"""The distillation corpus's case generator (a part of the JAX package's
train/distill.py).

Only `random_cases` is here: train/eval.py draws its held-out cases from
it, and the arena's scenarios share its taxonomy. The rest of distill (the
teacher pairs, the train step, checkpoint saving) waits for the training
port, ROADMAP queue 1 item 10.
"""

from __future__ import annotations

import numpy as np


def random_cases(n_nodes: int = 5, seed: int = 0):
    """Endless randomized (pod, nodes) scheduling cases — THE training
    distribution. train/eval.py draws its held-out cases from this same
    generator at a disjoint seed, so agreement measured there stays
    on-distribution by construction when this is tuned."""
    import dataclasses

    from k8s_llm_scheduler_tpu_torch.cluster.interface import raw_pod_to_spec
    from k8s_llm_scheduler_tpu_torch.testing import pod_burst, synthetic_cluster

    rng = np.random.default_rng(seed)
    while True:
        cluster = synthetic_cluster(int(rng.integers(2, n_nodes + 1)))
        base_nodes = cluster.get_node_metrics()
        cluster.close()
        # synthetic_cluster's load levels are deterministic — without this
        # perturbation the corpus collapses to ~16 distinct sequences
        nodes = [
            dataclasses.replace(
                n,
                cpu_usage_percent=float(rng.uniform(5, 95)),
                memory_usage_percent=float(rng.uniform(5, 95)),
                pod_count=int(rng.integers(0, n.max_pods // 2)),
            )
            for n in base_nodes
        ]
        for raw in pod_burst(4, distinct_shapes=4):
            pod = raw_pod_to_spec(raw)
            yield (
                dataclasses.replace(
                    pod,
                    cpu_request=round(float(rng.uniform(0.05, 2.0)), 3),
                    memory_request=round(float(rng.uniform(0.064, 2.0)), 3),
                ),
                nodes,
            )
