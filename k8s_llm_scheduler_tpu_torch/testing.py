"""Synthetic cluster snapshots and fixture pods for tests and the chip smoke.

`synthetic_nodes(n)` returns exactly the NodeMetrics that the JAX package's
`testing.synthetic_cluster(n).get_node_metrics()` reports for a cluster with
no pods bound: node-i at load (i * 37 % 90)% of 16 cores / 64 GB, 110 max
pods, zone label z(i % 4), Ready.
"""

from __future__ import annotations

from k8s_llm_scheduler_tpu_torch.types import NodeMetrics, PodSpec


def synthetic_nodes(
    n_nodes: int = 3,
    cpu_cores: float = 16.0,
    memory_gb: float = 64.0,
    max_pods: int = 110,
    load_spread: bool = True,
) -> list[NodeMetrics]:
    """n nodes at varied synthetic load levels."""
    out = []
    for i in range(n_nodes):
        load = float(i * 37 % 90) if load_spread else 0.0
        out.append(
            NodeMetrics(
                name=f"node-{i}",
                cpu_usage_percent=load,
                memory_usage_percent=load,
                available_cpu_cores=cpu_cores,
                available_memory_gb=memory_gb,
                pod_count=0,
                max_pods=max_pods,
                labels={"zone": f"z{i % 4}"},
                taints=(),
                conditions={"Ready": "True"},
            )
        )
    return out


def fixture_pods(n: int = 8) -> list[PodSpec]:
    """n pending pods of varied shape: small web pods, memory-heavy caches,
    compute and high-priority batch jobs. None carries a selector, so every
    node of synthetic_nodes is feasible for each — the decision grammar
    covers every ready node, and any name it emits is a feasible one."""
    shapes = (
        dict(cpu_request=0.5, memory_request=0.5),
        dict(cpu_request=2.0, memory_request=8.0),
        dict(cpu_request=1.0, memory_request=2.0),
        dict(cpu_request=4.0, memory_request=16.0, priority=100),
        dict(cpu_request=0.25, memory_request=0.25),
        dict(cpu_request=8.0, memory_request=4.0),
        dict(cpu_request=1.5, memory_request=3.0),
        dict(cpu_request=3.0, memory_request=24.0, priority=10),
    )
    names = ("web", "cache", "api", "batch", "sidecar", "compute", "worker", "etl")
    return [
        PodSpec(
            name=f"{names[i % len(names)]}-{i}",
            namespace="default",
            **shapes[i % len(shapes)],
        )
        for i in range(n)
    ]
