"""Decision-QUALITY evaluation: is the LLM scheduler actually good at its
job?

The reference prompts for specific selection criteria (reference
scheduler.py:196-214 — balance load, respect resources, prefer
lower-utilization nodes) but never measures whether the returned decisions
satisfy them; its tests stop at "the response parsed". This module closes
that gap with two measurements:

1. **Teacher agreement** (`eval_agreement`): top-1 agreement between a
   decision function and the heuristic teacher (core/fallback.py
   resource_balanced — the same scorer `cli train` distills from) on
   HELD-OUT randomized clusters (disjoint seed from training). This is the
   distillation-quality metric: a checkpoint trained by `cli train` should
   agree with its teacher far above chance.

2. **Placement quality** (`eval_placement`): sequentially place a burst of
   pods, folding each decision back into the cluster state (pod_count +
   the reference's synthesized usage, scheduler.py:149-151), then score
   the final load spread across nodes. Reported for the candidate decider
   against the fallback scorer and a uniform-random placer on identical
   bursts — the spread gap is the "does the LLM balance load" number.

Surfaces: `cli train --eval`, `cli eval --checkpoint DIR`, and
`tests/test_eval.py` (slow tier) for the closed loop.
"""

from __future__ import annotations

import dataclasses
import logging
import statistics
from typing import Callable, Iterator, Sequence

import numpy as np

from k8s_llm_scheduler_tpu_torch.core.fallback import fallback_decision
from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
from k8s_llm_scheduler_tpu_torch.types import NodeMetrics, PodSpec

logger = logging.getLogger(__name__)

DecideFn = Callable[[PodSpec, Sequence[NodeMetrics]], str | None]
"""(pod, nodes) -> selected node name (None = unschedulable)."""


def held_out_cases(
    n_cases: int,
    n_nodes: int = 5,
    seed: int = 10_007,
) -> Iterator[tuple[PodSpec, list[NodeMetrics]]]:
    """Randomized (pod, cluster) cases from THE SAME generator the
    training corpus uses (train/distill.random_cases) at a DISJOINT seed
    stream — on-distribution by construction (tuning the training
    distribution cannot silently skew this metric), and generalization
    rather than memorization."""
    from k8s_llm_scheduler_tpu_torch.train.distill import random_cases

    cases = random_cases(n_nodes=n_nodes, seed=seed)
    for _ in range(n_cases):
        yield next(cases)


SCENARIO_CLASSES = (
    "uniform", "hetero-capacity", "tainted", "selector", "affinity"
)

# Which PodSpec constraint dimension each scenario class exercises (None:
# the class varies topology, not pod constraints). THE drift tripwire for
# the shared taxonomy: tests/test_learn.py pins that every class in
# SCENARIO_CLASSES has an entry here, that sample_pod_constraints REJECTS
# anything else, and that each non-None class actually populates its
# dimension — so neither this module nor sim/scenarios.py can grow a
# class the other (or the incident miner's per-class counts) doesn't know.
CLASS_DIMENSION: dict[str, str | None] = {
    "uniform": None,
    "hetero-capacity": None,
    "tainted": "tolerations",
    "selector": "node_selector",
    "affinity": "affinity_rules",
}


def sample_pod_constraints(
    kind: str, rng: np.random.Generator
) -> tuple[dict, tuple, dict]:
    """One (node_selector, tolerations, affinity_rules) draw for a pod of
    scenario class `kind` — THE constraint taxonomy, shared by the eval's
    per-class agreement table below, the sim's workload generators
    (sim/scenarios.py), and the incident miner's per-class corpus counts
    (learn/miner.py), so arena scores, eval tables, and mined corpora all
    speak the same scenario language. rng call ORDER is part of the
    contract: existing seeded streams (tests/test_eval.py) must not
    shift. Unknown kinds RAISE instead of silently yielding an
    unconstrained pod — a class added on one side of the taxonomy must
    fail loudly everywhere else until both sides know it."""
    if kind not in SCENARIO_CLASSES:
        raise ValueError(
            f"unknown scenario class {kind!r} (known: {SCENARIO_CLASSES})"
        )
    selector: dict = {}
    tolerations: tuple = ()
    affinity: dict = {}
    if kind == "selector" and rng.random() < 0.7:
        selector = {"tier": "db" if rng.random() < 0.5 else "web"}
    if kind == "tainted" and rng.random() < 0.6:
        tolerations = (
            {"key": "dedicated", "operator": "Equal", "value": "gpu",
             "effect": "NoSchedule"},
        )
    if kind == "affinity" and rng.random() < 0.8:
        zones = [f"z{z}" for z in rng.choice(3, size=2, replace=False)]
        affinity = {
            "node_affinity_terms": [
                [{"key": "zone", "operator": "In", "values": zones}]
            ]
        }
    return selector, tolerations, affinity


def scenario_cases(
    kind: str,
    n_nodes: int = 5,
    seed: int = 40_009,
) -> Iterator[tuple[PodSpec, list[NodeMetrics]]]:
    """Held-out cases per scenario class (VERDICT r4 weak #5: the eval
    previously drew only from the training generator's 5-uniform-node
    distribution — agreement numbers never saw the constraint dimensions
    core/validation.py exists for).

    - uniform:         the training distribution (train/distill.random_cases)
    - hetero-capacity: node sizes/max_pods drawn from distinct SKUs
    - tainted:         some nodes carry NoSchedule taints; pods may tolerate
    - selector:        tiered node labels; pods may pin a tier
    - affinity:        required node-affinity terms over zone labels

    Cases where the teacher abstains (no feasible node) are yielded too —
    eval_agreement skips them, exactly as it does for the uniform stream.
    """
    if kind == "uniform":
        from k8s_llm_scheduler_tpu_torch.train.distill import random_cases

        yield from random_cases(n_nodes=n_nodes, seed=seed)
        return
    if kind not in SCENARIO_CLASSES:
        raise ValueError(
            f"unknown scenario {kind!r} (known: {SCENARIO_CLASSES})"
        )
    rng = np.random.default_rng(seed)
    skus = [(4.0, 16.0, 30), (8.0, 32.0, 60), (16.0, 64.0, 110),
            (64.0, 256.0, 250)]
    case_idx = 0
    while True:
        k = int(rng.integers(2, n_nodes + 1))
        nodes = []
        for i in range(k):
            if kind == "hetero-capacity":
                cpu_cap, mem_cap, max_pods = skus[int(rng.integers(len(skus)))]
            else:
                cpu_cap, mem_cap, max_pods = 16.0, 64.0, 110
            labels = {"zone": f"z{i % 3}", "tier": ("db" if i % 2 else "web")}
            taints: tuple = ()
            if kind == "tainted" and rng.random() < 0.5:
                taints = (
                    {"key": "dedicated", "value": "gpu",
                     "effect": "NoSchedule"},
                )
            nodes.append(
                NodeMetrics(
                    name=f"node-{i}",
                    cpu_usage_percent=float(rng.uniform(5, 95)),
                    memory_usage_percent=float(rng.uniform(5, 95)),
                    available_cpu_cores=cpu_cap,
                    available_memory_gb=mem_cap,
                    pod_count=int(rng.integers(0, max_pods // 2)),
                    max_pods=max_pods,
                    labels=labels,
                    taints=taints,
                    conditions={"Ready": "True"},
                )
            )
        selector, tolerations, affinity = sample_pod_constraints(kind, rng)
        yield (
            PodSpec(
                name=f"{kind}-pod-{case_idx}",
                namespace="default",
                cpu_request=round(float(rng.uniform(0.05, 6.0)), 3),
                memory_request=round(float(rng.uniform(0.064, 24.0)), 3),
                node_selector=selector,
                tolerations=tolerations,
                affinity_rules=affinity,
                priority=int(rng.integers(0, 5)),
            ),
            nodes,
        )
        case_idx += 1


def eval_agreement_by_scenario(
    decide: DecideFn,
    n_cases: int = 32,
    n_nodes: int = 5,
    seed: int = 40_009,
    classes: Sequence[str] = SCENARIO_CLASSES,
) -> dict[str, dict]:
    """Per-scenario-class agreement report — the distribution-shift table
    (VERDICT r4 item 6). Each class gets its own case stream at the same
    seed so the table is reproducible."""
    out = {}
    for kind in classes:
        cases = scenario_cases(kind, n_nodes=n_nodes, seed=seed)
        agree = total = valid = 0
        chance_sum = 0.0
        attempts = 0
        while total < n_cases and attempts < n_cases * 8:
            attempts += 1
            pod, nodes = next(cases)
            target = teacher_decide(pod, nodes)
            if target is None:
                continue
            total += 1
            chance_sum += 1.0 / max(1, len(feasible_nodes(pod, nodes)))
            got = decide(pod, nodes)
            if got is not None and got in {n.name for n in nodes}:
                valid += 1
                if got == target:
                    agree += 1
        out[kind] = {
            "n_cases": total,
            "agreement_pct": round(100.0 * agree / max(1, total), 1),
            "valid_pct": round(100.0 * valid / max(1, total), 1),
            "chance_pct": round(100.0 * chance_sum / max(1, total), 1),
        }
    return out


def teacher_decide(pod: PodSpec, nodes: Sequence[NodeMetrics]) -> str | None:
    d = fallback_decision(
        nodes, reason="teacher", strategy="resource_balanced", pod=pod
    )
    return d.selected_node if d else None


def random_decide_fn(seed: int = 0) -> DecideFn:
    rng = np.random.default_rng(seed)

    def decide(pod: PodSpec, nodes: Sequence[NodeMetrics]) -> str | None:
        ok = feasible_nodes(pod, nodes)
        if not ok:
            return None
        return ok[int(rng.integers(0, len(ok)))].name

    return decide


def eval_agreement(
    decide: DecideFn,
    n_cases: int = 64,
    n_nodes: int = 5,
    seed: int = 10_007,
) -> dict:
    """Top-1 agreement with the teacher on held-out cases, plus the
    expected-by-chance agreement of a feasibility-aware random placer
    (the honest baseline: with ~3 feasible nodes, chance is ~33%, not
    1/n_nodes)."""
    agree = total = 0
    chance_sum = 0.0
    valid = 0
    for pod, nodes in held_out_cases(n_cases, n_nodes=n_nodes, seed=seed):
        target = teacher_decide(pod, nodes)
        if target is None:
            continue
        total += 1
        chance_sum += 1.0 / max(1, len(feasible_nodes(pod, nodes)))
        got = decide(pod, nodes)
        # valid = names an ACTUAL node of this cluster; a decider that
        # hallucinates "node-99" must not score as valid (this is the
        # field tests use to assert the grammar constraint held)
        if got is not None and got in {n.name for n in nodes}:
            valid += 1
            if got == target:
                agree += 1
    return {
        "n_cases": total,
        "agreement_pct": round(100.0 * agree / max(1, total), 1),
        "valid_pct": round(100.0 * valid / max(1, total), 1),
        "chance_pct": round(100.0 * chance_sum / max(1, total), 1),
    }


def _apply_placement(nodes: list[NodeMetrics], name: str) -> list[NodeMetrics]:
    """Fold one placement into the snapshot the next decision sees:
    pod_count += 1 and usage re-synthesized exactly as the reference does
    when metrics-server is absent ((pods/max_pods)*50,
    reference scheduler.py:149-151)."""
    out = []
    for n in nodes:
        if n.name == name:
            count = n.pod_count + 1
            synth = (count / n.max_pods) * 50.0 if n.max_pods else 0.0
            n = dataclasses.replace(
                n,
                pod_count=count,
                cpu_usage_percent=synth,
                memory_usage_percent=synth,
            )
        out.append(n)
    return out


def load_spread(nodes: Sequence[NodeMetrics]) -> float:
    """Population stdev of fractional pod load — the balance metric the
    reference's prompt asks the model to optimize but never scores."""
    fills = [n.pod_count / n.max_pods for n in nodes if n.max_pods]
    if len(fills) < 2:
        return 0.0
    return statistics.pstdev(fills)


def eval_placement(
    decide: DecideFn,
    n_pods: int = 32,
    n_nodes: int = 6,
    seed: int = 20_011,
) -> float:
    """Place `n_pods` sequentially (decision -> state update -> next
    decision) on one randomized cluster; return the final load spread."""
    from k8s_llm_scheduler_tpu_torch.cluster.interface import raw_pod_to_spec
    from k8s_llm_scheduler_tpu_torch.testing import pod_burst, synthetic_cluster

    rng = np.random.default_rng(seed)
    cluster = synthetic_cluster(n_nodes)
    nodes = list(cluster.get_node_metrics())
    cluster.close()
    # skew the starting load so "balance" is a real task, and shrink
    # max_pods so n_pods placements move the needle
    nodes = [
        dataclasses.replace(
            n,
            max_pods=20,
            pod_count=int(rng.integers(0, 10)),
        )
        for n in nodes
    ]
    nodes = [
        dataclasses.replace(
            n,
            cpu_usage_percent=(n.pod_count / n.max_pods) * 50.0,
            memory_usage_percent=(n.pod_count / n.max_pods) * 50.0,
        )
        for n in nodes
    ]
    pods = [raw_pod_to_spec(p) for p in pod_burst(n_pods, distinct_shapes=8)]
    names = {n.name for n in nodes}
    for pod in pods:
        name = decide(pod, nodes)
        if name is None or name not in names:
            continue  # unschedulable or hallucinated: nothing placed
        nodes = _apply_placement(nodes, name)
    return round(load_spread(nodes), 4)


def evaluate_decider(
    decide: DecideFn,
    n_cases: int = 64,
    placement_pods: int = 32,
    seed: int = 10_007,
) -> dict:
    """Full report card for one decision function: teacher agreement plus
    placement spread against the fallback and random baselines on the
    SAME burst."""
    report = eval_agreement(decide, n_cases=n_cases, seed=seed)
    report["placement_spread"] = eval_placement(decide, n_pods=placement_pods)
    report["fallback_spread"] = eval_placement(
        teacher_decide, n_pods=placement_pods
    )
    report["random_spread"] = eval_placement(
        random_decide_fn(seed), n_pods=placement_pods
    )
    return report


def evaluate_checkpoint(
    model: str,
    checkpoint_path: str | None,
    n_cases: int = 64,
    placement_pods: int = 32,
    backend=None,
    backend_kwargs: dict | None = None,
    scenarios: bool = False,
    scenario_cases_n: int = 32,
) -> dict:
    """Evaluate a (possibly distilled) decision model end to end through
    the REAL serving stack: prompt -> grammar-constrained wave decode ->
    parse -> validate. `checkpoint_path=None` evaluates the random-init
    model (the floor). Pass `backend` to reuse an already-built one, or
    `backend_kwargs` (e.g. the cli's cfg mapping — quantization,
    tokenizer, mesh, compile cache) so the report card measures the model
    AS SERVED, not a default-configured twin. temperature DEFAULTS to 0
    (deterministic argmax-policy report) but honors an explicit
    backend_kwargs["temperature"] — `cli eval --temperature` threads
    through here for sampled measurement."""
    from k8s_llm_scheduler_tpu_torch.engine.backend import (
        BackendError,
        NoFeasibleNodeError,
    )
    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend

    own = backend is None
    if own:
        kwargs = dict(backend_kwargs or {})
        kwargs.update(
            model=model,
            checkpoint_path=checkpoint_path,
        )
        kwargs.setdefault("temperature", 0.0)
        kwargs.setdefault("max_slots", 4)
        backend = build_local_backend(**kwargs)
    try:

        def decide(pod: PodSpec, nodes: Sequence[NodeMetrics]) -> str | None:
            try:
                return backend.get_scheduling_decision(pod, nodes).selected_node
            except (NoFeasibleNodeError, BackendError):
                return None

        report = evaluate_decider(
            decide, n_cases=n_cases, placement_pods=placement_pods
        )
        if scenarios:
            report["scenarios"] = eval_agreement_by_scenario(
                decide, n_cases=scenario_cases_n
            )
        report["model"] = model
        report["checkpoint"] = checkpoint_path
        return report
    finally:
        if own:
            backend.close()
