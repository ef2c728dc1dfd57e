"""Per-decision routing between the sharded big arm and the distilled
fast arm.

The north-star serving stack (BASELINE config 3) runs TWO model tiers:
a 70B-class decision LLM tensor-parallel over the ICI mesh
(engine/sharded/), and a scheduler-specialized small checkpoint
distilled from it (train/distill.py + the rollout registry). The big
arm is slow and smart; the fast arm is cheap and right for the easy
mass of decisions. This module is the seam that picks an arm PER
DECISION — not per deployment — so the hybrid can spend the 70B budget
only where it pays.

Decision classes (classify_decision):

- **deadline budget** (sched/deadline.py ambient DeadlineBudget): a
  decision whose remaining budget cannot cover the big arm's typical
  latency goes fast — a late great answer loses to an on-time good one
  (the degradation-ladder premise, applied one rung earlier);
- **pod constraint complexity**: selectors, tolerations, affinity and
  priority raise the stakes — constrained pods are where the big model
  measurably beats the small one (learn/ weakness mining shows the
  fast tier's losses concentrate there), so complexity >= threshold
  routes big;
- **cache tier**: a cluster snapshot the big arm has never prefilled
  is a full prefix prefill away from its first token; when the budget
  cannot also absorb that cold-start, the decision goes fast and the
  router fires the big arm's prefix prewarm in the background so the
  NEXT decision on this snapshot finds it warm.

The hybrid is not assumed better — it is GATED (run_hybrid_gate): a
seeded arena run (sim/arena.py) scores big-alone, fast-alone, and the
routed hybrid on the canary gate's axes (spread down, constraint
satisfaction up, bound fraction up; rollout/canary.GateConfig
tolerances), and the hybrid must beat or match BOTH arms alone.

`RoutedBackend` implements the DecisionBackend protocol, so it slots
under sched/client.DecisionClient (cache, single-flight, breaker,
degradation ladder all stack on top) and inside fleet pools exactly
like any local or remote backend.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
from collections import OrderedDict
from collections.abc import Sequence
from typing import Any, Callable

from k8s_llm_scheduler_tpu_torch.core.cache import _nodes_digest
from k8s_llm_scheduler_tpu_torch.engine.backend import (
    DecisionBackend,
    NoFeasibleNodeError,
)
from k8s_llm_scheduler_tpu_torch.sched.deadline import (
    DeadlineExceededError,
    current_budget,
)
from k8s_llm_scheduler_tpu_torch.types import (
    NodeMetrics,
    PodSpec,
    SchedulingDecision,
)

logger = logging.getLogger(__name__)

ROUTE_BIG = "big"
ROUTE_FAST = "fast"

# Exceptions that are VERDICTS, not arm failures: failing over to the
# other arm on these would re-ask a question that was already answered
# (no node fits) or already out of time.
_NO_FAILOVER = (NoFeasibleNodeError, DeadlineExceededError)


@dataclasses.dataclass(frozen=True)
class RouterPolicy:
    """Routing thresholds. Defaults suit the 1B-operating-point latency
    envelope (BENCH notes); config block `router` overrides them."""

    # Remaining deadline budget (ms) below which the big arm is not
    # attempted — covers its typical warm decision latency.
    big_min_budget_ms: float = 120.0
    # Additional budget (ms) a COLD snapshot must have on top of
    # big_min_budget_ms to absorb the big arm's prefix prefill.
    big_cold_extra_ms: float = 250.0
    # Constraint-complexity score at or above which a pod routes big
    # (see pod_complexity).
    complexity_threshold: int = 2
    # With no ambient deadline budget at all, assume this much headroom
    # (offline/batch callers — the arena, replayed traces).
    no_budget_assume_ms: float = 1000.0
    # Snapshot digests remembered as warm on the big arm (LRU bound).
    warm_snapshots: int = 64
    # Fire the big arm's prefix prewarm when a cold snapshot forces a
    # fast route, so the next decision on it can go big.
    prewarm_on_cold: bool = True


def pod_complexity(pod: PodSpec) -> int:
    """Constraint-complexity score: how much scheduling judgment this
    pod demands. Each selector term, toleration, and affinity rule adds
    one; a nonzero priority adds one (preemption-adjacent placements
    are the expensive mistakes)."""
    score = len(pod.node_selector) + len(pod.tolerations)
    score += len(getattr(pod, "affinity_rules", None) or {})
    if getattr(pod, "priority", 0):
        score += 1
    return score


class _WarmDigests:
    """LRU set of snapshot digests the big arm has served (= its prefix
    cache plausibly holds them). Thread-safe: the router is called from
    the scheduler loop's executor threads."""

    def __init__(self, cap: int) -> None:
        self._cap = max(1, int(cap))
        self._seen: OrderedDict[bytes, None] = OrderedDict()
        self._lock = threading.Lock()

    def is_warm(self, digest: bytes) -> bool:
        with self._lock:
            if digest in self._seen:
                self._seen.move_to_end(digest)
                return True
            return False

    def note(self, digest: bytes) -> None:
        with self._lock:
            self._seen[digest] = None
            self._seen.move_to_end(digest)
            while len(self._seen) > self._cap:
                self._seen.popitem(last=False)


def classify_decision(
    pod: PodSpec,
    nodes: Sequence[NodeMetrics],
    *,
    policy: RouterPolicy,
    warm: _WarmDigests,
) -> tuple[str, str]:
    """(arm, reason) for one decision. Pure over its inputs plus the
    ambient deadline budget — the reason string is a stable counter key
    (router stats), not prose."""
    budget = current_budget()
    if budget is not None:
        remaining = budget.remaining_ms()
    else:
        remaining = policy.no_budget_assume_ms
    if remaining < policy.big_min_budget_ms:
        return ROUTE_FAST, "deadline_budget"
    digest = _nodes_digest(nodes)
    cold = not warm.is_warm(digest)
    if cold and remaining < policy.big_min_budget_ms + policy.big_cold_extra_ms:
        return ROUTE_FAST, "cold_snapshot"
    if pod_complexity(pod) >= policy.complexity_threshold:
        return ROUTE_BIG, "constraint_complexity"
    return ROUTE_FAST, "simple_pod"


class RoutedBackend:
    """DecisionBackend (structural, like every backend here) that routes
    each decision between two arms.

    `big` is the sharded tp serving stack; `fast` the distilled small
    checkpoint (both any DecisionBackend — local engine, fleet pool,
    remote client). Failover: if the chosen arm errors (not a
    no-feasible-node / deadline verdict), the other arm answers and the
    failover is counted — a down arm degrades the hybrid to the
    surviving tier instead of the heuristic ladder.
    """

    pool_role = "mixed"

    def __init__(
        self,
        big: DecisionBackend,
        fast: DecisionBackend,
        policy: RouterPolicy | None = None,
        *,
        owned: bool = True,
    ) -> None:
        self.big = big
        self.fast = fast
        self.policy = policy or RouterPolicy()
        self._owned = owned
        self._warm = _WarmDigests(self.policy.warm_snapshots)
        self._lock = threading.Lock()
        self.stats_counters: dict[str, int] = {
            "routed_big": 0,
            "routed_fast": 0,
            "failovers": 0,
            "cold_prewarms": 0,
        }
        self._reasons: dict[str, int] = {}

    # ------------------------------------------------------------ routing
    def _arm(self, name: str) -> DecisionBackend:
        return self.big if name == ROUTE_BIG else self.fast

    def _note_route(self, arm: str, reason: str) -> None:
        with self._lock:
            self.stats_counters[f"routed_{arm}"] += 1
            self._reasons[reason] = self._reasons.get(reason, 0) + 1

    def _route(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics]
    ) -> tuple[str, str]:
        arm, reason = classify_decision(
            pod, nodes, policy=self.policy, warm=self._warm
        )
        self._note_route(arm, reason)
        if arm == ROUTE_BIG:
            # The big arm is about to prefill (or re-use) this snapshot:
            # it is warm for every later decision in the burst.
            self._warm.note(_nodes_digest(nodes))
        elif reason == "cold_snapshot" and self.policy.prewarm_on_cold:
            self._fire_big_prewarm(nodes)
        return arm, reason

    def _fire_big_prewarm(self, nodes: Sequence[NodeMetrics]) -> None:
        prewarm = getattr(self.big, "prewarm_prefix", None)
        if prewarm is None:
            return
        try:
            prewarm(nodes)
        except Exception:  # pragma: no cover - advisory path
            logger.debug("big-arm prewarm failed", exc_info=True)
            return
        self._warm.note(_nodes_digest(nodes))
        with self._lock:
            self.stats_counters["cold_prewarms"] += 1

    # ----------------------------------------------------------- sync API
    def get_scheduling_decision(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics]
    ) -> SchedulingDecision:
        arm, _reason = self._route(pod, nodes)
        try:
            return self._arm(arm).get_scheduling_decision(pod, nodes)
        except _NO_FAILOVER:
            raise
        except Exception:
            other = ROUTE_FAST if arm == ROUTE_BIG else ROUTE_BIG
            logger.warning(
                "router: %s arm failed, failing over to %s", arm, other,
                exc_info=True,
            )
            with self._lock:
                self.stats_counters["failovers"] += 1
            return self._arm(other).get_scheduling_decision(pod, nodes)

    def get_scheduling_decisions_batch(
        self, pods: Sequence[PodSpec], nodes: Sequence[NodeMetrics]
    ) -> list[SchedulingDecision]:
        """Split the batch by decision class, ship each sub-batch to its
        arm's batch path (packed admission on a local engine), reassemble
        in submission order."""
        routes = [self._route(pod, nodes)[0] for pod in pods]
        out: list[SchedulingDecision | None] = [None] * len(pods)
        for arm_name in (ROUTE_BIG, ROUTE_FAST):
            idx = [i for i, r in enumerate(routes) if r == arm_name]
            if not idx:
                continue
            arm = self._arm(arm_name)
            sub = [pods[i] for i in idx]
            batch = getattr(arm, "get_scheduling_decisions_batch", None)
            if batch is not None:
                results = batch(sub, nodes)
            else:
                results = [
                    arm.get_scheduling_decision(p, nodes) for p in sub
                ]
            for i, res in zip(idx, results):
                out[i] = res
        return [r for r in out if r is not None] if None in out else out  # type: ignore[return-value]

    # ---------------------------------------------------------- async API
    async def _call_async(
        self, arm: DecisionBackend, pod: PodSpec, nodes: Sequence[NodeMetrics]
    ) -> SchedulingDecision:
        fn = getattr(arm, "get_scheduling_decision_async", None)
        if fn is not None:
            return await fn(pod, nodes)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, arm.get_scheduling_decision, pod, nodes
        )

    async def get_scheduling_decision_async(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics]
    ) -> SchedulingDecision:
        arm, _reason = self._route(pod, nodes)
        try:
            return await self._call_async(self._arm(arm), pod, nodes)
        except _NO_FAILOVER:
            raise
        except Exception:
            other = ROUTE_FAST if arm == ROUTE_BIG else ROUTE_BIG
            logger.warning(
                "router: %s arm failed (async), failing over to %s",
                arm, other, exc_info=True,
            )
            with self._lock:
                self.stats_counters["failovers"] += 1
            return await self._call_async(self._arm(other), pod, nodes)

    # ----------------------------------------------------------- plumbing
    def prewarm_prefix(self, nodes: Sequence[NodeMetrics]):
        """Prewarm BOTH arms (each maintains its own prefix cache) and
        mark the snapshot warm for routing."""
        res = None
        for arm in (self.big, self.fast):
            fn = getattr(arm, "prewarm_prefix", None)
            if fn is not None:
                res = fn(nodes)
        self._warm.note(_nodes_digest(nodes))
        return res

    def get_stats(self) -> dict[str, Any]:
        with self._lock:
            counters = dict(self.stats_counters)
            reasons = dict(self._reasons)
        stats: dict[str, Any] = {
            "backend": "routed",
            "router": {**counters, "route_reasons": reasons},
        }
        for name, arm in (("big", self.big), ("fast", self.fast)):
            get = getattr(arm, "get_stats", None)
            if get is not None:
                try:
                    stats[name] = get()
                except Exception:  # pragma: no cover - stats best-effort
                    stats[name] = {"error": "stats unavailable"}
        return stats

    def close(self) -> None:
        if not self._owned:
            return
        for arm in (self.big, self.fast):
            closer = getattr(arm, "close", None)
            if closer is not None:
                try:
                    closer()
                except Exception:  # pragma: no cover - teardown best-effort
                    logger.warning("router: arm close failed", exc_info=True)


# ------------------------------------------------------------------ distill
def distill_fast_checkpoint(
    cfg,
    out_dir: str,
    *,
    steps: int = 300,
    seed: int = 0,
    tokenizer_name: str = "numeric",
    registry_dir: str | None = None,
    **train_kwargs: Any,
) -> str:
    """Distill the scheduler-specialized fast tier and return the
    servable checkpoint path.

    Thin veneer over train/distill.train_and_save — the EXISTING
    teacher-pair distillation path — that defaults the knobs the fast
    tier wants (numeric tokenizer, registry publication when a registry
    is given so the checkpoint carries provenance/lineage like every
    other promoted artifact)."""
    from k8s_llm_scheduler_tpu_torch.train.distill import train_and_save

    train_and_save(
        cfg,
        out_dir,
        steps=steps,
        seed=seed,
        tokenizer_name=tokenizer_name,
        registry_dir=registry_dir,
        publish_note=f"router fast tier (distilled, steps={steps})",
        **train_kwargs,
    )
    if registry_dir is not None:
        from k8s_llm_scheduler_tpu_torch.rollout import CheckpointRegistry

        registry = CheckpointRegistry(registry_dir)
        active = registry.active()
        if active is not None:
            return str(registry.get(active).checkpoint_path)
    return out_dir


# --------------------------------------------------------------------- gate
def run_hybrid_gate(
    make_big: Callable[[], Any],
    make_fast: Callable[[], Any],
    make_hybrid: Callable[[], Any],
    gate=None,
) -> dict:
    """Arena-gate the routed hybrid against BOTH arms alone.

    Runs the three stacks over the same seeded scenario (the canary
    gate's scenario shape) and applies the gate's score checks twice:
    hybrid-vs-big and hybrid-vs-fast. The hybrid passes only if it is
    no worse than EITHER arm alone on every axis — the routing policy
    must not buy latency with placement quality.
    """
    from k8s_llm_scheduler_tpu_torch.rollout.canary import GateConfig
    from k8s_llm_scheduler_tpu_torch.sim import ArmSpec, generate_scenario, run_arena
    from k8s_llm_scheduler_tpu_torch.sim.scenarios import ScenarioSpec

    gate = gate or GateConfig()
    spec = ScenarioSpec(
        name="router-gate",
        seed=gate.seed,
        n_nodes=gate.nodes,
        n_pods=gate.pods,
        shapes=gate.shapes,
        arrival="waves",
        n_waves=gate.waves,
        constraint_mix=gate.constraint_mix,
        taint_frac=gate.taint_frac,
        hetero=gate.hetero,
    )
    scenario = generate_scenario(spec)
    report = run_arena(
        scenario,
        [
            ArmSpec(name="big", kind="stack", make=make_big),
            ArmSpec(name="fast", kind="stack", make=make_fast),
            ArmSpec(name="hybrid", kind="stack", make=make_hybrid),
        ],
        wave_timeout_s=gate.wave_timeout_s,
    )
    scores = {name: arm["scores"] for name, arm in report["arms"].items()}
    hyb = scores["hybrid"]

    def axes(baseline: dict) -> dict:
        return {
            "spread": hyb["spread"] <= baseline["spread"] + gate.spread_tolerance,
            "constraint_satisfaction": (
                hyb["constraint_satisfaction"]
                >= baseline["constraint_satisfaction"] - gate.constraint_tolerance
            ),
            "bound_frac": (
                hyb["bound_frac"] >= baseline["bound_frac"] - gate.bound_tolerance
            ),
        }

    checks = {"vs_big": axes(scores["big"]), "vs_fast": axes(scores["fast"])}
    return {
        "pass": all(all(c.values()) for c in checks.values()),
        "checks": checks,
        "scores": scores,
        "seed": gate.seed,
        "scenario_spec": spec.to_dict(),
    }
