"""Heuristic fallback scheduling — the CPU escape hatch.

Behavioral parity with the reference's `_fallback_decision`
(reference scheduler.py:521-559): filter to Ready nodes (scheduler.py:532-535)
then score by strategy (config.yaml:34-36):

- `resource_balanced` (default): 0.35*cpu_free% + 0.35*mem_free% +
  0.30*pod_headroom% (scheduler.py:537-541)
- `least_loaded`: cpu_free% + mem_free% (scheduler.py:542-543)
- `round_robin`: prefer the node with the FEWEST pods. The reference's code
  comment says "prefer fewer pods" but its argmax over `score = pod_count`
  picks the MOST-loaded node (scheduler.py:544-545) — a bug SURVEY §2 flags.
  This implementation follows the documented intent, not the bug.

Decisions are returned with confidence 0.4 and fallback_needed=True
(scheduler.py:551-557). Pure functions, no I/O.
"""

from __future__ import annotations

from collections.abc import Sequence

from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
from k8s_llm_scheduler_tpu_torch.types import (
    DecisionSource,
    NodeMetrics,
    PodSpec,
    SchedulingDecision,
)

FALLBACK_CONFIDENCE = 0.4

STRATEGIES = ("resource_balanced", "least_loaded", "round_robin")


def score_resource_balanced(node: NodeMetrics) -> float:
    """Weighted free-resource score (reference scheduler.py:537-541)."""
    return (
        0.35 * node.cpu_free_percent
        + 0.35 * node.memory_free_percent
        + 0.30 * node.pod_headroom_percent
    )


def score_least_loaded(node: NodeMetrics) -> float:
    """Sum of free percentages (reference scheduler.py:542-543)."""
    return node.cpu_free_percent + node.memory_free_percent


def score_round_robin(node: NodeMetrics) -> float:
    """Fewest pods wins (negated count so argmax is correct — fixes the
    reference's inversion at scheduler.py:544-545)."""
    return -float(node.pod_count)


# Public registry: sim/arena.py builds one decision arm per strategy from
# this map, so a new heuristic automatically becomes a benchmarked arm.
# These scorers are deliberately STATELESS one-shot rankings — the
# spread-lookahead / soft-affinity reference policy that folds its own
# placements lives in sim/teacher.py, where O(candidates x nodes) per
# decision is affordable; the runtime fallback must stay O(nodes).
SCORERS = {
    "resource_balanced": score_resource_balanced,
    "least_loaded": score_least_loaded,
    "round_robin": score_round_robin,
}
_SCORERS = SCORERS  # backwards-compat alias


def fallback_decision(
    nodes: Sequence[NodeMetrics],
    reason: str = "llm_unavailable",
    strategy: str = "resource_balanced",
    pod: PodSpec | None = None,
) -> SchedulingDecision | None:
    """Pick a node heuristically. Returns None when no candidate node exists
    (the caller then leaves the pod Pending for the next watch cycle).

    When `pod` is provided, candidates are filtered to nodes the pod can
    legally run on (selector, taints, resource fit) — the reference's
    fallback ignores placement constraints entirely (scheduler.py:532-535
    filters only on readiness), which can bind a pod onto a node that
    violates its nodeSelector; K8s honors bindings unconditionally, so that
    is a real mis-placement, not a transient.
    """
    scorer = _SCORERS.get(strategy, score_resource_balanced)
    if pod is not None:
        candidates = feasible_nodes(pod, nodes)
    else:
        candidates = [n for n in nodes if n.is_ready]
    if not candidates:
        return None
    best = max(candidates, key=scorer)
    return SchedulingDecision(
        selected_node=best.name,
        confidence=FALLBACK_CONFIDENCE,
        reasoning=f"fallback[{strategy}]: {reason}",
        fallback_needed=True,
        source=DecisionSource.FALLBACK,
    )
