"""Spread-lookahead + soft-affinity reference policy.

The runtime fallback (core/fallback.py) is deliberately a stateless
one-shot ranking: O(nodes) per decision, no memory, because it runs on
the hot path when the model is down. This teacher is the policy the
runtime CANNOT afford — the reference arm the arena scores every other
arm against:

- **one-step spread lookahead**: for each feasible candidate, project the
  placement and score the RESULTING cluster's pod-fill spread (pstdev of
  fractional fills, the same metric train/eval.load_spread reports), then
  pick the future with the least imbalance. The greedy scorers rank the
  present; this ranks the consequence.
- **soft zone anti-affinity**: pods of one shape group (replicas of one
  deployment) are nudged across zones — a per-(group, zone) count the
  policy folds itself, since no NodeMetrics carries it. Soft: it breaks
  ties and biases, never vetoes a feasible node.
- feasibility first: candidates come from core/validation.feasible_nodes,
  identical to what the constrained decoder enforces for the LLM arm.

Stateful ⇒ order-dependent ⇒ the arena runs this arm in SEQUENTIAL
policy mode (one decision at a time over the deterministic ClusterModel),
not through the concurrent stack. That is what "reference" means here:
the score an oracle-ish planner reaches, for the live arms to chase.
"""

from __future__ import annotations

import math
from collections import Counter
from collections.abc import Sequence

from k8s_llm_scheduler_tpu_torch.core.fallback import score_resource_balanced
from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
from k8s_llm_scheduler_tpu_torch.types import NodeMetrics, PodSpec



def pod_group(pod: PodSpec) -> str:
    """Shape signature = deployment stand-in (matches the decision-cache
    notion that same-shape pods are replicas of one workload)."""
    return f"{pod.cpu_request:.3f}|{pod.memory_request:.3f}"


class SpreadLookaheadTeacher:
    """Callable policy: decide(pod, nodes) -> node name | None.

    Within a wave the teacher also projects its OWN in-flight placements
    (`begin_wave` resets the projection once the cluster state has folded
    the binds in), so 30 identical replicas in one wave fan out instead
    of stacking on the one currently-best node — the exact failure mode
    of the cached fallback arm it exists to contrast."""

    def __init__(self) -> None:
        self._zone_counts: dict[str, Counter] = {}   # group -> zone -> n
        self._wave_counts: Counter = Counter()       # node -> in-wave adds

    def reset(self) -> None:
        self._zone_counts.clear()
        self._wave_counts.clear()

    def begin_wave(self) -> None:
        """The driver settled all previous binds into the snapshot: the
        per-node projection is now double-counting and must drop. The
        per-(group, zone) memory persists — no snapshot carries it."""
        self._wave_counts.clear()

    def decide(self, pod: PodSpec, nodes: Sequence[NodeMetrics]) -> str | None:
        candidates = feasible_nodes(pod, nodes)
        # project in-wave placements into the candidate filter too: a node
        # at max_pods - 1 with one in-wave add is FULL for this pod
        candidates = [
            n for n in candidates
            if n.pod_count + self._wave_counts[n.name] < n.max_pods
        ]
        if not candidates:
            return None
        group = pod_group(pod)
        zones = self._zone_counts.setdefault(group, Counter())

        fills = {
            n.name: (
                (n.pod_count + self._wave_counts[n.name]) / n.max_pods
                if n.max_pods
                else 0.0
            )
            for n in nodes
        }
        # incremental variance: only ONE fill changes per candidate, so
        # the projected pstdev is O(1) from the running sum / sum-of-
        # squares — the naive per-candidate recompute made a 256-node /
        # 1000-pod scenario O(nodes^2 * pods) and minutes-slow
        count = len(fills)
        f_sum = sum(fills.values())
        f_sumsq = sum(v * v for v in fills.values())

        def cost(n: NodeMetrics) -> tuple:
            old = fills[n.name]
            new = (
                (n.pod_count + self._wave_counts[n.name] + 1) / n.max_pods
                if n.max_pods
                else old
            )
            s = f_sum - old + new
            sq = f_sumsq - old * old + new * new
            var = max(sq / count - (s / count) ** 2, 0.0)
            spread_after = math.sqrt(var) if count > 1 else 0.0
            zone_pressure = zones.get(n.labels.get("zone", ""), 0)
            # LEXICOGRAPHIC, not weighted: the lookahead spread is the
            # headline objective and must never be outbid by a soft term
            # (a weighted blend measurably placed WORSE than the greedy
            # heuristics it exists to beat); zone anti-affinity breaks
            # spread ties, the balanced-resource score breaks the rest,
            # the name makes the order total (determinism).
            return (
                round(spread_after, 9),
                zone_pressure,
                -score_resource_balanced(n),
                n.name,
            )

        best = min(candidates, key=cost)
        self._wave_counts[best.name] += 1
        zones[best.labels.get("zone", "")] += 1
        return best.name
