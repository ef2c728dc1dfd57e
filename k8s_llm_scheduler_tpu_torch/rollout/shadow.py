"""Shadow arm: mirror live decisions through a candidate, score both.

A candidate checkpoint that passed offline distillation eval still hasn't
seen LIVE traffic — real pod shapes, real snapshot drift. Before the canary
gate ever promotes it, the shadow arm builds evidence for free: a
configurable fraction of `schedule_pod` decisions (sched/loop.py) is
mirrored — NON-BINDING, off the hot path — through the candidate backend,
and both answers are scored against a stateless spread-teacher reference:

- agreement: candidate node == incumbent node;
- teacher agreement for each arm (the one-step spread-lookahead pick,
  the same objective sim/teacher.py optimizes — stateless here because
  live traffic owns the real placements);
- projected-spread delta: spread-after-placement(candidate) minus
  spread-after-placement(incumbent) — negative means the candidate's
  choices leave the cluster better balanced.

Hot-path cost is one counter check and one executor submit (the same
pool pattern the replica prewarm reply path uses — the watch loop never
waits on a candidate decode). Backpressure drops mirrors instead of
queueing unbounded: shadow data is a sample, not a ledger.
"""

from __future__ import annotations

import logging
import statistics
import threading
from collections.abc import Sequence
from concurrent.futures import ThreadPoolExecutor

from k8s_llm_scheduler_tpu_torch.core.fallback import score_resource_balanced
from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
from k8s_llm_scheduler_tpu_torch.types import NodeMetrics, PodSpec, SchedulingDecision

logger = logging.getLogger(__name__)


def projected_spread(nodes: Sequence[NodeMetrics], chosen: str) -> float:
    """pstdev of fractional pod fills AFTER placing one pod on `chosen` —
    the spread-after metric the teacher's lookahead minimizes."""
    fills = []
    for n in nodes:
        if not n.max_pods:
            continue
        count = n.pod_count + (1 if n.name == chosen else 0)
        fills.append(count / n.max_pods)
    return statistics.pstdev(fills) if len(fills) > 1 else 0.0


def teacher_pick(pod: PodSpec, nodes: Sequence[NodeMetrics]) -> str | None:
    """Stateless one-step spread-lookahead reference choice (sim/teacher.py
    without the cross-wave memory — live traffic owns real placements, so
    only the snapshot-projected future is comparable)."""
    candidates = feasible_nodes(pod, nodes)
    candidates = [n for n in candidates if n.pod_count < n.max_pods or not n.max_pods]
    if not candidates:
        return None
    return min(
        candidates,
        key=lambda n: (
            round(projected_spread(nodes, n.name), 9),
            -score_resource_balanced(n),
            n.name,
        ),
    ).name


class ShadowScorer:
    """Mirror a fraction of live decisions through `candidate`, accumulate
    agreement/score deltas per candidate version. Attach to a Scheduler
    (scheduler.shadow = scorer); its stats surface through get_stats ->
    /metrics."""

    def __init__(
        self,
        candidate,                     # DecisionBackend
        *,
        fraction: float = 0.05,
        candidate_version: int | str | None = None,
        max_pending: int = 64,
        workers: int = 1,
    ) -> None:
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"shadow fraction must be in [0, 1], got {fraction}")
        self.candidate = candidate
        self.fraction = float(fraction)
        self.candidate_version = candidate_version
        self.max_pending = int(max_pending)
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="shadow"
        )
        self._lock = threading.Lock()
        self._seen = 0
        self._pending = 0
        self._closed = False
        self._counts = {
            "mirrored": 0,
            "agree": 0,
            "teacher_agree_incumbent": 0,
            "teacher_agree_candidate": 0,
            "errors": 0,
            "dropped": 0,
        }
        self._spread_delta_sum = 0.0

    # -------------------------------------------------------------- intake
    def observe(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics],
        decision: SchedulingDecision,
    ) -> bool:
        """Hot-path hook: maybe enqueue a mirror for this decision.
        Deterministic counter-based sampling (no RNG on the hot path, and
        a given fraction mirrors exactly that share of traffic). Returns
        True when a mirror was enqueued."""
        if self._closed or self.fraction <= 0.0 or decision is None:
            return False
        with self._lock:
            self._seen += 1
            take = int(self._seen * self.fraction) > int(
                (self._seen - 1) * self.fraction
            )
            if not take:
                return False
            if self._pending >= self.max_pending:
                self._counts["dropped"] += 1
                return False
            self._pending += 1
        try:
            self._pool.submit(self._mirror, pod, nodes, decision.selected_node)
        except RuntimeError:  # pool shut down under us
            with self._lock:
                self._pending -= 1
            return False
        return True

    # ------------------------------------------------------------- scoring
    def _mirror(self, pod, nodes, incumbent_node: str) -> None:
        try:
            cand = self.candidate.get_scheduling_decision(pod, nodes)
            cand_node = cand.selected_node
        except Exception:
            with self._lock:
                self._pending -= 1
                self._counts["errors"] += 1
            return
        ref = teacher_pick(pod, nodes)
        delta = (
            projected_spread(nodes, cand_node)
            - projected_spread(nodes, incumbent_node)
        )
        with self._lock:
            self._pending -= 1
            self._counts["mirrored"] += 1
            if cand_node == incumbent_node:
                self._counts["agree"] += 1
            if ref is not None:
                if incumbent_node == ref:
                    self._counts["teacher_agree_incumbent"] += 1
                if cand_node == ref:
                    self._counts["teacher_agree_candidate"] += 1
            self._spread_delta_sum += delta

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            n = self._counts["mirrored"]
            out = {
                "fraction": self.fraction,
                "seen": self._seen,
                "pending": self._pending,
                **self._counts,
                "agree_frac": round(self._counts["agree"] / n, 4) if n else None,
                "teacher_agree_incumbent_frac": (
                    round(self._counts["teacher_agree_incumbent"] / n, 4)
                    if n else None
                ),
                "teacher_agree_candidate_frac": (
                    round(self._counts["teacher_agree_candidate"] / n, 4)
                    if n else None
                ),
                "spread_delta_mean": (
                    round(self._spread_delta_sum / n, 6) if n else None
                ),
            }
            if self.candidate_version is not None:
                out["candidate_version"] = self.candidate_version
            return out

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Wait for in-flight mirrors to land (tests / orderly shutdown)."""
        import time

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._pending == 0:
                    return True
            time.sleep(0.005)  # graftlint: ok[raw-clock] — bounded drain poll on the scorer pool's own background thread
        return False

    def close(self) -> None:
        self._closed = True
        self._pool.shutdown(wait=False, cancel_futures=True)
