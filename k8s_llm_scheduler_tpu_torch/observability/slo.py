"""SLO burn-rate engine: declarative objectives over windowed telemetry.

PR 4 gave the system per-decision percentiles (PhaseRecorder histograms,
windowed via `delta_hist`) and PR 6 made it a fleet — but nothing turned
those numbers into a SERVING-LEVEL signal: "is the error budget burning
fast enough that a human (or the canary gate, or the circuit breaker)
should act?" This module is that layer.

Objectives are declared in config.yaml (`slo.objectives`) and evaluated
over MULTI-WINDOW BURN RATES — the standard fast+slow pairing: the fast
window (default 5m) catches a sharp regression in minutes, the slow
window (default 1h) keeps a brief blip from paging anyone; a trip
requires BOTH to exceed their thresholds (defaults 14.4x / 6x, the
classic page-severity pairing). Three objective kinds:

- `latency`:   "phase X under T ms for all but `budget` of events" —
  violation fraction comes from windowed histogram bucket deltas
  (observability/trace.delta_hist over the fixed shared bucket ladder).
  Counting is CONSERVATIVE: an event counts as a violation only when its
  bucket's LOWER bound >= threshold, so bucket quantization can delay a
  trip by one 2x bucket but can never fire a false one (the same
  discipline rollout/canary's trip_decide_p99_ms uses).
- `error_rate`: numerator/denominator counter deltas (dotted stat paths,
  e.g. `failed_bindings` over `total_scheduled`) against a budget.
- `throughput`: a counter's windowed rate against a floor (e.g. fleet
  decisions/s); burn = floor/rate, thresholds default to 1.0.

Trips surface four ways: /debug/slo (full state), Prometheus gauges
(`llm_scheduler_slo_*`), a burn-in trip input for rollout/canary.py
(an open canary burn-in rolls back immediately on an SLO trip), and an
ADVISORY hook into core/breaker.py (`CircuitBreaker.slo_advisory` —
recorded and surfaced, never forcing the state machine: the breaker
guards backend health, and a latency SLO burn is evidence, not proof, of
a backend fault). `on_trip` callbacks fire on the RISING edge only.

Evaluation is pull-based (`evaluate()`), with an optional background
ticker thread whose lifecycle matches EngineSampler (start/stop with
join; MetricsServer.stop() stops it too).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Any, Callable

from k8s_llm_scheduler_tpu_torch.observability.trace import (
    BUCKET_BOUNDS_S,
    delta_hist,
)

logger = logging.getLogger(__name__)

KINDS = ("latency", "error_rate", "throughput")


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One declarative objective (config.yaml `slo.objectives` entry)."""

    name: str
    kind: str  # latency | error_rate | throughput
    # latency:
    phase: str = "decide"
    threshold_ms: float = 250.0
    # error_rate (dotted paths into the stats tree):
    numerator: str = "failed_bindings"
    denominator: str = "total_scheduled"
    # throughput:
    counter: str = "total_scheduled"
    min_per_s: float = 1.0
    # shared:
    budget: float = 0.01  # allowed violation fraction (latency/error_rate)
    fast_burn_threshold: float | None = None  # kind-dependent default
    slow_burn_threshold: float | None = None

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(
                f"slo objective {self.name!r}: kind {self.kind!r} "
                f"not in {KINDS}"
            )
        if self.kind != "throughput" and self.budget <= 0:
            raise ValueError(
                f"slo objective {self.name!r}: budget must be > 0"
            )

    @property
    def fast_threshold(self) -> float:
        if self.fast_burn_threshold is not None:
            return self.fast_burn_threshold
        return 1.0 if self.kind == "throughput" else 14.4

    @property
    def slow_threshold(self) -> float:
        if self.slow_burn_threshold is not None:
            return self.slow_burn_threshold
        return 1.0 if self.kind == "throughput" else 6.0

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SloObjective":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"slo objective {d.get('name', '?')!r}: unknown keys "
                f"{sorted(unknown)} (known: {sorted(known)})"
            )
        if "name" not in d or "kind" not in d:
            raise ValueError("slo objective needs 'name' and 'kind'")
        return cls(**d)


def _resolve(stats: dict, dotted: str) -> float:
    """Dotted-path counter lookup; a missing path reads 0 (a replica that
    has not produced the stat yet must not crash evaluation)."""
    node: Any = stats
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return 0.0
        node = node[part]
    return float(node) if isinstance(node, (int, float)) else 0.0


def _violations_above(counts: list[int], threshold_ms: float) -> int:
    """Events whose bucket LOWER bound >= threshold — each is guaranteed
    to exceed the threshold (conservative; see module docstring)."""
    threshold_s = threshold_ms / 1000.0
    viol = 0
    for i, c in enumerate(counts):
        lower = 0.0 if i == 0 else BUCKET_BOUNDS_S[i - 1]
        if i == len(BUCKET_BOUNDS_S):  # overflow bucket
            lower = BUCKET_BOUNDS_S[-1]
        if lower >= threshold_s:
            viol += int(c)
    return viol


class SloEngine:
    """Multi-window burn-rate evaluation over a stats provider.

    Keeps a ring of timestamped stats snapshots; each `evaluate()` takes a
    fresh snapshot and derives per-objective fast/slow-window burns from
    the delta against the snapshot nearest each window's start. With a
    young ring the window degrades to actual coverage (reported as
    `window_covered_s`) rather than refusing to answer — a scheduler five
    minutes old still gets a fast-window verdict.
    """

    def __init__(
        self,
        objectives: list[SloObjective],
        stats_provider: Callable[[], dict],
        *,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.objectives = list(objectives)
        self.stats_provider = stats_provider
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._snaps: deque[tuple[float, dict]] = deque()
        self._tripped: set[str] = set()
        self._last_eval: dict[str, dict] = {}
        self.trip_counts: dict[str, int] = {o.name: 0 for o in self.objectives}
        self.evaluations = 0
        # rising-edge callbacks: fn(objective_name, detail_dict)
        self.on_trip: list[Callable[[str, dict], None]] = []
        # falling-edge callbacks (the burn dropped back under threshold):
        # fn(objective_name, detail_dict). The consumer that needs both
        # edges is the decision brownout (sched/client.py): on_trip
        # enters it, on_clear exits it — without the falling edge a
        # single burn would shed decisions forever.
        self.on_clear: list[Callable[[str, dict], None]] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # lifecycle lock: start/stop are called from more than one owner
        # (MetricsServer.stop, cli shutdown paths, autoscale-driven
        # controller restarts) — without serialization a start racing a
        # stop could observe the dying thread's slot as free, clear the
        # stop event under it, and leak BOTH threads
        self._lifecycle = threading.Lock()

    # Stored-baseline resolution: _baseline only ever picks the snapshot
    # nearest a window cutoff, so the ring needs ~this many points per
    # window, not one per evaluate tick — without thinning, a sub-second
    # interval_s against the default 1h slow window accumulates tens of
    # thousands of full stats trees (each holding every phase histogram).
    POINTS_PER_WINDOW = 128

    def _thin(self, now: float) -> None:
        """Bound the snapshot ring (caller holds the lock): evict past the
        slow horizon (keeping one so a full-window baseline exists), then
        thin survivors to POINTS_PER_WINDOW resolution — fast-window
        granularity while young, slow-window granularity once older than
        the fast window. Baseline times stay exact (window_covered_s is
        computed from the snapshot actually used), only their spacing
        coarsens."""
        horizon = now - self.slow_window_s
        while len(self._snaps) > 2 and self._snaps[1][0] <= horizon:
            self._snaps.popleft()
        fast_edge = now - self.fast_window_s
        fast_r = self.fast_window_s / self.POINTS_PER_WINDOW
        slow_r = self.slow_window_s / self.POINTS_PER_WINDOW
        kept: list[tuple[float, dict]] = []
        for t, snap in self._snaps:
            if kept:
                spacing = slow_r if t <= fast_edge else fast_r
                if t - kept[-1][0] < spacing:
                    continue
            kept.append((t, snap))
        if len(kept) != len(self._snaps):
            self._snaps = deque(kept)

    # ----------------------------------------------------------- windows
    def _baseline(self, now: float, window_s: float) -> tuple[float, dict] | None:
        """Newest snapshot at least `window_s` old (else the oldest held —
        degraded coverage)."""
        cutoff = now - window_s
        best: tuple[float, dict] | None = None
        for t, snap in self._snaps:
            if t <= cutoff:
                best = (t, snap)
            else:
                break
        if best is None and self._snaps:
            best = self._snaps[0]
        return best

    def _burn(
        self, obj: SloObjective, base_t: float, base: dict,
        now: float, cur: dict,
    ) -> dict:
        covered = max(now - base_t, 1e-9)
        if obj.kind == "latency":
            dh = delta_hist(
                (base.get("phases") or {}).get(obj.phase),
                (cur.get("phases") or {}).get(obj.phase),
            )
            total = int(dh["count"]) if dh else 0
            viol = _violations_above(dh["counts"], obj.threshold_ms) if dh else 0
            frac = viol / total if total else 0.0
            return {
                "burn": frac / obj.budget,
                "violations": viol,
                "events": total,
                "window_covered_s": round(covered, 1),
            }
        if obj.kind == "error_rate":
            num = _resolve(cur, obj.numerator) - _resolve(base, obj.numerator)
            den = (
                _resolve(cur, obj.denominator)
                - _resolve(base, obj.denominator)
            )
            frac = (num / den) if den > 0 else 0.0
            return {
                "burn": max(frac, 0.0) / obj.budget,
                "violations": int(max(num, 0)),
                "events": int(max(den, 0)),
                "window_covered_s": round(covered, 1),
            }
        # throughput floor: burn = floor / achieved rate (>1 = violating).
        # Zero traffic against a floor is a full-rate burn, not a crash.
        delta = _resolve(cur, obj.counter) - _resolve(base, obj.counter)
        rate = max(delta, 0.0) / covered
        burn = (obj.min_per_s / rate) if rate > 0 else float(10 * obj.fast_threshold or 10.0)
        return {
            "burn": burn,
            "rate_per_s": round(rate, 3),
            "window_covered_s": round(covered, 1),
        }

    # ---------------------------------------------------------- evaluate
    def evaluate(self) -> dict[str, dict]:
        """Take a snapshot and re-derive every objective's burn state.
        Returns {objective: {fast, slow, tripped, ...}}; fires on_trip
        hooks on rising edges."""
        now = self._clock()
        cur = self.stats_provider()
        rising: list[tuple[str, dict]] = []
        falling: list[tuple[str, dict]] = []
        with self._lock:
            self.evaluations += 1
            results: dict[str, dict] = {}
            fast_base = self._baseline(now, self.fast_window_s)
            slow_base = self._baseline(now, self.slow_window_s)
            for obj in self.objectives:
                fast = (
                    self._burn(obj, fast_base[0], fast_base[1], now, cur)
                    if fast_base is not None else None
                )
                slow = (
                    self._burn(obj, slow_base[0], slow_base[1], now, cur)
                    if slow_base is not None else None
                )
                tripped = bool(
                    fast is not None and slow is not None
                    and fast["burn"] > obj.fast_threshold
                    and slow["burn"] > obj.slow_threshold
                )
                detail = {
                    "kind": obj.kind,
                    "fast": fast,
                    "slow": slow,
                    "fast_threshold": obj.fast_threshold,
                    "slow_threshold": obj.slow_threshold,
                    "tripped": tripped,
                }
                results[obj.name] = detail
                if tripped and obj.name not in self._tripped:
                    self._tripped.add(obj.name)
                    self.trip_counts[obj.name] += 1
                    rising.append((obj.name, detail))
                elif not tripped and obj.name in self._tripped:
                    self._tripped.discard(obj.name)
                    falling.append((obj.name, detail))
            self._last_eval = results
            self._snaps.append((now, cur))
            self._thin(now)
        for name, detail in rising:
            logger.warning(
                "SLO TRIP %s: fast burn %.2fx (>%.1fx), slow burn %.2fx "
                "(>%.1fx)", name,
                detail["fast"]["burn"], detail["fast_threshold"],
                detail["slow"]["burn"], detail["slow_threshold"],
            )
            for hook in list(self.on_trip):
                try:
                    hook(name, detail)
                except Exception:
                    logger.exception("slo on_trip hook failed for %s", name)
        for name, detail in falling:
            logger.info("SLO trip cleared: %s", name)
            for hook in list(self.on_clear):
                try:
                    hook(name, detail)
                except Exception:
                    logger.exception("slo on_clear hook failed for %s", name)
        return results

    def tripped(self) -> list[str]:
        """Names of objectives currently in trip (as of the last
        evaluate()) — the canary burn-in's input."""
        with self._lock:
            return sorted(self._tripped)

    # ------------------------------------------------------------ exports
    def snapshot(self) -> dict:
        """The /debug/slo payload."""
        with self._lock:
            return {
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "evaluations": self.evaluations,
                "snapshots_held": len(self._snaps),
                "trip_counts": dict(self.trip_counts),
                "tripped": sorted(self._tripped),
                "objectives": dict(self._last_eval),
            }

    def gauges(self) -> dict[str, Any]:
        """Flat numeric view for /metrics (llm_scheduler_slo_* gauges)."""
        with self._lock:
            out: dict[str, Any] = {"evaluations": self.evaluations}
            for name, detail in self._last_eval.items():
                if detail.get("fast"):
                    out[f"{name}_fast_burn"] = round(
                        detail["fast"]["burn"], 4
                    )
                if detail.get("slow"):
                    out[f"{name}_slow_burn"] = round(
                        detail["slow"]["burn"], 4
                    )
                out[f"{name}_tripped"] = bool(detail["tripped"])
                out[f"{name}_trips_total"] = self.trip_counts.get(name, 0)
        return out

    # ---------------------------------------------------------- lifecycle
    def start(self, interval_s: float = 10.0) -> None:
        """Background evaluation ticker (same restartable discipline as
        EngineSampler: stop() sets the event, start() clears it).
        IDEMPOTENT under repeated controller restarts: a double start is
        a no-op while the ticker lives (never a second thread), and a
        start racing a stop waits for the old thread to be joined
        before clearing the stop event (clearing it early would revive
        the dying thread alongside the new one)."""
        with self._lifecycle:
            if self._thread is not None:
                return
            self._stop.clear()
            interval = max(0.05, float(interval_s))

            def run() -> None:
                while not self._stop.wait(interval):
                    try:
                        self.evaluate()
                    except Exception:
                        logger.exception("slo evaluation failed")

            self._thread = threading.Thread(
                target=run, daemon=True, name="slo-engine"
            )
            self._thread.start()

    def stop(self) -> None:
        """Idempotent: the first caller joins the ticker exactly once
        (MetricsServer.stop and the owner's own shutdown path may both
        call this); later callers find no thread and return."""
        with self._lifecycle:
            self._stop.set()
            thread = self._thread
            self._thread = None
            if thread is not None:
                thread.join(timeout=5)


def from_config(
    slo_cfg: dict[str, Any], stats_provider: Callable[[], dict],
    clock: Callable[[], float] = time.monotonic,
) -> SloEngine | None:
    """Build an SloEngine from the config `slo` section (None when
    disabled or no objectives are declared)."""
    if not slo_cfg or not slo_cfg.get("enabled"):
        return None
    objectives = [
        SloObjective.from_dict(d) for d in slo_cfg.get("objectives") or []
    ]
    if not objectives:
        return None
    return SloEngine(
        objectives,
        stats_provider,
        fast_window_s=float(slo_cfg.get("fast_window_s", 300.0)),
        slow_window_s=float(slo_cfg.get("slow_window_s", 3600.0)),
        clock=clock,
    )
