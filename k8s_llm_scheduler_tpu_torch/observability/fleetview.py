"""Fleet telemetry aggregation: N replicas' telemetry merged into one view.

PR 6 made serving fleet-scale (sharded FleetReplicas, disaggregated
pools, replica wire) but telemetry stayed strictly per-process: 16
replicas meant 16 /metrics endpoints, 16 flight recorders, and no answer
to "what is the FLEET p99?". This module is the fan-in:

- `build_telemetry` renders one replica's pullable payload: its stats
  tree (histograms ride along as the embedded HIST_KEY bucket dicts),
  a since-cursor slice of its flight recorder (bounded by trace count
  AND bytes — FlightRecorder.export_slices), and its engine-sampler ring.
  This is what the `telemetry_pull` replica-wire op ships
  (sched/replica.py) and what in-process FleetReplicas serve directly.
- `FleetAggregator` polls N sources (remote ReplicaClients, in-process
  replicas, or anything callable), keeps per-source cursors, and merges:
  - **histograms** bucket-by-bucket — every PhaseRecorder shares the
    fixed process-wide bucket ladder (observability/trace.BUCKET_BOUNDS_S)
    precisely so two replicas' "decide" histograms ADD, and fleet
    p50/p95/p99 falls out of `hist_percentiles` over the summed counts
    (identical, within one bucket width, to recomputing from the raw
    samples — the merge loses nothing the bucketing hadn't already lost);
  - **counters** by summation (they are monotone counts);
  - **traces** by trace id: the ids already ride decision frames across
    the replica wire, so a coordinator-side decision trace and the
    worker-side `replica.decide` trace stitch into one span set here.
- Failure semantics: a replica that dies mid-pull degrades the view to
  the surviving members — its last-known payload is retained and marked
  STALE (with age), never silently dropped and never blocking the round.
  A replica joining mid-scrape simply contributes its partial (shorter)
  history; cumulative histograms make that sound by construction.

`FleetAggregator.render_prometheus()` emits ONE merged exposition
(observability/metrics.render_prometheus over the merged tree), and
`render_top` is the text frame behind `cli fleet top`.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable

from k8s_llm_scheduler_tpu_torch.observability.trace import (
    BUCKET_BOUNDS_S,
    HIST_KEY,
    hist_percentiles,
)

logger = logging.getLogger(__name__)

_N_BUCKETS = len(BUCKET_BOUNDS_S) + 1

# Defaults for one telemetry_pull frame: bounded so a 16-replica round
# never ships unbounded JSONL (the same caps /debug/* enforce).
DEFAULT_MAX_TRACES = 256
DEFAULT_MAX_BYTES = 1 << 20


def build_telemetry(
    stats: dict[str, Any],
    recorder: Any = None,
    sampler: Any = None,
    *,
    since_seq: int = 0,
    max_traces: int = DEFAULT_MAX_TRACES,
    max_bytes: int = DEFAULT_MAX_BYTES,
) -> dict[str, Any]:
    """One replica's pullable telemetry payload (wire-shaped: plain JSON
    types only)."""
    # Hoist the resident-loop gauge family (engine.get_stats nests it
    # under "engine") to the payload top level so the fleet merge and
    # `render_prometheus` expose it as llm_scheduler_persistent_* — the
    # SAME family name the per-replica /metrics mounts (metrics.py), so
    # dashboards need one query whichever endpoint they scrape.
    eng = stats.get("engine")
    if (
        isinstance(eng, dict)
        and isinstance(eng.get("persistent"), dict)
        and "persistent" not in stats
    ):
        stats = {**stats, "persistent": eng["persistent"]}
    out: dict[str, Any] = {
        "stats": stats,
        "traces": [],
        "next_cursor": since_seq,
        "truncated": False,
        "recorded_total": 0,
    }
    if recorder is not None:
        entries, next_cursor, truncated = recorder.export_slices(
            since_seq=since_seq, max_traces=max_traces, max_bytes=max_bytes,
        )
        out["traces"] = entries
        out["next_cursor"] = next_cursor
        out["truncated"] = truncated
        out["recorded_total"] = recorder.seq
    if sampler is not None:
        out["sampler"] = sampler.series()
    return out


def _merge_hist_stat(entries: list[dict]) -> dict:
    """Merge same-phase stat dicts (PhaseRecorder.snapshot leaf shape):
    buckets sum, derived fields recompute from the MERGED buckets."""
    counts = [0] * _N_BUCKETS
    sum_s = 0.0
    total_n = 0
    max_ms = 0.0
    for entry in entries:
        hist = entry.get(HIST_KEY) or {}
        ec = hist.get("counts") or []
        if len(ec) != _N_BUCKETS:
            continue  # foreign bucket ladder: refuse to merge garbage
        for i, c in enumerate(ec):
            counts[i] += int(c)
        sum_s += float(hist.get("sum_s", 0.0))
        total_n += int(hist.get("count", 0))
        max_ms = max(max_ms, float(entry.get("max_ms", 0.0)))
    p50, p95, p99 = hist_percentiles(counts)
    return {
        "count": total_n,
        "total_ms": sum_s * 1000.0,
        "avg_ms": (sum_s / total_n) * 1000.0 if total_n else 0.0,
        "max_ms": max_ms,
        "p50_ms": p50,
        "p95_ms": p95,
        "p99_ms": p99,
        HIST_KEY: {"counts": counts, "sum_s": sum_s, "count": total_n},
    }


# Numeric leaves that are NOT summable counters. `generation` is an epoch
# shared through the fleet's single L2 (fleet/cache.py) — every replica
# reports the same authority value, so the fleet figure is the max, not
# N times it. Ratio leaves (`*_rate`, `*_frac`) are per-replica derived
# values; the merged view reports their mean (the exact fleet ratio needs
# the underlying counters, which ARE summed wherever the tree carries
# them).
_EPOCH_LEAVES = frozenset({"generation", "known_generation"})
# `*_per_decision` is a derived per-replica ratio like the others —
# summing N replicas' dispatches_per_decision would report a fleet that
# pays N times the per-decision cost it actually does.
_RATIO_SUFFIXES = ("_rate", "_frac", "_per_decision")


def _merge_stats(trees: list[dict]) -> dict:
    """Recursive fleet merge of stats trees: histogram-bearing dicts merge
    bucket-wise, plain dicts merge by key union, numeric leaves SUM
    (nearly every numeric leaf in the stats contract is a monotone counter
    or a count; the exceptions — shared epochs and derived ratios, see
    _EPOCH_LEAVES/_RATIO_SUFFIXES — merge by max and mean). Strings keep
    the first value when all agree, else a "mixed" marker; lists are
    dropped (the per-replica view keeps them)."""
    trees = [t for t in trees if isinstance(t, dict)]
    if not trees:
        return {}
    if any(isinstance(t.get(HIST_KEY), dict) for t in trees):
        return _merge_hist_stat(trees)
    out: dict[str, Any] = {}
    keys: list[str] = []
    seen = set()
    for t in trees:
        for k in t:
            if k not in seen:
                seen.add(k)
                keys.append(k)
    for key in keys:
        values = [t[key] for t in trees if key in t]
        if any(isinstance(v, dict) for v in values):
            out[key] = _merge_stats([v for v in values if isinstance(v, dict)])
        elif all(isinstance(v, bool) for v in values):
            out[key] = any(values)
        elif all(isinstance(v, (int, float)) for v in values):
            if key in _EPOCH_LEAVES:
                out[key] = max(values)
            elif key.endswith(_RATIO_SUFFIXES):
                out[key] = round(sum(values) / len(values), 6)
            else:
                total = sum(values)
                out[key] = (
                    round(total, 6) if isinstance(total, float) else total
                )
        elif all(isinstance(v, str) for v in values):
            out[key] = values[0] if len(set(values)) == 1 else "mixed"
        # lists/None: dropped from the merged view
    return out


class _SourceState:
    __slots__ = (
        "pull", "cursor", "stats", "traces", "sampler", "last_ok_t",
        "failures", "stale", "pulls",
    )

    def __init__(self, pull: Callable[[int], dict]) -> None:
        self.pull = pull
        self.cursor = 0
        self.stats: dict = {}
        self.traces: deque[dict] = deque(maxlen=DEFAULT_MAX_TRACES * 4)
        self.sampler: dict | None = None
        self.last_ok_t = 0.0
        self.failures = 0
        self.stale = True  # never pulled yet
        self.pulls = 0


class FleetAggregator:
    """Merge N replicas' telemetry into one fleet view (module docstring).

    Sources are callables `pull(since_seq) -> payload` (build_telemetry
    shape). Thread-safe: pull_all serializes rounds; readers snapshot
    under the same lock."""

    def __init__(self, stale_after_s: float = 15.0, clock=time.monotonic) -> None:
        self.stale_after_s = float(stale_after_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._sources: dict[str, _SourceState] = {}
        self.rounds = 0

    # ------------------------------------------------------------- sources
    def add_source(self, name: str, pull: Callable[[int], dict]) -> None:
        with self._lock:
            self._sources[name] = _SourceState(pull)

    def add_replica_client(self, name: str, client: Any) -> None:
        """Source over a remote ReplicaClient (sched/replica.py
        telemetry_pull wire op)."""
        self.add_source(
            name, lambda since, c=client: c.telemetry_pull(since_seq=since)
        )

    def add_local(
        self, name: str, stats_provider: Callable[[], dict],
        recorder: Any = None, sampler: Any = None,
    ) -> None:
        """In-process source (FleetReplica / bench harnesses)."""
        self.add_source(
            name,
            lambda since, sp=stats_provider, r=recorder, s=sampler:
                build_telemetry(sp(), r, s, since_seq=since),
        )

    def remove_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    # --------------------------------------------------------------- pull
    def pull_all(self) -> dict[str, Any]:
        """One aggregation round: pull every source from its cursor.

        A raising source is marked failed (stale once stale_after_s has
        passed since its last good pull) and the round continues over the
        survivors — a dead replica degrades the view, never blocks it. A
        truncated slice advances the cursor and catches up next round."""
        with self._lock:
            sources = list(self._sources.items())
        ok = failed = 0
        for name, st in sources:
            try:
                payload = st.pull(st.cursor)
            except Exception as exc:
                st.failures += 1
                failed += 1
                logger.warning(
                    "telemetry pull from %s failed (%d consecutive): %s",
                    name, st.failures, exc,
                )
                continue
            with self._lock:
                st.failures = 0
                st.pulls += 1
                st.last_ok_t = self._clock()
                st.stale = False
                st.stats = payload.get("stats") or {}
                for entry in payload.get("traces") or []:
                    st.traces.append(entry)
                st.cursor = int(payload.get("next_cursor", st.cursor))
                if payload.get("sampler") is not None:
                    st.sampler = payload["sampler"]
            ok += 1
        with self._lock:
            self.rounds += 1
            now = self._clock()
            for _, st in sources:
                if st.failures and now - st.last_ok_t > self.stale_after_s:
                    st.stale = True
        return {"ok": ok, "failed": failed, "sources": len(sources)}

    # ------------------------------------------------------------- merged
    def merged_stats(self) -> dict[str, Any]:
        """One fleet-wide stats tree: counters summed, histograms merged
        bucket-by-bucket, percentiles recomputed from the merged buckets.
        Stale members still contribute their last-known payload (marked
        in source_status — known-stale data beats a silent hole)."""
        with self._lock:
            trees = [st.stats for st in self._sources.values() if st.stats]
        return _merge_stats(trees)

    def fleet_percentiles(self, phase: str = "decide") -> dict | None:
        """Fleet p50/p95/p99 of one phase from the MERGED buckets."""
        merged = self.merged_stats()
        entry = (merged.get("phases") or {}).get(phase)
        if not entry:
            return None
        return {
            k: entry[k]
            for k in ("count", "p50_ms", "p95_ms", "p99_ms", "max_ms")
        }

    def traces(self, n: int = 100) -> list[dict]:
        """Newest-last merged trace list, STITCHED by trace id: slices of
        the same trace pulled from different replicas (coordinator +
        worker sides of one decision) fuse into one entry with the union
        of their spans."""
        with self._lock:
            rows: list[tuple[str, dict]] = [
                (name, entry)
                for name, st in self._sources.items()
                for entry in st.traces
            ]
        by_id: dict[str, dict] = {}
        order: list[str] = []
        for source, entry in rows:
            tid = entry.get("trace_id")
            if tid not in by_id:
                merged = dict(entry)
                merged["spans"] = list(entry.get("spans") or [])
                merged["sources"] = [source]
                by_id[tid] = merged
                order.append(tid)
                continue
            tgt = by_id[tid]
            have = {s.get("span_id") for s in tgt["spans"]}
            tgt["spans"].extend(
                s for s in entry.get("spans") or []
                if s.get("span_id") not in have
            )
            meta = dict(tgt.get("meta") or {})
            meta.update(entry.get("meta") or {})
            tgt["meta"] = meta
            if source not in tgt["sources"]:
                tgt["sources"].append(source)
            # root-side fields win (the earlier-starting entry is the root)
            if (entry.get("start_unix") or 0) < (tgt.get("start_unix") or 0):
                for field in ("name", "start_unix", "dur_ms", "status"):
                    if field in entry:
                        tgt[field] = entry[field]
        merged_list = [by_id[tid] for tid in order]
        merged_list.sort(key=lambda e: e.get("start_unix") or 0.0)
        return merged_list[-n:]

    def source_status(self) -> dict[str, dict]:
        with self._lock:
            now = self._clock()
            return {
                name: {
                    "stale": st.stale,
                    "failures": st.failures,
                    "pulls": st.pulls,
                    "cursor": st.cursor,
                    "age_s": (
                        round(now - st.last_ok_t, 1) if st.last_ok_t else None
                    ),
                    "traces_held": len(st.traces),
                }
                for name, st in self._sources.items()
            }

    def render_prometheus(self) -> str:
        """ONE merged exposition for the whole fleet (same renderer the
        per-replica /metrics uses, over the merged tree)."""
        from k8s_llm_scheduler_tpu_torch.observability.metrics import (
            render_prometheus,
        )

        return render_prometheus(self.merged_stats())

    def snapshot(self) -> dict[str, Any]:
        return {
            "rounds": self.rounds,
            "sources": self.source_status(),
            "merged": self.merged_stats(),
        }


def render_top(agg: FleetAggregator, phases=("decide", "bind")) -> str:
    """The `cli fleet top` frame: fleet percentiles from merged buckets +
    a per-source row (decisions, decide p99, staleness)."""
    lines: list[str] = []
    merged = agg.merged_stats()
    status = agg.source_status()
    live = sum(1 for s in status.values() if not s["stale"])
    lines.append(
        f"fleet telemetry — {live}/{len(status)} sources live, "
        f"{agg.rounds} rounds"
    )
    for phase in phases:
        pct = (merged.get("phases") or {}).get(phase)
        if pct:
            lines.append(
                f"  fleet {phase:<8} n={pct['count']:<8} "
                f"p50={pct['p50_ms']:.1f}ms p95={pct['p95_ms']:.1f}ms "
                f"p99={pct['p99_ms']:.1f}ms max={pct['max_ms']:.1f}ms"
            )
    totals = {
        key: merged.get(key, 0)
        for key in (
            "total_scheduled", "llm_decisions", "cache_decisions",
            "fallback_decisions", "failed_bindings",
        )
    }
    lines.append(
        "  totals   "
        + "  ".join(f"{k}={v}" for k, v in totals.items())
    )
    # Fleet resident-loop headline (merge sums per-replica tok/s — the
    # fleet figure is genuine aggregate throughput, not an average).
    pers = merged.get("persistent")
    if pers:
        lines.append(
            "  resident "
            f"tok/s={float(pers.get('resident_tokens_per_s', 0.0)):.1f}  "
            f"tokens_total={int(pers.get('tokens_total', 0))}  "
            f"loop_windows={int(pers.get('loop_windows', 0))}"
        )
    with agg._lock:
        per_source = {
            name: st.stats for name, st in agg._sources.items()
        }
    lines.append(
        f"  {'source':<14} {'bound':>7} {'llm':>6} {'cache':>6} "
        f"{'decide_p99':>11} {'ring':>5} {'res_tok/s':>10} "
        f"{'shards':<18} state"
    )
    for name, stats in sorted(per_source.items()):
        st = status[name]
        phases_d = (stats.get("phases") or {}).get("decide") or {}
        shards = stats.get("owned_shards")
        pool = stats.get("pool_role")
        tag = f"pool={pool}" if pool else ""
        # Resident-loop columns: token-ring occupancy from the flat
        # persistent server counters (nested under "engine" by
        # sched/client.get_stats), resident tok/s from the hoisted
        # profiler gauge family. "-" when the replica has no resident
        # loop — most fleets are mixed during a persistent rollout.
        eng = stats.get("engine") or {}
        occ = eng.get("persistent_ring_occupancy_frac")
        ring = f"{occ:.2f}" if isinstance(occ, (int, float)) else "-"
        pers = stats.get("persistent") or eng.get("persistent") or {}
        tps = pers.get("resident_tokens_per_s")
        res = f"{tps:.1f}" if isinstance(tps, (int, float)) else "-"
        lines.append(
            f"  {name:<14} {stats.get('total_scheduled', 0):>7} "
            f"{stats.get('llm_decisions', 0):>6} "
            f"{stats.get('cache_decisions', 0):>6} "
            f"{phases_d.get('p99_ms', 0.0):>9.1f}ms "
            f"{ring:>5} {res:>10} "
            f"{str(shards if shards is not None else '-'):<18} "
            + ("STALE" if st["stale"] else "live")
            + (f" {tag}" if tag else "")
        )
    return "\n".join(lines)
