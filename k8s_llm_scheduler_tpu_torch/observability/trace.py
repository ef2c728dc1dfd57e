"""Per-phase timing with histogram buckets, plus optional torch.profiler
capture (the JAX package's observability/trace.py; `device_trace` wraps
torch.profiler where the JAX one wraps jax.profiler).

The reference's only instrumentation is a running average of remote-API wall
time (reference scheduler.py:435-441; SURVEY §5 tracing: "none"). Here every
scheduling decision can be broken into phases —
watch -> snapshot -> prompt -> prefill -> decode -> bind — with a low-overhead
recorder.

Since the observability round the recorder keeps fixed LOG-SPACED buckets per
phase, not just count/total/max: averages hide exactly the tail the sim arena
(per-wave latency attribution) and the canary burn-in (regression trips)
decide on, and "bind p99 under burst" is unanswerable from a mean. The bucket
bounds are shared process-wide (`BUCKET_BOUNDS_S`), so two snapshots of the
same recorder subtract bucket-by-bucket — which is how per-wave and burn-in
WINDOW percentiles are derived (`delta_hist`, `hist_percentiles`).
"""

from __future__ import annotations

import contextlib
import logging
import math
import threading
import time
from typing import Any, Iterator

logger = logging.getLogger(__name__)

# Fixed log-spaced bucket bounds in SECONDS: 100 us doubling up to ~420 s.
# 23 buckets cover a 4-decade dynamic range (a 0.2 ms cache-hit bind to a
# multi-minute cold-compile decide) at <=2x resolution — fixed so every
# snapshot of every recorder subtracts bucket-by-bucket, and small enough
# that a snapshot copy is ~a hundred ints per phase.
BUCKET_BOUNDS_S: tuple[float, ...] = tuple(1e-4 * 2**i for i in range(23))

# Marker key for embedded histogram dicts: metrics._flatten skips them and
# render_prometheus turns them into `histogram` exposition families.
HIST_KEY = "_hist"


def hist_percentiles(
    counts: list[int], quantiles: tuple[float, ...] = (0.5, 0.95, 0.99)
) -> list[float]:
    """Percentile estimates (in ms) from NON-cumulative bucket counts.

    Reports the bucket's upper bound (the overflow bucket reports the last
    finite bound x2) — a deliberately conservative, monotone estimator: a
    derived p99 gauge must never understate the tail it summarizes."""
    total = sum(counts)
    out: list[float] = []
    bounds_ms = [b * 1000.0 for b in BUCKET_BOUNDS_S]
    overflow_ms = bounds_ms[-1] * 2.0
    for q in quantiles:
        if total <= 0:
            out.append(0.0)
            continue
        rank = q * total
        acc = 0
        value = overflow_ms
        for i, c in enumerate(counts):
            acc += c
            if acc >= rank:
                value = bounds_ms[i] if i < len(bounds_ms) else overflow_ms
                break
        out.append(value)
    return out


def delta_hist(before: dict | None, after: dict | None) -> dict | None:
    """Bucket-wise difference of two phase snapshots' histogram dicts —
    the window percentile instrument (arena per-wave attribution, canary
    burn-in): subtracting two cumulative snapshots yields the histogram of
    ONLY the events between them."""
    a = (after or {}).get(HIST_KEY)
    if a is None:
        return None
    b = (before or {}).get(HIST_KEY)
    if b is None:
        counts = list(a["counts"])
        return {
            "counts": counts,
            "sum_s": a["sum_s"],
            "count": a["count"],
        }
    counts = [max(x - y, 0) for x, y in zip(a["counts"], b["counts"])]
    return {
        "counts": counts,
        "sum_s": max(a["sum_s"] - b["sum_s"], 0.0),
        "count": max(a["count"] - b["count"], 0),
    }


class PhaseRecorder:
    """Thread-safe accumulator of per-phase durations.

    Per phase: count / total / max plus fixed log-spaced bucket counts
    (BUCKET_BOUNDS_S + one overflow bucket). The record path is one lock
    acquisition, one bisect-free bucket walk (bounds double, so
    `bit_length` indexes in O(1)), and three dict writes."""

    _N_BUCKETS = len(BUCKET_BOUNDS_S) + 1  # + overflow

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._count: dict[str, int] = {}
        self._total: dict[str, float] = {}
        self._max: dict[str, float] = {}
        self._buckets: dict[str, list[int]] = {}

    @staticmethod
    def _bucket_index(seconds: float) -> int:
        # bounds are 1e-4 * 2**i: the smallest i with seconds <= bound is
        # ceil(log2(seconds/1e-4)), computed via bit_length — no per-record
        # list scan. Float rounding at an exact boundary may land one
        # bucket up, which stays a valid (conservative) histogram.
        if seconds <= BUCKET_BOUNDS_S[0]:
            return 0
        ratio = math.ceil(seconds / 1e-4)
        return min((ratio - 1).bit_length(), len(BUCKET_BOUNDS_S))

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - start)

    def record(self, name: str, seconds: float) -> None:
        idx = self._bucket_index(seconds)
        with self._lock:
            if name not in self._count:
                self._count[name] = 0
                self._total[name] = 0.0
                self._max[name] = 0.0
                self._buckets[name] = [0] * self._N_BUCKETS
            self._count[name] += 1
            self._total[name] += seconds
            if seconds > self._max[name]:
                self._max[name] = seconds
            self._buckets[name][idx] += 1

    def snapshot(self) -> dict[str, dict[str, Any]]:
        """Consistent per-phase stats. State is COPIED under one lock
        acquisition and all derivation happens outside it: building the
        output dict entry-by-entry while racing record()/reset() is what
        once made `total/count` a divide-by-zero hazard (a reset between
        the total read and the count read), and long snapshot math must
        not hold the hot path's lock either way."""
        with self._lock:
            counts = dict(self._count)
            totals = dict(self._total)
            maxes = dict(self._max)
            buckets = {k: list(v) for k, v in self._buckets.items()}
        out: dict[str, dict[str, Any]] = {}
        for name, n in counts.items():
            total = totals.get(name, 0.0)
            bkt = buckets.get(name, [0] * self._N_BUCKETS)
            p50, p95, p99 = hist_percentiles(bkt)
            out[name] = {
                "count": n,
                "total_ms": total * 1000.0,
                "avg_ms": (total / max(n, 1)) * 1000.0,
                "max_ms": maxes.get(name, 0.0) * 1000.0,
                "p50_ms": p50,
                "p95_ms": p95,
                "p99_ms": p99,
                HIST_KEY: {
                    "counts": bkt,  # non-cumulative, overflow last
                    "sum_s": total,
                    "count": n,
                },
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._count.clear()
            self._total.clear()
            self._max.clear()
            self._buckets.clear()


# Global default recorder — components grab phases without plumbing.
recorder = PhaseRecorder()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace (CPU and, with a card, CUDA
    activity) around a block and export it as a Chrome trace into
    `log_dir` (trace-<pid>-<n>.json).

    The stop is guarded: a failed capture teardown (CUPTI died, disk full)
    must never MASK the block's own exception — the original error is what
    the operator needs."""
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        try:
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            n = len([f for f in os.listdir(log_dir) if f.startswith("trace-")])
            prof.export_chrome_trace(
                os.path.join(log_dir, f"trace-{os.getpid()}-{n}.json"))
        except Exception:
            logger.exception("device trace capture failed to stop cleanly")
