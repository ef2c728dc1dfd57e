"""Background engine telemetry sampler.

The engine's counters (engine/engine.py `stats`) are lifetime totals — a
scrape sees "4M decode tokens" but not "the engine sat at 12% batch
occupancy through the burst that just missed its SLO". This sampler turns
the totals into RING-BUFFERED TIME SERIES: a daemon thread snapshots the
engine every `interval_s` and derives

- `batch_occupancy`     in-flight paged slots / max_slots
- `kv_page_util`        allocated KV pages / pool size
- `prefix_cache_hit_rate`  prefix hits / (hits + prefills), lifetime ratio
- `tokens_per_s`        decode-token delta / wall delta (window rate);
                        counts EMITTED tokens (the engine books only
                        pad-filtered harvested tokens, exact under the
                        fused runtime's early-exiting chunks). A window
                        in which NO harvest sync landed reports None —
                        under fused chunked harvest the device may be
                        mid-chunk with tokens not yet visible, and a
                        fabricated 0.0 would saw-tooth the gauge at the
                        harvest cadence instead of measuring a rate.
- `hbm_used_frac`       bytes the caching allocator holds in tensors /
                        the card's memory (torch.cuda.memory_stats and
                        mem_get_info; None for an engine on the CPU)

`latest()` feeds /metrics as gauges; `series()` backs /debug/engine with
the full window, so "what did occupancy look like during the burst?" is
answerable after the fact without a dashboard stack. Sampling is read-only
against GIL-atomic engine state (dict reads, int reads) — no locks are
taken on the engine's hot path, same discipline as the stats providers.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any

logger = logging.getLogger(__name__)

SERIES = (
    "batch_occupancy",
    "kv_page_util",
    "prefix_cache_hit_rate",
    "tokens_per_s",
    "hbm_used_frac",
)


class EngineSampler:
    """Periodic sampler over one InferenceEngine (or anything shaped like
    it: `max_slots`, `free_slots`, `kv.pages_free`, `kv.num_pages`,
    `stats` dict). `clock` is injectable for deterministic tests."""

    def __init__(
        self,
        engine: Any,
        interval_s: float = 1.0,
        window: int = 600,
        clock=time.monotonic,
    ) -> None:
        self.engine = engine
        self.interval_s = max(0.05, float(interval_s))
        self.window = max(2, int(window))
        self._clock = clock
        self._lock = threading.Lock()
        self._series: dict[str, deque[tuple[float, float | None]]] = {
            name: deque(maxlen=self.window) for name in SERIES
        }
        self._last_tokens: tuple[float, int, int] | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.samples_taken = 0

    # ------------------------------------------------------------- sampling
    def _hbm_used_frac(self) -> float | None:
        device = getattr(self.engine, "device", None)
        if getattr(device, "type", None) != "cuda":
            return None  # an engine on the CPU (or a test double)
        try:
            import torch

            stats = torch.cuda.memory_stats(device)
            _, limit = torch.cuda.mem_get_info(device)
        except Exception:
            return None
        used = stats.get("allocated_bytes.all.current")
        if not used or not limit:
            return None
        return used / limit

    def sample_once(self) -> dict[str, float | None]:
        """Take one sample and append it to every series. Public so tests
        (and the /debug handler on a cold sampler) can tick explicitly."""
        eng = self.engine
        stats = dict(getattr(eng, "stats", {}) or {})
        out: dict[str, float | None] = {}

        max_slots = getattr(eng, "max_slots", 0) or 0
        free = getattr(eng, "free_slots", max_slots)
        out["batch_occupancy"] = (
            (max_slots - free) / max_slots if max_slots else None
        )

        kv = getattr(eng, "kv", None)
        num_pages = getattr(kv, "num_pages", 0) or 0
        pages_free = getattr(kv, "pages_free", num_pages)
        out["kv_page_util"] = (
            (num_pages - pages_free) / num_pages if num_pages else None
        )

        hits = stats.get("prefix_hits", 0)
        fills = stats.get("prefix_prefills", 0)
        out["prefix_cache_hit_rate"] = (
            hits / (hits + fills) if (hits + fills) else None
        )

        out["hbm_used_frac"] = self._hbm_used_frac()

        tokens = int(stats.get("decode_tokens", 0))
        # Harvest progress marker: dispatch-path harvests bump `syncs`,
        # but persistent-loop harvests are RING traffic — zero dispatches,
        # zero syncs (the whole point of engine/persistent/). Folding the
        # chunk counter in means resident emissions advance the rate
        # baseline too; without it steady-state serving read ~0 tok/s in
        # /debug/engine (every window looked "no harvest landed").
        syncs = int(stats.get("syncs", 0)) + int(
            stats.get("persistent_chunks", 0)
        )
        # The rate baseline, clock read, and ring appends share ONE lock
        # acquisition: the background thread and /debug/engine's
        # cold-sample path (handler threads) may sample concurrently, and
        # an unguarded read-modify-write of _last_tokens would compute a
        # rate against a stale baseline — while taking `now` inside the
        # lock keeps ring timestamps monotone (series() renders ages
        # relative to the last entry and assumes it is newest).
        with self._lock:
            now = self._clock()
            if self._last_tokens is not None:
                t_prev, n_prev, s_prev = self._last_tokens
                dt = now - t_prev
                if dt <= 0:
                    out["tokens_per_s"] = None
                elif syncs == s_prev and tokens == n_prev:
                    # No harvest landed in this window: under fused
                    # chunked harvest the device may be mid-chunk with
                    # emitted tokens not yet host-visible — the rate is
                    # UNKNOWN, not zero, and the baseline is NOT advanced:
                    # the next synced sample reports the exact emitted
                    # rate over the whole elapsed span, so tokens decoded
                    # during unsynced windows are never misattributed.
                    # (A window WITH a sync and zero new tokens is
                    # genuine idle and reports 0.0.)
                    out["tokens_per_s"] = None
                else:
                    out["tokens_per_s"] = max(tokens - n_prev, 0) / dt
                    self._last_tokens = (now, tokens, syncs)
            else:
                out["tokens_per_s"] = None
                self._last_tokens = (now, tokens, syncs)
            self.samples_taken += 1
            for name in SERIES:
                self._series[name].append((now, out[name]))
        return out

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                # one bad sample (engine mid-teardown) must not kill the
                # sampler thread for the process lifetime
                logger.exception("engine telemetry sample failed")

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._thread is not None:
            return
        # restartable: stop() leaves the event set, and a thread started
        # against a set event would exit its first wait() immediately
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="engine-sampler"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -------------------------------------------------------------- exports
    def latest(self) -> dict[str, float]:
        """Most recent non-None value per series — the /metrics gauges."""
        out: dict[str, float] = {}
        with self._lock:
            for name, ring in self._series.items():
                for _, value in reversed(ring):
                    if value is not None:
                        out[name] = round(value, 6)
                        break
            out["samples_taken"] = self.samples_taken
        return out

    def series(self) -> dict[str, Any]:
        """The full ring per series for /debug/engine: [[t, value], ...]
        with t relative to the newest sample (ages in seconds — wall-clock
        anchoring is the caller's concern, monotonic is ours)."""
        with self._lock:
            rings = {name: list(ring) for name, ring in self._series.items()}
        newest = max(
            (ring[-1][0] for ring in rings.values() if ring), default=0.0
        )
        return {
            "interval_s": self.interval_s,
            "window": self.window,
            "samples_taken": self.samples_taken,
            "series": {
                name: [
                    [round(t - newest, 3), value] for t, value in ring
                ]
                for name, ring in rings.items()
            },
        }
