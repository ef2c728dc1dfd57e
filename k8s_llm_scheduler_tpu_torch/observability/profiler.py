"""Continuous engine profiler: per-wave step timelines + MFU loss terms.

The JAX package's observability/profiler.py, ported: the bookkeeping is a
copy (host-only: segments, rings, gauges, snapshot()); `detect_peak_tflops`
reads the CUDA device's name, and the engine's fences read perf_counter
and query CUDA events (engine/graphs.Fence), never synchronize.

This profiler fences every decision wave with perf_counter reads at its
dispatch and sync boundaries (engine/engine.py submit_wave /
harvest_wave; engine/local.py contributes the queue-side fences) and
buckets the wave's wall time into NAMED SEGMENTS that telescope exactly:

    queue_stall    oldest item enqueued -> submit entered (admission wait,
                   coalescing window, group-switch fairness holds)
    dispatch       submit entered -> the wave dispatcher queued the wave's
                   suffix prefill, its first device program (host staging,
                   and the dispatcher's queue behind earlier waves)
    dispatch_gap   dispatch done -> harvest entered (pipelining overlap:
                   the worker polls the queue / feeds later waves here)
    host_sync      harvest entered -> results on the host (the dispatcher
                   queueing the block iterations, the device tail, the
                   copy to pinned memory)
    harvest        results on the host -> decoded into token streams
    unattributed   wall - sum(above): clock-fence residue, reported as its
                   own segment so coverage is verifiable (>= 95% of wave
                   wall by construction; the acceptance test pins it)

Overlapping those host segments, `device_compute` estimates when the
device was actually busy on this wave (dispatch end -> result ready; the
ready edge comes from the worker's is_ready() poll, a CUDA event query,
or the results' arrival on a blocking harvest). From token counts and the model config the
profiler computes per-wave achieved FLOPs, so `mfu_decode` decomposes:

    mfu_decode + sum(mfu_loss[segment]) ~= mfu_device

where mfu_device is what the device-busy time alone would achieve and
each loss term charges a named idle segment its share of the gap. The
bounded ring exports at /debug/profile (observability/metrics.py) and the
windowed means surface as Prometheus gauges — this is the layer every
subsequent perf PR proves itself against.

The admission plane (engine/admission/) gets the same treatment: each
packed admission contributes a record whose PACK_SEGMENTS telescope to
its host wall (admission_pack / chunk_prefill / decode_piggyback /
unattributed, sum == wall), and a `prefill_tokens_per_decision` gauge —
windowed (wave suffix + packed + prefix tokens ACTUALLY prefilled) per
decision — measures the delta-encoding claim directly: prefill cost
scaling with what changed, not cluster size. The speculative pipeline
(spec/decoder.py) books per-request SPEC_SEGMENTS (draft / verify /
rollback / unattributed, sum == wall) plus the measured round-overlap
fraction — the draft-runs-in-the-shadow-of-the-verify claim, measured.

Cost discipline: all fencing is perf_counter reads on the PER-WAVE path,
never per token, and no fence synchronizes the device; with no profiler
attached the engine pays one None check per wave. chip_smoke.py's
decision phase measures the cost with the profiler on.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any

logger = logging.getLogger(__name__)

# Telescoping host-side segments, in timeline order. `device_compute` is
# NOT in this list: it overlaps dispatch_gap/host_sync and is reported as
# its own (estimated) figure beside them.
SEGMENTS = (
    "queue_stall",
    "dispatch",
    "dispatch_gap",
    "host_sync",
    "harvest",
    "unattributed",
)

# Packed-admission segments (engine.admit_packed — the admission plane),
# telescoping over each pack's host wall time with the same sum==wall
# identity the wave segments keep: admission_pack is host-side packing /
# bookkeeping, chunk_prefill the packed block-diagonal prefill dispatches,
# decode_piggyback the SARATHI decode chunks interleaved between them.
PACK_SEGMENTS = (
    "admission_pack",
    "chunk_prefill",
    "decode_piggyback",
    "unattributed",
)

# Fused-decode segments (engine.step_fused / decode_fused — the fused
# on-device runtime, engine/fused/): telescoping over each fused harvest's
# host wall with the same sum==wall identity. dispatch is the back-to-back
# chunk enqueues (no syncs), host_sync the per-chunk sync window,
# harvest the host-side token decode after the last sync.
FUSED_SEGMENTS = (
    "dispatch",
    "host_sync",
    "harvest",
    "unattributed",
)

# Persistent-loop segments (engine/persistent/ — the device-resident
# serving loop): telescoping over each step_persistent harvest's host
# wall with the same sum==wall identity. ring_wait is the host blocking
# on TokenRing.drain (waiting for the loop to push), harvest the host-
# side booking of drained batches, loop_resident everything else — the
# window where the device loop ran with NO host involvement at all. The
# whole point of the subsystem is that loop_resident dominates while
# dispatches_per_decision (the flow books below) reads zero.
PERSISTENT_SEGMENTS = (
    "ring_wait",
    "loop_resident",
    "harvest",
    "unattributed",
)

# Sub-decomposition of `loop_resident` itself (observability/resident.py
# + engine._decompose_loop_resident): the device-resident counter block
# exported through the StatsRing splits the opaque in-loop window by
# counter deltas — admissions taken, decode steps run, token-ring
# backpressure stalls, idle chunks. Telescoping over loop_resident with
# the same sum==wall identity (the last segment is the exact remainder),
# pinned like every other segment family. Only booked for windows where
# a telemetry snapshot landed (telemetry off -> sub-books untouched).
PERSISTENT_LOOP_SEGMENTS = (
    "admit",
    "decode",
    "ring_stall",
    "idle",
)

# Speculative-decoding segments (spec/decoder.py — the async
# propose/verify pipeline): telescoping over each spec REQUEST's host
# wall with the same sum==wall identity. draft covers propose dispatches
# (draft prefill + fresh + ahead — ~0 for the hidden arm, whose
# proposals ride inside the verify program), verify the verify dispatch
# plus the round's single sync, rollback the paged-KV truncate +
# host emit bookkeeping. Beside the segments, the books carry the round
# OVERLAP fraction — rounds whose proposal block was device-resident
# before the round began, i.e. the draft work hidden behind the previous
# verify sync — the async pipeline's headline.
SPEC_SEGMENTS = (
    "draft",
    "verify",
    "rollback",
    "unattributed",
)

# Peak dense bf16 TFLOP/s (tensor cores, no sparsity) by CUDA device name
# as torch.cuda.get_device_name reports it (NVIDIA's data sheets, at each
# part's full power limit).
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,   # H100 SXM5
    "NVIDIA H100 PCIe": 756.0,
    "NVIDIA H100 NVL": 835.0,
    "NVIDIA H200": 989.0,
    "NVIDIA A100-SXM4-80GB": 312.0,
    "NVIDIA A100-SXM4-40GB": 312.0,
    "NVIDIA A100 80GB PCIe": 312.0,
}


def matmul_flops_per_token(cfg) -> float:
    """Dense matmul FLOPs for one token's forward pass (2*MACs).
    The JAX package's bench.py shares this accounting, so an MFU
    decomposition and a bench headline read one set of books."""
    d, hd = cfg.d_model, cfg.head_dim
    attn_proj = (
        d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
        + cfg.n_heads * hd * d
    )
    mlp = 3 * d * cfg.d_ff
    lm_head = d * cfg.vocab_size
    return 2.0 * (cfg.n_layers * (attn_proj + mlp) + lm_head)


def attn_flops_per_token(cfg, ctx: float) -> float:
    """Attention score+value FLOPs for one token attending to `ctx` keys."""
    return 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * ctx


def detect_peak_tflops(override: float | None = None) -> tuple[float | None, str]:
    """(peak bf16 TFLOP/s or None if unknown, device kind): the kind is
    CUDA device 0's name, "cpu" without a card; only a name in
    PEAK_BF16_TFLOPS has a peak."""
    try:
        import torch

        kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    except Exception:  # pragma: no cover - a broken CUDA install
        kind = "unknown"
    if override is not None:
        return override, kind
    return PEAK_BF16_TFLOPS.get(kind), kind


class EngineProfiler:
    """Per-wave step-timeline recorder for one InferenceEngine.

    The engine owns the fences (it is the only code that knows where its
    dispatch and sync boundaries are); this class owns the bookkeeping:
    in-flight wave state keyed by handle identity, a bounded ring of
    completed wave records, and the derived segment/MFU aggregates.

    Thread model: on_submit/note_ready/on_harvest run on the engine-owner
    thread; note_admission runs there too (engine/local._submit_waves).
    snapshot()/gauges() are called from metrics-server handler threads —
    ring and totals are guarded by one lock, acquired once per wave and
    once per scrape.
    """

    def __init__(
        self,
        cfg: Any = None,
        *,
        window: int = 256,
        peak_tflops: float | None = None,
        clock=time.perf_counter,
    ) -> None:
        self.cfg = cfg
        self.window = max(1, int(window))
        self._clock = clock
        peak, kind = detect_peak_tflops(peak_tflops)
        self.peak_flops = peak * 1e12 if peak else None
        self.device_kind = kind
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=self.window)
        # in-flight fence state, keyed by id(handle): a handle is submitted
        # and harvested exactly once, and the engine-owner thread does both
        self._open: dict[int, dict] = {}
        self._wave_counter = 0
        self._totals = {name: 0.0 for name in SEGMENTS}
        self._totals["device_compute"] = 0.0
        self._totals["wall"] = 0.0
        self._flops_total = 0.0
        self._tokens_total = 0
        self.waves_profiled = 0
        # CUMULATIVE (never-windowed) segment books beside the windowed
        # ones: monotone counters the SLO burn-rate engine can window
        # itself (delta against its own baselines) — an error_rate
        # objective over queue_stall_ms_total/wall_ms_total is the
        # admission-pressure objective the autoscaler consumes without a
        # custom stats provider. The windowed `*_frac` gauges cannot
        # serve that role: eviction makes them non-monotone.
        self._cum = {name: 0.0 for name in SEGMENTS}
        self._cum["wall"] = 0.0
        # Admission-plane books: per-pack records (engine.admit_packed)
        # and the prefill-tokens-per-decision gauge inputs. Prefix
        # prefills contribute only their NON-REUSED tokens — the delta
        # path's O(changed) claim is measured on exactly this figure.
        self._pack_ring: deque[dict] = deque(maxlen=self.window)
        self._pack_totals = {name: 0.0 for name in PACK_SEGMENTS}
        self._pack_totals["wall"] = 0.0
        # Fused-decode books (engine/fused/): per-harvest records with
        # telescoping FUSED_SEGMENTS and their own MFU figure — the
        # before/after proof the fused runtime is measured against.
        self._fused_ring: deque[dict] = deque(maxlen=self.window)
        self._fused_totals = {name: 0.0 for name in FUSED_SEGMENTS}
        self._fused_totals["wall"] = 0.0
        self._fused_flops = 0.0
        self._fused_tokens = 0
        self.fused_profiled = 0
        self._prefix_prefills: deque[tuple[int, int]] = deque(
            maxlen=self.window
        )  # (tokens prefilled, prefix length)
        self.packs_profiled = 0
        # Speculative-pipeline books (spec/decoder.py): per-request
        # records with telescoping SPEC_SEGMENTS plus windowed round /
        # overlap counts — the draft/verify overlap fraction is derived
        # from exactly these.
        self._spec_ring: deque[dict] = deque(maxlen=self.window)
        self._spec_totals = {name: 0.0 for name in SPEC_SEGMENTS}
        self._spec_totals["wall"] = 0.0
        self._spec_rounds = 0
        self._spec_overlapped = 0
        self._spec_tokens = 0
        self.spec_profiled = 0
        # Persistent-loop books (engine/persistent/): per-harvest records
        # with telescoping PERSISTENT_SEGMENTS — the residency proof the
        # zero-dispatch loop is measured against.
        self._pers_ring: deque[dict] = deque(maxlen=self.window)
        self._pers_totals = {name: 0.0 for name in PERSISTENT_SEGMENTS}
        self._pers_totals["wall"] = 0.0
        self._pers_steps = 0
        self._pers_tokens = 0
        self.persistent_profiled = 0
        # In-loop sub-books (PERSISTENT_LOOP_SEGMENTS): "wall" here is
        # the loop_resident covered by windows that CARRIED a telemetry
        # snapshot — the denominator the sub-fractions telescope over.
        self._pers_loop_totals = {
            name: 0.0 for name in PERSISTENT_LOOP_SEGMENTS
        }
        self._pers_loop_totals["wall"] = 0.0
        self.persistent_loop_profiled = 0
        # Monotone resident-token counter beside the windowed books — the
        # SLO throughput floor windows THIS with its own baselines (the
        # windowed figure is non-monotone under ring eviction; see the
        # _cum comment above).
        self._pers_tokens_cum = 0
        # Decision-flow books: (engine dispatches, decisions completed)
        # deltas booked at each completion window (engine.
        # _book_decision_flow). The windowed ratio is THE zero-dispatch
        # headline: 0.0 in persistent steady state, >= 1 on the dispatch
        # path. Dispatch deltas telescope exactly — every stats
        # "dispatches" bump lands in exactly one window — so the lifetime
        # sum of d_dispatches equals the engine's dispatch counter.
        self._flow_ring: deque[tuple[int, int]] = deque(maxlen=self.window)
        self._flow_dispatches = 0
        self._flow_decisions = 0
        self.closed = False

    # ------------------------------------------------------------- fences
    def on_submit(
        self,
        handle: Any,
        t_enter: float,
        t_exit: float,
        *,
        suffix_tokens: int,
        n_requests: int,
        prefix_len: int,
        cold_compile: bool,
    ) -> None:
        """submit_wave fencing: t_enter/t_exit bracket the dispatch
        (prompt packing + program enqueue + D2H kick)."""
        with self._lock:
            if len(self._open) > 64:
                # a leaked handle (harvest raised before reaching the
                # profiler fence) must not grow this map forever
                self._open.clear()
            self._open[id(handle)] = {
                "submit_enter": t_enter,
                "submit_exit": t_exit,
                "enqueued_at": None,
                "ready_at": None,
                "suffix_tokens": int(suffix_tokens),
                "n_requests": int(n_requests),
                "prefix_len": int(prefix_len),
                "cold_compile": bool(cold_compile),
            }

    def note_admission(self, handle: Any, oldest_enqueued_at: float) -> None:
        """Queue-side fence from engine/local.py: the oldest batch item's
        enqueue time (perf_counter) — the wave's queue_stall anchor."""
        with self._lock:
            st = self._open.get(id(handle))
            if st is not None:
                st["enqueued_at"] = float(oldest_enqueued_at)

    def note_dispatch_end(self, handle: Any, t: float) -> None:
        """The port's fence for the end of a wave's dispatch. submit_wave
        returns once the wave is handed to the engine's dispatcher thread,
        which queues its programs later; the dispatcher stamps the moment
        it queued the wave's first device program on the handle, and the
        owner thread books that stamp here, at harvest, in place of the
        submit's return (on_submit's t_exit)."""
        with self._lock:
            st = self._open.get(id(handle))
            if st is not None:
                st["submit_exit"] = max(float(t), st["submit_enter"])

    def note_ready(self, handle: Any) -> None:
        """The worker's is_ready() poll observed the device result landing
        (first call wins); on a blocking harvest the results' arrival
        stands in for this edge."""
        now = self._clock()
        with self._lock:
            st = self._open.get(id(handle))
            if st is not None and st["ready_at"] is None:
                st["ready_at"] = now

    def on_harvest(
        self,
        handle: Any,
        t_enter: float,
        t_sync: float,
        t_exit: float,
        *,
        decode_tokens: int,
        model_calls: int,
        ready_at_entry: bool,
        device_event_s: float | None = None,
    ) -> None:
        """harvest_wave fencing: t_enter -> t_sync brackets the wait for the results
        (the sync boundary), t_sync -> t_exit the host-side
        token decode. Completes the wave record. `device_event_s` (the
        port's): the wave's device time between two timing events recorded
        on its stream around its programs, outside any capture; booked
        beside the `device_compute` estimate as `device_event_ms`."""
        with self._lock:
            st = self._open.pop(id(handle), None)
        if st is None:
            return  # submitted before the profiler attached
        ready_at = st["ready_at"]
        if ready_at is None:
            # never observed by a poll: the result landed either before
            # harvest entry (charge the gap) or when they reached the host
            ready_at = t_enter if ready_at_entry else t_sync
        start = st["enqueued_at"]
        if start is None or start > st["submit_enter"]:
            start = st["submit_enter"]
        seg = {
            "queue_stall": max(st["submit_enter"] - start, 0.0),
            "dispatch": max(st["submit_exit"] - st["submit_enter"], 0.0),
            "dispatch_gap": max(t_enter - st["submit_exit"], 0.0),
            "host_sync": max(t_sync - t_enter, 0.0),
            "harvest": max(t_exit - t_sync, 0.0),
        }
        wall = max(t_exit - start, 0.0)
        seg["unattributed"] = max(wall - sum(seg.values()), 0.0)
        device = min(max(ready_at - st["submit_exit"], 0.0), wall)
        suffix_tokens = st["suffix_tokens"]
        tokens = suffix_tokens + int(decode_tokens)
        flops = self._wave_flops(
            st["prefix_len"], suffix_tokens, int(decode_tokens),
            st["n_requests"],
        )
        record = {
            "wave": 0,  # stamped under the lock below
            "n_requests": st["n_requests"],
            "cold_compile": st["cold_compile"],
            "wall_ms": wall * 1000.0,
            "segments_ms": {k: v * 1000.0 for k, v in seg.items()},
            "device_compute_ms": device * 1000.0,
            "suffix_tokens": suffix_tokens,
            "decode_tokens": int(decode_tokens),
            "model_calls": int(model_calls),
            "flops": flops,
        }
        if device_event_s is not None:
            record["device_event_ms"] = float(device_event_s) * 1000.0
        with self._lock:
            self._wave_counter += 1
            record["wave"] = self._wave_counter
            # the aggregates are WINDOWED over the ring: an evicted wave's
            # contribution leaves the books, so segment_frac / mfu gauges
            # track the last `window` waves and a fresh regression moves
            # them immediately instead of drowning in lifetime history
            if len(self._ring) == self._ring.maxlen:
                old = self._ring[0]
                if not old["cold_compile"]:
                    for name in SEGMENTS:
                        self._totals[name] = max(
                            self._totals[name]
                            - old["segments_ms"].get(name, 0.0) / 1000.0,
                            0.0,
                        )
                    self._totals["device_compute"] = max(
                        self._totals["device_compute"]
                        - old["device_compute_ms"] / 1000.0,
                        0.0,
                    )
                    self._totals["wall"] = max(
                        self._totals["wall"] - old["wall_ms"] / 1000.0, 0.0
                    )
                    self._flops_total = max(
                        self._flops_total - old["flops"], 0.0
                    )
                    self._tokens_total = max(
                        self._tokens_total
                        - (old["suffix_tokens"] + old["decode_tokens"]),
                        0,
                    )
            self._ring.append(record)
            self.waves_profiled += 1
            # cold-compile waves hit the ring (they are real wall time the
            # operator should see) but stay out of the MFU aggregates —
            # capture time would poison the loss attribution exactly the way
            # it poisons the service-time EMA (engine/local.py)
            if not st["cold_compile"]:
                for name in SEGMENTS:
                    self._totals[name] += seg.get(name, 0.0)
                    self._cum[name] += seg.get(name, 0.0)
                self._totals["device_compute"] += device
                self._totals["wall"] += wall
                self._cum["wall"] += wall
                self._flops_total += flops
                self._tokens_total += tokens

    def note_prefix_prefill(self, tokens_prefilled: int, prefix_len: int) -> None:
        """A cluster-state prefix (re)prefill happened: `tokens_prefilled`
        is what was actually COMPUTED (0 on a cache hit; only the
        non-reused tail on an LCP-seeded / pinned-snapshot prefill), so
        the prefill-tokens-per-decision gauge credits delta encoding with
        exactly the work it skipped."""
        with self._lock:
            self._prefix_prefills.append(
                (int(tokens_prefilled), int(prefix_len))
            )

    def on_pack(
        self,
        *,
        wall_s: float,
        chunk_prefill_s: float,
        piggyback_s: float,
        n_prompts: int,
        tokens: int,
        chunks: int,
    ) -> None:
        """One packed admission completed dispatching (engine.admit_packed;
        the host never synced — segments are host-side enqueue walls).
        admission_pack = wall minus the measured dispatch segments (the
        packing/bookkeeping share); the identity sum(segments) == wall
        holds by construction and the acceptance test pins it."""
        wall = max(float(wall_s), 0.0)
        seg = {
            "chunk_prefill": max(float(chunk_prefill_s), 0.0),
            "decode_piggyback": max(float(piggyback_s), 0.0),
        }
        seg["admission_pack"] = max(
            wall - seg["chunk_prefill"] - seg["decode_piggyback"], 0.0
        )
        seg["unattributed"] = max(wall - sum(seg.values()), 0.0)
        record = {
            "pack": 0,  # stamped under the lock below
            "n_prompts": int(n_prompts),
            "tokens": int(tokens),
            "chunks": int(chunks),
            "wall_ms": wall * 1000.0,
            "segments_ms": {k: v * 1000.0 for k, v in seg.items()},
        }
        with self._lock:
            self.packs_profiled += 1
            record["pack"] = self.packs_profiled
            if len(self._pack_ring) == self._pack_ring.maxlen:
                old = self._pack_ring[0]
                for name in PACK_SEGMENTS:
                    self._pack_totals[name] = max(
                        self._pack_totals[name]
                        - old["segments_ms"].get(name, 0.0) / 1000.0,
                        0.0,
                    )
                self._pack_totals["wall"] = max(
                    self._pack_totals["wall"] - old["wall_ms"] / 1000.0, 0.0
                )
            self._pack_ring.append(record)
            for name in PACK_SEGMENTS:
                self._pack_totals[name] += seg[name]
            self._pack_totals["wall"] += wall

    def on_fused(
        self,
        *,
        wall_s: float,
        dispatch_s: float,
        sync_s: float,
        harvest_s: float,
        steps: int,
        tokens: int,
        chunks: int,
        ctx: float = 0.0,
    ) -> None:
        """One fused harvest completed (engine.step_fused / decode_fused).
        The three measured segments partition the wall by construction
        (consecutive perf_counter fences), so sum(segments) == wall holds
        exactly and the acceptance test pins it. `tokens` counts EMITTED
        tokens (pad-filtered, early-exit aware) — never chunk capacity —
        and `ctx` is the mean decode attention context for the FLOP books.
        """
        wall = max(float(wall_s), 0.0)
        seg = {
            "dispatch": max(float(dispatch_s), 0.0),
            "host_sync": max(float(sync_s), 0.0),
            "harvest": max(float(harvest_s), 0.0),
        }
        seg["unattributed"] = max(wall - sum(seg.values()), 0.0)
        flops = 0.0
        if self.cfg is not None and tokens > 0:
            flops = tokens * (
                matmul_flops_per_token(self.cfg)
                + attn_flops_per_token(self.cfg, max(float(ctx), 0.0))
            )
        record = {
            "harvest": 0,  # stamped under the lock below
            "chunks": int(chunks),
            "steps": int(steps),
            "tokens": int(tokens),
            "wall_ms": wall * 1000.0,
            "segments_ms": {k: v * 1000.0 for k, v in seg.items()},
            "flops": flops,
        }
        with self._lock:
            self.fused_profiled += 1
            record["harvest"] = self.fused_profiled
            if len(self._fused_ring) == self._fused_ring.maxlen:
                old = self._fused_ring[0]
                for name in FUSED_SEGMENTS:
                    self._fused_totals[name] = max(
                        self._fused_totals[name]
                        - old["segments_ms"].get(name, 0.0) / 1000.0,
                        0.0,
                    )
                self._fused_totals["wall"] = max(
                    self._fused_totals["wall"] - old["wall_ms"] / 1000.0, 0.0
                )
                self._fused_flops = max(self._fused_flops - old["flops"], 0.0)
                self._fused_tokens = max(
                    self._fused_tokens - old["tokens"], 0
                )
            self._fused_ring.append(record)
            for name in FUSED_SEGMENTS:
                self._fused_totals[name] += seg.get(name, 0.0)
            self._fused_totals["wall"] += wall
            self._fused_flops += flops
            self._fused_tokens += int(tokens)

    def on_spec(
        self,
        *,
        wall_s: float,
        draft_s: float,
        verify_s: float,
        rollback_s: float,
        rounds: int,
        overlapped_rounds: int,
        tokens: int,
        arm: str = "draft",
        disabled: bool = False,
    ) -> None:
        """One speculative request closed (spec/decoder.py — at
        completion, or at the auto-disable hand-off, in which case the
        record covers only the speculative phase). The three measured
        segments partition the wall by construction (consecutive
        perf_counter fences accumulated over the request's rounds), so
        sum(SPEC_SEGMENTS) == wall holds exactly and the acceptance test
        pins it. `overlapped_rounds` counts rounds whose proposal block
        was device-resident when the round began — the draft stream
        running in the shadow of the verify."""
        wall = max(float(wall_s), 0.0)
        seg = {
            "draft": max(float(draft_s), 0.0),
            "verify": max(float(verify_s), 0.0),
            "rollback": max(float(rollback_s), 0.0),
        }
        seg["unattributed"] = max(wall - sum(seg.values()), 0.0)
        record = {
            "request": 0,  # stamped under the lock below
            "arm": str(arm),
            "rounds": int(rounds),
            "overlapped_rounds": int(overlapped_rounds),
            "tokens": int(tokens),
            "disabled": bool(disabled),
            "wall_ms": wall * 1000.0,
            "segments_ms": {k: v * 1000.0 for k, v in seg.items()},
        }
        with self._lock:
            self.spec_profiled += 1
            record["request"] = self.spec_profiled
            if len(self._spec_ring) == self._spec_ring.maxlen:
                old = self._spec_ring[0]
                for name in SPEC_SEGMENTS:
                    self._spec_totals[name] = max(
                        self._spec_totals[name]
                        - old["segments_ms"].get(name, 0.0) / 1000.0,
                        0.0,
                    )
                self._spec_totals["wall"] = max(
                    self._spec_totals["wall"] - old["wall_ms"] / 1000.0, 0.0
                )
                self._spec_rounds = max(self._spec_rounds - old["rounds"], 0)
                self._spec_overlapped = max(
                    self._spec_overlapped - old["overlapped_rounds"], 0
                )
                self._spec_tokens = max(self._spec_tokens - old["tokens"], 0)
            self._spec_ring.append(record)
            for name in SPEC_SEGMENTS:
                self._spec_totals[name] += seg.get(name, 0.0)
            self._spec_totals["wall"] += wall
            self._spec_rounds += int(rounds)
            self._spec_overlapped += int(overlapped_rounds)
            self._spec_tokens += int(tokens)

    def on_persistent(
        self,
        *,
        wall_s: float,
        ring_wait_s: float,
        harvest_s: float,
        loop_resident_s: float,
        steps: int,
        tokens: int,
        batches: int,
        loop_segments: dict[str, float] | None = None,
    ) -> None:
        """One persistent-loop harvest window closed (engine.
        step_persistent): wall is the time since the previous harvest,
        ring_wait the TokenRing.drain block, harvest the host-side batch
        booking, loop_resident the remainder — device-resident serving
        with zero host involvement. The engine pre-clamps the measured
        segments to the wall, so sum(PERSISTENT_SEGMENTS) == wall holds
        exactly and the acceptance test pins it.

        `loop_segments` (optional) is the counter-delta decomposition of
        loop_resident into PERSISTENT_LOOP_SEGMENTS — already summing
        exactly to loop_resident_s (engine._decompose_loop_resident
        builds the last segment as the remainder); booked as-is, never
        renormalized, so the sub-family identity pin is end to end."""
        wall = max(float(wall_s), 0.0)
        seg = {
            "ring_wait": max(float(ring_wait_s), 0.0),
            "harvest": max(float(harvest_s), 0.0),
            "loop_resident": max(float(loop_resident_s), 0.0),
        }
        seg["unattributed"] = max(wall - sum(seg.values()), 0.0)
        record = {
            "harvest": 0,  # stamped under the lock below
            "batches": int(batches),
            "steps": int(steps),
            "tokens": int(tokens),
            "wall_ms": wall * 1000.0,
            "segments_ms": {k: v * 1000.0 for k, v in seg.items()},
        }
        if loop_segments is not None:
            record["loop_segments_ms"] = {
                name: max(float(loop_segments.get(name, 0.0)), 0.0) * 1000.0
                for name in PERSISTENT_LOOP_SEGMENTS
            }
        with self._lock:
            self.persistent_profiled += 1
            record["harvest"] = self.persistent_profiled
            if len(self._pers_ring) == self._pers_ring.maxlen:
                old = self._pers_ring[0]
                for name in PERSISTENT_SEGMENTS:
                    self._pers_totals[name] = max(
                        self._pers_totals[name]
                        - old["segments_ms"].get(name, 0.0) / 1000.0,
                        0.0,
                    )
                self._pers_totals["wall"] = max(
                    self._pers_totals["wall"] - old["wall_ms"] / 1000.0, 0.0
                )
                self._pers_steps = max(self._pers_steps - old["steps"], 0)
                self._pers_tokens = max(
                    self._pers_tokens - old["tokens"], 0
                )
                old_loop = old.get("loop_segments_ms")
                if old_loop is not None:
                    for name in PERSISTENT_LOOP_SEGMENTS:
                        self._pers_loop_totals[name] = max(
                            self._pers_loop_totals[name]
                            - old_loop.get(name, 0.0) / 1000.0,
                            0.0,
                        )
                    self._pers_loop_totals["wall"] = max(
                        self._pers_loop_totals["wall"]
                        - old["segments_ms"]["loop_resident"] / 1000.0,
                        0.0,
                    )
                    self.persistent_loop_profiled = max(
                        self.persistent_loop_profiled - 1, 0
                    )
            self._pers_ring.append(record)
            for name in PERSISTENT_SEGMENTS:
                self._pers_totals[name] += seg.get(name, 0.0)
            self._pers_totals["wall"] += wall
            self._pers_steps += int(steps)
            self._pers_tokens += int(tokens)
            self._pers_tokens_cum += int(tokens)
            if loop_segments is not None:
                for name in PERSISTENT_LOOP_SEGMENTS:
                    self._pers_loop_totals[name] += (
                        record["loop_segments_ms"][name] / 1000.0
                    )
                self._pers_loop_totals["wall"] += seg["loop_resident"]
                self.persistent_loop_profiled += 1

    def on_decision_flow(self, d_dispatches: int, d_decisions: int) -> None:
        """Book one completion window's (dispatch delta, decision delta).
        The engine calls this whenever decisions complete, with the engine
        dispatches issued since the PREVIOUS completion window — deltas
        telescope, so the windowed ratio charges every dispatch to
        exactly one batch of decisions."""
        d_disp = max(int(d_dispatches), 0)
        d_done = max(int(d_decisions), 0)
        if d_done <= 0:
            return
        with self._lock:
            if len(self._flow_ring) == self._flow_ring.maxlen:
                old_disp, old_done = self._flow_ring[0]
                self._flow_dispatches = max(
                    self._flow_dispatches - old_disp, 0
                )
                self._flow_decisions = max(
                    self._flow_decisions - old_done, 0
                )
            self._flow_ring.append((d_disp, d_done))
            self._flow_dispatches += d_disp
            self._flow_decisions += d_done

    def dispatches_per_decision(self) -> float | None:
        """Windowed engine dispatches per completed decision — 0.0 in
        persistent steady state (the zero-dispatch pin), >= 1 on the
        dispatch path. None until a completion window has been booked."""
        with self._lock:
            if self._flow_decisions <= 0:
                return None
            return round(self._flow_dispatches / self._flow_decisions, 4)

    def _prefill_tokens_per_decision_locked(self) -> float | None:
        """Windowed prefill tokens per decision: (wave suffix tokens +
        packed tokens + prefix tokens actually prefilled) / decisions.
        Caller holds the lock."""
        decisions = sum(r["n_requests"] for r in self._ring) + sum(
            r["n_prompts"] for r in self._pack_ring
        )
        if decisions <= 0:
            return None
        tokens = (
            sum(r["suffix_tokens"] for r in self._ring)
            + sum(r["tokens"] for r in self._pack_ring)
            + sum(t for t, _ in self._prefix_prefills)
        )
        return tokens / decisions

    # -------------------------------------------------------------- flops
    def _wave_flops(
        self,
        prefix_len: int,
        suffix_tokens: int,
        decode_tokens: int,
        n_requests: int = 1,
    ) -> float:
        """Achieved FLOPs of one wave: suffix prefill + block decode, both
        attending to the shared prefix (mean PER-REQUEST context ~ prefix +
        half that request's suffix+emission — the JAX package's bench.py
        MFU estimator; the wave total must be apportioned or a batched wave's
        attention term is overstated n_requests-fold)."""
        if self.cfg is None:
            return 0.0
        n = suffix_tokens + decode_tokens
        if n <= 0:
            return 0.0
        per_req = n / max(int(n_requests), 1)
        ctx = prefix_len + (per_req / 2.0)
        return n * (
            matmul_flops_per_token(self.cfg)
            + attn_flops_per_token(self.cfg, ctx)
        )

    # ------------------------------------------------------------- exports
    def _mfu(
        self, flops: float, wall: float, device: float, totals: dict
    ) -> dict | None:
        """The decomposition: mfu_decode + sum(loss terms) ~= mfu_device.

        The device is busy during [dispatch end, ready], which overlaps
        dispatch_gap and host_sync; each segment's loss term charges its
        NON-OVERLAPPED (device-idle) share, so the identity holds by
        construction: loss[s] = mfu_device * idle_s / wall and
        sum(idle) + device = wall. `totals` is the caller's copy taken
        under ONE lock acquisition together with flops/wall/device — a
        re-read here could include a wave the other figures don't."""
        if not self.peak_flops or wall <= 0 or flops <= 0:
            return None
        mfu = flops / wall / self.peak_flops
        if device <= 0:
            return {"decode": round(mfu, 5)}
        mfu_device = flops / device / self.peak_flops
        seg = {name: totals[name] for name in SEGMENTS}
        # device busy overlaps the gap first, then the sync window
        overlap_gap = min(seg["dispatch_gap"], device)
        overlap_sync = min(seg["host_sync"], device - overlap_gap)
        idle = dict(seg)
        idle["dispatch_gap"] = max(seg["dispatch_gap"] - overlap_gap, 0.0)
        idle["host_sync"] = max(seg["host_sync"] - overlap_sync, 0.0)
        loss = {
            name: round(mfu_device * idle_s / wall, 5)
            for name, idle_s in idle.items()
            if idle_s > 0
        }
        return {
            "decode": round(mfu, 5),
            "device": round(mfu_device, 5),
            "busy_frac": round(device / wall, 4),
            "loss": loss,
        }

    def snapshot(self) -> dict:
        """The /debug/profile payload: windowed segment totals/means, the
        MFU decomposition, and the per-wave ring."""
        with self._lock:
            ring = list(self._ring)
            totals = dict(self._totals)
            flops = self._flops_total
            tokens = self._tokens_total
            waves = self.waves_profiled
            pack_ring = list(self._pack_ring)
            pack_totals = dict(self._pack_totals)
            packs = self.packs_profiled
            fused_ring = list(self._fused_ring)
            fused_totals = dict(self._fused_totals)
            fused_flops = self._fused_flops
            fused_tokens = self._fused_tokens
            fused = self.fused_profiled
            spec_ring = list(self._spec_ring)
            spec_totals = dict(self._spec_totals)
            spec_rounds = self._spec_rounds
            spec_overlapped = self._spec_overlapped
            spec_tokens = self._spec_tokens
            spec = self.spec_profiled
            pers_ring = list(self._pers_ring)
            pers_totals = dict(self._pers_totals)
            pers_steps = self._pers_steps
            pers_tokens = self._pers_tokens
            pers = self.persistent_profiled
            pers_loop_totals = dict(self._pers_loop_totals)
            pers_loop = self.persistent_loop_profiled
            flow_disp = self._flow_dispatches
            flow_done = self._flow_decisions
            tpd = self._prefill_tokens_per_decision_locked()
        wall = totals["wall"]
        n_warm = sum(1 for r in ring if not r["cold_compile"])
        out: dict[str, Any] = {
            "waves_profiled": waves,
            "window": self.window,
            "device_kind": self.device_kind,
            "peak_bf16_tflops": (
                self.peak_flops / 1e12 if self.peak_flops else None
            ),
            "wall_ms_total": round(wall * 1000.0, 3),
            "segments_ms_total": {
                name: round(totals[name] * 1000.0, 3) for name in SEGMENTS
            },
            "device_compute_ms_total": round(
                totals["device_compute"] * 1000.0, 3
            ),
            "segment_frac": {
                name: round(totals[name] / wall, 4) if wall > 0 else 0.0
                for name in SEGMENTS
            },
            "coverage_frac": (
                round(
                    sum(totals[n] for n in SEGMENTS if n != "unattributed")
                    / wall,
                    4,
                )
                if wall > 0
                else 0.0
            ),
            "tokens": tokens,
            "achieved_tflops": (
                round(flops / wall / 1e12, 4) if wall > 0 else 0.0
            ),
            "warm_waves_in_window": n_warm,
            "ring": ring,
        }
        timed = [r for r in ring if not r["cold_compile"] and "device_event_ms" in r]
        if timed:
            # the warm waves' event-timed device ms, beside
            # device_compute_ms_total (the estimate over the same waves)
            out["device_event_ms_total"] = round(
                sum(r["device_event_ms"] for r in timed), 3)
        mfu = self._mfu(flops, wall, totals["device_compute"], totals)
        if mfu is not None:
            out["mfu"] = mfu
        if packs:
            pack_wall = pack_totals["wall"]
            out["packs"] = {
                "packs_profiled": packs,
                "wall_ms_total": round(pack_wall * 1000.0, 3),
                "segments_ms_total": {
                    name: round(pack_totals[name] * 1000.0, 3)
                    for name in PACK_SEGMENTS
                },
                "segment_frac": {
                    name: (
                        round(pack_totals[name] / pack_wall, 4)
                        if pack_wall > 0
                        else 0.0
                    )
                    for name in PACK_SEGMENTS
                },
                "ring": pack_ring,
            }
        if fused:
            fused_wall = fused_totals["wall"]
            fused_out: dict[str, Any] = {
                "harvests_profiled": fused,
                "tokens": fused_tokens,
                "wall_ms_total": round(fused_wall * 1000.0, 3),
                "segments_ms_total": {
                    name: round(fused_totals[name] * 1000.0, 3)
                    for name in FUSED_SEGMENTS
                },
                "segment_frac": {
                    name: (
                        round(fused_totals[name] / fused_wall, 4)
                        if fused_wall > 0
                        else 0.0
                    )
                    for name in FUSED_SEGMENTS
                },
                "ring": fused_ring,
            }
            if fused_wall > 0:
                fused_out["tokens_per_s"] = round(
                    fused_tokens / fused_wall, 1
                )
                fused_out["achieved_tflops"] = round(
                    fused_flops / fused_wall / 1e12, 4
                )
                if self.peak_flops and fused_flops > 0:
                    fused_out["mfu_decode"] = round(
                        fused_flops / fused_wall / self.peak_flops, 5
                    )
            out["fused"] = fused_out
        if spec:
            spec_wall = spec_totals["wall"]
            spec_out: dict[str, Any] = {
                "requests_profiled": spec,
                "tokens": spec_tokens,
                "rounds": spec_rounds,
                "overlapped_rounds": spec_overlapped,
                "overlap_fraction": (
                    round(spec_overlapped / spec_rounds, 4)
                    if spec_rounds > 0
                    else 0.0
                ),
                "wall_ms_total": round(spec_wall * 1000.0, 3),
                "segments_ms_total": {
                    name: round(spec_totals[name] * 1000.0, 3)
                    for name in SPEC_SEGMENTS
                },
                "segment_frac": {
                    name: (
                        round(spec_totals[name] / spec_wall, 4)
                        if spec_wall > 0
                        else 0.0
                    )
                    for name in SPEC_SEGMENTS
                },
                "ring": spec_ring,
            }
            if spec_wall > 0:
                spec_out["tokens_per_s"] = round(spec_tokens / spec_wall, 1)
            out["spec"] = spec_out
        if pers:
            pers_wall = pers_totals["wall"]
            pers_out: dict[str, Any] = {
                "harvests_profiled": pers,
                "steps": pers_steps,
                "tokens": pers_tokens,
                "wall_ms_total": round(pers_wall * 1000.0, 3),
                "segments_ms_total": {
                    name: round(pers_totals[name] * 1000.0, 3)
                    for name in PERSISTENT_SEGMENTS
                },
                "segment_frac": {
                    name: (
                        round(pers_totals[name] / pers_wall, 4)
                        if pers_wall > 0
                        else 0.0
                    )
                    for name in PERSISTENT_SEGMENTS
                },
                "ring": pers_ring,
            }
            if pers_wall > 0:
                pers_out["tokens_per_s"] = round(pers_tokens / pers_wall, 1)
            if pers_loop:
                loop_wall = pers_loop_totals["wall"]
                pers_out["loop_windows_profiled"] = pers_loop
                pers_out["loop_segments_ms_total"] = {
                    name: round(pers_loop_totals[name] * 1000.0, 3)
                    for name in PERSISTENT_LOOP_SEGMENTS
                }
                pers_out["loop_segment_frac"] = {
                    name: (
                        round(pers_loop_totals[name] / loop_wall, 4)
                        if loop_wall > 0
                        else 0.0
                    )
                    for name in PERSISTENT_LOOP_SEGMENTS
                }
            out["persistent"] = pers_out
        if flow_done > 0:
            out["dispatches_per_decision"] = round(
                flow_disp / flow_done, 4
            )
        if tpd is not None:
            out["prefill_tokens_per_decision"] = round(tpd, 2)
        return out

    def gauges(self) -> dict[str, float]:
        """Flat numeric view for /metrics (observability/metrics._flatten
        renders each as a llm_scheduler_engine_profile_* gauge)."""
        with self._lock:
            totals = dict(self._totals)
            cum = dict(self._cum)
            flops = self._flops_total
            waves = self.waves_profiled
            pack_totals = dict(self._pack_totals)
            packs = self.packs_profiled
            fused_totals = dict(self._fused_totals)
            fused_flops = self._fused_flops
            fused = self.fused_profiled
            spec_totals = dict(self._spec_totals)
            spec_rounds = self._spec_rounds
            spec_overlapped = self._spec_overlapped
            spec = self.spec_profiled
            pers_totals = dict(self._pers_totals)
            pers = self.persistent_profiled
            pers_loop_totals = dict(self._pers_loop_totals)
            pers_loop = self.persistent_loop_profiled
            flow_disp = self._flow_dispatches
            flow_done = self._flow_decisions
            tpd = self._prefill_tokens_per_decision_locked()
        wall = totals["wall"]
        out: dict[str, float] = {"waves_profiled": float(waves)}
        for name in SEGMENTS:
            out[f"{name}_frac"] = (
                round(totals[name] / wall, 4) if wall > 0 else 0.0
            )
            # monotone ms counters (module __init__ comment): what the
            # SLO engine's windowed deltas consume
            out[f"{name}_ms_total"] = round(cum[name] * 1000.0, 3)
        out["wall_ms_cum_total"] = round(cum["wall"] * 1000.0, 3)
        if packs:
            out["packs_profiled"] = float(packs)
            pack_wall = pack_totals["wall"]
            for name in PACK_SEGMENTS:
                out[f"pack_{name}_frac"] = (
                    round(pack_totals[name] / pack_wall, 4)
                    if pack_wall > 0
                    else 0.0
                )
        if fused:
            out["fused_profiled"] = float(fused)
            fused_wall = fused_totals["wall"]
            for name in FUSED_SEGMENTS:
                out[f"fused_{name}_frac"] = (
                    round(fused_totals[name] / fused_wall, 4)
                    if fused_wall > 0
                    else 0.0
                )
            if self.peak_flops and fused_wall > 0 and fused_flops > 0:
                out["fused_mfu_decode"] = round(
                    fused_flops / fused_wall / self.peak_flops, 5
                )
        if spec:
            out["spec_profiled"] = float(spec)
            spec_wall = spec_totals["wall"]
            for name in SPEC_SEGMENTS:
                out[f"spec_{name}_frac"] = (
                    round(spec_totals[name] / spec_wall, 4)
                    if spec_wall > 0
                    else 0.0
                )
            out["spec_overlap_frac"] = (
                round(spec_overlapped / spec_rounds, 4)
                if spec_rounds > 0
                else 0.0
            )
        if pers:
            out["persistent_profiled"] = float(pers)
            pers_wall = pers_totals["wall"]
            for name in PERSISTENT_SEGMENTS:
                out[f"persistent_{name}_frac"] = (
                    round(pers_totals[name] / pers_wall, 4)
                    if pers_wall > 0
                    else 0.0
                )
            if pers_loop:
                loop_wall = pers_loop_totals["wall"]
                for name in PERSISTENT_LOOP_SEGMENTS:
                    out[f"persistent_loop_{name}_frac"] = (
                        round(pers_loop_totals[name] / loop_wall, 4)
                        if loop_wall > 0
                        else 0.0
                    )
        if flow_done > 0:
            out["dispatches_per_decision"] = round(
                flow_disp / flow_done, 4
            )
        if tpd is not None:
            out["prefill_tokens_per_decision"] = round(tpd, 2)
        out["device_compute_frac"] = (
            round(totals["device_compute"] / wall, 4) if wall > 0 else 0.0
        )
        if wall > 0:
            out["achieved_tflops"] = round(flops / wall / 1e12, 4)
        mfu = self._mfu(flops, wall, totals["device_compute"], totals)
        if mfu is not None:
            out["mfu_decode"] = mfu["decode"]
            if "device" in mfu:
                out["mfu_device"] = mfu["device"]
            for name, value in (mfu.get("loss") or {}).items():
                out[f"mfu_loss_{name}"] = value
        return out

    def persistent_gauges(self) -> dict[str, float]:
        """The `llm_scheduler_persistent_*` gauge family: a flat numeric
        subtree the metrics server mounts at stats["persistent"] (the
        Prometheus renderer prefixes flattened paths with
        llm_scheduler_). Fleet-merge aware by NAMING: `*_frac` leaves
        average across replicas (fleetview._RATIO_SUFFIXES), plain
        counters/rates SUM — a fleet's resident tok/s is the sum of its
        replicas', its segment mix the mean. `tokens_total` is the
        monotone counter the SLO throughput floor windows."""
        with self._lock:
            pers_totals = dict(self._pers_totals)
            pers = self.persistent_profiled
            pers_tokens = self._pers_tokens
            pers_steps = self._pers_steps
            pers_loop_totals = dict(self._pers_loop_totals)
            pers_loop = self.persistent_loop_profiled
            tokens_cum = self._pers_tokens_cum
        out: dict[str, float] = {
            "harvests": float(pers),
            "steps": float(pers_steps),
            "tokens": float(pers_tokens),
            "tokens_total": float(tokens_cum),
            "loop_windows": float(pers_loop),
        }
        pers_wall = pers_totals["wall"]
        out["resident_tokens_per_s"] = (
            round(pers_tokens / pers_wall, 1) if pers_wall > 0 else 0.0
        )
        for name in PERSISTENT_SEGMENTS:
            out[f"{name}_frac"] = (
                round(pers_totals[name] / pers_wall, 4)
                if pers_wall > 0
                else 0.0
            )
        loop_wall = pers_loop_totals["wall"]
        for name in PERSISTENT_LOOP_SEGMENTS:
            out[f"loop_{name}_frac"] = (
                round(pers_loop_totals[name] / loop_wall, 4)
                if loop_wall > 0
                else 0.0
            )
        return out

    def close(self) -> None:
        """Flush any in-flight fence state (waves that will never harvest —
        backend shutdown fails them upstream) so shutdown leaves no
        half-open records; idempotent."""
        with self._lock:
            self._open.clear()
            self.closed = True
