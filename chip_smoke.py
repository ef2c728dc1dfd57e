#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--out FILE.json]

Run from the root of the repository. It fails (non-zero exit, no result
line) when no CUDA device is visible or the port is not beside it.

Phases, each of which must pass:

1. Build: compiles the four hand-written CUDA kernels from
   k8s_llm_scheduler_tpu_torch/csrc (one nvcc per source, in parallel).
1a. cli verify: `python -m k8s_llm_scheduler_tpu_torch.cli verify` in a
   process of its own: every check `[ok]` (torch, numpy, the card's name
   and power limit, the four kernels built with nvcc, the config, a TINY
   forward launching K1 and K2, cluster access, the tokenizer), exit 0.
1b. cli run, the production entry point at full width: the port's
   WireFakeK8s (real HTTP) holding synthetic_nodes(32); a child process
   runs `cli.main(["run"])` against it (KubeCluster over the in-tree REST
   transport, LLM_MODEL=llama-3.1-8b-instruct, the config's defaults:
   temperature 0.3, packed admission and delta prompts on); then 24
   pending pods of 12 shapes are created over the wire (12 leaders against
   8 slots: two waves), and once they are bound 8 more of 8 new shapes (a
   warm R=8 wave). Once the fake shows all 32 bound (deadline 600 s)
   the child gets SIGINT and must exit 0 with its stats JSON. Every pod
   bound to a ready, feasible node, no fallback, every decision parsed,
   K1 and K2 launched in the child (counts zeroed just before cli.main).
   Prints each pod's pending -> bound time, the seconds between the two
   waves' harvests and the child's peak memory. The child runs with the
   operating plane on: the decision journal (durability.enabled, in its
   temporary directory), the wave profiler (on by default), metrics on
   port 0 and the SLO engine (one error-rate objective). Before SIGINT the
   phase scrapes /metrics, /debug/profile and /debug/slo and prints on one
   line the wave segments, device_compute, mfu_decode with the peak it
   used, dispatches_per_decision and prefill_tokens_per_decision. Fails
   if a record's segments do not sum to its wall, if they cover under 95%
   of it, or if an MFU share is above 1. It runs first, while no other 8B
   model is resident.
   Every child of the smoke runs in a temporary directory with the
   repository on its PYTHONPATH: the repo root's config.yaml would be
   read there, and a machine without PyYAML refuses a config file.
2. Kernels: K1 (shared-prefix flash partials) and K2 (causal in-chunk flash
   partials) on random bf16 inputs at every shape the decision phase gives
   them (taken from the engine's bucket and wave geometry for the smoke's
   own prompts: prefix chunks, suffix prefills, block decodes), each held
   against its plain PyTorch version on the same inputs (K1 at its planned
   key splits, so the combine kernel is held too; K1 also, untimed, at
   TINY's head dim 64 and g = 2, at 32-64 key splits mostly past
   prefix_len, at a buffer that is not whole key tiles and at an empty
   prefix: `K1_EDGE_CASES`; K2, untimed, at TINY, chunks that are not
   whole tiles, g = 1 and 8, lens 0, 1, > S and < 0: `K2_EDGE_CASES`).
   Queries are scaled so that attention is peaked; the normalized output
   o/l must agree within 3e-2 of the reference's RMS, m within 1e-4 (1 +
   max |m|), l within 1e-4 relative, and rows without a valid key must be
   exactly m = -1e30, l = 0. Times for the kernel, its plain version and one PyTorch library
   call (scaled_dot_product_attention) on the same inputs are device times:
   back-to-back calls captured in a CUDA graph, replayed between CUDA
   events (`_time_ms`). K1 and its SDPA yardstick are timed with a cold L2
   as the path meets it (the captured calls rotate over >= 4 distinct
   prefix buffers, 134 MB, since each layer reads its own prefix K/V) and
   again hot (one buffer replayed). K2 is timed hot (its inputs are just
   written by the layer) and cold (rotating input copies), beside SDPA
   with its dense mask and, where every len is S, SDPA with
   is_causal=True on each backend that runs it; its ratio is against the
   faster yardstick.
3. Reference: the main path at TINY width on the card (kernels) against the
   same weights on the CPU (plain versions): chunked prefix prefill, then a
   suffix prefill; logits within 5e-2 of the largest logit (bf16).
   Also, at TINY with the same weights: block decode with int8 weights and
   ragged matmuls (K3), the general path's buffered decode step with K4
   partials, and the manual-page decode step with K4 normalized.
4. Decision: a LocalLLMBackend with full-width, full-depth Llama-3.1-8B
   (random bf16 weights from a seed, greedy, batches as waves; built
   before phase 2, whose shapes it gives) serves 4 single decisions, then (once its idle worker has
   captured the sibling wave geometries: `prewarm_wave_siblings`) a batch
   of 8, then one more single decision under torch.profiler, for a 32-node
   synthetic cluster (a 5,488-token prefix: the chunked prefix prefill).
   It does so twice on the same weights: with the engine's waves as CUDA
   graphs (the default), then eagerly (graphs=False). Every decision must
   parse, name a feasible node and carry a confidence in [0, 1]; the two
   modes must emit identical greedy tokens wave for wave and row for row,
   launch each kernel as often per run of every step (prefix chunk, suffix
   prefill and block decode by row count R; a graph replay counts what its
   capture recorded), and in graph mode the batch must find its geometry
   captured and the profiled decision launch no kernel outside a graph
   (the profiler counts the host's launch calls and the device's
   operations per model call). K1 and K2 must have launched (every count
   is zeroed just before each mode's drive); K1's launches by step must
   add up to its total. Capture seconds, replays and peak memory are
   printed for each mode. Then, in graph mode: a thread waiting on a CUDA
   event must let other Python threads run (`gil_probe`), and of two warm
   R=8 waves submitted back to back the first must be harvested within
   1.25x a lone one's time, counted from its submit, with the tokens of
   the same waves run alone (`two_wave_overlap`: submit_wave returns at
   once; the wave dispatcher thread runs its iterations). Last, still in
   graph mode, two warm singles without the wave profiler and two with it
   (observability/profiler.EngineProfiler attached), then one more with
   it under torch.profiler: the profiler's cost in ms a decision is
   printed, and host launch calls a model call and host synchronizations
   a decision must equal those of the profiled decision without it.
4a. Admission, on the graph-mode engine of phase 4 (no second copy of
   the weights): (a) a LocalLLMBackend with the admission plane of
   the config's defaults takes the batch of 8 through
   get_scheduling_decisions_batch: one packed admission (chunks of 256,
   K1 in each chunk's prefix part, decode chunks piggybacked between
   them), decoded by step() to completion. All 8 must parse and name a
   feasible node, with 1 packed admission of 8 prompts in ceil(suffix
   tokens / 256) chunks, K1 launched 32 times in each ("pack chunk" step).
   Prints the batch's wall time, the piggybacked chunks, the decode steps
   and how many of the 8 token streams equal the wave batch's of phase 4
   (bf16: near-ties may flip, not gated), the pinned KV and peak memory.
   (b) At TINY (bf16: the kernels take bf16), three prompts (one shorter
   than a 16-token chunk, one spanning 14, one between), under the grammar
   and unconstrained: admit_packed with decode chunks piggybacked must
   emit the same tokens as with none and as each prompt's serial
   generate(), K1 4 times a chunk, and one pack chunk's end logits must
   be within 5e-2 of the largest of its CPU twin's.
4b. Loop: the scheduler's main path through its entry points, on the
   graph-mode engine of phase 4 (a new LocalLLMBackend over it with the
   config's default admission plane, as `cli run` maps it):
   `synthetic_cluster(32)` holding `pod_burst(32, distinct_shapes=8)`,
   added before the loop starts, the stack of `cli.build_stack` at the
   config's defaults around that backend (snapshot TTL 1 s,
   prefix prewarm tick 0.25 s), and Scheduler.run() until every pod is
   bound (deadline 300 s); then a second burst of 8 pods (one a shape) on
   the same cluster after the first's binds, through a new stack. Every
   pod must be bound to a ready node feasible
   for it, with no fallback decision, retry or backend error, the breaker
   closed, every LLM decision through get_scheduling_decision_async, and
   K1 and K2 launched in each burst (counts zeroed just before the first).
   The first burst's prompts must be the pinned snapshot, the second's a
   delta over the same pin, still held, and the prefill of the second
   burst's prefix must compute fewer tokens than the prefix, seeded from
   the pin, with K1 and K2 launched in it. Prints LLM
   decisions, cache and single-flight hits, waves and rows a wave, group
   installs, prefix prewarms, each pod's pending -> bound time, the drifted
   nodes, and the delta prefix prefill's tokens and ms.
4c. cli demo: `python -m k8s_llm_scheduler_tpu_torch.cli demo --model tiny
   --fake-nodes 4` in a process of its own (sampled at the config's 0.3):
   exit 0, 3 binds, no fallback.
5. Path A: the same 8B weights quantized to int8 on the card, in an engine
   with decode_matmul="ragged", the same drive in both modes, held the
   same way; all feasible, K3 and K1 launched, K3 7 times a layer (224)
   per block-decode run in both modes. The valid tokens of every
   block-decode call are recorded for phase 7.
6. Path B: the bf16 8B weights in an engine with paged_attn="pallas",
   max_slots 8, pages of 64: the cluster prefix installed, 8 suffixes
   admitted (unconstrained, greedy, 64 new tokens), step() until all
   finish, one generate(), then 8 more admitted with one step() under the
   profiler and the rest drained; in both modes (decode chunks as CUDA
   graphs, then eagerly). Every request finishes with 1-64 tokens, the
   modes emit identical tokens, K4 launched, launches per run equal, the
   graph-mode step launched no kernel outside a graph, and every page is
   returned. Its engines run fused_decode=False, so generate() drains
   through step() as before the fused runtime; that has phase 6c.
6c. Fused: path B's configuration, both modes: the 8 drained by step(),
   one generate() (which must go through decode_fused), then the 8 by
   decode_fused(): its tokens equal the step() drain's, it books exactly
   max(tokens) - 1 steps and sum(tokens - 1) decode tokens, and K4
   launches 32 times a step inside its program (graph mode: the launches
   of the conditional bodies that ran); the modes' tokens identical. Ms a
   step and tok/s beside path B's, and the device ms (CUDA events) of one
   live 16-step chunk and of the chunk's program run on the finished batch
   (mean of 10 back-to-back runs). Then one sampled drain at 0.3 with top-k 40 (graphs):
   every token a decodable id, never pad.
6d. Persistent (a): the 8B bf16 weights in an engine with
   paged_attn="gather" (the loop's own-token attention, as in the JAX
   loop), suffix bucket 256; the 8 suffixes admitted one at a time and
   drained by decode_fused give the reference; a warm-up residency
   captures the loop's two programs; then enter_persistent, the 8 through
   the command ring and step_persistent until done: the reference's
   tokens, the counter block's `emitted` equal to the decode tokens
   harvested, no torch op on the owner thread (a thread-local dispatch
   mode counts them) and no dispatch booked, K1 and K2 launched by the
   loop's admissions. Then a quiesce mid-stream and step_fused to the end:
   the reference's tokens again.
6g. Spec: speculative decoding (spec/) on the 8B bf16 weights of the
   resident backend, K = 4, two of the path B prompts behind the cluster
   prefix, 64 new tokens each: (a) the draft arm (a random TINY draft)
   and (b) the hidden arm (a random [4, 4096, 4096] head), greedy, with
   disable_threshold 0 so that every round speculates, in graph mode (two
   prompts) and eagerly (one); each prompt also through
   generate(use_spec=False) for ms a token beside ms a round. Every
   emitted token within 5e-2 of the largest |logit| of the target's argmax
   under one teacher-forced forward of prompt + output (bf16: the first
   divergence from the plain path is reported, not gated); one host sync
   at start and one a verify round; K1 launched 32 times at admission and
   32 times a verify round; graph and eager tokens identical. (c) the
   draft arm sampled at 0.3: every token legal. (d) the draft arm at the
   default threshold 0.3 with no prefix installed (K1 at prefix_len 0): the
   stream is handed back after 4 rounds and finishes through fused chunks,
   K4 launched. (e) TINY bf16 (the kernels take bf16), graphs: each arm
   (a random draft, the self-draft, the hidden head) token-identical to
   plain generate, unconstrained and under the decision grammar; the
   self-draft accepts K every round; sampled at 0.3, four streams of one
   prompt legal and not all equal (replays draw afresh). (f) `cli complete
   --spec` at TINY in a child, greedy through LLM_TEMPERATURE=0: exit 0
   and the stdout of the same command without --spec. (g) K1 at the verify
   shapes q[1,5] and q[1,1] against the 8B prefix buffer (prefix_len
   5,488) and the empty one (64 slots, prefix_len 0), held and timed as
   the other K1 shapes.
6a. Checkpoint: a TINY HF-layout safetensors checkpoint from a seed,
   written in the format's own few lines (no `safetensors` package), vocab
   widened for the builtin numeric tokenizer, loaded through
   build_local_backend(checkpoint_path=...) on the card and on the CPU,
   bf16 and int8: a suffix prefill's logits on the card within 5e-2 of
   the largest logit of the CPU load; one greedy decision on the card
   parses and names a feasible node.
6b. Sampled: a TINY engine on the card, graphs on, temperature 0.3, the
   decision grammar: after a wave that captures the geometry, two waves of
   8 copies of one prompt are replayed; their 16 streams must not all be
   equal (the generator registered with the graphs draws afresh) and each
   must parse and name a node.
6e. Persistent (b): TINY through LocalLLMBackend(persistent_loop=True) on
   the card (graphs, temperature 0.3, suffix bucket 1024): 6 decisions at
   once, every one admitted through the resident loop (no wave, no
   fallback, no wedge), parsed and feasible.
6h. Journal restart: `cli run` at TINY in a child over the port's
   WireFakeK8s with the decision journal on (durability.enabled, fsync
   "intent"); the child is SIGKILLed after its first bind, more pods are
   created while it is dead, and a second child restarts on the same
   journal (recovery, then the watch resumed from the journaled
   resourceVersion). Every pod must be bound exactly once (one binding
   POST a pod, no 409) to a ready node, the second child exit 0 on SIGINT,
   and `cli journal fsck` exit 0 with the journal clean.
6f. cli complete: `python -m k8s_llm_scheduler_tpu_torch.cli complete` at
   8B in a child process started after phase 6d (the TINY phases run
   beside it), greedy, 64 new tokens, on an 11,349-token prompt (past the
   largest prefill bucket, 8,192, by more than a prefix chunk): exit 0,
   text printed, the prompt's head through set_prefix's chunked path, K1
   and K2 launched in the child, the tail decoded by fused chunks; its
   wall time and peak memory.
7. K3, untimed, at `K3_EDGE_CASES` (TINY's widths, N and K not whole
   tiles, M = 96 and 384, totals 0 / 1 / 64 / 65 / M), then at the seven 8B
   weight shapes, int8 pairs and bf16, x [R*24, K] for R = 4 and 8, and
   totals 0, R*24 and the smallest, median and largest that path A ran:
   rows below `total` within 6e-2 of the reference's RMS (the error's RMS
   within 5e-3 of it), rows from ceil(total/64)*64 on exactly zero, outputs
   finite. Timed with a cold L2 (the captured calls rotate over copies of
   the weight, >= 134 MB in all, as each layer reads its own) and hot.
   Library yardstick, cold and hot: torch.matmul of the computed rows
   against a bf16 weight (for int8 a dequantized copy made beforehand, so
   it reads twice the weight bytes).
8. K4, untimed, at `K4_EDGE_CASES` (head dims 64 and 128; g 1, 2, 3, 4
   and 8; pages of 16 to 256 tokens; lens 0, 1, ps - 1, ps, ps + 1, P*ps,
   past P*ps and negative; scattered, descending and repeated page ids;
   one split, more splits planned than pages, and 40 splits), both modes;
   then at the shapes
   of path B's step, taken from its engine (its page geometry, its page
   tables padded with the trash row, its own-token lengths with the trash
   row's negative one), both modes, and at `K4_LONG` (every slot near 64
   pages), partials. Held like K1/K2 (empty rows exactly m = -1e30, l = 0,
   o = 0) and bitwise against a second call. Timed cold (the captured
   calls rotate over copies of the caches, >= 134 MB of valid K/V in all,
   since each layer reads its own cache) and, at path B's shapes, hot;
   after the CUDA-graph replays every split-merge counter must be 0.
   Library yardstick: SDPA on KV gathered beforehand (the gather is not
   timed), cold and hot.

The last lines are a JSON object with per-kernel numbers, the card's name
and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM published peaks (dense): bf16 tensor cores and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
# Bytes of distinct prefix K/V (K1) or weights (K3) that a cold-L2 timing
# rotates over: four layers' worth of K1's prefix at Sp 8192 (33.5 MB
# each), well past the 50 MB L2.
COLD_BYTES = 134_217_728
DEVICE = "cuda"  # where the K3/K4 cases run
NEG_INF = -1e30
N_SINGLES = 4  # single decisions before the batch of 8
BLOCK_F = 24  # the engine's wave block width
PATH_B_NEW_TOKENS = 64
# K3 against its plain version: both sum exact bf16 products in f32 and
# round once; they differ in the order of the sums, so an output element
# may round to a neighbouring bf16 value (one ulp: up to 1/128 of its
# size, 3.1e-2 of the RMS at the largest outputs of the first chip run).
# Held to 6e-2 of the reference's RMS for the largest error and 5e-3 for
# the RMS of the error (rounding alone leaves ~1e-3; a dropped 32-wide K
# step of 4096 leaves ~9e-2).
TOL_K3_RMS = 6e-2
TOL_K3_ERR_RMS = 5e-3


def print_ptxas(reports) -> None:
    """The ptxas report of each library built: registers, spills and errors;
    for the Hopper kernels K1 (prefix_attention), K2 (causal_attention), K3
    (ragged_matmul) and K4 (paged_attention) every line (shared memory,
    warnings, wgmma serialization notes)."""
    for name, log in reports.items():
        for line in log.splitlines():
            low = line.lower()
            full = name in ("prefix_attention", "causal_attention", "ragged_matmul",
                            "paged_attention") and (
                "ptxas" in low or "stack frame" in low)
            if full or "registers" in line or "spill" in line or "error" in low:
                print(f"  {name}: {line.strip()}", flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Device time of one call: after two warm-up calls, `reps` calls are
    captured back to back in a CUDA graph, and the median of three replays
    between CUDA events, over `reps`, is the time. Host launch overhead is
    left out, as it is in no kernel's bound. A call that cannot be captured
    is timed as `reps` eager calls back to back (host gaps included; the
    line printed says so)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        run = graph.replay
    except RuntimeError as exc:
        print(f"  not capturable, timed eagerly: {exc}", flush=True)
        graph = None

        def run():
            for _ in range(reps):
                fn()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


# ------------------------------------------------------------- kernel phase
# Queries are scaled so that the scores have a standard deviation of about
# 4: attention is peaked on a few keys, so a wrong mask, a dropped tile or a
# wrong P.V product moves the normalized output by a large fraction of its
# size, far past the tolerances below.
Q_SCALE = 4.0
# Tolerances of the kernels against their plain versions on the same bf16
# inputs. Both round q and P to bf16 at the same points; they differ in the
# order of the f32 sums and in that the kernel rounds P against its running
# maximum. The normalized output is held relative to the reference's RMS.
TOL_O_RMS = 3e-2
TOL_M = 1e-4  # times (1 + max |m|)
TOL_L = 1e-4  # relative


def _compare(got, want, valid_rows):
    """Errors of the normalized outputs, of m and of l on rows with a valid
    key; rows without one must be exactly m = NEG_INF, l = 0."""
    import torch

    o, m, l = got
    o_r, m_r, l_r = want
    vr = valid_rows
    out = (o / l.clamp(min=1e-30)[..., None])[vr]
    ref = (o_r / l_r.clamp(min=1e-30)[..., None])[vr]
    if vr.any():
        rms = ref.square().mean().sqrt().item()
        err_o = (out - ref).abs().max().item()
        err_m = (m[vr] - m_r[vr]).abs().max().item()
        tol_m = TOL_M * (1.0 + m_r[vr].abs().max().item())
        err_l = ((l[vr] - l_r[vr]).abs() / l_r[vr]).max().item()
    else:
        rms = err_o = err_m = tol_m = err_l = 0.0
    dead = ~vr
    dead_ok = bool((m[dead] == NEG_INF).all() and (l[dead] == 0).all())
    finite = bool(torch.isfinite(o).all() and torch.isfinite(l).all())
    ok = (err_o <= TOL_O_RMS * rms and err_m <= tol_m and err_l <= TOL_L
          and dead_ok and finite)
    return ok, {"max_abs_err": err_o, "ref_rms": rms, "m_err": err_m,
                "l_rel_err": err_l, "masked_rows_exact": dead_ok}


def _prefix_check(gen, step, B, S, Sp, plen, H=32, n_kv=8, hd=128):
    """K1 against its plain version on random inputs: (ok, rec, inputs)."""
    import torch
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

    dev = "cuda"
    q = (Q_SCALE * torch.randn((B, S, H, hd), generator=gen, device=dev)).to(torch.bfloat16)
    k = torch.randn((Sp, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((Sp, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    plen_d = torch.tensor(plen, dtype=torch.int32, device=dev)
    got = pa.flash_prefix_attention_parts(q, k, v, plen_d)
    want = pa.prefix_attention_parts_plain(q, k, v, plen_d)
    torch.cuda.synchronize()
    valid = torch.full(want[1].shape, plen > 0, dtype=torch.bool, device=dev)
    ok, rec = _compare(got, want, valid)
    rec.update(step=step, splits=_k1_splits(B, S, Sp, H, n_kv, hd),
               shape=f"q[{B},{S},{H},{hd}] prefix[{Sp},{n_kv},{hd}] prefix_len={plen}")
    return ok, rec, (q, k, v, plen_d)


def _prefix_case(gen, step, B, S, Sp, plen, H=32, n_kv=8, hd=128):
    """K1 held against its plain version, then timed with a cold and a hot
    L2 beside its plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

    ok, rec, (q, k, v, plen_d) = _prefix_check(gen, step, B, S, Sp, plen, H, n_kv, hd)
    flops = 4.0 * B * S * H * plen * hd
    nbytes = (B * S * H * hd * 2 + 2 * plen * n_kv * hd * 2 + 4
              + B * H * S * hd * 4 + 2 * B * H * S * 4)
    # Cold L2, as the path meets it: each layer reads its own prefix K/V, so
    # the timed calls rotate over distinct buffers (>= COLD_BYTES in all).
    n_buf = max(4, -(-COLD_BYTES // (k.nbytes + v.nbytes)))
    bufs = [(k, v)] + [
        (torch.randn_like(k, dtype=torch.float32).to(torch.bfloat16),
         torch.randn_like(v, dtype=torch.float32).to(torch.bfloat16))
        for _ in range(n_buf - 1)
    ]
    kernel_bufs = itertools.cycle(bufs)

    def kernel_cold():
        kb, vb = next(kernel_bufs)
        pa.flash_prefix_attention_parts(q, kb, vb, plen_d)

    rec.update(
        ms=_time_ms(kernel_cold, 20),
        ms_hot=_time_ms(lambda: pa.flash_prefix_attention_parts(q, k, v, plen_d), 20),
        plain_ms=_time_ms(lambda: pa.prefix_attention_parts_plain(q, k, v, plen_d), 5),
        cold_buffers=n_buf,
        **_bound(flops, nbytes),
    )
    if plen > 0:
        qt = q.transpose(1, 2)
        views = [
            tuple(t[:plen].permute(1, 0, 2).unsqueeze(0).expand(B, n_kv, plen, hd)
                  for t in kv)
            for kv in bufs
        ]
        lib_bufs = itertools.cycle(views)

        def sdpa_cold():
            kt, vt = next(lib_bufs)
            F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)

        rec["library_ms"] = _library_ms(sdpa_cold)
        rec["library_ms_hot"] = _library_ms(
            lambda: F.scaled_dot_product_attention(qt, *views[0], enable_gqa=True)
        )
    else:
        rec["library_ms"] = rec["library_ms_hot"] = None
    return ok, rec


def _causal_check(gen, step, B, S, lens, H=32, n_kv=8, hd=128):
    """K2 against its plain version on random inputs: (ok, rec, inputs)."""
    import torch
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

    dev = "cuda"
    q = (Q_SCALE * torch.randn((B, S, H, hd), generator=gen, device=dev)).to(torch.bfloat16)
    k = torch.randn((B, S, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    lens_d = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = pa.flash_causal_attention_parts(q, k, v, lens_d)
    want = pa.causal_attention_parts_plain(q, k, v, lens_d)
    torch.cuda.synchronize()
    valid = (lens_d > 0)[:, None, None, None].expand(want[1].shape)
    ok, rec = _compare(got, want, valid)
    rec.update(step=step, shape=f"q[{B},{S},{H},{hd}] n_kv={n_kv} lens={list(lens)}")
    return ok, rec, (q, k, v, lens_d)


def _causal_case(gen, step, B, S, lens, H=32, n_kv=8, hd=128):
    """K2 held against its plain version, then timed hot (as the path meets
    its inputs, just written by the layer) and cold (the captured calls
    rotate over >= COLD_BYTES of input copies) beside its plain version and
    two SDPA yardsticks: with the dense causal-and-length mask (every
    shape), and with is_causal=True on each backend that takes it (where
    every len is S, the same function)."""
    import torch
    import torch.nn.functional as F
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

    ok, rec, (q, k, v, lens_d) = _causal_check(gen, step, B, S, lens, H, n_kv, hd)
    pairs = sum(sum(min(max(n, 0), s + 1) for s in range(S)) for n in lens)
    flops = 4.0 * pairs * H * hd
    nbytes = (B * S * H * hd * 2 + 2 * sum(min(max(n, 0), S) for n in lens) * n_kv * hd * 2
              + 4 * B + B * H * S * hd * 4 + 2 * B * H * S * 4)
    n_buf = max(4, -(-COLD_BYTES // (q.nbytes + k.nbytes + v.nbytes)))
    copies = itertools.cycle([(q, k, v)] + [
        tuple((t.float() + torch.randn(t.shape, generator=gen, device=t.device)
               ).to(torch.bfloat16) for t in (q, k, v))
        for _ in range(n_buf - 1)
    ])

    def kernel_cold():
        pa.flash_causal_attention_parts(*next(copies), lens_d)

    rec.update(
        ms=_time_ms(lambda: pa.flash_causal_attention_parts(q, k, v, lens_d), 20),
        ms_cold=_time_ms(kernel_cold, 20),
        plain_ms=_time_ms(lambda: pa.causal_attention_parts_plain(q, k, v, lens_d), 5),
        cold_buffers=n_buf,
        **_bound(flops, nbytes),
    )
    dev = q.device
    pos = torch.arange(S, device=dev)
    mask = (pos[:, None] >= pos[None, :])[None] & (pos[None, :] < lens_d[:, None])[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rec["library_ms"] = _library_ms(
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True
        )
    )
    rec["library_causal"] = (
        _sdpa_causal_ms(qt, kt, vt) if all(n == S for n in lens) else {}
    )
    yardsticks = [t for t in (rec["library_ms"], *rec["library_causal"].values())
                  if t is not None]
    rec["ratio"] = rec["ms"] / min(yardsticks) if yardsticks else None
    return ok, rec


def _sdpa_causal_ms(qt, kt, vt) -> dict:
    """{backend: ms} of scaled_dot_product_attention(is_causal=True) on each
    backend that takes these inputs, GQA as it is or, where a backend
    refuses it, with K/V expanded to every query head beforehand (the copy
    is not timed)."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = qt.shape[1] // kt.shape[1]
    expanded = (kt.repeat_interleave(g, dim=1), vt.repeat_interleave(g, dim=1))
    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        for name, kv, extra in ((backend.name, (kt, vt), {"enable_gqa": True}),
                                (f"{backend.name} (K/V expanded)", expanded, {})):
            def call(kv=kv, extra=extra, backend=backend):
                with sdpa_kernel(backend):
                    F.scaled_dot_product_attention(qt, *kv, is_causal=True, **extra)
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    call()
            except (RuntimeError, TypeError):
                continue
            out[name] = _library_ms(call)
            break
    return out


def _library_ms(fn) -> float | None:
    """Time of the PyTorch library yardstick, or None where this PyTorch
    build refuses the call (it is a yardstick only, never on the path)."""
    try:
        return _time_ms(fn, 20)
    except (RuntimeError, TypeError) as exc:
        print(f"  library call refused: {exc}", flush=True)
        return None


def _bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops,
        "bytes": nbytes,
    }


def path_shapes(backend, nodes, pods, n_singles):
    """The K1 and K2 calls the decision phase makes, from the engine's own
    geometry for these prompts: the chunked prefix prefill of the cluster
    prefix, then for each wave (one per single decision, then the batch)
    its suffix prefill and its block decode; and K1 in a pack chunk of the
    admission phase's packed batch (q [1, admission_chunk_tokens] against
    the same prefix). Each K1 case is (step, B, S, Sp, prefix_len) and each
    K2 case (step, B, S, lens); repeats are dropped."""
    eng = backend.engine
    items = [backend._prepare_item(p, nodes) for p in pods]
    n = len(items[0].prefix_ids)
    chunk = min(eng.prefix_chunk, eng.prefill_buckets[-1])
    if n <= chunk:
        raise RuntimeError(f"a {n}-token prefix does not take the chunked prefill")
    cap = -(-n // chunk) * chunk + chunk  # engine._prefill_prefix_chunked
    # the block width of a wave follows the grammar the worker installs
    # with the prefix; installing it here as well changes nothing else
    eng.set_grammar(backend._grammar_for(items[0].group_key[1]))
    k1, k2 = {}, {}
    for start in range(0, n, chunk):
        k1.setdefault((1, chunk, cap, start), "prefix chunk")
        k2.setdefault((1, chunk, (min(chunk, n - start),)), "prefix chunk")
    for wave in [[it] for it in items[:n_singles]] + [items]:
        lens = [len(it.suffix_ids) for it in wave]
        bucket = eng._bucket_for(max(lens))
        R, _, F = eng._wave_geometry(len(wave), backend.max_new_tokens)
        lens += [0] * (R - len(lens))
        k1.setdefault((R, bucket, cap, n), "suffix prefill")
        k1.setdefault((R, F, cap, n), "block decode")
        if not any(key[:2] == (R, bucket) for key in k2):
            k2[(R, bucket, tuple(lens))] = "suffix prefill"
    k1.setdefault((1, eng.admission_chunk_tokens, cap, n), "pack chunk")
    return ([(step, *key) for key, step in k1.items()],
            [(step, *key) for key, step in k2.items()])


# K1 off the 8B path's shapes, held but not timed: (step, B, S, Sp,
# prefix_len, H, n_kv, hd). TINY's head dim 64 with g = 2 (the reference
# phase's width); many key splits, most of them past prefix_len, at hd 64 and
# 128 (the combine over 32-64 splits); a buffer that is not a whole number
# of key tiles; a block-decode call with an empty prefix (every split empty).
K1_EDGE_CASES = [
    ("TINY", 1, 37, 64, 50, 4, 2, 64),
    ("TINY many splits", 2, 3, 4096, 3000, 4, 2, 64),
    ("hd 128 many splits", 1, 5, 4096, 130, 8, 2, 128),
    ("ragged buffer end", 2, 70, 1000, 1000, 8, 2, 128),
    ("empty prefix", 8, 24, 8192, 0, 32, 8, 128),
]


# K2 off the 8B path's shapes, held but not timed: (step, B, S, lens, H,
# n_kv, hd). TINY's head dim 64 with g = 2 and an empty row at a chunk that
# is not whole tiles; S 300 with lens ending inside the second and third
# key tiles and at 1; g = 8 (Llama-3.3-70B's 64/8 heads); g = 1 at hd 64; a
# length past S beside a negative one.
K2_EDGE_CASES = [
    ("TINY", 2, 37, (37, 0), 4, 2, 64),
    ("S 300", 3, 300, (300, 129, 1), 32, 8, 128),
    ("g 8", 1, 520, (520,), 64, 8, 128),
    ("g 1 hd 64", 2, 300, (300, 200), 8, 8, 64),
    ("len > S, len < 0", 2, 64, (100, -3), 32, 8, 128),
]


def kernel_phase(k1_cases, k2_cases, k1_edge_cases=K1_EDGE_CASES,
                 k2_edge_cases=K2_EDGE_CASES, timed=True
                 ) -> tuple[bool, list[dict], list[dict]]:
    """K1 and K2 held against their plain versions at the path's shapes and
    at their edge cases; timed at the path's shapes unless `timed` is
    False."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k1, k2 = [], []
    runs = (
        [(k1, _prefix_check, c) for c in k1_edge_cases]
        + [(k1, _prefix_case if timed else _prefix_check, c) for c in k1_cases]
        + [(k2, _causal_check, c) for c in k2_edge_cases]
        + [(k2, _causal_case if timed else _causal_check, c) for c in k2_cases]
    )
    for recs, run, case in runs:
        ok, rec = run(gen, *case)[:2]
        rec["ok"] = ok
        recs.append(rec)
        torch.cuda.empty_cache()
    for name, recs in (("K1", k1), ("K2", k2)):
        for rec in recs:
            _print_attention_case(name, rec)
    return all(r["ok"] for r in k1 + k2), k1, k2


def _k1_splits(B, S, Sp, H=32, n_kv=8, hd=128) -> int:
    """Key splits K1's wrapper plans for this call on this card."""
    import torch
    from k8s_llm_scheduler_tpu_torch.ops import kernels
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

    sms = kernels.sm_count(torch.device("cuda"))
    return pa.kv_splits(B * S * (H // n_kv), n_kv, Sp, hd, sms)[0]


def _print_attention_case(name, rec):
    line = (f"{name} {rec['step']} {rec['shape']}: ok={rec['ok']} "
            f"err={rec['max_abs_err']:.3g} (rms {rec['ref_rms']:.3g}) "
            f"m_err={rec['m_err']:.3g} l_rel_err={rec['l_rel_err']:.3g}")
    if "splits" in rec:
        line += f" splits={rec['splits']}"
    if "ms" in rec:
        line += (f" ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                 f"bound_ms={rec['bound_ms']:.4f} library_ms={rec['library_ms']}")
    if "ms_hot" in rec:
        line += f" (hot L2: ms={rec['ms_hot']:.4f} library_ms={rec['library_ms_hot']})"
    if "ms_cold" in rec:
        line += (f" (cold L2: ms={rec['ms_cold']:.4f}) is_causal SDPA "
                 f"{rec['library_causal']} ratio={rec['ratio']}")
    print(line, flush=True)


# ------------------------------------------------------------- K3 phase
def k3_weights(cfg):
    """(name, K, N) of the seven matmuls K3 runs in each layer."""
    D, Fd, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    H, KV = cfg.n_heads * hd, cfg.n_kv_heads * hd
    return [("wq", D, H), ("wk", D, KV), ("wv", D, KV), ("wo", H, D),
            ("w_gate", D, Fd), ("w_up", D, Fd), ("w_down", Fd, D)]


def _compare_k3(got, want, total):
    """K3 against its plain version: rows below `total` by the largest
    error and the error's RMS, both relative to the reference's RMS; rows
    from the end of the last computed 64-row tile exactly zero."""
    import torch

    end = min(-(-total // 64) * 64, got.shape[0])
    if total > 0:
        ref = want[:total].float()
        diff = got[:total].float() - ref
        rms = ref.square().mean().sqrt().item()
        err = diff.abs().max().item()
        err_rms = diff.square().mean().sqrt().item()
    else:
        rms = err = err_rms = 0.0
    zero_ok = bool((got[end:] == 0).all())
    finite = bool(torch.isfinite(got.float()).all())
    ok = (err <= TOL_K3_RMS * rms and err_rms <= TOL_K3_ERR_RMS * rms
          and zero_ok and finite)
    return ok, {"max_abs_err": err, "err_rms": err_rms, "ref_rms": rms,
                "zero_tail_exact": zero_ok}


def _k3_weight(gen, K, N, int8):
    """A random [K, N] weight: bf16, or the int8 pair quantized from one."""
    import torch
    from k8s_llm_scheduler_tpu_torch.models.quant import quantize_weight

    w = (torch.randn((K, N), generator=gen, device=DEVICE) * K**-0.5).to(torch.bfloat16)
    return quantize_weight(w) if int8 else w


def _k3_check(gen, w, M, total):
    """K3 against its plain version on random x [M, K]: (ok, rec, x, total)."""
    import torch
    from k8s_llm_scheduler_tpu_torch.ops.ragged_matmul import (
        ragged_matmul,
        ragged_matmul_plain,
    )

    K = (w["q"] if isinstance(w, dict) else w).shape[0]
    x = torch.randn((M, K), generator=gen, device=DEVICE).to(torch.bfloat16)
    total_d = torch.tensor(total, dtype=torch.int32, device=DEVICE)
    got = ragged_matmul(x, w, total_d)
    want = ragged_matmul_plain(x, w, total_d)
    torch.cuda.synchronize()
    ok, cmp = _compare_k3(got, want, total)
    return ok, {**cmp, "ok": ok, "total": total}, x, total_d


def _k3_splits(N, K) -> int:
    """K splits K3's wrapper plans for this weight on this card."""
    import torch
    from k8s_llm_scheduler_tpu_torch.ops import kernels
    from k8s_llm_scheduler_tpu_torch.ops import ragged_matmul as rm

    return rm.k_splits(N, K, kernels.sm_count(torch.device(DEVICE)))[0]


def _k3_copies(w, n_bytes):
    """`w` and copies of it (distinct memory), >= COLD_BYTES in all."""
    n = max(2, -(-COLD_BYTES // n_bytes))
    if isinstance(w, dict):
        return [w] + [{"q": w["q"].clone(), "scale": w["scale"].clone()}
                      for _ in range(n - 1)]
    return [w] + [w.clone() for _ in range(n - 1)]


def _k3_case(gen, name, copies, lib_copies, R, total, int8):
    """K3 held at x [R*24, K] and `total`, then timed with a cold L2 (the
    captured calls rotate over `copies`, as each layer reads its own
    weights) and hot (one weight replayed), beside its plain version and
    the yardstick: torch.matmul of the computed rows against a bf16 weight
    (for int8 a dequantized copy made beforehand, so it reads twice the
    weight bytes), cold over `lib_copies` and hot."""
    import torch
    from k8s_llm_scheduler_tpu_torch.ops.ragged_matmul import (
        BM,
        ragged_matmul,
        ragged_matmul_plain,
    )

    w = copies[0]
    K, N = (w["q"] if int8 else w).shape
    M = R * BLOCK_F
    ok, rec, x, total_d = _k3_check(gen, w, M, total)
    end = min(-(-total // BM) * BM, M)
    wbytes = K * N * (1 if int8 else 2) + (4 * N if int8 else 0)
    nbytes = (wbytes + end * K * 2 if end else 0) + M * N * 2
    rot = itertools.cycle(copies)
    rec.update(
        step=f"R={R}", weight=name, int8=int8, splits=_k3_splits(N, K),
        shape=f"x[{M},{K}] @ {'int8' if int8 else 'bf16'} w[{K},{N}] total={total}",
        ms=_time_ms(lambda: ragged_matmul(x, next(rot), total_d), 20),
        ms_hot=_time_ms(lambda: ragged_matmul(x, w, total_d), 20),
        plain_ms=_time_ms(lambda: ragged_matmul_plain(x, w, total_d), 5),
        cold_copies=len(copies),
        **_bound(2.0 * end * K * N, nbytes),
    )
    if end:
        xs = x[:end]
        lib_rot = itertools.cycle(lib_copies)
        rec["library_ms"] = _library_ms(lambda: torch.matmul(xs, next(lib_rot)))
        rec["library_ms_hot"] = _library_ms(lambda: torch.matmul(xs, lib_copies[0]))
    else:
        rec["library_ms"] = rec["library_ms_hot"] = None
    return ok, rec


# K3 off the 8B path's shapes, held but not timed, for int8 and bf16
# weights: (name, M, K, N, totals). TINY's widths (d_model 256, q/kv/ff
# widths 256/128/512) at R = 4; N not a whole 128-column tile; K not a whole
# 64-deep ring stage; M > 192 (R = 16), two passes over the weights.
K3_EDGE_CASES = [
    ("TINY wq", 96, 256, 256, (0, 1, 64, 65, 96)),
    ("TINY wk", 96, 256, 128, (0, 1, 64, 65, 96)),
    ("TINY w_gate", 96, 256, 512, (0, 1, 64, 65, 96)),
    ("N not whole column tiles", 192, 4096, 208, (0, 1, 64, 65, 192)),
    ("K not whole ring stages", 192, 1000, 256, (0, 1, 64, 65, 192)),
    ("R=16, M > 192", 384, 4096, 1024, (0, 1, 64, 65, 193, 384)),
]


def k3_phase(cfg, totals_by_r, edge_cases=K3_EDGE_CASES) -> tuple[bool, list[dict]]:
    """K3 held at `edge_cases`, then at every weight shape of path A, both
    weight forms, for each row bucket R and its totals (0, the path's
    smallest/median/largest, R*F), timed there cold and hot."""
    import torch

    from k8s_llm_scheduler_tpu_torch.ops import ragged_matmul as rm

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    if hasattr(rm, "SMEM_BYTES"):
        print(f"K3 dynamic shared memory: {rm.SMEM_BYTES} bytes a block", flush=True)
    recs = []
    for name, M, K, N, totals in edge_cases:
        for int8 in (True, False):
            w = _k3_weight(gen, K, N, int8)
            for total in totals:
                ok, rec, _, _ = _k3_check(gen, w, M, total)
                rec.update(step="edge", weight=name, int8=int8,
                           shape=f"x[{M},{K}] @ {'int8' if int8 else 'bf16'} "
                                 f"w[{K},{N}] total={total}")
                recs.append(rec)
                _print_k3(rec)
    for name, K, N in k3_weights(cfg) if totals_by_r else ():
        for int8 in (True, False):
            w = _k3_weight(gen, K, N, int8)
            copies = _k3_copies(w, K * N * (1 if int8 else 2))
            w_lib = (w["q"].float() * w["scale"]).to(torch.bfloat16) if int8 else w
            lib_copies = _k3_copies(w_lib, K * N * 2)
            for R, seen in sorted(totals_by_r.items()):
                med = int(statistics.median_low(seen)) if seen else None
                picks = {0, R * BLOCK_F} | ({min(seen), med, max(seen)} if seen else set())
                for total in sorted(picks):
                    ok, rec = _k3_case(gen, name, copies, lib_copies, R, total, int8)
                    rec["median_total"] = total == med
                    recs.append(rec)
                    _print_k3(rec)
            del copies, lib_copies
            torch.cuda.empty_cache()
    return all(r["ok"] for r in recs), recs


def _print_k3(rec):
    line = (f"K3 {rec['step']} {rec['shape']}: ok={rec['ok']} "
            f"err={rec['max_abs_err']:.3g} err_rms={rec['err_rms']:.3g} "
            f"(rms {rec['ref_rms']:.3g}) zero_tail={rec['zero_tail_exact']}")
    if "splits" in rec:
        line += f" splits={rec['splits']}"
    if "ms" in rec:
        line += (f" ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                 f"bound_ms={rec['bound_ms']:.4f} library_ms={rec['library_ms']} "
                 f"(hot L2: ms={rec['ms_hot']:.4f} "
                 f"library_ms={rec['library_ms_hot']})")
    print(line, flush=True)


# ------------------------------------------------------------- K4 phase
# K4 off path B's shapes, held but not timed, both modes: (name, B, H, n_kv,
# hd, page size, pages in the cache, table width P, lens, table kind). The
# lens cover 0, 1, ps - 1, ps, ps + 1, P*ps, past P*ps and negative; the
# tables hold scattered, descending or repeated page ids. Head dims 64 and
# 128; g 1, 2 (TINY), 3 (rounded up to 4 in the kernel), 4 and 8
# (Llama-3.3-70B's 64/8 heads); pages of 16, 32, 64, 100, 203 (the largest
# the first K4 kernel took at hd 128) and 256 tokens, so pages of several boxes
# and stages of several pages. One sequence on 8 kv heads plans 17 splits
# (more than its pages); 40 sequences plan one split; one sequence of 40
# pages of 256 on one kv head takes 40 splits (the fold's 8-split rounds).
K4_EDGE_CASES = [
    ("TINY lens 0/1/ps-1/ps/ps+1/<0", 6, 4, 2, 64, 16, 64, 8, (0, 1, 15, 16, 17, -3),
     "scattered"),
    ("g 1 hd 64, P*ps and past it", 4, 8, 8, 64, 16, 40, 8, (128, 500, 64, -1),
     "descending"),
    ("g 8, repeated pages", 3, 64, 8, 128, 64, 16, 8, (512, 65, 63), "repeated"),
    ("g 3, ps 32", 3, 12, 4, 128, 32, 16, 4, (100, 31, 128), "scattered"),
    ("ps 100 hd 64", 2, 16, 4, 64, 100, 12, 5, (500, 101), "descending"),
    ("ps 203", 3, 32, 8, 128, 203, 24, 6, (1218, 204, 202), "scattered"),
    ("B 1, splits past the pages", 1, 32, 8, 128, 64, 64, 64, (100,), "scattered"),
    ("40 sequences, one split", 40, 32, 8, 128, 64, 200, 4,
     tuple((37 * i) % 260 - 4 for i in range(40)), "scattered"),
    ("ps 256, 40 splits", 1, 4, 1, 64, 256, 48, 40, (10000,), "descending"),
]
# Path B's engine at max_pages_per_seq = 64 with every slot near its end: 8
# sequences of 3,969-4,032 own tokens (63 pages each, 504 of the 512) and
# the trash row at -5,488. (step, q shape, cache shape, lens).
K4_LONG_LENS = (4032, 4025, 4011, 4003, 3994, 3985, 3977, 3969, -5488)
K4_LONG = ("long: 63 pages a slot", (9, 32, 128), (512, 64, 8, 128), K4_LONG_LENS)


def _k4_tables(kind, B, P, num_pages, gen):
    """[B, P] int32 page ids: distinct and scattered, descending, or few ids
    reused across and within rows."""
    import torch

    if kind == "scattered":
        ids = torch.randperm(num_pages, generator=gen)
        ids = ids.repeat(-(-B * P // num_pages))[:B * P]
    elif kind == "descending":
        ids = (num_pages - 1 - torch.arange(B * P)) % num_pages
    else:
        ids = torch.randint(0, min(4, num_pages), (B * P,), generator=gen)
    return ids.reshape(B, P).to(torch.int32)


def _k4_compare(got, want, lens, normalize):
    """The smoke's K4 comparison: normalized outputs (and for the partials
    m and l) as _compare holds K1/K2, and rows of a sequence with len <= 0
    exactly m = -1e30, l = 0, o = 0 (normalized: 0)."""
    import torch

    B = lens.shape[0]
    if normalize:
        H = got.shape[1]
        vr = (lens > 0)[:, None].expand(B, H)
        if vr.any():
            ref = want[vr].float()
            rms = ref.square().mean().sqrt().item()
            err = (got[vr].float() - ref).abs().max().item()
        else:
            rms = err = 0.0
        dead_ok = bool((got[~vr] == 0).all())
        ok = err <= TOL_O_RMS * rms and dead_ok and bool(torch.isfinite(got.float()).all())
        return ok, {"max_abs_err": err, "ref_rms": rms, "masked_rows_exact": dead_ok}
    n_kv, g = got[1].shape[1:]
    vr = (lens > 0)[:, None, None].expand(B, n_kv, g)
    # the partials carry no S axis: add one for the shared comparison
    ok, rec = _compare(
        tuple(t.unsqueeze(-2) if t.dim() == 4 else t.unsqueeze(-1) for t in got),
        tuple(t.unsqueeze(-2) if t.dim() == 4 else t.unsqueeze(-1) for t in want),
        vr.unsqueeze(-1),
    )
    o_dead = bool((got[0][~vr] == 0).all())
    rec["masked_rows_exact"] = rec["masked_rows_exact"] and o_dead
    return ok and o_dead, rec


def _k4_check(gen, step, q_shape, pages_shape, tables, lens, normalize):
    """K4 against its plain version on random inputs, and against itself
    (bitwise, run to run): (ok, rec, (kernel, plain, q, k, v, tables,
    lens))."""
    import torch
    from k8s_llm_scheduler_tpu_torch.ops import kernels
    from k8s_llm_scheduler_tpu_torch.ops import paged_attention as pg

    dev = DEVICE
    B, H, hd = q_shape
    _, ps, n_kv, _ = pages_shape
    q = (Q_SCALE * torch.randn(q_shape, generator=gen, device=dev)).to(torch.bfloat16)
    kc = torch.randn(pages_shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(pages_shape, generator=gen, device=dev).to(torch.bfloat16)
    tables = tables.to(dev).contiguous()
    lens = lens.to(dev).contiguous()
    kernel = pg.paged_decode_attention if normalize else pg.paged_decode_attention_parts
    plain = pg.paged_attention_plain if normalize else pg.paged_attention_parts_plain
    got = kernel(q, kc, vc, tables, lens)
    again = kernel(q, kc, vc, tables, lens)
    want = plain(q, kc, vc, tables, lens)
    torch.cuda.synchronize()
    ok, rec = _k4_compare(got, want, lens, normalize)
    pairs = zip(got, again) if not normalize else [(got, again)]
    rec["bitwise_repeat"] = all(torch.equal(a, b) for a, b in pairs)
    rec.update(
        step=step, mode="normalized" if normalize else "parts",
        ok=ok and rec["bitwise_repeat"],
        shape=(f"q[{B},{H},{hd}] pages{list(pages_shape)} tables{list(tables.shape)} "
               f"lens={lens.tolist()}"),
    )
    if hasattr(pg, "paged_splits"):
        rec["splits"] = pg.paged_splits(B, n_kv, tables.shape[1], kernels.sm_count(q.device))
    return rec["ok"], rec, (kernel, plain, q, kc, vc, tables, lens)


def _k4_tickets_zero() -> bool | None:
    """Whether every split-merge counter is 0 (None for a K4 without them)."""
    from k8s_llm_scheduler_tpu_torch.ops import paged_attention as pg

    counters = getattr(pg, "_tickets", None)
    if counters is None:
        return None
    return all(int(t.abs().sum()) == 0 for t in counters.values())


def _k4_case(gen, step, q_shape, pages_shape, tables, lens, normalize, hot=True):
    """K4 held as _k4_check does, then timed cold (the captured calls
    rotate over copies of the caches whose valid bytes add up to >=
    COLD_BYTES, as each layer reads its own cache) and, unless `hot` is
    False, hot (one cache replayed), beside its plain version and the
    yardstick: SDPA on KV gathered beforehand (the gather untimed), cold
    over as many gathered copies and hot."""
    import torch
    import torch.nn.functional as F
    from k8s_llm_scheduler_tpu_torch.ops.attention import gather_pages

    ok, rec, (kernel, plain, q, kc, vc, tables, lens) = _k4_check(
        gen, step, q_shape, pages_shape, tables, lens, normalize)
    B, H, hd = q_shape
    _, ps, n_kv, _ = pages_shape
    n_tok = int(lens.clamp(min=0, max=tables.shape[1] * ps).sum())
    n_pages = sum(-(-min(max(int(n), 0), tables.shape[1] * ps) // ps) for n in lens.tolist())
    out_bytes = B * H * hd * 2 if normalize else B * H * hd * 4 + 2 * B * H * 4
    kv_bytes = 2 * n_tok * n_kv * hd * 2
    nbytes = B * H * hd * 2 + kv_bytes + 4 * n_pages + 4 * B + out_bytes
    n_copies = max(2, -(-COLD_BYTES // max(kv_bytes, 1)))
    copies = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(n_copies - 1)]
    rot = itertools.cycle(copies)
    rec.update(
        ms=_time_ms(lambda: kernel(q, *next(rot), tables, lens), 20),
        ms_hot=_time_ms(lambda: kernel(q, kc, vc, tables, lens), 20) if hot else None,
        plain_ms=_time_ms(lambda: plain(q, kc, vc, tables, lens), 5),
        cold_copies=n_copies,
        **_bound(4.0 * n_tok * H * hd, nbytes, PEAK_F32_FLOPS),
    )
    del copies, rot
    rec["tickets_zero_after_replays"] = _k4_tickets_zero()
    rec["ok"] = ok = ok and rec["tickets_zero_after_replays"] is not False
    span = -(-max(int(lens.max()), 1) // ps) * ps
    gathered = [tuple(gather_pages(c, tables)[:, :span].transpose(1, 2).contiguous()
                      for c in (kc, vc))]
    gathered += [tuple(t.clone() for t in gathered[0]) for _ in range(n_copies - 1)]
    lib_rot = itertools.cycle(gathered)
    mask = (torch.arange(span, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    qt = q[:, :, None, :]

    def sdpa(kv):
        return F.scaled_dot_product_attention(qt, *kv, attn_mask=mask, enable_gqa=True)

    rec["library_ms"] = _library_ms(lambda: sdpa(next(lib_rot)))
    rec["library_ms_hot"] = _library_ms(lambda: sdpa(gathered[0])) if hot else None
    rec["library_note"] = "SDPA on KV gathered beforehand; the gather is not timed"
    del gathered, lib_rot
    return ok, rec


def _print_k4(rec):
    line = (f"K4 {rec['mode']} {rec['step']} {rec['shape']}: ok={rec['ok']} "
            f"err={rec['max_abs_err']:.3g} (rms {rec['ref_rms']:.3g}) "
            f"dead_exact={rec['masked_rows_exact']} bitwise={rec['bitwise_repeat']}")
    if "splits" in rec:
        line += f" splits={rec['splits']}"
    if "ms" in rec:
        line += (f" ms={rec['ms']:.4f} (cold, {rec['cold_copies']} copies) "
                 f"ms_hot={rec['ms_hot']} plain_ms={rec['plain_ms']:.4f} "
                 f"bound_ms={rec['bound_ms']:.4f} library_ms={rec['library_ms']} "
                 f"library_ms_hot={rec['library_ms_hot']} "
                 f"tickets_zero={rec['tickets_zero_after_replays']}")
    print(line, flush=True)


def k4_long_case():
    """K4_LONG as a K4 case: tables [9, 64] with 63 distinct pages (of 1..511)
    for each live slot, the trash row's all page 0."""
    import torch

    step, q_shape, pages_shape, lens = K4_LONG
    gen = torch.Generator().manual_seed(7)
    ids = (1 + torch.randperm(pages_shape[0] - 1, generator=gen))[:8 * 63].reshape(8, 63)
    tables = torch.zeros((len(lens), 64), dtype=torch.int32)
    tables[:8, :63] = ids.to(torch.int32)
    return step, q_shape, pages_shape, tables, torch.tensor(lens, dtype=torch.int32)


def k4_phase(cases, edge_cases=K4_EDGE_CASES, long_cases=(), timed=True
             ) -> tuple[bool, list[dict]]:
    """K4 held at `edge_cases`, both modes, then at path B's `cases` (both
    modes) and `long_cases` (partials), timed there unless `timed` is
    False: path B's shapes cold and hot, the long ones cold."""
    import torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    cpu_gen = torch.Generator().manual_seed(4)
    recs = []
    for name, B, H, n_kv, hd, ps, num_pages, P, lens, kind in edge_cases:
        tables = _k4_tables(kind, B, P, num_pages, cpu_gen)
        lens_t = torch.tensor(lens, dtype=torch.int32)
        for normalize in (False, True):
            _, rec, _ = _k4_check(gen, f"edge: {name}", (B, H, hd), (num_pages, ps, n_kv, hd),
                                  tables, lens_t, normalize)
            recs.append(rec)
            _print_k4(rec)
        torch.cuda.empty_cache()
    runs = [(c, m, True) for c in cases for m in (False, True)]
    runs += [(c, False, False) for c in long_cases]
    for (step, q_shape, pages_shape, tables, lens), normalize, hot in runs:
        if timed:
            _, rec = _k4_case(gen, step, q_shape, pages_shape, tables, lens, normalize, hot)
        else:
            _, rec, _ = _k4_check(gen, step, q_shape, pages_shape, tables, lens, normalize)
        recs.append(rec)
        _print_k4(rec)
        torch.cuda.empty_cache()
    return all(r["ok"] for r in recs), recs


def _launch_counts() -> dict:
    from k8s_llm_scheduler_tpu_torch.ops import paged_attention as pg
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa
    from k8s_llm_scheduler_tpu_torch.ops.ragged_matmul import ragged_matmul

    return {
        "K1": pa.flash_prefix_attention_parts.launches,
        "K2": pa.flash_causal_attention_parts.launches,
        "K3": ragged_matmul.launches,
        "K4": pg.paged_decode_attention_parts.launches + pg.paged_decode_attention.launches,
    }


@contextlib.contextmanager
def launches_by_step(engine):
    """Kernel launches and device runs by step of the engine's work: each
    run of one of its programs (engine/graphs.Program, replayed or eager:
    the suffix prefill and the block iteration of each wave geometry, keyed
    by its row count R, or the decode chunk), each chunked prefix prefill
    ("prefix chunk", its calls as runs) and each chunk of a packed
    admission ("pack chunk"). The wrappers' counts are read before and
    after each (a replay adds what its capture recorded). Yields {step:
    {"runs": n, "K1": .., "K2": .., "K3": .., "K4": ..}}, filled as the
    steps run; the wrappers go on exit."""
    from k8s_llm_scheduler_tpu_torch.engine import graphs

    steps: dict[str, dict] = {}

    def book(step, runs, before):
        after = _launch_counts()
        rec = steps.setdefault(step, {"runs": 0, "K1": 0, "K2": 0, "K3": 0, "K4": 0})
        rec["runs"] += runs
        for k, n in after.items():
            rec[k] += n - before[k]

    run = graphs.Program.run

    def counted_run(prog):
        before, runs0 = _launch_counts(), prog.runs
        try:
            run(prog)
        finally:
            book(prog.name, prog.runs - runs0, before)

    def counted(step, fn):
        def call(*args, **kwargs):
            before = _launch_counts()
            try:
                return fn(*args, **kwargs)
            finally:
                book(step, 1, before)
        return call

    wrapped = {"_prefill_prefix_chunked": "prefix chunk", "_pack_chunk": "pack chunk"}
    saved = {name: vars(engine).get(name) for name in wrapped}  # another wrapper's
    graphs.Program.run = counted_run
    for name, step in wrapped.items():
        setattr(engine, name, counted(step, getattr(engine, name)))
    try:
        yield steps
    finally:
        graphs.Program.run = run
        for name, fn in saved.items():
            if fn is None:
                delattr(engine, name)
            else:
                setattr(engine, name, fn)


def per_call(steps) -> dict:
    """Kernel launches per device run of each step."""
    return {step: {k: rec[k] / rec["runs"] for k in ("K1", "K2", "K3", "K4")}
            for step, rec in steps.items() if rec["runs"]}


# The host's launch calls as torch.profiler traces them (CUPTI): kernel
# launches through the runtime and the driver, graph launches, and async
# copies and sets.
HOST_KERNEL_CALLS = frozenset(
    ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"))
HOST_LAUNCH_CALLS = HOST_KERNEL_CALLS | {"cudaGraphLaunch", "cudaMemcpyAsync",
                                         "cudaMemsetAsync"}
# The host's waits on the device as torch.profiler traces them.
HOST_SYNC_CALLS = frozenset(("cudaDeviceSynchronize", "cudaStreamSynchronize",
                             "cudaEventSynchronize"))


def launch_census(fn) -> dict:
    """fn() under torch.profiler, ending in a synchronize: the host's launch
    calls (HOST_LAUNCH_CALLS), of them the kernel launches outside graphs
    and the graph launches, the host's waits on the device
    (HOST_SYNC_CALLS, the closing synchronize included), and the
    operations the device ran (kernels, copies, sets)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # the CUDA activity alone traces the runtime and driver calls too
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rec = {"host_launches": 0, "host_kernel_launches": 0, "graph_launches": 0,
           "host_syncs": 0, "device_ops": 0}
    # the trace's raw records: an eager decision has ~1.4M, which
    # prof.events() is far slower to build into a tree than to read raw
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            rec["device_ops"] += 1
        elif name in HOST_SYNC_CALLS:
            rec["host_syncs"] += 1
        elif name in HOST_LAUNCH_CALLS:
            rec["host_launches"] += 1
            rec["host_kernel_launches"] += name in HOST_KERNEL_CALLS
            rec["graph_launches"] += name == "cudaGraphLaunch"
    return rec


def _zero_launch_counts() -> None:
    from k8s_llm_scheduler_tpu_torch.ops import paged_attention as pg
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa
    from k8s_llm_scheduler_tpu_torch.ops.ragged_matmul import ragged_matmul

    pa.reset_launch_counts()
    ragged_matmul.launches = 0
    pg.paged_decode_attention_parts.launches = 0
    pg.paged_decode_attention.launches = 0


# ---------------------------------------------------------- reference phase
def reference_phase() -> tuple[bool, dict]:
    """TINY main path on the card (kernels) vs the same weights on the CPU
    (plain versions)."""
    import torch
    from k8s_llm_scheduler_tpu_torch.core.prompt import PromptEngine
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY
    from k8s_llm_scheduler_tpu_torch.models.llama import (
        forward_prefill_suffix_dense,
        init_params,
    )
    from k8s_llm_scheduler_tpu_torch.testing import synthetic_nodes

    tok = ByteTokenizer()
    pe = PromptEngine()
    prefix, suffix = tok.chat_prompt_parts(
        pe.system_prompt, pe.cluster_part(synthetic_nodes(4)), "pod web-0"
    )
    cpu_params = init_params(TINY, seed=1, device="cpu")
    logits = {}
    for dev in ("cuda", "cpu"):
        params = {
            k: {kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
            else v.to(dev)
            for k, v in cpu_params.items()
        }
        eng = InferenceEngine(params, TINY, tok, temperature=0.0, prefix_chunk=512)
        eng.set_prefix(prefix)
        toks = torch.tensor([suffix], dtype=torch.int32, device=dev)
        lg, _, _ = forward_prefill_suffix_dense(
            params, TINY, toks,
            torch.tensor([len(suffix)], dtype=torch.int32, device=dev),
            eng._prefix.k, eng._prefix.v,
            torch.tensor(eng.prefix_len, dtype=torch.int32, device=dev),
        )
        logits[dev] = lg.float().cpu()
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    scale = logits["cpu"].abs().max().item()
    ok = bool(torch.isfinite(logits["cuda"]).all()) and err <= 5e-2 * scale
    rec = {"prefix_tokens": len(prefix), "max_abs_err": err, "max_logit": scale}
    print(f"reference: TINY chunked prefix ({len(prefix)} tokens) + suffix, "
          f"cuda vs cpu logits err={err:.4g} (max |logit| {scale:.4g}) ok={ok}",
          flush=True)
    for name, fn in (
        ("block_decode_int8_ragged", _tiny_block_decode_ragged),
        ("decode_buffered_pallas", _tiny_decode_buffered),
        ("decode_pallas", _tiny_decode),
    ):
        out = {dev: fn(cpu_params, dev).float().cpu() for dev in ("cuda", "cpu")}
        e = (out["cuda"] - out["cpu"]).abs().max().item()
        sc = out["cpu"].abs().max().item()
        good = bool(torch.isfinite(out["cuda"]).all()) and e <= 5e-2 * sc
        rec[name] = {"max_abs_err": e, "max_logit": sc, "ok": good}
        ok = ok and good
        print(f"reference: TINY {name}, cuda vs cpu logits err={e:.4g} "
              f"(max |logit| {sc:.4g}) ok={good}", flush=True)
    return ok, rec


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _tiny_block_decode_ragged(cpu_params, dev):
    """One block-decode iteration at TINY with int8 weights and K3 matmuls;
    logits of the rows with valid tokens."""
    import numpy as np
    import torch
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY
    from k8s_llm_scheduler_tpu_torch.models.llama import forward_block_decode
    from k8s_llm_scheduler_tpu_torch.models.quant import quantize_params

    rng = np.random.default_rng(5)
    L, kv, hd = TINY.n_layers, TINY.n_kv_heads, TINY.head_dim
    R, F, Ss, cap, Sp, plen = 4, BLOCK_F, 32, 48, 64, 50
    blk_len = np.asarray([24, 3, 0, 11], np.int32)
    blk_valid = np.arange(F)[None, :] < blk_len[:, None]
    blk_tok = (rng.integers(1, 256, size=(R, F)) * blk_valid).astype(np.int32)
    suffix_lens = np.asarray([32, 20, 0, 7], np.int32)
    tail = np.asarray([5, 0, 0, 12], np.int32)
    positions = (plen + suffix_lens + tail)[:, None] + np.arange(F)[None, :]

    def kvs(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            dtype=TINY.dtype, device=dev)

    def ints(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

    params = _on(quantize_params(cpu_params), dev)
    logits, _, _ = forward_block_decode(
        params, TINY, ints(blk_tok), torch.from_numpy(blk_valid).to(dev),
        ints(blk_len), ints(positions), kvs(L, R, Ss, kv, hd), kvs(L, R, Ss, kv, hd),
        ints(suffix_lens), kvs(L, R, cap + 1, kv, hd), kvs(L, R, cap + 1, kv, hd),
        ints(tail), kvs(L, Sp, kv, hd), kvs(L, Sp, kv, hd),
        torch.tensor(plen, dtype=torch.int32, device=dev), ragged=True,
    )
    return logits[torch.from_numpy(blk_len > 0).to(dev)]


def _tiny_paged_inputs(dev, rng):
    import numpy as np
    import torch
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY

    L, kv, hd = TINY.n_layers, TINY.n_kv_heads, TINY.head_dim
    shape = (L, 16, 16, kv, hd)  # 16 pages of 16 tokens
    kc = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    tables = torch.tensor([[3, 9, 1, 14], [7, 2, 0, 0], [0, 0, 0, 0]], dtype=torch.int32)
    return (kc.to(dtype=TINY.dtype, device=dev), vc.to(dtype=TINY.dtype, device=dev),
            tables.to(dev))


def _tiny_decode_buffered(cpu_params, dev):
    """One chunked-decode step at TINY with own-token attention through K4
    partials; one slot empty and the trash-like row negative."""
    import numpy as np
    import torch
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY
    from k8s_llm_scheduler_tpu_torch.models.llama import forward_decode_buffered

    rng = np.random.default_rng(6)
    L, kv, hd = TINY.n_layers, TINY.n_kv_heads, TINY.head_dim
    kc, vc, tables = _tiny_paged_inputs(dev, rng)
    Sp, plen, n_steps = 64, 50, 4
    own = torch.tensor([40, 0, -50], dtype=torch.int32, device=dev)
    tail = torch.tensor([1, 0, 2], dtype=torch.int32, device=dev)
    pos = (plen + own.clamp(min=0) + tail).to(torch.int32)

    def kvs(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            dtype=TINY.dtype, device=dev)

    logits, _, _ = forward_decode_buffered(
        _on(cpu_params, dev), TINY, torch.tensor([65, 66, 67], device=dev), pos,
        kc, vc, own, kvs(L, 3, n_steps, kv, hd), kvs(L, 3, n_steps, kv, hd), tail,
        kvs(L, Sp, kv, hd), kvs(L, Sp, kv, hd),
        torch.tensor(plen, dtype=torch.int32, device=dev),
        page_tables=tables, own_impl="pallas",
    )
    return logits


def _tiny_decode(cpu_params, dev):
    """One manual-page decode step at TINY through K4 normalized; the third
    slot is inactive."""
    import numpy as np
    import torch
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY
    from k8s_llm_scheduler_tpu_torch.models.llama import forward_decode

    rng = np.random.default_rng(7)
    kc, vc, tables = _tiny_paged_inputs(dev, rng)
    logits, _, _ = forward_decode(
        _on(cpu_params, dev), TINY, torch.tensor([70, 71, 72], device=dev),
        torch.tensor([40, 17, 3], dtype=torch.int32, device=dev), kc, vc, tables,
        torch.tensor([True, True, False], device=dev), paged_attn="pallas",
    )
    return logits


# ----------------------------------------------------------- decision phase
def build_backend():
    import torch
    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend

    t0 = time.perf_counter()
    # greedy (the modes are held token for token), batches as waves, and
    # 64 pages a slot: the geometry earlier runs measured
    backend = build_local_backend(
        "llama-3.1-8b-instruct", device="cuda", seed=0, request_timeout_s=600.0,
        temperature=0.0, packed_admission=False, max_pages_per_seq=64,
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"decision: 8B backend built in {build_s:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    return backend, build_s


MODES = (("graphs", True), ("eager", False))  # InferenceEngine(graphs=...)
NO_PREWARM_S = 3600.0  # an eager backend's idle grace: longer than the smoke


def _serve(backend, nodes, pods, n_singles, prewarm: bool) -> dict:
    """The decision drive: n_singles single decisions; then (with
    `prewarm`, once the backend's idle worker has captured the sibling wave
    geometries: engine.prewarm_wave_siblings, polled through
    wave_prewarm_backlog) the batch; then one more single decision under the profiler
    (launch_census). Returns its times, the decisions [(pod, decision)],
    each wave's tokens, row count and cold flag (from harvest_wave), and
    the valid tokens of each block call by row bucket R."""
    eng = backend.engine
    waves: list[dict] = []
    harvest = eng.harvest_wave

    def recorded(handle):
        fins = harvest(handle)
        waves.append({"R": handle.geo_key[0], "cold": handle.cold_compile,
                      "tokens": [f.token_ids for f in fins]})
        return fins

    eng.harvest_wave = recorded
    eng.block_tokens.clear()
    out, singles = [], []
    try:
        for pod in pods[:n_singles]:
            t = time.perf_counter()
            out.append((pod, backend.get_scheduling_decision(pod, nodes)))
            singles.append((time.perf_counter() - t) * 1000.0)
        totals = {eng.max_slots // 2: list(eng.block_tokens)}
        eng.block_tokens.clear()
        t = time.perf_counter()
        while prewarm and eng.wave_prewarm_backlog():
            if time.perf_counter() - t > 600:
                raise RuntimeError("the sibling wave prewarm did not drain in 600 s")
            time.sleep(0.05)
        prewarm_s = time.perf_counter() - t
        n_single_waves = len(waves)
        t = time.perf_counter()
        batch = backend.get_scheduling_decisions_batch(pods, nodes)
        batch_ms = (time.perf_counter() - t) * 1000.0
        totals[eng.max_slots] = list(eng.block_tokens)
        batch_cold = [w["cold"] for w in waves[n_single_waves:]]
        calls0 = eng.stats["wave_model_calls"]
        census = launch_census(lambda: backend.get_scheduling_decision(pods[0], nodes))
        census["model_calls"] = eng.stats["wave_model_calls"] - calls0
    finally:
        del eng.harvest_wave
    for pod, d in zip(pods, batch):
        if isinstance(d, Exception):
            raise d
        out.append((pod, d))
    return {"single_decision_ms": singles, "prewarm_wait_s": prewarm_s,
            "batch_of_8_ms": batch_ms, "batch_cold_compile": batch_cold,
            "decisions": out, "waves": waves, "totals": totals, "census": census}


def _graph_books(engine) -> dict:
    """The engine's CUDA-graph books: captures, replays, capture seconds by
    program (summed over its geometries)."""
    runner = engine._graphs
    return {"captures": runner.captures, "replays": runner.replays,
            "capture_s": dict(runner.capture_s)}


def _memory(start: int) -> dict:
    import torch

    return {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "peak_above_start_gib": (torch.cuda.max_memory_allocated() - start) / 2**30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}


def _drive_modes(make_backend, nodes, pods, profiled=False) -> dict:
    """_serve in graph mode, then eagerly (graphs=False), each on a backend
    from make_backend(graphs) that is closed after it; every launch count
    is zeroed just before a mode's drive and read just after it. An eager
    backend has nothing to capture: it is built with an idle grace that
    never passes, so no prewarm dummy wave runs in its drive. With
    `profiled`, graph mode's backend then runs profiler_cost."""
    import torch

    recs = {}
    for mode, graphs in MODES:
        backend = make_backend(graphs)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            with launches_by_step(backend.engine) as steps:
                _zero_launch_counts()
                t0 = time.perf_counter()
                served = _serve(backend, nodes, pods, N_SINGLES, prewarm=graphs)
                main_s = time.perf_counter() - t0
                launches = _launch_counts()
            stats = backend.get_stats()
            recs[mode] = {**served, "main_s": main_s, "launches": launches,
                          "steps": steps, "stats": stats,
                          **_graph_books(backend.engine), **_memory(start)}
            if graphs and profiled:
                recs[mode]["profiler"] = profiler_cost(backend, nodes, pods,
                                                       served["census"])
        finally:
            backend.close()
        del backend
        gc.collect()  # an engine and its graphs hold each other
        torch.cuda.empty_cache()
    return recs


PROFILED_SINGLES = 2


def profiler_cost(backend, nodes, pods, census_off) -> dict:
    """The wave profiler's cost on warm bf16 singles in graph mode:
    PROFILED_SINGLES decisions without it and the same with an
    EngineProfiler attached, then pods[0] again with it under
    torch.profiler (launch_census), against `census_off`, pods[0]'s
    census without it. Host launch calls a model call and host waits on
    the device a decision must not change (the fences read perf_counter
    and query events); ok says whether they did not."""
    from k8s_llm_scheduler_tpu_torch.observability.profiler import EngineProfiler

    eng = backend.engine

    def singles():
        ms, syncs0 = [], eng.stats["syncs"]
        for pod in pods[:PROFILED_SINGLES]:
            t = time.perf_counter()
            backend.get_scheduling_decision(pod, nodes)
            ms.append((time.perf_counter() - t) * 1000.0)
        return ms, eng.stats["syncs"] - syncs0

    off_ms, off_syncs = singles()
    prof = EngineProfiler(cfg=eng.cfg)
    eng.attach_profiler(prof)
    try:
        on_ms, on_syncs = singles()
        calls0 = eng.stats["wave_model_calls"]
        census_on = launch_census(lambda: backend.get_scheduling_decision(pods[0], nodes))
        census_on["model_calls"] = eng.stats["wave_model_calls"] - calls0
        snap = prof.snapshot()
    finally:
        eng.attach_profiler(None)

    def launches_a_call(c):
        return c["host_launches"] / max(c["model_calls"], 1)

    rec = {
        "singles_ms_without": off_ms, "singles_ms_with": on_ms,
        "cost_ms_per_decision": (sum(on_ms) - sum(off_ms)) / PROFILED_SINGLES,
        "engine_syncs_without": off_syncs, "engine_syncs_with": on_syncs,
        "host_launches_per_model_call_without": launches_a_call(census_off),
        "host_launches_per_model_call_with": launches_a_call(census_on),
        "host_syncs_without": census_off["host_syncs"],
        "host_syncs_with": census_on["host_syncs"],
        "model_calls_without": census_off["model_calls"],
        "model_calls_with": census_on["model_calls"],
        "waves_profiled": snap["waves_profiled"],
    }
    rec["ok"] = (off_syncs == on_syncs
                 and census_on["model_calls"] == census_off["model_calls"]
                 and census_on["host_launches"] == census_off["host_launches"]
                 and census_on["host_syncs"] == census_off["host_syncs"]
                 and snap["waves_profiled"] == PROFILED_SINGLES + 1)
    print(f"decision: wave profiler cost {rec['cost_ms_per_decision']:.3f} ms a decision "
          f"(singles {[round(x, 1) for x in off_ms]} ms without, "
          f"{[round(x, 1) for x in on_ms]} ms with); host launch calls a model call "
          f"{rec['host_launches_per_model_call_without']:.4f} without, "
          f"{rec['host_launches_per_model_call_with']:.4f} with; host syncs a decision "
          f"{rec['host_syncs_without']} / {rec['host_syncs_with']}; engine syncs "
          f"{off_syncs} / {on_syncs} | {_smi()} | ok={rec['ok']}", flush=True)
    return rec


def _mode_summary(rec, decisions) -> dict:
    """One mode's printed record."""
    stats, census = rec["stats"], rec["census"]
    n = len(decisions)
    return {
        "decisions": n,
        "launches": rec["launches"],
        "launches_per_decision": {k: v / n for k, v in rec["launches"].items()},
        "single_decision_ms": rec["single_decision_ms"],
        "batch_of_8_ms": rec["batch_of_8_ms"],
        "decisions_per_s_batch": 8 / (rec["batch_of_8_ms"] / 1000.0),
        "batch_cold_compile": rec["batch_cold_compile"],
        "prewarm_wait_s": rec["prewarm_wait_s"],
        "prefix_prefill_ms": stats["prefix_prefill_ms"],
        "prefix_tokens_prefilled": stats["prefill_tokens"],
        "wave_ms_total": stats["wave_ms"],
        "waves": stats["waves"],
        "wave_model_calls": stats["wave_model_calls"],
        "wave_block_calls": stats["wave_block_calls"],
        "wave_prewarms": stats["wave_prewarms"],
        "wave_prewarm_failures": stats["wave_prewarm_failures"],
        "captures": rec["captures"], "replays": rec["replays"],
        "capture_s": rec["capture_s"],
        "kernel_launches_per_run": per_call(rec["steps"]),
        "steps": rec["steps"],
        "census_decision": census,
        "host_launches_per_model_call": census["host_launches"] / max(census["model_calls"], 1),
        "device_ops_per_model_call": census["device_ops"] / max(census["model_calls"], 1),
        "peak_gib": rec["peak_gib"], "peak_above_start_gib": rec["peak_above_start_gib"],
        "peak_reserved_gib": rec["peak_reserved_gib"],
    }


def _modes_agree(recs, what: str) -> bool:
    """Graph mode against eager: identical greedy tokens wave for wave and
    row for row, equal kernel launches per device run of every step, the
    batch of 8 warm in graph mode, and no kernel launched outside a graph
    in graph mode's profiled decision."""
    g, e = recs["graphs"], recs["eager"]
    same = [w["tokens"] for w in g["waves"]] == [w["tokens"] for w in e["waves"]]
    calls = per_call(g["steps"]) == per_call(e["steps"])
    warm = g["batch_cold_compile"] == [False]
    # the profiler saw the runtime's calls (a graph launch a model call at
    # least) and no kernel launch among them
    no_eager = (g["census"]["host_kernel_launches"] == 0
                and g["census"]["graph_launches"] >= g["census"]["model_calls"])
    print(f"{what}: graphs vs eager tokens identical={same} ({len(g['waves'])} waves), "
          f"launches per run equal={calls}, batch warm={warm}, "
          f"graph-mode decision launched no kernel outside a graph={no_eager}", flush=True)
    return same and calls and warm and no_eager


def decision_phase(backend, build_s, nodes, pods) -> tuple[bool, dict]:
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer

    params, cfg = backend.engine.params, backend.engine.cfg

    def make(graphs):
        if graphs:
            return backend  # built before phase 2, graphs on by default
        return LocalLLMBackend(
            InferenceEngine(params, cfg, ByteTokenizer(), temperature=0.0, rng_seed=0,
                            graphs=False),
            request_timeout_s=600.0, prewarm_idle_delay_s=NO_PREWARM_S)

    recs = _drive_modes(make, nodes, pods, profiled=True)
    ok = _modes_agree(recs, "decision")
    rec = {"model": "llama-3.1-8b-instruct", "nodes": len(nodes), "backend_build_s": build_s}
    for mode, _ in MODES:
        r = recs[mode]
        ok = ok and _feasible(nodes, r["decisions"])
        rec[mode] = _mode_summary(r, r["decisions"])
        print(f"decision [{mode}]: " + json.dumps(rec[mode]), flush=True)
    g = recs["graphs"]
    # the main path's counts: graph mode; measured by step, every K1 launch
    # of the run falls in one of them
    rec["launches"] = g["launches"]
    rec["k1_launches_by_step"] = {step: r["K1"] for step, r in g["steps"].items()}
    # the batch of 8's wave, row by row (the admission phase packs it)
    rec["batch_tokens"] = g["waves"][N_SINGLES]["tokens"]
    ok = (ok and g["launches"]["K1"] > 0 and g["launches"]["K2"] > 0
          and sum(rec["k1_launches_by_step"].values()) == g["launches"]["K1"])
    rec["profiler"] = g["profiler"]
    ok = ok and rec["profiler"]["ok"]
    rec["gil"] = gil_probe()
    o_ok, rec["two_waves"] = two_wave_overlap(backend, nodes, pods)
    return ok and o_ok and rec["gil"]["released"], rec


OVERLAP_LIMIT = 1.25  # the first of two back-to-back waves, against a lone one


def two_wave_overlap(backend, nodes, pods) -> tuple[bool, dict]:
    """The wave dispatcher on the card, on the graph-mode engine (greedy):
    a lone warm R=8 wave of the pods' suffixes (A) is timed, and so is
    another of them reversed (B); then A and B are submitted back to back
    and harvested in turn. harvest_wave of A must return within
    OVERLAP_LIMIT x the lone A's time, counted from A's submit, and both
    waves' tokens must equal those of the same waves run alone."""
    eng = backend.engine
    items = [backend._prepare_item(pod, nodes) for pod in pods[: eng.max_slots]]
    backend._switch_group(items[0])  # the decision phase's prefix and grammar
    a = [i.suffix_ids for i in items]
    b = a[::-1]
    new = backend.max_new_tokens

    def alone(prompts):
        t0 = time.perf_counter()
        fins = eng.decide_wave(prompts, new)
        return time.perf_counter() - t0, [f.token_ids for f in fins]

    alone(a)  # warm
    lone_a, toks_a = alone(a)
    lone_b, toks_b = alone(b)
    t0 = time.perf_counter()
    ha = eng.submit_wave(a, new)
    submit_a = time.perf_counter() - t0
    hb = eng.submit_wave(b, new)
    submit_b = time.perf_counter() - t0
    fa = eng.harvest_wave(ha)
    first = time.perf_counter() - t0
    fb = eng.harvest_wave(hb)
    second = time.perf_counter() - t0
    same = [f.token_ids for f in fa] == toks_a and [f.token_ids for f in fb] == toks_b
    ratio = first / lone_a
    rec = {"lone_a_s": lone_a, "lone_b_s": lone_b, "submit_a_s": submit_a,
           "submit_b_s": submit_b, "harvest_a_s": first, "harvest_b_s": second,
           "ratio": ratio, "tokens_equal": same, "cold": [ha.cold_compile, hb.cold_compile],
           "model_calls": [ha.iters, hb.iters]}
    ok = ratio <= OVERLAP_LIMIT and same and not (ha.cold_compile or hb.cold_compile)
    print(f"decision, two waves back to back: lone A {lone_a:.3f} s, lone B {lone_b:.3f} s; "
          f"submits returned at {submit_a * 1e3:.2f} / {submit_b * 1e3:.2f} ms, harvest A at "
          f"{first:.3f} s ({ratio:.3f}x the lone A; limit {OVERLAP_LIMIT}x), B at "
          f"{second:.3f} s; tokens equal to the lone waves'={same} | {_smi()} | ok={ok}",
          flush=True)
    return ok, rec


def gil_probe() -> dict:
    """Whether a thread waiting on a CUDA event (the wave dispatcher's
    fences, harvest_wave) lets other Python threads run: the main thread
    counts loop turns for 0.2 s alone, then for 0.2 s while another
    thread waits on an event behind ~1 s of device sleep."""
    import torch

    def spin(seconds):
        n, end = 0, time.perf_counter() + seconds
        while time.perf_counter() < end:
            n += 1
        return n

    alone = spin(0.2)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # ~1 s of cycles
    ev = torch.cuda.Event()
    ev.record()
    waiter = threading.Thread(target=ev.synchronize)
    waiter.start()
    time.sleep(0.02)
    during = spin(0.2)
    still_waiting = waiter.is_alive()
    waiter.join()
    rec = {"spin_alone": alone, "spin_while_waiting": during,
           "waiter_was_waiting": still_waiting,
           "released": still_waiting and during > 0.5 * alone}
    print(f"decision: a thread in Event.synchronize releases the GIL={rec['released']} "
          f"({during} loop turns beside it against {alone} alone)", flush=True)
    return rec


# ---------------------------------------------------------- admission phase
TINY_CHUNK = 16  # the TINY pack's chunk width: its prompts span chunks
TINY_NEW_TOKENS = 24


def _default_config():
    """The port's config at its defaults (the JAX package's): no file, no
    env."""
    import copy

    from k8s_llm_scheduler_tpu_torch.config import DEFAULTS, Config

    return Config(copy.deepcopy(DEFAULTS))


ADMISSION_KEYS = ("packed_admission", "admission_chunk_tokens", "delta_prompts",
                  "repin_fraction", "max_pins")


def _admission_backend(engine):
    """A LocalLLMBackend over `engine` with the config's default admission
    plane (packed batches, delta prompts, 4 pins), as `cli run` and `cli
    demo` map it (cli._backend_kwargs); the chunk width is the engine's,
    checked against the config's."""
    from k8s_llm_scheduler_tpu_torch.cli import _backend_kwargs
    from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend

    kw = {k: v for k, v in _backend_kwargs(_default_config()).items() if k in ADMISSION_KEYS}
    if engine.admission_chunk_tokens != kw.pop("admission_chunk_tokens"):
        raise RuntimeError("the engine's admission chunk is not the config's")
    return LocalLLMBackend(engine, request_timeout_s=600.0, **kw)


@contextlib.contextmanager
def _recording_paged(engine):
    """Records each admit_packed call (its request ids and wall ms), the
    Finished records and count of step() calls, and the device ms of each
    pack chunk and each decode chunk (CUDA events around their launches:
    the device's time from the first to the last, idle gaps included), on
    `engine`."""
    import torch

    rec = {"packs": [], "fins": {}, "steps": 0, "events": {"pack chunk": [],
                                                          "decode chunk": []}}
    admit, step = engine.admit_packed, engine.step

    def timed(name, fn):
        def call(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            rec["events"][name].append((start, end))
            return out
        return call

    engine._pack_chunk = timed("pack chunk", engine._pack_chunk)
    engine._chunk_dispatch = timed("decode chunk", engine._chunk_dispatch)

    def admit_packed(prompts, max_new_tokens=200, piggyback_decode=True):
        t = time.perf_counter()
        ids = admit(prompts, max_new_tokens, piggyback_decode)
        rec["packs"].append((ids, (time.perf_counter() - t) * 1000.0))
        return ids

    def recorded_step(chunks=1):
        fins = step(chunks)
        rec["steps"] += 1
        rec["fins"].update((f.req_id, f.token_ids) for f in fins)
        return fins

    engine.admit_packed, engine.step = admit_packed, recorded_step
    try:
        yield rec
    finally:
        del engine.admit_packed, engine.step, engine._pack_chunk, engine._chunk_dispatch
        torch.cuda.synchronize()
        rec["ms"] = {name: [a.elapsed_time(b) for a, b in evs]
                     for name, evs in rec.pop("events").items()}


def _pinned_gib(engine) -> float:
    return sum(p.k.numel() * p.k.element_size() * 2
               for key, p in engine._prefix_cache.items()
               if key in engine._pinned_prefix_keys) / 2**30


def _packed_batch(engine, nodes, pods, wave_tokens) -> tuple[bool, dict]:
    """(a) The batch of 8 through get_scheduling_decisions_batch of a
    backend with the config's default admission plane on the decision phase's
    graph-mode engine: one packed admission of the 8 suffixes in chunks of
    256 (K1 in each chunk's prefix part), decode chunks piggybacked between
    them, then step() until every decision is done. Counts zeroed just
    before the call and read just after it."""
    import torch
    from k8s_llm_scheduler_tpu_torch.core.prompt import PromptEngine, pod_suffix
    from k8s_llm_scheduler_tpu_torch.utils.json_extract import parse_decision_json

    pe = PromptEngine()
    suffix_tokens = sum(len(engine.tokenizer.chat_prompt_parts(
        pe.system_prompt, pe.cluster_part(nodes), pod_suffix(pod))[1]) for pod in pods)
    C = engine.admission_chunk_tokens
    backend = _admission_backend(engine)
    before = dict(engine.stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with _recording_paged(engine) as paged, launches_by_step(engine) as steps:
            _zero_launch_counts()
            t0 = time.perf_counter()
            batch = backend.get_scheduling_decisions_batch(pods, nodes)
            wall_ms = (time.perf_counter() - t0) * 1000.0
            launches = _launch_counts()
    finally:
        backend.close()
    d = {k: engine.stats[k] - before[k] for k in (
        "packed_admissions", "packed_prompts", "pack_chunks", "piggyback_chunks",
        "chunks", "syncs", "prefix_prefills", "waves")}
    errors = [repr(x) for x in batch if isinstance(x, Exception)]
    ids, admit_ms = paged["packs"][0] if paged["packs"] else ([], None)
    tokens = [paged["fins"].get(i) for i in ids]
    same = sum(t == w for t, w in zip(tokens, wave_tokens))
    # where each stream first leaves the wave's, and the node each names
    first_diff = [next((i for i, (x, y) in enumerate(zip(t or [], w)) if x != y), None)
                  for t, w in zip(tokens, wave_tokens)]

    def node(ids_):
        parsed = parse_decision_json(engine.tokenizer.decode(ids_ or []))
        return parsed and parsed["selected_node"]

    same_node = sum(node(t) == node(w) for t, w in zip(tokens, wave_tokens))
    ms = paged["ms"]
    pack = steps.get("pack chunk", {"runs": 0, "K1": 0})
    rec = {
        "wall_ms": wall_ms, "admit_packed_ms": admit_ms, "suffix_tokens": suffix_tokens,
        "chunk_tokens": C, **d, "decode_steps": d["chunks"] * engine.chunk_steps,
        "step_calls": paged["steps"], "launches": launches,
        "pack_chunk_runs": pack["runs"], "pack_chunk_k1": pack["K1"],
        "tokens_a_decision": [len(t) if t else None for t in tokens],
        "same_tokens_as_the_wave": same, "first_token_unlike_the_wave": first_diff,
        "same_node_as_the_wave": same_node,
        "pack_chunk_ms": ms["pack chunk"], "decode_chunk_ms": ms["decode chunk"],
        "pinned_gib": _pinned_gib(engine),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "errors": errors,
    }
    n_chunks = -(-suffix_tokens // C)
    ok = (not errors and len(ids) == 8 and None not in tokens
          and _feasible(nodes, list(zip(pods, batch)))
          and d["packed_admissions"] == 1 and d["packed_prompts"] == 8
          and d["pack_chunks"] == pack["runs"] == n_chunks and d["waves"] == 0
          and pack["K1"] == n_chunks * engine.cfg.n_layers == launches["K1"])
    print(f"admission (a): packed batch of 8: {json.dumps(rec)}", flush=True)
    print(f"admission (a): {suffix_tokens} suffix tokens in {d['pack_chunks']} chunks of {C} "
          f"(K1 {pack['K1']} launches in them), {d['piggyback_chunks']} decode chunks "
          f"piggybacked, {rec['decode_steps']} decode steps in {d['chunks']} chunks, "
          f"{paged['steps']} step() calls; batch wall {wall_ms:.1f} ms (admit_packed "
          f"{admit_ms and round(admit_ms, 1)} ms; pack chunks {sum(ms['pack chunk']):.1f} ms "
          f"and decode chunks {sum(ms['decode chunk']):.1f} ms of device time); {same} of 8 "
          f"token streams equal the wave's (first unlike at {first_diff}), {same_node} name "
          f"the same node; pinned {rec['pinned_gib']:.2f} GiB, peak {rec['peak_gib']:.2f} GiB | "
          f"{_smi()} | ok={ok}", flush=True)
    return ok, rec


def _drain_paged(eng, ids):
    out = {}
    while not set(ids) <= out.keys():
        out.update((f.req_id, f.token_ids) for f in eng.step())
    return [out[i] for i in ids]


def _packed_tiny() -> tuple[bool, dict]:
    """(b) At TINY on the card, three prompts of the decision path (one
    shorter than a 16-token chunk, one spanning 14 chunks, one between),
    under the decision grammar and unconstrained: admit_packed with decode
    chunks piggybacked (graphs) must be token-identical to admit_packed
    with none (the slot state the eager pack chunks write in place is what
    the chunk graph's replays read) and to each prompt's serial generate(),
    and one pack chunk's end logits on the card within 5e-2 of the largest
    logit of its plain version on the CPU. In bf16: the kernels take bf16
    operands, so f32 runs only on the CPU, where the tests hold the same
    identity (tests/test_torch_admission.py). These inputs are fixed, so
    the result is too; in bf16 the packed and serial reductions round
    apart, so other inputs may flip a near-tie."""
    import torch
    from k8s_llm_scheduler_tpu_torch.core.prompt import PromptEngine, pod_suffix
    from k8s_llm_scheduler_tpu_torch.engine.admission.packer import pack_prompts
    from k8s_llm_scheduler_tpu_torch.engine.constrained import build_decision_dfa
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY
    from k8s_llm_scheduler_tpu_torch.models.llama import forward_prefill_packed, init_params
    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes

    tok, pe = ByteTokenizer(), PromptEngine()
    nodes = synthetic_nodes(4)
    parts = [tok.chat_prompt_parts(pe.system_prompt, pe.cluster_part(nodes), pod_suffix(p))
             for p in fixture_pods(3)]
    prompts = [parts[0][1][:12], parts[1][1], parts[2][1][:40]]
    cpu_params = init_params(TINY, seed=1, device="cpu")
    eng = InferenceEngine(_on(cpu_params, "cuda"), TINY, tok, temperature=0.0,
                          prefix_chunk=512, admission_chunk_tokens=TINY_CHUNK)
    eng.set_prefix(parts[0][0])
    dfa = build_decision_dfa(tok, [n.name for n in nodes], max_reason_tokens=16)
    rec, ok = {"prompt_lens": [len(p) for p in prompts]}, True
    for mode, grammar in (("grammar", dfa), ("free", None)):
        eng.set_grammar(grammar)
        serial = [eng.generate(p, max_new_tokens=TINY_NEW_TOKENS).token_ids for p in prompts]
        runs = {}
        for name, piggyback in (("piggybacked", True), ("not piggybacked", False)):
            before = dict(eng.stats)
            with launches_by_step(eng) as steps:
                _zero_launch_counts()
                ids = eng.admit_packed(prompts, TINY_NEW_TOKENS, piggyback_decode=piggyback)
                tokens = _drain_paged(eng, ids)
            runs[name] = {
                "tokens": tokens,
                "pack_chunks": eng.stats["pack_chunks"] - before["pack_chunks"],
                "piggyback_chunks": eng.stats["piggyback_chunks"] - before["piggyback_chunks"],
                "pack_chunk_k1": steps["pack chunk"]["K1"],
            }
        p, q = runs["piggybacked"], runs["not piggybacked"]
        n_chunks = -(-sum(map(len, prompts)) // TINY_CHUNK)
        good = (p["tokens"] == q["tokens"] and p["piggyback_chunks"] > 0
                and q["piggyback_chunks"] == 0
                and p["pack_chunks"] == q["pack_chunks"] == n_chunks
                and p["pack_chunk_k1"] == q["pack_chunk_k1"] == n_chunks * TINY.n_layers
                and all(1 <= len(t) <= TINY_NEW_TOKENS for t in p["tokens"])
                and p["tokens"] == serial)
        same_serial = [t == s for t, s in zip(p["tokens"], serial)]
        rec[mode] = {**{k: v for k, v in p.items() if k != "tokens"},
                     "identical_without_piggyback": p["tokens"] == q["tokens"],
                     "same_as_serial_generate": same_serial, "ok": good}
        ok = ok and good
        print(f"admission (b): TINY {mode}: piggybacked == not piggybacked "
              f"{p['tokens'] == q['tokens']} ({p['piggyback_chunks']} chunks piggybacked, "
              f"{p['pack_chunks']} pack chunks, K1 {p['pack_chunk_k1']}); same as serial "
              f"generate {same_serial} ok={good}", flush=True)
    # the first pack chunk's end logits, card against the CPU's plain twins
    chunk = pack_prompts(prompts, TINY_CHUNK, tok.pad_id).chunks[0]
    ends = torch.tensor([e.index for e in chunk.ends] or [0])
    logits = {}
    for dev, params in (("cuda", eng.params), ("cpu", cpu_params)):
        pk, pv = eng._prefix.k.to(dev), eng._prefix.v.to(dev)
        L, _, n_kv, hd = pk.shape
        carry = torch.zeros((L, TINY_CHUNK, n_kv, hd), dtype=pk.dtype, device=dev)
        cache = torch.zeros((L, 2, TINY_CHUNK, n_kv, hd), dtype=pk.dtype, device=dev)
        logits[dev] = forward_prefill_packed(
            params, TINY, torch.from_numpy(chunk.tokens).to(dev),
            torch.from_numpy(chunk.seg).to(dev),
            torch.from_numpy(chunk.positions).to(dev) + eng.prefix_len,
            pk, pv, torch.tensor(eng.prefix_len, dtype=torch.int32, device=dev),
            carry, carry.clone(), torch.full((TINY_CHUNK,), -1, dtype=torch.int32, device=dev),
            0, cache, cache.clone(), torch.ones(TINY_CHUNK, dtype=torch.int32, device=dev),
            torch.arange(TINY_CHUNK, dtype=torch.int32, device=dev), ends.to(dev),
        ).float().cpu()
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    scale = logits["cpu"].abs().max().item()
    good = bool(torch.isfinite(logits["cuda"]).all()) and err <= 5e-2 * scale
    rec["pack_chunk_logits"] = {"max_abs_err": err, "max_logit": scale, "ok": good}
    print(f"admission (b): TINY pack chunk end logits, cuda vs cpu err={err:.4g} "
          f"(max |logit| {scale:.4g}) ok={good}", flush=True)
    ok = ok and good and eng.kv.pages_free == eng.kv.num_pages - 1
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return ok, rec


def admission_phase(engine, nodes, pods, wave_tokens) -> tuple[bool, dict]:
    a_ok, a = _packed_batch(engine, nodes, pods, wave_tokens)
    b_ok, b = _packed_tiny()
    return a_ok and b_ok, {"packed_batch": a, "tiny": b}


# --------------------------------------------------------------- loop phase
LOOP_NODES = 32  # the decision phase's cluster: the same 5,488-token prefix
LOOP_PODS = 32
LOOP_SHAPES = 8
LOOP_SECOND_PODS = 8  # the second burst: one pod a shape
LOOP_DEADLINE_S = 300.0


def _loop_burst(engine, backend, cluster, pods, bound_total):
    """One burst through a new `cli.build_stack` over `backend`: the pods,
    already added, until `bound_total` binds in all (deadline
    LOOP_DEADLINE_S). Returns its record (launches as the difference of the
    counts read before and after) and whether it passed."""
    import asyncio

    from k8s_llm_scheduler_tpu_torch.cli import build_stack, run_until_bound
    from k8s_llm_scheduler_tpu_torch.cluster.interface import raw_pod_to_spec
    from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes

    nodes = cluster.get_node_metrics()  # the snapshot the burst is decided on
    scheduler, _ = build_stack(_default_config(), cluster, backend=backend)
    bound_at: dict[str, float] = {}
    bind = cluster.bind_pod_to_node

    def timed_bind(name, namespace, node):
        ok = bind(name, namespace, node)
        bound_at.setdefault(name, time.perf_counter())
        return ok

    cluster.bind_pod_to_node = timed_bind
    waves: list[dict] = []
    harvest = engine.harvest_wave

    def recorded(handle):
        fins = harvest(handle)
        waves.append({"rows": handle.n, "R": handle.geo_key[0],
                      "cold": handle.cold_compile})
        return fins

    # each decision's prompt: the pinned snapshot's prefix, or that plus a
    # STATE UPDATES diff; and the pin it names
    items: list = []
    prepare = backend._prepare_item

    def prepare_item(pod, nodes, cluster_info=None):
        item = prepare(pod, nodes, cluster_info)
        items.append(item)
        return item

    engine.harvest_wave = recorded
    backend._prepare_item = prepare_item
    before, counters0, launches0 = dict(engine.stats), dict(backend.counters), _launch_counts()
    try:
        t0 = time.perf_counter()
        all_bound = asyncio.run(run_until_bound(scheduler, cluster, bound_total,
                                                LOOP_DEADLINE_S))
        run_s = time.perf_counter() - t0
        launches = {k: v - launches0[k] for k, v in _launch_counts().items()}
    finally:
        del engine.harvest_wave, backend._prepare_item, cluster.bind_pod_to_node
    stats = scheduler.get_stats()
    client = stats["client"]
    counters = {k: v - counters0[k] for k, v in backend.counters.items()}
    eng = {k: engine.stats[k] - before[k] for k in (
        "prefix_prefills", "prefix_hits", "waves", "wave_model_calls", "wave_prewarms")}
    by_name = {n.name: n for n in nodes}
    placed = {p.name: cluster.get_pod(p.namespace, p.name).node_name for p in pods}
    feasible = all(
        placed[p.name] is not None and by_name[placed[p.name]].is_ready
        and placed[p.name] in {n.name for n in feasible_nodes(raw_pod_to_spec(p), nodes)}
        for p in pods)
    # every backend call that raised was retried, or failed the decision
    calls = counters["async_calls"] + counters["sync_calls"]
    errors = calls - client["successful_requests"] - client["invalid_decisions"]
    retries = errors - client["failed_requests"]
    bound = sorted(t - t0 for t in bound_at.values())
    rec = {
        "nodes": len(nodes), "pods": len(pods), "all_bound": all_bound, "feasible": feasible,
        "llm_decisions": stats["llm_decisions"],
        "cache_decisions": stats["cache_decisions"],
        "client_cached": client["cached_requests"],
        "client_coalesced": client["coalesced_requests"],
        "fallback_decisions": client["fallback_decisions"] + stats["fallback_decisions"],
        "retries": retries, "failed_requests": client["failed_requests"],
        "backend_errors": errors,
        "breaker": client["circuit_breaker"]["state"],
        "async_calls": counters["async_calls"], "sync_calls": counters["sync_calls"],
        "waves": len(waves), "rows_per_wave": [w["rows"] for w in waves],
        "wave_R": [w["R"] for w in waves], "cold_waves": sum(w["cold"] for w in waves),
        "group_installs": counters["group_installs"],
        "prewarms_installed": counters["prewarms_installed"],
        "prewarms_dropped": counters["prewarms_dropped"],
        "engine": eng,
        "encodings": sorted({"pinned" if list(i.prefix_ids) == list(i.pin_spec[1])
                             else "delta" for i in items}),
        "pin_keys": sorted({i.pin_spec[0] for i in items}),
        "first_bound_s": bound[0] if bound else None,
        "last_bound_s": bound[-1] if bound else None,
        "run_s": run_s, "launches": launches,
        "phases_ms": {k: v["avg_ms"] for k, v in stats["phases"].items()},
    }
    ok = (all_bound and feasible and rec["fallback_decisions"] == 0 and retries == 0
          and rec["failed_requests"] == 0 and rec["backend_errors"] == 0
          and rec["breaker"] == "closed" and counters["sync_calls"] == 0
          and counters["async_calls"] == stats["llm_decisions"] > 0
          and launches["K1"] > 0 and launches["K2"] > 0)
    return ok, rec, {tuple(i.prefix_ids) for i in items}, nodes


@contextlib.contextmanager
def _recording_prefixes(engine):
    """Records every prefix install of the engine (set_prefix and
    pin_prefix, on the worker thread, one at a time): its token ids, the
    tokens it prefilled and reused, its wall ms (ending in a sync) and the
    K1/K2 launches it made."""
    import torch

    recs: list[dict] = []
    inner = engine._set_prefix_inner

    def recorded(prompt_ids, activate=True):
        before, launches0 = dict(engine.stats), _launch_counts()
        t = time.perf_counter()
        inner(prompt_ids, activate)
        torch.cuda.synchronize()
        launches = _launch_counts()
        recs.append({
            "ids": tuple(prompt_ids), "ms": (time.perf_counter() - t) * 1000.0,
            **{k: engine.stats[k] - before[k] for k in (
                "prefix_prefills", "prefix_hits", "prefill_tokens", "prefix_reused_tokens")},
            **{k: launches[k] - launches0[k] for k in ("K1", "K2")},
        })

    engine._set_prefix_inner = recorded
    try:
        yield recs
    finally:
        del engine._set_prefix_inner


def loop_phase(engine):
    """The scheduler's main path through the user's entry points: a
    FakeCluster holding a burst of pending pods (all added before the loop
    starts, so one snapshot serves the burst's leaders), the stack of
    `cli.build_stack` at the reference config's defaults with the backend
    of `cli demo` (the config's default admission plane: delta prompts over
    pinned prefixes), and Scheduler.run() until every pod is bound, over a
    new LocalLLMBackend on the decision phase's graph-mode engine (no
    second copy of the weights). Then a second burst of one pod a shape on
    the same cluster, after the first's binds, through a new stack over the
    same backend. Every launch count is zeroed just before the first burst
    and read after each. Fails unless in both bursts every pod is bound to
    a ready node that is feasible for it, the client made no fallback
    decision, no retry and met no backend error, the breaker is closed,
    every LLM decision came through get_scheduling_decision_async (none
    through a to_thread thread), and K1 and K2 launched; and unless the
    first burst's prompts are the pinned snapshot and the second's a delta
    over the same pin, which is still held, and the prefill of the second
    burst's prefix (when the decisions' group install or the scheduler's
    idle prefix prewarm ran it) computed fewer tokens than the prefix,
    seeded from the pin, K1 and K2 launching in it."""
    from k8s_llm_scheduler_tpu_torch.core.prompt import render_node_block
    from k8s_llm_scheduler_tpu_torch.testing import pod_burst, synthetic_cluster

    cluster = synthetic_cluster(LOOP_NODES)
    pods = pod_burst(LOOP_PODS, distinct_shapes=LOOP_SHAPES)
    for pod in pods:
        cluster.add_pod(pod)
    backend = _admission_backend(engine)
    try:
        with _recording_prefixes(engine) as installs:
            _zero_launch_counts()
            ok1, rec, _, _ = _loop_burst(engine, backend, cluster, pods, LOOP_PODS)
            second = [dataclasses.replace(p, name=f"second-{p.name}") for p in
                      pod_burst(LOOP_SECOND_PODS, distinct_shapes=LOOP_SHAPES)]
            for pod in second:
                cluster.add_pod(pod)
            ok2, rec2, prefixes, nodes2 = _loop_burst(
                engine, backend, cluster, second, LOOP_PODS + LOOP_SECOND_PODS)
        pin = backend._delta._pin
        pins = backend._pin_manager.stats()
        pin_held = set(backend._pin_manager.pins)
    finally:
        backend.close()
    # the prefill of the second burst's prefix, wherever it ran
    fill = next((r for r in installs if r["ids"] in prefixes and r["prefix_prefills"]), None)
    rec2["drifted_nodes"] = sum(render_node_block(n) != pin.blocks[n.name] for n in nodes2)
    rec2["prefix_install"] = fill and {k: v for k, v in fill.items() if k != "ids"}
    rec2["prefix_len"] = len(fill["ids"]) if fill else None
    rec["second_burst"] = rec2
    rec["pins"] = pins
    rec["prefix_installs"] = [{k: (len(v) if k == "ids" else v) for k, v in r.items()}
                              for r in installs]
    ok = (ok1 and ok2 and rec["encodings"] == ["pinned"] and rec2["encodings"] == ["delta"]
          and len(rec["pin_keys"]) == 1 and rec2["pin_keys"] == rec["pin_keys"]
          and rec["pin_keys"][0] in pin_held and fill is not None
          and 0 < fill["prefill_tokens"] < len(fill["ids"])
          and fill["prefix_reused_tokens"] > 0 and fill["K1"] > 0 and fill["K2"] > 0)
    print(f"loop: {json.dumps(rec)}", flush=True)
    print(f"loop: {rec['llm_decisions']} LLM decisions, {rec['client_cached']} cache or "
          f"single-flight hits ({rec['client_coalesced']} coalesced), {rec['waves']} waves "
          f"of {rec['rows_per_wave']} rows, {rec['group_installs']} group installs, prefix "
          f"prewarms {rec['prewarms_installed']} installed / {rec['prewarms_dropped']} dropped; "
          f"pending -> bound first {rec['first_bound_s']:.3f} s, last "
          f"{rec['last_bound_s']:.3f} s; burst wall {rec['run_s']:.3f} s; prompts "
          f"{rec['encodings']} | {_smi()} | ok={ok1}", flush=True)
    fill = fill or {"prefill_tokens": None, "prefix_reused_tokens": None, "ms": float("nan"),
                    "K1": None, "K2": None}
    print(f"loop, second burst: {rec2['pods']} pods, {rec2['llm_decisions']} LLM decisions "
          f"in {rec2['waves']} waves of {rec2['rows_per_wave']} rows; prompts "
          f"{rec2['encodings']} over {rec2['drifted_nodes']} drifted nodes; its prefix "
          f"prefill {fill['prefill_tokens']} of {rec2['prefix_len']} tokens "
          f"({fill['prefix_reused_tokens']} seeded from the pin) in {fill['ms']:.1f} ms, K1 "
          f"{fill['K1']} / K2 {fill['K2']} launches; pending -> bound last "
          f"{rec2['last_bound_s']:.3f} s, wall {rec2['run_s']:.3f} s; {pins['live_pins']} "
          f"pins live | {_smi()} | ok={ok}", flush=True)
    return ok, rec


def _child_env(**extra) -> dict:
    """The environment of a child process of the smoke: the repository on
    its PYTHONPATH, since children run in a temporary directory (the
    repo root's config.yaml would be read there, and a machine without
    PyYAML refuses a config file it cannot read)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    env.update(extra)
    return env


def demo_phase(device="cuda"):
    """`python -m k8s_llm_scheduler_tpu_torch.cli demo --model tiny
    --fake-nodes 4` in a process of its own on the card, in a temporary
    directory (the config's defaults: temperature 0.3): it must exit 0
    with its three fixture pods bound and no fallback decision."""
    cmd = [sys.executable, "-m", "k8s_llm_scheduler_tpu_torch.cli", "demo",
           "--model", "tiny", "--fake-nodes", "4", "--device", device]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as cwd:
        out = subprocess.run(cmd, cwd=cwd, env=_child_env(), capture_output=True, text=True,
                             timeout=600)
    wall_s = time.perf_counter() - t0
    try:
        stats = json.loads(out.stdout)
    except ValueError:
        stats = {}
    rec = {"rc": out.returncode, "wall_s": wall_s,
           "binds": stats.get("total_scheduled"),
           "llm_decisions": stats.get("llm_decisions"),
           "fallbacks": stats.get("fallback_decisions")}
    ok = (out.returncode == 0 and rec["binds"] == 3 and rec["fallbacks"] == 0
          and stats["client"]["fallback_decisions"] == 0)
    print(f"cli demo: {json.dumps(rec)} ok={ok}", flush=True)
    if not ok:
        print(out.stderr[-4000:], file=sys.stderr, flush=True)
    return ok, rec


def _feasible(nodes, decisions) -> bool:
    from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes

    ok = True
    for pod, d in decisions:
        names = {n.name for n in feasible_nodes(pod, nodes)}
        good = d.selected_node in names and 0.0 <= d.confidence <= 1.0
        ok = ok and good
        print(f"  {pod.name}: {d.selected_node} conf={d.confidence} "
              f"reasoning_len={len(d.reasoning)} ok={good}", flush=True)
    return ok


def path_a_phase(backend, nodes, pods):
    """int8 weights (quantized on the card from the bf16 8B params) and
    ragged block-decode matmuls (K3) on the decision path, in both modes;
    K3 launches 7 a layer of every block-decode run in both."""
    import torch
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
    from k8s_llm_scheduler_tpu_torch.models.quant import param_bytes, quantize_params

    cfg = backend.engine.cfg
    t0 = time.perf_counter()
    params = quantize_params(backend.engine.params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0

    def make(graphs):
        engine = InferenceEngine(params, cfg, ByteTokenizer(), temperature=0.0,
                                 decode_matmul="ragged", graphs=graphs)
        return LocalLLMBackend(engine, request_timeout_s=600.0,
                               prewarm_idle_delay_s=0.5 if graphs else NO_PREWARM_S)

    recs = _drive_modes(make, nodes, pods)
    ok = _modes_agree(recs, "path A")
    rec = {"model": "llama-3.1-8b-instruct int8 weight-only, decode_matmul=ragged",
           "quantize_s": quant_s, "int8_param_gib": param_bytes(params) / 2**30}
    k3_per_block = 7 * cfg.n_layers
    for mode, _ in MODES:
        r = recs[mode]
        ok = ok and _feasible(nodes, r["decisions"])
        blocks = {step: c for step, c in per_call(r["steps"]).items()
                  if step.startswith("block decode")}
        ok = (ok and r["launches"]["K3"] > 0 and r["launches"]["K1"] > 0 and bool(blocks)
              and all(c["K3"] == k3_per_block for c in blocks.values()))
        rec[mode] = _mode_summary(r, r["decisions"])
        print(f"path A [{mode}]: " + json.dumps(rec[mode]), flush=True)
    g = recs["graphs"]
    rec["launches"] = g["launches"]
    rec["block_tokens"] = {str(r): t for r, t in g["totals"].items()}
    return ok, rec, g["totals"]


def _path_b_run(eng, suffixes):
    """One path-B drive on engine `eng` (its prefix installed): 8 suffixes
    admitted and stepped to completion, one generate(), then 8 more
    admitted with one step() under the profiler (launch_census) and the
    rest drained."""
    import torch

    pages0 = eng.kv.pages_free
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = eng.add_requests(suffixes, max_new_tokens=PATH_B_NEW_TOKENS)
    plen = eng.prefix_len
    shapes = [("step after admission", eng._padded_tables().clone(),
               (eng._state.pos - plen).clone())]
    fins = []
    while eng.has_active:
        fins += eng.step()
        if len(shapes) == 1:
            shapes.append(("step after one chunk", eng._padded_tables().clone(),
                           (eng._state.pos - plen).clone()))
    batch_s = time.perf_counter() - t0
    chunks_batch = eng.stats["chunks"]
    t1 = time.perf_counter()
    gen = eng.generate(suffixes[0], max_new_tokens=PATH_B_NEW_TOKENS)
    gen_s = time.perf_counter() - t1
    chunks_main = eng.stats["chunks"]
    pages_main = eng.kv.pages_free
    more = eng.add_requests(suffixes, max_new_tokens=PATH_B_NEW_TOKENS)
    box = {}
    census = launch_census(lambda: box.setdefault("fins", eng.step()))
    census["decode_steps"] = (eng.stats["chunks"] - chunks_main) * eng.chunk_steps
    extra = box["fins"]
    while eng.has_active:
        extra += eng.step()
    done = {f.req_id: f.token_ids for f in fins}
    done_more = {f.req_id: f.token_ids for f in extra}
    return {
        "ids": ids, "tokens": [done.get(i) for i in ids], "generate": gen.token_ids,
        "extra": [done_more.get(i) for i in more],
        "batch_s": batch_s, "chunks_batch": chunks_batch, "gen_s": gen_s,
        "chunks_main": chunks_main, "pages0": pages0, "pages_main": pages_main,
        "pages_end": eng.kv.pages_free, "shapes": shapes, "census": census,
        "pages_shape": tuple(eng.kv.k.shape[1:]),
    }


def path_b_phase(backend, nodes, pods):
    """General completion on the bf16 8B params: set_prefix, add_requests,
    step() to completion, then generate(), own-token attention through K4,
    in both modes: identical tokens, every page returned."""
    import torch
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer

    cfg = backend.engine.cfg
    items = [backend._prepare_item(p, nodes) for p in pods]
    suffixes = [it.suffix_ids for it in items]
    runs, ok = {}, True
    rec = {"model": "llama-3.1-8b-instruct bf16, paged_attn=pallas",
           "suffix_tokens": [len(sfx) for sfx in suffixes]}
    for mode, graphs in MODES:
        # step() and a generate() that drains through step(): the fused
        # runtime has its own phase
        eng = InferenceEngine(backend.engine.params, cfg, ByteTokenizer(), temperature=0.0,
                              paged_attn="pallas", max_slots=8, page_size=64, graphs=graphs,
                              fused_decode=False)
        eng.set_prefix(items[0].prefix_ids)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        with launches_by_step(eng) as steps:
            _zero_launch_counts()
            r = _path_b_run(eng, suffixes)
            launches = _launch_counts()
        runs[mode] = r
        n_tok = sum(len(t) for t in r["tokens"] if t is not None)
        steps_run = r["chunks_batch"] * eng.chunk_steps
        good = (all(t is not None and 1 <= len(t) <= PATH_B_NEW_TOKENS for t in r["tokens"])
                and 1 <= len(r["generate"]) <= PATH_B_NEW_TOKENS
                and all(t is not None and 1 <= len(t) <= PATH_B_NEW_TOKENS
                        for t in r["extra"])
                and launches["K4"] > 0
                and r["pages_main"] == r["pages0"] == r["pages_end"])
        census = r["census"]
        rec[mode] = {
            "prefix_tokens": eng.prefix_len,
            "requests": len(r["ids"]),
            "tokens_per_request": [len(t or ()) for t in r["tokens"]],
            "batch_wall_s": r["batch_s"],
            "batch_tokens_per_s": n_tok / r["batch_s"],
            "chunks": r["chunks_batch"],
            "ms_per_decode_step": r["batch_s"] * 1000.0 / steps_run,
            "generate_tokens": len(r["generate"]),
            "generate_wall_s": r["gen_s"],
            "generate_tokens_per_s": len(r["generate"]) / r["gen_s"],
            "generate_ms_per_decode_step": r["gen_s"] * 1000.0 / (
                (r["chunks_main"] - r["chunks_batch"]) * eng.chunk_steps),
            "launches": launches,
            "launches_per_decode_step": launches["K4"] / (eng.stats["chunks"] * eng.chunk_steps),
            "kernel_launches_per_run": per_call(steps),
            "steps": steps,
            "census_step": census,
            "host_launches_per_decode_step": census["host_launches"] / census["decode_steps"],
            "device_ops_per_decode_step": census["device_ops"] / census["decode_steps"],
            **_graph_books(eng), **_memory(start),
            "pages_free_start": r["pages0"], "pages_free_end": r["pages_end"],
            "ok": good,
        }
        ok = ok and good
        print(f"path B [{mode}]: " + json.dumps(rec[mode]), flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    g, e = runs["graphs"], runs["eager"]
    same = (g["tokens"], g["generate"], g["extra"]) == (e["tokens"], e["generate"], e["extra"])
    calls = rec["graphs"]["kernel_launches_per_run"] == rec["eager"]["kernel_launches_per_run"]
    no_eager = (g["census"]["host_kernel_launches"] == 0
                and g["census"]["graph_launches"] >= 1)
    print(f"path B: graphs vs eager tokens identical={same}, launches per run equal={calls}, "
          f"graph-mode step launched no kernel outside a graph={no_eager}", flush=True)
    ok = ok and same and calls and no_eager
    rec["launches"] = rec["graphs"]["launches"]
    q_shape = (8 + 1, cfg.n_heads, cfg.head_dim)
    cases = [(step, q_shape, g["pages_shape"], t.cpu(), l.cpu())
             for step, t, l in g["shapes"]]
    return ok, rec, cases


# ------------------------------------------------------------------ fused phase
FUSED_TOP_K = 40
FUSED_DEAD_REPS = 10
# the fused chunk's sampling over constant probabilities (testing.chunk_draws:
# 16 runs of 16 steps on 64 slots, vocab 32): a draw equals its slot's draw
# at step 0 by chance ~0.04 of the time, and 16,384 draws lie ~0.02 from
# the softmax in total variation
CHUNK_REPEAT_LIMIT = 0.25
CHUNK_TV_LIMIT = 0.05


def _events():
    import torch

    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def _live_chunk_ms(eng) -> tuple[float, int]:
    """Device ms (CUDA events) of one fused chunk dispatched on the live
    batch, and the steps it ran; its emissions park for the next harvest.
    The prefix and page tables are bound first, so no host copy lands in
    the window."""
    eng._bind_prefix()
    eng._padded_tables()
    start, end = _events()
    start.record()
    toks, steps, prog = eng._fused_chunk_dispatch()
    end.record()
    end.synchronize()
    eng._pending_emissions.append(toks)
    return start.elapsed_time(end), eng._book_fused_steps([(steps, prog)])


def _dead_chunk_ms(eng, reps: int) -> tuple[float, int]:
    """Device ms (CUDA events) of the fused chunk's program run `reps`
    times back to back on the finished batch, per run, and the steps the
    last ran: one dispatch first binds the tables and finds the program,
    then its replays alone are timed (no host buffer, no copy in the
    window)."""
    toks, steps, prog = eng._fused_chunk_dispatch()
    eng._book_fused_steps([(steps, prog)])
    start, end = _events()
    start.record()
    for _ in range(reps):
        prog.run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, int(eng._chunk.j)


def _fused_run(eng, suffixes) -> dict:
    """On `eng` (its prefix installed): the 8 suffixes drained by step(),
    one generate() (its fused chunks capture the program), the 8 drained
    by decode_fused() (timed, with its books and K4 launches), then a live
    chunk and, on the finished batch, dead chunks timed alone."""
    import torch

    n = PATH_B_NEW_TOKENS
    ids = eng.add_requests(suffixes, max_new_tokens=n)
    fins = []
    while eng.has_active:
        fins += eng.step()
    by_step = {f.req_id: f.token_ids for f in fins}
    stepped = [by_step[i] for i in ids]
    chunks1 = eng.stats["fused_chunks"]
    t1 = time.perf_counter()
    gen = eng.generate(suffixes[0], max_new_tokens=n)
    gen_rec = dict(generate=gen.token_ids, generate_s=time.perf_counter() - t1,
                   generate_chunks=eng.stats["fused_chunks"] - chunks1)
    steps0, tok0, chunks0 = (eng.stats[k] for k in ("fused_steps", "decode_tokens",
                                                    "fused_chunks"))
    k4_0 = _launch_counts()["K4"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = eng.add_requests(suffixes, max_new_tokens=n)
    done = {f.req_id: f.token_ids for f in eng.decode_fused()}
    wall = time.perf_counter() - t0
    fused = [done.get(i) for i in ids]
    steps = eng.stats["fused_steps"] - steps0
    rec = {
        "tokens": fused, "stepped": stepped,
        "wall_s": wall, "fused_steps": steps, "chunks": eng.stats["fused_chunks"] - chunks0,
        "decode_tokens": eng.stats["decode_tokens"] - tok0,
        "k4_launches": _launch_counts()["K4"] - k4_0, **gen_rec,
    }
    # a live chunk (16 steps on 8 slots) beside over-dispatched ones on the
    # finished batch; the live batch then drains
    ids = eng.add_requests(suffixes, max_new_tokens=n)
    rec["live_chunk_ms"], rec["live_chunk_steps"] = _live_chunk_ms(eng)
    while eng.has_active:
        eng.decode_fused()
    rec["dead_chunk_ms"], rec["dead_chunk_steps"] = _dead_chunk_ms(eng, FUSED_DEAD_REPS)
    return rec


def _sampled_fused(params, cfg, prefix, suffixes) -> dict:
    """Two sampled decode_fused drains at temperature 0.3 with top-k 40
    (graphs), the second timed: every token a decodable id, never pad,
    within the budget."""
    import torch
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    eng = InferenceEngine(params, cfg, tok, temperature=SAMPLED_TEMPERATURE,
                          top_k=FUSED_TOP_K, paged_attn="pallas", max_slots=8, page_size=64)
    eng.set_prefix(prefix)
    ids = eng.add_requests(suffixes, max_new_tokens=PATH_B_NEW_TOKENS)
    done = {f.req_id: f.token_ids for f in eng.decode_fused()}
    streams = [done.get(i) for i in ids]
    # a second drain, its chunk captured: timed
    steps0 = eng.stats["fused_steps"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = eng.add_requests(suffixes, max_new_tokens=PATH_B_NEW_TOKENS)
    done = {f.req_id: f.token_ids for f in eng.decode_fused()}
    wall = time.perf_counter() - t0
    steps = eng.stats["fused_steps"] - steps0
    streams += [done.get(i) for i in ids]
    valid = all(s is not None and 1 <= len(s) <= PATH_B_NEW_TOKENS
                and all(0 <= t < tok.vocab_size and t != tok.pad_id for t in s)
                for s in streams)
    rec = {"temperature": SAMPLED_TEMPERATURE, "top_k": FUSED_TOP_K, "valid": valid,
           "tokens": sum(len(s or ()) for s in streams),
           "distinct_streams": len({tuple(s or ()) for s in streams}),
           "fused_chunks": eng.stats["fused_chunks"], "replays": eng._graphs.replays,
           "timed_wall_s": wall, "timed_fused_steps": steps,
           "timed_ms_per_step": wall * 1000.0 / max(steps, 1)}
    del eng
    return rec


def _chunk_draws_check() -> dict:
    """The fused chunk's sampling captured on the card (its steps one WHILE
    node) over probabilities that stay constant: every run takes its 16
    steps, 15 of the 16 runs are replays, a slot's draws across one chunk's
    steps are independent (a draw made inside the WHILE body would repeat
    at every step) and follow the softmax within CHUNK_TV_LIMIT."""
    from k8s_llm_scheduler_tpu_torch import testing

    rec = testing.chunk_draws("cuda")
    rec["ok"] = (rec["steps_run"] == [16] * 16 and rec["replays"] == 15
                 and rec["repeat"] <= CHUNK_REPEAT_LIMIT and rec["tv"] <= CHUNK_TV_LIMIT)
    return rec


def fused_phase(backend, nodes, pods, path_b) -> tuple[bool, dict]:
    """The fused decode runtime at 8B bf16: path B's engine configuration
    (paged_attn="pallas", 8 slots, the path B prompts, greedy, 64 new
    tokens) in both modes. decode_fused must emit the tokens of a step()
    drain, book exactly max(tokens) - 1 steps and sum(tokens - 1) decode
    tokens, launch K4 n_layers times a step inside its program, and
    generate() must go through it; graphs and eager emit identical tokens.
    Times ms a step and tok/s beside path B's, and one over-dispatched
    chunk on a finished batch beside a live chunk (CUDA events). Then one
    sampled drain (0.3, top-k 40) whose tokens must all be valid, and the
    chunk's sampling over constant probabilities (_chunk_draws_check)."""
    import torch
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer

    params, cfg = backend.engine.params, backend.engine.cfg
    items = [backend._prepare_item(p, nodes) for p in pods]
    suffixes = [it.suffix_ids for it in items]
    prefix = items[0].prefix_ids
    rec, runs, ok = {"model": "llama-3.1-8b-instruct bf16, paged_attn=pallas"}, {}, True
    for mode, graphs in MODES:
        eng = InferenceEngine(params, cfg, ByteTokenizer(), temperature=0.0,
                              paged_attn="pallas", max_slots=8, page_size=64, graphs=graphs)
        eng.set_prefix(prefix)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        r = runs[mode] = _fused_run(eng, suffixes)
        lens = [len(t) for t in r["tokens"] if t is not None]
        n_tok = sum(lens)
        books = (len(lens) == len(suffixes) and r["fused_steps"] == max(lens) - 1
                 and r["decode_tokens"] == sum(n - 1 for n in lens))
        good = (r["tokens"] == r["stepped"] and books
                and r["k4_launches"] == cfg.n_layers * r["fused_steps"] > 0
                and r["generate_chunks"] > 0 and 1 <= len(r["generate"]) <= PATH_B_NEW_TOKENS
                and r["live_chunk_steps"] == eng.chunk_steps and r["dead_chunk_steps"] == 0
                and eng.stats["fused_fallbacks"] == 0)
        b = path_b.get(mode, {})
        rec[mode] = {
            "tokens_equal_step_drain": r["tokens"] == r["stepped"], "books_exact": books,
            "tokens_per_request": lens, "fused_steps": r["fused_steps"],
            "fused_chunks": r["chunks"], "decode_tokens": r["decode_tokens"],
            "k4_launches": r["k4_launches"],
            "wall_s": r["wall_s"], "ms_per_step": r["wall_s"] * 1000.0 / r["fused_steps"],
            "tokens_per_s": n_tok / r["wall_s"],
            "path_b_ms_per_step": b.get("ms_per_decode_step"),
            "path_b_tokens_per_s": b.get("batch_tokens_per_s"),
            "generate_tokens": len(r["generate"]), "generate_chunks": r["generate_chunks"],
            "generate_s": r["generate_s"],
            "live_chunk_ms": r["live_chunk_ms"], "live_chunk_steps": r["live_chunk_steps"],
            "dead_chunk_ms": r["dead_chunk_ms"],
            **_graph_books(eng), **_memory(start), "ok": good,
        }
        ok = ok and good
        print(f"fused [{mode}]: " + json.dumps(rec[mode]), flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    same = runs["graphs"]["tokens"] == runs["eager"]["tokens"]
    rec["sampled"] = _sampled_fused(params, cfg, prefix, suffixes)
    gc.collect()
    torch.cuda.empty_cache()
    rec["chunk_draws"] = _chunk_draws_check()
    ok = ok and same and rec["sampled"]["valid"] and rec["chunk_draws"]["ok"]
    print(f"fused: graphs vs eager tokens identical={same}; sampled drain "
          f"{json.dumps(rec['sampled'])}; chunk draws {json.dumps(rec['chunk_draws'])} "
          f"| {_smi()} | ok={ok}", flush=True)
    rec["launches"] = {"K4": rec["graphs"]["k4_launches"]}
    return ok, rec


# ------------------------------------------------------------ persistent phase
class _OpCounter:
    """Counts the torch ops run on the thread that enters it (a torch
    dispatch mode: modes are thread-local)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        ops = self.ops = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops.append(str(func))
                return func(*args, **(kwargs or {}))

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def _drain_resident(eng, n, deadline_s=300.0) -> dict:
    out = {}
    end = time.perf_counter() + deadline_s
    while len(out) < n and time.perf_counter() < end:
        for fin in eng.step_persistent(timeout_s=0.05):
            out[fin.req_id] = fin.token_ids
    return out


def persistent_8b(backend, nodes, pods) -> tuple[bool, dict]:
    """(a) The resident loop at 8B bf16, unconstrained, greedy: an engine
    with paged_attn="gather" (the loop's own-token attention is the dense
    gather, as in the JAX loop), suffix bucket 256; reference: the 8
    path B suffixes admitted one at a time and drained by decode_fused.
    Then enter_persistent, the 8 through the command ring, step_persistent
    until done: the same tokens, the counter block's `emitted` equal to
    the decode tokens harvested, no torch op on the owner thread and no
    dispatch booked between the admissions and the last harvest. Then a
    quiesce mid-stream, and the rest drained by step_fused: the same
    tokens again."""
    import torch
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer

    params, cfg = backend.engine.params, backend.engine.cfg
    items = [backend._prepare_item(p, nodes) for p in pods]
    suffixes = [it.suffix_ids for it in items]
    n = PATH_B_NEW_TOKENS
    eng = InferenceEngine(params, cfg, ByteTokenizer(), temperature=0.0, paged_attn="gather",
                          max_slots=8, page_size=64, num_pages=128, max_pages_per_seq=8,
                          prefill_buckets=(256, 512, 1024, 2048), persistent_loop=True,
                          persistent_suffix_bucket=256)
    eng.set_prefix(items[0].prefix_ids)
    rec = {"model": "llama-3.1-8b-instruct bf16, paged_attn=gather",
           "suffix_tokens": [len(s) for s in suffixes]}
    try:
        ids = [eng.add_requests([s], max_new_tokens=n)[0] for s in suffixes]
        done = {f.req_id: f.token_ids for f in eng.decode_fused()}
        want = [done.get(i) for i in ids]
        # a warm-up residency: its first micro-chunks capture the loop's
        # admit and plain programs
        t_warm = time.perf_counter()
        eng.enter_persistent()
        eng.add_requests(suffixes[:1], max_new_tokens=2 * eng.chunk_steps)
        _drain_resident(eng, 1)
        eng.exit_persistent()
        rec["warmup_s"] = time.perf_counter() - t_warm

        torch.cuda.synchronize()
        before = _launch_counts()
        t_enter = time.perf_counter()
        entered = eng.enter_persistent()
        dispatches, tok0, steps0 = (eng.stats[k] for k in ("dispatches", "decode_tokens",
                                                          "persistent_steps"))
        t0 = time.perf_counter()
        with _OpCounter() as owner:
            ids = eng.add_requests(suffixes, max_new_tokens=n)
            out = _drain_resident(eng, len(ids))
        wall = time.perf_counter() - t0
        steady_dispatches = eng.stats["dispatches"] - dispatches
        resident_tokens = eng.stats["decode_tokens"] - tok0
        resident_steps = eng.stats["persistent_steps"] - steps0
        eng.exit_persistent()
        launches = {k: v - before[k] for k, v in _launch_counts().items()}
        totals = eng.persistent_counter_totals() or {}
        got = [out.get(i) for i in ids]
        n_tok = sum(len(t) for t in got if t is not None)

        # quiesce mid-stream, resume on the dispatch path
        reentered = eng.enter_persistent()
        ids = eng.add_requests(suffixes, max_new_tokens=n)
        mid = {}
        end = time.perf_counter() + 300.0
        while eng.stats["persistent_steps"] - resident_steps - steps0 < 1 and \
                time.perf_counter() < end:
            for fin in eng.step_persistent(timeout_s=0.05):
                mid[fin.req_id] = fin.token_ids
        eng.exit_persistent()
        for fin in eng.step_persistent(timeout_s=0.0):
            mid[fin.req_id] = fin.token_ids
        while eng.has_active:
            for fin in eng.step_fused():
                mid[fin.req_id] = fin.token_ids
        resumed = [mid.get(i) for i in ids]
        srv = eng._persistent
        rec.update({
            "entered": entered and reentered, "enter_s": t0 - t_enter,
            "tokens_equal_decode_fused": got == want,
            "resume_tokens_equal": resumed == want,
            "owner_thread_torch_ops": len(owner.ops), "owner_ops_sample": owner.ops[:5],
            "steady_dispatches": steady_dispatches,
            "counter_totals": totals, "harvested_decode_tokens": resident_tokens,
            "resident_steps": resident_steps, "wall_s": wall,
            "ms_per_step": wall * 1000.0 / max(resident_steps, 1),
            "tokens_per_s": n_tok / wall, "launches": launches,
            "tokens_per_request": [len(t or ()) for t in got],
            "launches_total": eng.stats["persistent_launches"],
            **_graph_books(eng), **srv.stats(),
        })
    finally:
        if eng.persistent_active:
            eng.exit_persistent()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    ok = (rec["entered"] and rec["tokens_equal_decode_fused"] and rec["resume_tokens_equal"]
          and rec["owner_thread_torch_ops"] == 0 and rec["steady_dispatches"] == 0
          and totals.get("emitted") == resident_tokens and totals.get("admits") == len(suffixes)
          and launches["K1"] > 0 and launches["K2"] > 0)
    print(f"persistent (a): {json.dumps(rec, default=str)} | {_smi()} | ok={ok}", flush=True)
    return ok, rec


def persistent_tiny() -> tuple[bool, dict]:
    """(b) TINY, the decision grammar, through LocalLLMBackend(
    persistent_loop=True) on the card (graphs, the config's temperature
    0.3): 6 decisions at once served by the resident loop (no wave), all
    parsed and feasible."""
    import concurrent.futures as cf

    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes
    from k8s_llm_scheduler_tpu_torch.types import DecisionSource

    nodes, pods = synthetic_nodes(4), fixture_pods(6)
    backend = build_local_backend("tiny", device="cuda", request_timeout_s=600.0,
                                  prewarm_idle_delay_s=NO_PREWARM_S, persistent_loop=True,
                                  persistent_suffix_bucket=1024)
    t0 = time.perf_counter()
    try:
        with cf.ThreadPoolExecutor(len(pods)) as pool:
            decisions = list(pool.map(lambda p: backend.get_scheduling_decision(p, nodes),
                                      pods))
        wall = time.perf_counter() - t0
        stats = backend.engine.get_stats()
    finally:
        backend.close()
    llm = all(d.source == DecisionSource.LLM for d in decisions)
    feasible = _feasible(nodes, list(zip(pods, decisions)))
    rec = {k: stats.get(k) for k in ("persistent_launches", "persistent_admissions",
                                     "persistent_fallbacks", "persistent_steps",
                                     "persistent_chunks", "waves", "persistent_wedges")}
    rec.update(decisions=len(decisions), all_llm=llm, feasible=feasible, wall_s=wall)
    ok = (llm and feasible and rec["persistent_admissions"] == len(pods)
          and rec["persistent_fallbacks"] == 0 and rec["waves"] == 0
          and rec["persistent_wedges"] == 0)
    print(f"persistent (b): TINY decisions through the resident loop {json.dumps(rec)} "
          f"| ok={ok}", flush=True)
    return ok, rec


# ------------------------------------------------------------------ spec phase
SPEC_K = 4  # the config's llm.spec_k
SPEC_NEW_TOKENS = 64
SPEC_PROMPTS = 2
SPEC_TEMPERATURE = 0.3  # the config's llm.temperature
# Greedy at 8B bf16 is held token by token to the target's own argmax: each
# emitted token's logit, under one teacher-forced forward of prompt +
# output, within 5e-2 of the largest |logit| of the largest (the bf16
# tolerance of the reference phase); a verify block and a one-token step
# round differently, so near-ties may flip between the two paths.
SPEC_TF_TOL = 5e-2
# The self-draft's acceptance at TINY bf16: 1.0 in f32 (tests/test_torch_
# spec.py); a random draft's is ~0.
SPEC_SELF_ACCEPT = 0.75
SPEC_TINY_PROMPT = "The quick brown fox jumps over the lazy dog. " * 2
SPEC_TINY_NODES = ["node-a", "node-b", "node-west-1"]
SPEC_COMPLETE_PROMPT = "Schedule pod web-1 on the least loaded node."


def _sync_s(fn):
    """(fn(), host seconds of it, ending in a device sync)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _verify_runs(spec) -> int:
    """Verify programs run (eager, warm-up or replay) by a decoder."""
    return sum(p.program.runs for p in spec._programs.values())


def _teacher_forced(eng, sfx, out):
    """The target's logits [len(out), V] f32 predicting each token of `out`,
    from one forward of sfx + out[:-1] against the engine's prefix (K1 and
    K2, as a suffix prefill computes them), and the mask of the ids plain
    decode may emit (pad and ids past the tokenizer excluded)."""
    import torch
    from k8s_llm_scheduler_tpu_torch.models import llama

    params, cfg, dev = eng.params, eng.cfg, eng.device
    pfx = eng._prefix or eng._get_empty_prefix()
    ids = list(sfx) + list(out[:-1])
    S = len(ids)
    tokens = torch.tensor([ids], dtype=torch.int32, device=dev)
    plen = torch.tensor(pfx.length, dtype=torch.int32, device=dev)
    positions = plen + torch.arange(S, dtype=torch.int32, device=dev)[None]
    lens = torch.tensor([S], dtype=torch.int32, device=dev)
    inv = llama.rope_inv_freq(cfg, dev)
    with torch.no_grad():
        x = params["embed"][tokens.long()]
        for i in range(cfg.n_layers):
            x, _, _ = llama._suffix_layer(llama._layer(params["layers"], i), cfg, x,
                                          positions, lens, pfx.k[i], pfx.v[i], plen, inv)
        logits = llama._logits(params, cfg, x[0, len(sfx) - 1:])
    V = logits.shape[-1]
    ids_v = torch.arange(V, device=dev)
    legal = ids_v != eng.tokenizer.pad_id
    if eng._vocab_limit is not None:
        legal &= ids_v < eng._vocab_limit
    return logits, legal


def _argmax_check(eng, sfx, out) -> dict:
    """Each token of `out` against the teacher-forced argmax (SPEC_TF_TOL),
    over the ids plain decode may emit there: under a grammar, those its
    dense table allows in the state the output has reached."""
    import torch

    logits, legal = _teacher_forced(eng, sfx, out)
    legal = legal.expand(len(out), -1)
    dense = eng.dense_grammar()
    if dense is not None:
        table = dense.cpu()
        st, rows = eng._dfa_start, []
        for t in out:
            rows.append(table[st] >= 0)
            st = int(table[st, t])
        legal = legal & torch.stack(rows).to(logits.device)
    masked = torch.where(legal, logits, float("-inf"))
    top = masked.max(dim=-1).values
    scale = torch.where(legal, logits.abs(), 0.0).max(dim=-1).values
    got = masked.gather(1, torch.tensor(out, device=logits.device)[:, None].long())[:, 0]
    gap = ((top - got) / scale).cpu()
    exact = (masked.argmax(dim=-1).cpu() == torch.tensor(out)).tolist()
    return {"max_gap_rel": float(gap.max()), "exact_argmax": sum(exact),
            "tokens": len(out), "ok": bool((gap <= SPEC_TF_TOL).all())}


def _first_divergence(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def _spec_drive(eng, spec, prompts, check=True) -> dict:
    """Each prompt through generate(use_spec=False) and then the attached
    decoder, timed (and its start(): the admission, the first token's
    fetch and the draft's prefill); the decoder's books, host syncs, verify
    runs and kernel launches of its runs, every token held against the
    teacher-forced argmax."""
    import torch

    n = SPEC_NEW_TOKENS
    rec = {"prompts": [], "plain_s": 0.0, "spec_s": 0.0, "start_s": 0.0, "plain_tokens": 0,
           "spec_tokens": 0, "syncs": 0}
    real_start = spec.start

    def timed_start(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_start(*args, **kwargs)
        torch.cuda.synchronize()
        rec["start_s"] += time.perf_counter() - t0
        return out

    spec.start = timed_start
    s0 = spec.stats.snapshot()
    runs0 = _verify_runs(spec)
    launches = {k: 0 for k in _launch_counts()}
    for sfx in prompts:
        plain, plain_s = _sync_s(lambda: eng.generate(sfx, n, use_spec=False))
        before, syncs0 = _launch_counts(), eng.stats["syncs"]
        fin, spec_s = _sync_s(lambda: eng.generate(sfx, n))
        rec["syncs"] += eng.stats["syncs"] - syncs0
        for k, v in _launch_counts().items():
            launches[k] += v - before[k]
        rec["plain_s"] += plain_s
        rec["spec_s"] += spec_s
        rec["plain_tokens"] += len(plain.token_ids)
        rec["spec_tokens"] += len(fin.token_ids)
        p = {"tokens": len(fin.token_ids), "plain_tokens": len(plain.token_ids),
             "first_divergence": _first_divergence(fin.token_ids, plain.token_ids),
             "spec_ids": fin.token_ids}
        if check:
            p["argmax"] = _argmax_check(eng, sfx, fin.token_ids)
        rec["prompts"].append(p)
    s1 = spec.stats.snapshot()
    d = {k: s1[k] - s0[k] for k in ("requests", "rounds", "proposed", "accepted", "emitted",
                                     "disables", "fallback_requests", "overlapped_rounds",
                                     "ahead_wasted")}
    rec.update(books=d, acceptance_rate=d["accepted"] / max(d["proposed"], 1),
               verify_runs=_verify_runs(spec) - runs0,
               launches=launches)
    # a round: a verify (and the draft arm's proposals), its one fetch and
    # the host's books, start() left out
    rec["ms_per_round"] = ((rec["spec_s"] - rec["start_s"]) * 1000.0
                           / max(rec["verify_runs"], 1))
    del spec.start
    rec["ms_per_token"] = rec["spec_s"] * 1000.0 / max(rec["spec_tokens"], 1)
    rec["plain_ms_per_token"] = rec["plain_s"] * 1000.0 / max(rec["plain_tokens"], 1)
    # admission launches K1 n_layers times a request, each verify n_layers
    rec["k1_expected"] = eng.cfg.n_layers * (len(prompts) + rec["verify_runs"])
    return rec


def _spec_ok(rec, greedy=True, hand_off=False) -> bool:
    b = rec["books"]
    ok = (rec["launches"]["K1"] == rec["k1_expected"] and rec["verify_runs"] > 0
          and all(1 <= p["tokens"] <= SPEC_NEW_TOKENS for p in rec["prompts"]))
    if greedy:
        ok = ok and all(p["argmax"]["ok"] for p in rec["prompts"])
    if not hand_off:
        # one sync at start, then one a round (the bootstrap rounds of the
        # hidden arm are verify runs too)
        ok = ok and rec["syncs"] == rec["verify_runs"] + b["requests"] and b["disables"] == 0
    return ok


def _spec_engine(params, cfg, **kw):
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer

    return InferenceEngine(params, cfg, ByteTokenizer(), **{
        "temperature": 0.0, "paged_attn": "pallas", "max_slots": 2, "page_size": 64,
        "num_pages": 96, "max_pages_per_seq": 16, **kw})


def _spec_8b(backend, nodes, pods) -> tuple[bool, dict]:
    """(a)-(d) on the 8B bf16 weights of the resident backend."""
    import torch
    from k8s_llm_scheduler_tpu_torch.models.configs import get_config
    from k8s_llm_scheduler_tpu_torch.spec import SpeculativeDecoder
    from k8s_llm_scheduler_tpu_torch.spec.draft import build_random_draft

    params, cfg = backend.engine.params, backend.engine.cfg
    items = [backend._prepare_item(p, nodes) for p in pods[:SPEC_PROMPTS]]
    prompts = [it.suffix_ids for it in items]
    prefix = items[0].prefix_ids
    vocab = backend.engine.tokenizer.vocab_size
    draft_params, draft_cfg = build_random_draft(get_config("tiny"), vocab, seed=1,
                                                 device="cuda")
    rec, ok = {"draft": draft_cfg.name, "k": SPEC_K, "prefix_tokens": len(prefix),
               "suffix_tokens": [len(p) for p in prompts]}, True

    def draft_dec(eng, **kw):
        return SpeculativeDecoder(eng, draft_params, draft_cfg, k=SPEC_K, **kw)

    def hidden_dec(eng):
        return SpeculativeDecoder(eng, arm="hidden", k=SPEC_K, hidden_seed=1,
                                  disable_threshold=0.0)

    for mode, graphs in MODES:
        eng = _spec_engine(params, cfg, graphs=graphs)
        eng.set_prefix(prefix)
        drive = prompts if graphs else prompts[:1]
        for arm, make in (("draft", lambda e: draft_dec(e, disable_threshold=0.0)),
                          ("hidden", hidden_dec)):
            spec = make(eng)
            eng.attach_spec(spec)
            r = _spec_drive(eng, spec, drive)
            r["ok"] = _spec_ok(r)
            rec[f"{arm} [{mode}]"] = r
            ok = ok and r["ok"]
            eng.attach_spec(None)
            del spec
            gc.collect()
        if graphs:
            # (d) auto-disable at the default threshold, no prefix (K1 at
            # prefix_len 0): a random draft hands the slot back after
            # min_rounds and the request finishes through the fused chunks
            eng.set_prefix(None)
            spec = draft_dec(eng)
            eng.attach_spec(spec)
            r = _spec_drive(eng, spec, prompts[:1])
            r["handed_off"] = r["books"]["fallback_requests"] == 1 == r["books"]["disables"]
            r["ms_per_round"] = None  # the fused chunks after the hand-off are in spec_s
            r["ok"] = (_spec_ok(r, hand_off=True) and r["handed_off"]
                       and r["launches"]["K4"] > 0)
            rec["auto-disable [graphs]"] = r
            ok = ok and r["ok"]
            eng.attach_spec(None)
            rec["graph_books"] = _graph_books(eng)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    for arm in ("draft", "hidden"):
        g, e = rec[f"{arm} [graphs]"], rec[f"{arm} [eager]"]
        same = g["prompts"][0]["spec_ids"] == e["prompts"][0]["spec_ids"]
        rec[f"{arm} graphs vs eager identical"] = same
        ok = ok and same
    # (c) the draft arm sampled at the config's 0.3 (graphs): legal tokens
    eng = _spec_engine(params, cfg, temperature=SPEC_TEMPERATURE)
    eng.set_prefix(prefix)
    spec = draft_dec(eng, disable_threshold=0.0)
    eng.attach_spec(spec)
    r = _spec_drive(eng, spec, prompts, check=False)
    streams = [p["spec_ids"] for p in r["prompts"]]
    r["legal"] = all(0 <= t < vocab and t != eng.tokenizer.pad_id for s in streams for t in s)
    r["ok"] = _spec_ok(r, greedy=False) and r["legal"]
    rec["draft sampled [graphs]"] = r
    ok = ok and r["ok"]
    del eng, spec
    gc.collect()
    torch.cuda.empty_cache()
    return ok, rec


def _spec_tiny() -> tuple[bool, dict]:
    """(e) TINY bf16 on the card (the kernels take bf16), graphs, greedy:
    each arm (a random draft, the self-draft, the hidden head),
    unconstrained and under the decision grammar behind a prefix, beside
    plain generate: whether the tokens are identical and where they first
    differ is reported; every token must hold the teacher-forced argmax
    (grammar-masked) within SPEC_TF_TOL, and the self-draft must accept at
    least SPEC_SELF_ACCEPT of its proposals (bf16 near-ties). Then the
    draft arm sampled at 0.3: every token legal, and replays draw afresh
    (the same prompt's streams are not all equal)."""
    from k8s_llm_scheduler_tpu_torch.engine.constrained import build_decision_dfa
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY
    from k8s_llm_scheduler_tpu_torch.models.llama import init_params
    from k8s_llm_scheduler_tpu_torch.spec import SpeculativeDecoder
    from k8s_llm_scheduler_tpu_torch.spec.draft import build_random_draft

    tok = ByteTokenizer()
    params = init_params(TINY, seed=0, device="cuda")
    draft, draft_cfg = build_random_draft(TINY, tok.vocab_size, seed=1, device="cuda")
    arms = {
        "draft": lambda e: SpeculativeDecoder(e, draft, draft_cfg, k=SPEC_K,
                                              disable_threshold=0.0),
        "self-draft": lambda e: SpeculativeDecoder(e, params, TINY, k=SPEC_K),
        "hidden": lambda e: SpeculativeDecoder(e, arm="hidden", k=SPEC_K, hidden_seed=1,
                                               disable_threshold=0.0),
    }
    rec, ok = {}, True
    for grammar in (False, True):
        eng = _spec_engine(params, TINY, max_pages_per_seq=8, num_pages=32,
                           prefill_buckets=(64, 128, 256))
        if grammar:
            eng.set_grammar(build_decision_dfa(tok, SPEC_TINY_NODES, max_reason_tokens=16))
            eng.set_prefix(tok.encode("cluster: node-a node-b node-west-1. "))
            prompt, n = tok.encode("Pick a node: "), 110
        else:
            prompt, n = tok.encode(SPEC_TINY_PROMPT), SPEC_NEW_TOKENS
        plain = eng.generate(prompt, n, use_spec=False).token_ids
        for arm, make in arms.items():
            spec = make(eng)
            eng.attach_spec(spec)
            got = eng.generate(prompt, n).token_ids
            snap = spec.stats.snapshot()
            argmax = _argmax_check(eng, prompt, got)
            good = argmax["ok"] and snap["rounds"] > 0
            if arm == "self-draft":
                # a self-draft disagrees with its target's verify only at
                # bf16 near-ties (the draft attends in f32 over a dense
                # buffer, the verify's prefix part rounds as K1 does)
                good = good and snap["acceptance_rate"] >= SPEC_SELF_ACCEPT
            r = {"identical": got == plain, "first_divergence": _first_divergence(got, plain),
                 "tokens": len(got), "rounds": snap["rounds"], "argmax": argmax,
                 "accepted_all": snap["accepted"] == SPEC_K * snap["rounds"],
                 "acceptance_rate": snap["acceptance_rate"], "mode": spec._grammar_mode()[0],
                 "ok": good}
            rec[f"{arm} {'grammar' if grammar else 'free'}"] = r
            ok = ok and good
            eng.attach_spec(None)
    eng = _spec_engine(params, TINY, max_pages_per_seq=8, num_pages=32,
                       prefill_buckets=(64, 128, 256), temperature=SPEC_TEMPERATURE)
    spec = arms["draft"](eng)
    eng.attach_spec(spec)
    prompt = tok.encode(SPEC_TINY_PROMPT)
    replays0 = eng._graphs.replays
    streams = [eng.generate(prompt, 32).token_ids for _ in range(4)]
    legal = all(0 <= t < tok.vocab_size and t != tok.pad_id for s in streams for t in s)
    r = {"streams": len(streams), "distinct": len({tuple(s) for s in streams}),
         "legal": legal, "replays": eng._graphs.replays - replays0,
         "rounds": spec.stats.rounds}
    r["ok"] = legal and r["distinct"] > 1 and r["replays"] > 0
    rec["draft sampled"] = r
    ok = ok and r["ok"]
    return ok, rec


def _spec_complete() -> tuple[bool, dict]:
    """(f) `cli complete --spec` at TINY in a child process (greedy through
    LLM_TEMPERATURE=0), beside the same command without --spec: both exit
    0 and print the same text."""
    outs = {}
    procs = {}
    with tempfile.TemporaryDirectory() as cwd:
        for name, extra in (("spec", ["--spec"]), ("plain", [])):
            cmd = [sys.executable, "-m", "k8s_llm_scheduler_tpu_torch.cli", "complete",
                   "--prompt", SPEC_COMPLETE_PROMPT, "--model", "tiny",
                   "--max-new-tokens", "32", "--device", "cuda", *extra]
            procs[name] = subprocess.Popen(cmd, cwd=cwd, env=_child_env(LLM_TEMPERATURE="0"),
                                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True)
        for name, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=300)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
            outs[name] = (proc.returncode, out, err)
    rec = {name: {"rc": rc, "stdout_chars": len(out)} for name, (rc, out, _) in outs.items()}
    rec["stdout_equal"] = outs["spec"][1] == outs["plain"][1]
    ok = all(rc == 0 for rc, _, _ in outs.values()) and rec["stdout_equal"]
    if not ok:
        for name, (_, _, err) in outs.items():
            print(f"cli complete {name} stderr: {err[-3000:]}", file=sys.stderr, flush=True)
    return ok, rec


def spec_phase(backend, nodes, pods) -> tuple[bool, dict]:
    """Speculative decoding (spec/) on the resident 8B backend's weights and
    at TINY; K1 at the verify shapes. See the module doc, phase 6g."""
    import torch

    ok8, rec = _spec_8b(backend, nodes, pods)
    okt, rec["tiny"] = _spec_tiny()
    okc, rec["cli_complete_spec"] = _spec_complete()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    n = len(backend._prepare_item(pods[0], nodes).prefix_ids)
    chunk = min(backend.engine.prefix_chunk, backend.engine.prefill_buckets[-1])
    sp = -(-n // chunk) * chunk + chunk  # the engine's chunked prefix buffer
    from k8s_llm_scheduler_tpu_torch.engine.engine import EMPTY_PREFIX_SLOTS

    k1 = []
    for S, what in ((SPEC_K + 1, "draft / hidden verify"), (1, "hidden bootstrap")):
        for Sp, plen in ((sp, n), (EMPTY_PREFIX_SLOTS, 0)):
            good, r = _prefix_case(gen, f"spec {what}", 1, S, Sp, plen)
            r["ok"] = good
            r["bound_share"] = r["bound_ms"] / r["ms"]
            _print_attention_case("K1", r)
            k1.append(r)
            torch.cuda.empty_cache()
    rec["k1_cases"] = k1
    okk = all(r["ok"] for r in k1)
    rec["k1_spec_launches"] = sum(
        v["launches"]["K1"] for k, v in rec.items() if isinstance(v, dict) and "launches" in v)
    ok = ok8 and okt and okc and okk
    summary = {k: ({kk: vv for kk, vv in v.items() if kk not in ("prompts",)}
                   if isinstance(v, dict) else v) for k, v in rec.items() if k != "k1_cases"}
    print(f"spec: {json.dumps(summary, default=str)} | {_smi()} | ok={ok} "
          f"(8B {ok8}, TINY {okt}, cli complete --spec {okc}, K1 {okk})", flush=True)
    return ok, rec


# --------------------------------------------------------------- cli complete
COMPLETE_MODEL = "llama-3.1-8b-instruct"
COMPLETE_NEW_TOKENS = 64
# The child of the cli complete phase: `cli complete` at argv[1]'s model,
# greedy, 64 new tokens, on a prompt longer than the config's largest
# prefill bucket (8,192) by more than one prefix chunk (2,048), so its head
# goes through set_prefix's chunked path. Its K1/K2 counts are zeroed
# before cli.main and read after; the chunked prefills and the fused
# chunks' steps are booked. Last line: one JSON object of them.
COMPLETE_CHILD = r"""
import json, sys, time
import torch
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch.engine import engine as engine_mod
from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

prompt = " ".join(f"node-{i:04d} cpu={i * 37 % 100}% mem={i * 53 % 100}%" for i in range(440))
chunked, fused, generated = [], [], []
chunk = engine_mod.InferenceEngine._prefill_prefix_chunked
book = engine_mod.InferenceEngine._book_fused_steps
generate = engine_mod.InferenceEngine.generate

def counted_chunked(self, ids, seed=None):
    chunked.append(len(ids))
    return chunk(self, ids, seed=seed)

def counted_book(self, handles):
    n = book(self, handles)
    fused.append(n)
    return n

def booked_generate(self, ids, max_new_tokens=200):
    fin = generate(self, ids, max_new_tokens)
    generated.append({"tokens": len(fin.token_ids), "token_ids": fin.token_ids,
                      "text": fin.text})
    return fin

engine_mod.InferenceEngine._prefill_prefix_chunked = counted_chunked
engine_mod.InferenceEngine._book_fused_steps = counted_book
engine_mod.InferenceEngine.generate = booked_generate
pa.reset_launch_counts()
t0 = time.perf_counter()
rc = cli.main(["complete", "--model", sys.argv[1], "--max-new-tokens", sys.argv[2],
               "--temperature", "0", "--prompt", prompt])
print()
print(json.dumps({"launches": {"K1": pa.flash_prefix_attention_parts.launches,
                               "K2": pa.flash_causal_attention_parts.launches},
                  "prompt_bytes": len(prompt.encode()), "chunked_prefix": chunked,
                  "fused_steps": fused, "generated": generated,
                  "wall_s": time.perf_counter() - t0,
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
sys.exit(rc)
"""


def start_complete():
    """Start the cli complete child (COMPLETE_CHILD) in a temporary
    directory; finish_complete() collects it."""
    cwd = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-c", COMPLETE_CHILD, COMPLETE_MODEL, str(COMPLETE_NEW_TOKENS)],
        cwd=cwd.name, env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return child, cwd, t0


def finish_complete(started) -> tuple[bool, dict]:
    """`python -m k8s_llm_scheduler_tpu_torch.cli complete` at 8B in a child
    process: exit 0, the prompt's head through the chunked prefix path, K1
    and K2 launched in the child, the tail decoded through the fused
    runtime (1-64 tokens generated), and what the command printed exactly
    the completion's text as generate() returned it (the child records it
    with its token ids; random weights may give an empty-looking text);
    wall time and the child's peak memory."""
    child, cwd, t0 = started
    try:
        out, err = child.communicate(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
        cwd.cleanup()
    lines = out.rstrip("\n").splitlines()
    try:
        report = json.loads(lines[-1])
    except (ValueError, IndexError):
        report = {}
    gen = (report.get("generated") or [{}])[-1]
    # stdout: the command's print of the text, the child's empty line, the
    # report (read as text: universal newlines)
    text = str(gen.get("text")).replace("\r\n", "\n").replace("\r", "\n")
    printed = "text" in gen and out == text + "\n\n" + lines[-1] + "\n"
    rec = {"model": COMPLETE_MODEL, "rc": child.returncode,
           "process_wall_s": time.perf_counter() - t0, "text_printed": printed, **report}
    launches = report.get("launches") or {}
    ok = (child.returncode == 0 and printed
          and 1 <= gen.get("tokens", 0) <= COMPLETE_NEW_TOKENS
          and bool(report.get("chunked_prefix"))
          and launches.get("K1", 0) > 0 and launches.get("K2", 0) > 0
          and sum(report.get("fused_steps") or ()) > 0)
    print(f"cli complete: {json.dumps(rec)} | {_smi()} | ok={ok}", flush=True)
    if not ok:
        print(err[-6000:], file=sys.stderr, flush=True)
    return ok, rec


# ------------------------------------------------------- cli verify, cli run
def verify_phase() -> tuple[bool, dict]:
    """`python -m k8s_llm_scheduler_tpu_torch.cli verify` in a process of
    its own, in a temporary directory (no config file: this machine may
    have no PyYAML): every check must pass, exit 0."""
    cmd = [sys.executable, "-m", "k8s_llm_scheduler_tpu_torch.cli", "verify"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as cwd:
        out = subprocess.run(cmd, cwd=cwd, env=_child_env(), capture_output=True, text=True,
                             timeout=600)
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip().startswith("[")]
    rec = {"rc": out.returncode, "wall_s": time.perf_counter() - t0, "checks": lines}
    ok = out.returncode == 0 and lines and not any(ln.startswith("[FAIL]") for ln in lines)
    for ln in lines:
        print(f"cli verify: {ln}", flush=True)
    print(f"cli verify: rc={out.returncode} in {rec['wall_s']:.1f} s ok={ok}", flush=True)
    if not ok:
        print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr, flush=True)
    return bool(ok), rec


RUN_MODEL = "llama-3.1-8b-instruct"
RUN_NODES = 32
RUN_PODS = 24
RUN_SHAPES = 12  # 12 leaders against 8 slots: two waves, 12 single-flight followers
# Once those are bound, 8 pods of 8 new shapes: one R=8 wave at the suffix
# bucket the first burst captured (the snapshot's delta rides the prefix),
# so the profiler books a warm wave.
RUN_SECOND_PODS = 8
RUN_DEADLINE_S = 600.0
# The run phase's SLO objective (slo.objectives, which no environment
# variable sets): failed binds over decisions.
RUN_SLO_OBJECTIVES = [{"name": "bind_errors", "kind": "error_rate",
                       "numerator": "failed_bindings", "denominator": "total_scheduled",
                       "budget": 0.01}]
# The operating plane's switches, as the run phase's child gets them.
RUN_PLANE_ENV = {"DURABILITY_ENABLED": "true", "METRICS_ENABLED": "true",
                 "METRICS_PORT": "0", "SLO_ENABLED": "true", "SLO_INTERVAL_S": "1.0",
                 "OBS_SAMPLER_INTERVAL_S": "0.5"}
# The child of the run phase: `cli run` against the wire fake at argv[1],
# at the config's defaults (temperature 0.3, packed admission and delta
# prompts on) with LLM_MODEL from its environment, the operating plane's
# switches on (RUN_PLANE_ENV, the journal in its directory) and the SLO
# objectives of SMOKE_SLO_OBJECTIVES. It writes its metrics port to the
# file metrics_port. Its K1/K2 counts are zeroed before cli.main and read
# after it; each harvest_wave return and each parsed decision is booked.
# Last line: one JSON object of them.
RUN_CHILD = r"""
import json, os, sys, time
from pathlib import Path
import torch
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch import config as config_mod
from k8s_llm_scheduler_tpu_torch.cluster import httpapi
from k8s_llm_scheduler_tpu_torch.engine import engine as engine_mod
from k8s_llm_scheduler_tpu_torch.engine import local as local_mod
from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

httpapi.set_active_config(sys.argv[1])
harvests, parsed = [], []
harvest = engine_mod.InferenceEngine.harvest_wave
parse = local_mod.LocalLLMBackend._parse

def timed_harvest(self, handle):
    fins = harvest(self, handle)
    harvests.append({"t": time.perf_counter(), "submitted": handle.submitted_at,
                     "rows": handle.n, "R": handle.geo_key[0], "cold": handle.cold_compile,
                     "model_calls": handle.iters})
    return fins

def booked_parse(self, text):
    try:
        d = parse(self, text)
    except Exception as exc:
        parsed.append({"ok": False, "error": str(exc)[:200]})
        raise
    parsed.append({"ok": True, "node": d.selected_node})
    return d

start_metrics = cli._start_metrics

def port_file(*args, **kwargs):
    server, sampler = start_metrics(*args, **kwargs)
    Path("metrics_port").write_text(str(server.port))
    return server, sampler

engine_mod.InferenceEngine.harvest_wave = timed_harvest
local_mod.LocalLLMBackend._parse = booked_parse
cli._start_metrics = port_file
config_mod.DEFAULTS["slo"]["objectives"] = json.loads(os.environ["SMOKE_SLO_OBJECTIVES"])
pa.reset_launch_counts()
rc = cli.main(["run"])
launches = {"K1": pa.flash_prefix_attention_parts.launches,
            "K2": pa.flash_causal_attention_parts.launches}
print(json.dumps({"launches": launches, "harvests": harvests, "parsed": parsed,
                  "temperature": cli.load_config().get("llm.temperature"),
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
sys.exit(rc)
"""


def _scrape_plane(port_path: Path, timeout_s: float = 30.0) -> dict:
    """/metrics, /debug/profile and /debug/slo of the run phase's child,
    its port read from the file it wrote. {} when it never wrote one."""
    import urllib.request

    end = time.perf_counter() + timeout_s
    while not port_path.exists() and time.perf_counter() < end:
        time.sleep(0.1)
    if not port_path.exists():
        return {}
    port = int(port_path.read_text())
    out = {}
    for path in ("/metrics", "/debug/profile", "/debug/slo"):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
            out[path] = resp.read().decode()
    return out


def _plane_summary(scraped: dict) -> tuple[bool, dict]:
    """The run phase's operating plane from its scrapes: the wave segments
    and device_compute with the event-timed device ms beside it, mfu_decode
    with the peak it used, the flow gauges, the SLO engine's evaluations.
    ok: every record's segments (waves, packs, fused harvests) sum to its
    wall, they cover at least 95% of the waves' wall (all of them, and the
    warm ones, which carry the MFU decomposition), each wave's timed device
    span lies inside its wall, and no MFU share is above 1."""
    if not scraped:
        print("run: the child's metrics server never answered | ok=False", flush=True)
        return False, {}
    from k8s_llm_scheduler_tpu_torch.observability.profiler import SEGMENTS

    prof = json.loads(scraped["/debug/profile"])
    slo = json.loads(scraped["/debug/slo"])
    gauges = {}
    for line in scraped["/metrics"].splitlines():
        name, _, value = line.partition(" ")
        if name.endswith(("dispatches_per_decision", "prefill_tokens_per_decision")):
            gauges[name] = float(value)
    records = list(prof["ring"])
    for family in ("packs", "fused", "spec", "persistent"):
        records += (prof.get(family) or {}).get("ring", [])
    sums_ok = all(abs(sum(r["segments_ms"].values()) - r["wall_ms"]) <= 1e-6 * max(
        r["wall_ms"], 1.0) for r in records)
    # every wave's coverage, the cold ones (capture) included; the
    # snapshot's coverage_frac and mfu cover the warm ones
    wall = sum(r["wall_ms"] for r in prof["ring"])
    covered = sum(r["wall_ms"] - r["segments_ms"]["unattributed"] for r in prof["ring"])
    mfu = prof.get("mfu") or {}
    shares = [mfu.get("decode"), mfu.get("device"), mfu.get("busy_frac"),
              *(mfu.get("loss") or {}).values(), (prof.get("fused") or {}).get("mfu_decode")]
    shares = [x for x in shares if x is not None]
    rec = {
        "device_kind": prof["device_kind"], "peak_bf16_tflops": prof["peak_bf16_tflops"],
        "waves_profiled": prof["waves_profiled"],
        "warm_waves_in_window": prof["warm_waves_in_window"],
        "wall_ms_total": prof["wall_ms_total"],
        "segments_ms_total": prof["segments_ms_total"],
        "device_compute_ms_total": prof["device_compute_ms_total"],
        "device_event_ms_total": prof.get("device_event_ms_total"),
        "coverage_frac": prof["coverage_frac"],
        "coverage_frac_all_waves": covered / wall if wall > 0 else 0.0, "mfu": mfu,
        "achieved_tflops": prof["achieved_tflops"],
        "dispatches_per_decision": prof.get("dispatches_per_decision"),
        "prefill_tokens_per_decision": prof.get("prefill_tokens_per_decision"),
        "metrics_gauges": gauges,
        "packs_profiled": (prof.get("packs") or {}).get("packs_profiled", 0),
        "fused_profiled": (prof.get("fused") or {}).get("harvests_profiled", 0),
        "records": len(records), "segments_sum_to_wall": sums_ok,
        "slo_evaluations": slo["evaluations"], "slo_tripped": slo["tripped"],
        "wave_segments": [{"wall_ms": r["wall_ms"], "cold": r["cold_compile"],
                           "device_compute_ms": r["device_compute_ms"],
                           "device_event_ms": r.get("device_event_ms"),
                           **{k: r["segments_ms"][k] for k in SEGMENTS}} for r in prof["ring"]],
    }
    warm = rec["warm_waves_in_window"] > 0
    # the event-timed device span of a wave lies inside its wall
    events_ok = all(0 < r["device_event_ms"] <= r["wall_ms"]
                    for r in prof["ring"] if "device_event_ms" in r)
    ok = (sums_ok and events_ok and rec["waves_profiled"] > 0
          and rec["coverage_frac_all_waves"] >= 0.95
          and (not warm or (rec["coverage_frac"] >= 0.95 and bool(mfu)))
          and all(0 <= x <= 1 for x in shares) and rec["slo_evaluations"] > 0)
    print("run: profile " + json.dumps({k: rec[k] for k in (
        "segments_ms_total", "device_compute_ms_total", "device_event_ms_total",
        "wall_ms_total", "coverage_frac", "coverage_frac_all_waves",
        "mfu", "peak_bf16_tflops", "device_kind", "dispatches_per_decision",
        "prefill_tokens_per_decision", "metrics_gauges", "waves_profiled",
        "warm_waves_in_window", "packs_profiled", "fused_profiled", "segments_sum_to_wall",
        "slo_evaluations")}) + f" | {_smi()} | ok={ok}", flush=True)
    return ok, rec


def run_phase() -> tuple[bool, dict]:
    """`cli run` at full width on the card against the wire-level fake API
    server: the port's WireFakeK8s holding synthetic_nodes(RUN_NODES), a
    child process (`RUN_CHILD`, in a temporary directory, KUBECONFIG at a
    path that does not exist, the API server set with
    httpapi.set_active_config, LLM_MODEL=RUN_MODEL, the config's default
    temperature 0.3) that runs `cli.main(["run"])`; then RUN_PODS pending
    pods of RUN_SHAPES shapes created over the wire, and once they are
    bound RUN_SECOND_PODS more of new shapes. Once the fake shows
    every pod bound (deadline RUN_DEADLINE_S) the child gets SIGINT; it must
    exit 0 with the stats JSON. Fails unless every pod is bound to a node
    that is ready and feasible for it, no decision fell back or failed to
    parse, and K1 and K2 launched in the child."""
    from k8s_llm_scheduler_tpu_torch.cluster.interface import raw_pod_to_spec
    from k8s_llm_scheduler_tpu_torch.cluster.wire_fake import WireFakeK8s
    from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
    from k8s_llm_scheduler_tpu_torch.testing import pod_burst, synthetic_nodes

    nodes = synthetic_nodes(RUN_NODES)
    srv = WireFakeK8s()
    for n in nodes:
        srv.add_node(n.name, cpu=str(int(n.available_cpu_cores)),
                     memory=f"{int(n.available_memory_gb)}Gi", pods=str(n.max_pods),
                     labels=n.labels)
    first = pod_burst(RUN_PODS, distinct_shapes=RUN_SHAPES)
    n_shapes = RUN_SHAPES + RUN_SECOND_PODS
    second = [dataclasses.replace(p, name=f"second-pod-{i}") for i, p in enumerate(
        pod_burst(n_shapes, distinct_shapes=n_shapes)[RUN_SHAPES:])]
    pods = first + second
    rec: dict = {"model": RUN_MODEL, "nodes": RUN_NODES, "pods": len(pods),
                 "shapes": n_shapes}
    scraped: dict = {}
    with tempfile.TemporaryDirectory() as cwd:
        env = _child_env(KUBECONFIG=str(Path(cwd) / "no-kubeconfig"), LLM_MODEL=RUN_MODEL,
                         DURABILITY_JOURNAL_DIR=str(Path(cwd) / "journal"),
                         SMOKE_SLO_OBJECTIVES=json.dumps(RUN_SLO_OBJECTIVES), **RUN_PLANE_ENV)
        env.pop("KUBERNETES_SERVICE_HOST", None)
        t0 = time.perf_counter()
        child = subprocess.Popen([sys.executable, "-c", RUN_CHILD, srv.base_url], cwd=cwd,
                                 env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True)
        try:
            # the child's watch must be up before the pods arrive: it lists
            # the pods, then watches
            end = time.perf_counter() + RUN_DEADLINE_S
            while (child.poll() is None and time.perf_counter() < end
                   and not any("watch=true" in r for r in srv.request_log)):
                time.sleep(0.1)
            rec["start_s"] = time.perf_counter() - t0
            pending_at, bound_at = {}, {}
            for burst in (first, second):
                for pod in burst:
                    req = pod.container_requests[0]
                    srv.add_pod(pod.name, requests=dict(req), priority=pod.priority)
                    pending_at[pod.name] = time.perf_counter()
                while (child.poll() is None and time.perf_counter() < end
                       and len(bound_at) < len(pending_at)):
                    now = time.perf_counter()
                    for _, name, _node in list(srv.bindings):
                        bound_at.setdefault(name, now)
                    time.sleep(0.01)
            if child.poll() is None:
                time.sleep(1.5)  # an SLO evaluation and a sample after the last bind
                scraped = _scrape_plane(Path(cwd) / "metrics_port")
            if child.poll() is None:
                child.send_signal(signal.SIGINT)
            out, err = child.communicate(timeout=120)
        finally:
            if child.poll() is None:
                child.kill()
                child.communicate()
            srv.close()
    placed = {name: node for _, name, node in srv.bindings}
    # stdout: the stats JSON (indented), then the child's one-line report
    lines = out.strip().splitlines()
    try:
        report = json.loads(lines[-1])
        stats = json.loads("\n".join(lines[:-1]))
    except (ValueError, IndexError):
        report, stats = {}, {}
    node_by_name = {n.name: n for n in nodes}
    feasible = all(
        placed.get(p.name) in {n.name for n in feasible_nodes(raw_pod_to_spec(p), nodes)}
        and node_by_name[placed[p.name]].is_ready for p in pods if p.name in placed)
    harvests = report.get("harvests", [])
    waves = [h for h in harvests if h["rows"]]
    rec.update({
        "rc": child.returncode, "wall_s": time.perf_counter() - t0,
        "bound": len(placed), "feasible": feasible,
        "pending_to_bound_s": {name: bound_at[name] - pending_at[name] for name in bound_at},
        "launches": report.get("launches"), "peak_gib": report.get("peak_gib"),
        "temperature": report.get("temperature"),
        "parsed": len(report.get("parsed", [])),
        "unparsed": sum(not r["ok"] for r in report.get("parsed", [])),
        "waves": [{k: h[k] for k in ("rows", "R", "cold", "model_calls")} for h in waves],
        "wave_wall_s": [h["t"] - h["submitted"] for h in waves],
        "between_harvests_s": [b["t"] - a["t"] for a, b in zip(waves, waves[1:])],
        "llm_decisions": stats.get("llm_decisions"),
        "fallback_decisions": stats.get("fallback_decisions"),
        "client_fallbacks": (stats.get("client") or {}).get("fallback_decisions"),
        "total_scheduled": stats.get("total_scheduled"),
    })
    plane_ok, rec["plane"] = _plane_summary(scraped)
    times = sorted(rec["pending_to_bound_s"].values())
    ok = (child.returncode == 0 and len(placed) == len(pods) and feasible
          and rec["fallback_decisions"] == 0 and rec["client_fallbacks"] == 0
          and rec["parsed"] > 0 and rec["unparsed"] == 0
          and bool(rec["launches"]) and rec["launches"]["K1"] > 0
          and rec["launches"]["K2"] > 0 and plane_ok)
    for name in sorted(rec["pending_to_bound_s"], key=rec["pending_to_bound_s"].get):
        print(f"  run: {name} pending -> bound {rec['pending_to_bound_s'][name]:.3f} s "
              f"on {placed.get(name)}", flush=True)
    print(f"run: cli run ({RUN_MODEL}, temperature {rec['temperature']}) over HTTP bound "
          f"{len(placed)} of {len(pods)} pods ({n_shapes} shapes, two bursts) in "
          f"{len(waves)} waves {rec['waves']}; pending -> bound first "
          f"{times[0] if times else float('nan'):.3f} s, last "
          f"{times[-1] if times else float('nan'):.3f} s; between the waves' harvests "
          f"{rec['between_harvests_s']} s; {rec['llm_decisions']} LLM decisions, "
          f"{rec['unparsed']} unparsed, fallbacks {rec['fallback_decisions']}; K1 / K2 "
          f"launches {rec['launches']}; child peak {rec['peak_gib']} GiB, rc "
          f"{child.returncode}, started in {rec['start_s']:.1f} s | {_smi()} | ok={ok}",
          flush=True)
    if not ok:
        print(err[-6000:], file=sys.stderr, flush=True)
    return ok, rec


# ------------------------------------------------------- journal restart phase
JOURNAL_NODES = 4
JOURNAL_PODS = 8  # 4 created before the kill, 4 while the child is dead
JOURNAL_DEADLINE_S = 300.0
# `cli run` (the config's defaults, LLM_MODEL and the journal from the
# environment) against the wire fake at argv[1].
JOURNAL_CHILD = r"""
import sys
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch.cluster import httpapi
httpapi.set_active_config(sys.argv[1])
sys.exit(cli.main(["run"]))
"""


def journal_restart_phase() -> tuple[bool, dict]:
    """Crash and restart of `cli run` on one decision journal: a TINY child
    over the port's WireFakeK8s with durability.enabled (fsync "intent")
    is SIGKILLed once the first of JOURNAL_PODS // 2 pods is bound; the
    other half is created while it is dead; a second child restarts on the
    same journal (recovery, then the watch from the journaled
    resourceVersion) and gets SIGINT once every pod is bound. Fails unless
    each pod is bound exactly once to a ready node (one 201 a pod, and no
    binding refused as already bound: a pod decided twice would meet a
    409), the second child exits 0, and `cli journal fsck` exits 0 with the
    journal clean and no lifecycle open. A binding POST the SIGKILL tore
    mid-request reaches the fake without its body and gets no answer; the
    binding POSTs the fake logged are reported beside the answers."""
    from collections import Counter

    from k8s_llm_scheduler_tpu_torch.cluster.wire_fake import WireFakeK8s
    from k8s_llm_scheduler_tpu_torch.testing import pod_burst, synthetic_nodes

    nodes = synthetic_nodes(JOURNAL_NODES)
    srv = WireFakeK8s()
    for n in nodes:
        srv.add_node(n.name, cpu=str(int(n.available_cpu_cores)),
                     memory=f"{int(n.available_memory_gb)}Gi", pods=str(n.max_pods),
                     labels=n.labels)
    answers = []  # the status code of every answered binding POST
    send = srv._send_json

    def answered(handler, code, obj):
        if handler.command == "POST" and handler.path.endswith("/bindings"):
            answers.append(code)
        send(handler, code, obj)

    srv._send_json = answered
    pods = pod_burst(JOURNAL_PODS, distinct_shapes=JOURNAL_PODS)
    half = JOURNAL_PODS // 2
    rec: dict = {"model": "tiny", "nodes": JOURNAL_NODES, "pods": JOURNAL_PODS}
    t0 = time.perf_counter()
    end = t0 + JOURNAL_DEADLINE_S
    with tempfile.TemporaryDirectory() as cwd:
        journal = Path(cwd) / "journal"
        env = _child_env(KUBECONFIG=str(Path(cwd) / "no-kubeconfig"), LLM_MODEL="tiny",
                         DURABILITY_ENABLED="true", DURABILITY_JOURNAL_DIR=str(journal))
        env.pop("KUBERNETES_SERVICE_HOST", None)
        logs = [Path(cwd) / "first.log", Path(cwd) / "second.log"]

        def start(log):
            with open(log, "w") as fh:
                return subprocess.Popen([sys.executable, "-c", JOURNAL_CHILD, srv.base_url],
                                        cwd=cwd, env=env, stdout=fh, stderr=subprocess.STDOUT)

        def wait(child, done):
            while child.poll() is None and time.perf_counter() < end and not done():
                time.sleep(0.01)

        def add(burst):
            for pod in burst:
                srv.add_pod(pod.name, requests=dict(pod.container_requests[0]),
                            priority=pod.priority)

        child = start(logs[0])
        try:
            wait(child, lambda: any("watch=true" in r for r in srv.request_log))
            add(pods[:half])
            wait(child, lambda: len(srv.bindings) >= 1)
            child.kill()  # SIGKILL: no shutdown path runs
            child.wait(timeout=60)
            rec["bound_at_kill"] = len(srv.bindings)
            add(pods[half:])
            n_log = len(srv.request_log)
            child = start(logs[1])
            wait(child, lambda: len(srv.bindings) >= len(pods))
            if child.poll() is None:
                child.send_signal(signal.SIGINT)
            child.wait(timeout=120)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        fsck = subprocess.run(
            [sys.executable, "-m", "k8s_llm_scheduler_tpu_torch.cli", "journal", "fsck",
             "--dir", str(journal)], cwd=cwd, env=env, capture_output=True, text=True,
            timeout=120)
        second_log = logs[1].read_text()
    srv.close()
    posts = sum(r.startswith("POST ") and r.endswith("/bindings") for r in srv.request_log)
    per_pod = Counter(name for _, name, _ in srv.bindings)
    try:
        report = json.loads(fsck.stdout)
    except ValueError:
        report = {}
    recovery = next((ln[ln.index("journal recovery:"):] for ln in second_log.splitlines()
                     if "journal recovery:" in ln), None)
    resumed = [r for r in srv.request_log[n_log:] if "watch=true" in r
               and "resourceVersion=" in r and "/pods" in r]
    ready = {n.name for n in nodes if n.is_ready}
    rec.update({
        "wall_s": time.perf_counter() - t0, "rc": child.returncode,
        "bound": len(per_pod), "binding_posts": posts,
        "binding_answers": dict(sorted(Counter(answers).items())),
        "bound_more_than_once": sorted(p for p, c in per_pod.items() if c > 1),
        "on_ready_nodes": all(node in ready for _, _, node in srv.bindings),
        "recovery": recovery, "watch_resumed_from_rv": bool(resumed),
        "fsck_rc": fsck.returncode, "fsck": {k: report.get(k) for k in (
            "ok", "torn_bytes", "open_decisions", "open_intents", "acked", "last_rv")},
    })
    ok = (rec["rc"] == 0 and rec["bound"] == len(pods)
          and rec["binding_answers"] == {201: len(pods)}
          and not rec["bound_more_than_once"] and rec["on_ready_nodes"]
          and recovery is not None and fsck.returncode == 0 and report.get("ok") is True
          and report.get("open_decisions") == 0 and report.get("open_intents") == 0
          and report.get("acked") == len(pods))
    print(f"journal restart: {json.dumps(rec)} | {_smi()} | ok={ok}", flush=True)
    if not ok:
        print(second_log[-6000:], fsck.stdout[-2000:], fsck.stderr[-2000:],
              file=sys.stderr, flush=True)
    return ok, rec


# --------------------------------------------------------------- sampled phase
SAMPLED_TEMPERATURE = 0.3  # the config's llm.temperature


def sampled_phase() -> tuple[bool, dict]:
    """Sampled decisions replayed as CUDA graphs: a TINY engine on the card
    (graphs on, temperature 0.3, the decision grammar over 4 nodes) runs a
    wave of 8 copies of one prompt to capture its geometry, then two more:
    the 16 replayed streams must not all be equal (the generator
    registered with the graphs draws afresh at every replay), and each
    must parse and name one of the nodes."""
    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes
    from k8s_llm_scheduler_tpu_torch.utils.json_extract import parse_decision_json

    nodes = synthetic_nodes(4)
    backend = build_local_backend("tiny", device="cuda", temperature=SAMPLED_TEMPERATURE,
                                  request_timeout_s=600.0, prewarm_idle_delay_s=NO_PREWARM_S)
    try:
        eng = backend.engine
        item = backend._prepare_item(fixture_pods(1)[0], nodes)
        backend._switch_group(item)
        prompts = [item.suffix_ids] * eng.max_slots
        eng.decide_wave(prompts, backend.max_new_tokens)  # captures the geometry
        replays0 = eng._graphs.replays
        streams = [f.token_ids for _ in range(2)
                   for f in eng.decide_wave(prompts, backend.max_new_tokens)]
        replayed = eng._graphs.replays - replays0
        texts = [eng.tokenizer.decode(ids) for ids in streams]
    finally:
        backend.close()
    names = {n.name for n in nodes}
    parsed = [parse_decision_json(t) for t in texts]
    valid = all(p is not None and p["selected_node"] in names for p in parsed)
    distinct = len({tuple(ids) for ids in streams})
    rec = {"streams": len(streams), "distinct": distinct, "valid": valid,
           "replays": replayed,
           "nodes": sorted({p["selected_node"] for p in parsed if p is not None})}
    ok = valid and distinct > 1 and replayed > 0
    print(f"sampled: TINY at temperature {SAMPLED_TEMPERATURE}, graphs: {distinct} distinct of "
          f"{len(streams)} replayed streams of one prompt ({replayed} replays), all parse to "
          f"a node={valid}, nodes {rec['nodes']} | {_smi()} | ok={ok}", flush=True)
    return ok, rec


# ------------------------------------------------------------ checkpoint phase
def _write_safetensors(path: Path, tensors: dict) -> None:
    """A safetensors file in the format's own few lines: 8-byte header
    length, JSON header, raw little-endian bytes."""
    import torch

    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.contiguous().cpu()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        dtype = {torch.bfloat16: "BF16", torch.float32: "F32"}[t.dtype]
        header[name] = {"dtype": dtype, "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def _tiny_hf_tensors(cfg, seed=0) -> dict:
    """A TINY HF-layout checkpoint ([out, in] projections) from a seed."""
    import torch

    g = torch.Generator().manual_seed(seed)
    hd, D, F = cfg.head_dim, cfg.d_model, cfg.d_ff

    def w(*shape, scale):
        return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16)

    out = {"model.embed_tokens.weight": w(cfg.vocab_size, D, scale=0.02),
           "model.norm.weight": (1 + w(D, scale=0.1).float()).to(torch.bfloat16)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        out.update({
            p + "input_layernorm.weight": (1 + w(D, scale=0.1).float()).to(torch.bfloat16),
            p + "self_attn.q_proj.weight": w(cfg.n_heads * hd, D, scale=D ** -0.5),
            p + "self_attn.k_proj.weight": w(cfg.n_kv_heads * hd, D, scale=D ** -0.5),
            p + "self_attn.v_proj.weight": w(cfg.n_kv_heads * hd, D, scale=D ** -0.5),
            p + "self_attn.o_proj.weight": w(D, cfg.n_heads * hd, scale=D ** -0.5),
            p + "post_attention_layernorm.weight": (1 + w(D, scale=0.1).float()).to(
                torch.bfloat16),
            p + "mlp.gate_proj.weight": w(F, D, scale=D ** -0.5),
            p + "mlp.up_proj.weight": w(F, D, scale=D ** -0.5),
            p + "mlp.down_proj.weight": w(D, F, scale=F ** -0.5),
        })
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = w(cfg.vocab_size, D, scale=D ** -0.5)
    return out


def checkpoint_phase() -> tuple[bool, dict]:
    """A TINY HF safetensors checkpoint from a seed (written by
    _write_safetensors; vocab widened for the builtin numeric tokenizer)
    loaded by build_local_backend(checkpoint_path=...) on the card and on
    the CPU, bf16 and int8: a suffix prefill's logits on the card within
    5e-2 of the largest logit of the same checkpoint loaded on the CPU,
    and one greedy decision on the card that parses and names a feasible
    node."""
    import torch

    from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import build_builtin_tokenizer
    from k8s_llm_scheduler_tpu_torch.models.configs import TINY
    from k8s_llm_scheduler_tpu_torch.models.llama import forward_prefill_suffix_dense
    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes
    from k8s_llm_scheduler_tpu_torch.types import DecisionSource

    _, cfg = build_builtin_tokenizer("numeric", TINY)
    nodes = synthetic_nodes(4)
    pod = fixture_pods(1)[0]
    rec, ok = {"vocab": cfg.vocab_size}, True
    with tempfile.TemporaryDirectory() as d:
        _write_safetensors(Path(d) / "model.safetensors", _tiny_hf_tensors(cfg))
        for quant in (None, "int8"):
            logits, t_load = {}, {}
            for dev in ("cuda", "cpu"):
                t0 = time.perf_counter()
                b = build_local_backend("tiny", device=dev, checkpoint_path=d,
                                        tokenizer_name="numeric", quantize=quant,
                                        temperature=0.0, request_timeout_s=600.0)
                t_load[dev] = time.perf_counter() - t0
                try:
                    eng = b.engine
                    item = b._prepare_item(pod, nodes)
                    eng.set_prefix(item.prefix_ids)
                    toks = torch.tensor([item.suffix_ids], dtype=torch.int32, device=dev)
                    lg, _, _ = forward_prefill_suffix_dense(
                        eng.params, eng.cfg, toks,
                        torch.tensor([len(item.suffix_ids)], dtype=torch.int32, device=dev),
                        eng._prefix.k, eng._prefix.v,
                        torch.tensor(eng.prefix_len, dtype=torch.int32, device=dev))
                    logits[dev] = lg.float().cpu()
                    if dev == "cuda":
                        decision = b.get_scheduling_decision(pod, nodes)
                finally:
                    b.close()
            err = (logits["cuda"] - logits["cpu"]).abs().max().item()
            scale = logits["cpu"].abs().max().item()
            names = {n.name for n in feasible_nodes(pod, nodes)}
            good = (bool(torch.isfinite(logits["cuda"]).all()) and err <= 5e-2 * scale
                    and decision.source == DecisionSource.LLM
                    and decision.selected_node in names)
            key = quant or "bf16"
            rec[key] = {"max_abs_err": err, "max_logit": scale, "load_s": t_load,
                        "decision": decision.selected_node, "ok": good}
            ok = ok and good
            print(f"checkpoint: TINY safetensors ({key}, vocab {cfg.vocab_size}, numeric "
                  f"tokenizer) loaded in {t_load['cuda']:.2f} s on the card; suffix prefill "
                  f"logits vs the CPU load err={err:.4g} (max |logit| {scale:.4g}); greedy "
                  f"decision {decision.selected_node} | {_smi()} | ok={good}", flush=True)
    return ok, rec


def _timed_phase(name, fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the full record to this JSON file")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        from k8s_llm_scheduler_tpu_torch.ops import kernels
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2

    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    reports = kernels.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {len(reports)} libraries in {build_s:.1f} s", flush=True)
    print_ptxas(reports)

    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes

    v_ok, verify = _timed_phase("cli verify", verify_phase)
    # no other 8B model is resident on the card while cli run's child holds one
    run_ok, run = _timed_phase("cli run", run_phase)
    nodes = synthetic_nodes(32)
    pods = fixture_pods(8)
    backend, backend_s = build_backend()
    try:
        k1_cases, k2_cases = path_shapes(backend, nodes, pods, N_SINGLES)
        k_ok, k1, k2 = _timed_phase("kernels", kernel_phase, k1_cases, k2_cases)
        r_ok, ref = _timed_phase("reference", reference_phase)
        d_ok, dec = _timed_phase("decision", decision_phase, backend, backend_s, nodes, pods)
        adm_ok, adm = _timed_phase("admission", admission_phase, backend.engine, nodes, pods,
                                   dec["batch_tokens"])
        l_ok, loop = _timed_phase("loop", loop_phase, backend.engine)
        c_ok, demo = _timed_phase("cli demo", demo_phase)
        a_ok, path_a, totals = _timed_phase("path A", path_a_phase, backend, nodes, pods)
        torch.cuda.empty_cache()
        b_ok, path_b, k4_cases = _timed_phase("path B", path_b_phase, backend, nodes, pods)
        f_ok, fused = _timed_phase("fused", fused_phase, backend, nodes, pods, path_b)
        p8_ok, pers8 = _timed_phase("persistent 8B", persistent_8b, backend, nodes, pods)
        sp_ok, spec = _timed_phase("spec", spec_phase, backend, nodes, pods)
        k1 += spec["k1_cases"]
        cfg = backend.engine.cfg
    finally:
        backend.close()
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    # cli complete's child builds its own 8B model; the TINY phases run
    # beside it, the timed kernel phases after it
    complete_child = start_complete()
    ck_ok, ckpt = _timed_phase("checkpoint", checkpoint_phase)
    s_ok, sampled = _timed_phase("sampled", sampled_phase)
    pt_ok, pers_tiny = _timed_phase("persistent TINY", persistent_tiny)
    jr_ok, journal_restart = _timed_phase("journal restart", journal_restart_phase)
    cc_ok, complete = _timed_phase("cli complete", finish_complete, complete_child)
    k3_ok, k3 = _timed_phase("K3", k3_phase, cfg, totals)
    k4_ok, k4 = _timed_phase("K4", k4_phase, k4_cases, long_cases=[k4_long_case()])

    def entry(name, recs, source, replaces, launches, main, **extra):
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": main["shape"],
            **extra,
            "shapes": recs,
        }

    def widest_suffix_prefill(recs):
        # K1/K2 headline: the batch's suffix prefill, the widest wave call
        return max((r for r in recs if r["step"] == "suffix prefill"),
                   key=lambda r: r["flops"])

    # K3 headline: int8 w_gate at R=8 and the batch's median total; K4:
    # partials at the step shape after one chunk, beside the long shape
    k3_main = next((r for r in k3 if r["int8"] and r["weight"] == "w_gate"
                    and r["step"] == "R=8" and r.get("median_total")),
                   max((r for r in k3 if "ms" in r), key=lambda r: r["flops"]))
    k1_main = widest_suffix_prefill(k1)
    k2_main = widest_suffix_prefill(k2)
    k4_main = next(r for r in k4 if r["mode"] == "parts"
                   and r["step"] == "step after one chunk")
    k4_long = next(r for r in k4 if r["step"] == K4_LONG[0])
    line = {
        "kernels": [
            entry("flash_prefix_attention_parts", k1,
                  "k8s_llm_scheduler_tpu_torch/csrc/prefix_attention.cu",
                  "k8s_llm_scheduler_tpu/ops/pallas_prefix_attention.py:365",
                  dec["launches"]["K1"], k1_main, ms_hot=k1_main["ms_hot"],
                  library_ms_hot=k1_main["library_ms_hot"], cold_l2=True,
                  launches_by_step=dec["k1_launches_by_step"],
                  loop_launches=loop["launches"]["K1"],
                  run_launches=(run["launches"] or {}).get("K1"),
                  complete_launches=(complete.get("launches") or {}).get("K1"),
                  persistent_launches=(pers8.get("launches") or {}).get("K1"),
                  spec_launches=spec["k1_spec_launches"],
                  spec_verify={r["shape"]: {k: r.get(k) for k in (
                      "ms", "ms_hot", "plain_ms", "bound_ms", "library_ms", "bound_share")}
                      for r in spec["k1_cases"]},
                  pack_chunk={k: v for k, v in next(
                      r for r in k1 if r["step"] == "pack chunk").items() if k in (
                      "shape", "ms", "ms_hot", "plain_ms", "bound_ms", "library_ms")},
                  pack_chunk_launches=adm["packed_batch"]["pack_chunk_k1"]),
            entry("flash_causal_attention_parts", k2,
                  "k8s_llm_scheduler_tpu_torch/csrc/causal_attention.cu",
                  "k8s_llm_scheduler_tpu/ops/pallas_prefix_attention.py:285",
                  dec["launches"]["K2"], k2_main, ms_cold=k2_main["ms_cold"],
                  ratio=k2_main["ratio"], loop_launches=loop["launches"]["K2"],
                  run_launches=(run["launches"] or {}).get("K2"),
                  complete_launches=(complete.get("launches") or {}).get("K2"),
                  persistent_launches=(pers8.get("launches") or {}).get("K2")),
            entry("ragged_matmul", k3,
                  "k8s_llm_scheduler_tpu_torch/csrc/ragged_matmul.cu",
                  "k8s_llm_scheduler_tpu/ops/ragged_matmul.py:108",
                  path_a["launches"]["K3"], k3_main, ms_hot=k3_main["ms_hot"],
                  library_ms_hot=k3_main["library_ms_hot"], cold_l2=True),
            entry("paged_decode_attention", k4,
                  "k8s_llm_scheduler_tpu_torch/csrc/paged_attention.cu",
                  "k8s_llm_scheduler_tpu/ops/pallas_paged_attention.py:276",
                  path_b["launches"]["K4"], k4_main, status="redesigned PR 7",
                  fused_launches=fused["launches"]["K4"],
                  ms_hot=k4_main["ms_hot"], library_ms_hot=k4_main["library_ms_hot"],
                  cold_l2=True, splits=k4_main.get("splits"),
                  long={k: k4_long[k] for k in ("shape", "ms", "bound_ms", "library_ms",
                                                "splits") if k in k4_long}),
        ],
        "not_ported": [],
    }
    phases = {"cli_verify": v_ok, "cli_run": run_ok, "kernels": k_ok, "reference": r_ok,
              "decision": d_ok, "admission": adm_ok, "loop": l_ok, "cli_demo": c_ok,
              "path_a": a_ok, "path_b": b_ok, "fused": f_ok, "persistent_8b": p8_ok,
              "spec": sp_ok,
              "checkpoint": ck_ok, "sampled": s_ok, "persistent_tiny": pt_ok,
              "journal_restart": jr_ok, "cli_complete": cc_ok, "k3": k3_ok, "k4": k4_ok}
    record = {"device": kind, "smi": smi, "build_s": build_s, "kernels": line,
              "cli_verify": verify, "cli_run": run, "reference": ref, "decision": dec,
              "admission": adm, "loop": loop, "cli_demo": demo, "path_a": path_a,
              "path_b": path_b, "fused": fused, "persistent_8b": pers8, "spec": spec,
              "checkpoint": ckpt, "sampled": sampled, "persistent_tiny": pers_tiny,
              "journal_restart": journal_restart, "cli_complete": complete,
              "phases_ok": phases}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    if not all(phases.values()):
        print(f"chip_smoke: FAILED phases {record['phases_ok']}", file=sys.stderr)
        return 1
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
