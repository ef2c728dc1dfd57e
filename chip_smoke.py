#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--out FILE.json]

Run from the root of the repository. It fails (non-zero exit, no result
line) when no CUDA device is visible or the port is not beside it.

Phases, each of which must pass:

1. Build: compiles the four hand-written CUDA kernels from
   k8s_llm_scheduler_tpu_torch/csrc (one nvcc per source, in parallel).
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
   (random bf16 weights from a seed; built before phase 2, whose shapes it
   gives) serves 4 single decisions and a batch
   of 8 for a 32-node synthetic cluster (a 5,488-token prefix: the chunked
   prefix prefill). Every decision must parse, name a feasible node and
   carry a confidence in [0, 1]; K1 and K2 must have launched on this run
   (every count is zeroed just before it). K1's launches are also counted
   by step (prefix chunks, suffix prefills, block decodes), around each of
   the engine's model calls, and must add up to its total.
5. Path A: the same 8B weights quantized to int8 on the card, in an engine
   with decode_matmul="ragged", serve single decisions and a batch of 8 on
   the same cluster; all feasible, K3 and K1 launched. The valid tokens of
   every block-decode call are recorded for phase 7.
6. Path B: the bf16 8B weights in an engine with paged_attn="pallas",
   max_slots 8, pages of 64: the cluster prefix installed, 8 suffixes
   admitted (unconstrained, greedy, 64 new tokens), step() until all
   finish, then one generate(). Every request finishes with 1-64 tokens,
   K4 launched, and every page is returned.
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
8. K4 at the shapes of path B's step, taken from its engine (its page
   geometry, its page tables padded with the trash row, its own-token
   lengths with the trash row's negative one), both modes, held like K1/K2
   (empty rows exactly m = -1e30, l = 0, o = 0). Library yardstick: SDPA on
   KV gathered beforehand (the gather is not timed).

The last lines are a JSON object with per-kernel numbers, the card's name
and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import itertools
import json
import statistics
import subprocess
import sys
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
    for the Hopper kernels K1 (prefix_attention), K2 (causal_attention) and
    K3 (ragged_matmul) every line (shared memory, warnings, wgmma
    serialization notes)."""
    for name, log in reports.items():
        for line in log.splitlines():
            low = line.lower()
            full = name in ("prefix_attention", "causal_attention", "ragged_matmul") and (
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
    its suffix prefill and its block decode. Each K1 case is
    (step, B, S, Sp, prefix_len) and each K2 case (step, B, S, lens);
    repeats are dropped."""
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
def _k4_case(gen, step, q_shape, pages_shape, tables, lens, normalize):
    import torch
    import torch.nn.functional as F
    from k8s_llm_scheduler_tpu_torch.ops import paged_attention as pg
    from k8s_llm_scheduler_tpu_torch.ops.attention import gather_pages

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
    want = plain(q, kc, vc, tables, lens)
    torch.cuda.synchronize()
    valid = (lens > 0)[:, None].expand(B, H)
    if normalize:
        vr = valid
        if vr.any():
            ref = want[vr].float()
            rms = ref.square().mean().sqrt().item()
            err = (got[vr].float() - ref).abs().max().item()
        else:
            rms = err = 0.0
        dead_ok = bool((got[~vr] == 0).all())
        ok = err <= TOL_O_RMS * rms and dead_ok and bool(torch.isfinite(got.float()).all())
        rec = {"max_abs_err": err, "ref_rms": rms, "masked_rows_exact": dead_ok}
    else:
        vr = valid.reshape(B, n_kv, H // n_kv)
        # the partials carry no S axis: add one for the shared comparison
        ok, rec = _compare(
            tuple(t.unsqueeze(-2) if t.dim() == 4 else t.unsqueeze(-1) for t in got),
            tuple(t.unsqueeze(-2) if t.dim() == 4 else t.unsqueeze(-1) for t in want),
            vr.unsqueeze(-1),
        )
        dead = ~vr
        ok = ok and bool((got[0][dead] == 0).all())
    n_tok = int(lens.clamp(min=0).sum())
    n_pages = sum(-(-max(int(n), 0) // ps) for n in lens.tolist())
    out_bytes = B * H * hd * 2 if normalize else B * H * hd * 4 + 2 * B * H * 4
    nbytes = (B * H * hd * 2 + 2 * n_tok * n_kv * hd * 2 + 4 * n_pages + 4 * B
              + out_bytes)
    rec.update(
        step=step, mode="normalized" if normalize else "parts", ok=ok,
        shape=(f"q[{B},{H},{hd}] pages{list(pages_shape)} tables{list(tables.shape)} "
               f"lens={lens.tolist()}"),
        ms=_time_ms(lambda: kernel(q, kc, vc, tables, lens), 20),
        plain_ms=_time_ms(lambda: plain(q, kc, vc, tables, lens), 5),
        **_bound(4.0 * n_tok * H * hd, nbytes, PEAK_F32_FLOPS),
    )
    # yardstick: SDPA on the KV gathered beforehand (the gather is untimed)
    span = -(-max(int(lens.max()), 1) // ps) * ps
    kg = gather_pages(kc, tables)[:, :span].transpose(1, 2)
    vg = gather_pages(vc, tables)[:, :span].transpose(1, 2)
    mask = (torch.arange(span, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    qt = q[:, :, None, :]
    rec["library_ms"] = _library_ms(
        lambda: F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask, enable_gqa=True)
    )
    rec["library_note"] = "SDPA on KV gathered beforehand; the gather is not timed"
    return ok, rec


def k4_phase(cases) -> tuple[bool, list[dict]]:
    import torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    recs = []
    for step, q_shape, pages_shape, tables, lens in cases:
        for normalize in (False, True):
            ok, rec = _k4_case(gen, step, q_shape, pages_shape, tables, lens, normalize)
            recs.append(rec)
            print(f"K4 {rec['mode']} {step} {rec['shape']}: ok={ok} "
                  f"err={rec['max_abs_err']:.3g} (rms {rec['ref_rms']:.3g}) "
                  f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                  f"bound_ms={rec['bound_ms']:.4f} library_ms={rec['library_ms']}",
                  flush=True)
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
def k1_launches_by_step(engine):
    """Measures K1's launches by step of the decision path: the engine's
    chunked prefix prefill, the waves' suffix prefills and their block
    decodes are wrapped to read K1's count before and after each call (an
    inner wrapped call inside an outer one counts for the outer). A wave's
    steps are keyed by its row count R (the rows of the call's tokens).
    Yields the dict of counts, filled as the calls run; the wrappers go on
    exit."""
    from k8s_llm_scheduler_tpu_torch.engine import engine as eng_mod
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

    counts: dict[str, int] = {}
    depth = [0]

    def counted(step, fn, by_rows):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            n0 = pa.flash_prefix_attention_parts.launches
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    # (params, cfg, tokens [R, ...], ...)
                    key = f"{step} R={args[2].shape[0]}" if by_rows else step
                    counts[key] = (counts.get(key, 0)
                                   + pa.flash_prefix_attention_parts.launches - n0)
        return call

    saved = {name: getattr(eng_mod, name)
             for name in ("forward_prefill_suffix_dense", "forward_block_decode")}
    eng_mod.forward_prefill_suffix_dense = counted(
        "suffix prefill", saved["forward_prefill_suffix_dense"], True)
    eng_mod.forward_block_decode = counted(
        "block decode", saved["forward_block_decode"], True)
    engine._prefill_prefix_chunked = counted(
        "prefix chunk", engine._prefill_prefix_chunked, False)
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(eng_mod, name, fn)
        del engine._prefill_prefix_chunked


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
    backend = build_local_backend(
        "llama-3.1-8b-instruct", device="cuda", seed=0, request_timeout_s=600.0
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"decision: 8B backend built in {build_s:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    return backend, build_s


def decision_phase(backend, build_s, nodes, pods) -> tuple[bool, dict]:
    import torch
    from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes

    decisions = []
    torch.cuda.reset_peak_memory_stats()
    with k1_launches_by_step(backend.engine) as by_step:
        _zero_launch_counts()
        t_main = time.perf_counter()
        singles = []
        for pod in pods[:N_SINGLES]:
            t = time.perf_counter()
            d = backend.get_scheduling_decision(pod, nodes)
            singles.append((time.perf_counter() - t) * 1000.0)
            decisions.append((pod, d))
        t = time.perf_counter()
        batch = backend.get_scheduling_decisions_batch(pods, nodes)
        batch_ms = (time.perf_counter() - t) * 1000.0
        main_s = time.perf_counter() - t_main
        launches = _launch_counts()
    stats = backend.get_stats()
    for pod, d in zip(pods, batch):
        if isinstance(d, Exception):
            raise d
        decisions.append((pod, d))
    ok = True
    for pod, d in decisions:
        names = {n.name for n in feasible_nodes(pod, nodes)}
        good = d.selected_node in names and 0.0 <= d.confidence <= 1.0
        ok = ok and good
        print(f"  {pod.name}: {d.selected_node} conf={d.confidence} "
              f"reasoning_len={len(d.reasoning)} ok={good}", flush=True)
    n = len(decisions)
    rec = {
        "model": "llama-3.1-8b-instruct",
        "nodes": len(nodes),
        "decisions": n,
        "launches": launches,
        "launches_per_decision": {k: v / n for k, v in launches.items()},
        "single_decision_ms": singles,
        "batch_of_8_ms": batch_ms,
        "decisions_per_s_batch": 8 / (batch_ms / 1000.0),
        "decisions_per_s_all": n / main_s,
        "prefix_prefill_ms": stats["prefix_prefill_ms"],
        "prefix_tokens_prefilled": stats["prefill_tokens"],
        "wave_ms_total": stats["wave_ms"],
        "waves": stats["waves"],
        "wave_model_calls": stats["wave_model_calls"],
        "backend_build_s": build_s,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    # measured by step; every K1 launch of the run falls in one of them
    rec["k1_launches_by_step"] = dict(by_step)
    ok = (ok and launches["K1"] > 0 and launches["K2"] > 0
          and sum(by_step.values()) == launches["K1"])
    print("decision: " + json.dumps(rec), flush=True)
    return ok, rec


def _serve(backend, nodes, pods, n_singles):
    """n_singles single decisions, then the batch; (singles ms, batch ms,
    [(pod, decision)], valid tokens of each block call by row bucket R)."""
    eng = backend.engine
    eng.block_tokens.clear()
    out, singles = [], []
    for pod in pods[:n_singles]:
        t = time.perf_counter()
        out.append((pod, backend.get_scheduling_decision(pod, nodes)))
        singles.append((time.perf_counter() - t) * 1000.0)
    totals = {eng.max_slots // 2: list(eng.block_tokens)}
    eng.block_tokens.clear()
    t = time.perf_counter()
    batch = backend.get_scheduling_decisions_batch(pods, nodes)
    batch_ms = (time.perf_counter() - t) * 1000.0
    totals[eng.max_slots] = list(eng.block_tokens)
    for pod, d in zip(pods, batch):
        if isinstance(d, Exception):
            raise d
        out.append((pod, d))
    return singles, batch_ms, out, totals


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
    ragged block-decode matmuls (K3) on the decision path."""
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
    engine = InferenceEngine(params, cfg, ByteTokenizer(), temperature=0.0,
                             decode_matmul="ragged")
    b = LocalLLMBackend(engine, request_timeout_s=600.0)
    try:
        _zero_launch_counts()
        singles, batch_ms, decisions, totals = _serve(b, nodes, pods, N_SINGLES)
        launches = _launch_counts()
        stats = b.get_stats()
    finally:
        b.close()
    ok = _feasible(nodes, decisions) and launches["K3"] > 0 and launches["K1"] > 0
    n = len(decisions)
    rec = {
        "model": "llama-3.1-8b-instruct int8 weight-only, decode_matmul=ragged",
        "quantize_s": quant_s,
        "int8_param_gib": param_bytes(params) / 2**30,
        "decisions": n,
        "launches": launches,
        "launches_per_decision": {k: v / n for k, v in launches.items()},
        "single_decision_ms": singles,
        "batch_of_8_ms": batch_ms,
        "decisions_per_s_batch": 8 / (batch_ms / 1000.0),
        "wave_model_calls": stats["wave_model_calls"],
        "waves": stats["waves"],
        "wave_ms_total": stats["wave_ms"],
        "block_tokens": {str(r): t for r, t in totals.items()},
    }
    print("path A: " + json.dumps({k: v for k, v in rec.items() if k != "block_tokens"}),
          flush=True)
    return ok, rec, totals


def path_b_phase(backend, nodes, pods):
    """General completion on the bf16 8B params: set_prefix, add_requests,
    step() to completion, then generate(), own-token attention through K4."""
    import torch
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer

    cfg = backend.engine.cfg
    eng = InferenceEngine(backend.engine.params, cfg, ByteTokenizer(), temperature=0.0,
                          paged_attn="pallas", max_slots=8, page_size=64)
    items = [backend._prepare_item(p, nodes) for p in pods]
    suffixes = [it.suffix_ids for it in items]
    eng.set_prefix(items[0].prefix_ids)
    pages0 = eng.kv.pages_free
    torch.cuda.synchronize()
    _zero_launch_counts()
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
    launches = _launch_counts()
    pages_end = eng.kv.pages_free
    done = {f.req_id: len(f.token_ids) for f in fins}
    ok = (sorted(done) == sorted(ids)
          and all(1 <= n <= PATH_B_NEW_TOKENS for n in done.values())
          and 1 <= len(gen.token_ids) <= PATH_B_NEW_TOKENS
          and launches["K4"] > 0 and pages_end == pages0)
    n_tok = sum(done.values())
    steps = chunks_batch * eng.chunk_steps
    rec = {
        "model": "llama-3.1-8b-instruct bf16, paged_attn=pallas",
        "prefix_tokens": plen,
        "suffix_tokens": [len(sfx) for sfx in suffixes],
        "requests": len(ids),
        "tokens_per_request": [done[i] for i in ids],
        "batch_wall_s": batch_s,
        "batch_tokens_per_s": n_tok / batch_s,
        "chunks": chunks_batch,
        "ms_per_decode_step": batch_s * 1000.0 / steps,
        "generate_tokens": len(gen.token_ids),
        "generate_wall_s": gen_s,
        "generate_tokens_per_s": len(gen.token_ids) / gen_s,
        "launches": launches,
        "launches_per_decode_step": launches["K4"] / (eng.stats["chunks"] * eng.chunk_steps),
        "pages_free_start": pages0,
        "pages_free_end": pages_end,
        "ok": ok,
    }
    print("path B: " + json.dumps(rec), flush=True)
    q_shape = (eng.max_slots + 1, cfg.n_heads, cfg.head_dim)
    pages_shape = tuple(eng.kv.k.shape[1:])
    cases = [(step, q_shape, pages_shape, t.cpu(), l.cpu()) for step, t, l in shapes]
    return ok, rec, cases


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

    nodes = synthetic_nodes(32)
    pods = fixture_pods(8)
    backend, backend_s = build_backend()
    try:
        k1_cases, k2_cases = path_shapes(backend, nodes, pods, N_SINGLES)
        k_ok, k1, k2 = kernel_phase(k1_cases, k2_cases)
        r_ok, ref = reference_phase()
        d_ok, dec = decision_phase(backend, backend_s, nodes, pods)
        a_ok, path_a, totals = path_a_phase(backend, nodes, pods)
        torch.cuda.empty_cache()
        b_ok, path_b, k4_cases = path_b_phase(backend, nodes, pods)
        cfg = backend.engine.cfg
    finally:
        backend.close()
    del backend
    torch.cuda.empty_cache()
    k3_ok, k3 = k3_phase(cfg, totals)
    k4_ok, k4 = k4_phase(k4_cases)

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
    # partials at the step shape after one chunk
    k3_main = next((r for r in k3 if r["int8"] and r["weight"] == "w_gate"
                    and r["step"] == "R=8" and r.get("median_total")),
                   max((r for r in k3 if "ms" in r), key=lambda r: r["flops"]))
    k1_main = widest_suffix_prefill(k1)
    k2_main = widest_suffix_prefill(k2)
    k4_main = next(r for r in k4 if r["mode"] == "parts"
                   and r["step"] == "step after one chunk")
    line = {
        "kernels": [
            entry("flash_prefix_attention_parts", k1,
                  "k8s_llm_scheduler_tpu_torch/csrc/prefix_attention.cu",
                  "k8s_llm_scheduler_tpu/ops/pallas_prefix_attention.py:365",
                  dec["launches"]["K1"], k1_main, ms_hot=k1_main["ms_hot"],
                  library_ms_hot=k1_main["library_ms_hot"], cold_l2=True,
                  launches_by_step=dec["k1_launches_by_step"]),
            entry("flash_causal_attention_parts", k2,
                  "k8s_llm_scheduler_tpu_torch/csrc/causal_attention.cu",
                  "k8s_llm_scheduler_tpu/ops/pallas_prefix_attention.py:285",
                  dec["launches"]["K2"], k2_main, ms_cold=k2_main["ms_cold"],
                  ratio=k2_main["ratio"]),
            entry("ragged_matmul", k3,
                  "k8s_llm_scheduler_tpu_torch/csrc/ragged_matmul.cu",
                  "k8s_llm_scheduler_tpu/ops/ragged_matmul.py:108",
                  path_a["launches"]["K3"], k3_main, ms_hot=k3_main["ms_hot"],
                  library_ms_hot=k3_main["library_ms_hot"], cold_l2=True),
            entry("paged_decode_attention", k4,
                  "k8s_llm_scheduler_tpu_torch/csrc/paged_attention.cu",
                  "k8s_llm_scheduler_tpu/ops/pallas_paged_attention.py:276",
                  path_b["launches"]["K4"], k4_main),
        ],
        "not_ported": [],
    }
    phases = {"kernels": k_ok, "reference": r_ok, "decision": d_ok, "path_a": a_ok,
              "path_b": b_ok, "k3": k3_ok, "k4": k4_ok}
    record = {"device": kind, "smi": smi, "build_s": build_s, "kernels": line,
              "reference": ref, "decision": dec, "path_a": path_a, "path_b": path_b,
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
