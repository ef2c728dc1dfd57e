#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--out FILE.json]

Run from the root of the repository. It fails (non-zero exit, no result
line) when no CUDA device is visible or the port is not beside it.

Phases, each of which must pass:

1. Build: compiles the hand-written CUDA kernels of the decision path from
   k8s_llm_scheduler_tpu_torch/csrc (one nvcc per source, in parallel).
2. Kernels: K1 (shared-prefix flash partials) and K2 (causal in-chunk flash
   partials) on random bf16 inputs at every shape the decision phase gives
   them (taken from the engine's bucket and wave geometry for the smoke's
   own prompts: prefix chunks, suffix prefills, block decodes), each held
   against its plain PyTorch version on the same inputs. Queries are scaled
   so that attention is peaked; the normalized output o/l must agree
   within 3e-2 of the reference's RMS, m within 1e-4 (1 + max |m|), l within
   1e-4 relative, and rows without a valid key must be exactly m = -1e30,
   l = 0. Median times over CUDA events for the kernel, its plain version
   and one PyTorch library call (scaled_dot_product_attention) on the same
   inputs.
3. Reference: the main path at TINY width on the card (kernels) against the
   same weights on the CPU (plain versions): chunked prefix prefill, then a
   suffix prefill; logits within 5e-2 of the largest logit (bf16).
4. Decision: a LocalLLMBackend with full-width, full-depth Llama-3.1-8B
   (random bf16 weights from a seed; built before phase 2, whose shapes it
   gives) serves 4 single decisions and a batch
   of 8 for a 32-node synthetic cluster (a 5,488-token prefix: the chunked
   prefix prefill). Every decision must parse, name a feasible node and
   carry a confidence in [0, 1]; both kernels must have launched on this
   run (their counts are zeroed just before it).

The last lines are a JSON object with per-kernel numbers, the card's name
and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
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
NEG_INF = -1e30
N_SINGLES = 4  # single decisions before the batch of 8


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Median device time of one call over `reps` timed calls (after two
    warm-up calls), from CUDA events around each call."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def _prefix_case(gen, step, B, S, Sp, plen, H=32, n_kv=8, hd=128):
    import torch
    import torch.nn.functional as F
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
    flops = 4.0 * B * S * H * plen * hd
    nbytes = (B * S * H * hd * 2 + 2 * plen * n_kv * hd * 2 + 4
              + B * H * S * hd * 4 + 2 * B * H * S * 4)
    rec.update(
        step=step,
        shape=f"q[{B},{S},{H},{hd}] prefix[{Sp},{n_kv},{hd}] prefix_len={plen}",
        ms=_time_ms(lambda: pa.flash_prefix_attention_parts(q, k, v, plen_d), 20),
        plain_ms=_time_ms(lambda: pa.prefix_attention_parts_plain(q, k, v, plen_d), 5),
        **_bound(flops, nbytes),
    )
    if plen > 0:
        qt = q.transpose(1, 2)
        kt = k[:plen].permute(1, 0, 2).unsqueeze(0).expand(B, n_kv, plen, hd)
        vt = v[:plen].permute(1, 0, 2).unsqueeze(0).expand(B, n_kv, plen, hd)
        rec["library_ms"] = _library_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
        )
    else:
        rec["library_ms"] = None
    return ok, rec


def _causal_case(gen, step, B, S, lens, H=32, n_kv=8, hd=128):
    import torch
    import torch.nn.functional as F
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
    pairs = sum(sum(min(n, s + 1) for s in range(S)) for n in lens)
    flops = 4.0 * pairs * H * hd
    nbytes = (B * S * H * hd * 2 + 2 * sum(lens) * n_kv * hd * 2 + 4 * B
              + B * H * S * hd * 4 + 2 * B * H * S * 4)
    rec.update(
        step=step,
        shape=f"q[{B},{S},{H},{hd}] lens={list(lens)}",
        ms=_time_ms(lambda: pa.flash_causal_attention_parts(q, k, v, lens_d), 20),
        plain_ms=_time_ms(lambda: pa.causal_attention_parts_plain(q, k, v, lens_d), 5),
        **_bound(flops, nbytes),
    )
    pos = torch.arange(S, device=dev)
    mask = (pos[:, None] >= pos[None, :])[None] & (pos[None, :] < lens_d[:, None])[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rec["library_ms"] = _library_ms(
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True
        )
    )
    return ok, rec


def _library_ms(fn) -> float | None:
    """Time of the PyTorch library yardstick, or None where this PyTorch
    build refuses the call (it is a yardstick only, never on the path)."""
    try:
        return _time_ms(fn, 20)
    except (RuntimeError, TypeError) as exc:
        print(f"  library call refused: {exc}", flush=True)
        return None


def _bound(flops: float, nbytes: float) -> dict:
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
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


def kernel_phase(k1_cases, k2_cases) -> tuple[bool, list[dict], list[dict]]:
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k1, k2 = [], []
    for case in k1_cases:
        ok, rec = _prefix_case(gen, *case)
        rec["ok"] = ok
        k1.append(rec)
        torch.cuda.empty_cache()
    for case in k2_cases:
        ok, rec = _causal_case(gen, *case)
        rec["ok"] = ok
        k2.append(rec)
        torch.cuda.empty_cache()
    for name, recs in (("K1", k1), ("K2", k2)):
        for rec in recs:
            print(f"{name} {rec['step']} {rec['shape']}: ok={rec['ok']} "
                  f"err={rec['max_abs_err']:.3g} (rms {rec['ref_rms']:.3g}) "
                  f"m_err={rec['m_err']:.3g} l_rel_err={rec['l_rel_err']:.3g} "
                  f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                  f"bound_ms={rec['bound_ms']:.4f} library_ms={rec['library_ms']}",
                  flush=True)
    return all(r["ok"] for r in k1 + k2), k1, k2


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
    return ok, rec


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
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

    decisions = []
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
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
    launches = {
        "K1": pa.flash_prefix_attention_parts.launches,
        "K2": pa.flash_causal_attention_parts.launches,
    }
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
    ok = ok and launches["K1"] > 0 and launches["K2"] > 0
    print("decision: " + json.dumps(rec), flush=True)
    return ok, rec


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
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}", flush=True)

    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes

    nodes = synthetic_nodes(32)
    pods = fixture_pods(8)
    backend, backend_s = build_backend()
    try:
        k1_cases, k2_cases = path_shapes(backend, nodes, pods, N_SINGLES)
        k_ok, k1, k2 = kernel_phase(k1_cases, k2_cases)
        r_ok, ref = reference_phase()
        d_ok, dec = decision_phase(backend, backend_s, nodes, pods)
    finally:
        backend.close()

    def entry(name, recs, source, replaces, launches):
        # headline: the batch's suffix prefill, the widest call of the waves
        main = max((r for r in recs if r["step"] == "suffix prefill"),
                   key=lambda r: r["flops"])
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
            "shapes": recs,
        }

    line = {
        "kernels": [
            entry("flash_prefix_attention_parts", k1,
                  "k8s_llm_scheduler_tpu_torch/csrc/prefix_attention.cu",
                  "k8s_llm_scheduler_tpu/ops/pallas_prefix_attention.py:365",
                  dec["launches"]["K1"]),
            entry("flash_causal_attention_parts", k2,
                  "k8s_llm_scheduler_tpu_torch/csrc/causal_attention.cu",
                  "k8s_llm_scheduler_tpu/ops/pallas_prefix_attention.py:285",
                  dec["launches"]["K2"]),
        ],
        "not_ported": [
            {"name": "ragged_matmul",
             "replaces": "k8s_llm_scheduler_tpu/ops/ragged_matmul.py:108"},
            {"name": "paged_decode_attention",
             "replaces": "k8s_llm_scheduler_tpu/ops/pallas_paged_attention.py:276"},
        ],
    }
    record = {"device": kind, "smi": smi, "build_s": build_s, "kernels": line,
              "reference": ref, "decision": dec,
              "phases_ok": {"kernels": k_ok, "reference": r_ok, "decision": d_ok}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    if not (k_ok and r_ok and d_ok):
        print(f"chip_smoke: FAILED phases {record['phases_ok']}", file=sys.stderr)
        return 1
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
