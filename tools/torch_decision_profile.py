"""Where the time of one scheduling decision goes in the PyTorch port, on a GPU.

    python3 tools/torch_decision_profile.py [--model llama-3.1-8b-instruct]
        [--path bf16|a] [--nodes 32] [--repeat N] [--package-root DIR]
        [--out FILE.json]

Builds the port's LocalLLMBackend with random weights from a seed (--path
a: the same weights quantized to int8 on the card, block-decode matmuls
through K3, as chip_smoke.py's path A), installs the cluster's prefix with
a first decision (not measured), then measures:

- each model call of the decision path at the shapes the decision uses,
  alone: one prefix-prefill chunk, the wave's suffix prefill and one
  block-decode iteration, as host wall time (ending in a synchronize) and
  device time (CUDA events), median of 5;
- `--repeat` single-pod decisions without the profiler, as host wall time
  (the end-to-end latency, for a parent/change A/B: --package-root measures
  the port package of another checkout);
- one whole single-pod decision under torch.profiler: device time and
  launches by kernel name (every kernel in --out, the top 20 printed), the
  device's busy and idle share of the wall time, the number of kernel
  launches per block-decode model call, and each hand-written kernel's
  device time and launches (K1-K4 by their kernels' names).

Prints JSON lines; the last one is the summary. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _package_root() -> str:
    """--package-root, read before the port is imported."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--package-root", default=str(Path(__file__).resolve().parent.parent))
    return str(Path(pre.parse_known_args()[0].package_root).resolve())


sys.path.insert(0, _package_root())

import torch  # noqa: E402

from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from k8s_llm_scheduler_tpu_torch.engine.local import (  # noqa: E402
    LocalLLMBackend,
    build_local_backend,
)
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer  # noqa: E402
from k8s_llm_scheduler_tpu_torch.models.configs import get_config  # noqa: E402
from k8s_llm_scheduler_tpu_torch.models.llama import (  # noqa: E402
    forward_block_decode,
    forward_prefill_suffix_dense,
)
from k8s_llm_scheduler_tpu_torch.models.quant import quantize_params  # noqa: E402
from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes  # noqa: E402


def _timed(fn, reps=5):
    """(median host ms, median device ms) of fn() over `reps` calls after a
    warm-up call; each call ends in a synchronize."""
    fn()
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1000.0)
        dev.append(start.elapsed_time(end))
    return statistics.median(host), statistics.median(dev)


def model_calls(engine, suffix_len: int) -> dict:
    cfg, params, dev = engine.cfg, engine.params, engine.device
    pfx = engine._prefix
    plen = torch.tensor(pfx.length, dtype=torch.int32, device=dev)
    out = {}
    chunk = min(engine.prefix_chunk, engine.prefill_buckets[-1])
    tok = torch.full((1, chunk), 65, dtype=torch.int32, device=dev)
    out["prefix_chunk"] = _timed(lambda: forward_prefill_suffix_dense(
        params, cfg, tok, torch.tensor([chunk], dtype=torch.int32, device=dev),
        pfx.k, pfx.v, torch.tensor(2 * chunk, dtype=torch.int32, device=dev),
    ))
    R = engine.max_slots
    bucket = engine._bucket_for(suffix_len)
    toks = torch.full((R, bucket), 65, dtype=torch.int32, device=dev)
    lens = torch.full((R,), suffix_len, dtype=torch.int32, device=dev)
    holder = {}

    def suffix():
        holder["kv"] = forward_prefill_suffix_dense(
            params, cfg, toks, lens, pfx.k, pfx.v, plen
        )

    out["suffix_prefill"] = _timed(suffix)
    _, k_sfx, v_sfx = holder["kv"]
    F, cap = engine.wave_block, 200
    gk = torch.zeros((cfg.n_layers, R, cap + 1, cfg.n_kv_heads, cfg.head_dim),
                     dtype=cfg.dtype, device=dev)
    gv = torch.zeros_like(gk)
    blk_tok = torch.full((R, F), 65, dtype=torch.int32, device=dev)
    blk_valid = torch.zeros((R, F), dtype=torch.bool, device=dev)
    blk_valid[:, 0] = True
    blk_len = blk_valid.sum(1, dtype=torch.int32)
    tail = torch.full((R,), 40, dtype=torch.int32, device=dev)
    pos = (plen + lens + tail)[:, None] + torch.arange(F, device=dev, dtype=torch.int32)
    out["block_decode"] = _timed(lambda: forward_block_decode(
        params, cfg, blk_tok, blk_valid, blk_len, pos, k_sfx, v_sfx, lens,
        gk, gv, tail, pfx.k, pfx.v, plen, ragged=engine.decode_matmul == "ragged",
    ))
    return {k: {"host_ms": h, "device_ms": d} for k, (h, d) in out.items()}


# The hand-written kernels' names as the profiler sees them (csrc/*.cu, each
# in an anonymous namespace, which keeps PyTorch's own `reduce_kernel` out);
# a kernel's split or combine pass counts with it.
KERNEL_NAMES = {
    key: tuple(f"(anonymous namespace)::{name}" for name in names)
    for key, names in {
        "K1": ("prefix_parts_kernel", "combine_kernel"),
        "K2": ("causal_parts_kernel",),
        "K3": ("ragged_kernel", "reduce_kernel"),
        "K4": ("paged_decode_kernel",),
    }.items()
}


def build(model: str, path: str, seed: int):
    """The backend of the decision path: bf16, or (path "a") int8 weights
    quantized on the card with block-decode matmuls through K3."""
    backend = build_local_backend(model, device="cuda", seed=seed, request_timeout_s=600.0)
    if path == "bf16":
        return backend
    engine = backend.engine
    params = quantize_params(engine.params)
    backend.close()
    del backend, engine
    torch.cuda.empty_cache()
    cfg = get_config(model)
    engine = InferenceEngine(params, cfg, ByteTokenizer(), temperature=0.0, rng_seed=seed,
                             decode_matmul="ragged")
    return LocalLLMBackend(engine, request_timeout_s=600.0)


def profile_decision(backend, pod, nodes) -> dict:
    from torch.profiler import ProfilerActivity, profile

    calls0 = backend.engine.stats["wave_model_calls"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        backend.get_scheduling_decision(pod, nodes)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    calls = backend.engine.stats["wave_model_calls"] - calls0
    # device-side rows: kernels, copies and fills, each with its own span
    gpu_rows = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    by_name: dict[str, list[float]] = {}
    for e in gpu_rows:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1000.0
        acc[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    kernels = {}
    for key, marks in KERNEL_NAMES.items():
        rows = [v for name, v in by_name.items() if any(m in name for m in marks)]
        kernels[key] = {"device_ms": sum(ms for ms, _ in rows),
                        "launches": sum(n for _, n in rows)}
    return {
        "wall_ms": wall_ms,
        "model_calls": calls,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches": len(gpu_rows),
        "launches_per_model_call": len(gpu_rows) / max(calls, 1),
        "kernels": kernels,
        "by_kernel": [
            {"name": name[:120], "device_ms": ms, "count": n}
            for name, (ms, n) in ranked
        ],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama-3.1-8b-instruct")
    ap.add_argument("--path", choices=("bf16", "a"), default="bf16",
                    help="bf16 weights, or path A: int8 weights and K3 in block decode")
    ap.add_argument("--nodes", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=0,
                    help="single decisions timed without the profiler first")
    ap.add_argument("--package-root", default=_package_root(),
                    help="the checkout whose k8s_llm_scheduler_tpu_torch to measure")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    backend = build(args.model, args.path, args.seed)
    try:
        nodes = synthetic_nodes(args.nodes)
        pods = fixture_pods(2)
        backend.get_scheduling_decision(pods[0], nodes)  # installs the prefix
        suffix_len = len(backend._prepare_item(pods[1], nodes).suffix_ids)
        rec = {"card": smi, "model": args.model, "path": args.path, "nodes": args.nodes,
               "package": str(Path(sys.modules[InferenceEngine.__module__].__file__)
                              .resolve().parents[1]),
               "prefix_tokens": backend.engine.prefix_len,
               "suffix_tokens": suffix_len}
        rec["model_calls"] = model_calls(backend.engine, suffix_len)
        print(json.dumps(rec["model_calls"]), flush=True)
        walls = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            backend.get_scheduling_decision(pods[1], nodes)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1000.0)
        rec["decision_wall_ms"] = walls
        rec["decision"] = profile_decision(backend, pods[1], nodes)
    finally:
        backend.close()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    for row in rec["decision"]["by_kernel"][:20]:
        print(json.dumps(row))
    summary = {k: v for k, v in rec.items() if k != "decision"}
    summary["decision"] = {k: v for k, v in rec["decision"].items() if k != "by_kernel"}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
