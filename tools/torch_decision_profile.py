"""Where the time of one scheduling decision, or one general-path decode
step, goes in the PyTorch port, on a GPU.

    python3 tools/torch_decision_profile.py [--model llama-3.1-8b-instruct]
        [--path bf16|a|b] [--eager] [--nodes 32] [--repeat N]
        [--package-root DIR] [--out FILE.json]

The engine replays its waves and decode chunks as CUDA graphs (its
default); `--eager` runs them eagerly (graphs=False, the mode of the port
before graphs). --path bf16 and a profile the decision path: the port's
LocalLLMBackend with random weights from a seed (a: the same weights
quantized to int8 on the card, block-decode matmuls through K3, as
chip_smoke.py's path A), the cluster's prefix installed with a first
decision (not measured), then:

- each model call of the decision path at the shapes the decision uses,
  alone: one prefix-prefill chunk, the wave's suffix prefill and one
  block-decode iteration, as host wall time (ending in a synchronize) and
  device time (CUDA events), median of 5; in graph mode each call is also
  captured as a CUDA graph and its replay timed (`graph_device_ms`);
- the host microseconds of one call of K1's wrapper (and K3's on path a)
  at an R=8 block-decode call's shapes, beside one eager torch.add;
- `--repeat` single-pod decisions without the profiler, as host wall time
  (the end-to-end latency, for a parent/change A/B: --package-root measures
  the port package of another checkout);
- one whole single-pod decision under torch.profiler.

--path b profiles the general path as chip_smoke.py's path B drives it
(bf16, paged_attn "pallas", 8 slots, pages of 64, the cluster prefix, 8
unconstrained requests of 64 new tokens): one decode chunk (chunk_steps
steps) under torch.profiler after a first one (which captures). In graph
mode it also measures the two shapes a chunk can take as graphs, each on
a fresh engine: the whole chunk as one graph, or one step's graph
replayed chunk_steps times between a set-up and a flush graph (capture
seconds, and each chunk's host and device ms, median of 3).

A profile reports device time and launches by kernel name (every kernel in
--out, the top 20 printed), the device's busy and idle share of the wall
time, the host's launch calls (kernel launches, graph launches, async
copies and sets) and the device's operations per model call (a block
decode iteration, or a decode step), and each hand-written kernel's device
time and launches (K1-K4 by their kernels' names).

Prints JSON lines; the last one is the summary. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
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


def _timed(fn, reps=5, graph=False):
    """(median host ms, median device ms) of fn() over `reps` calls after a
    warm-up call; each call ends in a synchronize. With `graph`, fn is
    captured as a CUDA graph after the warm-up and its replay is timed."""
    fn()
    torch.cuda.synchronize()
    call = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        call = g.replay
    host, dev = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1000.0)
        dev.append(start.elapsed_time(end))
    return statistics.median(host), statistics.median(dev)


def model_calls(engine, suffix_len: int, graph: bool) -> dict:
    cfg, params, dev = engine.cfg, engine.params, engine.device
    pfx = engine._prefix
    plen = torch.tensor(pfx.length, dtype=torch.int32, device=dev)
    calls = {}
    chunk = min(engine.prefix_chunk, engine.prefill_buckets[-1])
    tok = torch.full((1, chunk), 65, dtype=torch.int32, device=dev)
    chunk_len = torch.tensor([chunk], dtype=torch.int32, device=dev)
    chunk_done = torch.tensor(2 * chunk, dtype=torch.int32, device=dev)
    calls["prefix_chunk"] = lambda: forward_prefill_suffix_dense(
        params, cfg, tok, chunk_len, pfx.k, pfx.v, chunk_done)
    R = engine.max_slots
    bucket = engine._bucket_for(suffix_len)
    toks = torch.full((R, bucket), 65, dtype=torch.int32, device=dev)
    lens = torch.full((R,), suffix_len, dtype=torch.int32, device=dev)
    _, k_sfx, v_sfx = forward_prefill_suffix_dense(params, cfg, toks, lens, pfx.k, pfx.v, plen)
    calls["suffix_prefill"] = lambda: forward_prefill_suffix_dense(
        params, cfg, toks, lens, pfx.k, pfx.v, plen)
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
    calls["block_decode"] = lambda: forward_block_decode(
        params, cfg, blk_tok, blk_valid, blk_len, pos, k_sfx, v_sfx, lens,
        gk, gv, tail, pfx.k, pfx.v, plen, ragged=engine.decode_matmul == "ragged",
    )
    out = {}
    for name, fn in calls.items():
        h, d = _timed(fn)
        out[name] = {"host_ms": h, "device_ms": d}
        if graph:
            out[name]["graph_device_ms"] = _timed(fn, graph=True)[1]
    return out


def wrapper_host_us(engine, reps: int = 224) -> dict:
    """Host microseconds of one call of each kernel wrapper on the block
    decode's path (its checks, split plan, tensor-map encoding and launch;
    the device is not waited for), median of 5 runs of `reps` back-to-back
    calls at the shapes of an R=8 block-decode call, beside one eager
    torch.add of the same activations."""
    from k8s_llm_scheduler_tpu_torch.models.llama import _layer
    from k8s_llm_scheduler_tpu_torch.ops.prefix_attention import (
        flash_prefix_attention_parts,
    )
    from k8s_llm_scheduler_tpu_torch.ops.ragged_matmul import ragged_matmul

    cfg, dev, pfx = engine.cfg, engine.device, engine._prefix
    R, F = engine.max_slots, engine.wave_block
    x = torch.randn((R * F, cfg.d_model), device=dev).to(cfg.dtype)
    q = torch.randn((R, F, cfg.n_heads, cfg.head_dim), device=dev).to(cfg.dtype)
    plen = torch.tensor(pfx.length, dtype=torch.int32, device=dev)
    total = torch.tensor(R, dtype=torch.int32, device=dev)
    lp = _layer(engine.params["layers"], 0)
    calls = {
        "K1 flash_prefix_attention_parts": lambda: flash_prefix_attention_parts(
            q, pfx.k[0], pfx.v[0], plen),
        "torch.add": lambda: torch.add(x, x),
    }
    if engine.decode_matmul == "ragged":
        calls["K3 ragged_matmul"] = lambda: ragged_matmul(x, lp["wq"], total)
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            runs.append((time.perf_counter() - t0) * 1e6 / reps)
            torch.cuda.synchronize()
        out[name] = statistics.median(runs)
    return out


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
# The host's launch calls as the profiler traces them (CUPTI): kernel
# launches through the runtime and the driver, graph launches, async copies
# and sets.
HOST_KERNEL_CALLS = frozenset(
    ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"))
HOST_LAUNCH_CALLS = HOST_KERNEL_CALLS | {"cudaGraphLaunch", "cudaMemcpyAsync",
                                         "cudaMemsetAsync"}


def graph_kw(graphs: bool) -> dict:
    """The engine's mode as a keyword: none for a package from before CUDA
    graphs (--package-root), whose engine is always eager."""
    if "graphs" in inspect.signature(InferenceEngine).parameters:
        return {"graphs": graphs}
    if graphs:
        raise SystemExit("this package's engine has no CUDA graphs: pass --eager")
    return {}


def build(model: str, path: str, seed: int, graphs: bool):
    """The backend of the decision path: bf16 (also path "b", whose engine
    is built apart), or (path "a") int8 weights quantized on the card with
    block-decode matmuls through K3."""
    backend = build_local_backend(model, device="cuda", seed=seed, request_timeout_s=600.0,
                                  temperature=0.0, packed_admission=False,
                                  max_pages_per_seq=64, **graph_kw(graphs))
    if path != "a":
        return backend
    engine = backend.engine
    params = quantize_params(engine.params)
    backend.close()
    del backend, engine
    torch.cuda.empty_cache()
    cfg = get_config(model)
    engine = InferenceEngine(params, cfg, ByteTokenizer(), temperature=0.0, rng_seed=seed,
                             decode_matmul="ragged", **graph_kw(graphs))
    return LocalLLMBackend(engine, request_timeout_s=600.0)


def profiled(fn, calls_of) -> dict:
    """fn() under torch.profiler, ending in a synchronize; `calls_of()` read
    before and after gives the model calls it ran."""
    from torch.profiler import ProfilerActivity, profile

    calls0 = calls_of()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    calls = max(calls_of() - calls0, 1)
    # device-side rows: kernels, copies and fills, each with its own span
    gpu_rows = []
    host = {"launches": 0, "kernel_launches": 0, "graph_launches": 0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            gpu_rows.append(e)
        elif e.name in HOST_LAUNCH_CALLS:
            host["launches"] += 1
            host["kernel_launches"] += e.name in HOST_KERNEL_CALLS
            host["graph_launches"] += e.name == "cudaGraphLaunch"
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
        ms, n = sum(ms for ms, _ in rows), sum(n for _, n in rows)
        kernels[key] = {"device_ms": ms, "launches": n, "ms_per_launch": ms / n if n else None}
    return {
        "wall_ms": wall_ms,
        "model_calls": calls,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_ms_per_model_call": busy_ms / calls,
        "device_ops": len(gpu_rows),
        "device_ops_per_model_call": len(gpu_rows) / calls,
        "host_launches": host,
        "host_launches_per_model_call": host["launches"] / calls,
        "kernels": kernels,
        "by_kernel": [
            {"name": name[:120], "device_ms": ms, "count": n}
            for name, (ms, n) in ranked
        ],
    }


def decision_profile(args, rec) -> None:
    """--path bf16 / a: model calls, --repeat decisions, one profiled."""
    backend = build(args.model, args.path, args.seed, not args.eager)
    try:
        nodes = synthetic_nodes(args.nodes)
        pods = fixture_pods(2)
        backend.get_scheduling_decision(pods[0], nodes)  # installs the prefix
        engine = backend.engine
        # the idle worker captures the sibling geometry now: let it finish,
        # so that no capture of its runs beside the measurements below
        while engine.wave_prewarm_backlog():
            time.sleep(0.05)
        suffix_len = len(backend._prepare_item(pods[1], nodes).suffix_ids)
        rec.update(prefix_tokens=engine.prefix_len, suffix_tokens=suffix_len)
        rec["model_calls"] = model_calls(engine, suffix_len, not args.eager)
        print(json.dumps(rec["model_calls"]), flush=True)
        rec["wrapper_host_us"] = wrapper_host_us(engine)
        print(json.dumps(rec["wrapper_host_us"]), flush=True)
        walls = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            backend.get_scheduling_decision(pods[1], nodes)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1000.0)
        rec["decision_wall_ms"] = walls
        rec["profile"] = profiled(
            lambda: backend.get_scheduling_decision(pods[1], nodes),
            lambda: engine.stats["wave_model_calls"])
        rec["graphs"] = _graph_books(engine)
    finally:
        backend.close()


def _graph_books(engine) -> dict:
    runner = getattr(engine, "_graphs", None)
    if runner is None:
        return {}
    return {"captures": runner.captures, "capture_s": dict(runner.capture_s)}


def _path_b_engine(backend, nodes, pods, graphs: bool):
    """Path B's engine on the backend's bf16 weights, the cluster prefix
    installed and 8 requests admitted; (engine, suffixes)."""
    items = [backend._prepare_item(p, nodes) for p in pods]
    eng = InferenceEngine(backend.engine.params, backend.engine.cfg, ByteTokenizer(),
                          temperature=0.0, paged_attn="pallas", max_slots=8,
                          page_size=64, **graph_kw(graphs))
    eng.set_prefix(items[0].prefix_ids)
    suffixes = [it.suffix_ids for it in items]
    eng.add_requests(suffixes, max_new_tokens=64)
    torch.cuda.synchronize()
    return eng, suffixes


def _as_step_graphs(eng) -> None:
    """Makes the engine's next decode chunk variant run as one step's graph
    replayed chunk_steps times between a set-up and a flush graph, built
    from the chunk's own methods, in place of its one chunk graph."""
    from k8s_llm_scheduler_tpu_torch.engine.engine import _ChunkVariant

    prefix = eng._bind_prefix()
    eng._padded_tables()
    eng._chunk_buffers()
    var = _ChunkVariant(eng, prefix)
    runner = eng._graphs
    programs = (
        [runner.program("decode chunk set-up", var._begin, idempotent=True)]
        + [runner.program("decode step", var._step)] * eng.chunk_steps
        + [runner.program("decode flush", var._flush, idempotent=True)]
    )

    def run():
        for prog in programs:
            prog.run()

    var.run = run
    eng._chunk_variants[eng._chunk_key()] = var


def _chunk_times(eng) -> dict:
    """Capture seconds of the engine's chunk programs (its first step()),
    then each further chunk's host ms (ending in the step's sync) and device
    ms (CUDA events), median of 3."""
    eng.step()
    host, dev = [], []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        eng.step()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1000.0)
        dev.append(start.elapsed_time(end))
    return {"capture_s": dict(eng._graphs.capture_s), "chunk_host_ms": statistics.median(host),
            "chunk_device_ms": statistics.median(dev), "steps": eng.chunk_steps}


def decode_profile(args, rec) -> None:
    """--path b: one decode chunk profiled after a first one; in graph mode
    the chunk graph against the step graph."""
    backend = build(args.model, "bf16", args.seed, not args.eager)
    try:
        nodes = synthetic_nodes(args.nodes)
        pods = fixture_pods(8)
        eng, _ = _path_b_engine(backend, nodes, pods, not args.eager)
        rec["prefix_tokens"] = eng.prefix_len
        eng.step()  # the first chunk (captures in graph mode)
        rec["profile"] = profiled(
            eng.step, lambda: eng.stats["chunks"] * eng.chunk_steps)
        rec["graphs"] = _graph_books(eng)
        del eng
        if not args.eager:
            shapes = {}
            for chunk_graph in ("chunk", "step"):
                torch.cuda.empty_cache()
                e, _ = _path_b_engine(backend, nodes, pods, True)
                if chunk_graph == "step":
                    _as_step_graphs(e)
                shapes[chunk_graph] = _chunk_times(e)
                print(json.dumps({chunk_graph: shapes[chunk_graph]}), flush=True)
                del e
            rec["chunk_graph_shapes"] = shapes
    finally:
        backend.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama-3.1-8b-instruct")
    ap.add_argument("--path", choices=("bf16", "a", "b"), default="bf16",
                    help="bf16 decisions; path A: int8 weights and K3 in block decode; "
                         "path B: general-path decode steps (K4)")
    ap.add_argument("--eager", action="store_true",
                    help="run waves and decode chunks eagerly (graphs=False)")
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
    rec = {"card": smi, "model": args.model, "path": args.path, "nodes": args.nodes,
           "mode": "eager" if args.eager else "graphs",
           "package": str(Path(sys.modules[InferenceEngine.__module__].__file__)
                          .resolve().parents[1])}
    if args.path == "b":
        decode_profile(args, rec)
    else:
        decision_profile(args, rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    for row in rec["profile"]["by_kernel"][:20]:
        print(json.dumps(row))
    summary = {k: v for k, v in rec.items() if k != "profile"}
    summary["profile"] = {k: v for k, v in rec["profile"].items() if k != "by_kernel"}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
