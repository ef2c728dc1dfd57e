"""Where the time of a tensor-parallel decision goes in the PyTorch port,
its tp ranks sharing one GPU over gloo (eager: gloo's host collectives
cannot be captured into a CUDA graph).

    python3 tools/torch_tp_profile.py [--model llama-3.1-8b-instruct] [--tp 2]
        [--nodes 8] [--reason-tokens 24] [--tp1] [--out FILE.json]

Builds the tp backend as chip_smoke.py's tp 8B phase does (weights drawn
from seed 0, paged_attn "pallas", greedy, graphs off), serves one decision
(not measured), then serves a second pod's decision twice on rank 0 (the
driver, this process):

1. with every tp all-reduce timed in four parts of host wall time, by the
   tensor's shape: `device_ms`, a synchronize of the stream before the
   copy out (the device work queued ahead of the all-reduce, which the
   copy out waits for anyway); `d2h_ms`, the copy into the pinned host
   buffer; `gloo_ms`, gloo's host all-reduce, which waits for the last
   rank to arrive; `h2d_ms`, queuing the copy back. Each mirrored call's
   settle with the followers (parallel/launch.Control.settle) is timed
   too;
2. under torch.profiler (tools/torch_decision_profile.profiled): the
   device's busy ms (kernels, copies, fills) against the wall ms, per
   model call.

`--tp1` then builds the same model at tp 1 (the whole model on this card,
the same weights, graphs off) and profiles the same decision the same way.
Prints JSON lines; the last one is the summary. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402
from torch_decision_profile import profiled  # noqa: E402

from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend  # noqa: E402
from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes  # noqa: E402


def _build(args, tp: int):
    return build_local_backend(
        args.model, device="cuda", seed=0, mesh_axes={"tp": tp}, graphs=False,
        temperature=0.0, packed_admission=False, max_pages_per_seq=64, paged_attn="pallas",
        max_reason_tokens=args.reason_tokens, request_timeout_s=600.0,
        prewarm_idle_delay_s=3600.0)


def _timed_all_reduce(group, book: dict):
    """`group.all_reduce` (parallel/launch.AxisGroup, gloo over CUDA
    tensors) split into its parts; each call's times land in `book` under
    its tensor's shape."""
    plain = group.all_reduce

    def all_reduce(t: torch.Tensor) -> torch.Tensor:
        if not (t.is_cuda and group.backend == "gloo"):
            return plain(t)
        row = book.setdefault(str(tuple(t.shape)), {
            "calls": 0, "bytes": t.numel() * t.element_size(), "device_ms": 0.0,
            "d2h_ms": 0.0, "gloo_ms": 0.0, "h2d_ms": 0.0})
        group.ops += 1
        t0 = time.perf_counter()
        torch.cuda.current_stream(t.device).synchronize()
        t1 = time.perf_counter()
        key = (tuple(t.shape), t.dtype)
        host = group._staging.get(key)
        if host is None:
            host = group._staging[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        t2 = time.perf_counter()
        group.pg.allreduce([host]).wait()
        t3 = time.perf_counter()
        t.copy_(host, non_blocking=True)
        t4 = time.perf_counter()
        row["calls"] += 1
        row["device_ms"] += (t1 - t0) * 1e3
        row["d2h_ms"] += (t2 - t1) * 1e3
        row["gloo_ms"] += (t3 - t2) * 1e3
        row["h2d_ms"] += (t4 - t3) * 1e3
        return t

    return all_reduce


def _timed_settle(control, book: dict):
    plain = control.settle

    def settle(engine, failed: bool) -> bool:
        t0 = time.perf_counter()
        try:
            return plain(engine, failed)
        finally:
            book["calls"] += 1
            book["ms"] += (time.perf_counter() - t0) * 1e3

    return settle


def tp_profile(args, rec: dict) -> None:
    nodes, pods = synthetic_nodes(args.nodes), fixture_pods(2)
    t0 = time.perf_counter()
    backend = _build(args, args.tp)
    rec["build_s"] = time.perf_counter() - t0
    try:
        engine = backend.engine
        backend.get_scheduling_decision(pods[0], nodes)  # installs the prefix
        # (the tp group exists once a first collective made it on every rank)
        group, control = engine.plane.group, engine.rank_group.control
        reduces, settles = {}, {"calls": 0, "ms": 0.0}
        group.all_reduce = _timed_all_reduce(group, reduces)
        control.settle = _timed_settle(control, settles)
        calls0 = engine.stats["wave_model_calls"]
        t1 = time.perf_counter()
        backend.get_scheduling_decision(pods[1], nodes)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
        calls = engine.stats["wave_model_calls"] - calls0
        del group.all_reduce, control.settle
        parts = ("device_ms", "d2h_ms", "gloo_ms", "h2d_ms")
        total = {p: sum(r[p] for r in reduces.values()) for p in parts}
        rec["split"] = {
            "wall_ms": wall_ms, "model_calls": calls, "all_reduce": reduces,
            "all_reduce_total": total,
            "all_reduces_per_model_call": sum(r["calls"] for r in reduces.values()) / calls,
            "settle": settles,
            "other_host_ms": wall_ms - sum(total.values()) - settles["ms"],
            "per_model_call_ms": {p: v / calls for p, v in total.items()},
            "wall_ms_per_model_call": wall_ms / calls,
        }
        print(json.dumps({"split": rec["split"]}), flush=True)
        rec["profile"] = profiled(lambda: backend.get_scheduling_decision(pods[1], nodes),
                                  lambda: engine.stats["wave_model_calls"])
        print(json.dumps({"profile": _short(rec["profile"])}), flush=True)
    finally:
        backend.close()
    if args.tp1:
        torch.cuda.empty_cache()
        backend = _build(args, 1)
        try:
            engine = backend.engine
            backend.get_scheduling_decision(pods[0], nodes)
            rec["tp1_profile"] = profiled(
                lambda: backend.get_scheduling_decision(pods[1], nodes),
                lambda: engine.stats["wave_model_calls"])
            print(json.dumps({"tp1_profile": _short(rec["tp1_profile"])}), flush=True)
        finally:
            backend.close()


def _short(profile: dict) -> dict:
    out = {k: v for k, v in profile.items() if k != "by_kernel"}
    out["top_kernels"] = profile["by_kernel"][:12]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama-3.1-8b-instruct")
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--reason-tokens", type=int, default=24)
    ap.add_argument("--tp1", action="store_true",
                    help="then profile the same decision at tp 1")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    rec = {"card": smi, "model": args.model, "tp": args.tp, "nodes": args.nodes,
           "reason_tokens": args.reason_tokens, "torch": torch.__version__}
    tp_profile(args, rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    summary = {k: v for k, v in rec.items() if not k.endswith("profile")}
    for key in ("profile", "tp1_profile"):
        if key in rec:
            summary[key] = {k: v for k, v in rec[key].items() if k != "by_kernel"}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
