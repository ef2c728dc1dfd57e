"""What the installed PyTorch's CUDA graphs offer the engine, on a GPU.

    python3 tools/torch_graph_probe.py [--nodes 5000 80000] [--package-root DIR]

Prints one JSON line: the PyTorch and CUDA versions; the public methods of
`torch.cuda.CUDAGraph` (the engine takes the early exit of a wave on the
host because no conditional node is among them); whether a copy from the
device into pinned host memory captures and replays (the wave's liveness
flag); whether sampling with a generator of its own, registered with the
graph, captures and draws fresh numbers at each replay; and, for graphs of
N one-element kernels, the seconds to capture and instantiate them and the
device milliseconds of a replay (the floor a graph puts under each kernel).
`conditional` lists what the private graph class (`torch._C._CUDAGraph`)
offers for conditional nodes, then captures the engine's WHILE node
(engine/graphs.GraphRunner.while_live, at most 16 steps) around one step of
the fused decode's shape (a cuBLAS bf16 product of [9, 4096] rows, a
multinomial draw from the graph's generator, K4 at path B's shapes, a
budget count-down), and replays it live for 5 and 16 steps and dead (no
budget): the steps run, K4's booked launches and the device ms of each;
`conditional_body_sizes` then times up to 16 steps of 10, 1,000 and 4,000
one-element kernels, as 16 IF nodes and as one WHILE node, dead and live
(what a skipped body costs as it grows, in each form). `while_body_draws`
replays one WHILE node of 16 iterations twice, each iteration writing
its row of four uniforms: drawn inside the body, and taken from a
[16, 4] buffer drawn before the node (what engine/fused/loop.py does): the
distinct rows in one replay, and whether the second replay drew afresh.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import torch


def _capture(fn) -> torch.cuda.CUDAGraph:
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def pinned_copy() -> bool:
    x = torch.zeros(4, device="cuda")
    host = torch.zeros(4, pin_memory=True)

    def step():
        x.add_(1)
        host.copy_(x, non_blocking=True)

    step()  # warm-up: x = 1
    graph = _capture(step)
    graph.replay()
    torch.cuda.synchronize()
    return host.tolist() == [2.0] * 4


def own_generator() -> bool:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    probs = torch.softmax(torch.randn(4, 100, device="cuda"), dim=-1)
    torch.multinomial(probs, 1, generator=gen)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out = torch.multinomial(probs, 1, generator=gen)
    draws = []
    for _ in range(4):
        graph.replay()
        draws.append(out.clone())
    torch.cuda.synchronize()
    return any(bool((d != draws[0]).any()) for d in draws[1:])


def node_times(n: int) -> dict:
    y = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            y.add_(1)
    capture_s = time.perf_counter() - t0
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return {"kernels": n, "capture_s": capture_s, "replay_ms": start.elapsed_time(end)}


def conditional_nodes() -> dict:
    """The engine's conditional IF nodes (engine/graphs.GraphRunner.when_live)
    around one step of the fused decode's shape each."""
    from k8s_llm_scheduler_tpu_torch.engine.graphs import GraphRunner
    from k8s_llm_scheduler_tpu_torch.ops import paged_attention as pg

    graph_cls = torch._C._CUDAGraph
    rec = {"torch_conditional_methods": sorted(
        m for m in dir(graph_cls) if "conditional" in m or "_node" in m)}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    runner = GraphRunner(dev, True, generator=g)
    x = torch.randn(9, 4096, device=dev, dtype=torch.bfloat16)
    w = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16) * 0.01
    wv = torch.randn(4096, 8192, device=dev, dtype=torch.bfloat16) * 0.01
    q = torch.randn(9, 32, 128, device=dev, dtype=torch.bfloat16)
    kc = torch.randn(512, 64, 8, 128, device=dev, dtype=torch.bfloat16)
    vc = torch.randn_like(kc)
    table = torch.arange(9 * 56, device=dev, dtype=torch.int32).view(9, 56) % 512
    lens = torch.full((9,), 230, device=dev, dtype=torch.int32)
    act = torch.ones(9, dtype=torch.bool, device=dev)
    budget = torch.zeros(9, dtype=torch.int32, device=dev)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    tok = torch.zeros(9, dtype=torch.int64, device=dev)
    o = torch.zeros(9, 32, 128, device=dev, dtype=torch.bfloat16)

    def body():
        h = torch.tanh(x @ w)
        probs = torch.softmax((h @ wv).float(), dim=-1)
        tok.copy_(torch.multinomial(probs, 1, generator=g)[:, 0])
        o.copy_(pg.paged_decode_attention(q, kc, vc, table, lens))
        budget.sub_(1)
        steps.add_(1)

    def chunk():
        steps.zero_()
        runner.while_live(act, budget, body, steps, 16)

    prog = runner.program("probe chunk", chunk)
    budget.fill_(3)
    steps.zero_()
    prog.run()  # warm-up (eager) and capture
    torch.cuda.synchronize()
    rec["warmup_steps"] = int(steps)
    rec["bodies_captured"] = prog.bodies
    rec["k4_launches_a_body"] = prog.body_launches.get(pg.paged_decode_attention, 0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for name, b in (("live5", 5), ("dead", 0), ("live16", 16), ("dead_again", 0)):
        budget.fill_(b)
        steps.zero_()
        torch.cuda.synchronize()
        k4 = pg.paged_decode_attention.launches
        start.record()
        prog.run()
        end.record()
        end.synchronize()
        prog.book_bodies(int(steps))
        rec[name] = {"steps_run": int(steps), "ms": start.elapsed_time(end),
                     "k4_launches": pg.paged_decode_attention.launches - k4}
    draws = []
    for _ in range(3):
        budget.fill_(1)
        prog.run()
        draws.append(tok.clone())
    torch.cuda.synchronize()
    rec["fresh_draws"] = any(bool((d != draws[0]).any()) for d in draws[1:])
    return rec


def conditional_body_sizes(sizes=(10, 1000, 4000), n: int = 16) -> list[dict]:
    """Up to 16 steps whose bodies hold `k` one-element kernels, as a chain
    of 16 IF nodes and as one WHILE node, replayed dead (no slot live) and
    live (16 steps), device ms a replay (mean of 5): what a skipped body
    costs as it grows, in each form."""
    from k8s_llm_scheduler_tpu_torch.engine.graphs import GraphRunner

    dev = torch.device("cuda")
    out = []
    for k, form in itertools.product(sizes, ("if_chain", "while")):
        runner = GraphRunner(dev, True)
        act = torch.ones(9, dtype=torch.bool, device=dev)
        budget = torch.zeros(9, dtype=torch.int32, device=dev)
        steps = torch.zeros((), dtype=torch.int64, device=dev)
        y = torch.zeros(1, device=dev)

        def body():
            for _ in range(k):
                y.add_(1)
            budget.sub_(1)
            steps.add_(1)

        def chunk():
            steps.zero_()
            if form == "while":
                runner.while_live(act, budget, body, steps, n)
                return
            for _ in range(n):
                if runner.when_live(act, budget, body) is False:
                    break

        prog = runner.program(f"{k}-kernel bodies, {form}", chunk)
        budget.fill_(1)
        t0 = time.perf_counter()
        prog.run()  # warm-up and capture
        torch.cuda.synchronize()
        rec = {"body_kernels": k, "form": form, "capture_s": time.perf_counter() - t0}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for name, b in (("dead", 0), ("live", n)):
            times = []
            for _ in range(5):
                budget.fill_(b)
                torch.cuda.synchronize()
                start.record()
                prog.run()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            rec[f"{name}_ms"] = sum(times) / len(times)
            rec[f"{name}_steps"] = int(steps)
        out.append(rec)
        del prog, runner
    return out


def while_body_draws(n: int = 16) -> dict:
    """One WHILE node of `n` iterations whose iteration j writes four
    uniforms into row j, drawn inside the body or read from a buffer drawn
    before the node; per form, the distinct rows of one replay and
    whether a second replay gave other rows."""
    from k8s_llm_scheduler_tpu_torch.engine.graphs import GraphRunner

    dev = torch.device("cuda")
    out = {}
    for form in ("in_body", "before_node"):
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        runner = GraphRunner(dev, True, generator=g)
        act = torch.ones(1, dtype=torch.bool, device=dev)
        budget = torch.ones(1, dtype=torch.int32, device=dev)
        j = torch.zeros((), dtype=torch.int64, device=dev)
        u = torch.zeros((n, 4), device=dev)
        rows = torch.zeros((n, 4), device=dev)

        def body():
            row = (torch.rand(4, generator=g, device=dev) if form == "in_body"
                   else u.index_select(0, j.view(1))[0])
            rows.index_copy_(0, j.view(1), row[None])
            j.add_(1)

        def chunk():
            j.zero_()
            if form == "before_node":
                u.uniform_(generator=g)
            runner.while_live(act, budget, body, j, n)

        prog = runner.program(f"draws {form}", chunk)
        prog.run()  # warm-up and capture
        replays = []
        for _ in range(2):
            prog.run()
            replays.append(rows.clone())
        torch.cuda.synchronize()
        out[form] = {
            "steps_run": int(j),
            "distinct_rows": len({tuple(r) for r in replays[0].tolist()}),
            "second_replay_differs": bool((replays[0] != replays[1]).any()),
        }
        del prog, runner
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, nargs="+", default=[5000, 80000])
    ap.add_argument("--package-root", default=None,
                    help="directory holding the port's package (default: the repo root)")
    args = ap.parse_args()
    sys.path.insert(0, args.package_root or str(Path(__file__).resolve().parents[1]))
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    rec = {
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_graph_methods": sorted(
            m for m in dir(torch.cuda.CUDAGraph) if not m.startswith("_")),
        "pinned_copy_in_graph": pinned_copy(),
        "own_generator_in_graph": own_generator(),
        "graphs_of_tiny_kernels": [node_times(n) for n in args.nodes],
        "conditional": conditional_nodes(),
        "conditional_body_sizes": conditional_body_sizes(),
        "while_body_draws": while_body_draws(),
    }
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
