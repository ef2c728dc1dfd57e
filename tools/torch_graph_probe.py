"""What the installed PyTorch's CUDA graphs offer the engine, on a GPU.

    python3 tools/torch_graph_probe.py [--nodes 5000 80000]

Prints one JSON line: the PyTorch and CUDA versions; the public methods of
`torch.cuda.CUDAGraph` (the engine takes the early exit of a wave on the
host because no conditional node is among them); whether a copy from the
device into pinned host memory captures and replays (the wave's liveness
flag); whether sampling with a generator of its own, registered with the
graph, captures and draws fresh numbers at each replay; and, for graphs of
N one-element kernels, the seconds to capture and instantiate them and the
device milliseconds of a replay (the floor a graph puts under each kernel).
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, nargs="+", default=[5000, 80000])
    args = ap.parse_args()
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
    }
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
