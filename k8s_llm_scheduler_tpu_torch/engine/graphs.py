"""CUDA graphs of the engine's device programs: capture, replay and the
shared memory pool.

PyTorch's counterpart of the JAX engine's `jax.jit` of `_wave_impl` and
`_decode_chunk_impl` (JAX package, engine/engine.py): where JAX traces a
program once per shape and dispatches the compiled executable, the port
captures a `Program` (a Python function over static buffers, which neither
allocates what outlives it nor syncs the host) as a CUDA graph the first
time it runs, and replays it after: one host launch in place of the
thousands of kernel launches of its eager run.

- **First run**: the function runs once eagerly on the runner's side
  stream (the warm-up: it is also this run's real work, and it makes every
  lazy allocation, such as K4's split counters, outside the capture), then
  it is captured on that stream into the runner's one memory pool. An
  idempotent program (one whose result depends only on its inputs) is then
  replayed once, so its capture is proven before anything relies on it.
- **Later runs** replay the graph on the current stream: the device's
  default stream, on every thread that runs programs.
- **No fallback**: a failed warm-up, capture or replay raises; the program
  stays uncaptured and the next run tries again.
- **Launch accounting**: the kernel wrappers count their launches on the
  host (`<wrapper>.launches`), which a replay does not run. A capture
  records how many times each wrapper launched while it was captured, sets
  the counts back (a capture launches nothing), and every replay adds what
  was recorded.

With `enabled=False`, or off a CUDA device, a program runs its function
eagerly every time: the same static-buffer code, the counterpart of
`jax.disable_jit`.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def launch_counted() -> tuple:
    """The kernel wrappers whose host launch counts a replay adds to."""
    from k8s_llm_scheduler_tpu_torch.ops import paged_attention as pg
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa
    from k8s_llm_scheduler_tpu_torch.ops.ragged_matmul import ragged_matmul

    return (
        pa.flash_prefix_attention_parts,
        pa.flash_causal_attention_parts,
        ragged_matmul,
        pg.paged_decode_attention_parts,
        pg.paged_decode_attention,
    )


class Program:
    """One device program of the engine over static buffers: `fn()` run
    eagerly, or captured at its first run and replayed after (GraphRunner).
    `name` labels it in the runner's books."""

    def __init__(self, runner: "GraphRunner", name: str, fn: Callable[[], None],
                 idempotent: bool = False) -> None:
        self.runner = runner
        self.name = name
        self.fn = fn
        self.idempotent = idempotent
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict = {}  # wrapper -> launches recorded by the capture
        self.capture_s: float | None = None
        self.runs = 0  # device runs: eager (the warm-up too) and replays

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def run(self) -> None:
        runner = self.runner
        if not runner.enabled:
            self.fn()
            self.runs += 1
            return
        if self.graph is None:
            runner.capture(self)
            return
        self._replay()

    def _replay(self) -> None:
        self.graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        self.runs += 1
        self.runner.replays += 1


class GraphRunner:
    """Captures and replays one engine's programs; every graph of the engine
    draws on one memory pool. `generator`, when given, is registered with
    every graph so that sampling under replay draws fresh numbers."""

    def __init__(self, device: torch.device, enabled: bool = True,
                 generator: torch.Generator | None = None) -> None:
        self.device = device
        self.enabled = bool(enabled) and device.type == "cuda"
        self.generator = generator
        self.pool = torch.cuda.graph_pool_handle() if self.enabled else None
        self.stream = torch.cuda.Stream(device) if self.enabled else None
        self.captures = 0
        self.replays = 0
        self.capture_s: dict[str, float] = {}  # program name -> seconds

    def program(self, name: str, fn: Callable[[], None],
                idempotent: bool = False) -> Program:
        return Program(self, name, fn, idempotent)

    def capture(self, prog: Program) -> None:
        """Warm-up run (the real work of this run), capture, and for an
        idempotent program one replay. Raises on any failure."""
        cur = torch.cuda.current_stream(self.device)
        side = self.stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            prog.fn()
        prog.runs += 1
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        counted = launch_counted()
        before = [w.launches for w in counted]
        t0 = time.perf_counter()
        try:
            # "thread_local": the engine captures on whichever thread runs
            # a program first (the wave dispatcher, or the engine's owner),
            # while the other goes on with its own CUDA calls (event
            # queries and syncs, pinned host buffers); under the default
            # "global" mode any of them would invalidate the capture.
            with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                  capture_error_mode="thread_local"):
                prog.fn()
        finally:
            recorded = [w.launches - n for w, n in zip(counted, before)]
            for w, n in zip(counted, before):
                w.launches = n
        prog.capture_s = time.perf_counter() - t0
        prog.graph = graph
        prog.launches = {w: n for w, n in zip(counted, recorded) if n}
        self.captures += 1
        self.capture_s[prog.name] = self.capture_s.get(prog.name, 0.0) + prog.capture_s
        if prog.idempotent:
            prog._replay()


class Fence:
    """A CUDA event on a card (recorded on the current stream); on the CPU,
    where every op has finished when it returns, a no-op."""

    def __init__(self, device: torch.device) -> None:
        self._event = torch.cuda.Event() if device.type == "cuda" else None

    def record(self) -> None:
        if self._event is not None:
            self._event.record()

    def synchronize(self) -> None:
        if self._event is not None:
            self._event.synchronize()

    def query(self) -> bool:
        return self._event is None or self._event.query()


def host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    """A host tensor that the device copies into and out of without a sync:
    pinned when `device` is a card."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")
