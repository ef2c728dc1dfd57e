"""CUDA graphs of the engine's device programs: capture, replay and the
shared memory pool.

PyTorch's counterpart of the JAX engine's `jax.jit` of `_wave_impl` and
`_decode_chunk_impl` (JAX package, engine/engine.py), and of its spec/
verify programs (spec/verify.VerifyProgram): where JAX traces a
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
- **Early exit** (`GraphRunner.while_live` / `when_live`): a step repeated
  while "any slot is still live" (and a step counter is below its bound),
  or run once if one is, runs eagerly under a host test; under capture it
  becomes a conditional WHILE (or IF) node whose condition a small kernel
  sets on the device (csrc/graph_cond.cu), its body captured on the
  runner's body stream into a memory pool of its own. PyTorch 2.11 has no
  conditional node, so the runtime API does this through ctypes. This is
  the JAX package's fused `lax.while_loop`: a finished batch's chunk costs
  the test and one skipped body.
- **Launch accounting**: the kernel wrappers count their launches on the
  host (`<wrapper>.launches`), which a replay does not run. A capture
  records how many times each wrapper launched while it was captured, sets
  the counts back (a capture launches nothing), and every replay adds what
  was recorded outside conditional bodies; what one body launched is added
  by `Program.book_bodies` once the caller knows how many bodies ran.

With `enabled=False`, or off a CUDA device, a program runs its function
eagerly every time: the same static-buffer code, the counterpart of
`jax.disable_jit`.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import threading
import time
from typing import Callable

import torch

# A CUDA graph capture on one thread forbids, on every other thread of the
# process, a device-wide synchronize, the caching allocator's empty_cache
# and the destruction of a memory pool (and torch.cuda.graph synchronizes
# and empties the cache itself before it begins). Every capture holds this
# lock, and so does every engine's device-wide synchronize and release, so
# that engines sharing a process (the serving engine beside a canary
# gate's arms and a shadow arm in `cli rollout watch`) capture and free
# their memory without breaking each other's captures.
DEVICE_WIDE = threading.RLock()

# Cyclic garbage collection is off while any capture runs: a collection on
# the capturing thread could free another program's graph (an engine left
# in a reference cycle), and destroying a graph is not permitted there. A
# count under a lock turns it off at the first hold and back on (if it was
# on) at the last release, whichever threads hold it.
_GC_LOCK = threading.Lock()
_gc_holds = 0
_gc_was_enabled = False


@contextlib.contextmanager
def no_collection():
    """Cyclic garbage collection off for the body, on every thread."""
    global _gc_holds, _gc_was_enabled
    with _GC_LOCK:
        if _gc_holds == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_holds += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_was_enabled:
                gc.enable()


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


IF_NODE, WHILE_NODE = 0, 1  # csrc/graph_cond.cu's node kinds


def _live(act, budget, gate=None, counter=None, n=0) -> bool:
    """The condition a conditional node's kernel evaluates, on the host."""
    if gate is not None and not bool(gate):
        return False
    if counter is not None and int(counter) >= n:
        return False
    return bool((act & (budget > 0)).any())


@functools.cache
def _cond_entries():
    from k8s_llm_scheduler_tpu_torch.ops import kernels

    lib = kernels.library("graph_cond")
    begin, end = lib.k8s_cond_begin, lib.k8s_cond_end
    begin.restype = end.restype = ctypes.c_int
    cond = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong]  # act, budget, M, gate, counter, n
    begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, *cond,
                      ctypes.POINTER(ctypes.c_ulonglong)]
    end.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong, *cond]
    return begin, end


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
        # wrapper -> launches of ONE conditional body (when_live); every
        # body of a program runs the same step
        self.body_launches: dict = {}
        self.bodies = 0  # conditional bodies captured
        self.replayed = False  # the last run was a replay
        self.capture_s: float | None = None
        self.runs = 0  # device runs: eager (the warm-up too) and replays

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def run(self) -> None:
        runner = self.runner
        self.replayed = False
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
        self.replayed = True

    def book_bodies(self, n: int) -> None:
        """After a replay, count the launches of the `n` conditional bodies
        that ran (an eager run's wrappers counted themselves)."""
        if self.replayed:
            for wrapper, k in self.body_launches.items():
                wrapper.launches += k * n


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
        # conditional bodies: captured on their own stream into their own pool
        self.body_stream = torch.cuda.Stream(device) if self.enabled else None
        self.body_pool = None
        self._capturing: Program | None = None
        self.captures = 0
        self.replays = 0
        self.capture_s: dict[str, float] = {}  # program name -> seconds

    def program(self, name: str, fn: Callable[[], None],
                idempotent: bool = False) -> Program:
        return Program(self, name, fn, idempotent)

    def capture(self, prog: Program) -> None:
        """Warm-up run (the real work of this run), capture, and for an
        idempotent program one replay, under DEVICE_WIDE. Raises on any
        failure."""
        with DEVICE_WIDE:
            self._capture(prog)

    def _capture(self, prog: Program) -> None:
        if self.body_pool is None:
            # cuBLAS's handle and workspace for the body stream, made
            # outside any capture
            self.body_pool = torch.cuda.MemPool()
            with torch.cuda.stream(self.body_stream):
                for dtype in (torch.float32, torch.bfloat16):
                    a = torch.ones((8, 8), dtype=dtype, device=self.device)
                    a @ a
            self.body_stream.synchronize()
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
        prog.body_launches, prog.bodies = {}, 0
        t0 = time.perf_counter()
        try:
            # "thread_local": the engine captures on whichever thread runs
            # a program first (the wave dispatcher, the resident loop's
            # thread, or the engine's owner), while the others go on with
            # their own CUDA calls (event queries and syncs, pinned host
            # buffers); under the default "global" mode any of them would
            # invalidate the capture.
            self._capturing = prog
            # (torch.cuda.graph's own gc.collect() runs before the capture
            # begins; a graph another thread frees by reference count is
            # destroyed on that thread, which "thread_local" permits)
            with no_collection(), torch.cuda.graph(graph, pool=self.pool, stream=side,
                                                   capture_error_mode="thread_local"):
                prog.fn()
        finally:
            self._capturing = None
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

    def when_live(self, act: torch.Tensor, budget: torch.Tensor,
                  fn: Callable[[], None], gate: torch.Tensor | None = None) -> bool | None:
        """Run `fn` once if any slot is live (`act & budget > 0`; act bool
        [M], budget int32 [M]) and the optional 0-dim bool `gate` is set.
        Eagerly (off a card, graphs off, a capture's warm-up run) the test
        syncs the host and the result says whether `fn` ran. Under capture
        `fn` becomes the body of a conditional IF node that a kernel tests
        on the device at each replay; returns None."""
        if self._capturing is None:
            if not _live(act, budget, gate):
                return False
            fn()
            return True
        self._conditional(IF_NODE, fn, act, budget, gate, None, 0)
        return None

    def while_live(self, act: torch.Tensor, budget: torch.Tensor, fn: Callable[[], None],
                   counter: torch.Tensor, n: int, gate: torch.Tensor | None = None) -> None:
        """Run `fn` while any slot is live, `gate` (if given) is set and the
        0-dim int64 `counter`, which `fn` advances, is below `n`. Eagerly
        the test syncs the host before each run; under capture `fn` becomes
        the body of a conditional WHILE node, its kernel run before the
        first iteration and at the end of each. `fn`'s kernel launches are
        booked per iteration (Program.book_bodies). A random draw inside
        `fn` repeats at every iteration of a replay (its Philox offset is
        fixed at capture): draw what the iterations need before the node."""
        if self._capturing is None:
            while _live(act, budget, gate, counter, n):
                fn()
            return
        self._conditional(WHILE_NODE, fn, act, budget, gate, counter, n)

    def _conditional(self, kind: int, fn, act, budget, gate, counter, n) -> None:
        """Capture `fn` as the body of a conditional node of `kind` in the
        program being captured."""
        prog = self._capturing
        begin, end = _cond_entries()
        cond = (act.data_ptr(), budget.data_ptr(), act.shape[0],
                None if gate is None else gate.data_ptr(),
                None if counter is None else counter.data_ptr(), n)
        handle = ctypes.c_ulonglong(0)
        side = torch.cuda.current_stream(self.device)
        rc = begin(side.cuda_stream, self.body_stream.cuda_stream, kind, *cond,
                   ctypes.byref(handle))
        if rc != 0:
            raise RuntimeError(f"conditional node: capture into its body failed ({rc})")
        counted = launch_counted()
        before = [w.launches for w in counted]
        try:
            with torch.cuda.stream(self.body_stream), torch.cuda.use_mem_pool(self.body_pool):
                fn()
        finally:
            rc = end(self.body_stream.cuda_stream, kind, handle.value, *cond)
            for w, n_before in zip(counted, before):
                if w.launches != n_before:
                    prog.body_launches[w] = w.launches - n_before
                w.launches = n_before
        if rc != 0:
            raise RuntimeError(f"conditional node: ending its body's capture failed ({rc})")
        prog.bodies += 1


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
