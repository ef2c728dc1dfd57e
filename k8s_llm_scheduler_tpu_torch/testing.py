"""Synthetic clusters, fixture pods and an async deadline for tests, the
chip smoke and `cli demo`.

`clear_prefix_cache`, `tear_next_swap`, `cached_prefix_kv`,
`scribble_prefix` and `swap_to_own_weights` act on one tp rank's engine,
for a test to run on every rank through `RankGroup.on_ranks` (the
followers import them from here). `stop_at_next_admit` lands a watchdog
stop inside a resident loop's iteration.

`chunk_draws` runs the fused decode loop's sampling alone over constant
probabilities, on the CPU or captured on a card, for the tests and the chip
smoke to hold against the softmax. `cap_torch_threads` caps a test
process's torch threads.

`synthetic_nodes(n)` returns exactly the NodeMetrics that
`synthetic_cluster(n).get_node_metrics()` reports for a cluster with no pods
bound: node-i at load (i * 37 % 90)% of 16 cores / 64 GB, 110 max pods,
zone label z(i % 4), Ready. `synthetic_cluster`, `pod_burst`,
`async_deadline` and `fixture_raw_pods` are copies of the JAX package's
testing.py (`fixture_raw_pods` is its `fixture_pods`: the reference's three
graduated nginx pods, as RawPods); `fixture_pods(n)` here returns PodSpecs.

`LockOrderSanitizer` (with `LockOrderViolation` and `_SanitizedLock`) is
the JAX module's text: the runtime half of the concurrency rules `cli lint`
checks. It wraps `threading.Lock` creation while installed, records the
cross-thread acquisition-order graph and reports order cycles and locks
held across an event-loop hop (`assert_clean`). Only this process's locks
are wrapped: a tp group's followers are processes of their own.
"""

from __future__ import annotations

import asyncio
import threading

from k8s_llm_scheduler_tpu_torch.cluster.fake import FakeCluster, FakeNode
from k8s_llm_scheduler_tpu_torch.cluster.interface import RawPod
from k8s_llm_scheduler_tpu_torch.types import NodeMetrics, PodSpec

SCHEDULER_NAME = "ai-llama-scheduler"


class _Py310Deadline:
    """Minimal backport of the 3.11 timeout context manager: arm a timer
    that cancels the CURRENT task; translate the resulting CancelledError
    into TimeoutError iff this deadline (not an outer cancel) fired."""

    def __init__(self, seconds: float) -> None:
        self._seconds = seconds
        self._fired = False
        self._handle = None
        self._task = None

    async def __aenter__(self) -> "_Py310Deadline":
        self._task = asyncio.current_task()
        loop = asyncio.get_running_loop()
        self._handle = loop.call_later(self._seconds, self._on_timeout)
        return self

    def _on_timeout(self) -> None:
        self._fired = True
        if self._task is not None:
            self._task.cancel()

    async def __aexit__(self, exc_type, exc, tb) -> bool:
        if self._handle is not None:
            self._handle.cancel()
        if self._fired:
            if exc_type is asyncio.CancelledError:
                raise TimeoutError(
                    f"deadline of {self._seconds}s expired"
                ) from exc
            if exc_type is None:
                # Timer fired in the gap between the block's last await and
                # exit: the task.cancel() is still pending and would escape
                # as a bare CancelledError at the caller's NEXT await.
                # Absorb it at a checkpoint here and report the expiry
                # (3.11's native timeout resolves this boundary the same
                # way, via Task.uncancel bookkeeping).
                try:
                    await asyncio.sleep(0)
                except asyncio.CancelledError:
                    raise TimeoutError(
                        f"deadline of {self._seconds}s expired"
                    ) from None
        return False


# torch's intra-op threads in a test process (cap_torch_threads).
TEST_TORCH_THREADS = 2


def cap_torch_threads() -> None:
    """Cap torch's intra-op thread pool at TEST_TORCH_THREADS (never raise
    it). Each test process (an xdist worker among several) otherwise sizes
    its pool to every core of the machine, beside the JAX CPU backend's
    own, and the workers oversubscribe the cores. The port's test files
    call this when they are imported."""
    import torch

    if torch.get_num_threads() > TEST_TORCH_THREADS:
        torch.set_num_threads(TEST_TORCH_THREADS)


def async_deadline(seconds: float):
    """``async with async_deadline(30): ...`` — bound an async block's wall
    time. Python 3.11+'s native scoped timeout when available (it handles
    nested-cancellation bookkeeping via Task.uncancel); a call_later-based
    shim with the same raise-TimeoutError contract on 3.10."""
    native = getattr(asyncio, "timeout", None)  # 3.11+
    if native is not None:
        return native(seconds)
    return _Py310Deadline(seconds)


# ------------------------------------------------------------------------
# Runtime lock-order sanitizer
# ------------------------------------------------------------------------


class LockOrderViolation(AssertionError):
    """A lock-discipline violation observed at runtime (order cycle or a
    lock held across an event-loop hop)."""


class _SanitizedLock:
    """Drop-in wrapper around a real `_thread.lock` that reports acquire/
    release events to its sanitizer. Identity for the order graph is the
    CREATION SITE (file:line), not the instance — two instances of the
    same class's `self._lock` are one graph node, so an ABBA cycle between
    two objects of the same class is still a cycle."""

    __slots__ = ("_real", "_san", "site", "_holder")

    def __init__(self, real, sanitizer: "LockOrderSanitizer", site: str) -> None:
        self._real = real
        self._san = sanitizer
        self.site = site
        # ident of the thread currently holding this lock (None when free
        # or released cross-thread) — lets the sanitizer purge hand-off
        # residue from the acquirer's held stack (see _note_acquire)
        self._holder: int | None = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._real.acquire(blocking, timeout)
        if got:
            self._holder = threading.get_ident()
            self._san._note_acquire(self)
        return got

    def release(self) -> None:
        self._san._note_release(self)
        self._holder = None
        self._real.release()

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def _at_fork_reinit(self) -> None:  # threading internals call this
        self._real._at_fork_reinit()

    def __repr__(self) -> str:
        return f"<SanitizedLock {self.site} {self._real!r}>"


class LockOrderSanitizer:
    """Wrap `threading.Lock` creation; record the acquisition graph; fail
    on cycles and on locks held across an event-loop hop.

    Checks (both are the runtime twin of a graftlint rule):

    - **order cycle**: edge A->B is recorded when a thread acquires B
      while holding A. A cycle in that graph is a latent deadlock even if
      this run's interleaving never wedged — exactly the class the test
      suite can only catch probabilistically.
    - **event-loop hop**: acquiring a threading lock on a loop thread and
      holding it across a loop iteration (detected via a patched
      `asyncio.events.Handle._run` tick counter: if the loop ran any
      OTHER callback between acquire and release, the holder suspended
      mid-critical-section — the runtime shape of `lock-across-await`).

    Violations are recorded, not raised at the fault site (raising inside
    arbitrary third-party acquire paths corrupts the code under test);
    `assert_clean()` — which the pytest fixture calls at teardown —
    raises LockOrderViolation with every observation.

    Scope: only locks CREATED while installed are tracked (the fixture
    installs before the test body, so objects the test builds are
    covered); `threading.RLock` is left alone (logging and interpreter
    internals). Use as a context manager, or install()/uninstall()."""

    def __init__(self) -> None:
        self._orig_lock = None
        self._orig_handle_run = None
        self._meta = threading.Lock()  # guards graph/violations (real lock)
        self._tls = threading.local()
        self.edges: dict[str, set[str]] = {}
        self.edge_where: dict[tuple[str, str], str] = {}
        self.violations: list[str] = []
        self.locks_created = 0

    # ------------------------------------------------------------ lifecycle
    def install(self) -> "LockOrderSanitizer":
        if self._orig_lock is not None:
            raise RuntimeError("sanitizer already installed")
        self._orig_lock = threading.Lock
        sanitizer = self

        def make_lock():
            sanitizer.locks_created += 1
            return _SanitizedLock(
                sanitizer._orig_lock(), sanitizer, sanitizer._creation_site()
            )

        threading.Lock = make_lock  # type: ignore[assignment]

        # Event-loop tick counter: every callback the loop runs bumps the
        # per-thread counter, so "held across a hop" is a counter delta.
        handle_cls = asyncio.events.Handle
        self._orig_handle_run = handle_cls._run
        orig_run = self._orig_handle_run

        def counting_run(handle_self):
            tls = sanitizer._tls
            tls.loop_ticks = getattr(tls, "loop_ticks", 0) + 1
            return orig_run(handle_self)

        handle_cls._run = counting_run  # type: ignore[assignment]
        return self

    def uninstall(self) -> None:
        if self._orig_lock is None:
            return
        threading.Lock = self._orig_lock  # type: ignore[assignment]
        asyncio.events.Handle._run = self._orig_handle_run  # type: ignore
        self._orig_lock = None
        self._orig_handle_run = None

    def __enter__(self) -> "LockOrderSanitizer":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # ------------------------------------------------------------ recording
    @staticmethod
    def _creation_site() -> str:
        """file:line of the threading.Lock() caller — skipping any frames
        from THIS module, so stacked sanitizers (suite-wide autouse plus
        an explicit fixture: the inner factory calls the outer factory)
        still attribute every lock to its real creation site instead of
        collapsing all locks onto one make_lock line (which would zero
        out edge recording — edges require distinct sites)."""
        import sys

        frame = sys._getframe(1)
        while frame is not None and frame.f_code.co_filename == __file__:
            frame = frame.f_back
        if frame is None:  # pragma: no cover - interpreter-internal caller
            return "<unknown>:0"
        # last TWO path components: two files sharing a basename AND a
        # line number must not collapse into one graph node (a collision
        # could weld unrelated locks together and report a false cycle)
        tail = "/".join(frame.f_code.co_filename.rsplit("/", 2)[-2:])
        return f"{tail}:{frame.f_lineno}"

    def _held(self) -> list:
        stack = getattr(self._tls, "held", None)
        if stack is None:
            stack = self._tls.held = []
        return stack

    def _loop_running_here(self) -> bool:
        try:
            asyncio.get_running_loop()
            return True
        except RuntimeError:
            return False

    def _note_acquire(self, lock: _SanitizedLock) -> None:
        held = self._held()
        # Purge hand-off residue: a lock acquired HERE but released on
        # another thread keeps its stack entry (the releasing thread's
        # _note_release can't see this stack). Its _holder is by then
        # None or another thread — treating it as still-held would record
        # phantom edges and manufacture false cycles.
        me = threading.get_ident()
        if held:
            held[:] = [e for e in held if e[0]._holder == me]
        tick = (
            getattr(self._tls, "loop_ticks", 0)
            if self._loop_running_here() else None
        )
        new_edges = [
            (h.site, lock.site) for h, _t in held if h.site != lock.site
        ]
        held.append((lock, tick))
        if not new_edges:
            return
        with self._meta:
            for a, b in new_edges:
                if b in self.edges.setdefault(a, set()):
                    continue
                self.edges[a].add(b)
                self.edge_where[(a, b)] = threading.current_thread().name
                cycle = self._find_path(b, a)
                if cycle is not None:
                    self.violations.append(
                        "lock-order cycle: "
                        + " -> ".join([a] + cycle)
                        + f" (edge {a} -> {b} closed the cycle on thread "
                        f"{threading.current_thread().name}; a cross-thread "
                        f"interleaving of these acquisitions deadlocks)"
                    )

    def _find_path(self, src: str, dst: str) -> list[str] | None:
        """DFS path src -> ... -> dst in the edge graph (caller holds
        _meta). Returns the node list after src, or None."""
        seen = set()
        stack: list[tuple[str, list[str]]] = [(src, [src])]
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in self.edges.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None

    def _note_release(self, lock: _SanitizedLock) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                _l, tick = held.pop(i)
                if tick is not None:
                    now = getattr(self._tls, "loop_ticks", 0)
                    if now != tick:
                        with self._meta:
                            self.violations.append(
                                f"lock {lock.site} was held across an "
                                f"event-loop hop ({now - tick} other "
                                f"callback(s) ran on the loop while it was "
                                f"held) — a threading lock in a coroutine "
                                f"must not span an await"
                            )
                return
        # release of a lock acquired before install (or on another
        # thread's stack for hand-off patterns): not ours to judge

    # ------------------------------------------------------------ reporting
    def assert_clean(self) -> None:
        if self.violations:
            raise LockOrderViolation(
                f"{len(self.violations)} lock-discipline violation(s):\n"
                + "\n".join(f"  - {v}" for v in self.violations)
            )


def synthetic_nodes(
    n_nodes: int = 3,
    cpu_cores: float = 16.0,
    memory_gb: float = 64.0,
    max_pods: int = 110,
    load_spread: bool = True,
) -> list[NodeMetrics]:
    """n nodes at varied synthetic load levels."""
    out = []
    for i in range(n_nodes):
        load = float(i * 37 % 90) if load_spread else 0.0
        out.append(
            NodeMetrics(
                name=f"node-{i}",
                cpu_usage_percent=load,
                memory_usage_percent=load,
                available_cpu_cores=cpu_cores,
                available_memory_gb=memory_gb,
                pod_count=0,
                max_pods=max_pods,
                labels={"zone": f"z{i % 4}"},
                taints=(),
                conditions={"Ready": "True"},
            )
        )
    return out


def fixture_pods(n: int = 8) -> list[PodSpec]:
    """n pending pods of varied shape: small web pods, memory-heavy caches,
    compute and high-priority batch jobs. None carries a selector, so every
    node of synthetic_nodes is feasible for each — the decision grammar
    covers every ready node, and any name it emits is a feasible one."""
    shapes = (
        dict(cpu_request=0.5, memory_request=0.5),
        dict(cpu_request=2.0, memory_request=8.0),
        dict(cpu_request=1.0, memory_request=2.0),
        dict(cpu_request=4.0, memory_request=16.0, priority=100),
        dict(cpu_request=0.25, memory_request=0.25),
        dict(cpu_request=8.0, memory_request=4.0),
        dict(cpu_request=1.5, memory_request=3.0),
        dict(cpu_request=3.0, memory_request=24.0, priority=10),
    )
    names = ("web", "cache", "api", "batch", "sidecar", "compute", "worker", "etl")
    return [
        PodSpec(
            name=f"{names[i % len(names)]}-{i}",
            namespace="default",
            **shapes[i % len(shapes)],
        )
        for i in range(n)
    ]


def fixture_raw_pods(scheduler_name: str = SCHEDULER_NAME) -> list[RawPod]:
    """The reference's 3 graduated nginx test pods (ai-test-pods.yaml)."""
    shapes = [
        ("ai-test-pod-1", "100m", "128Mi"),
        ("ai-test-pod-2", "250m", "256Mi"),
        ("ai-test-pod-3", "500m", "512Mi"),
    ]
    return [
        RawPod(
            name=name,
            namespace="default",
            scheduler_name=scheduler_name,
            container_requests=({"cpu": cpu, "memory": mem},),
        )
        for name, cpu, mem in shapes
    ]


def synthetic_cluster(
    n_nodes: int = 3,
    cpu_cores: float = 16.0,
    memory_gb: float = 64.0,
    max_pods: int = 110,
    load_spread: bool = True,
) -> FakeCluster:
    """A FakeCluster with n nodes at varied synthetic load levels."""
    cluster = FakeCluster()
    for i in range(n_nodes):
        load = (i * 37 % 90) if load_spread else None
        cluster.add_node(
            FakeNode(
                name=f"node-{i}",
                cpu_capacity_cores=cpu_cores,
                memory_capacity_gb=memory_gb,
                max_pods=max_pods,
                cpu_usage_percent=float(load) if load is not None else None,
                memory_usage_percent=float(load) if load is not None else None,
                labels={"zone": f"z{i % 4}"},
            )
        )
    return cluster


def pod_burst(
    n_pods: int,
    scheduler_name: str = SCHEDULER_NAME,
    distinct_shapes: int = 8,
) -> list[RawPod]:
    """A burst of pending pods with `distinct_shapes` resource shapes.

    distinct_shapes controls the decision-cache hit rate: a 1000-pod burst
    with 8 shapes means ~992 decisions are cache-servable, which mirrors real
    bursts (replicas of few deployments) and the reference's cache-key
    equivalence design (scheduler.py:265-271).
    """
    pods = []
    for i in range(n_pods):
        shape = i % distinct_shapes
        cpu_m = 100 + 50 * shape
        mem_mi = 128 * (1 + shape % 4)
        pods.append(
            RawPod(
                name=f"burst-pod-{i}",
                namespace="default",
                scheduler_name=scheduler_name,
                container_requests=({"cpu": f"{cpu_m}m", "memory": f"{mem_mi}Mi"},),
                priority=shape % 3,
            )
        )
    return pods


def chunk_draws(device: str = "cpu", *, slots: int = 64, steps: int = 16,
                replays: int = 16, vocab: int = 32, temperature: float = 1.0,
                seed: int = 0) -> dict:
    """The fused loop's sampling with probabilities that stay constant: a
    chunk of `steps` steps, each sampling every slot with `sample_fused`
    from its row of the chunk's uniforms (engine/fused/loop.py
    `fused_draw` / `step_uniforms`), as a GraphRunner program (on a card a
    CUDA graph whose steps are one WHILE node), run `replays` times.

    Returns the draws' total variation from the softmax (`tv`), the share
    of draws equal to their slot's draw at step 0 of the same run
    (`repeat`, the chance of which for independent draws is `repeat_want`,
    the sum of the squared probabilities), the steps run and replays."""
    import torch

    from k8s_llm_scheduler_tpu_torch.engine.fused.loop import fused_draw, step_uniforms
    from k8s_llm_scheduler_tpu_torch.engine.fused.sampler import sample_fused
    from k8s_llm_scheduler_tpu_torch.engine.graphs import GraphRunner

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    runner = GraphRunner(dev, True, generator=gen)
    base = torch.randn(vocab, generator=torch.Generator().manual_seed(seed)) * 0.5
    logits = base.to(dev).expand(slots, vocab).contiguous()
    st = torch.zeros(slots, dtype=torch.int32, device=dev)
    table = torch.zeros((1, vocab), dtype=torch.int32, device=dev)
    act = torch.ones(slots, dtype=torch.bool, device=dev)
    budget = torch.full((slots,), steps, dtype=torch.int32, device=dev)
    toks = torch.zeros((slots, steps), dtype=torch.int32, device=dev)

    class Buf:
        u = torch.zeros((steps, slots), dtype=torch.float32, device=dev)
        j = torch.zeros((), dtype=torch.int64, device=dev)

    def step() -> None:
        tok, _ = sample_fused(logits, st, table, gen, temperature, 0, False, vocab,
                              u=step_uniforms(Buf, temperature))
        toks.index_copy_(1, Buf.j.view(1), tok[:, None])
        Buf.j.add_(1)

    def chunk() -> None:
        Buf.j.zero_()
        fused_draw(Buf, gen, temperature)
        runner.while_live(act, budget, step, Buf.j, steps)

    prog = runner.program("chunk draws", chunk)
    runs, steps_run = [], []
    for _ in range(replays):
        prog.run()
        runs.append(toks.clone())
        steps_run.append(Buf.j.clone())
    draws = torch.stack(runs).cpu()  # [replays, slots, steps]
    want = torch.softmax(base / temperature, dim=-1).double()
    got = torch.bincount(draws.flatten().long(), minlength=vocab).double() / draws.numel()
    return {
        "tv": float(0.5 * (got - want).abs().sum()),
        "repeat": float((draws[..., 1:] == draws[..., :1]).double().mean()),
        "repeat_want": float((want * want).sum()),
        "steps_run": [int(n) for n in torch.stack(steps_run).cpu()],
        "replays": runner.replays,
        "draws": draws.numel(),
    }


def clear_prefix_cache(engine) -> None:
    """Drop this rank's prefix cache and pins (what an adoption then has
    to restore without a prefill)."""
    engine._await_dispatch()
    engine._prefix_cache.clear()
    engine._pinned_prefix_keys.clear()
    engine._prefix = None


def tear_next_swap(engine, ranks: list[int]) -> None:
    """On the tp ranks in `ranks`, make the next swap_params copy half of
    the leaves, then raise OSError: a read error part way through a donate
    restore."""
    if engine.plane.rank not in ranks:
        return

    def torn(params):
        del engine.swap_params  # the next call is the real one again
        pairs = []

        def walk(dst, src):
            if isinstance(dst, dict):
                for key in sorted(dst):
                    walk(dst[key], src[key])
            else:
                pairs.append((dst, src))

        walk(engine.params, params)
        for dst, src in pairs[: len(pairs) // 2]:
            dst.copy_(src)
        raise OSError("read error half way through the candidate")

    engine.swap_params = torn


def cached_prefix_kv(engine, key: tuple[int, ...]):
    """CPU copies of this rank's cached (k, v) of `key`, or None."""
    engine._await_dispatch()
    pfx = engine._prefix_cache.get(tuple(key))
    return None if pfx is None else (pfx.k.cpu().clone(), pfx.v.cpu().clone())


def scribble_prefix(engine, key: tuple[int, ...], value: float) -> None:
    """Write `value` over this rank's cached KV of `key`, in place."""
    engine._await_dispatch()
    pfx = engine._prefix_cache[tuple(key)]
    pfx.k.fill_(value)
    pfx.v.fill_(value)


def swap_to_own_weights(engine) -> None:
    """Swap this rank to the weights it serves: no weight changes, but the
    prefix cache clears and prefix_epoch bumps, as after any swap."""
    engine.swap_params(engine.params)


def stop_at_next_admit(server) -> None:
    """Make the resident loop of `server` (engine/persistent/server.py) meet
    the watchdog's stop right after it takes the next ADMIT off its command
    ring, before it runs it."""
    from k8s_llm_scheduler_tpu_torch.engine.persistent.ring import OP_ADMIT

    take = server.commands.take

    def take_then_stop():
        cmd = take()
        if cmd is not None and cmd.op == OP_ADMIT:
            server.force_stop()
        return cmd

    server.commands.take = take_then_stop

