"""Process groups, the spawn of a tp group's followers, and the mirror that
keeps their engines in step with the driver's.

The JAX package serves tensor parallel from one controller: XLA places the
shards and inserts the collectives. PyTorch runs one process per rank, so
this module makes the process model explicit:

- One process per rank. Rank 0 of a host's tp group is its DRIVER: it owns
  the engine's public API, the backend and (on the coordinator host) the
  control plane. The other ranks are FOLLOWERS, spawned by the driver as
  fresh interpreters (`start_followers`), each building the same engine
  over its own shard (`follower_main`).
- Followers mirror the driver's engine calls (`RankGroup.mirror`): every
  state-changing public call is broadcast as (name, args) on a CPU gloo
  group before the driver makes it, and each follower makes the same call
  on its engine. Every rank then runs the same host logic on the same
  gathered logits and samples the same tokens from a generator seeded the
  same way. A grammar's tables cross once, with the set_grammar call that
  installs them.
- Collectives. A serving tp group issues only all_reduce (sum) and
  broadcast; a training mesh also all-gathers, reduce-scatters and
  permutes around a ring (`AxisGroup`; the differentiable forms are in
  parallel/collectives.py). Over gloo a CUDA tensor goes through pinned
  host buffers, so no gloo op is handed a device tensor. The backend is
  chosen by a fixed rule (`choose_backend`): NCCL when every rank of the
  group has a CUDA device of its own, gloo on the CPU and when ranks share
  a device.
- Training (`run_spmd`): every rank of the mesh runs the same function,
  the driver as rank 0 of its host and one spawned interpreter for each
  other local rank; there is no engine and no mirror.
- Ordering. The driver holds one lock across each mirrored call, so the
  followers see the calls in the order the driver makes them, and within
  an engine the dispatcher thread and `_await_dispatch` order the model
  calls, so each rank issues its collectives in the driver's order.
- The prefix-KV plane's `d2d` pages (fleet/kvplane/pages.py). At tp > 1
  each rank keeps its block of an exported entry in an export table of
  its own and hands out a handle another process can open (parallel/
  ipc.py); an adopting group's rank r copies the filler's rank-r block
  from it. The driver's ExportBook says when a block may go: once the page
  set is collected, or once the filler's prefix_epoch moved past it, and
  never while an adoption holds it. The group releases such blocks on
  every rank before and after each of its own calls, under its lock
  (never from a finalizer, which may run while another group's lock is
  held).
- Failure. Every group has a timeout. After every mirrored call the ranks
  settle (`Control.settle`): each says whether its call raised, and when
  every call raised, how many tp collectives its engine has issued. The
  group stays up when every rank's call returned, or when every rank's
  raised with the same count (a call refused before it touched the group).
  Anything else leaves the ranks out of step (a collective one rank issued
  and another never will, so the next ones would pair the wrong partials):
  the followers exit non-zero, and the driver raises and shuts the group
  down; every later mirrored call raises at once. A follower that dies
  makes the driver's next collective or settle raise.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import logging
import os
import pickle
import sys
import threading
import time
import traceback
from typing import Any, Callable

import torch

logger = logging.getLogger(__name__)

GROUP_TIMEOUT_S = 120.0  # a tp group's collective timeout
# A follower waits for the driver's next call for as long as the driver
# lives (a serving replica idles for hours); the driver's death closes the
# channel's connections, which ends the wait at once.
CONTROL_TIMEOUT_S = 365 * 24 * 3600.0
START_TIMEOUT_S = 900.0  # followers' engine builds (an 8B shard from a seed)
EXIT_GRACE_S = 2.0  # a failed settle's wait for a dying follower's exit code

# The engine calls a driver mirrors to its followers: every public call
# that changes engine state or runs the model. Reads (get_stats,
# free_slots, ...) stay local.
MIRRORED_CALLS = (
    "set_grammar", "set_prefix", "pin_prefix", "unpin_prefix",
    "submit_wave", "harvest_wave", "decide_wave", "prewarm_wave_siblings",
    "add_request", "add_requests", "admit_packed",
    "step", "step_fused", "decode_fused", "generate",
    "enter_persistent", "exit_persistent", "export_prefix_kv",
    "release_slot", "abort_all", "close", "release",
)


def choose_backend(devices: list[int | None]) -> str:
    """The collective backend of a group whose ranks run on `devices` (CUDA
    device indices, None for the CPU): NCCL when every rank has a CUDA
    device of its own, gloo otherwise (the CPU, or ranks sharing a card,
    which NCCL refuses)."""
    if any(d is None for d in devices) or len(set(devices)) < len(devices):
        return "gloo"
    return "nccl"


def new_process_group(store, rank: int, size: int, backend: str, timeout_s: float):
    """A process group of `size` ranks over `store` (a PrefixStore private
    to the group), without touching torch.distributed's default group: a
    process may hold several (a test, two engines)."""
    from torch import distributed as dist

    timeout = datetime.timedelta(seconds=timeout_s)
    if backend == "gloo":
        return dist.ProcessGroupGloo(store, rank, size, timeout)
    opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = timeout
    return dist.ProcessGroupNCCL(store, rank, size, opts)


class AxisGroup:
    """One rank's process group along one mesh axis (or several: the ranks
    that share every other coordinate). Counts the collectives it issued
    (`ops`; a follower tells a call that failed before touching the group
    from one that failed halfway), each kind's count (`counts`) and the
    bytes this rank handed to them (`sent`)."""

    def __init__(self, pg, rank: int, size: int, backend: str, ranks: list[int]) -> None:
        self.pg, self.rank, self.size = pg, rank, size
        self.backend, self.ranks = backend, ranks
        self.ops = 0
        self.counts: dict[str, int] = {}
        self.sent = 0
        # gloo on CUDA tensors: pinned host buffers by (role, shape, dtype)
        self._staging: dict[tuple, torch.Tensor] = {}

    @classmethod
    def for_mesh(cls, mesh, axis, *, tag: str = "", backend: str | None = None,
                 timeout_s: float | None = None) -> "AxisGroup":
        """This rank's group along `axis`. A `tag` makes another group over
        the same ranks, every member creating it at the same point: the
        resident loop's own tp group, and its command channel (gloo, with
        the control channel's timeout)."""
        from torch.distributed import PrefixStore

        ranks = mesh.axis_ranks(axis)
        backend = backend or choose_backend([mesh.local_device_index(r) for r in ranks])
        name = (axis if isinstance(axis, str) else "+".join(axis)) + (f"#{tag}" if tag else "")
        store = PrefixStore(f"{mesh.prefix}group/{name}/{'-'.join(map(str, ranks))}",
                            mesh.store)
        pg = new_process_group(store, ranks.index(mesh.rank), len(ranks), backend,
                               mesh.timeout_s if timeout_s is None else timeout_s)
        logger.info("rank %d: %s group %s over %s", mesh.rank, name, ranks, backend)
        return cls(pg, ranks.index(mesh.rank), len(ranks), backend, ranks)

    def _book(self, kind: str, t: torch.Tensor) -> None:
        self.ops += 1
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.sent += t.numel() * t.element_size()

    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.backend == "gloo"

    def _host(self, role: str, shape, dtype) -> torch.Tensor:
        key = (role, tuple(shape), dtype)
        host = self._staging.get(key)
        if host is None:
            host = self._staging[key] = torch.empty(shape, dtype=dtype, pin_memory=True)
        return host

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the group, in place. Over gloo a CUDA tensor goes
        through a pinned host buffer of its shape: one copy each way around
        gloo's CPU all-reduce."""
        self._book("all_reduce", t)
        return self._reduce(t)

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        if not self._staged(t):
            self.pg.allreduce([t]).wait()
            return t
        host = self._host("reduce", t.shape, t.dtype)
        # the copy out waits for the stream, so it also waits for the last
        # copy back from this buffer (queued before it on the same stream)
        host.copy_(t)
        self.pg.allreduce([host]).wait()
        return t.copy_(host, non_blocking=True)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The group's tensors concatenated along `dim`, in rank order (a
        new tensor)."""
        self._book("all_gather", t)
        t = t.contiguous()
        if not self._staged(t):
            parts = [torch.empty_like(t) for _ in range(self.size)]
            self.pg.allgather([parts], [t]).wait()
            return torch.cat(parts, dim)
        host = self._host("gather_in", t.shape, t.dtype)
        host.copy_(t)
        parts = [self._host(f"gather_out{i}", t.shape, t.dtype) for i in range(self.size)]
        self.pg.allgather([parts], [host]).wait()
        return torch.cat([p.to(t.device, non_blocking=True) for p in parts], dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block along `dim` of `t` summed over the group (a new
        tensor). Gloo has no reduce-scatter of its own on every build, so
        there it is an all-reduce of a copy, narrowed; NCCL runs its own."""
        n = t.shape[dim]
        if n % self.size:
            raise ValueError(f"dim of {n} does not split over {self.size} ranks")
        block = n // self.size
        self._book("reduce_scatter", t)
        if self.backend == "gloo":
            total = self._reduce(t.contiguous().clone())
            return total.narrow(dim, self.rank * block, block).contiguous()
        parts = [p.contiguous() for p in t.split(block, dim)]
        out = torch.empty_like(parts[0])
        self.pg.reduce_scatter([out], [parts]).wait()
        return out

    def permute(self, t: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """JAX's ppermute around the group's ring: send `t` to rank + shift,
        return what rank - shift sent (a new tensor). Over NCCL even ranks
        send first and odd ranks receive first (a ring of even size)."""
        self._book("permute", t)
        t = t.contiguous()
        if self.size == 1 or shift % self.size == 0:
            return t.clone()
        dst, src = (self.rank + shift) % self.size, (self.rank - shift) % self.size
        staged = self._staged(t)
        out = self._host("recv", t.shape, t.dtype) if staged else torch.empty_like(t)
        if staged:
            send = self._host("send", t.shape, t.dtype)
            send.copy_(t)
        else:
            send = t
        if self.backend == "nccl" and self.rank % 2:
            self.pg.recv([out], src, 0).wait()
            self.pg.send([send], dst, 0).wait()
        else:
            sent = self.pg.send([send], dst, 0)
            self.pg.recv([out], src, 0).wait()
            sent.wait()
        return out.to(t.device, copy=True) if staged else out

    def gather_to_root(self, t: torch.Tensor, dim: int, root: int = 0) -> torch.Tensor | None:
        """The group's tensors concatenated along `dim` in rank order, on
        `root` alone, in host memory (pinned when `t` lies on a card); None
        on the other ranks. Over gloo a card's tensor crosses through a
        pinned host copy; NCCL gathers on the device, then the root copies
        out."""
        from torch.distributed import GatherOptions

        self._book("gather", t)
        t = t.contiguous()
        send, like = t, {"dtype": t.dtype, "device": t.device}
        if self._staged(t):
            like = {"dtype": t.dtype, "pin_memory": True}
            send = torch.empty(t.shape, **like).copy_(t)
        parts = ([torch.empty(t.shape, **like) for _ in range(self.size)]
                 if self.rank == root else [])
        opts = GatherOptions()
        opts.rootRank = root
        self.pg.gather([parts] if parts else [], [send], opts).wait()
        if not parts:
            return None
        shape = list(t.shape)
        shape[dim] *= self.size
        out = torch.empty(shape, dtype=t.dtype, pin_memory=t.is_cuda)
        return out.copy_(torch.cat(parts, dim))

    def scatter_from_root(self, blocks: list[torch.Tensor] | None, shape, dtype,
                          device: torch.device, root: int = 0) -> torch.Tensor:
        """Rank r's `blocks[r]` (host tensors of `shape`, given on `root`
        only) on every rank r: a new host tensor over gloo, a tensor on
        `device` over NCCL."""
        from torch.distributed import ScatterOptions

        opts = ScatterOptions()
        opts.rootRank = root
        if self.backend == "gloo":
            out = torch.empty(shape, dtype=dtype)
            inputs = [[b.cpu().contiguous() for b in blocks]] if self.rank == root else []
        else:
            out = torch.empty(shape, dtype=dtype, device=device)
            inputs = ([[b.to(device).contiguous() for b in blocks]]
                      if self.rank == root else [])
        self._book("scatter", out)
        self.pg.scatter([out], inputs, opts).wait()
        return out

    def broadcast(self, t: torch.Tensor, root: int = 0) -> torch.Tensor:
        """`root`'s `t` on every rank, in place (a CPU tensor)."""
        from torch.distributed import BroadcastOptions

        opts = BroadcastOptions()
        opts.rootRank, opts.rootTensor = root, 0
        self._book("broadcast", t)
        self.pg.broadcast([t], opts).wait()
        return t


class Control:
    """The driver-to-followers channel of one host's tp group: pickled
    messages broadcast on a CPU gloo group of their own, so a message never
    queues behind the model's collectives, and a second group the ranks
    settle each call on. A rank reaches the settle at most one collective
    timeout after another (the call that raised first leaves its peers
    waiting in a collective until that times out), so the settle waits
    twice that and a minute."""

    def __init__(self, store, rank: int, size: int, timeout_s: float) -> None:
        from torch.distributed import PrefixStore

        ranks = list(range(size))
        self.group = AxisGroup(
            new_process_group(PrefixStore("control", store), rank, size, "gloo",
                              CONTROL_TIMEOUT_S),
            rank, size, "gloo", ranks)
        self.status = new_process_group(PrefixStore("status", store), rank, size, "gloo",
                                        2 * timeout_s + 60.0)

    def _max(self, values: list[int]) -> list[int]:
        from torch.distributed import AllreduceOptions, ReduceOp

        t = torch.tensor(values, dtype=torch.int64)
        opts = AllreduceOptions()
        opts.reduceOp = ReduceOp.MAX
        self.status.allreduce([t], opts).wait()
        return t.tolist()

    def settle(self, engine, failed: bool) -> bool:
        """After a mirrored call, on every rank of the group: True when the
        ranks are still in step (every call returned, or every call raised
        having issued the same tp collectives), False when they are not."""
        any_failed, any_ok = self._max([int(failed), int(not failed)])
        if not any_failed:
            return True
        if any_ok:
            return False
        # every call raised: once each dispatcher has drained, the ranks
        # are in step if each issued the same number of collectives
        try:
            engine._await_dispatch()
        except Exception:
            logger.exception("tp settle: the wave dispatcher did not drain")
        ops = engine.mesh.issued(engine.plane.tp_axis)
        most, least = self._max([ops, -ops])
        return most == -least

    def send(self, message) -> None:
        payload = torch.frombuffer(bytearray(pickle.dumps(message)), dtype=torch.uint8)
        self.group.broadcast(torch.tensor([payload.numel()], dtype=torch.int64))
        self.group.broadcast(payload)

    def recv(self):
        n = self.group.broadcast(torch.zeros(1, dtype=torch.int64))
        payload = self.group.broadcast(torch.empty(int(n[0]), dtype=torch.uint8))
        return pickle.loads(payload.numpy().tobytes())


@dataclasses.dataclass(frozen=True)
class _Ref:
    """A value a follower's own earlier call returned (a WaveHandle), named
    by that call's sequence number."""

    seq: int


_EXIT = "__exit__"
_FN = "__fn__"


def _is_handle(value) -> bool:
    return type(value).__name__ == "WaveHandle"


class ExportBook:
    """The driver's book of its group's live `d2d` exports (one a tp > 1
    page set, fleet/kvplane/pages.py), by export id: the prefix_epoch each
    was exported under and the adoptions holding it.

    An export is doomed once its page set is collected (`dropped`, which a
    finalizer calls: it appends to a deque and takes no lock) or once the
    filler's prefix_epoch moved past it; `releasable` hands the group the
    doomed ones no adoption holds, and an adoption may `hold` only an
    export that is neither doomed nor in a closed group's book."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._live: dict[int, list[int]] = {}  # id -> [prefix_epoch, holds]
        self._dropped: collections.deque[int] = collections.deque()
        self._doomed: set[int] = set()
        self._next = 0
        self.closed = False

    def open(self, epoch: int) -> int:
        """A new export's id, made under `epoch`."""
        with self._lock:
            export_id, self._next = self._next, self._next + 1
            self._live[export_id] = [epoch, 0]
            return export_id

    def dropped(self, export_id: int) -> None:
        """The export's page set is gone (a finalizer's call)."""
        self._dropped.append(export_id)

    def hold(self, export_id: int, epoch: int) -> bool:
        """Keep the export from release while an adoption copies it; False
        when it was released, is doomed, or the group is closed."""
        with self._lock:
            rec = self._live.get(export_id)
            if self.closed or rec is None or rec[0] != epoch or export_id in self._doomed:
                return False
            rec[1] += 1
            return True

    def unhold(self, export_id: int) -> None:
        with self._lock:
            self._live[export_id][1] -= 1

    def releasable(self, epoch: int) -> list[int]:
        """The doomed exports no adoption holds, forgotten here: the caller
        releases them on every rank."""
        with self._lock:
            while self._dropped:
                self._doomed.add(self._dropped.popleft())
            self._doomed.update(i for i, (e, _) in self._live.items() if e != epoch)
            ready = sorted(i for i in self._doomed if self._live.get(i, [0, 0])[1] == 0)
            for i in ready:
                self._doomed.discard(i)
                self._live.pop(i, None)
            return ready

    def live(self) -> list[int]:
        """The ids not yet released."""
        with self._lock:
            return sorted(self._live)

    def close(self) -> None:
        with self._lock:
            self.closed = True


class RankGroup:
    """The driver's side of its host's tp group: the followers' processes,
    the control channel, and the mirror over the driver's engine."""

    def __init__(self, mesh, procs: list, store, timeout_s: float) -> None:
        self.mesh, self.procs, self.store = mesh, procs, store
        self.timeout_s = timeout_s
        self.control = Control(store, 0, len(procs) + 1, timeout_s)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._seq = 0
        self._refs: dict[int, int] = {}  # id(returned handle) -> seq
        self.closed = False
        self.broken: str | None = None  # why the group went down, if it did
        self.scratch = None  # a TemporaryDirectory the group's files live in
        self.engine = None  # the driver's engine, once mirrored
        self.exports = ExportBook()  # the group's d2d page sets

    def inside(self) -> bool:
        """Whether this thread is inside a call the group mirrors."""
        return getattr(self._local, "inside", False)

    # ---------------------------------------------------------- liveness
    def check_followers(self) -> None:
        """Raise if a follower has exited."""
        for i, p in enumerate(self.procs, start=1):
            if p.exitcode is not None:
                raise RuntimeError(f"tp follower rank {i} exited with code {p.exitcode}")

    # ------------------------------------------------------------ mirror
    def mirror(self, engine) -> None:
        """Route `engine`'s MIRRORED_CALLS through the group: a call from
        outside the engine is broadcast first; calls it makes of itself are
        not (each follower's engine makes them too)."""
        self.engine = engine
        for name in MIRRORED_CALLS:
            setattr(engine, name, self._mirrored(name, getattr(engine, name)))
        engine.rank_group = self

    def _mirrored(self, name: str, fn: Callable) -> Callable:
        def call(*args, **kwargs):
            if self.inside():
                return fn(*args, **kwargs)
            return self._run(name, fn, args, kwargs)

        call.__name__ = name
        call.__doc__ = fn.__doc__
        return call

    def _run(self, name, fn, args, kwargs):
        out = self._call(name, fn, args, kwargs)
        if name == "release":
            self.shutdown()  # a released engine serves no more calls
        return out

    def _call(self, name, fn, args, kwargs):
        with self._lock:
            lost = any(p.exitcode is not None for p in self.procs)
            if name in ("close", "release") and (self.closed or lost):
                # the followers are gone (or going): closing and releasing
                # the driver's own engine still work
                return self._local_call(fn, args, kwargs)
            self._release_exports()
            seq = self._open(name)
            self.control.send((seq, name, self._wire(args), self._wire(kwargs), self._sync()))
            out = self._settled(name, lambda: self._local_call(fn, args, kwargs))
            if _is_handle(out):
                self._refs[id(out)] = seq
            self._release_exports()
            return out

    def _open(self, name: str) -> int:
        """The next call's sequence number, once the group can take it."""
        if self.broken is not None:
            raise RuntimeError(f"tp group is down ({self.broken}); {name} not served")
        if self.closed:
            raise RuntimeError(f"tp group is closed; {name} not served")
        try:
            self.check_followers()
        except RuntimeError as exc:
            self._break(str(exc))
            raise RuntimeError(f"tp group is down ({exc}); {name} not served") from None
        seq = self._seq
        self._seq += 1
        return seq

    def _settled(self, name: str, local: Callable):
        """Run the driver's side of a mirrored call and settle it with the
        followers: its result when the group is in step (its exception
        when every rank raised alike), else the group goes down and this
        raises."""
        error = None
        try:
            out = local()
        except Exception as exc:
            error = exc
        except BaseException:
            # the followers' calls go on to a settle this rank never makes
            self._break(f"{name} was interrupted on the driver")
            raise
        try:
            in_step = self.control.settle(self.engine, error is not None)
        except Exception as exc:
            reason = f"{name}: a follower did not settle ({type(exc).__name__}: {exc})"
            lost = self._exited(EXIT_GRACE_S)
            if lost:
                reason = f"{name}: tp follower rank {lost[0]} exited"
            self._break(reason)
            raise RuntimeError(f"tp group is down ({reason})") from (error or exc)
        if not in_step:
            reason = f"the ranks are out of step after {name}"
            self._break(reason)
            raise RuntimeError(f"tp group is down ({reason})") from error
        if error is not None:
            raise error
        return out

    def _exited(self, grace_s: float) -> list[int]:
        """The follower ranks that have exited, waiting up to `grace_s` for
        one to show: a settle that failed on a closed connection most often
        means a peer is dying, and its exit code comes a moment later."""
        deadline = time.monotonic() + grace_s
        while True:
            lost = [i for i, p in enumerate(self.procs, start=1) if p.exitcode is not None]
            if lost or time.monotonic() >= deadline:
                return lost
            time.sleep(0.01)

    def _local_call(self, fn, args, kwargs):
        """`fn` on the driver's engine; the calls it makes of the engine's
        own mirrored methods go straight through."""
        self._local.inside = True
        try:
            return fn(*args, **kwargs)
        finally:
            self._local.inside = False

    def _wire(self, value):
        if _is_handle(value):
            return _Ref(self._refs.pop(id(value)))
        if isinstance(value, (list, tuple)):
            return type(value)(self._wire(v) for v in value)
        if isinstance(value, dict):
            return {k: self._wire(v) for k, v in value.items()}
        return value

    def _sync(self):
        """What a follower matches before each call: the driver's resident
        loop state (InferenceEngine.persistent_sync)."""
        return self.engine.persistent_sync() if self.engine is not None else None

    def on_ranks(self, fn: Callable, *args, driver_kwargs: dict | None = None) -> list:
        """Run `fn(engine, *args)` on every rank of the group at once (`fn`
        a module-level function of this package: the followers import it)
        and return each rank's result, rank 0's first. Settled as a
        mirrored call is. `driver_kwargs` go to the driver's call alone
        (buffers that must not cross the control channel whole: the
        function hands each rank its share over the tp group)."""
        with self._lock:
            self._release_exports()
            out = self._on_ranks(fn, args, driver_kwargs)
            self._release_exports()
            return out

    def _on_ranks(self, fn: Callable, args: tuple, driver_kwargs: dict | None) -> list:
        seq = self._open(fn.__name__)
        self.control.send((seq, _FN, (fn, args), {}, self._sync()))
        out = [self._settled(fn.__name__, lambda: self._local_call(
            fn, (self.engine, *args), driver_kwargs or {}))]
        for rank in range(1, len(self.procs) + 1):
            key = f"result/{seq}/{rank}"
            self._wait_key(key)
            out.append(pickle.loads(self.store.get(key)))
        return out

    def _release_exports(self) -> None:
        """Under the lock: release on every rank the d2d exports the book
        says may go (ExportBook.releasable)."""
        if self.broken is not None or self.closed or self.engine is None:
            return
        ids = self.exports.releasable(self.engine.prefix_epoch)
        if ids:
            self._on_ranks(release_kv_exports, (ids,), None)

    def _wait_key(self, key: str) -> None:
        deadline = time.monotonic() + self.timeout_s
        while not self.store.check([key]):
            self.check_followers()
            if time.monotonic() > deadline:
                raise TimeoutError(f"no follower answer under {key} in {self.timeout_s} s")
            time.sleep(0.01)

    def shutdown(self, timeout_s: float = 60.0) -> None:
        """Tell the followers to exit and reap them (killing stragglers)."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
            if self.broken is None and all(p.exitcode is None for p in self.procs):
                try:
                    self.control.send((self._seq, _EXIT, (), {}, None))
                except Exception:  # a peer died meanwhile: reaped below
                    logger.exception("tp group: the exit message did not go out")
        self._reap(timeout_s)

    def _break(self, reason: str) -> None:
        """Take the group down (under the lock): the followers exit on
        their own, a straggler is killed."""
        logger.error("tp group is down: %s", reason)
        self.broken = reason
        self.closed = True  # graftlint: ok[unguarded-attr-write] — every caller (_open, _settled) holds self._lock
        self._reap(10.0)

    def _reap(self, timeout_s: float) -> None:
        self.exports.close()
        stop_followers(self.procs, timeout_s)
        self.mesh.close()
        if self.scratch is not None:
            self.scratch.cleanup()


def stop_followers(procs: list, timeout_s: float = 60.0) -> None:
    """Join `procs` for up to `timeout_s`, then kill what is left."""
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.exitcode is None:
            p.kill()
            p.join(10)


# ----------------------------------------------------------- rendezvous
def open_store(rendezvous: dict, size: int):
    """The store a group rendezvouses over: a FileStore at a path (one
    host) or the world's TCP store (parallel/distributed.py)."""
    from torch.distributed import FileStore

    if rendezvous["kind"] == "file":
        return FileStore(rendezvous["path"], size)
    from k8s_llm_scheduler_tpu_torch.parallel.distributed import connect_store

    return connect_store(rendezvous["address"], False)


def host_store(world_store, host_rank0: int):
    """The keys of one host's tp group (readiness, control, results),
    apart from every other host's in a shared world store."""
    from torch.distributed import PrefixStore

    return PrefixStore(f"host/{host_rank0}", world_store)


class Follower:
    """A follower rank's process: a fresh interpreter running this module
    (the "spawn" model: nothing of the driver's state or main module is
    inherited), with multiprocessing.Process's exitcode/join/kill."""

    def __init__(self, spec_path: str, rank: int) -> None:
        import subprocess

        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
        self.rank = rank
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "k8s_llm_scheduler_tpu_torch.parallel.launch",
             spec_path, str(rank)], env=env)

    @property
    def exitcode(self) -> int | None:
        return self.proc.poll()

    def join(self, timeout: float | None = None) -> None:
        import subprocess

        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            pass

    def kill(self) -> None:
        self.proc.kill()


def start_followers(spec: dict, followers: list[int], workdir: str) -> list[Follower]:
    """Start one process for each global rank in `followers`, each running
    follower_main(spec, rank); `spec` crosses in a file under `workdir`."""
    path = os.path.join(workdir, "follower_spec.pkl")
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    return [Follower(path, rank) for rank in followers]


def wait_ready(store, procs: list, ranks: list[int], timeout_s: float) -> None:
    """Wait until every follower built its engine, raising at once when one
    exits or reports a failure."""
    deadline = time.monotonic() + timeout_s
    pending = list(ranks)
    while pending:
        for p, rank in zip(procs, ranks):
            if rank in pending and store.check([f"ready/{rank}"]):
                pending.remove(rank)
                status = store.get(f"ready/{rank}").decode()
                if status != "ok":
                    raise RuntimeError(f"tp follower rank {rank} failed to start: {status}")
            elif rank in pending and p.exitcode is not None:
                raise RuntimeError(
                    f"tp follower rank {rank} exited with code {p.exitcode} while starting")
        if time.monotonic() > deadline:
            raise TimeoutError(f"tp followers {pending} not ready in {timeout_s} s")
        time.sleep(0.02)


def follower_main(spec: dict, rank: int) -> None:
    """A follower rank: build the engine over this rank's shard, then make
    every call the driver mirrors until it says exit. Exits non-zero when a
    call fails after it issued a collective, or the channel breaks. A
    training follower (`spec["spmd"]`) runs the driver's function instead
    and exits."""
    threads = spec.get("torch_threads")
    if threads:
        torch.set_num_threads(int(threads))
    logging.basicConfig(level=spec.get("log_level", logging.WARNING))
    from k8s_llm_scheduler_tpu_torch.parallel.mesh import RankMesh

    mesh = RankMesh(spec["grid"], spec["axes"])
    mesh.prefix = spec.get("prefix", "")
    world_store = open_store(spec["rendezvous"], spec["group_size"])
    mesh.bind(world_store, rank, timeout_s=spec["timeout_s"],
              device_count=spec["device_count"], host_rank0=spec["host_rank0"])
    if "spmd" in spec:
        fn, kwargs = spec["spmd"]
        try:
            fn(mesh, **kwargs)
            code = 0
        except BaseException:
            traceback.print_exc()
            code = 1
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    from k8s_llm_scheduler_tpu_torch.engine.local import build_rank_engine

    store = host_store(world_store, spec["host_rank0"])
    local_rank = rank - spec["host_rank0"]
    try:
        engine = build_rank_engine(spec["engine"], mesh)
    except BaseException as exc:
        store.set(f"ready/{local_rank}", f"{type(exc).__name__}: {exc}")
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    store.set(f"ready/{local_rank}", "ok")
    control = Control(store, local_rank, spec["group_size"], spec["timeout_s"])
    code = _serve(engine, control, store, local_rank)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _serve(engine, control: Control, store, local_rank: int) -> int:
    refs: dict[int, Any] = {}

    def resolve(value):
        if isinstance(value, _Ref):
            return refs.pop(value.seq)
        if isinstance(value, (list, tuple)):
            return type(value)(resolve(v) for v in value)
        if isinstance(value, dict):
            return {k: resolve(v) for k, v in value.items()}
        return value

    while True:
        try:
            seq, name, args, kwargs, sync = control.recv()
        except Exception:
            traceback.print_exc()
            return 3  # the driver is gone
        if name == _EXIT:
            return 0
        out, error = None, None
        try:
            # the driver's resident loop state first: its harvests and its
            # own drains (engine/persistent/server.py's tp design)
            engine.follow_persistent(sync)
            if name == _FN:
                fn, fargs = args
                out = fn(engine, *fargs)
            else:
                out = getattr(engine, name)(*resolve(args), **resolve(kwargs))
        except Exception as exc:
            error = exc
        try:
            in_step = control.settle(engine, error is not None)
        except Exception:
            traceback.print_exc()
            return 3  # the driver or a peer is gone
        if not in_step:
            print(f"tp rank {local_rank}: out of step after {name}", file=sys.stderr)
            if error is not None:
                traceback.print_exception(error)
            return 1
        if error is not None:
            # every rank's call raised alike: the group goes on
            logger.info("mirrored %s raised on every rank", name, exc_info=error)
        elif name == _FN:
            store.set(f"result/{seq}/{local_rank}", pickle.dumps(out))
        elif _is_handle(out):
            refs[seq] = out


# ------------------------------------------------------ SPMD training
SPMD_TIMEOUT_S = 600.0  # a training mesh's collective timeout
_spmd_runs = 0  # run_spmd calls in this process: each host counts alike


def training_mesh(mesh_axes: dict | None):
    """The rank mesh of a training run's `llm.mesh`: one host's ranks, or
    across the rendezvoused hosts (parallel/distributed.py) dp and fsdp
    between hosts and tp and sp within each (the JAX package's rule,
    train/distill.py)."""
    from k8s_llm_scheduler_tpu_torch.parallel.distributed import multihost_mesh, world
    from k8s_llm_scheduler_tpu_torch.parallel.mesh import mesh_from_config

    if world() is None:
        return mesh_from_config(mesh_axes)
    axes = {k: int(v) for k, v in (mesh_axes or {}).items()}
    return multihost_mesh({k: v for k, v in axes.items() if k in ("dp", "fsdp")},
                          {k: v for k, v in axes.items() if k in ("tp", "sp")}
                          or {"tp": 1})


def run_spmd(mesh, fn: Callable, kwargs: dict, *, device, driver_kwargs: dict | None = None):
    """Run `fn(mesh, **kwargs)` on every rank of this host's share of
    `mesh` (an unbound RankMesh): this process is the host's first rank and
    spawns one fresh interpreter for each other (`fn` a module-level
    function of this package, `kwargs` picklable). The driver's own call
    also gets `driver_kwargs` (callbacks that stay in this process).
    Returns the driver's result once every follower has exited 0; raises
    when the driver's call does, or a follower exits non-zero (the others
    are stopped: they would wait in a collective)."""
    import tempfile

    from k8s_llm_scheduler_tpu_torch.parallel.distributed import world

    global _spmd_runs
    _spmd_runs += 1
    dev = torch.device(device)
    device_count = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and not device_count:
        raise RuntimeError("a CUDA training mesh needs a GPU (pass device='cpu' for the CPU)")
    w = world()
    tmp = tempfile.TemporaryDirectory(prefix="spmd-")
    if w is None:
        host_rank0, local = 0, mesh.size
        rendezvous = {"kind": "file", "path": os.path.join(tmp.name, "store")}
        store = open_store(rendezvous, local)
        prefix = ""
    else:
        host_rank0 = w.host_rank0
        local = sum(host_rank0 <= r < host_rank0 + w.ranks_per_process for r in mesh.ranks)
        rendezvous = {"kind": "tcp", "address": w.coordinator}
        store = w.store
        prefix = f"spmd/{_spmd_runs}/"
    mesh.prefix = prefix
    mesh.bind(store, host_rank0, timeout_s=SPMD_TIMEOUT_S, device_count=device_count,
              host_rank0=host_rank0)
    spec = {
        "grid": mesh.grid.tolist(), "axes": mesh.axis_names, "rendezvous": rendezvous,
        "group_size": local, "timeout_s": SPMD_TIMEOUT_S, "device_count": device_count,
        "host_rank0": host_rank0, "prefix": prefix, "spmd": (fn, kwargs),
        "torch_threads": torch.get_num_threads(),
        "log_level": logging.getLogger().level,
    }
    procs = start_followers(spec, [host_rank0 + i for i in range(1, local)], tmp.name)
    try:
        out = fn(mesh, **kwargs, **(driver_kwargs or {}))
        deadline = time.monotonic() + SPMD_TIMEOUT_S
        for i, p in enumerate(procs, start=1):
            p.join(max(0.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"training rank {host_rank0 + i} exited with code "
                                   f"{p.exitcode}")
        return out
    finally:
        stop_followers(procs, 5.0)
        mesh.close()
        tmp.cleanup()


def collective_book(mesh) -> dict:
    """{group name: {"counts": {kind: n}, "bytes": b}} of the collectives
    this rank issued on each of `mesh`'s groups."""
    return {(a if isinstance(a, str) else "+".join(a)): {"counts": dict(g.counts),
                                                         "bytes": g.sent}
            for a, g in mesh._groups.items()}


# ------------------------------------------------- functions for on_ranks
def launch_counts(engine) -> dict:
    """This rank's kernel wrappers' launch counts (K1-K4)."""
    from k8s_llm_scheduler_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_parts,
    )
    from k8s_llm_scheduler_tpu_torch.ops.prefix_attention import (
        flash_causal_attention_parts,
        flash_prefix_attention_parts,
    )
    from k8s_llm_scheduler_tpu_torch.ops.ragged_matmul import ragged_matmul

    return {"K1": flash_prefix_attention_parts.launches,
            "K2": flash_causal_attention_parts.launches,
            "K3": ragged_matmul.launches,
            "K4": paged_decode_attention_parts.launches + paged_decode_attention.launches}


def reset_launch_counts(engine) -> None:
    """Set this rank's kernel launch counts to 0."""
    from k8s_llm_scheduler_tpu_torch.ops import paged_attention, prefix_attention
    from k8s_llm_scheduler_tpu_torch.ops.ragged_matmul import ragged_matmul

    prefix_attention.reset_launch_counts()
    paged_attention.paged_decode_attention_parts.launches = 0
    paged_attention.paged_decode_attention.launches = 0
    ragged_matmul.launches = 0


def prefill_logits(engine, prompt_ids: list[int]) -> torch.Tensor:
    """The gathered logits [S, V] f32 (on the CPU) of one whole-prompt
    forward_prefill on this rank's shard: every rank issues the same
    collectives, so each returns the same logits."""
    from k8s_llm_scheduler_tpu_torch.models.llama import forward_prefill

    engine._await_dispatch()
    engine.drain_for_collectives()
    tokens = torch.tensor([prompt_ids], dtype=torch.int32, device=engine.device)
    lens = torch.tensor([len(prompt_ids)], dtype=torch.int32, device=engine.device)
    with torch.no_grad():
        logits, _, _ = forward_prefill(engine.params, engine.cfg, tokens, lens)
    return logits[0].cpu()


def prefix_kv(engine) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's active prefix KV ([L, Sp, n_kv_local, hd], CPU copies)."""
    pfx = engine._prefix
    return pfx.k[:, : pfx.length].cpu(), pfx.v[:, : pfx.length].cpu()


def peak_memory(engine) -> dict:
    """This rank's peak allocated and reserved device memory, in bytes."""
    if engine.device.type != "cuda":
        return {"peak_allocated": None, "peak_reserved": None}
    return {"peak_allocated": torch.cuda.max_memory_allocated(engine.device),
            "peak_reserved": torch.cuda.max_memory_reserved(engine.device)}


def loaded_packages(engine) -> list[str]:
    """The top-level packages this rank's process has imported."""
    return sorted({name.split(".")[0] for name in list(sys.modules)})


def engine_state(engine) -> dict:
    """This rank's weight generation and resident loop state: its
    prefix_epoch, swap and persistent books, whether the loop is resident
    or latched off after a wedge, and the token batches it harvested."""
    keys = ("weight_swaps", "persistent_launches", "persistent_admissions",
            "persistent_steps", "persistent_chunks", "persistent_wedges",
            "prefix_prefills", "adopted_prefixes", "pinned_prefixes")
    return {"prefix_epoch": engine.prefix_epoch,
            "persistent_active": engine.persistent_active,
            "persistent_wedged": engine._persistent_wedged,
            "harvested": engine._pers_harvested,
            "counters": engine.persistent_counter_totals(),
            **{k: engine.stats.get(k, 0) for k in keys}}


def param_ptrs(engine) -> list[int]:
    """The data_ptr of every leaf of this rank's serving tree, in walk
    order (a swap copies into them: they never move)."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key])
        else:
            out.append(node.data_ptr())

    walk(engine.params)
    return out


# ------------------------------------------- the hot swap, a rank at a time
def _any_rank(engine, failed: bool) -> bool:
    """Whether any rank of the tp group failed (one all-reduce: every rank
    calls it at the same point, so a failure on one rank alone is known to
    all and they raise alike)."""
    flag = torch.tensor([float(failed)], device=engine.device)
    return bool(engine.plane.group.all_reduce(flag).item() > 0)


def _rank_tree(engine, source: dict, model_config, device) -> dict:
    """This rank's block of the tree `source` names ({"checkpoint_path",
    "quantize", "seed"}: a safetensors checkpoint read a block at a time, a
    native one placed, or the seed's draw), shaped for the model's whole
    config, on `device`."""
    from k8s_llm_scheduler_tpu_torch.engine.local import rank_params

    return rank_params(source, model_config, engine.mesh, torch.device(device))


def stage_swap(engine, source: dict, model_config) -> None:
    """The `double` mode's load, outside the pause: a thread of this rank
    restores its block of `source` onto its own device while the rank goes
    on serving (the load issues no collective); install_swap joins it."""
    holder = {"tree": None, "error": None, "ms": 0.0}

    def load():
        t0 = time.perf_counter()
        try:
            holder["tree"] = _rank_tree(engine, source, model_config, engine.device)
            _sync_device(engine)
        except Exception as exc:  # raised on every rank by install_swap
            holder["error"] = exc
        holder["ms"] = (time.perf_counter() - t0) * 1000.0

    thread = threading.Thread(target=load, name="swap-stage", daemon=True)
    holder["thread"] = thread
    engine._swap_staging = holder
    thread.start()


def wait_staged(engine, timeout_s: float | None = None) -> bool:
    """Whether this rank's staging thread has finished (waiting up to
    `timeout_s`)."""
    holder = engine._swap_staging
    if holder is None:
        return False
    holder["thread"].join(timeout_s)
    return not holder["thread"].is_alive()


def install_swap(engine) -> dict:
    """The `double` mode's install, inside the pause: once every rank's
    block is staged, each copied into its rank's serving tensors
    (engine.swap_params). When any rank's load failed, every rank drops
    its staged block and raises, its serving weights untouched."""
    holder, engine._swap_staging = engine._swap_staging, None
    if holder is None:
        raise RuntimeError("install_swap without a staged tree (stage_swap first)")
    engine._await_dispatch()
    holder["thread"].join()
    error = holder["error"]
    if _any_rank(engine, error is not None):
        raise error or RuntimeError("the swap's restore failed on another tp rank")
    t0 = time.perf_counter()
    engine.swap_params(holder["tree"])
    _sync_device(engine)
    return {"load_ms": holder["ms"], "install_ms": (time.perf_counter() - t0) * 1000.0,
            "bytes": _tree_bytes(holder["tree"])}


def donate_swap(engine, source: dict, model_config, prior: dict | None) -> dict:
    """The `donate` mode, inside the pause: this rank's block of `source`
    restored to host memory and copied straight into the serving tensors.
    When any rank failed (a read error, or a copy torn part way), every
    rank re-restores `prior` into the same tensors and raises: no rank is
    left on mixed weights or on weights the others do not serve."""
    engine._await_dispatch()
    t0 = time.perf_counter()
    error = None
    try:
        engine.swap_params(_rank_tree(engine, source, model_config, "cpu"))
        _sync_device(engine)
    except Exception as exc:
        error = exc
    if _any_rank(engine, error is not None):
        if prior is not None:
            engine.swap_params(_rank_tree(engine, prior, model_config, "cpu"))
        raise error or RuntimeError("the donate swap failed on another tp rank")
    return {"install_ms": (time.perf_counter() - t0) * 1000.0}


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return int(tree.numel() * tree.element_size())


def _sync_device(engine) -> None:
    if engine.device.type == "cuda":
        from k8s_llm_scheduler_tpu_torch.engine.graphs import DEVICE_WIDE

        with DEVICE_WIDE:
            torch.cuda.synchronize(engine.device)


# ------------------------------------------- the prefix-KV plane's adoption
def adopt_head_blocks(engine, prompt_ids: list[int], shape: tuple, k=None, v=None):
    """Adopt a whole-model page set on every rank: the driver holds `k`
    and `v` ([L, cap, n_kv, hd], the model's kv heads) and hands each rank
    its contiguous block of heads over the tp group; each rank copies its
    block into a buffer of its own (InferenceEngine.adopt_prefix_pages)."""
    return engine._adopt_head_blocks(prompt_ids, shape, k, v)


# ------------------------------------------------- the plane's d2d pages
def export_kv_blocks(engine, key: tuple, export_id: int, scratch: str):
    """Register this rank's block of `key`'s cached KV in its export table
    under `export_id` and return what the page set holds of it: rank 0
    its (k, v) tensors, every other rank a (k, v) pair of handles another
    process can open (parallel/ipc.py; on the CPU, files under `scratch`).
    None on every rank when the entry is not resident."""
    return engine._export_block(tuple(key), export_id, scratch)


def adopt_kv_blocks(engine, prompt_ids: list[int], export_id: int, handles: list,
                    own: bool, filler: str, k=None, v=None):
    """Adopt a tp > 1 d2d page set on every rank: rank 0 copies the
    filler's rank-0 tensors (`k`, `v`, the driver's alone, taken by
    reference: the two groups' drivers are one process), every other rank
    r opens `handles[r - 1]` and copies the filler's rank-r block into a
    buffer of its own, or, when the filler is its own group (`own`), copies
    it from its export table."""
    return engine._adopt_block(prompt_ids, export_id, handles, own, filler, k, v)


def release_kv_exports(engine, ids: list[int]) -> None:
    """Drop the exports `ids` from this rank's export table."""
    engine._release_exports(ids)


def export_table(engine) -> list[int]:
    """The export ids this rank's export table holds."""
    return sorted(engine._kv_exports)


def rank_collectives(engine) -> dict:
    """collective_book of this rank's mesh: every group's counts and bytes."""
    return collective_book(engine.mesh)


if __name__ == "__main__":
    # through the package's module, so the classes a message names (_Ref)
    # are the ones the driver pickled
    from k8s_llm_scheduler_tpu_torch.parallel import launch as _launch

    with open(sys.argv[1], "rb") as _f:
        _launch.follower_main(pickle.load(_f), int(sys.argv[2]))

