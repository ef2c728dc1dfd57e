"""Host-side ring buffers for the persistent serving loop (a copy of the JAX
package's engine/persistent/ring.py, which imports no JAX; in the port the
"device callbacks" below are the resident thread's poll and push,
engine/persistent/server.py).

Both rings are bounded and thread-safe, and both block rather than drop:

- CommandRing (host feeder -> device poll callback): `put` blocks up to
  its timeout when full — ADMISSION BACKPRESSURE. A full ring means the
  loop is behind on command uptake; making the feeder wait (instead of
  queueing unboundedly or failing) is what bounds admitted-but-unserved
  work, exactly like the engine's free-slot check does for the dispatch
  path.
- TokenRing (device push callback -> host harvester): `put` blocks
  INDEFINITELY when full — EMISSION BACKPRESSURE. The push callback runs
  inside the device program (ordered io_callback), so a full token ring
  stalls the loop itself until the harvester drains. Tokens are never
  dropped and never re-delivered: each batch carries a monotonically
  increasing `seq` the harvester checks, so loss or duplication is a
  loud protocol error, not silent corruption.

Heartbeat is the wedge detector shared by the real server and the chaos
harness: every callback entry beats it; a loop that stops beating while
marked running is WEDGED and the watchdog kicks a graceful drain back to
the dispatch path (PersistentServer.force_stop / chaos `persistent-wedge`
regime).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any

import numpy as np

# Command opcodes (device-visible int32 scalars).
OP_NOOP = 0     # nothing pending — run a decode micro-chunk and re-poll
OP_ADMIT = 1    # in-loop admission: suffix prefill + first-token sample
OP_ABORT = 2    # deactivate one slot (slot >= 0) or every slot (slot < 0)
OP_QUIESCE = 3  # exit the loop; final carry returns to the host


class RingFull(RuntimeError):
    """CommandRing.put timed out — the loop is not draining commands."""


class RingClosed(RuntimeError):
    """Ring used after close() — the loop already drained."""


@dataclasses.dataclass(frozen=True)
class Command:
    """One host->device command, pre-shaped to the loop's static geometry.

    ADMIT payloads carry the SAME things the dispatch path's `_admit`
    dispatch carries, as numpy (the poll callback returns them into the
    traced program): bucketed suffix tokens, the suffix length, the
    target slot, the decode budget (max_new_tokens - 1, first token
    sampled in-loop), the per-block destination page ids for the suffix
    prefill scatter, and the slot's FULL page-table row (the loop carries
    page_tables so decode steps can land KV past the prefill blocks)."""

    op: int
    tokens: np.ndarray | None = None       # [1, Sb] int32
    suffix_len: int = 0
    slot: int = -1
    budget: int = 0
    prefill_pages: np.ndarray | None = None  # [1, Sb // page_size] int32
    page_row: np.ndarray | None = None       # [P] int32


@dataclasses.dataclass
class HarvestBatch:
    """One device->host emission batch: the outcome of one micro-chunk."""

    seq: int                 # monotonic batch number (gap/repeat = protocol bug)
    emitted: np.ndarray      # [M, n_steps] int32, pad_id holes past each stop
    steps_run: int           # micro-chunk iterations actually executed
    act: np.ndarray          # [M] bool  post-chunk liveness
    budget: np.ndarray       # [M] int32 post-chunk budgets
    pos: np.ndarray          # [M] int32 post-chunk positions
    admit_slot: int          # slot admitted THIS batch (-1 = none)
    first_tok: int           # its sampled first token (pad when admit_slot<0)
    pushed_at: float = dataclasses.field(default_factory=time.monotonic)


class Heartbeat:
    """Liveness tracker for the resident loop (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._beats = 0

    def beat(self) -> None:
        with self._lock:
            self._last = time.monotonic()
            self._beats += 1

    @property
    def beats(self) -> int:
        with self._lock:
            return self._beats

    def idle_s(self) -> float:
        with self._lock:
            return time.monotonic() - self._last

    def wedged(self, timeout_s: float) -> bool:
        return self.idle_s() > timeout_s


class CommandRing:
    """Bounded host->device command queue (feeder blocks when full)."""

    def __init__(self, capacity: int = 64) -> None:
        if capacity < 1:
            raise ValueError("CommandRing capacity must be >= 1")
        self.capacity = int(capacity)
        self._items: deque[Command] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self.stalls = 0       # puts that had to wait on a full ring
        self.enqueued = 0     # host-side producer cursor
        self.taken = 0        # device-side consumer cursor (loop progress)

    def put(self, cmd: Command, timeout_s: float = 5.0) -> None:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            if self._closed:
                raise RingClosed("command ring closed")
            if len(self._items) >= self.capacity:
                self.stalls += 1
            while len(self._items) >= self.capacity:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RingFull(
                        f"command ring full ({self.capacity}) for "
                        f"{timeout_s:.2f}s — loop not draining commands"
                    )
                self._cond.wait(remaining)
                if self._closed:
                    raise RingClosed("command ring closed")
            self._items.append(cmd)
            self.enqueued += 1
            self._cond.notify_all()

    def take(self) -> Command | None:
        """Non-blocking pop (the device poll callback's fast path)."""
        with self._cond:
            if not self._items:
                return None
            cmd = self._items.popleft()
            self.taken += 1
            self._cond.notify_all()
            return cmd

    def wait_nonempty(self, timeout_s: float) -> bool:
        """Park the poll callback briefly when the loop is idle (no
        active slots, no commands) so an idle resident loop doesn't
        busy-spin the host. Returns True if a command is waiting."""
        with self._cond:
            if self._items or self._closed:
                return bool(self._items)
            self._cond.wait(timeout_s)
            return bool(self._items)

    def qsize(self) -> int:
        with self._cond:
            return len(self._items)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


class TokenRing:
    """Bounded device->host emission stream (device blocks when full)."""

    def __init__(self, capacity: int = 64) -> None:
        if capacity < 1:
            raise ValueError("TokenRing capacity must be >= 1")
        self.capacity = int(capacity)
        self._items: deque[HarvestBatch] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._next_seq = 0    # assigned by put (device side)
        self._take_seq = 0    # checked by drain (host side)
        self.stalls = 0       # pushes that had to wait on a full ring
        self.pushed = 0

    def put(self, batch: HarvestBatch, stop_check=None) -> bool:
        """Device-side push: blocks until space (zero-loss backpressure).
        `stop_check()` is polled while blocked so a forced drain can
        unwedge a push whose consumer died; returns False when stopped
        (the loop should exit), True on successful enqueue."""
        with self._cond:
            if len(self._items) >= self.capacity:
                self.stalls += 1
            while len(self._items) >= self.capacity and not self._closed:
                if stop_check is not None and stop_check():
                    return False
                self._cond.wait(0.05)
            if self._closed:
                raise RingClosed("token ring closed")
            batch.seq = self._next_seq
            self._next_seq += 1
            self._items.append(batch)
            self.pushed += 1
            self._cond.notify_all()
            return True

    def drain(self, timeout_s: float = 0.0) -> list[HarvestBatch]:
        """Host-side harvest: everything queued, blocking up to
        `timeout_s` for the FIRST batch. Sequence numbers are verified —
        a gap or repeat means tokens were lost or double-delivered and
        the protocol is broken (raise loudly, never mis-book)."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while not self._items:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    return []
                self._cond.wait(remaining)
            out = list(self._items)
            self._items.clear()
            self._cond.notify_all()
            for b in out:
                if b.seq != self._take_seq:
                    raise RuntimeError(
                        f"token ring sequence break: got batch {b.seq}, "
                        f"expected {self._take_seq} (lost or duplicated "
                        f"emissions)"
                    )
                self._take_seq += 1
        return out

    def clear_parked(self) -> int:
        """Drop every undelivered batch (abort_all: parked emissions of
        aborted work must never be inherited by a slot-reusing request).
        The take-side cursor advances past the dropped batches so the
        sequence check stays consistent. Returns the number dropped."""
        with self._cond:
            dropped = len(self._items)
            for b in self._items:
                self._take_seq = max(self._take_seq, b.seq + 1)
            self._items.clear()
            self._cond.notify_all()
            return dropped

    def qsize(self) -> int:
        with self._cond:
            return len(self._items)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
