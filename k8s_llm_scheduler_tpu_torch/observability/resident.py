"""Device-resident telemetry plane for the persistent serving loop (a copy
of the JAX package's observability/resident.py, which imports no JAX; in the
port the counter block lives in the resident loop's device buffers,
engine/persistent/loop.py).

The persistent `lax.while_loop` program (engine/persistent/loop.py)
deleted the per-step dispatch boundaries the profiler fences on, so
steady-state serving books everything into one opaque `loop_resident`
segment. This module restores attribution WITHOUT reintroducing
dispatches:

- A device-resident COUNTER BLOCK rides in the loop carry (indices
  below): outer iterations, decode steps, admits taken, emissions
  pushed, command-ring empty polls, idle chunks, plus per-slot token
  counts and admission/first-emission iteration stamps. Updates are
  pure carried-array arithmetic inside the already-traced program —
  zero extra dispatches, zero extra callbacks.
- The counters leave the device by PIGGYBACKING on the loop's existing
  push io_callback (ordered callbacks inside `lax.cond` are the thing
  the loop design avoids, so telemetry must not add one). The host
  edge publishes a StatsSnapshot to the StatsRing below at a low,
  host-controlled cadence (PersistentServer.stats_every).
- StatsRing is the TokenRing's discipline applied to telemetry:
  bounded, seq-stamped at put, seq-VERIFIED at drain — losing a stats
  window is a loud protocol error, never a silent gap in the books.
  The server publishes via `put_latest` (drop-oldest, counted) so an
  undrained telemetry consumer can never backpressure-stall the
  serving loop itself; the blocking `put` exists for symmetry and is
  pinned by the same unit suite as TokenRing.put.
- BlackBox is the wedge forensics ring: the last-N per-push iteration
  snapshots (counters, ring cursors, slot-liveness bitmap — NO
  timestamps, so a dump is byte-stable across replays), dumped on
  watchdog latch or quiesce to /debug/blackbox and into the chaos
  trace under the `persistent-wedge` regime.

Everything here that the push callback reaches (StatsRing.put_latest,
BlackBox.record) is pure numpy + threading — graftlint's
dispatch-in-persistent-path rule sweeps this module via _device_push.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np

# Device counter-block indices (int32 vector carried in the loop state).
CTR_ITERS = 0        # outer loop iterations (one poll+chunk+push each)
CTR_STEPS = 1        # decode steps actually run (sum of steps_run)
CTR_ADMITS = 2       # in-loop admissions taken (OP_ADMIT polls)
CTR_EMITTED = 3      # non-pad tokens written to the emission buffer
CTR_EMPTY_POLLS = 4  # polls that returned OP_NOOP (command ring empty)
CTR_IDLE_CHUNKS = 5  # iterations whose decode chunk ran zero steps
N_COUNTERS = 6

COUNTER_NAMES = (
    "iters",
    "steps",
    "admits",
    "emitted",
    "empty_polls",
    "idle_chunks",
)


def counters_dict(ctr: np.ndarray) -> dict[str, int]:
    """Name the counter vector (device export order is the index order)."""
    return {name: int(ctr[i]) for i, name in enumerate(COUNTER_NAMES)}


@dataclasses.dataclass
class StatsSnapshot:
    """One telemetry window: cumulative device counters at a push edge,
    merged with the host-side ring books the device cannot count (a
    token-ring stall blocks INSIDE the push callback — only the host
    sees it)."""

    seq: int                  # monotonic snapshot number (gap = loud error)
    counters: np.ndarray      # [N_COUNTERS] int64 cumulative device counters
    slot_tokens: np.ndarray   # [M] tokens emitted per slot (current occupant)
    admit_iter: np.ndarray    # [M] iteration stamp of the slot's admission
    first_emit: np.ndarray    # [M] iteration of first emission (-1 pending)
    pushes: int = 0           # token-ring pushes at snapshot time
    token_stalls: int = 0     # token-ring backpressure stalls (host books)
    cmd_stalls: int = 0       # command-ring feeder stalls (host books)
    cmd_depth: int = 0
    token_depth: int = 0


class StatsRing:
    """Bounded device->host telemetry stream, TokenRing discipline.

    `put` blocks when full (the mirror of emission backpressure, unit-
    pinned); `put_latest` never blocks — it drops the OLDEST snapshot,
    advances the take cursor past it, and counts the drop, so telemetry
    can never stall the serving loop while staying seq-verified: drain
    still proves no snapshot was lost SILENTLY."""

    def __init__(self, capacity: int = 64) -> None:
        if capacity < 1:
            raise ValueError("StatsRing capacity must be >= 1")
        self.capacity = int(capacity)
        self._items: deque[StatsSnapshot] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._next_seq = 0    # assigned by put (device side)
        self._take_seq = 0    # checked by drain (host side)
        self.stalls = 0       # blocking puts that had to wait on a full ring
        self.dropped = 0      # put_latest evictions of the oldest snapshot
        self.pushed = 0

    def put(
        self, snap: StatsSnapshot, stop_check: Callable[[], bool] | None = None
    ) -> bool:
        """Blocking publish: waits for space (polling `stop_check` like
        TokenRing.put so a forced drain can unwedge it); returns False
        when stopped, True on enqueue."""
        with self._cond:
            if len(self._items) >= self.capacity:
                self.stalls += 1
            while len(self._items) >= self.capacity and not self._closed:
                if stop_check is not None and stop_check():
                    return False
                self._cond.wait(0.05)
            if self._closed:
                raise RuntimeError("stats ring closed")
            snap.seq = self._next_seq
            self._next_seq += 1
            self._items.append(snap)
            self.pushed += 1
            self._cond.notify_all()
            return True

    def put_latest(self, snap: StatsSnapshot) -> None:
        """Non-blocking publish: a full ring evicts its OLDEST snapshot
        (freshest-wins — stats, unlike tokens, are superseded by the
        next cumulative window) and advances the take cursor so the
        drain-side seq check stays consistent. The eviction is counted,
        never silent."""
        with self._cond:
            if self._closed:
                raise RuntimeError("stats ring closed")
            if len(self._items) >= self.capacity:
                old = self._items.popleft()
                self._take_seq = max(self._take_seq, old.seq + 1)
                self.dropped += 1
            snap.seq = self._next_seq
            self._next_seq += 1
            self._items.append(snap)
            self.pushed += 1
            self._cond.notify_all()

    def drain(self, timeout_s: float = 0.0) -> list[StatsSnapshot]:
        """Host-side harvest, blocking up to `timeout_s` for the first
        snapshot. Seq-verified: a gap or repeat (beyond counted
        put_latest evictions, whose cursor advance keeps the check
        consistent) raises loudly."""
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
            for s in out:
                if s.seq != self._take_seq:
                    raise RuntimeError(
                        f"stats ring sequence break: got snapshot {s.seq}, "
                        f"expected {self._take_seq} (lost or duplicated "
                        f"telemetry)"
                    )
                self._take_seq += 1
        return out

    def clear_parked(self) -> int:
        """Drop every undelivered snapshot, advancing the cursor (the
        relaunch path: stale windows from a drained residency must not
        be booked against the new one)."""
        with self._cond:
            dropped = len(self._items)
            for s in self._items:
                self._take_seq = max(self._take_seq, s.seq + 1)
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


class BlackBox:
    """Bounded ring of the last-N iteration snapshots — the wedge
    forensics the watchdog dumps when the loop stops heartbeating.

    Snapshots are plain dicts of ints (counters, ring cursors, a slot
    liveness bitmap) with NO wall-clock fields: the dump is a pure
    function of the served sequence, which is what lets the chaos
    `persistent-wedge` regime pin it byte-identical across replays."""

    def __init__(self, depth: int = 64) -> None:
        if depth < 1:
            raise ValueError("BlackBox depth must be >= 1")
        self.depth = int(depth)
        self._lock = threading.Lock()
        self._ring: deque[dict[str, Any]] = deque(maxlen=self.depth)
        self._recorded = 0

    def record(self, snap: dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(snap)
            self._recorded += 1

    @property
    def recorded(self) -> int:
        with self._lock:
            return self._recorded

    def dump(self, reason: str = "quiesce") -> dict[str, Any]:
        """Stable, JSON-ready view: bounded snapshot list plus the books
        needed to read it (depth, total recorded, dump reason)."""
        with self._lock:
            return {
                "reason": reason,
                "depth": self.depth,
                "recorded": self._recorded,
                "snapshots": [dict(s) for s in self._ring],
            }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._recorded = 0


def canonical_blackbox_bytes(dump: dict[str, Any]) -> bytes:
    """Canonical byte encoding of a black-box dump — the byte-identity
    pin the chaos regime replays against (same discipline as
    chaos.trace.canonical_chaos_bytes)."""
    return json.dumps(
        dump, sort_keys=True, separators=(",", ":"), default=str
    ).encode()


def liveness_bitmap(act: np.ndarray) -> int:
    """Pack a slot-liveness bool vector into one int (LSB = slot 0) —
    the black-box's fixed-size view of which slots were alive."""
    bits = 0
    for i, alive in enumerate(np.asarray(act).astype(bool).tolist()):
        if alive:
            bits |= 1 << i
    return bits
