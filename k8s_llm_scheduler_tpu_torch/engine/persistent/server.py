"""PersistentServer: host-side owner of one resident serving loop (the port
of the JAX package's engine/persistent/server.py).

Threading model: the loop runs on a DEDICATED RESIDENT THREAD
("persistent-loop"), as the JAX server's does. There, one iteration is
poll the CommandRing, run the micro-chunk program (engine/persistent/
loop.py; one CUDA graph launch on a card, captured at its first run on this
thread), wait on its event, push a HarvestBatch into the TokenRing. The
engine-owner thread only touches the two rings (admit/abort/quiesce feed
the CommandRing, harvest drains the TokenRing) and runs no CUDA work while
the loop is resident: the steady-state feeders (`*_steady`) make no device
call and no device sync.

The resident thread and the engine's wave dispatcher never run device work
at the same time: each holds the engine's `_device_lock` around its
programs (a wave may still be served while the loop is resident, as in the
JAX engine). `launch` waits for the dispatcher to have queued every wave
submitted before.

Buffer ownership: the loop updates the engine's own slot state, page tables
and paged caches in place (no donation). While it is resident the engine's
dispatch-path entry points drain it first (`exit_persistent`), and its
chunk dispatches refuse to run, so nothing else writes those buffers.
`quiesce` stops the loop after one last (stepless) iteration and returns
the final counter block.

Tensor parallel (tp > 1, engine/sharded/plane.py). Every rank runs a
resident thread over its own slots, and every iteration's model calls issue
the tp collectives, so every rank must run the same iterations with the
same command in each. The design:

- Only the DRIVER's resident thread decides. Its `_poll` reads its command
  ring and the clock as at tp 1 (`poll_idle_s`, the idle park, a
  `force_stop`), then broadcasts the iteration's Command, tokens and page
  rows included, on a gloo group of its own (`channel`: not the control
  channel, which the owner thread uses), before it runs the iteration. A
  follower's resident thread runs exactly the commands it receives
  (`_follow`), QUIESCE included; when the driver's loop ends any other way
  (a stop vote from a forced drain, an error) it sends STOP, and the
  followers' loops end without running an iteration. So a forced drain
  (the watchdog's `force_stop`) reaches every rank the same way, and the
  heartbeat and `wedged()` are read on the driver only.
- The loop's collectives go over a tp group of its own (`loop_group`, the
  thread's route through ServingPlane.use_group), so the control
  channel's settle counts only the owner thread's collectives, whatever
  iteration each rank's loop has reached.
- The engine's calls that issue collectives on the owner thread drain the
  loop first, on every rank (InferenceEngine.drain_for_collectives: a
  wave, a prefill, an export or adoption, a swap). Else one rank's wave
  and another rank's micro-chunk, each holding its rank's `_device_lock`
  while it waits for its peer, would wait for each other.
- Admissions stay mirrored host work: each rank's add_requests allocates
  the same slot and pages and puts the same ADMIT on its own ring. A
  follower's loop takes its own ADMIT when the driver's arrives and checks
  the two are equal, so an undrained ADMIT is left on every rank's ring
  alike (exit_persistent finishes them).
- Emissions reach the driver's token ring, which its owner thread harvests
  as at tp 1 (step_persistent, no message to the followers). A
  follower's token ring is unbounded, so its loop never blocks on it; the
  follower harvests it one batch at a time up to the driver's count
  before each mirrored call (InferenceEngine.follow_persistent, from the
  count the call's message carries), so every rank's host books hold the
  same requests, slots and pages at every call.
- Over gloo no CUDA graph is captured (engine.check_tp_serving), so at
  tp 2 on one card the loop's programs run eagerly.
"""

from __future__ import annotations

import atexit
import logging
import sys
import threading
import time
import weakref
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from k8s_llm_scheduler_tpu_torch.engine.graphs import Fence
from k8s_llm_scheduler_tpu_torch.engine.persistent.loop import (
    ResidentBuffers,
    persistent_serve_impl,
    resident_iteration,
)
from k8s_llm_scheduler_tpu_torch.engine.persistent.ring import (
    OP_ABORT,
    OP_ADMIT,
    OP_NOOP,
    OP_QUIESCE,
    Command,
    CommandRing,
    Heartbeat,
    HarvestBatch,
    TokenRing,
)
from k8s_llm_scheduler_tpu_torch.observability.resident import (
    BlackBox,
    StatsRing,
    StatsSnapshot,
    counters_dict,
    liveness_bitmap,
)

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine

logger = logging.getLogger(__name__)

# Loops still resident at interpreter shutdown are stopped BEFORE Python
# finalizes: a daemon thread running CUDA work during finalization crashes
# the process instead of exiting it. launch() registers each server here;
# the hook votes stop and joins briefly.
_LIVE: "weakref.WeakSet[PersistentServer]" = weakref.WeakSet()


@atexit.register
def _stop_resident_loops() -> None:  # pragma: no cover - process teardown
    for srv in list(_LIVE):
        if srv._running and not srv._done.is_set():
            srv.force_stop()
            srv._done.wait(5.0)


class PersistentServer:
    """One resident loop over one engine's buffers. The engine-owner thread
    calls launch/admit/abort/quiesce/harvest; the resident thread runs the
    device programs."""

    def __init__(
        self,
        engine: "InferenceEngine",
        *,
        suffix_bucket: int | None = None,
        cmd_capacity: int = 64,
        token_capacity: int = 64,
        wedge_timeout_s: float = 30.0,
        poll_idle_s: float = 0.002,
        telemetry: bool = True,
        stats_every: int = 8,
        blackbox_depth: int = 64,
        channel=None,
        loop_group=None,
    ) -> None:
        self.engine = engine
        # tp > 1 (module doc): the command channel (a gloo AxisGroup, the
        # driver its rank 0) and the loop's own tp group; None at tp 1
        self.channel = channel
        self.loop_group = loop_group
        self.follower = channel is not None and channel.rank != 0
        self.suffix_bucket = int(
            suffix_bucket if suffix_bucket is not None else engine.prefill_buckets[0]
        )
        if self.suffix_bucket % engine.kv.page_size:
            raise ValueError(
                f"suffix bucket {self.suffix_bucket} must be a multiple of "
                f"the page size {engine.kv.page_size}"
            )
        self.cmd_capacity = int(cmd_capacity)
        self.token_capacity = int(token_capacity)
        self.wedge_timeout_s = float(wedge_timeout_s)
        self.poll_idle_s = float(poll_idle_s)
        self.telemetry = bool(telemetry)
        self.stats_every = max(1, int(stats_every))
        self.commands = CommandRing(self.cmd_capacity)
        # a follower's ring is unbounded: its loop must never block on it
        self.tokens = TokenRing(sys.maxsize if self.follower else self.token_capacity)
        # Telemetry plane (observability/resident.py): the StatsRing is
        # published from the push via put_latest (drop-oldest, counted), so
        # an undrained telemetry consumer never stalls the loop; the
        # BlackBox keeps the last-N per-push snapshots for the watchdog.
        self.stats_ring = StatsRing(64)
        self.blackbox = BlackBox(blackbox_depth)
        self._push_count = 0
        self._last_blackbox: dict | None = None
        self._bb_dumped = False
        self.heartbeat = Heartbeat()
        self._thread: threading.Thread | None = None
        self._final: dict | None = None
        self._error: BaseException | None = None
        self._done = threading.Event()
        self._force_stop = False
        self._any_active = False  # device-truth mirror from the last push
        self._running = False
        self._launched_at = 0.0
        self._bufs: ResidentBuffers | None = None
        # batches taken off the token ring while quiescing, for the final
        # harvest
        self._held: list[HarvestBatch] = []
        self._programs: dict[tuple, tuple] = {}  # key -> (noop, admit) programs
        self._key: tuple | None = None
        self._sent_quiesce = False  # the driver's last broadcast was a QUIESCE

    # ------------------------------------------------------------ launch
    @property
    def running(self) -> bool:
        return self._running

    def launch(self) -> None:
        """Hand the engine's slots to a fresh resident loop: binds the
        active prefix and page tables, then starts the resident thread.
        Everything after it is ring traffic."""
        if self._running:
            raise RuntimeError("persistent loop already resident")
        eng = self.engine
        eng._await_dispatch()
        table = eng.dense_grammar() if eng._constrained else eng._fused_dummy
        if eng._constrained and table is None:
            raise RuntimeError("grammar has no dense table — persistent loop unsupported")
        prefix = eng._bind_prefix()
        eng._padded_tables()
        if self._bufs is None:
            self._bufs = ResidentBuffers.make(eng, self.suffix_bucket)
        bufs = self._bufs
        bufs.table, bufs.prefix = table, prefix
        key = (
            self.suffix_bucket, eng.chunk_steps, eng._constrained, eng.top_k,
            eng._vocab_limit, self.telemetry, prefix.k.shape[1], tuple(table.shape),
        )
        if key not in self._programs:
            self._programs[key] = tuple(
                eng._graphs.program(
                    f"resident {'admit ' if admit else ''}micro-chunk",
                    lambda admit=admit: resident_iteration(
                        eng, bufs, admit=admit, telemetry=self.telemetry,
                    ),
                )
                for admit in (False, True)
            )
        self._key = key
        bufs.reset_telemetry()

        self._final = None
        self._error = None
        self._done.clear()
        self._force_stop = False
        self._sent_quiesce = False
        # Fresh residency, fresh forensics: the black-box ring describes
        # THIS residency only (_last_blackbox keeps the previous dump until
        # a new one supersedes it).
        self._push_count = 0
        self._bb_dumped = False
        self.stats_ring.clear_parked()
        self.blackbox.clear()
        self._any_active = bool((eng._act_np & (eng._budget_np > 0)).any())
        self._running = True
        self._launched_at = time.monotonic()
        self.heartbeat.beat()
        _LIVE.add(self)
        self._thread = threading.Thread(
            target=self._run_resident, name="persistent-loop", daemon=True,
        )
        self._thread.start()

    def _run_resident(self) -> None:
        """The resident thread: serves until a QUIESCE or a stop vote (at
        tp > 1 a follower's until the driver's QUIESCE or STOP)."""
        try:
            if self.loop_group is not None:
                self.engine.plane.use_group(self.loop_group)
            if self.follower:
                self._follow()
            else:
                poll = self._poll if self.channel is None else self._poll_and_send
                persistent_serve_impl(poll=poll, push=self._push, run=self._run_iteration)
        except BaseException as exc:  # noqa: BLE001 - published, not dropped
            logger.exception("persistent loop died")
            self._error = exc
        finally:
            if self.channel is not None and not self.follower and not self._sent_quiesce:
                try:
                    self._send(None)  # STOP: the followers' loops end with this one
                except Exception:
                    logger.exception("persistent loop: the STOP did not reach the followers")
            self._done.set()

    # ------------------------------------------------- tp > 1: the channel
    def _wire_len(self) -> int:
        kv = self.engine.kv
        return 4 + self.suffix_bucket + self.suffix_bucket // kv.page_size + kv.max_pages_per_seq

    def _send(self, cmd: Command | None) -> None:
        """Broadcast one iteration's command (None: STOP) to the followers."""
        msg = torch.zeros(self._wire_len(), dtype=torch.int64)
        if cmd is None:
            msg[0] = -1
        else:
            msg[:4] = torch.tensor([cmd.op, cmd.suffix_len, cmd.slot, cmd.budget])
            if cmd.op == OP_ADMIT:
                Sb, nb = self.suffix_bucket, self.suffix_bucket // self.engine.kv.page_size
                msg[4:4 + Sb] = torch.from_numpy(cmd.tokens.reshape(-1).astype(np.int64))
                msg[4 + Sb:4 + Sb + nb] = torch.from_numpy(
                    cmd.prefill_pages.reshape(-1).astype(np.int64))
                msg[4 + Sb + nb:] = torch.from_numpy(cmd.page_row.astype(np.int64))
        self.channel.broadcast(msg)
        self._sent_quiesce = cmd is not None and cmd.op == OP_QUIESCE

    def _recv(self) -> Command | None:
        msg = self.channel.broadcast(torch.zeros(self._wire_len(), dtype=torch.int64)).numpy()
        op = int(msg[0])
        if op < 0:
            return None
        head = dict(op=op, suffix_len=int(msg[1]), slot=int(msg[2]), budget=int(msg[3]))
        if op != OP_ADMIT:
            return Command(**head)
        Sb, nb = self.suffix_bucket, self.suffix_bucket // self.engine.kv.page_size
        return Command(**head, tokens=msg[4:4 + Sb].astype(np.int32).reshape(1, Sb),
                       prefill_pages=msg[4 + Sb:4 + Sb + nb].astype(np.int32).reshape(1, nb),
                       page_row=msg[4 + Sb + nb:].astype(np.int32))

    def _poll_and_send(self) -> Command:
        cmd = self._poll()
        self._send(cmd)
        return cmd

    def _follow(self) -> None:
        """A follower's resident thread: each iteration the driver's loop
        sends, until its QUIESCE (run, as the driver runs it) or STOP."""
        while True:
            cmd = self._recv()
            if cmd is None:
                return
            if cmd.op == OP_ADMIT:
                self._match_admit(cmd)
            batch, counters = self._run_iteration(cmd)
            self._push(batch, counters)
            if cmd.op == OP_QUIESCE:
                return

    def _match_admit(self, cmd: Command) -> None:
        """Take this rank's own ADMIT (its mirrored add_requests put it on
        its ring) and check that it is the driver's: a difference means the
        ranks' host books parted."""
        deadline = time.monotonic() + self.engine.mesh.timeout_s
        own = self.commands.take()
        while own is None:
            if time.monotonic() > deadline:
                raise RuntimeError("tp follower: the driver's ADMIT has no match on this rank")
            self.commands.wait_nonempty(0.05)
            own = self.commands.take()
        same = (own.op == cmd.op and own.slot == cmd.slot and own.budget == cmd.budget
                and own.suffix_len == cmd.suffix_len
                and np.array_equal(own.tokens, cmd.tokens)
                and np.array_equal(own.prefill_pages, cmd.prefill_pages)
                and np.array_equal(own.page_row, cmd.page_row))
        if not same:
            raise RuntimeError(
                f"tp follower: the driver admitted slot {cmd.slot}, this rank's ring "
                f"holds slot {own.slot}: the ranks are out of step")

    def take_one(self, timeout_s: float) -> HarvestBatch | None:
        """The next emission batch, held ones first (a tp follower harvests
        one batch at a time, to the driver's count); None when the loop has
        ended with nothing left, or after `timeout_s`."""
        if self._held:
            return self._held.pop(0)
        deadline = time.monotonic() + timeout_s
        while True:
            ended = self._done.is_set()
            got = self.tokens.drain(0.0 if ended else 0.05)
            if got:
                self._held = got[1:]
                return got[0]
            if ended or time.monotonic() > deadline:
                return None

    def failed(self) -> bool:
        """True when the resident thread ended on an error while the loop
        is still marked running (quiesce raises it)."""
        return self._running and self._done.is_set() and self._error is not None

    # ----------------------------------------------------- the resident thread
    def _poll(self) -> Command:
        """One command per micro-chunk. While the loop is idle (no live
        slot, no command) it parks here, beating the heartbeat every
        `poll_idle_s`, until a command or a stop arrives. (The JAX loop runs
        an empty micro-chunk and pushes an empty batch every `poll_idle_s`
        instead: an idle residency that nobody harvests then fills the token
        ring, and its blocked push stops the heartbeat.)"""
        self.heartbeat.beat()
        cmd = self.commands.take()
        while cmd is None and not self._any_active and not self._force_stop:
            self.commands.wait_nonempty(self.poll_idle_s)
            self.heartbeat.beat()
            cmd = self.commands.take()
        if self._force_stop and (cmd is None or cmd.op != OP_QUIESCE):
            if cmd is not None:
                # the watchdog's stop landed between the take and the run: an
                # ADMIT dropped here would leave its request live with no
                # prefill (and at tp > 1 a follower's copy still on its
                # ring). Back on the ring, exit_persistent finishes it
                # truncated on every rank. (The JAX loop's _device_poll drops
                # it.)
                self.commands.put_back(cmd)
            cmd = Command(op=OP_QUIESCE)
        return cmd if cmd is not None else Command(op=OP_NOOP)

    def _run_iteration(self, cmd: Command) -> tuple[HarvestBatch, dict]:
        """Stage `cmd`, run its micro-chunk program, wait for the outputs."""
        eng, bufs = self.engine, self._bufs
        noop_prog, admit_prog = self._programs[self._key]
        prog = admit_prog if cmd.op == OP_ADMIT else noop_prog
        with eng._device_lock:
            bufs.stage(cmd, eng.tokenizer.pad_id)
            prog.run()
            done = Fence(eng.device)
            done.record()
            done.synchronize()
        batch = bufs.batch()
        prog.book_bodies(batch.steps_run)
        return batch, bufs.counters()

    def _push(self, batch: HarvestBatch, counters: dict) -> bool:
        """One emission batch per micro-chunk. Blocks on a full token ring
        (zero lost tokens); returns the stop vote the watchdog uses to
        force a drain. Every push records a black-box snapshot, and every
        `stats_every`-th push publishes a StatsSnapshot (put_latest:
        telemetry never stalls the loop). Pure numpy + threading."""
        self.heartbeat.beat()
        ctr = counters["ctr"]
        self._final = counters
        self._any_active = bool((batch.act & (batch.budget > 0)).any())
        if self.telemetry:
            self._push_count += 1
            self.blackbox.record(
                {
                    "push": self._push_count,
                    "counters": counters_dict(ctr),
                    "act_bits": liveness_bitmap(batch.act),
                    "admit_slot": batch.admit_slot,
                    "steps_run": batch.steps_run,
                    "cmd_cursor": self.commands.taken,
                    "token_cursor": self.tokens.pushed,
                }
            )
            if self._push_count % self.stats_every == 0:
                self.stats_ring.put_latest(
                    StatsSnapshot(
                        seq=0,
                        counters=ctr.astype(np.int64),
                        slot_tokens=counters["s_tok"],
                        admit_iter=counters["a_it"],
                        first_emit=counters["f_em"],
                        pushes=self.tokens.pushed,
                        token_stalls=self.tokens.stalls,
                        cmd_stalls=self.commands.stalls,
                        cmd_depth=self.commands.qsize(),
                        token_depth=self.tokens.qsize(),
                    )
                )
        ok = self.tokens.put(batch, stop_check=lambda: self._force_stop)
        return not ok or self._force_stop

    # ------------------------------------------------- steady-state feeders
    def admit_steady(
        self,
        suffix_ids: list[int],
        slot: int,
        budget: int,
        prefill_pages: np.ndarray,
        page_row: np.ndarray,
        timeout_s: float = 5.0,
    ) -> None:
        """Feed one admission through the command ring. No device call:
        the zero-dispatch steady-state admission path."""
        Sb = self.suffix_bucket
        if len(suffix_ids) > Sb:
            raise ValueError(
                f"suffix of {len(suffix_ids)} tokens exceeds the loop's "
                f"bucket {Sb} — route via the dispatch path"
            )
        tokens = np.full((1, Sb), self.engine.tokenizer.pad_id, dtype=np.int32)
        tokens[0, : len(suffix_ids)] = suffix_ids
        self.commands.put(
            Command(
                op=OP_ADMIT, tokens=tokens, suffix_len=len(suffix_ids),
                slot=int(slot), budget=int(budget),
                prefill_pages=np.asarray(prefill_pages, dtype=np.int32),
                page_row=np.asarray(page_row, dtype=np.int32),
            ),
            timeout_s=timeout_s,
        )
        self._any_active = True

    def abort_steady(self, slot: int = -1, timeout_s: float = 5.0) -> None:
        """Deactivate one slot (or all, slot=-1) via the command ring."""
        self.commands.put(Command(op=OP_ABORT, slot=int(slot)), timeout_s)

    def harvest_steady(self, timeout_s: float = 0.0) -> list[HarvestBatch]:
        """Drain the token ring (blocking up to timeout for the first
        batch). No device call, no device sync: pure ring traffic."""
        held, self._held = self._held, []
        return held + self.tokens.drain(0.0 if held else timeout_s)

    def clear_parked(self) -> int:
        """Drop undelivered emission batches (abort_all path)."""
        held, self._held = len(self._held), []
        return held + self.tokens.clear_parked()

    # --------------------------------------------------------- drain paths
    def wedged(self) -> bool:
        """True when the resident loop stopped beating for wedge_timeout_s
        while still marked running."""
        return (
            self._running
            and not self._done.is_set()
            and self.heartbeat.wedged(self.wedge_timeout_s)
        )

    def force_stop(self) -> None:
        """Watchdog drain: make the next poll return QUIESCE and the next
        push vote stop, then unblock a push stalled on the full token ring
        by leaving its contents for harvest. Dumps the wedge black-box
        FIRST: the forced drain is the moment its snapshots explain."""
        if self.telemetry and self._running and not self._bb_dumped:
            self._last_blackbox = self.blackbox.dump(reason="wedge")
            self._bb_dumped = True
        self._force_stop = True
        with self.commands._cond:
            self.commands._cond.notify_all()

    def quiesce(self, timeout_s: float = 60.0) -> dict:
        """Stop the loop and return its final counter block ({"ctr",
        "s_tok", "a_it", "f_em"} as numpy). Raises on a loop error or a
        drain timeout (a truly wedged loop)."""
        if not self._running:
            raise RuntimeError("persistent loop not resident")
        if self.follower:
            # the driver's loop sends the QUIESCE (or STOP) that ends this
            # one: a mirrored exit quiesces it in the same call
            if not self._done.wait(timeout_s):
                raise RuntimeError("tp follower: the driver's loop did not end this one")
        try:
            if not self.follower:
                self.commands.put(Command(op=OP_QUIESCE), timeout_s=timeout_s)
        except Exception:
            self.force_stop()
        deadline = time.monotonic() + timeout_s
        while not self._done.is_set():
            # a push parked on a full ring would never reach the QUIESCE:
            # hold its batches for the final harvest
            self._held.extend(self.tokens.drain(0.0))
            if time.monotonic() >= deadline:
                self.force_stop()
                if not self._done.wait(5.0):
                    raise RuntimeError(
                        "persistent loop failed to drain (wedged past force_stop)"
                    )
            else:
                self._done.wait(0.05)
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.telemetry and not self._bb_dumped:
            self._last_blackbox = self.blackbox.dump(reason="quiesce")
            self._bb_dumped = True
        if self._error is not None:
            raise RuntimeError("persistent loop died") from self._error
        if self._final is None:
            raise RuntimeError("persistent loop ended without an iteration")
        return self._final

    def blackbox_dump(self) -> dict[str, Any]:
        """Latest black-box dump: the wedge/quiesce dump once one was
        taken, else a live view of the current residency's ring."""
        if self._last_blackbox is not None:
            return self._last_blackbox
        return self.blackbox.dump(reason="live")

    def stats(self) -> dict[str, Any]:
        return {
            "persistent_resident": self._running,
            "persistent_cmd_stalls": self.commands.stalls,
            "persistent_token_stalls": self.tokens.stalls,
            "persistent_cmd_depth": self.commands.qsize(),
            "persistent_token_depth": self.tokens.qsize(),
            # _frac suffix: the fleet merge averages ratio leaves
            "persistent_ring_occupancy_frac": round(
                self.tokens.qsize() / self.token_capacity, 4
            ),
            "persistent_heartbeats": self.heartbeat.beats,
            "persistent_telemetry": self.telemetry,
            "persistent_stats_published": self.stats_ring.pushed,
            "persistent_stats_drops": self.stats_ring.dropped,
            "persistent_stats_depth": self.stats_ring.qsize(),
            "persistent_blackbox_recorded": self.blackbox.recorded,
        }
