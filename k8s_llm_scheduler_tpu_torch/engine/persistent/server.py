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
"""

from __future__ import annotations

import atexit
import logging
import threading
import time
import weakref
from typing import TYPE_CHECKING, Any

import numpy as np

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
    ) -> None:
        self.engine = engine
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
        self.tokens = TokenRing(self.token_capacity)
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
        """The resident thread: serves until a QUIESCE or a stop vote."""
        try:
            persistent_serve_impl(poll=self._poll, push=self._push, run=self._run_iteration)
        except BaseException as exc:  # noqa: BLE001 - published, not dropped
            logger.exception("persistent loop died")
            self._error = exc
        finally:
            self._done.set()

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
        try:
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
