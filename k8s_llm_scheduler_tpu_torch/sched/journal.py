"""Durable decision journal — the write-ahead log binds survive crashes by.

Every durable-state invariant the serving plane has (exactly-once binds,
no orphaned decisions, watch continuity) assumed until now that the
scheduler PROCESS survives: a crashed replica lost its in-flight pod
set, so a cold restart could re-decide a pod whose bind already landed
(the apiserver's 409 made that a wasted model call and a nondeterminism
source) or orphan a pod it decided but never bound. The journal records
the decision -> bind-intent -> bind-ack lifecycle per pod, the
informer's last-observed resourceVersion, and circuit-breaker trips, so
the recovery protocol (sched/recovery.py) can rebuild a replica from
disk and reconcile every open lifecycle against the cluster's actual
``pod.spec.nodeName`` instead of re-deciding.

On-disk format — append-only JSON-lines segments under one directory::

    <root>/seg-000001.log
    crc32hex {"k":"intent","ns":"default","name":"p0","node":"n3",...}\n

Each record line carries the crc32 of its JSON payload. Replay decodes
line by line and TRUNCATES at the first undecodable record (missing
newline, bad crc, bad JSON): a torn tail — the bytes a crash cut mid-
write — can never corrupt recovery, it only loses the record being
written at the instant of death, and the cluster reconciliation pass
re-derives that record's outcome anyway. Opening a journal physically
truncates the torn tail before appending (seeded-truncation fuzz in
tests/test_durable.py tears the last record at every byte boundary).

Durability policy (``fsync_policy``):

- ``"intent"`` (default): bind-intent records are flushed AND fsync'd
  BEFORE the bind leaves for the apiserver — the classic write-ahead
  property — while decide/ack/rv records ride the userspace buffer
  until the next intent sync (or close) carries them down. Losing a
  buffered record to a crash costs one cluster lookup at recovery,
  never a double bind or a lost pod: an unwritten ack leaves an open
  intent the reconciliation pass closes from ``pod.spec.nodeName``,
  and an unwritten decide means no bind was attempted — the watch
  re-offers the still-pending pod. The cluster is always the
  authority the journal is reconciled against.
- ``"always"``: every record flushed + fsync'd (the crash-harness
  setting — each kill point must observe exactly its own record set).
- ``"none"``: buffered until close/rotation (still torn-tail safe).

Segment rotation is the registry's proven discipline
(rollout/registry.py): when the active segment exceeds
``segment_max_records``, the LIVE state (open lifecycles, last rv, last
breaker snapshot) is compacted into a fresh segment written aside and
published with one ``os.replace``; old segments are deleted only after
the new one is durable, so a crash mid-rotation leaves either the old
segments or old+new (replay is idempotent over both), never neither.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import zlib
from pathlib import Path
from typing import Any, Iterator

logger = logging.getLogger(__name__)

_SEG_FMT = "seg-{:06d}.log"
_FSYNC_POLICIES = ("always", "intent", "none")


class JournalError(RuntimeError):
    """A journal operation failed (bad root, unknown fsync policy...)."""


def _encode(rec: dict) -> bytes:
    payload = json.dumps(rec, sort_keys=True, separators=(",", ":")).encode()
    return b"%08x " % (zlib.crc32(payload) & 0xFFFFFFFF) + payload + b"\n"


def _decode_line(line: bytes) -> dict | None:
    """One journal line -> record dict, or None when torn/corrupt."""
    if not line.endswith(b"\n") or len(line) < 10 or line[8:9] != b" ":
        return None
    payload = line[9:-1]
    try:
        if int(line[:8], 16) != (zlib.crc32(payload) & 0xFFFFFFFF):
            return None
        rec = json.loads(payload)
    except (ValueError, UnicodeDecodeError):
        return None
    return rec if isinstance(rec, dict) and "k" in rec else None


@dataclasses.dataclass
class JournalState:
    """The live fold of a record stream: exactly what recovery needs.

    Completed lifecycles are pruned as their acks arrive (their outcome
    lives in ``acked``/counters), so the state — and therefore each
    compacted segment — stays proportional to the OPEN work, not the
    pod history."""

    # (ns, name) -> {"node": ...}: decide seen, no intent yet
    open_decisions: dict[tuple[str, str], dict] = dataclasses.field(
        default_factory=dict
    )
    # (ns, name) -> {"node", "shard", "epoch"}: intent seen, no ack
    open_intents: dict[tuple[str, str], dict] = dataclasses.field(
        default_factory=dict
    )
    # (ns, name) -> node for every ack with ok=True (the book
    # finalize_journal judges against the cluster)
    acked: dict[tuple[str, str], str] = dataclasses.field(
        default_factory=dict
    )
    last_rv: str | None = None
    breaker: dict | None = None
    counts: dict[str, int] = dataclasses.field(
        default_factory=lambda: {
            "records": 0, "decides": 0, "intents": 0,
            "acks_ok": 0, "acks_failed": 0, "drops": 0,
        }
    )

    def apply(self, rec: dict) -> None:
        kind = rec["k"]
        self.counts["records"] += 1
        if kind == "decide":
            key = (rec["ns"], rec["name"])
            self.counts["decides"] += 1
            self.open_decisions[key] = {"node": rec["node"]}
        elif kind == "intent":
            key = (rec["ns"], rec["name"])
            self.counts["intents"] += 1
            self.open_decisions.pop(key, None)
            self.open_intents[key] = {
                "node": rec["node"],
                "shard": rec.get("shard"),
                "epoch": rec.get("epoch"),
            }
        elif kind == "ack":
            key = (rec["ns"], rec["name"])
            self.open_decisions.pop(key, None)
            self.open_intents.pop(key, None)
            if rec.get("ok"):
                self.counts["acks_ok"] += 1
                self.acked[key] = rec["node"]
            else:
                self.counts["acks_failed"] += 1
        elif kind == "drop":
            key = (rec["ns"], rec["name"])
            self.counts["drops"] += 1
            self.open_decisions.pop(key, None)
            self.open_intents.pop(key, None)
        elif kind == "rv":
            self.last_rv = rec["rv"]
        elif kind == "breaker":
            self.breaker = dict(rec.get("snap") or {})
        # unknown kinds are skipped, not fatal: an older binary replaying
        # a newer journal must degrade to reconciliation, not crash

    def open_lifecycles(self) -> dict[tuple[str, str], dict]:
        """Everything recovery must reconcile: open intents (bind may or
        may not have landed) plus decisions that never reached an
        intent (the bind definitely did not land, but the decision is
        known — completing it needs no model call)."""
        return {**self.open_decisions, **self.open_intents}

    def snapshot_records(self) -> list[dict]:
        """The record stream that reconstructs this state exactly — what
        a compacted segment starts with."""
        out: list[dict] = []
        for (ns, name), rec in sorted(self.open_decisions.items()):
            out.append({"k": "decide", "ns": ns, "name": name,
                        "node": rec["node"]})
        for (ns, name), rec in sorted(self.open_intents.items()):
            out.append({"k": "decide", "ns": ns, "name": name,
                        "node": rec["node"]})
            out.append({"k": "intent", "ns": ns, "name": name,
                        "node": rec["node"], "shard": rec.get("shard"),
                        "epoch": rec.get("epoch")})
        # acked lifecycles are deliberately NOT snapshotted: compaction
        # exists to forget completed history (recovery never reads an
        # ack — the cluster is the authority on what landed), and
        # carrying them forward would make every rotation rewrite the
        # replica's whole bind history — O(lifetime) I/O per rotation
        # instead of O(open work)
        if self.last_rv is not None:
            out.append({"k": "rv", "rv": self.last_rv})
        if self.breaker is not None:
            out.append({"k": "breaker", "snap": dict(self.breaker)})
        return out


def _read_segment(path: Path) -> tuple[list[dict], int, int]:
    """(records, good_bytes, dropped_bytes) for one segment file.
    Decoding stops at the first torn/corrupt record — everything after a
    tear is unattributable (the tear may have eaten a record boundary)."""
    data = path.read_bytes()
    records: list[dict] = []
    offset = 0
    while offset < len(data):
        end = data.find(b"\n", offset)
        if end < 0:
            break  # torn tail: no newline
        line = data[offset:end + 1]
        rec = _decode_line(line)
        if rec is None:
            break  # corrupt record: stop here, drop the rest
        records.append(rec)
        offset = end + 1
    return records, offset, len(data) - offset


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class DecisionJournal:
    """One replica's durable decision journal (module docstring).

    Thread-safe: binds journal from the event loop AND executor threads.
    The instance keeps the folded :class:`JournalState` current as it
    appends, so rotation compacts without a re-read and recovery starts
    from ``self.state`` the moment the journal opens."""

    def __init__(
        self,
        root: str | Path,
        *,
        fsync_policy: str = "intent",
        segment_max_records: int = 4096,
    ) -> None:
        if fsync_policy not in _FSYNC_POLICIES:
            raise JournalError(
                f"unknown fsync policy {fsync_policy!r} "
                f"(known: {_FSYNC_POLICIES})"
            )
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.fsync_policy = fsync_policy
        self.segment_max_records = int(segment_max_records)
        # single-writer guard: two live journals over one directory
        # would rotate each other's active segment out from underneath
        # (`cli journal compact` racing a running scheduler). flock is
        # advisory but both writers are this class; the lock dies with
        # the process, so a crashed holder never wedges recovery.
        self._lock_fd = os.open(
            self.root / ".lock", os.O_CREAT | os.O_RDWR, 0o644
        )
        try:
            import fcntl

            fcntl.flock(self._lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(self._lock_fd)
            raise JournalError(
                f"journal {self.root} is held by a live writer (a "
                f"running scheduler?) — stop it before fsck/compact"
            ) from None
        self._lock = threading.Lock()
        self.state = JournalState()
        self.torn_bytes_dropped = 0
        self.appends = 0
        self.fsyncs = 0
        # sweep rotation debris (never a visible segment, always safe)
        for stale in self.root.glob(".staging-*"):
            stale.unlink(missing_ok=True)
        segments = self._segments()
        for i, seg in enumerate(segments):
            records, good, dropped = _read_segment(seg)
            for rec in records:
                self.state.apply(rec)
            if dropped:
                self.torn_bytes_dropped += dropped
                logger.warning(
                    "journal %s: dropped %d torn byte(s) from %s",
                    self.root, dropped, seg.name,
                )
                # crash-consistency: physically truncate the tear so new
                # appends never concatenate onto garbage
                with open(seg, "ab") as fh:
                    fh.truncate(good)
                    fh.flush()
                    os.fsync(fh.fileno())
        if segments:
            self._seg_path = segments[-1]
            self._seg_index = int(segments[-1].stem.split("-")[1])
            records, _good, _dropped = _read_segment(self._seg_path)
            self._seg_records = len(records)
        else:
            self._seg_index = 1
            self._seg_path = self.root / _SEG_FMT.format(1)
            self._seg_path.touch()
            self._seg_records = 0
        self._fh = open(self._seg_path, "ab")

    def _segments(self) -> list[Path]:
        return sorted(self.root.glob("seg-*.log"))

    # -------------------------------------------------------------- appends
    def _append(self, rec: dict, durable: bool) -> None:
        line = _encode(rec)
        with self._lock:
            fh = self._fh
            if fh is None:
                raise JournalError(f"journal {self.root} is closed")
            fh.write(line)
            if durable and self.fsync_policy != "none":
                # flush + fsync carry every buffered record down with
                # this one: after an intent sync, its decide (and any
                # earlier acks/rvs) are durable too
                fh.flush()
                os.fsync(fh.fileno())
                self.fsyncs += 1
            self.appends += 1
            self.state.apply(rec)
            self._seg_records += 1
            if self._seg_records >= self.segment_max_records:
                self._rotate_locked()

    def record_decide(self, namespace: str, name: str, node: str) -> None:
        self._append(
            {"k": "decide", "ns": namespace, "name": name, "node": node},
            durable=self.fsync_policy == "always",
        )

    def record_intent(
        self, namespace: str, name: str, node: str,
        shard: int | None = None, epoch: int | None = None,
    ) -> None:
        """THE write-ahead record: durable (under the default policy)
        before the bind leaves for the apiserver."""
        self._append(
            {"k": "intent", "ns": namespace, "name": name, "node": node,
             "shard": shard, "epoch": epoch},
            durable=self.fsync_policy in ("always", "intent"),
        )

    def record_ack(
        self, namespace: str, name: str, node: str, ok: bool,
        recovered: bool = False,
    ) -> None:
        self._append(
            {"k": "ack", "ns": namespace, "name": name, "node": node,
             "ok": bool(ok), "recovered": bool(recovered)},
            durable=self.fsync_policy == "always",
        )

    def record_drop(self, namespace: str, name: str, reason: str) -> None:
        """Close a lifecycle whose pod is GONE (deleted while we were
        down): nothing to bind, nothing to ack."""
        self._append(
            {"k": "drop", "ns": namespace, "name": name, "reason": reason},
            durable=self.fsync_policy == "always",
        )

    def record_rv(self, rv: str) -> None:
        """Informer watch position. Buffered under the default policy (a
        lost rv record widens the recovery relist by a few events, it
        can never lose a pod); "always" syncs it like everything else.
        De-duplicated: bookmark-heavy quiet streams must not grow the
        journal."""
        if self.state.last_rv == rv:
            return
        self._append(
            {"k": "rv", "rv": str(rv)},
            durable=self.fsync_policy == "always",
        )

    def record_breaker(self, snap: dict) -> None:
        """Breaker transition snapshot (core/breaker.py journal_sink): a
        rebooted replica restores OPEN with its remaining cooldown
        instead of hammering a backend the fleet knows is down. Synced
        like an intent (trips are rare and the whole point is surviving
        the crash that tends to FOLLOW a dying backend)."""
        self._append(
            {"k": "breaker", "snap": dict(snap)},
            durable=self.fsync_policy in ("always", "intent"),
        )

    # ------------------------------------------------------------- rotation
    def _rotate_locked(self) -> None:
        """Compact the live state into a fresh segment (write-aside +
        os.replace — rollout/registry.py discipline) and drop the old
        segments. Caller holds self._lock."""
        old_segments = self._segments()
        next_index = self._seg_index + 1
        final = self.root / _SEG_FMT.format(next_index)
        staging = self.root / f".staging-{final.name}"
        records = self.state.snapshot_records()
        with open(staging, "wb") as fh:
            for rec in records:
                fh.write(_encode(rec))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(staging, final)
        _fsync_dir(self.root)
        self._fh.close()
        self._fh = open(final, "ab")
        self._seg_path = final
        self._seg_index = next_index
        self._seg_records = len(records)
        # keep the in-memory fold consistent with what is now on disk:
        # the compacted segment no longer mentions acked lifecycles, so
        # the acked book resets to the post-rotation window (the chaos
        # monitor's finalize_journal judges that window — its runs never
        # rotate mid-flight)
        self.state.acked.clear()
        for seg in old_segments:
            if seg != final:
                seg.unlink(missing_ok=True)
        _fsync_dir(self.root)
        logger.info(
            "journal %s: compacted to %s (%d live record(s))",
            self.root, final.name, len(records),
        )

    def compact(self) -> dict:
        """Force a rotation now (the `cli journal compact` surface)."""
        with self._lock:
            before = self._seg_records
            self._rotate_locked()
            return {
                "segment": self._seg_path.name,
                "records_before": before,
                "records_after": self._seg_records,
            }

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._fh.close()
                self._fh = None
            self._release_writer_lock_locked()

    def _release_writer_lock_locked(self) -> None:
        if self._lock_fd is not None:
            os.close(self._lock_fd)  # closing the fd drops the flock
            self._lock_fd = None

    def abandon(self) -> None:
        """Drop the file handle WITHOUT flushing — the simulated-crash
        teardown (chaos harness / tests). A real crash would not flush
        either; everything already flushed per append stays durable.
        The buffered bytes must be LOST, not written late: the fd is
        redirected to /dev/null before the handle is dropped, so the
        BufferedWriter's eventual GC flush lands harmlessly there
        instead of in whatever file has since reused the fd number."""
        with self._lock:
            fh = self._fh
            self._fh = None
            if fh is not None:
                devnull = os.open(os.devnull, os.O_WRONLY)
                try:
                    os.dup2(devnull, fh.fileno())
                finally:
                    os.close(devnull)
            self._release_writer_lock_locked()

    # ------------------------------------------------------------- tooling
    def stats(self) -> dict:
        with self._lock:
            return {
                "root": str(self.root),
                "segment": self._seg_path.name,
                "segment_records": self._seg_records,
                "appends": self.appends,
                "fsyncs": self.fsyncs,
                "fsync_policy": self.fsync_policy,
                "open_decisions": len(self.state.open_decisions),
                "open_intents": len(self.state.open_intents),
                "acked": len(self.state.acked),
                "last_rv": self.state.last_rv,
                "torn_bytes_dropped": self.torn_bytes_dropped,
                "counts": dict(self.state.counts),
            }


def replay(root: str | Path) -> JournalState:
    """Fold every segment under `root` into a JournalState without
    opening (or mutating) the journal — the read-only half of recovery
    and of `cli journal fsck`."""
    state = JournalState()
    for seg in sorted(Path(root).glob("seg-*.log")):
        records, _good, _dropped = _read_segment(seg)
        for rec in records:
            state.apply(rec)
    return state


def iter_records(root: str | Path) -> Iterator[tuple[str, dict]]:
    """(segment name, record) stream for `cli journal show`."""
    for seg in sorted(Path(root).glob("seg-*.log")):
        records, _good, _dropped = _read_segment(seg)
        for rec in records:
            yield seg.name, rec


def fsck(root: str | Path) -> dict:
    """Per-segment integrity report: record counts, torn bytes, and the
    folded end state. ok=True means every byte decodes (a torn tail is
    RECOVERABLE — replay truncates it — but fsck surfaces it so an
    operator knows a crash landed mid-write)."""
    root = Path(root)
    segments = []
    total_torn = 0
    state = JournalState()
    for seg in sorted(root.glob("seg-*.log")):
        records, good, dropped = _read_segment(seg)
        for rec in records:
            state.apply(rec)
        total_torn += dropped
        segments.append({
            "segment": seg.name,
            "records": len(records),
            "bytes": good,
            "torn_bytes": dropped,
        })
    return {
        "root": str(root),
        "ok": total_torn == 0,
        "segments": segments,
        "torn_bytes": total_torn,
        "open_decisions": len(state.open_decisions),
        "open_intents": len(state.open_intents),
        "acked": len(state.acked),
        "last_rv": state.last_rv,
        "counts": dict(state.counts),
    }
