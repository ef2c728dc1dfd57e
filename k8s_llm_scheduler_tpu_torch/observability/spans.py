"""Trace-id'd span tracing + the decision flight recorder.

The reference's only instrumentation is a running average of remote-API
wall time (reference scheduler.py:435-441); through round 7 our own rebuild
exported only point-in-time gauges and count/total/max phase aggregates.
Neither can answer "why was THIS pod's placement slow?" — the per-decision
question every tail-latency investigation starts with (SARATHI and
SwiftSpec both report p99 attribution across the prefill/decode boundary,
never averages). This module adds exactly that:

- **Spans**: named, trace-id'd wall-time intervals forming a tree. One
  trace per scheduling decision (sched/loop.py opens it per watch event);
  children cover snapshot / decide (backend attempts, admission wait,
  prefill, decode) / bind. Propagation is a `contextvars.ContextVar`, so
  the asyncio pipeline carries the ambient trace with zero plumbing;
  thread-crossing hops (the engine worker in engine/local.py) capture an
  explicit `SpanContext` and attach retroactive spans at harvest.
- **Cross-process stitching**: `wire_context()` serializes (trace_id,
  span_id) into a replica RPC frame; the worker opens a remote-rooted
  trace, and its serialized spans ride back in the response for
  `merge_remote_spans` to graft into the coordinator's trace
  (sched/replica.py). Span times are wall-clock (time.time) + perf_counter
  durations, so stitched trees stay meaningful across processes.
- **Flight recorder**: a bounded ring of the last N COMPLETE decision
  traces (span tree + decision metadata: source, fallback reason, cache
  key/generation, token counts), queryable via /debug/decisions and
  /debug/trace/<id> on MetricsServer and `cli trace` (list/show/tail/
  export — JSONL, replayable alongside sim traces).

Cost discipline: tracing is ON by default but every span is a dataclass
append + two clock reads; with tracing disabled (`configure(enabled=False)`
or `observability.tracing: false`) `span()` is a shared no-op context
manager and `start_trace` yields None — the knob `bench.py --preset
obs-overhead` A/Bs (< 2% of decision p50, SCALING.md).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Iterator

_id_counter = itertools.count(1)
_ID_LOCK = threading.Lock()
_PROC_TAG = f"{time.time_ns() & 0xFFFFFF:06x}"


def _new_id() -> str:
    # monotonic counter + per-process tag: unique, cheap (no os.urandom on
    # the per-decision hot path), and stable for tests to compare
    with _ID_LOCK:
        n = next(_id_counter)
    return f"{_PROC_TAG}-{n:x}"


@dataclasses.dataclass
class Span:
    """One named wall-time interval in a trace tree.

    `start_unix` is wall-clock (time.time) so spans stitched across
    processes stay ordered; `dur_ms` comes from perf_counter deltas so
    durations keep sub-ms resolution. `dur_ms` is None while the span is
    open."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    start_unix: float
    dur_ms: float | None = None
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    status: str = "ok"

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_unix": self.start_unix,
            "dur_ms": self.dur_ms,
            # copy, never alias: span() callers mutate the live attrs dict
            # mid-block (engine wave/spec counters), while a recorded ring
            # entry may be serialized by a /debug handler thread at any
            # time — an aliased dict is the same changed-size-during-
            # iteration race set_meta exists to prevent for trace meta
            "attrs": dict(self.attrs),
            "status": self.status,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Span":
        return cls(
            name=d["name"],
            trace_id=d["trace_id"],
            span_id=d["span_id"],
            parent_id=d.get("parent_id"),
            start_unix=float(d.get("start_unix", 0.0)),
            dur_ms=d.get("dur_ms"),
            attrs=dict(d.get("attrs") or {}),
            status=d.get("status", "ok"),
        )


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """Wire/thread-portable handle: enough to parent new spans under an
    existing trace from another thread or process."""

    trace_id: str
    span_id: str


class Trace:
    """One decision's span collection. Spans append under a lock — the
    engine worker and the asyncio loop both write to the same trace."""

    __slots__ = ("trace_id", "root", "spans", "meta", "_lock", "_recorder")

    def __init__(self, name: str, trace_id: str | None = None,
                 parent_id: str | None = None, **attrs: Any) -> None:
        self.trace_id = trace_id or _new_id()
        self._lock = threading.Lock()
        self.spans: list[Span] = []
        # decision metadata stamped by the pipeline as it learns things
        # (source, fallback reason, cache key, token counts, ...)
        self.meta: dict[str, Any] = {}
        # set by FlightRecorder.record: spans attached AFTER the root
        # closed (a timed-out decision whose wave harvests later) re-
        # publish the serialized ring entry instead of being silently lost
        self._recorder = None
        self.root = Span(
            name=name,
            trace_id=self.trace_id,
            span_id=_new_id(),
            parent_id=parent_id,
            start_unix=time.time(),  # graftlint: ok[raw-clock] — spans are wall-ANCHORED by design so trees stitch across processes
            attrs=dict(attrs),
        )
        self.spans.append(self.root)

    def add_span(
        self,
        name: str,
        start_unix: float,
        dur_ms: float,
        parent_id: str | None = None,
        status: str = "ok",
        publish: bool = True,
        **attrs: Any,
    ) -> Span:
        """Attach a RETROACTIVE span (interval already over) — the shape
        thread-crossing producers need: the engine worker learns a wave's
        timings only at harvest, long after the interval started.

        `publish=False` defers the ring re-publication for batch
        producers — call flush() once after the last span instead of
        paying a full reserialization per span."""
        sp = Span(
            name=name,
            trace_id=self.trace_id,
            span_id=_new_id(),
            parent_id=parent_id or self.root.span_id,
            start_unix=start_unix,
            dur_ms=float(dur_ms),
            attrs=dict(attrs),
            status=status,
        )
        with self._lock:
            self.spans.append(sp)
        if publish:
            self.flush()
        return sp

    def set_meta(self, **meta: Any) -> None:
        """Stamp decision metadata under the trace lock.

        Stamps arrive from the pipeline (sched/loop, sched/client, cli)
        while a metrics-server handler thread may be serializing this
        very trace for /debug/decisions — an unguarded `self.meta[...] =`
        during to_dict's `dict(self.meta)` copy is a "dictionary changed
        size during iteration" RuntimeError that kills the scrape.
        (Found by this PR's concurrency sweep; direct `trace.meta[...]`
        writes outside this module are the hazard.)"""
        with self._lock:
            self.meta.update(meta)

    def flush(self) -> None:
        """Re-publish this trace's ring entry if it was already recorded
        (root closed before this producer caught up — e.g. the decision
        timed out and fell back while its wave was still on device), so
        /debug/trace shows the engine attribution for exactly the tail
        decisions the recorder exists to explain. No-op pre-record."""
        recorder = self._recorder
        if recorder is not None:
            recorder.refresh(self)

    def merge_remote_spans(self, spans: list[dict]) -> int:
        """Graft spans serialized by a remote process (sched/replica.py
        response frames) into this trace. Only spans carrying this trace's
        id are accepted — a desynced frame must not pollute the tree."""
        merged = 0
        for d in spans:
            try:
                sp = Span.from_dict(d)
            except (KeyError, TypeError, ValueError):
                continue
            if sp.trace_id != self.trace_id:
                continue
            with self._lock:
                self.spans.append(sp)
            merged += 1
        if merged:
            self.flush()
        return merged

    def to_dict(self) -> dict[str, Any]:
        with self._lock:
            # meta copied under the SAME lock set_meta writes under — a
            # concurrent stamp must not blow up this serialization
            spans = [s.to_dict() for s in self.spans]
            meta = dict(self.meta)
        return {
            "trace_id": self.trace_id,
            "name": self.root.name,
            "start_unix": self.root.start_unix,
            "dur_ms": self.root.dur_ms,
            "status": self.root.status,
            "meta": meta,
            "spans": spans,
        }

    def span_tree(self) -> dict[str, Any]:
        """The span tree (children nested), for humans and tests."""
        with self._lock:
            dicts = [s.to_dict() for s in self.spans]
        return build_span_tree(dicts)


def build_span_tree(span_dicts: list[dict]) -> dict[str, Any]:
    """Nest serialized spans by parent_id (shared by Trace.span_tree and
    `cli trace show`, which only has the wire form). Spans whose parent is
    not in the set (a remote root whose parent lived on the other side of
    the wire before merging, or an orphan) hang off the local root."""
    ids = {s["span_id"] for s in span_dicts}
    by_parent: dict[str | None, list[dict]] = {}
    for s in span_dicts:
        parent = s.get("parent_id") if s.get("parent_id") in ids else None
        by_parent.setdefault(parent, []).append(s)

    def node(s: dict) -> dict[str, Any]:
        kids = sorted(
            by_parent.get(s["span_id"], []),
            key=lambda c: c.get("start_unix", 0.0),
        )
        return {**s, "children": [node(k) for k in kids]}

    roots = sorted(
        by_parent.get(None, []), key=lambda s: s.get("start_unix", 0.0)
    )
    # single decision root in the normal case; keep the forest shape for
    # robustness against multiple orphans
    return node(roots[0]) if len(roots) == 1 else {
        "name": "forest", "children": [node(r) for r in roots],
    }


# ------------------------------------------------------------ ambient state
_current: contextvars.ContextVar[tuple[Trace, Span] | None] = (
    contextvars.ContextVar("obs_span", default=None)
)


class _NullCtx:
    """Shared no-op context manager: the disabled/traceless fast path must
    not allocate per call."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL = _NullCtx()


def budget_slice(
    matched: list[dict],
    since_seq: int = 0,
    max_traces: int | None = None,
    max_bytes: int | None = None,
) -> tuple[list[dict], int, bool]:
    """Apply trace-count + byte caps to cursor-ordered entries (each
    carrying a `seq`). Returns (kept, next_cursor, truncated) — the one
    budget loop behind FlightRecorder.export_slices (/debug/export,
    telemetry_pull) and /debug/decisions' summary pagination. At least
    one entry is always kept when any matched, so a single oversized
    entry cannot wedge the cursor."""
    entries: list[dict] = []
    next_cursor = since_seq
    spent = 0
    truncated = False
    for e in matched:
        if max_traces is not None and len(entries) >= max_traces:
            truncated = True
            break
        size = len(json.dumps(e, separators=(",", ":")))
        if max_bytes is not None and entries and spent + size > max_bytes:
            truncated = True
            break
        entries.append(e)
        spent += size
        next_cursor = e["seq"]
    return entries, next_cursor, truncated


class FlightRecorder:
    """Bounded ring of the last N complete decision traces.

    `seq` is a monotonically increasing completion counter so `cli trace
    tail` can poll for "traces since X" without re-reading the ring."""

    def __init__(self, capacity: int = 256) -> None:
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        # deque(maxlen): O(1) eviction — record() runs synchronously at
        # root-span close on the scheduler loop, so a full ring must not
        # pay a per-decision element shift
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self.seq = 0

    def record(self, trace: Trace) -> None:
        # _recorder is set BEFORE serializing: a producer attaching a span
        # concurrently with the root close then either lands in the
        # serialization, or sees _recorder and refreshes. Its refresh can
        # still no-op if it runs before the insert below — the post-insert
        # drift check closes that window.
        trace._recorder = self
        entry = trace.to_dict()
        with self._lock:
            self.seq += 1
            entry["seq"] = self.seq
            self._ring.append(entry)
        with trace._lock:
            drifted = len(trace.spans) != len(entry["spans"])
        if drifted:
            self.refresh(trace)

    def refresh(self, trace: Trace) -> None:
        """Replace this trace's ring entry with a fresh serialization
        (same seq). Rare path — only spans attached after the root
        closed; a no-op once the ring evicted the entry."""
        entry = trace.to_dict()
        with self._lock:
            for i, old in enumerate(self._ring):
                if old["trace_id"] == trace.trace_id:
                    entry["seq"] = old["seq"]
                    self._ring[i] = entry
                    return

    def list(
        self, n: int | None = 50, since_seq: int = 0,
    ) -> list[dict]:
        """Newest-last summaries (cheap fields only — the list endpoint
        must stay small at ring capacity). `n` keeps the NEWEST n (the
        recent-traces view); pass None for every match past the cursor —
        what a forward-pagination walk needs, since a newest-n cut would
        silently skip older entries without marking truncation."""
        with self._lock:
            entries = [e for e in self._ring if e["seq"] > since_seq]
        if n is not None:
            entries = entries[-n:]
        return [
            {
                "seq": e["seq"],
                "trace_id": e["trace_id"],
                "name": e["name"],
                "start_unix": e["start_unix"],
                "dur_ms": e["dur_ms"],
                "status": e["status"],
                "n_spans": len(e["spans"]),
                "meta": e["meta"],
            }
            for e in entries
        ]

    def get(self, trace_id: str) -> dict | None:
        with self._lock:
            for e in reversed(self._ring):
                if e["trace_id"] == trace_id:
                    return e
        return None

    def export_jsonl(self) -> str:
        """One canonical-JSON trace per line — the same file shape sim
        traces use, so recorded decisions replay alongside them."""
        with self._lock:
            entries = list(self._ring)
        return "".join(
            json.dumps(e, sort_keys=True, separators=(",", ":")) + "\n"
            for e in entries
        )

    def export_slices(
        self,
        since_seq: int = 0,
        max_traces: int | None = None,
        max_bytes: int | None = None,
    ) -> tuple[list[dict], int, bool]:
        """Since-cursor trace slices with a HARD response-size cap.

        Returns (entries, next_cursor, truncated). `next_cursor` is the
        last included entry's seq (or `since_seq` when nothing fit) — pass
        it back as `since_seq` to resume; `truncated` is True when more
        entries matched the cursor than the caps allowed. This is the
        shape a 16-replica `telemetry_pull` fans in: without the cap one
        frame could ship the whole ring per replica per scrape
        (observability/fleetview.py; /debug/export routes through it too,
        and /debug/decisions applies the same `budget_slice` to its
        summaries). The byte budget counts each entry's canonical-JSON
        size; at least one entry is always shipped when any matches, so a
        single oversized trace cannot wedge the cursor."""
        with self._lock:
            matched = [e for e in self._ring if e["seq"] > since_seq]
        return budget_slice(
            matched, since_seq=since_seq,
            max_traces=max_traces, max_bytes=max_bytes,
        )

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"recorded": self.seq, "held": len(self._ring),
                    "capacity": self.capacity}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


# Process-global defaults — components grab tracing without plumbing, the
# same idiom as observability.trace.recorder.
flight = FlightRecorder()
_enabled = True


def configure(enabled: bool | None = None, capacity: int | None = None) -> None:
    """Apply the `observability.*` config block (cli wiring)."""
    global _enabled, flight
    if enabled is not None:
        _enabled = bool(enabled)
    if capacity is not None and capacity != flight.capacity:
        flight = FlightRecorder(capacity)


def enabled() -> bool:
    return _enabled


def start_trace(
    name: str,
    recorder: FlightRecorder | None = None,
    trace_id: str | None = None,
    parent_id: str | None = None,
    start_unix: float | None = None,
    start_perf: float | None = None,
    **attrs: Any,
):
    """Open a new trace and make it ambient for the block. On exit the
    root span closes and the trace publishes to `recorder` (default: the
    global flight recorder). Yields None (via the shared no-op context
    manager — no per-call allocation) when tracing is disabled.

    `start_unix`/`start_perf` BACKDATE the root: the fast/follower paths
    open their trace only after the decision already resolved, and without
    backdating the root would cover just the bind — the list view's
    duration column would filter out exactly the slow decisions it exists
    to surface."""
    if not _enabled:
        return _NULL
    return _start_trace_cm(
        name, recorder, trace_id, parent_id, start_unix, start_perf, attrs
    )


@contextlib.contextmanager
def _start_trace_cm(
    name, recorder, trace_id, parent_id, start_unix, start_perf, attrs
) -> Iterator[Trace]:
    trace = Trace(name, trace_id=trace_id, parent_id=parent_id, **attrs)
    if start_unix is not None:
        trace.root.start_unix = start_unix
    t0 = start_perf if start_perf is not None else time.perf_counter()
    token = _current.set((trace, trace.root))
    try:
        yield trace
    except BaseException:
        trace.root.status = "error"
        raise
    finally:
        _current.reset(token)
        trace.root.dur_ms = (time.perf_counter() - t0) * 1000.0
        (recorder if recorder is not None else flight).record(trace)


def span(name: str, **attrs: Any):
    """Child span under the ambient trace; without one (or with tracing
    disabled) returns the SHARED no-op context manager — the hot path
    allocates nothing. The caller may mutate the yielded span's attrs
    mid-block."""
    cur = _current.get() if _enabled else None
    if cur is None:
        return _NULL
    return _span_cm(name, cur, attrs)


@contextlib.contextmanager
def _span_cm(
    name: str, cur: tuple[Trace, Span], attrs: dict
) -> Iterator[Span]:
    trace, parent = cur
    sp = Span(
        name=name,
        trace_id=trace.trace_id,
        span_id=_new_id(),
        parent_id=parent.span_id,
        start_unix=time.time(),  # graftlint: ok[raw-clock] — spans are wall-ANCHORED by design so trees stitch across processes
        attrs=attrs,
    )
    with trace._lock:
        trace.spans.append(sp)
    t0 = time.perf_counter()
    token = _current.set((trace, sp))
    try:
        yield sp
    except BaseException:
        sp.status = "error"
        raise
    finally:
        _current.reset(token)
        sp.dur_ms = (time.perf_counter() - t0) * 1000.0


def current_trace() -> Trace | None:
    cur = _current.get()
    return cur[0] if cur is not None else None


def context() -> SpanContext | None:
    """Portable handle to the ambient span (for thread-crossing hops)."""
    cur = _current.get() if _enabled else None
    if cur is None:
        return None
    trace, sp = cur
    return SpanContext(trace_id=trace.trace_id, span_id=sp.span_id)


def capture() -> tuple[Trace, SpanContext] | None:
    """(trace handle, span context) for producers that will attach
    retroactive spans from another thread (engine/local.py work items)."""
    cur = _current.get() if _enabled else None
    if cur is None:
        return None
    trace, sp = cur
    return trace, SpanContext(trace_id=trace.trace_id, span_id=sp.span_id)


def wire_context() -> dict[str, str] | None:
    """The cross-process form: a small dict for an RPC frame
    (sched/replica.py adds it as the "trace" field)."""
    ctx = context()
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "span_id": ctx.span_id}
