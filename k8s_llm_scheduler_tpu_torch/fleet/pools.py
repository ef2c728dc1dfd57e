"""Disaggregated prefill/decode pools with prepacked admission.

The fleet-scale hazard SARATHI (arXiv:2308.16369) and Prepacking
(arXiv:2404.09529) describe at the engine layer exists at the fleet
layer too: an admission burst is PREFILL-dominated (every new cluster
snapshot pays a fresh cluster-state prefix prefill before any decision
token decodes), and if that burst lands on the same workers serving
latency-critical decode traffic, decode throughput is evicted exactly
when the cluster is busiest. The fleet answer is disaggregation — route
the two phases to distinct worker pools so they never contend:

- **prefill pool**: absorbs admission. The first decisions against a
  NEW cluster snapshot (cold prefix) go here, PREPACKED: concurrent
  short scheduler prompts against one snapshot are batched into a
  single `decide_batch` wire frame (sched/replica.py), and the worker's
  batch surface (LocalLLMBackend.get_scheduling_decisions_batch) hands
  the whole frame to the engine's PACKED CHUNKED admission
  (engine.admit_packed — block-diagonal attention over one packed token
  stream, engine/admission/). The wire-level prepack window and the
  engine-level pack are ONE mechanism: the frame that ships together
  prefills together, with no second whole-prompt prefill wave behind
  the wire batch.
- **decode pool**: serves continuation. Once a snapshot's prefix is
  WARM on the decode pool (the router fires an advisory
  `prewarm_prefix` at the decode pool the moment it first sees a
  snapshot), subsequent decisions against that snapshot are
  decode-dominated (prefix KV hit + a few dozen constrained decision
  tokens) and route here — off the admission pool entirely, so a
  concurrent admission burst cannot evict them.

Classification is by SNAPSHOT, not by pod: the cluster-state prefix is
the prefill cost, and it is keyed by the node snapshot digest — the
same equivalence class the decision cache and the engine's prefix KV
reuse are built on (core/cache._nodes_digest).

Pool roles are enforced at the worker too (`pool_role` on
LocalLLMBackend / StubBackend / ReplicaServer): a decode-role worker
REFUSES admission (`work="prefill"`) frames, so a misconfigured router
surfaces as a loud BackendError instead of silent interference.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import threading
from collections import OrderedDict
from collections.abc import Sequence
from typing import Any

from k8s_llm_scheduler_tpu_torch.core.cache import _nodes_digest
from k8s_llm_scheduler_tpu_torch.engine.backend import (
    BackendError,
    NoFeasibleNodeError,
)
from k8s_llm_scheduler_tpu_torch.observability import spans
from k8s_llm_scheduler_tpu_torch.types import NodeMetrics, PodSpec, SchedulingDecision

logger = logging.getLogger(__name__)

PREFILL = "prefill"
DECODE = "decode"
MIXED = "mixed"
POOL_ROLES = (PREFILL, DECODE, MIXED)


def check_pool_role(role: str, work: str) -> None:
    """The worker-side admission gate. A decode-pool worker refuses
    prefill (admission) work — routing bugs must fail loudly, because
    the silent version of this bug is exactly the decode-eviction
    problem disaggregation exists to prevent. Prefill and mixed roles
    accept everything (a prefill worker finishing a decision decodes
    its few output tokens itself; splitting ONE decision's KV across
    pools is an engine-layer migration this repo does not do)."""
    if role == DECODE and work == PREFILL:
        raise BackendError(
            "pool role 'decode' refuses admission (prefill) work — "
            "route new-snapshot decisions to the prefill pool"
        )


class _SnapshotWarmth:
    """Which snapshot digests are warm on the decode pool. LRU-bounded:
    snapshots churn with every cluster-state change and the router only
    cares about recent ones."""

    def __init__(self, max_entries: int = 64) -> None:
        self._warm: OrderedDict[bytes, bool] = OrderedDict()
        self._max = max_entries
        self._lock = threading.Lock()

    def is_warm(self, digest: bytes) -> bool:
        with self._lock:
            if digest in self._warm:
                self._warm.move_to_end(digest)
                return self._warm[digest]
            return False

    def note(self, digest: bytes, warm: bool) -> bool:
        """Record warmth; returns True iff this digest was NEVER seen
        before (the caller fires the decode-pool prewarm exactly once
        per snapshot)."""
        with self._lock:
            first = digest not in self._warm
            self._warm[digest] = warm or self._warm.get(digest, False)
            self._warm.move_to_end(digest)
            while len(self._warm) > self._max:
                self._warm.popitem(last=False)
            return first

    def mark_warm(self, digest: bytes) -> None:
        self.note(digest, True)


class _PendingPack:
    """One forming admission batch: pods sharing a snapshot, flushed
    together as one decide_batch frame."""

    __slots__ = ("nodes", "pods", "futures", "handle")

    def __init__(self, nodes: Sequence[NodeMetrics]) -> None:
        self.nodes = nodes
        self.pods: list[PodSpec] = []
        self.futures: list[asyncio.Future] = []
        self.handle: asyncio.TimerHandle | None = None


class DisaggregatedBackend:
    """DecisionBackend routing admission to a prefill pool and warm
    continuation to a decode pool, prepacking admission batches.

    Sits at the DecisionBackend seam below DecisionClient (like
    FanoutBackend — members may BE FanoutBackends, ReplicaClients, or
    local backends), so cache/single-flight/breaker/fallback are
    untouched: only leader decisions ever reach the router.

    An empty decode pool degrades to a pure prefill fleet (everything
    routes prefill — the pre-disaggregation behavior). Member choice
    within a pool is least-inflight.
    """

    def __init__(
        self,
        prefill_pool: Sequence[Any],
        decode_pool: Sequence[Any] = (),
        prepack_max_batch: int = 16,
        prepack_window_s: float = 0.002,
    ) -> None:
        if not prefill_pool:
            raise ValueError("DisaggregatedBackend needs a prefill pool")
        self.prefill_pool = list(prefill_pool)
        self.decode_pool = list(decode_pool)
        self.prepack_max_batch = max(1, int(prepack_max_batch))
        self.prepack_window_s = float(prepack_window_s)
        self._warmth = _SnapshotWarmth()
        self._inflight: dict[int, int] = {}  # id(member) -> count
        self._work_sig: dict[tuple[int, str], bool] = {}  # capability memo
        self._lock = threading.Lock()
        # forming packs, keyed by snapshot digest — event-loop-confined
        # (only touched from async paths on the loop thread)
        self._packs: dict[bytes, _PendingPack] = {}
        self.stats_counters = {
            "prefill_routed": 0,
            "decode_routed": 0,
            "packs_flushed": 0,
            "packed_decisions": 0,
            "prewarms_fired": 0,
        }

    # ------------------------------------------------------------ selection
    def _least_loaded(self, pool: list[Any]) -> Any:
        with self._lock:
            return min(pool, key=lambda m: self._inflight.get(id(m), 0))

    def _acquire(self, member: Any) -> None:
        with self._lock:
            self._inflight[id(member)] = self._inflight.get(id(member), 0) + 1

    def _release(self, member: Any) -> None:
        with self._lock:
            self._inflight[id(member)] = max(
                0, self._inflight.get(id(member), 0) - 1
            )

    def _note(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self.stats_counters[counter] += n

    # ------------------------------------------------------- classification
    def _classify(self, nodes: Sequence[NodeMetrics]) -> tuple[str, bytes]:
        """prefill | decode for this snapshot. New snapshots are
        admission (cold prefix -> prefill pool) and fire a one-shot
        advisory prewarm at the decode pool; a snapshot routes decode
        only once the decode pool CONFIRMED the install — until then the
        admission burst stays on the prefill pool rather than paying the
        cold prefill twice."""
        digest = _nodes_digest(nodes)
        if not self.decode_pool:
            return PREFILL, digest
        if self._warmth.is_warm(digest):
            return DECODE, digest
        if self._warmth.note(digest, warm=False):
            self._fire_decode_prewarm(digest, nodes)
        return PREFILL, digest

    def _fire_decode_prewarm(
        self, digest: bytes, nodes: Sequence[NodeMetrics]
    ) -> None:
        for member in self.decode_pool:
            fn = getattr(member, "prewarm_prefix", None)
            if fn is None:
                continue
            try:
                fut = fn(nodes)
            except Exception:
                logger.exception("decode-pool prewarm submit failed")
                continue
            if fut is None:
                continue
            self._note("prewarms_fired")

            def _done(f, d=digest) -> None:
                try:
                    ok = bool(f.result())
                except Exception:
                    ok = False
                if ok:
                    self._warmth.mark_warm(d)

            fut.add_done_callback(_done)

    # ------------------------------------------------------------ sync path
    def get_scheduling_decision(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics]
    ) -> SchedulingDecision:
        """Synchronous single-decision path (no prepacking: packing
        needs concurrent arrivals, and a blocking caller has none)."""
        work, _ = self._classify(nodes)
        pool = self.decode_pool if work == DECODE else self.prefill_pool
        member = self._least_loaded(pool)
        self._note(f"{work}_routed")
        self._stamp(work)
        self._acquire(member)
        try:
            return self._member_decide(member, pod, nodes, work)
        finally:
            self._release(member)

    def _accepts_work(self, member: Any, kind: str, fn: Any) -> bool:
        """Signature-inspected ONCE per (member, method) and memoized —
        inspect.signature costs tens of microseconds, which would rival
        the tracing budget if paid per decision. Probed, not try/except
        TypeError (which would re-invoke the member when ITS body raises
        TypeError): does this member understand the work tag?"""
        key = (id(member), kind)
        with self._lock:
            hit = self._work_sig.get(key)
        if hit is None:
            try:
                hit = "work" in inspect.signature(fn).parameters
            except (TypeError, ValueError):
                hit = False
            with self._lock:
                self._work_sig[key] = hit
        return hit

    def _member_decide(
        self, member: Any, pod: PodSpec, nodes: Sequence[NodeMetrics],
        work: str,
    ) -> SchedulingDecision:
        fn = member.get_scheduling_decision
        if self._accepts_work(member, "sync", fn):
            return fn(pod, nodes, work=work)
        return fn(pod, nodes)  # member predates the work tag

    @staticmethod
    def _stamp(work: str) -> None:
        trace = spans.current_trace()
        if trace is not None:
            trace.set_meta(pool=work)

    # ----------------------------------------------------------- async path
    async def get_scheduling_decision_async(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics]
    ) -> SchedulingDecision:
        """The fleet hot path (DecisionClient prefers it). Decode work
        routes immediately; admission parks on a forming pack keyed by
        the snapshot digest — the pack flushes as ONE decide_batch when
        it reaches prepack_max_batch or after prepack_window_s, whichever
        comes first. The window trades ~2 ms of added admission latency
        for one prefill wave instead of N; decode work never waits."""
        work, digest = self._classify(nodes)
        self._note(f"{work}_routed")
        self._stamp(work)
        if work == DECODE:
            member = self._least_loaded(self.decode_pool)
            self._acquire(member)
            try:
                return await self._member_decide_async(
                    member, pod, nodes, work
                )
            finally:
                self._release(member)

        loop = asyncio.get_running_loop()
        pack = self._packs.get(digest)
        if pack is None:
            # equal digests across DIFFERENT snapshot objects (e.g. a
            # TTL refresh on an unchanged cluster) mean identical
            # content — same prompt, safe to join the forming pack;
            # replacing it would abandon the parked futures forever.
            pack = _PendingPack(nodes)
            self._packs[digest] = pack
            pack.handle = loop.call_later(
                self.prepack_window_s, self._flush_pack, digest
            )
        fut: asyncio.Future = loop.create_future()
        pack.pods.append(pod)
        pack.futures.append(fut)
        if len(pack.pods) >= self.prepack_max_batch:
            self._flush_pack(digest)
        return await fut

    async def _member_decide_async(
        self, member: Any, pod: PodSpec, nodes: Sequence[NodeMetrics],
        work: str,
    ) -> SchedulingDecision:
        afn = getattr(member, "get_scheduling_decision_async", None)
        if afn is not None:
            if self._accepts_work(member, "async", afn):
                return await afn(pod, nodes, work=work)
            return await afn(pod, nodes)
        return await asyncio.to_thread(
            self._member_decide, member, pod, nodes, work
        )

    def _flush_pack(self, digest: bytes) -> None:
        """Detach a forming pack and ship it (runs on the event loop —
        call_later callback or the max-batch fast flush)."""
        pack = self._packs.pop(digest, None)
        if pack is None:
            return
        if pack.handle is not None:
            pack.handle.cancel()
        self._note("packs_flushed")
        self._note("packed_decisions", len(pack.pods))
        task = asyncio.ensure_future(self._ship_pack(pack))
        # containment: _ship_pack resolves every future even on member
        # failure; this callback only guards against bugs in _ship_pack
        # itself leaving callers parked forever
        task.add_done_callback(lambda t: self._pack_shipped(t, pack))

    @staticmethod
    def _pack_shipped(task: asyncio.Task, pack: _PendingPack) -> None:
        exc = task.exception() if not task.cancelled() else None
        for fut in pack.futures:
            if not fut.done():
                fut.set_exception(
                    exc if exc is not None
                    else BackendError("prepack shipment dropped its batch")
                )

    async def _ship_pack(self, pack: _PendingPack) -> None:
        member = self._least_loaded(self.prefill_pool)
        self._acquire(member)
        try:
            batch_async = getattr(
                member, "get_scheduling_decisions_batch_async", None
            )
            batch_sync = getattr(
                member, "get_scheduling_decisions_batch", None
            )
            if batch_async is not None:
                results = await batch_async(
                    pack.pods, pack.nodes, work=PREFILL
                )
            elif batch_sync is not None:
                results = await asyncio.to_thread(
                    batch_sync, pack.pods, pack.nodes, PREFILL
                )
            else:
                # member has no batch surface: fan out concurrently so
                # its engine still sees the pack together
                results = await asyncio.gather(
                    *(
                        self._member_decide_async(
                            member, pod, pack.nodes, PREFILL
                        )
                        for pod in pack.pods
                    ),
                    return_exceptions=True,
                )
        except Exception as exc:
            for fut in pack.futures:
                if not fut.done():
                    fut.set_exception(
                        BackendError(f"prepacked admission failed: {exc}")
                    )
            return
        finally:
            self._release(member)
        for fut, result in zip(pack.futures, results):
            if fut.done():
                continue
            if isinstance(result, SchedulingDecision):
                fut.set_result(result)
            elif isinstance(result, BaseException):
                fut.set_exception(result)
            else:
                fut.set_exception(
                    BackendError(f"batch member returned {type(result).__name__}")
                )

    # ------------------------------------------------------------ elasticity
    def occupancy(self) -> dict[str, float]:
        """Mean in-flight work per member, per pool — the autoscale
        controller's pool-pressure signal (fleet/autoscale.py). A pool
        with no members reads 0.0 (nothing to rebalance toward)."""
        with self._lock:
            def mean(pool: list[Any]) -> float:
                if not pool:
                    return 0.0
                total = sum(self._inflight.get(id(m), 0) for m in pool)
                return total / len(pool)

            return {
                "prefill": round(mean(self.prefill_pool), 4),
                "decode": round(mean(self.decode_pool), 4),
            }

    def fleet_geometry(self) -> "FleetGeometry":
        """The roster's slice geometry (engine/sharded/geometry.py): one
        tp-group size per member, prefill-pool members first. Members
        advertise via `slice_tp` or a live engine mesh; unknown = 1."""
        from k8s_llm_scheduler_tpu_torch.engine.sharded import FleetGeometry

        with self._lock:
            roster = [*self.prefill_pool, *self.decode_pool]
        return FleetGeometry.of(roster)

    def split_for_share(self, share: float) -> int:
        """Prefill member count for a target DEVICE share of the fleet.

        The autoscaler steers the split by occupancy share; on a
        heterogeneous fleet a member is not a unit of capacity — a tp=8
        slice is eight chips. This converts the share to device counts
        and snaps to the nearest whole device-group boundary (a split
        can move whole tp groups between pools, never a fraction of
        one), walking the prefill-affinity ordering so the chosen
        prefix is the same set set_split will select."""
        return self.fleet_geometry().split_for_device_share(share)

    def set_split(self, n_prefill: int) -> dict[str, int]:
        """Rebalance the prefill<->decode split over the SAME member
        roster (autoscale output #2). On a heterogeneous fleet the
        roster is ordered by slice geometry first — largest tp groups
        take the prefill slots (prefill is compute-bound and scales
        with group width; decode's small per-step matmuls waste wide
        slices), stable within a size class. A uniform fleet keeps the
        historical stable order (prefill members first, then decode, as
        currently assigned), so in both cases the same `n_prefill`
        always produces the same assignment — membership moves are
        deterministic, not load-timing-chosen.
        `n_prefill` clamps to [1, members] (admission must always have
        somewhere to land; 0 decode members degrades to a pure prefill
        fleet, the pre-disaggregation behavior). Members exposing a
        `pool_role` attribute are retagged so the worker-side admission
        gate (check_pool_role) stays consistent with the router's view.
        In-flight work is untouched: classification is per-decision, so
        the new split applies from the next admission on."""
        from k8s_llm_scheduler_tpu_torch.engine.sharded import FleetGeometry

        with self._lock:
            roster = [*self.prefill_pool, *self.decode_pool]
            geometry = FleetGeometry.of(roster)
            if not geometry.uniform:
                roster = [roster[i] for i in geometry.prefill_order()]
            n_prefill = max(1, min(int(n_prefill), len(roster)))
            new_prefill = roster[:n_prefill]
            new_decode = roster[n_prefill:]
            self.prefill_pool[:] = new_prefill
            self.decode_pool[:] = new_decode
        for member, role in (
            *((m, PREFILL) for m in new_prefill),
            *((m, DECODE) for m in new_decode),
        ):
            if hasattr(member, "pool_role"):
                member.pool_role = role
        return {"prefill": len(new_prefill), "decode": len(new_decode)}

    # ----------------------------------------------------------- advisories
    def prewarm_prefix(self, nodes: Sequence[NodeMetrics]):
        """Scheduler idle-prewarm advisory: forward to the PREFILL pool
        (admission lands there first); the decode pool is prewarmed by
        the router's own per-snapshot advisory. None iff no prefill
        member supports prewarming."""
        futs = []
        for member in self.prefill_pool:
            fn = getattr(member, "prewarm_prefix", None)
            if fn is None:
                continue
            fut = fn(nodes)
            if fut is not None:
                futs.append(fut)
        if not futs:
            return None
        from concurrent.futures import Future

        out: Future = Future()
        state = {"left": len(futs), "ok": True}
        lock = threading.Lock()

        def _done(f) -> None:
            try:
                ok = bool(f.result())
            except Exception:
                ok = False
            with lock:
                state["ok"] &= ok
                state["left"] -= 1
                finished = state["left"] == 0
            if finished and not out.done():
                out.set_result(state["ok"])

        for f in futs:
            f.add_done_callback(_done)
        return out

    def get_stats(self) -> dict:
        with self._lock:
            out: dict[str, Any] = {
                f"pools_{k}": v for k, v in self.stats_counters.items()
            }
        out["pools_prefill_size"] = len(self.prefill_pool)
        out["pools_decode_size"] = len(self.decode_pool)
        first = self.prefill_pool[0]
        if hasattr(first, "get_stats"):
            out.update(first.get_stats())
        return out

    def close(self) -> None:
        for member in (*self.prefill_pool, *self.decode_pool):
            if hasattr(member, "close"):
                member.close()
