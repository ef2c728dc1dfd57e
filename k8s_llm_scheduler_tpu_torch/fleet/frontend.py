"""Fleet frontend: N sharded scheduler replicas over one cluster.

This is the composition layer the rest of `fleet/` exists for. Each
`FleetReplica` is a complete serving stack — Scheduler loop,
DecisionClient with a TieredDecisionCache (private L1 over the fleet's
shared L2), its own DecisionBackend — whose watch space is filtered to
the shards its LeaseManager currently holds. The `Fleet` object wires
replicas to the shared pieces (LeaseStore, L2, cluster) and runs them
as tasks on one event loop: the honest in-process twin of a
one-process-per-replica deployment, and the shape `bench.py --preset
fleet` and the failover tests drive.

Correctness story for failover (the part that must be exact):

1. a pod's shard never changes (hash of namespace/name);
2. each replica's watch filter drops pods of shards it does not hold —
   at most one replica SCHEDULES a pod at a time;
3. the fenced binder re-checks shard ownership against the lease
   manager at bind time, so a decision computed under a lease that
   expired mid-flight is discarded, not bound;
4. the cluster is the source of truth: bind of an already-bound pod
   fails at the apiserver (and at cluster/fake.py), so even a fencing
   race cannot double-bind — it can only waste one bind attempt;
5. when a replica gains a shard (initial claim or failover), it
   re-lists the cluster's still-pending pods for that shard and
   schedules them — pods the dead replica already bound are no longer
   pending, so the rebind pass is naturally exactly-once.
"""

from __future__ import annotations

import asyncio
import logging
from collections.abc import Sequence
from typing import Any, Callable

from k8s_llm_scheduler_tpu_torch.cluster.interface import Binder, ClusterState, RawPod
from k8s_llm_scheduler_tpu_torch.core.breaker import CircuitBreaker
from k8s_llm_scheduler_tpu_torch.core.cache import DecisionCache
from k8s_llm_scheduler_tpu_torch.fleet.cache import TieredDecisionCache
from k8s_llm_scheduler_tpu_torch.fleet.lease import (
    LeaseManager,
    LeaseStore,
    assign_initial,
    shard_of,
)
from k8s_llm_scheduler_tpu_torch.sched.client import DecisionClient
from k8s_llm_scheduler_tpu_torch.sched.loop import Scheduler

logger = logging.getLogger(__name__)


class _ShardView:
    """ClusterState filtered to one replica's live shard set. Node reads
    pass through untouched (every replica needs the full snapshot — the
    decision prompt is cluster-wide); only the pending-pod stream is
    partitioned."""

    def __init__(
        self, inner: ClusterState, owns: Callable[[int], bool],
        n_shards: int,
    ) -> None:
        self._inner = inner
        self._owns = owns
        self._n_shards = n_shards

    def get_node_metrics(self):
        return self._inner.get_node_metrics()

    async def watch_pending_pods(self, scheduler_name: str):
        async for raw in self._inner.watch_pending_pods(scheduler_name):
            if self._owns(shard_of(raw.namespace, raw.name, self._n_shards)):
                yield raw
            # else: not ours — the shard's holder sees its own copy of
            # the event; an UNHELD shard's pods are picked up by the
            # rebind pass when some replica claims the shard


class _FencedBinder:
    """Bind-time lease fencing (correctness point 3 above).

    Two checks, cheapest first: the replica's LOCAL lease view (`owns` —
    lock-free set membership, catches the common case where the manager
    already processed a loss), then the STORE's fencing token (`verify`,
    backed by LeaseStore.check_fence with this replica's believed epoch).
    The store check is what makes the fence exact: a replica partitioned
    from the store keeps BELIEVING it holds its shards (its local view
    cannot learn otherwise), and before this check it would keep binding
    them while a survivor — which already claimed the shards under a new
    epoch — binds them too; the cluster's 409 made that a wasted bind and
    a nondeterministic winner. With the store check, a stale or
    unverifiable fencing token fails CLOSED: the bind is refused, the pod
    stays pending, and the shard's live holder (per the store) is the
    only replica that can land it. Cost: one store read per bind (a lock
    acquisition in-process; the apiserver Lease read a k8s-backed store
    would do)."""

    def __init__(
        self, inner: Binder, owns: Callable[[int], bool], n_shards: int,
        on_fenced: Callable[[], None] | None = None,
        verify: Callable[[int], bool] | None = None,
    ) -> None:
        self._inner = inner
        self._owns = owns
        self._n_shards = n_shards
        self._on_fenced = on_fenced
        self._verify = verify
        # preserve the loop's inline-bind fast path for in-memory binders
        self.bind_is_nonblocking = getattr(inner, "bind_is_nonblocking", False)

    def bind_pod_to_node(
        self, pod_name: str, namespace: str, node_name: str
    ) -> bool:
        shard = shard_of(namespace, pod_name, self._n_shards)
        fenced = not self._owns(shard)
        if not fenced and self._verify is not None:
            fenced = not self._verify(shard)
        if fenced:
            logger.warning(
                "fenced bind dropped: %s/%s -> %s (lease no longer held)",
                namespace, pod_name, node_name,
            )
            if self._on_fenced is not None:
                self._on_fenced()
            return False
        return self._inner.bind_pod_to_node(pod_name, namespace, node_name)


class FleetReplica:
    """One sharded scheduler replica (see module docstring)."""

    def __init__(
        self,
        replica_id: int,
        *,
        cluster: ClusterState,
        binder: Binder,
        backend: Any,
        store: LeaseStore,
        l2: DecisionCache,
        scheduler_name: str,
        l1_size: int = 256,
        renew_interval_s: float = 1.5,
        max_concurrency: int = 64,
        snapshot_ttl_s: float = 1.0,
        list_pending: Callable[[], Sequence[RawPod]] | None = None,
        journal: Any = None,
    ) -> None:
        self.replica_id = replica_id
        self.holder = f"replica-{replica_id}"
        self.backend = backend  # kept for teardown on elastic removal
        self._list_pending = list_pending
        self._loop: asyncio.AbstractEventLoop | None = None
        self.fenced_binds = 0
        self.manager = LeaseManager(
            store, self.holder,
            renew_interval_s=renew_interval_s,
            on_gain=self._on_gain,
        )
        self.cache = TieredDecisionCache(l2, l1_size=l1_size)
        self.client = DecisionClient(
            backend,
            cache=self.cache,
            breaker=CircuitBreaker(),
            retry_delay=0.05,
        )
        n_shards = store.n_shards
        # Durable decision journal (sched/journal.py): the bind chain
        # becomes fence(journal(binder)) — INSIDE the fence, so a
        # fenced-off bind never creates a recovery obligation — and the
        # breaker journals its trips so a restart restores OPEN with its
        # remaining cooldown. None (the default) costs nothing.
        self.journal = journal
        self._journaled_binder = None
        if journal is not None:
            from k8s_llm_scheduler_tpu_torch.sched.recovery import JournaledBinder

            self._journaled_binder = JournaledBinder(
                binder, journal,
                shard_fn=lambda ns, name: shard_of(ns, name, n_shards),
                epoch_fn=self.manager.epoch_of,
            )
            binder = self._journaled_binder
            self.client.breaker.journal_sink = journal.record_breaker
        self.scheduler = Scheduler(
            _ShardView(cluster, self.manager.owns, n_shards),
            _FencedBinder(
                binder, self.manager.owns, n_shards, self._note_fenced,
                verify=self._store_fence,
            ),
            self.client,
            scheduler_name=scheduler_name,
            max_concurrency=max_concurrency,
            snapshot_ttl_s=snapshot_ttl_s,
            prefix_prewarm_s=0.0,  # the fleet router owns prewarm policy
        )
        # flight-recorder shard attribution (sched/loop stamps this on
        # every decision trace this replica records)
        self.scheduler.shard_fn = (
            lambda ns, name: shard_of(ns, name, n_shards)
        )
        self._task: asyncio.Task | None = None

    def _note_fenced(self) -> None:
        self.fenced_binds += 1  # GIL-atomic int bump; stats-only

    def _store_fence(self, shard: int) -> bool:
        """Store-side fencing-token verification for _FencedBinder: this
        replica's believed epoch must still be THE live lease. Any store
        failure (partition, apiserver outage) fails CLOSED — a bind we
        cannot verify is a bind we do not land."""
        epoch = self.manager.epoch_of(shard)
        if epoch is None:
            return False
        try:
            return self.manager.store.check_fence(shard, self.holder, epoch)
        except Exception:
            logger.warning(
                "%s: lease store unreachable at bind time for shard %d; "
                "failing closed", self.holder, shard,
            )
            return False

    # ------------------------------------------------------------- lifecycle
    async def start(self, lease_thread: bool = True) -> None:
        self._loop = asyncio.get_running_loop()
        self._task = asyncio.create_task(self.scheduler.run())
        if lease_thread:
            self.manager.start()

    async def stop(self, release_leases: bool = True) -> None:
        """Clean shutdown (releases leases) or simulated crash
        (`release_leases=False`: leases linger until TTL — failover
        tests kill replicas this way). Leases are held until the
        scheduler has drained: releasing first would fence our own
        in-flight binds and report them as failed."""
        self.scheduler.stop()
        if self._task is not None:
            try:
                await asyncio.wait_for(self._task, timeout=30)
            except asyncio.TimeoutError:
                self._task.cancel()
            self._task = None
        self.manager.stop(release=release_leases)

    # ------------------------------------------------------------- recovery
    async def recover(self, pod_lookup) -> dict:
        """Crash-restart recovery (sched/recovery.py), run after a cold
        rebuild and BEFORE start(): tick the lease manager once so the
        fenced binder answers for our shards again (an unexpired own
        lease renews at the SAME epoch; an expired one re-acquires under
        a bumped epoch — either way the completion binds below run under
        a live fence), then replay-reconcile every open journal
        lifecycle against the cluster and restore the breaker.
        `pod_lookup(ns, name) -> ("bound", node) | ("pending", None) |
        ("gone", None)` is the cluster-truth probe (cluster/kube.py
        lookup_pod_node; cluster/fake.py get_pod)."""
        if self.journal is None:
            return {}
        from k8s_llm_scheduler_tpu_torch.sched import recovery as recovery_mod

        self.manager.tick()
        crash_seam = getattr(self._journaled_binder, "crash_seam", None)
        report = await asyncio.to_thread(
            recovery_mod.recover,
            self.journal,
            pod_lookup=pod_lookup,
            binder=self.scheduler.binder,
            breaker=self.client.breaker,
            crash_seam=crash_seam,
        )
        return report.to_dict()

    # -------------------------------------------------------------- rebind
    def _on_gain(self, shards: frozenset[int]) -> None:
        """Lease-manager callback (manager tick thread OR the event loop
        in manual-tick tests): schedule a rebind scan for the gained
        shards on the replica's loop."""
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            task = asyncio.ensure_future(self._rebind(shards))
            self.scheduler._tasks.add(task)
            task.add_done_callback(self.scheduler._tasks.discard)
        else:
            asyncio.run_coroutine_threadsafe(self._rebind(shards), loop)

    async def _rebind(self, shards: frozenset[int]) -> None:
        """Re-list still-pending pods of the gained shards and schedule
        them (correctness point 5). Without a lister (live KubeCluster:
        the watch's periodic re-list re-delivers pending pods anyway)
        this is a no-op and convergence rides the watch."""
        if self._list_pending is None:
            return
        try:
            pending = await asyncio.to_thread(self._list_pending)
        except Exception:
            logger.exception("rebind re-list failed (%s)", self.holder)
            return
        n_shards = self.manager.store.n_shards
        todo = [
            raw for raw in pending
            if shard_of(raw.namespace, raw.name, n_shards) in shards
        ]
        if not todo:
            return
        logger.info(
            "%s: rebinding %d pending pod(s) from gained shards %s",
            self.holder, len(todo), sorted(shards),
        )
        await asyncio.gather(
            *(self.scheduler.schedule_pod(raw) for raw in todo),
            return_exceptions=True,
        )

    def get_stats(self) -> dict:
        return {
            "replica_id": self.replica_id,
            "owned_shards": sorted(self.manager.owned()),
            "fenced_binds": self.fenced_binds,
            "lease": self.manager.stats(),
            **self.scheduler.get_stats(),
        }

    def telemetry(
        self, since_seq: int = 0, recorder: Any = None,
        sampler: Any = None, **caps: Any,
    ) -> dict:
        """This replica's pullable telemetry payload (observability/
        fleetview.build_telemetry shape): its stats tree — per-replica
        phase histograms ride along as bucket dicts — plus an optional
        flight-recorder slice. In-process fleets share ONE process-global
        flight recorder, so `recorder` defaults to None here and
        Fleet.aggregator() attaches the shared ring to exactly one
        source; a one-process-per-replica deployment passes its own."""
        from k8s_llm_scheduler_tpu_torch.observability import fleetview

        return fleetview.build_telemetry(
            self.get_stats(), recorder, sampler, since_seq=since_seq, **caps
        )


class JoinError(RuntimeError):
    """A scale-up health gate failed (backend construction, the dial/
    prewarm probe, or a chaos-injected mid-join death). The join is
    rolled back by the caller; no partially-joined replica serves."""


class PendingJoin:
    """One in-flight scale-up: the replica is constructed, probed, and
    running, but not ADMITTED until its health gate completes — dial +
    prewarm probe already passed (start_join), first lease claim still
    pending (complete_join, driven by lease ticks). The controller holds
    this across ticks so the gate never blocks a control loop."""

    __slots__ = ("replica", "ticks_waited", "dead")

    def __init__(self, replica: FleetReplica) -> None:
        self.replica = replica
        self.ticks_waited = 0
        self.dead = False  # chaos: died mid-gate (never heartbeats)


class Fleet:
    """N replicas + the shared pieces, run on the current event loop.

    ELASTIC since the autoscale round: `start_join`/`complete_join`/
    `abort_join` grow the member set one health-gated replica at a time,
    and `remove_replica` shrinks it through the drain-before-release
    ordering FleetReplica.stop() already guarantees (in-flight decisions
    complete their binds BEFORE leases release — the PR 6 stop-ordering
    fix, now on the scale-down path). Scale events are staggered by
    construction: one join or one drain at a time, and removal below
    min 1 replica is refused, so no wave ever observes zero capacity."""

    def __init__(
        self,
        cluster: ClusterState,
        binder: Binder,
        backend_factory: Callable[[int], Any],
        *,
        n_replicas: int,
        n_shards: int | None = None,
        scheduler_name: str = "ai-llama-scheduler",
        lease_ttl_s: float = 5.0,
        renew_interval_s: float = 1.5,
        l1_size: int = 256,
        l2_size: int = 4096,
        l2_ttl_s: float = 300.0,
        max_concurrency: int = 64,
        snapshot_ttl_s: float = 1.0,
        clock=None,
        list_pending: Callable[[], Sequence[RawPod]] | None = None,
        store: LeaseStore | None = None,
        kvplane=None,
    ) -> None:
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if n_shards is None:
            # enough shards that failover redistributes in pieces, few
            # enough that the per-shard lease traffic stays trivial
            n_shards = max(2 * n_replicas, 8)
        self.n_shards = n_shards
        kwargs = {} if clock is None else {"clock": clock}
        if store is not None:
            # pluggable backend (durability.lease_store_path wires a
            # FileLeaseStore here): the caller's store must already be
            # sized for this fleet's shard space
            if store.n_shards != n_shards:
                raise ValueError(
                    f"injected lease store has {store.n_shards} shards, "
                    f"fleet wants {n_shards}"
                )
            self.store = store
        else:
            self.store = LeaseStore(n_shards, ttl_s=lease_ttl_s, **kwargs)
        self.l2 = DecisionCache(ttl_seconds=l2_ttl_s, max_size=l2_size)
        # Shared prefix-KV plane (fleet/kvplane/KVPlaneStore), one per
        # fleet: replicas whose backends can pin prefixes join it in
        # _make_replica, so ONE replica's snapshot prefill serves the
        # fleet. None = every replica prefills its own pins.
        self.kvplane = kvplane
        self._backend_factory = backend_factory
        self._mk = dict(
            cluster=cluster,
            binder=binder,
            scheduler_name=scheduler_name,
            l1_size=l1_size,
            renew_interval_s=renew_interval_s,
            max_concurrency=max_concurrency,
            snapshot_ttl_s=snapshot_ttl_s,
            list_pending=list_pending,
        )
        self._lease_threads = True  # recorded by start(); joins follow it
        # Chaos seam (chaos/faults.py, seam "scale"): None in production.
        # Interpreted at the join health gate: `join_fail` kills a
        # joining replica either at the dial/prewarm probe
        # (phase="dial") or silently mid-gate (phase="claim" — the
        # replica never heartbeats, so it never claims and the gate
        # times out into the rollback path).
        self.fault_seam = None
        # observation hook: called with a JOINING replica after its
        # probe passes and BEFORE its scheduler starts (it owns no
        # shards yet, so nothing can slip past the wrap) — the chaos
        # harness wraps binder/cache with the invariant monitor here,
        # the bench attaches its bind taps. None in production.
        self.on_replica_start: Callable[[FleetReplica], None] | None = None
        self.scale_counters = {
            "joins_started": 0,
            "joins_completed": 0,
            "joins_failed": 0,
            "removals": 0,
        }
        self.replicas = [self._make_replica(i) for i in range(n_replicas)]
        self._next_id = n_replicas

    def _make_replica(self, replica_id: int) -> FleetReplica:
        backend = self._backend_factory(replica_id)
        if self.kvplane is not None and hasattr(backend, "attach_kvplane"):
            backend.attach_kvplane(
                self.kvplane, replica=f"replica-{replica_id}"
            )
        return FleetReplica(
            replica_id,
            backend=backend,
            store=self.store,
            l2=self.l2,
            **self._mk,
        )

    async def start(self, lease_threads: bool = True) -> None:
        """Bootstrap ownership deterministically (every shard held
        before the first pod event), then start the replica loops. With
        `lease_threads=False` tests drive `tick_leases()` manually."""
        self._lease_threads = lease_threads
        assigned = assign_initial(
            self.store, [r.holder for r in self.replicas]
        )
        by_holder = {r.holder: r for r in self.replicas}
        for holder, leases in assigned.items():
            replica = by_holder[holder]
            for lease in leases:
                replica.manager.adopt(lease)
        for replica in self.replicas:
            await replica.start(lease_thread=lease_threads)

    def tick_leases(self) -> None:
        for replica in self.replicas:
            replica.manager.tick()

    async def stop(self) -> None:
        await asyncio.gather(*(r.stop() for r in self.replicas))

    async def kill_replica(self, index: int) -> None:
        """Simulated crash: the scheduler stops, leases are NOT
        released — failover happens via TTL expiry."""
        await self.replicas[index].stop(release_leases=False)

    # ----------------------------------------------------------- elasticity
    @property
    def n_live(self) -> int:
        return len(self.replicas)

    def _scale_seam_event(self, kind: str, key: str):
        seam = self.fault_seam
        return None if seam is None else seam.should(kind, key=key)

    async def start_join(self) -> PendingJoin:
        """Scale-up, phase 1 — construct + health-gate a new replica:

        1. the backend factory runs (a remote worker would be dialed
           here; a factory failure is a failed join, not a crash);
        2. the dial/prewarm probe: the backend must answer a cheap
           read (`health_probe()` when it has one, else `get_stats()`)
           — a replica that cannot answer must never enter the roster;
        3. the replica's scheduler starts and its lease manager begins
           heartbeating — it now counts toward everyone's fair share,
           so incumbents start shedding toward it.

        The replica is IN the roster from here (its watch filter owns
        nothing yet, so it schedules nothing), but the join is complete
        only when `complete_join` observes its first lease claim. Any
        failure raises JoinError after rolling the replica back out."""
        self.scale_counters["joins_started"] += 1
        replica_id = self._next_id
        holder = f"replica-{replica_id}"
        try:
            if self._scale_seam_event("join_fail", holder) is not None:
                raise JoinError(
                    f"{holder}: died mid-join (chaos join_fail)"
                )
            replica = self._make_replica(replica_id)
        except JoinError:
            self.scale_counters["joins_failed"] += 1
            raise
        except Exception as exc:
            self.scale_counters["joins_failed"] += 1
            raise JoinError(f"{holder}: backend factory failed: {exc}") from exc
        self._next_id = replica_id + 1
        join = PendingJoin(replica)
        try:
            probe = getattr(
                replica.backend, "health_probe", None
            ) or getattr(replica.backend, "get_stats", None)
            if probe is not None:
                await asyncio.to_thread(probe)
        except Exception as exc:
            self.scale_counters["joins_failed"] += 1
            self._close_backend(replica)
            raise JoinError(f"{holder}: dial/prewarm probe failed: {exc}") from exc
        # chaos gate_stall: the replica dies right AFTER the probe — it
        # never enters the roster, never heartbeats, never claims; the
        # dead flag tells the controller the death was OBSERVED, so it
        # rolls the join back on its next tick (a silent death nobody
        # observes is the separate budget-expiry path: a live joiner
        # that simply never claims)
        event = self._scale_seam_event("gate_stall", holder)
        join.dead = event is not None
        if join.dead:
            return join
        if self.on_replica_start is not None:
            self.on_replica_start(replica)
        self.replicas.append(replica)
        await replica.start(lease_thread=self._lease_threads)
        if not self._lease_threads:
            # manual-tick fleets: heartbeat immediately so the next
            # tick's fair-share census already counts the newcomer
            replica.manager.tick()
        return join

    def join_ready(self, join: PendingJoin) -> bool:
        """Has the joining replica claimed its first lease? (The last
        health-gate condition — callable from sync control loops.)"""
        return bool(join.replica.manager.owned())

    async def complete_join(self, join: PendingJoin) -> bool:
        """Scale-up, phase 2: admit the replica once it holds >= 1
        lease. Returns True when the gate is complete; the caller keeps
        driving ticks (and re-calling) until then or aborts on its
        budget."""
        join.ticks_waited += 1
        if not self.join_ready(join):
            return False
        self.scale_counters["joins_completed"] += 1
        return True

    async def abort_join(self, join: PendingJoin) -> None:
        """Failed-join rollback: stop the scheduler (drains anything in
        flight — with no shards there is nothing), release any leases it
        did claim, close the backend, and drop it from the roster. The
        fleet is exactly as it was before start_join."""
        self.scale_counters["joins_failed"] += 1
        replica = join.replica
        if replica in self.replicas:
            self.replicas.remove(replica)
        await replica.stop(release_leases=True)
        self._close_backend(replica)

    def pick_removal(self) -> FleetReplica:
        """Deterministic scale-down victim: the NEWEST replica (highest
        id). Bootstrap members persist, so repeated scale cycles churn
        the same tail instead of rotating ownership through the whole
        fleet."""
        return max(self.replicas, key=lambda r: r.replica_id)

    async def remove_replica(self, replica: FleetReplica) -> None:
        """Scale-down, drain-before-release (the PR 6 stop ordering, now
        on the controller path): the scheduler drains its in-flight
        decisions and completes their binds FIRST (leases still held, so
        the fenced binder passes), THEN leases release (survivors'
        fair-share claims converge on the freed shards), THEN the
        backend closes (socket teardown last — a decision in flight on
        the wire must never lose its transport before its bind lands).
        Refuses to shrink below one replica: a wave must never observe
        zero capacity."""
        if len(self.replicas) <= 1:
            raise ValueError("cannot remove the last replica")
        if replica not in self.replicas:
            raise ValueError(f"{replica.holder} is not in this fleet")
        self.replicas.remove(replica)
        try:
            # drains, then releases leases (FleetReplica.stop ordering)
            await replica.stop(release_leases=True)
        finally:
            self._close_backend(replica)
        self.scale_counters["removals"] += 1

    @staticmethod
    def _close_backend(replica: FleetReplica) -> None:
        close = getattr(replica.backend, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                logger.exception(
                    "%s: backend close failed during scale event",
                    replica.holder,
                )

    def aggregator(self, include_traces: bool = True):
        """A FleetAggregator over this fleet's replicas (observability/
        fleetview.py): per-replica stats sources (histograms merge
        bucket-wise into fleet percentiles) plus — because an in-process
        fleet shares one process-global flight recorder — the shared
        trace ring attached to replica 0's source only, so traces are
        pulled once, not N times."""
        from k8s_llm_scheduler_tpu_torch.observability import spans
        from k8s_llm_scheduler_tpu_torch.observability.fleetview import (
            FleetAggregator,
        )

        agg = FleetAggregator()
        for i, replica in enumerate(self.replicas):
            recorder = spans.flight if include_traces and i == 0 else None
            agg.add_source(
                replica.holder,
                lambda since, r=replica, rec=recorder:
                    r.telemetry(since_seq=since, recorder=rec),
            )
        return agg

    def get_stats(self) -> dict:
        totals = {
            "total_scheduled": 0,
            "failed_bindings": 0,
            "fenced_binds": 0,
        }
        per_replica = []
        for replica in self.replicas:
            stats = replica.get_stats()
            per_replica.append(stats)
            totals["total_scheduled"] += stats.get("total_scheduled", 0)
            totals["failed_bindings"] += stats.get("failed_bindings", 0)
            totals["fenced_binds"] += stats.get("fenced_binds", 0)
        out = {
            **totals,
            "n_shards": self.n_shards,
            "n_replicas": len(self.replicas),
            "scale": dict(self.scale_counters),
            "lease": self.store.gauges(),
            "l2": self.l2.stats(),
            "replicas": per_replica,
        }
        if self.kvplane is not None:
            # surfaces as llm_scheduler_kvplane_* in /metrics
            # (observability/metrics._flatten)
            out["kvplane"] = self.kvplane.gauges()
        return out
