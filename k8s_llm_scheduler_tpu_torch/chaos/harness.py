"""Wave-barriered chaos runner: one regime, the real stack, a verdict.

The harness is the arena's (sim/arena.py) robustness counterpart. It
takes a regime name + seed, generates BOTH sides of the experiment from
that seed — the workload (a `sim/scenarios.chaos_scenario` wave
scenario) and the fault schedule (`chaos/faults.FaultPlan`) — and runs
them through one of three production stacks:

- **single**: Scheduler over the wire-level fake API server
  (cluster/wire_fake.py) through the REAL cluster/kube.py watch/
  informer/bind paths — the stack `cli run` deploys, minus the model.
- **wire**: single, plus a real ReplicaServer/ReplicaClient TCP hop
  under the DecisionClient, so wire faults (reset/drop/dup/delay) hit
  the real framing, reconnect, and retry code.
- **fleet**: an in-process `fleet.Fleet` (2 sharded replicas, shared
  LeaseStore + L2) over the in-memory cluster with a virtual store
  clock and manually-ticked leases — lease partitions, clock skew, and
  cache outages play out against real fencing and failover.

Determinism contract (what makes a chaos run a regression test):

1. the fault schedule is pure (regime, seed, n_waves) — replay
   regenerates it and byte-compares;
2. decisions are pure per POD SHAPE: the harness decider
   (`HashPlacementBackend`) picks by a stable hash of the pod's shape
   over the feasible-node set, so a cache hit, an L2 outage, or a
   different replica computing the decision cannot change a placement;
3. waves are drained to a barrier before the next wave releases, so
   every decision in a wave sees the same settled snapshot — fault
   windows and churn land on wave boundaries (virtual time), never on
   thread-timing boundaries;
4. partial faults pick victims by stable key hash (chaos/faults.py),
   never by RNG draw order — and in wire mode the decision cache is off
   so a per-POD fault can't leak through a shape-level cache entry.

The invariant monitor (chaos/invariants.py) watches the run from inside
(binder, cache, breaker seams) and renders the verdict; the trace
(`build_chaos_trace`/`verify_chaos_trace`) is the replayable artifact:
same seed -> same fault schedule -> byte-identical trace.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Any

from k8s_llm_scheduler_tpu_torch.chaos.faults import (
    REGIMES,
    ChaosBackend,
    FaultInjector,
    FaultPlan,
    stable_fraction,
)
from k8s_llm_scheduler_tpu_torch.chaos.invariants import InvariantMonitor
from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
from k8s_llm_scheduler_tpu_torch.types import DecisionSource, SchedulingDecision

SCHEDULER_NAME = "ai-llama-scheduler"
TRACE_VERSION = 1


class ChaosError(RuntimeError):
    pass


# ------------------------------------------------------------------ decider
class HashPlacementBackend:
    """Deterministic-by-shape decider: same pod shape + same feasible
    set -> same node, regardless of which replica/cache/tier answered.
    This is the property the determinism contract (module docstring,
    point 2) rests on — a load-aware decider would couple placements to
    bind ORDER, which thread scheduling owns."""

    def __init__(self) -> None:
        self.calls = 0

    @staticmethod
    def _shape_key(pod) -> str:
        return (
            f"{pod.cpu_request:.4f}:{pod.memory_request:.4f}:"
            f"{sorted(pod.node_selector.items())}:{pod.priority}"
        )

    def get_scheduling_decision(self, pod, nodes) -> SchedulingDecision:
        from k8s_llm_scheduler_tpu_torch.engine.backend import NoFeasibleNodeError

        self.calls += 1
        candidates = sorted(n.name for n in feasible_nodes(pod, nodes))
        if not candidates:
            raise NoFeasibleNodeError(
                f"no feasible node for {pod.namespace}/{pod.name}"
            )
        pick = candidates[
            int(stable_fraction(self._shape_key(pod)) * len(candidates))
            % len(candidates)
        ]
        return SchedulingDecision(
            selected_node=pick,
            confidence=0.9,
            reasoning="chaos[hash-placement]",
            source=DecisionSource.LLM,
        )

    def get_stats(self) -> dict:
        return {"calls": self.calls}


class _VirtualClock:
    """The fleet store's manually-advanced clock (virtual wave time)."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


async def _settle(predicate, timeout_s: float, what: str) -> bool:
    """Poll until `predicate`; False on timeout (chaos runs must FINISH
    and report lost work, not die mid-verdict like the arena may). A
    predicate that RAISES counts as not-settled: the harness's own
    observation probes ride the same faulted wire as the stack under
    test (an injected api_5xx answers the harness too)."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            if predicate():
                return True
        except Exception:
            pass  # graftlint: ok[swallowed-exception] — probe shares the chaos-faulted wire; retried until the window closes or timeout
        if time.monotonic() > deadline:
            return False
        await asyncio.sleep(0.01)


def _wave_brownout(injector: FaultInjector, clients: list) -> None:
    """Interpret the `slo` seam: a brownout window puts every decision
    client into SLO-brownout mode for the wave (the on_trip/on_clear
    wiring `cli run` installs, driven here by the plan's virtual time)."""
    seam = injector.seam("slo")
    active = bool(seam.active("brownout"))
    for client in clients:
        if active:
            if not client.brownout:
                client.enter_brownout("chaos")
                injector.note("slo", "brownout", None)
        else:
            client.exit_brownout("chaos")


def _open_burn_in(scheduler, swap_cache) -> Any:
    """Interpret the `swap` seam: perform the cache-visible half of an
    identical-policy hot swap (generation bump — cached decisions from
    the 'old policy' become unservable, exactly what HotSwapper does
    after a real weight swap) and open a REAL CanaryController burn-in
    over the live scheduler stats. The decider is unchanged (the
    determinism contract: a swap must not move placements), so a healthy
    burn-in is the only correct verdict — any rollback the harness
    observes is a regression in the burn-in's signal math (e.g. the
    brownout-overlap subtraction in rollout/canary._signals)."""
    from types import SimpleNamespace

    from k8s_llm_scheduler_tpu_torch.rollout.canary import CanaryController

    class _RegistryDouble:
        """Just enough registry for a promote + potential rollback."""

        def __init__(self) -> None:
            self._active = 1

        def active(self):
            return self._active

        def set_active(self, version) -> None:
            self._active = version

        def record_scores(self, version, scores) -> None:
            pass

        def versions(self):
            return [1, 2]

        def get(self, version):
            return SimpleNamespace(parent=None if version == 1 else 1)

    controller = CanaryController(
        _RegistryDouble(),
        SimpleNamespace(swap_to=lambda version: {"pause_s": 0.0}),
        stats_provider=scheduler.get_stats,
        gate_runner=lambda version: {
            "pass": True, "checks": {}, "candidate": {},
        },
        burn_in_decisions=24,
    )
    if swap_cache is not None:
        swap_cache.bump_generation()
    verdict = controller.consider(2)
    if verdict.get("action") != "promoted":  # pragma: no cover - defensive
        raise ChaosError(f"learn-swap promotion failed: {verdict}")
    return controller


_CLIENT_COUNTERS = (
    "total_requests", "fallback_decisions", "degraded_decisions",
    "brownout_decisions", "deadline_timeouts", "invalid_decisions",
    "failed_requests",
)


def _client_counts(clients: list) -> dict[str, int]:
    out = {k: 0 for k in _CLIENT_COUNTERS}
    for client in clients:
        for k in _CLIENT_COUNTERS:
            out[k] += int(client.stats.get(k, 0))
    return out


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


# -------------------------------------------------------- single/wire modes
async def _run_wire_stack(
    scenario, plan: FaultPlan, injector: FaultInjector,
    monitor: InvariantMonitor, *, mode: str, deadline_ms: float | None,
    wave_timeout_s: float,
) -> dict:
    from k8s_llm_scheduler_tpu_torch.cluster.httpapi import (
        clear_active_config,
        set_active_config,
    )
    from k8s_llm_scheduler_tpu_torch.cluster.kube import KubeCluster
    from k8s_llm_scheduler_tpu_torch.cluster.wire_fake import WireFakeK8s
    from k8s_llm_scheduler_tpu_torch.core.breaker import CircuitBreaker, CircuitState
    from k8s_llm_scheduler_tpu_torch.core.cache import DecisionCache
    from k8s_llm_scheduler_tpu_torch.sched.client import DecisionClient
    from k8s_llm_scheduler_tpu_torch.sched.loop import Scheduler
    from k8s_llm_scheduler_tpu_torch.sim.scenarios import (
        ClusterModel,
        add_pod_to_wire,
        apply_churn_to_wire,
        apply_topology,
    )

    wire = WireFakeK8s(auto_run=True)
    wire.fault_seam = injector.seam("watch")
    cluster = None
    task = None
    server = None
    rclient = None
    try:
        apply_topology(scenario, wire)
        set_active_config(wire.base_url)
        cluster = KubeCluster(watch_timeout_seconds=10)

        if mode == "wire":
            from k8s_llm_scheduler_tpu_torch.sched.replica import (
                ReplicaClient,
                ReplicaServer,
            )

            server = ReplicaServer(
                HashPlacementBackend(), host="127.0.0.1", port=0
            )
            rclient = ReplicaClient(
                "127.0.0.1", server.port,
                connect_timeout_s=5.0, request_timeout_s=5.0,
            )
            rclient.fault_seam = injector.seam("wire")
            inner_backend: Any = rclient
            # cache OFF: wire faults pick victims per POD, and a shape-
            # level cache entry would smear one pod's fate over its
            # whole shape group (determinism contract, point 4)
            cache = None
        else:
            inner_backend = HashPlacementBackend()
            cache = monitor.wrap_cache(DecisionCache(max_size=4096))

        backend = ChaosBackend(inner_backend, injector.seam("backend"))
        # cooldown LONGER than any wave: once the breaker opens it stays
        # open for the rest of that wave (every later decision falls
        # back deterministically) instead of decaying to HALF_OPEN at a
        # wall-clock instant mid-wave that picks the reopen boundary by
        # timing; the pre-wave drain gate absorbs the cooldown between
        # waves. HALF_OPEN admission is wave-wide so the first post-
        # fault wave probes as one settled unit, not a timing-chosen
        # winner.
        breaker = CircuitBreaker(
            failure_threshold=3,
            timeout_seconds=1.0,
            half_open_max_calls=1_000_000,
        )
        monitor.watch_breaker(breaker)
        client = DecisionClient(
            backend, cache=cache, breaker=breaker,
            max_retries=2, retry_delay=0.01,
            deadline_ms=deadline_ms,
        )
        scheduler = Scheduler(
            cluster, monitor.wrap_binder(cluster), client,
            scheduler_name=SCHEDULER_NAME,
            snapshot_ttl_s=1e9,          # waves invalidate explicitly
            # wire mode serializes decisions: a chaos reset kills the
            # SHARED connection and the reader's fail-everything sweep
            # would otherwise collaterally fail whichever other pods
            # happened to be in flight — thread timing choosing fallback
            # victims is exactly what the determinism contract forbids
            max_concurrency=1 if mode == "wire" else 64,
            prefix_prewarm_s=0.0,
            # chaos regimes EXPECT watch errors: the default 5s re-watch
            # backoff would dominate every fault window's wall clock
            error_backoff_s=0.2,
        )

        outcomes: dict[str, str] = {}
        orig_note = scheduler._note_bind

        def tagging_note(ok, pod, decision):
            if ok:
                outcomes[pod.name] = decision.selected_node
            orig_note(ok, pod, decision)

        scheduler._note_bind = tagging_note

        unplaced: set[str] = set()
        orig_schedule = scheduler.schedule_pod

        async def tracking_schedule(raw, pod=None):
            ok = await orig_schedule(raw, pod)
            if not ok:
                unplaced.add(raw.name)
            return ok

        scheduler.schedule_pod = tracking_schedule
        task = asyncio.create_task(scheduler.run())

        model = ClusterModel(scenario)
        waves_out: list[dict] = []
        lost: set[str] = set()

        backend_seam = injector.seam("backend")
        wire_seam = injector.seam("wire")
        swap_seam = injector.seam("swap")
        canary = None
        burn_in_result: str | None = None
        for wave_idx, wave in enumerate(scenario.waves):
            injector.begin_wave(wave_idx)
            _wave_brownout(injector, [client])
            if canary is None and swap_seam.should("hot_swap") is not None:
                # hot swap at the wave boundary: generation bump + an open
                # canary burn-in over the live stats (learn-swap regime)
                canary = _open_burn_in(scheduler, cache)
            tripping = (
                backend_seam.active("error")
                or wire_seam.active("reset")
                or wire_seam.active("drop")
            )
            if not tripping:
                # no FAILURE-kind fault this wave (dup/delay are benign):
                # drain any lingering OPEN first, so the jittered
                # cooldown's tail can't leak a wall-clock-chosen fallback
                # into a wave that should decide cleanly (determinism
                # contract)
                await _settle(
                    lambda: breaker.state is not CircuitState.OPEN,
                    5.0, f"breaker cooldown before wave {wave_idx}",
                )
            churn = scenario.churn_for_wave(wave_idx)
            if churn:
                apply_churn_to_wire(scenario, churn, wire)
                model.apply_churn(churn)
                expect = {
                    n.name: model.ready[n.name] for n in model.live_nodes()
                }
                ok = await _settle(
                    lambda: {
                        n.name: n.is_ready
                        for n in cluster.get_node_metrics()
                    } == expect,
                    wave_timeout_s, f"churn@wave{wave_idx}",
                )
                if not ok:
                    raise ChaosError(
                        f"churn never settled before wave {wave_idx}"
                    )
            if not wave:
                waves_out.append({"wave": wave_idx, "n_pods": 0})
                continue

            scheduler.invalidate_snapshot()
            before = _client_counts([client])
            inj_before = dict(injector.injection_counts())
            t0 = time.perf_counter()
            for pod in wave:
                add_pod_to_wire(pod, wire)
            released = {p.name for p in wave}

            drained = await _settle(
                lambda: all(
                    n in outcomes or n in unplaced for n in released
                ),
                wave_timeout_s, f"wave{wave_idx}",
            )
            wall_ms = (time.perf_counter() - t0) * 1000.0
            if not drained:
                # a pod neither bound nor resolved within the budget:
                # finalize() will judge it lost unless a later re-list
                # recovers it
                lost |= {
                    n for n in released
                    if n not in outcomes and n not in unplaced
                }
            for pod in wave:
                if pod.name in outcomes:
                    model.place(pod, outcomes[pod.name])

            # informer barrier: every bind on a still-present node must
            # be visible before the next wave's snapshot
            total_bound = sum(
                1 for name, node in outcomes.items()
                if model.present.get(node)
            )
            await _settle(
                lambda: sum(
                    n.pod_count for n in cluster.get_node_metrics()
                ) >= total_bound,
                wave_timeout_s, f"wave{wave_idx} informer",
            )
            waves_out.append({
                "wave": wave_idx,
                "n_pods": len(wave),
                "n_bound": sum(1 for n in released if n in outcomes),
                "wall_ms": round(wall_ms, 3),
                "client": _delta(_client_counts([client]), before),
                "injections": _delta(
                    dict(injector.injection_counts()), inj_before
                ),
            })
            if canary is not None and burn_in_result is None:
                # progress the open burn-in at the wave barrier: the
                # decision-count window fills from settled waves only, so
                # the verdict is wave-quantized like everything else here
                burn_in_result = canary.observe_burn_in()
        injector.end_run()

        # late recovery scan: the watch re-list may resolve stragglers
        # after their wave's barrier expired
        if lost:
            await _settle(
                lambda: all(
                    n in outcomes or n in unplaced for n in lost
                ),
                5.0, "late stragglers",
            )
        all_pods = [p for wave in scenario.waves for p in wave]
        monitor.finalize(
            expected=[("default", p.name) for p in all_pods],
            pending=[
                ("default", n) for n in unplaced if n not in outcomes
            ],
        )
        out = {
            "placements": dict(sorted(outcomes.items())),
            "unschedulable": sorted(
                n for n in unplaced if n not in outcomes
            ),
            "waves": waves_out,
            "client": client.get_stats(),
        }
        if canary is not None:
            out["canary"] = {
                "result": burn_in_result,
                "promotions": canary.counters["promotions"],
                "rollbacks": canary.counters["rollbacks"],
            }
        return out
    finally:
        injector.end_run()
        if task is not None:
            scheduler.stop()
            cluster.close()
            try:
                await asyncio.wait_for(task, timeout=30)
            except asyncio.TimeoutError:
                task.cancel()
        elif cluster is not None:
            cluster.close()
        if rclient is not None:
            rclient.close()
        if server is not None:
            server.close()
        wire.close()
        # the active config is process-global and now points at a DEAD
        # server — a later `cli run` (or test) would hang dialing it
        clear_active_config()


# -------------------------------------------------------------- fleet mode
async def _run_fleet_stack(
    scenario, plan: FaultPlan, injector: FaultInjector,
    monitor: InvariantMonitor, *, deadline_ms: float | None,
    wave_timeout_s: float, tick_s: float = 2.0, lease_ttl_s: float = 5.0,
) -> dict:
    from k8s_llm_scheduler_tpu_torch.cluster.fake import FakeCluster, FakeNode
    from k8s_llm_scheduler_tpu_torch.fleet import Fleet

    cluster = FakeCluster()
    for n in scenario.nodes:
        cluster.add_node(FakeNode(
            name=n.name,
            cpu_capacity_cores=n.cpu_cores,
            memory_capacity_gb=n.memory_gb,
            max_pods=n.max_pods,
            labels=dict(n.labels),
            taints=n.taints,
            ready=n.ready,
        ))
    clock = _VirtualClock()
    fleet = Fleet(
        cluster, cluster, lambda i: HashPlacementBackend(),
        n_replicas=2, n_shards=8,
        lease_ttl_s=lease_ttl_s, clock=clock,
        list_pending=lambda: cluster.pending_pods(SCHEDULER_NAME),
    )
    store = fleet.store
    store.fault_seam = injector.seam("lease")

    # Shared prefix-KV plane, riding the same virtual clock: every wave
    # each replica pins that wave's snapshot prefix through the plane
    # (model-free StubPinEngine — KV is a pure function of the token
    # ids, so byte-identical adopted vs local KV IS the zero-
    # correctness-loss check). The kv-plane-outage regime injects on
    # the store's seam; every other fleet regime exercises the healthy
    # fill-once/adopt-everywhere path alongside its own faults.
    from k8s_llm_scheduler_tpu_torch.fleet.kvplane import (
        KVPlaneClient, KVPlaneStore, StubPinEngine,
    )

    kvstore = KVPlaneStore(fill_ttl_s=lease_ttl_s, clock=clock)
    kvstore.fault_seam = injector.seam("kvplane")
    kv_clients = [
        KVPlaneClient(kvstore, StubPinEngine(), replica=replica.holder)
        for replica in fleet.replicas
    ]
    kv_mismatches = 0

    def _kv_counts() -> dict:
        out: dict[str, int] = dict(kvstore.counters)
        for kc in kv_clients:
            for k, v in kc.counters.items():
                out[f"client_{k}"] = out.get(f"client_{k}", 0) + v
        return out

    clients = []
    deferred: set[str] = set()
    for replica in fleet.replicas:
        replica.cache.fault_seam = injector.seam("cache")
        replica.client.cache = monitor.wrap_cache(replica.cache)
        replica.client.deadline_ms = deadline_ms
        monitor.watch_breaker(replica.client.breaker, name=replica.holder)
        replica.scheduler.binder = monitor.wrap_binder(
            replica.scheduler.binder,
            holder=replica.holder, store=store, n_shards=store.n_shards,
        )
        clients.append(replica.client)

        orig_schedule = replica.scheduler.schedule_pod

        async def tracking_schedule(raw, pod=None, _orig=orig_schedule):
            ok = await _orig(raw, pod)
            if not ok:
                deferred.add(raw.name)
            return ok

        replica.scheduler.schedule_pod = tracking_schedule

    def bound_names() -> set[str]:
        return {name for (_ns, name), _node in monitor.bound_pods().items()}

    def resolved_names() -> set[str]:
        # a pod is wave-resolved once ANY path disposed of it: a bind
        # attempt (ok or fenced — the fast path never enters
        # schedule_pod) or a schedule_pod that returned False
        return (
            {name for _ns, name in monitor.attempted_pods()} | deferred
        )

    await fleet.start(lease_threads=False)
    waves_out: list[dict] = []
    try:
        for wave_idx, wave in enumerate(scenario.waves):
            injector.begin_wave(wave_idx)
            _wave_brownout(injector, clients)
            clock.advance(tick_s)
            fleet.tick_leases()
            if not wave:
                waves_out.append({"wave": wave_idx, "n_pods": 0})
                continue
            before = _client_counts(clients)
            inj_before = dict(injector.injection_counts())
            kv_before = _kv_counts()
            # wave-fresh snapshot prefix → one fill election per wave;
            # identical resident KV across both replicas afterwards, or
            # the correctness probe counts a mismatch (must stay 0)
            pin_ids = [9000 + wave_idx * 31 + j for j in range(16)]
            for kc in kv_clients:
                kc.pin(pin_ids)
            if len({kc.engine.kv_digest(pin_ids) for kc in kv_clients}) != 1:
                kv_mismatches += 1
            t0 = time.perf_counter()  # graftlint: ok[wall-clock-in-replay] — wave/recovery timing rides the report only; build_chaos_trace strips wall_ms before canonicalizing
            for pod in wave:
                cluster.add_pod(pod.to_raw_pod())
            released = {p.name for p in wave}
            # a timed-out barrier is not a verdict: the recovery ticks
            # below get another chance and finalize() judges lost pods
            await _settle(
                lambda: released <= resolved_names(),
                wave_timeout_s, f"wave{wave_idx}",
            )
            waves_out.append({
                "wave": wave_idx,
                "n_pods": len(wave),
                "n_bound": len(released & bound_names()),
                "wall_ms": round((time.perf_counter() - t0) * 1000.0, 3),  # graftlint: ok[wall-clock-in-replay] — wave/recovery timing rides the report only; build_chaos_trace strips wall_ms before canonicalizing
                "client": _delta(_client_counts(clients), before),
                "kvplane": _delta(_kv_counts(), kv_before),
                "injections": _delta(
                    dict(injector.injection_counts()), inj_before
                ),
            })
        injector.end_run()

        # recovery ticks: leases re-converge and deferred pods rebind
        # (the post-fault waves may end before fair-share settles —
        # e.g. the survivor only claims a partitioned peer's shards
        # after that peer's HEARTBEAT TTL runs out in virtual time).
        # Each tick also re-offers still-pending pods to their shard's
        # owner — the periodic watch RE-LIST a live kube watch performs
        # (FakeCluster's watch never re-delivers, so without this a pod
        # fenced during a TRANSIENT partition that did not cost the
        # lease would stay pending forever: no lease changed hands, so
        # no on_gain rebind pass ever re-offers it)
        from k8s_llm_scheduler_tpu_torch.fleet.lease import shard_of

        all_names = {p.name for wave in scenario.waves for p in wave}
        for _ in range(24):
            if not (all_names - bound_names()):
                break
            clock.advance(tick_s)
            fleet.tick_leases()
            pending = cluster.pending_pods(SCHEDULER_NAME)
            for replica in fleet.replicas:
                todo = [
                    p for p in pending
                    if replica.manager.owns(
                        shard_of(p.namespace, p.name, fleet.n_shards)
                    )
                ]
                if todo:
                    await asyncio.gather(
                        *(replica.scheduler.schedule_pod(p) for p in todo),
                        return_exceptions=True,
                    )
            await _settle(
                lambda: not (all_names - bound_names()), 0.5, "recovery",
            )

        all_pods = [p for wave in scenario.waves for p in wave]
        still_pending = {
            (p.namespace, p.name)
            for p in cluster.pending_pods(SCHEDULER_NAME)
        }
        monitor.finalize(
            expected=[("default", p.name) for p in all_pods],
            pending=still_pending,
        )
        placements = {
            name: node
            for (_ns, name), node in monitor.bound_pods().items()
        }
        return {
            "placements": dict(sorted(placements.items())),
            "unschedulable": sorted(
                n for n in all_names if n not in placements
            ),
            "waves": waves_out,
            "client": {
                "totals": _client_counts(clients),
                "fleet": {
                    k: v for k, v in fleet.get_stats().items()
                    if k != "replicas"
                },
            },
            "kvplane": {
                "store": kvstore.gauges(),
                "clients": {
                    kc.replica: kc.stats() for kc in kv_clients
                },
                "kv_mismatches": kv_mismatches,
            },
        }
    finally:
        injector.end_run()
        await fleet.stop()
        cluster.close()


# ---------------------------------------------------------- autoscale mode
async def _run_autoscale_stack(
    scenario, plan: FaultPlan, injector: FaultInjector,
    monitor: InvariantMonitor, *, deadline_ms: float | None,
    wave_timeout_s: float, tick_s: float = 2.0, lease_ttl_s: float = 5.0,
) -> dict:
    """An ELASTIC fleet (fleet/autoscale.AutoscaleController over
    Fleet.start_join/remove_replica) driven in virtual wave time.

    Determinism: the controller's ONLY inputs are the incoming wave's
    pod count (queue-depth signal, known before the wave releases) and
    a WAVE-QUANTIZED control clock (wave index x tick_s) — the store
    clock may be advanced extra inside a stalled wave barrier to let a
    TTL failover converge (the periodic re-list a live watch performs),
    but the controller never sees those advances, so the scale-event
    sequence is a pure function of (scenario, plan). Placements stay
    deterministic-by-shape exactly as in fleet mode."""
    from k8s_llm_scheduler_tpu_torch.cluster.fake import FakeCluster, FakeNode
    from k8s_llm_scheduler_tpu_torch.fleet import Fleet
    from k8s_llm_scheduler_tpu_torch.fleet.autoscale import (
        AutoscaleConfig,
        AutoscaleController,
    )
    from k8s_llm_scheduler_tpu_torch.fleet.lease import shard_of

    cluster = FakeCluster()
    for n in scenario.nodes:
        cluster.add_node(FakeNode(
            name=n.name,
            cpu_capacity_cores=n.cpu_cores,
            memory_capacity_gb=n.memory_gb,
            max_pods=n.max_pods,
            labels=dict(n.labels),
            taints=n.taints,
            ready=n.ready,
        ))
    clock = _VirtualClock()
    fleet = Fleet(
        cluster, cluster, lambda i: HashPlacementBackend(),
        n_replicas=1, n_shards=8,
        lease_ttl_s=lease_ttl_s, clock=clock,
        list_pending=lambda: cluster.pending_pods(SCHEDULER_NAME),
    )
    store = fleet.store
    store.fault_seam = injector.seam("lease")
    fleet.fault_seam = injector.seam("scale")
    scale_seam = injector.seam("scale")

    clients: list = []
    deferred: set[str] = set()
    crashed: list = []

    def wire_replica(replica) -> None:
        """Monitor-wrap a replica before it can bind anything — initial
        members here, joiners via Fleet.on_replica_start (which fires
        before the joiner's scheduler starts)."""
        replica.cache.fault_seam = injector.seam("cache")
        replica.client.cache = monitor.wrap_cache(replica.cache)
        replica.client.deadline_ms = deadline_ms
        monitor.watch_breaker(replica.client.breaker, name=replica.holder)
        replica.scheduler.binder = monitor.wrap_binder(
            replica.scheduler.binder,
            holder=replica.holder, store=store, n_shards=store.n_shards,
        )
        clients.append(replica.client)

        orig_schedule = replica.scheduler.schedule_pod

        async def tracking_schedule(raw, pod=None, _orig=orig_schedule):
            ok = await _orig(raw, pod)
            if not ok:
                deferred.add(raw.name)
            return ok

        replica.scheduler.schedule_pod = tracking_schedule

    fleet.on_replica_start = wire_replica
    for replica in fleet.replicas:
        wire_replica(replica)

    wave_state = {"i": 0, "incoming": 0}
    acfg = AutoscaleConfig(
        min_replicas=1, max_replicas=4,
        # 6 decisions/replica/wave: the diurnal ramp's second wave
        # already crosses the up threshold, so scale-up attempts land
        # INSIDE the join-fail windows (and the thrash flap's heavy
        # waves sit well above the band while light waves sit below it)
        target_per_replica=6.0, target_utilization=0.75,
        up_threshold=1.0, down_threshold=0.5,
        max_step=1,
        up_cooldown_s=tick_s,            # at most one up per wave
        down_cooldown_s=3 * tick_s,      # downs at most every 3 waves
        join_budget_ticks=3, join_backoff_ticks=1, max_join_retries=3,
        split_enabled=False,
    )
    controller = AutoscaleController(
        fleet, acfg,
        queue_depth_fn=lambda: wave_state["incoming"],
        # wave-quantized control clock (see docstring): never advanced
        # by the intra-wave failover catch-up the store clock needs
        clock=lambda: wave_state["i"] * tick_s,
        on_scale=monitor.note_scale,
    )

    def bound_names() -> set[str]:
        return {name for (_ns, name), _node in monitor.bound_pods().items()}

    def resolved_names() -> set[str]:
        return (
            {name for _ns, name in monitor.attempted_pods()} | deferred
        )

    def reoffer_pending() -> list:
        """The periodic watch re-list: offer still-pending pods to the
        shard owner's scheduler (the in-flight dedup suppresses
        doubles; a stale local owner's bind is fenced at the store)."""
        pending = cluster.pending_pods(SCHEDULER_NAME)
        coros = []
        for replica in fleet.replicas:
            todo = [
                p for p in pending
                if replica.manager.owns(
                    shard_of(p.namespace, p.name, fleet.n_shards)
                )
            ]
            coros.extend(replica.scheduler.schedule_pod(p) for p in todo)
        return coros

    async def drain_wave(released: set[str], label: str) -> bool:
        """Wave barrier. A stalled barrier (shards mid-failover after a
        drain-race crash) advances the STORE clock and re-offers — the
        lease protocol converging in accelerated virtual time — without
        touching the control clock."""
        deadline = time.monotonic() + wave_timeout_s  # graftlint: ok[wall-clock-in-replay] — wave/recovery timing rides the report only; build_chaos_trace strips wall_ms before canonicalizing
        stalls = 0
        while time.monotonic() < deadline:  # graftlint: ok[wall-clock-in-replay] — wave/recovery timing rides the report only; build_chaos_trace strips wall_ms before canonicalizing
            if released <= resolved_names():
                return True
            await asyncio.sleep(0.02)
            stalls += 1
            if stalls % 25 == 0:
                clock.advance(tick_s)
                fleet.tick_leases()
                coros = reoffer_pending()
                if coros:
                    await asyncio.gather(*coros, return_exceptions=True)
        return released <= resolved_names()

    await fleet.start(lease_threads=False)
    waves_out: list[dict] = []
    try:
        for wave_idx, wave in enumerate(scenario.waves):
            injector.begin_wave(wave_idx)
            _wave_brownout(injector, clients)
            clock.advance(tick_s)
            fleet.tick_leases()
            wave_state["i"] = wave_idx + 1
            wave_state["incoming"] = len(wave)
            if scale_seam.active("thrash"):
                # marker only (the workload IS the fault) — note it so
                # the injection report shows the thrash span
                injector.note("scale", "thrash", None)
            before = _client_counts(clients)
            inj_before = dict(injector.injection_counts())
            tick_record = await controller.tick()
            if scale_seam.should("drain_race") is not None:
                # the race: a controller-path drain (real
                # remove_replica: drain -> release -> teardown) while
                # the OLDEST replica crashes with its leases lingering
                # to TTL — two membership changes through the lease
                # plane at once
                if fleet.n_live > 1:
                    victim = fleet.pick_removal()
                    await fleet.remove_replica(victim)
                survivors = [
                    r for r in fleet.replicas if r not in crashed
                ]
                if len(survivors) > 1:
                    corpse = min(survivors, key=lambda r: r.replica_id)
                    await corpse.stop(release_leases=False)
                    crashed.append(corpse)
            t0 = time.perf_counter()  # graftlint: ok[wall-clock-in-replay] — wave/recovery timing rides the report only; build_chaos_trace strips wall_ms before canonicalizing
            if not wave:
                waves_out.append({
                    "wave": wave_idx, "n_pods": 0,
                    "replicas": fleet.n_live,
                    "scale_action": tick_record["action"],
                })
                continue
            for pod in wave:
                cluster.add_pod(pod.to_raw_pod())
            released = {p.name for p in wave}
            # a timed-out barrier is not a verdict: finalize() judges
            # lost pods after the recovery ticks below
            await drain_wave(released, f"wave{wave_idx}")
            waves_out.append({
                "wave": wave_idx,
                "n_pods": len(wave),
                "n_bound": len(released & bound_names()),
                "replicas": fleet.n_live,
                "scale_action": tick_record["action"],
                "wall_ms": round((time.perf_counter() - t0) * 1000.0, 3),  # graftlint: ok[wall-clock-in-replay] — wave/recovery timing rides the report only; build_chaos_trace strips wall_ms before canonicalizing
                "client": _delta(_client_counts(clients), before),
                "injections": _delta(
                    dict(injector.injection_counts()), inj_before
                ),
            })
        injector.end_run()

        # recovery: lease failover of crashed replicas converges and
        # every still-pending pod re-offers to its live owner (the
        # controller does NOT tick here — scale events stay a pure
        # function of the scenario's waves)
        all_names = {p.name for wave in scenario.waves for p in wave}
        for _ in range(24):
            if not (all_names - bound_names() - deferred):
                break
            clock.advance(tick_s)
            fleet.tick_leases()
            coros = reoffer_pending()
            if coros:
                await asyncio.gather(*coros, return_exceptions=True)
            await _settle(
                lambda: not (all_names - bound_names() - deferred),
                0.5, "recovery",
            )

        all_pods = [p for wave in scenario.waves for p in wave]
        still_pending = {
            (p.namespace, p.name)
            for p in cluster.pending_pods(SCHEDULER_NAME)
        }
        monitor.finalize(
            expected=[("default", p.name) for p in all_pods],
            pending=still_pending,
        )
        placements = {
            name: node
            for (_ns, name), node in monitor.bound_pods().items()
        }
        return {
            "placements": dict(sorted(placements.items())),
            "unschedulable": sorted(
                n for n in all_names if n not in placements
            ),
            "waves": waves_out,
            "client": {
                "totals": _client_counts(clients),
                "fleet": {
                    k: v for k, v in fleet.get_stats().items()
                    if k != "replicas"
                },
            },
            "scale_events": controller.scale_events(),
            "autoscale": controller.stats(),
        }
    finally:
        injector.end_run()
        await fleet.stop()
        cluster.close()


# -------------------------------------------------------------- crash mode
class _FirstBindTap:
    """Thin binder wrapper stamping the perf time of the first
    SUCCESSFUL bind a rebuilt replica lands — the 'first post-restart
    bind' edge of the MTTR the recovery bench publishes."""

    def __init__(self, inner: Any) -> None:
        self._inner = inner
        self.first_ok: float | None = None
        self.bind_is_nonblocking = getattr(inner, "bind_is_nonblocking", False)

    def bind_pod_to_node(self, pod_name, namespace, node_name) -> bool:
        ok = self._inner.bind_pod_to_node(pod_name, namespace, node_name)
        if ok and self.first_ok is None:
            self.first_ok = time.perf_counter()
        return ok

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)


def _tear_journal_tail(journal_root, n_bytes: int) -> None:
    """Harness interpretation of the `torn_tail` fault: physically cut
    N bytes off the end of the newest journal segment — the bytes a
    crash tore out of the record being written at the instant of
    death. The rebuilt journal's replay must truncate (never mis-parse)
    the tear."""
    from pathlib import Path

    segments = sorted(Path(journal_root).glob("seg-*.log"))
    if not segments:
        return
    seg = segments[-1]
    size = seg.stat().st_size
    with open(seg, "ab") as fh:
        fh.truncate(max(0, size - max(1, n_bytes)))


async def _run_crash_stack(
    scenario, plan: FaultPlan, injector: FaultInjector,
    monitor: InvariantMonitor, *, deadline_ms: float | None,
    wave_timeout_s: float, tick_s: float = 2.0, lease_ttl_s: float = 5.0,
) -> dict:
    """One JOURNAL-BACKED replica over the in-memory cluster, dropped
    cold at seeded lifecycle points and rebuilt from disk.

    The durable pieces are real: a FileLeaseStore (leases linger to TTL
    across the death, exactly like a crashed pod's k8s Lease), an
    fsync'd DecisionJournal, and the full recovery protocol
    (FleetReplica.recover -> sched/recovery.recover). The invariant
    monitor — and its exactly-once bind book — live OUTSIDE the replica
    and span every process lifetime, so a double bind across a restart
    is judged exactly like one inside a single lifetime, against the
    store.

    Determinism: pods are driven through the scheduler SEQUENTIALLY in
    sorted order (the crash must always land on the same pod at the
    same lifecycle point), placements are by-shape (HashPlacement), the
    store clock is virtual, and `times=1` budgets mean exactly one
    death per crash window. Restart timing (ms) stays in the report;
    the (wave, point, reconciled-counts) sequence rides the trace."""
    import shutil
    import tempfile
    from pathlib import Path

    from k8s_llm_scheduler_tpu_torch.cluster.fake import FakeCluster, FakeNode
    from k8s_llm_scheduler_tpu_torch.core.cache import DecisionCache
    from k8s_llm_scheduler_tpu_torch.fleet.frontend import FleetReplica
    from k8s_llm_scheduler_tpu_torch.fleet.lease import FileLeaseStore
    from k8s_llm_scheduler_tpu_torch.sched.journal import DecisionJournal
    from k8s_llm_scheduler_tpu_torch.sched.recovery import SimulatedCrash

    workdir = Path(tempfile.mkdtemp(prefix="chaos-crash-"))
    journal_root = workdir / "journal"
    cluster = FakeCluster()
    for n in scenario.nodes:
        cluster.add_node(FakeNode(
            name=n.name,
            cpu_capacity_cores=n.cpu_cores,
            memory_capacity_gb=n.memory_gb,
            max_pods=n.max_pods,
            labels=dict(n.labels),
            taints=n.taints,
            ready=n.ready,
        ))
    clock = _VirtualClock()
    store = FileLeaseStore(
        workdir / "leases.json", n_shards=4, ttl_s=lease_ttl_s, clock=clock,
    )
    store.fault_seam = injector.seam("lease")
    process_seam = injector.seam("process")
    clients: list = []
    deferred: set[str] = set()

    def pod_lookup(ns: str, name: str):
        raw = cluster.get_pod(ns, name)
        if raw is None:
            return ("gone", None)
        if raw.node_name:
            return ("bound", raw.node_name)
        return ("pending", None)

    def build_replica() -> FleetReplica:
        journal = DecisionJournal(journal_root, fsync_policy="always")
        # monitor INSIDE the journal wrapper (fence(journal(monitor(
        # cluster)))): a post_bind crash fires AFTER the inner bind
        # returns — with the monitor outside, the exception would skip
        # its bookkeeping and a genuinely-landed bind would read as a
        # lost pod. Inside, the observation completes WITH the bind,
        # which is also what the cluster (the real authority) sees.
        tap = _FirstBindTap(cluster)
        monitored = monitor.wrap_binder(
            tap, holder="replica-0", store=store, n_shards=store.n_shards,
        )
        replica = FleetReplica(
            0,
            cluster=cluster, binder=monitored,
            backend=HashPlacementBackend(),
            store=store, l2=DecisionCache(max_size=4096),
            scheduler_name=SCHEDULER_NAME,
            snapshot_ttl_s=1e9,  # waves invalidate explicitly
            journal=journal,
            list_pending=lambda: cluster.pending_pods(SCHEDULER_NAME),
        )
        replica._journaled_binder.crash_seam = process_seam
        replica.cache.fault_seam = injector.seam("cache")
        replica.client.cache = monitor.wrap_cache(replica.cache)
        replica.client.deadline_ms = deadline_ms
        monitor.watch_breaker(replica.client.breaker, name=replica.holder)
        replica.bind_tap = tap
        clients.append(replica.client)
        return replica

    def bound_names() -> set[str]:
        return {name for (_ns, name), _node in monitor.bound_pods().items()}

    replica = build_replica()
    replica.manager.tick()  # single holder claims every shard
    restarts: list[dict] = []
    open_restart: dict | None = None

    def settle_restart(current_wave: int) -> None:
        """Fill the open restart's MTTR once its rebuilt replica landed
        a bind (kill -> rebuild -> recover -> first bind, inclusive)."""
        nonlocal open_restart
        if open_restart is None:
            return
        tap = open_restart["tap"]
        if tap.first_ok is None:
            return
        rec = open_restart["record"]
        rec["mttr_ms"] = round(
            (tap.first_ok - open_restart["t_kill"]) * 1000.0, 3
        )
        rec["mttr_waves"] = current_wave - rec["wave"]
        open_restart = None

    waves_out: list[dict] = []
    try:
        for wave_idx, wave in enumerate(scenario.waves):
            injector.begin_wave(wave_idx)
            _wave_brownout(injector, clients)
            clock.advance(tick_s)
            replica.manager.tick()
            if not wave:
                waves_out.append({"wave": wave_idx, "n_pods": 0})
                continue
            replica.scheduler.invalidate_snapshot()
            before = _client_counts(clients)
            inj_before = dict(injector.injection_counts())
            t0 = time.perf_counter()
            for pod in wave:
                cluster.add_pod(pod.to_raw_pod())
            released = {p.name for p in wave}

            # sequential deterministic drive, crash-aware: a pass over
            # the pending set; a SimulatedCrash aborts the pass, the
            # replica is rebuilt from disk, recovery reconciles, and a
            # fresh pass covers whatever is still pending
            while True:
                pending = sorted(
                    cluster.pending_pods(SCHEDULER_NAME),
                    key=lambda p: (p.namespace, p.name),
                )
                crashed = False
                for raw in pending:
                    try:
                        ok = await replica.scheduler.schedule_pod(raw)
                    except SimulatedCrash as crash:
                        # ---------------- cold process death ----------
                        t_kill = time.perf_counter()
                        replica.journal.abandon()
                        # leases are NOT released; the store keeps them
                        # until TTL — exactly a crashed pod's k8s Lease
                        torn = process_seam.should("torn_tail")
                        if torn is not None:
                            _tear_journal_tail(
                                journal_root,
                                int(torn.param("bytes", 4)),
                            )
                        # ---------------- rebuild from disk -----------
                        replica = build_replica()
                        try:
                            rec = await replica.recover(pod_lookup)
                        except SimulatedCrash:
                            # crash DURING recovery: die again, rebuild
                            # again — the journal now holds recovery's
                            # partial writes and must still reconcile
                            replica.journal.abandon()
                            replica = build_replica()
                            rec = await replica.recover(pod_lookup)
                        record = {
                            "wave": wave_idx,
                            "point": crash.point,
                            "reconciled": {
                                k: rec[k] for k in
                                ("acked", "rebound", "dropped", "failed")
                            },
                        }
                        restarts.append(record)
                        open_restart = {
                            "record": record, "t_kill": t_kill,
                            "tap": replica.bind_tap,
                        }
                        replica.scheduler.invalidate_snapshot()
                        crashed = True
                        break
                    else:
                        if not ok:
                            deferred.add(raw.name)
                        settle_restart(wave_idx)
                if not crashed:
                    break
            settle_restart(wave_idx)
            waves_out.append({
                "wave": wave_idx,
                "n_pods": len(wave),
                "n_bound": len(released & bound_names()),
                "restarts": sum(
                    1 for r in restarts if r["wave"] == wave_idx
                ),
                "wall_ms": round((time.perf_counter() - t0) * 1000.0, 3),
                "client": _delta(_client_counts(clients), before),
                "injections": _delta(
                    dict(injector.injection_counts()), inj_before
                ),
            })
        injector.end_run()

        # recovery sweep: re-offer anything still pending (a deferred
        # pod whose bind was refused mid-crash retries against the
        # settled cluster)
        all_names = {p.name for wave in scenario.waves for p in wave}
        for _ in range(8):
            if not (all_names - bound_names() - deferred):
                break
            clock.advance(tick_s)
            replica.manager.tick()
            for raw in sorted(
                cluster.pending_pods(SCHEDULER_NAME),
                key=lambda p: (p.namespace, p.name),
            ):
                try:
                    await replica.scheduler.schedule_pod(raw)
                except SimulatedCrash:
                    break  # budgets are spent by now; defensive only
            settle_restart(len(scenario.waves) - 1)

        all_pods = [p for wave in scenario.waves for p in wave]
        still_pending = {
            (p.namespace, p.name)
            for p in cluster.pending_pods(SCHEDULER_NAME)
        }
        monitor.finalize(
            expected=[("default", p.name) for p in all_pods],
            pending=still_pending,
        )
        monitor.finalize_journal(replica.journal.state, pod_lookup)
        placements = {
            name: node
            for (_ns, name), node in monitor.bound_pods().items()
        }
        return {
            "placements": dict(sorted(placements.items())),
            "unschedulable": sorted(
                n for n in all_names if n not in placements
            ),
            "waves": waves_out,
            "client": {
                "totals": _client_counts(clients),
                "lease": store.gauges(),
            },
            "restarts": restarts,
            "journal": replica.journal.stats(),
        }
    finally:
        injector.end_run()
        try:
            replica.journal.close()
        except Exception:
            pass  # graftlint: ok[swallowed-exception] — teardown of a possibly-abandoned journal; state already on disk
        cluster.close()
        shutil.rmtree(workdir, ignore_errors=True)


# --------------------------------------------------------- persistent mode
_STUB_CHUNK = 4          # micro-chunk steps per harvest batch
_STUB_SLOTS = 32         # resident slots (>= any wave plus parked work)
_CMD_CAPACITY = 4        # small on purpose: ring_full must actually bite
_TOK_CAPACITY = 8        # bounded: a stalled consumer must backpressure
_WEDGE_TIMEOUT_S = 0.08  # heartbeat staleness the watchdog trips on


def _stub_token(seed: int, pos: int) -> int:
    """Pure-arithmetic token stream (cross-process stable, no RNG): the
    whole emission stream of one serving request is a function of its
    seed, so the harness can verify byte-exact delivery without sharing
    any state with the loop thread."""
    return int((seed * 1000003 + pos * 7919 + 12345) % 49999)


def _stub_stream(seed: int) -> list[int]:
    """The request's full expected stream; length 6..17 so every request
    spans several micro-chunks (its budget exceeds one chunk)."""
    return [_stub_token(seed, i) for i in range(6 + seed % 12)]


class _ServeReq:
    """One serving request in flight through the persistent plane."""

    __slots__ = (
        "pod", "seed", "expected", "delivered", "candidates", "slot",
        "via_fallback",
    )

    def __init__(self, pod, seed: int, expected: list[int],
                 candidates: list[str]) -> None:
        self.pod = pod
        self.seed = seed
        self.expected = expected
        self.delivered: list[int] = []
        self.candidates = candidates
        self.slot = -1
        self.via_fallback = False


class _StubResidentLoop:
    """Deterministic no-JAX stand-in for the resident serving loop
    (engine/persistent/loop.py) driving the REAL CommandRing /
    TokenRing / Heartbeat from engine/persistent/ring.py. One thread
    iteration = one micro-chunk, exactly like the device program: beat,
    poll ONE command, serve up to _STUB_CHUNK tokens per active slot,
    push one HarvestBatch — blocking when the token ring is full, the
    same emission backpressure that stalls the real loop. Chaos flags
    are wave-quantized by the harness while the loop is IDLE (the wave
    barrier drained everything), so no take/flag race can change what
    the loop observed: `pause_polls` stops command uptake (ring_full),
    `wedged` stops the thread beating entirely (loop_wedge — the
    Heartbeat watchdog must notice on its own)."""

    def __init__(self) -> None:
        from k8s_llm_scheduler_tpu_torch.engine.persistent.ring import (
            CommandRing,
            Heartbeat,
            TokenRing,
        )
        from k8s_llm_scheduler_tpu_torch.observability.resident import BlackBox

        self.commands = CommandRing(capacity=_CMD_CAPACITY)
        self.tokens = TokenRing(capacity=_TOK_CAPACITY)
        self.heartbeat = Heartbeat()
        # Wedge black-box, chaos flavour: the real loop's box records
        # full iteration snapshots (observability/resident.py), but
        # iteration cadence here is thread timing — so this box records
        # only PROTOCOL events (command uptake, FIFO order fixed by the
        # plan), keeping the dump byte-identical across replay. Depth 16
        # < the regime's ~36 admits, so boundedness is exercised, not
        # just declared.
        self.blackbox = BlackBox(depth=16)
        self.pause_polls = False
        self.wedged = False
        self._stop = False
        import numpy as np

        self._seed = np.zeros(_STUB_SLOTS, dtype=np.int64)
        self._pos = np.zeros(_STUB_SLOTS, dtype=np.int32)
        self._budget = np.zeros(_STUB_SLOTS, dtype=np.int32)
        self._act = np.zeros(_STUB_SLOTS, dtype=bool)
        self._thread = threading.Thread(
            target=self._run, name="chaos-persistent-loop", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        import numpy as np

        from k8s_llm_scheduler_tpu_torch.engine.persistent.ring import (
            OP_ABORT,
            OP_ADMIT,
            OP_QUIESCE,
            HarvestBatch,
        )

        while not self._stop:
            if self.wedged:
                time.sleep(0.002)  # graftlint: ok[raw-clock] — a wedged loop must idle REAL wall time so the real Heartbeat watchdog trips on its own
                continue
            self.heartbeat.beat()
            cmd = None
            if not self.pause_polls:
                cmd = self.commands.take()
            if cmd is not None:
                if cmd.op == OP_QUIESCE:
                    self.blackbox.record({"event": "quiesce"})
                    return
                if cmd.op == OP_ABORT:
                    self.blackbox.record(
                        {"event": "abort", "slot": int(cmd.slot)}
                    )
                    if cmd.slot < 0:
                        self._act[:] = False
                    else:
                        self._act[cmd.slot] = False
                elif cmd.op == OP_ADMIT:
                    self.blackbox.record({
                        "event": "admit",
                        "slot": int(cmd.slot),
                        "seed": int(cmd.tokens[0, 0]),
                        "budget": int(cmd.budget),
                    })
                    self._seed[cmd.slot] = int(cmd.tokens[0, 0])
                    self._pos[cmd.slot] = 0
                    self._budget[cmd.slot] = cmd.budget
                    self._act[cmd.slot] = True
            if not self._act.any():
                if cmd is None:
                    self.commands.wait_nonempty(0.005)
                continue
            emitted = np.full(
                (_STUB_SLOTS, _STUB_CHUNK), -1, dtype=np.int32
            )
            for s in range(_STUB_SLOTS):
                if not self._act[s]:
                    continue
                n = min(_STUB_CHUNK, int(self._budget[s]))
                for j in range(n):
                    emitted[s, j] = _stub_token(
                        int(self._seed[s]), int(self._pos[s]) + j
                    )
                self._pos[s] += n
                self._budget[s] -= n
                if self._budget[s] <= 0:
                    self._act[s] = False
            batch = HarvestBatch(
                seq=-1, emitted=emitted, steps_run=_STUB_CHUNK,
                act=self._act.copy(), budget=self._budget.copy(),
                pos=self._pos.copy(), admit_slot=-1, first_tok=0,
            )
            if not self.tokens.put(batch, stop_check=lambda: self._stop):
                return                 # forced drain unblocked the push
            self.heartbeat.beat()

    def shutdown(self, timeout_s: float = 5.0) -> None:
        from k8s_llm_scheduler_tpu_torch.engine.persistent.ring import (
            OP_QUIESCE,
            Command,
        )

        try:
            self.commands.put(Command(op=OP_QUIESCE), timeout_s=0.5)
        except Exception:
            pass  # graftlint: ok[swallowed-exception] — ring may be full or closed; the stop flag below ends the thread either way
        self._stop = True
        self._thread.join(timeout_s)
        self.commands.close()
        self.tokens.close()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()


async def _run_persistent_stack(
    scenario, plan: FaultPlan, injector: FaultInjector,
    monitor: InvariantMonitor, *, deadline_ms: float | None,
    wave_timeout_s: float,
) -> dict:
    """The persistent serving plane under fire: the REAL ring plane
    (CommandRing admission backpressure, TokenRing seq-verified
    emission, Heartbeat wedge watchdog) under a deterministic stub loop
    thread. Each pod is ONE serving request: its expected token stream
    is a pure function of its name, its placement is decoded from the
    DELIVERED stream over the wave-settled feasible set — so a lost,
    duplicated, or corrupted emission moves a placement and breaks the
    byte-identical trace, and the fallback path re-derives the same
    stream, so a drain must never move one (the determinism contract).

    Determinism: admission is sequential in wave order; chaos flags are
    applied at wave boundaries while the loop is idle; the consumer-
    stall window bounds ring admission to the command ring's capacity
    (the same parked-work bound the production feeder enforces) so the
    feeder never races the jammed loop for RingFull; and the wedge
    window is ordered before any stall window (chaos/faults regime
    builder) so no request is ever mid-stream when the watchdog drains
    — every completion path (ring, reject-fallback, drain-fallback) is
    chosen by the plan, never by thread timing. Timing-dependent ring
    counters (token-ring stalls, heartbeats) stay report-only."""
    import numpy as np

    from k8s_llm_scheduler_tpu_torch.engine.persistent.ring import (
        OP_ADMIT,
        Command,
        RingFull,
    )
    from k8s_llm_scheduler_tpu_torch.sim.scenarios import ClusterModel

    model = ClusterModel(scenario)
    placements: dict[str, str] = {}
    unschedulable: list[str] = []
    slot_req: dict[int, _ServeReq] = {}
    free_slots = list(range(_STUB_SLOTS))
    P = {
        "admitted_ring": 0,
        "completed_ring": 0,
        "completed_fallback": 0,
        "ring_full_rejects": 0,
        "tokens_delivered": 0,
        "tokens_lost": 0,
        "tokens_duplicated": 0,
        "tokens_corrupted": 0,
        "wedges": 0,
        "drains": 0,
        "relaunches": 0,
    }
    timing = {"command_ring_stalls": 0, "token_ring_stalls": 0,
              "heartbeats": 0}

    def new_req(pod, snapshot) -> _ServeReq:
        seed = int(stable_fraction(f"persistent:{pod.name}") * 2**31)
        candidates = sorted(
            n.name for n in feasible_nodes(pod.to_pod_spec(), snapshot)
        )
        return _ServeReq(pod, seed, _stub_stream(seed), candidates)

    def complete(req: _ServeReq) -> None:
        monitor.note_tokens(
            "default", req.pod.name, req.expected, req.delivered
        )
        n_exp, n_got = len(req.expected), len(req.delivered)
        P["tokens_delivered"] += n_got
        if n_got < n_exp:
            P["tokens_lost"] += n_exp - n_got
        elif n_got > n_exp:
            P["tokens_duplicated"] += n_got - n_exp
        elif req.delivered != req.expected:
            P["tokens_corrupted"] += 1
        P["completed_fallback" if req.via_fallback
          else "completed_ring"] += 1
        if req.slot >= 0:
            slot_req.pop(req.slot, None)
            free_slots.append(req.slot)
            free_slots.sort()
            req.slot = -1
        if not req.candidates:
            unschedulable.append(req.pod.name)
            return
        stream = req.delivered or req.expected
        node = req.candidates[
            (stream[0] + sum(stream)) % len(req.candidates)
        ]
        placements[req.pod.name] = node
        model.place(req.pod, node)
        monitor.note_bind(True, "default", req.pod.name, node)

    def fallback_finish(req: _ServeReq) -> None:
        """The dispatch path finishes (or fully serves) the request:
        deterministic continuation from wherever the ring left it."""
        req.delivered.extend(req.expected[len(req.delivered):])
        req.via_fallback = True
        complete(req)

    def book_batch(batch) -> None:
        for s in range(batch.emitted.shape[0]):
            req = slot_req.get(s)
            row = [int(t) for t in batch.emitted[s] if int(t) >= 0]
            if not row:
                continue
            if req is None:
                # emissions for a slot nobody owns: double-delivery
                P["tokens_duplicated"] += len(row)
                monitor.record(
                    "token_integrity", f"slot-{s}",
                    f"{len(row)} emission(s) for an unowned slot",
                )
                continue
            req.delivered.extend(row)
            if len(req.delivered) >= len(req.expected):
                complete(req)

    async def settle_ring(loop, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while slot_req and time.monotonic() < deadline:
            for batch in loop.tokens.drain(0.02):
                book_batch(batch)
            await asyncio.sleep(0)
        return not slot_req

    def retire(loop) -> None:
        timing["command_ring_stalls"] += loop.commands.stalls
        timing["token_ring_stalls"] += loop.tokens.stalls
        timing["heartbeats"] += loop.heartbeat.beats

    async def watchdog_drain(loop) -> None:
        """The wedge path: wait for the REAL Heartbeat watchdog to trip
        (not the harness's knowledge of the schedule), then gracefully
        drain — stop the thread, harvest every emission already in the
        token ring, recover never-taken commands, and hand everything
        still incomplete back to the dispatch path."""
        t_end = time.monotonic() + 5.0
        while (not loop.heartbeat.wedged(_WEDGE_TIMEOUT_S)
               and time.monotonic() < t_end):
            await asyncio.sleep(0.01)
        P["wedges"] += 1
        loop._stop = True
        loop._thread.join(2.0)
        # Black-box dump at the latch, before any drain mutates state —
        # the same order the real server uses (force_stop dumps first).
        # Parked work is deterministic here (wedge windows are ordered
        # before stall windows, so the plane settled), and the dump
        # rides report["persistent"] into the byte-replayable trace.
        loop.blackbox.record({
            "event": "wedge_drain",
            "parked": sorted(
                req.pod.name for req in slot_req.values()
            ),
        })
        P["blackbox"] = loop.blackbox.dump(reason="wedge")
        for batch in loop.tokens.drain(0.0):
            book_batch(batch)
        while True:
            cmd = loop.commands.take()
            if cmd is None:
                break
            req = slot_req.get(cmd.slot)
            if req is not None:
                fallback_finish(req)
        for req in list(slot_req.values()):
            fallback_finish(req)
        loop.commands.close()
        loop.tokens.close()
        retire(loop)
        P["drains"] += 1

    seam = injector.seam("persistent")
    loop: _StubResidentLoop | None = _StubResidentLoop()
    waves_out: list[dict] = []
    try:
        for wave_idx, wave in enumerate(scenario.waves):
            injector.begin_wave(wave_idx)
            model.apply_churn(scenario.churn_for_wave(wave_idx))
            inj_before = dict(injector.injection_counts())
            ring_full = seam.should("ring_full") is not None
            stall = seam.should("consumer_stall") is not None
            wedge = seam.should("loop_wedge") is not None
            t0 = time.perf_counter()  # graftlint: ok[wall-clock-in-replay] — wave/recovery timing rides the report only; build_chaos_trace strips wall_ms before canonicalizing
            n_ring = n_fb = 0
            if not wave:
                waves_out.append({"wave": wave_idx, "n_pods": 0})
                continue
            if wedge:
                if loop is not None:
                    loop.wedged = True
                    await watchdog_drain(loop)
                    loop = None
                # the loop is down for the window: the whole wave rides
                # the dispatch path
                snapshot = model.metrics()
                for pod in wave:
                    fallback_finish(new_req(pod, snapshot))
                    n_fb += 1
            else:
                if loop is None:
                    loop = _StubResidentLoop()
                    P["relaunches"] += 1
                loop.pause_polls = ring_full
                # heal first: parked work from a previous window must
                # resolve before this wave admits (serialized, so the
                # per-wave books stay deterministic)
                if slot_req and not stall:
                    await settle_ring(loop, wave_timeout_s)
                snapshot = model.metrics()
                # stalled consumer: bound admitted-but-unharvested work
                # to the command ring's capacity (the production
                # feeder's parking bound) — the overflow rides the
                # dispatch path by PLAN, not by who lost the race
                quota = loop.commands.capacity if stall else None
                for pod in wave:
                    req = new_req(pod, snapshot)
                    if (quota is not None and n_ring >= quota) \
                            or not free_slots:
                        fallback_finish(req)
                        n_fb += 1
                        continue
                    slot = free_slots.pop(0)
                    cmd = Command(
                        op=OP_ADMIT,
                        tokens=np.array([[req.seed]], dtype=np.int32),
                        suffix_len=1, slot=slot,
                        budget=len(req.expected),
                    )
                    try:
                        loop.commands.put(
                            cmd, timeout_s=0.05 if ring_full else 5.0
                        )
                    except RingFull:
                        P["ring_full_rejects"] += 1
                        free_slots.append(slot)
                        free_slots.sort()
                        fallback_finish(req)
                        n_fb += 1
                        continue
                    req.slot = slot
                    slot_req[slot] = req
                    P["admitted_ring"] += 1
                    n_ring += 1
                if not stall and not ring_full:
                    await settle_ring(loop, wave_timeout_s)
                # ring_full / stall waves leave their admitted work
                # parked (commands queued / emissions unharvested); the
                # next wave's heal pass resolves it
            waves_out.append({
                "wave": wave_idx,
                "n_pods": len(wave),
                "n_bound": sum(
                    1 for p in wave if p.name in placements
                ),
                "n_ring": n_ring,
                "n_fallback": n_fb,
                "parked": len(slot_req),
                "wall_ms": round(
                    (time.perf_counter() - t0) * 1000.0, 3  # graftlint: ok[wall-clock-in-replay] — wave/recovery timing rides the report only; build_chaos_trace strips wall_ms before canonicalizing
                ),
                "injections": _delta(
                    dict(injector.injection_counts()), inj_before
                ),
            })
        injector.end_run()

        if loop is not None:
            loop.pause_polls = False
            await settle_ring(loop, wave_timeout_s)
            for req in list(slot_req.values()):
                fallback_finish(req)   # defensive: never hit on a
                # healthy plane — the final heal drains everything
            loop.shutdown()
            retire(loop)
            loop = None
        all_pods = [p for wave in scenario.waves for p in wave]
        monitor.finalize(
            expected=[("default", p.name) for p in all_pods],
            pending=[("default", n) for n in unschedulable],
        )
        return {
            "placements": dict(sorted(placements.items())),
            "unschedulable": sorted(unschedulable),
            "waves": waves_out,
            "client": {"serving": dict(timing)},
            "persistent": P,
        }
    finally:
        injector.end_run()
        if loop is not None:
            loop.shutdown()
            retire(loop)


# ------------------------------------------------------------------- runner
def run_chaos(
    regime: str,
    seed: int = 0,
    *,
    n_waves: int = 8,
    n_nodes: int = 12,
    n_pods: int | None = None,
    wave_timeout_s: float = 30.0,
    deadline_ms: float | None = 2000.0,
    quality: bool = True,
) -> dict:
    """One seeded chaos run, end to end. Returns the report; the
    deterministic sub-record is extracted by build_chaos_trace().

    `deadline_ms` defaults LOOSE (2s): the budget rides every decision
    frame (the wire stamps it, the worker refuses expired frames) but a
    TIGHT wall-clock deadline would let host hiccups pick which pods
    degrade — exactly the thread-timing dependence the determinism
    contract forbids. The brownout regime degrades via the (virtual-
    time) SLO brownout flag instead; tight-deadline shedding is pinned
    by unit tests where the clock is injectable."""
    from k8s_llm_scheduler_tpu_torch.sim.arena import score_placement
    from k8s_llm_scheduler_tpu_torch.sim.scenarios import chaos_scenario, generate_scenario

    if regime not in REGIMES:
        raise ChaosError(
            f"unknown chaos regime {regime!r} (known: {sorted(REGIMES)})"
        )
    mode = REGIMES[regime]["mode"]
    if n_pods is None:
        # fleet/autoscale/crash modes share the cluster across replicas
        # (or process lifetimes) whose snapshots are not wave-settled:
        # keep per-node worst-case fill clear of max_pods so the
        # feasible set never shifts mid-run
        n_pods = 96 if mode in ("single", "wire") else 64
    spec, plan = chaos_scenario(
        regime, seed, n_nodes=n_nodes, n_pods=n_pods, n_waves=n_waves
    )
    scenario = generate_scenario(spec)
    injector = FaultInjector(plan)
    monitor = InvariantMonitor(injector)

    t_run = time.perf_counter()  # graftlint: ok[wall-clock-in-replay] — wave/recovery timing rides the report only; build_chaos_trace strips wall_ms before canonicalizing
    if mode == "crash":
        stack = asyncio.run(_run_crash_stack(
            scenario, plan, injector, monitor,
            deadline_ms=deadline_ms, wave_timeout_s=wave_timeout_s,
        ))
    elif mode == "autoscale":
        stack = asyncio.run(_run_autoscale_stack(
            scenario, plan, injector, monitor,
            deadline_ms=deadline_ms, wave_timeout_s=wave_timeout_s,
        ))
    elif mode == "fleet":
        stack = asyncio.run(_run_fleet_stack(
            scenario, plan, injector, monitor,
            deadline_ms=deadline_ms, wave_timeout_s=wave_timeout_s,
        ))
    elif mode == "persistent":
        stack = asyncio.run(_run_persistent_stack(
            scenario, plan, injector, monitor,
            deadline_ms=deadline_ms, wave_timeout_s=wave_timeout_s,
        ))
    else:
        stack = asyncio.run(_run_wire_stack(
            scenario, plan, injector, monitor,
            mode=mode, deadline_ms=deadline_ms,
            wave_timeout_s=wave_timeout_s,
        ))
    run_wall_ms = (time.perf_counter() - t_run) * 1000.0  # graftlint: ok[wall-clock-in-replay] — wave/recovery timing rides the report only; build_chaos_trace strips wall_ms before canonicalizing

    scores = score_placement(
        scenario, stack["placements"], stack["unschedulable"]
    )
    report = {
        "metric": "chaos",
        "regime": regime,
        "mode": mode,
        "seed": seed,
        "scenario_spec": spec.to_dict(),
        "plan": plan.to_dict(),
        "plan_digest": plan.digest(),
        "placements": stack["placements"],
        "unschedulable": stack["unschedulable"],
        "scores": scores,
        "waves": stack["waves"],
        "client": stack["client"],
        "injections": injector.injection_counts(),
        "invariants": monitor.report(),
        "recovery": _recovery(plan, stack["waves"]),
        "degraded_fraction": _degraded_fraction(stack["waves"]),
        "wall_ms": round(run_wall_ms, 3),
    }
    if "canary" in stack:
        # learn-swap regime: the burn-in verdict (timing-free booleans,
        # but run-local — stays in the report, not the trace)
        report["canary"] = stack["canary"]
    if "scale_events" in stack:
        # autoscale mode: the controller's membership-change sequence
        # is deterministic in virtual wave time, so it rides the TRACE
        # (byte-replay pins the control loop, not just the placements);
        # the controller stats stay report-only
        report["scale_events"] = stack["scale_events"]
        report["autoscale"] = stack["autoscale"]
    if "restarts" in stack:
        # crash mode: the (wave, point, reconciled) restart sequence is
        # deterministic (sequential drive, times=1 budgets) and rides
        # the trace; MTTR timing and the journal stats stay report-only
        report["restarts"] = stack["restarts"]
        report["journal"] = stack["journal"]
    if "kvplane" in stack:
        # fleet mode: the shared prefix-KV plane's fill/adopt/fallback
        # counters are deterministic (fixed replica order, virtual
        # clock, seeded fault windows) and ride the trace — byte-replay
        # pins the degradation path, and kv_mismatches pins the zero-
        # correctness-loss invariant
        report["kvplane"] = stack["kvplane"]
    if "persistent" in stack:
        # persistent mode: the serving plane's protocol outcome
        # (ring/fallback routing, token-integrity totals, wedge/drain/
        # relaunch counts) is deterministic by the stack's admission
        # discipline and rides the trace; ring stall counters and
        # heartbeat totals are thread-timing and stay report-only
        # (under report["client"]["serving"])
        report["persistent"] = stack["persistent"]
    if quality:
        report["quality"] = _quality_vs_teacher(scenario, scores)
    return report


def _degraded_fraction(waves: list[dict]) -> float:
    total = sum(w.get("client", {}).get("total_requests", 0) for w in waves)
    degraded = sum(
        w.get("client", {}).get("degraded_decisions", 0) for w in waves
    )
    return round(degraded / total, 6) if total else 0.0


def _recovery(plan: FaultPlan, waves: list[dict]) -> dict:
    """Recovery = first post-fault wave that ran clean (no fallbacks,
    no degradations, every released pod bound). `recovery_waves` counts
    the waves it took after the last fault wave; `recovery_ms` sums
    their wall clocks (None: never recovered within the run)."""
    last_fault = plan.last_fault_wave()
    post = [w for w in waves if w["wave"] > last_fault and w.get("n_pods")]
    elapsed = 0.0
    for i, w in enumerate(post):
        elapsed += w.get("wall_ms", 0.0)
        delta = w.get("client", {})
        clean = (
            delta.get("fallback_decisions", 0) == 0
            and delta.get("degraded_decisions", 0) == 0
            and w.get("n_bound", 0) == w.get("n_pods", 0)
        )
        if clean:
            return {
                "last_fault_wave": last_fault,
                "recovery_waves": i + 1,
                "recovery_ms": round(elapsed, 3),
            }
    return {
        "last_fault_wave": last_fault,
        "recovery_waves": None,
        "recovery_ms": None,
    }


def _quality_vs_teacher(scenario, scores: dict) -> dict:
    """Placement quality under chaos vs the fault-free teacher policy —
    the 'how much did degradation cost us' number the bench publishes."""
    from k8s_llm_scheduler_tpu_torch.sim.arena import _run_policy_arm, score_placement
    from k8s_llm_scheduler_tpu_torch.sim.teacher import SpreadLookaheadTeacher

    placements, unsched, _waves = _run_policy_arm(
        scenario, SpreadLookaheadTeacher()
    )
    teacher = score_placement(scenario, placements, unsched)
    return {
        "spread": scores["spread"],
        "teacher_spread": teacher["spread"],
        "spread_vs_teacher": round(
            scores["spread"] - teacher["spread"], 6
        ),
        "bound_frac": scores["bound_frac"],
        "teacher_bound_frac": teacher["bound_frac"],
    }


# -------------------------------------------------------------------- trace
def build_chaos_trace(report: dict) -> dict:
    """The DETERMINISTIC payload of a chaos run (sim/trace.py
    discipline): plan + placements + violations identities + scores —
    plus, for autoscale mode, the controller's scale-event sequence
    (wave-quantized control clock makes it replay-stable). Timing
    (waves, recovery ms) deliberately stays in the report."""
    trace = {
        "version": TRACE_VERSION,
        "scenario_spec": report["scenario_spec"],
        "plan": report["plan"],
        "mode": report["mode"],
        "placements": report["placements"],
        "unschedulable": sorted(report["unschedulable"]),
        "violations": sorted(
            (
                {"invariant": v["invariant"], "subject": v["subject"]}
                for v in report["invariants"]["violations"]
            ),
            key=lambda v: (v["invariant"], v["subject"]),
        ),
        "scores": report["scores"],
    }
    if "scale_events" in report:
        trace["scale_events"] = report["scale_events"]
    if "restarts" in report:
        # (wave, point, reconciled) is the deterministic restart
        # identity; mttr_ms/mttr_waves are run-local timing and stay in
        # the report
        trace["restarts"] = [
            {
                "wave": r["wave"],
                "point": r["point"],
                "reconciled": dict(r["reconciled"]),
            }
            for r in report["restarts"]
        ]
    if "kvplane" in report:
        # deterministic protocol outcome (fills/adoptions/fallbacks +
        # the correctness-mismatch count); byte-identity across runs
        # pins the plane's degradation behaviour under the regime
        trace["kvplane"] = report["kvplane"]
    if "persistent" in report:
        # deterministic serving-plane outcome: which requests rode the
        # rings vs the dispatch path, and the zero-loss/zero-duplicate
        # token books; byte-identity across runs pins the ring protocol
        trace["persistent"] = report["persistent"]
    return trace


def canonical_chaos_bytes(trace: dict) -> bytes:
    from k8s_llm_scheduler_tpu_torch.sim.trace import canonical_bytes

    return canonical_bytes(trace)


def save_chaos_trace(report: dict, path) -> bytes:
    from pathlib import Path

    data = canonical_chaos_bytes(build_chaos_trace(report))
    Path(path).write_bytes(data)
    return data


def load_chaos_trace(path) -> dict:
    import json
    from pathlib import Path

    return json.loads(Path(path).read_bytes().decode("utf-8"))


def replay_chaos_trace(trace: dict) -> dict:
    """Re-derive everything derivable from the recorded trace: the plan
    from (regime, seed, n_waves, topology), the scenario from its spec,
    the scores from the recorded placements. Returns a NEW trace whose
    canonical bytes must equal the recorded ones."""
    from k8s_llm_scheduler_tpu_torch.sim.arena import score_placement
    from k8s_llm_scheduler_tpu_torch.sim.scenarios import (
        ScenarioSpec,
        generate_scenario,
    )

    if trace.get("version") != TRACE_VERSION:
        raise ChaosError(
            f"chaos trace version {trace.get('version')!r} != {TRACE_VERSION}"
        )
    recorded_plan = trace["plan"]
    plan = FaultPlan.generate(
        recorded_plan["regime"], int(recorded_plan["seed"]),
        int(recorded_plan["n_waves"]),
        n_nodes=int(trace["scenario_spec"]["n_nodes"]),
    )
    if plan.to_dict() != recorded_plan:
        raise ChaosError(
            "fault schedule diverged: the recorded plan is not what "
            f"seed {recorded_plan['seed']} generates for regime "
            f"{recorded_plan['regime']!r}"
        )
    spec = ScenarioSpec.from_dict(trace["scenario_spec"])
    scenario = generate_scenario(spec)
    pod_names = {p.name for wave in scenario.waves for p in wave}
    placements = dict(trace["placements"])
    unknown = set(placements) - pod_names
    if unknown:
        raise ChaosError(
            f"trace places pods the scenario never generated: "
            f"{sorted(unknown)[:5]}"
        )
    scores = score_placement(
        scenario, placements, trace.get("unschedulable", ())
    )
    out = {
        "version": TRACE_VERSION,
        "scenario_spec": spec.to_dict(),
        "plan": plan.to_dict(),
        "mode": trace["mode"],
        "placements": placements,
        "unschedulable": sorted(trace.get("unschedulable", ())),
        "violations": list(trace.get("violations", ())),
        "scores": scores,
    }
    if "scale_events" in trace:
        # run-recorded, not re-derivable without re-running the stack —
        # carried verbatim; byte-identity across RUNS is what pins it
        out["scale_events"] = list(trace["scale_events"])
    if "restarts" in trace:
        # same contract as scale_events: the restart sequence is pinned
        # by byte-identity across runs, not re-derived here
        out["restarts"] = list(trace["restarts"])
    if "kvplane" in trace:
        # same contract: run-recorded protocol counters, carried
        # verbatim — byte-identity across RUNS pins them
        out["kvplane"] = dict(trace["kvplane"])
    if "persistent" in trace:
        # same contract: run-recorded ring-protocol books, carried
        # verbatim — byte-identity across RUNS pins them
        out["persistent"] = dict(trace["persistent"])
    return out


def verify_chaos_trace(path) -> tuple[bool, str]:
    """(ok, detail): replay the recorded chaos trace and byte-compare."""
    import difflib
    import json
    from pathlib import Path

    recorded = Path(path).read_bytes()
    replayed = canonical_chaos_bytes(
        replay_chaos_trace(json.loads(recorded))
    )
    recorded_canon = canonical_chaos_bytes(json.loads(recorded))
    if replayed == recorded_canon:
        return True, f"bit-identical ({len(replayed)} bytes)"
    a = json.dumps(json.loads(recorded_canon), indent=1, sort_keys=True)
    b = json.dumps(json.loads(replayed), indent=1, sort_keys=True)
    diff = "\n".join(
        list(difflib.unified_diff(
            a.splitlines(), b.splitlines(), "recorded", "replayed"
        ))[:40]
    )
    return False, f"replay diverged:\n{diff}"
