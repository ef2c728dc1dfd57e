"""Policy arena: one scenario, many deciders, comparable scores.

Round-5 VERDICT: the served LLM decider had never been DEMONSTRATED
beating the `resource_balanced` fallback on any placement metric. The
arena is that demonstration instrument. Every arm runs the SAME seeded
scenario (sim/scenarios.py); placements are scored on:

- **spread**: pstdev of fractional pod fills (train/eval.load_spread —
  the metric the decision prompt asks the model to optimize);
- **utilization balance**: pstdev of requested-CPU and requested-memory
  allocation fractions across nodes (fill spread can look perfect while
  one node holds all the fat pods);
- **constraint satisfaction**: fraction of placed pods whose node passes
  selector/taint/affinity predicates (core/validation — 1.0 or the arm
  is breaking K8s contracts);
- **fragmentation**: 1 - (pods of the mean shape that still fit given
  per-node free vectors) / (pods that would fit if free capacity were
  pooled) — stranded-capacity bin-packing waste;
- **bound fraction** and per-wave latency attribution (sim/trace.py).

Two arm modes:
- `stack`: the decider is a DecisionBackend and the scenario runs through
  the REAL pipeline — wire-level fake API server (cluster/wire_fake.py),
  the in-tree kube client's watch/informer/bind paths over real sockets,
  DecisionClient's cache/single-flight/breaker, the scheduler loop.
  Placements are deterministic because decisions are pure per
  (pod shape, settled snapshot) and waves are drained to a barrier.
- `policy`: the decider is a stateful sequential policy (sim/teacher.py)
  replayed over the deterministic ClusterModel — the reference score the
  live arms chase.
"""

from __future__ import annotations

import asyncio
import dataclasses
import statistics
import time
from typing import Any, Callable, Sequence

from k8s_llm_scheduler_tpu_torch.core.fallback import (
    SCORERS,
    fallback_decision,
)
from k8s_llm_scheduler_tpu_torch.core.validation import (
    node_affinity_matches,
    selector_matches,
    tolerates_taints,
)
from k8s_llm_scheduler_tpu_torch.sim.scenarios import (
    SCHEDULER_NAME,
    ClusterModel,
    Scenario,
    SimPod,
    add_pod_to_wire,
    apply_churn_to_wire,
    apply_topology,
)
from k8s_llm_scheduler_tpu_torch.sim.teacher import SpreadLookaheadTeacher
from k8s_llm_scheduler_tpu_torch.types import (
    DecisionSource,
    NodeMetrics,
    PodSpec,
    SchedulingDecision,
)


class ArenaError(RuntimeError):
    pass


# ------------------------------------------------------------------- arms
class HeuristicBackend:
    """A core/fallback scorer served as a DecisionBackend, so the full
    client stack (cache, single-flight, breaker, validation) runs exactly
    as it would for the model — the arena measures the POLICY difference,
    not a plumbing difference. fallback_needed stays False: to the stack
    this IS the decider, not a degraded answer (and single-flight
    followers may reuse it, like any healthy leader decision)."""

    def __init__(self, strategy: str) -> None:
        if strategy not in SCORERS:
            raise ValueError(f"unknown strategy {strategy!r}")
        self.strategy = strategy

    def get_scheduling_decision(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics]
    ) -> SchedulingDecision:
        from k8s_llm_scheduler_tpu_torch.engine.backend import NoFeasibleNodeError

        decision = fallback_decision(
            nodes, reason="arena", strategy=self.strategy, pod=pod
        )
        if decision is None:
            raise NoFeasibleNodeError(
                f"no feasible node for pod {pod.namespace}/{pod.name}"
            )
        return dataclasses.replace(
            decision,
            fallback_needed=False,
            source=DecisionSource.LLM,
            confidence=0.5,
            reasoning=f"arena[{self.strategy}]",
        )


@dataclasses.dataclass
class ArmSpec:
    """One contender. `make()` returns a DecisionBackend (kind="stack") or
    a policy object with decide()/begin_wave() (kind="policy"). `owned`
    backends are closed by the arena after the run."""

    name: str
    kind: str                      # "stack" | "policy"
    make: Callable[[], Any]
    cache: bool = True
    owned: bool = True


def heuristic_arms() -> list[ArmSpec]:
    return [
        ArmSpec(name=s, kind="stack", make=lambda s=s: HeuristicBackend(s))
        for s in SCORERS
    ]


def teacher_arm() -> ArmSpec:
    return ArmSpec(
        name="teacher", kind="policy", make=SpreadLookaheadTeacher
    )


def stub_llm_arm() -> ArmSpec:
    """The zero-weights stand-in for the LLM arm: the full serving stack
    with engine/backend.StubBackend deciding — what `cli sim` runs when
    no model is configured."""
    from k8s_llm_scheduler_tpu_torch.engine.backend import StubBackend

    return ArmSpec(name="stub-llm", kind="stack", make=StubBackend)


# ---------------------------------------------------------------- scoring
def score_placement(
    scenario: Scenario,
    placements: dict[str, str],
    unschedulable: Sequence[str] = (),
) -> dict:
    """Deterministic placement metrics for one arm's final state.

    Rebuilds the ClusterModel from the scenario and the placement map —
    the SAME computation trace replay performs, so a recorded trace's
    scores are reproducible from its decisions alone (bit-identity)."""
    pods_by_name = {p.name: p for wave in scenario.waves for p in wave}
    model = ClusterModel(scenario)
    for wave_idx in range(len(scenario.waves)):
        model.apply_churn(scenario.churn_for_wave(wave_idx))
    for pod_name in sorted(placements):
        model.place(pods_by_name[pod_name], placements[pod_name])

    final = model.metrics()
    fills = [n.pod_count / n.max_pods for n in final if n.max_pods]
    spread = statistics.pstdev(fills) if len(fills) > 1 else 0.0

    cpu_fracs = []
    mem_fracs = []
    node_facts = {n.name: n for n in scenario.nodes}
    for n in final:
        cpu_fracs.append(model.cpu_alloc[n.name] / n.available_cpu_cores
                         if n.available_cpu_cores else 0.0)
        mem_fracs.append(model.mem_alloc[n.name] / n.available_memory_gb
                         if n.available_memory_gb else 0.0)
    util_cpu = statistics.pstdev(cpu_fracs) if len(cpu_fracs) > 1 else 0.0
    util_mem = statistics.pstdev(mem_fracs) if len(mem_fracs) > 1 else 0.0

    # constraint satisfaction against STATIC node facts (labels, taints,
    # affinity); readiness-at-decision-time is the live stack's concern
    satisfied = 0
    for pod_name in sorted(placements):
        pod = pods_by_name[pod_name].to_pod_spec()
        fact = node_facts.get(placements[pod_name])
        if fact is None:
            continue
        node = NodeMetrics(
            name=fact.name, cpu_usage_percent=0.0, memory_usage_percent=0.0,
            available_cpu_cores=fact.cpu_cores,
            available_memory_gb=fact.memory_gb,
            pod_count=0, max_pods=fact.max_pods,
            labels=dict(fact.labels), taints=fact.taints,
            conditions={"Ready": "True"},
        )
        if (
            selector_matches(pod, node)
            and tolerates_taints(pod, node)
            and node_affinity_matches(pod, node)
        ):
            satisfied += 1

    # fragmentation vs the MEAN pod shape: stranded capacity that a pooled
    # cluster would still serve. Zero-pod scenarios have no shape to
    # fragment against — mean 0 routes every fit through the slot count.
    all_pods = list(pods_by_name.values())
    n_all = max(len(all_pods), 1)
    mean_cpu = sum(p.cpu_m for p in all_pods) / (1000.0 * n_all)
    mean_mem = sum(p.mem_mi for p in all_pods) / (1024.0 * n_all)
    fit = pooled_cpu = pooled_mem = pooled_slots = 0.0
    for n in final:
        cpu_free = max(n.available_cpu_cores - model.cpu_alloc[n.name], 0.0)
        mem_free = max(n.available_memory_gb - model.mem_alloc[n.name], 0.0)
        slots_free = max(n.max_pods - n.pod_count, 0)
        fit += min(
            int(cpu_free / mean_cpu) if mean_cpu else slots_free,
            int(mem_free / mean_mem) if mean_mem else slots_free,
            slots_free,
        )
        pooled_cpu += cpu_free
        pooled_mem += mem_free
        pooled_slots += slots_free
    pooled_fit = min(
        int(pooled_cpu / mean_cpu) if mean_cpu else pooled_slots,
        int(pooled_mem / mean_mem) if mean_mem else pooled_slots,
        pooled_slots,
    )
    fragmentation = 1.0 - (fit / pooled_fit) if pooled_fit else 0.0

    n_pods = scenario.n_pods
    return {
        "spread": round(spread, 6),
        "util_cpu_spread": round(util_cpu, 6),
        "util_mem_spread": round(util_mem, 6),
        "constraint_satisfaction": round(
            satisfied / len(placements), 6
        ) if placements else 1.0,
        "fragmentation": round(fragmentation, 6),
        "bound_frac": round(len(placements) / n_pods, 6) if n_pods else 1.0,
        "n_bound": len(placements),
        "n_unschedulable": len(unschedulable),
    }


# ------------------------------------------------------------ stack runner
async def _settle(predicate, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() > deadline:
            raise ArenaError(f"timed out settling: {what}")
        await asyncio.sleep(0.01)


async def _run_stack_arm(
    scenario: Scenario,
    backend: Any,
    *,
    use_cache: bool = True,
    max_concurrency: int = 64,
    wave_timeout_s: float = 300.0,
) -> tuple[dict[str, str], list[str], list[dict], dict]:
    """Run one backend arm end to end over the wire fake. Returns
    (placements, unschedulable, per-wave attribution, stats)."""
    from k8s_llm_scheduler_tpu_torch.cluster.httpapi import (
        clear_active_config,
        set_active_config,
    )
    from k8s_llm_scheduler_tpu_torch.cluster.kube import KubeCluster
    from k8s_llm_scheduler_tpu_torch.cluster.wire_fake import WireFakeK8s
    from k8s_llm_scheduler_tpu_torch.core.breaker import CircuitBreaker
    from k8s_llm_scheduler_tpu_torch.core.cache import DecisionCache
    from k8s_llm_scheduler_tpu_torch.sched.client import DecisionClient
    from k8s_llm_scheduler_tpu_torch.sched.loop import Scheduler

    wire = WireFakeK8s(auto_run=True)
    cluster = None
    task = None
    try:
        apply_topology(scenario, wire)
        set_active_config(wire.base_url)
        cluster = KubeCluster(watch_timeout_seconds=10)
        client = DecisionClient(
            backend,
            cache=DecisionCache(max_size=4096) if use_cache else None,
            breaker=CircuitBreaker(),
            retry_delay=0.05,
        )
        scheduler = Scheduler(
            cluster, cluster, client,
            scheduler_name=SCHEDULER_NAME,
            snapshot_ttl_s=1e9,          # waves invalidate explicitly
            max_concurrency=max_concurrency,
            prefix_prewarm_s=0.0,        # determinism: no idle installs
        )

        # every bind converges on _note_bind: tag pod -> (node, source,
        # backend latency, bind wall time) without touching the loop
        outcomes: dict[str, tuple[str, str, float, float]] = {}
        orig_note = scheduler._note_bind

        def tagging_note(ok, pod, decision):
            if ok:
                outcomes[pod.name] = (
                    decision.selected_node,
                    decision.source.value,
                    decision.latency_ms,
                    time.perf_counter(),
                )
            orig_note(ok, pod, decision)

        scheduler._note_bind = tagging_note

        # Pods that resolved WITHOUT a bind (unschedulable, failed bind),
        # by name. A global-counter delta here would double-count when a
        # watch fresh-start re-delivers still-pending pods from earlier
        # waves (the 410 path wire_fake supports) and release the wave
        # barrier early — a set of names is idempotent under redelivery.
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
        engine_stats = getattr(backend, "get_stats", None)
        placements: dict[str, str] = {}
        unschedulable: list[str] = []
        waves_out: list[dict] = []

        for wave_idx, wave in enumerate(scenario.waves):
            churn = scenario.churn_for_wave(wave_idx)
            if churn:
                apply_churn_to_wire(scenario, churn, wire)
                model.apply_churn(churn)
                expect = {
                    n.name: model.ready[n.name] for n in model.live_nodes()
                }

                def churn_settled() -> bool:
                    seen = {
                        n.name: n.is_ready
                        for n in cluster.get_node_metrics()
                    }
                    return seen == expect

                await _settle(
                    churn_settled, wave_timeout_s, f"churn@wave{wave_idx}"
                )
            if not wave:
                waves_out.append({"wave": wave_idx, "n_pods": 0})
                continue

            scheduler.invalidate_snapshot()
            phases_before = scheduler.phases.snapshot()
            engine_before = dict(engine_stats()) if engine_stats else {}
            t0 = time.perf_counter()
            for pod in wave:
                add_pod_to_wire(pod, wire)

            released = {p.name for p in wave}

            def wave_done() -> bool:
                return all(
                    n in outcomes or n in unplaced for n in released
                )

            await _settle(wave_done, wave_timeout_s, f"wave{wave_idx} drain")
            wall_s = time.perf_counter() - t0

            wave_bound = [n for n in released if n in outcomes]
            for name in wave_bound:
                placements[name] = outcomes[name][0]
            wave_unsched = sorted(released - set(wave_bound))
            unschedulable.extend(wave_unsched)
            for pod in wave:
                if pod.name in outcomes:
                    model.place(pod, outcomes[pod.name][0])

            # barrier: the informer must reflect every bind before the
            # next wave's snapshot (usage synthesis counts placements).
            # Count only pods on still-present nodes — a churn-deleted
            # node takes its placements out of the informer's view.
            total_bound = sum(
                1 for node in placements.values() if model.present.get(node)
            )

            def informer_settled(want=total_bound) -> bool:
                return sum(
                    n.pod_count for n in cluster.get_node_metrics()
                ) >= want

            await _settle(
                informer_settled, wave_timeout_s,
                f"wave{wave_idx} informer",
            )

            waves_out.append(
                _wave_attribution(
                    wave_idx, wave, outcomes, t0, wall_s,
                    phases_before, scheduler.phases.snapshot(),
                    engine_before,
                    dict(engine_stats()) if engine_stats else {},
                    wave_unsched,
                )
            )

        stats = scheduler.get_stats()
        return placements, unschedulable, waves_out, stats
    finally:
        if task is not None:
            scheduler.stop()
            cluster.close()
            try:
                await asyncio.wait_for(task, timeout=30)
            except asyncio.TimeoutError:
                task.cancel()
        elif cluster is not None:
            cluster.close()
        wire.close()
        # drop the process-global active config now pointing at a dead
        # server (same hygiene as the chaos harness): later clients must
        # fall back to real cluster discovery, not dial this address
        clear_active_config()


def _phase_delta(before: dict, after: dict, name: str) -> float:
    b = before.get(name, {}).get("total_ms", 0.0)
    a = after.get(name, {}).get("total_ms", 0.0)
    return a - b


def _wave_attribution(
    wave_idx: int,
    wave: list[SimPod],
    outcomes: dict,
    t0: float,
    wall_s: float,
    phases_before: dict,
    phases_after: dict,
    engine_before: dict,
    engine_after: dict,
    unschedulable: list[str],
) -> dict:
    """Decompose one wave's latency (the burst-residual instrument).

    Per-pod latency = bind wall time - wave release. Phase numbers are
    DELTAS of the scheduler's PhaseRecorder totals (sums over pods —
    concurrent phases legitimately exceed wall time). `admission_ms` is
    decide-total minus backend-total: time decisions spent queued in the
    client (semaphore, single-flight parking) rather than in the model.
    The prefill/decode split apportions backend time by the engine's
    token-count deltas — an estimate (flagged _est), absent for
    engine-less arms. `residual_p50_ms` is the per-pod median latency not
    covered by per-pod mean phase costs: the number that was previously
    invisible (~100 ms of unattributed burst latency, VERDICT r5)."""
    n = len(wave)
    lat = sorted(
        (outcomes[p.name][3] - t0) * 1000.0
        for p in wave if p.name in outcomes
    )
    backend_ms = sum(
        outcomes[p.name][2]
        for p in wave
        if p.name in outcomes and outcomes[p.name][1] == "llm"
    )
    n_llm = sum(
        1 for p in wave
        if p.name in outcomes and outcomes[p.name][1] == "llm"
    )
    snapshot_ms = _phase_delta(phases_before, phases_after, "snapshot")
    decide_ms = _phase_delta(phases_before, phases_after, "decide")
    bind_ms = _phase_delta(phases_before, phases_after, "bind")
    admission_ms = max(decide_ms - backend_ms, 0.0)
    # Window percentiles from HISTOGRAM bucket deltas (observability/trace):
    # this wave's own decide/bind p50/p95 — a per-wave total only says how
    # much time was spent, not how it was distributed over the wave's pods
    # (the avg hid exactly the tail the attribution exists to expose).
    from k8s_llm_scheduler_tpu_torch.observability.trace import (
        delta_hist,
        hist_percentiles,
    )

    phase_pcts = {}
    for phase in ("decide", "bind"):
        dh = delta_hist(phases_before.get(phase), phases_after.get(phase))
        if dh and dh["count"]:
            p50, p95, _ = hist_percentiles(dh["counts"])
            phase_pcts[f"{phase}_p50_ms"] = round(p50, 3)
            phase_pcts[f"{phase}_p95_ms"] = round(p95, 3)
    out = {
        "wave": wave_idx,
        "n_pods": n,
        "n_bound": len(lat),
        "n_llm_leaders": n_llm,
        "n_unschedulable": len(unschedulable),
        "wall_ms": round(wall_s * 1000.0, 3),
        "pod_p50_ms": round(statistics.median(lat), 3) if lat else None,
        "pod_p95_ms": round(
            lat[min(len(lat) - 1, int(len(lat) * 0.95))], 3
        ) if lat else None,
        "snapshot_ms": round(snapshot_ms, 3),
        "decide_ms": round(decide_ms, 3),
        "bind_ms": round(bind_ms, 3),
        "backend_ms": round(backend_ms, 3),
        "admission_ms": round(admission_ms, 3),
        **phase_pcts,
    }
    pf = engine_after.get("prefill_tokens", 0) - engine_before.get(
        "prefill_tokens", 0
    )
    dc = engine_after.get("decode_tokens", 0) - engine_before.get(
        "decode_tokens", 0
    )
    if backend_ms and (pf + dc):
        out["prefill_ms_est"] = round(backend_ms * pf / (pf + dc), 3)
        out["decode_ms_est"] = round(backend_ms * dc / (pf + dc), 3)
        out["prefill_tokens"] = int(pf)
        out["decode_tokens"] = int(dc)
    if lat:
        per_pod_known = (snapshot_ms + decide_ms + bind_ms) / max(len(lat), 1)
        out["residual_p50_ms"] = round(
            max(statistics.median(lat) - per_pod_known, 0.0), 3
        )
    return out


# ----------------------------------------------------------- policy runner
def _run_policy_arm(
    scenario: Scenario, policy: Any
) -> tuple[dict[str, str], list[str], list[dict]]:
    """Sequential deterministic replay over the ClusterModel (stateful
    policies — the teacher). Wave structure and churn identical to the
    stack runner; 'latency' here is pure host compute."""
    model = ClusterModel(scenario)
    placements: dict[str, str] = {}
    unschedulable: list[str] = []
    waves_out: list[dict] = []
    if hasattr(policy, "reset"):
        policy.reset()
    for wave_idx, wave in enumerate(scenario.waves):
        model.apply_churn(scenario.churn_for_wave(wave_idx))
        if not wave:
            waves_out.append({"wave": wave_idx, "n_pods": 0})
            continue
        snapshot = model.metrics()
        if hasattr(policy, "begin_wave"):
            policy.begin_wave()
        t0 = time.perf_counter()
        decided: list[tuple[SimPod, str]] = []
        wave_unsched: list[str] = []
        for pod in wave:
            name = policy.decide(pod.to_pod_spec(), snapshot)
            if name is None:
                wave_unsched.append(pod.name)
            else:
                decided.append((pod, name))
        wall_s = time.perf_counter() - t0
        for pod, node in decided:
            model.place(pod, node)
            placements[pod.name] = node
        unschedulable.extend(wave_unsched)
        waves_out.append({
            "wave": wave_idx,
            "n_pods": len(wave),
            "n_bound": len(decided),
            "n_unschedulable": len(wave_unsched),
            "wall_ms": round(wall_s * 1000.0, 3),
            "decide_ms": round(wall_s * 1000.0, 3),
        })
    return placements, unschedulable, waves_out


# ------------------------------------------------------------------ arena
def run_arena(
    scenario: Scenario,
    arms: Sequence[ArmSpec],
    *,
    wave_timeout_s: float = 300.0,
    max_concurrency: int = 64,
    on_arm_done: "Callable[[str, dict], None] | None" = None,
) -> dict:
    """Run every arm over `scenario`; return the BENCH-style report.

    Report = {"scenario": ..., "arms": {name: {"scores", "waves",
    "stats"}}}. `scores`, each arm's `placements_digest`, and the per-arm
    placements (in the trace) are deterministic for a given scenario
    seed; `waves` carries the timing attribution and is expected to vary
    run to run. `on_arm_done(name, arm_report)` fires as each arm lands —
    the live hook `cli sim --metrics-port` exports scrapes through."""
    report_arms: dict[str, dict] = {}
    traces: dict[str, dict] = {}
    for arm in arms:
        impl = arm.make()
        try:
            if arm.kind == "stack":
                placements, unsched, waves, stats = asyncio.run(
                    _run_stack_arm(
                        scenario, impl,
                        use_cache=arm.cache,
                        max_concurrency=max_concurrency,
                        wave_timeout_s=wave_timeout_s,
                    )
                )
            elif arm.kind == "policy":
                placements, unsched, waves = _run_policy_arm(scenario, impl)
                stats = {}
            else:
                raise ValueError(f"unknown arm kind {arm.kind!r}")
        finally:
            if arm.owned and hasattr(impl, "close"):
                impl.close()
        scores = score_placement(scenario, placements, unsched)
        report_arms[arm.name] = {
            "kind": arm.kind,
            "scores": scores,
            # determinism witness without shipping the full map: two runs
            # of the same seed must print the same digest
            "placements_digest": placements_digest(placements),
            "waves": waves,
            "stats": _compact_stats(stats),
        }
        traces[arm.name] = {
            "placements": placements,
            "unschedulable": sorted(unsched),
            "scores": scores,
        }
        if on_arm_done is not None:
            on_arm_done(arm.name, report_arms[arm.name])
    return {
        "metric": "sim_arena",
        "scenario": scenario.spec.to_dict(),
        "arms": report_arms,
        "_traces": traces,  # consumed by sim/trace.py; stripped from JSON
    }


def placements_digest(placements: dict[str, str]) -> str:
    import hashlib

    # THE canonical serialization (sim/trace.py) — one definition of
    # byte-stable form, so the digest and the trace can never disagree
    from k8s_llm_scheduler_tpu_torch.sim.trace import canonical_bytes

    return hashlib.sha256(canonical_bytes(placements)).hexdigest()[:16]


def _compact_stats(stats: dict) -> dict:
    """Keep the decision-mix counters; drop nested engine/client detail
    (the full stats surface via /metrics when a MetricsServer is up)."""
    keep = (
        "total_scheduled", "llm_decisions", "cache_decisions",
        "fallback_decisions", "failed_bindings", "unschedulable",
    )
    return {k: stats[k] for k in keep if k in stats}
