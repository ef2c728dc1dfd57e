"""Seeded scenario generators + the deterministic cluster twin.

SARATHI (arXiv:2308.16369) and Prepacking (arXiv:2404.09529) both show
that batching schedulers must be measured under realistic ARRIVAL
PROCESSES, not single-request microbenchmarks — yet through round 5 the
repo's only workload generator was `testing.pod_burst` (one shape ladder,
burst-at-t0, uniform nodes). This module generates the missing scenario
space, all from one seed:

- topologies: 3→256+ nodes across heterogeneous SKUs, zone/tier labels,
  NoSchedule taints;
- workloads: Poisson or burst arrivals quantized into WAVES (the unit the
  arena drains, scores, and attributes latency to), resource-shape mixes,
  and per-shape placement constraints drawn from the SAME scenario-class
  taxonomy `cli eval --scenarios` measures (train/eval.SCENARIO_CLASSES —
  arena scores and eval tables speak one language);
- churn: wave-indexed node failures/recoveries/additions/deletions
  (wall-clock-indexed churn would make replay nondeterministic).

`ClusterModel` is the deterministic twin of the informer's view (same
pod-count synthesized usage as cluster/kube.py and cluster/fake.py): the
scoring and trace-replay authority. The live run drives the REAL stack
over cluster/wire_fake.py; the model never decides, it only accounts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from k8s_llm_scheduler_tpu_torch.cluster.interface import RawPod
from k8s_llm_scheduler_tpu_torch.train.eval import SCENARIO_CLASSES, sample_pod_constraints
from k8s_llm_scheduler_tpu_torch.types import NodeMetrics, PodSpec

SCHEDULER_NAME = "ai-llama-scheduler"

# (cpu cores, memory GB, max pods) — the SKU ladder topologies draw from;
# index 2 is the homogeneous default (testing.synthetic_cluster's shape).
SKUS = (
    (4.0, 16.0, 30),
    (8.0, 32.0, 60),
    (16.0, 64.0, 110),
    (64.0, 256.0, 250),
)


@dataclasses.dataclass(frozen=True)
class SimNode:
    name: str
    cpu_cores: float
    memory_gb: float
    max_pods: int
    labels: dict[str, str]
    taints: tuple[dict[str, str], ...] = ()
    ready: bool = True


@dataclasses.dataclass(frozen=True)
class SimPod:
    name: str
    shape: int               # shape id (cache-coherence group)
    kind: str                # scenario class (train/eval.SCENARIO_CLASSES)
    cpu_m: int               # CPU request, millicores
    mem_mi: int              # memory request, Mi
    node_selector: dict[str, str]
    tolerations: tuple[dict[str, Any], ...]
    affinity_terms: tuple[tuple[dict, ...], ...]  # normalized OR-of-ANDs
    arrival_s: float = 0.0
    priority: int = 0

    def to_pod_spec(self) -> PodSpec:
        """The normalized view core/validation + the teacher policy use —
        unit conversion matches cluster/interface.raw_pod_to_spec."""
        affinity = (
            {"node_affinity_terms": [list(t) for t in self.affinity_terms]}
            if self.affinity_terms
            else {}
        )
        return PodSpec(
            name=self.name,
            namespace="default",
            cpu_request=self.cpu_m / 1000.0,
            memory_request=self.mem_mi / 1024.0,
            node_selector=dict(self.node_selector),
            tolerations=self.tolerations,
            affinity_rules=affinity,
            priority=self.priority,
        )

    def to_raw_pod(self) -> RawPod:
        affinity = (
            {"node_affinity_terms": [list(t) for t in self.affinity_terms]}
            if self.affinity_terms
            else {}
        )
        return RawPod(
            name=self.name,
            namespace="default",
            scheduler_name=SCHEDULER_NAME,
            container_requests=(
                {"cpu": f"{self.cpu_m}m", "memory": f"{self.mem_mi}Mi"},
            ),
            node_selector=dict(self.node_selector),
            tolerations=self.tolerations,
            affinity=affinity,
            priority=self.priority,
        )


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """Applied (and settled) BEFORE wave `wave` is released."""

    wave: int
    kind: str        # fail | recover | add | delete
    node: str


@dataclasses.dataclass
class ScenarioSpec:
    """Everything a scenario is, in one seedable record."""

    name: str = "scenario"
    seed: int = 0
    n_nodes: int = 16
    n_pods: int = 64
    shapes: int = 8
    # burst | poisson | waves | multitenant | flap | diurnal
    arrival: str = "burst"
    arrival_rate: float = 500.0   # pods/sec (poisson / multitenant aggregate)
    wave_window_s: float = 0.1    # arrival quantization window (poisson)
    n_waves: int = 4              # explicit wave count (waves/flap/diurnal)
    # flap arrival (scale-thrash workloads): heavy and light waves
    # alternate; heavy waves carry this fraction of the pods — arrival
    # pressure flaps across the autoscaler's deadband every wave
    flap_heavy_frac: float = 0.85
    # diurnal arrival (the millions-of-users day curve, wave-quantized):
    # per-wave load follows 1 + amplitude*sin starting at the trough, so
    # one period ramps trough -> peak -> trough. amplitude 0.9 ~ a 19x
    # trough-to-peak swing (the ROADMAP "diurnal 10x" class).
    diurnal_amplitude: float = 0.9
    diurnal_period_waves: int = 0  # 0 = one full period over n_waves
    # multitenant arrival shaping: number of independent tenant sources.
    # Each tenant is an on/off Poisson stream whose share of the
    # aggregate rate is drawn lognormal (heavy-tailed) — a few heavy
    # tenants dominate and their on-periods overlap into the bursty,
    # long-tailed superposition a fleet frontend actually sees.
    tenants: int = 1
    hetero: bool = True           # draw node SKUs from the ladder
    zones: int = 4
    taint_frac: float = 0.0       # fraction of nodes carrying NoSchedule
    # per-shape constraint classes cycled over the shape ids; "uniform"
    # means unconstrained (the training distribution)
    constraint_mix: tuple[str, ...] = ("uniform",)
    churn: tuple[ChurnEvent, ...] = ()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["churn"] = [dataclasses.asdict(e) for e in self.churn]
        d["constraint_mix"] = list(self.constraint_mix)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        d = dict(d)
        d["churn"] = tuple(ChurnEvent(**e) for e in d.get("churn", ()))
        d["constraint_mix"] = tuple(d.get("constraint_mix") or ("uniform",))
        return cls(**d)


@dataclasses.dataclass
class Scenario:
    spec: ScenarioSpec
    nodes: list[SimNode]
    waves: list[list[SimPod]]    # pods grouped by release wave

    @property
    def n_pods(self) -> int:
        return sum(len(w) for w in self.waves)

    def churn_for_wave(self, wave: int) -> list[ChurnEvent]:
        return [e for e in self.spec.churn if e.wave == wave]

    def to_dict(self) -> dict:
        return {
            "spec": self.spec.to_dict(),
            "nodes": [dataclasses.asdict(n) for n in self.nodes],
            "waves": [
                [dataclasses.asdict(p) for p in wave] for wave in self.waves
            ],
        }


def _normalize_kinds(mix: Sequence[str]) -> tuple[str, ...]:
    for kind in mix:
        if kind not in SCENARIO_CLASSES:
            raise ValueError(
                f"unknown constraint class {kind!r} "
                f"(known: {SCENARIO_CLASSES})"
            )
    return tuple(mix) or ("uniform",)


def generate_scenario(spec: ScenarioSpec) -> Scenario:
    """One seed -> one fully-determined scenario (topology + workload).

    Every random draw comes from a single np.random.default_rng(seed)
    stream in a FIXED order, so the same spec always generates the same
    scenario object — the determinism the arena's acceptance bar
    (identical placements and scores across runs) is built on.
    """
    mix = _normalize_kinds(spec.constraint_mix)
    rng = np.random.default_rng(spec.seed)

    # ------------------------------------------------------------- topology
    nodes: list[SimNode] = []
    for i in range(spec.n_nodes):
        if spec.hetero:
            cpu, mem, max_pods = SKUS[int(rng.integers(len(SKUS)))]
        else:
            cpu, mem, max_pods = SKUS[2]
        labels = {
            "zone": f"z{i % max(1, spec.zones)}",
            "tier": "db" if i % 2 else "web",
        }
        taints: tuple[dict[str, str], ...] = ()
        if spec.taint_frac > 0 and rng.random() < spec.taint_frac:
            taints = (
                {"key": "dedicated", "value": "gpu", "effect": "NoSchedule"},
            )
        nodes.append(
            SimNode(
                name=f"sim-node-{i:03d}",
                cpu_cores=cpu,
                memory_gb=mem,
                max_pods=max_pods,
                labels=labels,
                taints=taints,
            )
        )

    # churn validated HERE, against the topology just generated: a typo'd
    # node name was previously a silent no-op in policy arms (phantom dict
    # key in ClusterModel) and a mid-run KeyError in stack arms — after
    # earlier arms had already burned their wall time
    known = {n.name for n in nodes}
    for e in spec.churn:
        if e.kind not in ("fail", "recover", "add", "delete"):
            raise ValueError(
                f"churn event {e}: unknown kind {e.kind!r} "
                f"(known: fail, recover, add, delete)"
            )
        if e.node not in known:
            raise ValueError(
                f"churn event {e}: node {e.node!r} is not in this "
                f"topology (nodes are sim-node-000..{spec.n_nodes - 1:03d})"
            )

    # ---------------------------------------------------- per-shape draws
    # Constraints are drawn ONCE per shape and shared by every pod of that
    # shape — replicas of one deployment carry one pod template, and this
    # is exactly what makes the decision cache's single-flight economics
    # realistic (8 shapes -> ~8 leaders per wave, not n_pods).
    shape_constraints: list[tuple[dict, tuple, dict]] = []
    shape_kinds: list[str] = []
    for s in range(spec.shapes):
        kind = mix[s % len(mix)]
        shape_kinds.append(kind)
        shape_constraints.append(sample_pod_constraints(kind, rng))

    # ------------------------------------------------------------ arrivals
    if spec.arrival == "poisson":
        gaps = rng.exponential(1.0 / max(spec.arrival_rate, 1e-9), spec.n_pods)
        arrivals = np.cumsum(gaps)
        wave_of = (arrivals // max(spec.wave_window_s, 1e-9)).astype(int)
        # compact to consecutive wave ids (empty windows carry no info)
        _, wave_of = np.unique(wave_of, return_inverse=True)
    elif spec.arrival == "waves":
        n_waves = max(1, spec.n_waves)
        arrivals = np.zeros(spec.n_pods)
        wave_of = np.minimum(
            np.arange(spec.n_pods) * n_waves // max(1, spec.n_pods),
            n_waves - 1,
        )
    elif spec.arrival == "multitenant":
        # Superposition of per-tenant on/off Poisson sources. Tenant
        # shares are lognormal (heavy-tailed: a handful of tenants carry
        # most of the traffic — the millions-of-users shape, where "user
        # demand" reaches the scheduler as deployments scaling replicas);
        # each tenant's stream starts at its own offset so bursts overlap
        # instead of aligning at t0.
        tenants = max(1, spec.tenants)
        weights = rng.lognormal(mean=0.0, sigma=1.5, size=tenants)
        weights = weights / weights.sum()
        counts = rng.multinomial(spec.n_pods, weights)
        horizon = spec.n_pods / max(spec.arrival_rate, 1e-9)
        streams = []
        for t in range(tenants):
            if counts[t] == 0:
                continue
            # tenant rate ~ its share of the aggregate; the on-period
            # offset spreads tenants over the first half of the horizon
            rate = max(spec.arrival_rate * float(weights[t]), 1e-9)
            start = float(rng.uniform(0.0, horizon * 0.5))
            gaps = rng.exponential(1.0 / rate, int(counts[t]))
            streams.append(start + np.cumsum(gaps))
        arrivals = np.sort(np.concatenate(streams)) if streams else np.zeros(0)
        wave_of = (arrivals // max(spec.wave_window_s, 1e-9)).astype(int)
        _, wave_of = np.unique(wave_of, return_inverse=True)
    elif spec.arrival == "flap":
        # alternating heavy/light waves: the scale-thrash workload.
        # Allocation is pure arithmetic (no rng draw) so the flap shape
        # is identical across seeds that share a geometry.
        n_waves = max(2, spec.n_waves)
        heavy = [w for w in range(n_waves) if w % 2 == 0]
        light = [w for w in range(n_waves) if w % 2 == 1]
        n_heavy = int(round(spec.n_pods * min(max(spec.flap_heavy_frac, 0.0), 1.0)))
        counts = np.zeros(n_waves, dtype=int)
        for group, total in ((heavy, n_heavy), (light, spec.n_pods - n_heavy)):
            base, rem = divmod(total, len(group))
            for j, w in enumerate(group):
                counts[w] = base + (1 if j < rem else 0)
        wave_of = np.repeat(np.arange(n_waves), counts)
        arrivals = np.zeros(spec.n_pods)
    elif spec.arrival == "diurnal":
        # wave-quantized day curve: per-wave weight 1 + A*sin starting
        # at the trough (wave 0 lightest, peak mid-period). Pod counts
        # come from largest-remainder apportionment of the weights —
        # deterministic, and the total is exactly n_pods.
        n_waves = max(1, spec.n_waves)
        period = spec.diurnal_period_waves or n_waves
        phase = 2.0 * np.pi * (np.arange(n_waves) + 0.5) / max(period, 1)
        weights = 1.0 + spec.diurnal_amplitude * np.sin(phase - np.pi / 2.0)
        weights = np.clip(weights, 0.0, None)
        if weights.sum() <= 0:
            weights = np.ones(n_waves)
        weights = weights / weights.sum()
        raw = weights * spec.n_pods
        counts = np.floor(raw).astype(int)
        remainder = spec.n_pods - int(counts.sum())
        order = np.argsort(-(raw - counts), kind="stable")
        counts[order[:remainder]] += 1
        wave_of = np.repeat(np.arange(n_waves), counts)
        arrivals = np.zeros(spec.n_pods)
    elif spec.arrival == "burst":
        arrivals = np.zeros(spec.n_pods)
        wave_of = np.zeros(spec.n_pods, dtype=int)
    else:
        raise ValueError(f"unknown arrival process {spec.arrival!r}")

    # ---------------------------------------------------------------- pods
    n_churn_waves = max((e.wave for e in spec.churn), default=-1) + 1
    n_waves_total = max(int(wave_of.max()) + 1 if spec.n_pods else 1,
                        n_churn_waves)
    if spec.arrival in ("flap", "diurnal"):
        # a trough wave may carry ZERO pods — it still exists (the
        # harness's fault windows and the autoscaler's down-scale ticks
        # are indexed by wave, and an idle wave is exactly when a
        # scale-down should fire)
        n_waves_total = max(n_waves_total, max(1, spec.n_waves))
    waves: list[list[SimPod]] = [[] for _ in range(n_waves_total)]
    for i in range(spec.n_pods):
        shape = i % spec.shapes
        selector, tolerations, affinity = shape_constraints[shape]
        terms = tuple(
            tuple(term) for term in affinity.get("node_affinity_terms", [])
        )
        waves[int(wave_of[i])].append(
            SimPod(
                name=f"sim-pod-{i:04d}",
                shape=shape,
                kind=shape_kinds[shape],
                cpu_m=100 + 50 * shape,
                mem_mi=128 * (1 + shape % 4),
                node_selector=selector,
                tolerations=tolerations,
                affinity_terms=terms,
                arrival_s=round(float(arrivals[i]), 6),
                priority=shape % 3,
            )
        )
    return Scenario(spec=spec, nodes=nodes, waves=waves)


# ---------------------------------------------------------- fleet scenarios
# Named fleet-scale scenario classes (ROADMAP open item 4): arrival
# traces shaped like heavy multi-tenant traffic against large hetero
# topologies. `fleet-500` is the fast-tier variant (CI, bench.py
# --preset fleet); `fleet-10k` is the 10k-node / 100k-pod class (slow
# tier — generation is seconds, driving it through a live stack is a
# deliberate soak). Specs are returned by value: callers may mutate
# their copy (seed sweeps, pod-count overrides) without corrupting the
# registry.
FLEET_SCENARIOS: dict[str, ScenarioSpec] = {
    "fleet-500": ScenarioSpec(
        name="fleet-500",
        seed=7,
        n_nodes=500,
        n_pods=5_000,
        shapes=64,
        arrival="multitenant",
        tenants=24,
        arrival_rate=5_000.0,
        wave_window_s=0.05,
        hetero=True,
        zones=8,
        taint_frac=0.02,
        constraint_mix=("uniform", "selector", "uniform", "tainted"),
    ),
    "fleet-10k": ScenarioSpec(
        name="fleet-10k",
        seed=7,
        n_nodes=10_000,
        n_pods=100_000,
        shapes=512,
        arrival="multitenant",
        tenants=200,
        arrival_rate=50_000.0,
        wave_window_s=0.05,
        hetero=True,
        zones=16,
        taint_frac=0.02,
        constraint_mix=("uniform", "selector", "uniform", "tainted"),
    ),
}


def fleet_scenario(name: str) -> ScenarioSpec:
    """A copy of a named fleet scenario spec (see FLEET_SCENARIOS)."""
    try:
        spec = FLEET_SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown fleet scenario {name!r} "
            f"(known: {sorted(FLEET_SCENARIOS)})"
        ) from None
    return dataclasses.replace(spec)


# ---------------------------------------------------------- chaos scenarios
def chaos_scenario(
    regime: str,
    seed: int = 0,
    *,
    n_nodes: int = 12,
    n_pods: int = 96,
    shapes: int = 8,
    n_waves: int = 8,
):
    """(ScenarioSpec, FaultPlan) for one chaos regime (chaos/faults.py
    REGIMES): the workload side is a wave-quantized scenario from THIS
    module's generator — same seed discipline, same churn machinery (the
    node-failure and autoscaler regimes ride ChurnEvent exactly like
    arena scenarios) — and the fault side is the regime's seeded
    FaultPlan over the same virtual (wave) clock. One seed determines
    both, which is what makes a chaos run a replayable artifact.

    Constraints stay uniform on purpose: every pod must be placeable so
    the invariant monitor's lost-pod accounting is exact (an
    unschedulable-by-construction pod would be indistinguishable from a
    dropped one without carrying the constraint solver into the chaos
    verdict)."""
    from k8s_llm_scheduler_tpu_torch.chaos.faults import REGIMES, FaultPlan

    plan = FaultPlan.generate(regime, seed, n_waves, n_nodes=n_nodes)
    churn = tuple(
        ChurnEvent(wave=int(c["wave"]), kind=c["kind"], node=c["node"])
        for c in plan.churn
    )
    # scale regimes shape the workload side too: flap parks arrival
    # pressure on the autoscaler's threshold, diurnal ramps it through
    # the fault window (chaos/faults.REGIMES declares which)
    arrival = REGIMES[regime].get("arrival", "waves")
    spec = ScenarioSpec(
        name=f"chaos-{regime}",
        seed=seed,
        n_nodes=n_nodes,
        n_pods=n_pods,
        shapes=shapes,
        arrival=arrival,
        n_waves=n_waves,
        hetero=True,
        zones=4,
        taint_frac=0.0,
        constraint_mix=("uniform",),
        churn=churn,
    )
    return spec, plan


# --------------------------------------------------------------- twin model
class ClusterModel:
    """Deterministic in-memory twin of what the informer would report.

    Usage synthesis parity: (pod_count / max_pods) * 50 — the exact
    stand-in cluster/kube.py and cluster/fake.py use when metrics-server
    is absent, so a policy decided against the model sees the same
    numbers a policy decided against the live stack sees. Also tracks
    requested-resource allocation per node (the live NodeMetrics carries
    CAPACITY, not allocation — utilization-balance scoring needs the
    latter)."""

    def __init__(self, scenario: Scenario) -> None:
        self._base = {n.name: n for n in scenario.nodes}
        self.ready: dict[str, bool] = {n.name: n.ready for n in scenario.nodes}
        self.present: dict[str, bool] = {n.name: True for n in scenario.nodes}
        self.pod_count: dict[str, int] = {n.name: 0 for n in scenario.nodes}
        self.cpu_alloc: dict[str, float] = {n.name: 0.0 for n in scenario.nodes}
        self.mem_alloc: dict[str, float] = {n.name: 0.0 for n in scenario.nodes}

    def apply_churn(self, events: Sequence[ChurnEvent]) -> None:
        for e in events:
            if e.kind == "fail":
                self.ready[e.node] = False
            elif e.kind == "recover":
                self.ready[e.node] = True
            elif e.kind == "delete":
                self.present[e.node] = False
            elif e.kind == "add":
                self.present[e.node] = True
                # parity with apply_churn_to_wire, which re-adds the node
                # ready=True: a fail->delete->add sequence must converge to
                # the same state on both sides or the stack runner's churn
                # barrier never settles
                self.ready[e.node] = True
            else:
                raise ValueError(f"unknown churn kind {e.kind!r}")

    def place(self, pod: SimPod, node: str) -> None:
        self.pod_count[node] += 1
        self.cpu_alloc[node] += pod.cpu_m / 1000.0
        self.mem_alloc[node] += pod.mem_mi / 1024.0

    def live_nodes(self) -> list[SimNode]:
        return [n for name, n in self._base.items() if self.present[name]]

    def metrics(self) -> list[NodeMetrics]:
        """The snapshot a decision would see (informer synthesis parity)."""
        out = []
        for name, node in self._base.items():
            if not self.present[name]:
                continue
            count = self.pod_count[name]
            synth = (count / node.max_pods) * 50.0 if node.max_pods else 0.0
            out.append(
                NodeMetrics(
                    name=name,
                    cpu_usage_percent=synth,
                    memory_usage_percent=synth,
                    available_cpu_cores=node.cpu_cores,
                    available_memory_gb=node.memory_gb,
                    pod_count=count,
                    max_pods=node.max_pods,
                    labels=dict(node.labels),
                    taints=node.taints,
                    conditions={
                        "Ready": "True" if self.ready[name] else "False"
                    },
                )
            )
        return out


# ------------------------------------------------------------ wire plumbing
def apply_topology(scenario: Scenario, wire) -> None:
    """Install the scenario's nodes into a WireFakeK8s — quantity strings
    exactly as an API server would serve them."""
    for n in scenario.nodes:
        wire.add_node(
            n.name,
            cpu=_cpu_str(n.cpu_cores),
            memory=f"{int(n.memory_gb * 1024)}Mi",
            pods=str(n.max_pods),
            labels=n.labels,
            taints=list(n.taints),
            ready=n.ready,
        )


def add_pod_to_wire(pod: SimPod, wire) -> None:
    from k8s_llm_scheduler_tpu_torch.cluster.wire_fake import node_affinity_wire

    affinity = (
        node_affinity_wire([list(t) for t in pod.affinity_terms])
        if pod.affinity_terms
        else None
    )
    wire.add_pod(
        pod.name,
        scheduler_name=SCHEDULER_NAME,
        requests={"cpu": f"{pod.cpu_m}m", "memory": f"{pod.mem_mi}Mi"},
        node_selector=pod.node_selector,
        tolerations=list(pod.tolerations),
        affinity=affinity,
        priority=pod.priority,
    )


def apply_churn_to_wire(scenario: Scenario, events: Sequence[ChurnEvent],
                        wire) -> None:
    by_name = {n.name: n for n in scenario.nodes}
    for e in events:
        if e.kind == "fail":
            wire.set_node_ready(e.node, False)
        elif e.kind == "recover":
            wire.set_node_ready(e.node, True)
        elif e.kind == "delete":
            wire.delete_node(e.node)
        elif e.kind == "add":
            n = by_name[e.node]
            wire.add_node(
                n.name, cpu=_cpu_str(n.cpu_cores),
                memory=f"{int(n.memory_gb * 1024)}Mi",
                pods=str(n.max_pods), labels=n.labels,
                taints=list(n.taints), ready=True,
            )
        else:
            raise ValueError(f"unknown churn kind {e.kind!r}")


def _cpu_str(cores: float) -> str:
    return str(int(cores)) if float(cores).is_integer() else f"{int(cores * 1000)}m"
