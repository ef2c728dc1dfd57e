"""Seeded, deterministic fault injection.

Design constraints, in order:

1. **Determinism.** The whole point of a chaos *plane* (vs. a chaos
   monkey) is that a failing run is a reproducible artifact. Faults are
   therefore scheduled in VIRTUAL TIME — the wave index of the harness's
   wave-barriered run — as WINDOWS, not as per-call coin flips: every
   operation that crosses a seam during an active window receives the
   same treatment, and partial faults (`fraction` < 1) select their
   victims by a stable hash of the operation's key (pod name, holder
   id), never by RNG draw order. Thread interleaving inside a wave can
   then vary freely without changing which pods were faulted.
2. **Real seams.** Faults fire at layer boundaries the production code
   already owns — the replica wire (sched/replica.py), the lease store
   (fleet/lease.py), the kube watch as served by the wire-level fake API
   server (cluster/wire_fake.py, driving the REAL cluster/kube.py +
   httpapi.py handling), the decision backend, and the fleet's shared L2
   cache (fleet/cache.py). Production objects carry an optional
   `fault_seam` attribute (None in every real deployment: one attribute
   read per boundary crossing, no chaos imports).
3. **One schedule object.** A `FaultPlan` is generated from (regime,
   seed, n_waves) by a named builder, serializes canonically, and is
   embedded in the chaos trace — replay regenerates it from the seed and
   byte-compares.

Seams and their fault kinds:

====== ==========================================================
seam   kinds
====== ==========================================================
wire   reset (connection reset mid-decision), drop (frame never
       sent — caller times out), delay (params: delay_ms), dup
       (frame sent twice — response idempotency)
lease  lost_renewal (renewal silently not applied; params: holder),
       partition (store unreachable for holder; params: holder),
       clock_skew (holder's mutations judged at now+skew_s;
       params: holder, skew_s)
watch  gone_410 (in-stream 410 Gone mid-burst), api_5xx (list/watch
       answered 500), stale_event (backlog event re-delivered)
backend error (device failure), slow (params: delay_ms), malformed
       (decision names a node that does not exist — drives the
       validate_decision defense)
cache  l2_down (shared L2 unavailable: reads miss, writes are
       L1-only, generation authority unreachable)
slo    brownout (harness-interpreted: the SLO burn-rate trip is
       simulated by entering the DecisionClient's brownout mode
       for the window — the on_trip wiring `cli run` installs)
====== ==========================================================
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from collections import Counter
from typing import Any, Callable, Sequence

SEAMS = (
    "wire", "lease", "watch", "backend", "cache", "slo", "swap", "scale",
    "process", "kvplane", "persistent",
)

FAULT_KINDS: dict[str, tuple[str, ...]] = {
    "wire": ("reset", "drop", "delay", "dup"),
    "lease": ("lost_renewal", "partition", "clock_skew"),
    "watch": ("gone_410", "api_5xx", "stale_event"),
    "backend": ("error", "slow", "malformed"),
    "cache": ("l2_down",),
    "slo": ("brownout",),
    # harness-interpreted: an identical-policy hot swap at the window's
    # first wave boundary (decision-cache generation bump + an OPEN
    # canary burn-in over the live scheduler stats — the promotion shape
    # the learn loop performs; chaos/harness.py)
    "swap": ("hot_swap",),
    # elastic-fleet scale events (fleet/autoscale.py + fleet/frontend.py
    # Fleet.fault_seam): `join_fail` kills a joining replica at the
    # dial/prewarm probe, `gate_stall` kills it mid-health-gate (after
    # the probe, before any heartbeat — the controller rolls the
    # observed death back on its next tick),
    # `drain_race` is harness-interpreted (a replica CRASHES — leases
    # lingering to TTL — while the controller's scale-down drain is
    # converging), and `thrash` marks the flapping-arrival window
    # (workload-shaped; the marker makes the window visible in the
    # injection report).
    "scale": ("thrash", "join_fail", "gate_stall", "drain_race"),
    # cold process death (sched/recovery.JournaledBinder crash_seam +
    # the crash harness mode): `crash` drops the replica at the lifecycle
    # point named by params["point"] (post_decide / mid_bind / post_bind
    # — sched/recovery.CRASH_POINTS), `crash_recovery` kills it AGAIN
    # mid-recovery (recovery must be re-entrant), and `torn_tail` is
    # harness-interpreted: the journal's last record is physically
    # truncated by params["bytes"] before the rebuild opens it (replay
    # must truncate the tear, never mis-parse it).
    "process": ("crash", "crash_recovery", "torn_tail"),
    # persistent serving-loop ring plane (engine/persistent/ring.py,
    # driven by chaos/harness._run_persistent_stack over the REAL rings
    # with a deterministic no-JAX stub loop thread): `ring_full` makes
    # the loop stop draining the command ring for the window (admission
    # backpressure — feeders must fall back to the dispatch path, never
    # queue unboundedly), `consumer_stall` pauses the host harvester so
    # emissions pile into the bounded token ring (zero-loss emission
    # backpressure — every token must still arrive, exactly once, after
    # the stall), and `loop_wedge` stops the loop thread beating
    # entirely so the Heartbeat watchdog must detect the wedge and kick
    # a graceful drain back to the dispatch path.
    "persistent": ("ring_full", "consumer_stall", "loop_wedge"),
    # shared prefix-KV plane (fleet/kvplane/KVPlaneStore.fault_seam):
    # `store_down` makes every store op raise (clients degrade to local
    # prefill), `fill_stall` kills the elected filler's publish
    # mid-flight WITHOUT releasing its fill lease (waiters see a held
    # lease and no pages — a dead filler — until the TTL reaps it), and
    # `stale_generation` ages a client's presented generation so its
    # adoption attempt is refused by the store's generation check.
    "kvplane": ("store_down", "fill_stall", "stale_generation"),
}


def stable_fraction(key: str) -> float:
    """Deterministic uniform-ish [0,1) value for a fault key — blake2b,
    not hash(): victim selection must agree across processes and runs."""
    digest = hashlib.blake2b(key.encode(), digest_size=4).digest()
    return int.from_bytes(digest, "big") / 2**32


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault window: [start_wave, end_wave) on one seam."""

    seam: str
    kind: str
    start_wave: int
    end_wave: int
    params: tuple[tuple[str, Any], ...] = ()

    def __post_init__(self) -> None:
        if self.seam not in FAULT_KINDS:
            raise ValueError(f"unknown seam {self.seam!r} (known: {SEAMS})")
        if self.kind not in FAULT_KINDS[self.seam]:
            raise ValueError(
                f"seam {self.seam!r} has no fault kind {self.kind!r} "
                f"(known: {FAULT_KINDS[self.seam]})"
            )
        if self.end_wave <= self.start_wave:
            raise ValueError(
                f"empty fault window [{self.start_wave}, {self.end_wave})"
            )

    def active(self, wave: int) -> bool:
        return self.start_wave <= wave < self.end_wave

    def param(self, name: str, default: Any = None) -> Any:
        for key, value in self.params:
            if key == name:
                return value
        return default

    def to_dict(self) -> dict:
        return {
            "seam": self.seam,
            "kind": self.kind,
            "start_wave": self.start_wave,
            "end_wave": self.end_wave,
            "params": {k: v for k, v in self.params},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(
            seam=d["seam"],
            kind=d["kind"],
            start_wave=int(d["start_wave"]),
            end_wave=int(d["end_wave"]),
            params=tuple(sorted((d.get("params") or {}).items())),
        )


def _ev(seam: str, kind: str, start: int, end: int, **params: Any) -> FaultEvent:
    return FaultEvent(seam, kind, start, end, tuple(sorted(params.items())))


# ------------------------------------------------------------------ regimes
# regime name -> builder(rng, n_waves, n_nodes) -> (fault events, churn
# specs). Churn rides the ScenarioSpec (sim/scenarios.ChurnEvent shape,
# returned here as dicts to avoid a circular import); fault events ride
# the FaultPlan. Builders draw ONLY from the passed rng, in a fixed
# order — the determinism contract generate() documents.
def _mid_windows(n_waves: int) -> tuple[int, int]:
    """The canonical fault window: roughly the middle third of the run,
    leaving pre-fault waves (healthy baseline) and post-fault waves
    (recovery measurement) on both sides."""
    start = max(1, n_waves // 3)
    end = max(start + 1, (2 * n_waves) // 3)
    return start, end


def _regime_node_failure(rng, n_waves: int, n_nodes: int):
    start, end = _mid_windows(n_waves)
    down = sorted(
        int(i) for i in rng.choice(n_nodes, size=max(1, n_nodes // 6),
                                   replace=False)
    )
    churn = [
        {"wave": start, "kind": "fail", "node": f"sim-node-{i:03d}"}
        for i in down
    ] + [
        {"wave": end, "kind": "recover", "node": f"sim-node-{i:03d}"}
        for i in down
    ]
    # the failing nodes take their capacity with them mid-wave while the
    # backend also turns briefly slow — the compound case ROADMAP item 5
    # names (node failure is rarely the ONLY thing going wrong)
    events = [_ev("backend", "slow", start, start + 1, delay_ms=5.0)]
    return events, churn


def _regime_autoscaler_churn(rng, n_waves: int, n_nodes: int):
    # scale-down then scale-up: delete a cohort early, re-add it later —
    # the informer and the decision prompt must track both transitions
    cohort = sorted(
        int(i) for i in rng.choice(n_nodes, size=max(1, n_nodes // 4),
                                   replace=False)
    )
    down_at = max(1, n_waves // 4)
    up_at = max(down_at + 1, (3 * n_waves) // 4)
    churn = [
        {"wave": down_at, "kind": "delete", "node": f"sim-node-{i:03d}"}
        for i in cohort
    ] + [
        {"wave": up_at, "kind": "add", "node": f"sim-node-{i:03d}"}
        for i in cohort
    ]
    # stale watch deliveries during the churn: the informer sees events
    # for nodes that were just deleted/re-added
    events = [_ev("watch", "stale_event", down_at, up_at)]
    return events, churn


def _regime_circuit_open(rng, n_waves: int, n_nodes: int):
    start, end = _mid_windows(n_waves)
    # every backend call fails for the window: retries exhaust, the
    # breaker opens, decisions shed to the heuristic rung; post-window
    # waves measure recovery through the HALF_OPEN probe
    return [_ev("backend", "error", start, end)], []


def _regime_brownout(rng, n_waves: int, n_nodes: int):
    start, end = _mid_windows(n_waves)
    return [
        # backend turns slow enough that the per-decision deadline budget
        # can no longer afford the LLM rung...
        _ev("backend", "slow", start, end, delay_ms=60.0),
        # ...while the SLO burn-rate brownout (harness-interpreted trip)
        # sheds even the decisions a slow backend could still serve
        _ev("slo", "brownout", start, end),
    ], []


def _regime_watch_410(rng, n_waves: int, n_nodes: int):
    start, end = _mid_windows(n_waves)
    events = [
        # times-bounded: compaction 410s a stream a few times mid-burst,
        # and a FLAKY apiserver 500s the first GETs of its window — an
        # uncapped whole-wave blackout would deadlock against the wave
        # barrier that is the only thing that can end the window
        _ev("watch", "gone_410", start, start + 1, times=3),
        _ev("watch", "stale_event", start, end),
    ]
    if start + 1 < end:
        events.append(
            _ev("watch", "api_5xx", start + 1, start + 2, times=6)
        )
    else:
        # one-wave window (n_waves 3-4): the 5xx shares the 410's wave
        events.append(_ev("watch", "api_5xx", start, end, times=6))
    return events, []


def _regime_wire_flaky(rng, n_waves: int, n_nodes: int):
    start, end = _mid_windows(n_waves)
    if end - start < 2:
        # one-wave window (n_waves 3-4): every fault kind shares the
        # wave — _submit_frame applies reset first for its victims, so
        # the dup/delay noise lands on the non-victim half
        return [
            _ev("wire", "reset", start, end, fraction=0.5),
            _ev("wire", "dup", start, end, fraction=0.5),
            _ev("wire", "delay", start, end, delay_ms=5.0),
        ], []
    mid = (start + end + 1) // 2
    return [
        # mid-decision connection resets for a deterministic half of the
        # pods, then dup/delay noise: the reconnect + retry + fallback
        # stack absorbs all of it or the invariant monitor says why not
        _ev("wire", "reset", start, mid, fraction=0.5),
        _ev("wire", "dup", mid, end),
        _ev("wire", "delay", mid, end, delay_ms=5.0),
    ], []


def _regime_partition(rng, n_waves: int, n_nodes: int):
    start, end = _mid_windows(n_waves)
    # the partition follows the lost renewals when the window is wide
    # enough to stage them; a one-wave window (n_waves 3-4) overlaps both
    part_start = start + 1 if start + 1 < end else start
    return [
        # replica-0 loses its renewals (silently — it believes they
        # landed) and then cannot reach the store at all: its leases
        # expire, the survivor claims them and rebinds, and replica-0's
        # straggler binds must be fenced
        _ev("lease", "lost_renewal", start, end, holder="replica-0"),
        _ev("lease", "partition", part_start, end, holder="replica-0"),
    ], []


def _regime_clock_skew(rng, n_waves: int, n_nodes: int):
    start, end = _mid_windows(n_waves)
    return [
        # replica-0's store mutations are judged several seconds in the
        # PAST (its clock runs slow): every renewal "succeeds" but only
        # extends the lease to skewed-now + ttl, which the store's own
        # clock sees expiring almost immediately — the peer claims the
        # shards under a new epoch while replica-0 still believes it
        # holds them, and epoch fencing must keep binds exactly-once
        _ev("lease", "clock_skew", start, end, holder="replica-0",
            skew_s=-4.0),
    ], []


def _regime_cache_outage(rng, n_waves: int, n_nodes: int):
    start, end = _mid_windows(n_waves)
    return [_ev("cache", "l2_down", start, end)], []


def _regime_learn_swap(rng, n_waves: int, n_nodes: int):
    start, end = _mid_windows(n_waves)
    return [
        # a hot swap lands at the window boundary and opens a canary
        # burn-in over the live stats (the learn loop's promotion step)...
        _ev("swap", "hot_swap", start, start + 1),
        # ...while an SLO brownout burns THROUGH the burn-in window: the
        # degradation ladder sheds decisions to the heuristic rung, and
        # the burn-in's fallback-rate trip must subtract those degraded
        # sheds (rollout/canary._signals) — a brownout overlapping a
        # burn-in must never roll back a healthy candidate
        _ev("slo", "brownout", start, end),
    ], []


def _regime_scale_thrash(rng, n_waves: int, n_nodes: int):
    # no seam fault at all: the WORKLOAD is the fault — arrival flaps
    # between heavy and light every wave (chaos_scenario gives scale
    # regimes their arrival shape), parking the pressure signal exactly
    # on the scale threshold. The controller's hysteresis band +
    # per-direction cooldowns must bound the oscillation: scale events
    # at most at the cooldown rate, never one per wave. The marker
    # window makes the thrash span visible in the injection report and
    # ends one wave early so the run keeps a post-fault recovery wave.
    return [_ev("scale", "thrash", 1, max(2, n_waves - 1))], []


def _regime_join_fail(rng, n_waves: int, n_nodes: int):
    # demand ramps into the windows (diurnal arrival peaks mid-run), so
    # the controller WANTS a new replica exactly while joins are dying:
    # first at the dial/prewarm probe (join_fail), then mid-health-gate
    # (gate_stall — the observed death rolls back on the next
    # controller tick). Every failure must roll back completely
    # (bounded retries, no half-joined member), and the retry once the
    # windows close — demand still above threshold on the ramp — must
    # land. Windows sit EARLY (the up-slope): that is when the
    # controller's first scale-up attempts fire.
    a = max(1, n_waves // 4)
    return [
        _ev("scale", "join_fail", a, a + 1),
        _ev("scale", "gate_stall", a + 1, a + 2),
    ], []


def _regime_drain_race(rng, n_waves: int, n_nodes: int):
    # late one-wave window on the diurnal DOWN-slope: while the
    # controller's scale-down drain is releasing the newest replica's
    # shards, the OLDEST replica crashes (no lease release — failover
    # rides TTL expiry). Two membership changes race through the lease
    # plane at once; epoch fencing + the drain-before-release ordering
    # must keep every bind exactly-once and every pod recoverable.
    start = max(1, (2 * n_waves) // 3)
    return [_ev("scale", "drain_race", start, start + 1)], []


def _regime_crash_restart(rng, n_waves: int, n_nodes: int):
    # three cold kills, one per lifecycle point, staggered across
    # consecutive waves (each `times=1`: exactly one death per window,
    # the victim is the first pod the sequential drive carries across
    # the seam that wave). post_decide leaves a decision with no intent,
    # mid_bind an intent whose bind never left, post_bind a LANDED bind
    # with no ack — the three distinct rows of the recovery decision
    # table, each proven by a full cold restart + journal replay.
    w = max(1, n_waves // 4)
    events = []
    for i, point in enumerate(("post_decide", "mid_bind", "post_bind")):
        # clamp inside the run (n_waves 3-4 stacks windows on the last
        # pre-recovery wave; distinct `point` params keep them distinct
        # events with their own times budgets)
        start = min(w + i, n_waves - 1)
        events.append(
            _ev("process", "crash", start, start + 1, point=point, times=1)
        )
    return events, []


def _regime_torn_journal(rng, n_waves: int, n_nodes: int):
    start, _end = _mid_windows(n_waves)
    # die right after the bind LANDED (ack never written), then tear the
    # journal's tail by a seeded byte count before the rebuild opens it:
    # replay must truncate the torn record, and reconciliation must
    # re-derive the lost outcome from the cluster (the pod IS bound)
    nbytes = int(rng.integers(1, 24))
    return [
        _ev("process", "crash", start, start + 1, point="post_bind",
            times=1),
        _ev("process", "torn_tail", start, start + 1, bytes=nbytes),
    ], []


def _regime_crash_during_recovery(rng, n_waves: int, n_nodes: int):
    start, end = _mid_windows(n_waves)
    return [
        # first death leaves an intent whose bind never executed...
        _ev("process", "crash", start, start + 1, point="mid_bind",
            times=1),
        # ...and the REBUILT replica dies again mid-recovery, right
        # after its first reconcile action lands — the third process
        # lifetime must finish the job from a journal that now contains
        # recovery's own partial writes (recovery is re-entrant)
        _ev("process", "crash_recovery", start, end, times=1),
    ], []


def _regime_persistent_wedge(rng, n_waves: int, n_nodes: int):
    # one-wave windows, strided two apart: ring_full first (admission
    # backpressure), then loop_wedge (watchdog drain), then
    # consumer_stall LAST. The stall must never be followed by a wedge
    # while its parked work is mid-stream — WHICH emissions rode the
    # ring before the wedge landed would be thread-timing's choice,
    # exactly what the determinism contract forbids; with the stall
    # last, the harvester simply resumes when the window closes and the
    # loop finishes serving, so every stalled request completes via the
    # ring deterministically. Narrow runs (n_waves 3-4) clamp windows
    # onto the last wave, where the wedge dominates a co-resident stall
    # and ring-full-parked commands (never taken by the paused loop)
    # drain to the fallback path with zero emissions — still
    # deterministic.
    w = max(1, n_waves // 4)
    events = []
    for i, kind in enumerate(("ring_full", "loop_wedge", "consumer_stall")):
        start = min(w + 2 * i, n_waves - 1)
        events.append(_ev("persistent", kind, start, start + 1))
    return events, []


def _regime_kv_plane_outage(rng, n_waves: int, n_nodes: int):
    start, end = _mid_windows(n_waves)
    if end - start >= 3:
        # wide window: the three failure shapes get staggered sub-windows
        # — store unreachable, then the elected filler dies mid-publish,
        # then a replica tries to adopt with an aged generation
        third = (end - start) // 3
        a, b = start + third, start + 2 * third
        return [
            _ev("kvplane", "store_down", start, max(a, start + 1)),
            _ev("kvplane", "fill_stall", max(a, start + 1),
                max(b, start + 2), holder="replica-0"),
            _ev("kvplane", "stale_generation", max(b, start + 2), end,
                holder="replica-1"),
        ], []
    # narrow window (n_waves 3-5): all three shapes share it — times
    # budgets keep each one a bounded bite so the shapes don't mask each
    # other (a down store would otherwise preempt the stall and the
    # stale adoption every wave)
    return [
        _ev("kvplane", "store_down", start, end, times=2),
        _ev("kvplane", "fill_stall", start, end, holder="replica-0",
            times=1),
        _ev("kvplane", "stale_generation", start, end, holder="replica-1",
            times=1),
    ], []


REGIMES: dict[str, dict[str, Any]] = {
    # mode: which harness stack the regime drives (chaos/harness.py) —
    # "single" = Scheduler over the wire-fake API server; "wire" =
    # single + a real ReplicaServer/ReplicaClient hop under the
    # DecisionClient; "fleet" = an in-process Fleet over the in-memory
    # cluster with manually-ticked leases and a virtual store clock.
    "node-failure": {
        "build": _regime_node_failure, "mode": "single",
        "describe": "nodes fail mid-wave and recover; backend briefly slow",
    },
    "autoscaler-churn": {
        "build": _regime_autoscaler_churn, "mode": "single",
        "describe": "autoscaler deletes then re-adds a node cohort "
                    "mid-run, with stale watch deliveries",
    },
    "circuit-open": {
        "build": _regime_circuit_open, "mode": "single",
        "describe": "backend hard-fails for a window: breaker opens, "
                    "heuristic rung serves, HALF_OPEN probe recovers",
    },
    "brownout": {
        "build": _regime_brownout, "mode": "single",
        "describe": "slow backend + SLO burn-rate brownout: the deadline "
                    "ladder sheds to fast decisions",
    },
    "watch-410": {
        "build": _regime_watch_410, "mode": "single",
        "describe": "410 Gone + API 5xx + stale events mid-burst on the "
                    "kube watch",
    },
    "wire-flaky": {
        "build": _regime_wire_flaky, "mode": "wire",
        "describe": "replica wire resets/dups/delays under a real "
                    "ReplicaServer/Client hop",
    },
    "partition": {
        "build": _regime_partition, "mode": "fleet",
        "describe": "replica-0 loses lease renewals then the store: "
                    "failover, rebind, fenced stragglers",
    },
    "clock-skew": {
        "build": _regime_clock_skew, "mode": "fleet",
        "describe": "replica-0's store clock runs 4s slow: its renewals "
                    "stop holding, epoch fencing must keep binds "
                    "exactly-once",
    },
    "cache-outage": {
        "build": _regime_cache_outage, "mode": "fleet",
        "describe": "shared L2 decision cache unavailable for a window",
    },
    "kv-plane-outage": {
        "build": _regime_kv_plane_outage, "mode": "fleet",
        "describe": "shared prefix-KV plane degrades: store unreachable, "
                    "the elected filler dies mid-publish (lease held to "
                    "TTL), and a stale-generation adoption is refused — "
                    "replicas fall back to local pins with identical KV",
    },
    "learn-swap": {
        "build": _regime_learn_swap, "mode": "single",
        "describe": "hot swap opens a canary burn-in mid-run while an "
                    "SLO brownout burns through it: the burn-in must "
                    "close clean, never roll back the healthy candidate",
    },
    # --- elastic-fleet regimes (mode "autoscale": an elastic Fleet +
    # AutoscaleController over the in-memory cluster with a virtual
    # store clock; chaos/harness._run_autoscale_stack). The `arrival`
    # key shapes the workload side (sim/scenarios.chaos_scenario).
    "scale-thrash": {
        "build": _regime_scale_thrash, "mode": "autoscale",
        "arrival": "flap",
        "describe": "arrival flaps at the scale threshold every wave: "
                    "hysteresis + cooldowns must bound oscillation "
                    "(never one scale event per wave)",
    },
    "join-fail": {
        "build": _regime_join_fail, "mode": "autoscale",
        "arrival": "diurnal",
        "describe": "joining replicas die at the dial probe, then "
                    "mid-health-gate: every failed join must roll back "
                    "completely, the post-window retry must land",
    },
    "drain-race": {
        "build": _regime_drain_race, "mode": "autoscale",
        "arrival": "diurnal",
        "describe": "a scale-down drain races a crashed replica's lease "
                    "failover: binds stay exactly-once across both "
                    "membership changes",
    },
    # --- persistent serving-loop regime (mode "persistent": the REAL
    # engine/persistent rings + Heartbeat watchdog under a
    # deterministic no-JAX stub loop thread; chaos/harness.
    # _run_persistent_stack. Each pod is one serving request whose
    # token stream — and therefore whose placement — must arrive
    # exactly once through the ring plane or the dispatch-path
    # fallback.)
    "persistent-wedge": {
        "build": _regime_persistent_wedge, "mode": "persistent",
        "describe": "serving-loop rings under fire: a full command ring "
                    "backpressures admission to the dispatch path, a "
                    "wedged loop is watchdog-drained, and a stalled "
                    "emission consumer blocks the loop without losing "
                    "or double-delivering a single token",
    },
    # --- durable-state regimes (mode "crash": one journal-backed
    # replica over a file-backed lease store, dropped COLD at seeded
    # lifecycle points and rebuilt from disk by the recovery protocol —
    # chaos/harness._run_crash_stack; the invariant monitor's bind book
    # spans every process lifetime, so exactly-once is judged ACROSS
    # restarts).
    "crash-restart": {
        "build": _regime_crash_restart, "mode": "crash",
        "describe": "cold kills at post-decide, mid-bind, and post-bind "
                    "(pre-ack); each restart replays the journal and "
                    "reconciles against the cluster without re-deciding",
    },
    "torn-journal": {
        "build": _regime_torn_journal, "mode": "crash",
        "describe": "crash after a landed bind plus a seeded torn "
                    "journal tail: replay truncates the tear, "
                    "reconciliation re-derives the outcome from the "
                    "cluster",
    },
    "crash-during-recovery": {
        "build": _regime_crash_during_recovery, "mode": "crash",
        "describe": "the rebuilt replica dies again mid-recovery: the "
                    "third process lifetime finishes reconciliation "
                    "from a journal holding recovery's partial writes",
    },
}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """The deterministic fault schedule of one chaos run."""

    regime: str
    seed: int
    n_waves: int
    events: tuple[FaultEvent, ...]
    churn: tuple[dict, ...] = ()  # ScenarioSpec churn riders (dict shape)

    @classmethod
    def generate(
        cls, regime: str, seed: int, n_waves: int, n_nodes: int = 12
    ) -> "FaultPlan":
        """One (regime, seed) -> one fully-determined plan. All draws
        come from a single np rng in a fixed order (the sim/scenarios
        discipline)."""
        import numpy as np

        try:
            builder = REGIMES[regime]["build"]
        except KeyError:
            raise ValueError(
                f"unknown chaos regime {regime!r} (known: {sorted(REGIMES)})"
            ) from None
        if n_waves < 3:
            raise ValueError("chaos plans need n_waves >= 3 "
                             "(pre-fault, fault, recovery)")
        rng = np.random.default_rng(seed)
        events, churn = builder(rng, n_waves, n_nodes)
        return cls(
            regime=regime, seed=int(seed), n_waves=int(n_waves),
            events=tuple(sorted(
                events, key=lambda e: (e.start_wave, e.seam, e.kind)
            )),
            churn=tuple(churn),
        )

    @property
    def mode(self) -> str:
        return REGIMES[self.regime]["mode"]

    def last_fault_wave(self) -> int:
        """Last wave any fault window covers (churn 'fail'/'delete'
        included) — the recovery clock starts after it."""
        last = max((e.end_wave - 1 for e in self.events), default=-1)
        for c in self.churn:
            if c["kind"] in ("fail", "delete"):
                last = max(last, int(c["wave"]))
        return last

    def to_dict(self) -> dict:
        return {
            "regime": self.regime,
            "seed": self.seed,
            "n_waves": self.n_waves,
            "events": [e.to_dict() for e in self.events],
            "churn": [dict(c) for c in self.churn],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(
            regime=d["regime"], seed=int(d["seed"]),
            n_waves=int(d["n_waves"]),
            events=tuple(FaultEvent.from_dict(e) for e in d["events"]),
            churn=tuple(dict(c) for c in d.get("churn", ())),
        )

    def digest(self) -> str:
        payload = json.dumps(
            self.to_dict(), sort_keys=True, separators=(",", ":")
        ).encode()
        return hashlib.sha256(payload).hexdigest()[:16]


class Seam:
    """One named injection point, handed to a production object as its
    `fault_seam`. Production code asks `should(kind, key=...)` at the
    boundary and interprets the returned event (or None); every fired
    fault is counted so the harness can report injection totals."""

    def __init__(self, injector: "FaultInjector", name: str) -> None:
        if name not in FAULT_KINDS:
            raise ValueError(f"unknown seam {name!r} (known: {SEAMS})")
        self.injector = injector
        self.name = name

    def active(self, kind: str | None = None) -> list[FaultEvent]:
        wave = self.injector.wave
        return [
            e for e in self.injector.plan.events
            if e.seam == self.name and e.active(wave)
            and (kind is None or e.kind == kind)
        ]

    def should(
        self, kind: str, key: str | None = None,
        where: dict | None = None,
    ) -> FaultEvent | None:
        """The active `kind` event covering `key` this wave, else None.
        Partial faults (params fraction < 1) pick victims by a stable
        hash of `key`, so the victim set is identical across runs and
        independent of call order. Events with a `times` param fire at
        most that many times over their whole window (a FLAKY seam, not
        a dead one — without the cap a whole-wave blackout deadlocks
        against the wave barrier that would advance past its window);
        which requests consume the budget is thread-order dependent, but
        `times` faults are only legal for kinds that DELAY work rather
        than redirect it, so placements stay deterministic. `where`
        filters by param equality BEFORE any budget draw — a caller
        probing for crash point="mid_bind" must not consume the budget
        of a point="post_bind" event sharing the window."""
        for event in self.active(kind):
            if where and any(
                event.param(k) != v for k, v in where.items()
            ):
                continue
            holder = event.param("holder")
            if holder is not None and key is not None and key != holder:
                continue
            fraction = float(event.param("fraction", 1.0))
            if fraction < 1.0 and key is not None:
                if stable_fraction(f"{self.name}:{kind}:{key}") >= fraction:
                    continue
            times = event.param("times")
            if times is not None and not self.injector.consume(event, int(times)):
                continue
            self.injector.note(self.name, kind, key)
            return event
        return None

    def delay_s(self, key: str | None = None) -> float:
        """Convenience for the common 'slow this operation' shape."""
        event = self.should("delay", key=key) or self.should("slow", key=key)
        return float(event.param("delay_ms", 0.0)) / 1000.0 if event else 0.0


class FaultInjector:
    """Holds the plan + the virtual clock (current wave) and hands out
    seam handles. `begin_wave` is the harness's only time control; wave
    -1 (pre-run) keeps every seam quiet so stack setup is fault-free."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self.wave = -1
        self._seams: dict[str, Seam] = {}
        self._lock = threading.Lock()
        self.injections: Counter = Counter()
        self._consumed: Counter = Counter()  # per-event `times` budgets

    def seam(self, name: str) -> Seam:
        if name not in self._seams:
            self._seams[name] = Seam(self, name)
        return self._seams[name]

    def begin_wave(self, wave: int) -> None:
        self.wave = int(wave)

    def end_run(self) -> None:
        self.wave = -1

    def note(self, seam: str, kind: str, key: str | None) -> None:
        with self._lock:
            self.injections[f"{seam}.{kind}"] += 1

    def consume(self, event: FaultEvent, times: int) -> bool:
        """Atomically draw one firing from an event's `times` budget."""
        token = (event.seam, event.kind, event.start_wave, event.end_wave)
        with self._lock:
            if self._consumed[token] >= times:
                return False
            self._consumed[token] += 1
            return True

    def injection_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(sorted(self.injections.items()))


class ChaosBackend:
    """DecisionBackend wrapper carrying the `backend` seam: slow waves,
    device failures, and malformed decisions, all key-deterministic per
    pod. Wraps ANY backend (stub, heuristic, real engine, replica
    client) — the chaos harness's default decider."""

    def __init__(
        self, inner: Any, seam: Seam,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.inner = inner
        self.seam = seam
        self._sleep = sleep

    def _pre(self, pod) -> None:
        from k8s_llm_scheduler_tpu_torch.engine.backend import BackendError

        delay = self.seam.delay_s(key=pod.name)
        if delay > 0:
            self._sleep(delay)
        if self.seam.should("error", key=pod.name) is not None:
            raise BackendError("chaos: injected device failure")

    def _post(self, pod, decision):
        if self.seam.should("malformed", key=pod.name) is not None:
            # a node name no snapshot contains: the validate_decision
            # defense (sched/client.py) must catch it and degrade
            return dataclasses.replace(
                decision, selected_node="chaos-no-such-node",
                reasoning="chaos: malformed decision",
            )
        return decision

    def get_scheduling_decision(self, pod, nodes, **kwargs):
        self._pre(pod)
        return self._post(
            pod, self.inner.get_scheduling_decision(pod, nodes, **kwargs)
        )

    async def get_scheduling_decision_async(self, pod, nodes, **kwargs):
        import asyncio

        from k8s_llm_scheduler_tpu_torch.engine.backend import BackendError

        delay = self.seam.delay_s(key=pod.name)
        if delay > 0:
            await asyncio.sleep(delay)
        if self.seam.should("error", key=pod.name) is not None:
            raise BackendError("chaos: injected device failure")
        afn = getattr(self.inner, "get_scheduling_decision_async", None)
        if afn is not None:
            decision = await afn(pod, nodes, **kwargs)
        else:
            decision = await asyncio.to_thread(
                self.inner.get_scheduling_decision, pod, nodes, **kwargs
            )
        return self._post(pod, decision)

    def get_stats(self) -> dict:
        fn = getattr(self.inner, "get_stats", None)
        return fn() if fn is not None else {}

    def close(self) -> None:
        fn = getattr(self.inner, "close", None)
        if fn is not None:
            fn()


def seams_of(events: Sequence[FaultEvent]) -> set[str]:
    return {e.seam for e in events}
