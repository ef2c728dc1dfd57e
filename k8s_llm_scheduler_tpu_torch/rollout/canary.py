"""Promotion controller: arena gate -> hot swap -> burn-in -> rollback.

The full canary path for a candidate checkpoint:

1. **Gate** (offline, seeded): incumbent and candidate run END TO END as
   arena stack arms over the same seeded scenario (sim/arena.py — wire
   fake, real watch/bind, real scheduler loop). The candidate must be no
   worse than the incumbent within tolerance on the placement metrics the
   system optimizes: spread (lower better), constraint satisfaction and
   bound fraction (higher better). A fixed seed suite makes the verdict
   reproducible — a flaky gate is worse than no gate.
2. **Promote**: on pass, hot-swap the live engine (rollout/hotswap.py) and
   move the registry's active pointer. No restart, no dropped traffic.
3. **Burn-in**: watch the LIVE regression signals from Scheduler.get_stats
   deltas — fallback rate, invalid-decision rate, bind-failure rate — over
   a decision-count window. Offline gates can't see everything (real pod
   shapes, prompt drift); the burn-in can.
4. **Rollback**: any tripped signal swaps back to the prior registry
   version and marks the candidate rejected (it is not retried).

For fanout deployments (sched/replica.py), `staggered_swap` promotes one
replica at a time so the FanoutBackend always has a serving majority: each
replica's swap is verified before the next begins, and a failed swap stops
the stagger with the majority still on the incumbent.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Sequence

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class GateConfig:
    """The seeded scenario suite + tolerances for one gate run."""

    seed: int = 0
    nodes: int = 12
    pods: int = 48
    shapes: int = 8
    waves: int = 2
    constraint_mix: tuple[str, ...] = ("uniform", "selector")
    taint_frac: float = 0.0
    hetero: bool = True
    # candidate must satisfy: spread <= incumbent + spread_tolerance;
    # constraint_satisfaction >= incumbent - constraint_tolerance;
    # bound_frac >= incumbent - bound_tolerance
    spread_tolerance: float = 0.02
    constraint_tolerance: float = 0.0
    bound_tolerance: float = 0.0
    wave_timeout_s: float = 120.0


def run_gate(
    incumbent_make: Callable[[], Any],
    candidate_make: Callable[[], Any],
    gate: GateConfig | None = None,
) -> dict:
    """Run incumbent vs candidate through the seeded arena scenario and
    return the verdict: {"pass", "checks", "incumbent", "candidate",
    "seed"}. Backends built by the make() callables are owned by the arena
    (closed after the run)."""
    from k8s_llm_scheduler_tpu_torch.sim import ArmSpec, generate_scenario, run_arena
    from k8s_llm_scheduler_tpu_torch.sim.scenarios import ScenarioSpec

    gate = gate or GateConfig()
    spec = ScenarioSpec(
        name="canary-gate",
        seed=gate.seed,
        n_nodes=gate.nodes,
        n_pods=gate.pods,
        shapes=gate.shapes,
        arrival="waves",
        n_waves=gate.waves,
        constraint_mix=gate.constraint_mix,
        taint_frac=gate.taint_frac,
        hetero=gate.hetero,
    )
    scenario = generate_scenario(spec)
    report = run_arena(
        scenario,
        [
            ArmSpec(name="incumbent", kind="stack", make=incumbent_make),
            ArmSpec(name="candidate", kind="stack", make=candidate_make),
        ],
        wave_timeout_s=gate.wave_timeout_s,
    )
    inc = report["arms"]["incumbent"]["scores"]
    cand = report["arms"]["candidate"]["scores"]
    checks = {
        "spread": cand["spread"] <= inc["spread"] + gate.spread_tolerance,
        "constraint_satisfaction": (
            cand["constraint_satisfaction"]
            >= inc["constraint_satisfaction"] - gate.constraint_tolerance
        ),
        "bound_frac": (
            cand["bound_frac"] >= inc["bound_frac"] - gate.bound_tolerance
        ),
    }
    return {
        "pass": all(checks.values()),
        "checks": checks,
        "incumbent": inc,
        "candidate": cand,
        "seed": gate.seed,
        # the deterministic per-arm record (sim/trace.py shape): what the
        # learn loop's byte-compared trace embeds so a gate verdict can be
        # REPLAYED from its own placements instead of re-running two
        # backends (learn/loop.replay_learn_trace)
        "scenario_spec": spec.to_dict(),
        "traces": {
            name: {
                "placements": arm_trace["placements"],
                "unschedulable": arm_trace["unschedulable"],
                "scores": arm_trace["scores"],
            }
            for name, arm_trace in report["_traces"].items()
        },
    }


def staggered_swap(
    swap_fns: Sequence[Callable[[], Any]],
    verify: Callable[[int, Any], bool] | None = None,
    decision_cache: Any = None,
    kvplane_store: Any = None,
) -> list[Any]:
    """Run per-replica swap callables ONE AT A TIME (fanout and fleet
    deployments: the dispatch layer must always keep a serving majority
    on a consistent version). `verify(index, result)` returning False —
    or any raise — stops the stagger; replicas not yet swapped stay on
    the incumbent.

    `decision_cache` is the fleet's decision cache (typically
    fleet/cache.TieredDecisionCache over the shared L2): when every
    replica swapped successfully, its generation is bumped ONCE — one
    fleet-wide epoch, invalidating every replica's L1 and the shared L2
    coherently — instead of per-replica bumps that would leave windows
    where a not-yet-swapped replica refills the shared tier with
    old-policy decisions under the new epoch. On a stopped stagger the
    bump is withheld: the fleet is still serving the incumbent majority,
    and incumbent decisions remain valid.

    `kvplane_store` is the fleet's shared prefix-KV plane
    (fleet/kvplane/KVPlaneStore) and follows the identical
    once-on-completion discipline: its pages are prefix KV computed
    under the incumbent weights, valid for the incumbent majority during
    the stagger, and invalidated fleet-wide in ONE generation bump after
    the last replica swaps. Per-replica bumps would let a swapped
    replica republish new-weight pages while an unswapped peer still
    serves old weights — the exact mixed-epoch window the decision
    cache's single bump exists to close.

    Returns the per-replica results up to the stop point."""
    results: list[Any] = []
    completed = True
    for i, fn in enumerate(swap_fns):
        result = fn()
        results.append(result)
        if verify is not None and not verify(i, result):
            logger.warning(
                "staggered swap stopped at replica %d/%d (verify failed)",
                i + 1, len(swap_fns),
            )
            completed = False
            break
    if completed and decision_cache is not None:
        generation = decision_cache.bump_generation()
        logger.info(
            "staggered swap complete across %d replica(s); decision-cache "
            "generation bumped to %d", len(results), generation,
        )
    if completed and kvplane_store is not None:
        generation = kvplane_store.bump_generation()
        logger.info(
            "staggered swap complete; kvplane generation bumped to %d",
            generation,
        )
    return results


class CanaryController:
    """Watch the registry for candidates; gate, promote, burn in, roll back.

    Pluggable seams so the policy logic is testable without a model:
    `gate_runner(candidate_version) -> verdict dict` (defaults to run_gate
    over backend factories), `stats_provider() -> Scheduler.get_stats()`
    shape for burn-in monitoring, `clock` for deterministic tests."""

    def __init__(
        self,
        registry,
        swapper,                       # HotSwapper (or test double)
        *,
        stats_provider: Callable[[], dict] | None = None,
        gate_runner: Callable[[int], dict] | None = None,
        incumbent_factory: Callable[[], Any] | None = None,
        candidate_factory: Callable[[int], Callable[[], Any]] | None = None,
        gate: GateConfig | None = None,
        burn_in_decisions: int = 200,
        trip_fallback_rate: float = 0.2,
        trip_invalid_rate: float = 0.05,
        trip_bind_failure_rate: float = 0.05,
        trip_decide_p99_ms: float | None = None,
        slo_engine: Any = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.registry = registry
        self.swapper = swapper
        self.stats_provider = stats_provider
        self.gate = gate or GateConfig()
        if gate_runner is None:
            if incumbent_factory is None or candidate_factory is None:
                raise ValueError(
                    "CanaryController needs either gate_runner or both "
                    "incumbent_factory and candidate_factory"
                )

            def gate_runner(version: int) -> dict:
                return run_gate(
                    incumbent_factory, candidate_factory(version), self.gate
                )

        self.gate_runner = gate_runner
        self.burn_in_decisions = int(burn_in_decisions)
        self.trip_fallback_rate = float(trip_fallback_rate)
        self.trip_invalid_rate = float(trip_invalid_rate)
        self.trip_bind_failure_rate = float(trip_bind_failure_rate)
        # Optional latency trip: decide p99 over the burn-in WINDOW (from
        # PhaseRecorder histogram bucket deltas — a lifetime average would
        # dilute a fresh regression under the incumbent's history). None
        # disables; rates/percentiles are always recorded either way.
        self.trip_decide_p99_ms = (
            None if trip_decide_p99_ms is None else float(trip_decide_p99_ms)
        )
        # Optional SLO burn-rate input (observability/slo.SloEngine): a
        # tripped objective during an OPEN burn-in rolls back immediately
        # — the multiwindow burn rate is a stronger regression signal than
        # the window-count rates, and waiting out the decision count would
        # serve a burning SLO for the rest of the window.
        self.slo_engine = slo_engine
        self.clock = clock
        self.rejected: set[int] = set()
        self._burn: dict | None = None
        self.counters = {
            "gate_pass": 0,
            "gate_fail": 0,
            "promotions": 0,
            "rollbacks": 0,
        }
        self.last_gate: dict | None = None

    # ------------------------------------------------------------ baseline
    @staticmethod
    def _signals(stats: dict) -> dict[str, float]:
        client = stats.get("client", {})
        decisions = (
            stats.get("llm_decisions", 0)
            + stats.get("cache_decisions", 0)
            + stats.get("fallback_decisions", 0)
        )
        # Deadline/brownout sheds (sched/deadline.py ladder) ride the
        # fallback counter but indict the CALLER's load or an SLO burn,
        # not the candidate model — counting them would roll back a
        # healthy candidate the moment a brownout overlaps its burn-in.
        # degraded_fallbacks counts only the sheds that actually became
        # fallback DECISIONS (a shed that produced none lands in
        # `unschedulable`, and subtracting it would mask the candidate's
        # own fallbacks in the same window).
        degraded = float(client.get("degraded_fallbacks", 0))
        return {
            "decisions": float(decisions),
            "fallback": max(
                float(stats.get("fallback_decisions", 0)) - degraded, 0.0
            ),
            "invalid": float(client.get("invalid_decisions", 0)),
            "failed_bindings": float(stats.get("failed_bindings", 0)),
        }

    # ------------------------------------------------------------- promote
    def consider(self, version: int) -> dict:
        """Gate `version`; promote on pass (swap + active pointer + burn-in
        start). Returns the gate verdict augmented with the action taken."""
        verdict = dict(self.gate_runner(version))
        self.last_gate = {"version": version, **verdict}
        self.registry.record_scores(
            version, {"gate": {
                "pass": verdict["pass"], "checks": verdict["checks"],
                "candidate": verdict.get("candidate"),
            }}
        )
        if not verdict["pass"]:
            self.counters["gate_fail"] += 1
            self.rejected.add(version)
            verdict["action"] = "rejected"
            logger.info("canary gate REJECTED version %d: %s",
                        version, verdict["checks"])
            return verdict
        self.counters["gate_pass"] += 1
        prior = self.registry.active()
        try:
            swap = self.swapper.swap_to(version)
        except Exception as exc:
            # Gate passed but the swap refused (torn checkpoint, wrong
            # fingerprint, restore failure). Mark the version rejected —
            # retrying every tick would re-run the full arena gate plus a
            # restore attempt per poll period, forever, and starve newer
            # candidates behind it. The engine still serves the incumbent.
            self.rejected.add(version)
            self.registry.record_scores(
                version, {"swap_failed": str(exc)[:500]}
            )
            verdict["action"] = "swap_failed"
            verdict["error"] = str(exc)
            logger.exception(
                "gate passed but swap to version %d failed — rejected",
                version,
            )
            return verdict
        self.registry.set_active(version)
        self.counters["promotions"] += 1
        baseline = phases_baseline = None
        if self.stats_provider is not None:
            stats_now = self.stats_provider()
            baseline = self._signals(stats_now)
            # phases snapshot at promotion: burn-in latency percentiles
            # come from HISTOGRAM DELTAS against this (only the window's
            # own decisions, not lifetime averages)
            phases_baseline = stats_now.get("phases", {})
        self._burn = {
            "version": version,
            "prior": prior,
            "started": self.clock(),
            "baseline": baseline,
            "phases_baseline": phases_baseline,
        }
        verdict["action"] = "promoted"
        verdict["swap"] = swap
        logger.info(
            "canary gate PASSED version %d — promoted (pause %.1f ms)",
            version, swap.get("pause_s", 0.0) * 1000.0,
        )
        return verdict

    # ------------------------------------------------------------- burn-in
    def observe_burn_in(self) -> str | None:
        """Progress the burn-in window. Returns None (no burn-in / still
        collecting), "ok" (survived — burn-in closed), or "rolled_back"."""
        if self._burn is None or self.stats_provider is None:
            return None
        baseline = self._burn["baseline"]
        if baseline is None:
            self._burn = None
            return "ok"
        if self.slo_engine is not None:
            # SLO burn-rate trip during an open burn-in: roll back NOW —
            # no waiting for the decision-count window to fill while a
            # declared objective burns (observability/slo.py).
            slo_tripped = self.slo_engine.tripped()
            if slo_tripped:
                return self._roll_back(
                    tripped=[f"slo:{name}" for name in slo_tripped],
                    rates={"slo_tripped": slo_tripped},
                )
        now_stats = self.stats_provider()
        now_sig = self._signals(now_stats)
        delta_n = now_sig["decisions"] - baseline["decisions"]
        if delta_n < self.burn_in_decisions:
            return None
        rates = {
            "fallback_rate": (now_sig["fallback"] - baseline["fallback"]) / delta_n,
            "invalid_rate": (now_sig["invalid"] - baseline["invalid"]) / delta_n,
            "bind_failure_rate": (
                now_sig["failed_bindings"] - baseline["failed_bindings"]
            ) / delta_n,
        }
        # Window latency percentiles (histogram bucket deltas vs the
        # promotion-time snapshot): recorded always, tripping only when a
        # trip_decide_p99_ms budget is configured.
        from k8s_llm_scheduler_tpu_torch.observability.trace import (
            delta_hist,
            hist_percentiles,
        )

        phases_base = self._burn.get("phases_baseline") or {}
        dh = delta_hist(
            phases_base.get("decide"),
            now_stats.get("phases", {}).get("decide"),
        )
        if dh and dh["count"]:
            p50, p95, p99 = hist_percentiles(dh["counts"])
            rates["decide_p50_ms"] = round(p50, 3)
            rates["decide_p95_ms"] = round(p95, 3)
            rates["decide_p99_ms"] = round(p99, 3)
        trips = {
            "fallback_rate": rates["fallback_rate"] > self.trip_fallback_rate,
            "invalid_rate": rates["invalid_rate"] > self.trip_invalid_rate,
            "bind_failure_rate": (
                rates["bind_failure_rate"] > self.trip_bind_failure_rate
            ),
        }
        if (
            self.trip_decide_p99_ms is not None
            and "decide_p99_ms" in rates
        ):
            # The percentile estimate is the UPPER bound of a 2x-spaced
            # bucket (observability/trace.hist_percentiles), so the true
            # p99 lies in (est/2, est]. Trip on the LOWER bound: est/2 >
            # budget guarantees the true p99 exceeded it — comparing the
            # upper bound directly would spuriously roll back healthy
            # candidates whose true p99 sits at ~half the budget.
            trips["decide_p99_ms"] = (
                rates["decide_p99_ms"] / 2.0 > self.trip_decide_p99_ms
            )
        if any(trips.values()):
            return self._roll_back(
                tripped=sorted(k for k, v in trips.items() if v),
                rates=rates,
            )
        version = self._burn["version"]
        self._burn = None
        self.registry.record_scores(
            version, {"burn_in": {"tripped": [], "rates": rates}}
        )
        logger.info("burn-in OK for version %d (rates %s)", version, rates)
        return "ok"

    def _roll_back(self, tripped: list, rates: dict) -> str:
        """Close the open burn-in as TRIPPED: reject the candidate, swap
        back to the prior version, bump counters. Shared by the window
        rate trips and the SLO burn-rate early trip."""
        version = self._burn["version"]
        prior = self._burn["prior"]
        self._burn = None
        logger.warning(
            "burn-in TRIPPED for version %d (%s; rates %s) — rolling "
            "back to %s", version, tripped, rates, prior,
        )
        self.rejected.add(version)
        self.registry.record_scores(
            version, {"burn_in": {"tripped": tripped, "rates": rates}}
        )
        if prior is not None:
            self.swapper.swap_to(prior)
            self.registry.set_active(prior)
        self.counters["rollbacks"] += 1
        return "rolled_back"

    # ----------------------------------------------------------------- tick
    def tick(self) -> dict | str | None:
        """One controller step: finish an open burn-in first, else gate the
        newest un-rejected candidate above the active version."""
        if self._burn is not None:
            return self.observe_burn_in()
        active = self.registry.active() or 0
        candidates = [
            v for v in self.registry.versions()
            if v > active and v not in self.rejected
        ]
        if not candidates:
            return None
        return self.consider(candidates[-1])

    def pinned_versions(self) -> set[int]:
        """Versions the registry's retention walk must not evict on this
        controller's account: the OPEN burn-in candidate and its rollback
        target. Mid burn-in the candidate IS the active version, but its
        prior may sit outside the keep-last window — evicting it turns
        the next rollback into a RegistryError (rollout/registry.retain's
        pinned set exists for exactly this and the incident-corpus
        lineage case)."""
        pinned: set[int] = set()
        if self._burn is not None:
            pinned.add(int(self._burn["version"]))
            if self._burn["prior"] is not None:
                pinned.add(int(self._burn["prior"]))
        return pinned

    def stats(self) -> dict:
        out = {
            **self.counters,
            "active_version": self.registry.active(),
            "burn_in_open": self._burn is not None,
            "rejected": sorted(self.rejected),
        }
        if self._burn is not None:
            out["candidate_version"] = self._burn["version"]
        if self.last_gate is not None:
            out["last_gate_version"] = self.last_gate["version"]
            out["last_gate_pass"] = bool(self.last_gate["pass"])
        if hasattr(self.swapper, "stats"):
            out["swap"] = self.swapper.stats()
        return out
