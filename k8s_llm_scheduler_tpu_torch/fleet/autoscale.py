"""SLO-burn-driven elastic fleet autoscaler (ROADMAP item 4).

The serving plane survives nine chaos regimes and self-improves its
policy, but through PR 11 it still "runs at N replicas" instead of
"serving the traffic": a diurnal 10x swing either burns money at peak
provisioning or burns the SLO budget. Every control input already
exists — the SLO engine's fast/slow burn windows (observability/slo.py),
the profiler's `queue_stall` segment (admission starvation, the
SARATHI-style pressure signal), merged fleet percentiles
(observability/fleetview.FleetAggregator), and pool occupancy
(fleet/pools.DisaggregatedBackend). This module closes the loop.

Control shape — a DEADBAND loop, robustness first:

- **pressure** is the max of normalized demand signals: queue depth per
  replica against the per-replica target, the SLO burn (only when BOTH
  windows exceed 1x — the multi-window discipline that keeps a blip
  from scaling the fleet), decide-p99 against an optional latency
  target, and profiler queue_stall beyond its budget. Max, not sum: any
  single starved dimension is a real capacity shortfall, and summing
  would let three healthy signals dilute one burning one.
- **hysteresis band**: no action while pressure sits inside
  [down_threshold, up_threshold]. Desired size re-targets
  `target_utilization` (below the up threshold), so the system lands
  INSIDE the band after a scale event and is stable there — flapping
  load at the threshold cannot produce one event per oscillation.
- **per-direction cooldowns**: scale-up needs `up_cooldown_s` since the
  last scale-up; scale-down needs `down_cooldown_s` since the last
  scale event of EITHER direction (an up immediately followed by a
  down is the thrash signature; the asymmetry keeps emergency up-scales
  fast while down-scales stay deliberate).
- **max-step clamp + [min, max] replica clamp**, and one scale
  OPERATION per tick regardless of the clamp — joins and drains are
  staggered (rollout/-style sequencing), so no wave observes a
  membership cliff.
- **health-gated join with rollback**: a new replica is admitted only
  after the dial/prewarm probe passes AND it claims its first lease
  (Fleet.start_join/complete_join); a join that fails or stalls past
  `join_budget_ticks` rolls back completely (abort_join), retries are
  BOUNDED (`max_join_retries`) with a tick-counted backoff, and the
  retry budget re-arms once the pressure that wanted the replica has
  dropped back to or below the up threshold.
- **drain-before-release scale-down**: removal rides
  Fleet.remove_replica — in-flight decisions complete their binds
  before leases release, survivors' fair-share claims converge on the
  freed shards (proven under chaos since PR 8), sockets tear down last.

The second output is the prefill<->decode POOL SPLIT
(fleet/pools.DisaggregatedBackend.set_split): when admission occupancy
dominates decode occupancy past its own deadband, members move to the
prefill pool (and back), on a separate cooldown.

Everything here runs on an INJECTED clock and is tick-driven — no
sleeps, no wall-time judgments — so the chaos harness drives the whole
loop in virtual wave time and byte-replays it (graftlint `resilience`
family clean by construction).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable

from k8s_llm_scheduler_tpu_torch.fleet.frontend import Fleet, JoinError, PendingJoin

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """The control loop's knobs (config.yaml `autoscale` block)."""

    min_replicas: int = 1
    max_replicas: int = 8
    # demand normalization: work units (queued decisions) one replica
    # serves per tick at target utilization
    target_per_replica: float = 8.0
    # post-scale utilization the desired size re-targets — must sit
    # INSIDE the deadband or scale events would not converge
    target_utilization: float = 0.75
    up_threshold: float = 1.0
    down_threshold: float = 0.5
    max_step: int = 2
    up_cooldown_s: float = 30.0
    down_cooldown_s: float = 120.0
    # health gate: ticks a pending join may wait for its first lease
    # claim before rollback, backoff ticks between attempts, and the
    # bounded retry budget (re-armed when pressure leaves the band)
    join_budget_ticks: int = 8
    join_backoff_ticks: int = 4
    max_join_retries: int = 3
    # optional latency pressure: decide p99 (merged fleet buckets)
    # against this target; None disables the term
    latency_target_ms: float | None = None
    # queue_stall fraction of wave wall time above which admission
    # counts as starved (profiler segment; SARATHI pressure)
    stall_budget: float = 0.25
    # prefill<->decode pool split control (None pools backend disables)
    split_enabled: bool = True
    split_cooldown_s: float = 60.0

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if not self.down_threshold < self.target_utilization <= self.up_threshold:
            raise ValueError(
                "need down_threshold < target_utilization <= up_threshold "
                f"(got {self.down_threshold} / {self.target_utilization} / "
                f"{self.up_threshold}) — the desired size must land inside "
                "the deadband or scale events cannot converge"
            )
        if self.max_step < 1:
            raise ValueError("max_step must be >= 1")

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "AutoscaleConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known - {"enabled", "tick_interval_s"}
        if unknown:
            raise ValueError(
                f"autoscale config: unknown keys {sorted(unknown)} "
                f"(known: {sorted(known)})"
            )
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class AutoscaleSignals:
    """One tick's control inputs, already reduced to scalars."""

    queue_depth: float = 0.0        # decisions waiting (admission queue)
    slo_fast_burn: float = 0.0      # max fast-window burn across objectives
    slo_slow_burn: float = 0.0
    decide_p99_ms: float | None = None   # merged fleet percentile
    bind_p99_ms: float | None = None
    queue_stall_frac: float = 0.0   # profiler segment fraction
    prefill_occupancy: float = 0.0  # mean in-flight per pool member
    decode_occupancy: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class AutoscalePolicy:
    """The PURE decision function: (n, signals) -> pressure -> desired
    size. No clocks, no side effects — unit-testable arithmetic; the
    controller owns cooldowns and sequencing."""

    def __init__(self, cfg: AutoscaleConfig) -> None:
        self.cfg = cfg

    def pressure(self, n_replicas: int, sig: AutoscaleSignals) -> float:
        cfg = self.cfg
        n = max(1, n_replicas)
        parts = [sig.queue_depth / (cfg.target_per_replica * n)]
        if sig.slo_fast_burn > 1.0 and sig.slo_slow_burn > 1.0:
            # both windows burning: the budget is genuinely draining —
            # the burn magnitude (bounded by the fast window) says how
            # underprovisioned we are
            parts.append(min(sig.slo_fast_burn, sig.slo_slow_burn))
        if cfg.latency_target_ms and sig.decide_p99_ms:
            parts.append(sig.decide_p99_ms / cfg.latency_target_ms)
        if sig.queue_stall_frac > cfg.stall_budget:
            # admission starvation past budget reads as proportional
            # overload (stall_frac 2x the budget ~ 2x pressure)
            parts.append(sig.queue_stall_frac / cfg.stall_budget)
        return max(parts)

    def desired(self, n_replicas: int, pressure: float) -> int:
        """Deadband + re-target + step clamp + [min, max] clamp."""
        cfg = self.cfg
        clamped_now = min(max(n_replicas, cfg.min_replicas), cfg.max_replicas)
        if cfg.down_threshold <= pressure <= cfg.up_threshold:
            return clamped_now  # hold (hysteresis band)
        want = math.ceil(
            n_replicas * pressure / cfg.target_utilization
        ) if pressure > 0 else cfg.min_replicas
        if want > n_replicas:
            want = min(want, n_replicas + cfg.max_step)
        else:
            want = max(want, n_replicas - cfg.max_step)
        return min(max(want, cfg.min_replicas), cfg.max_replicas)


class AutoscaleController:
    """The tick-driven closed loop over an elastic Fleet.

    `tick()` is the whole protocol (deterministic given the injected
    clock and the signal providers): gather signals, progress any
    pending health-gated join, run the policy, apply AT MOST ONE scale
    operation, rebalance the pool split. Owners drive it — `cli run`
    from the SLO ticker cadence, the chaos harness once per wave in
    virtual time, the bench once per arrival wave.
    """

    def __init__(
        self,
        fleet: Fleet,
        cfg: AutoscaleConfig,
        *,
        queue_depth_fn: Callable[[], float] | None = None,
        slo_engine: Any = None,
        aggregator: Any = None,
        profiler: Any = None,
        pools: Any = None,
        clock: Callable[[], float] = time.monotonic,
        on_scale: Callable[[int, int, int], None] | None = None,
        event_limit: int = 4096,
    ) -> None:
        self.fleet = fleet
        self.cfg = cfg
        self.policy = AutoscalePolicy(cfg)
        self._queue_depth_fn = queue_depth_fn
        self._slo = slo_engine
        self._agg = aggregator
        self._profiler = profiler
        self._pools = pools
        self._clock = clock
        # invariant hook (chaos/invariants.py note_scale): fires after
        # every tick with (n_replicas, min, max)
        self.on_scale = on_scale
        self._event_limit = int(event_limit)
        self.tick_no = 0
        self.last_pressure = 0.0
        self._pending: PendingJoin | None = None
        self._join_retries = 0
        self._backoff_until_tick = 0
        self._last_up_t: float | None = None
        self._last_event_t: float | None = None
        self._last_split_t: float | None = None
        self.counters = {
            "ticks": 0,
            "scale_ups": 0,
            "scale_downs": 0,
            "holds": 0,
            "join_failures": 0,
            "split_changes": 0,
        }
        self.events: list[dict] = []

    # --------------------------------------------------------------- inputs
    def gather(self) -> AutoscaleSignals:
        sig = AutoscaleSignals()
        if self._queue_depth_fn is not None:
            sig.queue_depth = float(self._queue_depth_fn())
        if self._slo is not None:
            fast = slow = 0.0
            for detail in self._slo.snapshot().get("objectives", {}).values():
                if detail.get("fast"):
                    fast = max(fast, float(detail["fast"].get("burn", 0.0)))
                if detail.get("slow"):
                    slow = max(slow, float(detail["slow"].get("burn", 0.0)))
            sig.slo_fast_burn, sig.slo_slow_burn = fast, slow
        if self._agg is not None:
            decide = self._agg.fleet_percentiles("decide")
            if decide:
                sig.decide_p99_ms = float(decide["p99_ms"])
            bind = self._agg.fleet_percentiles("bind")
            if bind:
                sig.bind_p99_ms = float(bind["p99_ms"])
        if self._profiler is not None:
            sig.queue_stall_frac = float(
                self._profiler.gauges().get("queue_stall_frac", 0.0)
            )
        if self._pools is not None:
            occ = self._pools.occupancy()
            sig.prefill_occupancy = occ.get("prefill", 0.0)
            sig.decode_occupancy = occ.get("decode", 0.0)
        return sig

    # ------------------------------------------------------------- cooldowns
    def _up_allowed(self, now: float) -> bool:
        return (
            self._last_up_t is None
            or now - self._last_up_t >= self.cfg.up_cooldown_s
        )

    def _down_allowed(self, now: float) -> bool:
        return (
            self._last_event_t is None
            or now - self._last_event_t >= self.cfg.down_cooldown_s
        )

    def _note(self, action: str, n_from: int, n_to: int, pressure: float,
              detail: str = "") -> dict:
        event = {
            "tick": self.tick_no,
            "action": action,
            "n_from": n_from,
            "n_to": n_to,
            "pressure": round(pressure, 6),
        }
        if detail:
            event["detail"] = detail
        self.events.append(event)
        if len(self.events) > self._event_limit:
            del self.events[: len(self.events) - self._event_limit]
        return event

    # ----------------------------------------------------------------- tick
    async def tick(self) -> dict:
        """One control iteration; returns the tick record."""
        self.tick_no += 1
        self.counters["ticks"] += 1
        now = self._clock()
        sig = self.gather()
        n = self.fleet.n_live
        pressure = self.policy.pressure(n, sig)
        self.last_pressure = pressure

        record: dict
        if self._pending is not None:
            record = await self._progress_join(now, pressure)
        else:
            record = await self._steer(now, n, pressure)

        if pressure <= self.cfg.up_threshold:
            # the demand that wanted a replica has cleared (anywhere at
            # or below the up threshold — a trough counts): re-arm the
            # bounded join-retry budget for the NEXT excursion. Gating
            # this on the band interior would permanently lock out
            # scale-ups for a load that flaps heavy/light without ever
            # settling inside the band.
            self._join_retries = 0

        if self.on_scale is not None:
            self.on_scale(
                self.fleet.n_live, self.cfg.min_replicas,
                self.cfg.max_replicas,
            )
        self._steer_split(now)
        record["signals"] = sig.to_dict()
        return record

    async def _progress_join(self, now: float, pressure: float) -> dict:
        """Advance the pending health-gated join (staggered: nothing
        else scales while a join is open)."""
        join = self._pending
        assert join is not None
        n = self.fleet.n_live
        if not join.dead and await self.fleet.complete_join(join):
            self._pending = None
            self._join_retries = 0
            self._last_up_t = self._last_event_t = now
            self.counters["scale_ups"] += 1
            logger.info(
                "autoscale: %s admitted (gate complete, %d replicas)",
                join.replica.holder, n,
            )
            return self._note("join_admitted", n, n, pressure)
        if join.dead or join.ticks_waited >= self.cfg.join_budget_ticks:
            await self.fleet.abort_join(join)
            self._pending = None
            self._join_retries += 1
            self._backoff_until_tick = (
                self.tick_no + self.cfg.join_backoff_ticks
            )
            self.counters["join_failures"] += 1
            logger.warning(
                "autoscale: join of %s rolled back (%s; retry %d/%d)",
                join.replica.holder,
                "died mid-gate" if join.dead else "gate budget exhausted",
                self._join_retries, self.cfg.max_join_retries,
            )
            return self._note(
                "join_rolled_back", n, self.fleet.n_live, pressure,
                detail="dead" if join.dead else "budget",
            )
        return self._note("join_pending", n, n, pressure)

    async def _steer(self, now: float, n: int, pressure: float) -> dict:
        want = self.policy.desired(n, pressure)
        if want > n:
            if not self._up_allowed(now):
                return self._note("hold", n, n, pressure, detail="up_cooldown")
            if self._join_retries >= self.cfg.max_join_retries:
                return self._note(
                    "hold", n, n, pressure, detail="join_retries_exhausted"
                )
            if self.tick_no < self._backoff_until_tick:
                return self._note(
                    "hold", n, n, pressure, detail="join_backoff"
                )
            try:
                self._pending = await self.fleet.start_join()
            except JoinError as exc:
                self._join_retries += 1
                self._backoff_until_tick = (
                    self.tick_no + self.cfg.join_backoff_ticks
                )
                self.counters["join_failures"] += 1
                logger.warning("autoscale: join failed at start: %s", exc)
                return self._note(
                    "join_failed", n, n, pressure, detail=str(exc)
                )
            return self._note("join_started", n, n + 1, pressure)
        if want < n:
            if not self._down_allowed(now):
                return self._note(
                    "hold", n, n, pressure, detail="down_cooldown"
                )
            victim = self.fleet.pick_removal()
            await self.fleet.remove_replica(victim)
            self._last_event_t = now
            self.counters["scale_downs"] += 1
            logger.info(
                "autoscale: drained %s (%d -> %d replicas)",
                victim.holder, n, n - 1,
            )
            return self._note("scale_down", n, n - 1, pressure)
        self.counters["holds"] += 1
        return self._note("hold", n, n, pressure)

    # ------------------------------------------------------------ pool split
    def _steer_split(self, now: float) -> None:
        """Output #2: move pool members toward the occupancy ratio, on
        its own deadband + cooldown. Admission-heavy ticks grow the
        prefill pool; decode-heavy ticks shrink it back."""
        pools = self._pools
        if pools is None or not self.cfg.split_enabled:
            return
        if (
            self._last_split_t is not None
            and now - self._last_split_t < self.cfg.split_cooldown_s
        ):
            return
        occ = pools.occupancy()
        total_members = len(pools.prefill_pool) + len(pools.decode_pool)
        if total_members < 2 or not pools.decode_pool:
            return  # nothing to split (or already a pure prefill fleet)
        load = occ["prefill"] + occ["decode"]
        if load <= 0:
            return
        share = occ["prefill"] / load
        split_for_share = getattr(pools, "split_for_share", None)
        if split_for_share is not None:
            # Device-weighted on heterogeneous fleets (engine/sharded
            # slice geometry): the share buys whole tp groups' worth of
            # chips, and the split lands on a device-group boundary
            # instead of treating a tp=8 slice as one unit of capacity.
            want_prefill = min(
                max(1, int(split_for_share(share))), total_members - 1
            )
        else:
            want_prefill = min(
                max(1, round(total_members * share)), total_members - 1
            )
        if want_prefill == len(pools.prefill_pool):
            return
        split = pools.set_split(want_prefill)
        self._last_split_t = now
        self.counters["split_changes"] += 1
        logger.info("autoscale: pool split rebalanced to %s", split)

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        """The `autoscale` subtree of the fleet stats tree (rendered as
        llm_scheduler_autoscale_* gauges)."""
        return {
            **self.counters,
            "replicas": self.fleet.n_live,
            "min_replicas": self.cfg.min_replicas,
            "max_replicas": self.cfg.max_replicas,
            "pressure": round(self.last_pressure, 6),
            "join_pending": self._pending is not None,
            "join_retries": self._join_retries,
        }

    def scale_events(self) -> list[dict]:
        """Membership-changing events only (the chaos trace's
        deterministic scale record; holds and pending-gate ticks are
        cadence noise)."""
        return [
            e for e in self.events
            if e["action"] not in ("hold", "join_pending")
        ]


def from_config(
    fleet: Fleet, autoscale_cfg: dict[str, Any], **providers: Any
) -> AutoscaleController | None:
    """Build a controller from the config `autoscale` block (None when
    disabled)."""
    if not autoscale_cfg or not autoscale_cfg.get("enabled"):
        return None
    cfg = AutoscaleConfig.from_dict(autoscale_cfg)
    return AutoscaleController(fleet, cfg, **providers)
