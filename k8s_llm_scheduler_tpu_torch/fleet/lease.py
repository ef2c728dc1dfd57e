"""Leased watch-space sharding — the fleet's ownership protocol.

A fleet of N scheduler replicas must partition the pending-pod watch
space so each pod is decided and bound by EXACTLY ONE replica, and so a
dead replica's share is picked up without either orphaning pods forever
or binding them twice. The protocol here is the standard lease one
(Kubernetes coordination.k8s.io Leases, etcd leases):

- the watch space is split into `n_shards` hash shards keyed on the
  pod's namespace/name (`shard_of`) — a pod's shard never changes;
- each shard is owned via a renewable lease with TTL expiry. A lease
  carries an `epoch` (fencing token) that increments on every
  acquisition, so a holder that lost its lease (expired while it was
  paused/partitioned) can detect staleness instead of acting on it;
- a dead replica simply stops renewing; after `ttl_s` its shards read
  as free and any live replica may claim them. The claimer re-lists the
  shard's still-pending pods and schedules them (fleet/frontend.py) —
  pods the dead replica already bound are no longer pending, so the
  rebind pass is idempotent, and the claimer's fenced binder refuses to
  bind pods of shards it no longer owns.

`LeaseStore` here is the in-process twin of that protocol (shared by
the fleet's replicas in tests, benches, and single-process
deployments). A multi-process deployment backs the same API with
apiserver Lease objects — one Lease per shard, `holder` =
holderIdentity, `epoch` = leaseTransitions — without touching anything
above this seam. The store is thread-safe and takes an injectable
clock so failover tests advance time instead of sleeping.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import math
import os
import threading
import time
from pathlib import Path
from typing import Callable, Iterable

logger = logging.getLogger(__name__)


def shard_of(namespace: str, name: str, n_shards: int) -> int:
    """Stable shard id for a pod identity. blake2b, not hash(): Python's
    string hash is salted per process, and two replicas MUST agree on
    every pod's shard or pods fall between filters."""
    if n_shards <= 1:
        return 0
    digest = hashlib.blake2b(
        f"{namespace}/{name}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") % n_shards


@dataclasses.dataclass
class Lease:
    shard_id: int
    holder: str
    epoch: int          # fencing token: bumps on every (re)acquisition
    expires_at: float   # store-clock deadline; renewals push it forward


class LeaseExpired(RuntimeError):
    """A renew/release was attempted on a lease the caller no longer
    holds (expired and possibly re-acquired by someone else)."""


class LeaseStoreUnavailable(RuntimeError):
    """The lease store could not be reached (chaos-injected partition; a
    k8s-backed store maps this to apiserver connectivity errors). The
    caller must treat it as a MISSED operation — which is exactly the
    failure mode TTL leases exist to survive."""


class LeaseStore:
    """Shard -> lease table with TTL expiry. All judgments use the
    injected clock; nothing here sleeps."""

    def __init__(
        self,
        n_shards: int,
        ttl_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = int(n_shards)
        self.ttl_s = float(ttl_s)
        self._clock = clock
        # Chaos seam (chaos/faults.py, seam "lease"): None in production.
        # Interpreted per MUTATING caller identity: partition (the store
        # is unreachable for that holder), lost_renewal (the renewal is
        # silently not applied — the holder believes it landed), and
        # clock_skew (the holder's mutations are judged at now+skew_s).
        self.fault_seam = None
        self._leases: dict[int, Lease] = {}
        self._epochs: dict[int, int] = {}  # survives expiry: epochs only grow
        # replica presence, independent of shard ownership: a NEWCOMER
        # holds no leases yet, but must count toward everyone's fair-
        # share target or the incumbents never shed and it starves. A
        # k8s-backed store maps this to the replica's own identity Lease.
        self._heartbeats: dict[str, float] = {}
        self._lock = threading.Lock()
        # lease-plane observability (llm_scheduler_lease_* gauges): the
        # autoscale controller and scrapers read these through the fleet
        # stats tree — monotone counters, mutated only under the lock
        self.counters: dict[str, int] = {
            "acquisitions": 0,      # fresh epochs granted (not renewals)
            "releases": 0,          # voluntary releases that landed
            "fence_checks": 0,
            "fence_rejections": 0,  # check_fence answered False
        }

    # -------------------------------------------------------- backend hook
    def _state_changed_locked(self) -> None:
        """Called at the end of every mutating operation with self._lock
        held — the ONE seam a durable backend overrides to persist. The
        in-memory default is a no-op (zero cost on the test-default
        store); FileLeaseStore writes its state file here, so both
        backends share every line of protocol logic and can only
        diverge in storage, never in semantics."""

    # ----------------------------------------------------------- chaos seam
    def _chaos_check(self, holder: str) -> None:
        """Partition gate for mutating ops: a partitioned holder's call
        never reaches the store (reads stay live — they model OTHER
        observers, and the invariant monitor uses them as the
        authority)."""
        seam = self.fault_seam
        if seam is not None and seam.should("partition", key=holder) is not None:
            raise LeaseStoreUnavailable(
                f"lease store unreachable for {holder} (chaos partition)"
            )

    def _now_for(self, holder: str) -> float:
        """The clock a holder's mutations are judged by: the store clock,
        plus any chaos-injected skew for that holder — the 'two replicas
        disagree about time' regime lease fencing must survive."""
        now = self._clock()
        seam = self.fault_seam
        if seam is not None:
            event = seam.should("clock_skew", key=holder)
            if event is not None:
                now += float(event.param("skew_s", 0.0))
        return now

    # -------------------------------------------------------------- queries
    def holder_of(self, shard_id: int) -> str | None:
        """Current unexpired holder, or None (free or expired)."""
        now = self._clock()
        with self._lock:
            lease = self._leases.get(shard_id)
            if lease is None or lease.expires_at <= now:
                return None
            return lease.holder

    def heartbeat(self, holder: str) -> None:
        """Record replica presence (TTL-expired like a lease). Managers
        heartbeat every tick, so a dead replica drops out of everyone's
        fair-share denominator after ttl_s."""
        self._chaos_check(holder)
        now = self._now_for(holder)
        with self._lock:
            self._heartbeats[holder] = now + self.ttl_s
            # opportunistic purge so the table can't grow unbounded
            # across replica generations
            dead = [h for h, t in self._heartbeats.items() if t <= now]
            for h in dead:
                del self._heartbeats[h]
            self._state_changed_locked()

    def retract_heartbeat(self, holder: str) -> None:
        """Remove a holder's presence record immediately (clean
        shutdown/scale-down). Without this the departed replica reads
        as a zero-shard STARVED peer for a full TTL, and the
        yield-to-most-starved claim rule would hold every freed shard
        unclaimed for it — pods on those shards would strand exactly as
        long. A crash does NOT retract: its heartbeat ages out with its
        leases, which is the failover path."""
        self._chaos_check(holder)
        with self._lock:
            self._heartbeats.pop(holder, None)
            self._state_changed_locked()

    def live_holders(self) -> set[str]:
        """Replicas that are PRESENT: unexpired lease holders plus
        unexpired heartbeats (a newcomer with no shards yet)."""
        now = self._clock()
        with self._lock:
            holders = {
                l.holder for l in self._leases.values() if l.expires_at > now
            }
            holders.update(
                h for h, t in self._heartbeats.items() if t > now
            )
            return holders

    def holdings(self) -> dict[str, int]:
        """Unexpired lease count per PRESENT holder (heartbeat-only
        newcomers appear at 0) — the census the fair-share shed rule
        needs to see a starved peer."""
        now = self._clock()
        with self._lock:
            out = {h: 0 for h, t in self._heartbeats.items() if t > now}
            for lease in self._leases.values():
                if lease.expires_at > now:
                    out[lease.holder] = out.get(lease.holder, 0) + 1
            return out

    def check_fence(self, shard_id: int, holder: str, epoch: int) -> bool:
        """Bind-time fencing-token check: does the store, NOW, hold an
        unexpired lease for `shard_id` by `holder` at exactly `epoch`?
        The fenced binder (fleet/frontend._FencedBinder) asks this before
        every bind, so a replica whose lease expired or was re-acquired
        (a stale fencing token) cannot land a bind — and a replica that
        cannot REACH the store to ask fails CLOSED (the
        LeaseStoreUnavailable from the partition gate propagates; the
        caller refuses the bind). Judged on the store's own clock: skew
        on the asking holder's side must not extend its authority."""
        self._chaos_check(holder)
        now = self._clock()
        with self._lock:
            lease = self._leases.get(shard_id)
            ok = (
                lease is not None
                and lease.expires_at > now
                and lease.holder == holder
                and lease.epoch == epoch
            )
            self.counters["fence_checks"] += 1
            if not ok:
                self.counters["fence_rejections"] += 1
            return ok

    def snapshot(self) -> dict[int, Lease]:
        """Copy of all UNEXPIRED leases (for /metrics and cli fleet)."""
        now = self._clock()
        with self._lock:
            return {
                sid: dataclasses.replace(lease)
                for sid, lease in self._leases.items()
                if lease.expires_at > now
            }

    # ------------------------------------------------------------ mutations
    def try_acquire(self, shard_id: int, holder: str) -> Lease | None:
        """Claim a free/expired shard (epoch bumps — a new ownership term)
        or renew one already held by `holder` (epoch unchanged). Returns
        None when another holder's lease is still live."""
        if not 0 <= shard_id < self.n_shards:
            raise ValueError(f"shard {shard_id} out of range 0..{self.n_shards - 1}")
        self._chaos_check(holder)
        now = self._now_for(holder)
        with self._lock:
            lease = self._leases.get(shard_id)
            if lease is not None and lease.expires_at > now:
                if lease.holder != holder:
                    return None
                lease.expires_at = now + self.ttl_s
                self._state_changed_locked()
                return dataclasses.replace(lease)
            epoch = self._epochs.get(shard_id, 0) + 1
            self._epochs[shard_id] = epoch
            lease = Lease(shard_id, holder, epoch, now + self.ttl_s)
            self._leases[shard_id] = lease
            self.counters["acquisitions"] += 1
            self._state_changed_locked()
            logger.debug(
                "lease: shard %d -> %s (epoch %d)", shard_id, holder, epoch
            )
            return dataclasses.replace(lease)

    def renew(self, shard_id: int, holder: str, epoch: int) -> Lease:
        """Extend a held lease. Raises LeaseExpired when the lease is
        gone, expired, or held under a different epoch — the caller must
        stop acting for this shard (its fencing token is stale)."""
        self._chaos_check(holder)
        now = self._now_for(holder)
        seam = self.fault_seam
        with self._lock:
            lease = self._leases.get(shard_id)
            if (
                lease is None
                or lease.expires_at <= now
                or lease.holder != holder
                or lease.epoch != epoch
            ):
                raise LeaseExpired(
                    f"shard {shard_id}: lease not held by {holder}@{epoch}"
                )
            if seam is not None and seam.should(
                "lost_renewal", key=holder
            ) is not None:
                # chaos: the renewal is silently NOT applied — the holder
                # walks away believing it renewed while the lease keeps
                # aging toward TTL expiry (a dropped apiserver write)
                return dataclasses.replace(lease)
            lease.expires_at = now + self.ttl_s
            self._state_changed_locked()
            return dataclasses.replace(lease)

    def release(self, shard_id: int, holder: str) -> bool:
        """Voluntary release (clean shutdown): the shard reads free
        immediately instead of after TTL."""
        self._chaos_check(holder)
        with self._lock:
            lease = self._leases.get(shard_id)
            if lease is None or lease.holder != holder:
                return False
            del self._leases[shard_id]
            self.counters["releases"] += 1
            self._state_changed_locked()
            return True

    def gauges(self) -> dict:
        """Flat lease-store view for the fleet stats tree (rendered as
        llm_scheduler_lease_* gauges by observability/metrics._flatten).
        Holder names are sanitized to metric-name-legal identifiers."""
        holdings = self.holdings()
        with self._lock:
            counters = dict(self.counters)
        leased = sum(holdings.values())
        return {
            **counters,
            "shards": self.n_shards,
            "leased_shards": leased,
            "free_shards": self.n_shards - leased,
            "live_holders": len(holdings),
            "holdings": {
                h.replace("-", "_").replace(".", "_"): n
                for h, n in sorted(holdings.items())
            },
        }


class FileLeaseStore(LeaseStore):
    """Durable LeaseStore backend: identical TTL/epoch-fencing semantics
    (every protocol line is inherited — only storage differs), persisted
    to one JSON state file with the registry's write-aside + os.replace
    + fsync discipline (rollout/registry.py) on every mutation.

    Restart semantics: epochs, leases, and heartbeats survive a process
    death, so a restarted replica re-acquiring its own unexpired lease
    RENEWS it (same epoch — its journaled bind intents stay fenced
    valid), while a lease that expired during the outage re-acquires
    under a BUMPED epoch exactly as a failover claim would. The clock
    caveat is the caller's: lease expiry is judged on the injected
    clock, so a durable deployment must inject a clock whose values
    mean the same thing across restarts (the chaos harness injects its
    virtual store clock; a production deployment maps this store to
    Kubernetes coordination.k8s.io Lease objects, where the apiserver
    owns the clock, and never reaches this file backend).

    Mutation cost: one ~1KB atomic file write under the store lock —
    the in-memory store stays the default everywhere latency matters;
    this backend exists so crash-restart tests and single-node durable
    deployments exercise the SAME semantics they would get from a
    k8s-backed store."""

    def __init__(
        self,
        path: str | Path,
        n_shards: int,
        ttl_s: float = 5.0,
        # wall clock, NOT monotonic: persisted expires_at values must
        # mean the same thing after a process restart or host reboot —
        # a monotonic deadline from a long-uptime boot would read as
        # unexpired for days on a freshly-booted host, freezing failover
        # for the dead incarnation's shards. Tests inject virtual clocks
        # as with the base store.
        clock: Callable[[], float] = time.time,
    ) -> None:
        super().__init__(n_shards, ttl_s=ttl_s, clock=clock)
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self.path.exists():
            self._load()

    def _load(self) -> None:
        with open(self.path, encoding="utf-8") as fh:
            data = json.load(fh)
        if int(data.get("n_shards", self.n_shards)) != self.n_shards:
            raise ValueError(
                f"lease store {self.path} was written for "
                f"{data.get('n_shards')} shards, not {self.n_shards}"
            )
        with self._lock:
            self._epochs = {
                int(sid): int(epoch)
                for sid, epoch in (data.get("epochs") or {}).items()
            }
            self._leases = {
                int(sid): Lease(
                    shard_id=int(sid),
                    holder=rec["holder"],
                    epoch=int(rec["epoch"]),
                    expires_at=float(rec["expires_at"]),
                )
                for sid, rec in (data.get("leases") or {}).items()
            }
            self._heartbeats = {
                h: float(t)
                for h, t in (data.get("heartbeats") or {}).items()
            }

    def _state_changed_locked(self) -> None:
        """Persist the whole (small) table atomically: write-aside,
        fsync, one os.replace — a crash mid-write leaves the previous
        state file intact, never a torn one."""
        data = {
            "n_shards": self.n_shards,
            "epochs": {str(s): e for s, e in self._epochs.items()},
            "leases": {
                str(s): {
                    "holder": l.holder,
                    "epoch": l.epoch,
                    "expires_at": l.expires_at,
                }
                for s, l in self._leases.items()
            },
            "heartbeats": dict(self._heartbeats),
        }
        tmp = self.path.with_name(self.path.name + ".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(data, fh, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)


class LeaseManager:
    """One replica's lease agent: renew what it holds, claim its fair
    share of free/expired shards, surface gains and losses.

    `tick()` is the whole protocol — deterministic, re-entrant-safe, and
    callable directly by tests (no background thread needed). `start()`
    runs it on a daemon thread every `renew_interval_s` for live
    deployments; the interval must be comfortably under the store TTL
    (the classic lease rule: renew at most every ttl/3).

    Fair share: a replica targets ceil(n_shards / live_holders) shards —
    a static target would either orphan shards (too low) or let one
    replica monopolize the space (too high). Newly observed holders push
    the target down, and a replica holding MORE than its target sheds at
    most ONE shard per tick (releases it; an under-target peer claims it
    and its rebind pass picks up any pods that arrived in the gap).
    One-per-tick keeps rebalancing gentle — a scale-up drains ownership
    over a few renew intervals instead of thrashing — and the system is
    stable at the balanced point (nobody over target, nobody sheds).
    Decisions in flight for a shed shard are fenced at bind time exactly
    like post-failover stragglers, so rebalancing cannot double-bind.

    `on_gain(shard_ids)` fires AFTER the tick holds the new leases — the
    frontend uses it to re-list and rebind the gained shards' pending
    pods. `on_loss(shard_ids)` fires when renewal discovers expiry (the
    replica was paused past TTL) so the frontend can fence itself.
    """

    def __init__(
        self,
        store: LeaseStore,
        holder: str,
        renew_interval_s: float = 1.5,
        on_gain: Callable[[frozenset[int]], None] | None = None,
        on_loss: Callable[[frozenset[int]], None] | None = None,
    ) -> None:
        self.store = store
        self.holder = holder
        self.renew_interval_s = float(renew_interval_s)
        self.on_gain = on_gain
        self.on_loss = on_loss
        self._held: dict[int, Lease] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # per-holder lease agent counters (llm_scheduler_lease_* via the
        # replica stats tree): the shed/claim churn rate is the autoscale
        # controller's view of how settled membership is
        self.counters: dict[str, int] = {
            "ticks": 0,
            "claims": 0,
            "sheds": 0,
            "losses": 0,
            "renewals": 0,
            "store_unavailable": 0,
        }

    # -------------------------------------------------------------- queries
    def owned(self) -> frozenset[int]:
        """Shards this replica currently believes it holds. The fencing
        check at bind time (fleet/frontend._FencedBinder) re-validates
        against the STORE — this local view can lag one tick behind."""
        with self._lock:
            return frozenset(self._held)

    def owns(self, shard_id: int) -> bool:
        with self._lock:
            return shard_id in self._held

    def epoch_of(self, shard_id: int) -> int | None:
        with self._lock:
            lease = self._held.get(shard_id)
            return None if lease is None else lease.epoch

    def stats(self) -> dict:
        """This agent's lease-plane counters + current holdings (the
        `lease` subtree of FleetReplica.get_stats, flattened into
        llm_scheduler_lease_* gauges)."""
        with self._lock:
            return {**self.counters, "held": len(self._held)}

    def adopt(self, lease: Lease) -> None:
        """Take ownership of a lease acquired on this holder's behalf
        (fleet bootstrap: assign_initial claims in the store, then each
        manager adopts its share so renewal takes over)."""
        if lease.holder != self.holder:
            raise ValueError(
                f"cannot adopt lease held by {lease.holder!r} "
                f"into manager {self.holder!r}"
            )
        with self._lock:
            self._held[lease.shard_id] = lease

    # ------------------------------------------------------------- protocol
    def tick(self) -> tuple[frozenset[int], frozenset[int]]:
        """One renew + claim pass. Returns (gained, lost) shard sets and
        fires the callbacks (gains after the claim, losses after the
        renew sweep). An unreachable store (LeaseStoreUnavailable —
        chaos partition, apiserver outage) aborts the REST of the tick
        (missed ticks ARE the failure mode TTL leases absorb, and one
        partitioned replica must not abort a shared tick driver) — but
        the tick is not atomic: ownership changes already applied before
        the failure are real, so their callbacks still fire (a gained
        shard whose on_gain rebind never ran would strand its pending
        pods forever: no later tick re-reports a shard already held)."""
        gained: set[int] = set()
        lost: set[int] = set()
        with self._lock:
            self.counters["ticks"] += 1
        try:
            self._tick_inner(gained, lost)
        except LeaseStoreUnavailable as exc:
            with self._lock:
                self.counters["store_unavailable"] += 1
            logger.warning(
                "lease tick aborted for %s (%s): %d gain(s)/%d loss(es) "
                "already applied, callbacks firing for those",
                self.holder, exc, len(gained), len(lost),
            )
        lost_f, gained_f = frozenset(lost), frozenset(gained)
        if lost_f and self.on_loss is not None:
            self.on_loss(lost_f)
        if gained_f and self.on_gain is not None:
            self.on_gain(gained_f)
        return gained_f, lost_f

    def _tick_inner(self, gained: set, lost: set) -> None:
        """The store-touching pass: mutates `gained`/`lost` IN PLACE as
        each ownership change lands, so an abort mid-tick leaves the
        caller an exact record of what actually changed."""
        self.store.heartbeat(self.holder)
        with self._lock:
            held = dict(self._held)
        for sid, lease in held.items():
            try:
                renewed = self.store.renew(sid, self.holder, lease.epoch)
            except LeaseExpired:
                lost.add(sid)
            else:
                with self._lock:
                    self.counters["renewals"] += 1
                    if sid in self._held:
                        self._held[sid] = renewed
        if lost:
            with self._lock:
                self.counters["losses"] += len(lost)
                for sid in lost:
                    self._held.pop(sid, None)
            logger.warning(
                "lease manager %s: lost shards %s (renewal expired)",
                self.holder, sorted(lost),
            )

        holdings = self.store.holdings()
        holdings.setdefault(self.holder, 0)  # we just heartbeated
        n_live = len(holdings)
        target = math.ceil(self.store.n_shards / n_live)
        floor_share = self.store.n_shards // n_live
        # Ceil alone starves a newcomer whenever the incumbents' holdings
        # already EQUAL ceil (16 shards at 4->5 replicas: ceil=4, everyone
        # holds 4, nobody over). A peer below the floor is the signal
        # that the remainder is maldistributed: shed down to the floor
        # until no live holder is starved (balanced states have every
        # holder at floor or floor+1 with nobody below floor — stable).
        starved = any(
            h != self.holder and count < floor_share
            for h, count in holdings.items()
        )
        with self._lock:
            n_held = len(self._held)
            over = n_held > target or (starved and n_held > floor_share)
            shed = max(self._held) if over and self._held else None
        if shed is not None:
            # one shard per tick: gentle rebalancing toward the fair
            # share when new replicas join (they claim what we free).
            # Release in the STORE first — if the store is unreachable
            # the local view stays consistent with it (still held on
            # both sides) instead of locally-dropped-but-store-blocked
            # until TTL.
            self.store.release(shed, self.holder)
            with self._lock:
                self.counters["sheds"] += 1
                self._held.pop(shed, None)
            logger.info(
                "lease manager %s: shed shard %d toward fair share %d",
                self.holder, shed, target,
            )
        # while a peer is starved, claim only up to the floor — claiming
        # to ceil would race the starved peer for the shard we just freed
        claim_target = floor_share if starved else target
        # Yield-to-most-starved: never claim while a live peer holds
        # STRICTLY fewer shards than we do. Without this, tick order
        # decides who wins each freed shard — an under-target incumbent
        # that ticks earlier hoovers every shard the over-target members
        # shed, and a zero-shard newcomer (an autoscale join waiting on
        # its health gate's first-claim condition) starves for as many
        # ticks as the incumbent is below target. The minimum holder is
        # always allowed to claim, so every free shard keeps a claimant
        # and balanced states are untouched.
        min_other = min(
            (count for h, count in holdings.items() if h != self.holder),
            default=None,
        )
        for sid in range(self.store.n_shards):
            with self._lock:
                n_held = len(self._held)
                have = sid in self._held
            if have:
                continue
            if n_held >= claim_target:
                break
            if min_other is not None and n_held > min_other:
                break
            current = self.store.holder_of(sid)
            if current is not None and current != self.holder:
                continue
            # free — or OUR OWN unexpired lease from a previous process
            # incarnation (crash-restart under the same identity, found
            # by the durable-state round): the store renews it at the
            # SAME epoch, so journaled bind intents stay fence-valid
            # across the restart instead of fencing off until TTL
            # expiry re-grants the shard under a bumped epoch.
            lease = self.store.try_acquire(sid, self.holder)
            if lease is not None:
                with self._lock:
                    self.counters["claims"] += 1
                    self._held[sid] = lease
                gained.add(sid)
        if gained:
            logger.info(
                "lease manager %s: claimed shards %s",
                self.holder, sorted(gained),
            )

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"lease-{self.holder}"
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.renew_interval_s):
            try:
                self.tick()
            except Exception:
                # a store hiccup must not kill the renewal thread — missing
                # renewals IS the failure mode leases exist to survive
                logger.exception("lease tick failed for %s", self.holder)

    def stop(self, release: bool = True) -> None:
        """Stop renewing. `release=True` (clean shutdown) frees the held
        shards immediately; `release=False` models a crash — shards stay
        leased until TTL expiry, exactly what failover tests need."""
        self._stop.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=5)
        if release:
            with self._lock:
                held = list(self._held)
                self._held.clear()
            for sid in held:
                self.store.release(sid, self.holder)
            try:
                self.store.retract_heartbeat(self.holder)
            except LeaseStoreUnavailable:
                pass  # unreachable store: presence ages out via TTL


def assign_initial(
    store: LeaseStore, holders: Iterable[str]
) -> dict[str, list[Lease]]:
    """Deterministic round-robin bootstrap: shard i -> holder i % N.
    Fleet startup uses this so every shard is owned before the first pod
    is observed (manager ticks alone converge, but only after a few
    rounds of fair-share claiming). Returns the acquired leases so the
    holders' managers can adopt them without a second store round-trip
    (2N apiserver calls in a k8s-backed deployment)."""
    holders = list(holders)
    out: dict[str, list[Lease]] = {h: [] for h in holders}
    for sid in range(store.n_shards):
        holder = holders[sid % len(holders)]
        lease = store.try_acquire(sid, holder)
        if lease is not None:
            out[holder].append(lease)
    return out
