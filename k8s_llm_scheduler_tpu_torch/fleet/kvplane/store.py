"""KVPlaneStore: the fleet-shared prefix-KV tier.

One replica's snapshot prefill serves the whole fleet: the first
replica to miss on a snapshot digest wins a **fill lease** (the same
epoch-fenced lease machinery that owns scheduling shards,
fleet/lease.py — a digest hashes to a fill shard, `try_acquire` elects
exactly one filler, `check_fence` rejects a filler that lost its lease
before publishing). Everyone else either adopts the published pages or
degrades to a local prefill; the store never blocks a decision.

Generation protocol (the TieredDecisionCache design, fleet/cache.py,
applied to KV): the store's `generation` is the fleet-wide twin of the
per-engine `prefix_epoch`. Hot swaps bump it ONCE
(rollout/hotswap.HotSwapper / rollout/canary.staggered_swap) and the
bump clears every entry — pages prefilled under old weights are wrong
under new weights, full stop. Lookups present the generation the client
last synced; a stale presentation is refused (counted, never served),
and a filler that publishes after a bump publishes into the void
(stale_publishes) rather than poisoning the new generation.

Geometry: entries are keyed by digest and stamped with the publisher's
KVGeometry (tp shard spec included). A lookup whose geometry differs
from the stored entry's raises KVGeometryError — loud refusal, because
a mixed-geometry fleet is a misconfiguration, not a cache miss.

Chaos seam: `fault_seam` (chaos/faults.Seam for the "kvplane" seam)
is consulted once per store operation — `store_down` makes the op raise
KVPlaneStoreUnavailable (clients degrade to local prefill),
`fill_stall` kills a publish mid-flight (the fill lease is NOT released:
waiters see neither pages nor a free lease until the TTL reaps it,
exactly what a dead filler looks like), `stale_generation` ages the
presented generation so adoption is refused.

All judgments use the injected clock; nothing here sleeps.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

from .pages import KVGeometry, KVGeometryError, PrefixPageSet
from ..lease import Lease, LeaseStore


class KVPlaneStoreUnavailable(RuntimeError):
    """The shared KV tier cannot be reached; callers degrade to local
    prefill (never an error surfaced to a decision)."""


class KVPlaneStore:
    """In-memory reference store for the shared prefix-KV plane.

    Single-process fleets share the object directly; the method surface
    (lookup / try_fill / publish / bump_generation, all keyed by content
    digest + generation) is what a networked backend would expose."""

    def __init__(
        self,
        *,
        fill_ttl_s: float = 5.0,
        max_entries: int = 8,
        n_fill_shards: int = 64,
        clock: Callable[[], float] = time.monotonic,
        lease_store: Optional[LeaseStore] = None,
    ) -> None:
        self._lock = threading.Lock()
        self._clock = clock
        self.max_entries = int(max_entries)
        self.lease = lease_store or LeaseStore(
            n_fill_shards, ttl_s=fill_ttl_s, clock=clock
        )
        # digest -> PrefixPageSet, LRU order; current generation only
        # (a bump clears the dict, so no entry ever carries a stale
        # generation — the stamp exists for clients that cached a
        # reference across the bump).
        self._entries: "OrderedDict[str, PrefixPageSet]" = OrderedDict()
        self.generation = 0
        self.fault_seam = None  # chaos/faults.Seam("kvplane") when under chaos
        self.counters = {
            "fills": 0,
            "adoptions": 0,
            "bytes_shipped": 0,
            "evictions": 0,
            "stale_rejections": 0,
            "stale_publishes": 0,
            "geometry_refusals": 0,
            "store_outages": 0,
            "fill_stalls": 0,
            "generation_bumps": 0,
        }

    # -- fault plumbing -------------------------------------------------

    def _check_up(self, holder: str) -> None:
        seam = self.fault_seam
        if seam is not None and seam.should("store_down", key=holder):
            with self._lock:
                self.counters["store_outages"] += 1
            raise KVPlaneStoreUnavailable(
                f"kvplane store unreachable from {holder!r}"
            )

    def _presented_generation(self, generation: int, holder: str) -> int:
        seam = self.fault_seam
        if seam is not None and seam.should("stale_generation", key=holder):
            return int(generation) - 1
        return int(generation)

    # -- fill election --------------------------------------------------

    def fill_shard(self, digest: str) -> int:
        """Map a snapshot digest onto a fill-lease shard (blake2b, the
        fleet/lease.shard_of discipline — stable across processes)."""
        h = hashlib.blake2b(digest.encode("utf-8"), digest_size=8)
        return int.from_bytes(h.digest(), "big") % self.lease.n_shards

    def try_fill(self, digest: str, holder: str) -> Optional[Lease]:
        """Run the single-filler election for `digest`. Returns the fill
        lease when `holder` wins (it now owes a publish or a TTL
        expiry), None when another replica already holds the fill."""
        self._check_up(holder)
        return self.lease.try_acquire(self.fill_shard(digest), holder)

    # -- data path ------------------------------------------------------

    def lookup(
        self,
        digest: str,
        geometry: KVGeometry,
        *,
        generation: int,
        holder: str,
    ) -> Optional[PrefixPageSet]:
        """Fetch published pages for `digest`, or None on miss.

        Refusals: a generation older than the store's (stale client —
        it must sync and re-pin, not adopt pre-swap KV) returns None and
        counts `stale_rejections`; a geometry mismatch against the
        stored entry raises KVGeometryError (see module docstring)."""
        self._check_up(holder)
        presented = self._presented_generation(generation, holder)
        with self._lock:
            if presented != self.generation:
                self.counters["stale_rejections"] += 1
                return None
            pages = self._entries.get(digest)
            if pages is None:
                return None
            if pages.geometry != geometry:
                self.counters["geometry_refusals"] += 1
                raise KVGeometryError(
                    f"kvplane entry {digest[:12]} was published for "
                    f"{pages.geometry.describe()} but {holder!r} serves "
                    f"{geometry.describe()}"
                )
            self._entries.move_to_end(digest)
            self.counters["adoptions"] += 1
            self.counters["bytes_shipped"] += pages.nbytes
            return pages

    def publish(self, pages: PrefixPageSet, lease: Lease) -> bool:
        """Publish freshly-prefilled pages under a fill lease.

        Returns False (entry NOT stored) when the filler's lease was
        fenced off, the store's generation moved past the pages', or a
        `fill_stall` fault kills the publish mid-flight. In the stall
        case the lease is deliberately left held — a filler that died
        mid-publish cannot release, so waiters degrade locally until
        the TTL reaps the lease. That asymmetry is what the
        kv-plane-outage regime exercises."""
        self._check_up(pages.filler)
        seam = self.fault_seam
        if seam is not None and seam.should("fill_stall", key=pages.filler):
            with self._lock:
                self.counters["fill_stalls"] += 1
            return False
        if not self.lease.check_fence(lease.shard_id, pages.filler, lease.epoch):
            return False
        with self._lock:
            if pages.generation != self.generation:
                self.counters["stale_publishes"] += 1
                return False
            self._entries[pages.digest] = pages
            self._entries.move_to_end(pages.digest)
            self.counters["fills"] += 1
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.counters["evictions"] += 1
        self.lease.release(lease.shard_id, pages.filler)
        return True

    # -- generation protocol -------------------------------------------

    def bump_generation(self) -> int:
        """Fleet-wide invalidation: weights changed (hot swap) or the
        pinned snapshot universe was rebuilt. Clears every entry —
        mirrors engine.swap_params clearing the local prefix cache."""
        with self._lock:
            self.generation += 1
            self._entries.clear()
            self.counters["generation_bumps"] += 1
            return self.generation

    # -- introspection --------------------------------------------------

    def gauges(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["generation"] = self.generation
            out["entries"] = len(self._entries)
            out["resident_bytes"] = sum(
                p.nbytes for p in self._entries.values()
            )
            return out

    # alias so fleet telemetry paths that expect .stats() work too
    stats = gauges
