"""KVPlaneClient: one replica's view of the shared prefix-KV plane.

Sits exactly where `engine.pin_prefix` used to be called from the
pinned-prefix manager (engine/admission/pinned.py): `pin(token_ids)`
keeps pin_prefix's return contract — (cache_key, prefix_epoch) — plus
the provenance tag (`local` | `shared`) that decision traces surface as
`kv_source`.

The pin path, in order:

1. **Sync** the store generation (a hot swap elsewhere in the fleet
   shows up here as a generation_sync; the engine's own prefix cache
   was already cleared by swap_params on this replica).
2. **Adopt**: lookup by content digest. A hit installs the peer's pages
   into the local engine (pages.adopt_pages) — no prefill paid.
3. **Elect**: on miss, run the single-filler election. Losing it means
   a peer is prefilling right now — re-check the store up to
   `wait_checks` times (cooperative, `yield_fn` between checks; the
   plane never sleeps a decision), then give up and prefill locally.
4. **Fill**: winning the election means prefill locally, export the
   pages, publish. A failed publish (fenced, stale generation, chaos
   stall) is not an error — the local pin already satisfied THIS
   replica's decision; only the fleet-wide dedup is lost.

Any KVPlaneStoreUnavailable anywhere degrades to a plain local
pin_prefix (counted as local_fallback) — the plane is an optimization
tier, never a correctness dependency. KVGeometryError, by contrast,
propagates: mixed geometry is a deployment bug.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from .pages import KVGeometry, adopt_pages, export_pages, page_digest
from .store import KVPlaneStore, KVPlaneStoreUnavailable


class KVPlaneClient:
    def __init__(
        self,
        store: KVPlaneStore,
        engine: Any,
        *,
        replica: str = "r0",
        transport: str = "host",
        wait_checks: int = 2,
        yield_fn: Optional[Callable[[], None]] = None,
    ) -> None:
        self.store = store
        self.engine = engine
        self.replica = replica
        self.transport = transport
        self.wait_checks = int(wait_checks)
        self._yield = yield_fn
        self._known_generation = store.generation
        self.last_source = "local"
        self.counters = {
            "adoptions": 0,
            "publishes": 0,
            "publish_failures": 0,
            "local_fallbacks": 0,
            "store_misses": 0,
            "elections_won": 0,
            "elections_lost": 0,
            "generation_syncs": 0,
            "bytes_shipped": 0,
        }

    # -- generation sync ------------------------------------------------

    def sync_generation(self) -> int:
        g = self.store.generation
        if g != self._known_generation:
            self._known_generation = g
            self.counters["generation_syncs"] += 1
        return self._known_generation

    # -- pin path -------------------------------------------------------

    def _pin_local(self, token_ids: Sequence[int]) -> tuple[Any, int, str]:
        key, epoch = self.engine.pin_prefix(list(token_ids))
        self.last_source = "local"
        return key, epoch, "local"

    def pin(self, token_ids: Sequence[int]) -> tuple[Any, int, str]:
        """Pin a snapshot prefix, preferring fleet-shared pages.

        Returns (cache_key, prefix_epoch, source) where source is
        "shared" (pages adopted from a peer) or "local" (this replica
        prefilled — as the elected filler, or as a degradation)."""
        geometry = KVGeometry.of_engine(self.engine)
        digest = page_digest(token_ids)
        try:
            generation = self.sync_generation()
            pages = self.store.lookup(
                digest, geometry, generation=generation, holder=self.replica
            )
            if pages is not None:
                return self._adopt(pages)
            self.counters["store_misses"] += 1
            lease = self.store.try_fill(digest, self.replica)
            if lease is None:
                self.counters["elections_lost"] += 1
                # A peer holds the fill lease: poll a bounded number of
                # times for its publish before degrading. Bounded and
                # non-sleeping — a stalled filler costs us one local
                # prefill, not a stalled decision.
                for _ in range(self.wait_checks):
                    if self._yield is not None:
                        self._yield()
                    pages = self.store.lookup(
                        digest,
                        geometry,
                        generation=self.sync_generation(),
                        holder=self.replica,
                    )
                    if pages is not None:
                        return self._adopt(pages)
                self.counters["local_fallbacks"] += 1
                return self._pin_local(token_ids)
            self.counters["elections_won"] += 1
            return self._fill(token_ids, lease, generation)
        except KVPlaneStoreUnavailable:
            self.counters["local_fallbacks"] += 1
            return self._pin_local(token_ids)

    def _adopt(self, pages) -> tuple[Any, int, str]:
        key, epoch = adopt_pages(self.engine, pages)
        self.counters["adoptions"] += 1
        self.counters["bytes_shipped"] += pages.nbytes
        self.last_source = "shared"
        return key, epoch, "shared"

    def _fill(
        self, token_ids: Sequence[int], lease, generation: int
    ) -> tuple[Any, int, str]:
        key, epoch, source = self._pin_local(token_ids)
        pages = export_pages(
            self.engine,
            key,
            generation=generation,
            filler=self.replica,
            transport=self.transport,
        )
        if pages is not None:
            try:
                if self.store.publish(pages, lease):
                    self.counters["publishes"] += 1
                else:
                    self.counters["publish_failures"] += 1
            except KVPlaneStoreUnavailable:
                self.counters["publish_failures"] += 1
        return key, epoch, source

    # -- introspection --------------------------------------------------

    def stats(self) -> dict:
        out = dict(self.counters)
        out["known_generation"] = self._known_generation
        out["last_source"] = self.last_source
        return out
