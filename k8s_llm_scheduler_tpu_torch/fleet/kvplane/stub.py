"""StubPinEngine: a model-free engine that speaks the pin/adopt surface.

The chaos harness and bench fleet arms need MANY replicas exercising
the kvplane protocol (elections, adoption, generation bumps, outages)
where loading even the micro model per replica would drown the thing
being measured. This stub implements exactly the engine methods the
plane touches — pin_prefix / adopt_prefix_pages / export_prefix_kv /
unpin_prefix / pin_alive / prefix_epoch / kv_geometry — with KV that is
a *pure deterministic function of the token ids* (a tiny seeded-hash
fill). That purity is the correctness probe: a replica that adopted
pages holds byte-identical KV to one that "prefilled" locally, so the
chaos harness can assert zero correctness loss by comparing digests,
no model required.

Counters mirror the real engine's prefix stats (prefix_prefills,
prefill_tokens, adopted_prefixes, prefix_hits) so fleet telemetry and
bench arithmetic read the same names either way.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np

from .pages import KVGeometry

_STUB_GEOMETRY = KVGeometry(
    n_layers=2, n_kv_heads=2, head_dim=4, dtype="float32", tp=1
)


def _stub_kv(token_ids: Sequence[int], geom: KVGeometry) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic [L, S, n_kv, hd] KV derived from the token ids —
    the same ids yield the same bytes on every replica."""
    h = hashlib.blake2b(digest_size=8)
    for t in token_ids:
        h.update(int(t).to_bytes(8, "big", signed=True))
    seed = int.from_bytes(h.digest(), "big") % (2**32)
    rng = np.random.default_rng(seed)
    shape = (geom.n_layers, max(1, len(token_ids)), geom.n_kv_heads, geom.head_dim)
    k = rng.standard_normal(shape).astype(geom.dtype)
    v = rng.standard_normal(shape).astype(geom.dtype)
    return k, v


class StubPinEngine:
    def __init__(self, *, geometry: KVGeometry | None = None, prefill_cost_per_token: int = 1) -> None:
        self.kv_geometry = geometry or _STUB_GEOMETRY
        self.prefix_epoch = 0
        self._cache: dict[tuple[int, ...], tuple[np.ndarray, np.ndarray]] = {}
        self._pinned: set[tuple[int, ...]] = set()
        self._cost = int(prefill_cost_per_token)
        self.stats = {
            "prefix_prefills": 0,
            "prefill_tokens": 0,
            "adopted_prefixes": 0,
            "prefix_hits": 0,
            "pinned_prefixes": 0,
            "pin_evictions": 0,
        }

    # -- pin surface ----------------------------------------------------

    def pin_prefix(self, token_ids: Sequence[int]) -> tuple[tuple[int, ...], int]:
        key = tuple(int(t) for t in token_ids)
        if key in self._cache:
            self.stats["prefix_hits"] += 1
        else:
            self._cache[key] = _stub_kv(key, self.kv_geometry)
            self.stats["prefix_prefills"] += 1
            self.stats["prefill_tokens"] += len(key) * self._cost
        self._pinned.add(key)
        self.stats["pinned_prefixes"] += 1
        return key, self.prefix_epoch

    def adopt_prefix_pages(
        self, token_ids: Sequence[int], k: np.ndarray, v: np.ndarray
    ) -> tuple[tuple[int, ...], int]:
        key = tuple(int(t) for t in token_ids)
        self._cache[key] = (np.asarray(k), np.asarray(v))
        self._pinned.add(key)
        self.stats["adopted_prefixes"] += 1
        return key, self.prefix_epoch

    def export_prefix_kv(self, cache_key: Sequence[int]):
        key = tuple(int(t) for t in cache_key)
        return self._cache.get(key)

    def unpin_prefix(self, cache_key: Sequence[int]) -> bool:
        key = tuple(int(t) for t in cache_key)
        if key in self._pinned:
            self._pinned.discard(key)
            self.stats["pin_evictions"] += 1
            return True
        return False

    def pin_alive(self, cache_key, epoch: int) -> bool:
        key = tuple(int(t) for t in cache_key)
        return (
            epoch == self.prefix_epoch
            and key in self._pinned
            and key in self._cache
        )

    # -- swap simulation ------------------------------------------------

    def bump_epoch(self) -> int:
        """What swap_params does to the prefix plane: clear + epoch++."""
        self._cache.clear()
        self._pinned.clear()
        self.prefix_epoch += 1
        return self.prefix_epoch

    # -- correctness probe ----------------------------------------------

    def kv_digest(self, cache_key: Sequence[int]) -> str | None:
        """Digest of the resident KV for `cache_key` — adopted pages and
        a local prefill of the same ids must agree byte-for-byte."""
        kv = self.export_prefix_kv(cache_key)
        if kv is None:
            return None
        h = hashlib.blake2b(digest_size=16)
        h.update(np.ascontiguousarray(kv[0]).tobytes())
        h.update(np.ascontiguousarray(kv[1]).tobytes())
        return h.hexdigest()

    def get_stats(self) -> dict:
        return dict(self.stats)
