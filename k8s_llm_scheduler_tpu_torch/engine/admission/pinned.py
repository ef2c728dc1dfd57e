"""Pinned snapshot-prefix KV manager: pin / refresh / evict lifecycle.

The delta-encoding scheme (sched/delta.py) renders every decision prompt
as (pinned cluster snapshot) + (diff of what changed since the pin). The
engine side of that contract lives here: the pinned snapshot's prefix KV
must STAY resident on device across bursts — it is the seed every
delta-extended prompt LCP-reuses (engine._best_lcp_seed), and losing it
to byte-pressure eviction re-pays the full O(cluster) prefill that
pinning exists to amortize.

The manager tracks one pin handle per snapshot key over the engine's
prefix cache (engine.pin_prefix / unpin_prefix / pin_alive), bounds the
pin count (LRU), and enforces the GENERATION contract: every handle is
stamped with the engine's prefix_epoch at pin time, and a rollout hot
swap (InferenceEngine.swap_params) bumps the epoch and clears the
engine's pin set — so a stale pin can never serve a post-swap decision;
ensure() simply re-pins under the new weights.

Thread model: ensure()/invalidate_stale() run on the ENGINE-OWNER thread
only (they dispatch prefills), like every engine call. stats() is
read-only snapshot data.
"""

from __future__ import annotations

import dataclasses
import logging

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class PinHandle:
    """One pinned snapshot prefix."""

    key: str                    # caller's snapshot key (sched/delta pin id)
    cache_key: tuple[int, ...]  # engine prefix-cache key (the token ids)
    epoch: int                  # engine.prefix_epoch at pin time
    length: int                 # pinned tokens
    source: str = "local"       # "local" prefill | "shared" (kvplane adoption)


class PinnedPrefixManager:
    def __init__(self, engine, max_pins: int = 4, kvplane=None) -> None:
        self.engine = engine
        self.max_pins = max(1, int(max_pins))
        # Shared prefix-KV plane client (fleet/kvplane/KVPlaneClient).
        # When attached, pin installs route through the fleet tier —
        # adopt a peer's pages when published, else prefill locally and
        # publish for the fleet. Assigned post-construction by
        # LocalLLMBackend.attach_kvplane.
        self.kvplane = kvplane
        self._pins: dict[str, PinHandle] = {}  # insertion order = LRU
        self.stats_counters = {
            "pins": 0,
            "pin_hits": 0,
            "repins_stale": 0,
            "evictions": 0,
        }

    def ensure(self, key: str, token_ids: list[int]) -> bool:
        """Make `key`'s snapshot prefix pinned and live on device.

        Returns True when a prefill (pin install) happened, False on a
        hit (already pinned, same tokens, current weight epoch). Called
        BEFORE the group's set_prefix so the delta-extended prefix
        LCP-seeds from the pin instead of prefilling the snapshot again.
        """
        ids = tuple(token_ids)
        h = self._pins.get(key)
        if h is not None:
            if h.cache_key == ids and self.engine.pin_alive(h.cache_key, h.epoch):
                # refresh LRU order
                self._pins[key] = self._pins.pop(key)
                self.stats_counters["pin_hits"] += 1
                return False
            # stale: weights swapped, evicted, or the snapshot re-pinned
            # with new content — release and re-pin below
            if not self.engine.pin_alive(h.cache_key, h.epoch):
                self.stats_counters["repins_stale"] += 1
            self.engine.unpin_prefix(h.cache_key)
            del self._pins[key]
        if self.kvplane is not None:
            cache_key, epoch, source = self.kvplane.pin(list(token_ids))
        else:
            cache_key, epoch = self.engine.pin_prefix(list(token_ids))
            source = "local"
        self._pins[key] = PinHandle(
            key=key, cache_key=cache_key, epoch=epoch, length=len(ids),
            source=source,
        )
        self.stats_counters["pins"] += 1
        while len(self._pins) > self.max_pins:
            old_key = next(iter(self._pins))
            old = self._pins.pop(old_key)
            self.engine.unpin_prefix(old.cache_key)
            self.stats_counters["evictions"] += 1
        return True

    def invalidate_stale(self) -> int:
        """Drop every handle whose weight epoch no longer matches the
        engine (a hot swap happened). Returns the number dropped. The
        engine already cleared its pin set at swap time — this only
        tidies the manager's handles so ensure() re-pins cleanly."""
        stale = [
            k for k, h in self._pins.items()
            if not self.engine.pin_alive(h.cache_key, h.epoch)
        ]
        for k in stale:
            del self._pins[k]
        if stale:
            self.stats_counters["repins_stale"] += len(stale)
        return len(stale)

    def release(self, key: str) -> None:
        h = self._pins.pop(key, None)
        if h is not None:
            self.engine.unpin_prefix(h.cache_key)

    def source_of(self, key: str) -> str | None:
        """Provenance of `key`'s live pin ("local" | "shared"), or None
        when nothing is pinned under it — what decision traces stamp as
        `kv_source`."""
        h = self._pins.get(key)
        return h.source if h is not None else None

    @property
    def pins(self) -> dict[str, PinHandle]:
        return dict(self._pins)

    def stats(self) -> dict:
        out = dict(self.stats_counters)
        out["live_pins"] = len(self._pins)
        out["pinned_tokens"] = sum(h.length for h in self._pins.values())
        return out
