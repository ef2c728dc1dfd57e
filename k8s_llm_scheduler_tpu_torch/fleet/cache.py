"""Tiered decision cache: per-replica L1 in front of a fleet-shared L2.

At fleet scale the decision cache splits the same way CPU caches do:

- **L1** is private to one replica — small, contention-free (its lock is
  only ever taken by this replica's threads), and answering the common
  case: a burst's followers re-reading the leader's decision.
- **L2** is ONE DecisionCache object shared by every replica in the
  fleet (in-process fleets share it directly; a multi-process deployment
  would back this seam with a networked store). It is what makes a
  decision computed by replica A servable from replica B without a
  second model call — the fleet-wide single-flight economics.

Generation coherence is the part that must not be reinvented per tier:
`DecisionCache` already stamps every stored key with a policy
generation and `bump_generation()` makes older epochs unreachable
(rollout/hotswap.py). Here the **L2 is the generation authority**: a
hot weight swap anywhere in the fleet bumps L2 once, and every
replica's L1 catches up lazily on its next lookup (`set_generation` is
monotonic), so pre-swap decisions become unservable from BOTH tiers
without any cross-replica flush traffic. Straggler protection carries
through unchanged: DecisionClient captures `generation` before the
backend call and both tiers file the late decision under that old,
unreachable epoch.

The tiered cache exposes the exact DecisionCache surface DecisionClient
consumes (get/set/generation/bump_generation/stats/len/clear), so the
client stack is fleet-ready without modification.
"""

from __future__ import annotations

import threading
from collections.abc import Sequence

from k8s_llm_scheduler_tpu_torch.core.cache import DecisionCache, decision_cache_key
from k8s_llm_scheduler_tpu_torch.types import NodeMetrics, PodSpec, SchedulingDecision


class TieredDecisionCache:
    """L1 (private) over L2 (shared, generation authority)."""

    def __init__(
        self,
        l2: DecisionCache,
        l1_size: int = 256,
        l1_ttl_s: float | None = None,
    ) -> None:
        self.l2 = l2
        self.l1 = DecisionCache(
            ttl_seconds=l2.ttl_seconds if l1_ttl_s is None else l1_ttl_s,
            max_size=l1_size,
        )
        self._tier_local = threading.local()
        self._lock = threading.Lock()
        self.l1_hits = 0
        self.l2_hits = 0
        self.misses = 0
        # Chaos seam (chaos/faults.py, seam "cache", kind "l2_down"):
        # None in production. While the shared tier is down, reads serve
        # from the private L1 only, writes are L1-only (nothing to share
        # with a dead tier), and generation sync pauses — the replica
        # keeps deciding on its last-known epoch and re-syncs on the
        # first lookup after recovery.
        self.fault_seam = None
        self.l2_unavailable = 0

    # ------------------------------------------------------------ coherence
    def _l2_up(self) -> bool:
        seam = self.fault_seam
        if seam is not None and seam.should("l2_down") is not None:
            with self._lock:
                self.l2_unavailable += 1
            return False
        return True

    def _sync(self, l2_up: bool | None = None) -> int:
        """Catch L1 up to the L2 epoch (monotonic; a no-op in the steady
        state). Called on every lookup/store so an L2 bump by ANOTHER
        replica invalidates this replica's L1 on its very next use.
        With the L2 unreachable, L1 keeps its last-known epoch — a
        bounded staleness window the first post-recovery sync closes.
        get/set pass their own `_l2_up()` reading so one operation
        consults the seam (and counts an outage) exactly once."""
        if l2_up is None:
            l2_up = self._l2_up()
        if not l2_up:
            return self.l1.generation
        return self.l1.set_generation(self.l2.generation)

    @property
    def generation(self) -> int:
        """The fleet epoch (L2's). DecisionClient captures this before
        the backend call, exactly as with a flat cache."""
        return self._sync()

    def bump_generation(self) -> int:
        """Hot swap: bump the shared epoch once; both tiers' older
        entries become unreachable (L1 via the sync that follows)."""
        gen = self.l2.bump_generation()
        self.l1.set_generation(gen)
        return gen

    # --------------------------------------------------------------- lookup
    def get(
        self,
        pod: PodSpec,
        nodes: Sequence[NodeMetrics],
        key: str | None = None,
    ) -> SchedulingDecision | None:
        if key is None:
            key = decision_cache_key(pod, nodes)
        l2_up = self._l2_up()
        self._sync(l2_up)
        decision = self.l1.get(pod, nodes, key=key)
        if decision is not None:
            with self._lock:
                self.l1_hits += 1
            self._tier_local.value = "l1_hit"
            return decision
        if not l2_up:
            with self._lock:
                self.misses += 1
            self._tier_local.value = "l2_down"
            return None
        decision = self.l2.get(pod, nodes, key=key)
        if decision is not None:
            # promote: the next lookup on this replica is an L1 hit and
            # never touches the shared tier's lock again
            self.l1.set(pod, nodes, decision, key=key)
            with self._lock:
                self.l2_hits += 1
            self._tier_local.value = "l2_hit"
            return decision
        with self._lock:
            self.misses += 1
        self._tier_local.value = "miss"
        return None

    def set(
        self,
        pod: PodSpec,
        nodes: Sequence[NodeMetrics],
        decision: SchedulingDecision,
        key: str | None = None,
        generation: int | None = None,
    ) -> None:
        """Write-through: the shared tier gets every decision (that is
        what makes it fleet-shared), the private tier keeps its copy hot.
        `generation` semantics are DecisionCache's: the epoch the
        decision was computed under, so post-swap stragglers file under
        their (unreachable) compute epoch in BOTH tiers."""
        if decision.fallback_needed:
            return
        if key is None:
            key = decision_cache_key(pod, nodes)
        l2_up = self._l2_up()
        self._sync(l2_up)
        self.l1.set(pod, nodes, decision, key=key, generation=generation)
        if l2_up:
            self.l2.set(pod, nodes, decision, key=key, generation=generation)

    # ---------------------------------------------------------- bookkeeping
    @property
    def last_tier(self) -> str | None:
        """This thread's last lookup outcome: l1_hit | l2_hit | miss —
        the flight recorder's cache_tier attribute."""
        return getattr(self._tier_local, "value", None)

    def clear(self) -> None:
        """Clears the PRIVATE tier only: the shared L2 belongs to the
        fleet, and one replica resetting everyone's cache is exactly the
        kind of cross-replica blast radius the tiering prevents."""
        self.l1.clear()

    def __len__(self) -> int:
        return len(self.l1)

    @property
    def ttl_seconds(self) -> float:
        return self.l2.ttl_seconds

    def stats(self) -> dict:
        with self._lock:
            tiers = {
                "l1_hits": self.l1_hits,
                "l2_hits": self.l2_hits,
                "misses": self.misses,
            }
            if self.l2_unavailable:
                tiers["l2_unavailable"] = self.l2_unavailable
        return {
            **tiers,
            "generation": self.l2.generation,
            "l1": self.l1.stats(),
            "l2": self.l2.stats(),
            # flat-cache compatibility for dashboards reading cache.hits:
            # a hit is a hit in either tier
            "size": len(self.l1),
            "hits": tiers["l1_hits"] + tiers["l2_hits"],
        }
