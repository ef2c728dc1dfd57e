"""Decision-level request cache.

Behavioral parity with the reference's RequestCache (reference
scheduler.py:257-294): the key is a digest of the pod's resource shape
(cpu, memory, priority) plus the sorted per-node load state (name, cpu%,
mem%) (scheduler.py:265-271); entries expire on read after `ttl_seconds`
(scheduler.py:278-282); the cache is size-capped with oldest-entry eviction
(scheduler.py:287-290). Defaults ttl=300s, max_size=100 (config.yaml:17-20).

Differences from the reference, on purpose:
- blake2b instead of MD5 for the key digest (same equivalence classes).
- thread-safe: the TPU serving layer runs the watch loop and the batching
  engine concurrently, so the cache takes a lock (the reference is
  single-threaded, SURVEY §5).
- O(1) eviction via insertion-ordered dict instead of a min() scan.

This cache sits *above* the on-device KV cache: it short-circuits whole
decisions for identical (pod shape, cluster state) pairs — the same
equivalence class the engine's shared-prefix prefill reuse exploits on device.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from collections.abc import Sequence

from k8s_llm_scheduler_tpu_torch.types import NodeMetrics, PodSpec, SchedulingDecision


# Snapshot-digest memo: a burst shares ONE node-metrics snapshot object
# across every pod (sched/loop.py snapshot_ttl_s), but the digest of those
# nodes was being recomputed per pod — ~180 us of the ~400 us per-pod host
# budget at 1000-pod burst scale. Keyed on identity (and verified by
# identity, so a recycled id can't alias); holds strong refs so an id is
# never reused while its entry lives. Assumes snapshots are not mutated
# in place after first use — the loop builds a fresh list per refresh.
_NODES_DIGEST_MEMO: OrderedDict[int, tuple[object, bytes]] = OrderedDict()
_NODES_DIGEST_LOCK = threading.Lock()


def _nodes_digest(nodes: Sequence[NodeMetrics]) -> bytes:
    key = id(nodes)
    with _NODES_DIGEST_LOCK:
        entry = _NODES_DIGEST_MEMO.get(key)
        if entry is not None and entry[0] is nodes:
            _NODES_DIGEST_MEMO.move_to_end(key)
            return entry[1]
    h = hashlib.blake2b(digest_size=16)
    for node in sorted(nodes, key=lambda n: n.name):
        h.update(
            f"|{node.name}|{node.cpu_usage_percent:.2f}|{node.memory_usage_percent:.2f}"
            f"|{int(node.is_ready)}".encode()
        )
        # Labels and taints gate feasibility (selector/affinity/toleration),
        # so a label or taint change within the TTL must miss the cache; the
        # memo above keeps this per-snapshot, not per-pod.
        h.update(f"|L{sorted(node.labels.items())!r}".encode())
        h.update(f"|T{[sorted(t.items()) for t in node.taints]!r}".encode())
    digest = h.digest()
    with _NODES_DIGEST_LOCK:
        _NODES_DIGEST_MEMO[key] = (nodes, digest)
        # 32, not 8: a fleet of sharded replicas (fleet/frontend.py) pins
        # one live snapshot PER REPLICA — at the bench's 16 replicas a
        # cap of 8 thrashed the memo and re-digested a 500-node snapshot
        # on every decision's hot path.
        while len(_NODES_DIGEST_MEMO) > 32:
            _NODES_DIGEST_MEMO.popitem(last=False)
    return digest


def decision_cache_key(pod: PodSpec, nodes: Sequence[NodeMetrics]) -> str:
    """Digest of the decision-relevant state.

    Pod identity (name/namespace) is deliberately excluded: two pods with the
    same resource shape against the same cluster state get the same decision
    (reference scheduler.py:265-271). Unlike the reference, the pod's
    placement constraints (node_selector, tolerations, affinity) ARE part of
    the key — the reference omits them, so a constrained pod could be served
    a cached decision for a node it cannot legally run on.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{pod.cpu_request:.6f}|{pod.memory_request:.6f}|{pod.priority}".encode())
    for k, v in sorted(pod.node_selector.items()):
        h.update(f"|sel:{k}={v}".encode())
    for tol in pod.tolerations:
        h.update(f"|tol:{sorted(tol.items())!r}".encode())
    if pod.affinity_rules:
        h.update(f"|aff:{sorted(pod.affinity_rules.items())!r}".encode())
    h.update(_nodes_digest(nodes))
    return h.hexdigest()


class DecisionCache:
    """TTL + size-capped cache of SchedulingDecision keyed on cluster state."""

    def __init__(self, ttl_seconds: float = 300.0, max_size: int = 100) -> None:
        self.ttl_seconds = float(ttl_seconds)
        self.max_size = int(max_size)
        self._entries: OrderedDict[str, tuple[float, SchedulingDecision]] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        # Per-thread outcome of the LAST get(): "l1_hit" | "miss" (a
        # single-tier cache is its own L1; fleet/cache.TieredDecisionCache
        # overrides with l1_hit/l2_hit/miss). Thread-local because the
        # cache is shared across the watch loop and replica threads —
        # the flight recorder stamps THIS thread's lookup, not the
        # latest lookup fleet-wide.
        self._tier_local = threading.local()
        # Policy generation/epoch. decision_cache_key digests only (pod,
        # cluster) state, so after a weight swap (rollout/hotswap.py) every
        # pre-swap entry would still hit — decisions from the RETIRED
        # policy served indefinitely. The generation is folded into the
        # stored key; bump_generation() makes every older entry
        # unreachable (they age out via TTL/size-cap) without flushing
        # counters or same-generation state.
        self.generation = 0

    def bump_generation(self) -> int:
        """Invalidate every cached decision from the current policy epoch
        (called on hot weight swap). O(1): entries are not flushed, they
        just become unreachable and age out."""
        with self._lock:
            self.generation += 1
            return self.generation

    def set_generation(self, generation: int) -> int:
        """Catch this cache up to a FOREIGN generation authority (the
        fleet's shared L2: a replica's private L1 must treat an L2 bump —
        another replica's hot swap — exactly like its own). Monotonic:
        a stale/lower value never rolls the epoch back. Returns the
        resulting generation."""
        with self._lock:
            if generation > self.generation:
                self.generation = generation
            return self.generation

    @property
    def last_tier(self) -> str | None:
        """This thread's last get() outcome ("l1_hit"/"miss"), for the
        flight recorder's cache_tier stamp. None before any lookup."""
        return getattr(self._tier_local, "value", None)

    def _stored_key(self, key: str, generation: int | None = None) -> str:
        # caller holds self._lock
        gen = self.generation if generation is None else generation
        return f"{gen}:{key}"

    def get(
        self,
        pod: PodSpec,
        nodes: Sequence[NodeMetrics],
        key: str | None = None,
    ) -> SchedulingDecision | None:
        if key is None:
            key = decision_cache_key(pod, nodes)
        now = time.monotonic()
        with self._lock:
            key = self._stored_key(key)
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                self._tier_local.value = "miss"
                return None
            stored_at, decision = entry
            if now - stored_at > self.ttl_seconds:  # expire on read (scheduler.py:278-282)
                del self._entries[key]
                self.misses += 1
                self._tier_local.value = "miss"
                return None
            self.hits += 1
            self._tier_local.value = "l1_hit"
            return decision

    def set(
        self,
        pod: PodSpec,
        nodes: Sequence[NodeMetrics],
        decision: SchedulingDecision,
        key: str | None = None,
        generation: int | None = None,
    ) -> None:
        """Store a decision. Fallback decisions are never cached
        (reference scheduler.py:398-399).

        `generation` is the policy epoch the decision was COMPUTED under
        (captured before the backend call — sched/client.py). Without it,
        a decision computed under pre-swap weights that lands after
        bump_generation would be stored under the NEW epoch and served
        post-promotion; with it, that straggler files under the old epoch
        and is unreachable. None = the current epoch (single-epoch
        callers)."""
        if decision.fallback_needed:
            return
        if key is None:
            key = decision_cache_key(pod, nodes)
        with self._lock:
            key = self._stored_key(key, generation)
            if key in self._entries:
                del self._entries[key]
            elif len(self._entries) >= self.max_size:
                self._entries.popitem(last=False)  # oldest insertion (scheduler.py:287-290)
            self._entries[key] = (time.monotonic(), decision)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "size": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "generation": self.generation,
            }
