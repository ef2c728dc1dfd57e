"""Fleet-scale serving: leased watch-space sharding, tiered decision
cache, disaggregated prefill/decode pools (ROADMAP open item 4).

- `fleet/lease.py` — shard hashing + renewable TTL leases (failover
  without double-binding);
- `fleet/cache.py` — per-replica L1 over a fleet-shared,
  generation-stamped L2 (hot swaps invalidate both tiers coherently);
- `fleet/pools.py` — admission routed to a prefill pool (prepacked:
  many short scheduler prompts per prefill wave), warm continuation to
  a decode pool;
- `fleet/frontend.py` — N sharded scheduler replicas composed over one
  cluster (elastic: health-gated joins, drain-before-release removal);
- `fleet/autoscale.py` — the SLO-burn-driven deadband control loop
  that grows/shrinks the replica set and rebalances the pool split.
"""

from k8s_llm_scheduler_tpu_torch.fleet.autoscale import (
    AutoscaleConfig,
    AutoscaleController,
    AutoscalePolicy,
    AutoscaleSignals,
)
from k8s_llm_scheduler_tpu_torch.fleet.cache import TieredDecisionCache
from k8s_llm_scheduler_tpu_torch.fleet.frontend import (
    Fleet,
    FleetReplica,
    JoinError,
    PendingJoin,
)
from k8s_llm_scheduler_tpu_torch.fleet.lease import (
    FileLeaseStore,
    Lease,
    LeaseExpired,
    LeaseManager,
    LeaseStore,
    LeaseStoreUnavailable,
    assign_initial,
    shard_of,
)
from k8s_llm_scheduler_tpu_torch.fleet.pools import (
    DECODE,
    MIXED,
    POOL_ROLES,
    PREFILL,
    DisaggregatedBackend,
    check_pool_role,
)

__all__ = [
    "AutoscaleConfig",
    "AutoscaleController",
    "AutoscalePolicy",
    "AutoscaleSignals",
    "DECODE",
    "DisaggregatedBackend",
    "FileLeaseStore",
    "Fleet",
    "FleetReplica",
    "JoinError",
    "Lease",
    "LeaseExpired",
    "LeaseManager",
    "LeaseStore",
    "LeaseStoreUnavailable",
    "MIXED",
    "POOL_ROLES",
    "PREFILL",
    "PendingJoin",
    "TieredDecisionCache",
    "assign_initial",
    "check_pool_role",
    "shard_of",
]
