"""Live policy rollout: registry -> shadow -> canary gate -> hot swap.

The training loop (train/distill.py) produces servable checkpoints and the
arena (sim/arena.py) scores policies offline, but until this package the
serving engine loaded params exactly once (engine/local.build_local_backend)
and could never adopt a better policy without a restart that drops in-flight
scheduling traffic. This is the last mile of the improvement loop:

- registry.py  — versioned on-disk checkpoint registry (digests, lineage,
  arena scores, atomic publish, retention, fsck);
- hotswap.py   — zero-downtime weight swap for a running engine (quiesce at
  a wave barrier, restore direct-to-shard, swap the params reference,
  invalidate weight-derived state, bump the decision-cache generation);
- shadow.py    — non-binding mirroring of a fraction of live decisions
  through a candidate backend, scored against a stateless spread teacher;
- canary.py    — the promotion controller: seeded arena gate, promote via
  hot swap, burn-in regression monitoring, auto-rollback.
"""

from k8s_llm_scheduler_tpu_torch.rollout.canary import (
    CanaryController,
    GateConfig,
    run_gate,
    staggered_swap,
)
from k8s_llm_scheduler_tpu_torch.rollout.hotswap import HotSwapper, swap_engine_params
from k8s_llm_scheduler_tpu_torch.rollout.registry import (
    CheckpointRegistry,
    Manifest,
    RegistryError,
    config_fingerprint,
)
from k8s_llm_scheduler_tpu_torch.rollout.shadow import ShadowScorer, teacher_pick

__all__ = [
    "CanaryController",
    "CheckpointRegistry",
    "GateConfig",
    "HotSwapper",
    "Manifest",
    "RegistryError",
    "ShadowScorer",
    "config_fingerprint",
    "run_gate",
    "staggered_swap",
    "swap_engine_params",
    "teacher_pick",
]
