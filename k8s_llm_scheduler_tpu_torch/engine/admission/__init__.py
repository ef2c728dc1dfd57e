"""Delta-prefill admission plane (the port of the JAX package's
engine/admission/).

Three cooperating pieces (ROADMAP item 2 — *SARATHI* chunked prefills,
*Prepacking* block-diagonal packing, plus the scheduler-specific third:
snapshot-delta prompts over pinned prefix KV):

- `packer`   — host-side prepacking: many short scheduler prompts
  concatenated into fixed-token chunks with per-token segment ids and
  position offsets (the block-diagonal attention plan);
- `chunked`  — the device work of one admission chunk (packed
  block-diagonal prefill + KV page scatter + first-token sample),
  dispatched by InferenceEngine.admit_packed with in-flight decode
  chunks piggybacked between prefill chunks so decode never stalls
  while a burst is admitted;
- `pinned`   — the pinned snapshot-prefix KV manager: pin/refresh/evict
  lifecycle over the engine's prefix cache, generation-stamped so
  rollout hot swaps can never serve a stale pin.

The prompt-side half (rendering a decision prompt as pinned snapshot +
incremental diff so prefill cost scales with what changed, not cluster
size) lives in sched/delta.py.
"""

from k8s_llm_scheduler_tpu_torch.engine.admission.packer import (
    PackChunk,
    PackedPlan,
    PromptEnd,
    pack_prompts,
)
from k8s_llm_scheduler_tpu_torch.engine.admission.pinned import (
    PinHandle,
    PinnedPrefixManager,
)

__all__ = [
    "PackChunk",
    "PackedPlan",
    "PromptEnd",
    "pack_prompts",
    "PinHandle",
    "PinnedPrefixManager",
]
