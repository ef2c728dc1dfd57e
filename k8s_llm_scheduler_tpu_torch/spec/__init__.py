"""Speculative decoding (the port of the JAX package's spec/): a draft arm
(a small model) or the draft-free hidden-transfer arm (transfer heads over
the target's own hidden states) proposes K tokens ahead of the target on
the engine's general paged path; the target scores all K in ONE forward
with on-device acceptance (greedy longest-consistent-prefix, or rejection
sampling that preserves the target distribution exactly).

Each round queues the target's verify and the draft's proposal of the NEXT
block back to back and syncs once; the hidden arm computes its proposals
inside the verify program. Speculative streams coexist with the fused
decode runtime (an open round deactivates only its own slot). Rejected
tokens unwind through PagedKVCache.truncate; the grammar is built in
(sparse K-space tables, or the fused runtime's dense table for greedy
verification), so speculation never emits a token the constrained decoder
would forbid.

Modules:
- draft.py   — DraftRunner: dense-KV draft state and the K+1-step proposal.
- verify.py  — the target's scoring program over the paged cache with its
               prefix part through K1, the on-device acceptance, and the
               static-buffer program of one verify geometry.
- hidden.py  — the draft-free arm's verify-and-propose program.
- decoder.py — SpeculativeDecoder: the round state machine, the
               per-request acceptance EWMA with auto-disable onto the fused
               decode path, and the swap rollback hook.
"""

from k8s_llm_scheduler_tpu_torch.spec.decoder import SpeculativeDecoder
from k8s_llm_scheduler_tpu_torch.spec.draft import DraftRunner

__all__ = ["SpeculativeDecoder", "DraftRunner"]
