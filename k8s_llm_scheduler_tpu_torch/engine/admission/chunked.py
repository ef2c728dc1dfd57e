"""The device work of one admission chunk (the port of the JAX package's
engine/admission/chunked.py).

One call per pack chunk: packed block-diagonal prefill
(models/llama.forward_prefill_packed) + per-token KV page scatter +
first-token sampling for every prompt that COMPLETES in this chunk, with
the sampled state scattered straight into the engine's per-slot decode
state — the packed analogue of engine/engine._admit_impl. The engine
(InferenceEngine.admit_packed) runs these back-to-back and piggybacks
in-flight decode chunks between them, so a burst's admission never stalls
decode (the SARATHI discipline) and the host syncs exactly once, at the
next step() harvest.

Where the JAX program donates the caches and the slot state and returns
new ones, this writes them IN PLACE: the decode chunk is a CUDA graph that
reads them at the addresses it was captured with, so a rebound tensor
would leave the piggybacked chunks decoding stale state.

Prompts that end mid-pack start decoding on the very next piggybacked
decode chunk — continuous batching at chunk granularity rather than
wave granularity.
"""

from __future__ import annotations

import torch

from k8s_llm_scheduler_tpu_torch.engine.engine import _admit_rows, _SlotState
from k8s_llm_scheduler_tpu_torch.models.llama import forward_prefill_packed


@torch.no_grad()
def packed_admit_step(
    params,
    cfg,
    tokens,        # [C] packed chunk tokens
    seg,           # [C] segment id per token (-1 padding)
    positions,     # [C] ABSOLUTE positions (prefix_len + local)
    prefix_k, prefix_v,  # [L, Sp, n_kv, hd] shared dense prefix KV
    prefix_len,    # 0-dim int32 on the device
    carry_k, carry_v,    # [L, CAP, n_kv, hd] pack carry, updated IN PLACE
    carry_seg,     # [CAP], updated IN PLACE
    carry_len: int,
    k_cache, v_cache,    # paged caches, updated IN PLACE
    page_ids, offs,      # [C] per-token page-scatter destinations
    end_idx,       # [E] chunk-local indices of prompt-final tokens
    end_slots,     # [E] target slot per ending prompt (trash row M on pad)
    end_valid,     # [E] bool — real entries
    end_pos,       # [E] absolute position AFTER the prompt (prefix+len)
    end_budgets,   # [E] decode budget for ending prompts (max_new - 1)
    state: _SlotState,   # per-slot state [M+1], updated IN PLACE
    sp_tokens, sp_next, done_state: int, eos_id: int, pad_id: int,
    dfa_start: int, gen, temperature: float, constrained: bool,
    vocab_limit: int | None = None,
) -> None:
    """One packed admission chunk.

    Ending prompts sample their first token from the chunk's end logits
    and scatter (token, position, active, DFA state, budget, first token)
    into their slot's decode state exactly as _admit_impl does; padding
    end rows land in the reserved trash row and never activate."""
    end_logits = forward_prefill_packed(
        params, cfg, tokens, seg, positions, prefix_k, prefix_v, prefix_len,
        carry_k, carry_v, carry_seg, carry_len, k_cache, v_cache,
        page_ids, offs, end_idx,
    )
    _admit_rows(
        state, end_logits, end_slots, end_pos, end_valid, end_budgets,
        sp_tokens, sp_next, done_state, eos_id, pad_id, dfa_start, gen,
        temperature, constrained, vocab_limit=vocab_limit,
    )
