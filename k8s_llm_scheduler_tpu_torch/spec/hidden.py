"""Hidden-transfer draft-free speculation: propose INSIDE the verify (the
port of the JAX package's spec/hidden.py).

*Hidden Transfer* (PAPERS.md) replaces the second model: the target's own
final-layer hidden state at the acceptance point is "transferred" to
pseudo hidden states for the next K positions (models/llama.
hidden_transfer_logits: per-offset residual matrices), and the model's own
LM head turns each into a proposal distribution. `_hidden_verify_impl` is
ONE device program a round that

1. scores the current block exactly as the draft arm's verify does
   (spec/verify._forward_verify_block: the same three parts, K1 for the
   prefix, the same in-place KV scatter and on-device acceptance, so greedy
   output is token-identical to plain decode by the same argument);
2. gathers the final-layer hidden state at the acceptance index `a` on the
   device;
3. chains K grammar-masked proposals from the transfer heads: the K
   heads' logits come from one LM-head product (they depend on that hidden
   state alone); each step masks through the tables the engine decodes
   with (a dense-table row when the grammar exports one, else sparse
   K-space), advances the DFA state and records the masked proposal logits
   the NEXT round's rejection sampler needs.

The proposals stay on the device: round n+1's block is assembled from
round n's outputs, so the only sync a round is the decoder's one fetch. A
W = 1 bootstrap geometry (block = [first token], no drafts) starts each
request and produces the first proposal block.
"""

from __future__ import annotations

import torch

from k8s_llm_scheduler_tpu_torch.engine.engine import _pick
from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig
from k8s_llm_scheduler_tpu_torch.models.llama import Params, hidden_transfer_logits
from k8s_llm_scheduler_tpu_torch.ops.attention import NEG_INF
from k8s_llm_scheduler_tpu_torch.spec.verify import (
    _accept_block,
    _at,
    _forward_verify_block,
    _masked_target,
)


@torch.no_grad()
def _hidden_verify_impl(
    params: Params,
    cfg: LlamaConfig,
    ht: Params,        # {"transfer": [K, D, D]} hidden-transfer head
    blk_tok,      # [W] — [t_cur, g_1..g_{W-1}] (W = 1 on the bootstrap round)
    positions,    # [W]
    prefix_k, prefix_v, prefix_len,
    k_cache, v_cache,  # updated IN PLACE
    page_table, own_len, page_ids, offs,
    mask_states,   # [W] — DFA state governing the token AFTER blk_tok[i]
    choice_idx,    # [W-1] — the proposal's masked-space index (rejection path)
    guess_logits,  # [W-1, X] — the previous round's masked proposal logits
    sp_tokens, sp_next,
    dense_next,    # [S, V] dense transition table (grammar == "dense")
    pad_id: int,
    gen, temperature: float,
    grammar: str,
    greedy: bool,
    n_guess: int,  # K proposals for the NEXT round
    vocab_limit: int | None = None,
):
    """Verify the current block AND propose the next one, one program.

    Returns (a, t_next, st_next, g_toks [n_guess], g_states [n_guess],
    g_idx [n_guess], g_logits [n_guess, X]). g_states[h] is the DFA state
    AFTER guess h; g_logits are the masked proposal logits (the q
    distributions of the next round's rejection sampler); X is the accept
    path's space (K-width under "sparse", vocab otherwise)."""
    logits_all, x_all = _forward_verify_block(
        params, cfg, blk_tok, positions, prefix_k, prefix_v, prefix_len,
        k_cache, v_cache, page_table, own_len, page_ids, offs,
    )
    masked, idx_to_tok = _masked_target(
        logits_all, mask_states, sp_tokens, sp_next, dense_next, pad_id, grammar,
        vocab_limit,
    )
    a, t_next, st_next = _accept_block(
        masked, idx_to_tok, blk_tok[1:], choice_idx, guess_logits, gen, temperature,
        grammar, greedy, sp_tokens=sp_tokens, mask_states=mask_states,
    )
    # The next block from the hidden state at the acceptance point: x_all[a]
    # predicted t_next; head h predicts the h+1-th token after it. The chain
    # is sequential in the DFA state only.
    head_logits = hidden_transfer_logits(params, cfg, ht, _at(x_all, a))  # [k, V]
    st = st_next.reshape(()).to(torch.int32)
    g_toks, g_states, g_idx, g_logits = [], [], [], []
    for h in range(n_guess):
        lg = head_logits[h]
        if grammar == "dense":
            row = dense_next.index_select(0, st.reshape(1).long())[0]  # [V]
            m = torch.where(row >= 0, lg, NEG_INF)
            k_idx = _pick(m[None, :], gen, temperature)[0]
            tok, nxt = k_idx, _at(row, k_idx)
        elif grammar == "sparse":
            rows = sp_tokens.index_select(0, st.reshape(1).long())[0]  # [Kw]
            nrow = sp_next.index_select(0, st.reshape(1).long())[0]
            m = torch.where(rows >= 0, lg[rows.clamp(min=0).long()], NEG_INF)
            k_idx = _pick(m[None, :], gen, temperature)[0]
            tok, nxt = _at(rows, k_idx), _at(nrow, k_idx)
        else:
            V = lg.shape[-1]
            ids = torch.arange(V, device=lg.device)
            bad = ids == pad_id
            if vocab_limit is not None and vocab_limit < V:
                bad = bad | (ids >= vocab_limit)
            m = torch.where(bad, NEG_INF, lg)
            k_idx = _pick(m[None, :], gen, temperature)[0]
            tok, nxt = k_idx, st
        g_toks.append(tok.to(torch.int32))
        g_states.append(nxt.to(torch.int32))
        g_idx.append(k_idx.to(torch.int32))
        g_logits.append(m)
        st = nxt.to(torch.int32)
    return a, t_next, st_next, torch.stack(g_toks), torch.stack(g_states), \
        torch.stack(g_idx), torch.stack(g_logits)
