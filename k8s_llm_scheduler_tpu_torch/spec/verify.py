"""Target-side verification: score K draft tokens in ONE forward, accept
(the port of the JAX package's spec/verify.py).

`_verify_impl` is one device program per (W, grammar mode, greedy)
geometry that

1. runs the target over the W-token block [t_cur, d_1..d_K] against three
   parts merged by log-sum-exp: the shared dense prefix (K1,
   ops/prefix_attention.flash_prefix_attention_parts), the slot's own pages
   (gathered and attended in f32, ops/attention.attend_part, as the JAX
   program does) and causal attention inside the block;
2. scatters the block's K/V into the slot's pages IN PLACE (`index_put_`
   into the engine's caches, whose addresses captured graphs hold): the
   accepted prefix is then resident, and the rejected tail unwinds through
   PagedKVCache.truncate (readers mask by length, so stale contents are
   never attended);
3. applies the decoder's grammar to every position's target distribution:
   greedy constrained verification reads the dense transition table when
   the engine exports one (engine/fused/tables.py), sampling and grammars
   past the table's byte cap keep the sparse K-space tables;
4. accepts on the device: greedy takes the longest draft prefix matching
   the target argmax and emits the target's token at the first divergence
   (so output == plain greedy decode by construction); sampling runs
   speculative rejection sampling (accept d_i with probability
   min(1, p_i/q_i); on rejection resample from normalize(max(p - q, 0))),
   which preserves the target distribution exactly.

Nothing here syncs the host: no `.item()`, no `nonzero`, no boolean
indexing. Random draws take the engine's generator. The forward also
returns the block's final-layer hidden states, from which the draft-free
arm (spec/hidden.py) grows its next proposal block in the same program.

`VerifyProgram` holds one geometry's static buffers and its program
(engine/graphs.Program: a CUDA graph on a card unless the engine's graphs
are off, eager otherwise).
"""

from __future__ import annotations

import numpy as np
import torch

from k8s_llm_scheduler_tpu_torch.engine.graphs import Fence, host_buffer
from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig
from k8s_llm_scheduler_tpu_torch.models.llama import (
    Params,
    _dense,
    _layer,
    _logits,
    _mlp,
    _qkv,
    rope_inv_freq,
)
from k8s_llm_scheduler_tpu_torch.ops.attention import attend_part, merge_attention_parts
from k8s_llm_scheduler_tpu_torch.ops.prefix_attention import (
    NEG_INF,
    flash_prefix_attention_parts,
)

# Grammar implementations a verify program can run against. "dense" is
# greedy-only (the rejection sampler needs K-space proposal distributions);
# the decoder picks per engine state (SpeculativeDecoder._grammar_mode).
GRAMMAR_MODES = ("none", "sparse", "dense")


def _at(t: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """t[i, j, ...] at 0-dim device indices, through index_select: indexing
    with a 0-dim tensor may read it on the host."""
    for i in idx:
        t = t.index_select(0, i.reshape(1).long())[0]
    return t


@torch.no_grad()
def _forward_verify_block(
    params: Params,
    cfg: LlamaConfig,
    blk_tok,      # [W] int — [t_cur, d_1..d_K]
    positions,    # [W] absolute positions
    prefix_k, prefix_v,  # [L, Sp, n_kv, hd] shared dense prefix
    prefix_len,   # 0-dim int32
    k_cache, v_cache,    # [L, num_pages, ps, n_kv, hd], updated IN PLACE
    page_table,   # [1, P] — the slot's own-page table row
    own_len,      # 0-dim int32 — valid own tokens in pages (< positions[0])
    page_ids, offs,      # [W] scatter destinations of the block's K/V
):
    """Target forward over the block: (logits [W, V] f32, hidden [W, D],
    the final layer's pre-norm residual stream). The block's K/V lands in
    the paged caches in place, after each layer's attention."""
    W = blk_tok.shape[0]
    hd = cfg.head_dim
    ps = k_cache.shape[2]
    P = page_table.shape[1]
    dev = blk_tok.device
    inv_freq = rope_inv_freq(cfg, dev)
    pos_b = positions[None, :]
    x = params["embed"][blk_tok.long()][None]  # [1, W, D]
    own_mask = (torch.arange(P * ps, device=dev)[None, :] < own_len)[:, None, None, None, :]
    j = torch.arange(W, device=dev)
    blk_mask = (j[:, None] >= j[None, :])[None, None, None, :, :]
    table = page_table.long()
    pages, offsets = page_ids.long(), offs.long()
    eq = "bqkgh,bskh->bkgqs"
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        q, k, v = _qkv(lp, cfg, x, pos_b, inv_freq)
        qg = (q.float() * hd**-0.5).reshape(1, W, cfg.n_kv_heads, cfg.q_per_kv, hd)
        k_own = k_cache[i][table].reshape(1, P * ps, cfg.n_kv_heads, hd)
        v_own = v_cache[i][table].reshape(1, P * ps, cfg.n_kv_heads, hd)
        parts = [
            flash_prefix_attention_parts(q, prefix_k[i], prefix_v[i], prefix_len),
            attend_part(qg, k_own, v_own, own_mask, eq),
            attend_part(qg, k, v, blk_mask, eq),
        ]
        attn = merge_attention_parts(parts)  # [1, n_kv, g, W, hd]
        attn = torch.movedim(attn, 3, 1).reshape(1, W, cfg.n_heads * hd)
        x = x + _dense(attn.to(x.dtype), lp["wo"])
        x = x + _mlp(lp, cfg, x)
        k_cache[i].index_put_((pages, offsets), k[0].to(k_cache.dtype))
        v_cache[i].index_put_((pages, offsets), v[0].to(v_cache.dtype))
    return _logits(params, cfg, x[0]), x[0]


def _masked_target(
    logits_all,   # [W, V] f32
    mask_states,  # [W] — DFA state governing the token AFTER blk_tok[i]
    sp_tokens, sp_next,  # sparse tables (grammar == "sparse")
    dense_next,   # [S, V] dense table (grammar == "dense")
    pad_id: int,
    grammar: str,
    vocab_limit: int | None,
):
    """Grammar-mask every position's target distribution.

    Returns (masked [W, X], idx_to_tok) where idx_to_tok(i, k) maps a
    selection index in the masked space back to (token id, next DFA state),
    i and k 0-dim device tensors. X = vocab for "dense"/"none" (token id ==
    index), the grammar's K-width for "sparse"."""
    states = mask_states.long()
    if grammar == "dense":
        rows_all = dense_next[states]  # [W, V]
        masked = torch.where(rows_all >= 0, logits_all, NEG_INF)

        def idx_to_tok(i, k_idx):
            return k_idx, _at(rows_all, i, k_idx)
    elif grammar == "sparse":
        tok_rows = sp_tokens[states]   # [W, Kw]
        next_rows = sp_next[states]
        gathered = torch.gather(logits_all, 1, tok_rows.clamp(min=0).long())
        masked = torch.where(tok_rows >= 0, gathered, NEG_INF)

        def idx_to_tok(i, k_idx):
            return _at(tok_rows, i, k_idx), _at(next_rows, i, k_idx)
    elif grammar == "none":
        V = logits_all.shape[-1]
        ids = torch.arange(V, device=logits_all.device)[None, :]
        bad = ids == pad_id
        if vocab_limit is not None and vocab_limit < V:
            bad = bad | (ids >= vocab_limit)
        masked = torch.where(bad, NEG_INF, logits_all)

        def idx_to_tok(i, k_idx):
            return k_idx, _at(mask_states, i)
    else:
        raise ValueError(f"grammar must be one of {GRAMMAR_MODES}, got {grammar!r}")
    return masked, idx_to_tok


def _accept_block(
    masked,        # [W, X] grammar-masked target logits
    idx_to_tok,    # from _masked_target
    drafts,        # [K] proposed token ids (blk_tok[1:])
    choice_idx,    # [K] the draft's sampled index per step (rejection path)
    draft_logits,  # [K, X'] the draft's masked proposal logits (rejection path)
    gen, temperature: float,
    grammar: str,
    greedy: bool,
    sp_tokens=None, mask_states=None,  # sparse token rows (greedy map-back)
):
    """On-device acceptance over a masked block: (a — the accepted prefix
    length, t_next, st_next), 0-dim device tensors.

    Greedy: the longest draft prefix matching the target argmax, the
    target's token at the divergence. Sampling: speculative rejection
    sampling in the draft's proposal space (K-space under a sparse grammar,
    token space otherwise), its uniforms and its resample drawn from `gen`."""
    W = masked.shape[0]
    K = W - 1
    dev = masked.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    if greedy:
        tgt_k = torch.argmax(masked, dim=-1)  # [W]
        if grammar == "sparse":
            rows_all = sp_tokens[mask_states.long()]
            tgt_tok = torch.gather(rows_all, 1, tgt_k[:, None])[:, 0]
        else:
            tgt_tok = tgt_k
        if K > 0:
            match = (tgt_tok[:K] == drafts.to(tgt_tok.dtype)).long()
            a = torch.cumprod(match, 0).sum()
        else:
            a = zero
        t_next, st_next = idx_to_tok(a, _at(tgt_k, a))
        return a, t_next, st_next
    if grammar != "sparse" and K > 0:
        # Align vocab widths: the draft's padded vocab may differ from the
        # target's. Both maskings confine all legal mass below the
        # tokenizer's vocab, so the common width drops only zero-probability
        # columns. K == 0 (a block with no proposals) must not align: its
        # draft_logits is a [0, 1] placeholder.
        v_common = min(masked.shape[-1], draft_logits.shape[-1])
        masked = masked[:, :v_common]
        draft_logits = draft_logits[:, :v_common]
    t = max(temperature, 1e-6)
    p = torch.softmax(masked / t, dim=-1)  # [W, X]
    if K > 0:
        q = torch.softmax(draft_logits / t, dim=-1)  # [K, X]
        idx = choice_idx.long()[:, None]
        p_tok = torch.gather(p[:K], 1, idx)[:, 0]
        q_tok = torch.gather(q, 1, idx)[:, 0]
        u = torch.rand(K, generator=gen, device=dev)
        acc = (u * q_tok < p_tok).long()
        a = torch.cumprod(acc, 0).sum()
        # Rejection at position a: resample from the residual
        # normalize(max(p - q, 0)), which makes the emitted marginal exactly
        # the target's. All accepted (a == K): the bonus token samples from
        # the target directly.
        p_a = _at(p, a)
        q_a = _at(q, torch.clamp(a, max=K - 1))
        resid = torch.clamp(p_a - q_a, min=0.0)
        resid = torch.where(resid.sum() > 0, resid, p_a)
        dist = torch.where(a < K, resid, p_a)
    else:
        a = zero
        dist = p[0]
    k_choice = torch.multinomial(dist, 1, generator=gen)[0]
    t_next, st_next = idx_to_tok(a, k_choice)
    return a, t_next, st_next


@torch.no_grad()
def _verify_impl(
    params: Params,
    cfg: LlamaConfig,
    blk_tok,      # [W] — [t_cur, d_1..d_K]
    positions,    # [W]
    prefix_k, prefix_v, prefix_len,
    k_cache, v_cache,  # updated IN PLACE
    page_table, own_len, page_ids, offs,
    mask_states,   # [W] — DFA state governing the token AFTER blk_tok[i]
    choice_idx,    # [K] — the draft's sampled index per step (rejection path)
    draft_logits,  # [K, X] — the draft's masked proposal logits (rejection path)
    sp_tokens, sp_next,
    dense_next,    # [S, V] dense transition table (grammar == "dense")
    pad_id: int,
    gen, temperature: float,
    grammar: str,
    greedy: bool,
    vocab_limit: int | None = None,
):
    """Score + accept in one program: (a, t_next, st_next), 0-dim device
    tensors. See the module doc for the contract."""
    logits_all, _x = _forward_verify_block(
        params, cfg, blk_tok, positions, prefix_k, prefix_v, prefix_len,
        k_cache, v_cache, page_table, own_len, page_ids, offs,
    )
    masked, idx_to_tok = _masked_target(
        logits_all, mask_states, sp_tokens, sp_next, dense_next, pad_id, grammar,
        vocab_limit,
    )
    return _accept_block(
        masked, idx_to_tok, blk_tok[1:], choice_idx, draft_logits, gen, temperature,
        grammar, greedy, sp_tokens=sp_tokens, mask_states=mask_states,
    )


def _int32s(*scalars: torch.Tensor) -> torch.Tensor:
    """0-dim device tensors as one int32 vector."""
    return torch.stack([t.reshape(()).to(torch.int32) for t in scalars])


class VerifyProgram:
    """One verify geometry of a decoder: its static buffers and its
    program, a CUDA graph on a card with the engine's graphs on (captured
    at its first run), eager otherwise. The decoder keys it by (W, grammar
    mode, greedy, the prefix buffer's length, the grammar tables' shapes,
    the proposal space's width, guesses made); it reads the engine's static
    prefix buffer of that length and the grammar tables of those shapes,
    whose addresses stay put.

    Each round the decoder writes the host-side inputs (the block's
    positions, page ids and offsets, the slot's page-table row, own_len,
    and the block's first token and state) through a pinned buffer in one
    non-blocking copy (`load_host`), and the device-side ones (the proposed
    tokens and states, choice indices and proposal logits) by device copies
    into `blk_tok`, `mask_states`, `choice_idx` and `q_logits`; then
    `run()`. The outputs: `out` = [a, t_next, st_next] and, for the hidden
    arm, the next block's guesses [g_toks, g_states, g_idx], with their
    masked logits in `g_logits`."""

    def __init__(self, eng, W: int, grammar: str, greedy: bool,
                 x_width: int, prefix, dense_next: torch.Tensor,
                 hidden_head: Params | None = None, n_guess: int = 0) -> None:
        dev = eng.device
        self.W, self.grammar, self.greedy = W, grammar, greedy
        self.n_guess = n_guess
        self._eng = eng
        self._prefix = prefix
        self._dense = dense_next
        self._ht = hidden_head
        P = eng.kv.max_pages_per_seq
        K = W - 1
        bounds = np.cumsum([0, W, W, W, P, 1, 1, 1])
        self.host = host_buffer((int(bounds[-1]),), torch.int32, dev)
        self._staged = Fence(dev)  # the last copy out of `host` ran
        self.inputs = torch.zeros(int(bounds[-1]), dtype=torch.int32, device=dev)
        sl = [self.inputs[bounds[i]:bounds[i + 1]] for i in range(7)]
        self.positions, self.page_ids, self.offs = sl[0], sl[1], sl[2]
        self.table_row = sl[3].view(1, P)
        self.own_len = sl[4].view(())
        self.tok0, self.st0 = sl[5], sl[6]
        self._bounds = bounds
        self.blk_tok = torch.zeros(W, dtype=torch.int32, device=dev)
        self.mask_states = torch.zeros(W, dtype=torch.int32, device=dev)
        self.choice_idx = torch.zeros(K, dtype=torch.int32, device=dev)
        self.q_logits = torch.zeros((K, x_width if K else 1), dtype=torch.float32,
                                    device=dev)
        self.out = torch.zeros(3 + 3 * n_guess, dtype=torch.int32, device=dev)
        self.g_logits = torch.zeros((n_guess, x_width), dtype=torch.float32, device=dev)
        name = (f"{'hidden ' if n_guess else ''}verify W={W} {grammar} "
                f"{'greedy' if greedy else 'sampled'}")
        self.program = eng._graphs.program(name, self._run)

    def load_host(self, positions, page_ids, offs, table_row, own_len: int,
                  tok0: int = 0, st0: int = 0) -> None:
        """The round's host-side inputs into the static buffer: one
        non-blocking copy from pinned memory, once the previous copy out of
        it has run."""
        self._staged.synchronize()
        h, b = self.host.numpy(), self._bounds
        for i, part in enumerate((positions, page_ids, offs, table_row,
                                  (own_len,), (tok0,), (st0,))):
            h[b[i]:b[i + 1]] = part
        self.inputs.copy_(self.host, non_blocking=True)
        self._staged.record()

    def run(self) -> None:
        self.program.run()

    @torch.no_grad()
    def _run(self) -> None:
        eng, pfx = self._eng, self._prefix
        common = (
            self.blk_tok, self.positions, pfx.k, pfx.v, eng._plen_d, eng.kv.k, eng.kv.v,
            self.table_row, self.own_len, self.page_ids, self.offs, self.mask_states,
            self.choice_idx, self.q_logits, eng._sp_tokens, eng._sp_next, self._dense,
            eng.tokenizer.pad_id, eng._gen, eng.temperature, self.grammar, self.greedy,
        )
        if self.n_guess:
            from k8s_llm_scheduler_tpu_torch.spec.hidden import _hidden_verify_impl

            a, t_next, st_next, g_toks, g_states, g_idx, g_logits = _hidden_verify_impl(
                eng.params, eng.cfg, self._ht, *common, self.n_guess,
                vocab_limit=eng._vocab_limit,
            )
            self.out.copy_(torch.cat([_int32s(a, t_next, st_next), g_toks, g_states, g_idx]))
            self.g_logits.copy_(g_logits)
            return
        a, t_next, st_next = _verify_impl(
            eng.params, eng.cfg, *common, vocab_limit=eng._vocab_limit)
        self.out.copy_(_int32s(a, t_next, st_next))
