"""Draft runner: the small model that speculates K tokens ahead (the port
of the JAX package's spec/draft.py).

The draft is a full (small) Llama kept in a DENSE per-request KV buffer
rather than the paged cache: draft KV at distill scale is a few MB,
rollback is host bookkeeping (stale entries past the accepted prefix are
never attended because every step masks by position), and the buffer
never contends with the target's page pool.

A proposal (`_propose_impl`) is K+1 single-token decode steps with the
sampling and the DFA transitions on the device, so it never syncs the
host: the tokens it returns feed the target's verify directly. It runs
eagerly (its CUDA graph is queued in ROADMAP.md). Each step samples
through the SAME sparse tables the target uses, so a draft proposal is
grammar-legal by construction. Random draws take the engine's generator.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from k8s_llm_scheduler_tpu_torch.engine.engine import _pick
from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig
from k8s_llm_scheduler_tpu_torch.models.llama import (
    Params,
    _dense,
    _layer,
    _logits,
    apply_rope,
    forward_prefill,
    init_params,
    rms_norm,
    rope_inv_freq,
)
from k8s_llm_scheduler_tpu_torch.ops.attention import NEG_INF


def build_random_draft(
    draft_cfg: LlamaConfig, tokenizer_vocab: int, seed: int,
    device: str | torch.device = "cuda",
) -> tuple[Params, LlamaConfig]:
    """Random-init a named draft config, widened to cover the tokenizer.

    The single widening rule: a draft narrower than the tokenizer cannot
    propose every legal token, so its vocab pads up to the next multiple of
    128 at or above the tokenizer's. Serving (engine/local._attach_spec)
    builds through here."""
    if draft_cfg.vocab_size < tokenizer_vocab:
        draft_cfg = dataclasses.replace(
            draft_cfg, vocab_size=-(-tokenizer_vocab // 128) * 128
        )
    return init_params(draft_cfg, seed=seed, device=device), draft_cfg


@torch.no_grad()
def _draft_token_step(
    params: Params,
    cfg: LlamaConfig,
    tok,      # 0-dim int — the token being processed
    pos: int,  # its absolute position (== dense-buffer index)
    k_buf, v_buf,  # [L, cap, n_kv, hd], written IN PLACE
):
    """One draft decode step: write the token's K/V at `pos`, attend over
    buffer[0..pos], return logits [V] f32."""
    hd = cfg.head_dim
    dev = k_buf.device
    inv_freq = rope_inv_freq(cfg, dev)
    position = torch.full((), pos, dtype=torch.int32, device=dev)
    x = params["embed"].index_select(0, tok.reshape(1).long())[0]  # [D]
    cap = k_buf.shape[1]
    mask = (torch.arange(cap, device=dev) <= pos)[None, None, :]
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q = apply_rope(_dense(h, lp["wq"]).reshape(cfg.n_heads, hd), position, inv_freq)
        k = apply_rope(_dense(h, lp["wk"]).reshape(cfg.n_kv_heads, hd), position, inv_freq)
        v = _dense(h, lp["wv"]).reshape(cfg.n_kv_heads, hd)
        k_buf[i, pos] = k.to(k_buf.dtype)
        v_buf[i, pos] = v.to(v_buf.dtype)
        qg = (q.float() * hd**-0.5).reshape(cfg.n_kv_heads, cfg.q_per_kv, hd)
        logits = torch.einsum("kgh,skh->kgs", qg, k_buf[i].float())
        w = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        attn = torch.einsum("kgs,skh->kgh", w, v_buf[i].float())
        x = x + _dense(attn.reshape(cfg.n_heads * hd).to(x.dtype), lp["wo"])
        h2 = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        gate = _dense(h2, lp["w_gate"])
        up = _dense(h2, lp["w_up"])
        x = x + _dense(F.silu(gate.float()).to(x.dtype) * up, lp["w_down"])
    return _logits(params, cfg, x)


@torch.no_grad()
def _propose_impl(
    params: Params,
    cfg: LlamaConfig,
    k_buf, v_buf,  # [L, cap, n_kv, hd], written IN PLACE
    tok,     # 0-dim int — the last emitted token (its KV not yet written)
    pos: int,  # its absolute position
    state,   # 0-dim int — the DFA state after `tok`
    sp_tokens, sp_next,  # sparse grammar tables (unused when unconstrained)
    pad_id: int,
    gen, temperature: float,
    K: int,
    constrained: bool,
    vocab_limit: int | None = None,
):
    """Propose K draft tokens in K+1 steps, no host sync.

    Step i processes the (i-1)-th proposal (step 0 processes `tok`), writes
    its K/V into the dense buffer, samples proposal i from the grammar- (or
    pad-)masked logits and advances the DFA state. Returns (tokens [K+1],
    states [K+1] — the state AFTER each proposal, choice_idx [K] — the
    sampled index into the step's masked distribution, step_logits [K, X] —
    that masked distribution's logits, X = the grammar's K-width when
    constrained, the draft's vocab when not).

    The extra step processes the K-th proposal itself, so the buffer holds
    valid KV through position pos+K (a fully accepted round needs it), and
    its sample is the draft's guess at the round's bonus token: the
    decoder anchors the AHEAD proposal for the next round on it."""
    toks, states, idxs, step_logits = [], [], [], []
    tok = tok.reshape(()).to(torch.int32)
    st = state.reshape(()).to(torch.int32)
    for i in range(K + 1):
        logits = _draft_token_step(params, cfg, tok, pos + i, k_buf, v_buf)
        if constrained:
            rows = sp_tokens.index_select(0, st.reshape(1).long())[0]  # [Kw]
            nrow = sp_next.index_select(0, st.reshape(1).long())[0]
            masked = torch.where(rows >= 0, logits[rows.clamp(min=0).long()], NEG_INF)
            k_idx = _pick(masked[None, :], gen, temperature)[0]
            nxt_tok = rows.index_select(0, k_idx.reshape(1).long())[0]
            nxt_st = nrow.index_select(0, k_idx.reshape(1).long())[0]
        else:
            V = logits.shape[-1]
            ids = torch.arange(V, device=logits.device)
            bad = ids == pad_id
            if vocab_limit is not None and vocab_limit < V:
                bad = bad | (ids >= vocab_limit)
            masked = torch.where(bad, NEG_INF, logits)
            k_idx = _pick(masked[None, :], gen, temperature)[0]
            nxt_tok, nxt_st = k_idx, st
        tok, st = nxt_tok.to(torch.int32), nxt_st.to(torch.int32)
        toks.append(tok)
        states.append(st)
        idxs.append(k_idx.to(torch.int32))
        step_logits.append(masked)
    return (torch.stack(toks), torch.stack(states), torch.stack(idxs[:K]),
            torch.stack(step_logits[:K]))


@torch.no_grad()
def _prefill_impl(params, cfg, tokens, n: int, k_buf, v_buf) -> None:
    """Prefill the draft's dense buffer with the prompt's KV, in place
    (bucketed [1, S] tokens; rows >= n are padding, overwritten or masked
    later)."""
    dev = tokens.device
    _, k_all, v_all = forward_prefill(
        params, cfg, tokens, torch.full((1,), n, dtype=torch.int32, device=dev),
        return_logits=False,
    )
    S = tokens.shape[1]
    k_buf[:, :S] = k_all[:, 0].to(k_buf.dtype)
    v_buf[:, :S] = v_all[:, 0].to(v_buf.dtype)


class DraftRunner:
    """Per-request draft state over one small model.

    Single-owner like the engine; one request in flight at a time (the spec
    path serves `generate()`). `begin()` prefills the full prompt (shared
    prefix included: the draft holds its own dense KV, it does not read the
    target's buffers); `propose()` runs the K+1-step proposal; rollback is
    implicit (host position bookkeeping)."""

    CAP_ROUND = 256  # dense-buffer size bucket

    def __init__(self, params: Params, cfg: LlamaConfig, *,
                 vocab_limit: int | None = None, prefill_round: int = 128) -> None:
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.vocab_limit = vocab_limit
        self.prefill_round = int(prefill_round)
        self._k: torch.Tensor | None = None
        self._v: torch.Tensor | None = None
        self._cap = 0

    @property
    def capacity(self) -> int:
        """Current dense-buffer capacity in tokens (0 before begin()): the
        decoder checks AHEAD proposals against it instead of letting
        propose() raise mid-round."""
        return self._cap

    def begin(self, token_ids: list[int], pad_id: int, extra: int) -> None:
        """Start a request: allocate the dense buffer sized for
        `len(token_ids) + extra` tokens (bucketed) and prefill the prompt.
        `token_ids` is the FULL context (engine prefix tokens + request
        suffix); `extra` covers max_new + K + slack."""
        total = len(token_ids)
        cap = -(-(total + extra) // self.CAP_ROUND) * self.CAP_ROUND
        shape = (self.cfg.n_layers, cap, self.cfg.n_kv_heads, self.cfg.head_dim)
        if self._k is None or self._cap != cap:
            self._cap = cap
            self._k = torch.zeros(shape, dtype=self.cfg.dtype, device=self.device)
            self._v = torch.zeros(shape, dtype=self.cfg.dtype, device=self.device)
        bucket = -(-total // self.prefill_round) * self.prefill_round
        assert bucket <= cap, (bucket, cap)
        tokens = torch.full((1, bucket), pad_id, dtype=torch.int32)
        tokens[0, :total] = torch.tensor(token_ids, dtype=torch.int32)
        _prefill_impl(self.params, self.cfg, tokens.to(self.device), total, self._k, self._v)

    def propose(self, tok, pos: int, state, sp_tokens, sp_next, pad_id: int,
                gen, temperature: float, k: int, constrained: bool):
        """The K+1-step proposal from (tok @ pos, DFA state): the device
        tensors of _propose_impl (no host sync: the verifier consumes them
        directly). `tok` and `state` are 0-dim device tensors (an AHEAD
        proposal anchors on the previous proposal's guess without fetching
        it); `pos` is a host int, checked here against the buffer."""
        if self._k is None:
            raise RuntimeError("DraftRunner.begin() not called")
        if pos + k + 1 > self._cap:  # K+1 steps write pos..pos+K
            raise RuntimeError(
                f"draft buffer overflow: pos {pos} + K+1 {k + 1} > cap {self._cap}"
            )
        return _propose_impl(
            self.params, self.cfg, self._k, self._v, tok, pos, state,
            sp_tokens, sp_next, pad_id, gen, temperature, k, constrained,
            vocab_limit=self.vocab_limit,
        )
