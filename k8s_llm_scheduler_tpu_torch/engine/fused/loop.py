"""The fused decode loop (the port of the JAX package's engine/fused/loop.py).

Where the chunked path (engine/engine.py `_ChunkVariant`) runs a FIXED
`n_steps` steps, this loop exits early: before every step it re-checks
per-slot liveness (`act & budget > 0`), so a batch that stops at step 3 of a
16-step chunk pays 3 model calls, and the over-dispatch the pipelined harvest
relies on (decode_fused queues ceil(budget / chunk) chunks back to back and
syncs once a chunk) costs next to nothing past the finish line.

The JAX chunk is one `lax.while_loop` program. The port's is one CUDA graph
on a card, one host launch a chunk: set-up, a conditional WHILE node whose
body is one step and whose condition a kernel sets on the device
(engine/graphs.GraphRunner.while_live, csrc/graph_cond.cu), and one flush.
Eagerly (off a card, `graphs=False`) the condition is a host test.

Everything the JAX body does happens inside the step:
- the step's forward (models/llama.forward_decode_fused_body, the same
  3-part cascade the chunked path runs, which makes greedy output
  token-identical between the paths),
- on-device sampling (engine/fused/sampler.py) from step `j`'s row of the
  uniforms drawn with the engine's generator before the loop (`fused_draw`:
  under capture the step is a WHILE body, whose every iteration replays the
  same random draw),
- grammar via ONE dense-table gather (engine/fused/tables.py),
- per-slot stop detection (EOS / DFA done / budget exhaustion),
- KV append into the chunk buffer, flushed to the PAGED cache in one
  scatter after the loop (the chunked path's flush).

Emissions land in a fixed [M, n_steps] buffer (pad_id holes past each slot's
stop); the step counter `j` reports the steps actually run, so the host's
token accounting stays exact under early exit. All state is updated IN
PLACE: the slot state, the paged caches and the buffers below (the graphs
read them by address).
"""

from __future__ import annotations

import torch

from k8s_llm_scheduler_tpu_torch.engine.fused.sampler import sample_fused
from k8s_llm_scheduler_tpu_torch.models.llama import forward_decode_fused_body


@torch.no_grad()
def fused_begin(prefix_len, state, buf, pad_id: int) -> None:
    """Start a chunk: `own_start` (tokens already in own pages); clear the
    chunk buffer, its tails, the emissions and the step counter."""
    buf.own_start.copy_(state.pos - prefix_len)
    buf.ck.zero_()
    buf.cv.zero_()
    buf.tail.zero_()
    buf.toks.fill_(pad_id)
    buf.j.zero_()


@torch.no_grad()
def fused_draw(buf, gen, temperature: float) -> None:
    """Draw the chunk's uniforms `buf.u` [n_steps, M], one a step and slot,
    outside the loop's body (nothing when greedy)."""
    if temperature > 0:
        buf.u.uniform_(generator=gen)


def step_uniforms(buf, temperature: float) -> torch.Tensor | None:
    """Step `buf.j`'s row of the chunk's uniforms [M] (None when greedy)."""
    if temperature > 0:
        return buf.u.index_select(0, buf.j.view(1))[0]
    return None


@torch.no_grad()
def fused_gather(k_cache, v_cache, page_tables, buf) -> None:
    """Freeze the pages for the chunk: gather them dense once (own_impl
    "dense")."""
    tables = page_tables.view(-1)
    for cache, own in ((k_cache, buf.k_own), (v_cache, buf.v_own)):
        torch.index_select(cache, 1, tables, out=own)


@torch.no_grad()
def fused_step(
    params, cfg, k_cache, v_cache, page_tables, prefix_k, prefix_v, prefix_len,
    state, buf, dense_next, done_state, eos_id: int, pad_id: int, gen,
    temperature: float, top_k: int, constrained: bool, own_impl: str,
    vocab_limit: int | None = None,
) -> None:
    """One loop step: the forward of every slot's current token, one sampled
    token per live slot (pad elsewhere) written at column `j`, and the slot
    state advanced in place. own_impl "dense" reads the gathered pages,
    "pallas" streams the paged caches through K4."""
    M, P = page_tables.shape
    L, _, ps, n_kv, hd = k_cache.shape
    if own_impl == "pallas":
        k_own, v_own = k_cache, v_cache
    else:
        k_own = buf.k_own.view(L, M, P * ps, n_kv, hd)
        v_own = buf.v_own.view(L, M, P * ps, n_kv, hd)
    s = state
    act_eff = s.act & (s.budget > 0)
    logits, _, _ = forward_decode_fused_body(
        params, cfg, s.tok, s.pos, k_own, v_own, buf.own_start,
        buf.ck, buf.cv, buf.tail, prefix_k, prefix_v, prefix_len,
        page_tables=page_tables, own_impl=own_impl,
    )
    nxt, new_st = sample_fused(
        logits, s.st, dense_next, gen, temperature, top_k, constrained, pad_id,
        vocab_limit, u=step_uniforms(buf, temperature),
    )
    emitted = torch.where(act_eff, nxt, pad_id)
    new_st = torch.where(act_eff, new_st, s.st)
    finished = (new_st == done_state) | (nxt == eos_id)
    buf.toks.index_copy_(1, buf.j.view(1), emitted[:, None])
    s.tok.copy_(emitted)
    s.st.copy_(new_st)
    s.act.copy_(act_eff & ~finished)
    s.budget.copy_(torch.where(act_eff, s.budget - 1, s.budget))
    s.pos.copy_(torch.where(act_eff, s.pos + 1, s.pos))
    buf.tail.copy_(torch.where(act_eff, buf.tail + 1, buf.tail))
    buf.j.add_(1)


@torch.no_grad()
def fused_flush(k_cache, v_cache, page_tables, buf) -> None:
    """The chunk buffer into pages: entry j of slot m lands at own position
    own_start[m] + j; invalid entries (j >= tail) go to scratch page 0
    (duplicates there are harmless: nothing reads it)."""
    P = page_tables.shape[1]
    ps = k_cache.shape[2]
    n_steps = buf.ck.shape[2]
    j = torch.arange(n_steps, device=buf.ck.device)
    own_pos = buf.own_start[:, None].long() + j[None, :]
    valid = j[None, :] < buf.tail[:, None]
    page_slot = torch.clamp(own_pos // ps, 0, P - 1)
    page_ids = torch.gather(page_tables.long(), 1, page_slot)
    page_ids = torch.where(valid, page_ids, 0)
    offs = torch.where(valid, own_pos % ps, 0)
    k_cache[:, page_ids, offs] = buf.ck
    v_cache[:, page_ids, offs] = buf.cv


def fused_decode_chunk_impl(
    params,
    cfg,
    k_cache, v_cache,    # paged caches, updated IN PLACE
    page_tables,         # [M, P] own-page tables (trash row included)
    prefix_k, prefix_v,  # [L, Sp, n_kv, hd] shared dense prefix KV
    prefix_len,          # 0-dim int32
    state,               # per-slot state [M] (tok, pos, act, st, budget), IN PLACE
    buf,                 # chunk buffers (ck, cv, tail, own_start, toks, j, u, k_own, v_own)
    dense_next,          # [S, V] int32 dense grammar table (-1 disallowed)
    done_state,          # 0-dim int32
    eos_id: int,
    pad_id: int,
    gen,
    temperature: float,
    n_steps: int,
    constrained: bool,
    top_k: int,
    paged_attn: str = "gather",  # "gather" | "pallas"
    vocab_limit: int | None = None,
    *,
    runner,              # engine/graphs.GraphRunner: the conditional nodes
    gate=None,           # 0-dim bool: no step runs while it is false
) -> None:
    """Up to `n_steps` fused decode steps with early exit: the emissions in
    `buf.toks` [M, n_steps], the steps run in `buf.j`. Paged-cache traffic
    is hoisted as in the chunked path: pages frozen for the chunk
    ("gather" pre-gathers them dense, "pallas" streams them through K4),
    new K/V in the chunk buffer, ONE scatter after the loop. The steps are
    `runner.while_live`'s body (a WHILE node under capture), and the gather
    is guarded by `runner.when_live`: a chunk on a finished batch copies no
    page."""
    fused_begin(prefix_len, state, buf, pad_id)
    fused_draw(buf, gen, temperature)
    own_impl = "pallas" if paged_attn == "pallas" else "dense"
    if own_impl == "dense":
        runner.when_live(state.act, state.budget,
                         lambda: fused_gather(k_cache, v_cache, page_tables, buf), gate)

    def step() -> None:
        fused_step(
            params, cfg, k_cache, v_cache, page_tables, prefix_k, prefix_v,
            prefix_len, state, buf, dense_next, done_state, eos_id, pad_id, gen,
            temperature, top_k, constrained, own_impl, vocab_limit,
        )

    runner.while_live(state.act, state.budget, step, buf.j, n_steps, gate)
    fused_flush(k_cache, v_cache, page_tables, buf)
