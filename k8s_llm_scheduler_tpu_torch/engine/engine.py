"""The inference engine: shared-prefix prefill, decision waves and the
paged general-completion path (the port of the JAX package's
engine/engine.py).

- **Shared-prefix (cascade) prefill**: a scheduling burst shares its
  (system + cluster-state) prompt prefix (core/prompt.py). The prefix
  prefills ONCE per cluster snapshot into a dense KV buffer and every wave
  or decode step attends it. Prefixes longer than one chunk prefill
  blockwise (`_prefill_prefix_chunked`), each chunk attending the KV
  accumulated so far, seeded from the cached prefix with the longest common
  prefix (`_best_lcp_seed`). Recent prefixes stay cached under a byte budget.
- **Decision waves** (`submit_wave` / `harvest_wave`): the whole batch's
  suffix prefill, then grammar-accelerated block decode to completion. Each
  iteration samples one token from the carried logits, expands the forced
  run that follows through DFA table lookups (no model call), and runs one
  block-wide mini-prefill (models/llama.forward_block_decode; with
  decode_matmul="ragged" its matmuls run K3 over the valid tokens only).
  Where the JAX engine runs the wave as ONE compiled program (a
  `lax.while_loop` with its early exit on the device), the port runs two
  programs over static buffers per wave geometry (`_WaveVariant`),
  captured as CUDA graphs on a card (engine/graphs.py): the suffix prefill,
  and one block iteration replayed at most `n_iters` times. The host reads
  iteration i's "any row alive" flag while iteration i+1 runs, so the
  device never waits on the host and at most one iteration runs past the
  last live one (it emits only pads and is not counted). That host loop
  runs on the engine's wave dispatcher thread, not the caller's:
  `submit_wave` stages the wave, hands it over and returns at once, as the
  JAX engine's returns without a sync; waves dispatch in FIFO order, each
  against the prefix and grammar it was submitted under. Every other entry
  point first waits until the dispatcher has queued all the waves
  submitted before it (`_await_dispatch`); from there on the order of the
  device's one stream keeps each wave's buffers from later writes.
- **General completion** (`add_requests` / `step` / `generate`): a fixed
  decode batch of `max_slots` slots over the paged KV cache
  (engine/kv_cache.py). Admission prefills a batch of suffixes against the
  prefix, scatters their KV into pages and samples each first token; a step
  runs `chunk_steps` decode steps with the new KV in a small chunk buffer,
  flushed into pages once per chunk, then syncs once. Own-token attention
  either gathers the pages once per chunk (paged_attn="gather") or streams
  them through K4 every step (paged_attn="pallas"). Per-slot state lives on
  the device with a trash row M = max_slots that admission padding writes;
  the chunk (`_ChunkVariant`) updates it in place and is one CUDA graph on
  a card.
- **Static buffers, one switch**: the graphs read the active prefix's KV,
  its length, the grammar tables and the page tables by address, so each
  has a static buffer that a switch copies into (the prefix one per buffer
  length Sp, the grammar one per table shape). `graphs=False` runs the
  same static-buffer code eagerly (the counterpart of `jax.disable_jit`);
  off a card there are no graphs.
- **Sparse grammar tables** (engine/constrained.py): sampling in K-space,
  vocab-independent.
- **Admission plane** (engine/admission/): `admit_packed` packs a batch's
  suffixes into one token stream cut into `admission_chunk_tokens` chunks
  with block-diagonal attention (models/llama.forward_prefill_packed, its
  prefix part through K1), and piggybacks a decode chunk between pack
  chunks; the piggybacked chunks' tokens are parked and harvested at the
  next `step()`. Pack chunks run eagerly, as the chunked prefix prefill
  does. `pin_prefix` keeps a prefix cache entry resident, exempt from byte
  eviction: the pinned snapshot that delta prompts (sched/delta.py)
  LCP-seed from.

- **Fused decode** (engine/fused/): `step_fused` / `decode_fused` run
  chunks of up to `chunk_steps` steps that exit early on the device once no
  slot is live (the steps are a conditional WHILE node's body,
  engine/graphs.GraphRunner.while_live), sampling with top-k and the grammar
  as a dense transition table; `generate` and the backend's packs decode
  through them. A grammar whose dense table passes `fused_table_bytes`
  (any decision grammar at a 128k vocab), or `fused_decode=False`, falls
  back to `step()` and counts `fused_fallbacks`, as in the JAX engine.
- **Persistent serving loop** (engine/persistent/): `enter_persistent`
  hands the slots to a resident thread that serves admissions from a
  command ring and streams emissions into a token ring; `step_persistent`
  harvests. Dispatch-path entry points drain it first, as the JAX ones do.

- **Speculative decoding** (spec/): `attach_spec` hands `generate` to a
  SpeculativeDecoder, which drives one request's slot itself
  (`_Request.external`: every harvest path skips it) and finishes it
  through `release_slot`, or hands it back to the fused runtime.
- **Profiler** (observability/profiler.py): `attach_profiler` hands the
  engine an EngineProfiler. Waves, packs, fused harvests, resident
  harvests and prefix prefills then book their fences into it, as the JAX
  engine's do. The fences read perf_counter on the owner thread and query
  CUDA events; none synchronizes. The wave dispatcher only stamps the end
  of a wave's dispatch on its handle (`dispatch_end`), and harvest_wave
  books it. Without a profiler each of them pays one None check.
- **Tensor parallel** (engine/sharded/plane.py, parallel/): `mesh=` with a
  tp axis wider than 1 makes the engine ONE RANK of a tp group: `params`
  is the rank's shard, `cfg` the rank's geometry (plane.local_config),
  `model_config` the whole model's, and every forward joins the ranks
  through the plane's all-reduces. A driver rank mirrors its public calls
  to the follower ranks (parallel/launch.RankGroup). At tp > 1:
  - the hot swap copies each rank's own block, restored by that rank from
    the checkpoint (parallel/launch.stage_swap / install_swap /
    donate_swap, run on every rank through RankGroup.on_ranks;
    rollout/hotswap.HotSwapper(mesh=)); `swap_params` itself takes a
    rank's block, and the driver refuses a call made of it alone;
  - the prefix-KV plane ships the whole model's kv heads: a `host` export
    gathers the ranks' head blocks into the driver's host memory, and its
    adoption hands each rank its own block over the tp group
    (`_adopt_head_blocks`); a `d2d` export leaves each rank's block in
    that rank's export table (`export_prefix_blocks`), and its adoption
    has each rank copy the filler's same-rank block device to device
    (`_adopt_block`), no byte through the driver or a collective;
  - the persistent loop runs a resident thread on every rank, the
    driver's deciding every iteration (engine/persistent/server.py);
  - `decode_matmul="ragged"` is refused as in the JAX engine, CUDA graphs
    over a gloo group too, and speculative decoding (`attach_spec`) raises
    NotImplementedError naming ROADMAP queue 1 item 9d, as the JAX entry
    point keeps plain decode on a tp mesh.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Any

import numpy as np
import torch

from k8s_llm_scheduler_tpu_torch.engine.backend import BackendError
from k8s_llm_scheduler_tpu_torch.engine.constrained import (
    DecisionDFA,
    sparse_tables,
    wave_iterations,
)
from k8s_llm_scheduler_tpu_torch.engine.fused import (
    DENSE_TABLE_MAX_BYTES,
    dense_tables,
    fused_decode_chunk_impl,
)
from k8s_llm_scheduler_tpu_torch.engine.fused.loop import fused_begin, fused_flush, fused_gather
from k8s_llm_scheduler_tpu_torch.engine.graphs import (
    DEVICE_WIDE,
    Fence,
    GraphRunner,
    Program,
    host_buffer,
)
from k8s_llm_scheduler_tpu_torch.engine.kv_cache import PagedKVCache
from k8s_llm_scheduler_tpu_torch.engine.persistent.ring import OP_ADMIT
from k8s_llm_scheduler_tpu_torch.engine.sharded.plane import build_plane
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer, Tokenizer
from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig
from k8s_llm_scheduler_tpu_torch.models.llama import (
    Params,
    forward_block_decode,
    forward_decode_buffered,
    forward_prefill,
    forward_prefill_suffix,
    forward_prefill_suffix_dense,
)
from k8s_llm_scheduler_tpu_torch.observability.resident import (
    CTR_ADMITS,
    CTR_IDLE_CHUNKS,
    CTR_ITERS,
    CTR_STEPS,
    N_COUNTERS,
    counters_dict,
)
from k8s_llm_scheduler_tpu_torch.ops.attention import NEG_INF

logger = logging.getLogger(__name__)

# Length of the all-zero prefix buffer used when no prefix is installed
# (the JAX engine's page size).
EMPTY_PREFIX_SLOTS = 64
# The ROADMAP queue 1 item that ports the path tp > 1 still refuses
# (speculative decoding).
TP_PENDING_ITEM = "9d"


def _pick(masked, gen, temperature):
    """temperature > 0 -> categorical, else argmax (first maximum), over
    masked f32 logits."""
    if temperature > 0:
        probs = torch.softmax(masked / max(temperature, 1e-6), dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].int()
    return torch.argmax(masked, dim=-1).int()


def _sample_unconstrained(logits, pad_id, gen, temperature, vocab_limit=None):
    """Full-vocab sampling with pad excluded (pad is the idle-row emission
    sentinel); `vocab_limit` also masks ids the tokenizer cannot decode."""
    V = logits.shape[-1]
    ids = torch.arange(V, device=logits.device)[None, :]
    bad = ids == pad_id
    if vocab_limit is not None and vocab_limit < V:
        bad = bad | (ids >= vocab_limit)
    return _pick(torch.where(bad, NEG_INF, logits), gen, temperature)


def _sample_sparse(logits, tok_rows, next_rows, gen, temperature):
    """Grammar sampling in K-space: gather the allowed tokens' logits, pick
    among them, map back to (token id, next DFA state).

    logits [R, V]; tok_rows/next_rows [R, K] (-1 padded)."""
    gathered = torch.gather(logits, 1, tok_rows.clamp(min=0).long())
    masked = torch.where(tok_rows >= 0, gathered, NEG_INF)
    k = _pick(masked, gen, temperature).long()[:, None]
    tok = torch.gather(tok_rows, 1, k)[:, 0]
    nxt = torch.gather(next_rows, 1, k)[:, 0]
    return tok.int(), nxt.int()


@dataclasses.dataclass
class _SlotState:
    """Per-slot decode state on the device, [max_slots + 1] each: row M is
    the trash row that admission padding writes and that never activates."""

    tok: torch.Tensor    # int32 current token
    pos: torch.Tensor    # int32 absolute position of that token
    act: torch.Tensor    # bool active
    st: torch.Tensor     # int32 DFA state
    budget: torch.Tensor  # int32 tokens it may still emit
    first: torch.Tensor  # int32 first token sampled at admission

    @classmethod
    def zeros(cls, rows: int, device) -> "_SlotState":
        def z(dtype=torch.int32):
            return torch.zeros(rows, dtype=dtype, device=device)

        return cls(z(), z(), z(torch.bool), z(), z(), z())


def _admit_rows(
    state: _SlotState, logits, slot_ids, pos, real, budgets,
    sp_tokens, sp_next, done_state: int, eos_id: int, pad_id: int,
    dfa_start: int, gen, temperature: float, constrained: bool,
    vocab_limit: int | None = None,
) -> None:
    """The first token of each admitted row, sampled from its prefill
    logits [R, V], and its slot's state set IN PLACE (the decode chunk's
    graph reads it by address): token, position `pos`, active, DFA state,
    budget and first token. Rows that are not `real` (padding) write the
    trash row and never activate it."""
    R = logits.shape[0]
    start_vec = torch.full((R,), dfa_start, dtype=torch.int32, device=logits.device)
    if constrained:
        first_new, st_new = _sample_sparse(
            logits, sp_tokens[start_vec], sp_next[start_vec], gen, temperature
        )
    else:
        first_new = _sample_unconstrained(logits, pad_id, gen, temperature, vocab_limit)
        st_new = start_vec
    finished = (first_new == eos_id) | (st_new == done_state)
    rows = slot_ids.long()
    state.tok[rows] = first_new
    state.pos[rows] = pos
    state.act[rows] = real & ~finished
    state.st[rows] = st_new
    state.budget[rows] = budgets
    state.first[rows] = first_new


@torch.no_grad()
def _admit_impl(
    params: Params,
    cfg: LlamaConfig,
    tokens,        # [R, Ss] suffix tokens (R = admission-row bucket)
    suffix_lens,   # [R] int32 (0 on padding rows)
    prefix_k, prefix_v,  # [L, Sp, n_kv, hd] shared dense prefix KV
    prefix_len,    # 0-dim int32
    k_cache, v_cache,    # paged caches, updated IN PLACE
    page_ids,      # [R, Ss/page_size] scatter destinations (0 = scratch)
    slot_ids,      # [R] target slot per row (trash row M on padding)
    state: _SlotState,   # updated IN PLACE
    new_budgets,   # [R] budget of admitted rows (max_new - 1; 0 on padding)
    *sampling,     # _admit_rows' sp_tokens ... constrained
    vocab_limit: int | None = None,
):
    """Batched admission: suffix prefill with the KV scattered into pages,
    then the first token of each row sampled and its slot's state set.
    Padding rows land in the trash row and stay inactive."""
    last_logits, _, _ = forward_prefill_suffix(
        params, cfg, tokens, suffix_lens, prefix_k, prefix_v, prefix_len,
        k_cache, v_cache, page_ids,
    )
    _admit_rows(
        state, last_logits, slot_ids, (prefix_len + suffix_lens).to(torch.int32),
        suffix_lens > 0, new_budgets, *sampling, vocab_limit=vocab_limit,
    )


class _WaveVariant:
    """One compiled wave geometry (InferenceEngine._wave_key): its static
    input buffers and carry, and its two device programs, captured as CUDA
    graphs on a card (engine/graphs.py) and run eagerly otherwise:

    - `prefill`: the batched suffix prefill against the static prefix, and
      the carry's initial state (idempotent: a function of the inputs);
    - `iteration`: ONE grammar-accelerated block iteration updating the
      carry in place: (a) sample one token from the carried logits, (b)
      expand the forced run that follows through DFA table lookups (no
      model call), (c) one F-wide mini-prefill over the block
      (models/llama.forward_block_decode; with decode_matmul="ragged" its
      matmuls run K3 over the valid tokens only). The block lands in `out`
      at the device-side iteration counter `it`, with its valid-token count
      in `counts[it]` and whether any row is still alive in `alive[it]`,
      which the program copies to the host buffer `alive_h`.

    The JAX package's `lax.while_loop` is the host loop of
    InferenceEngine._run_wave. Every buffer a program reads lives as long
    as the variant: the static prefix of its Sp, the grammar tables of its
    shape and the prefix length are the engine's."""

    def __init__(self, eng: "InferenceEngine", key: tuple, R: int, bucket: int,
                 n_iters: int, F: int, cap: int, prefix: "_StaticPrefix",
                 grammar: tuple) -> None:
        cfg, dev = eng.cfg, eng.device
        self.key, self.R, self.n_iters, self.F = key, R, n_iters, F
        self._eng = eng
        self._prefix = prefix
        # the grammar tables of this variant's shape and whether they
        # constrain (InferenceEngine._grammar; set_grammar keeps one set a
        # shape and rewrites it in place)
        self._tables, self._constrained = grammar

        def i32(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        self.tokens, self.suffix_lens, self.max_new = i32(R, bucket), i32(R), i32(R)
        self.staging = tuple(
            host_buffer(t.shape, torch.int32, dev)
            for t in (self.tokens, self.suffix_lens, self.max_new)
        )
        self._staged = Fence(dev)  # the last copies out of `staging` ran
        kv = (cfg.n_layers, R, bucket, cfg.n_kv_heads, cfg.head_dim)
        self.k_sfx = torch.zeros(kv, dtype=cfg.dtype, device=dev)
        self.v_sfx = torch.zeros_like(self.k_sfx)
        gen_kv = (cfg.n_layers, R, cap + 1, cfg.n_kv_heads, cfg.head_dim)
        self.gk = torch.zeros(gen_kv, dtype=cfg.dtype, device=dev)
        self.gv = torch.zeros_like(self.gk)
        self.st, self.emitted, self.pos_next = i32(R), i32(R), i32(R)
        self.act = torch.zeros(R, dtype=torch.bool, device=dev)
        self.logits = torch.zeros((R, cfg.vocab_size), dtype=torch.float32, device=dev)
        self.out = i32(R, n_iters * F)
        self.counts = i32(n_iters)
        self.alive = torch.zeros(n_iters, dtype=torch.bool, device=dev)
        self.alive_h = host_buffer((n_iters,), torch.bool, dev)
        self.it = torch.zeros((), dtype=torch.int64, device=dev)
        self.jcol = torch.arange(F, dtype=torch.int32, device=dev)
        runner = eng._graphs
        self.prefill = runner.program(f"suffix prefill R={R}", self._prefill, idempotent=True)
        self.iteration = runner.program(f"block decode R={R}", self._iterate)

    def load(self, tokens: np.ndarray, suffix_lens: np.ndarray, max_new: np.ndarray) -> None:
        """The wave's inputs into the static buffers through pinned host
        buffers, copied without a sync once the previous copies out of
        them have run."""
        self._staged.synchronize()
        for host, dst, src in zip(self.staging, (self.tokens, self.suffix_lens, self.max_new),
                                  (tokens, suffix_lens, max_new)):
            host.numpy()[...] = src
            dst.copy_(host, non_blocking=True)
        self._staged.record()

    @torch.no_grad()
    def _prefill(self) -> None:
        eng, pfx = self._eng, self._prefix
        last_logits, _, _ = forward_prefill_suffix_dense(
            eng.params, eng.cfg, self.tokens, self.suffix_lens, pfx.k, pfx.v,
            eng._plen_d, kv_out=(self.k_sfx, self.v_sfx),
        )
        self.logits.copy_(last_logits)
        self.st.copy_(eng._dfa_start_d.expand(self.R))
        self.act.copy_(self.suffix_lens > 0)
        # emitted doubles as the generated-KV write tail.
        self.emitted.zero_()
        self.pos_next.copy_(eng._plen_d + self.suffix_lens)
        self.gk.zero_()
        self.gv.zero_()
        self.out.fill_(eng.tokenizer.pad_id)
        self.counts.zero_()
        self.alive.zero_()
        self.it.zero_()

    @torch.no_grad()
    def _iterate(self) -> None:
        eng, pfx = self._eng, self._prefix
        sp_tokens, sp_next, forced, forced_next = self._tables
        pad_id, eos_id = eng.tokenizer.pad_id, eng.tokenizer.eos_id
        done = eng._done_state_d
        st, act, emitted, max_new = self.st, self.act, self.emitted, self.max_new
        F = self.F
        # (a) sample the block's first token from the carried logits
        if self._constrained:
            t0, s_t0 = _sample_sparse(
                self.logits, sp_tokens[st], sp_next[st], eng._gen, eng.temperature
            )
        else:
            t0 = _sample_unconstrained(
                self.logits, pad_id, eng._gen, eng.temperature, eng._vocab_limit
            )
            s_t0 = st
        emit0 = act & (emitted < max_new)
        s_cur = torch.where(emit0, s_t0, st)
        fin0 = (t0 == eos_id) | (s_cur == done)
        blk = [torch.where(emit0, t0, pad_id)]
        valid = [emit0]
        alive = emit0 & ~fin0 & (emitted + 1 < max_new)
        # (b) forced-run expansion: table lookups, no model call
        for j in range(1, F):
            ft = forced[s_cur]
            emit_j = alive & (ft >= 0)
            t_j = torch.where(emit_j, ft, pad_id)
            s_cur = torch.where(emit_j, forced_next[s_cur], s_cur)
            fin_j = (t_j == eos_id) | (s_cur == done)
            blk.append(t_j)
            valid.append(emit_j)
            # paused-at-choice rows (ft < 0) stay alive for the next
            # iteration's sample; emitted rows continue unless finished or
            # out of budget
            alive = torch.where(
                emit_j, ~fin_j & (emitted + j + 1 < max_new), alive & (ft < 0)
            )
        blk_tok = torch.stack(blk, dim=1)
        blk_valid = torch.stack(valid, dim=1)
        blk_len = blk_valid.sum(dim=1, dtype=torch.int32)
        positions = self.pos_next[:, None] + self.jcol[None, :]
        # (c) one model call for the whole block (gk/gv written in place)
        logits, _, _ = forward_block_decode(
            eng.params, eng.cfg, blk_tok, blk_valid, blk_len, positions,
            self.k_sfx, self.v_sfx, self.suffix_lens, self.gk, self.gv, emitted,
            pfx.k, pfx.v, eng._plen_d, ragged=eng.decode_matmul == "ragged",
        )
        it = self.it.view(1)
        self.logits.copy_(logits)
        self.out.index_copy_(1, self.it * F + self.jcol.long(), blk_tok)
        self.counts.index_copy_(0, it, blk_len.sum(dtype=torch.int32).view(1))
        self.alive.index_copy_(0, it, alive.any().view(1))
        self.alive_h.copy_(self.alive, non_blocking=True)
        self.st.copy_(s_cur)
        self.act.copy_(alive)
        self.emitted.add_(blk_len)
        self.pos_next.add_(blk_len)
        self.it.add_(1)


class _ChunkVariant:
    """The general path's decode chunk for one geometry: `chunk_steps`
    decode steps, each emitting one sampled token per slot (finished,
    exhausted or idle slots emit pad_id), over the engine's slot state and
    static page tables, updated IN PLACE. The pages are frozen for the
    chunk: new K/V goes to a small chunk buffer and flushes into pages in
    one scatter at its end. Own-token attention either gathers the pages to
    a dense buffer once ("gather") or streams them through K4 every step
    ("pallas"). The emitted tokens land in the engine's `_chunk.toks`.

    The chunk is one program ("decode chunk": its set-up, `chunk_steps`
    steps and the flush), one CUDA graph on a card: one host launch a
    chunk. (One step's graph replayed `chunk_steps` times between set-up
    and flush graphs replays as fast or up to 5% slower at path B's shapes
    and captures ~5x faster; tools/torch_decision_profile.py --path b
    builds it from the same methods.)"""

    def __init__(self, eng: "InferenceEngine", prefix: "_StaticPrefix") -> None:
        self._eng = eng
        self._prefix = prefix
        self._tables = (eng._sp_tokens, eng._sp_next)
        self._constrained = eng._constrained
        # by the engine's mode, not by the buffers: the resident loop may
        # have added gather buffers to a "pallas" engine's set
        self._gather = eng.paged_attn == "gather"
        self.program = eng._graphs.program("decode chunk", self._chunk)

    def run(self) -> None:
        self.program.run()

    def _chunk(self) -> None:
        self._begin()
        for _ in range(self._eng.chunk_steps):
            self._step()
        self._flush()

    def _begin(self) -> None:
        eng, c = self._eng, self._eng._chunk
        fused_begin(eng._plen_d, eng._state, c, eng.tokenizer.pad_id)
        if self._gather:
            fused_gather(eng.kv.k, eng.kv.v, eng._tables_d, c)

    @torch.no_grad()
    def _step(self) -> None:
        eng, c, s, pfx = self._eng, self._eng._chunk, self._eng._state, self._prefix
        pad_id, eos_id = eng.tokenizer.pad_id, eng.tokenizer.eos_id
        M, P = eng._tables_d.shape
        L, _, ps, n_kv, hd = eng.kv.k.shape
        if not self._gather:
            k_own, v_own = eng.kv.k, eng.kv.v
        else:
            k_own = c.k_own.view(L, M, P * ps, n_kv, hd)
            v_own = c.v_own.view(L, M, P * ps, n_kv, hd)
        act_eff = s.act & (s.budget > 0)
        logits, _, _ = forward_decode_buffered(
            eng.params, eng.cfg, s.tok, s.pos, k_own, v_own, c.own_start,
            c.ck, c.cv, c.tail, pfx.k, pfx.v, eng._plen_d,
            page_tables=eng._tables_d,
            own_impl="pallas" if eng.paged_attn == "pallas" else "dense",
        )
        if self._constrained:
            sp_tokens, sp_next = self._tables
            nxt, new_st = _sample_sparse(
                logits, sp_tokens[s.st], sp_next[s.st], eng._gen, eng.temperature
            )
        else:
            nxt = _sample_unconstrained(
                logits, pad_id, eng._gen, eng.temperature, eng._vocab_limit
            )
            new_st = s.st
        tok = torch.where(act_eff, nxt, pad_id)
        new_st = torch.where(act_eff, new_st, s.st)
        finished = (new_st == eng._done_state_d) | (nxt == eos_id)
        c.toks.index_copy_(1, c.j.view(1), tok[:, None])
        s.tok.copy_(tok)
        s.st.copy_(new_st)
        s.act.copy_(act_eff & ~finished)
        s.budget.copy_(torch.where(act_eff, s.budget - 1, s.budget))
        s.pos.copy_(torch.where(act_eff, s.pos + 1, s.pos))
        c.tail.copy_(torch.where(act_eff, c.tail + 1, c.tail))
        c.j.add_(1)

    def _flush(self) -> None:
        eng = self._eng
        fused_flush(eng.kv.k, eng.kv.v, eng._tables_d, eng._chunk)


class _FusedChunkVariant:
    """The fused decode chunk for one geometry (engine/fused/loop.py): up to
    `chunk_steps` steps over the engine's slot state, page tables and paged
    caches, each step guarded by the on-device liveness test, so a chunk
    dispatched on a finished batch runs no model call. Emissions land in
    the engine's `_chunk.toks`, the steps run in `_chunk.j`. One program,
    one CUDA graph on a card: one host launch a chunk."""

    def __init__(self, eng: "InferenceEngine", prefix: "_StaticPrefix",
                 table: torch.Tensor) -> None:
        self._eng = eng
        self._prefix = prefix
        self._table = table
        self._constrained = eng._constrained
        self.program = eng._graphs.program("fused decode chunk", self._chunk)

    @torch.no_grad()
    def _chunk(self) -> None:
        eng, pfx = self._eng, self._prefix
        fused_decode_chunk_impl(
            eng.params, eng.cfg, eng.kv.k, eng.kv.v, eng._tables_d, pfx.k, pfx.v,
            eng._plen_d, eng._state, eng._chunk, self._table, eng._done_state_d,
            eng.tokenizer.eos_id, eng.tokenizer.pad_id, eng._gen, eng.temperature,
            eng.chunk_steps, self._constrained, eng.top_k, eng.paged_attn,
            eng._vocab_limit, runner=eng._graphs,
        )


@dataclasses.dataclass
class _ChunkBuffers:
    """The decode chunk's scratch, shared by its variants (one runs at a
    time): the chunk KV buffer [L, M, n_steps, n_kv, hd], each slot's
    entries in it (`tail`), its own tokens before the chunk (`own_start`),
    the emitted tokens [M, n_steps] with the step counter `j` (a fused
    chunk's steps run), a fused chunk's uniforms [n_steps, M], and with
    paged_attn="gather" (or for the resident loop) the gathered pages
    [L, M*P, ps, n_kv, hd]."""

    ck: torch.Tensor
    cv: torch.Tensor
    tail: torch.Tensor
    own_start: torch.Tensor
    toks: torch.Tensor
    j: torch.Tensor
    u: torch.Tensor
    k_own: torch.Tensor | None
    v_own: torch.Tensor | None


@dataclasses.dataclass
class _StaticPrefix:
    """The buffer the graphs read the active prefix's KV from, one per
    prefix buffer length Sp: the kernels encode their TMA maps for the
    addresses seen at capture, so a prefix switch copies into it. `src`
    names the prefix it holds (weakly: an evicted prefix is freed)."""

    k: torch.Tensor
    v: torch.Tensor
    src: weakref.ref | None = None


@dataclasses.dataclass
class _PrefixKV:
    """Dense KV of a burst-shared prompt prefix, prefilled once."""

    k: torch.Tensor  # [L, Sp_bucket, n_kv, hd]
    v: torch.Tensor
    length: int
    token_ids: tuple[int, ...]


@dataclasses.dataclass
class _Request:
    req_id: int
    slot: int
    prompt_len: int
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    first_pending: bool = True  # first token not yet harvested from device
    # Parked piggyback emissions (engine._pending_emissions) with list
    # index < park_floor predate this request's admission: a slot reused
    # after a failed or finished pack must never book an earlier occupant's
    # parked tokens (_finish_harvest skips those columns). Reset to 0 once
    # the parked list is consumed.
    park_floor: int = 0
    # Driven by an EXTERNAL decoder (spec/decoder.py): the slot is
    # deactivated in the decode batch and every harvest path skips it, so
    # fused chunks and open speculative rounds share one device stream. The
    # owner finishes the request through release_slot, or hands it back by
    # clearing this flag and re-arming the slot (the auto-disable path).
    external: bool = False
    submitted_at: float = dataclasses.field(default_factory=time.perf_counter)


@dataclasses.dataclass
class Finished:
    req_id: int
    token_ids: list[int]
    text: str
    latency_ms: float


@dataclasses.dataclass
class WaveHandle:
    """A decision wave handed to the engine's wave dispatcher. submit_wave
    returns it at once; the dispatcher fills in the results' host buffers,
    the iteration count and the fence of their copies once it has queued
    the wave's last iteration, then sets `dispatched` (JAX: a dispatched
    program with `copy_to_host_async`). A failed dispatch leaves `error`.
    With a profiler attached, the dispatcher also stamps `dispatch_end`
    (perf_counter) once it has queued the wave's suffix prefill, its first
    device program, and on a card `timing`: two timing events recorded on
    the stream before the wave's first copy and after its last, outside
    any capture."""

    n: int                # real prompts in this wave (<= R)
    max_new_tokens: int
    req_ids: list[int]
    submitted_at: float  # perf_counter at submit
    # True when this wave's geometry was not captured at submit: its wall
    # time includes the capture, and service-time estimators skip it.
    cold_compile: bool = False
    # Compiled-variant identity (engine._wave_key).
    geo_key: tuple | None = None
    toks_h: torch.Tensor | None = None  # host [R, n_iters*F] emitted tokens (pad_id holes)
    blk_tokens_h: torch.Tensor | None = None  # host [n_iters]: valid tokens of each model call
    iters: int = 0        # model calls actually run (early exit)
    done: Fence | None = None  # the copies to the host have landed
    error: BaseException | None = None
    dispatch_end: float | None = None
    timing: tuple | None = None  # (start, end) torch.cuda.Event
    dispatched: threading.Event = dataclasses.field(default_factory=threading.Event)

    def is_ready(self) -> bool:
        """True once the results landed on the host or the dispatch failed
        (harvest won't block). Never blocks."""
        if not self.dispatched.is_set():
            return False
        return self.error is not None or self.done.query()


def _as_tensor(t) -> torch.Tensor:
    """A tensor of adopted pages: numpy ones (a wire's, or read-only ones)
    through a copy torch may write."""
    return t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))


def _match_tree(serving, new, path: str, pairs: list) -> None:
    """Append (serving leaf, new leaf) for every leaf of `serving` to
    `pairs`; raise ValueError at the first path where `new` differs in
    structure, shape or dtype."""
    if isinstance(serving, dict):
        if not isinstance(new, dict) or set(new) != set(serving):
            got = sorted(new) if isinstance(new, dict) else type(new).__name__
            raise ValueError(
                f"swap_params: {path} has keys {got}, the serving tree {sorted(serving)}")
        for key in serving:
            _match_tree(serving[key], new[key], f"{path}.{key}", pairs)
        return
    if not isinstance(new, torch.Tensor):
        raise ValueError(f"swap_params: {path} is a {type(new).__name__}, not a tensor")
    if new.shape != serving.shape or new.dtype != serving.dtype:
        raise ValueError(
            f"swap_params: {path} is {new.dtype} {tuple(new.shape)}, the serving "
            f"leaf {serving.dtype} {tuple(serving.shape)}")
    pairs.append((serving, new))


def _tp_not_ported(what: str, tp: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} at tp={tp} is not ported yet (ROADMAP queue 1 item {TP_PENDING_ITEM}): "
        f"serve it at tp 1")


def check_tp_serving(tp: int, backend: str, device_type: str, graphs: bool,
                     decode_matmul: str) -> None:
    """Raise for an engine setting a tp > 1 rank does not serve: ragged
    decode matmuls (refused as the JAX engine refuses them) and CUDA graphs
    over a gloo group on CUDA (so at tp 2 on one card every program, the
    resident loop's too, runs eagerly)."""
    if decode_matmul == "ragged":
        raise ValueError(
            f"decode_matmul='ragged' is single-device-only (K3 runs over one "
            f"device's whole weight, not a rank's shard) but the serving mesh "
            f"has tp={tp}; use decode_matmul='dense' for tensor-parallel serving")
    if graphs and device_type == "cuda" and backend == "gloo":
        raise ValueError(
            f"graphs=True over a gloo tp group on CUDA (tp={tp} ranks sharing a "
            f"device): gloo runs its collectives through the host, which a CUDA "
            f"graph cannot capture; build the engine with graphs=False")


def _dispatch_loop(jobs: "queue.SimpleQueue") -> None:
    """The wave dispatcher thread: run the queued jobs in FIFO order until
    a None arrives. It holds no reference to the engine between jobs, so
    an engine nobody holds is freed (and its finalizer stops the thread)."""
    while True:
        job = jobs.get()
        if job is None:
            return
        job()
        del job


class InferenceEngine:
    """Single-owner (one thread) engine over one model and one paged KV
    cache on one device; the device is where the params lie. With
    `graphs=True` (the default) its waves and decode chunks replay CUDA
    graphs on a card, captured on the owner thread at their first dispatch;
    `graphs=False` runs the same code eagerly. Neither falls back to the
    other: a failed capture or replay raises."""

    DFA_STATE_CAPACITY = 4096
    # On-device prefix KV cache budget, in BYTES: at least one entry (the
    # active prefix) is always kept.
    PREFIX_CACHE_BYTES = 1 << 30

    def __init__(
        self,
        params: Params,
        cfg: LlamaConfig,
        tokenizer: Tokenizer | None = None,
        *,
        num_pages: int = 512,
        page_size: int = 64,
        max_slots: int = 8,
        max_pages_per_seq: int = 64,
        prefill_buckets: tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096, 8192),
        chunk_steps: int = 16,
        temperature: float = 0.3,
        top_k: int = 0,
        rng_seed: int = 0,
        prefix_chunk: int = 2048,
        paged_attn: str = "gather",
        decode_matmul: str = "dense",
        graphs: bool = True,
        admission_chunk_tokens: int = 256,
        fused_decode: bool = True,
        fused_table_bytes: int | None = None,
        persistent_loop: bool = False,
        persistent_suffix_bucket: int | None = None,
        persistent_wedge_timeout_s: float = 30.0,
        persistent_telemetry: bool = True,
        persistent_stats_every: int = 8,
        persistent_blackbox_depth: int = 64,
        mesh=None,
    ) -> None:
        self.params = params
        self.device = params["embed"].device
        # The tp serving plane (engine/sharded/plane.py): over a mesh whose
        # tp axis is wider than 1 this process is one rank, `params` its
        # shard (parallel/sharding.py) and `cfg` becomes the rank's
        # geometry, so every buffer below holds the rank's kv heads and
        # every forward joins the ranks through the plane. None off-mesh.
        self.mesh = mesh
        self.plane = build_plane(mesh)
        # the driver's parallel/launch.RankGroup, set when it mirrors this
        # engine's calls to its followers
        self.rank_group = None
        # the whole model's config (the checkpoint's shapes, the prefix-KV
        # plane's geometry); `cfg` below is the rank's at tp > 1
        self.model_config = cfg
        if self.plane is not None:
            cfg = self._rank_config(cfg, graphs, decode_matmul)
        self.cfg = cfg
        self.tokenizer = tokenizer or ByteTokenizer()
        if self.tokenizer.vocab_size > cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab {self.tokenizer.vocab_size} > model vocab "
                f"{cfg.vocab_size} — the tokenizer would emit ids past the "
                f"embedding table"
            )
        # Unconstrained sampling masks ids past a smaller tokenizer's table.
        self._vocab_limit: int | None = (
            self.tokenizer.vocab_size
            if self.tokenizer.vocab_size < cfg.vocab_size
            else None
        )
        bad = [bkt for bkt in prefill_buckets if bkt % page_size]
        if bad:
            raise ValueError(f"prefill buckets {bad} not multiples of page_size={page_size}")
        # Own-token attention of the general path's chunked decode: "gather"
        # (pages gathered to a dense buffer once per chunk) or "pallas" (K4
        # streams them every step).
        if paged_attn not in ("gather", "pallas"):
            raise ValueError(f"paged_attn must be 'gather' or 'pallas', got {paged_attn!r}")
        # Block-decode matmuls of decision waves: "dense" or "ragged" (K3
        # over the valid tokens only).
        if decode_matmul not in ("dense", "ragged"):
            raise ValueError(
                f"unknown decode_matmul {decode_matmul!r} (expected 'dense' or 'ragged')"
            )
        self.paged_attn = paged_attn
        self.decode_matmul = decode_matmul
        self.chunk_steps = int(chunk_steps)
        self.kv = PagedKVCache(
            cfg, num_pages=num_pages, page_size=page_size, max_slots=max_slots,
            max_pages_per_seq=max_pages_per_seq, device=self.device,
        )
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        # Block width of the chunked long-prefix prefill: bounds the
        # per-layer attention work at O(prefix_chunk x prefix).
        self.prefix_chunk = int(prefix_chunk)
        self.temperature = float(temperature)
        # top-k restricts the fused loop's sampled draws (engine/fused/
        # sampler.py), its one reader in both packages; waves and step()
        # sample the whole distribution.
        self.top_k = int(top_k)
        # Fused on-device decode runtime (engine/fused/): step_fused /
        # decode_fused route here and FALL BACK to step() whenever the
        # grammar can't export a dense table within fused_table_bytes.
        self.fused_decode = bool(fused_decode)
        self.fused_table_bytes = (
            int(fused_table_bytes) if fused_table_bytes is not None
            else DENSE_TABLE_MAX_BYTES
        )
        self._dfa: DecisionDFA | None = None
        self._fused_next_d: torch.Tensor | None = None
        self._fused_unsupported = False
        # Unconstrained fused chunks never read the table: a [1, 1] dummy.
        self._fused_dummy = torch.full((1, 1), -1, dtype=torch.int32, device=self.device)
        self._fused_variants: dict[tuple, _FusedChunkVariant] = {}
        # Persistent serving loop (engine/persistent/): when enabled AND
        # supported, add_requests feeds its command ring and
        # step_persistent() drains its token ring. The server is built at
        # the first enter_persistent; _persistent_wedged latches after a
        # watchdog drain, so a wedging workload stays on the dispatch path.
        self.persistent_loop = bool(persistent_loop)
        self.persistent_suffix_bucket = persistent_suffix_bucket
        self.persistent_wedge_timeout_s = float(persistent_wedge_timeout_s)
        self.persistent_telemetry = bool(persistent_telemetry)
        self.persistent_stats_every = int(persistent_stats_every)
        self.persistent_blackbox_depth = int(persistent_blackbox_depth)
        self._persistent = None  # PersistentServer | None
        self._persistent_wedged = False
        # token batches harvested off the resident loop's ring, over every
        # residency: a tp follower harvests to the driver's count before
        # each mirrored call (follow_persistent)
        self._pers_harvested = 0
        # a tp rank's block of the next weights, staged by the double
        # mode's load (parallel/launch.stage_swap)
        self._swap_staging = None
        # Speculative decoder (spec/decoder.py), attached by attach_spec:
        # generate() routes through it.
        self.spec = None
        self._pers_ctr_final: dict[str, int] | None = None
        # Continuous wave profiler (observability/profiler.py), attached by
        # attach_profiler. None = one None check a wave, nothing else.
        self.profiler = None
        # Resident-loop profiler books: the wall anchor of step_persistent's
        # windows, the counter baselines its loop_resident decomposition
        # takes deltas against, and the EWMA of in-loop decision latency.
        self._pers_tok_last = 0.0
        self._pers_ctr_last = np.zeros(N_COUNTERS, dtype=np.int64)
        self._pers_stall_last = 0
        self._resident_latency_ms: float | None = None
        # Decision-flow books of the dispatches_per_decision gauge: the
        # counters when a completion window was last booked.
        self._flow_dispatches_last = 0
        self._flow_completed_last = 0
        # The resident loop and the wave dispatcher never run device work at
        # the same time: each holds this lock around its programs.
        self._device_lock = threading.Lock()
        self.max_slots = max_slots
        # Block width of grammar-accelerated wave decoding: 1 sampled + up
        # to wave_block-1 forced tokens per model call.
        self.wave_block = 24
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed)
        # CUDA graphs (engine/graphs.py); sampled decoding registers the
        # generator with every graph.
        self._graphs = GraphRunner(
            self.device, graphs, generator=self._gen if self.temperature > 0 else None
        )
        # The wave dispatcher (submit_wave): its job queue and thread,
        # started at the first wave, and the count of waves handed to it
        # whose work is not all queued on the device yet.
        self._jobs: queue.SimpleQueue | None = None
        self._dispatcher: threading.Thread | None = None
        self._undispatched = 0
        self._dispatch_cv = threading.Condition()
        # Grammar tables, one set per shape, rewritten in place by
        # set_grammar (graphs read them by address); the DFA's start and
        # done states as device scalars for the same reason.
        self._grammar_tables: dict[tuple, torch.Tensor] = {}
        self._dfa_start_d = torch.zeros((), dtype=torch.int32, device=self.device)
        self._done_state_d = torch.zeros((), dtype=torch.int32, device=self.device)
        self.set_grammar(None)

        self._prefix: _PrefixKV | None = None
        self._prefix_cache: OrderedDict[tuple[int, ...], _PrefixKV] = OrderedDict()
        self._empty_prefix: _PrefixKV | None = None
        # Pinned prefix-cache keys (pin_prefix): exempt from byte-pressure
        # eviction. prefix_epoch stamps pin handles with the weight
        # generation; a hot swap (swap_params) bumps it.
        self._pinned_prefix_keys: set[tuple[int, ...]] = set()
        self.prefix_epoch = 0
        # At tp > 1, this rank's d2d exports (export_prefix_blocks): export
        # id -> ((k, v) of the exported entry, the handles shared of them).
        # The entry keeps living here after an eviction or a swap, until
        # the driver releases it (parallel/launch.ExportBook).
        self._kv_exports: dict[int, tuple[tuple[torch.Tensor, torch.Tensor], list]] = {}
        # Packed admission (admit_packed): the chunk width of the packed
        # prefill; the host buffers of decode chunks piggybacked between
        # pack chunks park here until the next step() harvest.
        if admission_chunk_tokens < 1:
            raise ValueError("admission_chunk_tokens must be >= 1")
        self.admission_chunk_tokens = int(admission_chunk_tokens)
        self._pending_emissions: list[torch.Tensor] = []
        self._req_counter = 0
        # General path: requests by slot, the device slot state (row M is
        # the trash row) with host mirrors of act/budget from the last sync,
        # finished records parked for the next step(), and the page tables
        # padded with the trash row.
        self._by_slot: dict[int, _Request] = {}
        self._state = _SlotState.zeros(max_slots + 1, self.device)
        self._act_np = np.zeros(max_slots + 1, dtype=bool)
        self._budget_np = np.zeros(max_slots + 1, dtype=np.int32)
        self._pending_finished: list[Finished] = []
        # Static buffers the graphs read: the active prefix's KV (one per
        # buffer length Sp) and its length, and the page tables padded with
        # the all-zeros trash row, refreshed when the kv tables change.
        self._static_prefix: dict[int, _StaticPrefix] = {}
        self._plen_d = torch.zeros((), dtype=torch.int32, device=self.device)
        self._plen_loaded: int | None = None
        self._tables_src: torch.Tensor | None = None
        self._tables_d = torch.zeros(
            (max_slots + 1, max_pages_per_seq), dtype=torch.int32, device=self.device
        )
        # Wave variants by _wave_key (static buffers and programs); keys
        # whose dispatch succeeded, with their captured programs
        # (_wave_compiled); the (suffix bucket, max_new) shapes served; and
        # the keys whose prewarm failed (JAX engine, engine.py).
        self._wave_variants: dict[tuple, _WaveVariant] = {}
        self._wave_compiled: dict[tuple, tuple[Program, Program]] = {}
        self._wave_shapes_seen: set[tuple[int, int]] = set()
        self._wave_prewarm_failed: set[tuple] = set()
        # The decode chunk: its scratch (allocated at the first chunk) and
        # its variants by key.
        self._chunk: _ChunkBuffers | None = None
        self._chunk_variants: dict[tuple, _ChunkVariant] = {}
        # Valid tokens of each recent block-decode model call (K3's `total`
        # with decode_matmul="ragged"), booked at harvest.
        self.block_tokens: deque[int] = deque(maxlen=4096)
        self.stats = {
            "requests": 0,
            "completed": 0,
            "prefill_tokens": 0,
            "prefix_prefills": 0,
            "prefix_hits": 0,
            "prefix_reused_tokens": 0,
            "decode_tokens": 0,
            "waves": 0,
            "wave_model_calls": 0,
            # block iterations run on the device: wave_model_calls, plus
            # the one past the last live iteration of each wave and those
            # of prewarm waves
            "wave_block_calls": 0,
            "wave_prewarms": 0,
            "wave_prewarm_failures": 0,
            "dispatches": 0,
            "prefills": 0,
            "chunks": 0,
            "syncs": 0,
            "packed_admissions": 0,
            "packed_prompts": 0,
            "pack_chunks": 0,
            "piggyback_chunks": 0,
            "pinned_prefixes": 0,
            "pin_evictions": 0,
            "fused_chunks": 0,
            "fused_steps": 0,
            "fused_fallbacks": 0,
            "persistent_launches": 0,
            "persistent_admissions": 0,
            "persistent_steps": 0,
            "persistent_chunks": 0,
            "persistent_fallbacks": 0,
            "persistent_wedges": 0,
            "weight_swaps": 0,
            # host wall time, device work included (both end in a sync)
            "prefix_prefill_ms": 0.0,
            "wave_ms": 0.0,
        }

    def _rank_config(self, cfg, graphs, decode_matmul):
        """The rank's geometry, after refusing what tp > 1 does not serve."""
        check_tp_serving(self.plane.tp, self.plane.backend, self.device.type, graphs,
                         decode_matmul)
        return self.plane.local_config(cfg)

    def _refuse_tp(self, what: str) -> None:
        """Raise for a path not ported to tensor-parallel serving."""
        if self.plane is not None:
            raise _tp_not_ported(what, self.plane.tp)

    # ------------------------------------------------------------- grammar
    def set_grammar(self, dfa: DecisionDFA | None) -> None:
        """Install (or clear) the decision grammar as SPARSE device tables,
        states padded to DFA_STATE_CAPACITY (doubled until it fits), copied
        into the engine's tables of that shape (so graphs keyed by the
        shape, as the JAX engine keys its executables, read them).
        Unconstrained mode samples the full vocab minus pad. The fused
        runtime's dense table resets with the grammar (built lazily on the
        first fused chunk: dense_grammar)."""
        self._await_dispatch()
        if self.persistent_active:
            # the resident loop serves the installed grammar's table and
            # start state: drain before swapping
            self.exit_persistent()
        self._dfa = dfa
        self._fused_next_d = None
        self._fused_unsupported = False
        if dfa is None:
            self._constrained = False
            sp_tokens = np.full((1, 1), -1, dtype=np.int32)
            sp_next = np.zeros((1, 1), dtype=np.int32)
            forced = np.full((1,), -1, dtype=np.int32)
            forced_next = np.zeros((1,), dtype=np.int32)
            self._done_state = -1  # unconstrained: nothing reaches done
            self._dfa_start = 0
            self._grammar_wave_iters = None
        else:
            cap = self.DFA_STATE_CAPACITY
            while cap < dfa.n_states:
                cap *= 2
            t = sparse_tables(dfa)
            K = t.k_width
            sp_tokens = np.full((cap, K), -1, dtype=np.int32)
            sp_next = np.zeros((cap, K), dtype=np.int32)
            forced = np.full((cap,), -1, dtype=np.int32)
            forced_next = np.zeros((cap,), dtype=np.int32)
            sp_tokens[: t.n_states] = t.sp_tokens
            sp_next[: t.n_states] = t.sp_next
            forced[: t.n_states] = t.forced
            forced_next[: t.n_states] = t.forced_next
            self._constrained = True
            self._done_state = int(dfa.done_state)
            self._dfa_start = int(dfa.start_state)
            self._grammar_wave_iters = wave_iterations(dfa, self.wave_block)
        self._sp_tokens, self._sp_next, self._forced, self._forced_next = (
            self._grammar_table(name, arr)
            for name, arr in (("sp_tokens", sp_tokens), ("sp_next", sp_next),
                              ("forced", forced), ("forced_next", forced_next))
        )
        self._done_state_d.fill_(self._done_state)
        self._dfa_start_d.fill_(self._dfa_start)

    def _grammar_table(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """The device table `name` of arr's shape, rewritten with arr."""
        key = (name, arr.shape)
        table = self._grammar_tables.get(key)
        if table is None:
            table = self._grammar_tables[key] = torch.from_numpy(arr).to(self.device)
        else:
            table.copy_(torch.from_numpy(arr))
        return table

    # -------------------------------------------------------------- prefix
    def _zeros_kv(self, slots: int) -> torch.Tensor:
        cfg = self.cfg
        return torch.zeros(
            (cfg.n_layers, slots, cfg.n_kv_heads, cfg.head_dim),
            dtype=cfg.dtype, device=self.device,
        )

    def _get_empty_prefix(self) -> _PrefixKV:
        if self._empty_prefix is None:
            self._empty_prefix = _PrefixKV(
                k=self._zeros_kv(EMPTY_PREFIX_SLOTS),
                v=self._zeros_kv(EMPTY_PREFIX_SLOTS),
                length=0,
                token_ids=(),
            )
        return self._empty_prefix

    def active_group(self) -> tuple:
        """The active prefix KV and grammar, as objects: a backend compares
        them by identity with what its own install left, to see whether
        another caller has installed a group since."""
        return self._prefix, self._dfa

    def set_prefix(self, prompt_ids: list[int] | None) -> None:
        """Install the burst-shared prompt prefix, prefilling it once if it
        is not cached on device. Prefixes longer than
        min(prefix_chunk, largest bucket) take the chunked path. Requires
        the general path to be drained: its slots decode against the
        active prefix."""
        self._await_dispatch()
        if self.persistent_active:
            # every in-loop admission prefills against the prefix bound at
            # launch: drain before swapping
            self.exit_persistent()
        if self._by_slot:
            raise RuntimeError("cannot switch prefix with requests in flight")
        if not prompt_ids:
            self._prefix = self._get_empty_prefix()
            return
        t0 = time.perf_counter()
        self._set_prefix_inner(prompt_ids)
        if self.device.type == "cuda":
            # a group switch is rare; the wave after it needs the KV anyway
            with DEVICE_WIDE:
                torch.cuda.synchronize(self.device)
        self.stats["prefix_prefill_ms"] += (time.perf_counter() - t0) * 1000.0

    @torch.no_grad()
    def _set_prefix_inner(self, prompt_ids: list[int], activate: bool = True) -> None:
        """Prefill (or cache-hit) `prompt_ids` into the prefix cache; with
        `activate`, make it the active prefix."""
        key = tuple(prompt_ids)
        cached = self._prefix_cache.get(key)
        if cached is not None:
            self._prefix_cache.move_to_end(key)
            if activate:
                self._prefix = cached
            self.stats["prefix_hits"] += 1
            if self.profiler is not None:
                self.profiler.note_prefix_prefill(0, cached.length)
            return
        n = len(prompt_ids)
        if n > self.cfg.max_seq_len:
            # Advisory: RoPE extrapolates beyond the trained window.
            logger.warning(
                "prefix of %d tokens exceeds model max_seq_len %d; "
                "quality may degrade", n, self.cfg.max_seq_len,
            )
        prefilled = n
        if n > min(self.prefix_chunk, self.prefill_buckets[-1]):
            seed = self._best_lcp_seed(key)
            k, v = self._prefill_prefix_chunked(prompt_ids, seed=seed)
            if seed is not None:
                prefilled = n - seed[2]
        else:
            bucket = self._bucket_for(n)
            tokens = torch.full(
                (1, bucket), self.tokenizer.pad_id, dtype=torch.int32
            )
            tokens[0, :n] = torch.tensor(prompt_ids, dtype=torch.int32)
            _, k_all, v_all = forward_prefill(
                self.params, self.cfg, tokens.to(self.device),
                torch.tensor([n], dtype=torch.int32, device=self.device),
                return_logits=False,
            )
            k, v = k_all[:, 0], v_all[:, 0]
        pfx = _PrefixKV(k=k, v=v, length=n, token_ids=key)
        self._prefix_cache[key] = pfx

        def nbytes(p: _PrefixKV) -> int:
            return p.k.numel() * p.k.element_size() * 2

        # Oldest first, but PINNED entries are skipped: a pinned snapshot's
        # KV is what every delta-encoded prompt LCP-seeds from. If pins
        # alone exceed the budget they are kept — holding those bytes is
        # what pinning means (PinnedPrefixManager bounds the pin count).
        total = sum(nbytes(p) for p in self._prefix_cache.values())
        for old in list(self._prefix_cache):
            if total <= self.PREFIX_CACHE_BYTES or len(self._prefix_cache) <= 1:
                break
            if old == key or old in self._pinned_prefix_keys:
                continue
            total -= nbytes(self._prefix_cache.pop(old))
        if activate:
            self._prefix = pfx
        self.stats["prefix_prefills"] += 1
        self.stats["dispatches"] += 1
        self.stats["prefill_tokens"] += prefilled
        if self.profiler is not None:
            self.profiler.note_prefix_prefill(prefilled, n)

    def pin_prefix(self, prompt_ids: list[int]) -> tuple[tuple[int, ...], int]:
        """Prefill (or cache-hit) `prompt_ids` as a PINNED prefix-cache
        entry WITHOUT making it the active prefix: it stays resident,
        exempt from byte-pressure eviction, so every later delta-extended
        prompt LCP-seeds from it and prefills only its tail. Safe with
        requests in flight (the active prefix is untouched). Returns (cache
        key, prefix_epoch); callers check pin_alive before trusting it."""
        if not prompt_ids:
            raise ValueError("cannot pin an empty prefix")
        self._await_dispatch()
        self.drain_for_collectives()
        key = tuple(prompt_ids)
        t0 = time.perf_counter()
        self._set_prefix_inner(prompt_ids, activate=False)
        if self.device.type == "cuda":
            with DEVICE_WIDE:
                torch.cuda.synchronize(self.device)
        self.stats["prefix_prefill_ms"] += (time.perf_counter() - t0) * 1000.0
        if key not in self._pinned_prefix_keys:
            self._pinned_prefix_keys.add(key)
            self.stats["pinned_prefixes"] += 1
        return key, self.prefix_epoch

    def unpin_prefix(self, key: tuple[int, ...]) -> None:
        """Release a pin: the entry becomes ordinary-evictable (its KV stays
        cached until byte pressure claims it)."""
        self._await_dispatch()
        if key in self._pinned_prefix_keys:
            self._pinned_prefix_keys.discard(key)
            self.stats["pin_evictions"] += 1

    def pin_alive(self, key: tuple[int, ...], epoch: int) -> bool:
        """True iff the pin still serves: taken under the current weights
        (epoch) and its KV entry still resident and pinned."""
        return (
            epoch == self.prefix_epoch
            and key in self._pinned_prefix_keys
            and key in self._prefix_cache
        )

    def export_prefix_kv(
        self, key: tuple[int, ...]
    ) -> tuple[torch.Tensor, torch.Tensor] | None:
        """The cached KV stack of `key` (the shared prefix-KV plane exports
        pinned snapshots through here, fleet/kvplane/), or None when the
        entry is not resident. Ships the FULL capacity buffer, padding
        included, so an adopting peer installs the bytes of this engine's
        own entry, in a buffer of a length its static prefix buffers
        already know (_bind_prefix): no new capture follows. The tensors
        are this engine's own; a caller that keeps them copies them
        (pages.export_pages' host arm, adopt_prefix_pages).

        At tp > 1 this is a mirrored call: the ranks' blocks of kv heads are
        gathered over the tp group into the driver's host memory (pinned
        when the ranks serve on a card), so the driver returns the whole
        model's [L, cap, n_kv, hd] host buffers, as the JAX engine's export
        of a head-sharded entry holds every head, and a follower None. The
        `d2d` transport at tp > 1 exports through export_prefix_blocks."""
        pfx = self._prefix_cache.get(tuple(key))
        if pfx is None:
            return None
        if self.plane is None:
            return pfx.k, pfx.v
        self._await_dispatch()
        self.drain_for_collectives()
        k = self.plane.group.gather_to_root(pfx.k, dim=2)
        v = self.plane.group.gather_to_root(pfx.v, dim=2)
        return None if k is None else (k, v)

    def export_prefix_blocks(self, key: tuple[int, ...]) -> tuple[int, list] | None:
        """The `d2d` export at tp > 1 (fleet/kvplane/pages.export_pages),
        on the driver: every rank registers its block of `key`'s cached KV
        in its own export table under a new export id, which keeps the
        block alive whatever the rank's cache does next, and hands out
        rank 0's (k, v) tensors and each other rank's (k, v) pair of
        handles (parallel/ipc.py: CUDA IPC on a card, files under the
        group's scratch directory on the CPU). Returns (export id, that
        list, rank 0's first), or None when the entry is not resident. No
        byte crosses a collective or the control channel.

        The group's ExportBook decides when the ranks drop the block: once
        the page set that holds it is collected (its finalizer tells the
        book), or once this engine's prefix_epoch moves on (a swap), each
        at the group's next call or right after the call that bumped it."""
        group = self.rank_group
        if group is None:
            raise RuntimeError("export_prefix_blocks is a tp > 1 driver's call")
        from k8s_llm_scheduler_tpu_torch.parallel.launch import export_kv_blocks

        export_id = group.exports.open(self.prefix_epoch)
        try:
            out = group.on_ranks(export_kv_blocks, tuple(key), export_id, group.scratch.name)
        except BaseException:
            group.exports.dropped(export_id)  # whatever a rank registered goes
            raise
        if out[0] is None:
            group.exports.dropped(export_id)
            return None
        return export_id, out

    def _export_block(self, key: tuple[int, ...], export_id: int, scratch: str):
        """This rank's part of export_prefix_blocks."""
        from k8s_llm_scheduler_tpu_torch.parallel import ipc

        self._await_dispatch()
        pfx = self._prefix_cache.get(key)
        if pfx is None:
            return None
        kv = (pfx.k, pfx.v)
        rank = self.plane.rank
        if rank == 0:
            self._kv_exports[export_id] = (kv, [])
            return kv
        if self.device.type == "cuda":
            with DEVICE_WIDE:  # another process reads the block: it must be whole
                torch.cuda.synchronize(self.device)
        handles = [ipc.share(t, os.path.join(scratch, f"kv-{export_id}-rank{rank}-{name}.bin"))
                   for name, t in zip("kv", kv)]
        self._kv_exports[export_id] = (kv, handles)
        return tuple(handles)

    def _release_exports(self, ids: list[int]) -> None:
        """Drop the exports `ids` from this rank's export table."""
        from k8s_llm_scheduler_tpu_torch.parallel import ipc

        for export_id in ids:
            _, handles = self._kv_exports.pop(export_id, (None, []))
            for handle in handles:
                ipc.discard(handle)

    @torch.no_grad()
    def adopt_prefix_pages(
        self, prompt_ids: list[int], k: Any, v: Any
    ) -> tuple[tuple[int, ...], int]:
        """Install a peer replica's exported prefix KV as a PINNED cache
        entry: pin_prefix's outcome without paying its prefill.

        The buffers must carry this engine's KV geometry ([n_layers, cap >=
        len(prompt_ids), n_kv_heads, head_dim]); anything else raises
        before the engine is touched. They may be host tensors, numpy
        arrays or another engine's device tensors, and are COPIED into a
        buffer this engine owns (the JAX engine's arrays are immutable, so
        its entries never alias either): a later write to the filler's
        buffer, or its eviction, leaves the adopted entry as it was.

        Returns (cache key, prefix_epoch), pin_prefix's contract, under
        the same staleness rules (pin_alive / swap_params).

        At tp > 1 the pages hold the whole model's kv heads (export_prefix_kv's
        at tp > 1, or a JAX replica's at the same tp). The driver checks
        them, then every rank takes its contiguous block of heads over the
        tp group, 1/tp of the bytes each (parallel/launch.adopt_head_blocks
        through RankGroup.on_ranks: the buffers never cross the control
        channel), so the adopted entry lands as a local prefill's does.
        A tp > 1 `d2d` page set (fleet/kvplane/pages.RankBlocks: the whole
        model's shape, one block a rank) goes device to device instead:
        each rank copies the filler's same-rank block (`_adopt_block`), and
        the filler's ExportBook keeps the blocks from release meanwhile."""
        if not prompt_ids:
            raise ValueError("cannot adopt an empty prefix")
        key = tuple(prompt_ids)
        n = len(key)
        cfg = self.model_config
        want = (cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)
        kshape, vshape = tuple(k.shape), tuple(v.shape)
        if (
            len(kshape) != 4
            or kshape != vshape
            or (kshape[0], kshape[2], kshape[3]) != want
            or kshape[1] < n
        ):
            raise ValueError(
                f"adopted prefix pages have shape k={kshape} v={vshape}; "
                f"this engine needs [L={want[0]}, cap>={n}, "
                f"n_kv={want[1]}, hd={want[2]}]"
            )
        from k8s_llm_scheduler_tpu_torch.fleet.kvplane.pages import RankBlocks

        blocks = isinstance(k, RankBlocks)
        if blocks and (not isinstance(v, RankBlocks) or v.export is not k.export
                       or self.plane is None or k.export.tp != self.plane.tp):
            raise ValueError(
                f"d2d pages of a tp={k.export.tp} group adopt on an engine of the same tp "
                f"only, their k and v of one export")
        if self.plane is not None:
            if self.rank_group is None:
                raise RuntimeError(
                    "a tp rank adopts prefix pages through its driver's call")
            if blocks:
                return self._adopt_rank_blocks(list(prompt_ids), k.export)
            from k8s_llm_scheduler_tpu_torch.parallel.launch import adopt_head_blocks

            return self.rank_group.on_ranks(adopt_head_blocks, list(prompt_ids), kshape,
                                            driver_kwargs={"k": k, "v": v})[0]
        self._await_dispatch()
        # numpy pages (a wire's, or read-only ones) come in through a copy
        # torch may write
        k_d, v_d = (
            torch.empty(kshape, dtype=self.cfg.dtype, device=self.device).copy_(_as_tensor(t))
            for t in (k, v)
        )
        return self._install_adopted(key, k_d, v_d)

    def _adopt_rank_blocks(self, prompt_ids: list[int], export) -> tuple[tuple[int, ...], int]:
        """The driver's side of a d2d adoption at tp > 1: hold the filler's
        export, then every rank copies its block (launch.adopt_kv_blocks)."""
        from k8s_llm_scheduler_tpu_torch.parallel.launch import adopt_kv_blocks

        book = export.group.exports
        if not book.hold(export.export_id, export.group.engine.prefix_epoch):
            raise RuntimeError(
                f"the d2d prefix pages of {export.filler!r} were released (evicted from "
                "the plane, the filler's weights swapped, or its group closed)")
        try:
            k0, v0 = export.local
            return self.rank_group.on_ranks(
                adopt_kv_blocks, prompt_ids, export.export_id, export.handles,
                export.group is self.rank_group, export.filler,
                driver_kwargs={"k": k0, "v": v0})[0]
        finally:
            book.unhold(export.export_id)

    @torch.no_grad()
    def _adopt_block(self, prompt_ids: list[int], export_id: int, handles: list, own: bool,
                     filler: str, k=None, v=None) -> tuple[tuple[int, ...], int]:
        """One tp rank's part of a d2d adoption: the filler's same-rank
        block copied into buffers of this rank's own (rank 0 from `k`, `v`,
        a rank of the filler's own group from its export table, any other
        rank through the handles its filler rank shared)."""
        from k8s_llm_scheduler_tpu_torch.parallel import ipc

        self._await_dispatch()
        rank = self.plane.rank
        if k is None and own:
            k, v = self._kv_exports[export_id][0]
        if k is not None:
            k_d, v_d = (torch.empty(t.shape, dtype=self.cfg.dtype, device=self.device).copy_(t)
                        for t in (k, v))
            return self._install_adopted(tuple(prompt_ids), k_d, v_d)
        mine = list(handles[rank - 1])
        k_d, v_d = (torch.empty(h["shape"], dtype=self.cfg.dtype, device=self.device)
                    for h in mine)
        try:
            ipc.copy_shared(mine, [k_d, v_d])
        except (OSError, RuntimeError, ValueError) as exc:
            raise RuntimeError(
                f"tp rank {rank} could not open the d2d prefix pages of {filler!r} "
                f"(export {export_id}): {exc}") from exc
        return self._install_adopted(tuple(prompt_ids), k_d, v_d)

    @torch.no_grad()
    def _adopt_head_blocks(self, prompt_ids: list[int], shape: tuple, k=None, v=None):
        """One tp rank's part of adopt_prefix_pages: the driver (holding the
        whole model's `k`, `v`) hands each rank its block of kv heads over
        the tp group, and each rank copies its block into a buffer of its
        own."""
        self._await_dispatch()
        self.drain_for_collectives()
        L, cap, n_kv, hd = shape
        tp, local = self.plane.tp, self.cfg.n_kv_heads
        group = self.plane.group
        blocks = {}
        for name, t in (("k", k), ("v", v)):
            parts = None
            if t is not None:
                t = _as_tensor(t).to(self.cfg.dtype)
                parts = [t.narrow(2, r * local, local) for r in range(tp)]
            blocks[name] = torch.empty((L, cap, local, hd), dtype=self.cfg.dtype,
                                       device=self.device).copy_(
                group.scatter_from_root(parts, (L, cap, local, hd), self.cfg.dtype,
                                        self.device))
        return self._install_adopted(tuple(prompt_ids), blocks["k"], blocks["v"])

    def _install_adopted(self, key: tuple[int, ...], k_d: torch.Tensor,
                         v_d: torch.Tensor) -> tuple[tuple[int, ...], int]:
        """Cache adopted buffers (this engine's own) as a pinned entry."""
        n = len(key)
        if self.device.type == "cuda":
            with DEVICE_WIDE:
                torch.cuda.synchronize(self.device)
        self._prefix_cache[key] = _PrefixKV(k=k_d, v=v_d, length=n, token_ids=key)
        self._prefix_cache.move_to_end(key)
        if key not in self._pinned_prefix_keys:
            self._pinned_prefix_keys.add(key)
            self.stats["pinned_prefixes"] += 1
        # created at the first adoption, as in the JAX engine's stats
        self.stats["adopted_prefixes"] = self.stats.get("adopted_prefixes", 0) + 1
        return key, self.prefix_epoch

    def drain_for_collectives(self) -> None:
        """At tp > 1, drain the resident loop before this thread issues a
        tp collective. The loop's iterations and this thread's model calls
        each hold the rank's `_device_lock` while they wait for their peers'
        collectives, and each rank's threads meet the lock in their own
        order: a rank whose wave holds it would wait for a peer whose
        micro-chunk holds that peer's, each for the other. So every call
        that runs collectives here exits the loop first, on every rank (a
        mirrored call does it on each), and the loop relaunches at the next
        admission. At tp 1 a wave may run beside the loop, as in the JAX
        engine."""
        if self.plane is not None and self.persistent_active:
            self.exit_persistent()

    def _best_lcp_seed(self, key: tuple[int, ...]):
        """(k, v, reuse_len) of the cached prefix sharing the longest common
        token prefix with `key`, or None below a small threshold. Causal
        attention makes the KV of every token before the first changed one
        identical, so only the changed tail is prefilled again."""
        chunk = min(self.prefix_chunk, self.prefill_buckets[-1])
        threshold = max(chunk // 2, 64)
        key_arr = np.asarray(key, dtype=np.int64)
        best: _PrefixKV | None = None
        best_reuse = 0
        for old_key, pfx in self._prefix_cache.items():
            m = min(len(old_key), len(key))
            if m < threshold:
                continue
            old_arr = np.asarray(old_key[:m], dtype=np.int64)
            mismatch = np.nonzero(old_arr != key_arr[:m])[0]
            lcp = int(mismatch[0]) if mismatch.size else m
            if lcp > best_reuse:
                best_reuse, best = lcp, pfx
        if best is None or best_reuse < threshold:
            return None
        return best.k, best.v, best_reuse

    @torch.no_grad()
    def _prefill_prefix_chunked(self, prompt_ids: list[int], seed=None):
        """Blockwise prefill: each chunk attends the dense KV accumulated so
        far (K1) plus causally within itself (K2), then its KV is appended.
        `seed` = (k, v, reuse_len) copies the first reuse_len tokens' KV
        from a cached buffer and resumes there.

        Returns (k, v) [L, cap, n_kv, hd]. cap keeps one chunk of headroom
        beyond the rounded length, as the JAX engine does: an unaligned
        resume writes chunk-wide blocks past n, and seeded and fresh
        prefills of one length share one buffer shape."""
        chunk = min(self.prefix_chunk, self.prefill_buckets[-1])
        n = len(prompt_ids)
        cap = -(-n // chunk) * chunk + chunk
        done = 0 if seed is None else seed[2]
        pad = self.tokenizer.pad_id
        k_buf = self._zeros_kv(cap)
        v_buf = self._zeros_kv(cap)
        if seed is not None:
            seed_k, seed_v, reuse = seed
            k_buf[:, :reuse] = seed_k[:, :reuse]
            v_buf[:, :reuse] = seed_v[:, :reuse]
            self.stats["prefix_reused_tokens"] += reuse
        ids = torch.tensor(prompt_ids, dtype=torch.int32)
        for start in range(done, n, chunk):
            m = min(chunk, n - start)
            tokens = torch.full((1, chunk), pad, dtype=torch.int32)
            tokens[0, :m] = ids[start:start + m]
            _, k_c, v_c = forward_prefill_suffix_dense(
                self.params, self.cfg, tokens.to(self.device),
                torch.tensor([m], dtype=torch.int32, device=self.device),
                k_buf, v_buf,
                torch.tensor(done, dtype=torch.int32, device=self.device),
            )
            # the headroom guarantees start + chunk <= cap: slicing never
            # clamps the way a JAX dynamic_update_slice would
            k_buf[:, start:start + chunk] = k_c[:, 0]
            v_buf[:, start:start + chunk] = v_c[:, 0]
            done += m
        return k_buf, v_buf

    def _bind_prefix(self, prefix: _PrefixKV | None = None) -> _StaticPrefix:
        """`prefix` (default: the active prefix, the empty one if none) in
        the static buffer of its length Sp, and its length in the static
        scalar: copied only after a switch (~0.7 ms for 1 GB at 8B). Graphs
        read these buffers, never a `_prefix_cache` entry, which eviction
        may free."""
        if prefix is None:
            prefix = self._prefix = self._prefix or self._get_empty_prefix()
        sp = self._static_prefix.get(prefix.k.shape[1])
        if sp is None:
            sp = _StaticPrefix(k=torch.empty_like(prefix.k), v=torch.empty_like(prefix.v))
            self._static_prefix[prefix.k.shape[1]] = sp
        if sp.src is None or sp.src() is not prefix:
            sp.k.copy_(prefix.k)
            sp.v.copy_(prefix.v)
            sp.src = weakref.ref(prefix)
        if self._plen_loaded != prefix.length:
            self._plen_d.fill_(prefix.length)
            self._plen_loaded = prefix.length
        return sp

    @property
    def prefix_len(self) -> int:
        return self._prefix.length if self._prefix else 0

    def _bucket_for(self, n: int) -> int:
        for bkt in self.prefill_buckets:
            if n <= bkt:
                return bkt
        raise ValueError(
            f"prompt of {n} tokens exceeds largest prefill bucket "
            f"{self.prefill_buckets[-1]}"
        )

    # ---------------------------------------------------------------- waves
    def _wave_geometry(self, n_prompts: int, max_new_tokens: int) -> tuple[int, int, int]:
        """(R, n_iters, F) for a wave of `n_prompts`: two row buckets (half
        and full max_slots); with a grammar, wave_iterations(dfa) block
        iterations of width wave_block, else one token per iteration;
        n_iters rounded up to a multiple of 4 (the JAX engine's compile
        buckets, kept so both engines run the same geometry)."""
        half = self.max_slots // 2
        R = half if 0 < n_prompts <= half else self.max_slots
        if self._constrained and self._grammar_wave_iters is not None:
            F = self.wave_block
            n_iters = min(self._grammar_wave_iters, max_new_tokens)
        else:
            F = 1
            n_iters = max_new_tokens
        n_iters = max(4, -(-n_iters // 4) * 4)
        return R, n_iters, F

    def _wave_key(
        self, R: int, bucket: int, n_iters: int, F: int, max_new: int
    ) -> tuple:
        """Identity of one compiled wave variant: everything that changes the
        captured programs' shapes or static values. Prefix buffer length and
        grammar table shapes are included (as in the JAX engine): a same-R
        wave against a longer prefix or a wider DFA bucket is another
        variant."""
        prefix = self._prefix or self._get_empty_prefix()
        return (
            R, bucket, n_iters, F, max_new,
            prefix.k.shape[1], tuple(self._sp_tokens.shape), self._constrained,
        )

    def wave_prewarm_backlog(self) -> int:
        """Number of sibling wave geometries not yet captured (read-only;
        safe to poll from other threads)."""
        return len(self._missing_wave_siblings())

    def _missing_wave_siblings(self) -> list[tuple[int, int, int]]:
        """(n_prompts, bucket, max_new) probes for wave variants adjacent to
        ones already used: BOTH row buckets at every seen (suffix bucket,
        budget). A burst normally runs full-R waves, then one straggler
        forms a half-R tail, whose variant must not be captured mid-burst."""
        out = []
        # list(): the owner thread adds to these while others poll
        for bucket, max_new in list(self._wave_shapes_seen):
            for n_prompts in (1, self.max_slots):
                R, n_iters, F = self._wave_geometry(n_prompts, max_new)
                key = self._wave_key(R, bucket, n_iters, F, max_new)
                if key not in self._wave_compiled and key not in self._wave_prewarm_failed:
                    out.append((n_prompts, bucket, max_new))
        return out

    def prewarm_wave_siblings(self, limit: int | None = None) -> int:
        """Capture up to `limit` missing sibling wave geometries by
        dispatching one dummy wave each (row 0 holds a single real token,
        the rest are padding; its results are discarded and it shares
        nothing with slot state), on the calling thread once the dispatcher
        has queued every wave before. Engine-owner thread only. A failed
        dispatch is recorded and counted, and its geometry stays cold (a
        real wave of it captures it again, or raises). Returns the number
        captured."""
        self._await_dispatch()
        self.drain_for_collectives()
        done = 0
        for n_prompts, bucket, max_new in self._missing_wave_siblings():
            if limit is not None and done >= limit:
                break
            R, n_iters, F = self._wave_geometry(n_prompts, max_new)
            pad = self.tokenizer.pad_id
            tokens = np.full((R, bucket), pad, dtype=np.int32)
            tokens[0, 0] = self.tokenizer.eos_id
            suffix_lens = np.zeros(R, dtype=np.int32)
            suffix_lens[0] = 1
            max_new_vec = np.zeros(R, dtype=np.int32)
            max_new_vec[0] = max_new
            key = self._wave_key(R, bucket, n_iters, F, max_new)
            try:
                var = self._run_wave(key, R, bucket, n_iters, F, max_new,
                                     tokens, suffix_lens, max_new_vec)[0]
            except Exception:
                # Record and move on: the backlog must drain even when a
                # dispatch fails.
                self._wave_prewarm_failed.add(key)
                self.stats["wave_prewarm_failures"] += 1
                logger.exception("wave prewarm dispatch failed for geometry %s", key)
                continue
            self._wave_compiled[key] = (var.prefill, var.iteration)
            self.stats["wave_prewarms"] += 1
            done += 1
        return done

    def _grammar(self) -> tuple:
        """The installed grammar as a wave binds it: (its device tables,
        whether it constrains)."""
        return ((self._sp_tokens, self._sp_next, self._forced, self._forced_next),
                self._constrained)

    def _run_wave(self, key, R, bucket, n_iters, F, max_new_tokens,
                  tokens, suffix_lens, max_new, prefix=None, grammar=None,
                  stamp=None):
        """Dispatch one wave on this thread: `prefix` (default: the active
        one) into the static prefix buffer, a new variant's grammar tables
        `grammar` (default: the installed grammar), its inputs into the
        variant's static buffers, the suffix prefill, then
        block iterations until `n_iters` or until no row is alive, the flags
        read one iteration behind; then the copies of its results to the
        host. Returns (variant, tokens on the host, valid tokens of each
        call on the host, iterations counted, the copies' fence). Holds the
        device lock: a resident loop's micro-chunks wait for the wave.
        `stamp`, a WaveHandle, gets its `dispatch_end` once the suffix
        prefill is queued, and on a card its `timing` events."""
        with self._device_lock:
            return self._run_wave_locked(key, R, bucket, n_iters, F, max_new_tokens,
                                         tokens, suffix_lens, max_new, prefix, grammar,
                                         stamp)

    def _run_wave_locked(self, key, R, bucket, n_iters, F, max_new_tokens,
                         tokens, suffix_lens, max_new, prefix, grammar, stamp):
        timed = stamp is not None and self.device.type == "cuda"
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        static_prefix = self._bind_prefix(prefix)
        var = self._wave_variants.get(key)
        if var is None:
            var = _WaveVariant(self, key, R, bucket, n_iters, F, max_new_tokens,
                               static_prefix, grammar or self._grammar())
            self._wave_variants[key] = var
        var.load(tokens, suffix_lens, max_new)
        var.prefill.run()
        if stamp is not None:
            stamp.dispatch_end = time.perf_counter()
        fences = (Fence(self.device), Fence(self.device))
        iters = n_iters
        for q in range(n_iters):
            var.iteration.run()
            fences[q % 2].record()
            if q:
                fences[(q - 1) % 2].synchronize()
                if not var.alive_h[q - 1]:
                    # iteration q-1 left no row alive: q ran past the end
                    iters = q
                    break
        self.stats["wave_block_calls"] += q + 1
        toks_h = host_buffer(var.out.shape, torch.int32, self.device)
        counts_h = host_buffer(var.counts.shape, torch.int32, self.device)
        toks_h.copy_(var.out, non_blocking=True)
        counts_h.copy_(var.counts, non_blocking=True)
        if timed:
            # before `done`, so that `done` having landed means it has too
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            stamp.timing = (start, end)
        done = Fence(self.device)
        done.record()
        return var, toks_h, counts_h, iters, done

    # ------------------------------------------------------ the dispatcher
    def _dispatch(self, job) -> None:
        """Hand `job` to the wave dispatcher thread, starting it if needed."""
        if self._dispatcher is None:
            self._jobs = queue.SimpleQueue()
            self._dispatcher = threading.Thread(
                target=_dispatch_loop, args=(self._jobs,), daemon=True,
                name="wave-dispatch",
            )
            self._dispatcher.start()
            weakref.finalize(self, self._jobs.put, None)
        with self._dispatch_cv:
            self._undispatched += 1
        self._jobs.put(job)

    def _await_dispatch(self) -> None:
        """Wait until the dispatcher has queued on the device the work of
        every wave submitted before: after that, work this thread queues
        runs after theirs, so it cannot change what they read."""
        with self._dispatch_cv:
            while self._undispatched:
                if not self._dispatch_cv.wait(timeout=1.0) and not self._dispatcher.is_alive():
                    raise RuntimeError("the wave dispatcher thread died")

    def _dispatch_wave(self, handle: WaveHandle, args: tuple, stamp) -> None:
        """The dispatcher's job for one wave: run it and fill in `handle`,
        or record the failure there; harvest_wave reads either. `stamp`
        (the handle, with a profiler attached) gets the dispatch's end."""
        try:
            var, handle.toks_h, handle.blk_tokens_h, handle.iters, handle.done = (
                self._run_wave(*args, stamp=stamp))
            # Recorded only after a successful dispatch (capture and
            # replays queued): a failed one leaves the geometry cold.
            self._wave_compiled[handle.geo_key] = (var.prefill, var.iteration)
        except Exception as exc:
            logger.exception("wave dispatch failed for geometry %s", handle.geo_key)
            handle.error = exc
        finally:
            handle.dispatched.set()
            with self._dispatch_cv:
                self._undispatched -= 1
                self._dispatch_cv.notify_all()

    def close(self) -> None:
        """Stop the wave dispatcher once it has queued every wave submitted
        (a later wave starts it again). Waves already handed out can still
        be harvested."""
        self._await_dispatch()
        if self._dispatcher is not None:
            self._jobs.put(None)
            self._dispatcher.join()
            self._dispatcher = self._jobs = None

    def release(self) -> None:
        """Close, then drop every device tensor the engine holds: the
        params, the paged KV, the prefix cache and its static buffers, the
        slot state, the grammar tables, every captured program with its
        static buffers (their graphs and the pool memory under them), the
        resident loop and the speculative decoder's own (spec.release). A
        backend that built the engine calls this at its close, so a closed
        arm returns its device memory without waiting for garbage
        collection. Afterwards get_stats() still answers (with the last
        page and slot counts); anything else raises. A second call does
        nothing."""
        if self.kv is None:
            return
        self.close()
        if self.persistent_active:
            try:
                self.exit_persistent()
            except Exception:
                # a loop that died (at tp > 1 with a lost peer) raised its
                # error where it was harvested; the release goes on
                logger.exception("the resident loop did not drain at release")
        self._released_kv_stats = {"pages_free": self.kv.pages_free,
                                   "slots_free": self.free_slots}
        self._persistent = None
        if self.spec is not None:
            self.spec.release()
        self.params = None
        self.kv = None
        self._by_slot.clear()
        self._prefix = self._empty_prefix = None
        self._prefix_cache.clear()
        self._pinned_prefix_keys.clear()
        self._release_exports(list(self._kv_exports))
        self._static_prefix.clear()
        self._wave_variants.clear()
        self._wave_compiled.clear()
        self._chunk = None
        self._chunk_variants.clear()
        self._fused_variants.clear()
        self._fused_next_d = self._fused_dummy = None
        self._grammar_tables.clear()
        self._sp_tokens = self._sp_next = self._forced = self._forced_next = None
        self._dfa_start_d = self._done_state_d = self._plen_d = None
        self._state = None
        self._tables_d = self._tables_src = None
        self._pending_emissions = []
        self._pending_finished = []
        with DEVICE_WIDE:  # a pool's destruction must not meet a capture
            self._graphs.body_pool = None

    def submit_wave(
        self, prompts: list[list[int]], max_new_tokens: int = 200
    ) -> WaveHandle:
        """Stage a whole batch's decode-to-completion against the installed
        prefix and grammar (_WaveVariant) and hand it to the dispatcher;
        returns at once. harvest_wave reads the results."""
        if not prompts:
            raise ValueError("empty wave")
        if any(not p for p in prompts):
            raise ValueError("empty prompt")
        if len(prompts) > self.max_slots:
            raise RuntimeError(
                f"wave of {len(prompts)} exceeds max_slots={self.max_slots}"
            )
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.drain_for_collectives()
        # the dispatch fence opens before prompt packing, as the JAX
        # engine's does; the dispatcher closes it (WaveHandle.dispatch_end)
        prof = self.profiler
        submitted_at = time.perf_counter()
        self._prefix = self._prefix or self._get_empty_prefix()

        bucket = self._bucket_for(max(len(p) for p in prompts))
        R, n_iters, F = self._wave_geometry(len(prompts), max_new_tokens)
        self._wave_shapes_seen.add((bucket, max_new_tokens))
        geo_key = self._wave_key(R, bucket, n_iters, F, max_new_tokens)
        pad = self.tokenizer.pad_id
        tokens = np.full((R, bucket), pad, dtype=np.int32)
        suffix_lens = np.zeros(R, dtype=np.int32)
        max_new = np.zeros(R, dtype=np.int32)
        for row, ids in enumerate(prompts):
            tokens[row, : len(ids)] = ids
            suffix_lens[row] = len(ids)
            max_new[row] = max_new_tokens
        req_ids = list(range(self._req_counter, self._req_counter + len(prompts)))
        self._req_counter += len(prompts)
        handle = WaveHandle(
            n=len(prompts), max_new_tokens=max_new_tokens, req_ids=req_ids,
            submitted_at=submitted_at,
            cold_compile=geo_key not in self._wave_compiled, geo_key=geo_key,
        )
        # the prefix and grammar this wave was submitted under, bound on the
        # dispatcher in FIFO order
        args = (geo_key, R, bucket, n_iters, F, max_new_tokens, tokens, suffix_lens,
                max_new, self._prefix, self._grammar())
        stamp = handle if prof is not None else None
        self._dispatch(lambda: self._dispatch_wave(handle, args, stamp))
        self.stats["waves"] += 1
        self.stats["dispatches"] += 1
        self.stats["prefill_tokens"] += int(suffix_lens.sum())
        self.stats["requests"] += len(prompts)
        if prof is not None:
            prof.on_submit(
                handle, submitted_at, time.perf_counter(),
                suffix_tokens=int(suffix_lens.sum()), n_requests=len(prompts),
                prefix_len=self._prefix.length, cold_compile=handle.cold_compile,
            )
        return handle

    def harvest_wave(self, handle: WaveHandle) -> list[Finished]:
        """One wave's results from the host buffers: waits for its dispatch,
        then for their copy. A failed dispatch raises BackendError. With a
        profiler attached, it books the wave's fences: its dispatch end
        (the dispatcher's stamp, or this entry if that came later, so the
        segments telescope), the entry, the results' arrival and the end
        of the decode."""
        prof = self.profiler
        if prof is not None:
            t_harvest0 = time.perf_counter()
            ready_at_entry = handle.is_ready()
        while not handle.dispatched.wait(timeout=1.0):
            if self._dispatcher is None or not self._dispatcher.is_alive():
                raise BackendError("the wave dispatcher stopped before this wave ran")
        if handle.error is not None:
            raise BackendError(f"wave dispatch failed: {handle.error}") from handle.error
        handle.done.synchronize()
        if prof is not None:
            t_sync = time.perf_counter()
            # both timing events have completed: `done`, recorded after
            # them on one stream, has
            device_event_s = None
            if handle.timing is not None:
                device_event_s = handle.timing[0].elapsed_time(handle.timing[1]) / 1000.0
        toks_np = handle.toks_h.numpy()
        self.block_tokens.extend(handle.blk_tokens_h[: handle.iters].tolist())
        self.stats["wave_model_calls"] += handle.iters
        pad = self.tokenizer.pad_id
        latency_ms = (time.perf_counter() - handle.submitted_at) * 1000.0
        self.stats["wave_ms"] += latency_ms
        out: list[Finished] = []
        decode_tokens = 0
        for row in range(handle.n):
            ids = [int(t) for t in toks_np[row] if t != pad]
            ids = ids[: handle.max_new_tokens]
            self.stats["completed"] += 1
            self.stats["decode_tokens"] += len(ids)
            decode_tokens += len(ids)
            out.append(
                Finished(
                    req_id=handle.req_ids[row],
                    token_ids=ids,
                    text=self.tokenizer.decode(ids),
                    latency_ms=latency_ms,
                )
            )
        if prof is not None:
            if handle.dispatch_end is not None:  # None: submitted before attach
                prof.note_dispatch_end(handle, min(handle.dispatch_end, t_harvest0))
            prof.on_harvest(
                handle, t_harvest0, t_sync, time.perf_counter(),
                decode_tokens=decode_tokens, model_calls=handle.iters,
                ready_at_entry=ready_at_entry, device_event_s=device_event_s,
            )
        return out

    def decide_wave(
        self, prompts: list[list[int]], max_new_tokens: int = 200
    ) -> list[Finished]:
        """Synchronous wave: submit + harvest."""
        return self.harvest_wave(self.submit_wave(prompts, max_new_tokens))

    # ------------------------------------------------------ general path
    @property
    def free_slots(self) -> int:
        return self.max_slots - len(self._by_slot)

    @property
    def has_active(self) -> bool:
        return bool(self._by_slot)

    def max_suffix_tokens(self, max_new_tokens: int) -> int:
        """Longest admissible prompt/suffix for the paged path: bounded by
        the page-table width and the largest prefill bucket."""
        by_pages = self.kv.max_pages_per_seq * self.kv.page_size - (max_new_tokens + 1)
        return min(by_pages, self.prefill_buckets[-1])

    def _padded_tables(self) -> torch.Tensor:
        """The static page tables: the kv tables plus the all-zeros trash
        row, copied in after a table change."""
        src = self.kv.page_tables()
        if src is not self._tables_src:
            self._tables_src = src
            self._tables_d[: src.shape[0]].copy_(src)
        return self._tables_d

    def add_request(self, prompt_ids: list[int], max_new_tokens: int = 200) -> int:
        """Single-request admission; see add_requests."""
        return self.add_requests([prompt_ids], max_new_tokens)[0]

    def add_requests(
        self, prompts: list[list[int]], max_new_tokens: int = 200
    ) -> list[int]:
        """Admit a batch of requests in one admission pass (no host sync).
        Each prompt is the per-request SUFFIX if a prefix is installed
        (set_prefix), else the whole prompt; all pad to one bucket. One
        request is admitted in a 1-row batch, more in a max_slots-row batch
        whose padding rows write the trash row. Each slot reserves pages for
        its prompt and max_new_tokens + 1 more. Decoding starts at the next
        step()."""
        if not prompts:
            return []
        self._await_dispatch()
        if any(not p for p in prompts):
            raise ValueError("empty prompt")
        if len(prompts) > self.free_slots:
            raise RuntimeError(
                f"no free slots for {len(prompts)} request(s) "
                f"({self.free_slots} free) — backpressure the caller"
            )
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.persistent_active:
            # Resident-loop admission: slot allocation is host work and the
            # prefill happens IN the loop. Shapes the loop can't serve
            # (suffix past its admission bucket) drain it and fall through.
            limit = self.persistent_suffix_limit(max_new_tokens)
            if all(len(p) <= limit for p in prompts):
                return self._add_requests_persistent(prompts, max_new_tokens)
            self.stats["persistent_fallbacks"] += 1
            self.exit_persistent()
        prefix = self._prefix or self._get_empty_prefix()
        self._prefix = prefix

        ps = self.kv.page_size
        bucket = self._bucket_for(max(len(p) for p in prompts))
        n_blocks = bucket // ps
        pad = self.tokenizer.pad_id
        R = 1 if len(prompts) == 1 else self.max_slots
        trash = self.max_slots
        tokens = np.full((R, bucket), pad, dtype=np.int32)
        suffix_lens = np.zeros(R, dtype=np.int32)
        page_ids = np.zeros((R, n_blocks), dtype=np.int32)
        slot_ids = np.full(R, trash, dtype=np.int32)
        new_budgets = np.zeros(R, dtype=np.int32)

        reqs: list[_Request] = []
        slots: list[int] = []
        dev = self.device
        try:
            for row, ids in enumerate(prompts):
                n = len(ids)
                slot = self.kv.allocate_slot(n, reserve_decode=max_new_tokens + 1)
                slots.append(slot)
                pages = self.kv.slot_pages(slot)
                used = self.kv.pages_needed(n)
                tokens[row, :n] = ids
                suffix_lens[row] = n
                slot_ids[row] = slot
                new_budgets[row] = max_new_tokens - 1
                for j in range(min(used, n_blocks)):
                    page_ids[row, j] = pages[j]
                reqs.append(_Request(
                    req_id=self._req_counter, slot=slot, prompt_len=n,
                    max_new_tokens=max_new_tokens,
                ))
                self._req_counter += 1
            _admit_impl(
                self.params, self.cfg,
                torch.from_numpy(tokens).to(dev), torch.from_numpy(suffix_lens).to(dev),
                prefix.k, prefix.v,
                torch.tensor(prefix.length, dtype=torch.int32, device=dev),
                self.kv.k, self.kv.v,
                torch.from_numpy(page_ids).to(dev), torch.from_numpy(slot_ids).to(dev),
                self._state, torch.from_numpy(new_budgets).to(dev),
                self._sp_tokens, self._sp_next, self._done_state,
                self.tokenizer.eos_id, pad, self._dfa_start,
                self._gen, self.temperature, self._constrained,
                vocab_limit=self._vocab_limit,
            )
        except Exception:
            # these slots are not in _by_slot yet: nothing else frees them
            for s in slots:
                self.kv.free_slot(s)
            raise
        for req in reqs:
            req.park_floor = len(self._pending_emissions)
            self._by_slot[req.slot] = req
            # optimistic mirrors until the next sync tells the truth
            self._act_np[req.slot] = True
            self._budget_np[req.slot] = max_new_tokens - 1
        self.stats["requests"] += len(reqs)
        self.stats["prefills"] += 1
        self.stats["dispatches"] += 1
        self.stats["prefill_tokens"] += int(suffix_lens.sum())
        return [r.req_id for r in reqs]

    # ---------------------------------------------------- packed admission
    def admit_packed(
        self,
        prompts: list[list[int]],
        max_new_tokens: int = 200,
        piggyback_decode: bool = True,
    ) -> list[int]:
        """Admit a batch through the admission plane: packed chunked
        prefill (the JAX engine's admit_packed).

        Where add_requests pads every prompt to one shared bucket, this
        packs the prompts into ONE token stream cut into
        `admission_chunk_tokens` chunks with block-diagonal attention
        (engine/admission/packer.py, models/llama.forward_prefill_packed),
        so prefill compute scales with the real token count. Between
        chunks, in-flight decode slots advance by one decode chunk (SARATHI
        piggybacking), among them the pack's prompts that already ended;
        its emitted tokens park until the next step(). Nothing syncs the
        host; the next step() harvests.

        Decoding is token-identical to admitting the same prompts through
        add_requests or serially through generate() under greedy decoding
        in f32 (tests/test_torch_admission.py)."""
        if not prompts:
            return []
        self._await_dispatch()
        if any(not p for p in prompts):
            raise ValueError("empty prompt")
        if len(prompts) > self.free_slots:
            raise RuntimeError(
                f"no free slots for {len(prompts)} request(s) "
                f"({self.free_slots} free) — backpressure the caller"
            )
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        limit = self.max_suffix_tokens(max_new_tokens)
        for ids in prompts:
            if len(ids) > limit:
                raise ValueError(
                    f"prompt of {len(ids)} tokens exceeds the paged "
                    f"admission limit {limit}"
                )
        if self.persistent_active:
            # packed admission writes the paged KV and slot state with its
            # own programs: it cannot run beside the resident loop
            self.stats["persistent_fallbacks"] += 1
            self.exit_persistent()
        from k8s_llm_scheduler_tpu_torch.engine.admission.packer import pack_prompts

        # host-side enqueue walls, never synced (the JAX engine's books)
        prof = self.profiler
        t0 = time.perf_counter() if prof is not None else 0.0
        chunk_prefill_s = piggyback_s = 0.0
        prefix = self._prefix or self._get_empty_prefix()
        self._prefix = prefix
        # Parked emissions that predate this admission belong to earlier
        # slot occupants: this pack's requests must not book them (its own
        # piggybacked ones they must).
        park_floor0 = len(self._pending_emissions)
        C = self.admission_chunk_tokens
        plan = pack_prompts(prompts, C, self.tokenizer.pad_id)
        # Carry capacity bucketed by powers of two over the chunk count (the
        # JAX engine's compile buckets).
        cap_chunks = 1
        while cap_chunks < plan.n_chunks:
            cap_chunks *= 2
        cfg, dev = self.cfg, self.device
        carry_k = torch.zeros(
            (cfg.n_layers, cap_chunks * C, cfg.n_kv_heads, cfg.head_dim),
            dtype=cfg.dtype, device=dev,
        )
        carry_v = torch.zeros_like(carry_k)
        carry_seg = torch.full((cap_chunks * C,), -1, dtype=torch.int32, device=dev)
        slots: list[int] = []
        ended = 0
        try:
            for ids in prompts:
                slots.append(self.kv.allocate_slot(len(ids), reserve_decode=max_new_tokens + 1))
            inputs = self._pack_inputs(plan, slots, prefix.length, max_new_tokens)
            sp = self._bind_prefix()
            for ci, chunk in enumerate(plan.chunks):
                t_d = time.perf_counter() if prof is not None else 0.0
                self._pack_chunk(sp, inputs, ci, carry_k, carry_v, carry_seg)
                if prof is not None:
                    chunk_prefill_s += time.perf_counter() - t_d
                ended += len(chunk.ends)
                # SARATHI piggyback: between prefill chunks, every in-flight
                # decode slot (earlier requests AND pack prompts that already
                # ended) advances one decode chunk; no host sync.
                if piggyback_decode and ci + 1 < plan.n_chunks and (self._by_slot or ended):
                    t_d = time.perf_counter() if prof is not None else 0.0
                    self._pending_emissions.append(self._chunk_dispatch())
                    self.stats["piggyback_chunks"] += 1
                    if prof is not None:
                        piggyback_s += time.perf_counter() - t_d
        except Exception:
            # Roll back the allocation AND the device slot state: a prompt
            # that ended in an earlier chunk set act in its slot, and a
            # ghost-active freed slot would decode into its next occupant.
            for slot in slots:
                self.kv.free_slot(slot)
            if slots:
                idx = torch.tensor(slots, dtype=torch.long, device=dev)
                self._state.act[idx] = False
                self._state.budget[idx] = 0
                self._act_np[slots] = False
                self._budget_np[slots] = 0
            if not self._by_slot:
                # no earlier request: the parked emissions belong to the
                # failed pack's freed slots (with requests in flight they
                # stay: that decode really advanced)
                self._pending_emissions = []
            raise
        reqs: list[_Request] = []
        for ids, slot in zip(prompts, slots):
            req = _Request(
                req_id=self._req_counter, slot=slot, prompt_len=len(ids),
                max_new_tokens=max_new_tokens, park_floor=park_floor0,
            )
            self._req_counter += 1
            reqs.append(req)
            self._by_slot[slot] = req
            # optimistic mirrors until the next sync tells the truth
            self._act_np[slot] = True
            self._budget_np[slot] = max_new_tokens - 1
        self.stats["requests"] += len(reqs)
        self.stats["prefills"] += 1
        self.stats["dispatches"] += 1
        self.stats["prefill_tokens"] += plan.total_tokens
        self.stats["packed_admissions"] += 1
        self.stats["packed_prompts"] += len(prompts)
        if prof is not None:
            prof.on_pack(
                wall_s=time.perf_counter() - t0, chunk_prefill_s=chunk_prefill_s,
                piggyback_s=piggyback_s, n_prompts=len(prompts),
                tokens=plan.total_tokens, chunks=plan.n_chunks,
            )
        return [r.req_id for r in reqs]

    def _pack_inputs(self, plan, slots: list[int], prefix_len: int,
                     max_new_tokens: int) -> dict[str, torch.Tensor]:
        """Every chunk's inputs, [n_chunks, ...] each, on the device in one
        copy an array (a copy from pageable memory syncs the host, so none
        is made between chunks): tokens, segment ids, absolute positions,
        per-token page and offset (padding to scratch page 0), and the
        ending prompts' chunk index, slot (trash row M on padding), validity,
        position after the prompt and decode budget, max_slots rows a
        chunk."""
        n, C, E, ps = plan.n_chunks, plan.chunk_tokens, self.max_slots, self.kv.page_size
        pages = [self.kv.slot_pages(slot) for slot in slots]
        host = {
            "tokens": np.stack([c.tokens for c in plan.chunks]),
            "seg": np.stack([c.seg for c in plan.chunks]),
            "positions": np.stack([c.positions for c in plan.chunks]) + np.int32(prefix_len),
            "page_ids": np.zeros((n, C), dtype=np.int32),
            "offs": np.zeros((n, C), dtype=np.int32),
            "end_idx": np.zeros((n, E), dtype=np.int32),
            "end_slots": np.full((n, E), self.max_slots, dtype=np.int32),
            "end_valid": np.zeros((n, E), dtype=bool),
            "end_pos": np.zeros((n, E), dtype=np.int32),
            "end_budgets": np.zeros((n, E), dtype=np.int32),
        }
        for ci, chunk in enumerate(plan.chunks):
            for i in range(chunk.n_tokens):
                local = int(chunk.positions[i])
                host["page_ids"][ci, i] = pages[int(chunk.seg[i])][local // ps]
                host["offs"][ci, i] = local % ps
            for row, end in enumerate(chunk.ends):
                host["end_idx"][ci, row] = end.index
                host["end_slots"][ci, row] = slots[end.prompt]
                host["end_valid"][ci, row] = True
                host["end_pos"][ci, row] = prefix_len + plan.prompt_lens[end.prompt]
                host["end_budgets"][ci, row] = max_new_tokens - 1
        return {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}

    def _pack_chunk(self, sp: _StaticPrefix, inputs: dict[str, torch.Tensor], ci: int,
                    carry_k, carry_v, carry_seg) -> None:
        """Pack chunk `ci` (engine/admission/chunked.packed_admit_step),
        eager: the packed prefill against the active prefix's static buffer,
        updating the paged caches, the carry and the slot state in place."""
        from k8s_llm_scheduler_tpu_torch.engine.admission.chunked import packed_admit_step

        x = {k: v[ci] for k, v in inputs.items()}
        packed_admit_step(
            self.params, self.cfg, x["tokens"], x["seg"], x["positions"],
            sp.k, sp.v, self._plen_d,
            carry_k, carry_v, carry_seg, ci * self.admission_chunk_tokens,
            self.kv.k, self.kv.v, x["page_ids"], x["offs"],
            x["end_idx"], x["end_slots"], x["end_valid"], x["end_pos"], x["end_budgets"],
            self._state, self._sp_tokens, self._sp_next, self._done_state,
            self.tokenizer.eos_id, self.tokenizer.pad_id, self._dfa_start,
            self._gen, self.temperature, self._constrained,
            vocab_limit=self._vocab_limit,
        )
        self.stats["pack_chunks"] += 1
        self.stats["dispatches"] += 1

    def abort_all(self) -> None:
        """Free every in-flight slot and its KV pages, deactivate every
        slot on the device and drop parked emissions: the recovery path
        after a failed step, so the engine never leaks capacity. At tp > 1
        the loop drains first on every rank (an ABORT through the ring and
        the parked batches it drops could not be matched across ranks)."""
        self._await_dispatch()
        if self.plane is not None and self.persistent_active:
            self.exit_persistent()
        if self._persistent is not None:
            if self.persistent_active:
                # deactivate every resident slot through the ring (slot=-1:
                # all); the loop stays resident for new work
                try:
                    self._persistent.abort_steady(-1)
                except Exception:
                    logger.warning(
                        "persistent abort command not accepted — force-draining "
                        "the resident loop", exc_info=True,
                    )
                    self._persistent.force_stop()
                    self.exit_persistent()
            # undelivered token-ring batches belong to the aborted work: a
            # request reusing a slot must never inherit them
            self._persistent.clear_parked()
        for slot in list(self._by_slot):
            self.kv.free_slot(slot)
            del self._by_slot[slot]
        self._act_np[:] = False
        self._budget_np[:] = 0
        if not self.persistent_active:  # resident: the ring's ABORT does it
            self._state.act.zero_()
            self._state.budget.zero_()
        # a later request reusing a slot must never inherit these tokens
        self._pending_emissions = []

    def step(self, chunks: int = 1) -> list[Finished]:
        """Run `chunks` decode chunks back to back, then ONE host sync;
        returns the requests that finished (and any parked earlier)."""
        self._await_dispatch()
        if self.persistent_active:
            self.exit_persistent()
        pend = self._pending_finished
        self._pending_finished = []
        if not self._by_slot:
            return pend
        return pend + self._step_inner(chunks)

    def _chunk_key(self) -> tuple:
        """Identity of one decode-chunk variant: (M, P, Sp, chunk_steps,
        constrained, paged_attn, grammar table shape)."""
        prefix = self._prefix or self._get_empty_prefix()
        return (
            self.max_slots + 1, self.kv.max_pages_per_seq, prefix.k.shape[1],
            self.chunk_steps, self._constrained, self.paged_attn,
            tuple(self._sp_tokens.shape),
        )

    def _chunk_buffers(self, gather: bool = False) -> _ChunkBuffers:
        """The decode chunk's scratch, made at first use; the dense page
        buffers come with paged_attn="gather", or when `gather` asks for
        them (the resident loop, which always gathers, shares this set:
        it and the dispatch path never run together)."""
        cfg, dev = self.cfg, self.device
        M, P, n = self.max_slots + 1, self.kv.max_pages_per_seq, self.chunk_steps
        if self._chunk is None:
            ck = torch.zeros((cfg.n_layers, M, n, cfg.n_kv_heads, cfg.head_dim),
                             dtype=self.kv.k.dtype, device=dev)

            def i32(*shape):
                return torch.zeros(shape, dtype=torch.int32, device=dev)

            self._chunk = _ChunkBuffers(
                ck=ck, cv=torch.zeros_like(ck), tail=i32(M), own_start=i32(M),
                toks=i32(M, n), j=torch.zeros((), dtype=torch.int64, device=dev),
                u=torch.zeros((n, M), dtype=torch.float32, device=dev),
                k_own=None, v_own=None,
            )
        c = self._chunk
        if (gather or self.paged_attn == "gather") and c.k_own is None:
            own = (cfg.n_layers, M * P, self.kv.page_size, cfg.n_kv_heads, cfg.head_dim)
            c.k_own = torch.empty(own, dtype=c.ck.dtype, device=dev)
            c.v_own = torch.empty(own, dtype=c.ck.dtype, device=dev)
        return c

    def _chunk_dispatch(self) -> torch.Tensor:
        """One decode chunk (no host sync); the emitted tokens
        [max_slots + 1, chunk_steps], on their way to a host buffer."""
        self._refuse_while_resident()
        prefix = self._bind_prefix()
        self._padded_tables()
        c = self._chunk_buffers()
        key = self._chunk_key()
        var = self._chunk_variants.get(key)
        if var is None:
            var = self._chunk_variants[key] = _ChunkVariant(self, prefix)
        var.run()
        toks = host_buffer(c.toks.shape, torch.int32, self.device)
        toks.copy_(c.toks, non_blocking=True)
        self.stats["chunks"] += 1
        self.stats["dispatches"] += 1
        return toks

    def _step_inner(self, chunks: int) -> list[Finished]:
        # Decode chunks piggybacked during a packed admission ran without a
        # sync; they harvest here, first (chronological order per slot).
        emissions: list[torch.Tensor] = self._pending_emissions
        self._pending_emissions = []
        any_active = bool(
            (self._act_np & (self._budget_np > 0))[list(self._by_slot)].any()
        )
        if any_active:
            for _ in range(max(1, chunks)):
                emissions.append(self._chunk_dispatch())
        # ONE host sync (the blocking copies below wait for the stream):
        # emitted tokens, post-chunk state, first tokens.
        act_np = self._state.act.cpu().numpy()
        budget_np = self._state.budget.cpu().numpy()
        first_np = self._state.first.cpu().numpy()
        emitted_np = [e.numpy() for e in emissions]
        self.stats["syncs"] += 1
        return self._finish_harvest(emitted_np, act_np, budget_np, first_np)

    def _finish_harvest(self, emitted_np, act_np, budget_np, first_np) -> list[Finished]:
        """Resolve harvested emissions into per-request token streams and
        Finished records. Token accounting is exact: pad is never sampled
        for an active slot, so the non-pad emissions are what ran."""
        self._act_np = np.array(act_np)
        self._budget_np = np.array(budget_np)
        toks = (
            np.concatenate(emitted_np, axis=1) if emitted_np
            else np.zeros((self.max_slots + 1, 0), dtype=np.int32)
        )
        # Column offset of each harvested emission array: a request books
        # only the columns from its park_floor on.
        col_at = np.cumsum([0] + [a.shape[1] for a in emitted_np])
        finished: list[Finished] = []
        pad = self.tokenizer.pad_id
        for slot, req in list(self._by_slot.items()):
            if req.external:
                # an open speculative stream: its slot is inactive in the
                # batch, its completion and teardown belong to its owner
                continue
            if req.first_pending:
                req.generated.append(int(first_np[slot]))
                req.first_pending = False
            start = col_at[min(req.park_floor, len(emitted_np))]
            req.park_floor = 0  # the parked list is consumed by this harvest
            emitted = [int(t) for t in toks[slot, start:] if t != pad]
            req.generated.extend(emitted)
            self.stats["decode_tokens"] += len(emitted)
            if not self._act_np[slot] or self._budget_np[slot] <= 0:
                self.kv.free_slot(slot)
                del self._by_slot[slot]
                ids = req.generated[: req.max_new_tokens]
                finished.append(Finished(
                    req_id=req.req_id,
                    token_ids=ids,
                    text=self.tokenizer.decode(ids),
                    latency_ms=(time.perf_counter() - req.submitted_at) * 1000.0,
                ))
                self.stats["completed"] += 1
        self._book_decision_flow()
        return finished

    def _book_decision_flow(self) -> None:
        """Feed the profiler's dispatches_per_decision gauge: the delta of
        engine dispatches over the delta of completed decisions since the
        last completion was booked. Dispatches accumulate across harvests
        that complete nothing, so the telescoped ratio is exact."""
        if self.profiler is None:
            return
        d_done = self.stats["completed"] - self._flow_completed_last
        if d_done <= 0:
            return
        d_disp = self.stats["dispatches"] - self._flow_dispatches_last
        self._flow_completed_last = self.stats["completed"]
        self._flow_dispatches_last = self.stats["dispatches"]
        self.profiler.on_decision_flow(d_disp, d_done)

    # ---------------------------------------------------------- fused decode
    def dense_grammar(self) -> torch.Tensor | None:
        """The active grammar's dense [states, vocab] transition table on
        the device, or None (no grammar / past the byte cap). Built lazily
        on first use into the engine's table of its shape (graphs read it
        by address)."""
        if not self._constrained or self._fused_unsupported:
            return None
        if self._fused_next_d is None:
            tables = (
                dense_tables(self._dfa, self.cfg.vocab_size, self.fused_table_bytes)
                if self._dfa is not None else None
            )
            if tables is None:
                self._fused_unsupported = True
                logger.info(
                    "grammar cannot export a dense fused table (cap %d bytes); "
                    "decode stays on the sparse chunked path", self.fused_table_bytes,
                )
                return None
            self._fused_next_d = self._grammar_table("dense_next", tables.next_state)
        return self._fused_next_d

    def _fused_ready(self) -> bool:
        """Whether the fused runtime can serve the CURRENT grammar state:
        False (grammar too large for a dense table, or fused decode off)
        routes callers to step()."""
        if not self.fused_decode:
            return False
        if not self._constrained:
            return True
        return self.dense_grammar() is not None

    def _fused_chunk_dispatch(self):
        """Dispatch ONE fused decode chunk (no host sync); returns (emitted
        tokens [M+1, chunk_steps] and steps run, each on its way to a host
        buffer, and the chunk's program, which books its bodies' kernel
        launches once the steps run are known)."""
        self._refuse_while_resident()
        prefix = self._bind_prefix()
        self._padded_tables()
        c = self._chunk_buffers()
        table = self._fused_next_d if self._constrained else self._fused_dummy
        key = ("fused", *self._chunk_key(), tuple(table.shape), self.top_k)
        var = self._fused_variants.get(key)
        if var is None:
            var = self._fused_variants[key] = _FusedChunkVariant(self, prefix, table)
        var.program.run()
        toks = host_buffer(c.toks.shape, torch.int32, self.device)
        steps = host_buffer((), torch.int64, self.device)
        toks.copy_(c.toks, non_blocking=True)
        steps.copy_(c.j, non_blocking=True)
        self.stats["chunks"] += 1
        self.stats["dispatches"] += 1
        self.stats["fused_chunks"] += 1
        return toks, steps, var.program

    def step_fused(self, chunks: int = 1) -> list[Finished]:
        """step()'s fused twin: `chunks` early-exit decode chunks dispatched
        back to back, then ONE host sync. A finished batch's remaining
        chunks run no step, so token accounting stays exact: the books
        count tokens emitted and steps run, never chunk capacity. Falls
        back to step() when the fused runtime can't serve (_fused_ready)."""
        self._await_dispatch()
        if self.persistent_active:
            self.exit_persistent()
        pend = self._pending_finished
        self._pending_finished = []
        if not self._by_slot:
            return pend
        if not self._fused_ready():
            self.stats["fused_fallbacks"] += 1
            return pend + self.step(chunks)
        prof = self.profiler
        t0 = time.perf_counter() if prof is not None else 0.0
        emissions: list[torch.Tensor] = self._pending_emissions
        self._pending_emissions = []
        handles = []
        any_active = bool(
            (self._act_np & (self._budget_np > 0))[list(self._by_slot)].any()
        )
        ctx = self._mean_decode_ctx() if prof is not None else 0.0
        if any_active:
            for _ in range(max(1, chunks)):
                toks, steps, prog = self._fused_chunk_dispatch()
                emissions.append(toks)
                handles.append((steps, prog))
        t_disp = time.perf_counter() if prof is not None else 0.0
        # ONE host sync (the blocking copies below wait for the stream)
        act_np = self._state.act.cpu().numpy()
        budget_np = self._state.budget.cpu().numpy()
        first_np = self._state.first.cpu().numpy()
        t_sync = time.perf_counter() if prof is not None else 0.0
        self.stats["syncs"] += 1
        steps_run = self._book_fused_steps(handles)
        tok_before = self.stats["decode_tokens"]
        finished = self._finish_harvest(
            [e.numpy() for e in emissions], act_np, budget_np, first_np
        )
        if prof is not None:
            self._book_fused(prof, t0, t_disp, t_sync, steps_run,
                             self.stats["decode_tokens"] - tok_before, len(handles), ctx)
        return pend + finished

    def _book_fused(self, prof, t0, t_disp, t_sync, steps, tokens, chunks, ctx) -> None:
        """One fused harvest's FUSED_SEGMENTS: dispatch (the chunks queued
        back to back), host_sync (until the results are on the host),
        harvest (the token decode after it)."""
        now = time.perf_counter()
        prof.on_fused(
            wall_s=now - t0, dispatch_s=t_disp - t0, sync_s=t_sync - t_disp,
            harvest_s=now - t_sync, steps=steps, tokens=tokens, chunks=chunks,
            ctx=ctx,
        )

    def _mean_decode_ctx(self) -> float:
        """Host-side mean attention context of in-flight decode slots
        (prefix + prompt + generated so far): the profiler's fused FLOP
        books, without a device read."""
        if not self._by_slot:
            return float(self.prefix_len)
        own = [req.prompt_len + len(req.generated) for req in self._by_slot.values()]
        return self.prefix_len + sum(own) / len(own)

    def _book_fused_steps(self, handles) -> int:
        """Book the steps each harvested fused chunk ran (its host buffers
        have landed), and its conditional bodies' kernel launches."""
        total = 0
        for steps, prog in handles:
            n = int(steps)
            prog.book_bodies(n)
            total += n
        self.stats["fused_steps"] += total
        return total

    def decode_fused(self) -> list[Finished]:
        """Drive every in-flight slot to COMPLETION through the fused
        runtime: dispatch ceil(max remaining budget / chunk_steps) chunks
        back to back with no host sync between them (early exit makes the
        ones past completion nearly free), then harvest with one host sync
        a chunk, in dispatch order, while later chunks still run. The
        device-side budget guarantees completion within them. Falls back to
        a step() drain when the fused runtime can't serve."""
        self._await_dispatch()
        if self.persistent_active:
            self.exit_persistent()
        pend = self._pending_finished
        self._pending_finished = []
        if not self._by_slot:
            return pend
        if not self._fused_ready():
            self.stats["fused_fallbacks"] += 1
            out: list[Finished] = list(pend)
            # external (spec-driven) requests never finish through step():
            # draining on them would spin forever
            while any(not r.external for r in self._by_slot.values()):
                out.extend(self.step())
            return out
        prof = self.profiler
        t0 = time.perf_counter() if prof is not None else 0.0
        ctx = self._mean_decode_ctx() if prof is not None else 0.0
        emissions: list[torch.Tensor] = self._pending_emissions
        self._pending_emissions = []
        live = list(self._by_slot)
        budget_max = int(self._budget_np[live].max()) if live else 0
        n_chunks = max(1, -(-budget_max // self.chunk_steps))
        handles, fences = [], []
        for _ in range(n_chunks):
            toks, steps, prog = self._fused_chunk_dispatch()
            emissions.append(toks)
            handles.append((steps, prog))
            fences.append(Fence(self.device))
            fences[-1].record()
        t_disp = time.perf_counter() if prof is not None else 0.0
        if len(emissions) > n_chunks:
            # parked piggyback emissions: chronologically first, fetched by
            # the first sync below (counted, as the JAX engine does)
            self.stats["syncs"] += 1
        for fence in fences:
            fence.synchronize()  # one sync a chunk
            self.stats["syncs"] += 1
        t_sync = time.perf_counter() if prof is not None else 0.0
        steps_run = self._book_fused_steps(handles)
        act_np = self._state.act.cpu().numpy()
        budget_np = self._state.budget.cpu().numpy()
        first_np = self._state.first.cpu().numpy()
        tok_before = self.stats["decode_tokens"]
        finished = self._finish_harvest(
            [e.numpy() for e in emissions], act_np, budget_np, first_np
        )
        if prof is not None:
            self._book_fused(prof, t0, t_disp, t_sync, steps_run,
                             self.stats["decode_tokens"] - tok_before, n_chunks, ctx)
        return pend + finished

    def release_slot(self, slot: int) -> None:
        """Tear down one admitted slot out of band: drop its request, free
        its pages, and clear its host and device decode state. The teardown
        of completions that bypass step() (spec/decoder.py finishes and
        failures)."""
        del self._by_slot[slot]
        self.kv.free_slot(slot)
        self._act_np[slot] = False
        self._budget_np[slot] = 0
        self._state.act[slot] = False
        self._state.budget[slot] = 0

    # ---------------------------------------------------------------- swap
    @torch.no_grad()
    def swap_params(self, params: Params) -> Params:
        """Install new weights by COPYING each leaf of `params` into the
        serving tensor of the same path (the JAX engine's swap_params,
        JAX engine.py:2813-2872, rebinds `self.params` instead). Returns
        `params`, the staging tree, which the caller drops; the serving
        tensors never move.

        Why a copy and not a pointer swap: every program the engine replays
        (the wave and decode-chunk CUDA graphs, the fused WHILE program,
        the speculative verify programs) baked the address of every weight
        in at capture, and K3 reads its weight through a TMA tensor map that
        a captured launch holds by value. A rebind would leave them reading
        the old weights, or the freed memory under them; the copy keeps
        every captured program valid, reading the new values, with no
        recapture. A tied head reads `embed` (models/llama._logits), so
        copying `embed` swaps both.

        `params` must have the serving tree's structure (keys, int8
        {q, scale} pairs, an untied `lm_head` where the config has one),
        and each leaf its shape and dtype; it may lie on another device
        (the donate mode's host tree). A tree that differs raises
        ValueError before any leaf is written.

        Engine-owner thread only, at a wave barrier (LocalLLMBackend.
        run_quiesced): the copies queue after every wave submitted before,
        so those waves read the old weights and the next one the new.
        Everything derived from the old weights is invalidated, as in the
        JAX engine: the resident loop exits (it relaunches lazily), open
        speculative streams roll back (spec/decoder.on_swap), the prefix
        cache and the pins clear and prefix_epoch bumps (a pin taken under
        the old weights never serves again), and the active prefix drops
        unless paged slots are in flight (they continue against it:
        token-identical only for identical params). The decision cache
        above the engine bumps its own generation, and the fleet's shared
        prefix-KV plane its store generation (rollout/hotswap.py).

        Engines built over ONE params tree (an in-process fleet sharing
        one copy of the weights on the card) share the serving tensors: a
        swap through one of them changes the other's weights as well, but
        bumps only this engine's prefix_epoch, so the other's prefix cache,
        pins and adopted pages stay marked current under weights they were
        not computed with. Swap such engines together. (The JAX engine
        rebinds, and a production deployment builds one engine a process,
        so neither meets this.)

        At tp > 1 `params` is this rank's block, and every rank swaps at the
        same barrier: parallel/launch.stage_swap / install_swap /
        donate_swap run it on each rank through RankGroup.on_ranks, each
        rank restoring its own block (rollout/hotswap.HotSwapper(mesh=)).
        The driver refuses a call made of it alone, which would leave the
        followers on the old weights."""
        if self.rank_group is not None and not self.rank_group.inside():
            raise RuntimeError(
                "swap_params on a tp driver swaps one rank: swap every rank "
                "through rollout.HotSwapper(mesh=) (parallel/launch.stage_swap)")
        pairs: list[tuple[torch.Tensor, torch.Tensor]] = []
        _match_tree(self.params, params, "params", pairs)
        self._await_dispatch()
        if self.persistent_active:
            self.exit_persistent()
        if self.spec is not None:
            self.spec.on_swap()
        for dst, src in pairs:
            if src is not dst:
                dst.copy_(src)
        self._prefix_cache.clear()
        self._pinned_prefix_keys.clear()
        self.prefix_epoch += 1
        if self._by_slot:
            logger.warning(
                "weight swap with %d paged request(s) in flight — they "
                "continue against the pre-swap prefix KV (token-identical "
                "only for identical params)", len(self._by_slot),
            )
        else:
            self._prefix = None
        self.stats["weight_swaps"] += 1
        return params

    def attach_spec(self, decoder) -> None:
        """Attach a speculative decoder (spec/decoder.SpeculativeDecoder), or
        detach with None. generate() then routes single-request completions
        through it; the fused runtime stays the fallback (prompts it does
        not support, auto-disable), and add_requests/step are unchanged. An
        open speculative stream occupies only its own slot
        (_Request.external). A resident loop drains first: spec rounds are
        dispatches of their own, which cannot run beside it
        (persistent_supported is False while a decoder is attached)."""
        self._refuse_tp("speculative decoding")
        if decoder is not None and self.persistent_active:
            self.exit_persistent()
        self.spec = decoder

    def attach_profiler(self, profiler) -> None:
        """Attach a continuous wave profiler (observability/profiler.py
        EngineProfiler), or detach with None. Waves, packs, fused and
        resident harvests and prefix prefills then book their fences into
        it; engine/local.py adds the queue-stall and ready-edge fences."""
        self.profiler = profiler

    def generate(self, prompt_ids: list[int], max_new_tokens: int = 200,
                 use_spec: bool | None = None) -> Finished:
        """Synchronous single-request generation. `use_spec`: None =
        speculative when a decoder is attached (attach_spec) and the
        request fits it; True/False force the path. Otherwise, while the
        resident loop serves, the request goes through its command ring
        and the token ring is drained until it completes; else it decodes
        through the FUSED runtime (decode_fused, which falls back to step()
        when the grammar can't fuse). Other requests that finish meanwhile
        are parked for the next harvest."""
        if use_spec is None:
            use_spec = self.spec is not None
        if use_spec and self.spec is not None and self.spec.supports(
                prompt_ids, max_new_tokens):
            return self.spec.generate(prompt_ids, max_new_tokens)
        req_id = self.add_request(prompt_ids, max_new_tokens)
        if self.persistent_active and self._persistent.follower:
            fin = self._follow_request(req_id)
            if fin is not None:
                return fin
        elif self.persistent_active:
            while True:
                fins = self.step_persistent(timeout_s=1.0)
                mine = [f for f in fins if f.req_id == req_id]
                self._pending_finished.extend(f for f in fins if f.req_id != req_id)
                if mine:
                    return mine[0]
                if not self.persistent_active:
                    break  # drained (wedge): finish on the dispatch path
        while True:
            fins = self.decode_fused()
            mine = [f for f in fins if f.req_id == req_id]
            self._pending_finished.extend(f for f in fins if f.req_id != req_id)
            if mine:
                return mine[0]

    # ------------------------------------------------- persistent serving
    def persistent_supported(self) -> bool:
        """Whether the resident loop can serve the CURRENT engine state.
        False routes to the dispatch path: flag off, a prior wedge
        (latched: a wedging workload must not relaunch-thrash), a
        speculative decoder attached (spec drives slots through dispatches
        of its own), or the fused runtime unavailable (the loop's body IS
        the fused step)."""
        if not self.persistent_loop or self._persistent_wedged:
            return False
        if self.spec is not None:
            return False
        return self._fused_ready()

    @property
    def persistent_active(self) -> bool:
        return self._persistent is not None and self._persistent.running

    def _refuse_while_resident(self) -> None:
        if self.persistent_active:
            raise RuntimeError(
                "the resident loop owns the slots: exit_persistent() before a dispatch"
            )

    def persistent_suffix_limit(self, max_new_tokens: int) -> int:
        """Largest suffix the resident loop's fixed-shape ADMIT can carry
        (its bucket, tightened by the paged budget bound). Callers routing
        work pre-filter on this, so an oversized suffix rides the dispatch
        path instead of draining the loop mid-burst."""
        if self._persistent is not None:
            bucket = self._persistent.suffix_bucket
        else:
            bucket = self.persistent_suffix_bucket or self.prefill_buckets[0]
        return min(bucket, self.max_suffix_tokens(max_new_tokens))

    def enter_persistent(self) -> bool:
        """Launch the resident serving loop (engine/persistent/) over this
        engine's slots. Every admission, decode step and emission until
        exit_persistent is ring traffic on this thread. Returns False when
        unsupported (the caller stays on the dispatch path). At tp > 1 a
        mirrored call: every rank launches its own loop, the driver's
        deciding each iteration (engine/persistent/server.py)."""
        if self.persistent_active:
            return True
        if not self.persistent_supported():
            return False
        if self._persistent is None:
            from k8s_llm_scheduler_tpu_torch.engine.persistent.server import (
                PersistentServer,
            )

            tp_groups = {}
            if self.plane is not None:
                # every rank creates them here, in the same mirrored call
                from k8s_llm_scheduler_tpu_torch.parallel.launch import (
                    CONTROL_TIMEOUT_S,
                    AxisGroup,
                )

                axis = self.plane.tp_axis
                tp_groups = dict(
                    channel=AxisGroup.for_mesh(self.mesh, axis, tag="resident-commands",
                                               backend="gloo", timeout_s=CONTROL_TIMEOUT_S),
                    loop_group=AxisGroup.for_mesh(self.mesh, axis, tag="resident"))
            self._persistent = PersistentServer(
                self,
                suffix_bucket=self.persistent_suffix_bucket,
                wedge_timeout_s=self.persistent_wedge_timeout_s,
                telemetry=self.persistent_telemetry,
                stats_every=self.persistent_stats_every,
                blackbox_depth=self.persistent_blackbox_depth,
                **tp_groups,
            )
        self._persistent.launch()
        # A fresh residency restarts the device counter block at zero, so
        # the host's delta baselines restart too.
        self._pers_ctr_last = np.zeros(N_COUNTERS, dtype=np.int64)
        self._pers_stall_last = self._persistent.tokens.stalls
        self._pers_ctr_final = None
        self.stats["persistent_launches"] += 1
        self.stats["dispatches"] += 1
        # The launch (and any set-up dispatch since the last completion
        # window) amortizes over the residency: re-baseline the flow books,
        # or the zero-dispatch gauge would read the set-up in its first
        # steady-state window.
        self._flow_dispatches_last = self.stats["dispatches"]
        self._pers_tok_last = time.perf_counter()
        return True

    def exit_persistent(self) -> None:
        """Quiesce the resident loop; the dispatch path resumes EXACTLY
        where it left off (mid-stream slots keep decoding
        token-identically). Completions recovered by the final harvest park
        in _pending_finished for the next harvesting call."""
        if not self.persistent_active:
            return
        srv = self._persistent
        final = srv.quiesce()
        # the residency's EXACT device counter totals, for the
        # reconciliation pin: emitted equals the decode tokens harvested
        # off the ring, token for token
        self._pers_ctr_final = counters_dict(final["ctr"])
        srv.stats_ring.clear_parked()
        # the loop wrote admitted slots' rows into the static page tables;
        # the host allocator is authoritative: copy it in again when next
        # needed
        self._tables_src = None
        self._pending_finished.extend(self._persistent_harvest(srv.harvest_steady(0.0)))
        # A force-stopped (wedged) loop can leave ADMIT commands undrained:
        # those requests never reached the device. Free their slots and
        # finish them truncated (they never emitted a token).
        while (cmd := srv.commands.take()) is not None:
            if cmd.op != OP_ADMIT:
                continue
            req = self._by_slot.pop(cmd.slot, None)
            if req is None:
                continue
            self.kv.free_slot(cmd.slot)
            self._act_np[cmd.slot] = False
            self._budget_np[cmd.slot] = 0
            ids = req.generated[: req.max_new_tokens]
            self._pending_finished.append(Finished(
                req_id=req.req_id, token_ids=ids, text=self.tokenizer.decode(ids),
                latency_ms=(time.perf_counter() - req.submitted_at) * 1000.0,
            ))
            self.stats["completed"] += 1

    def step_persistent(self, timeout_s: float = 0.05) -> list[Finished]:
        """Steady-state persistent tick: drain the token ring, book the
        emissions, return completions; no device call on this thread. Also
        the wedge watchdog: a loop that stops beating is force-stopped and
        drained back to the dispatch path, latching _persistent_wedged."""
        out = list(self._pending_finished)
        self._pending_finished = []
        if not self.persistent_active:
            return out
        srv = self._persistent
        if srv.failed():
            # the resident thread died (at tp > 1, say, a peer rank lost):
            # its exit raises the loop's error, or the group's
            self.exit_persistent()
        if srv.wedged():
            logger.warning(
                "persistent loop wedged (no heartbeat for %.0fs) — "
                "force-draining back to the dispatch path", srv.wedge_timeout_s,
            )
            self.stats["persistent_wedges"] += 1
            self._persistent_wedged = True
            srv.force_stop()
            self.exit_persistent()
            out.extend(self._pending_finished)
            self._pending_finished = []
            return out
        prof = self.profiler
        t0 = time.perf_counter()
        tok_before = self.stats["decode_tokens"]
        step_before = self.stats["persistent_steps"]
        batches = srv.harvest_steady(timeout_s)
        t1 = time.perf_counter()
        out.extend(self._persistent_harvest(batches))
        if prof is not None:
            # PERSISTENT_SEGMENTS over the window since the last harvest,
            # each clamped to the wall so they sum to it exactly
            now = time.perf_counter()
            wall = max(now - self._pers_tok_last, 0.0)
            ring_wait = min(t1 - t0, wall)
            harvest = min(now - t1, wall - ring_wait)
            loop_resident = max(wall - ring_wait - harvest, 0.0)
            prof.on_persistent(
                wall_s=wall, ring_wait_s=ring_wait, harvest_s=harvest,
                loop_resident_s=loop_resident,
                steps=self.stats["persistent_steps"] - step_before,
                tokens=self.stats["decode_tokens"] - tok_before,
                batches=len(batches),
                loop_segments=self._decompose_loop_resident(srv, loop_resident),
            )
            self._pers_tok_last = now
        return out

    def _decompose_loop_resident(self, srv, loop_resident_s: float) -> dict[str, float] | None:
        """Split the opaque `loop_resident` window into
        PERSISTENT_LOOP_SEGMENTS (admit / decode / ring_stall / idle) in
        proportion to the resident counters' deltas since the previous
        window (the StatsRing's newest snapshot): admissions taken, decode
        steps run, token-ring stalls (a host book) and idle chunks. The
        last segment is the exact remainder, so they sum to the window.
        Also feeds the EWMA of in-loop decision latency (admission to first
        emission, in iterations, times the mean iteration wall). None (the
        sub-books unchanged) when telemetry is off or no snapshot landed in
        this window."""
        if not srv.telemetry:
            return None
        snaps = srv.stats_ring.drain(0.0)
        if not snaps:
            return None
        last = snaps[-1]
        cur = np.asarray(last.counters, dtype=np.int64)
        iters_start = int(self._pers_ctr_last[CTR_ITERS])
        d = cur - self._pers_ctr_last
        d_stalls = max(int(last.token_stalls) - self._pers_stall_last, 0)
        self._pers_ctr_last = cur
        self._pers_stall_last = int(last.token_stalls)
        d_iters = int(d[CTR_ITERS])
        weights = {
            "admit": float(max(int(d[CTR_ADMITS]), 0)),
            "decode": float(max(int(d[CTR_STEPS]), 0)),
            "ring_stall": float(d_stalls),
            "idle": float(max(int(d[CTR_IDLE_CHUNKS]), 0)),
        }
        total_w = sum(weights.values())
        seg: dict[str, float] = {}
        remaining = max(float(loop_resident_s), 0.0)
        if total_w <= 0:
            # a window with no counted event is a parked loop: idle
            seg = {"admit": 0.0, "decode": 0.0, "ring_stall": 0.0}
        else:
            for name in ("admit", "decode", "ring_stall"):
                share = min(loop_resident_s * weights[name] / total_w, remaining)
                seg[name] = share
                remaining -= share
        seg["idle"] = remaining
        if d_iters > 0:
            mean_iter_ms = loop_resident_s / d_iters * 1000.0
            a_it = np.asarray(last.admit_iter)
            f_em = np.asarray(last.first_emit)
            fresh = (a_it >= iters_start) & (f_em >= a_it)
            if fresh.any():
                lat_ms = float((f_em[fresh] - a_it[fresh] + 1).mean()) * mean_iter_ms
                self._resident_latency_ms = (
                    lat_ms if self._resident_latency_ms is None
                    else 0.7 * self._resident_latency_ms + 0.3 * lat_ms
                )
        return seg

    def resident_decision_latency(self) -> float | None:
        """EWMA of in-loop per-decision latency (ms): admission-to-first-
        emission iterations x mean resident iteration wall, from the
        counter deltas step_persistent books with a profiler attached. None
        until a ring-served admission completed a telemetry window.
        sched/loop.py attaches it as a synthetic `loop_resident` span."""
        return self._resident_latency_ms

    def persistent_counter_totals(self) -> dict[str, int] | None:
        """Exact device counter totals of the last drained residency: its
        `emitted` equals the decode tokens harvested off the token ring."""
        return self._pers_ctr_final

    def persistent_blackbox(self) -> dict | None:
        """Latest wedge/quiesce black-box dump; None before the first
        residency or with telemetry off."""
        if self._persistent is None or not self._persistent.telemetry:
            return None
        return self._persistent.blackbox_dump()

    def persistent_sync(self) -> dict | None:
        """The driver's resident loop state that a tp follower matches
        before each mirrored call (parallel/launch.RankGroup sends it with
        the call): batches harvested, resident or not, the wedge latch and
        count. None before the first residency."""
        if self._persistent is None:
            return None
        return {"harvested": self._pers_harvested, "active": self.persistent_active,
                "wedged": self._persistent_wedged,
                "wedges": self.stats["persistent_wedges"]}

    def follow_persistent(self, state: dict | None) -> None:
        """A tp follower, before each mirrored call: harvest its token ring
        up to the driver's count (the driver returned those completions:
        they are dropped here), exit a loop the driver's owner thread has
        drained on its own (a wedge, or a generate that met one), and take
        the driver's wedge latch. Raises when the books cannot match."""
        if state is None or self._persistent is None:
            return
        srv = self._persistent
        if srv.running:
            while self._pers_harvested < state["harvested"]:
                batch = srv.take_one(self.mesh.timeout_s)
                if batch is None:
                    break  # the loop ended: the exit below harvests the rest
                self._persistent_harvest([batch])
            if not state["active"] or srv.failed():
                self.exit_persistent()
        self._persistent_wedged = state["wedged"]
        self.stats["persistent_wedges"] = state["wedges"]
        if self._pers_harvested != state["harvested"]:
            raise RuntimeError(
                f"tp follower harvested {self._pers_harvested} resident batches, the "
                f"driver {state['harvested']}: the ranks are out of step")

    def _follow_request(self, req_id: int) -> Finished | None:
        """A tp follower's generate() through the resident loop: harvest one
        batch at a time until `req_id` finishes (so it never harvests past
        the driver, whose harvest drains at least that far); None when the
        driver's loop ended first (the follower's exits with it)."""
        srv = self._persistent
        while True:
            batch = srv.take_one(self.mesh.timeout_s)
            if batch is None:
                if not srv.running or srv._done.is_set():
                    self.exit_persistent()
                    return None
                raise RuntimeError("tp follower: no resident batch from the driver's loop")
            fins = self._persistent_harvest([batch])
            mine = [f for f in fins if f.req_id == req_id]
            self._pending_finished.extend(f for f in fins if f.req_id != req_id)
            if mine:
                return mine[0]

    def _persistent_harvest(self, batches) -> list[Finished]:
        """Book ring batches (in push order) into request streams: the
        persistent twin of _finish_harvest, one batch at a time because a
        slot can finish AND be reused by a later in-window admission."""
        finished: list[Finished] = []
        pad = self.tokenizer.pad_id
        self._pers_harvested += len(batches)
        for b in batches:
            if b.admit_slot >= 0:
                req = self._by_slot.get(b.admit_slot)
                if req is not None and req.first_pending:
                    req.generated.append(int(b.first_tok))
                    req.first_pending = False
            self._act_np = np.array(b.act)
            self._budget_np = np.array(b.budget)
            self.stats["persistent_steps"] += int(b.steps_run)
            self.stats["persistent_chunks"] += 1
            for slot, req in list(self._by_slot.items()):
                if req.external:
                    continue
                if req.first_pending:
                    # admitted through the ring, its admission batch later in
                    # the stream: this batch's row is a previous occupant's
                    continue
                emitted = [int(t) for t in b.emitted[slot] if t != pad]
                req.generated.extend(emitted)
                self.stats["decode_tokens"] += len(emitted)
                if not self._act_np[slot] or self._budget_np[slot] <= 0:
                    self.kv.free_slot(slot)
                    del self._by_slot[slot]
                    ids = req.generated[: req.max_new_tokens]
                    finished.append(Finished(
                        req_id=req.req_id, token_ids=ids, text=self.tokenizer.decode(ids),
                        latency_ms=(time.perf_counter() - req.submitted_at) * 1000.0,
                    ))
                    self.stats["completed"] += 1
        self._book_decision_flow()
        return finished

    def _add_requests_persistent(
        self, prompts: list[list[int]], max_new_tokens: int
    ) -> list[int]:
        """Ring-routed admission: slot/page allocation is host work, the
        suffix prefill and first-token sample happen in the resident loop
        (OP_ADMIT). No device call on this thread."""
        srv = self._persistent
        reqs: list[_Request] = []
        n_blocks = srv.suffix_bucket // self.kv.page_size
        for ids in prompts:
            n = len(ids)
            slot = self.kv.allocate_slot(n, reserve_decode=max_new_tokens + 1)
            pages = self.kv.slot_pages(slot)
            row = np.zeros(self.kv.max_pages_per_seq, dtype=np.int32)
            row[: len(pages)] = pages
            page_ids = np.zeros((1, n_blocks), dtype=np.int32)
            used = min(self.kv.pages_needed(n), n_blocks)
            page_ids[0, :used] = pages[:used]
            try:
                srv.admit_steady(ids, slot, max_new_tokens - 1, page_ids, row)
            except Exception:
                self.kv.free_slot(slot)
                raise
            req = _Request(req_id=self._req_counter, slot=slot, prompt_len=n,
                           max_new_tokens=max_new_tokens)
            self._req_counter += 1
            self._by_slot[slot] = req
            # optimistic mirrors until the admission batch tells the truth
            self._act_np[slot] = True
            self._budget_np[slot] = max_new_tokens - 1
            reqs.append(req)
        self.stats["requests"] += len(reqs)
        self.stats["persistent_admissions"] += len(reqs)
        self.stats["prefill_tokens"] += sum(len(p) for p in prompts)
        return [r.req_id for r in reqs]

    def get_stats(self) -> dict:
        if self.kv is None:  # released
            out = {**self.stats, **self._released_kv_stats}
        else:
            out = {**self.stats, "pages_free": self.kv.pages_free,
                   "slots_free": self.free_slots}
        if self._persistent is not None:
            out.update(self._persistent.stats())
        # windowed from the profiler's flow books when attached, else the
        # lifetime ratio; a residency books one dispatch, its launch (as
        # the JAX engine does), its micro-chunks none
        dpd = self.profiler.dispatches_per_decision() if self.profiler is not None else None
        if dpd is None and self.stats["completed"]:
            dpd = round(self.stats["dispatches"] / self.stats["completed"], 4)
        if dpd is not None:
            out["dispatches_per_decision"] = dpd
        # the resident loop's gauge family, as a subtree
        if self.profiler is not None and (
            self.profiler.persistent_profiled or self.stats["persistent_launches"]
        ):
            out["persistent"] = self.profiler.persistent_gauges()
        if self.spec is not None:
            out["spec"] = self.spec.stats.snapshot()
        return out
