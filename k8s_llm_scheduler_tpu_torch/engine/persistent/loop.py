"""The persistent serving loop (the port of the JAX package's
engine/persistent/loop.py).

The JAX loop is ONE long-lived `lax.while_loop` program that polls its
command ring and pushes into its token ring through ordered `io_callback`s.
A CUDA graph cannot call into Python in the middle of a replay, so the port
runs the outer loop on a RESIDENT THREAD (engine/persistent/server.py) and
each outer iteration, one "micro-chunk", as ONE device program over static
buffers, captured as a CUDA graph on a card:

1. POLL (host, `persistent_serve_impl`): the next command from the
   CommandRing, staged into pinned host buffers (fixed shapes: the ADMIT
   payload rides along zero-filled for the other ops).
2. The program (`resident_iteration`): the staged command copied to the
   device; ABORT deactivates one slot (slot >= 0) or all (slot < 0);
   ADMIT (the program's admit variant: the host knows the op before the
   launch, where the JAX program branches with `lax.cond`) prefills the
   suffix at the fixed bucket through forward_prefill_suffix against the
   active prefix (K1 + K2 on a card), samples the first token with
   sample_fused over the SAME dense table the fused dispatch path gathers
   from, and writes the slot's row; then DECODE: one fused micro-chunk,
   the EXACT step of engine/fused/loop.py with own_impl="dense" as the JAX
   loop uses, over pages gathered after the admission, so a fresh slot
   decodes in the same iteration; then the counter block; then the
   outputs copied into pinned host buffers.
3. PUSH (host): the [M, n_steps] emissions, the exact steps run, the
   post-chunk (act, budget, pos) books, the admission's (slot, first
   token) and the counter block, as one HarvestBatch into the TokenRing.
   The push blocks while the ring is full (backpressure: tokens are never
   dropped) and its return is the stop vote (watchdog drain).

The loop ends after a QUIESCE (its iteration runs no step: the command's
`run` flag gates the liveness test) or a stop vote. The slot state, page
tables and paged caches are the engine's own buffers, updated in place:
there is no donation, and the dispatch path resumes exactly where the loop
left off.

"Zero dispatches" in the port: between `launch` and `quiesce` the engine
owner's thread runs no CUDA work (admission and harvest are ring traffic);
the resident thread makes one graph launch a micro-chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from k8s_llm_scheduler_tpu_torch.engine.fused.loop import fused_decode_chunk_impl
from k8s_llm_scheduler_tpu_torch.engine.fused.sampler import sample_fused
from k8s_llm_scheduler_tpu_torch.engine.graphs import host_buffer
from k8s_llm_scheduler_tpu_torch.engine.persistent.ring import (
    OP_ABORT,
    OP_NOOP,
    OP_QUIESCE,
    Command,
    HarvestBatch,
)
from k8s_llm_scheduler_tpu_torch.models.llama import forward_prefill_suffix
from k8s_llm_scheduler_tpu_torch.observability.resident import (
    CTR_ADMITS,
    CTR_EMITTED,
    CTR_EMPTY_POLLS,
    CTR_IDLE_CHUNKS,
    CTR_ITERS,
    CTR_STEPS,
    N_COUNTERS,
)


@dataclasses.dataclass
class ResidentBuffers:
    """The resident loop's static buffers: the command as the device reads
    it (and its pinned host staging twin), the engine's chunk buffers for
    the micro-chunk (the dispatch path's set, with the gather buffers: own
    pages are always gathered dense), the counter block with its per-slot
    telemetry rows, and the pinned host buffers the outputs land in."""

    cmd: dict[str, torch.Tensor]
    cmd_h: dict[str, torch.Tensor]
    chunk: object  # the engine's _ChunkBuffers, with the gather buffers
    admit_slot: torch.Tensor
    first_tok: torch.Tensor
    ctr: torch.Tensor      # [N_COUNTERS] int32
    s_tok: torch.Tensor    # [M] int32 tokens emitted by each slot's occupant
    a_it: torch.Tensor     # [M] int32 admission iteration (-1 none)
    f_em: torch.Tensor     # [M] int32 first-emission iteration (-1 none)
    outs: dict[str, torch.Tensor]    # what the iteration hands the host
    out_h: dict[str, torch.Tensor]   # their pinned host twins
    table: torch.Tensor | None = None  # the dense grammar (or the dummy)
    prefix: object = None              # the active prefix's static buffer

    @classmethod
    def make(cls, eng, suffix_bucket: int) -> "ResidentBuffers":
        dev = eng.device
        M = eng.max_slots + 1
        P = eng.kv.max_pages_per_seq
        nb = suffix_bucket // eng.kv.page_size
        shapes = {
            "op": ((), torch.int32),
            "run": ((), torch.bool),
            "tokens": ((1, suffix_bucket), torch.int32),
            "suffix_len": ((1,), torch.int32),
            "slot": ((1,), torch.int32),
            "budget": ((1,), torch.int32),
            "prefill_pages": ((1, nb), torch.int32),
            "page_row": ((1, P), torch.int32),
        }
        cmd = {k: torch.zeros(s, dtype=d, device=dev) for k, (s, d) in shapes.items()}
        cmd_h = {k: host_buffer(s, d, dev) for k, (s, d) in shapes.items()}
        chunk = eng._chunk_buffers(gather=True)

        def i32(*shape, fill=0):
            return torch.full(shape, fill, dtype=torch.int32, device=dev)

        bufs = cls(
            cmd=cmd, cmd_h=cmd_h, chunk=chunk,
            admit_slot=i32(), first_tok=i32(),
            ctr=i32(N_COUNTERS), s_tok=i32(M), a_it=i32(M, fill=-1), f_em=i32(M, fill=-1),
            outs={}, out_h={},
        )
        bufs.outs = {
            "emitted": chunk.toks, "steps_run": chunk.j, "act": eng._state.act,
            "budget": eng._state.budget, "pos": eng._state.pos,
            "admit_slot": bufs.admit_slot, "first_tok": bufs.first_tok, "ctr": bufs.ctr,
            "s_tok": bufs.s_tok, "a_it": bufs.a_it, "f_em": bufs.f_em,
        }
        bufs.out_h = {k: host_buffer(t.shape, t.dtype, dev) for k, t in bufs.outs.items()}
        return bufs

    def reset_telemetry(self) -> None:
        """A fresh residency's counter block (the JAX loop's initial carry)."""
        self.ctr.zero_()
        self.s_tok.zero_()
        self.a_it.fill_(-1)
        self.f_em.fill_(-1)

    def stage(self, cmd: Command, pad_id: int) -> None:
        """Write `cmd` into the pinned staging buffers (host only)."""
        h = {k: v.numpy() for k, v in self.cmd_h.items()}
        h["op"][...] = cmd.op
        h["run"][...] = cmd.op != OP_QUIESCE
        if cmd.tokens is not None:
            h["tokens"][...] = cmd.tokens
        else:
            h["tokens"][...] = pad_id
        h["suffix_len"][...] = cmd.suffix_len
        h["slot"][...] = cmd.slot
        h["budget"][...] = cmd.budget
        h["prefill_pages"][...] = 0 if cmd.prefill_pages is None else cmd.prefill_pages
        h["page_row"][...] = 0 if cmd.page_row is None else cmd.page_row[None, :]

    def batch(self) -> HarvestBatch:
        """The landed outputs as one HarvestBatch (copies: the buffers are
        rewritten by the next iteration)."""
        o = {k: np.array(v.numpy()) for k, v in self.out_h.items()}
        return HarvestBatch(
            seq=0, emitted=o["emitted"], steps_run=int(o["steps_run"]), act=o["act"],
            budget=o["budget"], pos=o["pos"], admit_slot=int(o["admit_slot"]),
            first_tok=int(o["first_tok"]),
        )

    def counters(self) -> dict[str, np.ndarray]:
        """The landed counter block and telemetry rows (copies)."""
        return {k: np.array(self.out_h[k].numpy()) for k in ("ctr", "s_tok", "a_it", "f_em")}


@torch.no_grad()
def resident_iteration(eng, bufs: ResidentBuffers, *, admit: bool, telemetry: bool) -> None:
    """One micro-chunk on the device (module docstring, step 2), over the
    engine's slot state, static page tables and prefix, and paged caches."""
    c = bufs.cmd
    for k, dst in c.items():
        dst.copy_(bufs.cmd_h[k], non_blocking=True)
    s, pad_id, eos_id = eng._state, eng.tokenizer.pad_id, eng.tokenizer.eos_id
    M = s.act.shape[0]
    op, sl = c["op"], c["slot"]
    cur_iter = bufs.ctr[CTR_ITERS].clone()  # this iteration's index

    # ---- ABORT: deactivate one slot (sl >= 0) or everything (sl < 0)
    is_abort = op == OP_ABORT
    kill_all = is_abort & (sl[0] < 0)
    kill_one = is_abort & (sl[0] >= 0)
    row = sl.long().clamp(0, M - 1)  # guarded by kill_one: a no-op otherwise
    s.act.copy_(torch.where(kill_all, False, s.act))
    s.budget.copy_(torch.where(kill_all, 0, s.budget))
    s.act.index_copy_(0, row, torch.where(kill_one, False, s.act[row]))
    s.budget.index_copy_(0, row, torch.where(kill_one, 0, s.budget[row]))

    prefix = bufs.prefix
    if admit:
        # ---- ADMIT: the dispatch path's admission, in the loop
        eng._tables_d.index_copy_(0, row, c["page_row"])
        last_logits, _, _ = forward_prefill_suffix(
            eng.params, eng.cfg, c["tokens"], c["suffix_len"], prefix.k, prefix.v,
            eng._plen_d, eng.kv.k, eng.kv.v, c["prefill_pages"],
        )
        st0 = eng._dfa_start_d.view(1)
        first, st1 = sample_fused(
            last_logits, st0, bufs.table, eng._gen, eng.temperature, eng.top_k,
            eng._constrained, pad_id, eng._vocab_limit,
        )
        finished = (first == eos_id) | (st1 == eng._done_state_d)
        real = c["suffix_len"] > 0
        s.tok.index_copy_(0, row, first)
        s.pos.index_copy_(0, row, (eng._plen_d + c["suffix_len"]).int())
        s.act.index_copy_(0, row, real & ~finished)
        s.st.index_copy_(0, row, st1)
        s.budget.index_copy_(0, row, c["budget"])
        s.first.index_copy_(0, row, first)
        bufs.first_tok.copy_(first[0])
        bufs.admit_slot.copy_(sl[0])
    else:
        bufs.first_tok.fill_(pad_id)
        bufs.admit_slot.fill_(-1)

    if telemetry:
        ctr = bufs.ctr
        ctr[CTR_ITERS] += 1
        ctr[CTR_EMPTY_POLLS] += (op == OP_NOOP).int()
        if admit:
            ctr[CTR_ADMITS] += 1
            bufs.s_tok.index_fill_(0, row, 0)
            bufs.a_it.index_copy_(0, row, cur_iter.view(1))
            bufs.f_em.index_fill_(0, row, -1)

    # ---- DECODE micro-chunk: the fused chunk, pages gathered after the
    # admission (own_impl "dense", as the JAX loop)
    ch = bufs.chunk
    fused_decode_chunk_impl(
        eng.params, eng.cfg, eng.kv.k, eng.kv.v, eng._tables_d, prefix.k, prefix.v,
        eng._plen_d, s, ch, bufs.table, eng._done_state_d, eos_id, pad_id, eng._gen,
        eng.temperature, eng.chunk_steps, eng._constrained, eng.top_k, "gather",
        eng._vocab_limit, runner=eng._graphs, gate=c["run"],
    )

    if telemetry:
        # chunk emissions (pad-filtered) mirror the host's booking in
        # _persistent_harvest EXACTLY: the admission's first token rides
        # `first_tok`, not the buffer, on both sides
        counts = (ch.toks != pad_id).sum(dim=1, dtype=torch.int32)
        steps = ch.j.int()
        ctr[CTR_STEPS] += steps
        ctr[CTR_EMITTED] += counts.sum(dtype=torch.int32)
        ctr[CTR_IDLE_CHUNKS] += (steps == 0).int()
        bufs.s_tok.add_(counts)
        bufs.f_em.copy_(torch.where((bufs.f_em < 0) & (counts > 0), cur_iter, bufs.f_em))

    for k, src in bufs.outs.items():
        bufs.out_h[k].copy_(src, non_blocking=True)


def persistent_serve_impl(
    *,
    poll: Callable[[], Command],
    push: Callable[[HarvestBatch, dict], bool],
    run: Callable[[Command], tuple[HarvestBatch, dict]],
) -> None:
    """The resident thread's outer loop: POLL a command, run its micro-chunk
    (`run`: stage, launch and wait for the outputs), PUSH the batch; until a
    QUIESCE has run or the push votes stop."""
    while True:
        cmd = poll()
        batch, counters = run(cmd)
        stop = push(batch, counters)
        if cmd.op == OP_QUIESCE or stop:
            return

