"""SpeculativeDecoder: the draft-ahead / verify-behind round state machine
(the port of the JAX package's spec/decoder.py).

The decoder drives ONE request at a time over the engine's general paged
path, beside the fused decode runtime:

- **One sync a round** (*SwiftSpec*, PAPERS.md). A round queues the
  target's verify of block n and the draft's AHEAD proposal of block n+1
  back to back, then fetches once. The ahead proposal anchors on the
  draft's own guess at the round's bonus token (spec/draft.py returns the
  K+1-th sample), so when the verify fully accepts and the bonus matches
  the guess, the next round's block is already on the device and the draft
  ran in the shadow of the verify. A miss discards the ahead block (the
  dense draft buffer re-proposes from the corrected token; stale entries
  are position-masked) and costs one serial round.
- **Beside the fused runtime**. A speculative request's slot is marked
  `external` and deactivated in the engine's decode batch at start():
  fused chunks for other slots dispatch between (and during) spec rounds,
  in the device's one stream order. The auto-disable hand-off re-arms the
  slot, so the request finishes through `engine.step_fused` /
  `decode_fused`.
- **Grammar**. Greedy constrained verification masks and transitions
  through the dense transition table the fused runtime gathers from;
  sampling and grammars past the table's byte cap keep the sparse K-space
  tables (spec/verify.py).
- **The draft-free hidden-transfer arm** (*Hidden Transfer*, PAPERS.md;
  spec/hidden.py). `arm="hidden"` drops the draft model: proposals come
  from transfer heads over the target's own hidden state INSIDE the verify
  program, so a round is one program and one fetch.

The verify programs are engine/graphs Programs, one per geometry
(spec/verify.VerifyProgram): CUDA graphs on a card with the engine's graphs
on, their inputs rewritten in place each round. The draft's proposal runs
eagerly.

The per-request acceptance EWMA auto-disables a draft that stops earning
its keep (after `min_rounds` rounds); the grammar-safe
PagedKVCache.truncate absorbs every mis-speculated tail; `on_swap` rolls
back any open block before new weights install. The draft/verify/rollback
seconds of each stream are booked in `_Stream.seg`, and handed at its close
to the engine's profiler, when one is attached (SPEC_SEGMENTS,
observability/profiler.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig
from k8s_llm_scheduler_tpu_torch.models.llama import Params, init_hidden_transfer
from k8s_llm_scheduler_tpu_torch.observability.trace import recorder
from k8s_llm_scheduler_tpu_torch.spec.draft import DraftRunner
from k8s_llm_scheduler_tpu_torch.spec.verify import VerifyProgram


@dataclasses.dataclass
class SpecStats:
    requests: int = 0
    rounds: int = 0
    proposed: int = 0
    accepted: int = 0
    emitted: int = 0
    disables: int = 0
    fallback_requests: int = 0
    unsupported_requests: int = 0
    # rounds whose proposal block was already on the device when the round
    # began (the draft ran in the shadow of the previous verify), ahead
    # proposals discarded on a miss, and open-block rollbacks forced by a
    # weight swap
    overlapped_rounds: int = 0
    ahead_wasted: int = 0
    swap_rollbacks: int = 0

    def snapshot(self) -> dict[str, Any]:
        out = dataclasses.asdict(self)
        out["acceptance_rate"] = self.accepted / self.proposed if self.proposed else 0.0
        out["tokens_per_round"] = self.emitted / self.rounds if self.rounds else 0.0
        out["overlap_fraction"] = (
            self.overlapped_rounds / self.rounds if self.rounds else 0.0
        )
        return out


@dataclasses.dataclass
class _Proposal:
    """A draft proposal block on the device (draft arm). `anchor_tok` /
    `anchor_st` are the token the block continues from and the DFA state
    after it (0-dim device tensors: an ahead proposal's anchor is the
    previous block's guess, never fetched). `toks` / `states` are the [K+1]
    proposal chain (index K = the draft's guess at the round's bonus
    token); `idxs` / `logits` feed the rejection sampler."""

    anchor_tok: torch.Tensor
    anchor_st: torch.Tensor
    pos: int  # the anchor's absolute position (host bookkeeping)
    toks: torch.Tensor
    states: torch.Tensor
    idxs: torch.Tensor
    logits: torch.Tensor


@dataclasses.dataclass
class _HiddenBlock:
    """The hidden arm's next proposal block: views of the previous round's
    program outputs, with host copies of the tokens and states fetched in
    that round's one sync."""

    pos: int  # the anchor's absolute position
    toks: torch.Tensor
    states: torch.Tensor
    idxs: torch.Tensor
    logits: torch.Tensor
    toks_np: np.ndarray
    states_np: np.ndarray


@dataclasses.dataclass
class _Stream:
    """One speculative request mid-flight (the round state machine)."""

    req_id: int
    slot: int
    n_prompt: int
    max_new: int
    hard_cap: int
    generated: list[int]
    t_cur: int
    st_cur: int
    n_own: int
    finished: bool = False
    disabled: bool = False
    # Set when the auto-disable edge handed the slot back to the engine: the
    # request is a normal engine request from then on, and its Finished
    # record arrives through the caller's own step_fused()/decode_fused()
    # harvest, never through advance().
    handed_off: bool = False
    ewma: float | None = None
    rounds: int = 0
    pending: Any = None  # _Proposal | _HiddenBlock | None
    t0: float = dataclasses.field(default_factory=time.perf_counter)
    seg: dict[str, float] = dataclasses.field(
        default_factory=lambda: {"draft": 0.0, "verify": 0.0, "rollback": 0.0}
    )
    overlapped: int = 0


class SpeculativeDecoder:
    """Speculative decoding over one engine and one draft arm."""

    def __init__(
        self,
        engine,  # InferenceEngine (not annotated: avoids an import cycle)
        draft_params: Params | None = None,
        draft_cfg: LlamaConfig | None = None,
        *,
        k: int = 4,
        arm: str = "draft",
        hidden_head: Params | None = None,
        hidden_seed: int = 0,
        disable_threshold: float = 0.3,
        ewma_alpha: float = 0.3,
        min_rounds: int = 4,
    ) -> None:
        if k < 1:
            raise ValueError(f"spec_k must be >= 1, got {k}")
        if not 0.0 <= disable_threshold <= 1.0:
            raise ValueError(f"disable_threshold must be in [0, 1], got {disable_threshold}")
        if arm not in ("draft", "hidden"):
            raise ValueError(f"unknown spec arm {arm!r}")
        tok_vocab = engine.tokenizer.vocab_size
        self.engine = engine
        self.arm = arm
        self.k = int(k)
        self.disable_threshold = float(disable_threshold)
        self.ewma_alpha = float(ewma_alpha)
        self.min_rounds = int(min_rounds)
        self.stats = SpecStats()
        self._streams: dict[int, _Stream] = {}  # slot -> open stream
        self._programs: dict[tuple, VerifyProgram] = {}
        self.draft: DraftRunner | None = None
        self.hidden_head: Params | None = None
        if arm == "draft":
            if draft_params is None or draft_cfg is None:
                raise ValueError("arm='draft' needs draft_params + draft_cfg")
            if draft_cfg.vocab_size < tok_vocab:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} < tokenizer vocab {tok_vocab} "
                    f"— the draft cannot propose every legal token"
                )
            # the draft masks the same undecodable tail as the target
            draft_limit = tok_vocab if tok_vocab < draft_cfg.vocab_size else None
            self.draft = DraftRunner(draft_params, draft_cfg, vocab_limit=draft_limit)
        else:
            self.hidden_head = (
                hidden_head if hidden_head is not None
                else init_hidden_transfer(engine.cfg, self.k, seed=hidden_seed,
                                          device=engine.device)
            )

    # ------------------------------------------------------------- plumbing
    def supports(self, prompt_ids: list[int], max_new_tokens: int) -> bool:
        """Whether this request can take the speculative path (the caller
        falls back to plain decode when not, never an error): the draft
        prefills the full context in one shot, capped at the engine's
        largest bucket like every other prefill (the hidden arm keeps the
        same bound)."""
        eng = self.engine
        return eng.prefix_len + len(prompt_ids) <= eng.prefill_buckets[-1]

    def _grammar_mode(self) -> tuple[str, torch.Tensor]:
        """(grammar implementation for this round, dense table or dummy).
        Greedy constrained verification uses the dense transition table
        when the engine's grammar exports one (engine.dense_grammar());
        the rejection sampler's proposal distributions live in K-space, so
        sampling keeps the sparse tables, as does a grammar past the dense
        table's byte cap."""
        eng = self.engine
        if not eng._constrained:
            return "none", eng._fused_dummy
        if eng.temperature == 0.0:
            dense = eng.dense_grammar()
            if dense is not None:
                return "dense", dense
        return "sparse", eng._fused_dummy

    def _program(self, W: int, x_width: int, n_guess: int = 0) -> VerifyProgram:
        """The verify program of this round's geometry, made at first use
        over the engine's static prefix buffer and grammar tables."""
        eng = self.engine
        grammar, dense = self._grammar_mode()
        greedy = eng.temperature == 0.0
        prefix = eng._bind_prefix()
        key = (W, grammar, greedy, prefix.k.shape[1], tuple(eng._sp_tokens.shape),
               tuple(dense.shape), x_width, n_guess)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = VerifyProgram(
                eng, W, grammar, greedy, x_width, prefix, dense,
                hidden_head=self.hidden_head if n_guess else None, n_guess=n_guess,
            )
        return prog

    def _round_io(self, slot: int, n_own: int, w: int, hard_cap: int):
        """Host-side page bookkeeping for one round: grow the slot to cover
        the block, then map each block position to (page, offset), and the
        slot's page-table row. Positions past `hard_cap` (draft tokens that
        could never be kept within the budget) go to scratch page 0."""
        kv = self.engine.kv
        ps = kv.page_size
        kv.ensure_capacity(slot, min(n_own + w, hard_cap))
        pages = kv.slot_pages(slot)
        page_ids = np.zeros(w, dtype=np.int32)
        offs = np.zeros(w, dtype=np.int32)
        for i, p in enumerate(range(n_own, n_own + w)):
            blk = p // ps
            if p < hard_cap and blk < len(pages):
                page_ids[i] = pages[blk]
                offs[i] = p % ps
        row = np.zeros(kv.max_pages_per_seq, dtype=np.int32)
        row[: len(pages)] = pages
        return page_ids, offs, row

    def _scalar(self, value: int) -> torch.Tensor:
        """A host int as a 0-dim int32 device tensor, by a fill (no copy
        from the host, so no sync)."""
        return torch.full((), value, dtype=torch.int32, device=self.engine.device)

    def _fetch(self, *tensors: torch.Tensor) -> np.ndarray:
        """THE round's one host sync: the tensors' int32 values, in order."""
        flat = torch.cat([t.reshape(-1).to(torch.int32) for t in tensors]).cpu().numpy()
        self.engine.stats["syncs"] += 1
        return flat

    def _propose_from(self, tok, pos: int, state) -> _Proposal:
        """One draft proposal anchored at (tok @ pos, state), 0-dim device
        tensors."""
        eng = self.engine
        toks, states, idxs, logits = self.draft.propose(
            tok, pos, state, eng._sp_tokens, eng._sp_next, eng.tokenizer.pad_id,
            eng._gen, eng.temperature, self.k, eng._constrained,
        )
        return _Proposal(anchor_tok=tok, anchor_st=state, pos=pos, toks=toks,
                         states=states, idxs=idxs, logits=logits)

    # --------------------------------------------------------------- stream
    def start(self, prompt_ids: list[int], max_new_tokens: int) -> _Stream:
        """Admit a request and open its speculative stream.

        Admission is the engine's own (prompt KV into the slot's pages, the
        first token sampled exactly as plain decode), then the slot is
        marked EXTERNAL and deactivated in the engine's decode batch: fused
        chunks for other slots keep dispatching while this stream drives
        its own rounds."""
        if self._streams:
            raise RuntimeError("one speculative stream at a time")
        eng = self.engine
        req_id = eng.add_request(prompt_ids, max_new_tokens)
        slot = next(s for s, r in eng._by_slot.items() if r.req_id == req_id)
        try:
            state = eng._state
            first, act, st = self._fetch(state.first[slot], state.act[slot], state.st[slot])
            # Take the slot OUT of the engine's decode batch (after the
            # fetch: deactivation clobbers the admission-time active flag).
            eng._by_slot[slot].external = True
            state.act[slot] = False
            state.budget[slot] = 0
            eng._act_np[slot] = False
            eng._budget_np[slot] = 0
            n_prompt = len(prompt_ids)
            s = _Stream(
                req_id=req_id, slot=slot, n_prompt=n_prompt, max_new=max_new_tokens,
                hard_cap=n_prompt + max_new_tokens + 1, generated=[int(first)],
                t_cur=int(first), st_cur=int(st), n_own=n_prompt, finished=not bool(act),
            )
            # Release the admission's full decode reservation: the rounds
            # grow the slot as they go and truncate() rolls rejected tails
            # back, which only means anything if tail pages can be freed.
            eng.kv.truncate(slot, s.n_own)
            if self.arm == "draft" and not s.finished and max_new_tokens > 1:
                prefix = eng._prefix or eng._get_empty_prefix()
                t_d = time.perf_counter()
                with recorder.phase("spec_draft_prefill"):
                    # +2K+4 slack: the AHEAD proposal writes up to K+1 past
                    # the block it anticipates
                    self.draft.begin(
                        list(prefix.token_ids) + list(prompt_ids), eng.tokenizer.pad_id,
                        extra=max_new_tokens + 2 * self.k + 4,
                    )
                s.seg["draft"] += time.perf_counter() - t_d
        except Exception:
            # A failed start must not leak the slot as an orphaned external
            # request: every harvest path skips external slots.
            eng.release_slot(slot)
            raise
        self._streams[slot] = s
        return s

    def advance(self, s: _Stream):
        """Run ONE speculative round (or the terminal transition).

        Returns the Finished record once the request completes through the
        speculative path, else None. Callers may interleave
        engine.step_fused() between advances. On the auto-disable edge the
        slot hands back to the engine (`s.handed_off`): the request
        finishes like any other through the caller's own harvest, so
        advance() never consumes other slots' Finished records. A failed
        round tears the stream down (slot and pages released) and
        re-raises."""
        if s.handed_off:
            raise RuntimeError(
                "stream handed off to the engine (auto-disable); harvest its "
                "Finished via step_fused/decode_fused"
            )
        if self._streams.get(s.slot) is not s:
            # finished or torn down: the slot may already serve another
            # request
            raise RuntimeError("speculative stream is closed")
        try:
            if s.finished or len(s.generated) >= s.max_new:
                return self._finish(s)
            if not s.disabled:
                if self.arm == "hidden":
                    self._round_hidden(s)
                else:
                    self._round_draft(s)
            if s.finished or len(s.generated) >= s.max_new:
                return self._finish(s)
            if s.disabled:
                self._hand_off(s)
            return None
        except Exception:
            self._streams.pop(s.slot, None)
            req = self.engine._by_slot.get(s.slot)
            if req is not None and req.req_id == s.req_id:
                self.engine.release_slot(s.slot)
            raise

    # -------------------------------------------------------- draft rounds
    def _round_draft(self, s: _Stream) -> None:
        eng = self.engine
        K = self.k
        w = K + 1
        abs_pos = eng.prefix_len + s.n_own
        prop = s.pending
        s.pending = None
        overlapped = prop is not None and prop.pos == abs_pos
        if not overlapped:
            if prop is not None:
                self.stats.ahead_wasted += 1
            t_d = time.perf_counter()
            with recorder.phase("spec_draft"):
                prop = self._propose_from(self._scalar(s.t_cur), abs_pos,
                                          self._scalar(s.st_cur))
            s.seg["draft"] += time.perf_counter() - t_d

        t_v = time.perf_counter()
        prog = self._program(w, prop.logits.shape[-1])
        page_ids, offs, row = self._round_io(s.slot, s.n_own, w, s.hard_cap)
        prog.load_host(np.arange(abs_pos, abs_pos + w), page_ids, offs, row, s.n_own)
        prog.blk_tok[:1].copy_(prop.anchor_tok.reshape(1))
        prog.blk_tok[1:].copy_(prop.toks[:K])
        prog.mask_states[:1].copy_(prop.anchor_st.reshape(1))
        prog.mask_states[1:].copy_(prop.states[:K])
        if not prog.greedy:
            prog.choice_idx.copy_(prop.idxs)
            prog.q_logits.copy_(prop.logits)
        with recorder.phase("spec_verify"):
            prog.run()
        s.seg["verify"] += time.perf_counter() - t_v

        # AHEAD proposal for round n+1, queued BEFORE the round's fetch: the
        # draft continues its own chain through the bonus-token guess while
        # the verify (already queued) runs. Skipped when the budget could
        # never use it or the draft buffer would overflow.
        ahead = None
        ahead_pos = abs_pos + K + 1
        if (s.max_new - len(s.generated) > K + 1
                and ahead_pos + K + 1 <= self.draft.capacity):
            t_d = time.perf_counter()
            with recorder.phase("spec_draft"):
                ahead = self._propose_from(prop.toks[K], ahead_pos, prop.states[K])
            s.seg["draft"] += time.perf_counter() - t_d

        # THE round's one fetch: the verdict and the block's token values
        # (the ahead proposal stays on the device)
        t_v = time.perf_counter()
        got = self._fetch(prog.out, prop.toks, prop.states)
        s.seg["verify"] += time.perf_counter() - t_v
        a, t_next, st_next = (int(x) for x in got[:3])
        toks_np, states_np = got[3:3 + w], got[3 + w:3 + 2 * w]
        if overlapped:
            self.stats.overlapped_rounds += 1
            s.overlapped += 1
        self._resolve_round(s, a, t_next, st_next,
                            [(int(toks_np[i]), int(states_np[i])) for i in range(a)])
        # Adopt the ahead block when the chain it anticipated is exactly the
        # chain that happened: full accept AND the bonus token (and its DFA
        # state) match the draft's guess.
        if (ahead is not None and not s.finished and not s.disabled
                and len(s.generated) < s.max_new and a == K
                and t_next == int(toks_np[K]) and st_next == int(states_np[K])
                and eng.prefix_len + s.n_own == ahead.pos):
            s.pending = ahead
        elif ahead is not None:
            self.stats.ahead_wasted += 1

    # ------------------------------------------------------- hidden rounds
    def _round_hidden(self, s: _Stream) -> None:
        eng = self.engine
        K = self.k
        abs_pos = eng.prefix_len + s.n_own
        pend = s.pending
        s.pending = None
        x_width = eng.cfg.vocab_size
        grammar, _ = self._grammar_mode()
        if grammar == "sparse":
            x_width = eng._sp_tokens.shape[1]
        overlapped = pend is not None and pend.pos == abs_pos
        # the bootstrap geometry (W = 1) has no proposals to verify: it
        # processes the current token, samples its successor and makes the
        # first proposal block
        w = K + 1 if overlapped else 1
        t_v = time.perf_counter()
        prog = self._program(w, x_width, n_guess=K)
        page_ids, offs, row = self._round_io(s.slot, s.n_own, w, s.hard_cap)
        prog.load_host(np.arange(abs_pos, abs_pos + w), page_ids, offs, row, s.n_own,
                       s.t_cur, s.st_cur)
        prog.blk_tok[:1].copy_(prog.tok0)
        prog.mask_states[:1].copy_(prog.st0)
        drafts: list[tuple[int, int]] = []
        if overlapped:
            prog.blk_tok[1:].copy_(pend.toks)
            prog.mask_states[1:].copy_(pend.states)
            if not prog.greedy:
                prog.choice_idx.copy_(pend.idxs)
                prog.q_logits.copy_(pend.logits)
            drafts = [(int(pend.toks_np[i]), int(pend.states_np[i])) for i in range(K)]
        with recorder.phase("spec_verify"):
            prog.run()
        # The round's one fetch: the verdict and the NEXT block's guesses
        # (their device buffers stay put for round n+1).
        got = self._fetch(prog.out)
        s.seg["verify"] += time.perf_counter() - t_v
        a, t_next, st_next = (int(x) for x in got[:3])
        if overlapped:
            # the proposals were made inside the previous round's program
            self.stats.overlapped_rounds += 1
            s.overlapped += 1
            self._resolve_round(s, a, t_next, st_next, drafts[:a])
        else:
            self._resolve_round(s, a, t_next, st_next, [], count_round=False)
        if not s.finished and not s.disabled and s.max_new - len(s.generated) > 1:
            s.pending = _HiddenBlock(
                pos=eng.prefix_len + s.n_own,
                toks=prog.out[3:3 + K], states=prog.out[3 + K:3 + 2 * K],
                idxs=prog.out[3 + 2 * K:3 + 3 * K], logits=prog.g_logits,
                toks_np=got[3:3 + K].copy(), states_np=got[3 + K:3 + 2 * K].copy(),
            )

    # ------------------------------------------------------------- resolve
    def _resolve_round(self, s: _Stream, a: int, t_next: int, st_next: int,
                       accepted: list[tuple[int, int]], count_round: bool = True) -> None:
        """Emit the round's target-consistent tokens, roll back the rejected
        tail's pages and update the acceptance EWMA."""
        eng = self.engine
        eos = eng.tokenizer.eos_id
        done_state = int(eng._done_state)
        if count_round:
            s.rounds += 1
            self.stats.rounds += 1
            self.stats.proposed += self.k
            self.stats.accepted += a
        t_r = time.perf_counter()
        for tok, stt in [*accepted, (t_next, st_next)]:
            if len(s.generated) >= s.max_new:
                break
            s.generated.append(tok)
            self.stats.emitted += 1
            if tok == eos or stt == done_state:
                s.finished = True
                break
            s.t_cur, s.st_cur = tok, stt
        # n_own counts tokens whose KV is resident: t_cur's KV lands only
        # when the next round processes it, so prompt + (emitted - 1)
        s.n_own = s.n_prompt + len(s.generated) - 1
        eng.kv.truncate(s.slot, s.n_own)  # paged-KV rollback of the tail
        s.seg["rollback"] += time.perf_counter() - t_r
        if count_round:
            rate = a / self.k
            s.ewma = rate if s.ewma is None else (
                self.ewma_alpha * rate + (1 - self.ewma_alpha) * s.ewma)
            # per-request warm-up: every request gets min_rounds of EWMA
            # settling before it can disable
            if (s.rounds >= self.min_rounds and not s.finished
                    and s.ewma < self.disable_threshold):
                s.disabled = True
                self.stats.disables += 1

    # ------------------------------------------------------------- generate
    def generate(self, prompt_ids: list[int], max_new_tokens: int = 200):
        """Speculative replacement for the engine's plain generate(): greedy
        output is token-identical to plain decode, sampled output follows
        the target distribution exactly (spec/verify.py)."""
        from k8s_llm_scheduler_tpu_torch.observability import spans

        eng = self.engine
        if not self.supports(prompt_ids, max_new_tokens):
            self.stats.unsupported_requests += 1
            return eng.generate(prompt_ids, max_new_tokens, use_spec=False)
        self.stats.requests += 1
        s0 = self.stats
        before = (s0.proposed, s0.accepted, s0.rounds, s0.disables)
        s = self.start(prompt_ids, max_new_tokens)
        try:
            with spans.span("spec_decode") as sp:
                fin = None
                while fin is None and not s.handed_off:
                    fin = self.advance(s)
                if fin is None:
                    # auto-disable handed the slot to the engine: finish it
                    # through the fused runtime
                    with recorder.phase("spec_fallback"):
                        while fin is None:
                            for f in eng.step_fused():
                                if f.req_id == s.req_id:
                                    fin = f
                                else:
                                    eng._pending_finished.append(f)
                if sp is not None:
                    sp.attrs.update(
                        arm=self.arm,
                        proposed=s0.proposed - before[0],
                        accepted=s0.accepted - before[1],
                        rejected=(s0.proposed - before[0]) - (s0.accepted - before[1]),
                        rounds=s0.rounds - before[2],
                        disabled=bool(s0.disables - before[3]),
                    )
            return fin
        except Exception:
            # a failed round must not leak the slot or its pages
            self._streams.pop(s.slot, None)
            req = eng._by_slot.get(s.slot)
            if req is not None and req.req_id == s.req_id:
                eng.release_slot(s.slot)
            raise

    # ------------------------------------------------------------- teardown
    def _profile_stream(self, s: _Stream, disabled: bool) -> None:
        """Hand a closed stream's books to the engine's profiler
        (SPEC_SEGMENTS), as the JAX decoder does: at completion, or at the
        auto-disable hand-off (`disabled`), when the record covers only the
        speculative phase."""
        prof = self.engine.profiler
        if prof is None:
            return
        prof.on_spec(
            wall_s=time.perf_counter() - s.t0, draft_s=s.seg["draft"],
            verify_s=s.seg["verify"], rollback_s=s.seg["rollback"], rounds=s.rounds,
            overlapped_rounds=s.overlapped, tokens=max(len(s.generated) - 1, 0),
            arm=self.arm, disabled=disabled,
        )

    def _finish(self, s: _Stream):
        """Complete the request: free the slot and build Finished exactly
        as the plain step() path does."""
        from k8s_llm_scheduler_tpu_torch.engine.engine import Finished

        eng = self.engine
        req = eng._by_slot[s.slot]
        self._streams.pop(s.slot, None)
        eng.release_slot(s.slot)
        ids = s.generated[: s.max_new]
        # the first token is accounted as the plain path does (not a decode token)
        eng.stats["decode_tokens"] += max(len(ids) - 1, 0)
        eng.stats["completed"] += 1
        self._profile_stream(s, disabled=False)
        return Finished(
            req_id=s.req_id, token_ids=ids, text=eng.tokenizer.decode(ids),
            latency_ms=(time.perf_counter() - req.submitted_at) * 1000.0,
        )

    def _hand_off(self, s: _Stream) -> None:
        """Auto-disable hand-off: restore the slot's decode state on the
        device, in place, and hand it BACK to the engine's decode batch
        (external cleared). The request finishes like any other engine
        request, through the caller's own step_fused()/decode_fused()
        harvest: driving the engine from here would consume other slots'
        completions out from under the caller."""
        eng = self.engine
        self.stats.fallback_requests += 1
        self._streams.pop(s.slot, None)
        self._profile_stream(s, disabled=True)
        remaining = s.max_new - len(s.generated)
        req = eng._by_slot[s.slot]
        req.generated = list(s.generated)
        req.first_pending = False
        req.external = False
        # emissions parked before now carry only pads for this slot
        req.park_floor = len(eng._pending_emissions)
        eng.kv.ensure_capacity(s.slot, s.n_own + remaining + 1)
        state = eng._state
        state.tok[s.slot] = s.t_cur
        state.pos[s.slot] = eng.prefix_len + s.n_own
        state.st[s.slot] = s.st_cur
        state.budget[s.slot] = remaining
        state.act[s.slot] = True
        eng._act_np[s.slot] = True
        eng._budget_np[s.slot] = remaining
        # the spec-emitted tokens are in req.generated; the plain path's
        # completion accounting takes over from here
        eng.stats["decode_tokens"] += max(len(s.generated) - 1, 0)
        s.handed_off = True

    # ----------------------------------------------------------------- swap
    def on_swap(self) -> None:
        """Weight-swap hook (called before new weights install): roll back
        every open stream's speculative tail through the grammar-safe
        PagedKVCache.truncate and drop proposal blocks on the device, which
        were computed under the old weights. Emitted tokens stand; the
        stream re-proposes from its last verified token. Called by
        engine.swap_params, the hot swap's install (rollout/hotswap.py)."""
        for s in self._streams.values():
            self.engine.kv.truncate(s.slot, s.n_own)
            if s.pending is not None:
                s.pending = None
                self.stats.ahead_wasted += 1
            self.stats.swap_rollbacks += 1

    def release(self) -> None:
        """Drop every device tensor the decoder holds (the draft model and
        its KV buffers, the hidden head, the verify programs and their
        buffers, open streams): engine.release, when a closed backend
        frees its engine. The arm, K and the books stay."""
        self._streams.clear()
        self._programs.clear()
        self.draft = None
        self.hidden_head = None

    @property
    def open_streams(self) -> int:
        return len(self._streams)
