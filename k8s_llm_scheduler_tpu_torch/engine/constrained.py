"""Grammar-constrained JSON decoding — hallucination-proof by construction.

The reference validates the LLM's selected node *after* decoding and falls
back when the model hallucinates (reference scheduler.py:453-465), and needs
a 3-strategy JSON extractor because the model may wrap the object in prose
(scheduler.py:474-519). Here the token stream itself is constrained by a
DFA over the decision grammar, so the model *cannot* emit anything but

    {"selected_node": "<one of the allowed names>",
     "confidence": <0.0-1.0 literal>,
     "reasoning": "<free text, bounded length>"}

- Fixed skeleton spans are forced (exactly one allowed token per state).
- The node name is a trie over the FEASIBLE node names (core/validation
  computes the candidate set), so selection degrees of freedom exist only
  where names diverge.
- `confidence` allows the literal grammar 0.d{1,2} | 1.0.
- `reasoning` is any non-quote printable text up to a length cap, then a
  forced closing quote+brace+EOS.

The DFA is held as edge lists on host and compiles to SPARSE device tables
(SparseDFATables: per-state allowed-token lists plus forced-run tables) —
both vocab-independent, so the same machinery serves the 512-entry byte
tokenizer and 128k-vocab BPE tokenizers. Sampling and transitions happen
on device inside the decision wave (engine/engine.py _sample_sparse): a
K-space gather-pick-map, never a full-vocab mask.

This module is a copy of the JAX package's engine/constrained.py (pure
numpy); the tests hold the two to identical tables.

Validation downstream (sched/client.py) stays as defense in depth.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from k8s_llm_scheduler_tpu_torch.engine.tokenizer import Tokenizer


@dataclasses.dataclass
class DecisionDFA:
    """Edge-list DFA for constrained decoding. Host memory is O(edges) —
    vocab-INDEPENDENT, which matters at 128k-vocab BPE tokenizers where a
    dense [n_states, vocab] table would be hundreds of MB per grammar (and
    the backend caches up to 17 grammars). The engine derives the sparse
    device tables (sparse_tables) from this."""

    edges: list[dict[int, int]]  # edges[s][token id] -> next state
    start_state: int
    done_state: int
    vocab_size: int

    @property
    def n_states(self) -> int:
        return len(self.edges)

    def allowed_tokens(self, state: int) -> list[int]:
        """Allowed token ids from `state`, ascending (deterministic order —
        greedy tie-breaks match the old dense argmax)."""
        return sorted(self.edges[state])

    def next(self, state: int, token: int) -> int:
        return self.edges[state][token]


class _Builder:
    def __init__(self, vocab_size: int) -> None:
        self.vocab = vocab_size
        self.edges: list[dict[int, int]] = []

    def new_state(self) -> int:
        self.edges.append({})
        return len(self.edges) - 1

    def edge(self, src: int, token: int, dst: int) -> None:
        self.edges[src][token] = dst

    def chain(self, src: int, tokens: list[int]) -> int:
        """Forced token sequence; returns the state after the last token."""
        cur = src
        for tok in tokens:
            nxt = self.new_state()
            self.edge(cur, tok, nxt)
            cur = nxt
        return cur

    def finish(self, start: int, done: int) -> DecisionDFA:
        return DecisionDFA(
            edges=self.edges,
            start_state=start,
            done_state=done,
            vocab_size=self.vocab,
        )


def build_decision_dfa(
    tokenizer: Tokenizer,
    node_names: list[str],
    max_reason_tokens: int = 120,
    style: str = "direct",
) -> DecisionDFA:
    """Compile the decision grammar for this set of allowed node names.

    Token-level trie — works for any tokenizer whose encode() is prefix-
    consistent over the name strings (byte-level trivially is; BPE names are
    encoded whole so each name is one fixed token path).

    `style` fixes the FIELD ORDER of the emitted object (the parsed JSON
    is identical either way — key order is semantically irrelevant):

    - "direct": {"selected_node": ..., "confidence": ..., "reasoning": ...}
      — the reference's serialization order (scheduler.py:208-212).
    - "cot":    {"reasoning": ..., "selected_node": ..., "confidence": ...}
      — chain-of-thought-before-choice: the model emits its free-text
      rationale (e.g. per-node scores, EVAL.md) BEFORE the constrained
      node choice, so the choice token can attend to the model's own
      serialized comparison instead of computing a global argmax in one
      step. Distillation selects this with train --answer-style cot.
    """
    if not node_names:
        raise ValueError("constrained decoding needs at least one allowed node name")
    if style not in ("direct", "cot"):
        raise ValueError(f"unknown decision style {style!r}")
    for name in node_names:
        # Names embed RAW inside the JSON string the grammar forces; a
        # quote/backslash/control char would make every decision unparseable
        # (and such a name cannot be a legal DNS-1123 K8s node name anyway —
        # a ClusterState handing one over is broken; fail loudly, not with
        # per-decision parse errors).
        if any(c in '"\\' or ord(c) < 0x20 for c in name):
            raise ValueError(
                f"node name {name!r} contains JSON-breaking characters and "
                "cannot appear in the decision grammar"
            )
    b = _Builder(tokenizer.vocab_size)
    quote = tokenizer.encode('"')[0]

    start = b.new_state()
    done = b.new_state()

    def wire_name_trie(src: int) -> int:
        """Trie over node names from `src`; leaves converge (via the
        closing quote) on the returned post-name state."""
        post_name = b.new_state()
        trie: dict[tuple[int, ...], int] = {(): src}
        for name in node_names:
            toks = tokenizer.encode(name)
            prefix: tuple[int, ...] = ()
            for tok in toks:
                nxt_prefix = prefix + (tok,)
                if nxt_prefix not in trie:
                    trie[nxt_prefix] = b.new_state()
                    b.edge(trie[prefix], tok, trie[nxt_prefix])
                elif tok not in b.edges[trie[prefix]]:
                    b.edge(trie[prefix], tok, trie[nxt_prefix])
                prefix = nxt_prefix
            b.edge(trie[prefix], quote, post_name)
        return post_name

    def wire_confidence(src: int) -> list[int]:
        """0.d | 0.dd | 1.0 from `src`; returns the terminal states (the
        caller wires the field separator/closer edges from them)."""
        digits = {d: tokenizer.encode(str(d))[0] for d in range(10)}
        dot = tokenizer.encode(".")[0]
        zero_state = b.new_state()
        b.edge(src, digits[0], zero_state)
        zero_dot = b.new_state()
        b.edge(zero_state, dot, zero_dot)
        first_dec = b.new_state()
        for d in range(10):
            b.edge(zero_dot, digits[d], first_dec)
        second_dec = b.new_state()
        for d in range(10):
            b.edge(first_dec, digits[d], second_dec)
        one_state = b.new_state()
        b.edge(src, digits[1], one_state)
        one_dot = b.new_state()
        b.edge(one_state, dot, one_dot)
        one_zero = b.new_state()
        b.edge(one_dot, digits[0], one_zero)
        return [first_dec, second_dec, one_zero]

    def wire_reasoning(src: int) -> int:
        """Free text (printable, non-quote/backslash) from `src`, bounded
        at max_reason_tokens; returns the state after the closing quote.
        NumericTokenizer note: digit runs in generated reasoning arrive as
        NUM tokens, so allow those alongside the single-char prints."""
        printable = [
            tokenizer.encode(chr(c))[0]
            for c in range(32, 127)
            if chr(c) not in ('"', "\\")
        ]
        num_base = getattr(tokenizer, "NUM_BASE", None)
        if num_base is not None:
            # integers 0-200 only: covers scores/percentages (the CoT
            # vocabulary) while keeping the state out-degree inside the
            # sparse-table K buckets (full NUM_COUNT would exceed 1024)
            printable = sorted(
                set(printable) | set(range(num_base, num_base + 201))
            )
        states = [src] + [b.new_state() for _ in range(max_reason_tokens)]
        close_q = b.new_state()
        for i, st in enumerate(states):
            b.edge(st, quote, close_q)
            if i < max_reason_tokens:
                for tok in printable:
                    b.edge(st, tok, states[i + 1])
        return close_q

    if style == "direct":
        # {"selected_node": "<name>", "confidence": 0.x, "reasoning": "…"}
        s = b.chain(start, tokenizer.encode('{"selected_node": "'))
        post_name = wire_name_trie(s)
        s = b.chain(post_name, tokenizer.encode(', "confidence": '))
        conf_ends = wire_confidence(s)
        comma = tokenizer.encode(",")[0]
        after_num = b.new_state()
        for st in conf_ends:
            b.edge(st, comma, after_num)
        reason_start = b.chain(after_num, tokenizer.encode(' "reasoning": "'))
        close_q = wire_reasoning(reason_start)
        close_b = b.chain(close_q, tokenizer.encode('}'))
        b.edge(close_b, tokenizer.eos_id, done)
    else:
        # {"reasoning": "…", "selected_node": "<name>", "confidence": 0.x}
        s = b.chain(start, tokenizer.encode('{"reasoning": "'))
        close_q = wire_reasoning(s)
        s = b.chain(close_q, tokenizer.encode(', "selected_node": "'))
        post_name = wire_name_trie(s)
        s = b.chain(post_name, tokenizer.encode(', "confidence": '))
        conf_ends = wire_confidence(s)
        brace = tokenizer.encode('}')[0]
        close_b = b.new_state()
        for st in conf_ends:
            b.edge(st, brace, close_b)
        b.edge(close_b, tokenizer.eos_id, done)

    # done state: self-loop on pad so finished slots stay well-defined
    b.edge(done, tokenizer.pad_id, done)

    return b.finish(start, done)


def first_token_of(dfa: DecisionDFA) -> int:
    """The single allowed first token (the opening brace)."""
    candidates = dfa.allowed_tokens(dfa.start_state)
    assert len(candidates) == 1
    return candidates[0]


def forced_token_table(dfa: DecisionDFA) -> np.ndarray:
    """Per-state: the single allowed token id when the state is FORCED
    (exactly one out-edge), else -1.

    This is what makes grammar-accelerated block decoding work
    (engine/engine.py _wave_impl): a forced token needs no logits — the
    device expands whole forced runs (JSON skeleton spans) with table
    gathers between model calls, so the model runs once per CHOICE point
    instead of once per token. The done state reports -1 (its pad self-loop
    exists only to keep finished slots well-defined, never to be taken).
    """
    forced = np.full(dfa.n_states, -1, dtype=np.int32)
    for s, out in enumerate(dfa.edges):
        if len(out) == 1:
            forced[s] = next(iter(out))
    forced[dfa.done_state] = -1
    return forced


@dataclasses.dataclass
class SparseDFATables:
    """Vocab-independent device representation of a DecisionDFA.

    The dense [n_states, vocab] tables are impossible at real-model vocab
    sizes (128k vocab x 4096 states of int32 is ~2 GB); but the decision
    grammar allows at most a few hundred tokens per state, so the device
    tables list them instead:

    - sp_tokens[s, k]: the k-th allowed token id from state s (-1 padding)
    - sp_next[s, k]:   the state reached by taking it
    - forced[s]:       the single allowed token when out-degree is 1, else -1
    - forced_next[s]:  the state reached by the forced token (0 when none)

    Sampling happens in K-space: gather the allowed tokens' logits, pick k,
    map back through sp_tokens/sp_next — the full-vocab mask never exists.
    K is bucketed to bound compile variants.
    """

    sp_tokens: np.ndarray  # [n_states, K] int32
    sp_next: np.ndarray    # [n_states, K] int32
    forced: np.ndarray     # [n_states] int32
    forced_next: np.ndarray  # [n_states] int32
    start_state: int
    done_state: int

    @property
    def n_states(self) -> int:
        return self.sp_tokens.shape[0]

    @property
    def k_width(self) -> int:
        return self.sp_tokens.shape[1]


_K_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)


def sparse_tables(dfa: DecisionDFA) -> SparseDFATables:
    """Compile a DecisionDFA to its sparse device tables (cached on the DFA)."""
    cached = getattr(dfa, "_sparse_cache", None)
    if cached is not None:
        return cached
    max_deg = max((len(out) for out in dfa.edges), default=1)
    for bucket in _K_BUCKETS:
        if max_deg <= bucket:
            K = bucket
            break
    else:
        raise ValueError(f"DFA out-degree {max_deg} exceeds {_K_BUCKETS[-1]}")
    n = dfa.n_states
    sp_tokens = np.full((n, K), -1, dtype=np.int32)
    sp_next = np.zeros((n, K), dtype=np.int32)
    for s in range(n):
        toks = dfa.allowed_tokens(s)
        sp_tokens[s, : len(toks)] = toks
        sp_next[s, : len(toks)] = [dfa.edges[s][t] for t in toks]
    forced = forced_token_table(dfa)
    forced_next = np.zeros(n, dtype=np.int32)
    for s in range(n):
        if forced[s] >= 0:
            forced_next[s] = dfa.edges[s][int(forced[s])]
    tables = SparseDFATables(
        sp_tokens=sp_tokens,
        sp_next=sp_next,
        forced=forced,
        forced_next=forced_next,
        start_state=dfa.start_state,
        done_state=dfa.done_state,
    )
    dfa._sparse_cache = tables  # type: ignore[attr-defined]
    return tables


def dense_transition_table(
    dfa: DecisionDFA, vocab_size: int | None = None
) -> np.ndarray:
    """Dense [n_states, vocab] next-state table: entry [s, v] is the state
    reached by emitting token v from state s, -1 when disallowed.

    The FUSED decode loop's grammar representation (engine/fused/): inside
    a lax.while_loop body one row gather yields both the allowed-token
    mask (`row >= 0`) and the transition — no K-space mapping, no
    per-grammar K-bucket compile variants. Host memory is O(states x
    vocab), which is exactly why the sparse tables above remain the
    serving representation for the wave/chunked paths: the engine's fused
    runtime size-caps this export (engine/fused/tables.py) and falls back
    to sparse chunked decode when a grammar cannot afford it.

    `vocab_size` widens the table past dfa.vocab_size (a checkpoint-shaped
    model's padded vocab served with a small domain tokenizer): the extra
    columns are all -1, so the mask forbids undecodable ids for free."""
    V = int(vocab_size if vocab_size is not None else dfa.vocab_size)
    if V < dfa.vocab_size:
        raise ValueError(
            f"vocab_size {V} narrower than the DFA's {dfa.vocab_size}"
        )
    table = np.full((dfa.n_states, V), -1, dtype=np.int32)
    for s, out in enumerate(dfa.edges):
        if out:
            table[s, list(out.keys())] = list(out.values())
    return table


def wave_iterations(dfa: DecisionDFA, block_size: int) -> int:
    """Worst-case number of block-decode iterations to complete ANY path
    through the grammar.

    One iteration consumes 1 sampled token plus up to `block_size - 1`
    forced continuations. Computed by DP over the DFA (acyclic by
    construction, apart from the done state's pad self-loop): iters(s) =
    1 + max over allowed t of iters(state reached from next(s, t) after
    following at most block_size - 1 forced edges). The engine sizes the
    wave's scan length with this, so completion inside one device program
    stays guaranteed (the old per-token wave needed max_new_tokens
    iterations; the decision grammar typically needs ~10-16).
    """
    if block_size < 1:
        raise ValueError("block_size must be >= 1")
    forced = forced_token_table(dfa)
    done = dfa.done_state
    memo: dict[int, int] = {done: 0}

    def advance(state: int) -> int:
        """Follow up to block_size-1 forced edges from `state`."""
        for _ in range(block_size - 1):
            if state == done:
                break
            ft = forced[state]
            if ft < 0:
                break
            state = dfa.edges[state][int(ft)]
        return state

    # Iterative DFS (the reasoning chain can be hundreds of states deep).
    stack = [dfa.start_state]
    while stack:
        s = stack[-1]
        if s in memo:
            stack.pop()
            continue
        succs = []
        ready = True
        for tok in dfa.allowed_tokens(s):
            nxt = advance(dfa.edges[s][tok])
            succs.append(nxt)
            if nxt not in memo:
                stack.append(nxt)
                ready = False
        if ready:
            memo[s] = 1 + max((memo[n] for n in succs), default=0)
            stack.pop()
    return memo[dfa.start_state]
