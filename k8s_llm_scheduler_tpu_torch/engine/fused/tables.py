"""Dense grammar transition tables for the fused decode loop (a copy of the
JAX package's engine/fused/tables.py, which imports no JAX).

The chunked path samples in K-space off SPARSE tables (engine/constrained
SparseDFATables) because a dense [n_states, vocab] table is impossible at
128k-vocab production tokenizers. Inside the fused while_loop the economics
flip: the loop body wants ONE gather per step (`next_state[st, token]`)
with the allowed-token mask falling out for free (`next_state[st] >= 0`) —
no K-bucket compile variants, no token->K mapping, and the transition is a
single gather.

So the dense table is an OPT-IN acceleration with an explicit size cap:
`dense_tables` returns None when `states x vocab x 4B` exceeds the budget
(e.g. a 128k-vocab grammar), and the engine falls back to the sparse
chunked path — fused decode is never a correctness trade. State capacity
buckets by powers of two (floor 1024) so same-structure grammars of
drifting snapshots share one captured fused program.

Greedy identity with the sparse path holds by construction: both mask the
SAME allowed set (the DFA's out-edges) and argmax ties resolve to the
lowest token id on both (sparse rows list tokens ascending; dense argmax
scans ascending ids) — the fused==chunked token-identity pin in
tests/test_torch_fused.py rests on exactly this.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from k8s_llm_scheduler_tpu_torch.engine.constrained import (
    DecisionDFA,
    dense_transition_table,
)

# Default byte budget for one dense table. A 64-node decision grammar
# (~2.5k states, padded to 4096) at the committed 4k-BPE vocab is 64 MB —
# inside the budget; a 128k-vocab checkpoint tokenizer would need 2 GB and
# falls back to the sparse chunked path instead.
DENSE_TABLE_MAX_BYTES = 128 << 20

_STATE_FLOOR = 1024


@dataclasses.dataclass
class DenseGrammarTables:
    """Dense device-side grammar for the fused loop.

    next_state[s, v] is the state reached by emitting token v from state s,
    or -1 when the grammar forbids it (the allowed mask). Rows past the
    DFA's real states are all -1 — unreachable by construction (states only
    ever come from the table itself or the DFA start state).
    """

    next_state: np.ndarray  # [state_cap, vocab] int32, -1 = disallowed
    start_state: int
    done_state: int
    n_states: int

    @property
    def nbytes(self) -> int:
        return int(self.next_state.nbytes)


def dense_tables(
    dfa: DecisionDFA,
    vocab_size: int | None = None,
    max_bytes: int = DENSE_TABLE_MAX_BYTES,
) -> DenseGrammarTables | None:
    """Compile `dfa` to its dense fused-loop table (cached on the DFA).

    Returns None when the table would exceed `max_bytes` — the caller's
    signal to keep the sparse chunked path for this grammar."""
    V = int(vocab_size if vocab_size is not None else dfa.vocab_size)
    cap = _STATE_FLOOR
    while cap < dfa.n_states:
        cap *= 2
    # The size cap is judged BEFORE the cache: two engines sharing one
    # DFA may carry different budgets, and a table another engine could
    # afford must not leak past this caller's smaller cap.
    if cap * V * 4 > max_bytes:
        return None
    cached = getattr(dfa, "_dense_cache", None)
    if cached is not None and cached.next_state.shape == (cap, V):
        return cached
    table = np.full((cap, V), -1, dtype=np.int32)
    table[: dfa.n_states] = dense_transition_table(dfa, V)
    tables = DenseGrammarTables(
        next_state=table,
        start_state=dfa.start_state,
        done_state=dfa.done_state,
        n_states=dfa.n_states,
    )
    dfa._dense_cache = tables  # type: ignore[attr-defined]
    return tables
