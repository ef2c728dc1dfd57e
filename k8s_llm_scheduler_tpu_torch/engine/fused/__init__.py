"""Fused on-device decode runtime (the port of the JAX package's
engine/fused/).

The autoregressive loop as ONE device program a chunk (*Kernel Looping*,
PAPERS.md): up to `chunk_steps` steps, each guarded by an on-device liveness
test, that run the model forward, sample on device (greedy +
temperature/top-k from the engine's generator), apply the grammar as a dense
transition-table gather, append KV toward the paged cache and detect
per-slot stops. The host syncs once per harvest CHUNK, never per token, and
a finished batch's remaining steps are skipped on the device.

Modules:
- tables.py  — dense [states, vocab] next-state table export from a
  DecisionDFA (the allowed-token mask is `next >= 0`); size-capped, the
  engine falls back to the sparse chunked path when a grammar cannot fuse.
- sampler.py — the on-device sampling step shared by every fused chunk.
- loop.py    — the early-exit decode chunk (fused_decode_chunk_impl).

The engine-facing surface is InferenceEngine.step_fused / decode_fused
(engine/engine.py), which composes with the admission plane (packs admit
into fused slots) and falls back to step() whenever the grammar can't fuse.
"""

from k8s_llm_scheduler_tpu_torch.engine.fused.loop import fused_decode_chunk_impl
from k8s_llm_scheduler_tpu_torch.engine.fused.sampler import sample_fused
from k8s_llm_scheduler_tpu_torch.engine.fused.tables import (
    DENSE_TABLE_MAX_BYTES,
    DenseGrammarTables,
    dense_tables,
)

__all__ = [
    "DENSE_TABLE_MAX_BYTES",
    "DenseGrammarTables",
    "dense_tables",
    "fused_decode_chunk_impl",
    "sample_fused",
]
