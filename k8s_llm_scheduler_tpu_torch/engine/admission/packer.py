"""Host-side prepacking: many short prompts -> fixed-token chunks.

The *Prepacking* observation (arXiv:2404.09529) applied to scheduler
prompts: a burst of per-pod suffixes is many SHORT sequences, and batching
them as rows pads every one to the bucket width — a wave of 8 rows at
bucket 256 pays 2048 prefill tokens for maybe 600 real ones. Packing
concatenates them into ONE token stream with per-token segment ids, so
prefill compute scales with the real token count, and the attention mask
is block-diagonal (a token attends only within its own segment, plus the
burst-shared prefix).

The *SARATHI* half (arXiv:2308.16369): the packed stream is split into
fixed-width CHUNKS, each dispatched as its own device program, so
in-flight decode work can be piggybacked between chunks — a long
admission burst never stalls decode for the whole burst's prefill. A
prompt may span a chunk boundary; its segment id and positions carry
across, and earlier chunks' K/V is visible to later ones via the pack
carry buffer (engine/admission/chunked.py).

Everything here is pure host bookkeeping (numpy, no jax): the plan is
computed once per pack and the arrays feed the jitted chunk program.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PromptEnd:
    """A prompt whose final token lands in this chunk."""

    prompt: int  # pack-level prompt index (== its segment id)
    index: int   # chunk-local index of the prompt's final token


@dataclasses.dataclass(frozen=True)
class PackChunk:
    """One fixed-width slice of the packed token stream."""

    tokens: np.ndarray     # [C] int32, pad_id on unused tail
    seg: np.ndarray        # [C] int32 segment id per token, -1 on padding
    positions: np.ndarray  # [C] int32 LOCAL position within the prompt
    n_tokens: int          # real tokens in this chunk
    ends: tuple[PromptEnd, ...]  # prompts completing in this chunk


@dataclasses.dataclass(frozen=True)
class PackedPlan:
    """The full pack: chunks + per-prompt geometry."""

    chunks: tuple[PackChunk, ...]
    prompt_lens: tuple[int, ...]
    chunk_tokens: int
    total_tokens: int  # sum(prompt_lens)

    @property
    def n_prompts(self) -> int:
        return len(self.prompt_lens)

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)


def pack_prompts(
    prompts: list[list[int]], chunk_tokens: int, pad_id: int
) -> PackedPlan:
    """Concatenate `prompts` (in order) into chunks of `chunk_tokens`.

    Segment id = the prompt's index in `prompts`; positions restart at 0
    per prompt (the dispatcher offsets them by the shared prefix length).
    Prompts shorter than a chunk share it; a prompt longer than the
    remaining chunk space spans into the next chunk (same segment id,
    continuing positions) — both the short-prompt and the
    spans-a-boundary cases are pinned by tests/test_admission.py.
    """
    if not prompts:
        raise ValueError("empty pack")
    if any(not p for p in prompts):
        raise ValueError("empty prompt")
    if chunk_tokens < 1:
        raise ValueError("chunk_tokens must be >= 1")

    flat_tok: list[int] = []
    flat_seg: list[int] = []
    flat_pos: list[int] = []
    end_at: dict[int, int] = {}  # flat index of each prompt's final token
    for s, ids in enumerate(prompts):
        for j, t in enumerate(ids):
            flat_tok.append(int(t))
            flat_seg.append(s)
            flat_pos.append(j)
        end_at[len(flat_tok) - 1] = s

    total = len(flat_tok)
    chunks: list[PackChunk] = []
    for start in range(0, total, chunk_tokens):
        piece = slice(start, min(start + chunk_tokens, total))
        n = piece.stop - piece.start
        tokens = np.full(chunk_tokens, pad_id, dtype=np.int32)
        seg = np.full(chunk_tokens, -1, dtype=np.int32)
        positions = np.zeros(chunk_tokens, dtype=np.int32)
        tokens[:n] = flat_tok[piece]
        seg[:n] = flat_seg[piece]
        positions[:n] = flat_pos[piece]
        ends = tuple(
            PromptEnd(prompt=end_at[start + i], index=i)
            for i in range(n)
            if (start + i) in end_at
        )
        chunks.append(
            PackChunk(
                tokens=tokens, seg=seg, positions=positions,
                n_tokens=n, ends=ends,
            )
        )
    return PackedPlan(
        chunks=tuple(chunks),
        prompt_lens=tuple(len(p) for p in prompts),
        chunk_tokens=chunk_tokens,
        total_tokens=total,
    )
