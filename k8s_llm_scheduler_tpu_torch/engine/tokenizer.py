"""Tokenizers for the decision model (the byte tokenizer only).

A copy of `Tokenizer` and `ByteTokenizer` from the JAX package's
engine/tokenizer.py: a deterministic byte-level vocab (256 bytes + specials,
padded to 512), zero files, zero network. The HuggingFace adapter is not
ported yet.

The chat template mirrors the reference's two-message structure
(system + user, reference scheduler.py:425-430) with explicit role tokens.
"""

from __future__ import annotations

from typing import Protocol, Sequence


class Tokenizer(Protocol):
    vocab_size: int
    pad_id: int
    eos_id: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    def chat_prompt(self, system: str, user: str) -> list[int]: ...

    def chat_prompt_parts(
        self, system: str, user_prefix: str, user_suffix: str
    ) -> tuple[list[int], list[int]]:
        """(prefix_ids, suffix_ids) such that prefix+suffix is a valid chat
        prompt with user content user_prefix+user_suffix. The prefix part is
        the burst-shared token block for on-device prefix caching."""
        ...


class ByteTokenizer:
    """Bytes 0-255 map to ids 1-256; specials above; vocab padded to 512.

    `vocab_size` can be overridden upward (e.g. to a real model config's
    128256) so checkpoint-shaped models run without a tokenizer file —
    token ids stay < 512, the embedding rows above are simply never hit.
    """

    PAD = 0
    BOS = 257
    EOS = 258
    SYSTEM = 259
    USER = 260
    ASSISTANT = 261
    END_ROLE = 262

    pad_id = PAD
    eos_id = EOS

    def __init__(self, vocab_size: int = 512) -> None:
        if vocab_size < 512:
            raise ValueError("ByteTokenizer needs vocab_size >= 512")
        self.vocab_size = vocab_size

    def encode(self, text: str) -> list[int]:
        return [b + 1 for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - 1 for i in ids if 1 <= i <= 256)
        return data.decode("utf-8", errors="replace")

    def chat_prompt(self, system: str, user: str) -> list[int]:
        """[BOS][SYSTEM]...[END_ROLE][USER]...[END_ROLE][ASSISTANT]"""
        return (
            [self.BOS, self.SYSTEM]
            + self.encode(system)
            + [self.END_ROLE, self.USER]
            + self.encode(user)
            + [self.END_ROLE, self.ASSISTANT]
        )

    def chat_prompt_parts(
        self, system: str, user_prefix: str, user_suffix: str
    ) -> tuple[list[int], list[int]]:
        """Exact split: byte-level tokenization means the token split equals
        the string split, so prefix+suffix == chat_prompt(system, pfx+sfx)."""
        prefix = (
            [self.BOS, self.SYSTEM]
            + self.encode(system)
            + [self.END_ROLE, self.USER]
            + self.encode(user_prefix)
        )
        suffix = self.encode(user_suffix) + [self.END_ROLE, self.ASSISTANT]
        return prefix, suffix
