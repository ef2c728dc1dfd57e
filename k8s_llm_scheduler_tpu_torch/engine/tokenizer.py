"""Tokenizers for the decision model (a copy of the JAX package's
engine/tokenizer.py; the BPE test fixture is the port's own copy, under
assets/bpe4k).

Implementations behind one tiny interface:

- `ByteTokenizer`: deterministic byte-level vocab (256 bytes + specials,
  padded to 512 for MXU-friendly embedding shapes). Zero files, zero
  network — used by tests, benches, and any run without a real checkpoint.
  This is what lets the framework exercise the full TPU path hermetically
  (the reference can't test its LLM path without the live HF API,
  SURVEY §4).
- `HFTokenizerAdapter`: wraps a local HuggingFace tokenizer directory for
  real Llama checkpoints (transformers is in-image; loading is from local
  files only — zero external API calls is the north star).

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


class NumericTokenizer(ByteTokenizer):
    """ByteTokenizer + single tokens for integers 0-999.

    The decision task is numeric RANKING: the model must compare
    utilization percentages across node blocks and name the argmax. Byte-
    level digits make that a multi-token arithmetic puzzle — round-4
    distillation drove answer CE to 0.018 while top-1 agreement stayed at
    chance (EVAL.md finding 4). Rendering each integer as ONE token turns
    magnitude comparison into an ordering over ~1000 embeddings, which a
    small transformer learns directly (VERDICT r4 next-step 1, route b:
    "a tokenizer that renders metrics as single comparable tokens").

    Encoding rules (deterministic, lossless):
    - maximal digit runs of 1-3 chars with no leading zero (or exactly
      "0") become NUM tokens: "47" -> NUM_47, "3" -> NUM_3;
    - runs with leading zeros ("007") or length > 3 fall back to bytes,
      keeping decode(encode(x)) == x for arbitrary text;
    - everything else is byte-level, ids identical to ByteTokenizer, so
      the chat template, specials, and DFA machinery carry over.

    Vocab: 512 (byte base + specials) + 1000 integers = 1512, padded to
    1536 (12 x 128 MXU lanes). Model configs must be built with
    vocab_size >= 1536 to serve it (build_local_backend widens the config
    automatically when this tokenizer is selected).
    """

    NUM_BASE = 512
    NUM_COUNT = 1000
    VOCAB = 1536  # 512 + 1000, padded to a multiple of 128

    def __init__(self, vocab_size: int = VOCAB) -> None:
        if vocab_size < self.VOCAB:
            raise ValueError(
                f"NumericTokenizer needs vocab_size >= {self.VOCAB}"
            )
        super().__init__(vocab_size=vocab_size)

    def encode(self, text: str) -> list[int]:
        import re

        out: list[int] = []
        for part in re.split(r"(\d+)", text):
            if not part:
                continue
            if part.isdigit():
                if len(part) <= 3 and (part == "0" or part[0] != "0"):
                    out.append(self.NUM_BASE + int(part))
                else:
                    out.extend(b + 1 for b in part.encode("utf-8"))
            else:
                out.extend(b + 1 for b in part.encode("utf-8"))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        parts: list[str] = []
        byte_run = bytearray()
        for i in ids:
            if 1 <= i <= 256:
                byte_run.append(i - 1)
                continue
            if byte_run:
                parts.append(byte_run.decode("utf-8", errors="replace"))
                byte_run = bytearray()
            if self.NUM_BASE <= i < self.NUM_BASE + self.NUM_COUNT:
                parts.append(str(i - self.NUM_BASE))
        if byte_run:
            parts.append(byte_run.decode("utf-8", errors="replace"))
        return "".join(parts)


def build_builtin_tokenizer(name: str, cfg):
    """(tokenizer, possibly-widened model cfg) for a builtin tokenizer.

    THE single vocab rule: training (train/distill.py) and serving
    (engine/local.build_local_backend) both call this, so a checkpoint
    trained with a builtin tokenizer restores into the serving stack
    shape-for-shape — the embedding width is decided here and only here.
    """
    import dataclasses

    if name == "numeric":
        if cfg.vocab_size < NumericTokenizer.VOCAB:
            cfg = dataclasses.replace(cfg, vocab_size=NumericTokenizer.VOCAB)
        return NumericTokenizer(vocab_size=cfg.vocab_size), cfg
    if name == "byte":
        if cfg.vocab_size < 512:
            cfg = dataclasses.replace(cfg, vocab_size=512)
        return ByteTokenizer(vocab_size=cfg.vocab_size), cfg
    raise ValueError(
        f"unknown tokenizer {name!r} (builtin: 'byte', 'numeric'; use "
        f"tokenizer_path for a HF tokenizer dir)"
    )


class HFTokenizerAdapter:
    """Local-files-only wrapper over a HuggingFace fast tokenizer.

    `path` must contain tokenizer.json etc. (e.g. an exported Llama 3
    tokenizer dir). Import is deferred so hermetic environments never touch
    transformers.
    """

    def __init__(self, path: str) -> None:
        from transformers import AutoTokenizer  # local import by design

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self._tok)
        self.eos_id = self._tok.eos_token_id
        self.pad_id = self._pick_pad_sentinel()
        # rendered-prefix STRING -> its token ids. A burst shares ONE
        # cluster-state prefix across every pod; re-encoding its ~10k chars
        # per pod costs ~6 ms each, which staggers the burst's leaders past
        # the engine's admission-coalescing window and fragments one wave
        # into several. Keying on the exact rendered text (not the inputs)
        # makes a hit trivially sound; the cheap parts — template render
        # (~0.1 ms) and the split validation — still run per call.
        self._prefix_encode_memo: dict[str, list[int]] = {}

    def _pick_pad_sentinel(self) -> int:
        """An id the engine can use as the idle-slot emission sentinel.

        It must be a real embedding row the sampler can never legitimately
        produce: token 0 is real text in Llama-3 ('!'), so defaulting to 0
        would silently strip '!' from generated output (engine/engine.py
        filters pad from emissions). Prefer the tokenizer's own pad token,
        then a reserved special token; raise rather than guess."""
        if self._tok.pad_token_id is not None:
            return self._tok.pad_token_id
        for name in ("<|finetune_right_pad_id|>",):
            tid = self._tok.convert_tokens_to_ids(name)
            if tid is not None and tid != getattr(self._tok, "unk_token_id", None):
                return tid
        for tok_str, tid in sorted(
            self._tok.get_added_vocab().items(), key=lambda kv: -kv[1]
        ):
            if "reserved" in tok_str and tid not in (self.eos_id,):
                return tid
        raise ValueError(
            "tokenizer has no pad token and no reserved special token to use "
            "as the idle-slot sentinel; set tokenizer.pad_token explicitly"
        )

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def chat_prompt(self, system: str, user: str) -> list[int]:
        messages = [
            {"role": "system", "content": system},
            {"role": "user", "content": user},
        ]
        return self._tok.apply_chat_template(messages, add_generation_prompt=True)

    def chat_prompt_parts(
        self, system: str, user_prefix: str, user_suffix: str
    ) -> tuple[list[int], list[int]]:
        """Split at the string boundary of the rendered template, encoding
        each half separately. The suffix's first token may tokenize slightly
        differently than in the unsplit prompt (standard prefix-caching
        tradeoff at block boundaries); the prefix block is identical across
        a burst, which is what the on-device prefix cache keys on.

        The split point is located by finding user_prefix in the render and
        verifying user_suffix follows it VERBATIM — searching for the suffix
        alone could match a later occurrence of its text inside the
        template's tail, and a template that transforms the content
        (trim/escape) fails the verbatim check; both degrade to no prefix
        sharing instead of mis-splitting. Only the ~10k-char prefix ENCODE
        (~6 ms) is memoized, keyed on the exact rendered prefix text; the
        render (~0.1 ms) and this validation run on every call."""
        messages = [
            {"role": "system", "content": system},
            {"role": "user", "content": user_prefix + user_suffix},
        ]
        rendered = self._tok.apply_chat_template(
            messages, add_generation_prompt=True, tokenize=False
        )
        split_at = -1
        if user_prefix and user_suffix:
            pos = rendered.rfind(user_prefix)
            if pos >= 0 and rendered.startswith(user_suffix, pos + len(user_prefix)):
                split_at = pos + len(user_prefix)
        if split_at <= 0:
            return [], self.chat_prompt(system, user_prefix + user_suffix)
        prefix_str = rendered[:split_at]
        prefix = self._prefix_encode_memo.get(prefix_str)
        if prefix is None:
            prefix = self._tok.encode(prefix_str, add_special_tokens=False)
            if len(self._prefix_encode_memo) > 8:
                self._prefix_encode_memo.clear()
            self._prefix_encode_memo[prefix_str] = prefix
        suffix = self._tok.encode(rendered[split_at:], add_special_tokens=False)
        return list(prefix), suffix
