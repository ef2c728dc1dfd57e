"""Paged KV cache (the port of the JAX package's engine/kv_cache.py).

- K/V tensors are [n_layers, num_pages, page_size, n_kv_heads, head_dim],
  allocated once on the device; page 0 is reserved scratch (inactive decode
  slots and padding prefill blocks write there, and nothing reads it as a
  sequence's page).
- A fixed pool of `max_slots` sequence slots; per-slot page tables
  [max_slots, max_pages_per_seq] map logical token blocks to pages.
- Page allocation and release are host bookkeeping (free lists and
  refcounts); the device tables are rebuilt only after a change.

The burst-shared cluster prefix lives outside this cache, as a dense buffer
(engine/engine.py _PrefixKV): slot pages hold only each request's suffix and
generated tokens.

`write_prefill`, `ensure_capacity` and `note_token_appended` are the manual
page API for driving models/llama.forward_decode directly; the engine
reserves a request's whole capacity at admission and scatters KV inside its
forwards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from k8s_llm_scheduler_tpu_torch.device import resolve_device
from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig


class OutOfPagesError(RuntimeError):
    """The page pool is exhausted: the caller should backpressure admissions."""


@dataclasses.dataclass
class SlotInfo:
    slot: int
    length: int  # tokens currently stored
    pages: list[int]  # owned pages (refcounted)


class PagedKVCache:
    def __init__(
        self,
        cfg: LlamaConfig,
        num_pages: int = 256,
        page_size: int = 128,
        max_slots: int = 8,
        max_pages_per_seq: int = 64,
        device: str | torch.device = "cuda",
    ) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_slots = int(max_slots)
        self.max_pages_per_seq = int(max_pages_per_seq)
        shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
        self.k = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        # Host state. Page 0 is scratch: never allocated.
        self._free = list(range(num_pages - 1, 0, -1))
        self._refcount = np.zeros(num_pages, dtype=np.int32)
        self._slots: dict[int, SlotInfo] = {}
        self._free_slots = list(range(max_slots - 1, -1, -1))
        # Device mirror of the tables, rebuilt after a change.
        self._tables_np = np.zeros((max_slots, max_pages_per_seq), dtype=np.int32)
        self._tables_dirty = True
        self._tables_dev: torch.Tensor | None = None

    # ------------------------------------------------------------- plumbing
    @property
    def pages_free(self) -> int:
        return len(self._free)

    def page_tables(self) -> torch.Tensor:
        """[max_slots, max_pages_per_seq] int32 on the device; the same
        tensor until the tables change."""
        if self._tables_dirty or self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self._tables_np.copy()).to(self.device)
            self._tables_dirty = False
        return self._tables_dev

    def _alloc_pages(self, n: int) -> list[int]:
        if n > len(self._free):
            raise OutOfPagesError(f"need {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refcount[p] += 1
        return pages

    def _release_pages(self, pages: list[int]) -> None:
        for p in pages:
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                self._free.append(p)

    def pages_needed(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.page_size))

    # ----------------------------------------------------------------- slots
    def allocate_slot(self, n_tokens: int, reserve_decode: int = 0) -> int:
        """Claim a slot with pages covering n_tokens (+ reserve_decode)."""
        if not self._free_slots:
            raise OutOfPagesError("no free sequence slots")
        need = self.pages_needed(n_tokens + reserve_decode)
        if need > self.max_pages_per_seq:
            raise OutOfPagesError(
                f"sequence needs {need} pages > max_pages_per_seq={self.max_pages_per_seq}"
            )
        pages = self._alloc_pages(need)
        slot = self._free_slots.pop()
        self._slots[slot] = SlotInfo(slot=slot, length=0, pages=pages)
        row = np.zeros(self.max_pages_per_seq, dtype=np.int32)
        row[: len(pages)] = pages
        self._tables_np[slot] = row
        self._tables_dirty = True
        return slot

    def free_slot(self, slot: int) -> None:
        info = self._slots.pop(slot)
        self._release_pages(info.pages)
        self._free_slots.append(slot)
        self._tables_np[slot] = 0
        self._tables_dirty = True

    def slot_length(self, slot: int) -> int:
        return self._slots[slot].length

    def slot_pages(self, slot: int) -> list[int]:
        """The slot's owned page ids, in logical-block order."""
        return list(self._slots[slot].pages)

    def ensure_decode_capacity(self, slot: int) -> None:
        """Grow the slot by one page if the next token would overflow."""
        self.ensure_capacity(slot, self._slots[slot].length + 1)

    def ensure_capacity(self, slot: int, upto_len: int) -> None:
        """Grow the slot's page list to cover `upto_len` tokens."""
        info = self._slots[slot]
        while len(info.pages) * self.page_size < upto_len:
            if len(info.pages) + 1 > self.max_pages_per_seq:
                raise OutOfPagesError("sequence exceeded max_pages_per_seq")
            (page,) = self._alloc_pages(1)
            self._tables_np[info.slot, len(info.pages)] = page
            info.pages.append(page)
            self._tables_dirty = True

    def note_token_appended(self, slot: int) -> None:
        self._slots[slot].length += 1

    def truncate(self, slot: int, new_length: int) -> None:
        """Shrink a slot to `new_length` tokens, releasing the tail pages it
        no longer needs (refcounted, never double-freed; a slot keeps at
        least one page). Page contents are not cleared: readers mask by
        length. The recorded length is SET to `new_length` (clamped to page
        capacity), so a caller truncates only downward from what it wrote."""
        if new_length < 0:
            raise ValueError(f"new_length must be >= 0, got {new_length}")
        info = self._slots[slot]
        keep = self.pages_needed(new_length)
        if keep < len(info.pages):
            dropped = info.pages[keep:]
            del info.pages[keep:]
            self._release_pages(dropped)
            self._tables_np[slot, keep:] = 0
            self._tables_dirty = True
        info.length = min(new_length, len(info.pages) * self.page_size)

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def write_prefill(
        self,
        slot: int,
        k_all: torch.Tensor,  # [L, S, n_kv, hd] — one sequence's prefill KV
        v_all: torch.Tensor,
        seq_len: int,
    ) -> None:
        """Scatter a sequence's prefill K/V into its pages. S (the padded
        bucket) may exceed seq_len; whole blocks past the needed pages go to
        scratch page 0."""
        info = self._slots[slot]
        L, S, n_kv, hd = k_all.shape
        if S % self.page_size:
            raise ValueError("bucket sizes must be multiples of page_size")
        n_blocks = S // self.page_size
        used = self.pages_needed(seq_len)
        dest = np.zeros(n_blocks, dtype=np.int64)
        for i in range(min(used, n_blocks)):
            dest[i] = info.pages[i]
        page_ids = torch.from_numpy(dest).to(self.device)
        shape = (L, n_blocks, self.page_size, n_kv, hd)
        self.k[:, page_ids] = k_all.reshape(shape).to(self.k.dtype)
        self.v[:, page_ids] = v_all.reshape(shape).to(self.v.dtype)
        info.length = seq_len
