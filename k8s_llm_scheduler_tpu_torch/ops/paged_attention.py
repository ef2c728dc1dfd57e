"""Paged decode attention: K4, a hand-written CUDA kernel, with its plain
twins (the port of the JAX package's ops/pallas_paged_attention.py).

One query token per sequence attends that sequence's KV pages, walked
through `page_table[B, P]` up to `seq_lens[B]`. q is scaled by hd^-0.5 in
f32, the math is f32, and query head kv*g + gi reads kv head kv. Two modes
of one kernel (csrc/paged_attention.cu):

- `paged_decode_attention_parts`: the flash partials (o f32 [B, n_kv, g,
  hd], m and l f32 [B, n_kv, g]) that join the general path's decode
  cascade (models/llama.forward_decode_buffered, own_impl="pallas");
- `paged_decode_attention`: o / max(l, 1e-30) in q's dtype, [B, n_heads,
  hd] (models/llama.forward_decode, paged_attn="pallas").

A length <= 0 (the engine's trash row and idle slots) attends nothing:
exactly m = -1e30, l = 0, o = 0. Each wrapper dispatches on where q lies:
on the CPU the plain version (gather the pages, mask, attend); on a CUDA
tensor the kernel, or it raises. Every launch adds one to the wrapper's
`launches` count.

The kernel splits each sequence's pages over blocks (`paged_splits` picks
the count from shapes, `split_page_ranges` is the ranges the blocks find
on the device) and merges the splits in split order in the same launch;
`split_paged_parts_plain` and `merge_paged_splits_plain` are the plain
twins of its workspace and of that merge.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from k8s_llm_scheduler_tpu_torch.ops import kernels
from k8s_llm_scheduler_tpu_torch.ops.attention import gather_pages

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
MAX_GROUP = 8  # query heads per kv head the kernel takes
MIN_TICKETS = 4096  # split-merge counters kept per card (grown on demand)
# Fewest tokens a split takes: below that, one block's walk over the pages
# costs less than merging more splits (the workspace, the ticket and the
# last block's fold), so a short sequence gets fewer splits than planned.
MIN_SPLIT_TOKENS = 256


def _parts_over(q, k_cache, v_cache, page_table, lo, hi):
    """Partials over the gathered token positions [lo[b], hi[b]) of each
    sequence (the plain arithmetic of both twins below)."""
    B, n_heads, hd = q.shape
    n_kv = k_cache.shape[2]
    k = gather_pages(k_cache, page_table).float()  # [B, P*ps, n_kv, hd]
    v = gather_pages(v_cache, page_table).float()
    qs = (q.float() * hd**-0.5).reshape(B, n_kv, n_heads // n_kv, hd)
    logits = torch.einsum("bkgh,blkh->bkgl", qs, k)
    pos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = ((pos >= lo[:, None]) & (pos < hi[:, None]))[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.where(mask, torch.exp(logits - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgl,blkh->bkgh", p, v)
    return o, m, l


def paged_attention_parts_plain(q, k_cache, v_cache, page_table, seq_lens):
    """Plain PyTorch K4 partials: q [B, n_heads, hd]; caches [num_pages, ps,
    n_kv, hd]; page_table [B, P]; seq_lens [B] (any sign)."""
    return _parts_over(q, k_cache, v_cache, page_table,
                       torch.zeros_like(seq_lens), seq_lens)


def paged_attention_plain(q, k_cache, v_cache, page_table, seq_lens):
    """Plain PyTorch K4 normalized: [B, n_heads, hd] in q's dtype."""
    o, _, l = paged_attention_parts_plain(q, k_cache, v_cache, page_table, seq_lens)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(q.shape).to(q.dtype)


def paged_splits(B: int, n_kv: int, P: int, sm_count: int) -> int:
    """Splits of each sequence's pages over K4's blocks, from the shapes the
    host knows (never seq_lens, which live on the device, so no sync).

    The grid is B * n_kv * splits blocks: the fewest splits that give each
    of the card's SMs a block, and never more splits than the table has
    pages (9 sequences x 8 kv heads on 132 SMs: 2)."""
    return max(1, min(P, -(-sm_count // max(1, B * n_kv))))


def min_split_pages(ps: int) -> int:
    """Fewest pages a split takes: MIN_SPLIT_TOKENS, rounded up to pages."""
    return max(1, -(-MIN_SPLIT_TOKENS // ps))


def split_page_ranges(seq_lens, ps: int, P: int, splits: int):
    """Token ranges [lo, hi) of each split as the kernel finds them on the
    device from len = clamp(seq_lens, 0, P*ps): pages [s*c, (s+1)*c) of
    the n_pages = ceil(len / ps) valid pages, c = max(ceil(n_pages /
    splits), min_split_pages(ps)), cut at len. Returns (lo, hi), each
    [splits, B]; an empty range has lo >= hi."""
    n = torch.clamp(seq_lens.long(), 0, P * ps)
    per = torch.clamp(-(-(-(-n // ps)) // splits), min=min_split_pages(ps))
    s = torch.arange(splits, device=seq_lens.device)[:, None]
    lo = s * per * ps
    return lo, torch.minimum((s + 1) * per * ps, n[None, :])


def split_paged_parts_plain(q, k_cache, v_cache, page_table, seq_lens, splits):
    """Plain twin of the split kernel's workspace: each split's partials
    over its device-style page range (split_page_ranges), stacked on a
    leading split axis. An empty range gives m = -1e30, l = 0, o = 0."""
    ps, P = k_cache.shape[1], page_table.shape[1]
    lo, hi = split_page_ranges(seq_lens, ps, P, splits)
    parts = [_parts_over(q, k_cache, v_cache, page_table, lo[s], hi[s])
             for s in range(splits)]
    return tuple(torch.stack(t) for t in zip(*parts))


def merge_paged_splits_plain(o, m, l):
    """Plain twin of the last block's merge: the splits' partials (leading
    split axis) folded in split order, m = max m_s, l = sum l_s e^(m_s - m),
    o = sum o_s e^(m_s - m). Empty splits weigh 0; all empty stays
    m = -1e30, l = 0, o = 0. (The kernel folds 8 splits at a time and
    rescales to each new maximum: the same within f32 rounding.)"""
    m_all = m.amax(dim=0)
    o_acc, l_acc = torch.zeros_like(o[0]), torch.zeros_like(l[0])
    for s in range(m.shape[0]):
        w = torch.exp(m[s] - m_all)
        o_acc = o_acc + o[s] * w[..., None]
        l_acc = l_acc + l[s] * w
    return o_acc, m_all, l_acc


@functools.cache
def _entry():
    fn = kernels.library("paged_attention").k8s_paged_decode
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
    )
    return fn


_tickets: dict[int, torch.Tensor] = {}


def _ticket_counters(dev, n: int) -> torch.Tensor:
    """The card's split-merge counters: zero between calls (each call's last
    block sets its counters back), so they are allocated once, outside any
    CUDA-graph capture, and shared by the calls on that card's stream."""
    t = _tickets.get(dev.index)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged decode attention: make one call before capturing a CUDA graph "
                "(its split counters are allocated outside the capture)"
            )
        t = torch.zeros(max(n, MIN_TICKETS), dtype=torch.int32, device=dev)
        _tickets[dev.index] = t
    return t


def _check_cuda(name, q, k_cache, v_cache, page_table, seq_lens):
    for t in (k_cache, v_cache, page_table, seq_lens):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
    for t in (q, k_cache, v_cache):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bf16 q and caches, got {t.dtype}")
    for t in (q, k_cache, v_cache, page_table, seq_lens):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel takes contiguous 16-byte aligned tensors")
    B, n_heads, hd = q.shape
    num_pages, ps, n_kv, hd_k = k_cache.shape
    if hd not in HEAD_DIMS or hd_k != hd or tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"{name}: q {tuple(q.shape)} and caches {tuple(k_cache.shape)}")
    if n_heads % n_kv or n_heads // n_kv > MAX_GROUP:
        raise ValueError(f"{name}: {n_heads} heads over {n_kv} kv heads (group <= {MAX_GROUP})")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"{name}: page_table must be int32 [{B}, P]")
    if seq_lens.dtype != torch.int32 or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"{name}: seq_lens must be int32 [{B}]")
    if B > 65535 or n_kv > 65535 or num_pages * ps >= 2**31 or page_table.shape[1] * ps >= 2**31:
        raise ValueError(f"{name}: {B} sequences of {num_pages} pages of {ps} exceed the grid")


def _launch(name, q, k_cache, v_cache, page_table, seq_lens, normalize):
    _check_cuda(name, q, k_cache, v_cache, page_table, seq_lens)
    B, n_heads, hd = q.shape
    num_pages, ps, n_kv, _ = k_cache.shape
    P = page_table.shape[1]
    g = n_heads // n_kv
    dev = q.device
    splits = paged_splits(B, n_kv, P, kernels.sm_count(dev))
    if normalize:
        o = torch.empty((B, n_heads, hd), dtype=q.dtype, device=dev)
        m = l = None
    else:
        o = torch.empty((B, n_kv, g, hd), dtype=torch.float32, device=dev)
        m = torch.empty((B, n_kv, g), dtype=torch.float32, device=dev)
        l = torch.empty((B, n_kv, g), dtype=torch.float32, device=dev)
    ws = (torch.empty(splits * B * n_heads * (hd + 2), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    with torch.cuda.device(dev):  # launch on q's card
        tickets = _ticket_counters(torch.device("cuda", torch.cuda.current_device()),
                                   B * n_kv)
        rc = _entry()(
            *map(kernels.ptr, (q, k_cache, v_cache, page_table, seq_lens, o, m, l, ws,
                               tickets)),
            B, n_kv, g, ps, P, num_pages, hd, splits, min_split_pages(ps), int(normalize),
            ctypes.c_float(hd**-0.5), kernels.stream(dev),
        )
    if rc == -1:
        raise ValueError(f"{name}: unsupported head dim or group")
    if rc == -2:
        raise RuntimeError(f"{name}: the K/V TMA tensor maps cannot be encoded")
    if rc == -3:
        raise RuntimeError(f"{name}: {splits} page splits for a table of {P} pages")
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    return o if normalize else (o, m, l)


def paged_decode_attention_parts(q, k_cache, v_cache, page_table, seq_lens):
    """K4 partials. q [B, n_heads, hd] post-RoPE and unscaled; caches
    [num_pages, ps, n_kv, hd]; page_table [B, P] int32; seq_lens [B] int32
    valid tokens in the paged region (<= 0: none)."""
    if q.device.type == "cpu":
        return paged_attention_parts_plain(q, k_cache, v_cache, page_table, seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_parts: no kernel for {q.device}")
    out = _launch("paged_decode_attention_parts", q, k_cache, v_cache,
                  page_table, seq_lens, normalize=False)
    paged_decode_attention_parts.launches += 1
    return out


def paged_decode_attention(q, k_cache, v_cache, page_table, seq_lens):
    """K4 normalized: the same inputs as paged_decode_attention_parts
    (seq_lens counting the new token); returns [B, n_heads, hd] in q's
    dtype."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_cache, v_cache, page_table, seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    out = _launch("paged_decode_attention", q, k_cache, v_cache,
                  page_table, seq_lens, normalize=True)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention_parts.launches = 0
paged_decode_attention.launches = 0
