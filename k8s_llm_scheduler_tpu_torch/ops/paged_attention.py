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
SMEM_LIMIT = 227 * 1024


def paged_attention_parts_plain(q, k_cache, v_cache, page_table, seq_lens):
    """Plain PyTorch K4 partials: q [B, n_heads, hd]; caches [num_pages, ps,
    n_kv, hd]; page_table [B, P]; seq_lens [B] (any sign)."""
    B, n_heads, hd = q.shape
    n_kv = k_cache.shape[2]
    k = gather_pages(k_cache, page_table).float()  # [B, P*ps, n_kv, hd]
    v = gather_pages(v_cache, page_table).float()
    qs = (q.float() * hd**-0.5).reshape(B, n_kv, n_heads // n_kv, hd)
    logits = torch.einsum("bkgh,blkh->bkgl", qs, k)
    valid = torch.arange(k.shape[1], device=q.device)[None, :] < seq_lens[:, None]
    mask = valid[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.where(mask, torch.exp(logits - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgl,blkh->bkgh", p, v)
    return o, m, l


def paged_attention_plain(q, k_cache, v_cache, page_table, seq_lens):
    """Plain PyTorch K4 normalized: [B, n_heads, hd] in q's dtype."""
    o, _, l = paged_attention_parts_plain(q, k_cache, v_cache, page_table, seq_lens)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(q.shape).to(q.dtype)


@functools.cache
def _entry():
    lib = kernels.library("paged_attention")
    fn = lib.k8s_paged_decode
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.k8s_paged_decode_smem.restype = ctypes.c_int
    lib.k8s_paged_decode_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    return fn, lib.k8s_paged_decode_smem


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
    _, ps, n_kv, hd_k = k_cache.shape
    if hd not in HEAD_DIMS or hd_k != hd or tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"{name}: q {tuple(q.shape)} and caches {tuple(k_cache.shape)}")
    if n_heads % n_kv or n_heads // n_kv > MAX_GROUP:
        raise ValueError(f"{name}: {n_heads} heads over {n_kv} kv heads (group <= {MAX_GROUP})")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"{name}: page_table must be int32 [{B}, P]")
    if seq_lens.dtype != torch.int32 or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"{name}: seq_lens must be int32 [{B}]")


def _launch(name, q, k_cache, v_cache, page_table, seq_lens, normalize):
    _check_cuda(name, q, k_cache, v_cache, page_table, seq_lens)
    B, n_heads, hd = q.shape
    _, ps, n_kv, _ = k_cache.shape
    g = n_heads // n_kv
    fn, smem = _entry()
    if smem(hd, ps) > SMEM_LIMIT:
        raise ValueError(f"{name}: pages of {ps} tokens do not fit shared memory")
    dev = q.device
    if normalize:
        o = torch.empty((B, n_heads, hd), dtype=q.dtype, device=dev)
        m = l = None
    else:
        o = torch.empty((B, n_kv, g, hd), dtype=torch.float32, device=dev)
        m = torch.empty((B, n_kv, g), dtype=torch.float32, device=dev)
        l = torch.empty((B, n_kv, g), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # launch on q's card
        rc = fn(
            *map(kernels.ptr, (q, k_cache, v_cache, page_table, seq_lens, o, m, l)),
            B, n_kv, g, ps, page_table.shape[1], hd, int(normalize),
            ctypes.c_float(hd**-0.5), kernels.stream(dev),
        )
    if rc == -1:
        raise ValueError(f"{name}: unsupported head dim")
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
