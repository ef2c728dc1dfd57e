"""Attention ops (the port of ops/attention.py).

Plain PyTorch versions of the JAX package's einsum paths — `attend_part`,
`merge_attention_parts`, `causal_prefill_attention`,
`chunk_attention_with_prefix`, and the gather-then-attend paged decode
`paged_decode_attention` (whose streaming kernel K4 is in
ops/paged_attention.py). The JAX package's `prefix_attend_parts` and
`causal_chunk_attend_parts` are the wrappers of the flash kernels K1 and K2
in ops/prefix_attention.py (`flash_prefix_attention_parts`,
`flash_causal_attention_parts`): they launch the CUDA kernel for CUDA tensors
and compute the plain version for CPU tensors. There is no shape-based or
"auto" fallback: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import torch

from k8s_llm_scheduler_tpu_torch.ops.prefix_attention import (
    NEG_INF,
    flash_causal_attention_parts,
    flash_prefix_attention_parts,
)


def causal_prefill_attention(q, k, v, seq_lens):
    """Causal self-attention over a padded prompt chunk, GQA-aware.

    q [B, S, n_heads, hd], k/v [B, S, n_kv, hd], seq_lens [B]. f32 softmax,
    output in q's dtype. Used by the single-shot prefix prefill only."""
    B, S, n_heads, hd = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(B, S, n_kv, n_heads // n_kv, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float() * hd**-0.5, k.float())
    pos = torch.arange(S, device=q.device)
    causal = pos[:, None] >= pos[None, :]
    valid = pos[None, :] < seq_lens[:, None]
    mask = causal[None, None, None, :, :] & valid[:, None, None, None, :]
    weights = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", weights, v.float())
    return out.reshape(B, S, n_heads, hd).to(q.dtype)


def merge_attention_parts(parts):
    """Flash-style merge of partial-softmax parts (o, m, l); a fully masked
    part carries m = NEG_INF and so weight exp(NEG_INF - m*) = 0."""
    o_acc, m_acc, l_acc = parts[0]
    for o, m, l in parts[1:]:
        m_new = torch.maximum(m_acc, m)
        w_acc = torch.exp(m_acc - m_new)
        w = torch.exp(m - m_new)
        o_acc = o_acc * w_acc[..., None] + o * w[..., None]
        l_acc = l_acc * w_acc + l * w
        m_acc = m_new
    return o_acc / torch.clamp(l_acc, min=1e-30)[..., None]


def attend_part(q_scaled, k, v, mask, kv_eq):
    """One softmax part (o, m, l) for merge_attention_parts.

    q_scaled: f32, already scaled; `kv_eq` maps q x k -> logits with the kv
    axis LAST; the output equation swaps it for a trailing head dim. Masked
    probabilities are not zeroed (the JAX einsum path's semantics): a fully
    masked row reports m = NEG_INF and merges with weight zero."""
    logits = torch.einsum(kv_eq, q_scaled, k.float())
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    lhs, rhs = kv_eq.split("->")
    k_spec = lhs.split(",")[1]
    o = torch.einsum(f"{rhs},{k_spec}->{rhs[:-1]}h", p, v.float())
    return o, m, l


def chunk_attention_with_prefix(
    q, k_chunk, v_chunk, chunk_lens, prefix_k, prefix_v, prefix_len
):
    """Suffix-chunk cascade attention: every query attends the whole valid
    shared prefix (K1) and causally within its own chunk (K2); the two
    parts merge exactly. Returns [B, S, n_heads, hd] in q's dtype."""
    B, S, n_heads, hd = q.shape
    o_p, m_p, l_p = flash_prefix_attention_parts(q, prefix_k, prefix_v, prefix_len)
    o_c, m_c, l_c = flash_causal_attention_parts(q, k_chunk, v_chunk, chunk_lens)
    out = merge_attention_parts([(o_p, m_p, l_p), (o_c, m_c, l_c)])
    out = torch.movedim(out, 3, 1)  # [B, S, n_kv, g, hd]
    return out.reshape(B, S, n_heads, hd).to(q.dtype)


def gather_pages(cache, page_table):
    """Each sequence's pages as one contiguous view: cache [num_pages, ps,
    n_kv, hd], page_table [B, max_pages] -> [B, max_pages * ps, n_kv, hd]."""
    gathered = cache[page_table.long()]  # [B, P, ps, n_kv, hd]
    B, P, ps, n_kv, hd = gathered.shape
    return gathered.reshape(B, P * ps, n_kv, hd)


def paged_decode_attention(q, k_cache, v_cache, page_table, seq_lens):
    """One decode step of attention against the paged KV cache, gather then
    attend (the JAX package's XLA path). q [B, n_heads, hd] (one new token a
    sequence, its K/V already in the cache); seq_lens [B] counts it. f32
    softmax, output in q's dtype."""
    B, n_heads, hd = q.shape
    n_kv = k_cache.shape[2]
    k = gather_pages(k_cache, page_table)
    v = gather_pages(v_cache, page_table)
    L = k.shape[1]
    qg = q.reshape(B, n_kv, n_heads // n_kv, hd)
    logits = torch.einsum("bkgh,blkh->bkgl", qg.float() * hd**-0.5, k.float())
    valid = torch.arange(L, device=q.device)[None, :] < seq_lens[:, None]
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgl,blkh->bkgh", weights, v.float())
    return out.reshape(B, n_heads, hd).to(q.dtype)
