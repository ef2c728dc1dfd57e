"""Ring attention: causal self-attention with the sequence split over the
sp axis (the port of the JAX package's parallel/ring_attention.py).

Each sp rank holds one chunk of Q/K/V: rank i holds positions
[i*S_local, (i+1)*S_local). K/V chunks rotate around the ring by
`ppermute` (parallel/collectives.py) while each rank accumulates its
queries' attention blockwise with the log-sum-exp correction, so no rank
holds the [S, S] score matrix. The blocks are plain PyTorch einsums in f32,
as the JAX ring's are (the JAX training forward calls no Pallas kernel).
The backward is autograd's: ppermute's backward is the reverse permute,
as JAX transposes it.
"""

from __future__ import annotations

import torch

from k8s_llm_scheduler_tpu_torch.ops.prefix_attention import NEG_INF
from k8s_llm_scheduler_tpu_torch.parallel.collectives import ppermute


def _block_attn(q, k, v, q_pos, k_pos, scale, k_valid=None):
    """One (q-chunk x k-chunk) block: masked logits, local max and sum.

    q [B, Sq, n_kv, g, hd]; k/v [B, Sk, n_kv, hd]; k_valid [B, Sk] bool
    (padding), None when every key is valid. Returns (num [B, Sq, n_kv, g,
    hd], den [B, Sq, n_kv, g], mx [B, Sq, n_kv, g]), all f32."""
    logits = torch.einsum("bqkgh,bskh->bqkgs", q.float() * scale, k.float())
    mask = (q_pos[:, None] >= k_pos[None, :])[None, :, None, None, :]  # causal
    if k_valid is not None:
        mask = mask & k_valid[:, None, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    mx = logits.amax(dim=-1)
    # exp(NEG_INF - NEG_INF) = 1 on a fully masked row: zero it, so a
    # padded-out row reports den 0 (weight 0)
    p = torch.where(mask, torch.exp(logits - mx[..., None]), 0.0)
    den = p.sum(dim=-1)
    num = torch.einsum("bqkgs,bskh->bqkgh", p, v.float())
    return num, den, mx


def ring_self_attention(
    q: torch.Tensor,  # [B, S_local, n_heads, hd]: this rank's chunk
    k: torch.Tensor,  # [B, S_local, n_kv, hd]
    v: torch.Tensor,
    group,  # the sp axis's AxisGroup
    seq_lens: torch.Tensor | None = None,  # [B] GLOBAL valid length per row
) -> torch.Tensor:
    """Causal ring attention over `group`. Keys at absolute positions >=
    seq_lens[b] are masked out of every block, so a padded batch attends
    only its real tokens, as unsharded masked attention does."""
    B, S, n_heads, hd = q.shape
    n_kv = k.shape[2]
    g = n_heads // n_kv
    scale = hd**-0.5
    n, me = group.size, group.rank
    local_pos = torch.arange(S, device=q.device)
    q_pos = me * S + local_pos
    qg = q.reshape(B, S, n_kv, g, hd)
    num = torch.zeros((B, S, n_kv, g, hd), dtype=torch.float32, device=q.device)
    den = torch.zeros((B, S, n_kv, g), dtype=torch.float32, device=q.device)
    mx = torch.full((B, S, n_kv, g), NEG_INF, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for r in range(n):
        src = (me - r) % n  # whose chunk this rank holds after r rotations
        k_pos = src * S + local_pos
        k_valid = None if seq_lens is None else k_pos[None, :] < seq_lens[:, None]
        b_num, b_den, b_mx = _block_attn(qg, k_cur, v_cur, q_pos, k_pos, scale, k_valid)
        new_mx = torch.maximum(mx, b_mx)
        corr_old = torch.exp(mx - new_mx)
        corr_new = torch.exp(b_mx - new_mx)
        num = num * corr_old[..., None] + b_num * corr_new[..., None]
        den = den * corr_old + b_den * corr_new
        mx = new_mx
        if r + 1 < n:  # the JAX loop's last rotation is never read
            k_cur = ppermute(k_cur, group, 1)
            v_cur = ppermute(v_cur, group, 1)
    # den == 0 only for a zero-length row (every key masked): 0, not 0/0
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(B, S, n_heads, hd).to(q.dtype)


def make_ring_prefill_attention(mesh, sp_axis: str = "sp", batch_axis: str | None = None):
    """attn(q, k, v, seq_lens=None) over this rank's chunk, with the
    signature of ops.attention.causal_prefill_attention (the model's
    `attn_impl`). `mesh` is bound to this rank; q/k/v hold this rank's
    rows (split over `batch_axis` by the caller) and its chunk of
    positions, `seq_lens` the rows' GLOBAL lengths (the whole sequence's
    length when None)."""

    def attn(q, k, v, seq_lens=None):
        group = mesh.group(sp_axis)  # created at the first call, on every rank
        if seq_lens is None:
            seq_lens = torch.full((q.shape[0],), q.shape[1] * group.size,
                                  dtype=torch.int32, device=q.device)
        return ring_self_attention(q, k, v, group, seq_lens)

    return attn
