"""Flash-attention partials for the decision path: K1 (shared prefix) and K2
(causal in-chunk), as hand-written CUDA kernels with their plain twins.

Ports the two TPU kernels of the JAX package's ops/pallas_prefix_attention.py
(`_prefix_kernel`, `_causal_kernel`). Both return UNNORMALIZED flash partials
(o [B, n_kv, g, S, hd] f32, m and l [B, n_kv, g, S] f32) that
ops/attention.merge_attention_parts folds with the other parts of a cascade.
A row with no valid key reports m = -1e30, l = 0, o = 0.

Each wrapper dispatches on where its tensors lie: on the CPU it computes the
plain PyTorch version; on a CUDA tensor it launches the kernel
(csrc/prefix_attention.cu, csrc/causal_attention.cu) or raises — there is no
fallback. The kernels take bf16 operands (q, k, v), head dims 64 and 128,
any sequence lengths, and read `prefix_len` / `lens` from device memory.
Every launch adds one to the wrapper's `launches` count.

Both are Hopper kernels on one body (csrc/flash_hopper.cuh: wgmma fed by
a TMA ring). Where K1's query rows are too few to fill the card (block
decode), `kv_splits` splits the prefix keys over blocks from the shapes
alone; the splits' f32 partials go to a workspace and a second kernel folds
them in split order (`combine_splits_plain` is its twin). K2's blocks each
take 128 rows of one batch row and kv head, walk only the key tiles below
their last row's causal limit and launch each batch row's heaviest first
(`causal_block_plan` is the twin of that plan).

The plain versions round exactly where the kernels do: q is scaled in f32
and rounded to the operand dtype, scores accumulate in f32, and the
probabilities are rounded to the operand dtype before the product with V
while l sums them unrounded. With f32 operands they are the JAX package's
einsum path (ops/attention.attend_part) with the masked probabilities
zeroed.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from k8s_llm_scheduler_tpu_torch.ops import kernels

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
# K1's and K2's tiling (csrc/flash_hopper.cuh kRows, kKeys): query rows of
# one kv head per block, and keys per tile (the unit of a key split and of
# K2's causal walk). Each wrapper checks them against its built kernel's
# before its first launch. A block's rows are two consumer warpgroups of 64
# (wgmma's M).
ROWS_PER_BLOCK = 128
KEYS_PER_TILE = 128
ROWS_PER_WARPGROUP = 64


def _masked_parts(logits, mask, v, pv_eq):
    """(o, m, l) of masked f32 logits; masked probabilities are zero."""
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.where(mask, torch.exp(logits - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum(pv_eq, p.to(v.dtype).float(), v.float())
    return o, m, l


def _scaled_queries(q, operand_dtype):
    """q scaled by hd**-0.5 in f32, rounded to the operand dtype, back in
    f32 (the kernels' order of operations)."""
    hd = q.shape[-1]
    return (q.float() * hd**-0.5).to(operand_dtype).float()


def prefix_attention_parts_plain(q, prefix_k, prefix_v, prefix_len):
    """Plain PyTorch K1: partials of q [B, S, n_heads, hd] against the shared
    prefix [Sp, n_kv, hd], keys < prefix_len (a 0-dim int tensor)."""
    B, S, n_heads, hd = q.shape
    Sp, n_kv, _ = prefix_k.shape
    g = n_heads // n_kv
    qs = _scaled_queries(q, prefix_k.dtype).reshape(B, S, n_kv, g, hd)
    logits = torch.einsum("bqkgh,skh->bkgqs", qs, prefix_k.float())
    valid = torch.arange(Sp, device=q.device) < prefix_len
    return _masked_parts(
        logits, valid[None, None, None, None, :], prefix_v, "bkgqs,skh->bkgqh"
    )


def causal_attention_parts_plain(q, k, v, lens):
    """Plain PyTorch K2: causal partials of q [B, S, n_heads, hd] against the
    chunk's own k/v [B, S, n_kv, hd], keys < lens[b] (int [B])."""
    B, S, n_heads, hd = q.shape
    n_kv = k.shape[2]
    g = n_heads // n_kv
    qs = _scaled_queries(q, k.dtype).reshape(B, S, n_kv, g, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qs, k.float())
    pos = torch.arange(S, device=q.device)
    causal = pos[:, None] >= pos[None, :]
    valid = pos[None, :] < lens[:, None]
    mask = causal[None, None, None, :, :] & valid[:, None, None, None, :]
    return _masked_parts(logits, mask, v, "bkgqs,bskh->bkgqh")


def _check_cuda(name, q, kv_tensors, n_kv, limit, limit_shape):
    tensors = (q, *kv_tensors)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bf16 operands, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if q.shape[2] % n_kv:
        raise ValueError(f"{name}: {q.shape[2]} heads over {n_kv} kv heads")
    if (
        limit.device != q.device
        or limit.dtype != torch.int32
        or tuple(limit.shape) != limit_shape
        or not limit.is_contiguous()
    ):
        raise ValueError(
            f"{name}: length must be a contiguous int32 tensor of shape "
            f"{limit_shape} on {q.device}, got {limit.dtype} "
            f"{tuple(limit.shape)} on {limit.device}"
        )


def _outputs(B, S, n_kv, g, hd, device):
    o = torch.empty((B, n_kv, g, S, hd), dtype=torch.float32, device=device)
    m = torch.empty((B, n_kv, g, S), dtype=torch.float32, device=device)
    l = torch.empty((B, n_kv, g, S), dtype=torch.float32, device=device)
    return o, m, l


@functools.cache
def _entry(lib: str, symbol: str, n_ptrs: int, n_ints: int):
    """The C entry point `symbol` of csrc/<lib>.cu: `n_ptrs` pointers (q,
    k, v, lengths, o, m, l, then any workspace), `n_ints` ints, the scale
    and the stream."""
    fn = getattr(kernels.library(lib), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
        + [ctypes.c_float, ctypes.c_void_p]
    )
    return fn


def _raise_on(rc: int, name: str) -> None:
    if rc == -1:
        raise ValueError(f"{name}: unsupported head dim")
    if rc == -2:
        raise RuntimeError(f"{name}: the K/V TMA tensor maps cannot be encoded")
    if rc == -3:
        raise RuntimeError(f"{name}: the key-split plan is not whole key tiles")
    if rc == -4:
        raise ValueError(f"{name}: more blocks than a 1-D grid holds")
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


@functools.cache
def _check_tiling(lib: str, symbol: str, name: str) -> None:
    """Raises unless the kernel of csrc/<lib>.cu tiles as ROWS_PER_BLOCK and
    KEYS_PER_TILE say, which K1's split plan and K2's block plan assume."""
    fn = getattr(kernels.library(lib), symbol)
    fn.restype = None
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    rows, keys = ctypes.c_int(), ctypes.c_int()
    fn(ctypes.byref(rows), ctypes.byref(keys))
    if (rows.value, keys.value) != (ROWS_PER_BLOCK, KEYS_PER_TILE):
        raise RuntimeError(
            f"{name}: the kernel tiles {rows.value} rows x {keys.value} keys, "
            f"the host plans {ROWS_PER_BLOCK} x {KEYS_PER_TILE}"
        )


def kv_splits(rows: int, n_kv: int, Sp: int, hd: int, sm_count: int) -> tuple[int, int]:
    """(splits, keys_per_split) of K1's prefix keys over blocks, from the
    shapes the host knows (never prefix_len, which lives on the device).

    A block owns ROWS_PER_BLOCK query rows of one kv head (`rows` = B*S*g
    per kv head). Where those blocks cannot fill the card's SMs once, the
    Sp keys are split into whole tiles so that they do, as far as the
    workspace cap allows; keys_per_split is a multiple of KEYS_PER_TILE."""
    key_tiles = max(1, -(-Sp // KEYS_PER_TILE))
    blocks = -(-rows // ROWS_PER_BLOCK) * n_kv
    splits = 1
    if 0 < blocks < sm_count:
        per_split = rows * n_kv * (hd + 2) * 4
        cap = max(1, workspace_cap_bytes(Sp, n_kv, hd) // per_split)
        splits = min(-(-sm_count // blocks), key_tiles, cap)
    per = -(-key_tiles // splits)
    return -(-key_tiles // per), per * KEYS_PER_TILE


def workspace_cap_bytes(Sp: int, n_kv: int, hd: int) -> int:
    """The most f32 split workspace a K1 call may use: half the bytes of its
    bf16 K/V buffers, so the workspace (written and read once) never costs
    more traffic than the keys it splits."""
    return Sp * n_kv * hd * 2


def split_prefix_parts_plain(q, prefix_k, prefix_v, prefix_len, splits, keys_per_split):
    """Plain twin of the split kernel's workspace: K1's partials over each
    key range [s*keys_per_split, (s+1)*keys_per_split), stacked on a leading
    split axis. A range at or past prefix_len gives m = -1e30, l = 0, o = 0."""
    Sp = prefix_k.shape[0]
    parts = []
    for s in range(splits):
        begin, end = s * keys_per_split, min((s + 1) * keys_per_split, Sp)
        local = torch.clamp(prefix_len - begin, 0, end - begin)
        parts.append(prefix_attention_parts_plain(
            q, prefix_k[begin:end], prefix_v[begin:end], local))
    return tuple(torch.stack(t) for t in zip(*parts))


def combine_splits_plain(o, m, l):
    """Plain twin of the combine kernel: folds split partials (leading split
    axis) into one unnormalized partial, m = max m_s, l = sum l_s e^(m_s-m),
    o = sum o_s e^(m_s-m). All-empty rows stay m = -1e30, l = 0, o = 0."""
    m_all = m.amax(dim=0)
    w = torch.exp(m - m_all)
    return (o * w[..., None]).sum(dim=0), m_all, (l * w).sum(dim=0)


class CausalBlock(NamedTuple):
    """One block of K2's grid: batch row b, kv head kv, its query rows of
    that (b, kv) (row r is position r // g, group member r % g), the key
    tiles it walks ([0, tiles)) and, per consumer warpgroup, the first tile
    that takes the masked softmax."""

    b: int
    kv: int
    rows: range
    tiles: int
    first_masked: tuple[int, ...]


def causal_block_plan(S: int, g: int, B: int, lens, n_kv: int = 1) -> list[CausalBlock]:
    """Twin of K2's device arithmetic (csrc/causal_attention.cu), in launch
    order: block x takes batch row x // (T*n_kv) (T row tiles), within it
    row tile T - 1 - (x % (T*n_kv)) // n_kv (the heaviest first) and kv
    head x % n_kv. lens[b] is clamped to [0, S]; a block walks the tiles
    below its last row's limit min(len, s_last + 1), and a warpgroup masks
    from the tile that its first (smallest) row's limit ends in."""
    rows = S * g
    row_tiles = -(-rows // ROWS_PER_BLOCK)
    per_b = row_tiles * n_kv
    plan = []
    for x in range(B * per_b):
        b = x // per_b
        tile = row_tiles - 1 - x % per_b // n_kv
        kv = x % n_kv
        n = min(max(int(lens[b]), 0), S)
        row0 = tile * ROWS_PER_BLOCK
        last = min(row0 + ROWS_PER_BLOCK, rows) - 1
        tiles = -(-min(n, last // g + 1) // KEYS_PER_TILE)
        first_masked = []
        for first in range(row0, row0 + ROWS_PER_BLOCK, ROWS_PER_WARPGROUP):
            mask_from = min(n, first // g + 1) if first < rows else n
            first_masked.append(mask_from // KEYS_PER_TILE)
        plan.append(CausalBlock(b, kv, range(row0, last + 1), tiles, tuple(first_masked)))
    return plan


def flash_prefix_attention_parts(q, prefix_k, prefix_v, prefix_len):
    """K1. q [B, S, n_heads, hd] post-RoPE and unscaled; prefix_k/v
    [Sp, n_kv, hd]; prefix_len a 0-dim int32 tensor on q's device."""
    if q.device.type == "cpu":
        return prefix_attention_parts_plain(q, prefix_k, prefix_v, prefix_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefix_attention_parts: no kernel for {q.device}")
    B, S, n_heads, hd = q.shape
    Sp, n_kv, _ = prefix_k.shape
    _check_cuda("flash_prefix_attention_parts", q, (prefix_k, prefix_v), n_kv,
                prefix_len, ())
    if tuple(prefix_v.shape) != tuple(prefix_k.shape) or prefix_k.shape[2] != hd:
        raise ValueError("flash_prefix_attention_parts: prefix k/v shapes differ")
    g = n_heads // n_kv
    _check_tiling("prefix_attention", "k8s_flash_prefix_tiling",
                  "flash_prefix_attention_parts")
    o, m, l = _outputs(B, S, n_kv, g, hd, q.device)
    splits, per = kv_splits(B * S * g, n_kv, Sp, hd, kernels.sm_count(q.device))
    ws = (
        torch.empty(splits * B * S * n_heads * (hd + 2), dtype=torch.float32,
                    device=q.device)
        if splits > 1 else None
    )
    with torch.cuda.device(q.device):  # launch on q's card
        rc = _entry("prefix_attention", "k8s_flash_prefix_parts", 8, 8)(
            *map(kernels.ptr, (q, prefix_k, prefix_v, prefix_len, o, m, l, ws)),
            B, S, n_kv, g, Sp, hd, splits, per,
            ctypes.c_float(hd**-0.5), kernels.stream(q.device),
        )
    _raise_on(rc, "flash_prefix_attention_parts")
    flash_prefix_attention_parts.launches += 1
    return o, m, l


def flash_causal_attention_parts(q, k, v, lens):
    """K2. q [B, S, n_heads, hd] post-RoPE and unscaled; k/v
    [B, S, n_kv, hd]; lens [B] int32 on q's device."""
    if q.device.type == "cpu":
        return causal_attention_parts_plain(q, k, v, lens)
    if q.device.type != "cuda":
        raise ValueError(f"flash_causal_attention_parts: no kernel for {q.device}")
    B, S, n_heads, hd = q.shape
    n_kv = k.shape[2]
    _check_cuda("flash_causal_attention_parts", q, (k, v), n_kv, lens, (B,))
    if tuple(k.shape) != (B, S, n_kv, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError("flash_causal_attention_parts: k/v must be [B, S, n_kv, hd]")
    g = n_heads // n_kv
    _check_tiling("causal_attention", "k8s_flash_causal_tiling",
                  "flash_causal_attention_parts")
    o, m, l = _outputs(B, S, n_kv, g, hd, q.device)
    with torch.cuda.device(q.device):  # launch on q's card
        rc = _entry("causal_attention", "k8s_flash_causal_parts", 7, 5)(
            *map(kernels.ptr, (q, k, v, lens, o, m, l)),
            B, S, n_kv, g, hd, ctypes.c_float(hd**-0.5), kernels.stream(q.device),
        )
    _raise_on(rc, "flash_causal_attention_parts")
    flash_causal_attention_parts.launches += 1
    return o, m, l


flash_prefix_attention_parts.launches = 0
flash_causal_attention_parts.launches = 0


def reset_launch_counts() -> None:
    flash_prefix_attention_parts.launches = 0
    flash_causal_attention_parts.launches = 0
