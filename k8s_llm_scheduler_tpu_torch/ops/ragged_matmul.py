"""Ragged-M matmul of block decode: K3, a hand-written CUDA kernel, with its
plain twin (the port of the JAX package's ops/ragged_matmul.py).

Block decode compacts each iteration's valid tokens to the front of the
flattened [R*F, D] activation (models/llama.forward_block_decode with
ragged=True); every projection and MLP matmul then runs here with the
valid-token count `total`, a 0-dim int32 tensor on the device:

    out[:ceil(total/64)*64] = x @ w   (f32 accumulation, one rounding)
    out[ceil(total/64)*64:] = 0

`w` is a bf16 [K, N] matrix or an int8 pair {"q": int8 [K, N], "scale":
f32 [1, N]} (models/quant.py). x is cast to the weight's compute dtype
(bf16 for an int8 pair), the per-output-channel scale multiplies the f32
result, and the output takes x's dtype.

`ragged_matmul` dispatches on where x lies: on the CPU it computes the
plain version; on a CUDA tensor it launches the kernel
(csrc/ragged_matmul.cu) or raises. `total` is never read on the host. Every
launch adds one to `ragged_matmul.launches`.

The kernel is a Hopper weight stream (TMA ring, swap-AB wgmma). What it does
beyond the product has plain twins here, which the CPU tests hold against
`ragged_matmul_plain` and the JAX package's Pallas kernel: the order in which
an int8 weight's columns land in the accumulator (`fragment_columns`), the
split of K over blocks (`k_splits`, `split_parts_plain`) and the fixed-order
sum of the splits with the epilogue that undoes the column order
(`combine_parts_plain`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from k8s_llm_scheduler_tpu_torch.ops import kernels

BM = 64  # rows per M-tile: work is done for whole tiles up to `total`
# K3's tiling (csrc/ragged_matmul.cu kBN, kBK, kRowTile, kMaxRows,
# kMaxSplits, kRingBytes, kSmemBytes): weight columns per block, K per ring
# stage (the unit of a K split), rows per x tile and per pass over the
# weights, the most K splits of one column tile, the bytes of the block's
# ring of stages (at most MAX_STAGES) and its dynamic shared memory (the ring
# aligned to 1 KB, and a full and an empty barrier per stage). The wrapper
# checks them against the built kernel's before its first launch.
COLS_PER_BLOCK = 128
K_STEP = 64
MAX_ROWS = 192
MAX_SPLITS = 16
RING_BYTES = 224 * 1024
MAX_STAGES = 16
SMEM_BYTES = RING_BYTES + 1024 + 2 * MAX_STAGES * 8


def _pair(w):
    """(matrix, scale or None) of a bf16 weight or an int8 pair."""
    if isinstance(w, dict):
        return w["q"], w["scale"]
    return w, None


def ragged_matmul_plain(x: torch.Tensor, w, total: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K3: the full product in f32 from operands in the
    weight's compute dtype, times the scale, cast to x's dtype; rows from
    ceil(total/64)*64 on are zeroed with a device mask (no host sync)."""
    mat, scale = _pair(w)
    compute = torch.bfloat16 if scale is not None else mat.dtype
    out = x.to(compute).float() @ mat.to(compute).float()
    if scale is not None:
        out = out * scale.reshape(1, -1)
    rows = torch.arange(x.shape[0], device=x.device)
    keep = rows < (torch.clamp(total, min=0) + BM - 1) // BM * BM
    return torch.where(keep[:, None], out, 0.0).to(x.dtype)


@functools.cache
def _entry():
    fn = kernels.library("ragged_matmul").k8s_ragged_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


@functools.cache
def _check_tiling() -> None:
    """Raises unless the built K3 tiles as the constants above say, which
    the split plan and the twins assume."""
    fn = kernels.library("ragged_matmul").k8s_ragged_tiling
    fn.restype = None
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 7
    got = [ctypes.c_int() for _ in range(7)]
    fn(*map(ctypes.byref, got))
    want = (COLS_PER_BLOCK, K_STEP, BM, MAX_ROWS, MAX_SPLITS, RING_BYTES, SMEM_BYTES)
    if tuple(v.value for v in got) != want:
        raise RuntimeError(
            f"ragged_matmul: the kernel tiles {[v.value for v in got]}, the split "
            f"plan (columns, K step, row tile, rows per pass, splits, ring and "
            f"shared-memory bytes) {list(want)}"
        )


def k_splits(N: int, K: int, sm_count: int) -> tuple[int, int]:
    """(splits, k_per_split) of K over blocks: a weight with fewer column
    tiles than the card has SMs splits K so that the blocks fill the SMs
    once, in at most MAX_SPLITS splits; k_per_split is a whole number of the
    kernel's K steps, and no split starts past K."""
    n_tiles = -(-N // COLS_PER_BLOCK)
    k_steps = max(1, -(-K // K_STEP))
    splits = 1 if n_tiles >= sm_count else min(k_steps, sm_count // n_tiles, MAX_SPLITS)
    per = -(-k_steps // splits)
    return -(-k_steps // per), per * K_STEP


def fragment_columns(N: int) -> torch.Tensor:
    """The weight column behind each accumulator row of the kernel for an
    int8 weight: `ldmatrix.trans` hands each lane two neighbouring columns,
    so in every 16 the rows hold columns 0, 2, .., 14, then 1, 3, .., 15.
    (A bf16 weight's rows hold the columns in order.)"""
    i = torch.arange(N)
    r = i % 16
    return i - r + 2 * (r % 8) + r // 8


def split_parts_plain(x, w, total, splits: int, k_per_split: int) -> torch.Tensor:
    """Twin of the kernel's main loop: for each K split, the f32 product of
    its K range in swapped form, w^T x^T, with an int8 weight's columns in
    `fragment_columns` order; [splits, N, M], computed rows only (the rest
    zero), unscaled."""
    mat, scale = _pair(w)
    M, K = x.shape
    N = mat.shape[1]
    cols = fragment_columns(N).to(x.device) if scale is not None else torch.arange(N)
    compute = torch.bfloat16 if scale is not None else mat.dtype
    wt = mat.to(compute).float().t()[cols]  # [N, K], accumulator row order
    xt = x.to(compute).float().t()  # [K, M]
    rows = torch.arange(M, device=x.device) < _active_rows(total, M)
    parts = []
    for s in range(splits):
        k0, k1 = s * k_per_split, min(K, (s + 1) * k_per_split)
        parts.append(torch.where(rows[None, :], wt[:, k0:k1] @ xt[k0:k1], 0.0))
    return torch.stack(parts)


def combine_parts_plain(parts: torch.Tensor, w, total) -> torch.Tensor:
    """Twin of the split sum and the epilogue: the splits' partials summed in
    split order, the scale of each accumulator row's own column applied,
    the column order undone, rounded once to bf16; rows from
    ceil(total/64)*64 on exactly zero. Returns [M, N]."""
    _, scale = _pair(w)
    N, M = parts.shape[1:]
    acc = parts[0].clone()
    for p in parts[1:]:
        acc = acc + p
    if scale is not None:
        cols = fragment_columns(N).to(parts.device)
        acc = acc * scale.reshape(-1)[cols][:, None]
        acc = torch.empty_like(acc).index_copy_(0, cols, acc)  # undo the order
    rows = torch.arange(M, device=parts.device) < _active_rows(total, M)
    return torch.where(rows[:, None], acc.t(), 0.0).to(torch.bfloat16)


def _active_rows(total, M: int):
    """The rows the kernel computes: whole 64-row tiles up to `total`."""
    return (torch.clamp(total, 0, M) + BM - 1) // BM * BM


def _check_cuda(x, mat, scale, total):
    name = "ragged_matmul"
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bf16 activations, got {x.dtype}")
    if x.dim() != 2 or mat.dim() != 2 or x.shape[1] != mat.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} @ {tuple(mat.shape)}")
    want = torch.int8 if scale is not None else torch.bfloat16
    if mat.dtype != want:
        raise ValueError(f"{name}: weight must be bf16 or an int8 pair, got {mat.dtype}")
    K, N = mat.shape
    if K % 8 or N % (16 if scale is not None else 8):
        raise ValueError(f"{name}: K={K} and N={N} must be multiples of 8 (N of 16 for int8)")
    tensors = [x, mat] + ([scale] if scale is not None else [])
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel takes contiguous 16-byte aligned tensors")
    if scale is not None and (scale.dtype != torch.float32 or scale.numel() != N):
        raise ValueError(f"{name}: scale must be f32 [1, {N}]")
    if total.device != x.device or total.dtype != torch.int32 or total.dim() != 0:
        raise ValueError(
            f"{name}: total must be a 0-dim int32 tensor on {x.device}, got "
            f"{total.dtype} {tuple(total.shape)} on {total.device}"
        )


def ragged_matmul(x: torch.Tensor, w, total: torch.Tensor) -> torch.Tensor:
    """K3. x [M, K] with the valid rows compacted to the front; w a bf16
    [K, N] matrix or an int8 pair; total a 0-dim int32 tensor on x's
    device. Returns [M, N] in x's dtype."""
    if x.device.type == "cpu":
        return ragged_matmul_plain(x, w, total)
    if x.device.type != "cuda":
        raise ValueError(f"ragged_matmul: no kernel for {x.device}")
    mat, scale = _pair(w)
    _check_cuda(x, mat, scale, total)
    _check_tiling()
    M, K = x.shape
    N = mat.shape[1]
    splits, k_per_split = k_splits(N, K, kernels.sm_count(x.device))
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    part = (
        torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
        if splits > 1 else None
    )
    with torch.cuda.device(x.device):  # launch on x's card
        rc = _entry()(
            *map(kernels.ptr, (x, mat, scale, total, out, part)),
            M, N, K, splits, k_per_split, int(scale is not None),
            kernels.stream(x.device),
        )
    if rc == -2:
        raise RuntimeError("ragged_matmul: the TMA tensor maps cannot be encoded")
    if rc == -3:
        raise RuntimeError("ragged_matmul: the split plan is not whole K steps within MAX_SPLITS")
    if rc != 0:
        raise RuntimeError(f"ragged_matmul: kernel launch failed with CUDA error {rc}")
    ragged_matmul.launches += 1
    return out


ragged_matmul.launches = 0
