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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from k8s_llm_scheduler_tpu_torch.ops import kernels

BM = 64  # rows per M-tile: work is done for whole tiles up to `total`
_BN, _BK = 128, 64  # the kernel's column tile and K step


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


def k_splits(N: int, K: int, sm_count: int) -> tuple[int, int]:
    """(splits, k_per_split) of K over blocks: a weight with fewer 128-column
    tiles than the card has SMs splits K so that the blocks fill the SMs
    once; k_per_split is a whole number of the kernel's K steps."""
    n_tiles = -(-N // _BN)
    k_steps = max(1, -(-K // _BK))
    splits = 1 if n_tiles >= sm_count else min(k_steps, sm_count // n_tiles)
    per = -(-k_steps // splits)
    return -(-k_steps // per), per * _BK


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
    if rc != 0:
        raise RuntimeError(f"ragged_matmul: kernel launch failed with CUDA error {rc}")
    ragged_matmul.launches += 1
    return out


ragged_matmul.launches = 0
