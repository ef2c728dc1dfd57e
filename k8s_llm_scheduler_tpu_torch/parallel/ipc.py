"""How one tp rank's block of a `d2d` prefix-KV page set reaches the same
rank of another tp group, a process of its own, without passing through
the driver, the control channel or a collective (fleet/kvplane/pages.py,
parallel/launch.export_kv_blocks / adopt_kv_blocks).

A handle is a small picklable dict. `share` makes one for a tensor the
exporting rank keeps alive in its export table; `copy_shared` copies the
blocks that handles name into tensors of the adopting rank's own, then
lets go of them; `discard` undoes what `share` made once the export is
released.

- On a card: a CUDA IPC memory handle of the tensor's allocation and the
  tensor's offset in it, through the CUDA driver API (ctypes over
  libcuda). The adopting rank opens each allocation once, copies device to
  device, synchronises and closes it. The exporting rank's export table
  owns the memory until the release; nothing else counts references (so a
  handle that is never opened leaks nothing). A process cannot open a
  handle it made: a rank adopting its own group's export reads its table.
- On the CPU: the block copied into a file under the exporting group's
  scratch directory, which the adopting rank maps read-only and copies.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os

import torch

# cuIpcOpenMemHandle's flag: map with peer access enabled lazily
_LAZY_ENABLE_PEER_ACCESS = 1


class _IpcMemHandle(ctypes.Structure):
    _fields_ = [("reserved", ctypes.c_ubyte * 64)]


def share(t: torch.Tensor, path: str) -> dict:
    """A handle to `t` (contiguous) that another process can open: its CUDA
    allocation's IPC handle on a card, else a copy of it in a new file at
    `path`. The caller keeps `t` alive until it releases the handle."""
    if not t.is_contiguous():
        raise ValueError("a shared block must be contiguous")
    meta = {"shape": tuple(t.shape), "dtype": str(t.dtype), "nbytes": t.numel() * t.element_size()}
    if t.is_cuda:
        cu = _driver()
        base, size = ctypes.c_uint64(), ctypes.c_size_t()
        _check(cu.cuMemGetAddressRange_v2(ctypes.byref(base), ctypes.byref(size), t.data_ptr()),
               "cuMemGetAddressRange")
        handle = _IpcMemHandle()
        _check(cu.cuIpcGetMemHandle(ctypes.byref(handle), base.value), "cuIpcGetMemHandle")
        return {"kind": "cuda", "handle": bytes(handle.reserved),
                "offset": t.data_ptr() - base.value, **meta}
    out = torch.from_file(path, shared=True, size=t.numel(), dtype=t.dtype)
    out.copy_(t.reshape(-1))
    del out  # unmapped: the file holds the block
    return {"kind": "file", "path": path, **meta}


def copy_shared(handles: list[dict], outs: list[torch.Tensor]) -> None:
    """Copy the block each handle names into the tensor beside it (this
    process's own, contiguous, of the block's shape and dtype), then let go
    of every block. Raises when a block cannot be opened or its shape,
    dtype or size differs from its tensor's."""
    for h, out in zip(handles, outs):
        if (tuple(out.shape) != tuple(h["shape"]) or str(out.dtype) != h["dtype"]
                or not out.is_contiguous()):
            raise ValueError(f"a shared block {h['shape']} {h['dtype']} cannot land in "
                             f"{tuple(out.shape)} {out.dtype}")
    if handles and handles[0]["kind"] == "cuda":
        _copy_cuda(handles, outs)
        return
    for h, out in zip(handles, outs):
        size = os.path.getsize(h["path"])
        if size != h["nbytes"]:
            raise OSError(f"{h['path']} holds {size} bytes, not the block's {h['nbytes']}")
        src = torch.from_file(h["path"], shared=False, size=out.numel(), dtype=out.dtype)
        out.view(-1).copy_(src)
        del src


def discard(handle: dict) -> None:
    """Undo what share made for `handle` (its file on the CPU; nothing on a
    card, where the export table's tensor is the block)."""
    if handle["kind"] == "file":
        with contextlib.suppress(FileNotFoundError):
            os.unlink(handle["path"])


def _copy_cuda(handles: list[dict], outs: list[torch.Tensor]) -> None:
    cu = _driver()
    # the tensors are allocated and idle, and this thread's context current
    torch.cuda.synchronize(outs[0].device)
    opened: dict[bytes, int] = {}  # an allocation is opened once a process
    try:
        for h, out in zip(handles, outs):
            raw = h["handle"]
            if raw not in opened:
                ptr = ctypes.c_uint64()
                _check(cu.cuIpcOpenMemHandle_v2(ctypes.byref(ptr),
                                                _IpcMemHandle.from_buffer_copy(raw),
                                                _LAZY_ENABLE_PEER_ACCESS), "cuIpcOpenMemHandle")
                opened[raw] = ptr.value
            _check(cu.cuMemcpyDtoD_v2(out.data_ptr(), opened[raw] + h["offset"], h["nbytes"]),
                   "cuMemcpyDtoD")
        _check(cu.cuCtxSynchronize(), "cuCtxSynchronize")
    finally:
        for ptr in opened.values():
            cu.cuIpcCloseMemHandle(ptr)


@functools.cache
def _driver():
    """libcuda, with the signatures this module calls."""
    cu = ctypes.CDLL("libcuda.so.1")
    ptr, size, res = ctypes.c_uint64, ctypes.c_size_t, ctypes.c_int
    sigs = {
        "cuMemGetAddressRange_v2": [ctypes.POINTER(ptr), ctypes.POINTER(size), ptr],
        "cuIpcGetMemHandle": [ctypes.POINTER(_IpcMemHandle), ptr],
        "cuIpcOpenMemHandle_v2": [ctypes.POINTER(ptr), _IpcMemHandle, ctypes.c_uint],
        "cuIpcCloseMemHandle": [ptr],
        "cuMemcpyDtoD_v2": [ptr, ptr, size],
        "cuCtxSynchronize": [],
        "cuGetErrorString": [res, ctypes.POINTER(ctypes.c_char_p)],
    }
    for name, argtypes in sigs.items():
        fn = getattr(cu, name)
        fn.argtypes, fn.restype = argtypes, res
    return cu


def _check(result: int, what: str) -> None:
    if result != 0:
        msg = ctypes.c_char_p()
        _driver().cuGetErrorString(result, ctypes.byref(msg))
        raise RuntimeError(f"{what} failed: CUDA error {result} "
                           f"({(msg.value or b'unknown').decode()})")
