"""Builds the hand-written CUDA kernels in csrc/ and loads them with ctypes.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into its
own shared library with a plain C interface, at first use, into `_build/`
beside this package (git ignores it). A library's file name carries a hash
of its sources and flags, so an edited kernel is rebuilt and a stale one is
never loaded. `build_all()` starts one `nvcc` per source at once.

Nothing here runs when the module is imported: the CPU tests import every
module on a machine with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = (
    "prefix_attention", "causal_attention", "ragged_matmul", "paged_attention", "graph_cond",
)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc",
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from csrc/ at first use"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every missing library, all `nvcc` runs in parallel. Returns
    {name: ptxas report} for the libraries built by this call (register
    and shared-memory use per kernel); raises with nvcc's output if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        reports[name] = log
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return reports


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address as a ctypes pointer (None: a null pointer)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `device`, where every kernel launches."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.cache
def sm_count(device) -> int:
    """Streaming multiprocessors of `device`: the wave a grid should fill."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
