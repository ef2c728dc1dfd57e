"""Device selection for the port's entry points.

Every entry point takes an explicit `device` that defaults to "cuda". A
caller that wants the CPU asks for it; a missing GPU is an error, never a
silent move to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device for `device`; raises if it names CUDA and no GPU is
    visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run on the CPU"
        )
    return dev
