"""Weights from the JAX package's parameter pytree, through numpy.

Both packages keep one layout (models/llama.py), so conversion is a tensor
per leaf: the caller hands over the JAX `init_params` tree as numpy arrays
(`jax.tree_util.tree_map(np.asarray, params)`), and the port computes with
exactly the same weights. bf16 leaves arrive as numpy's extension dtype
`bfloat16`; they are moved bit for bit. An int8 weight pair (models/quant.py)
keeps its types: `q` stays int8 and `scale` f32 whatever `dtype` asks.
"""

from __future__ import annotations

import numpy as np
import torch

from k8s_llm_scheduler_tpu_torch.device import resolve_device
from k8s_llm_scheduler_tpu_torch.models.quant import is_quantized


def _to_tensor(arr, device: torch.device, dtype: torch.dtype | None):
    arr = np.array(arr)  # a writable copy: the port never aliases the source
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(
    np_params: dict,
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = None,
) -> dict:
    """The port's params dict from a numpy copy of the JAX params pytree.
    `dtype` casts every floating leaf (None keeps each leaf's own) except
    an int8 pair's f32 scale."""
    dev = resolve_device(device)

    def walk(node):
        if is_quantized(node):
            return {k: _to_tensor(v, dev, None) for k, v in node.items()}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _to_tensor(node, dev, dtype)

    return walk(np_params)
