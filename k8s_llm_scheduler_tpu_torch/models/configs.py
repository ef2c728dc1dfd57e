"""Llama model-family configurations (the port's copy of models/configs.py).

The same public architecture hyperparameters as the JAX package's configs,
with a torch dtype in place of the jnp one: TINY and SMALL for tests, and
the Llama-3.2-1B, Llama-3.1-8B and Llama-3.3-70B checkpoint shapes.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3.x rope frequency scaling (the "llama3" scheme)."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    name: str
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rope_scaling: RopeScaling | None = None
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def __post_init__(self) -> None:
        if self.d_model % self.n_heads or self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"{self.name}: d_model {self.d_model}, n_heads {self.n_heads} "
                f"and n_kv_heads {self.n_kv_heads} do not divide"
            )


TINY = LlamaConfig(
    name="tiny",
    vocab_size=512,          # byte tokenizer fits in 512
    d_model=256,
    n_layers=4,
    n_heads=4,
    n_kv_heads=2,            # exercises GQA
    d_ff=512,
    max_seq_len=2048,
    rope_theta=10000.0,
    rope_scaling=None,
    tie_embeddings=True,
)

SMALL = LlamaConfig(
    name="small",
    vocab_size=512,
    d_model=1024,
    n_layers=8,
    n_heads=8,
    n_kv_heads=4,
    d_ff=2816,
    max_seq_len=8192,
    rope_theta=500000.0,
    tie_embeddings=True,
)

LLAMA_3_2_1B = LlamaConfig(
    name="llama-3.2-1b-instruct",
    vocab_size=128256,
    d_model=2048,
    n_layers=16,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    max_seq_len=131072,
    rope_theta=500000.0,
    rope_scaling=RopeScaling(factor=32.0),
    tie_embeddings=True,
)

LLAMA_3_1_8B = LlamaConfig(
    name="llama-3.1-8b-instruct",
    vocab_size=128256,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    max_seq_len=131072,
    rope_theta=500000.0,
    rope_scaling=RopeScaling(factor=8.0),
)

LLAMA_3_3_70B = LlamaConfig(
    name="llama-3.3-70b-instruct",
    vocab_size=128256,
    d_model=8192,
    n_layers=80,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    max_seq_len=131072,
    rope_theta=500000.0,
    rope_scaling=RopeScaling(factor=8.0),
)

_REGISTRY = {
    c.name: c for c in (TINY, SMALL, LLAMA_3_2_1B, LLAMA_3_1_8B, LLAMA_3_3_70B)
}


def get_config(name: str) -> LlamaConfig:
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown model config {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]
