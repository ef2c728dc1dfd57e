"""Weight-only int8 quantization for the decision model (the port of the JAX
package's models/quant.py).

Llama-3.1-8B in bf16 is ~16 GB of weights; per-channel int8 halves that and
halves the weight bytes every decode step reads. Activations stay bf16.

Scheme: symmetric per-output-channel. For a stacked weight [L, in, out]:
    scale[L, 1, out] = max(|w|) over `in` / 127   (f32, floored at 1e-12)
    q[L, in, out]    = clip(round(w / scale), -127, 127)  (int8)
A quantized weight is the pair {"q": int8, "scale": f32}; models/llama.py
dispatches on that form (`_dense` on the plain path, the ragged-M kernel
K3 in block decode). torch.round and jnp.round both round half to even, so
both packages quantize a weight to the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from k8s_llm_scheduler_tpu_torch.device import resolve_device

Params = dict

# Dense weight leaves that quantize (stacked [L, in, out]).
QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_INV_127 = float(np.float32(1.0 / 127.0))  # 1/127 rounded to f32, as XLA folds it


def quantize_weight(w: torch.Tensor, reciprocal: bool = False) -> dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of [..., in, out].
    A stacked weight is quantized one leading slice at a time, so the f32
    transient is one layer's matrix. `reciprocal` computes the scale as
    max * f32(1/127), as XLA compiles the JAX package's jitted quantization
    (its HF loader's); the default divides by 127, as the JAX function does
    run eagerly. The two differ in the last bit of some scales."""
    if w.dim() > 2:
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scale = torch.empty(
            (*w.shape[:-2], 1, w.shape[-1]), dtype=torch.float32, device=w.device
        )
        for i in range(w.shape[0]):
            part = quantize_weight(w[i], reciprocal)
            q[i], scale[i] = part["q"], part["scale"]
        return {"q": q, "scale": scale}
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = amax * _INV_127 if reciprocal else amax / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def quantize_params(params: Params) -> Params:
    """Quantize the transformer's dense weights; embed, norms and the LM
    head stay as they are. Returns a new params dict and leaves the given
    one untouched. It works one stacked weight at a time, so a caller that
    drops its bf16 params after the call never holds a second model."""
    out = dict(params)
    layers = dict(params["layers"])
    for key in QUANT_KEYS:
        layers[key] = quantize_weight(layers[key])
    out["layers"] = layers
    return out


def init_params_int8_host(
    rng_seed: int, cfg, device: str | torch.device = "cuda"
) -> Params:
    """A random int8-quantized model drawn and quantized on the host with
    numpy, so the bf16 weights never exist on the device. numpy's
    `default_rng(rng_seed)` draws in the JAX package's order (embed, then
    wq, wk, wv, wo, w_gate, w_up, w_down layer by layer, then the untied LM
    head), so both packages build bit-identical models from one seed."""
    dev = resolve_device(device)
    rng = np.random.default_rng(rng_seed)
    hd = cfg.head_dim
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff

    def host_quant(shape, in_dim):
        scale_init = in_dim**-0.5
        qs, ss = [], []
        for _ in range(shape[0]):  # one layer slice at a time
            w = rng.standard_normal(shape[1:], dtype=np.float32) * scale_init
            s = np.maximum(np.abs(w).max(axis=-2, keepdims=True) / 127.0, 1e-12)
            qs.append(np.clip(np.round(w / s), -127, 127).astype(np.int8))
            ss.append(s.astype(np.float32))
        return {
            "q": torch.from_numpy(np.stack(qs)).to(dev),
            "scale": torch.from_numpy(np.stack(ss)).to(dev),
        }

    def norm(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    embed = rng.standard_normal((cfg.vocab_size, D), dtype=np.float32) * 0.02
    params: Params = {
        "embed": torch.from_numpy(embed).to(cfg.dtype).to(dev),
        "final_norm": norm((D,)),
        "layers": {
            "attn_norm": norm((L, D)),
            "wq": host_quant((L, D, cfg.n_heads * hd), D),
            "wk": host_quant((L, D, cfg.n_kv_heads * hd), D),
            "wv": host_quant((L, D, cfg.n_kv_heads * hd), D),
            "wo": host_quant((L, cfg.n_heads * hd, D), cfg.n_heads * hd),
            "mlp_norm": norm((L, D)),
            "w_gate": host_quant((L, D, F), D),
            "w_up": host_quant((L, D, F), D),
            "w_down": host_quant((L, F, D), F),
        },
    }
    if not cfg.tie_embeddings:
        lm = rng.standard_normal((D, cfg.vocab_size), dtype=np.float32) * D**-0.5
        params["lm_head"] = torch.from_numpy(lm).to(cfg.dtype).to(dev)
    return params


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w and "scale" in w


def param_bytes(params: Params) -> int:
    """Bytes of every tensor in a (possibly quantized) params dict."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
