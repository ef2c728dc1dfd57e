"""Llama 3.x in PyTorch for the decision path: RMSNorm, RoPE, GQA, SwiGLU.

The port of the JAX package's models/llama.py, keeping its parameter layout
so weights convert one to one (models/convert.py): a dict with `embed`
[V, D], `final_norm` [D], optional `lm_head` [D, V], and `layers` holding
STACKED [L, ...] tensors (attn_norm, wq, wk, wv, wo, mlp_norm, w_gate, w_up,
w_down; projections stored [in, out]). A forward walks the layers in a
Python loop over views of the stacks.

Entry points: `forward_prefill` (single-shot prefix prefill, KV-only mode
too); the cascade suffix prefills `forward_prefill_suffix_dense` (decision
waves) and `forward_prefill_suffix` (KV into pages, the general path); the packed
block-diagonal chunk of the admission plane `forward_prefill_packed`;
`forward_block_decode` (decision waves; `ragged=True` runs every projection
and MLP matmul through K3); and the paged decode steps
`forward_decode_buffered` (the general path's chunked decode; own-token
attention through K4 with own_impl="pallas") and `forward_decode` (the
manual-page API; K4 normalized with paged_attn="pallas"). The hidden-transfer
head of the draft-free speculative arm (`init_hidden_transfer`,
`hidden_transfer_hidden`, `hidden_transfer_logits`) turns a final-layer
hidden state into proposals for the next tokens. bf16 weights and
activations, or int8 weight pairs (models/quant.py); norms, RoPE, softmax
and the LM head accumulate in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from k8s_llm_scheduler_tpu_torch.device import resolve_device
from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig
from k8s_llm_scheduler_tpu_torch.ops.attention import (
    attend_part,
    causal_prefill_attention,
    chunk_attention_with_prefix,
    merge_attention_parts,
    paged_decode_attention,
)
from k8s_llm_scheduler_tpu_torch.ops.paged_attention import (
    paged_decode_attention as paged_decode_attention_kernel,
    paged_decode_attention_parts,
)
from k8s_llm_scheduler_tpu_torch.ops.prefix_attention import (
    flash_prefix_attention_parts,
)
from k8s_llm_scheduler_tpu_torch.ops.ragged_matmul import ragged_matmul

Params = dict

LAYER_KEYS = (
    "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down",
)


# --------------------------------------------------------------------- norm
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, result back in the input dtype, times the weight."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * weight


# --------------------------------------------------------------------- rope
def rope_inv_freq(cfg: LlamaConfig, device=None) -> torch.Tensor:
    """Inverse RoPE frequencies (f32) with optional llama3 scaling."""
    hd = cfg.head_dim
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    inv = 1.0 / (cfg.rope_theta ** exps)
    s = cfg.rope_scaling
    if s is None:
        return inv
    # llama3 scheme: low-freq bands divided by factor, high-freq kept,
    # smooth interpolation in between.
    wavelen = 2.0 * math.pi / inv
    low_wl = s.original_max_position / s.low_freq_factor
    high_wl = s.original_max_position / s.high_freq_factor
    smooth = (s.original_max_position / wavelen - s.low_freq_factor) / (
        s.high_freq_factor - s.low_freq_factor
    )
    smooth = smooth.clamp(0.0, 1.0)
    return torch.where(
        wavelen > low_wl,
        inv / s.factor,
        torch.where(
            wavelen < high_wl, inv, (1 - smooth) * inv / s.factor + smooth * inv
        ),
    )


def apply_rope(
    x: torch.Tensor,  # [..., n_heads, head_dim]
    positions: torch.Tensor,  # broadcastable to x's leading dims
    inv_freq: torch.Tensor,  # [head_dim // 2]
) -> torch.Tensor:
    """Rotary embedding at absolute positions (half-split layout)."""
    angles = positions[..., None].float() * inv_freq
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- init
def init_params(
    cfg: LlamaConfig, seed: int = 0, device: str | torch.device = "cuda",
    shard: dict | None = None,
) -> Params:
    """Random weights from a seeded torch.Generator, allocated on `device`
    (the JAX package's init_params scheme: N(0, 0.02) embeddings, N(0,
    1/fan_in) projections, unit norms). Each stacked layer weight is filled
    one layer at a time, so the f32 transient is one layer's matrix.

    `shard` ({param name: (dim, lo, hi)}, parallel/sharding.rank_ranges)
    keeps only those blocks of the named params, for one tensor-parallel
    rank: the generator draws every number of the full tree in the same
    order, so the rank's params equal the slices of the full tree, which
    never exists."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    L, D, Fd, hd = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.head_dim
    shard = shard or {}

    def normal(name, shape, std):
        dim, lo, hi = shard.get(name, (None, 0, 0))
        kept = tuple(hi - lo if d == dim else n for d, n in enumerate(shape))
        w = torch.empty(kept, dtype=cfg.dtype, device=dev)
        for i in range(shape[0]):
            row = (
                torch.randn(shape[1:], generator=gen, dtype=torch.float32,
                            device=dev) * std
            ).to(cfg.dtype)
            if dim is None:
                w[i] = row
            elif dim == 0:
                if lo <= i < hi:
                    w[i - lo] = row
            else:
                w[i] = row.narrow(dim - 1, lo, hi - lo)
        return w

    def dense(name, shape, in_dim):
        return normal(name, shape, in_dim**-0.5)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    params: Params = {
        "embed": normal("embed", (cfg.vocab_size, D), 0.02),
        "final_norm": ones((D,)),
        "layers": {
            "attn_norm": ones((L, D)),
            "wq": dense("layers.wq", (L, D, cfg.n_heads * hd), D),
            "wk": dense("layers.wk", (L, D, cfg.n_kv_heads * hd), D),
            "wv": dense("layers.wv", (L, D, cfg.n_kv_heads * hd), D),
            "wo": dense("layers.wo", (L, cfg.n_heads * hd, D), cfg.n_heads * hd),
            "mlp_norm": ones((L, D)),
            "w_gate": dense("layers.w_gate", (L, D, Fd), D),
            "w_up": dense("layers.w_up", (L, D, Fd), D),
            "w_down": dense("layers.w_down", (L, Fd, D), Fd),
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense("lm_head", (D, cfg.vocab_size), D)
    return params


def _layer(layers: Params, i: int) -> Params:
    """Layer i's weights: views of the stacks, int8 pairs sliced per part."""
    return {
        k: {kk: vv[i] for kk, vv in layers[k].items()}
        if isinstance(layers[k], dict) else layers[k][i]
        for k in LAYER_KEYS
    }


class _MmF32(torch.autograd.Function):
    """torch.mm(x, w, out_dtype=float32) with a derivative (the op has none):
    the f32 output gradient is rounded to the operands' dtype and both
    products accumulate in f32, as a bf16 matmul's backward does."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        x2, w = ctx.saved_tensors
        g = grad.to(x2.dtype)
        grad_x = g @ w.t() if ctx.needs_input_grad[0] else None
        grad_w = x2.t() @ g if ctx.needs_input_grad[1] else None
        return grad_x, grad_w


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] with f32 accumulation AND an f32 result, from
    operands in their own dtype: casting a 128k-vocab head to f32 would be
    a multi-GB transient per call."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        out = x2 @ w.float()
    elif x.is_cuda:
        if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
            out = _MmF32.apply(x2, w)
        else:
            out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float()
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _logits(params: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """LM head (tied or untied), f32 logits; on a tp rank's config
    (engine/sharded/plane.RankConfig) the rank's vocab block, gathered."""
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    plane = getattr(cfg, "plane", None)
    if plane is None:
        return _matmul_f32(x, head)
    return plane.gather_logits(_matmul_f32(x, head))


def _embed(params: Params, cfg: LlamaConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows of `tokens`; on a tp rank's config, the plane's
    vocab-sharded lookup."""
    plane = getattr(cfg, "plane", None)
    if plane is None:
        return params["embed"][tokens]
    return plane.embed_lookup(params["embed"], tokens)


def _dense(x: torch.Tensor, w) -> torch.Tensor:
    """Dense projection x [..., in] @ w [in, out]. An int8 pair
    {"q", "scale"} (models/quant.py) computes x @ q in x's dtype, ROUNDED to
    x's dtype, then times the f32 per-channel scale and rounded again: the
    JAX package's two roundings (K3 rounds once; each path keeps its own)."""
    if isinstance(w, dict):
        out = torch.matmul(x, w["q"].to(x.dtype))
        return (out.float() * w["scale"]).to(x.dtype)
    return torch.matmul(x, w)


def _row_dense(cfg: LlamaConfig, x: torch.Tensor, w) -> torch.Tensor:
    """A row-parallel projection (wo, w_down): _dense, or on a tp rank's
    config the plane's product summed over the ranks."""
    plane = getattr(cfg, "plane", None)
    if plane is None:
        return _dense(x, w)
    return plane.row_dense(x, w)


def _mlp(lp: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    gate = _dense(h, lp["w_gate"])
    up = _dense(h, lp["w_up"])
    fused = F.silu(gate.float()).to(x.dtype) * up
    return _row_dense(cfg, fused, lp["w_down"])


def _qkv(lp, cfg, x, positions, inv_freq):
    B, S = x.shape[:2]
    hd = cfg.head_dim
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q = _dense(h, lp["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = _dense(h, lp["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = _dense(h, lp["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    return apply_rope(q, positions, inv_freq), apply_rope(k, positions, inv_freq), v


def _kv_stacks(cfg, B, S, dtype, device):
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    return (
        torch.empty(shape, dtype=dtype, device=device),
        torch.empty(shape, dtype=dtype, device=device),
    )


def _unbound_layers(layers: Params, n_layers: int) -> list[Params]:
    """Every layer's weights, as _layer gives them, from one unbind of each
    stack: the backward of unbind stacks the L layers' gradients once, where
    L selects would each add a full-size zero stack."""
    def split(w):
        if isinstance(w, dict):
            parts = {kk: vv.unbind(0) for kk, vv in w.items()}
            return [{kk: p[i] for kk, p in parts.items()} for i in range(n_layers)]
        return w.unbind(0)

    cols = {k: split(layers[k]) for k in LAYER_KEYS}
    return [{k: cols[k][i] for k in LAYER_KEYS} for i in range(n_layers)]


# ------------------------------------------------------------------ prefill
def _prefill_layer(lp, cfg, x, positions, seq_lens, inv_freq):
    """One layer of full-prompt prefill: (x_out, k, v)."""
    B, S = x.shape[:2]
    q, k, v = _qkv(lp, cfg, x, positions, inv_freq)
    attn = causal_prefill_attention(q, k, v, seq_lens)
    x = x + _row_dense(cfg, attn.reshape(B, S, -1), lp["wo"])
    return x + _mlp(lp, cfg, x), k, v


def forward_prefill(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S] int, left-aligned, padded
    seq_lens: torch.Tensor,  # [B]
    return_logits: bool = True,  # False skips the LM head (KV-only)
    remat: bool = False,  # recompute each layer in the backward (training)
    return_hidden: bool = False,  # also return the final-layer residual
):
    """Full-prompt forward pass: (logits [B, S, V] f32 or None,
    k_all [L, B, S, n_kv, hd], v_all), and with `return_hidden` the
    final-layer residual stream before the final norm, [B, S, D], as a
    fourth value (hidden-transfer head training).

    Differentiable in `params` where they require grad (train/train_step.py).
    `remat=True` runs each layer under torch.utils.checkpoint, so the
    backward recomputes a layer's activations instead of keeping all L
    layers' live (the JAX package's jax.checkpoint of the scanned layer).
    The KV stacks hold detached copies: they are outputs for the engine,
    never part of a gradient. The default arguments compute what serving
    has always computed."""
    B, S = tokens.shape
    dev = tokens.device
    inv_freq = rope_inv_freq(cfg, dev)
    positions = torch.arange(S, device=dev).expand(B, S)
    x = _embed(params, cfg, tokens)
    k_all, v_all = _kv_stacks(cfg, B, S, x.dtype, dev)
    for i, lp in enumerate(_unbound_layers(params["layers"], cfg.n_layers)):
        if remat:
            x, k, v = checkpoint(_prefill_layer, lp, cfg, x, positions, seq_lens,
                                 inv_freq, use_reentrant=False)
        else:
            x, k, v = _prefill_layer(lp, cfg, x, positions, seq_lens, inv_freq)
        k_all[i], v_all[i] = k.detach(), v.detach()
    logits = _logits(params, cfg, x) if return_logits else None
    if return_hidden:
        return logits, k_all, v_all, x
    return logits, k_all, v_all


# ------------------------------------------------- suffix prefill (cascade)
def _suffix_layer(
    lp, cfg, x, positions, suffix_lens, pk, pv, prefix_len, inv_freq
):
    """One layer of cascade suffix prefill: attends the shared dense prefix
    (K1) and causally within the suffix (K2). Returns (x_out, k, v)."""
    B, S = x.shape[:2]
    q, k, v = _qkv(lp, cfg, x, positions, inv_freq)
    attn = chunk_attention_with_prefix(q, k, v, suffix_lens, pk, pv, prefix_len)
    x = x + _row_dense(cfg, attn.reshape(B, S, -1), lp["wo"])
    x = x + _mlp(lp, cfg, x)
    return x, k, v


def _last_valid_logits(params, cfg, x, lens):
    """Logits at each row's final valid token ([B, S, D], [B] -> [B, V]);
    rows with len 0 read position 0."""
    last_idx = torch.clamp(lens.long() - 1, min=0)
    x_last = x[torch.arange(x.shape[0], device=x.device), last_idx]
    return _logits(params, cfg, x_last)


@torch.no_grad()
def forward_prefill_suffix_dense(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, Ss] int — per-request suffix, left-aligned
    suffix_lens: torch.Tensor,  # [B] int32 valid suffix tokens (0 = unused)
    prefix_k_all: torch.Tensor,  # [L, Sp, n_kv, hd] shared dense prefix KV
    prefix_v_all: torch.Tensor,
    prefix_len: torch.Tensor,  # 0-dim int32 on the device
    kv_out: tuple[torch.Tensor, torch.Tensor] | None = None,
):
    """Batched suffix prefill against a shared dense prefix, KV kept dense:
    (last_logits [B, V] f32, k_sfx [L, B, Ss, n_kv, hd], v_sfx). `kv_out`
    gives the buffers k_sfx and v_sfx are written into (a CUDA graph's
    static buffers), else they are allocated."""
    B, S = tokens.shape
    dev = tokens.device
    inv_freq = rope_inv_freq(cfg, dev)
    positions = prefix_len + torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
    x = _embed(params, cfg, tokens)
    k_sfx, v_sfx = kv_out if kv_out is not None else _kv_stacks(cfg, B, S, x.dtype, dev)
    for i in range(cfg.n_layers):
        x, k_sfx[i], v_sfx[i] = _suffix_layer(
            _layer(params["layers"], i), cfg, x, positions, suffix_lens,
            prefix_k_all[i], prefix_v_all[i], prefix_len, inv_freq,
        )
    return _last_valid_logits(params, cfg, x, suffix_lens), k_sfx, v_sfx


@torch.no_grad()
def forward_prefill_suffix(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, Ss] int — per-request suffix, left-aligned
    suffix_lens: torch.Tensor,  # [B] int32 valid suffix tokens (0 = unused)
    prefix_k_all: torch.Tensor,  # [L, Sp, n_kv, hd] shared dense prefix KV
    prefix_v_all: torch.Tensor,
    prefix_len: torch.Tensor,  # 0-dim int32 on the device
    k_cache: torch.Tensor,  # [L, num_pages, page_size, n_kv, hd], updated IN PLACE
    v_cache: torch.Tensor,
    page_ids: torch.Tensor,  # [B, Ss/page_size] dest page per block (0 = scratch)
):
    """Batched suffix prefill against a shared dense prefix with the suffix
    K/V scattered into the paged cache, page block by page block (padding
    blocks go to scratch page 0, whose content nothing reads).

    Returns (last_logits [B, V] f32, k_cache, v_cache)."""
    B, S = tokens.shape
    dev = tokens.device
    ps = k_cache.shape[2]
    n_blocks = S // ps
    inv_freq = rope_inv_freq(cfg, dev)
    positions = prefix_len + torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
    pages = page_ids.long()
    x = _embed(params, cfg, tokens)
    for i in range(cfg.n_layers):
        x, k, v = _suffix_layer(
            _layer(params["layers"], i), cfg, x, positions, suffix_lens,
            prefix_k_all[i], prefix_v_all[i], prefix_len, inv_freq,
        )
        shape = (B, n_blocks, ps, cfg.n_kv_heads, cfg.head_dim)
        k_cache[i][pages] = k.reshape(shape).to(k_cache.dtype)
        v_cache[i][pages] = v.reshape(shape).to(v_cache.dtype)
    return _last_valid_logits(params, cfg, x, suffix_lens), k_cache, v_cache


@torch.no_grad()
def forward_prefill_packed(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,     # [C] int — one packed chunk (pad holes)
    seg: torch.Tensor,        # [C] int — segment id per token, -1 on padding
    positions: torch.Tensor,  # [C] int — ABSOLUTE position of each token
    prefix_k_all: torch.Tensor,  # [L, Sp, n_kv, hd] shared dense prefix KV
    prefix_v_all: torch.Tensor,
    prefix_len: torch.Tensor,    # 0-dim int32 on the device
    carry_k: torch.Tensor,    # [L, CAP, n_kv, hd] pack carry, updated IN PLACE
    carry_v: torch.Tensor,
    carry_seg: torch.Tensor,  # [CAP] int32 segment per carry entry (-1 empty)
    carry_len: int,           # tokens already in the carry
    k_cache: torch.Tensor,    # [L, num_pages, page_size, n_kv, hd], IN PLACE
    v_cache: torch.Tensor,
    page_ids: torch.Tensor,   # [C] per-token dest page (0 = scratch)
    offs: torch.Tensor,       # [C] per-token dest offset within the page
    end_idx: torch.Tensor,    # [E] chunk-local indices of prompt-final tokens
):
    """One PACKED prefill chunk: many prompts in one token stream with
    BLOCK-DIAGONAL attention (the JAX package's forward_prefill_packed).

    Token i (segment s_i) attends to three parts, merged by log-sum-exp:
    - the burst-shared dense prefix (K1, every token);
    - carry entries of the SAME segment (this prompt's tokens from earlier
      chunks of the pack — how a prompt spans a chunk boundary);
    - chunk tokens j <= i of the SAME segment (causal within the prompt,
      blocked across prompts).
    The last two are plain f32 einsums (ops/attention.attend_part), as in
    the JAX package, which computes them outside any Pallas kernel.
    Padding tokens (seg -1) only match other padding. The chunk's K/V is
    scattered per token into the paged cache (each prompt's slot pages;
    padding to scratch page 0) and written into the carry at `carry_len`,
    and `carry_seg` takes the chunk's segment ids there, all IN PLACE.

    Returns end_logits [E, V] f32: the LM head runs only at `end_idx`."""
    C = tokens.shape[0]
    CAP = carry_k.shape[1]
    hd = cfg.head_dim
    dev = tokens.device
    inv_freq = rope_inv_freq(cfg, dev)
    x = _embed(params, cfg, tokens)[None]  # [1, C, D]
    pos_b = positions[None, :]
    eq = "bqkgh,bskh->bkgqs"
    # masks are layer-independent
    carry_mask = (
        (torch.arange(CAP, device=dev)[None, :] < carry_len)
        & (carry_seg[None, :] == seg[:, None])
    )[None, None, None, :, :]  # [1, 1, 1, C, CAP]
    j = torch.arange(C, device=dev)
    blk_mask = (
        (j[:, None] >= j[None, :]) & (seg[:, None] == seg[None, :])
    )[None, None, None, :, :]  # [1, 1, 1, C, C]
    pages, offsets = page_ids.long(), offs.long()
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        q, k, v = _qkv(lp, cfg, x, pos_b, inv_freq)
        qg = (q.float() * hd**-0.5).reshape(1, C, cfg.n_kv_heads, cfg.q_per_kv, hd)
        parts = [
            flash_prefix_attention_parts(q, prefix_k_all[i], prefix_v_all[i], prefix_len),
            attend_part(qg, carry_k[i][None], carry_v[i][None], carry_mask, eq),
            attend_part(qg, k, v, blk_mask, eq),
        ]
        attn = merge_attention_parts(parts)  # [1, n_kv, g, C, hd]
        attn = torch.movedim(attn, 3, 1).reshape(1, C, cfg.n_heads * hd)
        x = x + _row_dense(cfg, attn.to(x.dtype), lp["wo"])
        x = x + _mlp(lp, cfg, x)
        k_cache[i][pages, offsets] = k[0].to(k_cache.dtype)
        v_cache[i][pages, offsets] = v[0].to(v_cache.dtype)
        carry_k[i, carry_len:carry_len + C] = k[0].to(carry_k.dtype)
        carry_v[i, carry_len:carry_len + C] = v[0].to(carry_v.dtype)
    carry_seg[carry_len:carry_len + C] = seg
    return _logits(params, cfg, x[0][end_idx.long()])


def _block_attention(cfg, q, k, v, i, masks, k_sfx, v_sfx, gen_k, gen_v,
                     prefix_k_all, prefix_v_all, prefix_len):
    """Block decode's four-part cascade for layer i: the shared prefix (K1),
    the row's dense suffix, the generated-so-far buffer and the block
    itself, merged. Returns [R, F, n_heads * hd] f32."""
    R, Fw = q.shape[:2]
    hd = cfg.head_dim
    sfx_mask, gen_mask, blk_mask = masks
    qg = (q.float() * hd**-0.5).reshape(R, Fw, cfg.n_kv_heads, cfg.q_per_kv, hd)
    eq = "bqkgh,bskh->bkgqs"
    parts = [
        flash_prefix_attention_parts(q, prefix_k_all[i], prefix_v_all[i], prefix_len),
        attend_part(qg, k_sfx[i], v_sfx[i], sfx_mask, eq),
        attend_part(qg, gen_k[i], gen_v[i], gen_mask, eq),
        attend_part(qg, k, v, blk_mask, eq),
    ]
    attn = merge_attention_parts(parts)  # [R, n_kv, g, F, hd]
    return torch.movedim(attn, 3, 1).reshape(R, Fw, cfg.n_heads * hd)


@torch.no_grad()
def forward_block_decode(
    params: Params,
    cfg: LlamaConfig,
    blk_tok: torch.Tensor,  # [R, F] int — this iteration's token block
    blk_valid: torch.Tensor,  # [R, F] bool — left-aligned valid tokens
    blk_len: torch.Tensor,  # [R] int — number of valid tokens
    positions: torch.Tensor,  # [R, F] absolute positions
    k_sfx: torch.Tensor,  # [L, R, Ss, n_kv, hd] dense suffix KV
    v_sfx: torch.Tensor,
    suffix_lens: torch.Tensor,  # [R]
    gen_k: torch.Tensor,  # [L, R, cap+1, n_kv, hd] generated-token KV
    gen_v: torch.Tensor,
    tail: torch.Tensor,  # [R] tokens already in gen_k/gen_v
    prefix_k_all: torch.Tensor,  # [L, Sp, n_kv, hd] shared dense prefix
    prefix_v_all: torch.Tensor,
    prefix_len: torch.Tensor,  # 0-dim int32 on the device
    ragged: bool = False,
):
    """One grammar-accelerated decode iteration: an F-wide mini-prefill
    where every valid block token attends the shared prefix (K1), its row's
    dense suffix, the generated-so-far buffer and causally within the block.
    The block's K/V is written into gen_k/gen_v IN PLACE AFTER each layer's
    attention (in-block attention uses the fresh k/v); invalid block slots
    write to the trash slot at index cap.

    `ragged=True` runs every projection and MLP matmul through K3
    (ops/ragged_matmul.py): the valid tokens are compacted to the front of
    the flattened [R*F] axis once (a stable argsort shared by all layers),
    the residual stream stays compacted through the layers, and each matmul
    works on whole 64-row tiles up to the valid-token count, read on the
    device. Attention and the K/V writes stay in the [R, F] layout: q/k/v
    scatter back through the inverse permutation and the attention output
    gathers forward through the permutation. Dead compacted rows carry
    zeros or garbage that every consumer masks.

    Returns (logits [R, V] f32 at each row's last valid block position,
    gen_k, gen_v)."""
    R, Fw = blk_tok.shape
    hd = cfg.head_dim
    dev = blk_tok.device
    cap1 = gen_k.shape[2]
    Ss = k_sfx.shape[2]
    inv_freq = rope_inv_freq(cfg, dev)
    x = _embed(params, cfg, blk_tok)

    sfx_mask = (torch.arange(Ss, device=dev)[None, :] < suffix_lens[:, None])[
        :, None, None, None, :
    ]
    gen_mask = (torch.arange(cap1, device=dev)[None, :] < tail[:, None])[
        :, None, None, None, :
    ]
    j = torch.arange(Fw, device=dev)
    blk_mask = (
        (j[:, None] >= j[None, :])[None, :, :] & blk_valid[:, None, :]
    )[:, None, None, :, :]
    masks = (sfx_mask, gen_mask, blk_mask)
    dest = torch.where(blk_valid, tail[:, None] + j[None, :], cap1 - 1).long()
    row = torch.arange(R, device=dev)[:, None]
    attn_args = (k_sfx, v_sfx, gen_k, gen_v, prefix_k_all, prefix_v_all, prefix_len)

    if ragged:
        perm = torch.argsort((~blk_valid).reshape(R * Fw).int(), stable=True)
        inv_perm = torch.argsort(perm)
        total = blk_len.sum(dtype=torch.int32)
        # last valid token of row r in compacted order (rows with len 0 clamp
        # to 0; their logits are never consumed)
        last_c = torch.clamp(torch.cumsum(blk_len, 0) - 1, min=0)
        xc = x.reshape(R * Fw, -1)[perm]

        def proj(h, w, n_heads):
            return ragged_matmul(h, w, total)[inv_perm].reshape(R, Fw, n_heads, hd)

        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            h = rms_norm(xc, lp["attn_norm"], cfg.rms_eps)
            q = apply_rope(proj(h, lp["wq"], cfg.n_heads), positions, inv_freq)
            k = apply_rope(proj(h, lp["wk"], cfg.n_kv_heads), positions, inv_freq)
            v = proj(h, lp["wv"], cfg.n_kv_heads)
            attn = _block_attention(cfg, q, k, v, i, masks, *attn_args)
            attn_c = attn.reshape(R * Fw, -1)[perm].to(xc.dtype)
            xc = xc + ragged_matmul(attn_c, lp["wo"], total)
            h2 = rms_norm(xc, lp["mlp_norm"], cfg.rms_eps)
            gate = ragged_matmul(h2, lp["w_gate"], total)
            up = ragged_matmul(h2, lp["w_up"], total)
            fused = F.silu(gate.float()).to(xc.dtype) * up
            xc = xc + ragged_matmul(fused, lp["w_down"], total)
            gen_k[i][row, dest] = k.to(gen_k.dtype)
            gen_v[i][row, dest] = v.to(gen_v.dtype)
        return _logits(params, cfg, xc[last_c]), gen_k, gen_v

    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        q, k, v = _qkv(lp, cfg, x, positions, inv_freq)
        attn = _block_attention(cfg, q, k, v, i, masks, *attn_args)
        x = x + _row_dense(cfg, attn.to(x.dtype), lp["wo"])
        x = x + _mlp(lp, cfg, x)
        gen_k[i][row, dest] = k.to(gen_k.dtype)
        gen_v[i][row, dest] = v.to(gen_v.dtype)
    return _last_valid_logits(params, cfg, x, blk_len), gen_k, gen_v


# ------------------------------------------------------------------- decode
def _decode_qkv(lp, cfg, x, positions, inv_freq):
    """One token per row ([B, D], [B]): q [B, n_heads, hd], k/v [B, n_kv, hd]."""
    q, k, v = _qkv(lp, cfg, x[:, None], positions[:, None], inv_freq)
    return q[:, 0], k[:, 0], v[:, 0]


@torch.no_grad()
def forward_decode_buffered(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B] int — one new token per slot
    positions: torch.Tensor,  # [B] ABSOLUTE position of that token
    k_own: torch.Tensor,  # own-token KV, layout per own_impl (see below)
    v_own: torch.Tensor,
    own_lens: torch.Tensor,  # [B] int32 valid own tokens (may be <= 0)
    chunk_k: torch.Tensor,  # [L, B, n_steps, n_kv, hd] this chunk's new KV
    chunk_v: torch.Tensor,
    tail_len: torch.Tensor,  # [B] entries already in the chunk buffer
    prefix_k_all: torch.Tensor,  # [L, Sp, n_kv, hd] shared dense prefix
    prefix_v_all: torch.Tensor,
    prefix_len: torch.Tensor,  # 0-dim int32
    page_tables: torch.Tensor | None = None,  # [B, P] (own_impl="pallas" only)
    own_impl: str = "dense",  # "dense" pre-gathered | "pallas" K4
):
    """One decode step against (prefix | own tokens | chunk buffer), the
    general path's chunked decode. The current token's K/V is written into
    the chunk buffer (IN PLACE) BEFORE attention, so it attends itself
    (the tail mask is `<=`). Attention is a three-part cascade merged by
    log-sum-exp:
      A. the shared dense prefix,
      B. the slot's own tokens — own_impl="dense": pre-gathered dense KV
         [L, B, L_own, n_kv, hd]; own_impl="pallas": the paged caches
         [L, num_pages, ps, n_kv, hd] and page_tables, streamed page by page
         by K4 (ops/paged_attention.paged_decode_attention_parts),
      C. the chunk buffer.
    Returns (logits [B, V] f32, chunk_k, chunk_v)."""
    if own_impl not in ("dense", "pallas"):
        raise ValueError(f"own_impl must be 'dense' or 'pallas', got {own_impl!r}")
    B = tokens.shape[0]
    dev = tokens.device
    hd = cfg.head_dim
    n_steps = chunk_k.shape[2]
    inv_freq = rope_inv_freq(cfg, dev)
    x = _embed(params, cfg, tokens)
    row = torch.arange(B, device=dev)
    tail = tail_len.long()

    Sp = prefix_k_all.shape[1]
    pre_mask = (torch.arange(Sp, device=dev) < prefix_len)[None, None, None, :]
    if own_impl == "dense":
        L_own = k_own.shape[2]
        own_mask = (torch.arange(L_own, device=dev)[None, :] < own_lens[:, None])[
            :, None, None, :
        ]
    # the current token attends itself: include the entry written this step
    tail_mask = (torch.arange(n_steps, device=dev)[None, :] <= tail_len[:, None])[
        :, None, None, :
    ]

    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        q, k, v = _decode_qkv(lp, cfg, x, positions, inv_freq)
        chunk_k[i][row, tail] = k.to(chunk_k.dtype)
        chunk_v[i][row, tail] = v.to(chunk_v.dtype)
        qg = (q.float() * hd**-0.5).reshape(B, cfg.n_kv_heads, cfg.q_per_kv, hd)
        if own_impl == "pallas":
            own_part = paged_decode_attention_parts(
                q, k_own[i], v_own[i], page_tables, own_lens
            )
        else:
            own_part = attend_part(qg, k_own[i], v_own[i], own_mask, "bkgh,blkh->bkgl")
        parts = [
            attend_part(qg, prefix_k_all[i], prefix_v_all[i], pre_mask, "bkgh,skh->bkgs"),
            own_part,
            attend_part(qg, chunk_k[i], chunk_v[i], tail_mask, "bkgh,blkh->bkgl"),
        ]
        attn = merge_attention_parts(parts).reshape(B, cfg.n_heads * hd).to(x.dtype)
        x = x + _row_dense(cfg, attn, lp["wo"])
        x = x + _mlp(lp, cfg, x)
    return _logits(params, cfg, x), chunk_k, chunk_v



# The fused decode loop's step forward (engine/fused/loop.py): the SAME
# function as the chunked path's, re-exported under the fused contract as
# the JAX package does; greedy token identity between the paths rests on it.
forward_decode_fused_body = forward_decode_buffered


@torch.no_grad()
def forward_decode(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B] int — one new token per slot
    positions: torch.Tensor,  # [B] 0-indexed position of the new token
    k_cache: torch.Tensor,  # [L, num_pages, page_size, n_kv, hd], updated IN PLACE
    v_cache: torch.Tensor,
    page_tables: torch.Tensor,  # [B, max_pages] int32
    active: torch.Tensor,  # [B] bool — inactive slots neither write nor matter
    paged_attn: str = "xla",  # "xla" gather path | "pallas" K4
):
    """One autoregressive decode step over the paged KV cache (the manual
    page API: engine/kv_cache.py write_prefill / ensure_capacity /
    note_token_appended). Scatters the new token's K/V into its page, then
    attends over every cached token including it. Inactive slots write to
    scratch page 0, offset 0, never through their (possibly recycled) page
    table. paged_attn="pallas" attends through K4 normalized
    (ops/paged_attention.paged_decode_attention); "xla" gathers the pages
    and attends densely (ops/attention.paged_decode_attention).

    Returns (logits [B, V] f32, k_cache, v_cache)."""
    if paged_attn not in ("xla", "pallas"):
        raise ValueError(f"paged_attn must be 'xla' or 'pallas', got {paged_attn!r}")
    attn_fn = (
        paged_decode_attention_kernel if paged_attn == "pallas"
        else paged_decode_attention
    )
    B = tokens.shape[0]
    dev = tokens.device
    ps = k_cache.shape[2]
    inv_freq = rope_inv_freq(cfg, dev)
    positions = positions.to(torch.int32)
    # an inactive slot may carry any position: clamp its table lookup
    page_slot = torch.clamp(positions.long() // ps, 0, page_tables.shape[1] - 1)
    page_ids = torch.gather(page_tables.long(), 1, page_slot[:, None])[:, 0]
    page_ids = torch.where(active, page_ids, 0)
    offsets = torch.where(active, positions.long() % ps, 0)
    seq_lens = (positions + 1).to(torch.int32)
    x = _embed(params, cfg, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        q, k, v = _decode_qkv(lp, cfg, x, positions, inv_freq)
        k_cache[i][page_ids, offsets] = k.to(k_cache.dtype)
        v_cache[i][page_ids, offsets] = v.to(v_cache.dtype)
        attn = attn_fn(q, k_cache[i], v_cache[i], page_tables, seq_lens)
        x = x + _row_dense(cfg, attn.reshape(B, cfg.n_heads * cfg.head_dim), lp["wo"])
        x = x + _mlp(lp, cfg, x)
    return _logits(params, cfg, x), k_cache, v_cache


# ------------------------------------------------ hidden-transfer head
def init_hidden_transfer(
    cfg: LlamaConfig, k: int, seed: int = 0, device: str | torch.device = "cuda"
) -> Params:
    """Random-init a hidden-transfer multi-token prediction head (*Hidden
    Transfer*, PAPERS.md): `k` per-offset transfer matrices [k, D, D]
    applied RESIDUALLY to the target's final-layer hidden state, x_h = x +
    x @ T_h, then pushed through the model's own final norm and LM head.

    The init is small (N(0, 1) * 0.02 / sqrt(D), from a seeded
    torch.Generator) so x_h ~= x: the untrained head predicts roughly the
    current position's distribution for every offset, which is never a
    correctness hazard (the verifier accepts only target-consistent
    tokens)."""
    if k < 1:
        raise ValueError(f"hidden-transfer k must be >= 1, got {k}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D = cfg.d_model
    t = torch.empty((k, D, D), dtype=cfg.dtype, device=dev)
    for h in range(k):
        t[h] = (torch.randn((D, D), generator=gen, dtype=torch.float32, device=dev)
                * (0.02 * D**-0.5)).to(cfg.dtype)
    return {"transfer": t}


def hidden_transfer_hidden(ht: Params, x: torch.Tensor, h: int) -> torch.Tensor:
    """Pseudo hidden state for future offset `h` (0-based head index):
    x [..., D] -> x + x @ T_h. The caller runs _logits on the result."""
    return x + _dense(x, ht["transfer"][h])


def hidden_transfer_logits(
    params: Params, cfg: LlamaConfig, ht: Params, x: torch.Tensor
) -> torch.Tensor:
    """All heads' logits from one hidden state: x [..., D] -> [..., k, V],
    through one LM-head product for the k pseudo hidden states."""
    xs = torch.stack(
        [hidden_transfer_hidden(ht, x, h) for h in range(ht["transfer"].shape[0])],
        dim=-2,
    )  # [..., k, D]
    return _logits(params, cfg, xs)
