"""Checkpoint loading: HF safetensors -> the port's params, and native
save/restore (the port of the JAX package's models/loader.py).

- **Streaming HF import**: `load_hf_checkpoint` walks the model's
  safetensors shard files one tensor at a time. Each per-layer tensor is
  transposed to the [in, out] layout of models/llama.py and copied into its
  stacked parameter's buffer on the device, allocated at the first layer
  that arrives. Host memory holds one tensor at a time. With
  `quantize="int8"` each stacked weight is quantized (models/quant.py's
  scheme, its scales in the JAX loader's compiled form) as soon as its
  last layer lands, so the bf16 form of at most one stacked weight is
  ever resident.
- **The format itself**, not the `safetensors` package: an 8-byte
  little-endian header length, a JSON header naming each tensor's dtype,
  shape and byte range, then the raw little-endian bytes
  (`SafetensorsFile`; the host is taken to be little-endian, as every
  host the port runs on is). A truncated file or a byte range that does not
  match its shape raises, naming the tensor.
- **Native checkpoints**: `save_checkpoint` / `restore_checkpoint` keep the
  params dict in a directory as one `torch.save` file, read back with
  `torch.load(weights_only=True)` (`read_native`). A hidden-transfer head,
  `{"transfer": [K, D, D]}`, is saved the same way and read back by
  train/hidden.restore_hidden_transfer. The JAX package's orbax directories
  cannot be read here.

HF -> port tensor map (Llama 3.x family, JAX loader.py:24-38):
  model.embed_tokens.weight            -> embed                [V, D]
  model.layers.{i}.input_layernorm     -> layers.attn_norm[i]  [D]
  model.layers.{i}.self_attn.q_proj    -> layers.wq[i]         [D, H*hd] (T)
  model.layers.{i}.self_attn.k_proj    -> layers.wk[i]         [D, KV*hd] (T)
  model.layers.{i}.self_attn.v_proj    -> layers.wv[i]         [D, KV*hd] (T)
  model.layers.{i}.self_attn.o_proj    -> layers.wo[i]         [H*hd, D] (T)
  model.layers.{i}.post_attention_layernorm -> layers.mlp_norm[i]
  model.layers.{i}.mlp.gate_proj       -> layers.w_gate[i]     [D, F] (T)
  model.layers.{i}.mlp.up_proj         -> layers.w_up[i]       [D, F] (T)
  model.layers.{i}.mlp.down_proj       -> layers.w_down[i]     [F, D] (T)
  model.norm.weight                    -> final_norm           [D]
  lm_head.weight                       -> lm_head              [D, V] (T)
  (lm_head absent => tie_embeddings; HF rotary is half-split, matching
   models/llama.apply_rope — no permutation needed.)
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import shutil
import struct
from pathlib import Path

import torch

from k8s_llm_scheduler_tpu_torch.device import resolve_device
from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig
from k8s_llm_scheduler_tpu_torch.models.quant import QUANT_KEYS, is_quantized, quantize_weight

logger = logging.getLogger(__name__)

Params = dict

_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)\.weight$")

# HF suffix -> (param key under "layers", transpose?)
_LAYER_MAP = {
    "input_layernorm": ("attn_norm", False),
    "self_attn.q_proj": ("wq", True),
    "self_attn.k_proj": ("wk", True),
    "self_attn.v_proj": ("wv", True),
    "self_attn.o_proj": ("wo", True),
    "post_attention_layernorm": ("mlp_norm", False),
    "mlp.gate_proj": ("w_gate", True),
    "mlp.up_proj": ("w_up", True),
    "mlp.down_proj": ("w_down", True),
}

_TOP_MAP = {
    "model.embed_tokens.weight": ("embed", False),
    "model.norm.weight": ("final_norm", False),
    "lm_head.weight": ("lm_head", True),
}

# safetensors dtype names -> torch dtypes (all stored little-endian)
_DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "F64": torch.float64,
    "I8": torch.int8,
    "U8": torch.uint8,
    "I16": torch.int16,
    "I32": torch.int32,
    "I64": torch.int64,
    "BOOL": torch.bool,
}

NATIVE_FILE = "params.pt"


def _expected_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, ...]]:
    hd = cfg.head_dim
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    shapes = {
        "embed": (cfg.vocab_size, D),
        "final_norm": (D,),
        "layers.attn_norm": (L, D),
        "layers.wq": (L, D, cfg.n_heads * hd),
        "layers.wk": (L, D, cfg.n_kv_heads * hd),
        "layers.wv": (L, D, cfg.n_kv_heads * hd),
        "layers.wo": (L, cfg.n_heads * hd, D),
        "layers.mlp_norm": (L, D),
        "layers.w_gate": (L, D, F),
        "layers.w_up": (L, D, F),
        "layers.w_down": (L, F, D),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, cfg.vocab_size)
    return shapes


class SafetensorsFile:
    """One safetensors file, read a tensor at a time from its byte range.

    Layout: an 8-byte little-endian u64 N, N bytes of JSON header
    ({name: {"dtype", "shape", "data_offsets": [begin, end]}, optionally
    "__metadata__"}), then the data; offsets are relative to the data's
    start. Every range is checked against the file's size and the tensor's
    shape when the file is opened, so a truncated file fails before any
    tensor is read, naming the first tensor it cuts."""

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        size = self.path.stat().st_size
        with open(self.path, "rb") as f:
            raw = f.read(8)
            if len(raw) < 8:
                raise ValueError(f"{self.path}: not a safetensors file (shorter than 8 bytes)")
            (n,) = struct.unpack("<Q", raw)
            if n > size - 8:
                raise ValueError(
                    f"{self.path}: header of {n} bytes runs past the file's {size} bytes")
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self._data_start = 8 + n
        self._entries = {}
        for name, info in header.items():
            dtype = _DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{self.path}: tensor {name!r} has unsupported dtype "
                                 f"{info['dtype']!r}")
            shape = tuple(int(d) for d in info["shape"])
            begin, end = (int(o) for o in info["data_offsets"])
            want = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
            if end - begin != want or begin < 0:
                raise ValueError(
                    f"{self.path}: tensor {name!r} of shape {shape} and dtype "
                    f"{info['dtype']} needs {want} bytes, its range holds {end - begin}")
            if self._data_start + end > size:
                raise ValueError(
                    f"{self.path}: tensor {name!r} ends at byte {self._data_start + end}, "
                    f"past the end of the file ({size} bytes): truncated")
            self._entries[name] = (dtype, shape, begin, end)

    def keys(self) -> list[str]:
        """Tensor names in the order of their bytes in the file."""
        return sorted(self._entries, key=lambda k: self._entries[k][2])

    def get_tensor(self, name: str) -> torch.Tensor:
        """The tensor `name` as a CPU tensor of its stored dtype."""
        return self.get_slice(name, 0, 0, None)

    def get_slice(self, name: str, dim: int, lo: int, hi: int | None) -> torch.Tensor:
        """Entries [lo, hi) of `name` along `dim` (hi None: to the end). A
        slice of dim 0 reads only its own bytes; another dim reads the
        tensor and narrows it."""
        dtype, shape, begin, end = self._entries[name]
        if dim != 0:
            full = self.get_slice(name, 0, 0, None)
            return full.narrow(dim, lo, (shape[dim] if hi is None else hi) - lo).contiguous()
        if shape:
            hi = shape[0] if hi is None else hi
            row = (end - begin) // shape[0] if shape[0] else 0
            begin, end = begin + lo * row, begin + hi * row
            shape = (hi - lo, *shape[1:])
        with open(self.path, "rb") as f:
            f.seek(self._data_start + begin)
            data = bytearray(f.read(end - begin))
        if len(data) != end - begin:
            raise ValueError(f"{self.path}: tensor {name!r} is truncated")
        if not data:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(data, dtype=dtype).reshape(shape)


def checkpoint_files(path: str | Path) -> list[Path]:
    """The safetensors shards of an HF checkpoint dir, index-ordered."""
    path = Path(path)
    index = path / "model.safetensors.index.json"
    if index.exists():
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        return [path / name for name in sorted(set(weight_map.values()))]
    single = path / "model.safetensors"
    if single.exists():
        return [single]
    files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files under {path}")
    return files


def load_hf_checkpoint(
    path: str | Path,
    cfg: LlamaConfig,
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = None,
    quantize: str | None = None,
    shard: dict | None = None,
) -> Params:
    """Stream an HF Llama safetensors checkpoint into the port's params on
    `device`, one tensor at a time (JAX loader.py:136-268).

    `shard` ({param name: (dim, lo, hi)} in the port's stacked layout,
    parallel/sharding.rank_ranges) keeps one tensor-parallel rank's block
    of those params: a block of an HF tensor's rows (column-parallel
    weights, the embedding, the LM head) is read alone, so a rank never
    holds another rank's weights; a row-parallel weight is read a layer at
    a time and narrowed, after its int8 scales were taken over the whole
    input dim (one rank's scales equal the unsharded model's)."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantization {quantize!r} (only 'int8')")
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    shapes = _expected_shapes(cfg)
    full_shapes = dict(shapes)
    shard = shard or {}
    for name, (dim, lo, hi) in shard.items():
        shapes[name] = tuple(hi - lo if d == dim else n for d, n in enumerate(shapes[name]))
    filled: dict[str, int] = {}
    out: dict[str, object] = {}

    def oriented(f: SafetensorsFile, hf_name: str, transpose: bool, want,
                 rng=None) -> torch.Tensor:
        if rng is None:
            tensor = f.get_tensor(hf_name)
        else:
            dim, lo, hi = rng  # in the oriented tensor's dims
            tensor = f.get_slice(hf_name, (1 - dim) if transpose else dim, lo, hi)
        if transpose:
            tensor = tensor.T.contiguous()
        if tuple(tensor.shape) != tuple(want):
            raise ValueError(
                f"{hf_name}: shape {tuple(tensor.shape)} != expected {tuple(want)}")
        return tensor.to(dtype)

    def layer_block(f, hf_name, key, transpose, name):
        """One layer of a stacked param: a rank's block of it under `shard`,
        an int8 pair where a row-parallel weight is quantized."""
        rng = shard.get(name)
        if rng is None:
            return oriented(f, hf_name, transpose, shapes[name][1:])
        dim, lo, hi = rng[0] - 1, rng[1], rng[2]
        if quantize == "int8" and key in QUANT_KEYS and dim == 0:
            # row parallel: the per-output scales span the whole input dim
            whole = oriented(f, hf_name, transpose, full_shapes[name][1:])
            pair = quantize_weight(whole, reciprocal=True)
            return {"q": pair["q"][lo:hi].contiguous(), "scale": pair["scale"]}
        return oriented(f, hf_name, transpose, shapes[name][1:], (dim, lo, hi))

    for file in checkpoint_files(path):
        f = SafetensorsFile(file)
        for hf_name in f.keys():
            m = _LAYER_RE.match(hf_name)
            if m:
                layer, suffix = int(m.group(1)), m.group(2)
                if suffix not in _LAYER_MAP:
                    logger.warning("skipping unknown tensor %s", hf_name)
                    continue
                key, transpose = _LAYER_MAP[suffix]
                name = f"layers.{key}"
                if layer >= cfg.n_layers:
                    raise ValueError(f"{hf_name}: layer {layer} >= n_layers={cfg.n_layers}")
                host = layer_block(f, hf_name, key, transpose, name)
                if isinstance(host, dict):  # quantized already, a layer at a time
                    if name not in out:
                        out[name] = {k: torch.zeros((cfg.n_layers, *v.shape), dtype=v.dtype,
                                                    device=dev) for k, v in host.items()}
                        filled[name] = 0
                    for k, v in host.items():
                        out[name][k][layer].copy_(v)
                    filled[name] += 1
                    continue
                if name not in out:
                    out[name] = torch.zeros(shapes[name], dtype=dtype, device=dev)
                    filled[name] = 0
                out[name][layer].copy_(host)
                filled[name] += 1
                if (quantize == "int8" and filled[name] == cfg.n_layers
                        and key in QUANT_KEYS):
                    out[name] = quantize_weight(out[name], reciprocal=True)
            elif hf_name in _TOP_MAP:
                name, transpose = _TOP_MAP[hf_name]
                if name == "lm_head" and cfg.tie_embeddings:
                    logger.info("ignoring lm_head (tied embeddings)")
                    continue
                out[name] = oriented(f, hf_name, transpose, shapes[name],
                                     shard.get(name)).to(dev)
            else:
                logger.warning("skipping unknown tensor %s", hf_name)

    missing = set(shapes) - set(out)
    partial = {n: f"{filled[n]}/{cfg.n_layers}" for n in filled if filled[n] < cfg.n_layers}
    if missing or partial:
        raise ValueError(
            f"checkpoint incomplete: missing {sorted(missing)}"
            + (f"; partial layer stacks {partial}" if partial else "")
        )
    params: Params = {
        "embed": out["embed"],
        "final_norm": out["final_norm"],
        "layers": {k.split(".", 1)[1]: v for k, v in out.items() if k.startswith("layers.")},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = out["lm_head"]
    return params


class CheckpointError(RuntimeError):
    """A native checkpoint is missing, torn, or shaped for another config:
    raised with the offending path and the first mismatched param."""


def _fsync(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _on_cpu(tree):
    if isinstance(tree, dict):
        return {k: _on_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def save_checkpoint(path: str | Path, params: Params) -> None:
    """Write a native checkpoint of `params` (bf16 or int8 pairs) as the
    directory `path`, overwriting one that is there. Atomic against
    crashes, as the JAX package's save is: written aside, fsynced, then
    swapped in by rename; the previous checkpoint survives as `.old` until
    the new one is durably in place."""
    path = Path(path).resolve()
    tmp = path.with_name(path.name + ".saving")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    torch.save(_on_cpu(params), tmp / NATIVE_FILE)
    _fsync(tmp / NATIVE_FILE)
    _fsync(tmp)
    old = path.with_name(path.name + ".old")
    if old.exists():
        shutil.rmtree(old)
    if path.exists():
        os.rename(path, old)
    os.rename(tmp, path)
    _fsync(path.parent)
    if old.exists():
        shutil.rmtree(old)


def read_native(path: str | Path):
    """The tree a native checkpoint dir holds, on the CPU, unchecked (the
    model's restore below, or train/hidden.restore_hidden_transfer for a
    hidden-transfer head, checks its shapes). A missing dir or file, or one
    torch.load cannot read, raises CheckpointError naming it."""
    path = Path(path).resolve()
    if not path.is_dir():
        raise CheckpointError(f"checkpoint dir {path} does not exist")
    file = path / NATIVE_FILE
    if not file.exists():
        raise CheckpointError(
            f"{path} is not a native checkpoint of the port (no {NATIVE_FILE}): a "
            f"partial save, an HF safetensors dir passed to the native restore, or "
            f"an orbax checkpoint of the JAX package, which the port cannot read"
        )
    try:
        return torch.load(file, map_location="cpu", weights_only=True)
    except Exception as exc:
        raise CheckpointError(f"{file} cannot be read: {exc}") from exc


def restore_checkpoint(
    path: str | Path,
    cfg: LlamaConfig,
    *,
    device: str | torch.device = "cuda",
) -> Params:
    """Read a native checkpoint (save_checkpoint) onto `device`, checked
    against `cfg` first: a missing or torn directory, or a stored param
    whose shape `cfg` does not expect, raises CheckpointError naming the
    path and the first such param."""
    dev = resolve_device(device)
    path = Path(path).resolve()
    tree = read_native(path)
    shapes = _expected_shapes(cfg)

    def lookup(name: str):
        node = tree
        for part in name.split("."):
            if not isinstance(node, dict) or part not in node:
                return None
            node = node[part]
        return node

    for name in sorted(shapes):
        leaf = lookup(name)
        if leaf is None:
            raise CheckpointError(
                f"{path}: checkpoint is missing param {name!r} expected by config "
                f"{cfg.name!r}")
        stored = tuple((leaf["q"] if is_quantized(leaf) else leaf).shape)
        if stored != tuple(shapes[name]):
            raise CheckpointError(
                f"{path}: param {name!r} has shape {stored}, but config {cfg.name!r} "
                f"expects {tuple(shapes[name])}")

    def place(node):
        if is_quantized(node):
            return {k: v.to(dev) for k, v in node.items()}
        if isinstance(node, dict):
            return {k: place(v) for k, v in node.items()}
        return node.to(dtype=cfg.dtype, device=dev)

    return place(tree)
