"""Geometry-fingerprinted prefix-KV page sets: the unit the shared
prefix-KV plane (fleet/kvplane/) ships between replicas.

A page set is ONE snapshot prefix's dense KV stack — the exact
[L, cap, n_kv, hd] buffers the engine's prefix cache holds
(engine/engine._PrefixKV) — plus everything a peer needs to adopt it
without recomputing or resharding:

- the **content digest** of the pinned token ids. The delta encoder's
  pin keys (`pin-<seq>`, sched/delta.py) are replica-local sequence
  numbers; two replicas pinning the same cluster snapshot agree only on
  the TOKENS, so the plane keys pages by blake2b(token ids) and every
  replica that renders the same snapshot lands on the same entry.
- the **KV geometry** fingerprint: layer/head/dim/dtype shape AND the
  tensor-parallel group size the pages were placed for. A tp=4 replica
  adopts a tp=4 peer's pages directly (the head-sharded layout,
  engine/sharded/plane.py `prefix_kv`, is a property of the mesh both
  sides share); pages published under any OTHER geometry are refused
  loudly (KVGeometryError) — silently resharding would hide a fleet
  misconfiguration behind a perf cliff.
- the **transport arm**: `host` page sets carry CPU tensors (a
  device-to-host copy on publish, into pinned memory when the filler
  serves on a card, and a host-to-device copy on adopt — the
  cross-process shape, and what a networked store would serialize). They
  are torch tensors and not numpy arrays because numpy holds no bfloat16.
  `d2d` page sets carry the filler's device tensors by reference
  (in-process fleets on one card: adoption is a device-to-device copy
  with no host round-trip). At tp > 1 a `host` export gathers the whole
  model's heads from the ranks into the driver's host memory; a `d2d`
  export leaves each rank's block on its rank, in that rank's export table
  (engine.export_prefix_blocks), and the page set's `k` and `v` are
  RankBlocks: the whole model's shape, dtype and bytes, holding rank 0's
  tensors (the driver's own) and each other rank's handle (parallel/
  ipc.py). An adopting tp group's rank r copies the filler's rank-r block
  device to device; the bytes never pass through the driver, the control
  channel, a collective or host memory. The blocks live until the page
  set is collected or the filler's weights change (parallel/launch.
  ExportBook). Either way the adopter copies the pages into a buffer it
  owns (engine.adopt_prefix_pages), so a later write to the filler's
  buffer never reaches an adopted entry.
- the **store generation** they were published under (store.py): the
  fleet-wide twin of `engine.prefix_epoch` — a hot swap bumps it once
  and every replica's next lookup refuses pre-swap pages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import weakref
from typing import Any, Sequence

import torch


class KVGeometryError(RuntimeError):
    """Adoption refused: the page set's KV geometry does not match the
    adopting engine's (different model shape, dtype, or tp group size).
    Always a deployment error, never degraded around silently."""


@dataclasses.dataclass(frozen=True)
class KVGeometry:
    """The shape contract a prefix-KV page set must satisfy to be
    adoptable: model KV dimensions + the tp shard spec it was placed
    under. Frozen/hashable so stores can key entries by it."""

    n_layers: int
    n_kv_heads: int
    head_dim: int
    dtype: str
    tp: int = 1

    @classmethod
    def of_engine(cls, engine: Any) -> "KVGeometry":
        """Read an engine's serving geometry.

        Resolution order mirrors engine/sharded/geometry.member_tp: a
        `kv_geometry` attribute (stub/remote engines advertise without
        shipping a config), else the engine's (cfg, plane) pair — tp
        comes from the serving plane when one exists (tp>1 mesh), 1
        otherwise. The kv heads are the WHOLE model's (a tp rank's `cfg`
        holds its own block of them, `model_config` the model's), so one
        model at one tp has one geometry in both packages."""
        adv = getattr(engine, "kv_geometry", None)
        if isinstance(adv, KVGeometry):
            return adv
        if callable(adv):
            return adv()
        cfg = getattr(engine, "model_config", None) or engine.cfg
        plane = getattr(engine, "plane", None)
        tp = int(plane.tp) if plane is not None else 1
        return cls(
            n_layers=int(cfg.n_layers),
            n_kv_heads=int(cfg.n_kv_heads),
            head_dim=int(cfg.head_dim),
            dtype=dtype_name(cfg.dtype),
            tp=tp,
        )

    def describe(self) -> str:
        return (
            f"L{self.n_layers}xkv{self.n_kv_heads}xhd{self.head_dim}"
            f"/{self.dtype}/tp{self.tp}"
        )


def dtype_name(dtype: Any) -> str:
    """A dtype as the JAX package's geometry names it (str(np.dtype(d))
    there: "bfloat16", "float32"), so one model has one geometry in both
    packages: torch.bfloat16 -> "bfloat16"."""
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def page_digest(token_ids: Sequence[int]) -> str:
    """Content address of a pinned snapshot prefix: blake2b over the
    token ids (not hash() — replicas must agree across processes, the
    same reason fleet/lease.shard_of uses it)."""
    h = hashlib.blake2b(digest_size=16)
    for t in token_ids:
        h.update(int(t).to_bytes(8, "big", signed=True))
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class PrefixPageSet:
    """One publishable snapshot-prefix KV stack (see module docstring)."""

    digest: str                 # page_digest(token_ids)
    token_ids: tuple[int, ...]
    geometry: KVGeometry
    k: Any                      # [L, cap, n_kv, hd]; torch.Tensor | np.ndarray | RankBlocks
    v: Any
    transport: str              # "host" | "d2d"
    generation: int             # store generation at publish time
    filler: str                 # replica that paid the prefill

    def __post_init__(self) -> None:
        if self.transport not in ("host", "d2d"):
            raise ValueError(
                f"unknown kvplane transport {self.transport!r} "
                "(known: host, d2d)"
            )

    @property
    def nbytes(self) -> int:
        return int(self.k.nbytes) + int(self.v.nbytes)

    @property
    def length(self) -> int:
        return len(self.token_ids)


class D2DExport:
    """One tp > 1 filler's `d2d` export of one entry: rank 0's (k, v)
    tensors, each other rank's (k, v) handles in rank order, and the
    filler's tp group, whose ExportBook is told when this object goes."""

    def __init__(self, group: Any, export_id: int, blocks: list, filler: str) -> None:
        self.group, self.export_id, self.filler = group, export_id, filler
        self.local = tuple(blocks[0])
        self.handles = [tuple(h) for h in blocks[1:]]
        self.tp = len(blocks)
        weakref.finalize(self, group.exports.dropped, export_id)


class RankBlocks:
    """The `k` or `v` of a tp > 1 `d2d` page set: the whole model's
    [L, cap, n_kv, hd] as `shape`, `dtype` and `nbytes` tell the adopter's
    check and the store, held as one block a rank (`export`)."""

    def __init__(self, export: D2DExport, part: int) -> None:
        local = export.local[part]
        self.export = export
        self.shape = (*local.shape[:2], local.shape[2] * export.tp, *local.shape[3:])
        self.dtype = local.dtype
        self.nbytes = math.prod(self.shape) * local.element_size()


def export_pages(
    engine: Any,
    cache_key: tuple[int, ...],
    *,
    generation: int,
    filler: str,
    transport: str = "host",
) -> PrefixPageSet | None:
    """Build a publishable page set from an engine's cached (pinned)
    prefix. Returns None when the entry is gone (evicted between pin and
    export — the filler then simply doesn't publish).

    The export ships the WHOLE capacity buffer, padding included, not a
    `[:length]` slice: the adopter installs a buffer bit-identical to
    the filler's local one, so adopted-vs-local token identity holds by
    construction and no new pad-shape ever reaches the jitted programs.
    A tp > 1 filler's `d2d` export leaves every rank's block on its rank
    (RankBlocks).
    """
    geometry = KVGeometry.of_engine(engine)
    if transport == "d2d" and geometry.tp > 1:
        out = engine.export_prefix_blocks(cache_key)
        if out is None:
            return None
        export = D2DExport(engine.rank_group, *out, filler)
        kv = RankBlocks(export, 0), RankBlocks(export, 1)
    else:
        kv = engine.export_prefix_kv(cache_key)
    if kv is None:
        return None
    k, v = kv
    if transport == "host" and geometry.tp == 1:
        # (a tp > 1 export is already a fresh gather into host memory)
        k, v = _to_host(k), _to_host(v)
    return PrefixPageSet(
        digest=page_digest(cache_key),
        token_ids=tuple(cache_key),
        geometry=geometry,
        k=k,
        v=v,
        transport=transport,
        generation=int(generation),
        filler=filler,
    )


def _to_host(t: Any) -> Any:
    """A host copy of a cached KV buffer that the filler's later writes
    cannot reach: pinned memory for a card's tensor (the copy back waits
    for it), a clone for a CPU one; numpy arrays (the stub engine's) pass
    through."""
    if not isinstance(t, torch.Tensor):
        return t
    if t.device.type == "cpu":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def adopt_pages(engine: Any, pages: PrefixPageSet) -> tuple[tuple[int, ...], int]:
    """Install a peer's page set into `engine` as a pinned prefix.

    Refuses loudly on geometry mismatch BEFORE touching the engine —
    the tp=4/tp=2 case the sharded plane makes fatal: the kv-head axis
    of the shipped buffer was laid out for a different shard spec.
    Returns (cache_key, prefix_epoch), exactly pin_prefix's contract."""
    want = KVGeometry.of_engine(engine)
    if pages.geometry != want:
        raise KVGeometryError(
            f"cannot adopt prefix-KV pages published by {pages.filler!r} "
            f"with geometry {pages.geometry.describe()}: this replica "
            f"serves {want.describe()} (pages must be re-prefilled, not "
            "resharded)"
        )
    return engine.adopt_prefix_pages(list(pages.token_ids), pages.k, pages.v)
