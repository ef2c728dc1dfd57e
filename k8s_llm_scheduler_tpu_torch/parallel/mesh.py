"""Rank meshes from config (after the JAX package's parallel/mesh.py).

The JAX package lays a `jax.sharding.Mesh` over the chips of one
controller and lets XLA insert the collectives. PyTorch's idiom is one
process per rank, so here a mesh is a grid of GLOBAL RANKS: `RankMesh`
names its axes in AXIS_ORDER (engine/sharded/geometry.MESH_AXES, tp
innermost), exposes `shape` ({axis: size}, like a jax Mesh, which is what
geometry.member_tp reads) and, once bound to a rendezvous store and this
process's rank, builds one process group per axis on first use
(parallel/launch.py picks the backend).

Axis conventions, as in the JAX package:
    dp    data/batch parallel
    fsdp  param sharding for training
    tp    tensor parallel (attention heads, MLP hidden dim, vocab)
    sp    sequence/context parallel
"""

from __future__ import annotations

import math
from collections.abc import Mapping, Sequence

import numpy as np

from k8s_llm_scheduler_tpu_torch.engine.sharded.geometry import MESH_AXES

AXIS_ORDER = MESH_AXES


class RankMesh:
    """A named grid of global ranks. `bind(store, rank, ...)` attaches this
    process; `group(axis)` is then this rank's process group along `axis`
    (the ranks that share every other coordinate), created once."""

    def __init__(self, grid: np.ndarray, names: Sequence[str]) -> None:
        grid = np.asarray(grid, dtype=np.int64)
        if grid.ndim != len(names):
            raise ValueError(f"grid of rank {grid.ndim} for axes {tuple(names)}")
        self.grid = grid
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in grid.shape)))
        self.size = int(grid.size)
        self.rank: int | None = None
        self.store = None
        self.timeout_s: float | None = None
        self.device_count = 0
        self.host_rank0 = 0
        self._groups: dict[str, object] = {}

    def __repr__(self) -> str:
        return f"RankMesh({self.shape}, rank={self.rank})"

    @property
    def ranks(self) -> list[int]:
        return [int(r) for r in self.grid.reshape(-1)]

    def bind(self, store, rank: int, *, timeout_s: float, device_count: int = 0,
             host_rank0: int = 0) -> "RankMesh":
        """Attach this process as global `rank`, rendezvousing over `store`.
        `device_count` is the CUDA devices this host sees (0 on the CPU) and
        `host_rank0` the first global rank of this host: local rank r - it
        runs on cuda:((r - host_rank0) % device_count)."""
        if rank not in self.ranks:
            raise ValueError(f"rank {rank} is not in the mesh {self.shape}")
        self.store, self.rank, self.timeout_s = store, int(rank), float(timeout_s)
        self.device_count, self.host_rank0 = int(device_count), int(host_rank0)
        return self

    def coords(self, rank: int | None = None) -> tuple[int, ...]:
        rank = self.rank if rank is None else rank
        where = np.argwhere(self.grid == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh {self.shape}")
        return tuple(int(c) for c in where[0])

    def axis_index(self, axis: str, rank: int | None = None) -> int:
        """`rank`'s coordinate on `axis` (0 for an axis the mesh lacks)."""
        if axis not in self.shape:
            return 0
        return self.coords(rank)[self.axis_names.index(axis)]

    def axis_ranks(self, axis: str, rank: int | None = None) -> list[int]:
        """The global ranks of `rank`'s group along `axis`, in axis order."""
        if axis not in self.shape:
            return [self.rank if rank is None else rank]
        at = list(self.coords(rank))
        i = self.axis_names.index(axis)
        out = []
        for c in range(self.shape[axis]):
            at[i] = c
            out.append(int(self.grid[tuple(at)]))
        return out

    def local_device_index(self, rank: int | None = None) -> int | None:
        """The CUDA device index `rank` runs on, None on the CPU."""
        if not self.device_count:
            return None
        rank = self.rank if rank is None else rank
        return (rank - self.host_rank0) % self.device_count

    def group(self, axis: str):
        """This rank's process group along `axis` (parallel/launch.AxisGroup),
        created at the first call; every member must call it too."""
        if self.rank is None:
            raise RuntimeError("the mesh is not bound to a rank (RankMesh.bind)")
        if axis not in self._groups:
            from k8s_llm_scheduler_tpu_torch.parallel.launch import AxisGroup

            self._groups[axis] = AxisGroup.for_mesh(self, axis)
        return self._groups[axis]

    def issued(self, axis: str) -> int:
        """The collectives this rank has issued along `axis` (0 before the
        group exists)."""
        group = self._groups.get(axis)
        return 0 if group is None else group.ops

    def close(self) -> None:
        """Drop the process groups (their connections close with them)."""
        self._groups.clear()


def make_mesh(
    axes: Mapping[str, int] | None = None,
    ranks: Sequence[int] | None = None,
) -> RankMesh:
    """A RankMesh with named axes from an {axis: size} mapping (JAX
    make_mesh): axes of size 1 are dropped, `{"dp": 1}` when none is left,
    the order is AXIS_ORDER. `ranks` are the global ranks to lay out (by
    default 0..size-1: one host's ranks are spawned to fit the mesh)."""
    axes = dict(axes or {})
    for name in axes:
        if name not in AXIS_ORDER:
            raise ValueError(f"unknown mesh axis {name!r}; known: {AXIS_ORDER}")
    ordered = [(name, int(axes.get(name, 1))) for name in AXIS_ORDER if axes.get(name, 1) > 1]
    if not ordered:
        ordered = [("dp", 1)]
    total = math.prod(size for _, size in ordered)
    ranks = list(range(total)) if ranks is None else [int(r) for r in ranks]
    if total > len(ranks):
        raise ValueError(f"mesh {dict(ordered)} needs {total} ranks, have {len(ranks)}")
    names = tuple(name for name, _ in ordered)
    shape = tuple(size for _, size in ordered)
    return RankMesh(np.array(ranks[:total]).reshape(shape), names)


def mesh_from_config(
    mesh_cfg: Mapping[str, int] | None,
    ranks: Sequence[int] | None = None,
) -> RankMesh:
    """Mesh from the `llm.mesh` config block; `{dp: 1}` when it is empty."""
    if not mesh_cfg:
        return make_mesh({"dp": 1}, ranks=ranks)
    return make_mesh(mesh_cfg, ranks=ranks)


def axis_size(mesh: RankMesh, name: str) -> int:
    return mesh.shape.get(name, 1)
