"""Slice geometry: how many devices a serving member's tp group spans.

The disaggregated fleet (fleet/pools.py) routes prefill and decode work
to different pools. Prefill is compute-bound and scales with tp group
size (more chips, more FLOPs per prompt); decode is weight- and
KV-bandwidth-bound and small tp groups waste the least interconnect on
its tiny per-step matmuls. So the pool mapping should put the LARGE tp
groups in the prefill pool and the small ones in decode — and when the
autoscaler re-splits the pools under load, the split must move whole
device groups, never imagine a fraction of one.

`member_tp` is the single probe: it reads the member's geometry without
caring whether it is a local backend (engine.mesh), a remote client
that advertises `slice_tp`, or a bare stub (1). fleet/pools.py sorts
rosters with it and weighs occupancy-driven splits in DEVICES rather
than members.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

# The declared mesh-axes table: every named axis a PartitionSpec anywhere
# in this codebase may mention. parallel/mesh.py builds meshes in this
# order (tp innermost so its collectives ride ICI neighbors), and
# graftlint's `unknown-mesh-axis` rule validates PartitionSpec string
# literals against this tuple STATICALLY — a typo'd axis name
# (P("tensor") for P("tp")) is not an error to GSPMD, it just silently
# replicates the tensor, so the lint is the only thing that catches it
# before a bench does. Adding an axis here is a declaration reviewed like
# an API change; the lint reads this assignment via AST, so keep it a
# plain tuple of string literals.
MESH_AXES = ("dp", "pp", "fsdp", "sp", "tp")


def member_tp(member: Any) -> int:
    """Devices in `member`'s tensor-parallel group (>= 1).

    Resolution order: an explicit `slice_tp` attribute (remote clients
    advertise their serving geometry without shipping a mesh object),
    then the live engine's mesh tp axis, then 1 (single-chip or unknown
    — the conservative reading: an unknown member never outranks a
    known large group for prefill placement).
    """
    adv = getattr(member, "slice_tp", None)
    if adv is not None:
        try:
            return max(1, int(adv))
        except (TypeError, ValueError):
            return 1
    engine = getattr(member, "engine", None)
    mesh = getattr(engine, "mesh", None)
    if mesh is not None:
        try:
            return max(1, int(mesh.shape.get("tp", 1)))
        except (AttributeError, TypeError):
            return 1
    return 1


@dataclasses.dataclass(frozen=True)
class FleetGeometry:
    """The fleet roster annotated with per-member device-group sizes."""

    tp_sizes: tuple[int, ...]

    @classmethod
    def of(cls, members: Iterable[Any]) -> "FleetGeometry":
        return cls(tp_sizes=tuple(member_tp(m) for m in members))

    @property
    def total_devices(self) -> int:
        return sum(self.tp_sizes)

    @property
    def uniform(self) -> bool:
        return len(set(self.tp_sizes)) <= 1

    def prefill_order(self) -> list[int]:
        """Roster indices, largest tp group first (stable within a size).

        This is the prefill-affinity ordering: slicing the first n of it
        into the prefill pool lands prompts on the widest slices.
        """
        return sorted(
            range(len(self.tp_sizes)),
            key=lambda i: (-self.tp_sizes[i], i),
        )

    def split_for_device_share(self, share: float, order: Sequence[int] | None = None) -> int:
        """Member count whose device total best matches `share` of the
        fleet's devices, walking the (prefill-ordered) roster so the
        split never lands mid-group.

        Always leaves at least one member on each side (a pool with zero
        members deadlocks its work class — fleet/pools.set_split's
        invariant). With a uniform fleet this degenerates to the old
        member-count rounding.
        """
        n = len(self.tp_sizes)
        if n < 2:
            return max(1, n)
        order = list(order) if order is not None else self.prefill_order()
        share = min(max(float(share), 0.0), 1.0)
        want_devices = share * self.total_devices
        best_n, best_err = 1, float("inf")
        cum = 0
        for count, idx in enumerate(order[:-1], start=1):
            cum += self.tp_sizes[idx]
            err = abs(cum - want_devices)
            # strict < keeps the SMALLEST count on ties: prefill holds
            # only as many groups as the load share actually justifies
            if err < best_err:
                best_n, best_err = count, err
        return best_n
