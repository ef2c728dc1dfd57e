"""Multi-host scaffolding (after the JAX package's parallel/distributed.py):
the world's rendezvous, the coordinator gate and hybrid rank meshes.

In the JAX package a *process* is a host and `jax.distributed.initialize`
makes every host's chips one device list. Here a host runs one process per
rank of its tensor-parallel group, so `init_distributed` rendezvouses a
world of `num_processes x ranks_per_process` ranks over a TCP store at the
coordinator's address: host h's ranks are h*tp .. h*tp+tp-1 and its driver
(the process `cli run` started) is rank h*tp, which spawns the others
(parallel/launch.py). `multihost_mesh` lays that world out as a grid with
the DCN axes (across hosts) outermost and the ICI axes (within a host)
innermost. `is_coordinator` gates the cluster-facing control plane
(watch/bind) to host 0; every other host serves its own replica.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from collections.abc import Mapping

import numpy as np

from k8s_llm_scheduler_tpu_torch.parallel.mesh import RankMesh

logger = logging.getLogger(__name__)

RENDEZVOUS_TIMEOUT_S = 300.0


@dataclasses.dataclass
class World:
    """This host's place in the rendezvoused world."""

    store: object  # torch.distributed.TCPStore
    coordinator: str  # "host:port" of the store
    num_processes: int  # hosts
    process_id: int  # this host
    ranks_per_process: int  # ranks each host runs (its tp)

    @property
    def host_rank0(self) -> int:
        return self.process_id * self.ranks_per_process

    @property
    def world_size(self) -> int:
        return self.num_processes * self.ranks_per_process


_WORLD: World | None = None


def _split_address(address: str) -> tuple[str, int]:
    host, _, port = str(address).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} is not host:port")
    return host, int(port)


def connect_store(address: str, is_master: bool, timeout_s: float = RENDEZVOUS_TIMEOUT_S):
    """A TCP store at `address` ("host:port"): the server on the master."""
    import datetime

    from torch.distributed import TCPStore

    host, port = _split_address(address)
    return TCPStore(host, port, is_master=is_master,
                    timeout=datetime.timedelta(seconds=timeout_s),
                    wait_for_workers=False)


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    ranks_per_process: int = 1,
    timeout_s: float = RENDEZVOUS_TIMEOUT_S,
) -> bool:
    """Join the multi-host world (idempotent; a no-op for one process).

    Nothing on a host announces a cluster, so the three arguments are
    required: process 0 serves the store at `coordinator_address`, and every
    host waits until all `num_processes` have checked in. Returns True iff
    the world spans more than one process."""
    global _WORLD
    if num_processes is not None and int(num_processes) <= 1:
        return False
    if _WORLD is None:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError(
                "distributed.enabled needs distributed.coordinator, num_processes and "
                "process_id: nothing on the host announces them")
        num_processes, process_id = int(num_processes), int(process_id)
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} not in [0, {num_processes})")
        store = connect_store(coordinator_address, process_id == 0, timeout_s)
        store.set(f"world/host/{process_id}", str(ranks_per_process))
        store.wait([f"world/host/{h}" for h in range(num_processes)])
        widths = {int(store.get(f"world/host/{h}")) for h in range(num_processes)}
        if widths != {int(ranks_per_process)}:
            raise ValueError(f"hosts run different tp widths: {sorted(widths)}")
        _WORLD = World(store, str(coordinator_address), num_processes, process_id,
                       int(ranks_per_process))
        logger.info("distributed: process %d/%d, %d ranks a host, %d global ranks",
                    process_id, num_processes, ranks_per_process, _WORLD.world_size)
    return _WORLD.num_processes > 1


def world() -> World | None:
    """The rendezvoused world, None single-process."""
    return _WORLD


def is_coordinator() -> bool:
    """True on the process that owns cluster-facing side effects
    (watch/bind); always True single-process."""
    return _WORLD is None or _WORLD.process_id == 0


def multihost_mesh(
    dcn_axes: Mapping[str, int],
    ici_axes: Mapping[str, int],
) -> RankMesh:
    """A RankMesh with `dcn_axes` across processes (hosts) and `ici_axes`
    within each, DCN outermost (JAX multihost_mesh). Size-1 axes are kept.
    The product of dcn_axes must equal the process count and the ici axes
    must fit each host's ranks."""
    dcn_axes = {k: int(v) for k, v in dcn_axes.items()}
    ici_axes = {k: int(v) for k, v in ici_axes.items()}
    overlap = set(dcn_axes) & set(ici_axes)
    if overlap:
        raise ValueError(f"axes {overlap} appear in both dcn and ici")
    dcn_size = math.prod(dcn_axes.values()) if dcn_axes else 1
    ici_size = math.prod(ici_axes.values())
    procs = _WORLD.num_processes if _WORLD is not None else 1
    if dcn_size != procs:
        raise ValueError(f"dcn axes {dict(dcn_axes)} need {dcn_size} processes, have {procs}")
    per_host = _WORLD.ranks_per_process if _WORLD is not None else ici_size
    if ici_size > per_host:
        raise ValueError(f"ici axes {dict(ici_axes)} need {ici_size} ranks per process; "
                         f"each process has {per_host}")
    rows = np.array([[h * per_host + i for i in range(ici_size)] for h in range(procs)])
    if dcn_axes:
        grid = rows.reshape(*dcn_axes.values(), *ici_axes.values())
    else:
        grid = rows[0].reshape(*ici_axes.values())
    return RankMesh(grid, tuple(dcn_axes) + tuple(ici_axes))
