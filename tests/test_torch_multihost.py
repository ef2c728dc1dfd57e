"""The port's multi-host scaffolding (parallel/distributed.py) and the
`cli run` worker path, against the JAX package's (tests/test_multihost.py
is its own): multihost_mesh's checks, `_run_worker_replica` serving a
decision over the replica RPC from a tp=2 backend, and two hosts x tp 1
through `distributed.enabled`, where the coordinator alone binds and the
other host serves through the fan-out.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from k8s_llm_scheduler_tpu.parallel import distributed as jdistributed
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.cluster.interface import raw_pod_to_spec
from k8s_llm_scheduler_tpu_torch.config import load_config
from k8s_llm_scheduler_tpu_torch.parallel import distributed
from k8s_llm_scheduler_tpu_torch.sched.replica import ReplicaClient

ttesting.cap_torch_threads()

REPO = Path(__file__).resolve().parent.parent
WAIT_S = 240.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -------------------------------------------------------------- the mesh
@pytest.mark.parametrize("dcn,ici,match", [
    ({}, {"tp": 4}, None),
    ({"dp": 2}, {"tp": 2}, "processes"),
    ({"dp": 2}, {"dp": 2}, "both"),
])
def test_multihost_mesh_checks_match_the_jax_ones(dcn, ici, match):
    if match is None:
        assert distributed.multihost_mesh(dcn, ici).shape == jdistributed.multihost_mesh(
            dcn, ici).shape == {"tp": 4}
        return
    with pytest.raises(ValueError, match=match):
        jdistributed.multihost_mesh(dcn, ici)
    with pytest.raises(ValueError, match=match):
        distributed.multihost_mesh(dcn, ici)


def test_coordinator_and_a_world_of_hosts(monkeypatch):
    assert distributed.is_coordinator() and jdistributed.is_coordinator()
    assert distributed.init_distributed(None, 1, 0) is False
    monkeypatch.setattr(distributed, "_WORLD", distributed.World(
        store=None, coordinator="127.0.0.1:1", num_processes=2, process_id=1,
        ranks_per_process=2))
    assert not distributed.is_coordinator()
    m = distributed.multihost_mesh({"dp": 2}, {"tp": 2})
    assert m.axis_names == ("dp", "tp") and np.array_equal(m.grid, [[0, 1], [2, 3]])
    assert m.bind(None, 3, timeout_s=1.0).axis_ranks("tp") == [2, 3]
    with pytest.raises(ValueError, match="ranks per process"):
        distributed.multihost_mesh({"dp": 2}, {"tp": 4})
    with pytest.raises(ValueError, match="need all three|coordinator"):
        monkeypatch.setattr(distributed, "_WORLD", None)
        distributed.init_distributed(None, 2, 0)


# --------------------------------------------------- the worker's cli path
def test_run_worker_replica_tp2_serves_decisions():
    """The cli worker path (JAX tests/test_multihost.py:45): with
    distributed.enabled and llm.mesh {tp: 2}, `_run_worker_replica` serves
    decisions over the replica RPC from a tp=2 backend on the CPU."""
    cfg = load_config(yaml_path=None, env={})
    cfg.data["distributed"]["enabled"] = True
    cfg.data["distributed"]["replica_port"] = 0  # OS-assigned
    cfg.data["llm"]["model"] = "tiny"
    cfg.data["llm"]["mesh"] = {"tp": 2}
    assert cli._backend_kwargs(cfg)["mesh_axes"] == {"tp": 2}
    ready, stop = threading.Event(), threading.Event()
    worker = threading.Thread(target=cli._run_worker_replica, args=(cfg, stop, ready),
                              kwargs={"device": "cpu"}, daemon=True)
    worker.start()
    try:
        deadline = time.monotonic() + WAIT_S
        while not ready.wait(0.05):
            assert worker.is_alive(), "worker thread died before serving"
            assert time.monotonic() < deadline, "worker never came up"
        client = ReplicaClient("localhost", ready.port, request_timeout_s=WAIT_S)
        try:
            cluster = ttesting.synthetic_cluster(3)
            nodes = cluster.get_node_metrics()
            cluster.close()
            pod = raw_pod_to_spec(next(iter(ttesting.pod_burst(1))))
            decision = client.get_scheduling_decision(pod, nodes)
            assert decision.selected_node in {n.name for n in nodes}
        finally:
            client.close()
    finally:
        stop.set()
        worker.join(timeout=60)
    assert not worker.is_alive()


# ------------------------------------------------ two hosts through the cli
N_NODES = 4
N_PODS = 6


def _yaml(settings: dict) -> str:
    return json.dumps(settings)  # JSON is YAML


def test_two_hosts_coordinator_binds_and_the_worker_serves(tmp_path, monkeypatch, capsys):
    coordinator = f"127.0.0.1:{_free_port()}"
    worker_port = _free_port()
    # the replica RPC waits as long as the test does: a decision the
    # coordinator gave up on would still run on the worker at its SIGINT
    common = {"llm": {"model": "tiny", "temperature": 0.0, "timeout": WAIT_S},
              "distributed": {"enabled": True, "coordinator": coordinator,
                              "num_processes": 2, "replica_bind_host": "127.0.0.1"}}
    worker_dir = tmp_path / "worker"
    worker_dir.mkdir()
    (worker_dir / "config.yaml").write_text(_yaml({
        **common, "distributed": {**common["distributed"], "process_id": 1,
                                  "replica_port": worker_port}}))
    # the worker's torch pool as small as this process's (cap_torch_threads)
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "OMP_NUM_THREADS": str(ttesting.TEST_TORCH_THREADS)}
    env.pop("JAX_PLATFORMS", None)
    worker = subprocess.Popen(
        [sys.executable, "-m", "k8s_llm_scheduler_tpu_torch.cli", "run", "--device", "cpu"],
        cwd=worker_dir, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: list[str] = []
    reader = threading.Thread(target=lambda: lines.extend(worker.stdout), daemon=True)
    reader.start()
    try:
        # each host's init waits for the other's, so the coordinator starts
        # now; the pods arrive once the worker host serves
        (tmp_path / "config.yaml").write_text(_yaml({
            **common, "distributed": {**common["distributed"], "process_id": 0,
                                      "replica_addrs": [f"127.0.0.1:{worker_port}"]}}))
        monkeypatch.chdir(tmp_path)
        monkeypatch.setattr(distributed, "_WORLD", None)  # restored at teardown
        cluster = ttesting.synthetic_cluster(N_NODES)
        monkeypatch.setattr(ttesting, "synthetic_cluster", lambda n: cluster)

        def pods_once_the_worker_serves():
            deadline = time.monotonic() + WAIT_S
            while not any("serving decisions on" in line for line in lines):
                if worker.poll() is not None or time.monotonic() > deadline:
                    return
                time.sleep(0.1)
            for pod in list(ttesting.pod_burst(N_PODS))[:N_PODS]:
                cluster.add_pod(pod)

        rc, stats = _run_until(monkeypatch, capsys, ["run", "--fake-cluster", "--fake-nodes",
                                                     str(N_NODES), "--device", "cpu"],
                               pods_once_the_worker_serves,
                               lambda: cluster.bind_count >= N_PODS)
        assert distributed.world().process_id == 0 and distributed.is_coordinator()
    finally:
        worker.send_signal(signal.SIGINT)
        try:
            worker.wait(60)
        except subprocess.TimeoutExpired:
            worker.kill()
            worker.wait(10)
    assert rc == 0 and stats["total_scheduled"] == N_PODS == cluster.bind_count
    routed = stats["client"]["engine"]["fanout_routed"]
    assert len(routed) == 2 and routed[1] >= 1, routed  # the worker host decided
    assert worker.returncode == 0, "".join(lines)[-3000:]


def _run_until(monkeypatch, capsys, argv, first, bound):
    """cli.main(argv) in this thread; a watcher thread runs `first()`, then
    sends SIGINT once `bound()`; (rc, stats)."""
    done = threading.Event()

    def watcher():
        first()
        end = time.monotonic() + WAIT_S
        while not bound() and time.monotonic() < end and not done.is_set():
            done.wait(0.05)
        if not done.is_set():
            os.kill(os.getpid(), signal.SIGINT)

    previous = signal.signal(signal.SIGINT, signal.default_int_handler)
    thread = threading.Thread(target=watcher, daemon=True)
    thread.start()
    try:
        rc = cli.main(argv)
    finally:
        done.set()
        thread.join(timeout=60)
        signal.signal(signal.SIGINT, previous)
    return rc, json.loads(capsys.readouterr().out)
