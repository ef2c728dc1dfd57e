"""The port's scheduling loop held against the JAX package's on the CPU: the
same fake cluster and pods through Scheduler + DecisionClient +
LocalLLMBackend on both sides (TINY in f32, greedy, the same weights), every
pod bound to the same node; again with int8 weights and ragged block-decode
matmuls (the K3 twin). Also the backend's advisory prefix install, its
quiesced controls on the real engine, and `cli demo`.

Both loops see one snapshot for the whole burst (pods added before run(),
a snapshot TTL longer than the test), so a pod's decision depends only on
the pod and that snapshot, not on timing.
"""

import asyncio
import copy
import dataclasses
import json
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu import testing as jtesting
from k8s_llm_scheduler_tpu.core.breaker import CircuitBreaker as JBreaker
from k8s_llm_scheduler_tpu.core.cache import DecisionCache as JCache
from k8s_llm_scheduler_tpu.engine.engine import InferenceEngine as JEngine
from k8s_llm_scheduler_tpu.engine.local import LocalLLMBackend as JBackend
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models import quant as jquant
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.sched.client import DecisionClient as JClient
from k8s_llm_scheduler_tpu.sched.loop import Scheduler as JScheduler
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.cluster.interface import raw_pod_to_spec
from k8s_llm_scheduler_tpu_torch.config import DEFAULTS, Config
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine as TEngine
from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend as TBackend
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax

ttesting.cap_torch_threads()

REPO = Path(__file__).resolve().parent.parent
JTINY = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TTINY = dataclasses.replace(tconfigs.TINY, dtype=torch.float32)
N_NODES = 4
SNAPSHOT_TTL_S = 3600.0  # one snapshot for the whole burst
TIMEOUT_S = 600.0  # a slow first wave must never turn into a retry
MAX_NEW = 80  # at most 12 reasoning tokens: short decisions keep the file quick
DEFAULT_CONFIG = Config(copy.deepcopy(DEFAULTS))  # the config's defaults: no file, no env


def _pods(testing):
    return testing.fixture_pods() if testing is jtesting else testing.fixture_raw_pods()


def _burst(testing):
    return _pods(testing) + testing.pod_burst(12, distinct_shapes=4)


async def _drive(scheduler, cluster, n_pods):
    """Run the loop until n_pods are bound; stop it and await its task, all
    under a deadline, so that a hang fails in seconds."""
    task = asyncio.create_task(scheduler.run())
    try:
        async with ttesting.async_deadline(300):
            while cluster.bind_count < n_pods:
                await asyncio.sleep(0.02)
            # in-flight scheduling tasks finish before stop(): one that finishes as
            # run() returns leaves drain() spinning without yielding (Python 3.12's
            # eager gather; ROADMAP queue 3 item 2), where no deadline can fire
            while scheduler._tasks:
                await asyncio.sleep(0.01)
    finally:
        scheduler.stop()
        cluster.close()
        async with ttesting.async_deadline(60):
            await task


def _run(testing, make_scheduler):
    """The burst on a fresh 4-node cluster; returns ({pod: node}, stats)."""
    cluster = testing.synthetic_cluster(N_NODES)
    pods = _burst(testing)
    for pod in pods:
        cluster.add_pod(pod)
    scheduler = make_scheduler(cluster)
    asyncio.run(_drive(scheduler, cluster, len(pods)))
    placed = {p.name: cluster.get_pod("default", p.name).node_name for p in pods}
    return placed, scheduler.get_stats()


def _jax_loop(jp, decode_matmul):
    backend = JBackend(
        JEngine(jp, JTINY, JByteTokenizer(), num_pages=16, page_size=64,
                max_pages_per_seq=8, temperature=0.0, decode_matmul=decode_matmul),
        max_new_tokens=MAX_NEW, packed_admission=False,
        prewarm_idle_delay_s=TIMEOUT_S, request_timeout_s=TIMEOUT_S,
    )

    def make(cluster):
        client = JClient(backend, cache=JCache(), breaker=JBreaker())
        return JScheduler(cluster, cluster, client,
                          scheduler_name=jtesting.SCHEDULER_NAME,
                          snapshot_ttl_s=SNAPSHOT_TTL_S)

    try:
        return _run(jtesting, make)
    finally:
        backend.close()


def _torch_backend(tp, decode_matmul="dense"):
    return TBackend(
        TEngine(tp, TTINY, ByteTokenizer(), temperature=0.0, decode_matmul=decode_matmul),
        max_new_tokens=MAX_NEW, prewarm_idle_delay_s=TIMEOUT_S,
        request_timeout_s=TIMEOUT_S,
    )


def _torch_loop(tp, decode_matmul):
    backend = _torch_backend(tp, decode_matmul)
    try:
        placed, stats = _run(
            ttesting,
            lambda cluster: cli.build_stack(DEFAULT_CONFIG, cluster, backend=backend,
                                            snapshot_ttl_s=SNAPSHOT_TTL_S)[0],
        )
        return placed, stats, dict(backend.counters)
    finally:
        backend.close()


@pytest.fixture(scope="module")
def tiny_params():
    jp = jinit_params(jax.random.PRNGKey(0), JTINY)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _no_fallback(stats):
    client = stats["client"]
    return (stats["fallback_decisions"] == 0 and client["fallback_decisions"] == 0
            and client["failed_requests"] == 0 and client["invalid_decisions"] == 0)


@pytest.mark.parametrize("weights", ["f32", "int8-ragged"])
def test_loop_binds_every_pod_where_the_jax_loop_does(tiny_params, weights):
    jp, tp = tiny_params
    decode_matmul = "dense"
    if weights == "int8-ragged":
        jp = jquant.quantize_params(jp)
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        decode_matmul = "ragged"
    want, jstats = _jax_loop(jp, decode_matmul)
    got, tstats, calls = _torch_loop(tp, decode_matmul)

    node_names = {f"node-{i}" for i in range(N_NODES)}
    assert len(got) == 15 and set(got.values()) <= node_names
    assert got == want
    assert _no_fallback(jstats) and _no_fallback(tstats)
    assert tstats["total_scheduled"] == jstats["total_scheduled"] == 15
    assert tstats["llm_decisions"] == jstats["llm_decisions"] > 0
    # every LLM decision went through the native async call, none through
    # a to_thread pool thread, and no call raised (so none was retried)
    assert calls["async_calls"] == tstats["llm_decisions"]
    assert calls["sync_calls"] == 0
    assert tstats["client"]["successful_requests"] == calls["async_calls"]
    assert tstats["client"]["circuit_breaker"]["state"] == "closed"


def test_prewarm_installs_the_group_a_real_decision_uses(tiny_params):
    """The stand-in suffix of prewarm_prefix lands on the exact group key a
    real pod of that snapshot produces (JAX tests/test_llm_e2e.py:134)."""
    backend = _torch_backend(tiny_params[1])
    try:
        cluster = ttesting.synthetic_cluster(3)
        nodes = cluster.get_node_metrics()
        cluster.close()
        assert backend.prewarm_prefix(nodes).result(timeout=120) is True
        pod = raw_pod_to_spec(ttesting.pod_burst(1)[0])
        item = backend._prepare_item(pod, nodes)
        assert backend._current_group == item.group_key
        d = backend.get_scheduling_decision(pod, nodes)
        assert d.selected_node in {n.name for n in nodes}
        assert backend._current_group == item.group_key
        # same snapshot again: a no-op True
        assert backend.prewarm_prefix(nodes).result(timeout=30) is True
        stats = backend.get_stats()
        assert stats["backend"]["group_installs"] == 1
        assert stats["backend"]["prewarms_installed"] == 1
        assert stats["prefix_prefills"] == 1
        # a snapshot with no ready node resolves False at once
        down = [dataclasses.replace(n, conditions={"Ready": "False"}) for n in nodes]
        assert backend.prewarm_prefix(down).result(timeout=1) is False
    finally:
        backend.close()


def test_run_quiesced_runs_on_the_worker_and_reinstalls_the_group(tiny_params):
    backend = _torch_backend(tiny_params[1])
    nodes = ttesting.synthetic_nodes(N_NODES)
    pod = ttesting.fixture_pods(1)[0]
    try:
        first = backend.get_scheduling_decision(pod, nodes)
        assert backend.counters["group_installs"] == 1
        result, pause_s = backend.run_quiesced(
            lambda: threading.current_thread().name, timeout_s=120)
        assert result == "llm-engine" and pause_s > 0
        assert backend.swap_stats["quiesce_runs"] == 1
        assert backend.get_stats()["swap"]["quiesce_runs"] == 1
        again = backend.get_scheduling_decision(pod, nodes)
        # the control dropped the group: the next wave reinstalled it (from
        # the engine's prefix cache), and decided as before
        assert backend.counters["group_installs"] == 2
        assert backend.engine.stats["prefix_prefills"] == 1
        assert again == first
    finally:
        backend.close()


def _demo(*args, timeout=300):
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": str(REPO),
           "OMP_NUM_THREADS": "2"}
    return subprocess.run(
        [sys.executable, "-m", "k8s_llm_scheduler_tpu_torch.cli", "demo", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout,
    )


def test_cli_demo_binds_the_fixture_pods_on_the_cpu():
    out = _demo("--device", "cpu", "--model", "tiny", "--fake-nodes", "4")
    assert out.returncode == 0, out.stderr[-2000:]
    stats = json.loads(out.stdout)
    assert stats["total_scheduled"] == 3
    assert stats["fallback_decisions"] == 0
    assert stats["client"]["fallback_decisions"] == 0
    assert stats["client"]["engine"]["backend"]["async_calls"] == stats["llm_decisions"]


def test_cli_demo_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _demo("--model", "tiny", timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert cli.build_parser().parse_args(["demo"]).device == "cuda"
    assert cli.build_parser().parse_args(["demo"]).model is None  # llm.model decides
    assert DEFAULT_CONFIG.get("llm.model") == "llama-3.2-1b-instruct"


def test_drain_returns_when_a_finished_task_is_still_tracked():
    """A task that has finished but whose done callback (its discard from
    the scheduler's task set) has not run yet: the reference's drain()
    gathers it forever without yielding (Python 3.12 completes the gather
    eagerly); the port's yields, the callback runs and drain returns."""
    from k8s_llm_scheduler_tpu_torch.sched.loop import Scheduler

    scheduler = Scheduler(ttesting.synthetic_cluster(1), None, None)
    out = {}

    async def main():
        async def noop():
            return None

        task = asyncio.create_task(noop())
        scheduler._tasks.add(task)
        task.add_done_callback(scheduler._tasks.discard)
        await asyncio.sleep(0)  # the task finishes; its callback is only queued
        out["tracked_done"] = task.done() and task in scheduler._tasks
        await scheduler.drain()
        out["drained"] = not scheduler._tasks

    runner = threading.Thread(target=lambda: asyncio.run(main()), daemon=True)
    runner.start()
    runner.join(30)
    assert not runner.is_alive(), "drain() never returned"
    assert out == {"tracked_done": True, "drained": True}
