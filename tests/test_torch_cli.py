"""The port's production entry point on the CPU, held against the JAX
package's stack: `cli run` builds its stack from the config (a YAML file
naming a TINY f32 model, an HF safetensors checkpoint both packages load,
and llm.temperature 0), and binds every pod to the node the JAX stack
(`_build_stack` from the same config) binds it to:

- `cli run --fake-cluster --device cpu` over the in-memory synthetic
  cluster, the JAX stack over its own;
- `cli run --device cpu` over the wire: `KubeCluster` through the in-tree
  REST transport against the port's `WireFakeK8s`, the JAX stack against
  the JAX package's.

Each run ends as a user ends it, with SIGINT, and must exit 0 with the
scheduler's stats JSON on stdout. Also `cli verify` on the CPU and the
demo's help text. Every wait is bounded (WAIT_S)."""

import asyncio
import dataclasses
import json
import os
import signal
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu import cli as jcli
from k8s_llm_scheduler_tpu import config as jconfig
from k8s_llm_scheduler_tpu import testing as jtesting
from k8s_llm_scheduler_tpu.cluster import httpapi as jhttp
from k8s_llm_scheduler_tpu.cluster import kube as jkube
from k8s_llm_scheduler_tpu.cluster import wire_fake as jwire
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.cluster import httpapi as thttp
from k8s_llm_scheduler_tpu_torch.cluster import wire_fake as twire
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs

ttesting.cap_torch_threads()

WAIT_S = 600.0
MODEL = "tiny-f32-cli"  # TINY in f32: the two packages' greedy tokens agree
N_NODES = 4
N_PODS = 6
SNAPSHOT_TTL_S = 3600.0  # one snapshot for the burst: decisions independent of timing


@pytest.fixture(autouse=True)
def _tiny_f32(monkeypatch):
    monkeypatch.setitem(jconfigs._REGISTRY, MODEL,
                        dataclasses.replace(jconfigs.TINY, name=MODEL, dtype=jnp.float32))
    monkeypatch.setitem(tconfigs._REGISTRY, MODEL,
                        dataclasses.replace(tconfigs.TINY, name=MODEL, dtype=torch.float32))


def _hf_checkpoint(path):
    """A TINY HF-layout safetensors checkpoint from a seed."""
    from safetensors.torch import save_file

    cfg = tconfigs.TINY
    rng = np.random.default_rng(5)
    hd, D, F = cfg.head_dim, cfg.d_model, cfg.d_ff
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, D), "model.norm.weight": (D,)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        shapes.update({p + "input_layernorm.weight": (D,),
                       p + "self_attn.q_proj.weight": (cfg.n_heads * hd, D),
                       p + "self_attn.k_proj.weight": (cfg.n_kv_heads * hd, D),
                       p + "self_attn.v_proj.weight": (cfg.n_kv_heads * hd, D),
                       p + "self_attn.o_proj.weight": (D, cfg.n_heads * hd),
                       p + "post_attention_layernorm.weight": (D,),
                       p + "mlp.gate_proj.weight": (F, D),
                       p + "mlp.up_proj.weight": (F, D),
                       p + "mlp.down_proj.weight": (D, F)})
    sd = {}
    for name, shape in shapes.items():
        scale = 0.1 if len(shape) == 1 else shape[-1] ** -0.5
        base = 1.0 if len(shape) == 1 else 0.0
        sd[name] = torch.from_numpy((base + rng.normal(size=shape) * scale).astype(np.float32))
    save_file(sd, str(path / "model.safetensors"))


@pytest.fixture
def config_file(tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    _hf_checkpoint(ckpt)
    path = tmp_path / "config.yaml"
    path.write_text(
        "llm:\n"
        f"  model: {MODEL}\n"
        f"  checkpoint_path: {ckpt}\n"
        "  temperature: 0.0\n"
        "  max_tokens: 80\n"
        "  timeout: 600\n"
        "  fused_decode: false\n"
        "  compile_cache_dir: null\n"
        "observability:\n"
        "  profiler: false\n"
    )
    return path


def _pods(testing):
    return testing.pod_burst(N_PODS, distinct_shapes=N_PODS)


def _jax_placements(cfg_path, cluster, bound):
    """The JAX stack from the same config over `cluster` until `bound()`
    reports every pod bound; returns its stats."""
    cfg = jconfig.load_config(yaml_path=cfg_path, env={})
    scheduler, backend = jcli._build_stack(cfg, cluster)
    scheduler.snapshot_ttl_s = SNAPSHOT_TTL_S

    async def drive():
        task = asyncio.create_task(scheduler.run())
        try:
            async with ttesting.async_deadline(WAIT_S):
                while not bound():
                    await asyncio.sleep(0.05)
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

    try:
        asyncio.run(drive())
    finally:
        backend.close()
    return scheduler.get_stats()


def _port_run(monkeypatch, capsys, argv, bound):
    """cli.main(argv) in this thread, SIGINT once `bound()` (from a watcher
    thread); returns (rc, stats JSON). The port's scheduler is given the
    same one-snapshot TTL as the JAX one."""
    build = cli.build_stack

    def one_snapshot(*args, **kwargs):
        scheduler, backend = build(*args, **kwargs)
        scheduler.snapshot_ttl_s = SNAPSHOT_TTL_S
        return scheduler, backend

    monkeypatch.setattr(cli, "build_stack", one_snapshot)
    done = threading.Event()

    def watcher():
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
    out = capsys.readouterr().out
    return rc, json.loads(out)


def test_cli_run_fake_cluster_binds_where_the_jax_stack_binds(config_file, monkeypatch,
                                                              capsys):
    jcluster = jtesting.synthetic_cluster(N_NODES)
    for pod in _pods(jtesting):
        jcluster.add_pod(pod)
    jstats = _jax_placements(config_file, jcluster, lambda: jcluster.bind_count >= N_PODS)
    want = {p.name: jcluster.get_pod("default", p.name).node_name for p in _pods(jtesting)}

    tcluster = ttesting.synthetic_cluster(N_NODES)
    for pod in _pods(ttesting):
        tcluster.add_pod(pod)
    monkeypatch.setattr(ttesting, "synthetic_cluster", lambda n: tcluster)
    rc, stats = _port_run(monkeypatch, capsys,
                          ["--config", str(config_file), "run", "--fake-cluster",
                           "--fake-nodes", str(N_NODES), "--device", "cpu"],
                          lambda: tcluster.bind_count >= N_PODS)
    got = {p.name: tcluster.get_pod("default", p.name).node_name for p in _pods(ttesting)}
    assert rc == 0
    assert None not in want.values() and got == want
    assert stats["total_scheduled"] == jstats["total_scheduled"] == N_PODS
    assert stats["fallback_decisions"] == 0 and stats["client"]["fallback_decisions"] == 0


def _wire_server(wire, http):
    srv = wire.WireFakeK8s()
    for n in ttesting.synthetic_nodes(N_NODES):
        srv.add_node(n.name, labels=n.labels)
    http.set_active_config(srv.base_url)
    return srv


def _add_wire_pods(srv, testing):
    for pod in _pods(testing):
        srv.add_pod(pod.name, requests=dict(pod.container_requests[0]), priority=pod.priority)


def test_cli_run_over_the_wire_binds_where_the_jax_stack_binds(config_file, monkeypatch,
                                                               capsys, tmp_path):
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "absent"))
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    jsrv = _wire_server(jwire, jhttp)
    try:
        _add_wire_pods(jsrv, jtesting)
        jcluster = jkube.KubeCluster(watch_timeout_seconds=60)
        _jax_placements(config_file, jcluster, lambda: len(jsrv.bindings) >= N_PODS)
        want = {name: node for _, name, node in jsrv.bindings}
    finally:
        jsrv.close()

    tsrv = _wire_server(twire, thttp)
    try:
        _add_wire_pods(tsrv, ttesting)
        rc, stats = _port_run(monkeypatch, capsys,
                              ["--config", str(config_file), "run", "--device", "cpu"],
                              lambda: len(tsrv.bindings) >= N_PODS)
        got = {name: node for _, name, node in tsrv.bindings}
        phases = {name: tsrv.pod(name)["status"]["phase"] for name in got}
    finally:
        tsrv.close()
    assert rc == 0
    assert len(want) == N_PODS and got == want
    assert set(phases.values()) == {"Running"}
    assert stats["total_scheduled"] == N_PODS and stats["fallback_decisions"] == 0


def test_cli_run_without_a_cluster_exits_2(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "absent"))
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.setattr(thttp, "_active", None)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["run", "--device", "cpu"]) == 2
    assert "--fake-cluster" in capsys.readouterr().err


def test_cli_run_refuses_an_unported_switch_before_a_model(monkeypatch, tmp_path, capsys):
    """No switch is unported any more: `distributed.enabled` (a world of one
    process here, so this process is the coordinator) and llm.spec_enabled
    are served. `cli run` builds its backend with a speculative decoder
    attached (it serves generate(); decisions never speculate) and exits 0
    on SIGINT with its stats."""
    from k8s_llm_scheduler_tpu_torch.engine import local as tlocal
    from k8s_llm_scheduler_tpu_torch.parallel import distributed

    monkeypatch.chdir(tmp_path)
    (tmp_path / "config.yaml").write_text(
        "distributed:\n  enabled: true\n  num_processes: 1\n")
    monkeypatch.setenv("SPEC_ENABLED", "true")
    built = []
    real = tlocal.build_local_backend

    def recording(**kwargs):
        built.append(real(**kwargs))
        return built[-1]

    monkeypatch.setattr(tlocal, "build_local_backend", recording)
    rc, stats = _port_run(monkeypatch, capsys,
                          ["run", "--fake-cluster", "--fake-nodes", "2", "--device", "cpu"],
                          lambda: bool(built))
    assert rc == 0 and stats["total_scheduled"] == 0
    assert distributed.world() is None and distributed.is_coordinator()
    spec = built[0].engine.spec
    assert spec is not None and spec.arm == "draft" and spec.k == 4
    assert not built[0].engine.persistent_supported()


def test_cli_verify_fast_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("KUBECONFIG", raising=False)
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert cli.main(["verify", "--fast", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[FAIL]" not in out and "all checks passed" in out
    assert "[ok] import torch" in out and "[ok] cluster access" in out
    if not torch.cuda.is_available():
        # the card's checks run by default, and fail without one
        assert cli.main(["verify", "--fast"]) == 1
        out = capsys.readouterr().out
        assert "[FAIL] CUDA device" in out and "check(s) failed" in out


def test_demo_help_says_it_samples_at_the_config_temperature():
    sub = cli.build_parser()._subparsers._group_actions[0].choices
    text = sub["demo"].description
    assert "0.3" in text and "LLM_TEMPERATURE=0 decodes greedily" in text
