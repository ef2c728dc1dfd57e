"""The port's fleet and replicas on one host (sched/replica.py,
sched/router.py, fleet/, observability/fleetview.py, the pool role of
engine/local.py, `cli fleet`, and `build_stack`'s wrappers) held against
the JAX package's on the CPU.

- Wire interop both ways over StubBackend: a port ReplicaServer answers a
  JAX ReplicaClient and a JAX ReplicaServer answers a port ReplicaClient
  (single and batched decisions, an infeasible pod, prewarm, telemetry).
- FanoutBackend over a TINY f32 backend (greedy) and a ReplicaClient of a
  server over the same backend, and RoutedBackend over two TINY f32
  backends (seeds 0 and 1): the decisions are token-identical to the JAX
  package's wrappers over the JAX engines on the same weights, and
  `classify_decision` gives the same classes.
- `build_stack` wraps in the JAX order: the fan-out, then the pools, then
  the router outermost; each switch alone builds its wrapper; `rollout
  watch` builds none of them, as the JAX watch does.
- A second backend over one engine: once it has installed its own group,
  the first reinstalls its own before its next wave.
- `LocalLLMBackend(pool_role=...)` refuses the work the JAX backend
  refuses, on every decision entry point.
- `cli fleet demo` binds every pod once, as the JAX demo does; `cli fleet
  shard` prints the JAX shard; `cli fleet top --once` reads a live port
  server; `kvplane` and `autoscale` print the JAX CLI's records, and
  `demo` with `fleet.kvplane.enabled` shows the plane's gauges.
- `_run_worker_replica` serves decisions until its stop event is set.

Every server is closed in a `finally`; every wait has a timeout; sockets
bind port 0 on 127.0.0.1.
"""

import asyncio
import copy
import dataclasses
import json
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu import cli as jcli
from k8s_llm_scheduler_tpu import testing as jtesting
from k8s_llm_scheduler_tpu import types as jtypes
from k8s_llm_scheduler_tpu.engine import backend as jbackend
from k8s_llm_scheduler_tpu.engine.engine import InferenceEngine as JEngine
from k8s_llm_scheduler_tpu.engine.local import LocalLLMBackend as JLocal
from k8s_llm_scheduler_tpu.engine.sharded import FleetGeometry as JGeometry
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.sched import replica as jreplica
from k8s_llm_scheduler_tpu.sched import router as jrouter
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch import types as ttypes
from k8s_llm_scheduler_tpu_torch.config import DEFAULTS, Config
from k8s_llm_scheduler_tpu_torch.engine import backend as tbackend
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine as TEngine
from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend as TLocal
from k8s_llm_scheduler_tpu_torch.engine.sharded import FleetGeometry as TGeometry
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.fleet import DisaggregatedBackend
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.sched import replica as treplica
from k8s_llm_scheduler_tpu_torch.sched import router as trouter

ttesting.cap_torch_threads()

WAIT_S = 120.0  # bound on every wait for a thread, a server or a future
JTINY = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TTINY = dataclasses.replace(tconfigs.TINY, dtype=torch.float32)
MAX_NEW = 80
REASON_TOKENS = 8
N_NODES = 4

SIDES = {
    "jax": SimpleNamespace(replica=jreplica, router=jrouter, backend=jbackend,
                           testing=jtesting, types=jtypes, cli=jcli),
    "torch": SimpleNamespace(replica=treplica, router=trouter, backend=tbackend,
                             testing=ttesting, types=ttypes, cli=cli),
}


def _cfg(**dotted):
    cfg = Config(copy.deepcopy(DEFAULTS))
    for key, value in dotted.items():
        node = cfg.data
        *parents, leaf = key.split(".")
        for part in parents:
            node = node[part]
        node[leaf] = value
    return cfg


def _pod_pairs(n):
    """The same pods as each package's PodSpec."""
    pods = ttesting.fixture_pods(n)
    return [(jtypes.PodSpec(**dataclasses.asdict(p)), p) for p in pods]


def _nodes(side, n=N_NODES):
    t = ttesting.synthetic_nodes(n)
    if side == "torch":
        return t
    return [jtypes.NodeMetrics(**dataclasses.asdict(x)) for x in t]


def _decision(d):
    return (d.selected_node, d.confidence, d.reasoning, d.source.value)


# ------------------------------------------------------------------- wire
@pytest.mark.parametrize("server_side,client_side", [("torch", "jax"), ("jax", "torch")],
                         ids=["port server, jax client", "jax server, port client"])
def test_wire_interop_over_the_stub(server_side, client_side):
    srv_ns, cli_ns = SIDES[server_side], SIDES[client_side]
    server = srv_ns.replica.ReplicaServer(srv_ns.backend.StubBackend(), host="127.0.0.1",
                                          port=0)
    client = cli_ns.replica.ReplicaClient("127.0.0.1", server.port, request_timeout_s=WAIT_S)
    try:
        nodes = _nodes(client_side)
        pods = [p[0] if client_side == "jax" else p[1] for p in _pod_pairs(4)]
        local = cli_ns.backend.StubBackend()
        for pod in pods:
            got = client.get_scheduling_decision(pod, nodes)
            assert _decision(got) == _decision(local.get_scheduling_decision(pod, nodes))
        infeasible = dataclasses.replace(pods[0], node_selector={"zone": "nowhere"})
        batch = client.get_scheduling_decisions_batch(pods[:2] + [infeasible], nodes)
        assert [_decision(d) for d in batch[:2]] == [
            _decision(local.get_scheduling_decision(p, nodes)) for p in pods[:2]]
        assert isinstance(batch[2], cli_ns.backend.NoFeasibleNodeError)
        with pytest.raises(cli_ns.backend.NoFeasibleNodeError):
            client.get_scheduling_decision(infeasible, nodes)
        # the stub has no prefix cache: the worker answers the prewarm False
        assert client.prewarm_prefix(nodes).result(timeout=WAIT_S) is False
        telemetry = client.telemetry_pull(timeout_s=WAIT_S)
        assert "stats" in telemetry
        assert server.served >= len(pods) + 1
    finally:
        client.close()
        server.close()


# ------------------------------------------------------- engines at TINY
@pytest.fixture(scope="module")
def backends():
    """For each package: TINY f32 greedy backends on the seed-0 and seed-1
    JAX weights (the port's converted), and a replica server over the
    seed-0 one."""
    out = {}
    params = {s: jax.tree_util.tree_map(np.asarray, jinit_params(jax.random.PRNGKey(s), JTINY))
              for s in (0, 1)}
    common = dict(max_new_tokens=MAX_NEW, max_reason_tokens=REASON_TOKENS,
                  packed_admission=False, prewarm_idle_delay_s=1e6,
                  request_timeout_s=WAIT_S)
    made = []
    try:
        for side in SIDES:
            pair = []
            for s in (0, 1):
                if side == "jax":
                    eng = JEngine(jax.tree_util.tree_map(jnp.asarray, params[s]), JTINY,
                                  JByteTokenizer(), num_pages=16, page_size=64,
                                  max_pages_per_seq=8, temperature=0.0)
                    pair.append(JLocal(eng, **common))
                else:
                    eng = TEngine(params_from_jax(params[s], device="cpu"), TTINY,
                                  ByteTokenizer(), temperature=0.0)
                    pair.append(TLocal(eng, **common))
                made.append(pair[-1])
            server = SIDES[side].replica.ReplicaServer(pair[0], host="127.0.0.1", port=0)
            made.append(server)
            out[side] = SimpleNamespace(big=pair[0], fast=pair[1], server=server)
        yield out
    finally:
        for obj in reversed(made):
            obj.close()


def test_fanout_decisions_are_token_identical_to_the_jax_fanout(backends):
    got = {}
    for side, ns in SIDES.items():
        b = backends[side]
        client = ns.replica.ReplicaClient("127.0.0.1", b.server.port, request_timeout_s=WAIT_S)
        fan = ns.replica.FanoutBackend([b.big, client])
        try:
            nodes = _nodes(side)
            pods = [p[0] if side == "jax" else p[1] for p in _pod_pairs(2)]
            decisions = [_decision(fan.get_scheduling_decision(p, nodes)) for p in pods]

            async def concurrent():
                return await asyncio.wait_for(asyncio.gather(*(
                    fan.get_scheduling_decision_async(p, nodes) for p in pods)), WAIT_S)

            decisions += [_decision(d) for d in asyncio.run(concurrent())]
            got[side] = (decisions, sum(fan.get_stats()["fanout_routed"]))
        finally:
            client.close()
    assert got["torch"] == got["jax"]
    decisions, routed = got["torch"]
    assert routed == 4 and decisions[:2] == decisions[2:]
    assert all(d[0].startswith("node-") for d in decisions)


def test_routed_decisions_and_classes_match_the_jax_router(backends):
    got = {}
    for side, ns in SIDES.items():
        b = backends[side]
        policy = ns.router.RouterPolicy(big_cold_extra_ms=1000.0, complexity_threshold=1)
        routed = ns.router.RoutedBackend(b.big, b.fast, policy, owned=False)
        nodes = _nodes(side)
        pods = [p[0] if side == "jax" else p[1] for p in _pod_pairs(4)]
        warm = ns.router._WarmDigests(policy.warm_snapshots)
        classes = []
        for pod in pods:
            classes.append(ns.router.classify_decision(pod, nodes, policy=policy, warm=warm))
            if classes[-1][0] == ns.router.ROUTE_BIG or classes[-1][1] == "cold_snapshot":
                warm.note(ns.router._nodes_digest(nodes))
        decisions = [_decision(routed.get_scheduling_decision(p, nodes)) for p in pods]
        stats = routed.get_stats()["router"]
        got[side] = (classes, decisions, stats)
    assert got["torch"] == got["jax"]
    classes, decisions, stats = got["torch"]
    assert [c[0] for c in classes] == ["fast", "fast", "fast", "big"]
    assert classes[0][1] == "cold_snapshot" and stats["cold_prewarms"] == 1
    assert stats["routed_big"] == 1 and stats["routed_fast"] == 3


def test_a_second_backend_over_the_engine_does_not_leave_the_first_stale(backends):
    """Two backends over one engine, one after the other: once the second
    has installed its own (prefix, grammar) group, the first reinstalls its
    group before its next wave, and decides as the JAX backend does."""
    first = backends["torch"].big
    second = TLocal(first.engine, max_new_tokens=MAX_NEW, max_reason_tokens=REASON_TOKENS,
                    packed_admission=False, prewarm_idle_delay_s=1e6,
                    request_timeout_s=WAIT_S)
    jpod, pod = _pod_pairs(1)[0]
    nodes = _nodes("torch")
    try:
        before = _decision(first.get_scheduling_decision(pod, nodes))
        installs = first.get_stats()["backend"]["group_installs"]
        second.get_scheduling_decision(pod, ttesting.synthetic_nodes(N_NODES + 3))
        after = _decision(first.get_scheduling_decision(pod, nodes))
        assert first.get_stats()["backend"]["group_installs"] == installs + 1
    finally:
        second.close()
    want = _decision(backends["jax"].big.get_scheduling_decision(jpod, _nodes("jax")))
    assert after == before == want


# ------------------------------------------------------------------ stack
def _names(backend):
    """The wrapper chain as type names, outermost first."""
    name = type(backend).__name__
    if name == "RoutedBackend":
        return [name, _names(backend.big), type(backend.fast).__name__]
    if name == "DisaggregatedBackend":
        return [name, [_names(m) for m in backend.prefill_pool],
                [type(m).__name__ for m in backend.decode_pool]]
    if name == "FanoutBackend":
        return [name, [type(r).__name__ for r in backend.replicas]]
    return name


def test_build_stack_wraps_in_the_jax_order(monkeypatch):
    server = treplica.ReplicaServer(tbackend.StubBackend(), host="127.0.0.1", port=0)
    addr = f"127.0.0.1:{server.port}"
    switches = {"distributed.replica_addrs": [addr], "fleet.enabled": True,
                "fleet.decode_addrs": [addr], "router.enabled": True,
                "router.fast_model": "tiny", "router.complexity_threshold": 1}
    stacks = []
    try:
        scheduler, backend = cli.build_stack(_cfg(**switches), ttesting.synthetic_cluster(2),
                                             backend=tbackend.StubBackend(), device="cpu")
        stacks.append(backend)
        assert backend.fast.engine.device.type == "cpu"
        assert type(backend.fast.tokenizer).__name__ == "NumericTokenizer"
        # the JAX _build_stack over the same switches, its local model a stub
        from k8s_llm_scheduler_tpu.engine import local as jlocal

        monkeypatch.setattr(jlocal, "build_local_backend", lambda **kw: jbackend.StubBackend())
        jcfg = jcli.load_config(yaml_path=None)
        for key, value in switches.items():
            node = jcfg.data
            *parents, leaf = key.split(".")
            for part in parents:
                node = node[part]
            node[leaf] = value
        _, jstack = jcli._build_stack(jcfg, jtesting.synthetic_cluster(2))
        stacks.append(jstack)
        chain = ["RoutedBackend",
                 ["DisaggregatedBackend",
                  [["FanoutBackend", ["StubBackend", "ReplicaClient"]]], ["ReplicaClient"]]]
        assert _names(backend)[:2] == _names(jstack)[:2] == chain
        assert _names(backend)[2] == "LocalLLMBackend" and _names(jstack)[2] == "StubBackend"
        # a priority pod routes big, through the pools and the fan-out
        pod = ttesting.fixture_pods(4)[3]
        decision = scheduler.client.backend.get_scheduling_decision(
            pod, ttesting.synthetic_nodes(3))
        assert decision.selected_node.startswith("node-")
        assert backend.get_stats()["router"]["routed_big"] == 1
    finally:
        for stack in stacks:
            stack.close()
        server.close()


@pytest.mark.parametrize("switch", ["distributed.replica_addrs", "router.enabled",
                                    "fleet.enabled+addrs"])
def test_each_fleet_switch_builds_its_wrapper(switch):
    """The switches refused before this slice build their wrappers now; a
    tp `llm.mesh` (tensor-parallel serving) reaches build_local_backend."""
    server = treplica.ReplicaServer(tbackend.StubBackend(), host="127.0.0.1", port=0)
    addr = f"127.0.0.1:{server.port}"
    dotted, want = {
        "distributed.replica_addrs": ({"distributed.replica_addrs": [addr]}, "FanoutBackend"),
        "router.enabled": ({"router.enabled": True}, "RoutedBackend"),
        "fleet.enabled+addrs": ({"fleet.enabled": True, "fleet.prefill_addrs": [addr]},
                                "DisaggregatedBackend"),
    }[switch]
    backend = None
    try:
        _, backend = cli.build_stack(_cfg(**dotted), ttesting.synthetic_cluster(2),
                                     backend=tbackend.StubBackend(), device="cpu")
        assert type(backend).__name__ == want
        assert cli._backend_kwargs(_cfg(**{**dotted, "llm.mesh": {"tp": 2}}))[
            "mesh_axes"] == {"tp": 2}
    finally:
        if backend is not None:
            backend.close()
        server.close()


class _StackBuilt(Exception):
    pass


def test_rollout_watch_serves_its_backend_unwrapped(tmp_path, monkeypatch):
    """`rollout watch` under the fan-out, pool and router switches builds
    its client over the backend it hot-swaps, as the JAX watch does: no
    wrapper is built, and no fast arm."""
    config = tmp_path / "config.yaml"
    config.write_text(
        "llm:\n  model: tiny\n  compile_cache_dir: null\n"
        "distributed:\n  replica_addrs: ['127.0.0.1:1']\n"
        "fleet:\n  enabled: true\n  prefill_addrs: ['127.0.0.1:1']\n"
        "router:\n  enabled: true\n")
    for name in ("_maybe_fanout", "_maybe_disaggregate", "_maybe_router"):
        monkeypatch.setattr(cli, name, lambda *a, name=name, **k: pytest.fail(f"{name} called"))
    build = cli.build_stack
    built = {}

    def stop_after_build(*args, **kwargs):
        built["stack"] = build(*args, **kwargs)
        built["backend"] = kwargs["backend"]
        raise _StackBuilt

    monkeypatch.setattr(cli, "build_stack", stop_after_build)
    try:
        with pytest.raises(_StackBuilt):
            cli.main(["--config", str(config), "rollout", "watch", "--registry",
                      str(tmp_path / "reg"), "--fake-cluster", "--device", "cpu"])
        scheduler, backend = built["stack"]
        assert backend is built["backend"] is scheduler.client.backend
        assert type(backend).__name__ == "LocalLLMBackend"
        assert backend.engine.device.type == "cpu"
    finally:
        if "backend" in built:
            built["backend"].close()


@pytest.mark.parametrize("text", ["9901", "host", "host:7", "[::1]:9", "[::1]", "::1",
                                  "[::1", "[::1]x", "h:x", ":5"])
def test_replica_addresses_parse_as_the_jax_cli_parses_them(text):
    def parse(fn):
        try:
            return fn(text, 9901, "k")
        except ValueError as exc:
            return ("error", str(exc))

    assert parse(cli._parse_replica_addr) == parse(jcli._parse_replica_addr)


def test_run_worker_replica_serves_until_stopped():
    stop, ready = threading.Event(), threading.Event()
    cfg = _cfg(**{"llm.backend": "stub", "distributed.replica_port": 0,
                  "distributed.replica_bind_host": "127.0.0.1"})
    result = {}
    worker = threading.Thread(
        target=lambda: result.update(rc=cli._run_worker_replica(cfg, stop, ready)),
        daemon=True)
    worker.start()
    client = None
    try:
        assert ready.wait(WAIT_S)
        client = treplica.ReplicaClient("127.0.0.1", ready.port, request_timeout_s=WAIT_S)
        pod, nodes = ttesting.fixture_pods(1)[0], ttesting.synthetic_nodes(3)
        assert _decision(client.get_scheduling_decision(pod, nodes)) == _decision(
            tbackend.StubBackend().get_scheduling_decision(pod, nodes))
    finally:
        if client is not None:
            client.close()
        stop.set()
        worker.join(WAIT_S)
    assert not worker.is_alive() and result["rc"] == 0


# -------------------------------------------------------------- pool role
class _Handle:
    def __init__(self, n):
        self.n = n
        self.submitted_at = time.perf_counter()
        self.cold_compile = False
        self.geo_key = ("fake", n)

    def is_ready(self):
        return True


class _FakeEngine:
    """Every wave finishes at once with one decision JSON a row."""

    max_slots = 4
    prefill_buckets = (4096,)

    def set_prefix(self, ids):
        pass

    def set_grammar(self, dfa):
        pass

    def submit_wave(self, prompts, max_new_tokens):
        return _Handle(len(prompts))

    def harvest_wave(self, handle):
        text = json.dumps({"selected_node": "node-1", "confidence": 0.9, "reasoning": "x"})
        return [SimpleNamespace(text=text, token_ids=[1]) for _ in range(handle.n)]

    def get_stats(self):
        return {}

    def prewarm_wave_siblings(self, limit=None):
        return 0


def _role_outcomes(side, role):
    ns = SIDES[side]
    local = JLocal if side == "jax" else TLocal
    tok = JByteTokenizer() if side == "jax" else ByteTokenizer()
    backend = local(_FakeEngine(), tokenizer=tok, pool_role=role, request_timeout_s=WAIT_S)
    nodes = _nodes(side, 3)
    pod = _pod_pairs(1)[0][0 if side == "jax" else 1]

    def outcome(fn):
        try:
            out = fn()
            out = out if isinstance(out, list) else [out]
            return [d.selected_node if hasattr(d, "selected_node") else type(d).__name__
                    for d in out]
        except ns.backend.BackendError as exc:
            return ("refused", str(exc))

    async def async_call(work):
        return await asyncio.wait_for(
            backend.get_scheduling_decision_async(pod, nodes, work=work), WAIT_S)

    try:
        got = []
        for work in ("prefill", "decode"):
            got.append(outcome(lambda: backend.get_scheduling_decision(pod, nodes, work=work)))
            got.append(outcome(lambda: asyncio.run(async_call(work))))
            got.append(outcome(
                lambda: backend.get_scheduling_decisions_batch([pod], nodes, work=work)))
        stats = backend.get_stats()
        got.append({k: stats.get(k) for k in ("pool_role", "role_refusals")})
        got.append(backend.role_refusals)
        return got
    finally:
        backend.close()


@pytest.mark.parametrize("role", ["decode", "prefill", "mixed"])
def test_pool_role_refuses_the_work_the_jax_backend_refuses(role):
    got, want = _role_outcomes("torch", role), _role_outcomes("jax", role)
    assert got == want
    refused = [o for o in got[:6] if isinstance(o, tuple)]
    assert len(refused) == (3 if role == "decode" else 0)
    with pytest.raises(ValueError, match="pool_role"):
        TLocal(_FakeEngine(), tokenizer=ByteTokenizer(), pool_role="both")


def test_role_refusals_stay_exact_under_concurrent_callers():
    """Refusals are counted from the callers' threads: 16 threads against a
    decode-role backend at a switch interval of 1e-6 s lose no count."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    backend = TLocal(_FakeEngine(), tokenizer=ByteTokenizer(), pool_role="decode")
    pod, nodes = ttesting.fixture_pods(1)[0], ttesting.synthetic_nodes(3)

    def refuse(_):
        for _ in range(200):
            with pytest.raises(tbackend.BackendError):
                backend.get_scheduling_decision(pod, nodes)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            for fut in [pool.submit(refuse, i) for i in range(16)]:
                fut.result(timeout=WAIT_S)
    finally:
        sys.setswitchinterval(interval)
        backend.close()
    assert backend.role_refusals == backend.get_stats()["role_refusals"] == 16 * 200


def test_geometry_resolves_a_port_engine_to_one_device():
    members = [TLocal(_FakeEngine(), tokenizer=ByteTokenizer()), tbackend.StubBackend(),
               SimpleNamespace(slice_tp=2)]
    try:
        geo = TGeometry.of(members)
        assert geo.tp_sizes == JGeometry.of(members).tp_sizes == (1, 1, 2)
        assert geo.split_for_device_share(0.5) == JGeometry.of(members).split_for_device_share(0.5)
    finally:
        members[0].close()


def test_disaggregated_pools_route_admission_to_the_prefill_pool():
    prefill = [tbackend.StubBackend(pool_role="prefill")]
    decode = [tbackend.StubBackend(pool_role="decode")]
    pools = DisaggregatedBackend(prefill, decode)
    try:
        pod, nodes = ttesting.fixture_pods(1)[0], ttesting.synthetic_nodes(3)
        assert pools.get_scheduling_decision(pod, nodes).selected_node.startswith("node-")
        assert prefill[0].calls == 1 and decode[0].role_refusals == 0
    finally:
        pools.close()


# -------------------------------------------------------------------- cli
def _main(side, argv, capsys):
    rc = SIDES[side].cli.main(argv)
    return rc, capsys.readouterr().out


def test_cli_fleet_demo_binds_every_pod_once(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["fleet", "demo", "--json", "--pods", "40", "--nodes", "6", "--shapes", "8",
            "--replicas", "3"]
    out = {}
    for side in SIDES:
        rc, text = _main(side, argv, capsys)
        stats = json.loads(text.strip().splitlines()[-1])
        out[side] = (rc, stats["total_scheduled"], stats["bind_count"], stats["n_shards"],
                     stats["n_replicas"], stats["failed_bindings"], stats["fenced_binds"],
                     sorted(s for r in stats["replicas"] for s in r["owned_shards"]))
    assert out["torch"] == out["jax"]
    rc, scheduled, bound, n_shards, replicas, failed, fenced, shards = out["torch"]
    assert rc == 0 and scheduled == bound == 40 and replicas == 3
    assert failed == fenced == 0 and shards == list(range(n_shards))


@pytest.mark.parametrize("pod,n", [("default/web-1", None), ("kube-system/dns", 7),
                                   ("bare", 32), ("ns/a/b", 3)])
def test_cli_fleet_shard_prints_the_jax_shard(pod, n, capsys):
    argv = ["fleet", "shard", pod] + ([] if n is None else ["--n-shards", str(n)])
    assert _main("torch", argv, capsys) == _main("jax", argv, capsys)


def test_cli_fleet_top_reads_live_replica_servers(capsys):
    servers = [treplica.ReplicaServer(tbackend.StubBackend(), host="127.0.0.1", port=0)
               for _ in range(2)]
    try:
        addrs = ",".join(f"127.0.0.1:{s.port}" for s in servers)
        pod, nodes = ttesting.fixture_pods(1)[0], ttesting.synthetic_nodes(3)
        client = treplica.ReplicaClient("127.0.0.1", servers[0].port, request_timeout_s=WAIT_S)
        try:
            client.get_scheduling_decision(pod, nodes)
        finally:
            client.close()
        for side in SIDES:
            rc, text = _main(side, ["fleet", "top", "--once", "--replicas", addrs], capsys)
            assert rc == 0 and all(f"127.0.0.1:{s.port}" in text for s in servers)
        prom = [_main(side, ["fleet", "top", "--once", "--format", "prom",
                             "--replicas", addrs], capsys) for side in SIDES]
        assert prom[0] == prom[1] and prom[0][0] == 0
        assert _main("torch", ["fleet", "top", "--once"], capsys)[0] == 2
    finally:
        for s in servers:
            s.close()


@pytest.mark.parametrize("argv,item", [(["fleet", "kvplane"], "9b"),
                                       (["fleet", "autoscale"], "10c")])
def test_cli_fleet_kvplane_and_autoscale_name_their_roadmap_items(argv, item, tmp_path,
                                                                  monkeypatch, capsys):
    """The ROADMAP items these commands waited for are ported: no switch
    cites them, and each prints the JAX CLI's record (autoscale's lease
    book aside: the demo's real-time drain loop paces its fence checks)."""
    monkeypatch.chdir(tmp_path)
    records = []
    for side in SIDES:
        rc, text = _main(side, argv + ["--json"], capsys)
        record = json.loads(text.strip().splitlines()[-1])
        record.pop("lease", None)
        records.append((rc, record))
    assert records[0] == records[1] and records[0][0] == 0


def test_cli_fleet_demo_refuses_the_kv_plane(tmp_path, monkeypatch, capsys):
    """With fleet.kvplane.enabled the demo runs beside one shared plane (the
    stub replicas pin nothing, so its gauges stay at zero), binding every
    pod once, as the JAX demo does."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("FLEET_KVPLANE_ENABLED", "true")
    out = []
    for side in SIDES:
        rc, text = _main(side, ["fleet", "demo", "--json", "--pods", "8", "--nodes", "4"],
                         capsys)
        stats = json.loads(text.strip().splitlines()[-1])
        out.append((rc, stats["total_scheduled"], stats["bind_count"], stats["kvplane"]))
    assert out[0] == out[1]
    assert out[0][:3] == (0, 8, 8) and out[0][3]["generation"] == 0
