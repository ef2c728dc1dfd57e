"""The tp > 1 paths of the port's engine held against the JAX engine on a
tp=2 mesh of the CPU devices (tests/conftest.py forces 8), at f32 and
greedy: the hot swap (rollout/hotswap.HotSwapper(mesh=), each rank
restoring its own block) and the shared prefix-KV plane (a whole-model
page set gathered from the ranks, adopted a head block a rank); the
persistent loop (the driver's resident thread deciding every iteration)
against the JAX engine off the mesh (`jax_resident` says why).
Every port engine here is a tp=2 group: this process is the driver, one
spawned interpreter the follower, over gloo.

Three groups are built: one serves the swap and the plane (delta prompts
on, so the backend pins), one the persistent loop (its wedge test last,
since the latch holds), and one is killed mid-residency. The micro config
is served under its name from this process's registry and its weights
from a registry of native checkpoints (v1 seed 0, v2 seed 1).
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu.engine.engine import InferenceEngine as JEngine
from k8s_llm_scheduler_tpu.engine.local import LocalLLMBackend as JBackend
from k8s_llm_scheduler_tpu.engine.sharded import serving_param_specs as jserving_specs
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu.fleet import kvplane as jkv
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.parallel.mesh import make_mesh as jmake_mesh
from k8s_llm_scheduler_tpu.parallel.sharding import shard_params as jshard_params
from k8s_llm_scheduler_tpu.types import NodeMetrics as JNodeMetrics
from k8s_llm_scheduler_tpu.types import PodSpec as JPodSpec
from k8s_llm_scheduler_tpu_torch import rollout as trollout
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.fleet import kvplane as tkv
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.models.llama import init_params as tinit_params
from k8s_llm_scheduler_tpu_torch.models.loader import CheckpointError, save_checkpoint
from k8s_llm_scheduler_tpu_torch.parallel import launch

ttesting.cap_torch_threads()

_MICRO = dict(name="tp-paths-micro", vocab_size=512, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=4096, rope_theta=10000.0,
              tie_embeddings=True)
JMICRO = jconfigs.LlamaConfig(**_MICRO, dtype=jnp.float32)
TMICRO = tconfigs.LlamaConfig(**_MICRO, dtype=torch.float32)
WAIT_S = 600.0
FAIL_TIMEOUT_S = 5.0  # the group timeout of the killed group
ENGINE_KW = dict(num_pages=256, page_size=16, max_slots=4, max_pages_per_seq=32,
                 prefill_buckets=(32, 64, 128, 256, 512, 1024, 2048), chunk_steps=4,
                 temperature=0.0, prefix_chunk=256, admission_chunk_tokens=16)
PERSISTENT_KW = dict(persistent_loop=True, persistent_suffix_bucket=512)
BACKEND_KW = dict(max_new_tokens=80, packed_admission=False, request_timeout_s=WAIT_S,
                  prewarm_idle_delay_s=WAIT_S)
TOK = ByteTokenizer()
PREFIX = TOK.encode("CLUSTER STATE: " + " ".join(f"node-{i} cpu={10 + i}" for i in range(4)))
PROMPTS = [TOK.encode("pod-a needs a node"), TOK.encode("p" * 45), TOK.encode("pod-c")]
BUDGET = 10


# ------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def trees():
    """The JAX trees of seeds 0 and 1 (numpy) and the port's of each."""
    out = []
    for seed in (0, 1):
        jp = jax.tree_util.tree_map(np.asarray, jinit_params(jax.random.PRNGKey(seed), JMICRO))
        out.append((jp, params_from_jax(jp, "cpu")))
    return out


@pytest.fixture(scope="module")
def registry(trees, tmp_path_factory):
    """A registry of the two trees as native checkpoints (v1 active, v2),
    MICRO registered under its name while the module runs."""
    root = tmp_path_factory.mktemp("tp-paths")
    reg = trollout.CheckpointRegistry(root / "reg")
    for seed, (_, tree) in enumerate(trees):
        save_checkpoint(root / f"ckpt{seed}", tree)
        reg.publish(root / f"ckpt{seed}", cfg=TMICRO, note=f"seed {seed}")
    reg.set_active(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tconfigs._REGISTRY, TMICRO.name, TMICRO)
        yield reg


def _build(registry, **kw):
    ckpt = str(registry.get(1).checkpoint_path)
    return build_local_backend(TMICRO.name, device="cpu", checkpoint_path=ckpt,
                               **{"mesh_axes": {"tp": 2}, **ENGINE_KW, **BACKEND_KW, **kw})


@pytest.fixture(scope="module")
def plane_group(registry):
    """The swap's and the plane's tp=2 backend (delta prompts on)."""
    backend = _build(registry, delta_prompts=True)
    yield backend
    backend.close()


@pytest.fixture(scope="module")
def loop_group(registry):
    """The persistent loop's tp=2 backend."""
    backend = _build(registry, **PERSISTENT_KW)
    yield backend
    backend.close()


def _jax_mesh_engine(jp, **kw):
    """The JAX engine on a tp=2 mesh of the CPU devices."""
    mesh = jmake_mesh({"tp": 2})
    params = jshard_params(jax.tree_util.tree_map(jnp.asarray, jp), mesh, jserving_specs(JMICRO))
    return JEngine(params, JMICRO, JByteTokenizer(), mesh=mesh, **{**ENGINE_KW, **kw})


def _serve(engine) -> dict:
    """generate, then a decision wave, against PREFIX."""
    engine.set_prefix(PREFIX)
    gen = [engine.generate(p, max_new_tokens=BUDGET).token_ids for p in PROMPTS[:2]]
    wave = [f.token_ids for f in engine.decide_wave(PROMPTS, BUDGET)]
    return {"generate": gen, "wave": wave}


@pytest.fixture(scope="module")
def jax_tokens(trees):
    """The JAX tp=2 engine's tokens on seed 0's tree, and after its
    swap_params to seed 1's."""
    engine = _jax_mesh_engine(trees[0][0])
    out = {"v1": _serve(engine)}
    mesh = engine.mesh
    engine.swap_params(jshard_params(jax.tree_util.tree_map(jnp.asarray, trees[1][0]), mesh,
                                     jserving_specs(JMICRO)))
    out["v2"] = _serve(engine)
    assert out["v1"] != out["v2"]
    return out


def _states(engine) -> list[dict]:
    return engine.rank_group.on_ranks(launch.engine_state)


def _in_step(engine) -> None:
    group = engine.rank_group
    assert group.broken is None and not group.closed
    assert all(p.exitcode is None for p in group.procs)


# ----------------------------------------------------------- the hot swap
@pytest.mark.parametrize("mode", ["double", "donate"])
def test_hot_swap_in_each_mode_gives_the_jax_engines_tokens(plane_group, registry,
                                                            jax_tokens, mode):
    """HotSwapper(mesh=) swaps the tp=2 group to v2 (each rank restoring
    its own block) and back: generate and a decision wave give the JAX
    tp=2 engine's tokens after its swap_params to the same tree; every
    rank's data_ptrs stay and its prefix_epoch bumps once a swap; the group
    stays in step."""
    engine = plane_group.engine
    group = engine.rank_group
    swapper = trollout.HotSwapper(plane_group, registry, engine.model_config,
                                  mesh=engine.mesh, mode=mode)
    ptrs = group.on_ranks(launch.param_ptrs)
    before = _states(engine)
    result = swapper.swap_to(2)
    assert result["mode"] == mode and result["version"] == 2 and result["pause_s"] > 0.0
    after = _states(engine)
    assert [s["prefix_epoch"] for s in after] == [s["prefix_epoch"] + 1 for s in before]
    assert [s["weight_swaps"] for s in after] == [s["weight_swaps"] + 1 for s in before]
    assert _serve(engine) == jax_tokens["v2"]
    swapper.rollback()
    assert _serve(engine) == jax_tokens["v1"]
    assert group.on_ranks(launch.param_ptrs) == ptrs
    assert len({s["prefix_epoch"] for s in _states(engine)}) == 1
    _in_step(engine)


def test_a_donate_restore_torn_on_one_rank_leaves_every_rank_on_the_prior_weights(
        plane_group, registry, jax_tokens):
    """The follower's donate copy fails half way: every rank re-restores
    v1 into the same tensors, the swap raises, and the group serves v1's
    tokens in step."""
    engine = plane_group.engine
    swapper = trollout.HotSwapper(plane_group, registry, engine.model_config,
                                  mesh=engine.mesh, mode="donate")
    assert swapper.active_version == 1
    engine.rank_group.on_ranks(ttesting.tear_next_swap, [1])
    with pytest.raises(RuntimeError, match="failed on another tp rank"):
        swapper.swap_to(2)
    assert swapper.active_version == 1
    assert _serve(engine) == jax_tokens["v1"]
    _in_step(engine)


def test_the_fingerprint_check_refuses_another_models_checkpoint(plane_group, registry,
                                                                 tmp_path):
    """A checkpoint of another model is refused before any rank is
    touched; so is a swapper built over a tp engine without its mesh, and
    a swap_params the driver makes alone."""
    engine = plane_group.engine
    save_checkpoint(tmp_path / "tiny", tinit_params(tconfigs.TINY, seed=0, device="cpu"))
    wrong = registry.publish(tmp_path / "tiny", cfg=tconfigs.TINY, note="another model")
    swapper = trollout.HotSwapper(plane_group, registry, engine.model_config,
                                  mesh=engine.mesh)
    seq = engine.rank_group._seq
    with pytest.raises(CheckpointError, match="shaped for config"):
        swapper.swap_to(wrong.version)
    assert engine.rank_group._seq == seq
    with pytest.raises(ValueError, match="pass mesh=engine.mesh"):
        trollout.HotSwapper(plane_group, registry, engine.model_config)
    with pytest.raises(RuntimeError, match="swaps one rank"):
        engine.swap_params(engine.params)
    _in_step(engine)


# ------------------------------------------------------ the prefix-KV plane
def test_geometry_equals_the_jax_engines_at_tp2(plane_group, trees):
    """One model at tp 2 has one geometry in both packages: the whole
    model's kv heads, tp 2."""
    jengine = _jax_mesh_engine(trees[0][0])
    want = jkv.KVGeometry.of_engine(jengine)
    got = tkv.KVGeometry.of_engine(plane_group.engine)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.describe() == want.describe() == "L2xkv2xhd16/float32/tp2"
    assert plane_group.engine.cfg.n_kv_heads == 1  # a rank's own block


def test_exported_pages_equal_the_jax_export_and_adopt_without_a_prefill(plane_group, trees):
    """The tp=2 export of a pinned prefix holds the whole model's heads,
    [L, cap, n_kv, hd] host tensors equal to the JAX tp=2 engine's export
    (f32 round-off). Clear every rank's cache, adopt the pages, decide: the
    tokens equal the local prefill's and the JAX engine's, with no prefix
    prefill on any rank after the adoption."""
    engine = plane_group.engine
    jengine = _jax_mesh_engine(trees[0][0])
    jpages = jkv.export_pages(jengine, jengine.pin_prefix(PREFIX)[0], generation=0,
                              filler="jax")
    jengine.set_prefix(PREFIX)
    want = [f.token_ids for f in jengine.decide_wave(PROMPTS, BUDGET)]

    key, _ = engine.pin_prefix(PREFIX)
    pages = tkv.export_pages(engine, key, generation=0, filler="tp2")
    assert pages.transport == "host" and pages.k.device.type == "cpu"
    assert tuple(pages.k.shape) == tuple(jpages.k.shape)
    assert pages.k.shape[2] == TMICRO.n_kv_heads and pages.k.shape[1] > len(PREFIX)
    np.testing.assert_allclose(pages.k.numpy(), np.asarray(jpages.k), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pages.v.numpy(), np.asarray(jpages.v), rtol=1e-4, atol=1e-4)
    engine.set_prefix(PREFIX)
    local = [f.token_ids for f in engine.decide_wave(PROMPTS, BUDGET)]

    engine.rank_group.on_ranks(ttesting.clear_prefix_cache)
    before = _states(engine)
    assert tkv.adopt_pages(engine, pages) == (tuple(PREFIX), engine.prefix_epoch)
    engine.set_prefix(PREFIX)
    adopted = [f.token_ids for f in engine.decide_wave(PROMPTS, BUDGET)]
    after = _states(engine)
    assert adopted == local == want
    assert [s["prefix_prefills"] for s in after] == [s["prefix_prefills"] for s in before]
    assert [s["adopted_prefixes"] for s in after] == [s["adopted_prefixes"] + 1
                                                       for s in before]
    _in_step(engine)


def test_a_tp1_page_set_and_a_d2d_export_are_refused_before_any_rank_is_touched(
        plane_group, trees):
    """A page set from a tp-1 engine of the same model is refused by the
    tp=2 engine with KVGeometryError, and the tp=2 engine's d2d export
    (one block a rank) by the tp-1 engine, through the plane and through
    the engine's own check: no refusal sends the followers a message."""
    engine = plane_group.engine
    tp1 = InferenceEngine(trees[0][1], TMICRO, TOK, graphs=False, **ENGINE_KW)
    pages = tkv.export_pages(tp1, tp1.pin_prefix(PREFIX)[0], generation=0, filler="tp1")
    assert pages.geometry.tp == 1
    key, _ = engine.pin_prefix(PREFIX)
    d2d = tkv.export_pages(engine, key, generation=0, filler="tp2", transport="d2d")
    assert d2d.transport == "d2d" and d2d.geometry.tp == 2
    seq = engine.rank_group._seq
    with pytest.raises(tkv.KVGeometryError, match="tp1.*tp2"):
        tkv.adopt_pages(engine, pages)
    with pytest.raises(tkv.KVGeometryError, match="tp2.*tp1"):
        tkv.adopt_pages(tp1, d2d)
    with pytest.raises(ValueError, match="adopt on an engine of the same tp"):
        tp1.adopt_prefix_pages(list(PREFIX), d2d.k, d2d.v)
    assert engine.rank_group._seq == seq
    assert "adopted_prefixes" not in tp1.stats
    _in_step(engine)


def test_a_tp2_replica_fills_the_plane_and_a_swap_makes_its_pages_stale(plane_group,
                                                                       registry, trees):
    """At the backend level: the tp=2 replica attached to a KVPlaneStore
    wins the fill election and publishes its whole-model pages; a tp-1
    replica's lookup of that entry raises KVGeometryError and counts a
    geometry refusal, as the JAX store does; a swap's generation bump makes
    the tp=2 pages stale."""
    store = tkv.KVPlaneStore()
    plane_group.attach_kvplane(store, replica="tp2")
    nodes, pods = ttesting.synthetic_nodes(3), ttesting.fixture_pods(2)
    assert plane_group.get_scheduling_decision(pods[0], nodes).selected_node
    kv = plane_group.get_stats()["kvplane"]
    assert kv["elections_won"] == 1 and kv["publishes"] == 1
    (digest,) = list(store._entries)
    published = store._entries[digest]
    assert published.geometry.tp == 2 and published.k.shape[2] == TMICRO.n_kv_heads

    tp1 = InferenceEngine(trees[0][1], TMICRO, TOK, graphs=False, **ENGINE_KW)
    client = tkv.KVPlaneClient(store, tp1, replica="tp1")
    with pytest.raises(tkv.KVGeometryError):
        client.pin(list(published.token_ids))
    assert store.counters["geometry_refusals"] == 1

    swapper = trollout.HotSwapper(plane_group, registry, plane_group.engine.model_config,
                                  mesh=plane_group.engine.mesh, kvplane=store)
    swapper.swap_to(2)
    assert store.generation == 1
    assert store.lookup(digest, published.geometry, generation=0, holder="tp2") is None
    assert store.counters["stale_rejections"] == 1
    swapper.rollback()
    _in_step(plane_group.engine)


# ------------------------------------------------------ the persistent loop
def _drain_persistent(engine, n: int) -> dict:
    out = {}
    deadline = time.monotonic() + WAIT_S
    while len(out) < n:
        assert time.monotonic() < deadline, "persistent serving wedged"
        for fin in engine.step_persistent(timeout_s=0.05):
            out[fin.req_id] = fin.token_ids
    return out


def _drain_fused(engine, n: int, out: dict | None = None) -> dict:
    out = dict(out or {})
    deadline = time.monotonic() + WAIT_S
    while len(out) < n:
        assert time.monotonic() < deadline, "fused decode wedged"
        for fin in engine.step_fused():
            out[fin.req_id] = fin.token_ids
    return out


def _admit_resident(engine, out: dict, max_new_tokens: int = 40) -> int:
    """Admit PROMPTS[0] through the command ring and harvest until the loop
    has run a step since (the request is on the device, not waiting in the
    ring). The steps count is the engine's since it was built, and the
    module's groups serve several tests, so it is read before the
    admission."""
    since = engine.stats["persistent_steps"]
    (rid,) = engine.add_requests([PROMPTS[0]], max_new_tokens=max_new_tokens)
    deadline = time.monotonic() + WAIT_S
    while engine.stats["persistent_steps"] <= since:
        assert time.monotonic() < deadline, "the loop never emitted"
        for fin in engine.step_persistent(timeout_s=0.05):
            out[fin.req_id] = fin.token_ids
    return rid


@pytest.fixture(scope="module")
def jax_resident(trees):
    """The JAX engine's resident streams of PROMPTS (budget 10) and its
    generate() of PROMPTS[0] at budget 40, off the mesh: the JAX resident
    loop's host callbacks do not partition over a tp mesh of CPU devices
    (XLA refuses a replicated io_callback), so the JAX package's own tp=2
    == tp=1 pin (tests/test_sharded.py) carries the comparison here."""
    engine = JEngine(jax.tree_util.tree_map(jnp.asarray, trees[0][0]), JMICRO,
                     JByteTokenizer(), **{**ENGINE_KW, **PERSISTENT_KW})
    engine.set_prefix(PREFIX)
    long = engine.generate(PROMPTS[0], max_new_tokens=40).token_ids
    assert engine.enter_persistent()
    ids = engine.add_requests(PROMPTS, max_new_tokens=BUDGET)
    out = _drain_persistent(engine, len(ids))
    engine.exit_persistent()
    return {"streams": [out[i] for i in ids], "long": long}


def test_resident_streams_equal_the_jax_engines_on_every_rank(loop_group, jax_resident):
    """Suffixes admitted through the command ring give the JAX engine's
    resident streams; every rank's counter block and books agree,
    and the loop's admissions launch K1 and K2 alike on every rank (the
    counts are 0 off a card)."""
    engine = loop_group.engine
    group = engine.rank_group
    engine.set_prefix(PREFIX)
    group.on_ranks(launch.reset_launch_counts)
    assert engine.enter_persistent()
    ids = engine.add_requests(PROMPTS, max_new_tokens=BUDGET)
    out = _drain_persistent(engine, len(ids))
    engine.exit_persistent()
    assert [out[i] for i in ids] == jax_resident["streams"]
    states = _states(engine)
    assert states[0] == states[1]
    assert states[0]["counters"]["admits"] == len(PROMPTS)
    assert states[0]["persistent_admissions"] == len(PROMPTS)
    counts = group.on_ranks(launch.launch_counts)
    assert counts[0] == counts[1]
    _in_step(engine)


def test_a_quiesce_mid_stream_continues_on_step_fused(loop_group, jax_resident):
    """Exit the loop mid-stream on every rank: step_fused finishes the
    request with the JAX engine's tokens."""
    engine = loop_group.engine
    engine.set_prefix(PREFIX)
    assert engine.enter_persistent()
    out = {}
    rid = _admit_resident(engine, out)
    engine.exit_persistent()
    assert not any(s["persistent_active"] for s in _states(engine))
    out = _drain_fused(engine, 1, out)
    assert out[rid] == jax_resident["long"]
    _in_step(engine)


def test_a_wave_and_a_swap_while_resident_keep_the_ranks_in_step(loop_group, registry,
                                                                 jax_tokens, jax_resident):
    """A wave submitted while the loop is resident drains it on every rank
    first and gives the JAX engine's wave; a hot swap while resident does
    the same at its barrier; the resident requests finish on the dispatch
    path with the JAX engine's tokens."""
    engine = loop_group.engine
    engine.set_prefix(PREFIX)
    assert engine.enter_persistent()
    out = {}
    rid = _admit_resident(engine, out)
    wave = [f.token_ids for f in engine.decide_wave(PROMPTS, BUDGET)]
    assert wave == jax_tokens["v1"]["wave"]
    assert not any(s["persistent_active"] for s in _states(engine))
    out = _drain_fused(engine, 1, out)
    assert out[rid] == jax_resident["long"]

    assert engine.enter_persistent()
    out = {}
    rid = _admit_resident(engine, out)
    epochs = [s["prefix_epoch"] for s in _states(engine)]
    swapper = trollout.HotSwapper(loop_group, registry, engine.model_config,
                                  mesh=engine.mesh, mode="double")
    swapper.swap_to(1)  # the weights it serves: the stream goes on unchanged
    states = _states(engine)
    assert [s["prefix_epoch"] for s in states] == [e + 1 for e in epochs]
    assert not any(s["persistent_active"] for s in states)
    out = _drain_fused(engine, 1, out)
    assert out[rid] == jax_resident["long"]
    _in_step(engine)


def test_the_backend_serves_decisions_through_the_loop_like_jax(loop_group, trees):
    """LocalLLMBackend(persistent_loop=True) over the tp=2 engine admits
    each decision through the command ring, and picks the JAX backend's
    node with its reasoning (the JAX engine off the mesh, as jax_resident
    says why)."""
    pods, nodes = ttesting.fixture_pods(2), ttesting.synthetic_nodes(3)
    jengine = JEngine(jax.tree_util.tree_map(jnp.asarray, trees[0][0]), JMICRO,
                      JByteTokenizer(), **{**ENGINE_KW, **PERSISTENT_KW})
    jb = JBackend(jengine, tokenizer=JByteTokenizer(),
                  max_new_tokens=80, persistent_loop=True, request_timeout_s=WAIT_S,
                  prewarm_idle_delay_s=WAIT_S)
    try:
        want = [jb.get_scheduling_decision(JPodSpec(**dataclasses.asdict(p)),
                                           [JNodeMetrics(**dataclasses.asdict(n))
                                            for n in nodes]) for p in pods]
    finally:
        jb.close()
    engine = loop_group.engine
    before, waves = _states(engine), engine.stats["waves"]
    got = [loop_group.get_scheduling_decision(p, nodes) for p in pods]
    assert [(d.selected_node, d.reasoning) for d in got] == [
        (d.selected_node, d.reasoning) for d in want]
    after = _states(engine)
    assert [a["persistent_admissions"] - b["persistent_admissions"]
            for a, b in zip(after, before)] == [len(pods)] * 2
    assert engine.stats["waves"] == waves
    _in_step(engine)


def test_the_wedge_watchdog_drains_every_rank(loop_group, jax_resident, monkeypatch):
    """The driver's heartbeat reads an hour idle: the watchdog drains the
    loop on every rank, every rank latches it off, and the request finishes
    on the dispatch path with the JAX engine's tokens. Only the watchdog's
    read is aged (the `idle_s` of the driver's own Heartbeat): the resident
    threads stamp their beats with the real clock, so a beat landing inside
    the window cannot make the heartbeat look fresh again."""
    engine = loop_group.engine
    engine.set_grammar(None)  # the backend's decisions installed theirs
    engine.set_prefix(PREFIX)
    assert engine.enter_persistent()
    out = {}
    rid = _admit_resident(engine, out)
    server = engine._persistent
    monkeypatch.setattr(server.heartbeat, "idle_s", lambda: server.wedge_timeout_s + 3600.0)
    for fin in engine.step_persistent(timeout_s=0.0):
        out[fin.req_id] = fin.token_ids
    monkeypatch.undo()
    states = _states(engine)
    assert [(s["persistent_active"], s["persistent_wedged"], s["persistent_wedges"])
            for s in states] == [(False, True, 1)] * 2
    assert engine.enter_persistent() is False
    out = _drain_fused(engine, 1, out)
    assert out[rid] == jax_resident["long"]
    assert engine.persistent_blackbox()["reason"] == "wedge"
    _in_step(engine)


def test_a_stop_between_an_admits_take_and_its_run_keeps_the_ranks_in_step(registry,
                                                                          jax_resident):
    """The watchdog's stop lands after the driver's resident loop took a
    request's ADMIT off its ring and before it ran it: the ADMIT goes back
    on the driver's ring (each follower's copy is still on its own), so
    exit_persistent finishes the request truncated on every rank, and the
    group then generates the JAX engine's tokens in step."""
    backend = _build(registry, **PERSISTENT_KW)
    engine = backend.engine
    try:
        engine.set_prefix(PREFIX)
        assert engine.enter_persistent()
        server = engine._persistent
        ttesting.stop_at_next_admit(server)
        (rid,) = engine.add_requests([PROMPTS[0]], max_new_tokens=40)
        assert server._done.wait(WAIT_S)
        engine.exit_persistent()
        assert {f.req_id: f.token_ids for f in engine.step_persistent()} == {rid: []}
        states = _states(engine)
        assert states[0] == states[1] and not engine.has_active
        assert engine.generate(PROMPTS[0], max_new_tokens=40).token_ids == jax_resident["long"]
        _in_step(engine)
    finally:
        backend.close()


@pytest.mark.parametrize("which", ["plane_group", "loop_group"])
def test_follower_ranks_import_no_jax_after_the_new_paths(which, request):
    """The followers that swapped, exported, adopted and ran the resident
    loop import torch and the port only."""
    engine = request.getfixturevalue(which).engine
    follower = engine.rank_group.on_ranks(launch.loaded_packages)[1]
    assert "k8s_llm_scheduler_tpu_torch" in follower and "torch" in follower
    assert "jax" not in follower and "k8s_llm_scheduler_tpu" not in follower
    assert "tools" not in follower


def test_a_follower_killed_mid_residency_makes_the_driver_raise(registry, monkeypatch):
    """The follower dies while the loop decodes: the driver's harvest
    raises within the group timeout, and no later call is served."""
    monkeypatch.setattr(launch, "GROUP_TIMEOUT_S", FAIL_TIMEOUT_S)
    backend = _build(registry, **PERSISTENT_KW)
    engine = backend.engine
    group = engine.rank_group
    try:
        engine.set_prefix(PREFIX)
        assert engine.enter_persistent()
        _admit_resident(engine, {}, max_new_tokens=200)
        group.procs[0].kill()
        group.procs[0].join(30)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError):
            _drain_persistent(engine, 1)
        assert time.monotonic() - t0 < 4 * FAIL_TIMEOUT_S
        with pytest.raises(RuntimeError, match="tp group is down"):
            engine.generate(PROMPTS[2], max_new_tokens=2)
    finally:
        backend.close()
    assert group.closed
