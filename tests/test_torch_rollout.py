"""The port's live rollout (rollout/, engine.swap_params) held against the
JAX package's on the CPU.

- Swap: a TINY f32 engine on params P0 runs a greedy wave, swaps to P1,
  runs it again, and swaps back, in both packages, with dense and with
  int8 trees (ragged block decode): the waves' tokens are equal across the
  packages, the post-swap tokens are a fresh engine's on P1, the swap back
  gives P0's tokens again, prefix_epoch, the pins and weight_swaps follow
  the JAX engine, and no serving tensor moves (data_ptr). A tree of the
  wrong structure, shape or dtype raises before any leaf is written.
- Hot swapper: two TINY checkpoints published in a registry, swap_to in
  both modes under concurrent decisions through run_quiesced; digest and
  fingerprint refusals with the old weights serving; a donate install that
  fails part way leaves the prior version serving.
- Registry: each package reads the other's registry (status, fsck) and
  writes the same manifest bytes; config_fingerprint is the JAX package's
  for TINY and Llama-3.1-8B.
- Shadow and canary: the same stats and controller steps as the JAX
  package's.
- A closed backend that built its engine holds no tensor (weakrefs).
- `cli rollout publish|status|promote|rollback|fsck` exit as the JAX
  package's do; the gate's arms run TINY f32 on the CPU.

Every wait is bounded (WAIT_S)."""

import concurrent.futures as cf
import dataclasses
import gc
import json
import types
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu import cli as jcli
from k8s_llm_scheduler_tpu import rollout as jrollout
from k8s_llm_scheduler_tpu.engine.backend import StubBackend as JStub
from k8s_llm_scheduler_tpu.engine.engine import InferenceEngine as JEngine
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models import quant as jquant
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.rollout import registry as jregistry
from k8s_llm_scheduler_tpu.types import DecisionSource as JSource
from k8s_llm_scheduler_tpu.types import SchedulingDecision as JDecision
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch import rollout as trollout
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.core.cache import DecisionCache
from k8s_llm_scheduler_tpu_torch.engine.backend import StubBackend as TStub
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine as TEngine
from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend, build_local_backend
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.models.loader import CheckpointError, save_checkpoint
from k8s_llm_scheduler_tpu_torch.rollout import registry as tregistry
from k8s_llm_scheduler_tpu_torch.types import DecisionSource as TSource
from k8s_llm_scheduler_tpu_torch.types import SchedulingDecision as TDecision

ttesting.cap_torch_threads()

REPO = Path(__file__).resolve().parent.parent
WAIT_S = 300.0
JTINY = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TTINY = dataclasses.replace(tconfigs.TINY, dtype=torch.float32)
PREFIX = list(b"cluster state: node-0 idle, node-1 busy, node-2 idle. ")
SUFFIXES = [list(b"pod web-1 wants 1 cpu"), list(b"pod db-7 wants 4 cpus and 8Gi")]
MAX_NEW = 12

# Modules copied from the JAX package: (path, [(start, end) markers of the
# compared spans, None meaning the text's start or end]).
COPIES = [
    ("rollout/__init__.py", [(None, None)]),
    ("rollout/shadow.py", [(None, None)]),
    ("rollout/canary.py", [(None, None)]),
    ("rollout/registry.py", [("def _file_digest(", "    def verify("),
                             ("    def fsck(", None)]),
]


@pytest.mark.parametrize("path,spans", COPIES, ids=[p for p, _ in COPIES])
def test_copy_matches_the_reference_text(path, spans):
    want = (REPO / "k8s_llm_scheduler_tpu" / path).read_text().replace(
        "k8s_llm_scheduler_tpu.", "k8s_llm_scheduler_tpu_torch.")
    got = (REPO / "k8s_llm_scheduler_tpu_torch" / path).read_text()

    def cut(text, a, b):
        text = text[text.index(a):] if a else text
        return text[:text.index(b)] if b else text

    for a, b in spans:
        assert cut(got, a, b) == cut(want, a, b)


# ------------------------------------------------------------- fingerprint
@pytest.mark.parametrize("name", ["tiny", "llama-3.1-8b-instruct"])
def test_config_fingerprint_is_the_jax_packages(name):
    assert trollout.config_fingerprint(tconfigs.get_config(name)) == (
        jrollout.config_fingerprint(jconfigs.get_config(name)))
    assert trollout.config_fingerprint(TTINY) == jrollout.config_fingerprint(JTINY)
    assert trollout.config_fingerprint(TTINY) != trollout.config_fingerprint(tconfigs.TINY)


# ---------------------------------------------------------------- registry
def _dummy(tmp_path, tag):
    src = tmp_path / f"src-{tag}"
    (src / "sub").mkdir(parents=True, exist_ok=True)
    (src / "weights.bin").write_bytes(b"w" * 64 + tag.encode())
    (src / "sub" / "meta.json").write_text(json.dumps({"tag": tag}))
    return src


def _publish_both(tmp_path, monkeypatch):
    """The same three publishes (a pointer move between) through each
    package's registry, at a frozen clock."""
    for mod in (jregistry, tregistry):
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.0)
    roots = {}
    for name, mod, cfg in (("jax", jregistry, jconfigs.TINY), ("port", tregistry, tconfigs.TINY)):
        reg = mod.CheckpointRegistry(tmp_path / f"reg-{name}")
        reg.publish(_dummy(tmp_path, "a"), cfg=cfg, note="a")
        reg.set_active(1)
        reg.publish(_dummy(tmp_path, "b"), cfg=cfg, note="b", scores={"spread": 0.01})
        reg.publish(_dummy(tmp_path, "c"), config_name="tiny")
        reg.record_scores(2, {"gate": {"pass": True}})
        roots[name] = reg.root
    return roots


def test_registries_are_byte_identical_and_read_across_packages(tmp_path, monkeypatch):
    roots = _publish_both(tmp_path, monkeypatch)
    for rel in ("registry.json", "v000001/manifest.json", "v000002/manifest.json",
                "v000003/manifest.json"):
        assert (roots["port"] / rel).read_bytes() == (roots["jax"] / rel).read_bytes()
    for root in roots.values():
        want = jregistry.CheckpointRegistry(root)
        got = tregistry.CheckpointRegistry(root)
        assert {**got.status(), "root": ""} == {**want.status(), "root": ""}
        assert got.fsck() == want.fsck() == {1: [], 2: [], 3: []}
    victim = roots["jax"] / "v000002" / "checkpoint" / "weights.bin"
    victim.write_bytes(b"x" * victim.stat().st_size)
    assert tregistry.CheckpointRegistry(roots["jax"]).fsck()[2] == ["weights.bin: content digest mismatch"]
    port = tregistry.CheckpointRegistry(roots["port"])
    assert port.retain(keep_last=1) == [2]  # the active v1 is kept, v2 goes
    assert port.versions() == [1, 3]


# ------------------------------------------------------------ engine swap
def _ptrs(tree):
    if isinstance(tree, dict):
        return {k: _ptrs(v) for k, v in tree.items()}
    return tree.data_ptr()


def _wave(eng):
    eng.set_prefix(PREFIX)
    return [f.token_ids for f in eng.decide_wave(SUFFIXES, MAX_NEW)]


def _jax_engine(jp, decode_matmul):
    return JEngine(jp, JTINY, JByteTokenizer(), num_pages=16, page_size=64,
                   max_pages_per_seq=8, max_slots=2, temperature=0.0,
                   decode_matmul=decode_matmul)


def _torch_engine(tp, decode_matmul):
    return TEngine(tp, TTINY, ByteTokenizer(), num_pages=16, page_size=64,
                   max_pages_per_seq=8, max_slots=2, temperature=0.0,
                   decode_matmul=decode_matmul)


@pytest.fixture(scope="module", params=["dense", "int8"])
def swap_trees(request):
    """(kind, JAX P0, JAX P1, a numpy copy of each) — int8 pairs quantized
    by the JAX package's quantize_params."""
    jp0 = jinit_params(jax.random.PRNGKey(0), JTINY)
    jp1 = jinit_params(jax.random.PRNGKey(1), JTINY)
    if request.param == "int8":
        jp0, jp1 = jquant.quantize_params(jp0), jquant.quantize_params(jp1)
    np0, np1 = (jax.tree_util.tree_map(np.asarray, p) for p in (jp0, jp1))
    return request.param, jp0, jp1, np0, np1


def _flat(tree, path="params"):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}.{k}")
    else:
        yield path, tree


def test_swap_params_copies_in_place_and_matches_the_jax_engine(swap_trees):
    kind, jp0, jp1, np0, np1 = swap_trees
    matmul = "ragged" if kind == "int8" else "dense"
    jeng = _jax_engine(jp0, matmul)
    teng = _torch_engine(params_from_jax(np0, "cpu"), matmul)
    before = _ptrs(teng.params)
    want0 = _wave(jeng)
    assert _wave(teng) == want0

    pins = []
    for eng in (jeng, teng):
        key, epoch = eng.pin_prefix(PREFIX)
        assert eng.pin_alive(key, epoch)
        pins.append((key, epoch))
    jeng.swap_params(jp1)
    staging = params_from_jax(np1, "cpu")
    assert teng.swap_params(staging) is staging
    assert _ptrs(teng.params) == before  # no serving tensor moved
    for eng, (key, epoch) in zip((jeng, teng), pins):
        assert not eng.pin_alive(key, epoch) and not eng._pinned_prefix_keys
        assert eng._prefix is None and not eng._prefix_cache
    for (path, got), (_, want) in zip(_flat(teng.params), _flat(staging)):
        assert torch.equal(got, want), path

    want1 = _wave(jeng)
    assert want1 != want0
    assert _wave(teng) == want1
    assert _wave(_torch_engine(params_from_jax(np1, "cpu"), matmul)) == want1

    jeng.swap_params(jp0)
    teng.swap_params(params_from_jax(np0, "cpu"))
    assert _wave(jeng) == want0
    assert _wave(teng) == want0
    assert _ptrs(teng.params) == before
    for field in ("prefix_epoch",):
        assert getattr(teng, field) == getattr(jeng, field) == 2
    assert teng.stats["weight_swaps"] == jeng.stats["weight_swaps"] == 2


def _bad_trees(tp):
    """Trees that must be refused: each differs from `tp` in ONE leaf (the
    last one walked, so a copy that ran ahead would show) or one key."""
    path, leaf = list(_flat(tp))[-1]
    keys = path.split(".")[1:]

    def with_leaf(new):
        tree = json_copy(tp)
        node = tree
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = new
        return tree

    def json_copy(t):
        return {k: json_copy(v) for k, v in t.items()} if isinstance(t, dict) else t.clone() + 1

    wrong_shape = with_leaf(torch.zeros(*leaf.shape[:-1], leaf.shape[-1] + 1, dtype=leaf.dtype))
    wrong_dtype = with_leaf(leaf.to(torch.float64) if leaf.is_floating_point()
                            else leaf.to(torch.int32))
    missing = json_copy(tp)
    missing.pop("final_norm")
    return {"shape": wrong_shape, "dtype": wrong_dtype, "missing": missing}


def test_swap_params_refuses_a_mismatched_tree_before_writing(swap_trees):
    kind, _, _, np0, _ = swap_trees
    teng = _torch_engine(params_from_jax(np0, "cpu"), "dense")
    snapshot = [(p, t.clone()) for p, t in _flat(teng.params)]
    for what, tree in _bad_trees(teng.params).items():
        with pytest.raises(ValueError, match="swap_params"):
            teng.swap_params(tree)
        for (path, want), (_, got) in zip(snapshot, _flat(teng.params)):
            assert torch.equal(got, want), (what, path)
    assert teng.stats["weight_swaps"] == 0 and teng.prefix_epoch == 0


# ------------------------------------------------------------ hot swapper
@pytest.fixture
def published(tmp_path):
    """A registry holding two TINY f32 checkpoints (seeds 0 and 1) of the
    port, v1 active, and the JAX P0/P1 they hold."""
    registry = trollout.CheckpointRegistry(tmp_path / "reg")
    trees = []
    for seed in (0, 1):
        jp = jinit_params(jax.random.PRNGKey(seed), JTINY)
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        save_checkpoint(tmp_path / f"ckpt{seed}", tp)
        registry.publish(tmp_path / f"ckpt{seed}", cfg=TTINY, note=f"seed {seed}")
        trees.append(tp)
    registry.set_active(1)
    return registry, trees


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def _backend(params):
    """A backend over an engine on a copy of `params` (a swap writes into
    the serving tensors)."""
    return LocalLLMBackend(_torch_engine(_clone(params), "dense"),
                           max_new_tokens=80, prewarm_idle_delay_s=WAIT_S,
                           request_timeout_s=WAIT_S)


def _decide(backend, pods, nodes):
    with cf.ThreadPoolExecutor(len(pods)) as pool:
        futs = [pool.submit(backend.get_scheduling_decision, p, nodes) for p in pods]
        return [f.result(timeout=WAIT_S) for f in futs]


@pytest.mark.parametrize("mode", ["double", "donate"])
def test_hot_swap_under_concurrent_waves(published, mode):
    registry, (p0, p1) = published
    backend = _backend(p0)
    eng = backend.engine
    before = _ptrs(eng.params)
    cache = DecisionCache()
    swapper = trollout.HotSwapper(backend, registry, TTINY, cache=cache, mode=mode)
    nodes = ttesting.synthetic_nodes(3)
    pods = ttesting.fixture_pods(6)
    try:
        with cf.ThreadPoolExecutor(8) as pool:
            first = [pool.submit(backend.get_scheduling_decision, p, nodes) for p in pods[:3]]
            swap = pool.submit(swapper.swap_to, 2)
            late = [pool.submit(backend.get_scheduling_decision, p, nodes) for p in pods[3:]]
            result = swap.result(timeout=WAIT_S)
            names = {n.name for n in nodes}
            for f in first + late:
                assert f.result(timeout=WAIT_S).selected_node in names
        assert result["version"] == 2 and result["prior"] == 1 and result["mode"] == mode
        assert result["pause_s"] > 0.0 and cache.generation == 1
        assert _ptrs(eng.params) == before
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_flat(eng.params), _flat(p1)))
        swapper.rollback()
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_flat(eng.params), _flat(p0)))
        assert cache.generation == 2 and swapper.stats()["rollbacks"] == 1
        assert eng.stats["weight_swaps"] == 2 and backend.get_stats()["swap"]["quiesce_runs"] == 2
    finally:
        backend.close()


def test_hot_swap_refusals_keep_the_old_weights_serving(published, tmp_path):
    registry, (p0, _) = published
    wrong = registry.publish(tmp_path / "ckpt1", cfg=tconfigs.TINY, note="bf16 config")
    backend = _backend(p0)
    swapper = trollout.HotSwapper(backend, registry, TTINY)
    nodes, pods = ttesting.synthetic_nodes(3), ttesting.fixture_pods(2)
    try:
        want = _decide(backend, pods, nodes)
        with pytest.raises(CheckpointError, match="shaped for config"):
            swapper.swap_to(wrong.version)
        victim = registry.get(2).checkpoint_path / "params.pt"
        data = bytearray(victim.read_bytes())
        data[len(data) // 2] ^= 0xFF  # same size, one byte flipped
        victim.write_bytes(bytes(data))
        with pytest.raises(CheckpointError, match="digest"):
            swapper.swap_to(2)
        assert backend.engine.stats["weight_swaps"] == 0
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_flat(backend.engine.params),
                                                               _flat(p0)))
        got = _decide(backend, pods, nodes)
        assert [d.selected_node for d in got] == [d.selected_node for d in want]
    finally:
        backend.close()


def test_donate_failure_part_way_restores_the_prior_version(published, monkeypatch):
    """A donate install whose copy fails after half the leaves were written
    restores v1 from the registry into the same storages, then raises."""
    registry, (p0, _) = published
    backend = _backend(p0)
    eng = backend.engine
    swapper = trollout.HotSwapper(backend, registry, TTINY, mode="donate")
    swapper.active_version = 1
    real = TEngine.swap_params
    calls = []

    def torn(self, params):
        calls.append(1)
        if len(calls) == 1:
            leaves = list(zip(_flat(self.params), _flat(params)))
            for (_, dst), (_, src) in leaves[: len(leaves) // 2]:
                dst.copy_(src)
            raise OSError("read error half way through the candidate")
        return real(self, params)

    monkeypatch.setattr(TEngine, "swap_params", torn)
    nodes, pods = ttesting.synthetic_nodes(3), ttesting.fixture_pods(2)
    try:
        want = _decide(backend, pods, nodes)
        with pytest.raises(OSError, match="half way"):
            swapper.swap_to(2)
        assert len(calls) == 2 and swapper.active_version == 1
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_flat(eng.params), _flat(p0)))
        got = _decide(backend, [dataclasses.replace(p, name=p.name + "-again") for p in pods],
                      nodes)
        assert [d.selected_node for d in got] == [d.selected_node for d in want]
    finally:
        backend.close()


# ------------------------------------------------------------ release
def _reachable_tensors(root):
    """Every tensor reachable from `root` through object references
    (functions through their closures and defaults, not their globals)."""
    seen, out, stack = set(), [], [root]
    while stack:
        obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            out.append(obj)
        elif isinstance(obj, (types.ModuleType, type, str, bytes, int, float)):
            continue
        elif isinstance(obj, types.FunctionType):
            stack.extend(c.cell_contents for c in obj.__closure__ or ()
                         if c.cell_contents is not None)
            stack.extend(obj.__defaults__ or ())
        else:
            stack.extend(gc.get_referents(obj))
    return out


def test_a_closed_backend_that_built_its_engine_holds_no_tensor(monkeypatch):
    """build_local_backend's backend owns its engine: after close() no
    tensor it reached (params, KV, prefix cache, wave buffers, the draft
    model of its speculative decoder) is alive; its books still answer. A
    backend over an engine it did not build leaves the engine alone."""
    monkeypatch.setitem(tconfigs._REGISTRY, "tiny-f32-release",
                        dataclasses.replace(TTINY, name="tiny-f32-release"))
    backend = build_local_backend("tiny-f32-release", device="cpu", temperature=0.0,
                                  max_new_tokens=80, prewarm_idle_delay_s=WAIT_S,
                                  spec_enabled=True)
    nodes, pods = ttesting.synthetic_nodes(3), ttesting.fixture_pods(2)
    _decide(backend, pods, nodes)
    refs = [weakref.ref(t) for t in _reachable_tensors(backend)]
    assert len(refs) > 50  # params, KV, prefix cache, wave buffers ...
    backend.close()
    gc.collect()
    alive = [r for r in refs if r() is not None]
    assert alive == []
    assert backend.get_stats()["completed"] >= 2  # the books survive
    assert backend.engine.spec.arm == "draft" and backend.engine.spec.draft is None
    shared = LocalLLMBackend(_torch_engine(init_params_cpu(), "dense"))
    shared.close()
    assert shared.engine.params is not None  # a borrowed engine is left alone


def init_params_cpu():
    from k8s_llm_scheduler_tpu_torch.models.llama import init_params

    return init_params(TTINY, seed=0, device="cpu")


# ---------------------------------------------------------- shadow, canary
def _scored(pkg_scorer, stub, decision, source, nodes_fn, pods_fn):
    scorer = pkg_scorer(stub(), fraction=0.5, candidate_version=7)
    try:
        nodes = nodes_fn(4)
        for i, pod in enumerate(pods_fn(8) * 2):
            d = decision(selected_node=f"node-{i % 4}", confidence=0.9, reasoning="t",
                         source=source.LLM)
            scorer.observe(pod, nodes, d)
        assert scorer.drain(timeout_s=WAIT_S)
        return scorer.stats()
    finally:
        scorer.close()


def test_shadow_scorer_stats_match_the_jax_package():
    from k8s_llm_scheduler_tpu import testing as jtesting

    got = _scored(trollout.ShadowScorer, TStub, TDecision, TSource,
                  ttesting.synthetic_nodes, ttesting.fixture_pods)
    want = _scored(jrollout.ShadowScorer, JStub, JDecision, JSource,
                   lambda n: jtesting.synthetic_cluster(n).get_node_metrics(),
                   lambda n: [__import__("k8s_llm_scheduler_tpu.cluster.interface",
                                         fromlist=["x"]).raw_pod_to_spec(p)
                              for p in jtesting.pod_burst(n, distinct_shapes=n)])
    assert got["mirrored"] == 8
    assert got == want


class _FakeSwapper:
    def __init__(self):
        self.calls = []

    def swap_to(self, version):
        self.calls.append(version)
        return {"version": version, "pause_s": 0.01, "mode": "double"}

    def stats(self):
        return {"swaps": len(self.calls)}


class _FakeSlo:
    def __init__(self):
        self.trips = []

    def tripped(self):
        return list(self.trips)


def _canary_steps(pkg, registry_mod, tmp_path, monkeypatch):
    """One scripted run of a CanaryController: promote v2 (clean burn-in),
    promote v3 (fallback trip, rollback), v4 gate-rejected, v5 promoted
    then tripped by the SLO engine. Returns every tick's result and the
    end state."""
    monkeypatch.setattr(registry_mod.time, "time", lambda: 1_700_000_000.0)
    registry = pkg.CheckpointRegistry(tmp_path)
    for i in range(5):
        src = tmp_path.parent / f"{tmp_path.name}-src{i}"
        src.mkdir()
        (src / "w.bin").write_bytes(bytes([i]) * 32)
        registry.publish(src, config_name="tiny")
    registry.set_active(1)
    stats = {"llm_decisions": 0, "cache_decisions": 0, "fallback_decisions": 0,
             "failed_bindings": 0, "client": {"invalid_decisions": 0}}
    clock = [100.0]
    slo = _FakeSlo()
    controller = pkg.CanaryController(
        registry, _FakeSwapper(),
        stats_provider=lambda: dict(stats, client=dict(stats["client"])),
        gate_runner=lambda v: {"pass": v != 4, "checks": {"spread": v != 4},
                               "candidate": {"spread": 0.1 * v}},
        burn_in_decisions=100, slo_engine=slo, clock=lambda: clock[0],
    )
    steps = []

    def tick(**changes):
        stats.update(changes)
        clock[0] += 5.0
        out = controller.tick()
        steps.append(out if isinstance(out, (str, type(None))) else
                     {k: out[k] for k in sorted(out) if k != "swap"})

    tick()                                   # gate + promote v5 (newest)
    tick(llm_decisions=50)                   # still collecting
    slo.trips = ["decide_latency"]
    tick()                                   # SLO burn: roll back to v1
    slo.trips = []
    tick()                                   # gate v4: rejected
    tick()                                   # gate v3: promoted
    tick(llm_decisions=200, fallback_decisions=90)  # fallback trip: rollback
    tick()                                   # gate v2: promoted
    tick(llm_decisions=320, fallback_decisions=91)  # clean burn-in
    tick()                                   # nothing left
    scores = {v: registry.get(v).scores for v in registry.versions()}
    return steps, controller.stats(), controller.swapper.calls, scores, registry.active()


def test_canary_controller_takes_the_jax_packages_steps(tmp_path, monkeypatch):
    got = _canary_steps(trollout, tregistry, tmp_path / "port", monkeypatch)
    want = _canary_steps(jrollout, jregistry, tmp_path / "jax", monkeypatch)
    assert got == want
    steps, stats, calls, _, active = got
    assert [s if isinstance(s, (str, type(None))) else s["action"] for s in steps] == [
        "promoted", None, "rolled_back", "rejected", "promoted", "rolled_back",
        "promoted", "ok", None]
    assert calls == [5, 1, 3, 1, 2] and active == 2 and stats["rejected"] == [3, 4, 5]


def test_gate_verdict_matches_the_jax_package():
    from k8s_llm_scheduler_tpu import sim as jsim
    from k8s_llm_scheduler_tpu_torch import sim as tsim

    gate = dict(seed=3, nodes=6, pods=12, shapes=6, waves=2, hetero=False,
                spread_tolerance=0.005)
    want = jrollout.run_gate(lambda: jsim.HeuristicBackend("resource_balanced"),
                             lambda: jsim.HeuristicBackend("least_loaded"),
                             jrollout.GateConfig(**gate))
    got = trollout.run_gate(lambda: tsim.HeuristicBackend("resource_balanced"),
                            lambda: tsim.HeuristicBackend("least_loaded"),
                            trollout.GateConfig(**gate))
    assert got == want


# ------------------------------------------------------------------- cli
def _hf(path, seed):
    from safetensors.torch import save_file

    cfg = tconfigs.TINY
    rng = np.random.default_rng(seed)
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
    path.mkdir()
    save_file({name: torch.from_numpy(((1.0 if len(s) == 1 else 0.0) + rng.normal(size=s) * (
        0.1 if len(s) == 1 else s[-1] ** -0.5)).astype(np.float32))
        for name, s in shapes.items()}, str(path / "model.safetensors"))


def test_cli_rollout_exits_as_the_jax_package_does(tmp_path, capsys, monkeypatch):
    """publish (two TINY HF checkpoints), status, fsck, promote v1 without
    the gate, rollback, and fsck after damage: the port's exit codes and
    JSON are the JAX package's. Then the port's promote of v2 through the
    gate (two TINY f32 arms, greedy, on the CPU, one after the other)
    passes, sets v2 active and records the verdict in its manifest."""
    model = "tiny-f32-rollout"
    monkeypatch.setitem(jconfigs._REGISTRY, model, dataclasses.replace(JTINY, name=model))
    monkeypatch.setitem(tconfigs._REGISTRY, model, dataclasses.replace(TTINY, name=model))
    for seed in (0, 1):
        _hf(tmp_path / f"hf{seed}", seed)
    config = tmp_path / "config.yaml"
    config.write_text(
        f"llm:\n  model: {model}\n  max_tokens: 80\n  max_batch: 4\n  timeout: 600\n"
        "  fused_decode: false\n  compile_cache_dir: null\n"
        "rollout:\n  gate:\n    nodes: 3\n    pods: 4\n    shapes: 2\n    waves: 2\n"
        "observability:\n  profiler: false\n")
    out = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        reg = str(tmp_path / f"reg-{name}")
        rcs, lines = [], []
        for argv in ([["publish", "--checkpoint", str(tmp_path / f"hf{s}")] for s in (0, 1)]
                     + [["status"], ["fsck"], ["promote", "--version", "1", "--no-gate"],
                        ["promote", "--version", "2", "--no-gate"], ["rollback"]]):
            rcs.append(main(["--config", str(config), "rollout", argv[0], "--registry", reg,
                             *argv[1:]]))
            lines.append(capsys.readouterr().out)
        out[name] = rcs, lines
    (jrcs, jlines), (trcs, tlines) = out["jax"], out["port"]
    assert trcs == jrcs == [0] * 7
    for i in (0, 1, 4, 5, 6):  # publish, promote, rollback: one JSON line each
        assert json.loads(tlines[i]) == json.loads(jlines[i])
    status = json.loads(tlines[2])
    assert [v["version"] for v in status["versions"]] == [1, 2] and status["active"] is None
    assert json.loads(tlines[3])["clean"] == 2

    reg = str(tmp_path / "reg-port")
    argv = ["--config", str(config), "rollout", "promote", "--registry", reg,
            "--version", "2", "--device", "cpu"]
    assert cli.main(argv) == 0
    promote = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert promote["pass"] and promote["active"] == 2
    assert promote["incumbent"]["bound_frac"] == promote["candidate"]["bound_frac"] == 1.0
    assert trollout.CheckpointRegistry(reg).get(2).scores["gate"]["pass"] is True
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        reg = tmp_path / f"reg-{name}"
        (reg / "v000002" / "checkpoint" / "model.safetensors").write_bytes(b"torn")
        assert main(["--config", str(config), "rollout", "fsck", "--registry", str(reg)]) == 1
        assert json.loads(capsys.readouterr().out)["problems"]["2"]


def test_captures_and_releases_hold_the_device_wide_lock(monkeypatch):
    """A capture, and the drop of an engine's body pool at release, hold
    graphs.DEVICE_WIDE: another thread's capture in the same process
    forbids a device-wide sync, empty_cache and a pool's destruction."""
    from k8s_llm_scheduler_tpu_torch.engine import graphs

    held = []
    monkeypatch.setattr(graphs.GraphRunner, "_capture",
                        lambda self, prog: held.append(graphs.DEVICE_WIDE._is_owned()))
    graphs.GraphRunner(torch.device("cpu"), enabled=False).capture(None)
    assert held == [True] and not graphs.DEVICE_WIDE._is_owned()

    class Watched:
        def __setattr__(self, name, value):
            held.append((name, graphs.DEVICE_WIDE._is_owned()))

    eng = _torch_engine(init_params_cpu(), "dense")
    eng._graphs = Watched()
    eng.release()
    assert held[1:] == [("body_pool", True)]
