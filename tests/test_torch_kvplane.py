"""The port's shared prefix-KV plane (fleet/kvplane/, engine export and
adoption, the pin manager's plane route, the backend's attach_kvplane,
HotSwapper's generation bump) held against the JAX package on the CPU.

- Protocol: one scripted sequence of pins, generation bumps, a fenced
  publish, a fill stall, an outage and a stale-generation presentation,
  run through each package's store and clients over StubPinEngine, gives
  the same gauges, client stats, engine stats and resident KV digests.
- Geometry: KVGeometry.of_engine(...).describe() is the same string for a
  JAX and a port engine of one config (bf16 and f32).
- Across frameworks: pages the JAX engine exports are adopted by the port
  engine on the same weights (models/convert.params_from_jax), and the
  other way round; the adopter's greedy tokens equal the local-prefill
  arm's exactly (MICRO, f32).
- The port engine's adoption contract (the JAX TestEngineAdoption cases):
  token identity with zero prefill, pressure, wrong shapes, a swap that
  kills adopted pins; and a d2d adoption that survives the filler's
  eviction and a later write to the filler's buffer.
- `cli fleet kvplane --json` prints the JAX CLI's record.
- HotSwapper(kvplane=) bumps the store generation after a swap; the pin
  manager routes through the plane; a port Fleet(kvplane=) over two TINY
  LocalLLMBackends attaches both, and the second adopts the first's pages.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu import cli as jcli
from k8s_llm_scheduler_tpu.engine.admission import PinnedPrefixManager as JPinManager
from k8s_llm_scheduler_tpu.engine.engine import InferenceEngine as JEngine
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu.fleet import kvplane as jkv
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch import rollout as trollout
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.cluster.fake import FakeCluster
from k8s_llm_scheduler_tpu_torch.engine.admission import PinnedPrefixManager as TPinManager
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine as TEngine
from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.fleet import Fleet
from k8s_llm_scheduler_tpu_torch.fleet import kvplane as tkv
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.models.llama import init_params as tinit_params
from k8s_llm_scheduler_tpu_torch.models.loader import save_checkpoint

ttesting.cap_torch_threads()

TOK = ByteTokenizer()
_MICRO = dict(name="kvplane-micro", vocab_size=512, d_model=64, n_layers=2,
              n_heads=2, n_kv_heads=1, d_ff=128, max_seq_len=4096,
              rope_theta=10000.0, tie_embeddings=True)
JMICRO = jconfigs.LlamaConfig(**_MICRO, dtype=jnp.float32)
TMICRO = tconfigs.LlamaConfig(**_MICRO, dtype=torch.float32)
TTINY = dataclasses.replace(tconfigs.TINY, dtype=torch.float32)
ENGINE_KW = dict(num_pages=128, page_size=16, max_slots=4, max_pages_per_seq=16,
                 prefill_buckets=(32, 64, 128, 256, 512, 1024, 2048), chunk_steps=4,
                 temperature=0.0, prefix_chunk=64)
WAIT_S = 600.0  # a slow decision on a crowded CPU must never time out
PIN = TOK.encode("CLUSTER STATE: " + " ".join(
    f"node-{i} cpu={10 + i} mem={20 + i}" for i in range(6)))
PROMPTS = [TOK.encode("pod-a needs a node"), TOK.encode("pod-b: which node?")]
NEW = 8


@pytest.fixture(scope="module")
def params():
    jp = jinit_params(jax.random.PRNGKey(0), JMICRO)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def t_engine(tp, **kw):
    return TEngine(tp, TMICRO, TOK, **{**ENGINE_KW, **kw})


def j_engine(jp, **kw):
    return JEngine(jp, JMICRO, JByteTokenizer(), fused_decode=False, **{**ENGINE_KW, **kw})


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def _greedy(engine):
    engine.set_prefix(PIN)
    return [engine.generate(p, max_new_tokens=NEW).token_ids for p in PROMPTS]


# ------------------------------------------------------------- protocol
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Script:
    """Chaos-seam stand-in: fire `kind` for `holders` (None = everyone) at
    most `times` times; swapped in and out by the scripted sequence."""

    def __init__(self):
        self.kind = self.holders = None
        self.times = 0

    def arm(self, kind, holders=None, times=1):
        self.kind, self.holders, self.times = kind, holders, times

    def should(self, kind, key=None, where=None):
        if kind != self.kind or self.times <= 0:
            return False
        if self.holders is not None and key not in self.holders:
            return False
        self.times -= 1
        return True


def _protocol(kv):
    """The scripted sequence through one package's plane: returns every
    number it keeps."""
    clock, seam = _Clock(), _Script()
    store = kv.KVPlaneStore(fill_ttl_s=5.0, max_entries=3, n_fill_shards=16, clock=clock)
    store.fault_seam = seam
    clients = [kv.KVPlaneClient(store, kv.StubPinEngine(), replica=f"r{i}") for i in range(3)]
    r0, r1, r2 = clients
    ids = {name: [1000 * i + j for j in range(24 + 8 * i)]
           for i, name in enumerate("ABCDEF")}
    trail = []

    def pin(client, name):
        key, epoch, source = client.pin(ids[name])
        trail.append((client.replica, name, epoch, source, len(key)))

    # fill once, adopt twice
    for c in clients:
        pin(c, "A")
    # a hot swap elsewhere: every replica's next lookup syncs and re-fills
    store.bump_generation()
    pin(r1, "A")
    pin(r0, "A")
    # a fenced publish: r0's fill lease expires, r2 takes the shard, and
    # r0's late publish is refused
    eng = r0.engine
    key, _ = eng.pin_prefix(ids["B"])
    digest = kv.page_digest(ids["B"])
    lease = store.try_fill(digest, "r0")
    clock.t += 6.0
    lease2 = store.try_fill(digest, "r2")
    pages = kv.export_pages(eng, key, generation=store.generation, filler="r0")
    trail.append(("fenced", store.publish(pages, lease), lease2 is not None))
    store.lease.release(lease2.shard_id, "r2")
    # a filler dies mid-publish: its lease is held to the TTL, waiters
    # degrade locally, and the next election after the TTL fills
    seam.arm("fill_stall", holders={"r2"})
    pin(r2, "C")
    pin(r0, "C")
    clock.t += 6.0
    pin(r1, "C")
    # the store is unreachable for two operations
    seam.arm("store_down", times=2)
    pin(r0, "D")
    pin(r1, "D")
    pin(r2, "D")
    # a stale generation presented once: refused, never served
    seam.arm("stale_generation", holders={"r1"})
    pin(r1, "D")
    # LRU eviction past max_entries
    for name in "EF":
        pin(r2, name)
    # a mismatched geometry refuses loudly
    tp4 = kv.KVPlaneClient(store, kv.StubPinEngine(
        geometry=kv.KVGeometry(2, 2, 4, "float32", tp=4)), replica="tp4")
    with pytest.raises(kv.KVGeometryError):
        tp4.pin(ids["F"])
    digests = {c.replica: {n: c.engine.kv_digest(ids[n]) for n in ids} for c in clients}
    return {"trail": trail, "gauges": store.gauges(),
            "clients": {c.replica: c.stats() for c in clients},
            "engines": {c.replica: c.engine.get_stats() for c in clients},
            "digests": digests}


def test_scripted_protocol_matches_the_jax_plane():
    got, want = _protocol(tkv), _protocol(jkv)
    assert got == want
    g = got["gauges"]
    # the script reached every branch it names
    assert g["generation_bumps"] == 1 and g["fill_stalls"] == 1
    assert g["store_outages"] == 2 and g["stale_rejections"] >= 1
    assert g["evictions"] >= 1 and g["geometry_refusals"] == 1
    assert ("fenced", False, True) in got["trail"]
    assert sum(c["local_fallbacks"] for c in got["clients"].values()) >= 3
    # adopted and local KV of the same ids agree byte for byte
    for name in "ACD":
        assert len({d[name] for d in got["digests"].values() if d[name]}) == 1


def test_pin_manager_routes_through_the_plane():
    """ensure() pins through the plane and source_of() shows provenance,
    as the JAX manager does."""
    out = []
    for kv, manager in ((tkv, TPinManager), (jkv, JPinManager)):
        store = kv.KVPlaneStore()
        engines = [kv.StubPinEngine(), kv.StubPinEngine()]
        mgrs = [manager(e, kvplane=kv.KVPlaneClient(store, e, replica=f"r{i}"))
                for i, e in enumerate(engines)]
        ids = [71, 72, 73]
        rec = [m.ensure("snap-1", ids) for m in mgrs]
        rec += [m.source_of("snap-1") for m in mgrs]
        rec += [engines[1].stats["prefix_prefills"], mgrs[1].ensure("snap-1", ids),
                mgrs[1].source_of("snap-1"), store.gauges(), mgrs[1].stats()]
        out.append(rec)
    assert out[0] == out[1]
    assert out[0][:5] == [True, True, "local", "shared", 0]


# ------------------------------------------------------------- geometry
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_geometry_is_one_string_in_both_packages(dtype):
    jcfg = dataclasses.replace(jconfigs.TINY, dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tconfigs.TINY, dtype=getattr(torch, dtype))
    kw = dict(num_pages=16, page_size=16, max_slots=2, max_pages_per_seq=4,
              prefill_buckets=(32, 64))
    jeng = JEngine(jinit_params(jax.random.PRNGKey(0), jcfg), jcfg, JByteTokenizer(), **kw)
    teng = TEngine(tinit_params(tcfg, seed=0, device="cpu"), tcfg, TOK, **kw)
    want = jkv.KVGeometry.of_engine(jeng)
    got = tkv.KVGeometry.of_engine(teng)
    assert got.describe() == want.describe() == f"L4xkv2xhd64/{dtype}/tp1"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# -------------------------------------------------------- across frameworks
def _as(kv, pages, to_array):
    """`pages` rebuilt as the other package's PrefixPageSet, its buffers
    through `to_array`: what a networked store would carry."""
    return kv.PrefixPageSet(
        digest=pages.digest, token_ids=tuple(pages.token_ids),
        geometry=kv.KVGeometry(**dataclasses.asdict(pages.geometry)),
        k=to_array(pages.k), v=to_array(pages.v), transport="host",
        generation=pages.generation, filler=pages.filler)


def test_jax_pages_adopted_by_the_port_engine(params):
    jp, tp = params
    filler = j_engine(jp)
    key, _ = filler.pin_prefix(PIN)
    baseline = _greedy(filler)  # the JAX engine's local-prefill arm
    pages = jkv.export_pages(filler, key, generation=0, filler="jax")
    assert isinstance(pages.k, np.ndarray)
    adopter = t_engine(tp)
    akey, epoch = tkv.adopt_pages(adopter, _as(tkv, pages, lambda a: torch.from_numpy(
        np.array(a))))
    assert akey == tuple(PIN) and adopter.pin_alive(akey, epoch)
    assert _greedy(adopter) == baseline
    assert adopter.stats["prefix_prefills"] == 0
    assert adopter.stats["adopted_prefixes"] == 1


def test_port_pages_adopted_by_the_jax_engine(params):
    jp, tp = params
    filler = t_engine(tp)
    key, _ = filler.pin_prefix(PIN)
    baseline = _greedy(filler)  # the port engine's local-prefill arm
    pages = tkv.export_pages(filler, key, generation=0, filler="port")
    assert isinstance(pages.k, torch.Tensor) and pages.k.device.type == "cpu"
    assert pages.nbytes == 2 * pages.k.numel() * 4 and pages.length == len(PIN)
    assert pages.digest == jkv.page_digest(PIN)
    adopter = j_engine(jp)
    jkv.adopt_pages(adopter, _as(jkv, pages, lambda t: t.numpy()))
    assert _greedy(adopter) == baseline
    assert adopter.stats["prefix_prefills"] == 0
    # and the JAX engine's own local arm agrees with both
    assert _greedy(j_engine(jp)) == baseline


def test_exported_buffers_match_the_jax_engine(params):
    """Both engines ship the whole capacity buffer of the same shape, and
    its values agree to f32 round-off."""
    jp, tp = params
    jf, tf = j_engine(jp), t_engine(tp)
    jpages = jkv.export_pages(jf, jf.pin_prefix(PIN)[0], generation=0, filler="j")
    tpages = tkv.export_pages(tf, tf.pin_prefix(PIN)[0], generation=0, filler="t")
    assert tuple(tpages.k.shape) == jpages.k.shape
    assert tpages.k.shape[1] > len(PIN)  # the padding travels too
    np.testing.assert_allclose(tpages.k.numpy(), jpages.k, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tpages.v.numpy(), jpages.v, rtol=1e-4, atol=1e-4)


# ------------------------------------------------- the port's adoption
class TestEngineAdoption:
    @pytest.mark.parametrize("transport", ["host", "d2d"])
    def test_adopted_pages_token_identity(self, params, transport):
        """A replica that adopted exported pages greedy-decodes what it
        decodes after a local prefill of the same prefix, with no prefill
        paid and no new static prefix buffer."""
        tp = params[1]
        filler, adopter = t_engine(tp), t_engine(tp)
        key_local, _ = adopter.pin_prefix(PIN)
        baseline = _greedy(adopter)
        adopter.unpin_prefix(key_local)
        adopter._prefix_cache.clear()
        prefills = adopter.stats["prefix_prefills"]
        buffers = set(adopter._static_prefix)
        key, _ = filler.pin_prefix(PIN)
        pages = tkv.export_pages(filler, key, generation=0, filler="f", transport=transport)
        assert (pages.k is filler.export_prefix_kv(key)[0]) == (transport == "d2d")
        akey, _ = tkv.adopt_pages(adopter, pages)
        assert akey == tuple(PIN)
        assert _greedy(adopter) == baseline
        assert adopter.stats["prefix_prefills"] == prefills
        assert adopter.stats["adopted_prefixes"] == 1
        assert adopter.stats["pinned_prefixes"] == 2  # the local pin, then the adopted one
        assert set(adopter._static_prefix) == buffers

    def test_adoption_pins_and_survives_pressure(self, params):
        tp = params[1]
        filler, adopter = t_engine(tp), t_engine(tp)
        pin_ids = TOK.encode("p" * 120)
        key, _ = filler.pin_prefix(pin_ids)
        pages = tkv.export_pages(filler, key, generation=0, filler="f")
        akey, epoch = tkv.adopt_pages(adopter, pages)
        assert adopter.pin_alive(akey, epoch)
        adopter.PREFIX_CACHE_BYTES = 1
        adopter.set_prefix(TOK.encode("q" * 120))
        adopter.set_prefix(TOK.encode("r" * 120))
        assert adopter.pin_alive(akey, epoch)  # an adopted pin is never evicted

    def test_adopt_rejects_wrong_shapes(self, params):
        adopter = t_engine(params[1])
        bad = np.zeros((1, 8, 1, 32), dtype=np.float32)  # n_layers=1
        with pytest.raises(ValueError, match="shape"):
            adopter.adopt_prefix_pages([1, 2, 3], bad, bad)
        short = torch.zeros((2, 2, 1, 32))  # cap below the prefix length
        with pytest.raises(ValueError, match="shape"):
            adopter.adopt_prefix_pages([1, 2, 3], short, short)
        with pytest.raises(ValueError, match="shape"):
            adopter.adopt_prefix_pages([1], torch.zeros((2, 8, 1, 32)),
                                       torch.zeros((2, 4, 1, 32)))
        with pytest.raises(ValueError, match="empty"):
            adopter.adopt_prefix_pages([], torch.zeros((2, 8, 1, 32)),
                                       torch.zeros((2, 8, 1, 32)))
        assert not adopter._prefix_cache and "adopted_prefixes" not in adopter.stats
        # a geometry mismatch is refused before the engine is asked
        pages = tkv.PrefixPageSet(
            digest=tkv.page_digest([1]), token_ids=(1,),
            geometry=tkv.KVGeometry(2, 1, 32, "float32", tp=4),
            k=torch.zeros((2, 8, 1, 32)), v=torch.zeros((2, 8, 1, 32)),
            transport="host", generation=0, filler="tp4")
        with pytest.raises(tkv.KVGeometryError):
            tkv.adopt_pages(adopter, pages)

    def test_swap_invalidates_adopted_pins(self, params):
        """Adopted pins obey the epoch contract of local pins: a weight
        swap kills them."""
        tp = params[1]
        filler, adopter = t_engine(tp), t_engine(_clone(tp))
        pin_ids = TOK.encode("s" * 80)
        key, _ = filler.pin_prefix(pin_ids)
        pages = tkv.export_pages(filler, key, generation=0, filler="f")
        akey, epoch = tkv.adopt_pages(adopter, pages)
        other = params_from_jax(jax.tree_util.tree_map(
            np.asarray, jinit_params(jax.random.PRNGKey(1), JMICRO)), "cpu")
        adopter.swap_params(other)
        assert not adopter.pin_alive(akey, epoch)
        assert filler.pin_alive(key, 0)  # the filler's own weights and pin stand

    def test_d2d_adoption_owns_its_buffer(self, params):
        """A d2d page set references the filler's tensors; the adopted
        entry is a copy, so the filler's eviction and a later write into
        the filler's buffer leave it, and its tokens, as they were."""
        tp = params[1]
        filler, adopter = t_engine(tp), t_engine(tp)
        baseline = _greedy(t_engine(tp))
        key, _ = filler.pin_prefix(PIN)
        pages = tkv.export_pages(filler, key, generation=0, filler="f", transport="d2d")
        akey, _ = tkv.adopt_pages(adopter, pages)
        held = adopter.export_prefix_kv(akey)
        snapshot = [t.clone() for t in held]
        assert held[0] is not pages.k and held[0].data_ptr() != pages.k.data_ptr()
        filler.unpin_prefix(key)
        filler.PREFIX_CACHE_BYTES = 1
        filler.set_prefix(TOK.encode("x" * 100))  # byte pressure evicts the old entry
        assert filler.export_prefix_kv(key) is None
        pages.k.fill_(7.0)
        pages.v.fill_(-7.0)
        assert all(torch.equal(a, b) for a, b in zip(adopter.export_prefix_kv(akey), snapshot))
        assert _greedy(adopter) == baseline


# ------------------------------------------------------- rollout and fleet
def test_hotswapper_bumps_the_plane_generation(tmp_path):
    """A completed swap_to bumps the store generation once (beside the
    decision cache's), so every replica refuses pre-swap pages; a backend
    joined to that plane then re-fills its pin under the new weights."""
    registry = trollout.CheckpointRegistry(tmp_path / "reg")
    for seed in (0, 1):
        save_checkpoint(tmp_path / f"ckpt{seed}", tinit_params(TTINY, seed=seed, device="cpu"))
        registry.publish(tmp_path / f"ckpt{seed}", cfg=TTINY, note=f"seed {seed}")
    registry.set_active(1)
    engine = TEngine(tinit_params(TTINY, seed=0, device="cpu"), TTINY, TOK, **ENGINE_KW)
    backend = LocalLLMBackend(engine, max_new_tokens=80, delta_prompts=True,
                              request_timeout_s=WAIT_S, prewarm_idle_delay_s=WAIT_S)
    store = tkv.KVPlaneStore()
    backend.attach_kvplane(store, replica="replica-0")
    swapper = trollout.HotSwapper(backend, registry, TTINY, kvplane=store)
    nodes, pods = ttesting.synthetic_nodes(3), ttesting.fixture_pods(2)
    try:
        backend.get_scheduling_decision(pods[0], nodes)
        assert store.gauges()["entries"] == 1
        result = swapper.swap_to(2)
        assert result["version"] == 2
        assert store.generation == 1 and store.gauges()["entries"] == 0
        backend.get_scheduling_decision(pods[1], nodes)
        kv = backend.get_stats()["kvplane"]
    finally:
        backend.close()
    assert kv["generation_syncs"] == 1 and kv["elections_won"] == 2
    assert kv["publishes"] == 2 and kv["known_generation"] == 1
    assert store.gauges()["fills"] == 2 and store.gauges()["entries"] == 1


def test_staggered_swap_withholds_the_bump_when_stopped():
    from k8s_llm_scheduler_tpu_torch.rollout.canary import staggered_swap

    store = tkv.KVPlaneStore()
    staggered_swap([lambda: "ok", lambda: "bad"], verify=lambda i, r: r == "ok",
                   kvplane_store=store)
    assert store.generation == 0
    staggered_swap([lambda: "ok", lambda: "ok"], verify=lambda i, r: r == "ok",
                   kvplane_store=store)
    assert store.generation == 1


def test_fleet_attaches_real_backends_to_the_plane():
    """Fleet(kvplane=) over two TINY LocalLLMBackends: both join the plane
    (the port's backend has attach_kvplane, so the frontend's hasattr
    check passes), replica 0 fills, replica 1 adopts, and both decide the
    same node with the same reasoning."""
    params = tinit_params(TTINY, seed=0, device="cpu")
    backends = [
        LocalLLMBackend(TEngine(params, TTINY, TOK, **ENGINE_KW), max_new_tokens=80,
                        delta_prompts=True, request_timeout_s=WAIT_S,
                        prewarm_idle_delay_s=WAIT_S)
        for _ in range(2)
    ]
    store = tkv.KVPlaneStore()
    cluster = FakeCluster()
    fleet = Fleet(cluster, cluster, lambda i: backends[i], n_replicas=2, kvplane=store)
    nodes, pod = ttesting.synthetic_nodes(3), ttesting.fixture_pods(1)[0]
    try:
        assert [b._kvplane.replica for b in backends] == ["replica-0", "replica-1"]
        assert all(b._pin_manager.kvplane is b._kvplane for b in backends)
        decisions = [b.get_scheduling_decision(pod, nodes) for b in backends]
        stats = [b.get_stats()["kvplane"] for b in backends]
        sources = [next(iter(b._pin_manager.pins.values())).source for b in backends]
    finally:
        for b in backends:
            b.close()
    assert sources == ["local", "shared"]
    assert stats[0]["publishes"] == 1 and stats[1]["adoptions"] == 1
    assert backends[1].engine.stats["adopted_prefixes"] == 1
    assert (decisions[0].selected_node, decisions[0].reasoning) == (
        decisions[1].selected_node, decisions[1].reasoning)
    assert fleet.get_stats()["kvplane"]["adoptions"] == 1


@pytest.mark.parametrize("argv", [["--replicas", "4"],
                                  ["--replicas", "3", "--snapshots", "5", "--swap-every", "2",
                                   "--pin-tokens", "64"]])
def test_cli_fleet_kvplane_prints_the_jax_record(argv, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = []
    for main in (cli.main, jcli.main):
        rc = main(["fleet", "kvplane", "--json"] + argv)
        out.append((rc, json.loads(capsys.readouterr().out)))
    assert out[0] == out[1]
    rc, record = out[0]
    assert rc == 0 and record["dedup_ratio"] > 1
    for stats in record["clients"].values():  # every pin accounted for
        assert (stats["adoptions"] + stats["elections_won"] + stats["local_fallbacks"]
                == record["snapshots"])
