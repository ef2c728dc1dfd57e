"""The prefix-KV plane's `d2d` transport at tp > 1, held against the JAX
engine on a tp=2 mesh of the CPU devices (tests/conftest.py forces 8), at
f32 and greedy. Two port tp=2 groups in this process (this process the
driver of both, one spawned follower each, over gloo) stand for two
replicas on one host: the filler exports a pinned prefix `d2d` (each rank
keeping its block in its export table, the follower's shared as a file in
the group's scratch directory), the adopter's ranks copy the filler's
same-rank blocks, and the waves after it equal a JAX tp=2 adopter's on the
same mesh. The micro config is served under its name from this process's
registry and its seed-0 weights from a native checkpoint.
"""

import dataclasses
import gc
import os
from pathlib import Path

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
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.fleet import kvplane as tkv
from k8s_llm_scheduler_tpu_torch.fleet.kvplane.pages import RankBlocks
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.models.loader import save_checkpoint
from k8s_llm_scheduler_tpu_torch.parallel import launch

ttesting.cap_torch_threads()

_MICRO = dict(name="kvplane-tp-micro", vocab_size=512, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=4096, rope_theta=10000.0,
              tie_embeddings=True)
JMICRO = jconfigs.LlamaConfig(**_MICRO, dtype=jnp.float32)
TMICRO = tconfigs.LlamaConfig(**_MICRO, dtype=torch.float32)
WAIT_S = 600.0
ENGINE_KW = dict(num_pages=256, page_size=16, max_slots=4, max_pages_per_seq=32,
                 prefill_buckets=(32, 64, 128, 256, 512, 1024, 2048), chunk_steps=4,
                 temperature=0.0, prefix_chunk=256, admission_chunk_tokens=16)
BACKEND_KW = dict(max_new_tokens=80, packed_admission=False, request_timeout_s=WAIT_S,
                  prewarm_idle_delay_s=WAIT_S, delta_prompts=True)
TOK = ByteTokenizer()
PREFIX = TOK.encode("CLUSTER STATE: " + " ".join(f"node-{i} cpu={10 + i}" for i in range(4)))
OTHER = TOK.encode("CLUSTER STATE: " + " ".join(f"node-{i} mem={20 + i}" for i in range(5)))
PROMPTS = [TOK.encode("pod-a needs a node"), TOK.encode("p" * 45), TOK.encode("pod-c")]
BUDGET = 10


@pytest.fixture(scope="module")
def tree():
    """Seed 0's JAX tree (numpy) and the port's."""
    jp = jax.tree_util.tree_map(np.asarray, jinit_params(jax.random.PRNGKey(0), JMICRO))
    return jp, params_from_jax(jp, "cpu")


@pytest.fixture(scope="module")
def ckpt(tree, tmp_path_factory):
    """Seed 0's tree as a native checkpoint, MICRO registered under its
    name while the module runs."""
    path = tmp_path_factory.mktemp("kvplane-tp") / "ckpt"
    save_checkpoint(path, tree[1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tconfigs._REGISTRY, TMICRO.name, TMICRO)
        yield str(path)


def _build(ckpt):
    return build_local_backend(TMICRO.name, device="cpu", checkpoint_path=ckpt,
                               mesh_axes={"tp": 2}, **ENGINE_KW, **BACKEND_KW)


@pytest.fixture(scope="module")
def groups(ckpt):
    """The filler's and the adopter's tp=2 backends."""
    built = []
    try:
        for _ in range(2):
            built.append(_build(ckpt))
        yield tuple(built)
    finally:
        for backend in built:
            backend.close()


def _jax_mesh_engine(jp):
    """The JAX engine on a tp=2 mesh of the CPU devices."""
    mesh = jmake_mesh({"tp": 2})
    params = jshard_params(jax.tree_util.tree_map(jnp.asarray, jp), mesh, jserving_specs(JMICRO))
    return JEngine(params, JMICRO, JByteTokenizer(), mesh=mesh, **ENGINE_KW)


def _wave(engine, prefix=PREFIX) -> list:
    engine.set_grammar(None)
    engine.set_prefix(prefix)
    return [f.token_ids for f in engine.decide_wave(PROMPTS, BUDGET)]


@pytest.fixture(scope="module")
def jax_adopted(tree):
    """A JAX tp=2 engine exports PREFIX's pages d2d and a second one on the
    same mesh adopts them: the adopter's wave, and whether it prefilled."""
    jfill, jadopt = _jax_mesh_engine(tree[0]), _jax_mesh_engine(tree[0])
    key, _ = jfill.pin_prefix(PREFIX)
    pages = jkv.export_pages(jfill, key, generation=0, filler="jax-fill", transport="d2d")
    jkv.adopt_pages(jadopt, pages)
    wave = _wave(jadopt)
    return {"pages": pages, "wave": wave, "prefills": jadopt.stats["prefix_prefills"]}


def _states(engine) -> list[dict]:
    return engine.rank_group.on_ranks(launch.engine_state)


def _in_step(engine) -> None:
    group = engine.rank_group
    assert group.broken is None and not group.closed
    assert all(p.exitcode is None for p in group.procs)


def _entries(engine, key) -> list:
    return engine.rank_group.on_ranks(ttesting.cached_prefix_kv, key)


def test_d2d_pages_adopt_on_a_second_group_like_the_jax_pair(groups, jax_adopted):
    """The filler's d2d export holds the whole model's shape in RankBlocks
    (the JAX page set's shape and bytes), rank 0's tensors by reference and
    the follower's block as a handle; the adopter's waves after the
    adoption equal the JAX adopter's, no adopter rank prefilled a prefix,
    and neither group's tp collectives booked a count or a byte for the
    export or the adoption."""
    filler, adopter = (b.engine for b in groups)
    key, _ = filler.pin_prefix(PREFIX)
    fill_book = filler.rank_group.on_ranks(launch.rank_collectives)
    pages = tkv.export_pages(filler, key, generation=0, filler="fill", transport="d2d")
    assert filler.rank_group.on_ranks(launch.rank_collectives) == fill_book
    jpages = jax_adopted["pages"]
    assert pages.transport == "d2d" and isinstance(pages.k, RankBlocks)
    assert dataclasses.astuple(pages.geometry) == dataclasses.astuple(jpages.geometry)
    assert pages.k.shape == tuple(jpages.k.shape) and pages.nbytes == jpages.nbytes
    export = pages.k.export
    assert export.local[0] is filler._prefix_cache[key].k
    (handles,) = export.handles
    assert [h["kind"] for h in handles] == ["file", "file"]
    assert filler.rank_group.on_ranks(launch.export_table) == [[export.export_id]] * 2

    before = _states(adopter)
    book = adopter.rank_group.on_ranks(launch.rank_collectives)
    assert tkv.adopt_pages(adopter, pages) == (tuple(PREFIX), adopter.prefix_epoch)
    assert adopter.rank_group.on_ranks(launch.rank_collectives) == book
    wave = _wave(adopter)
    after = _states(adopter)
    assert wave == jax_adopted["wave"]
    assert jax_adopted["prefills"] == 0
    assert [a["prefix_prefills"] - b["prefix_prefills"] for a, b in zip(after, before)] == [0, 0]
    assert [a["adopted_prefixes"] - b["adopted_prefixes"] for a, b in zip(after, before)] == [1, 1]
    for engine in (filler, adopter):
        _in_step(engine)


def test_the_fillers_later_writes_and_eviction_leave_the_adopted_entry(groups, jax_adopted):
    """Every rank of the filler writes into its entry, then evicts it: the
    adopter's entry on every rank is as it was, and so are its tokens."""
    filler, adopter = (b.engine for b in groups)
    key, _ = filler.pin_prefix(PREFIX)
    pages = tkv.export_pages(filler, key, generation=0, filler="fill", transport="d2d")
    tkv.adopt_pages(adopter, pages)
    held = _entries(adopter, key)
    filler.rank_group.on_ranks(ttesting.scribble_prefix, key, 7.0)
    assert all(torch.all(k == 7.0) for k, _ in _entries(filler, key))
    filler.rank_group.on_ranks(ttesting.clear_prefix_cache)
    assert _entries(filler, key) == [None, None]
    for got, want in zip(_entries(adopter, key), held):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _wave(adopter) == jax_adopted["wave"]
    _in_step(adopter)


def test_every_filler_rank_drops_its_blocks_once_the_store_drops_the_page_set(groups):
    """Two page sets published to a store of one entry: the LRU eviction
    of the first releases its blocks on every filler rank, the generation
    bump the second's; then every rank's export table is empty, the
    book holds nothing and the shared files are gone."""
    filler = groups[0].engine
    group = filler.rank_group
    store = tkv.KVPlaneStore(max_entries=1)
    ids = []
    for prefix in (PREFIX, OTHER):
        key, _ = filler.pin_prefix(prefix)
        pages = tkv.export_pages(filler, key, generation=0, filler="fill", transport="d2d")
        ids.append(pages.k.export.export_id)
        assert store.publish(pages, store.try_fill(pages.digest, "fill"))
        del pages
    gc.collect()
    assert store.counters["evictions"] == 1
    assert group.on_ranks(launch.export_table) == [[ids[1]]] * 2
    store.bump_generation()
    gc.collect()
    assert group.on_ranks(launch.export_table) == [[], []]
    assert group.exports.live() == []
    assert not list(Path(group.scratch.name).glob("kv-*"))
    _in_step(filler)


def test_a_swap_of_the_filler_releases_its_blocks_and_refuses_their_adoption(groups):
    """The filler's prefix_epoch moves on (every rank swapping to the
    weights it serves): the call that bumped it releases the export on
    every rank, and an adoption of the page set is refused before any
    adopter rank is touched."""
    filler, adopter = (b.engine for b in groups)
    key, _ = filler.pin_prefix(PREFIX)
    pages = tkv.export_pages(filler, key, generation=0, filler="fill", transport="d2d")
    filler.rank_group.on_ranks(ttesting.swap_to_own_weights)
    assert filler.rank_group.on_ranks(launch.export_table) == [[], []]
    seq = adopter.rank_group._seq
    with pytest.raises(RuntimeError, match="d2d prefix pages of 'fill' were released"):
        tkv.adopt_pages(adopter, pages)
    assert adopter.rank_group._seq == seq
    _in_step(filler)


def test_two_tp2_backends_share_d2d_pages_like_the_jax_pair(groups, tree):
    """Two tp=2 backends attached to one KVPlaneStore with transport d2d:
    the first wins the fill election and publishes, the second adopts, and
    both name the nodes (with the reasoning) the JAX pair names."""
    pods, nodes = ttesting.fixture_pods(2), ttesting.synthetic_nodes(3)
    jstore = jkv.KVPlaneStore()
    jbackends = [JBackend(_jax_mesh_engine(tree[0]), tokenizer=JByteTokenizer(),
                          max_new_tokens=80, delta_prompts=True, request_timeout_s=WAIT_S,
                          prewarm_idle_delay_s=WAIT_S) for _ in range(2)]
    try:
        for i, jb in enumerate(jbackends):
            jb.attach_kvplane(jstore, replica=f"replica-{i}", transport="d2d")
        want = [jb.get_scheduling_decision(JPodSpec(**dataclasses.asdict(pods[0])),
                                           [JNodeMetrics(**dataclasses.asdict(n))
                                            for n in nodes]) for jb in jbackends]
        jstats = [jb.get_stats()["kvplane"] for jb in jbackends]
    finally:
        for jb in jbackends:
            jb.close()
    store = tkv.KVPlaneStore()
    for i, backend in enumerate(groups):
        backend.engine.rank_group.on_ranks(ttesting.clear_prefix_cache)
        backend.attach_kvplane(store, replica=f"replica-{i}", transport="d2d")
    got = [b.get_scheduling_decision(pods[0], nodes) for b in groups]
    stats = [b.get_stats()["kvplane"] for b in groups]
    assert [(d.selected_node, d.reasoning) for d in got] == [
        (d.selected_node, d.reasoning) for d in want]
    keys = ("elections_won", "publishes", "adoptions")
    assert [{k: s[k] for k in keys} for s in stats] == [{k: s[k] for k in keys} for s in jstats]
    assert stats[0]["publishes"] == 1 and stats[1]["adoptions"] == 1
    (published,) = store._entries.values()
    assert published.transport == "d2d" and isinstance(published.k, RankBlocks)
    for backend in groups:
        _in_step(backend.engine)


def test_a_handle_that_fails_to_open_takes_the_adopting_group_down(groups, ckpt, capfd):
    """The filler's rank-1 block is gone (its file removed): the adopter's
    rank 1 raises naming itself and the filler, its rank 0 adopted, so the
    settle finds the ranks out of step and the adopting group goes down as
    after any such call. The filler serves on."""
    filler = groups[0].engine
    key, _ = filler.pin_prefix(PREFIX)
    pages = tkv.export_pages(filler, key, generation=0, filler="fill", transport="d2d")
    (handles,) = pages.k.export.handles
    os.unlink(handles[0]["path"])
    backend = _build(ckpt)
    try:
        with pytest.raises(RuntimeError, match="out of step after adopt_kv_blocks"):
            tkv.adopt_pages(backend.engine, pages)
        assert backend.engine.rank_group.broken is not None
    finally:
        backend.close()
    assert "tp rank 1 could not open the d2d prefix pages of 'fill'" in capfd.readouterr().err
    assert _wave(filler) == _wave(groups[1].engine)
    _in_step(filler)


@pytest.mark.parametrize("which", [0, 1], ids=["filler", "adopter"])
def test_follower_ranks_import_no_jax_after_d2d(groups, which):
    """The followers that exported and adopted d2d pages import torch and
    the port only."""
    follower = groups[which].engine.rank_group.on_ranks(launch.loaded_packages)[1]
    assert "k8s_llm_scheduler_tpu_torch" in follower and "torch" in follower
    assert "jax" not in follower and "k8s_llm_scheduler_tpu" not in follower
