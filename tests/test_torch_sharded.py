"""The port's tensor-parallel engine held against the JAX package's engine
on the CPU (tests/test_sharded.py pins the JAX engine's tp=2 == tp=1):
a tp=2 port engine (two processes over gloo) is token-identical, at f32
and greedy, to the JAX engine off-mesh through generate, admit_packed +
step_fused and a grammar-constrained decision through LocalLLMBackend;
the refusals (ragged at tp>1, CUDA graphs over gloo, a dp serving mesh,
indivisible heads, speculative decoding, which item 9d ports); failures (a
follower killed mid-wave, a wave that fails on one rank alone, a call
every rank refuses); member_tp. The hot swap, the prefix-KV plane and the
persistent loop at tp=2 are tests/test_torch_tp_paths.py's.

The micro config is served under its name from this process's registry
(the driver resolves the model and hands its config to the follower), and
the JAX weights as a native checkpoint.
"""

import dataclasses
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu.engine.engine import InferenceEngine as JEngine
from k8s_llm_scheduler_tpu.engine.local import LocalLLMBackend as JBackend
from k8s_llm_scheduler_tpu.engine.local import build_local_backend as jbuild
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.types import NodeMetrics as JNodeMetrics
from k8s_llm_scheduler_tpu.types import PodSpec as JPodSpec
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine, check_tp_serving
from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
from k8s_llm_scheduler_tpu_torch.engine.sharded import member_tp
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.models.loader import save_checkpoint
from k8s_llm_scheduler_tpu_torch.parallel import launch, mesh, sharding

ttesting.cap_torch_threads()

_MICRO = dict(name="sharded-micro", vocab_size=512, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=4096, rope_theta=10000.0,
              tie_embeddings=True)
JMICRO = jconfigs.LlamaConfig(**_MICRO, dtype=jnp.float32)
TMICRO = tconfigs.LlamaConfig(**_MICRO, dtype=torch.float32)
TIMEOUT_S = 600.0
FAIL_TIMEOUT_S = 5.0  # the group timeout of the failure tests' groups
ENGINE_KW = dict(num_pages=128, page_size=16, max_slots=4, max_pages_per_seq=32,
                 prefill_buckets=(32, 64, 128, 256, 512, 1024, 2048), chunk_steps=4,
                 temperature=0.0, prefix_chunk=256, admission_chunk_tokens=16)
BACKEND_KW = dict(max_new_tokens=80, packed_admission=False, request_timeout_s=TIMEOUT_S,
                  prewarm_idle_delay_s=TIMEOUT_S)
TOK = ByteTokenizer()
PREFIX = TOK.encode("CLUSTER STATE: " + " ".join(f"node-{i} cpu={10 + i}" for i in range(4)))
PROMPTS = [TOK.encode("pod-a needs a node"), TOK.encode("p" * 45), TOK.encode("pod-c")]


@pytest.fixture(scope="module")
def params():
    jp = jinit_params(jax.random.PRNGKey(0), JMICRO)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def micro(params, tmp_path_factory):
    """The checkpoint path of MICRO's JAX weights, with MICRO registered
    under its name while the module runs."""
    ckpt = tmp_path_factory.mktemp("micro") / "ckpt"
    save_checkpoint(ckpt, params[1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tconfigs._REGISTRY, TMICRO.name, TMICRO)
        yield str(ckpt)


def _build(ckpt: str, **kw):
    return build_local_backend(TMICRO.name, device="cpu", checkpoint_path=ckpt,
                               **{"mesh_axes": {"tp": 2}, **ENGINE_KW, **BACKEND_KW, **kw})


@pytest.fixture(scope="module")
def tp2(micro):
    backend = _build(micro)
    yield backend
    backend.close()


def _jax_nodes(nodes):
    return [JNodeMetrics(**dataclasses.asdict(n)) for n in nodes]


def _drain_fused(engine, req_ids):
    out = {}
    while len(out) < len(req_ids):
        for fin in engine.step_fused():
            out[fin.req_id] = fin.token_ids
    return [out[r] for r in req_ids]


def test_generate_and_packed_admission_equal_the_jax_engine(params, tp2):
    """generate and admit_packed + step_fused on the tp=2 port engine give
    the JAX engine's tokens off-mesh, token for token (JAX
    tests/test_sharded.py:379 pins its own tp=2 to tp=1)."""
    jp, _ = params
    jengine = JEngine(jp, JMICRO, JByteTokenizer(), **ENGINE_KW)
    outs = []
    for engine in (jengine, tp2.engine):
        engine.set_prefix(PREFIX)
        serial = [engine.generate(p, max_new_tokens=8).token_ids for p in PROMPTS]
        packed = _drain_fused(engine, engine.admit_packed(PROMPTS, max_new_tokens=8))
        outs.append((serial, packed))
    assert outs[1] == outs[0]
    assert outs[1][0] == outs[1][1]
    assert tp2.engine.plane.tp == 2 and tp2.engine.cfg.n_kv_heads == 1
    assert tuple(tp2.engine.kv.k.shape[-2:]) == (1, 16)  # the rank's kv head


def test_decision_through_the_backend_equals_the_jax_backend(params, tp2):
    """A grammar-constrained decision wave through LocalLLMBackend over
    the tp=2 engine picks the JAX backend's node with its reasoning."""
    jp, _ = params
    pods = ttesting.fixture_pods(2)
    nodes = ttesting.synthetic_nodes(4)
    got = [tp2.get_scheduling_decision(p, nodes) for p in pods]
    jbackend = JBackend(JEngine(jp, JMICRO, JByteTokenizer(), **ENGINE_KW), **BACKEND_KW)
    try:
        want = [jbackend.get_scheduling_decision(
            JPodSpec(**dataclasses.asdict(p)), _jax_nodes(nodes)) for p in pods]
    finally:
        jbackend.close()
    assert [(d.selected_node, d.confidence, d.reasoning) for d in got] == [
        (d.selected_node, d.confidence, d.reasoning) for d in want]
    assert tp2.engine.stats["waves"] >= 1
    assert member_tp(tp2) == 2


def test_unported_paths_raise_at_tp2_naming_item_9d(tp2):
    """What tp > 1 still refuses: speculative decoding (the JAX entry
    point keeps plain decode on a tp mesh), naming item 9d, and a
    swap_params the driver makes alone (a swap goes through every rank)."""
    engine = tp2.engine
    with pytest.raises(NotImplementedError, match="speculative decoding at tp=2.*item 9d"):
        engine.attach_spec(None)
    with pytest.raises(RuntimeError, match="swaps one rank"):
        engine.swap_params(engine.params)
    # the group still serves after the refusals
    assert engine.generate(PROMPTS[2], max_new_tokens=2).token_ids


@pytest.mark.parametrize("case", ["ragged", "dp2", "indivisible"])
def test_build_refusals(case, micro):
    """Refused before a follower is spawned: ragged at tp>1 and a dp
    serving mesh in the JAX package's words, indivisible heads with the
    JAX message."""
    if case == "ragged":
        with pytest.raises(ValueError, match="single-device-only"):
            _build(micro, decode_matmul="ragged")
        return
    axes = {"dp": 2} if case == "dp2" else {"tp": 4}
    with pytest.raises(ValueError) as jerr:
        jbuild("tiny", mesh_axes=axes)
    with pytest.raises(ValueError) as terr:
        build_local_backend("tiny", device="cpu", mesh_axes=axes)
    assert str(terr.value) == str(jerr.value)


def test_engine_refusals_and_the_graphs_rule(params):
    """The engine refuses ragged at tp>1 itself; graphs=True is refused
    over gloo on CUDA only (a unit check of the rule: no card here)."""
    m = mesh.make_mesh({"tp": 2}).bind(None, 0, timeout_s=5.0)
    shard = sharding.shard_params(params[1], m, specs=sharding.param_specs(TMICRO))
    with pytest.raises(ValueError, match="single-device-only"):
        InferenceEngine(shard, TMICRO, ByteTokenizer(), mesh=m, decode_matmul="ragged")
    with pytest.raises(ValueError, match="graphs=True over a gloo tp group on CUDA"):
        check_tp_serving(2, "gloo", "cuda", True, "dense")
    check_tp_serving(2, "nccl", "cuda", True, "dense")
    check_tp_serving(2, "gloo", "cuda", False, "dense")
    check_tp_serving(2, "gloo", "cpu", True, "dense")
    assert launch.choose_backend([0, 0]) == "gloo"


def test_a_killed_follower_makes_the_driver_raise(micro, monkeypatch):
    """An idle driver outlives the group timeout (a replica idles for
    hours); a follower killed while a decision wave is in flight, inside
    one of the driver dispatcher's collectives, then makes the decision
    raise within the group timeout, and every later call raise at once."""
    monkeypatch.setattr(launch, "GROUP_TIMEOUT_S", FAIL_TIMEOUT_S)
    backend = _build(micro)
    engine, group = backend.engine, backend.engine.rank_group
    follower = group.procs[0]
    pods, nodes = ttesting.fixture_pods(2), ttesting.synthetic_nodes(4)
    try:
        time.sleep(FAIL_TIMEOUT_S + 1.0)
        assert backend.get_scheduling_decision(pods[0], nodes).selected_node
        tp_group, armed = engine.plane.group, threading.Event()
        all_reduce = tp_group.all_reduce

        def killing(t):
            if armed.is_set() and threading.current_thread() is not threading.main_thread():
                armed.clear()
                follower.kill()
                follower.join(30)
            return all_reduce(t)

        monkeypatch.setattr(tp_group, "all_reduce", killing)
        armed.set()
        t0 = time.monotonic()
        with pytest.raises(Exception, match="tp group is down.*rank 1 exited"):
            backend.get_scheduling_decision(pods[1], nodes)
        assert time.monotonic() - t0 < FAIL_TIMEOUT_S
        assert not armed.is_set() and follower.exitcode is not None
        with pytest.raises(RuntimeError, match="tp group is down"):
            engine.decide_wave(PROMPTS, max_new_tokens=4)
    finally:
        backend.close()
    assert group.closed
    assert not os.path.exists(group.scratch.name)


def test_a_wave_failing_on_one_rank_alone_takes_the_group_down(micro, monkeypatch):
    """A wave that fails on the driver alone, before any collective (say an
    allocation of its buffers), leaves the follower's wave in a collective
    the driver never joins. The ranks settle out of step: the decision
    raises within twice the group timeout, the follower exits 1, and no
    later call is served (its collectives would pair with the follower's
    pending one)."""
    monkeypatch.setattr(launch, "GROUP_TIMEOUT_S", FAIL_TIMEOUT_S)
    backend = _build(micro)
    engine, group = backend.engine, backend.engine.rank_group
    follower = group.procs[0]
    pods, nodes = ttesting.fixture_pods(2), ttesting.synthetic_nodes(4)
    try:
        assert backend.get_scheduling_decision(pods[0], nodes).selected_node
        run_wave = engine._run_wave

        def failing(*args, **kwargs):
            engine._run_wave = run_wave
            raise RuntimeError("out of memory allocating the wave's buffers")

        engine._run_wave = failing
        t0 = time.monotonic()
        with pytest.raises(Exception, match="tp group is down.*out of step"):
            backend.get_scheduling_decision(pods[1], nodes)
        assert time.monotonic() - t0 < 2 * FAIL_TIMEOUT_S
        follower.join(30)
        assert follower.exitcode == 1
        with pytest.raises(RuntimeError, match="tp group is down.*out of step"):
            engine.generate(PROMPTS[0], max_new_tokens=2)
    finally:
        backend.close()
    assert group.closed


def test_a_call_every_rank_refuses_keeps_the_group_up(tp2):
    """A mirrored call that raises on every rank before any collective
    (an over-long prompt) leaves the ranks in step: the driver raises the
    engine's own error and the group serves the next call."""
    engine = tp2.engine
    with pytest.raises(ValueError):
        engine.generate([65] * 10_000, max_new_tokens=2)
    assert engine.rank_group.broken is None
    assert engine.generate(PROMPTS[2], max_new_tokens=2).token_ids
