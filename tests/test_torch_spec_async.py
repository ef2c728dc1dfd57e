"""The port's speculative decoder as a round state machine beside the fused
runtime, on the CPU (the JAX package's tests/test_spec_async.py and
test_spec.py scenarios; configs and weights as tests/test_torch_spec.py,
the port's engines with graphs=False):

- the auto-disable edge hands the slot back and the request finishes
  through decode_fused with the JAX decoder's tokens; the next request
  speculates again;
- a spec stream coexists with fused chunks of other slots, interleaved
  round by round, each output identical to its isolated run, and the
  disable edge under coexistence drops no Finished record;
- a failure in start() or advance() releases the slot and the decoder
  serves again; advance() on a closed stream raises;
- persistent_supported() is False while a decoder is attached;
- on_swap rolls back an open block (called directly: the port has no hot
  swap yet);
- greedy verification through the dense table equals the sparse path;
- sampled speculation (temperature 0.8, the wider-vocab draft too) emits
  legal tokens within the budget, and use_spec=False forces plain decode;
- _attach_spec / build_local_backend(spec_enabled=...) attach each arm,
  refuse an unknown arm and a hidden-head checkpoint (not ported).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu.engine.engine import InferenceEngine as JEngine
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu.models.configs import LlamaConfig as JConfig
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.spec.decoder import SpeculativeDecoder as JDecoder
from k8s_llm_scheduler_tpu_torch.engine.constrained import build_decision_dfa
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
from k8s_llm_scheduler_tpu_torch.engine.local import _attach_spec, build_local_backend
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.spec import SpeculativeDecoder
from k8s_llm_scheduler_tpu_torch.testing import cap_torch_threads

cap_torch_threads()

TOK = ByteTokenizer()
JTOK = JByteTokenizer()
ARCH = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
            max_seq_len=2048, rope_theta=10000.0, tie_embeddings=True)
DRAFT_ARCH = dict(vocab_size=512, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=64,
                  max_seq_len=2048, rope_theta=10000.0, tie_embeddings=True)
JCFG = JConfig(name="spec-async", dtype=jnp.float32, **ARCH)
TCFG = LlamaConfig(name="spec-async", dtype=torch.float32, **ARCH)
JDRAFT = JConfig(name="spec-async-draft", dtype=jnp.float32, **DRAFT_ARCH)
TDRAFT = LlamaConfig(name="spec-async-draft", dtype=torch.float32, **DRAFT_ARCH)
TWIDE = LlamaConfig(name="spec-draft-wide", dtype=torch.float32,
                    **{**DRAFT_ARCH, "vocab_size": 640})
ENGINE = dict(num_pages=96, page_size=64, max_slots=4, max_pages_per_seq=16,
              prefill_buckets=(128, 256, 512), chunk_steps=8, temperature=0.0)
PROMPT = TOK.encode("The quick brown fox jumps over the lazy dog. " * 2)
NAMES = ["node-a", "node-b", "node-west-1"]


def _convert(jp):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def weights():
    jp = jinit_params(jax.random.PRNGKey(0), JCFG)
    jd = jinit_params(jax.random.PRNGKey(7), JDRAFT)
    return {"target": (jp, _convert(jp)), "draft": (jd, _convert(jd))}


def _engine(weights, **kw):
    return InferenceEngine(weights["target"][1], TCFG, TOK, graphs=False, **{**ENGINE, **kw})


def _draft(weights, eng, **kw):
    return SpeculativeDecoder(eng, weights["draft"][1], TDRAFT, k=4, **kw)


def _self(weights, eng, k=3):
    return SpeculativeDecoder(eng, weights["target"][1], TCFG, k=k)


def _no_leak(eng):
    assert eng.kv.pages_free == eng.kv.num_pages - 1
    assert eng.free_slots == eng.max_slots


# ------------------------------------------------------------ auto-disable
def test_disable_edge_hands_slot_back_to_fused_with_the_jax_tokens(weights):
    """A disagreeing draft and an impossible threshold: the EWMA trips after
    the warm-up rounds, the slot goes back to the engine and the request
    finishes through decode_fused with the tokens of the JAX decoder's
    same run; the next request speculates again."""
    jp, jd = weights["target"][0], weights["draft"][0]
    jeng = JEngine(jp, JCFG, JTOK, **ENGINE)
    jeng.attach_spec(JDecoder(jeng, jd, JDRAFT, k=4, disable_threshold=0.95, min_rounds=2))
    want = jeng.generate(PROMPT, 24).token_ids
    eng = _engine(weights)
    spec = _draft(weights, eng, disable_threshold=0.95, min_rounds=2)
    eng.attach_spec(spec)
    chunks0 = eng.stats["fused_chunks"]
    assert eng.generate(PROMPT, 24).token_ids == want
    snap = eng.get_stats()["spec"]
    assert snap["disables"] == 1 and snap["fallback_requests"] == 1
    assert snap == {**snap, **{k: v for k, v in jeng.get_stats()["spec"].items()
                               if k in ("rounds", "accepted", "emitted", "disables")}}
    assert eng.stats["fused_chunks"] > chunks0  # finished through the fused runtime
    assert eng.stats["fused_fallbacks"] == 0
    _no_leak(eng)
    rounds = snap["rounds"]
    eng.generate(PROMPT, 16)
    assert eng.get_stats()["spec"]["rounds"] > rounds
    assert eng.get_stats()["spec"]["requests"] == 2


# ------------------------------------------------------------ coexistence
def test_spec_rounds_and_fused_chunks_share_one_pipeline(weights):
    """With a speculative stream OPEN behind a prefix, fused chunks serve
    two other slots between every round: all outputs identical to their
    isolated runs, no fused fallback, nothing leaked."""
    eng = _engine(weights, num_pages=128)
    eng.set_prefix(TOK.encode("shared prefix"))
    spec = SpeculativeDecoder(eng, weights["target"][1], TCFG, k=2)
    eng.attach_spec(spec)
    p_spec, p_a, p_b = (TOK.encode(t) for t in ("pod-spec request", "pod-a needs a node",
                                                 "pod-b too"))
    refs = [eng.generate(p, 12, use_spec=False).token_ids for p in (p_spec, p_a, p_b)]
    stream = spec.start(p_spec, 12)
    other_ids = eng.add_requests([p_a, p_b], max_new_tokens=12)
    chunks0 = eng.stats["fused_chunks"]
    fin, others = None, {}
    while fin is None or len(others) < 2:
        if fin is None:
            fin = spec.advance(stream)
        for f in eng.step_fused():
            others[f.req_id] = f.token_ids
    assert fin.token_ids == refs[0]
    assert [others[i] for i in other_ids] == refs[1:]
    assert eng.stats["fused_chunks"] > chunks0 and eng.stats["fused_fallbacks"] == 0
    assert eng.kv.pages_free == eng.kv.num_pages - 1


def test_disable_under_coexistence_never_drops_other_completions(weights):
    eng = _engine(weights, num_pages=128)
    spec = _draft(weights, eng, disable_threshold=0.95, min_rounds=2)
    eng.attach_spec(spec)
    p_other = TOK.encode("pod-other request")
    ref_spec = eng.generate(PROMPT, 24, use_spec=False).token_ids
    ref_other = eng.generate(p_other, 12, use_spec=False).token_ids
    stream = spec.start(PROMPT, 24)
    (other_id,) = eng.add_requests([p_other], max_new_tokens=12)
    done, fin = {}, None
    deadline = time.monotonic() + 120
    while len(done) < 2:
        assert time.monotonic() < deadline, "coexistence loop wedged"
        if fin is None and not stream.handed_off:
            fin = spec.advance(stream)
        for f in eng.step_fused():
            done[f.req_id] = f.token_ids
        if fin is not None:
            done.setdefault(fin.req_id, fin.token_ids)
    assert spec.stats.disables == 1 and stream.handed_off
    assert done[stream.req_id] == ref_spec and done[other_id] == ref_other
    with pytest.raises(RuntimeError, match="handed off"):
        spec.advance(stream)
    assert eng.kv.pages_free == eng.kv.num_pages - 1


# ---------------------------------------------------------------- failures
@pytest.mark.parametrize("where", ["start", "advance"])
def test_a_failure_releases_the_slot_and_the_decoder_serves_again(weights, where):
    eng = _engine(weights)
    spec = _self(weights, eng)
    eng.attach_spec(spec)
    target = spec.draft if where == "start" else eng.kv
    name = "begin" if where == "start" else "ensure_capacity"
    real = getattr(target, name)

    def boom(*a, **k):
        raise RuntimeError(f"injected {where} failure")

    setattr(target, name, boom)
    try:
        with pytest.raises(RuntimeError, match="injected"):
            stream = spec.start(PROMPT, 16)
            spec.advance(stream)
    finally:
        setattr(target, name, real)
    assert spec.open_streams == 0
    _no_leak(eng)
    ref = eng.generate(PROMPT, 8, use_spec=False).token_ids
    assert spec.generate(PROMPT, 8).token_ids == ref


def test_advance_on_a_closed_stream_raises(weights):
    eng = _engine(weights)
    spec = _self(weights, eng)
    eng.attach_spec(spec)
    stream = spec.start(PROMPT, 8)
    fin = None
    while fin is None:
        fin = spec.advance(stream)
    assert len(fin.token_ids) == 8
    with pytest.raises(RuntimeError, match="closed"):
        spec.advance(stream)
    with pytest.raises(RuntimeError, match="one speculative stream"):
        spec.start(PROMPT, 8)
        spec.start(PROMPT, 8)


# ----------------------------------------------------- persistent and swap
def test_persistent_supported_is_false_while_a_decoder_is_attached(weights):
    eng = _engine(weights, persistent_loop=True, persistent_suffix_bucket=128)
    assert eng.persistent_supported()
    eng.attach_spec(_self(weights, eng))
    assert not eng.persistent_supported() and not eng.enter_persistent()
    eng.attach_spec(None)
    assert eng.persistent_supported()


def test_on_swap_rolls_back_an_open_block(weights):
    """One round in with an ahead block pending: on_swap truncates the slot
    to its verified tokens and drops the block; the stream then finishes
    token-identically."""
    eng = _engine(weights)
    spec = _self(weights, eng)
    eng.attach_spec(spec)
    ref = eng.generate(PROMPT, 24, use_spec=False).token_ids
    stream = spec.start(PROMPT, 24)
    assert spec.advance(stream) is None and stream.pending is not None
    free = eng.kv.pages_free
    spec.on_swap()
    assert spec.stats.swap_rollbacks == 1 and spec.stats.ahead_wasted >= 1
    assert stream.pending is None
    assert len(eng.kv.slot_pages(stream.slot)) == eng.kv.pages_needed(stream.n_own)
    assert eng.kv.pages_free >= free
    fin = None
    while fin is None:
        fin = spec.advance(stream)
    assert fin.token_ids == ref
    _no_leak(eng)


# ------------------------------------------------------------- grammar
def test_dense_table_verification_matches_sparse(weights):
    dfa = build_decision_dfa(TOK, NAMES, max_reason_tokens=16)
    prompt = TOK.encode("Pick a node: ")
    out = {}
    for name, kw in (("dense", {}), ("sparse", {"fused_table_bytes": 64}), ("plain", {})):
        eng = _engine(weights, **kw)
        eng.set_grammar(dfa)
        if name == "plain":
            out[name] = eng.generate(prompt, 110).token_ids
            continue
        spec = SpeculativeDecoder(eng, weights["target"][1], TCFG, k=4)
        eng.attach_spec(spec)
        assert spec._grammar_mode()[0] == name
        out[name] = eng.generate(prompt, 110).token_ids
    assert out["dense"] == out["sparse"] == out["plain"]


# ---------------------------------------------------------------- sampling
@pytest.mark.parametrize("draft", ["draft", "wide"])
def test_sampled_spec_decode_is_legal_and_complete(weights, draft):
    eng = _engine(weights, temperature=0.8)
    if draft == "wide":
        from k8s_llm_scheduler_tpu_torch.models.llama import init_params

        spec = SpeculativeDecoder(eng, init_params(TWIDE, 9, "cpu"), TWIDE, k=3,
                                  min_rounds=10**9)
    else:
        spec = _draft(weights, eng, min_rounds=10**9)
    eng.attach_spec(spec)
    fin = eng.generate(PROMPT, 12)
    assert len(fin.token_ids) == 12
    assert all(0 <= t < TOK.vocab_size and t != TOK.pad_id for t in fin.token_ids)
    assert spec.stats.rounds > 0
    _no_leak(eng)


def test_use_spec_false_forces_the_plain_path(weights):
    eng = _engine(weights)
    eng.attach_spec(_self(weights, eng))
    assert len(eng.generate(PROMPT, 8, use_spec=False).token_ids) == 8
    assert eng.get_stats()["spec"]["requests"] == 0


# ------------------------------------------------------------------ attach
def test_attach_spec_builds_each_arm_and_refuses_the_rest(weights, tmp_path):
    eng = _engine(weights)
    with pytest.raises(ValueError, match="spec_arm"):
        _attach_spec(eng, arm="hiden", draft_model="tiny", draft_checkpoint=None, k=4,
                     disable_threshold=0.3, rng_seed=0)
    with pytest.raises(NotImplementedError, match="item 10"):
        _attach_spec(eng, arm="hidden", draft_model="tiny", draft_checkpoint=str(tmp_path),
                     k=4, disable_threshold=0.3, rng_seed=0)
    _attach_spec(eng, arm="hidden", draft_model="tiny", draft_checkpoint=None, k=3,
                 disable_threshold=0.3, rng_seed=0)
    assert eng.spec.arm == "hidden" and eng.spec.hidden_head["transfer"].shape == (3, 64, 64)
    backend = build_local_backend("tiny", device="cpu", temperature=0.0, spec_enabled=True,
                                  spec_k=2, spec_disable_threshold=0.5)
    try:
        spec = backend.engine.spec
        assert spec.arm == "draft" and spec.k == 2 and spec.disable_threshold == 0.5
        assert spec.draft.cfg.name == "tiny"
        fin = backend.engine.generate(TOK.encode("hello"), 6)
        assert len(fin.token_ids) == 6 and spec.stats.requests == 1
    finally:
        backend.close()
