"""The port's fused decode runtime (engine/fused/) on the CPU, held against
the JAX package's (TINY at 2 layers in f32, the JAX params converted
through numpy; the port's engines with graphs=False, the code a card
captures):

- dense tables array for array equal to the JAX ones, and None at
  Llama-3's vocab of 128,256 under the default cap;
- sample_fused against JAX's on the same seeded logits with planted ties:
  greedy tokens and next states identical (exact), constrained and not;
  pad and vocab_limit masked; top-k never changes greedy; sampled tokens in
  the allowed set and the top k; 4,000 draws within total variation 0.05 of
  the JAX softmax;
- the fused steps draw nothing from the engine's generator (their uniforms
  are drawn before the loop; tests/test_torch_chunk_draws.py holds the
  draws to the softmax, captured on a card);
- decode_fused / step_fused token-identical (exact) to the JAX engine's
  decode_fused and to the port's step(), constrained and not, with
  paged_attn "gather" and "pallas" (K4's plain twin here); generate() to
  the JAX generate(); with the same step and token books;
- packs admitted through admit_packed and stepped through step_fused, on
  the engine and through the backend, identical to the JAX package's;
- exact accounting: early exit books only the steps run, over-dispatched
  chunks emit pads and book nothing, and the dense-table cap or
  fused_decode=False fall back to step() and count fused_fallbacks.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu.engine import constrained as jconstrained
from k8s_llm_scheduler_tpu.engine import fused as jfused
from k8s_llm_scheduler_tpu.engine.engine import InferenceEngine as JEngine
from k8s_llm_scheduler_tpu.engine.local import LocalLLMBackend as JBackend
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.types import NodeMetrics as JNodeMetrics
from k8s_llm_scheduler_tpu.types import PodSpec as JPodSpec
from k8s_llm_scheduler_tpu_torch.engine import constrained as tconstrained
from k8s_llm_scheduler_tpu_torch.engine import fused as tfused
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine as TEngine
from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.testing import (
    cap_torch_threads,
    fixture_pods,
    synthetic_nodes,
)

cap_torch_threads()

JCFG = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32, n_layers=2)
TCFG = dataclasses.replace(tconfigs.TINY, dtype=torch.float32, n_layers=2)
NAMES = ["node-a", "node-b2"]
ENGINE = dict(num_pages=128, page_size=16, max_slots=4, max_pages_per_seq=16,
              prefill_buckets=(32, 64, 128, 256), chunk_steps=4, temperature=0.0,
              prefix_chunk=64)
TEMPERATURE = 0.3
DRAWS = 4000
TV_LIMIT = 0.05  # the bound of test_torch_sampling.py for 4,000 draws
PROMPTS = ["pod-a needs a node", "pod-b: a somewhat longer request line", "p-c"]


@pytest.fixture(scope="module")
def params():
    jp = jinit_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _engines(params, grammar=False, jkw=None, **kw):
    jp, tp = params
    jeng = JEngine(jp, JCFG, JByteTokenizer(), **{**ENGINE, **(jkw or {})})
    teng = TEngine(tp, TCFG, ByteTokenizer(), graphs=False, **{**ENGINE, **kw})
    if grammar:
        jeng.set_grammar(jconstrained.build_decision_dfa(JByteTokenizer(), NAMES,
                                                         max_reason_tokens=6))
        teng.set_grammar(tconstrained.build_decision_dfa(ByteTokenizer(), NAMES,
                                                         max_reason_tokens=6))
    for eng in (jeng, teng):
        eng.set_prefix(ByteTokenizer().encode("shared cluster prefix: node-a node-b2"))
    return jeng, teng


def _ids(texts):
    return [ByteTokenizer().encode(t) for t in texts]


def _drain(step, n):
    out = {}
    deadline = time.monotonic() + 120
    while len(out) < n:
        assert time.monotonic() < deadline, "decode wedged"
        for fin in step():
            out[fin.req_id] = fin.token_ids
    return out


# ------------------------------------------------------------ dense tables
def test_dense_tables_equal_the_jax_ones_array_for_array():
    jdfa = jconstrained.build_decision_dfa(JByteTokenizer(), NAMES, max_reason_tokens=6)
    tdfa = tconstrained.build_decision_dfa(ByteTokenizer(), NAMES, max_reason_tokens=6)
    for vocab in (None, 512 + 64):
        want = jfused.dense_tables(jdfa, vocab)
        got = tfused.dense_tables(tdfa, vocab)
        np.testing.assert_array_equal(got.next_state, want.next_state)
        assert (got.start_state, got.done_state, got.n_states) == (
            want.start_state, want.done_state, want.n_states)
    # the cap is judged before the cache (a smaller budget never sees a
    # table cached under a larger one)
    assert tfused.dense_tables(tdfa, 512, max_bytes=64) is None
    assert tfused.dense_tables(tdfa, 512) is tfused.dense_tables(tdfa, 512)


def test_dense_tables_refuse_llama3_vocab_under_the_default_cap():
    """1,024 states x 128,256 x 4 B = 525 MB > 128 MiB: constrained fused
    decode cannot run at 8B, in either package."""
    tdfa = tconstrained.build_decision_dfa(ByteTokenizer(), NAMES, max_reason_tokens=6)
    jdfa = jconstrained.build_decision_dfa(JByteTokenizer(), NAMES, max_reason_tokens=6)
    assert tfused.DENSE_TABLE_MAX_BYTES == jfused.DENSE_TABLE_MAX_BYTES == 128 << 20
    assert tfused.dense_tables(tdfa, 128_256) is None
    assert jfused.dense_tables(jdfa, 128_256) is None


# ----------------------------------------------------------------- sampler
def _sampler_inputs(seed):
    """[6, 16] logits with planted ties (rows 0 and 3 tie on their two best
    allowed ids; row 4 ties everywhere), a dense table and states."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(6, 16)).astype(np.float32)
    logits[0, [2, 5]] = 4.0
    logits[3, [7, 8]] = 3.0
    logits[4, :] = 1.0
    dense = np.full((4, 16), -1, dtype=np.int32)
    dense[0, [2, 5, 9]] = [1, 2, 3]
    dense[1, [4]] = 2
    dense[2, [7, 8]] = [3, 3]
    dense[3, [1, 8, 11, 14]] = [0, 1, 2, 3]
    st = np.array([0, 1, 2, 2, 3, 0], dtype=np.int32)
    return logits, dense, st


def _jax_sample(logits, dense, st, temperature, top_k, constrained, pad=0,
                vocab_limit=None, seed=0):
    tok, nxt = jfused.sample_fused(
        jnp.asarray(logits), jnp.asarray(st), jnp.asarray(dense), jax.random.PRNGKey(seed),
        jnp.float32(temperature), top_k, constrained, jnp.int32(pad), vocab_limit,
    )
    return np.asarray(tok), np.asarray(nxt)


def _port_sample(logits, dense, st, temperature, top_k, constrained, pad=0,
                 vocab_limit=None, gen=None):
    tok, nxt = tfused.sample_fused(
        torch.from_numpy(logits), torch.from_numpy(st), torch.from_numpy(dense), gen,
        temperature, top_k, constrained, pad, vocab_limit,
    )
    return tok.numpy(), nxt.numpy()


@pytest.mark.parametrize("constrained", [True, False], ids=["grammar", "free"])
@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_sample_fused_equals_jax_with_ties(seed, constrained):
    logits, dense, st = _sampler_inputs(seed)
    for top_k in (0, 2):
        want = _jax_sample(logits, dense, st, 0.0, top_k, constrained)
        got = _port_sample(logits, dense, st, 0.0, top_k, constrained)
        np.testing.assert_array_equal(got[0], want[0])  # exact
        np.testing.assert_array_equal(got[1], want[1])
    # ties resolve to the lowest id
    if constrained:
        assert got[0][0] == 2 and got[0][3] == 7
    # top-k never changes greedy
    np.testing.assert_array_equal(_port_sample(logits, dense, st, 0.0, 0, constrained)[0],
                                  _port_sample(logits, dense, st, 0.0, 3, constrained)[0])


def test_sample_fused_masks_pad_and_vocab_limit():
    logits = np.zeros((1, 16), dtype=np.float32)
    # pad (id 0) and the undecodable tail carry the HIGHEST logits
    logits[0, 0], logits[0, 12:] = 10.0, 9.0
    st = np.array([5], dtype=np.int32)
    dummy = np.full((1, 1), -1, dtype=np.int32)
    want = _jax_sample(logits, dummy, st, 0.0, 0, False, vocab_limit=12)
    got = _port_sample(logits, dummy, st, 0.0, 0, False, vocab_limit=12)
    assert 0 < int(got[0][0]) < 12 and int(got[0][0]) == int(want[0][0])
    assert int(got[1][0]) == 5  # unconstrained passes the state through
    gen = torch.Generator().manual_seed(0)
    draws = _port_sample(np.repeat(logits, 500, 0), dummy, np.repeat(st, 500), 1.0, 0,
                         False, vocab_limit=12, gen=gen)[0]
    assert ((draws > 0) & (draws < 12)).all()


def test_sampled_tokens_stay_in_the_allowed_set_and_the_top_k():
    logits, dense, _ = _sampler_inputs(3)
    row = np.repeat(logits[5:6], DRAWS, 0)  # state 0 allows {2, 5, 9}
    st = np.zeros(DRAWS, dtype=np.int32)
    gen = torch.Generator().manual_seed(1)
    tok, nxt = _port_sample(row, dense, st, 1.3, 2, True, gen=gen)
    allowed = np.array([2, 5, 9])
    top2 = allowed[np.argsort(-logits[5, allowed], kind="stable")[:2]]
    assert set(tok.tolist()) == set(top2.tolist())
    np.testing.assert_array_equal(nxt, dense[0, tok])
    # unconstrained top-k: every draw among the k largest logits
    free = np.repeat(logits[1:2], DRAWS, 0)
    tok, _ = _port_sample(free, dense, st, 1.0, 3, False, gen=gen)
    assert set(tok.tolist()) <= set(np.argsort(-logits[1])[:3].tolist())


@pytest.mark.parametrize("seed", [0, 1])
def test_sampled_distribution_follows_the_jax_softmax(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(1, 64)) * 0.4).astype(np.float32)
    dense = np.full((1, 64), -1, dtype=np.int32)
    allowed = np.sort(rng.choice(np.arange(1, 64), size=8, replace=False))
    dense[0, allowed] = 0
    masked = jnp.where(jnp.asarray(dense[0]) >= 0, jnp.asarray(logits[0]), -1e30)
    want = np.asarray(jax.nn.softmax(masked / TEMPERATURE))[allowed]
    gen = torch.Generator().manual_seed(seed)
    tok, _ = _port_sample(np.repeat(logits, DRAWS, 0), dense, np.zeros(DRAWS, np.int32),
                          TEMPERATURE, 0, True, gen=gen)
    got = np.array([(tok == a).mean() for a in allowed])
    tv = 0.5 * np.abs(got - want).sum()
    assert tv <= TV_LIMIT, (tv, got, want)
    assert want.max() < 0.9  # a distribution sampling can tell from argmax


def test_fused_steps_draw_nothing_from_the_generator(params, monkeypatch):
    """The fused chunk draws its uniforms before its steps (captured, the
    steps are one WHILE body whose iterations replay the same random
    draw): the engine generator's state is the same after each step as
    before it, and the sampled streams are valid."""
    _, teng = _engines(params, temperature=0.7, top_k=8)
    runner, gen = teng._graphs, teng._gen
    while_live, unchanged = runner.while_live, []

    def watched(act, budget, fn, counter, n, gate=None):
        def body():
            before = gen.get_state()
            fn()
            unchanged.append(torch.equal(gen.get_state(), before))
        while_live(act, budget, body, counter, n, gate)

    monkeypatch.setattr(runner, "while_live", watched)
    ids = teng.add_requests(_ids(PROMPTS), max_new_tokens=10)
    got = {f.req_id: f.token_ids for f in teng.decode_fused()}
    assert len(unchanged) > 1 and all(unchanged)
    pad = ByteTokenizer().pad_id
    assert all(1 <= len(got[i]) <= 10 and pad not in got[i] for i in ids)


# ------------------------------------------------------------ identity pins
@pytest.mark.parametrize("paged_attn", ["gather", "pallas"])
@pytest.mark.parametrize("grammar", [False, True], ids=["free", "grammar"])
def test_fused_decode_equals_jax_and_the_chunked_path(params, grammar, paged_attn):
    """decode_fused and step_fused emit the JAX engine's decode_fused tokens
    and the port's step() tokens, with the JAX engine's step and chunk
    books (exact)."""
    jeng, teng = _engines(params, grammar, paged_attn=paged_attn)
    budget = 60 if grammar else 10
    prompts = _ids(PROMPTS)
    jids = jeng.add_requests(prompts, max_new_tokens=budget)
    want = {f.req_id: f.token_ids for f in jeng.decode_fused()}
    ids = teng.add_requests(prompts, max_new_tokens=budget)
    got = {f.req_id: f.token_ids for f in teng.decode_fused()}
    assert [got[i] for i in ids] == [want[i] for i in jids]
    for key in ("fused_steps", "fused_chunks", "decode_tokens"):
        assert teng.stats[key] == jeng.stats[key], key
    ids2 = teng.add_requests(prompts, max_new_tokens=budget)
    stepped = _drain(teng.step_fused, len(prompts))
    ids3 = teng.add_requests(prompts, max_new_tokens=budget)
    chunked = _drain(teng.step, len(prompts))
    assert [stepped[i] for i in ids2] == [chunked[i] for i in ids3] == [got[i] for i in ids]
    assert teng.stats["fused_fallbacks"] == 0
    if grammar:
        assert ByteTokenizer().decode(got[ids[0]]).startswith('{"selected_node": ')


def test_generate_goes_through_decode_fused_and_equals_jax(params):
    jeng, teng = _engines(params)
    for text in ("pod-a needs a node", "x"):
        want = jeng.generate(ByteTokenizer().encode(text), max_new_tokens=9).token_ids
        chunks = teng.stats["fused_chunks"]
        got = teng.generate(ByteTokenizer().encode(text), max_new_tokens=9).token_ids
        assert got == want
        assert teng.stats["fused_chunks"] > chunks


def test_packs_step_through_step_fused_like_jax(params):
    """admit_packed, then step_fused: the JAX engine's tokens, and the
    piggybacked emissions harvest through the fused runtime's sync."""
    jeng, teng = _engines(params, jkw=dict(admission_chunk_tokens=16),
                          admission_chunk_tokens=16)
    prompts = _ids(["pod-a needs", "p" * 45])  # 45 tokens span 3 chunks of 16
    jids = jeng.admit_packed(prompts, max_new_tokens=8)
    want = _drain(jeng.step_fused, 2)
    ids = teng.admit_packed(prompts, max_new_tokens=8)
    got = _drain(teng.step_fused, 2)
    assert [got[i] for i in ids] == [want[i] for i in jids]
    assert teng.stats["packed_admissions"] == 1 and teng.stats["fused_chunks"] >= 1
    assert teng.stats["piggyback_chunks"] == jeng.stats["piggyback_chunks"]


def test_backend_packs_decide_like_the_jax_backend(params):
    """A batch through each package's backend (packed admission, greedy,
    grammar): the same decisions, and the port's packs decoded through
    step_fused."""
    jp, tp = params
    ekw = {**ENGINE, "prefill_buckets": (512, 1024), "prefix_chunk": 1024,
           "num_pages": 256, "max_pages_per_seq": 32}
    jeng = JEngine(jp, JCFG, JByteTokenizer(), **ekw)
    teng = TEngine(tp, TCFG, ByteTokenizer(), graphs=False, **ekw)
    kw = dict(max_new_tokens=80, packed_admission=True, request_timeout_s=600.0,
              prewarm_idle_delay_s=600.0)
    jb, tb = JBackend(jeng, **kw), LocalLLMBackend(teng, **kw)
    pods, nodes = fixture_pods(3), synthetic_nodes(3)
    try:
        want = jb.get_scheduling_decisions_batch(
            [JPodSpec(**dataclasses.asdict(p)) for p in pods],
            [JNodeMetrics(**dataclasses.asdict(n)) for n in nodes])
        got = tb.get_scheduling_decisions_batch(pods, nodes)
    finally:
        jb.close()
        tb.close()
    assert not [d for d in got + want if isinstance(d, Exception)]
    assert [(d.selected_node, d.reasoning) for d in got] == [
        (d.selected_node, d.reasoning) for d in want]
    assert teng.stats["packed_admissions"] >= 1 and teng.stats["fused_chunks"] >= 1
    assert teng.stats["fused_fallbacks"] == 0


# ------------------------------------------------------- exact accounting
def test_early_exit_books_only_the_steps_run(params):
    _, teng = _engines(params, chunk_steps=8)
    (rid,) = teng.add_requests(_ids(["pod-x"]), max_new_tokens=3)
    tok0 = teng.stats["decode_tokens"]
    out = _drain(teng.step_fused, 1)
    assert len(out[rid]) == 3
    # the first token came from admission; the loop ran budget - 1 = 2
    # steps of an 8-step chunk and stopped
    assert teng.stats["fused_steps"] == 2
    assert teng.stats["decode_tokens"] - tok0 == 2


def test_over_dispatched_chunks_emit_pads_and_book_nothing(params):
    _, teng = _engines(params, chunk_steps=8)
    ids = teng.add_requests(_ids(["pod-y"]), max_new_tokens=4)
    fins = teng.step_fused(chunks=4)
    assert [f.req_id for f in fins] == ids and len(fins[0].token_ids) == 4
    assert teng.stats["fused_chunks"] == 4
    assert teng.stats["fused_steps"] == 3  # budget - 1, not 4 x 8
    # a chunk on the finished batch: no step, pads only
    toks, steps, _ = teng._fused_chunk_dispatch()
    assert int(steps) == 0 and (toks.numpy() == teng.tokenizer.pad_id).all()


@pytest.mark.parametrize("why", ["cap", "disabled"])
def test_fallback_to_step_counts_fused_fallbacks(params, why):
    kw = dict(fused_table_bytes=64) if why == "cap" else dict(fused_decode=False)
    jeng, teng = _engines(params, grammar=True, jkw=kw, **kw)
    prompts = _ids(["pod-a", "pod-b longer"])
    jids = jeng.add_requests(prompts, max_new_tokens=40)
    want = {f.req_id: f.token_ids for f in jeng.decode_fused()}
    ids = teng.add_requests(prompts, max_new_tokens=40)
    got = {f.req_id: f.token_ids for f in teng.decode_fused()}
    assert [got[i] for i in ids] == [want[i] for i in jids]
    assert teng.stats["fused_fallbacks"] == jeng.stats["fused_fallbacks"] == 1
    assert teng.stats["fused_chunks"] == 0 and teng.stats["chunks"] > 0
    assert teng.dense_grammar() is None if why == "cap" else True
