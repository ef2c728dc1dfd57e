"""The port's admission plane held against the JAX package's on the CPU
(tests/test_admission.py is the JAX package's own): the packed
block-diagonal prefill chunk, the packed admission step's slot state, the
engine's admit_packed (token for token against the port's serial generate
and the JAX engine's admit_packed, greedy, f32, constrained and
unconstrained), its backpressure, validation and rollback, the pin
lifecycle, and the backend's delta prompts and packed batches, ending with
two bursts through the scheduling loop on both packages.

MICRO is the JAX package's admission test model (f32, 2 layers); weights
come from the JAX init through models/convert.py, inputs from numpy seeds.
"""

import asyncio
import copy
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu import testing as jtesting
from k8s_llm_scheduler_tpu.core.breaker import CircuitBreaker as JBreaker
from k8s_llm_scheduler_tpu.core.cache import DecisionCache as JCache
from k8s_llm_scheduler_tpu.engine import constrained as jconstrained
from k8s_llm_scheduler_tpu.engine.admission.chunked import packed_admit_step as jstep
from k8s_llm_scheduler_tpu.engine.engine import InferenceEngine as JEngine
from k8s_llm_scheduler_tpu.engine.local import LocalLLMBackend as JBackend
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models.llama import forward_prefill_packed as jforward
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.sched.client import DecisionClient as JClient
from k8s_llm_scheduler_tpu.sched.loop import Scheduler as JScheduler
from k8s_llm_scheduler_tpu.types import NodeMetrics as JNodeMetrics
from k8s_llm_scheduler_tpu.types import PodSpec as JPodSpec
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch.config import DEFAULTS, Config
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.engine import constrained as tconstrained
from k8s_llm_scheduler_tpu_torch.engine.admission import PinnedPrefixManager
from k8s_llm_scheduler_tpu_torch.engine.admission.chunked import packed_admit_step as tstep
from k8s_llm_scheduler_tpu_torch.engine.admission.packer import pack_prompts
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine as TEngine
from k8s_llm_scheduler_tpu_torch.engine.engine import _SlotState
from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend as TBackend
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.models.llama import forward_prefill_packed as tforward

ttesting.cap_torch_threads()

TOK = ByteTokenizer()
_MICRO = dict(name="admission-micro", vocab_size=512, d_model=64, n_layers=2,
              n_heads=2, n_kv_heads=1, d_ff=128, max_seq_len=4096,
              rope_theta=10000.0, tie_embeddings=True)
JMICRO = jconfigs.LlamaConfig(**_MICRO, dtype=jnp.float32)
TMICRO = tconfigs.LlamaConfig(**_MICRO, dtype=torch.float32)
RTOL = ATOL = 1e-4  # f32, as tests/test_torch_model.py
TIMEOUT_S = 600.0  # a slow decision on a crowded CPU must never time out
# the backend settings of the config's `admission.*` keys (cli._backend_kwargs)
ADMISSION_KEYS = ("packed_admission", "admission_chunk_tokens", "delta_prompts",
                  "repin_fraction", "max_pins")


@pytest.fixture(scope="module")
def params():
    jp = jinit_params(jax.random.PRNGKey(0), JMICRO)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


ENGINE_KW = dict(num_pages=128, page_size=16, max_slots=4, max_pages_per_seq=16,
                 prefill_buckets=(32, 64, 128, 256, 512, 1024, 2048), chunk_steps=4,
                 temperature=0.0, admission_chunk_tokens=16, prefix_chunk=64)


def t_engine(tp, **kw):
    return TEngine(tp, TMICRO, TOK, **{**ENGINE_KW, **kw})


def j_engine(jp, **kw):
    return JEngine(jp, JMICRO, JByteTokenizer(), fused_decode=False, **{**ENGINE_KW, **kw})


PREFIX = TOK.encode("CLUSTER STATE: " + " ".join(f"node-{i} cpu={10 + i}" for i in range(8)))
# shorter than a chunk, spanning three chunks of 16, and one between
PROMPTS = [TOK.encode("pod-a needs a node"), TOK.encode("p" * 45), TOK.encode("pod-c: tiny")]
NAMES = ["node-0", "node-1", "gpu-a100-pool-7"]


def _drain(engine, req_ids):
    out = {}
    deadline = time.monotonic() + 120
    while len(out) < len(req_ids):
        assert time.monotonic() < deadline, "packed decode wedged"
        for fin in engine.step():
            out[fin.req_id] = fin.token_ids
    return [out[r] for r in req_ids]


# ------------------------------------------------------ packed prefill chunk
def _pack_case(plen, seed):
    """A pack of three prompts (one spanning chunks) at C=16, the slots'
    pages and a random dense prefix [L, Sp, n_kv, hd] with plen valid."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 500, n).tolist() for n in (5, 20, 3)]
    plan = pack_prompts(prompts, 16, 0)
    L, n_kv, hd = TMICRO.n_layers, TMICRO.n_kv_heads, TMICRO.head_dim
    pk = rng.standard_normal((L, 64, n_kv, hd)).astype(np.float32)
    pv = rng.standard_normal((L, 64, n_kv, hd)).astype(np.float32)
    ps, num_pages = 4, 24
    # prompt s's pages: distinct, scattered, past the scratch page 0
    order = rng.permutation(np.arange(1, num_pages))
    slot_pages, at = [], 0
    for p in prompts:
        n = -(-len(p) // ps)
        slot_pages.append(order[at:at + n].tolist())
        at += n
    chunks = []
    for chunk in plan.chunks:
        page_ids = np.zeros(16, np.int32)
        offs = np.zeros(16, np.int32)
        for i in range(chunk.n_tokens):
            local = int(chunk.positions[i])
            page_ids[i] = slot_pages[int(chunk.seg[i])][local // ps]
            offs[i] = local % ps
        end_idx = np.zeros(4, np.int32)
        for row, end in enumerate(chunk.ends):
            end_idx[row] = end.index
        chunks.append((chunk, chunk.positions + np.int32(plen), page_ids, offs, end_idx))
    cache = np.zeros((L, num_pages, ps, n_kv, hd), np.float32)
    carry = np.zeros((L, 32, n_kv, hd), np.float32)
    return plan, chunks, pk, pv, cache, carry


@pytest.mark.parametrize("plen", [0, 37, 64])
def test_forward_prefill_packed_matches_jax(params, plen):
    """End logits, carry, carry segment ids and the scattered pages after
    every chunk of a pack whose middle prompt spans chunks."""
    jp, tp = params
    plan, chunks, pk, pv, cache, carry = _pack_case(plen, seed=plen)
    assert plan.n_chunks == 2 and plan.chunks[0].ends and not plan.chunks[1].n_tokens == 16
    j = dict(ck=jnp.asarray(carry), cv=jnp.asarray(carry),
             cs=jnp.full((32,), -1, jnp.int32), kc=jnp.asarray(cache), vc=jnp.asarray(cache))
    t = dict(ck=torch.from_numpy(carry.copy()), cv=torch.from_numpy(carry.copy()),
             cs=torch.full((32,), -1, dtype=torch.int32),
             kc=torch.from_numpy(cache.copy()), vc=torch.from_numpy(cache.copy()))
    tp_len = torch.tensor(plen, dtype=torch.int32)
    for ci, (chunk, pos, page_ids, offs, end_idx) in enumerate(chunks):
        want, j["ck"], j["cv"], j["cs"], j["kc"], j["vc"] = jforward(
            jp, JMICRO, jnp.asarray(chunk.tokens), jnp.asarray(chunk.seg), jnp.asarray(pos),
            jnp.asarray(pk), jnp.asarray(pv), jnp.int32(plen),
            j["ck"], j["cv"], j["cs"], jnp.int32(ci * 16), j["kc"], j["vc"],
            jnp.asarray(page_ids), jnp.asarray(offs), jnp.asarray(end_idx),
        )
        got = tforward(
            tp, TMICRO, torch.from_numpy(chunk.tokens), torch.from_numpy(chunk.seg),
            torch.from_numpy(pos), torch.from_numpy(pk), torch.from_numpy(pv), tp_len,
            t["ck"], t["cv"], t["cs"], ci * 16, t["kc"], t["vc"],
            torch.from_numpy(page_ids), torch.from_numpy(offs), torch.from_numpy(end_idx),
        )
        n_end = len(chunk.ends)
        np.testing.assert_allclose(got.numpy()[:n_end], np.asarray(want)[:n_end],
                                   rtol=RTOL, atol=ATOL)
        for name in ("ck", "cv", "kc", "vc"):
            g, w = t[name].numpy(), np.asarray(j[name])
            if name in ("kc", "vc"):  # scratch page 0 takes every padding token
                g, w = g[:, 1:], w[:, 1:]
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_array_equal(t["cs"].numpy(), np.asarray(j["cs"]))


@pytest.mark.parametrize("constrained", [False, True])
def test_packed_admit_step_sets_the_slot_state_of_jax(params, constrained):
    """The ending prompts' first token, position, active flag, DFA state,
    budget and first-token rows after one pack chunk, padding end rows to
    the trash row M; unconstrained and under the decision grammar."""
    jp, tp = params
    plen = 37
    plan, chunks, pk, pv, cache, carry = _pack_case(plen, seed=7)
    chunk, pos, page_ids, offs, end_idx = chunks[0]
    M = 4
    slots = [2, 0, 3]
    end_slots = np.full(4, M, np.int32)
    end_valid = np.zeros(4, bool)
    end_pos = np.zeros(4, np.int32)
    end_budgets = np.zeros(4, np.int32)
    for row, end in enumerate(chunk.ends):
        end_slots[row] = slots[end.prompt]
        end_valid[row] = True
        end_pos[row] = plen + plan.prompt_lens[end.prompt]
        end_budgets[row] = 7
    if constrained:
        dfa = jconstrained.build_decision_dfa(JByteTokenizer(), NAMES, max_reason_tokens=8)
        tables = jconstrained.sparse_tables(dfa)
        sp_tokens, sp_next = tables.sp_tokens, tables.sp_next
        start, done = int(dfa.start_state), int(dfa.done_state)
    else:
        sp_tokens, sp_next = np.full((1, 1), -1, np.int32), np.zeros((1, 1), np.int32)
        start, done = 0, -1
    rng = np.random.default_rng(3)
    init = {k: rng.integers(0, 9, M + 1).astype(np.int32)
            for k in ("tok", "pos", "st", "budget", "first")}
    init["act"] = rng.integers(0, 2, M + 1).astype(bool)
    out = jstep(
        jp, JMICRO, jnp.asarray(chunk.tokens), jnp.asarray(chunk.seg), jnp.asarray(pos),
        jnp.asarray(pk), jnp.asarray(pv), jnp.int32(plen),
        jnp.asarray(carry), jnp.asarray(carry), jnp.full((32,), -1, jnp.int32), jnp.int32(0),
        jnp.asarray(cache), jnp.asarray(cache), jnp.asarray(page_ids), jnp.asarray(offs),
        jnp.asarray(end_idx), jnp.asarray(end_slots), jnp.asarray(end_valid),
        jnp.asarray(end_pos), jnp.asarray(end_budgets),
        *(jnp.asarray(init[k]) for k in ("tok", "pos", "act", "st", "budget", "first")),
        jnp.asarray(sp_tokens), jnp.asarray(sp_next), jnp.int32(done),
        jnp.int32(TOK.eos_id), jnp.int32(TOK.pad_id), jnp.int32(start),
        jax.random.PRNGKey(0), jnp.float32(0.0), constrained,
    )
    want = dict(zip(("tok", "pos", "act", "st", "budget", "first"), out[5:]))
    state = _SlotState(*(torch.from_numpy(init[k].copy())
                         for k in ("tok", "pos", "act", "st", "budget", "first")))
    f = torch.from_numpy
    tstep(
        tp, TMICRO, f(chunk.tokens), f(chunk.seg), f(pos), f(pk), f(pv),
        torch.tensor(plen, dtype=torch.int32),
        f(carry.copy()), f(carry.copy()), torch.full((32,), -1, dtype=torch.int32), 0,
        f(cache.copy()), f(cache.copy()), f(page_ids), f(offs),
        f(end_idx), f(end_slots), f(end_valid), f(end_pos), f(end_budgets),
        state, f(sp_tokens), f(sp_next), done, TOK.eos_id, TOK.pad_id, start,
        torch.Generator(), 0.0, constrained,
    )
    for name, w in want.items():  # the trash row M takes the padding rows
        np.testing.assert_array_equal(getattr(state, name).numpy()[:M], np.asarray(w)[:M],
                                      err_msg=name)
    assert not state.act[M]


# ----------------------------------------------------------- admit_packed
@pytest.mark.parametrize("constrained", [False, True])
def test_admit_packed_is_token_identical_to_serial_and_to_jax(params, constrained):
    """The acceptance pin: a pack (a prompt shorter than a chunk, one
    spanning three chunks, one between) decodes token for token as the
    port's serial generate() of each prompt and as the JAX engine's
    admit_packed, while decode chunks ran between its prefill chunks."""
    jp, tp = params
    tdfa = tconstrained.build_decision_dfa(TOK, NAMES, max_reason_tokens=8)
    jdfa = jconstrained.build_decision_dfa(JByteTokenizer(), NAMES, max_reason_tokens=8)
    teng, jeng = t_engine(tp), j_engine(jp)
    for eng, dfa in ((teng, tdfa), (jeng, jdfa)):
        eng.set_prefix(PREFIX)
        eng.set_grammar(dfa if constrained else None)
    max_new = 12
    serial = [teng.generate(p, max_new_tokens=max_new).token_ids for p in PROMPTS]
    assert not teng.has_active
    got = _drain(teng, teng.admit_packed(PROMPTS, max_new_tokens=max_new))
    want = _drain(jeng, jeng.admit_packed(PROMPTS, max_new_tokens=max_new))
    assert got == serial
    assert got == want
    assert all(1 <= len(ids) <= max_new for ids in got)
    for key in ("packed_admissions", "packed_prompts", "pack_chunks", "piggyback_chunks"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["pack_chunks"] == -(-sum(map(len, PROMPTS)) // 16) == 5
    assert teng.stats["piggyback_chunks"] >= 1  # decode advanced mid-pack
    assert teng.kv.pages_free == teng.kv.num_pages - 1 and teng.free_slots == 4


def test_pack_admitted_beside_a_request_in_flight(params):
    """A request admitted before the pack decodes through the piggybacked
    chunks and books each of its tokens once; the pack's requests do not
    book the chunks parked before their admission."""
    _, tp = params
    eng = t_engine(tp)
    eng.set_prefix(PREFIX)
    solo = TOK.encode("in flight first")
    alone = t_engine(tp)
    alone.set_prefix(PREFIX)
    want_solo = alone.generate(solo, max_new_tokens=30).token_ids
    want_pack = [alone.generate(p, max_new_tokens=10).token_ids for p in PROMPTS]
    (rid,) = eng.add_requests([solo], max_new_tokens=30)
    ids = eng.admit_packed(PROMPTS, max_new_tokens=10)
    parked = len(eng._pending_emissions)
    assert parked == eng.stats["piggyback_chunks"] >= 2
    out = dict(zip(ids, _drain(eng, ids)))
    while rid not in out:
        for fin in eng.step():
            out[fin.req_id] = fin.token_ids
    for fin in eng.step():  # the solo request may have finished already
        out[fin.req_id] = fin.token_ids
    assert [out[i] for i in ids] == want_pack
    assert out[rid] == want_solo


def test_row_batched_and_packed_admission_agree(params):
    _, tp = params
    eng = t_engine(tp)
    eng.set_prefix(TOK.encode("shared cluster prefix text here"))
    prompts = [TOK.encode("alpha pod"), TOK.encode("beta pod longer")]
    row = _drain(eng, eng.add_requests(prompts, max_new_tokens=6))
    assert _drain(eng, eng.admit_packed(prompts, max_new_tokens=6)) == row


def test_backpressure_and_validation(params):
    eng = t_engine(params[1])
    with pytest.raises(ValueError):
        eng.admit_packed([[]], max_new_tokens=4)
    with pytest.raises(RuntimeError):
        eng.admit_packed([[1]] * 5, max_new_tokens=4)  # > max_slots
    with pytest.raises(ValueError):
        eng.admit_packed([[1]], max_new_tokens=0)
    assert eng.admit_packed([], max_new_tokens=4) == []
    with pytest.raises(ValueError):
        eng.admit_packed([[1] * (eng.max_suffix_tokens(4) + 1)], max_new_tokens=4)
    with pytest.raises(ValueError):
        TEngine(params[1], TMICRO, TOK, admission_chunk_tokens=0)


def test_allocation_failure_rolls_back_pages(params):
    """Under KV-page pressure the pack fails cleanly: no page or slot
    leaks, and the engine serves afterwards."""
    eng = t_engine(params[1], num_pages=8, max_pages_per_seq=8)
    free0 = eng.kv.pages_free
    with pytest.raises(RuntimeError):
        eng.admit_packed([TOK.encode("x" * 40)] * 3, max_new_tokens=40)
    assert eng.kv.pages_free == free0
    assert eng.free_slots == eng.max_slots
    assert len(eng.generate(TOK.encode("still works"), max_new_tokens=4).token_ids) >= 1


@pytest.mark.parametrize("in_flight", [False, True])
def test_failed_pack_rolls_back_slot_state_and_parked_tokens(params, monkeypatch, in_flight):
    """A pack that fails after a prompt ended (its slot active on the
    device) and a decode chunk was parked: its slots are freed and
    deactivated, its parked tokens are dropped unless a request was in
    flight, and the slots' next occupants decode as on a fresh engine."""
    _, tp = params
    eng = t_engine(tp)
    eng.set_prefix(PREFIX)
    if in_flight:
        (rid,) = eng.add_requests([TOK.encode("already running")], max_new_tokens=20)
    run = eng._pack_chunk
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected chunk failure")
        return run(*args, **kwargs)

    monkeypatch.setattr(eng, "_pack_chunk", failing)
    with pytest.raises(RuntimeError, match="injected"):
        eng.admit_packed(PROMPTS, max_new_tokens=10)
    monkeypatch.undo()
    # the first prompt ends in chunk 1: a chunk rides after it, and after
    # chunk 0 too with a request in flight
    parked = 2 if in_flight else 1
    assert eng.stats["piggyback_chunks"] == parked
    assert len(eng._pending_emissions) == (parked if in_flight else 0)
    busy = {r.slot for r in eng._by_slot.values()}
    assert len(busy) == int(in_flight) and eng.free_slots == eng.max_slots - len(busy)
    act, budget = eng._state.act.numpy(), eng._state.budget.numpy()
    assert not any(act[s] or budget[s] for s in range(eng.max_slots) if s not in busy)
    fresh = t_engine(tp)
    fresh.set_prefix(PREFIX)
    want = [fresh.generate(p, max_new_tokens=10).token_ids for p in PROMPTS[:2]]
    ids = eng.add_requests(PROMPTS[:2], max_new_tokens=10)
    out = {}
    while not set(ids) <= out.keys():
        for fin in eng.step():
            out[fin.req_id] = fin.token_ids
    assert [out[i] for i in ids] == want


def test_abort_all_frees_and_deactivates_every_slot(params):
    eng = t_engine(params[1])
    eng.set_prefix(PREFIX)
    eng.admit_packed(PROMPTS, max_new_tokens=10)
    assert eng._pending_emissions and eng.has_active
    with pytest.raises(RuntimeError, match="in flight"):
        eng.set_prefix(TOK.encode("another prefix"))
    eng.abort_all()
    assert not eng.has_active and not eng._pending_emissions
    assert eng.kv.pages_free == eng.kv.num_pages - 1
    assert not eng._state.act.any() and not eng._state.budget.any()
    assert eng.step() == []


# ---------------------------------------------------------- pin lifecycle
def test_pin_survives_byte_pressure_while_unpinned_entries_evict(params):
    eng = t_engine(params[1])
    pinned = TOK.encode("p" * 120)
    other = TOK.encode("q" * 120)
    key, epoch = eng.pin_prefix(pinned)
    assert eng.pin_alive(key, epoch) and eng.prefix_len == 0  # not activated
    eng.PREFIX_CACHE_BYTES = 1  # the instance attribute shadows the class's
    eng.set_prefix(other)
    assert eng.pin_alive(key, epoch)
    assert tuple(other) in eng._prefix_cache  # the newest is kept too
    eng.set_prefix(TOK.encode("r" * 120))
    assert eng.pin_alive(key, epoch)
    assert tuple(other) not in eng._prefix_cache
    assert eng.stats["pinned_prefixes"] == 1
    assert not eng.pin_alive(key, epoch + 1)


def test_unpin_makes_the_entry_evictable(params):
    eng = t_engine(params[1])
    key, epoch = eng.pin_prefix(TOK.encode("s" * 120))
    eng.unpin_prefix(key)
    assert not eng.pin_alive(key, epoch) and eng.stats["pin_evictions"] == 1
    eng.PREFIX_CACHE_BYTES = 1
    eng.set_prefix(TOK.encode("t" * 120))
    eng.set_prefix(TOK.encode("u" * 120))
    assert key not in eng._prefix_cache
    with pytest.raises(ValueError):
        eng.pin_prefix([])


def test_manager_ensure_hit_lru_and_refresh(params):
    eng = t_engine(params[1])
    mgr = PinnedPrefixManager(eng, max_pins=2)
    assert mgr.ensure("snap-1", TOK.encode("a" * 80)) is True
    assert mgr.ensure("snap-1", TOK.encode("a" * 80)) is False  # hit
    mgr.ensure("snap-2", TOK.encode("b" * 80))
    mgr.ensure("snap-3", TOK.encode("c" * 80))  # evicts snap-1 (LRU)
    assert set(mgr.pins) == {"snap-2", "snap-3"}
    s = mgr.stats()
    assert (s["pins"], s["pin_hits"], s["evictions"], s["live_pins"]) == (3, 1, 1, 2)
    assert mgr.ensure("snap-2", TOK.encode("v2 " * 30)) is True  # new content
    assert mgr.pins["snap-2"].cache_key == tuple(TOK.encode("v2 " * 30))
    assert mgr.source_of("snap-2") == "local" and mgr.source_of("snap-1") is None
    eng.prefix_epoch += 1  # what a weight swap does
    assert mgr.invalidate_stale() == 2 and not mgr.pins


def test_delta_prefix_prefills_only_its_tail(params):
    """A pinned snapshot seeds the delta-extended prefix: the chunked
    prefill starts at the shared length (the JAX engine's count too)."""
    jp, tp = params
    pin = TOK.encode("pinned " * 30)
    tail = TOK.encode(" STATE UPDATES tail")
    counts = []
    for eng in (t_engine(tp), j_engine(jp)):
        eng.pin_prefix(pin)
        before = eng.stats["prefill_tokens"]
        eng.set_prefix(pin + tail)
        counts.append((eng.stats["prefill_tokens"] - before,
                       eng.stats["prefix_reused_tokens"]))
    assert counts[0] == counts[1]
    assert counts[0][0] < len(pin) + len(tail) and counts[0][1] >= len(pin) // 2


# ---------------------------------------------------------------- backend
def _nodes(n=4, cpu=10.0):
    return [dataclasses.replace(x, cpu_usage_percent=cpu + i)
            for i, x in enumerate(ttesting.synthetic_nodes(n))]


def _jax_nodes(nodes):
    return [JNodeMetrics(**{f.name: getattr(n, f.name) for f in dataclasses.fields(n)})
            for n in nodes]


def _pods(n):
    return ttesting.fixture_pods(n)


def t_backend(tp, engine_kw=None, **kw):
    kw.setdefault("max_new_tokens", 80)
    kw.setdefault("delta_prompts", True)
    kw.setdefault("packed_admission", True)
    kw.setdefault("request_timeout_s", TIMEOUT_S)
    kw.setdefault("prewarm_idle_delay_s", TIMEOUT_S)
    # 32 pages a slot: a pod suffix and the decode budget fit the paged pack
    return TBackend(t_engine(tp, max_pages_per_seq=32, **(engine_kw or {})), **kw)


def test_delta_decision_identical_to_cold_prefill_of_the_same_prompt(params):
    """The delta path's KV shortcuts (pinned prefix + LCP seed) are exact:
    the same delta-encoded prompt prefilled whole gives the same decision."""
    _, tp = params
    nodes = _nodes()
    drifted = list(nodes)
    drifted[1] = dataclasses.replace(drifted[1], cpu_usage_percent=91.0)
    warm, pod = _pods(2)
    a = t_backend(tp)
    try:
        a.get_scheduling_decision(warm, nodes)  # pins
        da = a.get_scheduling_decision(pod, drifted)
        reused = a.engine.stats["prefix_reused_tokens"]
        stats = a.get_stats()
    finally:
        a.close()
    assert stats["delta"]["delta_encodes"] == 1 and stats["delta"]["pins"] == 1
    assert stats["pins"]["live_pins"] == 1
    assert reused > 0  # the pinned snapshot's KV seeded the delta prefix
    b = t_backend(tp)
    b._pin_manager = None  # no pin: the delta prefix prefills whole
    try:
        b.get_scheduling_decision(warm, nodes)
        db = b.get_scheduling_decision(pod, drifted)
    finally:
        b.close()
    assert b._pin_manager is None and not b.engine._pinned_prefix_keys
    assert (da.selected_node, da.reasoning) == (db.selected_node, db.reasoning)


def test_pin_refresh_mid_burst(params):
    backend = t_backend(params[1], repin_fraction=0.2)
    try:
        nodes = _nodes()
        names = {n.name for n in nodes}
        p1, p2 = _pods(2)
        assert backend.get_scheduling_decision(p1, nodes).selected_node in names
        drifted = [dataclasses.replace(n, cpu_usage_percent=70.0 + i)
                   for i, n in enumerate(nodes[:3])] + [nodes[3]]
        assert backend.get_scheduling_decision(p2, drifted).selected_node in names
        assert backend._delta.stats()["repin_drift"] == 1
        assert backend._pin_manager.stats()["pins"] == 2
    finally:
        backend.close()


def test_batch_routes_through_the_pack_as_the_jax_backend_does(params):
    """get_scheduling_decisions_batch of 3 pods is one packed admission of
    3 prompts, no wave, on both packages, with the same decisions."""
    jp, tp = params
    pods = _pods(3)
    backend = t_backend(tp)
    try:
        got = backend.get_scheduling_decisions_batch(pods, _nodes())
        stats = backend.engine.stats
    finally:
        backend.close()
    jbackend = JBackend(j_engine(jp, max_pages_per_seq=32), max_new_tokens=80,
                        delta_prompts=True, request_timeout_s=TIMEOUT_S,
                        prewarm_idle_delay_s=TIMEOUT_S)
    try:
        want = jbackend.get_scheduling_decisions_batch(
            [JPodSpec(**dataclasses.asdict(p)) for p in pods], _jax_nodes(_nodes()))
        jstats = jbackend.engine.stats
    finally:
        jbackend.close()
    assert not [d for d in got + want if isinstance(d, Exception)]
    assert [(d.selected_node, d.reasoning) for d in got] == [
        (d.selected_node, d.reasoning) for d in want]
    assert (stats["packed_admissions"], stats["packed_prompts"], stats["waves"]) == (1, 3, 0)
    for key in ("packed_admissions", "packed_prompts", "pack_chunks", "prefill_tokens"):
        assert stats[key] == jstats[key], key


def test_packed_admission_off_rides_waves(params):
    backend = t_backend(params[1], packed_admission=False)
    try:
        res = backend.get_scheduling_decisions_batch(_pods(2), _nodes())
    finally:
        backend.close()
    assert all(hasattr(r, "selected_node") for r in res)
    assert backend.engine.stats["packed_admissions"] == 0
    assert backend.engine.stats["waves"] >= 1


def test_quiesced_control_waits_for_the_pack_and_prewarm_pins(params):
    """A control enqueued behind a pack runs once the pack has decoded;
    a delta prewarm of the next snapshot pins nothing new and installs the
    delta group."""
    backend = t_backend(params[1])
    nodes = _nodes()
    try:
        res = backend.get_scheduling_decisions_batch(_pods(3), nodes)
        assert not any(isinstance(d, Exception) for d in res)
        _, pause = backend.run_quiesced(lambda: backend.engine.has_active, timeout_s=120)
        drifted = list(nodes)
        drifted[0] = dataclasses.replace(drifted[0], cpu_usage_percent=55.0)
        assert backend.prewarm_prefix(drifted).result(timeout=120) is True
        stats = backend.get_stats()
    finally:
        backend.close()
    assert pause >= 0.0
    assert stats["delta"]["delta_encodes"] == 1 and stats["pins"]["pins"] == 1
    assert stats["pins"]["pin_hits"] == 1


# ------------------------------------------------------------------- loop
N_NODES = 8
SNAPSHOT_TTL_S = 3600.0  # one snapshot a burst


def _two_bursts(testing, make_scheduler):
    """Burst 1 (8 pods) on a fresh cluster through Scheduler.run() until
    bound; then burst 2 (4 pods) on the same cluster, whose snapshot
    carries burst 1's binds. Returns ({pod: node}, [stats of each run])."""
    cluster = testing.synthetic_cluster(N_NODES)
    first = testing.pod_burst(8, distinct_shapes=8)
    second = [dataclasses.replace(p, name=f"second-{p.name}")
              for p in testing.pod_burst(4, distinct_shapes=4)]
    placed, stats = {}, []
    for burst, total in ((first, 8), (second, 12)):
        for pod in burst:
            cluster.add_pod(pod)
        scheduler = make_scheduler(cluster)

        async def drive():
            task = asyncio.create_task(scheduler.run())
            try:
                async with ttesting.async_deadline(300):
                    while cluster.bind_count < total:
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

        asyncio.run(drive())
        stats.append(scheduler.get_stats())
        placed.update({p.name: cluster.get_pod("default", p.name).node_name for p in burst})
    return placed, stats


def test_two_bursts_bind_where_the_jax_loop_binds_with_a_delta_second(params):
    """The config's default admission plane on the port, the JAX config's on the
    JAX loop: every pod of both bursts bound to the same node, no fallback,
    the first burst's prompts pinned and the second's delta-encoded over
    that pin."""
    jp, tp = params
    kw = {k: v for k, v in cli._backend_kwargs(Config(copy.deepcopy(DEFAULTS))).items()
          if k in ADMISSION_KEYS}
    chunk_tokens = kw.pop("admission_chunk_tokens")
    jbackend = JBackend(
        j_engine(jp, max_pages_per_seq=32, admission_chunk_tokens=chunk_tokens),
        max_new_tokens=80, request_timeout_s=TIMEOUT_S, prewarm_idle_delay_s=TIMEOUT_S,
        **kw,
    )

    def jmake(cluster):
        client = JClient(jbackend, cache=JCache(), breaker=JBreaker())
        return JScheduler(cluster, cluster, client, scheduler_name=jtesting.SCHEDULER_NAME,
                          snapshot_ttl_s=SNAPSHOT_TTL_S)

    try:
        want, jstats = _two_bursts(jtesting, jmake)
        jdelta = jbackend._delta.stats()
    finally:
        jbackend.close()
    backend = t_backend(tp, engine_kw={"admission_chunk_tokens": chunk_tokens}, **kw)
    try:
        got, tstats = _two_bursts(
            ttesting, lambda c: cli.build_stack(Config(copy.deepcopy(DEFAULTS)), c,
                                                backend=backend,
                                                snapshot_ttl_s=SNAPSHOT_TTL_S)[0])
        stats = backend.get_stats()
    finally:
        backend.close()
    assert kw == {"packed_admission": True, "delta_prompts": True,
                  "repin_fraction": 0.25, "max_pins": 4} and chunk_tokens == 256
    assert len(got) == 12 and None not in got.values()
    assert got == want
    for s in tstats + jstats:
        assert s["fallback_decisions"] == 0 and s["client"]["fallback_decisions"] == 0
        assert s["client"]["failed_requests"] == 0
    d = stats["delta"]
    assert d == jdelta
    assert d["pins"] == 1 and d["repin_membership"] == d["repin_drift"] == 0
    assert d["delta_encodes"] >= 1 and d["delta_nodes_total"] >= 1
    assert stats["pins"]["live_pins"] == 1 and stats["prefix_reused_tokens"] > 0
