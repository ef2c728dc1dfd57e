"""The port's speculative decoding (k8s_llm_scheduler_tpu_torch/spec/) held
against the JAX package's on the CPU, with the JAX tests' configs (target:
vocab 512, d 64, 2 layers, f32; draft: d 32, 1 layer), the JAX weights
carried across by models/convert, and the port's engines with graphs=False
(the static-buffer code a card captures):

- hidden_transfer_logits and the verify block's forward (logits, final
  hidden states and the scattered cache pages) at rtol = atol = 1e-4, K1's
  prefix part through its plain twin here;
- greedy acceptance (accept count, next token, next state) equal in the
  grammar modes none, sparse and dense, and the draft's greedy proposal
  (tokens, states, choice indices, masked logits) equal, free and under
  the grammar;
- greedy generate through the decoder token-identical to the JAX
  SpeculativeDecoder's and to the port's plain generate, with the same
  round books and the same host syncs: the disagreeing draft, the
  self-draft (acceptance 1.0, every steady round overlapped), the
  wider-vocab draft, and the hidden arm, unconstrained and under the
  decision grammar behind a cluster prefix;
- rejection sampling preserves the target distribution: 4,000 draws of
  the first emitted token of a fixed (p, q) within total variation 0.05 of
  softmax(p);
- PagedKVCache.truncate's cases from the JAX package's tests, on both
  caches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu.engine import kv_cache as jkv
from k8s_llm_scheduler_tpu.engine.constrained import build_decision_dfa as jbuild_dfa
from k8s_llm_scheduler_tpu.engine.engine import InferenceEngine as JEngine
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu.models.configs import LlamaConfig as JConfig
from k8s_llm_scheduler_tpu.models.llama import hidden_transfer_logits as jht_logits
from k8s_llm_scheduler_tpu.models.llama import init_hidden_transfer as jinit_ht
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.spec import draft as jdraft
from k8s_llm_scheduler_tpu.spec import verify as jverify
from k8s_llm_scheduler_tpu.spec.decoder import SpeculativeDecoder as JDecoder
from k8s_llm_scheduler_tpu_torch.engine import kv_cache as tkv
from k8s_llm_scheduler_tpu_torch.engine.constrained import build_decision_dfa
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.models.llama import hidden_transfer_logits
from k8s_llm_scheduler_tpu_torch.spec import SpeculativeDecoder
from k8s_llm_scheduler_tpu_torch.spec import draft as tdraft
from k8s_llm_scheduler_tpu_torch.spec import verify as tverify
from k8s_llm_scheduler_tpu_torch.testing import cap_torch_threads

cap_torch_threads()

TOK = ByteTokenizer()
JTOK = JByteTokenizer()
ARCH = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
            max_seq_len=2048, rope_theta=10000.0, tie_embeddings=True)
DRAFT_ARCH = dict(vocab_size=512, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=64,
                  max_seq_len=2048, rope_theta=10000.0, tie_embeddings=True)
JCFG = JConfig(name="spec-test", dtype=jnp.float32, **ARCH)
TCFG = LlamaConfig(name="spec-test", dtype=torch.float32, **ARCH)
JDRAFT = JConfig(name="spec-draft", dtype=jnp.float32, **DRAFT_ARCH)
TDRAFT = LlamaConfig(name="spec-draft", dtype=torch.float32, **DRAFT_ARCH)
WIDE = {**DRAFT_ARCH, "vocab_size": 640}
JWIDE = JConfig(name="spec-draft-wide", dtype=jnp.float32, **WIDE)
TWIDE = LlamaConfig(name="spec-draft-wide", dtype=torch.float32, **WIDE)
ENGINE = dict(num_pages=64, page_size=64, max_slots=2, max_pages_per_seq=16,
              prefill_buckets=(128, 256, 512), chunk_steps=8, temperature=0.0)
NAMES = ["node-a", "node-b", "node-west-1"]
PROMPT = TOK.encode("The quick brown fox jumps over the lazy dog. " * 2)
GRAMMAR_PREFIX = TOK.encode("cluster: node-a node-b node-west-1. ")
GRAMMAR_PROMPT = TOK.encode("Pick a node: ")
TOL = dict(rtol=1e-4, atol=1e-4)  # f32, as tests/test_torch_model.py
K = 4
DRAWS = 4000
TV_LIMIT = 0.05  # the bound of test_torch_sampling.py for 4,000 draws


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _convert(jp):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def weights():
    """(JAX, port) params of the target, the draft, the wide draft, and the
    hidden-transfer head (JAX's init, carried across by models/convert)."""
    jp = jinit_params(jax.random.PRNGKey(0), JCFG)
    jd = jinit_params(jax.random.PRNGKey(7), JDRAFT)
    jw = jinit_params(jax.random.PRNGKey(9), JWIDE)
    jh = jinit_ht(jax.random.PRNGKey(1), JCFG, K)
    return {name: (j, _convert(j)) for name, j in
            (("target", jp), ("draft", jd), ("wide", jw), ("head", jh))}


def _engines(weights, grammar: bool, **kw):
    jp, tp = weights["target"]
    jeng = JEngine(jp, JCFG, JTOK, **{**ENGINE, **kw})
    teng = InferenceEngine(tp, TCFG, TOK, graphs=False, **{**ENGINE, **kw})
    if grammar:
        jeng.set_grammar(jbuild_dfa(JTOK, NAMES, max_reason_tokens=16))
        teng.set_grammar(build_decision_dfa(TOK, NAMES, max_reason_tokens=16))
        jeng.set_prefix(GRAMMAR_PREFIX)
        teng.set_prefix(GRAMMAR_PREFIX)
    return jeng, teng


# ------------------------------------------------------ hidden-transfer head
def test_hidden_transfer_logits_match_jax(weights):
    (jp, tp), (jh, th) = weights["target"], weights["head"]
    assert tuple(th["transfer"].shape) == (K, JCFG.d_model, JCFG.d_model)
    x = np.random.default_rng(0).standard_normal((3, JCFG.d_model)).astype(np.float32)
    want = jht_logits(jp, JCFG, jh, jnp.asarray(x))
    got = hidden_transfer_logits(tp, TCFG, th, torch.from_numpy(x))
    assert got.shape == (3, K, JCFG.vocab_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


# -------------------------------------------------------- verify forward
@pytest.mark.parametrize("W,prefix_len", [(K + 1, 37), (1, 0)], ids=["W5-prefix", "W1-empty"])
def test_forward_verify_block_matches_jax(weights, W, prefix_len):
    """Logits, final hidden states and the cache pages after the block's
    scatter, at one slot's page row with 70 own tokens (two pages) and the
    block landing across its second and third pages."""
    (jp, tp) = weights["target"]
    rng = np.random.default_rng(W)
    L, n_kv, hd, ps, n_pages, P = JCFG.n_layers, JCFG.n_kv_heads, JCFG.head_dim, 16, 12, 6
    Sp = 64
    pk = rng.standard_normal((L, Sp, n_kv, hd)).astype(np.float32)
    pv = rng.standard_normal((L, Sp, n_kv, hd)).astype(np.float32)
    kc = rng.standard_normal((L, n_pages, ps, n_kv, hd)).astype(np.float32)
    vc = rng.standard_normal((L, n_pages, ps, n_kv, hd)).astype(np.float32)
    own_len = 30
    table = np.array([[3, 7, 2, 0, 0, 0]], dtype=np.int32)
    assert table.shape[1] == P
    blk = rng.integers(1, 500, size=W).astype(np.int32)
    positions = (prefix_len + own_len + np.arange(W)).astype(np.int32)
    own_pos = own_len + np.arange(W)
    page_ids = table[0, own_pos // ps].astype(np.int32)
    offs = (own_pos % ps).astype(np.int32)
    j_out = jverify._forward_verify_block(
        jp, JCFG, jnp.asarray(blk), jnp.asarray(positions), jnp.asarray(pk), jnp.asarray(pv),
        jnp.int32(prefix_len), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(table),
        jnp.int32(own_len), jnp.asarray(page_ids), jnp.asarray(offs),
    )
    t_kc, t_vc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    logits, x = tverify._forward_verify_block(
        tp, TCFG, torch.from_numpy(blk), torch.from_numpy(positions), torch.from_numpy(pk),
        torch.from_numpy(pv), torch.tensor(prefix_len, dtype=torch.int32), t_kc, t_vc,
        torch.from_numpy(table), torch.tensor(own_len, dtype=torch.int32),
        torch.from_numpy(page_ids), torch.from_numpy(offs),
    )
    assert logits.shape == (W, JCFG.vocab_size) and x.shape == (W, JCFG.d_model)
    for got, want in zip((logits, x, t_kc, t_vc), j_out):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # the scatter wrote exactly the block's destinations
    changed = (_np(t_kc) != kc).any(axis=(0, 3, 4))
    want_changed = np.zeros((n_pages, ps), dtype=bool)
    want_changed[page_ids, offs] = True
    np.testing.assert_array_equal(changed, want_changed)


# --------------------------------------------------------- greedy accept
def _walk(sp_tokens, sp_next, start, n, rng):
    """n legal (token, next state) steps through the sparse tables."""
    out, st = [], start
    for _ in range(n):
        row = sp_tokens[st]
        legal = np.nonzero(row >= 0)[0]
        k = int(rng.choice(legal))
        out.append((int(row[k]), int(sp_next[st, k])))
        st = out[-1][1]
    return out


@pytest.mark.parametrize("grammar", ["none", "sparse", "dense"])
@pytest.mark.parametrize("diverge", [0, 2, K], ids=["reject-first", "accept-2", "accept-all"])
def test_greedy_accept_matches_jax(weights, grammar, diverge):
    """Random target logits over a block whose drafts follow the target's
    masked argmax up to `diverge`, then a different legal token: accept
    count, next token and next state equal (exact)."""
    jeng, teng = _engines(weights, grammar != "none")
    rng = np.random.default_rng(diverge)
    W = K + 1
    logits = (3.0 * rng.standard_normal((W, JCFG.vocab_size))).astype(np.float32)
    sp_tokens, sp_next = _np(teng._sp_tokens), _np(teng._sp_next)
    dense_t = teng.dense_grammar() if grammar == "dense" else teng._fused_dummy
    dense_j = jeng.dense_grammar() if grammar == "dense" else jeng._fused_dummy
    # the block: t_cur then K drafts, each state the one after its token
    if grammar == "none":
        states = np.zeros(W, dtype=np.int32)
    else:
        start = int(teng._dfa_start)
        states = np.array([start] + [s for _, s in _walk(sp_tokens, sp_next, start, K, rng)],
                          dtype=np.int32)
    masked_t, _ = tverify._masked_target(
        torch.from_numpy(logits), torch.from_numpy(states), teng._sp_tokens, teng._sp_next,
        dense_t, TOK.pad_id, grammar, None)
    tgt = np.argmax(_np(masked_t), axis=-1)
    drafts, mask_states = [], [int(states[0])]
    for i in range(K):
        st = mask_states[-1]
        if grammar == "sparse":
            tok, nxt = int(sp_tokens[st, tgt[i]]), int(sp_next[st, tgt[i]])
        elif grammar == "dense":
            tok, nxt = int(tgt[i]), int(_np(dense_t)[st, tgt[i]])
        else:
            tok, nxt = int(tgt[i]), 0
        if i >= diverge:
            # any other token rejects (legal or not); the states past the
            # divergence are never read
            tok, nxt = tok % 500 + 1, st
        drafts.append(tok)
        mask_states.append(nxt)
    mask_states = np.array(mask_states, dtype=np.int32)
    drafts = np.array(drafts, dtype=np.int32)
    jm, jf = jverify._masked_target(
        jnp.asarray(logits), jnp.asarray(mask_states), jeng._sp_tokens, jeng._sp_next,
        dense_j, JTOK.pad_id, grammar, None)
    want = jverify._accept_block(
        jm, jf, jnp.asarray(drafts), jnp.zeros((K,), jnp.int32), jnp.zeros((K, 1)),
        jax.random.PRNGKey(0), 0.0, grammar, True, sp_tokens=jeng._sp_tokens,
        mask_states=jnp.asarray(mask_states))
    tm, tf = tverify._masked_target(
        torch.from_numpy(logits), torch.from_numpy(mask_states), teng._sp_tokens,
        teng._sp_next, dense_t, TOK.pad_id, grammar, None)
    got = tverify._accept_block(
        tm, tf, torch.from_numpy(drafts), torch.zeros(K, dtype=torch.int32),
        torch.zeros((K, 1)), None, 0.0, grammar, True, sp_tokens=teng._sp_tokens,
        mask_states=torch.from_numpy(mask_states))
    assert [int(v) for v in got] == [int(v) for v in want]
    assert int(got[0]) == diverge


# ------------------------------------------------------- draft proposal
@pytest.mark.parametrize("grammar", [False, True], ids=["free", "grammar"])
def test_draft_propose_greedy_matches_jax(weights, grammar):
    jeng, teng = _engines(weights, grammar)
    (jd, td) = weights["draft"]
    ctx = list(PROMPT)
    jr = jdraft.DraftRunner(jd, JDRAFT)
    tr = tdraft.DraftRunner(td, TDRAFT)
    jr.begin(ctx, JTOK.pad_id, extra=40)
    tr.begin(ctx, TOK.pad_id, extra=40)
    assert tr.capacity == jr.capacity
    state = int(teng._dfa_start) if grammar else 0
    pos, tok = len(ctx), 101
    for _ in range(2):  # twice: the second reads the first's buffer writes
        want = jr.propose(tok, pos, state, jeng._sp_tokens, jeng._sp_next, JTOK.pad_id,
                          jax.random.PRNGKey(0), 0.0, K, grammar)
        got = tr.propose(torch.tensor(tok, dtype=torch.int32),
                         pos, torch.tensor(state, dtype=torch.int32), teng._sp_tokens,
                         teng._sp_next, TOK.pad_id, None, 0.0, K, grammar)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        np.testing.assert_allclose(_np(got[3]), np.asarray(want[3]), **TOL)
        assert got[0].shape == (K + 1,) and got[3].shape[0] == K
        tok, state, pos = int(_np(got[0])[K]), int(_np(got[1])[K]), pos + K + 1


def test_build_random_draft_widens_to_the_tokenizer():
    cfg = dataclasses.replace(TDRAFT, vocab_size=300)
    params, wide = tdraft.build_random_draft(cfg, 512, seed=3, device="cpu")
    jwide = jdraft.build_random_draft(dataclasses.replace(JDRAFT, vocab_size=300), 512, 3)[1]
    assert wide.vocab_size == jwide.vocab_size == 512
    assert params["embed"].shape == (512, TDRAFT.d_model)
    assert tdraft.build_random_draft(TDRAFT, 500, seed=3, device="cpu")[1] is TDRAFT


# ------------------------------------------------ greedy generate vs JAX
SCENARIOS = {
    # name: (arm, draft weights key or "self" or None, grammar, decoder kwargs)
    "draft": ("draft", "draft", False, {}),
    "draft-grammar": ("draft", "draft", True, {}),
    "self-draft": ("draft", "self", False, {}),
    "wide-draft": ("draft", "wide", False, {}),
    "hidden": ("hidden", None, False, {}),
    "hidden-grammar": ("hidden", None, True, {}),
}
BOOKS = ("rounds", "proposed", "accepted", "emitted", "overlapped_rounds", "ahead_wasted",
         "disables", "fallback_requests")


def _decoders(weights, jeng, teng, arm, draft):
    kw = dict(k=K, min_rounds=10**9)
    if arm == "hidden":
        jh, th = weights["head"]
        return (JDecoder(jeng, arm="hidden", hidden_head=jh, **kw),
                SpeculativeDecoder(teng, arm="hidden", hidden_head=th, **kw))
    if draft == "self":
        (jp, tp) = weights["target"]
        return JDecoder(jeng, jp, JCFG, **kw), SpeculativeDecoder(teng, tp, TCFG, **kw)
    jcfg, tcfg = (JDRAFT, TDRAFT) if draft == "draft" else (JWIDE, TWIDE)
    jd, td = weights[draft]
    return JDecoder(jeng, jd, jcfg, **kw), SpeculativeDecoder(teng, td, tcfg, **kw)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_greedy_generate_is_token_identical_to_jax_and_plain(weights, scenario):
    arm, draft, grammar, _ = SCENARIOS[scenario]
    prompt, n = (GRAMMAR_PROMPT, 110) if grammar else (PROMPT, 24)
    jeng, teng = _engines(weights, grammar)
    plain = teng.generate(prompt, n).token_ids
    jdec, tdec = _decoders(weights, jeng, teng, arm, draft)
    jeng.attach_spec(jdec)
    teng.attach_spec(tdec)
    j0, t0 = jeng.stats["syncs"], teng.stats["syncs"]
    want = jeng.generate(prompt, n).token_ids
    got = teng.generate(prompt, n).token_ids
    assert got == want == plain
    jb, tb = jdec.stats.snapshot(), tdec.stats.snapshot()
    assert {k: tb[k] for k in BOOKS} == {k: jb[k] for k in BOOKS}
    assert tb["rounds"] > 0 and tb["emitted"] == len(got) - 1
    # one host sync a round (and one at start), as the JAX decoder
    assert teng.stats["syncs"] - t0 == jeng.stats["syncs"] - j0
    if arm == "draft":
        assert teng.stats["syncs"] - t0 == tb["rounds"] + 1
    if draft == "self":
        assert tb["acceptance_rate"] == 1.0 and tb["ahead_wasted"] == 0
        assert tb["overlapped_rounds"] == tb["rounds"] - 1
    if arm == "hidden":
        assert tb["overlap_fraction"] == 1.0
    if grammar:
        assert tb["acceptance_rate"] > 0.2  # the skeleton's forced runs
        mode = tdec._grammar_mode()[0]
        assert mode == "dense"
    assert teng.kv.pages_free == teng.kv.num_pages - 1
    assert teng.free_slots == teng.max_slots


# ----------------------------------------------------- rejection sampling
def test_rejection_sampling_preserves_the_target_distribution():
    """A fixed target p (3 positions) and draft q (2 proposals) over 16
    tokens; each draw samples the drafts from q, then _accept_block; the
    first emitted token (the first draft if accepted, else the resample)
    must follow softmax(p[0])."""
    V, temp = 16, 0.7
    rng = np.random.default_rng(5)
    p = torch.from_numpy((1.5 * rng.standard_normal((K - 1, V))).astype(np.float32))
    q = torch.from_numpy((1.5 * rng.standard_normal((K - 2, V))).astype(np.float32))
    gen = torch.Generator().manual_seed(11)
    states = torch.zeros(K - 1, dtype=torch.int32)
    masked, idx_to_tok = tverify._masked_target(p, states, None, None, None, V + 5, "none", None)
    q_probs = torch.softmax(q / temp, dim=-1)
    counts = np.zeros(V)
    for _ in range(DRAWS):
        drafts = torch.multinomial(q_probs, 1, generator=gen)[:, 0].int()
        a, t_next, _ = tverify._accept_block(masked, idx_to_tok, drafts, drafts, q, gen, temp,
                                             "none", False)
        counts[int(drafts[0]) if int(a) >= 1 else int(t_next)] += 1
    target = torch.softmax(p[0] / temp, dim=-1).numpy()
    tv = 0.5 * np.abs(counts / DRAWS - target).sum()
    assert tv <= TV_LIMIT, tv


# ------------------------------------------------------ KV truncate (JAX)
def _caches(num_pages=16, page_size=4):
    kw = dict(num_pages=num_pages, page_size=page_size, max_slots=2, max_pages_per_seq=8)
    return jkv.PagedKVCache(JCFG, **kw), tkv.PagedKVCache(TCFG, device="cpu", **kw)


def _truncate_case(kv, case):
    free0 = kv.pages_free
    if case == "frees-tail":
        slot = kv.allocate_slot(3, reserve_decode=9)
        before = kv.slot_pages(slot)
        kv.truncate(slot, 5)
        return (free0 - kv.pages_free, kv.slot_pages(slot) == before[:2],
                list(kv._tables_np[slot][2:]), kv.slot_length(slot))
    if case == "idempotent":
        slot = kv.allocate_slot(10)
        for n in (2, 2, 1):
            kv.truncate(slot, n)
        used = free0 - kv.pages_free
        kv.free_slot(slot)
        return used, kv.pages_free == free0, bool((kv._refcount[1:] == 0).all())
    if case == "reuse":
        slot = kv.allocate_slot(12)
        dropped = kv.slot_pages(slot)[1:]
        kv.truncate(slot, 4)
        kv.ensure_capacity(slot, 12)
        return set(kv.slot_pages(slot)[1:]) == set(dropped), kv.slot_length(slot)
    if case == "keeps-one-page":
        slot = kv.allocate_slot(9)
        kv.truncate(slot, 0)
        return len(kv.slot_pages(slot)), free0 - kv.pages_free, kv.slot_length(slot)
    if case == "negative":
        slot = kv.allocate_slot(4)
        with pytest.raises(ValueError):
            kv.truncate(slot, -1)
        return True
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["frees-tail", "idempotent", "reuse", "keeps-one-page",
                                  "negative"])
def test_truncate_cases_agree_with_jax(case):
    jc, tc = _caches()
    assert _truncate_case(tc, case) == _truncate_case(jc, case)


def test_truncated_then_regrown_append_roundtrip_agrees_with_jax():
    out = []
    for kv, conv in zip(_caches(), (jnp.asarray, torch.from_numpy)):
        slot = kv.allocate_slot(8)
        k_all = np.ones((JCFG.n_layers, 8, JCFG.n_kv_heads, JCFG.head_dim), np.float32)
        kv.write_prefill(slot, conv(k_all), conv(k_all), 8)
        kv.truncate(slot, 5)
        n5 = len(kv.slot_pages(slot))
        kv.truncate(slot, 3)
        kv.ensure_capacity(slot, 6)
        for _ in range(3):
            kv.note_token_appended(slot)
        out.append((n5, kv.slot_length(slot), len(kv.slot_pages(slot)),
                    list(kv._tables_np[slot])))
    assert out[0] == out[1]
    assert out[1][:3] == (2, 6, 2)
