"""Path B of the port held against the JAX package on the CPU: the plain
twins of K4 (paged decode attention) against the Pallas kernel in interpret
mode and the XLA gather path, the paged forwards, PagedKVCache's
bookkeeping, and the general-completion engine (add_requests / step /
generate) token for token.

Tolerances: 2e-5 where both sides compute in f32 (only the order of the
sums differs); 2e-2 with bf16 inputs (the Pallas kernel converts k/v to f32
as the plain twin does, but the two frameworks may round q's scaling
differently). The model forwards hold 1e-4 in f32, as in
test_torch_model.py. Greedy engine tokens are identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu.engine import constrained as jconstrained
from k8s_llm_scheduler_tpu.engine import kv_cache as jkv
from k8s_llm_scheduler_tpu.engine.engine import InferenceEngine as JEngine
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models import llama as jllama
from k8s_llm_scheduler_tpu.ops import attention as jA
from k8s_llm_scheduler_tpu.ops.pallas_paged_attention import (
    paged_decode_attention_pallas as jax_paged,
    paged_decode_attention_parts as jax_paged_parts,
)
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.core import prompt as tprompt
from k8s_llm_scheduler_tpu_torch.engine import constrained as tconstrained
from k8s_llm_scheduler_tpu_torch.engine import kv_cache as tkv
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine as TEngine
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models import llama as tllama
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.ops import attention as tA
from k8s_llm_scheduler_tpu_torch.ops.paged_attention import (
    NEG_INF,
    paged_attention_parts_plain,
    paged_attention_plain,
    paged_decode_attention,
    paged_decode_attention_parts,
)

ttesting.cap_torch_threads()

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
MODEL_F32 = dict(rtol=1e-4, atol=1e-4)
JTINY = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TTINY = dataclasses.replace(tconfigs.TINY, dtype=torch.float32)


def _np(x):
    return np.array(x, dtype=np.float32)


def _tnp(x):
    return x.float().numpy()


@pytest.fixture(scope="module")
def tiny_params():
    jp = jllama.init_params(jax.random.PRNGKey(0), JTINY)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


# ------------------------------------------------------------------- K4
class TestPagedKernelTwins:
    B, H, NKV, HD, PAGES, PS, P = 4, 8, 2, 64, 12, 16, 4
    # scattered page ids; row 2 is empty, row 3 negative (the engine's
    # trash row and idle slots)
    TABLES = np.asarray([[5, 2, 9, 11], [7, 3, 0, 0], [4, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    LENS = np.asarray([61, 17, 0, -40], np.int32)

    def _inputs(self, seed):
        rng = np.random.default_rng(seed)
        q = rng.standard_normal((self.B, self.H, self.HD)).astype(np.float32)
        k = rng.standard_normal((self.PAGES, self.PS, self.NKV, self.HD)).astype(np.float32)
        v = rng.standard_normal((self.PAGES, self.PS, self.NKV, self.HD)).astype(np.float32)
        return q, k, v

    @pytest.mark.parametrize("mode", ["parts", "normalized"])
    def test_plain_matches_pallas_interpret_bf16(self, mode):
        q, k, v = self._inputs(0)
        j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
        t = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() for a in j]
        pt, sl = torch.from_numpy(self.TABLES), torch.from_numpy(self.LENS)
        jpt, jsl = jnp.asarray(self.TABLES), jnp.asarray(self.LENS)
        if mode == "parts":
            o_j, m_j, l_j = jax_paged_parts(*j, jpt, jsl, interpret=True)
            o_t, m_t, l_t = paged_attention_parts_plain(*t, pt, sl)
            np.testing.assert_allclose(_tnp(m_t), _np(m_j), **BF16)
            np.testing.assert_allclose(_tnp(l_t), _np(l_j), **BF16)
            np.testing.assert_allclose(_tnp(o_t), _np(o_j), **BF16)
            dead = self.LENS <= 0
            assert (m_t[dead] == NEG_INF).all() and (l_t[dead] == 0).all()
            assert (o_t[dead] == 0).all()
        else:
            want = jax_paged(*j, jpt, jsl, interpret=True)
            got = paged_attention_plain(*t, pt, sl)
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(_tnp(got), _np(want), **BF16)
            assert (got[self.LENS <= 0] == 0).all()

    def test_parts_match_pallas_interpret_f32(self):
        q, k, v = self._inputs(1)
        pt, sl = jnp.asarray(self.TABLES), jnp.asarray(self.LENS)
        o_j, m_j, l_j = jax_paged_parts(*map(jnp.asarray, (q, k, v)), pt, sl, interpret=True)
        o_t, m_t, l_t = paged_decode_attention_parts(
            *map(torch.from_numpy, (q, k, v, self.TABLES, self.LENS))
        )
        np.testing.assert_allclose(_tnp(m_t), _np(m_j), **F32)
        np.testing.assert_allclose(_tnp(l_t), _np(l_j), **F32)
        np.testing.assert_allclose(_tnp(o_t), _np(o_j), **F32)

    def test_normalized_matches_xla_f32(self):
        """Against the gather-then-attend XLA path, on the rows with keys
        (XLA's softmax averages every key of an empty row; K4 returns 0)."""
        q, k, v = self._inputs(2)
        want = jA.paged_decode_attention(
            *map(jnp.asarray, (q, k, v, self.TABLES, self.LENS))
        )
        got = paged_decode_attention(*map(torch.from_numpy, (q, k, v, self.TABLES, self.LENS)))
        live = self.LENS > 0
        np.testing.assert_allclose(_tnp(got)[live], _np(want)[live], **F32)
        xla = tA.paged_decode_attention(*map(torch.from_numpy, (q, k, v, self.TABLES, self.LENS)))
        np.testing.assert_allclose(_tnp(xla), _np(want), **F32)

    def test_cpu_takes_the_plain_version_and_other_devices_raise(self):
        q, k, v = (torch.from_numpy(a) for a in self._inputs(3))
        pt, sl = torch.from_numpy(self.TABLES), torch.from_numpy(self.LENS)
        before = (paged_decode_attention_parts.launches, paged_decode_attention.launches)
        for got, want in zip(paged_decode_attention_parts(q, k, v, pt, sl),
                             paged_attention_parts_plain(q, k, v, pt, sl)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        paged_decode_attention(q, k, v, pt, sl)
        assert (paged_decode_attention_parts.launches, paged_decode_attention.launches) == before
        meta = [t.to("meta") for t in (q, k, v, pt, sl)]
        for fn in (paged_decode_attention_parts, paged_decode_attention):
            with pytest.raises(ValueError, match="no kernel"):
                fn(*meta)


# ------------------------------------------------------------- forwards
def _paged_case(rng, cfg, num_pages=16, ps=16):
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    k = (rng.standard_normal((L, num_pages, ps, kv, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((L, num_pages, ps, kv, hd)) * 0.5).astype(np.float32)
    return k, v


class TestPagedForwards:
    def _prefix(self, jp, rng, n=40, cap=64):
        ids = np.zeros((1, cap), dtype=np.int32)
        ids[0, :n] = rng.integers(1, 300, size=n)
        _, kj, vj = jllama.forward_prefill(jp, JTINY, jnp.asarray(ids), jnp.asarray([n]))
        return _np(kj[:, 0]), _np(vj[:, 0]), n

    def test_forward_prefill_suffix_matches_jax(self, tiny_params):
        """Logits and the KV scattered into pages (page 0, the scratch that
        padding blocks share, is left out)."""
        jp, tp = tiny_params
        rng = np.random.default_rng(0)
        pk, pv, plen = self._prefix(jp, rng)
        kc, vc = _paged_case(rng, JTINY)
        tokens = rng.integers(1, 300, size=(3, 32)).astype(np.int32)
        lens = np.asarray([32, 9, 0], np.int32)
        page_ids = np.asarray([[3, 7], [5, 0], [0, 0]], np.int32)
        lj, kcj, vcj = jllama.forward_prefill_suffix(
            jp, JTINY, jnp.asarray(tokens), jnp.asarray(lens), jnp.asarray(pk),
            jnp.asarray(pv), jnp.int32(plen), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(page_ids),
        )
        lt, kct, vct = tllama.forward_prefill_suffix(
            tp, TTINY, *map(torch.from_numpy, (tokens, lens, pk, pv)),
            torch.tensor(plen, dtype=torch.int32),
            torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()),
            torch.from_numpy(page_ids),
        )
        live = lens > 0
        np.testing.assert_allclose(_tnp(lt)[live], _np(lj)[live], **MODEL_F32)
        np.testing.assert_allclose(_tnp(kct)[:, 1:], _np(kcj)[:, 1:], **MODEL_F32)
        np.testing.assert_allclose(_tnp(vct)[:, 1:], _np(vcj)[:, 1:], **MODEL_F32)

    @pytest.mark.parametrize("own_impl", ["dense", "pallas"])
    def test_forward_decode_buffered_matches_jax(self, tiny_params, own_impl):
        jp, tp = tiny_params
        rng = np.random.default_rng(1)
        pk, pv, plen = self._prefix(jp, rng)
        L, kv, hd = JTINY.n_layers, JTINY.n_kv_heads, JTINY.head_dim
        B, n_steps = 3, 4
        tables = np.asarray([[3, 9, 1, 14], [7, 2, 0, 0], [0, 0, 0, 0]], np.int32)
        own = np.asarray([40, 0, -plen], np.int32)  # a trash-like negative row
        tail = np.asarray([1, 0, 2], np.int32)
        pos = (plen + np.maximum(own, 0) + tail).astype(np.int32)
        tokens = np.asarray([65, 66, 67], np.int32)
        ck = (rng.standard_normal((L, B, n_steps, kv, hd)) * 0.5).astype(np.float32)
        cv = (rng.standard_normal((L, B, n_steps, kv, hd)) * 0.5).astype(np.float32)
        kc, vc = _paged_case(rng, JTINY)
        if own_impl == "pallas":
            k_own, v_own, pt = kc, vc, tables
        else:  # the engine's per-chunk gather
            k_own = kc[:, tables].reshape(L, B, -1, kv, hd)
            v_own = vc[:, tables].reshape(L, B, -1, kv, hd)
            pt = None
        lj, ckj, cvj = jllama.forward_decode_buffered(
            jp, JTINY, *map(jnp.asarray, (tokens, pos, k_own, v_own, own, ck, cv, tail,
                                          pk, pv)), jnp.int32(plen),
            page_tables=None if pt is None else jnp.asarray(pt), own_impl=own_impl,
        )
        lt, ckt, cvt = tllama.forward_decode_buffered(
            tp, TTINY, *(torch.from_numpy(np.array(a)) for a in (
                tokens, pos, k_own, v_own, own, ck, cv, tail, pk, pv)),
            torch.tensor(plen, dtype=torch.int32),
            page_tables=None if pt is None else torch.from_numpy(pt), own_impl=own_impl,
        )
        np.testing.assert_allclose(_tnp(lt), _np(lj), **MODEL_F32)
        np.testing.assert_allclose(_tnp(ckt), _np(ckj), **MODEL_F32)
        np.testing.assert_allclose(_tnp(cvt), _np(cvj), **MODEL_F32)

    @pytest.mark.parametrize("paged_attn", ["xla", "pallas"])
    def test_forward_decode_matches_jax(self, tiny_params, paged_attn):
        jp, tp = tiny_params
        rng = np.random.default_rng(2)
        kc, vc = _paged_case(rng, JTINY)
        tables = np.asarray([[3, 9, 1, 14], [7, 2, 0, 0], [5, 0, 0, 0]], np.int32)
        tokens = np.asarray([70, 71, 72], np.int32)
        positions = np.asarray([40, 17, 3], np.int32)
        active = np.asarray([True, True, False])
        lj, kcj, vcj = jllama.forward_decode(
            jp, JTINY, *map(jnp.asarray, (tokens, positions, kc, vc, tables, active)),
            paged_attn=paged_attn,
        )
        lt, kct, vct = tllama.forward_decode(
            tp, TTINY, *(torch.from_numpy(np.array(a)) for a in (
                tokens, positions, kc, vc, tables, active)),
            paged_attn=paged_attn,
        )
        np.testing.assert_allclose(_tnp(lt)[:2], _np(lj)[:2], **MODEL_F32)
        # pages 0 (inactive slots' scratch) left out
        np.testing.assert_allclose(_tnp(kct)[:, 1:], _np(kcj)[:, 1:], **MODEL_F32)
        np.testing.assert_allclose(_tnp(vct)[:, 1:], _np(vcj)[:, 1:], **MODEL_F32)


# ------------------------------------------------------------- KV cache
def test_paged_kv_cache_bookkeeping_matches_jax():
    """One sequence of allocations, growth, truncation, prefill writes and
    releases: the same page tables, free counts, slot pages and contents."""
    caches = (
        jkv.PagedKVCache(JTINY, num_pages=12, page_size=16, max_slots=3, max_pages_per_seq=5),
        tkv.PagedKVCache(TTINY, num_pages=12, page_size=16, max_slots=3,
                         max_pages_per_seq=5, device="cpu"),
    )
    rng = np.random.default_rng(3)
    L, kv, hd = JTINY.n_layers, JTINY.n_kv_heads, JTINY.head_dim
    k_all = rng.standard_normal((L, 48, kv, hd)).astype(np.float32)
    trace = []
    for c, conv in zip(caches, (jnp.asarray, torch.from_numpy)):
        a = c.allocate_slot(20, reserve_decode=5)
        b = c.allocate_slot(3)
        c.write_prefill(a, conv(k_all), conv(k_all * 2), 20)
        c.ensure_capacity(b, 40)
        for _ in range(2):
            c.note_token_appended(a)
        c.ensure_decode_capacity(a)
        c.truncate(b, 17)
        with pytest.raises(jkv.OutOfPagesError if conv is jnp.asarray else tkv.OutOfPagesError):
            c.allocate_slot(90)
        c.free_slot(a)
        d = c.allocate_slot(33)
        trace.append((
            np.asarray(c.page_tables()), c.pages_free, c.slot_pages(b), c.slot_pages(d),
            c.slot_length(b), _np(c.k), _np(c.v),
        ))
    (tj, fj, bj, dj, lj, kj, vj), (tt, ft, bt, dt, lt, kt, vt) = trace
    np.testing.assert_array_equal(tt, tj)
    assert (ft, bt, dt, lt) == (fj, bj, dj, lj)
    np.testing.assert_array_equal(kt[:, 1:], kj[:, 1:])
    np.testing.assert_array_equal(vt[:, 1:], vj[:, 1:])


# --------------------------------------------------------------- engine
@pytest.mark.parametrize("constrained", [False, True], ids=["free", "grammar"])
def test_general_path_tokens_match_jax(tiny_params, constrained):
    """TINY in f32, greedy, three requests behind a 4-node cluster prefix:
    add_requests + step() until they finish, then generate(). The JAX
    engine runs fused_decode=False with paged_attn="gather"; the port runs
    paged_attn="pallas" (on the CPU K4's plain twin). Same tokens, pages
    all returned."""
    jp, tp = tiny_params
    jtok, ttok = JByteTokenizer(), ByteTokenizer()
    pe = tprompt.PromptEngine()
    cluster = pe.cluster_part(ttesting.synthetic_nodes(4))
    prompts = [
        ttok.chat_prompt_parts(pe.system_prompt, cluster, tprompt.pod_suffix(p))
        for p in ttesting.fixture_pods(3)
    ]
    prefix, suffixes = prompts[0][0], [s for _, s in prompts]
    names = [f"node-{i}" for i in range(4)]
    common = dict(num_pages=32, page_size=64, max_slots=4, max_pages_per_seq=8,
                  prefill_buckets=(128, 256, 2048), temperature=0.0, chunk_steps=8)
    max_new = 20

    jeng = JEngine(jp, JTINY, jtok, paged_attn="gather", fused_decode=False, **common)
    teng = TEngine(tp, TTINY, ttok, paged_attn="pallas", **common)
    results = []
    for eng, tok, build in ((jeng, jtok, jconstrained), (teng, ttok, tconstrained)):
        eng.set_prefix(prefix)
        if constrained:
            eng.set_grammar(build.build_decision_dfa(tok, names, max_reason_tokens=6))
        pages0 = eng.kv.pages_free
        ids = eng.add_requests(suffixes, max_new_tokens=max_new)
        fins = []
        while eng.has_active:
            fins += eng.step()
        by_id = {f.req_id: f.token_ids for f in fins}
        gen = eng.generate(suffixes[1], max_new_tokens=max_new)
        results.append(([by_id[i] for i in ids], gen.token_ids,
                         eng.kv.pages_free == pages0, eng.stats["chunks"]))
    assert results[1] == results[0]
    assert results[1][2]  # every page returned
    assert all(1 <= len(t) <= max_new for t in results[1][0])
