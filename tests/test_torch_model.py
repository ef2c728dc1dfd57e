"""The port's Llama model (models/llama.py) held against the JAX package on
the CPU, with the same weights (models/convert.params_from_jax).

Configs: TINY; SMALL cut to 2 layers and narrowed (head dim 128); and an
8B-shaped narrow config (2 layers, GQA group of 4, head dim 128, llama3 RoPE
scaling, untied LM head). f32 holds logits and KV to 1e-4 (the two
frameworks sum in different orders over a few layers); bf16 to 5e-2 of the
logits' scale (each side rounds activations to bf16 at its own places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models import llama as jllama
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models import llama as tllama
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.testing import cap_torch_threads

cap_torch_threads()

F32 = dict(rtol=1e-4, atol=1e-4)

SMALL_2L = dict(base="small", n_layers=2, d_model=512, n_heads=4, n_kv_heads=2,
                d_ff=1024)
LLAMA8B_2L = dict(base="llama-3.1-8b-instruct", n_layers=2, d_model=1024,
                  n_heads=8, n_kv_heads=2, d_ff=1024, vocab_size=512)
CONFIGS = {"tiny": dict(base="tiny"), "small-2l": SMALL_2L, "8b-2l": LLAMA8B_2L}


def _pair(name, dtype="float32"):
    """(jax cfg, torch cfg) of one of CONFIGS in `dtype`."""
    spec = dict(CONFIGS[name])
    base = spec.pop("base")
    jcfg = dataclasses.replace(
        jconfigs.get_config(base), dtype=getattr(jnp, dtype), **spec
    )
    tcfg = dataclasses.replace(
        tconfigs.get_config(base), dtype=getattr(torch, dtype), **spec
    )
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jp = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _np(x):
    return np.array(x, dtype=np.float32)


def _tnp(x):
    return x.float().numpy()


class TestConfigs:
    @pytest.mark.parametrize("name", sorted(jconfigs._REGISTRY))
    def test_fields_match_jax(self, name):
        j, t = jconfigs.get_config(name), tconfigs.get_config(name)
        for f in dataclasses.fields(j):
            if f.name == "dtype":
                continue
            jv, tv = getattr(j, f.name), getattr(t, f.name)
            if f.name == "rope_scaling" and jv is not None:
                assert dataclasses.asdict(jv) == dataclasses.asdict(tv)
            else:
                assert jv == tv, f.name
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        assert (t.head_dim, t.q_per_kv) == (j.head_dim, j.q_per_kv)

    @pytest.mark.parametrize("name", ["tiny", "llama-3.2-1b-instruct", "llama-3.1-8b-instruct"])
    def test_rope_inv_freq_matches_jax(self, name):
        j, t = jconfigs.get_config(name), tconfigs.get_config(name)
        np.testing.assert_allclose(
            _tnp(tllama.rope_inv_freq(t)), _np(jllama.rope_inv_freq(j)), rtol=1e-6
        )


class TestLayers:
    def test_rms_norm_and_rope_match_jax(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
        w = rng.standard_normal((64,)).astype(np.float32)
        np.testing.assert_allclose(
            _tnp(tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)),
            _np(jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), **F32,
        )
        pos = rng.integers(0, 9000, size=(2, 5)).astype(np.int32)
        cfg_j, cfg_t = _pair("8b-2l")
        hd = cfg_t.head_dim
        x = rng.standard_normal((2, 5, 4, hd)).astype(np.float32)
        got = tllama.apply_rope(
            torch.from_numpy(x), torch.from_numpy(pos), tllama.rope_inv_freq(cfg_t)
        )
        want = jllama.apply_rope(
            jnp.asarray(x), jnp.asarray(pos), jllama.rope_inv_freq(cfg_j)
        )
        np.testing.assert_allclose(_tnp(got), _np(want), rtol=1e-4, atol=1e-4)


class TestForwards:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_forward_prefill_matches_jax(self, name):
        jcfg, tcfg = _pair(name)
        jp, tp = _params(jcfg)
        rng = np.random.default_rng(1)
        tokens = rng.integers(1, 300, size=(2, 24)).astype(np.int32)
        lens = np.asarray([24, 17], dtype=np.int32)
        lj, kj, vj = jllama.forward_prefill(jp, jcfg, jnp.asarray(tokens), jnp.asarray(lens))
        lt, kt, vt = tllama.forward_prefill(
            tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(lens)
        )
        for b, n in enumerate(lens):
            np.testing.assert_allclose(_tnp(lt[b, :n]), _np(lj[b, :n]), **F32)
        np.testing.assert_allclose(_tnp(kt), _np(kj), **F32)
        np.testing.assert_allclose(_tnp(vt), _np(vj), **F32)
        none, k2, _ = tllama.forward_prefill(
            tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(lens),
            return_logits=False,
        )
        assert none is None
        torch.testing.assert_close(k2, kt, rtol=0, atol=0)

    def test_forward_prefill_bf16_within_bf16_tolerance(self):
        jcfg, tcfg = _pair("tiny", "bfloat16")
        jp, tp = _params(jcfg)
        rng = np.random.default_rng(2)
        tokens = rng.integers(1, 300, size=(1, 32)).astype(np.int32)
        lens = np.asarray([32], dtype=np.int32)
        lj, _, _ = jllama.forward_prefill(jp, jcfg, jnp.asarray(tokens), jnp.asarray(lens))
        lt, _, _ = tllama.forward_prefill(
            tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(lens)
        )
        scale = float(np.abs(_np(lj)).max())
        np.testing.assert_allclose(_tnp(lt), _np(lj), rtol=0, atol=5e-2 * scale)

    def _prefix(self, jp, jcfg, rng, n=40, cap=64):
        ids = np.zeros((1, cap), dtype=np.int32)
        ids[0, :n] = rng.integers(1, 300, size=n)
        _, kj, vj = jllama.forward_prefill(jp, jcfg, jnp.asarray(ids), jnp.asarray([n]))
        return kj[:, 0], vj[:, 0], n

    @pytest.mark.parametrize("name", ["tiny", "8b-2l"])
    def test_forward_prefill_suffix_dense_matches_jax(self, name):
        jcfg, tcfg = _pair(name)
        jp, tp = _params(jcfg)
        rng = np.random.default_rng(3)
        pk, pv, plen = self._prefix(jp, jcfg, rng)
        tokens = rng.integers(1, 300, size=(3, 16)).astype(np.int32)
        lens = np.asarray([16, 9, 0], dtype=np.int32)
        lj, kj, vj = jllama.forward_prefill_suffix_dense(
            jp, jcfg, jnp.asarray(tokens), jnp.asarray(lens), pk, pv, jnp.int32(plen)
        )
        lt, kt, vt = tllama.forward_prefill_suffix_dense(
            tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(lens),
            torch.from_numpy(_np(pk)), torch.from_numpy(_np(pv)),
            torch.tensor(plen, dtype=torch.int32),
        )
        np.testing.assert_allclose(_tnp(lt), _np(lj), **F32)
        for b, n in enumerate(lens):
            np.testing.assert_allclose(_tnp(kt[:, b, :n]), _np(kj[:, b, :n]), **F32)
            np.testing.assert_allclose(_tnp(vt[:, b, :n]), _np(vj[:, b, :n]), **F32)

    @pytest.mark.parametrize("name", ["tiny", "8b-2l"])
    def test_forward_block_decode_matches_jax(self, name):
        """One block-decode iteration: logits at each row's last valid token
        and the generated-KV buffers (the trash slot, written by several
        invalid tokens in an unspecified order, is left out)."""
        jcfg, tcfg = _pair(name)
        jp, tp = _params(jcfg)
        rng = np.random.default_rng(4)
        pk, pv, plen = self._prefix(jp, jcfg, rng)
        L, R, Fw, Ss, cap = jcfg.n_layers, 3, 5, 12, 8
        n_kv, hd = jcfg.n_kv_heads, jcfg.head_dim
        blk_len = np.asarray([5, 2, 0], dtype=np.int32)
        blk_valid = np.arange(Fw)[None, :] < blk_len[:, None]
        blk_tok = np.where(blk_valid, rng.integers(1, 300, size=(R, Fw)), 0).astype(np.int32)
        suffix_lens = np.asarray([12, 7, 0], dtype=np.int32)
        tail = np.asarray([3, 0, 0], dtype=np.int32)
        positions = (plen + suffix_lens + tail)[:, None] + np.arange(Fw)[None, :]
        positions = positions.astype(np.int32)
        k_sfx = rng.standard_normal((L, R, Ss, n_kv, hd)).astype(np.float32)
        v_sfx = rng.standard_normal((L, R, Ss, n_kv, hd)).astype(np.float32)
        gen_k = rng.standard_normal((L, R, cap + 1, n_kv, hd)).astype(np.float32)
        gen_v = rng.standard_normal((L, R, cap + 1, n_kv, hd)).astype(np.float32)
        args = (blk_tok, blk_valid, blk_len, positions, k_sfx, v_sfx,
                suffix_lens, gen_k, gen_v, tail)
        lj, gkj, gvj = jllama.forward_block_decode(
            jp, jcfg, *map(jnp.asarray, args), pk, pv, jnp.int32(plen)
        )
        lt, gkt, gvt = tllama.forward_block_decode(
            tp, tcfg, *(torch.from_numpy(np.array(a)) for a in args),
            torch.from_numpy(_np(pk)), torch.from_numpy(_np(pv)),
            torch.tensor(plen, dtype=torch.int32),
        )
        for r, n in enumerate(blk_len):
            if n:
                np.testing.assert_allclose(_tnp(lt[r]), _np(lj[r]), **F32)
        np.testing.assert_allclose(_tnp(gkt[:, :, :cap]), _np(gkj[:, :, :cap]), **F32)
        np.testing.assert_allclose(_tnp(gvt[:, :, :cap]), _np(gvj[:, :, :cap]), **F32)


class TestParams:
    def test_params_from_jax_moves_bf16_bit_for_bit(self):
        jcfg, _ = _pair("tiny", "bfloat16")
        jp = jllama.init_params(jax.random.PRNGKey(3), jcfg)
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        assert tp["embed"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_tnp(tp["embed"]), _np(jp["embed"]))
        np.testing.assert_array_equal(
            _tnp(tp["layers"]["w_down"]), _np(jp["layers"]["w_down"])
        )

    @pytest.mark.parametrize("name", ["tiny", "8b-2l"])
    def test_init_params_has_the_jax_layout(self, name):
        jcfg, tcfg = _pair(name, "bfloat16")
        shapes = jax.eval_shape(lambda: jllama.init_params(jax.random.PRNGKey(0), jcfg))
        tp = tllama.init_params(tcfg, seed=0, device="cpu")
        flat_j = jax.tree_util.tree_leaves_with_path(shapes)
        assert len(flat_j) == len(jax.tree_util.tree_leaves(tp))
        for path, leaf in flat_j:
            node = tp
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == tuple(leaf.shape), path
            assert node.dtype == torch.bfloat16

    def test_init_params_is_seeded(self):
        _, tcfg = _pair("tiny", "bfloat16")
        a = tllama.init_params(tcfg, seed=5, device="cpu")
        b = tllama.init_params(tcfg, seed=5, device="cpu")
        c = tllama.init_params(tcfg, seed=6, device="cpu")
        assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
        assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])

    def test_init_params_defaults_to_cuda_and_raises_without_it(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tllama.init_params(tconfigs.TINY)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params_from_jax({"embed": np.zeros((2, 2), np.float32)})
