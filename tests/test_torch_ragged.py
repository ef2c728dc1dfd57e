"""Path A of the port held against the JAX package on the CPU: int8
weight-only quantization (models/quant.py), the plain twin of K3 (the
ragged-M matmul) against the Pallas kernel in interpret mode, ragged block
decode, and a whole greedy decision wave with int8 weights and ragged
matmuls, token for token.

Tolerances: quantization and the host int8 init are bit-identical (same
numpy draws, the same IEEE f32 division and round-half-even). K3's f32 sums
differ from the Pallas kernel's only in order, so its bf16 outputs agree to
about one bf16 rounding (1e-2 relative) and its f32 outputs to 1e-5 of
the largest output; rows
past the last computed 64-row tile are exactly zero on both sides. The f32
model forwards hold 1e-4, as in test_torch_model.py; with int8 weights the
ragged path rounds activations to bf16 next to the matmul on both sides,
so a bf16 rounding may land differently: 1e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu.engine import constrained as jconstrained
from k8s_llm_scheduler_tpu.engine.engine import InferenceEngine as JEngine
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models import llama as jllama
from k8s_llm_scheduler_tpu.models import quant as jquant
from k8s_llm_scheduler_tpu.ops.ragged_matmul import ragged_matmul as jax_ragged
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.core import prompt as tprompt
from k8s_llm_scheduler_tpu_torch.engine import constrained as tconstrained
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine as TEngine
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models import llama as tllama
from k8s_llm_scheduler_tpu_torch.models import quant as tquant
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.ops.ragged_matmul import (
    BM,
    COLS_PER_BLOCK,
    K_STEP,
    MAX_ROWS,
    MAX_SPLITS,
    MAX_STAGES,
    RING_BYTES,
    combine_parts_plain,
    fragment_columns,
    k_splits,
    ragged_matmul,
    ragged_matmul_plain,
    split_parts_plain,
)

ttesting.cap_torch_threads()

F32 = dict(rtol=1e-4, atol=1e-4)
INT8_F32 = dict(rtol=1e-2, atol=1e-2)


def _np(x):
    return np.array(x, dtype=np.float32)


def _tnp(x):
    return x.float().numpy()


def _to_torch(jtree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


class TestQuant:
    def test_quantize_weight_is_bit_identical_to_jax(self):
        rng = np.random.default_rng(0)
        w = (rng.standard_normal((3, 64, 48)) * 0.05).astype(np.float32)
        w[1, :, 5] = 0.0  # an all-zero channel takes the 1e-12 scale floor
        want = jquant.quantize_weight(jnp.asarray(w))
        got = tquant.quantize_weight(torch.from_numpy(w))
        assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))

    def test_init_params_int8_host_is_bit_identical_to_jax(self):
        cfg_j = dataclasses.replace(jconfigs.TINY, tie_embeddings=False, n_layers=2)
        cfg_t = dataclasses.replace(tconfigs.TINY, tie_embeddings=False, n_layers=2)
        want = jax.tree_util.tree_map(np.asarray, jquant.init_params_int8_host(7, cfg_j))
        got = tquant.init_params_int8_host(7, cfg_t, device="cpu")
        flat_j = jax.tree_util.tree_leaves_with_path(want)
        assert len(flat_j) == len(jax.tree_util.tree_leaves(got))
        for path, leaf in flat_j:
            node = got
            for key in path:
                node = node[key.key]
            if leaf.dtype.name == "bfloat16":
                leaf = leaf.astype(np.float32)
            np.testing.assert_array_equal(node.float().numpy(), leaf.astype(np.float32))
        assert got["layers"]["w_down"]["q"].dtype == torch.int8
        assert tquant.param_bytes(got) == jquant.param_bytes(
            jquant.init_params_int8_host(7, cfg_j)
        )

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_dense_int8_matches_jax(self, dtype):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 5, 64)).astype(np.float32)
        w = jquant.quantize_weight(jnp.asarray(rng.standard_normal((64, 96)) * 0.1, jnp.float32))
        xj = jnp.asarray(x, getattr(jnp, dtype))
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
        want = jllama._dense(xj, w, "bsd,dh->bsh")
        got = tllama._dense(xt, _to_torch(w))
        tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(_tnp(got), _np(want), **tol)

    def test_params_from_jax_keeps_int8_pairs(self):
        """dtype casts the floating leaves but never an int8 pair's scale."""
        w = jquant.quantize_weight(jnp.ones((2, 16, 8), jnp.float32))
        jp = {"embed": jnp.ones((4, 16), jnp.float32), "layers": {"wq": w}}
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                             dtype=torch.bfloat16)
        assert tp["embed"].dtype == torch.bfloat16
        assert tp["layers"]["wq"]["q"].dtype == torch.int8
        assert tp["layers"]["wq"]["scale"].dtype == torch.float32
        np.testing.assert_array_equal(tp["layers"]["wq"]["scale"].numpy(),
                                      np.asarray(w["scale"]))

    def test_quantize_params_leaves_the_source_and_norms(self):
        tp = tllama.init_params(tconfigs.TINY, seed=0, device="cpu")
        qp = tquant.quantize_params(tp)
        assert all(tquant.is_quantized(qp["layers"][k]) for k in tquant.QUANT_KEYS)
        assert qp["layers"]["attn_norm"] is tp["layers"]["attn_norm"]
        assert tp["layers"]["wq"].dtype == torch.bfloat16  # the source is untouched
        assert tquant.param_bytes(qp) < tquant.param_bytes(tp)


class TestRaggedMatmul:
    M, K, N = 150, 256, 384

    def _inputs(self, int8, seed=0):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((self.M, self.K)).astype(np.float32)
        if int8:
            wj = {
                "q": jnp.asarray(rng.integers(-127, 128, size=(self.K, self.N)), jnp.int8),
                "scale": jnp.asarray(rng.uniform(0.01, 0.1, size=(1, self.N)), jnp.float32),
            }
        else:
            wj = jnp.asarray(rng.standard_normal((self.K, self.N)) * 0.1, jnp.bfloat16)
        return x, wj

    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    @pytest.mark.parametrize("total", [0, 1, 63, 64, 65, 150])
    def test_plain_matches_pallas_interpret_bf16(self, int8, total):
        x, wj = self._inputs(int8)
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
        want = _np(jax_ragged(xj, wj, jnp.int32(total), bm=BM, interpret=True))
        got = ragged_matmul_plain(xt, _to_torch(wj), torch.tensor(total, dtype=torch.int32))
        assert got.dtype == torch.bfloat16
        end = min(-(-total // BM) * BM, self.M)
        np.testing.assert_allclose(_tnp(got)[:end], want[:end], rtol=1e-2, atol=1e-2)
        assert (_tnp(got)[end:] == 0).all() and (want[end:] == 0).all()

    @pytest.mark.parametrize("total", [0, 65, 150])
    def test_plain_matches_pallas_interpret_f32(self, total):
        """f32 activations and weights: the same product to 1e-5."""
        rng = np.random.default_rng(2)
        x = rng.standard_normal((self.M, self.K)).astype(np.float32)
        w = (rng.standard_normal((self.K, self.N)) * 0.1).astype(np.float32)
        want = _np(jax_ragged(jnp.asarray(x), jnp.asarray(w), jnp.int32(total),
                              bm=BM, interpret=True))
        got = ragged_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            torch.tensor(total, dtype=torch.int32))
        np.testing.assert_allclose(_tnp(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())

    def test_int8_pair_with_f32_activations_computes_in_bf16(self):
        """As in the JAX kernel, x is cast to the int8 pair's compute dtype
        (bf16) and the output takes x's dtype (f32)."""
        x, wj = self._inputs(True, seed=3)
        want = _np(jax_ragged(jnp.asarray(x), wj, jnp.int32(100), bm=BM, interpret=True))
        got = ragged_matmul(torch.from_numpy(x), _to_torch(wj),
                            torch.tensor(100, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_tnp(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())

    def test_cpu_takes_the_plain_version_and_other_devices_raise(self):
        x = torch.ones((4, 16))
        w = torch.ones((16, 8))
        before = ragged_matmul.launches
        ragged_matmul(x, w, torch.tensor(2, dtype=torch.int32))
        assert ragged_matmul.launches == before
        with pytest.raises(ValueError, match="no kernel"):
            ragged_matmul(x.to("meta"), w.to("meta"), torch.empty((), device="meta"))


# Llama-3.1-8B's seven block-decode weights (K, N) on a 132-SM H100.
WEIGHTS_8B = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
              "wo": (4096, 4096), "w_gate": (4096, 14336), "w_up": (4096, 14336),
              "w_down": (14336, 4096)}
H100_SMS = 132
# HBM's bandwidth times its latency (3.35 TB/s x ~1 us): the weight bytes a
# call must keep in flight over the card to stream at full rate.
HBM_IN_FLIGHT_BYTES = 3_350_000


def plan(N, K, int8, rows, sm_count):
    """The grid of a K3 call, the weight bytes it keeps in flight and the
    split workspace it writes and reads back. A working block streams its
    [k_per_split, COLS_PER_BLOCK] slice of the weight through its ring
    (stages of a weight tile [K_STEP, COLS_PER_BLOCK] and the rows' x tile,
    as many as RING_BYTES hold), so it has the smaller of the two in
    flight; a split writes f32 partials of the `rows` active rows."""
    splits, per = k_splits(N, K, sm_count)
    elem = 1 if int8 else 2
    stage = K_STEP * COLS_PER_BLOCK * elem + min(rows, MAX_ROWS) * K_STEP * 2
    ring = min(MAX_STAGES, RING_BYTES // stage) * K_STEP * COLS_PER_BLOCK * elem
    blocks = -(-N // COLS_PER_BLOCK) * splits
    return {"blocks": blocks,
            "in_flight_bytes": blocks * min(min(per, K) * COLS_PER_BLOCK * elem, ring),
            "workspace_bytes": splits * rows * N * 4 if splits > 1 else 0}


class TestSplitPlan:
    @pytest.mark.parametrize("rows", [64, 192])
    @pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
    @pytest.mark.parametrize("name", list(WEIGHTS_8B))
    def test_k_split_fills_the_sms_once(self, name, int8, rows):
        """Every 8B shape gets at least 128 of 132 SMs working (each block
        streams ~20 GB/s, so the time follows the working SMs), or, where N
        has 112 column tiles and no split (w_gate, w_up), keeps more than
        HBM's bandwidth-latency product of weight bytes in flight. The
        workspace of a split holds the active rows only: at most the
        weight's bytes per 64-row tile, and half the 50 MB L2 it stays in."""
        K, N = WEIGHTS_8B[name]
        got = plan(N, K, int8, rows, H100_SMS)
        assert got["blocks"] <= H100_SMS
        assert got["blocks"] >= 128 or got["in_flight_bytes"] >= HBM_IN_FLIGHT_BYTES
        assert got["workspace_bytes"] <= K * N * (1 if int8 else 2) * rows // BM
        assert got["workspace_bytes"] <= 25_000_000

    @pytest.mark.parametrize(
        "n,k", [(14336, 4096), (4096, 4096), (1024, 4096), (4096, 14336),
                (128, 256), (256, 256), (512, 256), (208, 4096), (256, 1000),
                (64, 64), (16, 8)],
    )
    def test_splits_are_whole_k_steps_within_k(self, n, k):
        """Splits are whole K steps, at most MAX_SPLITS, none starts past K,
        and a call never asks for more blocks than a card has SMs unless
        its column tiles alone do."""
        splits, per = k_splits(n, k, H100_SMS)
        assert 1 <= splits <= MAX_SPLITS and per % K_STEP == 0
        assert (splits - 1) * per < max(k, 1) <= splits * per
        tiles = -(-n // COLS_PER_BLOCK)
        assert tiles * splits <= max(H100_SMS, tiles)


class TestKernelTransforms:
    """Plain twins of what the kernel does beyond the product: the column
    order of an int8 weight's A fragments and its inverse in the epilogue,
    the exact int8 -> bf16 convert, and the K split with its fixed-order
    sum, held against ragged_matmul_plain and the Pallas kernel."""

    @staticmethod
    def _fragments(tile):
        """What `ldmatrix.trans` over an int8 [16 k, 16 n] tile viewed as b16
        pairs, then the byte split, hands wgmma: A [16 rows, 16 k], row gq
        from lane (gq, tq)'s even column and row gq + 8 from its odd one."""
        a = np.zeros((16, 16), np.int32)
        for lane in range(32):
            gq, tq = lane // 4, lane % 4
            for half in range(2):  # k rows 0-7, then 8-15 (a0/a1, a2/a3)
                k0 = 8 * half + 2 * tq
                b = [tile[k0, 2 * gq], tile[k0, 2 * gq + 1],
                     tile[k0 + 1, 2 * gq], tile[k0 + 1, 2 * gq + 1]]
                a[gq, k0:k0 + 2] = (b[0], b[2])  # even pair: row gq
                a[gq + 8, k0:k0 + 2] = (b[1], b[3])  # odd pair: row gq + 8
        return a

    def test_fragment_rows_hold_fragment_columns(self):
        rng = np.random.default_rng(0)
        tile = rng.integers(-127, 128, size=(16, 16))
        a = self._fragments(tile)
        cols = fragment_columns(16).numpy()
        np.testing.assert_array_equal(a, tile[:, cols].T)

    def test_epilogue_undoes_the_column_order(self):
        """The kernel writes accumulator row 16w + gq + 8h of a 64-column
        slice to column 16w + 2gq + h: the inverse of fragment_columns."""
        cols = fragment_columns(256).numpy()
        assert sorted(cols) == list(range(256))
        for slice0 in (0, 64, 128, 192):
            for w in range(4):
                for gq in range(8):
                    for h in range(2):
                        row = slice0 + 16 * w + gq + 8 * h
                        assert cols[row] == slice0 + 16 * w + 2 * gq + h

    def test_int8_convert_is_exact(self):
        """f32 bits 0x4B000000 | (q + 128), less 2^23 + 128, is q for every
        int8 q; then bf16 holds it exactly."""
        q = np.arange(-128, 128, dtype=np.int32)
        bits = (0x4B000000 | ((q + 128) & 0xFF)).astype(np.uint32)
        f = bits.view(np.float32) - np.float32(8388736.0)
        np.testing.assert_array_equal(f, q.astype(np.float32))
        back = torch.from_numpy(f).bfloat16().float().numpy()
        np.testing.assert_array_equal(back, f)

    @pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
    @pytest.mark.parametrize("total", [0, 1, 64, 65, 150])
    def test_split_twin_matches_plain_and_pallas(self, int8, total):
        """The twin at the kernel's plan (K split over blocks, partials
        summed in split order, column order undone) against the plain
        version and the Pallas kernel in interpret mode: one bf16 rounding
        apart; rows past the computed tiles exactly zero."""
        M, K, N = 150, 1000, 208
        rng = np.random.default_rng(4)
        xj = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
        if int8:
            wj = {"q": jnp.asarray(rng.integers(-127, 128, size=(K, N)), jnp.int8),
                  "scale": jnp.asarray(rng.uniform(0.001, 0.01, size=(1, N)), jnp.float32)}
        else:
            wj = jnp.asarray(rng.standard_normal((K, N)) * 0.03, jnp.bfloat16)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
        wt = _to_torch(wj)
        t = torch.tensor(total, dtype=torch.int32)
        splits, per = k_splits(N, K, H100_SMS)
        assert splits > 1
        got = combine_parts_plain(split_parts_plain(xt, wt, t, splits, per), wt, t)
        want = ragged_matmul_plain(xt, wt, t)
        pallas = _np(jax_ragged(xj, wj, jnp.int32(total), bm=BM, interpret=True))
        end = min(-(-total // BM) * BM, M)
        np.testing.assert_allclose(_tnp(got)[:end], _tnp(want)[:end], rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(_tnp(got)[:end], pallas[:end], rtol=1e-2, atol=1e-2)
        assert (_tnp(got)[end:] == 0).all()


class TestSmokeComparison:
    """chip_smoke.py holds K3 against its plain version by the largest error
    and the error's RMS relative to the reference's RMS, and the zero rows
    exactly. On the CPU the same comparison must pass an exact copy,
    outputs one bf16 ulp off in places and the kernel's own transforms done
    right (the split twin), and refuse a dropped K step, a missing scale, a
    zero tail one tile short, one row of garbage, and the kernel's
    transforms done wrong: the column order not undone, each column scaled
    by its fragment row's neighbour, one K split dropped."""

    @staticmethod
    def _smoke():
        import importlib.util
        from pathlib import Path

        path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    @pytest.mark.parametrize("mutation", [
        "none", "ulp_in_places", "split_twin", "k_step_dropped", "scale_missing",
        "tail_short", "garbage_row", "order_not_undone", "scale_wrong_column",
        "split_dropped",
    ])
    def test_comparison_refuses_broken_kernels(self, mutation):
        cs = self._smoke()
        g = torch.Generator().manual_seed(0)
        M, K, N, total = 192, 4096, 256, 70
        x = torch.randn((M, K), generator=g).bfloat16()
        w = tquant.quantize_weight((torch.randn((K, N), generator=g) * K**-0.5).bfloat16())
        t = torch.tensor(total, dtype=torch.int32)
        want = ragged_matmul_plain(x, w, t)
        cut = {"q": w["q"].clone(), "scale": w["scale"]}
        cut["q"][:32] = 0  # one 32-wide K step missing
        splits, per = k_splits(N, K, 132)
        parts = split_parts_plain(x, w, t, splits, per)
        cols = fragment_columns(N)
        rows = torch.arange(M) < 128  # the computed tiles at total 70

        def epilogue(acc, scale_rows, undo=True):
            acc = acc * scale_rows[:, None]
            if undo:
                acc = torch.empty_like(acc).index_copy_(0, cols, acc)
            return torch.where(rows[:, None], acc.t(), 0.0).bfloat16()

        scale = w["scale"].reshape(-1)
        got = {
            "none": lambda: want,
            "ulp_in_places": lambda: torch.where(  # every 16th element rounds up
                torch.arange(M * N).reshape(M, N) % 16 == 0,
                (want.float() * (1 + 2**-7)).bfloat16(), want,
            ),
            "k_step_dropped": lambda: ragged_matmul_plain(x, cut, t),
            "scale_missing": lambda: ragged_matmul_plain(x, w["q"].bfloat16(), t),
            "tail_short": lambda: ragged_matmul_plain(x, w, t + 64),
            "garbage_row": lambda: torch.cat([want[:5], want[5:6] * 3, want[6:]]),
            "split_twin": lambda: combine_parts_plain(parts, w, t),
            "order_not_undone": lambda: epilogue(parts.sum(0), scale[cols], undo=False),
            "scale_wrong_column": lambda: epilogue(parts.sum(0), scale),
            "split_dropped": lambda: combine_parts_plain(parts[1:], w, t),
        }[mutation]()
        ok, _ = cs._compare_k3(got, want, total)
        assert ok == (mutation in ("none", "ulp_in_places", "split_twin"))


def _ragged_case(dtype, seed=0):
    """tests/test_ragged_matmul.py's block-decode case, as numpy inputs."""
    jcfg = jconfigs.LlamaConfig(
        name="ragged-test", vocab_size=512, d_model=128, n_layers=2,
        n_heads=4, n_kv_heads=2, d_ff=256, max_seq_len=2048,
        rope_theta=10000.0, dtype=jnp.float32, tie_embeddings=True,
    )
    tcfg = tconfigs.LlamaConfig(
        name="ragged-test", vocab_size=512, d_model=128, n_layers=2,
        n_heads=4, n_kv_heads=2, d_ff=256, max_seq_len=2048,
        rope_theta=10000.0, dtype=torch.float32, tie_embeddings=True,
    )
    jp = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    if dtype == "int8":
        jp = jquant.quantize_params(jp)
    rng = np.random.default_rng(seed)
    R, F, Ss, cap, Sp = 4, 8, 16, 24, 32
    L, kv, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    blk_len = np.asarray([5, 1, 8, 0], np.int32)
    blk_valid = np.arange(F)[None, :] < blk_len[:, None]
    blk_tok = (rng.integers(1, 256, size=(R, F)) * blk_valid).astype(np.int32)
    suffix_lens = np.asarray([10, 16, 3, 7], np.int32)
    tail = np.asarray([2, 0, 5, 9], np.int32)
    positions = (Sp + suffix_lens[:, None] + tail[:, None]
                 + np.arange(F)[None, :]).astype(np.int32)

    def t(*shape):
        return (rng.normal(size=shape) * 0.1).astype(np.float32)

    args = (blk_tok, blk_valid, blk_len, positions, t(L, R, Ss, kv, hd),
            t(L, R, Ss, kv, hd), suffix_lens, t(L, R, cap + 1, kv, hd),
            t(L, R, cap + 1, kv, hd), tail, t(L, Sp, kv, hd), t(L, Sp, kv, hd))
    return jcfg, tcfg, jp, args, Sp


class TestRaggedBlockDecode:
    @pytest.mark.parametrize("dtype", ["f32", "int8"])
    def test_matches_jax_ragged(self, dtype):
        """Logits at every live row and every exposed generated-KV entry."""
        jcfg, tcfg, jp, args, Sp = _ragged_case(dtype)
        lj, gkj, gvj = jllama.forward_block_decode(
            jp, jcfg, *map(jnp.asarray, args), jnp.int32(Sp), ragged=True
        )
        lt, gkt, gvt = tllama.forward_block_decode(
            _to_torch(jp), tcfg, *(torch.from_numpy(np.array(a)) for a in args),
            torch.tensor(Sp, dtype=torch.int32), ragged=True,
        )
        tol = F32 if dtype == "f32" else INT8_F32
        blk_len, tail = args[2], args[9]
        live = blk_len > 0
        np.testing.assert_allclose(_tnp(lt)[live], _np(lj)[live], **tol)
        for r in range(len(tail)):
            hi = tail[r] + blk_len[r]
            np.testing.assert_allclose(_tnp(gkt[:, r, :hi]), _np(gkj[:, r, :hi]), **tol)
            np.testing.assert_allclose(_tnp(gvt[:, r, :hi]), _np(gvj[:, r, :hi]), **tol)

    def test_ragged_matches_dense_in_the_port(self):
        _, tcfg, jp, args, Sp = _ragged_case("f32", seed=1)
        tp = _to_torch(jp)

        def run(ragged):
            return tllama.forward_block_decode(
                tp, tcfg, *(torch.from_numpy(np.array(a)) for a in args),
                torch.tensor(Sp, dtype=torch.int32), ragged=ragged,
            )

        (ld, _, _), (lr, _, _) = run(False), run(True)
        live = args[2] > 0
        np.testing.assert_allclose(_tnp(lr)[live], _tnp(ld)[live], **F32)


def test_int8_ragged_wave_tokens_match_jax():
    """TINY in f32 with int8 weights, grammar-constrained, greedy: one wave
    of three pods through ragged block decode gives the JAX engine's
    tokens (and the same number of model calls)."""
    jcfg = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.TINY, dtype=torch.float32)
    jp = jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(0), jcfg))
    tp = _to_torch(jp)
    jtok, ttok = JByteTokenizer(), ByteTokenizer()
    pe = tprompt.PromptEngine()
    cluster = pe.cluster_part(ttesting.synthetic_nodes(3))
    prompts = [
        ttok.chat_prompt_parts(pe.system_prompt, cluster, tprompt.pod_suffix(p))
        for p in ttesting.fixture_pods(3)
    ]
    prefix, suffixes = prompts[0][0], [s for _, s in prompts]
    names = [f"node-{i}" for i in range(3)]
    common = dict(max_slots=4, prefill_buckets=(128, 256, 1024), temperature=0.0,
                  decode_matmul="ragged")

    jeng = JEngine(jp, jcfg, jtok, num_pages=16, page_size=64, max_pages_per_seq=8,
                   **common)
    jeng.set_prefix(prefix)
    jeng.set_grammar(jconstrained.build_decision_dfa(jtok, names, max_reason_tokens=8))
    want = jeng.decide_wave(suffixes, max_new_tokens=80)

    teng = TEngine(tp, tcfg, ttok, num_pages=16, **common)
    teng.set_prefix(prefix)
    teng.set_grammar(tconstrained.build_decision_dfa(ttok, names, max_reason_tokens=8))
    got = teng.decide_wave(suffixes, max_new_tokens=80)

    assert [f.token_ids for f in got] == [f.token_ids for f in want]
    assert teng.stats["wave_model_calls"] == jeng.stats["wave_model_calls"]
    assert len(teng.block_tokens) == teng.stats["wave_model_calls"]
    assert 0 < min(teng.block_tokens) and max(teng.block_tokens) <= 4 * teng.wave_block
