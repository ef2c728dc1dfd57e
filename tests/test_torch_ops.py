"""The port's attention ops and the plain twins of its CUDA kernels, held
against the JAX package on the CPU.

K1 (shared-prefix flash partials) and K2 (causal in-chunk flash partials)
run on the CPU through their plain PyTorch versions; those are compared with
the JAX Pallas kernels in interpret mode (bf16 operands, as the kernels take
them) and with the JAX einsum path (f32). The CUDA kernels themselves are
held against these plain versions on the card by chip_smoke.py.

Tolerances: 2e-5 where both sides compute in f32 (only the order of the
sums differs); 2e-2 in bf16, where the two sides may round a probability to
a neighbouring bf16 value before the product with V.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu.ops import attention as jA
from k8s_llm_scheduler_tpu.ops.pallas_prefix_attention import (
    flash_causal_attention_parts as jax_flash_causal,
    flash_prefix_attention_parts as jax_flash_prefix,
)
from k8s_llm_scheduler_tpu_torch.ops import attention as tA
from k8s_llm_scheduler_tpu_torch.ops import kernels
from k8s_llm_scheduler_tpu_torch.ops.paged_attention import (
    merge_paged_splits_plain,
    paged_attention_parts_plain,
    split_paged_parts_plain,
)
from k8s_llm_scheduler_tpu_torch.ops.prefix_attention import (
    NEG_INF,
    _masked_parts,
    causal_attention_parts_plain,
    combine_splits_plain,
    flash_causal_attention_parts,
    flash_prefix_attention_parts,
    prefix_attention_parts_plain,
    split_prefix_parts_plain,
)

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _bf16_pair(a):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, dtype=jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _np(x):
    return np.array(x, dtype=np.float32)


def _tnp(x):
    return x.float().numpy()


class TestPrefixParts:
    B, S, H, NKV, HD, SP = 2, 16, 4, 2, 64, 256

    def _inputs(self, seed):
        rng = np.random.default_rng(seed)
        q = _normal(rng, (self.B, self.S, self.H, self.HD))
        pk = _normal(rng, (self.SP, self.NKV, self.HD))
        pv = _normal(rng, (self.SP, self.NKV, self.HD))
        return q, pk, pv

    @pytest.mark.parametrize("plen", [0, 1, 130, 256])
    def test_plain_matches_pallas_interpret_bf16(self, plen):
        q, pk, pv = self._inputs(0)
        (qj, qt), (kj, kt), (vj, vt) = _bf16_pair(q), _bf16_pair(pk), _bf16_pair(pv)
        o_j, m_j, l_j = jax_flash_prefix(qj, kj, vj, jnp.int32(plen), interpret=True)
        o_t, m_t, l_t = prefix_attention_parts_plain(
            qt, kt, vt, torch.tensor(plen, dtype=torch.int32)
        )
        np.testing.assert_allclose(_tnp(m_t), _np(m_j), **BF16)
        np.testing.assert_allclose(_tnp(l_t), _np(l_j), **BF16)
        np.testing.assert_allclose(_tnp(o_t), _np(o_j), **BF16)
        if plen == 0:
            assert (m_t == NEG_INF).all() and (l_t == 0).all() and (o_t == 0).all()

    @pytest.mark.parametrize("plen", [0, 1, 130, 256])
    def test_plain_matches_xla_f32(self, plen):
        q, pk, pv = self._inputs(1)
        qj = jnp.asarray(q)
        qg = (qj * self.HD**-0.5).reshape(self.B, self.S, self.NKV, -1, self.HD)
        o_j, m_j, l_j = jA.prefix_attend_parts(
            qj, qg, jnp.asarray(pk), jnp.asarray(pv), jnp.int32(plen), impl="xla"
        )
        o_t, m_t, l_t = flash_prefix_attention_parts(
            torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
            torch.tensor(plen, dtype=torch.int32),
        )
        np.testing.assert_allclose(_tnp(m_t), _np(m_j), **F32)
        if plen == 0:
            # the einsum path leaves exp(0) = 1 in masked probabilities; both
            # report zero weight through m = NEG_INF
            return
        np.testing.assert_allclose(_tnp(l_t), _np(l_j), **F32)
        np.testing.assert_allclose(_tnp(o_t), _np(o_j), **F32)


class TestCausalParts:
    B, S, H, NKV, HD = 2, 128, 4, 2, 64

    def _inputs(self, seed):
        rng = np.random.default_rng(seed)
        q = _normal(rng, (self.B, self.S, self.H, self.HD))
        k = _normal(rng, (self.B, self.S, self.NKV, self.HD))
        v = _normal(rng, (self.B, self.S, self.NKV, self.HD))
        return q, k, v

    @pytest.mark.parametrize("lens", [(128, 0), (65, 1), (40, 128)])
    def test_plain_matches_pallas_interpret_bf16(self, lens):
        q, k, v = self._inputs(2)
        (qj, qt), (kj, kt), (vj, vt) = _bf16_pair(q), _bf16_pair(k), _bf16_pair(v)
        lens_np = np.asarray(lens, dtype=np.int32)
        o_j, m_j, l_j = jax_flash_causal(qj, kj, vj, jnp.asarray(lens_np), interpret=True)
        o_t, m_t, l_t = causal_attention_parts_plain(qt, kt, vt, torch.from_numpy(lens_np))
        np.testing.assert_allclose(_tnp(m_t), _np(m_j), **BF16)
        np.testing.assert_allclose(_tnp(l_t), _np(l_j), **BF16)
        np.testing.assert_allclose(_tnp(o_t), _np(o_j), **BF16)
        for b, n in enumerate(lens):
            if n == 0:
                assert (m_t[b] == NEG_INF).all() and (l_t[b] == 0).all()

    @pytest.mark.parametrize("lens", [(128, 0), (65, 1)])
    def test_plain_matches_xla_f32(self, lens):
        q, k, v = self._inputs(3)
        lens_np = np.asarray(lens, dtype=np.int32)
        qj = jnp.asarray(q)
        qg = (qj * self.HD**-0.5).reshape(self.B, self.S, self.NKV, -1, self.HD)
        o_j, m_j, l_j = jA.causal_chunk_attend_parts(
            qj, qg, jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens_np), impl="xla"
        )
        o_t, m_t, l_t = flash_causal_attention_parts(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(lens_np),
        )
        np.testing.assert_allclose(_tnp(m_t), _np(m_j), **F32)
        for b, n in enumerate(lens):
            if n == 0:  # no valid key: only m is defined on the einsum path
                continue
            np.testing.assert_allclose(_tnp(l_t[b]), _np(l_j[b]), **F32)
            np.testing.assert_allclose(_tnp(o_t[b]), _np(o_j[b]), **F32)


class TestCascade:
    def test_chunk_attention_with_prefix_matches_xla_f32(self):
        rng = np.random.default_rng(4)
        B, S, H, NKV, HD, SP = 2, 32, 4, 2, 64, 96
        q = _normal(rng, (B, S, H, HD))
        kc, vc = _normal(rng, (B, S, NKV, HD)), _normal(rng, (B, S, NKV, HD))
        pk, pv = _normal(rng, (SP, NKV, HD)), _normal(rng, (SP, NKV, HD))
        lens = np.asarray([S, S - 5], dtype=np.int32)
        ref = jA.chunk_attention_with_prefix(
            *map(jnp.asarray, (q, kc, vc, lens, pk, pv)), jnp.int32(70),
            prefix_impl="xla",
        )
        got = tA.chunk_attention_with_prefix(
            *map(torch.from_numpy, (q, kc, vc, lens, pk, pv)),
            torch.tensor(70, dtype=torch.int32),
        )
        np.testing.assert_allclose(_tnp(got), _np(ref), **F32)

    def test_causal_prefill_attention_matches_xla_f32(self):
        rng = np.random.default_rng(5)
        B, S, H, NKV, HD = 2, 24, 4, 2, 64
        q, k, v = _normal(rng, (B, S, H, HD)), _normal(rng, (B, S, NKV, HD)), _normal(
            rng, (B, S, NKV, HD)
        )
        lens = np.asarray([S, 7], dtype=np.int32)
        ref = jA.causal_prefill_attention(*map(jnp.asarray, (q, k, v, lens)))
        got = tA.causal_prefill_attention(*map(torch.from_numpy, (q, k, v, lens)))
        np.testing.assert_allclose(_tnp(got), _np(ref), **F32)

    def test_merge_of_attend_parts_matches_jax(self):
        """Block-decode cascade parts from attend_part (a row's suffix and
        its generated tokens, one of them empty) merge to the JAX result."""
        rng = np.random.default_rng(6)
        R, Fw, H, NKV, HD, SS, CAP = 2, 6, 4, 2, 64, 10, 9
        q = _normal(rng, (R, Fw, H, HD))
        qg = (q * HD**-0.5).reshape(R, Fw, NKV, H // NKV, HD)
        ks, vs = _normal(rng, (R, SS, NKV, HD)), _normal(rng, (R, SS, NKV, HD))
        gk, gv = _normal(rng, (R, CAP, NKV, HD)), _normal(rng, (R, CAP, NKV, HD))
        sfx = (np.arange(SS)[None, :] < np.array([[SS], [4]]))[:, None, None, None, :]
        gen = (np.arange(CAP)[None, :] < np.array([[0], [3]]))[:, None, None, None, :]
        eq = "bqkgh,bskh->bkgqs"

        def parts(A, cvt):
            return [
                A.attend_part(cvt(qg), cvt(ks), cvt(vs), cvt(sfx), eq),
                A.attend_part(cvt(qg), cvt(gk), cvt(gv), cvt(gen), eq),
            ]

        ref = jA.merge_attention_parts(parts(jA, jnp.asarray))
        got = tA.merge_attention_parts(parts(tA, torch.from_numpy))
        np.testing.assert_allclose(_tnp(got), _np(ref), **F32)


class TestKernelWrappers:
    def test_cpu_tensors_take_the_plain_version(self):
        rng = np.random.default_rng(7)
        q = torch.from_numpy(_normal(rng, (1, 8, 4, 64)))
        pk = torch.from_numpy(_normal(rng, (40, 2, 64)))
        plen = torch.tensor(33, dtype=torch.int32)
        before = flash_prefix_attention_parts.launches
        got = flash_prefix_attention_parts(q, pk, pk, plen)
        want = prefix_attention_parts_plain(q, pk, pk, plen)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        lens = torch.tensor([8], dtype=torch.int32)
        k = torch.from_numpy(_normal(rng, (1, 8, 2, 64)))
        flash_causal_attention_parts(q, k, k, lens)
        assert flash_prefix_attention_parts.launches == before  # no kernel ran

    def test_device_without_a_kernel_raises(self):
        """No silent fallback: a non-CPU tensor the kernels cannot take
        raises instead of computing the plain version."""
        q = torch.empty((1, 8, 4, 64), device="meta")
        pk = torch.empty((40, 2, 64), device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            flash_prefix_attention_parts(q, pk, pk, torch.empty((), device="meta"))
        with pytest.raises(ValueError, match="no kernel"):
            flash_causal_attention_parts(q, pk, pk, torch.empty((1,), device="meta"))

    def test_library_names_track_the_sources(self):
        """Each kernel builds into its own library whose name hashes the
        sources, so an edited kernel is never loaded stale."""
        paths = {kernels._lib_path(name) for name in kernels.SOURCES}
        assert len(paths) == len(kernels.SOURCES)
        assert all(p.parent == kernels.BUILD_DIR for p in paths)
        assert all((kernels.CSRC / f"{n}.cu").exists() for n in kernels.SOURCES)


class TestSmokeComparison:
    """chip_smoke.py holds each CUDA kernel against its plain version with
    peaked queries and tolerances a few times the kernels' own error. Here
    the same comparison, on the CPU, must pass an exact copy and refuse
    outputs of a broken kernel: a mask off by one key, a dropped key tile,
    a P.V product 10% off, V rounded to fp8, and of a broken key split: a
    middle split's keys missing, splits folded without e^(m_s - m). For K2,
    outputs of a broken causal walk: the diagonal one key off, every row of
    a 128-row block given the block's last row's limit, each row's last
    partial key tile dropped, batch row b given lens[b - 1]. For K4 (its
    comparison, `_k4_compare`, in both modes), outputs of a broken split
    merge or page walk: a split dropped, splits folded without
    e^(m_s - m), a page one off in the table, the last partial page's mask
    one key off, sequence b given lens[b - 1], and the trash row's partials
    not exactly (-1e30, 0, 0)."""

    @staticmethod
    def _smoke():
        import importlib.util
        from pathlib import Path

        path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    SPLIT_KEYS = 256  # four splits of the 1,024-key buffer; PLEN ends in the third

    def _split_dropped(self, q, k, v, plen):
        o, m, l = split_prefix_parts_plain(q, k, v, plen, 4, self.SPLIT_KEYS)
        o[1], m[1], l[1] = 0.0, NEG_INF, 0.0  # split 1 never ran
        return combine_splits_plain(o, m, l)

    def _split_not_rescaled(self, q, k, v, plen):
        o, m, l = split_prefix_parts_plain(q, k, v, plen, 4, self.SPLIT_KEYS)
        return o.sum(dim=0), m.amax(dim=0), l.sum(dim=0)

    @pytest.mark.parametrize(
        "mutation",
        ["none", "mask_plus_one", "tile_dropped", "pv_scaled", "v_fp8",
         "split_dropped", "split_not_rescaled"],
    )
    def test_comparison_refuses_broken_kernels(self, mutation):
        cs = self._smoke()
        g = torch.Generator().manual_seed(0)
        B, S, H, NKV, HD, SP, PLEN = 2, 64, 8, 2, 128, 1024, 700
        q = (cs.Q_SCALE * torch.randn((B, S, H, HD), generator=g)).bfloat16()
        k = torch.randn((SP, NKV, HD), generator=g).bfloat16()
        v = torch.randn((SP, NKV, HD), generator=g).bfloat16()
        plen = torch.tensor(PLEN, dtype=torch.int32)
        want = prefix_attention_parts_plain(q, k, v, plen)
        got = {
            "none": lambda: want,
            "mask_plus_one": lambda: prefix_attention_parts_plain(q, k, v, plen + 1),
            "tile_dropped": lambda: prefix_attention_parts_plain(
                q, k, v, plen - PLEN % 64
            ),
            "pv_scaled": lambda: (want[0] * 0.9, want[1], want[2]),
            "v_fp8": lambda: prefix_attention_parts_plain(
                q, k, v.to(torch.float8_e4m3fn).bfloat16(), plen
            ),
            "split_dropped": lambda: self._split_dropped(q, k, v, plen),
            "split_not_rescaled": lambda: self._split_not_rescaled(q, k, v, plen),
        }[mutation]()
        ok, _ = cs._compare(got, want, torch.ones(want[1].shape, dtype=torch.bool))
        assert ok == (mutation == "none")

    @staticmethod
    def _causal_with_limits(q, k, v, limit):
        """K2's plain arithmetic with an explicit key limit per query row
        (limit [B, g, S]: row s of group member gi sees keys j < limit)."""
        B, S, H, hd = q.shape
        n_kv = k.shape[2]
        g = H // n_kv
        qs = (q.float() * hd**-0.5).to(k.dtype).float().reshape(B, S, n_kv, g, hd)
        logits = torch.einsum("bqkgh,bskh->bkgqs", qs, k.float())
        mask = torch.arange(S)[None, None, None, None, :] < limit[:, None, :, :, None]
        return _masked_parts(logits, mask, v, "bkgqs,bskh->bkgqh")

    @pytest.mark.parametrize(
        "mutation",
        ["none", "diagonal_plus_one", "block_last_limit", "last_partial_tile_dropped",
         "previous_batch_len"],
    )
    def test_comparison_refuses_broken_causal_kernels(self, mutation):
        cs = self._smoke()
        gen = torch.Generator().manual_seed(1)
        B, S, H, NKV, HD = 2, 300, 8, 2, 128
        lens = torch.tensor([300, 130], dtype=torch.int32)
        G = H // NKV
        q = (cs.Q_SCALE * torch.randn((B, S, H, HD), generator=gen)).bfloat16()
        k = torch.randn((B, S, NKV, HD), generator=gen).bfloat16()
        v = torch.randn((B, S, NKV, HD), generator=gen).bfloat16()
        want = causal_attention_parts_plain(q, k, v, lens)
        row = torch.arange(S)[None, :] * G + torch.arange(G)[:, None]  # [g, S]
        s_pos = row // G
        block_last = torch.clamp((row // 128) * 128 + 127, max=S * G - 1) // G
        n = lens[:, None, None]
        limit = {
            "none": torch.minimum(n, s_pos + 1),
            "diagonal_plus_one": torch.minimum(n, s_pos + 2),
            "block_last_limit": torch.minimum(n, block_last + 1),
            "last_partial_tile_dropped": torch.minimum(n, s_pos + 1) // 128 * 128,
            "previous_batch_len": torch.minimum(torch.roll(lens, 1)[:, None, None],
                                                s_pos + 1),
        }[mutation]
        got = self._causal_with_limits(q, k, v, limit)
        valid = (lens > 0)[:, None, None, None].expand(want[1].shape)
        ok, _ = cs._compare(got, want, valid)
        assert ok == (mutation == "none")


    # K4: a sequence of 63 pages of 16 (three splits of 21), two of one
    # split with partial last pages, and the trash row
    K4_LENS = (1000, 77, 45, -300)
    K4_SPLITS = 3

    def _k4_inputs(self, cs):
        gen = torch.Generator().manual_seed(4)
        B, H, NKV, HD, PAGES, PS, P = len(self.K4_LENS), 8, 2, 128, 300, 16, 64
        q = (cs.Q_SCALE * torch.randn((B, H, HD), generator=gen)).bfloat16()
        k = torch.randn((PAGES, PS, NKV, HD), generator=gen).bfloat16()
        v = torch.randn((PAGES, PS, NKV, HD), generator=gen).bfloat16()
        table = torch.randperm(PAGES, generator=gen)[:B * P].reshape(B, P).to(torch.int32)
        return q, k, v, table, torch.tensor(self.K4_LENS, dtype=torch.int32)

    def _k4_broken(self, mutation, q, k, v, table, lens):
        """The (o, m, l) partials a broken K4 would give."""
        split = split_paged_parts_plain(q, k, v, table, lens, self.K4_SPLITS)
        if mutation == "none":
            return merge_paged_splits_plain(*split)
        if mutation == "split_dropped":
            o, m, l = (t.clone() for t in split)
            o[1], m[1], l[1] = 0.0, NEG_INF, 0.0  # split 1 never ran
            return merge_paged_splits_plain(o, m, l)
        if mutation == "split_not_rescaled":
            o, m, l = split
            return o.sum(dim=0), m.amax(dim=0), l.sum(dim=0)
        if mutation == "page_one_off":
            bad = table.clone()
            bad[0, 5] = (bad[0, 5] + 1) % k.shape[0]
            return paged_attention_parts_plain(q, k, v, bad, lens)
        if mutation == "last_page_mask_plus_one":
            return paged_attention_parts_plain(q, k, v, table, torch.where(lens > 0, lens + 1, lens))
        if mutation == "previous_batch_len":
            return paged_attention_parts_plain(q, k, v, table, torch.roll(lens, 1))
        # the trash row as a kernel that gave its one masked key weight
        # exp(-1e30 - -1e30) = 1 would leave it
        o, m, l = (t.clone() for t in paged_attention_parts_plain(q, k, v, table, lens))
        l[-1] = 1.0
        o[-1] = v[table[-1, 0], 0].float()[:, None, :]  # [n_kv, g, hd]
        return o, m, l

    @pytest.mark.parametrize("mode", ["parts", "normalized"])
    @pytest.mark.parametrize(
        "mutation",
        ["none", "split_dropped", "split_not_rescaled", "page_one_off",
         "last_page_mask_plus_one", "previous_batch_len", "trash_row_not_empty"],
    )
    def test_comparison_refuses_broken_paged_kernels(self, mutation, mode):
        cs = self._smoke()
        q, k, v, table, lens = self._k4_inputs(cs)
        want = paged_attention_parts_plain(q, k, v, table, lens)
        got = self._k4_broken(mutation, q, k, v, table, lens)
        if mode == "normalized":
            def norm(parts):
                o, _, l = parts
                return (o / l.clamp(min=1e-30)[..., None]).reshape(q.shape).bfloat16()
            got, want = norm(got), norm(want)
        ok, _ = cs._k4_compare(got, want, lens, mode == "normalized")
        assert ok == (mutation == "none")


class TestSmokeStepLaunches:
    """chip_smoke.py counts K1's launches by step of the decision path
    (prefix chunks, suffix prefills, block decodes) around the engine's
    model calls. On the CPU the wrapper launches no kernel, so here K1's
    call sites add one to its count per call: the steps must add up to the
    total, one launch per layer of each model call, and the engine must be
    left unwrapped."""

    def test_steps_add_up_to_the_total(self, monkeypatch):
        from k8s_llm_scheduler_tpu_torch.engine import engine as eng_mod
        from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
        from k8s_llm_scheduler_tpu_torch.models import llama
        from k8s_llm_scheduler_tpu_torch.ops import attention, prefix_attention
        from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes

        def counting(fn):
            def call(*args):
                fn.launches += 1
                return fn(*args)
            return call

        for mod in (llama, attention):
            monkeypatch.setattr(mod, "flash_prefix_attention_parts",
                                counting(flash_prefix_attention_parts))
        cs = TestSmokeComparison._smoke()
        originals = (eng_mod.forward_prefill_suffix_dense, eng_mod.forward_block_decode)
        backend = build_local_backend("tiny", device="cpu")
        try:
            eng = backend.engine
            eng.prefix_chunk = 256  # the 4-node prefix takes the chunked prefill
            nodes = synthetic_nodes(4)
            n_prefix = len(backend._prepare_item(fixture_pods(1)[0], nodes).prefix_ids)
            with cs.k1_launches_by_step(eng) as by_step:
                cs._zero_launch_counts()
                backend.get_scheduling_decision(fixture_pods(1)[0], nodes)
                total = cs._launch_counts()["K1"]
            stats = backend.get_stats()
        finally:
            backend.close()
            prefix_attention.reset_launch_counts()
        L = eng.cfg.n_layers
        R = eng.max_slots // 2  # a single decision's wave
        assert by_step == {
            "prefix chunk": -(-n_prefix // 256) * L,
            f"suffix prefill R={R}": stats["waves"] * L,
            f"block decode R={R}": stats["wave_model_calls"] * L,
        }
        assert sum(by_step.values()) == total > 0
        assert (eng_mod.forward_prefill_suffix_dense, eng_mod.forward_block_decode) == originals
        assert "_prefill_prefix_chunked" not in vars(eng)
