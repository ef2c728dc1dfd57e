"""K2 (causal in-chunk flash partials) on the CPU.

K2's plain PyTorch version is held against the JAX package: against the
Pallas kernel in interpret mode where it runs (S a multiple of 128), in
bf16 as the kernels take their operands, and against the XLA einsum path
in f32 where it does not (S = 37, 136, 300), at GQA groups g = 1, 2, 4, 8,
head dims 64 and 128, and lengths 0, 1, S, past S and negative.

The CUDA kernel's block plan (csrc/causal_attention.cu) has a host twin,
`causal_block_plan`: its launch order must be a permutation of all blocks,
each batch row's heaviest first; every (row, key) the causal mask admits must lie in a tile
its block walks, and no walked tile may start at or past the block's
limit; tiles below a warpgroup's first masked tile must need no mask. A
flash loop over the plan, in f32, must then give the plain version's
partials. chip_smoke.py holds the kernel itself against the plain version
on the card.

Tolerances: 2e-5 where both sides compute in f32 (only the order of the
sums differs); 3e-2 in bf16, where the two sides may round a probability
to a neighbouring bf16 value before the product with V.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu.ops import attention as jA
from k8s_llm_scheduler_tpu.ops.pallas_prefix_attention import (
    flash_causal_attention_parts as jax_flash_causal,
)
from k8s_llm_scheduler_tpu_torch.ops.prefix_attention import (
    KEYS_PER_TILE,
    NEG_INF,
    ROWS_PER_BLOCK,
    ROWS_PER_WARPGROUP,
    causal_attention_parts_plain,
    causal_block_plan,
    flash_causal_attention_parts,
)
from k8s_llm_scheduler_tpu_torch.testing import cap_torch_threads

cap_torch_threads()

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
GROUPS = [1, 2, 4, 8]
HEAD_DIMS = [64, 128]


def _inputs(seed, B, S, H, n_kv, hd):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((B, S, H, hd), (B, S, n_kv, hd), (B, S, n_kv, hd))
    )


def _bf16_pair(a):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, dtype=jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _np(x):
    return np.array(x, dtype=np.float32)


def _tnp(x):
    return x.float().numpy()


class TestPlainAgainstJax:
    @pytest.mark.parametrize("hd", HEAD_DIMS)
    @pytest.mark.parametrize("g", GROUPS)
    @pytest.mark.parametrize("lens", [(128, 0, 1, 140, -3), (65, 127, 2, 129, 64)])
    def test_plain_matches_pallas_interpret_bf16(self, lens, g, hd):
        B, S, n_kv = len(lens), 128, 1
        q, k, v = _inputs(g * hd, B, S, g * n_kv, n_kv, hd)
        (qj, qt), (kj, kt), (vj, vt) = _bf16_pair(q), _bf16_pair(k), _bf16_pair(v)
        lens_np = np.asarray(lens, dtype=np.int32)
        o_j, m_j, l_j = jax_flash_causal(qj, kj, vj, jnp.asarray(lens_np), interpret=True)
        o_t, m_t, l_t = causal_attention_parts_plain(qt, kt, vt, torch.from_numpy(lens_np))
        np.testing.assert_allclose(_tnp(m_t), _np(m_j), **BF16)
        np.testing.assert_allclose(_tnp(l_t), _np(l_j), **BF16)
        np.testing.assert_allclose(_tnp(o_t), _np(o_j), **BF16)
        for b, n in enumerate(lens):
            if n <= 0:
                assert (m_t[b] == NEG_INF).all() and (l_t[b] == 0).all()
                assert (o_t[b] == 0).all()

    @pytest.mark.parametrize("hd", HEAD_DIMS)
    @pytest.mark.parametrize("g", GROUPS)
    @pytest.mark.parametrize("S", [37, 136, 300])
    def test_plain_matches_xla_f32(self, S, g, hd):
        lens = (S, 0, 1, S + 9, -2, S // 2 + 1)
        B, n_kv = len(lens), 2
        q, k, v = _inputs(S + g + hd, B, S, g * n_kv, n_kv, hd)
        lens_np = np.asarray(lens, dtype=np.int32)
        qj = jnp.asarray(q)
        qg = (qj * hd**-0.5).reshape(B, S, n_kv, g, hd)
        o_j, m_j, l_j = jA.causal_chunk_attend_parts(
            qj, qg, jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens_np), impl="xla"
        )
        o_t, m_t, l_t = flash_causal_attention_parts(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(lens_np),
        )
        np.testing.assert_allclose(_tnp(m_t), _np(m_j), **F32)
        for b, n in enumerate(lens):
            if n <= 0:  # no valid key: only m is defined on the einsum path
                assert (l_t[b] == 0).all() and (o_t[b] == 0).all()
                continue
            np.testing.assert_allclose(_tnp(l_t[b]), _np(l_j[b]), **F32)
            np.testing.assert_allclose(_tnp(o_t[b]), _np(o_j[b]), **F32)


# (S, g, B, lens, n_kv): the 8B path's prefix chunks and suffix prefills,
# chip_smoke.py's K2 edge cases, and g = 3, whose blocks straddle key tiles
PLAN_CASES = [
    (2048, 4, 1, (2048,), 8),
    (2048, 4, 1, (1392,), 8),
    (256, 4, 4, (226, 0, 0, 0), 8),
    (256, 4, 8, (226, 228, 226, 231, 230, 230, 229, 228), 8),
    (37, 2, 2, (37, 0), 2),
    (300, 4, 3, (300, 129, 1), 8),
    (520, 8, 1, (520,), 8),
    (300, 1, 2, (300, 200), 8),
    (64, 4, 2, (100, -3), 8),
    (300, 3, 2, (300, 150), 2),
]


def _limit(n, S, r, g):
    """Row r's key limit: min(len clamped to [0, S], s + 1)."""
    return min(min(max(n, 0), S), r // g + 1)


class TestBlockPlan:
    def test_tiling_is_two_warpgroups(self):
        assert ROWS_PER_BLOCK == 2 * ROWS_PER_WARPGROUP
        assert KEYS_PER_TILE == 128

    @pytest.mark.parametrize("S,g,B,lens,n_kv", PLAN_CASES)
    def test_launch_order_is_a_permutation_heaviest_first(self, S, g, B, lens, n_kv):
        plan = causal_block_plan(S, g, B, lens, n_kv)
        row_tiles = -(-S * g // ROWS_PER_BLOCK)
        seen = sorted((blk.b, blk.kv, blk.rows.start) for blk in plan)
        assert seen == sorted(
            (b, kv, t * ROWS_PER_BLOCK)
            for b in range(B) for kv in range(n_kv) for t in range(row_tiles)
        )
        for blk in plan:
            assert blk.rows.stop == min(blk.rows.start + ROWS_PER_BLOCK, S * g)
        # batch rows in order, each one's blocks heaviest first
        assert [blk.b for blk in plan] == sorted(blk.b for blk in plan)
        for b in range(B):
            work = [blk.tiles for blk in plan if blk.b == b]
            assert work == sorted(work, reverse=True)

    @pytest.mark.parametrize("S,g,B,lens,n_kv", PLAN_CASES)
    def test_walked_tiles_cover_the_mask_and_no_more(self, S, g, B, lens, n_kv):
        for blk in causal_block_plan(S, g, B, lens, n_kv):
            limits = [_limit(lens[blk.b], S, r, g) for r in blk.rows]
            # every admitted key j < limit lies in a walked tile
            assert max(limits) <= blk.tiles * KEYS_PER_TILE
            # no walked tile starts at or past the block's largest limit
            assert blk.tiles == 0 or (blk.tiles - 1) * KEYS_PER_TILE < max(limits)

    @pytest.mark.parametrize("S,g,B,lens,n_kv", PLAN_CASES)
    def test_unmasked_tiles_need_no_mask(self, S, g, B, lens, n_kv):
        for blk in causal_block_plan(S, g, B, lens, n_kv):
            for wg, first in enumerate(blk.first_masked):
                start = blk.rows.start + wg * ROWS_PER_WARPGROUP
                rows = [r for r in range(start, start + ROWS_PER_WARPGROUP)
                        if r < blk.rows.stop]
                if not rows:
                    continue
                low = min(_limit(lens[blk.b], S, r, g) for r in rows)
                # tiles below `first` are wholly admitted for every row...
                assert first * KEYS_PER_TILE <= low
                # ...and the tile at `first` is not (a row ends inside it)
                assert low < (first + 1) * KEYS_PER_TILE

    def test_prefix_chunk_blocks_carry_1_to_16_tiles_heaviest_first(self):
        """At the 8B prefix chunk q[1,2048] (g = 4, 8 kv heads) the 512
        blocks walk 16 down to 1 key tiles, the 16-tile ones launched first."""
        plan = causal_block_plan(2048, 4, 1, (2048,), 8)
        assert len(plan) == 512
        assert [blk.tiles for blk in plan[:32]] == [16] * 32
        assert [blk.tiles for blk in plan[-32:]] == [1] * 32


def _flash_by_plan(q, k, v, lens):
    """K2's arithmetic in f32, block by block as the plan says: each block
    walks its tiles with an online softmax, and a warpgroup masks a tile
    only from its first masked tile on (below it no mask is applied)."""
    B, S, H, hd = q.shape
    n_kv = k.shape[2]
    g = H // n_kv
    o = torch.zeros((B, n_kv, g, S, hd))
    m = torch.full((B, n_kv, g, S), NEG_INF)
    l = torch.zeros((B, n_kv, g, S))
    qs = q * hd**-0.5
    for blk in causal_block_plan(S, g, B, lens.tolist(), n_kv):
        n = min(max(int(lens[blk.b]), 0), S)
        for wg, first in enumerate(blk.first_masked):
            start = blk.rows.start + wg * ROWS_PER_WARPGROUP
            if start >= blk.rows.stop:
                continue
            rows = torch.arange(start, min(start + ROWS_PER_WARPGROUP, blk.rows.stop))
            s_pos, gi = rows // g, rows % g
            qr = qs[blk.b, s_pos, blk.kv * g + gi]  # [rows, hd]
            limit = torch.clamp(s_pos + 1, max=n)
            m_r = torch.full((len(rows),), NEG_INF)
            l_r = torch.zeros(len(rows))
            o_r = torch.zeros((len(rows), hd))
            for t in range(blk.tiles):
                keys = torch.arange(t * KEYS_PER_TILE, (t + 1) * KEYS_PER_TILE)
                inside = keys < S  # keys past S arrive as zeros
                kt = torch.zeros((KEYS_PER_TILE, hd))
                vt = torch.zeros((KEYS_PER_TILE, hd))
                kt[inside] = k[blk.b, keys[inside], blk.kv]
                vt[inside] = v[blk.b, keys[inside], blk.kv]
                sc = qr @ kt.T
                admit = keys[None, :] < limit[:, None]
                if t >= first:
                    sc = torch.where(admit, sc, NEG_INF)
                else:
                    assert admit.all()
                m_new = torch.maximum(m_r, sc.amax(dim=1))
                alpha = torch.exp(m_r - m_new)
                p = torch.exp(sc - m_new[:, None])
                if t >= first:
                    p = torch.where(admit, p, 0.0)
                l_r = l_r * alpha + p.sum(dim=1)
                o_r = o_r * alpha[:, None] + p @ vt
                m_r = m_new
            o[blk.b, blk.kv, gi, s_pos] = o_r
            m[blk.b, blk.kv, gi, s_pos] = m_r
            l[blk.b, blk.kv, gi, s_pos] = l_r
    return o, m, l


class TestFlashByPlan:
    @pytest.mark.parametrize(
        "S,g,lens",
        [(300, 4, (300, 129, 1)), (136, 8, (136, 0)), (200, 1, (250, -1, 77)),
         (300, 3, (300, 150))],
    )
    def test_plan_walk_equals_plain_f32(self, S, g, lens):
        B, n_kv, hd = len(lens), 2, 64
        q, k, v = (torch.from_numpy(a) for a in _inputs(S * g, B, S, g * n_kv, n_kv, hd))
        lens_t = torch.tensor(lens, dtype=torch.int32)
        got = _flash_by_plan(q, k, v, lens_t)
        want = causal_attention_parts_plain(q, k, v, lens_t)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **F32)
