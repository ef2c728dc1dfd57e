"""K1's split of the prefix keys over blocks, on the CPU.

Where K1's query rows are too few to fill the card (block decode), the
wrapper splits the prefix keys over blocks with `kv_splits` (from shapes
alone) and a second kernel folds the splits' partials in split order. Here
the split kernel's workspace is computed plainly (`split_prefix_parts_plain`,
K1's plain version over each key range) and folded by the combine kernel's
twin (`combine_splits_plain`): that must equal the unsplit plain version in
f32 to 1e-5 (only the order of the f32 sums differs), and the JAX package's
einsum path. The plan itself must fill the card at the 8B path's block
decode, leave the wide calls unsplit and keep its workspace under the cap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu.ops import attention as jA
from k8s_llm_scheduler_tpu_torch.ops.prefix_attention import (
    KEYS_PER_TILE,
    NEG_INF,
    ROWS_PER_BLOCK,
    combine_splits_plain,
    kv_splits,
    prefix_attention_parts_plain,
    split_prefix_parts_plain,
    workspace_cap_bytes,
)
from k8s_llm_scheduler_tpu_torch.testing import cap_torch_threads

cap_torch_threads()

F32 = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132
# Llama-3.1-8B on the decision path: 32 query heads over 8 kv heads of 128,
# an 8,192-slot prefix buffer; block decode runs q[R, 24]
N_KV, G, HD, SP, BLOCK_F = 8, 4, 128, 8192, 24


def _blocks(rows, splits):
    return -(-rows // ROWS_PER_BLOCK) * N_KV * splits


class TestSplitPlan:
    @pytest.mark.parametrize("R", [4, 8])
    def test_block_decode_fills_the_card(self, R):
        rows = R * BLOCK_F * G
        splits, per = kv_splits(rows, N_KV, SP, HD, H100_SMS)
        assert splits > 1 and _blocks(rows, splits) >= H100_SMS
        assert per % KEYS_PER_TILE == 0 and (splits - 1) * per < SP <= splits * per
        workspace = splits * rows * N_KV * (HD + 2) * 4
        assert workspace <= workspace_cap_bytes(SP, N_KV, HD)

    @pytest.mark.parametrize("B,S", [(8, 256), (4, 256), (1, 2048)])
    def test_wide_calls_stay_unsplit(self, B, S):
        splits, per = kv_splits(B * S * G, N_KV, SP, HD, H100_SMS)
        assert splits == 1 and per >= SP

    def test_workspace_cap_limits_the_splits(self):
        """A card wide enough to want more splits than the cap allows gets
        as many as fit under the cap."""
        rows, hd = 64, 128
        splits, _ = kv_splits(rows, 1, SP, hd, 10_000)
        per_split = rows * (hd + 2) * 4
        assert 1 < splits <= workspace_cap_bytes(SP, 1, hd) // per_split
        assert splits < SP // KEYS_PER_TILE  # the cap, not the key tiles, bound it

    @pytest.mark.parametrize("rows", [0, 24])  # 0: an empty call, no kernel work
    def test_no_split_is_wholly_past_the_buffer(self, rows):
        for sp in (1, 63, 64, 65, 1000, 8191, 8192):
            splits, per = kv_splits(rows, 2, sp, 64, H100_SMS)
            assert (splits - 1) * per < sp <= splits * per


class TestCombine:
    B, S, H, NKV = 2, 7, 8, 2

    def _inputs(self, seed, sp, hd):
        rng = np.random.default_rng(seed)
        q = 3.0 * rng.standard_normal((self.B, self.S, self.H, hd)).astype(np.float32)
        k = rng.standard_normal((sp, self.NKV, hd)).astype(np.float32)
        v = rng.standard_normal((sp, self.NKV, hd)).astype(np.float32)
        return q, k, v

    @pytest.mark.parametrize("hd", [64, 128])
    @pytest.mark.parametrize(
        "plen,splits,per",
        [
            (0, 4, 64),      # no valid key: every split is empty
            (130, 4, 64),    # not a multiple of the tile; splits 3.. past it
            (100, 3, 128),   # splits 1 and 2 wholly past prefix_len
            (320, 5, 64),    # every key valid, a split per 64 keys
            (200, 1, 320),   # one split: the combine is the identity
        ],
    )
    def test_split_then_combine_equals_unsplit(self, hd, plen, splits, per):
        q, k, v = (torch.from_numpy(a) for a in self._inputs(hd + plen, 320, hd))
        plen_t = torch.tensor(plen, dtype=torch.int32)
        parts = split_prefix_parts_plain(q, k, v, plen_t, splits, per)
        assert parts[0].shape[0] == splits
        for s in range(splits):  # a split at or past prefix_len is empty
            if s * per >= plen:
                assert (parts[1][s] == NEG_INF).all()
                assert (parts[2][s] == 0).all() and (parts[0][s] == 0).all()
        o, m, l = combine_splits_plain(*parts)
        o_r, m_r, l_r = prefix_attention_parts_plain(q, k, v, plen_t)
        for got, want in ((o, o_r), (m, m_r), (l, l_r)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
        if plen == 0:
            assert (m == NEG_INF).all() and (l == 0).all() and (o == 0).all()

    @pytest.mark.parametrize("hd", [64, 128])
    def test_split_then_combine_matches_jax(self, hd):
        """The folded splits agree with the JAX package's einsum path at the
        plan's own split of a decode-shaped call."""
        q, k, v = self._inputs(7, 4096, hd)
        plen = 3000
        rows = self.B * self.S * (self.H // self.NKV)
        splits, per = kv_splits(rows, self.NKV, 4096, hd, H100_SMS)
        assert splits > 1
        o, m, l = combine_splits_plain(*split_prefix_parts_plain(
            *map(torch.from_numpy, (q, k, v)), torch.tensor(plen, dtype=torch.int32),
            splits, per))
        qj = jnp.asarray(q)
        qg = (qj * hd**-0.5).reshape(self.B, self.S, self.NKV, -1, hd)
        o_j, m_j, l_j = jA.prefix_attend_parts(
            qj, qg, jnp.asarray(k), jnp.asarray(v), jnp.int32(plen), impl="xla")
        for got, want in ((o, o_j), (m, m_j), (l, l_j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
