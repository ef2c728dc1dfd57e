"""K4's split plan and split merge held on the CPU (the kernel itself runs
only on the card, in chip_smoke.py).

K4 splits each sequence's pages over blocks: the host plans the number of
splits from shapes (`paged_splits`), each block finds its page range on the
device from the sequence's length (`split_page_ranges`), writes its
partials to a workspace (`split_paged_parts_plain` is the plain twin of
that workspace), and the block that draws the last ticket folds every
split's partials in split order (`merge_paged_splits_plain`).

Tolerances: 2e-5 where both sides compute in f32 from the same f32 inputs
(only the order of the sums differs); empty rows are exact. The ticket
merge is bitwise: the fold reads the splits in split order, whatever order
they arrived in.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu.ops.pallas_paged_attention import (
    paged_decode_attention_parts as jax_paged_parts,
)
from k8s_llm_scheduler_tpu_torch.ops.paged_attention import (
    MIN_SPLIT_TOKENS,
    NEG_INF,
    merge_paged_splits_plain,
    min_split_pages,
    paged_attention_parts_plain,
    paged_splits,
    split_page_ranges,
    split_paged_parts_plain,
)

F32 = dict(rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ the plan
PLAN_SHAPES = [
    # (B, n_kv, P, sm_count): path B (8 slots + the trash row), one long
    # sequence, a batch past the card, tables narrower than the plan,
    # Llama-3.3-70B's kv heads, TINY, an empty batch and a 1-page table
    (9, 8, 64, 132),
    (1, 8, 64, 132),
    (40, 8, 4, 132),
    (3, 8, 2, 132),
    (1, 1, 1000, 132),
    (2, 8, 64, 114),
    (6, 2, 8, 132),
    (0, 8, 64, 132),
    (5, 8, 1, 132),
    (17, 4, 16, 80),
]


@pytest.mark.parametrize("B,n_kv,P,sm", PLAN_SHAPES)
def test_plan_gives_each_sm_a_block_and_no_more(B, n_kv, P, sm):
    """The grid is B * n_kv * splits blocks: splits is at least 1 and at
    most the table's width; the grid fills the card where the table allows,
    and one split fewer would not (the fewest splits that do)."""
    S = paged_splits(B, n_kv, P, sm)
    blocks = B * n_kv
    assert 1 <= S <= max(P, 1)
    assert blocks * S >= min(sm, blocks * max(P, 1))
    assert S == 1 or blocks * (S - 1) < sm
    assert blocks * S < sm + blocks  # at most one block an SM past a full card


RANGE_CASES = [
    # (ps, P, splits, lens): path B's step at its plan, the long shape, pages
    # of 16 (16 pages a split at least), a split count past the pages, the
    # clamp at P*ps, empty and negative lengths, pages of 203 and 256
    (64, 64, 2, (226, 247, 0, -5488, 1, 64, 65)),
    (64, 64, 2, (4032, 3969, 4096, 5000)),
    (16, 8, 5, (0, 1, 15, 16, 17, 127, 128, 500, -1)),
    (64, 64, 17, (100, 1, 4096, 257)),
    (203, 6, 6, (1218, 204, 202, 406, 407)),
    (256, 40, 40, (10000, 256, 257, 10240, 99999)),
]


@pytest.mark.parametrize("ps,P,splits,lens", RANGE_CASES)
def test_device_ranges_split_the_valid_pages(ps, P, splits, lens):
    """Each split's range is whole pages from its start, the ranges follow
    each other in split order without gap or overlap, together cover
    exactly [0, clamp(len, 0, P*ps)), and every split but a sequence's last
    non-empty one holds the same count of pages, at least
    min_split_pages(ps) (MIN_SPLIT_TOKENS)."""
    lens_t = torch.tensor(lens, dtype=torch.int32)
    lo, hi = split_page_ranges(lens_t, ps, P, splits)
    assert lo.shape == hi.shape == (splits, len(lens))
    for b, n in enumerate(lens):
        n = min(max(n, 0), P * ps)
        ranges = [(int(lo[s, b]), int(hi[s, b])) for s in range(splits)]
        live = [(a, z) for a, z in ranges if z > a]
        assert all(a % ps == 0 for a, _ in live)
        covered = 0
        for a, z in live:
            assert a == covered
            covered = z
        assert covered == n
        sizes = [-(-(z - a) // ps) for a, z in live]
        assert all(size == sizes[0] for size in sizes[:-1])
        if len(live) > 1:
            assert sizes[0] >= min_split_pages(ps)
            assert sizes[0] * ps >= MIN_SPLIT_TOKENS
        # a split's range is non-empty only if every earlier one is
        assert [z > a for a, z in ranges] == sorted([z > a for a, z in ranges], reverse=True)


# ------------------------------------------------- the split twin
# CPU-sized counterparts of chip_smoke.py's K4_EDGE_CASES: (name, B, H,
# n_kv, hd, ps, num_pages, P, lens, table kind).
EDGE_CASES = [
    ("TINY lens 0/1/ps-1/ps/ps+1/<0", 6, 4, 2, 64, 16, 64, 8, (0, 1, 15, 16, 17, -3),
     "scattered"),
    ("g 1 hd 64, P*ps and past it", 4, 4, 4, 64, 16, 40, 8, (128, 500, 64, -1),
     "descending"),
    ("g 8, repeated pages", 3, 16, 2, 128, 64, 16, 8, (512, 65, 63), "repeated"),
    ("g 3, ps 32", 3, 6, 2, 128, 32, 16, 4, (100, 31, 128), "scattered"),
    ("ps 100 hd 64", 2, 8, 2, 64, 100, 12, 5, (500, 101), "descending"),
    ("ps 203", 3, 8, 2, 128, 203, 24, 6, (1218, 204, 202), "scattered"),
    ("B 1, splits past the pages", 1, 8, 2, 128, 64, 64, 64, (100,), "scattered"),
    ("ps 256, 40 pages", 1, 4, 1, 64, 256, 48, 40, (10000,), "descending"),
]


def _tables(kind, B, P, num_pages, rng):
    if kind == "scattered":
        ids = np.resize(rng.permutation(num_pages), B * P)
    elif kind == "descending":
        ids = (num_pages - 1 - np.arange(B * P)) % num_pages
    else:
        ids = rng.integers(0, min(4, num_pages), B * P)
    return ids.reshape(B, P).astype(np.int32)


def _case(case, seed=0):
    _, B, H, n_kv, hd, ps, num_pages, P, lens, kind = case
    rng = np.random.default_rng(seed)
    q = (2.0 * rng.standard_normal((B, H, hd))).astype(np.float32)
    k = rng.standard_normal((num_pages, ps, n_kv, hd)).astype(np.float32)
    v = rng.standard_normal((num_pages, ps, n_kv, hd)).astype(np.float32)
    return q, k, v, _tables(kind, B, P, num_pages, rng), np.asarray(lens, np.int32)


def _splits_for(case):
    """The plan on an H100 (132 SMs), one split, and split counts past it."""
    _, B, _, n_kv, _, _, _, P, _, _ = case
    return sorted({1, 3, paged_splits(B, n_kv, P, 132), P})


@pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_split_merge_matches_the_plain_partials(case):
    q, k, v, table, lens = map(torch.from_numpy, _case(case))
    want = paged_attention_parts_plain(q, k, v, table, lens)
    dead = lens <= 0
    for splits in _splits_for(case):
        parts = split_paged_parts_plain(q, k, v, table, lens, splits)
        assert parts[0].shape == (splits, *want[0].shape)
        got = merge_paged_splits_plain(*parts)
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), w_.numpy(), **F32)
        assert (got[1][dead] == NEG_INF).all() and (got[2][dead] == 0).all()
        assert (got[0][dead] == 0).all()


@pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_split_merge_matches_the_pallas_kernel(case):
    """The split twin merged at the plan against the JAX package's Pallas
    kernel in interpret mode, f32 inputs."""
    q, k, v, table, lens = _case(case, seed=1)
    o_j, m_j, l_j = jax_paged_parts(*map(jnp.asarray, (q, k, v, table, lens)), interpret=True)
    _, B, _, n_kv, _, _, _, P, _, _ = case
    parts = split_paged_parts_plain(*map(torch.from_numpy, (q, k, v, table, lens)),
                                    paged_splits(B, n_kv, P, 132))
    o_t, m_t, l_t = merge_paged_splits_plain(*parts)
    live = lens > 0
    np.testing.assert_allclose(m_t.numpy()[live], np.asarray(m_j)[live], **F32)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), **F32)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **F32)


# ------------------------------------------------------ the ticket merge
def _ticket_merge(ws_o, ws_m, ws_l, arrival):
    """A CPU model of the kernel's merge: splits arrive in `arrival` order,
    each writes its partials to the workspace and takes a ticket from the
    counter; the one that draws the last ticket folds the workspace in
    split order and sets the counter back to 0. Returns (merged, counter)."""
    n = ws_m.shape[0]
    ws = [None] * n
    counter, merged = 0, None
    for s in arrival:
        ws[s] = (ws_o[s], ws_m[s], ws_l[s])
        ticket, counter = counter, counter + 1
        if ticket == n - 1:
            merged = merge_paged_splits_plain(*(torch.stack(t) for t in zip(*ws)))
            counter = 0
    return merged, counter


def _arrival_order_fold(ws_o, ws_m, ws_l, arrival):
    """The fold a kernel would get by merging in arrival order instead."""
    order = list(arrival)
    return merge_paged_splits_plain(ws_o[order], ws_m[order], ws_l[order])


# four, three and two non-empty splits, and an empty sequence
TICKET_CASE = ("ticket", 4, 8, 2, 128, 64, 40, 16, (1000, 600, 300, -1), "scattered")


@pytest.fixture(scope="module")
def ticket_parts():
    q, k, v, table, lens = map(torch.from_numpy, _case(TICKET_CASE, seed=2))
    return split_paged_parts_plain(q, k, v, table, lens, 4)


@pytest.mark.parametrize("arrival", list(itertools.permutations(range(4))),
                         ids=lambda a: "".join(map(str, a)))
def test_any_arrival_order_gives_the_same_bits(ticket_parts, arrival):
    want, _ = _ticket_merge(*ticket_parts, (0, 1, 2, 3))
    got, counter = _ticket_merge(*ticket_parts, arrival)
    assert counter == 0
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)


def test_an_arrival_order_fold_would_not(ticket_parts):
    """The check above can fail: folding in arrival order gives other bits
    for some order, as f32 sums do."""
    want = _arrival_order_fold(*ticket_parts, (0, 1, 2, 3))
    differs = [
        a for a in itertools.permutations(range(4))
        if not torch.equal(_arrival_order_fold(*ticket_parts, a)[0], want[0])
    ]
    assert differs
