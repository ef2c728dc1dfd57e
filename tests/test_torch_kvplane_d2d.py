"""The prefix-KV plane's `d2d` transport between two tp=2 groups of TINY
(seed 0), on the CPU and on a card. This process is the driver of both
groups, one spawned follower each. The filler pins a prefix and exports
its pages `d2d`. The adopter's ranks copy the filler's same-rank blocks:
rank 0 from the driver's own tensors, rank 1 through the handle the
filler's rank 1 shared (a file on the CPU, a CUDA IPC handle on a card).
Then the filler clears its cache and adopts its own page set, each rank
reading its export table. The `cuda` case needs a card (`python -m pytest
--noconftest -m cuda tests/test_torch_kvplane_d2d.py`: tests/conftest.py
imports JAX) and skips without one. This file imports no JAX, so it runs
where the port runs; tests/test_torch_kvplane_tp.py holds the same
transport against the JAX engine on the CPU.
"""

import gc

import pytest
import torch

from k8s_llm_scheduler_tpu_torch import testing
from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.fleet import kvplane
from k8s_llm_scheduler_tpu_torch.parallel import launch

testing.cap_torch_threads()

TOK = ByteTokenizer()
PREFIX = TOK.encode("CLUSTER STATE: " + " ".join(f"node-{i} cpu={10 + i}" for i in range(6)))
SUFFIXES = [TOK.encode("pod-a needs a node"), TOK.encode("pod-b")]
BUDGET = 6
ENGINE_KW = dict(graphs=False, temperature=0.0, packed_admission=False, max_pages_per_seq=32,
                 request_timeout_s=600.0, prewarm_idle_delay_s=600.0)


def _wave(engine) -> list:
    engine.set_grammar(None)
    engine.set_prefix(PREFIX)
    return [f.token_ids for f in engine.decide_wave(SUFFIXES, BUDGET)]


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_d2d_pages_cross_two_groups_and_back_into_the_filler(device):
    """The adopter's wave equals the filler's local one with no prefix
    prefill and no tp collective on either group; the filler adopts its
    own page set after clearing its cache; once the page set is gone every
    filler rank's export table is empty."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    backends = []
    try:
        for _ in range(2):
            backends.append(build_local_backend("tiny", device=device, seed=0,
                                                mesh_axes={"tp": 2}, **ENGINE_KW))
        filler, adopter = (b.engine for b in backends)
        key, _ = filler.pin_prefix(PREFIX)
        local = _wave(filler)
        books = [e.rank_group.on_ranks(launch.rank_collectives) for e in (filler, adopter)]
        before = adopter.rank_group.on_ranks(launch.engine_state)
        pages = kvplane.export_pages(filler, key, generation=0, filler="fill", transport="d2d")
        (handles,) = pages.k.export.handles
        assert [h["kind"] for h in handles] == [{"cpu": "file", "cuda": "cuda"}[device]] * 2
        kvplane.adopt_pages(adopter, pages)
        assert [e.rank_group.on_ranks(launch.rank_collectives)
                for e in (filler, adopter)] == books
        assert _wave(adopter) == local
        after = adopter.rank_group.on_ranks(launch.engine_state)
        assert [a["prefix_prefills"] - b["prefix_prefills"]
                for a, b in zip(after, before)] == [0, 0]

        filler.rank_group.on_ranks(testing.clear_prefix_cache)
        kvplane.adopt_pages(filler, pages)
        assert _wave(filler) == local
        export_id = pages.k.export.export_id
        assert filler.rank_group.on_ranks(launch.export_table) == [[export_id]] * 2
        del pages
        gc.collect()
        assert filler.rank_group.on_ranks(launch.export_table) == [[], []]
        for engine in (filler, adopter):
            assert engine.rank_group.broken is None
    finally:
        for backend in backends:
            backend.close()
