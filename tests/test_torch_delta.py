"""The port's snapshot-delta prompt encoder (sched/delta.py) and host-side
prepacker (engine/admission/packer.py) held against the JAX package's:
both are copies of the reference's text, and on the same node lists and
prompts they give the same DeltaPrompt, counters and PackedPlan."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from k8s_llm_scheduler_tpu.core.prompt import PromptEngine as JPromptEngine
from k8s_llm_scheduler_tpu.engine.admission.packer import pack_prompts as jpack
from k8s_llm_scheduler_tpu.sched.delta import SnapshotDeltaEncoder as JEncoder
from k8s_llm_scheduler_tpu_torch.core.prompt import PromptEngine as TPromptEngine
from k8s_llm_scheduler_tpu_torch.engine.admission.packer import pack_prompts as tpack
from k8s_llm_scheduler_tpu_torch.sched.delta import DELTA_HEADER
from k8s_llm_scheduler_tpu_torch.sched.delta import SnapshotDeltaEncoder as TEncoder
from k8s_llm_scheduler_tpu_torch.types import NodeMetrics as TNodeMetrics

from conftest import make_node
from k8s_llm_scheduler_tpu_torch.testing import cap_torch_threads

cap_torch_threads()

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("path", ["sched/delta.py", "engine/admission/packer.py"])
def test_copy_matches_the_reference_text(path):
    want = (REPO / "k8s_llm_scheduler_tpu" / path).read_text().replace(
        "k8s_llm_scheduler_tpu.", "k8s_llm_scheduler_tpu_torch.")
    assert (REPO / "k8s_llm_scheduler_tpu_torch" / path).read_text() == want


def _port(node):
    """The port's NodeMetrics with the same field values."""
    return TNodeMetrics(**{f.name: getattr(node, f.name) for f in dataclasses.fields(node)})


def _nodes(n=4, cpu=10.0):
    return [make_node(f"node-{i}", cpu_pct=cpu + i) for i in range(n)]


def _drift(nodes, idx, **changes):
    out = list(nodes)
    for i in idx:
        out[i] = dataclasses.replace(out[i], **changes)
    return out


# Each scenario: snapshots encoded in order by one encoder (a fresh one per
# scenario), and the repin_fraction it is built with.
SCENARIOS = {
    "first pin": ([_nodes()], 0.25),
    "drift": ([_nodes(), _drift(_nodes(), [2], cpu_usage_percent=88.0)], 0.25),
    "clean": ([_nodes(), [dataclasses.replace(n) for n in _nodes()]], 0.25),
    "membership": ([_nodes(4), _nodes(5)], 0.25),
    "readiness": ([_nodes(), _nodes()[:1] + [make_node("node-1", cpu_pct=11.0, ready=False)]
                   + _nodes()[2:]], 0.25),
    "drift fraction": ([_nodes(), _drift(_nodes(), [0, 1], cpu_usage_percent=77.0)], 0.25),
    "drift then clean then drift": (
        [_nodes(8), _drift(_nodes(8), [1], memory_usage_percent=66.0),
         _drift(_nodes(8), [1], memory_usage_percent=66.0),
         _drift(_nodes(8), [1, 5], pod_count=40)], 0.25),
    "drift past a low threshold": (
        [_nodes(), _drift(_nodes(), [0, 1, 2], cpu_usage_percent=70.0)], 0.2),
    "32 nodes, 8 drifted": (
        [_nodes(32), _drift(_nodes(32), range(0, 32, 4), pod_count=3)], 0.25),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_delta_prompts_match_the_jax_encoder(name):
    snapshots, repin_fraction = SCENARIOS[name]
    jenc, tenc = JEncoder(repin_fraction), TEncoder(repin_fraction)
    for nodes in snapshots:
        want = jenc.encode(nodes)
        got = tenc.encode([_port(n) for n in nodes])
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tenc.stats() == jenc.stats()


def test_first_pin_is_the_plain_render_and_a_delta_extends_it():
    enc = TEncoder()
    nodes = [_port(n) for n in _nodes()]
    pin = enc.encode(nodes)
    assert pin.repinned and pin.cluster_part == TPromptEngine().cluster_part(nodes)
    assert pin.cluster_part == JPromptEngine().cluster_part(_nodes())
    dp = enc.encode(_drift(nodes, [2], cpu_usage_percent=88.0))
    assert not dp.repinned and dp.delta_nodes == 1 and dp.pin_key == pin.pin_key
    tail = dp.cluster_part[len(pin.cluster_part):]
    assert dp.cluster_part.startswith(pin.cluster_part)
    assert tail.startswith(DELTA_HEADER) and "node-2" in tail and "88.0" in tail


PACKS = {
    "one short": ([3], 8),
    "share a chunk": ([2, 1, 2], 8),
    "spans a boundary": ([2, 10], 4),
    "exact fill": ([4, 4], 4),
    "many": ([17, 3, 45, 1, 9, 30, 2, 64], 16),
}


@pytest.mark.parametrize("name", list(PACKS))
def test_pack_plans_match_the_jax_packer(name):
    lens, C = PACKS[name]
    rng = np.random.default_rng(len(lens) * 100 + C)
    prompts = [rng.integers(1, 500, n).tolist() for n in lens]
    want, got = jpack(prompts, C, 0), tpack(prompts, C, 0)
    assert (got.prompt_lens, got.chunk_tokens, got.total_tokens) == (
        want.prompt_lens, want.chunk_tokens, want.total_tokens)
    assert got.n_chunks == want.n_chunks == -(-sum(lens) // C)
    for g, w in zip(got.chunks, want.chunks):
        for field in ("tokens", "seg", "positions"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
        assert (g.n_tokens, g.ends) == (w.n_tokens, tuple(
            type(g.ends[0])(e.prompt, e.index) for e in w.ends) if w.ends else ())


@pytest.mark.parametrize("prompts,C", [([], 8), ([[1], []], 8), ([[1]], 0)])
def test_packer_rejects_what_the_jax_packer_rejects(prompts, C):
    with pytest.raises(ValueError):
        jpack(prompts, C, 0)
    with pytest.raises(ValueError):
        tpack(prompts, C, 0)
