"""Sampled decisions on the CPU. A sampled token cannot be held to
`jax.random`'s bytes, so the port's sampling is held to the grammar and to
the distribution:

- at the reference's temperature 0.3 on TINY every constrained decision
  parses and names a feasible node, through waves and through packed
  admission;
- 4,000 draws of the wave sampler over one grammar row's logits (8
  allowed tokens) land within total-variation distance 0.05 of the JAX
  engine's softmax(logits / 0.3) over the same row;
- two sampled waves of the same prompts do not all emit the same streams
  (the generator moves on);
- greedy decoding (temperature 0) stays token-identical to the JAX engine.
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
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu_torch.core.prompt import PromptEngine, pod_suffix
from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
from k8s_llm_scheduler_tpu_torch.engine import constrained as tconstrained
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine as TEngine
from k8s_llm_scheduler_tpu_torch.engine.engine import _sample_sparse
from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.testing import (
    cap_torch_threads,
    fixture_pods,
    synthetic_nodes,
)
from k8s_llm_scheduler_tpu_torch.types import DecisionSource
from k8s_llm_scheduler_tpu_torch.utils.json_extract import parse_decision_json

cap_torch_threads()

TEMPERATURE = 0.3  # the reference config's llm.temperature
DRAWS = 4000
TV_LIMIT = 0.05
JTINY = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TTINY = dataclasses.replace(tconfigs.TINY, dtype=torch.float32)
NAMES = [f"node-{i}" for i in range(4)]


@pytest.mark.parametrize("packed", [False, True], ids=["waves", "packed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sampled_decisions_parse_and_name_a_feasible_node(seed, packed):
    backend = build_local_backend("tiny", device="cpu", seed=seed, temperature=TEMPERATURE,
                                  packed_admission=packed, max_new_tokens=100,
                                  request_timeout_s=600.0, prewarm_idle_delay_s=600.0)
    assert backend.engine.temperature == TEMPERATURE
    nodes, pods = synthetic_nodes(4), fixture_pods(6)
    try:
        decisions = backend.get_scheduling_decisions_batch(pods, nodes)
        decisions.append(backend.get_scheduling_decision(pods[0], nodes))
        stats = backend.get_stats()
    finally:
        backend.close()
    for pod, d in zip(pods + pods[:1], decisions):
        assert not isinstance(d, Exception), d
        assert d.source == DecisionSource.LLM
        assert d.selected_node in {n.name for n in feasible_nodes(pod, nodes)}
        assert 0.0 <= d.confidence <= 1.0
    assert (stats["packed_admissions"] > 0) == packed


def _grammar_row(seed):
    """A DFA state of the decision grammar with 8 allowed tokens (the
    node-name choice over 8 nodes), its sparse table rows, and logits."""
    tok = ByteTokenizer()
    names = [f"n{i}" for i in range(8)]
    dfa = tconstrained.build_decision_dfa(tok, names, max_reason_tokens=4)
    t = tconstrained.sparse_tables(dfa)
    widths = (t.sp_tokens >= 0).sum(axis=1)
    state = int(np.nonzero(widths == 8)[0][0])
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=tok.vocab_size) * 0.4).astype(np.float32)
    return t.sp_tokens[state], t.sp_next[state], logits


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grammar_row_draws_follow_the_jax_softmax(seed):
    tok_row, next_row, logits = _grammar_row(seed)
    allowed = tok_row[tok_row >= 0]
    assert len(allowed) == 8
    # the JAX engine's distribution: categorical over logits / T, the
    # disallowed tokens masked out
    masked = jnp.where(jnp.asarray(tok_row) >= 0,
                       jnp.asarray(logits)[jnp.asarray(np.maximum(tok_row, 0))], -1e30)
    want = np.asarray(jax.nn.softmax(masked / TEMPERATURE))[tok_row >= 0]
    gen = torch.Generator().manual_seed(seed)
    rows = torch.from_numpy(logits)[None].expand(DRAWS, -1).contiguous()
    tok, nxt = _sample_sparse(rows, torch.from_numpy(tok_row)[None].expand(DRAWS, -1),
                              torch.from_numpy(next_row)[None].expand(DRAWS, -1), gen,
                              TEMPERATURE)
    tok, nxt = tok.numpy(), nxt.numpy()
    assert set(tok) <= set(allowed)
    # each draw moves to its own token's next state
    assert all(nxt[i] == next_row[list(tok_row).index(tok[i])] for i in range(0, DRAWS, 97))
    got = np.array([(tok == a).mean() for a in allowed])
    tv = 0.5 * np.abs(got - want).sum()
    assert tv <= TV_LIMIT, (tv, got, want)
    assert want.max() < 0.9  # a distribution that sampling can tell from argmax


@pytest.fixture(scope="module")
def tiny_params():
    jp = jinit_params(jax.random.PRNGKey(0), JTINY)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _prompts():
    tok, pe = ByteTokenizer(), PromptEngine()
    cluster = pe.cluster_part(synthetic_nodes(4))
    parts = [tok.chat_prompt_parts(pe.system_prompt, cluster, pod_suffix(p))
             for p in fixture_pods(4)]
    return parts[0][0], [s for _, s in parts]


def test_two_sampled_waves_do_not_repeat_each_other(tiny_params):
    _, tp = tiny_params
    prefix, suffixes = _prompts()
    tok = ByteTokenizer()
    eng = TEngine(tp, TTINY, tok, temperature=TEMPERATURE, rng_seed=0, graphs=False,
                  prefill_buckets=(128, 256, 512))
    eng.set_prefix(prefix)
    eng.set_grammar(tconstrained.build_decision_dfa(tok, NAMES, max_reason_tokens=24))
    same = [suffixes[0]] * 4
    first = [f.token_ids for f in eng.decide_wave(same, 100)]
    second = [f.token_ids for f in eng.decide_wave(same, 100)]
    assert first + second != [first[0]] * 8
    for ids in first + second:
        assert parse_decision_json(tok.decode(ids))["selected_node"] in NAMES


@pytest.mark.parametrize("grammar", [True, False], ids=["grammar", "free"])
def test_greedy_waves_stay_token_identical_to_the_jax_engine(tiny_params, grammar):
    jp, tp = tiny_params
    prefix, suffixes = _prompts()
    jtok, ttok = JByteTokenizer(), ByteTokenizer()
    kw = dict(max_slots=8, prefill_buckets=(128, 256, 512), temperature=0.0, prefix_chunk=128)
    jeng = JEngine(jp, JTINY, jtok, num_pages=16, page_size=64, max_pages_per_seq=8, **kw)
    teng = TEngine(tp, TTINY, ttok, graphs=False, **kw)
    if grammar:
        jeng.set_grammar(jconstrained.build_decision_dfa(jtok, NAMES, max_reason_tokens=12))
        teng.set_grammar(tconstrained.build_decision_dfa(ttok, NAMES, max_reason_tokens=12))
    for eng in (jeng, teng):
        eng.set_prefix(prefix)
    budget = 90 if grammar else 12
    want = [f.token_ids for f in jeng.decide_wave(suffixes, budget)]
    got = [f.token_ids for f in teng.decide_wave(suffixes, budget)]
    assert got == want
