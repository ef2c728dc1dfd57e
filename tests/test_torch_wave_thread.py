"""The wave dispatcher on the CPU: submit_wave hands a wave to the engine's
dispatcher thread and returns at once. With the block-iteration program
held on a gate (an event the test opens):

- submit_wave returns before the gate opens, and the wave is not ready;
- the harvested tokens equal decide_wave's on an engine with no gate;
- a set_prefix / set_grammar issued after submit_wave waits until the
  wave is queued and does not change its tokens;
- waves submitted back to back run in FIFO order, each with its own
  tokens, even on one geometry (one set of static buffers);
- a failing dispatch raises BackendError from harvest_wave, never hangs;
- close() joins the dispatcher, a later wave starts a new one, and an
  engine nobody holds lets its dispatcher end.

Every wait is bounded (WAIT_S)."""

import dataclasses
import gc
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu_torch.core.prompt import PromptEngine, pod_suffix
from k8s_llm_scheduler_tpu_torch.engine import constrained as tconstrained
from k8s_llm_scheduler_tpu_torch.engine import engine as engine_mod
from k8s_llm_scheduler_tpu_torch.engine.backend import BackendError
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.testing import (
    cap_torch_threads,
    fixture_pods,
    synthetic_nodes,
)

cap_torch_threads()

WAIT_S = 120.0
JTINY = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TTINY = dataclasses.replace(tconfigs.TINY, dtype=torch.float32)
NAMES = [f"node-{i}" for i in range(4)]
BUDGET = 80


@pytest.fixture(scope="module")
def tparams():
    jp = jinit_params(jax.random.PRNGKey(0), JTINY)
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def prompts():
    """Two prefixes (4 and 5 nodes) and 8 pod suffixes."""
    tok, pe = ByteTokenizer(), PromptEngine()
    prefixes = []
    for n in (4, 5):
        cluster = pe.cluster_part(synthetic_nodes(n))
        prefixes.append(tok.chat_prompt_parts(pe.system_prompt, cluster, "x")[0])
    suffixes = [tok.chat_prompt_parts(pe.system_prompt, "c", pod_suffix(p))[1]
                for p in fixture_pods(8)]
    return prefixes, suffixes


@pytest.fixture(scope="module")
def decided(tparams):
    """decide_wave's tokens on a fresh engine by (prefix, grammar, prompts),
    each computed once for the module: the references several tests hold
    the dispatcher's waves to."""
    memo = {}

    def get(prefix, prompts, grammar=True):
        key = (tuple(prefix), grammar, tuple(map(tuple, prompts)))
        if key not in memo:
            memo[key] = _tokens(_engine(tparams, prefix, grammar).decide_wave(prompts, BUDGET))
        return memo[key]

    return get


def _engine(tparams, prefix, grammar=True):
    tok = ByteTokenizer()
    eng = engine_mod.InferenceEngine(tparams, TTINY, tok, temperature=0.0, graphs=False,
                                     prefill_buckets=(128, 256, 512), prefix_chunk=128)
    eng.set_prefix(prefix)
    if grammar:
        eng.set_grammar(tconstrained.build_decision_dfa(tok, NAMES, max_reason_tokens=12))
    return eng


@pytest.fixture
def gate(monkeypatch):
    """The block-iteration program waits on this event (bounded); open
    until a test clears it."""
    event = threading.Event()
    event.set()
    iterate = engine_mod._WaveVariant._iterate

    def gated(self):
        assert event.wait(timeout=WAIT_S), "the test never opened the gate"
        iterate(self)

    monkeypatch.setattr(engine_mod._WaveVariant, "_iterate", gated)
    yield event
    event.set()


def _tokens(fins):
    return [f.token_ids for f in fins]


def test_submit_returns_before_the_gate_opens_with_decide_waves_tokens(tparams, prompts,
                                                                       gate, decided):
    (p4, _), suffixes = prompts
    want = decided(p4, suffixes[:5])
    gate.clear()
    eng = _engine(tparams, p4)
    handle = eng.submit_wave(suffixes[:5], BUDGET)
    assert not handle.dispatched.is_set() and not handle.is_ready()
    assert eng.stats["waves"] == 1 and eng.stats["wave_block_calls"] == 0
    gate.set()
    assert _tokens(eng.harvest_wave(handle)) == want
    assert handle.is_ready() and handle.iters == eng.stats["wave_model_calls"]
    eng.close()


@pytest.mark.parametrize("switch", ["prefix", "grammar", "both"])
def test_a_later_switch_waits_and_leaves_the_wave_alone(tparams, prompts, gate, decided,
                                                        switch):
    (p4, p5), suffixes = prompts
    want = decided(p4, suffixes[:3])
    gate.clear()
    eng = _engine(tparams, p4)
    handle = eng.submit_wave(suffixes[:3], BUDGET)

    def later():
        if switch in ("prefix", "both"):
            eng.set_prefix(p5)
        if switch in ("grammar", "both"):
            eng.set_grammar(None)

    t = threading.Thread(target=later)
    t.start()
    t.join(timeout=0.3)
    assert t.is_alive(), "the switch ran while the wave was not yet queued"
    gate.set()
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    assert _tokens(eng.harvest_wave(handle)) == want
    # the next wave runs under the switch
    after = _tokens(eng.decide_wave(suffixes[:3], BUDGET))
    assert after == decided(p5 if switch != "grammar" else p4, suffixes[:3],
                            grammar=switch == "prefix")
    eng.close()


@pytest.mark.parametrize("split", [(4, 4), (8, 3), (2, 6)], ids=["same-R", "R8-R4", "R4-R8"])
def test_back_to_back_waves_run_in_order_with_their_own_tokens(tparams, prompts, decided,
                                                               split):
    (p4, _), suffixes = prompts
    a, b = suffixes[:split[0]], suffixes[::-1][:split[1]]
    want = (decided(p4, a), decided(p4, b))
    eng = _engine(tparams, p4)
    ha, hb = eng.submit_wave(a, BUDGET), eng.submit_wave(b, BUDGET)
    order = []
    hb.dispatched.wait(timeout=WAIT_S)
    order.append(ha.dispatched.is_set())  # A was queued before B finished
    assert (_tokens(eng.harvest_wave(ha)), _tokens(eng.harvest_wave(hb))) == want
    assert order == [True] and ha.req_ids[-1] < hb.req_ids[0]
    eng.close()


def test_a_failing_dispatch_raises_from_harvest(tparams, prompts, monkeypatch):
    (p4, _), suffixes = prompts
    eng = _engine(tparams, p4)

    def broken(*args, **kwargs):
        raise RuntimeError("device lost")

    monkeypatch.setattr(eng, "_run_wave", broken)
    handle = eng.submit_wave(suffixes[:2], BUDGET)
    with pytest.raises(BackendError, match="device lost"):
        eng.harvest_wave(handle)
    assert handle.is_ready() and handle.error is not None
    monkeypatch.undo()
    assert len(eng.decide_wave(suffixes[:2], BUDGET)) == 2  # the dispatcher lives on
    eng.close()


def test_close_joins_the_dispatcher_and_a_later_wave_restarts_it(tparams, prompts):
    (p4, _), suffixes = prompts
    eng = _engine(tparams, p4)
    assert eng._dispatcher is None  # started by the first wave
    eng.decide_wave(suffixes[:1], BUDGET)
    first = eng._dispatcher
    assert first.is_alive()
    eng.close()
    assert not first.is_alive() and eng._dispatcher is None
    eng.close()  # idempotent
    assert len(eng.decide_wave(suffixes[:1], BUDGET)) == 1
    assert eng._dispatcher is not first and eng._dispatcher.is_alive()
    eng.close()


def test_an_engine_nobody_holds_stops_its_dispatcher(tparams, prompts):
    (p4, _), suffixes = prompts
    eng = _engine(tparams, p4)
    eng.decide_wave(suffixes[:1], BUDGET)
    thread = eng._dispatcher
    del eng
    gc.collect()
    thread.join(timeout=WAIT_S)
    assert not thread.is_alive()


def test_the_backend_closes_its_engines_dispatcher(tparams, prompts):
    from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend

    (p4, _), _ = prompts
    eng = _engine(tparams, p4)
    backend = LocalLLMBackend(eng, max_new_tokens=BUDGET, request_timeout_s=WAIT_S,
                              prewarm_idle_delay_s=WAIT_S)
    d = backend.get_scheduling_decision(fixture_pods(1)[0], synthetic_nodes(4))
    assert d.selected_node in NAMES
    thread = eng._dispatcher
    assert thread.name == "wave-dispatch" and thread is not threading.current_thread()
    backend.close()
    assert not thread.is_alive() and eng._dispatcher is None
