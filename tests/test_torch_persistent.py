"""The port's persistent serving loop (engine/persistent/) on the CPU, held
against the JAX package's (TINY at 2 layers in f32, the JAX params
converted through numpy; the port's engines with graphs=False, the code a
card captures):

- the port's copies of the rings pass the JAX package's ring cases;
- greedy resident streams are token-identical (exact) to the JAX resident
  loop's, unconstrained and constrained, with the same device counter
  totals; relaunch after exit; an exit mid-stream resumes on the dispatch
  path (step_fused) with an unchanged stream;
- routing: an oversized suffix drains to the dispatch path,
  `persistent_suffix_bucket` widens the limit, the flag off is
  unsupported, and the wedge watchdog latches and finishes on the
  dispatch path;
- the counter block reconciles with the harvest (emitted == decode tokens
  booked); abort_all never leaks parked tokens into a reused slot;
  telemetry off gives an identical stream and reads dark;
- steady state runs no torch op on the owner thread (a thread-local
  dispatch mode counts them) and books no dispatch;
- LocalLLMBackend(persistent_loop=True) serves decisions through the loop,
  the JAX backend's decisions.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from k8s_llm_scheduler_tpu.engine import constrained as jconstrained
from k8s_llm_scheduler_tpu.engine.engine import InferenceEngine as JEngine
from k8s_llm_scheduler_tpu.engine.local import LocalLLMBackend as JBackend
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.types import NodeMetrics as JNodeMetrics
from k8s_llm_scheduler_tpu.types import PodSpec as JPodSpec
from k8s_llm_scheduler_tpu_torch.engine import constrained as tconstrained
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine as TEngine
from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend
from k8s_llm_scheduler_tpu_torch.engine.persistent import (
    OP_ADMIT,
    Command,
    CommandRing,
    HarvestBatch,
    Heartbeat,
    RingFull,
    TokenRing,
)
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.testing import (
    cap_torch_threads,
    fixture_pods,
    synthetic_nodes,
)

cap_torch_threads()

JCFG = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32, n_layers=2)
TCFG = dataclasses.replace(tconfigs.TINY, dtype=torch.float32, n_layers=2)
TOK = ByteTokenizer()
NAMES = ["node-a", "node-b2"]
ENGINE = dict(num_pages=128, page_size=16, max_slots=4, max_pages_per_seq=16,
              prefill_buckets=(32, 64, 128, 256, 512), chunk_steps=4, temperature=0.0,
              prefix_chunk=64, persistent_loop=True)
WAIT_S = 120.0


@pytest.fixture(scope="module")
def params():
    jp = jinit_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def t_engine(params, **kw):
    return TEngine(params[1], TCFG, TOK, graphs=False, **{**ENGINE, **kw})


def j_engine(params, **kw):
    return JEngine(params[0], JCFG, JByteTokenizer(), **{**ENGINE, **kw})


def drain_persistent(engine, n):
    out = {}
    deadline = time.monotonic() + WAIT_S
    while len(out) < n:
        assert time.monotonic() < deadline, "persistent serving wedged"
        for fin in engine.step_persistent(timeout_s=0.05):
            out[fin.req_id] = fin.token_ids
    return out


def drain_fused(engine, n):
    out = {}
    deadline = time.monotonic() + WAIT_S
    while len(out) < n:
        assert time.monotonic() < deadline, "fused decode wedged"
        for fin in engine.step_fused():
            out[fin.req_id] = fin.token_ids
    return out


def make_batch(slots=4, steps=2):
    return HarvestBatch(
        seq=-1, emitted=np.full((slots, steps), -1, dtype=np.int32), steps_run=steps,
        act=np.zeros(slots, dtype=bool), budget=np.zeros(slots, dtype=np.int32),
        pos=np.zeros(slots, dtype=np.int32), admit_slot=-1, first_tok=0,
    )


def wait_emitted(engine, out):
    """Step the ring until the loop has run at least one decode step."""
    deadline = time.monotonic() + WAIT_S
    while engine.stats["persistent_steps"] < 1:
        assert time.monotonic() < deadline, "loop never emitted"
        for fin in engine.step_persistent(timeout_s=0.05):
            out[fin.req_id] = fin.token_ids


# ------------------------------------------------------------- ring plane
class TestCommandRing:
    def test_backpressure_times_out_loudly(self):
        ring = CommandRing(capacity=2)
        ring.put(Command(op=OP_ADMIT, slot=0), timeout_s=0.1)
        ring.put(Command(op=OP_ADMIT, slot=1), timeout_s=0.1)
        with pytest.raises(RingFull):
            ring.put(Command(op=OP_ADMIT, slot=2), timeout_s=0.05)
        assert ring.stalls == 1 and ring.enqueued == 2

    def test_blocked_put_unblocks_when_loop_drains(self):
        ring = CommandRing(capacity=1)
        ring.put(Command(op=OP_ADMIT, slot=0))
        taken = []

        def consumer():
            time.sleep(0.05)
            taken.append(ring.take())

        t = threading.Thread(target=consumer)
        t.start()
        ring.put(Command(op=OP_ADMIT, slot=1), timeout_s=5.0)
        t.join(timeout=5.0)
        assert not t.is_alive()
        assert taken[0].slot == 0 and ring.take().slot == 1 and ring.take() is None
        assert ring.stalls == 1

    def test_wait_nonempty_parks_and_wakes(self):
        ring = CommandRing(capacity=4)
        t0 = time.monotonic()
        assert ring.wait_nonempty(0.02) is False
        assert time.monotonic() - t0 >= 0.015
        ring.put(Command(op=OP_ADMIT, slot=0))
        assert ring.wait_nonempty(0.02) is True


class TestTokenRing:
    def test_seq_assigned_and_verified_in_order(self):
        ring = TokenRing(capacity=8)
        for _ in range(3):
            assert ring.put(make_batch()) is True
        assert [b.seq for b in ring.drain()] == [0, 1, 2]
        assert ring.pushed == 3

    def test_lost_batch_is_a_loud_protocol_error(self):
        ring = TokenRing(capacity=8)
        ring.put(make_batch())
        with ring._cond:
            ring._items.clear()  # batch 0 vanishes without the take cursor moving
        ring.put(make_batch())
        with pytest.raises(RuntimeError, match="sequence break"):
            ring.drain()

    def test_full_ring_blocks_the_push_until_harvest(self):
        ring = TokenRing(capacity=1)
        ring.put(make_batch())
        done = []
        t = threading.Thread(target=lambda: done.append(ring.put(make_batch())))
        t.start()
        time.sleep(0.05)
        assert not done  # emission backpressure: the push is parked
        first = ring.drain()
        t.join(timeout=5.0)
        assert not t.is_alive() and done == [True]
        assert [b.seq for b in first] == [0] and [b.seq for b in ring.drain()] == [1]
        assert ring.stalls == 1

    def test_stop_check_unwedges_a_parked_push(self):
        ring = TokenRing(capacity=1)
        ring.put(make_batch())
        assert ring.put(make_batch(), stop_check=lambda: True) is False

    def test_clear_parked_advances_cursor_not_breaks_seq(self):
        ring = TokenRing(capacity=8)
        for _ in range(3):
            ring.put(make_batch())
        assert ring.clear_parked() == 3
        ring.put(make_batch())
        assert [b.seq for b in ring.drain()] == [3]

    def test_heartbeat_wedge_detection(self):
        hb = Heartbeat()
        hb.beat()
        assert hb.beats == 1 and not hb.wedged(5.0) and hb.wedged(-1.0)


# ------------------------------------------------ token identity vs JAX
@pytest.mark.parametrize("grammar", [False, True], ids=["free", "grammar"])
def test_resident_streams_and_counters_equal_the_jax_loop(params, grammar):
    prompts = [TOK.encode(t) for t in ("pod-a needs a node", "pod-b second line", "p-c")]
    budget = 60 if grammar else 10
    results = []
    for eng, build in ((j_engine(params), jconstrained), (t_engine(params), tconstrained)):
        if grammar:
            eng.set_grammar(build.build_decision_dfa(
                JByteTokenizer() if build is jconstrained else TOK, NAMES,
                max_reason_tokens=6))
        eng.set_prefix(TOK.encode("CLUSTER STATE: node-a cpu=10 node-b2 cpu=11"))
        assert eng.enter_persistent()
        ids = eng.add_requests(prompts, max_new_tokens=budget)
        out = drain_persistent(eng, len(prompts))
        eng.exit_persistent()
        totals = eng.persistent_counter_totals()
        results.append(([out[i] for i in ids],
                        # the counters that do not depend on the host's timing
                        {k: totals[k] for k in ("steps", "admits", "emitted")},
                        {k: eng.stats[k] for k in ("persistent_admissions",
                                                   "persistent_steps", "decode_tokens",
                                                   "persistent_launches")}))
    assert results[1] == results[0]  # streams, counter block and books: exact
    if grammar:
        assert TOK.decode(results[1][0][0]).startswith('{"selected_node": ')


def test_relaunch_and_exit_mid_stream_resume_on_the_dispatch_path(params):
    eng = t_engine(params)
    eng.set_prefix(TOK.encode("relaunch prefix"))
    prompt = TOK.encode("pod-swap request")
    serial = eng.generate(prompt, max_new_tokens=40).token_ids
    assert eng.enter_persistent()
    (rid,) = eng.add_requests([prompt], max_new_tokens=40)
    out = {}
    wait_emitted(eng, out)
    eng.exit_persistent()  # mid-stream
    assert not eng.persistent_active
    for fin in eng.step_persistent(timeout_s=0.0):
        out[fin.req_id] = fin.token_ids
    if rid not in out:
        out.update(drain_fused(eng, 1))
    assert out[rid] == serial
    short = eng.generate(prompt, max_new_tokens=8).token_ids
    for _ in range(2):
        assert eng.enter_persistent()
        (rid,) = eng.add_requests([prompt], max_new_tokens=8)
        assert drain_persistent(eng, 1)[rid] == short
        eng.exit_persistent()
    assert eng.stats["persistent_launches"] == 3


# -------------------------------------------------------- fallback routing
def test_oversized_suffix_drains_the_loop_to_the_dispatch_path(params):
    eng = t_engine(params)  # admission bucket = prefill_buckets[0] = 32
    eng.set_prefix(TOK.encode("fallback prefix"))
    prompts = [TOK.encode("pod-small"), TOK.encode("p" * 40)]
    serial = [eng.generate(p, max_new_tokens=8).token_ids for p in prompts]
    assert eng.enter_persistent()
    ids = eng.add_requests(prompts, max_new_tokens=8)
    assert not eng.persistent_active
    assert eng.stats["persistent_fallbacks"] == 1 and eng.stats["persistent_admissions"] == 0
    out = drain_fused(eng, 2)
    assert [out[i] for i in ids] == serial


def test_suffix_bucket_widens_the_ring_limit(params):
    eng = t_engine(params, persistent_suffix_bucket=64)
    eng.set_prefix(TOK.encode("wide bucket prefix"))
    prompt = TOK.encode("p" * 40)  # fits 64, not the default 32
    serial = eng.generate(prompt, max_new_tokens=8).token_ids
    assert eng.enter_persistent()
    assert eng.persistent_suffix_limit(8) >= 40
    (rid,) = eng.add_requests([prompt], max_new_tokens=8)
    assert eng.persistent_active
    assert drain_persistent(eng, 1)[rid] == serial
    eng.exit_persistent()
    assert eng.stats["persistent_fallbacks"] == 0


def test_flag_off_is_unsupported(params):
    eng = t_engine(params, persistent_loop=False)
    assert eng.persistent_supported() is False
    assert eng.enter_persistent() is False and not eng.persistent_active


def test_wedge_watchdog_latches_and_finishes_on_the_dispatch_path(params):
    eng = t_engine(params)
    eng.set_prefix(TOK.encode("wedge prefix"))
    prompt = TOK.encode("pod-wedge")
    serial = eng.generate(prompt, max_new_tokens=16).token_ids
    assert eng.enter_persistent()
    (rid,) = eng.add_requests([prompt], max_new_tokens=16)
    out = {}
    wait_emitted(eng, out)
    eng._persistent.wedge_timeout_s = -1.0  # any idle time now reads as wedged
    for fin in eng.step_persistent(timeout_s=0.0):
        out[fin.req_id] = fin.token_ids
    assert eng.stats["persistent_wedges"] == 1 and not eng.persistent_active
    assert eng.persistent_supported() is False and eng.enter_persistent() is False
    if rid not in out:
        out.update(drain_fused(eng, 1))
    assert out[rid] == serial
    assert eng.persistent_blackbox()["reason"] == "wedge"


# ------------------------------------------- books, abort and telemetry
def test_counter_totals_reconcile_exactly_with_the_harvest(params):
    eng = t_engine(params)
    eng.set_prefix(TOK.encode("reconcile prefix"))
    prompts = [TOK.encode(t) for t in ("pod-a", "pod-b extra", "pod-c three")]
    assert eng.enter_persistent()
    tok0, step0 = eng.stats["decode_tokens"], eng.stats["persistent_steps"]
    eng.add_requests(prompts, max_new_tokens=9)
    drain_persistent(eng, len(prompts))
    eng.exit_persistent()
    totals = eng.persistent_counter_totals()
    assert totals["emitted"] == eng.stats["decode_tokens"] - tok0
    assert totals["steps"] == eng.stats["persistent_steps"] - step0
    assert totals["admits"] == len(prompts) and totals["iters"] >= totals["admits"]
    assert eng.persistent_blackbox()["reason"] == "quiesce"


def test_abort_all_never_leaks_parked_tokens_into_slot_reuse(params):
    eng = t_engine(params)
    eng.set_prefix(TOK.encode("abort prefix"))
    after = TOK.encode("pod-after abort")
    serial = eng.generate(after, max_new_tokens=10).token_ids
    assert eng.enter_persistent()
    eng.add_requests([TOK.encode("pod-doomed")], max_new_tokens=30)
    srv = eng._persistent
    deadline = time.monotonic() + WAIT_S
    while srv.tokens.qsize() == 0:  # emissions park, un-harvested
        assert time.monotonic() < deadline, "loop never emitted"
        time.sleep(0.005)
    eng.abort_all()
    assert eng.free_slots == eng.max_slots and eng.persistent_active
    (rid,) = eng.add_requests([after], max_new_tokens=10)
    out = drain_persistent(eng, 1)
    eng.exit_persistent()
    assert out[rid] == serial


def test_telemetry_off_is_stream_identical_and_dark(params):
    eng = t_engine(params, persistent_telemetry=False)
    eng.set_prefix(TOK.encode("dark prefix"))
    prompt = TOK.encode("pod-dark request")
    serial = eng.generate(prompt, max_new_tokens=10).token_ids
    assert eng.enter_persistent()
    (rid,) = eng.add_requests([prompt], max_new_tokens=10)
    assert drain_persistent(eng, 1)[rid] == serial
    eng.exit_persistent()
    assert eng.persistent_blackbox() is None
    assert eng.persistent_counter_totals()["emitted"] == 0
    st = eng.get_stats()
    assert st["persistent_telemetry"] is False and st["persistent_stats_published"] == 0


class _OpCounter(TorchDispatchMode):
    """Counts the torch ops run on the thread that entered it (dispatch
    modes are thread-local)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_steady_state_runs_no_torch_op_on_the_owner_thread(params):
    eng = t_engine(params)
    eng.set_prefix(TOK.encode("zero dispatch prefix"))
    prompts = [TOK.encode("pod-a"), TOK.encode("pod-b request")]
    serial = [eng.generate(p, max_new_tokens=12).token_ids for p in prompts]
    assert eng.enter_persistent()
    base = eng.stats["dispatches"]
    with _OpCounter() as counter:
        ids = eng.add_requests(prompts, max_new_tokens=12)
        out = drain_persistent(eng, 2)
    assert counter.ops == []  # admission and harvest are ring traffic
    assert eng.stats["dispatches"] == base
    assert [out[i] for i in ids] == serial
    assert eng._persistent.stats()["persistent_heartbeats"] > 0
    eng.exit_persistent()


# --------------------------------------------------- worker-plane serving
def test_backend_serves_decisions_through_the_resident_loop_like_jax(params):
    pods, nodes = fixture_pods(2), synthetic_nodes(3)
    kw = dict(persistent_suffix_bucket=512, num_pages=256, max_pages_per_seq=32)
    jeng, teng = j_engine(params, **kw), t_engine(params, **kw)
    bkw = dict(max_new_tokens=80, persistent_loop=True, request_timeout_s=600.0,
               prewarm_idle_delay_s=600.0)
    # each backend closed as soon as it has decided: an idle JAX residency
    # fills its token ring with empty batches until its quiesce stalls
    jb = JBackend(jeng, tokenizer=JByteTokenizer(), **bkw)
    try:
        want = [jb.get_scheduling_decision(JPodSpec(**dataclasses.asdict(p)),
                                           [JNodeMetrics(**dataclasses.asdict(n))
                                            for n in nodes]) for p in pods]
    finally:
        jb.close()
    assert not jeng.persistent_active
    tb = LocalLLMBackend(teng, tokenizer=TOK, **bkw)
    try:
        got = [tb.get_scheduling_decision(p, nodes) for p in pods]
    finally:
        tb.close()
    assert [(d.selected_node, d.reasoning) for d in got] == [
        (d.selected_node, d.reasoning) for d in want]
    assert all(d.selected_node in {n.name for n in nodes} for d in got)
    assert teng.stats["persistent_admissions"] == len(pods)
    assert teng.stats["persistent_fallbacks"] == 0 and teng.stats["waves"] == 0
    assert not teng.persistent_active  # close() exits the loop
