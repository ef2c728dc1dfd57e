"""The decision backend's wave worker, held against the JAX package's: the
same scenarios, with the same assertions, run against the JAX
LocalLLMBackend and the port's, each over a fake engine whose waves finish
only when the test releases them. Assertions are on the order of events
(which wave held which items, whether a hold shipped before a harvest),
never on tight wall-clock bounds.

Scenarios (from the JAX package's tests/test_local_worker.py, without its
pool-role and prepack cases, which the port has not): a prewarm under load
is dropped; stale prewarms collapse to the latest; a lying is_ready still
resolves at wave completion; a held ragged tail ships before the harvest;
a full wave submits during flight; group switches under load wait for
group_switch_after_s; a quiesced control runs at the wave barrier.
"""

import contextlib
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest

from k8s_llm_scheduler_tpu import types as jtypes
from k8s_llm_scheduler_tpu.engine.local import LocalLLMBackend as JBackend
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu_torch import types as ttypes
from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend as TBackend
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer as TByteTokenizer
from k8s_llm_scheduler_tpu_torch.testing import cap_torch_threads

cap_torch_threads()

WAIT_S = 30.0  # generous bound on every wait for an event
NEVER_S = 1e6  # an EMA or fairness bound no test run reaches

SIDES = {
    "jax": SimpleNamespace(backend=JBackend, tokenizer=JByteTokenizer, types=jtypes),
    "torch": SimpleNamespace(backend=TBackend, tokenizer=TByteTokenizer, types=ttypes),
}

DECISION = json.dumps(
    {"selected_node": "node-1", "confidence": 0.9, "reasoning": "stub"}
)


@pytest.fixture(params=sorted(SIDES))
def side(request):
    return SIDES[request.param]


def make_nodes(side, n=3):
    return [
        side.types.NodeMetrics(
            name=f"node-{i}", cpu_usage_percent=10.0 * i,
            memory_usage_percent=10.0 * i, available_cpu_cores=8.0,
            available_memory_gb=32.0, pod_count=i, max_pods=110,
            labels={}, taints=(), conditions={"Ready": "True"},
        )
        for i in range(n)
    ]


def make_pod(side, i):
    return side.types.PodSpec(
        name=f"p{i}", namespace="default", cpu_request=0.1 + 0.01 * i,
        memory_request=0.125, node_selector={}, tolerations=(), priority=0,
    )


def wait_for(pred, what):
    end = time.monotonic() + WAIT_S
    while not pred():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


class FakeHandle:
    def __init__(self, n, index):
        self.n = n
        self.index = index
        self.submitted_at = time.perf_counter()
        self.released = threading.Event()
        self.cold_compile = False
        self.geo_key = ("fake", n)

    def is_ready(self):
        return self.released.is_set()


class LyingHandle(FakeHandle):
    """is_ready never fires: readiness that tracks something other than
    this wave's completion."""

    def is_ready(self):
        return False


class FakeEngine:
    """Logs every call in order; a wave completes when the test releases it
    (or at once with `auto_release`); harvest_wave blocks until then, as a
    real harvest returns at the wave's true completion."""

    max_slots = 4
    prefill_buckets = (4096,)

    def __init__(self, handle_cls=FakeHandle):
        self.handle_cls = handle_cls
        self.handles: list[FakeHandle] = []
        self.log: list[tuple] = []
        self.auto_release = False
        self._lock = threading.Lock()

    def _note(self, *event):
        with self._lock:
            self.log.append(event)

    def count(self, kind):
        with self._lock:
            return sum(1 for e in self.log if e[0] == kind)

    def index(self, event):
        with self._lock:
            return self.log.index(event)

    @property
    def submits(self):
        with self._lock:
            return [e[2] for e in self.log if e[0] == "submit"]

    def set_prefix(self, ids):
        self._note("prefix")

    def set_grammar(self, dfa):
        self._note("grammar")

    def submit_wave(self, prompts, max_new_tokens):
        h = self.handle_cls(len(prompts), len(self.handles))
        self.handles.append(h)
        if self.auto_release:
            h.released.set()
        self._note("submit", h.index, len(prompts))
        return h

    def release_all(self):
        self.auto_release = True
        for h in list(self.handles):
            h.released.set()

    def harvest_wave(self, h):
        self._note("harvest_start", h.index)
        if not h.released.wait(WAIT_S):
            raise RuntimeError("wave never released")
        self._note("harvest", h.index)
        return [SimpleNamespace(text=DECISION, token_ids=[1, 2]) for _ in range(h.n)]

    def get_stats(self):
        return {}

    def prewarm_wave_siblings(self, limit=None):
        return 0


@contextlib.contextmanager
def worker_held(backend, pool):
    """Park the engine-owner thread inside a quiesced control, so that
    everything the block enqueues reaches the worker in one tick."""
    entered, release = threading.Event(), threading.Event()

    def fn():
        entered.set()
        release.wait(WAIT_S)

    done = pool.submit(backend.run_quiesced, fn, WAIT_S)
    assert entered.wait(WAIT_S)
    try:
        yield
    finally:
        release.set()
    done.result(WAIT_S)


def decide(pool, backend, side, ids, nodes):
    return [pool.submit(backend.get_scheduling_decision, make_pod(side, i), nodes)
            for i in ids]


def first_wave_of_four(backend, eng, side, pool, nodes):
    """Four decisions in one full wave, left in flight."""
    with worker_held(backend, pool):
        futs = decide(pool, backend, side, range(4), nodes)
        wait_for(lambda: backend._queue.qsize() >= 4, "four queued decisions")
    wait_for(lambda: eng.submits == [4], "the first wave")
    return futs


def assert_all_decided(futs):
    for f in futs:
        d = f.result(WAIT_S) if hasattr(f, "result") else f
        assert d.selected_node == "node-1"


def test_prewarm_under_load_is_dropped(side):
    eng = FakeEngine()
    backend = side.backend(eng, tokenizer=side.tokenizer(), max_new_tokens=160,
                           admit_wait_s=0.001)
    backend._wave_ema_default = NEVER_S  # the poll ends only at readiness
    try:
        with ThreadPoolExecutor(8) as pool:
            real = decide(pool, backend, side, range(4), make_nodes(side))
            wait_for(lambda: eng.submits, "a wave in flight")
            warm = backend.prewarm_prefix(make_nodes(side, 4))
            assert warm.result(WAIT_S) is False
            assert eng.count("prefix") == 1  # the real group only
            eng.release_all()
            assert_all_decided(real)
        # idle now: the same advisory installs
        assert backend.prewarm_prefix(make_nodes(side, 4)).result(WAIT_S) is True
        assert eng.count("prefix") == 2
    finally:
        backend.close()


def test_stale_prewarms_collapse_to_the_latest(side):
    eng = FakeEngine()
    backend = side.backend(eng, tokenizer=side.tokenizer(), max_new_tokens=160)
    try:
        with ThreadPoolExecutor(2) as pool:
            with worker_held(backend, pool):
                futs = [backend.prewarm_prefix(make_nodes(side, 2 + i)) for i in range(3)]
            assert [f.result(WAIT_S) for f in futs] == [False, False, True]
        assert eng.count("prefix") == 1
        latest = backend._prepare_prewarm(make_nodes(side, 4))
        assert backend._current_group == latest.group_key
    finally:
        backend.close()


def test_lying_is_ready_still_resolves_at_wave_completion(side):
    eng = FakeEngine(handle_cls=LyingHandle)
    backend = side.backend(eng, tokenizer=side.tokenizer(), max_new_tokens=160,
                           partial_hold_s=0.01, admit_wait_s=0.001)
    try:
        with ThreadPoolExecutor(2) as pool:
            (fut,) = decide(pool, backend, side, [0], make_nodes(side))
            # the poll gives up on is_ready at its EMA deadline and the
            # worker harvests blockingly, before the wave has completed
            wait_for(lambda: eng.count("harvest_start") == 1, "a blocking harvest")
            assert not fut.done()
            eng.release_all()
            assert_all_decided([fut])
    finally:
        backend.close()


def test_held_tail_ships_before_the_wave_harvest(side):
    eng = FakeEngine()
    backend = side.backend(eng, tokenizer=side.tokenizer(), max_new_tokens=160,
                           partial_hold_s=0.2, admit_wait_s=0.001)
    backend._wave_ema_default = NEVER_S
    try:
        nodes = make_nodes(side)
        with ThreadPoolExecutor(8) as pool:
            first = first_wave_of_four(backend, eng, side, pool, nodes)
            tail = pool.submit(backend.get_scheduling_decisions_batch,
                               [make_pod(side, 10), make_pod(side, 11)], nodes)
            # wave 1 is never released before the tail ships: only the
            # hold's deadline can send it, as one wave of both stragglers
            wait_for(lambda: len(eng.submits) == 2, "the tail's wave")
            assert eng.submits == [4, 2]
            assert eng.count("harvest_start") == 0
            eng.release_all()
            assert_all_decided(first + list(tail.result(WAIT_S)))
    finally:
        backend.close()


def test_full_wave_submits_during_flight(side):
    eng = FakeEngine()
    backend = side.backend(eng, tokenizer=side.tokenizer(), max_new_tokens=160,
                           partial_hold_s=NEVER_S, admit_wait_s=0.01)
    backend._wave_ema_default = NEVER_S
    try:
        nodes = make_nodes(side)
        with ThreadPoolExecutor(10) as pool:
            first = first_wave_of_four(backend, eng, side, pool, nodes)
            second = decide(pool, backend, side, range(20, 24), nodes)
            # a partial never ships under this hold: the second wave goes
            # out full, while the first is still in flight
            wait_for(lambda: len(eng.submits) == 2, "the second wave")
            assert eng.submits == [4, 4]
            assert eng.count("harvest_start") == 0
            eng.release_all()
            assert_all_decided(first + second)
    finally:
        backend.close()


@pytest.mark.parametrize("switch_after", [0.05, NEVER_S])
def test_group_switch_under_load_waits_for_its_fairness_bound(side, switch_after):
    eng = FakeEngine()
    backend = side.backend(eng, tokenizer=side.tokenizer(), max_new_tokens=160,
                           group_switch_after_s=switch_after, partial_hold_s=0.0,
                           admit_wait_s=0.001)
    backend._wave_ema_default = NEVER_S
    try:
        with ThreadPoolExecutor(4) as pool:
            a = decide(pool, backend, side, [0], make_nodes(side, 3))
            wait_for(lambda: eng.submits == [1], "group A's wave")
            b = decide(pool, backend, side, [1], make_nodes(side, 4))
            if switch_after < NEVER_S:
                # B's oldest item outwaits the bound: the switch happens
                # with A's wave still in flight
                wait_for(lambda: len(eng.submits) == 2, "group B's wave")
                assert eng.count("harvest_start") == 0
            else:
                wait_for(lambda: backend._queue.qsize() == 0, "B drained")
                time.sleep(0.2)
                assert eng.submits == [1]  # B waits for A's harvest
            eng.release_all()
            assert_all_decided(a + b)
        assert eng.count("prefix") == 2
        if switch_after == NEVER_S:
            assert eng.index(("harvest", 0)) < eng.index(("submit", 1, 1))
    finally:
        backend.close()


def test_quiesced_control_runs_at_the_wave_barrier(side):
    eng = FakeEngine()
    backend = side.backend(eng, tokenizer=side.tokenizer(), max_new_tokens=160,
                           partial_hold_s=0.0, admit_wait_s=0.001)
    backend._wave_ema_default = NEVER_S
    try:
        nodes = make_nodes(side)
        with ThreadPoolExecutor(4) as pool:
            a = decide(pool, backend, side, [0], nodes)
            wait_for(lambda: eng.submits == [1], "a wave in flight")
            ctl = pool.submit(backend.run_quiesced, lambda: eng._note("control"), WAIT_S)
            wait_for(lambda: backend._queue.qsize() == 0, "the control drained")
            c = decide(pool, backend, side, [1], nodes)
            wait_for(lambda: backend._queue.qsize() == 0, "the decision drained")
            assert eng.submits == [1] and eng.count("control") == 0  # held
            eng.release_all()
            result, pause_s = ctl.result(WAIT_S)
            assert result is None and pause_s > 0
            assert_all_decided(a + c)
        assert eng.index(("harvest", 0)) < eng.index(("control",)) < eng.index(("submit", 1, 1))
        assert backend.swap_stats["quiesce_runs"] == 1
        # the control dropped the group: the next wave reinstalled it
        assert eng.count("prefix") == 2
    finally:
        backend.close()
