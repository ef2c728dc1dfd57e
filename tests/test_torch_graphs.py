"""The port's wave and decode chunk over static buffers (the code a card
captures as CUDA graphs, here run eagerly with graphs=False on the CPU)
held against the JAX engine: token for token (TINY in f32, greedy), the
iterations a wave runs and each model call's valid tokens, the wave-variant
bookkeeping and sibling prewarm, a switch between two cached prefixes of
one buffer length, and decode chunks with their state updated in place.
"""

import dataclasses
import time

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
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.core import prompt as tprompt
from k8s_llm_scheduler_tpu_torch.engine import constrained as tconstrained
from k8s_llm_scheduler_tpu_torch.engine import graphs as tgraphs
from k8s_llm_scheduler_tpu_torch.engine.backend import BackendError
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine as TEngine
from k8s_llm_scheduler_tpu_torch.engine.local import LocalLLMBackend
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax

ttesting.cap_torch_threads()

JTINY = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TTINY = dataclasses.replace(tconfigs.TINY, dtype=torch.float32)
NAMES = [f"node-{i}" for i in range(4)]
WAVE = dict(max_slots=8, prefill_buckets=(128, 256, 512), temperature=0.0,
            prefix_chunk=128)


@pytest.fixture(scope="module")
def tiny_params():
    jp = jinit_params(jax.random.PRNGKey(0), JTINY)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def cluster_prompts():
    """(shared prefix, 8 pod suffixes) for a 4-node cluster."""
    tok = ByteTokenizer()
    pe = tprompt.PromptEngine()
    cluster = pe.cluster_part(ttesting.synthetic_nodes(4))
    pods = ttesting.fixture_pods(8)
    parts = [tok.chat_prompt_parts(pe.system_prompt, cluster, tprompt.pod_suffix(p))
             for p in pods]
    return parts[0][0], [s for _, s in parts]


def _engines(tiny_params, grammar: bool, **kw):
    jp, tp = tiny_params
    jtok, ttok = JByteTokenizer(), ByteTokenizer()
    jeng = JEngine(jp, JTINY, jtok, num_pages=16, page_size=64, max_pages_per_seq=8,
                   **{**WAVE, **kw})
    teng = TEngine(tp, TTINY, ttok, graphs=False, **{**WAVE, **kw})
    if grammar:
        jeng.set_grammar(jconstrained.build_decision_dfa(jtok, NAMES, max_reason_tokens=12))
        teng.set_grammar(tconstrained.build_decision_dfa(ttok, NAMES, max_reason_tokens=12))
    return jeng, teng


def _wave_inputs(eng, prompts, budgets):
    """The engine's wave geometry and padded inputs for `prompts` with a
    budget each (the wave programs take a budget a row; submit_wave gives
    every row the same)."""
    cap = max(budgets)
    bucket = eng._bucket_for(max(len(p) for p in prompts))
    R, n_iters, F = eng._wave_geometry(len(prompts), cap)
    tokens = np.full((R, bucket), eng.tokenizer.pad_id, dtype=np.int32)
    suffix_lens = np.zeros(R, dtype=np.int32)
    max_new = np.zeros(R, dtype=np.int32)
    for row, (ids, budget) in enumerate(zip(prompts, budgets)):
        tokens[row, : len(ids)] = ids
        suffix_lens[row] = len(ids)
        max_new[row] = budget
    return (R, bucket, n_iters, F, cap), (tokens, suffix_lens, max_new)


def _jax_wave(jeng, prompts, budgets):
    """(tokens [R, n_iters*F], iterations run, valid tokens of each call) of
    the JAX engine's one-program wave (_wave_impl, jit'd); a call's valid
    tokens are its block's non-pad emissions."""
    (R, bucket, n_iters, F, cap), (tokens, suffix_lens, max_new) = _wave_inputs(
        jeng, prompts, budgets)
    pfx = jeng._prefix
    out, _, iters = jeng._wave(
        jeng.params, jeng.cfg, jnp.asarray(tokens), jnp.asarray(suffix_lens),
        pfx.k, pfx.v, jnp.int32(pfx.length), jnp.asarray(max_new),
        jeng._sp_tokens, jeng._sp_next, jeng._forced, jeng._forced_next,
        jeng._done_state, jnp.int32(jeng.tokenizer.eos_id),
        jnp.int32(jeng.tokenizer.pad_id), jnp.int32(jeng._dfa_start),
        jax.random.PRNGKey(0), jnp.float32(0.0), n_iters, F, cap, jeng._constrained,
    )
    out, iters = np.asarray(out), int(iters)
    pad = jeng.tokenizer.pad_id
    counts = [int((out[:, i * F:(i + 1) * F] != pad).sum()) for i in range(iters)]
    return out, iters, counts


@pytest.mark.parametrize(
    "grammar,budgets",
    [(True, [90] * 3), (True, [90, 40, 65, 90, 25, 70]),
     (False, [8] * 3), (False, [7, 3, 5, 6, 2, 4])],
    ids=["grammar-R4", "grammar-R8-rows-end-apart", "free-R4-to-n_iters",
         "free-R8-rows-end-apart"],
)
def test_wave_matches_the_jax_one_program_wave(tiny_params, cluster_prompts, grammar,
                                               budgets):
    """The static-buffer wave (a suffix-prefill program, then one block
    iteration at a time with the liveness flag read one iteration behind)
    emits the JAX _wave_impl's tokens, runs its iterations and books each
    call's valid tokens. With budgets apart the rows finish at different
    iterations; a wave that ends before n_iters runs one iteration past its
    last live one (pads only, not counted); a free-running wave whose rows
    all run to the budget runs to n_iters."""
    prefix, suffixes = cluster_prompts
    prompts = suffixes[: len(budgets)]
    jeng, teng = _engines(tiny_params, grammar)
    for eng in (jeng, teng):
        eng.set_prefix(prefix)
    want, want_iters, want_counts = _jax_wave(jeng, prompts, budgets)
    (R, bucket, n_iters, F, cap), inputs = _wave_inputs(teng, prompts, budgets)
    assert R == (4 if len(budgets) <= 4 else 8)

    key = teng._wave_key(R, bucket, n_iters, F, cap)
    _, toks_h, counts_h, iters, done = teng._run_wave(key, R, bucket, n_iters, F, cap,
                                                      *inputs)
    done.synchronize()
    got = toks_h.numpy()
    np.testing.assert_array_equal(got, want)
    assert iters == want_iters
    assert counts_h[:iters].tolist() == want_counts
    ends = {int(np.nonzero(got[r] != teng.tokenizer.pad_id)[0].max()) // F
            for r in range(len(budgets))}
    assert (len(ends) > 1) == (len(set(budgets)) > 1)
    if len(set(budgets)) > 1 or grammar:
        assert iters < n_iters
        assert teng.stats["wave_block_calls"] == iters + 1
    else:
        assert iters == n_iters
        assert teng.stats["wave_block_calls"] == n_iters


def test_submit_and_harvest_match_the_jax_engine(tiny_params, cluster_prompts):
    """submit_wave / harvest_wave: the JAX engine's tokens, iterations and
    handle books (cold_compile, geo_key), and the valid tokens of each call
    booked at harvest."""
    prefix, suffixes = cluster_prompts
    jeng, teng = _engines(tiny_params, True)
    for eng in (jeng, teng):
        eng.set_prefix(prefix)
    jh = jeng.submit_wave(suffixes[:5], 90)
    want = jeng.harvest_wave(jh)
    th = teng.submit_wave(suffixes[:5], 90)
    assert (th.cold_compile, th.geo_key) == (jh.cold_compile, jh.geo_key)
    # submit_wave returns at once; the wave is ready once dispatched
    assert th.dispatched.wait(timeout=600) and th.is_ready()
    got = teng.harvest_wave(th)
    assert [f.token_ids for f in got] == [f.token_ids for f in want]
    assert th.iters == int(jh.iters_d) == teng.stats["wave_model_calls"]
    assert sum(teng.block_tokens) == sum(len(f.token_ids) for f in got)


def test_wave_bookkeeping_and_prewarm_match_jax(tiny_params, cluster_prompts):
    """_wave_key, the compiled keys, the shapes seen, _missing_wave_siblings
    and wave_prewarm_backlog after the same submit_wave calls; then
    prewarm_wave_siblings drains the backlog on both, and a wave of the
    prewarmed geometry finds it warm."""
    prefix, suffixes = cluster_prompts
    jeng, teng = _engines(tiny_params, True)
    handles = {"jax": [], "torch": []}
    for eng, name in ((jeng, "jax"), (teng, "torch")):
        eng.set_prefix(prefix)
        for prompts, max_new in ((suffixes[:2], 90), (suffixes[:6], 90), (suffixes[:1], 80)):
            handles[name].append(eng.submit_wave(prompts, max_new))

    def books(eng):
        return (sorted(eng._wave_compiled), sorted(eng._wave_shapes_seen),
                sorted(eng._missing_wave_siblings()), eng.wave_prewarm_backlog())

    teng._await_dispatch()  # a geometry is booked once the dispatcher queued its wave
    assert books(teng) == books(jeng)
    assert [h.geo_key for h in handles["torch"]] == [h.geo_key for h in handles["jax"]]
    assert [h.cold_compile for h in handles["torch"]] == [True, True, True]
    assert teng.wave_prewarm_backlog() == 1  # R=8 at max_new 80
    assert teng._wave_key(8, 256, 12, 24, 80) == jeng._wave_key(8, 256, 12, 24, 80)

    assert teng.prewarm_wave_siblings() == jeng.prewarm_wave_siblings() == 1
    assert books(teng) == books(jeng)
    assert teng.wave_prewarm_backlog() == 0
    assert teng.stats["wave_prewarms"] == 1 and teng.stats["wave_prewarm_failures"] == 0
    warm = teng.submit_wave(suffixes[:8], 80)
    assert not warm.cold_compile
    assert teng.stats["dispatches"] == 1 + 4  # the prefix prefill, four waves


def test_failed_prewarm_is_recorded_and_stays_cold(tiny_params, cluster_prompts,
                                                   monkeypatch):
    prefix, suffixes = cluster_prompts
    _, teng = _engines(tiny_params, True)
    teng.set_prefix(prefix)
    teng.decide_wave(suffixes[:2], 90)

    def broken(*args, **kwargs):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(teng, "_run_wave", broken)
    assert teng.prewarm_wave_siblings() == 0
    assert teng.stats["wave_prewarm_failures"] == 1
    assert teng.wave_prewarm_backlog() == 0  # excluded, as the JAX engine does
    (key,) = teng._wave_prewarm_failed
    assert key not in teng._wave_compiled
    with pytest.raises(BackendError, match="capture failed"):
        teng.decide_wave(suffixes[:8], 90)  # a real dispatch fails its wave
    assert key not in teng._wave_compiled


@pytest.mark.parametrize("grammar", [False, True], ids=["free", "grammar"])
def test_prefix_switch_refreshes_the_static_buffer(tiny_params, grammar):
    """Two cached prefixes of one buffer length (512 slots) and different
    lengths, switched A, B, A: each wave attends the prefix installed for
    it, as in the JAX engine (a static prefix buffer or length left from
    the other prefix would change the tokens)."""
    rng = np.random.default_rng(3)
    pa = [int(t) for t in rng.integers(1, 256, size=300)]
    pb = [int(t) for t in rng.integers(1, 256, size=330)]
    suffixes = [[int(t) for t in rng.integers(1, 256, size=n)] for n in (20, 31)]
    jeng, teng = _engines(tiny_params, grammar)
    got, want = [], []
    for prefix in (pa, pb, pa):
        for eng, out in ((jeng, want), (teng, got)):
            eng.set_prefix(prefix)
            out.append([f.token_ids for f in eng.decide_wave(suffixes, 40)])
    assert teng._prefix.k.shape[1] == 512 and len(teng._static_prefix) == 1
    assert teng.stats["prefix_hits"] == 1
    assert got == want
    assert got[0] != got[1]


CHUNKS = dict(num_pages=32, page_size=64, max_slots=4, max_pages_per_seq=8,
              prefill_buckets=(128, 256, 2048), temperature=0.0, chunk_steps=4)


def _drive_chunks(eng, tok, build, cluster_prompts, grammar):
    prefix, suffixes = cluster_prompts
    eng.set_prefix(prefix)
    if grammar:
        eng.set_grammar(build.build_decision_dfa(tok, NAMES, max_reason_tokens=6))
    pages0 = eng.kv.pages_free
    ids = eng.add_requests(suffixes[:3], max_new_tokens=11)
    fins = []
    while eng.has_active:
        fins += eng.step(chunks=2)
    by_id = {f.req_id: f.token_ids for f in fins}
    gen = eng.generate(suffixes[3], max_new_tokens=9)
    return ([by_id[i] for i in ids], gen.token_ids, eng.kv.pages_free == pages0,
            eng.stats["chunks"])


@pytest.fixture(scope="module")
def jax_chunks(tiny_params, cluster_prompts):
    """The JAX general path's decode-chunk results by grammar, computed once
    for both of the port's paged_attn modes."""
    memo = {}

    def get(grammar):
        if grammar not in memo:
            jeng = JEngine(tiny_params[0], JTINY, JByteTokenizer(), paged_attn="gather",
                           fused_decode=False, **CHUNKS)
            memo[grammar] = _drive_chunks(jeng, jeng.tokenizer, jconstrained,
                                          cluster_prompts, grammar)
        return memo[grammar]

    return get


@pytest.mark.parametrize("grammar", [False, True], ids=["free", "grammar"])
@pytest.mark.parametrize("paged_attn", ["gather", "pallas"])
def test_decode_chunks_in_place_match_jax(tiny_params, cluster_prompts, jax_chunks,
                                          paged_attn, grammar):
    """Two decode chunks a step() (one host sync), the slot state updated
    in place and the page tables in their static buffer: the JAX general
    path's tokens (fused_decode=False), then one more admission (the tables
    change) and generate(). One chunk variant serves it all."""
    teng = TEngine(tiny_params[1], TTINY, ByteTokenizer(), paged_attn=paged_attn,
                   graphs=False, fused_decode=False, **CHUNKS)
    results = [jax_chunks(grammar),
               _drive_chunks(teng, teng.tokenizer, tconstrained, cluster_prompts, grammar)]
    assert results[1] == results[0]
    assert results[1][2]
    assert len(teng._chunk_variants) == 1
    (var,) = teng._chunk_variants.values()
    assert var.program.runs == teng.stats["chunks"]


def test_off_a_card_programs_run_eagerly():
    """On the CPU a runner has no graphs, whatever it is asked: every run
    calls the function, and the engine keeps its default graphs=True."""
    runner = tgraphs.GraphRunner(torch.device("cpu"), enabled=True)
    calls = []
    prog = runner.program("p", lambda: calls.append(1))
    for _ in range(3):
        prog.run()
    assert calls == [1, 1, 1]
    assert not runner.enabled and not prog.captured and runner.captures == 0
    fence = tgraphs.Fence(torch.device("cpu"))
    fence.record()
    fence.synchronize()
    assert fence.query()
    assert not tgraphs.host_buffer((2,), torch.int32, torch.device("cpu")).is_pinned()
    wrappers = tgraphs.launch_counted()
    assert len(wrappers) == 5 and all(isinstance(w.launches, int) for w in wrappers)


def test_idle_backend_captures_the_sibling_geometry(tiny_params):
    """The backend's worker, idle past prewarm_idle_delay_s after single
    decisions (R=4 waves), prewarms the R=8 sibling on its own thread, so
    the batch that follows finds its geometry warm (JAX LocalLLMBackend's
    idle prewarm)."""
    _, tp = tiny_params
    engine = TEngine(tp, TTINY, ByteTokenizer(), temperature=0.0, graphs=False)
    backend = LocalLLMBackend(engine, max_new_tokens=100, prewarm_idle_delay_s=0.05)
    cold = []
    harvest = engine.harvest_wave

    def recorded(handle):
        cold.append(handle.cold_compile)
        return harvest(handle)

    engine.harvest_wave = recorded
    pods, nodes = ttesting.fixture_pods(8), ttesting.synthetic_nodes(4)
    try:
        backend.get_scheduling_decision(pods[0], nodes)
        deadline = time.monotonic() + 300
        while engine.wave_prewarm_backlog():
            assert time.monotonic() < deadline, "the prewarm did not drain"
            time.sleep(0.02)
        batch = backend.get_scheduling_decisions_batch(pods, nodes)
    finally:
        backend.close()
    assert not any(isinstance(d, Exception) for d in batch)
    assert engine.stats["wave_prewarms"] == 1
    assert cold == [True, False]


def test_no_collection_holds_across_threads():
    """Two overlapping holds (captures of two engines on two threads) keep
    the collector off until the last one ends, which restores it; a
    collector that was off stays off."""
    import gc
    import threading

    from k8s_llm_scheduler_tpu_torch.engine.graphs import no_collection

    assert gc.isenabled()
    held, release, seen = threading.Event(), threading.Event(), []

    def other():
        with no_collection():
            held.set()
            release.wait(10)
            seen.append(gc.isenabled())

    thread = threading.Thread(target=other)
    thread.start()
    assert held.wait(10)
    with no_collection():
        assert not gc.isenabled()
    assert not gc.isenabled()  # the other thread's hold outlives this one
    release.set()
    thread.join(10)
    assert seen == [False] and gc.isenabled()
    gc.disable()
    try:
        with no_collection():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
