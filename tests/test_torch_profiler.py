"""The port's continuous engine profiler (observability/profiler.py) held
against the JAX package's on the CPU:

- bookkeeping: one scripted sequence of fences with an injected clock
  (waves cold and warm, with and without a queue anchor and a ready edge,
  prefix prefills, packs, fused, speculative and resident harvests,
  decision-flow windows, ring eviction) gives the same snapshot(),
  gauges() and persistent_gauges() in both packages, to 1e-9;
- the peak table is NVIDIA's, and on the CPU no peak is known; the port's
  event-timed device time is booked beside the estimate;
- a profiled TINY f32 engine (2 layers, graphs=False, the static-buffer
  code a card captures) driven through a wave, a packed admission, a
  fused drain, a step_fused harvest and a speculative generate: the same
  record counts, tokens, FLOPs and prefill_tokens_per_decision as the JAX
  engine, every port wave record's segments summing to its wall with at
  least 95% covered, and the same greedy tokens with and without the
  profiler.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu.engine.engine import InferenceEngine as JEngine
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu.models.configs import LlamaConfig as JConfig
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.observability import profiler as jprofiler
from k8s_llm_scheduler_tpu.spec.decoder import SpeculativeDecoder as JDecoder
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.observability import profiler as tprofiler
from k8s_llm_scheduler_tpu_torch.spec import SpeculativeDecoder
from k8s_llm_scheduler_tpu_torch.testing import cap_torch_threads

cap_torch_threads()

ARCH = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
            max_seq_len=2048, rope_theta=10000.0, tie_embeddings=True)
JCFG = JConfig(name="prof-test", dtype=jnp.float32, **ARCH)
TCFG = LlamaConfig(name="prof-test", dtype=torch.float32, **ARCH)
ENGINE = dict(num_pages=64, page_size=64, max_slots=4, max_pages_per_seq=16,
              prefill_buckets=(128, 256, 512), chunk_steps=8, temperature=0.0,
              admission_chunk_tokens=32)
TOK = ByteTokenizer()
JTOK = JByteTokenizer()
PREFIX = TOK.encode("cluster: node-a cpu 40% mem 12%; node-b cpu 75% mem 60%. ")
SUFFIXES = [TOK.encode("pod-a needs a node"), TOK.encode("pod " * 11),
            TOK.encode("pod-c: tiny")]
PROMPT = TOK.encode("The quick brown fox jumps over the lazy dog. ")
REL = 1e-9


def _close(got, want, path="") -> None:
    """Recursive equality, floats to REL (relative) or 1e-9 absolute."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)) and math.isclose(
            got, want, rel_tol=REL, abs_tol=1e-9), (path, got, want)
    else:
        assert got == want, (path, got, want)


class _Clock:
    def __init__(self) -> None:
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


class _Handle:
    """Identity-keyed stand-in for a WaveHandle."""


def _script(mod, cfg) -> dict:
    """Every fence of the profiler's API, on a window of 3 (so each ring
    evicts), with an injected clock."""
    clock = _Clock()
    prof = mod.EngineProfiler(cfg=cfg, window=3, peak_tflops=50.0, clock=clock)
    for i in range(5):
        h = _Handle()
        t = 1.0 + i
        prof.on_submit(h, t + 0.010, t + 0.012 + 0.001 * i, suffix_tokens=100 + 7 * i,
                       n_requests=1 + i % 3, prefix_len=900 + 11 * i, cold_compile=i == 0)
        if i % 2 == 0:
            prof.note_admission(h, t)
        if i != 3:
            clock.t = t + 0.040 + 0.003 * i
            prof.note_ready(h)
            prof.note_ready(h)  # first call wins
        prof.on_harvest(h, t + 0.045, t + 0.060 + 0.002 * i, t + 0.061 + 0.002 * i,
                        decode_tokens=200 + 13 * i, model_calls=9 + i,
                        ready_at_entry=i == 4)
    prof.on_harvest(_Handle(), 0.0, 0.1, 0.2, decode_tokens=1, model_calls=1,
                    ready_at_entry=True)  # submitted before the profiler: ignored
    for i in range(4):
        prof.note_prefix_prefill(0 if i == 1 else 300 + i, 900 + i)
        prof.on_pack(wall_s=0.02 + 0.001 * i, chunk_prefill_s=0.012, piggyback_s=0.003 * i,
                     n_prompts=2 + i, tokens=60 + 9 * i, chunks=2 + i)
        prof.on_fused(wall_s=0.03 + 0.002 * i, dispatch_s=0.004, sync_s=0.02,
                      harvest_s=0.003, steps=16 + i, tokens=14 + i, chunks=2, ctx=512.0 + i)
        prof.on_spec(wall_s=0.05 + 0.01 * i, draft_s=0.01, verify_s=0.03, rollback_s=0.002,
                     rounds=5 + i, overlapped_rounds=4 + i, tokens=20 + 3 * i,
                     arm="draft" if i % 2 else "hidden", disabled=i == 3)
        prof.on_persistent(
            wall_s=0.1, ring_wait_s=0.02, harvest_s=0.01, loop_resident_s=0.07,
            steps=30 + i, tokens=25 + i, batches=3,
            loop_segments=None if i == 2 else {"admit": 0.01, "decode": 0.05,
                                               "ring_stall": 0.0, "idle": 0.01})
    for d_disp, d_done in ((12, 3), (5, 0), (0, 4), (7, 2), (3, 1)):
        prof.on_decision_flow(d_disp, d_done)
    out = {"snapshot": prof.snapshot(), "gauges": prof.gauges(),
           "persistent": prof.persistent_gauges(),
           "dpd": prof.dispatches_per_decision()}
    prof.close()
    assert prof.closed and not prof._open
    return out


def test_scripted_fences_give_the_jax_snapshot_and_gauges():
    want = _script(jprofiler, JCFG)
    got = _script(tprofiler, TCFG)
    _close(got, want)
    snap = got["snapshot"]
    assert snap["waves_profiled"] == 5 and len(snap["ring"]) == 3
    assert "mfu" in snap and snap["packs"]["packs_profiled"] == 4
    assert got["dpd"] == want["dpd"] is not None


def test_peak_table_is_nvidia_and_the_cpu_has_no_peak():
    assert all(name.startswith("NVIDIA ") for name in tprofiler.PEAK_BF16_TFLOPS)
    assert tprofiler.PEAK_BF16_TFLOPS["NVIDIA H100 80GB HBM3"] == 989.0
    if not torch.cuda.is_available():
        assert tprofiler.detect_peak_tflops() == (None, "cpu")
        assert tprofiler.detect_peak_tflops(12.5) == (12.5, "cpu")
        prof = tprofiler.EngineProfiler(cfg=TCFG)
        assert prof.peak_flops is None and prof.device_kind == "cpu"


def test_the_event_timed_device_time_is_booked_beside_the_estimate():
    """The port's own figure: a harvest given the wave's event-timed device
    seconds books them on its record, and the warm ones sum in the
    snapshot; without it neither key appears (as in the JAX package)."""
    prof = tprofiler.EngineProfiler(cfg=TCFG, peak_tflops=50.0)
    for cold, event_s in ((True, 0.5), (False, 0.036), (False, None), (False, 0.030)):
        h = _Handle()
        prof.on_submit(h, 0.010, 0.012, suffix_tokens=10, n_requests=1, prefix_len=0,
                       cold_compile=cold)
        prof.on_harvest(h, 0.020, 0.050, 0.051, decode_tokens=5, model_calls=2,
                        ready_at_entry=False, device_event_s=event_s)
    snap = prof.snapshot()
    assert [r.get("device_event_ms") for r in snap["ring"]] == [500.0, 36.0, None, 30.0]
    assert snap["device_event_ms_total"] == pytest.approx(66.0)
    assert "device_event_ms_total" not in _script(tprofiler, TCFG)["snapshot"]


# ------------------------------------------------------------ profiled engine
@pytest.fixture(scope="module")
def weights():
    jp = jinit_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _drive(eng, spec) -> list:
    """A prefix prefill, a cold and a warm wave, a packed admission drained
    by decode_fused, a step_fused harvest, then a speculative generate."""
    toks = []
    eng.set_prefix(PREFIX)
    for _ in range(2):
        toks.append([f.token_ids for f in eng.harvest_wave(eng.submit_wave(SUFFIXES[:2], 12))])
    ids = eng.admit_packed(SUFFIXES, max_new_tokens=10)
    fins = {}
    while len(fins) < len(ids):
        fins.update((f.req_id, f.token_ids) for f in eng.decode_fused())
    toks.append([fins[i] for i in ids])
    ids = eng.add_requests(SUFFIXES[:2], 10)
    fins = {}
    while len(fins) < len(ids):
        fins.update((f.req_id, f.token_ids) for f in eng.step_fused(chunks=1))
    toks.append([fins[i] for i in ids])
    eng.attach_spec(spec)
    toks.append(eng.generate(PROMPT, 12).token_ids)
    eng.attach_spec(None)
    return toks


@pytest.fixture(scope="module")
def profiled(weights):
    jp, tp = weights
    jeng = JEngine(jp, JCFG, JTOK, **ENGINE)
    teng = InferenceEngine(tp, TCFG, TOK, graphs=False, **ENGINE)
    plain = InferenceEngine(tp, TCFG, TOK, graphs=False, **ENGINE)
    jprof = jprofiler.EngineProfiler(cfg=JCFG, peak_tflops=50.0)
    tprof = tprofiler.EngineProfiler(cfg=TCFG, peak_tflops=50.0)
    jeng.attach_profiler(jprof)
    teng.attach_profiler(tprof)
    kw = dict(k=4, min_rounds=10**9)
    out = {
        "jax": _drive(jeng, JDecoder(jeng, jp, JCFG, **kw)),
        "port": _drive(teng, SpeculativeDecoder(teng, tp, TCFG, **kw)),
        "plain": _drive(plain, SpeculativeDecoder(plain, tp, TCFG, **kw)),
    }
    yield out, jprof.snapshot(), tprof.snapshot(), teng
    teng.close()
    plain.close()


def _books(snap) -> dict:
    """What both packages must agree on: counts, tokens, FLOPs, the
    prefill tokens per decision."""
    return {
        "waves": snap["waves_profiled"],
        "wave_records": [{k: r[k] for k in ("n_requests", "cold_compile", "suffix_tokens",
                                             "decode_tokens", "model_calls", "flops")}
                         for r in snap["ring"]],
        "tokens": snap["tokens"],
        "packs": [{k: r[k] for k in ("n_prompts", "tokens", "chunks")}
                  for r in snap["packs"]["ring"]],
        "fused": [{k: r[k] for k in ("chunks", "steps", "tokens", "flops")}
                  for r in snap["fused"]["ring"]],
        "spec": [{k: r[k] for k in ("arm", "rounds", "overlapped_rounds", "tokens",
                                    "disabled")} for r in snap["spec"]["ring"]],
        "prefill_tokens_per_decision": snap["prefill_tokens_per_decision"],
    }


def test_profiled_engine_books_what_the_jax_engine_books(profiled):
    toks, jsnap, tsnap, _ = profiled
    assert toks["port"] == toks["jax"]
    _close(_books(tsnap), _books(jsnap))
    assert tsnap["waves_profiled"] == 2 and len(tsnap["fused"]["ring"]) >= 2
    assert tsnap["spec"]["requests_profiled"] == 1


def test_port_wave_segments_sum_to_the_wall_and_cover_it(profiled):
    _, _, tsnap, _ = profiled
    for rec in tsnap["ring"]:
        seg = rec["segments_ms"]
        assert set(seg) == set(tprofiler.SEGMENTS)
        assert sum(seg.values()) == pytest.approx(rec["wall_ms"], rel=1e-9, abs=1e-9)
        covered = sum(v for k, v in seg.items() if k != "unattributed")
        assert covered >= 0.95 * rec["wall_ms"] > 0
        assert 0 < rec["device_compute_ms"] <= rec["wall_ms"]
    assert tsnap["coverage_frac"] >= 0.95
    for family, names in (("packs", tprofiler.PACK_SEGMENTS),
                          ("fused", tprofiler.FUSED_SEGMENTS),
                          ("spec", tprofiler.SPEC_SEGMENTS)):
        for rec in tsnap[family]["ring"]:
            assert set(rec["segments_ms"]) == set(names)
            assert sum(rec["segments_ms"].values()) == pytest.approx(rec["wall_ms"])


def test_greedy_tokens_do_not_change_with_the_profiler(profiled):
    toks, _, _, teng = profiled
    assert toks["plain"] == toks["port"]
    stats = teng.get_stats()
    assert stats["dispatches_per_decision"] > 0
