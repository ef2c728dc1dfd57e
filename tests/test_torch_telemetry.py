"""The port's telemetry plane held against the JAX package's on the CPU:
observability/metrics.py, observability/slo.py, observability/sampler.py,
and `cli run`'s operating plane.

- render_prometheus of one stats tree (a live stack's scheduler stats with
  its phase histograms, profiler and SLO gauges) gives the same bytes in
  both packages;
- every route of MetricsServer._route answers as the JAX server's does,
  over the same providers and components of each package;
- the SLO engine, under one scripted stats series and an injected clock,
  trips and clears identically in both (latency, error-rate and
  throughput objectives, and the breaker advisory);
- the engine sampler books the same series over one duck-typed engine;
- trace.device_trace exports a Chrome trace of torch.profiler, and its
  guarded stop never masks the block's own error;
- `cli run` over the wire fake with the journal, the profiler, metrics
  (port 0) and the SLO engine on binds every pod, answers /metrics,
  /debug/profile and /debug/slo and `cli trace list` while it runs, and
  `cli journal fsck` exits 0 on the journal it left.

Every wait is bounded (WAIT_S).
"""

import copy
import json
import os
import signal
import threading
import time
import urllib.request

import pytest

from k8s_llm_scheduler_tpu.core.breaker import CircuitBreaker as JBreaker
from k8s_llm_scheduler_tpu.observability import metrics as jmetrics
from k8s_llm_scheduler_tpu.observability import profiler as jprofiler
from k8s_llm_scheduler_tpu.observability import sampler as jsampler
from k8s_llm_scheduler_tpu.observability import slo as jslo
from k8s_llm_scheduler_tpu.observability import trace as jtrace
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch import config as tconfig
from k8s_llm_scheduler_tpu_torch.cluster import httpapi as thttp
from k8s_llm_scheduler_tpu_torch.cluster import wire_fake as twire
from k8s_llm_scheduler_tpu_torch.core.breaker import CircuitBreaker as TBreaker
from k8s_llm_scheduler_tpu_torch.observability import metrics as tmetrics
from k8s_llm_scheduler_tpu_torch.observability import profiler as tprofiler
from k8s_llm_scheduler_tpu_torch.observability import sampler as tsampler
from k8s_llm_scheduler_tpu_torch.observability import slo as tslo
from k8s_llm_scheduler_tpu_torch.observability import trace as ttrace
from k8s_llm_scheduler_tpu_torch.testing import (
    cap_torch_threads,
    pod_burst,
    synthetic_cluster,
    synthetic_nodes,
)

cap_torch_threads()

WAIT_S = 300.0
PKG = {
    "jax": dict(metrics=jmetrics, profiler=jprofiler, sampler=jsampler, slo=jslo,
                trace=jtrace, breaker=JBreaker),
    "port": dict(metrics=tmetrics, profiler=tprofiler, sampler=tsampler, slo=tslo,
                 trace=ttrace, breaker=TBreaker),
}
OBJECTIVES = [
    {"name": "decide_p", "kind": "latency", "phase": "decide", "threshold_ms": 50.0,
     "budget": 0.05},
    {"name": "bind_errors", "kind": "error_rate", "numerator": "failed_bindings",
     "denominator": "total_scheduled", "budget": 0.02},
    {"name": "floor", "kind": "throughput", "counter": "total_scheduled", "min_per_s": 0.5},
]


def _stats_tree() -> dict:
    """A live stub stack's scheduler stats (phase histograms included),
    with numbers, strings, bools, None and lists beside them."""
    cfg = tconfig.Config(copy.deepcopy(tconfig.DEFAULTS))
    cfg.data["llm"]["backend"] = "stub"
    cluster = synthetic_cluster(2)
    scheduler, _ = cli.build_stack(cfg, cluster)
    for i, seconds in enumerate((0.0002, 0.004, 0.09, 1.7, 700.0)):
        scheduler.phases.record("decide", seconds)
        scheduler.phases.record("bind", seconds / (i + 1))
    cluster.close()
    stats = scheduler.get_stats()
    stats.update({"label": 'a "quoted"\\ value\n', "flag": True, "missing": None,
                  "series": [1, 2.5, False, {"x": 3}], "nested": {"deeper": {"n": 7}}})
    return stats


def test_render_prometheus_gives_the_jax_bytes():
    stats = _stats_tree()
    assert "phases" in stats and stats["phases"]["decide"]
    got = tmetrics.render_prometheus(stats)
    assert got == jmetrics.render_prometheus(stats)
    assert "llm_scheduler_phases_decide_seconds_bucket" in got


class _Engine:
    """A duck-typed engine for the sampler: slots, pages, stats."""

    def __init__(self) -> None:
        self.max_slots, self.free_slots = 8, 8

        class KV:
            num_pages, pages_free = 100, 100

        self.kv = KV()
        self.stats = {"decode_tokens": 0, "syncs": 0, "prefix_hits": 0,
                      "prefix_prefills": 0, "persistent_chunks": 0}


class _Clock:
    def __init__(self) -> None:
        self.t = 50.0

    def __call__(self) -> float:
        return self.t


def _sampler_series(pkg: str) -> list:
    eng, clock = _Engine(), _Clock()
    sampler = PKG[pkg]["sampler"].EngineSampler(eng, interval_s=1.0, window=4, clock=clock)
    out = []
    for i in range(6):
        clock.t += 1.5
        eng.free_slots = 8 - i % 5
        eng.kv.pages_free = 100 - 9 * i
        eng.stats["prefix_hits"] += i % 2
        eng.stats["prefix_prefills"] += 1
        if i != 3:  # a window with no harvest
            eng.stats["decode_tokens"] += 40 * i
            eng.stats["syncs"] += 1
        out.append(sampler.sample_once())
    out.append((sampler.latest(), sampler.series()))
    return out


def test_engine_sampler_books_the_jax_series():
    got = _sampler_series("port")
    assert got == _sampler_series("jax")
    assert got[-2]["hbm_used_frac"] is None  # an engine off the card


def _slo_run(pkg: str) -> dict:
    """One scripted stats series through from_config's engine, with the
    breaker advisory cli run wires."""
    mod = PKG[pkg]
    recorder = mod["trace"].PhaseRecorder()
    clock = _Clock()
    state = {"total_scheduled": 0, "failed_bindings": 0}

    def provider():
        return {**state, "phases": recorder.snapshot()}

    cfg = {"enabled": True, "fast_window_s": 30.0, "slow_window_s": 120.0,
           "objectives": OBJECTIVES}
    engine = mod["slo"].from_config(cfg, provider, clock=clock)
    breaker = mod["breaker"](failure_threshold=3, timeout_seconds=10)
    events = []
    engine.on_trip.append(lambda name, _d: breaker.slo_advisory(name))
    engine.on_trip.append(lambda name, _d: events.append(("trip", name, clock.t)))
    engine.on_clear.append(lambda name, _d: events.append(("clear", name, clock.t)))
    timeline = []
    for tick in range(60):
        clock.t += 5.0
        slow = 20 <= tick < 35  # a latency regression
        failing = 28 <= tick < 40  # then bind errors
        idle = 45 <= tick < 55  # then no traffic
        if not idle:
            state["total_scheduled"] += 4
            for _ in range(4):
                recorder.record("decide", 0.2 if slow else 0.01)
        if failing:
            state["failed_bindings"] += 2
        result = engine.evaluate()
        timeline.append((tick, engine.tripped(),
                         {k: (v["tripped"], v["fast"], v["slow"]) for k, v in result.items()}))
    return {"events": events, "timeline": timeline, "snapshot": engine.snapshot(),
            "gauges": engine.gauges(), "advisories": breaker.stats()}


def test_slo_engine_trips_and_clears_as_the_jax_engine():
    got = _slo_run("port")
    assert got == _slo_run("jax")
    kinds = {(kind, name) for kind, name, _ in got["events"]}
    assert {("trip", "decide_p"), ("clear", "decide_p"), ("trip", "bind_errors"),
            ("trip", "floor")} <= kinds


def _server(pkg: str):
    mod = PKG[pkg]
    prof = mod["profiler"].EngineProfiler(cfg=None, peak_tflops=10.0)
    prof.on_fused(wall_s=0.02, dispatch_s=0.004, sync_s=0.012, harvest_s=0.004, steps=16,
                  tokens=16, chunks=2)
    eng, clock = _Engine(), _Clock()
    sampler = mod["sampler"].EngineSampler(eng, clock=clock)
    slo_engine = mod["slo"].from_config(
        {"enabled": True, "objectives": OBJECTIVES[1:2]},
        lambda: {"total_scheduled": 3, "failed_bindings": 0}, clock=clock)
    slo_engine.evaluate()

    class Recorder:
        def list(self, n=None, since_seq=-1):
            rows = [{"trace_id": f"t{i}", "name": "decision", "seq": i, "dur_ms": 1.5 * i}
                    for i in range(5)]
            rows = [r for r in rows if r["seq"] > since_seq]
            return rows if n is None else rows[-n:]

        def stats(self):
            return {"held": 5, "capacity": 8, "recorded": 5}

        def get(self, trace_id):
            return {"trace_id": trace_id, "spans": []} if trace_id == "t1" else None

        def export_slices(self, since_seq=0, max_bytes=None):
            return [{"trace_id": "t1", "seq": 1}], 1, False

    return mod["metrics"].MetricsServer(
        lambda: {"total_scheduled": 3, "breaker": "closed"}, port=0, host="127.0.0.1",
        flight_recorder=Recorder(), engine_sampler=sampler, engine_profiler=prof,
        slo_engine=slo_engine, blackbox_provider=lambda: None)


ROUTES = ["/metrics", "/healthz", "/stats", "/debug/decisions?n=2",
          "/debug/decisions?since=2&n=10", "/debug/decisions?max_bytes=64",
          "/debug/trace/t1", "/debug/trace/nope", "/debug/export", "/debug/engine",
          "/debug/profile", "/debug/slo", "/debug/blackbox", "/nope"]


def test_every_route_answers_as_the_jax_server():
    servers = {pkg: _server(pkg) for pkg in PKG}
    try:
        for path in ROUTES:
            got, want = (servers[p]._route(path) for p in ("port", "jax"))
            if path == "/debug/engine":
                # the sampler's first tick: the same series keys and values
                got, want = (json.loads(b) for b, _, _ in (got, want))
            assert got == want, path
    finally:
        for srv in servers.values():
            srv._server.server_close()


def test_device_trace_exports_a_chrome_trace_and_never_masks_the_error(tmp_path):
    import torch

    with ttrace.device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "trace").glob("trace-*.json")
    assert "traceEvents" in json.loads(path.read_text())
    with pytest.raises(ValueError, match="the block's own"):
        with ttrace.device_trace(str(tmp_path / "trace")):
            raise ValueError("the block's own error")
    assert len(list((tmp_path / "trace").glob("trace-*.json"))) == 2


# ------------------------------------------------------------- the entry point
@pytest.fixture
def run_config(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(json.dumps({
        "llm": {"model": "tiny", "temperature": 0.0, "max_tokens": 80, "timeout": 600,
                "prefill_buckets": [128, 256, 512, 1024, 2048, 4096, 8192]},
        "durability": {"enabled": True, "journal_dir": str(tmp_path / "journal")},
        "metrics": {"enabled": True, "port": 0},
        # an error-rate objective: a throughput floor would trip before the
        # first bind and brown the LLM rung out
        "slo": {"enabled": True, "interval_s": 0.2, "objectives": OBJECTIVES[1:2]},
        "observability": {"sampler_interval_s": 0.2},
    }))
    return path


def test_cli_run_with_the_operating_plane_answers_and_leaves_a_clean_journal(
        run_config, monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "absent"))
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.chdir(tmp_path)
    servers = []
    real = cli._start_metrics

    def capture(*args, **kwargs):
        server, sampler = real(*args, **kwargs)
        servers.append(server)
        return server, sampler

    monkeypatch.setattr(cli, "_start_metrics", capture)
    srv = twire.WireFakeK8s()
    for node in synthetic_nodes(3):
        srv.add_node(node.name, labels=node.labels)
    thttp.set_active_config(srv.base_url)
    pods = pod_burst(4, distinct_shapes=2)
    for pod in pods:
        srv.add_pod(pod.name, requests=dict(pod.container_requests[0]), priority=pod.priority)
    scraped, done = {}, threading.Event()

    def get(path):
        port = servers[0].port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
            return resp.status, resp.read().decode()

    def watcher():
        try:
            end = time.monotonic() + WAIT_S
            while (len(srv.bindings) < len(pods) or not servers) and time.monotonic() < end:
                done.wait(0.05)
            time.sleep(0.5)  # a sampler and an SLO tick after the last bind
            for path in ("/metrics", "/debug/profile", "/debug/slo", "/debug/engine"):
                scraped[path] = get(path)
            scraped["trace list"] = cli.main(["trace", "list", "--port",
                                              str(servers[0].port)])
        finally:
            if not done.is_set():
                os.kill(os.getpid(), signal.SIGINT)

    previous = signal.signal(signal.SIGINT, signal.default_int_handler)
    thread = threading.Thread(target=watcher, daemon=True)
    thread.start()
    try:
        rc = cli.main(["--config", str(run_config), "run", "--device", "cpu"])
    finally:
        done.set()
        thread.join(timeout=60)
        signal.signal(signal.SIGINT, previous)
        srv.close()
        thttp.clear_active_config()
    out = capsys.readouterr().out
    assert rc == 0
    assert sorted(name for _, name, _ in srv.bindings) == sorted(p.name for p in pods)
    code, text = scraped["/metrics"]
    assert code == 200 and "llm_scheduler_engine_profile_waves_profiled" in text
    assert "llm_scheduler_slo_evaluations" in text and "llm_scheduler_engine_telemetry_" in text
    code, body = scraped["/debug/profile"]
    profile = json.loads(body)
    assert code == 200 and profile["waves_profiled"] >= 1
    assert profile["prefill_tokens_per_decision"] > 0
    for rec in profile["ring"]:
        assert sum(rec["segments_ms"].values()) == pytest.approx(rec["wall_ms"])
    assert json.loads(scraped["/debug/slo"][1])["evaluations"] >= 1
    assert scraped["/debug/engine"][0] == 200 and scraped["trace list"] == 0
    stats = json.loads(out[out.index("{\n"):])
    assert stats["total_scheduled"] == len(pods) and stats["fallback_decisions"] == 0
    # the journal it left: every lifecycle acked, fsck clean
    assert cli.main(["--config", str(run_config), "journal", "fsck"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"]
    assert cli.main(["--config", str(run_config), "journal", "show", "--limit", "3"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 3
