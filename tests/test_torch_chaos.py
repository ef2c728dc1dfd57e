"""The port's chaos plane (chaos/, sim/scenarios.chaos_scenario, `cli
chaos`, `cli fleet autoscale`) held against the JAX package's on the CPU.

- Every regime of REGIMES, run by each package at seed 3, 4 waves and 24
  pods (quality off), gives byte-identical canonical traces. `watch-410`
  waits out real reconnect backoff (~25 s a package, almost all of it
  asleep), so its two runs go in two threads at once, and it runs once.
- A trace either package records verifies through the other's
  `verify_chaos_trace`.
- `chaos_scenario` returns the JAX spec and fault plan for each regime.
- `cli chaos list`, `cli chaos run --trace` and `cli chaos replay`, and
  `cli fleet autoscale --json`, print the JAX CLI's records (wall-clock
  fields removed) and write the same trace bytes.

No model runs: the chaos stacks decide through stubs and the harness's
HashPlacementBackend.
"""

import concurrent.futures as cf
import dataclasses
import json

import pytest

from k8s_llm_scheduler_tpu import cli as jcli
from k8s_llm_scheduler_tpu.chaos import faults as jfaults
from k8s_llm_scheduler_tpu.chaos import harness as jharness
from k8s_llm_scheduler_tpu.sim import scenarios as jscenarios
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.chaos import faults as tfaults
from k8s_llm_scheduler_tpu_torch.chaos import harness as tharness
from k8s_llm_scheduler_tpu_torch.sim import scenarios as tscenarios

ttesting.cap_torch_threads()

RUN = dict(seed=3, n_waves=4, n_pods=24, quality=False)
REGIMES = sorted(jfaults.REGIMES)
SLEEPY = {"watch-410"}  # waits on real time, not the CPU: both packages at once
FAST = "kv-plane-outage"


def _trace(harness, regime):
    report = harness.run_chaos(regime, **RUN)
    return report, harness.canonical_chaos_bytes(harness.build_chaos_trace(report))


def test_the_port_has_the_jax_regimes():
    def data(regimes):  # the regimes' declarations, their plan builders aside
        return {name: {k: v for k, v in info.items() if not callable(v)}
                for name, info in regimes.items()}

    assert sorted(tfaults.REGIMES) == REGIMES
    assert data(tfaults.REGIMES) == data(jfaults.REGIMES)


@pytest.mark.parametrize("regime", REGIMES)
def test_chaos_trace_is_the_jax_trace(regime):
    if regime in SLEEPY:
        with cf.ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(_trace, h, regime) for h in (tharness, jharness)]
            (report, got), (_, want) = [f.result(timeout=300) for f in futs]
    else:
        report, got = _trace(tharness, regime)
        _, want = _trace(jharness, regime)
    assert got == want
    assert b"k8s_llm" not in got
    assert report["invariants"]["clean"], report["invariants"]["violations"]


@pytest.mark.parametrize("recorder,verifier", [(jharness, tharness), (tharness, jharness)],
                         ids=["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("regime", [FAST, "crash-restart", "scale-thrash"])
def test_a_trace_verifies_across_packages(regime, recorder, verifier, tmp_path):
    path = tmp_path / "trace.json"
    recorder.save_chaos_trace(recorder.run_chaos(regime, **RUN), path)
    ok, detail = verifier.verify_chaos_trace(path)
    assert ok, detail


def test_a_tampered_trace_fails_in_both_packages(tmp_path):
    path = tmp_path / "trace.json"
    tharness.save_chaos_trace(tharness.run_chaos(FAST, **RUN), path)
    trace = json.loads(path.read_bytes())
    trace["scores"]["bound_frac"] /= 2  # the replay recomputes it from the placements
    path.write_text(json.dumps(trace))
    assert not tharness.verify_chaos_trace(path)[0]
    assert not jharness.verify_chaos_trace(path)[0]


@pytest.mark.parametrize("regime", REGIMES)
def test_chaos_scenario_is_the_jax_plan(regime):
    tspec, tplan = tscenarios.chaos_scenario(regime, seed=5, n_pods=24, n_waves=4)
    jspec, jplan = jscenarios.chaos_scenario(regime, seed=5, n_pods=24, n_waves=4)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert tplan.to_dict() == jplan.to_dict() and tplan.digest() == jplan.digest()
    waves = [[[dataclasses.asdict(p) for p in w] for w in pkg.generate_scenario(spec).waves]
             for pkg, spec in ((tscenarios, tspec), (jscenarios, jspec))]
    assert waves[0] == waves[1]


# -------------------------------------------------------------------- cli
def _main(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_cli_chaos_list_prints_the_jax_list(capsys):
    got = _main(cli.main, ["chaos", "list"], capsys)
    assert got == _main(jcli.main, ["chaos", "list"], capsys)
    assert got[0] == 0 and len(got[1].splitlines()) == len(REGIMES)


def test_cli_chaos_run_and_replay_print_the_jax_records(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = {}
    for side, main in (("torch", cli.main), ("jax", jcli.main)):
        trace = tmp_path / f"{side}.trace"
        argv = ["chaos", "run", "--regime", FAST, "--seed", "3", "--waves", "4",
                "--pods", "24", "--trace", str(trace)]
        rc, text = _main(main, argv, capsys)
        record = json.loads(text.strip().splitlines()[-1])
        replays = [_main(m, ["chaos", "replay", str(trace)], capsys) for m in (cli.main,
                                                                               jcli.main)]
        out[side] = (rc, record, trace.read_bytes(),
                     [(r, json.loads(t)["ok"], json.loads(t)["detail"]) for r, t in replays])
    assert out["torch"] == out["jax"]
    rc, record, _, replays = out["torch"]
    assert rc == 0 and record["clean"] and record["regime"] == FAST
    assert all(r == 0 and ok for r, ok, _ in replays)


def test_cli_chaos_run_refuses_an_unknown_regime():
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit, match="unknown regime"):
            main(["chaos", "run", "--regime", "no-such-regime"])


def test_cli_fleet_autoscale_prints_the_jax_record(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["fleet", "autoscale", "--json", "--pods", "120", "--nodes", "12", "--waves", "8"]
    got, want = (_main(m, argv, capsys) for m in (cli.main, jcli.main))
    assert got[0] == want[0] == 0
    got, want = json.loads(got[1]), json.loads(want[1])
    # the lease book counts the fence checks and renewals of the demo's
    # drain loop, which real-time sleeps pace: not part of the record
    glease, wlease = got.pop("lease"), want.pop("lease")
    assert got == want
    assert glease["fence_rejections"] == wlease["fence_rejections"] == 0
    assert got["bind_count"] == 120 and got["autoscale"]["scale_ups"] >= 1
    text = [_main(m, argv[:2] + argv[3:], capsys) for m in (cli.main, jcli.main)]
    assert text[0] == text[1] and text[0][0] == 0
