"""The port's arena (sim/) and report card (train/eval.py) held against the
JAX package's on the CPU.

- The copied modules are the JAX package's text (train/distill.py's
  `random_cases` only); `chaos_scenario` gives the JAX package's spec and
  fault plan.
- `generate_scenario` gives the JAX package's scenarios for every arrival
  process, with constraints and churn; the report card's agreement and
  placement numbers are the JAX package's for the teacher and random
  deciders.
- `run_arena` over one seeded scenario (4 nodes, 16 pods, 2 waves) gives
  byte-identical `canonical_bytes` traces to the JAX package's for the
  heuristic, teacher and stub arms, and for a TINY f32 greedy `llm` arm
  (an HF safetensors checkpoint both packages load); each package's
  `verify_trace` accepts the other's trace.
- `cli sim --arms stub,teacher,llm --trace` and `--replay`, and `cli eval
  --model tiny`, on the CPU.

Every wait is bounded (WAIT_S)."""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu import cli as jcli
from k8s_llm_scheduler_tpu import sim as jsim
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.sim import scenarios as jscenarios
from k8s_llm_scheduler_tpu.sim import trace as jtrace
from k8s_llm_scheduler_tpu.train import eval as jeval
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch import sim as tsim
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.sim import scenarios as tscenarios
from k8s_llm_scheduler_tpu_torch.sim import trace as ttrace
from k8s_llm_scheduler_tpu_torch.train import eval as teval

ttesting.cap_torch_threads()

REPO = Path(__file__).resolve().parent.parent
WAIT_S = 300.0
MODEL = "tiny-f32-sim"  # TINY in f32: the two packages' greedy tokens agree

# Modules copied from the JAX package: (path in both packages, the text cut
# at this marker in both, or None for all of it).
COPIES = [
    ("train/eval.py", None),
    ("sim/__init__.py", None),
    ("sim/arena.py", None),
    ("sim/teacher.py", None),
    ("sim/trace.py", None),
    ("sim/scenarios.py", None),
]


@pytest.mark.parametrize("path,cut", COPIES, ids=[p for p, _ in COPIES])
def test_copy_matches_the_reference_text(path, cut):
    want = (REPO / "k8s_llm_scheduler_tpu" / path).read_text().replace(
        "k8s_llm_scheduler_tpu.", "k8s_llm_scheduler_tpu_torch.")
    got = (REPO / "k8s_llm_scheduler_tpu_torch" / path).read_text()
    if cut is not None:
        want, got = want[:want.index(cut)], got[:got.index(cut)]
    assert got == want


def test_random_cases_is_the_reference_function():
    def body(path):
        text = path.read_text()
        return text[text.index("def random_cases("):].split("\n\n\n")[0].rstrip()

    want = body(REPO / "k8s_llm_scheduler_tpu/train/distill.py").replace(
        "k8s_llm_scheduler_tpu.", "k8s_llm_scheduler_tpu_torch.")
    assert body(REPO / "k8s_llm_scheduler_tpu_torch/train/distill.py") == want


def test_chaos_scenario_waits_for_the_chaos_plane():
    """The chaos plane is ported: chaos_scenario gives the JAX spec and
    plan, and refuses an unknown regime as the JAX one does (every regime:
    tests/test_torch_chaos.py)."""
    tspec, tplan = tscenarios.chaos_scenario("node-failure", seed=1)
    jspec, jplan = jscenarios.chaos_scenario("node-failure", seed=1)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert tplan.to_dict() == jplan.to_dict()
    for pkg in (tscenarios, jscenarios):
        with pytest.raises(Exception, match="node-fail"):
            pkg.chaos_scenario("node-fail")


# ------------------------------------------------------------- scenarios
SPECS = [
    dict(arrival="burst", n_nodes=6, n_pods=18, shapes=3),
    dict(arrival="poisson", arrival_rate=50.0, wave_window_s=0.05, n_pods=40,
         constraint_mix=("uniform", "selector", "tainted", "affinity"), taint_frac=0.3),
    dict(arrival="waves", n_waves=3, n_pods=20, hetero=False, zones=2,
         churn=(("fail", 1, "sim-node-002"), ("recover", 2, "sim-node-002"))),
    dict(arrival="multitenant", tenants=5, n_pods=60, arrival_rate=400.0),
    dict(arrival="flap", n_waves=4, n_pods=30),
    dict(arrival="diurnal", n_waves=6, n_pods=50, constraint_mix=("hetero-capacity",)),
]


def _spec(pkg, seed, kw):
    kw = dict(kw)
    churn = tuple(pkg.ChurnEvent(wave=w, kind=k, node=n) for k, w, n in kw.pop("churn", ()))
    return pkg.ScenarioSpec(name="t", seed=seed, churn=churn, **kw)


@pytest.mark.parametrize("kw", SPECS, ids=[s["arrival"] for s in SPECS])
def test_generate_scenario_matches_the_jax_package(kw):
    for seed in (0, 11):
        want = jsim.generate_scenario(_spec(jscenarios, seed, kw))
        got = tsim.generate_scenario(_spec(tscenarios, seed, kw))
        assert got.to_dict() == want.to_dict()
        assert ttrace.canonical_bytes(got.to_dict()) == jtrace.canonical_bytes(want.to_dict())


def test_fleet_scenarios_and_scoring_match():
    assert dataclasses.asdict(tscenarios.fleet_scenario("fleet-500")) == dataclasses.asdict(
        jscenarios.fleet_scenario("fleet-500"))
    kw = dict(SPECS[2])
    jsc, tsc = (pkg.generate_scenario(_spec(mod, 3, kw)) for pkg, mod in
                ((jsim, jscenarios), (tsim, tscenarios)))
    rng = np.random.default_rng(0)
    names = [n.name for n in tsc.nodes]
    pods = [p.name for w in tsc.waves for p in w]
    placements = {p: names[int(rng.integers(len(names)))] for p in pods[:-3]}
    unsched = pods[-3:]
    assert tsim.score_placement(tsc, placements, unsched) == jsim.score_placement(
        jsc, placements, unsched)
    tm, jm = tscenarios.ClusterModel(tsc), jscenarios.ClusterModel(jsc)
    for model in (tm, jm):
        model.apply_churn(tsc.churn_for_wave(1))
    assert [dataclasses.asdict(n) for n in tm.metrics()] == [
        dataclasses.asdict(n) for n in jm.metrics()]


# ------------------------------------------------------------------ eval
def test_eval_reports_match_the_jax_package():
    assert teval.SCENARIO_CLASSES == jeval.SCENARIO_CLASSES
    for (tp, tn), (jp, jn) in zip(teval.held_out_cases(12), jeval.held_out_cases(12)):
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        assert [dataclasses.asdict(n) for n in tn] == [dataclasses.asdict(n) for n in jn]
    for tdec, jdec in ((teval.teacher_decide, jeval.teacher_decide),
                       (teval.random_decide_fn(3), jeval.random_decide_fn(3))):
        assert teval.eval_agreement(tdec, n_cases=24) == jeval.eval_agreement(jdec, n_cases=24)
    for tdec, jdec in ((teval.teacher_decide, jeval.teacher_decide),
                       (teval.random_decide_fn(5), jeval.random_decide_fn(5))):
        assert teval.eval_placement(tdec, n_pods=16) == jeval.eval_placement(jdec, n_pods=16)
    assert teval.eval_agreement_by_scenario(teval.random_decide_fn(1), n_cases=6) == (
        jeval.eval_agreement_by_scenario(jeval.random_decide_fn(1), n_cases=6))
    assert teval.evaluate_decider(teval.teacher_decide, n_cases=8, placement_pods=8) == (
        jeval.evaluate_decider(jeval.teacher_decide, n_cases=8, placement_pods=8))


# ----------------------------------------------------------------- arena
ARENA = dict(name="parity", seed=5, n_nodes=4, n_pods=16, shapes=4, arrival="waves",
             n_waves=2, constraint_mix=("uniform", "selector"))
HEURISTIC_ARMS = "stub,resource_balanced,least_loaded,round_robin,teacher"


def _arms(sim_pkg, names):
    from importlib import import_module

    backend = import_module(sim_pkg.__name__.rsplit(".", 1)[0] + ".engine.backend")
    out = []
    for name in names.split(","):
        if name == "teacher":
            out.append(sim_pkg.teacher_arm())
        elif name == "stub":
            out.append(sim_pkg.ArmSpec(name="stub", kind="stack", make=backend.StubBackend))
        else:
            out.append(sim_pkg.ArmSpec(name=name, kind="stack",
                                       make=lambda n=name: sim_pkg.HeuristicBackend(n)))
    return out


def test_arena_traces_are_byte_identical_across_packages(tmp_path):
    jreport = jsim.run_arena(jsim.generate_scenario(jsim.ScenarioSpec(**ARENA)),
                             _arms(jsim, HEURISTIC_ARMS), wave_timeout_s=WAIT_S)
    treport = tsim.run_arena(tsim.generate_scenario(tsim.ScenarioSpec(**ARENA)),
                             _arms(tsim, HEURISTIC_ARMS), wave_timeout_s=WAIT_S)
    want = jtrace.canonical_bytes(jtrace.build_trace(jreport))
    got = ttrace.canonical_bytes(ttrace.build_trace(treport))
    assert got == want
    for name, arm in treport["arms"].items():
        assert arm["placements_digest"] == jreport["arms"][name]["placements_digest"]
        assert arm["scores"]["bound_frac"] + arm["scores"]["n_unschedulable"] / 16 == 1.0
    path_t, path_j = tmp_path / "t.json", tmp_path / "j.json"
    ttrace.save_trace(treport, path_t)
    jtrace.save_trace(jreport, path_j)
    for path in (path_t, path_j):
        assert tsim.verify_trace(path)[0] and jsim.verify_trace(path)[0]


# ------------------------------------------------------- the llm arm, cli
def _hf_checkpoint(path):
    """A TINY HF-layout safetensors checkpoint from a seed (both packages'
    loaders read it to the same weights)."""
    from safetensors.torch import save_file

    cfg = tconfigs.TINY
    rng = np.random.default_rng(7)
    hd, D, F = cfg.head_dim, cfg.d_model, cfg.d_ff
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, D), "model.norm.weight": (D,)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        shapes.update({p + "input_layernorm.weight": (D,),
                       p + "self_attn.q_proj.weight": (cfg.n_heads * hd, D),
                       p + "self_attn.k_proj.weight": (cfg.n_kv_heads * hd, D),
                       p + "self_attn.v_proj.weight": (cfg.n_kv_heads * hd, D),
                       p + "self_attn.o_proj.weight": (D, cfg.n_heads * hd),
                       p + "post_attention_layernorm.weight": (D,),
                       p + "mlp.gate_proj.weight": (F, D),
                       p + "mlp.up_proj.weight": (F, D),
                       p + "mlp.down_proj.weight": (D, F)})
    sd = {}
    for name, shape in shapes.items():
        scale = 0.1 if len(shape) == 1 else shape[-1] ** -0.5
        base = 1.0 if len(shape) == 1 else 0.0
        sd[name] = torch.from_numpy((base + rng.normal(size=shape) * scale).astype(np.float32))
    path.mkdir()
    save_file(sd, str(path / "model.safetensors"))


@pytest.fixture
def config_file(tmp_path, monkeypatch):
    monkeypatch.setitem(jconfigs._REGISTRY, MODEL,
                        dataclasses.replace(jconfigs.TINY, name=MODEL, dtype=jnp.float32))
    monkeypatch.setitem(tconfigs._REGISTRY, MODEL,
                        dataclasses.replace(tconfigs.TINY, name=MODEL, dtype=torch.float32))
    _hf_checkpoint(tmp_path / "ckpt")
    path = tmp_path / "config.yaml"
    path.write_text(
        "llm:\n"
        f"  model: {MODEL}\n"
        f"  checkpoint_path: {tmp_path / 'ckpt'}\n"
        "  max_tokens: 80\n"
        "  max_batch: 4\n"
        "  timeout: 600\n"
        "  fused_decode: false\n"
        "  compile_cache_dir: null\n"
        "observability:\n"
        "  profiler: false\n"
    )
    return path


def _sim_argv(config_file, trace, device=()):
    a = ARENA
    return (["--config", str(config_file), "sim", "--name", a["name"], "--seed", str(a["seed"]),
             "--nodes", str(a["n_nodes"]), "--pods", str(a["n_pods"]), "--shapes",
             str(a["shapes"]), "--arrival", "waves", "--waves", str(a["n_waves"]),
             "--constraints", ",".join(a["constraint_mix"]), "--arms", "stub,teacher,llm",
             "--wave-timeout", str(WAIT_S), "--trace", str(trace),
             "--out", str(trace) + ".report", *device])


def test_cli_sim_llm_arm_trace_matches_the_jax_package_and_replays(config_file, tmp_path,
                                                                   capsys):
    """`cli sim --arms stub,teacher,llm --trace` in both packages from one
    config (TINY f32, greedy): byte-identical traces; `--replay` of the
    port's trace exits 0 in the port and verifies in the JAX package."""
    jtr, ttr = tmp_path / "jax.trace", tmp_path / "port.trace"
    assert jcli.main(_sim_argv(config_file, jtr)) == 0
    capsys.readouterr()
    assert cli.main(_sim_argv(config_file, ttr, ("--device", "cpu"))) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    head = lines[-1]
    assert head["metric"] == "sim_arena" and set(head["arms"]) == {"stub", "teacher", "llm"}
    assert head["arms"]["llm"]["bound_frac"] == 1.0
    report = json.loads(Path(str(ttr) + ".report").read_text())
    llm = report["arms"]["llm"]["stats"]
    assert llm["llm_decisions"] > 0 and llm["fallback_decisions"] == 0
    assert ttr.read_bytes() == jtr.read_bytes()
    assert cli.main(["--config", str(config_file), "sim", "--replay", str(ttr)]) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True
    assert jsim.verify_trace(ttr)[0]


def test_cli_eval_prints_its_report_line(config_file, capsys):
    """`cli eval` on the CPU prints one JSON line: the report card of the
    checkpoint served greedily (every decision names a real node), beside
    the fallback and random baselines, whose numbers are the JAX
    package's (test_eval_reports_match_the_jax_package)."""
    argv = ["--config", str(config_file), "eval", "--model", MODEL, "--cases", "2",
            "--placement-pods", "2", "--checkpoint", str(config_file.parent / "ckpt"),
            "--device", "cpu"]
    assert cli.main(argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["n_cases"] == 2 and got["valid_pct"] == 100.0
    assert got["model"] == MODEL and got["checkpoint"] == str(config_file.parent / "ckpt")
    assert got["fallback_spread"] == jeval.eval_placement(jeval.teacher_decide, n_pods=2)
    assert got["random_spread"] == jeval.eval_placement(jeval.random_decide_fn(10_007),
                                                         n_pods=2)
