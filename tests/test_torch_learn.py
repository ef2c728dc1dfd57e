"""The port's learn loop (learn/, `cli learn`, the retention pins of `cli
rollout`) held against the JAX package's on the CPU.

- learn/loop.py is the JAX module's text outside `finetune_on_corpus` and
  the lines that pass `device` down; miner, curriculum and the package's
  __init__ are checked as copies in test_torch_engine.py.
- The same seeded scenario mined by the same policy arm (a decide function
  that picks the teacher's worst feasible node) writes the same corpus
  bytes (but `created_at`) and digest in both packages, and
  `curriculum_batches` gives equal arrays.
- `finetune_on_corpus` at TINY (2 layers, f32, seq 128, 3 steps) from the
  same base weights (the JAX `init_params`, converted through
  models/convert.params_from_jax, each saved in its own package's
  checkpoint format): the final loss within rtol 1e-4 / atol 1e-6. The
  JAX package's orbax restore does not read a checkpoint back in this
  environment (its own tests/test_rollout.py TestCheckpointErrors fail
  here), so on the JAX side the saved tree is handed to the trainer by a
  stand-in for `restore_checkpoint` that checks the directory exists.
- A cycle through the loop's seams (as tests/test_learn.py drives the JAX
  one: decide functions, a stub trainer, heuristic gate arms) promotes,
  rejects and swaps as the JAX cycle does, with the same report and trace
  bytes; a trace written by either package verifies in the other's
  `verify_learn_trace`, and a tampered one fails in both.
- `cli learn mine|build|status|replay` on `llm.backend: stub` print what
  the JAX cli prints; `cli rollout publish` with `rollout.retain 1` keeps
  the corpus's lineage versions.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu import cli as jcli
from k8s_llm_scheduler_tpu import learn as jlearn
from k8s_llm_scheduler_tpu import rollout as jrollout
from k8s_llm_scheduler_tpu import sim as jsim
from k8s_llm_scheduler_tpu.core import fallback as jfallback
from k8s_llm_scheduler_tpu.core import validation as jvalidation
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu.learn import loop as jloop
from k8s_llm_scheduler_tpu.learn.curriculum import curriculum_batches as jcurriculum_batches
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models import loader as jloader
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.train import eval as jeval
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch import learn as tlearn
from k8s_llm_scheduler_tpu_torch import rollout as trollout
from k8s_llm_scheduler_tpu_torch import sim as tsim
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.core import fallback as tfallback
from k8s_llm_scheduler_tpu_torch.core import validation as tvalidation
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.learn import loop as tloop
from k8s_llm_scheduler_tpu_torch.learn.curriculum import curriculum_batches
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.models.loader import save_checkpoint
from k8s_llm_scheduler_tpu_torch.train import eval as teval

ttesting.cap_torch_threads()

REPO = Path(__file__).resolve().parent.parent
JTINY2 = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32, n_layers=2)
TTINY2 = dataclasses.replace(tconfigs.TINY, dtype=torch.float32, n_layers=2)
SEQ = 128
STEPS = 3
BATCH = 2
LR = 1e-3
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6


def _anti_teacher(validation, fallback):
    """Deterministically picks the worst feasible node by the teacher's own
    score: loss incidents without a model (tests/test_learn.py's)."""
    def decide(pod, nodes):
        ok = validation.feasible_nodes(pod, nodes)
        if not ok:
            return None
        return min(ok, key=lambda n: (fallback.score_resource_balanced(n), n.name)).name

    return decide


PKG = {
    "jax": dict(learn=jlearn, rollout=jrollout, sim=jsim, eval=jeval, cli=jcli,
                anti=_anti_teacher(jvalidation, jfallback)),
    "torch": dict(learn=tlearn, rollout=trollout, sim=tsim, eval=teval, cli=cli,
                  anti=_anti_teacher(tvalidation, tfallback)),
}


def _learn_cfg(side, **overrides):
    p = PKG[side]
    defaults = dict(
        seed=3, mine_seeds=(3, 4), mine_nodes=6, mine_pods=24, mine_shapes=6,
        mine_waves=3, weakness_cases=16, steps=1,
        gate=p["rollout"].GateConfig(seed=3, nodes=6, pods=16, shapes=4, waves=2,
                                     spread_tolerance=0.2, wave_timeout_s=60.0),
    )
    defaults.update(overrides)
    return p["learn"].LearnConfig(**defaults)


def _stub_train(record, out_dir):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "weights.bin").write_bytes(b"trained-" * 8)
    return 0.5


def _make_loop(side, root, *, improving=True, swapper=None):
    p = PKG[side]
    cfg = _learn_cfg(side)
    corpus = p["learn"].IncidentCorpus(root / "corpus")
    registry = p["rollout"].CheckpointRegistry(root / "registry")
    src = root / "incumbent"
    src.mkdir(parents=True, exist_ok=True)
    (src / "weights.bin").write_bytes(b"incumbent" * 4)
    registry.set_active(registry.publish(src, note="incumbent").version)
    anti = p["anti"]
    candidate = p["eval"].teacher_decide if improving else anti

    def gate_runner(version):
        return p["rollout"].run_gate(
            lambda: p["sim"].HeuristicBackend("resource_balanced"),
            lambda: p["sim"].HeuristicBackend("resource_balanced"),
            cfg.gate)

    loop = p["learn"].LearnLoop(
        registry, corpus, cfg,
        mine_arm_factory=lambda: p["learn"].decide_policy_arm("llm", anti),
        incumbent_decide_factory=lambda: (anti, lambda: None),
        candidate_decide_factory=lambda ckpt: (candidate, lambda: None),
        gate_runner=gate_runner,
        train_fn=_stub_train,
        swapper=swapper,
    )
    return loop, registry, corpus


def _mined_record(side, root):
    p = PKG[side]
    cfg = _learn_cfg(side)
    corpus = p["learn"].IncidentCorpus(root)
    sources = [p["learn"].mine_scenario(spec, p["learn"].decide_policy_arm("llm", p["anti"]))
               for spec in cfg.mine_specs()]
    return corpus, corpus.add_version(sources, checkpoint_version=1, note="parity")


@pytest.fixture(scope="module")
def mined(tmp_path_factory):
    root = tmp_path_factory.mktemp("mined")
    return {side: _mined_record(side, root / side) for side in PKG}


# ------------------------------------------------------------------- text
def test_loop_is_the_reference_text_outside_the_finetune():
    def outside(text):
        start = text.index("# --------------------------------------------------------------- finetune")
        end = text.index("# -------------------------------------------------------------------- loop")
        return (text[:start] + text[end:]).splitlines()

    want = outside((REPO / "k8s_llm_scheduler_tpu/learn/loop.py").read_text().replace(
        "k8s_llm_scheduler_tpu.", "k8s_llm_scheduler_tpu_torch."))
    got = outside((REPO / "k8s_llm_scheduler_tpu_torch/learn/loop.py").read_text())
    assert [line for line in got if "device" not in line] == want
    # the port's own lines: LearnLoop takes a device and passes it down
    assert [line.strip() for line in got if "device" in line] == [
        'device: str = "cuda",',
        "self.device = device",
        "device=self.device,",
    ]


# ----------------------------------------------------------------- corpus
def test_mined_corpus_bytes_and_digest_equal_the_jax_corpus(mined):
    (jcorpus, jrec), (tcorpus, trec) = mined["jax"], mined["torch"]
    assert trec["n_incidents"] > 0 and trec["digest"] == jrec["digest"]
    assert trec["per_class"] == jrec["per_class"]

    def stored(corpus, version):
        data = json.loads((Path(corpus.root) / f"v{version:06d}" / "corpus.json").read_bytes())
        data["created_at"] = 0
        return json.dumps(data, indent=1, sort_keys=True).encode()

    assert stored(tcorpus, trec["version"]) == stored(jcorpus, jrec["version"])
    assert tcorpus.status()["versions"] == jcorpus.status()["versions"]
    assert tcorpus.lineage_versions() == jcorpus.lineage_versions() == {1}
    # each package reads the other's corpus
    other = tlearn.IncidentCorpus(jcorpus.root).get(jrec["version"])
    assert tlearn.corpus_digest(other["sources"]) == jrec["digest"]


@pytest.mark.parametrize("replay_fraction", [0.0, 0.3, 1.0])
def test_curriculum_batches_equal_the_jax_arrays(mined, replay_fraction):
    (_, jrec), (_, trec) = mined["jax"], mined["torch"]
    jit = jcurriculum_batches(JByteTokenizer(), jrec, batch_size=4, seq_len=512,
                              replay_fraction=replay_fraction, seed=5)
    tit = curriculum_batches(ByteTokenizer(), trec, batch_size=4, seq_len=512,
                             replay_fraction=replay_fraction, seed=5)
    for _ in range(3):
        for got, want in zip(next(tit), next(jit)):
            np.testing.assert_array_equal(got, want)
    assert tlearn.curriculum_summary(trec, replay_fraction) == jlearn.curriculum_summary(
        jrec, replay_fraction)


# --------------------------------------------------------------- finetune
def test_finetune_on_corpus_matches_the_jax_trainer(mined, tmp_path, monkeypatch):
    (_, jrec), (_, trec) = mined["jax"], mined["torch"]
    np_params = jax.tree_util.tree_map(np.asarray, jinit_params(jax.random.PRNGKey(0), JTINY2))
    jbase, tbase = tmp_path / "jax_base", tmp_path / "torch_base"
    jloader.save_checkpoint(jbase, jax.tree_util.tree_map(jnp.asarray, np_params))
    save_checkpoint(tbase, params_from_jax(np_params, device="cpu"))

    def saved_tree(path, cfg, mesh=None, **_):
        assert Path(path).is_dir() and cfg == JTINY2
        return jax.tree_util.tree_map(jnp.asarray, np_params)

    monkeypatch.setattr(jloader, "restore_checkpoint", saved_tree)
    common = dict(steps=STEPS, batch_size=BATCH, seq_len=SEQ, lr=LR, seed=0)
    want = jloop.finetune_on_corpus(JTINY2, "byte", jrec, str(tmp_path / "jax_out"),
                                    base_checkpoint=str(jbase), **common)
    got = tloop.finetune_on_corpus(TTINY2, "byte", trec, str(tmp_path / "torch_out"),
                                   base_checkpoint=str(tbase), device="cpu", **common)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert (tmp_path / "torch_out" / "params.pt").is_file()


def test_finetune_on_a_dp2_mesh_matches_one_device(mined, tmp_path):
    """finetune_on_corpus(mesh_axes={"dp": 2}): two ranks from the same
    incumbent, each on its rows of the curriculum's batches: the one-device
    loss (within LOSS_RTOL / LOSS_ATOL) and one whole checkpoint."""
    from k8s_llm_scheduler_tpu_torch.models.loader import restore_checkpoint

    _, trec = mined["torch"]
    np_params = jax.tree_util.tree_map(np.asarray, jinit_params(jax.random.PRNGKey(0), JTINY2))
    base = tmp_path / "base"
    save_checkpoint(base, params_from_jax(np_params, device="cpu"))
    common = dict(base_checkpoint=str(base), steps=STEPS, batch_size=BATCH, seq_len=SEQ,
                  lr=LR, seed=0, device="cpu")
    want = tloop.finetune_on_corpus(TTINY2, "byte", trec, str(tmp_path / "one"), **common)
    got = tloop.finetune_on_corpus(TTINY2, "byte", trec, str(tmp_path / "mesh"),
                                   mesh_axes={"dp": 2}, **common)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    whole = restore_checkpoint(tmp_path / "mesh", TTINY2, device="cpu")
    assert whole["embed"].shape == (TTINY2.vocab_size, TTINY2.d_model)


# ------------------------------------------------------------------ cycle
def _report(report):
    return {k: report[k] for k in ("action", "candidate_version", "incumbent_version",
                                   "corpus_version", "corpus_digest", "per_class",
                                   "weakness", "gate", "train_loss", "curriculum")}


@pytest.mark.parametrize("improving,action", [(True, "promoted"), (False, "rejected")],
                         ids=["promotes", "rejects"])
def test_cycle_through_the_seams_acts_as_the_jax_cycle(tmp_path, improving, action):
    out = {}
    for side in PKG:
        swaps = []

        class Swapper:
            def swap_to(self, version, swaps=swaps):
                swaps.append(version)
                return {"pause_s": 0.0, "version": version}

        loop, registry, corpus = _make_loop(side, tmp_path / side, improving=improving,
                                            swapper=Swapper())
        incumbent = registry.active()
        report = loop.run_cycle(tmp_path / side / "work")
        trace = tmp_path / f"{side}.trace"
        out[side] = dict(report=_report(report), swaps=swaps, active=registry.active(),
                         rejected=set(loop.rejected), counters=dict(loop.counters),
                         trace=PKG[side]["learn"].save_learn_trace(report, trace),
                         manifest=registry.get(report["candidate_version"]).scores,
                         incumbent=incumbent, path=trace)
    t, j = out["torch"], out["jax"]
    assert t["report"]["action"] == action
    assert t["report"] == j["report"]
    assert t["trace"] == j["trace"]
    assert (t["swaps"], t["active"], t["rejected"], t["counters"], t["manifest"]) == (
        j["swaps"], j["active"], j["rejected"], j["counters"], j["manifest"])
    if improving:
        assert t["swaps"] == [t["report"]["candidate_version"]] == [t["active"]]
    else:
        assert t["swaps"] == [] and t["active"] == t["incumbent"]
        assert t["report"]["candidate_version"] in t["rejected"]
    # each package verifies the other's trace
    for mine, other in (("torch", "jax"), ("jax", "torch")):
        ok, detail = PKG[mine]["learn"].verify_learn_trace(out[other]["path"])
        assert ok, detail


def test_a_tampered_trace_fails_in_both_packages(tmp_path):
    loop, _, _ = _make_loop("torch", tmp_path)
    report = loop.run_cycle(tmp_path / "work")
    path = tmp_path / "trace.json"
    tlearn.save_learn_trace(report, path)
    trace = json.loads(path.read_bytes())
    trace["mine"]["corpus_digest"] = "0" * 16
    path.write_bytes(json.dumps(trace).encode())
    for side in PKG:
        ok, detail = PKG[side]["learn"].verify_learn_trace(path)
        assert not ok and "diverged" in detail
    # a moved placement: the recorded weakness cases no longer reconstruct
    trace = json.loads(json.dumps(report["_trace"]))
    src = trace["mine"]["sources"][0]
    victim = sorted(src["placements"])[0]
    src["placements"][victim] = ("sim-node-000" if src["placements"][victim] != "sim-node-000"
                                 else "sim-node-001")
    path.write_bytes(json.dumps(trace).encode())
    for side in PKG:
        with pytest.raises(Exception, match="does not match|diverged"):
            ok, _ = PKG[side]["learn"].verify_learn_trace(path)
            assert not ok


def test_retain_keeps_the_open_candidate_and_the_corpus_lineage(tmp_path):
    out = {}
    for side in PKG:
        loop, registry, corpus = _make_loop(side, tmp_path / side, improving=False)
        loop.config.retain = 1
        for _ in range(2):
            loop.run_cycle(tmp_path / side / "work")
        out[side] = (registry.versions(), loop.pinned_versions(), corpus.lineage_versions())
    assert out["torch"] == out["jax"]
    versions, pinned, lineage = out["torch"]
    assert lineage and lineage <= set(versions) and pinned == lineage


# -------------------------------------------------------------------- cli
def _cli_json(side, monkeypatch, capsys, argv):
    monkeypatch.setenv("LLM_BACKEND", "stub")
    rc = PKG[side]["cli"].main(argv)
    lines = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    return rc, "\n".join(lines)


def test_cli_learn_mine_build_status_on_the_stub_print_the_jax_output(
        tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = {}
    for side in PKG:
        corpus = str(tmp_path / f"corpus_{side}")
        extra = ["--device", "cpu"] if side == "torch" else []
        mine = _cli_json(side, monkeypatch, capsys,
                         ["learn", "mine", "--corpus", corpus, "--seeds", "0", *extra])
        build = _cli_json(side, monkeypatch, capsys, ["learn", "build", "--corpus", corpus])
        status = _cli_json(side, monkeypatch, capsys, ["learn", "status", "--corpus", corpus])
        out[side] = (mine, build, json.loads(status[1])["versions"])
    assert out["torch"] == out["jax"]
    (rc, mine), (brc, build), versions = out["torch"]
    assert rc == brc == 0
    assert json.loads(mine)["n_incidents"] > 0 and len(versions) == 1
    assert json.loads(build)["metric"] == "learn_build"


def test_cli_learn_replay_verifies_either_packages_trace(tmp_path, monkeypatch, capsys):
    paths = {}
    for side in PKG:
        loop, _, _ = _make_loop(side, tmp_path / side)
        paths[side] = tmp_path / f"{side}.trace"
        PKG[side]["learn"].save_learn_trace(loop.run_cycle(tmp_path / side / "work"),
                                            paths[side])
    for side in PKG:
        rc, text = _cli_json("torch", monkeypatch, capsys, ["learn", "replay", str(paths[side])])
        assert rc == 0 and json.loads(text)["ok"] is True
    data = json.loads(paths["torch"].read_bytes())
    data["mine"]["corpus_digest"] = "f" * 16
    paths["torch"].write_bytes(json.dumps(data).encode())
    rc, text = _cli_json("torch", monkeypatch, capsys, ["learn", "replay", str(paths["torch"])])
    assert rc == 1 and json.loads(text)["ok"] is False


def test_cli_learn_run_needs_the_local_backend(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("LLM_BACKEND", "stub")
    argv = ["learn", "run", "--corpus", str(tmp_path / "c"), "--registry",
            str(tmp_path / "r")]
    assert cli.main(argv + ["--device", "cpu"]) == jcli.main(argv) == 2
    assert capsys.readouterr().err.count("learn run needs llm.backend: local") == 2


def test_cli_rollout_retain_keeps_the_corpus_lineage(tmp_path, monkeypatch, capsys):
    """`rollout publish` under `rollout.retain: 1` keeps every version an
    incident corpus mined against, in both packages."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("LLM_BACKEND", "stub")
    kept = {}
    for side in PKG:
        root = tmp_path / side
        ckpt = root / "ckpt"
        ckpt.mkdir(parents=True)
        (ckpt / "weights.bin").write_bytes(b"w" * 8)
        registry = PKG[side]["rollout"].CheckpointRegistry(root / "registry")
        for _ in range(2):
            registry.publish(ckpt)
        corpus, _ = _mined_record(side, root / "corpus")  # lineage: version 1
        (root / "config.yaml").write_text(
            f"rollout:\n  retain: 1\n  registry_dir: {root / 'registry'}\n"
            f"learn:\n  corpus_dir: {corpus.root}\n")
        for _ in range(2):
            assert PKG[side]["cli"].main(["--config", str(root / "config.yaml"), "rollout",
                                          "publish", "--checkpoint", str(ckpt)]) == 0
        kept[side] = PKG[side]["rollout"].CheckpointRegistry(root / "registry").versions()
    capsys.readouterr()
    assert kept["torch"] == kept["jax"]
    assert 1 in kept["torch"] and 2 not in kept["torch"]


def test_learn_loop_without_a_trainer_needs_a_model_config(tmp_path):
    with pytest.raises(ValueError, match="train_fn or model_cfg"):
        tlearn.LearnLoop(trollout.CheckpointRegistry(tmp_path / "r"),
                         tlearn.IncidentCorpus(tmp_path / "c"),
                         mine_arm_factory=None, incumbent_decide_factory=None,
                         candidate_decide_factory=None, gate_runner=None)


def test_default_trainer_passes_the_device_down(tmp_path, monkeypatch, mined):
    seen = {}

    def fake_finetune(model_cfg, tokenizer_name, record, out_dir, **kw):
        seen.update(kw, model_cfg=model_cfg, out_dir=out_dir)
        return 1.25

    monkeypatch.setattr(tloop, "finetune_on_corpus", fake_finetune)
    loop = tlearn.LearnLoop(
        trollout.CheckpointRegistry(tmp_path / "r"), tlearn.IncidentCorpus(tmp_path / "c"),
        _learn_cfg("torch", steps=7), mine_arm_factory=None, incumbent_decide_factory=None,
        candidate_decide_factory=None, gate_runner=None, model_cfg=TTINY2,
        mesh_axes={"dp": 1}, device="cpu")
    loop._cycle_base_ckpt = "/base"
    _, trec = mined["torch"]
    assert loop._default_train(trec, str(tmp_path / "cand")) == 1.25
    assert seen["device"] == "cpu" and seen["base_checkpoint"] == "/base"
    assert seen["steps"] == 7 and seen["mesh_axes"] == {"dp": 1}
    assert len(seen["cases"]) == len(tlearn.incident_cases(trec))
