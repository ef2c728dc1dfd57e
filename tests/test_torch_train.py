"""The port's single-device training (train/train_step.py, train/distill.py,
`cli train`) held against the JAX package's on the CPU, TINY in f32.

- The corpus code of train/distill.py is the JAX module's text, and
  `make_batches` gives equal arrays for the same seed (direct and cot
  answers, non-zero easy, placement, diverse, micro and prompt-LM fractions).
- `causal_lm_loss` on the same random logits, with and without
  `loss_start` and `loss_weights`: within 1e-6.
- One `make_train_step` step from the same converted weights against the
  JAX step with optax.adamw(lr): the loss within 1e-5, every gradient leaf
  within rtol 1e-4 / atol 1e-6, the weights after the step within
  1e-3 * lr except where |JAX grad| < 1e-6 (there Adam's first step is
  +-lr and may flip sign: fewer than 0.1% of the elements). Three steps'
  losses within 1e-4.
- One bf16 step's gradients against the same package's f32 ones: every
  leaf of the port (the tied embedding first) within 1.5x the JAX step's
  distance from f32 (both land near 0.02 at TINY).
- The cosine schedule's learning rates equal optax's over 20 steps (rtol
  1e-6); `remat=True` against `remat=False`: losses and gradients within
  1e-6.
- `numeric_embedding_init` equal to JAX's; the agreement probe and the CoT
  diagnostics give JAX's numbers on the same weights.
- `train_and_save` at TINY: 3 steps, save, resume from `.saving` and from
  `.old`, registry publish, restore. `cli train --model tiny --steps 2`
  writes a checkpoint that `restore_checkpoint` reads.
- On a two-rank mesh ({dp2}, {tp2}) `train_and_save` gives the one-device
  losses (within 1e-4) and saves the whole tree; `cli train` with
  `llm.mesh: {dp: 2}` writes a checkpoint a tp=1 backend serves. The
  layouts against the JAX step are tests/test_torch_train_parallel.py's.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_llm_scheduler_tpu.engine.tokenizer import (
    ByteTokenizer as JByteTokenizer,
    NumericTokenizer as JNumericTokenizer,
)
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models.llama import forward_prefill as jforward_prefill
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.parallel.mesh import mesh_from_config
from k8s_llm_scheduler_tpu.train import distill as jdistill
from k8s_llm_scheduler_tpu.train import train_step as jts
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer, NumericTokenizer
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.models.llama import forward_prefill
from k8s_llm_scheduler_tpu_torch.models.loader import restore_checkpoint
from k8s_llm_scheduler_tpu_torch.rollout.registry import CheckpointRegistry
from k8s_llm_scheduler_tpu_torch.train import distill
from k8s_llm_scheduler_tpu_torch.train.train_step import (
    adamw,
    causal_lm_loss,
    make_train_step,
    param_leaves,
)

ttesting.cap_torch_threads()

REPO = Path(__file__).resolve().parent.parent
JTINY = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TTINY = dataclasses.replace(tconfigs.TINY, dtype=torch.float32)
B, S = 2, 64
LR = 1e-3


def _jax_params(seed=0, cfg=JTINY):
    return jax.tree_util.tree_map(np.asarray, jinit_params(jax.random.PRNGKey(seed), cfg))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, JTINY.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([S, 40], dtype=np.int32)
    starts = np.array([20, 9], dtype=np.int32)
    weights = rng.uniform(0.5, 3.0, size=(B, S)).astype(np.float32)
    return tokens, lens, starts, weights


def _jax_loss_fn(tokens, lens, starts, weights):
    def loss_fn(params):
        logits, _, _ = jforward_prefill(params, JTINY, tokens, lens, remat=True)
        return jts.causal_lm_loss(logits, tokens, lens, starts, weights)
    return loss_fn


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _torch_state(np_params):
    init_fn, step_fn = make_train_step(TTINY, "cpu", optimizer=adamw(LR))
    return init_fn(params_from_jax(np_params, device="cpu")), step_fn


# ------------------------------------------------------------------ corpus
def test_corpus_code_is_the_reference_text():
    def body(text):
        return text[text.index("ANSWER_PREFIX = "):text.index("def numeric_embedding_init(")]

    want = body((REPO / "k8s_llm_scheduler_tpu/train/distill.py").read_text()).replace(
        "k8s_llm_scheduler_tpu.", "k8s_llm_scheduler_tpu_torch.")
    assert body((REPO / "k8s_llm_scheduler_tpu_torch/train/distill.py").read_text()) == want


BATCH_CASES = {
    "direct": dict(tok="byte", seq_len=1024, kw=dict(
        easy_frac=0.3, placement_frac=0.3, diverse_frac=0.2, prompt_lm_frac=0.3)),
    "cot": dict(tok="numeric", seq_len=1024, kw=dict(
        answer_style="cot", micro_frac=0.5, easy_frac=0.2, placement_frac=0.2,
        cot_weight=2.0, name_weight=9.0)),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_make_batches_equal_to_jax(case):
    c = BATCH_CASES[case]
    jtok, ttok = ((JNumericTokenizer(), NumericTokenizer()) if c["tok"] == "numeric"
                  else (JByteTokenizer(), ByteTokenizer()))
    got = distill.make_batches(ttok, 3, c["seq_len"], seed=5, **c["kw"])
    want = jdistill.make_batches(jtok, 3, c["seq_len"], seed=5, **c["kw"])
    for _ in range(3):
        for g, w in zip(next(got), next(want)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# -------------------------------------------------------------------- loss
@pytest.mark.parametrize("start,weights", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_causal_lm_loss_matches_jax(start, weights):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((B, S, 97)) * 3).astype(np.float32)
    tokens = rng.integers(0, 97, size=(B, S)).astype(np.int32)
    lens = np.array([S, 23], dtype=np.int32)
    st = np.array([30, 0], dtype=np.int32) if start else None
    w = rng.uniform(0.0, 4.0, size=(B, S)).astype(np.float32) if weights else None
    want = float(jts.causal_lm_loss(jnp.asarray(logits), jnp.asarray(tokens),
                                    jnp.asarray(lens), st, w))
    got = float(causal_lm_loss(
        torch.from_numpy(logits), torch.from_numpy(tokens), torch.from_numpy(lens),
        None if st is None else torch.from_numpy(st),
        None if w is None else torch.from_numpy(w)))
    assert abs(got - want) <= 1e-6


# -------------------------------------------------------------------- step
@pytest.fixture(scope="module")
def jax_train():
    """JAX's make_train_step with optax.adamw(LR), and a TrainState maker
    from a numpy params tree."""
    optimizer = optax.adamw(LR)
    _, j_step = jts.make_train_step(JTINY, mesh_from_config(None), optimizer)

    def state(np_params):
        jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
        return jts.TrainState(jparams, optimizer.init(jparams), jnp.zeros((), jnp.int32))

    return j_step, state


@pytest.fixture(scope="module")
def one_step(jax_train):
    """One step of each package from the same weights and batch: (JAX loss,
    JAX grads, JAX params after, port loss, port grads, port params after),
    the trees flattened to numpy by dotted name."""
    j_step, j_state_of = jax_train
    np_params = _jax_params()
    batch = _batch()
    j_state = j_state_of(np_params)
    j_loss, j_grads = jax.jit(jax.value_and_grad(_jax_loss_fn(*batch)))(j_state.params)
    j_state, j_step_loss = j_step(j_state, *batch)
    assert abs(float(j_step_loss) - float(j_loss)) <= 1e-6

    state, step_fn = _torch_state(np_params)
    state, t_loss = step_fn(state, *step_fn.place_batch(*batch))
    t_grads = {k: v.grad.numpy() for k, v in _flat(state.params).items()}
    t_after = {k: v.detach().numpy() for k, v in _flat(state.params).items()}
    as_np = lambda tree: {k: np.asarray(v) for k, v in _flat(tree).items()}  # noqa: E731
    return (float(j_loss), as_np(j_grads), as_np(j_state.params), float(t_loss),
            t_grads, t_after)


def test_one_step_loss_matches_jax(one_step):
    j_loss, _, _, t_loss, _, _ = one_step
    assert abs(t_loss - j_loss) <= 1e-5


def test_one_step_gradients_match_jax(one_step):
    _, j_grads, _, _, t_grads, _ = one_step
    assert sorted(t_grads) == sorted(j_grads)
    for name, want in j_grads.items():
        np.testing.assert_allclose(t_grads[name], want, rtol=1e-4, atol=1e-6, err_msg=name)


def test_one_step_weights_match_jax(one_step):
    _, j_grads, j_after, _, _, t_after = one_step
    flips = total = 0
    for name, want in j_after.items():
        off = np.abs(t_after[name] - want) > 1e-3 * LR
        tiny = np.abs(j_grads[name]) < 1e-6
        assert not (off & ~tiny).any(), name
        flips += int((off & tiny).sum())
        total += want.size
    assert flips < 1e-3 * total


def test_three_steps_losses_match_jax(jax_train):
    j_step, j_state_of = jax_train
    np_params = _jax_params(seed=2)
    j_state = j_state_of(np_params)
    state, step_fn = _torch_state(np_params)
    for i in range(3):
        batch = _batch(seed=10 + i)
        j_state, j_loss = j_step(j_state, *batch)
        state, t_loss = step_fn(state, *step_fn.place_batch(*batch))
        assert abs(float(t_loss) - float(j_loss)) <= 1e-4, i
    assert state.step == 3


def test_cosine_schedule_matches_optax():
    lr, steps = 3e-4, 20
    warmup = max(1, min(steps // 10, 500))
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=warmup,
        decay_steps=max(steps, warmup + 1), end_value=lr * 0.05)
    got = distill.warmup_cosine_schedule(lr, steps)
    assert got(0) == 0.0
    for n in range(steps + 3):
        assert got(n) == pytest.approx(float(want(n)), rel=1e-6, abs=1e-12), n


def test_step_applies_the_schedule_at_the_update_count():
    seen = []
    init_fn, step_fn = make_train_step(TTINY, "cpu", lr_schedule=lambda n: seen.append(n) or 0.0)
    state = init_fn(0)
    before = [t.detach().clone() for t in param_leaves(state.params)]
    for _ in range(2):
        state, _ = step_fn(state, *step_fn.place_batch(*_batch()[:2]))
    assert seen == [0, 1]
    # lr 0: Adam moves nothing and decoupled decay is scaled by lr too
    assert all(torch.equal(a, b) for a, b in zip(before, param_leaves(state.params)))


def test_remat_matches_plain_forward():
    np_params = _jax_params(seed=3)
    tokens, lens, starts, weights = (torch.from_numpy(a) for a in _batch(seed=4))
    out = []
    for remat in (False, True):
        params = params_from_jax(np_params, device="cpu")
        leaves = param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        logits, k_all, _ = forward_prefill(params, TTINY, tokens, lens, remat=remat)
        loss = causal_lm_loss(logits, tokens, lens, starts, weights)
        loss.backward()
        assert not k_all.requires_grad
        out.append((float(loss.detach()), [t.grad for t in leaves]))
    (l0, g0), (l1, g1) = out
    assert abs(l0 - l1) <= 1e-6
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


BF16_GRAD_FACTOR = 1.5  # the port's distance from f32 over the JAX step's


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(float(np.linalg.norm(b)), 1e-30))


def test_bf16_embedding_gradient_lands_as_far_from_f32_as_the_jax_step():
    """One bf16 step's gradients against the same package's f32 gradients,
    on the same weights and batch (TINY ties its embeddings, so `embed`
    sums the lookup's scatter and the head's product): every leaf of the
    port, `embed` first, is no further from f32 than BF16_GRAD_FACTOR
    times the JAX step's distance for that leaf, and `embed` no further
    than the port's farthest other leaf (on this config both packages
    land near 0.02 for every leaf)."""
    np_params = _jax_params(seed=7)
    batch = _batch(seed=8)

    def jax_grads(dtype):
        cfg = dataclasses.replace(JTINY, dtype=dtype)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), np_params)

        def loss_fn(p):
            logits, _, _ = jforward_prefill(p, cfg, batch[0], batch[1], remat=True)
            return jts.causal_lm_loss(logits, batch[0], batch[1], batch[2], batch[3])

        grads = jax.jit(jax.grad(loss_fn))(params)
        return {k: np.asarray(v, np.float32) for k, v in _flat(grads).items()}

    def port_grads(dtype):
        cfg = dataclasses.replace(TTINY, dtype=dtype)
        init_fn, step_fn = make_train_step(
            cfg, "cpu", optimizer=lambda leaves: torch.optim.SGD(leaves, lr=0.0))
        params = jax.tree_util.tree_map(lambda t: t.to(dtype),
                                        params_from_jax(np_params, device="cpu"))
        state, _ = step_fn(init_fn(params), *step_fn.place_batch(*batch))
        return {k: v.grad.float().numpy() for k, v in _flat(state.params).items()}

    j32, j16 = jax_grads(jnp.float32), jax_grads(jnp.bfloat16)
    t32, t16 = port_grads(torch.float32), port_grads(torch.bfloat16)
    assert sorted(t16) == sorted(j16)
    jax_err = {k: _rel(j16[k], j32[k]) for k in j32}
    port_err = {k: _rel(t16[k], t32[k]) for k in t32}
    print("bf16 gradient's distance from f32 (JAX, port): "
          + ", ".join(f"{k} {jax_err[k]:.4f} {port_err[k]:.4f}" for k in sorted(jax_err)))
    for name in sorted(port_err, key=lambda k: k != "embed"):
        assert port_err[name] <= BF16_GRAD_FACTOR * jax_err[name], (name, port_err, jax_err)
    assert port_err["embed"] <= max(v for k, v in port_err.items() if k != "embed")


def test_return_hidden_is_the_pre_norm_residual():
    np_params = _jax_params(seed=5)
    tokens, lens = _batch(seed=6)[:2]
    _, _, _, jx = jforward_prefill(jax.tree_util.tree_map(jnp.asarray, np_params), JTINY,
                                   tokens, lens, return_logits=False, return_hidden=True)
    logits, _, _, x = forward_prefill(params_from_jax(np_params, device="cpu"), TTINY,
                                      torch.from_numpy(tokens), torch.from_numpy(lens),
                                      return_logits=False, return_hidden=True)
    assert logits is None
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-4)


def test_a_one_rank_mesh_trains_as_one_device():
    """mesh_from_config(None) (one rank) gives the one-device step, with
    the same loss; ring attention needs a mesh with an sp axis."""
    from k8s_llm_scheduler_tpu_torch.parallel.mesh import mesh_from_config

    batch = _batch()
    losses = []
    for mesh in (None, mesh_from_config(None)):
        init_fn, step_fn = make_train_step(TTINY, "cpu", optimizer=adamw(LR), mesh=mesh)
        state = init_fn(params_from_jax(_jax_params(), device="cpu"))
        losses.append(float(step_fn(state, *step_fn.place_batch(*batch))[1]))
    assert losses[0] == losses[1]
    with pytest.raises(ValueError, match="ring attention needs"):
        make_train_step(TTINY, "cpu", use_ring_attention=True)


# ------------------------------------------------- probes and numeric init
def _numeric_cfgs():
    return (dataclasses.replace(JTINY, vocab_size=JNumericTokenizer.VOCAB),
            dataclasses.replace(TTINY, vocab_size=NumericTokenizer.VOCAB))


def test_numeric_embedding_init_matches_jax():
    jcfg, _ = _numeric_cfgs()
    np_params = _jax_params(seed=7, cfg=jcfg)
    jtree = dict(np_params)
    jdistill.numeric_embedding_init(jtree, JNumericTokenizer())
    params = params_from_jax(np_params, device="cpu")
    distill.numeric_embedding_init(params, NumericTokenizer())
    np.testing.assert_array_equal(params["embed"].numpy(), np.asarray(jtree["embed"]))
    before = params["embed"].clone()
    distill.numeric_embedding_init(params, ByteTokenizer())  # a no-op
    assert torch.equal(params["embed"], before)


@pytest.mark.parametrize("style", ["direct", "cot"])
def test_agreement_probe_matches_jax(style):
    jcfg, tcfg = _numeric_cfgs()
    np_params = _jax_params(seed=8, cfg=jcfg)
    kw = dict(n_cases=6, n_nodes=4, seq_len=768, answer_style=style)
    want = jdistill.make_agreement_probe(jcfg, JNumericTokenizer(), **kw)(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    got = distill.make_agreement_probe(tcfg, NumericTokenizer(), device="cpu", **kw)(
        params_from_jax(np_params, device="cpu"))
    assert got == want


def test_cot_diagnostics_match_jax():
    jcfg, tcfg = _numeric_cfgs()
    np_params = _jax_params(seed=9, cfg=jcfg)
    kw = dict(n_cases=3, n_nodes=3, seq_len=768)
    want = jdistill.make_cot_diagnostics(jcfg, JNumericTokenizer(), **kw)(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    got = distill.make_cot_diagnostics(tcfg, NumericTokenizer(), device="cpu", **kw)(
        params_from_jax(np_params, device="cpu"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k


# --------------------------------------------------------- train_and_save
TRAIN_KW = dict(steps=3, batch_size=2, seq_len=512, log_every=1, lr=1e-3,
                lr_schedule="cosine", device="cpu")


def _leaves_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k].detach(), fb[k]) for k in fa)


def test_train_and_save_resume_publish_restore(tmp_path):
    out = tmp_path / "ckpt"
    reg = tmp_path / "registry"
    seen = []
    kept = {}

    def on_step(step, loss, state):
        seen.append((step, float(loss)))
        kept["params"] = state.params

    loss = distill.train_and_save(TTINY, str(out), registry_dir=str(reg),
                                  on_step=on_step, **TRAIN_KW)
    assert [s for s, _ in seen] == [1, 2, 3] and loss == seen[-1][1]
    assert all(np.isfinite(v) for _, v in seen)
    trained = restore_checkpoint(out, TTINY, device="cpu")
    assert _leaves_equal(kept["params"], trained)
    manifest = CheckpointRegistry(str(reg)).latest()
    assert manifest.version == 1
    assert manifest.scores["train"]["final_loss"] == round(loss, 6)
    assert manifest.scores["train"]["steps"] == 3

    # a crash inside save_checkpoint's swap leaves the newest snapshot at
    # .saving or the previous one at .old: resume finds either
    for suffix in (".saving", ".old"):
        side = tmp_path / f"ckpt{suffix}"
        os.rename(out, side)
        distill.train_and_save(TTINY, str(out), resume=True,
                               **{**TRAIN_KW, "steps": 0})
        assert _leaves_equal(trained, restore_checkpoint(out, TTINY, device="cpu"))
        assert not side.exists()  # the save's own swap consumed it

    # resuming trains on from the restored params, not a fresh init
    first = {}
    distill.train_and_save(TTINY, str(out), resume=True, seed=1,
                           on_step=lambda s, l, st: first.setdefault("loss", float(l)),
                           **{**TRAIN_KW, "steps": 1})
    fresh = {}
    distill.train_and_save(TTINY, str(tmp_path / "fresh"), seed=1,
                           on_step=lambda s, l, st: fresh.setdefault("loss", float(l)),
                           **{**TRAIN_KW, "steps": 1})
    assert first["loss"] != fresh["loss"]


@pytest.mark.parametrize("axes", [{"dp": 2}, {"tp": 2}], ids=["dp2", "tp2"])
def test_train_and_save_on_a_mesh_saves_the_whole_tree(tmp_path, axes):
    """Two ranks (this process and one spawned) step on the same batches as
    one device does: the same losses (within 1e-4: tp sums its partial
    products in f32), and the coordinator saves the whole tree, which
    restores at tp 1 and whose slice is this rank's params."""
    from k8s_llm_scheduler_tpu_torch.parallel import sharding
    from k8s_llm_scheduler_tpu_torch.parallel.mesh import make_mesh

    seen, kept, single = [], {}, []
    distill.train_and_save(TTINY, str(tmp_path / "one"),
                           on_step=lambda s, l, st: single.append(float(l)), **TRAIN_KW)

    def on_step(step, loss, state):
        seen.append(float(loss))
        kept["params"] = state.params

    loss = distill.train_and_save(TTINY, str(tmp_path / "mesh"), mesh_axes=axes,
                                  on_step=on_step, **TRAIN_KW)
    assert loss == seen[-1]
    np.testing.assert_allclose(seen, single, rtol=1e-4, atol=1e-4)
    whole = restore_checkpoint(tmp_path / "mesh", TTINY, device="cpu")
    rank0 = sharding.shard_params(whole, make_mesh(axes), 0,
                                  sharding.param_specs(TTINY, tp="tp" if "tp" in axes else None))
    assert _leaves_equal(kept["params"], rank0)
    assert whole["embed"].shape == (TTINY.vocab_size, TTINY.d_model)


def test_cli_train_writes_a_restorable_checkpoint(tmp_path):
    out = tmp_path / "cli_ckpt"
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    env.pop("LLM_MODEL", None)
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_llm_scheduler_tpu_torch.cli", "train", "--out",
         str(out), "--model", "tiny", "--steps", "2", "--batch-size", "2",
         "--seq-len", "512", "--no-publish", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"checkpoint at {out}" in proc.stdout
    params = restore_checkpoint(out, tconfigs.TINY, device="cpu")
    assert params["embed"].shape == (tconfigs.TINY.vocab_size, tconfigs.TINY.d_model)


def test_cli_train_on_a_dp2_mesh_writes_a_checkpoint_that_serves_at_tp1(tmp_path):
    """`cli train` with `llm.mesh: {dp: 2}` in the config spawns its second
    rank; the checkpoint serves a decision from a tp=1 backend."""
    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes

    out = tmp_path / "mesh_ckpt"
    (tmp_path / "config.yaml").write_text('{"llm": {"mesh": {"dp": 2}}}')
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": str(ttesting.TEST_TORCH_THREADS)}
    env.pop("LLM_MODEL", None)
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_llm_scheduler_tpu_torch.cli", "train", "--out",
         str(out), "--model", "tiny", "--steps", "2", "--batch-size", "2",
         "--seq-len", "512", "--no-publish", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"checkpoint at {out}" in proc.stdout
    assert "dp group [0, 1]" in proc.stderr
    backend = build_local_backend("tiny", device="cpu", checkpoint_path=str(out),
                                  temperature=0.0)
    try:
        nodes = synthetic_nodes(3)
        decision = backend.get_scheduling_decision(fixture_pods(1)[0], nodes)
        assert decision.selected_node in {n.name for n in nodes}
    finally:
        backend.close()


def test_cli_train_refuses_cot_knobs_without_cot(tmp_path, monkeypatch, capsys):
    from k8s_llm_scheduler_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LLM_ANSWER_STYLE", raising=False)
    rc = cli.main(["train", "--out", str(tmp_path / "x"), "--micro-frac", "0.5",
                   "--device", "cpu"])
    assert rc == 2
    assert "llm.answer_style: cot" in capsys.readouterr().err
    assert not (tmp_path / "x").exists()
