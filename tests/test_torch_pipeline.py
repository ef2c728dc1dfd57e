"""The port's GPipe trainer (train/pipeline.py) against the JAX package's
make_pp_train_step on the same mesh, on the CPU in f32: {pp2} and
{dp2, pp2}, n_micro 2, and the JAX trainer's refusals
(tests/test_train.py:117-195).

The JAX side runs on the 8 virtual CPU devices (tests/conftest.py), one
compile a layout: its gradients from one optax.sgd(1.0) step (old - new
params, the stage axis folded back into the layer stack), its AdamW
params from optax.adamw(LR) applied to them. The port's stages are
processes over gloo (parallel/launch.run_spmd). Uneven seq_lens, so the
loss is the whole batch's mean. Tolerances (f32) are
test_torch_train_parallel.py's: the loss within 1e-5, gradients within
rtol 1e-4 / atol 1e-6, params within 1e-3 * LR but where |JAX grad| <
1e-6 (fewer than 0.1% of the elements). The embedding and final norm,
which every stage holds, are bit-equal on every rank after the step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.parallel.mesh import make_mesh as jmake_mesh
from k8s_llm_scheduler_tpu.train import pipeline as jpipeline
from k8s_llm_scheduler_tpu.train.train_step import TrainState as JTrainState
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.parallel import dryrun, launch
from k8s_llm_scheduler_tpu_torch.parallel.mesh import make_mesh
from k8s_llm_scheduler_tpu_torch.train.pipeline import make_pp_train_step, stage_params

ttesting.cap_torch_threads()

_CFG = dict(name="pp-test", vocab_size=128, d_model=32, n_layers=4, n_heads=2,
            n_kv_heads=2, d_ff=64, max_seq_len=128, rope_theta=10000.0,
            tie_embeddings=True)
JCFG = jconfigs.LlamaConfig(**_CFG, dtype=jnp.float32)
TCFG = tconfigs.LlamaConfig(**_CFG, dtype=torch.float32)
B, S = 8, 32
LR = 1e-3


def _batch():
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, JCFG.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([32, 20, 32, 7, 32, 31, 1, 32], np.int32)
    return tokens, lens


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _jax_reference(axes, np_params, batch):
    mesh = jmake_mesh(axes)
    pp = axes["pp"]
    sgd = optax.sgd(1.0)
    _, step_fn = jpipeline.make_pp_train_step(JCFG, mesh, sgd, n_micro=2)
    staged = jpipeline.stage_params(jax.tree_util.tree_map(jnp.asarray, np_params), pp)
    specs = {"embed": P(), "final_norm": P(),
             "layers": jax.tree_util.tree_map(lambda _: P("pp"), staged["layers"])}
    params = jax.tree_util.tree_map(lambda a, sp: jax.device_put(a, NamedSharding(mesh, sp)),
                                    staged, specs)
    state = JTrainState(params, sgd.init(params), jnp.zeros((), jnp.int32))
    after, loss = step_fn(state, *step_fn.place_batch(*batch))
    after = jax.tree_util.tree_map(np.asarray, after.params)
    after["layers"] = {k: v.reshape(JCFG.n_layers, *v.shape[2:])
                       for k, v in after["layers"].items()}
    grads = jax.tree_util.tree_map(lambda a, b: a - b, np_params, after)
    adamw = optax.adamw(LR)
    start = jax.tree_util.tree_map(jnp.asarray, np_params)
    updates, _ = adamw.update(jax.tree_util.tree_map(jnp.asarray, grads), adamw.init(start),
                              start)
    stepped = jax.tree_util.tree_map(np.asarray, optax.apply_updates(start, updates))
    return float(loss), _flat(grads), _flat(stepped)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree_util.tree_map(np.asarray, jinit_params(jax.random.PRNGKey(0), JCFG))


@pytest.mark.parametrize("axes", [{"pp": 2}, {"dp": 2, "pp": 2}], ids=["pp2", "dp2-pp2"])
def test_pipeline_step_matches_the_jax_pipeline(axes, np_params):
    batch = _batch()
    j_loss, j_grads, j_after = _jax_reference(axes, np_params, batch)
    got = launch.run_spmd(make_mesh(axes), dryrun.probe_step,
                          dict(cfg=TCFG, batch=batch, params=np_params, lr=LR, device="cpu",
                               pipeline=True, n_micro=2), device="cpu")
    assert abs(got["loss"] - j_loss) <= 1e-5, (got["loss"], j_loss)
    grads, after = _flat(got["grads"]), _flat(got["params"])
    assert sorted(grads) == sorted(j_grads)
    flips = total = 0
    for name, want in j_grads.items():
        np.testing.assert_allclose(grads[name], want, rtol=1e-4, atol=1e-6, err_msg=name)
        off = np.abs(after[name] - j_after[name]) > 1e-3 * LR
        tiny = np.abs(want) < 1e-6
        assert not (off & ~tiny).any(), name
        flips += int((off & tiny).sum())
        total += want.size
    assert flips < 1e-3 * total
    assert got["replicated_equal"]
    assert got["ranks_importing_jax"] == [0]  # rank 0 is this test process


def test_stage_params_splits_the_stack_as_the_jax_one(np_params):
    from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax

    want = jpipeline.stage_params(np_params, 2)
    got = stage_params(params_from_jax(np_params, device="cpu"), 2)
    for k, v in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][k].numpy(), np.asarray(v))


def _bound(axes, rank=0):
    return make_mesh(axes).bind(None, rank, timeout_s=1.0)


def test_pipeline_refusals_match_the_jax_ones():
    with pytest.raises(ValueError, match="pp composes with dp only"):
        jpipeline.make_pp_train_step(JCFG, jmake_mesh({"pp": 2, "tp": 2}))
    with pytest.raises(ValueError, match="pp composes with dp only"):
        make_pp_train_step(TCFG, _bound({"pp": 2, "tp": 2}), "cpu")
    with pytest.raises(ValueError, match="size >= 2"):
        make_pp_train_step(TCFG, _bound({"dp": 2}), "cpu")
    bad = dataclasses.replace(TCFG, n_layers=3)
    init_fn, _ = make_pp_train_step(bad, _bound({"pp": 2}), "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        init_fn(0)
    jinit, _ = jpipeline.make_pp_train_step(dataclasses.replace(JCFG, n_layers=3),
                                            jmake_mesh({"pp": 2}))
    with pytest.raises(ValueError, match="not divisible"):
        jinit(jax.random.PRNGKey(0))


def test_a_local_batch_the_microbatches_do_not_divide_raises():
    init_fn, step_fn = make_pp_train_step(TCFG, _bound({"pp": 2}), "cpu", n_micro=3)
    state = init_fn(0)
    tokens, lens = _batch()
    with pytest.raises(ValueError, match="not divisible by n_micro=3"):
        step_fn(state, *step_fn.place_batch(tokens, lens))
