"""The port's hidden-transfer head training (train/hidden.py), its checkpoint
and its serving, held against the JAX package's on the CPU, TINY in f32.

- `hidden_transfer_loss` on the same weights, head and batch as JAX's:
  within 1e-5; only the head takes a gradient.
- One head step (`hidden_transfer_step`, AdamW at optax.adamw's settings)
  from the same converted head against JAX's value_and_grad + optax.adamw
  update: the loss within 1e-5, the gradient within rtol 1e-4 / atol 1e-6,
  the head after the step within 1e-3 * lr except where |JAX grad| < 1e-6
  (Adam's first step is +-lr there: fewer than 0.1% of the elements).
- `train_hidden_transfer` with `batches=`: the loss falls, the head is
  saved and published, and `restore_hidden_transfer` gives it back; a head
  of another K or d_model raises.
- `_attach_spec` / `build_local_backend(spec_arm="hidden",
  spec_draft_checkpoint=...)` serve the saved head: greedy speculative
  `generate` equals plain `generate` token for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models.llama import init_hidden_transfer as jinit_hidden
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.train import hidden as jhidden
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
from k8s_llm_scheduler_tpu_torch.engine.local import _attach_spec, build_local_backend
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.models.loader import save_checkpoint
from k8s_llm_scheduler_tpu_torch.rollout.registry import CheckpointRegistry
from k8s_llm_scheduler_tpu_torch.train.hidden import (
    hidden_transfer_loss,
    hidden_transfer_step,
    restore_hidden_transfer,
    train_hidden_transfer,
)
from k8s_llm_scheduler_tpu_torch.train.train_step import adamw

ttesting.cap_torch_threads()

JTINY = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TTINY = dataclasses.replace(tconfigs.TINY, dtype=torch.float32)
K, LR = 3, 1e-3
TOK = ByteTokenizer()
PROMPT = TOK.encode("The quick brown fox jumps over the lazy dog. " * 2)
ENGINE = dict(num_pages=96, page_size=64, max_slots=4, max_pages_per_seq=16,
              prefill_buckets=(128, 256, 512), chunk_steps=8, temperature=0.0)


@pytest.fixture(scope="module")
def weights():
    """The JAX target and head as numpy trees, and a batch."""
    np_params = jax.tree_util.tree_map(
        np.asarray, jinit_params(jax.random.PRNGKey(0), JTINY))
    # a head large enough that the offsets matter (the init is ~x)
    np_head = {"transfer": np.asarray(
        jinit_hidden(jax.random.PRNGKey(1), JTINY, K)["transfer"]) * 40.0}
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, size=(2, 48)).astype(np.int32)
    lens = np.array([48, 30], dtype=np.int32)
    return np_params, np_head, tokens, lens


def _jax(weights):
    np_params, np_head, tokens, lens = weights
    as_jnp = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    return as_jnp(np_params), as_jnp(np_head), tokens, lens


def _port(weights):
    np_params, np_head, tokens, lens = weights
    return (params_from_jax(np_params, device="cpu"), params_from_jax(np_head, device="cpu"),
            torch.from_numpy(tokens).long(), torch.from_numpy(lens))


@pytest.fixture(scope="module")
def jax_step(weights):
    """JAX's loss, head gradient and head after one optax.adamw(LR) update."""
    jp, jh, tokens, lens = _jax(weights)
    tokens, lens = jnp.asarray(tokens), jnp.asarray(lens)
    loss, grad = jax.jit(jax.value_and_grad(
        lambda h: jhidden.hidden_transfer_loss(jp, JTINY, h, tokens, lens)))(jh)
    optimizer = optax.adamw(LR)
    updates, _ = optimizer.update(grad, optimizer.init(jh), jh)
    after = optax.apply_updates(jh, updates)["transfer"]
    return float(loss), np.asarray(grad["transfer"]), np.asarray(after)


def test_hidden_transfer_loss_matches_jax(weights, jax_step):
    params, head, t_tokens, t_lens = _port(weights)
    head["transfer"].requires_grad_(True)
    loss = hidden_transfer_loss(params, TTINY, head, t_tokens, t_lens)
    assert abs(float(loss.detach()) - jax_step[0]) <= 1e-5
    loss.backward()
    assert head["transfer"].grad is not None
    assert all(not t.requires_grad for t in params["layers"].values())


def test_one_head_step_matches_jax(weights, jax_step):
    j_loss, j_grad, j_after = jax_step
    params, head, t_tokens, t_lens = _port(weights)
    head["transfer"].requires_grad_(True)
    loss = hidden_transfer_step(params, TTINY, head, adamw(LR)([head["transfer"]]),
                                t_tokens, t_lens)
    assert abs(float(loss) - j_loss) <= 1e-5
    np.testing.assert_allclose(head["transfer"].grad.numpy(), j_grad, rtol=1e-4, atol=1e-6)
    after = head["transfer"].detach().numpy()
    off = np.abs(after - j_after) > 1e-3 * LR
    tiny = np.abs(j_grad) < 1e-6
    assert not (off & ~tiny).any()
    assert (off & tiny).sum() < 1e-3 * after.size


def _stream(weights):
    _, _, tokens, lens = weights
    while True:
        yield tokens, lens


def test_train_save_publish_restore(weights, tmp_path):
    params = _port(weights)[0]
    out, reg = tmp_path / "head", tmp_path / "registry"
    losses = []
    ht, loss = train_hidden_transfer(
        params, TTINY, k=2, steps=6, lr=1e-2, batches=_stream(weights), out_dir=str(out),
        registry_dir=str(reg), log_every=0,
        on_step=lambda step, l, h: losses.append((step, float(l))))
    assert [s for s, _ in losses] == list(range(1, 7))
    assert loss == losses[-1][1] < losses[0][1]
    assert not ht["transfer"].requires_grad
    manifest = CheckpointRegistry(str(reg)).latest()
    assert manifest.config_name == f"{TTINY.name}-hidden-k2"
    assert manifest.scores["hidden_transfer_loss"] == pytest.approx(loss)
    restored = restore_hidden_transfer(out, TTINY, 2, device="cpu")
    assert torch.equal(restored["transfer"], ht["transfer"])
    with pytest.raises(ValueError, match=r"serving needs \[3, 256, 256\]"):
        restore_hidden_transfer(out, TTINY, 3, device="cpu")
    wide = dataclasses.replace(TTINY, d_model=128)
    with pytest.raises(ValueError, match="serving needs"):
        restore_hidden_transfer(out, wide, 2, device="cpu")
    save_checkpoint(tmp_path / "model", params)  # a model tree is not a head
    with pytest.raises(ValueError, match="has shape None"):
        restore_hidden_transfer(tmp_path / "model", TTINY, 2, device="cpu")


def test_attach_spec_serves_a_trained_head(weights, tmp_path):
    params = _port(weights)[0]
    ht, _ = train_hidden_transfer(params, TTINY, k=2, steps=3, lr=1e-2,
                                  batches=_stream(weights), out_dir=str(tmp_path / "h"),
                                  log_every=0)
    eng = InferenceEngine(params, TTINY, TOK, graphs=False, **ENGINE)
    _attach_spec(eng, arm="hidden", draft_model="tiny", draft_checkpoint=str(tmp_path / "h"),
                 k=2, disable_threshold=0.0, rng_seed=0)
    assert eng.spec.arm == "hidden"
    assert torch.equal(eng.spec.hidden_head["transfer"], ht["transfer"])
    fin = eng.generate(PROMPT, 16)
    assert eng.spec.stats.rounds > 0
    assert fin.token_ids == eng.generate(PROMPT, 16, use_spec=False).token_ids
    with pytest.raises(ValueError, match="serving needs"):
        _attach_spec(eng, arm="hidden", draft_model="tiny",
                     draft_checkpoint=str(tmp_path / "h"), k=3, disable_threshold=0.0,
                     rng_seed=0)


def test_config_route_serves_the_head_in_the_models_dtype(weights, tmp_path):
    ht, _ = train_hidden_transfer(_port(weights)[0], TTINY, k=2, steps=1,
                                  batches=_stream(weights), out_dir=str(tmp_path / "h"),
                                  log_every=0)
    backend = build_local_backend("tiny", device="cpu", temperature=0.0, spec_enabled=True,
                                  spec_arm="hidden", spec_draft_checkpoint=str(tmp_path / "h"),
                                  spec_k=2)
    try:
        head = backend.engine.spec.hidden_head["transfer"]
        assert head.dtype == tconfigs.TINY.dtype
        assert torch.equal(head, ht["transfer"].to(head.dtype))
        assert len(backend.engine.generate(TOK.encode("hello"), 6).token_ids) == 6
    finally:
        backend.close()
