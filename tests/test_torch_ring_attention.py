"""The port's ring attention (parallel/ring_attention.py) against the JAX
package's make_ring_prefill_attention and against full causal attention,
forward and gradient, on the CPU in f32: the cases of
tests/test_parallel.py's TestRingAttention (sp 2 and 4, a padded batch
with lengths mid-chunk, on a chunk boundary and full, and a dp batch
axis beside sp).

The JAX side runs on the 8 virtual CPU devices (tests/conftest.py), its
gradient by jax.grad of sum(out * cotangent); the port's sp ranks are
processes over gloo (parallel/launch.run_spmd, the driver in this
process). Tolerance: atol 2e-4 / rtol 1e-3 for outputs and gradients, the
JAX ring test's bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from k8s_llm_scheduler_tpu.ops.attention import causal_prefill_attention
from k8s_llm_scheduler_tpu.parallel.mesh import make_mesh as jmake_mesh
from k8s_llm_scheduler_tpu.parallel.ring_attention import make_ring_prefill_attention
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.parallel import dryrun, launch
from k8s_llm_scheduler_tpu_torch.parallel.mesh import make_mesh

ttesting.cap_torch_threads()

ATOL, RTOL = 2e-4, 1e-3

CASES = {
    # (mesh axes, batch axis, B, S, H, KV, hd, lens)
    "sp2": ({"sp": 2}, None, 2, 32, 4, 2, 8, None),
    "sp4-padded": ({"sp": 4}, None, 3, 64, 8, 4, 16, [41, 32, 64]),
    "dp2-sp2-padded": ({"dp": 2, "sp": 2}, "dp", 2, 32, 4, 2, 8, [20, 32]),
}


def _inputs(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    cot = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    return q, k, v, cot


def _jax_out_and_grads(attn, q, k, v, lens, cot):
    def f(q, k, v):
        return jnp.sum(attn(q, k, v, lens) * cot)

    out = attn(q, k, v, lens)
    grads = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_matches_the_jax_ring_and_full_attention(case):
    axes, batch_axis, B, S, H, KV, hd, lens = CASES[case]
    q, k, v, cot = _inputs(B, S, H, KV, hd, seed=len(case))
    lens = np.full((B,), S, np.int32) if lens is None else np.asarray(lens, np.int32)
    jring = make_ring_prefill_attention(jmake_mesh(axes), "sp", batch_axis=batch_axis)
    want_ring, want_ring_grads = _jax_out_and_grads(jring, q, k, v, jnp.asarray(lens), cot)
    want_full, want_full_grads = _jax_out_and_grads(
        lambda q, k, v, lens: causal_prefill_attention(q, k, v, lens), q, k, v,
        jnp.asarray(lens), cot)
    got = launch.run_spmd(make_mesh(axes), dryrun.probe_ring,
                          dict(q=q, k=k, v=v, seq_lens=lens, cotangent=cot,
                               batch_axis=batch_axis), device="cpu")
    assert not np.isnan(got["out"]).any()
    np.testing.assert_allclose(got["out"], want_ring, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["out"], want_full, atol=ATOL, rtol=RTOL)
    for name, g, w_ring, w_full in zip("qkv", got["grads"], want_ring_grads,
                                       want_full_grads):
        np.testing.assert_allclose(g, w_ring, atol=ATOL, rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(g, w_full, atol=ATOL, rtol=RTOL, err_msg=name)


def test_sp2_and_sp4_agree():
    q, k, v, cot = _inputs(1, 32, 4, 2, 8, seed=6)
    lens = np.array([32], np.int32)
    outs = [launch.run_spmd(make_mesh({"sp": n}), dryrun.probe_ring,
                            dict(q=q, k=k, v=v, seq_lens=lens, cotangent=cot),
                            device="cpu") for n in (2, 4)]
    np.testing.assert_allclose(outs[0]["out"], outs[1]["out"], atol=ATOL, rtol=RTOL)
    for a, b in zip(outs[0]["grads"], outs[1]["grads"]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)


def test_zero_length_row_attends_nothing():
    """A row of length 0 masks every key: its output is 0 (the den guard),
    not NaN, as the JAX ring's is."""
    q, k, v, cot = _inputs(2, 16, 2, 1, 8, seed=9)
    lens = np.array([0, 11], np.int32)
    got = launch.run_spmd(make_mesh({"sp": 2}), dryrun.probe_ring,
                          dict(q=q, k=k, v=v, seq_lens=lens, cotangent=cot), device="cpu")
    jring = make_ring_prefill_attention(jmake_mesh({"sp": 2}), "sp")
    want = np.asarray(jring(q, k, v, jnp.asarray(lens)))
    assert not np.isnan(got["out"]).any() and not np.abs(got["out"][0]).any()
    np.testing.assert_allclose(got["out"], want, atol=ATOL, rtol=RTOL)
