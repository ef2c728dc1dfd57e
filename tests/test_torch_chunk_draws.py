"""The fused decode chunk's sampling (engine/fused/loop.py `fused_draw` /
`step_uniforms`, engine/fused/sampler.py) over probabilities that stay
constant, through `testing.chunk_draws`: 16 runs of a 16-step chunk on 64
slots. A slot's draws across one chunk's steps are independent and follow
the softmax within TV 0.05. The `cuda` case captures the chunk, its steps
one WHILE node whose every iteration replays the same random draw, so only
uniforms drawn before the loop keep the steps independent; it needs a card
(`python -m pytest --noconftest -m cuda tests/test_torch_chunk_draws.py`:
tests/conftest.py imports JAX) and skips without one. This file imports
no JAX, so it runs where the port runs.
"""

import pytest
import torch

from k8s_llm_scheduler_tpu_torch import testing

testing.cap_torch_threads()

TV_LIMIT = 0.05  # test_torch_sampling.py's bound for 4,000 draws; 16,384 here
REPEAT_LIMIT = 0.25  # a step's draw equals step 0's by chance: ~sum(p^2) = 0.04 here


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_chunk_draws_vary_across_steps_and_follow_the_softmax(device):
    """The fused loop's steps sample from their own row of the chunk's
    uniforms: over probabilities that stay constant, a slot's draws across
    one chunk's steps are independent (a draw equals step 0's no more often
    than chance) and follow the softmax within TV 0.05. On a card the steps
    are one WHILE node replayed: a draw made inside its body would repeat
    at every step."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chunk is captured as a CUDA graph")
    rec = testing.chunk_draws(device)
    assert rec["steps_run"] == [16] * 16
    assert rec["repeat"] <= REPEAT_LIMIT, rec
    assert rec["tv"] <= TV_LIMIT, rec
    if device == "cuda":
        assert rec["replays"] == 15  # the first run is the warm-up and capture
