"""On-device sampling for the fused decode loop (the port of the JAX
package's engine/fused/sampler.py).

One function, called once per loop step on the device: grammar mask
(dense-table gather) or pad/vocab-limit mask, then greedy or temperature /
top-k selection. Where the JAX sampler threads a PRNG key through the loop,
the port samples by inverse CDF from uniforms drawn with the engine's
explicit `torch.Generator`, registered with every CUDA graph
(engine/graphs.py), so each replay draws afresh: sampled streams match
JAX's in distribution, never in bytes. The fused loop passes each step its
own row of uniforms drawn before the loop (`u`, engine/fused/loop.py): a
CUDA graph's WHILE body replays the same Philox offsets at every
iteration, so a draw made inside the body would repeat across the steps.

Greedy (temperature == 0) is TOKEN-IDENTICAL to the chunked path's K-space
sparse sampling: both argmax the same allowed logit set and both break ties
toward the lowest token id (`torch.argmax` returns the first maximum, as
`jnp.argmax` does; tests/test_torch_fused.py pins it). Top-k restricts only
the SAMPLED distribution: the greedy branch reads the unrestricted masked
logits, so turning top-k on never changes a greedy decode.
"""

from __future__ import annotations

import torch

from k8s_llm_scheduler_tpu_torch.ops.attention import NEG_INF


def inverse_cdf(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One draw a row of `probs` [R, V] from the uniforms `u` [R] in [0, 1):
    the first id whose cumulative probability exceeds u times the row's
    total, as int32. The sum runs in f64, so an id of probability 0 (its
    cumulative sum equal to its predecessor's) is never drawn, and u times
    the total stays below the total."""
    cdf = probs.double().cumsum(-1)
    v = u.double()[:, None] * cdf[:, -1:]
    tok = torch.searchsorted(cdf, v, right=True)[:, 0]
    return tok.clamp_(max=probs.shape[-1] - 1).int()


def sample_fused(
    logits: torch.Tensor,      # [R, V] f32
    st: torch.Tensor,          # [R] int32 current DFA states (ignored unconstrained)
    dense_next: torch.Tensor,  # [S, V] int32 transition table (-1 disallowed)
    gen: torch.Generator | None,
    temperature: float,        # 0 = greedy
    top_k: int,                # 0 = full distribution
    constrained: bool,
    pad_id: int,
    vocab_limit: int | None = None,
    u: torch.Tensor | None = None,  # [R] f32 uniforms in [0, 1); drawn from gen if None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (token [R] int32, next_state [R] int32).

    Constrained: the allowed mask is `dense_next[st] >= 0` and the
    transition is one gather. Unconstrained: pad (the idle-slot sentinel)
    and ids past the tokenizer's table are masked, exactly as the chunked
    path does; next_state passes through. A sampled row draws its token
    from `u` (one uniform a row), or from `gen` when `u` is None."""
    V = logits.shape[-1]
    if constrained:
        rows = dense_next[st.long()]  # [R, V]
        masked = torch.where(rows >= 0, logits, NEG_INF)
    else:
        ids = torch.arange(V, device=logits.device)[None, :]
        bad = ids == pad_id
        if vocab_limit is not None and vocab_limit < V:
            bad = bad | (ids >= vocab_limit)
        masked = torch.where(bad, NEG_INF, logits)

    if temperature > 0:
        sample_logits = masked
        if top_k and 0 < top_k < V:
            kth = torch.topk(masked, top_k, dim=-1).values[..., -1:]
            sample_logits = torch.where(masked < kth, NEG_INF, masked)
        probs = torch.softmax(sample_logits / max(temperature, 1e-6), dim=-1)
        if u is None:
            u = torch.rand(probs.shape[0], generator=gen, device=probs.device)
        tok = inverse_cdf(probs, u)
    else:
        tok = torch.argmax(masked, dim=-1).int()

    if constrained:
        nxt = torch.gather(rows, 1, tok.long()[:, None])[:, 0]
        # A sampled token is always allowed for a live state; a state with
        # no out-edges (never reachable: done self-loops on pad) would yield
        # -1, clamped to "stay" so idle rows can't corrupt st.
        new_st = torch.where(nxt >= 0, nxt, st).int()
    else:
        new_st = st
    return tok, new_st
