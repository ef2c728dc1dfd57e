"""Hidden-transfer head training: teach the target to predict its own future.

The port of the JAX package's train/hidden.py (*Hidden Transfer*,
PAPERS.md). The draft-free speculative arm (spec/hidden.py) proposes K
future tokens from per-offset transfer matrices over the target's
final-layer hidden state (models/llama.init_hidden_transfer). This module
trains exactly those matrices: the target model is frozen (its forward runs
under torch.no_grad, and only the [K, D, D] head takes a gradient), so
training is cheap enough to run at 8B on one card and the serving weights
are untouched by construction.

Batches come from train/distill.make_batches, the teacher-decision
sequences the draft arm distills on. The loss is cross entropy per head at
its serving offset: the hidden state at position p predicts token p+1
through the LM head, and head h (0-based) scores token p+2+h, the (h+1)-th
token after the next one, which is what spec/hidden.py proposes it as;
positions whose target lies past the sequence are masked out.

The head is saved as a native checkpoint (models/loader.save_checkpoint of
the tree {"transfer": [K, D, D]}); `registry_dir` also publishes it through
the rollout registry with the target config's fingerprint and the train
scores. `restore_hidden_transfer` reads it back for
`llm.spec_draft_checkpoint` with `llm.spec_arm: hidden`.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch
import torch.nn.functional as F

from k8s_llm_scheduler_tpu_torch.device import resolve_device
from k8s_llm_scheduler_tpu_torch.models.llama import (
    Params,
    forward_prefill,
    hidden_transfer_logits,
    init_hidden_transfer,
)

logger = logging.getLogger(__name__)


def hidden_transfer_loss(params: Params, cfg, ht: Params, tokens, seq_lens) -> torch.Tensor:
    """Mean masked cross entropy of every head's offset prediction.

    tokens [B, S]; head h's logits at position p score token p+2+h.
    Positions whose target falls at or past seq_len (or past S) are masked
    out. The target's forward runs without gradient tracking; the loss is
    differentiable in `ht` only."""
    B, S = tokens.shape
    K = ht["transfer"].shape[0]
    with torch.no_grad():
        *_, x = forward_prefill(params, cfg, tokens, seq_lens, return_logits=False,
                                return_hidden=True)  # [B, S, D]
    logits = hidden_transfer_logits(params, cfg, ht, x)  # [B, S, K, V] f32
    logp = F.log_softmax(logits, dim=-1)
    pos = torch.arange(S, device=tokens.device)
    total = logp.new_zeros(())
    count = logp.new_zeros(())
    for h in range(K):
        off = h + 2  # hidden at p predicts p+1; head h predicts p+1+(h+1)
        tgt = tokens[:, torch.clamp(pos + off, 0, S - 1)].long()  # [B, S]
        lp = logp[:, :, h, :].gather(-1, tgt[..., None])[..., 0]  # [B, S]
        valid = (pos[None, :] + off < seq_lens[:, None]).float()
        total = total - (lp * valid).sum()
        count = count + valid.sum()
    return total / torch.clamp(count, min=1.0)


def hidden_transfer_step(params, cfg, ht, optimizer, tokens, seq_lens) -> torch.Tensor:
    """One update of the head `ht` (in place, through `optimizer`, which
    holds ht's tensors) against frozen `params`; the loss, a 0-dim tensor."""
    optimizer.zero_grad(set_to_none=True)
    loss = hidden_transfer_loss(params, cfg, ht, tokens, seq_lens)
    loss.backward()
    optimizer.step()
    return loss.detach()


def restore_hidden_transfer(path, cfg, k: int, *, device="cuda") -> Params:
    """Read a head checkpoint (train_hidden_transfer's out_dir, or a registry
    version's checkpoint dir) onto `device` in cfg's dtype, checked against
    the serving geometry first: a head trained for another d_model or K
    raises, rather than proposing garbage."""
    from k8s_llm_scheduler_tpu_torch.models.loader import read_native

    tree = read_native(path)
    t = tree.get("transfer") if isinstance(tree, dict) else None
    if not isinstance(t, torch.Tensor) or tuple(t.shape) != (k, cfg.d_model, cfg.d_model):
        raise ValueError(
            f"hidden-transfer checkpoint at {path} has shape "
            f"{tuple(t.shape) if isinstance(t, torch.Tensor) else None}; serving needs "
            f"[{k}, {cfg.d_model}, {cfg.d_model}]"
        )
    return {"transfer": t.to(device=resolve_device(device), dtype=cfg.dtype)}


def train_hidden_transfer(
    params: Params,
    cfg,
    *,
    k: int = 4,
    steps: int = 200,
    batch_size: int = 4,
    seq_len: int = 512,
    lr: float = 1e-3,
    seed: int = 0,
    tokenizer=None,
    batches=None,
    out_dir: str | None = None,
    registry_dir: str | None = None,
    publish_note: str = "",
    log_every: int = 50,
    on_step=None,
) -> tuple[Params, float]:
    """Train a fresh [k, D, D] hidden-transfer head (init_hidden_transfer from
    `seed`, on the params' device) against frozen `params` with AdamW at
    optax.adamw's settings. Returns (head, final loss).

    `batches`: an iterator of (tokens [B, S], seq_lens [B]) that overrides
    the distill stream. `out_dir` saves a native checkpoint; `registry_dir`
    also publishes it with provenance. `on_step(step, loss, head)`, when
    given, is called after each update (step from 1; `loss` a 0-dim device
    tensor)."""
    from k8s_llm_scheduler_tpu_torch.train.train_step import adamw

    dev = params["embed"].device
    ht = init_hidden_transfer(cfg, k, seed=seed, device=dev)
    ht["transfer"].requires_grad_(True)
    optimizer = adamw(lr)([ht["transfer"]])
    if batches is None:
        if tokenizer is None:
            from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer

            tokenizer = ByteTokenizer()
        from k8s_llm_scheduler_tpu_torch.train.distill import make_batches

        batches = (
            (tokens, seq_lens)
            for tokens, seq_lens, _starts, _w in make_batches(
                tokenizer, batch_size, seq_len, seed=seed)
        )
    loss_t = torch.tensor(float("nan"))
    for i in range(steps):
        tokens, seq_lens = next(batches)
        loss_t = hidden_transfer_step(
            params, cfg, ht, optimizer,
            torch.as_tensor(tokens).to(dev, torch.long),
            torch.as_tensor(seq_lens).to(dev, torch.int32),
        )
        if on_step is not None:
            on_step(i + 1, loss_t, ht)
        if log_every and (i % log_every == 0 or i == steps - 1):
            logger.info("hidden-transfer step %d loss %.4f", i, float(loss_t))
    loss = float(loss_t)
    ht = {"transfer": ht["transfer"].detach()}

    if out_dir is not None:
        from k8s_llm_scheduler_tpu_torch.models.loader import save_checkpoint

        save_checkpoint(Path(out_dir), ht)
        if registry_dir is not None:
            from k8s_llm_scheduler_tpu_torch.rollout.registry import CheckpointRegistry

            manifest = CheckpointRegistry(registry_dir).publish(
                out_dir,
                cfg=cfg,
                config_name=f"{cfg.name}-hidden-k{k}",
                scores={"hidden_transfer_loss": loss, "hidden_k": k, "steps": steps},
                note=publish_note or "hidden-transfer head (train/hidden.py)",
            )
            logger.info("hidden-transfer head published as registry v%d",
                        manifest.version)
    return ht, loss
