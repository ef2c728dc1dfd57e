"""Training-mesh dry runs (after the JAX package's `__graft_entry__.
dryrun_multichip` training half and tools/dryrun_multihost.py), and
`probe_step`, one training step on a mesh with everything a check needs.

    python -m k8s_llm_scheduler_tpu_torch.parallel.dryrun [--n 8] [--multihost]
        [--device cpu]

`dryrun_multichip(n)` factors n ranks into dp x sp x tp (tp first, then
sp, then dp) and runs one train step with ring attention over sp, then
dp x pp through the GPipe trainer. `dryrun_multihost()` starts two "hosts"
(processes that rendezvous as parallel/distributed.py's world), each of
two ranks: (1) one dp(across hosts) 2 x tp(within a host) 2 train step
from the same global batch through `place_batch`; (2) a decision served
by each host's tp=2 replica; (3) the bind by the coordinator alone.
Every rank is a process over gloo (on one card the ranks share it).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from k8s_llm_scheduler_tpu_torch.models.configs import LlamaConfig
from k8s_llm_scheduler_tpu_torch.parallel import launch
from k8s_llm_scheduler_tpu_torch.parallel.mesh import make_mesh

DRYRUN = LlamaConfig(
    name="dryrun", vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4,
    d_ff=256, max_seq_len=512, rope_theta=10000.0, dtype=torch.float32,
    tie_embeddings=True,
)
MULTIHOST = dataclasses.replace(DRYRUN, name="dryrun-mh", vocab_size=256, d_model=64,
                                n_kv_heads=2, d_ff=128, max_seq_len=256)
# head dim 64: a width the attention kernels take on a card
MULTIHOST_SERVE = dataclasses.replace(MULTIHOST, name="dryrun-mh-serve", vocab_size=512,
                                      d_model=256, d_ff=512, max_seq_len=4096)


def _replicated_equal(mesh, params, specs) -> bool:
    """Whether every leaf is bit-equal on the ranks that replicate it (the
    mesh's axes that do not split it). A collective."""
    from k8s_llm_scheduler_tpu_torch.parallel.sharding import _walk

    same = []

    def check(t, spec, path):
        for axis in mesh.axis_names:
            if mesh.shape[axis] > 1 and axis not in spec:
                blocks = mesh.group(axis).all_gather(t.detach()[None], 0)
                same.append(all(torch.equal(blocks[0], b) for b in blocks[1:]))
        return t

    _walk(params, specs, check)
    return all(same)


def _ranks_importing_jax(mesh) -> list[int]:
    """The mesh's ranks whose process has imported jax or the JAX package
    (a collective)."""
    foreign = any(name.split(".")[0] in ("jax", "k8s_llm_scheduler_tpu") for name in sys.modules)
    flags = mesh.group(tuple(mesh.axis_names)).all_gather(
        torch.tensor([int(foreign)]), 0)
    ranks = mesh.axis_ranks(tuple(mesh.axis_names))
    return [r for r, f in zip(ranks, flags.tolist()) if f]


def probe_ring(mesh, q, k, v, seq_lens, cotangent, batch_axis: str | None = None) -> dict:
    """Ring attention (parallel/ring_attention.py) over `mesh`'s sp axis on
    whole numpy q/k/v [B, S, H, hd] (each rank takes its rows over
    `batch_axis` and its chunk of positions): the whole output and the
    gradients of sum(out * cotangent) w.r.t. q, k and v, gathered on
    every rank (numpy)."""
    from k8s_llm_scheduler_tpu_torch.parallel.ring_attention import make_ring_prefill_attention

    sp = mesh.shape.get("sp", 1)
    n_rows = mesh.shape.get(batch_axis, 1) if batch_axis else 1
    B, S = q.shape[:2]
    rows = slice(mesh.axis_index(batch_axis) * (B // n_rows) if batch_axis else 0,
                 (mesh.axis_index(batch_axis) + 1) * (B // n_rows) if batch_axis else B)
    cols = slice(mesh.axis_index("sp") * (S // sp), (mesh.axis_index("sp") + 1) * (S // sp))
    local = [torch.from_numpy(np.ascontiguousarray(a[rows, cols])).requires_grad_(True)
             for a in (q, k, v)]
    attn = make_ring_prefill_attention(mesh, "sp", batch_axis)
    out = attn(*local, torch.from_numpy(np.asarray(seq_lens)[rows]))
    (out * torch.from_numpy(np.ascontiguousarray(cotangent[rows, cols]))).sum().backward()

    def whole(t):
        t = mesh.group("sp").all_gather(t.detach(), 1)
        return (mesh.group(batch_axis).all_gather(t, 0) if n_rows > 1 else t).numpy()

    return {"out": whole(out), "grads": [whole(t.grad) for t in local]}


def probe_step(mesh, cfg: LlamaConfig, batch: tuple, *, params=None, seed: int = 0,
               lr: float = 1e-3, device="cuda", pipeline: bool = False,
               n_micro: int | None = None, timed_steps: int = 0, gather: bool = True,
               compare: bool = False, reference=None) -> dict:
    """One AdamW training step (at `lr`, optax.adamw's settings) on this
    rank of `mesh` from `params` (a whole tree of numpy arrays or tensors,
    or the path of one torch.save'd) or `seed`, on the whole host `batch`
    ((tokens, seq_lens[, loss_start, loss_weights]) numpy; pp takes the
    first two). Returns the loss, whether every replicated leaf is
    bit-equal on its ranks after the step, the ranks that imported JAX,
    and with `gather` the whole gradients and params after (numpy, from
    all-gathers: on every rank). With `compare`, every rank gathers the
    gradients and the rank given `reference` ({name: a whole gradient tree
    of tensors, on its device}) reports each leaf's relative error against
    each, |g - ref| / |ref| in the Frobenius norm. `timed_steps` more steps
    on the same batch are then timed: ms a step, the collectives and bytes
    a step on each group, and every rank's peak device memory."""
    from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
    from k8s_llm_scheduler_tpu_torch.train.pipeline import make_pp_train_step
    from k8s_llm_scheduler_tpu_torch.train.train_step import adamw, make_train_step

    if pipeline:
        init_fn, step_fn = make_pp_train_step(cfg, mesh, device, adamw(lr), n_micro)
        batch = batch[:2]
    else:
        init_fn, step_fn = make_train_step(cfg, device, adamw(lr), mesh=mesh)
    if isinstance(params, str):
        params = torch.load(params, map_location="cpu")
    elif params is not None and not isinstance(_first_leaf(params), torch.Tensor):
        params = params_from_jax(params, device="cpu")
    state = init_fn(seed if params is None else params)
    placed = step_fn.place_batch(*batch)
    state, loss = step_fn(state, *placed)
    out = {"loss": float(loss), "rank": mesh.rank,
           "replicated_equal": _replicated_equal(mesh, state.params, step_fn.specs),
           "ranks_importing_jax": _ranks_importing_jax(mesh)}
    if gather:
        grads = _grad_tree(state.params)
        out["grads"] = _numpy(step_fn.gather_params(grads))
        out["params"] = _numpy(step_fn.gather_params(state.params))
    if compare:
        whole = step_fn.gather_params(_grad_tree(state.params))
        if reference is not None:
            out["grad_rel_err"] = {ref_name: {
                name: float((g.float() - r.float()).norm() / r.float().norm().clamp(min=1e-30))
                for name, g, r in _pairs(whole, ref)} for ref_name, ref in reference.items()}
        del whole
    if timed_steps:
        dev = placed[0].device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        before = launch.collective_book(mesh)
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            state, loss = step_fn(state, *placed)
        float(loss)
        out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / timed_steps
        after = launch.collective_book(mesh)
        out["collectives_per_step"] = {
            name: {"counts": {k: (n - before.get(name, {}).get("counts", {}).get(k, 0))
                              / timed_steps for k, n in book["counts"].items()},
                   "bytes": (book["bytes"] - before.get(name, {}).get("bytes", 0))
                   / timed_steps}
            for name, book in after.items()}
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        everyone = tuple(mesh.axis_names)
        out["peak_bytes"] = dict(zip(mesh.axis_ranks(everyone), mesh.group(everyone).all_gather(
            torch.tensor([peak], dtype=torch.int64), 0).tolist()))
        out["last_loss"] = float(loss)
    return out


def _pairs(tree, other, path=""):
    for k in sorted(tree):
        name = f"{path}.{k}" if path else k
        if isinstance(tree[k], dict):
            yield from _pairs(tree[k], other[k], name)
        else:
            yield name, tree[k], other[k]


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = tree[next(iter(tree))]
    return tree


def _grad_tree(params):
    if isinstance(params, dict):
        return {k: _grad_tree(v) for k, v in params.items()}
    return params.grad if params.grad is not None else torch.zeros_like(params)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


# ------------------------------------------------------------- multichip
def _dryrun_rank(mesh, cfg, batch, pipeline, n_micro, device):
    out = probe_step(mesh, cfg, batch, pipeline=pipeline, n_micro=n_micro, device=device,
                     gather=False)
    if not np.isfinite(out["loss"]):
        raise RuntimeError(f"rank {mesh.rank}: loss is {out['loss']}")
    if not out["replicated_equal"]:
        raise RuntimeError(f"rank {mesh.rank}: replicated leaves differ across ranks")
    return out


def dryrun_multichip(n_ranks: int = 8, device="cuda") -> dict:
    """One train step over n ranks factored dp x sp x tp, then dp x pp
    (the training half of the JAX package's dryrun_multichip). Returns the
    two losses."""
    cfg = DRYRUN
    remaining = n_ranks
    tp = 2 if remaining % 2 == 0 and cfg.n_kv_heads % 2 == 0 else 1
    remaining //= tp
    sp = 2 if remaining % 2 == 0 else 1
    remaining //= sp
    dp = remaining
    axes = {k: v for k, v in (("dp", dp), ("sp", sp), ("tp", tp)) if v > 1}
    mesh = make_mesh(axes or {"dp": 1})
    print(f"dryrun mesh: {mesh.shape} over {n_ranks} ranks", flush=True)
    rng = np.random.default_rng(1)
    B, S = max(dp * 2, 2), 128  # sharded over sp into 64-token chunks
    batch = (rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
             np.full((B,), S, np.int32))
    out = launch.run_spmd(mesh, _dryrun_rank, dict(cfg=cfg, batch=batch, pipeline=False,
                                                   n_micro=None, device=device),
                          device=device)
    print(f"dryrun OK (dp/sp/tp): step=1 loss={out['loss']:.4f}", flush=True)
    losses = {"dp_sp_tp": out["loss"]}
    if n_ranks % 2:
        print(f"dryrun SKIP: the pipeline pass needs an even rank count, have {n_ranks}")
        return losses
    pp, dp_pp = 2, n_ranks // 2
    mesh_pp = make_mesh({k: v for k, v in (("dp", dp_pp), ("pp", pp)) if v > 1})
    Bpp = max(dp_pp * 2, 2)
    batch_pp = (np.random.default_rng(3).integers(0, cfg.vocab_size, size=(Bpp, 64))
                .astype(np.int32), np.full((Bpp,), 64, np.int32))
    out = launch.run_spmd(mesh_pp, _dryrun_rank, dict(cfg=cfg, batch=batch_pp, pipeline=True,
                                                      n_micro=2, device=device),
                          device=device)
    print(f"dryrun OK (pipeline dp={dp_pp} pp={pp}): loss={out['loss']:.4f}", flush=True)
    losses["dp_pp"] = out["loss"]
    return losses


# ------------------------------------------------------------- multihost
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host(host_id: int, port: int, device) -> None:
    """One host of the two-host dry run (a process of its own)."""
    from k8s_llm_scheduler_tpu_torch.parallel.distributed import (
        init_distributed,
        is_coordinator,
    )

    assert init_distributed(f"127.0.0.1:{port}", 2, host_id, ranks_per_process=2)
    # 1. dp across hosts x tp within each: every rank takes its rows of
    # the same global batch
    mesh = launch.training_mesh({"dp": 2, "tp": 2})
    assert mesh.shape == {"dp": 2, "tp": 2}
    assert mesh.grid[:, 0].tolist() == [0, 2], "dp does not cross the hosts"
    rng = np.random.default_rng(42)
    batch = (rng.integers(0, MULTIHOST.vocab_size, size=(4, 64)).astype(np.int32),
             np.full((4,), 64, np.int32))
    out = launch.run_spmd(mesh, _dryrun_rank, dict(cfg=MULTIHOST, batch=batch,
                                                   pipeline=False, n_micro=None,
                                                   device=device), device=device)
    if is_coordinator():
        print(f"dryrun OK (multihost train dp(DCN)=2 x tp(ICI)=2): loss={out['loss']:.4f}",
              flush=True)
    # 2. each host serves a decision from its own tp=2 replica
    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
    from k8s_llm_scheduler_tpu_torch.models import configs
    from k8s_llm_scheduler_tpu_torch.testing import fixture_pods, synthetic_nodes
    from k8s_llm_scheduler_tpu_torch.types import DecisionSource

    # the card's kernels take bf16
    serve = MULTIHOST_SERVE if device == "cpu" else dataclasses.replace(
        MULTIHOST_SERVE, dtype=torch.bfloat16)
    configs._REGISTRY[serve.name] = serve
    backend = build_local_backend(
        serve.name, device=device, mesh_axes={"tp": 2}, graphs=False,
        max_slots=2, num_pages=64, page_size=64, prefill_buckets=(512, 1024, 2048, 4096),
        chunk_steps=8, temperature=0.0, max_new_tokens=160)
    try:
        nodes = synthetic_nodes(3)
        pod = fixture_pods(1)[0]
        decision = backend.get_scheduling_decision(pod, nodes)
        assert decision.source is DecisionSource.LLM, decision
        assert decision.selected_node in {n.name for n in nodes}
        # 3. the coordinator alone binds
        if is_coordinator():
            from k8s_llm_scheduler_tpu_torch.cluster.fake import FakeCluster, FakeNode
            from k8s_llm_scheduler_tpu_torch.cluster.interface import RawPod

            cluster = FakeCluster()
            for n in nodes:
                cluster.add_node(FakeNode(n.name))
            cluster.add_pod(RawPod(name=pod.name, namespace=pod.namespace,
                                   scheduler_name="ai-llama-scheduler",
                                   container_requests=({"cpu": "100m", "memory": "128Mi"},)))
            assert cluster.bind_pod_to_node(pod.name, pod.namespace, decision.selected_node)
            print(f"dryrun OK (multihost serving, replica/host, tp=2, coordinator-only "
                  f"bind): node={decision.selected_node}", flush=True)
        else:
            print(f"worker {host_id}: replica decision computed, no bind", flush=True)
    finally:
        backend.close()


def dryrun_multihost(device="cuda", timeout_s: float = 600.0) -> list[str]:
    """Two hosts of two ranks each on this machine; returns each host's
    output and raises unless both passed."""
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "k8s_llm_scheduler_tpu_torch.parallel.dryrun", "--host-id",
         str(i), "--port", str(port), "--device", str(device)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=timeout_s)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    failed = [i for i, p in enumerate(procs) if p.returncode != 0]
    if failed or "multihost train" not in outs[0] or "coordinator-only bind" not in outs[0] \
            or "no bind" not in outs[1]:
        raise RuntimeError("dryrun_multihost failed:\n" + "\n".join(
            f"--- host {i} (rc={p.returncode}) ---\n{o[-3000:]}"
            for i, (p, o) in enumerate(zip(procs, outs))))
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m k8s_llm_scheduler_tpu_torch.parallel.dryrun")
    ap.add_argument("--n", type=int, default=8, help="ranks of the multichip dry run")
    ap.add_argument("--multihost", action="store_true", help="the two-host dry run instead")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host-id", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.host_id is not None:
        _host(args.host_id, args.port, args.device)
        return 0
    if args.multihost:
        for i, out in enumerate(dryrun_multihost(args.device)):
            print(f"--- host {i} ---\n{out[-2000:]}")
        print("dryrun_multihost: ALL OK")
        return 0
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    # through the package's module, so the rank functions a follower
    # unpickles are the package's, not this __main__'s
    from k8s_llm_scheduler_tpu_torch.parallel import dryrun as _dryrun

    sys.exit(_dryrun.main())
