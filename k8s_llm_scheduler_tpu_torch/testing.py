"""Synthetic clusters, fixture pods and an async deadline for tests, the
chip smoke and `cli demo`.

`chunk_draws` runs the fused decode loop's sampling alone over constant
probabilities, on the CPU or captured on a card, for the tests and the chip
smoke to hold against the softmax. `cap_torch_threads` caps a test
process's torch threads.

`synthetic_nodes(n)` returns exactly the NodeMetrics that
`synthetic_cluster(n).get_node_metrics()` reports for a cluster with no pods
bound: node-i at load (i * 37 % 90)% of 16 cores / 64 GB, 110 max pods,
zone label z(i % 4), Ready. `synthetic_cluster`, `pod_burst`,
`async_deadline` and `fixture_raw_pods` are copies of the JAX package's
testing.py (`fixture_raw_pods` is its `fixture_pods`: the reference's three
graduated nginx pods, as RawPods); `fixture_pods(n)` here returns PodSpecs.
"""

from __future__ import annotations

import asyncio

from k8s_llm_scheduler_tpu_torch.cluster.fake import FakeCluster, FakeNode
from k8s_llm_scheduler_tpu_torch.cluster.interface import RawPod
from k8s_llm_scheduler_tpu_torch.types import NodeMetrics, PodSpec

SCHEDULER_NAME = "ai-llama-scheduler"


class _Py310Deadline:
    """Minimal backport of the 3.11 timeout context manager: arm a timer
    that cancels the CURRENT task; translate the resulting CancelledError
    into TimeoutError iff this deadline (not an outer cancel) fired."""

    def __init__(self, seconds: float) -> None:
        self._seconds = seconds
        self._fired = False
        self._handle = None
        self._task = None

    async def __aenter__(self) -> "_Py310Deadline":
        self._task = asyncio.current_task()
        loop = asyncio.get_running_loop()
        self._handle = loop.call_later(self._seconds, self._on_timeout)
        return self

    def _on_timeout(self) -> None:
        self._fired = True
        if self._task is not None:
            self._task.cancel()

    async def __aexit__(self, exc_type, exc, tb) -> bool:
        if self._handle is not None:
            self._handle.cancel()
        if self._fired:
            if exc_type is asyncio.CancelledError:
                raise TimeoutError(
                    f"deadline of {self._seconds}s expired"
                ) from exc
            if exc_type is None:
                # Timer fired in the gap between the block's last await and
                # exit: the task.cancel() is still pending and would escape
                # as a bare CancelledError at the caller's NEXT await.
                # Absorb it at a checkpoint here and report the expiry
                # (3.11's native timeout resolves this boundary the same
                # way, via Task.uncancel bookkeeping).
                try:
                    await asyncio.sleep(0)
                except asyncio.CancelledError:
                    raise TimeoutError(
                        f"deadline of {self._seconds}s expired"
                    ) from None
        return False


# torch's intra-op threads in a test process (cap_torch_threads).
TEST_TORCH_THREADS = 2


def cap_torch_threads() -> None:
    """Cap torch's intra-op thread pool at TEST_TORCH_THREADS (never raise
    it). Each test process (an xdist worker among several) otherwise sizes
    its pool to every core of the machine, beside the JAX CPU backend's
    own, and the workers oversubscribe the cores. The port's test files
    call this when they are imported."""
    import torch

    if torch.get_num_threads() > TEST_TORCH_THREADS:
        torch.set_num_threads(TEST_TORCH_THREADS)


def async_deadline(seconds: float):
    """``async with async_deadline(30): ...`` — bound an async block's wall
    time. Python 3.11+'s native scoped timeout when available (it handles
    nested-cancellation bookkeeping via Task.uncancel); a call_later-based
    shim with the same raise-TimeoutError contract on 3.10."""
    native = getattr(asyncio, "timeout", None)  # 3.11+
    if native is not None:
        return native(seconds)
    return _Py310Deadline(seconds)


def synthetic_nodes(
    n_nodes: int = 3,
    cpu_cores: float = 16.0,
    memory_gb: float = 64.0,
    max_pods: int = 110,
    load_spread: bool = True,
) -> list[NodeMetrics]:
    """n nodes at varied synthetic load levels."""
    out = []
    for i in range(n_nodes):
        load = float(i * 37 % 90) if load_spread else 0.0
        out.append(
            NodeMetrics(
                name=f"node-{i}",
                cpu_usage_percent=load,
                memory_usage_percent=load,
                available_cpu_cores=cpu_cores,
                available_memory_gb=memory_gb,
                pod_count=0,
                max_pods=max_pods,
                labels={"zone": f"z{i % 4}"},
                taints=(),
                conditions={"Ready": "True"},
            )
        )
    return out


def fixture_pods(n: int = 8) -> list[PodSpec]:
    """n pending pods of varied shape: small web pods, memory-heavy caches,
    compute and high-priority batch jobs. None carries a selector, so every
    node of synthetic_nodes is feasible for each — the decision grammar
    covers every ready node, and any name it emits is a feasible one."""
    shapes = (
        dict(cpu_request=0.5, memory_request=0.5),
        dict(cpu_request=2.0, memory_request=8.0),
        dict(cpu_request=1.0, memory_request=2.0),
        dict(cpu_request=4.0, memory_request=16.0, priority=100),
        dict(cpu_request=0.25, memory_request=0.25),
        dict(cpu_request=8.0, memory_request=4.0),
        dict(cpu_request=1.5, memory_request=3.0),
        dict(cpu_request=3.0, memory_request=24.0, priority=10),
    )
    names = ("web", "cache", "api", "batch", "sidecar", "compute", "worker", "etl")
    return [
        PodSpec(
            name=f"{names[i % len(names)]}-{i}",
            namespace="default",
            **shapes[i % len(shapes)],
        )
        for i in range(n)
    ]


def fixture_raw_pods(scheduler_name: str = SCHEDULER_NAME) -> list[RawPod]:
    """The reference's 3 graduated nginx test pods (ai-test-pods.yaml)."""
    shapes = [
        ("ai-test-pod-1", "100m", "128Mi"),
        ("ai-test-pod-2", "250m", "256Mi"),
        ("ai-test-pod-3", "500m", "512Mi"),
    ]
    return [
        RawPod(
            name=name,
            namespace="default",
            scheduler_name=scheduler_name,
            container_requests=({"cpu": cpu, "memory": mem},),
        )
        for name, cpu, mem in shapes
    ]


def synthetic_cluster(
    n_nodes: int = 3,
    cpu_cores: float = 16.0,
    memory_gb: float = 64.0,
    max_pods: int = 110,
    load_spread: bool = True,
) -> FakeCluster:
    """A FakeCluster with n nodes at varied synthetic load levels."""
    cluster = FakeCluster()
    for i in range(n_nodes):
        load = (i * 37 % 90) if load_spread else None
        cluster.add_node(
            FakeNode(
                name=f"node-{i}",
                cpu_capacity_cores=cpu_cores,
                memory_capacity_gb=memory_gb,
                max_pods=max_pods,
                cpu_usage_percent=float(load) if load is not None else None,
                memory_usage_percent=float(load) if load is not None else None,
                labels={"zone": f"z{i % 4}"},
            )
        )
    return cluster


def pod_burst(
    n_pods: int,
    scheduler_name: str = SCHEDULER_NAME,
    distinct_shapes: int = 8,
) -> list[RawPod]:
    """A burst of pending pods with `distinct_shapes` resource shapes.

    distinct_shapes controls the decision-cache hit rate: a 1000-pod burst
    with 8 shapes means ~992 decisions are cache-servable, which mirrors real
    bursts (replicas of few deployments) and the reference's cache-key
    equivalence design (scheduler.py:265-271).
    """
    pods = []
    for i in range(n_pods):
        shape = i % distinct_shapes
        cpu_m = 100 + 50 * shape
        mem_mi = 128 * (1 + shape % 4)
        pods.append(
            RawPod(
                name=f"burst-pod-{i}",
                namespace="default",
                scheduler_name=scheduler_name,
                container_requests=({"cpu": f"{cpu_m}m", "memory": f"{mem_mi}Mi"},),
                priority=shape % 3,
            )
        )
    return pods


def chunk_draws(device: str = "cpu", *, slots: int = 64, steps: int = 16,
                replays: int = 16, vocab: int = 32, temperature: float = 1.0,
                seed: int = 0) -> dict:
    """The fused loop's sampling with probabilities that stay constant: a
    chunk of `steps` steps, each sampling every slot with `sample_fused`
    from its row of the chunk's uniforms (engine/fused/loop.py
    `fused_draw` / `step_uniforms`), as a GraphRunner program (on a card a
    CUDA graph whose steps are one WHILE node), run `replays` times.

    Returns the draws' total variation from the softmax (`tv`), the share
    of draws equal to their slot's draw at step 0 of the same run
    (`repeat`, the chance of which for independent draws is `repeat_want`,
    the sum of the squared probabilities), the steps run and replays."""
    import torch

    from k8s_llm_scheduler_tpu_torch.engine.fused.loop import fused_draw, step_uniforms
    from k8s_llm_scheduler_tpu_torch.engine.fused.sampler import sample_fused
    from k8s_llm_scheduler_tpu_torch.engine.graphs import GraphRunner

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    runner = GraphRunner(dev, True, generator=gen)
    base = torch.randn(vocab, generator=torch.Generator().manual_seed(seed)) * 0.5
    logits = base.to(dev).expand(slots, vocab).contiguous()
    st = torch.zeros(slots, dtype=torch.int32, device=dev)
    table = torch.zeros((1, vocab), dtype=torch.int32, device=dev)
    act = torch.ones(slots, dtype=torch.bool, device=dev)
    budget = torch.full((slots,), steps, dtype=torch.int32, device=dev)
    toks = torch.zeros((slots, steps), dtype=torch.int32, device=dev)

    class Buf:
        u = torch.zeros((steps, slots), dtype=torch.float32, device=dev)
        j = torch.zeros((), dtype=torch.int64, device=dev)

    def step() -> None:
        tok, _ = sample_fused(logits, st, table, gen, temperature, 0, False, vocab,
                              u=step_uniforms(Buf, temperature))
        toks.index_copy_(1, Buf.j.view(1), tok[:, None])
        Buf.j.add_(1)

    def chunk() -> None:
        Buf.j.zero_()
        fused_draw(Buf, gen, temperature)
        runner.while_live(act, budget, step, Buf.j, steps)

    prog = runner.program("chunk draws", chunk)
    runs, steps_run = [], []
    for _ in range(replays):
        prog.run()
        runs.append(toks.clone())
        steps_run.append(Buf.j.clone())
    draws = torch.stack(runs).cpu()  # [replays, slots, steps]
    want = torch.softmax(base / temperature, dim=-1).double()
    got = torch.bincount(draws.flatten().long(), minlength=vocab).double() / draws.numel()
    return {
        "tv": float(0.5 * (got - want).abs().sum()),
        "repeat": float((draws[..., 1:] == draws[..., :1]).double().mean()),
        "repeat_want": float((want * want).sum()),
        "steps_run": [int(n) for n in torch.stack(steps_run).cpu()],
        "replays": runner.replays,
        "draws": draws.numel(),
    }
