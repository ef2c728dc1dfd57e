"""k8s_llm_scheduler_tpu_torch — the PyTorch/CUDA port of the LLM scheduler.

The port of the JAX package `k8s_llm_scheduler_tpu` to PyTorch on an NVIDIA
H100 (Hopper). It mirrors that package's layout, imports nothing of it and
never imports JAX; modules that were free of JAX there are copied here.

Package layout:
    cli.py         `python -m k8s_llm_scheduler_tpu_torch.cli demo`; build_stack
    cluster/       RawPod, ClusterState / Binder, the in-memory FakeCluster (copies)
    sched/         Scheduler loop, DecisionClient, deadline budgets (copies)
    core/          prompt, feasibility, cache, circuit breaker, fallback (copies)
    observability/ decision spans and phase timings (copies)
    engine/        tokenizer, grammar DFA, inference engine, local backend
    models/        Llama configs and model in PyTorch; weight conversion
    ops/           attention ops; the CUDA flash kernels' wrappers and builder
    csrc/          the hand-written CUDA kernels (built by nvcc at first use)
    utils/         JSON extraction, unit parsing (copies)

Entry points take a `device` that defaults to "cuda" and raise when no GPU
is present unless the caller asks for "cpu".
"""

__version__ = "0.1.0"

from k8s_llm_scheduler_tpu_torch.types import (  # noqa: F401
    NodeMetrics,
    PodSpec,
    SchedulingDecision,
)
