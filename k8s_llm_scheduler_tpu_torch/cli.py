"""Command line of the port. One command so far, `demo`:

    python -m k8s_llm_scheduler_tpu_torch.cli demo [--fake-nodes N]
        [--model NAME] [--quantize int8] [--decode-matmul ragged] [--eager]
        [--device cuda|cpu]

It builds the whole stack — LocalLLMBackend (random weights from a seed),
DecisionCache, CircuitBreaker, DecisionClient and Scheduler — over an
in-memory FakeCluster of N synthetic nodes, adds the reference's three
fixture pods, runs the scheduling loop (watch -> snapshot -> decide ->
validate -> bind) until all three are bound, and prints the scheduler's
stats as JSON on stdout. It exits 0 once every pod is bound. The backend
runs the reference config's admission plane (`admission_kwargs`): packed
batch admission, and delta prompts over up to 4 pinned snapshot prefixes.

A port of the JAX package's `cli demo` (cli.py:690-694, `_build_stack`
cli.py:106-187, `_run_scheduler`'s demo branch cli.py:379-396 and its stats
dump at :421). The port reads no config file (no YAML): the stack takes the
reference config's defaults, which `DEFAULTS` names.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import sys

from k8s_llm_scheduler_tpu_torch.core.breaker import CircuitBreaker
from k8s_llm_scheduler_tpu_torch.core.cache import DecisionCache
from k8s_llm_scheduler_tpu_torch.sched.client import DecisionClient
from k8s_llm_scheduler_tpu_torch.sched.loop import Scheduler

logger = logging.getLogger(__name__)

DEMO_DEADLINE_S = 600.0  # the demo gives up (exit 1) if pods are unbound by then

# The reference config's DEFAULTS (JAX package config.py:33) that the demo
# stack reads, by their dotted config keys. The cache and the breaker are
# enabled there, and no decision deadline is set.
DEFAULTS = {
    "scheduler.name": "ai-llama-scheduler",
    "scheduler.error_backoff_seconds": 5.0,
    "scheduler.prefix_prewarm_seconds": 0.25,
    "scheduler.decision_deadline_ms": None,
    "scheduler.llm_min_budget_ms": 25.0,
    "llm.model": "llama-3.2-1b-instruct",
    "llm.timeout": 60,
    "llm.max_retries": 3,
    "llm.retry_delay": 1.0,
    "cache.ttl_seconds": 300,
    "cache.max_size": 100,
    "circuit_breaker.failure_threshold": 5,
    "circuit_breaker.timeout": 60,
    "circuit_breaker.half_open_max_calls": 1,
    "circuit_breaker.cooldown_jitter": 0.1,
    "fallback.enabled": True,
    "fallback.strategy": "resource_balanced",
    # the admission plane (JAX package config.py:141-157): packed batch
    # admission and snapshot-delta prompts over pinned prefix KV
    "admission.packed": True,
    "admission.chunk_tokens": 256,
    "admission.delta_prompts": True,
    "admission.repin_fraction": 0.25,
    "admission.max_pins": 4,
}


def admission_kwargs() -> dict:
    """build_local_backend's admission-plane settings from DEFAULTS, as the
    reference's `_build_stack` wires them (JAX package cli.py:87-92)."""
    cfg = DEFAULTS
    return {
        "packed_admission": cfg["admission.packed"],
        "admission_chunk_tokens": cfg["admission.chunk_tokens"],
        "delta_prompts": cfg["admission.delta_prompts"],
        "repin_fraction": cfg["admission.repin_fraction"],
        "max_pins": cfg["admission.max_pins"],
    }


def build_stack(backend, cluster, *, snapshot_ttl_s: float = 1.0) -> Scheduler:
    """Cache, breaker, client and scheduler over `backend` and `cluster`
    (the fake cluster is its own binder), as the reference's
    `_build_stack` wires them from its config, here DEFAULTS. The client
    is `scheduler.client`."""
    cfg = DEFAULTS
    breaker = CircuitBreaker(
        failure_threshold=cfg["circuit_breaker.failure_threshold"],
        timeout_seconds=cfg["circuit_breaker.timeout"],
        half_open_max_calls=cfg["circuit_breaker.half_open_max_calls"],
        cooldown_jitter=cfg["circuit_breaker.cooldown_jitter"],
    )
    client = DecisionClient(
        backend,
        cache=DecisionCache(ttl_seconds=cfg["cache.ttl_seconds"],
                            max_size=cfg["cache.max_size"]),
        breaker=breaker,
        max_retries=cfg["llm.max_retries"],
        retry_delay=cfg["llm.retry_delay"],
        fallback_strategy=cfg["fallback.strategy"],
        fallback_enabled=cfg["fallback.enabled"],
        deadline_ms=cfg["scheduler.decision_deadline_ms"],
        llm_min_budget_ms=cfg["scheduler.llm_min_budget_ms"],
    )
    return Scheduler(
        cluster, cluster, client,
        scheduler_name=cfg["scheduler.name"],
        snapshot_ttl_s=snapshot_ttl_s,
        error_backoff_s=cfg["scheduler.error_backoff_seconds"],
        prefix_prewarm_s=cfg["scheduler.prefix_prewarm_seconds"],
    )


async def run_until_bound(scheduler: Scheduler, cluster, n_pods: int,
                          deadline_s: float) -> bool:
    """Run the scheduling loop until `n_pods` pods are bound or
    `deadline_s` passes; then stop it and close the cluster's watch.
    Returns whether every pod was bound."""
    task = asyncio.create_task(scheduler.run())
    loop = asyncio.get_running_loop()
    end = loop.time() + deadline_s
    try:
        while cluster.bind_count < n_pods and not task.done() and loop.time() < end:
            await asyncio.sleep(0.05)
    finally:
        scheduler.stop()
        cluster.close()
        await asyncio.wait_for(task, timeout=60)
    return cluster.bind_count >= n_pods


def cmd_demo(args: argparse.Namespace) -> int:
    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
    from k8s_llm_scheduler_tpu_torch.testing import (
        fixture_raw_pods,
        synthetic_cluster,
    )

    backend = build_local_backend(
        args.model, device=args.device, seed=0,
        request_timeout_s=DEFAULTS["llm.timeout"],
        quantize=args.quantize, decode_matmul=args.decode_matmul,
        graphs=not args.eager, **admission_kwargs(),
    )
    cluster = synthetic_cluster(args.fake_nodes)
    pods = fixture_raw_pods(DEFAULTS["scheduler.name"])
    for pod in pods:
        cluster.add_pod(pod)
    scheduler = build_stack(backend, cluster)
    try:
        ok = asyncio.run(run_until_bound(scheduler, cluster, len(pods), DEMO_DEADLINE_S))
    finally:
        backend.close()
    if ok:
        logger.info("demo: all fixture pods scheduled")
    else:
        logger.error("demo: %d of %d pods bound within %.0f s",
                     cluster.bind_count, len(pods), DEMO_DEADLINE_S)
    print(json.dumps(scheduler.get_stats(), indent=2, default=str))
    return 0 if ok else 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m k8s_llm_scheduler_tpu_torch.cli",
        description="The PyTorch/CUDA port of the LLM scheduler.",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    demo = sub.add_parser(
        "demo",
        help="schedule the three fixture pods on an in-memory fake cluster",
        description=(
            "Schedule the reference's three fixture pods on an in-memory fake "
            "cluster through the whole stack, then print the scheduler's stats "
            "as JSON. Weights are random from seed 0. Decoding is greedy: the "
            "reference demo samples at llm.temperature 0.3, while this port's "
            "build_local_backend decodes at temperature 0."
        ),
    )
    demo.add_argument("--fake-nodes", type=int, default=3,
                      help="nodes in the synthetic cluster (default 3)")
    demo.add_argument("--model", default=DEFAULTS["llm.model"],
                      help="model config name (default %(default)s)")
    demo.add_argument("--quantize", choices=("int8",), default=None,
                      help="int8 weight-only quantization")
    demo.add_argument("--decode-matmul", choices=("dense", "ragged"), default="dense",
                      help="block-decode matmuls: dense, or ragged (the K3 kernel)")
    demo.add_argument("--eager", action="store_true",
                      help="run the engine's waves eagerly, not as CUDA graphs")
    demo.add_argument("--device", default="cuda",
                      help="cuda (default; raises without a GPU) or cpu")
    demo.set_defaults(func=cmd_demo)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
