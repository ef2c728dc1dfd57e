"""Command line of the port: run / verify / demo / complete.

    python -m k8s_llm_scheduler_tpu_torch.cli [--config FILE] run
        [--fake-cluster] [--fake-nodes N] [--device cuda|cpu]
    python -m k8s_llm_scheduler_tpu_torch.cli [--config FILE] verify
        [--fast] [--device cuda|cpu]
    python -m k8s_llm_scheduler_tpu_torch.cli [--config FILE] demo
        [--fake-nodes N] [--model NAME] [--quantize int8]
        [--decode-matmul ragged] [--eager] [--device cuda|cpu]
    python -m k8s_llm_scheduler_tpu_torch.cli [--config FILE] complete
        [--prompt TEXT] [--chat] [--max-new-tokens N] [--temperature T]
        [--model NAME] [--spec] [--device cuda|cpu]

A port of the JAX package's cli.py: the configuration comes from
`config.load_config` (env > config.yaml or `--config` > defaults), and
`_backend_kwargs` maps it onto build_local_backend in one place
(JAX cli.py:39-104), which `build_stack` wraps in the decision cache, the
circuit breaker, the decision client and the scheduler (JAX cli.py:106-187).

- `run` (JAX cli.py:444-485) watches and binds through `KubeCluster` (the
  in-tree REST transport, cluster/httpapi.py, when the `kubernetes` package
  is absent), or an in-memory synthetic cluster with `--fake-cluster`. It
  runs until SIGINT, then prints the scheduler's stats as JSON on stdout
  and exits 0. The banner goes to stderr, so stdout holds only the stats.
- `verify` is the preflight (JAX cli.py:697-790) for torch and CUDA: one
  `[ok]`/`[FAIL]` line per check, exit 1 on any failure.
- `demo` schedules the reference's three fixture pods on an in-memory
  cluster through the same stack, then prints the stats (exit 1 if they
  are not bound within DEMO_DEADLINE_S).
- `complete` (JAX cli.py:2450-2543) is general free-form completion
  through the paged path: the prompt (`--prompt`, else stdin) past the
  largest prefill bucket is installed as a chunked dense prefix, its tail
  generated through the fused runtime, or speculatively with `--spec`
  (spec/); the text goes to stdout.

`--device` is the port's own flag: the model runs on "cuda" (the default;
it raises without a GPU) unless "cpu" is asked for. The switches of paths
the port has not ported yet raise NotImplementedError before any model is
built (`UNPORTED_SWITCHES`); the one of them that is on by default logs a
warning instead (`WARNED_SWITCHES`).
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import json
import logging
import os
import sys
import time
from pathlib import Path

from k8s_llm_scheduler_tpu_torch.config import Config, load_config
from k8s_llm_scheduler_tpu_torch.logging_setup import setup_logging

logger = logging.getLogger(__name__)

BANNER = r"""
  LLM Kubernetes Scheduler (PyTorch/CUDA)
  watch -> snapshot -> prompt -> decide(on-GPU) -> validate -> bind
"""

DEMO_DEADLINE_S = 600.0  # the demo gives up (exit 1) if pods are unbound by then

# Config switches whose paths are not ported yet, with the ROADMAP queue 1
# item each waits for. Setting one raises before any model is built.
UNPORTED_SWITCHES = (
    ("durability.enabled", "the decision journal", 7),
    ("metrics.enabled", "the metrics endpoint", 7),
    ("slo.enabled", "the SLO engine", 7),
    ("distributed.enabled", "multi-host serving", 9),
    ("distributed.replica_addrs", "replica fan-out", 9),
    ("router.enabled", "the decision router", 9),
)
# Switches that are on by default but not ported: a warning each.
WARNED_SWITCHES = (
    ("observability.profiler", "the wave profiler", 8, "no profile is kept"),
)


def check_switches(cfg: Config) -> None:
    """Raise NotImplementedError for a switch of an unported path, naming
    it and the ROADMAP item it waits for; warn for those on by default."""
    for key, what, item in UNPORTED_SWITCHES:
        if cfg.get(key, None):
            raise NotImplementedError(
                f"{key}: {what} is not ported yet (ROADMAP queue 1 item {item})"
            )
    mesh = cfg.get("llm.mesh", None) or {}
    wide = {ax: n for ax, n in mesh.items() if int(n) > 1}
    if wide:
        raise NotImplementedError(
            f"llm.mesh {wide}: the port serves on one device, tp 1 "
            f"(tensor parallel: ROADMAP queue 1 item 9)"
        )
    if cfg.get("fleet.enabled", False) and (
        cfg.get("fleet.prefill_addrs", None) or cfg.get("fleet.decode_addrs", None)
    ):
        raise NotImplementedError(
            "fleet.prefill_addrs / fleet.decode_addrs: disaggregated pools "
            "are not ported yet (ROADMAP queue 1 item 9)"
        )
    for key, what, item, effect in WARNED_SWITCHES:
        if cfg.get(key, None):
            logger.warning("%s: %s is not ported yet (ROADMAP queue 1 item %d); %s",
                           key, what, item, effect)


def _backend_kwargs(cfg: Config, **overrides) -> dict:
    """The ONE cfg -> build_local_backend kwargs mapping (JAX cli.py:39-104),
    for the keys the port honours. `overrides` win (the CLI's flags)."""
    kwargs = dict(
        model=cfg.get("llm.model", "tiny"),
        temperature=cfg.get("llm.temperature"),
        top_k=int(cfg.get("llm.top_k", 0)),
        max_slots=cfg.get("llm.max_batch"),
        page_size=cfg.get("llm.page_size"),
        prefill_buckets=tuple(cfg.get("llm.prefill_buckets")),
        max_new_tokens=cfg.get("llm.max_tokens"),
        constrained=cfg.get("llm.constrained_json"),
        checkpoint_path=cfg.get("llm.checkpoint_path"),
        tokenizer_path=cfg.get("llm.tokenizer_path"),
        tokenizer_name=cfg.get("llm.tokenizer", "byte"),
        decode_matmul=cfg.get("llm.decode_matmul", "dense"),
        answer_style=cfg.get("llm.answer_style", "direct"),
        max_reason_tokens=int(cfg.get("llm.max_reason_tokens", 320)),
        quantize=cfg.get("llm.quantization"),
        request_timeout_s=float(cfg.get("llm.timeout")),
        group_switch_after_s=float(cfg.get("llm.group_switch_after_s")),
        # fused on-device decode runtime (engine/fused/)
        fused_decode=bool(cfg.get("llm.fused_decode", True)),
        # persistent serving loop (engine/persistent/) and its telemetry
        persistent_loop=bool(cfg.get("llm.persistent_loop", False)),
        persistent_suffix_bucket=cfg.get("llm.persistent_suffix_bucket", None),
        persistent_telemetry=bool(cfg.get("llm.persistent_telemetry", True)),
        persistent_stats_every=int(cfg.get("llm.persistent_stats_every", 8)),
        persistent_blackbox_depth=int(cfg.get("llm.persistent_blackbox_depth", 64)),
        # delta-prefill admission plane (engine/admission/, sched/delta.py)
        packed_admission=bool(cfg.get("admission.packed", True)),
        admission_chunk_tokens=int(cfg.get("admission.chunk_tokens", 256)),
        delta_prompts=bool(cfg.get("admission.delta_prompts", True)),
        repin_fraction=float(cfg.get("admission.repin_fraction", 0.25)),
        max_pins=int(cfg.get("admission.max_pins", 4)),
        # speculative decoding (spec/): serves generate(), never decisions
        spec_enabled=bool(cfg.get("llm.spec_enabled", False)),
        spec_arm=cfg.get("llm.spec_arm", "draft"),
        spec_draft_model=cfg.get("llm.spec_draft_model", "tiny"),
        spec_draft_checkpoint=cfg.get("llm.spec_draft_checkpoint", None),
        spec_k=int(cfg.get("llm.spec_k", 4)),
        spec_disable_threshold=float(cfg.get("llm.spec_disable_threshold", 0.3)),
    )
    kwargs.update(overrides)
    return kwargs


def build_stack(cfg: Config, cluster, *, backend=None, device: str = "cuda",
                snapshot_ttl_s: float = 1.0, **backend_overrides):
    """(scheduler, backend) from `cfg` over `cluster` (its own binder), as
    the JAX package's `_build_stack` wires them: the backend (`backend`, or
    the stub with `llm.backend: stub`, or build_local_backend on `device`),
    the decision cache and the circuit breaker where enabled, the client
    with its deadline ladder, and the scheduler. Unported switches raise
    first (check_switches). The client is `scheduler.client`."""
    from k8s_llm_scheduler_tpu_torch.core.breaker import CircuitBreaker
    from k8s_llm_scheduler_tpu_torch.core.cache import DecisionCache
    from k8s_llm_scheduler_tpu_torch.sched.client import DecisionClient
    from k8s_llm_scheduler_tpu_torch.sched.loop import Scheduler

    check_switches(cfg)
    if backend is None:
        if cfg.get("llm.backend") == "stub":
            from k8s_llm_scheduler_tpu_torch.engine.backend import StubBackend

            backend = StubBackend()
        else:
            from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend

            backend = build_local_backend(
                **_backend_kwargs(cfg, device=device, **backend_overrides))
    cache = (
        DecisionCache(ttl_seconds=cfg.get("cache.ttl_seconds"),
                      max_size=cfg.get("cache.max_size"))
        if cfg.get("cache.enabled") else None
    )
    breaker = (
        CircuitBreaker(
            failure_threshold=cfg.get("circuit_breaker.failure_threshold"),
            timeout_seconds=cfg.get("circuit_breaker.timeout"),
            half_open_max_calls=cfg.get("circuit_breaker.half_open_max_calls"),
            cooldown_jitter=float(cfg.get("circuit_breaker.cooldown_jitter", 0.1)),
        )
        if cfg.get("circuit_breaker.enabled") else None
    )
    # the env override arrives as a string (the default is null): through
    # float first, then "null / <= 0 disables"
    deadline_ms = cfg.get("scheduler.decision_deadline_ms", None)
    if deadline_ms is not None:
        deadline_ms = float(deadline_ms)
        if deadline_ms <= 0:
            deadline_ms = None
    client = DecisionClient(
        backend,
        cache=cache,
        breaker=breaker,
        max_retries=cfg.get("llm.max_retries"),
        retry_delay=cfg.get("llm.retry_delay"),
        fallback_strategy=cfg.get("fallback.strategy"),
        fallback_enabled=cfg.get("fallback.enabled"),
        deadline_ms=deadline_ms,
        llm_min_budget_ms=float(cfg.get("scheduler.llm_min_budget_ms", 25.0)),
    )
    scheduler = Scheduler(
        cluster, cluster, client,
        scheduler_name=cfg.get("scheduler.name"),
        snapshot_ttl_s=snapshot_ttl_s,
        error_backoff_s=cfg.get("scheduler.error_backoff_seconds"),
        prefix_prewarm_s=float(cfg.get("scheduler.prefix_prewarm_seconds", 0.25)),
    )
    return scheduler, backend


async def run_until_bound(scheduler, cluster, n_pods: int, deadline_s: float) -> bool:
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


async def _serve(scheduler, cluster) -> None:
    """Run the scheduling loop until it ends or SIGINT cancels this task
    (asyncio.run's handler); then stop it and close the cluster's watch.
    The loop task is shielded, so it ends by stop(), not by cancellation
    (JAX cli.py:386-400)."""
    task = asyncio.create_task(scheduler.run())
    try:
        await asyncio.shield(task)
    except (KeyboardInterrupt, asyncio.CancelledError):
        logger.info("shutting down")
        scheduler.stop()
        close = getattr(cluster, "close", None)
        if close:
            close()
        await asyncio.wait_for(task, timeout=30)


def _close(backend) -> None:
    close = getattr(backend, "close", None)
    if close:
        close()


def cmd_run(args: argparse.Namespace, cfg: Config) -> int:
    if args.fake_cluster:
        from k8s_llm_scheduler_tpu_torch.testing import synthetic_cluster

        cluster = synthetic_cluster(args.fake_nodes)
    else:
        from k8s_llm_scheduler_tpu_torch.cluster.kube import KubeCluster

        try:
            cluster = KubeCluster(watch_timeout_seconds=cfg.get("scheduler.watch_interval"))
        except Exception as exc:
            # a client is always importable (the in-tree transport); a
            # missing or unreachable kubeconfig surfaces here
            print(f"cannot reach a Kubernetes cluster ({exc}); use --fake-cluster "
                  f"for the in-memory cluster", file=sys.stderr)
            return 2
    scheduler, backend = build_stack(cfg, cluster, device=args.device)
    print(BANNER, file=sys.stderr)
    logger.info("scheduler %r starting", cfg.get("scheduler.name"))
    try:
        asyncio.run(_serve(scheduler, cluster))
    finally:
        _close(backend)
        # final stats dump (reference scheduler.py:803-819)
        print(json.dumps(scheduler.get_stats(), indent=2, default=str), flush=True)
    return 0


def cmd_demo(args: argparse.Namespace, cfg: Config) -> int:
    from k8s_llm_scheduler_tpu_torch.testing import fixture_raw_pods, synthetic_cluster

    overrides = {"graphs": not args.eager}
    for key in ("model", "quantize", "decode_matmul"):
        if getattr(args, key):
            overrides[key] = getattr(args, key)
    cluster = synthetic_cluster(args.fake_nodes)
    pods = fixture_raw_pods(cfg.get("scheduler.name"))
    for pod in pods:
        cluster.add_pod(pod)
    scheduler, backend = build_stack(cfg, cluster, device=args.device, **overrides)
    try:
        ok = asyncio.run(run_until_bound(scheduler, cluster, len(pods), DEMO_DEADLINE_S))
    finally:
        _close(backend)
    if ok:
        logger.info("demo: all fixture pods scheduled")
    else:
        logger.error("demo: %d of %d pods bound within %.0f s",
                     cluster.bind_count, len(pods), DEMO_DEADLINE_S)
    print(json.dumps(scheduler.get_stats(), indent=2, default=str))
    return 0 if ok else 1


def cmd_complete(args: argparse.Namespace, cfg: Config) -> int:
    """Free-form generation through the paged path (JAX cli.py:2450-2543):
    the general-completion capability the reference gets from its remote
    chat-completion endpoint, minus the network. Decision serving never
    uses it; this is its product surface: unbounded budgets, no grammar,
    long prompts through the chunked prefix path.

    The engine is SIZED FROM THE REQUEST: the prompt is encoded first, the
    page table is sized for (tail + budget), and a prompt beyond the
    largest prefill bucket is installed as a chunked dense prefix
    (set_prefix) with only its tail going through the bucketed suffix
    prefill and generate(), which decodes through the fused runtime, or
    through the speculative decoder with `--spec` or llm.spec_enabled
    (spec/; its arm, K and draft are the config's llm.spec_* keys)."""
    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import (
        ByteTokenizer,
        HFTokenizerAdapter,
    )
    from k8s_llm_scheduler_tpu_torch.observability import spans

    tokenizer_path = cfg.get("llm.tokenizer_path")
    tok = HFTokenizerAdapter(tokenizer_path) if tokenizer_path else ByteTokenizer()
    prompt = args.prompt if args.prompt is not None else sys.stdin.read()
    ids = (
        tok.chat_prompt("You are a helpful assistant.", prompt) if args.chat
        else tok.encode(prompt)
    )
    if not ids:
        print("empty prompt", file=sys.stderr)
        return 2
    page_size = int(cfg.get("llm.page_size"))
    buckets = tuple(cfg.get("llm.prefill_buckets"))
    # Only prompts beyond the LARGEST bucket need the long-context path;
    # the tail (and the decode budget) is what the page table must hold.
    tail = min(len(ids), max(1, buckets[-1]))
    pages_needed = -(-(tail + args.max_new_tokens + 1) // page_size) + 1
    overrides = dict(
        model=args.model or cfg.get("llm.model", "tiny"),
        max_new_tokens=args.max_new_tokens,
        max_pages_per_seq=pages_needed,
        num_pages=max(512, pages_needed + 8),
        constrained=False,
        device=args.device,
    )
    if args.temperature is not None:
        overrides["temperature"] = args.temperature
    if args.spec:
        overrides["spec_enabled"] = True
    kwargs = _backend_kwargs(cfg, **overrides)
    backend = build_local_backend(**kwargs)
    try:
        engine = backend.engine
        with spans.start_trace("completion", prompt_tokens=len(ids),
                               spec=bool(kwargs["spec_enabled"])) as trace:
            if len(ids) > tail:
                engine.set_prefix(ids[:-tail])
            fin = engine.generate(ids[-tail:], max_new_tokens=args.max_new_tokens)
            if trace is not None:
                trace.set_meta(generated_tokens=len(fin.token_ids))
        print(fin.text)
        logger.info(
            "completed %d tokens in %.1f ms%s", len(fin.token_ids), fin.latency_ms,
            f" (trace {trace.trace_id})" if trace is not None else "",
        )
        return 0
    finally:
        backend.close()


def _smi() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _tiny_forward(device: str) -> str:
    """A TINY suffix prefill against a prefix on `device`: K1 and K2 on a
    card, each checked launched."""
    import torch

    from k8s_llm_scheduler_tpu_torch.models.configs import TINY
    from k8s_llm_scheduler_tpu_torch.models.llama import (
        forward_prefill_suffix_dense,
        init_params,
    )
    from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as pa

    params = init_params(TINY, seed=0, device=device)
    kv = (TINY.n_layers, 64, TINY.n_kv_heads, TINY.head_dim)
    k_pfx = torch.randn(kv, generator=torch.Generator().manual_seed(0)).to(TINY.dtype).to(device)
    tokens = torch.arange(1, 33, dtype=torch.int32, device=device).view(1, 32)
    before = (pa.flash_prefix_attention_parts.launches,
              pa.flash_causal_attention_parts.launches)
    logits, _, _ = forward_prefill_suffix_dense(
        params, TINY, tokens, torch.tensor([32], dtype=torch.int32, device=device),
        k_pfx, k_pfx.clone(), torch.tensor(40, dtype=torch.int32, device=device),
    )
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")
    k1 = pa.flash_prefix_attention_parts.launches - before[0]
    k2 = pa.flash_causal_attention_parts.launches - before[1]
    if device != "cpu" and not (k1 and k2):
        raise RuntimeError(f"K1 launched {k1} times, K2 {k2}")
    return f"logits {tuple(logits.shape)}, K1 launches {k1}, K2 launches {k2}"


def cmd_verify(args: argparse.Namespace, cfg: Config) -> int:
    """Preflight (reference verify_setup.py:28-114), torch/CUDA edition."""
    failures = []

    def check(name: str, fn) -> None:
        try:
            detail = fn()
            print(f"  [ok] {name}" + (f" — {detail}" if detail else ""))
        except Exception as exc:
            failures.append((name, exc))
            print(f"  [FAIL] {name}: {exc}")

    def optional(mod: str, what: str) -> str:
        try:
            return f"{importlib.import_module(mod).__name__} installed ({what})"
        except ImportError:
            return f"not installed (optional: {what})"

    print("Preflight checks:")
    for mod in ("torch", "numpy"):
        check(f"import {mod}",
              lambda m=mod: f"{m} {getattr(importlib.import_module(m), '__version__', '')}")
    check("optional yaml", lambda: optional("yaml", "config files"))
    check("optional transformers", lambda: optional("transformers", "HF tokenizers"))
    check("optional kubernetes", lambda: optional(
        "kubernetes", "the official client; the in-tree REST transport works without it"))
    on_card = args.device != "cpu"

    def device_check():
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device visible")
        return f"{torch.cuda.get_device_name(0)} | {_smi()}"

    def build_check():
        from k8s_llm_scheduler_tpu_torch.ops import kernels

        t0 = time.perf_counter()
        reports = kernels.build_all()
        return f"{len(reports)} libraries with nvcc in {time.perf_counter() - t0:.1f} s"

    if on_card:
        check("CUDA device", device_check)
        check("kernels build (K1-K4)", build_check)
    check("config resolves", lambda: f"scheduler={cfg.get('scheduler.name')}, "
                                     f"model={cfg.get('llm.model')}")
    if not args.fast:
        check(f"model forward (TINY, {args.device})", lambda: _tiny_forward(args.device))

    def kube_check():
        from k8s_llm_scheduler_tpu_torch.cluster.kube import KubeCluster

        configured = (
            os.environ.get("KUBERNETES_SERVICE_HOST")
            or os.environ.get("KUBECONFIG")
            or os.path.exists(os.path.expanduser("~/.kube/config"))
        )
        if not configured:
            return (f"no kubeconfig found (driver {KubeCluster.driver()}; "
                    f"fake cluster available)")
        nodes = KubeCluster().get_node_metrics()
        return f"{len(nodes)} nodes visible ({KubeCluster.driver()} driver)"

    check("cluster access", kube_check)

    def tokenizer_check():
        # resolved as build_local_backend resolves it; with no HF tokenizer
        # configured, the bundled BPE fixture is checked as a packaging smoke
        path = cfg.get("llm.tokenizer_path")
        label = "configured tokenizer"
        if not path:
            ckpt = cfg.get("llm.checkpoint_path")
            if ckpt and (Path(ckpt) / "tokenizer.json").exists():
                path, label = ckpt, "checkpoint tokenizer"
        if not path:
            path = str(Path(__file__).resolve().parent / "assets" / "bpe4k")
            label = f"bundled BPE fixture (runtime builtin is {cfg.get('llm.tokenizer')!r})"
        try:
            from k8s_llm_scheduler_tpu_torch.engine.tokenizer import HFTokenizerAdapter

            tok = HFTokenizerAdapter(path)
        except ImportError:
            return "transformers not installed (builtin tokenizers available)"
        sample = "Node: node-1"
        if tok.decode(tok.encode(sample)) != sample:
            raise RuntimeError(f"tokenizer round-trip failed for {sample!r}")
        return f"{label}: vocab {tok.vocab_size}, pad {tok.pad_id}, eos {tok.eos_id}"

    if not args.fast:
        check("tokenizer loads + round-trips", tokenizer_check)

    if failures:
        print(f"\n{len(failures)} check(s) failed")
        return 1
    print("\nall checks passed")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m k8s_llm_scheduler_tpu_torch.cli",
        description="The PyTorch/CUDA port of the LLM scheduler.",
    )
    parser.add_argument("--config", default=None,
                        help="path to config.yaml (default: ./config.yaml if present)")
    sub = parser.add_subparsers(dest="command", required=True)

    def device_flag(p):
        p.add_argument("--device", default="cuda",
                       help="cuda (default; raises without a GPU) or cpu")

    run = sub.add_parser("run", help="run the scheduler against a cluster")
    run.add_argument("--fake-cluster", action="store_true",
                     help="an in-memory synthetic cluster in place of Kubernetes")
    run.add_argument("--fake-nodes", type=int, default=3)
    device_flag(run)
    run.set_defaults(func=cmd_run)

    verify = sub.add_parser("verify", help="preflight environment checks")
    verify.add_argument("--fast", action="store_true",
                        help="skip the model forward and the tokenizer")
    device_flag(verify)
    verify.set_defaults(func=cmd_verify)

    demo = sub.add_parser(
        "demo",
        help="schedule the three fixture pods on an in-memory fake cluster",
        description=(
            "Schedule the reference's three fixture pods on an in-memory fake "
            "cluster through the whole stack, then print the scheduler's stats "
            "as JSON. Weights are random from seed 0 unless llm.checkpoint_path "
            "is set. Decisions are sampled at llm.temperature (0.3 by default, "
            "as in the reference); LLM_TEMPERATURE=0 decodes greedily."
        ),
    )
    demo.add_argument("--fake-nodes", type=int, default=3,
                      help="nodes in the synthetic cluster (default 3)")
    demo.add_argument("--model", default=None,
                      help="model config name (default: llm.model)")
    demo.add_argument("--quantize", choices=("int8",), default=None,
                      help="int8 weight-only quantization (default: llm.quantization)")
    demo.add_argument("--decode-matmul", choices=("dense", "ragged"), default=None,
                      help="block-decode matmuls: dense, or ragged (the K3 kernel); "
                           "default: llm.decode_matmul")
    demo.add_argument("--eager", action="store_true",
                      help="run the engine's waves eagerly, not as CUDA graphs")
    device_flag(demo)
    demo.set_defaults(func=cmd_demo)

    complete = sub.add_parser(
        "complete", help="free-form text completion (paged path, fused decode)")
    complete.add_argument("--prompt", default=None, help="prompt text (default: stdin)")
    complete.add_argument("--model", default=None, help="config name")
    complete.add_argument("--max-new-tokens", type=int, default=200)
    complete.add_argument("--temperature", type=float, default=None)
    complete.add_argument("--chat", action="store_true",
                          help="wrap the prompt in the chat template")
    complete.add_argument("--spec", action="store_true",
                          help="speculative decoding (llm.spec_* settings)")
    device_flag(complete)
    complete.set_defaults(func=cmd_complete)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = load_config(yaml_path=args.config)
    setup_logging(level=cfg.get("logging.level"), fmt=cfg.get("logging.format"),
                  file=cfg.get("logging.file"))
    # tracing on/off and the flight recorder's size are process-global
    from k8s_llm_scheduler_tpu_torch.observability import spans

    spans.configure(
        enabled=bool(cfg.get("observability.tracing", True)),
        capacity=int(cfg.get("observability.flight_recorder_size", 256)),
    )
    return args.func(args, cfg)


if __name__ == "__main__":
    sys.exit(main())
