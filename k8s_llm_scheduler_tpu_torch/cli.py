"""Command line of the port: run / verify / demo / complete / journal /
eval / train / sim / chaos / rollout / learn / fleet / trace.

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
    python -m k8s_llm_scheduler_tpu_torch.cli [--config FILE] journal
        fsck|show|compact [--dir DIR] [--limit N]
    python -m k8s_llm_scheduler_tpu_torch.cli [--config FILE] eval
        [--checkpoint DIR] [--model NAME] [--cases N] [--scenarios]
        [--device cuda|cpu]
    python -m k8s_llm_scheduler_tpu_torch.cli [--config FILE] train --out DIR
        [--steps N] [--batch-size B] [--seq-len S] [--model NAME] [--lr LR]
        [--lr-schedule constant|cosine] [--resume] [--eval] ... [--device cuda|cpu]
    python -m k8s_llm_scheduler_tpu_torch.cli [--config FILE] sim
        [--seed S] [--nodes N] [--pods N] [--arrival burst|poisson|waves]
        [--arms llm,stub,teacher,...] [--trace F] [--replay F]
        [--device cuda|cpu]
    python -m k8s_llm_scheduler_tpu_torch.cli [--config FILE] chaos
        list|run|replay [--regime NAME|all] [--seed S] [--trace F] ...
    python -m k8s_llm_scheduler_tpu_torch.cli [--config FILE] rollout
        publish|status|fsck|rollback|promote|watch [--registry DIR] ...
    python -m k8s_llm_scheduler_tpu_torch.cli [--config FILE] learn
        mine|build|status|run|replay [--corpus DIR] [--registry DIR] ...
        [--device cuda|cpu]
    python -m k8s_llm_scheduler_tpu_torch.cli [--config FILE] fleet
        demo|shard POD|top|kvplane|autoscale [--replicas ...] ...
    python -m k8s_llm_scheduler_tpu_torch.cli [--config FILE] trace
        list|show ID|tail|export [--host H] [--port P]

A port of the JAX package's cli.py: the configuration comes from
`config.load_config` (env > config.yaml or `--config` > defaults), and
`_backend_kwargs` maps it onto build_local_backend in one place
(JAX cli.py:39-104), which `build_stack` wraps in the decision cache, the
circuit breaker, the decision client and the scheduler (JAX cli.py:106-187).

- `run` (JAX cli.py:231-485) watches and binds through `KubeCluster` (the
  in-tree REST transport, cluster/httpapi.py, when the `kubernetes` package
  is absent), or an in-memory synthetic cluster with `--fake-cluster`. It
  runs until SIGINT, then prints the scheduler's stats as JSON on stdout
  and exits 0. The banner goes to stderr, so stdout holds only the stats.
  Its operating plane, as in the JAX package: the durable decision journal
  with crash recovery before the watch starts (`durability.*`;
  sched/journal.py, sched/recovery.py), the wave profiler
  (`observability.profiler`, on by default), the SLO burn-rate engine with
  its breaker advisory and client brownout (`slo.*`), and the engine
  sampler with the metrics server (`metrics.*`: /metrics and /debug/*).
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
- `journal` (JAX cli.py:1155-1196) checks, dumps or compacts a decision
  journal; `trace` (JAX cli.py:1861-2026) reads a running scheduler's
  flight recorder over its metrics port.
- `train` (JAX cli.py:792-862) fine-tunes the decision model on the
  heuristic teacher's pairs (train/distill.train_and_save) and saves a
  native checkpoint that `llm.checkpoint_path` serves; with `--eval` it
  then prints the checkpoint's report card. It honours `llm.tokenizer`,
  `llm.answer_style` and `llm.mesh` (dp/fsdp/tp/sp: one process a rank,
  spawned by this one); with `distributed.enabled` every host runs it and
  spawns its own ranks, and the coordinator saves and reports.
- `eval` (JAX cli.py:884-908) prints the decision-quality report card
  (train/eval.py) as one JSON line; `sim` (JAX cli.py:969-1078) runs the
  seeded arena (sim/) across decision arms and records or replays its
  trace; `chaos` (JAX cli.py:1080-1152) lists the chaos regimes (chaos/),
  runs seeded fault schedules through the real stack under the invariant
  monitor, and replays a recorded chaos trace byte for byte.
- `rollout` (JAX cli.py:1241-1605) files checkpoints in the versioned
  registry, gates a candidate against the incumbent in the arena, moves
  the active pointer, and `watch` serves the active version while it
  shadow-scores, gates, hot-swaps and burns in new versions
  (rollout/). A swap copies the new weights into the serving tensors in
  place (engine.swap_params): the engine's captured CUDA graphs and K3's
  tensor maps hold the weights' addresses.
- `learn` (JAX cli.py:1606-1858) mines loss incidents of the serving
  policy into a versioned corpus, prints its curriculum, runs one whole
  cycle (learn/loop.LearnLoop: mine, finetune on `--device`, publish, the
  weakness and arena gates, promote) and replays its trace.
- `fleet` (JAX cli.py:2029-2417): `demo` runs a sharded fleet of stub
  replicas with leases over a fake cluster (with `fleet.kvplane.enabled`,
  beside one shared prefix-KV plane), `shard` maps a pod to its shard,
  `top` renders the merged telemetry of live replica servers, `kvplane`
  runs the shared prefix-KV plane's protocol over model-free replicas
  (fleet/kvplane/), and `autoscale` the elastic fleet over a diurnal
  curve.

`build_stack` wraps the backend as the JAX `_build_stack` does
(JAX cli.py:534-688): the fan-out over `distributed.replica_addrs`
(sched/replica.FanoutBackend), the prefill/decode pools of `fleet.*`
(fleet/pools.DisaggregatedBackend) and the decision router of `router.*`
(sched/router.RoutedBackend, its fast arm on `--device`), outermost.
`_run_worker_replica` serves a backend to such a coordinator.

`--device` is the port's own flag: the model runs on "cuda" (the default;
it raises without a GPU) unless "cpu" is asked for. `llm.mesh {tp: N}`
serves the model tensor parallel over N ranks, one process each, spawned
by the backend (engine/local.build_local_backend, parallel/launch.py);
with `distributed.enabled`, `cmd_run` joins the multi-host world
(`distributed.coordinator/num_processes/process_id`, N ranks a host) and
runs the control plane on host 0 only, every other host serving its own
replica through `_run_worker_replica`.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import importlib
import json
import logging
import math
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



def _backend_kwargs(cfg: Config, **overrides) -> dict:
    """The ONE cfg -> build_local_backend kwargs mapping (JAX cli.py:39-104),
    for the keys the port honours. `overrides` win (the CLI's flags)."""
    kwargs = dict(
        model=cfg.get("llm.model", "tiny"),
        mesh_axes=cfg.get("llm.mesh", None),
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
                snapshot_ttl_s: float = 1.0, wrap: bool = True, **backend_overrides):
    """(scheduler, backend) from `cfg` over `cluster` (its own binder), as
    the JAX package's `_build_stack` wires them: the backend (`backend`, or
    the stub with `llm.backend: stub`, or build_local_backend on `device`)
    wrapped, in the JAX order, in the replica fan-out
    (`distributed.replica_addrs`), the disaggregated pools (`fleet.*`) and
    the decision router outermost (`router.*`); then the decision cache and
    the circuit breaker where enabled, the client with its deadline ladder,
    and the scheduler. `wrap=False` leaves the fleet and router switches
    unread, as the JAX rollout watch does: its client serves `backend`
    itself. The client is
    `scheduler.client`; the backend returned is the outermost wrapper."""
    from k8s_llm_scheduler_tpu_torch.core.breaker import CircuitBreaker
    from k8s_llm_scheduler_tpu_torch.core.cache import DecisionCache
    from k8s_llm_scheduler_tpu_torch.sched.client import DecisionClient
    from k8s_llm_scheduler_tpu_torch.sched.loop import Scheduler

    if backend is None:
        if cfg.get("llm.backend") == "stub":
            from k8s_llm_scheduler_tpu_torch.engine.backend import StubBackend

            backend = StubBackend()
        else:
            from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend

            backend = build_local_backend(
                **_backend_kwargs(cfg, device=device, **backend_overrides))
    if wrap:
        # Coordinator fan-out across worker replicas (sched/replica.py).
        # Sits below the cache and single-flight, so only leader decisions
        # cross processes.
        backend = _maybe_fanout(backend, cfg)
        # Disaggregated prefill/decode pools (fleet/pools.py), around the
        # (possibly fanned-out) backend.
        backend = _maybe_disaggregate(backend, cfg)
        # Per-decision routing between the big arm (everything built
        # above) and a small fast tier (sched/router.py). Outermost, so
        # routing sees the decision before any pool or fan-out spends
        # big-arm capacity.
        backend = _maybe_router(backend, cfg, device)
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


def _run_worker_replica(cfg: Config, stop_event=None, ready=None, *,
                        device: str = "cuda") -> int:
    """A worker process's serving loop (JAX cli.py:487-531): build the
    local backend (or the stub under `llm.backend: stub`) on `device` and
    answer decision RPCs over sched/replica.ReplicaServer until the
    process is terminated (SIGINT) or `stop_event` is set. `ready`, when
    given, gets the bound port as `ready.port` and is set once the server
    listens. `cmd_run` reaches this on every host but the coordinator
    under `distributed.enabled`; on one host a worker is started by
    calling this function."""
    import threading

    from k8s_llm_scheduler_tpu_torch.sched.replica import ReplicaServer

    if cfg.get("llm.backend") == "stub":
        from k8s_llm_scheduler_tpu_torch.engine.backend import StubBackend

        backend = StubBackend()
    else:
        from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend

        backend = build_local_backend(**_backend_kwargs(cfg, device=device))
    server = ReplicaServer(
        backend,
        host=str(cfg.get("distributed.replica_bind_host")),
        port=int(cfg.get("distributed.replica_port")),
        max_inflight=int(cfg.get("distributed.replica_max_inflight")),
    )
    print(f"replica worker serving decisions on :{server.port}", flush=True)
    if ready is not None:
        ready.port = server.port
        ready.set()
    try:
        (stop_event or threading.Event()).wait()  # serve until terminated
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        _close(backend)
    return 0


def _parse_replica_addr(text: str, default_port: int, key: str) -> tuple[str, int]:
    """Parse one replica-address config entry into (host, port)."""
    if text.isdigit():
        # bare port (older configs wrote '9901' for localhost:9901): keep
        # that meaning rather than dialing a hostname made of digits
        return "localhost", int(text)
    if text.startswith("["):
        # bracketed IPv6: '[::1]:9901' or '[::1]' (default port)
        bracket_end = text.find("]")
        if bracket_end < 0:
            raise ValueError(
                f"{key} entry {text!r}: unterminated '[' (expected '[v6-addr]:port')")
        host = text[1:bracket_end]
        rest = text[bracket_end + 1:]
        if rest.startswith(":"):
            try:
                port = int(rest[1:])
            except ValueError:
                raise ValueError(
                    f"{key} entry {text!r}: port {rest[1:]!r} is not an integer"
                ) from None
        elif rest:
            raise ValueError(
                f"{key} entry {text!r}: trailing {rest!r} after ']' "
                f"(expected '[v6-addr]:port')")
        else:
            port = default_port
        return host, port
    if text.count(":") > 1:
        # bare IPv6 literal: rpartition(':') would misparse '::1' as host
        # ':' port 1, so brackets are demanded instead of a guess
        raise ValueError(
            f"{key} entry {text!r} looks like a bare IPv6 literal; write it "
            f"bracketed ('[{text}]:port')")
    host, sep, port_s = text.rpartition(":")
    if sep:
        try:
            port = int(port_s)
        except ValueError:
            raise ValueError(
                f"{key} entry {text!r}: port {port_s!r} is not an integer (expected "
                f"'host:port' or bare 'host')") from None
    else:
        host, port = text, default_port  # bare host: default port
    return host or "localhost", port


def _replica_clients(cfg: Config, addrs, key: str) -> list:
    from k8s_llm_scheduler_tpu_torch.sched.replica import ReplicaClient

    default_port = int(cfg.get("distributed.replica_port"))
    timeout_s = float(cfg.get("llm.timeout"))
    return [
        ReplicaClient(*_parse_replica_addr(str(addr), default_port, key),
                      request_timeout_s=timeout_s)
        for addr in addrs
    ]


def _maybe_fanout(backend, cfg: Config):
    """The backend in a FanoutBackend over it and the worker replicas of
    `distributed.replica_addrs`; the backend itself when there are none."""
    addrs = cfg.get("distributed.replica_addrs") or []
    if not addrs:
        return backend
    from k8s_llm_scheduler_tpu_torch.sched.replica import FanoutBackend

    replicas = [backend] + _replica_clients(cfg, addrs, "distributed.replica_addrs")
    logger.info("fanning decisions out over %d replicas", len(replicas))
    return FanoutBackend(replicas)


def _maybe_disaggregate(backend, cfg: Config):
    """The backend in a DisaggregatedBackend when fleet pools are
    configured: the prefill pool (the backend and `fleet.prefill_addrs`)
    absorbs admission bursts, prepacked; the decode pool
    (`fleet.decode_addrs`) keeps continuation latency flat. A no-op with
    fleet.enabled off or no pool addresses."""
    if not cfg.get("fleet.enabled"):
        return backend
    prefill_addrs = cfg.get("fleet.prefill_addrs") or []
    decode_addrs = cfg.get("fleet.decode_addrs") or []
    if not prefill_addrs and not decode_addrs:
        return backend
    from k8s_llm_scheduler_tpu_torch.fleet import DisaggregatedBackend

    prefill_pool = [backend] + _replica_clients(cfg, prefill_addrs, "fleet.prefill_addrs")
    decode_pool = _replica_clients(cfg, decode_addrs, "fleet.decode_addrs")
    logger.info("disaggregated pools: %d prefill / %d decode worker(s)",
                len(prefill_pool), len(decode_pool))
    return DisaggregatedBackend(
        prefill_pool,
        decode_pool,
        prepack_max_batch=int(cfg.get("fleet.prepack_max_batch")),
        prepack_window_s=float(cfg.get("fleet.prepack_window_ms")) / 1000.0,
    )


def _maybe_router(backend, cfg: Config, device: str = "cuda"):
    """The backend in a RoutedBackend when router.enabled: the big arm is
    the stack built below it, the fast arm a small model served on
    `device` (router.fast_model, router.fast_checkpoint,
    router.fast_tokenizer). A no-op when the big arm is the stub."""
    if not cfg.get("router.enabled"):
        return backend
    if cfg.get("llm.backend") == "stub":
        logger.warning("router.enabled ignored: llm.backend is stub")
        return backend
    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
    from k8s_llm_scheduler_tpu_torch.sched.router import RoutedBackend, RouterPolicy

    fast = build_local_backend(**_backend_kwargs(
        cfg,
        device=device,
        model=cfg.get("router.fast_model", "tiny"),
        checkpoint_path=cfg.get("router.fast_checkpoint"),
        tokenizer_name=cfg.get("router.fast_tokenizer", "numeric"),
        quantize=None,
    ))
    policy = RouterPolicy(
        big_min_budget_ms=float(cfg.get("router.big_min_budget_ms", 120.0)),
        big_cold_extra_ms=float(cfg.get("router.big_cold_extra_ms", 250.0)),
        complexity_threshold=int(cfg.get("router.complexity_threshold", 2)),
        prewarm_on_cold=bool(cfg.get("router.prewarm_on_cold", True)),
    )
    logger.info("routing decisions: big=%s fast=%s (min budget %.0fms, complexity >= %d)",
                cfg.get("llm.model", "tiny"), cfg.get("router.fast_model", "tiny"),
                policy.big_min_budget_ms, policy.complexity_threshold)
    return RoutedBackend(backend, fast, policy)


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


def _maybe_journal(cfg: Config):
    """The durable decision journal when the `durability` block enables it
    (sched/journal.py); None otherwise."""
    if not cfg.get("durability.enabled", False):
        return None
    journal_dir = cfg.get("durability.journal_dir", None)
    if not journal_dir:
        raise SystemExit(
            "durability.enabled is set but durability.journal_dir is not "
            "(DURABILITY_JOURNAL_DIR)"
        )
    from k8s_llm_scheduler_tpu_torch.sched.journal import DecisionJournal

    return DecisionJournal(
        journal_dir,
        fsync_policy=str(cfg.get("durability.fsync", "intent")),
        segment_max_records=int(cfg.get("durability.segment_max_records", 4096)),
    )


def _recovery_lookup(cluster):
    """The cluster-truth probe recovery needs (sched/recovery.PodLookup),
    from whatever cluster driver is in play."""
    factory = getattr(cluster, "recovery_lookup", None)  # KubeCluster
    if factory is not None:
        return factory()  # one list snapshot answers the whole pass
    get_pod = getattr(cluster, "get_pod", None)  # FakeCluster

    def lookup(ns: str, name: str):
        raw = get_pod(ns, name)
        if raw is None:
            return ("gone", None)
        if raw.node_name:
            return ("bound", raw.node_name)
        return ("pending", None)

    return lookup


def _recover(scheduler, cluster, journal) -> None:
    """Journal the binder's decide/intent/ack lifecycle and the breaker's
    trips, then reconcile what a previous incarnation left open BEFORE the
    watch starts: a decided-but-unbound pod completes without a model
    call, a bound-but-unacked one just gets its ack (JAX cli.py:236-262)."""
    from k8s_llm_scheduler_tpu_torch.sched import recovery as recovery_mod
    from k8s_llm_scheduler_tpu_torch.sched.recovery import JournaledBinder

    scheduler.binder = JournaledBinder(scheduler.binder, journal)
    breaker = scheduler.client.breaker
    if breaker is not None:
        breaker.journal_sink = journal.record_breaker
    report = recovery_mod.recover(
        journal, pod_lookup=_recovery_lookup(cluster), binder=scheduler.binder,
        breaker=breaker,
    )
    logger.info(
        "journal recovery: %d acked, %d completed, %d dropped, %d refused "
        "(resume rv=%s)", report.acked, report.rebound, report.dropped,
        report.failed, report.resume_rv,
    )


def _attach_profiler(cfg: Config, scheduler, engine):
    """The continuous wave profiler (observability/profiler.py), attached
    to `engine` when `observability.profiler` is on: per-wave dispatch and
    sync fences and the MFU loss decomposition, served at /debug/profile
    and as llm_scheduler_engine_profile_* gauges. With the resident loop,
    the scheduler attaches the engine's in-loop decision latency to each
    trace. None when off, or with no engine (the stub backend)."""
    if engine is None or not cfg.get("observability.profiler", True):
        return None
    from k8s_llm_scheduler_tpu_torch.observability.profiler import EngineProfiler

    profiler = EngineProfiler(
        cfg=engine.cfg, window=int(cfg.get("observability.profiler_window", 256)))
    engine.attach_profiler(profiler)
    if engine.persistent_loop:
        scheduler.resident_latency_fn = engine.resident_decision_latency
    return profiler


def _start_slo(cfg: Config, scheduler, profiler):
    """The SLO burn-rate engine (observability/slo.py) over the scheduler's
    stats, with the profiler's gauges mounted under `engine_profile` and
    `persistent`; its trips reach the breaker as an advisory and, with
    `slo.brownout`, shed the client's LLM rung until they clear. Started;
    None when `slo.enabled` is off (JAX cli.py:286-331)."""
    from k8s_llm_scheduler_tpu_torch.observability import slo as slo_mod

    provider = scheduler.get_stats
    if profiler is not None:
        def provider(_base=scheduler.get_stats, _prof=profiler):
            return {**_base(), "engine_profile": _prof.gauges(),
                    "persistent": _prof.persistent_gauges()}

    slo_engine = slo_mod.from_config(cfg.section("slo"), provider)
    if slo_engine is None:
        return None
    breaker = scheduler.client.breaker
    if breaker is not None:
        slo_engine.on_trip.append(lambda name, _detail: breaker.slo_advisory(name))
    if cfg.get("slo.brownout", True):
        # a sustained burn sheds the LLM rung until it clears: the falling
        # edge matters as much as the rising one
        client = scheduler.client
        slo_engine.on_trip.append(lambda name, _d: client.enter_brownout(f"slo:{name}"))
        slo_engine.on_clear.append(lambda name, _d: client.exit_brownout(f"slo:{name}"))
    slo_engine.start(interval_s=float(cfg.get("slo.interval_s", 10.0)))
    return slo_engine


def _start_metrics(cfg: Config, scheduler, engine, profiler, slo_engine,
                   extra_stats=None):
    """(metrics server, engine sampler), both started when
    `metrics.enabled` is on, else (None, None) (JAX cli.py:334-375). The
    sampler (observability/sampler.py) rings occupancy, KV use, prefix hit
    rate, tokens/s and device memory at /debug/engine; the server answers
    /metrics and /debug/* (observability/metrics.py). `extra_stats()`, when
    given, adds its subtrees to every scrape (`rollout watch`: the rollout
    gauges)."""
    if not cfg.get("metrics.enabled"):
        return None, None
    from k8s_llm_scheduler_tpu_torch.observability.metrics import MetricsServer

    sampler = None
    stats_provider = scheduler.get_stats
    if extra_stats is not None:
        def stats_provider(_base=scheduler.get_stats):
            return {**_base(), **extra_stats()}

    if engine is not None:
        from k8s_llm_scheduler_tpu_torch.observability.sampler import EngineSampler

        sampler = EngineSampler(
            engine,
            interval_s=float(cfg.get("observability.sampler_interval_s", 1.0)),
            window=int(cfg.get("observability.sampler_window", 600)),
        )
        sampler.start()

        def stats_provider(_base=stats_provider, _sampler=sampler):
            return {**_base(), "engine_telemetry": _sampler.latest()}

    server = MetricsServer(
        stats_provider,
        port=cfg.get("metrics.port"),
        is_alive=lambda: scheduler.running,
        engine_sampler=sampler,
        engine_profiler=profiler,
        slo_engine=slo_engine,
        # /debug/blackbox: the resident loop's last iterations
        blackbox_provider=(engine.persistent_blackbox
                           if engine is not None and engine.persistent_loop else None),
    )
    server.start()
    return server, sampler


def _run_scheduler(cfg: Config, cluster, *, device: str, journal=None) -> int:
    """Build the stack over `cluster` and serve until SIGINT, with the
    operating plane the config asks for (JAX cli.py:231-422): journal and
    recovery, profiler, SLO engine, sampler and metrics server. They stop
    in the JAX package's order: the sampler and the SLO engine first (no
    thread may read an engine mid-teardown), then the metrics server, then
    the backend (whose close flushes the profiler's open fences), then the
    journal; last, the stats go to stdout as JSON."""
    scheduler, backend = build_stack(cfg, cluster, device=device)
    sampler = slo_engine = metrics_server = None
    try:
        if journal is not None:
            _recover(scheduler, cluster, journal)
        engine = getattr(backend, "engine", None)
        profiler = _attach_profiler(cfg, scheduler, engine)
        slo_engine = _start_slo(cfg, scheduler, profiler)
        metrics_server, sampler = _start_metrics(cfg, scheduler, engine, profiler,
                                                 slo_engine)
        print(BANNER, file=sys.stderr)
        logger.info("scheduler %r starting", cfg.get("scheduler.name"))
        asyncio.run(_serve(scheduler, cluster))
    finally:
        if sampler is not None:
            sampler.stop()
        if slo_engine is not None:
            slo_engine.stop()
        if metrics_server is not None:
            metrics_server.stop()
        _close(backend)
        if journal is not None:
            journal.close()
        # final stats dump (reference scheduler.py:803-819)
        print(json.dumps(scheduler.get_stats(), indent=2, default=str), flush=True)
    return 0


def _maybe_init_distributed(cfg: Config, ranks_per_process: int | None = None) -> bool:
    """Join the multi-host world when `distributed.enabled` (JAX cli.py:
    425-441): a world of num_processes hosts x `ranks_per_process` ranks
    (parallel/distributed.py; serving's default: `llm.mesh` tp). True when
    this process runs the cluster-facing control plane: always
    single-process, host 0 otherwise."""
    if not cfg.get("distributed.enabled"):
        return True
    from k8s_llm_scheduler_tpu_torch.parallel.distributed import (
        init_distributed,
        is_coordinator,
    )

    if ranks_per_process is None:
        ranks_per_process = int((cfg.get("llm.mesh", None) or {}).get("tp", 1))
    init_distributed(
        cfg.get("distributed.coordinator"),
        cfg.get("distributed.num_processes"),
        cfg.get("distributed.process_id"),
        ranks_per_process=ranks_per_process,
    )
    return is_coordinator()


def cmd_run(args: argparse.Namespace, cfg: Config) -> int:
    if not _maybe_init_distributed(cfg):
        # a worker host: no control plane (watch/bind belong to the
        # coordinator alone); it serves its own replica over the decision
        # RPC until terminated (JAX cli.py:443-450)
        return _run_worker_replica(cfg, device=args.device)
    journal = _maybe_journal(cfg)
    if args.fake_cluster:
        from k8s_llm_scheduler_tpu_torch.testing import synthetic_cluster

        cluster = synthetic_cluster(args.fake_nodes)
    else:
        from k8s_llm_scheduler_tpu_torch.cluster.kube import KubeCluster

        kube_kwargs = {}
        if journal is not None:
            # resume the watch after the journaled resourceVersion (one
            # reconciling relist covers anything older) and keep the
            # journal's resume point current as events stream
            kube_kwargs = {"resume_rv": journal.state.last_rv,
                           "rv_hook": journal.record_rv}
        try:
            cluster = KubeCluster(
                watch_timeout_seconds=cfg.get("scheduler.watch_interval"), **kube_kwargs)
        except Exception as exc:
            # a client is always importable (the in-tree transport); a
            # missing or unreachable kubeconfig surfaces here
            print(f"cannot reach a Kubernetes cluster ({exc}); use --fake-cluster "
                  f"for the in-memory cluster", file=sys.stderr)
            if journal is not None:
                journal.close()
            return 2
    return _run_scheduler(cfg, cluster, device=args.device, journal=journal)


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


def cmd_journal(args: argparse.Namespace, cfg: Config) -> int:
    """Durable decision journal tooling (sched/journal.py):

        cli journal fsck     # per-segment integrity + the folded state
        cli journal show     # record stream (JSONL)
        cli journal compact  # fold completed lifecycles into one segment
    """
    from k8s_llm_scheduler_tpu_torch.sched import journal as journal_mod

    root = args.dir or cfg.get("durability.journal_dir", None)
    if not root:
        raise SystemExit(
            "no journal: pass --dir DIR or set durability.journal_dir "
            "(DURABILITY_JOURNAL_DIR)"
        )
    if args.journal_cmd == "fsck":
        report = journal_mod.fsck(root)
        print(json.dumps(report, indent=1, sort_keys=True))
        return 0 if report["ok"] else 1  # 1: torn bytes found
    if args.journal_cmd == "show":
        n = 0
        for seg, rec in journal_mod.iter_records(root):
            print(json.dumps({"segment": seg, **rec}, sort_keys=True))
            n += 1
            if args.limit and n >= args.limit:
                break
        return 0
    # compact: open (replays and truncates any torn tail) and rotate. The
    # journal's single-writer lock refuses a directory a live scheduler is
    # writing.
    try:
        journal = journal_mod.DecisionJournal(root)
    except journal_mod.JournalError as exc:
        raise SystemExit(str(exc)) from exc
    try:
        stats = journal.compact()
    finally:
        journal.close()
    print(json.dumps(stats, sort_keys=True))
    return 0


def cmd_eval(args: argparse.Namespace, cfg: Config) -> int:
    """Decision-quality report card (train/eval.py): teacher agreement on
    held-out clusters + placement load-spread vs the fallback scorer and a
    random placer, through the served stack (JAX cli.py:884-908). The
    backend is the config's (`_backend_kwargs`) at `--temperature`, an
    eval parameter that defaults to greedy so the report is reproducible;
    serving keeps llm.temperature. (The JAX package's _eval_backend_kwargs
    also drops multi-host mesh axes: `cli eval` never joins a multi-host
    world, and `cli train --eval` drops them itself.)"""
    from k8s_llm_scheduler_tpu_torch.train.eval import evaluate_checkpoint

    report = evaluate_checkpoint(
        args.model or cfg.get("llm.model", "tiny"),
        args.checkpoint,
        n_cases=args.cases,
        placement_pods=args.placement_pods,
        backend_kwargs=_backend_kwargs(cfg, temperature=args.temperature,
                                       device=args.device),
        scenarios=args.scenarios,
        scenario_cases_n=args.scenario_cases,
    )
    print(json.dumps(report))
    if args.scenarios and report.get("scenarios"):
        # human-readable table after the JSON line
        print(f"{'scenario':<18}{'agree%':>8}{'chance%':>9}{'valid%':>8}{'n':>5}",
              file=sys.stderr)
        for kind, row in report["scenarios"].items():
            print(f"{kind:<18}{row['agreement_pct']:>8}{row['chance_pct']:>9}"
                  f"{row['valid_pct']:>8}{row['n_cases']:>5}", file=sys.stderr)
    return 0


def cmd_train(args: argparse.Namespace, cfg: Config) -> int:
    """Fine-tune the decision model on heuristic-teacher pairs and save a
    native checkpoint servable via llm.checkpoint_path (train/distill.py;
    JAX cli.py:792-862)."""
    from k8s_llm_scheduler_tpu_torch.models.configs import get_config
    from k8s_llm_scheduler_tpu_torch.train.distill import train_and_save

    answer_style = cfg.get("llm.answer_style", "direct")
    if answer_style != "cot" and (args.micro_frac or args.cot_weight != 1.0):
        # these knobs only shape CoT batches; ignoring them silently would
        # waste a long run
        print("--micro-frac/--cot-weight require llm.answer_style: cot "
              "(set it in the config or LLM_ANSWER_STYLE)", file=sys.stderr)
        return 2
    # training is SPMD: every host runs this, each spawning its own ranks
    # (dp/fsdp span the hosts, tp/sp stay within one)
    mesh_axes = cfg.get("llm.mesh", None) or {}
    coordinator = _maybe_init_distributed(
        cfg, ranks_per_process=math.prod(int(mesh_axes.get(a, 1)) for a in ("tp", "sp")))
    loss = train_and_save(
        get_config(args.model),
        mesh_axes=cfg.get("llm.mesh", None),
        out_dir=args.out,
        steps=args.steps,
        batch_size=args.batch_size,
        seq_len=args.seq_len,
        lr=args.lr,
        tokenizer_name=cfg.get("llm.tokenizer", "byte"),
        name_weight=args.name_weight,
        probe_every=args.probe_every,
        lr_schedule=args.lr_schedule,
        easy_frac=args.easy_frac,
        save_every=args.save_every,
        resume=args.resume,
        answer_style=answer_style,
        cot_weight=args.cot_weight,
        micro_frac=args.micro_frac,
        prompt_lm_frac=args.prompt_lm_frac,
        placement_frac=args.placement_frac,
        diverse_frac=args.diverse_frac,
        seed=args.seed,
        registry_dir=(None if args.no_publish
                      else args.registry or cfg.get("rollout.registry_dir", None)),
        device=args.device,
    )
    print(f"final loss {loss:.4f}; checkpoint at {args.out}")
    if args.eval and coordinator:
        from k8s_llm_scheduler_tpu_torch.train.eval import evaluate_checkpoint

        kwargs = _backend_kwargs(cfg, temperature=0.0, device=args.device)
        if cfg.get("distributed.enabled"):
            kwargs["mesh_axes"] = None  # the report card is this host's alone
        report = evaluate_checkpoint(args.model, args.out, n_cases=args.eval_cases,
                                     backend_kwargs=kwargs)
        print(json.dumps(report))
    return 0


def _sim_arms(args: argparse.Namespace, cfg: Config) -> list:
    """Arm names -> ArmSpecs (JAX cli.py:918-966). `llm` serves the
    CONFIGURED decision backend (llm.backend: local builds the engine on
    --device at temperature 0, greedy, so the arena's determinism contract
    holds; stub is the zero-weights stand-in). `stub` always means
    StubBackend through the full stack. Heuristic names come from
    core/fallback.SCORERS; `teacher` is the sim/teacher.py reference."""
    from k8s_llm_scheduler_tpu_torch.core.fallback import SCORERS
    from k8s_llm_scheduler_tpu_torch.engine.backend import StubBackend
    from k8s_llm_scheduler_tpu_torch.sim import ArmSpec, HeuristicBackend, teacher_arm

    specs: list = []
    for name in [a.strip() for a in args.arms.split(",") if a.strip()]:
        if name == "llm":
            if cfg.get("llm.backend") == "stub":
                specs.append(ArmSpec(name="llm", kind="stack", make=StubBackend))
            else:
                def make_llm():
                    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend

                    return build_local_backend(**_backend_kwargs(
                        cfg, temperature=0.0, device=args.device))

                specs.append(ArmSpec(name="llm", kind="stack", make=make_llm))
        elif name == "stub":
            specs.append(ArmSpec(name="stub", kind="stack", make=StubBackend))
        elif name == "teacher":
            specs.append(teacher_arm())
        elif name in SCORERS:
            specs.append(ArmSpec(name=name, kind="stack",
                                 make=lambda n=name: HeuristicBackend(n)))
        else:
            raise SystemExit(
                f"unknown arm {name!r} (known: llm, stub, teacher, {', '.join(SCORERS)})")
    return specs


def cmd_sim(args: argparse.Namespace, cfg: Config) -> int:
    """Cluster-twin scenario arena (sim/, JAX cli.py:969-1078): seeded
    burst/Poisson workloads through the REAL stack over the wire-level fake
    API server, scored across decision arms, recorded as a bit-identically
    replayable trace."""
    from k8s_llm_scheduler_tpu_torch.sim import (
        ChurnEvent,
        ScenarioSpec,
        generate_scenario,
        run_arena,
        save_trace,
        verify_trace,
    )

    if args.replay:
        ok, detail = verify_trace(args.replay)
        print(json.dumps({"metric": "sim_replay", "ok": ok, "trace": args.replay,
                          "detail": detail}))
        return 0 if ok else 1

    churn = []
    for entry in args.churn or []:
        try:
            wave_s, kind, node = entry.split(":", 2)
            churn.append(ChurnEvent(wave=int(wave_s), kind=kind, node=node))
        except ValueError:
            raise SystemExit(f"--churn {entry!r}: expected WAVE:KIND:NODE "
                             f"(e.g. 2:fail:sim-node-003)") from None
    spec = ScenarioSpec(
        name=args.name,
        seed=args.seed,
        n_nodes=args.nodes,
        n_pods=args.pods,
        shapes=args.shapes,
        arrival=args.arrival,
        arrival_rate=args.arrival_rate,
        n_waves=args.waves,
        hetero=not args.homogeneous,
        taint_frac=args.taint_frac,
        constraint_mix=tuple(c.strip() for c in args.constraints.split(",") if c.strip()),
        churn=tuple(churn),
    )
    try:
        scenario = generate_scenario(spec)
    except ValueError as exc:
        raise SystemExit(str(exc)) from None
    arms = _sim_arms(args, cfg)

    live: dict = {"arena": {"done_arms": 0, "arms": {}}}
    metrics_server = None
    if args.metrics_port is not None:
        from k8s_llm_scheduler_tpu_torch.observability.metrics import MetricsServer

        metrics_server = MetricsServer(lambda: live["arena"], port=args.metrics_port)
        metrics_server.start()

    def on_arm_done(name: str, arm_report: dict) -> None:
        live["arena"]["done_arms"] += 1
        live["arena"]["arms"][name] = {"scores": arm_report["scores"],
                                       "waves": arm_report["waves"]}
        print(json.dumps({"metric": "sim_arm", "arm": name, "scores": arm_report["scores"],
                          "placements_digest": arm_report["placements_digest"]}),
              flush=True)

    try:
        report = run_arena(scenario, arms, wave_timeout_s=args.wave_timeout,
                           on_arm_done=on_arm_done)
    finally:
        if metrics_server is not None:
            metrics_server.stop()

    if args.trace:
        save_trace(report, args.trace)
    report.pop("_traces")
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=1, sort_keys=True)
    # headline: one line, deterministic fields only
    print(json.dumps({
        "metric": "sim_arena",
        "seed": spec.seed,
        "nodes": spec.n_nodes,
        "pods": spec.n_pods,
        "waves": len(scenario.waves),
        "arms": {
            name: {
                "spread": arm["scores"]["spread"],
                "bound_frac": arm["scores"]["bound_frac"],
                "constraint_satisfaction": arm["scores"]["constraint_satisfaction"],
                "placements_digest": arm["placements_digest"],
            }
            for name, arm in report["arms"].items()
        },
    }))
    return 0


def _rollout_registry(args: argparse.Namespace, cfg: Config):
    from k8s_llm_scheduler_tpu_torch.rollout import CheckpointRegistry

    root = getattr(args, "registry", None) or cfg.get("rollout.registry_dir", None)
    if not root:
        raise SystemExit(
            "no registry: pass --registry DIR or set rollout.registry_dir "
            "(ROLLOUT_REGISTRY_DIR)"
        )
    return CheckpointRegistry(root)


def _retention_pins(cfg: Config) -> set:
    """Versions retention must keep beyond the keep-last window: every
    checkpoint an incident corpus mined against (learn.corpus_dir lineage;
    evicting one orphans the corpus's provenance)."""
    corpus_dir = cfg.get("learn.corpus_dir", None)
    if not corpus_dir or not os.path.isdir(str(corpus_dir)):
        return set()
    from k8s_llm_scheduler_tpu_torch.learn import IncidentCorpus

    return IncidentCorpus(corpus_dir).lineage_versions()


def _gate_from_cfg(cfg: Config, seed: int | None = None):
    from k8s_llm_scheduler_tpu_torch.rollout import GateConfig

    g = cfg.section("rollout").get("gate", {})
    return GateConfig(
        seed=seed if seed is not None else int(g.get("seed", 0)),
        nodes=int(g.get("nodes", 12)),
        pods=int(g.get("pods", 48)),
        shapes=int(g.get("shapes", 8)),
        waves=int(g.get("waves", 2)),
        spread_tolerance=float(g.get("spread_tolerance", 0.02)),
        constraint_tolerance=float(g.get("constraint_tolerance", 0.0)),
        bound_tolerance=float(g.get("bound_tolerance", 0.0)),
    )


def cmd_chaos(args: argparse.Namespace, cfg: Config) -> int:
    """Deterministic chaos plane (chaos/; JAX cli.py:1080-1152): seeded
    fault schedules over the real stack, invariant-monitored, replayable
    byte for byte. No model runs: the decisions come from stubs and the
    harness's HashPlacementBackend."""
    from k8s_llm_scheduler_tpu_torch.chaos import (
        REGIMES,
        run_chaos,
        save_chaos_trace,
        verify_chaos_trace,
    )

    if args.chaos_cmd == "list":
        for name in sorted(REGIMES):
            info = REGIMES[name]
            print(f"{name:18s} [{info['mode']:6s}] {info['describe']}")
        return 0

    if args.chaos_cmd == "replay":
        ok, detail = verify_chaos_trace(args.trace)
        print(json.dumps({"metric": "chaos_replay", "ok": ok, "trace": args.trace,
                          "detail": detail}))
        return 0 if ok else 1

    regimes = sorted(REGIMES) if args.regime == "all" else [args.regime]
    unknown = [r for r in regimes if r not in REGIMES]
    if unknown:
        raise SystemExit(f"unknown regime(s) {unknown}; `cli chaos list` shows all")
    if args.trace and len(regimes) != 1:
        raise SystemExit("--trace records exactly one regime's run")
    deadline_ms = args.deadline_ms
    if deadline_ms is not None and deadline_ms <= 0:
        deadline_ms = None
    exit_code = 0
    for regime in regimes:
        report = run_chaos(
            regime, seed=args.seed, n_waves=args.waves, n_nodes=args.nodes,
            n_pods=args.pods, wave_timeout_s=args.wave_timeout,
            deadline_ms=deadline_ms,
        )
        if args.trace:
            save_chaos_trace(report, args.trace)
        if args.out:
            mode = "w" if regime == regimes[0] else "a"  # JSONL, one run per line
            with open(args.out, mode, encoding="utf-8") as fh:
                json.dump(report, fh, sort_keys=True)
                fh.write("\n")
        clean = report["invariants"]["clean"]
        if not clean:
            exit_code = 1
            for v in report["invariants"]["violations"]:
                line = f"VIOLATION [{v['invariant']}] {v['subject']}: {v['detail']}"
                if v.get("trace_id"):
                    line += f" (cli trace show {v['trace_id']})"
                print(line, flush=True)
        print(json.dumps({
            "metric": "chaos",
            "regime": regime,
            "seed": args.seed,
            "mode": report["mode"],
            "clean": clean,
            "plan_digest": report["plan_digest"],
            "bound_frac": report["scores"]["bound_frac"],
            "degraded_fraction": report["degraded_fraction"],
            "recovery_waves": report["recovery"]["recovery_waves"],
            "injections": report["injections"],
        }), flush=True)
    return exit_code


def cmd_rollout(args: argparse.Namespace, cfg: Config) -> int:
    """Live-rollout surface (rollout/, JAX cli.py:1241-1315): publish a
    trained checkpoint into the versioned registry, inspect or verify it,
    gate-and-promote a candidate, roll the active pointer back, or run the
    live watch loop (shadow scoring + canary controller + hot swap)
    against a serving stack. `rollout.retain` keeps the newest versions,
    the active one and its parent, and every version an incident corpus
    (learn.corpus_dir) mined against (`_retention_pins`)."""
    registry = _rollout_registry(args, cfg)

    if args.rollout_cmd == "publish":
        from k8s_llm_scheduler_tpu_torch.models.configs import get_config

        model = args.model or cfg.get("llm.model", "tiny")
        manifest = registry.publish(
            args.checkpoint,
            cfg=get_config(model),
            tokenizer=cfg.get("llm.tokenizer", "byte"),
            parent=args.parent,
            note=args.note,
        )
        retain = int(cfg.get("rollout.retain", 0))
        if retain:
            registry.retain(retain, pinned=_retention_pins(cfg))
        print(json.dumps({
            "metric": "rollout_publish",
            "version": manifest.version,
            "config": manifest.config_name,
            "fingerprint": manifest.config_fingerprint,
            "parent": manifest.parent,
            "n_files": len(manifest.files),
        }))
        return 0

    if args.rollout_cmd == "status":
        print(json.dumps(registry.status(), indent=1, sort_keys=True))
        return 0

    if args.rollout_cmd == "fsck":
        report = registry.fsck()
        bad = {v: p for v, p in report.items() if p}
        print(json.dumps({
            "metric": "rollout_fsck",
            "versions": len(report),
            "clean": len(report) - len(bad),
            "problems": {str(v): p for v, p in bad.items()},
        }, indent=1, sort_keys=True))
        return 1 if bad else 0

    if args.rollout_cmd == "rollback":
        active = registry.active()
        if active is None:
            print("no active version to roll back from", file=sys.stderr)
            return 2
        target = registry.get(active).parent
        if target is None:
            versions = [v for v in registry.versions() if v < active]
            target = versions[-1] if versions else None
        if target is None:
            print(f"active version {active} has no predecessor", file=sys.stderr)
            return 2
        registry.set_active(target)
        print(json.dumps({"metric": "rollout_rollback", "from": active, "to": target}))
        return 0

    if args.rollout_cmd == "promote":
        return _rollout_promote(args, cfg, registry)

    if args.rollout_cmd == "watch":
        return _rollout_watch(args, cfg, registry)

    raise SystemExit(f"unknown rollout command {args.rollout_cmd!r}")


def _rollout_backend_factory(cfg: Config, checkpoint_path: str | None, device: str):
    """make() for a gate or shadow arm: the configured local stack serving
    `checkpoint_path` greedily (the arena's determinism contract) on
    `device`. The backend owns its engine: closing the arm frees its
    device memory."""
    def make():
        from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend

        return build_local_backend(**_backend_kwargs(
            cfg, temperature=0.0, checkpoint_path=checkpoint_path, device=device))

    return make


def _rollout_promote(args: argparse.Namespace, cfg: Config, registry) -> int:
    """Gate a candidate against the incumbent and move the active pointer
    (JAX cli.py:1332-1381). The incumbent arm serves the ACTIVE registry
    version (or the config's llm.checkpoint_path, or random-init when
    neither exists); the two arms run one after the other, each closed
    before the next is built. In-process hot swapping of a running
    scheduler is `rollout watch`'s job; promote moves the durable pointer
    that serving processes read at startup."""
    from k8s_llm_scheduler_tpu_torch.rollout import run_gate

    candidate = registry.get(args.version)
    if args.no_gate:
        registry.set_active(args.version)
        print(json.dumps({"metric": "rollout_promote", "version": args.version,
                          "gate": "skipped"}))
        return 0
    active = registry.active()
    incumbent_ckpt = (
        str(registry.get(active).checkpoint_path)
        if active is not None
        else cfg.get("llm.checkpoint_path", None)
    )
    verdict = run_gate(
        _rollout_backend_factory(cfg, incumbent_ckpt, args.device),
        _rollout_backend_factory(cfg, str(candidate.checkpoint_path), args.device),
        _gate_from_cfg(cfg, seed=args.seed),
    )
    registry.record_scores(args.version, {"gate": {
        "pass": verdict["pass"], "checks": verdict["checks"],
        "candidate": verdict["candidate"],
    }})
    if verdict["pass"]:
        registry.set_active(args.version)
    print(json.dumps({
        "metric": "rollout_promote",
        "version": args.version,
        "pass": verdict["pass"],
        "checks": verdict["checks"],
        "incumbent": verdict["incumbent"],
        "candidate": verdict["candidate"],
        "active": registry.active(),
    }))
    return 0 if verdict["pass"] else 1


class _ShadowArm:
    """The watch loop's shadow arm (JAX cli.py:1477-1511): a ShadowScorer
    over a backend serving the newest PROMOTABLE candidate (newer than the
    active version and not rejected), rebuilt when that version changes
    and dropped when there is none or the fraction is 0. Anything else (a
    superseded or rejected version) would hold a whole model's device
    memory scoring a policy that can never be promoted."""

    def __init__(self, scheduler, registry, controller, fraction: float, make_backend):
        self.scheduler = scheduler
        self.registry = registry
        self.controller = controller
        self.fraction = fraction
        self.make_backend = make_backend  # checkpoint path -> backend
        self.scorer = None

    def refresh(self) -> None:
        from k8s_llm_scheduler_tpu_torch.rollout import ShadowScorer

        active = self.registry.active() or 0
        versions = [v for v in self.registry.versions()
                    if v > active and v not in self.controller.rejected]
        newest = versions[-1] if versions and self.fraction > 0 else None
        if self.scorer is not None and self.scorer.candidate_version == newest:
            return
        self.close()
        if newest is not None:
            self.scorer = ShadowScorer(
                self.make_backend(str(self.registry.get(newest).checkpoint_path)),
                fraction=self.fraction, candidate_version=newest)
            self.scheduler.shadow = self.scorer

    def close(self) -> None:
        if self.scorer is not None:
            self.scheduler.shadow = None
            self.scorer.close()
            self.scorer.candidate.close()
            self.scorer = None


def _rollout_watch(args: argparse.Namespace, cfg: Config, registry) -> int:
    """Live rollout loop (JAX cli.py:1384-1605): serve the active version,
    shadow-score the newest candidate, gate / promote / burn in / roll back
    as new versions land; until SIGINT, then the stats JSON (with the
    rollout subtree) on stdout and exit 0. The stack is `cli run`'s: the
    journal with recovery, the wave profiler, the SLO engine (its trips
    also roll an open burn-in back) and the metrics server, whose /metrics
    carries the rollout gauges. Promotions hot-swap the serving engine in
    place (rollout/hotswap.py, mode `rollout.swap_mode`); gate arms and
    the shadow arm are backends of their own, each freed when closed."""
    import threading

    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
    from k8s_llm_scheduler_tpu_torch.models.configs import get_config
    from k8s_llm_scheduler_tpu_torch.rollout import CanaryController, HotSwapper

    if cfg.get("llm.backend") == "stub":
        print("rollout watch needs llm.backend: local", file=sys.stderr)
        return 2
    active = registry.active()
    active_ckpt = str(registry.get(active).checkpoint_path) if active is not None else None
    backend = build_local_backend(**_backend_kwargs(
        cfg, checkpoint_path=active_ckpt or cfg.get("llm.checkpoint_path"),
        device=args.device))
    journal = _maybe_journal(cfg)
    if args.fake_cluster:
        from k8s_llm_scheduler_tpu_torch.testing import synthetic_cluster

        cluster = synthetic_cluster(args.fake_nodes)
    else:
        from k8s_llm_scheduler_tpu_torch.cluster.kube import KubeCluster

        kube_kwargs = {}
        if journal is not None:
            kube_kwargs = {"resume_rv": journal.state.last_rv,
                           "rv_hook": journal.record_rv}
        cluster = KubeCluster(
            watch_timeout_seconds=cfg.get("scheduler.watch_interval"), **kube_kwargs)
    # the JAX watch's client serves the swapped backend itself: no
    # fan-out, pools or router around it (their replicas and fast arm
    # would keep serving the old weights)
    scheduler, _ = build_stack(cfg, cluster, backend=backend, device=args.device, wrap=False)
    client = scheduler.client

    def factory(ckpt):
        return _rollout_backend_factory(cfg, ckpt, args.device)

    def incumbent_factory():
        # resolved at GATE time: after a promotion the next candidate is
        # compared with the CURRENT active version
        active_now = registry.active()
        ckpt = (str(registry.get(active_now).checkpoint_path) if active_now is not None
                else cfg.get("llm.checkpoint_path"))
        return factory(ckpt)()

    swapper = HotSwapper(
        backend, registry, backend.engine.cfg,
        quantize=cfg.get("llm.quantization"),
        cache=client.cache, mode=cfg.get("rollout.swap_mode", "auto"),
    )
    stop = threading.Event()
    ctl_thread = sampler = slo_engine = metrics_server = shadow = None
    try:
        if journal is not None:
            _recover(scheduler, cluster, journal)
        profiler = _attach_profiler(cfg, scheduler, backend.engine)
        slo_engine = _start_slo(cfg, scheduler, profiler)
        controller = CanaryController(
            registry, swapper,
            stats_provider=scheduler.get_stats,
            incumbent_factory=incumbent_factory,
            candidate_factory=lambda v: factory(str(registry.get(v).checkpoint_path)),
            gate=_gate_from_cfg(cfg),
            burn_in_decisions=int(cfg.get("rollout.burn_in_decisions", 200)),
            trip_fallback_rate=float(cfg.get("rollout.trip_fallback_rate", 0.2)),
            trip_invalid_rate=float(cfg.get("rollout.trip_invalid_rate", 0.05)),
            trip_bind_failure_rate=float(cfg.get("rollout.trip_bind_failure_rate", 0.05)),
            trip_decide_p99_ms=cfg.get("rollout.trip_decide_p99_ms", None),
            slo_engine=slo_engine,
        )
        shadow_frac = (args.shadow_frac if args.shadow_frac is not None
                       else float(cfg.get("rollout.shadow_fraction", 0.0)))
        shadow = _ShadowArm(scheduler, registry, controller, shadow_frac,
                            lambda ckpt: factory(ckpt)())

        def controller_loop():
            poll = float(cfg.get("rollout.poll_seconds", 5.0))
            while not stop.wait(poll):
                try:
                    shadow.refresh()
                    controller.tick()
                except Exception:
                    logger.exception("rollout controller tick failed")

        ctl_thread = threading.Thread(target=controller_loop, daemon=True,
                                      name="rollout-controller")
        ctl_thread.start()
        metrics_server, sampler = _start_metrics(
            cfg, scheduler, backend.engine, profiler, slo_engine,
            extra_stats=lambda: {"rollout": controller.stats()})
        print(BANNER, file=sys.stderr)
        logger.info("rollout watch: registry=%s active=%s shadow_frac=%.3f",
                    registry.root, registry.active(), shadow_frac)
        asyncio.run(_serve(scheduler, cluster))
    finally:
        stop.set()
        if ctl_thread is not None:
            ctl_thread.join(timeout=30)
        if sampler is not None:
            sampler.stop()
        if slo_engine is not None:
            slo_engine.stop()
        if metrics_server is not None:
            metrics_server.stop()
        if shadow is not None:
            shadow.close()
        _close(backend)
        if journal is not None:
            journal.close()
        stats = scheduler.get_stats()
        if ctl_thread is not None:
            stats["rollout"] = controller.stats()
        print(json.dumps(stats, indent=2, default=str), flush=True)
    return 0


def _learn_corpus(args: argparse.Namespace, cfg: Config):
    from k8s_llm_scheduler_tpu_torch.learn import IncidentCorpus

    root = getattr(args, "corpus", None) or cfg.get("learn.corpus_dir", None)
    if not root:
        raise SystemExit(
            "no incident corpus: pass --corpus DIR or set learn.corpus_dir "
            "(LEARN_CORPUS_DIR)"
        )
    return IncidentCorpus(root)


def _learn_config(args: argparse.Namespace, cfg: Config):
    from k8s_llm_scheduler_tpu_torch.learn import LearnConfig

    sect = cfg.section("learn")
    seeds = getattr(args, "seeds", None)
    if seeds:
        mine_seeds = tuple(int(s) for s in seeds.split(",") if s.strip())
    else:
        mine_seeds = tuple(int(s) for s in sect.get("mine_seeds", [0, 1]))
    replay_fraction = getattr(args, "replay_fraction", None)
    return LearnConfig(
        seed=int(getattr(args, "seed", 0) or 0),
        mine_seeds=mine_seeds,
        mine_nodes=int(sect.get("mine_nodes", 8)),
        mine_pods=int(sect.get("mine_pods", 48)),
        mine_waves=int(sect.get("mine_waves", 3)),
        spread_margin=float(sect.get("spread_margin", 0.005)),
        replay_fraction=float(
            replay_fraction if replay_fraction is not None
            else sect.get("replay_fraction", 0.3)
        ),
        steps=int(getattr(args, "steps", None) or sect.get("steps", 200)),
        batch_size=int(sect.get("batch_size", 4)),
        seq_len=int(sect.get("seq_len", 1024)),
        lr=float(sect.get("lr", 3e-4)),
        weakness_cases=int(sect.get("weakness_cases", 32)),
        weakness_margin=float(sect.get("weakness_margin", 0.0)),
        gate=_gate_from_cfg(cfg),
        retain=int(sect.get("retain", 0)),
    )


def _learn_candidate_arm(cfg: Config, checkpoint_path: str | None, device: str):
    """The serving policy as a stack arena arm for mining: the configured
    backend (the stub, or the local stack serving `checkpoint_path`
    greedily on `device`: the arena's determinism contract)."""
    from k8s_llm_scheduler_tpu_torch.sim import ArmSpec

    if cfg.get("llm.backend") == "stub":
        from k8s_llm_scheduler_tpu_torch.engine.backend import StubBackend

        return ArmSpec(name="llm", kind="stack", make=StubBackend)
    return ArmSpec(name="llm", kind="stack",
                   make=_rollout_backend_factory(cfg, checkpoint_path, device))


def _learn_active_checkpoint(args, cfg: Config):
    """(registry | None, active version | None, checkpoint path | None): the
    incumbent the loop mines, gates against and finetunes from. The active
    version is read here, once, with its path: a promotion landing between
    this read and a later one would let the corpus's lineage point at a
    checkpoint that never produced the mined placements."""
    registry = None
    if getattr(args, "registry", None) or cfg.get("rollout.registry_dir", None):
        registry = _rollout_registry(args, cfg)
    active = registry.active() if registry is not None else None
    if active is not None:
        return registry, active, str(registry.get(active).checkpoint_path)
    return registry, None, cfg.get("llm.checkpoint_path", None)


def cmd_learn(args: argparse.Namespace, cfg: Config) -> int:
    """The closed policy-improvement loop (learn/; JAX cli.py:1689-1769):
    mine loss incidents from seeded arena runs of the serving policy
    against the spread-lookahead teacher, build replay-mixed finetune
    batches, run the whole mine -> finetune -> publish -> gate -> promote
    cycle, or inspect and replay its artifacts."""
    from k8s_llm_scheduler_tpu_torch.learn import (
        curriculum_summary,
        mine_scenario,
        verify_learn_trace,
    )

    if args.learn_cmd == "replay":
        ok, detail = verify_learn_trace(args.trace)
        print(json.dumps({"metric": "learn_replay", "ok": ok, "trace": args.trace,
                          "detail": detail}))
        return 0 if ok else 1

    corpus = _learn_corpus(args, cfg)

    if args.learn_cmd == "status":
        status = corpus.status()
        if getattr(args, "registry", None) or cfg.get("rollout.registry_dir", None):
            registry = _rollout_registry(args, cfg)
            status["registry_active"] = registry.active()
            status["lineage_versions"] = sorted(corpus.lineage_versions())
        print(json.dumps(status, indent=1, sort_keys=True))
        return 0

    if args.learn_cmd == "mine":
        learn_cfg = _learn_config(args, cfg)
        _registry, active_version, ckpt = _learn_active_checkpoint(args, cfg)
        sources = [
            mine_scenario(
                spec, _learn_candidate_arm(cfg, ckpt, args.device),
                spread_margin=learn_cfg.spread_margin,
                wave_timeout_s=learn_cfg.gate.wave_timeout_s,
            )
            for spec in learn_cfg.mine_specs()
        ]
        record = corpus.add_version(
            sources,
            # the version read with the checkpoint path, before the mining
            # pass: never a re-read
            checkpoint_version=active_version,
            note=args.note,
        )
        print(json.dumps({
            "metric": "learn_mine",
            "corpus_version": record["version"],
            "n_incidents": record["n_incidents"],
            "per_class": record["per_class"],
            "digest": record["digest"],
            "checkpoint_version": record["checkpoint_version"],
            "sources": len(sources),
        }))
        return 0

    if args.learn_cmd == "build":
        record = corpus.get(args.version) if args.version else corpus.latest()
        if record is None:
            print("corpus has no versions — run `cli learn mine` first", file=sys.stderr)
            return 2
        learn_cfg = _learn_config(args, cfg)
        print(json.dumps({"metric": "learn_build",
                          **curriculum_summary(record, learn_cfg.replay_fraction)}))
        return 0

    if args.learn_cmd == "run":
        return _learn_run(args, cfg, corpus)

    raise SystemExit(f"unknown learn command {args.learn_cmd!r}")


def _learn_run(args: argparse.Namespace, cfg: Config, corpus) -> int:
    """One whole learn cycle against the configured local model on
    `--device` (JAX cli.py:1772-1858): learn/loop.LearnLoop with the
    incumbent (the registry's active version, else llm.checkpoint_path)
    as the mining arm, the weakness gate's incumbent and the finetune's
    base. Exit 0 when the candidate is promoted, 1 when it is rejected."""
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import build_builtin_tokenizer
    from k8s_llm_scheduler_tpu_torch.learn import LearnLoop, backend_decide, save_learn_trace
    from k8s_llm_scheduler_tpu_torch.models.configs import get_config
    from k8s_llm_scheduler_tpu_torch.rollout import run_gate

    if cfg.get("llm.backend") != "local":
        print("learn run needs llm.backend: local (finetuning requires the "
              "in-tree model)", file=sys.stderr)
        return 2
    if cfg.get("llm.tokenizer_path"):
        print("learn run finetunes with a builtin tokenizer; unset "
              "llm.tokenizer_path", file=sys.stderr)
        return 2
    registry = _rollout_registry(args, cfg)
    learn_cfg = _learn_config(args, cfg)
    tokenizer_name = cfg.get("llm.tokenizer", "byte")
    # the widened serving config: the fingerprint the registry records
    # must match what restore and hot swap check against
    _tok, model_cfg = build_builtin_tokenizer(
        tokenizer_name, get_config(cfg.get("llm.model", "tiny")))
    _registry, _active, incumbent_ckpt = _learn_active_checkpoint(args, cfg)

    def backend_factory(checkpoint_path):
        return _rollout_backend_factory(cfg, checkpoint_path, args.device)

    def decide_factory(checkpoint_path):
        backend = backend_factory(checkpoint_path)()
        return backend_decide(backend), backend.close

    loop = LearnLoop(
        registry, corpus, learn_cfg,
        mine_arm_factory=lambda: _learn_candidate_arm(cfg, incumbent_ckpt, args.device),
        incumbent_decide_factory=lambda: decide_factory(incumbent_ckpt),
        candidate_decide_factory=decide_factory,
        gate_runner=lambda version: run_gate(
            backend_factory(incumbent_ckpt),
            backend_factory(str(registry.get(version).checkpoint_path)),
            learn_cfg.gate,
        ),
        model_cfg=model_cfg,
        tokenizer_name=tokenizer_name,
        answer_style=cfg.get("llm.answer_style", "direct"),
        mesh_axes=cfg.get("llm.mesh"),
        device=args.device,
    )

    metrics_server = None
    if cfg.get("metrics.enabled"):
        from k8s_llm_scheduler_tpu_torch.observability.metrics import MetricsServer

        metrics_server = MetricsServer(lambda: {"learn": loop.stats()},
                                       port=cfg.get("metrics.port"))
        metrics_server.start()
    try:
        report = loop.run_cycle(args.work_dir, note=args.note)
    finally:
        if metrics_server is not None:
            metrics_server.stop()
    if args.trace:
        save_learn_trace(report, args.trace)
    print(json.dumps({
        "metric": "learn_run",
        "action": report["action"],
        "candidate_version": report["candidate_version"],
        "incumbent_version": report["incumbent_version"],
        "corpus_version": report["corpus_version"],
        "per_class": report["per_class"],
        "weakness_incumbent": report["weakness"]["incumbent"]["score"],
        "weakness_candidate": report["weakness"]["candidate"]["score"],
        "gate_pass": report["gate"]["pass"],
        "train_loss": report["train_loss"],
    }))
    return 0 if report["action"] == "promoted" else 1


def cmd_fleet(args: argparse.Namespace, cfg: Config) -> int:
    """Fleet-scale serving on one host (fleet/; JAX cli.py:2029-2417):

        cli fleet demo    # an in-process sharded fleet over a fake cluster
        cli fleet shard <namespace/name>   # a pod's watch-space shard
        cli fleet top     # merged telemetry of live replica servers
        cli fleet kvplane    # the shared prefix-KV plane's protocol demo
        cli fleet autoscale  # the elastic fleet over a diurnal curve"""
    from k8s_llm_scheduler_tpu_torch.fleet import shard_of

    if args.fleet_cmd == "shard":
        n_shards = (args.n_shards if args.n_shards is not None
                    else int(cfg.get("fleet.n_shards")))
        if "/" in args.pod:
            namespace, name = args.pod.split("/", 1)
        else:
            namespace, name = "default", args.pod
        print(shard_of(namespace, name, n_shards))
        return 0

    if args.fleet_cmd == "demo":
        return _fleet_demo(args, cfg)

    if args.fleet_cmd == "kvplane":
        return _fleet_kvplane(args, cfg)

    if args.fleet_cmd == "autoscale":
        return _fleet_autoscale(args, cfg)

    if args.fleet_cmd == "top":
        return _fleet_top(args, cfg)

    raise SystemExit(f"unknown fleet command {args.fleet_cmd!r}")


def _fleet_demo(args: argparse.Namespace, cfg: Config) -> int:
    """An in-process sharded fleet of stub-backed replicas over a fake
    cluster: shard ownership, decision mix and cache-tier hits."""
    from k8s_llm_scheduler_tpu_torch.engine.backend import StubBackend
    from k8s_llm_scheduler_tpu_torch.fleet import Fleet
    from k8s_llm_scheduler_tpu_torch.testing import pod_burst, synthetic_cluster

    replicas = args.replicas if args.replicas is not None else int(cfg.get("fleet.replicas"))
    scheduler_name = cfg.get("scheduler.name")

    async def demo() -> dict:
        cluster = synthetic_cluster(args.nodes)
        for raw in pod_burst(args.pods, scheduler_name=scheduler_name,
                             distinct_shapes=args.shapes):
            cluster.add_pod(raw)
        store = None
        lease_path = cfg.get("durability.lease_store_path", None)
        if lease_path:
            # the durable lease backend: the same protocol, leases survive
            # a demo restart
            from k8s_llm_scheduler_tpu_torch.fleet import FileLeaseStore

            store = FileLeaseStore(lease_path, n_shards=int(cfg.get("fleet.n_shards")),
                                   ttl_s=float(cfg.get("fleet.lease_ttl_s")))
        kvplane = None
        if cfg.get("fleet.kvplane.enabled"):
            # the shared prefix-KV plane: backends that pin prefixes
            # (LocalLLMBackend) join it through attach_kvplane; the demo's
            # StubBackend pins nothing, so here the plane only shows its
            # gauges — a fleet of real backends deduplicates snapshot
            # prefill through it
            from k8s_llm_scheduler_tpu_torch.fleet.kvplane import KVPlaneStore

            kvplane = KVPlaneStore(
                fill_ttl_s=float(cfg.get("fleet.kvplane.fill_ttl_s")),
                max_entries=int(cfg.get("fleet.kvplane.max_entries")),
            )
        fleet = Fleet(
            cluster, cluster, lambda i: StubBackend(),
            n_replicas=replicas,
            n_shards=int(cfg.get("fleet.n_shards")),
            scheduler_name=scheduler_name,
            lease_ttl_s=float(cfg.get("fleet.lease_ttl_s")),
            renew_interval_s=float(cfg.get("fleet.renew_interval_s")),
            l1_size=int(cfg.get("fleet.l1_size")),
            l2_size=int(cfg.get("fleet.l2_size")),
            list_pending=lambda: cluster.pending_pods(scheduler_name),
            store=store,
            kvplane=kvplane,
        )
        t0 = time.perf_counter()
        await fleet.start()
        deadline = t0 + 60.0
        while time.perf_counter() < deadline:
            if fleet.get_stats()["total_scheduled"] >= args.pods:
                break
            await asyncio.sleep(0.02)
        wall_s = time.perf_counter() - t0
        stats = fleet.get_stats()
        await fleet.stop()
        stats["wall_s"] = round(wall_s, 3)
        stats["decisions_per_s"] = (round(stats["total_scheduled"] / wall_s, 1)
                                    if wall_s else 0.0)
        stats["bind_count"] = cluster.bind_count
        return stats

    stats = asyncio.run(demo())
    if args.json:
        print(json.dumps(stats))
        return 0
    print(f"fleet demo: {replicas} replica(s), {stats['n_shards']} shards, "
          f"{args.pods} pods over {args.nodes} nodes")
    for r in stats["replicas"]:
        print(f"  replica-{r['replica_id']}: shards {r['owned_shards']}  "
              f"bound {r['total_scheduled']}  "
              f"(llm {r['llm_decisions']}, cache {r['cache_decisions']})  "
              f"fenced {r['fenced_binds']}")
    l2 = stats["l2"]
    print(f"  shared L2: {l2['hits']} hits / {l2['misses']} misses "
          f"(generation {l2['generation']})")
    print(f"  {stats['total_scheduled']} bound ({stats['decisions_per_s']}/s), "
          f"{stats['failed_bindings']} failed, {stats['fenced_binds']} fenced; "
          f"cluster bind_count={stats['bind_count']}")
    return 0 if stats["total_scheduled"] >= args.pods else 1


def _fleet_kvplane(args: argparse.Namespace, cfg: Config) -> int:
    """Protocol demo of the shared prefix-KV plane: N replicas (model-free
    StubPinEngines, whose KV is a pure function of the token ids) pin a
    sequence of snapshot prefixes through one KVPlaneStore. Shows the
    election / adopt / publish flow, the generation bump, and the headline:
    the fleet's prefill tokens against what N independent replicas pay."""
    from k8s_llm_scheduler_tpu_torch.fleet.kvplane import (
        KVPlaneClient,
        KVPlaneStore,
        StubPinEngine,
    )

    replicas = args.replicas if args.replicas is not None else int(cfg.get("fleet.replicas"))
    kvstore = KVPlaneStore(
        fill_ttl_s=float(cfg.get("fleet.kvplane.fill_ttl_s")),
        max_entries=int(cfg.get("fleet.kvplane.max_entries")),
    )
    clients = [
        KVPlaneClient(kvstore, StubPinEngine(), replica=f"replica-{i}",
                      wait_checks=int(cfg.get("fleet.kvplane.wait_checks")))
        for i in range(replicas)
    ]
    for s in range(args.snapshots):
        ids = [7000 + s * 101 + j for j in range(args.pin_tokens)]
        for kc in clients:
            kc.pin(ids)
        if args.swap_every and (s + 1) % args.swap_every == 0:
            kvstore.bump_generation()
    fleet_prefill = sum(kc.engine.stats["prefill_tokens"] for kc in clients)
    solo_prefill = replicas * args.snapshots * args.pin_tokens
    out = {
        "replicas": replicas,
        "snapshots": args.snapshots,
        "pin_tokens": args.pin_tokens,
        "store": kvstore.gauges(),
        "clients": {kc.replica: kc.stats() for kc in clients},
        "fleet_prefill_tokens": fleet_prefill,
        "plane_off_prefill_tokens": solo_prefill,
        "dedup_ratio": round(solo_prefill / fleet_prefill, 2) if fleet_prefill else None,
    }
    if args.json:
        print(json.dumps(out))
        return 0
    g = out["store"]
    print(f"kvplane demo: {replicas} replica(s), {args.snapshots} "
          f"snapshot(s) x {args.pin_tokens} tokens")
    print(f"  fills {g['fills']}  adoptions {g['adoptions']}  "
          f"generation {g['generation']}  entries {g['entries']}")
    for kc in clients:
        st = kc.stats()
        print(f"  {kc.replica}: won {st['elections_won']}  "
              f"adopted {st['adoptions']}  "
              f"fallbacks {st['local_fallbacks']}  "
              f"shipped {st['bytes_shipped']}B")
    print(f"  fleet prefill {fleet_prefill} tokens vs {solo_prefill} plane-off "
          f"({out['dedup_ratio']}x dedup)")
    return 0


def _fleet_autoscale(args: argparse.Namespace, cfg: Config) -> int:
    """The elastic fleet over a diurnal arrival curve on a virtual clock:
    the autoscale controller's trajectory, its scale events and the bind
    book. Pods are placed by the chaos harness's HashPlacementBackend, so
    no model runs."""
    from k8s_llm_scheduler_tpu_torch.chaos.harness import HashPlacementBackend, _VirtualClock
    from k8s_llm_scheduler_tpu_torch.cluster.fake import FakeCluster, FakeNode
    from k8s_llm_scheduler_tpu_torch.fleet import Fleet
    from k8s_llm_scheduler_tpu_torch.fleet.autoscale import AutoscaleConfig, AutoscaleController
    from k8s_llm_scheduler_tpu_torch.fleet.lease import shard_of
    from k8s_llm_scheduler_tpu_torch.sim.scenarios import ScenarioSpec, generate_scenario

    # from_dict keeps its unknown-key error for config.yaml typos; demo
    # pacing then overrides the wall-clock cooldowns (the virtual tick is
    # one wave, so the config's second-scale cooldowns would freeze the
    # demo) while keeping their ratio (up fast, down deliberate)
    acfg = dataclasses.replace(
        AutoscaleConfig.from_dict(cfg.section("autoscale")),
        up_cooldown_s=1.0, down_cooldown_s=3.0,
        join_budget_ticks=4, join_backoff_ticks=1,
        split_enabled=False,
    )
    scheduler_name = cfg.get("scheduler.name")
    spec = ScenarioSpec(
        name="autoscale-demo", seed=args.seed,
        n_nodes=args.nodes, n_pods=args.pods, shapes=16,
        arrival="diurnal", n_waves=args.waves,
        hetero=True, constraint_mix=("uniform",),
    )
    scenario = generate_scenario(spec)

    async def demo() -> dict:
        cluster = FakeCluster()
        for n in scenario.nodes:
            cluster.add_node(FakeNode(
                name=n.name, cpu_capacity_cores=n.cpu_cores,
                memory_capacity_gb=n.memory_gb, max_pods=n.max_pods,
                labels=dict(n.labels), taints=n.taints, ready=n.ready,
            ))
        clock = _VirtualClock()
        fleet = Fleet(
            cluster, cluster, lambda i: HashPlacementBackend(),
            n_replicas=acfg.min_replicas,
            n_shards=2 * acfg.max_replicas,
            scheduler_name=scheduler_name,
            lease_ttl_s=6.0, clock=clock, snapshot_ttl_s=1e9,
            list_pending=lambda: cluster.pending_pods(scheduler_name),
        )
        wave_state = {"i": 0, "incoming": 0}
        controller = AutoscaleController(
            fleet, acfg,
            queue_depth_fn=lambda: wave_state["incoming"],
            clock=lambda: wave_state["i"] * 1.0,
        )

        def reoffer() -> list:
            pending = cluster.pending_pods(scheduler_name)
            coros = []
            for replica in fleet.replicas:
                todo = [p for p in pending
                        if replica.manager.owns(shard_of(p.namespace, p.name, fleet.n_shards))]
                coros.extend(replica.scheduler.schedule_pod(p) for p in todo)
            return coros

        trajectory = []
        await fleet.start(lease_threads=False)
        try:
            for wave_idx, wave in enumerate(scenario.waves):
                clock.advance(1.0)
                fleet.tick_leases()
                wave_state["i"] = wave_idx + 1
                wave_state["incoming"] = len(wave)
                record = await controller.tick()
                for pod in wave:
                    cluster.add_pod(pod.to_raw_pod())
                # every demo pod is placeable (uniform constraints), so the
                # wave drains exactly when nothing is pending
                deadline = time.monotonic() + 30.0
                stalls = 0
                while cluster.pending_pods(scheduler_name):
                    if time.monotonic() > deadline:
                        break
                    await asyncio.sleep(0.01)
                    stalls += 1
                    if stalls % 25 == 0:
                        fleet.tick_leases()
                        coros = reoffer()
                        if coros:
                            await asyncio.gather(*coros, return_exceptions=True)
                trajectory.append({
                    "wave": wave_idx,
                    "pods": len(wave),
                    "replicas": fleet.n_live,
                    "pressure": record["pressure"],
                    "action": record["action"],
                })
            stats = fleet.get_stats()
            return {
                "trajectory": trajectory,
                "scale_events": controller.scale_events(),
                "autoscale": controller.stats(),
                # the cluster's bind book is the authority: roster stats
                # lose a drained replica's counts with it
                "bind_count": cluster.bind_count,
                "lease": stats["lease"],
            }
        finally:
            await fleet.stop()

    out = asyncio.run(demo())
    if args.json:
        print(json.dumps(out))
        return 0
    print(f"autoscale demo: {args.pods} pods over a {args.waves}-wave "
          f"diurnal curve, clamp [{acfg.min_replicas}, {acfg.max_replicas}]")
    for t in out["trajectory"]:
        bar = "#" * t["replicas"]
        print(f"  wave {t['wave']:>2}  pods {t['pods']:>4}  "
              f"pressure {t['pressure']:>6.2f}  replicas "
              f"{t['replicas']} {bar:<8} {t['action']}")
    a = out["autoscale"]
    print(f"  {out['bind_count']}/{args.pods} bound exactly once; "
          f"{a['scale_ups']} up(s), {a['scale_downs']} down(s), "
          f"{a['join_failures']} failed join(s)")
    return 0 if out["bind_count"] >= args.pods else 1


def _fleet_top(args: argparse.Namespace, cfg: Config) -> int:
    """Pull every replica server's stats and trace slices over the wire
    and render one fleet-wide view (observability/fleetview.py)."""
    from k8s_llm_scheduler_tpu_torch.observability.fleetview import FleetAggregator, render_top

    addrs = ([a for a in args.replicas.split(",") if a.strip()] if args.replicas
             else list(cfg.get("distributed.replica_addrs") or []))
    if not addrs:
        print("fleet top needs replica addresses (--replicas host:port,... or "
              "distributed.replica_addrs config)", file=sys.stderr)
        return 2
    clients = _replica_clients(cfg, addrs, "--replicas")
    agg = FleetAggregator()
    for client in clients:
        agg.add_replica_client(client.addr, client)
    try:
        while True:
            round_info = agg.pull_all()
            if args.format == "prom":
                print(agg.render_prometheus(), flush=True)
            else:
                print(render_top(agg), flush=True)
            if args.once:
                return 0 if round_info["ok"] else 2
            print()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        for client in clients:
            client.close()


def _debug_get(host: str, port: int, path: str, timeout: float = 5.0) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=timeout) as resp:
        return resp.read().decode()


def _format_span_tree(node: dict, depth: int = 0) -> list[str]:
    dur = node.get("dur_ms")
    dur_txt = f"{dur:.2f}ms" if isinstance(dur, (int, float)) else "open"
    attrs = node.get("attrs") or {}
    attr_txt = " " + " ".join(f"{k}={v}" for k, v in sorted(attrs.items())) if attrs else ""
    status = "" if node.get("status", "ok") == "ok" else " [ERROR]"
    lines = [f"{'  ' * depth}{node['name']}  {dur_txt}{status}{attr_txt}"]
    for child in node.get("children", []):
        lines.extend(_format_span_tree(child, depth + 1))
    return lines


def _export_traces(host: str, port: int) -> list[str]:
    """Every held trace as a JSONL line, following /debug/export's cursor
    (a capped body ends in a {"truncated": true, "next_cursor": N} trailer,
    kept out of the result)."""
    lines: list[str] = []
    since = 0
    while True:
        body = _debug_get(host, port, f"/debug/export?since={since}", timeout=30.0)
        chunk = [ln for ln in body.splitlines() if ln.strip()]
        trailer = None
        if chunk:
            try:
                last = json.loads(chunk[-1])
            except ValueError:
                last = None
            if (isinstance(last, dict) and last.get("truncated") is True
                    and set(last) == {"truncated", "next_cursor"}):
                trailer = last
                chunk = chunk[:-1]
        lines.extend(chunk)
        if trailer is None:
            return lines
        since = int(trailer["next_cursor"])


def cmd_trace(args: argparse.Namespace, cfg: Config) -> int:
    """Query a RUNNING scheduler's decision flight recorder over its metrics
    port (observability/spans.py; /debug/decisions, /debug/trace, /debug/export):

        cli trace list                 # newest decision traces
        cli trace show <trace-id>      # one trace's span tree
        cli trace tail                 # follow new traces as they complete
        cli trace export --out f.jsonl # the ring as JSONL
    """
    import urllib.error

    from k8s_llm_scheduler_tpu_torch.observability.spans import build_span_tree

    host = args.host
    port = args.port if args.port is not None else int(cfg.get("metrics.port"))

    def summarize(entry: dict) -> str:
        meta = entry.get("meta") or {}
        dur = entry.get("dur_ms")
        return (
            f"{entry['trace_id']:<16} {entry['name']:<10} "
            f"{(f'{dur:.1f}ms' if dur is not None else 'open'):>10} "
            f"{meta.get('source', '-'):<9} "
            f"{meta.get('selected_node', '-'):<20} "
            f"{str(meta.get('shard_id', '-')):>5} "
            f"{meta.get('cache_tier', '-'):<9} "
            f"{meta.get('outcome', meta.get('fallback_reason', '-'))}"
        )

    try:
        if args.trace_cmd == "list":
            data = json.loads(_debug_get(host, port, f"/debug/decisions?n={args.n}"))
            print(f"{'trace_id':<16} {'name':<10} {'duration':>10} {'source':<9} "
                  f"{'node':<20} {'shard':>5} {'tier':<9} outcome")
            for entry in data["traces"]:
                print(summarize(entry))
            rec = data["recorder"]
            print(f"-- {rec['held']}/{rec['capacity']} held, "
                  f"{rec['recorded']} recorded total")
            return 0
        if args.trace_cmd == "show":
            try:
                body = _debug_get(host, port, f"/debug/trace/{args.trace_id}")
            except urllib.error.HTTPError as exc:
                if exc.code == 404:
                    print(f"trace {args.trace_id!r} not found (ring may have evicted it)",
                          file=sys.stderr)
                    return 1
                raise
            entry = json.loads(body)
            print(f"trace {entry['trace_id']}  meta={json.dumps(entry.get('meta') or {})}")
            for line in _format_span_tree(build_span_tree(entry["spans"])):
                print(line)
            return 0
        if args.trace_cmd == "tail":
            since = 0
            while True:
                data = json.loads(_debug_get(
                    host, port, f"/debug/decisions?n=1000&since={since}"))
                for entry in data["traces"]:
                    print(summarize(entry), flush=True)
                    since = max(since, entry["seq"])
                time.sleep(args.interval)
        if args.trace_cmd == "export":
            lines = _export_traces(host, port)
            out_body = "".join(line + "\n" for line in lines)
            if args.out:
                with open(args.out, "w", encoding="utf-8") as fh:
                    fh.write(out_body)
                print(f"wrote {len(lines)} trace(s) to {args.out}")
            else:
                sys.stdout.write(out_body)
            return 0
    except KeyboardInterrupt:
        return 0
    except urllib.error.HTTPError as exc:
        # before OSError (HTTPError subclasses it): a server-side 500
        # carries the handler's exception text in its body
        body = exc.read().decode(errors="replace").strip()
        print(f"metrics endpoint at {host}:{port} answered {exc.code}: "
              f"{body or exc.reason}", file=sys.stderr)
        return 2
    except OSError as exc:
        print(f"cannot reach scheduler metrics endpoint at {host}:{port} ({exc}) "
              f"— is it running with metrics.enabled?", file=sys.stderr)
        return 2
    raise SystemExit(f"unknown trace command {args.trace_cmd!r}")


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

    journal = sub.add_parser(
        "journal", help="durable decision journal: fsck/show/compact "
                        "(sched/journal.py; durability.* config block)")
    jsub = journal.add_subparsers(dest="journal_cmd", required=True)
    for name, help_text in (
        ("fsck", "per-segment integrity report + the folded end state"),
        ("show", "dump the record stream as JSONL"),
        ("compact", "fold completed lifecycles into one fresh segment"),
    ):
        p_j = jsub.add_parser(name, help=help_text)
        p_j.add_argument("--dir", default=None,
                         help="journal directory (default: durability.journal_dir)")
        if name == "show":
            p_j.add_argument("--limit", type=int, default=0,
                             help="stop after N records (0 = all)")
    journal.set_defaults(func=cmd_journal)

    p_eval = sub.add_parser(
        "eval", help="decision-quality report: teacher agreement + placement spread")
    p_eval.add_argument("--checkpoint", default=None,
                        help="native or safetensors checkpoint dir "
                             "(default: random-init floor)")
    p_eval.add_argument("--model", default=None, help="config name")
    p_eval.add_argument("--cases", type=int, default=64)
    p_eval.add_argument("--temperature", type=float, default=0.0,
                        help="eval-time sampling temperature (default 0.0 = greedy, the "
                             "deterministic report card; serving keeps llm.temperature)")
    p_eval.add_argument("--placement-pods", type=int, default=32)
    p_eval.add_argument("--scenarios", action="store_true",
                        help="add the per-scenario-class agreement table (heterogeneous "
                             "capacities, taints, selectors, affinity)")
    p_eval.add_argument("--scenario-cases", type=int, default=32)
    device_flag(p_eval)
    p_eval.set_defaults(func=cmd_eval)

    p_train = sub.add_parser(
        "train", help="fine-tune the decision model; save a native checkpoint")
    p_train.add_argument("--out", required=True, help="checkpoint output dir")
    p_train.add_argument("--steps", type=int, default=20)
    p_train.add_argument("--batch-size", type=int, default=4)
    p_train.add_argument("--seq-len", type=int, default=2048)
    p_train.add_argument(
        "--model", default="tiny",
        help="config name (default tiny: bootstrap distillation targets small "
             "configs; pass llm.model sizes deliberately)")
    p_train.add_argument("--lr", type=float, default=3e-4)
    p_train.add_argument("--lr-schedule", default="constant",
                         choices=("constant", "cosine"))
    p_train.add_argument(
        "--name-weight", type=float, default=8.0,
        help="loss upweight on the selected_node value tokens (the one "
             "decision-bearing span of the answer)")
    p_train.add_argument(
        "--cot-weight", type=float, default=1.0,
        help="loss weight on the CoT score tokens (answer_style=cot); the argmax "
             "digit and name always carry --name-weight")
    p_train.add_argument(
        "--micro-frac", type=float, default=0.0,
        help="fraction of batch rows replaced by bare argmax drills "
             "(answer_style=cot; train-only scaffolding)")
    p_train.add_argument(
        "--placement-frac", type=float, default=0.0,
        help="fraction of cases drawn from sequential-placement rollouts (the "
             "fold manifold eval_placement walks; train/distill.py)")
    p_train.add_argument(
        "--diverse-frac", type=float, default=0.0,
        help="fraction of cases drawn from constraint scenarios (hetero SKUs, "
             "taints, selectors, affinity) at train-disjoint seeds")
    p_train.add_argument(
        "--prompt-lm-frac", type=float, default=0.0,
        help="fraction of rows trained with plain full-sequence LM loss "
             "(induction-head pressure from the repetitive prompt text)")
    p_train.add_argument(
        "--probe-every", type=int, default=0,
        help="log greedy held-out teacher agreement every N steps (0=off)")
    p_train.add_argument(
        "--save-every", type=int, default=0,
        help="snapshot the checkpoint every N steps (0=only at the end)")
    p_train.add_argument(
        "--resume", action="store_true",
        help="resume params from --out's latest snapshot if present")
    p_train.add_argument(
        "--seed", type=int, default=0,
        help="init + data-stream seed; vary it on resumed continuations so the "
             "stream does not replay from the start")
    p_train.add_argument(
        "--easy-frac", type=float, default=0.0,
        help="fraction of curriculum (wide-margin) cases mixed into the teacher "
             "stream (train-only; eval never draws from it)")
    p_train.add_argument(
        "--eval", action="store_true",
        help="after training, report teacher agreement + placement quality for "
             "the saved checkpoint")
    p_train.add_argument("--eval-cases", type=int, default=64)
    p_train.add_argument(
        "--registry", default=None,
        help="publish the finished checkpoint into this rollout registry "
             "(default: rollout.registry_dir when configured)")
    p_train.add_argument(
        "--no-publish", action="store_true",
        help="skip registry publication even when a registry is configured")
    device_flag(p_train)
    p_train.set_defaults(func=cmd_train)

    p_sim = sub.add_parser(
        "sim", help="cluster-twin scenario arena: seeded workloads through the "
                    "real stack, scored across decision arms (sim/)")
    p_sim.add_argument("--name", default="scenario")
    p_sim.add_argument("--seed", type=int, default=0)
    p_sim.add_argument("--nodes", type=int, default=16)
    p_sim.add_argument("--pods", type=int, default=64)
    p_sim.add_argument("--shapes", type=int, default=8)
    p_sim.add_argument("--arrival", choices=("burst", "poisson", "waves"), default="burst")
    p_sim.add_argument("--arrival-rate", type=float, default=500.0,
                       help="pods/sec for --arrival poisson")
    p_sim.add_argument("--waves", type=int, default=4, help="wave count for --arrival waves")
    p_sim.add_argument("--homogeneous", action="store_true",
                       help="uniform node SKUs (default: heterogeneous ladder)")
    p_sim.add_argument("--taint-frac", type=float, default=0.0)
    p_sim.add_argument("--constraints", default="uniform",
                       help="comma list of scenario classes cycled over pod shapes "
                            "(train/eval.SCENARIO_CLASSES: uniform, hetero-capacity, "
                            "tainted, selector, affinity)")
    p_sim.add_argument("--churn", action="append", default=None, metavar="WAVE:KIND:NODE",
                       help="node churn applied before WAVE (kind: fail|recover|add|"
                            "delete); repeatable")
    p_sim.add_argument("--arms", default="stub,resource_balanced,least_loaded,round_robin,teacher",
                       help="comma list: llm (configured backend, greedy), stub, teacher, "
                            "or any core/fallback strategy")
    p_sim.add_argument("--trace", default=None, help="record trace here")
    p_sim.add_argument("--replay", default=None,
                       help="verify a recorded trace replays bit-identically, then exit")
    p_sim.add_argument("--out", default=None, help="full JSON report path")
    p_sim.add_argument("--wave-timeout", type=float, default=300.0)
    p_sim.add_argument("--metrics-port", type=int, default=None,
                       help="serve live arena scores on /metrics while running")
    device_flag(p_sim)
    p_sim.set_defaults(func=cmd_sim)

    p_chaos = sub.add_parser(
        "chaos", help="deterministic chaos plane: seeded fault schedules through the "
                      "real stack, invariant-monitored, replayable (chaos/)")
    csub = p_chaos.add_subparsers(dest="chaos_cmd", required=True)
    csub.add_parser("list", help="list regimes")
    p_crun = csub.add_parser("run", help="run one regime (or all) and print the verdict")
    p_crun.add_argument("--regime", default="all",
                        help="regime name (`cli chaos list`) or 'all'")
    p_crun.add_argument("--seed", type=int, default=0)
    p_crun.add_argument("--waves", type=int, default=8)
    p_crun.add_argument("--nodes", type=int, default=12)
    p_crun.add_argument("--pods", type=int, default=None,
                        help="default: 96 (single/wire regimes) or 64 (fleet regimes)")
    p_crun.add_argument("--wave-timeout", type=float, default=30.0)
    p_crun.add_argument(
        "--deadline-ms", type=float, default=2000.0,
        help="per-decision deadline budget riding every frame (<=0 disables; loose "
             "by default — tight wall-clock deadlines would break run-to-run "
             "placement determinism)")
    p_crun.add_argument("--trace", default=None,
                        help="record the (single) regime's replayable trace here")
    p_crun.add_argument("--out", default=None, help="full JSON report path")
    p_creplay = csub.add_parser(
        "replay", help="verify a recorded chaos trace replays byte-identically")
    p_creplay.add_argument("trace", help="trace file from `chaos run --trace`")
    p_chaos.set_defaults(func=cmd_chaos)

    p_rollout = sub.add_parser(
        "rollout", help="live policy rollout: checkpoint registry, canary gate, "
                        "shadow scoring, hot weight swap (rollout/)")
    rsub = p_rollout.add_subparsers(dest="rollout_cmd", required=True)

    def with_registry(p):
        p.add_argument("--registry", default=None,
                       help="registry dir (default: rollout.registry_dir / "
                            "ROLLOUT_REGISTRY_DIR)")
        return p

    p_publish = with_registry(rsub.add_parser(
        "publish", help="register a trained checkpoint as a new version"))
    p_publish.add_argument("--checkpoint", required=True,
                           help="checkpoint dir (models/loader.save_checkpoint's, or "
                                "HF safetensors)")
    p_publish.add_argument("--model", default=None,
                           help="config name the checkpoint is shaped for (default "
                                "llm.model; stamps the fingerprint hot-swap "
                                "compatibility is checked against)")
    p_publish.add_argument("--parent", type=int, default=None)
    p_publish.add_argument("--note", default="")
    with_registry(rsub.add_parser(
        "status", help="list versions, scores, and the active pointer"))
    with_registry(rsub.add_parser(
        "fsck", help="digest-verify every version (exit 1 on any damage)"))
    with_registry(rsub.add_parser(
        "rollback", help="move the active pointer back to its parent"))
    p_promote = with_registry(rsub.add_parser(
        "promote", help="arena-gate a candidate vs the incumbent; set active on pass"))
    p_promote.add_argument("--version", type=int, required=True)
    p_promote.add_argument("--seed", type=int, default=None,
                           help="gate scenario seed (default rollout.gate.seed)")
    p_promote.add_argument("--no-gate", action="store_true",
                           help="skip the arena gate (set active unconditionally)")
    device_flag(p_promote)
    p_watch = with_registry(rsub.add_parser(
        "watch", help="serve the active version and run the live canary loop "
                      "(shadow scoring, gate-promote, burn-in auto-rollback)"))
    p_watch.add_argument("--shadow-frac", type=float, default=None,
                         help="fraction of live decisions mirrored through the newest "
                              "candidate (default rollout.shadow_fraction)")
    p_watch.add_argument("--fake-cluster", action="store_true")
    p_watch.add_argument("--fake-nodes", type=int, default=3)
    device_flag(p_watch)
    p_rollout.set_defaults(func=cmd_rollout)

    p_learn = sub.add_parser(
        "learn", help="closed policy-improvement loop (learn/): mine loss incidents, "
                      "build finetune curricula, run the whole "
                      "mine->finetune->gate->promote cycle")
    lsub = p_learn.add_subparsers(dest="learn_cmd", required=True)

    def with_corpus(p):
        p.add_argument("--corpus", default=None,
                       help="incident corpus dir (default: learn.corpus_dir / "
                            "LEARN_CORPUS_DIR)")
        return p

    p_lmine = with_registry(with_corpus(lsub.add_parser(
        "mine", help="run the serving policy vs the teacher over seeded arena "
                     "scenarios and write a new incident-corpus version")))
    p_lmine.add_argument("--seeds", default=None,
                         help="comma-separated mining scenario seeds (default: "
                              "learn.mine_seeds)")
    p_lmine.add_argument("--note", default="")
    device_flag(p_lmine)
    p_lbuild = with_corpus(lsub.add_parser(
        "build", help="reconstruct a corpus version into curriculum cases and print "
                      "the batch mix (dry-run of the finetune input)"))
    p_lbuild.add_argument("--version", type=int, default=None)
    p_lbuild.add_argument("--replay-fraction", type=float, default=None)
    p_lrun = with_registry(with_corpus(lsub.add_parser(
        "run", help="one whole learn cycle: mine -> finetune -> publish -> two-sided "
                    "gate -> promote (exit 1 when rejected)")))
    p_lrun.add_argument("--seed", type=int, default=0)
    p_lrun.add_argument("--seeds", default=None,
                        help="mining scenario seeds (default learn.mine_seeds)")
    p_lrun.add_argument("--steps", type=int, default=None)
    p_lrun.add_argument("--replay-fraction", type=float, default=None)
    p_lrun.add_argument("--work-dir", default="learn-work",
                        help="cycle working dir (the candidate checkpoint lands here "
                             "before publish)")
    p_lrun.add_argument("--trace", default=None,
                        help="record the cycle's byte-replayable learn trace here")
    p_lrun.add_argument("--note", default="")
    device_flag(p_lrun)
    with_registry(with_corpus(lsub.add_parser(
        "status", help="corpus versions, per-class counts, lineage")))
    p_lreplay = lsub.add_parser(
        "replay", help="verify a recorded learn trace replays byte-identically")
    p_lreplay.add_argument("trace", help="trace file from `learn run --trace`")
    p_learn.set_defaults(func=cmd_learn)

    p_fleet = sub.add_parser(
        "fleet", help="fleet-scale serving (fleet/): sharded-replica demo, shard "
                      "mapping, merged replica telemetry, the shared prefix-KV "
                      "plane demo, the elastic-fleet demo")
    fsub = p_fleet.add_subparsers(dest="fleet_cmd", required=True)
    p_fdemo = fsub.add_parser(
        "demo", help="run an in-process sharded fleet over a fake cluster and print "
                     "shard ownership, decision mix, and tier hits")
    p_fdemo.add_argument("--replicas", type=int, default=None,
                         help="scheduler replicas (default: fleet.replicas config)")
    p_fdemo.add_argument("--pods", type=int, default=200)
    p_fdemo.add_argument("--nodes", type=int, default=12)
    p_fdemo.add_argument("--shapes", type=int, default=16,
                         help="distinct pod resource shapes (cache-coherence groups)")
    p_fdemo.add_argument("--json", action="store_true")
    p_fkv = fsub.add_parser(
        "kvplane", help="shared prefix-KV plane demo (fleet/kvplane/): N replicas pin "
                        "snapshot prefixes through one store — the fill-once / "
                        "adopt-everywhere flow and the prefill dedup ratio")
    p_fkv.add_argument("--replicas", type=int, default=None,
                       help="plane clients (default: fleet.replicas config)")
    p_fkv.add_argument("--snapshots", type=int, default=4,
                       help="distinct snapshot prefixes pinned in sequence")
    p_fkv.add_argument("--pin-tokens", type=int, default=512,
                       help="tokens per snapshot prefix")
    p_fkv.add_argument("--swap-every", type=int, default=0,
                       help="bump the plane generation every N snapshots (0 = never) "
                            "— the hot-swap invalidation path")
    p_fkv.add_argument("--json", action="store_true")
    p_fshard = fsub.add_parser("shard", help="print a pod's watch-space shard id")
    p_fshard.add_argument("pod", help="namespace/name (bare name = default namespace)")
    p_fshard.add_argument("--n-shards", type=int, default=None,
                          help="shard count (default: fleet.n_shards config)")
    p_fauto = fsub.add_parser(
        "autoscale", help="elastic-fleet demo: a seeded diurnal arrival curve through "
                          "the autoscale controller (fleet/autoscale.py) over a fake "
                          "cluster; prints the replica trajectory and scale events")
    p_fauto.add_argument("--pods", type=int, default=240)
    p_fauto.add_argument("--nodes", type=int, default=24)
    p_fauto.add_argument("--waves", type=int, default=12,
                         help="diurnal curve length in waves (one controller tick each)")
    p_fauto.add_argument("--seed", type=int, default=0)
    p_fauto.add_argument("--json", action="store_true")
    p_ftop = fsub.add_parser(
        "top", help="live merged fleet telemetry: pull every replica's stats and trace "
                    "slices over the wire and render one fleet-wide view")
    p_ftop.add_argument("--replicas", default=None,
                        help="comma-separated replica addrs host:port (default: "
                             "distributed.replica_addrs config)")
    p_ftop.add_argument("--interval", type=float, default=2.0,
                        help="refresh period in seconds")
    p_ftop.add_argument("--once", action="store_true",
                        help="render one frame and exit (scripting/tests)")
    p_ftop.add_argument("--format", choices=("text", "prom"), default="text",
                        help="text frame or one merged Prometheus exposition")
    p_fleet.set_defaults(func=cmd_fleet)

    trace = sub.add_parser(
        "trace", help="decision flight recorder: list/show/tail/export traces from "
                      "a running scheduler's /debug endpoints")
    tsub = trace.add_subparsers(dest="trace_cmd", required=True)

    def endpoint(p):
        p.add_argument("--host", default="127.0.0.1")
        p.add_argument("--port", type=int, default=None,
                       help="metrics port (default: metrics.port)")
        return p

    endpoint(tsub.add_parser("list", help="newest decision traces")).add_argument(
        "-n", type=int, default=20)
    endpoint(tsub.add_parser("show", help="one trace's span tree")).add_argument("trace_id")
    endpoint(tsub.add_parser(
        "tail", help="follow new traces as they complete (Ctrl-C to stop)")).add_argument(
        "--interval", type=float, default=1.0)
    endpoint(tsub.add_parser("export", help="the ring as JSONL")).add_argument(
        "--out", default=None, help="file (default stdout)")
    trace.set_defaults(func=cmd_trace)
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
