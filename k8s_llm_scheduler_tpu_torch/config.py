"""Layered configuration: env var > config.yaml > hardcoded default.

A copy of the JAX package's config.py (its DEFAULTS, ENV_OVERRIDES,
Config, _coerce, _deep_merge and load_config), with one change: PyYAML is
imported only when a config file is read, so the port imports without it
and a process with no config file runs on the defaults. A config file that
is present while PyYAML is missing raises an error naming the file; it is
never skipped.

Behavioral parity with the reference's config system (reference
scheduler.py:46-66): YAML loaded once, env vars override YAML, hardcoded
defaults under both (scheduler.py:55-60). The reference's env names
(SCHEDULER_NAME, LLM_MODEL, LLM_TIMEOUT, MAX_RETRIES — scheduler.py:56-60)
keep working.

The keys are the JAX package's, all of them, so one config file serves
both packages. The port's `cli run` honours the keys of the paths it has
and refuses the switches of paths it has not ported yet (cli.py,
`UNPORTED_SWITCHES`); `llm.compile_cache_dir` names JAX's compile cache
and has no counterpart here.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from pathlib import Path
from typing import Any

_MISSING = object()


DEFAULTS: dict[str, Any] = {
    "scheduler": {
        "name": "ai-llama-scheduler",
        "namespace": "kube-system",
        "watch_interval": 60,  # watch re-list timeout seconds (live, unlike ref)
        "error_backoff_seconds": 5.0,  # scheduler.py:685
        # advisory prefix-prewarm tick (0 disables): while idle, keep the
        # engine's cluster-state prefix KV pointed at the live snapshot so
        # the next burst's first wave skips the prefix prefill
        "prefix_prewarm_seconds": 0.25,
        # Deadline-budgeted degradation (sched/deadline.py): every
        # decision gets this much budget; the ladder LLM -> cached ->
        # heuristic sheds to a fast answer when the remaining budget
        # can no longer afford the model rung. null = no deadline.
        "decision_deadline_ms": None,
        # below this remaining budget the LLM rung is unaffordable
        "llm_min_budget_ms": 25.0,
    },
    "llm": {
        "model": "llama-3.2-1b-instruct",
        "backend": "local",  # local | stub
        "timeout": 60,
        "max_retries": 3,
        "retry_delay": 1.0,  # base of exponential backoff (live, unlike ref)
        "temperature": 0.3,  # config.yaml:13
        "max_tokens": 200,  # config.yaml:14
        "constrained_json": True,
        # --- TPU engine geometry (north star: mesh/sharding/max_batch) ---
        "mesh": {"dp": 1, "tp": 1},
        "sharding": "tensor_parallel",
        "max_batch": 8,
        "page_size": 128,
        "max_pages_per_seq": 64,
        "prefill_buckets": [256, 512, 1024, 2048, 4096, 8192],
        "checkpoint_path": None,
        "quantization": None,  # None | "int8" (weight-only, models/quant.py)
        "tokenizer_path": None,
        # builtin tokenizer when no tokenizer_path is set: "byte"
        # (hermetic default) or "numeric" (byte + single-token integers —
        # the distillation-grade vocab; engine/tokenizer.py)
        "tokenizer": "byte",
        # block-decode matmul impl: "dense" (XLA einsums) or "ragged"
        # (ops/ragged_matmul.py — skips DFA-decided F-width padding;
        # single-device only: a tp>1 mesh REJECTS it at build time,
        # use "dense" for tensor-parallel serving)
        "decode_matmul": "dense",
        # decision JSON field order: "direct" (reference order) or "cot"
        # (reasoning before the constrained node choice — the parsed
        # object is identical; engine/constrained.py)
        "answer_style": "direct",
        # token budget for the reasoning field (the decision DFA's free-
        # text bound; still capped by what fits in llm.max_tokens — the
        # effective budget is min(this, llm.max_tokens - 62 - name)). The
        # scratchpad CoT with input echoes (train/distill.build_cot)
        # measures <=245 tokens for 5 feasible nodes under the numeric
        # tokenizer, <=290 under byte; 320 covers both. Serving a CoT
        # checkpoint needs llm.max_tokens >= 62 + name + this (e.g. 390).
        "max_reason_tokens": 320,
        # fairness bound for (prefix, grammar) group switches under load
        # (engine/local.py _submit_waves)
        "group_switch_after_s": 0.25,
        # --- speculative decoding (spec/decoder.py; general-completion
        # paged path only — decision waves are already grammar-accelerated
        # and never speculate) ---
        "spec_enabled": False,
        # "draft" (two-model async pipeline) or "hidden" (draft-free
        # hidden-transfer heads over the target's own hidden states —
        # spec/hidden.py; no second model resident)
        "spec_arm": "draft",
        # draft model: a config name (models/configs.py) random-initialized,
        # or serve the distilled checkpoint via spec_draft_checkpoint
        # (train/distill.py output — the intended production draft; for
        # spec_arm=hidden it names a train/hidden.py head checkpoint)
        "spec_draft_model": "tiny",
        "spec_draft_checkpoint": None,
        "spec_k": 4,  # draft tokens proposed per round
        # acceptance-rate EWMA floor: below it speculation auto-disables
        # for the request and the slot hands back to the FUSED decode path
        "spec_disable_threshold": 0.3,
        # persistent XLA compile cache dir ("auto" = ~/.cache/...; null
        # disables) — utils/compile_cache.py
        "compile_cache_dir": "auto",
        # --- fused on-device decode runtime (engine/fused/): the paged
        # decode loop as ONE lax.while_loop program with early exit —
        # host syncs once per harvest chunk, never per token. Falls back
        # to the sparse chunked path by itself when a grammar can't
        # export a dense table (size cap); open speculative rounds
        # COEXIST with it (each spec stream owns only its slot). ---
        "fused_decode": True,
        # top-k sampling cut applied INSIDE the fused loop (0 = full
        # distribution; greedy decode is unaffected by construction)
        "top_k": 0,
        # --- persistent device-resident serving loop (engine/persistent/):
        # ONE long-lived program subsumes admission prefill + fused decode
        # micro-chunks; steady-state decisions pay zero XLA dispatches.
        # Off by default until the truth round lands it as the default
        # serving mode. ---
        "persistent_loop": False,
        # admission suffix bucket of the resident loop's fixed-shape
        # ADMIT (None = smallest prefill bucket; must be a page-size
        # multiple — suffixes past it fall back to the dispatch path)
        "persistent_suffix_bucket": None,
    },
    # Delta-prefill admission plane (engine/admission/ + sched/delta.py):
    # packed chunked admission for batch surfaces, and snapshot-delta
    # prompt encoding over pinned prefix KV so prefill cost scales with
    # what changed since the pinned snapshot, not cluster size.
    "admission": {
        # route decide_batch admission through packed block-diagonal
        # chunked prefill (engine.admit_packed) instead of wave rows
        "packed": True,
        # fixed token width of one packed prefill chunk; in-flight decode
        # piggybacks between chunks (SARATHI)
        "chunk_tokens": 256,
        # render cluster prefixes as pinned snapshot + drift diff
        # (sched/delta.SnapshotDeltaEncoder); False = whole-prompt render
        "delta_prompts": True,
        # re-pin when more than this fraction of nodes drifted (the delta
        # section is approaching the cost of a fresh render)
        "repin_fraction": 0.25,
        # pinned snapshot prefixes kept resident engine-side (eviction-
        # exempt; LRU beyond this)
        "max_pins": 4,
    },
    "cache": {
        "enabled": True,
        "ttl_seconds": 300,  # config.yaml:19
        "max_size": 100,  # config.yaml:20
    },
    "logging": {
        "level": "INFO",
        "format": "text",  # text | json
        "file": None,
    },
    "metrics": {
        "enabled": False,
        "port": 9090,  # config.yaml:31 — made real by observability/metrics.py
    },
    # Decision flight recorder + engine telemetry (observability/spans.py,
    # observability/sampler.py). Tracing is cheap (<2% of decision p50,
    # bench.py --preset obs-overhead) and on by default; the sampler rides
    # the metrics server and only runs when metrics are enabled.
    "observability": {
        "tracing": True,
        # complete decision traces held in the ring (/debug/decisions,
        # cli trace); one trace is ~a few KB
        "flight_recorder_size": 256,
        # engine telemetry sampling period + ring length (per series)
        "sampler_interval_s": 1.0,
        "sampler_window": 600,
        # continuous wave profiler (observability/profiler.py): per-wave
        # dispatch/sync segment fencing + MFU loss decomposition, served
        # at /debug/profile. Per-wave cost is a handful of perf_counter
        # reads (bench.py --preset obs-overhead re-measures the budget).
        "profiler": True,
        "profiler_window": 256,
    },
    # SLO burn-rate engine (observability/slo.py): declarative objectives
    # evaluated over multi-window (fast 5m / slow 1h) burn rates from the
    # windowed histogram deltas. Trips surface at /debug/slo, as
    # llm_scheduler_slo_* gauges, as a canary burn-in rollback input, and
    # as a circuit-breaker ADVISORY. Disabled by default; see config.yaml
    # for objective examples.
    "slo": {
        "enabled": False,
        "fast_window_s": 300.0,
        "slow_window_s": 3600.0,
        "interval_s": 10.0,
        # each: {name, kind: latency|error_rate|throughput, ...} —
        # observability/slo.SloObjective fields
        "objectives": [],
        # burn-rate brownout: an SLO trip puts the decision client into
        # brownout (sched/client.py — the LLM rung sheds to the heuristic
        # ladder floor) until the burn clears. Requires slo.enabled.
        "brownout": True,
    },
    "fallback": {
        "enabled": True,
        "strategy": "resource_balanced",  # config.yaml:36
    },
    "circuit_breaker": {
        "enabled": True,
        "failure_threshold": 5,  # config.yaml:41
        "timeout": 60,  # config.yaml:42
        "half_open_max_calls": 1,
        # OPEN->HALF_OPEN cooldown jitter fraction: each trip draws its
        # cooldown from [timeout, timeout*(1+jitter)] so N fleet replicas
        # that tripped on one dying backend don't all probe at the same
        # instant when the shared cooldown elapses (thundering-herd
        # half-open). 0 disables.
        "cooldown_jitter": 0.1,
    },
    # Live policy rollout (rollout/): checkpoint registry + shadow scoring
    # + canary gate + zero-downtime hot weight swap. registry_dir null
    # disables the whole subsystem.
    "rollout": {
        "registry_dir": None,
        # fraction of live schedule_pod decisions mirrored (non-binding)
        # through the newest candidate (rollout/shadow.py); 0 disables
        "shadow_fraction": 0.0,
        # weight-swap residency: "auto" double-buffers when 2x params fit
        # in HBM, else donates in place (rollout/hotswap.py)
        "swap_mode": "auto",
        # keep-last retention after each publish/promote (0 = keep all);
        # the active version and its rollback parent are always kept
        "retain": 0,
        # seeded arena gate (rollout/canary.GateConfig)
        "gate": {
            "seed": 0,
            "nodes": 12,
            "pods": 48,
            "shapes": 8,
            "waves": 2,
            "spread_tolerance": 0.02,
            "constraint_tolerance": 0.0,
            "bound_tolerance": 0.0,
        },
        # live burn-in after a promotion: window size in decisions, and
        # the regression rates that trip an auto-rollback
        "burn_in_decisions": 200,
        "trip_fallback_rate": 0.2,
        "trip_invalid_rate": 0.05,
        "trip_bind_failure_rate": 0.05,
        # decide-latency p99 budget (ms) over the burn-in window, derived
        # from PhaseRecorder histogram deltas; null disables the trip.
        # Bucket-quantized conservatively: rollback fires only when the
        # window p99's bucket LOWER bound exceeds this, so a healthy
        # candidate sharing a 2x bucket with the budget never trips
        "trip_decide_p99_ms": None,
        # registry poll period for `cli rollout watch`
        "poll_seconds": 5.0,
    },
    # Closed policy-improvement loop (learn/): mine arena/chaos losses
    # into a versioned incident corpus, finetune the decision model on
    # them (mixed with base-distribution replay), publish to the rollout
    # registry, and canary-promote. corpus_dir null disables the
    # subsystem; the registry comes from rollout.registry_dir.
    "learn": {
        "corpus_dir": None,
        # fraction of finetune rows drawn from the BASE training
        # distribution instead of mined incidents (the anti-catastrophic-
        # forgetting knob; 1.0 = pure replay, 0.0 = pure incidents)
        "replay_fraction": 0.3,
        "steps": 200,
        "batch_size": 4,
        "seq_len": 1024,
        "lr": 3e-4,
        # one mining arena scenario per seed
        "mine_seeds": [0, 1],
        "mine_nodes": 8,
        "mine_pods": 48,
        "mine_waves": 3,
        # per-wave spread margin the reference must win by before a
        # divergent pod counts as a loss incident
        "spread_margin": 0.005,
        # weakness gate: cases evaluated, and how much the candidate must
        # beat the incumbent by (strictly) on them
        "weakness_cases": 32,
        "weakness_margin": 0.0,
        # registry keep-last retention after a cycle (0 = keep all); the
        # retention walk always receives the loop's pinned set (open
        # candidate + incident-corpus lineage)
        "retain": 0,
    },
    # Fleet-scale serving (fleet/): leased watch-space sharding, tiered
    # decision cache, disaggregated prefill/decode pools. `replicas`/
    # `n_shards` size the sharded frontend; lease TTL + renew interval
    # follow the classic rule (renew at most every ttl/3).
    "fleet": {
        "enabled": False,
        "replicas": 1,
        "n_shards": 16,
        "lease_ttl_s": 5.0,
        "renew_interval_s": 1.5,
        # tiered decision cache (fleet/cache.py): private-L1 entries per
        # replica, shared generation-stamped L2 entries fleet-wide
        "l1_size": 256,
        "l2_size": 4096,
        # disaggregated pools (fleet/pools.py): replica addrs
        # ("host:port") per role; both empty = no disaggregation (all
        # work on the local/mixed backend)
        "prefill_addrs": [],
        "decode_addrs": [],
        # prepacked admission: batch up to this many same-snapshot
        # decisions into one decide_batch frame, flushing after the
        # window elapses
        "prepack_max_batch": 16,
        "prepack_window_ms": 2.0,
        # shared prefix-KV plane (fleet/kvplane/): one replica's
        # snapshot prefill serves the fleet. transport "host" ships
        # numpy pages (cross-process shape); "d2d" hands device arrays
        # across replicas sharing one mesh. fill_ttl_s bounds how long
        # a dead filler's lease blocks peers (they degrade to local
        # prefill meanwhile, never wait); wait_checks is how many times
        # an election loser re-polls for the filler's publish before
        # prefilling locally.
        "kvplane": {
            "enabled": False,
            "transport": "host",
            "fill_ttl_s": 5.0,
            "max_entries": 8,
            "wait_checks": 2,
        },
    },
    # Elastic fleet autoscaler (fleet/autoscale.py): SLO-burn-driven
    # deadband control loop over replica count + prefill/decode pool
    # split. Thrash-proofing knobs: hysteresis band
    # [down_threshold, up_threshold] with target_utilization strictly
    # inside it, per-direction cooldowns, max_step clamp, and the
    # [min, max] replica clamp the chaos invariant monitor re-checks.
    "autoscale": {
        "enabled": False,
        "min_replicas": 1,
        "max_replicas": 8,
        # work units (queued decisions per tick) one replica serves at
        # target utilization — the demand normalizer
        "target_per_replica": 8.0,
        "target_utilization": 0.75,
        "up_threshold": 1.0,
        "down_threshold": 0.5,
        "max_step": 2,
        "up_cooldown_s": 30.0,
        "down_cooldown_s": 120.0,
        # scale-up health gate: ticks a join may wait for its first
        # lease claim before rollback, backoff between attempts, and
        # the bounded retry budget
        "join_budget_ticks": 8,
        "join_backoff_ticks": 4,
        "max_join_retries": 3,
        # optional decide-p99 pressure term (merged fleet buckets); null
        # disables it
        "latency_target_ms": None,
        # profiler queue_stall fraction above which admission counts as
        # starved (the SARATHI-style pressure signal)
        "stall_budget": 0.25,
        # prefill<->decode pool split rebalancing
        "split_enabled": True,
        "split_cooldown_s": 60.0,
        # controller tick cadence (live deployments; harness/bench tick
        # in virtual wave time)
        "tick_interval_s": 5.0,
    },
    # Durable decision journal & crash-restart recovery (sched/journal.py,
    # sched/recovery.py): an fsync'd write-ahead journal of the
    # decide -> bind-intent -> bind-ack lifecycle plus the informer's
    # watch position, replayed on start to reconcile open binds against
    # the cluster WITHOUT re-deciding and to resume the watch from the
    # journaled resourceVersion. Off by default: a journal-less replica
    # is still exactly-once (the apiserver's 409 is the backstop) — the
    # journal buys not-re-deciding, breaker continuity, and watch
    # continuity across process death.
    "durability": {
        "enabled": False,
        "journal_dir": None,
        # "intent" fsyncs the bind-intent record (the write-ahead
        # property binds need; ~0.7ms each) and flushes the rest;
        # "always" fsyncs every record; "none" flushes only
        "fsync": "intent",
        # active-segment compaction threshold (journal rotation folds
        # completed lifecycles away via write-aside + os.replace)
        "segment_max_records": 4096,
        # file-backed durable lease store (fleet/lease.FileLeaseStore)
        # for fleet surfaces (`cli fleet demo`); null keeps the
        # in-memory store. Production fleets map leases to k8s Lease
        # objects instead.
        "lease_store_path": None,
    },
    # Multi-host JAX (parallel/distributed.py). On TPU pods the launcher
    # auto-detects coordinator/count/id (leave them null); set them
    # explicitly for manual/CPU launches. The control plane (watch/bind)
    # runs only on process 0 — see SCALING.md "Multi-host".
    "router": {
        # Per-decision routing (sched/router.py) between the sharded big
        # arm (the llm block's model/mesh) and a distilled fast arm.
        "enabled": False,
        # Fast-arm serving config + checkpoint (train/distill.py output;
        # router.distill_fast_checkpoint publishes via the rollout
        # registry). No checkpoint = random-init fast arm (tests only).
        "fast_model": "tiny",
        "fast_checkpoint": None,
        "fast_tokenizer": "numeric",
        # Routing thresholds (sched/router.RouterPolicy).
        "big_min_budget_ms": 120.0,
        "big_cold_extra_ms": 250.0,
        "complexity_threshold": 2,
        "prewarm_on_cold": True,
    },
    "distributed": {
        "enabled": False,
        "coordinator": None,  # e.g. "10.0.0.2:8476"
        "num_processes": None,
        "process_id": None,
        # Cross-host decision serving (sched/replica.py): worker processes
        # serve their replica backend on replica_port; the coordinator
        # fans leader decisions out over replica_addrs ("host:port", one
        # per worker). Empty addrs = coordinator serves alone.
        "replica_port": 9901,
        "replica_addrs": [],
        # Replica RPC is unauthenticated (trusted-network protocol):
        # default bind is loopback; multi-host deployments set this to the
        # worker's pod/host IP (or "0.0.0.0" on a trusted network).
        "replica_bind_host": "localhost",
        # Bound on concurrently-executing requests per worker (a remote
        # peer must not be able to spawn unbounded threads).
        "replica_max_inflight": 64,
    },
}

# Env var name -> dotted config path (reference scheduler.py:56-60 names kept).
ENV_OVERRIDES: dict[str, str] = {
    "SCHEDULER_NAME": "scheduler.name",
    "SCHEDULER_NAMESPACE": "scheduler.namespace",
    "SCHEDULER_PREFIX_PREWARM_SECONDS": "scheduler.prefix_prewarm_seconds",
    "LLM_MODEL": "llm.model",
    "LLM_BACKEND": "llm.backend",
    "LLM_TIMEOUT": "llm.timeout",
    "LLM_MAX_BATCH": "llm.max_batch",
    "LLM_CHECKPOINT_PATH": "llm.checkpoint_path",
    "LLM_TOKENIZER": "llm.tokenizer",
    "LLM_ANSWER_STYLE": "llm.answer_style",
    "LLM_MAX_REASON_TOKENS": "llm.max_reason_tokens",
    "LLM_MAX_TOKENS": "llm.max_tokens",
    "LLM_TEMPERATURE": "llm.temperature",
    "SPEC_ENABLED": "llm.spec_enabled",
    "SPEC_ARM": "llm.spec_arm",
    "FUSED_DECODE": "llm.fused_decode",
    "LLM_TOP_K": "llm.top_k",
    "PERSISTENT_LOOP": "llm.persistent_loop",
    "SPEC_K": "llm.spec_k",
    "SPEC_DRAFT_MODEL": "llm.spec_draft_model",
    "SPEC_DRAFT_CHECKPOINT": "llm.spec_draft_checkpoint",
    "SPEC_DISABLE_THRESHOLD": "llm.spec_disable_threshold",
    "MAX_RETRIES": "llm.max_retries",
    "ADMISSION_PACKED": "admission.packed",
    "ADMISSION_CHUNK_TOKENS": "admission.chunk_tokens",
    "ADMISSION_DELTA_PROMPTS": "admission.delta_prompts",
    "ADMISSION_REPIN_FRACTION": "admission.repin_fraction",
    "ADMISSION_MAX_PINS": "admission.max_pins",
    "CACHE_ENABLED": "cache.enabled",
    "CACHE_TTL": "cache.ttl_seconds",
    "CACHE_MAX_SIZE": "cache.max_size",
    "LOG_LEVEL": "logging.level",
    "LOG_FORMAT": "logging.format",
    "METRICS_ENABLED": "metrics.enabled",
    "METRICS_PORT": "metrics.port",
    "OBS_TRACING": "observability.tracing",
    "OBS_FLIGHT_RECORDER_SIZE": "observability.flight_recorder_size",
    "OBS_SAMPLER_INTERVAL_S": "observability.sampler_interval_s",
    "OBS_SAMPLER_WINDOW": "observability.sampler_window",
    "OBS_PROFILER": "observability.profiler",
    "OBS_PROFILER_WINDOW": "observability.profiler_window",
    "SLO_ENABLED": "slo.enabled",
    "SLO_FAST_WINDOW_S": "slo.fast_window_s",
    "SLO_SLOW_WINDOW_S": "slo.slow_window_s",
    "SLO_INTERVAL_S": "slo.interval_s",
    "SLO_BROWNOUT": "slo.brownout",
    "SCHED_DECISION_DEADLINE_MS": "scheduler.decision_deadline_ms",
    "SCHED_LLM_MIN_BUDGET_MS": "scheduler.llm_min_budget_ms",
    "BREAKER_COOLDOWN_JITTER": "circuit_breaker.cooldown_jitter",
    "FALLBACK_STRATEGY": "fallback.strategy",
    "FLEET_ENABLED": "fleet.enabled",
    "FLEET_REPLICAS": "fleet.replicas",
    "FLEET_N_SHARDS": "fleet.n_shards",
    "FLEET_LEASE_TTL_S": "fleet.lease_ttl_s",
    "FLEET_RENEW_INTERVAL_S": "fleet.renew_interval_s",
    "FLEET_L1_SIZE": "fleet.l1_size",
    "FLEET_L2_SIZE": "fleet.l2_size",
    "FLEET_PREPACK_MAX_BATCH": "fleet.prepack_max_batch",
    "FLEET_PREPACK_WINDOW_MS": "fleet.prepack_window_ms",
    "FLEET_PREFILL_ADDRS": "fleet.prefill_addrs",
    "FLEET_DECODE_ADDRS": "fleet.decode_addrs",
    "FLEET_KVPLANE_ENABLED": "fleet.kvplane.enabled",
    "FLEET_KVPLANE_TRANSPORT": "fleet.kvplane.transport",
    "FLEET_KVPLANE_FILL_TTL_S": "fleet.kvplane.fill_ttl_s",
    "FLEET_KVPLANE_MAX_ENTRIES": "fleet.kvplane.max_entries",
    "FLEET_KVPLANE_WAIT_CHECKS": "fleet.kvplane.wait_checks",
    "ROUTER_ENABLED": "router.enabled",
    "ROUTER_FAST_MODEL": "router.fast_model",
    "ROUTER_FAST_CHECKPOINT": "router.fast_checkpoint",
    "ROUTER_BIG_MIN_BUDGET_MS": "router.big_min_budget_ms",
    "ROUTER_COMPLEXITY_THRESHOLD": "router.complexity_threshold",
    "AUTOSCALE_ENABLED": "autoscale.enabled",
    "AUTOSCALE_MIN_REPLICAS": "autoscale.min_replicas",
    "AUTOSCALE_MAX_REPLICAS": "autoscale.max_replicas",
    "AUTOSCALE_TARGET_PER_REPLICA": "autoscale.target_per_replica",
    "AUTOSCALE_MAX_STEP": "autoscale.max_step",
    "AUTOSCALE_UP_COOLDOWN_S": "autoscale.up_cooldown_s",
    "AUTOSCALE_DOWN_COOLDOWN_S": "autoscale.down_cooldown_s",
    "AUTOSCALE_TICK_INTERVAL_S": "autoscale.tick_interval_s",
    "DURABILITY_ENABLED": "durability.enabled",
    "DURABILITY_JOURNAL_DIR": "durability.journal_dir",
    "DURABILITY_FSYNC": "durability.fsync",
    "DURABILITY_SEGMENT_MAX_RECORDS": "durability.segment_max_records",
    "DURABILITY_LEASE_STORE_PATH": "durability.lease_store_path",
    "LEARN_CORPUS_DIR": "learn.corpus_dir",
    "LEARN_REPLAY_FRACTION": "learn.replay_fraction",
    "LEARN_STEPS": "learn.steps",
    "LEARN_MINE_SEEDS": "learn.mine_seeds",
    "LEARN_WEAKNESS_MARGIN": "learn.weakness_margin",
    "ROLLOUT_REGISTRY_DIR": "rollout.registry_dir",
    "ROLLOUT_SHADOW_FRACTION": "rollout.shadow_fraction",
    "ROLLOUT_SWAP_MODE": "rollout.swap_mode",
    "ROLLOUT_BURN_IN_DECISIONS": "rollout.burn_in_decisions",
}


def _coerce(value: str, template: Any) -> Any:
    """Coerce an env string to the type of the default it overrides."""
    if isinstance(template, bool):
        return value.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(template, int):
        return int(value)
    if isinstance(template, float):
        return float(value)
    if isinstance(template, list):
        # comma-separated ("host:9901,host:9902"); empty string = []
        return [part for part in
                (piece.strip() for piece in value.split(",")) if part]
    return value


def _deep_merge(base: dict[str, Any], override: dict[str, Any]) -> dict[str, Any]:
    merged = dict(base)
    for key, val in override.items():
        if isinstance(val, dict) and isinstance(merged.get(key), dict):
            merged[key] = _deep_merge(merged[key], val)
        else:
            merged[key] = val
    return merged


@dataclasses.dataclass
class Config:
    """Resolved configuration tree with dotted-path access."""

    data: dict[str, Any]

    def get(self, path: str, default: Any = _MISSING) -> Any:
        node: Any = self.data
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                if default is _MISSING:
                    raise KeyError(path)
                return default
            node = node[part]
        return node

    def section(self, name: str) -> dict[str, Any]:
        value = self.data.get(name, {})
        return value if isinstance(value, dict) else {}

    def __getitem__(self, path: str) -> Any:
        return self.get(path)


def load_config(
    yaml_path: str | os.PathLike[str] | None = None,
    env: dict[str, str] | None = None,
) -> Config:
    """Resolve config with precedence env > yaml > defaults
    (reference scheduler.py:55-60).

    `yaml_path` defaults to ./config.yaml next to the caller's CWD if present
    (the reference loads from its own directory, scheduler.py:46-52).
    `env` defaults to os.environ; injectable for tests.
    """
    data = copy.deepcopy(DEFAULTS)

    if yaml_path is None:
        candidate = Path("config.yaml")
        yaml_path = candidate if candidate.exists() else None
    if yaml_path is not None:
        try:
            import yaml
        except ImportError as exc:
            raise RuntimeError(
                f"config file {yaml_path} needs PyYAML, which is not installed: "
                f"install it, or run without a config file (defaults + env)"
            ) from exc
        raw = Path(yaml_path).read_text()
        loaded = yaml.safe_load(raw) or {}
        if not isinstance(loaded, dict):
            raise ValueError(f"config file {yaml_path} must contain a mapping")
        for key, val in loaded.items():
            if key in DEFAULTS and isinstance(DEFAULTS[key], dict) and not isinstance(val, dict):
                raise ValueError(
                    f"config file {yaml_path}: section {key!r} must be a mapping, got {type(val).__name__}"
                )
        data = _deep_merge(data, loaded)

    env_map = os.environ if env is None else env
    for env_name, dotted in ENV_OVERRIDES.items():
        if env_name in env_map:
            parts = dotted.split(".")
            node = data
            for part in parts[:-1]:
                node = node.setdefault(part, {})
                if not isinstance(node, dict):
                    raise ValueError(
                        f"cannot apply env var {env_name}: config section "
                        f"{'.'.join(parts[:-1])!r} is not a mapping"
                    )
            template = node.get(parts[-1])
            try:
                node[parts[-1]] = _coerce(env_map[env_name], template)
            except ValueError as exc:
                raise ValueError(
                    f"invalid value for env var {env_name}={env_map[env_name]!r}: {exc}"
                ) from exc

    return Config(data)
