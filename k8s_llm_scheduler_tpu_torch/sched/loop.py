"""The scheduling control loop.

Orchestration parity with the reference's CustomScheduler (reference
scheduler.py:625-770): watch pending pods filtered to our schedulerName
(scheduler.py:674-676), per pod snapshot node metrics → build spec → decide →
bind (scheduler.py:690-729), stats bookkeeping (scheduler.py:635-640), and
self-healing on stream errors with a backoff sleep (scheduler.py:683-685).

TPU-first differences:
- genuinely concurrent: each pending pod is scheduled as an asyncio task, so
  a burst of pods overlaps cluster snapshots with LLM decisions and the
  batching engine can coalesce their prompts; `max_concurrency` bounds the
  in-flight set. The reference processes one pod at a time
  (scheduler.py:704) and blocks its event loop.
- node-metrics snapshots are shared across a burst: a snapshot taken within
  `snapshot_ttl_s` is reused, both to cut API traffic and to keep the
  cluster-state prompt prefix identical across the burst (which is what lets
  the engine prefix-cache it on device).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from collections.abc import Sequence

from k8s_llm_scheduler_tpu_torch.cluster.interface import (
    Binder,
    ClusterState,
    RawPod,
    raw_pod_to_spec,
)
from k8s_llm_scheduler_tpu_torch.observability import spans
from k8s_llm_scheduler_tpu_torch.observability.trace import PhaseRecorder
from k8s_llm_scheduler_tpu_torch.sched.client import DecisionClient
from k8s_llm_scheduler_tpu_torch.types import DecisionSource, NodeMetrics

logger = logging.getLogger(__name__)


def _stamp_decision(trace, decision) -> None:
    """THE decision-metadata stamp (full, fast, and follower paths all
    converge here so /debug/decisions entries carry one field set)."""
    if trace is not None:
        # set_meta, never trace.meta[...]=: stamps race /debug handlers
        # serializing the trace from metrics-server threads
        trace.set_meta(
            source=decision.source.value,
            selected_node=decision.selected_node,
            confidence=decision.confidence,
        )


def _stamp_outcome(trace, outcome: str) -> None:
    if trace is not None:
        trace.set_meta(outcome=outcome)


class Scheduler:
    def __init__(
        self,
        cluster: ClusterState,
        binder: Binder,
        client: DecisionClient,
        scheduler_name: str = "ai-llama-scheduler",
        max_concurrency: int = 64,
        snapshot_ttl_s: float = 1.0,
        error_backoff_s: float = 5.0,
        prefix_prewarm_s: float = 0.25,
    ) -> None:
        self.cluster = cluster
        self.binder = binder
        self.client = client
        self.scheduler_name = scheduler_name
        self.error_backoff_s = error_backoff_s
        self.snapshot_ttl_s = snapshot_ttl_s
        # Advisory prefix prewarming (0 disables): while idle, keep the
        # engine's (prefix KV, grammar) group pointed at the CURRENT
        # cluster snapshot so the first wave of the next burst skips the
        # chunked prefix prefill — the dominant term in the burst1000
        # floor (SCALING.md). `_prewarm_last` is written from the engine
        # worker thread's future callback (str compare/assign only).
        self.prefix_prewarm_s = prefix_prewarm_s
        self._prewarm_last: str | None = None
        self._sem = asyncio.Semaphore(max_concurrency)
        # Blocking (executor) binds get their own bound so they can't
        # monopolize the shared to_thread pool (snapshot runs there too).
        self._bind_sem = asyncio.Semaphore(min(32, max_concurrency))
        self._snapshot: tuple[float, Sequence[NodeMetrics]] | None = None
        self._snapshot_lock = asyncio.Lock()
        self._tasks: set[asyncio.Task] = set()
        # follower fan-out batches parked on in-flight leader futures
        self._followers: dict[asyncio.Future, list] = {}
        # pods currently in the pipeline, keyed (namespace, name): the
        # same pod can reach the scheduler twice concurrently — a watch
        # event racing a fleet rebind re-list (fleet/frontend._rebind),
        # or a kube relist re-delivering a still-in-flight pod. The
        # second copy is suppressed, not double-decided (the loser would
        # waste a model call and fail its bind at the apiserver). All
        # mutations happen on the event loop; completed pods leave the
        # set, so a genuinely re-pending pod (failed bind) retries.
        self._inflight_pods: set[tuple[str, str]] = set()
        self._stop_event = asyncio.Event()
        self.running = False
        # Per-phase wall time of the decision pipeline (SURVEY §5 tracing:
        # the reference has none) — surfaces via get_stats and /metrics.
        self.phases = PhaseRecorder()
        # Optional shadow scorer (rollout/shadow.ShadowScorer): mirrors a
        # fraction of decided pods through a candidate backend, non-binding
        # and off the hot path. Attached by the rollout wiring.
        self.shadow = None
        # Optional shard attribution (fleet/frontend.py): maps a pod's
        # (namespace, name) to its watch-space shard id; when set, every
        # decision trace carries shard_id in its meta so /debug/decisions
        # and `cli trace` answer "which replica's shard was this?".
        self.shard_fn = None
        # Optional in-loop latency probe (engine.resident_decision_latency,
        # attached by the cli run wiring when the backend serves from the
        # persistent loop): ring-served decisions have NO dispatch-fenced
        # engine spans — the work happened inside one resident XLA program
        # — so LLM decisions attach the probe's EWMA as a SYNTHETIC
        # `loop_resident` span and `cli trace show` explains them again.
        self.resident_latency_fn = None
        self.stats = {
            "total_scheduled": 0,
            "llm_decisions": 0,
            "cache_decisions": 0,
            "fallback_decisions": 0,
            "failed_bindings": 0,
            "unschedulable": 0,
        }

    def invalidate_snapshot(self) -> None:
        """Drop the cached node snapshot so the next decision re-reads the
        cluster. Wave-barrier drivers (sim/arena.py) call this between
        waves: each wave must decide against the settled post-bind state
        even when snapshot_ttl_s is set long enough to pin one snapshot
        per wave. Plain assignment — the reader re-checks under its lock."""
        self._snapshot = None

    async def _node_snapshot(self) -> Sequence[NodeMetrics]:
        """Cluster snapshot, reused within snapshot_ttl_s across a burst."""
        async with self._snapshot_lock:
            now = time.monotonic()
            if self._snapshot is not None and now - self._snapshot[0] < self.snapshot_ttl_s:
                return self._snapshot[1]
            metrics = await asyncio.to_thread(self.cluster.get_node_metrics)
            self._snapshot = (time.monotonic(), metrics)
            return metrics

    async def schedule_pod(self, raw: RawPod, pod=None) -> bool:
        """One pod through the full pipeline (reference scheduler.py:690-729).
        Returns True iff the pod was bound. `pod` is the optional
        already-converted PodSpec (the fast path computes it before falling
        through; don't pay raw_pod_to_spec twice on the ingest hot path).

        Each pod gets its own flight-recorder trace (observability/spans):
        snapshot/decide/bind child spans here, backend/admission/prefill/
        decode spans attached downstream (sched/client, engine/local), so
        "why was THIS placement slow?" is answerable from /debug/trace."""
        key = (raw.namespace, raw.name)
        if key in self._inflight_pods:
            logger.debug(
                "duplicate schedule suppressed: %s/%s (already in flight)",
                raw.namespace, raw.name,
            )
            return False
        self._inflight_pods.add(key)
        try:
            if pod is None:
                pod = raw_pod_to_spec(raw)
            with spans.start_trace(
                "decision", pod=f"{pod.namespace}/{pod.name}", path="full"
            ) as trace:
                self._stamp_shard(trace, pod)
                return await self._schedule_pod_inner(pod, trace)
        finally:
            self._inflight_pods.discard(key)

    def _stamp_shard(self, trace, pod) -> None:
        """Shard attribution on the decision trace (all three paths —
        full, fast, follower — call this right after the trace opens)."""
        if trace is not None and self.shard_fn is not None:
            trace.set_meta(shard_id=self.shard_fn(pod.namespace, pod.name))

    def _attach_resident_span(self, trace) -> None:
        """Synthetic `loop_resident` span on an LLM decision: the
        counter-derived EWMA of in-loop admission-to-first-emission
        latency (probe wired by cli run). Marked synthetic=True — it is
        an attribution estimate from device counters, not a fenced
        measurement, and the trace viewer labels it as such. Backdated so
        the span sits inside the decide window it explains."""
        if trace is None or self.resident_latency_fn is None:
            return
        try:
            lat_ms = self.resident_latency_fn()
        except Exception:
            logger.exception("resident latency probe failed")
            return
        if not lat_ms:
            return
        trace.add_span(
            "loop_resident",
            start_unix=time.time() - lat_ms / 1000.0,  # graftlint: ok[raw-clock] — wall ANCHOR backdating a retroactive span (duration comes from device counters)
            dur_ms=float(lat_ms),
            synthetic=True,
        )

    async def _schedule_pod_inner(self, pod, trace) -> bool:
        with self.phases.phase("snapshot"), spans.span("snapshot"):
            nodes = await self._node_snapshot()
        if not nodes:
            logger.warning("no nodes in cluster, leaving %s pending", pod.name)
            self.stats["unschedulable"] += 1
            _stamp_outcome(trace, "unschedulable")
            return False

        with self.phases.phase("decide"), spans.span("decide"):
            # The semaphore is passed THROUGH: the client acquires it only
            # around real backend work. Cache hits and single-flight
            # follower waits never hold a slot (during a burst, followers
            # parked on slots throttled the watch drain behind the wave
            # round trip — measured ~2x p50 inflation), while a follower
            # retrying after a failed leader is still bounded.
            decision = await self.client.get_scheduling_decision(
                pod, nodes, concurrency=self._sem
            )
        if decision is None:
            self.stats["unschedulable"] += 1
            _stamp_outcome(trace, "unschedulable")
            return False

        if decision.source is DecisionSource.FALLBACK:
            self.stats["fallback_decisions"] += 1
        elif decision.source is DecisionSource.CACHE:
            self.stats["cache_decisions"] += 1
        else:
            self.stats["llm_decisions"] += 1
            self._attach_resident_span(trace)
        _stamp_decision(trace, decision)

        if self.shadow is not None:
            # Non-binding candidate mirror (rollout/shadow.py): one counter
            # check + one executor submit; never on the bind critical path,
            # and a broken shadow must never affect real scheduling.
            try:
                self.shadow.observe(pod, nodes, decision)
            except Exception:
                logger.exception("shadow mirror failed")

        if getattr(self.binder, "bind_is_nonblocking", False):
            # In-memory binders (FakeCluster) finish in microseconds; the
            # executor round trip would cost more than the bind and its
            # queue serializes a 1000-pod drain.
            ok = self._bind_now(pod, decision)
        else:
            # Blocking binders go through the shared to_thread executor;
            # bound separately from the decide semaphore so an unbounded
            # flood of cache-hit binds can't saturate the executor and
            # starve _node_snapshot's to_thread behind it.
            async with self._bind_sem:
                with self.phases.phase("bind"), spans.span("bind"):
                    ok = await asyncio.to_thread(
                        self.binder.bind_pod_to_node,
                        pod.name, pod.namespace, decision.selected_node,
                    )
            self._note_bind(ok, pod, decision)
        _stamp_outcome(trace, "bound" if ok else "bind_failed")
        if not ok:
            return False
        logger.info(
            "scheduled %s/%s -> %s (%s, conf=%.2f, %.1fms)",
            pod.namespace,
            pod.name,
            decision.selected_node,
            decision.source.value,
            decision.confidence,
            decision.latency_ms,
        )
        return True

    async def _spawn(self, raw: RawPod, pod=None) -> None:
        # No semaphore here: the client bounds only its backend work, so
        # cache/coalesced decisions drain at host speed during a burst.
        try:
            await self.schedule_pod(raw, pod)
        except Exception:
            logger.exception("unhandled error scheduling %s/%s", raw.namespace, raw.name)

    # ------------------------------------------------------- burst fast path
    def _try_fast(self, raw: RawPod) -> tuple[bool, "PodSpec | None"]:
        """Handle a watch event synchronously on the hot loop when no
        backend work is needed. Returns (handled, pod_spec); an unhandled
        pod's spec is passed to the full path so it isn't converted twice.

        During a 1000-pod burst only ~#shapes decisions need the model;
        everything else is a cache hit or a follower of an in-flight
        single-flight leader. Spawning a task per such pod (round 2) made
        the median pod's latency drain-bound: hundreds of live coroutines
        contended with the engine's wave round trip. Here cache hits bind
        inline and followers park on the leader's future in a LIST — one
        callback flushes the whole batch when the leader resolves, so the
        loop stays idle while the wave is in flight (the pod's latency is
        then one wave round trip, not host scheduling).
        """
        if (raw.namespace, raw.name) in self._inflight_pods:
            return True, None  # duplicate of an in-flight pod: drop it
        if not getattr(self.binder, "bind_is_nonblocking", False):
            return False, None  # blocking binders need the executor path
        snap = self._snapshot
        if snap is None or time.monotonic() - snap[0] >= self.snapshot_ttl_s:
            return False, None  # no fresh snapshot: full path refreshes it
        nodes = snap[1]
        if not nodes:
            return False, None
        pod = raw_pod_to_spec(raw)
        t0 = time.perf_counter()
        t0_wall = time.time()  # graftlint: ok[raw-clock] — wall ANCHOR for span stitching, never a judgment (durations stay perf_counter)
        decision, fut = self.client.fast_decision(pod, nodes)
        if decision is not None:
            # Record the decide phase only when the fast path handles the
            # pod — an unhandled probe falls through to schedule_pod, which
            # records its own decide (double counting otherwise).
            decide_s = time.perf_counter() - t0
            self.phases.record("decide", decide_s)
            self.stats["cache_decisions"] += 1
            # backdated to the watch event: the trace opens after the
            # cache hit resolved, but its root must cover decide + bind
            with spans.start_trace(
                "decision", pod=f"{pod.namespace}/{pod.name}", path="fast",
                start_unix=t0_wall, start_perf=t0,
            ) as trace:
                if trace is not None:
                    trace.add_span(
                        "decide", start_unix=t0_wall,
                        dur_ms=decide_s * 1000.0, cache_hit=True,
                    )
                    # the cache recorded which tier answered (thread-local
                    # on this loop thread, set by the fast_decision lookup
                    # just above): l1_hit, or l2_hit via a fleet-shared L2
                    tier = getattr(self.client.cache, "last_tier", None)
                    if tier is not None:
                        trace.set_meta(cache_tier=tier)
                self._stamp_shard(trace, pod)
                _stamp_decision(trace, decision)
                try:
                    ok = self._bind_now(pod, decision)
                    _stamp_outcome(trace, "bound" if ok else "bind_failed")
                except Exception:
                    # Contained HERE, pod counts as handled: re-running it
                    # through the full path would double-count the decide/
                    # cache stats just recorded (and could double-bind). A
                    # raising binder is accounted like a failed bind; the
                    # pod stays Pending and the watch re-observes it.
                    self.stats["failed_bindings"] += 1
                    _stamp_outcome(trace, "bind_raised")
                    logger.exception(
                        "fast-path bind raised: %s/%s", pod.namespace, pod.name
                    )
            return True, pod
        if fut is not None:
            batch = self._followers.get(fut)
            if batch is None:
                self._followers[fut] = batch = []
                fut.add_done_callback(self._flush_followers)
            # parked followers are in flight until the flush binds them
            self._inflight_pods.add((raw.namespace, raw.name))
            batch.append((raw, pod, t0, t0_wall))
            return True, pod
        return False, pod

    def _bind_now(self, pod, decision) -> bool:
        """Synchronous bind + bookkeeping (nonblocking binders only)."""
        with self.phases.phase("bind"), spans.span("bind"):
            ok = self.binder.bind_pod_to_node(
                pod.name, pod.namespace, decision.selected_node
            )
        self._note_bind(ok, pod, decision)
        return ok

    def _note_bind(self, ok: bool, pod, decision) -> None:
        """The ONE place bind outcomes are accounted (fast path, full path,
        follower flush all converge here)."""
        if ok:
            self.stats["total_scheduled"] += 1
        else:
            self.stats["failed_bindings"] += 1
            logger.error(
                "binding failed: %s/%s -> %s",
                pod.namespace, pod.name, decision.selected_node,
            )

    def _flush_followers(self, fut: asyncio.Future) -> None:
        """Leader resolved: bind its parked followers in one pass, or (on a
        failed/fallback leader) degrade each to the full path."""
        batch = self._followers.pop(fut, [])
        if not batch:
            return
        leader = None
        if not fut.cancelled():
            leader = fut.result()  # single-flight futures never hold exceptions
        if leader is not None:
            self.client.note_coalesced(len(batch))
            decision = dataclasses.replace(leader, source=DecisionSource.CACHE)
            now = time.perf_counter()
            for _raw, pod, parked_at, parked_wall in batch:
                # Per-item isolation: one raising bind must not drop the
                # rest of the batch (this runs in a future done-callback).
                try:
                    # follower decide duration = park -> leader resolution,
                    # matching what the shield-await path used to measure
                    self.phases.record("decide", now - parked_at)
                    self.stats["cache_decisions"] += 1
                    # backdated to the park time: the root covers the
                    # whole park -> leader -> bind interval, not just bind
                    with spans.start_trace(
                        "decision", pod=f"{pod.namespace}/{pod.name}",
                        path="follower",
                        start_unix=parked_wall, start_perf=parked_at,
                    ) as trace:
                        if trace is not None:
                            trace.add_span(
                                "decide", start_unix=parked_wall,
                                dur_ms=(now - parked_at) * 1000.0,
                                coalesced=True,
                            )
                            # a follower never consulted the cache: its
                            # decision is the leader's, reused in flight
                            trace.set_meta(cache_tier="coalesced")
                        self._stamp_shard(trace, pod)
                        _stamp_decision(trace, decision)
                        ok = self._bind_now(pod, decision)
                        _stamp_outcome(trace, "bound" if ok else "bind_failed")
                except Exception:
                    self.stats["failed_bindings"] += 1
                    logger.exception(
                        "follower bind failed: %s/%s", pod.namespace, pod.name
                    )
                finally:
                    self._inflight_pods.discard((_raw.namespace, _raw.name))
        else:
            # leader failed or fell back: each follower decides on the full
            # path (which records its own decide phase). Release the park
            # key first — schedule_pod re-adds it (and would otherwise
            # suppress its own retry as a duplicate).
            for raw, pod, _t0, _t0w in batch:
                self._inflight_pods.discard((raw.namespace, raw.name))
                task = asyncio.create_task(self._spawn(raw, pod))
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)

    async def _prefix_prewarm_loop(self) -> None:
        """Keep the engine's prefix group pointed at the current cluster
        snapshot while idle (engine/local.prewarm_prefix — advisory: the
        engine drops installs whenever real traffic is in flight). The
        rendered cluster prefix is the change signature: re-prewarm only
        when the snapshot's PROMPT TEXT changed, so a steady-state tick
        costs one ~0.1 ms render plus at most 1/snapshot_ttl_s snapshot
        refreshes — and a refresh is an in-memory read for this repo's
        ClusterState impls (cluster/kube.py is a watch-driven informer
        serving get_node_metrics from its local cache with zero API
        calls; cluster/fake.py is memory), NOT recurring apiserver load.
        A polling ClusterState impl would pay its poll here at 1 Hz; gate
        with scheduler.prefix_prewarm_seconds: 0 in that case. Exits on
        the first tick if the backend doesn't support prewarming."""
        from k8s_llm_scheduler_tpu_torch.core.prompt import PromptEngine

        pe = PromptEngine()
        while not self._stop_event.is_set():
            try:
                await asyncio.wait_for(
                    self._stop_event.wait(), timeout=self.prefix_prewarm_s
                )
                return
            except asyncio.TimeoutError:
                pass
            if self._tasks:
                # Decisions in flight: the engine would drop the install
                # anyway (real traffic decides groups) — skip the render/
                # encode entirely instead of blocking the event loop at
                # tick rate for the whole burst. The tick resumes once the
                # burst drains, when the snapshot has settled post-binds.
                continue
            try:
                nodes = await self._node_snapshot()
                sig = pe.cluster_part(nodes)
                if sig == self._prewarm_last:
                    continue
                # to_thread: the local backend's prewarm_prefix is a queue
                # put, but a FanoutBackend forwards over the decision-RPC
                # wire — ReplicaClient may BLOCK dialing a dead worker for
                # connect_timeout_s, which must not wedge the event loop
                fut = await asyncio.to_thread(
                    self.client.prewarm_prefix, nodes
                )
                if fut is None:
                    return  # backend can't prewarm; stop ticking
                self._prewarm_last = sig

                def _done(f, s=sig):
                    # engine-worker thread: GIL-atomic compare/assign only.
                    # A dropped install (engine busy) clears the signature
                    # so the next tick retries.
                    try:
                        ok = f.result()
                    except Exception:
                        ok = False
                    if not ok and self._prewarm_last == s:
                        self._prewarm_last = None

                fut.add_done_callback(_done)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("prefix prewarm tick failed")

    async def run(self) -> None:
        """Watch loop: stream pending pods, schedule each concurrently.
        Self-heals on stream errors (reference scheduler.py:683-685).
        stop() terminates the loop even while the watch stream is idle —
        each stream read is raced against the stop event."""
        if self._stop_event.is_set():
            return  # stop() was called before run() got scheduled
        self.running = True
        # ONE long-lived stop-wait task raced against every stream read: a
        # fresh task per pod costs two task creations + a cancel on the
        # ingest hot path (~50 ms across a 1000-pod burst).
        stop_task = asyncio.ensure_future(self._stop_event.wait())
        prewarm_task = (
            asyncio.create_task(self._prefix_prewarm_loop())
            if self.prefix_prewarm_s > 0
            else None
        )
        try:
            while self.running:
                stream = None
                try:
                    stream = self.cluster.watch_pending_pods(self.scheduler_name).__aiter__()
                    while self.running:
                        next_task = asyncio.ensure_future(anext(stream))
                        done, _ = await asyncio.wait(
                            {next_task, stop_task}, return_when=asyncio.FIRST_COMPLETED
                        )
                        if stop_task in done and next_task not in done:
                            next_task.cancel()
                            try:
                                await next_task  # let the generator settle
                            except (asyncio.CancelledError, StopAsyncIteration):
                                pass
                            break
                        try:
                            raw = next_task.result()
                        except StopAsyncIteration:
                            break
                        pod = None
                        try:
                            handled, pod = self._try_fast(raw)
                        except Exception:
                            # Per-pod containment: a poison event must not
                            # tear down the watch stream (the full path has
                            # its own try/except in _spawn).
                            handled = False
                            logger.exception(
                                "fast path failed for %s/%s",
                                raw.namespace, raw.name,
                            )
                        if handled:
                            continue
                        task = asyncio.create_task(self._spawn(raw, pod))
                        self._tasks.add(task)
                        task.add_done_callback(self._tasks.discard)
                    break  # stream ended cleanly or stop requested
                except asyncio.CancelledError:
                    raise
                except Exception:
                    logger.exception(
                        "watch stream error, re-watching in %.1fs", self.error_backoff_s
                    )
                    await asyncio.sleep(self.error_backoff_s)
                finally:
                    if stream is not None and hasattr(stream, "aclose"):
                        # Run the generator's cleanup (stops kube watch threads).
                        await stream.aclose()
        finally:
            stop_task.cancel()
            try:
                await stop_task
            except asyncio.CancelledError:
                pass
            if prewarm_task is not None:
                prewarm_task.cancel()
                try:
                    await prewarm_task
                except asyncio.CancelledError:
                    pass
        await self.drain()

    async def drain(self) -> None:
        """Wait for all in-flight scheduling tasks."""
        while self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
            # A gather whose tasks have all finished completes without
            # yielding to the loop (Python 3.12), so the done callbacks that
            # take them out of _tasks would never run: yield once.
            await asyncio.sleep(0)

    def stop(self) -> None:
        """Request loop termination; safe to call before or during run()."""
        self.running = False
        self._stop_event.set()

    def get_stats(self) -> dict:
        out = {
            **self.stats,
            "client": self.client.get_stats(),
            "phases": self.phases.snapshot(),
        }
        if self.shadow is not None:
            out["shadow"] = self.shadow.stats()
        return out
