"""DecisionClient — resilience wrapper around any DecisionBackend.

Control-flow parity with the reference's HuggingFaceClient.get_scheduling_decision
(reference scheduler.py:377-416): cache check first (scheduler.py:380-385);
up to max_retries attempts through the circuit breaker (scheduler.py:390-395)
with exponential backoff retry_delay * 2**attempt (scheduler.py:409-412 —
the reference hardcodes base 1s and never reads its retry_delay config key;
here the key is live); breaker-open or retry exhaustion falls back to the
heuristic scorer (scheduler.py:404-416); successful non-fallback decisions
are cached (scheduler.py:398-399); decisions are validated against the live
node list before acceptance (scheduler.py:453-465).

Differences, on purpose:
- genuinely async: backoff is `await asyncio.sleep`, the backend call runs in
  a worker thread — the reference's `time.sleep` blocks its event loop
  (SURVEY §2 component 12);
- the breaker guards the in-tree TPU engine (BackendError, XLA failures)
  instead of a remote HTTP API;
- stats parity: total/successful/failed/cached requests, avg response time,
  breaker trips (scheduler.py:344-351).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from collections.abc import Sequence

from k8s_llm_scheduler_tpu_torch.core.breaker import CircuitBreaker, CircuitOpenError
from k8s_llm_scheduler_tpu_torch.observability import spans
from k8s_llm_scheduler_tpu_torch.sched import deadline
from k8s_llm_scheduler_tpu_torch.sched.deadline import (
    LADDER,
    DeadlineBudget,
    DeadlineExceededError,
)
from k8s_llm_scheduler_tpu_torch.core.cache import DecisionCache, decision_cache_key
from k8s_llm_scheduler_tpu_torch.core.fallback import fallback_decision
from k8s_llm_scheduler_tpu_torch.core.validation import validate_decision
from k8s_llm_scheduler_tpu_torch.engine.backend import DecisionBackend, NoFeasibleNodeError
from k8s_llm_scheduler_tpu_torch.types import (
    DecisionSource,
    NodeMetrics,
    PodSpec,
    SchedulingDecision,
)

logger = logging.getLogger(__name__)


class DecisionClient:
    def __init__(
        self,
        backend: DecisionBackend,
        cache: DecisionCache | None = None,
        breaker: CircuitBreaker | None = None,
        max_retries: int = 3,
        retry_delay: float = 1.0,
        fallback_strategy: str = "resource_balanced",
        fallback_enabled: bool = True,
        deadline_ms: float | None = None,
        llm_min_budget_ms: float = 25.0,
    ) -> None:
        self.backend = backend
        self.cache = cache
        self.breaker = breaker
        if breaker is not None:
            # Unschedulable pods must never open the circuit (pod property,
            # not device health); neither must a deadline rejection (an
            # overloaded CALLER is not a sick device).
            for exc_type in (NoFeasibleNodeError, DeadlineExceededError):
                if exc_type not in breaker.non_failure_exceptions:
                    breaker.non_failure_exceptions = (
                        *breaker.non_failure_exceptions,
                        exc_type,
                    )
        self.max_retries = max(1, int(max_retries))
        self.retry_delay = float(retry_delay)
        self.fallback_strategy = fallback_strategy
        self.fallback_enabled = fallback_enabled
        # Deadline-budgeted degradation (sched/deadline.py): every
        # decision gets `deadline_ms` of budget (None = unlimited) and
        # the ladder LLM -> cached -> heuristic is stepped by what
        # remains: below `llm_min_budget_ms` the model rung is no longer
        # affordable and the decision sheds to a fast answer instead of
        # timing out its bind. An SLO burn-rate brownout (enter_brownout,
        # wired to observability/slo.py on_trip in `cli run`) forces the
        # shed regardless of budget.
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        self.llm_min_budget_ms = float(llm_min_budget_ms)
        self._brownout: set[str] = set()
        self.stats = {
            "total_requests": 0,
            "successful_requests": 0,
            "failed_requests": 0,
            "cached_requests": 0,
            "coalesced_requests": 0,
            "fallback_decisions": 0,
            "invalid_decisions": 0,
            "degraded_decisions": 0,
            "degraded_fallbacks": 0,
            "brownout_decisions": 0,
            "deadline_timeouts": 0,
            "avg_response_time_ms": 0.0,
        }
        # Single-flight: identical (pod shape, cluster state) decisions share
        # one in-flight backend call — without this, a 1000-pod burst of 8
        # shapes fires 1000 LLM requests before the first one can populate
        # the cache.
        self._inflight: dict[str, asyncio.Future] = {}

    def _note_response_time(self, ms: float) -> None:
        """Running average (reference scheduler.py:435-441)."""
        n = self.stats["successful_requests"]
        prev = self.stats["avg_response_time_ms"]
        self.stats["avg_response_time_ms"] = prev + (ms - prev) / max(1, n)

    def _call_backend(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics]
    ) -> SchedulingDecision:
        if self.breaker is not None:
            return self.breaker.call(self.backend.get_scheduling_decision, pod, nodes)
        return self.backend.get_scheduling_decision(pod, nodes)

    async def _call_backend_async(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics]
    ) -> SchedulingDecision:
        """Prefer the backend's natively-async path (no worker thread held
        per in-flight decision — a burst of N distinct pod shapes would pin
        N pool threads for a full wave round trip otherwise); fall back to
        asyncio.to_thread for sync-only backends (fakes, stubs)."""
        afn = getattr(self.backend, "get_scheduling_decision_async", None)
        if afn is not None:
            if self.breaker is not None:
                return await self.breaker.async_call(afn, pod, nodes)
            return await afn(pod, nodes)
        return await asyncio.to_thread(self._call_backend, pod, nodes)

    def _fallback(
        self, nodes: Sequence[NodeMetrics], reason: str, pod: PodSpec | None = None
    ) -> SchedulingDecision | None:
        trace = spans.current_trace()
        if trace is not None:
            trace.set_meta(fallback_reason=reason)
        if not self.fallback_enabled:
            return None
        decision = fallback_decision(
            nodes, reason=reason, strategy=self.fallback_strategy, pod=pod
        )
        if decision is not None:
            self.stats["fallback_decisions"] += 1
        return decision

    # ---------------------------------------------------------- degradation
    def enter_brownout(self, reason: str = "manual") -> None:
        """SLO burn-rate brownout: shed the LLM rung for every decision
        until the burn clears (exit_brownout). Reasons are a SET — two
        burning objectives require two clears."""
        self._brownout.add(reason)
        logger.warning("decision brownout entered (%s)", reason)

    def exit_brownout(self, reason: str = "manual") -> None:
        if reason not in self._brownout:
            return  # already clear (or never entered): nothing to log
        self._brownout.discard(reason)
        if not self._brownout:
            logger.info("decision brownout cleared (%s)", reason)

    @property
    def brownout(self) -> bool:
        return bool(self._brownout)

    def _degrade(
        self,
        nodes: Sequence[NodeMetrics],
        reason: str,
        pod: PodSpec | None,
        rung: str = LADDER[-1],
    ) -> SchedulingDecision | None:
        """Step down the ladder (sched/deadline.LADDER): the cached rung
        was already consulted upstream (it is free and always first), so
        a degradation here lands on the heuristic floor. Counted apart
        from ordinary fallbacks — `degraded_decisions` is the ladder's
        engagement meter (bench --preset chaos asserts it moves in the
        brownout regime)."""
        self.stats["degraded_decisions"] += 1
        trace = spans.current_trace()
        if trace is not None:
            trace.set_meta(degraded=rung, degraded_reason=reason)
        decision = self._fallback(nodes, reason, pod)
        if decision is not None:
            # degrades that actually produced a fallback decision — the
            # counter rollout/canary subtracts from the scheduler-side
            # fallback count (a shed with fallback disabled or no
            # feasible node lands in `unschedulable`, not `fallback`,
            # and must not be subtracted)
            self.stats["degraded_fallbacks"] += 1
        return decision

    def fast_decision(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics]
    ) -> tuple[SchedulingDecision | None, "asyncio.Future | None"]:
        """Synchronous fast path for the burst hot loop (sched/loop.py):

        - (decision, None): cache hit, counted, ready to bind — no
          coroutine needed;
        - (None, future): a single-flight leader for this key is in flight;
          the caller may park the pod on the future (follower fan-out) and
          bind the whole batch when it resolves — count via
          note_coalesced(n) at flush;
        - (None, None): backend work needed — take the full async path.
        """
        if self.cache is None:
            return None, None
        key = decision_cache_key(pod, nodes)
        cached = self.cache.get(pod, nodes, key=key)
        if cached is not None:
            self.stats["total_requests"] += 1
            self.stats["cached_requests"] += 1
            return dataclasses.replace(cached, source=DecisionSource.CACHE), None
        return None, self._inflight.get(key)

    def note_coalesced(self, n: int) -> None:
        """Account a flushed follower batch (see fast_decision)."""
        self.stats["total_requests"] += n
        self.stats["coalesced_requests"] += n
        self.stats["cached_requests"] += n

    async def get_scheduling_decision(
        self,
        pod: PodSpec,
        nodes: Sequence[NodeMetrics],
        concurrency: "asyncio.Semaphore | None" = None,
    ) -> SchedulingDecision | None:
        """Decide a node for `pod`, or None when nothing can decide (the pod
        stays Pending and will be re-observed — correctness rests on the
        cluster as source of truth, SURVEY §5 checkpoint note).

        `concurrency` bounds ONLY the backend-work path (_decide_uncached):
        cache hits and single-flight follower waits never hold a slot — but
        a follower that falls through after a failed leader does, so a
        leader failure can't stampede an unbounded herd onto the backend."""
        self.stats["total_requests"] += 1
        # Deadline budget: adopt the ambient one (a caller that already
        # started the clock — e.g. a replica server re-installing a wire
        # deadline) or start this decision's own. Started HERE, before the
        # cache lookup, so the budget covers the decision end to end.
        budget = deadline.current_budget()
        if budget is None and self.deadline_ms is not None:
            budget = DeadlineBudget.start(self.deadline_ms)

        key: str | None = None
        generation: int | None = None
        my_future: asyncio.Future | None = None
        if self.cache is not None:
            # Staleness is handled by the cache key itself: node names and
            # readiness are part of the digest (core/cache.py), so a node
            # going NotReady or disappearing changes the key and misses.
            # The policy epoch is captured HERE, before the backend call: a
            # decision computed under pre-swap weights that resolves after
            # a hot swap's bump_generation must file under the OLD epoch
            # (unreachable), not the new one (rollout/hotswap.py).
            key = decision_cache_key(pod, nodes)
            generation = self.cache.generation
            trace = spans.current_trace()
            if trace is not None:
                # prompt/decision identity for the flight recorder: the
                # cache key digests (pod shape, cluster snapshot) — the
                # same equivalence class the prompt prefix is keyed by
                trace.set_meta(cache_key=key[:16], cache_generation=generation)
            cached = self.cache.get(pod, nodes, key=key)
            if trace is not None:
                # which tier answered (or "miss"): l1_hit / l2_hit come
                # from the cache's thread-local lookup record — the fleet
                # tiering attribute (fleet/cache.TieredDecisionCache); a
                # flat DecisionCache reports l1_hit/miss.
                tier = getattr(self.cache, "last_tier", None)
                if tier is not None:
                    trace.set_meta(cache_tier=tier)
            if cached is not None:
                self.stats["cached_requests"] += 1
                return dataclasses.replace(cached, source=DecisionSource.CACHE)
            existing = self._inflight.get(key)
            if existing is not None:
                with spans.span("coalesce_wait"):
                    try:
                        leader = await asyncio.shield(existing)
                    except Exception:
                        leader = None
                if leader is not None:
                    self.stats["coalesced_requests"] += 1
                    self.stats["cached_requests"] += 1
                    if trace is not None:
                        trace.set_meta(cache_tier="coalesced")
                    return dataclasses.replace(leader, source=DecisionSource.CACHE)
                # Leader failed or fell back — compute independently below.
            fut = asyncio.get_running_loop().create_future()
            # Register only if nobody else re-registered first (two followers
            # waking from a failed leader must not overwrite each other).
            if self._inflight.setdefault(key, fut) is fut:
                my_future = fut

        try:
            if concurrency is not None:
                async with concurrency:
                    decision = await self._decide_uncached(
                        pod, nodes, cache_key=key, generation=generation,
                        budget=budget,
                    )
            else:
                decision = await self._decide_uncached(
                    pod, nodes, cache_key=key, generation=generation,
                    budget=budget,
                )
        except BaseException:
            if my_future is not None:
                if self._inflight.get(key) is my_future:
                    del self._inflight[key]
                my_future.set_result(None)
            raise
        if my_future is not None:
            if self._inflight.get(key) is my_future:
                del self._inflight[key]
            # Followers reuse only clean LLM decisions.
            my_future.set_result(
                decision if decision is not None and not decision.fallback_needed else None
            )
        return decision

    async def _decide_uncached(
        self,
        pod: PodSpec,
        nodes: Sequence[NodeMetrics],
        cache_key: str | None = None,
        generation: int | None = None,
        budget: DeadlineBudget | None = None,
    ) -> SchedulingDecision | None:
        # Degradation ladder gate (LLM rung affordability). Brownout
        # first: a burning SLO says the backend's latency is ALREADY
        # hurting the fleet — keep even affordable decisions off it.
        if self._brownout:
            self.stats["brownout_decisions"] += 1
            return self._degrade(
                nodes, f"brownout:{','.join(sorted(self._brownout))}", pod
            )
        if budget is not None and budget.remaining_ms() < self.llm_min_budget_ms:
            return self._degrade(nodes, "deadline_budget", pod)

        last_error: Exception | None = None
        for attempt in range(self.max_retries):
            start = time.perf_counter()  # per attempt: excludes backoff sleeps
            try:
                with spans.span("backend", attempt=attempt):
                    if budget is None:
                        decision = await self._call_backend_async(pod, nodes)
                    else:
                        # the ambient install lets the replica wire stamp
                        # the REMAINING budget onto the decision frame;
                        # wait_for is the local enforcement of the same
                        # deadline (sheds to a fast decision instead of
                        # letting the bind time out)
                        with deadline.running(budget):
                            decision = await asyncio.wait_for(
                                self._call_backend_async(pod, nodes),
                                timeout=max(budget.remaining_ms(), 1.0) / 1000.0,
                            )
            except asyncio.TimeoutError:
                self.stats["deadline_timeouts"] += 1
                logger.warning(
                    "decision for %s/%s exceeded its %.0fms deadline budget, "
                    "degrading", pod.namespace, pod.name,
                    budget.total_ms if budget is not None else 0.0,
                )
                return self._degrade(nodes, "deadline_exceeded", pod)
            except DeadlineExceededError:
                # the remote end refused an already-expired frame: same
                # shed, minus a wave of wasted compute on the worker
                self.stats["deadline_timeouts"] += 1
                return self._degrade(nodes, "deadline_exceeded", pod)
            except CircuitOpenError as exc:
                logger.warning("circuit open, using fallback: %s", exc)
                return self._fallback(nodes, "circuit_open", pod)
            except NoFeasibleNodeError as exc:
                # Pod property, not backend health: no retries, no breaker
                # failure, no constraint-ignoring fallback. Pod stays Pending.
                logger.warning("unschedulable: %s", exc)
                return self._fallback(nodes, "no_feasible_node", pod)
            except Exception as exc:
                last_error = exc
                logger.warning(
                    "backend attempt %d/%d failed: %s", attempt + 1, self.max_retries, exc
                )
                if budget is not None and (
                    budget.remaining_ms() < self.llm_min_budget_ms
                ):
                    # a retry the budget can't afford is a disguised
                    # timeout — shed now, with the error on record
                    return self._degrade(
                        nodes, f"deadline_budget:{last_error}", pod
                    )
                if attempt + 1 < self.max_retries:
                    backoff = self.retry_delay * (2**attempt)
                    if budget is not None:
                        backoff = min(
                            backoff, max(budget.remaining_ms(), 0.0) / 1000.0
                        )
                    await asyncio.sleep(backoff)
                continue

            if not validate_decision(decision, nodes):
                # Hallucinated node name — defense in depth behind the
                # constrained decoder (reference scheduler.py:453-465).
                self.stats["invalid_decisions"] += 1
                logger.warning(
                    "backend selected unknown node %r, using fallback",
                    decision.selected_node,
                )
                return self._fallback(nodes, "invalid_node", pod)

            self.stats["successful_requests"] += 1
            elapsed_ms = (time.perf_counter() - start) * 1000.0
            if decision.latency_ms == 0.0:
                decision.latency_ms = elapsed_ms
            self._note_response_time(elapsed_ms)
            if self.cache is not None:
                self.cache.set(
                    pod, nodes, decision, key=cache_key, generation=generation
                )
            return decision

        self.stats["failed_requests"] += 1
        logger.warning("all %d attempts failed (%s), using fallback", self.max_retries, last_error)
        return self._fallback(nodes, f"retries_exhausted:{last_error}", pod)

    def prewarm_prefix(self, nodes):
        """Forward an advisory prefix prewarm to the backend (see
        engine/local.prewarm_prefix). Returns the backend's Future, or
        None when the backend doesn't support prewarming (stub/remote
        backends) — the caller disables its prewarm loop on None."""
        fn = getattr(self.backend, "prewarm_prefix", None)
        return None if fn is None else fn(nodes)

    def get_stats(self) -> dict:
        out = dict(self.stats)
        if self._brownout:
            out["brownout"] = sorted(self._brownout)
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        if self.breaker is not None:
            out["circuit_breaker"] = self.breaker.stats()
        backend_stats = getattr(self.backend, "get_stats", None)
        if backend_stats is not None:
            # engine-level counters (waves, prefix hits, decode tokens, ...)
            # surface through /metrics alongside the scheduling stats
            out["engine"] = backend_stats()
        return out
