"""Circuit breaker for the decision backend.

Behavioral parity with the reference's CircuitBreaker (reference
scheduler.py:299-332): CLOSED / OPEN / HALF_OPEN states (scheduler.py:307);
opens after `failure_threshold` consecutive failures (scheduler.py:329-331);
OPEN transitions to HALF_OPEN after `timeout_seconds` (scheduler.py:311-314);
a success in HALF_OPEN closes the breaker and resets the failure count
(scheduler.py:320-323). Defaults threshold=5, timeout=60s (config.yaml:41-42).

Improvements over the reference:
- A typed `CircuitOpenError` instead of matching the string
  "Circuit breaker is OPEN" upstream (the reference matches by substring at
  scheduler.py:404 — fragile).
- Thread-safe: the continuous-batching engine calls through the breaker from
  multiple tasks.
- In the TPU build the breaker guards *device health* (engine failures, XLA
  errors, TPU-VM liveness probes) rather than a remote HTTP API — same state
  machine, repointed per the north star (SURVEY §2.3).
"""

from __future__ import annotations

import enum
import logging
import random
import threading
import time
from typing import Any, Callable, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")


class CircuitState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitOpenError(RuntimeError):
    """Raised when a call is rejected because the breaker is OPEN."""


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 5,
        timeout_seconds: float = 60.0,
        half_open_max_calls: int = 1,
        non_failure_exceptions: tuple[type[BaseException], ...] = (),
        cooldown_jitter: float = 0.1,
        clock: Callable[[], float] = time.monotonic,
        jitter_rng: "random.Random | None" = None,
    ) -> None:
        self.failure_threshold = int(failure_threshold)
        self.timeout_seconds = float(timeout_seconds)
        self.half_open_max_calls = int(half_open_max_calls)
        # Exceptions that propagate without counting as backend failures
        # (e.g. "this pod is unschedulable" — a pod property, not ill health).
        self.non_failure_exceptions = non_failure_exceptions
        # Cooldown jitter: each trip draws its OPEN->HALF_OPEN cooldown
        # from [timeout, timeout * (1 + jitter)]. N fleet replicas that
        # tripped on the same dying backend would otherwise all probe at
        # the same instant when the shared cooldown elapses — a
        # thundering herd of HALF_OPEN probes onto a backend that just
        # recovered (or worse, is still recovering). Jitter decorrelates
        # the probes so the first successful one closes its replica's
        # breaker while the rest are still waiting. `jitter_rng` is
        # injectable for deterministic tests; the clock likewise so
        # failover tests advance time instead of sleeping.
        self.cooldown_jitter = max(0.0, float(cooldown_jitter))
        self._clock = clock
        self._rng = jitter_rng if jitter_rng is not None else random.Random()
        self._cooldown_s = self.timeout_seconds
        self._state = CircuitState.CLOSED
        self._failure_count = 0
        self._opened_at = 0.0
        self._half_open_inflight = 0
        self._lock = threading.Lock()
        self.trip_count = 0
        # Optional transition observer (chaos/invariants.py watches the
        # state machine's legality through it). Called WITH the breaker
        # lock held: the hook must only record — never call back into
        # the breaker (the lock is not reentrant).
        self.on_transition: Callable[[CircuitState, CircuitState], None] | None = None
        # Advisory SLO-trip bookkeeping (observability/slo.py): evidence
        # surfaced beside breaker state, never a state transition.
        self._slo_advisories = 0
        self._last_slo_trip: str | None = None
        # Durable-state sink (sched/journal.py record_breaker): called
        # with snapshot() OUTSIDE the lock after a trip or a close, so a
        # rebooted replica can restore OPEN with its remaining cooldown
        # instead of hammering a backend the fleet knows is down. None
        # in non-durable deployments — one attribute read per edge.
        self.journal_sink: Callable[[dict], None] | None = None

    def _set_state_locked(self, new: CircuitState) -> None:
        """THE state write (caller holds self._lock): fires on_transition
        on every actual edge so an observer sees the full walk."""
        old = self._state
        if old is new:
            return
        self._state = new
        if self.on_transition is not None:
            try:
                self.on_transition(old, new)
            except Exception:  # observer bugs must not break serving
                pass  # graftlint: ok[swallowed-exception] — best-effort observer; breaker state already updated

    @property
    def state(self) -> CircuitState:
        with self._lock:
            return self._effective_state_locked()

    def _effective_state_locked(self) -> CircuitState:
        """OPEN decays to HALF_OPEN after the (jittered) cooldown
        (scheduler.py:311-314).

        Writes `self._state`; caller holds self._lock — the `*_locked`
        suffix is the repo's called-with-lock-held contract (cluster/
        kube.py convention, enforced by graftlint's unguarded-attr-write
        rule: this PR's sweep found the old name `_effective_state`
        carrying a lock-guarded write with no visible contract)."""
        if (
            self._state is CircuitState.OPEN
            and self._clock() - self._opened_at >= self._cooldown_s
        ):
            self._set_state_locked(CircuitState.HALF_OPEN)
        return self._state

    def _admit(self) -> bool:
        """Shared admission gate; returns True when this call is the
        HALF_OPEN probe (caller must release via _release_probe)."""
        with self._lock:
            state = self._effective_state_locked()
            if state is CircuitState.OPEN:
                raise CircuitOpenError(
                    f"circuit open for {self._cooldown_s - (self._clock() - self._opened_at):.1f}s more"
                )
            if state is CircuitState.HALF_OPEN:
                if self._half_open_inflight >= self.half_open_max_calls:
                    raise CircuitOpenError("circuit half-open, probe already in flight")
                self._half_open_inflight += 1
                return True
        return False

    def _release_probe(self) -> None:
        with self._lock:
            self._half_open_inflight -= 1

    def call(self, func: Callable[..., T], *args: Any, **kwargs: Any) -> T:
        """Run `func` through the breaker (reference scheduler.py:309-332).

        In HALF_OPEN at most `half_open_max_calls` probes run concurrently
        (the reference declares this knob at config.yaml:43 but never reads
        it); excess callers get CircuitOpenError rather than hammering a
        backend that is still being probed.
        """
        half_open_probe = self._admit()
        try:
            result = func(*args, **kwargs)
        except self.non_failure_exceptions:
            raise
        except Exception:
            self.record_failure()
            raise
        else:
            self.record_success()
            return result
        finally:
            if half_open_probe:
                self._release_probe()

    async def async_call(self, func: Callable[..., Any], *args: Any, **kwargs: Any):
        """Async twin of call(): awaits a coroutine function through the same
        state machine. Used by the natively-async decision backend path
        (engine/local.py get_scheduling_decision_async), where holding a
        worker thread per in-flight call would exhaust the pool on a
        1000-pod burst."""
        half_open_probe = self._admit()
        try:
            result = await func(*args, **kwargs)
        except self.non_failure_exceptions:
            raise
        except Exception:
            self.record_failure()
            raise
        else:
            self.record_success()
            return result
        finally:
            if half_open_probe:
                self._release_probe()

    def record_success(self) -> None:
        with self._lock:
            closed = False
            if self._effective_state_locked() is CircuitState.HALF_OPEN:
                self._set_state_locked(CircuitState.CLOSED)
                closed = True
            self._failure_count = 0
        if closed:
            self._journal_edge()

    def record_failure(self) -> None:
        with self._lock:
            self._failure_count += 1
            state = self._effective_state_locked()
            tripped = False
            if state is CircuitState.HALF_OPEN or self._failure_count >= self.failure_threshold:
                if self._state is not CircuitState.OPEN:
                    self.trip_count += 1
                    tripped = True
                self._set_state_locked(CircuitState.OPEN)
                self._opened_at = self._clock()
                # fresh jittered cooldown PER TRIP: re-drawing each time
                # keeps replicas decorrelated even when they keep
                # re-tripping on the same backend in lockstep
                self._cooldown_s = self.timeout_seconds * (
                    1.0 + self.cooldown_jitter * self._rng.random()
                )
        if tripped:
            self._journal_edge()

    def _journal_edge(self) -> None:
        """Ship a post-edge snapshot to the durable journal. Outside the
        lock on purpose: the sink does file I/O, and snapshot() takes
        the (non-reentrant) lock itself."""
        sink = self.journal_sink
        if sink is None:
            return
        try:
            sink(self.snapshot())
        except Exception:
            # a full/closed journal must not take serving down with it
            logger.exception("breaker journal sink failed")

    def snapshot(self) -> dict[str, Any]:
        """Restorable state: what a durable journal records on each trip
        or close. OPEN carries its REMAINING (already-jittered) cooldown
        so a restore resumes the countdown instead of restarting it."""
        with self._lock:
            state = self._effective_state_locked()
            out: dict[str, Any] = {
                "state": state.value,
                "failure_count": self._failure_count,
                "trip_count": self.trip_count,
            }
            if state is CircuitState.OPEN:
                out["remaining_s"] = max(
                    0.0,
                    self._cooldown_s - (self._clock() - self._opened_at),
                )
            return out

    def restore(self, snap: dict) -> None:
        """Rehydrate from a snapshot() dict after a process restart.
        Administrative like reset(): the restore edge is not a state-
        machine transition, so it deliberately bypasses on_transition
        (chaos/invariants.py judges only the machine's own walk). A
        HALF_OPEN snapshot restores as OPEN with zero remaining
        cooldown — the very next admission probes, which is exactly
        what HALF_OPEN means."""
        state = str(snap.get("state", "closed"))
        with self._lock:
            self._failure_count = int(snap.get("failure_count", 0))
            self.trip_count = int(snap.get("trip_count", self.trip_count))
            if state in (CircuitState.OPEN.value, CircuitState.HALF_OPEN.value):
                self._state = CircuitState.OPEN
                self._opened_at = self._clock()
                self._cooldown_s = (
                    max(0.0, float(snap.get("remaining_s", 0.0)))
                    if state == CircuitState.OPEN.value else 0.0
                )
            else:
                self._state = CircuitState.CLOSED

    def reset(self) -> None:
        with self._lock:
            # administrative reset: deliberately NOT routed through
            # _set_state_locked — observers judge the state machine's own
            # edges, and an operator reset is outside the machine
            self._state = CircuitState.CLOSED
            self._failure_count = 0

    def slo_advisory(self, objective: str) -> None:
        """ADVISORY input from the SLO burn-rate engine (observability/
        slo.py on_trip hooks): a burning latency/error SLO is evidence of
        — not proof of — backend ill health, so this records and surfaces
        the trip beside the breaker's own state WITHOUT driving the state
        machine (decisions keep flowing; record_failure stays the only
        path to OPEN). Operators correlate `slo_advisories` with `trips`
        in /metrics: advisories without trips means the latency burn is
        not a backend fault (look at admission/queueing instead)."""
        with self._lock:
            self._slo_advisories += 1
            self._last_slo_trip = objective

    def stats(self) -> dict[str, Any]:
        with self._lock:
            out = {
                "state": self._effective_state_locked().value,
                "failure_count": self._failure_count,
                "trips": self.trip_count,
                # this trip's jittered cooldown (== timeout_seconds until
                # the first trip): operators correlating probe storms
                # across replicas read it here
                "cooldown_s": round(self._cooldown_s, 3),
            }
            if self._slo_advisories:
                out["slo_advisories"] = self._slo_advisories
                out["last_slo_trip"] = self._last_slo_trip
            return out
