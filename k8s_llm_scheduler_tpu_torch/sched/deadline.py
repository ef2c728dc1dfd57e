"""Per-decision deadline budgets — the currency of graceful degradation.

A scheduling decision is only worth computing while someone is still
waiting for it: a bind that lands after the pod's effective deadline is
indistinguishable from a failed bind to the workload, and a backend that
is 10x slow turns a burst into a pile-up of decisions nobody can use.
This module gives every decision a BUDGET that rides with it through the
whole pipeline:

- `DeadlineBudget` is a start-time + total-ms record; `remaining_ms()`
  is the only question anyone asks it.
- The budget propagates AMBIENTLY via a contextvar (same discipline as
  observability/spans): `running(budget)` installs it for a scope,
  `current_budget()` reads it anywhere downstream — including the
  replica wire client, which stamps the REMAINING budget onto the
  decision frame (`deadline_ms`); the worker server restarts a budget
  from that remainder (wire transit has already been spent by the
  sender) and re-installs it around its backend call. An already-expired
  frame is refused with a typed `DeadlineExceededError` instead of
  burning a wave on a dead decision.
- `DecisionClient` (sched/client.py) steps a degradation LADDER by the
  remaining budget: full LLM decision while the budget affords one,
  cached decision when one exists (always consulted first — it is free),
  heuristic fallback when the budget (or an SLO brownout) says the model
  rung is no longer affordable. Shedding beats timing out: an overloaded
  backend degrades decision QUALITY, never decision delivery.

Clock discipline: budgets are judged on an injectable monotonic clock so
chaos/virtual-time tests can reason about expiry without sleeping.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from typing import Callable, Iterator

# Degradation ladder rungs, best to cheapest. The ladder is stepped by
# remaining budget and by SLO brownout (sched/client.py); the rung that
# answered is stamped on the decision trace as `degraded` meta.
LADDER = ("llm", "cached", "heuristic")


class DeadlineExceededError(RuntimeError):
    """A decision's budget expired before (or while) the backend could
    serve it. NOT a backend-health failure — the breaker must not count
    it (an overloaded caller is not a sick device), and the client
    degrades to the next ladder rung instead of retrying."""


@dataclasses.dataclass
class DeadlineBudget:
    """One decision's time allowance. `started` is a reading of `clock`
    (monotonic); all judgments are deltas against it."""

    total_ms: float
    started: float
    clock: Callable[[], float] = time.monotonic

    @classmethod
    def start(
        cls, total_ms: float, clock: Callable[[], float] = time.monotonic
    ) -> "DeadlineBudget":
        return cls(total_ms=float(total_ms), started=clock(), clock=clock)

    def remaining_ms(self) -> float:
        return self.total_ms - (self.clock() - self.started) * 1000.0

    @property
    def expired(self) -> bool:
        return self.remaining_ms() <= 0.0


_current: contextvars.ContextVar[DeadlineBudget | None] = contextvars.ContextVar(
    "decision_deadline_budget", default=None
)


def current_budget() -> DeadlineBudget | None:
    """The ambient budget, if any scope installed one."""
    return _current.get()


@contextlib.contextmanager
def running(budget: DeadlineBudget | None) -> Iterator[DeadlineBudget | None]:
    """Install `budget` as the ambient budget for the scope. None is
    allowed (and a no-op install) so callers can write one with-block
    whether or not a deadline is configured."""
    token = _current.set(budget)
    try:
        yield budget
    finally:
        _current.reset(token)


def remaining_ms() -> float | None:
    """Remaining ambient budget in ms, or None when no budget is set —
    the value the replica wire stamps on decision frames."""
    budget = _current.get()
    return None if budget is None else budget.remaining_ms()
