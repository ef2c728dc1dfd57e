"""Decision-backend errors (copied from the JAX package's engine/backend.py).

The backend seam itself is the reference's
`HuggingFaceClient.get_scheduling_decision` (reference scheduler.py:377);
the port's only backend so far is `LocalLLMBackend` (engine/local.py).
"""

from __future__ import annotations


class BackendError(RuntimeError):
    """A backend failed to produce a decision (model error, device lost…).

    Counts as a breaker failure: repeated BackendErrors open the circuit.
    """


class NoFeasibleNodeError(RuntimeError):
    """The pod cannot legally run anywhere right now.

    A property of the POD, not of the backend — deliberately NOT a
    BackendError subclass so one chronically unschedulable pod never trips
    the circuit breaker and poisons scheduling for healthy pods. The breaker
    guards device health only.
    """
