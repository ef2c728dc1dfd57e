"""Decision backends — the seam where the LLM plugs in.

The reference's seam is `HuggingFaceClient.get_scheduling_decision`
(reference scheduler.py:377): everything above it (control loop) and around
it (cache, breaker, retries, fallback) survives any backend swap. This module
defines that seam as a protocol plus two in-tree backends:

- `StubBackend`: deterministic, dependency-free — scores feasible nodes like
  the resource_balanced fallback but reports as an LLM decision. Exists so
  control-loop tests and cold-start benches run with zero model weights
  (the "deterministic stub LLM backend" SURVEY §4 calls for).
- `LocalLLMBackend` (engine/local.py): the real TPU path — in-tree JAX Llama
  with constrained JSON decoding. Imported lazily to keep JAX out of
  pure-logic test processes.

There is deliberately NO HuggingFace-API backend: zero external API calls is
the north star (BASELINE.json).
"""

from __future__ import annotations

import time
from collections.abc import Sequence
from typing import Protocol, runtime_checkable

from k8s_llm_scheduler_tpu_torch.core.fallback import score_resource_balanced
from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
from k8s_llm_scheduler_tpu_torch.types import (
    DecisionSource,
    NodeMetrics,
    PodSpec,
    SchedulingDecision,
)


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


@runtime_checkable
class DecisionBackend(Protocol):
    """One decision per call. Implementations may batch internally."""

    def get_scheduling_decision(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics]
    ) -> SchedulingDecision:
        ...


class StubBackend:
    """Deterministic no-model backend for hermetic tests and dry runs.

    Picks the best feasible node by the resource-balanced score. Configurable
    failure injection: `fail_next` raises BackendError for the next N calls
    (to exercise retry/breaker paths); `latency_s` simulates decode time.
    """

    def __init__(
        self, latency_s: float = 0.0, pool_role: str = "mixed",
        sleep=time.sleep,
    ) -> None:
        self.latency_s = latency_s
        # injectable so chaos/virtual-time tests simulate a slow device
        # without wall-clock waits (the repo's injectable-clock rule,
        # tools/graftlint resilience family)
        self._sleep = sleep
        self.fail_next = 0
        self.calls = 0
        # Disaggregated-pool role parity with LocalLLMBackend
        # (fleet/pools.py): lets pool-routing tests and benches run with
        # zero model weights.
        if pool_role not in ("prefill", "decode", "mixed"):
            raise ValueError(
                f"pool_role {pool_role!r} not in ('prefill', 'decode', 'mixed')"
            )
        self.pool_role = pool_role
        self.role_refusals = 0
        self.batch_calls = 0

    def get_scheduling_decision(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics],
        work: str = "prefill",
    ) -> SchedulingDecision:
        if self.pool_role == "decode" and work == "prefill":
            self.role_refusals += 1
            raise BackendError(
                "pool role 'decode' refuses admission (prefill) work"
            )
        self.calls += 1
        if self.fail_next > 0:
            self.fail_next -= 1
            raise BackendError("injected stub failure")
        if self.latency_s:
            self._sleep(self.latency_s)
        start = time.perf_counter()
        candidates = feasible_nodes(pod, nodes)
        if not candidates:
            # No feasible node: report the fact rather than hallucinate.
            raise NoFeasibleNodeError(f"no feasible node for pod {pod.namespace}/{pod.name}")
        best = max(candidates, key=score_resource_balanced)
        return SchedulingDecision(
            selected_node=best.name,
            confidence=0.95,
            reasoning=f"stub: best resource-balanced score among {len(candidates)} feasible nodes",
            source=DecisionSource.LLM,
            latency_ms=(time.perf_counter() - start) * 1000.0,
        )

    def get_scheduling_decisions_batch(
        self, pods: Sequence[PodSpec], nodes: Sequence[NodeMetrics],
        work: str = "prefill",
    ) -> list["SchedulingDecision | Exception"]:
        """Prepacked-admission surface parity with LocalLLMBackend:
        positional per-pod outcomes, one bad pod never fails the batch."""
        self.batch_calls += 1
        out: list[SchedulingDecision | Exception] = []
        for pod in pods:
            try:
                out.append(self.get_scheduling_decision(pod, nodes, work=work))
            except Exception as exc:
                out.append(exc)
        return out
