"""Core data models for scheduling decisions.

Behavioral parity with the reference dataclasses (reference scheduler.py:72-104):
`NodeMetrics` (scheduler.py:73-84), `PodSpec` (scheduler.py:87-96) and
`SchedulingDecision` (scheduler.py:99-104). Extended with provenance fields
(decision latency, backend name, token counts) that the TPU inference path
reports for observability.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any


@dataclasses.dataclass(frozen=True)
class NodeMetrics:
    """Snapshot of one node's schedulable state.

    Mirrors reference scheduler.py:73-84. `cpu_usage_percent` /
    `memory_usage_percent` are whatever the ClusterState impl reports — the
    fake cluster reports exact values; the kubernetes impl synthesizes them
    from pod counts when metrics-server is absent (as the reference does at
    scheduler.py:149-151).
    """

    name: str
    cpu_usage_percent: float
    memory_usage_percent: float
    available_cpu_cores: float
    available_memory_gb: float
    pod_count: int
    max_pods: int
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    taints: tuple[dict[str, str], ...] = ()
    conditions: dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def is_ready(self) -> bool:
        """Ready iff the Ready condition is "True" (reference scheduler.py:532-535)."""
        return self.conditions.get("Ready") == "True"

    @property
    def cpu_free_percent(self) -> float:
        return 100.0 - self.cpu_usage_percent

    @property
    def memory_free_percent(self) -> float:
        return 100.0 - self.memory_usage_percent

    @property
    def pod_headroom_percent(self) -> float:
        if self.max_pods <= 0:
            return 0.0
        return 100.0 * (1.0 - self.pod_count / self.max_pods)


@dataclasses.dataclass(frozen=True)
class PodSpec:
    """Pending pod, reduced to what the decision model needs.

    Mirrors reference scheduler.py:87-96. Requests are normalized: CPU in
    cores (float), memory in GB — the unit parsing lives in utils/units.py.
    """

    name: str
    namespace: str
    cpu_request: float
    memory_request: float
    node_selector: dict[str, str] = dataclasses.field(default_factory=dict)
    tolerations: tuple[dict[str, Any], ...] = ()
    affinity_rules: dict[str, Any] = dataclasses.field(default_factory=dict)
    priority: int = 0


class DecisionSource(enum.Enum):
    """Where a decision came from — used for stats and tests."""

    LLM = "llm"
    CACHE = "cache"
    FALLBACK = "fallback"


@dataclasses.dataclass
class SchedulingDecision:
    """The decision model's answer for one pod.

    Mirrors reference scheduler.py:99-104 (selected_node, confidence,
    reasoning, fallback_needed) plus provenance for the TPU path.
    """

    selected_node: str
    confidence: float
    reasoning: str
    fallback_needed: bool = False
    source: DecisionSource = DecisionSource.LLM
    latency_ms: float = 0.0
    prompt_tokens: int = 0
    completion_tokens: int = 0

    def to_dict(self) -> dict[str, Any]:
        return {
            "selected_node": self.selected_node,
            "confidence": self.confidence,
            "reasoning": self.reasoning,
            "fallback_needed": self.fallback_needed,
            "source": self.source.value,
            "latency_ms": self.latency_ms,
        }
