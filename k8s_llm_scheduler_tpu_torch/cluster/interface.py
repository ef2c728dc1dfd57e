"""Cluster read/write protocols — the seam the reference never abstracted.

The reference talks to the Kubernetes API directly from three places:
ContextManager reads nodes (reference scheduler.py:109-187), the watch loop
streams pods (scheduler.py:657-666), and IntegrationLayer writes bindings
(scheduler.py:568-620). Here those become two small protocols so the control
loop runs identically against the real API (cluster/kube.py) and the
in-memory fake (cluster/fake.py) used by hermetic tests and benchmarks —
the test layer SURVEY §4 calls out as missing from the reference.
"""

from __future__ import annotations

import dataclasses
from collections.abc import AsyncIterator, Sequence
from typing import Any, Protocol, runtime_checkable

from k8s_llm_scheduler_tpu_torch.types import NodeMetrics, PodSpec
from k8s_llm_scheduler_tpu_torch.utils.units import parse_cpu, parse_memory_gb


@dataclasses.dataclass
class RawPod:
    """A pod as observed from the cluster, before unit normalization.

    Mirrors the fields `_convert_pod_to_spec` pulls off V1Pod
    (reference scheduler.py:731-764). Container requests keep their K8s
    quantity strings ("100m", "128Mi"); conversion happens in
    `raw_pod_to_spec` so parsing bugs are unit-testable without a cluster.
    """

    name: str
    namespace: str
    phase: str = "Pending"
    scheduler_name: str = ""
    node_name: str | None = None
    container_requests: tuple[dict[str, str], ...] = ()
    node_selector: dict[str, str] = dataclasses.field(default_factory=dict)
    tolerations: tuple[dict[str, Any], ...] = ()
    # Normalized required node affinity: {"node_affinity_terms": [[expr,..],..]}
    # (terms OR'd, expressions AND'd) — see core/validation.node_affinity_matches.
    affinity: dict[str, Any] = dataclasses.field(default_factory=dict)
    priority: int = 0
    uid: str = ""

    @property
    def needs_scheduling(self) -> bool:
        return self.phase == "Pending" and self.node_name is None


def raw_pod_to_spec(pod: RawPod) -> PodSpec:
    """Sum container requests with unit parsing (reference scheduler.py:737-753).

    Unparseable quantities count as zero rather than failing the pod — the
    scheduler must keep making progress on malformed specs.
    """
    cpu = 0.0
    mem = 0.0
    for req in pod.container_requests:
        try:
            cpu += parse_cpu(req.get("cpu"))
        except ValueError:
            pass
        try:
            mem += parse_memory_gb(req.get("memory"))
        except ValueError:
            pass
    return PodSpec(
        name=pod.name,
        namespace=pod.namespace,
        cpu_request=cpu,
        memory_request=mem,
        node_selector=dict(pod.node_selector),
        tolerations=tuple(pod.tolerations),
        # Live, unlike the reference (scheduler.py:762 always passes {}):
        # core/validation.feasible_nodes enforces required node affinity.
        affinity_rules=dict(pod.affinity),
        priority=pod.priority,
    )


@runtime_checkable
class ClusterState(Protocol):
    """Read side: node metrics snapshot + pending-pod watch stream."""

    def get_node_metrics(self) -> Sequence[NodeMetrics]:
        """Snapshot of all nodes (reference scheduler.py:121-170)."""
        ...

    def watch_pending_pods(self, scheduler_name: str) -> AsyncIterator[RawPod]:
        """Async stream of pods with phase==Pending, matching schedulerName,
        and no node assigned (filter parity: reference scheduler.py:674-676).
        The iterator ends when the cluster/watch shuts down."""
        ...


@runtime_checkable
class Binder(Protocol):
    """Write side: bind a pod to a node (reference scheduler.py:579-620)."""

    def bind_pod_to_node(self, pod_name: str, namespace: str, node_name: str) -> bool:
        ...
