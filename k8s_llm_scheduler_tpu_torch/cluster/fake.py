"""In-memory fake cluster — the hermetic test substrate.

The reference has no fake: its only tests run against a live Minikube and the
real HF API (SURVEY §4). This fake implements both ClusterState and Binder so
the whole control loop — watch, snapshot, decide, bind — runs in-process with
no network, and doubles as the load generator for bench.py (1000-pod bursts
against a 256-node synthetic cluster, the BASELINE stress configs).

Semantics mirrored from the reference:
- node metrics synthesis: when a node has no explicit usage set, usage% is
  derived from pod count as (pods/max_pods)*50, exactly the reference's
  stand-in for metrics-server (scheduler.py:149-151);
- binding sets the pod's nodeName and flips it to Running, which is what a
  kubelet would eventually do to the reference's fixture pods
  (test_e2e.py:126-135 asserts that end state);
- the watch stream delivers currently-pending pods and then live additions,
  like a K8s watch with an initial list.

Failure injection (`fail_next_bindings`, `freeze_nodes`) exists for the
resilience tests the reference's CONTRIBUTING.md:27-31 asks for but never
implements.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import threading
from collections.abc import AsyncIterator, Sequence

from k8s_llm_scheduler_tpu_torch.cluster.interface import RawPod
from k8s_llm_scheduler_tpu_torch.types import NodeMetrics


@dataclasses.dataclass
class FakeNode:
    name: str
    cpu_capacity_cores: float = 8.0
    memory_capacity_gb: float = 32.0
    max_pods: int = 110
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    taints: tuple[dict[str, str], ...] = ()
    ready: bool = True
    # Explicit usage overrides; None -> synthesized from pod count.
    cpu_usage_percent: float | None = None
    memory_usage_percent: float | None = None


class FakeCluster:
    """ClusterState + Binder backed by dicts and an asyncio watch queue."""

    # Binds are lock+dict operations — the scheduler loop may call them
    # inline on the event loop instead of paying an executor round trip.
    bind_is_nonblocking = True

    def __init__(self) -> None:
        self._nodes: dict[str, FakeNode] = {}
        self._pods: dict[tuple[str, str], RawPod] = {}
        self._lock = threading.Lock()
        # (queue, owning event loop) — pushes from foreign threads must go
        # through call_soon_threadsafe (asyncio.Queue is not thread-safe).
        self._watchers: list[tuple[asyncio.Queue[RawPod | None], asyncio.AbstractEventLoop]] = []
        self._uid_counter = itertools.count(1)
        self.fail_next_bindings = 0
        self.bind_count = 0
        self.bindings: list[tuple[str, str, str]] = []  # (namespace, pod, node)

    # ------------------------------------------------------------- topology
    def add_node(self, node: FakeNode) -> None:
        with self._lock:
            self._nodes[node.name] = node

    def add_nodes(self, count: int, prefix: str = "node", **kwargs) -> None:
        for i in range(count):
            self.add_node(FakeNode(name=f"{prefix}-{i}", **kwargs))

    def freeze_nodes(self, *names: str) -> None:
        """Mark nodes NotReady (failure injection)."""
        with self._lock:
            for name in names:
                if name in self._nodes:
                    self._nodes[name].ready = False

    # ----------------------------------------------------------------- pods
    def add_pod(self, pod: RawPod) -> None:
        """Add a pod; pending pods are pushed to all watch streams."""
        if not pod.uid:
            pod = dataclasses.replace(pod, uid=f"uid-{next(self._uid_counter)}")
        with self._lock:
            self._pods[(pod.namespace, pod.name)] = pod
            watchers = list(self._watchers)
        if pod.needs_scheduling:
            for queue, loop in watchers:
                self._deliver(queue, loop, pod)

    def get_pod(self, namespace: str, name: str) -> RawPod | None:
        with self._lock:
            return self._pods.get((namespace, name))

    def pods_on_node(self, node_name: str) -> int:
        with self._lock:
            return sum(1 for p in self._pods.values() if p.node_name == node_name)

    def pending_pods(self, scheduler_name: str | None = None) -> list[RawPod]:
        with self._lock:
            return [
                p
                for p in self._pods.values()
                if p.needs_scheduling
                and (scheduler_name is None or p.scheduler_name == scheduler_name)
            ]

    # ----------------------------------------------------------- ClusterState
    def get_node_metrics(self) -> Sequence[NodeMetrics]:
        """One snapshot, one pass over the pod store — no N+1 API pattern
        (the reference issues one list-pods call per node,
        scheduler.py:144-147)."""
        with self._lock:
            counts: dict[str, int] = {name: 0 for name in self._nodes}
            for pod in self._pods.values():
                if pod.node_name in counts:
                    counts[pod.node_name] += 1
            out = []
            for node in self._nodes.values():
                pods = counts[node.name]
                synthesized = (pods / node.max_pods) * 50.0 if node.max_pods else 0.0
                cpu_pct = (
                    node.cpu_usage_percent
                    if node.cpu_usage_percent is not None
                    else synthesized
                )
                mem_pct = (
                    node.memory_usage_percent
                    if node.memory_usage_percent is not None
                    else synthesized
                )
                out.append(
                    NodeMetrics(
                        name=node.name,
                        cpu_usage_percent=cpu_pct,
                        memory_usage_percent=mem_pct,
                        available_cpu_cores=node.cpu_capacity_cores,
                        available_memory_gb=node.memory_capacity_gb,
                        pod_count=pods,
                        max_pods=node.max_pods,
                        labels=dict(node.labels),
                        taints=node.taints,
                        conditions={"Ready": "True" if node.ready else "False"},
                    )
                )
            return out

    async def watch_pending_pods(self, scheduler_name: str) -> AsyncIterator[RawPod]:
        """Initial list of pending pods, then live additions (K8s watch shape,
        reference scheduler.py:657-676). Ends on close()."""
        queue: asyncio.Queue[RawPod | None] = asyncio.Queue()
        entry = (queue, asyncio.get_running_loop())
        with self._lock:
            self._watchers.append(entry)
            backlog = [p for p in self._pods.values() if p.needs_scheduling]
        try:
            for pod in backlog:
                if pod.scheduler_name == scheduler_name:
                    yield pod
            while True:
                pod = await queue.get()
                if pod is None:
                    return
                if pod.scheduler_name == scheduler_name and pod.needs_scheduling:
                    yield pod
        finally:
            with self._lock:
                if entry in self._watchers:
                    self._watchers.remove(entry)

    @staticmethod
    def _deliver(
        queue: asyncio.Queue, loop: asyncio.AbstractEventLoop, item: RawPod | None
    ) -> None:
        """Thread-safe push to a watcher queue."""
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            queue.put_nowait(item)
        else:
            loop.call_soon_threadsafe(queue.put_nowait, item)

    def close(self) -> None:
        """End all watch streams."""
        with self._lock:
            watchers = list(self._watchers)
        for queue, loop in watchers:
            self._deliver(queue, loop, None)

    # ---------------------------------------------------------------- Binder
    def bind_pod_to_node(self, pod_name: str, namespace: str, node_name: str) -> bool:
        """Bind parity with reference scheduler.py:579-620; the fake also
        flips the pod to Running (what the kubelet would do)."""
        with self._lock:
            if self.fail_next_bindings > 0:
                self.fail_next_bindings -= 1
                return False
            pod = self._pods.get((namespace, pod_name))
            if pod is None or node_name not in self._nodes:
                return False
            if pod.node_name is not None:
                return False  # already bound
            self._pods[(namespace, pod_name)] = dataclasses.replace(
                pod, node_name=node_name, phase="Running"
            )
            self.bind_count += 1
            self.bindings.append((namespace, pod_name, node_name))
            return True
