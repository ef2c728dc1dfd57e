"""Real Kubernetes cluster interface via the official client.

A copy of the JAX package's cluster/kube.py. The official `kubernetes`
package stays behind its import gate; without it (the usual case for the
port) the in-tree REST transport, cluster/httpapi.py, is the driver.

Import-gated: the kubernetes package may be absent in hermetic environments;
`KubeCluster.available()` reports whether the driver can be used. All
behavior parity points:

- node metrics: list nodes, extract labels/taints/conditions and allocatable
  cpu/mem/pods (reference scheduler.py:121-170). The reference issues one
  list-pods API call *per node* to count pods (scheduler.py:144-147 — the N+1
  pattern SURVEY §7 flags); here a single list_pod_for_all_namespaces call is
  bucketed by spec.nodeName, so a 256-node snapshot costs 2 API calls, not 257.
- usage synthesis: (pods/max_pods)*50 when metrics-server is absent, exactly
  the reference's stand-in (scheduler.py:149-151).
- watch: list_pod_for_all_namespaces watch stream with timeout, filter
  phase==Pending ∧ schedulerName==ours ∧ nodeName unset
  (scheduler.py:657-676), bridged into asyncio via a reader thread so the
  event loop never blocks (the reference's "async" loop blocks on the watch
  generator, SURVEY §2 component 12).
- binding: V1Binding with target kind=Node, _preload_content=False to dodge
  the k8s-client Binding deserialization bug (scheduler.py:598-602).
- informer: while a watch is live, pod->node placements are maintained
  incrementally from the SAME event stream, so get_node_metrics becomes a
  cache read (zero API calls) between periodic full-relist reconciliations
  — at 256 nodes / 10k pods the full relist per snapshot TTL was the next
  scaling wall after the reference's N+1 (SURVEY §7).
- resourceVersion continuation: when a watch stream reaches its server-side
  timeout it RESUMES from the last observed resourceVersion (consuming
  bookmark events to keep that version fresh) instead of restarting from
  scratch — no event gap, no forced relist, matching real client-go
  reflector behavior. A 410 Gone (version expired server-side) falls back
  to one fresh-start watch plus a single reconciling relist.
- node watch: node-level changes (NotReady, taints, labels, add/remove)
  stream into the informer the same way pod placements do, so a node going
  NotReady is reflected in snapshots in event time rather than waiting out
  relist_interval_s.
"""

from __future__ import annotations

import asyncio
import logging
import queue as queue_mod
import threading
import time
from collections.abc import AsyncIterator, Sequence

from k8s_llm_scheduler_tpu_torch.cluster.interface import RawPod
from k8s_llm_scheduler_tpu_torch.types import NodeMetrics
from k8s_llm_scheduler_tpu_torch.utils.units import parse_cpu, parse_memory_gb

logger = logging.getLogger(__name__)

try:  # pragma: no cover - exercised only with a real cluster
    from kubernetes import client as k8s_client
    from kubernetes import config as k8s_config
    from kubernetes import watch as k8s_watch
    from kubernetes.client.rest import ApiException

    _KUBERNETES_AVAILABLE = True
    _KUBERNETES_DRIVER = "official"
except ImportError:
    # In-tree stdlib REST transport (cluster/httpapi.py): same attribute
    # surface, same wire paths — the scheduler runs against a real API
    # server with zero external dependencies. Wire-level tested against
    # cluster/wire_fake.py in tests/test_torch_kube_wire.py.
    from k8s_llm_scheduler_tpu_torch.cluster import httpapi as _httpapi

    class _HttpApiClientModule:
        CoreV1Api = _httpapi.CoreV1Api
        V1Binding = _httpapi.V1Binding
        V1ObjectMeta = _httpapi.V1ObjectMeta
        V1ObjectReference = _httpapi.V1ObjectReference

    class _HttpApiConfigModule:
        load_incluster_config = staticmethod(_httpapi.load_incluster_config)
        load_kube_config = staticmethod(_httpapi.load_kube_config)

    class _HttpApiWatchModule:
        Watch = _httpapi.Watch

    k8s_client = _HttpApiClientModule
    k8s_config = _HttpApiConfigModule
    k8s_watch = _HttpApiWatchModule
    ApiException = _httpapi.ApiException
    _KUBERNETES_AVAILABLE = True
    _KUBERNETES_DRIVER = "httpapi"


def _pod_to_raw(pod) -> RawPod:
    """V1Pod -> RawPod (field extraction parity: reference scheduler.py:731-764)."""
    spec = pod.spec
    requests = []
    for container in spec.containers or []:
        res = getattr(container, "resources", None)
        req = getattr(res, "requests", None) or {}
        requests.append({"cpu": req.get("cpu", ""), "memory": req.get("memory", "")})
    tolerations = tuple(
        {
            "key": t.key or "",
            "operator": t.operator or "",
            "value": t.value or "",
            "effect": t.effect or "",
        }
        for t in (spec.tolerations or [])
    )
    # Required node affinity -> the normalized terms form validation checks.
    # (The reference extracts affinity but always discards it,
    # scheduler.py:762.) Preferred affinity is scoring-only in K8s and the
    # decision model weighs load instead, so only `required` gates here.
    affinity: dict = {}
    node_aff = getattr(getattr(spec, "affinity", None), "node_affinity", None)
    required = getattr(
        node_aff, "required_during_scheduling_ignored_during_execution", None
    )
    terms = []
    for term in getattr(required, "node_selector_terms", None) or []:
        exprs = [
            {
                "key": e.key or "",
                "operator": e.operator or "In",
                "values": list(e.values or []),
            }
            for e in (term.match_expressions or [])
        ]
        # matchFields terms (K8s supports only metadata.name here) are kept
        # as field-tagged expressions so validation matches them against the
        # node name rather than silently dropping the constraint.
        exprs.extend(
            {
                "key": f.key or "",
                "operator": f.operator or "In",
                "values": list(f.values or []),
                "field": True,
            }
            for f in (getattr(term, "match_fields", None) or [])
        )
        terms.append(exprs)
    # NB: `if terms`, not `if any(terms)`: an all-empty term list must be
    # KEPT — K8s treats an empty nodeSelectorTerm as match-nothing, and
    # node_affinity_matches preserves that (empty term is falsy).
    if terms:
        affinity = {"node_affinity_terms": terms}
    return RawPod(
        name=pod.metadata.name,
        namespace=pod.metadata.namespace,
        phase=pod.status.phase or "Unknown",
        scheduler_name=spec.scheduler_name or "",
        node_name=spec.node_name,
        container_requests=tuple(requests),
        node_selector=dict(spec.node_selector or {}),
        tolerations=tolerations,
        affinity=affinity,
        priority=spec.priority or 0,
        uid=pod.metadata.uid or "",
    )


class KubeCluster:
    """ClusterState + Binder against a real K8s API server.

    Hermetically tested with a scripted fake kubernetes module
    (tests/test_kube_cluster.py); only the import gate above needs a real
    package."""

    def __init__(
        self,
        watch_timeout_seconds: int = 60,
        informer: bool = True,
        relist_interval_s: float = 30.0,
        resume_rv: str | None = None,
        rv_hook=None,
    ) -> None:
        try:
            k8s_config.load_incluster_config()
        except Exception:
            k8s_config.load_kube_config()
        self._v1 = k8s_client.CoreV1Api()
        # Durable watch continuity (sched/journal.py): `resume_rv` seeds
        # the FIRST pod watch stream with a journaled resourceVersion —
        # events that arrived while the process was dead are delivered
        # instead of skipped, and the informer's first snapshot pays one
        # reconciling relist (it starts with no baseline, so the
        # freshness check forces the relist by construction). An expired
        # resume rv degrades through the normal 410 path: one fresh
        # start plus a relist. `rv_hook(rv)` fires per pod-watch event
        # (bookmarks included) so a journal can record the live resume
        # point; node watches never feed it (their rv is a different
        # resume space).
        self._resume_rv = resume_rv
        self.rv_hook = rv_hook
        self._watch_timeout = watch_timeout_seconds
        self._stop = threading.Event()
        # Informer cache: node facts + incremental pod->node placements
        # maintained from the watch stream, reconciled by a full relist
        # every `relist_interval_s` (or whenever the watch is down — a
        # dropped stream may have missed events).
        self._informer = bool(informer)
        self._relist_interval = float(relist_interval_s)
        self._inf_lock = threading.Lock()
        self._inf_nodes: list[dict] | None = None  # parsed static node facts
        self._inf_counts: dict[str, int] = {}
        self._inf_pod_node: dict[tuple[str, str], str] = {}
        # Placement deltas since the last relist: a relist's API responses
        # race the watch reader, so deltas folded while the list calls were
        # in flight are REPLAYED over the listed snapshot (events observed
        # during a list win — standard reflector behavior). Entries carry a
        # monotonically increasing sequence number so the replay cut point
        # survives the runaway-guard front truncation (list indices would
        # shift under it and replay the wrong slice).
        self._inf_seq = 0
        self._inf_journal: list[tuple[int, tuple[str, str], str | None]] = []
        self._inf_last_relist = 0.0
        # True only once the watch stream has PROVEN healthy (first event /
        # bookmark observed, or a clean server-side timeout with rv
        # continuation — a stream that connects but silently stalls before
        # any event never flips this). Written under _inf_lock. A stream
        # that stalls AFTER events is still bounded by relist_interval_s:
        # freshness requires a relist within that window regardless.
        self._inf_watch_live = False

    @staticmethod
    def available() -> bool:
        """Always True since the in-tree httpapi fallback (a driver is
        always importable; reaching a cluster is decided at construction).
        Kept for API stability; see driver() for which client is active."""
        return _KUBERNETES_AVAILABLE

    @staticmethod
    def driver() -> str:
        """'official' (kubernetes package) or 'httpapi' (in-tree REST)."""
        return _KUBERNETES_DRIVER

    # ----------------------------------------------------------- ClusterState
    def get_node_metrics(self) -> Sequence[NodeMetrics]:
        """Per-node metrics snapshot.

        While the informer is fresh (watch live, last full relist within
        relist_interval_s) this is a pure cache read — ZERO API calls per
        snapshot, vs 2 for the round-2 bucketed relist and N+1 for the
        reference (scheduler.py:144-147). Stale or watchless, it falls back
        to a full relist that also reconciles the incremental state."""
        if self._informer:
            with self._inf_lock:
                fresh = (
                    self._inf_nodes is not None
                    and self._inf_watch_live
                    and time.monotonic() - self._inf_last_relist
                    < self._relist_interval
                )
                if fresh:
                    return self._metrics_from_cache_locked()
        return self._relist()

    @staticmethod
    def _parse_node(node) -> dict:
        """Static node facts (everything but the pod count)."""
        allocatable = node.status.allocatable or {}
        return {
            "name": node.metadata.name,
            "cpu_cores": parse_cpu(allocatable.get("cpu", "0")),
            "mem_gb": parse_memory_gb(allocatable.get("memory", "0")),
            "max_pods": int(parse_cpu(allocatable.get("pods", "110"))),
            "labels": dict(node.metadata.labels or {}),
            "taints": tuple(
                {
                    "key": t.key or "",
                    "value": t.value or "",
                    "effect": t.effect or "",
                }
                for t in (node.spec.taints or [])
            ),
            "conditions": {
                c.type: c.status for c in (node.status.conditions or [])
            },
        }

    def _metrics_from_cache_locked(self) -> list[NodeMetrics]:
        out = []
        for rec in self._inf_nodes or []:
            pod_count = self._inf_counts.get(rec["name"], 0)
            max_pods = rec["max_pods"]
            # usage synthesis parity with the reference (scheduler.py:149-151)
            synthesized = (pod_count / max_pods) * 50.0 if max_pods else 0.0
            out.append(
                NodeMetrics(
                    name=rec["name"],
                    cpu_usage_percent=synthesized,
                    memory_usage_percent=synthesized,
                    available_cpu_cores=rec["cpu_cores"],
                    available_memory_gb=rec["mem_gb"],
                    pod_count=pod_count,
                    max_pods=max_pods,
                    labels=rec["labels"],
                    taints=rec["taints"],
                    conditions=rec["conditions"],
                )
            )
        return out

    def _relist(self) -> list[NodeMetrics]:
        """Full reconciliation: ONE list-nodes + ONE list-pods call (never
        one call per node — the reference's N+1). Deltas journaled by the
        watch/bind paths while the list calls were in flight are replayed
        over the listed snapshot so concurrent events are not lost. The
        replay cut point is a sequence number, not a list index, so the
        journal's runaway-guard truncation can never shift it."""
        with self._inf_lock:
            seq0 = self._inf_seq
        nodes = self._v1.list_node().items
        pods = self._v1.list_pod_for_all_namespaces().items
        counts: dict[str, int] = {}
        pod_node: dict[tuple[str, str], str] = {}
        for pod in pods:
            node_name = pod.spec.node_name
            # Skip terminal pods, matching _informer_observe: a completed
            # Job pod holds no scheduling capacity, and counting it only in
            # relists made pod_count flap every reconciliation (the
            # synthesized usage percent and the decision-cache digest with
            # it). Deliberate divergence from the reference, which counts
            # every placed pod (scheduler.py:144-147).
            phase = getattr(getattr(pod, "status", None), "phase", None) or ""
            if node_name and phase not in ("Succeeded", "Failed"):
                counts[node_name] = counts.get(node_name, 0) + 1
                meta = getattr(pod, "metadata", None)
                if meta is not None:
                    pod_node[(meta.namespace, meta.name)] = node_name
        parsed = [self._parse_node(n) for n in nodes]
        with self._inf_lock:
            replay = [e for e in self._inf_journal if e[0] > seq0]
            self._inf_nodes = parsed
            self._inf_counts = counts
            self._inf_pod_node = pod_node
            self._inf_journal = []
            for _seq, key, node in replay:
                self._place_pod_locked(key, node)
            self._inf_last_relist = time.monotonic()
            return self._metrics_from_cache_locked()

    def _place_pod_locked(
        self, key: tuple[str, str], node: str | None, journal: bool = False
    ) -> None:
        """Move pod `key` to `node` (None = gone) in the placement map,
        maintaining per-node counts. Idempotent per (key, node). The single
        implementation behind watch events, optimistic binds, and relist
        replay."""
        old = self._inf_pod_node.get(key)
        if node == old:
            return
        if old is not None:
            self._inf_counts[old] = max(0, self._inf_counts.get(old, 0) - 1)
            del self._inf_pod_node[key]
        if node:
            self._inf_pod_node[key] = node
            self._inf_counts[node] = self._inf_counts.get(node, 0) + 1
        if journal:
            self._inf_seq += 1
            self._inf_journal.append((self._inf_seq, key, node))
            if len(self._inf_journal) > 100_000:  # relist-gap runaway guard
                del self._inf_journal[:50_000]

    def _informer_observe_node(self, etype: str, node) -> None:
        """Fold one node watch event into the cached node facts. Upserts by
        name (ADDED/MODIFIED), drops on DELETED. No-op until the first
        relist establishes a baseline list. Node events racing a relist's
        in-flight list call can be overwritten by the (older) list result;
        the next event or relist reconciles — node facts have no journal
        because the damage window is one relist_interval_s at worst and
        node mutations are orders of magnitude rarer than pod churn."""
        try:
            name = node.metadata.name
        except AttributeError:
            return
        with self._inf_lock:
            if self._inf_nodes is None:
                return
            if etype == "DELETED":
                self._inf_nodes = [
                    r for r in self._inf_nodes if r["name"] != name
                ]
                return
            rec = self._parse_node(node)
            for i, old in enumerate(self._inf_nodes):
                if old["name"] == name:
                    self._inf_nodes[i] = rec
                    break
            else:
                self._inf_nodes.append(rec)

    def _informer_observe(self, etype: str, pod) -> None:
        """Fold one watch event into the pod->node placement map. Keyed by
        (namespace, name), so replayed ADDED events and repeated MODIFIEDs
        are idempotent."""
        if not self._informer:
            return
        try:
            key = (pod.metadata.namespace, pod.metadata.name)
            node = pod.spec.node_name
        except AttributeError:
            return
        gone = etype == "DELETED" or (pod.status.phase or "") in (
            "Succeeded",
            "Failed",
        )
        with self._inf_lock:
            self._place_pod_locked(key, None if gone else node, journal=True)

    def _mark_stale_locked_free(self) -> None:
        """A broken stream may have dropped events: mark the informer stale
        so the next snapshot relists."""
        with self._inf_lock:
            self._inf_watch_live = False
            self._inf_last_relist = 0.0

    def _mark_live(self) -> None:
        with self._inf_lock:
            self._inf_watch_live = True

    @staticmethod
    def _event_rv(obj) -> str | None:
        return getattr(getattr(obj, "metadata", None), "resource_version", None)

    def _stream_kwargs(self, rv: str | None) -> dict:
        """Watch kwargs: rv=None is a fresh start (the server replays the
        current state as synthetic ADDED events — how pre-existing pending
        pods are picked up); a concrete rv RESUMES exactly after the last
        observed event. Bookmarks keep the rv current through quiet spells
        so a resume after the server-side timeout never lands on an
        expired version."""
        kwargs = {
            "timeout_seconds": self._watch_timeout,
            "allow_watch_bookmarks": True,
        }
        if rv is not None:
            kwargs["resource_version"] = rv
        return kwargs

    class _WatchExpired(Exception):
        """410 Gone delivered as an in-stream ERROR event."""

    @classmethod
    def _check_error_event(cls, etype: str, obj) -> None:
        if etype == "ERROR":
            code = getattr(obj, "code", None)
            if code is None and isinstance(obj, dict):
                code = obj.get("code")
            if code == 410:
                raise cls._WatchExpired()
            raise RuntimeError(f"watch ERROR event: {obj!r}")

    @staticmethod
    def _is_gone(exc: Exception) -> bool:
        return getattr(exc, "status", None) == 410

    def _watch_cycle(
        self, list_fn, rv: str | None, stopping, on_event, on_alive=None,
        on_rv=None,
    ) -> tuple[str | None, bool, str]:
        """ONE watch stream to completion — the rv/bookmark/410 state
        machine shared by the pod and node readers. `on_event(etype, obj)`
        fires per non-bookmark event; `on_alive()` once at the stream's
        first event (bookmarks included — a bookmark proves the stream
        healthy on quiet clusters). Returns (rv, saw_event, outcome) with
        outcome 'clean' (server-side timeout or stop; resume from rv),
        'expired' (410: caller must fresh-start), or 'error' (unknown
        failure: caller backs off and may mark state stale)."""
        saw_event = False
        try:
            w = k8s_watch.Watch()
            for event in w.stream(list_fn, **self._stream_kwargs(rv)):
                if stopping():
                    break
                etype = event.get("type", "")
                obj = event["object"]
                self._check_error_event(etype, obj)
                new_rv = self._event_rv(obj)
                if new_rv is not None:
                    rv = new_rv
                    if on_rv is not None:
                        try:
                            on_rv(new_rv)
                        except Exception:
                            logger.exception("rv hook failed")
                if not saw_event:
                    saw_event = True
                    if on_alive is not None:
                        on_alive()
                if etype != "BOOKMARK":
                    on_event(etype, obj)
            return rv, saw_event, "clean"
        except self._WatchExpired:
            return None, saw_event, "expired"
        except Exception as exc:
            if self._is_gone(exc):
                return None, saw_event, "expired"
            logger.warning(
                "%s watch stream error, re-watching: %s",
                getattr(list_fn, "__name__", "watch"), exc,
            )
            return rv, saw_event, "error"

    async def watch_pending_pods(self, scheduler_name: str) -> AsyncIterator[RawPod]:
        """Watch stream bridged thread->asyncio so the loop stays responsive.

        Each generator starts its first stream FRESH (rv unset — the server
        replays current state, so pending pods that predate this watch are
        observed), then RESUMES from the last seen resourceVersion across
        the server-side timeouts — no event gap, so the informer stays
        fresh and snapshots keep costing zero API calls across arbitrarily
        many timeout cycles. 410 Gone (version expired) degrades to one
        fresh start plus a single reconciling relist. When the informer is
        enabled a second reader watches NODES the same way, folding
        NotReady/taint/label/add/remove changes into the cache in event
        time.

        Cleanup contract: abandoning/aclosing the generator stops the reader
        threads (their stop event is per-watch, so the cluster object can be
        watched again), and the bounded queue + timeout-polling get mean no
        thread is ever parked forever on an abandoned watch.
        """
        sync_queue: queue_mod.Queue[RawPod | None] = queue_mod.Queue(maxsize=1024)
        stop = threading.Event()

        def stopping() -> bool:
            return stop.is_set() or self._stop.is_set()

        def on_pod_event(etype: str, obj) -> None:
            # Feed the informer from the SAME stream the scheduler already
            # pays for: every event updates pod->node placements, so
            # snapshots between relists cost zero API calls.
            self._informer_observe(etype, obj)
            raw = _pod_to_raw(obj)
            if raw.needs_scheduling and raw.scheduler_name == scheduler_name:
                while not stopping():
                    try:
                        sync_queue.put(raw, timeout=0.5)
                        break
                    except queue_mod.Full:
                        continue

        def reader() -> None:
            # journaled resume point (consumed exactly once: a later
            # generator on the same cluster starts fresh — the journal's
            # rv has gone stale the moment a live stream advanced it)
            rv: str | None = self._resume_rv
            self._resume_rv = None
            if rv is not None:
                # THE reconciling relist of the recovery protocol: the
                # resumed stream replays only events AFTER the journaled
                # rv, so pods already Pending before it — observed by
                # the dead incarnation, never decided — would otherwise
                # strand. One list re-offers current state; downstream
                # is idempotent (the scheduler dedups in-flight pods,
                # bound pods fail needs_scheduling), so the overlap
                # between list and resumed stream is harmless.
                try:
                    for pod in self._v1.list_pod_for_all_namespaces().items:
                        on_pod_event("ADDED", pod)
                except Exception:
                    logger.warning(
                        "resume relist failed; degrading to a fresh "
                        "watch start"
                    )
                    rv = None
            while not stopping():
                was_fresh = rv is None
                rv, saw_event, outcome = self._watch_cycle(
                    self._v1.list_pod_for_all_namespaces, rv, stopping,
                    on_pod_event, on_alive=self._mark_live,
                    on_rv=self.rv_hook,
                )
                if outcome == "clean":
                    # Clean server-side timeout. With a concrete rv the
                    # next stream resumes gaplessly; rv=None means the next
                    # stream is a fresh state replay — either way the
                    # stream proved healthy end to end.
                    self._mark_live()
                    if not saw_event:
                        # empty stream: yield briefly so a server that
                        # closes streams immediately can't hot-loop us
                        stop.wait(0.02)
                elif outcome == "expired":
                    # An EXPIRED rv is not a server-health signal: restart
                    # fresh IMMEDIATELY (client-go relist-and-rewatch), so
                    # the stale window costs one reconciling relist, not a
                    # backoff's worth of them. But a 410 against an
                    # ALREADY-fresh start means the server itself is sick —
                    # that gets the self-heal backoff, or we'd hot-loop the
                    # API at unbounded rate.
                    logger.warning(
                        "watch resourceVersion expired (410); fresh start + relist"
                    )
                    self._mark_stale_locked_free()
                    if was_fresh:
                        stop.wait(5.0)
                else:
                    # Self-heal: brief sleep + re-watch (reference
                    # scheduler.py:683-685); events may have been dropped.
                    self._mark_stale_locked_free()
                    stop.wait(5.0)
            with self._inf_lock:
                self._inf_watch_live = False
            try:
                sync_queue.put_nowait(None)
            except queue_mod.Full:
                pass

        def node_reader() -> None:
            """Node facts ride their own watch; same rv/bookmark/410
            discipline via _watch_cycle. Errors here never force relists —
            the pod watch owns informer freshness; stale node facts
            self-bound at one relist_interval_s."""
            rv: str | None = None
            while not stopping():
                was_fresh = rv is None
                rv, saw_event, outcome = self._watch_cycle(
                    self._v1.list_node, rv, stopping,
                    self._informer_observe_node,
                )
                if outcome == "clean":
                    if not saw_event:
                        stop.wait(0.02)
                elif outcome == "expired" and not was_fresh:
                    pass  # expired rv: immediate fresh-start re-watch
                else:  # unknown error, or 410 against a fresh start
                    stop.wait(5.0)

        def poll_get() -> RawPod | None:
            """Blocking get with a timeout loop so the executor thread can
            notice a stopped watch instead of parking forever."""
            while True:
                try:
                    return sync_queue.get(timeout=0.5)
                except queue_mod.Empty:
                    if stop.is_set() or self._stop.is_set():
                        return None

        thread = threading.Thread(target=reader, daemon=True, name="k8s-watch")
        thread.start()
        if self._informer:
            node_thread = threading.Thread(
                target=node_reader, daemon=True, name="k8s-node-watch"
            )
            node_thread.start()
        loop = asyncio.get_running_loop()
        try:
            while True:
                raw = await loop.run_in_executor(None, poll_get)
                if raw is None:
                    return
                yield raw
        finally:
            stop.set()

    def close(self) -> None:
        self._stop.set()

    def recovery_lookup(self):
        """Recovery's cluster-truth probe (sched/recovery.PodLookup):
        ONE list call snapshots every pod's spec.nodeName, and the
        returned closure answers ("bound", node) / ("pending", None) /
        ("gone", None) from it. One snapshot is correct for a whole
        recovery pass: the restarting process is the only thing acting
        on its open lifecycles, and each lifecycle is a distinct pod —
        per-lookup listing would transfer the full pod set once per
        open lifecycle for the same answers."""
        try:
            pods = self._v1.list_pod_for_all_namespaces().items
        except Exception as exc:
            raise RuntimeError(f"recovery lookup list failed: {exc}") from exc
        nodes: dict[tuple[str, str], str | None] = {}
        for pod in pods:
            meta = getattr(pod, "metadata", None)
            if meta is None:
                continue
            nodes[(meta.namespace, meta.name)] = pod.spec.node_name

        def lookup(namespace: str, name: str) -> tuple[str, str | None]:
            if (namespace, name) not in nodes:
                return ("gone", None)
            node = nodes[(namespace, name)]
            return ("bound", node) if node else ("pending", None)

        return lookup

    def lookup_pod_node(
        self, namespace: str, name: str
    ) -> tuple[str, str | None]:
        """One-off probe (same contract); spot checks and tests — a
        recovery pass over many lifecycles uses recovery_lookup()."""
        return self.recovery_lookup()(namespace, name)

    # ---------------------------------------------------------------- Binder
    def bind_pod_to_node(self, pod_name: str, namespace: str, node_name: str) -> bool:
        binding = k8s_client.V1Binding(
            metadata=k8s_client.V1ObjectMeta(name=pod_name, namespace=namespace),
            target=k8s_client.V1ObjectReference(
                api_version="v1", kind="Node", name=node_name
            ),
        )
        try:
            self._v1.create_namespaced_binding(
                namespace=namespace, body=binding, _preload_content=False
            )
            # Optimistic informer update: the MODIFIED watch event takes a
            # beat to arrive, but back-to-back decisions in a burst should
            # see this pod on its node immediately (idempotent with the
            # event when it lands — same (ns, name) key).
            if self._informer:
                with self._inf_lock:
                    self._place_pod_locked(
                        (namespace, pod_name), node_name, journal=True
                    )
            return True
        except ApiException as exc:
            logger.error(
                "binding failed pod=%s/%s node=%s status=%s reason=%s",
                namespace,
                pod_name,
                node_name,
                getattr(exc, "status", "?"),
                getattr(exc, "reason", "?"),
            )
            return False
