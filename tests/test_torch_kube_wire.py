"""The port's wire-level Kubernetes client held against the JAX package's:
each package's `KubeCluster` over its in-tree REST transport
(cluster/httpapi.py) against its own `WireFakeK8s` (a fake API server
speaking real HTTP), driven through the same scenario, must see the same
nodes, pending pods, binds and watch resumes. The cases are those of
tests/test_kube_wire.py: K8sObject's attribute protocol, kubeconfig
parsing, list + binding (409 on a double bind), watch events and
bookmarks, the in-stream 410, snapshot parsing, the watch + informer +
binding loop, resourceVersion resume, the 410 fallback, and the
reference's E2E verdict (every fixture pod scheduled AND running) through
each package's scheduler."""

import asyncio
import dataclasses
import types

import pytest

import k8s_llm_scheduler_tpu.cluster.httpapi as jhttp
import k8s_llm_scheduler_tpu.cluster.kube as jkube
import k8s_llm_scheduler_tpu.cluster.wire_fake as jwire
import k8s_llm_scheduler_tpu_torch.cluster.httpapi as thttp
import k8s_llm_scheduler_tpu_torch.cluster.kube as tkube
import k8s_llm_scheduler_tpu_torch.cluster.wire_fake as twire
from k8s_llm_scheduler_tpu_torch.testing import async_deadline, cap_torch_threads

cap_torch_threads()

SCHED = "ai-llama-scheduler"
PKGS = {
    "jax": types.SimpleNamespace(http=jhttp, kube=jkube, wire=jwire, root="k8s_llm_scheduler_tpu"),
    "torch": types.SimpleNamespace(http=thttp, kube=tkube, wire=twire,
                                   root="k8s_llm_scheduler_tpu_torch"),
}
# Every poll below ends by this deadline. A poll ends as soon as its event
# happens, so the limit costs nothing when things work; it is set where the
# load of a parallel test run cannot reach it.
WAIT_S = 120.0
SNAPSHOT_TTL_S = 3600.0  # the e2e's burst decides against one snapshot


def _server(pkg):
    srv = pkg.wire.WireFakeK8s()
    for i in range(3):
        srv.add_node(f"node-{i}", labels={"zone": f"z{i}"})
    pkg.http.set_active_config(srv.base_url)
    return srv


def _kubeconfig(tmp_path, monkeypatch, srv, name):
    cfg = tmp_path / f"kubeconfig-{name}"
    cfg.write_text(
        "current-context: main\n"
        "contexts:\n- name: main\n  context: {cluster: c, user: u}\n"
        f"clusters:\n- name: c\n  cluster: {{server: {srv.base_url}}}\n"
        "users:\n- name: u\n  user: {}\n"
    )
    monkeypatch.setenv("KUBECONFIG", str(cfg))
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)


def _both(fn):
    """fn(pkg) for each package; returns {"jax": ..., "torch": ...}."""
    return {name: fn(pkg) for name, pkg in PKGS.items()}


def _same(results):
    assert results["torch"] == results["jax"]
    return results["torch"]


async def _until(pred, what, srv=None):
    """Poll `pred` until it holds; a timeout names the wait and shows the
    tail of the fake API server's request log."""
    try:
        async with async_deadline(WAIT_S):
            while not pred():
                await asyncio.sleep(0.02)
    except TimeoutError as exc:
        log = "\n".join(srv.request_log[-40:]) if srv is not None else ""
        raise AssertionError(f"timed out after {WAIT_S}s waiting for {what}\n{log}") from exc
    assert pred(), what


# ---------------------------------------------------------------- httpapi
def test_k8sobject_attribute_protocol_matches():
    def run(pkg):
        K = pkg.http.K8sObject
        obj = K({"spec": {"nodeName": "n1", "schedulerName": "s"}})
        alloc = K({"allocatable": {"cpu": "16", "memory": "64Gi"}}).allocatable
        expr = K({"key": "zone", "operator": "In", "values": ["a"]})
        return (obj.spec.node_name, obj.spec.scheduler_name, obj.spec.priority,
                obj.metadata, alloc.get("cpu", "0"), dict(alloc), bool(K({})),
                list(expr.values))

    assert _same(_both(run)) == ("n1", "s", None, None, "16",
                                 {"cpu": "16", "memory": "64Gi"}, False, ["a"])


def test_kubeconfig_parsing_matches(tmp_path):
    def run(pkg):
        srv = _server(pkg)
        try:
            cfg = tmp_path / f"kc-{pkg.root}"
            cfg.write_text(
                "apiVersion: v1\ncurrent-context: main\ncontexts:\n"
                "- name: main\n  context: {cluster: c1, user: u1}\nclusters:\n"
                f"- name: c1\n  cluster: {{server: {srv.base_url}}}\nusers:\n"
                "- name: u1\n  user: {token: tok-123}\n")
            pkg.http.load_kube_config(str(cfg))
            return [n.metadata.name for n in pkg.http.CoreV1Api().list_node().items]
        finally:
            srv.close()

    assert _same(_both(run)) == ["node-0", "node-1", "node-2"]


def test_an_active_config_needs_no_kubeconfig_file(tmp_path, monkeypatch):
    """set_active_config outranks a KUBECONFIG that does not exist (how
    chip_smoke.py's `run` child reaches the wire fake)."""
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "absent"))

    def run(pkg):
        srv = _server(pkg)
        try:
            pkg.http.load_kube_config()
            return [m.name for m in pkg.kube.KubeCluster(informer=False).get_node_metrics()]
        finally:
            srv.close()

    assert _same(_both(run)) == ["node-0", "node-1", "node-2"]


def test_list_pods_and_binding_roundtrip_match():
    def run(pkg):
        srv = _server(pkg)
        try:
            srv.add_pod("p1")
            api = pkg.http.CoreV1Api()
            pods = api.list_pod_for_all_namespaces().items
            binding = pkg.http.V1Binding(
                metadata=pkg.http.V1ObjectMeta(name="p1", namespace="default"),
                target=pkg.http.V1ObjectReference(kind="Node", name="node-1"))
            api.create_namespaced_binding("default", binding, _preload_content=False)
            with pytest.raises(pkg.http.ApiException) as ei:
                api.create_namespaced_binding("default", binding)
            return ([p.metadata.name for p in pods], pods[0].spec.node_name,
                    list(srv.bindings), ei.value.status)
        finally:
            srv.close()

    assert _same(_both(run)) == (["p1"], None, [("default", "p1", "node-1")], 409)


def test_watch_streams_events_and_bookmarks_match():
    def run(pkg):
        srv = _server(pkg)
        try:
            api = pkg.http.CoreV1Api()
            stream = pkg.http.Watch().stream(api.list_pod_for_all_namespaces,
                                             timeout_seconds=1, allow_watch_bookmarks=True)
            srv.add_pod("wp")
            events = list(stream)
            added = next(e for e in events if e["type"] == "ADDED")
            return ("BOOKMARK" in {e["type"] for e in events}, added["object"].metadata.name,
                    added["object"].metadata.resource_version is not None)
        finally:
            srv.close()

    assert _same(_both(run)) == (True, "wp", True)


def test_expired_rv_is_an_in_stream_410_in_both():
    def run(pkg):
        srv = _server(pkg)
        try:
            srv.add_pod("old")
            srv.compact()
            events = list(pkg.http.Watch().stream(
                pkg.http.CoreV1Api().list_pod_for_all_namespaces, timeout_seconds=1,
                resource_version="101"))
            return events[0]["type"], events[0]["object"].code
        finally:
            srv.close()

    assert _same(_both(run)) == ("ERROR", 410)


# ---------------------------------------------------------------- KubeCluster
def test_snapshot_node_metrics_match(tmp_path, monkeypatch):
    def run(pkg):
        srv = _server(pkg)
        try:
            _kubeconfig(tmp_path, monkeypatch, srv, pkg.root)
            srv.add_pod("placed", node_name="node-1", phase="Running")
            srv.add_node("node-3", cpu="8", memory="32Gi", pods="50",
                         taints=[{"key": "gpu", "value": "true", "effect": "NoSchedule"}])
            srv.add_node("node-4", ready=False)
            cluster = pkg.kube.KubeCluster(informer=False)
            metrics = [dataclasses.asdict(m) for m in cluster.get_node_metrics()]
            cluster.close()
            return metrics
        finally:
            srv.close()

    metrics = _same(_both(run))
    assert [m["name"] for m in metrics] == [f"node-{i}" for i in range(5)]
    by = {m["name"]: m for m in metrics}
    assert by["node-0"]["available_cpu_cores"] == 16.0 and by["node-1"]["pod_count"] == 1
    assert by["node-4"]["conditions"]["Ready"] == "False"


def _informer_binding(pkg, tmp_path, monkeypatch):
    srv = _server(pkg)
    _kubeconfig(tmp_path, monkeypatch, srv, pkg.root)
    cluster = pkg.kube.KubeCluster(watch_timeout_seconds=5)
    seen = []

    async def drive():
        async def consume():
            async for raw in cluster.watch_pending_pods(SCHED):
                seen.append(raw)
                break

        task = asyncio.create_task(consume())
        await _until(lambda: any("watch=true" in r for r in srv.request_log), "watch up", srv)
        srv.add_pod("e2e-pod", requests={"cpu": "250m", "memory": "256Mi"})
        async with async_deadline(WAIT_S):
            await task

    try:
        asyncio.run(drive())
        cluster.get_node_metrics()
        lists = [r for r in srv.request_log
                 if r.startswith("GET /api/v1/pods") and "watch=true" not in r]
        metrics = cluster.get_node_metrics()
        lists_after = [r for r in srv.request_log
                       if r.startswith("GET /api/v1/pods") and "watch=true" not in r]
        bound = cluster.bind_pod_to_node("e2e-pod", "default", "node-2")
        after = {m.name: m.pod_count for m in cluster.get_node_metrics()}
        raw = seen[0]
        return (raw.name, raw.needs_scheduling, raw.container_requests,
                len(lists_after) - len(lists), sorted(m.name for m in metrics), bound,
                list(srv.bindings), srv.pod("e2e-pod")["spec"]["nodeName"], after)
    finally:
        cluster.close()
        srv.close()


def test_watch_informer_and_binding_match(tmp_path, monkeypatch):
    """Watch picks up a pending pod, the informer serves a snapshot with no
    pod LIST, the binding POST lands and folds back into the cache."""
    got = _same(_both(lambda pkg: _informer_binding(pkg, tmp_path, monkeypatch)))
    assert got[0] == "e2e-pod" and got[1] is True
    assert got[3] == 0 and got[5] is True
    assert got[6] == [("default", "e2e-pod", "node-2")] and got[8]["node-2"] == 1


def _resume(pkg, tmp_path, monkeypatch, compact):
    srv = _server(pkg)
    _kubeconfig(tmp_path, monkeypatch, srv, pkg.root)
    cluster = pkg.kube.KubeCluster(watch_timeout_seconds=1)
    seen = []

    def watches():
        return [r for r in srv.request_log
                if r.startswith("GET /api/v1/pods") and "watch=true" in r]

    async def drive():
        async def consume():
            async for raw in cluster.watch_pending_pods(SCHED):
                seen.append(raw.name)

        task = asyncio.create_task(consume())
        await _until(lambda: watches(), "first watch up", srv)
        srv.add_pod("first")
        await _until(lambda: len(seen) == 1, "first pod seen", srv)
        if compact:
            srv.compact()  # every rv expires: the resume gets an in-stream 410
        n = len(watches())
        # stream 1 ends at its 1 s server timeout; the next one is up
        await _until(lambda: len(watches()) > n, "a later watch up", srv)
        srv.add_pod("second")
        await _until(lambda: len(seen) == 2, "second pod seen", srv)
        cluster.close()
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task

    try:
        asyncio.run(drive())
    finally:
        cluster.close()
        srv.close()
    resumed = any("resourceVersion=" in w for w in watches()[1:])
    return seen, resumed


def test_watch_resumes_with_resource_version_in_both(tmp_path, monkeypatch):
    seen, resumed = _same(_both(lambda pkg: _resume(pkg, tmp_path, monkeypatch, False)))
    assert seen == ["first", "second"] and resumed


def test_410_falls_back_to_a_fresh_watch_in_both(tmp_path, monkeypatch):
    seen, _ = _same(_both(lambda pkg: _resume(pkg, tmp_path, monkeypatch, True)))
    assert seen == ["first", "second"]


def _e2e(pkg, tmp_path, monkeypatch):
    import importlib

    mod = lambda m: importlib.import_module(f"{pkg.root}.{m}")  # noqa: E731
    srv = _server(pkg)
    _kubeconfig(tmp_path, monkeypatch, srv, pkg.root)
    cluster = pkg.kube.KubeCluster(watch_timeout_seconds=5)
    client = mod("sched.client").DecisionClient(
        backend=mod("engine.backend").StubBackend(), cache=mod("core.cache").DecisionCache(),
        breaker=mod("core.breaker").CircuitBreaker(), retry_delay=0.0)
    # One snapshot for the burst: the three pods arrive together, and with a
    # fresh snapshot a decision, whether pod 3's snapshot already holds pod
    # 1's and 2's binds depends on timing (under a loaded parallel run the
    # two packages placed pod 3 on different nodes).
    scheduler = mod("sched.loop").Scheduler(cluster, cluster, client, scheduler_name=SCHED,
                                            snapshot_ttl_s=SNAPSHOT_TTL_S)

    async def drive():
        task = asyncio.create_task(scheduler.run())
        await _until(lambda: any("watch=true" in r for r in srv.request_log), "watch up", srv)
        for i, req in enumerate([{"cpu": "100m", "memory": "128Mi"},
                                 {"cpu": "250m", "memory": "256Mi"},
                                 {"cpu": "500m", "memory": "512Mi"}]):
            srv.add_pod(f"ai-test-pod-{i + 1}", requests=req)
        await _until(lambda: len(srv.bindings) == 3, "three binds", srv)
        scheduler.stop()
        cluster.close()
        async with async_deadline(WAIT_S):
            await task

    try:
        asyncio.run(drive())
        return sorted((name, node, srv.pod(name)["status"]["phase"])
                      for _, name, node in srv.bindings)
    finally:
        cluster.close()
        srv.close()


def test_reference_e2e_verdict_over_the_wire_in_both(tmp_path, monkeypatch):
    """Every fixture pod scheduled AND running, through each package's
    scheduler with the stub backend, on the same nodes."""
    placed = _same(_both(lambda pkg: _e2e(pkg, tmp_path, monkeypatch)))
    assert [p[0] for p in placed] == [f"ai-test-pod-{i}" for i in (1, 2, 3)]
    assert all(node in {"node-0", "node-1", "node-2"} and phase == "Running"
               for _, node, phase in placed)
