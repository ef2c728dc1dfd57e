"""In-tree Kubernetes REST client — stdlib HTTP, zero dependencies.

A copy of the JAX package's cluster/httpapi.py; `load_kube_config` imports
PyYAML only when it has a kubeconfig file to read.

The reference reaches its cluster through the official `kubernetes`
package (reference scheduler.py:114,573 kubeconfig; :657-666 watch;
:598-602 binding). That package may be absent in hermetic or minimal
images; this module speaks the same REST surface over http.client so
`cluster/kube.py` runs unchanged without it:

- `CoreV1Api.list_node()` / `.list_pod_for_all_namespaces()` — plain GET,
  returning objects with the official client's attribute shapes (`.items`,
  `pod.spec.node_name`, camelCase JSON exposed as snake_case attributes).
- watch streams — `?watch=1` chunked GET with `resourceVersion`,
  `timeoutSeconds`, `allowWatchBookmarks` query params, yielding
  `{"type", "object"}` events exactly like `kubernetes.watch.Watch`,
  including in-stream ERROR/410 Status objects (how the API server
  delivers an expired resourceVersion mid-stream).
- `CoreV1Api.create_namespaced_binding()` — POST
  /api/v1/namespaces/{ns}/bindings, the exact wire path the official
  client's method uses (the `_preload_content=False` workaround the
  reference needs, scheduler.py:598-602, is a client-side deserialization
  issue that simply does not exist here: responses are returned raw).
- `load_incluster_config()` — KUBERNETES_SERVICE_HOST/PORT + the mounted
  serviceaccount token/CA; `load_kube_config()` — minimal kubeconfig YAML
  (current-context -> cluster server + user token).

Scope: exactly what the scheduler consumes. This is not a generated
client; it is the framework's native transport, wire-level tested against
`cluster/wire_fake.py` (a fake API server speaking real HTTP) in
tests/test_torch_kube_wire.py.
"""

from __future__ import annotations

import json
import os
import ssl
import urllib.parse
import urllib.request
from typing import Any, Iterator

__all__ = [
    "ApiException",
    "K8sObject",
    "CoreV1Api",
    "Watch",
    "V1Binding",
    "V1ObjectMeta",
    "V1ObjectReference",
    "load_incluster_config",
    "load_kube_config",
    "set_active_config",
]


class ApiException(Exception):
    """HTTP-level API failure; `.status`/`.reason` match the official
    client's exception surface (kube.py logs both, and treats 410 as
    watch-expired)."""

    def __init__(self, status: int = 0, reason: str = "") -> None:
        super().__init__(f"({status}) Reason: {reason}")
        self.status = status
        self.reason = reason


def _snake_to_camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(part.capitalize() for part in rest)


class K8sObject:
    """Attribute view over parsed K8s JSON.

    `obj.node_name` reads JSON key "nodeName"; missing keys are None (the
    official client's unset-field behavior). Dict-protocol methods (get /
    keys / __getitem__ / __iter__) cover map-typed fields the caller uses
    as dicts (allocatable, labels). Deliberately NO values()/items()
    methods: the caller reads `.values` (affinity expressions) and
    `.items` (list responses) as FIELDS, and a dict method would shadow
    them.
    """

    __slots__ = ("_data",)

    def __init__(self, data: dict) -> None:
        self._data = data

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict):
            return K8sObject(value)
        if isinstance(value, list):
            return [K8sObject._wrap(v) for v in value]
        return value

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        data = object.__getattribute__(self, "_data")
        if name in data:
            return self._wrap(data[name])
        camel = _snake_to_camel(name)
        return self._wrap(data.get(camel))

    # --- dict protocol for map-typed fields (labels, allocatable, ...) ---
    def get(self, key: str, default: Any = None) -> Any:
        return self._wrap(self._data.get(key, default))

    def keys(self):
        return self._data.keys()

    def __getitem__(self, key: str) -> Any:
        return self._wrap(self._data[key])

    def __iter__(self):
        return iter(self._data)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __len__(self) -> int:
        return len(self._data)

    def __bool__(self) -> bool:
        return bool(self._data)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"K8sObject({self._data!r})"

    def to_dict(self) -> dict:
        return self._data


# ------------------------------------------------------------ configuration
class _ClusterConfig:
    def __init__(
        self,
        host: str,
        token: str | None = None,
        ca_file: str | None = None,
        verify_ssl: bool = True,
    ) -> None:
        self.host = host.rstrip("/")
        self.token = token
        self.ca_file = ca_file
        self.verify_ssl = verify_ssl

    def ssl_context(self) -> ssl.SSLContext | None:
        if not self.host.startswith("https"):
            return None
        if not self.verify_ssl:
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            return ctx
        return ssl.create_default_context(cafile=self.ca_file)


_active: _ClusterConfig | None = None

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def set_active_config(
    host: str,
    token: str | None = None,
    ca_file: str | None = None,
    verify_ssl: bool = True,
) -> None:
    """Point the module at an API server directly (tests, custom setups)."""
    global _active
    _active = _ClusterConfig(host, token, ca_file, verify_ssl)


def clear_active_config() -> None:
    """Forget an explicit set_active_config (harness/sim teardown).

    The active config is PROCESS-GLOBAL: a harness that pointed it at an
    ephemeral fake API server and exited without clearing would leave
    every later client dialing a dead address instead of discovering (or
    cleanly failing on) the real cluster config."""
    global _active
    _active = None


def load_incluster_config() -> None:
    """Pod environment: service env vars + mounted serviceaccount creds."""
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    token_path = os.path.join(_SA_DIR, "token")
    if not host or not os.path.exists(token_path):
        raise RuntimeError("not running in a Kubernetes pod")
    with open(token_path, encoding="utf-8") as fh:
        token = fh.read().strip()
    ca = os.path.join(_SA_DIR, "ca.crt")
    set_active_config(
        f"https://{host}:{port}",
        token=token,
        ca_file=ca if os.path.exists(ca) else None,
    )


def load_kube_config(path: str | None = None) -> None:
    """Minimal kubeconfig: current-context -> cluster server + user token.

    KUBECONFIG may be a colon-separated path list (kubectl semantics); the
    first existing file that resolves to a cluster server wins — a
    simplification of kubectl's full merge that covers the common multi-
    file setup. Client-certificate auth is not implemented (this transport
    covers token / insecure clusters); the official client remains the
    preferred driver when installed (cluster/kube.py import order).
    PyYAML is imported only once a kubeconfig file is there to read, so an
    explicit set_active_config() needs no PyYAML."""
    raw = path or os.environ.get(
        "KUBECONFIG", os.path.expanduser("~/.kube/config")
    )
    candidates = [p for p in str(raw).split(os.pathsep) if p]
    existing = [p for p in candidates if os.path.exists(p)]
    if not existing:
        if _active is not None:
            # an explicit set_active_config() (tests, sim/arena pointing at
            # the wire fake) outranks a missing kubeconfig: keep it rather
            # than failing construction of a client that is already
            # configured
            return
        raise FileNotFoundError(
            f"no kubeconfig found at {raw!r}"
        )
    import yaml

    last_err: Exception | None = None
    for p in existing:
        try:
            _load_one_kubeconfig(p, yaml)
            return
        except Exception as exc:  # try the next file in the list
            last_err = exc
    raise last_err  # every existing file failed to resolve


def _load_one_kubeconfig(path: str, yaml) -> None:
    with open(path, encoding="utf-8") as fh:
        doc = yaml.safe_load(fh) or {}
    current = doc.get("current-context")
    contexts = {e.get("name"): e.get("context", {}) for e in doc.get("contexts", [])}
    ctx = contexts.get(current) or (next(iter(contexts.values())) if contexts else {})
    clusters = {e.get("name"): e.get("cluster", {}) for e in doc.get("clusters", [])}
    users = {e.get("name"): e.get("user", {}) for e in doc.get("users", [])}
    cluster = clusters.get(ctx.get("cluster"), {})
    user = users.get(ctx.get("user"), {})
    server = cluster.get("server")
    if not server:
        raise RuntimeError(f"kubeconfig {path} has no cluster server")
    set_active_config(
        server,
        token=user.get("token"),
        ca_file=cluster.get("certificate-authority"),
        verify_ssl=not cluster.get("insecure-skip-tls-verify", False),
    )


def _require_config() -> _ClusterConfig:
    if _active is None:
        raise RuntimeError(
            "no cluster configured: call load_incluster_config(), "
            "load_kube_config(), or set_active_config() first"
        )
    return _active


# -------------------------------------------------------------------- bodies
class V1ObjectMeta:
    def __init__(self, name: str = "", namespace: str = "") -> None:
        self.name = name
        self.namespace = namespace

    def to_dict(self) -> dict:
        return {"name": self.name, "namespace": self.namespace}


class V1ObjectReference:
    def __init__(
        self, api_version: str = "v1", kind: str = "", name: str = ""
    ) -> None:
        self.api_version = api_version
        self.kind = kind
        self.name = name

    def to_dict(self) -> dict:
        return {"apiVersion": self.api_version, "kind": self.kind, "name": self.name}


class V1Binding:
    def __init__(
        self, metadata: V1ObjectMeta, target: V1ObjectReference
    ) -> None:
        self.metadata = metadata
        self.target = target

    def to_dict(self) -> dict:
        return {
            "apiVersion": "v1",
            "kind": "Binding",
            "metadata": self.metadata.to_dict(),
            "target": self.target.to_dict(),
        }


# ----------------------------------------------------------------- transport
def _open(
    method: str,
    path: str,
    query: dict[str, Any] | None = None,
    body: dict | None = None,
    timeout: float | None = 30.0,
):
    cfg = _require_config()
    url = cfg.host + path
    if query:
        url += "?" + urllib.parse.urlencode(
            {k: v for k, v in query.items() if v is not None}
        )
    data = json.dumps(body).encode("utf-8") if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Accept", "application/json")
    if body is not None:
        req.add_header("Content-Type", "application/json")
    if cfg.token:
        req.add_header("Authorization", f"Bearer {cfg.token}")
    try:
        return urllib.request.urlopen(
            req, timeout=timeout, context=cfg.ssl_context()
        )
    except urllib.error.HTTPError as exc:
        raise ApiException(status=exc.code, reason=exc.reason) from exc
    except OSError as exc:
        raise ApiException(status=0, reason=str(exc)) from exc


def _get_json(path: str, query: dict | None = None) -> K8sObject:
    with _open("GET", path, query=query) as resp:
        return K8sObject(json.loads(resp.read().decode("utf-8")))


def _watch_stream(
    path: str,
    resource_version: str | None,
    timeout_seconds: int | None,
    allow_watch_bookmarks: bool,
) -> Iterator[dict]:
    """One chunked watch GET, yielding {"type", "object"} events until the
    server closes the stream (its timeoutSeconds). The read timeout leaves
    generous headroom over the server-side timeout so a quiet-but-healthy
    stream is never torn down early."""
    query = {
        "watch": "true",
        "resourceVersion": resource_version,
        "timeoutSeconds": timeout_seconds,
        "allowWatchBookmarks": "true" if allow_watch_bookmarks else None,
    }
    read_timeout = (timeout_seconds or 60) + 30
    with _open("GET", path, query=query, timeout=read_timeout) as resp:
        for line in resp:
            line = line.strip()
            if not line:
                continue
            event = json.loads(line.decode("utf-8"))
            yield {
                "type": event.get("type", ""),
                "object": K8sObject(event.get("object") or {}),
            }


class _WatchableList:
    """A list endpoint callable both ways the caller uses it: plainly
    (returns the parsed list response) and via Watch (watch=True kwarg
    returns the event iterator)."""

    def __init__(self, path: str, name: str) -> None:
        self._path = path
        self.__name__ = name  # kube.py logs list_fn.__name__

    def __call__(self, watch: bool = False, **kwargs):
        if watch:
            return _watch_stream(
                self._path,
                resource_version=kwargs.get("resource_version"),
                timeout_seconds=kwargs.get("timeout_seconds"),
                allow_watch_bookmarks=bool(kwargs.get("allow_watch_bookmarks")),
            )
        return _get_json(self._path)


class CoreV1Api:
    """The slice of the official CoreV1Api the scheduler consumes."""

    def __init__(self) -> None:
        _require_config()
        self.list_node = _WatchableList("/api/v1/nodes", "list_node")
        self.list_pod_for_all_namespaces = _WatchableList(
            "/api/v1/pods", "list_pod_for_all_namespaces"
        )

    def create_namespaced_binding(
        self, namespace: str, body: V1Binding, _preload_content: bool = True
    ) -> K8sObject:
        # _preload_content is accepted for drop-in compatibility; this
        # transport never deserializes into typed models, so the official
        # client's Binding-deserialization bug has no analog here.
        with _open(
            "POST", f"/api/v1/namespaces/{namespace}/bindings",
            body=body.to_dict(),
        ) as resp:
            raw = resp.read()
        try:
            return K8sObject(json.loads(raw.decode("utf-8")))
        except (ValueError, UnicodeDecodeError):
            return K8sObject({})


class Watch:
    """Official-client-shaped watch facade: `stream(list_fn, **kw)` yields
    event dicts. The official signature passes snake_case kwargs; the
    _WatchableList translates them onto the wire."""

    def stream(self, list_fn, **kwargs) -> Iterator[dict]:
        return list_fn(watch=True, **kwargs)

    def stop(self) -> None:  # pragma: no cover - parity no-op
        pass
