"""Continuous invariant monitoring during (and after) a chaos run.

The chaos plane's verdict is not "did it crash" — the stack is built not
to crash — but "did any SAFETY property silently break while the faults
were flying". The monitor checks five, during the run where possible and
at finalize() where only the end state can tell:

- **exactly_once_bind**: no pod is successfully bound twice. Checked at
  the binder seam (every bind converges there) against the monitor's own
  book, independently of the cluster's 409 defense — the point is to
  catch the cluster defense AND the scheduler discipline regressing
  together.
- **bind_after_fence**: a replica whose lease for a pod's shard is no
  longer live in the STORE must not successfully bind that pod. Checked
  at the fenced binder seam with the store as the authority (the
  replica's local view may lag; the store cannot).
- **stale_generation**: a cached decision served after a generation bump
  must not come from a pre-bump entry. The monitor keeps its own
  key -> generation book on every cache write and compares on every
  cache hit — an independent re-derivation of the coherence the
  generation-stamped keys are supposed to enforce.
- **lost_pod**: at the end of the run, every generated pod is either
  bound or still observably pending. A pod that is neither was dropped
  by the pipeline — the failure mode watch re-lists and rebind passes
  exist to prevent.
- **breaker_transition**: the circuit breaker only ever moves along
  legal edges (CLOSED->OPEN, OPEN->HALF_OPEN, HALF_OPEN->{CLOSED,OPEN},
  administrative reset->CLOSED). Checked via the breaker's transition
  hook.

Violations carry the flight-recorder trace id active at the violating
operation (spans.current_trace() — binds and cache lookups run inside
the decision's trace context), and the trace itself is stamped with
`invariant_violation` meta, so `cli trace show <id>` explains each one.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Iterable

from k8s_llm_scheduler_tpu_torch.observability import spans

INVARIANTS = (
    "exactly_once_bind",
    "bind_after_fence",
    "stale_generation",
    "lost_pod",
    "breaker_transition",
    # elastic-fleet round: binds stay exactly-once ACROSS membership
    # changes — a pod successfully bound by two DIFFERENT holders means
    # a scale event (join, drain, crash failover) let ownership overlap.
    # Refines exactly_once_bind with holder attribution: the membership
    # hazard is specifically two replicas both believing they own the
    # pod's shard, which only holder identity can distinguish from a
    # same-replica retry bug.
    "single_holder_bind",
    # the autoscale controller must never steer the fleet outside its
    # configured [min, max] replica clamp (checked on every controller
    # tick via note_scale)
    "replica_bounds",
    # durable-state round: at the end of a crash-restart run the journal
    # (sched/journal.py), the monitor's own bind book — which spans
    # every process lifetime — and the cluster must agree: no lifecycle
    # left open (recovery reconciled everything), every ok-acked bind
    # actually on the cluster at the acked node, no acked pod the
    # monitor never saw bind. Judged at finalize_journal against the
    # STORE (the cluster lookup), not the journal's own claims.
    "journal_consistency",
    # persistent-serving round: the token stream delivered for one
    # serving request (through the device->host TokenRing, the
    # dispatch-path fallback, or a watchdog drain that splits a request
    # across both) must be byte-identical to the expected stream — a
    # shortfall is a LOST emission, an overrun a DOUBLE-delivered one,
    # and a value divergence is stream corruption (a slot-reuse or
    # sequence bug). Checked per request via note_tokens as the chaos
    # harness books completions.
    "token_integrity",
)

# legal breaker edges (core/breaker.py state machine); reset() is
# administrative and reported separately by the hook, never judged here
_LEGAL_BREAKER_EDGES = {
    ("closed", "open"),
    ("open", "half_open"),
    ("half_open", "closed"),
    ("half_open", "open"),
}


@dataclasses.dataclass
class Violation:
    invariant: str
    subject: str          # pod ns/name, cache-key prefix, breaker name
    detail: str
    trace_id: str | None = None
    wave: int | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def deterministic_key(self) -> dict:
        """The replay-stable identity (trace ids and wave timing are
        run-local; the chaos trace stores only this part)."""
        return {"invariant": self.invariant, "subject": self.subject}


class InvariantMonitor:
    """Collects violations from the wrapped seams. Thread-safe: binder
    wrappers run on the event loop AND executor threads, the breaker
    hook on whatever thread trips it."""

    def __init__(self, injector: Any = None) -> None:
        self._injector = injector  # for wave stamping (may be None)
        self._lock = threading.Lock()
        self.violations: list[Violation] = []
        self._bound: dict[tuple[str, str], str] = {}
        self._bound_holder: dict[tuple[str, str], str] = {}
        # every bind ATTEMPT (ok or fenced/failed) — the harness's wave
        # barrier resolves pods here because the scheduler's cache-hit
        # fast path binds without passing through schedule_pod
        self._attempted: set[tuple[str, str]] = set()
        self.checks: dict[str, int] = {name: 0 for name in INVARIANTS}

    # ------------------------------------------------------------- recording
    def _wave(self) -> int | None:
        if self._injector is None:
            return None
        wave = self._injector.wave
        return None if wave < 0 else wave

    def record(self, invariant: str, subject: str, detail: str) -> None:
        trace = spans.current_trace()
        trace_id = trace.trace_id if trace is not None else None
        if trace is not None:
            # the flight recorder entry explains the violation:
            # `cli trace show <id>` surfaces this meta
            trace.set_meta(invariant_violation=invariant)
        violation = Violation(
            invariant=invariant, subject=subject, detail=detail,
            trace_id=trace_id, wave=self._wave(),
        )
        with self._lock:
            self.violations.append(violation)

    def _check(self, invariant: str) -> None:
        with self._lock:
            self.checks[invariant] += 1

    # --------------------------------------------------------------- binder
    def wrap_binder(
        self,
        binder: Any,
        *,
        holder: str | None = None,
        store: Any = None,
        n_shards: int | None = None,
    ) -> "MonitoredBinder":
        """Wrap a Binder. With (holder, store, n_shards) the wrapper also
        checks lease fencing: a successful bind while the store says the
        shard is not live-held by `holder` is a bind after the fence."""
        return MonitoredBinder(
            self, binder, holder=holder, store=store, n_shards=n_shards
        )

    def note_bind(
        self, ok: bool, namespace: str, name: str, node: str,
        holder: str | None = None, store: Any = None,
        n_shards: int | None = None,
    ) -> None:
        with self._lock:
            self._attempted.add((namespace, name))
        if not ok:
            return
        key = (namespace, name)
        self._check("exactly_once_bind")
        with self._lock:
            previous = self._bound.get(key)
            if previous is None:
                self._bound[key] = node
        if previous is not None:
            self.record(
                "exactly_once_bind", f"{namespace}/{name}",
                f"bound twice: first -> {previous}, again -> {node}",
            )
        if holder is not None:
            self._check("single_holder_bind")
            with self._lock:
                first_holder = self._bound_holder.setdefault(key, holder)
            if first_holder != holder:
                self.record(
                    "single_holder_bind", f"{namespace}/{name}",
                    f"bound by two holders across a membership change: "
                    f"first {first_holder}, again {holder}",
                )
        if holder is not None and store is not None and n_shards:
            from k8s_llm_scheduler_tpu_torch.fleet.lease import shard_of

            self._check("bind_after_fence")
            shard = shard_of(namespace, name, n_shards)
            live = store.holder_of(shard)
            if live != holder:
                self.record(
                    "bind_after_fence", f"{namespace}/{name}",
                    f"bind by {holder} succeeded but shard {shard} is "
                    f"held by {live!r} in the store",
                )

    # ---------------------------------------------------------------- scale
    def note_scale(self, n_replicas: int, min_replicas: int,
                   max_replicas: int) -> None:
        """Autoscale-controller hook (fleet/autoscale.AutoscaleController
        on_scale): fires after every control tick with the fleet size
        and the configured clamp. Outside [min, max] is the
        replica_bounds violation — the controller's own clamp and this
        independent re-derivation must agree."""
        self._check("replica_bounds")
        if not min_replicas <= n_replicas <= max_replicas:
            self.record(
                "replica_bounds", f"replicas={n_replicas}",
                f"fleet size {n_replicas} outside configured clamp "
                f"[{min_replicas}, {max_replicas}]",
            )

    # --------------------------------------------------------------- tokens
    def note_tokens(
        self, namespace: str, name: str,
        expected: Any, delivered: Any,
    ) -> None:
        """Persistent-plane accounting (see the token_integrity entry in
        INVARIANTS): called once per serving request as the chaos
        harness books its completion, with the stream the request was
        SUPPOSED to produce and the stream that actually arrived —
        whether it rode the TokenRing, the dispatch-path fallback, or a
        watchdog drain splitting it across both."""
        self._check("token_integrity")
        expected = list(expected)
        delivered = list(delivered)
        if delivered == expected:
            return
        n_exp, n_got = len(expected), len(delivered)
        if n_got < n_exp:
            detail = (
                f"{n_exp - n_got} emission(s) lost "
                f"({n_got}/{n_exp} delivered)"
            )
        elif n_got > n_exp:
            detail = f"{n_got - n_exp} emission(s) double-delivered"
        else:
            diverge = next(
                i for i, (a, b) in enumerate(zip(expected, delivered))
                if a != b
            )
            detail = f"delivered stream diverges at position {diverge}"
        self.record("token_integrity", f"{namespace}/{name}", detail)

    # ---------------------------------------------------------------- cache
    def wrap_cache(self, cache: Any) -> "MonitoredCache":
        return MonitoredCache(self, cache)

    # -------------------------------------------------------------- breaker
    def watch_breaker(self, breaker: Any, name: str = "breaker") -> None:
        """Subscribe to the breaker's transition hook (core/breaker.py
        on_transition). The hook fires under the breaker's lock: this
        callback only appends under the monitor's own lock and never
        calls back into the breaker. CHAINS any observer already
        installed (a durable replica journals its trips through the same
        slot — monitoring must not silently disconnect it)."""
        prior = getattr(breaker, "on_transition", None)

        def on_transition(old, new) -> None:
            self._check("breaker_transition")
            edge = (old.value, new.value)
            if edge not in _LEGAL_BREAKER_EDGES:
                self.record(
                    "breaker_transition", name,
                    f"illegal edge {old.value} -> {new.value}",
                )
            if prior is not None:
                prior(old, new)

        breaker.on_transition = on_transition

    # ------------------------------------------------------------- finalize
    def finalize(
        self,
        expected: Iterable[tuple[str, str]],
        pending: Iterable[tuple[str, str]],
    ) -> None:
        """End-of-run accounting: every expected (namespace, name) must be
        bound (per the monitor's book) or still pending (per the cluster's
        own listing)."""
        pending_set = set(pending)
        with self._lock:
            bound = set(self._bound)
        for key in expected:
            self._check("lost_pod")
            if key not in bound and key not in pending_set:
                self.record(
                    "lost_pod", f"{key[0]}/{key[1]}",
                    "pod neither bound nor pending at end of run",
                )

    def finalize_journal(self, state: Any, pod_lookup: Any) -> None:
        """Crash-plane accounting (see the journal_consistency entry in
        INVARIANTS). `state` is the journal's folded JournalState;
        `pod_lookup` the same cluster-truth probe recovery used."""
        self._check("journal_consistency")
        for (ns, name) in sorted(
            set(state.open_decisions) | set(state.open_intents)
        ):
            self.record(
                "journal_consistency", f"{ns}/{name}",
                "journal lifecycle still open at end of run — recovery "
                "never reconciled it",
            )
        with self._lock:
            bound = dict(self._bound)
        for (ns, name), node in sorted(state.acked.items()):
            status, now = pod_lookup(ns, name)
            if status == "pending":
                self.record(
                    "journal_consistency", f"{ns}/{name}",
                    f"journal acked a bind to {node} but the cluster "
                    f"still lists the pod pending",
                )
            elif status == "bound" and now != node:
                self.record(
                    "journal_consistency", f"{ns}/{name}",
                    f"journal acked node {node} but the cluster has the "
                    f"pod on {now}",
                )
            monitor_node = bound.get((ns, name))
            if monitor_node is not None and monitor_node != node:
                self.record(
                    "journal_consistency", f"{ns}/{name}",
                    f"journal acked {node} but the bind book (spanning "
                    f"all process lifetimes) recorded {monitor_node}",
                )

    # --------------------------------------------------------------- report
    @property
    def clean(self) -> bool:
        with self._lock:
            return not self.violations

    def bound_pods(self) -> dict[tuple[str, str], str]:
        with self._lock:
            return dict(self._bound)

    def attempted_pods(self) -> set[tuple[str, str]]:
        with self._lock:
            return set(self._attempted)

    def report(self) -> dict:
        with self._lock:
            return {
                "clean": not self.violations,
                "checks": dict(self.checks),
                "violations": [v.to_dict() for v in self.violations],
            }


class MonitoredBinder:
    """Binder wrapper feeding note_bind (see InvariantMonitor)."""

    def __init__(
        self, monitor: InvariantMonitor, inner: Any, *,
        holder: str | None = None, store: Any = None,
        n_shards: int | None = None,
    ) -> None:
        self._monitor = monitor
        self._inner = inner
        self._holder = holder
        self._store = store
        self._n_shards = n_shards
        # preserve the scheduler's inline-bind fast path
        self.bind_is_nonblocking = getattr(inner, "bind_is_nonblocking", False)

    def bind_pod_to_node(
        self, pod_name: str, namespace: str, node_name: str
    ) -> bool:
        ok = self._inner.bind_pod_to_node(pod_name, namespace, node_name)
        self._monitor.note_bind(
            ok, namespace, pod_name, node_name,
            holder=self._holder, store=self._store, n_shards=self._n_shards,
        )
        return ok

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)


class MonitoredCache:
    """Cache wrapper keeping an independent key -> generation book.

    Works over a flat DecisionCache or a TieredDecisionCache: both expose
    get/set/generation/bump_generation. The book records the generation
    each key was last WRITTEN under (the explicit compute-epoch argument
    when given, else the cache's current generation); a HIT whose last
    write predates the current generation means a pre-swap entry was
    served — the stale_generation violation."""

    def __init__(self, monitor: InvariantMonitor, inner: Any) -> None:
        self._monitor = monitor
        self._inner = inner
        self._book: dict[str, int] = {}
        self._book_lock = threading.Lock()

    # the DecisionCache surface DecisionClient consumes ------------------
    def get(self, pod, nodes, key=None):
        from k8s_llm_scheduler_tpu_torch.core.cache import decision_cache_key

        if key is None:
            key = decision_cache_key(pod, nodes)
        decision = self._inner.get(pod, nodes, key=key)
        if decision is not None:
            self._monitor._check("stale_generation")
            current = self._inner.generation
            with self._book_lock:
                written = self._book.get(key)
            if written is not None and written < current:
                self._monitor.record(
                    "stale_generation", key[:16],
                    f"cache hit on entry written under generation "
                    f"{written}, current generation {current}",
                )
        return decision

    def set(self, pod, nodes, decision, key=None, generation=None):
        from k8s_llm_scheduler_tpu_torch.core.cache import decision_cache_key

        if key is None:
            key = decision_cache_key(pod, nodes)
        effective = self._inner.generation if generation is None else generation
        with self._book_lock:
            self._book[key] = effective
        return self._inner.set(
            pod, nodes, decision, key=key, generation=generation
        )

    @property
    def generation(self):
        return self._inner.generation

    def bump_generation(self):
        return self._inner.bump_generation()

    @property
    def last_tier(self):
        return getattr(self._inner, "last_tier", None)

    @property
    def ttl_seconds(self):
        return self._inner.ttl_seconds

    def clear(self) -> None:
        self._inner.clear()

    def __len__(self) -> int:
        return len(self._inner)

    def stats(self) -> dict:
        return self._inner.stats()
