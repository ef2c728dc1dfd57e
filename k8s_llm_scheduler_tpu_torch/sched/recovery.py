"""Crash-restart recovery: rebuild a replica's bind obligations from disk.

The journal (sched/journal.py) records the decision -> bind-intent ->
bind-ack lifecycle; this module is the other half — the protocol a
restarting replica runs BEFORE it takes traffic:

1. replay the journal (done by DecisionJournal at open: torn tail
   truncated, state folded);
2. restore the circuit breaker from its journaled snapshot, so a
   rebooted replica does not hammer a backend the fleet already knows
   is down (OPEN resumes with its remaining jittered cooldown);
3. reconcile every OPEN lifecycle against the cluster's actual
   ``pod.spec.nodeName`` — the cluster, not the journal, is the
   authority on what landed:

   ========== ==========================================================
   cluster    action
   ========== ==========================================================
   bound      the bind landed before the crash (or someone else's did):
              journal the missing ack, nothing to re-execute
   pending    the decision survived but the bind did not: complete the
              bind through the caller's binder chain — under a
              re-acquired fenced lease in a fleet — WITHOUT re-deciding
              (the journaled node IS the decision)
   gone       the pod was deleted while we were down: journal a drop
   ========== ==========================================================

4. resume the watch from the journaled resourceVersion (the caller
   passes ``state.last_rv`` to its cluster driver — cluster/kube.py
   ``resume_rv``), paying one reconciling relist instead of a blind
   fresh start.

Recovery writes only journal APPENDS (acks/drops/fresh intents), so it
is itself crash-consistent: a crash mid-recovery leaves a journal whose
next replay reconciles the remainder — the chaos plane's
crash-during-recovery regime pins exactly that.

`JournaledBinder` is the production seam that feeds the journal: every
bind path (full, fast, follower, rebind, recovery) converges on the
Binder, so wrapping it records the whole lifecycle with one wrapper.
The chaos `process` seam rides the same wrapper (``crash_seam``, None
in production) to drop a replica cold at the nastiest points.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

from k8s_llm_scheduler_tpu_torch.sched.journal import DecisionJournal

logger = logging.getLogger(__name__)

# JournaledBinder kill points, in lifecycle order (chaos process seam):
# post_decide = decision journaled, intent not; mid_bind = intent
# journaled, bind NOT executed; post_bind = bind executed, ack not.
CRASH_POINTS = ("post_decide", "mid_bind", "post_bind")


class SimulatedCrash(RuntimeError):
    """Chaos-injected cold process death (never raised in production:
    it fires only through a non-None crash_seam). The harness catches
    it, discards the replica object with leases UNRELEASED, and rebuilds
    from disk."""

    def __init__(self, point: str, subject: str) -> None:
        super().__init__(f"simulated crash at {point} ({subject})")
        self.point = point
        self.subject = subject


class JournaledBinder:
    """Binder wrapper recording the decide/intent/ack lifecycle.

    Sits INSIDE the lease fence (fleet/frontend.py wraps it in
    _FencedBinder): a fenced-off bind never journals, so recovery never
    chases obligations this replica was not allowed to create. The
    decide record is written here too — the binder receives the chosen
    node, and every scheduler path (full, fast, follower, rebind)
    converges on it, so one wrapper covers the whole lifecycle without
    touching three hot paths."""

    def __init__(
        self,
        inner: Any,
        journal: DecisionJournal,
        *,
        shard_fn: Callable[[str, str], int] | None = None,
        epoch_fn: Callable[[int], int | None] | None = None,
    ) -> None:
        self._inner = inner
        self._journal = journal
        self._shard_fn = shard_fn
        self._epoch_fn = epoch_fn
        # Chaos seam (chaos/faults.py seam "process"): None in production
        # — one attribute read per bind.
        self.crash_seam = None
        self.crashed: tuple[str, str] | None = None  # (point, subject)
        # preserve the scheduler's inline-bind fast path
        self.bind_is_nonblocking = getattr(inner, "bind_is_nonblocking", False)

    def _crash(self, point: str, subject: str) -> None:
        seam = self.crash_seam
        if seam is None:
            return
        event = seam.should("crash", key=subject, where={"point": point})
        if event is not None:
            self.crashed = (point, subject)
            raise SimulatedCrash(point, subject)

    def bind_pod_to_node(
        self, pod_name: str, namespace: str, node_name: str
    ) -> bool:
        subject = f"{namespace}/{pod_name}"
        shard = (
            self._shard_fn(namespace, pod_name)
            if self._shard_fn is not None else None
        )
        epoch = (
            self._epoch_fn(shard)
            if self._epoch_fn is not None and shard is not None else None
        )
        self._journal.record_decide(namespace, pod_name, node_name)
        self._crash("post_decide", subject)
        self._journal.record_intent(
            namespace, pod_name, node_name, shard=shard, epoch=epoch
        )
        self._crash("mid_bind", subject)
        ok = self._inner.bind_pod_to_node(pod_name, namespace, node_name)
        self._crash("post_bind", subject)
        self._journal.record_ack(namespace, pod_name, node_name, ok)
        return ok

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)


@dataclasses.dataclass
class RecoveryReport:
    """What one recovery pass reconciled."""

    acked: int = 0      # bind had landed: missing ack journaled
    rebound: int = 0    # bind had not landed: completed without re-deciding
    dropped: int = 0    # pod gone: lifecycle closed
    failed: int = 0     # completion bind refused (fence/cluster said no)
    breaker_restored: bool = False
    resume_rv: str | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def reconciled(self) -> int:
        return self.acked + self.rebound + self.dropped


# pod_lookup contract: (namespace, name) -> ("bound", node) |
# ("pending", None) | ("gone", None). cluster/kube.py lookup_pod_node
# and cluster/fake.py get_pod both back it trivially.
PodLookup = Callable[[str, str], tuple[str, "str | None"]]


def recover(
    journal: DecisionJournal,
    *,
    pod_lookup: PodLookup,
    binder: Any,
    breaker: Any = None,
    crash_seam: Any = None,
) -> RecoveryReport:
    """Run the recovery protocol (module docstring) over an OPEN journal.

    `binder` must be the replica's full bind chain (fence + journal +
    monitors), so completions are fenced and re-journaled exactly like
    live binds. Deterministic: lifecycles reconcile in sorted order.
    `crash_seam` is the chaos process seam (None in production) — the
    crash-during-recovery regime consumes one `crash_recovery` event
    after a reconcile action lands, proving recovery is re-entrant."""
    report = RecoveryReport()
    state = journal.state
    report.resume_rv = state.last_rv
    if breaker is not None and state.breaker is not None:
        try:
            breaker.restore(state.breaker)
            report.breaker_restored = True
        except Exception:
            logger.exception("breaker restore failed; starting CLOSED")
    open_lifecycles = state.open_lifecycles()
    for (ns, name), rec in sorted(open_lifecycles.items()):
        status, node_now = pod_lookup(ns, name)
        if status == "gone":
            journal.record_drop(ns, name, "pod gone at recovery")
            report.dropped += 1
        elif status == "bound":
            # landed before the crash (to our node, or — lease failover
            # while we were down — to someone else's choice); either way
            # the obligation is discharged, record the truth
            journal.record_ack(ns, name, node_now, ok=True, recovered=True)
            report.acked += 1
        else:
            # decided but unbound: complete WITHOUT re-deciding. The
            # chain fences this under the re-acquired lease; a refusal
            # (fence lost, cluster said no) leaves the pod pending for
            # the shard's live owner — never silently dropped.
            ok = binder.bind_pod_to_node(name, ns, rec["node"])
            if ok:
                report.rebound += 1
            else:
                report.failed += 1
                logger.warning(
                    "recovery: completion bind refused for %s/%s -> %s "
                    "(pod stays pending)", ns, name, rec["node"],
                )
        if crash_seam is not None:
            event = crash_seam.should("crash_recovery", key=f"{ns}/{name}")
            if event is not None:
                raise SimulatedCrash("recovery", f"{ns}/{name}")
    logger.info(
        "recovery: %d acked, %d rebound, %d dropped, %d refused "
        "(resume rv=%s, breaker %s)",
        report.acked, report.rebound, report.dropped, report.failed,
        report.resume_rv,
        "restored" if report.breaker_restored else "fresh",
    )
    return report
