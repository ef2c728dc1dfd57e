"""The port's durable decision journal and crash recovery held against the
JAX package's on the CPU (sched/journal.py, sched/recovery.py).

- The same record stream writes the same bytes in both packages, rotation
  and compaction included, and a journal one package wrote is read by the
  other's fsck, replay and recovery to the same folded state and the same
  reconciliation (operators moving a scheduler between the TPU and GPU
  builds keep their journal).
- The torn-tail fuzz at every byte boundary of the last record gives the
  same fsck report, folded state and dropped byte count in both packages
  (the JAX package's tests/test_durable.py torn-tail test).
- Crash restart at each kill point (post_decide, mid_bind, post_bind) over
  each package's wire fake and KubeCluster, with a duck-typed crash seam:
  every pod bound exactly once, with the same recovery counts in both
  stacks (tests/test_durable.py's wire-stack crash matrix).
"""

import logging

import pytest

from k8s_llm_scheduler_tpu.sched import journal as jjournal
from k8s_llm_scheduler_tpu.sched import recovery as jrecovery
from k8s_llm_scheduler_tpu_torch.sched import journal as tjournal
from k8s_llm_scheduler_tpu_torch.sched import recovery as trecovery
from k8s_llm_scheduler_tpu_torch.testing import cap_torch_threads

cap_torch_threads()
logging.getLogger("k8s_llm_scheduler_tpu").setLevel(logging.CRITICAL)
logging.getLogger("k8s_llm_scheduler_tpu_torch").setLevel(logging.CRITICAL)

PACKAGES = {"jax": (jjournal, jrecovery), "port": (tjournal, trecovery)}


def _script(j) -> None:
    """One scripted record stream: lifecycles that complete, fail, drop and
    stay open, an rv, a breaker trip; rotations at segment_max_records."""
    for i in range(9):
        ns, name, node = "default", f"p{i}", f"node-{i % 3}"
        j.record_decide(ns, name, node)
        if i % 4 == 3:
            continue  # decided, never reached an intent
        j.record_intent(ns, name, node, shard=i % 2, epoch=i)
        if i % 4 == 2:
            continue  # intent open: bind may or may not have landed
        if i == 5:
            j.record_drop(ns, name, "pod gone")
            continue
        j.record_ack(ns, name, node, i != 1)
        j.record_rv(str(100 + i))
    j.record_breaker({"state": "open", "failures": 3, "opened_at": 12.5})


def _write(mod, root, **kw):
    j = mod.DecisionJournal(root, fsync_policy="always", segment_max_records=7, **kw)
    _script(j)
    j.close()


def _segments(root) -> dict:
    return {p.name: p.read_bytes() for p in sorted(root.glob("seg-*.log"))}


def _state(state) -> dict:
    return {
        "open_decisions": state.open_decisions,
        "open_intents": state.open_intents,
        "acked": state.acked,
        "last_rv": state.last_rv,
        "breaker": state.breaker,
        "counts": state.counts,
    }


def _fsck(mod, root) -> dict:
    """fsck with the root path taken out of the report (the two packages
    are read from two directories)."""
    report = mod.fsck(root)
    text = repr(report).replace(str(root), "<root>")
    return {"text": text, "ok": report["ok"]}


def test_both_packages_write_the_same_bytes(tmp_path):
    _write(jjournal, tmp_path / "jax")
    _write(tjournal, tmp_path / "port")
    jax_segs, port_segs = _segments(tmp_path / "jax"), _segments(tmp_path / "port")
    assert "seg-000001.log" not in port_segs  # rotation compacted it away
    assert port_segs == jax_segs


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_journal_one_package_wrote_is_read_by_the_other(tmp_path, writer, reader):
    """fsck, replay and recovery of a journal the other package wrote: the
    same report, the same folded state, the same reconciliation, and the
    same bytes appended."""
    wmod, _ = PACKAGES[writer]
    rjournal, rrecovery = PACKAGES[reader]
    src = tmp_path / "src"
    _write(wmod, src)
    assert _fsck(rjournal, src) == _fsck(wmod, src)
    assert _fsck(rjournal, src)["ok"]
    assert _state(rjournal.replay(src)) == _state(wmod.replay(src))
    assert list(rjournal.iter_records(src)) == list(wmod.iter_records(src))

    # recovery by each package over a copy of the same journal
    pods = {("default", "p2"): ("bound", "node-2"), ("default", "p3"): ("pending", None),
            ("default", "p6"): ("gone", None), ("default", "p7"): ("pending", None)}
    outcomes = {}
    for name, (jmod, rmod) in (("writer", PACKAGES[writer]), ("reader", PACKAGES[reader])):
        root = tmp_path / name
        root.mkdir()
        for seg, data in _segments(src).items():
            (root / seg).write_bytes(data)
        binds = []

        class Binder:
            def bind_pod_to_node(self, pod, ns, node, _binds=binds):
                _binds.append((ns, pod, node))
                return True

        journal = jmod.DecisionJournal(root, fsync_policy="always")
        binder = rmod.JournaledBinder(Binder(), journal)
        report = rmod.recover(journal, pod_lookup=lambda ns, n: pods[(ns, n)], binder=binder)
        assert journal.state.open_lifecycles() == {}
        journal.close()
        outcomes[name] = (report.to_dict(), binds, _segments(root))
    assert outcomes["reader"] == outcomes["writer"]
    report, binds, _ = outcomes["reader"]
    assert (report["acked"], report["rebound"], report["dropped"]) == (1, 2, 1)
    assert report["resume_rv"] == "108" and binds == [
        ("default", "p3", "node-0"), ("default", "p7", "node-1")]


def test_torn_tail_fuzz_every_byte_boundary_matches_across_packages(tmp_path):
    """Truncating the last record at every byte boundary: both packages
    drop the same torn bytes, keep the same prefix, report the same fsck,
    and append after the tear to a physically truncated file."""
    src = tmp_path / "src"
    j = tjournal.DecisionJournal(src)
    j.record_decide("default", "p0", "n1")
    j.record_intent("default", "p0", "n1", shard=1, epoch=2)
    j.record_ack("default", "p0", "n1", True)
    j.record_intent("default", "p1", "n3")  # the record to tear
    j.close()
    seg = sorted(src.glob("seg-*.log"))[-1]
    data = seg.read_bytes()
    prefix_end = data.rfind(b"\n", 0, len(data) - 1) + 1
    for cut in range(prefix_end, len(data) + 1):
        seen = {}
        for name, (mod, _) in PACKAGES.items():
            torn = tmp_path / f"torn-{name}-{cut}"
            torn.mkdir()
            (torn / seg.name).write_bytes(data[:cut])
            before = _fsck(mod, torn)
            j2 = mod.DecisionJournal(torn)
            state = _state(j2.state)
            dropped = j2.torn_bytes_dropped
            j2.record_rv("9")
            j2.close()
            seen[name] = (before, state, dropped, _fsck(mod, torn), _segments(torn))
        assert seen["port"] == seen["jax"], cut
        before, state, dropped, after, _ = seen["port"]
        assert after["ok"] and before["ok"] == (cut in (prefix_end, len(data)))
        if cut == len(data):
            assert ("default", "p1") in state["open_intents"]
        else:
            assert ("default", "p1") not in state["open_intents"]
            assert state["acked"] == {("default", "p0"): "n1"}
            assert dropped == cut - prefix_end


class _CrashSeam:
    """Duck-typed chaos seam: the first bind crossing `point` dies."""

    def __init__(self, point: str) -> None:
        self.point = point
        self.fired = False

    def should(self, kind, key=None, where=None):
        if kind == "crash" and not self.fired and (where or {}).get("point") == self.point:
            self.fired = True
            return {"kind": kind, "key": key}
        return None


def _crash_restart(pkg: str, point: str, root) -> dict:
    """The JAX package's wire-stack crash matrix, on `pkg`'s wire fake,
    KubeCluster, journal and recovery."""
    if pkg == "jax":
        from k8s_llm_scheduler_tpu.cluster import httpapi
        from k8s_llm_scheduler_tpu.cluster.kube import KubeCluster
        from k8s_llm_scheduler_tpu.cluster.wire_fake import WireFakeK8s
    else:
        from k8s_llm_scheduler_tpu_torch.cluster import httpapi
        from k8s_llm_scheduler_tpu_torch.cluster.kube import KubeCluster
        from k8s_llm_scheduler_tpu_torch.cluster.wire_fake import WireFakeK8s
    journal_mod, recovery_mod = PACKAGES[pkg]
    wire = WireFakeK8s(auto_run=False)
    try:
        for i in range(3):
            wire.add_node(f"node-{i}")
        httpapi.set_active_config(wire.base_url)
        wire.add_pod("p0")
        wire.add_pod("p1")
        cluster = KubeCluster(watch_timeout_seconds=5)
        # "always": each kill point leaves exactly its own record set
        journal = journal_mod.DecisionJournal(root, fsync_policy="always")
        binder = recovery_mod.JournaledBinder(cluster, journal)
        binder.crash_seam = _CrashSeam(point)
        with pytest.raises(recovery_mod.SimulatedCrash) as exc:
            binder.bind_pod_to_node("p0", "default", "node-0")
        assert exc.value.point == point
        journal.abandon()
        cluster.close()
        landed = bool(wire.pod("p0")["spec"].get("nodeName"))
        # ---- cold restart on the same journal ----
        cluster2 = KubeCluster(watch_timeout_seconds=5)
        j2 = journal_mod.DecisionJournal(root)
        binder2 = recovery_mod.JournaledBinder(cluster2, j2)
        report = recovery_mod.recover(j2, pod_lookup=cluster2.lookup_pod_node, binder=binder2)
        open_after = j2.state.open_lifecycles()
        # the restarted process keeps serving: p1 binds normally
        p1_ok = binder2.bind_pod_to_node("p1", "default", "node-1")
        j2.close()
        cluster2.close()
        return {
            "landed_before_restart": landed,
            "report": report.to_dict(),
            "open_after": open_after,
            "p1_ok": p1_ok,
            "bindings": list(wire.bindings),
            "nodes": {p: wire.pod(p)["spec"].get("nodeName") for p in ("p0", "p1")},
            "fsck_ok": journal_mod.fsck(root)["ok"],
        }
    finally:
        wire.close()
        httpapi.clear_active_config()


@pytest.mark.parametrize("point", ["post_decide", "mid_bind", "post_bind"])
def test_crash_restart_binds_each_pod_exactly_once_as_the_jax_stack(tmp_path, point):
    port = _crash_restart("port", point, tmp_path / "port")
    jax = _crash_restart("jax", point, tmp_path / "jax")
    assert port == jax
    assert port["landed_before_restart"] == (point == "post_bind")
    # exactly one binding POST per pod, p0 at its journaled node, without
    # a second decision
    assert sorted(port["bindings"]) == [("default", "p0", "node-0"), ("default", "p1", "node-1")]
    assert port["nodes"] == {"p0": "node-0", "p1": "node-1"} and port["p1_ok"]
    if point == "post_bind":
        assert (port["report"]["acked"], port["report"]["rebound"]) == (1, 0)
    else:
        assert (port["report"]["acked"], port["report"]["rebound"]) == (0, 1)
    assert port["open_after"] == {} and port["fsck_ok"]
    assert _segments(tmp_path / "port") == _segments(tmp_path / "jax")
