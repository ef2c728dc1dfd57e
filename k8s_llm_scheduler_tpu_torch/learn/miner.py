"""Loss-incident mining: turn arena/chaos runs into a training corpus.

The policy-improvement loop (learn/loop.py) starts here. A *loss
incident* is a pod where the serving policy demonstrably lost to the
spread-lookahead reference on the canonical replayable record of a run
(sim/trace.py arena traces, chaos/harness.py chaos reports):

- **unbound**: the arm left the pod unschedulable while the reference
  bound it;
- **constraint**: the arm's placement violates the pod's static
  selector/taint/affinity predicates (core/validation — a K8s-contract
  break, mined unconditionally);
- **divergence**: the arm placed the pod differently from the reference
  in a wave the reference WON — the arm's cumulative fill spread after
  that wave exceeds the reference's by more than `spread_margin`. A
  divergent pod in a wave the arm won (or tied) is taste, not a loss,
  and is deliberately not mined.

Mining is a PURE function of (scenario, candidate placements, reference
placements): `mine_placements` re-derives the per-wave cumulative state
through the deterministic ClusterModel, so the same trace always mines
the same incidents — which is what lets the learn trace replay
byte-identically (learn/loop.py) and what makes an incident corpus a
reproducible artifact rather than a log scrape.

Incidents are deduplicated by (scenario-class, shape, wave, reason):
same-shape pods in one wave are replicas of one pod template (the
decision-cache coherence group — sim/scenarios.py draws constraints once
per shape), so one exemplar with a count carries the same training
signal as thirty copies. Classes come from the shared taxonomy
train/eval.SCENARIO_CLASSES — the corpus's per-class counts speak the
same language as `cli eval --scenarios` and the arena's constraint_mix.

`IncidentCorpus` is the versioned on-disk store: one monotonically
numbered version per mining pass, canonical-JSON sources (the
deterministic mining record: scenario spec, both placement maps,
incidents), a content digest over exactly that deterministic payload,
and provenance — seeds, per-source trace digests, and the registry
checkpoint version that produced the mined placements (the lineage the
registry's retention pinning protects; rollout/registry.py).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import time
from pathlib import Path
from typing import Any, Callable, Sequence

from k8s_llm_scheduler_tpu_torch.core.validation import (
    node_affinity_matches,
    selector_matches,
    tolerates_taints,
)
from k8s_llm_scheduler_tpu_torch.sim.scenarios import (
    ClusterModel,
    Scenario,
    ScenarioSpec,
    generate_scenario,
)
from k8s_llm_scheduler_tpu_torch.types import NodeMetrics

logger = logging.getLogger(__name__)

MINE_REASONS = ("unbound", "constraint", "divergence")

_VERSION_FMT = "v{:06d}"
_CORPUS_FILE = "corpus.json"
_POINTER = "corpus_index.json"


class CorpusError(RuntimeError):
    pass


def _canonical_bytes(obj: dict) -> bytes:
    # sim/trace.py discipline: one byte-stable serialization everywhere
    from k8s_llm_scheduler_tpu_torch.sim.trace import canonical_bytes

    return canonical_bytes(obj)


def _load_spread(nodes: Sequence[NodeMetrics]) -> float:
    from k8s_llm_scheduler_tpu_torch.train.eval import load_spread

    return load_spread(nodes)


def _static_node_metrics(fact) -> NodeMetrics:
    """A SimNode's static facts as a NodeMetrics for the validation
    predicates (same construction as sim/arena.score_placement)."""
    return NodeMetrics(
        name=fact.name, cpu_usage_percent=0.0, memory_usage_percent=0.0,
        available_cpu_cores=fact.cpu_cores,
        available_memory_gb=fact.memory_gb,
        pod_count=0, max_pods=fact.max_pods,
        labels=dict(fact.labels), taints=fact.taints,
        conditions={"Ready": "True"},
    )


def mine_placements(
    scenario: Scenario,
    placements: dict[str, str],
    unschedulable: Sequence[str],
    ref_placements: dict[str, str],
    ref_unschedulable: Sequence[str],
    *,
    spread_margin: float = 0.005,
) -> list[dict]:
    """Pure incident extraction from two placement maps over one scenario.

    Walks the waves cumulatively through two ClusterModels (candidate and
    reference), judging each wave by the fill spread AFTER it, and each
    pod by the rules in the module docstring. Deterministic: pods iterate
    in name order inside each wave, dedup keys are value tuples, and the
    output is sorted — same inputs, same bytes (the learn-trace replay
    contract rests on this)."""
    node_facts = {n.name: n for n in scenario.nodes}
    cand_model = ClusterModel(scenario)
    ref_model = ClusterModel(scenario)
    # dedup by (kind, shape, wave, reason): same-shape pods in one wave
    # are replicas of one template — one exemplar + count
    buckets: dict[tuple, dict] = {}
    for wave_idx, wave in enumerate(scenario.waves):
        churn = scenario.churn_for_wave(wave_idx)
        cand_model.apply_churn(churn)
        ref_model.apply_churn(churn)
        for pod in wave:
            if pod.name in placements:
                cand_model.place(pod, placements[pod.name])
            if pod.name in ref_placements:
                ref_model.place(pod, ref_placements[pod.name])
        cand_spread = _load_spread(cand_model.metrics())
        ref_spread = _load_spread(ref_model.metrics())
        wave_beaten = cand_spread > ref_spread + spread_margin
        for pod in sorted(wave, key=lambda p: p.name):
            got = placements.get(pod.name)
            ref = ref_placements.get(pod.name)
            reason = None
            if got is None:
                if ref is not None:
                    reason = "unbound"
            else:
                fact = node_facts.get(got)
                spec = pod.to_pod_spec()
                if fact is not None:
                    node = _static_node_metrics(fact)
                    if not (
                        selector_matches(spec, node)
                        and tolerates_taints(spec, node)
                        and node_affinity_matches(spec, node)
                    ):
                        reason = "constraint"
                if reason is None and ref is not None and got != ref \
                        and wave_beaten:
                    reason = "divergence"
            if reason is None:
                continue
            key = (pod.kind, pod.shape, wave_idx, reason)
            bucket = buckets.get(key)
            if bucket is None:
                buckets[key] = {
                    "pod": pod.name,
                    "kind": pod.kind,
                    "shape": pod.shape,
                    "wave": wave_idx,
                    "reason": reason,
                    "count": 1,
                    "got": got,
                    "reference": ref,
                }
            else:
                bucket["count"] += 1
    return sorted(
        buckets.values(),
        key=lambda b: (b["kind"], b["shape"], b["wave"], b["reason"]),
    )


def source_digest(source: dict) -> str:
    """Provenance digest over one source's deterministic payload (the
    recorded placements + incidents — the fields replay recomputes)."""
    payload = {
        k: source[k]
        for k in (
            "scenario_spec", "placements", "unschedulable",
            "ref_placements", "ref_unschedulable", "incidents",
        )
    }
    return hashlib.sha256(_canonical_bytes(payload)).hexdigest()[:16]


def mine_arena_report(
    report: dict,
    arm: str,
    reference: str = "teacher",
    *,
    spread_margin: float = 0.005,
) -> dict:
    """One mined SOURCE record from an arena report (run_arena output with
    its `_traces`, or a loaded sim trace dict with `arms`)."""
    arms = report.get("_traces") or report.get("arms")
    if arms is None or arm not in arms or reference not in arms:
        raise CorpusError(
            f"report has no per-arm placements for {arm!r} vs {reference!r} "
            f"(have {sorted(arms) if arms else []})"
        )
    spec_dict = report.get("scenario") or report.get("scenario_spec")
    if spec_dict is None:
        raise CorpusError("report carries no scenario spec")
    scenario = generate_scenario(ScenarioSpec.from_dict(spec_dict))
    cand = arms[arm]
    ref = arms[reference]
    source = {
        "scenario_spec": ScenarioSpec.from_dict(spec_dict).to_dict(),
        "arm": arm,
        "reference": reference,
        "placements": dict(sorted(cand["placements"].items())),
        "unschedulable": sorted(cand.get("unschedulable", ())),
        "ref_placements": dict(sorted(ref["placements"].items())),
        "ref_unschedulable": sorted(ref.get("unschedulable", ())),
        "spread_margin": spread_margin,
    }
    source["incidents"] = mine_placements(
        scenario,
        source["placements"], source["unschedulable"],
        source["ref_placements"], source["ref_unschedulable"],
        spread_margin=spread_margin,
    )
    source["trace_digest"] = source_digest(source)
    return source


def mine_chaos_report(report: dict, *, spread_margin: float = 0.005) -> dict:
    """A source record from a chaos run report (chaos/harness.run_chaos
    output or a loaded chaos trace): the reference side is the fault-free
    teacher policy replayed over the same scenario — the same comparison
    the report's `quality` section already makes, here per pod."""
    from k8s_llm_scheduler_tpu_torch.sim.arena import _run_policy_arm
    from k8s_llm_scheduler_tpu_torch.sim.teacher import SpreadLookaheadTeacher

    spec = ScenarioSpec.from_dict(report["scenario_spec"])
    scenario = generate_scenario(spec)
    ref_placements, ref_unsched, _waves = _run_policy_arm(
        scenario, SpreadLookaheadTeacher()
    )
    source = {
        "scenario_spec": spec.to_dict(),
        "arm": report.get("regime", "chaos"),
        "reference": "teacher",
        "placements": dict(sorted(report["placements"].items())),
        "unschedulable": sorted(report.get("unschedulable", ())),
        "ref_placements": dict(sorted(ref_placements.items())),
        "ref_unschedulable": sorted(ref_unsched),
        "spread_margin": spread_margin,
    }
    source["incidents"] = mine_placements(
        scenario,
        source["placements"], source["unschedulable"],
        source["ref_placements"], source["ref_unschedulable"],
        spread_margin=spread_margin,
    )
    source["trace_digest"] = source_digest(source)
    return source


def decide_policy_arm(name: str, decide: Callable) -> Any:
    """A bare decide(pod, nodes) function as a sim POLICY arm — the cheap
    mining mode (sequential deterministic replay over the ClusterModel,
    no wire stack). The production surface (`cli learn mine`) runs the
    incumbent as a STACK arm instead; this is for the loop's greedy
    real-engine mining and for tests, where the stack's plumbing is not
    the thing being measured."""
    from k8s_llm_scheduler_tpu_torch.sim.arena import ArmSpec

    class _DecidePolicy:
        def decide(self, pod, nodes):
            return decide(pod, nodes)

    return ArmSpec(name=name, kind="policy", make=_DecidePolicy)


def mine_scenario(
    spec: ScenarioSpec,
    candidate_arm,
    *,
    spread_margin: float = 0.005,
    wave_timeout_s: float = 120.0,
) -> dict:
    """Run one seeded scenario with `candidate_arm` (an sim.ArmSpec)
    against the spread-lookahead teacher and mine the result — the live
    mining path `cli learn mine` and the loop use."""
    from k8s_llm_scheduler_tpu_torch.sim.arena import run_arena, teacher_arm

    scenario = generate_scenario(spec)
    report = run_arena(
        scenario, [candidate_arm, teacher_arm()],
        wave_timeout_s=wave_timeout_s,
    )
    return mine_arena_report(
        report, candidate_arm.name, "teacher", spread_margin=spread_margin
    )


def per_class_counts(sources: Sequence[dict]) -> dict[str, int]:
    from k8s_llm_scheduler_tpu_torch.train.eval import SCENARIO_CLASSES

    counts = {kind: 0 for kind in SCENARIO_CLASSES}
    for source in sources:
        for incident in source["incidents"]:
            counts[incident["kind"]] = (
                counts.get(incident["kind"], 0) + int(incident["count"])
            )
    return {k: v for k, v in counts.items() if v}


def corpus_digest(sources: Sequence[dict]) -> str:
    """Content digest over the DETERMINISTIC corpus payload — the same
    bytes learn-trace replay recomputes, so a trace and the corpus it
    references can never silently disagree."""
    payload = {
        "sources": [
            {
                k: s[k]
                for k in (
                    "scenario_spec", "placements", "unschedulable",
                    "ref_placements", "ref_unschedulable", "incidents",
                )
            }
            for s in sources
        ]
    }
    return hashlib.sha256(_canonical_bytes(payload)).hexdigest()[:16]


class IncidentCorpus:
    """Versioned on-disk incident store: <root>/v000001/corpus.json.

    Same write-aside + rename discipline as the checkpoint registry
    (rollout/registry.py): a version lands atomically or not at all, and
    version ids stay monotonic across deletes via the pointer file."""

    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        for stale in self.root.glob(".staging-*"):
            shutil.rmtree(stale, ignore_errors=True)

    # ------------------------------------------------------------- pointer
    def _pointer(self) -> dict:
        p = self.root / _POINTER
        if not p.exists():
            return {"next_version": 1}
        with open(p) as fh:
            return json.load(fh)

    def _write_pointer(self, data: dict) -> None:
        tmp = self.root / (_POINTER + ".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(data, fh, indent=1, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.root / _POINTER)

    # ------------------------------------------------------------ versions
    def versions(self) -> list[int]:
        out = []
        for d in self.root.iterdir():
            if d.is_dir() and d.name.startswith("v") and (
                d / _CORPUS_FILE
            ).exists():
                try:
                    out.append(int(d.name[1:]))
                except ValueError:
                    continue
        return sorted(out)

    def get(self, version: int) -> dict:
        path = self.root / _VERSION_FMT.format(version) / _CORPUS_FILE
        if not path.exists():
            raise CorpusError(
                f"corpus {self.root}: no version {version} "
                f"(have {self.versions()})"
            )
        with open(path) as fh:
            return json.load(fh)

    def latest(self) -> dict | None:
        versions = self.versions()
        return self.get(versions[-1]) if versions else None

    # --------------------------------------------------------------- write
    def add_version(
        self,
        sources: Sequence[dict],
        *,
        checkpoint_version: int | None = None,
        note: str = "",
    ) -> dict:
        """Persist one mining pass as the next corpus version.

        `checkpoint_version` is the registry version whose decisions were
        mined — the corpus lineage pointer retention pinning protects
        (rollout/registry.retain pinned set)."""
        sources = [dict(s) for s in sources]
        if not sources:
            raise CorpusError("refusing to write an empty corpus version")
        n_incidents = sum(
            int(i["count"]) for s in sources for i in s["incidents"]
        )
        if not n_incidents:
            raise CorpusError(
                "mining produced zero incidents — nothing to learn from "
                "(the candidate beat the reference everywhere)"
            )
        ptr = self._pointer()
        version = int(ptr["next_version"])
        record = {
            "version": version,
            "created_at": time.time(),  # graftlint: ok[raw-clock, wall-clock-in-replay] — wall-clock metadata for operators, never compared against durations
            "checkpoint_version": checkpoint_version,
            "note": note,
            "per_class": per_class_counts(sources),
            "n_incidents": n_incidents,
            "digest": corpus_digest(sources),
            "sources": sources,
        }
        staging = self.root / f".staging-{_VERSION_FMT.format(version)}-{os.getpid()}"
        if staging.exists():
            shutil.rmtree(staging)
        staging.mkdir(parents=True)
        try:
            with open(staging / _CORPUS_FILE, "w", encoding="utf-8") as fh:
                json.dump(record, fh, indent=1, sort_keys=True)
                fh.flush()
                os.fsync(fh.fileno())
            os.rename(staging, self.root / _VERSION_FMT.format(version))
        except Exception:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        ptr["next_version"] = version + 1
        self._write_pointer(ptr)
        logger.info(
            "incident corpus v%d: %d incidents across %d source(s) %s",
            version, n_incidents, len(sources), record["per_class"],
        )
        return record

    # --------------------------------------------------------------- reads
    def lineage_versions(self) -> set[int]:
        """Registry checkpoint versions referenced by ANY corpus version —
        the set the registry's retention walk must never evict."""
        out: set[int] = set()
        for v in self.versions():
            ckpt = self.get(v).get("checkpoint_version")
            if ckpt is not None:
                out.add(int(ckpt))
        return out

    def status(self) -> dict:
        versions = []
        for v in self.versions():
            record = self.get(v)
            versions.append({
                "version": v,
                "n_incidents": record["n_incidents"],
                "per_class": record["per_class"],
                "checkpoint_version": record.get("checkpoint_version"),
                "digest": record["digest"],
                "note": record.get("note", ""),
                "sources": len(record["sources"]),
            })
        return {"root": str(self.root), "versions": versions}
