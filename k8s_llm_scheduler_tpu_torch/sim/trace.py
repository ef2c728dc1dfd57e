"""Deterministic trace record/replay for arena runs.

A trace is the DETERMINISTIC payload of an arena run: the scenario spec
(the seed regenerates topology and workload bit-for-bit), every arm's
placement map, its unschedulable set, and its scores. Timing — wave
attribution, wall clocks — deliberately lives OUTSIDE the trace, in the
report: it varies run to run and would break bit-identity.

Replay re-derives everything derivable:
1. regenerate the scenario from the recorded spec,
2. re-fold each arm's recorded placements through the ClusterModel,
3. recompute scores with arena.score_placement,
4. re-serialize canonically.

`verify_trace` asserts the recomputed bytes equal the recorded bytes —
the acceptance bar "replaying a recorded trace is bit-identical". Any
drift (a scoring change, a scenario-generator change, a corrupted file)
surfaces as a byte diff, never silently.

Canonical form: JSON with sorted keys, no whitespace, UTF-8. All floats
inside are round()ed at fixed precision by their producers, so equal
values serialize to equal bytes.
"""

from __future__ import annotations

import json
from pathlib import Path

from k8s_llm_scheduler_tpu_torch.sim.scenarios import ScenarioSpec, generate_scenario

TRACE_VERSION = 1


def canonical_bytes(obj: dict) -> bytes:
    return json.dumps(
        obj, sort_keys=True, separators=(",", ":"), ensure_ascii=True
    ).encode("utf-8")


def build_trace(report: dict) -> dict:
    """Extract the deterministic trace from an arena report (run_arena
    attaches per-arm placements under the private "_traces" key)."""
    return {
        "version": TRACE_VERSION,
        "scenario_spec": report["scenario"],
        "arms": report["_traces"],
    }


def save_trace(report: dict, path: str | Path) -> bytes:
    data = canonical_bytes(build_trace(report))
    Path(path).write_bytes(data)
    return data


def load_trace(path: str | Path) -> dict:
    return json.loads(Path(path).read_bytes().decode("utf-8"))


def replay_trace(trace: dict) -> dict:
    """Recompute the trace from its own spec + decisions. Returns a NEW
    trace dict whose canonical bytes must equal the original's."""
    from k8s_llm_scheduler_tpu_torch.sim.arena import score_placement

    if trace.get("version") != TRACE_VERSION:
        raise ValueError(
            f"trace version {trace.get('version')!r} != {TRACE_VERSION}"
        )
    spec = ScenarioSpec.from_dict(trace["scenario_spec"])
    scenario = generate_scenario(spec)
    pod_names = {p.name for wave in scenario.waves for p in wave}
    arms_out: dict[str, dict] = {}
    for arm, rec in trace["arms"].items():
        placements = dict(rec["placements"])
        unknown = set(placements) - pod_names
        if unknown:
            raise ValueError(
                f"arm {arm!r}: trace places pods the scenario never "
                f"generated: {sorted(unknown)[:5]}"
            )
        scores = score_placement(
            scenario, placements, rec.get("unschedulable", ())
        )
        arms_out[arm] = {
            "placements": placements,
            "unschedulable": sorted(rec.get("unschedulable", ())),
            "scores": scores,
        }
    return {
        "version": TRACE_VERSION,
        "scenario_spec": spec.to_dict(),
        "arms": arms_out,
    }


def verify_trace(path: str | Path) -> tuple[bool, str]:
    """(ok, detail): replay the recorded trace and byte-compare."""
    recorded = Path(path).read_bytes()
    replayed = canonical_bytes(replay_trace(json.loads(recorded)))
    # normalize the recorded side through canonical serialization too, so
    # a hand-pretty-printed (but semantically identical) file still passes
    recorded_canon = canonical_bytes(json.loads(recorded))
    if replayed == recorded_canon:
        return True, f"bit-identical ({len(replayed)} bytes)"
    import difflib

    a = json.dumps(json.loads(recorded_canon), indent=1, sort_keys=True)
    b = json.dumps(json.loads(replayed), indent=1, sort_keys=True)
    diff = "\n".join(
        list(difflib.unified_diff(a.splitlines(), b.splitlines(),
                                  "recorded", "replayed"))[:40]
    )
    return False, f"replay diverged:\n{diff}"
