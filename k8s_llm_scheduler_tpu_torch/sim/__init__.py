"""Cluster-twin simulator & policy arena.

The instrument the BASELINE north star is judged with: seeded scenario
generators (`scenarios.py`) drive the wire-level fake API server
(cluster/wire_fake.py) so the REAL scheduler stack — watch, snapshot,
prompt, cache, breaker, decide, bind — runs end to end; the arena
(`arena.py`) runs the same scenario across decision arms (served LLM,
each core/fallback heuristic, the sim/teacher.py spread-lookahead
reference) and scores the placements; `trace.py` records every run as a
deterministic trace that replays bit-identically and attributes per-wave
latency (snapshot vs admission vs prefill/decode vs bind).
"""

from k8s_llm_scheduler_tpu_torch.sim.arena import (
    ArmSpec,
    HeuristicBackend,
    heuristic_arms,
    run_arena,
    score_placement,
    stub_llm_arm,
    teacher_arm,
)
from k8s_llm_scheduler_tpu_torch.sim.scenarios import (
    ChurnEvent,
    ClusterModel,
    Scenario,
    ScenarioSpec,
    SimNode,
    SimPod,
    generate_scenario,
)
from k8s_llm_scheduler_tpu_torch.sim.trace import (
    build_trace,
    replay_trace,
    save_trace,
    verify_trace,
)

__all__ = [
    "ArmSpec",
    "ChurnEvent",
    "ClusterModel",
    "HeuristicBackend",
    "Scenario",
    "ScenarioSpec",
    "SimNode",
    "SimPod",
    "build_trace",
    "generate_scenario",
    "heuristic_arms",
    "replay_trace",
    "run_arena",
    "save_trace",
    "score_placement",
    "stub_llm_arm",
    "teacher_arm",
]
