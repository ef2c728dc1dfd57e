"""Closed policy-improvement loop: mine losses -> finetune -> promote.

- learn/miner.py: loss-incident extraction from arena/chaos traces into
  a versioned on-disk incident corpus (per-class counts, provenance).
- learn/curriculum.py: deterministic reconstruction of incident decision
  states + replay-mixed finetune batches over train/distill machinery.
- learn/loop.py: the LearnLoop controller driving mine -> finetune ->
  registry publish -> two-sided gate (mined-weakness improvement + base
  arena tolerance) -> hot-swap promotion, with a byte-replayable trace.

Surfaces: `cli learn mine/build/run/status/replay` and
`bench.py --preset learn`.
"""

from k8s_llm_scheduler_tpu_torch.learn.curriculum import (
    curriculum_batches,
    curriculum_summary,
    incident_cases,
    reconstruct_cases,
)
from k8s_llm_scheduler_tpu_torch.learn.loop import (
    LearnConfig,
    LearnError,
    LearnLoop,
    backend_decide,
    build_learn_trace,
    finetune_on_corpus,
    load_learn_trace,
    replay_learn_trace,
    save_learn_trace,
    verify_learn_trace,
    weakness_report,
)
from k8s_llm_scheduler_tpu_torch.learn.miner import (
    CorpusError,
    IncidentCorpus,
    corpus_digest,
    decide_policy_arm,
    mine_arena_report,
    mine_chaos_report,
    mine_placements,
    mine_scenario,
    per_class_counts,
)

__all__ = [
    "CorpusError",
    "IncidentCorpus",
    "LearnConfig",
    "LearnError",
    "LearnLoop",
    "backend_decide",
    "build_learn_trace",
    "corpus_digest",
    "curriculum_batches",
    "curriculum_summary",
    "decide_policy_arm",
    "finetune_on_corpus",
    "incident_cases",
    "load_learn_trace",
    "mine_arena_report",
    "mine_chaos_report",
    "mine_placements",
    "mine_scenario",
    "per_class_counts",
    "reconstruct_cases",
    "replay_learn_trace",
    "save_learn_trace",
    "verify_learn_trace",
    "weakness_report",
]
