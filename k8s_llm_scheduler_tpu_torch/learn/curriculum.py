"""Curriculum: mined incidents -> deterministic finetune batches.

The bridge between the incident corpus (learn/miner.py) and the train
step (train/train_step.py). Three responsibilities:

1. **Case reconstruction** (`reconstruct_cases`): an incident records
   only (scenario spec, wave, pod name) — the scenario regenerates from
   its seed and the decision STATE the pod was judged in replays
   deterministically: the reference trajectory is the spread-lookahead
   teacher replayed exactly as the arena's policy runner replays it
   (sim/arena._run_policy_arm discipline — one snapshot per wave, all of
   a wave's decisions against it, placements folded after). The corpus
   therefore ships kilobytes of provenance, not serialized tensors, and
   two machines reconstruct bit-identical training cases.

2. **Supervision** rides the established distillation machinery: each
   reconstructed case goes through train/distill.case_to_pair — the SAME
   teacher (`resource_balanced`), answer format, name-span weighting,
   and CoT scratchpad path the bootstrap corpus uses. The lookahead
   teacher is the *detector* (it finds where the policy loses); the
   computable heuristic remains the *supervisor* (it is what the runtime
   can actually distill and what the weakness gate scores against).

3. **Replay mixing** (`curriculum_batches`): each batch row draws mined
   hard cases with probability (1 - replay_fraction) and the base
   training distribution (train/distill.random_cases) otherwise — the
   anti-catastrophic-forgetting knob. Pinned behavior: replay_fraction
   1.0 degenerates to pure base-distribution batches, 0.0 to pure
   incident batches, and the row order is a pure function of the seed
   (the learn loop's "deterministic batch order" contract).
"""

from __future__ import annotations

import logging
from typing import Iterator, Sequence

import numpy as np

from k8s_llm_scheduler_tpu_torch.sim.scenarios import (
    ClusterModel,
    ScenarioSpec,
    generate_scenario,
)
from k8s_llm_scheduler_tpu_torch.sim.teacher import SpreadLookaheadTeacher
from k8s_llm_scheduler_tpu_torch.types import NodeMetrics, PodSpec

logger = logging.getLogger(__name__)


def reconstruct_cases(
    spec_dict: dict,
    wanted: dict[str, str],
) -> list[tuple[PodSpec, list[NodeMetrics], str]]:
    """Rebuild the (pod, snapshot) decision states for `wanted`
    ({pod name -> scenario class}) by replaying the reference trajectory.

    Mirrors sim/arena._run_policy_arm exactly: churn applies before the
    wave, ONE snapshot serves the whole wave, the teacher's own
    placements fold in after the wave — so the state a mined pod is
    reconstructed in is the state the reference decided it in, every
    time, on every machine."""
    scenario = generate_scenario(ScenarioSpec.from_dict(spec_dict))
    teacher = SpreadLookaheadTeacher()
    teacher.reset()
    model = ClusterModel(scenario)
    out: list[tuple[PodSpec, list[NodeMetrics], str]] = []
    remaining = dict(wanted)
    for wave_idx, wave in enumerate(scenario.waves):
        model.apply_churn(scenario.churn_for_wave(wave_idx))
        if not wave:
            continue
        snapshot = model.metrics()
        teacher.begin_wave()
        decided: list[tuple] = []
        for pod in wave:
            spec = pod.to_pod_spec()
            if pod.name in remaining:
                out.append((spec, snapshot, remaining.pop(pod.name)))
            node = teacher.decide(spec, snapshot)
            if node is not None:
                decided.append((pod, node))
        for pod, node in decided:
            model.place(pod, node)
        if not remaining:
            break
    if remaining:
        raise ValueError(
            f"incident pods not in scenario {spec_dict.get('name')!r}: "
            f"{sorted(remaining)[:5]}"
        )
    return out


def incident_cases(
    record: dict,
) -> list[tuple[PodSpec, list[NodeMetrics], str]]:
    """Every corpus version's incidents as reconstructed cases, in the
    corpus's own deterministic order (sources in recorded order,
    incidents in their sorted order)."""
    out: list[tuple[PodSpec, list[NodeMetrics], str]] = []
    for source in record["sources"]:
        wanted = {
            inc["pod"]: inc["kind"] for inc in source["incidents"]
        }
        if wanted:
            out.extend(reconstruct_cases(source["scenario_spec"], wanted))
    return out


def curriculum_summary(
    record: dict,
    replay_fraction: float,
    cases: "Sequence[tuple] | None" = None,
) -> dict:
    """What `cli learn build` prints: reconstructable rows per class plus
    the mix the batches will draw. `cases` lets a caller that already
    reconstructed the corpus (the learn loop does it once per cycle)
    skip the scenario regen + teacher replay."""
    if cases is None:
        cases = incident_cases(record)
    per_class: dict[str, int] = {}
    for _pod, _nodes, kind in cases:
        per_class[kind] = per_class.get(kind, 0) + 1
    return {
        "corpus_version": record["version"],
        "corpus_digest": record["digest"],
        "incident_cases": len(cases),
        "per_class": dict(sorted(per_class.items())),
        "replay_fraction": replay_fraction,
        "incident_fraction": round(1.0 - replay_fraction, 6),
    }


def curriculum_batches(
    tokenizer,
    record: dict,
    *,
    batch_size: int,
    seq_len: int,
    replay_fraction: float = 0.3,
    seed: int = 0,
    n_nodes: int = 5,
    answer_style: str = "direct",
    name_weight: float = 8.0,
    cot_weight: float = 1.0,
    cases: "Sequence[tuple] | None" = None,
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Endless batched (tokens, seq_lens, answer_starts, loss_weights)
    mixing reconstructed incident cases with base-distribution replay.
    `cases` (pre-reconstructed incident cases) skips the per-call
    reconstruction for callers that already hold them.

    Deterministic: the mix decisions, the incident epoch shuffles, and
    the replay stream all derive from `seed` alone, so two runs of the
    same (corpus version, seed) train on identical batches in identical
    order — the property the learn loop's seeded-finetune contract and
    its byte-compared trace lean on."""
    from k8s_llm_scheduler_tpu_torch.core.prompt import PromptEngine
    from k8s_llm_scheduler_tpu_torch.train.distill import (
        case_to_pair,
        clip_row,
        random_cases,
    )

    if not 0.0 <= replay_fraction <= 1.0:
        raise ValueError(
            f"replay_fraction must be in [0, 1], got {replay_fraction}"
        )
    hard = list(cases) if cases is not None else incident_cases(record)
    pe = PromptEngine()
    if replay_fraction < 1.0:
        # liveness: keep only incident cases the supervisor can actually
        # supervise (case_to_pair abstains when fallback_decision finds
        # no feasible node). With replay_fraction 0.0 an all-abstain
        # corpus would otherwise redraw forever inside the batch loop —
        # raise up front instead of hanging the finetune stage.
        hard = [
            case for case in hard
            if case_to_pair(
                tokenizer, pe, case[0], case[1],
                answer_style=answer_style,
                name_weight=name_weight, cot_weight=cot_weight,
            ) is not None
        ]
        if not hard:
            raise ValueError(
                f"corpus v{record.get('version')} has no supervisable "
                "incident cases (teacher abstains on every reconstructed "
                "state) — nothing to finetune on"
            )
    mix_rng = np.random.default_rng(seed)
    epoch_rng = np.random.default_rng(seed + 1)
    replay = random_cases(n_nodes=n_nodes, seed=seed + 17)

    def hard_stream():
        while True:
            order = epoch_rng.permutation(len(hard))
            for i in order:
                yield hard[int(i)][:2]

    hard_it = hard_stream() if hard else None
    warned = False
    pad = tokenizer.pad_id
    while True:
        tokens = np.full((batch_size, seq_len), pad, dtype=np.int32)
        lens = np.zeros(batch_size, dtype=np.int32)
        starts = np.zeros(batch_size, dtype=np.int32)
        weights = np.ones((batch_size, seq_len), dtype=np.float32)
        b = 0
        while b < batch_size:
            use_replay = (
                hard_it is None or mix_rng.random() < replay_fraction
            )
            pod, nodes = next(replay if use_replay else hard_it)
            pair = case_to_pair(
                tokenizer, pe, pod, nodes,
                answer_style=answer_style,
                name_weight=name_weight, cot_weight=cot_weight,
            )
            if pair is None:
                continue  # teacher abstained: redraw (deterministically)
            ids, ans_start, _span, w_ids = pair
            ids, ans_start, w_ids, clipped = clip_row(
                ids, ans_start, w_ids, seq_len
            )
            if clipped and not warned:
                logger.warning(
                    "curriculum rows exceed seq_len=%d; truncating prompt "
                    "context from the left (answers preserved)", seq_len,
                )
                warned = True
            tokens[b, : len(ids)] = ids
            lens[b] = len(ids)
            starts[b] = ans_start
            weights[b, : len(ids)] = w_ids
            b += 1
        yield tokens, lens, starts, weights
