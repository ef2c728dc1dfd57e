"""LearnLoop: mine -> finetune -> publish -> gate -> promote, as one unit.

The capstone controller over five existing planes. Every stage already
existed in-tree — the sim arena finds waves where the policy loses to
the spread-lookahead reference, train/distill.py turns teacher decisions
into weighted training pairs, train/train_step.py finetunes, rollout/
gates/swaps/rolls back — and this module is the missing spine that makes
"sim finds a weakness -> policy improves -> canary promotes" ONE seeded,
replayable operation instead of a human copy-pasting between five CLIs.

One `run_cycle` is:

1. **mine** (learn/miner.py): seeded scenarios run the incumbent against
   the teacher; loss incidents land in the versioned incident corpus,
   lineage pointing at the incumbent's registry version.
2. **build** (learn/curriculum.py): incidents reconstruct into training
   cases, mixed with base-distribution replay at `replay_fraction`.
3. **finetune**: TrainState + causal_lm_loss over the curriculum batches
   (seeded init, deterministic batch order), starting FROM the incumbent
   checkpoint so the candidate is an increment, not a reroll.
4. **publish**: the candidate enters the rollout registry with lineage
   (parent = incumbent, scores carry the corpus version + digest).
5. **gate**, two-sided: the candidate must STRICTLY beat the incumbent
   on the mined-weakness cases (`weakness_report` — the very cases the
   corpus says the incumbent lost), AND stay within tolerance on the
   base arena (`rollout/canary.run_gate` — the catastrophic-forgetting
   backstop the replay fraction exists to make passable).
6. **promote**: staggered/quiesced hot swap through the provided
   swapper on pass; rejected-version memory on fail (a failed candidate
   is never re-gated every cycle).

The deterministic record of a cycle is its learn TRACE (sim/trace.py
discipline): the mined sources, the corpus digest, every weakness-case
decision, and the gate placements — everything timing-free. Replay
re-derives the incidents, scores, checks, and action from the recorded
decisions alone (no model re-run) and must byte-compare.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Any, Callable, Sequence

from k8s_llm_scheduler_tpu_torch.learn.curriculum import (
    curriculum_batches,
    curriculum_summary,
    incident_cases,
)
from k8s_llm_scheduler_tpu_torch.learn.miner import (
    IncidentCorpus,
    corpus_digest,
    mine_placements,
    mine_scenario,
    per_class_counts,
    source_digest,
)
from k8s_llm_scheduler_tpu_torch.observability import spans
from k8s_llm_scheduler_tpu_torch.rollout.canary import GateConfig
from k8s_llm_scheduler_tpu_torch.sim.scenarios import ScenarioSpec
from k8s_llm_scheduler_tpu_torch.types import NodeMetrics, PodSpec

logger = logging.getLogger(__name__)

LEARN_TRACE_VERSION = 1

DecideFn = Callable[[PodSpec, Sequence[NodeMetrics]], "str | None"]


class LearnError(RuntimeError):
    pass


# ------------------------------------------------------------------ config
@dataclasses.dataclass
class LearnConfig:
    """One cycle's knobs, all seed-derived where it matters."""

    seed: int = 0
    # mining: one arena scenario per seed, covering the shared taxonomy
    mine_seeds: tuple[int, ...] = (0, 1)
    mine_nodes: int = 8
    mine_pods: int = 48
    mine_shapes: int = 8
    mine_waves: int = 3
    constraint_mix: tuple[str, ...] = (
        "uniform", "selector", "tainted", "affinity"
    )
    taint_frac: float = 0.2
    spread_margin: float = 0.005
    # curriculum / finetune
    replay_fraction: float = 0.3
    steps: int = 200
    batch_size: int = 4
    seq_len: int = 1024
    lr: float = 3e-4
    # weakness gate: candidate must beat incumbent by MORE than margin on
    # the mined cases (strict — a tie is not an improvement)
    weakness_cases: int = 32
    weakness_margin: float = 0.0
    # base-arena tolerance gate (rollout/canary.run_gate)
    gate: GateConfig = dataclasses.field(default_factory=GateConfig)
    # registry retention after a cycle (0 = keep all); the retention walk
    # receives the loop's pinned set (open candidate + corpus lineage)
    retain: int = 0

    def mine_specs(self) -> list[ScenarioSpec]:
        return [
            ScenarioSpec(
                name=f"learn-mine-{seed}",
                seed=int(seed),
                n_nodes=self.mine_nodes,
                n_pods=self.mine_pods,
                shapes=self.mine_shapes,
                arrival="waves",
                n_waves=self.mine_waves,
                hetero=True,
                taint_frac=self.taint_frac,
                constraint_mix=tuple(self.constraint_mix),
            )
            for seed in self.mine_seeds
        ]


# --------------------------------------------------------------- weakness
def backend_decide(backend) -> DecideFn:
    """A DecisionBackend as a bare decide function (the train/eval shape):
    backend errors and infeasibility read as abstention, exactly as
    evaluate_checkpoint scores them."""
    from k8s_llm_scheduler_tpu_torch.engine.backend import (
        BackendError,
        NoFeasibleNodeError,
    )

    def decide(pod: PodSpec, nodes: Sequence[NodeMetrics]) -> str | None:
        try:
            return backend.get_scheduling_decision(pod, nodes).selected_node
        except (NoFeasibleNodeError, BackendError):
            return None

    return decide


def _score_decisions(
    cases: Sequence[tuple[PodSpec, list[NodeMetrics], str]],
    decisions: Sequence[dict],
) -> dict:
    """THE one weakness scorer, shared by the live gate (weakness_report)
    and trace replay (_score_recorded_weakness): agreement with the
    distillation SUPERVISOR (core/fallback resource_balanced — what the
    curriculum trains toward) over (case, recorded decision) pairs. A
    scoring-rule change made in only one consumer would make replays
    diverge from every recorded trace, so there is only one body."""
    from k8s_llm_scheduler_tpu_torch.train.eval import teacher_decide

    per_class: dict[str, dict[str, int]] = {}
    agree = total = 0
    for rec in decisions:
        pod, nodes, kind = cases[int(rec["idx"])]
        got = rec["got"]
        target = teacher_decide(pod, nodes)
        if target is None:
            continue
        total += 1
        bucket = per_class.setdefault(kind, {"n": 0, "agree": 0})
        bucket["n"] += 1
        valid = got is not None and got in {n.name for n in nodes}
        if valid and got == target:
            agree += 1
            bucket["agree"] += 1
    return {
        "n_cases": total,
        "score": round(agree / total, 6) if total else 0.0,
        "per_class": {k: dict(v) for k, v in sorted(per_class.items())},
        "decisions": list(decisions),
    }


def weakness_report(
    decide: DecideFn,
    cases: Sequence[tuple[PodSpec, list[NodeMetrics], str]],
) -> dict:
    """Run `decide` over the mined-weakness cases and score it against
    the supervisor teacher (see _score_decisions)."""
    decisions = [
        {"idx": idx, "pod": pod.name, "kind": kind,
         "got": decide(pod, nodes)}
        for idx, (pod, nodes, kind) in enumerate(cases)
    ]
    return _score_decisions(cases, decisions)


def _score_recorded_weakness(
    cases: Sequence[tuple[PodSpec, list[NodeMetrics], str]],
    decisions: Sequence[dict],
) -> dict:
    """Rescore RECORDED decisions (trace replay: no model re-run — the
    sim/trace discipline of re-deriving everything derivable from
    recorded choices), after validating they align with the
    reconstructed cases."""
    checked: list[dict] = []
    for rec in decisions:
        idx = int(rec["idx"])
        if idx >= len(cases):
            raise LearnError(
                f"recorded weakness case idx {idx} exceeds reconstructed "
                f"case count {len(cases)}"
            )
        pod, _nodes, kind = cases[idx]
        if pod.name != rec["pod"] or kind != rec["kind"]:
            raise LearnError(
                f"recorded weakness case {idx} ({rec['pod']}/{rec['kind']}) "
                f"does not match reconstruction ({pod.name}/{kind})"
            )
        checked.append(
            {"idx": idx, "pod": pod.name, "kind": kind, "got": rec["got"]}
        )
    return _score_decisions(cases, checked)


# --------------------------------------------------------------- finetune
def finetune_on_corpus(
    model_cfg,
    tokenizer_name: str,
    record: dict,
    out_dir: str,
    *,
    base_checkpoint: str | None = None,
    steps: int = 200,
    batch_size: int = 4,
    seq_len: int = 1024,
    lr: float = 3e-4,
    replay_fraction: float = 0.3,
    seed: int = 0,
    answer_style: str = "direct",
    mesh_axes: dict | None = None,
    log_every: int = 25,
    cases: "Sequence[tuple] | None" = None,
    device: str = "cuda",
) -> float:
    """The loop's default trainer: TrainState + causal_lm_loss over the
    corpus curriculum, seeded init, deterministic batch order, starting
    from `base_checkpoint` (the incumbent) when given. Saves a native
    checkpoint (models/loader.save_checkpoint) to `out_dir`; returns the
    final loss. `cases` forwards pre-reconstructed incident cases to the
    curriculum (the loop reconstructs once per cycle).

    The port trains on one `device` (train/train_step.make_train_step with
    AdamW at `lr`); `mesh_axes` wider than one device raise through
    train_step.refuse_mesh (ROADMAP queue 1 item 9c)."""
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import build_builtin_tokenizer
    from k8s_llm_scheduler_tpu_torch.models.loader import (
        restore_checkpoint,
        save_checkpoint,
    )
    from k8s_llm_scheduler_tpu_torch.train.train_step import adamw, make_train_step

    tokenizer, cfg = build_builtin_tokenizer(tokenizer_name, model_cfg)
    init_fn, step_fn = make_train_step(
        cfg, device, optimizer=adamw(lr), mesh_axes=mesh_axes
    )
    if base_checkpoint is not None:
        state = init_fn(restore_checkpoint(base_checkpoint, cfg, device=device))
    else:
        state = init_fn(seed)
    batches = curriculum_batches(
        tokenizer, record,
        batch_size=batch_size, seq_len=seq_len,
        replay_fraction=replay_fraction, seed=seed,
        answer_style=answer_style, cases=cases,
    )
    loss = float("nan")
    for step in range(1, steps + 1):
        tokens, lens, starts, weights = next(batches)
        tokens, lens, starts, weights = step_fn.place_batch(
            tokens, lens, starts, weights
        )
        state, loss_arr = step_fn(state, tokens, lens, starts, weights)
        if step % log_every == 0 or step == steps:
            loss = float(loss_arr)
            logger.info(
                "learn finetune step %d/%d loss %.4f", step, steps, loss
            )
    save_checkpoint(out_dir, state.params)
    return loss


# -------------------------------------------------------------------- loop
class LearnLoop:
    """The closed policy-improvement controller.

    Pluggable seams so the cycle logic is testable without a model (and
    so `bench.py --preset learn` / `cli learn run` can drive the real
    micro engine through the identical code path):

    - `mine_arm_factory() -> sim.ArmSpec`: the incumbent as an arena arm
      (stack arm for the production surface, policy arm for cheap runs);
    - `incumbent_decide_factory() -> (DecideFn, close)`: the incumbent
      as a bare decide function for the weakness gate;
    - `candidate_decide_factory(ckpt_dir) -> (DecideFn, close)`: same,
      for the freshly trained candidate;
    - `train_fn(record, out_dir) -> loss`: the finetune stage (default:
      finetune_on_corpus from the incumbent checkpoint — requires
      model_cfg + tokenizer_name);
    - `gate_runner(version) -> run_gate verdict`: the base-arena
      tolerance gate;
    - `swapper.swap_to(version)`: optional live promotion (HotSwapper or
      rollout/canary.staggered_swap wrapper); without one the cycle just
      moves the registry's active pointer.
    """

    def __init__(
        self,
        registry,
        corpus: IncidentCorpus,
        config: LearnConfig | None = None,
        *,
        mine_arm_factory: Callable[[], Any],
        incumbent_decide_factory: Callable[[], tuple[DecideFn, Callable]],
        candidate_decide_factory: Callable[[str], tuple[DecideFn, Callable]],
        gate_runner: Callable[[int], dict],
        train_fn: Callable[[dict, str], float] | None = None,
        model_cfg: Any = None,
        tokenizer_name: str = "byte",
        answer_style: str = "direct",
        mesh_axes: dict | None = None,
        swapper: Any = None,
        device: str = "cuda",
    ) -> None:
        self.registry = registry
        self.corpus = corpus
        self.config = config or LearnConfig()
        self.mine_arm_factory = mine_arm_factory
        self.incumbent_decide_factory = incumbent_decide_factory
        self.candidate_decide_factory = candidate_decide_factory
        self.gate_runner = gate_runner
        self.train_fn = train_fn
        self.model_cfg = model_cfg
        self.tokenizer_name = tokenizer_name
        self.answer_style = answer_style
        self.mesh_axes = mesh_axes
        self.swapper = swapper
        self.device = device
        if train_fn is None and model_cfg is None:
            raise ValueError(
                "LearnLoop needs either train_fn or model_cfg (+ tokenizer) "
                "for the default finetune stage"
            )
        self.rejected: set[int] = set()
        self._open_candidate: int | None = None
        # (corpus version, reconstructed cases) memo for the current cycle
        self._cycle_cases: tuple | None = None
        # incumbent checkpoint path captured at mine time (see
        # _default_train)
        self._cycle_base_ckpt: str | None = None
        self.counters = {
            "cycles": 0,
            "incidents_mined": 0,
            "weakness_pass": 0,
            "weakness_fail": 0,
            "gate_pass": 0,
            "gate_fail": 0,
            "promotions": 0,
            "rejections": 0,
        }
        self.last_cycle: dict | None = None

    # ------------------------------------------------------------- stages
    def mine_sources(self) -> list[dict]:
        return [
            mine_scenario(
                spec, self.mine_arm_factory(),
                spread_margin=self.config.spread_margin,
                wave_timeout_s=self.config.gate.wave_timeout_s,
            )
            for spec in self.config.mine_specs()
        ]

    def _weakness_cases(self, record: dict):
        return self._cases_for(record)[: self.config.weakness_cases]

    def _cases_for(self, record: dict):
        """Reconstruct the corpus's incident cases ONCE per cycle (the
        build, finetune, and gate stages all consume the same list —
        re-replaying the teacher trajectory three times per cycle is
        pure waste)."""
        if (
            self._cycle_cases is None
            or self._cycle_cases[0] != record.get("version")
        ):
            self._cycle_cases = (
                record.get("version"), incident_cases(record)
            )
        return self._cycle_cases[1]

    def _default_train(self, record: dict, out_dir: str) -> float:
        # finetune from the incumbent CAPTURED AT MINE TIME, never a
        # re-read of the active pointer: a promotion landing mid-cycle
        # (another loop, `cli rollout promote`) must not make the
        # candidate's lineage point at a checkpoint that never produced
        # the mined placements
        base = self._cycle_base_ckpt
        cfg = self.config
        return finetune_on_corpus(
            self.model_cfg, self.tokenizer_name, record, out_dir,
            base_checkpoint=base,
            steps=cfg.steps, batch_size=cfg.batch_size,
            seq_len=cfg.seq_len, lr=cfg.lr,
            replay_fraction=cfg.replay_fraction, seed=cfg.seed,
            answer_style=self.answer_style, mesh_axes=self.mesh_axes,
            cases=self._cases_for(record),
            device=self.device,
        )

    def pinned_versions(self) -> set[int]:
        """Registry versions the retention walk must never evict: the
        candidate currently mid-cycle (published but not yet judged) and
        every checkpoint any incident-corpus version mined against
        (rollout/registry.retain pinned set — the eviction bug this PR
        fixes)."""
        pinned = set(self.corpus.lineage_versions())
        if self._open_candidate is not None:
            pinned.add(self._open_candidate)
        return pinned

    # -------------------------------------------------------------- cycle
    def run_cycle(self, work_dir: str | Path, note: str = "") -> dict:
        """One full mine -> finetune -> publish -> gate -> promote pass.

        Returns the cycle report; the deterministic trace payload rides
        under "_trace" (build_learn_trace extracts it; timing and loss
        stay outside it, like the arena's report/trace split)."""
        cfg = self.config
        work_dir = Path(work_dir)
        work_dir.mkdir(parents=True, exist_ok=True)
        out_dir = str(work_dir / "candidate")
        report: dict[str, Any] = {"seed": cfg.seed}
        self.counters["cycles"] += 1
        with spans.start_trace("learn_cycle"):
            with spans.span("learn.mine") as sp:
                incumbent_version = self.registry.active()
                self._cycle_base_ckpt = (
                    str(self.registry.get(incumbent_version).checkpoint_path)
                    if incumbent_version is not None
                    else None
                )
                sources = self.mine_sources()
                record = self.corpus.add_version(
                    sources,
                    checkpoint_version=incumbent_version,
                    note=note or f"learn cycle {self.counters['cycles']}",
                )
                self.counters["incidents_mined"] += record["n_incidents"]
                if sp is not None:
                    sp.attrs.update(
                        incidents=record["n_incidents"],
                        corpus_version=record["version"],
                    )
            report["corpus_version"] = record["version"]
            report["corpus_digest"] = record["digest"]
            report["per_class"] = record["per_class"]

            with spans.span("learn.build"):
                report["curriculum"] = curriculum_summary(
                    record, cfg.replay_fraction,
                    cases=self._cases_for(record),
                )

            with spans.span("learn.finetune"):
                train = self.train_fn or self._default_train
                report["train_loss"] = train(record, out_dir)

            with spans.span("learn.publish"):
                manifest = self.registry.publish(
                    out_dir,
                    cfg=self.model_cfg,
                    tokenizer=self.tokenizer_name,
                    parent=incumbent_version,
                    scores={"learn": {
                        "corpus_version": record["version"],
                        "corpus_digest": record["digest"],
                        "per_class": record["per_class"],
                    }},
                    note=note or "learn loop candidate",
                )
                version = manifest.version
                self._open_candidate = version
            report["candidate_version"] = version
            report["incumbent_version"] = incumbent_version

            try:
                with spans.span("learn.gate") as sp:
                    weakness, gate = self._gate(record, out_dir, version)
                    if sp is not None:
                        sp.attrs.update(
                            weakness_pass=weakness["pass"],
                            gate_pass=gate["pass"],
                        )
                report["weakness"] = {
                    k: weakness[k]
                    for k in ("incumbent", "candidate", "margin", "pass")
                }
                report["gate"] = {
                    "pass": gate["pass"], "checks": gate["checks"],
                }
                promoted = weakness["pass"] and gate["pass"]
                with spans.span("learn.swap") as sp:
                    if promoted:
                        if self.swapper is not None:
                            report["swap"] = self.swapper.swap_to(version)
                        self.registry.set_active(version)
                        self.counters["promotions"] += 1
                        report["action"] = "promoted"
                    else:
                        # rejected-version memory: this candidate is never
                        # re-gated; the next cycle mines + trains afresh
                        self.rejected.add(version)
                        self.counters["rejections"] += 1
                        report["action"] = "rejected"
                    if sp is not None:
                        sp.attrs.update(action=report["action"])
                self.registry.record_scores(version, {"learn_gate": {
                    "weakness": {
                        "incumbent": weakness["incumbent"]["score"],
                        "candidate": weakness["candidate"]["score"],
                        "pass": weakness["pass"],
                    },
                    "base": {"pass": gate["pass"], "checks": gate["checks"]},
                    "action": report["action"],
                }})
            finally:
                self._open_candidate = (
                    version if report.get("action") is None else None
                )

        if cfg.retain:
            self.registry.retain(cfg.retain, pinned=self.pinned_versions())

        report["_trace"] = self._build_trace(
            sources, record, weakness, gate, report["action"]
        )
        logger.info(
            "learn cycle %d: %s candidate v%d (weakness %.3f -> %.3f, "
            "base gate %s)",
            self.counters["cycles"], report["action"], version,
            weakness["incumbent"]["score"], weakness["candidate"]["score"],
            gate["pass"],
        )
        self.last_cycle = {
            k: report[k]
            for k in (
                "action", "candidate_version", "corpus_version", "per_class",
            )
        }
        return report

    def _gate(self, record: dict, out_dir: str, version: int):
        cfg = self.config
        cases = self._weakness_cases(record)
        if not cases:
            raise LearnError("weakness gate has zero reconstructable cases")
        inc_decide, inc_close = self.incumbent_decide_factory()
        try:
            incumbent = weakness_report(inc_decide, cases)
        finally:
            inc_close()
        if incumbent["n_cases"] == 0:
            # the supervisor abstained on every reconstructed case: the
            # gate would be vacuous (0.0 vs 0.0 rejects forever) —
            # refuse loudly instead of burning a finetune per cycle
            raise LearnError(
                "weakness gate scored zero cases (supervisor teacher "
                "abstained on every mined state)"
            )
        cand_decide, cand_close = self.candidate_decide_factory(out_dir)
        try:
            candidate = weakness_report(cand_decide, cases)
        finally:
            cand_close()
        weakness = {
            "incumbent": incumbent,
            "candidate": candidate,
            "margin": cfg.weakness_margin,
            "pass": candidate["score"] > incumbent["score"]
            + cfg.weakness_margin,
        }
        self.counters[
            "weakness_pass" if weakness["pass"] else "weakness_fail"
        ] += 1
        gate = dict(self.gate_runner(version))
        self.counters["gate_pass" if gate["pass"] else "gate_fail"] += 1
        return weakness, gate

    # -------------------------------------------------------------- trace
    def _build_trace(
        self, sources, record, weakness, gate, action
    ) -> dict:
        gcfg = self.config.gate
        return {
            "version": LEARN_TRACE_VERSION,
            "seed": self.config.seed,
            "mine": {
                "sources": [_trace_source(s) for s in sources],
                "per_class": record["per_class"],
                "corpus_digest": record["digest"],
            },
            "weakness": {
                "margin": self.config.weakness_margin,
                "incumbent": _trace_weakness(weakness["incumbent"]),
                "candidate": _trace_weakness(weakness["candidate"]),
                "pass": weakness["pass"],
            },
            "gate": {
                "scenario_spec": gate["scenario_spec"],
                "config": {
                    "spread_tolerance": gcfg.spread_tolerance,
                    "constraint_tolerance": gcfg.constraint_tolerance,
                    "bound_tolerance": gcfg.bound_tolerance,
                },
                "incumbent": gate["traces"]["incumbent"],
                "candidate": gate["traces"]["candidate"],
                "checks": gate["checks"],
                "pass": gate["pass"],
            },
            "action": action,
        }

    def stats(self) -> dict:
        out = {
            **self.counters,
            "active_version": self.registry.active(),
            "rejected": sorted(self.rejected),
            "corpus_versions": len(self.corpus.versions()),
        }
        if self.last_cycle is not None:
            out["last_cycle"] = dict(self.last_cycle)
        return out


def _trace_source(source: dict) -> dict:
    keys = (
        "scenario_spec", "arm", "reference", "placements", "unschedulable",
        "ref_placements", "ref_unschedulable", "spread_margin", "incidents",
        "trace_digest",
    )
    return {k: source[k] for k in keys}


def _trace_weakness(side: dict) -> dict:
    return {
        "score": side["score"],
        "n_cases": side["n_cases"],
        "per_class": side["per_class"],
        "decisions": side["decisions"],
    }


# ------------------------------------------------------------ trace replay
def build_learn_trace(report: dict) -> dict:
    return report["_trace"]


def save_learn_trace(report: dict, path) -> bytes:
    from k8s_llm_scheduler_tpu_torch.sim.trace import canonical_bytes

    data = canonical_bytes(build_learn_trace(report))
    Path(path).write_bytes(data)
    return data


def load_learn_trace(path) -> dict:
    return json.loads(Path(path).read_bytes().decode("utf-8"))


def replay_learn_trace(trace: dict) -> dict:
    """Re-derive everything derivable from the recorded trace: incidents
    from the recorded placements, the corpus digest from the re-mined
    sources, weakness scores from the recorded per-case decisions, gate
    scores from the recorded gate placements, checks and the action from
    the recorded tolerances. Returns a NEW trace whose canonical bytes
    must equal the recorded ones — no model, no training re-run."""
    from k8s_llm_scheduler_tpu_torch.sim.arena import score_placement
    from k8s_llm_scheduler_tpu_torch.sim.scenarios import generate_scenario

    if trace.get("version") != LEARN_TRACE_VERSION:
        raise LearnError(
            f"learn trace version {trace.get('version')!r} != "
            f"{LEARN_TRACE_VERSION}"
        )
    # ---- mine: re-derive incidents + digests from recorded placements
    sources_out = []
    for rec in trace["mine"]["sources"]:
        spec = ScenarioSpec.from_dict(rec["scenario_spec"])
        scenario = generate_scenario(spec)
        pod_names = {p.name for wave in scenario.waves for p in wave}
        unknown = (
            set(rec["placements"]) | set(rec["ref_placements"])
        ) - pod_names
        if unknown:
            raise LearnError(
                f"trace places pods the scenario never generated: "
                f"{sorted(unknown)[:5]}"
            )
        source = {
            "scenario_spec": spec.to_dict(),
            "arm": rec["arm"],
            "reference": rec["reference"],
            "placements": dict(sorted(rec["placements"].items())),
            "unschedulable": sorted(rec["unschedulable"]),
            "ref_placements": dict(sorted(rec["ref_placements"].items())),
            "ref_unschedulable": sorted(rec["ref_unschedulable"]),
            "spread_margin": rec["spread_margin"],
        }
        source["incidents"] = mine_placements(
            scenario,
            source["placements"], source["unschedulable"],
            source["ref_placements"], source["ref_unschedulable"],
            spread_margin=float(rec["spread_margin"]),
        )
        source["trace_digest"] = source_digest(source)
        sources_out.append(source)
    record_like = {"sources": sources_out, "version": None}

    # ---- weakness: reconstruct cases, rescore recorded decisions
    cases = incident_cases(record_like)
    n_cases = max(
        (int(d["idx"]) + 1
         for side in ("incumbent", "candidate")
         for d in trace["weakness"][side]["decisions"]),
        default=0,
    )
    cases = cases[: max(n_cases, 0)] if n_cases else []
    margin = float(trace["weakness"]["margin"])
    incumbent = _score_recorded_weakness(
        cases, trace["weakness"]["incumbent"]["decisions"]
    )
    candidate = _score_recorded_weakness(
        cases, trace["weakness"]["candidate"]["decisions"]
    )
    weakness_pass = candidate["score"] > incumbent["score"] + margin

    # ---- gate: rescore recorded placements, re-derive checks
    gspec = ScenarioSpec.from_dict(trace["gate"]["scenario_spec"])
    gscenario = generate_scenario(gspec)
    gate_cfg = trace["gate"]["config"]
    sides = {}
    for side in ("incumbent", "candidate"):
        rec = trace["gate"][side]
        scores = score_placement(
            gscenario, dict(rec["placements"]),
            rec.get("unschedulable", ()),
        )
        sides[side] = {
            "placements": dict(sorted(rec["placements"].items())),
            "unschedulable": sorted(rec.get("unschedulable", ())),
            "scores": scores,
        }
    inc_s, cand_s = sides["incumbent"]["scores"], sides["candidate"]["scores"]
    checks = {
        "spread": cand_s["spread"]
        <= inc_s["spread"] + float(gate_cfg["spread_tolerance"]),
        "constraint_satisfaction": (
            cand_s["constraint_satisfaction"]
            >= inc_s["constraint_satisfaction"]
            - float(gate_cfg["constraint_tolerance"])
        ),
        "bound_frac": (
            cand_s["bound_frac"]
            >= inc_s["bound_frac"] - float(gate_cfg["bound_tolerance"])
        ),
    }
    gate_pass = all(checks.values())

    return {
        "version": LEARN_TRACE_VERSION,
        "seed": trace["seed"],
        "mine": {
            "sources": sources_out,
            "per_class": per_class_counts(sources_out),
            "corpus_digest": corpus_digest(sources_out),
        },
        "weakness": {
            "margin": margin,
            "incumbent": _trace_weakness(incumbent),
            "candidate": _trace_weakness(candidate),
            "pass": weakness_pass,
        },
        "gate": {
            "scenario_spec": gspec.to_dict(),
            "config": dict(gate_cfg),
            "incumbent": sides["incumbent"],
            "candidate": sides["candidate"],
            "checks": checks,
            "pass": gate_pass,
        },
        "action": "promoted" if (weakness_pass and gate_pass) else "rejected",
    }


def verify_learn_trace(path) -> tuple[bool, str]:
    """(ok, detail): replay the recorded learn trace and byte-compare."""
    import difflib

    from k8s_llm_scheduler_tpu_torch.sim.trace import canonical_bytes

    recorded = Path(path).read_bytes()
    replayed = canonical_bytes(replay_learn_trace(json.loads(recorded)))
    recorded_canon = canonical_bytes(json.loads(recorded))
    if replayed == recorded_canon:
        return True, f"bit-identical ({len(replayed)} bytes)"
    a = json.dumps(json.loads(recorded_canon), indent=1, sort_keys=True)
    b = json.dumps(json.loads(replayed), indent=1, sort_keys=True)
    diff = "\n".join(
        list(difflib.unified_diff(
            a.splitlines(), b.splitlines(), "recorded", "replayed"
        ))[:40]
    )
    return False, f"replay diverged:\n{diff}"
