"""Fine-tune the decision model on scheduler decisions (self-distillation).

The port of the JAX package's train/distill.py. It generates (cluster-state
prompt -> decision JSON) pairs from the heuristic fallback scorer as a
bootstrap teacher (in production: logged prompts and accepted placements)
and trains the decision model on them with the train step
(train/train_step.py), on one device or a rank mesh, saving a native checkpoint that
`build_local_backend(checkpoint_path=...)` serves directly.

The corpus (the CoT scratchpad code, the teacher pairs, the case
generators and `make_batches`) is the JAX module's own code, which imports
no JAX, with its imports pointed at the port; a batch is the same numpy
arrays for the same seed. `numeric_embedding_init`, the agreement probe, the CoT diagnostics
and `train_and_save` are ported. train/eval.py draws its held-out cases
from `random_cases`.

Surface: `python -m k8s_llm_scheduler_tpu_torch.cli train --steps N --out DIR`.
"""

from __future__ import annotations

import json
import logging
import math
import re
from typing import Iterator

import numpy as np

from k8s_llm_scheduler_tpu_torch.core.fallback import fallback_decision
from k8s_llm_scheduler_tpu_torch.core.prompt import PromptEngine
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import Tokenizer

logger = logging.getLogger(__name__)


def random_cases(n_nodes: int = 5, seed: int = 0):
    """Endless randomized (pod, nodes) scheduling cases — THE training
    distribution. train/eval.py draws its held-out cases from this same
    generator at a disjoint seed, so agreement measured there stays
    on-distribution by construction when this is tuned."""
    import dataclasses

    from k8s_llm_scheduler_tpu_torch.cluster.interface import raw_pod_to_spec
    from k8s_llm_scheduler_tpu_torch.testing import pod_burst, synthetic_cluster

    rng = np.random.default_rng(seed)
    while True:
        cluster = synthetic_cluster(int(rng.integers(2, n_nodes + 1)))
        base_nodes = cluster.get_node_metrics()
        cluster.close()
        # synthetic_cluster's load levels are deterministic — without this
        # perturbation the corpus collapses to ~16 distinct sequences
        nodes = [
            dataclasses.replace(
                n,
                cpu_usage_percent=float(rng.uniform(5, 95)),
                memory_usage_percent=float(rng.uniform(5, 95)),
                pod_count=int(rng.integers(0, n.max_pods // 2)),
            )
            for n in base_nodes
        ]
        for raw in pod_burst(4, distinct_shapes=4):
            pod = raw_pod_to_spec(raw)
            yield (
                dataclasses.replace(
                    pod,
                    cpu_request=round(float(rng.uniform(0.05, 2.0)), 3),
                    memory_request=round(float(rng.uniform(0.064, 2.0)), 3),
                ),
                nodes,
            )


ANSWER_PREFIX = '{"selected_node": "'


def cot_answer_ids(
    tokenizer: Tokenizer, cot: str, name: str, confidence: float
) -> tuple[list[int], tuple[int, int], tuple[int, int]]:
    """(answer token ids incl. EOS, name_span, cot_span) for a CoT-style
    decision JSON, spans RELATIVE to the answer start. THE single place
    the span arithmetic matches json.dumps serialization — teacher_pairs
    and the micro drills both build through here so a format change can
    never silently shift one of their weighted spans."""
    answer = json.dumps({
        "reasoning": cot,
        "selected_node": name,
        "confidence": round(confidence, 2),
    })
    expected_prefix = f'{{"reasoning": "{cot}", "selected_node": "{name}"'
    if not answer.startswith(expected_prefix):
        # json.dumps escaped something (quote/backslash/non-ASCII in a
        # logged name or cot) — the span arithmetic below would silently
        # land the loss weights on the wrong tokens
        raise ValueError(
            f"cot/name not serialization-transparent: {answer[:80]!r}"
        )
    cs = len(tokenizer.encode('{"reasoning": "'))
    ce = cs + len(tokenizer.encode(cot))
    np_ = len(
        tokenizer.encode(f'{{"reasoning": "{cot}", "selected_node": "')
    )
    ne = np_ + len(tokenizer.encode(name))
    return tokenizer.encode(answer) + [tokenizer.eos_id], (np_, ne), (cs, ce)


def build_cot(
    tokenizer: Tokenizer,
    names: list[str],
    scores: list[float],
    echoes: list[tuple[str, str, str]] | None = None,
    tiebreak: list[float] | None = None,
) -> tuple[str, list[str]]:
    """Running-max scratchpad CoT: `(cot_string, per-token kinds)`.

    Format (one segment per feasible node, prompt order; echo fields
    present when `echoes` is given):

        node-0 c=61.2 m=43.4 p=12/110 s=59.9 max=59.9@node-0; ... best=node-0

    Every cognitive step is LOCAL — the load-bearing redesign after the
    round-5 finding that the linear score list left the final argmax at a
    position bias for thousands of steps (a k-way comparison over tokens
    up to 100 positions back) while isolated drills learned in ~250:

    - input echoes (`c= m= p=`): LITERAL token copies of the node's
      prompt metrics (the strings are rendered exactly as
      core/prompt.render_node_block renders them, so under the numeric
      tokenizer each value is the same NUM token appearing in the
      prompt) — induction-head retrieval, decoupled from arithmetic.
      Without them the score head must fuse long-range retrieval WITH
      the weighted sum: measured at tiny capacity that plateaued at
      score MAE ~8 while the compare/copy circuits hit 100%;
    - score emission (`s=59.9`): the weighted-sum regression, now over
      the ADJACENT echoed values;
    - running max value (`max=59.9`): a TWO-way compare between the
      score just emitted and the previous segment's max, emitted as a
      copy of the winner;
    - running max name (`@node-0`): copy of the name bound to the
      winning value;
    - final choice (` best=node-0`): a copy of the adjacent last max
      name — which the constrained selected_node field copies again.

    Scores render at ONE decimal (0.1 granularity): rounding is
    monotone, so a rendered compare can never invert the true compare —
    it can only tie (~1%/pair on the uniform distribution). Measured
    A/B on granularity (EVAL.md v3): TWO-decimal rendering — motivated
    by sequential placement's equalized-score regime, where ~1 in 6
    top-2 gaps is a 0.1-rendered tie — DOUBLED the regression's
    integer-unit MAE (0.3 -> 0.6; a 1000-way fraction target is harder
    than a 10-way one) and made placement spread WORSE (0.22 -> 0.56):
    tie resolution only pays if the regression stays tighter than the
    granularity, and it did not. One decimal is the measured optimum.

    The running max follows the RENDERED compare with an explicit
    `tiebreak` rule on rendered ties (see `beats`); a pair whose
    procedure disagrees with the teacher's true-float argmax is DROPPED
    by cot_teacher_case's consistency guard, so supervision is always
    self-consistent — the corpus trades ~1-2% of near-tie cases for a
    tie policy the model can actually compute from its context.

    Kinds (aligned 1:1 with `tokenizer.encode(cot_string)`): `echo` the
    copied metric values, `score_int`/`score_dec` the score value tokens,
    `cmp_int`/`cmp_dec` the running-max value tokens, `decision` the
    final token of each max/best NAME (the choice-bearing token), `fmt`
    everything else. Piece boundaries never split a digit run, so
    per-piece encoding is concatenation-safe for both builtin tokenizers
    (asserted)."""
    pieces: list[tuple[str, str]] = []

    def num(kind: str, tenths: int) -> None:
        if tenths < 0:
            # floor-division rendering is wrong below zero; the
            # resource_balanced teacher is 0-100 by construction — refuse
            # rather than emit self-inconsistent supervision if a future
            # caller distills a signed scorer
            raise ValueError(
                f"build_cot scores must be non-negative, got {tenths / 10}"
            )
        pieces.append((kind + "_int", str(tenths // 10)))
        pieces.append(("fmt", "."))
        pieces.append((kind + "_dec", str(tenths % 10)))

    def name(kind: str, text: str) -> None:
        pieces.append((kind, text))

    def beats(i: int, j: int) -> bool:
        """Does candidate i beat the running best j? On a RENDERED tie
        (equal at 0.1) the tiebreak values decide (lower wins — teacher_cot
        passes pod counts, so the rule is 'fewest pods', derivable from
        the ADJACENT p= echo): sequential placement equalizes true scores
        to sub-rendering gaps, and a tie rule the model can actually
        compute from its context is the only learnable policy there
        (EVAL.md v3/v4: neither finer rendering nor near-exact regression
        transferred, because the deciding information was rounded away).
        Off ties, the rendered compare decides (strict >: first-wins,
        like max())."""
        ri, rj = round(scores[i] * 10), round(scores[j] * 10)
        if ri != rj:
            return ri > rj
        if tiebreak is not None and tiebreak[i] != tiebreak[j]:
            return tiebreak[i] < tiebreak[j]
        return False  # full tie: keep the incumbent (first wins)

    best_i = 0
    for i, (nm, sc) in enumerate(zip(names, scores)):
        if i and beats(i, best_i):
            best_i = i
        if i:
            pieces.append(("fmt", "; "))
        name("fmt", nm)
        if echoes is not None:
            for label, value in zip((" c=", " m=", " p="), echoes[i]):
                pieces.append(("fmt", label))
                # split the echoed value at its separators so '.'/'/' carry
                # kind 'fmt': only the DIGIT tokens are retrieval content —
                # counting separators as echo would both inflate the echo
                # diagnostic (format learnable with zero retrieval) and
                # give them cot_weight
                for part in re.split(r"([./])", value):
                    if part:
                        pieces.append(("fmt" if part in "./" else "echo", part))
            pieces.append(("fmt", " s="))
        else:
            pieces.append(("fmt", "="))
        num("score", round(sc * 10))
        pieces.append(("fmt", " max="))
        num("cmp", round(scores[best_i] * 10))
        pieces.append(("fmt", "@"))
        name("name", names[best_i])
    pieces.append(("fmt", " best="))
    name("name", names[best_i])

    cot = "".join(text for _, text in pieces)
    kinds: list[str] = []
    n_tokens = 0
    for kind, text in pieces:
        toks = tokenizer.encode(text)
        if kind == "name":
            # only the LAST token of a max/best name is the choice; the
            # shared 'node-' prefix tokens are format
            kinds.extend(["fmt"] * (len(toks) - 1) + ["decision"])
        else:
            kinds.extend([kind] * len(toks))
        n_tokens += len(toks)
    if n_tokens != len(tokenizer.encode(cot)):
        raise AssertionError(
            "build_cot pieces are not concatenation-safe for this tokenizer"
        )
    return cot, kinds


def cot_token_weights(
    kinds: list[str],
    name_weight: float,
    cot_weight: float,
    drill: bool = False,
) -> np.ndarray:
    """Per-token loss weights for a build_cot kinds list: score value
    tokens (int AND decimal digits) at `cot_weight`, compare/choice
    tokens (cmp value digits, max/best names) at `name_weight`, format
    at 1. The cmp DECIMAL digit carries name_weight too — when two
    scores tie at the integer digit, the decimal is where the compare is
    decided. `drill=True` zeroes the score tokens: micro drills carry
    RANDOM scores (not derivable from their distractor context), so
    supervising them would teach noise — only the compares, copies, and
    format carry loss."""
    w = np.ones(len(kinds), dtype=np.float32)
    for i, k in enumerate(kinds):
        if k in ("echo", "score_int", "score_dec"):
            w[i] = 0.0 if drill else cot_weight
        elif k in ("cmp_int", "cmp_dec", "decision"):
            w[i] = name_weight
    return w


def teacher_cot(pod, nodes, tokenizer: Tokenizer) -> tuple[str, list[str]]:
    """build_cot over the feasible nodes' resource-balanced scores — the
    teacher's own computation serialized as a running-max scratchpad. The
    echo fields render EXACTLY as core/prompt.render_node_block renders
    the same metrics, so each echo is a literal token copy from the
    prompt under the numeric tokenizer."""
    from k8s_llm_scheduler_tpu_torch.core.fallback import score_resource_balanced
    from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes

    cand = feasible_nodes(pod, nodes)
    return build_cot(
        tokenizer,
        [n.name for n in cand],
        [score_resource_balanced(n) for n in cand],
        echoes=[
            (
                f"{n.cpu_usage_percent:.1f}",
                f"{n.memory_usage_percent:.1f}",
                f"{n.pod_count}/{n.max_pods}",
            )
            for n in cand
        ],
        # rendered-tie rule: fewest pods wins — computable from the p=
        # echo sitting ~10 tokens back, unlike the rounded-away sub-0.1
        # score difference the teacher's true argmax actually used
        tiebreak=[float(n.pod_count) for n in cand],
    )


def cot_teacher_case(
    tokenizer: Tokenizer, pe: PromptEngine, pod, nodes
) -> tuple[list[int], list[int], tuple[int, int], tuple[int, int], list[str]] | None:
    """One full teacher scratchpad-CoT sequence, or None if the teacher
    abstains (no feasible node) or the scratchpad's conclusion
    contradicts the teacher's answer. The second branch is LOAD-BEARING:
    build_cot's running max breaks rendered ties by the explicit
    tiebreak rule (fewest pods), which can disagree with the teacher's
    true-float argmax on ~1-2% of near-tie cases — those pairs are
    dropped so supervision is always self-consistent.

    Returns (prompt_ids, answer_ids, name_span, cot_span, kinds) with the
    spans RELATIVE to the answer start — THE single construction path for
    the training corpus (teacher_pairs), the circuit diagnostics
    (make_cot_diagnostics), and any future consumer, so a format or guard
    change can never make them measure different corpora."""
    decision = fallback_decision(
        nodes, reason="teacher", strategy="resource_balanced", pod=pod
    )
    if decision is None:
        return None
    cot, kinds = teacher_cot(pod, nodes, tokenizer)
    if not cot.endswith("best=" + decision.selected_node):
        return None
    ans_ids, name_span, (cs, ce) = cot_answer_ids(
        tokenizer, cot, decision.selected_node, decision.confidence,
    )
    if ce - cs != len(kinds):
        raise AssertionError(
            "cot span arithmetic disagrees with build_cot kinds"
        )
    cluster_part, pod_part = pe.split_prompt(pod, nodes)
    prompt = tokenizer.chat_prompt(pe.system_prompt, cluster_part + pod_part)
    return prompt, ans_ids, name_span, (cs, ce), kinds


def easy_cases(n_nodes: int = 3, seed: int = 1):
    """Curriculum stream: small clusters where ONE node dominates the
    teacher score by a wide margin (low usage + low pod count vs loaded
    peers). Pure scaffolding for the number-ordering circuit — the
    held-out eval never draws from here (train/eval.py uses
    random_cases exclusively), so mixing these in cannot inflate the
    reported agreement."""
    import dataclasses

    from k8s_llm_scheduler_tpu_torch.cluster.interface import raw_pod_to_spec
    from k8s_llm_scheduler_tpu_torch.testing import pod_burst, synthetic_cluster

    rng = np.random.default_rng(seed)
    while True:
        k = int(rng.integers(2, n_nodes + 1))
        cluster = synthetic_cluster(k)
        base_nodes = cluster.get_node_metrics()
        cluster.close()
        winner = int(rng.integers(0, k))
        nodes = []
        for i, n in enumerate(base_nodes):
            if i == winner:
                lo, hi, pods_hi = 5, 25, 10
            else:
                lo, hi, pods_hi = 60, 95, 55
            nodes.append(
                dataclasses.replace(
                    n,
                    cpu_usage_percent=float(rng.uniform(lo, hi)),
                    memory_usage_percent=float(rng.uniform(lo, hi)),
                    pod_count=int(rng.integers(0, pods_hi)),
                )
            )
        for raw in pod_burst(2, distinct_shapes=2):
            pod = raw_pod_to_spec(raw)
            yield (
                dataclasses.replace(
                    pod,
                    cpu_request=round(float(rng.uniform(0.05, 2.0)), 3),
                    memory_request=round(float(rng.uniform(0.064, 2.0)), 3),
                ),
                nodes,
            )


def placement_cases(n_nodes: int = 5, seed: int = 2):
    """States visited by sequential placement ROLLOUTS — the fold
    manifold: after each teacher decision the placed node's usage is
    re-synthesized from its pod count ((pods/max)*50, exactly
    train/eval._apply_placement / reference scheduler.py:149-151) while
    its peers keep their original metrics. eval_placement walks this
    manifold for 32 consecutive decisions, so its tipping points — a
    node's synthesized usage just overtaking a peer, score gaps under 1
    point — dominate the spread metric; a model trained only on
    independent U(5,95) states carries ~±0.3 score error there and
    piles onto a stale favorite (measured: placement spread 0.295 vs
    the teacher's 0.019 at 100% single-shot agreement). Train-time seeds
    are disjoint from the eval streams; the manifold coverage is what
    transfers, not the cases."""
    import dataclasses

    from k8s_llm_scheduler_tpu_torch.train.eval import (
        _apply_placement,
        teacher_decide,
    )

    rng = np.random.default_rng(seed)
    base = random_cases(n_nodes=n_nodes, seed=seed + 11)
    while True:
        pod, nodes = next(base)
        nodes = list(nodes)
        for _ in range(int(rng.integers(4, 17))):
            p = dataclasses.replace(
                pod,
                cpu_request=round(float(rng.uniform(0.05, 2.0)), 3),
                memory_request=round(float(rng.uniform(0.064, 2.0)), 3),
            )
            yield p, list(nodes)
            target = teacher_decide(p, nodes)
            if target is None:
                break
            nodes = _apply_placement(nodes, target)


def diverse_cases(n_nodes: int = 5, seed: int = 4):
    """Constraint-dimension cases for training: heterogeneous SKUs,
    taints/tolerations, selectors, and required node affinity — the
    train/eval.scenario_cases generator family at TRAIN-DISJOINT seeds
    (the eval's scenario table stays held out; what transfers is the
    distribution, not the cases). Without these the decider learns the
    global argmax and lands BELOW chance on constrained clusters — the
    teacher's feasible-set argmax needs the model to apply the filters
    the prompt states (measured: selector class 25% vs 58% chance)."""
    from k8s_llm_scheduler_tpu_torch.train.eval import (
        SCENARIO_CLASSES,
        scenario_cases,
    )

    gens = [
        scenario_cases(kind, n_nodes=n_nodes, seed=seed + 101 + i)
        for i, kind in enumerate(SCENARIO_CLASSES)
        if kind != "uniform"
    ]
    rng = np.random.default_rng(seed)
    while True:
        yield next(gens[int(rng.integers(len(gens)))])


def case_to_pair(
    tokenizer: Tokenizer,
    pe: PromptEngine,
    pod,
    nodes,
    *,
    answer_style: str = "direct",
    name_weight: float = 8.0,
    cot_weight: float = 1.0,
) -> tuple[list[int], int, tuple[int, int], np.ndarray] | None:
    """One (pod, nodes) case -> one training row `(token ids, answer
    start, name span, loss weights)`, or None when the teacher abstains
    (no feasible node) or — for answer_style='cot' — the scratchpad's
    tie rule contradicts the teacher's true argmax (cot_teacher_case's
    consistency guard).

    THE single case->row construction path: teacher_pairs (the bootstrap
    corpus) and learn/curriculum.py (mined-incident finetune batches)
    both build through here, so a format or weighting change can never
    make the two corpora train different sequences for the same case."""
    if answer_style == "cot":
        case = cot_teacher_case(tokenizer, pe, pod, nodes)
        if case is None:
            return None
        prompt, ans_ids, (ns, ne), (cs, ce), kinds = case
        weights = np.ones(len(prompt) + len(ans_ids), dtype=np.float32)
        off = len(prompt)
        weights[off + cs : off + ce] = cot_token_weights(
            kinds, name_weight, cot_weight
        )
        weights[off + ne - 1] = name_weight
        return prompt + ans_ids, off, (off + ns, off + ne), weights
    decision = fallback_decision(
        nodes, reason="teacher", strategy="resource_balanced", pod=pod
    )
    if decision is None:
        return None
    cluster_part, pod_part = pe.split_prompt(pod, nodes)
    prompt = tokenizer.chat_prompt(pe.system_prompt, cluster_part + pod_part)
    answer = json.dumps(
        {
            "selected_node": decision.selected_node,
            "confidence": round(decision.confidence, 2),
            "reasoning": "resource balanced",
        }
    )
    name_len = len(tokenizer.encode(decision.selected_node))
    name_start = len(prompt) + len(tokenizer.encode(ANSWER_PREFIX))
    ids = prompt + tokenizer.encode(answer) + [tokenizer.eos_id]
    weights = np.ones(len(ids), dtype=np.float32)
    weights[name_start + name_len - 1] = name_weight
    return ids, len(prompt), (name_start, name_start + name_len), weights


def clip_row(
    ids: list[int],
    ans_start: int,
    weights: np.ndarray,
    seq_len: int,
) -> tuple[list[int], int, np.ndarray, bool]:
    """Fit one row into `seq_len` by truncating from the LEFT (the
    decision JSON lives at the tail; dropping the answer would train on
    prompt text only, silently learning nothing). Returns the possibly
    clipped (ids, ans_start, weights, clipped?)."""
    if len(ids) <= seq_len:
        return ids, ans_start, weights, False
    cut = len(ids) - seq_len
    return (
        ids[-seq_len:],
        max(0, ans_start - cut),
        weights[-seq_len:],
        True,
    )


def teacher_pairs(
    tokenizer: Tokenizer,
    n_nodes: int = 5,
    seed: int = 0,
    easy_frac: float = 0.0,
    answer_style: str = "direct",
    name_weight: float = 8.0,
    cot_weight: float = 1.0,
    placement_frac: float = 0.0,
    diverse_frac: float = 0.0,
) -> Iterator[tuple[list[int], int, tuple[int, int], np.ndarray]]:
    """Endless (prompt + decision tokens, answer_start, name_span,
    loss_weights) samples from the heuristic teacher over randomized
    synthetic clusters.

    Each sample is the full chat prompt (system + cluster state + pod)
    followed by the teacher's decision JSON and EOS — exactly the
    sequence the serving path decodes with the same answer_style.
    `answer_start` is the index of the first decision token: the loss
    masks to the answer span (train_step.causal_lm_loss loss_start),
    because a ~60-token answer behind a ~1.5k-token prompt otherwise
    contributes ~4% of the gradient and the decision head stays near
    uniform for hundreds of steps. `name_span` is the (start, end) token
    range of the selected_node VALUE — the decision-bearing tokens
    (EVAL.md finding 4). `loss_weights` is aligned 1:1 with the token
    list: ones outside the answer, `name_weight` on the selected_node
    choice token, and — for answer_style='cot' — the build_cot kind
    weights over the scratchpad (cmp/decision tokens at `name_weight`,
    score tokens at `cot_weight`; under a flat cot weight the choice
    tokens carried ~2% of the gradient, diluted by their own scores)."""
    pe = PromptEngine()

    fracs = (placement_frac, diverse_frac, easy_frac)
    if any(f < 0 for f in fracs) or sum(fracs) > 1.0:
        # oversubscribed fractions would silently cannibalize the later
        # streams (the cumulative-threshold chain below) — the hard
        # stream, THE training distribution, could vanish with no warning
        raise ValueError(
            f"placement_frac+diverse_frac+easy_frac must be in [0, 1]: "
            f"{fracs}"
        )

    def mixed_cases():
        hard = random_cases(n_nodes=n_nodes, seed=seed)
        if not easy_frac and not placement_frac and not diverse_frac:
            yield from hard
            return
        easy = easy_cases(seed=seed + 1)
        rollout = placement_cases(n_nodes=n_nodes, seed=seed + 3)
        diverse = diverse_cases(n_nodes=n_nodes, seed=seed + 4)
        rng = np.random.default_rng(seed + 2)
        while True:
            r = rng.random()
            if r < placement_frac:
                yield next(rollout)
            elif r < placement_frac + diverse_frac:
                yield next(diverse)
            elif r < placement_frac + diverse_frac + easy_frac:
                yield next(easy)
            else:
                yield next(hard)

    for pod, nodes in mixed_cases():
        pair = case_to_pair(
            tokenizer, pe, pod, nodes,
            answer_style=answer_style,
            name_weight=name_weight, cot_weight=cot_weight,
        )
        if pair is not None:
            yield pair


def make_batches(
    tokenizer: Tokenizer,
    batch_size: int,
    seq_len: int,
    n_nodes: int = 5,
    seed: int = 0,
    name_weight: float = 8.0,
    easy_frac: float = 0.0,
    answer_style: str = "direct",
    cot_weight: float = 1.0,
    micro_frac: float = 0.0,
    prompt_lm_frac: float = 0.0,
    placement_frac: float = 0.0,
    diverse_frac: float = 0.0,
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Batched, padded (tokens, seq_lens, answer_starts, loss_weights) for
    the train step (answer_starts feeds the loss mask; loss_weights
    upweight the FINAL selected_node value token by `name_weight` — the
    corpus' names share a 'node-' prefix, so the last token is the one
    decision-bearing choice of a ~70-token mostly-deterministic answer —
    and, for answer_style='cot', the reasoning scores by `cot_weight`).

    `micro_frac` (cot only): fraction of batch rows replaced by BARE
    answer-shaped scratchpad drills — a build_cot answer with RANDOM
    scores behind a distractor prompt slice. A 1M-param model learns the
    isolated comparison in ~250 steps while the full-prompt task leaves
    the choice tokens at a position bias for thousands (measured; the
    score REGRESSION learns fine) — these rows inject that concentrated
    compare/copy signal at realistic positions. Train-only scaffolding:
    the eval never sees them.

    `prompt_lm_frac`: fraction of rows trained with PLAIN full-sequence
    LM loss (loss_start 0, uniform weights) instead of answer masking.
    The prompt's node blocks are highly repetitive structured text —
    next-token pressure on them is the classic driver of induction-head
    formation, which the echo/retrieval circuit needs and which
    answer-only loss provides no gradient for (measured: echo accuracy
    flatlined at ~22% through 1.5k answer-masked steps while the local
    compare/copy circuits passed 90%)."""
    pairs = teacher_pairs(
        tokenizer, n_nodes=n_nodes, seed=seed, easy_frac=easy_frac,
        answer_style=answer_style, name_weight=name_weight,
        cot_weight=cot_weight, placement_frac=placement_frac,
        diverse_frac=diverse_frac,
    )
    micro_rng = np.random.default_rng(seed + 7)

    def micro_row(
        prompt_ids: list[int],
    ) -> tuple[list[int], int, tuple, np.ndarray]:
        """Running-max drill AT REALISTIC POSITIONS: a random-length slice
        of a REAL prompt (pure distractor context), then a build_cot
        answer with RANDOM scores. Loss starts at the first running-max
        value token — everything before it (the drill's score emissions)
        is unlearnable noise and carries zero weight (cot_token_weights
        drill=True); the compares, name copies, post-cot format, and the
        constrained-choice copy all carry loss."""
        k = int(micro_rng.integers(2, n_nodes + 1))
        tenths = micro_rng.choice(1001, size=k, replace=False)
        names = [f"node-{i}" for i in range(k)]
        best = int(np.argmax(tenths))
        # random echoes (zero-weighted, like the random scores): they keep
        # the drill's token geometry identical to real answers so the
        # compare/copy circuits train at the true positions
        echoes = [
            (
                f"{micro_rng.uniform(0, 100):.1f}",
                f"{micro_rng.uniform(0, 100):.1f}",
                f"{int(micro_rng.integers(0, 110))}/110",
            )
            for _ in range(k)
        ]
        cot, kinds = build_cot(
            tokenizer, names, [t / 10.0 for t in tenths], echoes=echoes
        )
        ans, (ns, ne), (cs, ce) = cot_answer_ids(
            tokenizer, cot, names[best], 0.4
        )
        aw = np.ones(len(ans), dtype=np.float32)
        aw[cs:ce] = cot_token_weights(
            kinds, name_weight, cot_weight, drill=True
        )
        aw[ne - 1] = name_weight
        first_cmp = cs + kinds.index("cmp_int")
        max_fill = max(0, min(len(prompt_ids), seq_len - len(ans)))
        fill = int(micro_rng.integers(0, max_fill + 1))
        ids = prompt_ids[:fill] + ans
        weights = np.ones(len(ids), dtype=np.float32)
        weights[fill:] = aw
        return ids, fill + first_cmp, (fill + ns, fill + ne), weights
    pad = tokenizer.pad_id
    warned = False
    while True:
        tokens = np.full((batch_size, seq_len), pad, dtype=np.int32)
        lens = np.zeros(batch_size, dtype=np.int32)
        starts = np.zeros(batch_size, dtype=np.int32)
        weights = np.ones((batch_size, seq_len), dtype=np.float32)
        for b in range(batch_size):
            ids, ans_start, _name_span, w_ids = next(pairs)
            is_drill = (
                bool(micro_frac)
                and answer_style == "cot"
                and micro_rng.random() < micro_frac
            )
            if is_drill:
                # reuse this pair's PROMPT as the drill's distractor fill
                ids, ans_start, _name_span, w_ids = micro_row(
                    ids[:ans_start]
                )
            ids, ans_start, w_ids, clipped = clip_row(
                ids, ans_start, w_ids, seq_len
            )
            if clipped and not warned:
                logger.warning(
                    "teacher pairs exceed seq_len=%d; truncating prompt "
                    "context from the left (answers preserved)", seq_len,
                )
                warned = True
            tokens[b, : len(ids)] = ids
            lens[b] = len(ids)
            starts[b] = ans_start
            weights[b, : len(ids)] = w_ids
            if (
                prompt_lm_frac
                and not is_drill  # a drill's random scores/echoes are
                # deliberately unlearnable — full-sequence loss on them
                # would push score positions toward uniform noise
                and micro_rng.random() < prompt_lm_frac
            ):
                # plain-LM row: model the whole sequence (see docstring)
                starts[b] = 0
                weights[b] = 1.0
        yield tokens, lens, starts, weights


def numeric_embedding_init(params, tokenizer) -> None:
    """Seed the NUM token embeddings with a smooth magnitude code.

    Random-init embeddings force the model to discover the ordering of 1000
    independent vectors from task reward alone; writing multi-scale sinusoid
    features of v = k/999 into the first 8 dims of the 1000 NUM rows hands
    it a comparable representation on day one (the numeracy-embedding
    trick, cf. positional encodings). In place on the params' embedding,
    before training; a no-op for tokenizers without NUM tokens."""
    import torch

    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import NumericTokenizer

    if not isinstance(tokenizer, NumericTokenizer):
        return
    v = np.arange(NumericTokenizer.NUM_COUNT, dtype=np.float32) / float(
        NumericTokenizer.NUM_COUNT - 1
    )
    feats = []
    for freq in (1.0, 2.0, 4.0, 8.0):
        feats.append(np.sin(np.pi * v * freq))
        feats.append(np.cos(np.pi * v * freq))
    block = np.stack(feats, axis=1) * 0.08  # match init scale ~1/sqrt(d)
    embed = params["embed"]
    rows = slice(NumericTokenizer.NUM_BASE,
                 NumericTokenizer.NUM_BASE + NumericTokenizer.NUM_COUNT)
    with torch.no_grad():
        embed[rows, : block.shape[1]] = torch.from_numpy(block).to(
            device=embed.device, dtype=embed.dtype)


PROBE_ROWS = 8  # rows a probe forward: 64 x 2048 tokens at once would hold
# every layer's f32 attention logits for all 64 rows


def _last_position_logits(params, cfg, tokens, lens, rows, cols):
    """f32 logits predicting the token after (rows[i], cols[i]) of a padded
    batch, from a no-grad forward of PROBE_ROWS rows at a time through the
    final residual (the LM head runs only at the probed positions)."""
    import torch

    from k8s_llm_scheduler_tpu_torch.models.llama import _logits, forward_prefill

    out = []
    with torch.no_grad():
        for r0 in range(0, tokens.shape[0], PROBE_ROWS):
            r1 = r0 + PROBE_ROWS
            *_, x = forward_prefill(params, cfg, tokens[r0:r1], lens[r0:r1],
                                    return_logits=False, return_hidden=True)
            sel = (rows >= r0) & (rows < r1)
            out.append(_logits(params, cfg, x[rows[sel] - r0, cols[sel]]))
    return torch.cat(out)


def make_agreement_probe(
    cfg,
    tokenizer: Tokenizer,
    n_cases: int = 64,
    n_nodes: int = 5,
    seed: int = 30_011,
    seq_len: int = 2048,
    answer_style: str = "direct",
    cases: "Iterator[tuple] | None" = None,
    device="cuda",
):
    """Build `probe(params) -> agreement`: greedy-serving-equivalent teacher
    agreement, cheap enough to run every few hundred train steps.

    `cases` overrides the case stream (default: the training distribution's
    random_cases at the probe seed). A finite iterator yields a probe over
    however many usable rows it produced (at most n_cases); an exhausted
    empty stream is an error, not a silent 0-case probe.

    Exactness: the decision grammar forces every token of the answer except
    the node-name choice, and the corpus' `node-K` names diverge only at the
    final K token. Greedy constrained decoding therefore equals: forward the
    prompt + '{"selected_node": "node-' and argmax the final position's
    logits over the feasible nodes' last name tokens, one batched prefill
    for the whole set. The probe seed is disjoint from the training stream
    and from train/eval.py's held-out seed (10_007).

    answer_style='cot' probes the final-choice token teacher-forced behind
    the teacher's running-max scratchpad (build_cot) up to ' best=node-':
    a short-range copy, an early-training liveness signal; the per-circuit
    numbers come from make_cot_diagnostics, the end-to-end one from `cli
    eval`."""
    import torch

    from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
    from k8s_llm_scheduler_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    pe = PromptEngine()
    if cases is None:
        cases = random_cases(n_nodes=n_nodes, seed=seed)
    rows, row_meta = [], []
    while len(rows) < n_cases:
        try:
            pod, nodes = next(cases)
        except StopIteration:
            break
        decision = fallback_decision(
            nodes, reason="teacher", strategy="resource_balanced", pod=pod
        )
        if decision is None:
            continue
        cand = feasible_nodes(pod, nodes)
        name_toks = [tokenizer.encode(n.name) for n in cand]
        shared, diverge = name_toks[0][:-1], [t[-1] for t in name_toks]
        if any(t[:-1] != shared for t in name_toks) or len(set(diverge)) != len(
            diverge
        ):
            # names without a single-token divergence point would need
            # full per-name scoring; this corpus never produces them
            continue
        cluster_part, pod_part = pe.split_prompt(pod, nodes)
        if answer_style == "cot":
            cot, _kinds = teacher_cot(pod, nodes, tokenizer)
            if not cot.endswith("best=" + decision.selected_node):
                # on rendered ties the scratchpad's tiebreak can conclude
                # another node than the teacher's float argmax: probing
                # such a case would score a correct copy as wrong
                continue
            prefix_str = '{"reasoning": "' + cot[: cot.rfind("node-")]
        else:
            prefix_str = ANSWER_PREFIX
        ids = (
            tokenizer.chat_prompt(pe.system_prompt, cluster_part + pod_part)
            + tokenizer.encode(prefix_str)
            + shared
        )
        if len(ids) > seq_len:
            ids = ids[-seq_len:]
        target = next(
            i for i, n in enumerate(cand) if n.name == decision.selected_node
        )
        rows.append(ids)
        row_meta.append((diverge, target))
    if not rows:
        raise ValueError(
            "agreement probe: the case stream yielded no usable cases"
        )
    n_rows = len(rows)
    max_k = max(len(d) for d, _ in row_meta)
    tokens = np.full((n_rows, seq_len), tokenizer.pad_id, dtype=np.int32)
    lens = np.zeros(n_rows, dtype=np.int32)
    cand_toks = np.full((n_rows, max_k), -1, dtype=np.int32)
    targets = np.zeros(n_rows, dtype=np.int32)
    for i, (ids, (diverge, target)) in enumerate(zip(rows, row_meta)):
        tokens[i, : len(ids)] = ids
        lens[i] = len(ids)
        cand_toks[i, : len(diverge)] = diverge
        targets[i] = target
    tokens_t = torch.from_numpy(tokens).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    cand_t = torch.from_numpy(cand_toks).long().to(dev)
    row_idx = torch.arange(n_rows, device=dev)

    def probe(params) -> float:
        last = _last_position_logits(params, cfg, tokens_t, lens_t, row_idx,
                                     lens_t.long() - 1)  # [N, V]
        cand_logits = last.gather(1, cand_t.clamp(min=0))
        cand_logits = torch.where(cand_t >= 0, cand_logits, float("-inf"))
        pred = cand_logits.argmax(dim=1).cpu().numpy()
        return float((pred == targets).mean())

    return probe


def make_cot_diagnostics(
    cfg,
    tokenizer: Tokenizer,
    n_cases: int = 16,
    n_nodes: int = 5,
    seed: int = 30_011,
    seq_len: int = 2048,
    device="cuda",
):
    """Build `diag(params) -> {"echo", "score", "cmp", "copy"[, "score_mae"]}`:
    teacher-forced per-circuit accuracies over full teacher sequences.

    `score` is the share of score_int tokens whose full-vocab argmax equals
    the teacher's rendered integer (the prompt -> score regression); `cmp`
    the same for cmp_int and cmp_dec tokens (the running-max compare);
    `copy` for decision tokens (the winner-name and final-choice copies);
    `echo` for the echoed metrics. Whichever is lowest is the circuit that
    holds back end-to-end agreement, which only `cli eval` measures
    (free-running generation compounds these per-step accuracies). With the
    numeric tokenizer, `score_mae` is the score regression's error in
    integer units."""
    import torch

    from k8s_llm_scheduler_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    tokens = np.full((n_cases, seq_len), tokenizer.pad_id, dtype=np.int32)
    lens = np.zeros(n_cases, dtype=np.int32)
    pos_rows: list[int] = []
    pos_cols: list[int] = []
    pos_kind: list[str] = []
    pe = PromptEngine()
    cases = random_cases(n_nodes=n_nodes, seed=seed)
    filled = 0
    while filled < n_cases:
        pod, nodes = next(cases)
        case = cot_teacher_case(tokenizer, pe, pod, nodes)
        if case is None:
            continue
        prompt, ans_ids, (ns, ne), (cs, ce), kinds = case
        ids = prompt + ans_ids
        cut = max(0, len(ids) - seq_len)
        ids = ids[cut:]
        off = len(prompt) - cut
        tokens[filled, : len(ids)] = ids
        lens[filled] = len(ids)
        for i, k in enumerate(kinds):
            col = off + cs + i
            if col <= 0 or col >= len(ids):
                continue
            if k in ("echo", "score_int", "cmp_int", "cmp_dec", "decision"):
                # cmp_dec counts toward the compare: on integer-digit score
                # ties the decimal is where the compare is decided
                pos_rows.append(filled)
                pos_cols.append(col)
                pos_kind.append(
                    {"echo": "echo", "score_int": "score", "cmp_int": "cmp",
                     "cmp_dec": "cmp"}.get(k, "copy")
                )
        # the constrained selected_node choice token is a copy too; on a
        # truncated prompt `off` can be <= 0, so the same guard applies
        col = off + ne - 1
        if 0 < col < len(ids):
            pos_rows.append(filled)
            pos_cols.append(col)
            pos_kind.append("copy")
        filled += 1
    row_idx = np.asarray(pos_rows, dtype=np.int64)
    col_idx = np.asarray(pos_cols, dtype=np.int64)
    kind_arr = np.asarray(pos_kind)
    tokens_t = torch.from_numpy(tokens).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    rows_t = torch.from_numpy(row_idx).to(dev)
    cols_t = torch.from_numpy(col_idx).to(dev)
    tgt = tokens[row_idx, col_idx]

    num_base = getattr(tokenizer, "NUM_BASE", None)
    num_count = getattr(tokenizer, "NUM_COUNT", 0)

    def diag(params) -> dict[str, float]:
        # the logits at col - 1 predict the token at col
        sel = _last_position_logits(params, cfg, tokens_t, lens_t, rows_t, cols_t - 1)
        pred = sel.argmax(dim=-1).cpu().numpy()
        hits = pred == tgt
        out = {
            k: float(hits[kind_arr == k].mean())
            for k in ("echo", "score", "cmp", "copy")
        }
        if num_base is not None:
            # the score regression's error in integer units (NUM token id -
            # NUM_BASE is the value): what bounds agreement is |error|
            # against the top-2 score gap, not exact-token accuracy
            sc = kind_arr == "score"
            p, t = pred[sc], tgt[sc]
            in_range = (p >= num_base) & (p < num_base + num_count)
            err = np.where(
                in_range, np.abs(p.astype(np.int64) - t), num_count
            )
            out["score_mae"] = float(err.mean())
        return out

    return diag


def warmup_cosine_schedule(lr: float, steps: int):
    """train_and_save's cosine schedule, optax.warmup_cosine_decay_schedule(
    0, lr, warmup, max(steps, warmup + 1), lr * 0.05) with warmup =
    max(1, min(steps // 10, 500)): n -> the learning rate of update n
    (from 0, so the first update's rate is 0, as optax's is)."""
    warmup = max(1, min(steps // 10, 500))
    decay = max(steps, warmup + 1) - warmup
    alpha = 0.05

    def schedule(n: int) -> float:
        if n < warmup:
            return lr * n / warmup
        t = min(n - warmup, decay)
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / decay)) + alpha)

    return schedule


def _restore_dir(out_dir: str) -> str | None:
    """Where `resume` restores from: out_dir, else the newer snapshot that a
    crash inside save_checkpoint's swap left at .saving (renames run only
    after the save completes), else the previous one at .old."""
    import os

    if os.path.isdir(out_dir):
        return out_dir
    for suffix in (".saving", ".old"):
        sibling = out_dir.rstrip("/") + suffix
        if os.path.isdir(sibling):
            logger.warning("resume: %s missing; falling back to %s", out_dir, sibling)
            return sibling
    return None


def train_and_save(
    cfg,
    out_dir: str,
    steps: int = 20,
    batch_size: int = 4,
    seq_len: int = 2048,
    mesh_axes: dict[str, int] | None = None,
    log_every: int = 5,
    seed: int = 0,
    lr: float = 3e-4,
    tokenizer_name: str = "byte",
    name_weight: float = 8.0,
    probe_every: int = 0,
    lr_schedule: str = "constant",
    easy_frac: float = 0.0,
    numeric_init: bool = True,
    save_every: int = 0,
    resume: bool = False,
    answer_style: str = "direct",
    cot_weight: float = 1.0,
    micro_frac: float = 0.0,
    prompt_lm_frac: float = 0.0,
    placement_frac: float = 0.0,
    diverse_frac: float = 0.0,
    registry_dir: str | None = None,
    publish_note: str = "",
    device="cuda",
    on_step=None,
) -> float:
    """Run `steps` of answer-masked fine-tuning on teacher pairs and save a
    native checkpoint (models/loader.save_checkpoint) that
    build_local_backend(checkpoint_path=...) serves. Returns the final
    loss. The `lr` default suits bootstrap distillation of the small configs
    from random init (the 1e-5 fine-tune default under-trained them by
    orders of magnitude).

    `tokenizer_name="numeric"` trains with the single-token-integer vocab
    (serve the result with llm.tokenizer: numeric). `probe_every=N` logs
    greedy held-out teacher agreement every N steps (make_agreement_probe).
    `lr_schedule="cosine"` adds a linear warmup and a cosine decay
    (warmup_cosine_schedule). `resume` restores the params from out_dir's
    latest snapshot (the moments restart). `registry_dir` also publishes
    the checkpoint into the rollout registry (rollout/registry.py) with the
    widened serving config's fingerprint and the train-side scores.
    `on_step(step, loss, state)`, when given, is called after each update
    (step from 1; `loss` the step's 0-dim device tensor), e.g. to read the
    gradients, which the state's params still hold (this rank's shards, on
    a mesh).

    `mesh_axes` (`llm.mesh`) wider than one device trains on a rank mesh
    (parallel/launch.run_spmd): this process is rank 0 and spawns the
    others, one process a rank, and every rank steps on its share. Across
    the hosts of a rendezvoused world (parallel/distributed.py) each host
    spawns its own ranks, dp and fsdp spanning hosts and tp and sp within
    each. `numeric_init` runs on the whole tree before it is split, and is
    skipped across hosts, as the JAX package skips it; `resume` reads the
    checkpoint and keeps each rank's slice. The coordinator (global rank
    0) alone saves the whole tree, gathered from the ranks, and publishes
    it. `on_step` is called on this process's rank only."""
    kwargs = {k: v for k, v in locals().items() if k not in ("mesh_axes", "on_step")}
    from k8s_llm_scheduler_tpu_torch.parallel import launch

    mesh = launch.training_mesh(mesh_axes)
    if mesh.size == 1:
        return _train_rank(None, on_step=on_step, **kwargs)
    return launch.run_spmd(mesh, _train_rank, kwargs, device=device,
                           driver_kwargs={"on_step": on_step})


def _train_rank(
    mesh, cfg, out_dir, steps, batch_size, seq_len, log_every, seed, lr, tokenizer_name,
    name_weight, probe_every, lr_schedule, easy_frac, numeric_init, save_every, resume,
    answer_style, cot_weight, micro_frac, prompt_lm_frac, placement_frac, diverse_frac,
    registry_dir, publish_note, device, on_step=None,
) -> float:
    """train_and_save on one rank of `mesh` (None: one device)."""
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import build_builtin_tokenizer
    from k8s_llm_scheduler_tpu_torch.models.llama import init_params
    from k8s_llm_scheduler_tpu_torch.models.loader import restore_checkpoint, save_checkpoint
    from k8s_llm_scheduler_tpu_torch.parallel.distributed import world
    from k8s_llm_scheduler_tpu_torch.train.train_step import (
        adamw,
        make_train_step,
        mesh_device,
    )

    coordinator = mesh is None or mesh.rank == 0
    # the shared vocab rule: serving widens the same way, so checkpoints
    # restore shape for shape
    tokenizer, cfg = build_builtin_tokenizer(tokenizer_name, cfg)
    schedule = warmup_cosine_schedule(lr, steps) if lr_schedule == "cosine" else None
    init_fn, step_fn = make_train_step(cfg, device, optimizer=adamw(lr),
                                       lr_schedule=schedule, mesh=mesh)
    restore_dir = _restore_dir(out_dir) if resume else None
    if restore_dir is not None:
        # params only: with warmup in the schedule the fresh moments cost a
        # brief re-adaptation, not the banked steps. On a mesh the whole
        # tree is read on the host and each rank keeps its slice
        state = init_fn(restore_checkpoint(restore_dir, cfg,
                                           device=device if mesh is None else "cpu"))
        logger.info("resumed params from %s", restore_dir)
    elif numeric_init and world() is None:
        dev = device if mesh is None else mesh_device(mesh, device)
        full = init_params(cfg, seed=seed, device=dev)
        numeric_embedding_init(full, tokenizer)
        state = init_fn(full)
        del full
    else:
        state = init_fn(seed)
    batches = make_batches(
        tokenizer, batch_size, seq_len, seed=seed, name_weight=name_weight,
        easy_frac=easy_frac, answer_style=answer_style,
        cot_weight=cot_weight, micro_frac=micro_frac,
        prompt_lm_frac=prompt_lm_frac, placement_frac=placement_frac,
        diverse_frac=diverse_frac,
    )
    # on a mesh every rank gathers the tree at a probe step; the
    # coordinator alone probes it
    probe = (
        make_agreement_probe(cfg, tokenizer, seq_len=seq_len,
                             answer_style=answer_style, device=device)
        if probe_every and coordinator
        else None
    )
    diag = (
        make_cot_diagnostics(cfg, tokenizer, seq_len=seq_len, device=device)
        if probe is not None and answer_style == "cot"
        else None
    )
    loss = float("nan")
    last_probe: float | None = None
    for step in range(1, steps + 1):
        placed = step_fn.place_batch(*next(batches))
        state, loss_t = step_fn(state, *placed)
        if on_step is not None:
            on_step(step, loss_t, state)
        if step % log_every == 0 or step == steps:
            loss = float(loss_t)
            if coordinator:
                logger.info("step %d/%d loss %.4f", step, steps, loss)
        if probe_every and (step % probe_every == 0 or step == steps):
            full = step_fn.gather_params(state.params)
            if probe is not None:
                last_probe = probe(full)
                logger.info(
                    "step %d/%d held-out greedy agreement%s %.1f%%",
                    step, steps,
                    " (teacher-forced CoT)" if answer_style == "cot" else "",
                    100.0 * last_probe,
                )
            if diag is not None:
                d = diag(full)
                logger.info(
                    "step %d/%d cot circuits (teacher-forced): echo %.1f%% "
                    "score %.1f%%%s cmp %.1f%% copy %.1f%%",
                    step, steps, 100.0 * d["echo"], 100.0 * d["score"],
                    f" (mae {d['score_mae']:.1f})" if "score_mae" in d else "",
                    100.0 * d["cmp"], 100.0 * d["copy"],
                )
            del full
        if save_every and step % save_every == 0 and step != steps:
            # periodic snapshot: a long run must not lose everything to one
            # crash
            full = step_fn.gather_params(state.params)
            if coordinator:
                save_checkpoint(out_dir, full)
                logger.info("step %d/%d checkpoint snapshot -> %s", step, steps, out_dir)
            del full
    full = step_fn.gather_params(state.params)
    if not coordinator:
        return loss
    save_checkpoint(out_dir, full)
    del full
    logger.info("checkpoint saved to %s", out_dir)
    if registry_dir:
        # every trained checkpoint that flows on to promotion enters the
        # registry with a fingerprint, lineage and its train scores
        from k8s_llm_scheduler_tpu_torch.rollout.registry import CheckpointRegistry

        registry = CheckpointRegistry(registry_dir)
        scores: dict = {"train": {
            "final_loss": None if loss != loss else round(loss, 6),
            "steps": steps,
            "seed": seed,
            "answer_style": answer_style,
        }}
        if last_probe is not None:
            scores["train"]["probe_agreement"] = round(last_probe, 4)
        manifest = registry.publish(
            out_dir,
            cfg=cfg,  # the widened serving config: what restore needs
            tokenizer=tokenizer_name,
            scores=scores,
            note=publish_note or f"train_and_save steps={steps}",
        )
        logger.info(
            "published checkpoint as registry version %d (parent=%s)",
            manifest.version, manifest.parent,
        )
    return loss
