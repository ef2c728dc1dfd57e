"""LocalLLMBackend — the in-process decision backend over the PyTorch engine
(the port of the JAX package's engine/local.py).

Same inputs as the reference's HuggingFaceClient._make_api_call (reference
scheduler.py:418-433) — a pod and the cluster's node metrics — and the same
output, a SchedulingDecision, with zero network: the prompt is built by
core/prompt.py, decoded by engine/engine.py under the node-name grammar
(engine/constrained.py) and parsed by utils/json_extract.py.

Concurrency: DecisionClient awaits `get_scheduling_decision_async` (no pool
thread held per in-flight pod); sync callers block on the same Future. ONE
engine-owner thread drains the queue and drives the engine with pipelined
decision waves (submit_wave / harvest_wave), as the reference's worker does
(JAX local.py:823-907, 1034-1197): a deque of waves in flight, a harvest
poll on the oldest bounded by a per-geometry EMA of wave service time,
stragglers held briefly (`partial_hold_s`) to fill a ragged tail, and group
switches under load bounded by `group_switch_after_s`. submit_wave hands
the wave to the engine's dispatcher thread and returns at once, so the
worker queues the next wave, or harvests the oldest, while one runs.

Requests group by (prompt prefix, grammar) — both keyed by the cluster
snapshot; a new group installs its prefix KV and DFA between waves, on the
worker thread only (the engine orders the install after the waves already
submitted). Advisory `prewarm_prefix` installs and `run_quiesced`
controls ride the same queue.
Idle for `prewarm_idle_delay_s`, the worker captures the wave geometries
next to those already served, one at a time (engine.prewarm_wave_siblings).

The admission plane (JAX local.py:157-200, 280-578, 955-1012): with
`packed_admission`, the items of one get_scheduling_decisions_batch call
share a pack marker and admit together through engine.admit_packed
(packed block-diagonal chunked prefill) into the paged slots, which the
worker steps every tick (`_drive_packs`) beside the waves; with
`delta_prompts`, the cluster part of every prompt renders as a pinned
snapshot plus a STATE UPDATES diff (sched/delta.py), and the snapshot's
prefix KV is pinned (engine/admission/pinned.py) before its group installs,
so the install prefills only the diff. The backend defaults both off;
build_local_backend turns packed admission on, as the JAX one does, and
the config's `admission.*` keys (cli._backend_kwargs) set both. Packs decode
through the engine's fused runtime (engine.step_fused), which falls back to
step() on its own when the grammar can't fuse.

The persistent serving loop (JAX local.py:161-181, 909-1030): with
`persistent_loop`, current-group items that fit the resident loop's
admission bucket feed its command ring (the engine enters the loop lazily)
and the worker drains its token ring every tick (`_drive_persistent`);
oversized items ride waves, which run beside the loop. The loop exits at a
control barrier, after a failed tick and at shutdown.

The engine profiler's queue-side fences (JAX local.py:648-655, 1117-1123):
a wave's oldest item's enqueue time at submit (`note_admission`), and the
ready edge the poll observes (`note_ready`); `close()` flushes the
profiler's open fences once the worker has joined.

Not ported yet: the KV plane (ROADMAP Queue 1 item 8) and the fleet pool
role (`pool_role`, `_check_role`, item 9).
"""

from __future__ import annotations

import asyncio
import logging
import queue
import threading
import time
from collections import deque
from collections.abc import Sequence
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from pathlib import Path
from types import SimpleNamespace
from typing import Any

import torch

from k8s_llm_scheduler_tpu_torch.core.prompt import PromptEngine, pod_suffix
from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
from k8s_llm_scheduler_tpu_torch.device import resolve_device
from k8s_llm_scheduler_tpu_torch.engine.backend import (
    BackendError,
    NoFeasibleNodeError,
)
from k8s_llm_scheduler_tpu_torch.engine.admission.pinned import PinnedPrefixManager
from k8s_llm_scheduler_tpu_torch.engine.constrained import build_decision_dfa
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import Tokenizer
from k8s_llm_scheduler_tpu_torch.models.configs import get_config
from k8s_llm_scheduler_tpu_torch.models.llama import init_params
from k8s_llm_scheduler_tpu_torch.models.quant import init_params_int8_host, quantize_params
from k8s_llm_scheduler_tpu_torch.observability import spans
from k8s_llm_scheduler_tpu_torch.sched.delta import SnapshotDeltaEncoder
from k8s_llm_scheduler_tpu_torch.types import (
    DecisionSource,
    NodeMetrics,
    PodSpec,
    SchedulingDecision,
)
from k8s_llm_scheduler_tpu_torch.utils.json_extract import parse_decision_json

logger = logging.getLogger(__name__)


class _WorkItem:
    __slots__ = (
        "prefix_ids", "suffix_ids", "group_key", "future", "enqueued_at",
        "enqueued_wall", "trace", "pack", "pin_spec",
    )

    def __init__(self, prefix_ids, suffix_ids, group_key):
        self.prefix_ids = prefix_ids
        # None marks an advisory prefix install (prewarm_prefix)
        self.suffix_ids = suffix_ids
        self.group_key = group_key  # (prefix token tuple, grammar names)
        # Items sharing a pack marker arrived as one batch
        # (get_scheduling_decisions_batch) and admit together through
        # engine.admit_packed instead of wave rows.
        self.pack = None
        # (pin key, pinned-prefix token ids) of a delta-encoded prompt
        # (sched/delta.py): the worker pins the snapshot prefix before
        # installing the group, so the delta-extended prefix LCP-seeds
        # from it.
        self.pin_spec = None
        self.future: Future = Future()
        self.enqueued_at = time.perf_counter()
        # wall-clock twin of enqueued_at: the engine spans attached at
        # harvest are wall-anchored (observability/spans)
        self.enqueued_wall = time.time()
        # (Trace, SpanContext) of the submitting thread, or None
        self.trace = None

    def resolve(self, text) -> None:
        """Set the result unless the caller already cancelled or timed out
        (the async path cancels the future through asyncio.wrap_future)."""
        if not self.future.done():
            self.future.set_result(text)

    def fail(self, exc: Exception) -> None:
        if not self.future.done():
            self.future.set_exception(exc)


class _ControlItem:
    """An action to run on the engine-owner thread at a wave barrier
    (run_quiesced; JAX local.py:120-138). While one is pending the worker
    admits nothing; the future resolves to (fn result, pause_s), pause_s
    being the admission-held wall time from enqueue to fn done."""

    __slots__ = ("fn", "future", "enqueued_at")

    def __init__(self, fn):
        self.fn = fn
        self.future: Future = Future()
        self.enqueued_at = time.perf_counter()

    def fail(self, exc: Exception) -> None:
        if not self.future.done():
            self.future.set_exception(exc)


class LocalLLMBackend:
    """DecisionBackend over an in-process InferenceEngine."""

    def __init__(
        self,
        engine: InferenceEngine,
        tokenizer: Tokenizer | None = None,
        max_new_tokens: int = 200,
        constrained: bool = True,
        request_timeout_s: float = 60.0,
        admit_wait_s: float = 0.002,
        group_switch_after_s: float = 0.25,
        partial_hold_s: float = 0.03,
        prewarm_idle_delay_s: float = 0.5,
        answer_style: str = "direct",
        max_reason_tokens: int = 320,
        packed_admission: bool = False,
        delta_prompts: bool = False,
        repin_fraction: float = 0.25,
        max_pins: int = 4,
        persistent_loop: bool = False,
    ) -> None:
        self.engine = engine
        # Persistent serving (engine/persistent/): the worker feeds the
        # resident loop's rings instead of submitting waves for what fits.
        # The backend flag is authoritative: it arms the engine gate too.
        self._persistent_loop = bool(persistent_loop) and hasattr(engine, "enter_persistent")
        if self._persistent_loop:
            engine.persistent_loop = True
        # in-flight resident-loop decisions: req_id -> (item, submitted_at)
        self._pers_items: dict[int, tuple[_WorkItem, float]] = {}
        # Admission plane: batch-surface decisions admit through packed
        # chunked prefill when the engine has it; delta_prompts renders
        # cluster prefixes as pinned snapshot + drift diff.
        self._packed_admission = bool(packed_admission) and hasattr(engine, "admit_packed")
        self._delta = (
            SnapshotDeltaEncoder(repin_fraction=repin_fraction) if delta_prompts else None
        )
        # (pin key, token ids) of the last pinned snapshot prefix: one
        # tokenize a pin, not a decision (a tuple swap, atomic under the GIL)
        self._pin_ids_cache: tuple | None = None
        self._pin_manager = (
            PinnedPrefixManager(engine, max_pins=max_pins)
            if hasattr(engine, "pin_prefix") else None  # engine test doubles
        )
        self.tokenizer = tokenizer or engine.tokenizer
        self.prompt_engine = PromptEngine()
        self.max_new_tokens = max_new_tokens
        self.constrained = constrained
        self.request_timeout_s = request_timeout_s
        # Coalescing window: a burst's leaders enqueue over a few ms.
        self.admit_wait_s = admit_wait_s
        # Fairness bound for (prefix, grammar) group switches under load
        # (_submit_waves).
        self.group_switch_after_s = group_switch_after_s
        # Max time a ragged wave tail may wait for stragglers while earlier
        # waves are in flight (_submit_waves.run_group).
        self.partial_hold_s = partial_hold_s
        # Decision JSON field order: "direct" or "cot" (engine/constrained.py).
        self.answer_style = answer_style
        self.max_reason_tokens = max_reason_tokens
        # Idle grace before a sibling wave geometry is captured
        # (engine.prewarm_wave_siblings): a capture blocks the worker, so it
        # must not start the instant the queue empties, when a burst's next
        # round often arrives within ms.
        self.prewarm_idle_delay_s = prewarm_idle_delay_s
        self._queue: queue.Queue = queue.Queue()
        self._dfa_cache: dict[tuple[str, ...], Any] = {}
        self._current_group: tuple | None = None
        # Controls parked until the wave barrier; while any is held,
        # _submit_waves admits nothing.
        self._held_controls: list[_ControlItem] = []
        self.swap_stats = {
            "quiesce_runs": 0,
            "last_pause_s": 0.0,
            "total_pause_s": 0.0,
        }
        # Per-geometry EMA of wave service time (WaveHandle.geo_key): the
        # deadline of the harvest poll in _worker_tick.
        self._wave_ema: dict[tuple | None, float] = {}
        self._wave_ema_default = 0.5
        self._last_harvest_t = 0.0
        # Decision calls by entry point (callers' threads, under the lock)
        # and the worker's group installs and prefix prewarms (its thread).
        self._calls_lock = threading.Lock()
        self.counters = {
            "async_calls": 0,
            "sync_calls": 0,
            "group_installs": 0,
            "prewarms_installed": 0,
            "prewarms_dropped": 0,
        }
        self._stopped = threading.Event()
        self._worker = threading.Thread(
            target=self._run_worker, daemon=True, name="llm-engine"
        )
        self._worker.start()

    def _count(self, key: str) -> None:
        with self._calls_lock:
            self.counters[key] += 1

    # ------------------------------------------------------------- backend
    def _cluster_part(self, nodes: Sequence[NodeMetrics]):
        """(cluster_part text, pin_spec | None, delta_nodes): the one
        rendering seam of real decisions and prewarms (JAX local.py:280-302).
        With delta encoding on, both land on the same pinned-snapshot +
        diff text (one group key); off, both use the plain full render."""
        if self._delta is None:
            return self.prompt_engine.cluster_part(nodes), None, 0
        dp = self._delta.encode(nodes)
        cached = self._pin_ids_cache
        if cached is not None and cached[0] == dp.pin_key:
            pin_ids = cached[1]
        else:
            # the pin's token ids in chat format (the stand-in suffix of
            # _prepare_prewarm: the prefix depends only on system and
            # cluster part)
            pin_ids, _ = self.tokenizer.chat_prompt_parts(
                self.prompt_engine.system_prompt, dp.pin_text, "x"
            )
            self._pin_ids_cache = (dp.pin_key, pin_ids)
        return dp.cluster_part, (dp.pin_key, pin_ids), dp.delta_nodes

    def _prepare_item(self, pod: PodSpec, nodes: Sequence[NodeMetrics],
                      cluster_info: tuple | None = None) -> _WorkItem:
        """`cluster_info` is a _cluster_part result computed beforehand: a
        batch renders (and diffs) the cluster once, not once a pod."""
        if not feasible_nodes(pod, nodes):
            raise NoFeasibleNodeError(
                f"no feasible node for {pod.namespace}/{pod.name}"
            )
        cluster_part, pin_spec, delta_nodes = (
            cluster_info if cluster_info is not None else self._cluster_part(nodes)
        )
        prefix_ids, suffix_ids = self.tokenizer.chat_prompt_parts(
            self.prompt_engine.system_prompt, cluster_part, pod_suffix(pod),
        )
        item = _WorkItem(prefix_ids, suffix_ids, self._group_key(prefix_ids, nodes))
        item.pin_spec = pin_spec
        item.trace = spans.capture()
        if self._delta is not None:
            trace = spans.current_trace()
            if trace is not None:
                trace.set_meta(prompt_encoding="delta" if delta_nodes else "pinned",
                               delta_nodes=delta_nodes)
        return item

    def _group_key(self, prefix_ids, nodes: Sequence[NodeMetrics]) -> tuple:
        # Grammar over READY nodes of this snapshot (stable across the pods
        # of a burst); per-pod feasibility is enforced by validation upstream.
        ready_names = tuple(sorted(n.name for n in nodes if n.is_ready))
        return (tuple(prefix_ids), ready_names if self.constrained else None)

    def prewarm_prefix(self, nodes: Sequence[NodeMetrics]) -> Future:
        """Advisory (JAX local.py:343-385): install this snapshot's (prefix
        KV, grammar) group while the engine is idle, so the first wave of
        the next burst skips the chunked prefix prefill.

        Returns a Future resolving True if the group was installed (or
        already current), False if dropped — the engine was busy (real
        traffic decides groups) or the snapshot has no ready node. Never
        blocks the caller; the install runs on the engine-owner thread."""
        item = self._prepare_prewarm(nodes)
        if item is None:
            f: Future = Future()
            f.set_result(False)
            return f
        self._queue.put(item)
        return item.future

    def _prepare_prewarm(self, nodes: Sequence[NodeMetrics]) -> _WorkItem | None:
        if not any(n.is_ready for n in nodes):
            return None
        cluster_part, pin_spec, _ = self._cluster_part(nodes)
        # Any non-empty stand-in suffix yields the prefix a real pod gets:
        # chat_prompt_parts splits at the end of the user-prefix string.
        prefix_ids, _ = self.tokenizer.chat_prompt_parts(
            self.prompt_engine.system_prompt, cluster_part, "x",
        )
        item = _WorkItem(prefix_ids, None, self._group_key(prefix_ids, nodes))
        item.pin_spec = pin_spec
        return item

    def get_scheduling_decision(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics]
    ) -> SchedulingDecision:
        self._count("sync_calls")
        item = self._prepare_item(pod, nodes)
        self._queue.put(item)
        try:
            text = item.future.result(timeout=self.request_timeout_s)
        except FuturesTimeout as exc:
            raise BackendError(
                f"decision timed out after {self.request_timeout_s}s"
            ) from exc
        return self._parse(text)

    async def get_scheduling_decision_async(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics]
    ) -> SchedulingDecision:
        """Natively async (JAX local.py:458-479): awaits the engine future
        without holding a thread. On the sync path every in-flight pod pins
        one asyncio.to_thread pool thread for a whole wave, and a burst with
        more distinct shapes than pool threads serializes into waves.
        DecisionClient prefers this method."""
        self._count("async_calls")
        item = self._prepare_item(pod, nodes)
        self._queue.put(item)
        try:
            text = await asyncio.wait_for(
                asyncio.wrap_future(item.future), timeout=self.request_timeout_s
            )
        except (TimeoutError, asyncio.TimeoutError) as exc:
            raise BackendError(
                f"decision timed out after {self.request_timeout_s}s"
            ) from exc
        return self._parse(text)

    def get_scheduling_decisions_batch(
        self, pods: Sequence[PodSpec], nodes: Sequence[NodeMetrics]
    ) -> list[SchedulingDecision | Exception]:
        """Enqueue the whole batch before waiting on any future, so the
        worker decodes it together: with packed admission, one packed
        admission of the batch (engine.admit_packed; JAX local.py:413-455),
        else one wave per max_slots pods. Per-pod outcomes are positional;
        one infeasible pod never fails the rest."""
        out: list[SchedulingDecision | Exception] = [
            BackendError("batch slot unresolved")
        ] * len(pods)
        staged: list[tuple[int, _WorkItem]] = []
        pack_marker = object() if self._packed_admission else None
        cluster_info = self._cluster_part(nodes)  # once a batch, not a pod
        for i, pod in enumerate(pods):
            try:
                item = self._prepare_item(pod, nodes, cluster_info=cluster_info)
            except Exception as exc:  # NoFeasibleNodeError, tokenizer...
                out[i] = exc
                continue
            item.pack = pack_marker
            staged.append((i, item))
        for _, item in staged:
            self._queue.put(item)
        for i, item in staged:
            try:
                out[i] = self._parse(item.future.result(timeout=self.request_timeout_s))
            except FuturesTimeout:
                out[i] = BackendError(
                    f"decision timed out after {self.request_timeout_s}s"
                )
            except Exception as exc:
                out[i] = exc
        return out

    def _parse(self, text: str) -> SchedulingDecision:
        parsed = parse_decision_json(text)
        if parsed is None:
            raise BackendError(f"model produced unparseable decision: {text[:200]!r}")
        return SchedulingDecision(
            selected_node=parsed["selected_node"],
            confidence=parsed["confidence"],
            reasoning=parsed["reasoning"],
            source=DecisionSource.LLM,
        )

    # -------------------------------------------------------------- worker
    def _grammar_for(self, key: tuple[str, ...]):
        if key not in self._dfa_cache:
            if len(self._dfa_cache) > 16:
                self._dfa_cache.clear()
            # The whole emission must fit in max_new_tokens: worst case
            # 59 + name_tokens + 1 + reasoning (see the JAX backend).
            longest_name = max(len(self.tokenizer.encode(n)) for n in key)
            budget = self.max_new_tokens - (60 + longest_name) - 2
            if budget < 0:
                raise ValueError(
                    f"max_new_tokens={self.max_new_tokens} cannot fit even an "
                    f"empty decision for node names up to {longest_name} tokens; "
                    f"need >= {62 + longest_name}"
                )
            self._dfa_cache[key] = build_decision_dfa(
                self.tokenizer, list(key),
                max_reason_tokens=min(budget, self.max_reason_tokens),
                style=self.answer_style,
            )
        return self._dfa_cache[key]

    def _install_group(self, item: _WorkItem) -> None:
        """Install item's (prefix, grammar) group on the engine. With a
        delta-encoded prompt the snapshot prefix is pinned first, so
        set_prefix LCP-seeds from the pin and prefills only the diff."""
        self.counters["group_installs"] += 1
        if item.pin_spec is not None and self._pin_manager is not None:
            key, pin_ids = item.pin_spec
            try:
                self._pin_manager.ensure(key, pin_ids)
            except Exception:
                # unpinned is slower, never wrong: the install below still
                # prefills the whole prefix
                logger.exception("snapshot prefix pin failed; continuing")
            source = self._pin_manager.source_of(key)
            if item.trace is not None and source is not None:
                item.trace[0].set_meta(kv_source=source)
        self.engine.set_prefix(item.prefix_ids)
        names = item.group_key[1]
        self.engine.set_grammar(
            self._grammar_for(names) if names is not None else None
        )

    def _switch_group(self, item: _WorkItem) -> None:
        """Make item's group current. Invalidate first: a half-installed
        group (prefix in, grammar failed) must match nothing."""
        self._current_group = None
        self._install_group(item)
        self._current_group = item.group_key

    def _apply_prewarms(self, prewarms: list[_WorkItem], busy: bool) -> None:
        """Advisory installs (JAX local.py:620-644): only the latest
        snapshot matters, and it applies only when the engine is idle."""
        for stale in prewarms[:-1]:
            stale.resolve(False)
        self.counters["prewarms_dropped"] += len(prewarms) - 1
        latest = prewarms[-1]
        if latest.group_key == self._current_group:
            latest.resolve(True)
            return
        if busy:
            self.counters["prewarms_dropped"] += 1
            latest.resolve(False)
            return
        try:
            self._switch_group(latest)
        except Exception:
            logger.exception("prefix prewarm failed")
            self.counters["prewarms_dropped"] += 1
            latest.resolve(False)
        else:
            self.counters["prewarms_installed"] += 1
            latest.resolve(True)

    def _submit_pack(self, batch: list[_WorkItem], packs: list[dict]) -> None:
        """Admit a marked batch through engine.admit_packed; _drive_packs
        decodes it at each tick."""
        try:
            req_ids = self.engine.admit_packed(
                [i.suffix_ids for i in batch], self.max_new_tokens
            )
        except Exception as exc:
            logger.exception("packed admission failed")
            for item in batch:
                item.fail(BackendError(str(exc)))
        else:
            packs.append({"items": dict(zip(req_ids, batch)),
                          "submitted_at": time.perf_counter()})

    def _submit_waves(self, pending: list, waves: deque, packs: list[dict]) -> list:
        """Dispatch every admissible pending item as pipelined waves, or a
        marked batch as one packed admission (JAX local.py:580-777, without
        its persistent branch).

        Items group by (prefix, grammar). A switch to another group happens
        at most once a tick, and under load only when that group's oldest
        item has waited group_switch_after_s: interleaved snapshots take
        turns at that period instead of starving behind a hot group. Packs
        in flight decode against the current prefix, so no switch happens
        until they finish.

        Returns the items that must keep waiting (held ragged tails, other
        groups not yet switched to, packed batches waiting for slots,
        everything while a control is held)."""
        controls = [i for i in pending if isinstance(i, _ControlItem)]
        if controls:
            self._held_controls.extend(controls)
            pending = [i for i in pending if not isinstance(i, _ControlItem)]
        if self._held_controls:
            # Quiesce in progress: hold every admission until the controls
            # run at the wave barrier (_worker_tick).
            return list(pending)
        if any(i.suffix_ids is None for i in pending):
            # Diverted here, the single consumer of `pending`: the
            # coalescing and straggler polls can hand over a prewarm at any
            # point of a tick.
            prewarms = [i for i in pending if i.suffix_ids is None]
            pending = [i for i in pending if i.suffix_ids is not None]
            self._apply_prewarms(prewarms, busy=bool(pending or waves or packs))
        rest: list[_WorkItem] = []

        def submit(batch: list[_WorkItem]) -> None:
            try:
                handle = self.engine.submit_wave(
                    [i.suffix_ids for i in batch], self.max_new_tokens
                )
            except Exception as exc:  # bucket overflow, bad grammar state
                logger.exception("wave submit failed")
                for item in batch:
                    item.fail(BackendError(str(exc)))
            else:
                # getattr: engine test doubles don't carry the attribute
                prof = getattr(self.engine, "profiler", None)
                if prof is not None:
                    # queue-stall fence: the oldest item's enqueue anchors
                    # the wave's timeline (admission wait, coalescing window
                    # and group-switch holds all land there)
                    prof.note_admission(handle, min(i.enqueued_at for i in batch))
                waves.append((handle, batch))

        def run_group(items: list[_WorkItem]) -> None:
            """Full waves submit; a ragged tail holds while earlier waves
            are in flight, until its oldest item has waited partial_hold_s,
            so stragglers of a burst fill it instead of riding a wave of
            their own.

            Pack-marked items admit through engine.admit_packed instead,
            bounded by the engine's free paged slots (the rest wait for
            slots to drain); a lone marked item, or one whose suffix is
            past the paged limit, rides a wave.

            With the persistent loop on, current-group items that fit its
            admission bucket feed the command ring first; while the loop
            is resident the packed branch is skipped (admit_packed would
            drain it), so what is left rides waves."""
            if self._persistent_loop:
                items = self._route_persistent(items, rest, bool(packs))
            if self._packed_admission and not getattr(self.engine, "persistent_active", False):
                limit = self.engine.max_suffix_tokens(self.max_new_tokens)
                packable = [i for i in items
                            if i.pack is not None and len(i.suffix_ids) <= limit]
                if len(packable) >= 2:
                    free = self.engine.free_slots
                    if free >= 2:
                        self._submit_pack(packable[:free], packs)
                        rest.extend(packable[free:])
                    else:
                        rest.extend(packable)
                    handled = set(map(id, packable))
                    items = [i for i in items if id(i) not in handled]
            batch: list[_WorkItem] = []
            for item in items:
                batch.append(item)
                if len(batch) >= self.engine.max_slots:
                    submit(batch)
                    batch = []
            if batch:
                held_s = time.perf_counter() - min(i.enqueued_at for i in batch)
                if waves and held_s < self.partial_hold_s:
                    rest.extend(batch)
                else:
                    submit(batch)

        current: list[_WorkItem] = []
        others: list[_WorkItem] = []
        for item in pending:
            if len(item.suffix_ids) > self.engine.prefill_buckets[-1]:
                # fail it alone rather than poisoning its whole wave
                item.fail(BackendError(
                    f"pod prompt suffix of {len(item.suffix_ids)} tokens "
                    f"exceeds the largest prefill bucket "
                    f"{self.engine.prefill_buckets[-1]}"
                ))
            elif item.group_key == self._current_group:
                current.append(item)
            else:
                others.append(item)

        run_group(current)
        if not others:
            return rest
        if packs or self._pers_items:
            # the paged slots decode against the current prefix: a switch
            # waits for the packs and resident-loop decisions to finish
            # (bounded by their budgets)
            rest.extend(others)
            return rest
        oldest = min(others, key=lambda i: i.enqueued_at)
        if waves and time.perf_counter() - oldest.enqueued_at < self.group_switch_after_s:
            rest.extend(others)
            return rest
        target = oldest.group_key
        switch_items = [i for i in others if i.group_key == target]
        rest.extend(i for i in others if i.group_key != target)
        try:
            self._switch_group(switch_items[0])
        except Exception as exc:  # prefix too long, grammar build
            logger.exception("group install failed")
            for item in switch_items:
                item.fail(BackendError(str(exc)))
            return rest
        run_group(switch_items)
        return rest

    def _drain_queue(self, pending: list, block: bool,
                     block_timeout: float | None = None) -> None:
        """Move queued items into `pending`; a None sentinel sets _stopped.
        `block_timeout` bounds only the first (blocking) get — None waits
        indefinitely."""
        try:
            while True:
                item = (self._queue.get(timeout=block_timeout) if block
                        else self._queue.get_nowait())
                if item is None:
                    self._stopped.set()
                    return
                pending.append(item)
                block = False
        except queue.Empty:
            pass

    def _harvest_oldest(self, pending: list, waves: deque, packs: list[dict]) -> list:
        """Poll the queue while the oldest wave runs, then harvest it
        (JAX local.py:1061-1162). Stragglers arriving meanwhile feed the
        next wave. The poll ends at the wave's readiness or at a deadline
        of half the EMA of this geometry's service time, anchored where
        the device could have started the wave (its submit, or the last
        harvest); past it the harvest blocks, returning at the wave's true
        completion, which keeps the EMA honest. With packs in flight there
        is no poll: their decode (or the resident loop's) must not starve
        behind it."""
        handle, items = waves[0]
        geo = handle.geo_key
        ema = self._wave_ema.get(geo, self._wave_ema_default)
        deadline = max(handle.submitted_at, self._last_harvest_t) + 0.5 * ema
        if packs or self._pers_items:
            deadline = 0.0
        while (not handle.is_ready() and not self._stopped.is_set()
               and time.perf_counter() < deadline):
            try:
                got = self._queue.get(timeout=0.002)
            except queue.Empty:
                if pending:
                    # held ragged tails re-check their hold deadline
                    pending = self._submit_waves(pending, waves, packs)
                continue
            if got is None:
                self._stopped.set()
                break
            pending.append(got)
            self._drain_queue(pending, block=False)
            pending = self._submit_waves(pending, waves, packs)
        prof = getattr(self.engine, "profiler", None)
        if prof is not None and handle.is_ready():
            # the ready edge the poll observed (or already there when its
            # deadline passed): the device-compute estimate ends here, not
            # at the blocking harvest
            prof.note_ready(handle)
        waves.popleft()
        try:
            fins = self.engine.harvest_wave(handle)
        except Exception as exc:
            logger.exception("wave harvest failed")
            for item in items:
                item.fail(BackendError(str(exc)))
            return pending
        now = time.perf_counter()
        # Marginal service time of this wave. Waves that captured their
        # geometry are skipped (capture + run would poison the estimate);
        # the update falls fast and rises at most 4x the estimate.
        service = max(now - max(handle.submitted_at, self._last_harvest_t), 0.02)
        self._last_harvest_t = now
        if not handle.cold_compile:
            ema = self._wave_ema.get(geo, self._wave_ema_default)
            if service < ema:
                ema = 0.5 * ema + 0.5 * service
            else:
                ema = 0.9 * ema + 0.1 * min(service, 4.0 * ema)
            self._wave_ema[geo] = ema
        for fin, item in zip(fins, items):
            self._attach_item_spans(item, handle, fin, now)
            item.resolve(fin.text)
        return pending

    def _route_persistent(self, items: list[_WorkItem], rest: list[_WorkItem],
                          packs_busy: bool) -> list[_WorkItem]:
        """Feed current-group items that fit the resident loop's admission
        bucket onto its command ring (entering the loop lazily); returns the
        items that take the dispatch path instead. A full ring or no free
        slot PARKS the item in `rest` (backpressure: retry next tick)."""
        from k8s_llm_scheduler_tpu_torch.engine.persistent.ring import RingFull

        eng = self.engine
        limit = eng.persistent_suffix_limit(self.max_new_tokens)
        if not any(len(i.suffix_ids) <= limit for i in items):
            return items
        if not eng.persistent_active:
            if packs_busy:
                # packs decode on the dispatch path: wait them out
                return items
            try:
                if not eng.enter_persistent():
                    return items  # unsupported / wedge-latched
            except Exception:
                logger.exception("persistent loop launch failed")
                return items
        leftover: list[_WorkItem] = []
        for item in items:
            if len(item.suffix_ids) > limit:
                leftover.append(item)
                continue
            if eng.free_slots <= 0:
                rest.append(item)
                continue
            try:
                (req_id,) = eng.add_requests([item.suffix_ids], self.max_new_tokens)
            except RingFull:
                rest.append(item)  # admission backpressure
            except Exception as exc:
                item.fail(BackendError(str(exc)))
            else:
                self._pers_items[req_id] = (item, time.perf_counter())
        return leftover

    def _resolve_fins(self, fins, packs: list[dict]) -> None:
        """Resolve finished paged decisions to their items: resident-loop
        admissions and packs share the paged slots, so one seam serves
        both."""
        now = time.perf_counter()
        for fin in fins:
            entry = self._pers_items.pop(fin.req_id, None)
            if entry is not None:
                item, submitted_at = entry
                self._attach_item_spans(item, SimpleNamespace(submitted_at=submitted_at),
                                        fin, now)
                item.resolve(fin.text)
                continue
            for pk in packs:
                item = pk["items"].pop(fin.req_id, None)
                if item is not None:
                    handle = SimpleNamespace(submitted_at=pk["submitted_at"])
                    self._attach_item_spans(item, handle, fin, now)
                    item.resolve(fin.text)
                    break
        packs[:] = [pk for pk in packs if pk["items"]]

    def _fail_paged_inflight(self, packs: list[dict], exc: Exception) -> None:
        """Fail every in-flight paged decision (packs and resident-loop
        items) and abort the engine's paged slots, so their slots and pages
        do not leak."""
        for pk in packs:
            for item in pk["items"].values():
                item.fail(BackendError(str(exc)))
        packs.clear()
        for item, _t in self._pers_items.values():
            item.fail(BackendError(str(exc)))
        self._pers_items.clear()
        self._exit_persistent("after a failed step")
        try:
            self.engine.abort_all()
        except Exception:  # pragma: no cover - best-effort cleanup
            logger.exception("engine abort after failed step")

    def _exit_persistent(self, when: str) -> None:
        try:
            if getattr(self.engine, "persistent_active", False):
                self.engine.exit_persistent()
        except Exception:  # pragma: no cover - best effort
            logger.exception("persistent loop exit %s failed", when)

    def _step_paged(self):
        """One fused step of the paged slots (step() on engine test doubles
        without a fused runtime)."""
        step_fused = getattr(self.engine, "step_fused", None)
        return step_fused() if step_fused is not None else self.engine.step()

    def _drive_packs(self, packs: list[dict]) -> None:
        """Advance in-flight packs by one step and resolve what finished
        (the step also harvests the decode chunks piggybacked during the
        admission: the engine's one sync). Packs admit into FUSED slots:
        the step goes through the fused runtime, which exits early past
        finished slots and falls back to step() on its own when the grammar
        can't fuse."""
        try:
            fins = self._step_paged()
        except Exception as exc:
            logger.exception("packed decode step failed")
            self._fail_paged_inflight(packs, exc)
            return
        self._resolve_fins(fins, packs)

    def _drive_persistent(self, packs: list[dict]) -> None:
        """Drain the resident loop's token ring and resolve finished
        decisions. After a drain (wedge, or a quiesce that didn't resume)
        the surviving slots keep decoding on the dispatch path, token for
        token."""
        eng = self.engine
        try:
            if eng.persistent_active:
                fins = eng.step_persistent(timeout_s=0.02)
            else:
                fins = self._step_paged()
        except Exception as exc:
            logger.exception("persistent serving step failed")
            self._fail_paged_inflight(packs, exc)
            return
        self._resolve_fins(fins, packs)

    def _run_controls(self) -> None:
        """At the wave barrier: run the held controls on this thread, then
        drop the current group — a control may have changed what the group
        key stands for (a weight swap clears the prefix KV), so the next
        wave reinstalls prefix and grammar (JAX local.py:1163-1197). Pins
        gone stale with it are dropped, so the next install re-pins."""
        # the resident loop exits first: the dispatch path owns the slots
        # while a control runs (swaps and drains expect it)
        self._exit_persistent("at the control barrier")
        controls, self._held_controls = self._held_controls, []
        for ctl in controls:
            try:
                result = ctl.fn()
            except Exception as exc:
                logger.exception("quiesced control action failed")
                ctl.fail(exc)
            else:
                pause_s = time.perf_counter() - ctl.enqueued_at
                self.swap_stats["quiesce_runs"] += 1
                self.swap_stats["last_pause_s"] = pause_s
                self.swap_stats["total_pause_s"] += pause_s
                if not ctl.future.done():
                    ctl.future.set_result((result, pause_s))
        self._current_group = None
        if self._pin_manager is not None:
            self._pin_manager.invalidate_stale()

    def _worker_tick(self, pending: list, waves: deque, packs: list[dict]) -> list:
        """One submit + harvest cycle; returns the items still waiting."""
        if pending and self.admit_wait_s and not waves:
            # Adaptive coalescing: keep extending the window while items
            # are still arriving (up to 5 times), so a burst lands in one
            # wave.
            for _ in range(5):
                before = len(pending)
                time.sleep(self.admit_wait_s)
                self._drain_queue(pending, block=False)
                if len(pending) == before or len(pending) >= self.engine.max_slots:
                    break
        pending = self._submit_waves(pending, waves, packs)
        if packs:
            # packs decode through the paged path: step them every tick so
            # their decisions resolve while waves pipeline alongside (the
            # resolve seam covers resident-loop items too)
            self._drive_packs(packs)
        elif self._pers_items:
            # resident-loop decisions: harvest the token ring (or, after a
            # drain, continue their slots on the dispatch path)
            self._drive_persistent(packs)
        if waves:
            pending = self._harvest_oldest(pending, waves, packs)
        if self._held_controls and not waves and not packs and not self._pers_items:
            self._run_controls()
        return pending

    @staticmethod
    def _attach_item_spans(item: _WorkItem, handle, fin, now: float) -> None:
        """Attach the item's engine spans to its decision trace at harvest
        (JAX local.py:1200-1247): admission_wait (enqueue to wave submit),
        then prefill and decode, the wave's wall time apportioned by their
        token counts (`apportioned`: the wave is one device program)."""
        cap = item.trace
        if cap is None:
            return
        try:
            trace, ctx = cap
            wall_offset = item.enqueued_wall - item.enqueued_at
            submitted = getattr(handle, "submitted_at", item.enqueued_at)
            trace.add_span(
                "admission_wait", start_unix=item.enqueued_wall,
                dur_ms=max(submitted - item.enqueued_at, 0.0) * 1000.0,
                parent_id=ctx.span_id, publish=False,
            )
            wave_ms = max(now - submitted, 0.0) * 1000.0
            pf = len(item.suffix_ids or ())
            dc = len(fin.token_ids)
            prefill_ms = wave_ms * pf / (pf + dc) if pf + dc else 0.0
            submit_wall = submitted + wall_offset
            trace.add_span(
                "prefill", start_unix=submit_wall, dur_ms=prefill_ms,
                parent_id=ctx.span_id, tokens=pf, apportioned=True,
                publish=False,
            )
            trace.add_span(
                "decode", start_unix=submit_wall + prefill_ms / 1000.0,
                dur_ms=wave_ms - prefill_ms, parent_id=ctx.span_id,
                tokens=dc, apportioned=True, publish=False,
            )
            trace.flush()
        except Exception:  # tracing must never fail a decision
            logger.exception("failed to attach engine spans")

    def _try_prewarm(self) -> bool:
        """Capture ONE missing sibling wave geometry while the engine is
        idle (engine.prewarm_wave_siblings), on this thread, the engine's
        owner; requests arriving meanwhile are served right after."""
        try:
            return self.engine.prewarm_wave_siblings(limit=1) > 0
        except Exception:
            logger.exception("wave prewarm failed")
            return False

    def _prewarm_backlog(self) -> int:
        try:
            return self.engine.wave_prewarm_backlog()
        except AttributeError:  # engine test doubles
            return 0

    def _run_worker(self) -> None:
        pending: list = []
        waves: deque = deque()
        packs: list[dict] = []  # in-flight packed admissions
        while not self._stopped.is_set():
            idle = not pending and not waves and not packs and not self._pers_items
            if idle and self._prewarm_backlog() > 0:
                # Idle with captures owed: park only for the grace period;
                # if still idle after it, capture ONE sibling geometry, then
                # re-check the queue. Arriving work always wins.
                self._drain_queue(pending, block=True,
                                  block_timeout=self.prewarm_idle_delay_s)
                if not self._stopped.is_set() and not pending:
                    self._try_prewarm()
                continue
            self._drain_queue(pending, block=idle)
            if self._stopped.is_set() or (
                not pending and not waves and not packs and not self._pers_items
            ):
                continue
            # Nothing below may kill the engine-owner thread.
            try:
                pending = self._worker_tick(pending, waves, packs)
            except Exception as exc:  # pragma: no cover - last-resort guard
                logger.exception("engine worker tick failed")
                for _, items in waves:
                    pending.extend(items)
                waves.clear()
                if packs or self._pers_items:
                    # their requests hold paged slots: abort, or they leak
                    self._fail_paged_inflight(packs, exc)
                pending.extend(self._held_controls)
                self._held_controls = []
                for item in pending:
                    item.fail(BackendError(str(exc)))
                pending = []
        # shutdown: retire the resident loop (its thread must not outlive
        # the backend), then fail anything still queued or in flight
        self._exit_persistent("at shutdown")
        self._drain_queue(pending, block=False)
        for _, items in waves:
            pending.extend(items)
        for pk in packs:
            pending.extend(pk["items"].values())
        pending.extend(item for item, _t in self._pers_items.values())
        self._pers_items.clear()
        pending.extend(self._held_controls)
        self._held_controls = []
        for item in pending:
            item.fail(BackendError("backend closed"))

    def run_quiesced(self, fn, timeout_s: float | None = None):
        """Run `fn()` on the engine-owner thread at a wave barrier (JAX
        local.py:1249-1271): from the control's enqueue the worker holds
        every new admission, harvests the waves in flight and decodes the
        packs in flight to their end, runs `fn`, and
        resumes on its next tick. No request is failed or dropped. Blocks
        until done; returns (fn result, pause_s), pause_s the
        admission-held wall time. Raises what fn raises."""
        if self._stopped.is_set():
            raise BackendError("backend closed")
        ctl = _ControlItem(fn)
        self._queue.put(ctl)
        try:
            return ctl.future.result(timeout=timeout_s)
        except FuturesTimeout as exc:
            raise BackendError(
                f"quiesced action not executed within {timeout_s}s"
            ) from exc

    def close(self) -> None:
        self._stopped.set()
        self._queue.put(None)
        self._worker.join(timeout=30)
        close_engine = getattr(self.engine, "close", None)  # engine test doubles
        if close_engine is not None and not self._worker.is_alive():
            close_engine()
        prof = getattr(self.engine, "profiler", None)
        if prof is not None:
            # flush the half-open wave fences once the worker has joined:
            # its in-flight waves were failed upstream and never harvest
            prof.close()

    def get_stats(self) -> dict[str, Any]:
        out = self.engine.get_stats()
        if self.swap_stats["quiesce_runs"]:
            out["swap"] = dict(self.swap_stats)
        with self._calls_lock:
            out["backend"] = dict(self.counters)
        if self._delta is not None:
            out["delta"] = self._delta.stats()
        if self._pin_manager is not None and self._pin_manager.stats_counters["pins"]:
            out["pins"] = self._pin_manager.stats()
        completed = out.get("completed", 0)
        if completed:
            # prefill tokens computed per finished decision (prefix prefills
            # count only the tokens not reused)
            out["prefill_tokens_per_decision"] = round(
                out.get("prefill_tokens", 0) / completed, 2
            )
        return out


def _attach_spec(
    engine: InferenceEngine,
    *,
    arm: str,
    draft_model: str,
    draft_checkpoint: str | None,
    k: int,
    disable_threshold: float,
    rng_seed: int,
) -> None:
    """Build the speculative arm and attach a SpeculativeDecoder (JAX
    local.py:1340-1412).

    `arm="draft"`: a second, small model serving the SAME tokenizer as the
    target; a random draft narrower than the tokenizer is widened so every
    legal token can be proposed (spec/draft.build_random_draft), a draft
    checkpoint (models/loader.restore_checkpoint's format) must already
    match. `arm="hidden"`: the draft-free hidden-transfer head
    (spec/hidden.py), random from rng_seed + 1; `draft_checkpoint` would
    name a trained head, whose training and format are not ported yet
    (ROADMAP queue 1 item 10)."""
    from k8s_llm_scheduler_tpu_torch.spec import SpeculativeDecoder

    if arm not in ("draft", "hidden"):
        # a typo must not silently serve the wrong pipeline
        raise ValueError(f"unknown llm.spec_arm {arm!r}")
    if arm == "hidden":
        if draft_checkpoint:
            raise NotImplementedError(
                "llm.spec_draft_checkpoint with llm.spec_arm hidden: the hidden-"
                "transfer head's training and checkpoint format are not ported yet "
                "(ROADMAP queue 1 item 10)"
            )
        engine.attach_spec(SpeculativeDecoder(
            engine, arm="hidden", hidden_seed=rng_seed + 1, k=k,
            disable_threshold=disable_threshold,
        ))
        logger.info("speculative decoding attached: arm=hidden k=%d disable<%.2f "
                    "(random-init)", k, disable_threshold)
        return
    from k8s_llm_scheduler_tpu_torch.spec.draft import build_random_draft

    draft_cfg = get_config(draft_model)
    if draft_checkpoint:
        from k8s_llm_scheduler_tpu_torch.models.loader import restore_checkpoint

        draft_params = restore_checkpoint(Path(draft_checkpoint), draft_cfg,
                                          device=engine.device)
    else:
        draft_params, draft_cfg = build_random_draft(
            draft_cfg, engine.tokenizer.vocab_size, rng_seed + 1, device=engine.device)
    engine.attach_spec(SpeculativeDecoder(
        engine, draft_params, draft_cfg, k=k, disable_threshold=disable_threshold,
    ))
    logger.info(
        "speculative decoding attached: draft=%s k=%d disable<%.2f%s", draft_cfg.name,
        k, disable_threshold, " (checkpoint)" if draft_checkpoint else " (random-init)",
    )


def build_local_backend(
    model: str = "tiny",
    device: str | torch.device = "cuda",
    seed: int = 0,
    *,
    temperature: float = 0.3,
    top_k: int = 0,
    max_slots: int = 8,
    num_pages: int = 512,
    page_size: int = 64,
    max_pages_per_seq: int | None = None,
    prefill_buckets: tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096, 8192),
    chunk_steps: int = 16,
    prefix_chunk: int = 2048,
    paged_attn: str = "gather",
    decode_matmul: str = "dense",
    quantize: str | None = None,
    max_new_tokens: int = 200,
    constrained: bool = True,
    checkpoint_path: str | None = None,
    tokenizer_path: str | None = None,
    tokenizer_name: str = "byte",
    request_timeout_s: float = 60.0,
    group_switch_after_s: float = 0.25,
    partial_hold_s: float = 0.03,
    prewarm_idle_delay_s: float = 0.5,
    answer_style: str = "direct",
    max_reason_tokens: int = 320,
    graphs: bool = True,
    packed_admission: bool = True,
    admission_chunk_tokens: int = 256,
    delta_prompts: bool = False,
    repin_fraction: float = 0.25,
    max_pins: int = 4,
    fused_decode: bool = True,
    persistent_loop: bool = False,
    persistent_suffix_bucket: int | None = None,
    persistent_wedge_timeout_s: float = 30.0,
    persistent_telemetry: bool = True,
    persistent_stats_every: int = 8,
    persistent_blackbox_depth: int = 64,
    spec_enabled: bool = False,
    spec_arm: str = "draft",
    spec_draft_model: str = "tiny",
    spec_draft_checkpoint: str | None = None,
    spec_k: int = 4,
    spec_disable_threshold: float = 0.3,
) -> LocalLLMBackend:
    """The local stack on `device` with the JAX package's settings and
    defaults (JAX local.py:1431-1480): params, tokenizer, engine and a
    grammar-constrained backend.

    Params come from `checkpoint_path` when it is set (an HF safetensors
    dir, or a native checkpoint of models/loader.save_checkpoint), else
    they are random from `seed`. `quantize="int8"` quantizes the weights
    (a checkpoint's one stacked weight at a time; random ones are drawn
    and quantized on the host, models/quant.init_params_int8_host, so only
    int8 weights reach the device). The tokenizer is the HF one at
    `tokenizer_path`, or the checkpoint's own when it ships one and
    `tokenizer_name` is "byte", else the builtin `tokenizer_name`, which
    may widen the model's vocab (engine/tokenizer.build_builtin_tokenizer).
    `temperature` 0 decodes greedily; `top_k` restricts the fused runtime's
    sampled draws (`fused_decode`, on by default; engine/fused/).
    `persistent_loop` serves what fits through the resident loop
    (engine/persistent/; `persistent_*` are its settings).
    `decode_matmul="ragged"` runs block decode's matmuls through K3;
    `graphs=False` runs the engine's waves eagerly where it would replay
    CUDA graphs. The admission plane's settings are the config's
    `admission.*` keys. `spec_enabled` attaches a speculative decoder
    (spec/; `spec_*` are its settings, the config's `llm.spec_*`), which
    serves the engine's generate(); decisions never speculate."""
    from k8s_llm_scheduler_tpu_torch.engine.tokenizer import (
        HFTokenizerAdapter,
        build_builtin_tokenizer,
    )

    dev = resolve_device(device)
    if quantize is not None and quantize != "int8":
        raise ValueError(f"unknown quantization {quantize!r} (only 'int8')")
    cfg = get_config(model)
    builtin_tokenizer = None
    if tokenizer_path is None and not (
        checkpoint_path
        and tokenizer_name == "byte"
        and (Path(checkpoint_path) / "tokenizer.json").exists()
    ):
        # before the params are built: the builtin may widen the vocab
        builtin_tokenizer, cfg = build_builtin_tokenizer(tokenizer_name, cfg)
    if checkpoint_path:
        from k8s_llm_scheduler_tpu_torch.models.loader import (
            load_hf_checkpoint,
            restore_checkpoint,
        )

        ckpt = Path(checkpoint_path)
        if list(ckpt.glob("*.safetensors")):
            params = load_hf_checkpoint(ckpt, cfg, device=dev, quantize=quantize)
        else:
            params = restore_checkpoint(ckpt, cfg, device=dev)
            if quantize is not None:
                params = quantize_params(params)
    elif quantize == "int8":
        params = init_params_int8_host(seed, cfg, device=dev)
    else:
        params = init_params(cfg, seed=seed, device=dev)
    tokenizer = builtin_tokenizer or HFTokenizerAdapter(tokenizer_path or checkpoint_path)
    if max_pages_per_seq is None:
        # own pages hold a pod's suffix and its generated tokens (the
        # shared prefix lives in the dense prefix buffer): the largest
        # suffix expected (1024 tokens) plus the decode budget
        max_pages_per_seq = -(-(1024 + max_new_tokens + chunk_steps) // page_size)
    engine = InferenceEngine(
        params, cfg, tokenizer,
        num_pages=num_pages, page_size=page_size, max_slots=max_slots,
        max_pages_per_seq=max_pages_per_seq, prefill_buckets=prefill_buckets,
        chunk_steps=chunk_steps, prefix_chunk=prefix_chunk, paged_attn=paged_attn,
        temperature=temperature, top_k=top_k, rng_seed=seed,
        decode_matmul=decode_matmul, graphs=graphs,
        admission_chunk_tokens=admission_chunk_tokens,
        fused_decode=fused_decode,
        persistent_loop=persistent_loop,
        persistent_suffix_bucket=persistent_suffix_bucket,
        persistent_wedge_timeout_s=persistent_wedge_timeout_s,
        persistent_telemetry=persistent_telemetry,
        persistent_stats_every=persistent_stats_every,
        persistent_blackbox_depth=persistent_blackbox_depth,
    )
    if spec_enabled:
        _attach_spec(
            engine, arm=spec_arm, draft_model=spec_draft_model,
            draft_checkpoint=spec_draft_checkpoint, k=spec_k,
            disable_threshold=spec_disable_threshold, rng_seed=seed,
        )
    return LocalLLMBackend(
        engine, tokenizer, max_new_tokens=max_new_tokens, constrained=constrained,
        request_timeout_s=request_timeout_s,
        group_switch_after_s=group_switch_after_s,
        partial_hold_s=partial_hold_s,
        prewarm_idle_delay_s=prewarm_idle_delay_s,
        answer_style=answer_style,
        max_reason_tokens=max_reason_tokens,
        packed_admission=packed_admission,
        delta_prompts=delta_prompts,
        repin_fraction=repin_fraction,
        max_pins=max_pins,
        persistent_loop=persistent_loop,
    )
