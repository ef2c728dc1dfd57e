"""LocalLLMBackend — the in-process decision backend over the PyTorch engine
(the port of the JAX package's engine/local.py, wave path only).

Same inputs as the reference's HuggingFaceClient._make_api_call (reference
scheduler.py:418-433) — a pod and the cluster's node metrics — and the same
output, a SchedulingDecision, with zero network: the prompt is built by
core/prompt.py, decoded by engine/engine.py under the node-name grammar
(engine/constrained.py) and parsed by utils/json_extract.py.

Concurrency: callers block on a Future; ONE engine-owner thread drains the
queue, coalesces a burst for a few milliseconds, and runs decision waves of
up to max_slots rows. Requests group by (prompt prefix, grammar) — both
keyed by the cluster snapshot; a new group installs its prefix KV and DFA
between waves. Idle for `prewarm_idle_delay_s`, the worker captures the
wave geometries next to those already served, one at a time
(engine.prewarm_wave_siblings), so a burst's ragged tail finds its CUDA
graphs captured.

Not ported yet: packed admission, delta prompts and pinned prefixes, the
persistent loop, the KV plane, speculative decoding, quiesced controls.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections.abc import Sequence
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any

import torch

from k8s_llm_scheduler_tpu_torch.core.prompt import PromptEngine, pod_suffix
from k8s_llm_scheduler_tpu_torch.core.validation import feasible_nodes
from k8s_llm_scheduler_tpu_torch.device import resolve_device
from k8s_llm_scheduler_tpu_torch.engine.backend import (
    BackendError,
    NoFeasibleNodeError,
)
from k8s_llm_scheduler_tpu_torch.engine.constrained import build_decision_dfa
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer, Tokenizer
from k8s_llm_scheduler_tpu_torch.models.configs import get_config
from k8s_llm_scheduler_tpu_torch.models.llama import init_params
from k8s_llm_scheduler_tpu_torch.models.quant import init_params_int8_host
from k8s_llm_scheduler_tpu_torch.types import (
    DecisionSource,
    NodeMetrics,
    PodSpec,
    SchedulingDecision,
)
from k8s_llm_scheduler_tpu_torch.utils.json_extract import parse_decision_json

logger = logging.getLogger(__name__)


class _WorkItem:
    __slots__ = ("prefix_ids", "suffix_ids", "group_key", "future", "enqueued_at")

    def __init__(self, prefix_ids, suffix_ids, group_key):
        self.prefix_ids = prefix_ids
        self.suffix_ids = suffix_ids
        self.group_key = group_key  # (prefix token tuple, grammar names)
        self.future: Future = Future()
        self.enqueued_at = time.perf_counter()

    def resolve(self, text: str) -> None:
        if not self.future.done():
            self.future.set_result(text)

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
        answer_style: str = "direct",
        max_reason_tokens: int = 320,
        prewarm_idle_delay_s: float = 0.5,
    ) -> None:
        self.engine = engine
        self.tokenizer = tokenizer or engine.tokenizer
        self.prompt_engine = PromptEngine()
        self.max_new_tokens = max_new_tokens
        self.constrained = constrained
        self.request_timeout_s = request_timeout_s
        # Coalescing window: a burst's leaders enqueue over a few ms.
        self.admit_wait_s = admit_wait_s
        # Decision JSON field order: "direct" or "cot" (engine/constrained.py).
        self.answer_style = answer_style
        self.max_reason_tokens = max_reason_tokens
        # Idle grace before a sibling wave geometry is captured
        # (engine.prewarm_wave_siblings): a capture blocks the worker, so it
        # must not start the instant the queue empties, when a burst's next
        # round often arrives within ms.
        self.prewarm_idle_delay_s = prewarm_idle_delay_s
        self._queue: queue.Queue[_WorkItem | None] = queue.Queue()
        self._dfa_cache: dict[tuple[str, ...], Any] = {}
        self._current_group: tuple | None = None
        self._stopped = threading.Event()
        self._worker = threading.Thread(
            target=self._run_worker, daemon=True, name="llm-engine"
        )
        self._worker.start()

    # ------------------------------------------------------------- backend
    def _prepare_item(self, pod: PodSpec, nodes: Sequence[NodeMetrics]) -> _WorkItem:
        if not feasible_nodes(pod, nodes):
            raise NoFeasibleNodeError(
                f"no feasible node for {pod.namespace}/{pod.name}"
            )
        prefix_ids, suffix_ids = self.tokenizer.chat_prompt_parts(
            self.prompt_engine.system_prompt,
            self.prompt_engine.cluster_part(nodes),
            pod_suffix(pod),
        )
        # Grammar over READY nodes of this snapshot (stable across the pods
        # of a burst); per-pod feasibility is enforced by validation upstream.
        ready_names = tuple(sorted(n.name for n in nodes if n.is_ready))
        group_key = (tuple(prefix_ids), ready_names if self.constrained else None)
        return _WorkItem(prefix_ids, suffix_ids, group_key)

    def get_scheduling_decision(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics]
    ) -> SchedulingDecision:
        item = self._prepare_item(pod, nodes)
        self._queue.put(item)
        try:
            text = item.future.result(timeout=self.request_timeout_s)
        except FuturesTimeout as exc:
            raise BackendError(
                f"decision timed out after {self.request_timeout_s}s"
            ) from exc
        return self._parse(text)

    def get_scheduling_decisions_batch(
        self, pods: Sequence[PodSpec], nodes: Sequence[NodeMetrics]
    ) -> list[SchedulingDecision | Exception]:
        """Enqueue the whole batch before waiting on any future, so the
        worker decodes it together (one wave per max_slots pods). Per-pod
        outcomes are positional; one infeasible pod never fails the rest."""
        out: list[SchedulingDecision | Exception] = [
            BackendError("batch slot unresolved")
        ] * len(pods)
        staged: list[tuple[int, _WorkItem]] = []
        for i, pod in enumerate(pods):
            try:
                staged.append((i, self._prepare_item(pod, nodes)))
            except Exception as exc:  # NoFeasibleNodeError, tokenizer...
                out[i] = exc
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
        """Install item's (prefix, grammar) group on the engine."""
        self.engine.set_prefix(item.prefix_ids)
        names = item.group_key[1]
        self.engine.set_grammar(
            self._grammar_for(names) if names is not None else None
        )

    def _submit_waves(self, pending: list[_WorkItem]):
        """Run every pending item of the current group as waves of up to
        max_slots rows; when the current group has none, switch to the group
        of the oldest other item first. Returns (waves, items still
        waiting for their group)."""
        waves: list[tuple[Any, list[_WorkItem]]] = []
        current: list[_WorkItem] = []
        others: list[_WorkItem] = []
        for item in pending:
            if len(item.suffix_ids) > self.engine.prefill_buckets[-1]:
                item.fail(BackendError(
                    f"pod prompt suffix of {len(item.suffix_ids)} tokens "
                    f"exceeds the largest prefill bucket "
                    f"{self.engine.prefill_buckets[-1]}"
                ))
            elif item.group_key == self._current_group:
                current.append(item)
            else:
                others.append(item)
        if not current and others:
            target = min(others, key=lambda i: i.enqueued_at).group_key
            current = [i for i in others if i.group_key == target]
            others = [i for i in others if i.group_key != target]
            # invalidate first: a half-installed group must match nothing
            self._current_group = None
            try:
                self._install_group(current[0])
                self._current_group = target
            except Exception as exc:  # prefix too long, grammar build
                logger.exception("group install failed")
                for item in current:
                    item.fail(BackendError(str(exc)))
                current = []
        for i in range(0, len(current), self.engine.max_slots):
            batch = current[i:i + self.engine.max_slots]
            try:
                handle = self.engine.submit_wave(
                    [it.suffix_ids for it in batch], self.max_new_tokens
                )
            except Exception as exc:
                logger.exception("wave submit failed")
                for item in batch:
                    item.fail(BackendError(str(exc)))
            else:
                waves.append((handle, batch))
        return waves, others

    def _drain_queue(self, pending: list[_WorkItem], block: bool,
                     block_timeout: float | None = None) -> None:
        """Move queued items into `pending` (waiting up to `block_timeout`
        for the first when blocking); a None sentinel stops the worker."""
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

    def _worker_tick(self, pending: list[_WorkItem]) -> list[_WorkItem]:
        """Coalesce, run the waves of one group, resolve their items;
        returns the items of other groups."""
        if self.admit_wait_s:
            for _ in range(5):
                before = len(pending)
                time.sleep(self.admit_wait_s)
                self._drain_queue(pending, block=False)
                if len(pending) == before or len(pending) >= self.engine.max_slots:
                    break
        waves, rest = self._submit_waves(pending)
        for handle, items in waves:
            try:
                fins = self.engine.harvest_wave(handle)
            except Exception as exc:
                logger.exception("wave harvest failed")
                for item in items:
                    item.fail(BackendError(str(exc)))
                continue
            for fin, item in zip(fins, items):
                item.resolve(fin.text)
        return rest

    def _try_prewarm(self) -> bool:
        """Capture ONE missing sibling wave geometry while the engine is
        idle (engine.prewarm_wave_siblings), on this thread, the engine's
        owner; requests arriving meanwhile are served right after."""
        try:
            return self.engine.prewarm_wave_siblings(limit=1) > 0
        except Exception:
            logger.exception("wave prewarm failed")
            return False

    def _run_worker(self) -> None:
        pending: list[_WorkItem] = []
        while not self._stopped.is_set():
            if not pending and self.engine.wave_prewarm_backlog() > 0:
                # Idle with captures owed: park only for the grace period;
                # if still idle after it, capture ONE sibling geometry, then
                # re-check the queue. Arriving work always wins.
                self._drain_queue(pending, block=True,
                                  block_timeout=self.prewarm_idle_delay_s)
                if not self._stopped.is_set() and not pending:
                    self._try_prewarm()
                continue
            self._drain_queue(pending, block=not pending)
            if self._stopped.is_set() or not pending:
                continue
            # Nothing below may kill the engine-owner thread.
            try:
                pending = self._worker_tick(pending)
            except Exception as exc:  # pragma: no cover - last-resort guard
                logger.exception("engine worker tick failed")
                for item in pending:
                    item.fail(BackendError(str(exc)))
                pending = []
        self._drain_queue(pending, block=False)
        for item in pending:
            item.fail(BackendError("backend closed"))

    def close(self) -> None:
        self._stopped.set()
        self._queue.put(None)
        self._worker.join(timeout=30)

    def get_stats(self) -> dict[str, Any]:
        return self.engine.get_stats()


def build_local_backend(
    model: str = "tiny",
    device: str | torch.device = "cuda",
    seed: int = 0,
    *,
    request_timeout_s: float = 60.0,
    quantize: str | None = None,
    decode_matmul: str = "dense",
    graphs: bool = True,
) -> LocalLLMBackend:
    """The local stack with random weights from `seed` on `device`: params,
    byte tokenizer, a greedy engine and a grammar-constrained backend, all
    other settings at their defaults. `quantize="int8"` draws and quantizes
    the weights on the host (models/quant.init_params_int8_host), so only
    int8 weights reach the device; `decode_matmul="ragged"` runs block
    decode's matmuls through K3; `graphs=False` runs the engine's waves
    eagerly where it would replay CUDA graphs."""
    dev = resolve_device(device)
    if quantize is not None and quantize != "int8":
        raise ValueError(f"unknown quantization {quantize!r} (only 'int8')")
    cfg = get_config(model)
    if quantize == "int8":
        params = init_params_int8_host(seed, cfg, device=dev)
    else:
        params = init_params(cfg, seed=seed, device=dev)
    tokenizer = ByteTokenizer()
    engine = InferenceEngine(
        params, cfg, tokenizer, temperature=0.0, rng_seed=seed,
        decode_matmul=decode_matmul, graphs=graphs,
    )
    return LocalLLMBackend(engine, tokenizer, request_timeout_s=request_timeout_s)
