"""Prompt construction for the scheduling decision model.

Behavioral parity with the reference's PromptEngine (reference
scheduler.py:192-252): a system prompt that demands an exact node name from
the provided list and a JSON-only response with selected_node / confidence /
reasoning (scheduler.py:196-214); a user prompt rendering the pod's requests
(scheduler.py:219-226), per-node metric blocks (scheduler.py:228-241), and a
closing VALID NODE NAMES reinforcement line (scheduler.py:243, 250).

TPU-first deviations, on purpose:
- **Prefix-cacheable ordering.** The reference renders [pod][nodes]; here the
  user prompt is [cluster state][pod block] so that during a scheduling burst
  every pod shares a common (system + cluster) token prefix — the engine
  prefill-caches that prefix on device once per cluster snapshot. The
  reference's own cache key (scheduler.py:265-271) proves cluster state is
  the shared equivalence class across a burst.
- **No double discounting.** The reference re-discounts already-allocatable
  capacity by usage% (scheduler.py:232-233), double-counting load (SURVEY §2
  quirk). Here each node line reports allocatable and usage separately.
- The prompt is produced in two pieces (`cluster_prefix`, `pod_suffix`) glued
  by `construct_scheduling_prompt` so the serving layer can key its prefix
  cache on the cluster piece alone.
"""

from __future__ import annotations

from collections.abc import Sequence

from k8s_llm_scheduler_tpu_torch.types import NodeMetrics, PodSpec

SYSTEM_PROMPT = """You are a Kubernetes scheduler. Given a pending pod and the current \
cluster state, select the best node for the pod.

Rules:
- You MUST pick exactly one node name from the VALID NODE NAMES list.
- Consider resource requests vs. available capacity, current load, pod count \
headroom, node selectors, taints and tolerations.
- Respond with ONLY a JSON object, no other text, in exactly this schema:
{"selected_node": "<node-name>", "confidence": <0.0-1.0>, "reasoning": "<one sentence>"}"""


def render_node_block(node: NodeMetrics) -> str:
    """One node's metric block (reference scheduler.py:228-241)."""
    lines = [
        f"Node: {node.name}",
        f"  CPU: {node.cpu_usage_percent:.1f}% used, {node.available_cpu_cores:.2f} cores allocatable",
        f"  Memory: {node.memory_usage_percent:.1f}% used, {node.available_memory_gb:.2f} GB allocatable",
        f"  Pods: {node.pod_count}/{node.max_pods}",
        f"  Ready: {node.conditions.get('Ready', 'Unknown')}",
    ]
    if node.labels:
        interesting = {
            k: v
            for k, v in sorted(node.labels.items())
            if not k.startswith("kubernetes.io/") and not k.startswith("beta.kubernetes.io/")
        }
        if interesting:
            lines.append("  Labels: " + ", ".join(f"{k}={v}" for k, v in interesting.items()))
    if node.taints:
        lines.append(
            "  Taints: "
            + ", ".join(
                f"{t.get('key', '?')}={t.get('value', '')}:{t.get('effect', '')}"
                for t in node.taints
            )
        )
    return "\n".join(lines)


def cluster_prefix(nodes: Sequence[NodeMetrics]) -> str:
    """The burst-shared prefix: full cluster state + valid-name list.

    Identical for every pod scheduled against the same cluster snapshot, so
    the engine can prefill it once and reuse the KV pages.
    """
    node_blocks = "\n\n".join(render_node_block(n) for n in nodes)
    valid = ", ".join(n.name for n in nodes)
    return (
        "CLUSTER STATE:\n\n"
        f"{node_blocks}\n\n"
        f"VALID NODE NAMES: [{valid}]\n"
    )


def pod_suffix(pod: PodSpec) -> str:
    """The per-pod tail of the prompt (reference scheduler.py:219-226)."""
    lines = [
        "POD TO SCHEDULE:",
        f"  Name: {pod.namespace}/{pod.name}",
        f"  CPU request: {pod.cpu_request:.3f} cores",
        f"  Memory request: {pod.memory_request:.3f} GB",
        f"  Priority: {pod.priority}",
    ]
    if pod.node_selector:
        lines.append(
            "  Node selector: " + ", ".join(f"{k}={v}" for k, v in sorted(pod.node_selector.items()))
        )
    if pod.tolerations:
        lines.append(
            "  Tolerations: "
            + ", ".join(
                f"{t.get('key', '*')}:{t.get('effect', '')}" for t in pod.tolerations
            )
        )
    if pod.affinity_rules.get("node_affinity_terms"):
        # required node affinity (core/validation.node_affinity_matches):
        # terms OR'd, expressions within a term AND'd. The reference
        # always dropped affinity before prompting (scheduler.py:762) —
        # rendering it is what makes the constraint LEARNABLE by a
        # distilled decider (a model cannot honor a filter it never sees).
        rendered_terms = []
        for term in pod.affinity_rules["node_affinity_terms"]:
            exprs = ", ".join(
                f"{e.get('key', '?')} {e.get('operator', 'In')} "
                f"[{', '.join(e.get('values', []) or [])}]"
                for e in term
            )
            if exprs:
                rendered_terms.append(f"({exprs})")
        if rendered_terms:
            lines.append("  Node affinity: " + " OR ".join(rendered_terms))
    lines.append("")
    lines.append(
        'Select the best node. Respond with ONLY the JSON object: '
        '{"selected_node": ..., "confidence": ..., "reasoning": ...}'
    )
    return "\n".join(lines)


class PromptEngine:
    """Stateless prompt builder (reference scheduler.py:192-252)."""

    system_prompt = SYSTEM_PROMPT

    def construct_scheduling_prompt(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics]
    ) -> str:
        """Full user prompt: shared cluster prefix + per-pod suffix."""
        return cluster_prefix(nodes) + "\n" + pod_suffix(pod)

    def cluster_part(self, nodes: Sequence[NodeMetrics]) -> str:
        """The burst-shared prefix half of split_prompt — THE single
        definition, so prefix prewarming (engine/local.prewarm_prefix)
        and real decisions can never drift onto different group keys."""
        return cluster_prefix(nodes) + "\n"

    def split_prompt(
        self, pod: PodSpec, nodes: Sequence[NodeMetrics]
    ) -> tuple[str, str]:
        """(shared_prefix, pod_tail) for prefix-cached prefill."""
        return self.cluster_part(nodes), pod_suffix(pod)
