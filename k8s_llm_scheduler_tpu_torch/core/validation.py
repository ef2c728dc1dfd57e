"""Decision validation and feasibility checks.

The reference validates only that the LLM's selected node is in the live node
list (reference scheduler.py:453-465) — its defense against hallucinated node
names. This module keeps that check and adds feasibility predicates
(readiness, node selector, taint toleration, resource fit) that both the
fallback scorer and the constrained decoder's candidate-node set use, so an
infeasible node can be excluded *before* decoding rather than detected after.
"""

from __future__ import annotations

from collections.abc import Sequence

from k8s_llm_scheduler_tpu_torch.types import NodeMetrics, PodSpec, SchedulingDecision


def node_names(nodes: Sequence[NodeMetrics]) -> set[str]:
    return {n.name for n in nodes}


def validate_decision(
    decision: SchedulingDecision, nodes: Sequence[NodeMetrics]
) -> bool:
    """True iff the selected node exists in the live node list
    (reference scheduler.py:453-455)."""
    return decision.selected_node in node_names(nodes)


def selector_matches(pod: PodSpec, node: NodeMetrics) -> bool:
    """Every nodeSelector key/value must be present in the node's labels."""
    return all(node.labels.get(k) == v for k, v in pod.node_selector.items())


def tolerates_taints(pod: PodSpec, node: NodeMetrics) -> bool:
    """NoSchedule/NoExecute taints must be tolerated by the pod.

    Simplified K8s semantics: a toleration matches a taint when its key is
    empty (tolerate-all) or equals the taint key, and its effect is empty or
    equal to the taint effect.
    """
    for taint in node.taints:
        effect = taint.get("effect", "")
        if effect not in ("NoSchedule", "NoExecute"):
            continue
        tolerated = any(
            (not tol.get("key") or tol.get("key") == taint.get("key"))
            and (not tol.get("effect") or tol.get("effect") == effect)
            for tol in pod.tolerations
        )
        if not tolerated:
            return False
    return True


def _affinity_expr_matches(
    expr: dict, labels: dict[str, str], node_name: str = ""
) -> bool:
    key = expr.get("key", "")
    op = expr.get("operator", "In")
    values = expr.get("values") or []
    if expr.get("field"):
        # matchFields expression: K8s only supports metadata.name here.
        labels = {"metadata.name": node_name}
    present = key in labels
    val = labels.get(key)
    if op == "In":
        return present and val in values
    if op == "NotIn":
        # K8s semantics: NotIn (like DoesNotExist) also matches nodes
        # WITHOUT the label.
        return not present or val not in values
    if op == "Exists":
        return present
    if op == "DoesNotExist":
        return not present
    if op in ("Gt", "Lt"):
        try:
            have, want = int(val), int(values[0])
        except (TypeError, ValueError, IndexError):
            return False
        return have > want if op == "Gt" else have < want
    return False  # unknown operator: fail closed


def node_affinity_matches(pod: PodSpec, node: NodeMetrics) -> bool:
    """requiredDuringSchedulingIgnoredDuringExecution node affinity.

    `affinity_rules["node_affinity_terms"]` is a list of terms (OR), each a
    list of match expressions (AND) — the normalized form
    cluster/interface.raw_pod_to_spec produces from a V1Pod. No rules =
    match everything. The reference carries affinity but always drops it
    (reference scheduler.py:762 `affinity_rules={}`); this predicate makes
    the field live.
    """
    terms = pod.affinity_rules.get("node_affinity_terms") or []
    if not terms:
        return True
    return any(
        term
        and all(_affinity_expr_matches(e, node.labels, node.name) for e in term)
        for term in terms
    )


def resources_fit(pod: PodSpec, node: NodeMetrics) -> bool:
    return (
        pod.cpu_request <= node.available_cpu_cores
        and pod.memory_request <= node.available_memory_gb
        and node.pod_count < node.max_pods
    )


def feasible_nodes(
    pod: PodSpec, nodes: Sequence[NodeMetrics]
) -> list[NodeMetrics]:
    """Nodes the pod could legally land on. Used to build the constrained
    decoder's allowed-node-name set, turning the reference's
    validate-then-fallback (scheduler.py:453-465) into
    can't-fail-by-construction."""
    return [
        n
        for n in nodes
        if n.is_ready
        and selector_matches(pod, n)
        and node_affinity_matches(pod, n)
        and tolerates_taints(pod, n)
        and resources_fit(pod, n)
    ]
