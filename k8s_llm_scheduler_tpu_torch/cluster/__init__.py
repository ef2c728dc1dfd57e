"""Cluster interfaces: read (ClusterState), write (Binder), the fake and
Kubernetes clusters (copies from the JAX package)."""

from k8s_llm_scheduler_tpu_torch.cluster.interface import (  # noqa: F401
    Binder,
    ClusterState,
    RawPod,
    raw_pod_to_spec,
)
