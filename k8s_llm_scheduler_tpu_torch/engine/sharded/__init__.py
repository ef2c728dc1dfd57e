"""engine/sharded — fleet-level slice geometry.

geometry.py (a copy of the JAX package's): the device-group sizes that
drive the disaggregated pool split (fleet/pools.py). A port engine serves
on one device and has no mesh, so every member resolves to tp 1.

The JAX package's tensor-parallel serving plane (plane.py: KV, prefix and
logits shardings, the constraint bundle, quantization-aware param specs)
is not ported: it waits for ROADMAP queue 1 item 9c.
"""

from k8s_llm_scheduler_tpu_torch.engine.sharded.geometry import (
    FleetGeometry,
    member_tp,
)

__all__ = [
    "FleetGeometry",
    "member_tp",
]
