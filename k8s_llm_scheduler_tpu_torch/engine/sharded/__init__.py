"""engine/sharded — the tensor-parallel serving plane.

plane.py: a rank's share of the model and of the engine's state (the
local geometry, the row-parallel all-reduce, the vocab-sharded embedding
and logits, quantization-aware param specs). geometry.py (a copy of the
JAX package's): fleet-level slice geometry, the device-group sizes that
drive the disaggregated pool split (fleet/pools.py); an engine built over
a tp mesh reports its tp through `engine.mesh`.
"""

from k8s_llm_scheduler_tpu_torch.engine.sharded.geometry import (
    FleetGeometry,
    member_tp,
)
from k8s_llm_scheduler_tpu_torch.engine.sharded.plane import (
    RankConfig,
    ServingPlane,
    build_plane,
    serving_param_specs,
)

__all__ = [
    "FleetGeometry",
    "RankConfig",
    "ServingPlane",
    "build_plane",
    "member_tp",
    "serving_param_specs",
]
