"""Deterministic chaos plane: seeded fault injection, a runtime
invariant monitor, and a replayable chaos harness.

The robustness counterpart of the policy arena (sim/): the same seed
always produces the same fault schedule, the same placements, and a
byte-identical replayable trace — so "does the system survive regime X?"
is a regression test, not an anecdote.

- chaos/faults.py     — FaultPlan (seeded virtual-time fault schedule),
                        FaultInjector + named seams at the layer
                        boundaries the repo already owns, ChaosBackend.
- chaos/invariants.py — continuous invariant monitor (exactly-once bind,
                        lease fencing, cache-generation coherence, no
                        lost pods, breaker state legality), violations
                        carrying flight-recorder trace ids.
- chaos/harness.py    — wave-barriered chaos runner over the real stack
                        (wire-fake API server / replica wire / fleet /
                        elastic autoscale / journal-backed crash-restart),
                        deterministic trace + replay verification.

Entry points: `cli chaos run/replay/list`, `bench.py --preset chaos`,
tests/test_chaos_plane.py (fast-tier seeded smoke).
"""

from k8s_llm_scheduler_tpu_torch.chaos.faults import (  # noqa: F401
    REGIMES,
    ChaosBackend,
    FaultEvent,
    FaultInjector,
    FaultPlan,
    Seam,
)
from k8s_llm_scheduler_tpu_torch.chaos.harness import (  # noqa: F401
    HashPlacementBackend,
    build_chaos_trace,
    load_chaos_trace,
    replay_chaos_trace,
    run_chaos,
    save_chaos_trace,
    verify_chaos_trace,
)
from k8s_llm_scheduler_tpu_torch.chaos.invariants import (  # noqa: F401
    InvariantMonitor,
    Violation,
)
