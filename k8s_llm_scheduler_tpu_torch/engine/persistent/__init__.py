"""Persistent serving loop (the port of the JAX package's engine/persistent/).

A resident thread serves admissions, fused decode micro-chunks and emission
streaming over the engine's slots: slot state stays on the device, a
host->loop COMMAND RING feeds admissions/aborts/quiesce, and a loop->host
TOKEN RING streams emissions (with exact `steps_run` books) back out. In
steady state the engine owner's thread makes no device call per decision;
the resident thread makes one graph launch per micro-chunk.

Layout:
- ring.py   — CommandRing / TokenRing / Heartbeat: the bounded,
  thread-safe rings with blocking backpressure (zero lost tokens by
  construction) and wedge detection (a copy of the JAX module).
- loop.py   — the micro-chunk program (resident_iteration: admission
  through forward_prefill_suffix + sample_fused, then the EXACT step of
  engine/fused/loop.py) and the resident thread's poll/run/push loop.
- server.py — PersistentServer: the resident thread, ring plumbing,
  watchdog and drain.
"""

from k8s_llm_scheduler_tpu_torch.engine.persistent.ring import (
    OP_ABORT,
    OP_ADMIT,
    OP_NOOP,
    OP_QUIESCE,
    Command,
    CommandRing,
    Heartbeat,
    HarvestBatch,
    RingClosed,
    RingFull,
    TokenRing,
)


def __getattr__(name: str):
    # server.py imports torch; the rings are pure numpy/threading: keep the
    # heavyweight half of the package lazy, as the JAX package does
    if name == "PersistentServer":
        from k8s_llm_scheduler_tpu_torch.engine.persistent.server import PersistentServer

        return PersistentServer
    raise AttributeError(name)


__all__ = [
    "OP_NOOP", "OP_ADMIT", "OP_ABORT", "OP_QUIESCE",
    "Command", "CommandRing", "TokenRing", "HarvestBatch",
    "Heartbeat", "RingFull", "RingClosed", "PersistentServer",
]
