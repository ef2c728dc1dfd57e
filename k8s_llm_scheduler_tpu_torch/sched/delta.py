"""Snapshot-delta prompt encoding: O(changed) prompts over a pinned pin.

The whole-prompt scheme re-renders the full cluster state into every
burst's prefix — and because node USAGE figures drift with every bind,
consecutive snapshots' renders diverge a few characters into the first
drifted node, so the engine's LCP prefix reuse collapses and each burst
re-pays an O(cluster) prefill. At 10k nodes that is the cost that makes
per-decision LLM scheduling unaffordable (ROADMAP item 2).

The delta encoding fixes the RENDERING, which fixes the prefill: the
first snapshot is PINNED (rendered once, its token prefix KV pinned on
device — engine/admission/pinned.py), and every later snapshot renders as

    <pinned snapshot, verbatim>  +  STATE UPDATES section (changed nodes
    only, latest values win)     +  per-pod suffix

so the pinned text is a literal string prefix of every subsequent prompt
— causal attention makes its KV bit-reusable — and prefill cost scales
with HOW MUCH CHANGED, not cluster size. The model sees the same
information (full state + overriding updates); the decision grammar and
all validation still run against the LIVE node list.

Re-pin policy: membership or readiness-set changes re-pin immediately
(the VALID NODE NAMES list and the decision grammar would otherwise
disagree with the pinned text), and a drift fraction above
`repin_fraction` re-pins because the delta section is approaching the
cost of a fresh render. Encoding is a pure function of (pin, snapshot)
between re-pins, so every pod of a burst — and the prewarm path — lands
on one group key.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections.abc import Sequence

from k8s_llm_scheduler_tpu_torch.core.prompt import cluster_prefix, render_node_block
from k8s_llm_scheduler_tpu_torch.types import NodeMetrics

DELTA_HEADER = (
    "STATE UPDATES (changes since the snapshot above; latest values win):"
)


@dataclasses.dataclass(frozen=True)
class DeltaPrompt:
    """One encoded cluster part, ready to glue a pod suffix onto."""

    cluster_part: str     # full prefix text for this decision
    pin_key: str | None   # stable id of the pinned snapshot (replica-local)
    pin_text: str         # the pinned snapshot's own prefix text
    delta_nodes: int      # nodes rendered in the delta section (0 = none)
    repinned: bool        # this encode re-pinned (fresh full render)
    # Content digest of pin_text. pin_key is a replica-local sequence
    # number ("pin-3") — two replicas watching the same cluster number
    # their pins independently, but their pin TEXT (hence tokens, hence
    # prefix KV) is identical. The shared prefix-KV plane keys pages by
    # content, and this digest is the cross-replica rendezvous for it.
    pin_digest: str = ""


@dataclasses.dataclass
class _Pin:
    key: str
    names: tuple[str, ...]          # node order at pin time
    ready: tuple[bool, ...]         # readiness at pin time
    blocks: dict[str, str]          # name -> rendered node block
    text: str                       # full pinned cluster part
    digest: str                     # blake2b(text) — fleet-sharable id


def pin_text_digest(text: str) -> str:
    """Content address of a pinned snapshot render — identical across
    replicas that rendered the same cluster state (core/prompt.py renders
    deterministically), unlike the per-replica pin-<seq> keys."""
    return hashlib.blake2b(text.encode("utf-8"), digest_size=16).hexdigest()


class SnapshotDeltaEncoder:
    """Stateful per-backend encoder; thread-safe (decisions prepare from
    many caller threads)."""

    def __init__(self, repin_fraction: float = 0.25) -> None:
        self.repin_fraction = float(repin_fraction)
        self._lock = threading.Lock()
        self._pin: _Pin | None = None
        self._pin_seq = 0
        self.stats_counters = {
            "encodes": 0,
            "pins": 0,
            "delta_encodes": 0,
            "clean_encodes": 0,
            "repin_membership": 0,
            "repin_drift": 0,
            "delta_nodes_total": 0,
        }

    # ------------------------------------------------------------- public
    def encode(self, nodes: Sequence[NodeMetrics]) -> DeltaPrompt:
        with self._lock:
            self.stats_counters["encodes"] += 1
            names = tuple(n.name for n in nodes)
            ready = tuple(bool(n.is_ready) for n in nodes)
            pin = self._pin
            if pin is None or names != pin.names or ready != pin.ready:
                if pin is not None:
                    self.stats_counters["repin_membership"] += 1
                return self._repin_locked(nodes)
            blocks = {n.name: render_node_block(n) for n in nodes}
            changed = [n for n in names if blocks[n] != pin.blocks[n]]
            if not changed:
                self.stats_counters["clean_encodes"] += 1
                return DeltaPrompt(
                    cluster_part=pin.text, pin_key=pin.key,
                    pin_text=pin.text, delta_nodes=0, repinned=False,
                    pin_digest=pin.digest,
                )
            if len(changed) > self.repin_fraction * len(names):
                self.stats_counters["repin_drift"] += 1
                return self._repin_locked(nodes)
            delta = "\n\n".join(blocks[n] for n in changed)
            part = f"{pin.text}{DELTA_HEADER}\n\n{delta}\n\n"
            self.stats_counters["delta_encodes"] += 1
            self.stats_counters["delta_nodes_total"] += len(changed)
            return DeltaPrompt(
                cluster_part=part, pin_key=pin.key, pin_text=pin.text,
                delta_nodes=len(changed), repinned=False,
                pin_digest=pin.digest,
            )

    def reset(self) -> None:
        """Drop the pin (next encode re-pins fresh)."""
        with self._lock:
            self._pin = None

    def stats(self) -> dict:
        with self._lock:
            return dict(self.stats_counters)

    # ------------------------------------------------------------ internal
    def _repin_locked(self, nodes: Sequence[NodeMetrics]) -> DeltaPrompt:
        """Pin the current snapshot; the encoded part IS the plain full
        render (byte-identical to the non-delta path — zero drift means
        zero encoding overhead)."""
        self._pin_seq += 1
        # same trailing glue as PromptEngine.cluster_part: prefix + "\n"
        text = cluster_prefix(nodes) + "\n"
        pin = _Pin(
            key=f"pin-{self._pin_seq}",
            names=tuple(n.name for n in nodes),
            ready=tuple(bool(n.is_ready) for n in nodes),
            blocks={n.name: render_node_block(n) for n in nodes},
            text=text,
            digest=pin_text_digest(text),
        )
        self._pin = pin
        self.stats_counters["pins"] += 1
        return DeltaPrompt(
            cluster_part=text, pin_key=pin.key, pin_text=text,
            delta_nodes=0, repinned=True, pin_digest=pin.digest,
        )
