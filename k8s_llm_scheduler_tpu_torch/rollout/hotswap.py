"""Zero-downtime weight swap for a running LocalLLMBackend (the port of the
JAX package's rollout/hotswap.py).

The serving engine is single-owner (one engine thread drives every device
dispatch — engine/local.py), so a swap is not a lock dance: it is a control
item on that thread's queue. `LocalLLMBackend.run_quiesced` holds new
admissions, drains every in-flight wave (no request fails or drops — held
work waits out the pause and resumes the next tick), and runs the swap at
the barrier. The admission-held wall time IS the reported swap pause.

The install is a COPY into the serving storages (engine.swap_params), not
a pointer swap as in the JAX package: the engine's CUDA graphs, its fused
WHILE program and the speculative verify programs baked the address of
every weight in at capture, and K3 reads its weight through a TMA tensor
map a captured launch holds by value. Copying in place keeps every
captured program valid and reading the new values, with no recapture.

Two residency modes, because a second copy of the params does not always
fit:

- **double** (default when it fits): restore the candidate to a device
  staging tree while the old params keep serving; the quiesced window is
  only the device-to-device copy + state invalidation. The staging tree is
  dropped after the install: burn-in rollback restores from the registry.
- **donate** (no headroom for a second device tree): inside the quiesced
  window the candidate is restored from disk into HOST memory and copied
  straight into the serving storages. The pause covers the whole restore.
  A restore that fails part way (after some leaves were written) leaves the
  engine on mixed weights — the swapper re-restores the prior version from
  the registry into the same storages before propagating (disk is the
  rollback buffer, not device memory).

On a tensor-parallel serving mesh (`mesh=`, tp > 1) the swap restores a
version directly to the serving shards, as the JAX swapper does: every
rank reads its own block of the checkpoint (engine/local.rank_params:
a safetensors checkpoint a block at a time, a native one placed) and
copies it into its own serving tensors at the same barrier
(parallel/launch.stage_swap / install_swap / donate_swap, run on every
rank through the group's on_ranks). Only the checkpoint path and the
quantization cross to the followers, never the tensors. `double` stages
each rank's block on its device (with ranks sharing a card, every
sharer's block on it); `donate` restores it to host memory inside the
pause, and a failure on any rank re-restores the prior version on every
rank before the swap raises. The fingerprint and the restore use the
model's whole config, not a rank's.

What a swap invalidates (everything computed under the old weights):
- on-device prefix-KV cache + active prefix, pins (engine.swap_params);
- the decision cache ABOVE the engine via a generation bump
  (core/cache.py) — cached decisions are the old policy's outputs and
  must never be served after promotion;
- the fleet's shared prefix-KV plane via its store generation
  (fleet/kvplane/store.py, `kvplane=`): pages peers published under the
  old weights are refused everywhere;
- open speculative streams roll back their unverified tails
  (spec/decoder.on_swap, called by swap_params).
"""

from __future__ import annotations

import logging
from typing import Any

from k8s_llm_scheduler_tpu_torch.models.loader import CheckpointError, restore_checkpoint
from k8s_llm_scheduler_tpu_torch.observability.trace import PhaseRecorder
from k8s_llm_scheduler_tpu_torch.rollout.registry import (
    CheckpointRegistry,
    RegistryError,
    config_fingerprint,
)

logger = logging.getLogger(__name__)


def swap_engine_params(engine, params) -> Any:
    """Engine-level swap (see InferenceEngine.swap_params): copy `params`
    into the served weights and invalidate weight-derived device state.
    Returns the staging tree. Callers outside the engine-owner thread must
    go through HotSwapper / run_quiesced."""
    return engine.swap_params(params)


def _tree_bytes(params) -> int:
    """Bytes of every tensor leaf of a params tree (int8 pairs included)."""
    if isinstance(params, dict):
        return sum(_tree_bytes(v) for v in params.values())
    return int(params.numel() * params.element_size())


def _device_headroom_bytes() -> int | None:
    """Free memory of the current CUDA device, or None on the CPU —
    callers treat None as 'room'."""
    import torch

    from k8s_llm_scheduler_tpu_torch.engine.graphs import DEVICE_WIDE

    if not torch.cuda.is_available():
        return None
    with DEVICE_WIDE:
        free, _total = torch.cuda.mem_get_info()
    return int(free)


class HotSwapper:
    """Promote registry versions into a live LocalLLMBackend.

    Owns: digest verification before any restore, config-fingerprint
    matching, residency-mode choice (double vs donate), the quiesced
    install, the decision-cache generation bump, and the swap-pause /
    phase accounting surfaced to /metrics."""

    def __init__(
        self,
        backend,                      # LocalLLMBackend (has .engine, .run_quiesced)
        registry: CheckpointRegistry,
        cfg,                          # the serving model's whole LlamaConfig
        *,
        mesh=None,                    # the SERVING mesh (None = single device)
        cache=None,                   # DecisionCache to generation-bump
        kvplane=None,                 # fleet KVPlaneStore to generation-bump
        mode: str = "auto",           # auto | double | donate
        quantize: str | None = None,  # None | "int8" — match the serving tree
        verify_digests: bool = True,
    ) -> None:
        if mode not in ("auto", "double", "donate"):
            raise ValueError(f"unknown swap mode {mode!r}")
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantization {quantize!r} (only 'int8')")
        self.backend = backend
        self.registry = registry
        self.cfg = cfg
        self.mesh = mesh
        plane = getattr(backend.engine, "plane", None)
        if plane is not None and not self._sharded():
            raise ValueError(
                f"the engine serves tp={plane.tp}: pass mesh=engine.mesh, so each rank "
                f"restores its own block")
        self.cache = cache
        # Shared prefix-KV plane store: its generation is the FLEET-wide
        # twin of engine.prefix_epoch — peers' published prefix pages
        # were prefilled under the outgoing weights, so the swap must
        # invalidate them everywhere, not just on this replica.
        self.kvplane = kvplane
        self.mode = mode
        self.quantize = quantize
        self.verify_digests = verify_digests
        self.phases = PhaseRecorder()
        self.active_version: int | None = registry.active()
        self._prior_version: int | None = None
        self.stats_counters = {
            "swaps": 0,
            "rollbacks": 0,
            "last_pause_s": 0.0,
            "last_mode": "",
        }

    def _sharded(self) -> bool:
        return self.mesh is not None and int(self.mesh.shape.get("tp", 1)) > 1

    # ----------------------------------------------------------- residency
    def _choose_mode(self) -> str:
        if self.mode != "auto":
            return self.mode
        params_bytes = _tree_bytes(self.backend.engine.params)
        if self._sharded():
            # the driver's block, times the ranks that stage on its card
            mine = self.mesh.local_device_index()
            params_bytes *= sum(self.mesh.local_device_index(r) == mine
                                for r in self.mesh.axis_ranks("tp"))
        headroom = _device_headroom_bytes()
        if headroom is not None and headroom < params_bytes:
            logger.info(
                "swap mode=donate: %.2f GB params vs %.2f GB free device memory "
                "(double-buffering needs a full second copy)",
                params_bytes / 1e9, headroom / 1e9,
            )
            return "donate"
        return "double"

    def _restore(self, manifest, device) -> Any:
        """Restore a registry version shaped exactly like the serving tree
        (same dtype, same quantization) onto `device`; a checkpoint saved
        already quantized is taken as it is."""
        from k8s_llm_scheduler_tpu_torch.models.quant import is_quantized, quantize_params

        params = restore_checkpoint(manifest.checkpoint_path, self.cfg, device=device)
        if self.quantize == "int8" and not is_quantized(params["layers"]["wq"]):
            params = quantize_params(params)
        return params

    # ---------------------------------------------------------------- swap
    def _check_version(self, version: int) -> "Any":
        manifest = self.registry.get(version)
        if self.verify_digests:
            ok, problems = self.registry.verify(version)
            if not ok:
                raise CheckpointError(
                    f"registry version {version} failed digest verification "
                    f"before swap: {problems[:3]}"
                )
        want = config_fingerprint(self.cfg)
        if manifest.config_fingerprint and manifest.config_fingerprint != want:
            raise CheckpointError(
                f"registry version {version} is shaped for config "
                f"{manifest.config_name!r} (fingerprint "
                f"{manifest.config_fingerprint}), serving config is "
                f"{self.cfg.name!r} ({want})"
            )
        return manifest

    def swap_to(self, version: int) -> dict:
        """Hot-swap the live engine to `version`. Returns
        {"version", "prior", "pause_s", "mode"}. Raises CheckpointError /
        RegistryError with the engine still serving the OLD weights (double
        mode) or restored to them from disk (donate mode)."""
        manifest = self._check_version(version)
        mode = self._choose_mode()
        engine = self.backend.engine
        prior = self.active_version

        if self._sharded():
            install = self._sharded_install(manifest, mode, prior)
            _, pause_s = self.backend.run_quiesced(install)
        elif mode == "double":
            # restore OUTSIDE the quiesced window: old params serve throughout
            with self.phases.phase("swap_load"):
                staging = self._restore(manifest, engine.device)

            def install():
                with self.phases.phase("swap_install"):
                    return engine.swap_params(staging)

            _, pause_s = self.backend.run_quiesced(install)
            # the staging tree goes here: burn-in rollback restores from the
            # registry (double-buffering covers the SWAP, not the burn-in)
            del staging
        else:
            def install():
                with self.phases.phase("swap_install"):
                    try:
                        # host memory only: no second device tree
                        return engine.swap_params(self._restore(manifest, "cpu"))
                    except Exception:
                        # a leaf may already hold the candidate's values:
                        # restore the prior version from disk into the same
                        # storages before propagating, or serving is mixed
                        if prior is not None:
                            engine.swap_params(
                                self._restore(self.registry.get(prior), "cpu"))
                        raise

            _, pause_s = self.backend.run_quiesced(install)

        if self.cache is not None:
            self.cache.bump_generation()
        if self.kvplane is not None:
            self.kvplane.bump_generation()
        self._prior_version = prior
        self.active_version = version
        self.stats_counters["swaps"] += 1
        self.stats_counters["last_pause_s"] = round(pause_s, 6)
        self.stats_counters["last_mode"] = mode
        logger.info(
            "hot-swapped to version %d (mode=%s, pause=%.1f ms, prior=%s)",
            version, mode, pause_s * 1000.0, prior,
        )
        return {
            "version": version,
            "prior": prior,
            "pause_s": pause_s,
            "mode": mode,
        }

    def _source(self, manifest) -> dict:
        """What a rank restores its block from (engine/local.rank_params)."""
        return {"checkpoint_path": str(manifest.checkpoint_path), "quantize": self.quantize,
                "seed": None}

    def _sharded_install(self, manifest, mode: str, prior: int | None):
        """The install a tp group runs at the barrier: each rank its own
        block. `double` stages them first, outside the pause."""
        from k8s_llm_scheduler_tpu_torch.parallel import launch

        group = self.backend.engine.rank_group
        source = self._source(manifest)
        if mode == "double":
            with self.phases.phase("swap_load"):
                # every rank loads in a thread of its own while it serves;
                # the driver waits for its own here, the install for all
                group.on_ranks(launch.stage_swap, source, self.cfg)
                launch.wait_staged(self.backend.engine)

            def install():
                with self.phases.phase("swap_install"):
                    return group.on_ranks(launch.install_swap)

            return install
        fallback = self._source(self.registry.get(prior)) if prior is not None else None

        def install():
            with self.phases.phase("swap_install"):
                return group.on_ranks(launch.donate_swap, source, self.cfg, fallback)

        return install

    def rollback(self) -> dict:
        """Swap back to the version active before the last swap_to (burn-in
        trip path). Falls back to the active version's manifest parent when
        the in-memory prior is unknown (fresh controller)."""
        target = self._prior_version
        if target is None and self.active_version is not None:
            target = self.registry.get(self.active_version).parent
        if target is None:
            raise RegistryError("no prior version to roll back to")
        out = self.swap_to(target)
        self.stats_counters["rollbacks"] += 1
        return out

    def stats(self) -> dict:
        return {
            **self.stats_counters,
            "active_version": self.active_version,
            "phases": self.phases.snapshot(),
        }
