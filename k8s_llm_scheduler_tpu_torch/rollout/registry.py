"""Versioned checkpoint registry: the durable handoff between train and serve
(a copy of the JAX package's rollout/registry.py; its on-disk layout and
manifest.json are that package's, byte for byte).

A trainer writes a checkpoint dir (the port's: models/loader.save_checkpoint);
`CheckpointRegistry.publish` copies it into the registry under a monotonic
version id with a manifest recording everything promotion needs to trust it:

- a config fingerprint (the LlamaConfig the params are shaped for — a
  candidate shaped for a different config must be rejected before it ever
  reaches the serving engine);
- per-file content digests (`verify` recomputes them, so a torn copy,
  truncated upload, or tampered file is caught before restore);
- lineage (parent version) and recorded arena scores.

Publish is ATOMIC with the same write-aside + rename discipline as
models/loader.save_checkpoint: everything lands in a staging dir first and
one rename makes the version visible — a crash mid-publish leaves only a
`.staging-*` dir that the next publish sweeps, never a half-readable
version. The pointer file (active version, next id) updates via
write-tmp + os.replace for the same reason.

Single-writer by design: one trainer/controller process publishes and
promotes; serving processes only read. Version ids stay monotonic across
retention deletes (the pointer file remembers `next_version`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import time
from pathlib import Path
from typing import Any, Iterable

logger = logging.getLogger(__name__)

_VERSION_FMT = "v{:06d}"
_MANIFEST = "manifest.json"
_CHECKPOINT = "checkpoint"
_POINTER = "registry.json"


class RegistryError(RuntimeError):
    """A registry operation failed (unknown version, digest mismatch...)."""


def _dtype_name(dtype: Any) -> str:
    """A dtype as the JAX package stringifies it: torch.bfloat16 ->
    "<class 'jax.numpy.bfloat16'>", the str() of jnp.bfloat16 there."""
    name = str(dtype)
    if name.startswith("torch."):
        return f"<class 'jax.numpy.{name[len('torch.'):]}'>"
    return name


def config_fingerprint(cfg: Any) -> str:
    """Stable digest of a LlamaConfig's architecture-defining fields.

    Serving must only hot-swap a checkpoint whose fingerprint matches the
    engine's config — same shapes, same dtype, same captured programs.
    dtype is stringified under the name the JAX package writes for it
    (`_dtype_name`), so one architecture has one fingerprint in both
    packages; nested dataclasses (RopeScaling) flatten through asdict."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = _dtype_name(d.get("dtype"))
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _file_digest(path: Path) -> tuple[str, int]:
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
            size += len(chunk)
    return h.hexdigest(), size


@dataclasses.dataclass
class Manifest:
    """One published version's metadata (the on-disk manifest.json)."""

    version: int
    config_name: str
    config_fingerprint: str
    tokenizer: str
    created_at: float
    parent: int | None = None
    scores: dict[str, Any] = dataclasses.field(default_factory=dict)
    note: str = ""
    # relpath under checkpoint/ -> {"sha256": ..., "bytes": ...}
    files: dict[str, dict[str, Any]] = dataclasses.field(default_factory=dict)
    # filled by the registry on load; never serialized
    checkpoint_path: Path | None = dataclasses.field(default=None, repr=False)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("checkpoint_path")
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Manifest":
        return cls(**{k: v for k, v in d.items() if k != "checkpoint_path"})


class CheckpointRegistry:
    """On-disk registry: <root>/v000001/{manifest.json, checkpoint/...}."""

    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        # sweep staging debris from a crashed publish — never a visible
        # version, always safe to delete
        for stale in self.root.glob(".staging-*"):
            shutil.rmtree(stale, ignore_errors=True)

    # ------------------------------------------------------------- pointer
    def _pointer(self) -> dict:
        p = self.root / _POINTER
        if not p.exists():
            return {"active": None, "next_version": 1}
        with open(p) as fh:
            return json.load(fh)

    def _write_pointer(self, data: dict) -> None:
        tmp = self.root / (_POINTER + ".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(data, fh, indent=1, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.root / _POINTER)

    def active(self) -> int | None:
        return self._pointer()["active"]

    def set_active(self, version: int | None) -> None:
        if version is not None:
            self.get(version)  # raises RegistryError on an unknown version
        ptr = self._pointer()
        ptr["active"] = version
        self._write_pointer(ptr)

    # ------------------------------------------------------------ versions
    def _version_dir(self, version: int) -> Path:
        return self.root / _VERSION_FMT.format(version)

    def versions(self) -> list[int]:
        out = []
        for d in self.root.iterdir():
            if d.is_dir() and d.name.startswith("v") and (d / _MANIFEST).exists():
                try:
                    out.append(int(d.name[1:]))
                except ValueError:
                    continue
        return sorted(out)

    def latest(self) -> Manifest | None:
        versions = self.versions()
        return self.get(versions[-1]) if versions else None

    def get(self, version: int) -> Manifest:
        vdir = self._version_dir(version)
        manifest_path = vdir / _MANIFEST
        if not manifest_path.exists():
            raise RegistryError(
                f"registry {self.root}: no version {version} "
                f"(have {self.versions()})"
            )
        with open(manifest_path) as fh:
            manifest = Manifest.from_dict(json.load(fh))
        manifest.checkpoint_path = vdir / _CHECKPOINT
        return manifest

    # ------------------------------------------------------------- publish
    def publish(
        self,
        checkpoint_dir: str | Path,
        *,
        cfg: Any = None,
        config_name: str = "",
        tokenizer: str = "byte",
        parent: int | None = None,
        scores: dict | None = None,
        note: str = "",
    ) -> Manifest:
        """Copy `checkpoint_dir` into the registry as the next version.

        Digests are computed WHILE copying (one read of each file), the
        manifest is written into the staging dir, and a single rename
        publishes the version. `cfg` (a LlamaConfig) stamps the config
        fingerprint; passing only `config_name` records the name without a
        fingerprint (fingerprint-less versions never pass a fingerprint
        check at swap time)."""
        src = Path(checkpoint_dir)
        if not src.is_dir():
            raise RegistryError(f"checkpoint dir {src} does not exist")
        ptr = self._pointer()
        version = int(ptr["next_version"])
        staging = self.root / f".staging-{_VERSION_FMT.format(version)}-{os.getpid()}"
        if staging.exists():
            shutil.rmtree(staging)
        dst = staging / _CHECKPOINT
        files: dict[str, dict[str, Any]] = {}
        try:
            for path in sorted(src.rglob("*")):
                rel = path.relative_to(src)
                target = dst / rel
                if path.is_dir():
                    target.mkdir(parents=True, exist_ok=True)
                    continue
                target.parent.mkdir(parents=True, exist_ok=True)
                shutil.copyfile(path, target)
                digest, size = _file_digest(target)
                files[str(rel)] = {"sha256": digest, "bytes": size}
            if not files:
                raise RegistryError(f"checkpoint dir {src} is empty")
            manifest = Manifest(
                version=version,
                config_name=(
                    config_name or (getattr(cfg, "name", "") if cfg else "")
                ),
                config_fingerprint=config_fingerprint(cfg) if cfg else "",
                tokenizer=tokenizer,
                created_at=time.time(),  # graftlint: ok[raw-clock, wall-clock-in-replay] — wall-clock metadata for operators, never compared against durations
                parent=parent if parent is not None else self.active(),
                scores=dict(scores or {}),
                note=note,
                files=files,
            )
            with open(staging / _MANIFEST, "w", encoding="utf-8") as fh:
                json.dump(manifest.to_dict(), fh, indent=1, sort_keys=True)
                fh.flush()
                os.fsync(fh.fileno())
            final = self._version_dir(version)
            os.rename(staging, final)  # the atomic publish
        except Exception:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        ptr["next_version"] = version + 1
        self._write_pointer(ptr)
        manifest.checkpoint_path = final / _CHECKPOINT
        logger.info(
            "published checkpoint version %d (%d files, parent=%s)",
            version, len(files), manifest.parent,
        )
        return manifest

    def record_scores(self, version: int, scores: dict) -> None:
        """Merge arena/gate scores into a version's manifest (atomic)."""
        manifest = self.get(version)
        manifest.scores.update(scores)
        vdir = self._version_dir(version)
        tmp = vdir / (_MANIFEST + ".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(manifest.to_dict(), fh, indent=1, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, vdir / _MANIFEST)

    # -------------------------------------------------------------- verify
    def verify(self, version: int) -> tuple[bool, list[str]]:
        """Digest-check every file of a version against its manifest.

        Catches torn copies, truncation, and tampering BEFORE the
        checkpoint reaches the engine; a failed verify must gate any swap."""
        manifest = self.get(version)
        root = manifest.checkpoint_path
        problems: list[str] = []
        for rel, meta in sorted(manifest.files.items()):
            path = root / rel
            if not path.is_file():
                problems.append(f"missing file {rel}")
                continue
            digest, size = _file_digest(path)
            if size != meta["bytes"]:
                problems.append(
                    f"{rel}: {size} bytes, manifest says {meta['bytes']}"
                )
            elif digest != meta["sha256"]:
                problems.append(f"{rel}: content digest mismatch")
        on_disk = {
            str(p.relative_to(root))
            for p in root.rglob("*")
            if p.is_file()
        }
        for extra in sorted(on_disk - set(manifest.files)):
            problems.append(f"unmanifested file {extra}")
        return (not problems), problems

    def fsck(self) -> dict[int, list[str]]:
        """verify() every version; returns {version: problems} (empty list
        = clean). The `cli rollout fsck` surface."""
        return {v: self.verify(v)[1] for v in self.versions()}

    # ----------------------------------------------------------- retention
    def retain(self, keep_last: int, pinned: "Iterable[int]" = ()) -> list[int]:
        """Delete all but the newest `keep_last` versions. The active
        version and the active version's parent (the rollback target) are
        always kept regardless, as is every version in `pinned` — the
        caller-supplied protection set for versions the keep-last window
        cannot see are still referenced: an OPEN canary candidate
        (CanaryController.pinned_versions — mid burn-in its version may
        be neither active nor newest) and checkpoints an incident corpus
        mined against (learn/miner.IncidentCorpus.lineage_versions —
        deleting them orphans the corpus's provenance and any trace
        replay that resolves it). Returns the deleted version ids."""
        if keep_last < 1:
            return []
        versions = self.versions()
        keep = set(versions[-keep_last:])
        keep.update(int(v) for v in pinned)
        active = self.active()
        if active is not None:
            keep.add(active)
            try:
                parent = self.get(active).parent
            except RegistryError:
                parent = None
            if parent is not None:
                keep.add(parent)
        deleted = []
        for v in versions:
            if v in keep:
                continue
            shutil.rmtree(self._version_dir(v), ignore_errors=True)
            deleted.append(v)
        if deleted:
            logger.info("retention deleted versions %s", deleted)
        return deleted

    # --------------------------------------------------------------- misc
    def status(self) -> dict:
        """JSON-ready summary for `cli rollout status` and /metrics."""
        versions = []
        for v in self.versions():
            m = self.get(v)
            versions.append({
                "version": v,
                "config": m.config_name,
                "fingerprint": m.config_fingerprint,
                "parent": m.parent,
                "scores": m.scores,
                "n_files": len(m.files),
                "bytes": sum(f["bytes"] for f in m.files.values()),
                "note": m.note,
            })
        return {
            "root": str(self.root),
            "active": self.active(),
            "versions": versions,
        }
