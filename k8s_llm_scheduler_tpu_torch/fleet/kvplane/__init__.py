"""Shared prefix-KV plane: one replica's snapshot prefill serves the
fleet. See store.py for the coherence protocol, pages.py for the unit
shipped, client.py for the per-replica pin path, stub.py for the
model-free protocol engine used by chaos and bench."""

from .client import KVPlaneClient
from .pages import (
    KVGeometry,
    KVGeometryError,
    PrefixPageSet,
    adopt_pages,
    export_pages,
    page_digest,
)
from .store import KVPlaneStore, KVPlaneStoreUnavailable
from .stub import StubPinEngine

__all__ = [
    "KVGeometry",
    "KVGeometryError",
    "KVPlaneClient",
    "KVPlaneStore",
    "KVPlaneStoreUnavailable",
    "PrefixPageSet",
    "StubPinEngine",
    "adopt_pages",
    "export_pages",
    "page_digest",
]
