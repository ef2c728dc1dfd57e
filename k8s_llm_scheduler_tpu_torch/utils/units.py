"""Kubernetes resource-quantity parsing.

Behavioral parity with the reference's unit parsers: CPU millicores
(reference scheduler.py:172-176, 737-745) and memory suffixes
(reference scheduler.py:178-187, 747-753), extended to the full K8s
quantity grammar (binary Ki/Mi/Gi/Ti/Pi and decimal k/M/G/T/P suffixes,
plus scientific notation) so the framework handles real pod specs the
reference would mis-parse.
"""

from __future__ import annotations

_BINARY = {
    "Ki": 1024.0,
    "Mi": 1024.0**2,
    "Gi": 1024.0**3,
    "Ti": 1024.0**4,
    "Pi": 1024.0**5,
    "Ei": 1024.0**6,
}
_DECIMAL = {
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
}

_GB = 1024.0**3


def parse_cpu(value: str | int | float | None) -> float:
    """Parse a K8s CPU quantity into cores.

    "100m" -> 0.1, "2" -> 2.0, "2.5" -> 2.5, 500 -> 500.0.
    Mirrors reference scheduler.py:172-176 (millicore handling) but returns
    0.0 for empty/None instead of raising.
    """
    if value is None:
        return 0.0
    if isinstance(value, (int, float)):
        return float(value)
    text = value.strip()
    if not text:
        return 0.0
    if text.endswith("m"):
        return float(text[:-1]) / 1000.0
    return float(text)


def parse_memory_bytes(value: str | int | float | None) -> float:
    """Parse a K8s memory quantity into bytes."""
    if value is None:
        return 0.0
    if isinstance(value, (int, float)):
        return float(value)
    text = value.strip()
    if not text:
        return 0.0
    for suffix, mult in _BINARY.items():
        if text.endswith(suffix):
            return float(text[: -len(suffix)]) * mult
    # Decimal suffixes are single-char; check after binary ones.
    suffix = text[-1]
    if suffix in _DECIMAL:
        return float(text[:-1]) * _DECIMAL[suffix]
    return float(text)


def parse_memory_gb(value: str | int | float | None) -> float:
    """Parse a K8s memory quantity into GB (GiB, matching the reference's
    Ki/Mi/Gi -> GB conversion at scheduler.py:178-187)."""
    return parse_memory_bytes(value) / _GB


def format_cpu(cores: float) -> str:
    """Render cores as a K8s quantity ("0.1" -> "100m")."""
    if cores < 1.0:
        return f"{int(round(cores * 1000))}m"
    if cores == int(cores):
        return str(int(cores))
    return f"{cores:g}"


def format_memory_gb(gb: float) -> str:
    """Render GB as a human-readable K8s quantity."""
    if gb >= 1.0:
        return f"{gb:g}Gi"
    mi = gb * 1024.0
    return f"{mi:g}Mi"
