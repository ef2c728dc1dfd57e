"""Dependency-free utilities: JSON extraction, unit parsing (copies)."""
