"""Dependency-free utilities: JSON extraction."""
