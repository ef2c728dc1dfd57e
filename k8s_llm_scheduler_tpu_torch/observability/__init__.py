"""Per-phase tracing and decision spans (copies)."""
