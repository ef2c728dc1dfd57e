"""The scheduling control plane: decision client, deadline, watch loop (copies)."""
