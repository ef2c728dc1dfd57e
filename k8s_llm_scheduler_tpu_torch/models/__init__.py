"""Llama configurations and the PyTorch model; weight conversion."""
