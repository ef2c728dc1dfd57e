"""Decision-plane logic copied from the JAX package: prompt, validation."""
