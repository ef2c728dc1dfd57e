"""Decision-plane logic copied from the JAX package: prompt, validation,
decision cache, circuit breaker, heuristic fallback."""
