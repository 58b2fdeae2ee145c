"""Checkpoint formats shared with the JAX package."""
