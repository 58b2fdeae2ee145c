"""Datasets, prompts and tokenizers (copies of the JAX package's JAX-free modules)."""
