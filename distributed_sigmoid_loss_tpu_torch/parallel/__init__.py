"""Attention cores that XLA computed in the JAX package."""
