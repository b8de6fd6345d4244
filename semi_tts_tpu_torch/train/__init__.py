"""Checkpoint format shared with the JAX package."""
