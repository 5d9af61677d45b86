"""Checkpoints of the immutable previous buffer (JAX's on-disk format)."""
