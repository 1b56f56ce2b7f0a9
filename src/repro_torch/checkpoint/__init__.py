"""Checkpoints in the JAX package's npz + manifest format (counterpart of
``repro.checkpoint``)."""
