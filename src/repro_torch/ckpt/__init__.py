"""Checkpoints in the JAX package's file format (npz shards + MANIFEST)."""
