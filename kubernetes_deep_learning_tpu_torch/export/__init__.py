"""Artifact reading and writing for the port (no flax, no StableHLO)."""
