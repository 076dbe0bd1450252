"""Distributed training pieces of the port (slice 2: activation recompute)."""
