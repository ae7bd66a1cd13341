"""Fault-tolerant checkpoints (``repro.checkpoint``)."""
