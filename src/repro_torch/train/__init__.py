"""The training step and loop (``repro.train``)."""
