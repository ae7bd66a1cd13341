"""Optimizers, ported from ``repro.optim``: AdamW with the reference's
schedules, global-norm clipping and matrix-only weight decay."""
