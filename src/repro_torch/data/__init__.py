"""Data pipelines (``repro.data``)."""
