"""Distribution, ported from ``repro.dist``: so far only the pipeline
schedules' analytics (``dist.pipeline``)."""
