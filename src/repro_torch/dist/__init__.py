"""Distribution, ported from ``repro.dist``: the pipeline schedules'
analytics (``dist.pipeline``) and the gradient-compression collectives
(``dist.collectives``); sharding and the executed schedules wait for a
mesh (ROADMAP A10)."""
