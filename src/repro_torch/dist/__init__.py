"""Distribution, ported from ``repro.dist``. Split by concern:

  * :mod:`repro_torch.dist.sharding`: role-based PartitionSpec resolution
    and the ambient-mesh ``constrain`` the model code calls;
  * :mod:`repro_torch.dist.collectives`: int8 error-feedback gradient
    compression;
  * :mod:`repro_torch.dist.pipeline`: the pipeline schedules' analytics.

Executed sharding (``to_named``, ``constrain`` under a mesh) and the
executed pipeline schedules (the reference's ``pipeline_forward``) wait
for ROADMAP A10 part 2.
"""
from repro_torch.dist.collectives import ef_compress_grads
from repro_torch.dist.pipeline import pipeline_bubble_fraction
from repro_torch.dist.sharding import (
    active_mesh,
    batch_pspecs,
    cache_pspecs,
    constrain,
    param_pspecs,
    resolve_pspec,
    to_named,
    use_mesh,
)

__all__ = [
    "active_mesh",
    "batch_pspecs",
    "cache_pspecs",
    "constrain",
    "ef_compress_grads",
    "param_pspecs",
    "pipeline_bubble_fraction",
    "resolve_pspec",
    "to_named",
    "use_mesh",
]
