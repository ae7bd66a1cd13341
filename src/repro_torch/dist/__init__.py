"""Distribution, ported from ``repro.dist``. Split by concern:

  * :mod:`repro_torch.dist.sharding`: role-based PartitionSpec resolution,
    their DTensor placements on a ``DeviceMesh`` and the ambient-mesh
    ``constrain`` the model code calls;
  * :mod:`repro_torch.dist.collectives`: int8 error-feedback gradient
    compression and its bucketed all-reduce over a process group;
  * :mod:`repro_torch.dist.pipeline`: the GPipe, 1F1B and ZB-H1 schedules,
    their analytics and their execution over point-to-point rings.
"""
from repro_torch.dist.collectives import ef_compress_grads
from repro_torch.dist.pipeline import pipeline_bubble_fraction, pipeline_forward
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
    "pipeline_forward",
    "resolve_pspec",
    "to_named",
    "use_mesh",
]
