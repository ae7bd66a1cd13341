"""Static auditor, ported from ``repro.analysis``: device-free checks that
catch model/prediction drift before anything compiles or serves.

Four check families (see :mod:`repro_torch.analysis.diagnostics` for the code
table):

* ``conservation`` (SP1xx) — analytical FLOP/byte ledgers vs the
  decomposer's per-call output;
* ``kernel-resource`` (SP2xx) — the reference kernels' Pallas
  grid/BlockSpec geometry vs each ``TPUSpec``'s VMEM;
* ``sharding`` (SP3xx) — PartitionSpec trees vs a mesh shape;
* ``coverage`` (SP4xx) — emitted call vocabulary vs what backends price.

Run the full audit with ``python -m repro_torch.analysis --all --strict``.
"""
from repro_torch.analysis.audit import CHECK_FAMILIES, AuditShape, audit_arch, run_audit
from repro_torch.analysis.conservation import (
    check_conservation,
    check_dryrun_artifacts,
    check_ep_alltoall,
    check_head_accounting,
    check_task_conservation,
)
from repro_torch.analysis.coverage import (
    E2E_FAMILIES,
    audit_comm_regressor,
    audit_predictor,
    check_coverage,
)
from repro_torch.analysis.diagnostics import (
    SEVERITIES,
    AuditError,
    Diagnostic,
    json_report,
    render_report,
    sort_diagnostics,
    worst_severity,
)
from repro_torch.analysis.kernels import KERNEL_HELPERS, check_kernel_resources, kernel_workloads
from repro_torch.analysis.sharding import PRODUCTION_MESH_SIZES, MeshShape, check_sharding

__all__ = [
    "AuditError",
    "AuditShape",
    "CHECK_FAMILIES",
    "Diagnostic",
    "E2E_FAMILIES",
    "KERNEL_HELPERS",
    "MeshShape",
    "PRODUCTION_MESH_SIZES",
    "SEVERITIES",
    "audit_arch",
    "audit_comm_regressor",
    "audit_predictor",
    "check_conservation",
    "check_coverage",
    "check_dryrun_artifacts",
    "check_ep_alltoall",
    "check_head_accounting",
    "check_kernel_resources",
    "check_sharding",
    "check_task_conservation",
    "json_report",
    "kernel_workloads",
    "render_report",
    "run_audit",
    "sort_diagnostics",
    "worst_severity",
]
