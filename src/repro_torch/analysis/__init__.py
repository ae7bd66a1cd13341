"""Static auditor, ported from ``repro.analysis``: the diagnostic model and
the kernel-resource lint (SP2xx) the tuner's prefilter runs. The
conservation, sharding and coverage families are still to port.
"""
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

__all__ = [
    "AuditError",
    "Diagnostic",
    "KERNEL_HELPERS",
    "SEVERITIES",
    "check_kernel_resources",
    "json_report",
    "kernel_workloads",
    "render_report",
    "sort_diagnostics",
    "worst_severity",
]
