"""Repo-wide audit orchestration, ported from ``repro.analysis.audit``: run
every check family over registry architectures and aggregate the
diagnostics.

This is what ``python -m repro_torch.analysis`` drives. Everything here is
static — the auditor never compiles, never allocates a parameter, never
touches a device (parameter trees are built on ``torch.device("meta")``;
meshes are shape-only stand-ins)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.conservation import check_conservation
from repro_torch.analysis.coverage import check_coverage
from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.kernels import check_kernel_resources
from repro_torch.analysis.sharding import check_sharding
from repro_torch.configs import get_arch, list_archs

#: check-family name -> callable(cfg, **shape_kw); the CLI's --check filter
CHECK_FAMILIES = ("conservation", "kernel-resource", "sharding", "coverage")


@dataclasses.dataclass(frozen=True)
class AuditShape:
    """The request shape the auditor lowers each arch at. Defaults pick a
    production-like point whose dims divide the default kernel blocks, so
    a clean repo audits clean."""

    B: int = 2
    lin: int = 512
    lout: int = 64
    tp: int = 16
    pp: int = 2


def audit_arch(
    arch: str,
    *,
    shape: Optional[AuditShape] = None,
    checks: Optional[Sequence[str]] = None,
    mesh_sizes: Optional[Dict[str, int]] = None,
) -> List[Diagnostic]:
    """Every selected check family for one registry arch."""
    shape = shape or AuditShape()
    selected = set(checks if checks is not None else CHECK_FAMILIES)
    unknown = selected - set(CHECK_FAMILIES)
    if unknown:
        raise ValueError(f"unknown check family(ies) {sorted(unknown)}; known: {CHECK_FAMILIES}")
    cfg = get_arch(arch)
    diags: List[Diagnostic] = []
    if "conservation" in selected:
        diags += check_conservation(
            cfg, B=shape.B, lin=shape.lin, lout=shape.lout, tp=shape.tp
        )
    if "kernel-resource" in selected:
        diags += check_kernel_resources(cfg, B=shape.B, lin=shape.lin)
    if "sharding" in selected:
        diags += check_sharding(cfg, mesh_sizes)
    if "coverage" in selected:
        diags += check_coverage(
            cfg, B=shape.B, lin=shape.lin, lout=shape.lout, tp=shape.tp, pp=shape.pp
        )
    return diags


def run_audit(
    archs: Optional[Sequence[str]] = None,
    *,
    shape: Optional[AuditShape] = None,
    checks: Optional[Sequence[str]] = None,
    mesh_sizes: Optional[Dict[str, int]] = None,
) -> List[Diagnostic]:
    """The repo-wide audit: every check family x every requested arch
    (default: the whole registry)."""
    out: List[Diagnostic] = []
    for arch in archs if archs is not None else list_archs():
        out += audit_arch(arch, shape=shape, checks=checks, mesh_sizes=mesh_sizes)
    return out
