"""Diagnostic model of the static auditor: stable codes, severities,
anchors, JSON rendering.

Every check in ``repro_torch.analysis`` returns a list of :class:`Diagnostic`.
Codes are *stable identifiers* — tests, CI gates and suppression lists key
on them, so a code is never renumbered or reused once shipped:

====== ========== ==============================================================
code   severity   meaning
====== ========== ==============================================================
SP101  error      EP all-to-all payload drifts from the dry-run byte ledger
SP102  error      decomposer task demands break the family's conservation law
SP103  error      LM-head GEMM token accounting is wrong (the PR 2 bug class)
SP104  error      LM-head all_gather payload disagrees with the head GEMM
SP105  info       dry-run artifact cross-check skipped (no cached ledgers)
SP201  error      kernel block choice overflows a registry device's VMEM
SP202  error      non-divisible tiling (the kernel would fail its assert)
SP203  error      degenerate Pallas grid (a zero/negative grid dimension)
SP204  error      compute/param dtype outside the priced dtype vocabulary
SP301  error      param/cache leaf name has no audited sharding rule
SP302  error      a resolved PartitionSpec consumes one mesh axis twice
SP303  error      a sharded dim is not divisible by its mesh axes
SP304  warning    large parameter left fully replicated on the mesh
SP401  error      workload emits a comm op the comm regressor cannot price
SP402  error      workload emits a kernel family no backend can price
====== ========== ==============================================================
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

SEVERITIES = ("error", "warning", "info")

#: rank for sorting / exit-code policy (lower = more severe)
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of the static auditor.

    ``code`` is the stable identifier (table above); ``check`` names the
    check family (``conservation`` / ``kernel-resource`` / ``sharding`` /
    ``coverage``); ``where`` anchors the finding (a ``module:function`` or
    a call/leaf description); ``arch`` is the registry architecture under
    audit (None for arch-independent findings); ``data`` carries the
    machine-readable expected/actual values."""

    code: str
    severity: str
    check: str
    message: str
    arch: Optional[str] = None
    where: Optional[str] = None
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {self.severity!r}"
            )

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v not in (None, {})}

    def render(self) -> str:
        loc = " @ ".join(x for x in (self.arch, self.where) if x)
        head = f"{self.code} [{self.severity}] {self.check}"
        return f"{head}: {self.message}" + (f"  ({loc})" if loc else "")


def sort_diagnostics(diags: List[Diagnostic]) -> List[Diagnostic]:
    """Severity-major ordering (errors first), then stable by code/arch."""
    return sorted(
        diags, key=lambda d: (_SEV_RANK[d.severity], d.code, d.arch or "", d.where or "")
    )


def worst_severity(diags: List[Diagnostic]) -> Optional[str]:
    ranks = [_SEV_RANK[d.severity] for d in diags]
    return SEVERITIES[min(ranks)] if ranks else None


def render_report(diags: List[Diagnostic]) -> str:
    """Human-readable report: one line per finding plus a severity tally."""
    ordered = sort_diagnostics(diags)
    lines = [d.render() for d in ordered]
    tally = {s: sum(1 for d in diags if d.severity == s) for s in SEVERITIES}
    lines.append(
        f"-- {len(diags)} finding(s): "
        + ", ".join(f"{n} {s}" for s, n in tally.items())
    )
    return "\n".join(lines)


def json_report(diags: List[Diagnostic]) -> str:
    return json.dumps([d.to_json() for d in sort_diagnostics(diags)], indent=2)


class AuditError(RuntimeError):
    """Raised by pre-flight ``audit=`` hooks (``FleetRouter``,
    ``ContinuousBatchingEngine``) when the auditor finds error-severity
    diagnostics at construction time — the diagnostic list rides on
    ``.diagnostics`` so callers can render or log it."""

    def __init__(self, diagnostics: List[Diagnostic]) -> None:
        self.diagnostics = sort_diagnostics(diagnostics)
        errors = [d for d in self.diagnostics if d.severity == "error"]
        super().__init__(
            f"pre-flight audit failed with {len(errors)} error(s):\n"
            + "\n".join(d.render() for d in self.diagnostics)
        )
