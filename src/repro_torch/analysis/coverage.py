"""Predictor-coverage lint (SP4xx), ported from ``repro.analysis.coverage``:
every call kind the workload generator can emit must be priceable *before*
a sweep or a serving run starts.

Two modes share the diagnostics:

* **static** (:func:`check_coverage`) — the kernel families and comm ops a
  request stream emits must be inside the decomposer vocabulary
  (``DECOMPOSERS``) and the comm-regressor vocabulary
  (``CommRegressor.OPS``). Registry-wide, device-free, runs in CI.
* **instance** (:func:`audit_predictor`) — a *configured* backend must
  cover the vocabulary: a ``CommRegressor`` fitted before an op joined
  ``OPS`` (the stale-regressor class ``FleetRouter`` used to discover
  mid-sweep, one warning per hardware) and kernel families missing from a
  trained estimator under ``fallback="error"`` become pre-flight errors.
  The ``audit=`` hooks on ``FleetRouter`` and ``ContinuousBatchingEngine``
  call this at construction and raise
  :class:`~repro_torch.analysis.AuditError`.
"""
from __future__ import annotations

from typing import Any, Iterable, List, Optional, Set

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.configs.base import ArchConfig
from repro_torch.core.decomposer import DECOMPOSERS
from repro_torch.predict.api import CommCall, KernelCall, flatten_calls
from repro_torch.predict.comm import CommRegressor


#: kernel families the e2e workload generator emits (``scaled_mm`` only
#: appears in explicitly quantized traces, so predictor-instance audits
#: default to this set; pass ``required_families=DECOMPOSERS`` to demand
#: the full vocabulary)
E2E_FAMILIES = ("gemm", "attention", "rmsnorm", "silu_mul", "fused_moe")


def emitted_vocab(calls: Iterable) -> tuple:
    """``(kernel kinds, comm ops)`` a (possibly nested) call stream emits."""
    kinds: Set[str] = set()
    ops: Set[str] = set()
    for call, _w in flatten_calls(calls):
        if isinstance(call, KernelCall):
            kinds.add(call.kind)
        elif isinstance(call, CommCall):
            ops.add(call.op)
    return kinds, ops


def check_coverage(
    cfg: ArchConfig,
    *,
    B: int = 2,
    lin: int = 512,
    lout: int = 64,
    tp: int = 16,
    pp: int = 2,
    calls: Optional[list] = None,
) -> List[Diagnostic]:
    """SP401/SP402 statically: the request stream of one arch (with TP and
    PP engaged so collective emission paths are exercised) against the
    decomposer and comm vocabularies."""
    from repro_torch.core.e2e import request_calls

    if calls is None:
        calls = request_calls(cfg, B, lin, lout, tp=tp, pp=pp)
    kinds, ops = emitted_vocab(calls)
    diags: List[Diagnostic] = []
    for kind in sorted(kinds - set(DECOMPOSERS)):
        diags.append(
            Diagnostic(
                code="SP402",
                severity="error",
                check="coverage",
                message=(
                    f"workload emits kernel family {kind!r} with no decomposer "
                    f"(known: {sorted(DECOMPOSERS)}) — no backend can price it"
                ),
                arch=cfg.name,
                where="core/e2e:request_calls",
                data={"kind": kind},
            )
        )
    for op in sorted(ops - set(CommRegressor.OPS)):
        diags.append(
            Diagnostic(
                code="SP401",
                severity="error",
                check="coverage",
                message=(
                    f"workload emits comm op {op!r} outside CommRegressor.OPS "
                    f"{list(CommRegressor.OPS)} — no fitted regressor can price it"
                ),
                arch=cfg.name,
                where="core/e2e:request_calls",
                data={"op": op},
            )
        )
    return diags


def audit_comm_regressor(
    comm: Optional[CommRegressor],
    *,
    required_ops: Optional[Iterable[str]] = None,
    hw_name: str = "",
) -> List[Diagnostic]:
    """SP401 against a comm-regressor *instance*: a regressor fitted before
    an op joined ``CommRegressor.OPS`` (or never fitted at all) cannot
    price that op — the stale-regressor class. ``comm=None`` passes
    vacuously (the backend auto-fits the full vocabulary on first use)."""
    if comm is None:
        return []
    required = set(required_ops if required_ops is not None else CommRegressor.OPS)
    missing = sorted(required - set(comm.fitted_ops()))
    if not missing:
        return []
    suffix = f" for {hw_name}" if hw_name else ""
    return [
        Diagnostic(
            code="SP401",
            severity="error",
            check="coverage",
            message=(
                f"CommRegressor{suffix} has no coefficients for comm op(s) "
                f"{missing} (fitted: {comm.fitted_ops() or 'none'}) — refit "
                f"with fit(hw) before routing/admission"
            ),
            where="predict/comm:CommRegressor",
            data={"missing_ops": missing, "fitted_ops": comm.fitted_ops(), "hw": hw_name},
        )
    ]


def audit_predictor(
    predictor: Any,
    *,
    required_families: Optional[Iterable[str]] = None,
    required_ops: Optional[Iterable[str]] = None,
    hw_name: str = "",
) -> List[Diagnostic]:
    """SP401/SP402 against a configured backend instance: missing comm-op
    coefficients and untrained kernel families surface *now*, not as a
    skip warning in the middle of a fleet sweep or as an admission
    fallback mid-replay."""
    name = hw_name or getattr(getattr(predictor, "hw", None), "name", "")
    diags = audit_comm_regressor(
        getattr(predictor, "_comm", None), required_ops=required_ops, hw_name=name
    )
    families = predictor.families() if hasattr(predictor, "families") else None
    if families is not None:
        required = set(
            required_families if required_families is not None else E2E_FAMILIES
        )
        missing = sorted(required - set(families))
        if missing:
            fallback = getattr(predictor, "fallback", "error")
            severity = "error" if fallback == "error" else "warning"
            suffix = f" for {name}" if name else ""
            diags.append(
                Diagnostic(
                    code="SP402",
                    severity=severity,
                    check="coverage",
                    message=(
                        f"predictor {getattr(predictor, 'name', type(predictor).__name__)!r}"
                        f"{suffix} has no model for kernel family(ies) {missing} "
                        + (
                            "and fallback='error' — prediction would raise"
                            if fallback == "error"
                            else f"(explicit fallback={fallback!r} substitutes)"
                        )
                    ),
                    where="predict/backends",
                    data={"missing_families": missing, "fallback": fallback, "hw": name},
                )
            )
    return diags
