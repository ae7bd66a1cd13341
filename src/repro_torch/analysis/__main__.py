"""``python -m repro_torch.analysis`` — the static auditor CLI, ported from
``repro.analysis.__main__``.

Exit codes: 0 clean (or warnings/info only), 1 when any error-severity
diagnostic fires (``--strict`` also fails on warnings), 2 on usage errors.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.analysis.audit import CHECK_FAMILIES, AuditShape, run_audit
from repro_torch.analysis.diagnostics import json_report, render_report, sort_diagnostics
from repro_torch.configs import list_archs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static auditor: conservation, kernel-resource, sharding "
        "and predictor-coverage checks over registry architectures.",
    )
    target = p.add_mutually_exclusive_group(required=True)
    target.add_argument(
        "--arch",
        action="append",
        choices=list_archs(),
        help="audit one arch (repeatable)",
    )
    target.add_argument(
        "--all", action="store_true", help="audit every registry arch"
    )
    p.add_argument(
        "--check",
        action="append",
        choices=CHECK_FAMILIES,
        help="run only this check family (repeatable; default: all four)",
    )
    p.add_argument("--json", action="store_true", help="emit machine-readable JSON")
    p.add_argument(
        "--strict",
        action="store_true",
        help="treat warning-severity diagnostics as failures too",
    )
    p.add_argument("--batch", type=int, default=AuditShape.B, help="audit batch size")
    p.add_argument("--lin", type=int, default=AuditShape.lin, help="audit prefill length")
    p.add_argument("--lout", type=int, default=AuditShape.lout, help="audit decode length")
    p.add_argument("--tp", type=int, default=AuditShape.tp, help="audit tensor-parallel degree")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    shape = AuditShape(B=args.batch, lin=args.lin, lout=args.lout, tp=args.tp)
    diags = sort_diagnostics(
        run_audit(args.arch, shape=shape, checks=args.check)
    )
    if args.json:
        print(json_report(diags))
    else:
        print(render_report(diags))
    failing = {"error", "warning"} if args.strict else {"error"}
    return 1 if any(d.severity in failing for d in diags) else 0


if __name__ == "__main__":
    sys.exit(main())
