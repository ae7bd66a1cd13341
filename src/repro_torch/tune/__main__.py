"""``python -m repro_torch.tune --kernel fused_moe --hw tpu-v4`` — tune one
of the port's kernels and print (or save) the decision trail: candidate
count, SP2xx rejections, predicted ranking, timed top-k, realized speedup,
and the predicted-vs-measured rank correlation.

``--hw`` names the registry device whose predictions rank the candidates;
the times are always measured on this machine: on the card by default, or
the plain versions on the host with ``--device cpu``."""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

from repro_torch.core.hardware import REGISTRY
from repro_torch.predict.backends import PREDICTORS, get_predictor
from repro_torch.tune.space import DEFAULT_WORKLOADS, TUNABLE_KERNELS, arch_workload
from repro_torch.tune.tuner import TunedConfigs, TuneReport, tune


def report_lines(report: TuneReport) -> List[str]:
    """The decision trail of one :func:`tune` run, as the CLI prints it."""
    mode = "plain versions on the CPU" if report.interpret else "kernels on the card"
    lines = [
        f"[tune] {report.kernel} on {report.hw} ({mode}, ranked by {report.predictor})",
        f"  workload        {report.workload}",
        f"  candidates      {report.n_candidates} enumerated, "
        f"{report.n_rejected} rejected by SP2xx, "
        f"{len(report.survivors)} ranked, {len(report.measured)} measured",
    ]
    for c in report.measured:
        tag = " <- best" if c is report.best else ""
        lines.append(
            f"    {c.blocks}  predicted={c.predicted_s*1e3:8.3f}ms  "
            f"measured={(c.measured_s or 0.0)*1e3:8.3f}ms{tag}"
        )
    lines.append(f"  default {report.default_blocks}  measured={report.t_default*1e3:.3f}ms")
    lines.append(
        f"  best    {report.best.blocks}  speedup={report.speedup:.2f}x  "
        f"rank_correlation={report.rank_correlation:+.2f}"
    )
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="Predictor-guided autotuning of the port's kernels.",
    )
    ap.add_argument("--kernel", required=True, choices=sorted(TUNABLE_KERNELS))
    ap.add_argument("--hw", default="tpu-v4", choices=sorted(REGISTRY),
                    help="registry device the predictor prices (not where it runs)")
    ap.add_argument(
        "--predictor",
        default="roofline",
        choices=sorted(PREDICTORS),
        help="ranking backend (roofline needs no training; synperf needs a "
        "trained estimator in the bench cache)",
    )
    ap.add_argument("--top-k", type=int, default=4, help="candidates to measure")
    ap.add_argument("--repeats", type=int, default=3, help="timed runs per candidate")
    ap.add_argument(
        "--arch",
        default=None,
        help="derive the workload shape from a registry arch's prefill step "
        "instead of the CPU-scale default",
    )
    ap.add_argument(
        "--dim",
        action="append",
        default=[],
        metavar="NAME=INT",
        help="override a workload dimension (repeatable), e.g. --dim E=16",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="where the candidates are timed: the kernels on the card, or their "
        "plain versions on the host",
    )
    ap.add_argument("--json", default=None, help="write the report summary to this path")
    ap.add_argument(
        "--save", default=None, help="write/update a TunedConfigs table at this path"
    )
    args = ap.parse_args(argv)

    hw = REGISTRY[args.hw]
    workload = (
        arch_workload(args.kernel, args.arch)
        if args.arch
        else dict(DEFAULT_WORKLOADS[args.kernel])
    )
    for item in args.dim:
        name, _, val = item.partition("=")
        if name not in workload:
            ap.error(f"--dim {name!r} is not a dimension of {sorted(workload)}")
        workload[name] = int(val)

    predictor = get_predictor(args.predictor, hw)
    report = tune(
        args.kernel,
        hw,
        workload=workload,
        predictor=predictor,
        predictor_name=args.predictor,
        top_k=args.top_k,
        repeats=args.repeats,
        device=args.device,
    )

    s = report.summary()
    print("\n".join(report_lines(report)))

    if args.json:
        with open(args.json, "w") as f:
            json.dump(s, f, indent=2, sort_keys=True)
        print(f"  wrote {args.json}")
    if args.save:
        try:
            table = TunedConfigs.load(args.save)
        except FileNotFoundError:
            table = TunedConfigs()
        table.add_report(report)
        table.save(args.save)
        print(f"  wrote {args.save}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
