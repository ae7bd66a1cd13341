"""Emit the dry-run and roofline tables from dry-run JSONs
(``repro.roofline.report``), under one device's peaks (default: one H100
SXM, ``roofline.analysis.H100_SXM``). The CLI adds notes on what the
port's counts hold beyond a production program (:func:`notes`).

  PYTHONPATH=src python -m repro_torch.roofline.report --dir results/dryrun_torch \
      [--baseline DIR] > tables.md
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import get_arch
from repro_torch.roofline.analysis import (
    H100_SXM,
    Peaks,
    load_rows,
    markdown_table,
    pick_hillclimb_cells,
)


def dryrun_table(rows) -> str:
    hdr = (
        "| arch | shape | mesh | HLO TFLOP/dev | HBM GB/dev | coll GB/dev | "
        "collective mix | compile s |\n|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for d in rows:
        mix = d["collectives"]
        parts = [
            f"{k.split('-')[1][:3] if '-' in k else k}:{v['bytes']/1e9:.1f}G"
            for k, v in mix.items()
            if isinstance(v, dict) and v.get("bytes", 0) > 1e8
        ]
        lines.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
            f"{d['flops']/1e12:.2f} | {d['hbm_bytes']/1e9:.1f} | "
            f"{mix['_total_bytes']/1e9:.2f} | {' '.join(parts) or '-'} | "
            f"{d['compile_s']} |"
        )
    return hdr + "\n".join(lines)


def report(dryrun_dir: str, baseline=None, section: str = "all", peaks: Peaks = H100_SXM) -> str:
    """The report's text for the JSONs in ``dryrun_dir`` under ``peaks``."""
    raw = []
    for p in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(p, encoding="utf-8") as f:
            raw.append(json.load(f))
    rows = load_rows(dryrun_dir, peaks)
    out = []

    if section in ("all", "dryrun"):
        out.append("### §Dry-run — compiled artifacts (per-device, SPMD-partitioned)\n")
        out.append(dryrun_table(raw))
        out.append("")
    if section in ("all", "roofline"):
        out.append("### §Roofline — three-term analysis\n")
        out.append(f"Constants: {peaks.flops/1e12:.0f} TFLOP/s bf16/chip, "
                   f"{peaks.hbm_bw/1e9:.0f} GB/s HBM, {peaks.link_bw/1e9:.0f} GB/s/link "
                   f"{peaks.link}.\n")
        out.append(markdown_table(rows))
        out.append("")
        picks = pick_hillclimb_cells(rows)
        out.append("Hillclimb picks:")
        for why, r in picks.items():
            out.append(f"- **{why}**: {r.arch}/{r.shape}/{r.mesh} "
                       f"(dominant={r.dominant}, bound={r.bound_s:.2f}s)")
        out.append("")
    if baseline and section in ("all", "compare"):
        base_rows = {(r.arch, r.shape, r.mesh): r for r in load_rows(baseline, peaks)}
        out.append("### §Perf — baseline vs optimized (paper-faithful -> beyond-paper)\n")
        out.append("| cell | term | baseline (s) | optimized (s) | delta |\n|---|---|---|---|---|")
        for r in rows:
            b = base_rows.get((r.arch, r.shape, r.mesh))
            if b is None:
                continue
            for term in ("compute", "memory", "collective"):
                bv = getattr(b, f"{term}_s")
                ov = getattr(r, f"{term}_s")
                if max(bv, ov) < 1e-4:
                    continue
                delta = (bv - ov) / max(bv, 1e-30) * 100
                mark = "**" if abs(delta) > 5 else ""
                out.append(f"| {r.arch}/{r.shape}/{r.mesh} | {term} | {bv:.3e} | "
                           f"{ov:.3e} | {mark}{delta:+.1f}%{mark} |")
    return "\n".join(out) + "\n"


def notes(dryrun_dir: str) -> str:
    """What the port's counts of the JSONs in ``dryrun_dir`` hold beyond
    the program a production run would lower: every cell's memory term is
    the eager plain program's, unfused; and a cell whose query or KV heads
    the mesh's ``model`` axis does not divide runs its attention replicated
    over that axis (``dist.sharding.unflatten`` gathers the heads first),
    so its attention products are in every rank's compute term and the
    gathers in its collective term."""
    out = ["Notes on the port's counts:",
           "- every memory term is the eager plain program's HBM traffic, unfused"]
    for p in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(p, encoding="utf-8") as f:
            d = json.load(f)
        cfg = get_arch(d["arch"])
        model = int(d["mesh"].removesuffix("pp").split("x")[-1])
        heads = [n for n in (cfg.n_heads, cfg.n_kv_heads) if n]
        if cfg.family != "ssm" and any(n % model for n in heads):
            out.append(f"- {d['arch']}/{d['shape']}/{d['mesh']}: {cfg.n_heads} query and "
                       f"{cfg.n_kv_heads} KV heads over a {model}-way model axis: attention "
                       f"replicated over it")
    return "\n".join(out) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--section", default="all", choices=("all", "dryrun", "roofline", "compare"))
    args = ap.parse_args(argv)
    print(report(args.dir, args.baseline, args.section), end="")
    print(notes(args.dir), end="")


if __name__ == "__main__":
    main()
