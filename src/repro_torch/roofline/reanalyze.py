"""Re-count cached dry-run artifacts and refresh the dry-run JSONs in place
(``repro.roofline.reanalyze``): iterating on the cost model without lowering
the cells again.

A JSON beside ``hlo/<tag>.hlo.zst`` (the reference's optimized HLO) is
re-walked with ``roofline.hlo_cost``; one beside ``hlo/<tag>.ops.zst`` or
``.ops.gz`` (the port's op ledger, ``launch.dryrun.write_ledger``) is
re-counted with the op counter's rules
(``roofline.op_cost.analyze_ledger``).

  PYTHONPATH=src python -m repro_torch.roofline.reanalyze [--dir results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import read_ledger
from repro_torch.roofline.hlo_cost import analyze_hlo
from repro_torch.roofline.op_cost import analyze_ledger


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    for jpath in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        tag = os.path.basename(jpath)[: -len(".json")]
        hpath = os.path.join(args.dir, "hlo", tag + ".hlo.zst")
        opaths = [p for p in (os.path.join(args.dir, "hlo", tag + ".ops" + ext)
                              for ext in (".zst", ".gz")) if os.path.exists(p)]
        if os.path.exists(hpath):
            import zstandard

            with open(hpath, "rb") as f:
                walk = analyze_hlo(zstandard.decompress(f.read()).decode())
        elif opaths:
            walk = analyze_ledger(read_ledger(opaths[0]))
        else:
            print(f"[skip] no HLO or op ledger for {tag}")
            continue
        with open(jpath, encoding="utf-8") as f:
            d = json.load(f)
        d["flops"] = walk.flops
        d["dot_flops"] = walk.dot_flops
        d["vector_ops"] = walk.vector_ops
        d["transcendentals"] = walk.transcendentals
        d["hbm_bytes"] = walk.hbm_bytes
        d["collectives"] = {**walk.collectives, "_total_bytes": walk.collective_bytes}
        d["unknown_ops"] = walk.unknown_ops
        with open(jpath, "w", encoding="utf-8") as f:
            json.dump(d, f, indent=2, default=str)
        print(f"[ok] {tag}: flops={walk.flops:.3e} hbm={walk.hbm_bytes:.3e} "
              f"coll={walk.collective_bytes:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
