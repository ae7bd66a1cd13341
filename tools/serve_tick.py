"""Median decode tick of full-width, full-depth qwen3-0.6b served without a
mesh, on the card: the meshless serving runs of ``chip_smoke.py``'s phase 4
(8 prompts of 512-2048 tokens through ``ServeEngine(max_batch=4)``, the next
8 through ``ContinuousBatchingEngine(slots=4, max_len=4096)``, 32 new tokens
each) and phase 12 (a) (prompts of 300, 517, 256 and 129 tokens, 12 new
tokens, through both engines at ``max_len=1024``), each run ``--repeats``
times on the same random weights (seed 0).

  python3 tools/serve_tick.py [--src DIR] [--repeats 3] [--label NAME]
      [--only phase4_serve ...] [--preload torch.distributed.tensor ...]
      [--cprofile 40]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that two trees can be timed in turns on one card, as
in ``python3 tools/serve_tick.py --src /path/to/other/src``. It prints one
line a run and, last, one JSON object with each workload's ticks (ms).
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent / "src"))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--label", default="")
    ap.add_argument("--preload", action="append", default=[],
                    help="a module to import before the runs (repeatable)")
    ap.add_argument("--only", action="append", default=[],
                    help="run only this workload (repeatable; default: all four)")
    ap.add_argument("--cprofile", type=int, default=0,
                    help="profile the last repeat's host code with cProfile and print "
                         "its N functions of most own time")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("serve_tick: this needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py serves
    sys.path.insert(0, str(Path(args.src).resolve()))
    import importlib

    for name in args.preload:
        importlib.import_module(name)
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request, ServeEngine
    from repro_torch.serve.trace import TraceRecorder

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    smi = smi.strip().splitlines()[0]
    cfg = get_arch("qwen3-0.6b")
    params = build_model(cfg, "cuda").init(SEED)
    rng = np.random.default_rng(SEED)
    lens = rng.integers(512, 2049, 16)
    p4 = [rng.integers(1, cfg.vocab_size, int(L)) for L in lens]
    rng = np.random.default_rng(SEED + 12)
    p12 = [rng.integers(1, cfg.vocab_size, int(L)) for L in (300, 517, 256, 129)]
    workloads = {
        "phase4_serve": (lambda: ServeEngine(cfg, params=params, max_batch=4,
                                             recorder=TraceRecorder(), device="cuda"),
                         p4[:8], 32),
        "phase4_continuous": (lambda: ContinuousBatchingEngine(
            cfg, params=params, slots=4, max_len=4096, recorder=TraceRecorder(), device="cuda"),
            p4[8:], 32),
        "phase12_serve": (lambda: ServeEngine(cfg, params=params, max_batch=4,
                                              recorder=TraceRecorder(), device="cuda"),
                          p12, 12),
        "phase12_continuous": (lambda: ContinuousBatchingEngine(
            cfg, params=params, slots=4, max_len=1024, recorder=TraceRecorder(),
            device="cuda"), p12, 12),
    }
    workloads = {k: v for k, v in workloads.items() if not args.only or k in args.only}
    ticks = {k: [] for k in workloads}
    t0 = time.perf_counter()
    import cProfile
    import pstats

    prof = cProfile.Profile()
    for rep in range(args.repeats):
        if args.cprofile and rep == args.repeats - 1:
            prof.enable()
        for name, (make, prompts, max_new) in workloads.items():
            eng = make()
            for i, p in enumerate(prompts):
                eng.submit(Request(rid=i, prompt=p, max_new=max_new))
            if isinstance(eng, ServeEngine):
                while eng.queue:
                    eng.step_batch()
            else:
                eng.run_to_completion()
            torch.cuda.synchronize()
            dec = [m.measured_s for m in eng.recorder.meta if m.phase == "decode"]
            tick = 1e3 * float(np.median(dec))
            ticks[name].append(tick)
            print(f"{args.label} repeat {rep} {name}: {len(dec)} decode steps, median tick "
                  f"{tick:.3f} ms", flush=True)
            del eng
    prof.disable()
    if args.cprofile:
        pstats.Stats(prof).sort_stats("tottime").print_stats(args.cprofile)
    print(f"{args.label} card: {smi}; {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"label": args.label, "card": smi, "ticks_ms": ticks,
                      "median_ms": {k: float(np.median(v)) for k, v in ticks.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
