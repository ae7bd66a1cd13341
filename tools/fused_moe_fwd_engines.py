#!/usr/bin/env python3
"""fused_moe's two forward engines side by side on one NVIDIA card.

    python3 tools/fused_moe_fwd_engines.py [--src DIR] [--quick] [--iters N]

Builds the port's forward libraries from the sources under DIR (default:
this checkout's ``src``), logs ptxas's registers and spills of the wgmma
engine (``csrc/fused_moe_wgmma.cu``) and its SASS instruction counts, then
checks it against the plain version (``ref.fused_moe_ref``) and the
mma.sync engine on the same inputs: small and ragged shapes over several
(block_m, block_f) pairs, and dbrx-132b's width (E16, D6144, F10752) at
512 and 640 rows an expert (bf16 within 2e-2 of max|ref|, bit-equal on a
rerun). Without ``--quick`` it then times both engines at dbrx-132b's width
over rows an expert from a decode tick's 4 to training's 640, in turns
(wgmma, mma.sync, mma.sync, wgmma; CUDA events around ``--iters`` calls
each), the library's three ``bmm`` and silu-mul beside them, and each wgmma
launch under ``torch.profiler`` against its own bound; then both engines
in turns at 512 rows an expert with blocks of 128, 64, 32 and 8 rows
(``block_m``; a wgmma tile of 64 rows stores a smaller block's rows and
computes the rest for nothing). Prints the card's
name and power limit first. Exits non-zero on any mismatch. Needs a card;
the port's tests and ``chip_smoke.py`` are the full check.
"""
import argparse
import collections
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BF16_TOL = 2e-2
PEAK_BF16, HBM = 989e12, 3.35e12  # the H100 SXM's dense bf16 rate and memory rate


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent / "src"))
    ap.add_argument("--quick", action="store_true", help="build and check; no timing")
    ap.add_argument("--iters", type=int, default=6)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fused_moe_fwd_engines: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels._build import _nvcc, build_log, library_path
    from repro_torch.kernels.fused_moe import kernel as moe_k
    from repro_torch.kernels.fused_moe.ref import fused_moe_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(g) for g in (moe_k.library, moe_k.fwd_wgmma_library)]:
            f.result()
    print(f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    for line in build_log("fused_moe_wgmma", moe_k.FWD_WGMMA_SOURCES).splitlines():
        if any(w in line for w in ("Compiling entry", "spill", "Used", "arning")):
            print("  ptxas", line.strip()[:160], flush=True)
    so = library_path("fused_moe_wgmma", moe_k.FWD_WGMMA_SOURCES)
    sass = subprocess.run([str(Path(_nvcc()).parent / "cuobjdump"), "--dump-sass", str(so)],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    ops = collections.Counter(re.findall(r"\b(HGMMA|UTMALDG|UTMASTG|SYNCS)\b", sass))
    print(f"  SASS {dict(sorted(ops.items()))}", flush=True)

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(0)

    def randn(shape, scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(
            dev, bf16)

    def inputs(E, C, D, F):
        return (randn((E, C, D), 1.0), randn((E, D, F), D ** -0.5), randn((E, D, F), D ** -0.5),
                randn((E, F, D), F ** -0.5))

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())

    ok = True
    # (E, C, D, F, block_m, block_f): ragged C, D, F and block edges, each knob pair
    cases = [(2, 64, 64, 128, 64, 256), (2, 128, 64, 128, 128, 256), (3, 200, 520, 776, 200, 776),
             (3, 8, 264, 512, 128, 256), (16, 4, 6144, 10752, 128, 256),
             (3, 200, 520, 776, 100, 776), (2, 192, 136, 264, 64, 88), (1, 512, 256, 512, 512, 512),
             (2, 384, 200, 328, 192, 8), (4, 256, 256, 512, 128, 64), (2, 128, 264, 520, 64, 520),
             (4, 256, 256, 512, 32, 64), (2, 200, 136, 264, 8, 88),
             (16, 512, 6144, 10752, 128, 256), (16, 640, 6144, 10752, 128, 256)]
    for E, C, D, F, bm, bf in cases:
        args_ = inputs(E, C, D, F)
        assert moe_k.fwd_engine(bf16, C, D, F, block_f=bf) == "wgmma", (C, D, F, bm, bf)
        w0, n0 = moe_k.wgmma_launches, moe_k.launches
        got = moe_k.fused_moe_cuda(*args_, block_m=bm, block_f=bf)
        again = moe_k.fused_moe_wgmma_cuda(*args_, block_m=bm, block_f=bf)
        old = moe_k.fused_moe_mma_sync_cuda(*args_, block_m=bm, block_f=bf)
        torch.cuda.synchronize()
        counted = (moe_k.wgmma_launches - w0, moe_k.launches - n0) == (2, 1)
        want = fused_moe_ref(*args_)
        e_ref, e_old = rel(got, want), rel(got, old)
        same = torch.equal(got, again)
        good = e_ref <= BF16_TOL and e_old <= BF16_TOL and same and counted
        ok &= good
        print(f"  E{E} C{C} D{D} F{F} bm{bm} bf{bf}: of max|ref| {e_ref:.2e} against the plain "
              f"version, {e_old:.2e} against mma.sync; rerun bit-equal {same}; counts {counted}"
              f"{'' if good else '  MISMATCH'}", flush=True)
        del args_, got, again, old, want
    torch.cuda.empty_cache()
    if args.quick or not ok:
        print("ok" if ok else "FAILED", flush=True)
        return 0 if ok else 1

    E, D, F = 16, 6144, 10752
    w = inputs(E, 1, D, F)[1:]

    def timed(fn, a, iters):
        fn(*a)
        torch.cuda.synchronize()
        s, t = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn(*a)
        t.record()
        torch.cuda.synchronize()
        return s.elapsed_time(t) / iters

    def library(x, wg, wu, wd):
        return torch.bmm(torch.nn.functional.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd)

    for C in (4, 8, 32, 64, 96, 128, 256, 512, 640):
        x = randn((E, C, D), 1.0)
        a = (x, *w)
        flops = 3 * 2 * E * C * D * F
        nbytes = 2 * (3 * E * D * F + 2 * E * C * D)
        bound = max(flops / PEAK_BF16, nbytes / HBM) * 1e3
        runs = {"wgmma": [], "mma_sync": []}
        for eng in ("wgmma", "mma_sync", "mma_sync", "wgmma"):
            fn = moe_k.fused_moe_wgmma_cuda if eng == "wgmma" else moe_k.fused_moe_mma_sync_cuda
            runs[eng].append(timed(fn, a, args.iters))
        lib = timed(library, a, args.iters)
        fmt = {k: "/".join(f"{v:.4f}" for v in vs) or "n/a" for k, vs in runs.items()}
        print(f"  dbrx E16 C{C} bf16: wgmma {fmt['wgmma']} ms, mma.sync {fmt['mma_sync']} ms, "
              f"library {lib:.4f} ms, bound {bound:.4f} ms "
              f"({'operations' if flops / PEAK_BF16 > nbytes / HBM else 'bytes'}); engine "
              f"{moe_k.fwd_engine(bf16, C, D, F)}", flush=True)
        if C in (512, 640):
            moe_k.fused_moe_wgmma_cuda(*a)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
                moe_k.fused_moe_wgmma_cuda(*a)
                torch.cuda.synchronize()
            times = {e.key: e.device_time_total / 1e3 for e in p.key_averages()
                     if "moe_fwd_wgmma" in e.key and e.device_time_total > 0}
            for key, ms in sorted(times.items()):
                epi = re.search(r"moe_fwd_wgmma(?:<\d+, (\d+)>|ILi\d+ELi(\d+)E)", key)
                which = "gate_up" if epi and "1" in epi.groups() else "down"
                fl = (2 if which == "gate_up" else 1) * 2 * E * C * D * F
                by = 2 * ((2 * E * D * F + E * C * D + E * C * F) if which == "gate_up"
                          else (E * D * F + E * C * F + E * C * D))
                b = max(fl / PEAK_BF16, by / HBM) * 1e3
                print(f"    launch {key[:60]}: {ms:.4f} ms, bound {b:.4f} ms ({b / ms:.2f})",
                      flush=True)
        del x, a
    a = (randn((E, 512, D), 1.0), *w)
    for bm in (128, 64, 32, 8):
        runs = {"wgmma": [], "mma_sync": []}
        for eng in ("wgmma", "mma_sync", "mma_sync", "wgmma"):
            fn = moe_k.fused_moe_wgmma_cuda if eng == "wgmma" else moe_k.fused_moe_mma_sync_cuda
            runs[eng].append(timed(lambda *t: fn(*t, block_m=bm), a, max(2, args.iters // 2)))
        fmt = {k: "/".join(f"{v:.4f}" for v in vs) for k, vs in runs.items()}
        print(f"  dbrx E16 C512 bf16 block_m {bm}: wgmma {fmt['wgmma']} ms, "
              f"mma.sync {fmt['mma_sync']} ms", flush=True)
    print("ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
