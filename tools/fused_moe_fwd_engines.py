#!/usr/bin/env python3
"""fused_moe's forward engines side by side on one NVIDIA card.

    python3 tools/fused_moe_fwd_engines.py [--src DIR] [--quick] [--iters N] [--f32]

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

With ``--f32`` it does the same for the f32 engines instead, with
``chip_smoke.py``'s own helpers: the 3xTF32 wgmma engine
(``csrc/fused_moe_tf32.cu``: ptxas's notes, SASS) against the plain version
run in float64 (within 1e-5 of max|ref|) and the mma.sync engine (within
f32 2e-5) on small, ragged and full-width shapes over several knob pairs,
bit-equal on a rerun, its count moving by one a call; then (without
``--quick``) both engines in turns at the tuner's f32 workload (E16 C256
D6144 F10752) and at dbrx-132b's training rows (E16 C640), CUDA-graph
replay (``cuda_ms``), beside the library's three ``bmm`` and silu-mul and
the 3xTF32 bound, and each 3xTF32 launch under the profiler.
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
    ap.add_argument("--f32", action="store_true", help="the f32 engines (3xTF32 wgmma, mma.sync)")
    args = ap.parse_args()
    if args.f32:
        return f32_engines(args)
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


def f32_engines(args) -> int:
    """``--f32``: the 3xTF32 wgmma engine against float64 and mma.sync, then
    both in turns beside the library (the module's head says how)."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fused_moe_fwd_engines: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    from repro_torch.kernels._build import build_log
    from repro_torch.kernels.fused_moe import kernel as moe_k
    from repro_torch.kernels.fused_moe.ref import fused_moe_ref
    from repro_torch.roofline.analysis import card_peaks

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(g) for g in (moe_k.library, moe_k.fwd_tf32_library)]:
            f.result()
    print(f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    ok = not any(cs.serialization_notes("fused_moe_tf32", moe_k.FWD_TF32_SOURCES).values())
    for line in build_log("fused_moe_tf32", moe_k.FWD_TF32_SOURCES).splitlines():
        if any(w in line for w in ("Compiling entry", "spill", "Used")):
            print("  ptxas", line.strip()[:160], flush=True)
    cs.wgmma_sass("fused_moe_tf32", moe_k.FWD_TF32_SOURCES, ("HGMMA", "UTMALDG", "SYNCS"))
    dev, f32 = torch.device("cuda"), torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(E, C, D, F):
        return tuple(s * torch.randn(shape, generator=gen, device=dev, dtype=f32) for shape, s in
                     (((E, C, D), 1.0), ((E, D, F), D ** -0.5), ((E, D, F), D ** -0.5),
                      ((E, F, D), F ** -0.5)))

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()) / float(b.double().abs().max())

    # (E, C, D, F, block_m, block_f): ragged C, D and F (C 1, 20, 65: rows
    # padded to 4), blocks of one tile, several and under one, one expert,
    # the tuner's default workload, dbrx-132b's widths at 256 and 640 rows
    cases = [(2, 64, 48, 96, 64, 96), (3, 20, 36, 44, 20, 44), (3, 200, 520, 776, 200, 776),
             (3, 200, 520, 776, 100, 776), (1, 1, 8, 8, 128, 256), (2, 65, 40, 48, 65, 48),
             (4, 256, 264, 512, 32, 64), (2, 384, 100, 96, 192, 32),
             (8, 512, 256, 512, 128, 256), (8, 512, 256, 512, 512, 32),
             (16, 256, 6144, 10752, 128, 256), (16, 256, 6144, 10752, 32, 512),
             (16, 640, 6144, 10752, 128, 256)]
    for E, C, D, F, bm, bf in cases:
        a = inputs(E, C, D, F)
        assert moe_k.fwd_engine(f32, C, D, F, block_f=bf) == "wgmma_tf32", (C, D, F, bf)
        t0, n0 = moe_k.tf32_launches, moe_k.launches
        got = moe_k.fused_moe_cuda(*a, block_m=bm, block_f=bf)
        again = moe_k.fused_moe_tf32_cuda(*a, block_m=bm, block_f=bf)
        counted = (moe_k.tf32_launches - t0, moe_k.launches - n0) == (2, 0)
        old = moe_k.fused_moe_mma_sync_cuda(*a, block_m=bm, block_f=bf)
        want = fused_moe_ref(*(t.double() for t in a))
        torch.cuda.synchronize()
        e64, eold = rel(got, want), rel(got, old)
        same = torch.equal(got, again)
        good = e64 <= 1e-5 and eold <= cs.F32_TOL and same and counted
        ok &= good
        print(f"  E{E} C{C} D{D} F{F} bm{bm} bf{bf}: of max|float64 ref| {e64:.2e}, against "
              f"mma.sync {eold:.2e}, mma.sync against float64 {rel(old, want):.2e}; rerun "
              f"bit-equal {same}; counts {counted}{'' if good else '  MISMATCH'}", flush=True)
        del a, got, again, old, want
        torch.cuda.empty_cache()
    if args.quick or not ok:
        print("ok" if ok else "FAILED", flush=True)
        return 0 if ok else 1

    peaks = card_peaks(torch.cuda.get_device_name(0))
    D, F = 6144, 10752
    for E, C in ((16, 256), (16, 640)):
        a = inputs(E, C, D, F)
        flops = 6 * E * C * D * F
        bound_ms, bound_by = cs.bound(peaks, 4 * (2 * E * C * D + 3 * E * D * F), 3 * flops,
                                      "tf32")
        runs = {"tf32": [], "mma_sync": []}
        for eng in ("tf32", "mma_sync", "mma_sync", "tf32"):
            fn = getattr(moe_k, f"fused_moe_{eng}_cuda")
            runs[eng].append(cs.cuda_ms(torch, fn, [a], args.iters)[0])
        lib = cs.cuda_ms(torch, cs.moe_library, [a], args.iters)[0]
        fmt = {k: "/".join(f"{v:.4f}" for v in vs) for k, vs in runs.items()}
        mean = float(np.mean(runs["tf32"]))
        print(f"  E{E} C{C} D{D} F{F} f32: tf32 {fmt['tf32']} ms, mma.sync {fmt['mma_sync']} "
              f"ms ({float(np.mean(runs['mma_sync'])) / mean:.2f}x), library {lib:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}, 3xTF32), {bound_ms / mean:.4f} of it",
              flush=True)
        cs.tf32_fwd_launch_times(torch, moe_k, peaks, a)
        del a
        torch.cuda.empty_cache()
    print("ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
