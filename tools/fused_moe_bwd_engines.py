#!/usr/bin/env python3
"""fused_moe's f32 backward on its two engines side by side on one NVIDIA card.

    python3 tools/fused_moe_bwd_engines.py [--src DIR] [--quick] [--iters N]

Builds the 3xTF32 wgmma engine (``csrc/fused_moe_bwd_tf32.cu``) and the
mma.sync engine (``csrc/fused_moe_bwd.cu``) from the sources under DIR
(default: this checkout's ``src``), so that a variant copy of the sources
can be checked and timed, with ``chip_smoke.py``'s own helpers: ptxas's
notes (``serialization_notes``) and the SASS instruction counts
(``wgmma_sass``) of the new engine, then each gradient on small, ragged
and full-width f32 shapes against ``ref.fused_moe_bwd_ref`` run in float64
and against the mma.sync engine on the same inputs (within f32 2e-5 of
max|ref|), bit-equal on a rerun, its count moving by one a call. Without
``--quick`` it then times both engines at the tuner's f32 workload (E16
C256 D6144 F10752) and at dbrx-132b's training rows (E16 C640) in turns
(tf32, mma.sync, mma.sync, tf32; ``cuda_ms``: ``--iters`` calls replayed
from one CUDA graph), beside the library's backward (``library_bwd_ms`` of
``moe_library``) and the 3xTF32 bound (``bound`` at the card's TF32 peak),
while ``nvidia-smi`` samples the SM clock and the power draw every 100 ms,
and each of the new engine's launches under the profiler
(``tf32_launch_times``). Prints the card's name and power limit first.
Exits non-zero on any mismatch. Needs a card; the port's tests and
``chip_smoke.py`` are the full check.
"""
import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--quick", action="store_true", help="build and check; no timing")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fused_moe_bwd_engines: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.fused_moe import kernel as moe_k
    from repro_torch.kernels.fused_moe.ref import fused_moe_bwd_ref
    from repro_torch.roofline.analysis import card_peaks

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    moe_k.tf32_library()
    moe_k.bwd_library()
    ok = not any(cs.serialization_notes("fused_moe_bwd_tf32", moe_k.TF32_SOURCES).values())
    cs.wgmma_sass("fused_moe_bwd_tf32", moe_k.TF32_SOURCES, ("HGMMA", "UTMALDG", "SYNCS"))

    dev, f32 = torch.device("cuda"), torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(E, C, D, F):
        return tuple(s * torch.randn(shape, generator=gen, device=dev, dtype=f32) for shape, s in
                     (((E, C, D), 1.0), ((E, D, F), D ** -0.5), ((E, D, F), D ** -0.5),
                      ((E, F, D), F ** -0.5), ((E, C, D), 1.0)))

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()) / float(b.double().abs().max())

    # ragged M, N and K; C = 1, 20 and 40 (rows padded to 4 values); one expert;
    # arctic-480b's and dbrx-132b's widths (K = 6144 and 2F = 21504)
    for E, C, D, F in [(2, 64, 48, 96), (3, 20, 36, 44), (3, 200, 520, 776), (1, 1, 8, 8),
                       (2, 40, 7168, 4864), (4, 129, 136, 264), (2, 640, 6144, 10752)]:
        a = inputs(E, C, D, F)
        assert moe_k.bwd_engine(f32, D, F) == "wgmma_tf32", (D, F)
        t0, b0 = moe_k.bwd_tf32_launches, moe_k.bwd_launches
        got = moe_k.fused_moe_bwd_cuda(*a)
        again = moe_k.fused_moe_bwd_tf32_cuda(*a)
        counted = (moe_k.bwd_tf32_launches - t0, moe_k.bwd_launches - b0) == (2, 0)
        old = moe_k.fused_moe_bwd_mma_sync_cuda(*a)
        want = fused_moe_bwd_ref(*(t.double() for t in a))
        torch.cuda.synchronize()
        e64 = [rel(g, w) for g, w in zip(got, want)]
        eold = [rel(g, o) for g, o in zip(got, old)]
        same = all(torch.equal(g, h) for g, h in zip(got, again))
        good = max(e64) <= cs.F32_TOL and max(eold) <= cs.F32_TOL and same and counted
        ok &= good
        print(f"  E{E} C{C} D{D} F{F}: of max|float64 ref| "
              + ", ".join(f"{n} {e:.2e}" for n, e in zip(("dx", "dw_gate", "dw_up", "dw_down"),
                                                         e64))
              + "; against mma.sync " + ", ".join(f"{e:.2e}" for e in eold)
              + f"; mma.sync against float64 {max(rel(o, w) for o, w in zip(old, want)):.2e}"
              + f"; rerun bit-equal {same}; counts {counted}{'' if good else '  MISMATCH'}",
              flush=True)
        del a, got, again, old, want
        torch.cuda.empty_cache()
    if args.quick or not ok:
        print("ok" if ok else "FAILED", flush=True)
        return 0 if ok else 1

    peaks = card_peaks(torch.cuda.get_device_name(0))
    D, F = 6144, 10752
    for E, C in ((16, 256), (16, 640)):
        a = inputs(E, C, D, F)
        flops = 16 * E * C * D * F
        bound_ms, bound_by = cs.bound(peaks, 4 * (3 * E * C * D + 6 * E * D * F), 3 * flops,
                                      "tf32")
        runs = {"tf32": [], "mma_sync": []}
        smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader,nounits", "-lms", "100"],
                               stdout=subprocess.PIPE, text=True)
        try:
            for eng in ("tf32", "mma_sync", "mma_sync", "tf32"):
                fn = getattr(moe_k, f"fused_moe_bwd_{eng}_cuda")
                runs[eng].append(cs.cuda_ms(torch, fn, [a], args.iters)[0])
        finally:
            smi.terminate()
            lines = smi.communicate(timeout=30)[0].splitlines()
        vals = [[float(v) for v in ln.split(",")] for ln in lines if ln.count(",") == 1]
        clocks, power = [v[0] for v in vals], [v[1] for v in vals]
        if clocks:
            print(f"    through the turns: SM clock median {np.median(clocks):.0f} MHz (min "
                  f"{min(clocks):.0f}, max {max(clocks):.0f}), power max {max(power):.1f} W, "
                  f"{len(clocks)} samples", flush=True)
        la = tuple(t.detach().requires_grad_() for t in a[:4]) + (a[4],)
        lib, _ = cs.library_bwd_ms(torch, cs.moe_library, [la], args.iters, f"E{E} C{C} f32")
        fmt = {k: "/".join(f"{v:.4f}" for v in vs) for k, vs in runs.items()}
        mean = float(np.mean(runs["tf32"]))
        print(f"  E{E} C{C} D{D} F{F} f32: tf32 {fmt['tf32']} ms, mma.sync {fmt['mma_sync']} "
              f"ms ({float(np.mean(runs['mma_sync'])) / mean:.2f}x), library {lib:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}, 3xTF32), {bound_ms / mean:.4f} of it; "
              f"its own products at the TF32 peak {1e3 * flops / peaks['tf32'] / mean:.4f}",
              flush=True)
        cs.tf32_launch_times(torch, moe_k, peaks, a)
        del a, la
        torch.cuda.empty_cache()
    print("ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
