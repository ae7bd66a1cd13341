#!/usr/bin/env python3
"""scaled_mm's two engines side by side on one NVIDIA card.

    python3 tools/scaled_mm_engines.py [--src DIR] [--quick] [--iters N]

Builds the port's scaled_mm libraries from the sources under DIR (default:
this checkout's ``src``) and logs, with ``chip_smoke.py``'s own helpers,
the wgmma engine's ptxas registers, spills and notes and its SASS
(``smm_ptxas_report``: a C7515, C7519 or C7520 note or a spill fails;
IGMMA, UTMALDG and SYNCS must be there). Then it holds the wgmma engine
(``csrc/scaled_mm_wgmma.cu``) against the plain version (``ref.py``) and
the mma.sync engine (``csrc/scaled_mm.cu``) on the same inputs: small and
ragged shapes, blocks of one row or of 4 columns, blocks that are not
4-column multiples, every stage depth, each output type, and dbrx-132b's
width (M1024 K6144 N10752) at the tuner's five blocks; the int32 sum exact
(unit scales, f32 output), the bf16 output bit-equal to the plain
version's and to the mma.sync engine's, f16 and f32 within 1e-2, a rerun
bit-equal, each count moving by one a call. Without ``--quick`` it then
times both engines in turns (``chip_smoke.smm_engines_in_turns``: wgmma,
mma.sync, mma.sync, wgmma, CUDA-graph replay) at dbrx-132b's width with the
default blocks and the tuner's four first-ranked blocks, and at the
tuner's default workload (M1024 K512 N512), beside ``torch._int_mm`` with
the same epilogue (``chip_smoke.smm_library``) and the bound
(``chip_smoke.smm_bound``). Prints the card's name and power limit first.
Exits non-zero on any mismatch. Needs a card; the port's tests and
``chip_smoke.py`` are the full check.
"""
import argparse
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: (M, K, N, block_m, block_n, block_k): the reference's test shapes, ragged
#: M, N blocks of 31 (N = 16 x 31) and 4 columns, 1-row blocks, stages of 32,
#: 64 and 128 k (block_k 96: stages of 32), blocks of several sub-tiles
CASES = [(64, 128, 96, 32, 32, 64), (128, 64, 128, 64, 64, 32), (7, 96, 16, 3, 5, 32),
         (64, 96, 48, 32, 25, 32), (100, 160, 496, 50, 32, 32), (200, 288, 272, 100, 136, 96),
         (1024, 512, 512, 128, 128, 256), (1024, 512, 512, 512, 512, 512),
         (1024, 512, 512, 32, 32, 32), (1024, 512, 512, 512, 512, 64),
         (256, 6144, 512, 128, 128, 256), (300, 1024, 384, 300, 384, 128)]
#: the tuner's default blocks and the four its roofline ranks first at
#: dbrx-132b's width (phase 7 of chip_smoke.py)
TUNER_BLOCKS = [(128, 128, 256), (512, 512, 512), (512, 512, 256), (256, 512, 512),
                (512, 256, 512)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--quick", action="store_true", help="build and check only, no timing")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("scaled_mm_engines: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.scaled_mm import kernel as smm_k
    from repro_torch.kernels.scaled_mm.ref import scaled_mm_acc_ref, scaled_mm_ref
    from repro_torch.roofline.analysis import card_peaks

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(g) for g in (smm_k.library, smm_k.wgmma_library)]:
            f.result()
    print(f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    ok = True
    try:
        cs.smm_ptxas_report(smm_k)
    except AssertionError as e:  # still check and time it, then fail
        print(f"  FAILED: {e}", flush=True)
        ok = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(M, K, N, lo=0.5, hi=2.0):
        return (torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8),
                torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8),
                lo + (hi - lo) * torch.rand(M, generator=gen, device=dev),
                lo + (hi - lo) * torch.rand(N, generator=gen, device=dev))

    cases = [(c, torch.bfloat16) for c in CASES]
    cases += [((256, 512, 384, 128, 128, 256), torch.float16),
              ((256, 512, 384, 128, 128, 256), torch.float32),
              ((100, 160, 496, 50, 32, 32), torch.float32)]
    cases += [((1024, 6144, 10752, *b), torch.bfloat16) for b in TUNER_BLOCKS]
    for (M, K, N, bm, bn, bk), out_dtype in cases:
        blocks = dict(block_m=bm, block_n=bn, block_k=bk)
        small = out_dtype == torch.float16  # scales that keep f16 finite
        x, w, sx, sw = inputs(M, K, N, *((0.5e-3, 2e-3) if small else (0.5, 2.0)))
        assert smm_k.engine(M, K, N, **blocks) == "wgmma", (M, K, N, blocks)
        n0, m0 = smm_k.wgmma_launches, smm_k.launches
        got = smm_k.scaled_mm_cuda(x, w, sx, sw, out_dtype=out_dtype, **blocks)
        counted = (smm_k.wgmma_launches - n0, smm_k.launches - m0) == (1, 0)
        grid = smm_k.last_grid == smm_k.launch_plan(M, K, N, **blocks).grid
        again = smm_k.scaled_mm_wgmma_cuda(x, w, sx, sw, out_dtype=out_dtype, **blocks)
        old = smm_k.scaled_mm_mma_sync_cuda(x, w, sx, sw, out_dtype=out_dtype, **blocks)
        unit = smm_k.scaled_mm_wgmma_cuda(x, w, torch.ones_like(sx), torch.ones_like(sw),
                                          out_dtype=torch.float32, **blocks)
        acc = scaled_mm_acc_ref(x, w)
        ref = scaled_mm_ref(x, w, sx, sw, out_dtype)
        torch.cuda.synchronize()
        exact = int(acc.abs().max()) < 2**24 and torch.equal(unit, acc.float())
        err = float((got.float() - ref.float()).abs().max())
        close = bool(torch.allclose(got.float(), ref.float(), rtol=cs.SMM_TOL, atol=cs.SMM_TOL))
        same_ref, same_old = torch.equal(got, ref), torch.equal(got, old)
        rerun = torch.equal(got, again)
        good = exact and close and rerun and counted and grid and (
            out_dtype != torch.bfloat16 or same_ref)
        ok &= good
        print(f"  M{M} K{K} N{N} blocks ({bm}, {bn}, {bk}) {str(out_dtype)[6:]}: int32 sum exact "
              f"{exact}, max abs err {err:.3g}, bit-equal to the plain version {same_ref}, to "
              f"mma.sync {same_old}, rerun {rerun}; count {counted}, grid {grid}"
              f"{'' if good else '  MISMATCH'}", flush=True)
        del x, w, sx, sw, got, again, old, unit, acc, ref
    torch.cuda.empty_cache()
    if args.quick:
        print("ok" if ok else "FAILED", flush=True)
        return 0 if ok else 1

    peaks = card_peaks(torch.cuda.get_device_name(0))
    for (M, K, N), block_list, reps in (((1024, 6144, 10752), TUNER_BLOCKS, 2),
                                        ((1024, 512, 512), TUNER_BLOCKS[:1], 8)):
        a = [inputs(M, K, N) for _ in range(reps)]  # 2 x 72 MB at dbrx width: more than L2
        bound_ms, bound_by = cs.smm_bound(peaks, M, K, N)
        lib = cs.cuda_ms(torch, cs.smm_library, a, args.iters)[0]
        for bm, bn, bk in block_list:
            blocks = dict(block_m=bm, block_n=bn, block_k=bk)
            turns, _ = cs.smm_engines_in_turns(torch, a, args.iters, **blocks)
            w_ms, m_ms = float(np.mean(turns["wgmma"])), float(np.mean(turns["mma_sync"]))
            fmt = {k: "/".join(f"{v:.4f}" for v in vs) for k, vs in turns.items()}
            print(f"  M{M} K{K} N{N} blocks ({bm}, {bn}, {bk}): wgmma {fmt['wgmma']} ms, "
                  f"mma.sync {fmt['mma_sync']} ms ({m_ms / w_ms:.2f}x), _int_mm + epilogue "
                  f"{lib:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), wgmma "
                  f"{bound_ms / w_ms:.3f} of it, {2 * M * K * N / w_ms / 1e9:.1f} TOPS",
                  flush=True)
        del a
        torch.cuda.empty_cache()
    print("ok" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
