#!/usr/bin/env python3
"""Flash attention's two backward engines side by side on one NVIDIA card.

    python3 tools/fa_bwd_engines.py [--src DIR] [--quick] [--iters N]

Builds the port's flash-attention libraries from the sources under DIR
(default: this checkout's ``src``), logs ptxas's registers and spills of
the wgmma engine (``csrc/flash_attention_bwd_wgmma.cu``) and its SASS
instruction counts, then checks it against the plain backward
(``ref.attention_bwd_ref``) and the mma.sync engine at head dim 256 (small,
ragged, each mask, query offsets; bf16 within 2e-2 of each gradient's
max|ref|). Without ``--quick`` it then times both engines at gemma2-2b's
training shape (B1 S4096, 8/4 heads of 256, causal, window 4096, softcap
50, bf16) in turns (wgmma, mma.sync, mma.sync, wgmma; CUDA events around
``--iters`` calls each), and each wgmma launch under ``torch.profiler``.
Prints the card's name and power limit first. Exits non-zero on any
mismatch. Needs a card; the port's tests and ``chip_smoke.py`` are the
full check.
"""
import argparse
import collections
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent / "src"))
    ap.add_argument("--quick", action="store_true", help="build and check; no timing")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fa_bwd_engines: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels._build import _nvcc, build_log, library_path
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(g) for g in (fa_k.library, fa_k.bwd_library, fa_k.wgmma_library)]:
            f.result()
    print(f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    for line in build_log("flash_attention_bwd_wgmma", fa_k.WGMMA_SOURCES).splitlines():
        if any(w in line for w in ("Compiling entry", "spill", "Used", "arning", "wgmma")):
            print("  ptxas", line.strip()[:160], flush=True)
    so = library_path("flash_attention_bwd_wgmma", fa_k.WGMMA_SOURCES)
    sass = subprocess.run([str(Path(_nvcc()).parent / "cuobjdump"), "--dump-sass", str(so)],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    ops = collections.Counter(re.findall(r"\b(HGMMA|UTMALDG|UTMASTG|SYNCS)\b", sass))
    print(f"  SASS {dict(sorted(ops.items()))}", flush=True)

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, bf16)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())

    ok = True
    # (B, rows, offset, Skv, Hq, Hkv, causal, window, softcap)
    cases = [(1, 64, 0, 64, 2, 2, True, None, None), (2, 130, 0, 130, 4, 2, False, None, None),
             (2, 130, 0, 130, 4, 2, True, None, None), (1, 130, 0, 130, 2, 1, True, 64, None),
             (1, 130, 0, 130, 2, 1, False, None, 50.0), (1, 200, 0, 50, 2, 1, True, 10, None),
             (1, 64, 100, 96, 2, 1, True, 32, 50.0), (1, 130, 40, 200, 2, 1, False, 64, None),
             (1, 4096, 0, 4096, 8, 4, True, 4096, 50.0)]
    for B, S, off, Skv, Hq, Hkv, causal, window, softcap in cases:
        q, dout, k, v = randn(B, S, Hq, 256), randn(B, S, Hq, 256), randn(B, Skv, Hkv, 256), \
            randn(B, Skv, Hkv, 256)
        kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
        out, lse = fa_k.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        fwd = rel(out, attention_ref(q, k, v, **kw))
        new = fa_k.flash_attention_bwd_wgmma_cuda(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        again = fa_k.flash_attention_bwd_wgmma_cuda(q, k, v, out, lse, dout, **kw)
        old = fa_k.flash_attention_bwd_mma_sync_cuda(q, k, v, out, lse, dout, **kw)
        ref = attention_bwd_ref(q, k, v, dout, **kw)
        errs = [rel(a, r) for a, r in zip(new, ref)]
        gaps = [rel(a, o) for a, o in zip(new, old)]
        same = all(torch.equal(a, b) for a, b in zip(new, again))
        good = max(errs + gaps + [fwd]) <= 2e-2 and same and all(
            bool(torch.isfinite(a).all()) for a in new)
        ok &= good
        print(f"{'ok  ' if good else 'FAIL'} B{B} S{S}+{off} Skv{Skv} {Hq}/{Hkv} causal={causal} "
              f"window={window} softcap={softcap}: forward {fwd:.3g}; wgmma of max|ref| "
              f"{[f'{e:.3g}' for e in errs]}, against mma.sync {[f'{g:.3g}' for g in gaps]}, "
              f"rerun bit-equal {same}", flush=True)
        del q, dout, k, v, out, lse, new, again, old, ref
    if not ok or args.quick:
        return 0 if ok else 1

    B, S, Hq, Hkv, D = 1, 4096, 8, 4, 256
    gkw = dict(causal=True, window=4096, softcap=50.0)
    q, dout, k, v = randn(B, S, Hq, D), randn(B, S, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    bound = 1e3 * 10 * D * B * Hq * S * (S + 1) // 2 / 989e12
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for label, kw in (("gemma2-2b's masks", gkw), ("causal only", dict(causal=True))):
        out, lse = fa_k.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        for engine in ("wgmma", "mma_sync", "mma_sync", "wgmma"):
            fn = getattr(fa_k, f"flash_attention_bwd_{engine}_cuda")
            for _ in range(2):
                fn(q, k, v, out, lse, dout, **kw)
            torch.cuda.synchronize()
            start.record()
            for _ in range(args.iters):
                fn(q, k, v, out, lse, dout, **kw)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / args.iters
            print(f"gemma2-2b training shape, {label}, {engine}: {ms:.4f} ms a call (CUDA "
                  f"events, {args.iters} calls), bound {bound:.4f}, {bound / ms:.4f} of it",
                  flush=True)
    out, lse = fa_k.flash_attention_cuda(q, k, v, return_lse=True, **gkw)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fa_k.flash_attention_bwd_wgmma_cuda(q, k, v, out, lse, dout, **gkw)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_time_total > 0:
            print(f"  profiler: {e.key[:60]} {e.device_time_total / 1e3 / e.count:.4f} ms x"
                  f"{e.count}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
