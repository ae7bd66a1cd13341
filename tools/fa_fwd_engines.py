#!/usr/bin/env python3
"""Flash attention's forward engines side by side on one NVIDIA card.

    python3 tools/fa_fwd_engines.py [--src DIR] [--quick] [--iters N]
                                    [--shapes NAME ...] [--f32]

Builds the port's forward libraries from the sources under DIR (default:
this checkout's ``src``), logs ptxas's registers, spills and notes of the
wgmma engine (``csrc/flash_attention_wgmma.cu``; ``chip_smoke.py``'s
``serialization_notes``: a C7515, C7519 or C7520 note fails) and its SASS
instruction counts (``wgmma_sass``), then checks it against the plain
version (``ref.attention_ref`` and ``ref.lse_ref``) and the mma.sync
engine at head dims 64, 80, 128 and 256: small, ragged, GQA, each mask,
rows that see no key, query offsets, S != Skv, other blocks and the models'
shapes (whisper-base's encoder and cross attention, hymba-1.5b's global
layer); bf16 within 2e-2 of max|ref|, the lse within 2e-2, bit-equal
reruns. A head dim the wgmma engine of DIR does not take is skipped (an
older tree's). Without ``--quick`` it then times both engines in turns
(wgmma, mma.sync, mma.sync, wgmma; ``chip_smoke.cuda_ms``: ``--iters``
calls replayed from one CUDA graph) at the serving path's main shape (B4
S2048, 16/8 heads of 128, causal), gemma2-2b's prefill (B1 S4608, 8/4
heads of 256, causal, window 4096, softcap 50), stablelm-3b's (B1 S2048,
32/32 heads of 80, causal), whisper-base's encoder (B1 S1500, 8/8 heads of
64, no mask) and hymba-1.5b's global layer (B1 S1528, 25/5 heads of 64,
causal), each against its bound (``chip_smoke.bound`` at the card's bf16
peak) and SDPA (causal only at D 256: SDPA takes no softcap).
``--shapes`` times only the named ones. To time two trees against each
other, run the tool on each in turns on one card (parent, change,
change, parent). Prints the card's name and power limit first. Exits
non-zero on any mismatch. Needs a card.

``--f32`` does the same for the f32 engines: the 3xTF32 engine
(``csrc/flash_attention_tf32.cu``, at head dims 64, 80 and 128) against
the plain version run in float64 (output and lse within 2e-5 of 1 +
|ref|, as ``allclose`` holds them) and against the FMA engine of
``csrc/flash_attention.cu`` at the cases above and f32's own shapes, then
both in turns at qwen3-0.6b's f32 gradient shape (B2 S256, 16/8 heads of
128, causal), the tuner's flash-attention workload (B2 S512, the same
heads) and stablelm-3b's (B2 S256, 32/32 heads of 80), beside SDPA in
f32, each against its 3xTF32 bound (three TF32 products for each of its
own, at the TF32 peak) and its bound at f32's peak.
"""
import argparse
import collections
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: (B, S, offset, Skv, Hq, Hkv, D, causal, window, softcap, block_q, block_k)
CASES = [
    (1, 64, 0, 64, 2, 2, 128, True, None, None, 128, 128),
    (2, 100, 0, 100, 4, 2, 128, True, None, None, 128, 128),
    (1, 1000, 0, 1000, 16, 8, 128, True, None, None, 128, 128),
    (2, 300, 0, 300, 8, 2, 128, True, None, None, 128, 128),
    (1, 130, 0, 130, 2, 1, 256, True, 64, 50.0, 128, 128),
    (2, 300, 0, 300, 8, 2, 256, True, None, None, 128, 128),
    (1, 200, 0, 50, 2, 1, 128, False, 10, None, 128, 128),
    (1, 200, 0, 50, 2, 1, 256, True, 10, None, 128, 128),
    (1, 77, 0, 200, 4, 1, 256, False, 50, 20.0, 128, 128),
    (1, 77, 0, 200, 4, 1, 128, False, 50, 20.0, 128, 128),
    (1, 512, 0, 1601, 32, 8, 128, False, None, None, 128, 128),
    (1, 64, 100, 96, 2, 1, 256, True, 32, 50.0, 128, 128),
    (1, 64, 64, 192, 4, 2, 128, True, None, None, 128, 128),
    (1, 130, 40, 200, 2, 1, 256, False, 64, None, 128, 128),
    (2, 512, 0, 512, 4, 2, 128, True, 100, None, 64, 32),
    (2, 512, 0, 512, 4, 2, 128, True, None, None, 512, 512),
    (2, 512, 0, 512, 4, 2, 256, True, None, 30.0, 256, 96),
    (1, 4608, 0, 4608, 8, 4, 256, True, 4096, 50.0, 128, 128),
    (4, 2048, 0, 2048, 16, 8, 128, True, None, None, 128, 128),
    (1, 64, 0, 64, 2, 2, 80, True, None, None, 128, 128),
    (2, 300, 0, 300, 8, 2, 80, True, None, None, 128, 128),
    (1, 130, 0, 130, 2, 1, 80, True, 64, 50.0, 128, 128),
    (1, 200, 0, 50, 2, 1, 80, False, 10, None, 128, 128),
    (1, 77, 0, 200, 4, 1, 80, False, 50, 20.0, 128, 128),
    (1, 64, 64, 192, 4, 2, 80, True, None, None, 128, 128),
    (2, 512, 0, 512, 4, 2, 80, True, 100, None, 64, 32),
    (2, 512, 0, 512, 4, 2, 80, True, None, None, 512, 512),
    (1, 2048, 0, 2048, 32, 32, 80, True, None, None, 128, 128),
    (1, 64, 0, 64, 2, 2, 64, True, None, None, 128, 128),
    (2, 300, 0, 300, 8, 2, 64, True, None, None, 128, 128),
    (1, 130, 0, 130, 2, 1, 64, True, 64, 50.0, 128, 128),
    (1, 200, 0, 50, 2, 1, 64, False, 10, None, 128, 128),
    (1, 77, 0, 200, 4, 1, 64, False, 50, 20.0, 128, 128),
    (1, 64, 64, 192, 4, 2, 64, True, None, None, 128, 128),
    (1, 130, 40, 200, 2, 1, 64, False, 64, None, 128, 128),
    (2, 512, 0, 512, 4, 2, 64, True, 100, None, 64, 32),
    (2, 512, 0, 512, 4, 2, 64, True, None, None, 512, 512),
    (1, 1500, 0, 1500, 8, 8, 64, False, None, None, 128, 128),
    (1, 64, 0, 1500, 8, 8, 64, False, None, None, 128, 128),
    (1, 1, 0, 1500, 8, 8, 64, False, None, None, 128, 128),
    (1, 1528, 0, 1528, 25, 5, 64, True, None, None, 128, 128),
]
#: f32's own cases: the timed shapes, dbrx-132b's f32 gradient shape, the
#: tuner's blocks and a step shorter than a tile
F32_CASES = [
    (2, 256, 0, 256, 16, 8, 128, True, None, None, 128, 128),
    (2, 512, 0, 512, 16, 8, 128, True, None, None, 64, 256),
    (2, 256, 0, 256, 32, 32, 80, True, None, None, 128, 128),
    (1, 128, 0, 128, 48, 8, 128, True, None, None, 128, 128),
    (2, 256, 0, 256, 16, 8, 64, True, None, None, 32, 16),
]
#: the f32 timed shapes: (name, (B, S, Hq, Hkv, D), masks)
F32_SHAPES = [("qwen3-0.6b", (2, 256, 16, 8, 128), dict(causal=True)),
              ("tuner", (2, 512, 16, 8, 128), dict(causal=True)),
              ("stablelm-3b", (2, 256, 32, 32, 80), dict(causal=True))]
#: the timed shapes: (name, (B, S, Hq, Hkv, D), masks)
SHAPES = [("main", (4, 2048, 16, 8, 128), dict(causal=True)),
          ("gemma2-2b", (1, 4608, 8, 4, 256), dict(causal=True, window=4096, softcap=50.0)),
          ("stablelm-3b", (1, 2048, 32, 32, 80), dict(causal=True)),
          ("whisper-base", (1, 1500, 8, 8, 64), dict(causal=False)),
          ("hymba-1.5b", (1, 1528, 25, 5, 64), dict(causal=True))]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent / "src"))
    ap.add_argument("--quick", action="store_true", help="build and check; no timing")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--shapes", nargs="*", default=None)
    ap.add_argument("--f32", action="store_true", help="the f32 engines")
    args = ap.parse_args()
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("fa_fwd_engines: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels._build import build_log
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ref import attention_ref, lse_ref
    from repro_torch.roofline.analysis import card_peaks

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    if args.f32:
        return f32_engines(args, cs, fa_k)
    args.shapes = args.shapes or [name for name, _, _ in SHAPES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(g) for g in (fa_k.library, fa_k.fwd_wgmma_library)]:
            f.result()
    print(f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    for line in build_log("flash_attention_wgmma", fa_k.FWD_WGMMA_SOURCES).splitlines():
        if any(w in line for w in ("Compiling entry", "spill", "Used", "arning")):
            print("  ptxas", line.strip()[:200], flush=True)
    ok = not any(cs.serialization_notes("flash_attention_wgmma", fa_k.FWD_WGMMA_SOURCES).values())
    cs.wgmma_sass("flash_attention_wgmma", fa_k.FWD_WGMMA_SOURCES, ("HGMMA", "UTMALDG", "SYNCS"))

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, bf16)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())

    def lse_gap(a, b):
        fin = torch.isfinite(b)
        if not torch.equal(fin, torch.isfinite(a)):
            return float("inf")
        return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0

    for B, S, off, Skv, Hq, Hkv, D, causal, window, softcap, bq, bk in CASES:
        if D not in fa_k.FWD_WGMMA_HEAD_DIMS:
            continue
        q, k, v = randn(B, S, Hq, D), randn(B, Skv, Hkv, D), randn(B, Skv, Hkv, D)
        mask = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
        kw = dict(mask, block_q=bq, block_k=bk)
        w0 = fa_k.wgmma_launches
        out, lse = fa_k.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        moved = fa_k.wgmma_launches - w0
        again, lse2 = fa_k.flash_attention_wgmma_cuda(q, k, v, return_lse=True, **kw)
        old = fa_k.flash_attention_mma_sync_cuda(q, k, v, **kw)
        ref = attention_ref(q, k, v, **mask)
        err, gap = rel(out, ref), rel(out, old)
        lerr = lse_gap(lse, lse_ref(q, k, v, **mask))
        same = torch.equal(out, again) and torch.equal(lse, lse2)
        good = (max(err, gap, lerr) <= 2e-2 and same and moved == 1
                and bool(torch.isfinite(out).all()))
        ok &= good
        print(f"{'ok  ' if good else 'FAIL'} B{B} S{S}+{off} Skv{Skv} {Hq}/{Hkv}x{D} "
              f"causal={causal} window={window} softcap={softcap} blocks ({bq}, {bk}): "
              f"of max|ref| {err:.3g}, against mma.sync {gap:.3g}, lse {lerr:.3g}, "
              f"rerun bit-equal {same}, wgmma launches {moved}", flush=True)
        del q, k, v, out, lse, again, lse2, old, ref
    if not ok or args.quick:
        return 0 if ok else 1

    peaks = card_peaks(torch.cuda.get_device_name(0))
    for label, (B, S, Hq, Hkv, D), kw in SHAPES:
        if label not in args.shapes:
            continue
        q, k, v = randn(B, S, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        W = kw.get("window") or S
        pairs = sum(min(i + 1, W) for i in range(S)) if kw["causal"] else S * S
        flops = 4 * D * B * Hq * pairs
        nbytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
        bound, by = cs.bound(peaks, nbytes, flops, "bfloat16")
        turns = collections.defaultdict(list)
        engines = ("wgmma", "mma_sync", "mma_sync", "wgmma")
        if D not in fa_k.FWD_WGMMA_HEAD_DIMS:
            engines = ("mma_sync", "mma_sync")
        for engine in engines:
            fn = getattr(fa_k, f"flash_attention_{engine}_cuda")
            turns[engine].append(cs.cuda_ms(torch, lambda a, b, c, fn=fn: fn(a, b, c, **kw),
                                            [(q, k, v)], args.iters)[0])
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa, _ = cs.cuda_ms(torch, lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=kw["causal"], enable_gqa=True), [(qt, kt, vt)], args.iters)
        for engine, ts in turns.items():
            m = float(np.mean(ts))
            print(f"{label} B{B} S{S} {Hq}/{Hkv}x{D} {kw}, {engine}: {m:.4f} ms a call (turns "
                  f"{[f'{t:.4f}' for t in ts]}), bound {bound:.4f} ms by {by}, {bound / m:.4f} "
                  f"of it, {flops / m / 1e9:.1f} TFLOP/s", flush=True)
        print(f"{label}: SDPA ({'causal' if kw['causal'] else 'no mask'} only) {sdpa:.4f} ms",
              flush=True)
        del q, k, v, qt, kt, vt
    return 0


def f32_engines(args, cs, fa_k) -> int:
    """``--f32``: the 3xTF32 engine against float64 and the FMA engine,
    then both timed in turns (the module's head says where)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels._build import build_log
    from repro_torch.kernels.flash_attention.ref import attention_ref, lse_ref
    from repro_torch.roofline.analysis import card_peaks

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(g) for g in (fa_k.library, fa_k.fwd_tf32_library)]:
            f.result()
    print(f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    for line in build_log("flash_attention_tf32", fa_k.FWD_TF32_SOURCES).splitlines():
        if any(w in line for w in ("Compiling entry", "spill", "Used", "arning")):
            print("  ptxas", line.strip()[:200], flush=True)
    ok = not any(cs.serialization_notes("flash_attention_tf32", fa_k.FWD_TF32_SOURCES).values())
    cs.wgmma_sass("flash_attention_tf32", fa_k.FWD_TF32_SOURCES, ("HGMMA", "UTMALDG", "SYNCS"))

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    for B, S, off, Skv, Hq, Hkv, D, causal, window, softcap, bq, bk in CASES + F32_CASES:
        if D not in fa_k.FWD_TF32_HEAD_DIMS:
            continue
        q, k, v = randn(B, S, Hq, D), randn(B, Skv, Hkv, D), randn(B, Skv, Hkv, D)
        mask = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
        kw = dict(mask, block_q=bq, block_k=bk)
        t0 = fa_k.tf32_launches
        out, lse = fa_k.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        moved = fa_k.tf32_launches - t0
        again, lse2 = fa_k.flash_attention_tf32_cuda(q, k, v, return_lse=True, **kw)
        old = fa_k.flash_attention_mma_sync_cuda(q, k, v, **kw)
        wide = [t.double() for t in (q, k, v)]
        ref, lref = attention_ref(*wide, **mask), lse_ref(*wide, **mask)
        err = float(((out.double() - ref).abs() / (1 + ref.abs())).max())
        gap = float((out - old).abs().max())
        fin = torch.isfinite(lref)
        lerr = (float(((lse.double() - lref)[fin].abs() / (1 + lref[fin].abs())).max())
                if bool(fin.any()) else 0.0)
        lerr = lerr if torch.equal(fin, torch.isfinite(lse)) else float("inf")
        same = torch.equal(out, again) and torch.equal(lse, lse2)
        good = (max(err, lerr) <= 2e-5 and same and moved == 1
                and bool(torch.isfinite(out).all()))
        ok &= good
        print(f"{'ok  ' if good else 'FAIL'} f32 B{B} S{S}+{off} Skv{Skv} {Hq}/{Hkv}x{D} "
              f"causal={causal} window={window} softcap={softcap} blocks ({bq}, {bk}): "
              f"from float64 {err:.3g} (of 1 + |ref|), lse {lerr:.3g}, against the FMA engine "
              f"{gap:.3g}, rerun bit-equal {same}, tf32 launches {moved}", flush=True)
        del q, k, v, out, lse, again, lse2, old, ref, lref, wide
    if not ok or args.quick:
        return 0 if ok else 1

    peaks = card_peaks(torch.cuda.get_device_name(0))
    for label, (B, S, Hq, Hkv, D), kw in F32_SHAPES:
        if args.shapes and label not in args.shapes:
            continue
        q, k, v = randn(B, S, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        pairs = B * Hq * (S * (S + 1) // 2 if kw["causal"] else S * S)
        flops = 4 * D * pairs
        nbytes = 4 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
        bound, by = cs.bound(peaks, nbytes, 3 * flops, "tf32")
        bound32, by32 = cs.bound(peaks, nbytes, flops, "float32")
        turns = collections.defaultdict(list)
        for engine in ("tf32", "mma_sync", "mma_sync", "tf32"):
            fn = getattr(fa_k, f"flash_attention_{engine}_cuda")
            turns[engine].append(cs.cuda_ms(torch, lambda a, b, c, fn=fn: fn(a, b, c, **kw),
                                            [(q, k, v)], args.iters)[0])
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa, _ = cs.cuda_ms(torch, lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=kw["causal"], enable_gqa=True), [(qt, kt, vt)], args.iters)
        for engine, ts in turns.items():
            m = float(np.mean(ts))
            print(f"{label} f32 B{B} S{S} {Hq}/{Hkv}x{D} {kw}, {engine}: {m:.4f} ms a call "
                  f"(turns {[f'{t:.4f}' for t in ts]}), 3xTF32 bound {bound:.4f} ms by {by}, "
                  f"f32-peak bound {bound32:.4f} ms by {by32}", flush=True)
        print(f"{label} f32: SDPA {sdpa:.4f} ms", flush=True)
        del q, k, v, qt, kt, vt
    return 0


if __name__ == "__main__":
    sys.exit(main())
