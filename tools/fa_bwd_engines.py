#!/usr/bin/env python3
"""Flash attention's backward engines side by side on one NVIDIA card.

    python3 tools/fa_bwd_engines.py [--src DIR] [--quick] [--iters N]
                                    [--no-check] [--shapes NAME ...] [--f32]

Builds the port's flash-attention libraries from the sources under DIR
(default: this checkout's ``src``), logs ptxas's registers and spills of
the wgmma engine (``csrc/flash_attention_bwd_wgmma.cu``), its wgmma
serialization notes (``chip_smoke.py``'s ``serialization_notes``: a C7515,
C7519 or C7520 note fails) and its SASS instruction counts, then checks it
against the plain backward (``ref.attention_bwd_ref``) and the mma.sync
engine at head dims 64, 80, 128 and 256 (small, ragged, each mask, rows
that see no key, GQA groups of 2 and 6, query offsets, S != Skv; the
models' training shapes: stablelm-3b's at 80, hymba-1.5b's and
whisper-base's at 64, qwen3-0.6b's and dbrx-132b's at 128, gemma2-2b's at
256; bf16 within 2e-2 of each gradient's max|ref|, bit-equal reruns).
Without ``--quick`` it then times both engines in turns (wgmma, mma.sync,
mma.sync, wgmma; ``chip_smoke.cuda_ms``: ``--iters`` calls replayed from
one CUDA graph) at those training shapes (gemma2-2b's with its window 4096
and softcap 50, then causal only), each beside its five-product bound at
the card's bf16 peak (``chip_smoke.bound``) and, where SDPA takes the
mask, SDPA's backward (``chip_smoke.library_bwd_ms``), and each wgmma
launch under ``torch.profiler`` (``chip_smoke.fa_launch_times``).
``--shapes`` times only the named ones; ``--no-check`` skips the checks
(to time a variant of the sources under ``--src``). Prints the card's name
and power limit first. Exits non-zero on any mismatch. Needs a card; the
port's tests and ``chip_smoke.py`` are the full check.

``--f32`` does the same for the f32 engines: the 3xTF32 engine
(``csrc/flash_attention_bwd_tf32.cu``, at head dims 80 and 128) against
the plain backward run in float64 (within 2e-5 of each gradient's
max|ref|) and the FMA engine of ``csrc/flash_attention_bwd.cu``, at the
cases above and the f32 gradient shapes of ``chip_smoke.py``'s phase 10
(a): qwen3-0.6b's (B2 S256, 16/8 heads of 128), stablelm-3b's (B2 S256,
32/32 heads of 80) and dbrx-132b's (B1 S128, 48/8 heads of 128), all
causal; then both in turns there beside SDPA's f32 backward, each against
its 3xTF32 bound (three TF32 products for each of its own, at the TF32
peak) and its bound at f32's peak, and each 3xTF32 launch under the
profiler.
"""
import argparse
import collections
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: the timed training shapes: (name, (B, S, Hq, Hkv, D), masks)
SHAPES = [("qwen3-0.6b", (4, 2048, 16, 8, 128), [dict(causal=True)]),
          ("dbrx-132b", (1, 2048, 48, 8, 128), [dict(causal=True)]),
          ("gemma2-2b", (1, 4096, 8, 4, 256),
           [dict(causal=True, window=4096, softcap=50.0), dict(causal=True)]),
          ("stablelm-3b", (1, 2048, 32, 32, 80), [dict(causal=True)]),
          ("hymba-1.5b", (1, 1528, 25, 5, 64), [dict(causal=True)]),
          ("whisper-base", (1, 1500, 8, 8, 64), [dict(causal=False)])]
#: the f32 gradient shapes, timed with ``--f32``
F32_SHAPES = [("qwen3-0.6b", (2, 256, 16, 8, 128), [dict(causal=True)]),
              ("stablelm-3b", (2, 256, 32, 32, 80), [dict(causal=True)]),
              ("dbrx-132b", (1, 128, 48, 8, 128), [dict(causal=True)])]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent / "src"))
    ap.add_argument("--quick", action="store_true", help="build and check; no timing")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--no-check", action="store_true", help="time only")
    ap.add_argument("--shapes", nargs="*", default=None)
    ap.add_argument("--f32", action="store_true", help="the f32 engines")
    args = ap.parse_args()
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("fa_bwd_engines: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels._build import _nvcc, build_log, library_path
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
    from repro_torch.roofline.analysis import card_peaks

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    engine = "tf32" if args.f32 else "wgmma"
    lib, sources = (("flash_attention_bwd_tf32", fa_k.BWD_TF32_SOURCES) if args.f32
                    else ("flash_attention_bwd_wgmma", fa_k.WGMMA_SOURCES))
    builds = (fa_k.library, fa_k.bwd_library, fa_k.fwd_tf32_library, fa_k.bwd_tf32_library) \
        if args.f32 else (fa_k.library, fa_k.bwd_library, fa_k.wgmma_library)
    with ThreadPoolExecutor(len(builds)) as pool:
        for f in [pool.submit(g) for g in builds]:
            f.result()
    print(f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    for line in build_log(lib, sources).splitlines():
        if any(w in line for w in ("Compiling entry", "spill", "Used", "arning")):
            print("  ptxas", line.strip()[:160], flush=True)
    ok = not any(cs.serialization_notes(lib, sources).values())
    so = library_path(lib, sources)
    sass = subprocess.run([str(Path(_nvcc()).parent / "cuobjdump"), "--dump-sass", str(so)],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    ops = collections.Counter(re.findall(r"\b(HGMMA|UTMALDG|UTMASTG|SYNCS)\b", sass))
    print(f"  SASS {dict(sorted(ops.items()))}", flush=True)
    # per kernel: its products, and the waits on them (one after every
    # product where ptxas serialized them)
    for part in sass.split("Function : ")[1:]:
        name = re.search(r"fa_bwd_\w+?_(?:wgmma|tf32)ILi\d+ELb\dE", part.splitlines()[0])
        ops = collections.Counter(re.findall(r"\b(HGMMA|WARPGROUP\.DEPBAR|WARPGROUP\.ARRIVE|"
                                             r"STL|LDL)\b", part))
        print(f"  SASS {name.group(0) if name else part.splitlines()[0][:60]}: "
              f"{dict(sorted(ops.items()))}", flush=True)

    dev = torch.device("cuda")
    dt = torch.float32 if args.f32 else torch.bfloat16
    heads = fa_k.BWD_TF32_HEAD_DIMS if args.f32 else fa_k.WGMMA_HEAD_DIMS
    shapes = F32_SHAPES if args.f32 else SHAPES
    args.shapes = args.shapes or [name for name, _, _ in shapes]
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dt)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())

    # (B, rows, offset, Skv, Hq, Hkv, causal, window, softcap) at each head dim
    cases = [(1, 64, 0, 64, 2, 2, True, None, None), (2, 130, 0, 130, 4, 2, False, None, None),
             (2, 130, 0, 130, 4, 2, True, None, None), (1, 130, 0, 130, 2, 1, True, 64, None),
             (1, 130, 0, 130, 2, 1, False, None, 50.0), (1, 200, 0, 50, 2, 1, True, 10, None),
             (1, 64, 100, 96, 2, 1, True, 32, 50.0), (1, 130, 40, 200, 2, 1, False, 64, None),
             (2, 300, 0, 300, 12, 2, True, None, None), (1, 77, 0, 200, 6, 1, False, 50, 20.0)]
    cases = [(*c, D) for D in (64, 80, 128, 256) for c in cases] + [
        (1, 4096, 0, 4096, 8, 4, True, 4096, 50.0, 256),
        (4, 2048, 0, 2048, 16, 8, True, None, None, 128),
        (1, 2048, 0, 2048, 48, 8, True, None, None, 128),
        (1, 2048, 0, 2048, 32, 32, True, None, None, 80),
        (1, 1528, 0, 1528, 25, 5, True, None, None, 64),
        (1, 1500, 0, 1500, 8, 8, False, None, None, 64),
        (2, 256, 0, 256, 16, 8, True, None, None, 128),
        (2, 256, 0, 256, 32, 32, True, None, None, 80),
        (1, 128, 0, 128, 48, 8, True, None, None, 128)]
    # bf16 within 2e-2 of each gradient's max|ref| of the plain backward, and
    # of the mma.sync engine's; f32 within 2e-5 of the plain backward's in
    # float64 (the FMA engine's gap is logged)
    tol = 2e-5 if args.f32 else 2e-2
    for B, S, off, Skv, Hq, Hkv, causal, window, softcap, D in [] if args.no_check else cases:
        if D not in heads:
            continue
        q, dout, k, v = randn(B, S, Hq, D), randn(B, S, Hq, D), randn(B, Skv, Hkv, D), \
            randn(B, Skv, Hkv, D)
        kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
        wide = [t.double() for t in (q, k, v)] if args.f32 else [q, k, v]
        out, lse = fa_k.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        fwd = rel(out, attention_ref(*wide, **kw))
        n0 = getattr(fa_k, f"bwd_{engine}_launches")
        new = fa_k.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        moved = getattr(fa_k, f"bwd_{engine}_launches") - n0
        again = getattr(fa_k, f"flash_attention_bwd_{engine}_cuda")(q, k, v, out, lse, dout, **kw)
        old = fa_k.flash_attention_bwd_mma_sync_cuda(q, k, v, out, lse, dout, **kw)
        ref = attention_bwd_ref(*wide, dout.double() if args.f32 else dout, **kw)
        errs = [rel(a, r) for a, r in zip(new, ref)]
        gaps = [rel(a, o) for a, o in zip(new, old)]
        same = all(torch.equal(a, b) for a, b in zip(new, again))
        good = max(errs + ([] if args.f32 else gaps) + [fwd]) <= tol and same and moved == 1 \
            and all(bool(torch.isfinite(a).all()) for a in new)
        ok &= good
        print(f"{'ok  ' if good else 'FAIL'} {dt} B{B} S{S}+{off} Skv{Skv} {Hq}/{Hkv}x{D} "
              f"causal={causal} window={window} softcap={softcap}: forward {fwd:.3g}; {engine} "
              f"of max|ref| {[f'{e:.3g}' for e in errs]}, against mma.sync "
              f"{[f'{g:.3g}' for g in gaps]}, rerun bit-equal {same}", flush=True)
        del q, dout, k, v, out, lse, new, again, old, ref, wide
    if not ok or args.quick:
        return 0 if ok else 1

    peaks = card_peaks(torch.cuda.get_device_name(0))
    size = 4 if args.f32 else 2
    for label, (B, S, Hq, Hkv, D), masks in shapes:
        if label not in args.shapes:
            continue
        q, dout, k, v = randn(B, S, Hq, D), randn(B, S, Hq, D), randn(B, S, Hkv, D), \
            randn(B, S, Hkv, D)
        nbytes = size * (4 * B * S * Hq * D + 4 * B * S * Hkv * D) + 4 * B * Hq * S
        for kw in masks:
            W = kw.get("window") or S
            pairs = B * Hq * (sum(min(i + 1, W) for i in range(S)) if kw["causal"] else S * S)
            bound, by = cs.bound(peaks, nbytes, 10 * D * pairs * (3 if args.f32 else 1),
                                 "tf32" if args.f32 else "bfloat16")
            out, lse = fa_k.flash_attention_cuda(q, k, v, return_lse=True, **kw)
            turns = collections.defaultdict(list)
            engines = (engine, "mma_sync", "mma_sync", engine)
            if D not in heads:
                engines = ("mma_sync", "mma_sync")
            for e in engines:
                fn = getattr(fa_k, f"flash_attention_bwd_{e}_cuda")
                turns[e].append(cs.cuda_ms(torch, lambda *a, fn=fn: fn(*a, **kw),
                                           [(q, k, v, out, lse, dout)], args.iters)[0])
            extra = ""
            if args.f32:
                b32, by32 = cs.bound(peaks, nbytes, 10 * D * pairs, "float32")
                extra = f", f32-peak bound {b32:.4f} by {by32}"
            for e, ts in turns.items():
                m = float(np.mean(ts))
                print(f"{label} training shape {dt} B{B} S{S} {Hq}/{Hkv}x{D} {kw}, {e}: "
                      f"{m:.4f} ms a call (turns {[f'{t:.4f}' for t in ts]}), bound {bound:.4f} "
                      f"by {by}, {bound / m:.4f} of it{extra}", flush=True)
            if "softcap" not in kw:
                lib = [(*(t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)),
                        dout.transpose(1, 2).contiguous())]
                ms, _ = cs.library_bwd_ms(torch, lambda a, b, c: F.scaled_dot_product_attention(
                    a, b, c, is_causal=kw["causal"], enable_gqa=True), lib, args.iters, label)
                print(f"{label} training shape {kw}, SDPA's backward: {ms:.4f} ms a call",
                      flush=True)
                del lib
            if D in heads:
                cs.fa_launch_times(torch, fa_k, peaks, (q, k, v, out, lse, dout), kw, pairs,
                                   engine)
        del q, dout, k, v, out, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
