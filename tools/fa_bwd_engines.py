#!/usr/bin/env python3
"""Flash attention's two backward engines side by side on one NVIDIA card.

    python3 tools/fa_bwd_engines.py [--src DIR] [--quick] [--iters N]
                                    [--no-check] [--shapes NAME ...]

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent / "src"))
    ap.add_argument("--quick", action="store_true", help="build and check; no timing")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--no-check", action="store_true", help="time only")
    ap.add_argument("--shapes", nargs="*", default=[name for name, _, _ in SHAPES])
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
    with ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(g) for g in (fa_k.library, fa_k.bwd_library, fa_k.wgmma_library)]:
            f.result()
    print(f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    for line in build_log("flash_attention_bwd_wgmma", fa_k.WGMMA_SOURCES).splitlines():
        if any(w in line for w in ("Compiling entry", "spill", "Used", "arning")):
            print("  ptxas", line.strip()[:160], flush=True)
    ok = not any(cs.serialization_notes("flash_attention_bwd_wgmma", fa_k.WGMMA_SOURCES).values())
    so = library_path("flash_attention_bwd_wgmma", fa_k.WGMMA_SOURCES)
    sass = subprocess.run([str(Path(_nvcc()).parent / "cuobjdump"), "--dump-sass", str(so)],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    ops = collections.Counter(re.findall(r"\b(HGMMA|UTMALDG|UTMASTG|SYNCS)\b", sass))
    print(f"  SASS {dict(sorted(ops.items()))}", flush=True)
    # per kernel: its products, and the waits on them (one after every
    # product where ptxas serialized them)
    for part in sass.split("Function : ")[1:]:
        name = re.search(r"fa_bwd_\w+?_wgmmaILi\d+ELb\dE", part.splitlines()[0])
        ops = collections.Counter(re.findall(r"\b(HGMMA|WARPGROUP\.DEPBAR|WARPGROUP\.ARRIVE|"
                                             r"STL|LDL)\b", part))
        print(f"  SASS {name.group(0) if name else part.splitlines()[0][:60]}: "
              f"{dict(sorted(ops.items()))}", flush=True)

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, bf16)

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
        (1, 1500, 0, 1500, 8, 8, False, None, None, 64)]
    for B, S, off, Skv, Hq, Hkv, causal, window, softcap, D in [] if args.no_check else cases:
        if D not in fa_k.WGMMA_HEAD_DIMS:
            continue
        q, dout, k, v = randn(B, S, Hq, D), randn(B, S, Hq, D), randn(B, Skv, Hkv, D), \
            randn(B, Skv, Hkv, D)
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
        print(f"{'ok  ' if good else 'FAIL'} B{B} S{S}+{off} Skv{Skv} {Hq}/{Hkv}x{D} causal={causal} "
              f"window={window} softcap={softcap}: forward {fwd:.3g}; wgmma of max|ref| "
              f"{[f'{e:.3g}' for e in errs]}, against mma.sync {[f'{g:.3g}' for g in gaps]}, "
              f"rerun bit-equal {same}", flush=True)
        del q, dout, k, v, out, lse, new, again, old, ref
    if not ok or args.quick:
        return 0 if ok else 1

    peaks = card_peaks(torch.cuda.get_device_name(0))
    for label, (B, S, Hq, Hkv, D), masks in SHAPES:
        if label not in args.shapes:
            continue
        q, dout, k, v = randn(B, S, Hq, D), randn(B, S, Hq, D), randn(B, S, Hkv, D), \
            randn(B, S, Hkv, D)
        nbytes = 2 * (4 * B * S * Hq * D + 4 * B * S * Hkv * D) + 4 * B * Hq * S
        for kw in masks:
            W = kw.get("window") or S
            pairs = B * Hq * (sum(min(i + 1, W) for i in range(S)) if kw["causal"] else S * S)
            bound, by = cs.bound(peaks, nbytes, 10 * D * pairs, "bfloat16")
            out, lse = fa_k.flash_attention_cuda(q, k, v, return_lse=True, **kw)
            turns = collections.defaultdict(list)
            engines = ("wgmma", "mma_sync", "mma_sync", "wgmma")
            if D not in fa_k.WGMMA_HEAD_DIMS:
                engines = ("mma_sync", "mma_sync")
            for engine in engines:
                fn = getattr(fa_k, f"flash_attention_bwd_{engine}_cuda")
                turns[engine].append(cs.cuda_ms(torch, lambda *a, fn=fn: fn(*a, **kw),
                                                [(q, k, v, out, lse, dout)], args.iters)[0])
            for engine, ts in turns.items():
                m = float(np.mean(ts))
                print(f"{label} training shape B{B} S{S} {Hq}/{Hkv}x{D} {kw}, {engine}: "
                      f"{m:.4f} ms a call (turns {[f'{t:.4f}' for t in ts]}), bound {bound:.4f} "
                      f"by {by}, {bound / m:.4f} of it", flush=True)
            if "softcap" not in kw:
                lib = [(*(t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)),
                        dout.transpose(1, 2).contiguous())]
                ms, _ = cs.library_bwd_ms(torch, lambda a, b, c: F.scaled_dot_product_attention(
                    a, b, c, is_causal=kw["causal"], enable_gqa=True), lib, args.iters, label)
                print(f"{label} training shape {kw}, SDPA's backward: {ms:.4f} ms a call",
                      flush=True)
                del lib
            if D in fa_k.WGMMA_HEAD_DIMS:
                cs.fa_launch_times(torch, fa_k, peaks, (q, k, v, out, lse, dout), kw, pairs)
        del q, dout, k, v, out, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
