#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build: compile the CUDA sources (flash attention, fused MoE, scaled_mm)
   with nvcc, one process each, all at once, and the Triton kernels
   (rmsnorm, silu_mul), from the sources in this checkout;
2. kernel parity: each kernel against its plain PyTorch version on the
   card, at the reference's test shapes and the main paths' shapes
   (f32 2e-5, bf16 2e-2, scaled_mm 1e-2 and an exact int32 sum, the
   reference's kernel tolerances; full-width f32 MoE sums relative to
   max|ref|); fused MoE and scaled_mm at every config the tuner's
   prefilter passes on its default workloads, and at dbrx-132b width;
3. whole-model parity: full-width qwen3-0.6b, f32 compute, random weights
   from one seed: prefill of a 64-token prompt and 8 greedy decode steps on
   the card (kernels) and on the CPU (plain versions), same weights;
4. serving, the main path: full-width qwen3-0.6b with bf16 compute through
   ``ServeEngine`` and ``ContinuousBatchingEngine``; every kernel's launch
   count must move by exactly what the path implies;
5. kernel times with CUDA events at the main paths' shapes (device time
   from a CUDA-graph replay; the eager time, launched from Python, is
   logged beside it), beside the plain version's time, one PyTorch library
   call's time where one exists (timed here only; the port never calls it)
   and the least time the card could take (its bound); fused MoE and
   scaled_mm at dbrx-132b width;
6. where a serving step's time goes: a ``ContinuousBatchingEngine`` with
   every slot filled runs decode ticks, and one more prompt is prefilled,
   under ``torch.profiler``; for each it prints the wall-clock of the
   profiled window, the device's busy time and idle share in that same
   window, the launches and the kernels that take the most device time;
7. the tuner, the second main path: ``repro_torch.tune.tune`` ranks
   fused MoE and scaled_mm configs with the roofline predictor for a
   registry TPU and times the top 4 and the default on the card, at the
   tuner's default workloads and at dbrx-132b width; every measured
   config's launched grid must equal its ``grid_shape`` and the launch
   counts must move by exactly (1 + repeats) per measured config.

It prints one ``{"kernels": [...]}`` line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Without CUDA, or without the
``src/repro_torch`` package beside it, it exits non-zero and prints no
result.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
F32_TOL, BF16_TOL = 2e-5, 2e-2
# of max|logit|: f32 sums in another order on the card and on the CPU; the gap
# measured on an H100 is about 1.6e-6 of max|logit|
MODEL_TOL = 1e-4
# of max|ref|: the full-width f32 MoE sums run over D=6144 and F=10752 in
# another order on the card than in cuBLAS; the gap measured on an H100 is
# about 5e-6 of max|ref|
MOE_F32_TOL = 1e-4
SMM_TOL = 1e-2
# published dense peaks: device memory bytes/s; bf16 tensor-core FLOP/s;
# f32 FLOP/s outside the tensor cores; int8 tensor-core ops/s
PEAKS = [
    ("H100 NVL", 3.9e12, 835e12, 60e12, 1670e12),
    ("H100 PCIe", 2.0e12, 756e12, 51e12, 1513e12),
    ("H100", 3.35e12, 989e12, 67e12, 1979e12),  # SXM, "H100 80GB HBM3"
    ("H200", 4.8e12, 989e12, 67e12, 1979e12),
]


def log(msg):
    print(msg, flush=True)


def card_peaks(name):
    for key, bw, bf16, f32, int8 in PEAKS:
        if key in name:
            return {"bytes": bw, "bfloat16": bf16, "float32": f32, "int8": int8}
    raise RuntimeError(f"no published peaks known for {name!r}")


def bound(peaks, nbytes, ops, kind):
    """``(bound_ms, bound_by)``: the larger of moving ``nbytes`` at the
    memory rate and doing ``ops`` at the peak rate of ``kind``."""
    by_bytes, by_ops = 1e3 * nbytes / peaks["bytes"], 1e3 * ops / peaks[kind]
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing ({src / 'repro_torch'})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.fused_moe import kernel as moe_k
    from repro_torch.kernels.rmsnorm import kernel as rms_k
    from repro_torch.kernels.scaled_mm import kernel as smm_k
    from repro_torch.kernels.silu_mul import kernel as silu_k

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    kinds = {"rmsnorm": rms_k, "silu_mul": silu_k, "flash_attention": fa_k}

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # one nvcc per CUDA source, all at once
        builds = [pool.submit(k.library) for k in (fa_k, moe_k, smm_k)]
        x = torch.ones(4, 1024, device=dev, dtype=torch.bfloat16)
        rms_k.rmsnorm_cuda(x, torch.zeros(1024, device=dev))
        silu_k.silu_mul_cuda(x, x)
        for b in builds:
            b.result()
    torch.cuda.synchronize()
    log(f"[1 build] nvcc + triton: {time.perf_counter() - t0:.1f}s")

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    max_err = kernel_parity(torch, dev)
    max_err.update(tuner_kernel_parity(torch, dev))
    log(f"[2 kernel parity] passed in {time.perf_counter() - t0:.1f}s; "
        f"max abs err at main-path shapes: {max_err}")

    # ---------------------------------------------------------------- 3
    t0 = time.perf_counter()
    params = model_parity(torch, dev)
    log(f"[3 model parity] passed in {time.perf_counter() - t0:.1f}s")

    # ---------------------------------------------------------------- 4
    t0 = time.perf_counter()
    launches = serve(torch, dev, params, kinds)
    log(f"[4 serve] passed in {time.perf_counter() - t0:.1f}s; launches {launches}")

    # ---------------------------------------------------------------- 5
    t0 = time.perf_counter()
    rows = kernel_times(torch, dev, peaks)
    log(f"[5 kernel times] done in {time.perf_counter() - t0:.1f}s")

    # ---------------------------------------------------------------- 6
    t0 = time.perf_counter()
    where_time_goes(torch, dev, params)
    del params
    torch.cuda.empty_cache()
    log(f"[6 where the time goes] done in {time.perf_counter() - t0:.1f}s")

    # ---------------------------------------------------------------- 7
    t0 = time.perf_counter()
    launches.update(tuner(torch, dev))
    log(f"[7 tuner] passed in {time.perf_counter() - t0:.1f}s; launches "
        f"{ {k: launches[k] for k in ('fused_moe', 'scaled_mm')} }")

    sources = {
        "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm/_triton.py",
                    "src/repro/kernels/rmsnorm/kernel.py:13"),
        "silu_mul": ("triton", "src/repro_torch/kernels/silu_mul/_triton.py",
                     "src/repro/kernels/silu_mul/kernel.py:13"),
        "flash_attention": ("cuda", "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:30"),
        "fused_moe": ("cuda", "src/repro_torch/kernels/fused_moe/csrc/fused_moe.cu",
                      "src/repro/kernels/fused_moe/kernel.py:27"),
        "scaled_mm": ("cuda", "src/repro_torch/kernels/scaled_mm/csrc/scaled_mm.cu",
                      "src/repro/kernels/scaled_mm/kernel.py:20"),
    }
    kernels = []
    for k, (route, source, replaces) in sources.items():
        kernels.append({
            "name": k, "route": route, "source": source, "replaces": replaces,
            "launches": launches[k], "max_abs_err": max_err[k], **rows[k],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ======================================================================
# phase 2: each kernel against its plain version on the card
# ======================================================================


def kernel_parity(torch, dev):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.silu_mul.kernel import silu_mul_cuda
    from repro_torch.kernels.silu_mul.ref import silu_mul_ref

    rng = np.random.default_rng(SEED)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(shape, dtype, scale=1.0):
        a = (scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)

    def check(label, kname, out, ref, dtype, main):
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = F32_TOL if dtype == f32 else BF16_TOL
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"{label}: {m}")
        log(f"  {label}: max abs err {err:.3g} (tol {tol})")
        if main:
            max_err[kname] = max(max_err[kname], err)

    max_err = {"rmsnorm": 0.0, "silu_mul": 0.0, "flash_attention": 0.0}
    for shape, xd, wd, main in [
        ((8192, 1024), bf16, f32, True), ((8192, 1024), bf16, bf16, True),
        ((8192 * 16, 128), bf16, bf16, True), ((8192, 1024), f32, f32, False),
        ((2, 7, 48), f32, f32, False), ((2, 7, 48), bf16, bf16, False),
    ]:
        x, w = randn(shape, xd), randn(shape[-1:], wd, 0.1)
        check(f"rmsnorm {shape} x={xd} w={wd}", "rmsnorm", rmsnorm_cuda(x, w),
              rmsnorm_ref(x, w), xd, main)
    for shape, dt, main in [((8192, 3072), bf16, True), ((8192, 3072), f32, False),
                            ((4, 32, 64), f32, False)]:
        for act in ("silu", "geglu"):
            g, u = randn(shape, dt, 3.0), randn(shape, dt)
            check(f"silu_mul {shape} {act} {dt}", "silu_mul", silu_mul_cuda(g, u, act=act),
                  silu_mul_ref(g, u, act=act), dt, main and act == "silu")
    fa_cases = [
        # (B, S, Skv, Hq, Hkv, D, causal, window, softcap, dtype, main path)
        (4, 2048, 2048, 16, 8, 128, True, None, None, bf16, True),
        (4, 2048, 2048, 16, 8, 128, True, None, None, f32, False),
        (1, 1000, 1000, 16, 8, 128, True, None, None, bf16, True),
        (2, 512, 512, 16, 8, 128, True, 256, None, bf16, False),
        (2, 512, 512, 16, 8, 128, True, None, 50.0, bf16, False),
        (2, 512, 512, 16, 8, 128, False, None, None, bf16, False),
        (1, 32, 128, 2, 2, 16, False, None, None, f32, False),
        (1, 64, 64, 2, 1, 16, True, 32, None, f32, False),
        (2, 128, 128, 4, 2, 32, True, None, None, f32, False),
    ]
    for B, S, Skv, Hq, Hkv, D, causal, window, softcap, dt, main in fa_cases:
        q, k, v = randn((B, S, Hq, D), dt), randn((B, Skv, Hkv, D), dt), randn((B, Skv, Hkv, D), dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        out = flash_attention_cuda(q, k, v, **kw)
        ref = attention_ref(q, k, v, **kw)
        check(f"flash_attention B{B} S{S} Skv{Skv} H{Hq}/{Hkv} D{D} causal={causal} "
              f"window={window} softcap={softcap} {dt}", "flash_attention", out, ref, dt, main)
    return max_err


def tuner_kernel_parity(torch, dev):
    """Fused MoE and scaled_mm against their plain versions: the reference's
    test cases, every config the tuner's prefilter passes on its default
    workloads (on the tuner's own inputs), and dbrx-132b width."""
    from repro_torch.kernels.fused_moe import kernel as moe_k
    from repro_torch.kernels.fused_moe import ops as moe_ops
    from repro_torch.kernels.fused_moe.ref import fused_moe_ref
    from repro_torch.kernels.scaled_mm import kernel as smm_k
    from repro_torch.kernels.scaled_mm import ops as smm_ops
    from repro_torch.kernels.scaled_mm.ref import quantize_rowwise, scaled_mm_acc_ref, scaled_mm_ref
    from repro_torch.tune import (DEFAULT_WORKLOADS, arch_workload, enumerate_candidates,
                                  make_inputs, prefilter)

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = {"fused_moe": 0.0, "scaled_mm": 0.0}

    def randn(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    def moe(label, kw, blocks, args, rel_tol=None, main=False):
        """One launch against the plain version: within the reference's
        tolerances, or within ``rel_tol`` of max|ref| where given."""
        out = moe_k.fused_moe_cuda(*args, **blocks)
        assert moe_k.last_grid == moe_ops.grid_shape(**kw, **blocks), (label, moe_k.last_grid)
        ref = fused_moe_ref(*args)
        torch.cuda.synchronize()
        assert out.dtype == args[0].dtype and bool(torch.isfinite(out).all()), label
        err = float((out.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if rel_tol is None:
            tol = F32_TOL if out.dtype == f32 else BF16_TOL
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol,
                                       msg=lambda m: f"{label}: {m}")
            log(f"  {label}: max abs err {err:.3g} (tol {tol})")
        else:
            log(f"  {label}: max abs err {err:.3g} = {err / scale:.3g} of max|ref| {scale:.4g} "
                f"(tol {rel_tol} of it)")
            assert err <= rel_tol * scale, f"{label}: card and plain version disagree"
        if main:
            max_err["fused_moe"] = max(max_err["fused_moe"], err)

    def smm(label, kw, blocks, args, main=False):
        """One launch against the plain version; the int32 sum is read
        through unit scales into f32, exact while |acc| < 2**24."""
        x, w, sx, sw = args
        out = smm_k.scaled_mm_cuda(x, w, sx, sw, **blocks)
        assert smm_k.last_grid == smm_ops.grid_shape(**kw, **blocks), (label, smm_k.last_grid)
        unit = smm_k.scaled_mm_cuda(x, w, torch.ones_like(sx), torch.ones_like(sw),
                                    out_dtype=f32, **blocks)
        acc = scaled_mm_acc_ref(x, w)
        ref = scaled_mm_ref(x, w, sx, sw)
        torch.cuda.synchronize()
        assert int(acc.abs().max()) < 2**24 and torch.equal(unit, acc.float()), f"{label}: int32 sum"
        err = float((out.float() - ref.float()).abs().max())
        torch.testing.assert_close(out.float(), ref.float(), rtol=SMM_TOL, atol=SMM_TOL,
                                   msg=lambda m: f"{label}: {m}")
        if main:
            max_err["scaled_mm"] = max(max_err["scaled_mm"], err)
        return torch.equal(out, ref), err

    # the reference's cases (tests/test_kernels.py), f32 and bf16
    for E, C, D, F, bm, bf in [(4, 32, 64, 128, 16, 64), (2, 64, 32, 64, 32, 32),
                               (8, 16, 48, 96, 16, 96), (3, 100, 200, 300, 50, 150)]:
        for dt in (f32, bf16):
            args = (randn((E, C, D), dt, 0.5), randn((E, D, F), dt, 0.1),
                    randn((E, D, F), dt, 0.1), randn((E, F, D), dt, 0.1))
            moe(f"fused_moe E{E} C{C} D{D} F{F} bm{bm} bf{bf} {dt}", dict(E=E, C=C, D=D, F=F),
                dict(block_m=bm, block_f=bf), args)
    for M, K, N in [(64, 128, 96), (128, 64, 128)]:
        x, sx = quantize_rowwise(randn((M, K), f32))
        wq, sw = quantize_rowwise(randn((N, K), f32))
        for bm, bn, bk in [(32, 32, 64), (64, 64, 32)]:
            same, err = smm(f"scaled_mm M{M} K{K} N{N}", dict(M=M, K=K, N=N),
                            dict(block_m=bm, block_n=bn, block_k=bk), (x, wq.t().contiguous(), sx, sw))
            log(f"  scaled_mm M{M} K{K} N{N} blocks ({bm}, {bn}, {bk}): int32 sum exact, "
                f"max abs err {err:.3g} (tol {SMM_TOL}), bf16 output bit-equal: {same}")

    # the tuner's default workloads, every config its prefilter passes
    for kernel in ("fused_moe", "scaled_mm"):
        kw = DEFAULT_WORKLOADS[kernel]
        survivors, _ = prefilter(kernel, kw, enumerate_candidates(kernel))
        args = make_inputs(kernel, kw, device="cuda")
        equal, worst = 0, 0.0
        for c in survivors:
            label = f"{kernel} {kw} {c.blocks}"
            if kernel == "fused_moe":
                moe(label, kw, c.blocks, args, rel_tol=MOE_F32_TOL, main=True)
            else:
                same, err = smm(label, kw, c.blocks, args, main=True)
                equal, worst = equal + same, max(worst, err)
        if kernel == "scaled_mm":
            log(f"  scaled_mm {kw}: {len(survivors)} configs, int32 sums exact, max abs err "
                f"{worst:.3g}, bf16 output bit-equal in {equal} of {len(survivors)}")
        del args

    # dbrx-132b width: the default blocks and two others
    kw = arch_workload("fused_moe", "dbrx-132b")
    E, C, D, F = (kw[k] for k in "ECDF")
    for dt in (f32, bf16):
        args = (randn((E, C, D), dt), randn((E, D, F), dt, D ** -0.5),
                randn((E, D, F), dt, D ** -0.5), randn((E, F, D), dt, F ** -0.5))
        for blocks in ({}, dict(block_m=512, block_f=512), dict(block_m=32, block_f=64)):
            moe(f"fused_moe {kw} {blocks or 'default blocks'} {dt}", kw, blocks, args,
                rel_tol=MOE_F32_TOL if dt == f32 else BF16_TOL, main=True)
        del args
        torch.cuda.empty_cache()
    kw = arch_workload("scaled_mm", "dbrx-132b")
    args = make_inputs("scaled_mm", kw, device="cuda")
    for blocks in ({}, dict(block_m=512, block_n=512, block_k=512),
                   dict(block_m=32, block_n=64, block_k=32)):
        same, err = smm(f"scaled_mm {kw} {blocks}", kw, blocks, args, main=True)
        log(f"  scaled_mm {kw} {blocks or 'default blocks'}: int32 sum exact, max abs err "
            f"{err:.3g} (tol {SMM_TOL}), bf16 output bit-equal: {same}")
    return max_err


# ======================================================================
# phase 3: full-width model on the card against the CPU
# ======================================================================


def model_parity(torch, dev):
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_arch("qwen3-0.6b"), compute_dtype="float32")
    gpu, cpu = build_model(cfg, "cuda"), build_model(cfg, "cpu")
    params = gpu.init(SEED)
    n = sum(p.numel() for p in params.parameters())
    log(f"  qwen3-0.6b full width: {n / 1e9:.3f}B parameters, f32 compute")
    params_cpu = T.Tree(T.tree_map(lambda a: a.detach().cpu(), params))
    prompt = np.random.default_rng(SEED).integers(1, cfg.vocab_size, (1, 64))

    def greedy(logits):
        return logits[:, : cfg.vocab_size].argmax(-1)

    def run(api, p, device, forced=None):
        toks = torch.from_numpy(prompt).to(device)
        with torch.no_grad():
            logits, caches = api.prefill(p, {"tokens": toks})
            caches = T.pad_cache(caches, cfg, 64 + 8)
            steps = [logits.float().cpu()]
            for i in range(8):
                tok = forced[i] if forced is not None else greedy(steps[-1])
                pos = torch.full((1,), 64 + i, device=device)
                logits, caches = api.decode(p, caches, tok.to(device), pos)
                steps.append(logits.float().cpu())
        return steps

    on_gpu = run(gpu, params, dev)
    forced = [greedy(s) for s in on_gpu[:-1]]  # the CPU follows the card's tokens
    on_cpu = run(cpu, params_cpu, "cpu", forced)
    for i, (a, b) in enumerate(zip(on_gpu, on_cpu)):
        assert torch.isfinite(a).all() and a.shape == (1, cfg.padded_vocab)
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        what = "prefill" if i == 0 else f"decode {i}"
        log(f"  {what}: max|logit| {scale:.4g}, max abs diff {err:.3g} "
            f"(tol {MODEL_TOL} x {scale:.4g})")
        assert err <= MODEL_TOL * scale, f"{what}: card and CPU logits disagree"
        ta, tb = int(greedy(a)), int(greedy(b))
        if ta != tb:
            top2 = b[0, : cfg.vocab_size].topk(2).values
            gap = float(top2[0] - top2[1])
            log(f"  {what}: greedy tokens differ ({ta} vs {tb}); CPU top-2 gap {gap:.3g}")
            assert gap <= 2 * MODEL_TOL * scale, f"{what}: greedy tokens differ beyond a tie"
    log(f"  greedy tokens on the card: {[int(greedy(s)) for s in on_gpu]}")
    del params_cpu
    return params


# ======================================================================
# phase 4: the main path, serving at full width
# ======================================================================


class StepLog:
    """Trace recorder for the engines (duck-typed): one entry per step,
    stamped with its wall-clock after a device sync."""

    def __init__(self):
        self.steps = []

    def record_step(self, name, cfg, B, q, kv, phase, active=None):
        self.steps.append({"phase": phase, "B": B, "q": q, "kv": kv,
                           "active": B if active is None else active})

    def mark_measured(self, seconds):
        self.steps[-1]["s"] = seconds

    def count(self, phase):
        return sum(1 for s in self.steps if s["phase"] == phase)


def serve(torch, dev, params, kinds):
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request, ServeEngine

    cfg = get_arch("qwen3-0.6b")  # bf16 compute, f32 parameters
    n = cfg.n_layers
    per_forward = {"rmsnorm": 4 * n + 1, "silu_mul": n}
    rng = np.random.default_rng(SEED)
    lens = rng.integers(512, 2049, 16)
    prompts = [rng.integers(1, cfg.vocab_size, int(L)) for L in lens]
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def check_finite(runner):
        inner = runner.sample

        def sample(logits, temperatures, generator):
            nonlocal finite
            finite = finite & torch.isfinite(logits).all()
            return inner(logits, temperatures, generator)

        runner.sample = sample

    engines = [
        ("ServeEngine(max_batch=4)",
         ServeEngine(cfg, params=params, max_batch=4, recorder=StepLog(), device="cuda"),
         prompts[:8]),
        ("ContinuousBatchingEngine(slots=4, max_len=4096)",
         ContinuousBatchingEngine(cfg, params=params, slots=4, max_len=4096,
                                  recorder=StepLog(), device="cuda"),
         prompts[8:]),
    ]
    for _, eng, _ in engines:
        check_finite(eng._runner)
    torch.cuda.synchronize()
    for k in kinds.values():
        k.launches = 0
    totals = {k: 0 for k in kinds}
    for label, eng, ps in engines:
        before = {k: m.launches for k, m in kinds.items()}
        for i, p in enumerate(ps):
            eng.submit(Request(rid=i, prompt=p, max_new=32))
        t0 = time.perf_counter()
        if isinstance(eng, ServeEngine):
            results = []
            while eng.queue:
                results += eng.step_batch()
        else:
            results = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = {k: m.launches - before[k] for k, m in kinds.items()}
        rec = eng.recorder
        n_pre, n_dec = rec.count("prefill"), rec.count("decode")
        expect = {
            "rmsnorm": per_forward["rmsnorm"] * (n_pre + n_dec),
            "silu_mul": per_forward["silu_mul"] * (n_pre + n_dec),
            "flash_attention": n * n_pre,  # decode attention stays on the plain path
        }
        assert moved == expect, f"{label}: launches {moved}, expected {expect}"
        assert sorted(r.rid for r in results) == list(range(len(ps)))
        for r in results:
            assert len(r.tokens) == 32 and all(0 <= t < cfg.vocab_size for t in r.tokens)
        pre = [s for s in rec.steps if s["phase"] == "prefill"]
        dec = [s for s in rec.steps if s["phase"] == "decode"]
        pre_tok = sum(s["B"] * s["q"] for s in pre)
        dec_tok = sum(s["active"] for s in dec)
        pre_s, dec_s = sum(s["s"] for s in pre), sum(s["s"] for s in dec)
        log(f"  {label}: {len(results)} requests, prompts {sorted(len(p) for p in ps)}, "
            f"{n_pre} prefills + {n_dec} decode steps in {wall:.2f}s; launches {moved}")
        log(f"    prefill {pre_tok} tokens (padded) in {pre_s:.3f}s = {pre_tok / pre_s:.0f} tok/s; "
            f"median prefill step {1e3 * float(np.median([s['s'] for s in pre])):.1f} ms")
        log(f"    decode {dec_tok} tokens in {dec_s:.3f}s = {dec_tok / dec_s:.0f} tok/s; "
            f"median decode step {1e3 * float(np.median([s['s'] for s in dec])):.2f} ms")
        for k in totals:
            totals[k] += moved[k]
    assert all(v > 0 for v in totals.values()), totals
    assert bool(finite), "non-finite logits on the serving path"
    return totals


# ======================================================================
# phase 5: kernel times
# ======================================================================


def cuda_ms(torch, fn, inputs, iters):
    """Mean milliseconds of one ``fn(*inputs[i % len(inputs)])`` on the
    device, and the same through eager launches: ``(device_ms, eager_ms)``.

    The device time replays ``iters`` calls captured in one CUDA graph, so
    the host's launch overhead is left out; the eager time launches them
    from Python between the same CUDA events, as the model does, and is
    above the device time wherever the host cannot keep up. Rotating inputs
    larger than the L2 cache makes every call read from device memory, as
    the model's calls do. Both follow a warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up (and Triton's compile) off the capture
        for a in inputs[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    device = start.elapsed_time(end) / iters
    del graph
    return device, eager


def kernel_times(torch, dev, peaks):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.fused_moe.kernel import fused_moe_cuda
    from repro_torch.kernels.fused_moe.ref import fused_moe_ref
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.scaled_mm.kernel import scaled_mm_cuda
    from repro_torch.kernels.scaled_mm.ref import scaled_mm_ref
    from repro_torch.kernels.silu_mul.kernel import silu_mul_cuda
    from repro_torch.kernels.silu_mul.ref import silu_mul_ref
    from repro_torch.tune import arch_workload

    bf16, f32 = torch.bfloat16, torch.float32
    bw = peaks["bytes"]
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0, dtype=bf16):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    rows, eager = {}, {}

    def row(kname, kernel, plain, library, inputs, iters, bound_ms, bound_by):
        """Device times of the kernel, its plain version and the library
        call (``library = (fn, inputs)`` or None); eager times are logged."""
        ms, eager[kname] = cuda_ms(torch, kernel, inputs, iters)
        plain_ms, eager[kname + " plain"] = cuda_ms(torch, plain, inputs, max(2, iters // 4))
        library_ms = None
        if library is not None:
            library_ms, eager[kname + " library"] = cuda_ms(torch, library[0], library[1], iters)
        rows[kname] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": library_ms}

    # rmsnorm: the layer norms of a 4 x 2048-token prefill, (8192, 1024) bf16
    R, d = 8192, 1024
    xs = [(randn(R, d), randn(d, scale=0.1)) for _ in range(8)]  # 8 x 16 MiB > L2
    row("rmsnorm", rmsnorm_cuda, rmsnorm_ref,
        (lambda x, w: F.rms_norm(x, (d,), w, 1e-6), [(x, 1.0 + w) for x, w in xs]),
        xs, 200, 1e3 * (2 * R * d * 2 + d * 2) / bw, "bytes")
    qk = [(randn(R * 16, 128), randn(128, scale=0.1)) for _ in range(2)]
    qk_ms, qk_eager = cuda_ms(torch, rmsnorm_cuda, qk, 100)
    log(f"  rmsnorm (131072, 128) bf16 (q norm): {qk_ms:.4f} ms (eager {qk_eager:.4f}), "
        f"bound {1e3 * (2 * R * 16 * 128 * 2) / bw:.4f} ms")
    # silu_mul: gate and up of the same prefill, (8192, 3072) bf16
    F_ = 3072
    gs = [(randn(R, F_, scale=3.0), randn(R, F_)) for _ in range(2)]
    row("silu_mul", silu_mul_cuda, silu_mul_ref, None, gs, 200,
        1e3 * (3 * R * F_ * 2) / bw, "bytes")
    # flash attention: causal prefill B=4, S=2048, 16/8 heads of 128, bf16
    B, S, Hq, Hkv, D = 4, 2048, 16, 8, 128
    q, k, v = randn(B, S, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    pairs = B * Hq * S * (S + 1) // 2  # (query, key) pairs the causal mask keeps
    flops = 4 * D * pairs
    nbytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(a, b, c, is_causal=True, enable_gqa=True)
    row("flash_attention", lambda a, b, c: flash_attention_cuda(a, b, c, causal=True),
        lambda a, b, c: attention_ref(a, b, c, causal=True), (sdpa, [(qt, kt, vt)]),
        [(q, k, v)], 20, *bound(peaks, nbytes, flops, "bfloat16"))
    log(f"  flash_attention causal work: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB")
    del q, k, v, qt, kt, vt

    # fused MoE at dbrx-132b width, default blocks: f32 (the tuner's inputs,
    # the JSON row) and bf16; library yardstick: three bmm's with silu * mul
    E, C, D, Fm = (arch_workload("fused_moe", "dbrx-132b")[k] for k in "ECDF")

    def bmm_moe(x, wg, wu, wd):
        return torch.bmm(F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd)

    for kname, dt in (("fused_moe", f32), ("fused_moe bf16", bf16)):
        args = (randn(E, C, D, dtype=dt), randn(E, D, Fm, scale=D ** -0.5, dtype=dt),
                randn(E, D, Fm, scale=D ** -0.5, dtype=dt), randn(E, Fm, D, scale=Fm ** -0.5, dtype=dt))
        nbytes = args[0].element_size() * (2 * E * C * D + 3 * E * D * Fm)
        row(kname, fused_moe_cuda, fused_moe_ref, (bmm_moe, [args]), [args], 2,
            *bound(peaks, nbytes, 6 * E * C * D * Fm, "float32" if dt == f32 else "bfloat16"))
        log(f"  fused_moe E{E} C{C} D{D} F{Fm} {dt}: {6 * E * C * D * Fm / 1e12:.4f} TFLOP, "
            f"{nbytes / 1e9:.2f} GB")
        del args
        torch.cuda.empty_cache()

    # scaled_mm at dbrx-132b width (its FFN projection), default blocks, bf16
    # out; library yardstick: torch._int_mm and the same epilogue
    M, K, N = (arch_workload("scaled_mm", "dbrx-132b")[k] for k in "MKN")

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def scales(n):
        return 0.5 + 1.5 * torch.rand(n, generator=gen, device=dev)

    def int_mm(x, w, sx, sw):
        return (torch._int_mm(x, w).float() * sx[:, None] * sw[None, :]).to(bf16)

    smm_args = [(int8(M, K), int8(K, N), scales(M), scales(N)) for _ in range(2)]  # 2 x 72 MB > L2
    nbytes = M * K + K * N + 4 * (M + N) + 2 * M * N
    row("scaled_mm", scaled_mm_cuda, scaled_mm_ref, (int_mm, smm_args), smm_args, 10,
        *bound(peaks, nbytes, 2 * M * K * N, "int8"))
    log(f"  scaled_mm M{M} K{K} N{N}: {2 * M * K * N / 1e12:.4f} Tops, {nbytes / 1e6:.1f} MB")
    for kname, r in rows.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {kname}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library {lib}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']})")
    log("  eager launches from Python, ms a call: "
        + ", ".join(f"{k} {v:.4f}" for k, v in eager.items()))
    return rows


# ======================================================================
# phase 6: where a serving step's time goes
# ======================================================================


def profiled(torch, fn, steps):
    """Run ``fn`` ``steps`` times under ``torch.profiler``. Per step: the
    wall-clock of the profiled window (ended by a device sync), the device's
    busy time in that window (the union of its kernels and copies), the
    idle share left, the launches, and the kernels taking the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    work = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, -float("inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in work):
        if e > end:
            busy += e - max(s, end)
            end = e
    assert work, "the profiler saw no device work"
    busy_ms = busy / 1e3 / steps
    by_name = {}
    for e in work:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "launches": len(work) / steps,
            "top": [(name[:90], n / steps, us / 1e3 / steps) for name, (n, us) in top]}


def where_time_goes(torch, dev, params):
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request

    cfg = get_arch("qwen3-0.6b")  # bf16 compute, as served in phase 4
    slots, prompt_len, ticks, warm = 4, 1024, 8, 3
    eng = ContinuousBatchingEngine(cfg, params=params, slots=slots, max_len=4096, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len) for _ in range(slots + 1)]
    for i, p in enumerate(prompts[:-1]):  # room for every tick below, so no slot retires
        eng.submit(Request(rid=i, prompt=p, max_new=warm + 2 * ticks + 2))
    batch = {"tokens": torch.as_tensor(prompts[-1][None, :], device=dev)}

    def prefill():
        eng._runner.prefill(batch)

    for _ in range(warm):  # the first tick admits (prefills) every slot
        eng.step()
    prefill()
    torch.cuda.synchronize()
    for label, fn, steps in ((f"decode tick ({slots} slots, {prompt_len}-token prompts)", eng.step, ticks),
                             (f"prefill (1 x {prompt_len} tokens)", prefill, 3)):
        walls = []
        for _ in range(steps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        r = profiled(torch, fn, steps)
        log(f"  {label}: profiled wall {r['wall_ms']:.3f} ms, device busy {r['busy_ms']:.3f} ms "
            f"(idle {100 * r['idle_share']:.1f}%), {r['launches']:.0f} launches; "
            f"unprofiled wall {float(np.median(walls)):.3f} ms")
        for name, n, ms in r["top"]:
            log(f"    {ms:9.4f} ms  x{n:<6g} {name}")


# ======================================================================
# phase 7: the tuner
# ======================================================================


def tuner(torch, dev):
    """``tune()`` on the card for fused MoE and scaled_mm, at the tuner's
    default workloads and at dbrx-132b width, ranked with the roofline
    predictor of a registry TPU. The predictions price that TPU; the times
    are the H100's, and their rank correlation is logged, not judged."""
    from repro_torch.analysis.kernels import check_blocks
    from repro_torch.core.hardware import REGISTRY
    from repro_torch.kernels.fused_moe import kernel as moe_k
    from repro_torch.kernels.fused_moe import ops as moe_ops
    from repro_torch.kernels.scaled_mm import kernel as smm_k
    from repro_torch.kernels.scaled_mm import ops as smm_ops
    from repro_torch.predict.backends import get_predictor
    from repro_torch.tune import DEFAULT_WORKLOADS, arch_workload, make_inputs, measure, tune
    from repro_torch.tune.__main__ import report_lines

    hw = REGISTRY["tpu-v4"]
    predictor = get_predictor("roofline", hw)
    kernels = {"fused_moe": (moe_k, moe_ops), "scaled_mm": (smm_k, smm_ops)}
    runs = [(k, kw) for k in kernels
            for kw in (DEFAULT_WORKLOADS[k], arch_workload(k, "dbrx-132b"))]
    repeats = 3
    inputs = [make_inputs(k, kw, device="cuda") for k, kw in runs]  # the tuner's inputs
    torch.cuda.synchronize()
    for mod, _ in kernels.values():
        mod.launches = 0
    for (kernel, kw), args in zip(runs, inputs):
        mod, ops = kernels[kernel]
        grids = []

        def timed(kernel, kw, blocks, *, args=None, repeats, device, _args=args, _mod=mod):
            s = measure(kernel, kw, blocks, args=_args, repeats=repeats, device=device)
            grids.append((dict(blocks), _mod.last_grid))
            return s

        before = mod.launches
        t0 = time.perf_counter()
        report = tune(kernel, hw, workload=kw, predictor=predictor, predictor_name="roofline",
                      top_k=4, repeats=repeats, device="cuda", measure_fn=timed)
        wall = time.perf_counter() - t0
        for line in report_lines(report):
            log("  " + line)
        distinct = {tuple(sorted(c.blocks.items())) for c in report.measured}
        distinct.add(tuple(sorted(report.default_blocks.items())))
        moved = mod.launches - before
        assert moved == (1 + repeats) * len(distinct) == (1 + repeats) * len(grids), (
            f"{kernel} {kw}: {moved} launches for {len(distinct)} configs")
        for blocks, grid in grids:
            assert grid == ops.grid_shape(**kw, **blocks), (kernel, kw, blocks, grid)
        assert not report.interpret and report.t_default > 0
        assert all(0 < c.measured_s < float("inf") for c in report.measured)
        assert not check_blocks(kernel, kw, report.best.blocks)
        log(f"    {len(grids)} configs measured in {wall:.1f}s, {moved} launches, every launched "
            f"grid equal to grid_shape")
    del inputs
    torch.cuda.empty_cache()
    launches = {k: mod.launches for k, (mod, _) in kernels.items()}
    assert all(v > 0 for v in launches.values()), launches
    return launches


if __name__ == "__main__":
    sys.exit(main())
