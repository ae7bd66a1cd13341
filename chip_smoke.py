#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build: compile the flash-attention CUDA source with nvcc and the Triton
   kernels (rmsnorm, silu_mul), from the sources in this checkout;
2. kernel parity: each kernel against its plain PyTorch version on the
   card, at the reference's test shapes and the main path's shapes
   (f32 2e-5, bf16 2e-2, the reference's kernel tolerances);
3. whole-model parity: full-width qwen3-0.6b, f32 compute, random weights
   from one seed: prefill of a 64-token prompt and 8 greedy decode steps on
   the card (kernels) and on the CPU (plain versions), same weights;
4. serving, the main path: full-width qwen3-0.6b with bf16 compute through
   ``ServeEngine`` and ``ContinuousBatchingEngine``; every kernel's launch
   count must move by exactly what the path implies;
5. kernel times with CUDA events at the main path's shapes (device time
   from a CUDA-graph replay; the eager time, launched from Python, is
   logged beside it), beside the plain version's time, one PyTorch library
   call's time where one exists (timed here only; the port never calls it)
   and the least time the card could take (its bound);
6. where a serving step's time goes: a ``ContinuousBatchingEngine`` with
   every slot filled runs decode ticks, and one more prompt is prefilled,
   under ``torch.profiler``; for each it prints the wall-clock of the
   profiled window, the device's busy time and idle share in that same
   window, the launches and the kernels that take the most device time.

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
# published dense peaks: (device memory bytes/s, bf16 tensor-core FLOP/s)
PEAKS = [
    ("H100 NVL", 3.9e12, 835e12),
    ("H100 PCIe", 2.0e12, 756e12),
    ("H100", 3.35e12, 989e12),  # SXM, "H100 80GB HBM3"
    ("H200", 4.8e12, 989e12),
]


def log(msg):
    print(msg, flush=True)


def card_peaks(name):
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no published peaks known for {name!r}")


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

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.rmsnorm import kernel as rms_k
    from repro_torch.kernels.silu_mul import kernel as silu_k

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    bw, bf16_flops = card_peaks(name)
    kinds = {"rmsnorm": rms_k, "silu_mul": silu_k, "flash_attention": fa_k}

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    fa_k.library()
    x = torch.ones(4, 1024, device=dev, dtype=torch.bfloat16)
    rms_k.rmsnorm_cuda(x, torch.zeros(1024, device=dev))
    silu_k.silu_mul_cuda(x, x)
    torch.cuda.synchronize()
    log(f"[1 build] nvcc + triton: {time.perf_counter() - t0:.1f}s")

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    max_err = kernel_parity(torch, dev)
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
    rows = kernel_times(torch, dev, bw, bf16_flops)
    log(f"[5 kernel times] done in {time.perf_counter() - t0:.1f}s")

    # ---------------------------------------------------------------- 6
    t0 = time.perf_counter()
    where_time_goes(torch, dev, params)
    del params
    torch.cuda.empty_cache()
    log(f"[6 where the time goes] done in {time.perf_counter() - t0:.1f}s")

    sources = {
        "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm/_triton.py",
                    "src/repro/kernels/rmsnorm/kernel.py:13"),
        "silu_mul": ("triton", "src/repro_torch/kernels/silu_mul/_triton.py",
                     "src/repro/kernels/silu_mul/kernel.py:13"),
        "flash_attention": ("cuda", "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:30"),
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


def kernel_times(torch, dev, bw, bf16_flops):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.silu_mul.kernel import silu_mul_cuda
    from repro_torch.kernels.silu_mul.ref import silu_mul_ref

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(bf16)

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
        [(q, k, v)], 20, max(1e3 * flops / bf16_flops, 1e3 * nbytes / bw),
        "operations" if flops / bf16_flops >= nbytes / bw else "bytes")
    log(f"  flash_attention causal work: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB")
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


if __name__ == "__main__":
    sys.exit(main())
