"""Binding of the Hopper W8A8 scaled-product kernel (``csrc/scaled_mm.cu``).

Replaces ``_scaled_mm_kernel`` / ``scaled_mm_pallas`` of
``repro/kernels/scaled_mm/kernel.py``; the source file's head says what
bounds the kernel and how it is laid out. The library is compiled with
``nvcc`` for ``sm_90a`` at first use (``kernels._build``) and called through
ctypes on PyTorch's current stream. A failed build or launch raises.

``launch_plan`` computes the launch geometry in Python, so the CPU tests
reach it: the three blocks after the reference's largest-divisor clamp, the
tensor-core sub-tile a CTA walks its block in, the depth and count of its
``cp.async`` stages and their shared memory.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import largest_divisor_block
from repro_torch.kernels._build import load_cuda_library

#: kernel launches since the count was last set to 0
launches = 0
#: ``(M/bm, N/bn, K/bk)`` of the last launch: the CUDA grid is
#: ``(N/bn, M/bm)`` and each CTA walks the ``K/bk`` axis in order
last_grid: tuple | None = None

SOURCES = [Path(__file__).resolve().parent / "csrc" / "scaled_mm.cu"]
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
STAGES = 4  # the cp.async ring's depth (kStages in the source)
W_ROW_BYTES = 128  # bytes of a staged w row, any sub-tile width (kLdb)
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# sub-tile -> warps a CTA: (16 * MI) x 32 outputs a warp (Tile<> in the source)
_WARPS = {128: 8, 64: 4, 32: 2}


class LaunchPlan(NamedTuple):
    grid: tuple  # (M/bm, N/bn, K/bk): the reference's grid_shape
    block_m: int  # rows a CTA owns (largest divisor of M <= block_m)
    block_n: int  # columns a CTA owns
    block_k: int  # k of one step of the CTA's walk over K
    sub_tile: int  # square tensor-core sub-tile the CTA walks its block in
    warps: int  # warps a CTA
    stage_k: int  # k bytes of one cp.async stage: 64, or 32 where block_k <= 32
    stages: int  # stages in the ring
    smem_bytes: int  # dynamic shared memory a CTA
    vectorized: bool  # 16-byte cp.async staging (else byte by byte)


def launch_plan(M: int, K: int, N: int, *, block_m: int = 128, block_n: int = 128,
                block_k: int = 256, out_dtype: torch.dtype = torch.bfloat16) -> LaunchPlan:
    """The kernel's launch geometry for these shapes and knobs. ``vectorized``
    holds where the shapes allow 16-byte staging; the wrapper also asks the
    pointers to be 16-byte aligned."""
    if min(M, K, N) <= 0 or min(block_m, block_n, block_k) <= 0:
        raise ValueError(f"scaled_mm: M={M} K={K} N={N}, blocks ({block_m}, {block_n}, "
                         f"{block_k}) must be positive")
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"scaled_mm: out_dtype {out_dtype} not in {list(_OUT_CODE)}")
    bm = largest_divisor_block(M, block_m)
    bn = largest_divisor_block(N, block_n)
    bk = largest_divisor_block(K, block_k)
    small = min(bm, bn)
    sub = 128 if small >= 128 else 64 if small >= 64 else 32
    ks = 32 if bk <= 32 else 64
    smem = STAGES * (sub * (ks + 16) + ks * W_ROW_BYTES)
    vec = all(n % 16 == 0 for n in (K, N, bn, bk))
    return LaunchPlan((M // bm, N // bn, K // bk), bm, bn, bk, sub, _WARPS[sub], ks, STAGES,
                      smem, vec)


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's library."""
    lib = load_cuda_library("scaled_mm", SOURCES)
    lib.scaled_mm_forward.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_longlong, ctypes.c_void_p]
    )
    lib.scaled_mm_forward.restype = ctypes.c_int
    return lib


def scaled_mm_cuda(
    x: torch.Tensor,  # (M, K) int8
    w: torch.Tensor,  # (K, N) int8
    sx: torch.Tensor,  # (M,)
    sw: torch.Tensor,  # (N,)
    *,
    out_dtype: torch.dtype = torch.bfloat16,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 256,
) -> torch.Tensor:
    """Launch the kernel: ``(float(x @ w) * sx[:, None]) * sw[None, :]``."""
    global launches, last_grid
    if not all(t.is_cuda and t.device == x.device for t in (x, w, sx, sw)):
        raise ValueError("scaled_mm_cuda: x, w, sx, sw must be CUDA tensors on one device")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"scaled_mm_cuda: x {x.dtype}, w {w.dtype}; expected int8")
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"scaled_mm_cuda: out_dtype {out_dtype} not in {list(_OUT_CODE)}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"scaled_mm_cuda: x {tuple(x.shape)}, w {tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    if sx.shape != (M,) or sw.shape != (N,):
        raise ValueError(f"scaled_mm_cuda: sx {tuple(sx.shape)}, sw {tuple(sw.shape)}; M={M}, N={N}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("scaled_mm_cuda: x and w must be contiguous")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    # the reference casts the scales to f32 and never launches a ragged grid
    sx, sw = sx.to(torch.float32).contiguous(), sw.to(torch.float32).contiguous()
    plan = launch_plan(M, K, N, block_m=block_m, block_n=block_n, block_k=block_k,
                       out_dtype=out_dtype)
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"scaled_mm_cuda: {plan} needs {plan.smem_bytes} bytes of shared "
                         f"memory a block, more than {SMEM_LIMIT}")
    vec = plan.vectorized and all(t.data_ptr() % 16 == 0 for t in (x, w, sx, sw, out))
    lib = library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.scaled_mm_forward(
            x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(),
            _OUT_CODE[out_dtype], M, K, N, plan.block_m, plan.block_n, plan.block_k,
            plan.sub_tile, plan.stage_k, int(vec), plan.smem_bytes, stream,
        )
    if err != 0:
        raise RuntimeError(f"scaled_mm_cuda: launch failed with cudaError {err}")
    launches += 1
    last_grid = plan.grid
    return out
