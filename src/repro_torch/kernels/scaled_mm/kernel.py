"""Binding of the Hopper W8A8 scaled-product kernel (``csrc/scaled_mm.cu``).

Replaces ``_scaled_mm_kernel`` / ``scaled_mm_pallas`` of
``repro/kernels/scaled_mm/kernel.py``; the source file's head says what
bounds the kernel and how it is laid out. The library is compiled with
``nvcc`` for ``sm_90a`` at first use (``kernels._build``) and called through
ctypes on PyTorch's current stream. A failed build or launch raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import largest_divisor_block
from repro_torch.kernels._build import load_cuda_library

#: kernel launches since the count was last set to 0
launches = 0
#: ``(M/bm, N/bn, K/bk)`` of the last launch: the CUDA grid is
#: ``(N/bn, M/bm)`` and each CTA walks the ``K/bk`` axis in order
last_grid: tuple | None = None

SOURCES = [Path(__file__).resolve().parent / "csrc" / "scaled_mm.cu"]
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's library."""
    lib = load_cuda_library("scaled_mm", SOURCES)
    lib.scaled_mm_forward.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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
    bm = largest_divisor_block(M, block_m)
    bn = largest_divisor_block(N, block_n)
    bk = largest_divisor_block(K, block_k)
    lib = library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.scaled_mm_forward(
            x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(),
            _OUT_CODE[out_dtype], M, K, N, bm, bn, bk, stream,
        )
    if err != 0:
        raise RuntimeError(f"scaled_mm_cuda: launch failed with cudaError {err}")
    launches += 1
    last_grid = (M // bm, N // bn, K // bk)
    return out
