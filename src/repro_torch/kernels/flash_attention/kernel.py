"""Binding of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``_fa_kernel`` / ``flash_attention_pallas`` of
``repro/kernels/flash_attention/kernel.py``; the source file's head says
what bounds the kernel and how it is laid out. The library is compiled with
``nvcc`` for ``sm_90a`` at first use (``kernels._build``) and called through
ctypes on PyTorch's current stream. A failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels._build import load_cuda_library

#: kernel launches since the count was last set to 0
launches = 0

SOURCES = [Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"]
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's library."""
    lib = load_cuda_library("flash_attention", SOURCES)
    fn = lib.fa_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    global launches
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: q, k, v must be CUDA tensors on one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention_cuda: types {q.dtype}, {k.dtype}, {v.dtype}; "
            "expected one of float32, bfloat16"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_cuda: shapes {q.shape}, {k.shape}, {v.shape}")
    B, S, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} vs k/v {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda: q, k, v must be contiguous")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention_cuda: window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention_cuda: softcap must be positive, got {softcap}")
    out = torch.empty_like(q)
    if q.numel() == 0 or Skv == 0:
        return out
    fn = library().fa_forward
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype],
            B, S, Skv, Hq, Hkv, D, int(causal), window or 0, float(softcap or 0.0),
            scale if scale is not None else 1.0 / math.sqrt(D), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_cuda: launch failed with cudaError {err}")
    launches += 1
    return out
