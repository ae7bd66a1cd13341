"""Binding of the Hopper fused-MoE kernel (``csrc/fused_moe.cu``).

Replaces ``_moe_kernel`` / ``fused_moe_pallas`` of
``repro/kernels/fused_moe/kernel.py``; the source file's head says what
bounds the kernel and how it is laid out. The library is compiled with
``nvcc`` for ``sm_90a`` at first use (``kernels._build``) and called through
ctypes on PyTorch's current stream. A failed build or launch raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import load_cuda_library

#: kernel launches since the count was last set to 0
launches = 0
#: ``(E, C/block_m, F/block_f)`` of the last launch: the CUDA grid is
#: ``(C/block_m, E)`` and each CTA walks the ``F/block_f`` axis in order
last_grid: tuple | None = None

SOURCES = [Path(__file__).resolve().parent / "csrc" / "fused_moe.cu"]
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's library."""
    lib = load_cuda_library("fused_moe", SOURCES)
    lib.fused_moe_forward.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.fused_moe_forward.restype = ctypes.c_int
    lib.fused_moe_smem_bytes.argtypes = [ctypes.c_int]
    lib.fused_moe_smem_bytes.restype = ctypes.c_longlong
    return lib


def fused_moe_cuda(
    x: torch.Tensor,  # (E, C, D)
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
    *,
    block_m: int = 128,
    block_f: int = 256,
) -> torch.Tensor:
    """Launch the kernel: ``(silu(x Wg) * (x Wu)) Wd`` per expert, in x's type."""
    global launches, last_grid
    ts = (x, w_gate, w_up, w_down)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("fused_moe_cuda: x and the weights must be CUDA tensors on one device")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for t in ts):
        raise TypeError(
            f"fused_moe_cuda: types {[t.dtype for t in ts]}; expected all float32 or all bfloat16"
        )
    if x.dim() != 3 or w_gate.dim() != 3:
        raise ValueError(f"fused_moe_cuda: x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}")
    E, C, D = x.shape
    F = w_gate.shape[2]
    if w_gate.shape != (E, D, F) or w_up.shape != (E, D, F) or w_down.shape != (E, F, D):
        raise ValueError(
            f"fused_moe_cuda: x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}, "
            f"w_up {tuple(w_up.shape)}, w_down {tuple(w_down.shape)}"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fused_moe_cuda: x and the weights must be contiguous")
    bm, bf = min(block_m, C), min(block_f, F)
    if bm <= 0 or bf <= 0 or C % bm or F % bf:
        raise ValueError(f"fused_moe_cuda: C={C} % block_m={bm} or F={F} % block_f={bf} != 0")
    out = torch.empty_like(x)
    if x.numel() == 0 or F == 0:
        return out
    lib = library()
    smem = lib.fused_moe_smem_bytes(bf)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fused_moe_cuda: block_f={bf} needs {smem} bytes of shared memory a block, "
            f"more than {SMEM_LIMIT}"
        )
    acc = torch.empty((E, C, D), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fused_moe_forward(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
            acc.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype], E, C, D, F, bm, bf, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_moe_cuda: launch failed with cudaError {err}")
    launches += 1
    last_grid = (E, C // bm, F // bf)
    return out
