"""Binding of the Hopper fused-MoE kernel (``csrc/fused_moe.cu``).

Replaces ``_moe_kernel`` / ``fused_moe_pallas`` of
``repro/kernels/fused_moe/kernel.py``; the source file's head says what
bounds the kernel and how it is laid out. The library is compiled with
``nvcc`` for ``sm_90a`` at first use (``kernels._build``) and called through
ctypes on PyTorch's current stream. A failed build or launch raises.

``launch_plan`` computes both launches' geometry in Python, so the CPU
tests reach it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels._build import load_cuda_library

#: kernel launches since the count was last set to 0 (one a wrapper call,
#: which launches the gate/up and the down kernels)
launches = 0
#: ``(E, C/block_m, F/block_f)`` of the last launch: the gate/up launch's
#: grid; the down launch covers ``(E, C/block_m, ceil(D/128))`` output tiles
#: and walks the ``F/block_f`` steps in order
last_grid: tuple | None = None

SOURCES = [Path(__file__).resolve().parent / "csrc" / "fused_moe.cu"]
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
D_TILE = 128  # output columns of a down-launch CTA
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class LaunchPlan(NamedTuple):
    grid: tuple  # (E, C/bm, F/bf): the gate/up grid, the reference's grid_shape
    down_grid: tuple  # (E, C/bm, ceil(D/128)): the down launch's output tiles
    block_m: int  # rows a CTA owns (clamped to C)
    block_f: int  # F columns of a gate/up CTA and F per summation step (clamped to F)
    sub_rows: int  # rows a CTA computes at a time: 32, 64 or 128


def launch_plan(E: int, C: int, D: int, F: int, *, block_m: int = 128,
                block_f: int = 256) -> LaunchPlan:
    """The two launches' geometry for these shapes and knobs, after the
    reference's ``min(block, dim)`` clamp; raises where a block does not
    divide its dimension, as the reference's ``grid_shape`` does."""
    bm, bf = min(block_m, C), min(block_f, F)
    if bm <= 0 or bf <= 0 or C % bm or F % bf:
        raise ValueError(f"fused_moe_cuda: C={C} % block_m={bm} or F={F} % block_f={bf} != 0")
    sub_rows = 32 if bm <= 32 else 64 if bm <= 64 else 128
    return LaunchPlan((E, C // bm, F // bf), (E, C // bm, -(-D // D_TILE)), bm, bf, sub_rows)


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's library."""
    lib = load_cuda_library("fused_moe", SOURCES)
    lib.fused_moe_forward.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.fused_moe_forward.restype = ctypes.c_int
    lib.fused_moe_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
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
    """Launch the kernels: ``(silu(x Wg) * (x Wu)) Wd`` per expert, in x's type."""
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
    out = torch.empty_like(x)
    if x.numel() == 0 or F == 0:
        return out
    plan = launch_plan(E, C, D, F, block_m=block_m, block_f=block_f)
    lib = library()
    code = _DTYPE_CODE[x.dtype]
    smem = lib.fused_moe_smem_bytes(code, plan.sub_rows // 32)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fused_moe_cuda: {plan} needs {smem} bytes of shared memory a block, "
            f"more than {SMEM_LIMIT}"
        )
    h = torch.empty((E, C, F), dtype=x.dtype, device=x.device)  # silu(x Wg) * (x Wu)
    size = x.element_size()
    vec = all(t.data_ptr() % 16 == 0 for t in (*ts, h, out)) and all(
        n * size % 16 == 0 for n in (D, F, plan.block_f)
    )
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fused_moe_forward(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
            h.data_ptr(), out.data_ptr(), code, E, C, D, F, plan.block_m, plan.block_f,
            plan.sub_rows // 32, int(vec), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_moe_cuda: launch failed with cudaError {err}")
    launches += 1
    last_grid = plan.grid
    return out
