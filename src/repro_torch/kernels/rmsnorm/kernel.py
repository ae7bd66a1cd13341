"""RMSNorm on Hopper, in Triton.

Replaces ``_rmsnorm_kernel`` / ``rmsnorm_pallas`` of
``repro/kernels/rmsnorm/kernel.py``. On the path it normalises every
pre-norm row (d=1024), the q/k heads (d=128) and the final norm.

What bounds it on the card: device-memory bytes. It reads each row once and
writes it once, with a few operations a element, so the bound is
``(2 R d) * itemsize / bandwidth``. The design keeps each row's square sum
in registers (one program holds ``ROWS`` whole rows, padded to a power of
two and masked, so d=48 or d=3072 work as well as d=1024) and loads the
weight once a program. The weight keeps its own type, so an f32 final-norm
weight is not rounded to bf16 before ``1 + w``.

The backward (``rmsnorm_bwd_cuda``) is bound by bytes too: it reads ``x``
and the gradient once and writes ``dx`` once. ``bwd_plan`` gives the
geometry: one program an SM walks a contiguous share of the rows in steps
of ``BWD_TILE`` values (16 KB of x and 16 KB of the gradient in bf16), with
the next steps' loads in flight (Triton's software pipeline over
``tl.range``), writing their ``dx`` and keeping its part of ``dw = sum g x
r`` in registers; a second launch sums those parts in program order, all
of them in one pass, so ``dw`` is the same bits every run (no float
atomics).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels._build import import_triton

#: kernel launches since the count was last set to 0
launches = 0
#: backward calls since the count was last set to 0 (each launches the
#: row pass and the ``dw`` pass)
bwd_launches = 0

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                 block_rows: int = 256) -> torch.Tensor:
    """Launch the kernel on ``x (..., d)`` and ``w (d,)``, both on the card.

    ``block_rows`` caps the rows one program normalises (rounded down to a
    power of two); the kernel also caps them so a program holds about 4096
    values."""
    global launches
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError("rmsnorm_cuda: x and w must be CUDA tensors on one device")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm_cuda: unsupported types {x.dtype}, {w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm_cuda: w has shape {tuple(w.shape)}, expected ({d},)")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_cuda: x and w must be contiguous")
    out = torch.empty_like(x)
    R = x.numel() // d if d else 0
    if R == 0:
        return out
    import_triton()
    from repro_torch.kernels.rmsnorm._triton import rmsnorm_kernel

    block_d = 1 << (d - 1).bit_length()
    rows = _pow2_floor(min(block_rows, max(1, 4096 // block_d)))
    rmsnorm_kernel[((R + rows - 1) // rows,)](
        x, w, out, R, d, eps, ROWS=rows, BLOCK_D=block_d,
        num_warps=4 if rows * block_d <= 2048 else 8,
    )
    launches += 1
    return out


#: values (rows x padded columns) of one step of the backward's row pass
BWD_TILE = 8192
#: programs of the row pass an SM, and the stages of its loads
BWD_PROGRAMS_PER_SM = 1
BWD_STAGES = 3
#: columns of ``dw`` a program of the second pass sums
DW_BLOCK = 32


class BwdPlan(NamedTuple):
    programs: int  # programs of the row pass
    rows_per_program: int  # program p walks rows [p * rows_per_program, + rows_per_program)
    rows: int  # rows of one step
    block_d: int  # columns of a step, ``d`` padded to a power of two
    stages: int  # steps whose loads are in flight
    warps: int
    dw_programs: int  # programs of the ``dw`` pass, ``dw_block`` columns each
    dw_block: int
    dw_rows: int  # partial rows the ``dw`` pass sums at a time


def bwd_plan(R: int, d: int, *, sms: int = 132) -> BwdPlan:
    """The backward's launch geometry for ``R`` rows of ``d`` on a card of
    ``sms`` SMs. Every row falls in exactly one program's share; the last
    share may run past ``R`` (those rows are masked)."""
    if R <= 0 or d <= 0 or sms <= 0:
        raise ValueError(f"rmsnorm backward: R={R}, d={d}, sms={sms}")
    block_d = 1 << (d - 1).bit_length()
    rows = min(_pow2_floor(max(1, BWD_TILE // block_d)), 1 << (R - 1).bit_length())
    steps = -(-R // rows)
    per = rows * -(-steps // min(steps, BWD_PROGRAMS_PER_SM * sms))
    programs = -(-R // per)
    dw_block = min(DW_BLOCK, block_d)
    return BwdPlan(programs, per, rows, block_d, BWD_STAGES, 8, -(-d // dw_block), dw_block,
                   min(1 << (programs - 1).bit_length(), max(1, BWD_TILE // dw_block)))


def rmsnorm_bwd_cuda(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor, *,
                     eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of ``rmsnorm_cuda(x, w)`` for the output gradient ``g``
    (x's shape and type): ``dx`` in x's type, ``dw`` in w's."""
    global bwd_launches
    if not all(t.is_cuda and t.device == x.device for t in (g, w)):
        raise ValueError("rmsnorm_bwd_cuda: g, x and w must be CUDA tensors on one device")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES or g.dtype != x.dtype:
        raise TypeError(f"rmsnorm_bwd_cuda: unsupported types {g.dtype}, {x.dtype}, {w.dtype}")
    d = x.shape[-1]
    if g.shape != x.shape or w.shape != (d,):
        raise ValueError(f"rmsnorm_bwd_cuda: shapes {tuple(g.shape)}, {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if not (g.is_contiguous() and x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_bwd_cuda: g, x and w must be contiguous")
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    R = x.numel() // d if d else 0
    if R == 0:
        return dx, dw.zero_()
    import_triton()
    from repro_torch.kernels.rmsnorm._triton import rmsnorm_bwd_kernel, rmsnorm_dw_kernel

    plan = bwd_plan(R, d, sms=torch.cuda.get_device_properties(x.device).multi_processor_count)
    part = torch.empty((plan.programs, d), dtype=torch.float32, device=x.device)
    rmsnorm_bwd_kernel[(plan.programs,)](
        x, w, g, dx, part, R, d, eps, plan.rows_per_program, ROWS=plan.rows,
        BLOCK_D=plan.block_d, STAGES=plan.stages, num_warps=plan.warps,
    )
    rmsnorm_dw_kernel[(plan.dw_programs,)](part, dw, plan.programs, d, PB=plan.dw_rows,
                                           BLOCK=plan.dw_block, num_warps=4)
    bwd_launches += 1
    return dx, dw
