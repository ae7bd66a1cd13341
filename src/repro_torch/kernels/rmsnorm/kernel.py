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
and the gradient once and writes ``dx`` once. A program walks a fixed share
of the rows, writing their ``dx`` and keeping its part of ``dw = sum g x r``
in registers; a second launch sums those parts in program order, so ``dw``
is the same bits every run (no float atomics).
"""
from __future__ import annotations

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


#: programs of the backward's row pass, at most (two an SM): each owns a
#: share of the rows, and the ``dw`` pass reads one f32 row of ``d`` per
#: program (1056 programs measured slower on an H100: the ``dw`` pass grows)
BWD_PROGRAMS = 264
#: columns of ``dw`` a program of the second pass sums
DW_BLOCK = 64


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

    block_d = 1 << (d - 1).bit_length()
    rows = _pow2_floor(max(1, 2048 // block_d))
    per = -(-R // min(-(-R // rows), BWD_PROGRAMS))
    per = -(-per // rows) * rows  # rows a program walks: whole steps of ``rows``
    programs = -(-R // per)
    part = torch.empty((programs, d), dtype=torch.float32, device=x.device)
    rmsnorm_bwd_kernel[(programs,)](
        x, w, g, dx, part, R, d, eps, per, ROWS=rows, BLOCK_D=block_d,
        num_warps=4 if rows * block_d <= 1024 else 8,
    )
    block = min(DW_BLOCK, block_d)
    rmsnorm_dw_kernel[(-(-d // block),)](part, dw, programs, d, PB=64, BLOCK=block,
                                         num_warps=4)
    bwd_launches += 1
    return dx, dw
