"""act(g) * u on Hopper, in Triton (act = silu, or tanh-gelu for geglu).

Replaces ``_silu_mul_kernel`` / ``silu_mul_pallas`` of
``repro/kernels/silu_mul/kernel.py``. On the path it joins the gate and up
projections of every FFN (d_ff=3072).

What bounds it on the card: device-memory bytes. Two inputs are read once
and one output written once, with about ten operations a element, so the
bound is ``3 R d * itemsize / bandwidth``. The activation is computed in
f32 as the reference does.

``block_rows`` reaches the launch: a program owns
``largest_divisor_block(R, block_rows)`` rows (R the rows of the flattened
leading dimensions), so the grid is the reference's ``grid_shape(R, d,
block_rows=...)``; it walks those rows' contiguous values in chunks of
``block``, with the next chunk's loads in flight while this one is stored.
``block`` is the span rounded up to a power of two, within ``MIN_BLOCK``
and ``MAX_BLOCK``, so that a program of few rows launches few masked lanes.
``launch_plan`` computes the geometry in Python, so the CPU tests reach it.

The backward (``silu_mul_bwd_cuda``) is one elementwise pass over ``dh``,
``g`` and ``u`` that writes ``dg`` and ``du``, in f32 inside: five values
moved a element, so its bound is ``5 R d * itemsize / bandwidth``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import largest_divisor_block
from repro_torch.kernels._build import import_triton

#: kernel launches since the count was last set to 0
launches = 0
#: backward launches since the count was last set to 0
bwd_launches = 0
#: ``(R/rows,)`` of the last launch: one program per block of rows
last_grid: tuple | None = None

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
MAX_BLOCK = 16384  # values a program handles at a time, at most
MIN_BLOCK = 512
VALUES_PER_THREAD = 16

#: rows a program owns on the serving path (``models.layers.ffn``): one, so
#: that a prompt of R tokens gets R programs whatever R's divisors are. The
#: reference's default of 128 gives a 1024-token prefill 8 programs for 132
#: SMs, and a prime length R one program of R rows; ``chip_smoke.py``
#: phase 5 times the serving path's prompt lengths at 1, 8 and 128.
SERVING_BLOCK_ROWS = 1


class LaunchPlan(NamedTuple):
    grid: tuple  # (R/rows,): the reference's grid_shape
    rows: int  # rows a program owns
    block: int  # values of one chunk: a power of two
    num_warps: int


def launch_plan(R: int, d: int, *, block_rows: int = 128) -> LaunchPlan:
    """One program per ``largest_divisor_block(R, block_rows)`` rows."""
    if block_rows <= 0:
        raise ValueError(f"silu_mul: block_rows must be positive, got {block_rows}")
    rows = largest_divisor_block(R, block_rows)
    block = min(MAX_BLOCK, max(MIN_BLOCK, 1 << (rows * d - 1).bit_length()))
    num_warps = min(32, max(4, block // (32 * VALUES_PER_THREAD)))
    return LaunchPlan((R // rows,), rows, block, num_warps)


def silu_mul_cuda(g: torch.Tensor, u: torch.Tensor, *, act: str = "silu",
                  block_rows: int = 128) -> torch.Tensor:
    """Launch the kernel on ``g``, ``u`` of one shape and type on the card."""
    global launches, last_grid
    if act not in ("silu", "geglu"):
        raise ValueError(f"silu_mul_cuda: unknown activation {act!r}")
    if not (g.is_cuda and u.is_cuda and g.device == u.device):
        raise ValueError("silu_mul_cuda: g and u must be CUDA tensors on one device")
    if g.dtype not in _DTYPES or u.dtype != g.dtype:
        raise TypeError(f"silu_mul_cuda: unsupported types {g.dtype}, {u.dtype}")
    if g.shape != u.shape:
        raise ValueError(f"silu_mul_cuda: shapes differ {tuple(g.shape)} vs {tuple(u.shape)}")
    if not (g.is_contiguous() and u.is_contiguous()):
        raise ValueError("silu_mul_cuda: g and u must be contiguous")
    out = torch.empty_like(g)
    if g.numel() == 0:
        return out
    d = g.shape[-1]
    plan = launch_plan(g.numel() // d, d, block_rows=block_rows)
    import_triton()
    from repro_torch.kernels.silu_mul._triton import act_mul_kernel

    act_mul_kernel[plan.grid](
        g, u, out, plan.rows * d, GEGLU=(act == "geglu"), BLOCK=plan.block,
        num_warps=plan.num_warps,
    )
    launches += 1
    last_grid = plan.grid
    return out


BWD_BLOCK = 2048  # values a program of the backward handles


def silu_mul_bwd_cuda(dh: torch.Tensor, g: torch.Tensor, u: torch.Tensor, *,
                      act: str = "silu") -> tuple[torch.Tensor, torch.Tensor]:
    """``(dg, du)`` of ``silu_mul_cuda(g, u, act=act)`` for the output
    gradient ``dh``; all three of one shape and type on the card."""
    global bwd_launches
    if act not in ("silu", "geglu"):
        raise ValueError(f"silu_mul_bwd_cuda: unknown activation {act!r}")
    if not all(t.is_cuda and t.device == g.device for t in (dh, u)):
        raise ValueError("silu_mul_bwd_cuda: dh, g and u must be CUDA tensors on one device")
    if g.dtype not in _DTYPES or u.dtype != g.dtype or dh.dtype != g.dtype:
        raise TypeError(f"silu_mul_bwd_cuda: unsupported types {dh.dtype}, {g.dtype}, {u.dtype}")
    if not (dh.shape == g.shape == u.shape):
        raise ValueError(f"silu_mul_bwd_cuda: shapes {tuple(dh.shape)}, {tuple(g.shape)}, "
                         f"{tuple(u.shape)}")
    if not (dh.is_contiguous() and g.is_contiguous() and u.is_contiguous()):
        raise ValueError("silu_mul_bwd_cuda: dh, g and u must be contiguous")
    dg, du = torch.empty_like(g), torch.empty_like(u)
    n = g.numel()
    if n == 0:
        return dg, du
    import_triton()
    from repro_torch.kernels.silu_mul._triton import act_mul_bwd_kernel

    act_mul_bwd_kernel[(-(-n // BWD_BLOCK),)](
        dh, g, u, dg, du, n, GEGLU=(act == "geglu"), BLOCK=BWD_BLOCK, num_warps=8,
    )
    bwd_launches += 1
    return dg, du
