"""act(g) * u entry point: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors. Same signature as ``repro.kernels.silu_mul.ops``;
``block_rows`` reaches the launch (``kernel.last_grid == grid_shape(...)``).

A DTensor runs the same call on each rank's shard (``kernels.on_shards``).
On CUDA tensors that autograd records, the call is a
``torch.autograd.Function`` whose backward is the Triton backward kernel
(``kernel.silu_mul_bwd_cuda``); on CPU tensors autograd differentiates the
plain version."""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.kernels import (
    is_dtensor,
    kernel_placements,
    largest_divisor_block,
    needs_grad,
    on_shards,
)
from repro_torch.kernels.silu_mul.kernel import silu_mul_bwd_cuda, silu_mul_cuda
from repro_torch.kernels.silu_mul.ref import silu_mul_ref


# The reference's static helpers, copied exactly: the TPU kernel's grid and
# VMEM working set, which the tuner's SP2xx prefilter lints (analysis.kernels).
def grid_shape(R: int, d: int, *, block_rows: int = 128) -> tuple:
    """Static ``pallas_call`` grid of :func:`act_mul` over ``R`` flattened
    rows: ``(R/block,)`` after largest-divisor clamping (never ragged)."""
    return (R // largest_divisor_block(R, block_rows),)


def vmem_footprint(R: int, d: int, *, block_rows: int = 128, dtype_bytes: int = 2) -> int:
    """Peak VMEM bytes one grid step of :func:`act_mul` holds resident:
    double-buffered ``g``/``u``/``out`` blocks of ``(rows, d)`` each (no
    scratch)."""
    rows = largest_divisor_block(R, block_rows)
    return 2 * (3 * rows * d) * dtype_bytes


def act_mul(g: torch.Tensor, u: torch.Tensor, *, act: str = "silu",
            block_rows: int = 128) -> torch.Tensor:
    if is_dtensor(g, u):  # elementwise: u is placed as g is
        pl = kernel_placements(g, range(g.ndim))
        return on_shards(partial(act_mul, act=act, block_rows=block_rows), (g, u), (pl, pl), pl)
    if g.device.type == "cpu":
        return silu_mul_ref(g, u, act=act)
    if needs_grad(g, u):
        return _ActMul.apply(g, u, act, block_rows)
    return silu_mul_cuda(g, u, act=act, block_rows=block_rows)


class _ActMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, u, act, block_rows):
        ctx.save_for_backward(g, u)
        ctx.act = act
        return silu_mul_cuda(g, u, act=act, block_rows=block_rows)

    @staticmethod
    def backward(ctx, dh):
        g, u = ctx.saved_tensors
        dg, du = silu_mul_bwd_cuda(dh.contiguous(), g, u, act=ctx.act)
        return dg, du, None, None
