"""RMSNorm entry point: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors. Same signature as ``repro.kernels.rmsnorm.ops``.

A DTensor runs the same call on each rank's rows (``kernels.on_shards``).
On CUDA tensors that autograd records, the call is a
``torch.autograd.Function`` whose backward is the Triton backward kernel
(``kernel.rmsnorm_bwd_cuda``); on CPU tensors autograd differentiates the
plain version."""
from __future__ import annotations

from functools import partial

import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.kernels import (
    is_dtensor,
    kernel_placements,
    largest_divisor_block,
    needs_grad,
    on_shards,
)
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_cuda, rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


# The reference's static helpers, copied exactly: the TPU kernel's grid and
# VMEM working set, which the tuner's SP2xx prefilter lints (analysis.kernels).
def grid_shape(R: int, d: int, *, block_rows: int = 256) -> tuple:
    """Static ``pallas_call`` grid of :func:`rmsnorm` over ``R`` flattened
    rows: ``(R/block,)`` after largest-divisor clamping (never ragged)."""
    return (R // largest_divisor_block(R, block_rows),)


def vmem_footprint(R: int, d: int, *, block_rows: int = 256, dtype_bytes: int = 2) -> int:
    """Peak VMEM bytes one grid step of :func:`rmsnorm` holds resident:
    double-buffered ``x (rows, d)`` / ``w (d,)`` / ``out (rows, d)``
    blocks (no scratch)."""
    rows = largest_divisor_block(R, block_rows)
    return 2 * (rows * d + d + rows * d) * dtype_bytes


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = 256) -> torch.Tensor:
    if is_dtensor(x, w):  # rows may be sharded, never the normed dim
        rows = kernel_placements(x, range(x.ndim - 1))
        rep = (Replicate(),) * len(rows)
        # w's gradient sums over the rows each rank holds
        dw = tuple(Partial() if isinstance(p, Shard) else p for p in rows)
        return on_shards(partial(rmsnorm, eps=eps, block_rows=block_rows), (x, w),
                         (rows, rep), rows, (rows, dw))
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if needs_grad(x, w):
        return _RMSNorm.apply(x, w, eps, block_rows)
    return rmsnorm_cuda(x, w, eps=eps, block_rows=block_rows)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps, block_rows):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm_cuda(x, w, eps=eps, block_rows=block_rows)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd_cuda(g.contiguous(), x, w, eps=ctx.eps)
        return dx, dw, None, None
