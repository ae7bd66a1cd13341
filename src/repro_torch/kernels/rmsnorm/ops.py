"""RMSNorm entry point: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors. Same signature as ``repro.kernels.rmsnorm.ops``."""
from __future__ import annotations

import torch

from repro_torch.kernels import largest_divisor_block
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
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
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    return rmsnorm_cuda(x, w, eps=eps, block_rows=block_rows)
