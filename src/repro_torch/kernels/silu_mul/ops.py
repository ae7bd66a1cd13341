"""act(g) * u entry point: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors. Same signature as ``repro.kernels.silu_mul.ops``."""
from __future__ import annotations

import torch

from repro_torch.kernels import largest_divisor_block
from repro_torch.kernels.silu_mul.kernel import silu_mul_cuda
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
    if g.device.type == "cpu":
        return silu_mul_ref(g, u, act=act)
    return silu_mul_cuda(g, u, act=act)
