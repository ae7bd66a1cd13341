"""W8A8 scaled-product entry point: the Hopper kernel for CUDA tensors, the
plain version for CPU tensors. Same signature as
``repro.kernels.scaled_mm.ops.scaled_mm``; the three blocks reach the
kernel's launch (``kernel.last_grid == grid_shape(...)``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import largest_divisor_block, refuse_grad
from repro_torch.kernels.scaled_mm.kernel import scaled_mm_cuda
from repro_torch.kernels.scaled_mm.ref import scaled_mm_ref


# The reference's static helpers, copied exactly: the TPU kernel's grid and
# VMEM working set, which the tuner's SP2xx prefilter lints (analysis.kernels).
def grid_shape(
    M: int, K: int, N: int, *, block_m: int = 128, block_n: int = 128, block_k: int = 256
) -> tuple:
    """Static ``pallas_call`` grid of :func:`scaled_mm`: ``(M/bm, N/bn,
    K/bk)`` after largest-divisor block clamping — this kernel never
    launches a ragged grid, so (unlike flash_attention/fused_moe) the
    helper cannot raise."""
    bm = largest_divisor_block(M, block_m)
    bn = largest_divisor_block(N, block_n)
    bk = largest_divisor_block(K, block_k)
    return (M // bm, N // bn, K // bk)


def vmem_footprint(
    M: int, K: int, N: int,
    *, block_m: int = 128, block_n: int = 128, block_k: int = 256, out_dtype_bytes: int = 2,
) -> int:
    """Peak VMEM bytes one grid step of :func:`scaled_mm` holds resident:
    double-buffered int8 ``x (bm, bk)`` / ``w (bk, bn)`` blocks, the f32
    scale vectors ``(bm, 1)``/``(1, bn)``, the ``(bm, bn)`` output block
    in ``out_dtype``, plus the int32 accumulator scratch."""
    bm = largest_divisor_block(M, block_m)
    bn = largest_divisor_block(N, block_n)
    bk = largest_divisor_block(K, block_k)
    blocks = bm * bk * 1 + bk * bn * 1 + (bm + bn) * 4 + bm * bn * out_dtype_bytes
    scratch = bm * bn * 4
    return 2 * blocks + scratch


def scaled_mm(
    x: torch.Tensor,  # (M, K) int8
    w: torch.Tensor,  # (K, N) int8
    sx: torch.Tensor,  # (M,) f32
    sw: torch.Tensor,  # (N,) f32
    *,
    out_dtype: torch.dtype = torch.bfloat16,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 256,
) -> torch.Tensor:
    if x.device.type == "cpu":
        return scaled_mm_ref(x, w, sx, sw, out_dtype)
    refuse_grad("scaled_mm", x, w, sx, sw)
    return scaled_mm_cuda(x, w, sx, sw, out_dtype=out_dtype,
                          block_m=block_m, block_n=block_n, block_k=block_k)
