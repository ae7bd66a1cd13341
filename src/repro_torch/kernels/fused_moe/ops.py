"""Fused-MoE expert FFN entry point: the Hopper kernel for CUDA tensors,
the plain version for CPU tensors. Same signature as
``repro.kernels.fused_moe.ops.fused_moe``; ``block_m``/``block_f`` reach the
kernel's launch (``kernel.last_grid == grid_shape(...)``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_moe.kernel import fused_moe_cuda
from repro_torch.kernels.fused_moe.ref import fused_moe_ref


# The reference's static helpers, copied exactly: the TPU kernel's grid and
# VMEM working set, which the tuner's SP2xx prefilter lints (analysis.kernels).
def grid_shape(E: int, C: int, D: int, F: int, *, block_m: int = 128, block_f: int = 256) -> tuple:
    """Static ``pallas_call`` grid of :func:`fused_moe`: ``(E, C/block_m,
    F/block_f)`` after the ``min(block, dim)`` clamp. Raises ``ValueError``
    where the kernel would fail its divisibility assert."""
    bm, bf = min(block_m, C), min(block_f, F)
    if C % bm or F % bf:
        raise ValueError(
            f"fused_moe: C={C} %% block_m={bm} or F={F} %% block_f={bf} != 0 "
            f"(non-divisible tiling)"
        )
    return (E, C // bm, F // bf)


def vmem_footprint(
    E: int, C: int, D: int, F: int,
    *, block_m: int = 128, block_f: int = 256, dtype_bytes: int = 2,
) -> int:
    """Peak VMEM bytes one grid step of :func:`fused_moe` holds resident:
    double-buffered blocks ``x (bm, D)``, ``w_gate/w_up (D, bf)``,
    ``w_down (bf, D)``, ``out (bm, D)`` plus the f32 ``(bm, D)``
    accumulator scratch. The auditor's VMEM-overflow lint (SP201) compares
    this against ``TPUSpec.vmem_mb`` before any compile."""
    bm, bf = min(block_m, C), min(block_f, F)
    blocks = (bm * D + 2 * D * bf + bf * D + bm * D) * dtype_bytes
    scratch = bm * D * 4
    return 2 * blocks + scratch


def fused_moe(
    x: torch.Tensor,  # (E, C, D) gathered per-expert token blocks
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
    *,
    block_m: int = 128,
    block_f: int = 256,
) -> torch.Tensor:
    if x.device.type == "cpu":
        return fused_moe_ref(x, w_gate, w_up, w_down)
    return fused_moe_cuda(x, w_gate, w_up, w_down, block_m=block_m, block_f=block_f)
