"""Fused-MoE expert FFN entry point: the Hopper kernel for CUDA tensors,
the plain version for CPU tensors. Same signature as
``repro.kernels.fused_moe.ops.fused_moe``; ``block_m``/``block_f`` reach the
kernel's launch (``kernel.last_grid == grid_shape(...)``). DTensors run
the same call on each rank's experts (and rows) through ``kernels.on_shards``."""
from __future__ import annotations

from functools import partial

import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.kernels import is_dtensor, kernel_placements, on_shards, refuse_grad
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


def on_expert_shards(fn, x, w_gate, w_up, w_down):
    """``fn(x, w_gate, w_up, w_down)`` (a fused-MoE call) on each rank's
    experts through ``kernels.on_shards``: experts on dim 0 of ``x`` and of
    the three weights; ``x``'s rows may stay sharded too, where the weights
    replicate (and their gradients are partial sums). Rows that a mesh dim
    of more ranks replicates are split over it, each rank computing its
    share, and the output rows gathered back: its ranks do not all compute
    every row (a decode step's few dispatch groups)."""
    xp = kernel_placements(x, (0, 1))
    mesh, R = x.device_mesh, x.shape[1]
    run = tuple(Shard(1) if p == Replicate() and 1 < mesh.size(m) and R % mesh.size(m) == 0
                else p for m, p in enumerate(xp))
    wp = tuple(p if p == Shard(0) else Replicate() for p in run)
    wg = tuple(Partial() if p == Shard(1) else w for p, w in zip(run, wp))
    out = on_shards(fn, (x, w_gate, w_up, w_down), (run, wp, wp, wp), run, (run, wg, wg, wg))
    return out if run == xp else out.redistribute(mesh, xp)


def fused_moe(
    x: torch.Tensor,  # (E, C, D) gathered per-expert token blocks
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
    *,
    block_m: int = 128,
    block_f: int = 256,
) -> torch.Tensor:
    if is_dtensor(x, w_gate, w_up, w_down):
        return on_expert_shards(partial(fused_moe, block_m=block_m, block_f=block_f),
                                x, w_gate, w_up, w_down)
    if x.device.type == "cpu":
        return fused_moe_ref(x, w_gate, w_up, w_down)
    refuse_grad("fused_moe", x, w_gate, w_up, w_down)
    return fused_moe_cuda(x, w_gate, w_up, w_down, block_m=block_m, block_f=block_f)
