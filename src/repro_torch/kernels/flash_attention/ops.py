"""Model-layout ``(B, S, H, D)`` GQA attention: the Hopper kernel for CUDA
tensors, the plain version for CPU tensors. Same signature as
``repro.kernels.flash_attention.ops.attention``.

``block_q``/``block_k`` are the reference's tiling knobs, kept for the
signature; the Hopper kernel tiles 64 x 64 and masks ragged edges itself,
so no length has to divide a block."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


# The reference's static helpers, copied exactly: the TPU kernel's grid and
# VMEM working set, which the tuner's SP2xx prefilter lints (analysis.kernels).
def grid_shape(
    B: int, S: int, Skv: int, Hq: int, Hkv: int, D: int,
    *, block_q: int = 128, block_k: int = 128,
) -> tuple:
    """Static ``pallas_call`` grid of :func:`attention`: ``(BKG, n_q, n_k)``
    where ``BKG = B * Hkv * (Hq // Hkv)``. Raises ``ValueError`` exactly
    where the kernel would fail its divisibility assert (after the
    ``min(block, dim)`` clamp) — the contract ``repro.analysis`` lints
    before any compile."""
    bq, bk = min(block_q, S), min(block_k, Skv)
    if S % bq or Skv % bk:
        raise ValueError(
            f"flash_attention: S={S} %% block_q={bq} or Skv={Skv} %% "
            f"block_k={bk} != 0 (non-divisible tiling)"
        )
    return (B * Hkv * (Hq // Hkv), S // bq, Skv // bk)


def vmem_footprint(
    B: int, S: int, Skv: int, Hq: int, Hkv: int, D: int,
    *, block_q: int = 128, block_k: int = 128, dtype_bytes: int = 2,
) -> int:
    """Peak VMEM bytes one grid step of :func:`attention` holds resident:
    the double-buffered in/out BlockSpec blocks (Mosaic pipelines the next
    tile's DMA while computing, so every block is resident twice) plus the
    f32 scratch accumulators ``(block_q, 1) x2 + (block_q, D)``. Mirrors
    the kernel's BlockSpecs exactly; pinned by ``tests/test_analysis.py``."""
    bq, bk = min(block_q, S), min(block_k, Skv)
    blocks = (bq * D + 2 * bk * D + bq * D) * dtype_bytes  # q, k, v, out
    scratch = (bq * 1 + bq * 1 + bq * D) * 4
    return 2 * blocks + scratch


def attention(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)
