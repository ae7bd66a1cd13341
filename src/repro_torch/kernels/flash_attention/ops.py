"""Model-layout ``(B, S, H, D)`` GQA attention: the Hopper kernel for CUDA
tensors, the plain version for CPU tensors. Same signature as
``repro.kernels.flash_attention.ops.attention``.

``block_q``/``block_k`` reach the kernel's launch: the q rows a CTA owns
and the keys of one online-softmax step (``kernel.last_grid ==
grid_shape(...)`` wherever the lengths divide the blocks). The kernel masks
ragged edges itself, so no length has to divide a block.

DTensors run the same call on each rank's batch and head shards
(``head_placements``, ``kernels.on_shards``).

On CUDA tensors that autograd records, the call is a
``torch.autograd.Function``: its forward also keeps each row's log-sum-exp,
and its backward is the CUDA backward kernel
(``kernel.flash_attention_bwd_cuda``), which recomputes P from it tile by
tile. Head dims outside ``kernel.BWD_HEAD_DIMS`` raise there, with no
fallback. On CPU tensors autograd differentiates the plain version."""
from __future__ import annotations

from functools import partial

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.kernels import is_dtensor, kernel_placements, needs_grad, on_shards
from repro_torch.kernels.flash_attention.kernel import (
    BWD_HEAD_DIMS,
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
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
    if is_dtensor(q, k, v):
        pl = head_placements(q, k)
        return on_shards(partial(attention, causal=causal, window=window, softcap=softcap,
                                 block_q=block_q, block_k=block_k),
                         (q, k, v), (pl, pl, pl), pl)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    if needs_grad(q, k, v):
        if q.shape[-1] not in BWD_HEAD_DIMS:
            raise NotImplementedError(
                f"flash attention: no backward kernel for head dim {q.shape[-1]} "
                f"(it has {BWD_HEAD_DIMS}); train this model on the CPU"
            )
        return _Attention.apply(q, k, v, causal, window, softcap, block_q, block_k)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap,
                                block_q=block_q, block_k=block_k)


def head_placements(q, k) -> tuple:
    """The placements attention runs its shards at: q's batch (dim 0) and
    head (dim 2) shards, never S or D. k and v take the same ones, so a
    rank's q heads find their GQA group's kv heads on the same rank; a mesh
    dim that does not divide both head counts replicates the heads."""
    return tuple(
        Replicate() if p == Shard(2) and (q.shape[2] % n or k.shape[2] % n) else p
        for p, n in zip(kernel_placements(q, (0, 2)), q.device_mesh.shape))


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, block_q, block_k):
        out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap,
                                        block_q=block_q, block_k=block_k, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout.contiguous(), **ctx.masks)
        return dq, dk, dv, None, None, None, None, None
