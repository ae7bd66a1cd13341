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
