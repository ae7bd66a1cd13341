"""Plain PyTorch W8A8 scaled product: the same function as
``repro.kernels.scaled_mm.ref``.

PyTorch has no int32 matrix product on CUDA tensors, so the accumulator is
computed in float64 on either device. That is exact: every partial sum is
an integer with |acc| <= K * 127**2 < 2**53, and it fits int32 for every K
up to 133k."""
from __future__ import annotations

import torch


def scaled_mm_acc_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact int32 accumulator ``x @ w`` of int8 ``x (M, K)``, ``w (K, N)``."""
    return (x.double() @ w.double()).to(torch.int32)


def scaled_mm_ref(x, w, sx, sw, out_dtype=torch.bfloat16):
    acc = scaled_mm_acc_ref(x, w)
    deq = acc.float() * sx[:, None].float() * sw[None, :].float()
    return deq.to(out_dtype)


def quantize_rowwise(a: torch.Tensor):
    """fp -> (int8, per-row scale)."""
    scale = torch.clamp(a.abs().amax(dim=1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(a / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale.float()
