"""Plain PyTorch RMSNorm: the function ``repro.models.layers.rmsnorm``
computes, and what the Hopper kernel is held against."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per row ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in f32, cast back to
    ``x.dtype``. ``w`` stores scale - 1 and may have another float type."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)
