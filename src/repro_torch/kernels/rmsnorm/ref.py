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


def rmsnorm_bwd_ref(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                    eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward of :func:`rmsnorm_ref` as an explicit formula, in f32:
    with ``r = rsqrt(mean(x^2) + eps)`` and ``gw = g (1 + w)``,
    ``dx = r gw - x r^3 mean(gw x)`` and ``dw = sum over rows of g x r``.
    ``dx`` in x's type, ``dw`` in w's."""
    xf, gf = x.float(), g.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    gw = gf * (1.0 + w.float())
    dx = r * gw - xf * r.pow(3) * (gw * xf).mean(dim=-1, keepdim=True)
    dw = (gf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)
