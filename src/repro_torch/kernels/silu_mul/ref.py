"""Plain PyTorch SiLU&Mul / GeGLU&Mul: ``act(g) * u`` in f32, cast to
``g.dtype`` (``repro.kernels.silu_mul.ref.silu_mul_ref``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def silu_mul_ref(g: torch.Tensor, u: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    g32, u32 = g.float(), u.float()
    h = F.gelu(g32, approximate="tanh") if act == "geglu" else F.silu(g32)
    return (h * u32).to(g.dtype)


def silu_mul_bwd_ref(dh: torch.Tensor, g: torch.Tensor, u: torch.Tensor, *,
                     act: str = "silu") -> tuple[torch.Tensor, torch.Tensor]:
    """The backward of :func:`silu_mul_ref` as an explicit formula, in f32:
    ``dg = dh u act'(g)`` and ``du = dh act(g)``, with
    ``silu'(g) = s (1 + g (1 - s))`` for ``s = sigmoid(g)`` and the
    tanh-gelu's derivative for geglu. Returns ``(dg, du)`` in g's and u's
    types."""
    d32, g32, u32 = dh.float(), g.float(), u.float()
    if act == "geglu":
        c = 0.7978845608028654  # sqrt(2 / pi)
        t = torch.tanh(c * (g32 + 0.044715 * g32.pow(3)))
        h = 0.5 * g32 * (1.0 + t)
        dact = 0.5 * (1.0 + t) + 0.5 * g32 * (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * g32 * g32)
    else:
        s = torch.sigmoid(g32)
        h = g32 * s
        dact = s * (1.0 + g32 * (1.0 - s))
    return (d32 * u32 * dact).to(g.dtype), (d32 * h).to(u.dtype)
