"""Plain PyTorch SiLU&Mul / GeGLU&Mul: ``act(g) * u`` in f32, cast to
``g.dtype`` (``repro.kernels.silu_mul.ref.silu_mul_ref``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def silu_mul_ref(g: torch.Tensor, u: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    g32, u32 = g.float(), u.float()
    h = F.gelu(g32, approximate="tanh") if act == "geglu" else F.silu(g32)
    return (h * u32).to(g.dtype)
