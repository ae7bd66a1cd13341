"""Plain PyTorch fused-MoE expert FFN: the same function as
``repro.kernels.fused_moe.ref``, in f32, cast back to the type of x."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def fused_moe_ref(x, w_gate, w_up, w_down):
    x32 = x.float()
    g = torch.einsum("ecd,edf->ecf", x32, w_gate.float())
    u = torch.einsum("ecd,edf->ecf", x32, w_up.float())
    h = F.silu(g) * u
    y = torch.einsum("ecf,efd->ecd", h, w_down.float())
    return y.to(x.dtype)
