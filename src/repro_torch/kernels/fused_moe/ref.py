"""Plain PyTorch fused-MoE expert FFN: the same function as
``repro.kernels.fused_moe.ref``, in f32 (float64 for float64 inputs: the
card's checks hold the f32 kernels to it), cast back to the type of x."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _wide(t):
    """``t`` in f32, or as it is where it is float64."""
    return t if t.dtype == torch.float64 else t.float()


def fused_moe_ref(x, w_gate, w_up, w_down):
    x32 = _wide(x)
    g = torch.einsum("ecd,edf->ecf", x32, _wide(w_gate))
    u = torch.einsum("ecd,edf->ecf", x32, _wide(w_up))
    h = F.silu(g) * u
    y = torch.einsum("ecf,efd->ecd", h, _wide(w_down))
    return y.to(x.dtype)


def fused_moe_bwd_ref(x, w_gate, w_up, w_down, dy):
    """The backward of :func:`fused_moe_ref` as explicit formulas, in f32
    (float64 for float64 inputs):
    with ``g = x Wg``, ``u = x Wu``, ``h = silu(g) u`` and ``dh = dy
    Wd^T``: ``dg = dh u silu'(g)``, ``du = dh silu(g)``, ``dWd = h^T dy``,
    ``dWg = x^T dg``, ``dWu = x^T du`` and ``dx = dg Wg^T + du Wu^T``, per
    expert. Returns ``(dx, dw_gate, dw_up, dw_down)`` in the inputs' types."""
    x32, wg, wu, wd, d32 = (_wide(t) for t in (x, w_gate, w_up, w_down, dy))
    g = torch.einsum("ecd,edf->ecf", x32, wg)
    u = torch.einsum("ecd,edf->ecf", x32, wu)
    s = torch.sigmoid(g)
    act = g * s
    dh = torch.einsum("ecd,efd->ecf", d32, wd)
    dg = dh * u * s * (1.0 + g * (1.0 - s))
    du = dh * act
    dx = torch.einsum("ecf,edf->ecd", dg, wg) + torch.einsum("ecf,edf->ecd", du, wu)
    dwg = torch.einsum("ecd,ecf->edf", x32, dg)
    dwu = torch.einsum("ecd,ecf->edf", x32, du)
    dwd = torch.einsum("ecf,ecd->efd", act * u, d32)
    return (dx.to(x.dtype), dwg.to(w_gate.dtype), dwu.to(w_up.dtype), dwd.to(w_down.dtype))
