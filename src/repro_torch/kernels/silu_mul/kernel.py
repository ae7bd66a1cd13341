"""act(g) * u on Hopper, in Triton (act = silu, or tanh-gelu for geglu).

Replaces ``_silu_mul_kernel`` / ``silu_mul_pallas`` of
``repro/kernels/silu_mul/kernel.py``. On the path it joins the gate and up
projections of every FFN (d_ff=3072).

What bounds it on the card: device-memory bytes. Two inputs are read once
and one output written once, with about ten operations a element, so the
bound is ``3 R d * itemsize / bandwidth``. The function is elementwise, so
the kernel walks the flattened tensors in masked blocks of 1024 values:
every load is contiguous and no row shape needs to divide anything. The
activation is computed in f32 as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import import_triton

#: kernel launches since the count was last set to 0
launches = 0

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_BLOCK = 1024


def silu_mul_cuda(g: torch.Tensor, u: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """Launch the kernel on ``g``, ``u`` of one shape and type on the card."""
    global launches
    if act not in ("silu", "geglu"):
        raise ValueError(f"silu_mul_cuda: unknown activation {act!r}")
    if not (g.is_cuda and u.is_cuda and g.device == u.device):
        raise ValueError("silu_mul_cuda: g and u must be CUDA tensors on one device")
    if g.dtype not in _DTYPES or u.dtype != g.dtype:
        raise TypeError(f"silu_mul_cuda: unsupported types {g.dtype}, {u.dtype}")
    if g.shape != u.shape:
        raise ValueError(f"silu_mul_cuda: shapes differ {tuple(g.shape)} vs {tuple(u.shape)}")
    if not (g.is_contiguous() and u.is_contiguous()):
        raise ValueError("silu_mul_cuda: g and u must be contiguous")
    out = torch.empty_like(g)
    n = g.numel()
    if n == 0:
        return out
    import_triton()
    from repro_torch.kernels.silu_mul._triton import act_mul_kernel

    act_mul_kernel[((n + _BLOCK - 1) // _BLOCK,)](
        g, u, out, n, GEGLU=(act == "geglu"), BLOCK=_BLOCK, num_warps=4,
    )
    launches += 1
    return out
