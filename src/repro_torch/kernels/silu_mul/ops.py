"""act(g) * u entry point: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors. Same signature as ``repro.kernels.silu_mul.ops``."""
from __future__ import annotations

import torch

from repro_torch.kernels.silu_mul.kernel import silu_mul_cuda
from repro_torch.kernels.silu_mul.ref import silu_mul_ref


def act_mul(g: torch.Tensor, u: torch.Tensor, *, act: str = "silu",
            block_rows: int = 128) -> torch.Tensor:
    if g.device.type == "cpu":
        return silu_mul_ref(g, u, act=act)
    return silu_mul_cuda(g, u, act=act)
