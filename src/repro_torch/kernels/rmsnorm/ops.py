"""RMSNorm entry point: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors. Same signature as ``repro.kernels.rmsnorm.ops``."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = 256) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    return rmsnorm_cuda(x, w, eps=eps, block_rows=block_rows)
