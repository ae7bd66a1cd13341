"""Hand-written Hopper kernels of the port, one package per kernel.

Each package holds ``ref.py`` (the plain PyTorch version), ``kernel.py``
(the kernel and its launch wrapper, with an integer ``launches`` count) and
``ops.py`` (the entry point the model calls, which dispatches on the device
of its tensor: CUDA launches the kernel, CPU takes the plain version).
"""
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.placement_types import Placement
from torch.distributed.tensor.experimental import local_map


def largest_divisor_block(total: int, block: int) -> int:
    """Largest divisor of ``total`` that is ``<= block`` (and >= 1).

    The block-clamping rule of the reference's row kernels, kept so that
    ``block_rows`` knobs mean the same thing in both packages."""
    block = min(block, total)
    return next(b for b in range(block, 0, -1) if total % b == 0)


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on ``tensors``: grad mode is on
    and one of them requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise where a kernel with no backward would be recorded by autograd:
    its output would carry no ``grad_fn``, so training through it would
    drop the gradients without a word."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{kernel}: the CUDA kernel has no backward yet; call it under "
            "torch.no_grad() or on inputs that do not require grad"
        )


# ----------------------------------------------------------------------
# DTensors: a kernel runs on each rank's local shard (``local_map``)
# ----------------------------------------------------------------------


def is_dtensor(*tensors) -> bool:
    """Whether any of ``tensors`` is a DTensor (a sharded call)."""
    return any(isinstance(t, DTensor) for t in tensors)


def kernel_placements(x, dims) -> tuple:
    """``x``'s placements with every mesh dim that does not shard one of
    ``dims`` (a kernel's independent dims: rows, batch, heads, experts)
    turned to ``Replicate()``: a shard of a dim the kernel reduces over,
    or a pending sum, is gathered or reduced first."""
    keep = {d % x.ndim for d in dims}
    return tuple(p if type(p) is Shard and p.dim % x.ndim in keep else Replicate()
                 for p in x.placements)


def on_shards(fn, args, in_placements, out_placements, grad_placements=None):
    """``fn`` on each rank's local shards of ``args`` through ``local_map``:
    the inputs are redistributed to ``in_placements`` (plain tensors count
    as replicated), ``fn`` runs on the local tensors with its own launch,
    and its output is a DTensor with ``out_placements``.
    ``grad_placements`` are the inputs' gradient placements (default: their
    own): a replicated weight applied to sharded rows has a ``Partial()``
    gradient on those rows' mesh dims. A ``fn`` with several outputs takes
    a list of placements for each. Differentiable."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    args = [a if isinstance(a, DTensor) else
            DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
            for a in args]
    # local_map takes one output's placements as a list, several as a tuple of lists
    several = len(out_placements) > 0 and not isinstance(out_placements[0], Placement)
    outs = tuple(list(p) for p in out_placements) if several else list(out_placements)
    return local_map(fn, out_placements=outs, in_placements=tuple(in_placements),
                     in_grad_placements=tuple(grad_placements or in_placements),
                     device_mesh=mesh, redistribute_inputs=True)(*args)

