"""Hand-written Hopper kernels of the port, one package per kernel.

Each package holds ``ref.py`` (the plain PyTorch version), ``kernel.py``
(the kernel and its launch wrapper, with an integer ``launches`` count) and
``ops.py`` (the entry point the model calls, which dispatches on the device
of its tensor: CUDA launches the kernel, CPU takes the plain version).
"""


def largest_divisor_block(total: int, block: int) -> int:
    """Largest divisor of ``total`` that is ``<= block`` (and >= 1).

    The block-clamping rule of the reference's row kernels, kept so that
    ``block_rows`` knobs mean the same thing in both packages."""
    block = min(block, total)
    return next(b for b in range(block, 0, -1) if total % b == 0)


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on ``tensors``: grad mode is on
    and one of them requires a gradient."""
    import torch

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
