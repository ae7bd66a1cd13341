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
