"""PyTorch/CUDA port of the ``repro`` package.

Mirrors ``repro``'s module names. Imports ``torch``, numpy and the standard
library only: nothing of JAX and nothing of ``repro``. Entry points run on
``"cuda"`` unless the caller passes ``device="cpu"``.
"""
