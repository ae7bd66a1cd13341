"""Triton source of the RMSNorm kernel. Imported only by the launching
function in ``kernel.py``, on a machine with a card and Triton."""
import triton
import triton.language as tl


@triton.jit
def rmsnorm_kernel(x_ptr, w_ptr, o_ptr, R, D, eps,
                   ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
    pid = tl.program_id(0)
    rows = pid * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_D)
    cmask = cols < D
    mask = (rows < R)[:, None] & cmask[None, :]
    offs = rows[:, None].to(tl.int64) * D + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=1) / D
    inv = tl.rsqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    o = x * inv[:, None] * (1.0 + w)[None, :]
    tl.store(o_ptr + offs, o.to(o_ptr.dtype.element_ty), mask=mask)
