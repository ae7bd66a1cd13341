"""Triton source of the act(g) * u kernel. Imported only by the launching
function in ``kernel.py``, on a machine with a card and Triton."""
import triton
import triton.language as tl


@triton.jit
def act_mul_kernel(g_ptr, u_ptr, o_ptr, N, GEGLU: tl.constexpr, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < N
    g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    u = tl.load(u_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    if GEGLU:
        # tanh-approximate gelu: 0.5 g (1 + tanh(z)) == g * sigmoid(2 z)
        z = 0.7978845608028654 * (g + 0.044715 * g * g * g)
        h = g / (1.0 + tl.exp(-2.0 * z))
    else:
        h = g / (1.0 + tl.exp(-g))
    tl.store(o_ptr + offs, (h * u).to(o_ptr.dtype.element_ty), mask=mask)
