"""Triton source of the act(g) * u kernel. Imported only by the launching
function in ``kernel.py``, on a machine with a card and Triton."""
import triton
import triton.language as tl


@triton.jit
def _act_mul(g, u, GEGLU: tl.constexpr):
    g = g.to(tl.float32)
    if GEGLU:
        # tanh-approximate gelu: 0.5 g (1 + tanh(z)) == g * sigmoid(2 z)
        z = 0.7978845608028654 * (g + 0.044715 * g * g * g)
        h = g / (1.0 + tl.exp(-2.0 * z))
    else:
        h = g / (1.0 + tl.exp(-g))
    return h * u.to(tl.float32)


@triton.jit
def act_mul_kernel(g_ptr, u_ptr, o_ptr, SPAN, GEGLU: tl.constexpr, BLOCK: tl.constexpr):
    """One program owns a block of rows, ``SPAN = rows * d`` contiguous
    values, and walks it in chunks of ``BLOCK``; the next chunk's loads are
    issued before this chunk is stored, so two are in flight."""
    base = tl.program_id(0).to(tl.int64) * SPAN
    offs = tl.arange(0, BLOCK)
    mask = offs < SPAN
    g = tl.load(g_ptr + base + offs, mask=mask, other=0.0)
    u = tl.load(u_ptr + base + offs, mask=mask, other=0.0)
    for start in range(BLOCK, SPAN + BLOCK, BLOCK):
        nxt = start + offs
        nmask = nxt < SPAN
        g_next = tl.load(g_ptr + base + nxt, mask=nmask, other=0.0)
        u_next = tl.load(u_ptr + base + nxt, mask=nmask, other=0.0)
        cur = start - BLOCK + offs
        tl.store(o_ptr + base + cur, _act_mul(g, u, GEGLU).to(o_ptr.dtype.element_ty),
                 mask=cur < SPAN)
        g, u = g_next, u_next


@triton.jit
def act_mul_bwd_kernel(dh_ptr, g_ptr, u_ptr, dg_ptr, du_ptr, N, GEGLU: tl.constexpr,
                       BLOCK: tl.constexpr):
    """``dg = dh u act'(g)`` and ``du = dh act(g)``, in f32, one pass over
    three inputs and two outputs."""
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < N
    dh = tl.load(dh_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    u = tl.load(u_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    if GEGLU:
        c = 0.7978845608028654  # sqrt(2 / pi)
        z = c * (g + 0.044715 * g * g * g)
        t = 2.0 / (1.0 + tl.exp(-2.0 * z)) - 1.0  # tanh(z)
        h = 0.5 * g * (1.0 + t)
        dact = 0.5 * (1.0 + t) + 0.5 * g * (1.0 - t * t) * c * (1.0 + 0.134145 * g * g)
    else:
        s = 1.0 / (1.0 + tl.exp(-g))
        h = g * s
        dact = s * (1.0 + g * (1.0 - s))
    tl.store(dg_ptr + offs, (dh * u * dact).to(dg_ptr.dtype.element_ty), mask=mask)
    tl.store(du_ptr + offs, (dh * h).to(du_ptr.dtype.element_ty), mask=mask)
