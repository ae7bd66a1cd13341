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


@triton.jit
def rmsnorm_bwd_kernel(x_ptr, w_ptr, g_ptr, dx_ptr, part_ptr, R, D, eps, ROWS_PER_PROG,
                       ROWS: tl.constexpr, BLOCK_D: tl.constexpr, STAGES: tl.constexpr):
    """One program walks ``ROWS_PER_PROG`` rows, ``ROWS`` a step, with the
    loads of the next ``STAGES - 1`` steps in flight: it writes their ``dx``
    and keeps its share of ``dw`` in registers, then stores that share as
    one row of ``part`` (no atomics)."""
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_D)
    cmask = cols < D
    w1 = 1.0 + tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    acc = tl.zeros((ROWS, BLOCK_D), dtype=tl.float32)
    row0 = pid * ROWS_PER_PROG
    for start in tl.range(0, ROWS_PER_PROG, ROWS, num_stages=STAGES):
        rows = row0 + start + tl.arange(0, ROWS)
        mask = (rows < R)[:, None] & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * D + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        r = tl.rsqrt(tl.sum(x * x, axis=1) / D + eps)
        gw = g * w1[None, :]
        c = tl.sum(gw * x, axis=1) / D
        dx = r[:, None] * gw - x * (r * r * r * c)[:, None]
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
        acc += g * x * r[:, None]
    tl.store(part_ptr + pid.to(tl.int64) * D + cols, tl.sum(acc, axis=0), mask=cmask)


@triton.jit
def rmsnorm_dw_kernel(part_ptr, dw_ptr, P, D, PB: tl.constexpr, BLOCK: tl.constexpr):
    """``dw``: the programs' shares summed ``PB`` at a time in program
    order, the same order every run, so ``dw`` is the same bits."""
    cols = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    cmask = cols < D
    acc = tl.zeros((BLOCK,), dtype=tl.float32)
    for p0 in range(0, P, PB):
        rows = p0 + tl.arange(0, PB)
        mask = (rows < P)[:, None] & cmask[None, :]
        acc += tl.sum(tl.load(part_ptr + rows[:, None] * D + cols[None, :], mask=mask,
                              other=0.0), axis=0)
    tl.store(dw_ptr + cols, acc.to(dw_ptr.dtype.element_ty), mask=cmask)
