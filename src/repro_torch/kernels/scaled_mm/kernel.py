"""Binding of the Hopper W8A8 scaled-product kernels (``csrc/scaled_mm_wgmma.cu``
and ``csrc/scaled_mm.cu``).

Replaces ``_scaled_mm_kernel`` / ``scaled_mm_pallas`` of
``repro/kernels/scaled_mm/kernel.py``; each source file's head says what
bounds its kernel and how it is laid out. Each library is compiled with
``nvcc`` for ``sm_90a`` at first use (``kernels._build``) and called through
ctypes on PyTorch's current stream. A failed build, tensor-map encode or
launch raises.

The product runs on one of two engines, each its own library, chosen by
``engine`` from the widths, the bases and block_k:

- ``csrc/scaled_mm_wgmma.cu`` (K and N multiples of 16, 16-byte bases,
  block_k a multiple of 32: the tuner's workloads at every block it
  ranks) on int8 ``wgmma`` fed by TMA, the product computed transposed
  with w^T as register A; ``wgmma_plan`` and ``wgmma_walk`` give its
  geometry and each CTA's sub-tiles;
- ``csrc/scaled_mm.cu`` (the rest) on ``mma.sync`` fed by ``cp.async``;
  ``launch_plan`` gives its geometry.

Each counts its own calls (``wgmma_launches``, ``launches``). Both keep
the three blocks after the reference's largest-divisor clamp and record
the reference's grid in ``last_grid``. The plans are pure Python, so the
CPU tests reach them.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import largest_divisor_block
from repro_torch.kernels._build import load_cuda_library

#: calls on the ``mma.sync`` engine since the count was last set to 0
launches = 0
#: calls on the ``wgmma`` engine since the count was last set to 0
wgmma_launches = 0
#: ``(M/bm, N/bn, K/bk)`` of the last launch, either engine: a CTA owns
#: each (bm, bn) block and walks the ``K/bk`` axis in order
last_grid: tuple | None = None

SOURCES = [Path(__file__).resolve().parent / "csrc" / "scaled_mm.cu"]
WGMMA_SOURCES = [Path(__file__).resolve().parent / "csrc" / "scaled_mm_wgmma.cu"]
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
STAGES = 4  # the cp.async ring's depth (kStages in the source)
W_ROW_BYTES = 128  # bytes of a staged w row, any sub-tile width (kLdb)
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# sub-tile -> warps a CTA: (16 * MI) x 32 outputs a warp (Tile<> in the source)
_WARPS = {128: 8, 64: 4, 32: 2}


class LaunchPlan(NamedTuple):
    grid: tuple  # (M/bm, N/bn, K/bk): the reference's grid_shape
    block_m: int  # rows a CTA owns (largest divisor of M <= block_m)
    block_n: int  # columns a CTA owns
    block_k: int  # k of one step of the CTA's walk over K
    sub_tile: int  # square tensor-core sub-tile the CTA walks its block in
    warps: int  # warps a CTA
    stage_k: int  # k bytes of one cp.async stage: 64, or 32 where block_k <= 32
    stages: int  # stages in the ring
    smem_bytes: int  # dynamic shared memory a CTA
    vectorized: bool  # 16-byte cp.async staging (else byte by byte)


def launch_plan(M: int, K: int, N: int, *, block_m: int = 128, block_n: int = 128,
                block_k: int = 256, out_dtype: torch.dtype = torch.bfloat16) -> LaunchPlan:
    """The mma.sync engine's launch geometry for these shapes and knobs. ``vectorized``
    holds where the shapes allow 16-byte staging; the wrapper also asks the
    pointers to be 16-byte aligned."""
    if min(M, K, N) <= 0 or min(block_m, block_n, block_k) <= 0:
        raise ValueError(f"scaled_mm: M={M} K={K} N={N}, blocks ({block_m}, {block_n}, "
                         f"{block_k}) must be positive")
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"scaled_mm: out_dtype {out_dtype} not in {list(_OUT_CODE)}")
    bm = largest_divisor_block(M, block_m)
    bn = largest_divisor_block(N, block_n)
    bk = largest_divisor_block(K, block_k)
    small = min(bm, bn)
    sub = 128 if small >= 128 else 64 if small >= 64 else 32
    ks = 32 if bk <= 32 else 64
    smem = STAGES * (sub * (ks + 16) + ks * W_ROW_BYTES)
    vec = all(n % 16 == 0 for n in (K, N, bn, bk))
    return LaunchPlan((M // bm, N // bn, K // bk), bm, bn, bk, sub, _WARPS[sub], ks, STAGES,
                      smem, vec)


#: the wgmma engine's tile (tokens, columns of out: a consumer warpgroup's two
#: m64 tiles of w^T), its threads (a consumer and a producer warpgroup) and
#: the ring depth at each stage depth (``csrc/scaled_mm_wgmma.cu``)
WGMMA_TILE = (128, 128)
WGMMA_THREADS = 256
WGMMA_STAGES = {128: 3, 64: 4, 32: 4}


def engine(M: int, K: int, N: int, *, block_m: int = 128, block_n: int = 128,
           block_k: int = 256, aligned: bool = True) -> str:
    """Which engine runs the product: ``"wgmma"`` where TMA can address the
    operands (K and N multiples of 16, so that every row is a 16-byte
    multiple, and the five bases 16-byte multiples: ``aligned``) and the
    clamped block_k holds whole 32-deep ``wgmma`` steps; ``"mma_sync"``
    otherwise. Any block_m and block_n: a sub-tile's rows and columns past
    its block are computed and not stored."""
    bk = largest_divisor_block(K, block_k) if min(K, block_k) > 0 else 0
    if min(M, K, N) > 0 and K % 16 == 0 and N % 16 == 0 and aligned and bk % 32 == 0:
        return "wgmma"
    return "mma_sync"


class WgmmaPlan(NamedTuple):
    grid: tuple  # (M/bm, N/bn, K/bk): the reference's grid_shape
    block_m: int  # rows (tokens) of a CTA's block
    block_n: int  # columns of a CTA's block
    block_k: int  # k of one step of the walk over K
    tile: tuple  # (tokens, columns) of a sub-tile
    sub_tiles: tuple  # sub-tiles a block whose first column is a 16-column multiple,
    #                   (along M, along N), walked rows outer (``wgmma_walk``)
    ctas: int  # the 1-D grid: one CTA a block, column block major
    stage_k: int  # k bytes of a TMA stage: 128, 64 or 32, the largest dividing block_k
    stages: int  # stages in the ring
    threads: int  # a consumer warpgroup and a producer warpgroup
    smem_bytes: int  # dynamic shared memory a CTA


def wgmma_plan(M: int, K: int, N: int, *, block_m: int = 128, block_n: int = 128,
               block_k: int = 256) -> WgmmaPlan:
    """The wgmma engine's geometry for these shapes and knobs, after the
    reference's largest-divisor clamp, as ``csrc/scaled_mm_wgmma.cu``
    launches it: a CTA owns each (bm, bn) block and walks it in 128 x 128
    sub-tiles (``wgmma_walk``), each over all of K in stages of
    ``stage_k`` that never straddle a block_k step. Raises where the
    engine does not take the shapes (``engine``)."""
    plan = launch_plan(M, K, N, block_m=block_m, block_n=block_n, block_k=block_k)
    if engine(M, K, N, block_k=block_k) != "wgmma":
        raise ValueError(f"scaled_mm wgmma: M={M} K={K} N={N} block_k={plan.block_k}: K and N "
                         f"must be multiples of 16, block_k of 32")
    bm, bn, bk = plan.block_m, plan.block_n, plan.block_k
    tm, tn = WGMMA_TILE
    sk = 128 if bk % 128 == 0 else 64 if bk % 64 == 0 else 32
    stages = WGMMA_STAGES[sk]
    # alignment slack, the ring (x: tm rows of sk; w: sk rows of tn), full and empty barriers
    smem = 1024 + stages * (tm * sk + sk * tn) + 2 * stages * 8
    return WgmmaPlan(plan.grid, bm, bn, bk, WGMMA_TILE, (-(-bm // tm), -(-bn // tn)),
                     (M // bm) * (N // bn), sk, stages, WGMMA_THREADS, smem)


def wgmma_walk(plan: WgmmaPlan, M: int, cta: int):
    """The sub-tiles CTA ``cta`` computes, in order, as ``(first row, rows
    stored, first column stored, columns stored)``: its block is ``(cta %
    (M/bm), cta // (M/bm))``; a TMA box starts on a 16-column multiple, so
    the columns are walked from the multiple of 16 at or below the block's
    first; rows and columns past the block are not stored."""
    bm, bn = plan.block_m, plan.block_n
    tm, tn = plan.tile
    m_blk, n_blk = (cta % (M // bm)) * bm, (cta // (M // bm)) * bn
    n_first = n_blk - n_blk % 16
    n_subs = -(-(n_blk + bn - n_first) // tn)
    for t in range(plan.sub_tiles[0] * n_subs):
        m0 = m_blk + (t // n_subs) * tm
        n0 = max(n_first + (t % n_subs) * tn, n_blk)
        yield m0, min(tm, m_blk + bm - m0), n0, min(n_first + (t % n_subs + 1) * tn, n_blk + bn) - n0


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the mma.sync engine's library."""
    lib = load_cuda_library("scaled_mm", SOURCES)
    lib.scaled_mm_forward.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_longlong, ctypes.c_void_p]
    )
    lib.scaled_mm_forward.restype = ctypes.c_int
    return lib


def wgmma_library() -> ctypes.CDLL:
    """Build (once per source and header hash) and load the wgmma engine."""
    lib = load_cuda_library("scaled_mm_wgmma", WGMMA_SOURCES)
    lib.scaled_mm_wgmma_forward.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.scaled_mm_wgmma_forward.restype = ctypes.c_int
    lib.scaled_mm_wgmma_smem_bytes.argtypes = [ctypes.c_int]
    lib.scaled_mm_wgmma_smem_bytes.restype = ctypes.c_longlong
    return lib


_ENCODE_ERROR = 100000  # the library's code for a failed tensor-map encode (+ its CUresult)


def _check(name: str, x, w, sx, sw, out_dtype) -> tuple:
    """``(M, K, N, sx, sw)`` after the checks both engines make, the scales
    as contiguous f32 (the reference casts them)."""
    if not all(t.is_cuda and t.device == x.device for t in (x, w, sx, sw)):
        raise ValueError(f"{name}: x, w, sx, sw must be CUDA tensors on one device")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"{name}: x {x.dtype}, w {w.dtype}; expected int8")
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"{name}: out_dtype {out_dtype} not in {list(_OUT_CODE)}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    if sx.shape != (M,) or sw.shape != (N,):
        raise ValueError(f"{name}: sx {tuple(sx.shape)}, sw {tuple(sw.shape)}; M={M}, N={N}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous")
    return M, K, N, sx.to(torch.float32).contiguous(), sw.to(torch.float32).contiguous()


def scaled_mm_cuda(
    x: torch.Tensor,  # (M, K) int8
    w: torch.Tensor,  # (K, N) int8
    sx: torch.Tensor,  # (M,)
    sw: torch.Tensor,  # (N,)
    *,
    out_dtype: torch.dtype = torch.bfloat16,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 256,
) -> torch.Tensor:
    """``(float(x @ w) * sx[:, None]) * sw[None, :]`` on the engine
    ``engine`` picks."""
    M, K, N, sx32, sw32 = _check("scaled_mm_cuda", x, w, sx, sw, out_dtype)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, sx32, sw32))  # out: a fresh tensor
    blocks = dict(block_m=block_m, block_n=block_n, block_k=block_k)
    if engine(M, K, N, aligned=aligned, **blocks) == "wgmma":
        return scaled_mm_wgmma_cuda(x, w, sx32, sw32, out_dtype=out_dtype, **blocks)
    return scaled_mm_mma_sync_cuda(x, w, sx32, sw32, out_dtype=out_dtype, **blocks)


def scaled_mm_wgmma_cuda(x, w, sx, sw, *, out_dtype: torch.dtype = torch.bfloat16,
                         block_m: int = 128, block_n: int = 128,
                         block_k: int = 256) -> torch.Tensor:
    """The product on the wgmma engine (``csrc/scaled_mm_wgmma.cu``): the
    shapes ``engine`` gives to it; raises otherwise."""
    global wgmma_launches, last_grid
    M, K, N, sx, sw = _check("scaled_mm_wgmma_cuda", x, w, sx, sw, out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if engine(M, K, N, block_k=block_k,
              aligned=all(t.data_ptr() % 16 == 0 for t in (x, w, sx, sw, out))) != "wgmma":
        raise ValueError(f"scaled_mm_wgmma_cuda: M={M} K={K} N={N} block_k={block_k} or a base "
                         f"that is not a 16-byte multiple")
    plan = wgmma_plan(M, K, N, block_m=block_m, block_n=block_n, block_k=block_k)
    lib = wgmma_library()
    smem = lib.scaled_mm_wgmma_smem_bytes(plan.stage_k)
    if smem != plan.smem_bytes or smem > SMEM_LIMIT:
        raise RuntimeError(f"scaled_mm_wgmma_cuda: the library takes {smem} shared bytes, the "
                           f"plan {plan.smem_bytes}, the limit {SMEM_LIMIT}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.scaled_mm_wgmma_forward(
            x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(),
            _OUT_CODE[out_dtype], M, K, N, plan.block_m, plan.block_n, plan.block_k,
            plan.stage_k, stream,
        )
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"scaled_mm_wgmma_cuda: a tensor map could not be encoded "
                           f"(CUresult {err - _ENCODE_ERROR})")
    if err != 0:
        raise RuntimeError(f"scaled_mm_wgmma_cuda: launch failed with cudaError {err}")
    wgmma_launches += 1
    last_grid = plan.grid
    return out


def scaled_mm_mma_sync_cuda(x, w, sx, sw, *, out_dtype: torch.dtype = torch.bfloat16,
                            block_m: int = 128, block_n: int = 128,
                            block_k: int = 256) -> torch.Tensor:
    """The product on the mma.sync engine (``csrc/scaled_mm.cu``): any
    shapes, rows that are not 16-byte multiples staged byte by byte."""
    global launches, last_grid
    M, K, N, sx, sw = _check("scaled_mm_mma_sync_cuda", x, w, sx, sw, out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = launch_plan(M, K, N, block_m=block_m, block_n=block_n, block_k=block_k,
                       out_dtype=out_dtype)
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"scaled_mm_cuda: {plan} needs {plan.smem_bytes} bytes of shared "
                         f"memory a block, more than {SMEM_LIMIT}")
    vec = plan.vectorized and all(t.data_ptr() % 16 == 0 for t in (x, w, sx, sw, out))
    lib = library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.scaled_mm_forward(
            x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(),
            _OUT_CODE[out_dtype], M, K, N, plan.block_m, plan.block_n, plan.block_k,
            plan.sub_tile, plan.stage_k, int(vec), plan.smem_bytes, stream,
        )
    if err != 0:
        raise RuntimeError(f"scaled_mm_cuda: launch failed with cudaError {err}")
    launches += 1
    last_grid = plan.grid
    return out
