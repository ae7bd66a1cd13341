"""Binding of the Hopper flash-attention kernels.

They replace ``_fa_kernel`` / ``flash_attention_pallas`` of
``repro/kernels/flash_attention/kernel.py``; each source file's head says
what bounds it and how it is laid out. Each library is compiled with
``nvcc`` for ``sm_90a`` at first use (``kernels._build``) and called through
ctypes on PyTorch's current stream. A failed build, tensor-map encode or
launch raises; nothing falls back to another engine.

The forward has two engines, each its own library, and ``fwd_engine``
chooses between them from the type, the head dim and the bases alone:

- ``csrc/flash_attention_wgmma.cu`` (bf16 at head dims 64, 80, 128 and
  256 whose bases are 16-byte multiples: whisper-base's and hymba-1.5b's
  prefill at 64, stablelm-3b's at 80, qwen3-0.6b's, dbrx-132b's and
  llama-3.2-vision's prefill and training at 128, gemma2-2b's at 256):
  ``wgmma`` fed by TMA, one producer and two consumer warpgroups that take
  turns issuing their products; ``fwd_wgmma_plan`` gives its geometry and
  ``fwd_wgmma_tiles`` the key tiles each sub-block of rows walks;
- ``csrc/flash_attention.cu`` (f32, the other head dims 8-32, and bf16
  bases TMA cannot address): ``mma.sync`` fed by ``cp.async`` for bf16, the
  FMA units for f32.

Each counts its own calls (``wgmma_launches``, ``launches``).

``launch_plan`` computes the launch geometry in Python, so the CPU tests
reach it: ``block_q`` sets the q rows a CTA owns and ``block_k`` the keys of
one online-softmax step, after the reference's ``min(block, dim)`` clamp;
both engines launch its grid.

With ``return_lse=True`` the forward also writes each row's log-sum-exp,
``(B, Hq, S)`` f32, which ``flash_attention_bwd_cuda`` takes: the backward
kernels of ``csrc/flash_attention_bwd.cu`` (its own library, so that its
build runs beside the forward's), for head dims ``BWD_HEAD_DIMS``.
``bwd_launch_plan`` computes their geometry in Python, as ``launch_plan``
does the forward's: the kernels in launch order, their grids, the block
each launch position takes, the tiles, the ring's stages and the shared
bytes; the wrapper passes the plan's tiles to the library.

The backward has two engines, each its own library so that the builds run
side by side, and ``bwd_engine`` chooses between them from the type, the
head dim and the bases alone:

- ``csrc/flash_attention_bwd_wgmma.cu`` (bf16 at head dims 64, 80, 128
  and 256 whose bases are 16-byte multiples: whisper-base's and
  hymba-1.5b's at 64, stablelm-3b's at 80, qwen3-0.6b's, dbrx-132b's and
  llama-3.2-vision's training at 128, gemma2-2b's at 256): ``wgmma`` fed by
  TMA through mbarrier rings, two consumer warpgroups a CTA;
  ``bwd_wgmma_plan`` gives its geometry at each head dim;
- ``csrc/flash_attention_bwd.cu`` (f32, head dims 8-32, and bf16 bases TMA
  cannot address): ``mma.sync`` fed by ``cp.async``.

Each engine counts its own calls (``bwd_wgmma_launches``,
``bwd_launches``), so a run shows which one ran. ``q_offset``, on every
entry point, is the position of q's first row for the masks (a rank's
block of the query rows, ``ops.row_split``); the keys' start at 0.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels._build import load_cuda_library

#: forward calls on the ``mma.sync`` engine since the count was last set to 0
launches = 0
#: forward calls on the ``wgmma`` engine (``csrc/flash_attention_wgmma.cu``)
wgmma_launches = 0
#: backward calls on the ``mma.sync`` engine since the count was last set
#: to 0 (each launches the kernels of ``bwd_launch_plan``)
bwd_launches = 0
#: backward calls on the ``wgmma`` engine (each launches the two kernels of
#: ``bwd_wgmma_plan``)
bwd_wgmma_launches = 0
#: ``(B*Hq, ceil(S/bq), ceil(Skv/bk))`` of the last launch: the CUDA grid is
#: the first two; each CTA walks the third, its softmax steps, in order
last_grid: tuple | None = None

SOURCES = [Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"]
BWD_SOURCES = [Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"]
WGMMA_SOURCES = [Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd_wgmma.cu"]
FWD_WGMMA_SOURCES = [Path(__file__).resolve().parent / "csrc" / "flash_attention_wgmma.cu"]
HEAD_DIMS = (8, 16, 32, 64, 80, 128, 256)
#: head dims of the backward kernels
BWD_HEAD_DIMS = (8, 16, 32, 64, 80, 128, 256)
#: bf16 backward tiles, the one set ``csrc`` builds: for dK/dV the q rows of
#: a step, the stages of its ring and the warps a CTA (16 keys each); for dQ
#: the keys of a step, its stages and warps (16 q rows each)
BWD_TILES = ((64, 2, 4), (64, 2, 4))
_F32_BLOCK, _F32_STRIDE = 64, 68  # the f32 kernels' 64 x 64 tile and its padded row
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class LaunchPlan(NamedTuple):
    grid: tuple  # (B*Hq, q blocks, softmax steps): the reference's grid_shape
    block_q: int  # q rows a CTA owns (clamped to S)
    block_k: int  # keys of one softmax step (clamped to Skv)
    kt: int  # keys of a register sub-tile
    warps: int  # warps a CTA; it walks its block_q rows a sub-block at a time


def launch_plan(
    B: int, S: int, Skv: int, Hq: int, Hkv: int, D: int,
    *, block_q: int = 128, block_k: int = 128, dtype: torch.dtype = torch.bfloat16,
) -> LaunchPlan:
    """The kernel's launch geometry for these shapes and knobs. Lengths
    need not divide the blocks (the kernel masks ragged edges); where they
    do, ``grid`` equals the reference's ``grid_shape``. Raises on a
    knob or shape the kernel cannot take; it never clamps a knob beyond
    the reference's ``min(block, dim)``."""
    if block_q <= 0 or block_k <= 0:
        raise ValueError(f"flash_attention: blocks must be positive, got {block_q}, {block_k}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    bq, bk = min(block_q, S), min(block_k, Skv)
    if dtype == torch.float32:
        kt, warps = 64, 8  # the FMA path: 256 threads over 64 rows x 64 keys
    else:
        kt_max = 128 if D <= 128 else 64  # S and the output must fit in registers
        kt = kt_max if bk >= kt_max else next(t for t in (32, 64, 128) if t >= bk)
        warps = min(8, -(-bq // 16))  # 16 q rows a warp
    grid = (B * Hq, -(-S // bq), -(-Skv // bk))
    return LaunchPlan(grid, bq, bk, kt, warps)


class BwdKernel(NamedTuple):
    name: str  # "delta", "dq" or "dkdv"
    grid: tuple  # the CUDA grid; bf16 at head dim 256 adds z = 2, the 128-column halves
    order: tuple  # the block blockIdx.y = 0, 1, ... takes: q blocks (dq), key blocks (dkdv)
    rows: int  # q rows (dq) or keys (dkdv) a CTA owns; rows (delta) of a CTA
    step: int  # keys (dq) or q rows (dkdv) of one step of the CTA's walk
    stages: int  # shared-memory stages of the ring the steps' tiles stream through
    warps: int  # warps a CTA
    smem: int  # dynamic shared bytes a CTA


def _heavy_first(n: int, rows: int, length: int) -> tuple:
    """The q block each dQ launch position takes (the kernel's
    ``heavy_first``): the last block first, since under a causal mask its
    rows see the most keys; a ragged last block, lighter than the full one
    before it, last."""
    if length % rows:
        return (*range(n - 2, -1, -1), n - 1)
    return tuple(range(n - 1, -1, -1))


def bwd_launch_plan(
    B: int, S: int, Skv: int, Hq: int, Hkv: int, D: int, dtype: torch.dtype = torch.bfloat16,
) -> tuple[BwdKernel, ...]:
    """The backward's kernels in launch order, with the geometry
    ``csrc/flash_attention_bwd.cu`` launches. bf16: dQ (which also writes
    Delta), then dK/dV, their tiles and warps from ``BWD_TILES``; f32:
    Delta, dK/dV, dQ on 64 x 64 tiles, one stage, holding at most 128
    head-dim columns of a shared tile at a time. Both grids put the block
    that the most causal pairs fall in first. At head dim 256 each bf16
    block is two CTAs, each owning 128 columns of dQ (or of dK and dV).
    Raises on a head dim the kernels do not take."""
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention backward: head dim {D} not in {BWD_HEAD_DIMS}")
    if dtype == torch.float32:
        bb, bs, dc = _F32_BLOCK, _F32_STRIDE, min(D, 128)
        nq, nk, rows = -(-S // bb), -(-Skv // bb), B * S * Hq
        return (
            BwdKernel("delta", (-(-rows // 8),), (), 8, 0, 0, 8, 0),
            BwdKernel("dkdv", (B * Hkv, nk), tuple(range(nk)), bb, bb, 1, 8,
                      4 * (4 * dc * bs + 2 * bb * bs + 2 * bb)),
            BwdKernel("dq", (B * Hq, nq), _heavy_first(nq, bb, S), bb, bb, 1, 8,
                      4 * (4 * dc * bs + bb * bs + 2 * bb)),
        )
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention backward: type {dtype}; expected float32 or bfloat16")
    (tq, kv_stages, kv_warps), (tk, q_stages, q_warps) = BWD_TILES
    ld = max(D, 16) + 8  # a shared row: head dims below 16 pad to 16, plus 16 bytes
    kv_rows, q_rows = 16 * kv_warps, 16 * q_warps
    nq, nk = -(-S // q_rows), -(-Skv // kv_rows)
    halves = (2,) if D > 128 else ()
    return (
        BwdKernel("dq", (B * Hq, nq, *halves), _heavy_first(nq, q_rows, S), q_rows, tk, q_stages,
                  q_warps, 2 * ld * (2 * q_rows + 2 * q_stages * tk)),
        BwdKernel("dkdv", (B * Hkv, nk, *halves), tuple(range(nk)), kv_rows, tq, kv_stages,
                  kv_warps, 2 * ld * (2 * kv_rows + 2 * kv_stages * tq) + 4 * 2 * kv_stages * tq),
    )


#: the wgmma engine (``csrc/flash_attention_bwd_wgmma.cu``): its head dims;
#: at each, for dQ the q rows of a CTA (64 a consumer warpgroup), the keys of
#: a step and the slots of its K and V rings; for dK/dV the keys of a CTA
#: (D 256: 64, each consumer warpgroup 128 of the columns; D 64, 80, 128:
#: 128, 64 a consumer warpgroup), the q rows of a step and the stages of its
#: q/dO ring; consumer warpgroups a CTA (one more loads)
WGMMA_HEAD_DIMS = (64, 80, 128, 256)
WGMMA_DQ = {64: (128, 64, (3, 2)), 80: (128, 64, (3, 2)), 128: (128, 64, (3, 2)),
            256: (128, 64, (2, 1))}
WGMMA_DKDV = {64: (128, 64, (3,)), 80: (128, 64, (3,)), 128: (128, 64, (3,)),
              256: (64, 64, (2,))}
WGMMA_WARPGROUPS = 2
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
#: the wgmma library returns this plus a CUresult where a tensor map could
#: not be encoded (its ``kEncodeError``)
_ENCODE_ERROR = 100000


def bwd_engine(dtype: torch.dtype, D: int, aligned: bool = True) -> str:
    """Which engine runs the backward: ``"wgmma"`` for bf16 at head dim 64,
    80, 128 or 256 whose bases (``aligned``) are 16-byte multiples, as TMA
    addresses them; ``"mma_sync"`` otherwise (f32, head dims 8-32)."""
    return ("wgmma" if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS and aligned
            else "mma_sync")


class WgmmaKernel(NamedTuple):
    name: str  # "dq" (which also writes Delta) or "dkdv", in launch order
    grid: tuple  # the CUDA grid (heads, blocks)
    order: tuple  # the block blockIdx.y = 0, 1, ... takes: q blocks (dq), key blocks (dkdv)
    rows: int  # q rows (dq) or keys (dkdv) a CTA owns
    step: int  # keys (dq) or q rows (dkdv) of one step of the CTA's walk
    stages: tuple  # slots of each ring: K and V (dq), q and dO tiles together (dkdv)
    warpgroups: int  # consumer warpgroups a CTA, each 128 threads; one more loads
    smem: int  # dynamic shared bytes a CTA


def bwd_wgmma_plan(B: int, S: int, Skv: int, Hq: int, Hkv: int, D: int
                   ) -> tuple[WgmmaKernel, ...]:
    """The wgmma engine's two launches in order, as
    ``csrc/flash_attention_bwd_wgmma.cu`` launches them at head dim ``D``.
    dQ: a CTA owns 128 q rows of one head, 64 a consumer warpgroup, with Q
    and dO resident and K and V tiles streaming through rings (D 256: 2 and
    1 slots; D 64, 80, 128: 3 and 2); heaviest causal block first
    (``_heavy_first``). dK/dV: a CTA owns keys of one KV head (D 256: 64,
    each consumer warpgroup owning 128 of the 256 columns of dK and dV; D
    64, 80, 128: 128, 64 a consumer warpgroup over all columns), K and V
    resident, walking its group's q heads and tiles with the q and dO tiles
    in a ring (D 256: two stages; below: three). Shared bytes: 1 KB of
    alignment slack, the bf16 tiles (a 64-row tile in boxes of 64 columns,
    64 x 64 x 2 bytes a box: D 80 takes two, as D 128 does), at D 256 P^T
    and dS^T (8 KB each, twice: even and odd steps), below it each stage's
    lse and Delta (64 f32 each), and 8 bytes a barrier. Raises on a shape
    the engine does not take."""
    if D not in WGMMA_HEAD_DIMS or min(B, S, Skv, Hkv) <= 0 or Hq % Hkv:
        raise ValueError(f"flash_attention wgmma backward: B={B} S={S} Skv={Skv} "
                         f"Hq={Hq} Hkv={Hkv} D={D}; it takes head dims {WGMMA_HEAD_DIMS}")
    tile = 64 * -(-D // 64) * 64 * 2
    (q_rows, tk, (k_slots, v_slots)), (kv_rows, tq, (st,)) = WGMMA_DQ[D], WGMMA_DKDV[D]
    nq, nk = -(-S // q_rows), -(-Skv // kv_rows)
    dq_smem = 1024 + 2 * (q_rows // 64) * tile + (k_slots + v_slots) * tile \
        + 8 * (1 + 2 * k_slots + 2 * v_slots)
    staged = 2 * 2 * 64 * 64 * 2 if D == 256 else st * 2 * 64 * 4
    dkdv_smem = 1024 + 2 * (kv_rows // 64) * tile + st * 2 * tile + staged + 8 * (1 + 2 * st)
    return (
        WgmmaKernel("dq", (B * Hq, nq), _heavy_first(nq, q_rows, S), q_rows, tk,
                    (k_slots, v_slots), WGMMA_WARPGROUPS, dq_smem),
        WgmmaKernel("dkdv", (B * Hkv, nk), tuple(range(nk)), kv_rows, tq, (st,),
                    WGMMA_WARPGROUPS, dkdv_smem),
    )


#: the forward wgmma engine (``csrc/flash_attention_wgmma.cu``): its head
#: dims, the keys of a tile at each, the q rows of a sub-block (64 a
#: consumer warpgroup) and the stages of its K/V ring. A row of D values is
#: loaded in boxes of 64 columns: at D 64 one, at D 80 two, the second's
#: last 48 columns zeros (``fwd_wgmma_plan`` counts the padded boxes' bytes)
FWD_WGMMA_HEAD_DIMS = (64, 80, 128, 256)
FWD_WGMMA_TILE_KEYS = {64: 128, 80: 128, 128: 128, 256: 64}
FWD_WGMMA_SUB_ROWS = 64 * WGMMA_WARPGROUPS
FWD_WGMMA_STAGES = 2


def fwd_engine(dtype: torch.dtype, D: int, aligned: bool = True) -> str:
    """Which engine runs the forward: ``"wgmma"`` for bf16 at head dim 64,
    80, 128 or 256 whose bases (``aligned``) are 16-byte multiples, as TMA
    addresses them; ``"mma_sync"`` otherwise (f32, head dims 8-32)."""
    return ("wgmma" if dtype == torch.bfloat16 and D in FWD_WGMMA_HEAD_DIMS and aligned
            else "mma_sync")


class FwdWgmmaPlan(NamedTuple):
    grid: tuple  # the CUDA grid (B*Hq, q blocks)
    order: tuple  # the q block blockIdx.y = 0, 1, ... takes: the heaviest causal one first
    block_q: int  # q rows a CTA owns (clamped to S), walked SUB_ROWS at a time
    block_k: int  # keys of a step (clamped to Skv), cut into tiles of tile_keys
    sub_rows: int  # q rows of a sub-block: 64 a consumer warpgroup
    tile_keys: int  # keys of one tile: the N of S = Q K^T
    tiles_per_step: int
    stages: int  # stages of the K/V ring
    warpgroups: int  # consumer warpgroups a CTA, each 128 threads; one more loads
    smem: int  # dynamic shared bytes a CTA


def fwd_wgmma_plan(B: int, S: int, Skv: int, Hq: int, Hkv: int, D: int, *,
                   block_q: int = 128, block_k: int = 128) -> FwdWgmmaPlan:
    """The forward wgmma engine's launch, as ``csrc/flash_attention_wgmma.cu``
    makes it, after the reference's ``min(block, dim)`` clamp: a CTA owns
    ``block_q`` q rows of one head and walks them 128 at a time; each step
    of ``block_k`` keys is cut into tiles of 128 keys (D 64, 80, 128) or 64
    (D 256). Shared bytes: 1 KB of alignment slack, each consumer's Q tile
    (64 rows), the ring's K and V tiles (rows in boxes of 64 columns: D 80
    takes 128), 8 bytes a barrier. Raises on a shape the
    engine does not take."""
    plan = launch_plan(B, S, Skv, Hq, Hkv, D, block_q=block_q, block_k=block_k)
    if D not in FWD_WGMMA_HEAD_DIMS or min(B, S, Skv) <= 0:
        raise ValueError(f"flash_attention wgmma forward: B={B} S={S} Skv={Skv} D={D}; "
                         f"it takes head dims {FWD_WGMMA_HEAD_DIMS}")
    bn = FWD_WGMMA_TILE_KEYS[D]
    nq = plan.grid[1]
    padded = -(-D // 64) * 64
    q_tile, kv_tile = 64 * padded * 2, bn * padded * 2
    smem = (1024 + WGMMA_WARPGROUPS * q_tile + FWD_WGMMA_STAGES * 2 * kv_tile
            + 8 * (2 + 4 * FWD_WGMMA_STAGES))
    return FwdWgmmaPlan((B * Hq, nq), _heavy_first(nq, plan.block_q, S), plan.block_q,
                        plan.block_k, FWD_WGMMA_SUB_ROWS, bn, -(-plan.block_k // bn),
                        FWD_WGMMA_STAGES, WGMMA_WARPGROUPS, smem)


def fwd_wgmma_tiles(plan: FwdWgmmaPlan, S: int, Skv: int, *, causal: bool = True,
                    window: int | None = None, q_offset: int = 0):
    """The key tiles each sub-block of the plan walks, in the order its CTA
    walks them (the source's ``Walk``): ``(first row, rows, [(first key,
    keys), ...])`` for every sub-block of every q block in launch order.
    A tile holds the keys of its step from its first key to its step's end
    or ``tile_keys`` on; the tiles the masks remove for every row of the
    sub-block are not walked; a sub-block holding a row that sees no key
    walks them all."""
    bq, bk, bn, w = plan.block_q, plan.block_k, plan.tile_keys, window or 0
    out = []
    for blk in plan.order:
        r_end = min(blk * bq + bq, S)
        for r0 in range(blk * bq, r_end, plan.sub_rows):
            p0, p1 = r0 + q_offset, min(r0 + plan.sub_rows, r_end) - 1 + q_offset
            k_hi = min(Skv, p1 + 1) if causal else Skv
            k_lo = max(0, p0 - w + 1) if w > 0 else 0
            if w > 0 and p1 >= Skv + w - 1:
                k_lo = 0
            tiles = []
            for j in range(k_lo // bk, -(-k_hi // bk)):
                e = min((j + 1) * bk, Skv)
                for k0 in range(j * bk, min(e, k_hi), bn):
                    if min(k0 + bn, e) > k_lo:
                        tiles.append((k0, min(k0 + bn, e) - k0))
            out.append((r0, min(r0 + plan.sub_rows, r_end) - r0, tiles))
    return out


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the mma.sync engine's library."""
    lib = load_cuda_library("flash_attention", SOURCES)
    fn = lib.fa_forward
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def bwd_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the backward kernel's library."""
    lib = load_cuda_library("flash_attention_bwd", BWD_SOURCES)
    fn = lib.fa_backward
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fwd_wgmma_library() -> ctypes.CDLL:
    """Build (once per source and header hash) and load the forward's
    wgmma engine."""
    lib = load_cuda_library("flash_attention_wgmma", FWD_WGMMA_SOURCES)
    lib.fa_forward_wgmma.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.fa_forward_wgmma.restype = ctypes.c_int
    lib.fa_fwd_wgmma_smem_bytes.argtypes = [ctypes.c_int]
    lib.fa_fwd_wgmma_smem_bytes.restype = ctypes.c_longlong
    return lib


def wgmma_library() -> ctypes.CDLL:
    """Build (once per source and header hash) and load the wgmma engine."""
    lib = load_cuda_library("flash_attention_bwd_wgmma", WGMMA_SOURCES)
    lib.fa_backward_wgmma.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
        + [ctypes.c_int] + [ctypes.c_void_p])
    lib.fa_backward_wgmma.restype = ctypes.c_int
    lib.fa_bwd_wgmma_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fa_bwd_wgmma_smem_bytes.restype = ctypes.c_longlong
    return lib


def flash_attention_cuda(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    block_q: int = 128,
    block_k: int = 128,
    return_lse: bool = False,
    q_offset: int = 0,
):
    """The attention output, and with ``return_lse`` also each row's
    log-sum-exp ``(B, Hq, S)`` f32 (``-inf`` for a row that sees no key),
    on the engine ``fwd_engine`` picks. Row i is masked at position
    ``q_offset + i``."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale, block_q=block_q,
              block_k=block_k, return_lse=return_lse, q_offset=q_offset)
    _fwd_check("flash_attention_cuda", q, k, v, window, softcap, q_offset)
    if fwd_engine(q.dtype, q.shape[-1], all(t.data_ptr() % 16 == 0 for t in (q, k, v))) == "wgmma":
        return flash_attention_wgmma_cuda(q, k, v, **kw)
    return flash_attention_mma_sync_cuda(q, k, v, **kw)


def _fwd_check(name: str, q, k, v, window, softcap, q_offset) -> tuple:
    """``(B, S, Skv, Hq, Hkv, D)`` after the checks every forward makes."""
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must be CUDA tensors on one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{name}: types {q.dtype}, {k.dtype}, {v.dtype}; expected one of float32, bfloat16"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: shapes {q.shape}, {k.shape}, {v.shape}")
    B, S, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k/v {tuple(k.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k, v must be contiguous")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"{name}: softcap must be positive, got {softcap}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {HEAD_DIMS}")
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset must be >= 0, got {q_offset}")
    return B, S, Skv, Hq, Hkv, D


def flash_attention_wgmma_cuda(q, k, v, *, causal=True, window=None, softcap=None, scale=None,
                               block_q=128, block_k=128, return_lse=False, q_offset=0):
    """The forward on the wgmma engine (``csrc/flash_attention_wgmma.cu``):
    bf16 at head dim 64, 80, 128 or 256 whose bases are 16-byte multiples;
    raises otherwise, and where a launch or a tensor map fails."""
    global wgmma_launches, last_grid
    name = "flash_attention_wgmma_cuda"
    B, S, Skv, Hq, Hkv, D = _fwd_check(name, q, k, v, window, softcap, q_offset)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device) if return_lse else None
    if fwd_engine(q.dtype, D, all(t.data_ptr() % 16 == 0 for t in (q, k, v, out))) != "wgmma":
        raise ValueError(f"{name}: {q.dtype} at head dim {D}, or a base that is not a 16-byte "
                         f"multiple; it takes bf16 at head dims {FWD_WGMMA_HEAD_DIMS}")
    if q.numel() == 0 or Skv == 0:
        return (out, lse) if return_lse else out
    plan = fwd_wgmma_plan(B, S, Skv, Hq, Hkv, D, block_q=block_q, block_k=block_k)
    lib = fwd_wgmma_library()
    smem = lib.fa_fwd_wgmma_smem_bytes(D)
    if smem != plan.smem or smem > SMEM_LIMIT:
        raise RuntimeError(f"{name}: the library takes {smem} shared bytes, the plan "
                           f"{plan.smem}, the limit {SMEM_LIMIT}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.fa_forward_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, B, S, Skv, Hq, Hkv, D, int(causal),
            window or 0, float(softcap or 0.0), scale if scale is not None else 1.0 / math.sqrt(D),
            plan.block_q, plan.block_k, q_offset, stream)
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"{name}: a tensor map could not be encoded "
                           f"(CUresult {err - _ENCODE_ERROR})")
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {err}")
    wgmma_launches += 1
    last_grid = launch_plan(B, S, Skv, Hq, Hkv, D, block_q=block_q, block_k=block_k).grid
    return (out, lse) if return_lse else out


def flash_attention_mma_sync_cuda(q, k, v, *, causal=True, window=None, softcap=None, scale=None,
                                  block_q=128, block_k=128, return_lse=False, q_offset=0):
    """The forward on the mma.sync engine (``csrc/flash_attention.cu``): f32
    or bf16, every head dim of ``HEAD_DIMS``."""
    global launches, last_grid
    B, S, Skv, Hq, Hkv, D = _fwd_check("flash_attention_mma_sync_cuda", q, k, v, window,
                                       softcap, q_offset)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device) if return_lse else None
    if q.numel() == 0 or Skv == 0:
        return (out, lse) if return_lse else out
    plan = launch_plan(B, S, Skv, Hq, Hkv, D, block_q=block_q, block_k=block_k, dtype=q.dtype)
    if q.dtype == torch.bfloat16:  # 16-byte asynchronous copies need aligned rows
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    lib = library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, _DTYPE_CODE[q.dtype],
            B, S, Skv, Hq, Hkv, D, int(causal), window or 0, float(softcap or 0.0),
            scale if scale is not None else 1.0 / math.sqrt(D),
            plan.block_q, plan.block_k, plan.kt, plan.warps, q_offset, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_mma_sync_cuda: launch failed with cudaError {err}")
    launches += 1
    last_grid = plan.grid
    return (out, lse) if return_lse else out


def _bwd_check(name: str, q, k, v, out, lse, dout, window, softcap, q_offset) -> tuple:
    """``(B, S, Skv, Hq, Hkv, D)`` after the checks every backward makes."""
    tensors = (q, k, v, out, lse, dout)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on q's CUDA device")
    if (q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in (k, v, out, dout))
            or lse.dtype != torch.float32):
        raise TypeError(f"{name}: q, k, v, out, dout of one type "
                        "(float32 or bfloat16) and an f32 lse")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}")
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if (k.shape != v.shape or out.shape != q.shape or dout.shape != q.shape
            or lse.shape != (B, Hq, S) or k.shape[0] != B or k.shape[3] != D or Hq % Hkv):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}, out {tuple(out.shape)}, lse {tuple(lse.shape)}, "
                         f"dout {tuple(dout.shape)}")
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {BWD_HEAD_DIMS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"{name}: softcap must be positive, got {softcap}")
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset must be >= 0, got {q_offset}")
    return B, S, Skv, Hq, Hkv, D


def flash_attention_bwd_cuda(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    out: torch.Tensor,  # the forward's output
    lse: torch.Tensor,  # (B, Hq, S) f32, the forward's
    dout: torch.Tensor,  # (B, S, Hq, D)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of ``flash_attention_cuda`` for the output gradient
    ``dout``, in q's type, on the engine ``bwd_engine`` picks."""
    args = (q, k, v, out, lse, dout)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale, q_offset=q_offset)
    if bwd_engine(q.dtype, q.shape[-1], all(t.data_ptr() % 16 == 0 for t in args)) == "wgmma":
        return flash_attention_bwd_wgmma_cuda(*args, **kw)
    return flash_attention_bwd_mma_sync_cuda(*args, **kw)


def flash_attention_bwd_wgmma_cuda(q, k, v, out, lse, dout, *, causal=True, window=None,
                                   softcap=None, scale=None, q_offset=0):
    """The backward on the wgmma engine (``csrc/flash_attention_bwd_wgmma.cu``):
    bf16 at head dim 64, 80, 128 or 256 whose bases are 16-byte multiples;
    raises otherwise, and where a launch or a tensor map fails."""
    global bwd_wgmma_launches
    name = "flash_attention_bwd_wgmma_cuda"
    B, S, Skv, Hq, Hkv, D = _bwd_check(name, q, k, v, out, lse, dout, window, softcap, q_offset)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    ts = (q, k, v, out, dout, lse, delta, dq, dk, dv)
    if bwd_engine(q.dtype, D, all(t.data_ptr() % 16 == 0 for t in ts)) != "wgmma":
        raise ValueError(f"{name}: {q.dtype} at head dim {D}, or a base that is not a "
                         f"16-byte multiple; it takes bf16 at head dims {WGMMA_HEAD_DIMS}")
    if q.numel() == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lib = wgmma_library()
    for i, kern in enumerate(bwd_wgmma_plan(B, S, Skv, Hq, Hkv, D)):
        if lib.fa_bwd_wgmma_smem_bytes(D, i) != kern.smem or kern.smem > SMEM_LIMIT:
            raise RuntimeError(f"{name}: {kern.name} takes {lib.fa_bwd_wgmma_smem_bytes(D, i)} "
                               f"shared bytes, the plan {kern.smem}, the limit {SMEM_LIMIT}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.fa_backward_wgmma(
            *(t.data_ptr() for t in ts), B, S, Skv, Hq, Hkv, D, int(causal), window or 0,
            float(softcap or 0.0), scale if scale is not None else 1.0 / math.sqrt(D),
            q_offset, stream)
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"{name}: a tensor map could not be encoded "
                           f"(CUresult {err - _ENCODE_ERROR})")
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {err}")
    bwd_wgmma_launches += 1
    return dq, dk, dv


def flash_attention_bwd_mma_sync_cuda(q, k, v, out, lse, dout, *, causal=True, window=None,
                                      softcap=None, scale=None, q_offset=0):
    """The backward on the mma.sync engine (``csrc/flash_attention_bwd.cu``):
    f32 or bf16, every head dim of ``BWD_HEAD_DIMS``."""
    global bwd_launches
    name = "flash_attention_bwd_mma_sync_cuda"
    B, S, Skv, Hq, Hkv, D = _bwd_check(name, q, k, v, out, lse, dout, window, softcap, q_offset)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    plan = {kern.name: kern for kern in bwd_launch_plan(B, S, Skv, Hq, Hkv, D, q.dtype)}
    if q.dtype == torch.bfloat16:  # 16-byte copies and loads need aligned rows
        q, k, v, out, dout = (t if t.data_ptr() % 16 == 0 else t.clone()
                              for t in (q, k, v, out, dout))
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    lib = bwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.fa_backward(
            *(t.data_ptr() for t in (q, k, v, out, dout, lse, delta, dq, dk, dv)),
            _DTYPE_CODE[q.dtype], B, S, Skv, Hq, Hkv, D, int(causal), window or 0,
            float(softcap or 0.0), scale if scale is not None else 1.0 / math.sqrt(D),
            *(x for name in ("dkdv", "dq") for x in (plan[name].step, plan[name].stages,
                                                      plan[name].warps)), q_offset, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_mma_sync_cuda: launch failed with cudaError {err}")
    bwd_launches += 1
    return dq, dk, dv
