"""Binding of the Hopper fused-MoE kernels (``csrc/fused_moe.cu``,
``csrc/fused_moe_wgmma.cu`` and their backwards).

Replaces ``_moe_kernel`` / ``fused_moe_pallas`` of
``repro/kernels/fused_moe/kernel.py``; each source file's head says what
bounds its kernel and how it is laid out. Each library is compiled with
``nvcc`` for ``sm_90a`` at first use (``kernels._build``) and called through
ctypes on PyTorch's current stream. A failed build or launch raises.

``launch_plan`` computes both launches' geometry in Python, so the CPU
tests reach it.

The forward runs on one of three engines, each its own library, chosen by
``fwd_engine`` from the type, the widths, the bases and block_f:

- ``csrc/fused_moe_wgmma.cu`` (bf16 whose rows and bases are 16-byte
  multiples: dbrx-132b's serving and training) on ``wgmma`` fed by TMA, one
  persistent CTA an SM walking ``fwd_wgmma_plan``'s tiles
  (``fwd_wgmma_walk``);
- ``csrc/fused_moe_tf32.cu`` (f32 whose rows and bases are 16-byte
  multiples: the tuner's f32 workloads, f32 training of an MoE model):
  3xTF32 on ``wgmma`` with A from registers, fed by TMA, the method of the
  3xTF32 backward; three launches (g^T, then u^T with h = silu(g) u in its
  epilogue, then y^T), each a persistent CTA an SM walking
  ``tf32_fwd_plan``'s tiles (``tf32_fwd_walk``);
- ``csrc/fused_moe.cu`` (rows TMA cannot address) on ``mma.sync``.

Each counts its own calls (``wgmma_launches``, ``tf32_launches``,
``launches``).

``fused_moe_bwd_cuda`` is the backward: four launches (g and u; dh with
the silu-mul backward in its epilogue; the three weight gradients; dx) of
one of three grouped-GEMM engines, each its own library so that the builds
run side by side:

- ``csrc/fused_moe_bwd_wgmma.cu`` (bf16 whose rows and bases are 16-byte
  multiples: dbrx-132b's and arctic-480b's training): ``wgmma`` fed by TMA
  through a ring of mbarriers, one persistent CTA an SM walking the
  launch's live 128 x 256 tiles; ``wgmma_plan`` and ``wgmma_walk`` give
  its geometry and each CTA's tiles;
- ``csrc/fused_moe_bwd_tf32.cu`` (f32 whose rows and bases are 16-byte
  multiples: f32 training of an MoE model, the tuner's f32 workload):
  3xTF32 on ``wgmma`` with A from registers, fed by TMA, each product
  written so that its B lies K-major (launches (1) and (2) compute g^T,
  u^T and dh^T; dy^T is the one copy); ``tf32_plan`` and ``tf32_walk``
  give its geometry and each CTA's tiles;
- ``csrc/fused_moe_bwd.cu`` (f32 and bf16 rows that TMA cannot address):
  ``mma.sync`` fed by ``cp.async``, a CTA a 128 x 128 tile;
  ``bwd_launch_plan`` gives its geometry.

``bwd_engine`` chooses among them from the type and the strides alone;
each engine counts its own calls (``bwd_wgmma_launches``,
``bwd_tf32_launches``, ``bwd_launches``), so a run shows which one ran.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels._build import load_cuda_library

#: forward calls on the ``mma.sync`` engine since the count was last set to
#: 0 (each launches the gate/up and the down kernels)
launches = 0
#: forward calls on the ``wgmma`` engine (each launches its gate/up and its
#: down kernel)
wgmma_launches = 0
#: forward calls on the 3xTF32 ``wgmma`` engine (each launches the three
#: kernels of ``tf32_fwd_plan``)
tf32_launches = 0
#: backward calls on the ``mma.sync`` engine since the count was last set
#: to 0 (each launches the four kernels of ``bwd_launch_plan``)
bwd_launches = 0
#: backward calls on the ``wgmma`` engine (each launches the four kernels
#: of ``wgmma_plan``)
bwd_wgmma_launches = 0
#: backward calls on the 3xTF32 ``wgmma`` engine (each launches dy's
#: transposing copy and the four kernels of ``tf32_plan``)
bwd_tf32_launches = 0
#: ``(E, C/block_m, F/block_f)`` of the last launch: the gate/up launch's
#: grid; the down launch covers ``(E, C/block_m, ceil(D/128))`` output tiles
#: and walks the ``F/block_f`` steps in order
last_grid: tuple | None = None

SOURCES = [Path(__file__).resolve().parent / "csrc" / "fused_moe.cu"]
BWD_SOURCES = [Path(__file__).resolve().parent / "csrc" / "fused_moe_bwd.cu"]
WGMMA_SOURCES = [Path(__file__).resolve().parent / "csrc" / "fused_moe_bwd_wgmma.cu"]
TF32_SOURCES = [Path(__file__).resolve().parent / "csrc" / "fused_moe_bwd_tf32.cu"]
FWD_WGMMA_SOURCES = [Path(__file__).resolve().parent / "csrc" / "fused_moe_wgmma.cu"]
FWD_TF32_SOURCES = [Path(__file__).resolve().parent / "csrc" / "fused_moe_tf32.cu"]
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
D_TILE = 128  # output columns of a down-launch CTA
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class LaunchPlan(NamedTuple):
    grid: tuple  # (E, C/bm, F/bf): the gate/up grid, the reference's grid_shape
    down_grid: tuple  # (E, C/bm, ceil(D/128)): the down launch's output tiles
    block_m: int  # rows a CTA owns (clamped to C)
    block_f: int  # F columns of a gate/up CTA and F per summation step (clamped to F)
    sub_rows: int  # rows a CTA computes at a time: 32, 64 or 128


def launch_plan(E: int, C: int, D: int, F: int, *, block_m: int = 128,
                block_f: int = 256) -> LaunchPlan:
    """The two launches' geometry for these shapes and knobs, after the
    reference's ``min(block, dim)`` clamp; raises where a block does not
    divide its dimension, as the reference's ``grid_shape`` does."""
    bm, bf = min(block_m, C), min(block_f, F)
    if bm <= 0 or bf <= 0 or C % bm or F % bf:
        raise ValueError(f"fused_moe_cuda: C={C} % block_m={bm} or F={F} % block_f={bf} != 0")
    sub_rows = 32 if bm <= 32 else 64 if bm <= 64 else 128
    return LaunchPlan((E, C // bm, F // bf), (E, C // bm, -(-D // D_TILE)), bm, bf, sub_rows)


#: the backward's output tile (rows x columns a CTA), and for each type the
#: k depth of a stage, its stages and the padding of a shared row of KS
#: values and of one of 128 (``csrc/fused_moe_bwd.cu``'s ``Cfg``)
BWD_TILE = (128, 128)
_BWD_CFG = {torch.float32: (32, 3, 4, 8), torch.bfloat16: (64, 3, 8, 8)}


class BwdLaunch(NamedTuple):
    name: str  # "gate_up", "dh", "dw" or "dx"
    grid: tuple  # the CUDA grid: (row tiles, column tiles, E * products)
    products: tuple  # each product's (M, N, K, K segments), out = A B
    layout: str  # "NN", "NT" or "TN": A, then B, stored as it is (N) or transposed (T)
    stages: int  # shared-memory stages of the ring the K tiles stream through
    smem: int  # dynamic shared bytes a CTA


def bwd_launch_plan(E: int, C: int, D: int, F: int,
                    dtype: torch.dtype = torch.bfloat16) -> tuple[BwdLaunch, ...]:
    """The backward's four launches in order, with the geometry
    ``csrc/fused_moe_bwd.cu`` launches: (1) ``g = x Wg``, ``u = x Wu``;
    (2) ``dh = dy Wd^T``, whose epilogue writes h, dg and du; (3) ``dWd =
    h^T dy``, ``dWg = x^T dg``, ``dWu = x^T du``; (4) ``dx = [dg | du]
    [Wg | Wu]^T`` over two K segments of F. A CTA owns a 128 x 128 tile of
    one product's output and walks all of its K in order; the grid covers
    the largest product of its launch, and a CTA past a smaller product's
    edge exits at once."""
    if dtype not in _BWD_CFG:
        raise TypeError(f"fused_moe backward: type {dtype}; expected float32 or bfloat16")
    if min(E, C, D, F) <= 0:
        raise ValueError(f"fused_moe backward: shapes E={E} C={C} D={D} F={F}")
    ks, stages, pk, pw = _BWD_CFG[dtype]
    mt, nt = BWD_TILE
    size = torch.empty((), dtype=dtype).element_size()
    a_el = {"N": mt * (ks + pk), "T": ks * (mt + pw)}
    b_el = {"N": ks * (nt + pw), "T": nt * (ks + pk)}
    out = []
    for name, products, layout in (
        ("gate_up", ((C, F, D, 1), (C, F, D, 1)), "NN"),
        ("dh", ((C, F, D, 1),), "NT"),
        ("dw", ((F, D, C, 1), (D, F, C, 1), (D, F, C, 1)), "TN"),
        ("dx", ((C, D, F, 2),), "NT"),
    ):
        grid = (max(-(-m // mt) for m, *_ in products), max(-(-n // nt) for _, n, *_ in products),
                E * len(products))
        smem = size * stages * (a_el[layout[0]] + b_el[layout[1]])
        out.append(BwdLaunch(name, grid, products, layout, stages, smem))
    return tuple(out)


#: the wgmma engine's output tile (rows x columns), k depth of a stage and
#: stages (``csrc/fused_moe_bwd_wgmma.cu``); the dw launch stages its output
#: in shared memory for TMA stores, 128 columns at a time (32 KB), and dh and
#: dx write bf16 rows through 2 KB of shared memory a consumer warp
WGMMA_TILE = (128, 256)
WGMMA_K, WGMMA_STAGES = 64, 4
WGMMA_STAGED = 128 * 128 * 2
WGMMA_ROW_SCRATCH = 8 * 2048
#: the wgmma library returns this plus a CUresult where a tensor map could
#: not be encoded (its ``kEncodeError``)
_ENCODE_ERROR = 100000


def bwd_engine(dtype: torch.dtype, D: int, F: int, aligned: bool = True) -> str:
    """Which engine runs the backward, from the type and the strides alone:
    ``"wgmma"`` for bf16 whose rows (D and F values) and bases
    (``aligned``) are 16-byte multiples, as TMA addresses them;
    ``"wgmma_tf32"`` for f32 whose rows and bases are (D and F multiples of
    4); ``"mma_sync"`` for the rest (f32 takes 3xTF32 there too)."""
    if aligned and dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0:
        return "wgmma"
    if aligned and dtype == torch.float32 and D % 4 == 0 and F % 4 == 0:
        return "wgmma_tf32"
    return "mma_sync"


class WgmmaLaunch(NamedTuple):
    name: str  # "gate_up", "dh", "dw" or "dx"
    products: tuple  # each product's (M, N, K, K segments), out = A B
    layout: str  # A then B: "K" stored K-major (K contiguous), "M" MN-major
    tiles: tuple  # each product's (row tiles, column tiles) an expert
    tiles_e: int  # tiles an expert: the walk covers E * tiles_e
    ctas: int  # the grid: min(SMs, live tiles), each CTA persistent
    stages: int  # shared-memory stages of the ring the K tiles stream through
    staged: bool  # the output goes out through a shared tile and TMA stores
    scratch: int  # shared bytes through which the consumer warps write bf16 rows
    smem: int  # dynamic shared bytes a CTA


def wgmma_plan(E: int, C: int, D: int, F: int, sms: int = 132) -> tuple[WgmmaLaunch, ...]:
    """The wgmma engine's four launches in order, as
    ``csrc/fused_moe_bwd_wgmma.cu`` launches them: the same products as
    ``bwd_launch_plan``, each operand staged as it lies (gate_up: x K-major,
    Wg and Wu MN-major; dh: dy and Wd K-major; dw: h, x, dy, dg, du
    MN-major; dx: dg, du, Wg, Wu K-major). A CTA walks the tiles ``t =
    cta, cta + ctas, ...`` of the flat walk ``wgmma_walk`` decodes."""
    if min(E, C, D, F, sms) <= 0:
        raise ValueError(f"fused_moe backward: shapes E={E} C={C} D={D} F={F}, {sms} SMs")
    bm, bn = WGMMA_TILE
    stage = (bm + bn) * WGMMA_K * 2
    out = []
    for name, products, layout in (
        ("gate_up", ((C, F, D, 1), (C, F, D, 1)), "KM"),
        ("dh", ((C, F, D, 1),), "KK"),
        ("dw", ((F, D, C, 1), (D, F, C, 1), (D, F, C, 1)), "MM"),
        ("dx", ((C, D, F, 2),), "KK"),
    ):
        tiles = tuple((-(-m // bm), -(-n // bn)) for m, n, *_ in products)
        tiles_e = sum(mt * nt for mt, nt in tiles)
        staged = name == "dw"
        scratch = WGMMA_ROW_SCRATCH if name in ("dh", "dx") else 0
        # alignment slack, the ring, the staged half tiles or row scratch, the ring's barriers
        smem = (1024 + WGMMA_STAGES * stage + staged * WGMMA_STAGED + scratch
                + 2 * WGMMA_STAGES * 8)
        out.append(WgmmaLaunch(name, products, layout, tiles, tiles_e, min(sms, E * tiles_e),
                               WGMMA_STAGES, staged, scratch, smem))
    return tuple(out)


def wgmma_walk(launch: WgmmaLaunch, E: int, cta: int):
    """The tiles CTA ``cta`` of ``launch`` computes, in order, as
    ``(expert, product, first row, first column)``: tile t of the flat walk
    is expert ``t // tiles_e``, then product by product, column tiles
    outer and row tiles fastest (``tile_of`` in the source)."""
    return _walk(launch, WGMMA_TILE, E, cta)


def _walk(launch, tile: tuple, E: int, cta: int):
    """``wgmma_walk`` and ``tf32_walk`` over ``launch``'s products' tiles of
    ``tile`` = (rows, columns)."""
    bm, bn = tile
    for t in range(cta, E * launch.tiles_e, launch.ctas):
        e, r = divmod(t, launch.tiles_e)
        p = 0
        while p + 1 < len(launch.tiles) and r >= launch.tiles[p][0] * launch.tiles[p][1]:
            r -= launch.tiles[p][0] * launch.tiles[p][1]
            p += 1
        mt = launch.tiles[p][0]
        yield e, p, (r % mt) * bm, (r // mt) * bn


#: the 3xTF32 engine's tile rows and columns, k depth of a stage (one
#: 128-byte swizzle row of f32) and stages of its ring
#: (``csrc/fused_moe_bwd_tf32.cu``)
TF32_M, TF32_N, TF32_K, TF32_STAGES = 128, 128, 32, 4


def tf32_cols(C: int) -> int:
    """The tile columns of the 3xTF32 engine's launches (1) and (2), whose
    N is C: 64 for C <= 64, else ``TF32_N`` (launches (3) and (4) take
    ``TF32_N``)."""
    return 64 if C <= 64 else TF32_N


def tf32_ld(C: int) -> int:
    """The row length, in values, of the 3xTF32 engine's C-wide arrays (g^T,
    u^T, dg^T, du^T, dy^T): C rounded up to 4, so that a row is a 16-byte
    multiple, as TMA addresses it."""
    return -(-C // 4) * 4


class Tf32Launch(NamedTuple):
    name: str  # "gate_up", "dh", "dw" or "dx"
    products: tuple  # each product's (M, N, K, K segments), out = A B
    layout: str  # A's major-ness: "K" (K contiguous) or "M" (MN-major); B is K-major
    tile: tuple  # (rows, columns) of an output tile
    tiles: tuple  # each product's (row tiles, column tiles) an expert
    tiles_e: int  # tiles an expert: the walk covers E * tiles_e
    ctas: int  # the grid: min(SMs, live tiles), each CTA persistent
    stages: int  # shared-memory stages of the ring the K tiles stream through
    smem: int  # dynamic shared bytes a CTA


def tf32_plan(E: int, C: int, D: int, F: int, sms: int = 132) -> tuple[Tf32Launch, ...]:
    """The 3xTF32 engine's four product launches in order, as
    ``csrc/fused_moe_bwd_tf32.cu`` launches them (after dy's transposing
    copy): the products of ``bwd_launch_plan``, each written so that its B
    lies K-major: (1) g^T = Wg^T x^T, u^T = Wu^T x^T and (2) dh^T = Wd dy^T
    (F x C, K = D); (3) dWd = h^T dy, dWg = x^T dg, dWu = x^T du (K = C);
    (4) dx over two K segments of F. A is MN-major except Wd in (2). A CTA
    walks the tiles ``t = cta, cta + ctas, ...`` of the flat walk
    ``tf32_walk`` decodes."""
    if min(E, C, D, F, sms) <= 0:
        raise ValueError(f"fused_moe backward: shapes E={E} C={C} D={D} F={F}, {sms} SMs")
    out = []
    for name, products, layout, bn in (
        ("gate_up", ((F, C, D, 1), (F, C, D, 1)), "M", tf32_cols(C)),
        ("dh", ((F, C, D, 1),), "K", tf32_cols(C)),
        ("dw", ((F, D, C, 1), (D, F, C, 1), (D, F, C, 1)), "M", TF32_N),
        ("dx", ((C, D, F, 2),), "M", TF32_N),
    ):
        tiles = tuple((-(-m // TF32_M), -(-n // bn)) for m, n, *_ in products)
        tiles_e = sum(mt * nt for mt, nt in tiles)
        # alignment slack, the ring (A, B and B's lo a stage), its full, split and empty barriers
        smem = 1024 + TF32_STAGES * (TF32_M + 2 * bn) * TF32_K * 4 + 3 * TF32_STAGES * 8
        out.append(Tf32Launch(name, products, layout, (TF32_M, bn), tiles, tiles_e,
                              min(sms, E * tiles_e), TF32_STAGES, smem))
    return tuple(out)


def tf32_walk(launch: Tf32Launch, E: int, cta: int):
    """The tiles CTA ``cta`` of ``launch`` computes, in order, as
    ``(expert, product, first row, first column)``: the flat walk of
    ``wgmma_walk`` over this launch's tiles (``tile_of`` in the source)."""
    return _walk(launch, launch.tile, E, cta)


#: the forward wgmma engine's stages of the ring, its B columns a stage and
#: the h columns of a gate/up tile (``csrc/fused_moe_wgmma.cu``)
FWD_WGMMA_STAGES, FWD_WGMMA_N, FWD_GATE_COLS = 4, 256, 128


def fwd_engine(dtype: torch.dtype, C: int, D: int, F: int, aligned: bool = True, *,
               block_f: int = 256) -> str:
    """Which engine runs the forward: ``"wgmma"`` for bf16 with rows to
    compute (C > 0) whose rows (D and F values) and bases (``aligned``) are
    16-byte multiples, as TMA addresses them, and whose F blocks are whole
    16-byte chunks; ``"wgmma_tf32"`` for f32 with rows to compute whose
    rows and bases are 16-byte multiples (D and F multiples of 4) and whose
    F blocks are whole 32-deep stages or all of F (its sum over F walks
    block_f steps in stages of 32 that never straddle one); ``"mma_sync"``
    otherwise (f32 takes 3xTF32 there too). The rows an expert set no
    threshold: at dbrx-132b's width the wgmma engine was the faster from a
    decode tick's 4 rows an expert to 640 (PERF.md, both engines timed in
    turns by ``tools/fused_moe_fwd_engines.py``)."""
    bf = min(block_f, F)
    if dtype == torch.bfloat16 and C > 0 and D % 8 == 0 and F % 8 == 0 and aligned \
            and bf % 8 == 0:
        return "wgmma"
    if dtype == torch.float32 and min(C, D, F) > 0 and D % 4 == 0 and F % 4 == 0 and aligned \
            and (bf % TF32_K == 0 or bf == F):
        return "wgmma_tf32"
    return "mma_sync"


class FwdWgmmaLaunch(NamedTuple):
    name: str  # "gate_up" or "down"
    tile: tuple  # (rows, columns) of a tile: rows 64 or 128; h's 128 or y's 256 columns
    consumers: int  # consumer warpgroups of 64 rows
    row_subs: int  # row sub-tiles a block of block_m rows
    row_tiles: int  # row tiles an expert: C / block_m blocks x row_subs
    col_block: int  # columns a column block: block_f (gate_up) or 256 (down)
    col_subs: int  # column sub-tiles a column block
    tiles_e: int  # tiles an expert: the walk covers E * tiles_e
    ctas: int  # the grid: min(SMs, live tiles), each CTA persistent
    k: int  # the summed dim, walked 64 deep a stage in order: D (gate_up) or F (down)
    stages: int  # shared-memory stages of the ring
    smem: int  # dynamic shared bytes a CTA


def fwd_wgmma_plan(E: int, C: int, D: int, F: int, block_m: int = 128, block_f: int = 256,
                   sms: int = 132) -> tuple[FwdWgmmaLaunch, ...]:
    """The forward wgmma engine's two launches, as ``csrc/fused_moe_wgmma.cu``
    launches them, after the reference's ``min(block, dim)`` clamp: (a)
    gate/up writes h in tiles of 64 or 128 rows (block_m 64, or more:
    sub-tiles of 128) by 128 of a block_f block's F columns (sub-tiles of
    128, the last cut at the block's edge); (b) down writes y in tiles of
    the same rows by 256 columns of D. A CTA walks the tiles ``t = cta,
    cta + ctas, ...`` of the flat walk ``fwd_wgmma_walk`` decodes. A block
    of fewer than 64 rows takes a 64-row tile and stores its own rows."""
    plan = launch_plan(E, C, D, F, block_m=block_m, block_f=block_f)
    bm, bf = plan.block_m, plan.block_f
    if min(E, sms) <= 0:
        raise ValueError(f"fused_moe wgmma forward: E={E}, {sms} SMs")
    kc = 1 if bm <= 64 else 2
    rows = 64 * kc
    row_subs = -(-bm // rows)
    row_tiles = C // bm * row_subs
    # alignment slack, the ring (A: rows x 64 k; B: 256 columns x 64 k), each
    # consumer warp's 2 KB of row scratch, the ring's full and empty barriers
    smem = (1024 + FWD_WGMMA_STAGES * (rows + FWD_WGMMA_N) * 64 * 2 + 4 * kc * 2048
            + 2 * FWD_WGMMA_STAGES * 8)
    out = []
    for name, cols, n, block, k in (("gate_up", FWD_GATE_COLS, F, bf, D),
                                    ("down", FWD_WGMMA_N, D, FWD_WGMMA_N, F)):
        col_subs = -(-block // cols)
        tiles_e = row_tiles * -(-n // block) * col_subs
        out.append(FwdWgmmaLaunch(name, (rows, cols), kc, row_subs, row_tiles, block, col_subs,
                                  tiles_e, min(sms, E * tiles_e), k, FWD_WGMMA_STAGES, smem))
    return tuple(out)


def fwd_wgmma_walk(launch: FwdWgmmaLaunch, E: int, C: int, n: int, block_m: int, cta: int):
    """The tiles CTA ``cta`` of ``launch`` computes and stores, in order, as
    ``(expert, first row, rows, first column, columns)``: tile t of the flat
    walk is expert ``t // tiles_e``, then column tile outer and row tile
    fastest (``tile_of`` in the source); ``n`` is the output's columns (F
    or D) and ``block_m`` the plan's clamped one."""
    rows_t, cols_t = launch.tile
    bm = min(block_m, C)
    for t in range(cta, E * launch.tiles_e, launch.ctas):
        e, r = divmod(t, launch.tiles_e)
        ci, mi = divmod(r, launch.row_tiles)
        mb, ms = divmod(mi, launch.row_subs)
        cb, cs = divmod(ci, launch.col_subs)
        n0 = cb * launch.col_block + cs * cols_t
        yield (e, mb * bm + ms * rows_t, min(rows_t, bm - ms * rows_t), n0,
               min(cols_t, launch.col_block - cs * cols_t, n - n0))


class Tf32FwdLaunch(NamedTuple):
    name: str  # "gate", "up" or "down"
    products: tuple  # (M, N, K): out^T (M x N) = A^T B over K; A the weights, MN-major
    tile: tuple  # (rows, columns) of a tile: 128 weight columns x 64 or 128 tokens
    row_block: int  # rows a row block: block_f (gate, up) or D (down)
    row_subs: int  # row tiles a row block
    row_tiles: int  # row tiles an expert
    col_block: int  # columns (tokens) a column block: block_m
    col_subs: int  # column tiles a column block
    col_tiles: int  # column tiles an expert
    tiles_e: int  # tiles an expert: the walk covers E * tiles_e
    ctas: int  # the grid: min(SMs, live tiles), each CTA persistent
    stages: int  # shared-memory stages of the ring the K tiles stream through
    smem: int  # dynamic shared bytes a CTA


def tf32_fwd_plan(E: int, C: int, D: int, F: int, block_m: int = 128, block_f: int = 256,
                  sms: int = 132) -> tuple[Tf32FwdLaunch, ...]:
    """The 3xTF32 forward engine's three launches in order, as
    ``csrc/fused_moe_tf32.cu`` launches them, after the reference's
    ``min(block, dim)`` clamp: (a) gate, g^T = Wg^T x^T, and (b) up, u^T =
    Wu^T x^T whose epilogue writes h = silu(g) u (F x C, K = D; rows in
    block_f blocks); (c) down, y^T = Wd^T h^T (D x C, K = F walked in order,
    block_f steps of 32-deep stages). The knobs: block_m blocks of tokens,
    each in column tiles of 64 (block_m <= 64) or 128; block_f blocks of F,
    each in row tiles of 128; a tile's rows and columns past its block are
    computed and not stored. A CTA walks the tiles ``t = cta, cta + ctas,
    ...`` of the flat walk ``tf32_fwd_walk`` decodes. Raises where the
    engine does not take block_f (a multiple of 32 or all of F)."""
    plan = launch_plan(E, C, D, F, block_m=block_m, block_f=block_f)
    bm, bf = plan.block_m, plan.block_f
    if min(E, sms) <= 0 or D % 4 or F % 4 or (bf % TF32_K and bf != F):
        raise ValueError(f"fused_moe 3xTF32 forward: E={E} D={D} F={F} block_f={bf}, {sms} SMs")
    bn = 64 if bm <= 64 else TF32_N
    col_subs = -(-bm // bn)
    # alignment slack, the ring (A, B and B's lo a stage), its full, split and empty barriers
    smem = 1024 + TF32_STAGES * (TF32_M + 2 * bn) * TF32_K * 4 + 3 * TF32_STAGES * 8
    out = []
    for name, (m, n, k), rb in (("gate", (F, C, D), bf), ("up", (F, C, D), bf),
                                ("down", (D, C, F), D)):
        row_subs = -(-rb // TF32_M)
        row_tiles, col_tiles = m // rb * row_subs, C // bm * col_subs
        out.append(Tf32FwdLaunch(name, (m, n, k), (TF32_M, bn), rb, row_subs, row_tiles, bm,
                                 col_subs, col_tiles, row_tiles * col_tiles,
                                 min(sms, E * row_tiles * col_tiles), TF32_STAGES, smem))
    return tuple(out)


def tf32_fwd_walk(launch: Tf32FwdLaunch, E: int, cta: int):
    """The tiles CTA ``cta`` of ``launch`` computes, in order, as ``(expert,
    first row, rows stored, first column, columns stored)``: tile t of the
    flat walk is expert ``t // tiles_e``, then row tile outer and column
    tile fastest (``tile_of`` in the source), so that the CTAs that read one
    weight panel run together. Rows and columns past a tile's blocks or
    past M and N are not stored (the source's gate launch also stores g^T's
    pad columns up to ``tf32_ld(C)``, which nothing reads)."""
    (bm_t, bn_t), (m, n, _) = launch.tile, launch.products
    for t in range(cta, E * launch.tiles_e, launch.ctas):
        e, r = divmod(t, launch.tiles_e)
        mi, ci = divmod(r, launch.col_tiles)
        mb, ms = divmod(mi, launch.row_subs)
        nb, cs = divmod(ci, launch.col_subs)
        m0, n0 = mb * launch.row_block + ms * bm_t, nb * launch.col_block + cs * bn_t
        yield (e, m0, min(bm_t, min((mb + 1) * launch.row_block, m) - m0), n0,
               min(bn_t, min((nb + 1) * launch.col_block, n) - n0))


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's library."""
    lib = load_cuda_library("fused_moe", SOURCES)
    lib.fused_moe_forward.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.fused_moe_forward.restype = ctypes.c_int
    lib.fused_moe_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_moe_smem_bytes.restype = ctypes.c_longlong
    return lib


def bwd_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the backward kernel's library."""
    lib = load_cuda_library("fused_moe_bwd", BWD_SOURCES)
    lib.fused_moe_backward.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.fused_moe_backward.restype = ctypes.c_int
    lib.fused_moe_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_moe_bwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def wgmma_library() -> ctypes.CDLL:
    """Build (once per source and header hash) and load the wgmma engine."""
    lib = load_cuda_library("fused_moe_bwd_wgmma", WGMMA_SOURCES)
    lib.fused_moe_backward_wgmma.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.fused_moe_backward_wgmma.restype = ctypes.c_int
    lib.fused_moe_bwd_wgmma_smem_bytes.argtypes = [ctypes.c_int]
    lib.fused_moe_bwd_wgmma_smem_bytes.restype = ctypes.c_longlong
    return lib


def tf32_library() -> ctypes.CDLL:
    """Build (once per source and header hash) and load the 3xTF32 engine."""
    lib = load_cuda_library("fused_moe_bwd_tf32", TF32_SOURCES)
    lib.fused_moe_backward_tf32.argtypes = (
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.fused_moe_backward_tf32.restype = ctypes.c_int
    lib.fused_moe_bwd_tf32_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_moe_bwd_tf32_smem_bytes.restype = ctypes.c_longlong
    return lib


def fwd_wgmma_library() -> ctypes.CDLL:
    """Build (once per source and header hash) and load the forward wgmma engine."""
    lib = load_cuda_library("fused_moe_wgmma", FWD_WGMMA_SOURCES)
    lib.fused_moe_forward_wgmma.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.fused_moe_forward_wgmma.restype = ctypes.c_int
    lib.fused_moe_wgmma_smem_bytes.argtypes = [ctypes.c_int]
    lib.fused_moe_wgmma_smem_bytes.restype = ctypes.c_longlong
    return lib


def fwd_tf32_library() -> ctypes.CDLL:
    """Build (once per source and header hash) and load the forward's 3xTF32
    engine."""
    lib = load_cuda_library("fused_moe_tf32", FWD_TF32_SOURCES)
    lib.fused_moe_forward_tf32.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.fused_moe_forward_tf32.restype = ctypes.c_int
    lib.fused_moe_tf32_smem_bytes.argtypes = [ctypes.c_int]
    lib.fused_moe_tf32_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(name: str, ts) -> tuple:
    """``(E, C, D, F)`` of ``x, w_gate, w_up, w_down`` (then any tensors
    shaped as x), after the checks both directions make."""
    x, w_gate, w_up, w_down = ts[:4]
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError(f"{name}: x and the weights must be CUDA tensors on one device")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for t in ts):
        raise TypeError(
            f"{name}: types {[t.dtype for t in ts]}; expected all float32 or all bfloat16"
        )
    if x.dim() != 3 or w_gate.dim() != 3:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}")
    E, C, D = x.shape
    F = w_gate.shape[2]
    if (w_gate.shape != (E, D, F) or w_up.shape != (E, D, F) or w_down.shape != (E, F, D)
            or any(t.shape != x.shape for t in ts[4:])):
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}, "
            f"w_up {tuple(w_up.shape)}, w_down {tuple(w_down.shape)}, "
            f"others {[tuple(t.shape) for t in ts[4:]]}"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: every tensor must be contiguous")
    return E, C, D, F


def fused_moe_cuda(
    x: torch.Tensor,  # (E, C, D)
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
    *,
    block_m: int = 128,
    block_f: int = 256,
) -> torch.Tensor:
    """``(silu(x Wg) * (x Wu)) Wd`` per expert, in x's type, on the engine
    ``fwd_engine`` picks."""
    ts = (x, w_gate, w_up, w_down)
    E, C, D, F = _check("fused_moe_cuda", ts)
    engine = fwd_engine(x.dtype, C, D, F, all(t.data_ptr() % 16 == 0 for t in ts),
                        block_f=block_f)
    if engine == "wgmma":
        return fused_moe_wgmma_cuda(*ts, block_m=block_m, block_f=block_f)
    if engine == "wgmma_tf32":
        return fused_moe_tf32_cuda(*ts, block_m=block_m, block_f=block_f)
    return fused_moe_mma_sync_cuda(*ts, block_m=block_m, block_f=block_f)


def fused_moe_wgmma_cuda(x, w_gate, w_up, w_down, *, block_m: int = 128,
                         block_f: int = 256) -> torch.Tensor:
    """The forward on the wgmma engine (``csrc/fused_moe_wgmma.cu``): bf16
    that ``fwd_engine`` gives to it; raises otherwise."""
    global wgmma_launches, last_grid
    ts = (x, w_gate, w_up, w_down)
    E, C, D, F = _check("fused_moe_wgmma_cuda", ts)
    plan = launch_plan(E, C, D, F, block_m=block_m, block_f=block_f)
    out = torch.empty_like(x)
    h = torch.empty((E, C, F), dtype=x.dtype, device=x.device)  # silu(x Wg) * (x Wu)
    if fwd_engine(x.dtype, C, D, F, all(t.data_ptr() % 16 == 0 for t in (*ts, h, out)),
                  block_f=block_f) != "wgmma":
        raise ValueError(f"fused_moe_wgmma_cuda: {x.dtype} with C={C}, D={D}, F={F}, "
                         f"block_f={block_f} or a base that is not a 16-byte multiple")
    lib = fwd_wgmma_library()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    launch = fwd_wgmma_plan(E, C, D, F, plan.block_m, plan.block_f, sms)[0]
    smem = lib.fused_moe_wgmma_smem_bytes(launch.consumers)
    if smem != launch.smem or smem > SMEM_LIMIT:
        raise RuntimeError(f"fused_moe_wgmma_cuda: the library takes {smem} shared bytes, the "
                           f"plan {launch.smem}, the limit {SMEM_LIMIT}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fused_moe_forward_wgmma(*(t.data_ptr() for t in (*ts, h, out)), E, C, D, F,
                                          plan.block_m, plan.block_f, sms, stream)
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"fused_moe_wgmma_cuda: a tensor map could not be encoded "
                           f"(CUresult {err - _ENCODE_ERROR})")
    if err != 0:
        raise RuntimeError(f"fused_moe_wgmma_cuda: launch failed with cudaError {err}")
    wgmma_launches += 1
    last_grid = plan.grid
    return out


def fused_moe_tf32_cuda(x, w_gate, w_up, w_down, *, block_m: int = 128,
                        block_f: int = 256) -> torch.Tensor:
    """The forward on the 3xTF32 wgmma engine (``csrc/fused_moe_tf32.cu``):
    f32 that ``fwd_engine`` gives to it; raises otherwise."""
    global tf32_launches, last_grid
    ts = (x, w_gate, w_up, w_down)
    E, C, D, F = _check("fused_moe_tf32_cuda", ts)
    plan = launch_plan(E, C, D, F, block_m=block_m, block_f=block_f)
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    gt = torch.empty((E, F, tf32_ld(C)), **f32)  # g^T, rows padded to 16 bytes
    h = torch.empty((E, C, F), **f32)  # silu(x Wg) * (x Wu)
    if fwd_engine(x.dtype, C, D, F, all(t.data_ptr() % 16 == 0 for t in (*ts, gt, h, out)),
                  block_f=block_f) != "wgmma_tf32":
        raise ValueError(f"fused_moe_tf32_cuda: {x.dtype} with C={C}, D={D}, F={F}, "
                         f"block_f={block_f} or a base that is not a 16-byte multiple")
    lib = fwd_tf32_library()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    launch = tf32_fwd_plan(E, C, D, F, plan.block_m, plan.block_f, sms)[0]
    smem = lib.fused_moe_tf32_smem_bytes(launch.tile[1])
    if smem != launch.smem or smem > SMEM_LIMIT:
        raise RuntimeError(f"fused_moe_tf32_cuda: the library takes {smem} shared bytes, the "
                           f"plan {launch.smem}, the limit {SMEM_LIMIT}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fused_moe_forward_tf32(*(t.data_ptr() for t in (*ts, gt, h, out)), E, C, D, F,
                                         plan.block_m, plan.block_f, sms, stream)
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"fused_moe_tf32_cuda: a tensor map could not be encoded "
                           f"(CUresult {err - _ENCODE_ERROR})")
    if err != 0:
        raise RuntimeError(f"fused_moe_tf32_cuda: launch failed with cudaError {err}")
    tf32_launches += 1
    last_grid = plan.grid
    return out


def fused_moe_mma_sync_cuda(x, w_gate, w_up, w_down, *, block_m: int = 128,
                            block_f: int = 256) -> torch.Tensor:
    """The forward on the mma.sync engine (``csrc/fused_moe.cu``): f32 or
    bf16, rows of any width."""
    global launches, last_grid
    ts = (x, w_gate, w_up, w_down)
    E, C, D, F = _check("fused_moe_mma_sync_cuda", ts)
    out = torch.empty_like(x)
    if x.numel() == 0 or F == 0:
        return out
    plan = launch_plan(E, C, D, F, block_m=block_m, block_f=block_f)
    lib = library()
    code = _DTYPE_CODE[x.dtype]
    smem = lib.fused_moe_smem_bytes(code, plan.sub_rows // 32)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fused_moe_cuda: {plan} needs {smem} bytes of shared memory a block, "
            f"more than {SMEM_LIMIT}"
        )
    h = torch.empty((E, C, F), dtype=x.dtype, device=x.device)  # silu(x Wg) * (x Wu)
    size = x.element_size()
    vec = all(t.data_ptr() % 16 == 0 for t in (*ts, h, out)) and all(
        n * size % 16 == 0 for n in (D, F, plan.block_f)
    )
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fused_moe_forward(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
            h.data_ptr(), out.data_ptr(), code, E, C, D, F, plan.block_m, plan.block_f,
            plan.sub_rows // 32, int(vec), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_moe_cuda: launch failed with cudaError {err}")
    launches += 1
    last_grid = plan.grid
    return out


def fused_moe_bwd_cuda(
    x: torch.Tensor,  # (E, C, D)
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
    dy: torch.Tensor,  # (E, C, D): the output's gradient
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dw_gate, dw_up, dw_down)`` of ``fused_moe_cuda`` for the
    output gradient ``dy``, in x's type, on the engine ``bwd_engine`` picks."""
    ts = (x, w_gate, w_up, w_down, dy)
    E, C, D, F = _check("fused_moe_bwd_cuda", ts)
    engine = bwd_engine(x.dtype, D, F, all(t.data_ptr() % 16 == 0 for t in ts))
    if engine == "wgmma":
        return fused_moe_bwd_wgmma_cuda(*ts)
    if engine == "wgmma_tf32":
        return fused_moe_bwd_tf32_cuda(*ts)
    return fused_moe_bwd_mma_sync_cuda(*ts)


def _workspaces(name, ts, tf32=False):
    """The shapes, the gradients and the workspaces of a backward call: f32
    g, u and typed h, dg, du (E, C, F); for the 3xTF32 engine (``tf32``)
    f32 g^T, u^T (E, F, Cp), h (E, C, F), dg^T, du^T (E, F, Cp) and dy^T
    (E, D, Cp), Cp = ``tf32_ld(C)``."""
    x = ts[0]
    E, C, D, F = _check(name, ts)
    grads = tuple(torch.empty_like(t) for t in ts[:4])
    f32 = dict(dtype=torch.float32, device=x.device)
    if tf32:
        cp = tf32_ld(C)
        work = (*(torch.empty((E, F, cp), **f32) for _ in range(2)),
                torch.empty((E, C, F), **f32),
                *(torch.empty((E, F, cp), **f32) for _ in range(2)),
                torch.empty((E, D, cp), **f32))
        return (E, C, D, F), grads, work
    work = (torch.empty((E, C, F), **f32), torch.empty((E, C, F), **f32),
            *(torch.empty((E, C, F), dtype=x.dtype, device=x.device) for _ in range(3)))
    return (E, C, D, F), grads, work


def fused_moe_bwd_wgmma_cuda(x, w_gate, w_up, w_down, dy):
    """The backward on the wgmma engine (``csrc/fused_moe_bwd_wgmma.cu``):
    bf16 whose rows and bases are 16-byte multiples; raises otherwise."""
    global bwd_wgmma_launches
    ts = (x, w_gate, w_up, w_down, dy)
    (E, C, D, F), grads, work = _workspaces("fused_moe_bwd_wgmma_cuda", ts)
    if bwd_engine(x.dtype, D, F, all(t.data_ptr() % 16 == 0 for t in (*ts, *grads, *work))) \
            != "wgmma":
        raise ValueError(f"fused_moe_bwd_wgmma_cuda: {x.dtype} with D={D}, F={F} or a base "
                         f"that is not a 16-byte multiple")
    if x.numel() == 0 or F == 0:
        return tuple(g.zero_() for g in grads)
    lib = wgmma_library()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    for i, launch in enumerate(wgmma_plan(E, C, D, F, sms)):
        if lib.fused_moe_bwd_wgmma_smem_bytes(i) != launch.smem or launch.smem > SMEM_LIMIT:
            raise RuntimeError(f"fused_moe_bwd_wgmma_cuda: {launch.name} takes "
                               f"{lib.fused_moe_bwd_wgmma_smem_bytes(i)} shared bytes, the "
                               f"plan {launch.smem}, the limit {SMEM_LIMIT}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fused_moe_backward_wgmma(*(t.data_ptr() for t in (*ts, *work, *grads)),
                                           E, C, D, F, sms, stream)
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"fused_moe_bwd_wgmma_cuda: a tensor map could not be encoded "
                           f"(CUresult {err - _ENCODE_ERROR})")
    if err != 0:
        raise RuntimeError(f"fused_moe_bwd_wgmma_cuda: launch failed with cudaError {err}")
    bwd_wgmma_launches += 1
    return grads


def fused_moe_bwd_tf32_cuda(x, w_gate, w_up, w_down, dy):
    """The backward on the 3xTF32 wgmma engine (``csrc/fused_moe_bwd_tf32.cu``):
    f32 whose rows and bases are 16-byte multiples; raises otherwise."""
    global bwd_tf32_launches
    ts = (x, w_gate, w_up, w_down, dy)
    (E, C, D, F), grads, work = _workspaces("fused_moe_bwd_tf32_cuda", ts, tf32=True)
    if bwd_engine(x.dtype, D, F, all(t.data_ptr() % 16 == 0 for t in (*ts, *grads, *work))) \
            != "wgmma_tf32":
        raise ValueError(f"fused_moe_bwd_tf32_cuda: {x.dtype} with D={D}, F={F} or a base "
                         f"that is not a 16-byte multiple")
    if x.numel() == 0 or F == 0:
        return tuple(g.zero_() for g in grads)
    lib = tf32_library()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    for i, launch in enumerate(tf32_plan(E, C, D, F, sms)):
        if lib.fused_moe_bwd_tf32_smem_bytes(i, C) != launch.smem or launch.smem > SMEM_LIMIT:
            raise RuntimeError(f"fused_moe_bwd_tf32_cuda: {launch.name} takes "
                               f"{lib.fused_moe_bwd_tf32_smem_bytes(i, C)} shared bytes, the "
                               f"plan {launch.smem}, the limit {SMEM_LIMIT}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fused_moe_backward_tf32(*(t.data_ptr() for t in (*ts, *work, *grads)),
                                          E, C, D, F, sms, stream)
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"fused_moe_bwd_tf32_cuda: a tensor map could not be encoded "
                           f"(CUresult {err - _ENCODE_ERROR})")
    if err != 0:
        raise RuntimeError(f"fused_moe_bwd_tf32_cuda: launch failed with cudaError {err}")
    bwd_tf32_launches += 1
    return grads


def fused_moe_bwd_mma_sync_cuda(x, w_gate, w_up, w_down, dy):
    """The backward on the mma.sync engine (``csrc/fused_moe_bwd.cu``):
    f32 or bf16, rows of any width."""
    global bwd_launches
    ts = (x, w_gate, w_up, w_down, dy)
    (E, C, D, F), grads, work = _workspaces("fused_moe_bwd_mma_sync_cuda", ts)
    if x.numel() == 0 or F == 0:
        return tuple(g.zero_() for g in grads)
    lib = bwd_library()
    code = _DTYPE_CODE[x.dtype]
    for i, launch in enumerate(bwd_launch_plan(E, C, D, F, x.dtype)):
        if lib.fused_moe_bwd_smem_bytes(code, i) != launch.smem:
            raise RuntimeError(f"fused_moe_bwd_mma_sync_cuda: {launch.name} takes "
                               f"{lib.fused_moe_bwd_smem_bytes(code, i)} shared bytes, the "
                               f"plan {launch.smem}")
    vec = all(t.data_ptr() % 16 == 0 for t in (*ts, *grads, *work)) and all(
        n * x.element_size() % 16 == 0 for n in (D, F))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fused_moe_backward(*(t.data_ptr() for t in (*ts, *work, *grads)),
                                     code, E, C, D, F, int(vec), stream)
    if err != 0:
        raise RuntimeError(f"fused_moe_bwd_mma_sync_cuda: launch failed with cudaError {err}")
    bwd_launches += 1
    return grads
