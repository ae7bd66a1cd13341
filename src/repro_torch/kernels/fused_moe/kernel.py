"""Binding of the Hopper fused-MoE kernel (``csrc/fused_moe.cu``).

Replaces ``_moe_kernel`` / ``fused_moe_pallas`` of
``repro/kernels/fused_moe/kernel.py``; the source file's head says what
bounds the kernel and how it is laid out. The library is compiled with
``nvcc`` for ``sm_90a`` at first use (``kernels._build``) and called through
ctypes on PyTorch's current stream. A failed build or launch raises.

``launch_plan`` computes both launches' geometry in Python, so the CPU
tests reach it.

``fused_moe_bwd_cuda`` is the backward (``csrc/fused_moe_bwd.cu``, its own
library, so that its build runs beside the forward's): four launches of
one grouped-GEMM kernel, whose geometry ``bwd_launch_plan`` computes in
Python as ``launch_plan`` does the forward's.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels._build import load_cuda_library

#: kernel launches since the count was last set to 0 (one a wrapper call,
#: which launches the gate/up and the down kernels)
launches = 0
#: backward calls since the count was last set to 0 (each launches the
#: four kernels of ``bwd_launch_plan``)
bwd_launches = 0
#: ``(E, C/block_m, F/block_f)`` of the last launch: the gate/up launch's
#: grid; the down launch covers ``(E, C/block_m, ceil(D/128))`` output tiles
#: and walks the ``F/block_f`` steps in order
last_grid: tuple | None = None

SOURCES = [Path(__file__).resolve().parent / "csrc" / "fused_moe.cu"]
BWD_SOURCES = [Path(__file__).resolve().parent / "csrc" / "fused_moe_bwd.cu"]
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
    """Launch the kernels: ``(silu(x Wg) * (x Wu)) Wd`` per expert, in x's type."""
    global launches, last_grid
    ts = (x, w_gate, w_up, w_down)
    E, C, D, F = _check("fused_moe_cuda", ts)
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
    output gradient ``dy``, in x's type: four launches of
    ``bwd_launch_plan``, with f32 g and u and typed h, dg, du workspaces."""
    global bwd_launches
    ts = (x, w_gate, w_up, w_down, dy)
    E, C, D, F = _check("fused_moe_bwd_cuda", ts)
    grads = tuple(torch.empty_like(t) for t in (x, w_gate, w_up, w_down))
    if x.numel() == 0 or F == 0:
        return tuple(g.zero_() for g in grads)
    lib = bwd_library()
    code = _DTYPE_CODE[x.dtype]
    for i, launch in enumerate(bwd_launch_plan(E, C, D, F, x.dtype)):
        if lib.fused_moe_bwd_smem_bytes(code, i) != launch.smem:
            raise RuntimeError(f"fused_moe_bwd_cuda: {launch.name} takes "
                               f"{lib.fused_moe_bwd_smem_bytes(code, i)} shared bytes, the "
                               f"plan {launch.smem}")
    f32 = dict(dtype=torch.float32, device=x.device)
    gw, uw = torch.empty((E, C, F), **f32), torch.empty((E, C, F), **f32)
    h, dg, du = (torch.empty((E, C, F), dtype=x.dtype, device=x.device) for _ in range(3))
    vec = all(t.data_ptr() % 16 == 0 for t in (*ts, *grads, gw, uw, h, dg, du)) and all(
        n * x.element_size() % 16 == 0 for n in (D, F))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fused_moe_backward(
            *(t.data_ptr() for t in (*ts, gw, uw, h, dg, du, *grads)),
            code, E, C, D, F, int(vec), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_moe_bwd_cuda: launch failed with cudaError {err}")
    bwd_launches += 1
    return grads
