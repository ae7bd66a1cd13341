"""Kernel Decomposer — F(X, S) -> {tasks}   (paper §IV-A).

Deterministically decomposes each kernel family into schedulable *tasks*.
On TPU a task is a Pallas grid tile (the unit a TensorCore streams through
with double-buffered DMA); across the slice, tiles are distributed by either
the static SPMD partition (conventional kernels) or a software work queue
(persistent/grouped kernels) — see scheduler.py.

Tasks are stored as a struct-of-arrays (:class:`TaskArray`) for speed; each
task carries its dimension-derived per-pipeline demands (paper Eq. 3-4):

    mxu  = alpha * prod(tile dims)    (alpha=2 GEMM, 4 flash-attention)
    vpu  = elementwise op count
    xu   = transcendental count (exp / rsqrt / silu / tanh)
    hbm  = operand/result bytes streamed from HBM
    vmem = bytes touched in VMEM (incl. accumulator traffic)
    align= MXU/VPU tile-alignment utilization in (0, 1]
    ws   = VMEM working-set bytes of the task

Each family's decomposer is a few dozen lines (paper §V-A reports 10-50).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.hardware import TPUSpec


@dataclasses.dataclass
class TaskArray:
    mxu: np.ndarray
    vpu: np.ndarray
    xu: np.ndarray
    hbm: np.ndarray
    vmem: np.ndarray
    align: np.ndarray
    ws: np.ndarray

    def __len__(self):
        return len(self.mxu)

    @staticmethod
    def build(n, **kw):
        z = lambda: np.zeros(n, dtype=np.float64)
        f = {k: np.asarray(v, dtype=np.float64) for k, v in kw.items()}
        return TaskArray(
            mxu=f.get("mxu", z()),
            vpu=f.get("vpu", z()),
            xu=f.get("xu", z()),
            hbm=f.get("hbm", z()),
            vmem=f.get("vmem", z()),
            align=f.get("align", np.ones(n)),
            ws=f.get("ws", z()),
        )

    @staticmethod
    def concat(parts: list["TaskArray"]) -> "TaskArray":
        return TaskArray(
            **{
                f.name: np.concatenate([getattr(p, f.name) for p in parts])
                for f in dataclasses.fields(TaskArray)
            }
        )


def _ceil(a, b):
    return -(-a // b)


def _util(sizes, quantum):
    sizes = np.asarray(sizes, dtype=np.float64)
    return sizes / (np.ceil(sizes / quantum) * quantum)


def _tile_sizes(total: int, tile: int) -> np.ndarray:
    n = _ceil(total, tile)
    sizes = np.full(n, tile, dtype=np.float64)
    if total % tile:
        sizes[-1] = total % tile
    return sizes


# ----------------------------------------------------------------------
# GEMM  (cuBLAS analogue: the XLA/Mosaic tile heuristic is the
# "closed-source" selector we reverse-engineer — paper §IV-A)
# ----------------------------------------------------------------------


def gemm_tile_heuristic(M, N, K, hw: TPUSpec, dtype_bytes: int = 2):
    """Biggest MXU-aligned tile whose working set fits VMEM, shrunk when the
    grid would underfill the slice (wave-quantization avoidance)."""
    vmem_budget = hw.vmem_mb * 2**20 * 0.6
    cands = ((512, 512), (512, 256), (256, 256), (256, 128), (128, 128))
    for tm, tn in cands:
        tiles = _ceil(M, tm) * _ceil(N, tn)
        work = (tm + tn) * min(K, 2048) * dtype_bytes + tm * tn * 4
        if work <= vmem_budget and (tiles >= hw.num_chips or (tm >= M and tn >= N)):
            return tm, tn
    return 128, 128


def decompose_gemm(X: dict, hw: TPUSpec) -> TaskArray:
    M, N, K = X["M"], X["N"], X["K"]
    b = X.get("dtype_bytes", 2)
    tm_h, tn_h = gemm_tile_heuristic(M, N, K, hw, b)
    # explicit kernel block choices (the autotuner's candidates) override the
    # XLA/Mosaic heuristic; absent keys reproduce the default decomposition
    tm = int(X.get("block_m", tm_h))
    tn = int(X.get("block_n", tn_h))
    ms = _tile_sizes(M, tm)
    ns = _tile_sizes(N, tn)
    m = np.repeat(ms, len(ns))
    n = np.tile(ns, len(ms))
    if "block_k" in X:
        bk = int(X["block_k"])
        k_panel = float(min(K, bk))
        # K is streamed in ceil(K/bk) panels with the f32 accumulator block
        # re-read/written once per extra panel
        acc = (np.ceil(K / bk) - 1.0) * m * n * 8.0
    else:
        k_panel = float(min(K, 2048))
        acc = 0.0
    t = TaskArray.build(
        len(m),
        mxu=2.0 * m * n * K,
        vpu=m * n,
        hbm=(m + n) * K * b + m * n * b,
        vmem=(m + n) * K * b + m * n * (b + 4) + acc,
        align=_util(m, 8) * _util(n, 128) * _util([K], 128)[0],
        ws=(k_panel * (m + n)) * b + m * n * 4,
    )
    return t


def decompose_scaled_mm(X: dict, hw: TPUSpec) -> TaskArray:
    """W8A8 GEMM: 1-byte operands + dequant epilogue (MXU int8 rate handled
    by hwsim via the int8 flag in X)."""
    t = decompose_gemm({**X, "dtype_bytes": 1}, hw)
    t.vpu = t.vpu * 3.0  # scale multiply + cast epilogue
    return t


# ----------------------------------------------------------------------
# FlashAttention (FA2-style): per (batch, kv-head, q-block) task; causal
# masking makes the effective KV per task variable — the paper's canonical
# non-uniform workload.
# ----------------------------------------------------------------------


def decompose_attention(X: dict, hw: TPUSpec) -> TaskArray:
    B, H, G = X["bs"], X["nkv"], X["group"]
    qlen, kvlen, hd = X["qlen"], X["kvlen"], X["hd"]
    causal = X.get("causal", 1)
    b = X.get("dtype_bytes", 2)
    bq_default = min(256, qlen) if qlen > 1 else 1
    bq = max(1, min(int(X.get("block_q", bq_default)), qlen))
    nq = _ceil(qlen, bq)
    m = _tile_sizes(qlen, bq)  # (nq,)
    starts = np.arange(nq) * bq
    offset = kvlen - qlen
    kv_eff = np.full(nq, float(kvlen))
    if causal:
        kv_eff = np.minimum(kvlen, offset + starts + m)
    rows = G * m
    if "block_k" in X:
        bk = int(X["block_k"])
        kv_panel = np.minimum(kv_eff, float(bk))
        # online-softmax accumulators (o, l, m) are re-updated once per extra
        # KV block the inner loop streams
        acc = (np.ceil(kv_eff / bk) - 1.0) * (rows * hd + 2.0 * rows) * 8.0
    else:
        kv_panel = np.minimum(kv_eff, 512)
        acc = 0.0
    one = TaskArray.build(
        nq,
        mxu=2.0 * rows * kv_eff * hd * 2.0,
        xu=rows * kv_eff,
        vpu=4.0 * rows * kv_eff,
        hbm=(2.0 * rows * hd + 2.0 * kv_eff * hd) * b,
        vmem=(2.0 * rows * hd + 2.0 * kv_eff * hd) * b + rows * kv_eff * b + acc,
        align=_util(rows, 8) * _util([hd], 128)[0],
        ws=(rows * hd * 2 + kv_panel * hd * 2) * b + rows * hd * 4,
    )
    reps = B * H
    return TaskArray(
        **{
            f.name: np.tile(getattr(one, f.name), reps)
            for f in dataclasses.fields(TaskArray)
        }
    )


# ----------------------------------------------------------------------
# RMSNorm / SiLU&Mul: row-block elementwise tasks
# ----------------------------------------------------------------------


def _rowwise(X, b, vpu_per_el, xu_per_el, streams):
    seq, dim = X["seq"], X["dim"]
    rows = _tile_sizes(seq, max(1, int(X.get("block_rows", 512))))
    n = len(rows)
    return TaskArray.build(
        n,
        vpu=vpu_per_el * rows * dim,
        xu=xu_per_el * rows * dim if xu_per_el >= 1 else rows,
        hbm=streams * rows * dim * b,
        vmem=streams * rows * dim * b,
        align=_util(rows, 8) * _util([dim], 128)[0],
        ws=streams * rows * dim * b,
    )


def decompose_rmsnorm(X: dict, hw: TPUSpec) -> TaskArray:
    return _rowwise(X, X.get("dtype_bytes", 2), 4.0, 0.0, 2.0)


def decompose_silu_mul(X: dict, hw: TPUSpec) -> TaskArray:
    return _rowwise(X, X.get("dtype_bytes", 2), 3.0, 1.0, 3.0)


# ----------------------------------------------------------------------
# Fused MoE (grouped GEMM, §VII case study): per-(expert, m-tile) tasks with
# ragged token counts from routing — software work-queue scheduled. block_m /
# block_f / stages are the tunable config (paper's BLOCK_SIZE / num_warps /
# num_stages).
# ----------------------------------------------------------------------


def routing_counts(M: int, E: int, topk: int, skew: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.full(E, max(0.05, 10.0 * (1.0 - skew))))
    counts = np.floor(w * M * topk).astype(np.int64)
    rem = M * topk - counts.sum()
    counts[np.argsort(-w)[: int(rem)]] += 1
    return counts


def default_moe_config(X: dict, hw: TPUSpec) -> dict:
    """The production kernel's config-selection logic. Tuned for the v5e
    sweet spot — deliberately *not* revisited per generation, which is the
    implementation shortcoming the paper's §VII diagnoses (its Triton kernel
    was ill-suited to the A40)."""
    return {"block_m": 128, "block_f": 512, "stages": 2}


def decompose_fused_moe(X: dict, hw: TPUSpec) -> TaskArray:
    M, E, topk = X["M"], X["E"], X["topk"]
    H, N = X["H"], X["N"]
    b = X.get("dtype_bytes", 2)
    cfgd = default_moe_config(X, hw)
    bm = X.get("block_m", cfgd["block_m"])
    bf = X.get("block_f", cfgd["block_f"])
    bf = min(bf, N)
    counts = routing_counts(M, E, topk, X.get("skew", 0.3), X.get("seed", 0))
    sizes = []
    for c in counts:
        c = int(c)
        if c:
            sizes.append(_tile_sizes(c, bm))
    if not sizes:
        return TaskArray.build(0)
    m = np.concatenate(sizes)
    n = len(m)
    # per m-tile: all three expert matrices streamed once (weight-dominated)
    w_bytes = 3.0 * H * N * b
    # the kernel's inner F loop re-updates the (m, H) f32 accumulator scratch
    # once per extra f-block — the VMEM cost of choosing a small block_f
    n_f = math.ceil(N / bf)
    acc = (n_f - 1) * m * H * 8.0
    return TaskArray.build(
        n,
        mxu=2.0 * m * 3.0 * H * N,
        xu=m * N,
        vpu=2.0 * m * N,
        hbm=w_bytes + (2.0 * m * H + m * N) * b,
        vmem=w_bytes + (2.0 * m * H + m * N) * b + m * H * 4 + acc,
        align=_util(m, 8) * _util([min(bf, N)], 128)[0],
        ws=(bm * H + (H + bm) * bf) * b * X.get("stages", cfgd["stages"]) + bm * H * 4,
    )


# ----------------------------------------------------------------------
# Expert-parallel dispatch/combine all-to-all (collective payload model).
# Not a kernel family: EP traffic is priced by the comm half of every
# backend (CommRegressor / hwsim.simulate_comm), but the *payload* is a
# dimension-derived analytical quantity exactly like the task demands
# above, so it lives with the decomposer.
# ----------------------------------------------------------------------


#: bytes per element of the compute dtypes the model zoo runs in — the
#: dtype the dispatched activations cross the EP axis as (shared by the
#: e2e workload generator and the dry-run ledger so the two can't drift)
COMPUTE_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def moe_dispatch_geometry(
    T: int, E: int, topk: int, capacity_factor: float, moe_group: int
) -> tuple:
    """``(G, Sg, C)`` of the dense GSPMD/GShard MoE dispatch for ``T``
    tokens: ``G`` dispatch groups of ``Sg`` tokens (the largest divisor of
    ``T`` that is <= ``moe_group``), each with per-expert capacity
    ``C = max(ceil(Sg * topk / E * capacity_factor), topk)``.

    This is the decomposer's *independent* statement of the geometry the
    model layer executes (``repro_torch.models.moe.dispatch_geometry``);
    ``tests/test_parallelism.py`` and ``benchmarks/bench_parallelism.py``
    pin the two byte-for-byte against ``launch.dryrun``'s model-derived
    count on every MoE arch, so drift in either breaks CI.
    """
    Sg = next(g for g in range(min(moe_group, T), 0, -1) if T % g == 0)
    C = max(int(math.ceil(Sg * topk / E * capacity_factor)), topk)
    return T // Sg, Sg, C


def ep_alltoall_bytes(X: dict) -> float:
    """Payload bytes of ONE expert-parallel all-to-all hop (dispatch and
    combine are symmetric): the full dispatched-activation tensor
    ``(G, E, C, d)`` in the compute dtype — the tensor the EP mesh axis
    actually re-shards, and the quantity ``launch.dryrun
    .count_ep_alltoall_bytes`` counts from the model implementation.

    ``X`` keys: ``T`` (tokens in the step), ``d`` (model dim), ``E``
    (experts), ``topk``, ``capacity_factor`` (the *serving* factor — e2e
    passes ``max(cfg.capacity_factor, 2.0)`` to match the model's
    inference capacity), ``moe_group``, optional ``dtype_bytes`` (2).
    The returned bytes are the whole-tensor payload; per-chip traffic is
    the comm model's concern (``simulate_comm`` applies the ``(n-1)/n``
    cross-chip fraction for balanced all-to-alls).
    """
    G, _, C = moe_dispatch_geometry(
        int(X["T"]), int(X["E"]), int(X["topk"]),
        float(X["capacity_factor"]), int(X["moe_group"]),
    )
    return float(G * int(X["E"]) * C * int(X["d"]) * X.get("dtype_bytes", 2))


DECOMPOSERS = {
    "gemm": decompose_gemm,
    "scaled_mm": decompose_scaled_mm,
    "attention": decompose_attention,
    "rmsnorm": decompose_rmsnorm,
    "silu_mul": decompose_silu_mul,
    "fused_moe": decompose_fused_moe,
}

# which scheduling paradigm each family uses (paper Table V HW/SW column)
SCHED_POLICY = {
    "gemm": "static",
    "scaled_mm": "static",
    "attention": "static",
    "rmsnorm": "static",
    "silu_mul": "static",
    "fused_moe": "workqueue",
}


def decompose(kind: str, X: dict, hw: TPUSpec) -> TaskArray:
    return DECOMPOSERS[kind](X, hw)
