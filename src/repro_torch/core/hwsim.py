"""hwsim — pipeline-level TPU timing oracle (the "physical hardware" of this
container; see DESIGN.md §2).

Strictly richer than the Feature Analyzer's first-order view: it models the
microarchitectural frictions the paper's MLP is supposed to learn —

  * MXU tile-alignment losses (ragged tiles vs the 128x128 systolic array),
  * imperfect MXU<->VPU overlap (cross-pipeline coupling, gen-dependent),
  * imperfect DMA/compute overlap (double-buffering quality, gen-dependent;
    improved by the fused-MoE ``stages`` config),
  * VMEM working-set pressure and spill,
  * per-tile pipeline fill/drain overhead amortized over the tile stream,
  * per-chip load imbalance (the scheduler's partition is taken as-is),
  * kernel launch overhead and deterministic measurement noise (+-3%).

The Estimator NEVER sees these internals — only the analytical features.
Baselines are scored against the same oracle. Its absolute scale is
calibrated to TPU-class numbers but is synthetic; the paper's experimental
structure (seen/unseen hardware, per-kernel MLPs, quantile ceilings) is what
is reproduced, not vendor-measured milliseconds.
"""
from __future__ import annotations

import hashlib
from functools import lru_cache

import numpy as np

from repro_torch.core.decomposer import (
    SCHED_POLICY,
    decompose,
    default_moe_config,
    routing_counts,
)
from repro_torch.core.hardware import TPUSpec
from repro_torch.core.scheduler import schedule

# per-generation friction parameters (never exposed to the estimator)
GEN_FRICTION = {
    "v4": dict(gamma_cp=0.35, gamma_mo=0.30, fill=3500.0, spill=2.2, ramp=0.92),
    "v5e": dict(gamma_cp=0.16, gamma_mo=0.12, fill=2000.0, spill=1.6, ramp=0.97),
    "v5p": dict(gamma_cp=0.14, gamma_mo=0.10, fill=1800.0, spill=1.5, ramp=0.97),
    "v6e": dict(gamma_cp=0.22, gamma_mo=0.09, fill=1500.0, spill=1.4, ramp=0.95),
    "v7": dict(gamma_cp=0.08, gamma_mo=0.06, fill=1200.0, spill=1.3, ramp=0.99),
}


def _noise(kind: str, X: dict, hw: TPUSpec, amp: float = 0.03) -> float:
    key = f"{kind}|{sorted(X.items())}|{hw.name}".encode()
    h = int.from_bytes(hashlib.sha256(key).digest()[:8], "little")
    rng = np.random.default_rng(h)
    return float(1.0 + amp * rng.standard_normal())


# tunable config keys the simulator prices per kernel family; passing any
# other key raises instead of being silently ignored (the old tuner searched
# a phantom knob for families whose config dict was dropped entirely)
CONFIG_KEYS = {
    "fused_moe": {"block_m", "block_f", "stages"},
    "gemm": {"block_m", "block_n", "block_k"},
    "scaled_mm": {"block_m", "block_n", "block_k"},
    "attention": {"block_q", "block_k"},
    "rmsnorm": {"block_rows"},
    "silu_mul": {"block_rows"},
}


def simulate(kind: str, X: dict, hw: TPUSpec, config: dict | None = None) -> float:
    """Simulated kernel latency in seconds. ``config`` carries tunable
    kernel block choices (``CONFIG_KEYS``); they reach the decomposer as
    workload keys, so tiling, alignment and working sets all respond."""
    Xs = dict(X)
    if config:
        unknown = set(config) - CONFIG_KEYS.get(kind, set())
        if unknown:
            raise ValueError(
                f"hwsim.simulate({kind!r}): unknown config keys {sorted(unknown)}; "
                f"tunable: {sorted(CONFIG_KEYS.get(kind, set()))}"
            )
        Xs.update(config)
    if kind == "fused_moe":
        cfgd = default_moe_config(X, hw)
        for k, v in cfgd.items():
            Xs.setdefault(k, v)
    tasks = decompose(kind, Xs, hw)
    if len(tasks) == 0:
        return hw.launch_us * 1e-6
    chip_of = schedule(SCHED_POLICY[kind], tasks, hw)
    fr = GEN_FRICTION[hw.generation]

    # ---- per-task pipe cycles -----------------------------------------
    mxu_thr = hw.mxu_flops_per_cycle * fr["ramp"]
    if Xs.get("int8") or kind == "scaled_mm":
        mxu_thr = mxu_thr * 2.0
    mxu_c = tasks.mxu / (mxu_thr * np.maximum(tasks.align, 1e-3))
    vec_c = tasks.vpu / hw.vpu_ops_per_cycle + tasks.xu / hw.xu_ops_per_cycle
    compute = np.maximum(mxu_c, vec_c) + fr["gamma_cp"] * np.minimum(mxu_c, vec_c)

    hbm_c = tasks.hbm / hw.hbm_bytes_per_cycle
    vmem_c = tasks.vmem / hw.vmem_bytes_per_cycle
    pressure = tasks.ws / (hw.vmem_mb * 2**20 * 0.8)
    spill = 1.0 + np.maximum(pressure - 0.6, 0.0) * fr["spill"]
    mem = np.maximum(hbm_c, vmem_c) * spill

    gamma_mo = fr["gamma_mo"]
    if kind == "fused_moe":
        stages = Xs.get("stages", 2)
        gamma_mo = gamma_mo * {1: 2.2, 2: 1.0, 3: 0.62, 4: 0.48}.get(stages, 1.0)
    t_task = np.maximum(compute, mem) + gamma_mo * np.minimum(compute, mem)

    # ---- per-chip timeline ---------------------------------------------
    n = hw.num_chips
    chip_time = np.bincount(chip_of, weights=t_task, minlength=n)
    counts = np.bincount(chip_of, minlength=n)
    # pipeline fill/drain: first tile pays full latency; later tiles hide
    # most of it behind double-buffered DMA
    chip_time = chip_time + fr["fill"] * (counts > 0) + 0.15 * fr["fill"] * np.maximum(counts - 1, 0)

    cycles = float(chip_time.max())
    seconds = cycles / (hw.clock_ghz * 1e9) + hw.launch_us * 1e-6
    return seconds * _noise(kind, Xs, hw)


# ----------------------------------------------------------------------
# communication oracle (E2E distributed prediction, paper §V-D)
# ----------------------------------------------------------------------


@lru_cache(maxsize=None)
def a2a_hot_ratio(skew: float, n_chips: int) -> float:
    """Hot-chip serialization factor of a routing-skewed all-to-all:
    ``max chip load / mean chip load`` under the same dirichlet routing
    model the fused-MoE decomposition and the dry-run EP ledger use
    (``decomposer.routing_counts``) — one expert group per chip, averaged
    over the ledger's seed range so the factor is deterministic.

    Exactly 1.0 at ``skew <= 0`` (balanced traffic — the legacy fixed
    contention model), monotonically growing with skew: the hottest
    chip's excess traffic serializes the exchange because every other
    chip must wait for it to drain. Bounded by ``n_chips`` (one chip
    receiving everything).
    """
    if skew <= 0.0 or n_chips <= 1:
        return 1.0
    ratios = []
    for seed in range(8):  # the dry-run ledger's seed convention
        counts = routing_counts(M=4096, E=n_chips, topk=1,
                                skew=float(skew), seed=seed)
        ratios.append(counts.max() / counts.mean())
    return float(np.mean(ratios))


def simulate_comm(
    op: str, nbytes: float, n_chips: int, hw: TPUSpec, skew: float = 0.0
) -> float:
    """alpha-beta collective time over the slice's ICI with contention
    friction and noise.

    ``skew`` (all_to_all only) is the routing-imbalance of the payload:
    the balanced ``(n-1)/n`` exchange is stretched by the hot-chip ratio
    :func:`a2a_hot_ratio` — at ``skew=0`` this reproduces the legacy
    fixed contention factor exactly.
    """
    if n_chips <= 1 or nbytes <= 0:
        return 0.0
    bw = hw.ici_gbps * 1e9 * hw.ici_links
    # all_to_all: every chip keeps 1/n of the payload and ships the rest —
    # the balanced EP dispatch/combine pattern (nbytes is the whole tensor)
    steps = {"all_reduce": 2.0 * (n_chips - 1) / n_chips,
             "all_gather": (n_chips - 1) / n_chips,
             "reduce_scatter": (n_chips - 1) / n_chips,
             "all_to_all": (n_chips - 1) / n_chips,
             "p2p": 1.0}[op]
    alpha = 4e-6 + 0.5e-6 * np.log2(max(n_chips, 2))
    beta = nbytes * steps / bw
    contention = (1.0 + 0.12 * (n_chips > 8) + 0.05 * (op == "all_reduce")
                  + 0.08 * (op == "all_to_all"))
    if op == "all_to_all" and skew > 0.0:
        beta *= a2a_hot_ratio(skew, n_chips)
    t = alpha + beta * contention
    return float(t * _noise(op, {"b": int(nbytes), "n": n_chips}, hw, amp=0.05))
