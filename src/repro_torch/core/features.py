"""Feature Analyzer — multi-pipeline demand / theoretical-cycle features
(paper §IV-C, Table IV) over the task distribution from the scheduler.

Per pipeline p in {MXU, VPU, XU, HBM, VMEM}:
  * slice-level: total demand, theoretical cycles  N_p / (chips * Th_p)
  * max-chip: demand and theoretical cycles of the most loaded chip
  * imbalance ratio (max-chip / ideal share)
plus pipe-balance ratios and the hardware descriptor vector (Table II
analogue). ``theoretical_cycles`` (dominant pipe at slice level) normalizes
the target: efficiency = theoretical / actual.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.decomposer import TaskArray
from repro_torch.core.hardware import TPUSpec

PIPES = ("mxu", "vpu", "xu", "hbm", "vmem")


def throughput(hw: TPUSpec, pipe: str) -> float:
    """Per-chip per-cycle throughput of pipeline p."""
    return {
        "mxu": hw.mxu_flops_per_cycle,
        "vpu": hw.vpu_ops_per_cycle,
        "xu": hw.xu_ops_per_cycle,
        "hbm": hw.hbm_bytes_per_cycle,
        "vmem": hw.vmem_bytes_per_cycle,
    }[pipe]


@dataclasses.dataclass
class FeatureSet:
    totals: dict
    total_cycles: dict
    max_chip: dict
    max_chip_cycles: dict
    n_tasks: int
    n_chips_used: int
    theoretical_cycles: float
    theoretical_s: float

    def vector(self, hw: TPUSpec) -> np.ndarray:
        eps = 1.0
        lg = lambda x: math.log10(max(x, eps))
        feats = []
        for p in PIPES:
            feats += [
                lg(self.totals[p]),
                lg(self.total_cycles[p]),
                lg(self.max_chip[p]),
                lg(self.max_chip_cycles[p]),
                self.max_chip[p] * hw.num_chips / max(self.totals[p], eps),
            ]
        feats += [
            lg(self.n_tasks),
            self.n_chips_used / hw.num_chips,
            lg(self.theoretical_cycles),
            *[
                self.total_cycles[p] / max(self.theoretical_cycles, eps)
                for p in PIPES
            ],
        ]
        feats += list(hw.as_vector())
        return np.asarray(feats, dtype=np.float32)


FEATURE_DIM = 5 * len(PIPES) + 3 + len(PIPES) + 11


def demand_summary(tasks: TaskArray, chip_of: np.ndarray, n_chips: int) -> tuple:
    """The hardware-independent half of :func:`analyze`: per-pipe total and
    max-chip demand plus chip usage, a function of (tasks, chip_of) only.
    Multi-hardware sweeps cache this per task signature
    (``repro_torch.predict.batching.FeatureCache``) so only the cycle conversions
    below fan out per device."""
    demands = {
        "mxu": tasks.mxu,
        "vpu": tasks.vpu,
        "xu": tasks.xu,
        "hbm": tasks.hbm,
        "vmem": tasks.vmem,
    }
    totals, max_chip = {}, {}
    for p, d in demands.items():
        totals[p] = float(d.sum())
        per_chip = (
            np.bincount(chip_of, weights=d, minlength=n_chips)
            if len(d)
            else np.zeros(n_chips)
        )
        max_chip[p] = float(per_chip.max())
    used = int(len(np.unique(chip_of))) if len(chip_of) else 0
    return totals, max_chip, used, len(tasks)


def analyze_summary(summary: tuple, hw: TPUSpec) -> FeatureSet:
    """Per-hardware cycle conversion of a :func:`demand_summary` — pure
    float math, no task-array traversal."""
    totals, max_chip, used, n_tasks = summary
    max_chip_cycles, total_cycles = {}, {}
    n = hw.num_chips
    for p in PIPES:
        total_cycles[p] = totals[p] / (n * throughput(hw, p))
        max_chip_cycles[p] = max_chip[p] / throughput(hw, p)
    theoretical = max(max(total_cycles.values()), 1.0)
    return FeatureSet(
        totals=totals,
        total_cycles=total_cycles,
        max_chip=max_chip,
        max_chip_cycles=max_chip_cycles,
        n_tasks=n_tasks,
        n_chips_used=used,
        theoretical_cycles=theoretical,
        # kernel dispatch overhead is part of the spec (Table II analogue),
        # so the ideal-time normalizer includes it; without this, tiny
        # kernels collapse to efficiencies ~1e-2 that a sigmoid head cannot
        # resolve relatively
        theoretical_s=theoretical / (hw.clock_ghz * 1e9) + hw.launch_us * 1e-6,
    )


def analyze(tasks: TaskArray, chip_of: np.ndarray, hw: TPUSpec) -> FeatureSet:
    return analyze_summary(demand_summary(tasks, chip_of, hw.num_chips), hw)


def overlap_window_s(kernel_s: float, n_comm_launches: float) -> float:
    """Cross-pipeline exposed-compute window (ISSUE 10): the kernel time
    the network can hide under when a trace's ``n`` collective launches
    are spread through its ``kernel_s`` of compute.

    Model: launches issue uniformly through the compute — launch ``i``
    after ``i/(n+1)`` of it — so the serialized network stream can
    overlap the compute that *follows* its first launch,
    ``kernel_s * n / (n + 1)``. The window is 0 with no launches (nothing
    to overlap), ``kernel_s/2`` for a single mid-trace collective, and
    approaches (but never reaches) ``kernel_s`` as launches densify —
    which is what bounds ``Estimate.overlapped()`` between pure compute
    and the additive estimate. This is the trace-level cross-pipeline
    feature the decomposer's per-kernel pipe demands cannot express: it
    couples the compute pipes' occupancy with the ICI's.
    """
    if kernel_s <= 0.0 or n_comm_launches <= 0.0:
        return 0.0
    return kernel_s * n_comm_launches / (n_comm_launches + 1.0)
