"""Compatibility shim — the autotuner lives in :mod:`repro_torch.tune`, as
the reference's moved to ``repro.tune``.

The real loop (signature-derived spaces, SP2xx prefilter, predictor
ranking, timed top-k) lives in ``repro_torch.tune``; this module keeps the old
entry points importable for existing callers.
"""
from __future__ import annotations

from repro_torch.core.hardware import TPUSpec
from repro_torch.tune.tuner import (
    TuneResult,
    geomean_speedup,
    pearson,
    spearman,
    tune_underperformers,
    tune_workload,
)

__all__ = [
    "TuneResult",
    "geomean_speedup",
    "pearson",
    "spearman",
    "tune_one",
    "tune_underperformers",
    "tune_workload",
]


def tune_one(workload: dict, hw: TPUSpec) -> TuneResult:
    """Old name for single-workload hwsim tuning (oracle-ranked, so the
    result is the exhaustive-search optimum over the measured top-k and
    the speedup is always >= 1)."""
    return tune_workload(workload, hw)
