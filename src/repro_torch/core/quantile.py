"""Beyond simulation (paper §VII-A/B), ported from ``repro.core.quantile``:
the P80 quantile-regression ceiling model and the Performance-Gap
diagnosis for the fused MoE kernel."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dataset import KernelDataset, SEEN
from repro_torch.core.nn import TrainedMLP, fit_mlp


@dataclasses.dataclass
class CeilingModel:
    model: TrainedMLP
    quantile: float

    def predict_ceiling(self, X: np.ndarray) -> np.ndarray:
        return np.clip(self.model.predict(X), 1e-3, 1.0)


def train_ceiling(
    ds: KernelDataset, *, quantile: float = 0.8, seed: int = 0, max_epochs: int = 150,
    device="cuda",
) -> CeilingModel:
    """Same features and efficiency target as §V-C, pinball loss at P80:
    fits the top-20% envelope — a statistically robust Potential Performance
    Ceiling (less outlier-sensitive than P90+)."""
    tr = ds.mask_hw(SEEN)  # trained on seen hw; diagnosis runs on all hw
    model = fit_mlp(
        tr.X, tr.y_eff, seed=seed, loss_kind="pinball", quantile=quantile,
        max_epochs=max_epochs, device=device,
    )
    return CeilingModel(model=model, quantile=quantile)


@dataclasses.dataclass
class GapReport:
    gaps: np.ndarray  # ceiling - actual efficiency per row
    underperforming: np.ndarray  # bool mask (gap > threshold)
    per_hw_counts: dict  # hw -> count of underperforming points
    per_hw_frac: dict
    threshold: float

    def cdf(self, grid=None):
        grid = grid if grid is not None else np.linspace(-0.2, 0.8, 101)
        return grid, np.array([(self.gaps <= g).mean() for g in grid])


def perf_gap(ceiling: CeilingModel, ds: KernelDataset, threshold: float = 0.1) -> GapReport:
    """perf_gap = y_hat_p80 - y_actual  (paper §VII-B)."""
    yhat = ceiling.predict_ceiling(ds.X)
    gaps = yhat - ds.y_eff
    under = gaps > threshold
    per_hw_counts, per_hw_frac = {}, {}
    hw_arr = np.asarray(ds.hw_names)
    for hw in sorted(set(ds.hw_names)):
        m = hw_arr == hw
        per_hw_counts[hw] = int(under[m].sum())
        per_hw_frac[hw] = float(under[m].mean())
    return GapReport(
        gaps=gaps,
        underperforming=under,
        per_hw_counts=per_hw_counts,
        per_hw_frac=per_hw_frac,
        threshold=threshold,
    )
