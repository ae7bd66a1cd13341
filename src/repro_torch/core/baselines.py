"""Baseline predictors (paper §VI-A), ported from ``repro.core.baselines``;
adjusted — as the paper does — to share PipeWeave's analytical components
where their design allows:

* Roofline  [Williams et al.]: latency = dominant-pipe theoretical time
  (perfect-efficiency first-order model).
* Linear    [Li et al., MICRO'23]: linear regression on two features from our
  Feature Analyzer — aggregate compute cycles and memory cycles.
* Habitat   [Yu et al., ATC'21]-like: black-box MLP on raw workload dims +
  hardware vector (kernel-level granularity, no pipeline decomposition).
* Neusight  [Lee et al., ASPLOS'25]-like: tile-level grey-box — consumes the
  SAME task definitions from our Kernel Decomposer, but with the paper's
  documented limitations baked in: a *static wave model* (latency =
  waves x uniform tile latency), aggregate mean-tile features, no dynamic
  per-chip scheduling — exactly the three gaps §III identifies.

Every feature builder, Roofline and Linear are numpy and held equal to the
reference. ``fit(ds, device=)`` trains Habitat's and Neusight's MLPs on
``device`` (the card unless the caller passes ``device="cpu"``); Roofline
and Linear take the argument and have no device work to do.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.dataset import KernelDataset, SEEN
from repro_torch.core.decomposer import decompose
from repro_torch.core.features import PIPES, throughput
from repro_torch.core.hardware import REGISTRY, TPUSpec
from repro_torch.core.nn import fit_mlp


# ----------------------------------------------------------------------
# Roofline
# ----------------------------------------------------------------------


class RooflineBaseline:
    name = "roofline"

    def fit(self, ds: KernelDataset, device="cuda"):
        return self

    def predict(self, ds: KernelDataset) -> np.ndarray:
        return ds.theoretical_s.copy()


# ----------------------------------------------------------------------
# Linear (2 aggregate features -> latency)
# ----------------------------------------------------------------------


class LinearBaseline:
    name = "linear"

    def __init__(self):
        self.theta = None

    @staticmethod
    def _feats(ds: KernelDataset) -> np.ndarray:
        # columns of the analytical vector: per-pipe [total, cycles, maxchip,
        # maxcycles, imb]; reconstruct aggregate compute & memory cycles
        comp = np.max(
            [10 ** ds.X[:, 5 * i + 1] for i, p in enumerate(PIPES) if p in ("mxu", "vpu", "xu")],
            axis=0,
        )
        mem = np.max(
            [10 ** ds.X[:, 5 * i + 1] for i, p in enumerate(PIPES) if p in ("hbm", "vmem")],
            axis=0,
        )
        return np.stack([comp, mem, np.ones(len(comp))], axis=1)

    def fit(self, ds: KernelDataset, device="cuda"):
        tr = ds.mask_hw(SEEN)
        A = self._feats(tr)
        self.theta, *_ = np.linalg.lstsq(A, tr.actual_s * 1e6, rcond=None)
        return self

    def predict(self, ds: KernelDataset) -> np.ndarray:
        pred = self._feats(ds) @ self.theta / 1e6
        return np.maximum(pred, 1e-7)


# ----------------------------------------------------------------------
# Habitat-like (black-box MLP on raw dims + hw vector)
# ----------------------------------------------------------------------

_RAW_KEYS = ("M", "N", "K", "bs", "nkv", "group", "hd", "qlen", "kvlen",
             "causal", "seq", "dim", "E", "topk", "H", "skew")


def _raw_vector(w: dict, hw: TPUSpec) -> np.ndarray:
    feats = [math.log10(max(float(w.get(k, 0)), 1.0)) for k in _RAW_KEYS]
    return np.asarray(feats + list(hw.as_vector()), np.float32)


class HabitatBaseline:
    name = "habitat"

    def __init__(self):
        self.model = None
        self.scale = None

    @staticmethod
    def _X(ds: KernelDataset) -> np.ndarray:
        return np.stack(
            [_raw_vector(w, REGISTRY[h]) for w, h in zip(ds.workloads, ds.hw_names)]
        )

    def fit(self, ds: KernelDataset, device="cuda"):
        tr = ds.mask_hw(SEEN)
        # black-box target: log-latency squashed to (0,1)
        logt = np.log10(tr.actual_s)
        self.scale = (logt.min() - 0.5, logt.max() + 0.5)
        y = (logt - self.scale[0]) / (self.scale[1] - self.scale[0])
        self.model = fit_mlp(self._X(tr), y.astype(np.float32), seed=1, loss_kind="mape",
                             device=device)
        return self

    def predict(self, ds: KernelDataset) -> np.ndarray:
        y = self.model.predict(self._X(ds))
        logt = y * (self.scale[1] - self.scale[0]) + self.scale[0]
        return 10.0 ** logt


# ----------------------------------------------------------------------
# Neusight-like (tile-level features + static wave model)
# ----------------------------------------------------------------------


class NeusightBaseline:
    name = "neusight"

    def __init__(self):
        self.model = None

    @staticmethod
    def _tile_feats(w: dict, kind: str, hw: TPUSpec):
        tasks = decompose(kind, w, hw)
        n = max(len(tasks), 1)
        waves = math.ceil(n / hw.num_chips)
        mean = {
            "mxu": float(tasks.mxu.mean()) if n and len(tasks) else 0.0,
            "vpu": float(tasks.vpu.mean()) if len(tasks) else 0.0,
            "xu": float(tasks.xu.mean()) if len(tasks) else 0.0,
            "hbm": float(tasks.hbm.mean()) if len(tasks) else 0.0,
            "vmem": float(tasks.vmem.mean()) if len(tasks) else 0.0,
        }
        tile_cycles = max(
            max(mean[p] / throughput(hw, p) for p in PIPES), 1.0
        )
        lg = lambda x: math.log10(max(x, 1.0))
        feats = [lg(mean[p]) for p in PIPES] + [
            lg(tile_cycles),
            lg(n),
            lg(waves),
            *hw.as_vector(),
        ]
        tile_theo_s = tile_cycles / (hw.clock_ghz * 1e9)
        return np.asarray(feats, np.float32), tile_theo_s, waves

    def _X(self, ds: KernelDataset):
        rows, theo, waves = [], [], []
        for w, h in zip(ds.workloads, ds.hw_names):
            f, t, wv = self._tile_feats(w, ds.kind, REGISTRY[h])
            rows.append(f)
            theo.append(t)
            waves.append(wv)
        return np.stack(rows), np.asarray(theo), np.asarray(waves)

    def fit(self, ds: KernelDataset, device="cuda"):
        tr = ds.mask_hw(SEEN)
        X, theo, waves = self._X(tr)
        # static-wave tile efficiency target: actual = waves * tile_theo / eff
        eff = np.clip(waves * theo / tr.actual_s, 1e-3, 1.0)
        self.model = fit_mlp(X, eff.astype(np.float32), seed=2, loss_kind="mape",
                             device=device)
        self._cache = None
        return self

    def predict(self, ds: KernelDataset) -> np.ndarray:
        X, theo, waves = self._X(ds)
        eff = np.clip(self.model.predict(X), 1e-3, 1.0)
        return waves * theo / eff


BASELINES = {
    "roofline": RooflineBaseline,
    "linear": LinearBaseline,
    "habitat": HabitatBaseline,
    "neusight": NeusightBaseline,
}
