"""Dataset construction (paper §V-B): sample kernel workloads from the
serving-framework ranges, run the analytical pipeline (decompose -> schedule
-> features) and record the hwsim ground truth per (workload, hardware).

Workload ranges follow the paper's Section V-B (scaled for single-core-CPU
tractability; the structure — log-uniform dims, variable-length attention
batches, MoE routing skew — is preserved).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import hwsim
from repro_torch.core.decomposer import SCHED_POLICY, decompose
from repro_torch.core.features import analyze
from repro_torch.core.hardware import REGISTRY, TPUSpec, seen_hw, unseen_hw
from repro_torch.core.scheduler import schedule

KERNELS = ("gemm", "attention", "rmsnorm", "silu_mul", "scaled_mm", "fused_moe")


def _logu(rng, lo, hi):
    return int(np.exp(rng.uniform(np.log(lo), np.log(hi))))


def sample_workload(kind: str, rng: np.random.Generator) -> dict:
    if kind == "gemm":
        return {
            "M": _logu(rng, 2, 65536),
            "N": max(128, _logu(rng, 384, 65536) // 128 * 128),
            "K": max(128, _logu(rng, 256, 16384) // 128 * 128),
        }
    if kind == "scaled_mm":
        return {
            "M": _logu(rng, 2, 65536),
            "N": max(128, _logu(rng, 384, 8192) // 128 * 128),
            "K": max(128, _logu(rng, 256, 8192) // 128 * 128),
        }
    if kind == "attention":
        decode = rng.random() < 0.3
        qlen = 1 if decode else _logu(rng, 16, 16384)
        kvlen = qlen + (_logu(rng, 4, 20481) if decode or rng.random() < 0.5 else 0)
        nkv = int(rng.integers(1, 9))
        return {
            "bs": int(rng.integers(1, 17)),
            "nkv": nkv,
            "group": int(rng.integers(1, 9)),
            "hd": int(rng.choice([64, 128])),
            "qlen": qlen,
            "kvlen": kvlen,
            "causal": 1 if rng.random() < 0.8 else 0,
        }
    if kind == "rmsnorm":
        return {"seq": _logu(rng, 2, 65536), "dim": _logu(rng, 128, 16384)}
    if kind == "silu_mul":
        return {"seq": _logu(rng, 2, 65536), "dim": _logu(rng, 768, 32768)}
    if kind == "fused_moe":
        return {
            "M": _logu(rng, 2, 8192),
            "E": int(rng.choice([8, 16, 32, 64, 128])),
            "topk": int(rng.integers(2, 9)),
            "H": max(128, _logu(rng, 1024, 4096) // 128 * 128),
            "N": max(128, _logu(rng, 512, 3072) // 128 * 128),
            "skew": float(rng.uniform(0.0, 0.7)),
            "seed": int(rng.integers(0, 2**31 - 1)),
        }
    raise ValueError(kind)


@dataclasses.dataclass
class KernelDataset:
    kind: str
    X: np.ndarray  # (n, FEATURE_DIM) analytical feature vectors
    y_eff: np.ndarray  # (n,) efficiency targets in (0, 1]
    theoretical_s: np.ndarray
    actual_s: np.ndarray
    hw_names: list
    workloads: list  # dicts

    def mask_hw(self, names: set) -> "KernelDataset":
        m = np.array([h in names for h in self.hw_names])
        return KernelDataset(
            self.kind,
            self.X[m],
            self.y_eff[m],
            self.theoretical_s[m],
            self.actual_s[m],
            [h for h, keep in zip(self.hw_names, m) if keep],
            [w for w, keep in zip(self.workloads, m) if keep],
        )


def featurize(kind: str, X: dict, hw: TPUSpec):
    tasks = decompose(kind, X, hw)
    chip_of = schedule(SCHED_POLICY[kind], tasks, hw)
    return analyze(tasks, chip_of, hw)


def build_dataset(
    kind: str,
    n_workloads: int = 300,
    seed: int = 0,
    hw_list: list | None = None,
) -> KernelDataset:
    rng = np.random.default_rng(seed)
    hws = hw_list or list(REGISTRY.values())
    feats, ys, theos, actuals, hw_names, workloads = [], [], [], [], [], []
    for _ in range(n_workloads):
        w = sample_workload(kind, rng)
        for hw in hws:
            fs = featurize(kind, w, hw)
            actual = hwsim.simulate(kind, w, hw)
            eff = min(fs.theoretical_s / actual, 1.0)
            feats.append(fs.vector(hw))
            ys.append(eff)
            theos.append(fs.theoretical_s)
            actuals.append(actual)
            hw_names.append(hw.name)
            workloads.append(w)
    return KernelDataset(
        kind=kind,
        X=np.stack(feats),
        y_eff=np.asarray(ys, np.float32),
        theoretical_s=np.asarray(theos),
        actual_s=np.asarray(actuals),
        hw_names=hw_names,
        workloads=workloads,
    )


SEEN = {h.name for h in seen_hw()}
UNSEEN = {h.name for h in unseen_hw()}


def mape(pred, actual) -> float:
    pred = np.asarray(pred, np.float64)
    actual = np.asarray(actual, np.float64)
    return float(np.mean(np.abs(pred - actual) / np.maximum(actual, 1e-12)) * 100.0)
