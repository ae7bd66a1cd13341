"""Performance Estimator (paper §IV-D), ported from ``repro.core.estimator``:
one lightweight MLP per kernel family consuming the analytical feature
vector; latency is recovered as theoretical_time / predicted_efficiency.

The pickle payload holds numpy arrays and ``repro_torch`` objects only, and
``PipeWeave.load`` unpickles through an unpickler that refuses any other
module: a pickle of the reference's estimator (jax arrays,
``repro.core.nn.TrainedMLP``) raises ``RuntimeError`` naming the file
instead of importing JAX. The port's cache files are
``pipeweave_torch_*.pkl``, apart from the reference's ``pipeweave_*.pkl``.
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np

from repro_torch.core.dataset import KernelDataset, featurize, SEEN
from repro_torch.core.hardware import TPUSpec
from repro_torch.core.nn import TrainedMLP, fit_mlp


# bump when the pickle payload layout or the feature contract changes; a
# stale cache must fail loudly, not mispredict silently
PICKLE_VERSION = 2

#: top-level packages a PipeWeave pickle may name
_PICKLE_MODULES = ("numpy", "builtins", "repro_torch")


class _PortUnpickler(pickle.Unpickler):
    def __init__(self, f, path: str):
        super().__init__(f)
        self.path = path

    def find_class(self, module, name):
        if module.split(".")[0] not in _PICKLE_MODULES:
            raise RuntimeError(
                f"{self.path} names {module}.{name}: it was not written by "
                "repro_torch (a reference PipeWeave pickle holds jax arrays); "
                "the port loads only pickles of its own PipeWeave.save"
            )
        return super().find_class(module, name)


@dataclasses.dataclass
class PipeWeave:
    models: dict  # kind -> TrainedMLP

    def predict_eff(self, kind: str, feats: np.ndarray) -> np.ndarray:
        return np.clip(self.models[kind].predict(feats), 1e-3, 1.0)

    def predict_latency(self, kind: str, X: dict, hw: TPUSpec) -> float:
        """Scalar per-call prediction (featurizes from scratch every call);
        for batched, cached estimation use repro_torch.predict.get_predictor."""
        fs = featurize(kind, X, hw)
        eff = self.predict_eff(kind, fs.vector(hw)[None])[0]
        return float(fs.theoretical_s / eff)

    def predict_dataset(self, ds: KernelDataset) -> np.ndarray:
        eff = self.predict_eff(ds.kind, ds.X)
        return ds.theoretical_s / eff

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {"__pipeweave_version__": PICKLE_VERSION, "models": self.models}
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    @staticmethod
    def load(path: str) -> "PipeWeave":
        with open(path, "rb") as f:
            obj = _PortUnpickler(f, path).load()
        if isinstance(obj, PipeWeave):
            raise RuntimeError(
                f"{path} is a pre-versioning PipeWeave pickle; delete the "
                "stale cache entry and retrain"
            )
        version = obj.get("__pipeweave_version__") if isinstance(obj, dict) else None
        if version != PICKLE_VERSION:
            raise RuntimeError(
                f"{path} has PipeWeave pickle version {version!r}, this code "
                f"expects {PICKLE_VERSION}; delete the stale cache entry and "
                "retrain with the current feature contract"
            )
        return PipeWeave(models=obj["models"])


def train_pipeweave(
    datasets: dict[str, KernelDataset],
    *,
    seed: int = 0,
    max_epochs: int = 250,
    verbose: bool = False,
    device="cuda",
) -> PipeWeave:
    """Train per-kernel MLPs on SEEN hardware rows only (paper's split)."""
    models = {}
    for kind, ds in datasets.items():
        tr = ds.mask_hw(SEEN)
        if verbose:
            print(f"[pipeweave] training {kind}: {len(tr.X)} rows")
        models[kind] = fit_mlp(
            tr.X, tr.y_eff, seed=seed, max_epochs=max_epochs, loss_kind="mape",
            verbose=verbose, device=device,
        )
    return PipeWeave(models=models)

