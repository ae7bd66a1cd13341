"""The per-family MLP with BatchNorm and Dropout, and its MAPE / pinball-loss
trainer (paper §V-C), ported from ``repro.core.nn``: 3 hidden layers
(256/128/64), ReLU, a sigmoid head predicting execution efficiency in
[0, 1]. AdamW (``repro_torch.optim``), early stopping on validation loss.

BatchNorm is written out as the reference has it, not ``nn.BatchNorm1d``:
the batch variance is the population variance, ``1e-5`` is added to it
*before* it enters the running statistics and again at inference, and the
running statistics keep ``momentum`` (0.99) of their *old* value. Dropout
draws its keep mask from an explicit ``torch.Generator``. The JAX PRNG
streams are not reproduced (init and dropout draw from generators seeded
from ``seed``); the numpy permutations that split and shuffle the rows are.

``fit_mlp`` trains in f32 on ``device`` (the card unless the caller passes
``device="cpu"``); its matmuls follow the process's TF32 setting, which
PyTorch leaves off and ``chip_smoke.py`` sets off. The ``TrainedMLP`` it
returns holds numpy arrays only, and ``predict`` is the reference's float64
numpy forward, so given the same weights it is bit-equal to the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.models.registry import resolve_device
from repro_torch.optim.adamw import AdamW, constant_lr, tree_leaves, tree_map, tree_unflatten

HIDDEN = (256, 128, 64)


def init_mlp(generator: torch.Generator, in_dim: int, hidden=HIDDEN):
    """He-normal weights drawn from ``generator``, on its device."""
    dev = generator.device
    params = {"layers": []}
    dims = [in_dim, *hidden, 1]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        layer = {
            "w": torch.randn((a, b), generator=generator, device=dev) * math.sqrt(2.0 / a),
            "b": torch.zeros((b,), device=dev),
        }
        if i < len(dims) - 2:  # BatchNorm on hidden layers
            layer["bn_scale"] = torch.ones((b,), device=dev)
            layer["bn_bias"] = torch.zeros((b,), device=dev)
        params["layers"].append(layer)
    state = {
        "bn_mean": [torch.zeros((h,), device=dev) for h in hidden],
        "bn_var": [torch.ones((h,), device=dev) for h in hidden],
    }
    return params, state


def apply_dropout(h, rate: float, rng: torch.Generator):
    """Keep each element with probability ``1 - rate`` (a mask drawn from
    ``rng``) and scale what is kept by ``1 / (1 - rate)``."""
    keep = torch.rand(h.shape, generator=rng, device=h.device) < 1 - rate
    return torch.where(keep, h / (1 - rate), 0.0)


def mlp_forward(params, state, x, *, train: bool, rng: Optional[torch.Generator] = None,
                dropout: float = 0.1, momentum: float = 0.99):
    """Returns (sigmoid output in (0,1), new_state). The new running
    statistics carry no gradient (the reference returns them as aux)."""
    new_mean, new_var = [], []
    h = x
    n_hidden = len(params["layers"]) - 1
    for i, layer in enumerate(params["layers"]):
        h = h @ layer["w"] + layer["b"]
        if i < n_hidden:
            if train:
                mu = torch.mean(h, dim=0)
                var = torch.var(h, dim=0, correction=0) + 1e-5
                new_mean.append(momentum * state["bn_mean"][i] + (1 - momentum) * mu.detach())
                new_var.append(momentum * state["bn_var"][i] + (1 - momentum) * var.detach())
            else:
                mu, var = state["bn_mean"][i], state["bn_var"][i] + 1e-5
            h = (h - mu) / torch.sqrt(var)
            h = h * layer["bn_scale"] + layer["bn_bias"]
            h = torch.relu(h)
            if train and dropout > 0 and rng is not None:
                h = apply_dropout(h, dropout, rng)
    out = torch.sigmoid(h[:, 0])
    new_state = (
        {"bn_mean": new_mean, "bn_var": new_var} if train and new_mean else state
    )
    return out, new_state


def mape_loss(pred_eff, y_eff):
    """MAPE on efficiency (the paper's training objective)."""
    return torch.mean(torch.abs(pred_eff - y_eff) / torch.clamp(y_eff, min=1e-3))


def pinball_loss(pred, y, q: float):
    """Quantile (pinball) loss — §VII-A P80 ceiling objective."""
    diff = y - pred
    return torch.mean(torch.maximum(q * diff, (q - 1) * diff) / torch.clamp(y, min=1e-3))


@dataclasses.dataclass
class TrainedMLP:
    params: dict  # numpy f32 arrays, the tree of ``init_mlp``
    state: dict
    mu_x: np.ndarray
    sd_x: np.ndarray
    y_floor: float = 1e-3  # sigmoid-collapse guard: no training row was
    # below this efficiency, so predictions aren't allowed to be either
    # (latency = theo/eff amplifies eff underestimates unboundedly)
    # normalized-space training envelope: unseen-hardware rows can land 3x
    # outside the training z-range, saturating BatchNorm+sigmoid and
    # collapsing predictions to the floor — clip inference inputs to the
    # envelope (no-op for in-distribution rows)
    x_lo: Optional[np.ndarray] = None
    x_hi: Optional[np.ndarray] = None
    # what the fit ran (early stopping ends it before max_epochs); the
    # on-card training log reads them, prediction does not
    epochs: int = 0
    steps: int = 0

    def _np_model(self):
        """Weights/BN stats as float64 numpy, converted once per instance.
        Inference runs in numpy float64 so per-row results are batch-size
        independent — the batched predictor path must reproduce per-call
        scalar sums to 1e-9."""
        cached = getattr(self, "_np_cache", None)
        if cached is None:
            layers = [
                {k: np.asarray(v, np.float64) for k, v in layer.items()}
                for layer in self.params["layers"]
            ]
            bn_mean = [np.asarray(m, np.float64) for m in self.state["bn_mean"]]
            bn_var = [np.asarray(v, np.float64) for v in self.state["bn_var"]]
            cached = (layers, bn_mean, bn_var)
            self._np_cache = cached
        return cached

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_np_cache", None)  # derived; keep pickles lean
        return state

    def predict(self, X: np.ndarray) -> np.ndarray:
        Xn = (np.asarray(X, np.float64) - self.mu_x) / self.sd_x
        if self.x_lo is not None:
            Xn = np.clip(Xn, self.x_lo, self.x_hi)
        layers, bn_mean, bn_var = self._np_model()
        h = Xn
        n_hidden = len(layers) - 1
        for i, layer in enumerate(layers):
            h = h @ layer["w"] + layer["b"]
            if i < n_hidden:
                h = (h - bn_mean[i]) / np.sqrt(bn_var[i] + 1e-5)
                h = h * layer["bn_scale"] + layer["bn_bias"]
                h = np.maximum(h, 0.0)
        with np.errstate(over="ignore"):  # saturated sigmoid is fine
            out = 1.0 / (1.0 + np.exp(-h[:, 0]))
        return np.clip(out, self.y_floor, 1.0)


def _to_numpy(tree):
    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy(), tree)


def fit_mlp(
    X: np.ndarray,
    y: np.ndarray,
    *,
    seed: int = 0,
    lr: float = 1e-3,
    weight_decay: float = 1e-4,
    batch: int = 512,
    max_epochs: int = 250,
    patience: int = 30,
    min_epochs: int = 40,
    loss_kind: str = "mape",
    quantile: float = 0.8,
    val_frac: float = 0.1,
    verbose: bool = False,
    device="cuda",
) -> TrainedMLP:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = len(X)
    perm = rng.permutation(n)
    n_val = max(int(n * val_frac), 1)
    val_idx, tr_idx = perm[:n_val], perm[n_val:]
    mu_x = X[tr_idx].mean(0)
    sd_x = X[tr_idx].std(0) + 1e-6
    Xn = (X - mu_x) / sd_x

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    Xtr, ytr = f32(Xn[tr_idx]), f32(y[tr_idx])
    Xva, yva = f32(Xn[val_idx]), f32(y[val_idx])

    params, state = init_mlp(torch.Generator(device=dev).manual_seed(seed), X.shape[1])
    opt = AdamW(lr=constant_lr(lr), weight_decay=weight_decay, clip_norm=1.0)
    opt_state = opt.init(params)

    def loss_fn(pred, yb):
        if loss_kind == "mape":
            return mape_loss(pred, yb)
        return pinball_loss(pred, yb, quantile)

    def clone(tree):
        return tree_map(lambda t: t.detach().clone(), tree)

    dropout_rng = torch.Generator(device=dev).manual_seed(seed + 1)
    best = (np.inf, clone(params), clone(state))
    bad = 0
    n_tr = len(tr_idx)
    steps_per_epoch = max(n_tr // batch, 1)
    epochs = 0
    for epoch in range(max_epochs):
        order = torch.as_tensor(rng.permutation(n_tr), device=dev)
        for s in range(steps_per_epoch):
            idx = order[s * batch : (s + 1) * batch]
            leaves = [p.requires_grad_() for p in tree_leaves(params)]
            pred, state = mlp_forward(params, state, Xtr[idx], train=True, rng=dropout_rng)
            grads = torch.autograd.grad(loss_fn(pred, ytr[idx]), leaves)
            with torch.no_grad():
                params, opt_state, _ = opt.update(
                    tree_unflatten(params, grads), opt_state, params
                )
        epochs = epoch + 1
        with torch.no_grad():
            pred, _ = mlp_forward(params, state, Xva, train=False)
            vl = float(loss_fn(pred, yva))  # the epoch's one wait on the device
        if verbose and epoch % 10 == 0:
            print(f"  epoch {epoch:3d} val={vl:.4f}")
        if vl < best[0] - 1e-5:
            best = (vl, clone(params), clone(state))
            bad = 0
        else:
            bad += 1
            if bad >= patience and epoch >= min_epochs:
                break
    _, params, state = best
    floor = float(max(np.min(y) * 0.5, 1e-3))
    return TrainedMLP(
        params=_to_numpy(params), state=_to_numpy(state), mu_x=mu_x, sd_x=sd_x,
        y_floor=floor, x_lo=np.asarray(Xn[tr_idx].min(0)),
        x_hi=np.asarray(Xn[tr_idx].max(0)), epochs=epochs, steps=epochs * steps_per_epoch,
    )
