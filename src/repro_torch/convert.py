"""Parameters of the reference, as numpy arrays, into the port.

``params_from_numpy(tree, cfg, device)`` takes the tree that
``repro.models.transformer.init_params`` returns, after
``jax.tree.map(np.asarray, params)``, and builds the port's parameter
``Tree``: each segment's stacked leaves ``(n_layers, ...)`` become a list of
per-layer dicts. ``ml_dtypes.bfloat16`` arrays are viewed as ``uint16`` and
then as ``torch.bfloat16``, so no value is rounded on the way.

``mlp_from_numpy`` and ``pipeweave_from_numpy`` carry a reference
``TrainedMLP`` (its ``params`` and ``state`` after
``jax.tree.map(np.asarray, ...)``, and its normalization arrays) and a
reference ``PipeWeave`` into the port's numpy-only estimator, whose
``predict`` is then bit-equal to the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.estimator import PipeWeave
from repro_torch.core.nn import TrainedMLP
from repro_torch.models.registry import resolve_device
from repro_torch.models.transformer import Tree, build_segments
from repro_torch.optim.adamw import tree_map


def to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy: the port owns its parameters
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: dict, cfg: ArchConfig, device="cuda") -> Tree:
    dev = resolve_device(device)
    segments = build_segments(cfg)
    if len(tree["segments"]) != len(segments):
        raise ValueError(
            f"{len(tree['segments'])} segments in the tree, {len(segments)} in {cfg.name}"
        )
    out = {k: _map(v, lambda a: to_tensor(a, dev)) for k, v in tree.items() if k != "segments"}
    out["segments"] = []
    for seg, stacked in zip(segments, tree["segments"]):
        leading = {np.shape(a)[0] for a in _leaves(stacked)}
        if leading != {seg.n}:
            raise ValueError(f"segment {seg.name!r}: leading axes {leading}, expected {seg.n}")
        out["segments"].append(
            [_map(stacked, lambda a, i=i: to_tensor(a[i], dev)) for i in range(seg.n)]
        )
    return Tree(out)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def mlp_from_numpy(params, state, mu_x, sd_x, y_floor, x_lo, x_hi) -> TrainedMLP:
    copy = lambda a: None if a is None else np.array(a)
    return TrainedMLP(
        params=tree_map(np.array, params), state=tree_map(np.array, state),
        mu_x=copy(mu_x), sd_x=copy(sd_x), y_floor=float(y_floor),
        x_lo=copy(x_lo), x_hi=copy(x_hi),
    )


def pipeweave_from_numpy(models: dict) -> PipeWeave:
    """``{kind: mlp_from_numpy's keyword arguments}`` -> ``PipeWeave``."""
    return PipeWeave(models={kind: mlp_from_numpy(**kw) for kind, kw in models.items()})
