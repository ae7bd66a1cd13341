"""Parameters of the reference, as numpy arrays, into the port.

``params_from_numpy(tree, cfg, device)`` takes the tree that
``repro.models.transformer.init_params`` returns, after
``jax.tree.map(np.asarray, params)``, and builds the port's parameter
``Tree``: each segment's stacked leaves ``(n_layers, ...)`` become a list of
per-layer dicts, and so do whisper's encoder (``enc``, stacked over
``n_enc_layers``) and llama-vision's inner self-attention layers (``self``,
stacked twice: ``(n_groups, cross_every, ...)``). ``ml_dtypes.bfloat16``
arrays are viewed as ``uint16`` and then as ``torch.bfloat16``, so no value
is rounded on the way.

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
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _unstack(stacked, n: int, what: str) -> list:
    """A tree of arrays stacked along axis 0 -> a list of ``n`` trees."""
    leading = {np.shape(a)[0] for a in _leaves(stacked)}
    if leading != {n}:
        raise ValueError(f"{what}: leading axes {leading}, expected {n}")
    return [_map(stacked, lambda a, i=i: a[i]) for i in range(n)]


def params_from_numpy(tree: dict, cfg: ArchConfig, device="cuda") -> Tree:
    dev = resolve_device(device)
    segments = build_segments(cfg)
    if len(tree["segments"]) != len(segments):
        raise ValueError(
            f"{len(tree['segments'])} segments in the tree, {len(segments)} in {cfg.name}"
        )
    out = {}
    for key, val in tree.items():
        if key == "segments":
            val = []
            for seg, stacked in zip(segments, tree["segments"]):
                layers = _unstack(stacked, seg.n, f"segment {seg.name!r}")
                if seg.name == "vlm":
                    for lp in layers:
                        lp["self"] = _unstack(lp["self"], cfg.cross_every, "vlm self layers")
                val.append(layers)
        elif key == "enc":
            val = _unstack(val, cfg.n_enc_layers, "encoder")
        out[key] = _map(val, lambda a: to_tensor(a, dev))
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
