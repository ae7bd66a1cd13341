"""AdamW with f32 moments, decoupled weight decay, global-norm clipping and
LR schedules, ported from ``repro.optim.adamw`` over a dict/list tree of
f32 tensors.

It is not ``torch.optim.AdamW``, which differs from the reference: its
default ``b2`` is 0.999 (here 0.95), it decays every parameter (here only
leaves with ``ndim >= 2``), it has no global-norm clip, and it takes a
fixed learning rate (here ``lr(step)`` from a schedule, the step counted
after its increment). The update is the reference's:
``u = m̂ / (sqrt(v / c2) + eps) + wd·p``, then ``p - lr·u``.

``update`` is functional, as the reference's is: it returns new trees and
leaves its inputs untouched. The step count and the learning rate stay on
the host, so a step waits on the device nowhere.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch


# ----------------------------------------------------------------------
# trees: dicts, lists and tuples of tensors
# ----------------------------------------------------------------------


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_flatten(tree):
    """``(leaves, unflatten)`` in ``jax.tree_util``'s order: dict keys
    sorted, lists, tuples and NamedTuples in order, ``None`` an empty
    subtree. ``unflatten(new_leaves)`` rebuilds a tree of the same shape,
    its dicts keeping ``tree``'s key order (the checkpoints' leaf numbering
    and the gradient buckets' ledger follow the sorted order, as the
    reference's do; ``tree_leaves`` and the sums over it, such as
    ``global_norm``, keep theirs, so a restored state steps bit for bit as
    the one saved)."""
    leaves = []

    def walk(node):
        if node is None:
            return lambda it: None
        if isinstance(node, dict):
            subs = {k: walk(node[k]) for k in sorted(node)}
            order = list(node)

            def build(it):
                built = {k: s(it) for k, s in subs.items()}  # leaves taken in sorted order
                return {k: built[k] for k in order}

            return build
        if isinstance(node, (list, tuple)):
            subs = [walk(v) for v in node]
            if hasattr(node, "_fields"):  # a NamedTuple
                return lambda it: type(node)(*(s(it) for s in subs))
            return lambda it: type(node)(s(it) for s in subs)
        leaves.append(node)
        return lambda it: next(it)

    build = walk(tree)
    return leaves, lambda new_leaves: build(iter(new_leaves))


# ----------------------------------------------------------------------
# schedules
# ----------------------------------------------------------------------


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def sched(step):
        step = float(step)
        if step < warmup:
            return peak_lr * step / max(warmup, 1)
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak_lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * t)))

    return sched


def constant_lr(lr: float):
    return lambda step: float(lr)


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable  # step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        # zeros_like: a DTensor parameter's moments are placed as it is
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return AdamWState(step=0, mu=zeros, nu=tree_map(torch.clone, zeros))

    def update(self, grads, state: AdamWState, params):
        """``(new_params, new_state, {"grad_norm": tensor, "lr": float})``."""
        grads = tree_map(lambda g: g.float(), grads)
        gnorm = global_norm(grads)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        c1 = 1.0 - b1 ** step
        c2 = 1.0 - b2 ** step
        lr = self.lr(step)

        def upd(p, m, v):
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay and p.ndim >= 2:  # decay matrices only
                u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, AdamWState(step=step, mu=mu, nu=nu), {
            "grad_norm": gnorm,
            "lr": lr,
        }


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in tree_leaves(tree)))
