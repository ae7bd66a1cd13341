"""Mixture-of-Experts layer, in PyTorch (``repro.models.moe``): top-k routing
with capacity-based Switch/GShard dispatch.

Tokens are flattened and re-grouped into dispatch groups of up to
``cfg.moe_group`` tokens; within each group every expert has capacity
``C = ceil(group * top_k / E * capacity_factor)``. Routing, the slot-major
capacity ranking, and the dispatch and combine einsums over one-hot masks
follow the reference line by line. The expert FFN
``silu(xe Wg) * (xe Wu) Wd`` over the dispatched ``(G, E, C, d)`` tensor
goes to ``kernels.fused_moe`` (the Hopper kernel on the card, its plain
version on the CPU), where the reference writes it as three einsums: it is
the function the reference's Pallas kernel computes.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import constrain, local_slice, placements, resolve_pspec
from repro_torch.kernels import is_dtensor, kernel_placements, on_shards
from repro_torch.kernels.fused_moe import ops as moe_ops
from repro_torch.models.layers import dense_init, ffn, init_ffn

#: rows of an expert a fused_moe CTA owns (the kernel's default ``block_m``)
EXPERT_BLOCK_M = 128


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype, device):
    d, f, E = cfg.d_model, cfg.moe_hidden, cfg.n_experts
    p = {
        "router": dense_init(gen, (d, E), dtype, device),
        "w_gate": dense_init(gen, (E, d, f), dtype, device, in_axis=1),
        "w_up": dense_init(gen, (E, d, f), dtype, device, in_axis=1),
        "w_down": dense_init(gen, (E, f, d), dtype, device, in_axis=1),
    }
    if cfg.dense_residual:
        p["dense"] = init_ffn(gen, cfg, dtype, device, d_ff=cfg.d_ff)
    return p


def _capacity(group: int, cfg: ArchConfig, train: bool) -> int:
    cf = cfg.capacity_factor if train else max(cfg.capacity_factor, 2.0)
    c = int(math.ceil(group * cfg.top_k / cfg.n_experts * cf))
    return max(c, cfg.top_k)


def dispatch_geometry(cfg: ArchConfig, T: int, *, train: bool) -> tuple:
    """``(G, Sg, C)`` the layer uses for ``T`` tokens: group count, group
    size (largest divisor of ``T`` <= ``cfg.moe_group``) and per-expert
    capacity. ``moe_layer`` builds the dispatched tensor ``(G, E, C, d)``
    from exactly this, which ``decomposer.ep_alltoall_bytes`` prices."""
    Sg = next(g for g in range(min(cfg.moe_group, T), 0, -1) if T % g == 0)
    return T // Sg, Sg, _capacity(Sg, cfg, train)


def expert_ffn(xe: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """``(E, R, d)`` dispatched rows through ``fused_moe``.

    The kernel needs ``block_m`` to divide the rows, and a prefill of a
    prime length gives ``R = 4 * L`` rows that 128 does not divide. So the
    rows are padded with zeros to a multiple of ``min(EXPERT_BLOCK_M, R)``
    and sliced off after: a zero row gives a zero output row. DTensors run
    on each rank's experts and rows (``fused_moe``'s placements), each rank
    padding its own rows."""
    if is_dtensor(xe, w_gate, w_up, w_down):
        return moe_ops.on_expert_shards(expert_ffn, xe, w_gate, w_up, w_down)
    R = xe.shape[1]
    block_m = min(EXPERT_BLOCK_M, R)
    pad = -R % block_m
    xe = F.pad(xe, (0, 0, 0, pad)) if pad else xe.contiguous()
    out = moe_ops.fused_moe(xe, w_gate, w_up, w_down, block_m=block_m)
    return out[:, :R] if pad else out


def _expert_placements(combine, cfg: ArchConfig):
    """On a mesh: the placements of the dispatched ``(G, E, C, d)`` tensor
    (its constraint's), and those of ``combine`` ``(G, Sg, E, C)`` and of
    the grouped tokens ``(G, Sg, d)`` that match them."""
    mesh = combine.device_mesh
    G, _, E, C = combine.shape
    xe = placements(resolve_pspec((G, E, C, cfg.d_model), ("batch", "experts", None, None),
                                  mesh), mesh)
    cp = tuple(Shard(2) if p == Shard(1) else p for p in xe)
    xg = tuple(p if p == Shard(0) else Replicate() for p in xe)
    return xe, cp, xg


def _dispatch(dispatch, xg, cfg: ArchConfig):
    """``einsum("gsec,gsd->gecd")``. On a mesh each rank computes its own
    experts' slots, where they are sharded (as XLA's propagation from the
    constraint on the result places the product); the tokens' gradient is
    then a sum over the ranks' experts."""
    if not is_dtensor(dispatch, xg):
        return torch.einsum("gsec,gsd->gecd", dispatch, xg)
    xe, cp, xp = _expert_placements(dispatch, cfg)
    xg_grad = tuple(Partial() if p == Shard(1) else q for p, q in zip(xe, xp))
    return on_shards(functools.partial(torch.einsum, "gsec,gsd->gecd"), (dispatch, xg),
                     (cp, xp), xe, (cp, xg_grad))


def _combine(combine, ye, cfg: ArchConfig):
    """``einsum("gsec,gecd->gsd")``. On a mesh each rank sums over its own
    experts and the output is a pending sum over the expert-parallel dims,
    reduced where it is next used: no rank gathers the experts' outputs."""
    if not is_dtensor(combine, ye):
        return torch.einsum("gsec,gecd->gsd", combine, ye)
    xe, cp, xp = _expert_placements(combine, cfg)
    out = tuple(Partial() if p == Shard(1) else q for p, q in zip(xe, xp))
    return on_shards(functools.partial(torch.einsum, "gsec,gecd->gsd"), (combine, ye),
                     (cp, xe), out)


def _route(logits, K: int, C: int, rows=None):
    """Top-K routing and capacity assignment of ``(G, Sg, E)`` router
    logits: ``(combine (G, Sg, E, C), probs (G, Sg, E), top1 (G, Sg, E))``,
    ``top1`` the one-hot of each token's first expert; ``rows`` keeps a
    slice of the group's tokens in the outputs. Each dispatch group is
    ranked on its own, so on a mesh each rank routes its own groups, each
    whole (``kernels.on_shards``), and keeps the tokens it holds: the
    dropped (token, slot) set is the meshless one, no sharded dim is viewed
    apart, and the combine's product runs on the rank's tokens only (the
    logits' gradient there is a pending sum over the token shards)."""
    if is_dtensor(logits):
        lp = kernel_placements(logits, (0,))
        op = tuple(p if p in (Shard(0), Shard(1)) else Replicate() for p in logits.placements)
        grad = tuple(Partial() if p == Shard(1) else q for p, q in zip(logits.placements, lp))
        fn = functools.partial(_route, K=K, C=C, rows=local_slice(logits, 1))
        return on_shards(fn, (logits,), (lp,), [op, op, op], (grad,))
    G, Sg, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.topk(probs, K, dim=-1)  # (G, Sg, K), descending
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- capacity assignment (priority: slot k, then token order) --------
    onehot = F.one_hot(top_ids, E).float()  # (G, Sg, K, E)
    # rank within expert, counting slot-major: (k, s) flattened with k outer
    flat = onehot.transpose(1, 2).reshape(G, K * Sg, E)
    pos_flat = torch.cumsum(flat, dim=1) - flat  # tokens ahead of me
    pos = pos_flat.reshape(G, K, Sg, E).transpose(1, 2)  # (G, Sg, K, E)
    pos = (pos * onehot).sum(-1).to(torch.int32)  # (G, Sg, K)
    keep = pos < C
    top_w = top_w * keep  # dropped tokens lose their expert

    # ---- the combine tensor ----------------------------------------------
    # one_hot(pos, C), all zeros where pos >= C (as jax.nn.one_hot gives)
    pos_oh = (pos[..., None] == torch.arange(C, device=logits.device)).float() * keep[..., None]
    weighted = onehot * top_w[..., None]
    top1 = F.one_hot(top_ids[..., 0], E).float()
    if rows is not None:
        weighted, pos_oh, probs, top1 = (t[:, rows] for t in (weighted, pos_oh, probs, top1))
    combine = torch.einsum("gske,gskc->gsec", weighted, pos_oh)
    return combine, probs, top1


def moe_layer(p, x, cfg: ArchConfig, *, train: bool):
    """x: (B, S, d) -> (out, aux_loss)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    G, Sg, C = dispatch_geometry(cfg, T, train=train)
    xg = x.reshape(G, Sg, d)

    # ---- routing and capacity assignment, each dispatch group alone ------
    logits = (xg @ p["router"]).float()  # (G, Sg, E)
    combine, probs, top1 = _route(logits, K, C)
    if cfg.moe_bf16_combine:  # bf16 dispatch/combine in bf16 compute
        combine = combine.to(x.dtype)
    dispatch = (combine > 0).to(x.dtype)
    xe = _dispatch(dispatch, xg, cfg)  # (G, E, C, d)
    xe = constrain(xe, ("batch", "experts", None, None))

    # ---- expert FFN (SwiGLU), one fused_moe call over (E, G*C, d) rows -----
    rows = xe.transpose(0, 1).reshape(E, G * C, d)
    w = [p[k].to(x.dtype) for k in ("w_gate", "w_up", "w_down")]
    ye = expert_ffn(rows, *w).reshape(E, G, C, d).transpose(0, 1)  # (G, E, C, d)

    out = _combine(combine.to(x.dtype), ye, cfg).reshape(B, S, d)

    # ---- auxiliary load-balancing loss (Switch) ---------------------------
    me = probs.mean(dim=(0, 1))  # mean router prob per expert
    ce = (top1.sum(dim=1) / Sg).mean(dim=0)
    aux = E * (me * ce).sum()

    if cfg.dense_residual:
        out = out + ffn(p["dense"], x, cfg)
    return out, aux
