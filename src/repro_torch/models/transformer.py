"""Decoder assembly, in PyTorch (``repro.models.transformer``).

A model is a list of *segments*, each a homogeneous stack of layers. The
reference scans each stack with ``lax.scan`` over stacked parameters; here
a segment's parameters are an ``nn.ModuleList`` of per-layer trees and
``Segment.apply`` is a Python loop over it. The KV cache keeps the
reference's layout: a list with one ``{"k", "v"}`` dict per segment, each
leaf ``(n_layers, B, S, Hkv, D)``.

Modes: 'train' (no cache), 'prefill' (build KV caches), 'decode' (one token
against the caches, which are updated in place). The dense and MoE families
with global attention are ported; ``build_segments`` raises for the others.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[name]


class Tree(nn.Module):
    """A nested dict of tensors (lists of dicts allowed) held as a Module.

    Leaves are parameters without gradients; dicts become child ``Tree``s
    and lists ``nn.ModuleList``s. ``tree[key]`` reads a child or a leaf, so
    the layer functions take a ``Tree`` or a plain dict alike."""

    def __init__(self, tree: dict):
        super().__init__()
        self._names = list(tree)
        for key, val in tree.items():
            if isinstance(val, torch.Tensor):
                self.register_parameter(key, nn.Parameter(val, requires_grad=False))
            else:
                self.add_module(key, _node(val))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._names

    def keys(self):
        return list(self._names)


def _node(val) -> nn.Module:
    if isinstance(val, nn.Module):
        return val
    if isinstance(val, dict):
        return Tree(val)
    if isinstance(val, (list, tuple)):
        return nn.ModuleList([_node(e) for e in val])
    raise TypeError(f"Tree: unsupported node {type(val).__name__}")


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """Apply ``fn`` to every leaf of a Tree / dict / list; returns plain
    dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (Tree, dict)):
        return {k: tree_map(fn, tree[k]) for k in tree.keys()}
    return [tree_map(fn, e) for e in tree]


def _cast(p, dtype):
    """Floating leaves to ``dtype`` (a no-op for leaves already in it)."""
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, p)


def cast_for_compute(params: Tree, cfg: ArchConfig) -> Tree:
    """The parameters as the forward pass uses them: block and embedding
    leaves in ``cfg.compute_dtype``, the final norm in its own type.

    The reference casts block parameters at every block call and the
    embedding tables at every use; the values are the same when the cast
    is done once, which saves re-reading the f32 weights every step."""
    cdt = torch_dtype(cfg.compute_dtype)
    out = {k: params[k] for k in params.keys()}
    out["embed"] = _cast(params["embed"], cdt)
    out["segments"] = [[_cast(lp, cdt) for lp in seg] for seg in params["segments"]]
    return Tree(out)


@dataclasses.dataclass
class Ctx:
    cfg: ArchConfig
    train: bool = False
    positions: Optional[torch.Tensor] = None  # (B, S) train/prefill
    dec_positions: Optional[torch.Tensor] = None  # (B,) decode


# ======================================================================
# block bodies: fwd(p, x, ctx, cache, mode) -> (x, aux, new_cache)
# ======================================================================


def _self_attn(p, x, ctx: Ctx, cache, mode, *, window, causal=True):
    cfg = ctx.cfg
    if mode == "decode":
        out, ck, cv = L.attention_decode(
            p, x, cfg, cache["k"], cache["v"], ctx.dec_positions, window=window
        )
        return out, {"k": ck, "v": cv}
    out, (k, v) = L.attention_layer(p, x, cfg, ctx.positions, window=window, causal=causal)
    if mode == "prefill":
        return out, {"k": k, "v": v}
    return out, None


def dense_block(p, x, ctx: Ctx, cache, mode, *, window):
    cfg = ctx.cfg
    p = _cast(p, x.dtype)
    h = L.apply_norm(p["ln1"], x, cfg)
    attn_out, new_cache = _self_attn(p["attn"], h, ctx, cache, mode, window=window)
    if cfg.post_norms:
        attn_out = L.apply_norm(p["post_ln1"], attn_out, cfg)
    x = x + attn_out
    h = L.apply_norm(p["ln2"], x, cfg)
    ffn_out = L.ffn(p["ffn"], h, cfg)
    if cfg.post_norms:
        ffn_out = L.apply_norm(p["post_ln2"], ffn_out, cfg)
    return x + ffn_out, 0.0, new_cache


def init_dense_block(gen, cfg: ArchConfig, dtype, device):
    p = {
        "ln1": L.init_norm(cfg, cfg.d_model, dtype, device),
        "attn": L.init_attention(gen, cfg, dtype, device),
        "ln2": L.init_norm(cfg, cfg.d_model, dtype, device),
        "ffn": L.init_ffn(gen, cfg, dtype, device),
    }
    if cfg.post_norms:
        p["post_ln1"] = L.init_norm(cfg, cfg.d_model, dtype, device)
        p["post_ln2"] = L.init_norm(cfg, cfg.d_model, dtype, device)
    return p


def moe_block(p, x, ctx: Ctx, cache, mode, *, window):
    cfg = ctx.cfg
    p = _cast(p, x.dtype)
    h = L.apply_norm(p["ln1"], x, cfg)
    attn_out, new_cache = _self_attn(p["attn"], h, ctx, cache, mode, window=window)
    x = x + attn_out
    h = L.apply_norm(p["ln2"], x, cfg)
    moe_out, aux = M.moe_layer(p["moe"], h, cfg, train=ctx.train)
    return x + moe_out, aux, new_cache


def init_moe_block(gen, cfg: ArchConfig, dtype, device):
    return {
        "ln1": L.init_norm(cfg, cfg.d_model, dtype, device),
        "attn": L.init_attention(gen, cfg, dtype, device),
        "ln2": L.init_norm(cfg, cfg.d_model, dtype, device),
        "moe": M.init_moe(gen, cfg, dtype, device),
    }


# ======================================================================
# segment machinery
# ======================================================================


@dataclasses.dataclass
class Segment:
    name: str
    n: int
    init_one: Callable[..., Any]  # (gen, dtype, device) -> one layer's params
    fwd: Callable  # (p, x, ctx, cache, mode) -> (x, aux, cache)

    def init(self, gen, dtype, device) -> list:
        return [self.init_one(gen, dtype, device) for _ in range(self.n)]

    def apply(self, params: nn.ModuleList, x, ctx: Ctx, mode: str, cache=None):
        """Run the stack: a Python loop over the layers' parameters. In
        prefill, each layer's cache is stacked along a new leading axis; in
        decode, layer i reads (and updates in place) ``cache[...][i]``."""
        aux = 0.0
        if mode == "decode":
            for i, lp in enumerate(params):
                x, _, _ = self.fwd(lp, x, ctx, {k: c[i] for k, c in cache.items()}, mode)
            return x, 0.0, cache
        per_layer = []
        for lp in params:
            x, a, c = self.fwd(lp, x, ctx, None, mode)
            aux = aux + a
            per_layer.append(c)
        if mode != "prefill":
            return x, aux, None
        return x, aux, {k: torch.stack([c[k] for c in per_layer]) for k in per_layer[0]}


def build_segments(cfg: ArchConfig) -> list[Segment]:
    if cfg.family not in ("dense", "moe") or cfg.layer_pattern != "global":
        raise NotImplementedError(
            f"{cfg.name}: only dense and MoE decoders with global attention are "
            f"ported (family={cfg.family!r}, layer_pattern={cfg.layer_pattern!r})"
        )
    init, fwd = {"dense": (init_dense_block, dense_block),
                 "moe": (init_moe_block, moe_block)}[cfg.family]
    return [
        Segment(
            cfg.family,
            cfg.n_layers,
            lambda gen, dt, dev: init(gen, cfg, dt, dev),
            partial(fwd, window=cfg.window),
        )
    ]


# ======================================================================
# full model
# ======================================================================


def init_params(cfg: ArchConfig, gen: torch.Generator, device) -> Tree:
    """Random parameters with the reference's tree, shapes and laws, drawn
    from ``gen`` (a generator on ``device``)."""
    dt = torch_dtype(cfg.param_dtype)
    segments = build_segments(cfg)
    return Tree({
        "embed": L.init_embed(gen, cfg, dt, device),
        "final_norm": L.init_norm(cfg, cfg.d_model, dt, device),
        "segments": [seg.init(gen, dt, device) for seg in segments],
    })


def forward(params, cfg: ArchConfig, batch, mode: str):
    """train/prefill forward. batch: dict(tokens (B, S) integer tensor).

    Returns (hidden, aux, caches): hidden is the post-final-norm residual
    stream; callers turn it into logits."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    ctx = Ctx(cfg=cfg, train=(mode == "train"), positions=pos)
    x = L.embed_tokens(params["embed"], tokens, cfg, torch_dtype(cfg.compute_dtype))
    caches = []
    aux = 0.0
    for seg, seg_params in zip(build_segments(cfg), params["segments"]):
        x, a, c = seg.apply(seg_params, x, ctx, mode)
        aux = aux + a
        caches.append(c)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return x, aux, (caches if mode == "prefill" else None)


def full_logits(params, cfg: ArchConfig, hidden):
    """Logits for every position of ``hidden``."""
    return L.lm_logits(params["embed"], hidden, cfg)


def decode_step(params, cfg: ArchConfig, caches, tokens, positions):
    """One decode step. tokens: (B,) integer; positions: (B,) absolute
    position of the new token. Returns (logits, caches); the caches are the
    ones passed in, updated in place."""
    x = L.embed_tokens(params["embed"], tokens[:, None], cfg, torch_dtype(cfg.compute_dtype))
    ctx = Ctx(cfg=cfg, dec_positions=positions)
    for seg, seg_params, seg_cache in zip(build_segments(cfg), params["segments"], caches):
        x, _, _ = seg.apply(seg_params, x, ctx, "decode", cache=seg_cache)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], x, cfg)[:, 0, :], caches


def pad_cache(caches, cfg: ArchConfig, max_len: int):
    """Pad prefill-produced KV caches (seq dim) out to ``max_len`` so
    decode steps can write into them (``cfg`` is kept for the reference's
    signature)."""

    def pad(leaf):  # (n_layers, B, S, Hkv, D)
        cur = leaf.shape[2]
        return leaf if cur >= max_len else torch.nn.functional.pad(
            leaf, (0, 0, 0, 0, 0, max_len - cur))

    return [{k: pad(v) for k, v in seg.items()} for seg in caches]


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device):
    """Zero caches matching decode_step's expectations. max_len includes the
    token about to be written."""
    cdt = torch_dtype(cfg.compute_dtype)
    shape_of = lambda n: (n, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return [
        {k: torch.zeros(shape_of(seg.n), dtype=cdt, device=device) for k in ("k", "v")}
        for seg in build_segments(cfg)
    ]
