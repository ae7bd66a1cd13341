"""Model zoo assembly, in PyTorch (``repro.models.transformer``).

A model is a list of *segments*, each a homogeneous stack of layers. The
reference scans each stack with ``lax.scan`` over stacked parameters; here
a segment's parameters are an ``nn.ModuleList`` of per-layer trees and
``Segment.apply`` is a Python loop over it. Heterogeneous layer patterns
(gemma2's local/global pairs, hymba's global islands, llama-vision's
cross-attention groups) become several segments or composite block bodies,
as in the reference. The caches keep the reference's trees: one tree per
segment, each leaf stacked over the segment's layers,
``(n_layers, B, S, Hkv, D)`` for a KV leaf (llama-vision's inner self
layers add an axis: ``(n_groups, cross_every, ...)``).

Modes: 'train' (no cache; with ``cfg.remat == "layer"`` each layer runs
under ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``),
'prefill' (build the KV and SSM caches),
'decode' (one token against the caches). Decode updates the caches in
place: KV leaves are written by ``attention_decode``, and a block that
returns new leaves (the SSM state) has them copied back into its layer's
slice of the cache, so the caller's tree is the updated one. Every family
of the zoo is ported.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM


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


def trainable(params) -> dict:
    """The parameters as a plain tree (dicts and lists) of leaves that take
    gradients: each a detached copy of the ``Tree``'s leaf with
    ``requires_grad``. The ``Tree`` itself, the engines' frozen parameters,
    is left as it is."""
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), params)


def tree_stack(trees: list):
    """Stack a list of same-shaped cache trees (nested dicts of tensors)
    leaf by leaf along a new axis 0."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return {k: tree_stack([t[k] for t in trees]) for k in first}


def _write_back(dst, src):
    """Copy every leaf of the cache tree ``src`` that is not already the
    tensor of ``dst`` at the same place into it (``dst`` holds views into
    the caller's cache)."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    else:
        for k in dst:
            _write_back(dst[k], src[k])


#: leaves that stay f32 when a block is cast (the SSM's decay and skip)
KEEP_F32 = ("A_log", "dt_bias", "D")


def _cast(p, dtype, keep_f32=KEEP_F32):
    """Floating leaves to ``dtype`` (a no-op for leaves already in it),
    except f32 leaves named in ``keep_f32``, as the reference's ``_cast``."""

    def walk(node, name):
        if isinstance(node, torch.Tensor):
            if node.dtype == torch.float32 and name in keep_f32:
                return node
            return node.to(dtype) if node.is_floating_point() else node
        if isinstance(node, (Tree, dict)):
            return {k: walk(node[k], k) for k in node.keys()}
        return [walk(e, name) for e in node]

    return walk(p, None)


def cast_for_compute(params: Tree, cfg: ArchConfig) -> Tree:
    """The parameters as the forward pass uses them: block, encoder and
    embedding leaves (token, meta-token and learned-position tables) in
    ``cfg.compute_dtype`` (the SSM's ``A_log``/``dt_bias``/``D`` kept f32),
    the final and encoder norms in their own type.

    The reference casts block parameters at every block call and the
    embedding tables at every use; the values are the same when the cast
    is done once, which saves re-reading the f32 weights every step."""
    cdt = torch_dtype(cfg.compute_dtype)
    out = {k: params[k] for k in params.keys()}
    out["embed"] = _cast(params["embed"], cdt)
    out["segments"] = [[_cast(lp, cdt) for lp in seg] for seg in params["segments"]]
    for key in ("enc", "meta", "enc_pos", "dec_pos"):
        if key in params:
            out[key] = _cast(params[key], cdt)
    return Tree(out)


@dataclasses.dataclass
class Ctx:
    cfg: ArchConfig
    train: bool = False
    positions: Optional[torch.Tensor] = None  # (B, S) train/prefill
    dec_positions: Optional[torch.Tensor] = None  # (B,) decode
    img: Optional[torch.Tensor] = None  # VLM patch embeddings (B, P, d)
    enc_out: Optional[torch.Tensor] = None  # whisper encoder output (B, F, d)


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
    # attn_shard_hint: True = always, "train" = training only, as the reference
    hint = cfg.attn_shard_hint is True or (cfg.attn_shard_hint == "train" and mode == "train")
    out, (k, v) = L.attention_layer(p, x, cfg, ctx.positions, window=window, causal=causal,
                                    shard_hint=hint)
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
    x = constrain(x + attn_out, ("batch", None, None))
    h = L.apply_norm(p["ln2"], x, cfg)
    ffn_out = L.ffn(p["ffn"], h, cfg)
    if cfg.post_norms:
        ffn_out = L.apply_norm(p["post_ln2"], ffn_out, cfg)
    x = constrain(x + ffn_out, ("batch", None, None))
    return x, 0.0, new_cache


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


def pair_block(p, x, ctx: Ctx, cache, mode, *, window):
    """gemma2: one sliding-window layer followed by one global layer."""
    cache = cache or {"local": None, "global": None}
    x, a1, c1 = dense_block(p["local"], x, ctx, cache["local"], mode, window=window)
    x, a2, c2 = dense_block(p["global"], x, ctx, cache["global"], mode, window=None)
    new_cache = None if c1 is None else {"local": c1, "global": c2}
    return x, a1 + a2, new_cache


def moe_block(p, x, ctx: Ctx, cache, mode, *, window):
    cfg = ctx.cfg
    p = _cast(p, x.dtype)
    h = L.apply_norm(p["ln1"], x, cfg)
    attn_out, new_cache = _self_attn(p["attn"], h, ctx, cache, mode, window=window)
    x = constrain(x + attn_out, ("batch", None, None))
    h = L.apply_norm(p["ln2"], x, cfg)
    moe_out, aux = M.moe_layer(p["moe"], h, cfg, train=ctx.train)
    x = constrain(x + moe_out, ("batch", None, None))
    return x, aux, new_cache


def init_moe_block(gen, cfg: ArchConfig, dtype, device):
    return {
        "ln1": L.init_norm(cfg, cfg.d_model, dtype, device),
        "attn": L.init_attention(gen, cfg, dtype, device),
        "ln2": L.init_norm(cfg, cfg.d_model, dtype, device),
        "moe": M.init_moe(gen, cfg, dtype, device),
    }


def ssm_block(p, x, ctx: Ctx, cache, mode):
    cfg = ctx.cfg
    p = _cast(p, x.dtype)
    h = L.apply_norm(p["ln1"], x, cfg)
    if mode == "decode":
        out, st = SSM.ssm_decode(p["mix"], h, cfg, SSM.SSMState(cache["conv"], cache["ssm"]))
        new_cache = {"conv": st.conv, "ssm": st.ssm}
    else:
        out, st = SSM.ssm_layer(p["mix"], h, cfg)
        new_cache = {"conv": st.conv, "ssm": st.ssm} if mode == "prefill" else None
    x = constrain(x + out, ("batch", None, None))
    return x, 0.0, new_cache


def init_ssm_block(gen, cfg: ArchConfig, dtype, device):
    return {
        "ln1": L.init_norm(cfg, cfg.d_model, dtype, device),
        "mix": SSM.init_ssm(gen, cfg, dtype, device),
    }


def hybrid_block(p, x, ctx: Ctx, cache, mode, *, window):
    """hymba: parallel attention and SSM heads, the mean of their norms."""
    cfg = ctx.cfg
    p = _cast(p, x.dtype)
    cache = cache or {"attn": None, "ssm": None}
    h = L.apply_norm(p["ln1"], x, cfg)
    attn_out, attn_cache = _self_attn(p["attn"], h, ctx, cache["attn"], mode, window=window)
    if mode == "decode":
        ssm_out, st = SSM.ssm_decode(
            p["mix"], h, cfg, SSM.SSMState(cache["ssm"]["conv"], cache["ssm"]["ssm"])
        )
    else:
        ssm_out, st = SSM.ssm_layer(p["mix"], h, cfg)
    mixed = 0.5 * (L.rmsnorm(attn_out, p["norm_attn"]) + L.rmsnorm(ssm_out, p["norm_ssm"]))
    x = constrain(x + mixed, ("batch", None, None))
    h = L.apply_norm(p["ln2"], x, cfg)
    x = constrain(x + L.ffn(p["ffn"], h, cfg), ("batch", None, None))
    new_cache = None
    if mode != "train":
        new_cache = {"attn": attn_cache, "ssm": {"conv": st.conv, "ssm": st.ssm}}
    return x, 0.0, new_cache


def init_hybrid_block(gen, cfg: ArchConfig, dtype, device):
    return {
        "ln1": L.init_norm(cfg, cfg.d_model, dtype, device),
        "attn": L.init_attention(gen, cfg, dtype, device),
        "mix": SSM.init_ssm(gen, cfg, dtype, device),
        "norm_attn": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "norm_ssm": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "ln2": L.init_norm(cfg, cfg.d_model, dtype, device),
        "ffn": L.init_ffn(gen, cfg, dtype, device),
    }


def cross_block(p, x, ctx: Ctx, cache, mode):
    """llama-3.2-vision's gated cross-attention layer (queries: text; keys
    and values: image). The gates are stored f32 and cast with the block,
    then ``tanh`` in that type, as the reference does."""
    cfg = ctx.cfg
    p = _cast(p, x.dtype)
    h = L.apply_norm(p["ln1"], x, cfg)
    if mode == "decode":
        out = L.cross_attention_cached(p["attn"], h, cache["ck"], cache["cv"], cfg)
        new_cache = cache
    else:
        out, (ck, cv) = L.cross_attention_layer(p["attn"], h, ctx.img, cfg)
        new_cache = {"ck": ck, "cv": cv} if mode == "prefill" else None
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * out
    h = L.apply_norm(p["ln2"], x, cfg)
    x = x + torch.tanh(p["gate_ffn"]).to(x.dtype) * L.ffn(p["ffn"], h, cfg)
    return constrain(x, ("batch", None, None)), 0.0, new_cache


def init_cross_block(gen, cfg: ArchConfig, dtype, device):
    return {
        "ln1": L.init_norm(cfg, cfg.d_model, dtype, device),
        "attn": L.init_cross_attention(gen, cfg, dtype, device),
        "gate_attn": torch.zeros((), dtype=torch.float32, device=device),
        "ln2": L.init_norm(cfg, cfg.d_model, dtype, device),
        "ffn": L.init_ffn(gen, cfg, dtype, device),
        "gate_ffn": torch.zeros((), dtype=torch.float32, device=device),
    }


def vlm_group(p, x, ctx: Ctx, cache, mode):
    """``cross_every`` self-attention layers (an inner stack, whose cache
    leaves gain an axis) followed by one gated cross-attention layer."""
    cache = cache or {"self": None, "cross": None}
    inner = Segment("self", len(p["self"]), None, partial(dense_block, window=None))
    x, aux, self_caches = inner.apply(p["self"], x, ctx, mode, cache=cache["self"])
    x, a2, cross_cache = cross_block(p["cross"], x, ctx, cache["cross"], mode)
    new_cache = None
    if mode != "train":
        new_cache = {"self": self_caches, "cross": cross_cache}
    return x, aux + a2, new_cache


def init_vlm_group(gen, cfg: ArchConfig, dtype, device):
    return {
        "self": [init_dense_block(gen, cfg, dtype, device) for _ in range(cfg.cross_every)],
        "cross": init_cross_block(gen, cfg, dtype, device),
    }


def encdec_block(p, x, ctx: Ctx, cache, mode):
    """whisper's decoder layer: causal self-attention, cross-attention to
    the encoder's output, FFN."""
    cfg = ctx.cfg
    p = _cast(p, x.dtype)
    cache = cache or {"self": None, "cross": None}
    h = L.apply_norm(p["ln1"], x, cfg)
    attn_out, self_cache = _self_attn(p["attn"], h, ctx, cache["self"], mode, window=None)
    x = x + attn_out
    h = L.apply_norm(p["ln_x"], x, cfg)
    if mode == "decode":
        xo = L.cross_attention_cached(p["xattn"], h, cache["cross"]["ck"],
                                      cache["cross"]["cv"], cfg)
        cross_cache = cache["cross"]
    else:
        xo, (ck, cv) = L.cross_attention_layer(p["xattn"], h, ctx.enc_out, cfg)
        cross_cache = {"ck": ck, "cv": cv} if mode == "prefill" else None
    x = x + xo
    h = L.apply_norm(p["ln2"], x, cfg)
    x = constrain(x + L.ffn(p["ffn"], h, cfg), ("batch", None, None))
    new_cache = None
    if mode != "train":
        new_cache = {"self": self_cache, "cross": cross_cache}
    return x, 0.0, new_cache


def init_encdec_block(gen, cfg: ArchConfig, dtype, device):
    return {
        "ln1": L.init_norm(cfg, cfg.d_model, dtype, device),
        "attn": L.init_attention(gen, cfg, dtype, device),
        "ln_x": L.init_norm(cfg, cfg.d_model, dtype, device),
        "xattn": L.init_cross_attention(gen, cfg, dtype, device),
        "ln2": L.init_norm(cfg, cfg.d_model, dtype, device),
        "ffn": L.init_ffn(gen, cfg, dtype, device),
    }


def enc_block(p, x, ctx: Ctx, cache, mode):
    """whisper's encoder layer: bidirectional self-attention, FFN (no cache)."""
    cfg = ctx.cfg
    p = _cast(p, x.dtype)
    h = L.apply_norm(p["ln1"], x, cfg)
    out, _ = _self_attn(p["attn"], h, ctx, None, "train", window=None, causal=False)
    x = x + out
    h = L.apply_norm(p["ln2"], x, cfg)
    return x + L.ffn(p["ffn"], h, cfg), 0.0, None


def init_encdec_enc(gen, cfg: ArchConfig, dtype, device):
    return {
        "ln1": L.init_norm(cfg, cfg.d_model, dtype, device),
        "attn": L.init_attention(gen, cfg, dtype, device),
        "ln2": L.init_norm(cfg, cfg.d_model, dtype, device),
        "ffn": L.init_ffn(gen, cfg, dtype, device),
    }


# ======================================================================
# segment machinery
# ======================================================================


@dataclasses.dataclass
class Segment:
    name: str
    n: int
    init_one: Optional[Callable[..., Any]]  # (gen, dtype, device) -> one layer's params
    fwd: Callable  # (p, x, ctx, cache, mode) -> (x, aux, cache)

    def init(self, gen, dtype, device) -> list:
        return [self.init_one(gen, dtype, device) for _ in range(self.n)]

    def apply(self, params, x, ctx: Ctx, mode: str, cache=None, remat=False):
        """Run the stack: a Python loop over the layers' parameters. In
        prefill, the layers' cache trees are stacked leaf by leaf along a
        new leading axis; in decode, layer i reads the views ``leaf[i]`` of
        ``cache`` and whatever new leaves it returns are copied into them,
        so ``cache`` itself is the updated cache. In train mode with
        ``remat``, each layer runs under ``torch.utils.checkpoint``: only
        its input is kept, and its forward (kernels included) runs again in
        the backward pass."""
        if mode == "train" and remat:
            aux = 0.0
            for lp in params:
                x, a = checkpoint(self._train_layer, lp, x, ctx, use_reentrant=False)
                aux = aux + a
            return x, aux, None
        if mode == "decode":
            for i, lp in enumerate(params):
                layer_cache = tree_map(lambda c: c[i], cache)
                x, _, new = self.fwd(lp, x, ctx, layer_cache, mode)
                _write_back(layer_cache, new)
            return x, 0.0, cache
        aux = 0.0
        per_layer = []
        for lp in params:
            x, a, c = self.fwd(lp, x, ctx, None, mode)
            aux = aux + a
            per_layer.append(c)
        if mode != "prefill":
            return x, aux, None
        return x, aux, tree_stack(per_layer)

    def _train_layer(self, lp, x, ctx):
        y, a, _ = self.fwd(lp, x, ctx, None, "train")
        return y, a


def build_segments(cfg: ArchConfig) -> list[Segment]:
    def seg(name, n, init, fwd):
        return Segment(name, n, lambda gen, dt, dev: init(gen, cfg, dt, dev), fwd)

    if cfg.family == "dense":
        if cfg.layer_pattern == "alt_local_global":
            if cfg.n_layers % 2:
                raise ValueError(f"{cfg.name}: alt_local_global needs an even n_layers")

            def init_pair(gen, cfg, dt, dev):
                return {"local": init_dense_block(gen, cfg, dt, dev),
                        "global": init_dense_block(gen, cfg, dt, dev)}

            return [seg("pairs", cfg.n_layers // 2, init_pair,
                        partial(pair_block, window=cfg.window))]
        return [seg("dense", cfg.n_layers, init_dense_block,
                    partial(dense_block, window=cfg.window))]
    if cfg.family == "moe":
        return [seg("moe", cfg.n_layers, init_moe_block, partial(moe_block, window=cfg.window))]
    if cfg.family == "ssm":
        return [seg("ssm", cfg.n_layers, init_ssm_block, ssm_block)]
    if cfg.family == "hybrid":
        # global attention islands at the first, middle and last layer
        n = cfg.n_layers
        gl = partial(hybrid_block, window=None)
        loc = partial(hybrid_block, window=cfg.window)
        globals_at = sorted({0, n // 2, n - 1})
        segs, prev = [], -1
        for gi, g in enumerate(globals_at):
            if g - prev - 1 > 0:
                segs.append(seg(f"loc_{gi}", g - prev - 1, init_hybrid_block, loc))
            segs.append(seg(f"g_{gi}", 1, init_hybrid_block, gl))
            prev = g
        if n - 1 - globals_at[-1] > 0:
            segs.append(seg("loc_tail", n - 1 - globals_at[-1], init_hybrid_block, loc))
        return segs
    if cfg.family == "vlm":
        return [seg("vlm", cfg.n_layers // cfg.cross_every, init_vlm_group, vlm_group)]
    if cfg.family == "audio":
        return [seg("dec", cfg.n_layers, init_encdec_block, encdec_block)]
    raise ValueError(cfg.family)


# ======================================================================
# full model
# ======================================================================

MAX_DEC_POS = 32768  # whisper's learned decoder-position table size


def init_params(cfg: ArchConfig, gen: torch.Generator, device) -> Tree:
    """Random parameters with the reference's tree, shapes and laws, drawn
    from ``gen`` (a generator on ``device``)."""
    dt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    params = {
        "embed": L.init_embed(gen, cfg, dt, device),
        "final_norm": L.init_norm(cfg, d, dt, device),
        "segments": [seg.init(gen, dt, device) for seg in build_segments(cfg)],
    }
    if cfg.meta_tokens:
        params["meta"] = L.embed_init(gen, (cfg.meta_tokens, d), dt, device)
    if cfg.family == "audio":
        params["enc"] = [init_encdec_enc(gen, cfg, dt, device) for _ in range(cfg.n_enc_layers)]
        params["enc_pos"] = L.embed_init(gen, (cfg.enc_frames, d), dt, device)
        params["dec_pos"] = L.embed_init(gen, (MAX_DEC_POS, d), dt, device)
        params["enc_norm"] = L.init_norm(cfg, d, dt, device)
    return Tree(params)


def _run_encoder(params, cfg: ArchConfig, frames, ctx: Ctx):
    """whisper's encoder over the frame embeddings (its conv front end is a
    stub, as in the reference): learned positions, bidirectional layers,
    the encoder norm."""
    cdt = torch_dtype(cfg.compute_dtype)
    B, F = frames.shape[:2]
    x = frames.to(cdt) + params["enc_pos"][:F][None].to(cdt)
    seg = Segment("enc", cfg.n_enc_layers, None, enc_block)
    enc_ctx = dataclasses.replace(
        ctx, positions=torch.arange(F, device=frames.device).expand(B, F))
    x, _, _ = seg.apply(params["enc"], x, enc_ctx, "train")
    return L.apply_norm(params["enc_norm"], x, cfg)


def _embed_input(params, cfg: ArchConfig, tokens, base_positions):
    """Token embeddings, with hymba's meta tokens in front and whisper's
    learned decoder positions added. Returns (x, positions)."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = L.embed_tokens(params["embed"], tokens, cfg, cdt)
    if cfg.meta_tokens:
        B, m = tokens.shape[0], cfg.meta_tokens
        meta = params["meta"][None].to(cdt).expand(B, m, cfg.d_model)
        x = torch.cat([meta, x], dim=1)
        pos = torch.cat([torch.arange(m, device=tokens.device).expand(B, m),
                         base_positions + m], dim=1)
    else:
        pos = base_positions
    if cfg.family == "audio":
        x = x + L.lookup_rows(params["dec_pos"], base_positions).to(cdt)
    return x, pos


def forward(params, cfg: ArchConfig, batch, mode: str):
    """train/prefill forward. batch: dict(tokens (B, S) integer tensor, and
    ``frames`` (audio) or ``image_embeds`` (vlm)).

    Returns (hidden, aux, caches): hidden is the post-final-norm residual
    stream, meta tokens stripped; callers turn it into logits. The
    positions every layer sees are ``0..S-1`` (``0..m+S-1`` with ``m``
    meta tokens), which is what the flash-attention kernel assumes."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    base_pos = torch.arange(S, device=tokens.device).expand(B, S)
    ctx = Ctx(cfg=cfg, train=(mode == "train"))
    if cfg.family == "vlm":
        ctx.img = batch["image_embeds"].to(torch_dtype(cfg.compute_dtype))
    if cfg.family == "audio":
        ctx.enc_out = _run_encoder(params, cfg, batch["frames"], ctx)
    x, ctx.positions = _embed_input(params, cfg, tokens, base_pos)
    x = constrain(x, ("batch", None, None))
    caches = []
    aux = 0.0
    for seg, seg_params in zip(build_segments(cfg), params["segments"]):
        x, a, c = seg.apply(seg_params, x, ctx, mode,
                            remat=(cfg.remat == "layer" and mode == "train"))
        aux = aux + a
        caches.append(c)
    x = L.apply_norm(params["final_norm"], x, cfg)
    if cfg.meta_tokens:
        x = x[:, cfg.meta_tokens:, :]
    return x, aux, (caches if mode == "prefill" else None)


def full_logits(params, cfg: ArchConfig, hidden):
    """Logits for every position of ``hidden``."""
    return L.lm_logits(params["embed"], hidden, cfg)


def train_loss(params, cfg: ArchConfig, batch):
    """Next-token loss ``ce + 0.01 aux`` over the batch's tokens, and
    ``{"ce", "aux"}`` (aux: the MoE load-balancing loss, 0 elsewhere)."""
    hidden, aux, _ = forward(params, cfg, batch, "train")
    labels = batch["tokens"][:, 1:]
    valid = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    ce = L.chunked_cross_entropy(hidden[:, :-1, :], params["embed"], labels, valid, cfg,
                                 block=cfg.q_block)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def decode_step(params, cfg: ArchConfig, caches, tokens, positions):
    """One decode step. tokens: (B,) integer; positions: (B,) absolute
    position of the new token (0-based, meta tokens excluded). Returns
    (logits, caches); the caches are the ones passed in, updated in place."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = L.embed_tokens(params["embed"], tokens[:, None], cfg, cdt)
    if cfg.family == "audio":
        x = x + L.lookup_rows(params["dec_pos"], positions[:, None]).to(cdt)
    ctx = Ctx(cfg=cfg, dec_positions=positions + (cfg.meta_tokens or 0))
    for seg, seg_params, seg_cache in zip(build_segments(cfg), params["segments"], caches):
        x, _, _ = seg.apply(seg_params, x, ctx, "decode", cache=seg_cache)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], x, cfg)[:, 0, :], caches


def pad_cache(caches, cfg: ArchConfig, max_len: int):
    """Pad the self-attention KV leaves (named ``k``/``v``) of prefill-made
    caches along their sequence axis (-3) out to ``max_len`` plus the meta
    tokens, so decode steps can write into them. Cross-attention K/V and
    SSM states are fixed-size and pass through."""
    target = max_len + (cfg.meta_tokens or 0)

    def walk(node, name):
        if isinstance(node, torch.Tensor):
            if name in ("k", "v") and node.dim() >= 4 and node.shape[-3] < target:
                return torch.nn.functional.pad(node, (0, 0, 0, 0, 0, target - node.shape[-3]))
            return node
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return [walk(e, name) for e in node]

    return walk(caches, None)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device):
    """Zero caches matching decode_step's expectations. max_len includes the
    token about to be written (meta tokens excluded; they are added here)."""
    cdt = torch_dtype(cfg.compute_dtype)
    hd, H = cfg.resolved_head_dim, cfg.n_kv_heads
    S_cache = max_len + (cfg.meta_tokens or 0)

    def zeros(*shape, dtype=cdt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv(*lead):
        return {"k": zeros(*lead, batch, S_cache, H, hd), "v": zeros(*lead, batch, S_cache, H, hd)}

    def cross(n, n_src):
        return {"ck": zeros(n, batch, n_src, H, hd), "cv": zeros(n, batch, n_src, H, hd)}

    def ssm_state(n):
        st = SSM.init_ssm_state(cfg, n * batch, cdt, device)
        return {"conv": st.conv.view(n, batch, *st.conv.shape[1:]),
                "ssm": st.ssm.view(n, batch, *st.ssm.shape[1:])}

    caches = []
    for seg in build_segments(cfg):
        n = seg.n
        if seg.name in ("dense", "moe"):
            caches.append(kv(n))
        elif seg.name == "pairs":
            caches.append({"local": kv(n), "global": kv(n)})
        elif seg.name == "ssm":
            caches.append(ssm_state(n))
        elif seg.name.startswith(("g_", "loc_")):
            caches.append({"attn": kv(n), "ssm": ssm_state(n)})
        elif seg.name == "vlm":
            caches.append({"self": kv(n, cfg.cross_every), "cross": cross(n, cfg.n_img_tokens)})
        elif seg.name == "dec":
            caches.append({"self": kv(n), "cross": cross(n, cfg.enc_frames)})
        else:
            raise ValueError(seg.name)
    return caches
