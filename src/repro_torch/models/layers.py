"""Core layers shared by the model zoo, in PyTorch (``repro.models.layers``).

Functions over explicit parameters (dict-like: a plain dict, or the
``transformer.Tree`` module that holds a model's parameters). RMS norms,
the gated FFN's activation and prefill attention (self and cross) go
through ``repro_torch.kernels``: on a CUDA tensor they launch the Hopper
kernels, on a CPU tensor they take the plain versions. Two attentions stay
on the plain ``chunked_attention``, whose function the kernel does not
compute: decode attention (a ``kv_valid`` mask and an offset query
position) and hymba's windowed layers, whose meta-token prefix stays
visible past the window. ``layernorm``, the non-gated gelu FFN and the
cross entropies are plain PyTorch, as they are plain ``jnp`` in the
reference. On CUDA tensors that autograd records, the kernels' calls carry
their hand-written backward kernels, so training runs through them too.
"""
from __future__ import annotations

import math
import operator
from typing import Optional

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import (
    active_mesh,
    constrain,
    resolve_pspec,
    unflatten,
    write_target,
)
from repro_torch.kernels import is_dtensor, kernel_placements, on_shards
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.silu_mul import ops as silu_ops
from repro_torch.kernels.silu_mul.kernel import SERVING_BLOCK_ROWS

# ----------------------------------------------------------------------
# initialisation helpers (the reference's distributions, drawn from a
# torch.Generator: the same laws, not the same numbers as jax.random)
# ----------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, device, in_axis: int = 0):
    """Truncated normal at +-2 sigma with std ``1/sqrt(fan_in)``."""
    std = 1.0 / math.sqrt(shape[in_axis])
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device):
    """Normal with std 0.02."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return (0.02 * t.normal_(generator=gen)).to(dtype)


# ----------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return rms_ops.rmsnorm(x, weight, eps=eps)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch, in f32 inside, cast back (the reference has no kernel
    for it)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return out.to(dt)


def init_norm(cfg: ArchConfig, d: int, dtype, device):
    if cfg.norm == "layernorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device),
                "b": torch.zeros((d,), dtype=dtype, device=device)}
    return {"w": torch.zeros((d,), dtype=dtype, device=device)}  # stores (scale - 1)


def apply_norm(p, x, cfg: ArchConfig):
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"])
    return rmsnorm(x, p["w"])


# ----------------------------------------------------------------------
# rotary position embeddings (with partial-rotary support)
# ----------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float, pct: float = 1.0):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    if pct <= 0.0:
        return x
    d = x.shape[-1]
    rot = int(d * pct) // 2 * 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None, None].float() * freqs  # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < d else out


# ----------------------------------------------------------------------
# attention (chunked, GQA, sliding window, softcap)
# ----------------------------------------------------------------------

NEG_INF = -2.0e38


def _block_attend(
    qb,  # (B, bq, Hkv, G, D)
    k,  # (B, Skv, Hkv, D)
    v,
    qpos,  # (B, bq)
    kpos,  # (B, Skv)
    *,
    causal: bool,
    window: Optional[int],
    softcap: Optional[float],
    scale: float,
    kv_valid=None,  # (B, Skv) bool: cache validity
    prefix: int = 0,  # always-visible global prefix (hymba's meta tokens)
):
    """Full-row masked attention for one query block. f32 softmax."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qb.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = torch.ones(
        (qpos.shape[0], qpos.shape[1], kpos.shape[1]), dtype=torch.bool, device=s.device
    )
    if causal:
        mask = mask & (kpos[:, None, :] <= qpos[:, :, None])
    if window is not None:
        win_ok = kpos[:, None, :] > (qpos[:, :, None] - window)
        if prefix:
            win_ok |= (kpos < prefix)[:, None, :]
        mask = mask & win_ok
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    s = s.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)  # fully masked rows stay finite
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def triangular_attention(
    qg,  # (B, Sq, Hkv, G, D) grouped queries
    k,  # (B, Sq, Hkv, D)
    v,
    qpos,  # (B, Sq)
    kpos,  # (B, Sq)
    *,
    softcap: Optional[float],
    scale: float,
    q_block: int,
):
    """The reference's block-sparse causal schedule: each query block
    visits only the key blocks at or below it (nb(nb+1)/2 pairs instead of
    nb^2), with an online-softmax state per query block. The reference
    scans the static pair list; here query block i walks key blocks
    0..i in a Python loop, the same pairs in the same order for each block.

    Requires Sq == Skv, no window, prefix or validity mask."""
    B, Sq, Hkv, G, D = qg.shape
    nb, qb = Sq // q_block, q_block
    f32 = torch.float32
    outs = []
    for i in range(nb):
        qt = qg[:, i * qb:(i + 1) * qb].float()
        qp = qpos[:, i * qb:(i + 1) * qb]
        m = torch.full((B, Hkv, G, qb, 1), NEG_INF, dtype=f32, device=qg.device)
        l = torch.zeros((B, Hkv, G, qb, 1), dtype=f32, device=qg.device)
        acc = torch.zeros((B, Hkv, G, qb, D), dtype=f32, device=qg.device)
        for j in range(i + 1):
            kt, vt = k[:, j * qb:(j + 1) * qb], v[:, j * qb:(j + 1) * qb]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qt, kt.float()) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            mask = kpos[:, None, j * qb:(j + 1) * qb] <= qp[:, :, None]  # (B, qb, qb)
            s = s.masked_fill(~mask[:, None, None, :, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True)).clamp_min(-1e30)
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(dim=-1, keepdim=True)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vt.dtype), vt).float()
            acc = corr * acc + pv
            m = m_new
        outs.append(acc / l.clamp_min(1e-30))  # (B, Hkv, G, qb, D)
    out = torch.cat(outs, dim=3)  # (B, Hkv, G, Sq, D)
    return out.permute(0, 3, 1, 2, 4).to(qg.dtype)


def chunked_attention(
    q,  # (B, Sq, Hq, D)
    k,  # (B, Skv, Hkv, D)
    v,
    qpos,  # (B, Sq)
    kpos,  # (B, Skv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_block: int = 512,
    kv_valid=None,
    prefix: int = 0,
    flash_remat: bool = False,
    causal_sparse: bool = False,
):
    """Attention a query block at a time (the reference's schedules), so
    peak memory is O(bq * Skv): the triangular causal schedule where
    ``causal_sparse`` asks for it and the shape allows it; otherwise each
    block sees either the full KV row (global) or, for a causal window
    narrower than the row, a fixed-size slice of it (local: the prefix
    plus ``[qstart - window, qstart + bq)``). A query length that is not a
    whole number of blocks is padded and sliced back.

    ``flash_remat`` chooses how the reference's backward pass recomputes
    each block. The forward pass is the same either way, so it has no
    effect here: on the card, training's attention is the flash-attention
    kernel, whose backward always recomputes P from the forward's
    log-sum-exp, and layer remat (``torch.utils.checkpoint``) recomputes
    whole layers."""
    del flash_remat
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = unflatten(q, 2, (Hkv, G))

    if (causal_sparse and causal and window is None and kv_valid is None and prefix == 0
            and Sq == Skv and Sq % q_block == 0 and Sq // q_block >= 2):
        out = triangular_attention(qg, k, v, qpos, kpos, softcap=softcap, scale=scale,
                                   q_block=q_block)
        return out.reshape(B, Sq, Hq, D)

    def attend(qb, kk, vv, qp, kp, kvv):
        return _block_attend(qb, kk, vv, qp, kp, causal=causal, window=window,
                             softcap=softcap, scale=scale, kv_valid=kvv, prefix=prefix)

    if Sq <= q_block:
        return attend(qg, k, v, qpos, kpos, kv_valid).reshape(B, Sq, Hq, D)

    if Sq % q_block:  # pad to a whole number of blocks; sliced off below
        pad = q_block - Sq % q_block
        qg = torch.nn.functional.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad))
        qpos = torch.nn.functional.pad(qpos, (0, pad))
    nb = qg.shape[1] // q_block

    local = window is not None and (prefix + window + q_block) < Skv and causal
    span = (window or 0) + q_block

    def slice_kv(arr, start):
        tail = arr[:, start:start + span]
        return torch.cat([arr[:, :prefix], tail], dim=1) if prefix else tail

    outs = []
    for idx in range(nb):
        rows = slice(idx * q_block, (idx + 1) * q_block)
        qb, qp = qg[:, rows], qpos[:, rows]
        if local:
            start = min(max(idx * q_block - window, prefix), Skv - span)
            kvv = slice_kv(kv_valid, start) if kv_valid is not None else None
            outs.append(attend(qb, slice_kv(k, start), slice_kv(v, start),
                               qp, slice_kv(kpos, start), kvv))
        else:
            outs.append(attend(qb, k, v, qp, kpos, kv_valid))
    return torch.cat(outs, dim=1)[:, :Sq].reshape(B, Sq, Hq, D)


# ----------------------------------------------------------------------
# attention layer (projections + rope + cache handling)
# ----------------------------------------------------------------------


def init_attention(gen, cfg: ArchConfig, dtype, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dtype, device),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype, device),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype, device),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def _project_qkv(p, x, cfg: ArchConfig, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = unflatten(x @ p["wq"], 2, (cfg.n_heads, hd))
    k = unflatten(x @ p["wk"], 2, (cfg.n_kv_heads, hd))
    v = unflatten(x @ p["wv"], 2, (cfg.n_kv_heads, hd))
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta, cfg.rope_pct)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_pct)
    return q, k, v


def attention_layer(p, x, cfg: ArchConfig, positions, *, window: Optional[int],
                    causal: bool = True, shard_hint: Optional[bool] = None):
    """Self-attention for prefill (and whisper's encoder). Returns
    (out, (k, v)) for caching.

    ``shard_hint`` (default: ``cfg.attn_shard_hint is True``) pins k and v
    batch- and head-sharded on the active mesh, and q too where its head
    count shards, as the reference does; without a mesh the hints return
    their inputs.

    ``positions`` are 0..S-1 in every row: ``transformer.forward`` builds
    them so, hymba's meta tokens included (``[0..m) ++ base + m`` is
    ``0..m+S-1``). So the attention is the flash-attention kernel's function
    and goes to ``kernels.flash_attention.ops`` -- except on a windowed
    layer with meta tokens (hymba's local layers), whose prefix stays
    visible past the window: that is not the kernel's mask, and it takes
    the reference's plain chunked path (local slice and prefix)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    if shard_hint if shard_hint is not None else cfg.attn_shard_hint is True:
        k = constrain(k, ("batch", None, "tp", None))
        v = constrain(v, ("batch", None, "tp", None))
        mesh = active_mesh()
        if mesh is not None and resolve_pspec(q.shape, ("batch", None, "tp", None), mesh)[2] is not None:
            q = constrain(q, ("batch", None, "tp", None))
    B, S = x.shape[:2]
    if window is not None and cfg.meta_tokens:
        out = chunked_attention(
            q, k, v, positions, positions, causal=causal, window=window,
            softcap=cfg.attn_softcap, q_block=cfg.q_block, prefix=cfg.meta_tokens,
            flash_remat=cfg.flash_remat,
        )
    else:
        if positions.shape[-1] != S:
            raise ValueError(f"attention_layer: {positions.shape[-1]} positions for {S} rows")
        if cfg.meta_tokens:  # positions assembled from the prefix and the tokens' own
            torch._assert_async(
                (positions == torch.arange(S, device=positions.device)).all(),
                "attention_layer: the kernel needs positions 0..S-1 in every row",
            )
        out = fa_ops.attention(q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap)
    return out.reshape(B, S, -1) @ p["wo"], (k, v)


def write_rows(at, *pairs) -> None:
    """``cache[b, at[b]] = new[b]`` for every row ``b`` of each ``(cache,
    new)`` pair, in place. A DTensor cache (batch and head shards, never the
    sequence dim) takes the write on each rank's own shard
    (``dist.sharding.write_target``)."""
    rows = None
    for cache, new in pairs:
        if is_dtensor(cache) and any(isinstance(p, Shard) and p.dim % cache.ndim == 1
                                     for p in cache.placements):
            raise ValueError(f"write_rows: the cache's sequence dim is sharded "
                             f"({cache.placements})")
        local, _, (new, at_l) = write_target(cache, 1, new, at)
        if rows is None or rows.shape[0] != local.shape[0]:
            rows = torch.arange(local.shape[0], device=local.device)
        local[rows, at_l] = new.to(local.dtype)


def attention_decode(
    p,
    x,  # (B, 1, d)
    cfg: ArchConfig,
    cache_k,  # (B, Smax, Hkv, D)
    cache_v,
    positions,  # (B,) current absolute position of the new token
    *,
    window: Optional[int],
):
    """Single-token decode against a KV cache; returns (out, cache_k, cache_v).

    Unlike the reference, which returns updated copies, the new key and
    value are written into ``cache_k``/``cache_v`` in place (the caches are
    the returned tensors), which saves a copy of the cache a step."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, positions[:, None])
    Smax = cache_k.shape[1]
    at = positions.clamp(0, Smax - 1)  # dynamic_update_slice clamps the same way
    write_rows(at, (cache_k, k[:, 0]), (cache_v, v[:, 0]))
    kpos = torch.arange(Smax, device=x.device).expand(B, Smax)
    valid = kpos <= positions[:, None]
    out = chunked_attention(
        q, cache_k, cache_v, positions[:, None], kpos,
        causal=True, window=window, softcap=cfg.attn_softcap,
        q_block=cfg.q_block, kv_valid=valid, prefix=cfg.meta_tokens,
    )
    return out.reshape(B, 1, -1) @ p["wo"], cache_k, cache_v


def init_cross_attention(gen, cfg: ArchConfig, dtype, device):
    return init_attention(gen, cfg, dtype, device)


def cross_attention_layer(p, x, kv_src, cfg: ArchConfig):
    """Cross-attention for prefill: queries from x, keys/values from
    ``kv_src`` (no rope). Every query sees every source row (positions all
    0, not causal, no window or softcap), which is the flash-attention
    kernel's non-causal function. Returns (out, (k, v)) for caching."""
    B, S, _ = x.shape
    Skv = kv_src.shape[1]
    hd = cfg.resolved_head_dim
    q = unflatten(x @ p["wq"], 2, (cfg.n_heads, hd))
    k = unflatten(kv_src @ p["wk"], 2, (cfg.n_kv_heads, hd))
    v = unflatten(kv_src @ p["wv"], 2, (cfg.n_kv_heads, hd))
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    out = fa_ops.attention(q, k, v, causal=False)
    return out.reshape(B, S, -1) @ p["wo"], (k, v)


def cross_attention_cached(p, x, ck, cv, cfg: ArchConfig):
    """Cross-attention at decode time against the source K/V of the
    prefill, on the plain chunked path like decode self-attention."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = unflatten(x @ p["wq"], 2, (cfg.n_heads, hd))
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
    zeros = lambda n: torch.zeros((B, n), dtype=torch.long, device=x.device)
    out = chunked_attention(q, ck, cv, zeros(S), zeros(ck.shape[1]), causal=False,
                            q_block=cfg.q_block)
    return out.reshape(B, S, -1) @ p["wo"]


# ----------------------------------------------------------------------
# feed-forward
# ----------------------------------------------------------------------


def init_ffn(gen, cfg: ArchConfig, dtype, device, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act in ("silu", "geglu"):
        return {
            "w_gate": dense_init(gen, (d, f), dtype, device),
            "w_up": dense_init(gen, (d, f), dtype, device),
            "w_down": dense_init(gen, (f, d), dtype, device),
        }
    return {"w_up": dense_init(gen, (d, f), dtype, device),
            "w_down": dense_init(gen, (f, d), dtype, device)}


def ffn(p, x, cfg: ArchConfig):
    """Gated FFN: ``act(g) * u`` is the silu_mul kernel on the card (the
    reference's ``use_pallas`` path, taken unconditionally here). The
    non-gated gelu FFN (whisper) has no product to fuse and stays plain, as
    in the reference."""
    if cfg.act in ("silu", "geglu"):
        h = silu_ops.act_mul(x @ p["w_gate"], x @ p["w_up"], act=cfg.act,
                             block_rows=SERVING_BLOCK_ROWS)
    else:
        h = torch.nn.functional.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


# ----------------------------------------------------------------------
# embedding / unembedding
# ----------------------------------------------------------------------


def init_embed(gen, cfg: ArchConfig, dtype, device):
    V, d = cfg.padded_vocab, cfg.d_model
    return {
        "tok": embed_init(gen, (V, d), dtype, device),
        "head": dense_init(gen, (d, V), dtype, device),
    }


def lookup_rows(table, index):
    """``table[index]``. On a mesh each rank looks its own index rows up in
    the whole table (gathered as FSDP gathers a weight), and the table's
    gradient sums over the ranks' rows: DTensor's rules for an index with
    sharded indices fail (torch 2.11), in the backward and, on a 3-D mesh,
    in the forward."""
    if not is_dtensor(table, index):
        return table[index]
    mesh = next(t.device_mesh for t in (table, index) if is_dtensor(t))
    rows = kernel_placements(index, (0,)) if is_dtensor(index) else None
    rows = rows or (Replicate(),) * mesh.ndim
    whole = (Replicate(),) * len(rows)
    grad = tuple(Partial() if isinstance(r, Shard) else r for r in rows)
    return on_shards(operator.getitem, (table, index), (whole, rows), rows, (grad, rows))


def embed_tokens(p, tokens, cfg: ArchConfig, compute_dtype):
    x = lookup_rows(p["tok"], tokens).to(compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype)
    return x


def lm_logits(p, x, cfg: ArchConfig):
    logits = (x @ p["head"].to(x.dtype)).float()
    if cfg.final_softcap is not None:
        c = cfg.final_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _mask_padded_vocab(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Padded vocabulary slots out of the softmax: their logits to ``NEG_INF``."""
    V = logits.shape[-1]
    if V <= vocab_size:
        return logits
    keep = torch.arange(V, device=logits.device) < vocab_size
    return logits.masked_fill(~keep, NEG_INF)


class _VocabShardNLL(torch.autograd.Function):
    """Per-row ``-log p(label)`` from one rank's slice of the vocabulary
    (global ids ``offset .. offset + V_local``): the row max, the sum of
    exponentials and the label's logit are summed over ``group``, the ranks
    that hold the other slices (none without one). Padded vocab slots are
    masked out. The backward is local: ``softmax - onehot`` on the slice."""

    @staticmethod
    def forward(ctx, logits, labels, offset: int, vocab_size: int, group):
        import torch.distributed as dist

        x = logits.float()
        n = x.shape[-1]
        ids = offset + torch.arange(n, device=x.device)
        x = x.masked_fill(ids >= vocab_size, NEG_INF)
        m = x.amax(dim=-1)
        if group is not None:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(x - m[..., None])
        se = e.sum(dim=-1)
        mine = (labels >= offset) & (labels < offset + n)
        at = (labels - offset).clamp(0, n - 1).long()[..., None]
        gold = torch.gather(x, -1, at)[..., 0] * mine
        if group is not None:
            dist.all_reduce(se, group=group)
            dist.all_reduce(gold, group=group)
        ctx.save_for_backward(e / se[..., None], at, mine)
        ctx.dtype = logits.dtype
        return torch.log(se) + m - gold

    @staticmethod
    def backward(ctx, g):
        p, at, mine = ctx.saved_tensors
        grad = p * g[..., None]
        grad.scatter_add_(-1, at, -(g * mine)[..., None])
        return grad.to(ctx.dtype), None, None, None, None


def _sharded_nll_sum(logits, labels, valid, vocab_size: int):
    """``_nll_sum`` of DTensor logits whose vocabulary may be sharded (the
    ``head`` rule puts it on ``model``): each rank works on its own rows
    and vocab slice through ``kernels.on_shards`` (:class:`_VocabShardNLL`)
    and nothing gathers the logits."""
    mesh, nd = logits.device_mesh, logits.ndim
    lp = kernel_placements(logits, range(nd))
    vocab = [i for i, p in enumerate(lp) if isinstance(p, Shard) and p.dim % nd == nd - 1]
    if len(vocab) > 1:
        raise ValueError(f"the logits' vocab is sharded over {len(vocab)} mesh dims")
    rows = tuple(Replicate() if i in vocab else p for i, p in enumerate(lp))
    if vocab:
        d = vocab[0]
        step = -(-logits.shape[-1] // mesh.shape[d])  # torch.chunk's slice length
        offset, group = mesh.get_local_rank(d) * step, mesh.get_group(d)
    else:
        offset, group = 0, None

    def local(lg, lb):
        return _VocabShardNLL.apply(lg, lb, offset, vocab_size, group)

    nll = on_shards(local, (logits, labels), (lp, rows), rows)
    return (nll * valid).sum(), valid.sum()


def _nll_sum(logits, labels, valid, vocab_size: int):
    """``(sum of valid positions' -log p(label), number of valid positions)``."""
    if is_dtensor(logits):
        return _sharded_nll_sum(logits, labels, valid, vocab_size)
    logits = _mask_padded_vocab(logits, vocab_size)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return ((logz - gold) * valid).sum(), valid.sum()


def cross_entropy(logits, labels, valid, vocab_size: int):
    """Mean next-token cross entropy over valid positions. Padded vocab slots
    are masked out of the softmax."""
    tot, n = _nll_sum(logits, labels, valid, vocab_size)
    return tot / n.clamp_min(1.0)


def chunked_cross_entropy(
    x,  # (B, S, d) final hidden states (positions predicting labels)
    embed_params,
    labels,  # (B, S) integer
    valid,  # (B, S) float
    cfg: ArchConfig,
    block: int = 512,
):
    """Next-token CE without materializing the (B, S, V) logits: blocks of
    ``block`` positions, each under ``torch.utils.checkpoint``, so its
    logits are recomputed in the backward pass (the reference's
    ``jax.checkpoint`` inside a scan). Peak logits memory is ``block * V``
    a row, not ``S * V``. DTensors are not padded: their last block is
    the shorter tail, whose sums are the same."""
    B, S, d = x.shape
    if S % block and not is_dtensor(x, labels, valid):
        pad = block - S % block
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
        S += pad

    def blk(xi, li, vi):
        return _nll_sum(lm_logits(embed_params, xi, cfg), li, vi, cfg.vocab_size)

    tot, n = 0.0, 0.0
    for i in range(0, S, block):
        s, c = checkpoint(blk, x[:, i:i + block], labels[:, i:i + block],
                          valid[:, i:i + block], use_reentrant=False)
        tot, n = tot + s, n + c
    return tot / torch.clamp(torch.as_tensor(n), min=1.0)
