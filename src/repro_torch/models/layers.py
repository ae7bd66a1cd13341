"""Core layers of the dense decoder, in PyTorch (``repro.models.layers``).

Functions over explicit parameters (dict-like: a plain dict, or the
``transformer.Tree`` module that holds a model's parameters). Norms, the
FFN activation and prefill attention go through ``repro_torch.kernels``:
on a CUDA tensor they launch the Hopper kernels, on a CPU tensor they take
the plain versions. Decode attention (a ``kv_valid`` mask and an offset
query position, which the kernel does not take) stays on the plain
``chunked_attention`` here.

Not ported yet: ``layernorm``, cross attention, the triangular causal
schedule, ``flash_remat`` and the local-window slice path of
``chunked_attention`` (the global path applies the same window mask), and
the cross entropies.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
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


def init_norm(cfg: ArchConfig, d: int, dtype, device):
    if cfg.norm == "layernorm":
        raise NotImplementedError("layernorm archs are not ported yet")
    return {"w": torch.zeros((d,), dtype=dtype, device=device)}  # stores (scale - 1)


def apply_norm(p, x, cfg: ArchConfig):
    if cfg.norm == "layernorm":
        raise NotImplementedError("layernorm archs are not ported yet")
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
):
    """Full-row masked attention for one query block. f32 softmax."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qb.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = torch.ones(
        (qpos.shape[0], qpos.shape[1], kpos.shape[1]), dtype=torch.bool, device=s.device
    )
    if causal:
        mask &= kpos[:, None, :] <= qpos[:, :, None]
    if window is not None:
        mask &= kpos[:, None, :] > (qpos[:, :, None] - window)
    if kv_valid is not None:
        mask &= kv_valid[:, None, :]
    s = s.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)  # fully masked rows stay finite
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


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
):
    """Attention a query block at a time, each block against the whole KV
    row (the reference's global path), so peak memory is O(bq * Skv)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hkv, G, D)
    outs = [
        _block_attend(
            qg[:, i:i + q_block], k, v, qpos[:, i:i + q_block], kpos,
            causal=causal, window=window, softcap=softcap, scale=scale,
            kv_valid=kv_valid,
        )
        for i in range(0, Sq, q_block)
    ]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, Sq, Hq, D)


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
    q = (x @ p["wq"]).view(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"]).view(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).view(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta, cfg.rope_pct)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_pct)
    return q, k, v


def attention_layer(p, x, cfg: ArchConfig, positions, *, window: Optional[int],
                    causal: bool = True):
    """Self-attention for prefill. Returns (out, (k, v)) for caching.

    ``positions`` are 0..S-1 per row, which is what ``transformer.forward``
    passes, so the attention is exactly the flash-attention kernel's
    function and goes to ``kernels.flash_attention.ops``. (The reference
    takes its chunked path where hymba's meta tokens shift the positions;
    the port builds no model with meta tokens yet.)"""
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = fa_ops.attention(q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap)
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ p["wo"], (k, v)


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
    rows = torch.arange(B, device=x.device)
    at = positions.clamp(0, Smax - 1)  # dynamic_update_slice clamps the same way
    cache_k[rows, at] = k[:, 0]
    cache_v[rows, at] = v[:, 0]
    kpos = torch.arange(Smax, device=x.device).expand(B, Smax)
    valid = kpos <= positions[:, None]
    out = chunked_attention(
        q, cache_k, cache_v, positions[:, None], kpos,
        causal=True, window=window, softcap=cfg.attn_softcap,
        q_block=cfg.q_block, kv_valid=valid,
    )
    return out.reshape(B, 1, -1) @ p["wo"], cache_k, cache_v


# ----------------------------------------------------------------------
# feed-forward
# ----------------------------------------------------------------------


def init_ffn(gen, cfg: ArchConfig, dtype, device, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act not in ("silu", "geglu"):
        raise NotImplementedError(f"act={cfg.act!r} is not ported yet")
    return {
        "w_gate": dense_init(gen, (d, f), dtype, device),
        "w_up": dense_init(gen, (d, f), dtype, device),
        "w_down": dense_init(gen, (f, d), dtype, device),
    }


def ffn(p, x, cfg: ArchConfig):
    """Gated FFN; ``act(g) * u`` is the silu_mul kernel on the card (the
    reference's ``use_pallas`` path, taken unconditionally here)."""
    if cfg.act not in ("silu", "geglu"):
        raise NotImplementedError(f"act={cfg.act!r} is not ported yet")
    h = silu_ops.act_mul(x @ p["w_gate"], x @ p["w_up"], act=cfg.act,
                         block_rows=SERVING_BLOCK_ROWS)
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


def embed_tokens(p, tokens, cfg: ArchConfig, compute_dtype):
    x = p["tok"][tokens].to(compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype)
    return x


def lm_logits(p, x, cfg: ArchConfig):
    logits = (x @ p["head"].to(x.dtype)).float()
    if cfg.final_softcap is not None:
        c = cfg.final_softcap
        logits = c * torch.tanh(logits / c)
    return logits
