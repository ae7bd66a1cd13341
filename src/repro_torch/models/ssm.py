"""Mamba-2 / SSD (state-space duality) blocks, in PyTorch (``repro.models.ssm``).

The chunked SSD algorithm: a quadratic, attention-like product inside
fixed-size chunks plus a linear recurrence over the chunk states (the
reference's ``lax.scan``, a Python loop over chunks here). Decode keeps a
recurrent (conv, ssm) state and costs O(1) a token. The reference has no
Pallas kernel in this module: the products are plain einsums in f32, and
only the gated norm goes through ``rmsnorm`` (the Triton kernel on the
card).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import is_dtensor, kernel_placements, on_shards
from repro_torch.models.layers import dense_init, rmsnorm


class SSMState(NamedTuple):
    conv: torch.Tensor  # (B, conv_dim, W-1) rolling window of recent inputs
    ssm: torch.Tensor  # (B, H, P, N) recurrent state, f32


def conv_dim(cfg: ArchConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_ssm(gen: torch.Generator, cfg: ArchConfig, dtype, device):
    """The reference's tree and laws, drawn from ``gen``: dt uniform in log
    space on [1e-3, 0.1] stored as its inverse softplus, ``A_log`` the log
    of U[1, 16]; ``A_log``, ``dt_bias`` and ``D`` in f32 whatever
    ``dtype`` is."""
    d, di = cfg.d_model, cfg.d_inner
    G, N, H, W = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.conv_width
    f32 = torch.float32
    proj_out = 2 * di + 2 * G * N + H
    in_proj = dense_init(gen, (d, proj_out), dtype, device)
    conv_w = 0.1 * torch.randn((conv_dim(cfg), W), generator=gen, device=device)
    a = 1.0 + 15.0 * torch.rand((H,), generator=gen, device=device)
    u = torch.rand((H,), generator=gen, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim(cfg),), dtype=dtype, device=device),
        "A_log": torch.log(a),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "D": torch.ones((H,), dtype=f32, device=device),
        "gate_norm": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (di, d), dtype, device),
    }


def _split_proj(cfg: ArchConfig, zxbcdt):
    di, H = cfg.d_inner, cfg.ssm_heads
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + conv_dim(cfg)]
    dt = zxbcdt[..., di + conv_dim(cfg):]
    if dt.shape[-1] != H:
        raise ValueError(f"in_proj gives {dt.shape[-1]} dt columns, expected {H}")
    return z, xBC, dt


def _split_replicated(x, dim: int, placements) -> tuple:
    """``placements`` (of ``x`` on its mesh) with each mesh dim of more than
    one rank that replicates ``x`` turned into ``Shard(dim)``, as long as
    ``x``'s length along ``dim`` divides over the ranks that shard it: work
    that every rank of that mesh dim would repeat is split over them, as
    XLA splits the reference's step."""
    mesh, size = x.device_mesh, x.shape[dim]
    ways = math.prod(mesh.size(m) for m, p in enumerate(placements) if p == Shard(dim))
    out = []
    for m, p in enumerate(placements):
        if p == Replicate() and mesh.size(m) > 1 and size % (ways * mesh.size(m)) == 0:
            p, ways = Shard(dim), ways * mesh.size(m)
        out.append(p)
    return tuple(out)


def _conv_placements(x, cdim: int, split: bool = False):
    """On a mesh, the placements a depthwise conv runs its shards at: x's
    batch (dim 0) and channel (``cdim``) shards, never its sequence or
    window dim (with ``split``, channels also over the mesh dims that
    replicate x: ``_split_replicated``); the weight ``(C, W)`` and the
    bias ``(C,)`` shard their channels with x's, and where x's batch is
    sharded their gradients are pending sums. Exact: each channel is its
    own conv."""
    xp = kernel_placements(x, (0, cdim))
    if split:
        xp = _split_replicated(x, cdim, xp)
    wp = tuple(Shard(0) if p == Shard(cdim) else Replicate() for p in xp)
    wg = tuple(Partial() if p == Shard(0) else w for p, w in zip(xp, wp))
    return xp, wp, wg


def _causal_conv(xBC, w, b):
    """Depthwise causal conv, width W. xBC: (B, L, C); w: (C, W). On a mesh,
    on each rank's batch and channel shards (``_conv_placements``)."""
    if is_dtensor(xBC, w, b):
        xp, wp, wg = _conv_placements(xBC, 2)
        return on_shards(_causal_conv, (xBC, w, b), (xp, wp, wp), xp, (xp, wg, wg))
    W = w.shape[-1]
    L = xBC.shape[1]
    pads = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(pads[:, i:i + L, :] * w[None, None, :, W - 1 - i] for i in range(W))
    return F.silu(out + b[None, None, :])


def _conv_tail(raw, W: int):
    """The conv state: the last W-1 pre-activation inputs of raw (B, L, C),
    oldest first, zeros before the first: (B, W-1, C). On a mesh, on each
    rank's batch and channel shards."""
    if is_dtensor(raw):
        xp = kernel_placements(raw, (0, 2))
        return on_shards(functools.partial(_conv_tail, W=W), (raw,), (xp,), xp)
    L = raw.shape[1]
    return F.pad(raw, (0, 0, W - 1, 0))[:, L:L + W - 1, :]


def _decode_conv(win, w, b):
    """One decode step's conv: silu(sum_w win[:, :, w] w[:, W-1-w] + b) in
    f32, win (B, C, W) with the newest input last. On a mesh, on each rank's
    batch and channel shards, the channels split over the mesh dims that
    replicate win."""
    if is_dtensor(win, w, b):
        xp, wp, _ = _conv_placements(win, 1, split=True)
        return on_shards(_decode_conv, (win, w, b), (xp, wp, wp), xp)
    conv_out = torch.einsum("bcw,cw->bc", win.float(), w.float().flip(-1))
    return F.silu(conv_out + b.float())


def _cumsum(x, dim: int):
    """``torch.cumsum`` along ``dim``. On a mesh, on each rank's shards of
    the other dims: its backward flips, and DTensor has no rule for flip."""
    if is_dtensor(x):
        pl = kernel_placements(x, tuple(d for d in range(x.ndim) if d != dim % x.ndim))
        return on_shards(functools.partial(torch.cumsum, dim=dim), (x,), (pl,), pl)
    return torch.cumsum(x, dim=dim)


def _head_placements(x, hdim: int, B, gdim: int):
    """On a mesh, the placements of a scan over heads: ``x``'s batch (dim 0)
    and head (``hdim``) shards, the heads also split over the mesh dims that
    replicate x (``_split_replicated``). Returns them with those of a
    per-head vector ``(h,)``, of ``B``/``C`` (batch, and groups where the
    head shards divide them, else replicated), and the gradients of the
    per-head vector and of ``B``/``C``: pending sums over the mesh dims where
    a rank sees part of the batch or only its heads of a replicated group."""
    run = _split_replicated(x, hdim, kernel_placements(x, (0, hdim)))
    mesh, g = x.device_mesh, B.shape[gdim]
    ways = math.prod(mesh.size(m) for m, p in enumerate(run) if p == Shard(hdim))
    vec = tuple(Shard(0) if p == Shard(hdim) else Replicate() for p in run)
    grp = tuple(p if p == Shard(0) else Shard(gdim) if p == Shard(hdim) and g % ways == 0
                else Replicate() for p in run)
    vec_grad = tuple(Partial() if p == Shard(0) else v for p, v in zip(run, vec))
    grp_grad = tuple(Partial() if p == Shard(hdim) and q == Replicate() else q
                     for p, q in zip(run, grp))
    return run, vec, grp, vec_grad, grp_grad


def _expand_groups(B, rep: int, dim: int, gidx):
    """B's groups repeated for their heads along ``dim``: without ``gidx``
    each group ``rep`` times; with it (on a rank's head shard, the global
    group of each of its heads, ``head // (h / g)``), the groups those heads
    read, out of the ones B holds: all g, or the rank's shard of them, which
    starts at a multiple of its own length."""
    if gidx is None:
        return B.repeat_interleave(rep, dim=dim)
    return B.index_select(dim, gidx % B.shape[dim])


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD scan.

    x: (b, l, h, p); dt: (b, l, h) positive; A: (h,) negative; B, C:
    (b, l, g, n). Returns y (b, l, h, p) in f32 and the final state
    (b, h, p, n). On a mesh, on each rank's batch and head shards
    (``_head_placements``): y on x's, the state on the same batch and head
    shards, as the decode cache holds it."""
    if is_dtensor(x, dt, A, B, C):
        h, g = x.shape[2], B.shape[2]
        run, vec, grp, vec_grad, grp_grad = _head_placements(x, 2, B, 2)
        rows = tuple(p if p == Shard(0) else Shard(1) if p == Shard(2) else Replicate()
                     for p in run)  # (b, l, h) and the state (b, h, p, n)
        dtp = tuple(p if p == Shard(0) else Shard(2) if p == Shard(2) else Replicate()
                    for p in run)
        gidx = torch.arange(g, device=x.device).repeat_interleave(h // g)  # each head's group
        return on_shards(functools.partial(_ssd, chunk=chunk), (x, dt, A, B, C, gidx),
                         (run, dtp, vec, grp, grp, vec), [run, rows],
                         (run, dtp, vec_grad, grp_grad, grp_grad, vec))
    return _ssd(x, dt, A, B, C, chunk=chunk)


def _ssd(x, dt, A, B, C, gidx=None, *, chunk: int):
    """``ssd_chunked`` on whole arrays, or on one rank's shards with the
    global group of each of its heads (``gidx``)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    l_orig = l
    if l % chunk:
        # zero-pad the tail: dt = 0 makes padded steps identity transitions
        # (decay exp(0) = 1, no state or output contribution)
        pad = chunk - l % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        l = l + pad
    nc, Q = l // chunk, chunk
    rep = h // g  # heads per B/C group

    f32 = torch.float32
    xdt = (x.float() * dt[..., None].float()).reshape(b, nc, Q, h, p)
    dA = (dt.float() * A.float()[None, None, :]).reshape(b, nc, Q, h)
    Bh = _expand_groups(B.float().reshape(b, nc, Q, g, n), rep, 3, gidx)  # (b, nc, Q, h, n)
    Ch = _expand_groups(C.float().reshape(b, nc, Q, g, n), rep, 3, gidx)

    cum = _cumsum(dA, 2)  # (b, nc, Q, h)

    # intra-chunk (block-diagonal) term: L[i, j] = exp(cum_i - cum_j) for
    # i >= j, the masked entries -inf before the exp
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b, nc, Qi, Qj, h)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    Lmat = torch.exp(seg.masked_fill(~causal[None, None, :, :, None], -math.inf))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh) * Lmat
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores, xdt)

    # chunk states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (b, nc, Q, h)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bh, decay_to_end, xdt)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b, nc, h)
    s = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b, nc, h, p, n)

    # state -> output
    decay_from_start = torch.exp(cum)  # (b, nc, Q, h)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, prev_states, decay_from_start)
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y[:, :l_orig], s


def _decode_state(xs, dt, A, Bm, Cm, ssm, gidx=None):
    """One decode step of the recurrence: xs (B, H, P), dt (B, H), A (H,),
    Bm and Cm (B, G, N), the state ssm (B, H, P, N) in f32. Returns the
    output read from the new state (B, H, P) and the new state. On a mesh,
    on each rank's batch and head shards (``_head_placements``, the state's
    placements first: the decode cache holds it on head shards)."""
    if is_dtensor(xs, dt, A, Bm, Cm, ssm):
        H, G = ssm.shape[1], Bm.shape[1]
        run, vec, grp, vec_grad, grp_grad = _head_placements(ssm, 1, Bm, 1)
        rows = tuple(p if p in (Shard(0), Shard(1)) else Replicate() for p in run)  # (B, H, ...)
        gidx = torch.arange(G, device=ssm.device).repeat_interleave(H // G)
        return on_shards(_decode_state, (xs, dt, A, Bm, Cm, ssm, gidx),
                         (rows, rows, vec, grp, grp, run, vec), [rows, run],
                         (rows, rows, vec_grad, grp_grad, grp_grad, run, vec))
    rep = ssm.shape[1] // Bm.shape[1]
    Bh = _expand_groups(Bm, rep, 1, gidx)  # (B, H, N)
    Ch = _expand_groups(Cm, rep, 1, gidx)
    dA = torch.exp(dt * A[None, :])  # (B, H)
    upd = (dt[:, :, None] * xs.float())[:, :, :, None] * Bh.float()[:, :, None, :]
    ssm = ssm * dA[:, :, None, None] + upd  # (B, H, P, N)
    return torch.einsum("bhpn,bhn->bhp", ssm, Ch.float()), ssm


def ssm_layer(p, x, cfg: ArchConfig):
    """The Mamba-2 mixer for train/prefill. x: (B, L, d). Returns
    (out, SSMState): the state hands prefill over to decode."""
    Bsz, L, _ = x.shape
    di, G, N, H, P = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    zxbcdt = x @ p["in_proj"]
    z, raw_xBC, dt = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv(raw_xBC, p["conv_w"], p["conv_b"])
    xs = xBC[..., :di].reshape(Bsz, L, H, P)
    Bm = xBC[..., di:di + G * N].reshape(Bsz, L, G, N)
    Cm = xBC[..., di + G * N:].reshape(Bsz, L, G, N)
    dt = _softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    y, final = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssd_chunk)
    y = y + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(Bsz, L, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["gate_norm"])
    out = y @ p["out_proj"]
    # the conv state holds the *pre-activation* last W-1 inputs, oldest first
    conv_state = _conv_tail(raw_xBC, cfg.conv_width).transpose(1, 2)  # (B, C, W-1)
    return out, SSMState(conv=conv_state.to(x.dtype).contiguous(), ssm=final)


def ssm_decode(p, x, cfg: ArchConfig, state: SSMState):
    """One-token recurrent step. x: (B, 1, d). Returns (out, new state):
    the caller writes the new state back into its cache."""
    Bsz = x.shape[0]
    di, G, N, H, P = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    zxbcdt = x[:, 0, :] @ p["in_proj"]  # (B, proj)
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    # rolling conv window; win[..., -1] is the newest input and pairs with conv_w[:, 0]
    win = torch.cat([state.conv, xBC[:, :, None]], dim=2)  # (B, C, W)
    xBC_a = _decode_conv(win, p["conv_w"], p["conv_b"]).to(x.dtype)
    xs = xBC_a[..., :di].reshape(Bsz, H, P)
    Bm = xBC_a[..., di:di + G * N].reshape(Bsz, G, N)
    Cm = xBC_a[..., di + G * N:].reshape(Bsz, G, N)
    dt = _softplus(dt.float() + p["dt_bias"][None, :])  # (B, H)
    A = -torch.exp(p["A_log"])
    y, ssm = _decode_state(xs, dt, A, Bm, Cm, state.ssm)
    y = y + p["D"][None, :, None] * xs.float()
    y = y.reshape(Bsz, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["gate_norm"])
    out = (y @ p["out_proj"])[:, None, :]
    return out, SSMState(conv=win[:, :, 1:].to(x.dtype), ssm=ssm)


def init_ssm_state(cfg: ArchConfig, batch: int, dtype, device) -> SSMState:
    return SSMState(
        conv=torch.zeros((batch, conv_dim(cfg), cfg.conv_width - 1), dtype=dtype, device=device),
        ssm=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                        dtype=torch.float32, device=device),
    )
