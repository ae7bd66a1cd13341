"""Plain PyTorch flash-attention oracle: dense masked softmax attention on
the kernel layout of ``repro.kernels.flash_attention.ref``.

``q_offset`` is the absolute position of q's first row: row i is masked
at position ``q_offset + i`` (a rank holding a block of the query rows);
the keys' positions start at 0. At 0 it is the reference's function."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(
    q: torch.Tensor,  # (BKG, S, D)
    k: torch.Tensor,  # (BK, Skv, D)
    v: torch.Tensor,
    *,
    group: int,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    _, S, D = q.shape
    Skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kx = k.repeat_interleave(group, dim=0).float()
    vx = v.repeat_interleave(group, dim=0).float()
    s = torch.einsum("bqd,bkd->bqk", q.float(), kx) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = visible_mask(S, Skv, causal, window, q_offset, q.device)
    s = s.masked_fill(~mask[None], -1.0e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bqk,bkd->bqd", p, vx).to(q.dtype)


def visible_mask(S, Skv, causal, window, q_offset, device) -> torch.Tensor:
    """``(S, Skv)``: which keys row i (at position ``q_offset + i``) sees."""
    qpos = q_offset + torch.arange(S, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  q_offset: int = 0) -> torch.Tensor:
    """The same function on the model layout: q ``(B, S, Hq, D)``, k/v
    ``(B, Skv, Hkv, D)``, through the reference's transposes."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4).reshape(B * Hkv * G, S, D)
    kf = k.permute(0, 2, 1, 3).reshape(B * Hkv, -1, D)
    vf = v.permute(0, 2, 1, 3).reshape(B * Hkv, -1, D)
    of = flash_attention_ref(qf, kf, vf, group=G, causal=causal, window=window, softcap=softcap,
                             q_offset=q_offset)
    return of.reshape(B, Hkv, G, S, D).permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D)


def lse_ref(q, k, v, *, causal=True, window=None, softcap=None, q_offset: int = 0
            ) -> torch.Tensor:
    """Each row's natural-log log-sum-exp of its masked scores, ``(B, Hq,
    S)`` f32, as the kernels' ``return_lse`` gives it: masked keys score
    -1e30, and a row that sees no key gets ``-inf``."""
    B, S, Hq, D = q.shape
    Skv, G = k.shape[1], Hq // k.shape[2]
    x = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(G, dim=2)) / math.sqrt(D)
    if softcap is not None:
        x = softcap * torch.tanh(x / softcap)
    mask = visible_mask(S, Skv, causal, window, q_offset, q.device)
    lse = torch.logsumexp(x.masked_fill(~mask, -1.0e30), dim=-1)
    return lse.masked_fill(~mask.any(dim=-1), float("-inf"))


def attention_bwd_ref(q, k, v, dout, *, causal=True, window=None, softcap=None,
                      q_offset: int = 0):
    """The backward of :func:`attention_ref` as an explicit formula, dense
    and in f32, on the model layout: ``P = softmax(masked s')``,
    ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P (dP - rowsum(P dP))`` times
    ``1 - tanh^2(s / c)`` under a softcap ``c`` and the scale, then
    ``dQ = dS K`` and ``dK = dS^T Q``; a masked pair has ``dS = 0``, and
    ``dK``/``dV`` sum over the query heads of a group. Returns
    ``(dq, dk, dv)`` in the inputs' types."""
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf, do = q.float(), dout.float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    x = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    dcap = 1.0
    if softcap is not None:
        t = torch.tanh(x / softcap)
        x, dcap = softcap * t, 1.0 - t * t
    mask = visible_mask(S, Skv, causal, window, q_offset, q.device)
    p = torch.softmax(x.masked_fill(~mask, -1.0e30), dim=-1)  # a row with no key: uniform
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True)) * dcap * scale
    ds = ds.masked_fill(~mask, 0.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(B, Skv, Hkv, G, D).sum(dim=3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do).reshape(B, Skv, Hkv, G, D).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
