"""Model-layout ``(B, S, H, D)`` GQA attention: the Hopper kernel for CUDA
tensors, the plain version for CPU tensors. Same signature as
``repro.kernels.flash_attention.ops.attention``.

``block_q``/``block_k`` reach the kernel's launch: the q rows a CTA owns
and the keys of one online-softmax step (``kernel.last_grid ==
grid_shape(...)`` wherever the lengths divide the blocks). The kernel masks
ragged edges itself, so no length has to divide a block.

DTensors run the same call on each rank's batch and head shards
(``head_placements``, ``kernels.on_shards``). Where a mesh dim divides
neither head count, its ranks split the KV heads h ways and the query rows
r ways, as XLA splits the reference's attention (``row_split``): each rank
runs the call on its heads and its block of rows with ``q_offset`` at the
block's first row, k and v whole; their gradients sum over the row ranks.

``q_offset`` is the absolute position of q's first row, for the causal and
window masks; the keys' positions start at 0.

On CUDA tensors that autograd records, the call is a
``torch.autograd.Function``: its forward also keeps each row's log-sum-exp,
and its backward is the CUDA backward kernel
(``kernel.flash_attention_bwd_cuda``), which recomputes P from it tile by
tile. Head dims outside ``kernel.BWD_HEAD_DIMS`` raise there, with no
fallback. On CPU tensors autograd differentiates the plain version."""
from __future__ import annotations

import math
from functools import partial

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.kernels import is_dtensor, kernel_placements, needs_grad, on_shards
from repro_torch.kernels.flash_attention.kernel import (
    BWD_HEAD_DIMS,
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import attention_ref


# The reference's static helpers, copied exactly: the TPU kernel's grid and
# VMEM working set, which the tuner's SP2xx prefilter lints (analysis.kernels).
def grid_shape(
    B: int, S: int, Skv: int, Hq: int, Hkv: int, D: int,
    *, block_q: int = 128, block_k: int = 128,
) -> tuple:
    """Static ``pallas_call`` grid of :func:`attention`: ``(BKG, n_q, n_k)``
    where ``BKG = B * Hkv * (Hq // Hkv)``. Raises ``ValueError`` exactly
    where the kernel would fail its divisibility assert (after the
    ``min(block, dim)`` clamp) — the contract ``repro.analysis`` lints
    before any compile."""
    bq, bk = min(block_q, S), min(block_k, Skv)
    if S % bq or Skv % bk:
        raise ValueError(
            f"flash_attention: S={S} %% block_q={bq} or Skv={Skv} %% "
            f"block_k={bk} != 0 (non-divisible tiling)"
        )
    return (B * Hkv * (Hq // Hkv), S // bq, Skv // bk)


def vmem_footprint(
    B: int, S: int, Skv: int, Hq: int, Hkv: int, D: int,
    *, block_q: int = 128, block_k: int = 128, dtype_bytes: int = 2,
) -> int:
    """Peak VMEM bytes one grid step of :func:`attention` holds resident:
    the double-buffered in/out BlockSpec blocks (Mosaic pipelines the next
    tile's DMA while computing, so every block is resident twice) plus the
    f32 scratch accumulators ``(block_q, 1) x2 + (block_q, D)``. Mirrors
    the kernel's BlockSpecs exactly; pinned by ``tests/test_analysis.py``."""
    bq, bk = min(block_q, S), min(block_k, Skv)
    blocks = (bq * D + 2 * bk * D + bq * D) * dtype_bytes  # q, k, v, out
    scratch = (bq * 1 + bq * 1 + bq * D) * 4
    return 2 * blocks + scratch


def attention(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    block_q: int = 128,
    block_k: int = 128,
    q_offset: int = 0,
) -> torch.Tensor:
    kw = dict(causal=causal, window=window, softcap=softcap, block_q=block_q, block_k=block_k)
    if is_dtensor(q, k, v):
        pl = head_placements(q, k)
        split = row_split(q, k, pl)
        if split is not None:
            return _attention_split(q, k, v, pl, *split, q_offset=q_offset, **kw)
        return on_shards(partial(attention, q_offset=q_offset, **kw), (q, k, v), (pl, pl, pl), pl)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                             q_offset=q_offset)
    if needs_grad(q, k, v):
        if q.shape[-1] not in BWD_HEAD_DIMS:
            raise NotImplementedError(
                f"flash attention: no backward kernel for head dim {q.shape[-1]} "
                f"(it has {BWD_HEAD_DIMS}); train this model on the CPU"
            )
        return _Attention.apply(q, k, v, causal, window, softcap, block_q, block_k, q_offset)
    return flash_attention_cuda(q, k, v, q_offset=q_offset, **kw)


def head_placements(q, k) -> tuple:
    """The placements attention runs its shards at: q's batch (dim 0) and
    head (dim 2) shards, never S or D. k and v take the same ones, so a
    rank's q heads find their GQA group's kv heads on the same rank; a mesh
    dim that does not divide both head counts replicates the heads (and
    ``row_split`` may split them with the rows there)."""
    return tuple(
        Replicate() if p == Shard(2) and (q.shape[2] % n or k.shape[2] % n) else p
        for p, n in zip(kernel_placements(q, (0, 2)), q.device_mesh.shape))


def row_split(q, k, pl) -> tuple | None:
    """``(mesh dim, h, r)`` where attention at placements ``pl`` splits a
    mesh dim that replicates it: the innermost mesh dim of n > 1 ranks that
    divides neither head count, where n = h r with h dividing the KV heads
    (the largest such h) and r the query rows. Its ranks then take h groups
    of KV heads (with their query heads) and r blocks of rows, as XLA
    splits the reference's attention. None where no mesh dim qualifies, or
    where another mesh dim shards the heads: attention stays replicated."""
    mesh = q.device_mesh
    if Shard(2) in pl:
        return None
    for m in reversed(range(mesh.ndim)):
        hr = split_sizes(mesh.size(m), q.shape[1], q.shape[2], k.shape[2])
        if pl[m] == Replicate() and hr is not None:
            return m, *hr
    return None


def o_input(flat, q, k, wo):
    """The o-projection's input: :func:`attention`'s output on ``q`` and
    ``k`` flattened to (B, S, Hq D) as ``flat``. Where attention split
    itself over a mesh dim (``row_split``) whose ranks shard ``wo``'s rows,
    its output comes back replicated there; its columns are then split over
    that dim as ``wo``'s rows are, so that each rank multiplies its share
    and ``wo``'s gradient is a share, as XLA splits the reference's
    o-projection. Elsewhere ``flat`` as it is."""
    if not is_dtensor(flat, wo):
        return flat
    split = row_split(q, k, head_placements(q, k))
    if split is None or wo.placements[split[0]] != Shard(0):
        return flat
    pl = list(flat.placements)
    pl[split[0]] = Shard(2)
    return flat.redistribute(flat.device_mesh, pl)


def split_sizes(n: int, S: int, Hq: int, Hkv: int) -> tuple | None:
    """``(h, r)`` for n > 1 ranks that divide neither head count: h the
    largest divisor of n and of the KV heads whose r = n / h divides the S
    query rows; None where n divides both, or where no such h exists."""
    if n == 1 or (Hq % n == 0 and Hkv % n == 0):
        return None
    return next(((h, n // h) for h in range(math.gcd(n, Hkv), 0, -1)
                 if n % h == 0 and S % (n // h) == 0), None)


def _attention_split(q, k, v, pl, m, h, r, *, q_offset, **kw):
    """:func:`attention` with mesh dim ``m``'s ranks split h ways over KV
    head groups and r ways over query rows (``row_split``). The heads and
    rows fold into one dim of h r (group major, row block minor) that mesh
    dim ``m`` shards; k and v are repeated over the r row blocks of their
    group, so that their gradients sum over the row ranks. Rank ``c`` of
    mesh dim ``m`` runs rows ``(c % r) S / r`` onwards of group ``c // r``.
    The folds and the unfold are pinned to the replicated placements ``pl``
    on both sides, which also pins their gradients there: the views'
    backwards then never split a sharded dim into parts that its ranks do
    not divide (which DTensor refuses)."""
    mesh = q.device_mesh
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    qf = (q.reshape(B, r, S // r, h, Hq // h, D).permute(0, 3, 1, 2, 4, 5)
          .reshape(B, h * r, S // r, Hq // h, D))
    kf, vf = ((t.reshape(B, Skv, h, Hkv // h, D).permute(0, 2, 1, 3, 4).unsqueeze(2)
               .expand(B, h, r, Skv, Hkv // h, D).reshape(B, h * r, Skv, Hkv // h, D))
              for t in (k, v))
    qf, kf, vf = (t.redistribute(mesh, pl) for t in (qf, kf, vf))
    fp = tuple(Shard(1) if i == m else p for i, p in enumerate(pl))
    row0 = (mesh.get_coordinate()[m] % r) * (S // r)

    def local(ql, kl, vl):
        ql, kl, vl = (t[:, 0].contiguous() for t in (ql, kl, vl))
        return attention(ql, kl, vl, q_offset=q_offset + row0, **kw).unsqueeze(1)

    out = on_shards(local, (qf, kf, vf), (fp, fp, fp), fp).redistribute(mesh, pl)
    return (out.reshape(B, h, r, S // r, Hq // h, D).permute(0, 2, 3, 1, 4, 5)
            .reshape(B, S, Hq, D).redistribute(mesh, pl))


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, block_q, block_k, q_offset):
        out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap,
                                        block_q=block_q, block_k=block_k, return_lse=True,
                                        q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout.contiguous(), **ctx.masks)
        return dq, dk, dv, None, None, None, None, None, None
