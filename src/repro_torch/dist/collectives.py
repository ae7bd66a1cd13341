"""Communication-compression collectives (``repro.dist.collectives``).

int8 error-feedback (EF) gradient compression: each step quantizes
``grad + carried_error`` to int8 with a per-leaf absmax scale, and carries
the quantization residual into the next step. The residual feedback makes
the scheme unbiased in the limit: the accumulated compressed updates
converge to the true gradient sum (1-bit Adam / EF-SGD lineage), which is
what licenses shipping 4x fewer bytes through data-parallel all-reduces.

As in the reference, compress and dequantize run inside the training step,
single-process, so the numerics are faithful while the transport is left to
the caller: ``ef_compress_grads_bucketed``'s ``all_reduce`` hook receives
each bucket's dequantized leaves. :func:`group_all_reduce` is that hook over
a ``torch.distributed`` process group (the ``data`` dim of a mesh): one
launch group a bucket, the counterpart of the reference's per-bucket
``psum`` inside ``shard_map``.

Trees are dicts, lists and tuples of tensors, flattened in the reference's
order (``optim.adamw.tree_flatten``: dict keys sorted), so the same leaves
give the same bucket ledger. Rounding is half to even in both packages
(``jnp.round``, ``torch.round``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.optim.adamw import tree_flatten

__all__ = [
    "ef_compress_grads",
    "ef_compress_grads_bucketed",
    "bucket_leaves",
    "GradBucket",
    "int8_quantize",
    "int8_dequantize",
    "group_all_reduce",
]

_LEVELS = 127.0  # symmetric int8: q in [-127, 127]

#: default bucket payload cap for the overlapped path (int8 wire bytes)
DEFAULT_BUCKET_BYTES = 4 << 20


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric absmax quantization. Returns (q_int8, scale)."""
    x = x.float()
    scale = x.abs().max() / _LEVELS
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -_LEVELS, _LEVELS)
    return q.to(torch.int8), scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _err_leaves(leaves, err) -> list:
    if err is None:
        return [torch.zeros_like(g, dtype=torch.float32) for g in leaves]
    err_leaves, _ = tree_flatten(err)
    if len(err_leaves) != len(leaves):
        raise ValueError(f"err has {len(err_leaves)} leaves, grads {len(leaves)}")
    return err_leaves


def _compress(g: torch.Tensor, e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    target = g.float() + e
    deq = int8_dequantize(*int8_quantize(target))
    return deq, target - deq


def ef_compress_grads(grads: Any, err: Optional[Any]) -> Tuple[Any, Any]:
    """Error-feedback int8 compression over a gradient tree.

    ``err`` is the carried residual tree (None on the first step: zeros).
    Returns ``(dequantized_grads, new_err)``, both shaped like ``grads``
    with f32 leaves. Per leaf, ``dequantized + new_err == grads + err``
    exactly in f32 (the quantization error is deferred, never dropped), and
    ``|new_err| <= scale / 2`` for a non-degenerate scale."""
    leaves, unflatten = tree_flatten(grads)
    pairs = [_compress(g, e) for g, e in zip(leaves, _err_leaves(leaves, err))]
    return unflatten([d for d, _ in pairs]), unflatten([e for _, e in pairs])


# ----------------------------------------------------------------------
# bucketed, overlapped error-feedback all-reduces
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GradBucket:
    """One overlapped all-reduce launch in the bucket ledger: which leaf
    indices it carries (into the flattened grad tree, *reverse* leaf order:
    the order backward produces gradients), and its int8 wire payload (1
    byte per element plus one f32 scale per leaf)."""

    leaf_indices: Tuple[int, ...]
    nbytes: int


def bucket_leaves(leaves: List[Any], bucket_bytes: int) -> List[GradBucket]:
    """Partition flattened grad leaves into launch buckets of at most
    ``bucket_bytes`` int8 wire payload each (a leaf larger than the cap gets
    its own bucket), walking the leaves in reverse tree order, the order
    their gradients exist during backward. Leaves are tensors or arrays
    (anything with a ``numel()`` or a ``size``)."""
    if bucket_bytes < 1:
        raise ValueError(f"bucket_bytes must be >= 1, got {bucket_bytes}")
    buckets: List[GradBucket] = []
    cur: List[int] = []
    cur_bytes = 0
    for i in reversed(range(len(leaves))):
        leaf = leaves[i]
        n = leaf.numel() if isinstance(leaf, torch.Tensor) else leaf.size
        nbytes = int(n) + 4  # int8 payload + f32 scale
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(GradBucket(tuple(cur), cur_bytes))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(GradBucket(tuple(cur), cur_bytes))
    return buckets


def ef_compress_grads_bucketed(
    grads: Any,
    err: Optional[Any],
    *,
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
    all_reduce: Optional[Callable] = None,
) -> Tuple[Any, Any, List[GradBucket]]:
    """Bucketed, overlap-ready variant of :func:`ef_compress_grads`: the
    same per-leaf arithmetic, bit for bit, with the leaves grouped into
    launch buckets in reverse leaf order. ``all_reduce`` optionally applies
    the transport to each bucket's list of dequantized leaves and returns
    the reduced list; ``None`` leaves the transport outside. Returns
    ``(dequantized_grads, new_err, ledger)``."""
    leaves, unflatten = tree_flatten(grads)
    err_leaves = _err_leaves(leaves, err)
    ledger = bucket_leaves(leaves, bucket_bytes)
    deq_leaves: List[Any] = [None] * len(leaves)
    new_err_leaves: List[Any] = [None] * len(leaves)
    for bucket in ledger:
        bucket_deq = []
        for i in bucket.leaf_indices:
            deq, new_err_leaves[i] = _compress(leaves[i], err_leaves[i])
            bucket_deq.append(deq)
        if all_reduce is not None:
            bucket_deq = all_reduce(bucket_deq)
        for i, deq in zip(bucket.leaf_indices, bucket_deq):
            deq_leaves[i] = deq
    return unflatten(deq_leaves), unflatten(new_err_leaves), ledger


def group_all_reduce(group=None) -> Callable[[List[torch.Tensor]], List[torch.Tensor]]:
    """The ``all_reduce`` hook over a process group (None: the default
    group): a bucket is one launch group, its leaves' all-reduces issued
    together (``async_op``) and waited on together, the counterpart of the
    reference's per-bucket list ``psum``. Each leaf keeps its own
    collective: packing a bucket into one buffer would move its elements to
    other ring chunks and change their summation order, and the bucketed
    transport must stay bit-equal to compress-then-all-reduce. Every rank
    must pass the same buckets, as ranks of one data-parallel step do."""
    import torch.distributed as dist

    def reduce(leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        out = [t.clone() for t in leaves]
        works = [dist.all_reduce(t, group=group, async_op=True) for t in out]
        for w in works:
            w.wait()
        return out

    return reduce
