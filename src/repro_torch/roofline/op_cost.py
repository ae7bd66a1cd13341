"""The port's counterpart of compiling a step and walking its HLO
(``roofline.hlo_cost``): a cost counter over the torch program.

:class:`OpCounter` is a ``TorchDispatchMode``. While it is entered, every
aten op applied to plain tensors is recorded. An op whose arguments hold a
DTensor is not: the mode defers it to DTensor (it returns
``NotImplemented``), whose dispatch runs the op on this rank's local shards,
and those local ops, with the collectives that redistribute the shards,
come back through the mode and are recorded. So every number is per
device, as the reference's numbers from its SPMD-partitioned HLO are.
DTensor's sharding propagation runs each new op once more at its global
shape, on fake tensors, to learn the output's metadata, and some placements
work their shard offsets out on small index tensors: neither is part of the
program, so neither is recorded (the index arithmetic runs on real tensors,
which a fake mode would refuse to read).

Each distinct call (op, arguments with every tensor as its shape and dtype,
outputs) is one line of the *op ledger*, with its count: the ledger is to
the port what HLO text is to the reference. A line's cost is a function of
the line alone (:func:`line_cost`), so :func:`analyze_ledger` counts a saved
ledger exactly as the live run counted it. Per line, times its count:

* ``dot_flops``: mm, bmm, addmm, baddbmm (``matmul``, ``einsum`` and
  ``linear`` decompose into these) and the SDPA family, by
  ``torch.utils.flop_counter``'s formulas;
* ``vector_ops``: output elements of pointwise ops, input elements of
  reductions;
* ``transcendentals``: output elements of exp, log, tanh, rsqrt, erf,
  sigmoid, sin, cos and their kin (silu, gelu, softmax);
* ``hbm_bytes``: operand plus output bytes of every op that is neither a
  view nor metadata nor an allocation. This is the eager program's
  traffic, each op a round trip through device memory with no fusion: what
  the plain program moves, not what a fused one would;
* ``collectives``: operand bytes and counts of the ``_c10d_functional`` and
  ``c10d`` ops, under the reference's five kinds;
* ``unknown_ops``: ops with no rule, with their counts.

The counter also tracks the bytes that the recorded ops allocate and that
are still alive (outputs that own new storage, freed when the tensor is);
``peak_bytes`` is their peak over the run.
"""
from __future__ import annotations

import json
import sys
import weakref
from collections import Counter
from typing import Iterable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.hlo_cost import CostSummary

__all__ = ["OpCounter", "TensorDesc", "analyze_ledger", "count", "line_cost"]

# the reference's five collective kinds, by the torch op's name
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# no traffic and no work: metadata, allocation, waiting on a collective
_FREE = frozenset({
    "device", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "detach",
    "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "wait_tensor", "_has_compatible_shallow_copy_type", "resize_", "set_", "_unsafe_view",
})
# data movement: bytes only
_MOVE = frozenset({
    "_to_copy", "copy_", "clone", "cat", "stack", "index", "index_put", "index_put_",
    "_index_put_impl_", "index_select", "index_add", "index_add_", "gather", "scatter",
    "scatter_", "scatter_add", "scatter_add_", "embedding", "embedding_dense_backward",
    "slice_scatter", "select_scatter", "diagonal_scatter", "as_strided_scatter",
    "constant_pad_nd", "repeat", "roll", "flip", "fill_", "zero_", "zeros", "zeros_like",
    "ones", "ones_like", "full", "full_like", "new_zeros", "new_ones", "new_full", "arange",
    "scalar_tensor", "_unsafe_index", "_unsafe_index_put", "masked_scatter", "tril", "triu",
    "_local_scalar_dense", "split_with_sizes_copy", "unbind_copy", "view_copy",
    "_foreach_copy_", "contiguous", "one_hot", "rand", "rand_like", "randn", "randn_like",
    "uniform_", "normal_", "bernoulli_", "select_backward", "slice_backward",
})
_REDUCE = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod", "var", "var_mean",
    "std", "norm", "linalg_vector_norm", "logsumexp", "cumsum", "cumprod", "any", "all",
    "_softmax", "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "topk", "sort", "argsort", "native_layer_norm", "native_layer_norm_backward",
    "nll_loss_forward", "nll_loss_backward", "count_nonzero", "median",
})
_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "rsqrt", "sqrt", "pow",
    "sin", "cos", "tan", "sigmoid", "erf", "erfc", "erfinv", "atan", "atan2", "silu", "gelu",
    "softplus", "mish", "logit", "silu_backward", "gelu_backward", "softplus_backward",
    "_softmax", "_log_softmax", "logsumexp", "native_layer_norm",
})

# DTensor runs an op at its global shape here to learn its output's metadata
_PROPAGATION_FRAMES = frozenset({"_propagate_tensor_meta_non_cached"})
# on a CPU mesh DTensor runs an all-to-all as an all-gather and a chunk
# (gloo has none): that all-gather is recorded as the all-to-all it stands
# for, whose operand bytes are the same
_ALL_TO_ALL_FRAMES = frozenset({"shard_dim_alltoall"})
# frames between an op's Python caller and the dispatch mode
_PASS_THROUGH = ("torch/_ops.py", "torch/_tensor.py", "torch/functional.py",
                 "torch/utils/_contextlib.py", "torch/_compile.py", "torch/_dynamo/")


def _in_frame(names: frozenset, depth: int = 16) -> bool:
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_name in names:
            return True
        f = f.f_back
    return False


def _called_by_torch_distributed() -> bool:
    """Whether the Python code that called the op lies in
    ``torch.distributed``: DTensor's own index arithmetic (shard sizes and
    offsets, which some placements work out with tensors), not the
    program's work."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        if not any(p in path for p in _PASS_THROUGH):
            return "/torch/distributed/" in path
        f = f.f_back
    return False


class TensorDesc:
    """A tensor as the ledger holds it: its shape and dtype name."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype: str):
        self.shape = torch.Size(shape)
        self.dtype = dtype

    @property
    def numel(self) -> int:
        return self.shape.numel()

    @property
    def nbytes(self) -> int:
        return self.numel * getattr(torch, self.dtype).itemsize


def _encode(x):
    if isinstance(x, torch.Tensor):
        return {"t": list(x.shape), "d": str(x.dtype).removeprefix("torch.")}
    if isinstance(x, (list, tuple)):
        return [_encode(e) for e in x]
    if isinstance(x, torch.dtype):
        return {"dtype": str(x).removeprefix("torch.")}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return {"repr": str(x)}  # a device, layout, memory format: no rule reads it


def _decode(x):
    if isinstance(x, list):
        return [_decode(e) for e in x]
    if isinstance(x, dict):
        if "t" in x:
            return TensorDesc(x["t"], x["d"])
        if "dtype" in x:
            return getattr(torch, x["dtype"])
        return x["repr"]
    return x


def _descs(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, TensorDesc)]


def _resolve(name: str):
    """``"aten.mm.default"`` -> the ``OpOverload``."""
    ns, packet, overload = name.split(".")
    return getattr(getattr(getattr(torch.ops, ns), packet), overload)


def _is_view(op) -> bool:
    """The op returns an alias of an input that it does not write: a view."""
    rets = op._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _allocates(op) -> bool:
    return not any(r.alias_info is not None for r in op._schema.returns)


def line_cost(op_name: str, args, kwargs, out, as_kind: Optional[str] = None) -> CostSummary:
    """The cost of one call, from its ledger line (tensors as
    :class:`TensorDesc`); ``as_kind`` is the collective kind the line was
    recorded as, where it is not the op's own."""
    s = CostSummary()
    op = _resolve(op_name)
    ns, packet = op_name.split(".")[:2]
    inputs, outputs = _descs((args, kwargs)), _descs(out)
    if ns in _COLLECTIVE_NAMESPACES and packet in _COLLECTIVES:
        kind = as_kind or _COLLECTIVES[packet]
        s.collectives[kind]["bytes"] += sum(t.nbytes for t in inputs)
        s.collectives[kind]["count"] += 1
        return s
    if packet in _FREE or _is_view(op):
        return s
    s.hbm_bytes += sum(t.nbytes for t in inputs) + sum(t.nbytes for t in outputs)
    size = tree_map(lambda t: t.shape if isinstance(t, TensorDesc) else t, (args, kwargs, out))
    base = packet.rstrip("_")
    if op._overloadpacket in flop_registry:
        s.dot_flops += flop_registry[op._overloadpacket](*size[0], **size[1], out_val=size[2])
    elif torch.Tag.pointwise in op.tags:
        s.vector_ops += sum(t.numel for t in outputs)
        if base in _TRANSCENDENTAL:
            s.transcendentals += sum(t.numel for t in outputs)
    elif torch.Tag.reduction in op.tags or base in _REDUCE:
        s.vector_ops += inputs[0].numel if inputs else 0
        if base in _TRANSCENDENTAL:
            s.transcendentals += inputs[0].numel if inputs else 0
    elif packet not in _MOVE:
        s.unknown_ops[op_name] = 1
    return s


def _add(total: CostSummary, part: CostSummary, n: int) -> None:
    total.dot_flops += n * part.dot_flops
    total.vector_ops += n * part.vector_ops
    total.transcendentals += n * part.transcendentals
    total.hbm_bytes += n * part.hbm_bytes
    for k in _KINDS:
        total.collectives[k]["bytes"] += n * part.collectives[k]["bytes"]
        total.collectives[k]["count"] += n * part.collectives[k]["count"]
    for k, v in part.unknown_ops.items():
        total.unknown_ops[k] = total.unknown_ops.get(k, 0) + n * v


def analyze_ledger(lines: Iterable[str], causal: Optional[tuple] = None) -> CostSummary:
    """The summed cost of an op ledger (:meth:`OpCounter.ledger_lines`, one
    JSON object a line: ``n``, ``op``, ``args``, ``kwargs``, ``out`` and,
    for a collective recorded as another kind, ``as``).

    With ``causal=(S, heads)``, a line holding attention scores counts at
    the causal share ``(S + 1) / (2 S)`` of its cost, the query-key pairs a
    causal kernel visits where the plain program computes them all. Scores
    are a tensor of shape ``(..., S, S)`` whose leading dims hold a multiple
    of ``heads`` matrices (batch rows times query heads), among the line's
    arguments or outputs: so the scores, probabilities and their gradients,
    and not a ``(B, S, d)`` activation whose ``d`` happens to equal ``S``.
    The counts may then be fractional."""
    total = CostSummary()
    for line in lines:
        if not line.strip():
            continue
        rec = json.loads(line)
        args, out = _decode(rec["args"]), _decode(rec["out"])
        kwargs = {k: _decode(v) for k, v in rec["kwargs"].items()}
        part = line_cost(rec["op"], args, kwargs, out, rec.get("as"))
        n = rec["n"]
        if causal and any(_is_scores(t.shape, *causal) for t in _descs((args, kwargs, out))):
            n *= (causal[0] + 1) / (2 * causal[0])
        _add(total, part, n)
    return total


def _is_scores(shape, S: int, heads: int) -> bool:
    lead = shape[:-2].numel()
    return len(shape) >= 3 and tuple(shape[-2:]) == (S, S) and lead >= heads and lead % heads == 0


class OpCounter(TorchDispatchMode):
    """Records every aten op run on plain tensors while entered (see the
    module docstring); enter it inside a ``FakeTensorMode`` to count a
    program without running it."""

    def __init__(self):
        super().__init__()
        self.ledger: Counter = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards, which come back here
        if _in_frame(_PROPAGATION_FRAMES):
            return func(*args, **kwargs)
        if not any(issubclass(t, FakeTensor) for t in types) and _called_by_torch_distributed():
            with unset_fake_temporarily():  # index arithmetic on real tensors, not recorded
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if func.namespace != "prim":
            rec = {"op": str(func), "args": _encode(args),
                   "kwargs": {k: _encode(v) for k, v in kwargs.items()}, "out": _encode(out)}
            if _COLLECTIVES.get(func.__name__.split(".")[0]) == "all-gather" and _in_frame(
                    _ALL_TO_ALL_FRAMES):
                rec["as"] = "all-to-all"
            key = json.dumps(rec, sort_keys=True)
            self.ledger[key] += 1
            if _allocates(func):
                for t in tree_flatten(out)[0]:
                    if isinstance(t, torch.Tensor):
                        self._hold(t)
        return out

    def _hold(self, t: torch.Tensor) -> None:
        nbytes = t.numel() * t.element_size()
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(t, self._release, nbytes)

    def _release(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def ledger_lines(self) -> list[str]:
        """The op ledger: one JSON object a distinct call, with its count
        ``n``, most frequent first."""
        lines = []
        for key, n in self.ledger.most_common():
            rec = json.loads(key)
            lines.append(json.dumps({"n": n, **rec}))
        return lines

    def summary(self) -> CostSummary:
        return analyze_ledger(self.ledger_lines())


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), counter)``: run ``fn`` under a fresh
    :class:`OpCounter`."""
    counter = OpCounter()
    with counter:
        out = fn(*args, **kwargs)
    return out, counter
