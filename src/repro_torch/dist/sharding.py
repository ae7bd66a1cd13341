"""Sharding rule engine, ported from ``repro.dist.sharding``: axis *roles*
-> mesh axes -> PartitionSpecs.

Model code never names mesh axes directly. It annotates tensors with logical
roles (``"batch"``, ``"tp"``, ``"fsdp"``, ``"experts"``) and this module maps
roles onto whatever mesh is active, with a greedy divisibility fallback:

  * a role whose candidate mesh axes are absent from the mesh replicates;
  * a dim that a candidate axis does not divide evenly replicates (odd head
    counts like hymba's 25 on a 16-way model axis, batch=1, etc.);
  * ``"batch"`` may span several axes jointly: on the multi-pod production
    mesh it greedily takes the longest prefix of ``("pod", "data")`` whose
    product still divides the batch dim;
  * a mesh axis is consumed at most once per spec (an expert-parallel dim
    claiming ``"model"`` blocks a later ``"tp"`` dim from reusing it).

A mesh here is a ``torch.distributed`` ``DeviceMesh`` with named dims,
anything with a ``.shape`` mapping of axis name to size
(``analysis.sharding.MeshShape``) or a plain ``{axis: size}`` dict: the
rules read nothing else. Specs are this module's :class:`PartitionSpec`,
whose ``repr`` is JAX's.

**Tree layout.** The reference stacks a segment's layers, so each of its
parameter leaves is ``(n_layers, ...)`` (llama-vision's inner self layers
twice: ``(n_groups, cross_every, ...)``), and its rules pad roles over that
*stacked* ndim. The port keeps per-layer lists (``models/transformer.py``):
a list at the root of a tree or directly under its ``"segments"`` key holds
segments, and every other list is a stack of layers. ``param_pspecs``
resolves each leaf at its stacked shape, as the reference does, and drops
the stack's leading entries, which must be None (the rules never shard a
stack dim). ``stacked_view`` gives the reference's tree itself (its path
names, stacked shapes and dtype names), which is what the auditor walks.
Cache trees are stacked in both packages and map one to one.

**Execution.** On a ``DeviceMesh`` a spec becomes DTensor placements
(:func:`to_named`, the counterpart of the reference's ``NamedSharding``):
an entry naming axis ``a`` on tensor dim ``i`` puts ``Shard(i)`` at mesh
dim ``a``, every other mesh dim is ``Replicate()``. :func:`place`
distributes a tree's leaves by their specs, and under ``use_mesh`` of a
``DeviceMesh`` :func:`constrain` redistributes a DTensor to its roles'
placements (the reference's ``with_sharding_constraint``). ``use_mesh``
also treats plain tensors met by DTensor ops as replicated
(``implicit_replication``), as the reference's un-annotated arrays are.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections.abc import Mapping
from typing import Any, Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

__all__ = [
    "PartitionSpec",
    "resolve_pspec",
    "param_pspecs",
    "batch_pspecs",
    "cache_pspecs",
    "stacked_view",
    "LeafShape",
    "to_named",
    "placements",
    "place",
    "local_slice",
    "unflatten",
    "write_target",
    "device_mesh",
    "as_dtensor",
    "use_mesh",
    "active_mesh",
    "constrain",
    "mesh_degrees",
]


class PartitionSpec(tuple):
    """One tensor's sharding: per dim, None (replicated), a mesh axis name,
    or a tuple of names (sharded over their product). A one-name tuple is
    stored as the name, as JAX stores it; ``repr``/``str`` are JAX's."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _entry(e):
    if isinstance(e, (tuple, list)):
        names = tuple(str(a) for a in e)
        return names[0] if len(names) == 1 else names
    return e


# ----------------------------------------------------------------------
# role -> mesh-axis candidates
# ----------------------------------------------------------------------

# Order matters for multi-axis roles: "batch" takes the longest divisible
# prefix, so pods are the outermost data-parallel dimension.
_ROLE_AXES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tp": ("model",),
    "experts": ("model",),
    "pipe": ("pipe",),
}


def _mesh_sizes(mesh) -> dict[str, int]:
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def mesh_degrees(mesh) -> tuple[int, int]:
    """``(tp, pp)`` of a mesh under the role table: the sizes of the axes
    the ``"tp"``/``"experts"`` and ``"pipe"`` roles resolve onto
    (``"model"`` and ``"pipe"``). ``(1, 1)`` for ``mesh=None``, the degrees
    a single-process run executes at; the serving engines report them to
    trace recording and predicted admission."""
    if mesh is None:
        return (1, 1)
    sizes = _mesh_sizes(mesh)
    return int(sizes.get("model", 1)), int(sizes.get("pipe", 1))


def resolve_pspec(shape: Sequence[int], axis_roles: Sequence[Optional[str]], mesh) -> P:
    """Resolve one tensor's axis roles into a PartitionSpec on ``mesh``.

    ``axis_roles`` has one entry per dim: a role name or None (replicate).
    Role semantics (the ``_ROLE_AXES`` table):

    * ``"batch"``: data-parallel dim; may span several mesh axes jointly,
      greedily taking the longest prefix of ``("pod", "data")`` whose
      product divides the dim (pods are the outermost data dimension);
    * ``"fsdp"``: parameter-shard dim of fully-sharded data parallelism;
      maps to ``"data"`` only (never pods: FSDP gathers stay intra-pod);
    * ``"tp"``: tensor-parallel (Megatron row/column) dim on ``"model"``;
    * ``"experts"``: expert-parallel dim, also on ``"model"``: EP and TP
      share the axis, and the at-most-once rule below is what forces an
      expert-sharded weight's hidden dims to replicate. The dispatch and
      combine all-to-alls this implies are priced by
      ``core.decomposer.ep_alltoall_bytes``;
    * ``"pipe"``: pipeline-stage dim on the ``"pipe"`` axis.

    Guarantees: the returned spec is always valid to shard ``shape`` with.
    A role whose axes are absent replicates, a dim a candidate axis does
    not divide evenly replicates (greedy prefix: the first non-dividing
    axis stops a multi-axis role), and a mesh axis is consumed at most once
    per spec (first dim wins; later dims claiming the same axis replicate).
    """
    if len(shape) != len(axis_roles):
        raise ValueError(f"shape {tuple(shape)} vs roles {tuple(axis_roles)}")
    sizes = _mesh_sizes(mesh)
    used: set[str] = set()
    entries: list[Any] = []
    for dim, role in zip(shape, axis_roles):
        if role is None or role not in _ROLE_AXES:
            entries.append(None)
            continue
        picked: list[str] = []
        prod = 1
        for ax in _ROLE_AXES[role]:
            if ax not in sizes or ax in used:
                continue
            if dim % (prod * sizes[ax]) != 0:
                break  # greedy prefix: stop at the first non-dividing axis
            picked.append(ax)
            prod *= sizes[ax]
        if not picked:
            entries.append(None)
        else:
            used.update(picked)
            entries.append(picked[0] if len(picked) == 1 else tuple(picked))
    return P(*entries)


# ----------------------------------------------------------------------
# active-mesh context
# ----------------------------------------------------------------------

_local = threading.local()


def active_mesh():
    """The innermost mesh entered via :func:`use_mesh`, or None."""
    stack = getattr(_local, "mesh_stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh for :func:`constrain`. On a
    ``DeviceMesh`` plain tensors that meet DTensors inside the block count
    as replicated (positions, masks, the cache's fresh rows)."""
    stack = getattr(_local, "mesh_stack", None)
    if stack is None:
        stack = _local.mesh_stack = []
    stack.append(mesh)
    try:
        if isinstance(mesh, DeviceMesh):
            with implicit_replication():
                yield mesh
        else:
            yield mesh
    finally:
        stack.pop()


def device_mesh(mesh) -> DeviceMesh:
    """``mesh`` itself, checked to be a ``DeviceMesh`` with named dims: what
    placing a tensor needs (an axis-size mapping does not do)."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"placing a tensor needs a torch.distributed DeviceMesh; {type(mesh).__name__} "
            "holds only axis sizes (see launch.mesh.make_mesh)"
        )
    if mesh.mesh_dim_names is None:
        raise ValueError("the DeviceMesh needs mesh_dim_names (e.g. ('data', 'model'))")
    return mesh


def placements(spec: P, mesh) -> tuple:
    """One spec as DTensor placements on ``mesh``, one per mesh dim: an
    entry naming axis ``a`` on tensor dim ``i`` is ``Shard(i)`` at ``a``'s
    mesh dim; a tuple entry shards dim ``i`` over each of its axes, major
    to minor, which must be the mesh's own order; the rest replicate. A
    mesh dim of size 1 replicates: its one shard is the whole tensor (and
    DTensor's view rules refuse to squeeze a dim sharded on it)."""
    mesh = device_mesh(mesh)
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for i, e in enumerate(spec):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: {axes} is not in the mesh's axis order {tuple(names)}")
        for d in dims:
            if mesh.size(d) > 1:
                out[d] = Shard(i)
    return tuple(out)


def as_dtensor(x, mesh):
    """``x`` itself if it is a DTensor, else ``x`` as a DTensor replicated on
    ``mesh`` (what a plain tensor is under ``use_mesh``)."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def constrain(x, axis_roles: Sequence[Optional[str]]):
    """Pin ``x``'s sharding to its roles on the active mesh.

    Without an active mesh it returns ``x`` itself: no launch, no copy, no
    sync, so model code calls it unconditionally. Under a ``DeviceMesh`` it
    resolves the spec and redistributes ``x`` to its placements (a plain
    tensor counts as replicated); a DTensor already placed so passes
    through."""
    mesh = active_mesh()
    if mesh is None:
        return x
    spec = resolve_pspec(x.shape, axis_roles, mesh)
    want = placements(spec, mesh)
    x = as_dtensor(x, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def local_slice(x, dim: int) -> slice:
    """The global indices of ``x``'s dim ``dim`` that this rank holds
    (all of them for a plain tensor)."""
    if not isinstance(x, DTensor):
        return slice(0, x.shape[dim])
    # each mesh dim that shards ``dim`` splits what the earlier ones left in
    # torch.chunk's pieces (the last ones shorter or empty), as DTensor does;
    # in plain integers, so that fake tensors (the dry run's) take it too
    dim %= x.ndim
    start, size = 0, x.shape[dim]
    coord = x.device_mesh.get_coordinate()
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.ndim == dim:
            chunk = -(-size // x.device_mesh.size(m))
            lo = min(coord[m] * chunk, size)
            start, size = start + lo, min(chunk, size - lo)
    return slice(start, start + size)


def unflatten(x, dim: int, sizes: Sequence[int]):
    """``x.unflatten(dim, sizes)``. A DTensor whose ``dim`` is sharded into
    more pieces than ``sizes[0]`` splits into evenly (8 KV heads over a
    16-way ``"model"`` axis) is first gathered over the mesh dims that shard
    ``dim``: DTensor cannot view a shard apart across heads, where XLA
    reshards such a reshape by itself. A plain tensor is only unflattened."""
    if isinstance(x, DTensor):
        d, parts = dim % x.ndim, 1
        on_dim = [m for m, p in enumerate(x.placements)
                  if isinstance(p, Shard) and p.dim % x.ndim == d]
        for m in on_dim:
            parts *= x.device_mesh.size(m)
        if sizes[0] % parts:
            want = [Replicate() if m in on_dim else p for m, p in enumerate(x.placements)]
            x = x.redistribute(x.device_mesh, want)
    return x.unflatten(dim, sizes)


def write_target(dst, dim: int, *srcs):
    """Where a write along ``dim`` of ``dst`` lands on this rank, so that no
    element of ``dst`` moves: ``(dst's local tensor, the global indices of
    dim that it holds, each of srcs as the local tensor that lines up with
    it)``. Each source is laid out as ``dst`` without its dim ``dim`` (or a
    leading part of those dims) and is brought to ``dst``'s placements over
    its own dims first (dim's mesh dims replicated). A plain ``dst`` gives
    itself, all of ``dim`` and the sources as they are."""
    if not isinstance(dst, DTensor):
        return dst, slice(0, dst.shape[dim]), srcs
    mesh, nd = dst.device_mesh, dst.ndim
    local = []
    for src in srcs:
        want = []
        for p in dst.placements:
            d = p.dim % nd if isinstance(p, Shard) else dim
            if d == dim:
                want.append(Replicate())
                continue
            d = d - 1 if d > dim else d  # the same dim of src
            want.append(Shard(d) if d < src.ndim else Replicate())
        local.append(as_dtensor(src, mesh).redistribute(mesh, want).to_local())
    return dst.to_local(), local_slice(dst, dim), local


def _map_specs(fn, specs):
    if specs is None or isinstance(specs, P):
        return None if specs is None else fn(specs)
    if isinstance(specs, Mapping):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if hasattr(specs, "_fields"):  # a NamedTuple such as AdamWState
        return type(specs)(*(_map_specs(fn, v) for v in specs))
    return type(specs)(_map_specs(fn, v) for v in specs)


def to_named(specs, mesh):
    """Replace every PartitionSpec of a tree (dicts, lists, NamedTuples)
    with its placements on ``mesh`` (:func:`placements`); ``None`` leaves
    (the lazy error-feedback buffer) pass through."""
    return _map_specs(lambda s: placements(s, mesh), specs)


def place(tree, specs, mesh):
    """``distribute_tensor`` every leaf of ``tree`` by the matching spec of
    ``specs`` (``param_pspecs``, ``cache_pspecs``, ``train_state_pspecs``):
    plain dicts and lists of DTensors, each rank keeping its own shard of
    the value it holds (every rank must hold the same values, as ranks that
    drew them from one seed do; nothing is sent). A leaf that is no tensor
    (a step count) or whose spec is None passes through; a DTensor leaf is
    redistributed. ``specs`` may hold placements (:func:`to_named`)."""
    mesh = device_mesh(mesh)

    def walk(node, spec):
        if node is None or spec is None:
            return node
        if isinstance(spec, tuple) and not isinstance(node, tuple):  # a spec or placements
            if not isinstance(node, torch.Tensor):
                return node
            want = placements(spec, mesh) if isinstance(spec, P) else tuple(spec)
            if isinstance(node, DTensor):
                return node if tuple(node.placements) == want else node.redistribute(mesh, want)
            return distribute_tensor(node.detach(), mesh, list(want), src_data_rank=None)
        keys = _keys(node)
        if keys is not None:
            return {k: walk(node[k], spec[k]) for k in keys}
        if hasattr(node, "_fields"):  # a NamedTuple such as AdamWState
            return type(node)(*(walk(v, s) for v, s in zip(node, spec)))
        return [walk(v, s) for v, s in zip(node, spec)]

    return walk(tree, specs)


# ----------------------------------------------------------------------
# tree mappers
# ----------------------------------------------------------------------

# Trailing-dim roles per parameter leaf name. Leaves carry a variable number
# of leading stack dims (layer stacking; vlm groups stack twice): rules
# describe only the logical trailing dims and pad left with None.
_PARAM_RULES: dict[str, tuple] = {
    # embeddings / positional tables
    "tok": ("tp", "fsdp"),
    "head": ("fsdp", "tp"),
    "meta": (None, "fsdp"),
    "enc_pos": (None, "fsdp"),
    "dec_pos": (None, "fsdp"),
    # attention projections (column-parallel in, row-parallel out)
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    # FFN (SwiGLU)
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    "router": ("fsdp", None),
    # SSM mixers
    "in_proj": ("fsdp", "tp"),
    "out_proj": ("tp", "fsdp"),
    "conv_w": ("fsdp", None),
    "conv_b": ("fsdp",),
    # SSM per-head vectors follow the cache's head sharding
    # (cache_pspecs shards the H dim of (B, H, hd, N) states on tp)
    "A_log": ("tp",),
    "D": ("tp",),
    "dt_bias": ("tp",),
    # norm scales/biases and residual gates are elementwise over activation
    # dims that stay unsharded: replicate (the generic matrix fallback would
    # split the layer-stack dim)
    "w": (None,),
    "b": (None,),
    "q_norm": (None,),
    "k_norm": (None,),
    "norm_attn": (None,),
    "norm_ssm": (None,),
    "gate_norm": (None,),
    "gate_attn": (),
    "gate_ffn": (),
}

#: every parameter leaf name that has been explicitly audited against the
#: production mesh; the auditor's SP301 fires on a leaf name outside this
#: set, forcing a deliberate rule instead of a silent generic fallback
AUDITED_PARAM_LEAVES = frozenset(_PARAM_RULES)

# Expert-parallel variants: the stacked (E, d, f) weights shard experts on
# the model axis; the hidden dim must then stay unsharded (axis reuse).
_MOE_PARAM_RULES: dict[str, tuple] = {
    "w_gate": ("experts", "fsdp", None),
    "w_up": ("experts", "fsdp", None),
    "w_down": ("experts", None, "fsdp"),
}

# Cache leaves are stacked along a leading layer dim; roles are anchored on
# the trailing dims by leaf name.
_CACHE_RULES: dict[str, tuple] = {
    # (..., B, S, H_kv, hd): batch + head sharding, never the seq dim
    "k": ("batch", None, "tp", None),
    "v": ("batch", None, "tp", None),
    "ck": ("batch", None, "tp", None),
    "cv": ("batch", None, "tp", None),
    # (..., B, conv_dim, W)
    "conv": ("batch", None, None),
    # (..., B, H, hd, N)
    "ssm": ("batch", "tp", None, None),
}


def _path_names(path) -> list[str]:
    """The dict keys along a path of keys and list indices (indices name
    nothing, as the reference's sequence keys do not)."""
    return [str(k) for k in path if not isinstance(k, int)]


def _pad_roles(roles: tuple, ndim: int) -> Optional[tuple]:
    if ndim < len(roles):
        return None
    return (None,) * (ndim - len(roles)) + tuple(roles)


def _param_roles(path, ndim: int) -> tuple:
    names = _path_names(path)
    name = names[-1] if names else ""
    in_moe = "moe" in names[:-1] and "dense" not in names[:-1]
    if in_moe and name in _MOE_PARAM_RULES:
        roles = _pad_roles(_MOE_PARAM_RULES[name], ndim)
        if roles is not None:
            return roles
    if name in _PARAM_RULES:
        roles = _pad_roles(_PARAM_RULES[name], ndim)
        if roles is not None:
            return roles
    # generic fallback: matrices get megatron-ish (fsdp, tp) on the trailing
    # two dims; vectors/scalars (norm scales, gates, A_log, ...) replicate
    if ndim >= 2:
        return (None,) * (ndim - 2) + ("fsdp", "tp")
    return (None,) * ndim


def _cache_roles(path, ndim: int) -> tuple:
    names = _path_names(path)
    name = names[-1] if names else ""
    roles = _pad_roles(_CACHE_RULES[name], ndim) if name in _CACHE_RULES else None
    return roles if roles is not None else (None,) * ndim


def _is_leaf(node) -> bool:
    return hasattr(node, "shape") and hasattr(node, "dtype")


def _keys(node) -> Optional[list]:
    """A mapping node's keys (a dict, or the port's ``Tree``), else None."""
    if isinstance(node, Mapping):
        return list(node)
    if hasattr(node, "keys") and hasattr(node, "__getitem__") and not isinstance(node, (list, tuple)):
        return list(node.keys())
    return None


def _is_segment_list(path) -> bool:
    return tuple(path) in ((), ("segments",))


def _map_with_path(fn, tree, path=(), stack=()):
    """``fn(path, leaf, stack)`` over every leaf of a port tree (dicts,
    ``Tree``s and lists), returning plain dicts and lists of the results.
    ``path`` holds the dict keys and list indices down to the leaf;
    ``stack`` the lengths of the layer stacks above it, outermost first."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(tuple(path), tree, tuple(stack))
    keys = _keys(tree)
    if keys is not None:
        return {k: _map_with_path(fn, tree[k], (*path, k), stack) for k in keys}
    items = list(tree)
    inner = stack if _is_segment_list(path) else (*stack, len(items))
    return [_map_with_path(fn, e, (*path, i), inner) for i, e in enumerate(items)]


def _resolve_stacked(path, leaf, stack, roles_of, mesh) -> P:
    """The reference's spec for a leaf at its stacked shape, with the stack
    dims dropped; the rules never shard a stack dim, and this checks it."""
    full = (*stack, *(int(d) for d in leaf.shape))
    spec = resolve_pspec(full, roles_of(path, len(full)), mesh)
    lead, rest = tuple(spec)[: len(stack)], tuple(spec)[len(stack):]
    if any(e is not None for e in lead):
        raise ValueError(
            f"{'/'.join(_path_names(path))}: the spec {spec} shards a layer-stack dim"
        )
    return P(*rest)


def param_pspecs(params, mesh):
    """Map every parameter leaf (tensors, meta tensors or
    :class:`LeafShape`s) to a PartitionSpec over its own dims.
    Structure-preserving: per-layer lists stay lists, and each layer's spec
    is the reference's stacked spec without its stack entries."""
    return _map_with_path(
        lambda path, leaf, stack: _resolve_stacked(path, leaf, stack, _param_roles, mesh),
        params,
    )


def batch_pspecs(batch, mesh):
    """Input batches shard their leading (batch) dim; everything else
    replicates. Works for token batches and modality frontends alike."""

    def one(path, leaf, stack):
        nd = len(leaf.shape)
        if nd == 0:
            return P()
        return resolve_pspec(leaf.shape, ("batch",) + (None,) * (nd - 1), mesh)

    return _map_with_path(one, batch)


def cache_pspecs(caches, mesh):
    """PartitionSpecs for prefill/decode cache trees (KV + SSM states)."""
    return _map_with_path(
        lambda path, leaf, stack: _resolve_stacked(path, leaf, stack, _cache_roles, mesh),
        caches,
    )


# ----------------------------------------------------------------------
# the reference's stacked layout, device-free
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafShape:
    """A leaf's shape and dtype name (``"float32"``, ``"bfloat16"``, ...):
    what the reference's ``jax.ShapeDtypeStruct`` carries."""

    shape: tuple
    dtype: str


def _dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (a name passes through)."""
    return str(dtype).removeprefix("torch.")


def _prepend(view, n: int):
    if isinstance(view, LeafShape):
        return LeafShape((n, *view.shape), view.dtype)
    if isinstance(view, dict):
        return {k: _prepend(v, n) for k, v in view.items()}
    return [_prepend(v, n) for v in view]


def stacked_view(tree, _path=()):
    """The tree in the reference's layout: every layer stack collapsed into
    one subtree whose leaves gain the stack's length in front, leaves as
    :class:`LeafShape`s. Nothing is read from a leaf but its shape and
    dtype, so a tree on the meta device works. A view maps to itself."""
    if _is_leaf(tree):
        return LeafShape(tuple(int(d) for d in tree.shape), _dtype_name(tree.dtype))
    keys = _keys(tree)
    if keys is not None:
        return {k: stacked_view(tree[k], (*_path, k)) for k in keys}
    items = [stacked_view(e, (*_path, i)) for i, e in enumerate(tree)]
    if _is_segment_list(_path):
        return items
    if not items or any(v != items[0] for v in items[1:]):
        raise ValueError(f"{'/'.join(_path_names(_path)) or '<root>'}: the layers of a stack differ")
    return _prepend(items[0], len(items))
