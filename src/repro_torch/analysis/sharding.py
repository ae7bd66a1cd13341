"""Device-free sharding checker (SP3xx), ported from
``repro.analysis.sharding``: validate parameter and cache PartitionSpec
trees against a mesh *shape* — no devices, no mesh object, no placement.

``dist.sharding.resolve_pspec`` only ever reads the mesh's axis sizes, so a
:class:`MeshShape` stand-in (an axis-name -> size mapping exposed as
``.shape``) lets the auditor resolve every arch's full-size parameter tree
against the 16x16 production geometry. The trees are built on
``torch.device("meta")``: no parameter is ever materialized (arctic-480b's
f32 tree alone would be about 1.9 TB), and every leaf is checked to be a
meta tensor. The checks walk ``dist.sharding.stacked_view`` of the trees,
the reference's layout (layer stacks as leading dims), so leaf paths,
shapes, dims and bytes are the reference's. Checks:

* SP301 — a param/cache leaf name outside the audited rule set (the
  frozen ``AUDITED_PARAM_LEAVES`` contract: new model families must add a
  deliberate rule, not ride the generic matrix fallback);
* SP302 — a resolved spec consuming one mesh axis twice (would shard a
  tensor onto more shards than devices);
* SP303 — a sharded dim its mesh axes do not divide (ragged shards);
* SP304 — a large parameter left fully replicated (warning: every device
  holds a full copy; legitimate for norm scales, suspicious above
  ``replicated_warn_mb``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import (
    AUDITED_PARAM_LEAVES,
    _CACHE_RULES,
    PartitionSpec as P,
    _is_leaf,
    _keys,
    _path_names,
    cache_pspecs,
    param_pspecs,
    stacked_view,
)

#: the production mesh geometry (the reference's
#: launch.mesh.make_production_mesh) as a device-free shape — the default
#: audit target
PRODUCTION_MESH_SIZES = {"data": 16, "model": 16}

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1, "int32": 4}


class MeshShape:
    """Shape-only mesh stand-in: ``resolve_pspec`` reads nothing but the
    axis sizes in ``mesh.shape``, so this audits sharding with zero devices."""

    def __init__(self, sizes: Dict[str, int]) -> None:
        self._sizes = dict(sizes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self._sizes)

    def __repr__(self) -> str:
        return f"MeshShape({self._sizes})"


def _leaf_bytes(leaf: Any) -> int:
    n = 1
    for d in leaf.shape:
        n *= int(d)
    return n * _DTYPE_BYTES.get(str(getattr(leaf, "dtype", "float32")), 4)


def _flatten(tree: Any, is_leaf, path: tuple = ()) -> List[tuple]:
    """``[(path, leaf)]`` in ``jax.tree_util``'s order: dict keys sorted,
    lists in order."""
    if is_leaf(tree):
        return [(path, tree)]
    keys = _keys(tree)
    if keys is not None:
        return [kv for k in sorted(keys) for kv in _flatten(tree[k], is_leaf, (*path, k))]
    return [kv for i, e in enumerate(tree) for kv in _flatten(e, is_leaf, (*path, i))]


def _meta_view(tree: Any, what: str) -> Any:
    """The stacked view of a tree built on the meta device, after checking
    that no leaf holds storage."""
    for path, leaf in _flatten(tree, _is_leaf):
        if not leaf.is_meta:
            raise RuntimeError(f"{what} leaf {'/'.join(_path_names(path))} is not a meta tensor")
    return stacked_view(tree)


def _spec_axes(entry: Any) -> List[str]:
    if entry is None:
        return []
    if isinstance(entry, tuple):
        return [str(a) for a in entry]
    return [str(entry)]


def _validate_tree(
    shapes: Any,
    specs: Any,
    sizes: Dict[str, int],
    *,
    cfg_name: str,
    kind: str,
    audited: frozenset,
    replicated_warn_mb: float,
) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    leaves_shapes = _flatten(shapes, _is_leaf)
    leaves_specs = [spec for _, spec in _flatten(specs, lambda x: isinstance(x, P))]
    for (path, leaf), spec in zip(leaves_shapes, leaves_specs):
        names = _path_names(path)
        name = names[-1] if names else ""
        where = f"{kind}:{'/'.join(names) or '<root>'}"
        if name not in audited:
            diags.append(
                Diagnostic(
                    code="SP301",
                    severity="error",
                    check="sharding",
                    message=(
                        f"{kind} leaf {name!r} has no audited sharding rule — add "
                        f"a deliberate rule to dist.sharding instead of riding "
                        f"the generic fallback"
                    ),
                    arch=cfg_name,
                    where=where,
                    data={"leaf": name, "shape": [int(d) for d in leaf.shape]},
                )
            )
        used: Dict[str, int] = {}
        entries = list(spec)
        for dim_i, entry in enumerate(entries):
            axes = _spec_axes(entry)
            for ax in axes:
                used[ax] = used.get(ax, 0) + 1
            prod = 1
            for ax in axes:
                prod *= sizes.get(ax, 1)
            if axes and int(leaf.shape[dim_i]) % prod != 0:
                diags.append(
                    Diagnostic(
                        code="SP303",
                        severity="error",
                        check="sharding",
                        message=(
                            f"{kind} leaf {name!r} dim {dim_i} (={leaf.shape[dim_i]}) "
                            f"is not divisible by mesh axes {axes} (x{prod}) — "
                            f"ragged shards"
                        ),
                        arch=cfg_name,
                        where=where,
                        data={"leaf": name, "dim": dim_i, "axes": axes, "prod": prod},
                    )
                )
        reused = sorted(ax for ax, n in used.items() if n > 1)
        if reused:
            diags.append(
                Diagnostic(
                    code="SP302",
                    severity="error",
                    check="sharding",
                    message=(
                        f"{kind} leaf {name!r} spec {spec} consumes mesh axis(es) "
                        f"{reused} more than once"
                    ),
                    arch=cfg_name,
                    where=where,
                    data={"leaf": name, "spec": str(spec), "reused": reused},
                )
            )
        if not any(_spec_axes(e) for e in entries):
            nbytes = _leaf_bytes(leaf)
            if nbytes > replicated_warn_mb * 2**20:
                diags.append(
                    Diagnostic(
                        code="SP304",
                        severity="warning",
                        check="sharding",
                        message=(
                            f"{kind} leaf {name!r} ({nbytes / 2**20:.1f} MiB) is fully "
                            f"replicated — every device holds a full copy"
                        ),
                        arch=cfg_name,
                        where=where,
                        data={"leaf": name, "bytes": nbytes},
                    )
                )
    return diags


def check_sharding(
    cfg: ArchConfig,
    mesh_sizes: Optional[Dict[str, int]] = None,
    *,
    param_shapes: Optional[Any] = None,
    replicated_warn_mb: float = 64.0,
    cache_batch: int = 4,
    cache_len: int = 128,
) -> List[Diagnostic]:
    """SP301-SP304 for one arch's parameter and cache trees, resolved
    against ``mesh_sizes`` (default: the 16x16 production geometry)
    entirely device-free. ``param_shapes`` overrides the meta-device tree
    (a port tree or its ``stacked_view``; seeded-bug tests inject a leaf)."""
    from repro_torch.models import transformer as T

    sizes = dict(mesh_sizes if mesh_sizes is not None else PRODUCTION_MESH_SIZES)
    mesh = MeshShape(sizes)
    meta = torch.device("meta")
    if param_shapes is None:
        param_shapes = _meta_view(
            T.init_params(cfg, torch.Generator().manual_seed(0), meta), "param"
        )
    param_shapes = stacked_view(param_shapes)
    specs = param_pspecs(param_shapes, mesh)
    diags = _validate_tree(
        param_shapes,
        specs,
        sizes,
        cfg_name=cfg.name,
        kind="param",
        audited=AUDITED_PARAM_LEAVES,
        replicated_warn_mb=replicated_warn_mb,
    )
    try:
        cache_shapes = T.init_cache(cfg, cache_batch, cache_len, meta)
    except Exception:  # encoder-decoder/exotic families without a plain cache
        cache_shapes = None
    if cache_shapes is not None:
        cache_shapes = _meta_view(cache_shapes, "cache")
        cache_specs = cache_pspecs(cache_shapes, mesh)
        diags += _validate_tree(
            cache_shapes,
            cache_specs,
            sizes,
            cfg_name=cfg.name,
            kind="cache",
            audited=frozenset(_CACHE_RULES),
            replicated_warn_mb=float("inf"),  # caches: replication is size-checked via params
        )
    return diags
