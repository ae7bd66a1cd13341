"""Kernel-resource lint (SP2xx), ported from ``repro.analysis.kernels``:
walk each reference kernel's static TPU grid/BlockSpec geometry against
every :class:`~repro_torch.core.hardware.TPUSpec` before any launch. The
tuner's prefilter runs it, so its survivors equal the reference's; the
Hopper kernels check their own shared memory when they launch.

The kernels' ``ops.py`` modules expose ``grid_shape``/``vmem_footprint``
static helpers that mirror the ``pallas_call`` BlockSpecs exactly (pinned
by direct unit tests); this module derives each registry arch's default
kernel workloads, evaluates the helpers, and reports:

* SP201 — the double-buffered working set exceeds a device's VMEM;
* SP202 — a block choice the kernel would reject with an assert
  (non-divisible tiling after the ``min(block, dim)`` clamp);
* SP203 — a degenerate grid (zero/negative dimension: nothing launches);
* SP204 — a compute/param dtype outside the priced vocabulary (the
  decomposer and the ref/kernel pair would disagree on byte widths).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.configs.base import ArchConfig
from repro_torch.core.decomposer import COMPUTE_DTYPE_BYTES, moe_dispatch_geometry
from repro_torch.core.hardware import REGISTRY, TPUSpec
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.fused_moe import ops as moe_ops
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.scaled_mm import ops as scaled_mm_ops
from repro_torch.kernels.silu_mul import ops as silu_mul_ops

_PARAM_DTYPES = ("float32", "bfloat16", "float16")

#: kernel name -> (grid_shape, vmem_footprint) static helper pair
KERNEL_HELPERS = {
    "flash_attention": (flash_ops.grid_shape, flash_ops.vmem_footprint),
    "fused_moe": (moe_ops.grid_shape, moe_ops.vmem_footprint),
    "scaled_mm": (scaled_mm_ops.grid_shape, scaled_mm_ops.vmem_footprint),
    "rmsnorm": (rmsnorm_ops.grid_shape, rmsnorm_ops.vmem_footprint),
    "silu_mul": (silu_mul_ops.grid_shape, silu_mul_ops.vmem_footprint),
}


def kernel_workloads(
    cfg: ArchConfig, *, B: int = 2, lin: int = 512
) -> Iterator[Tuple[str, Dict[str, Any]]]:
    """The default Pallas kernel launches one prefill step of ``cfg``
    implies: ``(kernel name, helper kwargs)`` pairs with the kernels'
    default block choices. Families the arch does not use are omitted
    (pure-SSM archs launch no attention; non-MoE archs no fused_moe)."""
    T = B * lin
    if cfg.n_heads:
        yield (
            "flash_attention",
            {
                "B": B,
                "S": lin,
                "Skv": lin,
                "Hq": cfg.n_heads,
                "Hkv": cfg.n_kv_heads,
                "D": cfg.resolved_head_dim,
            },
        )
    if cfg.n_experts:
        _, _, C = moe_dispatch_geometry(
            T, cfg.n_experts, cfg.top_k, max(cfg.capacity_factor, 2.0), cfg.moe_group
        )
        yield (
            "fused_moe",
            {"E": cfg.n_experts, "C": C, "D": cfg.d_model, "F": cfg.moe_hidden},
        )
    if cfg.d_ff:  # pure-SSM archs (mamba2) have no FFN projection
        yield ("scaled_mm", {"M": T, "K": cfg.d_model, "N": cfg.d_ff})
        yield ("silu_mul", {"R": T, "d": cfg.d_ff})
    yield ("rmsnorm", {"R": T, "d": cfg.d_model})


def check_kernel_resources(
    cfg: ArchConfig,
    *,
    B: int = 2,
    lin: int = 512,
    hws: Optional[Sequence[TPUSpec]] = None,
    workloads: Optional[Sequence[Tuple[str, Dict[str, Any]]]] = None,
    block_overrides: Optional[Dict[str, Dict[str, int]]] = None,
) -> List[Diagnostic]:
    """SP201-SP204 for one arch across the hardware registry.

    ``workloads`` overrides the derived kernel set (seeded-bug tests);
    ``block_overrides`` maps kernel name -> block kwargs, so autotuning
    candidates can be linted before being launched."""
    hws = list(hws) if hws is not None else list(REGISTRY.values())
    if workloads is None:
        workloads = list(kernel_workloads(cfg, B=B, lin=lin))
    diags: List[Diagnostic] = []

    if cfg.compute_dtype not in COMPUTE_DTYPE_BYTES:
        diags.append(
            Diagnostic(
                code="SP204",
                severity="error",
                check="kernel-resource",
                message=(
                    f"compute_dtype {cfg.compute_dtype!r} is outside the priced "
                    f"vocabulary {sorted(COMPUTE_DTYPE_BYTES)} — the decomposer "
                    f"cannot size its byte streams"
                ),
                arch=cfg.name,
                where="configs:compute_dtype",
            )
        )
    if cfg.param_dtype not in _PARAM_DTYPES:
        diags.append(
            Diagnostic(
                code="SP204",
                severity="error",
                check="kernel-resource",
                message=(
                    f"param_dtype {cfg.param_dtype!r} is outside the supported "
                    f"vocabulary {_PARAM_DTYPES} — ref and kernel dtypes would diverge"
                ),
                arch=cfg.name,
                where="configs:param_dtype",
            )
        )

    dtype_bytes = COMPUTE_DTYPE_BYTES.get(cfg.compute_dtype, 2)
    for name, kwargs in workloads:
        blocks = dict((block_overrides or {}).get(name, {}))
        diags += check_blocks(
            name, kwargs, blocks, hws=hws, dtype_bytes=dtype_bytes, arch=cfg.name
        )
    return diags


def check_blocks(
    name: str,
    kwargs: Dict[str, Any],
    blocks: Optional[Dict[str, int]] = None,
    *,
    hws: Optional[Sequence[TPUSpec]] = None,
    dtype_bytes: int = 2,
    arch: str = "tuner",
) -> List[Diagnostic]:
    """SP201-SP203 geometry lint for ONE (kernel, workload, block-config)
    triple across ``hws`` — no :class:`ArchConfig` needed. This is the exact
    check the ``repro_torch.tune`` autotuner runs over every candidate before it
    is allowed to launch, so nothing the auditor would reject ever runs."""
    hws = list(hws) if hws is not None else list(REGISTRY.values())
    blocks = dict(blocks or {})
    grid_fn, vmem_fn = KERNEL_HELPERS[name]
    diags: List[Diagnostic] = []
    try:
        grid = grid_fn(**kwargs, **blocks)
    except ValueError as e:
        diags.append(
            Diagnostic(
                code="SP202",
                severity="error",
                check="kernel-resource",
                message=str(e),
                arch=arch,
                where=f"kernels/{name}:grid_shape {kwargs}",
                data={"kernel": name, "workload": kwargs, "blocks": blocks},
            )
        )
        return diags
    if any(g <= 0 for g in grid):
        diags.append(
            Diagnostic(
                code="SP203",
                severity="error",
                check="kernel-resource",
                message=f"{name} launches a degenerate grid {grid} — nothing executes",
                arch=arch,
                where=f"kernels/{name}:grid_shape {kwargs}",
                data={"kernel": name, "grid": list(grid), "workload": kwargs},
            )
        )
        return diags
    vm_kw = dict(blocks)
    if name != "scaled_mm":  # int8 kernel: operand widths are fixed
        vm_kw["dtype_bytes"] = dtype_bytes
    footprint = vmem_fn(**kwargs, **vm_kw)
    for hw in hws:
        budget = hw.vmem_mb * 2**20
        if footprint > budget:
            diags.append(
                Diagnostic(
                    code="SP201",
                    severity="error",
                    check="kernel-resource",
                    message=(
                        f"{name} working set {footprint / 2**20:.1f} MiB overflows "
                        f"{hw.name} VMEM ({hw.vmem_mb:g} MiB) with blocks "
                        f"{blocks or 'default'} — the compile would spill or abort"
                    ),
                    arch=arch,
                    where=f"kernels/{name}:vmem_footprint {kwargs} on {hw.name}",
                    data={
                        "kernel": name,
                        "hw": hw.name,
                        "footprint_bytes": footprint,
                        "vmem_bytes": int(budget),
                        "blocks": blocks,
                    },
                )
            )
    return diags
