"""Search-space derivation for the kernel autotuner, ported from
``repro.tune.space``: the port's ops entry points keep the reference's
signatures and ``block_*`` defaults, so the space is the same.

The old ``core.tuner`` searched a hard-coded ``{block_m, block_f, stages}``
space — including a ``stages`` knob no Pallas kernel in this repo accepts.
Here every knob is derived from (and validated against) the kernel's actual
``ops.py`` entry-point signature: a tunable parameter is exactly a keyword
argument named ``block_*``, and naming anything else raises
:class:`UnknownKnobError` instead of silently tuning a phantom.
"""
from __future__ import annotations

import inspect
import itertools
from typing import Any, Callable, Dict, Iterable, List, Tuple

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.fused_moe import ops as moe_ops
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.scaled_mm import ops as scaled_mm_ops
from repro_torch.kernels.silu_mul import ops as silu_mul_ops

#: kernel name -> (ops module, entry-point attribute, predictor family kind)
KERNEL_OPS: Dict[str, Tuple[Any, str, str]] = {
    "flash_attention": (flash_ops, "attention", "attention"),
    "fused_moe": (moe_ops, "fused_moe", "fused_moe"),
    "scaled_mm": (scaled_mm_ops, "scaled_mm", "scaled_mm"),
    "silu_mul": (silu_mul_ops, "act_mul", "silu_mul"),
    "rmsnorm": (rmsnorm_ops, "rmsnorm", "rmsnorm"),
}

TUNABLE_KERNELS = tuple(KERNEL_OPS)

#: the block-size lattice candidates are drawn from (per knob); the static
#: SP2xx pre-filter prunes combinations a given workload/device rejects
BLOCK_VALUES: Tuple[int, ...] = (32, 64, 128, 256, 512)


class UnknownKnobError(ValueError):
    """A search space named a knob the kernel's signature does not accept."""

    def __init__(self, kernel: str, unknown: Iterable[str], accepted: Iterable[str]):
        self.kernel = kernel
        self.unknown = sorted(unknown)
        self.accepted = sorted(accepted)
        super().__init__(
            f"kernel {kernel!r} accepts no knob(s) {self.unknown} — its ops "
            f"signature tunes exactly {self.accepted}; a knob the kernel "
            f"ignores would be searched for nothing (the old `stages` bug)"
        )


def kernel_entry(kernel: str) -> Callable[..., Any]:
    """The ops entry point of ``kernel`` (e.g. ``fused_moe.fused_moe``)."""
    mod, attr, _ = KERNEL_OPS[kernel]
    return getattr(mod, attr)


def predict_kind(kernel: str) -> str:
    """The predictor/decomposer family name of ``kernel`` (they differ only
    for flash_attention, whose family is ``attention``)."""
    return KERNEL_OPS[kernel][2]


def block_params(kernel: str) -> Dict[str, int]:
    """``{knob: default}`` straight from the kernel's ops signature —
    every keyword parameter named ``block_*``."""
    sig = inspect.signature(kernel_entry(kernel))
    return {
        name: p.default
        for name, p in sig.parameters.items()
        if name.startswith("block_") and p.default is not inspect.Parameter.empty
    }


def validate_space(kernel: str, space: Dict[str, Iterable[int]]) -> Dict[str, Tuple[int, ...]]:
    """Check every knob in ``space`` against the kernel signature; returns
    the space with value tuples, raising :class:`UnknownKnobError` on any
    knob the kernel would silently ignore."""
    accepted = block_params(kernel)
    unknown = set(space) - set(accepted)
    if unknown:
        raise UnknownKnobError(kernel, unknown, accepted)
    return {k: tuple(int(v) for v in vs) for k, vs in space.items()}


def candidate_space(kernel: str, values: Tuple[int, ...] = BLOCK_VALUES) -> Dict[str, Tuple[int, ...]]:
    """The default search space: every signature-derived knob over the
    block lattice."""
    return {name: values for name in block_params(kernel)}


def enumerate_candidates(
    kernel: str, space: Dict[str, Iterable[int]] | None = None
) -> List[Dict[str, int]]:
    """All knob-value combinations of ``space`` (default:
    :func:`candidate_space`), each validated against the ops signature."""
    sp = validate_space(kernel, dict(space) if space is not None else candidate_space(kernel))
    names = sorted(sp)
    return [dict(zip(names, combo)) for combo in itertools.product(*(sp[n] for n in names))]


# ----------------------------------------------------------------------
# workload plumbing: ops-helper kwargs <-> decomposer workload dicts
# ----------------------------------------------------------------------

#: the reference's CPU-scale default tuning workloads per kernel (override
#: with --arch / explicit dims for full-width runs)
DEFAULT_WORKLOADS: Dict[str, Dict[str, int]] = {
    "fused_moe": {"E": 8, "C": 512, "D": 256, "F": 512},
    "scaled_mm": {"M": 1024, "K": 512, "N": 512},
    "flash_attention": {"B": 2, "S": 512, "Skv": 512, "Hq": 8, "Hkv": 8, "D": 64},
    "silu_mul": {"R": 4096, "d": 1024},
    "rmsnorm": {"R": 4096, "d": 512},
}


def decomposer_workload(kernel: str, kw: Dict[str, int]) -> Dict[str, Any]:
    """Map the ops-helper kwargs (the measured kernel's shape) to the
    decomposer workload dict the predictor prices. The fused-MoE mapping
    assumes balanced routing at the gathered capacity (``M = E*C`` routed
    pairs at top-1), which is the shape the kernel actually executes."""
    if kernel == "fused_moe":
        return {
            "M": kw["E"] * kw["C"], "E": kw["E"], "topk": 1,
            "H": kw["D"], "N": kw["F"], "skew": 0.0, "seed": 0,
        }
    if kernel == "scaled_mm":
        return {"M": kw["M"], "N": kw["N"], "K": kw["K"]}
    if kernel == "flash_attention":
        return {
            "bs": kw["B"], "nkv": kw["Hkv"], "group": kw["Hq"] // kw["Hkv"],
            "hd": kw["D"], "qlen": kw["S"], "kvlen": kw["Skv"], "causal": 1,
        }
    if kernel in ("silu_mul", "rmsnorm"):
        return {"seq": kw["R"], "dim": kw["d"]}
    raise KeyError(f"unknown kernel {kernel!r}; tunable: {sorted(KERNEL_OPS)}")


def arch_workload(kernel: str, arch: str, *, B: int = 2, lin: int = 512,
                  smoke: bool = False) -> Dict[str, int]:
    """The ops-helper kwargs one prefill step of registry arch ``arch``
    implies for ``kernel`` (via the auditor's ``kernel_workloads``);
    ``smoke=True`` uses the arch's CPU-scale smoke variant."""
    from repro_torch.analysis.kernels import kernel_workloads
    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.smoke()
    for name, kw in kernel_workloads(cfg, B=B, lin=lin):
        if name == kernel:
            return dict(kw)
    raise ValueError(
        f"arch {arch!r} launches no {kernel!r} kernel (its prefill workloads: "
        f"{[n for n, _ in kernel_workloads(cfg, B=B, lin=lin)]})"
    )
