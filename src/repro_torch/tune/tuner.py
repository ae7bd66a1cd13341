"""Predictor-driven kernel autotuning (paper §VII-C, "beyond simulation"),
ported from ``repro.tune.tuner``.

The loop the paper argues the predictor is *for*: enumerate candidate block
configs (signature-derived, :mod:`repro_torch.tune.space`), drop everything the
static SP201-SP203 geometry lint would reject (nothing the auditor flags is
ever launched), rank the survivors with a :class:`~repro_torch.predict.api.Predictor`
(each candidate's blocks ride into the decomposer as workload keys, so
tiling, alignment, and working sets all respond), then spend real execution
time only on the predicted top-k — the port's Hopper kernels timed with CUDA
events on the card, or, only when the caller passes ``device="cpu"``, their
plain versions timed on the host clock (the analogue of the reference's
interpret mode).

Everything but :func:`make_inputs`, :func:`measure` and the ``device``
argument of :func:`tune` is a copy of the reference.

Two measurement substrates share the loop:

* :func:`tune` — the real kernels (``kernels/*/ops.py``), timed;
* :func:`tune_workload` — the hwsim oracle as "hardware", for the
  dataset-scale §VII-C experiment (``benchmarks/bench_perf_gap.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import hwsim
from repro_torch.core.hardware import REGISTRY, TPUSpec
from repro_torch.predict.api import KernelCall, Predictor
from repro_torch.tune.space import (
    DEFAULT_WORKLOADS,
    block_params,
    candidate_space,
    decomposer_workload,
    enumerate_candidates,
    kernel_entry,
    predict_kind,
)

__all__ = [
    "Candidate",
    "TuneReport",
    "TuneResult",
    "TunedConfigs",
    "geomean_speedup",
    "grid_steps",
    "measure",
    "pearson",
    "prefilter",
    "rank_candidates",
    "spearman",
    "tune",
    "tune_underperformers",
    "tune_workload",
]


# ----------------------------------------------------------------------
# statistics helpers
# ----------------------------------------------------------------------


def pearson(x: Sequence[float], y: Sequence[float]) -> float:
    xa, ya = np.asarray(x, float), np.asarray(y, float)
    if len(xa) < 2 or xa.std() == 0 or ya.std() == 0:
        return 0.0
    return float(np.corrcoef(xa, ya)[0, 1])


def _ranks(x: Sequence[float]) -> np.ndarray:
    a = np.asarray(x, float)
    order = np.argsort(a, kind="stable")
    r = np.empty(len(a), float)
    r[order] = np.arange(len(a), dtype=float)
    return r


def spearman(x: Sequence[float], y: Sequence[float]) -> float:
    """Rank correlation — the predicted-vs-measured ordering score."""
    if len(x) < 2:
        return 0.0
    return pearson(_ranks(x), _ranks(y))


def geomean_speedup(results: Sequence["TuneResult"]) -> float:
    if not results:
        return 1.0
    return float(np.exp(np.mean([np.log(r.speedup) for r in results])))


# ----------------------------------------------------------------------
# candidate pipeline: prefilter -> rank -> measure
# ----------------------------------------------------------------------


@dataclasses.dataclass
class Candidate:
    """One block config moving through the tuning pipeline."""

    blocks: Dict[str, int]
    predicted_s: float = float("nan")
    ceiling_s: float = float("nan")
    measured_s: Optional[float] = None
    grid_steps: Optional[int] = None

    @property
    def predicted_gap(self) -> float:
        """Predicted headroom above the analytical ceiling (>= 1)."""
        if not np.isfinite(self.ceiling_s) or self.ceiling_s <= 0:
            return float("nan")
        return self.predicted_s / self.ceiling_s


def grid_steps(kernel: str, kw: Dict[str, int], blocks: Dict[str, int]) -> int:
    """Total grid steps of the candidate (the reference's ``pallas_call``
    grid, which the port's kernels launch as ``kernel.last_grid``)."""
    from repro_torch.analysis.kernels import KERNEL_HELPERS

    grid_fn, _ = KERNEL_HELPERS[kernel]
    return int(np.prod(grid_fn(**kw, **blocks)))


def prefilter(
    kernel: str,
    kw: Dict[str, int],
    candidates: Sequence[Dict[str, int]],
    *,
    hws: Optional[Sequence[TPUSpec]] = None,
    dtype_bytes: int = 2,
) -> Tuple[List[Candidate], List[Tuple[Dict[str, int], List[Any]]]]:
    """Static SP201-SP203 lint over every candidate; returns
    ``(survivors, rejected)`` where each rejection carries its diagnostics.
    Defaults to the FULL hardware registry, so a surviving config is legal
    on every device the auditor knows — not just the tuning target."""
    from repro_torch.analysis.kernels import check_blocks

    survivors: List[Candidate] = []
    rejected: List[Tuple[Dict[str, int], List[Any]]] = []
    for blocks in candidates:
        diags = check_blocks(kernel, kw, blocks, hws=hws, dtype_bytes=dtype_bytes)
        if diags:
            rejected.append((blocks, diags))
        else:
            survivors.append(
                Candidate(blocks=dict(blocks), grid_steps=grid_steps(kernel, kw, blocks))
            )
    return survivors, rejected


def rank_candidates(
    kernel: str,
    X: Dict[str, Any],
    candidates: List[Candidate],
    predictor: Optional[Predictor],
    hw: TPUSpec,
) -> List[Candidate]:
    """Fill ``predicted_s``/``ceiling_s`` and sort ascending by predicted
    time. ``predictor=None`` ranks with the hwsim oracle directly. The sort
    is deterministic: ties break toward larger blocks (fewer grid steps,
    cheaper launch), then by the canonical block tuple."""
    kind = predict_kind(kernel)
    for c in candidates:
        Xc = {**X, **c.blocks}
        if predictor is None:
            c.predicted_s = hwsim.simulate(kind, Xc, hw)
            c.ceiling_s = float("nan")
        else:
            est = predictor.predict([KernelCall(kind, Xc)])
            c.predicted_s = est.kernel_s
            c.ceiling_s = float("nan") if est.theoretical_s is None else est.theoretical_s
    candidates.sort(
        key=lambda c: (
            c.predicted_s,
            -sum(c.blocks.values()),
            tuple(sorted(c.blocks.items())),
        )
    )
    return candidates


# ----------------------------------------------------------------------
# real-kernel measurement
# ----------------------------------------------------------------------


def _device(device: str) -> torch.device:
    """The device to measure on; ``"cuda"`` without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tune: no CUDA device; the tuner measures the kernels on the card "
            "(pass device='cpu' to time their plain versions on the host)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"tune: device must be cuda or cpu, got {device!r}")
    return dev


def make_inputs(kernel: str, kw: Dict[str, int], seed: int = 0, device: str = "cuda") -> tuple:
    """Deterministic tensors shaped for ``kernel_entry(kernel)``: the numpy
    arrays the reference draws, moved to ``device``."""
    dev = _device(device)
    rng = np.random.default_rng(seed)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    def f32(*shape: int) -> torch.Tensor:
        return put(rng.standard_normal(shape).astype(np.float32))

    if kernel == "fused_moe":
        E, C, D, F = kw["E"], kw["C"], kw["D"], kw["F"]
        return (f32(E, C, D), f32(E, D, F), f32(E, D, F), f32(E, F, D))
    if kernel == "scaled_mm":
        M, K, N = kw["M"], kw["K"], kw["N"]
        x = put(rng.integers(-127, 128, (M, K), dtype=np.int8))
        w = put(rng.integers(-127, 128, (K, N), dtype=np.int8))
        sx = put(rng.uniform(0.5, 2.0, (M,)).astype(np.float32))
        sw = put(rng.uniform(0.5, 2.0, (N,)).astype(np.float32))
        return (x, w, sx, sw)
    if kernel == "flash_attention":
        B, S, Skv = kw["B"], kw["S"], kw["Skv"]
        Hq, Hkv, D = kw["Hq"], kw["Hkv"], kw["D"]
        return (f32(B, S, Hq, D), f32(B, Skv, Hkv, D), f32(B, Skv, Hkv, D))
    if kernel == "silu_mul":
        return (f32(kw["R"], kw["d"]), f32(kw["R"], kw["d"]))
    if kernel == "rmsnorm":
        return (f32(kw["R"], kw["d"]), f32(kw["d"]))
    raise KeyError(f"unknown kernel {kernel!r}")


def measure(
    kernel: str,
    kw: Dict[str, int],
    blocks: Dict[str, int],
    *,
    args: Optional[tuple] = None,
    repeats: int = 3,
    device: str = "cuda",
) -> float:
    """Seconds of one launch of the kernel with ``blocks``: one warmup
    launch, then the minimum over ``repeats`` launches, each timed with
    CUDA events on the current stream. With ``device="cpu"`` it times the
    plain version on the host clock instead."""
    dev = _device(device)
    if args is None:
        args = make_inputs(kernel, kw, device=device)
    call = functools.partial(kernel_entry(kernel), *args, **blocks)
    best = float("inf")
    if dev.type == "cpu":
        call()  # warmup
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            call()
            best = min(best, time.perf_counter() - t0)
        return best
    with torch.cuda.device(dev):
        call()  # warmup: the first launch builds and loads the kernel's library
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(max(1, repeats)):
            start.record()
            call()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
    return best


# ----------------------------------------------------------------------
# the full loop over real kernels
# ----------------------------------------------------------------------


@dataclasses.dataclass
class TuneReport:
    """Everything one :func:`tune` run decided and observed."""

    kernel: str
    hw: str
    workload: Dict[str, int]
    default_blocks: Dict[str, int]
    n_candidates: int
    n_rejected: int
    survivors: List[Candidate]  # ranked, predicted_s filled
    measured: List[Candidate]  # the launched subset (default first)
    best: Candidate
    t_default: float
    interpret: bool  # True: the plain versions were timed on the CPU
    predictor: str

    @property
    def speedup(self) -> float:
        assert self.best.measured_s is not None
        return self.t_default / self.best.measured_s

    @property
    def rank_correlation(self) -> float:
        """Spearman between predicted and measured times over the launched
        set — the paper's 'predictor as optimization oracle' score."""
        pts = [
            (c.predicted_s, c.measured_s)
            for c in self.measured
            if c.measured_s is not None and np.isfinite(c.predicted_s)
        ]
        if len(pts) < 2:
            return 0.0
        return spearman([p for p, _ in pts], [m for _, m in pts])

    def summary(self) -> Dict[str, Any]:
        return {
            "kernel": self.kernel,
            "hw": self.hw,
            "workload": self.workload,
            "default_blocks": self.default_blocks,
            "best_blocks": self.best.blocks,
            "t_default_s": self.t_default,
            "t_best_s": self.best.measured_s,
            "speedup": self.speedup,
            "rank_correlation": self.rank_correlation,
            "n_candidates": self.n_candidates,
            "n_rejected": self.n_rejected,
            "n_measured": len(self.measured),
            "interpret": self.interpret,
            "predictor": self.predictor,
        }


def tune(
    kernel: str,
    hw: TPUSpec,
    *,
    workload: Optional[Dict[str, int]] = None,
    predictor: Optional[Predictor] = None,
    predictor_name: str = "",
    top_k: int = 4,
    repeats: int = 3,
    space: Optional[Dict[str, Sequence[int]]] = None,
    device: str = "cuda",
    measure_fn: Optional[Callable[..., float]] = None,
    dtype_bytes: int = 2,
) -> TuneReport:
    """Tune one real kernel on one workload shape.

    Enumerates the signature-derived space, prefilters via SP2xx against
    the full registry, ranks with ``predictor`` (hwsim oracle when None),
    measures the predicted top-k plus the signature-default config, and
    returns the full :class:`TuneReport`. ``measure_fn`` swaps the timing
    substrate (tests stub it to keep CI fast). ``device`` is where the
    kernels are timed: ``"cuda"`` (the default) or, only when asked for,
    ``"cpu"`` for the plain versions."""
    dev = _device(device)
    kw = dict(workload if workload is not None else DEFAULT_WORKLOADS[kernel])
    defaults = block_params(kernel)
    cands = enumerate_candidates(kernel, space)
    survivors, rejected = prefilter(kernel, kw, cands, dtype_bytes=dtype_bytes)
    if not survivors:
        raise ValueError(
            f"no {kernel} candidate survives the SP2xx prefilter on workload {kw} "
            f"({len(rejected)} rejected) — widen the space or change the shape"
        )
    X = decomposer_workload(kernel, kw)
    rank_candidates(kernel, X, survivors, predictor, hw)

    mfn = measure_fn if measure_fn is not None else measure
    args = make_inputs(kernel, kw, device=device) if measure_fn is None else None
    # default config measured first: the speedup denominator, and — when it
    # also appears among survivors — an extra rank-correlation point
    t_default = mfn(kernel, kw, defaults, args=args, repeats=repeats, device=device)
    measured: List[Candidate] = []
    for c in survivors[: max(1, top_k)]:
        c.measured_s = (
            t_default
            if c.blocks == defaults
            else mfn(kernel, kw, c.blocks, args=args, repeats=repeats, device=device)
        )
        measured.append(c)
    best = min(measured, key=lambda c: c.measured_s or float("inf"))

    return TuneReport(
        kernel=kernel,
        hw=hw.name,
        workload=kw,
        default_blocks=defaults,
        n_candidates=len(cands),
        n_rejected=len(rejected),
        survivors=survivors,
        measured=measured,
        best=best,
        t_default=t_default,
        interpret=dev.type == "cpu",
        predictor=predictor_name or (type(predictor).__name__ if predictor else "oracle"),
    )


# ----------------------------------------------------------------------
# TunedConfigs: the table serve engines / core.e2e consume
# ----------------------------------------------------------------------


@dataclasses.dataclass
class TunedConfigs:
    """Tuned block choices keyed ``hw name -> kernel family -> blocks``.

    The family key is the *predictor* kind (``attention``, not
    ``flash_attention``) so ``core.e2e.model_calls(..., tuned=...)`` can
    merge blocks into matching :class:`KernelCall` workloads directly."""

    configs: Dict[str, Dict[str, Dict[str, int]]] = dataclasses.field(default_factory=dict)

    def set(self, hw: str, kind: str, blocks: Dict[str, int]) -> None:
        self.configs.setdefault(hw, {})[kind] = {k: int(v) for k, v in blocks.items()}

    def add_report(self, report: TuneReport) -> None:
        self.set(report.hw, predict_kind(report.kernel), report.best.blocks)

    def for_hw(self, hw: str | TPUSpec) -> Dict[str, Dict[str, int]]:
        """``{kernel family: blocks}`` for one device — the ``tuned=``
        argument of ``core.e2e.model_calls`` / the serve engines."""
        name = hw.name if isinstance(hw, TPUSpec) else hw
        return {k: dict(v) for k, v in self.configs.get(name, {}).items()}

    def save(self, path: str) -> None:
        import json

        with open(path, "w") as f:
            json.dump({"tuned_configs": self.configs}, f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "TunedConfigs":
        import json

        with open(path) as f:
            payload = json.load(f)
        table = payload.get("tuned_configs", payload)
        return cls(
            configs={
                hw: {kind: {k: int(v) for k, v in blocks.items()} for kind, blocks in kinds.items()}
                for hw, kinds in table.items()
            }
        )


# ----------------------------------------------------------------------
# hwsim-substrate tuning (dataset-scale §VII-C, bench_perf_gap)
# ----------------------------------------------------------------------


@dataclasses.dataclass
class TuneResult:
    """One tuned hwsim workload (the dataset-scale experiment's unit)."""

    workload: dict
    hw: str
    t_default: float
    t_best: float
    best_config: dict
    predicted_s: Tuple[float, ...] = ()
    measured_s: Tuple[float, ...] = ()

    @property
    def speedup(self) -> float:
        return self.t_default / self.t_best

    @property
    def rank_correlation(self) -> float:
        if len(self.measured_s) < 2:
            return 0.0
        return spearman(self.predicted_s, self.measured_s)


def _moe_helper_kwargs(X: dict, blocks: Dict[str, int]) -> Dict[str, int]:
    """ops-helper kwargs for a fused-MoE *dataset* workload (decomposer X).
    Dataset rows carry no per-expert capacity, so ``C`` is set to the
    candidate's ``block_m`` — the divisibility the static lint then enforces
    is exactly the kernel's real constraint (``F % block_f``)."""
    return {
        "E": int(X["E"]),
        "C": int(blocks.get("block_m", 128)),
        "D": int(X["H"]),
        "F": int(X["N"]),
    }


def tune_workload(
    workload: dict,
    hw: TPUSpec,
    *,
    kernel: str = "fused_moe",
    predictor: Optional[Predictor] = None,
    top_k: int = 5,
    space: Optional[Dict[str, Sequence[int]]] = None,
) -> TuneResult:
    """§VII-C tuning of one hwsim dataset workload: same
    prefilter -> predictor-rank -> measure-top-k loop as :func:`tune`, with
    ``hwsim.simulate`` standing in as the hardware. ``predictor=None``
    degenerates to oracle ranking (exhaustive-equivalent, used by the
    ``core.tuner`` compatibility shim)."""
    from repro_torch.analysis.kernels import check_blocks

    kind = predict_kind(kernel)
    t_default = hwsim.simulate(kind, workload, hw)
    survivors: List[Candidate] = []
    for blocks in enumerate_candidates(kernel, space):
        kw = _moe_helper_kwargs(workload, blocks) if kernel == "fused_moe" else blocks
        if check_blocks(kernel, kw, blocks, hws=[hw]):
            continue
        survivors.append(Candidate(blocks=dict(blocks)))
    rank_candidates(kernel, workload, survivors, predictor, hw)

    best_t, best_cfg = t_default, {}
    predicted: List[float] = []
    measured: List[float] = []
    for c in survivors[: max(1, top_k)]:
        t = (
            c.predicted_s
            if predictor is None  # oracle ranking already IS the measurement
            else hwsim.simulate(kind, workload, hw, config=c.blocks)
        )
        c.measured_s = t
        predicted.append(c.predicted_s)
        measured.append(t)
        if t < best_t:
            best_t, best_cfg = t, c.blocks
    return TuneResult(
        workload=workload,
        hw=hw.name,
        t_default=t_default,
        t_best=best_t,
        best_config=best_cfg,
        predicted_s=tuple(predicted),
        measured_s=tuple(measured),
    )


def tune_underperformers(
    ds: Any,
    under_mask: np.ndarray,
    per_hw_limit: int = 40,
    *,
    predictors: Optional[Dict[str, Predictor]] = None,
    top_k: int = 5,
) -> Dict[str, List[TuneResult]]:
    """Tune up to N unique underperforming dataset configurations per
    hardware (paper Fig. 9 protocol). ``predictors`` maps hw name to the
    ranking predictor for that device (None entries = oracle ranking)."""
    out: Dict[str, List[TuneResult]] = {}
    hw_arr = np.asarray(ds.hw_names)
    for hw_name in sorted(set(ds.hw_names)):
        idxs = np.where((hw_arr == hw_name) & under_mask)[0][:per_hw_limit]
        pred = (predictors or {}).get(hw_name)
        out[hw_name] = [
            tune_workload(ds.workloads[i], REGISTRY[hw_name], predictor=pred, top_k=top_k)
            for i in idxs
        ]
    return out
