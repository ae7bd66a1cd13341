"""Predictor backends behind one registry (paper §IV estimator + §VI
baselines + the roofline bound + the hwsim oracle)::

    get_predictor("synperf", hw, estimator=pw)   # PipeWeave MLPs (not ported yet)
    get_predictor("roofline", hw)                # analytical ceiling
    get_predictor("linear", hw, models={...})    # fitted §VI baselines
    get_predictor("oracle", hw)                  # hwsim ("measured")

All backends share the batched path: calls are grouped per kernel family
(deduplicated by canonical workload), featurization is memoized, and the
ML backends run one vectorized forward per family. Families a backend has
no model for follow an *explicit* fallback policy — ``"error"`` (default),
``"oracle"`` or ``"roofline"`` — and every substitution is recorded in
``Estimate.fallbacks``; nothing falls back silently.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np

from repro_torch.core import hwsim
from repro_torch.core.dataset import KernelDataset
from repro_torch.core.features import overlap_window_s
from repro_torch.core.hardware import TPUSpec
from repro_torch.predict.api import CallSeq, Estimate, KernelCall, UntrainedFamilyError
from repro_torch.predict.batching import FeatureCache, group_calls
from repro_torch.predict.comm import CommRegressor


class BasePredictor:
    """Shared batched-estimation engine. Subclasses provide
    ``_family_latencies`` (vectorized per-family prediction) and may
    restrict ``families()``; everything else — grouping, featurize
    memoization, fallback policy, comm, Estimate assembly — lives here."""

    name = "base"
    #: legacy adapters have no feature analyzer; they set this False and
    #: report ``Estimate.theoretical_s = None``
    compute_theoretical = True

    def __init__(
        self,
        hw: TPUSpec | None,
        *,
        comm: CommRegressor | None = None,
        fallback: str = "error",
        cache: FeatureCache | None = None,
    ) -> None:
        if fallback not in ("error", "oracle", "roofline"):
            raise ValueError(f"fallback must be error|oracle|roofline, got {fallback!r}")
        self.hw = hw
        self.fallback = fallback
        self.cache = cache if cache is not None else FeatureCache()
        self._comm = comm

    # -- extension points -------------------------------------------------

    def families(self) -> set | None:
        """Kernel families this backend has a model for; None = any the
        decomposer understands."""
        return None

    def _family_latencies(self, kind: str, workloads: list) -> np.ndarray:
        raise NotImplementedError

    # -- comm -------------------------------------------------------------

    @property
    def comm(self) -> CommRegressor:
        """The comm half of the backend; auto-fitted on first use."""
        if self._comm is None:
            self._comm = CommRegressor().fit(self.hw)
        return self._comm

    def _comm_latency(
        self, op: str, nbytes: float, n_units: int, skew: float = 0.0
    ) -> float:
        # the alpha-beta regressor is fitted on balanced traffic; routing
        # skew stretches the exchange by the analytical hot-chip factor
        # (the same model the hwsim oracle prices natively)
        t = self.comm.predict(op, nbytes, n_units)
        if op == "all_to_all" and skew > 0.0:
            t *= hwsim.a2a_hot_ratio(skew, n_units)
        return t

    # -- batched prediction ----------------------------------------------

    def _theoretical_latencies(self, kind: str, workloads: list) -> np.ndarray:
        """Analytical (roofline) ceiling per workload, via the cache."""
        return np.asarray(
            [self.cache.featureset(kind, X, self.hw).theoretical_s for X in workloads],
            np.float64,
        )

    def _oracle_latencies(self, kind: str, workloads: list) -> np.ndarray:
        return np.asarray(
            [hwsim.simulate(kind, X, self.hw) for X in workloads], np.float64
        )

    def _fallback_latencies(self, kind: str, workloads: list) -> np.ndarray:
        if self.fallback == "error":
            raise UntrainedFamilyError(self.name, kind, self.families() or ())
        if self.fallback == "oracle":
            return self._oracle_latencies(kind, workloads)
        return self._theoretical_latencies(kind, workloads)

    def predict(self, calls: CallSeq) -> Estimate:
        return self.predict_grouped(*group_calls(calls))

    def predict_grouped(self, families: dict, comms: dict) -> Estimate:
        """Estimate pre-grouped calls (the output of ``group_calls``).
        ``SweepPredictor`` uses this to flatten+group a trace once and fan
        out only the per-hardware stages."""
        by_family: dict = {}
        fallbacks: dict = {}
        kernel_s = 0.0
        theo_s = 0.0
        n_kernel = 0.0
        supported = self.families()
        for kind, grp in families.items():
            if supported is None or kind in supported:
                lats = np.asarray(self._family_latencies(kind, grp.workloads), np.float64)
            else:
                lats = self._fallback_latencies(kind, grp.workloads)
                fallbacks[kind] = self.fallback
            w = grp.weight_array
            fam_s = float(lats @ w)
            by_family[kind] = fam_s
            kernel_s += fam_s
            n_kernel += float(w.sum())
            if self.compute_theoretical:
                theo_s += float(self._theoretical_latencies(kind, grp.workloads) @ w)
        by_comm: dict = {}
        comm_s = 0.0
        n_comm = 0.0
        for (op, nbytes, n_units, skew), w in comms.items():
            t = w * self._comm_latency(op, nbytes, n_units, skew)
            by_comm[op] = by_comm.get(op, 0.0) + t
            comm_s += t
            n_comm += w
        return Estimate(
            total_s=kernel_s + comm_s,
            kernel_s=kernel_s,
            comm_s=comm_s,
            theoretical_s=theo_s if self.compute_theoretical else None,
            by_family=by_family,
            by_comm_op=by_comm,
            n_kernel_calls=n_kernel,
            n_comm_calls=n_comm,
            fallbacks=fallbacks,
            # cross-pipeline exposed-compute window (features.overlap_window_s):
            # what Estimate.overlapped() subtracts from the comm component
            overlap_window_s=overlap_window_s(kernel_s, n_comm),
        )

    # -- scalar conveniences ----------------------------------------------

    def kernel_time(self, kind: str, X: dict) -> float:
        return self.predict([KernelCall(kind, X)]).kernel_s

    def comm_time(
        self, op: str, nbytes: float, n_units: int, skew: float = 0.0
    ) -> float:
        return self._comm_latency(op, nbytes, n_units, skew)

    def as_times(self) -> tuple:
        """Legacy ``(kernel_time, comm_time)`` lambda pair (the old
        ``oracle_times``/``predictor_times`` plumbing)."""
        return (
            lambda kind, X: self.kernel_time(kind, X),
            lambda op, nbytes, n: self.comm_time(op, nbytes, n),
        )


class SynPerfPredictor(BasePredictor):
    """The paper's hybrid predictor: cached analytical featurization + one
    vectorized per-family MLP forward, latency = theoretical / efficiency.

    Not ported yet: it needs the trained estimator (``core/estimator`` over
    ``core/nn``, ROADMAP A3). Constructing it raises instead of standing in
    another backend for it."""

    name = "synperf"

    def __init__(self, hw: TPUSpec, estimator: Any = None, **kw: Any) -> None:
        raise NotImplementedError(
            'get_predictor("synperf", hw) needs the trained PipeWeave estimator '
            "(core/estimator and core/nn), which the port has not ported yet "
            "(ROADMAP A3); use the roofline or oracle predictor"
        )


class RooflinePredictor(BasePredictor):
    """Perfect-efficiency first-order model: latency = analytical ceiling."""

    name = "roofline"

    def _family_latencies(self, kind: str, workloads: list) -> np.ndarray:
        return self._theoretical_latencies(kind, workloads)


class OraclePredictor(BasePredictor):
    """hwsim-backed 'measured' times — the ground-truth system every other
    backend is scored against. Comm always comes from the comm oracle."""

    name = "oracle"

    def _family_latencies(self, kind: str, workloads: list) -> np.ndarray:
        return self._oracle_latencies(kind, workloads)

    def _comm_latency(
        self, op: str, nbytes: float, n_units: int, skew: float = 0.0
    ) -> float:
        return hwsim.simulate_comm(op, nbytes, n_units, self.hw, skew)


class BaselinePredictor(BasePredictor):
    """Wraps the fitted §VI-A baselines (``repro_torch.core.baselines``) — one
    fitted model per kernel family — behind the batched interface by
    building a single per-family KernelDataset per predict() call."""

    name = "baseline"

    def __init__(
        self, hw: TPUSpec, models: dict | None = None, baseline: str = "", **kw: Any
    ) -> None:
        super().__init__(hw, **kw)
        if not models:
            raise TypeError(
                f"predictor {baseline or 'baseline'!r} needs fitted per-family models: "
                "get_predictor(name, hw, models={kind: BASELINES[name]().fit(ds)})"
                " — see benchmarks/common.py:get_baseline"
            )
        self.models = models
        if baseline:
            self.name = baseline

    def families(self) -> set:
        return set(self.models)

    def _family_latencies(self, kind: str, workloads: list) -> np.ndarray:
        vecs = np.stack([self.cache.vector(kind, X, self.hw) for X in workloads])
        theo = self._theoretical_latencies(kind, workloads)
        ds = KernelDataset(
            kind=kind,
            X=vecs,
            y_eff=np.ones(len(workloads), np.float32),
            theoretical_s=theo,
            actual_s=theo,
            hw_names=[self.hw.name] * len(workloads),
            workloads=list(workloads),
        )
        return np.maximum(np.asarray(self.models[kind].predict(ds), np.float64), 1e-9)


class CallableTimesPredictor(BasePredictor):
    """Adapter for the legacy two-lambda plumbing: wraps raw
    ``kernel_time(kind, X)`` / ``comm_time(op, nbytes, n)`` callables.
    Still deduplicates repeated shapes, but cannot batch model forwards or
    report the analytical ceiling (``Estimate.theoretical_s`` is None)."""

    name = "callable"
    compute_theoretical = False

    def __init__(self, kernel_time: Callable, comm_time: Callable) -> None:
        super().__init__(hw=None)
        self._kernel_time = kernel_time
        self._comm_time = comm_time

    def _family_latencies(self, kind: str, workloads: list) -> np.ndarray:
        return np.asarray([self._kernel_time(kind, X) for X in workloads], np.float64)

    def _comm_latency(
        self, op: str, nbytes: float, n_units: int, skew: float = 0.0
    ) -> float:
        # the legacy two-lambda callables predate the skew knob; balanced
        # pricing keeps the deprecation shim bit-stable
        return self._comm_time(op, nbytes, n_units)


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------


def _baseline_factory(name: str) -> Callable[..., "BaselinePredictor"]:
    def make(hw: TPUSpec, **kw: Any) -> BaselinePredictor:
        return BaselinePredictor(hw, baseline=name, **kw)

    return make


PREDICTORS = {
    "synperf": SynPerfPredictor,
    "roofline": RooflinePredictor,
    "oracle": OraclePredictor,
    "linear": _baseline_factory("linear"),
    "habitat": _baseline_factory("habitat"),
    "neusight": _baseline_factory("neusight"),
}


def get_predictor(name: str, hw: TPUSpec, **kwargs: Any) -> BasePredictor:
    """One constructor for every backend.

    Common kwargs: ``comm`` (a fitted CommRegressor; auto-fitted on ``hw``
    when omitted), ``fallback`` ("error" | "oracle" | "roofline"),
    ``cache`` (a shared FeatureCache). Backend-specific: ``estimator`` (a
    PipeWeave or pickle path) for "synperf"; ``models`` ({kind: fitted
    baseline}) for "linear"/"habitat"/"neusight".
    """
    try:
        factory = PREDICTORS[name]
    except KeyError:
        raise KeyError(
            f"unknown predictor {name!r}; registered: {sorted(PREDICTORS)}"
        ) from None
    return factory(hw, **kwargs)
