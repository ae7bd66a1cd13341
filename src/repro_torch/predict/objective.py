"""Placement objectives, ported from ``repro.predict.objective`` and held
equal to it: how a fleet router scores one hardware's
``Estimate`` for a workload.

The predict layer answers "how long does this trace take on hw X?"
(seconds); an *objective* turns that answer into a ranking criterion —
lower score is always better. Objectives are deliberately tiny, pure
functions of ``(hw, Estimate)`` plus optional workload metadata, so new
criteria (energy, queueing headroom, ...) slot in without touching the
router::

    from repro_torch.predict.objective import get_objective

    obj = get_objective("cost")                     # $ for the trace
    obj = get_objective("latency")                  # seconds
    obj = get_objective("cost_per_token")           # $ / generated token
    obj = get_objective("slo_cheapest", slo_s=0.5)  # cheapest under an SLO

Units and conventions:

  * ``Estimate`` latencies are **seconds** for the whole priced trace;
  * cost is **USD** for the trace: ``total_s / 3600 * usd_per_chip_hour *
    num_chips`` — the whole slice is billed while the workload runs, idle
    chips included (the registry's ``usd_per_chip_hour`` is the list
    price per chip);
  * ``n_tokens`` is the number of *generated* tokens the trace produced
    (``TraceRecorder.generated_tokens``; ``B * lout`` for a synthetic
    request) — prompt tokens are an input cost, not an output;
  * infeasible is not unrankable: ``feasible()`` marks SLO violations,
    and the router ranks infeasible hardware after every feasible one
    (still ordered by score) instead of dropping it from the table.

Hardware without a price (``usd_per_chip_hour is None``) makes cost-family
objectives raise ``UnpricedHardwareError``; ``FleetRouter`` converts that
into a skip-with-warning so one unpriced registry entry cannot abort a
fleet-wide routing pass.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Union

from repro_torch.core.hardware import TPUSpec
from repro_torch.predict.api import Estimate


class UnpricedHardwareError(ValueError):
    """A cost objective was asked about hardware with no
    ``usd_per_chip_hour``. ``FleetRouter`` catches this and skips the
    entry with a warning instead of aborting the sweep."""

    def __init__(self, hw_name: str, objective: str) -> None:
        self.hw_name = hw_name
        self.objective = objective
        super().__init__(
            f"objective {objective!r} needs a price but hardware {hw_name!r} "
            "has usd_per_chip_hour=None; set it on the TPUSpec (registry "
            "entries are priced) or use the 'latency' objective"
        )


def trace_cost_usd(hw: TPUSpec, est: Estimate, objective: str = "cost") -> float:
    """USD to run the estimated trace on ``hw``: the whole slice is billed
    for ``est.total_s`` seconds at the ``usd_per_slice_hour`` rate."""
    if hw.usd_per_slice_hour is None:
        raise UnpricedHardwareError(hw.name, objective)
    return est.total_s / 3600.0 * hw.usd_per_slice_hour


class Objective:
    """Base placement objective: ``score`` (lower = better) + ``feasible``.

    ``score`` may use ``n_tokens`` (generated-token count) when the
    criterion is per-token; implementations must raise an actionable error
    when required metadata is missing rather than silently scoring 0."""

    name = "base"

    def score(self, hw: TPUSpec, est: Estimate, *, n_tokens: Optional[float] = None) -> float:
        raise NotImplementedError

    def feasible(self, hw: TPUSpec, est: Estimate) -> bool:
        return True

    def describe(self) -> str:
        return self.name


class LatencyObjective(Objective):
    """Score = predicted trace latency in seconds."""

    name = "latency"

    def score(self, hw: TPUSpec, est: Estimate, *, n_tokens: Optional[float] = None) -> float:
        return est.total_s


class CostObjective(Objective):
    """Score = USD for the trace (slice-hours x list price)."""

    name = "cost"

    def score(self, hw: TPUSpec, est: Estimate, *, n_tokens: Optional[float] = None) -> float:
        return trace_cost_usd(hw, est, self.name)


class CostPerTokenObjective(Objective):
    """Score = USD per *generated* token. Needs ``n_tokens``."""

    name = "cost_per_token"

    def score(self, hw: TPUSpec, est: Estimate, *, n_tokens: Optional[float] = None) -> float:
        if not n_tokens:
            raise ValueError(
                "objective 'cost_per_token' needs n_tokens > 0 (generated "
                "tokens: TraceRecorder.generated_tokens for a recorded "
                "trace, B * lout for a synthetic request)"
            )
        return trace_cost_usd(hw, est, self.name) / n_tokens


class SLOCheapestObjective(Objective):
    """Cheapest hardware whose predicted latency meets an SLO: feasible iff
    ``est.total_s <= slo_s``; score = trace cost, so the router ranks
    feasible entries by price and only then falls back to SLO violators
    (also by price — "least over budget" is not the criterion; violators
    are flagged infeasible in the placement table)."""

    name = "slo_cheapest"

    def __init__(self, slo_s: float) -> None:
        if slo_s <= 0:
            raise ValueError(f"slo_s must be > 0, got {slo_s}")
        self.slo_s = slo_s

    def score(self, hw: TPUSpec, est: Estimate, *, n_tokens: Optional[float] = None) -> float:
        return trace_cost_usd(hw, est, self.name)

    def feasible(self, hw: TPUSpec, est: Estimate) -> bool:
        return est.total_s <= self.slo_s

    def describe(self) -> str:
        return f"{self.name}(slo={self.slo_s*1e3:.1f}ms)"


class ResidualCorrectedObjective(Objective):
    """Wrap any objective so it scores *residual-corrected* estimates:
    before delegating to ``base``, the hardware's estimate is rescaled by
    its measured-vs-predicted correction factor (``corrections[hw.name]``,
    default 1.0 — uncorrected).

    The factors come from a ``repro_torch.serve.monitor.ResidualMonitor``'s
    :meth:`~repro_torch.serve.monitor.ResidualMonitor.corrections` — per-hw EWMA
    residual ratios of a live fleet. Re-running ``FleetRouter.route_many``
    under this wrapper is how the drift control loop re-places workloads
    against what the fleet *measures* instead of what the frozen predictor
    believed at fit time; ``FleetRouter.route_corrected`` and
    ``FleetSimulator.replay(monitor=...)`` build it for you."""

    name = "residual_corrected"

    def __init__(self, base: Union[str, Objective],
                 corrections: dict[str, float]) -> None:
        self.base = get_objective(base)
        for hw_name, factor in corrections.items():
            if not (factor > 0 and math.isfinite(factor)):
                raise ValueError(
                    f"correction factor for {hw_name!r} must be finite and "
                    f"> 0, got {factor}"
                )
        self.corrections = dict(corrections)

    def _corrected(self, hw: TPUSpec, est: Estimate) -> Estimate:
        factor = self.corrections.get(hw.name, 1.0)
        return est if factor == 1.0 else est.scaled(factor)

    def score(self, hw: TPUSpec, est: Estimate, *, n_tokens: Optional[float] = None) -> float:
        return self.base.score(hw, self._corrected(hw, est), n_tokens=n_tokens)

    def feasible(self, hw: TPUSpec, est: Estimate) -> bool:
        return self.base.feasible(hw, self._corrected(hw, est))

    def describe(self) -> str:
        facts = ", ".join(
            f"{hw}x{f:.3g}" for hw, f in sorted(self.corrections.items())
        )
        return f"{self.name}({self.base.describe()}; {facts or 'no corrections'})"


OBJECTIVES = {
    "latency": LatencyObjective,
    "cost": CostObjective,
    "cost_per_token": CostPerTokenObjective,
    "slo_cheapest": SLOCheapestObjective,
    "residual_corrected": ResidualCorrectedObjective,
}


def get_objective(spec: Union[str, Objective], **kwargs: Any) -> Objective:
    """Resolve an objective: an ``Objective`` instance passes through,
    a name constructs from :data:`OBJECTIVES` (``slo_cheapest`` requires
    ``slo_s=``)."""
    if isinstance(spec, Objective):
        if kwargs:
            raise TypeError("kwargs only apply when constructing by name")
        return spec
    try:
        cls = OBJECTIVES[spec]
    except KeyError:
        raise KeyError(
            f"unknown objective {spec!r}; registered: {sorted(OBJECTIVES)}"
        ) from None
    return cls(**kwargs)
