"""Prediction-guided fleet placement, ported from ``repro.serve.placement``
and held equal to it: route workloads across the hardware
registry using the predict layer (paper §VII "beyond simulation" — the
predictor as a hardware-selection engine, cf. PipeWeave's deployment
framing and Lee et al.'s predict-then-place fleet workflow).

``FleetRouter`` closes the loop: a live ``TraceRecorder``
trace (or a synthetic ``request_calls`` sequence) is priced on every
registry entry via one shared ``SweepPredictor`` pass, then ranked under a
pluggable objective (``repro_torch.predict.objective``)::

    router = FleetRouter(objective="cost", estimator=pw, fallback="oracle")
    placement = router.route(rec.calls(), n_tokens=rec.decode_tokens)
    placement.best            # hw name with the lowest score
    print(placement.table())  # ranked table, skipped hw surfaced

Split-fleet assignment prices workload *classes* separately — a
prefill-heavy class is compute-bound and a decode-heavy class is
bandwidth-bound, so they can prefer different devices::

    sp = router.route_split(rec)   # or {"prefill": [...], "decode": [...]}
    sp.assignment                  # {"prefill": "tpu-v7p", "decode": "tpu-v6e"}

Robustness: a registry entry whose backend cannot price the trace — an
unfitted ``CommRegressor``, an untrained kernel family under
``fallback="error"``, unpriced hardware under a cost objective — is
*skipped with a warning* and surfaced in ``Placement.skipped`` and the
table, instead of aborting the whole fleet sweep mid-pass. Routing only
raises when **no** hardware survives.

Units: scores follow the objective (seconds for ``latency``, USD for the
cost family); ``total_s``/``cost_usd`` per row are whole-trace values.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

from repro_torch.predict.api import Estimate
from repro_torch.predict.batching import group_calls
from repro_torch.predict.objective import (
    Objective,
    ResidualCorrectedObjective,
    UnpricedHardwareError,
    get_objective,
    trace_cost_usd,
)
from repro_torch.predict.sweep import SweepPredictor, check_prebuilt_exclusive, hw_split


@dataclasses.dataclass
class PlacementRow:
    """One ranked hardware: whole-trace latency/cost plus the objective's
    score (lower = better) and SLO feasibility."""

    hw: str
    split: str  # seen / unseen / ? (off-registry)
    total_s: float
    cost_usd: Optional[float]  # None when the hardware is unpriced
    score: float
    feasible: bool
    estimate: Estimate


@dataclasses.dataclass
class Placement:
    """A ranked routing decision: feasible hardware first (by score), then
    infeasible (still by score), plus every skipped entry with its reason."""

    objective: str
    rows: list  # PlacementRow, ranked
    skipped: dict  # hw name -> reason string
    n_tokens: Optional[float] = None

    @property
    def best(self) -> str:
        """The top-ranked hardware name (feasible when any entry is)."""
        if not self.rows:
            raise RuntimeError(
                f"placement under {self.objective!r} has no rankable hardware"
                + (f"; skipped: {self.skipped}" if self.skipped else "")
            )
        return self.rows[0].hw

    def ranking(self) -> list:
        return [r.hw for r in self.rows]

    def __getitem__(self, hw_name: str) -> PlacementRow:
        for r in self.rows:
            if r.hw == hw_name:
                return r
        raise KeyError(hw_name)

    def __contains__(self, hw_name: str) -> bool:
        return any(r.hw == hw_name for r in self.rows)

    def table(self) -> str:
        """Ranked placement table; skipped hardware is listed last with
        its skip reason so fleet gaps stay visible."""
        lines = [f"{'hardware':<14} {'split':<7} {'total':>10} {'cost':>10} "
                 f"{'score':>12} {'feasible':>8}"]
        for r in self.rows:
            cost = "-" if r.cost_usd is None else f"${r.cost_usd:.3g}"
            lines.append(
                f"{r.hw:<14} {r.split:<7} {r.total_s*1e3:>8.2f}ms {cost:>10} "
                f"{r.score:>12.4g} {'yes' if r.feasible else 'NO':>8}"
            )
        for name, reason in sorted(self.skipped.items()):
            lines.append(f"{name:<14} {'-':<7} {'skipped:':>10} {reason}")
        return "\n".join(lines)


@dataclasses.dataclass
class SplitPlacement:
    """Per-workload-class placements (``route_split``): one ``Placement``
    per class, plus the combined fleet assignment."""

    parts: dict  # class name -> Placement

    @property
    def assignment(self) -> dict:
        """``{class: best hw}`` — the split-fleet routing decision."""
        return {phase: p.best for phase, p in self.parts.items()}

    @property
    def is_split(self) -> bool:
        """True when at least two classes prefer different hardware."""
        return len(set(self.assignment.values())) > 1

    def __getitem__(self, phase: str) -> Placement:
        return self.parts[phase]

    def table(self) -> str:
        out = []
        for phase, p in self.parts.items():
            out.append(f"-- {phase} (objective={p.objective}) --")
            out.append(p.table())
        return "\n".join(out)


class FleetRouter:
    """Rank the hardware fleet for a workload by predicted performance.

    Construction mirrors ``SweepPredictor`` (it owns one internally):
    ``hws`` is an iterable of registry names or ``TPUSpec``s (default: the
    whole registry), ``backend`` + ``**backend_kw`` go to
    ``get_predictor`` per hardware, or pass a prebuilt ``sweep=`` to share
    its warmed ``FeatureCache`` across many routing calls. ``objective``
    is the default criterion (name or ``Objective``); every route call may
    override it.

    ``audit=True`` runs the predictor-coverage lint
    (``repro_torch.analysis.audit_predictor``) over every fleet backend at
    construction and raises :class:`~repro_torch.analysis.AuditError`
    listing the diagnostics: a stale ``CommRegressor`` or an untrained
    kernel family fails *here* instead of surfacing as one skip warning per
    hardware in the middle of a fleet sweep. Pass a callable
    ``audit(predictor, hw_name) -> list[Diagnostic]`` to substitute a
    custom pre-flight lint."""

    def __init__(
        self,
        hws=None,
        backend: str = "synperf",
        *,
        objective="latency",
        sweep: Optional[SweepPredictor] = None,
        audit=None,
        **backend_kw,
    ):
        check_prebuilt_exclusive("sweep", sweep, hws, backend, backend_kw)
        self.sweep = sweep if sweep is not None else SweepPredictor(hws, backend, **backend_kw)
        self.objective = get_objective(objective)
        if audit:
            # deferred import: serve stays importable without analysis
            from repro_torch.analysis import AuditError, audit_predictor

            hook = audit_predictor if audit is True else audit
            found = []
            for name, predictor in self.sweep.predictors.items():
                found += (
                    hook(predictor, hw_name=name)
                    if hook is audit_predictor
                    else hook(predictor, name)
                )
            errors = [d for d in found if d.severity == "error"]
            if errors:
                raise AuditError(errors)

    @property
    def hw_names(self) -> list:
        return self.sweep.hw_names

    # ------------------------------------------------------------------

    def _rank(
        self, estimates: dict, obj: Objective, n_tokens, skipped: dict
    ) -> Placement:
        rows = []
        for hw in self.sweep.hws:
            if hw.name in skipped:
                continue
            est = estimates[hw.name]
            try:
                score = obj.score(hw, est, n_tokens=n_tokens)
            except UnpricedHardwareError as e:
                # a per-hardware gap (no price) skips the entry; workload-
                # metadata errors (e.g. a missing n_tokens) are hardware-
                # independent and propagate to the caller instead of being
                # laundered into one skip warning per fleet entry
                warnings.warn(f"FleetRouter: skipping {hw.name}: {e}", stacklevel=3)
                skipped[hw.name] = f"{type(e).__name__}: {e}"
                continue
            cost = (
                None
                if hw.usd_per_chip_hour is None
                else trace_cost_usd(hw, est)
            )
            rows.append(
                PlacementRow(
                    hw=hw.name,
                    split=hw_split(hw.name),
                    total_s=est.total_s,
                    cost_usd=cost,
                    score=score,
                    feasible=obj.feasible(hw, est),
                    estimate=est,
                )
            )
        if not rows:
            raise RuntimeError(
                f"FleetRouter: every hardware was skipped under "
                f"{obj.describe()!r}: {skipped}"
            )
        rows.sort(key=lambda r: (not r.feasible, r.score))
        return Placement(
            objective=obj.describe(), rows=rows, skipped=skipped, n_tokens=n_tokens
        )

    def route(
        self,
        calls,
        *,
        objective=None,
        n_tokens: Optional[float] = None,
        scale: float = 1.0,
        overlap: bool = False,
    ) -> Placement:
        """Price ``calls`` on every fleet entry (one grouping pass, shared
        cache) and rank under the objective.

        ``n_tokens`` is the generated-token count (needed by per-token
        objectives); ``scale`` multiplies every estimate (e.g. the PP
        bubble surcharge ``place_request`` applies); ``overlap=True``
        overlap-prices each candidate (``Estimate.overlapped``, applied
        before ``scale``) — each device uses its own exposed-compute
        window, which can re-rank comm-bound fleets. Hardware whose
        backend raises while pricing (unfitted comm regressor, untrained
        family under ``fallback="error"``) is skipped with a warning."""
        obj = self.objective if objective is None else get_objective(objective)
        families, comms = group_calls(calls)
        estimates: dict = {}
        skipped: dict = {}
        for hw in self.sweep.hws:
            try:
                est = self.sweep.predictors[hw.name].predict_grouped(families, comms)
            except RuntimeError as e:  # incl. UntrainedFamilyError
                warnings.warn(
                    f"FleetRouter: skipping {hw.name}: {e}", stacklevel=2
                )
                skipped[hw.name] = f"{type(e).__name__}: {e}"
                continue
            if overlap:
                est = est.overlapped()
            estimates[hw.name] = est if scale == 1.0 else est.scaled(scale)
        return self._rank(estimates, obj, n_tokens, skipped)

    def route_many(
        self,
        named_calls: dict,
        *,
        objective=None,
        n_tokens: Optional[dict] = None,
        scales: Optional[dict] = None,
    ) -> dict:
        """Route several named workloads through the shared sweep cache:
        ``{name: call sequence} -> {name: Placement}``. ``n_tokens`` and
        ``scales`` are optional per-name mappings (generated-token count
        for per-token objectives; estimate scale, e.g. a PP bubble
        surcharge). The names are workload *classes* in the fleet-simulator
        sense (``serve.fleet``) — every class is priced against one warmed
        ``FeatureCache``, so routing a whole traffic mix costs barely more
        than one combined route."""
        n_tokens = n_tokens or {}
        scales = scales or {}
        return {
            name: self.route(
                calls,
                objective=objective,
                n_tokens=n_tokens.get(name),
                scale=scales.get(name, 1.0),
            )
            for name, calls in named_calls.items()
        }

    def route_corrected(
        self,
        named_calls: dict,
        corrections: dict,
        *,
        objective=None,
        n_tokens: Optional[dict] = None,
        scales: Optional[dict] = None,
    ) -> dict:
        """``route_many`` against *residual-corrected* service times: every
        hardware's estimate is rescaled by its measured-vs-predicted
        correction factor (``{hw: factor}``, absent = 1.0 — typically a
        ``repro_torch.serve.monitor.ResidualMonitor``'s ``corrections()``) before
        objective scoring. This is the mid-replay re-route step of the
        drift control loop: the ranking reflects what the fleet measures,
        not what the frozen fit believed."""
        obj = self.objective if objective is None else get_objective(objective)
        return self.route_many(
            named_calls,
            objective=ResidualCorrectedObjective(obj, dict(corrections)),
            n_tokens=n_tokens,
            scales=scales,
        )

    def route_trace(self, recorder, *, objective=None, scale: float = 1.0) -> Placement:
        """Route a live ``TraceRecorder``: the recorded call groups with
        ``n_tokens`` taken from the recorder's generated-token count
        (prefill-sampled first tokens + decode-tick tokens)."""
        return self.route(
            recorder.calls(),
            objective=objective,
            n_tokens=recorder.generated_tokens or None,
            scale=scale,
        )

    def route_split(self, trace, *, objective=None) -> SplitPlacement:
        """Split-fleet assignment: place each workload class on its own
        best hardware.

        ``trace`` is a ``TraceRecorder`` (classes = recorded step phases,
        via ``split_calls()``) or a ``{class: call sequence}`` mapping.
        Every class is priced through the same shared cache, so the split
        pass costs barely more than one combined route."""
        if hasattr(trace, "split_calls"):
            parts = trace.split_calls()
            # per-class token counts so per-token objectives work on
            # either side of the split
            tokens = {
                "prefill": getattr(trace, "prefill_tokens", None) or None,
                "decode": getattr(trace, "decode_tokens", None) or None,
            }
        elif isinstance(trace, dict):
            parts = trace
            tokens = {}
        else:
            raise TypeError(
                "route_split takes a TraceRecorder or a {class: calls} mapping, "
                f"got {type(trace).__name__}"
            )
        if not parts:
            raise ValueError("route_split: empty trace (no workload classes)")
        return SplitPlacement(
            {
                phase: self.route(calls, objective=objective, n_tokens=tokens.get(phase))
                for phase, calls in parts.items()
            }
        )
