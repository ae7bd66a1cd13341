"""Residual monitoring, ported from ``repro.serve.monitor`` and held equal
to it: detect sustained measured-vs-predicted drift and drive fleet
re-routing (the ROADMAP's "drift-driven re-routing" control
loop; Zhang et al.'s fine-grained distributed-LLM model, arXiv 2509.22832,
is the reference for which multi-node terms dominate at fleet scale, and
PipeWeave's frozen-at-fit-time accuracy is the baseline this loop beats).

The predict stack prices a workload once; a live fleet then drifts —
thermals, contention, a quietly degraded link — and placements made on the
stale numbers stop being optimal. A :class:`ResidualMonitor` closes that
gap:

  * every completed unit of work contributes one *residual* observation,
    the ratio ``measured_s / predicted_s`` for its ``(workload class,
    hardware)`` key — from the fleet simulator's completions, from a
    :class:`~repro_torch.serve.trace.TraceRecorder`'s per-step wall-clock
    (``StepMeta.measured_s``), or from engine ``Result.latency_s``;
  * per key, the monitor keeps an EWMA of the residual ratio over a
    sliding window (``window`` is the EWMA span: ``alpha = 2/(window+1)``,
    seeded with the first sample so an all-identical stream's EWMA is that
    value *exactly*; the last ``window`` raw residuals are kept for
    inspection);
  * a drift trips only when the EWMA's deviation ``|ewma - 1|`` stays
    ``>= threshold`` for ``sustain`` *consecutive* observations (after at
    least ``min_samples`` have been seen) — a single noisy spike moves
    the EWMA by at most ``alpha`` of itself and resets the streak, so
    transient noise never triggers a re-route;
  * on a trip, :meth:`ResidualMonitor.corrections` is the per-hardware
    residual factor to rescale predictions with —
    ``FleetSimulator.replay(monitor=...)`` re-runs ``route_many`` under a
    :class:`~repro_torch.predict.objective.ResidualCorrectedObjective`
    built from it, logs a ``RerouteEvent``, and resets the monitor against
    the corrected baseline (so a step drift re-routes exactly once: after
    correction the residual returns to 1).

Drift *injection* lives here too: a :class:`DriftSpec` multiplies one
hardware's true service times (step or linear ramp), which makes the whole
loop testable end to end — inject a step, watch the monitor trip, check
the re-route log.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Optional

#: default EWMA span (observations) — roughly "how much history matters"
DEFAULT_WINDOW = 64
#: default relative deviation of the EWMA ratio that counts as drift
DEFAULT_THRESHOLD = 0.25
#: default number of consecutive over-threshold observations to trip
DEFAULT_SUSTAIN = 8


# ----------------------------------------------------------------------
# drift injection
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DriftSpec:
    """A multiplier on one hardware's *true* service times.

    ``mode="step"`` jumps from 1.0 to ``factor`` at ``t_start``;
    ``mode="ramp"`` rises linearly from 1.0 at ``t_start`` to ``factor``
    at ``t_end`` and holds. Factors below 1.0 model a *speedup* drift
    (e.g. a contention source going away) and are equally detectable —
    the monitor trips on ``|ewma - 1|``, not on slowdowns only."""

    hw: str
    factor: float
    t_start: float = 0.0
    mode: str = "step"  # "step" | "ramp"
    t_end: Optional[float] = None  # required for mode="ramp"

    def __post_init__(self) -> None:
        if self.factor <= 0 or not math.isfinite(self.factor):
            raise ValueError(f"drift factor must be finite and > 0, got {self.factor}")
        if self.mode not in ("step", "ramp"):
            raise ValueError(f"drift mode must be 'step' or 'ramp', got {self.mode!r}")
        if self.mode == "ramp":
            if self.t_end is None or self.t_end <= self.t_start:
                raise ValueError(
                    f"ramp drift needs t_end > t_start, got t_start={self.t_start} "
                    f"t_end={self.t_end}"
                )

    def factor_at(self, t: float) -> float:
        """The multiplier in effect at simulation time ``t``."""
        if t < self.t_start:
            return 1.0
        if self.mode == "step" or t >= self.t_end:
            return self.factor
        frac = (t - self.t_start) / (self.t_end - self.t_start)
        return 1.0 + (self.factor - 1.0) * frac


def resolve_drift(drift) -> dict:
    """Normalize a replay's ``drift=`` argument to ``{hw: [DriftSpec]}``.

    Accepts ``None``, one :class:`DriftSpec`, an iterable of them, or the
    shorthand ``{hw: factor}`` (a step at t=0 per entry)."""
    if drift is None:
        return {}
    if isinstance(drift, DriftSpec):
        drift = [drift]
    if isinstance(drift, dict):
        drift = [DriftSpec(hw=h, factor=f) for h, f in drift.items()]
    out: dict = {}
    for spec in drift:
        if not isinstance(spec, DriftSpec):
            raise TypeError(
                "drift= takes a DriftSpec, a list of them, or a {hw: factor} "
                f"mapping; got element {spec!r}"
            )
        out.setdefault(spec.hw, []).append(spec)
    return out


def drift_factor(specs_by_hw: dict, hw: str, t: float) -> float:
    """Combined (multiplicative) drift factor on ``hw`` at time ``t``."""
    f = 1.0
    for spec in specs_by_hw.get(hw, ()):
        f *= spec.factor_at(t)
    return f


# ----------------------------------------------------------------------
# residual observations
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Residual:
    """One measured-vs-predicted observation."""

    t: float
    cls: str
    hw: str
    measured_s: float
    predicted_s: float
    label: str = ""

    @property
    def ratio(self) -> float:
        return self.measured_s / self.predicted_s


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    """A sustained-drift trip: the EWMA residual of ``(cls, hw)`` stayed
    over threshold for the configured streak. ``ewma`` is the residual
    *ratio* at trip time — the correction factor for this key."""

    t: float
    cls: str
    hw: str
    ewma: float
    deviation: float  # |ewma - 1| at trip time
    n_samples: int  # total observations of the key so far


@dataclasses.dataclass
class _KeyState:
    ewma: float = 0.0
    n: int = 0
    over: int = 0  # consecutive over-threshold observations
    window: deque = None  # last `window` raw ratios


class ResidualMonitor:
    """Sustained measured-vs-predicted drift detector per
    ``(workload class, hardware)`` key.

    Parameters
    ----------
    window:
        EWMA span in observations (``alpha = 2/(window+1)``); also the
        length of the kept raw-residual window. A window longer than the
        observation stream is fine — the EWMA is seeded with the first
        sample and defined from then on.
    threshold:
        relative deviation ``|ewma - 1|`` that counts as over-threshold.
        The comparison is ``>=``: a residual pinned exactly at
        ``1 + threshold`` trips once sustained.
    sustain:
        consecutive over-threshold observations required to trip. One
        under-threshold observation resets the streak — this is the
        transient-noise guard.
    min_samples:
        observations of a key before it may start a streak (defaults to
        ``sustain``); keeps single-sample classes from tripping on their
        first residual.
    """

    def __init__(
        self,
        *,
        window: int = DEFAULT_WINDOW,
        threshold: float = DEFAULT_THRESHOLD,
        sustain: int = DEFAULT_SUSTAIN,
        min_samples: Optional[int] = None,
    ):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if not (threshold > 0 and math.isfinite(threshold)):
            raise ValueError(f"threshold must be finite and > 0, got {threshold}")
        if sustain < 1:
            raise ValueError(f"sustain must be >= 1, got {sustain}")
        self.window = int(window)
        self.threshold = float(threshold)
        self.sustain = int(sustain)
        self.min_samples = int(sustain if min_samples is None else min_samples)
        self._alpha = 2.0 / (self.window + 1.0)
        self._state: dict = {}  # (cls, hw) -> _KeyState
        #: every trip ever observed (kept across reset() by default)
        self.events: list = []
        self.n_observed = 0

    # ------------------------------------------------------------------

    def observe(
        self, cls: str, hw: str, measured_s: float, predicted_s: float, t: float = 0.0
    ) -> Optional[DriftEvent]:
        """Feed one residual; returns a :class:`DriftEvent` when this
        observation completes a sustained over-threshold streak (the event
        is also appended to :attr:`events`), else ``None``. After a trip
        the streak restarts — without :meth:`reset` (or corrected
        predictions) the same drift trips again ``sustain`` observations
        later."""
        if not (measured_s > 0 and math.isfinite(measured_s)):
            raise ValueError(f"measured_s must be finite and > 0, got {measured_s}")
        if not (predicted_s > 0 and math.isfinite(predicted_s)):
            raise ValueError(f"predicted_s must be finite and > 0, got {predicted_s}")
        ratio = measured_s / predicted_s
        key = (cls, hw)
        st = self._state.get(key)
        if st is None:
            st = self._state[key] = _KeyState(
                ewma=ratio, window=deque(maxlen=self.window)
            )
        else:
            st.ewma += self._alpha * (ratio - st.ewma)
        st.n += 1
        st.window.append(ratio)
        self.n_observed += 1
        if st.n >= self.min_samples and abs(st.ewma - 1.0) >= self.threshold:
            st.over += 1
        else:
            st.over = 0
        if st.over >= self.sustain:
            st.over = 0
            event = DriftEvent(
                t=t, cls=cls, hw=hw, ewma=st.ewma,
                deviation=abs(st.ewma - 1.0), n_samples=st.n,
            )
            self.events.append(event)
            return event
        return None

    def observe_trace(self, recorder, predictor, *, cls: str = "trace",
                      hw: Optional[str] = None) -> list:
        """Feed every measured step of a ``TraceRecorder`` (steps with
        ``StepMeta.measured_s > 0``); returns the trip events raised.
        ``hw`` defaults to the predictor's hardware name."""
        events = []
        for r in trace_residuals(recorder, predictor, cls=cls, hw=hw):
            ev = self.observe(r.cls, r.hw, r.measured_s, r.predicted_s, t=r.t)
            if ev is not None:
                events.append(ev)
        return events

    def observe_results(self, results, predicted_s: float, *, cls: str, hw: str,
                        t0: float = 0.0) -> list:
        """Feed engine ``Result``s: each result's measured ``latency_s``
        against one per-request ``predicted_s`` (e.g. a ``request_calls``
        estimate on the target hardware). Returns the trip events."""
        events = []
        t = t0
        for r in results:
            t += r.latency_s
            ev = self.observe(cls, hw, r.latency_s, predicted_s, t=t)
            if ev is not None:
                events.append(ev)
        return events

    # ------------------------------------------------------------------

    def keys(self) -> list:
        return sorted(self._state)

    def ewma(self, cls: str, hw: str) -> Optional[float]:
        st = self._state.get((cls, hw))
        return None if st is None else st.ewma

    def deviation(self, cls: str, hw: str) -> Optional[float]:
        st = self._state.get((cls, hw))
        return None if st is None else abs(st.ewma - 1.0)

    def n_samples(self, cls: str, hw: str) -> int:
        st = self._state.get((cls, hw))
        return 0 if st is None else st.n

    def window_samples(self, cls: str, hw: str) -> list:
        """The raw residual ratios currently in the key's sliding window."""
        st = self._state.get((cls, hw))
        return [] if st is None else list(st.window)

    def corrections(self) -> dict:
        """Per-hardware residual correction factors: for each hardware with
        observations, the window-count-weighted mean of its class EWMAs.
        Multiply predicted service times by these to get residual-corrected
        ones (``ResidualCorrectedObjective`` does exactly that). Hardware
        never observed is absent — callers treat that as factor 1.0."""
        num: dict = {}
        den: dict = {}
        for (_, hw), st in self._state.items():
            w = len(st.window)
            num[hw] = num.get(hw, 0.0) + st.ewma * w
            den[hw] = den.get(hw, 0) + w
        return {hw: num[hw] / den[hw] for hw in num if den[hw] > 0}

    def reset(self, *, clear_events: bool = False) -> None:
        """Drop all per-key sample state (the re-route loop calls this
        after applying corrections — the baseline changed, so history
        against the old baseline is no longer evidence). The trip history
        in :attr:`events` is kept unless ``clear_events=True``."""
        self._state.clear()
        self.n_observed = 0
        if clear_events:
            self.events.clear()


# ----------------------------------------------------------------------
# trace round-trip helpers
# ----------------------------------------------------------------------


def step_predicted_s(meta, cfg, predictor, *, pp_schedule: str = "gpipe",
                     pp_interleave: int = 2, tuned: Optional[dict] = None) -> float:
    """Predicted seconds of one recorded step, re-lowered from its
    :class:`~repro_torch.serve.trace.StepMeta` shapes alone (``B``/``qlen``/
    ``kvlen`` at the meta's ``tp``/``pp``). By construction this equals
    predicting the recorded call group directly — the round-trip the
    recorder contract promises."""
    from repro_torch.serve.trace import step_calls

    return predictor.predict(
        step_calls(cfg, meta.B, meta.qlen, meta.kvlen, tp=meta.tp, pp=meta.pp,
                   pp_schedule=pp_schedule, pp_interleave=pp_interleave,
                   tuned=tuned)
    ).total_s


def trace_residuals(recorder, predictor, *, cls: str = "trace",
                    hw: Optional[str] = None) -> list:
    """Measured-vs-predicted residuals of a recorded serving run: one
    :class:`Residual` per step that carries engine wall-clock
    (``StepMeta.measured_s > 0``), with ``predicted_s`` from pricing the
    recorded call group on ``predictor``. Timestamps are the cumulative
    measured seconds (a per-process clock, good enough for ordering)."""
    if hw is None:
        hw = getattr(getattr(predictor, "hw", None), "name", "") or "?"
    out = []
    t = 0.0
    for (_, _, calls), meta in zip(recorder.steps, recorder.meta):
        if meta.measured_s <= 0:
            continue
        t += meta.measured_s
        out.append(
            Residual(t=t, cls=cls, hw=hw, measured_s=meta.measured_s,
                     predicted_s=predictor.predict(calls).total_s,
                     label=meta.label)
        )
    return out
