"""Multi-hardware sweep prediction (the paper's generalization protocol),
ported from ``repro.predict.sweep`` and held equal to it.

SynPerf's headline claim is one estimator generalizing *across hardware*:
the same kernel trace priced on every registry entry, errors reported per
kernel family over the seen/unseen split. ``SweepPredictor`` runs that
protocol as one pass:

    sweep = SweepPredictor(REGISTRY, backend="roofline")
    res = sweep.predict(trace)          # {hw name: Estimate}
    cmp = sweep.compare(trace)          # measured (oracle) vs predicted

Why a sweep is cheaper than N independent predicts:

  1. the trace is flattened and grouped by (kind, canonical shape) once;
  2. decompose+schedule run once per (kind, shape, task-signature) — most
     hardware shares a signature (``batching.task_sig``), so task
     construction does not fan out per device;
  3. only ``analyze`` + the feature vector + the per-family latency model
     are per-device.

Every latency here is a prediction for a registry TPU, never a time
measured on the machine that runs the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ItemsView, Iterable, Iterator, Optional

import numpy as np

from repro_torch.core.hardware import REGISTRY, TPUSpec, get_hw
from repro_torch.predict.api import CallSeq, CommCall, Estimate, KernelCall
from repro_torch.predict.batching import FeatureCache, group_calls


def _resolve_hws(hws: Optional[Iterable]) -> list[TPUSpec]:
    if hws is None:
        return list(REGISTRY.values())
    out = []
    for h in hws:
        out.append(get_hw(h) if isinstance(h, str) else h)
    if not out:
        raise ValueError("SweepPredictor needs at least one hardware")
    names = [h.name for h in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate hardware in sweep: {names}")
    return out


def check_prebuilt_exclusive(
    name: str, prebuilt: object, hws: Optional[Iterable], backend: str, backend_kw: dict
) -> None:
    """Shared guard for the ``sweep=``/``router=`` convenience kwargs:
    a prebuilt object already carries its hardware list and backends, so
    combining it with construction kwargs is ambiguous and refused."""
    if prebuilt is not None and (hws is not None or backend != "synperf" or backend_kw):
        raise TypeError(
            f"pass either {name}= (a prebuilt object) or "
            "hws=/backend=/backend kwargs, not both"
        )


def hw_split(name: str) -> str:
    """``"seen"`` / ``"unseen"`` for registry entries (the paper's
    training/held-out hardware split), ``"?"`` for off-registry specs."""
    spec = REGISTRY.get(name)
    return "?" if spec is None else ("seen" if spec.seen else "unseen")


_split = hw_split  # backward-compatible private alias


@dataclasses.dataclass
class SweepResult:
    """Per-hardware estimates for one trace. Mapping-ish: iterate items(),
    index by hw name."""

    estimates: dict  # hw name -> Estimate, sweep order

    def __getitem__(self, hw_name: str) -> Estimate:
        return self.estimates[hw_name]

    def __iter__(self) -> Iterator:
        return iter(self.estimates)

    def __len__(self) -> int:
        return len(self.estimates)

    def items(self) -> ItemsView:
        return self.estimates.items()

    def totals(self) -> dict:
        return {name: est.total_s for name, est in self.estimates.items()}

    def scaled(self, k: float) -> "SweepResult":
        return SweepResult({n: e.scaled(k) for n, e in self.estimates.items()})

    def overlapped(self) -> "SweepResult":
        """Overlap-aware re-pricing of every device's estimate
        (``Estimate.overlapped``): each uses its own exposed-compute
        window, so slower devices (longer kernel time for the same trace)
        hide proportionally more of the same collectives."""
        return SweepResult({n: e.overlapped() for n, e in self.estimates.items()})

    def table(self) -> str:
        """Per-hw latency table, seen/unseen tagged, fastest first."""
        rows = sorted(self.estimates.items(), key=lambda kv: kv[1].total_s)
        lines = [f"{'hardware':<14} {'split':<7} {'total':>10} {'kernel':>10} "
                 f"{'comm':>10} {'ceiling':>10}"]
        for name, est in rows:
            ceil = "-" if est.theoretical_s is None else f"{est.theoretical_s*1e3:.2f}ms"
            lines.append(
                f"{name:<14} {_split(name):<7} {est.total_s*1e3:>8.2f}ms "
                f"{est.kernel_s*1e3:>8.2f}ms {est.comm_s*1e3:>8.2f}ms {ceil:>10}"
            )
        return "\n".join(lines)


@dataclasses.dataclass
class SweepComparison:
    """Measured-vs-predicted over a sweep: one row per (hw, family) plus
    per-request totals — the data behind the paper's Table IX layout.

    All latencies are **seconds for the whole compared trace** (the sum of
    every recorded/weighted step), not per-step or per-token values;
    "measured" means the ``reference`` backend of :meth:`SweepPredictor
    .compare` (default: the hwsim oracle), not this process's wall-clock.
    """

    #: hw name -> family -> (measured_s, predicted_s), trace totals
    by_family: dict
    #: hw name -> (measured_total_s, predicted_total_s), trace totals
    totals: dict

    def err_pct(self, hw_name: str) -> float:
        """Absolute relative total-latency error for one hardware, in
        percent (``|predicted - measured| / measured * 100``)."""
        m, p = self.totals[hw_name]
        return abs(p - m) / max(m, 1e-12) * 100.0

    def split_mape(self) -> dict:
        """``{"seen": ..., "unseen": ...}`` mean absolute total-latency
        error in **percent** over the registry's seen/unseen hardware
        split — the generalization headline numbers. Each hardware
        contributes its whole-trace :meth:`err_pct` (an error on totals,
        not a mean of per-kernel errors); off-registry specs (split
        ``"?"``) are excluded, and an empty split is ``nan`` — callers
        like :meth:`table` must omit it rather than print ``nan%``."""
        out = {"seen": [], "unseen": []}
        for name in self.totals:
            split = hw_split(name)
            if split != "?":
                out[split].append(self.err_pct(name))
        return {k: float(np.mean(v)) if v else float("nan") for k, v in out.items()}

    def family_mape(self) -> dict:
        """``{family: error_pct}`` — mean absolute error in **percent** of
        each kernel family's *per-trace total seconds*, averaged across
        all swept hardware (the Table VIII analogue). Comm ops are not
        included: only kernel families appear in ``by_family``."""
        errs: dict = {}
        for fams in self.by_family.values():
            for fam, (m, p) in fams.items():
                errs.setdefault(fam, []).append(abs(p - m) / max(m, 1e-12) * 100.0)
        return {f: float(np.mean(v)) for f, v in errs.items()}

    def table(self) -> str:
        lines = [f"{'hardware':<14} {'split':<7} {'measured':>10} {'predicted':>10} {'err':>7}"]
        for name, (m, p) in sorted(self.totals.items(), key=lambda kv: kv[1][0]):
            lines.append(
                f"{name:<14} {_split(name):<7} {m*1e3:>8.2f}ms {p*1e3:>8.2f}ms "
                f"{self.err_pct(name):>6.1f}%"
            )
        sm = self.split_mape()
        for split in ("seen", "unseen"):
            if not np.isnan(sm[split]):
                lines.append(f"{'mean':<14} {split:<7} {'':>10} {'':>10} {sm[split]:>6.1f}%")
        return "\n".join(lines)


class SweepPredictor:
    """One trace, many devices: a per-hardware family of predictor backends
    sharing one ``FeatureCache`` (task- and feature-level memoization) and
    one grouping pass per trace.

    ``hws`` is an iterable of hardware names or specs (default: the whole
    registry). ``backend`` + ``**backend_kw`` are forwarded to
    ``get_predictor`` per hardware — e.g. ``estimator=pw`` for "synperf"
    (the estimator is hw-independent and shared). A ``predictors`` mapping
    of pre-built backends overrides construction entirely (they should
    share a cache to benefit from the sweep).

    Conventions (shared with ``docs/predict.md``):

      * every returned latency is **seconds for the whole priced trace**;
        per-step views come from :meth:`predict_steps`;
      * traces are call sequences — flat ``KernelCall``/``CommCall`` lists
        or nested ``(label, repetitions, sub_sequence)`` groups. Workload
        shapes are the *launched* shapes (padded batch) with the longest
        **attended** KV span per step — the decomposer's convention, which
        ``TraceRecorder`` follows, so recorded traces, synthetic
        ``request_calls`` and the hwsim oracle are mutually comparable;
      * the sweep is exact: per-hw results equal independent
        ``get_predictor(backend, hw).predict(trace)`` calls
        (``tests/test_sweep.py`` pins this at 1e-9 relative) — sharing
        only removes redundant work, never approximates."""

    def __init__(
        self,
        hws: Optional[Iterable] = None,
        backend: str = "synperf",
        *,
        cache: Optional[FeatureCache] = None,
        predictors: Optional[dict] = None,
        **backend_kw: Any,
    ) -> None:
        from repro_torch.predict.backends import get_predictor

        self.cache = cache if cache is not None else FeatureCache()
        if predictors is None:
            self.hws = _resolve_hws(hws)
            predictors = {
                hw.name: get_predictor(backend, hw, cache=self.cache, **backend_kw)
                for hw in self.hws
            }
        else:
            # pre-built backends carry their own spec; fall back to the
            # registry for adapters constructed without one. Keys must be
            # the hardware names — predict()/compare() index by them.
            hws = []
            for name, p in predictors.items():
                spec = p.hw if p.hw is not None else get_hw(name)
                if name != spec.name:
                    raise ValueError(
                        f"predictors key {name!r} != its backend's hardware "
                        f"name {spec.name!r}; key the mapping by hw name"
                    )
                hws.append(spec)
            self.hws = hws
        self.predictors = predictors

    @property
    def hw_names(self) -> list:
        return [hw.name for hw in self.hws]

    def predict(self, calls: CallSeq) -> SweepResult:
        """Group once, estimate per hardware."""
        families, comms = group_calls(calls)
        return SweepResult(
            {
                hw.name: self.predictors[hw.name].predict_grouped(families, comms)
                for hw in self.hws
            }
        )

    def predict_steps(self, calls: CallSeq) -> dict:
        """Per-step estimates across the sweep: ``{hw name: [(label,
        Estimate), ...]}`` with one entry per *top-level* group of
        ``calls`` (a ``TraceRecorder`` trace has one group per executed
        engine step; bare calls between groups are folded into an
        anonymous ``"calls"`` step).

        This is the per-step view the placement layer builds on (e.g.
        pricing prefill-class vs decode-class steps separately), and it is
        cheap by construction: every step shares this sweep's
        ``FeatureCache``, so the decompose/schedule/demand levels are
        warmed once per unique shape no matter how many steps repeat it —
        only the per-step grouping pass and the (memoized) feature lookups
        fan out. Estimates are per *single execution* of each step times
        its group repetition count, in trace order."""
        steps: list = []
        loose: list = []
        for item in calls:
            if isinstance(item, (KernelCall, CommCall)):
                loose.append(item)
            else:
                if loose:
                    steps.append(("calls", 1.0, loose))
                    loose = []
                steps.append(item)
        if loose:
            steps.append(("calls", 1.0, loose))
        out: dict = {hw.name: [] for hw in self.hws}
        for label, reps, seq in steps:
            families, comms = group_calls([(label, reps, seq)])
            for hw in self.hws:
                est = self.predictors[hw.name].predict_grouped(families, comms)
                out[hw.name].append((label, est))
        return out

    def compare(self, calls: CallSeq, *, reference: str = "oracle") -> SweepComparison:
        """Measured (``reference`` backend, default the hwsim oracle) vs
        predicted, per hardware and per kernel family, over one grouping
        pass. This is the paper's seen/unseen evaluation protocol."""
        from repro_torch.predict.backends import get_predictor

        families, comms = group_calls(calls)
        by_family: dict = {}
        totals: dict = {}
        for hw in self.hws:
            ref = get_predictor(reference, hw, cache=self.cache)
            measured = ref.predict_grouped(families, comms)
            predicted = self.predictors[hw.name].predict_grouped(families, comms)
            by_family[hw.name] = {
                fam: (measured.by_family[fam], predicted.by_family[fam])
                for fam in measured.by_family
            }
            totals[hw.name] = (measured.total_s, predicted.total_s)
        return SweepComparison(by_family=by_family, totals=totals)
