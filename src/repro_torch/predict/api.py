"""Predictor API surface: the call types every workload generator emits,
the ``Estimate`` result every backend returns, and the ``Predictor``
protocol that ties them together.

This module is the bottom of the predict-layer dependency stack — it must
not import anything from ``repro_torch.core`` so that ``repro_torch.core.e2e`` (the
workload generator) can re-export the call types without a cycle.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Protocol, runtime_checkable


@dataclasses.dataclass
class KernelCall:
    """One kernel invocation: family name + the workload dict the
    decomposer understands. ``count`` repeats the call (may be fractional
    for amortized calls, e.g. Simpson decode weights)."""

    kind: str
    X: dict
    count: float = 1


@dataclasses.dataclass
class CommCall:
    """One collective: op name, payload bytes, participant count.

    ``skew`` is the routing-imbalance knob for all-to-alls (the same
    dirichlet skew the fused-MoE decomposition's ``routing_counts``
    uses): 0 = balanced traffic (the legacy contention model, exactly),
    larger = a hotter chip serializing the exchange. Backends that model
    congestion (the hwsim oracle) price it; alpha-beta regressor
    backends are fitted on balanced traffic and apply the analytical
    hot-chip factor on top."""

    op: str
    nbytes: float
    n_units: int
    count: float = 1
    skew: float = 0.0


# a call sequence may nest groups: (label, repetitions, sub-sequence),
# e.g. model_calls() emits [("layers", n_layers, [...]), ("head", 1, [...])]
CallSeq = Iterable


def flatten_calls(calls: CallSeq, weight: float = 1.0, _out: Optional[list] = None) -> list:
    """Flatten a (possibly nested) call sequence into ``(call, weight)``
    pairs, folding group repetitions and per-call counts into the weight."""
    out = [] if _out is None else _out
    for item in calls:
        if isinstance(item, (KernelCall, CommCall)):
            out.append((item, weight * item.count))
        else:  # (label, reps, sub-sequence) group
            _, reps, seq = item
            flatten_calls(seq, weight * reps, out)
    return out


class UntrainedFamilyError(RuntimeError):
    """Raised when a backend is asked to predict a kernel family it has no
    model for and the fallback policy is ``"error"`` (the default — silent
    oracle substitution hid real coverage gaps, see ISSUE 2)."""

    def __init__(self, backend: str, kind: str, supported: Iterable[str]) -> None:
        self.backend = backend
        self.kind = kind
        self.supported = sorted(supported)
        super().__init__(
            f"predictor {backend!r} has no model for kernel family {kind!r} "
            f"(trained families: {self.supported}); pass "
            f'fallback="oracle" or fallback="roofline" to get_predictor() '
            f"for an explicit substitute, or train the missing family"
        )


@dataclasses.dataclass
class Estimate:
    """Batched prediction result.

    ``theoretical_s`` is the analytical ceiling (sum of per-call
    dominant-pipe roofline times); it is ``None`` only for the legacy
    two-lambda adapter, which has no feature analyzer to ask.
    ``fallbacks`` records which families were served by a substitute
    backend (explicit-fallback policy) — empty when every family had a
    model.

    ``overlap_window_s`` is the cross-pipeline exposed-compute window
    (``repro_torch.core.features.overlap_window_s``): the kernel time the
    network can hide under when collectives launch as early as their
    operands exist. ``total_s`` is still the *additive* (serialized)
    sum — :meth:`overlapped` re-prices with the window subtracted from
    the comm component, bounded below by pure compute.
    """

    total_s: float
    kernel_s: float
    comm_s: float
    theoretical_s: Optional[float]
    by_family: dict
    by_comm_op: dict
    n_kernel_calls: float
    n_comm_calls: float
    fallbacks: dict
    #: exposed-compute window the comm can hide under (None for backends
    #: that cannot derive it, e.g. the legacy two-lambda adapter)
    overlap_window_s: Optional[float] = None

    def scaled(self, k: float) -> "Estimate":
        """Scale every latency component by ``k`` (e.g. the pipeline
        bubble surcharge); call counts and fallback records are kept."""
        return Estimate(
            total_s=self.total_s * k,
            kernel_s=self.kernel_s * k,
            comm_s=self.comm_s * k,
            theoretical_s=None if self.theoretical_s is None else self.theoretical_s * k,
            by_family={f: t * k for f, t in self.by_family.items()},
            by_comm_op={o: t * k for o, t in self.by_comm_op.items()},
            n_kernel_calls=self.n_kernel_calls,
            n_comm_calls=self.n_comm_calls,
            fallbacks=dict(self.fallbacks),
            overlap_window_s=(
                None if self.overlap_window_s is None else self.overlap_window_s * k
            ),
        )

    def overlapped(self, window_s: Optional[float] = None) -> "Estimate":
        """Overlap-aware re-pricing: per-step comm becomes
        ``max(0, comm_s - window)`` instead of additive.

        ``window_s`` defaults to the estimate's own ``overlap_window_s``
        (falling back to 0.0 — i.e. the additive estimate — when the
        backend could not derive one). The window never exceeds
        ``kernel_s`` by construction, so the overlapped total is always
        bounded: ``kernel_s <= total_s' <= kernel_s + comm_s`` — never
        below pure compute, never above the additive estimate (the
        regression ``tests``/``bench_parallelism`` gate). The per-op
        breakdown is rescaled proportionally so it still sums to the
        exposed comm time.
        """
        w = self.overlap_window_s if window_s is None else window_s
        w = 0.0 if w is None else min(max(w, 0.0), self.kernel_s)
        exposed = max(0.0, self.comm_s - w)
        shrink = exposed / self.comm_s if self.comm_s > 0 else 0.0
        return Estimate(
            total_s=self.kernel_s + exposed,
            kernel_s=self.kernel_s,
            comm_s=exposed,
            theoretical_s=self.theoretical_s,
            by_family=dict(self.by_family),
            by_comm_op={o: t * shrink for o, t in self.by_comm_op.items()},
            n_kernel_calls=self.n_kernel_calls,
            n_comm_calls=self.n_comm_calls,
            fallbacks=dict(self.fallbacks),
            overlap_window_s=w,
        )

    def pretty(self) -> str:
        parts = [f"total={self.total_s*1e3:.2f}ms"]
        if self.theoretical_s is not None:
            parts.append(f"ceiling={self.theoretical_s*1e3:.2f}ms")
        fams = sorted(self.by_family.items(), key=lambda kv: -kv[1])
        parts += [f"{f}={t*1e3:.2f}ms" for f, t in fams]
        parts += [f"{o}={t*1e3:.2f}ms" for o, t in sorted(self.by_comm_op.items())]
        if self.fallbacks:
            parts.append("fallbacks=" + ",".join(f"{k}->{v}" for k, v in sorted(self.fallbacks.items())))
        return "  ".join(parts)


@runtime_checkable
class Predictor(Protocol):
    """What every backend implements: batched estimation over call
    sequences plus scalar conveniences for one-off queries."""

    def predict(self, calls: CallSeq) -> Estimate: ...

    def kernel_time(self, kind: str, X: dict) -> float: ...

    def comm_time(
        self, op: str, nbytes: float, n_units: int, skew: float = 0.0
    ) -> float: ...
