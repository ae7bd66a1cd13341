"""Serve-trace capture, ported from ``repro.serve.trace`` and held equal to
it: record the kernel-call sequence a serving run actually executes, in the
exact format the predict layer consumes.

The serving engines execute model steps; the decomposer models the
same steps as ``KernelCall``/``CommCall`` sequences (``core.e2e``). A
``TraceRecorder`` attached to an engine bridges the two: every executed
prefill/decode step appends one ``(label, 1.0, model_calls(...))`` group
with the *actual* shapes served (batch, query length, attended KV length),
so after a run

    rec = TraceRecorder()
    eng = ServeEngine(cfg, recorder=rec)
    ... serve ...
    SweepPredictor(hws, backend="roofline").predict(rec.calls())

prices the real workload on every registry TPU, driven by a live serving
trace instead of a synthetic request shape. The engines stamp each step
with its wall-clock on this machine, taken after a device sync
(:meth:`TraceRecorder.mark_measured`); ``serve.monitor`` pairs those
measured seconds with the predicted ones.

Recording contract (the reference's ``docs/serving.md``):

  * one group per executed engine step, in execution order;
  * ``B`` is the *launched* batch (the full lock-step slot pool for the
    continuous engine, not just active slots) — kernels are priced at the
    shapes the hardware actually runs;
  * ``kvlen`` is the longest *attended* KV span in the step — the
    decomposer's convention (``request_calls`` prices its Simpson decode
    samples the same way, and causal ``kv_eff`` in ``decompose_attention``
    assumes it), so recorded traces are directly comparable to synthetic
    request estimates and to the hwsim oracle. Note this is the logical
    span: the engines' masked decode attention physically sweeps the full
    padded cache, so comparisons against this process's wall-clock
    (rather than the oracle) would need padded-cache pricing;
  * labels are informational only (``prefill[...]``, ``decode@pos``,
    ``admit#rid``, ``tick[...]``); group weights are always 1.0 — a
    recorded step happened exactly once;
  * every step additionally carries a :class:`StepMeta` (shape + phase +
    active-sequence count) so downstream consumers — the placement
    layer's split-fleet routing, per-token cost objectives — can classify
    steps without parsing labels.

The recorder is deliberately cheap: it builds the nested call groups
(plain dataclasses) and never touches device memory.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.e2e import model_calls

#: step phases the placement layer understands; ``"other"`` is the
#: catch-all for pre-lowered escape-hatch steps with no declared phase
PHASES = ("prefill", "decode", "other")


def step_calls(
    cfg: ArchConfig,
    B: int,
    qlen: int,
    kvlen: int,
    tp: int = 1,
    pp: int = 1,
    *,
    pp_schedule: str = "gpipe",
    pp_interleave: int = 2,
    tuned: Optional[dict] = None,
) -> list:
    """Lower one engine step's shapes into the call sequence the recorder
    would record for them: the full ``model_calls`` lowering plus, at
    ``pp > 1``, the schedule's stage-boundary activation traffic.

    This is the single lowering both :meth:`TraceRecorder.record_step` and
    the residual monitor's re-lowering path
    (``repro_torch.serve.monitor.step_predicted_s``) use, which is what makes
    the round-trip exact: re-lowering a recorded :class:`StepMeta`'s
    shapes yields the same calls — hence the same prediction — as the
    group recorded live."""
    calls = model_calls(cfg, B, qlen, kvlen, tp, tuned)
    if pp > 1:
        from repro_torch.core.e2e import pp_boundary_hops
        from repro_torch.predict.api import CommCall

        boundary = pp_boundary_hops(pp, pp_schedule, pp_interleave) * (
            B * cfg.d_model * 2.0
        )
        calls.append(("pp_boundary", 1, [CommCall("p2p", boundary * qlen, 2)]))
    return calls


@dataclasses.dataclass(frozen=True)
class StepMeta:
    """Shape + scheduling metadata of one recorded engine step.

    ``B``/``qlen``/``kvlen`` are the *launched* shapes (padded batch,
    attended KV span — the recording contract above); ``active`` is how
    many of the ``B`` rows belong to live requests (== ``B`` for the
    simple batch engine, the in-flight count for the continuous engine's
    lock-step ticks). A decode step therefore generated ``active`` tokens.
    ``tp``/``pp`` are the parallel degrees the step was *recorded at*
    (the recorder's declared mesh — see :class:`TraceRecorder`).
    """

    label: str
    phase: str  # one of PHASES
    B: int
    qlen: int
    kvlen: int
    active: int
    #: resolved at record time: the engine's mesh degrees when the
    #: recorder is bound to a mesh-native engine, else the declared ones
    tp: int = 1
    pp: int = 1
    #: wall-clock seconds the step actually took, stamped by the engine
    #: via :meth:`TraceRecorder.mark_measured` (0.0 = not measured).
    #: Measured steps are the residual monitor's observations
    #: (``repro_torch.serve.monitor.trace_residuals``).
    measured_s: float = 0.0


@dataclasses.dataclass
class TraceRecorder:
    """Accumulates one nested call group per executed engine step, plus a
    parallel :class:`StepMeta` per step (``meta``).

    The parallel degrees a trace is *priced at* come from the engine it is
    attached to: an engine constructed with ``mesh=`` calls
    :meth:`bind_mesh` with its mesh's "model"/"pipe" axis sizes, and every
    recorded step lowers at those degrees — the trace then carries the TP
    all-reduces/all-gathers, the MoE expert-parallel dispatch/combine
    all-to-alls (byte-exact — ``core.e2e.layer_calls``) and the PP
    stage-boundary activations of the mesh the engine actually runs on.
    Recorded traces therefore price collective costs through
    ``SweepPredictor``/``FleetRouter`` exactly like synthetic
    ``request_calls`` do.

    Caller-declared degrees (``TraceRecorder(tp=4, pp=2)``) are kept as a
    *deprecation shim* for pricing a single-process run at a hypothetical
    mesh; they apply only when no engine mesh is bound. When a declared
    degree conflicts with a bound mesh, the mesh wins and a
    ``DeprecationWarning`` is raised — the engine's reality is
    authoritative. A per-step ``tp=`` argument to :meth:`record_step`
    overrides both."""

    steps: list = dataclasses.field(default_factory=list)
    meta: list = dataclasses.field(default_factory=list)
    #: declared degrees (deprecation shim); ``None`` = inherit from the
    #: engine's mesh (1 when the engine has none)
    tp: Optional[int] = None
    pp: Optional[int] = None
    #: pipeline schedule the PP boundary traffic is recorded for
    pp_schedule: str = "gpipe"
    pp_interleave: int = 2
    #: autotuned kernel block table (``repro_torch.tune.TunedConfigs.for_hw(hw)``:
    #: kernel family -> block kwargs); recorded steps lower with these
    #: blocks merged into matching kernel calls, so the trace prices the
    #: tuned engine, not the default one
    tuned: Optional[dict] = None
    _mesh_tp: Optional[int] = dataclasses.field(default=None, init=False, repr=False)
    _mesh_pp: Optional[int] = dataclasses.field(default=None, init=False, repr=False)

    def bind_mesh(self, tp: int, pp: int = 1) -> None:
        """Bind the recorder to an engine's actual mesh degrees. Called by
        engines constructed with ``mesh=``; callers never need to. Bound
        degrees are authoritative: a conflicting declared ``tp=``/``pp=``
        raises a ``DeprecationWarning`` and loses."""
        if (self.tp not in (None, tp)) or (self.pp not in (None, pp)):
            warnings.warn(
                f"TraceRecorder declared tp={self.tp}/pp={self.pp} but the "
                f"engine's mesh runs tp={tp}/pp={pp}; the mesh wins. "
                "Declared degrees are deprecated for mesh-native engines — "
                "drop them and let the recorder inherit from the engine.",
                DeprecationWarning,
                stacklevel=3,
            )
        self._mesh_tp, self._mesh_pp = int(tp), int(pp)

    @property
    def resolved_tp(self) -> int:
        """The TP degree steps record at: engine-mesh bound > declared > 1."""
        if self._mesh_tp is not None:
            return self._mesh_tp
        return 1 if self.tp is None else self.tp

    @property
    def resolved_pp(self) -> int:
        if self._mesh_pp is not None:
            return self._mesh_pp
        return 1 if self.pp is None else self.pp

    def record_step(
        self,
        label: str,
        cfg: ArchConfig,
        B: int,
        qlen: int,
        kvlen: int,
        tp: Optional[int] = None,
        *,
        phase: Optional[str] = None,
        active: Optional[int] = None,
    ) -> None:
        """Record one executed step as the decomposer's call sequence for
        its shapes (all layers + LM head, the ``model_calls`` lowering),
        at the recorder's resolved parallel degrees (``tp`` overrides).

        ``phase`` defaults to the shape heuristic ``qlen > 1 -> prefill``;
        engines should pass it explicitly (a 1-token-prompt admission is
        still a prefill). ``active`` defaults to ``B``. When the resolved
        ``pp > 1`` the step additionally carries its stage-boundary
        activation traffic (``qlen`` tokens across the schedule's boundary
        hops — the same convention as ``request_calls``)."""
        if phase is None:
            phase = "prefill" if qlen > 1 else "decode"
        if phase not in PHASES:
            raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
        tp = self.resolved_tp if tp is None else tp
        pp = self.resolved_pp
        calls = step_calls(cfg, B, qlen, kvlen, tp, pp,
                           pp_schedule=self.pp_schedule,
                           pp_interleave=self.pp_interleave, tuned=self.tuned)
        self.steps.append((label, 1.0, calls))
        self.meta.append(
            StepMeta(label, phase, B, qlen, kvlen,
                     B if active is None else active, tp, pp)
        )

    def record(self, label: str, calls: list, *, phase: str = "other") -> None:
        """Record a pre-lowered call group (escape hatch for custom steps,
        e.g. PP boundary traffic an engine adds itself). Shapes are
        unknown, so the meta row carries zeros and phase ``"other"``
        unless declared."""
        if phase not in PHASES:
            raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
        self.steps.append((label, 1.0, calls))
        self.meta.append(StepMeta(label, phase, 0, 0, 0, 0))

    def mark_measured(self, seconds: float) -> None:
        """Stamp the most recently recorded step with its measured
        wall-clock (engines call this right after timing the step; the
        pairing of measured seconds with the step's predicted calls is
        what the residual monitor consumes). No-op refinements are
        rejected: there must be a step to stamp."""
        if not self.meta:
            raise RuntimeError("mark_measured with no recorded step")
        if not seconds >= 0:
            raise ValueError(f"measured seconds must be >= 0, got {seconds}")
        self.meta[-1] = dataclasses.replace(self.meta[-1], measured_s=float(seconds))

    def calls(self) -> list:
        """The recorded trace as one nested call sequence — feed directly
        to ``Predictor.predict`` / ``SweepPredictor.predict``."""
        return list(self.steps)

    def labels(self) -> list:
        return [label for label, _, _ in self.steps]

    def phases(self) -> list:
        """Per-step phase tags, parallel to ``labels()``."""
        return [m.phase for m in self.meta]

    def split_calls(self) -> dict:
        """The trace partitioned by phase: ``{"prefill": [...steps...],
        "decode": [...]}`` (phases with no steps are omitted). Each value
        is a valid call sequence — this is the input shape
        ``FleetRouter.route_split`` consumes to place workload classes on
        different hardware."""
        out: dict = {}
        for step, m in zip(self.steps, self.meta):
            out.setdefault(m.phase, []).append(step)
        return out

    @property
    def decode_tokens(self) -> int:
        """Tokens generated by the recorded *decode* steps only (sum of
        active rows per decode tick). Each prefill also samples one token
        per active row, so the total output is :attr:`generated_tokens`."""
        return sum(m.active for m in self.meta if m.phase == "decode")

    @property
    def prefill_tokens(self) -> int:
        """First tokens sampled from recorded prefill steps (one per
        active row of each prefill/admission)."""
        return sum(m.active for m in self.meta if m.phase == "prefill")

    @property
    def generated_tokens(self) -> int:
        """Every token the recorded run produced: prefill-sampled first
        tokens plus decode-tick tokens. For a full request of ``lout``
        output tokens this matches the synthetic ``B * lout`` convention
        of ``place_request`` — the ``n_tokens`` per-token cost objectives
        should use."""
        return self.prefill_tokens + self.decode_tokens

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    def clear(self) -> None:
        self.steps.clear()
        self.meta.clear()
