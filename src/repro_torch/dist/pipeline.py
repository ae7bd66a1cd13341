"""Pipeline-parallel schedule analytics, ported from ``repro.dist.pipeline``:
the exact tick counts and bubble fractions of the GPipe, interleaved-1F1B
and zero-bubble ZB-H1 schedules, which ``core.e2e.pp_bubble`` prices
requests with. Pure Python, held equal to the reference.

All schedules stream microbatches around a ring of ``S`` pipeline stages.
GPipe runs ``M + S - 1`` ticks for ``M`` microbatches; the ring schedules
hold one in-flight microbatch per device for its whole lifecycle ``L``
(``V*S`` chunk-ticks for 1F1B with ``V = interleave`` chunks a device,
``3*V*S`` for ZB-H1's F/B/W phases) and run ``L * ceil(M/S) + (M-1) mod S``
ticks. :func:`simulate_schedule` re-derives the count by stepping the ring
event by event; the reference's property tests hold the two equal.

The executed schedules (:func:`pipeline_forward`) run the same rings over
a ``torch.distributed`` process group: every rank of the mesh's ``pipe``
dim holds its stage's layers, and each tick ends with one point-to-point
exchange to the next stage (``batch_isend_irecv``), the counterpart of the
reference's ``shard_map`` + ``ppermute``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_leaves, tree_map

__all__ = [
    "pipeline_forward",
    "pipeline_bubble_fraction",
    "schedule_ticks",
    "bubble_fraction",
    "simulate_schedule",
    "SCHEDULES",
]

#: schedules schedule_ticks / bubble_fraction / simulate_schedule understand
SCHEDULES = ("gpipe", "1f1b", "zb-h1")

#: lifecycle phases per ring slot: 1F1B runs forward only (F); ZB-H1 adds
#: the B (input-grad) and W (weight-grad) occupancy phases — 3x the
#: per-microbatch chunk-ticks on the same slot machine
_PHASES = {"gpipe": 1, "1f1b": 1, "zb-h1": 3}


def _check_schedule(schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got {schedule!r}")


def schedule_ticks(
    n_stages: int, n_micro: int, schedule: str = "gpipe", interleave: int = 2
) -> int:
    """Exact ring-tick count of the executed schedule (the length of the
    reference's ``pipeline_forward`` scan).

    GPipe: ``M + S - 1``. The ring schedules hold at most ``S`` in-flight
    microbatches (one slot per device); a microbatch occupies its slot
    for its full lifecycle ``L`` and a new one can enter stage 0 only
    when the incoming slot is free — giving

        ``L * ceil(M/S) + (M-1) mod S``

    with ``L = V*S`` for interleaved 1F1B (``V*M + S - 1`` when ``S``
    divides ``M``, the Megatron interleaved form) and ``L = 3*V*S`` for
    ZB-H1 (the F/B/W three-phase lifecycle; ``3M + S - 1`` at ``V = 1``
    and ``S | M``, the canonical ZB-H1 makespan). With ``interleave=1``
    the 1F1B count degenerates to GPipe's ``M + S - 1`` — the ring is
    the same machine. Note a ring tick is ``1/V`` of a GPipe tick (a
    chunk is ``1/V`` of a stage); :func:`bubble_fraction` normalizes for
    that.
    """
    _check_schedule(schedule)
    S, M = int(n_stages), int(n_micro)
    if S < 1 or M < 1:
        raise ValueError(f"need n_stages >= 1 and n_micro >= 1, got {S}, {M}")
    if schedule == "gpipe":
        return M + S - 1
    V = int(interleave)
    if V < 1:
        raise ValueError(f"interleave must be >= 1, got {V}")
    return _PHASES[schedule] * V * S * math.ceil(M / S) + (M - 1) % S


def bubble_fraction(
    n_stages: int, n_micro: int, schedule: str = "gpipe", interleave: int = 2
) -> float:
    """Idle fraction of the schedule: ``1 - ideal_work / ticks``.

    Per-device ideal work is ``M`` stage-ticks for GPipe, ``V*M``
    chunk-ticks for 1F1B and ``3*V*M`` for ZB-H1 (F + B + W are all
    useful per-device compute; a chunk-tick is ``1/V`` of a stage-tick),
    so the fractions are directly comparable across schedules. For all
    ``(S, M >= 1)``: the 1F1B fraction is <= GPipe's, strictly smaller
    whenever ``S > 1``, ``interleave >= 2`` and ``M mod S != 1`` (at
    ``M ≡ 1 (mod S)`` the straggler microbatch drains alone under both
    schedules and they tie); and the ZB-H1 fraction is <= 1F1B's at the
    same ``V``, strictly smaller exactly when ``(M - 1) mod S != 0`` —
    pinned by the property tests in ``tests/test_parallelism.py`` and
    ``tests/test_zero_bubble.py``.
    """
    ticks = schedule_ticks(n_stages, n_micro, schedule, interleave)
    V = 1 if schedule == "gpipe" else int(interleave)
    work = n_micro * V * _PHASES[schedule]
    return (ticks - work) / ticks


def pipeline_bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle fraction of the GPipe schedule (fill + drain). Kept for
    backward compatibility; equals ``bubble_fraction(S, M, "gpipe")``."""
    return bubble_fraction(n_stages, n_micro, "gpipe")


def simulate_schedule(
    n_stages: int, n_micro: int, schedule: str = "gpipe", interleave: int = 2
) -> int:
    """Event-driven reference simulation of the activation ring.

    Steps the exact machine the reference's ``pipeline_forward`` implements — one
    in-flight slot per device, stage-0 injection only into a free slot,
    one lifecycle tick per ring tick, then a ring shift — and returns the
    tick at which the **last** microbatch completes. For ZB-H1 a slot's
    lifecycle spans the three phases (``g // (V*S)`` is 0 during F, 1
    during B, 2 during W); occupancy and completion are what set the tick
    count, so the same machine covers all ring schedules. This is an
    independent derivation of :func:`schedule_ticks` (no shared
    arithmetic); the property tests assert simulation == closed form for
    every schedule across the whole ``(S, M, V)`` grid, which is what
    licenses using the closed form as the analytical bubble model in
    ``core.e2e``.
    """
    _check_schedule(schedule)
    S, M = int(n_stages), int(n_micro)
    V = int(interleave) if schedule != "gpipe" else 1
    total_stages = _PHASES[schedule] * V * S
    slots: list = [None] * S  # per-device in-flight (microbatch, next stage)
    next_m = done = ticks = 0
    while done < M:
        if slots[0] is None and next_m < M:
            slots[0] = (next_m, 0)  # stage-0 injection into the free slot
            next_m += 1
        shifted: list = [None] * S
        for d in range(S):
            if slots[d] is None:
                continue
            m, g = slots[d]
            assert g % S == d, "chunk placement invariant: stage g lives on g mod S"
            g += 1
            if g == total_stages:
                done += 1  # finished on device S-1; slot recycles via the ring
            else:
                shifted[(d + 1) % S] = (m, g)
        slots = shifted
        ticks += 1
    return ticks



# ----------------------------------------------------------------------
# executed schedules (process-group point-to-point rings)
# ----------------------------------------------------------------------


class _Ring:
    """The ``pipe`` dim of a mesh as a ring: this rank's stage, the stage
    count, and one tick's exchange with the neighbours (send to the next
    stage, receive from the previous one)."""

    def __init__(self, mesh, axis: Optional[str]):
        axis = axis or mesh.mesh_dim_names[0]
        self.group = mesh.get_group(axis)
        self.n = mesh.size(mesh.mesh_dim_names.index(axis))
        self.stage = mesh.get_local_rank(axis)
        self._next = dist.get_global_rank(self.group, (self.stage + 1) % self.n)
        self._prev = dist.get_global_rank(self.group, (self.stage - 1) % self.n)

    def shift(self, *tensors):
        """Each tensor as the previous stage held it (``ppermute`` by one)."""
        if self.n == 1:
            return tensors
        out = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t.contiguous(), self._next, self.group) for t in tensors]
        ops += [dist.P2POp(dist.irecv, o, self._prev, self.group) for o in out]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return tuple(out)

    def from_last(self, outputs):
        """The last stage's ``outputs`` on every rank (the reference's
        ``psum`` of the outputs masked to the last stage)."""
        out = outputs if self.stage == self.n - 1 else torch.zeros_like(outputs)
        if self.n > 1:
            dist.all_reduce(out, group=self.group)
        return out


def _n_layers(params) -> int:
    return tree_leaves(params)[0].shape[0]


def _apply_layers(layer_fn, params, lo: int, hi: int, h):
    for i in range(lo, hi):
        h = layer_fn(tree_map(lambda p: p[i], params), h)
    return h


def pipeline_forward(
    layer_fn: Callable,
    params: Any,
    x: torch.Tensor,
    mesh,
    axis: Optional[str] = None,
    *,
    schedule: str = "gpipe",
    interleave: int = 2,
    ticks: Optional[int] = None,
):
    """Run a stacked layer tree as a pipeline over ``mesh``'s ``axis`` (a
    ``DeviceMesh``; default: its first dim), one stage a rank.

    Schedule contract (the reference's):

    * ``schedule="gpipe"`` (default): one contiguous stage per rank;
      ``n_layers`` must divide by the pipeline size ``S``. Runs exactly
      ``schedule_ticks(S, M, "gpipe")`` ticks.
    * ``schedule="1f1b"``: interleaved virtual stages, global chunk
      ``g = j * S + d`` on rank ``d``; ``n_layers`` must divide by
      ``S * interleave``. Runs exactly ``schedule_ticks(S, M, "1f1b",
      interleave)`` ticks, for any ``M >= 1``.
    * ``schedule="zb-h1"``: the zero-bubble three-phase ring; chunks are
      applied during the F phase (lifecycle ticks ``< V*S``), the B/W
      phases carry the finished activation as occupancy ticks. Runs exactly
      ``schedule_ticks(S, M, "zb-h1", interleave)`` ticks.

    ``layer_fn(layer_params, h) -> h`` runs one layer on one microbatch;
    ``params`` is a tree of ``(n_layers, ...)`` tensors and ``x`` is
    ``(n_micro, ...)``, both the same on every rank. ``ticks`` overrides
    the tick count (one short must leave the last microbatch unfinished).
    Returns the ``(n_micro, ...)`` outputs on every rank, equal to running
    every layer over each microbatch in order."""
    _check_schedule(schedule)
    ring = _Ring(mesh, axis)
    if schedule in ("1f1b", "zb-h1"):
        return _forward_ring(layer_fn, params, x, ring, interleave, ticks, schedule)
    return _forward_gpipe(layer_fn, params, x, ring, ticks)


def _forward_gpipe(layer_fn, params, x, ring: _Ring, ticks=None):
    S, stage = ring.n, ring.stage
    n_layers = _n_layers(params)
    if n_layers % S != 0:
        raise ValueError(f"{n_layers} layers not divisible into {S} stages")
    per = n_layers // S
    n_micro = x.shape[0]
    n_ticks = schedule_ticks(S, n_micro, "gpipe") if ticks is None else ticks
    state, outputs = torch.zeros_like(x[0]), torch.zeros_like(x)
    for t in range(n_ticks):
        # stage 0 ingests microbatch t while the schedule is filling
        h = x[min(t, n_micro - 1)] if stage == 0 and t < n_micro else state
        y = _apply_layers(layer_fn, params, stage * per, (stage + 1) * per, h)
        # the last stage finishes microbatch t - (S - 1) at tick t
        if stage == S - 1 and t >= S - 1:
            outputs[min(t - (S - 1), n_micro - 1)] = y
        (state,) = ring.shift(y)
    return ring.from_last(outputs)


def _forward_ring(layer_fn, params, x, ring: _Ring, interleave, ticks=None,
                  schedule="1f1b"):
    S, stage = ring.n, ring.stage
    V = int(interleave)
    if V < 1:
        raise ValueError(f"interleave must be >= 1, got {V}")
    n_layers = _n_layers(params)
    if n_layers % (S * V) != 0:
        raise ValueError(f"{n_layers} layers not divisible into {S} stages x "
                         f"{V} interleaved chunks")
    per_chunk = n_layers // (S * V)
    n_micro = x.shape[0]
    # forward chunk-stages apply layers; ZB-H1 extends the slot lifecycle
    # with the B/W occupancy phases (chunks applied only while g < V*S)
    forward_stages = V * S
    total_stages = _PHASES[schedule] * forward_stages
    n_ticks = schedule_ticks(S, n_micro, schedule, V) if ticks is None else ticks

    h = torch.zeros_like(x[0])
    # the held slot: next global chunk-stage g, microbatch m, occupancy live
    slot = torch.zeros(3, dtype=torch.int64, device=x.device)
    next_m = 0  # injection counter (meaningful on stage 0 only)
    outputs = torch.zeros_like(x)
    for _ in range(n_ticks):
        g, m, live = (int(v) for v in slot.tolist())
        # stage-0 injection: only into a free (non-live) incoming slot
        if stage == 0 and not live and next_m < n_micro:
            h, g, m, live = x[next_m], 0, next_m, 1
            next_m += 1
        if live and g < forward_stages:
            # round-robin placement: chunk j of this rank is global chunk j*S + stage
            chunk = min(g // S, V - 1) * S + stage
            h = _apply_layers(layer_fn, params, chunk * per_chunk, (chunk + 1) * per_chunk, h)
        g += 1
        # the final lifecycle tick (g == phases*V*S) lands on rank S-1
        if live and g >= total_stages:
            outputs[min(m, n_micro - 1)] = h
            live = 0
        slot = torch.tensor([g, m, live], dtype=torch.int64, device=x.device)
        h, slot = ring.shift(h, slot)
    return ring.from_last(outputs)
