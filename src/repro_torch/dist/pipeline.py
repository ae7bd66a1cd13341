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

Only the analytic half is here. The executed schedules
(``pipeline_forward`` over ``shard_map`` and collective permutes in the
reference) come with the port's distribution slice, over
``torch.distributed`` point-to-point sends; this module imports no
collectives.
"""
from __future__ import annotations

import math

__all__ = [
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

