"""Fleet-scale queueing simulation, ported from ``repro.serve.fleet`` and
held equal to it: replay large request streams through a
``FleetRouter`` placement with real queueing delay.

The placement layer prices a workload in isolation — one request, empty
fleet. Real serving latency is dominated by *waiting*: requests arrive in
bursts, replicas are busy, queues build. :class:`FleetSimulator` closes
that gap with a discrete-event simulation on top of the predict stack:

  * each :class:`WorkloadClass` (a named request shape: cfg, B, lin, lout,
    parallel degrees, mix weight) is lowered to its ``request_calls``
    sequence and routed through a shared :class:`FleetRouter` pass
    (``route_many`` — one warmed ``FeatureCache`` across classes). The
    class's *service time* on its assigned hardware is the placement row's
    ``total_s`` (PP bubble surcharge included) — the ``SweepPredictor``
    path end to end;
  * :meth:`FleetSimulator.replay` then streams arrivals (Poisson via
    :func:`poisson_arrivals`, or recorded timestamps) through per-hardware
    FIFO replica pools (:func:`simulate_queue`) and reports queue-aware
    fleet metrics: p50/p95/p99/mean latency, waiting time and utilization
    per hardware (:class:`FleetReport`);
  * an optional :class:`AutoscalePolicy` adjusts each pool's replica count
    at fixed arrival-rate windows — the predicted-autoscaling hook:
    desired replicas = arrival rate x predicted service time / target
    utilization.

Exactness anchors: a
request entering an empty fleet waits zero, so its simulated latency *is*
the isolated placement estimate (bit-for-bit — the simulator adds queueing
on top of the predict path, it never re-derives service times); and p95
latency is monotone in arrival rate under common random numbers (same
seed, arrival times scaled by 1/rate).

The simulator is pure host-side Python/NumPy over predicted seconds — it
never touches device memory, so replaying 1e5–1e6 requests takes seconds.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.e2e import pp_bubble, request_calls
from repro_torch.predict.sweep import check_prebuilt_exclusive
from repro_torch.serve.monitor import drift_factor, resolve_drift
from repro_torch.serve.placement import FleetRouter, Placement


@dataclasses.dataclass(frozen=True)
class WorkloadClass:
    """One request shape in the traffic mix: the synthetic-request
    convention of ``place_request`` (``B`` sequences of ``lin`` prompt +
    ``lout`` output tokens at the given parallel degrees), plus a mix
    ``weight`` — the relative share of arrivals drawn from this class."""

    name: str
    cfg: ArchConfig
    B: int = 1
    lin: int = 128
    lout: int = 16
    tp: int = 1
    pp: int = 1
    pp_schedule: str = "gpipe"
    pp_microbatches: Optional[int] = None
    pp_interleave: int = 2
    weight: float = 1.0

    def calls(self) -> list:
        return request_calls(
            self.cfg, self.B, self.lin, self.lout, tp=self.tp, pp=self.pp,
            pp_schedule=self.pp_schedule, pp_interleave=self.pp_interleave,
        )

    def bubble(self) -> float:
        return pp_bubble(self.pp, self.pp_microbatches, self.pp_schedule,
                         self.pp_interleave)

    @property
    def n_tokens(self) -> int:
        return self.B * self.lout


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Predicted autoscaling: at every ``window_s`` boundary, size the
    replica pool to the window's observed arrival rate —

        desired = ceil(rate x mean predicted service / target_utilization)

    clipped to ``[min_replicas, max_replicas]``. Service times are the
    predict path's, so the policy scales on *predicted* load, before
    queues actually build (the fleet analogue of predicted admission)."""

    window_s: float
    target_utilization: float = 0.7
    min_replicas: int = 1
    max_replicas: int = 64


def poisson_arrivals(rate_rps: float, n: int, seed: int = 0) -> np.ndarray:
    """``n`` Poisson arrival times (seconds, sorted) at ``rate_rps``.

    Uses one exponential draw per gap under a fixed seed, so two streams
    at different rates with the same seed are *scaled copies* of each
    other — the common-random-numbers construction that makes simulated
    latency percentiles monotone in arrival rate."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_rps, size=n))


def simulate_queue(
    arrivals: np.ndarray,
    service_s: np.ndarray,
    replicas: int = 1,
    autoscale: Optional[AutoscalePolicy] = None,
):
    """FIFO multi-replica queue: each request starts on the
    earliest-free replica, no earlier than its arrival.

    Returns ``(starts, trajectory, capacity_s)``: per-request service
    start times, the replica-count trajectory ``[(t, n), ...]`` (constant
    ``[(0, replicas)]`` without autoscaling), and the integrated capacity
    ``sum(n x dt)`` up to the last completion — the denominator of
    utilization. O(n log replicas) via a heap of replica-free times.

    With ``autoscale``, the pool is resized at every ``window_s`` boundary
    from the previous window's arrival rate and mean service time;
    shrinking retires the earliest-free replicas first.
    """
    arrivals = np.asarray(arrivals, float)
    service_s = np.asarray(service_s, float)
    n = len(arrivals)
    starts = np.empty(n, float)
    free = [0.0] * int(replicas)  # next-free time per replica
    heapq.heapify(free)
    traj = [(0.0, len(free))]

    boundary = autoscale.window_s if autoscale is not None else math.inf
    win_count, win_service = 0, 0.0
    for i in range(n):
        a = arrivals[i]
        while a >= boundary:  # autoscale only; inf never triggers
            rate = win_count / autoscale.window_s
            mean_svc = win_service / win_count if win_count else 0.0
            desired = max(
                autoscale.min_replicas,
                min(
                    autoscale.max_replicas,
                    math.ceil(rate * mean_svc / autoscale.target_utilization)
                    if win_count
                    else autoscale.min_replicas,
                ),
            )
            while len(free) < desired:
                heapq.heappush(free, boundary)
            while len(free) > desired:
                heapq.heappop(free)
            traj.append((boundary, len(free)))
            win_count, win_service = 0, 0.0
            boundary += autoscale.window_s
        win_count += 1
        win_service += service_s[i]
        t = heapq.heappop(free)
        start = a if a >= t else t
        starts[i] = start
        heapq.heappush(free, start + service_s[i])

    horizon = max(free) if n else 0.0  # last completion across replicas
    capacity = 0.0
    for (t0, c), (t1, _) in zip(traj, traj[1:] + [(horizon, 0)]):
        capacity += c * max(min(t1, horizon) - t0, 0.0)
    return starts, traj, capacity


@dataclasses.dataclass
class HardwareLoad:
    """Queue-aware serving metrics of one hardware pool in the fleet."""

    hw: str
    classes: list  # workload-class names routed here
    n_requests: int
    replicas: int  # initial pool size
    final_replicas: int
    latency_p50_s: float
    latency_p95_s: float
    latency_p99_s: float
    latency_mean_s: float
    wait_mean_s: float
    utilization: float  # busy seconds / integrated capacity
    busy_s: float
    replica_traj: list  # [(t, n), ...]


@dataclasses.dataclass(frozen=True)
class RerouteEvent:
    """One mid-replay re-route of the drift control loop: the monitor
    tripped on request ``index`` (completion time ``t``), the tripping
    ``(cls, hw)`` key's EWMA residual deviated by ``deviation``, and the
    fleet was re-routed under the per-hw ``corrections`` (cumulative
    residual factors) — ``old_assignment`` -> ``new_assignment``."""

    index: int  # arrival-order index of the tripping request
    t: float  # completion time of the tripping request (sim seconds)
    cls: str  # workload class whose residual tripped
    hw: str  # hardware the tripping residual was measured on
    deviation: float  # |ewma residual - 1| at trip time
    corrections: dict  # hw -> correction factor applied at this re-route
    old_assignment: dict  # class -> hw before
    new_assignment: dict  # class -> hw after

    @property
    def changed(self) -> bool:
        """True when the re-route actually moved at least one class."""
        return self.old_assignment != self.new_assignment


@dataclasses.dataclass
class FleetReport:
    """One replayed stream's fleet metrics. ``latencies`` is the raw
    per-request latency array (arrival to completion, predicted seconds on
    the assigned hardware) for downstream analysis. ``reroutes`` is the
    drift control loop's re-route log (empty without ``monitor=``, and for
    any replay where no sustained drift tripped); ``assignment`` is the
    assignment in effect at the *end* of the replay — it differs from the
    simulator's frozen one exactly when a logged re-route changed it."""

    assignment: dict  # class name -> hw name
    per_hw: dict  # hw name -> HardwareLoad
    n_requests: int
    horizon_s: float  # last completion
    latency_p50_s: float
    latency_p95_s: float
    latency_p99_s: float
    latency_mean_s: float
    latencies: np.ndarray = dataclasses.field(repr=False, default=None)
    #: RerouteEvent log, in trip order (drift control loop)
    reroutes: list = dataclasses.field(default_factory=list)

    def table(self) -> str:
        lines = [
            f"{'hardware':<14} {'classes':<18} {'reqs':>8} {'repl':>5} "
            f"{'util':>6} {'p50':>10} {'p95':>10} {'p99':>10}"
        ]
        for hw, load in sorted(self.per_hw.items()):
            repl = (
                str(load.replicas)
                if load.final_replicas == load.replicas
                else f"{load.replicas}->{load.final_replicas}"
            )
            lines.append(
                f"{hw:<14} {','.join(load.classes):<18} {load.n_requests:>8} "
                f"{repl:>5} {load.utilization:>6.1%} "
                f"{load.latency_p50_s*1e3:>8.2f}ms {load.latency_p95_s*1e3:>8.2f}ms "
                f"{load.latency_p99_s*1e3:>8.2f}ms"
            )
        return "\n".join(lines)


class FleetSimulator:
    """Replay request streams through a routed fleet with queueing delay.

    Construction routes every workload class (``route_many`` on one shared
    router/cache) and freezes the assignment + per-class service times;
    :meth:`replay` is then pure host-side simulation — price once, replay
    many streams. ``replicas`` is an int (every pool) or a ``{hw: int}``
    mapping; ``autoscale`` (an :class:`AutoscalePolicy`) applies to every
    pool and can be overridden per replay."""

    def __init__(
        self,
        classes,
        *,
        router: Optional[FleetRouter] = None,
        hws=None,
        backend: str = "synperf",
        objective="latency",
        replicas=1,
        autoscale: Optional[AutoscalePolicy] = None,
        **backend_kw,
    ):
        if isinstance(classes, WorkloadClass):
            classes = [classes]
        if not classes:
            raise ValueError("FleetSimulator needs at least one WorkloadClass")
        names = [c.name for c in classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate workload-class names: {names}")
        self.classes = list(classes)
        check_prebuilt_exclusive("router", router, hws, backend, backend_kw)
        self.router = router if router is not None else FleetRouter(hws, backend, **backend_kw)
        # routing inputs are kept so the drift control loop can re-run
        # route_many mid-replay under residual-corrected service times
        self._objective = objective
        self._named_calls = {c.name: c.calls() for c in self.classes}
        self._n_tokens = {c.name: c.n_tokens for c in self.classes}
        self._scales = {c.name: c.bubble() for c in self.classes}
        #: class name -> Placement (full fleet ranking per class)
        self.placements: dict = self.router.route_many(
            self._named_calls,
            objective=objective,
            n_tokens=self._n_tokens,
            scales=self._scales,
        )
        #: class name -> assigned hardware (the placement's best entry)
        self.assignment = {name: p.best for name, p in self.placements.items()}
        pools = sorted(set(self.assignment.values()))
        # pools a re-route newly sends traffic to get this default size
        self._default_replicas = 1 if isinstance(replicas, dict) else int(replicas)
        self.replicas = (
            dict(replicas) if isinstance(replicas, dict)
            else {hw: int(replicas) for hw in pools}
        )
        self.autoscale = autoscale

    def pool_size(self, hw: str) -> int:
        """Replica count of one hardware pool (hardware the frozen
        assignment never used falls back to the scalar ``replicas=``
        default — a re-route can move traffic onto it)."""
        return self.replicas.get(hw, self._default_replicas)

    def service_s(self, cls_name: str, hw: Optional[str] = None) -> float:
        """Predicted isolated service time of one class on ``hw`` (its
        assigned hardware by default) — the placement row's ``total_s``."""
        return self.placements[cls_name][hw or self.assignment[cls_name]].total_s

    def saturation_rate_rps(self) -> float:
        """The total arrival rate at which the busiest pool reaches
        utilization 1 under the class mix — rates for an experiment are
        naturally expressed as fractions of this."""
        total_w = sum(c.weight for c in self.classes)
        load_per_rate: dict = {}
        for c in self.classes:
            hw = self.assignment[c.name]
            load_per_rate[hw] = load_per_rate.get(hw, 0.0) + (
                c.weight / total_w
            ) * self.service_s(c.name)
        return min(
            self.replicas[hw] / load for hw, load in load_per_rate.items()
        )

    def replay(
        self,
        arrivals=None,
        *,
        rate_rps: Optional[float] = None,
        n_requests: Optional[int] = None,
        seed: int = 0,
        class_ids=None,
        autoscale: Optional[AutoscalePolicy] = None,
        drift=None,
        monitor=None,
    ) -> FleetReport:
        """Replay one request stream and report queue-aware fleet metrics.

        Either pass recorded ``arrivals`` (seconds, any order — sorted
        internally) or ``rate_rps`` + ``n_requests`` for a Poisson stream.
        ``class_ids`` optionally pins each request's workload class (index
        into ``self.classes``); by default classes are drawn by weight
        under ``seed``.

        Drift control loop: ``drift=`` injects measured-vs-predicted drift
        (a ``serve.monitor.DriftSpec``, a list of them, or a ``{hw:
        factor}`` step shorthand) by multiplying the *true* service times
        on the drifted hardware while predictions stay frozen; ``monitor=``
        (a ``serve.monitor.ResidualMonitor``) observes every completion's
        measured-vs-predicted residual and, on a sustained trip, re-runs
        ``route_many`` under residual-corrected service times mid-replay —
        the fleet re-balances and the report's ``reroutes`` log says when
        and how. Either argument switches to the event-by-event control
        path; autoscaling composes with it (each pool resizes at its
        window boundaries from the window's *measured* rate and service
        times, the same rule as :func:`simulate_queue` — which prices
        drifted hardware at its drifted load, not the frozen prediction).
        With both ``None`` the vectorized frozen-assignment path is
        bit-identical to before."""
        if arrivals is None:
            if rate_rps is None or n_requests is None:
                raise ValueError(
                    "replay needs arrivals= (recorded) or rate_rps= + "
                    "n_requests= (Poisson)"
                )
            arrivals = poisson_arrivals(rate_rps, n_requests, seed)
        arrivals = np.sort(np.asarray(arrivals, float))
        n = len(arrivals)
        if class_ids is None:
            w = np.asarray([c.weight for c in self.classes], float)
            class_ids = np.random.default_rng(seed + 1).choice(
                len(self.classes), size=n, p=w / w.sum()
            )
        class_ids = np.asarray(class_ids)
        policy = self.autoscale if autoscale is None else autoscale
        if drift is not None or monitor is not None:
            return self._replay_controlled(
                arrivals, class_ids, drift, monitor, policy
            )
        svc_by_class = np.asarray(
            [self.service_s(c.name) for c in self.classes], float
        )
        svc = svc_by_class[class_ids]

        latencies = np.empty(n, float)
        per_hw: dict = {}
        horizon = 0.0
        hw_of_class = [self.assignment[c.name] for c in self.classes]
        for hw in sorted(set(hw_of_class)):
            cls_idx = [i for i, h in enumerate(hw_of_class) if h == hw]
            mask = np.isin(class_ids, cls_idx)
            if not mask.any():
                continue
            a, s = arrivals[mask], svc[mask]
            starts, traj, capacity = simulate_queue(
                a, s, self.replicas[hw], policy
            )
            lat = starts + s - a
            latencies[mask] = lat
            horizon = max(horizon, float((starts + s).max()))
            per_hw[hw] = HardwareLoad(
                hw=hw,
                classes=[self.classes[i].name for i in cls_idx],
                n_requests=int(mask.sum()),
                replicas=self.replicas[hw],
                final_replicas=traj[-1][1],
                latency_p50_s=float(np.percentile(lat, 50)),
                latency_p95_s=float(np.percentile(lat, 95)),
                latency_p99_s=float(np.percentile(lat, 99)),
                latency_mean_s=float(lat.mean()),
                wait_mean_s=float((starts - a).mean()),
                utilization=float(s.sum() / capacity) if capacity > 0 else 0.0,
                busy_s=float(s.sum()),
                replica_traj=traj,
            )
        return FleetReport(
            assignment=dict(self.assignment),
            per_hw=per_hw,
            n_requests=n,
            horizon_s=horizon,
            latency_p50_s=float(np.percentile(latencies, 50)),
            latency_p95_s=float(np.percentile(latencies, 95)),
            latency_p99_s=float(np.percentile(latencies, 99)),
            latency_mean_s=float(latencies.mean()),
            latencies=latencies,
        )

    # ------------------------------------------------------------------
    # drift control loop

    def _replay_controlled(
        self, arrivals, class_ids, drift, monitor, autoscale=None
    ) -> FleetReport:
        """Event-by-event replay with drift injection and/or residual
        monitoring (the production control loop, simulated).

        Per completion: the *measured* service time is the placement row's
        ``total_s`` times the injected drift factor at arrival time; the
        *predicted* one is the row's ``total_s`` times the cumulative
        correction already applied to that hardware (1.0 until a trip).
        The monitor observes that pair; when it trips, the fleet is
        re-routed under ``ResidualCorrectedObjective`` with the cumulative
        per-hw corrections, the event is logged, and the monitor resets —
        its history measured the *old* baseline. Without drift and with a
        quiet monitor this path reproduces the vectorized frozen replay
        exactly (same per-hw FIFO heaps, same arithmetic).

        ``autoscale`` (an :class:`AutoscalePolicy`) composes with the
        control loop: each pool tracks its own window boundaries on the
        absolute clock and resizes from the previous window's arrival
        rate and mean *measured* service time — the same resize rule as
        :func:`simulate_queue` (where measured == predicted, since that
        path has no drift), so drifted hardware is scaled for the load it
        actually serves."""
        from repro_torch.predict.objective import (
            ResidualCorrectedObjective,
            get_objective,
        )

        specs = resolve_drift(drift)
        for hw in specs:
            known = {r.hw for p in self.placements.values() for r in p.rows}
            if hw not in known:
                raise ValueError(
                    f"drift names hardware {hw!r} that no placement prices; "
                    f"priceable: {sorted(known)}"
                )
        base_obj = get_objective(self._objective)
        assignment = dict(self.assignment)
        cum_corr: dict = {}  # hw -> cumulative correction factor applied
        reroutes: list = []
        n = len(arrivals)
        latencies = np.empty(n, float)
        pools: dict = {}  # hw -> heap of replica next-free times
        # per-hw accumulators for the report
        acc: dict = {}  # hw -> dict(lat=[], wait=[], busy=0.0, classes=set)
        # per-hw autoscale state: next window boundary, window arrival
        # count / measured-service sum, replica trajectory
        boundary: dict = {}  # hw -> next resize time
        win_count: dict = {}
        win_service: dict = {}
        traj: dict = {}  # hw -> [(t, n), ...]

        for i in range(n):
            a = float(arrivals[i])
            c = self.classes[int(class_ids[i])]
            hw = assignment[c.name]
            pool = pools.get(hw)
            if pool is None:
                pool = [0.0] * self.pool_size(hw)
                heapq.heapify(pool)
                pools[hw] = pool
                traj[hw] = [(0.0, len(pool))]
                if autoscale is not None:
                    boundary[hw] = autoscale.window_s
                    win_count[hw], win_service[hw] = 0, 0.0
            while autoscale is not None and a >= boundary[hw]:
                b = boundary[hw]
                rate = win_count[hw] / autoscale.window_s
                mean_svc = (
                    win_service[hw] / win_count[hw] if win_count[hw] else 0.0
                )
                desired = max(
                    autoscale.min_replicas,
                    min(
                        autoscale.max_replicas,
                        math.ceil(
                            rate * mean_svc / autoscale.target_utilization
                        )
                        if win_count[hw]
                        else autoscale.min_replicas,
                    ),
                )
                while len(pool) < desired:
                    heapq.heappush(pool, b)
                while len(pool) > desired:
                    heapq.heappop(pool)
                traj[hw].append((b, len(pool)))
                win_count[hw], win_service[hw] = 0, 0.0
                boundary[hw] = b + autoscale.window_s
            base = self.placements[c.name][hw].total_s
            measured = base * drift_factor(specs, hw, a)
            predicted = base * cum_corr.get(hw, 1.0)
            if autoscale is not None:
                win_count[hw] += 1
                win_service[hw] += measured
            t_free = heapq.heappop(pool)
            start = a if a >= t_free else t_free
            done = start + measured
            heapq.heappush(pool, done)
            latencies[i] = done - a
            st = acc.get(hw)
            if st is None:
                st = acc[hw] = {"lat": [], "wait": [], "busy": 0.0,
                                "classes": set()}
            st["lat"].append(done - a)
            st["wait"].append(start - a)
            st["busy"] += measured
            st["classes"].add(c.name)
            if monitor is None:
                continue
            event = monitor.observe(c.name, hw, measured, predicted, t=done)
            if event is None:
                continue
            # sustained drift: fold the monitor's per-hw corrections into
            # the cumulative ones (they are residuals *of the corrected
            # predictions*, so composition is multiplicative), re-route,
            # and reset the monitor against the new baseline
            step_corr = monitor.corrections()
            for h, f in step_corr.items():
                cum_corr[h] = cum_corr.get(h, 1.0) * f
            corrected = self.router.route_many(
                self._named_calls,
                objective=ResidualCorrectedObjective(base_obj, dict(cum_corr)),
                n_tokens=self._n_tokens,
                scales=self._scales,
            )
            new_assignment = {name: p.best for name, p in corrected.items()}
            reroutes.append(
                RerouteEvent(
                    index=i, t=done, cls=event.cls, hw=event.hw,
                    deviation=event.deviation, corrections=dict(step_corr),
                    old_assignment=dict(assignment),
                    new_assignment=dict(new_assignment),
                )
            )
            assignment = new_assignment
            monitor.reset()

        per_hw: dict = {}
        horizon = 0.0
        for hw, st in acc.items():
            lat = np.asarray(st["lat"], float)
            wait = np.asarray(st["wait"], float)
            size = self.pool_size(hw)
            hw_last = float(max(pools[hw]))  # last completion on this pool
            horizon = max(horizon, hw_last)
            # integrated capacity over the replica trajectory (constant
            # [(0, size)] without autoscaling -> size * hw_last, as before)
            hw_traj = traj[hw]
            capacity = 0.0
            for (t0, cnt), (t1, _) in zip(hw_traj, hw_traj[1:] + [(hw_last, 0)]):
                capacity += cnt * max(min(t1, hw_last) - t0, 0.0)
            per_hw[hw] = HardwareLoad(
                hw=hw,
                classes=sorted(st["classes"]),
                n_requests=len(lat),
                replicas=size,
                final_replicas=len(pools[hw]),
                latency_p50_s=float(np.percentile(lat, 50)),
                latency_p95_s=float(np.percentile(lat, 95)),
                latency_p99_s=float(np.percentile(lat, 99)),
                latency_mean_s=float(lat.mean()),
                wait_mean_s=float(wait.mean()),
                utilization=float(st["busy"] / capacity) if capacity > 0 else 0.0,
                busy_s=float(st["busy"]),
                replica_traj=hw_traj,
            )
        return FleetReport(
            assignment=assignment,
            per_hw=per_hw,
            n_requests=n,
            horizon_s=horizon,
            latency_p50_s=float(np.percentile(latencies, 50)),
            latency_p95_s=float(np.percentile(latencies, 95)),
            latency_p99_s=float(np.percentile(latencies, 99)),
            latency_mean_s=float(latencies.mean()),
            latencies=latencies,
            reroutes=reroutes,
        )
