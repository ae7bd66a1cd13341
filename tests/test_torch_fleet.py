"""The port's fleet layer against the reference's: ``predict.objective``,
``serve.placement`` (``FleetRouter``) and ``serve.fleet`` (replay,
autoscale, the drift control loop), with ``core.e2e.place_request`` and
``simulate_fleet`` on top. All of it is numpy or plain Python in both
packages, so every result is held *equal* to the reference's on the same
inputs: placements, tables, ``FleetReport``s with their latency arrays and
re-route logs. The reference's ``tests/test_placement.py`` (its routing
tests; the admission tests are in ``test_torch_trace.py``),
``tests/test_fleet.py``, ``tests/test_fleet_properties.py`` (through
``tests/_hypothesis_stub.py`` where hypothesis is missing) and the fleet
tests of ``tests/test_monitor.py`` are mirrored on the port, each also
comparing with the reference. The synperf cases use reference estimator
weights crossed into the port by ``convert``."""
import dataclasses
import warnings
from functools import lru_cache

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.configs import get_arch as ref_get_arch
from repro.core import dataset as ref_dataset
from repro.core import e2e as ref_e2e
from repro.core import estimator as ref_estimator
from repro.core import hardware as ref_hardware
from repro.predict import KernelCall as RefKernelCall
from repro.predict import backends as ref_backends
from repro.predict import objective as ref_objective
from repro.predict import sweep as ref_sweep
from repro.predict.comm import CommRegressor as RefCommRegressor
from repro.serve import fleet as ref_fleet
from repro.serve import monitor as ref_monitor
from repro.serve import placement as ref_placement
from repro.serve import trace as ref_trace
from repro_torch.analysis import AuditError
from repro_torch.configs import get_arch
from repro_torch.convert import pipeweave_from_numpy
from repro_torch.core.e2e import model_calls, place_request, simulate_fleet
from repro_torch.core.hardware import REGISTRY, _mk, get_hw
from repro_torch.predict import (
    CommRegressor,
    FeatureCache,
    KernelCall,
    SweepPredictor,
    UnpricedHardwareError,
    get_objective,
    get_predictor,
    trace_cost_usd,
)
from repro_torch.predict import objective
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.fleet import (
    AutoscalePolicy,
    FleetSimulator,
    WorkloadClass,
    poisson_arrivals,
    simulate_queue,
)
from repro_torch.serve.monitor import DriftSpec, ResidualMonitor
from repro_torch.serve.placement import FleetRouter
from repro_torch.serve.trace import TraceRecorder

HWS = ["tpu-v5e", "tpu-v6e"]


def _plain(obj):
    """Dataclasses, dicts, tuples and arrays reduced so ``==`` compares bits."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [obj.dtype.str, obj.shape, obj.tobytes()]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _eq(port, ref):
    assert _plain(port) == _plain(ref)


def _ref_kw(kw):
    """Keyword arguments with the port's objects swapped for the reference's."""
    out = {}
    for k, v in kw.items():
        if isinstance(v, DriftSpec):
            v = ref_monitor.DriftSpec(**dataclasses.asdict(v))
        elif isinstance(v, AutoscalePolicy):
            v = ref_fleet.AutoscalePolicy(**dataclasses.asdict(v))
        elif isinstance(v, ResidualMonitor):
            v = ref_monitor.ResidualMonitor()
        out[k] = v
    return out


# synthetic two-device registry with an analytically-known ranking
# (tests/test_placement.py): "fast" halves the latency at 4x the price
SPECS = [("syn-fast", "syn", 8, 1.0, 200, 1600, 128, True, 4.0),
         ("syn-slow", "syn", 8, 1.0, 200, 800, 128, True, 1.0)]
FAST, SLOW = (_mk(*s[:-1], usd=s[-1], launch=0.0) for s in SPECS)
REF_FAST, REF_SLOW = (ref_hardware._mk(*s[:-1], usd=s[-1], launch=0.0) for s in SPECS)
HBM = ("rmsnorm", {"seq": 4096, "dim": 4096}, 8)
HBM_TRACE = [KernelCall(HBM[0], HBM[1], count=HBM[2])]
REF_HBM_TRACE = [RefKernelCall(HBM[0], HBM[1], count=HBM[2])]


def _routers(hws, ref_hws, **kw):
    return FleetRouter(hws, **kw), ref_placement.FleetRouter(ref_hws, **kw)


@pytest.fixture(scope="module")
def ref_pw_gemm_only():
    return ref_estimator.train_pipeweave(
        {"gemm": ref_dataset.build_dataset("gemm", n_workloads=8, seed=0)}, max_epochs=2
    )


@pytest.fixture(scope="module")
def ref_pw():
    return ref_estimator.train_pipeweave(
        {"gemm": ref_dataset.build_dataset("gemm", n_workloads=20, seed=3),
         "rmsnorm": ref_dataset.build_dataset("rmsnorm", n_workloads=12, seed=4)},
        max_epochs=12,
    )


def _cross(pw):
    return pipeweave_from_numpy({
        k: dict(params=jax.tree.map(np.asarray, m.params), state=jax.tree.map(np.asarray, m.state),
                mu_x=m.mu_x, sd_x=m.sd_x, y_floor=m.y_floor, x_lo=m.x_lo, x_hi=m.x_hi)
        for k, m in pw.models.items()
    })


# ----------------------------------------------------------------------
# objectives
# ----------------------------------------------------------------------


def test_objectives_equal_reference():
    assert sorted(objective.OBJECTIVES) == sorted(ref_objective.OBJECTIVES)
    router, ref_router = _routers([FAST, SLOW], [REF_FAST, REF_SLOW], backend="roofline")
    est = router.route(HBM_TRACE).rows[0].estimate
    ref_est = ref_router.route(REF_HBM_TRACE).rows[0].estimate
    _eq(est, ref_est)
    for spec, kw in (("latency", {}), ("cost", {}), ("cost_per_token", {}),
                     ("slo_cheapest", {"slo_s": est.total_s * 1.5})):
        obj, ref = get_objective(spec, **kw), ref_objective.get_objective(spec, **kw)
        assert obj.describe() == ref.describe()
        for hw, ref_hw in ((FAST, REF_FAST), (SLOW, REF_SLOW)):
            assert obj.score(hw, est, n_tokens=64) == ref.score(ref_hw, ref_est, n_tokens=64)
            assert obj.feasible(hw, est) == ref.feasible(ref_hw, ref_est)
    corr = {"syn-fast": 3.0}
    obj = get_objective("residual_corrected", base="cost", corrections=corr)
    ref = ref_objective.get_objective("residual_corrected", base="cost", corrections=corr)
    assert obj.describe() == ref.describe()
    assert obj.score(FAST, est) == ref.score(REF_FAST, ref_est)
    assert trace_cost_usd(SLOW, est) == ref_objective.trace_cost_usd(REF_SLOW, ref_est)
    with pytest.raises(ValueError, match="finite"):
        get_objective("residual_corrected", base="cost", corrections={"x": 0.0})
    with pytest.raises(ValueError, match="slo_s"):
        get_objective("slo_cheapest", slo_s=0.0)
    with pytest.raises(TypeError, match="kwargs"):
        get_objective(obj, slo_s=1.0)


# ----------------------------------------------------------------------
# routing (tests/test_placement.py)
# ----------------------------------------------------------------------


def test_router_picks_analytically_optimal_hw():
    router, ref = _routers([FAST, SLOW], [REF_FAST, REF_SLOW], backend="roofline")
    by_lat = router.route(HBM_TRACE, objective="latency")
    _eq(by_lat, ref.route(REF_HBM_TRACE, objective="latency"))
    assert by_lat.best == "syn-fast"
    assert np.isclose(by_lat["syn-slow"].total_s, 2 * by_lat["syn-fast"].total_s, rtol=1e-9)
    by_cost = router.route(HBM_TRACE, objective="cost")
    ref_cost = ref.route(REF_HBM_TRACE, objective="cost")
    _eq(by_cost, ref_cost)
    assert by_cost.table() == ref_cost.table()
    assert by_cost.best == "syn-slow"
    assert np.isclose(by_cost["syn-fast"].score, 2 * by_cost["syn-slow"].score, rtol=1e-9)
    assert by_cost.ranking() == ["syn-slow", "syn-fast"]
    assert "syn-fast" in by_cost and "nope" not in by_cost
    assert len(by_cost.table().splitlines()) == 3


def test_slo_cheapest_objective():
    router, ref = _routers([FAST, SLOW], [REF_FAST, REF_SLOW], backend="roofline")
    lat = {r.hw: r.total_s for r in router.route(HBM_TRACE).rows}
    slo = (lat["syn-fast"] + lat["syn-slow"]) / 2
    tight = router.route(HBM_TRACE, objective=get_objective("slo_cheapest", slo_s=slo))
    _eq(tight, ref.route(REF_HBM_TRACE, objective=ref_objective.get_objective("slo_cheapest", slo_s=slo)))
    assert tight.best == "syn-fast"
    assert tight["syn-fast"].feasible and not tight["syn-slow"].feasible
    assert "NO" in tight.table()
    loose = router.route(HBM_TRACE, objective=get_objective("slo_cheapest", slo_s=10 * lat["syn-slow"]))
    assert loose.best == "syn-slow"
    assert all(r.feasible for r in loose.rows)


def test_cost_per_token_needs_n_tokens():
    router, ref = _routers([FAST, SLOW], [REF_FAST, REF_SLOW], backend="roofline",
                           objective="cost_per_token")
    with pytest.raises(ValueError, match="needs n_tokens"):
        router.route(HBM_TRACE)
    pl = router.route(HBM_TRACE, n_tokens=64)
    _eq(pl, ref.route(REF_HBM_TRACE, n_tokens=64))
    assert pl.best == "syn-slow"
    assert np.isclose(pl.rows[0].score, trace_cost_usd(SLOW, pl["syn-slow"].estimate) / 64)


def test_unpriced_hw_is_skipped_under_cost_with_warning():
    unpriced = dataclasses.replace(FAST, name="syn-unpriced", usd_per_chip_hour=None)
    ref_unpriced = dataclasses.replace(REF_FAST, name="syn-unpriced", usd_per_chip_hour=None)
    router, ref = _routers([SLOW, unpriced], [REF_SLOW, ref_unpriced], backend="roofline")
    with pytest.warns(UserWarning, match="skipping syn-unpriced"):
        pl = router.route(HBM_TRACE, objective="cost")
    with pytest.warns(UserWarning, match="skipping syn-unpriced"):
        ref_pl = ref.route(REF_HBM_TRACE, objective="cost")
    _eq(pl, ref_pl)
    assert pl.table() == ref_pl.table()
    assert pl.best == "syn-slow" and "syn-unpriced" in pl.skipped
    assert router.route(HBM_TRACE, objective="latency").skipped == {}
    with pytest.raises(UnpricedHardwareError):
        trace_cost_usd(unpriced, pl["syn-slow"].estimate)


def test_commless_registry_entry_skipped_mid_sweep():
    def trace(mod, cfg, m_calls):
        return [("s", 1.0, [mod.KernelCall("gemm", {"M": 256, "N": 256, "K": 256})]),
                ("comm", 1.0, m_calls(cfg, 2, 1, 64, tp=2))]

    from repro import predict as ref_predict
    from repro_torch import predict

    router = FleetRouter(sweep=SweepPredictor(predictors={
        "tpu-v5e": get_predictor("oracle", get_hw("tpu-v5e")),
        "tpu-v6e": get_predictor("roofline", get_hw("tpu-v6e"), comm=CommRegressor())}))
    ref = ref_placement.FleetRouter(sweep=ref_sweep.SweepPredictor(predictors={
        "tpu-v5e": ref_backends.get_predictor("oracle", ref_hardware.get_hw("tpu-v5e")),
        "tpu-v6e": ref_backends.get_predictor("roofline", ref_hardware.get_hw("tpu-v6e"),
                                              comm=RefCommRegressor())}))
    with pytest.warns(UserWarning, match="skipping tpu-v6e"):
        pl = router.route(trace(predict, get_arch("qwen3-0.6b"), model_calls))
    with pytest.warns(UserWarning, match="skipping tpu-v6e"):
        ref_pl = ref.route(trace(ref_predict, ref_get_arch("qwen3-0.6b"), ref_e2e.model_calls))
    _eq(pl, ref_pl)
    assert pl.best == "tpu-v5e" and list(pl.skipped) == ["tpu-v6e"]
    assert "no fitted coefficients" in pl.skipped["tpu-v6e"]


def test_router_every_hw_skipped_raises(ref_pw_gemm_only):
    router = FleetRouter(HWS, estimator=_cross(ref_pw_gemm_only), cache=FeatureCache())
    trace = [("d", 1.0, model_calls(get_arch("qwen3-0.6b"), 2, 1, 64, tp=1))]
    with pytest.raises(RuntimeError, match="every hardware was skipped"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            router.route(trace)


def test_router_rejects_ambiguous_construction_and_audit():
    sp = SweepPredictor(["tpu-v5e"], backend="roofline")
    with pytest.raises(TypeError, match="not both"):
        FleetRouter(["tpu-v5e"], sweep=sp)
    with pytest.raises(KeyError, match="unknown objective"):
        FleetRouter(["tpu-v5e"], backend="roofline", objective="speed")
    # audit= is ported: a fitted fleet passes, a stale comm regressor fails
    # construction (tests/test_torch_audit.py holds both against the reference)
    FleetRouter(["tpu-v5e"], backend="roofline", audit=True)
    stale = CommRegressor().fit(get_hw("tpu-v5e"))
    for k in [k for k in stale.theta if k[0] == "all_to_all"]:
        del stale.theta[k]
    with pytest.raises(AuditError, match="all_to_all"):
        FleetRouter(["tpu-v5e"], backend="roofline", audit=True, comm=stale)


def test_split_fleet_prefers_different_devices():
    spec = [("syn-mxu", "syn", 8, 1.0, 400, 800, 128, True), ("syn-hbm", "syn", 8, 1.0, 100, 3200, 128, True)]
    router = FleetRouter([_mk(*s, usd=2.0, launch=0.0) for s in spec], backend="roofline")
    ref = ref_placement.FleetRouter([ref_hardware._mk(*s, usd=2.0, launch=0.0) for s in spec],
                                    backend="roofline")
    classes = {"prefill": ("gemm", {"M": 4096, "N": 4096, "K": 4096}),
               "decode": ("rmsnorm", {"seq": 4096, "dim": 4096})}
    split = router.route_split({k: [KernelCall(*v)] for k, v in classes.items()})
    ref_split = ref.route_split({k: [RefKernelCall(*v)] for k, v in classes.items()})
    _eq(split, ref_split)
    assert split.table() == ref_split.table()
    assert split.assignment == {"prefill": "syn-mxu", "decode": "syn-hbm"}
    assert split.is_split and split["prefill"].best == "syn-mxu"


def _ref_recorder(rec, ref_cfg):
    """The reference's recorder holding the port recorder's steps."""
    ref = ref_trace.TraceRecorder()
    for m in rec.meta:
        ref.record_step(m.label, ref_cfg, m.B, m.qlen, m.kvlen, phase=m.phase, active=m.active)
    return ref


def test_route_split_from_recorder_and_route_trace():
    cfg = get_arch("qwen3-0.6b").smoke()
    rec = TraceRecorder()
    eng = ServeEngine(cfg, max_batch=2, recorder=rec, device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(1, 13, dtype=np.int32), max_new=3))
    eng.step_batch()
    assert rec.phases() == ["prefill", "decode", "decode"]
    assert (rec.decode_tokens, rec.prefill_tokens, rec.generated_tokens) == (2, 1, 3)
    ref_rec = _ref_recorder(rec, ref_get_arch("qwen3-0.6b").smoke())
    router, ref = _routers(HWS, HWS, backend="oracle")
    split = router.route_split(rec)
    _eq(split, ref.route_split(ref_rec))
    assert set(split.parts) == {"prefill", "decode"}
    split_cpt = router.route_split(rec, objective="cost_per_token")
    _eq(split_cpt, ref.route_split(ref_rec, objective="cost_per_token"))
    assert (split_cpt["prefill"].n_tokens, split_cpt["decode"].n_tokens) == (1, 2)
    pl = router.route_trace(rec, objective="cost_per_token")
    _eq(pl, ref.route_trace(ref_rec, objective="cost_per_token"))
    assert pl.n_tokens == 3
    with pytest.raises(TypeError, match="TraceRecorder or a"):
        router.route_split([("s", 1.0, [])])
    with pytest.raises(ValueError, match="empty trace"):
        router.route_split({})


def test_decode_tokens_with_heterogeneous_max_new():
    cfg = get_arch("qwen3-0.6b").smoke()
    rec = TraceRecorder()
    eng = ServeEngine(cfg, max_batch=2, recorder=rec, device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(1, 9, dtype=np.int32), max_new=2))
    eng.submit(Request(rid=1, prompt=np.arange(1, 9, dtype=np.int32), max_new=6))
    results = eng.step_batch()
    assert sum(len(r.tokens) for r in results) == rec.generated_tokens == 8
    decode_meta = [m for m in rec.meta if m.phase == "decode"]
    assert all(m.B == 2 for m in decode_meta)
    assert [m.active for m in decode_meta] == [2, 1, 1, 1, 1]
    ref_rec = _ref_recorder(rec, ref_get_arch("qwen3-0.6b").smoke())
    router, ref = _routers(HWS, HWS, backend="roofline")
    _eq(router.route_trace(rec, objective="cost_per_token"),
        ref.route_trace(ref_rec, objective="cost_per_token"))


# ----------------------------------------------------------------------
# place_request
# ----------------------------------------------------------------------


def test_place_request_over_registry():
    pl = place_request(get_arch("qwen3-0.6b"), 4, 64, 8, backend="roofline", objective="cost")
    ref = ref_e2e.place_request(ref_get_arch("qwen3-0.6b"), 4, 64, 8, backend="roofline",
                                objective="cost")
    _eq(pl, ref)
    assert pl.table() == ref.table()
    assert set(pl.ranking()) == set(REGISTRY)
    assert pl.n_tokens == 4 * 8
    scores = [r.score for r in pl.rows]
    assert scores == sorted(scores) and scores[0] > 0
    with pytest.raises(TypeError, match="not both"):
        place_request(get_arch("qwen3-0.6b"), 4, 64, 8, backend="roofline",
                      router=FleetRouter(backend="roofline"))


def test_place_request_pp_applies_bubble():
    cfg, ref_cfg = get_arch("qwen3-0.6b"), ref_get_arch("qwen3-0.6b")
    router, ref = FleetRouter(["tpu-v5e"], backend="oracle"), \
        ref_placement.FleetRouter(["tpu-v5e"], backend="oracle")
    flat = place_request(cfg, 2, 64, 8, router=router)
    pp = place_request(cfg, 2, 64, 8, pp=2, router=router)
    _eq(flat, ref_e2e.place_request(ref_cfg, 2, 64, 8, router=ref))
    _eq(pp, ref_e2e.place_request(ref_cfg, 2, 64, 8, pp=2, router=ref))
    assert pp["tpu-v5e"].total_s > flat["tpu-v5e"].total_s * 1.25


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b"])
def test_place_request_synperf_equal(ref_pw, arch):
    kw = dict(tp=2, comm_overlap=True, objective="cost", backend="synperf", fallback="oracle",
              hws=["tpu-v5e", "tpu-v6e", "tpu-v7p"])
    pl = place_request(get_arch(arch), 2, 64, 8, estimator=_cross(ref_pw), **kw)
    ref = ref_e2e.place_request(ref_get_arch(arch), 2, 64, 8, estimator=ref_pw, **kw)
    _eq(pl, ref)
    assert all(r.estimate.fallbacks for r in pl.rows)


# ----------------------------------------------------------------------
# fleet replay (tests/test_fleet.py)
# ----------------------------------------------------------------------


def _sim_pair(classes, **kw):
    """``FleetSimulator`` of both packages over the same workload classes
    ``(name, lin, lout, weight)`` of qwen3-0.6b smoke."""
    cfg, ref_cfg = get_arch("qwen3-0.6b").smoke(), ref_get_arch("qwen3-0.6b").smoke()
    kw = {"hws": HWS, "backend": "oracle", "replicas": 2, **kw}
    port = FleetSimulator([WorkloadClass(n, cfg, B=1, lin=li, lout=lo, weight=w)
                           for n, li, lo, w in classes], **kw)
    ref = ref_fleet.FleetSimulator([ref_fleet.WorkloadClass(n, ref_cfg, B=1, lin=li, lout=lo, weight=w)
                                    for n, li, lo, w in classes], **kw)
    return port, ref


def _replay(pair, **kw):
    port, ref = pair
    rep = port.replay(**kw)
    _eq(rep, ref.replay(**_ref_kw(kw)))
    return rep


@pytest.fixture(scope="module")
def chat():
    return _sim_pair([("chat", 32, 8, 1.0)])


def test_simulate_queue_and_arrivals_equal():
    arr, svc = np.array([0.0, 1.0, 2.0]), np.array([2.0, 2.0, 2.0])
    starts, traj, capacity = simulate_queue(arr, svc, replicas=1)
    assert list(starts) == [0.0, 2.0, 4.0] and traj == [(0.0, 1)] and capacity == 6.0
    assert list(simulate_queue(arr, svc, replicas=2)[0]) == [0.0, 1.0, 2.0]
    rng = np.random.default_rng(0)
    arr, svc = np.sort(rng.uniform(0, 50, 300)), rng.uniform(0.1, 1.0, 300)
    pol = AutoscalePolicy(window_s=5.0, target_utilization=0.5, min_replicas=1, max_replicas=8)
    for kw in ({"replicas": 2}, {"replicas": 1, "autoscale": pol}):
        _eq(simulate_queue(arr, svc, **kw), ref_fleet.simulate_queue(arr, svc, **_ref_kw(kw)))
    a1, a2 = poisson_arrivals(10.0, 1000, seed=7), poisson_arrivals(20.0, 1000, seed=7)
    _eq(a1, ref_fleet.poisson_arrivals(10.0, 1000, seed=7))
    np.testing.assert_allclose(a2, a1 / 2.0, rtol=1e-12)
    assert np.all(np.diff(a1) > 0)


def test_empty_fleet_latency_is_isolated_estimate(chat):
    sim, ref = chat
    assert sim.assignment == ref.assignment
    _eq(sim.placements, ref.placements)
    report = _replay(chat, arrivals=np.array([0.0]))
    assert abs(report.latency_p50_s - sim.service_s("chat")) <= 1e-9
    assert report.per_hw[sim.assignment["chat"]].wait_mean_s == 0.0


def test_latency_monotone_in_arrival_rate(chat):
    sat = chat[0].saturation_rate_rps()
    assert sat == chat[1].saturation_rate_rps()
    p95 = [_replay(chat, rate_rps=f * sat, n_requests=20_000, seed=3).latency_p95_s
           for f in (0.3, 0.6, 0.9)]
    assert p95[0] <= p95[1] <= p95[2] and p95[2] > p95[0]


def test_more_replicas_cut_waiting():
    small, big = _sim_pair([("chat", 32, 8, 1.0)], replicas=1), _sim_pair([("chat", 32, 8, 1.0)], replicas=4)
    rate = 0.8 * small[0].saturation_rate_rps()
    hw = small[0].assignment["chat"]
    wait_small = _replay(small, rate_rps=rate, n_requests=10_000, seed=5).per_hw[hw].wait_mean_s
    wait_big = _replay(big, rate_rps=rate, n_requests=10_000, seed=5).per_hw[hw].wait_mean_s
    assert wait_big < wait_small


def test_replay_is_deterministic_and_conserves_requests(chat):
    sim = chat[0]
    r1 = _replay(chat, rate_rps=100.0, n_requests=5_000, seed=11)
    r2 = sim.replay(rate_rps=100.0, n_requests=5_000, seed=11)
    assert r1.latency_p95_s == r2.latency_p95_s and r1.n_requests == 5_000
    assert sum(l.n_requests for l in r1.per_hw.values()) == 5_000
    assert 0.0 < r1.per_hw[sim.assignment["chat"]].utilization <= 1.0
    assert np.all(r1.latencies >= sim.service_s("chat") - 1e-12)


def test_recorded_arrivals_any_order(chat):
    arr = poisson_arrivals(200.0, 2_000, seed=2)
    shuffled = arr.copy()
    np.random.default_rng(0).shuffle(shuffled)
    a = _replay(chat, arrivals=arr, class_ids=np.zeros(len(arr), int))
    b = _replay(chat, arrivals=shuffled, class_ids=np.zeros(len(arr), int))
    assert a.latency_p95_s == b.latency_p95_s


def test_assignment_follows_router(chat):
    sim = chat[0]
    cls = sim.classes[0]
    placement = sim.router.route(cls.calls(), objective="latency", n_tokens=cls.n_tokens,
                                 scale=cls.bubble())
    assert sim.assignment["chat"] == placement.best
    assert sim.service_s("chat") == placement[placement.best].total_s


def test_autoscale_grows_pool_under_load(chat):
    sim = chat[0]
    sat, svc = sim.saturation_rate_rps(), sim.service_s("chat")
    policy = AutoscalePolicy(window_s=20 * svc, target_utilization=0.5, min_replicas=2,
                             max_replicas=16)
    fixed = _replay(chat, rate_rps=0.9 * sat, n_requests=20_000, seed=3)
    scaled = _replay(chat, rate_rps=0.9 * sat, n_requests=20_000, seed=3, autoscale=policy)
    hw = sim.assignment["chat"]
    assert scaled.per_hw[hw].final_replicas > scaled.per_hw[hw].replicas
    assert scaled.latency_p95_s <= fixed.latency_p95_s
    assert len(scaled.per_hw[hw].replica_traj) > 1


def test_multi_class_mix_routes_and_replays():
    pair = _sim_pair([("chat", 32, 8, 3.0), ("bulk", 96, 24, 1.0)])
    sim = pair[0]
    assert set(sim.assignment) == {"chat", "bulk"}
    assert sim.service_s("bulk") > sim.service_s("chat")
    report = _replay(pair, rate_rps=0.5 * sim.saturation_rate_rps(), n_requests=8_000, seed=1)
    names = [n for load in report.per_hw.values() for n in load.classes]
    assert "chat" in names and "bulk" in names
    assert report.table() == pair[1].replay(rate_rps=0.5 * sim.saturation_rate_rps(),
                                            n_requests=8_000, seed=1).table()


def test_simulate_fleet_convenience():
    kw = dict(rate_rps=50.0, n_requests=2_000, hws=HWS, backend="oracle", replicas=2, seed=0)
    report = simulate_fleet(get_arch("qwen3-0.6b").smoke(), 1, 32, 8, **kw)
    _eq(report, ref_e2e.simulate_fleet(ref_get_arch("qwen3-0.6b").smoke(), 1, 32, 8, **kw))
    assert report.n_requests == 2_000
    assert report.latency_p99_s >= report.latency_p95_s >= report.latency_p50_s > 0


def test_simulate_fleet_synperf_equal(ref_pw):
    """The full-width model priced by crossed synperf weights (gemm and
    rmsnorm; the other families on the oracle), with drift and a monitor."""
    kw = dict(rate_rps=20.0, n_requests=400, hws=HWS, backend="synperf", fallback="oracle",
              replicas=2, seed=3)
    drift = {"tpu-v6e": 2.5}
    report = simulate_fleet(get_arch("qwen3-0.6b"), 1, 256, 16, estimator=_cross(ref_pw),
                            drift=drift, monitor=ResidualMonitor(), **kw)
    ref = ref_e2e.simulate_fleet(ref_get_arch("qwen3-0.6b"), 1, 256, 16, estimator=ref_pw,
                                 drift=drift, monitor=ref_monitor.ResidualMonitor(), **kw)
    _eq(report, ref)


# ----------------------------------------------------------------------
# the drift control loop (tests/test_monitor.py's fleet tests)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def mix():
    return _sim_pair([("chat", 256, 32, 3.0), ("bulk", 1024, 64, 1.0)])


def test_golden_reroute_log(mix):
    sim = mix[0]
    assert sim.assignment == {"chat": "tpu-v6e", "bulk": "tpu-v6e"}
    mon = ResidualMonitor()
    kw = dict(rate_rps=0.5 * sim.saturation_rate_rps(), n_requests=4000, seed=7,
              drift=DriftSpec(hw="tpu-v6e", factor=3.0))
    report = sim.replay(monitor=mon, **kw)
    _eq(report, mix[1].replay(monitor=ref_monitor.ResidualMonitor(), **_ref_kw(kw)))
    assert len(report.reroutes) == 1
    ev = report.reroutes[0]
    assert (ev.index, ev.cls, ev.hw, ev.deviation) == (18, "chat", "tpu-v6e", 2.0)
    assert set(ev.corrections) == {"tpu-v6e"}
    assert ev.corrections["tpu-v6e"] == pytest.approx(3.0, rel=1e-12)
    assert ev.old_assignment == {"chat": "tpu-v6e", "bulk": "tpu-v6e"}
    assert ev.new_assignment == {"chat": "tpu-v5e", "bulk": "tpu-v5e"}
    assert ev.changed and report.assignment == ev.new_assignment
    assert mon.events[0].deviation == 2.0


def test_golden_reroute_log_is_reproducible(mix):
    kw = dict(rate_rps=0.5 * mix[0].saturation_rate_rps(), n_requests=4000, seed=7,
              drift=DriftSpec(hw="tpu-v6e", factor=3.0))
    r1 = mix[0].replay(monitor=ResidualMonitor(), **kw)
    r2 = mix[0].replay(monitor=ResidualMonitor(), **kw)
    assert r1.reroutes == r2.reroutes
    assert np.array_equal(r1.latencies, r2.latencies)


def test_monitored_undrifted_replay_is_bit_identical(mix):
    rate = 0.5 * mix[0].saturation_rate_rps()
    frozen = _replay(mix, rate_rps=rate, n_requests=1500, seed=7)
    ctl = _replay(mix, rate_rps=rate, n_requests=1500, seed=7, monitor=ResidualMonitor())
    assert ctl.reroutes == [] and ctl.assignment == frozen.assignment
    assert np.array_equal(frozen.latencies, ctl.latencies)


def test_drift_rejects_unknown_hardware(mix):
    with pytest.raises(ValueError, match="no placement prices"):
        mix[0].replay(rate_rps=1.0, n_requests=10, seed=0, drift={"tpu-v99": 2.0})


def test_drift_replay_composes_with_autoscale(mix):
    rate = 0.8 * mix[0].saturation_rate_rps()
    pol = AutoscalePolicy(window_s=2000 / rate / 10, target_utilization=0.6, min_replicas=1,
                          max_replicas=16)
    rep = _replay(mix, rate_rps=rate, n_requests=2000, seed=11, drift={"tpu-v6e": 2.0},
                  autoscale=pol)
    assert sum(l.n_requests for l in rep.per_hw.values()) == 2000
    load = rep.per_hw["tpu-v6e"]
    assert 0.0 < load.utilization <= 1.0 + 1e-9
    assert load.final_replicas > load.replicas and len(load.replica_traj) > 1
    assert load.replica_traj[-1][1] == load.final_replicas


def test_autoscaled_quiet_monitor_matches_vectorized_autoscale(mix):
    rate = 0.8 * mix[0].saturation_rate_rps()
    pol = AutoscalePolicy(window_s=1500 / rate / 10, target_utilization=0.6, min_replicas=1,
                          max_replicas=16)
    kw = dict(rate_rps=rate, n_requests=1500, seed=5, autoscale=pol)
    vec = _replay(mix, **kw)
    ctl = _replay(mix, monitor=ResidualMonitor(), **kw)
    assert ctl.reroutes == [] and np.array_equal(vec.latencies, ctl.latencies)
    for hw, load in vec.per_hw.items():
        assert ctl.per_hw[hw].replica_traj == load.replica_traj
        assert ctl.per_hw[hw].final_replicas == load.final_replicas
        assert ctl.per_hw[hw].utilization == pytest.approx(load.utilization, rel=1e-12)


# ----------------------------------------------------------------------
# properties of the control loop (tests/test_fleet_properties.py)
# ----------------------------------------------------------------------

MIXES = (
    (("chat", 256, 32, 3.0), ("bulk", 1024, 64, 1.0)),
    (("solo", 512, 48, 1.0),),
    (("a", 128, 16, 1.0), ("b", 384, 32, 2.0), ("c", 768, 8, 1.0)),
)
SINGLE = MIXES[1]
N = 400  # requests per replayed stream (event-by-event path: keep small)


@lru_cache(maxsize=None)
def _sims(mix):
    # module-level cache: @given hides the signature, so fixtures can't mix
    return _sim_pair(mix)


@settings(deadline=None, max_examples=8)
@given(mix=st.sampled_from(MIXES), seed=st.integers(0, 3),
       frac=st.floats(min_value=0.3, max_value=0.7))
def test_no_drift_means_zero_reroutes_and_exact_replay(mix, seed, frac):
    pair = _sims(mix)
    rate = frac * pair[0].saturation_rate_rps()
    frozen = _replay(pair, rate_rps=rate, n_requests=N, seed=seed)
    ctl = _replay(pair, rate_rps=rate, n_requests=N, seed=seed, monitor=ResidualMonitor())
    assert ctl.reroutes == [] and ctl.assignment == pair[0].assignment
    assert np.array_equal(frozen.latencies, ctl.latencies)
    assert set(ctl.per_hw) == set(frozen.per_hw)


@settings(deadline=None, max_examples=8)
@given(mix=st.sampled_from(MIXES), seed=st.integers(0, 3),
       factor=st.floats(min_value=1.6, max_value=4.0))
def test_step_drift_trips_exactly_one_reroute(mix, seed, factor):
    pair = _sims(mix)
    drift_hw = pair[0].assignment[mix[0][0]]
    report = _replay(pair, rate_rps=0.5 * pair[0].saturation_rate_rps(), n_requests=N,
                     seed=seed, drift=DriftSpec(hw=drift_hw, factor=factor),
                     monitor=ResidualMonitor())
    assert len(report.reroutes) == 1
    ev = report.reroutes[0]
    assert ev.hw == drift_hw and ev.deviation >= 0.25
    assert ev.corrections[drift_hw] > 1.0
    assert report.assignment == ev.new_assignment


@settings(deadline=None, max_examples=8)
@given(seed=st.integers(0, 5), factor=st.floats(min_value=2.0, max_value=4.0))
def test_rerouted_p95_never_exceeds_frozen_on_drifted_stream(seed, factor):
    pair = _sims(SINGLE)
    rate = 0.5 * pair[0].saturation_rate_rps()
    drift = DriftSpec(hw=pair[0].assignment["solo"], factor=factor)
    frozen = _replay(pair, rate_rps=rate, n_requests=N, seed=seed, drift=drift)
    routed = _replay(pair, rate_rps=rate, n_requests=N, seed=seed, drift=drift,
                     monitor=ResidualMonitor())
    assert len(routed.reroutes) == 1
    assert routed.latency_p95_s <= frozen.latency_p95_s * (1 + 1e-12)


@settings(deadline=None, max_examples=10)
@given(mix=st.sampled_from(MIXES), seed=st.integers(0, 3),
       factor=st.floats(min_value=1.0, max_value=3.0))
def test_conservation_and_utilization(mix, seed, factor):
    pair = _sims(mix)
    report = _replay(pair, rate_rps=0.5 * pair[0].saturation_rate_rps(), n_requests=N,
                     seed=seed, drift={pair[0].assignment[mix[0][0]]: factor},
                     monitor=ResidualMonitor())
    assert report.n_requests == N and len(report.latencies) == N
    assert sum(l.n_requests for l in report.per_hw.values()) == N
    assert np.all(report.latencies > 0) and np.isfinite(report.latencies).all()
    for load in report.per_hw.values():
        assert 0.0 <= load.utilization <= 1.0 + 1e-9 and load.busy_s >= 0.0
    assert report.horizon_s >= float(report.latencies[0])
    assert {c for l in report.per_hw.values() for c in l.classes} == {m[0] for m in mix}
