"""The port's pricing path against the reference's: ``core.e2e`` (the
workload generator and request pricing), ``predict.sweep`` and the pipeline
schedule analytics. All of it is numpy or plain Python in both packages, so
it is held *equal*: the same call sequences and the same ``Estimate`` bits
on the oracle and roofline backends. The reference's ``tests/test_e2e.py``
is mirrored on the port at the end."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_arch as ref_get_arch
from repro.core import e2e as ref_e2e
from repro.core import hardware as ref_hardware
from repro.dist import pipeline as ref_pipeline
from repro.predict import backends as ref_backends
from repro.predict import sweep as ref_sweep
from repro_torch.configs import get_arch, list_archs
from repro_torch.core import e2e, hwsim
from repro_torch.core.e2e import (
    CommCall,
    CommRegressor,
    KernelCall,
    layer_calls,
    model_calls,
    oracle_times,
    request_latency,
    step_time,
)
from repro_torch.core.hardware import REGISTRY, get_hw
from repro_torch.dist import pipeline
from repro_torch.predict import SweepPredictor, get_predictor
from repro_torch.predict import sweep

HW = get_hw("tpu-v5e")
BACKENDS = ("oracle", "roofline")
SCHEDULES = ("gpipe", "1f1b", "zb-h1")


def _plain(obj):
    """A value with every dataclass, dict and tuple reduced to dicts, lists
    and floats, so ``==`` compares bits across the two packages' types."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _pair(backend, hw_name="tpu-v5e"):
    return (ref_backends.get_predictor(backend, ref_hardware.get_hw(hw_name)),
            get_predictor(backend, get_hw(hw_name)))


# ----------------------------------------------------------------------
# the workload generator: the same calls for every arch and shape
# ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_layer_and_model_calls_equal_reference_over_a_grid(arch):
    ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
    for B in (1, 3, 8):
        for qlen, kvlen in ((1, 1), (1, 777), (64, 64), (513, 513)):
            for tp in (1, 2, 8):
                args = (B, qlen, kvlen, tp)
                assert _plain(layer_calls(cfg, *args)) == _plain(
                    ref_e2e.layer_calls(ref_cfg, *args)), (arch, args)
                assert _plain(model_calls(cfg, *args)) == _plain(
                    ref_e2e.model_calls(ref_cfg, *args)), (arch, args)


def test_apply_tuned_and_request_calls_equal_reference():
    tuned = {"fused_moe": {"block_m": 64, "block_f": 128}, "attention": {"block_q": 256}}
    for arch in ("dbrx-132b", "qwen3-0.6b", "whisper-base"):
        ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
        assert _plain(model_calls(cfg, 2, 16, 16, 2, tuned)) == _plain(
            ref_e2e.model_calls(ref_cfg, 2, 16, 16, 2, tuned))
        for pp in (1, 2, 3, 4):
            for sched in SCHEDULES:
                kw = dict(tp=2, pp=pp, pp_schedule=sched, pp_interleave=3, tuned=tuned)
                assert _plain(e2e.request_calls(cfg, 2, 100, 20, **kw)) == _plain(
                    ref_e2e.request_calls(ref_cfg, 2, 100, 20, **kw)), (arch, pp, sched)
    calls = [KernelCall("fused_moe", {"M": 4, "block_m": 32}), CommCall("p2p", 8.0, 2),
             ("g", 2, [KernelCall("gemm", {"M": 1, "N": 2, "K": 3})])]
    ref_calls = [ref_e2e.KernelCall("fused_moe", {"M": 4, "block_m": 32}),
                 ref_e2e.CommCall("p2p", 8.0, 2),
                 ("g", 2, [ref_e2e.KernelCall("gemm", {"M": 1, "N": 2, "K": 3})])]
    assert _plain(e2e.apply_tuned(calls, tuned)) == _plain(ref_e2e.apply_tuned(ref_calls, tuned))
    assert e2e.apply_tuned(calls, None) is calls


# ----------------------------------------------------------------------
# pricing: the same Estimate on the oracle and roofline backends
# ----------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", list_archs())
def test_step_estimate_equals_reference(arch, backend):
    ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
    ref_p, p = _pair(backend)
    for B, qlen, kvlen, tp in ((4, 1, 1024, 1), (2, 256, 256, 4)):
        est = e2e.step_estimate(cfg, B, qlen, kvlen, tp=tp, predictor=p)
        ref = ref_e2e.step_estimate(ref_cfg, B, qlen, kvlen, tp=tp, predictor=ref_p)
        assert _plain(est) == _plain(ref), (arch, B, qlen, kvlen, tp)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("pp", [1, 2, 3, 4])
def test_request_estimate_equals_reference(pp, backend):
    ref_p, p = _pair(backend)
    for arch in ("dbrx-132b", "deepseek-67b"):
        ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
        for sched in SCHEDULES:
            for overlap in (False, True):
                kw = dict(tp=4, pp=pp, pp_schedule=sched, comm_overlap=overlap)
                if sched != "gpipe":
                    kw.update(pp_microbatches=3, pp_interleave=2)
                est = e2e.request_estimate(cfg, 4, 256, 32, predictor=p, **kw)
                ref = ref_e2e.request_estimate(ref_cfg, 4, 256, 32, predictor=ref_p, **kw)
                assert _plain(est) == _plain(ref), (arch, kw)
    lat = dict(tp=4, pp=pp)
    assert e2e.request_latency(cfg, 4, 256, 32, predictor=p, **lat) == \
        ref_e2e.request_latency(ref_cfg, 4, 256, 32, predictor=ref_p, **lat)


def test_legacy_two_lambda_pricing_equals_reference():
    ref_cfg, cfg = ref_get_arch("qwen3-0.6b"), get_arch("qwen3-0.6b")
    kt, ct = oracle_times(HW)
    rkt, rct = ref_e2e.oracle_times(ref_hardware.get_hw("tpu-v5e"))
    assert step_time(cfg, 8, 1, 512, tp=2, kernel_time=kt, comm_time=ct) == \
        ref_e2e.step_time(ref_cfg, 8, 1, 512, tp=2, kernel_time=rkt, comm_time=rct)
    assert request_latency(cfg, 4, 128, 16, tp=2, pp=2, kernel_time=kt, comm_time=ct) == \
        ref_e2e.request_latency(ref_cfg, 4, 128, 16, tp=2, pp=2, kernel_time=rkt,
                                comm_time=rct)
    with pytest.raises(TypeError):
        step_time(cfg, 1, 1, 1, tp=1)
    with pytest.raises(TypeError):
        step_time(cfg, 1, 1, 1, tp=1, predictor=get_predictor("oracle", HW), kernel_time=kt)


def test_request_sweep_and_fleet_entry_points():
    ref_cfg, cfg = ref_get_arch("dbrx-132b"), get_arch("dbrx-132b")
    hws = ["tpu-v5e", "tpu-v6e", "tpu-v4"]
    for pp, overlap in ((1, False), (2, True)):
        kw = dict(tp=2, pp=pp, comm_overlap=overlap, backend="roofline")
        res = e2e.request_sweep(cfg, 2, 64, 8, hws=hws, **kw)
        ref = ref_e2e.request_sweep(ref_cfg, 2, 64, 8, hws=hws, **kw)
        assert _plain(res.estimates) == _plain(ref.estimates)
    with pytest.raises(TypeError):
        e2e.request_sweep(cfg, 2, 64, 8, hws=hws, sweep=SweepPredictor(hws, "roofline"))
    # the fleet layer: place_request and simulate_fleet equal the reference's
    for pp, overlap in ((1, False), (2, True)):
        kw = dict(tp=2, pp=pp, comm_overlap=overlap, backend="roofline", hws=hws,
                  objective="cost_per_token")
        assert _plain(e2e.place_request(cfg, 2, 64, 8, **kw)) == \
            _plain(ref_e2e.place_request(ref_cfg, 2, 64, 8, **kw))
    kw = dict(tp=2, rate_rps=2.0, n_requests=50, backend="oracle", hws=hws, replicas=2, seed=4)
    rep, ref_rep = e2e.simulate_fleet(cfg, 2, 64, 8, **kw), ref_e2e.simulate_fleet(ref_cfg, 2, 64, 8, **kw)
    assert rep.latencies.tobytes() == ref_rep.latencies.tobytes()
    assert _plain(dataclasses.replace(rep, latencies=None)) == \
        _plain(dataclasses.replace(ref_rep, latencies=None))


# ----------------------------------------------------------------------
# pipeline schedule analytics
# ----------------------------------------------------------------------


def test_schedule_analytics_equal_reference():
    assert pipeline.SCHEDULES == ref_pipeline.SCHEDULES
    assert pipeline._PHASES == ref_pipeline._PHASES
    for S in range(1, 9):
        for M in range(1, 17):
            assert pipeline.pipeline_bubble_fraction(S, M) == \
                ref_pipeline.pipeline_bubble_fraction(S, M)
            for sched in SCHEDULES:
                for V in (1, 2, 3):
                    args = (S, M, sched, V)
                    ticks = pipeline.schedule_ticks(*args)
                    assert ticks == ref_pipeline.schedule_ticks(*args) == \
                        pipeline.simulate_schedule(*args), args
                    assert pipeline.bubble_fraction(*args) == ref_pipeline.bubble_fraction(*args)
                    assert e2e.pp_bubble(S, M, sched, V) == ref_e2e.pp_bubble(S, M, sched, V)
                    assert e2e.pp_boundary_hops(S, sched, V) == \
                        ref_e2e.pp_boundary_hops(S, sched, V)
    assert e2e._pp_bubble is e2e.pp_bubble and e2e.pp_bubble(4) == ref_e2e.pp_bubble(4)
    with pytest.raises(ValueError):
        pipeline.schedule_ticks(2, 4, "interleaved")
    with pytest.raises(ValueError):
        pipeline.schedule_ticks(0, 4)
    with pytest.raises(ValueError):
        pipeline.schedule_ticks(2, 4, "1f1b", interleave=0)


# ----------------------------------------------------------------------
# the sweep
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def trace():
    return [(f"decode@{64 + i}", 1.0, model_calls(get_arch("qwen3-0.6b"), 4, 1, 64 + i, tp=1))
            for i in range(4)] + [("prefill", 1.0, model_calls(get_arch("dbrx-132b"), 1, 33, 33,
                                                                 tp=2))]


@pytest.fixture(scope="module")
def ref_trace():
    return [(f"decode@{64 + i}", 1.0,
             ref_e2e.model_calls(ref_get_arch("qwen3-0.6b"), 4, 1, 64 + i, tp=1))
            for i in range(4)] + [("prefill", 1.0, ref_e2e.model_calls(
                ref_get_arch("dbrx-132b"), 1, 33, 33, tp=2))]


def test_roofline_sweep_over_the_full_registry_equals_reference(trace, ref_trace):
    sp = SweepPredictor(backend="roofline")
    ref_sp = ref_sweep.SweepPredictor(backend="roofline")
    assert sp.hw_names == ref_sp.hw_names == sorted(REGISTRY, key=list(REGISTRY).index)
    res, ref = sp.predict(trace), ref_sp.predict(ref_trace)
    assert list(res) == list(ref) and len(res) == len(REGISTRY)
    assert _plain(res.estimates) == _plain(ref.estimates)
    assert res.totals() == ref.totals()
    assert res.table() == ref.table()
    assert _plain(res.scaled(1.5).estimates) == _plain(ref.scaled(1.5).estimates)
    assert _plain(res.overlapped().estimates) == _plain(ref.overlapped().estimates)
    steps, ref_steps = sp.predict_steps(trace), ref_sp.predict_steps(ref_trace)
    assert _plain(steps) == _plain(ref_steps)
    # the sweep is exact: each entry equals an independent predict
    for name in sp.hw_names:
        ind = get_predictor("roofline", get_hw(name)).predict(trace)
        assert res[name].total_s == ind.total_s


def test_sweep_compare_and_helpers_equal_reference(trace, ref_trace):
    hws = ["tpu-v5e", "tpu-v4", "tpu-v6e", "tpu-v7p"]
    cmp = SweepPredictor(hws, "roofline").compare(trace)
    ref = ref_sweep.SweepPredictor(hws, "roofline").compare(ref_trace)
    assert _plain(cmp) == _plain(ref)
    assert cmp.table() == ref.table()
    assert _plain(cmp.split_mape()) == _plain(ref.split_mape())
    assert cmp.family_mape() == ref.family_mape()
    for name in list(REGISTRY) + ["not-a-tpu"]:
        assert sweep.hw_split(name) == ref_sweep.hw_split(name)
    with pytest.raises(ValueError):
        SweepPredictor([], "roofline")
    with pytest.raises(ValueError):
        SweepPredictor(["tpu-v5e", "tpu-v5e"], "roofline")
    with pytest.raises(TypeError):
        sweep.check_prebuilt_exclusive("sweep", object(), ["tpu-v5e"], "synperf", {})
    with pytest.raises(ValueError, match="key the mapping"):
        SweepPredictor(predictors={"tpu-v4": get_predictor("roofline", get_hw("tpu-v5e"))})


# ----------------------------------------------------------------------
# tests/test_e2e.py, on the port
# ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_layer_calls_cover_every_arch(arch):
    cfg = get_arch(arch)
    calls = layer_calls(cfg, B=4, qlen=128, kvlen=128, tp=2)
    assert calls, arch
    kinds = {c.kind for c in calls if isinstance(c, KernelCall)}
    if cfg.family == "moe":
        assert "fused_moe" in kinds
    if cfg.family in ("dense", "moe", "hybrid", "audio", "vlm"):
        assert "attention" in kinds
    if cfg.family in ("ssm", "hybrid"):
        assert "gemm" in kinds
    assert any(isinstance(c, CommCall) for c in calls)


def test_tp_reduces_per_unit_kernel_work():
    cfg = get_arch("deepseek-67b")
    kt, _ = oracle_times(HW)
    t1 = step_time(cfg, 4, 512, 512, tp=1, kernel_time=kt, comm_time=lambda *a: 0.0)
    t4 = step_time(cfg, 4, 512, 512, tp=4, kernel_time=kt, comm_time=lambda *a: 0.0)
    assert t4 < t1


def test_decode_step_cheaper_than_prefill():
    cfg = get_arch("qwen3-0.6b")
    kt, ct = oracle_times(HW)
    pre = step_time(cfg, 8, 1024, 1024, tp=1, kernel_time=kt, comm_time=ct)
    dec = step_time(cfg, 8, 1, 1024, tp=1, kernel_time=kt, comm_time=ct)
    assert dec < pre / 3


def test_comm_regressor_fits_oracle():
    reg = CommRegressor().fit(HW)
    errs = []
    rng = np.random.default_rng(3)
    for _ in range(30):
        nbytes = float(np.exp(rng.uniform(np.log(1e4), np.log(5e8))))
        n = int(rng.choice([2, 4, 8]))
        t_true = hwsim.simulate_comm("all_reduce", nbytes, n, HW)
        errs.append(abs(reg.predict("all_reduce", nbytes, n) - t_true) / t_true)
    assert np.mean(errs) < 0.25, np.mean(errs)


def test_request_latency_monotone_in_output_len():
    cfg = get_arch("qwen3-0.6b")
    kt, ct = oracle_times(HW)
    t_short = request_latency(cfg, 4, 512, 16, tp=1, kernel_time=kt, comm_time=ct)
    t_long = request_latency(cfg, 4, 512, 128, tp=1, kernel_time=kt, comm_time=ct)
    assert t_long > t_short


def test_pp_adds_bubble():
    cfg = get_arch("deepseek-67b")
    kt, ct = oracle_times(HW)
    t1 = request_latency(cfg, 4, 256, 16, tp=4, pp=1, kernel_time=kt, comm_time=ct)
    t2 = request_latency(cfg, 4, 256, 16, tp=4, pp=2, kernel_time=kt, comm_time=ct)
    assert t2 > t1
