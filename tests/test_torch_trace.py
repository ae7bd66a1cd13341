"""The port's serving trace, residual monitor and predicted admission
against the reference's. Both engines record into ``serve.trace
.TraceRecorder``; on the same requests and weights the port's recorded
``StepMeta``s (all but the measured seconds) and call groups, and the
predicted-admission logs, equal the reference's. The reference's
``tests/test_trace_residuals.py`` (all but its mesh test), the recorder
round trips of ``tests/test_sweep.py`` and the predicted-admission tests of
``tests/test_placement.py`` are mirrored on the port."""
import dataclasses
import math

import jax
import numpy as np
import pytest

import repro.models.transformer as RT
from repro.configs import get_arch as ref_get_arch
from repro.core import e2e as ref_e2e
from repro.core import hardware as ref_hardware
from repro.predict import backends as ref_backends
from repro.serve import engine as ref_engine
from repro.serve import monitor as ref_monitor
from repro.serve import trace as ref_trace
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.e2e import model_calls
from repro_torch.core.hardware import get_hw
from repro_torch.predict import FeatureCache, SweepPredictor, get_predictor
from repro_torch.serve import monitor
from repro_torch.serve.engine import ContinuousBatchingEngine, Request, ServeEngine
from repro_torch.serve.monitor import ResidualMonitor, step_predicted_s, trace_residuals
from repro_torch.serve.trace import StepMeta, TraceRecorder, step_calls

HW = get_hw("tpu-v5e")


def _plain(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _unmeasured(meta):
    return [_plain(dataclasses.replace(m, measured_s=0.0)) for m in meta]


@pytest.fixture(scope="module")
def predictor():
    return get_predictor("oracle", HW)


@pytest.fixture(scope="module")
def cfg():
    return get_arch("qwen3-0.6b").smoke()


@pytest.fixture(scope="module")
def pair():
    """The f32 smoke config in both packages, with the reference's weights."""
    ref_cfg = dataclasses.replace(ref_get_arch("qwen3-0.6b").smoke(), compute_dtype="float32")
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke(), compute_dtype="float32")
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return ref_cfg, ref_params, cfg, params


def _prompts(n, seed, lo=6, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, int(rng.integers(lo, hi))).astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module")
def served(cfg):
    """One recorded ServeEngine run: (recorder, results)."""
    rec = TraceRecorder()
    eng = ServeEngine(cfg, max_batch=2, recorder=rec, device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(1, 13, dtype=np.int32), max_new=3))
    eng.submit(Request(rid=1, prompt=np.arange(1, 9, dtype=np.int32), max_new=3))
    return rec, eng.step_batch()


# ----------------------------------------------------------------------
# the recorder and the engines, against the reference
# ----------------------------------------------------------------------


def test_step_calls_and_recorder_equal_reference():
    for arch in ("qwen3-0.6b", "dbrx-132b"):
        ref_cfg, cfg = ref_get_arch(arch).smoke(), get_arch(arch).smoke()
        for pp, sched in ((1, "gpipe"), (2, "1f1b"), (3, "zb-h1")):
            kw = dict(pp_schedule=sched, pp_interleave=2, tuned={"attention": {"block_q": 64}})
            assert _plain(step_calls(cfg, 2, 7, 9, 2, pp, **kw)) == _plain(
                ref_trace.step_calls(ref_cfg, 2, 7, 9, 2, pp, **kw))
        rec, ref = TraceRecorder(tp=2, pp=2), ref_trace.TraceRecorder(tp=2, pp=2)
        for r in (rec, ref):
            r.record_step("prefill", cfg if r is rec else ref_cfg, 2, 16, 16, phase="prefill")
            r.mark_measured(0.5)
            r.record_step("decode", cfg if r is rec else ref_cfg, 2, 1, 17, active=1)
            r.record("custom", [], phase="other")
        assert _plain(rec.meta) == _plain(ref.meta)
        assert _plain(rec.calls()) == _plain(ref.calls())
        assert rec.labels() == ref.labels() and rec.phases() == ref.phases()
        assert _plain(rec.split_calls()) == _plain(ref.split_calls())
        assert (rec.decode_tokens, rec.prefill_tokens, rec.generated_tokens, rec.n_steps) == (
            ref.decode_tokens, ref.prefill_tokens, ref.generated_tokens, ref.n_steps)
    with pytest.raises(ValueError):
        TraceRecorder().record_step("x", cfg, 1, 1, 1, phase="warmup")
    rec = TraceRecorder(tp=4)
    with pytest.warns(DeprecationWarning, match="mesh wins"):
        rec.bind_mesh(2, 1)
    assert (rec.resolved_tp, rec.resolved_pp) == (2, 1)


def test_serve_engine_records_the_reference_steps(pair):
    ref_cfg, ref_params, cfg, params = pair
    prompts = _prompts(5, seed=0)
    ref_rec, rec = ref_trace.TraceRecorder(), TraceRecorder()
    ref = ref_engine.ServeEngine(ref_cfg, params=ref_params, max_batch=3, recorder=ref_rec)
    eng = ServeEngine(cfg, params=params, max_batch=3, recorder=rec, device="cpu")
    for i, p in enumerate(prompts):
        ref.submit(ref_engine.Request(rid=i, prompt=p, max_new=[4, 2][i % 2]))
        eng.submit(Request(rid=i, prompt=p, max_new=[4, 2][i % 2]))
    ref_out, out = [], []
    while ref.queue:
        ref_out += ref.step_batch()
    while eng.queue:
        out += eng.step_batch()
    assert [(r.rid, r.tokens) for r in out] == [(r.rid, r.tokens) for r in ref_out]
    assert _unmeasured(rec.meta) == _unmeasured(ref_rec.meta)
    assert _plain(rec.calls()) == _plain(ref_rec.calls())
    assert all(m.measured_s > 0 for m in rec.meta)


def test_continuous_engine_records_the_reference_steps(pair):
    ref_cfg, ref_params, cfg, params = pair
    prompts = _prompts(5, seed=1)
    ref_rec, rec = ref_trace.TraceRecorder(), TraceRecorder()
    ref = ref_engine.ContinuousBatchingEngine(ref_cfg, slots=2, max_len=48, params=ref_params,
                                              recorder=ref_rec)
    eng = ContinuousBatchingEngine(cfg, slots=2, max_len=48, params=params, recorder=rec,
                                   device="cpu")
    for i, p in enumerate(prompts):
        ref.submit(ref_engine.Request(rid=i, prompt=p, max_new=[5, 3, 4][i % 3]))
        eng.submit(Request(rid=i, prompt=p, max_new=[5, 3, 4][i % 3]))
    ref_out = {r.rid: r.tokens for r in ref.run_to_completion()}
    assert {r.rid: r.tokens for r in eng.run_to_completion()} == ref_out
    assert _unmeasured(rec.meta) == _unmeasured(ref_rec.meta)
    assert _plain(rec.calls()) == _plain(ref_rec.calls())
    assert all(m.measured_s > 0 for m in rec.meta)


# ----------------------------------------------------------------------
# predicted admission, against the reference
# ----------------------------------------------------------------------


def _admission_pair(pair, predictor_pair, slo, prompts, max_new, slots=2, max_len=48):
    ref_cfg, ref_params, cfg, params = pair
    ref_pred, pred = predictor_pair
    ref = ref_engine.ContinuousBatchingEngine(
        ref_cfg, slots=slots, max_len=max_len, params=ref_params,
        recorder=ref_trace.TraceRecorder(), admission="predicted", predictor=ref_pred,
        decode_slo_s=slo)
    eng = ContinuousBatchingEngine(
        cfg, slots=slots, max_len=max_len, params=params, recorder=TraceRecorder(),
        admission="predicted", predictor=pred, decode_slo_s=slo, device="cpu")
    for i, p in enumerate(prompts):
        ref.submit(ref_engine.Request(rid=i, prompt=p, max_new=max_new[i]))
        eng.submit(Request(rid=i, prompt=p, max_new=max_new[i]))
    return ref, eng


@pytest.mark.parametrize("backend", ["oracle", "roofline"])
def test_predicted_admission_log_equals_reference(pair, backend):
    """The same decisions as the reference. Under the roofline, whose price
    grows with the KV span, long requests violate the SLO alone (forced,
    warned) and short ones are deferred while a long one runs, then
    admitted under the SLO; the oracle's seeded noise (a few percent) is
    larger than the KV span's effect at smoke widths, so its pattern is
    only held equal."""
    ref_cfg = pair[0]
    preds = (ref_backends.get_predictor(backend, ref_hardware.get_hw("tpu-v5e")),
             get_predictor(backend, HW))
    slo = preds[0].predict(ref_e2e.model_calls(ref_cfg, 2, 1, 26, tp=1)).total_s
    rng = np.random.default_rng(4)
    lens = [30, 8, 9, 28, 10, 7]
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in lens]
    max_new = [6, 3, 4, 5, 2, 3]
    ref, eng = _admission_pair(pair, preds, slo, prompts, max_new)
    with pytest.warns(UserWarning, match="admitting anyway"):
        ref_out = {r.rid: r.tokens for r in ref.run_to_completion()}
    with pytest.warns(UserWarning, match="admitting anyway"):
        out = {r.rid: r.tokens for r in eng.run_to_completion()}
    assert out == ref_out and sorted(out) == list(range(len(lens)))
    assert eng.admission_log == ref.admission_log
    assert eng.slo_forced_admits == ref.slo_forced_admits > 0
    if backend == "roofline":
        assert any(not d["admitted"] for d in eng.admission_log)
        assert any(d["admitted"] and not d["forced"] for d in eng.admission_log)
    assert _unmeasured(eng.recorder.meta) == _unmeasured(ref.recorder.meta)
    assert _plain(eng.recorder.calls()) == _plain(ref.recorder.calls())


class _Unpriced:
    """A predictor that cannot price a step (the trained estimator it would
    stand for is not ported): ``predict`` raises ``RuntimeError``."""

    hw = None

    def predict(self, calls):
        raise RuntimeError("no model for kernel family 'gemm'")


def test_predicted_admission_falls_back_like_the_reference(pair):
    ref, eng = _admission_pair(pair, (_Unpriced(), _Unpriced()), 1.0, _prompts(3, seed=2),
                               [3, 2, 3])
    for e in (ref, eng):
        with pytest.warns(UserWarning, match="falling back to fixed"):
            out = e.run_to_completion()
        assert sorted(r.rid for r in out) == [0, 1, 2]
        assert e.admission == "fixed" and e.admission_log == []
    assert eng.admission_fallback_reason == ref.admission_fallback_reason
    assert "RuntimeError" in eng.admission_fallback_reason


# ----------------------------------------------------------------------
# the residual monitor, against the reference
# ----------------------------------------------------------------------


def test_monitor_equals_reference_on_random_streams():
    rng = np.random.default_rng(7)
    for window, threshold, sustain, min_samples in ((4, 0.2, 2, None), (64, 0.25, 8, 3),
                                                    (1, 0.5, 1, 1)):
        kw = dict(window=window, threshold=threshold, sustain=sustain, min_samples=min_samples)
        mon, ref = ResidualMonitor(**kw), ref_monitor.ResidualMonitor(**kw)
        for i in range(300):
            cls, hw = f"c{i % 3}", f"h{i % 2}"
            m, p = float(rng.uniform(0.5, 2.0)), float(rng.uniform(0.5, 1.5))
            if i > 150:
                m *= 1.6  # a step drift
            ev = mon.observe(cls, hw, m, p, t=float(i))
            assert _plain(ev) == _plain(ref.observe(cls, hw, m, p, t=float(i)))
        assert _plain(mon.events) == _plain(ref.events) and mon.events
        assert mon.keys() == ref.keys() and mon.corrections() == ref.corrections()
        for cls, hw in mon.keys():
            assert mon.ewma(cls, hw) == ref.ewma(cls, hw)
            assert mon.window_samples(cls, hw) == ref.window_samples(cls, hw)
        mon.reset(), ref.reset()
        assert mon.n_observed == ref.n_observed == 0 and len(mon.events) == len(ref.events)
    for bad in (dict(window=0), dict(threshold=0.0), dict(sustain=0)):
        with pytest.raises(ValueError):
            ResidualMonitor(**bad)
    with pytest.raises(ValueError):
        ResidualMonitor().observe("c", "h", float("nan"), 1.0)


def test_drift_specs_equal_reference():
    specs = [monitor.DriftSpec("tpu-v5e", 2.0, t_start=1.0),
             monitor.DriftSpec("tpu-v5e", 0.5, t_start=2.0, mode="ramp", t_end=6.0),
             monitor.DriftSpec("tpu-v6e", 3.0, mode="ramp", t_end=1.0)]
    ref_specs = [ref_monitor.DriftSpec(**dataclasses.asdict(s)) for s in specs]
    by_hw, ref_by_hw = monitor.resolve_drift(specs), ref_monitor.resolve_drift(ref_specs)
    assert _plain(by_hw) == _plain(ref_by_hw)
    for t in np.linspace(0.0, 8.0, 33):
        for hw in ("tpu-v5e", "tpu-v6e", "tpu-v4"):
            assert monitor.drift_factor(by_hw, hw, float(t)) == \
                ref_monitor.drift_factor(ref_by_hw, hw, float(t))
    assert _plain(monitor.resolve_drift({"a": 2.0})) == \
        _plain(ref_monitor.resolve_drift({"a": 2.0}))
    assert monitor.resolve_drift(None) == {}
    for bad in (dict(factor=0.0), dict(factor=2.0, mode="wave"), dict(factor=2.0, mode="ramp")):
        with pytest.raises(ValueError):
            monitor.DriftSpec("h", **bad)
    with pytest.raises(TypeError):
        monitor.resolve_drift([1.0])


# ----------------------------------------------------------------------
# tests/test_trace_residuals.py, on the port (its mesh test waits for A10)
# ----------------------------------------------------------------------


def test_serve_engine_stamps_every_step(served):
    rec, results = served
    assert rec.n_steps == 3
    assert rec.phases() == ["prefill", "decode", "decode"]
    assert all(m.measured_s > 0 for m in rec.meta)
    assert rec.meta[0].measured_s == results[0].prefill_s


def test_continuous_engine_stamps_every_step(cfg):
    rec = TraceRecorder()
    eng = ContinuousBatchingEngine(cfg, slots=2, max_len=48, recorder=rec, device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(1, 11, dtype=np.int32), max_new=3))
    results = eng.run_to_completion()
    assert all(m.measured_s > 0 for m in rec.meta)
    admit = next(m for m in rec.meta if m.phase == "prefill")
    assert admit.measured_s == results[0].prefill_s
    assert results[0].latency_s > 0


def test_mark_measured_guards(cfg):
    rec = TraceRecorder()
    with pytest.raises(RuntimeError):
        rec.mark_measured(0.1)
    rec.record_step("s", cfg, 1, 4, 4)
    with pytest.raises(ValueError):
        rec.mark_measured(-1.0)


def test_relowered_meta_predicts_exactly_like_recorded_calls(served, cfg, predictor):
    rec, _ = served
    for (_, _, calls), meta in zip(rec.steps, rec.meta):
        live = predictor.predict(calls).total_s
        assert live > 0
        assert step_predicted_s(meta, cfg, predictor) == live


def test_round_trip_at_declared_degrees(predictor):
    cfg = get_arch("dbrx-132b").smoke()
    rec = TraceRecorder(tp=2, pp=2)
    rec.record_step("prefill", cfg, 2, 16, 16, phase="prefill")
    rec.record_step("decode", cfg, 2, 1, 17, phase="decode")
    for (_, _, calls), meta in zip(rec.steps, rec.meta):
        assert meta.tp == 2 and meta.pp == 2
        assert step_predicted_s(meta, cfg, predictor) == predictor.predict(calls).total_s


def test_trace_residuals_reproduce_live_measurements(served, predictor):
    rec, _ = served
    res = trace_residuals(rec, predictor)
    assert len(res) == rec.n_steps
    assert [r.label for r in res] == rec.labels()
    assert [r.measured_s for r in res] == [m.measured_s for m in rec.meta]
    for r in res:
        assert r.hw == HW.name
        assert r.predicted_s > 0 and np.isfinite(r.ratio) and r.ratio > 0
    ts = [r.t for r in res]
    assert all(b > a for a, b in zip(ts, ts[1:]))
    assert ts[-1] == pytest.approx(sum(m.measured_s for m in rec.meta))


def test_unmeasured_steps_are_skipped(cfg, predictor):
    rec = TraceRecorder()
    rec.record_step("measured", cfg, 1, 8, 8, phase="prefill")
    rec.mark_measured(0.25)
    rec.record("pre-lowered", [], phase="other")
    rec.record_step("also-unmeasured", cfg, 1, 1, 9, phase="decode")
    res = trace_residuals(rec, predictor)
    assert [r.label for r in res] == ["measured"]
    assert res[0].measured_s == 0.25


def test_monitor_observe_trace(served, predictor):
    rec, _ = served
    mon = ResidualMonitor()
    mon.observe_trace(rec, predictor)
    assert mon.n_observed == rec.n_steps
    assert mon.keys() == [("trace", HW.name)]
    assert mon.ewma("trace", HW.name) > 0


def test_monitor_observe_results(served):
    rec, results = served
    mon = ResidualMonitor(window=4, threshold=0.5, sustain=1, min_samples=1)
    events = mon.observe_results(results, predicted_s=results[0].latency_s * 10.0,
                                 cls="chat", hw=HW.name)
    assert len(events) == len(results)
    assert mon.events == events
    assert events[0].t == pytest.approx(results[0].latency_s)


# ----------------------------------------------------------------------
# tests/test_sweep.py's recorder round trips, on the port
# ----------------------------------------------------------------------


def test_trace_recorder_roundtrip_serve_engine(cfg):
    rec = TraceRecorder()
    eng = ServeEngine(cfg, max_batch=2, recorder=rec, device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(1, 13, dtype=np.int32), max_new=3))
    results = eng.step_batch()
    assert len(results) == 1 and len(results[0].tokens) == 3
    assert rec.labels() == ["prefill[b1xL12]", "decode@12", "decode@13"]
    oracle = get_predictor("oracle", HW)
    est = oracle.predict(rec.calls())
    manual = [("prefill", 1.0, model_calls(cfg, 1, 12, 12, 1)),
              ("d0", 1.0, model_calls(cfg, 1, 1, 13, 1)),
              ("d1", 1.0, model_calls(cfg, 1, 1, 14, 1))]
    ref = oracle.predict(manual)
    assert np.isclose(est.total_s, ref.total_s, rtol=1e-12)
    assert est.n_kernel_calls == ref.n_kernel_calls
    rec.clear()
    assert rec.n_steps == 0 and rec.calls() == []


def test_trace_recorder_roundtrip_continuous_engine(cfg):
    rec = TraceRecorder()
    eng = ContinuousBatchingEngine(cfg, slots=2, max_len=48, recorder=rec, device="cpu")
    for i in range(3):
        eng.submit(Request(rid=i, prompt=np.arange(1, 10, dtype=np.int32), max_new=2))
    out = eng.run_to_completion()
    assert sorted(r.rid for r in out) == [0, 1, 2]
    labels = rec.labels()
    assert labels.count("admit#0[L9]") == 1 and labels.count("admit#2[L9]") == 1
    assert any(label.startswith("tick[") for label in labels)
    res = SweepPredictor(["tpu-v5e", "tpu-v6e"], backend="oracle").predict(rec.calls())
    assert res["tpu-v5e"].total_s > 0 and res["tpu-v6e"].total_s > 0


def test_trace_recorder_untracked_engine_records_nothing(cfg):
    eng = ServeEngine(cfg, max_batch=1, device="cpu")
    assert eng.recorder is None
    eng.submit(Request(rid=0, prompt=np.arange(1, 9, dtype=np.int32), max_new=2))
    assert len(eng.step_batch()) == 1


# ----------------------------------------------------------------------
# tests/test_placement.py's predicted-admission tests, on the port
# ----------------------------------------------------------------------


def _reqs(n, max_new=3, L=10):
    return [Request(rid=i, prompt=np.arange(1, L + 1, dtype=np.int32), max_new=max_new)
            for i in range(n)]


def test_predicted_admission_never_exceeds_slo(cfg):
    pred = get_predictor("oracle", HW, cache=FeatureCache())
    slots, max_len = 2, 48
    slo = pred.predict(model_calls(cfg, slots, 1, max_len, tp=1)).total_s * 1.05
    rec = TraceRecorder()
    eng = ContinuousBatchingEngine(cfg, slots=slots, max_len=max_len, recorder=rec,
                                   admission="predicted", predictor=pred, decode_slo_s=slo,
                                   device="cpu")
    for r in _reqs(4):
        eng.submit(r)
    out = eng.run_to_completion()
    assert sorted(r.rid for r in out) == [0, 1, 2, 3]
    assert eng.slo_forced_admits == 0
    assert len(eng.admission_log) >= 4
    for d in eng.admission_log:
        assert d["admitted"] and not d["forced"] and d["predicted_s"] <= slo
    ticks = [s for s, m in zip(rec.steps, rec.meta) if m.phase == "decode"]
    assert ticks and max(pred.predict([t]).total_s for t in ticks) <= slo


def test_predicted_admission_defers_but_makes_progress(cfg):
    pred = get_predictor("oracle", HW, cache=FeatureCache())
    eng = ContinuousBatchingEngine(cfg, slots=2, max_len=48, admission="predicted",
                                   predictor=pred, decode_slo_s=1e-9, device="cpu")
    for r in _reqs(3):
        eng.submit(r)
    with pytest.warns(UserWarning, match="admitting anyway"):
        out = eng.run_to_completion()
    assert sorted(r.rid for r in out) == [0, 1, 2]
    assert eng.slo_forced_admits == 3
    assert [d for d in eng.admission_log if not d["admitted"]]


def test_predicted_admission_falls_back_when_unpriced(cfg):
    eng = ContinuousBatchingEngine(cfg, slots=2, max_len=48, admission="predicted",
                                   predictor=_Unpriced(), decode_slo_s=1.0, device="cpu")
    for r in _reqs(3):
        eng.submit(r)
    with pytest.warns(UserWarning, match="falling back to fixed"):
        out = eng.run_to_completion()
    assert sorted(r.rid for r in out) == [0, 1, 2]
    assert eng.admission == "fixed"
    assert "RuntimeError" in eng.admission_fallback_reason
    assert eng.admission_log == []


def test_predicted_admission_requires_predictor_and_slo(cfg):
    with pytest.raises(ValueError, match="admission="):
        ContinuousBatchingEngine(cfg, admission="predicted", device="cpu")
    with pytest.raises(ValueError, match="'fixed' or 'predicted'"):
        ContinuousBatchingEngine(cfg, admission="adaptive", device="cpu")


def test_stepmeta_fields_equal_reference():
    assert [f.name for f in dataclasses.fields(StepMeta)] == [
        f.name for f in dataclasses.fields(ref_trace.StepMeta)]
    assert math.isclose(StepMeta("a", "decode", 1, 1, 1, 1).measured_s, 0.0)
