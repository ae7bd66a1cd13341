"""The port's trained predictor against the reference's, on the same inputs:
``optim.adamw``, ``core.nn``, ``core.estimator``, ``core.quantile``,
``core.baselines`` and the ``synperf``/baseline backends.

Float training code is held to the reference's f32 tolerance (2e-5): AdamW
over 20 steps, and ``mlp_forward`` with its loss gradients (``jax.grad``
against autograd) on the reference's initial weights. Everything numpy is
held *equal*: a reference ``TrainedMLP``/``PipeWeave`` crossed into the port
by ``convert`` predicts the same bits, and so do ``perf_gap``, the numpy
baselines, their feature builders and whole synperf ``Estimate``s. Training
itself is held by its outcome (``tests/test_core.py``'s gemm and ceiling
criteria, ``bench_kernel_mape``'s smoke criteria), since the JAX PRNG streams
are not reproduced. Everything here runs on the CPU (``device="cpu"``)."""
import dataclasses
import math
import pickle
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core import baselines as ref_baselines
from repro.core import dataset as ref_dataset
from repro.core import e2e as ref_e2e
from repro.core import estimator as ref_estimator
from repro.core import hardware as ref_hardware
from repro.core import nn as ref_nn
from repro.core import quantile as ref_quantile
from repro.optim import adamw as ref_adamw
from repro.predict import api as ref_api
from repro.predict import backends as ref_backends
from repro_torch.configs import get_arch
from repro_torch.convert import mlp_from_numpy, pipeweave_from_numpy
from repro_torch.core import baselines, dataset, e2e, nn, quantile
from repro_torch.core.dataset import SEEN, build_dataset, mape
from repro_torch.core.estimator import PICKLE_VERSION, PipeWeave, train_pipeweave
from repro_torch.core.hardware import get_hw
from repro_torch.optim import adamw
from repro_torch.predict import UntrainedFamilyError, api, get_predictor

TOL = dict(rtol=2e-5, atol=2e-5)  # f32, tests/test_kernels.py::_tol
CPU = "cpu"


@pytest.fixture(autouse=True)
def one_thread():
    """The MLP's small matmuls run fastest on one CPU thread, and several
    test workers with a thread per core each slow every step many times
    over; the count is restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


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


def _t(tree):
    """A numpy (or jax) tree as f32 CPU tensors."""
    return adamw.tree_map(lambda a: torch.tensor(np.asarray(a, np.float32)), tree)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def _cross_mlp(m) -> dict:
    """A reference ``TrainedMLP`` as ``mlp_from_numpy``'s arguments."""
    return dict(params=jax.tree.map(np.asarray, m.params), state=jax.tree.map(np.asarray, m.state),
                mu_x=m.mu_x, sd_x=m.sd_x, y_floor=m.y_floor, x_lo=m.x_lo, x_hi=m.x_hi)


def _cross(pw) -> PipeWeave:
    return pipeweave_from_numpy({k: _cross_mlp(m) for k, m in pw.models.items()})


@pytest.fixture(scope="module")
def small_ds():
    """``tests/test_predict.py``'s datasets, from the reference."""
    return {
        "gemm": ref_dataset.build_dataset("gemm", n_workloads=20, seed=3),
        "rmsnorm": ref_dataset.build_dataset("rmsnorm", n_workloads=12, seed=4),
    }


@pytest.fixture(scope="module")
def ref_pw(small_ds):
    return ref_estimator.train_pipeweave(small_ds, max_epochs=12)


@pytest.fixture(scope="module")
def ref_pw_gemm_only(small_ds):
    return ref_estimator.train_pipeweave({"gemm": small_ds["gemm"]}, max_epochs=8)


# ----------------------------------------------------------------------
# optim.adamw
# ----------------------------------------------------------------------


def _adam_tree(rng):
    return {"w": rng.normal(size=(4, 3)), "b": rng.normal(size=(3,)),
            "layers": [{"k": rng.normal(size=(2, 5))}, {"v": rng.normal(size=(5,))}]}


@pytest.mark.parametrize("sched", ["constant", "warmup_cosine"])
@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_matches_reference(sched, clip):
    """20 steps, decay on the 2-D leaves only, clipping on and off: params,
    moments, grad norm and lr within f32 2e-5."""
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), _adam_tree(rng))
    if sched == "constant":
        ref_lr, lr = ref_adamw.constant_lr(3e-2), adamw.constant_lr(3e-2)
    else:
        ref_lr, lr = ref_adamw.warmup_cosine(3e-2, 5, 15), adamw.warmup_cosine(3e-2, 5, 15)
    ref_opt = ref_adamw.AdamW(lr=ref_lr, clip_norm=clip)
    opt = adamw.AdamW(lr=lr, clip_norm=clip)
    ref_p, p = jax.tree.map(jnp.asarray, params), _t(params)
    ref_s, s = ref_opt.init(ref_p), opt.init(p)
    for _ in range(20):
        g = jax.tree.map(lambda a: np.asarray(a * 3.0, np.float32), _adam_tree(rng))
        ref_p, ref_s, ref_st = ref_opt.update(jax.tree.map(jnp.asarray, g), ref_s, ref_p)
        p, s, st = opt.update(_t(g), s, p)
        assert s.step == int(ref_s.step)
        _close(st["grad_norm"], ref_st["grad_norm"])
        assert st["lr"] == pytest.approx(float(ref_st["lr"]), rel=2e-5, abs=2e-5)
        for port, ref in ((p, ref_p), (s.mu, ref_s.mu), (s.nu, ref_s.nu)):
            jax.tree.map(lambda r, q: _close(q, r), ref, port)
    # the 1-D leaves were never decayed: zero gradients leave them still
    zero = adamw.tree_map(torch.zeros_like, p)
    fresh = adamw.AdamW(lr=lr, clip_norm=clip)
    moved, _, _ = fresh.update(zero, fresh.init(p), p)
    assert torch.equal(moved["b"], p["b"]) and not torch.equal(moved["w"], p["w"])


def test_schedules_match_reference():
    ref, port = ref_adamw.warmup_cosine(1e-3, 10, 100, floor=0.2), adamw.warmup_cosine(1e-3, 10, 100, floor=0.2)
    for step in range(0, 120, 3):
        assert port(step) == pytest.approx(float(ref(step)), rel=2e-5, abs=1e-12)
    assert adamw.constant_lr(0.5)(7) == float(ref_adamw.constant_lr(0.5)(7))


# ----------------------------------------------------------------------
# core.nn: init, forward, losses and gradients
# ----------------------------------------------------------------------


def _ref_init(in_dim=12, seed=0):
    params, state = ref_nn.init_mlp(jax.random.PRNGKey(seed), in_dim)
    rng = np.random.default_rng(seed)
    state = {  # running statistics away from their init, so eval mode is seen
        "bn_mean": [np.asarray(rng.normal(size=m.shape), np.float32) for m in state["bn_mean"]],
        "bn_var": [np.asarray(rng.uniform(0.5, 2.0, size=v.shape), np.float32)
                   for v in state["bn_var"]],
    }
    params = jax.tree.map(np.asarray, params)
    for layer in params["layers"]:
        if "bn_scale" in layer:
            layer["bn_scale"] = np.asarray(rng.uniform(0.5, 1.5, layer["bn_scale"].shape), np.float32)
            layer["bn_bias"] = np.asarray(rng.normal(size=layer["bn_bias"].shape) * 0.1, np.float32)
        layer["b"] = np.asarray(rng.normal(size=layer["b"].shape) * 0.1, np.float32)
    return params, state


@pytest.mark.parametrize("train", [False, True])
def test_mlp_forward_matches_reference(train):
    params, state = _ref_init()
    x = np.random.default_rng(1).normal(size=(64, 12)).astype(np.float32)
    ref_out, ref_state = ref_nn.mlp_forward(jax.tree.map(jnp.asarray, params),
                                            jax.tree.map(jnp.asarray, state), jnp.asarray(x),
                                            train=train)
    out, new_state = nn.mlp_forward(_t(params), _t(state), torch.tensor(x), train=train)
    _close(out, ref_out)
    assert len(new_state["bn_mean"]) == len(ref_state["bn_mean"]) == 3
    jax.tree.map(lambda r, q: _close(q, r), ref_state, new_state)


@pytest.mark.parametrize("loss", ["mape", "pinball"])
def test_loss_and_gradients_match_reference(loss):
    params, state = _ref_init()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(48, 12)).astype(np.float32)
    y = rng.uniform(0.0005, 1.0, 48).astype(np.float32)  # some below the 1e-3 floor

    def ref_fn(p):
        pred, _ = ref_nn.mlp_forward(p, jax.tree.map(jnp.asarray, state), jnp.asarray(x), train=True)
        if loss == "mape":
            return ref_nn.mape_loss(pred, jnp.asarray(y))
        return ref_nn.pinball_loss(pred, jnp.asarray(y), 0.8)

    ref_val, ref_grads = jax.value_and_grad(ref_fn)(jax.tree.map(jnp.asarray, params))
    p = _t(params)
    leaves = [t.requires_grad_() for t in adamw.tree_leaves(p)]
    pred, _ = nn.mlp_forward(p, _t(state), torch.tensor(x), train=True)
    val = nn.mape_loss(pred, torch.tensor(y)) if loss == "mape" else \
        nn.pinball_loss(pred, torch.tensor(y), 0.8)
    grads = adamw.tree_unflatten(p, torch.autograd.grad(val, leaves))
    _close(val, ref_val)
    jax.tree.map(lambda r, q: _close(q, r), ref_grads, grads)


def test_init_mlp_shapes_scale_and_seed():
    ref_params, ref_state = ref_nn.init_mlp(jax.random.PRNGKey(0), 44)
    params, state = nn.init_mlp(torch.Generator().manual_seed(0), 44)
    assert jax.tree.map(np.shape, ref_params) == adamw.tree_map(lambda t: tuple(t.shape), params)
    assert jax.tree.map(np.shape, ref_state) == adamw.tree_map(lambda t: tuple(t.shape), state)
    for a, (layer, ref_layer) in zip([44, *nn.HIDDEN], zip(params["layers"], ref_params["layers"])):
        w = layer["w"]
        want, n = math.sqrt(2.0 / a), w.numel()
        # the sample std of n normals is within 5 of its standard errors
        assert abs(float(w.std()) - want) < 5 * want / math.sqrt(2 * n), (a, float(w.std()))
        assert torch.equal(layer["b"], torch.zeros_like(layer["b"]))
        if "bn_scale" in ref_layer:
            assert torch.equal(layer["bn_scale"], torch.ones_like(layer["bn_scale"]))
    again, _ = nn.init_mlp(torch.Generator().manual_seed(0), 44)
    other, _ = nn.init_mlp(torch.Generator().manual_seed(1), 44)
    assert all(torch.equal(a, b) for a, b in zip(adamw.tree_leaves(params), adamw.tree_leaves(again)))
    assert not torch.equal(params["layers"][0]["w"], other["layers"][0]["w"])


def test_dropout_keeps_nine_tenths_scaled_and_is_seeded():
    h = torch.ones(512, 256)
    out = nn.apply_dropout(h, 0.1, torch.Generator().manual_seed(3))
    kept = out != 0
    frac, n = float(kept.float().mean()), h.numel()
    assert abs(frac - 0.9) < 5 * math.sqrt(0.09 / n), frac
    assert torch.equal(out[kept], torch.full_like(out[kept], 1 / 0.9))
    assert torch.equal(out, nn.apply_dropout(h, 0.1, torch.Generator().manual_seed(3)))
    assert not torch.equal(out, nn.apply_dropout(h, 0.1, torch.Generator().manual_seed(4)))
    # mlp_forward applies it only when given a generator
    params, state = _ref_init()
    x = torch.tensor(np.random.default_rng(1).normal(size=(32, 12)), dtype=torch.float32)
    run = lambda rng: nn.mlp_forward(_t(params), _t(state), x, train=True, rng=rng)[0]
    assert torch.equal(run(torch.Generator().manual_seed(5)), run(torch.Generator().manual_seed(5)))
    assert not torch.equal(run(torch.Generator().manual_seed(5)), run(None))


# ----------------------------------------------------------------------
# crossed weights: the numpy predictions are bit-equal
# ----------------------------------------------------------------------


def test_crossed_mlp_and_pipeweave_predict_equal(ref_pw, small_ds):
    pw = _cross(ref_pw)
    for kind, ds in small_ds.items():
        seen = np.array([h in SEEN for h in ds.hw_names])
        assert seen.any() and (~seen).any()
        assert np.array_equal(pw.models[kind].predict(ds.X), ref_pw.models[kind].predict(ds.X))
        assert np.array_equal(pw.predict_dataset(ds), ref_pw.predict_dataset(ds))
        assert np.array_equal(pw.predict_eff(kind, ds.X[~seen] * 3.0),
                              ref_pw.predict_eff(kind, ds.X[~seen] * 3.0))  # clipped envelope
    for hw_name in ("tpu-v5e", "tpu-v7p"):
        X = {"M": 128, "N": 512, "K": 256}
        assert pw.predict_latency("gemm", X, get_hw(hw_name)) == \
            ref_pw.predict_latency("gemm", X, ref_hardware.get_hw(hw_name))


def test_perf_gap_equal_with_crossed_ceiling():
    ds = ref_dataset.build_dataset("fused_moe", n_workloads=16, seed=6)
    ref_ceiling = ref_quantile.train_ceiling(ds, max_epochs=10)
    ceiling = quantile.CeilingModel(mlp_from_numpy(**_cross_mlp(ref_ceiling.model)),
                                    ref_ceiling.quantile)
    for threshold in (0.1, 0.0):
        ref, port = ref_quantile.perf_gap(ref_ceiling, ds, threshold), quantile.perf_gap(ceiling, ds, threshold)
        assert _plain(port) == _plain(ref)
        assert _plain(port.cdf()) == _plain(ref.cdf())


# ----------------------------------------------------------------------
# baselines
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gemm", "attention", "fused_moe"])
def test_numpy_baselines_and_feature_builders_equal(kind):
    ref_ds = ref_dataset.build_dataset(kind, n_workloads=12, seed=9)
    ds = dataset.build_dataset(kind, n_workloads=12, seed=9)
    for name in ("roofline", "linear"):
        ref, port = ref_baselines.BASELINES[name]().fit(ref_ds), baselines.BASELINES[name]().fit(ds)
        assert np.array_equal(port.predict(ds), ref.predict(ref_ds)), name
    assert _plain(baselines.LinearBaseline._feats(ds)) == _plain(ref_baselines.LinearBaseline._feats(ref_ds))
    assert _plain(baselines.HabitatBaseline._X(ds)) == _plain(ref_baselines.HabitatBaseline._X(ref_ds))
    assert _plain(baselines.NeusightBaseline()._X(ds)) == _plain(ref_baselines.NeusightBaseline()._X(ref_ds))
    for w, h in zip(ds.workloads[:5], ds.hw_names[:5]):
        hw, ref_hw = get_hw(h), ref_hardware.get_hw(h)
        assert _plain(baselines._raw_vector(w, hw)) == _plain(ref_baselines._raw_vector(w, ref_hw))
        assert _plain(baselines.NeusightBaseline._tile_feats(w, kind, hw)) == \
            _plain(ref_baselines.NeusightBaseline._tile_feats(w, kind, ref_hw))


@pytest.fixture(scope="module")
def ref_mlp_baselines(small_ds):
    return {name: ref_baselines.BASELINES[name]().fit(small_ds["gemm"])
            for name in ("habitat", "neusight")}


def _crossed_baseline(name, ref):
    port = baselines.BASELINES[name]()
    port.model = mlp_from_numpy(**_cross_mlp(ref.model))
    if name == "habitat":
        port.scale = ref.scale
    return port


@pytest.mark.parametrize("name", ["habitat", "neusight"])
def test_mlp_baselines_predict_equal_with_crossed_weights(name, ref_mlp_baselines, small_ds):
    ref = ref_mlp_baselines[name]
    port = _crossed_baseline(name, ref)
    for ds in (small_ds["gemm"], ref_dataset.build_dataset("gemm", n_workloads=6, seed=11)):
        assert np.array_equal(port.predict(ds), ref.predict(ds))


# ----------------------------------------------------------------------
# the predictor backends
# ----------------------------------------------------------------------

CALLS = [  # tests/test_predict.py's
    ("gemm", {"M": 256, "N": 1024, "K": 512}, 1),
    ("gemm", {"M": 256, "N": 1024, "K": 512}, 1),
    ("gemm", {"M": 8, "N": 2048, "K": 512}, 3),
    ("rmsnorm", {"seq": 64, "dim": 1024}, 1),
]


def _calls(mod):
    K = mod.KernelCall
    return [K(kind, X, count=c) for kind, X, c in CALLS] + [
        ("block", 4, [K("gemm", {"M": 8, "N": 2048, "K": 512}), K("rmsnorm", {"seq": 64, "dim": 1024})]),
        mod.CommCall("all_reduce", 1e6, 4),
    ]


@pytest.mark.parametrize("hw_name", ["tpu-v5e", "tpu-v6e", "tpu-v7p"])
def test_synperf_estimates_equal_with_crossed_estimator(ref_pw, hw_name):
    ref = ref_backends.get_predictor("synperf", ref_hardware.get_hw(hw_name), estimator=ref_pw)
    port = get_predictor("synperf", get_hw(hw_name), estimator=_cross(ref_pw))
    assert port.families() == ref.families() == {"gemm", "rmsnorm"}
    assert _plain(port.predict(_calls(api))) == _plain(ref.predict(_calls(ref_api)))
    assert port.kernel_time("gemm", {"M": 64, "N": 512, "K": 256}) == \
        ref.kernel_time("gemm", {"M": 64, "N": 512, "K": 256})


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b"])
def test_synperf_model_calls_equal(ref_pw, arch):
    """Every family a model step lowers to, gemm and rmsnorm on the model and
    the rest on the roofline fallback, recorded in ``Estimate.fallbacks``."""
    ref = ref_backends.get_predictor("synperf", ref_hardware.get_hw("tpu-v5e"), estimator=ref_pw,
                                     fallback="roofline")
    port = get_predictor("synperf", get_hw("tpu-v5e"), estimator=_cross(ref_pw), fallback="roofline")
    ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
    for B, qlen, kvlen, tp in ((4, 128, 128, 1), (8, 1, 2048, 2)):
        ref_est = ref.predict(ref_e2e.model_calls(ref_cfg, B, qlen, kvlen, tp))
        est = port.predict(e2e.model_calls(cfg, B, qlen, kvlen, tp))
        assert est.fallbacks and _plain(est) == _plain(ref_est)


@pytest.mark.parametrize("fallback", ["error", "oracle", "roofline"])
def test_synperf_fallback_policy_equal(ref_pw_gemm_only, fallback):
    ref = ref_backends.get_predictor("synperf", ref_hardware.get_hw("tpu-v5e"),
                                     estimator=ref_pw_gemm_only, fallback=fallback)
    port = get_predictor("synperf", get_hw("tpu-v5e"), estimator=_cross(ref_pw_gemm_only),
                         fallback=fallback)
    if fallback == "error":
        with pytest.raises(UntrainedFamilyError, match="rmsnorm"):
            port.predict(_calls(api))
        return
    est = port.predict(_calls(api))
    assert est.fallbacks == {"rmsnorm": fallback}
    assert _plain(est) == _plain(ref.predict(_calls(ref_api)))


@pytest.mark.parametrize("name", ["linear", "habitat", "neusight"])
def test_baseline_backends_equal(name, small_ds, ref_mlp_baselines):
    """The fitted-baseline backends: linear fitted by each package on the
    same rows, habitat and neusight with crossed MLPs."""
    if name == "linear":
        ds = dataset.build_dataset("gemm", n_workloads=20, seed=3)
        ref_model, port_model = ref_baselines.LinearBaseline().fit(small_ds["gemm"]), \
            baselines.LinearBaseline().fit(ds)
    else:
        ref_model = ref_mlp_baselines[name]
        port_model = _crossed_baseline(name, ref_model)
    calls = [c for c in _calls(api)[:3]]
    ref_calls = [c for c in _calls(ref_api)[:3]]
    ref = ref_backends.get_predictor(name, ref_hardware.get_hw("tpu-v6e"), models={"gemm": ref_model})
    port = get_predictor(name, get_hw("tpu-v6e"), models={"gemm": port_model})
    assert port.name == ref.name == name
    assert _plain(port.predict(calls)) == _plain(ref.predict(ref_calls))
    with pytest.raises(TypeError, match="models"):
        get_predictor(name, get_hw("tpu-v6e"))
    if name != "linear":  # the factory with a model the port fitted itself
        fitted = baselines.BASELINES[name]().fit(dataset.build_dataset("gemm", n_workloads=20, seed=3),
                                                 device=CPU)
        est = get_predictor(name, get_hw("tpu-v6e"), models={"gemm": fitted}).predict(calls)
        assert np.isfinite(est.kernel_s) and est.kernel_s > 0 and est.fallbacks == {}


# ----------------------------------------------------------------------
# pickles
# ----------------------------------------------------------------------


def test_pipeweave_pickle_roundtrip_and_version(ref_pw, small_ds, tmp_path):
    pw = _cross(ref_pw)
    p = str(tmp_path / "pw.pkl")
    pw.save(p)
    loaded = PipeWeave.load(p)
    for kind, ds in small_ds.items():
        assert np.array_equal(loaded.predict_dataset(ds), pw.predict_dataset(ds))
    assert isinstance(loaded.models["gemm"].params["layers"][0]["w"], np.ndarray)
    with open(p, "wb") as f:
        pickle.dump({"__pipeweave_version__": PICKLE_VERSION + 1, "models": pw.models}, f)
    with pytest.raises(RuntimeError, match="version"):
        PipeWeave.load(p)
    with open(p, "wb") as f:
        pickle.dump(pw, f)
    with pytest.raises(RuntimeError, match="pre-versioning"):
        PipeWeave.load(p)


def test_reference_pickle_is_refused(ref_pw, tmp_path, monkeypatch):
    """A pickle of the reference's estimator names ``repro`` and jax: the
    port refuses it, and the default cache lookup passes over it."""
    ref_path = tmp_path / "pipeweave_220_250.pkl"
    ref_pw.save(str(ref_path))
    with pytest.raises(RuntimeError, match=str(ref_path)):
        PipeWeave.load(str(ref_path))
    monkeypatch.setenv("REPRO_BENCH_CACHE", str(tmp_path))
    with pytest.raises(RuntimeError, match="estimator"):
        get_predictor("synperf", get_hw("tpu-v5e"))
    # a foreign file under the port's name is passed over too
    (tmp_path / "pipeweave_torch_bad.pkl").write_bytes(ref_path.read_bytes())
    with pytest.raises(RuntimeError, match="estimator"):
        get_predictor("synperf", get_hw("tpu-v5e"))
    _cross(ref_pw).save(str(tmp_path / "pipeweave_torch_good.pkl"))
    pred = get_predictor("synperf", get_hw("tpu-v5e"))
    assert pred.families() == {"gemm", "rmsnorm"}


# ----------------------------------------------------------------------
# training, held by its outcome (tests/test_core.py, bench_kernel_mape)
# ----------------------------------------------------------------------


def test_fit_mlp_learns_gemm():
    ds = build_dataset("gemm", n_workloads=110, seed=5)
    pw = train_pipeweave({"gemm": ds}, max_epochs=250, device=CPU)
    pred = pw.predict_dataset(ds)
    seen = np.array([h in SEEN for h in ds.hw_names])
    m = mape(pred[seen], ds.actual_s[seen])
    roofline = mape(ds.theoretical_s[seen], ds.actual_s[seen])
    assert m < roofline, (m, roofline)
    assert m < 20.0, m
    mlp = pw.models["gemm"]
    assert 0 < mlp.epochs <= 250 and mlp.steps == mlp.epochs  # one batch of 512 an epoch
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float32
               for a in jax.tree.leaves(mlp.params))


def test_quantile_ceiling_above_median_eff():
    ds = build_dataset("fused_moe", n_workloads=50, seed=6)
    ceiling = quantile.train_ceiling(ds, max_epochs=200, device=CPU)
    report = quantile.perf_gap(ceiling, ds)
    frac_above = float((report.gaps > -0.05).mean())
    assert frac_above > 0.6, frac_above


def test_kernel_mape_smoke_criteria():
    """``benchmarks/bench_kernel_mape.py --smoke``'s criteria at the size
    ``benchmarks/common.py`` trains by default (220 workloads, 250 epochs)
    on gemm, attention and fused_moe: average MAPE at most 25% seen and 45%
    unseen, and at least 1.2x below the best baseline on both splits. At
    the benchmark's CI size (60 workloads, 60 epochs: one step an epoch)
    the outcome hangs on the init draw in both packages, and early stopping
    can keep a barely trained model; at this size it does not."""
    kinds, names = ("gemm", "attention", "fused_moe"), ("roofline", "linear", "habitat", "neusight")
    table = {}
    for kind in kinds:
        ds = build_dataset(kind, n_workloads=220, seed=zlib.crc32(kind.encode()))
        seen = np.array([h in SEEN for h in ds.hw_names])
        preds = {"pipeweave": train_pipeweave({kind: ds}, max_epochs=250, device=CPU).predict_dataset(ds)}
        for b in names:
            preds[b] = baselines.BASELINES[b]().fit(ds, device=CPU).predict(ds)
        for name, p in preds.items():
            table[(kind, name, "seen")] = mape(p[seen], ds.actual_s[seen])
            table[(kind, name, "unseen")] = mape(p[~seen], ds.actual_s[~seen])
    for split, cap in (("seen", 25.0), ("unseen", 45.0)):
        avg = {n: float(np.mean([table[(k, n, split)] for k in kinds])) for n in ("pipeweave", *names)}
        reduction = min(avg[b] for b in names) / max(avg["pipeweave"], 1e-9)
        assert avg["pipeweave"] <= cap, (split, avg)
        assert reduction >= 1.2, (split, reduction, avg)
