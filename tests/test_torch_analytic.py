"""The port's analytic substrate, predictors and kernel lint against the
reference, on the same inputs. These modules are numpy in both packages, so
they are held *equal*: the same bits, not within a tolerance."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.analysis import kernels as ref_akernels
from repro.configs import get_arch as ref_get_arch
from repro.core import dataset as ref_dataset
from repro.core import decomposer as ref_decomposer
from repro.core import features as ref_features
from repro.core import hardware as ref_hardware
from repro.core import hwsim as ref_hwsim
from repro.core import scheduler as ref_scheduler
from repro.predict import api as ref_api
from repro.predict import backends as ref_backends
from repro_torch.analysis import kernels as akernels
from repro_torch.configs import get_arch, list_archs
from repro_torch.core import dataset, decomposer, features, hardware, hwsim, scheduler
from repro_torch.predict import api, backends

HW_NAMES = sorted(ref_hardware.REGISTRY)


def _plain(obj):
    """A value with every dataclass, dict, tuple and array reduced to lists
    and floats, so ``==`` compares bits."""
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


def test_registry_and_hw_vectors_equal():
    assert sorted(hardware.REGISTRY) == HW_NAMES
    for name in HW_NAMES:
        ref, port = ref_hardware.REGISTRY[name], hardware.REGISTRY[name]
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert _plain(port.as_vector()) == _plain(ref.as_vector())
    assert [h.name for h in hardware.seen_hw()] == [h.name for h in ref_hardware.seen_hw()]
    assert [h.name for h in hardware.unseen_hw()] == [h.name for h in ref_hardware.unseen_hw()]
    assert decomposer.SCHED_POLICY == ref_decomposer.SCHED_POLICY
    assert decomposer.COMPUTE_DTYPE_BYTES == ref_decomposer.COMPUTE_DTYPE_BYTES
    assert hwsim.CONFIG_KEYS == ref_hwsim.CONFIG_KEYS


def _config(keys):
    values = {"block_m": 64, "block_n": 128, "block_k": 256, "block_f": 128,
              "block_q": 64, "block_rows": 32, "stages": 2}
    return {k: values[k] for k in sorted(keys)}


@pytest.mark.parametrize("hw_name", HW_NAMES)
@pytest.mark.parametrize("kind", sorted(ref_hwsim.CONFIG_KEYS))
def test_pipeline_and_hwsim_equal(kind, hw_name):
    """decompose -> schedule -> analyze -> vector, and hwsim with and
    without a block config, on a few sampled workloads of each family."""
    ref_hw, hw = ref_hardware.REGISTRY[hw_name], hardware.REGISTRY[hw_name]
    ref_rng, rng = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):
        X = ref_dataset.sample_workload(kind, ref_rng)
        assert dataset.sample_workload(kind, rng) == X
        ref_tasks, tasks = ref_decomposer.decompose(kind, X, ref_hw), decomposer.decompose(kind, X, hw)
        assert _plain(tasks) == _plain(ref_tasks)
        policy = ref_decomposer.SCHED_POLICY[kind]
        ref_chip = ref_scheduler.schedule(policy, ref_tasks, ref_hw)
        chip = scheduler.schedule(policy, tasks, hw)
        assert _plain(chip) == _plain(ref_chip)
        ref_fs, fs = ref_features.analyze(ref_tasks, ref_chip, ref_hw), features.analyze(tasks, chip, hw)
        assert _plain(fs) == _plain(ref_fs)
        assert _plain(fs.vector(hw)) == _plain(ref_fs.vector(ref_hw))
        assert _plain(dataset.featurize(kind, X, hw)) == _plain(ref_dataset.featurize(kind, X, ref_hw))
        assert hwsim.simulate(kind, X, hw) == ref_hwsim.simulate(kind, X, ref_hw)
        cfg = _config(ref_hwsim.CONFIG_KEYS[kind])
        assert hwsim.simulate(kind, X, hw, config=cfg) == ref_hwsim.simulate(kind, X, ref_hw, config=cfg)


def test_build_dataset_equal():
    ref = ref_dataset.build_dataset("fused_moe", n_workloads=20, seed=6)
    port = dataset.build_dataset("fused_moe", n_workloads=20, seed=6)
    assert _plain(port.X) == _plain(ref.X)
    assert _plain(port.y_eff) == _plain(ref.y_eff)
    assert port.workloads == ref.workloads and port.hw_names == ref.hw_names
    assert _plain(port.theoretical_s) == _plain(ref.theoretical_s)
    assert dataset.mape(port.actual_s, port.theoretical_s) == ref_dataset.mape(
        ref.actual_s, ref.theoretical_s)


def _calls(mod):
    K, C = mod.KernelCall, mod.CommCall
    return [
        K("gemm", {"M": 512, "N": 1024, "K": 256}),
        K("attention", {"bs": 2, "nkv": 4, "group": 2, "hd": 64, "qlen": 256, "kvlen": 256,
                        "causal": 1}, count=3),
        K("fused_moe", {"M": 1024, "E": 8, "topk": 2, "H": 256, "N": 512, "skew": 0.2, "seed": 1}),
        K("scaled_mm", {"M": 256, "N": 512, "K": 512, "block_m": 64}),
        K("rmsnorm", {"seq": 1024, "dim": 512}, count=2.5),
        C("all_reduce", 4e6, 4),
        C("all_to_all", 8e6, 8, skew=0.3),
        ("layer", 2, [K("silu_mul", {"seq": 2048, "dim": 1024}), C("all_gather", 1e6, 2)]),
    ]


@pytest.mark.parametrize("name", ["roofline", "oracle"])
@pytest.mark.parametrize("hw_name", ["tpu-v4", "tpu-v5e", "tpu-v6e"])
def test_estimates_equal(name, hw_name):
    ref = ref_backends.get_predictor(name, ref_hardware.REGISTRY[hw_name]).predict(_calls(ref_api))
    port = backends.get_predictor(name, hardware.REGISTRY[hw_name]).predict(_calls(api))
    assert _plain(port) == _plain(ref)


def test_predictor_registry_equal_and_synperf_not_ported():
    """The registry, and synperf built from reference estimator weights
    crossed into the port: its estimates equal the reference's (the name is
    kept from when synperf raised here)."""
    from repro.core import dataset as ref_ds
    from repro.core import estimator as ref_estimator
    from repro_torch.convert import pipeweave_from_numpy

    assert sorted(backends.PREDICTORS) == sorted(ref_backends.PREDICTORS)
    ref_pw = ref_estimator.train_pipeweave(
        {kind: ref_ds.build_dataset(kind, n_workloads=8, seed=1) for kind in ("gemm", "rmsnorm")},
        max_epochs=3)
    pw = pipeweave_from_numpy({k: dict(
        params=jax.tree.map(np.asarray, m.params), state=jax.tree.map(np.asarray, m.state),
        mu_x=m.mu_x, sd_x=m.sd_x, y_floor=m.y_floor, x_lo=m.x_lo, x_hi=m.x_hi)
        for k, m in ref_pw.models.items()})
    for hw_name in ("tpu-v4", "tpu-v6e-lite"):
        ref = ref_backends.get_predictor("synperf", ref_hardware.REGISTRY[hw_name],
                                         estimator=ref_pw, fallback="roofline")
        port = backends.get_predictor("synperf", hardware.REGISTRY[hw_name], estimator=pw,
                                      fallback="roofline")
        assert port.name == ref.name == "synperf"
        assert _plain(port.predict(_calls(api))) == _plain(ref.predict(_calls(ref_api)))


@pytest.mark.parametrize("arch", list_archs())
def test_kernel_workloads_and_resource_lint_equal(arch):
    ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
    assert list(akernels.kernel_workloads(cfg)) == list(ref_akernels.kernel_workloads(ref_cfg))
    for kw in ({}, {"B": 8, "lin": 4096}):
        assert _plain(akernels.check_kernel_resources(cfg, **kw)) == _plain(
            ref_akernels.check_kernel_resources(ref_cfg, **kw))
    big = {"fused_moe": {"block_m": 512, "block_f": 512},
           "scaled_mm": {"block_m": 512, "block_n": 512, "block_k": 512},
           "flash_attention": {"block_q": 96}}
    assert _plain(akernels.check_kernel_resources(cfg, block_overrides=big)) == _plain(
        ref_akernels.check_kernel_resources(ref_cfg, block_overrides=big))
