"""The port's autotuner (``repro_torch.tune``) against the reference's
(``repro.tune``): the cases of ``tests/test_tune.py`` that need no
``core.e2e``, with the same stubbed measurement, and the search space,
prefilter, ranking and choice held equal to the reference's for all five
kernels. The timing itself runs on the card (``chip_smoke.py``); here the
plain versions are timed where a test asks for ``device="cpu"``."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import tune as ref_tune
from repro.core.hardware import REGISTRY as REF_REGISTRY
from repro.predict.backends import get_predictor as ref_get_predictor
from repro_torch.core import hwsim
from repro_torch.core.hardware import REGISTRY
from repro_torch.configs import list_archs
from repro_torch.predict.backends import get_predictor
from repro_torch.tune import (
    BLOCK_VALUES,
    DEFAULT_WORKLOADS,
    TUNABLE_KERNELS,
    TunedConfigs,
    UnknownKnobError,
    arch_workload,
    block_params,
    decomposer_workload,
    enumerate_candidates,
    make_inputs,
    predict_kind,
    prefilter,
    tune,
    tune_workload,
    validate_space,
)

ROOT = Path(__file__).resolve().parent.parent
HW = REGISTRY["tpu-v4"]
REF_HW = REF_REGISTRY["tpu-v4"]

#: small deterministic space keeping stub-measured tune() runs fast
SMALL_SPACE = {"fused_moe": {"block_m": (64, 128, 256), "block_f": (128, 256)}}


def stub_measure(kernel, kw, blocks, *, args=None, repeats=1, device=None):
    """Deterministic fake wall-clock: monotone in grid steps with a
    block-dependent epsilon tiebreak (``tests/test_tune.py``'s stub)."""
    from repro_torch.tune import grid_steps

    steps = grid_steps(kernel, kw, blocks)
    return steps * 1e-4 + sum(blocks.values()) * 1e-9


def ref_stub_measure(kernel, kw, blocks, *, args=None, repeats=1, interpret=None):
    steps = ref_tune.grid_steps(kernel, kw, blocks)
    return steps * 1e-4 + sum(blocks.values()) * 1e-9


# ----------------------------------------------------------------------
# search space is the signature, not a hard-coded guess
# ----------------------------------------------------------------------


def test_space_is_signature_derived():
    for kernel in TUNABLE_KERNELS:
        knobs = block_params(kernel)
        assert knobs, kernel
        assert all(k.startswith("block_") for k in knobs)
        assert all(isinstance(v, int) for v in knobs.values())
        assert "stages" not in knobs


@pytest.mark.parametrize("kernel", sorted(ref_tune.TUNABLE_KERNELS))
def test_space_equals_reference(kernel):
    assert TUNABLE_KERNELS == ref_tune.TUNABLE_KERNELS and BLOCK_VALUES == ref_tune.BLOCK_VALUES
    assert block_params(kernel) == ref_tune.block_params(kernel)
    assert DEFAULT_WORKLOADS[kernel] == ref_tune.DEFAULT_WORKLOADS[kernel]
    assert enumerate_candidates(kernel) == ref_tune.enumerate_candidates(kernel)
    assert predict_kind(kernel) == ref_tune.predict_kind(kernel)
    kw = DEFAULT_WORKLOADS[kernel]
    assert decomposer_workload(kernel, kw) == ref_tune.decomposer_workload(kernel, kw)


def test_arch_workloads_equal_reference():
    for arch in list_archs():
        for kernel in TUNABLE_KERNELS:
            try:
                ref = ref_tune.arch_workload(kernel, arch)
            except ValueError:
                with pytest.raises(ValueError):
                    arch_workload(kernel, arch)
                continue
            assert arch_workload(kernel, arch) == ref
    assert arch_workload("fused_moe", "dbrx-132b") == {"E": 16, "C": 256, "D": 6144, "F": 10752}
    assert arch_workload("scaled_mm", "dbrx-132b") == {"M": 1024, "K": 6144, "N": 10752}


def test_fused_moe_knobs_match_ops():
    assert block_params("fused_moe") == {"block_m": 128, "block_f": 256}


def test_unknown_knob_raises():
    with pytest.raises(UnknownKnobError, match="stages"):
        validate_space("fused_moe", {"stages": (1, 2), "block_m": (128,)})
    with pytest.raises(UnknownKnobError, match="block_f"):
        enumerate_candidates("fused_moe", {"stages": (1, 2)})


def test_enumerate_is_full_cross_product():
    cands = enumerate_candidates("fused_moe", SMALL_SPACE["fused_moe"])
    assert len(cands) == 6
    assert all(set(c) == {"block_m", "block_f"} for c in cands)
    assert len({tuple(sorted(c.items())) for c in cands}) == 6


# ----------------------------------------------------------------------
# the SP2xx guarantee
# ----------------------------------------------------------------------


def test_prefilter_default_registry_is_every_device():
    from repro_torch.analysis.kernels import check_blocks

    kw = DEFAULT_WORKLOADS["fused_moe"]
    survivors, rejected = prefilter("fused_moe", kw, enumerate_candidates("fused_moe"))
    assert survivors
    for c in survivors:
        for hw in REGISTRY.values():
            assert not check_blocks("fused_moe", kw, c.blocks, hws=[hw]), (c.blocks, hw.name)
    for blocks, diags in rejected:
        assert diags


@pytest.mark.parametrize("kernel", sorted(TUNABLE_KERNELS))
def test_selected_config_passes_sp2xx_everywhere(kernel):
    from repro_torch.analysis.kernels import check_blocks

    report = tune(kernel, HW, predictor=get_predictor("roofline", HW), top_k=3,
                  measure_fn=stub_measure, device="cpu")
    kw = report.workload
    assert report.n_candidates == len(report.survivors) + report.n_rejected
    for c in report.measured:
        assert not check_blocks(kernel, kw, c.blocks), c.blocks
    assert not check_blocks(kernel, kw, report.best.blocks)
    assert report.best.measured_s is not None
    assert report.speedup >= 1.0 or math.isclose(report.speedup, 1.0)


def test_nondivisible_blocks_are_rejected_not_launched():
    kw = {"E": 2, "C": 96, "D": 128, "F": 192}
    space = {"block_m": (32, 64, 96), "block_f": (64, 192)}
    survivors, rejected = prefilter("fused_moe", kw, enumerate_candidates("fused_moe", space))
    assert rejected
    assert 64 in {blocks["block_m"] for blocks, _ in rejected}
    for c in survivors:
        assert kw["C"] % min(c.blocks["block_m"], kw["C"]) == 0
        assert kw["F"] % min(c.blocks["block_f"], kw["F"]) == 0


# ----------------------------------------------------------------------
# ranking and choice, equal to the reference's
# ----------------------------------------------------------------------


def _summary(report):
    return (
        report.n_candidates, report.n_rejected,
        [(c.blocks, c.predicted_s, c.ceiling_s, c.grid_steps) for c in report.survivors],
        [(c.blocks, c.measured_s) for c in report.measured],
        report.best.blocks, report.default_blocks, report.workload,
    )


@pytest.mark.parametrize("predictor", ["roofline", "oracle"])
@pytest.mark.parametrize("kernel", sorted(TUNABLE_KERNELS))
def test_tune_equals_reference(kernel, predictor):
    ref = ref_tune.tune(kernel, REF_HW, predictor=ref_get_predictor(predictor, REF_HW),
                        predictor_name=predictor, top_k=4, measure_fn=ref_stub_measure)
    port = tune(kernel, HW, predictor=get_predictor(predictor, HW), predictor_name=predictor,
                top_k=4, measure_fn=stub_measure, device="cpu")
    assert _summary(port) == _summary(ref)
    s, r = port.summary(), ref.summary()
    assert sorted(s) == sorted(r)
    assert s["interpret"] is True
    assert {k: v for k, v in s.items() if k != "interpret"} == {
        k: v for k, v in r.items() if k != "interpret"}


def test_tune_at_dbrx_width_ranks_as_the_reference():
    for kernel in ("fused_moe", "scaled_mm"):
        kw = arch_workload(kernel, "dbrx-132b")
        ref = ref_tune.tune(kernel, REF_HW, workload=kw, predictor=ref_get_predictor("roofline", REF_HW),
                            measure_fn=ref_stub_measure)
        port = tune(kernel, HW, workload=kw, predictor=get_predictor("roofline", HW),
                    measure_fn=stub_measure, device="cpu")
        assert _summary(port) == _summary(ref)


def test_ranking_is_deterministic():
    pred = get_predictor("roofline", HW)
    runs = [tune("fused_moe", HW, predictor=pred, top_k=4, measure_fn=stub_measure, device="cpu")
            for _ in range(2)]
    order0 = [tuple(sorted(c.blocks.items())) for c in runs[0].survivors]
    order1 = [tuple(sorted(c.blocks.items())) for c in runs[1].survivors]
    assert order0 == order1
    assert runs[0].best.blocks == runs[1].best.blocks
    pred_times = [c.predicted_s for c in runs[0].survivors]
    assert pred_times == sorted(pred_times)


def test_blocks_change_the_prediction():
    X = decomposer_workload("fused_moe", DEFAULT_WORKLOADS["fused_moe"])
    times = {
        bf: hwsim.simulate("fused_moe", X, HW, config={"block_m": 128, "block_f": bf})
        for bf in (64, 512)
    }
    assert times[64] != times[512]


def test_hwsim_rejects_unknown_config_key():
    X = decomposer_workload("fused_moe", DEFAULT_WORKLOADS["fused_moe"])
    with pytest.raises(ValueError, match="unknown config"):
        hwsim.simulate("fused_moe", X, HW, config={"block_q": 128})


def test_tune_workload_oracle_never_slows_down():
    X = {"M": 512, "E": 8, "topk": 2, "H": 512, "N": 512, "skew": 0.2, "seed": 3}
    r = tune_workload(X, HW, top_k=8)
    assert r.speedup >= 1.0
    if r.best_config:
        from repro_torch.analysis.kernels import check_blocks
        from repro_torch.tune.tuner import _moe_helper_kwargs

        kw = _moe_helper_kwargs(X, r.best_config)
        assert not check_blocks("fused_moe", kw, r.best_config, hws=[HW])
    ref = ref_tune.tune_workload(X, REF_HW, top_k=8)
    assert (r.t_default, r.t_best, r.best_config, r.predicted_s, r.measured_s) == (
        ref.t_default, ref.t_best, ref.best_config, ref.predicted_s, ref.measured_s)


# ----------------------------------------------------------------------
# inputs and real measurement of the plain versions
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kernel", sorted(TUNABLE_KERNELS))
def test_make_inputs_equal_reference(kernel):
    kw = {
        "fused_moe": {"E": 2, "C": 8, "D": 16, "F": 32},
        "scaled_mm": {"M": 16, "K": 32, "N": 8},
        "flash_attention": {"B": 1, "S": 16, "Skv": 16, "Hq": 2, "Hkv": 1, "D": 8},
        "silu_mul": {"R": 8, "d": 16},
        "rmsnorm": {"R": 8, "d": 16},
    }[kernel]
    ref = ref_tune.make_inputs(kernel, kw, seed=3)
    port = make_inputs(kernel, kw, seed=3, device="cpu")
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a.device.type == "cpu"
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)


def test_tune_times_the_plain_versions_on_the_cpu():
    kw = {"E": 2, "C": 64, "D": 32, "F": 64}
    report = tune("fused_moe", HW, workload=kw, predictor=get_predictor("roofline", HW),
                  top_k=2, repeats=1, device="cpu")
    assert report.interpret is True
    assert all(c.measured_s is not None and c.measured_s > 0 for c in report.measured)
    assert report.t_default > 0 and report.best in report.measured


# ----------------------------------------------------------------------
# TunedConfigs and the CLI
# ----------------------------------------------------------------------


def test_tuned_configs_roundtrip(tmp_path):
    tc = TunedConfigs()
    report = tune("fused_moe", HW, predictor=get_predictor("roofline", HW), top_k=2,
                  measure_fn=stub_measure, device="cpu")
    tc.add_report(report)
    tc.set("tpu-v5p", "attention", {"block_q": 256, "block_k": 512})
    p = tmp_path / "tuned.json"
    tc.save(str(p))
    back = TunedConfigs.load(str(p))
    assert back.configs == tc.configs
    assert back.for_hw(HW) == {predict_kind("fused_moe"): report.best.blocks}
    assert back.for_hw("tpu-v5p") == {"attention": {"block_q": 256, "block_k": 512}}
    assert back.for_hw("tpu-v6e") == {}


def test_tuned_configs_files_cross_load(tmp_path):
    configs = {"tpu-v4": {"fused_moe": {"block_m": 64, "block_f": 512}},
               "tpu-v6e": {"scaled_mm": {"block_m": 128, "block_n": 256, "block_k": 512}}}
    ref_path, port_path = tmp_path / "ref.json", tmp_path / "port.json"
    ref_tune.TunedConfigs(configs=configs).save(str(ref_path))
    TunedConfigs(configs=configs).save(str(port_path))
    assert ref_path.read_text() == port_path.read_text()
    assert TunedConfigs.load(str(ref_path)).configs == configs
    assert ref_tune.TunedConfigs.load(str(port_path)).configs == configs


def test_core_tuner_shim_reexports():
    from repro_torch.core import tuner as shim

    assert shim.tune_workload is tune_workload
    for name in ("TuneResult", "geomean_speedup", "pearson", "spearman",
                 "tune_underperformers", "tune_one"):
        assert hasattr(shim, name), name


def test_block_values_lattice_sane():
    assert BLOCK_VALUES == tuple(sorted(BLOCK_VALUES))
    assert all(v % 32 == 0 for v in BLOCK_VALUES)


def test_cli_runs_on_the_cpu(tmp_path):
    out = tmp_path / "report.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", "--kernel", "fused_moe", "--device", "cpu",
         "--dim", "E=2", "--dim", "C=64", "--dim", "D=32", "--dim", "F=64",
         "--top-k", "2", "--repeats", "1", "--json", str(out)],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "plain versions on the CPU" in proc.stdout
    s = json.loads(out.read_text())
    assert s["interpret"] is True and s["n_measured"] >= 2
    assert s["workload"] == {"E": 2, "C": 64, "D": 32, "F": 64}

