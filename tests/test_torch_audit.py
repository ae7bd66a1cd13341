"""The port's static auditor (``repro_torch.analysis``) held equal to the
reference's (``repro.analysis``), as ``tests/test_analysis.py`` drives it:
the registry audit report string for string, the CLI, and the seeded faults
of each check family (SP101-SP104, SP301-SP304, SP401, SP402) giving the
same diagnostics in both packages; then the ``audit=`` pre-flight on the
continuous-batching engine and in fleet placement."""
import copy
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

import repro.analysis as ref
import repro.analysis.__main__ as ref_main
import repro.analysis.conservation as ref_cons
import repro.analysis.sharding as ref_sharding
import repro_torch.analysis as port
import repro_torch.analysis.__main__ as port_main
import repro_torch.analysis.conservation as port_cons
import repro_torch.analysis.sharding as port_sharding
from repro.configs import get_arch as ref_get_arch
from repro.core.e2e import layer_calls as ref_layer_calls
from repro.core.e2e import model_calls as ref_model_calls
from repro.core.estimator import PipeWeave as RefPipeWeave
from repro.core.hardware import get_hw as ref_get_hw
from repro.launch.dryrun import count_ep_alltoall_bytes as ref_count_ep
from repro.models.registry import build_model as ref_build_model
from repro.predict.api import CommCall as RefCommCall
from repro.predict.api import KernelCall as RefKernelCall
from repro.predict.backends import get_predictor as ref_get_predictor
from repro.predict.comm import CommRegressor as RefCommRegressor
from repro_torch.configs import get_arch, list_archs
from repro_torch.core.e2e import layer_calls, model_calls
from repro_torch.core.estimator import PipeWeave
from repro_torch.core.hardware import get_hw
from repro_torch.dist.sharding import LeafShape
from repro_torch.dist.sharding import PartitionSpec as P
from repro_torch.models import transformer as T
from repro_torch.predict.api import CommCall, KernelCall
from repro_torch.predict.backends import get_predictor
from repro_torch.predict.comm import CommRegressor
from repro_torch.serve import engine as port_engine
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.placement import FleetRouter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE, DENSE = "dbrx-132b", "qwen3-0.6b"


def _same(port_diags, ref_diags):
    """Both lists rendered as the auditors' JSON reports, string for string."""
    mine, theirs = port.json_report(port_diags), ref.json_report(ref_diags)
    assert mine == theirs
    return json.loads(mine)


# ----------------------------------------------------------------------
# the registry audit and the CLI
# ----------------------------------------------------------------------


def test_exports_equal_the_references():
    assert port.__all__ == ref.__all__
    assert port.CHECK_FAMILIES == ref.CHECK_FAMILIES
    assert port.E2E_FAMILIES == ref.E2E_FAMILIES
    assert port.PRODUCTION_MESH_SIZES == ref.PRODUCTION_MESH_SIZES
    assert port.AuditShape() == port.AuditShape(**vars(ref.AuditShape()))


@pytest.mark.parametrize("shape,mesh,codes", [
    # the default audit: clean, the SP105 info skip for each arch
    ((2, 512, 64, 16, 2), None, {"SP105"}),
    # a ragged mesh and odd lengths: large leaves left replicated (SP304)
    # and kernel tilings the blocks do not divide (SP202)
    ((3, 500, 7, 4, 2), {"data": 3, "model": 7}, {"SP105", "SP202", "SP304"}),
    ((1, 256, 32, 8, 4), {"pod": 2, "data": 4, "model": 8, "pipe": 2}, {"SP105"}),
])
def test_registry_audit_equals_the_references(shape, mesh, codes):
    parsed = _same(port.run_audit(shape=port.AuditShape(*shape), mesh_sizes=mesh),
                   ref.run_audit(shape=ref.AuditShape(*shape), mesh_sizes=mesh))
    assert {d["arch"] for d in parsed if d["code"] == "SP105"} == set(list_archs())
    assert {d["code"] for d in parsed} == codes


def _run_cli(module, *argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", module, *argv], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)


def test_cli_strict_json_equals_the_references():
    argv = ("--arch", DENSE, "--arch", MOE, "--strict", "--json")
    proc, ref_proc = _run_cli("repro_torch.analysis", *argv), _run_cli("repro.analysis", *argv)
    assert proc.returncode == ref_proc.returncode == 0, proc.stderr
    assert proc.stdout == ref_proc.stdout
    assert all(d["severity"] == "info" for d in json.loads(proc.stdout))
    bad = _run_cli("repro_torch.analysis", "--arch", "nope")
    assert bad.returncode == 2 and "invalid choice" in bad.stderr


@pytest.mark.parametrize("argv", [
    ["--arch", "hymba-1.5b", "--strict"],
    ["--all", "--check", "sharding", "--check", "coverage", "--json"],
    ["--arch", "gemma2-2b", "--batch", "3", "--lin", "500", "--tp", "4", "--json"],
    ["--arch", "gemma2-2b", "--batch", "3", "--lin", "500", "--tp", "4", "--strict"],
])
def test_cli_main_equals_the_references(argv, capsys):
    """Exit codes (0 clean, 1 on an error, or a warning under --strict) and
    output of the CLI's ``main``, both packages in process."""
    rc = port_main.main(argv)
    out = capsys.readouterr().out
    assert (rc, out) == (ref_main.main(argv), capsys.readouterr().out)
    if "--lin" in argv:
        assert rc == 1 and "SP202" in out


# ----------------------------------------------------------------------
# seeded faults: each family fires, as the reference's
# ----------------------------------------------------------------------


def _mutate_head(calls, kernel_cls, comm_cls, **gemm):
    calls = copy.deepcopy(calls)
    for item in calls:
        if not isinstance(item, (kernel_cls, comm_cls)) and item[0] == "head":
            for c in item[2]:
                if isinstance(c, kernel_cls) and c.kind == "gemm":
                    c.X.update(gemm)
                if isinstance(c, comm_cls) and c.op == "all_gather" and not gemm:
                    c.nbytes /= 2  # a bf16-sized gather of an f32 logit shard
    return calls


@pytest.mark.parametrize("fault", ["sp103", "sp104"])
def test_seeded_head_faults(fault):
    cfg, rcfg = get_arch(DENSE), ref_get_arch(DENSE)
    B, qlen, tp = 2, 128, 4
    calls, ref_calls = model_calls(cfg, B, qlen, qlen, tp), ref_model_calls(rcfg, B, qlen, qlen, tp)
    assert port.check_head_accounting(cfg, B=B, qlen=qlen, tp=tp, calls=calls) == []
    kw = {"M": B} if fault == "sp103" else {}
    parsed = _same(
        port.check_head_accounting(cfg, B=B, qlen=qlen, tp=tp,
                                   calls=_mutate_head(calls, KernelCall, CommCall, **kw)),
        ref.check_head_accounting(rcfg, B=B, qlen=qlen, tp=tp,
                                  calls=_mutate_head(ref_calls, RefKernelCall, RefCommCall, **kw)),
    )
    assert [d["code"] for d in parsed] == [fault.upper()]


def test_seeded_decomposer_drift_fires_sp102(monkeypatch):
    """A decomposer whose GEMM tasks account for half the MXU demand, in
    each package's own conservation module."""
    cfg, rcfg = get_arch(DENSE), ref_get_arch(DENSE)
    for mod in (port_cons, ref_cons):
        real = mod.decompose

        def lossy(kind, X, hw, real=real):
            t = real(kind, X, hw)
            if kind == "gemm":
                t.mxu = t.mxu * 0.5
            return t

        monkeypatch.setattr(mod, "decompose", lossy)
    parsed = _same(port.check_task_conservation(cfg, B=2, lin=512, lout=64, tp=4),
                   ref.check_task_conservation(rcfg, B=2, lin=512, lout=64, tp=4))
    assert parsed and {d["code"] for d in parsed} == {"SP102"}
    assert {d["data"]["kind"] for d in parsed} == {"gemm"}


def test_ep_ledger_and_seeded_alltoall_drift_fire_sp101():
    for arch in ("dbrx-132b", "arctic-480b"):
        for B, qlen in ((2, 512), (2, 1), (3, 7)):
            assert (port_cons.count_ep_alltoall_bytes(get_arch(arch), B, qlen)
                    == ref_count_ep(ref_get_arch(arch), B, qlen))
    cfg, rcfg = get_arch(MOE), ref_get_arch(MOE)
    calls, ref_calls = layer_calls(cfg, 2, 64, 64, 4), ref_layer_calls(rcfg, 2, 64, 64, 4)
    assert port.check_ep_alltoall(cfg, B=2, qlen=64, tp=4, calls=calls) == []
    for cs, comm_cls in ((calls, CommCall), (ref_calls, RefCommCall)):
        for c in cs:
            if isinstance(c, comm_cls) and c.op == "all_to_all":
                c.nbytes *= 0.5
    parsed = _same(port.check_ep_alltoall(cfg, B=2, qlen=64, tp=4, calls=calls),
                   ref.check_ep_alltoall(rcfg, B=2, qlen=64, tp=4, calls=ref_calls))
    assert [d["code"] for d in parsed] == ["SP101", "SP101"]


def test_dryrun_ledgers_are_read_as_data(tmp_path):
    """SP105 where no ledger is cached; a cached ledger whose EP dispatch
    bytes drift from the decomposer fires SP101, as in the reference."""
    for name in (MOE, DENSE):
        _same(port.check_dryrun_artifacts(get_arch(name), root=str(tmp_path)),
              ref.check_dryrun_artifacts(ref_get_arch(name), root=str(tmp_path)))
    (tmp_path / f"train_{MOE}.json").write_text(
        json.dumps({"ep_alltoall": {"T": 4096, "dispatch_bytes": 1.0}}))
    parsed = _same(port.check_dryrun_artifacts(get_arch(MOE), root=str(tmp_path)),
                   ref.check_dryrun_artifacts(ref_get_arch(MOE), root=str(tmp_path)))
    assert [d["code"] for d in parsed] == ["SP101"]


def test_seeded_unaudited_leaf_fires_sp301():
    cfg, rcfg = get_arch(DENSE), ref_get_arch(DENSE)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
    shapes = jax.eval_shape(ref_build_model(rcfg).init, jax.random.PRNGKey(0))
    assert [d for d in port.check_sharding(cfg, param_shapes=params)
            if d.severity == "error"] == []
    bugged = {k: params[k] for k in params.keys()}
    bugged["mystery_adapter"] = torch.empty((4096, 4096), device="meta")
    ref_bugged = dict(shapes)
    ref_bugged["mystery_adapter"] = jax.ShapeDtypeStruct((4096, 4096), "float32")
    parsed = _same(port.check_sharding(cfg, param_shapes=bugged),
                   ref.check_sharding(rcfg, param_shapes=ref_bugged))
    assert any(d["code"] == "SP301" and d["data"]["leaf"] == "mystery_adapter" for d in parsed)


def test_seeded_spec_faults_fire_sp302_sp303_sp304():
    """Hand-made specs the rules never resolve to: an axis used twice, a
    ragged dim, a large replicated leaf."""
    sizes = {"data": 16, "model": 16}
    shapes = {"wq": (30, 64), "w": (8192, 4096), "router": (64, 16)}
    specs = {"wq": ("model", "model"), "w": (None, None), "router": (("data", "model"), None)}
    kw = dict(cfg_name="toy", kind="param", audited=frozenset({"wq", "w"}),
              replicated_warn_mb=64.0)
    parsed = _same(
        port_sharding._validate_tree({k: LeafShape(v, "float32") for k, v in shapes.items()},
                                     {k: P(*v) for k, v in specs.items()}, sizes, **kw),
        ref_sharding._validate_tree(
            {k: jax.ShapeDtypeStruct(v, "float32") for k, v in shapes.items()},
            {k: jax.sharding.PartitionSpec(*v) for k, v in specs.items()}, sizes, **kw),
    )
    assert {d["code"] for d in parsed} == {"SP301", "SP302", "SP303", "SP304"}


def test_meta_trees_only():
    """The auditor builds its trees on the meta device: a leaf that holds
    storage is refused."""
    with pytest.raises(RuntimeError, match="not a meta tensor"):
        port_sharding._meta_view({"w": torch.zeros(3)}, "param")


def test_coverage_static_clean_and_seeded_sp401_sp402():
    for arch in (MOE, DENSE):
        assert port.check_coverage(get_arch(arch)) == []
    parsed = _same(
        port.check_coverage(get_arch(MOE), calls=[KernelCall("conv3d", {"M": 1}),
                                                  CommCall("all_to_one", 1e6, 8)]),
        ref.check_coverage(ref_get_arch(MOE), calls=[RefKernelCall("conv3d", {"M": 1}),
                                                     RefCommCall("all_to_one", 1e6, 8)]),
    )
    assert {d["code"] for d in parsed} == {"SP401", "SP402"}


# ----------------------------------------------------------------------
# instance audits and the pre-flight hooks
# ----------------------------------------------------------------------


def _stale(cls, hw):
    """A regressor fitted before 'all_to_all' joined CommRegressor.OPS."""
    c = cls().fit(hw)
    for k in [k for k in c.theta if k[0] == "all_to_all"]:
        del c.theta[k]
    return c


def test_instance_audits_equal_the_references():
    hw, rhw = get_hw("tpu-v5e"), ref_get_hw("tpu-v5e")
    assert port.audit_comm_regressor(None) == []
    assert port.audit_predictor(get_predictor("roofline", hw)) == []
    parsed = _same(port.audit_comm_regressor(_stale(CommRegressor, hw), hw_name=hw.name),
                   ref.audit_comm_regressor(_stale(RefCommRegressor, rhw), hw_name=rhw.name))
    assert parsed[0]["data"]["missing_ops"] == ["all_to_all"]
    for fallback in ("error", "oracle"):
        parsed = _same(
            port.audit_predictor(get_predictor("synperf", hw, estimator=PipeWeave(models={}),
                                               fallback=fallback)),
            ref.audit_predictor(ref_get_predictor("synperf", rhw,
                                                  estimator=RefPipeWeave(models={}),
                                                  fallback=fallback)),
        )
        assert [d["severity"] for d in parsed] == [
            "error" if fallback == "error" else "warning"]


def test_engine_audit_raises_before_building_anything(monkeypatch):
    """``audit=True`` on predicted admission: a stale regressor raises
    ``AuditError`` before the model runner (parameters, caches) exists; a
    fitted one passes; a callable hook gets ``(predictor, hw_name)``."""
    cfg, hw = get_arch(DENSE).smoke(), get_hw("tpu-v5e")
    bad = get_predictor("roofline", hw, comm=_stale(CommRegressor, hw))
    built = []
    real_runner = port_engine._ModelRunner

    def runner(*a, **kw):
        built.append(1)
        return real_runner(*a, **kw)

    monkeypatch.setattr(port_engine, "_ModelRunner", runner)
    with pytest.raises(port.AuditError) as ei:
        ContinuousBatchingEngine(cfg, admission="predicted", predictor=bad, decode_slo_s=0.5,
                                 audit=True, device="cpu")
    assert [d.code for d in ei.value.diagnostics] == ["SP401"] and not built
    seen = []

    def hook(predictor, hw_name):
        seen.append((predictor, hw_name))
        return []

    eng = ContinuousBatchingEngine(cfg, admission="predicted", predictor=bad, decode_slo_s=0.5,
                                   audit=hook, device="cpu")
    assert seen == [(bad, "tpu-v5e")] and built
    eng = ContinuousBatchingEngine(cfg, admission="predicted", decode_slo_s=0.5, audit=True,
                                   predictor=get_predictor("roofline", hw), device="cpu")
    assert eng.admission == "predicted" and (eng.tp, eng.pp) == (1, 1)


def test_fleet_router_audit_catches_stale_regressor_at_init():
    stale = _stale(CommRegressor, get_hw("tpu-v5e"))
    FleetRouter(["tpu-v5e"], "roofline", comm=stale)  # no audit: constructs
    with pytest.raises(port.AuditError) as ei:
        FleetRouter(["tpu-v5e"], "roofline", audit=True, comm=stale)
    assert [d.code for d in ei.value.diagnostics] == ["SP401"]
    assert "all_to_all" in str(ei.value)
    FleetRouter(["tpu-v5e", "tpu-v4"], "roofline", audit=True)
    seen = []
    FleetRouter(["tpu-v5e", "tpu-v4"], "roofline",
                audit=lambda p, name: seen.append(name) or [])
    assert seen == ["tpu-v5e", "tpu-v4"]
