"""Rules of the PyTorch port: it imports neither JAX nor the reference
package, its entry points run on CUDA unless asked for the CPU, and its
configs are held equal to the reference's."""
import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from repro.configs import base as ref_base
from repro.configs import get_arch as ref_get_arch
from repro.configs import list_archs as ref_list_archs
from repro_torch.configs import base
from repro_torch.configs import get_arch, list_archs
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine
from repro_torch.core.baselines import HabitatBaseline
from repro_torch.core.dataset import build_dataset
from repro_torch.core.estimator import train_pipeweave
from repro_torch.core.hardware import REGISTRY
from repro_torch.core.nn import fit_mlp
from repro_torch.core.quantile import train_ceiling
from repro_torch.tune import make_inputs, measure, tune
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train as launch_train
from repro_torch.train.step import TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = {
        n for n in _imported(path)
        if n.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes") and n.split(".")[0] != "repro_torch"
    }
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_port_files_exist():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix() for p in PORT_FILES[:-1]}
    for mod in ("configs/base.py", "configs/all.py", "kernels/_build.py",
                "kernels/rmsnorm/ops.py", "kernels/silu_mul/ops.py",
                "kernels/flash_attention/ops.py", "models/layers.py",
                "models/transformer.py", "models/registry.py", "convert.py",
                "serve/engine.py", "launch/serve.py",
                "kernels/fused_moe/ops.py", "kernels/fused_moe/kernel.py",
                "kernels/fused_moe/ref.py", "kernels/scaled_mm/ops.py",
                "kernels/scaled_mm/kernel.py", "kernels/scaled_mm/ref.py",
                "core/hardware.py", "core/decomposer.py", "core/scheduler.py",
                "core/features.py", "core/hwsim.py", "core/dataset.py", "core/tuner.py",
                "predict/api.py", "predict/batching.py", "predict/comm.py",
                "predict/backends.py", "analysis/diagnostics.py", "analysis/kernels.py",
                "tune/space.py", "tune/tuner.py", "tune/__main__.py",
                "predict/sweep.py", "dist/pipeline.py", "core/e2e.py", "serve/trace.py",
                "serve/monitor.py", "models/moe.py", "optim/adamw.py", "core/nn.py",
                "core/estimator.py", "core/quantile.py", "core/baselines.py",
                "predict/objective.py", "serve/placement.py", "serve/fleet.py",
                "models/ssm.py", "dist/collectives.py", "data/pipeline.py",
                "checkpoint/manager.py", "train/step.py", "train/trainer.py",
                "launch/train.py", "dist/sharding.py", "analysis/conservation.py",
                "analysis/coverage.py", "analysis/sharding.py", "analysis/audit.py",
                "analysis/__main__.py"):
        assert mod in names
    assert (ROOT / "chip_smoke.py").is_file()
    for cu in ("kernels/fused_moe/csrc/fused_moe.cu", "kernels/scaled_mm/csrc/scaled_mm.cu",
               "kernels/scaled_mm/csrc/scaled_mm_wgmma.cu",
               "kernels/flash_attention/csrc/flash_attention_bwd.cu",
               "kernels/flash_attention/csrc/flash_attention_bwd_wgmma.cu",
               "kernels/flash_attention/csrc/flash_attention_wgmma.cu",
               "kernels/fused_moe/csrc/fused_moe_bwd.cu",
               "kernels/fused_moe/csrc/fused_moe_bwd_wgmma.cu",
               "kernels/fused_moe/csrc/fused_moe_bwd_tf32.cu",
               "kernels/fused_moe/csrc/fused_moe_wgmma.cu",
               "kernels/fused_moe/csrc/fused_moe_tf32.cu", "kernels/_hopper/hopper.cuh"):
        assert (ROOT / "src" / "repro_torch" / cu).is_file()


LIBRARY_PRODUCTS = ("torch.matmul", "bmm", "einsum", "_int_mm", "cublas")


@pytest.mark.parametrize("kernel", ["fused_moe", "scaled_mm", "flash_attention", "rmsnorm",
                                    "silu_mul"])
def test_kernels_compute_their_own_products(kernel):
    """The kernel and its binding call no library product: the plain
    version (``ref.py``) may, the kernel may not. That covers the backward
    kernels of flash attention, rmsnorm, silu_mul and fused_moe."""
    pkg = ROOT / "src" / "repro_torch" / "kernels" / kernel
    for path in [pkg / "kernel.py", *sorted(pkg.glob("_triton.py")),
                 *sorted((pkg / "csrc").glob("*.cu"))]:
        text = path.read_text().lower()
        found = [name for name in LIBRARY_PRODUCTS if name.lower() in text]
        assert not found, f"{path.name} names {found}"


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("qwen3-0.6b").smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    assert ServeEngine(cfg, device="cpu").device.type == "cpu"
    # the predictor's trainers
    ds = build_dataset("gemm", n_workloads=4, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_mlp(ds.X, ds.y_eff, max_epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_pipeweave({"gemm": ds}, max_epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_ceiling(ds, max_epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HabitatBaseline().fit(ds)
    assert fit_mlp(ds.X, ds.y_eff, max_epochs=1, device="cpu").epochs == 1


def test_training_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    """``Trainer`` and ``launch.train`` default to the card and raise on a
    machine without it; neither falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("qwen3-0.6b").smoke()
    data = DataConfig(batch=2, seq_len=8)
    tcfg = TrainerConfig(total_steps=1, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, data, TrainConfig(), tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)])
    assert launch_train.parse_args(["--arch", "qwen3-0.6b"]).device == "cuda"
    assert Trainer(cfg, data, TrainConfig(), tcfg, device="cpu").device.type == "cpu"
    with pytest.raises(TypeError, match="DeviceMesh"):  # a mesh must be able to place
        Trainer(cfg, data, TrainConfig(), tcfg, mesh=object(), device="cpu")


def test_tuner_measures_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {"E": 2, "C": 32, "D": 16, "F": 32}
    blocks = {"block_m": 32, "block_f": 32}
    hw = REGISTRY["tpu-v4"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune("fused_moe", hw, workload=kw, top_k=1, repeats=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure("fused_moe", kw, blocks, repeats=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_inputs("fused_moe", kw)
    assert measure("fused_moe", kw, blocks, repeats=1, device="cpu") > 0
    assert tune("fused_moe", hw, workload=kw, top_k=1, repeats=1, device="cpu").interpret


@pytest.mark.parametrize("name", ref_list_archs())
def test_configs_equal_reference(name):
    assert list_archs() == ref_list_archs()
    ref, port = ref_get_arch(name), get_arch(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.smoke()) == dataclasses.asdict(ref.smoke())
    for attr in ("resolved_head_dim", "padded_vocab", "d_inner", "moe_hidden"):
        assert getattr(port, attr) == getattr(ref, attr)
    assert port.n_params() == ref.n_params() and port.active_params() == ref.active_params()
    assert [port.supports_shape(s) for s in base.SHAPES.values()] == [
        ref.supports_shape(s) for s in ref_base.SHAPES.values()
    ]


def test_shapes_and_cells_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()
    }
    assert base.all_cells() == ref_base.all_cells()
    assert [f.name for f in dataclasses.fields(base.ArchConfig)] == [
        f.name for f in dataclasses.fields(ref_base.ArchConfig)
    ]
