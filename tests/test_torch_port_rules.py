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
                "serve/engine.py", "launch/serve.py"):
        assert mod in names
    assert (ROOT / "chip_smoke.py").is_file()


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
