"""The port's dry run (``repro_torch.launch.dryrun``) and production meshes
(``launch.mesh.make_production_mesh`` on ``fake_process_group``) against
the reference: per-device dot FLOPs of smoke configs within 2% of the
reference's HLO walk, on one device and on a (2, 2) mesh (there against the
reference's own dry run of that mesh), the JSON's keys, and the auditor
reading a port-written ledger. The port runs on fake CPU tensors: no card,
no allocation."""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_process_group, make_mesh, make_production_mesh, mesh_tag

#: the port's per-device dot FLOPs against the reference's HLO walk of the
#: same smoke config and shape, lowered plainly
DOT_RTOL = 0.02
CASES = [(arch, kind) for arch in ("qwen3-0.6b", "dbrx-132b")
         for kind in ("train", "prefill", "decode")]
B, S = 4, 64


@functools.lru_cache(maxsize=None)
def _meshless(arch: str, kind: str):
    return D.lower_step(get_arch(arch).smoke(), kind, B, S)


def _reference_dot_flops(arch: str, kind: str) -> float:
    from repro.configs import get_arch as ref_arch
    from repro.models.registry import batch_specs, build_model
    from repro.roofline.hlo_cost import analyze_hlo
    from repro.train.step import TrainConfig, init_train_state, make_optimizer, make_train_step

    cfg = ref_arch(arch).smoke()
    api = build_model(cfg)
    key = jax.random.PRNGKey(0)
    if kind == "train":
        tc = TrainConfig()
        opt = make_optimizer(tc)
        state = jax.eval_shape(lambda: init_train_state(api, opt, key))
        lowered = jax.jit(make_train_step(api, opt, tc)).lower(state, batch_specs(cfg, B, S))
    else:
        params = jax.eval_shape(api.init, key)
        if kind == "prefill":
            lowered = jax.jit(api.prefill).lower(params, batch_specs(cfg, B, S))
        else:
            cache = jax.eval_shape(lambda: api.init_cache(B, S))
            tok = jax.ShapeDtypeStruct((B,), jnp.int32)
            lowered = jax.jit(api.decode).lower(params, cache, tok, tok)
    return analyze_hlo(lowered.compile().as_text()).dot_flops


def _skipped_causal_blocks(cfg, kind: str) -> float:
    """The products of the causal blocks above the diagonal, which the
    reference's plain prefill skips (``causal_sparse="prefill"``: its
    chunked attention's triangular schedule) and the port's prefill does:
    it goes to the flash-attention kernel's entry point, whose plain
    version is dense (ROADMAP queue C). Two products (QK^T and PV) a block,
    each ``2 * B * Hq * q_block^2 * D``."""
    nb = S // cfg.q_block
    if kind != "prefill" or cfg.causal_sparse != "prefill" or S % cfg.q_block or nb < 2:
        return 0.0
    per_block = 2 * 2 * B * cfg.n_heads * cfg.q_block ** 2 * cfg.resolved_head_dim
    return float(cfg.n_layers * nb * (nb - 1) // 2 * per_block)


@pytest.mark.parametrize("arch,kind", CASES)
def test_dot_flops_match_the_reference_walk(arch, kind, monkeypatch):
    """Within 2% once the port's two by-design extras are taken out: the
    skipped causal blocks (counted exactly above) and the MoE's expert rows
    padded to the kernel's ``block_m`` (the reference pads none; the count
    is taken with ``EXPERT_BLOCK_M = 1``, no padding, and the padded one is
    held to be larger)."""
    from repro_torch.models import moe as M

    cfg = get_arch(arch).smoke()
    padded = _meshless(arch, kind)
    monkeypatch.setattr(M, "EXPERT_BLOCK_M", 1)
    lw = D.lower_step(cfg, kind, B, S)
    got = lw.counter.summary()
    want = _reference_dot_flops(arch, kind) + _skipped_causal_blocks(cfg, kind)
    assert abs(got.dot_flops - want) <= DOT_RTOL * want, (got.dot_flops, want)
    assert padded.counter.summary().dot_flops >= got.dot_flops
    assert not got.unknown_ops, got.unknown_ops
    assert lw.argument_bytes > 0 and lw.output_bytes > 0 and lw.counter.peak_bytes > 0


def _unpadded_loss_rows(cfg, kind: str) -> float:
    """The lm-head products of the rows that the reference's cross entropy
    pads its ``S - 1`` positions with (to a multiple of its ``q_block``
    blocks) and that the port's skips on DTensors (``chunked_cross_entropy``
    does not pad them): four products a row, the checkpointed forward, its
    recomputation and the two of the backward, each ``2 * d * V``."""
    pad = -(S - 1) % cfg.q_block
    return float(4 * 2 * B * pad * cfg.d_model * cfg.padded_vocab) if kind == "train" else 0.0


#: the reference's own dry run (``repro.launch.dryrun``'s ``lower_cell`` and
#: ``analyze``) of each case on a (2, 2) mesh of four forced host devices.
#: Its production mesh, architectures and shapes are swapped for the (2, 2)
#: mesh, the smoke configs and ``(B, S)``; the mesh's axes are ``Auto``, as
#: the reference's ``with_sharding_constraint`` needs them (jax 0.9 makes
#: ``Explicit`` ones by default)
_REF_ON_2X2 = """
import dataclasses, json, os
import jax
import repro.launch.dryrun as RD
from repro.configs import SHAPES, get_arch

mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
RD.make_production_mesh = lambda multi_pod=False, pipeline=False: mesh
RD.get_arch = lambda arch: get_arch(arch).smoke()
out = {}
for arch, kind in CASES:
    name = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    RD.SHAPES = {name: dataclasses.replace(SHAPES[name], global_batch=B, seq_len=S)}
    d = RD.analyze(*RD.lower_cell(arch, name, False))
    out[arch + "/" + kind] = {"dot_flops": d["dot_flops"], "collectives": d["collectives"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_on_2x2():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(root, "src"), env.get("PYTHONPATH", "")])
    script = f"CASES, B, S = {CASES!r}, {B}, {S}\n" + _REF_ON_2X2
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=600, cwd=root, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,kind", CASES)
def test_lowering_on_a_fake_2x2_mesh(arch, kind, ref_on_2x2, monkeypatch):
    """Per device, within 2% of the reference's own dry run on a (2, 2)
    ``data, model`` mesh, once the port's differences by design are taken
    out: the meshless test's two (the skipped causal blocks, and no expert
    padding), each device doing a quarter of them (batch over ``data``,
    heads and experts over ``model``), and the padded loss rows that the
    port does not compute on DTensors (:func:`_unpadded_loss_rows`). The
    collective bytes by kind are not held to the reference's (ROADMAP
    queue C says why)."""
    from repro_torch.models import moe as M

    cfg = get_arch(arch).smoke()
    monkeypatch.setattr(M, "EXPERT_BLOCK_M", 1)
    with fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        lw = D.lower_step(cfg, kind, B, S, mesh=mesh)
    assert not dist.is_initialized()
    got = lw.counter.summary()
    want = (ref_on_2x2[f"{arch}/{kind}"]["dot_flops"]
            + (_skipped_causal_blocks(cfg, kind) - _unpadded_loss_rows(cfg, kind)) / 4)
    assert abs(got.dot_flops - want) <= DOT_RTOL * want, (got.dot_flops, want)
    assert not got.unknown_ops, got.unknown_ops
    assert got.collectives["all-gather"]["bytes"] > 0 and got.collectives["all-reduce"]["bytes"] > 0
    assert got.collective_bytes == sum(v["bytes"] for v in got.collectives.values())
    # each device does a share of the meshless step's products, and holds a
    # share of its inputs
    whole = _meshless(arch, kind)
    assert got.dot_flops < whole.counter.summary().dot_flops
    assert lw.argument_bytes < whole.argument_bytes


def test_production_meshes_on_a_fake_group():
    want = {(False, False): ((16, 16), ("data", "model"), "16x16"),
            (True, False): ((2, 16, 16), ("pod", "data", "model"), "2x16x16"),
            (False, True): ((4, 8, 8), ("pipe", "data", "model"), "4x8x8pp"),
            (True, True): ((2, 4, 8, 8), ("pod", "pipe", "data", "model"), "2x4x8x8pp")}
    for (multi_pod, pipeline), (shape, axes, tag) in want.items():
        with fake_process_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, pipeline=pipeline)
            assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == axes
            assert mesh.device_type == "cpu" and mesh.size() == (512 if multi_pod else 256)
        assert mesh_tag(multi_pod=multi_pod, pipeline=pipeline) == tag
        assert not dist.is_initialized()


def test_production_mesh_needs_its_fake_group():
    with pytest.raises(ValueError, match="256 ranks, have no process group"):
        make_production_mesh()
    with fake_process_group(256):
        with pytest.raises(ValueError, match="512 ranks, have 256"):
            make_production_mesh(multi_pod=True)
        with pytest.raises(RuntimeError, match="exists already"):
            with fake_process_group(4):
                pass
    with pytest.raises(KeyError):
        with fake_process_group(8):
            raise KeyError("the block fails")
    assert not dist.is_initialized()  # destroyed however the block ends


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's ``launch.dryrun``. Its module forces 512 host devices
    through ``XLA_FLAGS`` when imported: jax is started first (so this
    process keeps its devices) and the variable is put back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def _port_result(arch, kind):
    lw = _meshless(arch, kind)
    shape = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    meta = {"arch": arch, "shape": shape, "mesh": "16x16", "n_devices": 1,
            "compile_s": round(lw.seconds, 1)}
    return D.analyze(lw, meta), lw


def test_json_keys_equal_the_reference(ref_dryrun):
    compiled = jax.jit(lambda a, b: a @ b).lower(
        jax.ShapeDtypeStruct((8, 8), jnp.float32), jax.ShapeDtypeStruct((8, 8), jnp.float32)
    ).compile()
    for arch in ("qwen3-0.6b", "dbrx-132b"):
        meta = {"arch": arch, "shape": "train_4k", "mesh": "16x16", "n_devices": 1,
                "compile_s": 0.0}
        ref = ref_dryrun.analyze(None, compiled, meta)
        port, lw = _port_result(arch, "train")
        assert set(port) == set(ref)
        assert set(port["memory"]) == set(ref["memory"])
        assert set(port["collectives"]) == set(ref["collectives"])
        assert port["xla_flops_raw"] is None and port["xla_bytes_raw"] is None
        assert port["hlo_lines"] == len(lw.counter.ledger_lines())
        assert port["memory"]["argument_bytes"] == lw.argument_bytes
        if "ep_alltoall" in ref:
            assert port["ep_alltoall"] == ref["ep_alltoall"]


def test_auditor_reads_a_port_written_ledger(tmp_path):
    from repro.analysis.conservation import check_dryrun_artifacts as ref_check
    from repro.configs import get_arch as ref_arch
    from repro_torch.analysis.conservation import check_dryrun_artifacts

    result, _ = _port_result("dbrx-132b", "train")
    (tmp_path / "dbrx-132b__train_4k__16x16.json").write_text(json.dumps(result, indent=2))
    diags = check_dryrun_artifacts(get_arch("dbrx-132b"), root=str(tmp_path))
    assert all(d.code != "SP105" and d.severity != "error" for d in diags), diags
    assert [d.message for d in diags] == [
        d.message for d in ref_check(ref_arch("dbrx-132b"), root=str(tmp_path))]


def test_cli_and_report_on_a_production_cell(tmp_path, capsys):
    from repro_torch.roofline import report

    out = tmp_path / "d"
    assert D.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--out", str(out)]) == 0
    tag = "qwen3-0.6b__decode_32k__16x16"
    d = json.loads((out / f"{tag}.json").read_text())
    assert d["n_devices"] == 256 and d["mesh"] == "16x16" and not d["unknown_ops"]
    assert (out / "hlo" / f"{tag}.ops.zst").stat().st_size > 0
    capsys.readouterr()
    report.main(["--dir", str(out)])
    text = capsys.readouterr().out
    assert "Constants: 989 TFLOP/s bf16/chip, 3350 GB/s HBM, 450 GB/s/link NVLink." in text
    assert "| qwen3-0.6b | decode_32k | 16x16 |" in text
    assert ("- qwen3-0.6b/decode_32k/16x16: 16 query and 8 KV heads over a 16-way model axis: "
            "attention replicated over it") in text
    # a cached cell is skipped, as the reference's CLI skips it
    assert D.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--out", str(out)]) == 0
    assert "[skip cached]" in capsys.readouterr().out


def test_cli_lowers_cells_apart(tmp_path, capsys):
    """With more than one cell to lower, each is lowered in a process of
    its own (here both production meshes of one cell, two at once)."""
    out = tmp_path / "d"
    argv = ["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--both-meshes", "--jobs", "2",
            "--out", str(out)]
    assert D.main(argv) == 0
    text = capsys.readouterr().out
    for mesh, n in (("16x16", 256), ("2x16x16", 512)):
        tag = f"qwen3-0.6b__decode_32k__{mesh}"
        assert f"{tag}: exit 0 in " in text
        d = json.loads((out / f"{tag}.json").read_text())
        assert d["n_devices"] == n and d["mesh"] == mesh and d["dot_flops"] > 0
    assert "done; 0 failures of 2 cells in " in text
    assert not dist.is_initialized()
    assert D.main(argv) == 0
    assert capsys.readouterr().out.count("[skip cached]") == 2


def test_documented_skip():
    with pytest.raises(ValueError, match="documented skip"):
        D.lower_cell("qwen3-0.6b", "long_500k", False)


def test_collective_bytes_of_hlo_text_equal_the_reference(ref_dryrun):
    import test_hlo_corpus

    texts = [v for v in vars(test_hlo_corpus).values()
             if isinstance(v, str) and v.startswith("HloModule")]
    assert texts
    for text in texts:
        assert D.collective_bytes(text) == ref_dryrun.collective_bytes(text)
    assert D._shape_bytes("(bf16[4,8], s32[2])") == ref_dryrun._shape_bytes("(bf16[4,8], s32[2])")


def test_fake_group_leaves_torch_usable():
    with fake_process_group(4):
        pass
    assert torch.ones(2).sum().item() == 2.0
