"""The port's roofline package against the reference: ``hlo_cost`` held
equal on the HLO corpus and on HLO that jax compiles here; ``analysis``,
``report`` and ``reanalyze`` equal on dry-run JSONs in the reference's
schema with the reference's constants passed in; and the op counter
(``roofline.op_cost``) on closed forms, DTensor included."""
import contextlib
import io
import json
import runpy
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

import test_hlo_corpus
from repro.roofline import analysis as ref_analysis
from repro.roofline import hlo_cost as ref_hlo
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.roofline import analysis, hlo_cost, op_cost, report

CORPUS = {k: v for k, v in vars(test_hlo_corpus).items()
          if isinstance(v, str) and v.startswith("HloModule")}


def _jitted_hlo():
    """HLO of ``tests/test_hlo_cost.py``'s functions, compiled here."""
    f32 = jnp.float32

    def scan13(x, w):
        return lax.scan(lambda c, _: (jnp.tanh(c @ w), None), x, None, length=13)[0]

    def nested(x):
        def outer(c, _):
            return lax.scan(lambda c2, _: (c2 @ c2, None), c, None, length=3)[0], None
        return lax.scan(outer, x, None, length=5)[0]

    cases = {
        "matmul": (lambda a, b: a @ b, [(128, 256), (256, 512)]),
        "scan": (scan13, [(64, 64), (64, 64)]),
        "nested_scan": (nested, [(32, 32)]),
        "batched": (lambda a, b: jnp.einsum("bij,bjk->bik", a, b), [(4, 64, 32), (4, 32, 16)]),
        "hbm": (lambda a, b: a @ b, [(512, 512), (512, 512)]),
    }
    out = {}
    for name, (fn, shapes) in cases.items():
        specs = [jax.ShapeDtypeStruct(s, f32) for s in shapes]
        out[name] = jax.jit(fn).lower(*specs).compile().as_text()

    from repro.configs import get_arch
    from repro.models.registry import build_model

    api = build_model(get_arch("qwen3-0.6b").smoke())
    params = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((2, 32), jnp.int32)}
    loss = jax.jit(lambda p, b: api.loss(p, b)[0]).lower(params, batch)
    out["model_loss"] = loss.compile().as_text()
    return out


@pytest.fixture(scope="module")
def jitted():
    return _jitted_hlo()


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_hlo_cost_equals_the_reference_on_the_corpus(name):
    text = CORPUS[name]
    assert hlo_cost.analyze_hlo(text).as_dict() == ref_hlo.analyze_hlo(text).as_dict()
    comps, ref_comps = hlo_cost.parse_module(text), ref_hlo.parse_module(text)
    assert sorted(comps) == sorted(ref_comps)
    for key, comp in comps.items():
        ref = ref_comps[key]
        assert (comp.name, comp.params) == (ref.name, ref.params)
        assert [vars(i) for i in comp.instrs] == [vars(i) for i in ref.instrs]
        assert hlo_cost.computation_traffic(comp, comps) == ref_hlo.computation_traffic(
            ref, ref_comps)


def test_hlo_cost_equals_the_reference_on_jitted_hlo(jitted):
    for name, text in jitted.items():
        got, want = hlo_cost.analyze_hlo(text).as_dict(), ref_hlo.analyze_hlo(text).as_dict()
        assert got == want, name
    # the reference's closed forms hold through the port's copy
    assert hlo_cost.analyze_hlo(jitted["scan"]).dot_flops == pytest.approx(
        13 * 2 * 64 ** 3, rel=0.01)
    assert hlo_cost.analyze_hlo(jitted["nested_scan"]).dot_flops == pytest.approx(
        15 * 2 * 32 ** 3, rel=0.01)


def test_hlo_cost_cli_equals_the_reference(jitted, tmp_path, monkeypatch):
    path = tmp_path / "dump.hlo"
    path.write_text(jitted["model_loss"])
    outs = []
    for module in ("repro_torch.roofline.hlo_cost", "repro.roofline.hlo_cost"):
        monkeypatch.setattr(sys, "argv", [module, str(path)])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runpy.run_module(module, run_name="__main__")
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and json.loads(outs[0])["dot_flops"] > 0


# ----------------------------------------------------------------------
# the op counter: closed forms
# ----------------------------------------------------------------------


def _count(fn, *args):
    return op_cost.count(fn, *args)[1]


def test_counter_single_matmul():
    with FakeTensorMode():
        a, b = torch.empty(128, 256), torch.empty(256, 512)
        c = _count(lambda: a @ b)
    s = c.summary()
    assert s.dot_flops == 2 * 128 * 256 * 512
    assert s.hbm_bytes == 4 * (128 * 256 + 256 * 512 + 128 * 512)
    assert s.vector_ops == 0 and s.collective_bytes == 0 and not s.unknown_ops


@pytest.mark.parametrize("L", [1, 13])
def test_counter_loop_of_matmuls_with_tanh(L):
    with FakeTensorMode():
        x, w = torch.empty(64, 64), torch.empty(64, 64)

        def f(x):
            for _ in range(L):
                x = torch.tanh(x @ w)
            return x

        s = _count(f, x).summary()
    assert s.dot_flops == L * 2 * 64 ** 3
    assert s.transcendentals == L * 64 * 64 and s.vector_ops == L * 64 * 64


def test_counter_nested_loops_and_batched_einsum():
    with FakeTensorMode():
        x = torch.empty(32, 32)

        def nested(x):
            for _ in range(5):
                for _ in range(3):
                    x = x @ x
            return x

        assert _count(nested, x).summary().dot_flops == 15 * 2 * 32 ** 3
        a, b = torch.empty(4, 64, 32), torch.empty(4, 32, 16)
        s = _count(lambda: torch.einsum("bij,bjk->bik", a, b)).summary()
    assert s.dot_flops == 2 * 4 * 64 * 32 * 16


def test_counter_counts_backward_and_reductions():
    with FakeTensorMode():
        x = torch.empty(16, 32, requires_grad=True)
        w = torch.empty(32, 8, requires_grad=True)
        c = _count(lambda: torch.autograd.grad((x @ w).sum(), (x, w)))
    s = c.summary()
    # forward, and both products of the backward
    assert s.dot_flops == 3 * 2 * 16 * 32 * 8
    assert s.vector_ops >= 16 * 8  # the sum reads every output element
    assert not s.unknown_ops


def test_counter_under_dtensor_counts_local_ops_only():
    with fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            a = distribute_tensor(torch.empty(64, 32), mesh, [Shard(0), Replicate()],
                                  src_data_rank=None)
            w = distribute_tensor(torch.empty(32, 48), mesh, [Replicate(), Shard(1)],
                                  src_data_rank=None)
            c = _count(lambda: torch.tanh(a @ w).redistribute(mesh, [Replicate(), Replicate()]))
    s = c.summary()
    # each rank: (32, 32) @ (32, 24), never the global (64, 32) @ (32, 48)
    assert s.dot_flops == 2 * 32 * 32 * 24
    assert s.transcendentals == 32 * 24
    # the redistribution gathers the local (32, 24) over model, then over data
    assert s.collectives["all-gather"]["count"] == 2
    assert s.collectives["all-gather"]["bytes"] == 4 * (32 * 24 + 32 * 48)


def test_ledger_round_trip(tmp_path):
    from repro_torch.launch.dryrun import read_ledger, write_ledger

    with FakeTensorMode():
        x, w = torch.empty(64, 64), torch.empty(64, 64)
        c = _count(lambda: torch.softmax(torch.tanh(x @ w), -1).sum())
    lines = c.ledger_lines()
    assert all(json.loads(line)["n"] >= 1 for line in lines)
    path = write_ledger(str(tmp_path / "c.ops.zst"), lines)
    assert op_cost.analyze_ledger(read_ledger(path)).as_dict() == c.summary().as_dict()


def test_causal_share_of_a_plain_attention():
    """``analyze_ledger(causal=(S, heads))`` counts the ops on the (H, S, S)
    scores at (S + 1) / (2 S) of their cost, and whole the projections of
    a (1, S, d) activation whose d equals S."""
    H, S, D = 2, 32, 16
    with FakeTensorMode():
        x, w = torch.empty(1, S, S), torch.empty(S, H * D)
        c = _count(lambda: _plain_attention(x, w, H, D))
    share = (S + 1) / (2 * S)
    whole = c.summary()
    proj, scores = 3 * 2 * S * S * H * D, 2 * (2 * H * S * S * D)
    assert whole.dot_flops == proj + scores
    got = op_cost.analyze_ledger(c.ledger_lines(), causal=(S, H))
    assert got.dot_flops == proj + share * scores
    assert got.transcendentals == share * whole.transcendentals == share * H * S * S
    for causal in ((S + 1, H), (S, 3 * H), None):
        assert op_cost.analyze_ledger(c.ledger_lines(), causal=causal).as_dict() == whole.as_dict()


def _plain_attention(x, w, H, D):
    q, k, v = ((x @ w).unflatten(-1, (H, D)).transpose(1, 2) for _ in range(3))
    return torch.softmax(q @ k.transpose(-1, -2), -1) @ v


def test_ledger_falls_back_to_gzip_without_zstandard(tmp_path, monkeypatch):
    from repro_torch.launch.dryrun import read_ledger, write_ledger

    monkeypatch.setitem(sys.modules, "zstandard", None)  # import raises ImportError
    path = write_ledger(str(tmp_path / "c.ops.zst"), ['{"n": 1}'])
    assert path.endswith(".ops.gz") and read_ledger(path) == ['{"n": 1}']


# ----------------------------------------------------------------------
# analysis, report, reanalyze against the reference
# ----------------------------------------------------------------------

REF_PEAKS = analysis.Peaks(ref_analysis.PEAK_FLOPS, ref_analysis.HBM_BW, ref_analysis.ICI_BW,
                           link="ICI")
# the advice's branches in the port's words (this card) and the reference's
ADVICE = {
    "memory": ("memory-bound: cut device-memory traffic", "memory-bound: cut HBM traffic"),
    "collective": ("collective-bound:", "collective-bound:"),
    "low useful": ("compute-bound but low useful ratio", "compute-bound but low useful ratio"),
    "compute": ("compute-bound: near the tensor-core roof", "compute-bound: near the MXU roof"),
}


def _write_cells(root):
    """Dry-run JSONs in the reference's schema: every branch of advice, both
    meshes, an MoE training cell."""
    cells = [("qwen3-0.6b", "train_4k", "16x16", 256, 5e14, 1e10, 1e9),
             ("qwen3-0.6b", "decode_32k", "16x16", 256, 1e10, 5e11, 1e8),
             ("dbrx-132b", "train_4k", "16x16", 256, 8e15, 1e12, 9e13),
             ("dbrx-132b", "prefill_32k", "16x16", 256, 3e15, 1e9, 1e8),
             ("gemma2-2b", "train_4k", "16x16", 256, 2e16, 1e10, 1e9),
             ("stablelm-3b", "train_4k", "16x16", 256, 5e13, 1e9, 1e8),
             ("dbrx-132b", "train_4k", "2x16x16", 512, 4e15, 1e12, 2e12)]
    root.mkdir(exist_ok=True)
    for arch, shape, mesh, n, flops, hbm, coll in cells:
        d = {"arch": arch, "shape": shape, "mesh": mesh, "n_devices": n, "compile_s": 1.5,
             "flops": flops, "dot_flops": flops, "hbm_bytes": hbm,
             "collectives": {"all-gather": {"bytes": coll / 2, "count": 3},
                             "all-reduce": {"bytes": coll / 2, "count": 2},
                             "reduce-scatter": {"bytes": 0, "count": 0},
                             "all-to-all": {"bytes": 0, "count": 0},
                             "collective-permute": {"bytes": 0, "count": 0},
                             "_total_bytes": coll}}
        (root / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(d))
    return root


def _same_row(a, b):
    return all(getattr(a, f) == getattr(b, f) for f in (
        "arch", "shape", "mesh", "n_devices", "compute_s", "memory_s", "collective_s",
        "model_flops_dev", "hlo_flops_dev", "hbm_bytes_dev", "coll_bytes_dev"))


def _as_reference(text: str, words: dict) -> str:
    """The port's text with each advice in the reference's words."""
    for port, ref in words.items():
        text = text.replace(port, ref)
    return text


def test_analysis_and_report_equal_the_reference(tmp_path, monkeypatch):
    root = _write_cells(tmp_path / "d")
    rows = analysis.load_rows(str(root), REF_PEAKS)
    ref_rows = ref_analysis.load_rows(str(root))
    assert len(rows) == len(ref_rows) == 7
    assert all(_same_row(a, b) for a, b in zip(rows, ref_rows))
    branches, words = set(), {}
    for a, b in zip(rows, ref_rows):
        assert (a.bound_s, a.dominant, a.useful_ratio, a.roofline_fraction) == (
            b.bound_s, b.dominant, b.useful_ratio, b.roofline_fraction)
        kind = next(k for k, (p, r) in ADVICE.items()
                    if a.advice().startswith(p) and b.advice().startswith(r))
        branches.add(kind)
        words[a.advice()] = b.advice()
    assert branches == set(ADVICE)  # every branch met, each the reference's
    assert _as_reference(analysis.markdown_table(rows), words) == ref_analysis.markdown_table(
        ref_rows)
    picks = analysis.pick_hillclimb_cells(rows)
    ref_picks = ref_analysis.pick_hillclimb_cells(ref_rows)
    assert {k: (r.arch, r.shape, r.mesh) for k, r in picks.items()} == {
        k: (r.arch, r.shape, r.mesh) for k, r in ref_picks.items()}

    from repro.roofline import report as ref_report

    base = _write_cells(tmp_path / "base")
    got = report.report(str(root), str(base), peaks=REF_PEAKS)
    monkeypatch.setattr(sys, "argv", ["report", "--dir", str(root), "--baseline", str(base)])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_report.main()
    assert _as_reference(got, words) == buf.getvalue()


def test_report_prints_the_peaks_it_is_given(tmp_path):
    root = _write_cells(tmp_path / "d")
    text = report.report(str(root), section="roofline")
    assert "Constants: 989 TFLOP/s bf16/chip, 3350 GB/s HBM, 450 GB/s/link NVLink." in text
    text = report.report(str(root), section="roofline", peaks=REF_PEAKS)
    assert "Constants: 197 TFLOP/s bf16/chip, 819 GB/s HBM, 50 GB/s/link ICI." in text


def test_card_peaks_are_the_published_ones():
    """Phase 5's bounds read these (they were ``chip_smoke.py``'s)."""
    assert analysis.card_peaks("NVIDIA H100 80GB HBM3") == {
        "bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12, "int8": 1979e12, "tf32": 495e12}
    assert analysis.card_peaks("NVIDIA H100 NVL")["bytes"] == 3.9e12
    assert analysis.card_peaks("NVIDIA H100 PCIe")["bfloat16"] == 756e12
    assert analysis.H100_SXM == analysis.Peaks(989e12, 3.35e12, 450e9)
    with pytest.raises(RuntimeError, match="no published peaks"):
        analysis.card_peaks("NVIDIA A100-SXM4-80GB")


def test_reanalyze_refreshes_both_kinds_of_artifact(tmp_path, jitted, monkeypatch):
    import zstandard

    from repro.roofline import reanalyze as ref_reanalyze
    from repro_torch.launch.dryrun import write_ledger
    from repro_torch.roofline import reanalyze

    root = tmp_path / "d"
    (root / "hlo").mkdir(parents=True)
    stale = {"arch": "qwen3-0.6b", "shape": "train_4k", "mesh": "16x16", "n_devices": 1,
             "flops": 0, "collectives": {"_total_bytes": 0}}
    (root / "hlo" / "a.hlo.zst").write_bytes(zstandard.compress(jitted["scan"].encode()))
    (root / "a.json").write_text(json.dumps(stale))
    with FakeTensorMode():
        x, w = torch.empty(64, 64), torch.empty(64, 64)
        c = _count(lambda: torch.tanh(x @ w))
    write_ledger(str(root / "hlo" / "b.ops.zst"), c.ledger_lines())
    (root / "b.json").write_text(json.dumps(stale))
    assert reanalyze.main(["--dir", str(root)]) == 0
    a, b = (json.loads((root / f"{t}.json").read_text()) for t in "ab")
    assert a["dot_flops"] == ref_hlo.analyze_hlo(jitted["scan"]).dot_flops
    assert b["dot_flops"] == 2 * 64 ** 3 and b["transcendentals"] == 64 * 64
    # the reference's reanalyze writes the HLO cell's JSON the same way
    (root / "a.json").write_text(json.dumps(stale))
    port_a = a
    monkeypatch.setattr(sys, "argv", ["reanalyze", "--dir", str(root)])
    with contextlib.redirect_stdout(io.StringIO()):
        ref_reanalyze.main()
    assert json.loads((root / "a.json").read_text()) == port_a
