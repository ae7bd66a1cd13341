"""The port's serving engines on a mesh, on the CPU (``tests/
test_serve_sharded.py``'s in-process cases and ``tests/
test_trace_residuals.py``'s mesh test): four gloo ranks on a (2, 2)
``("data", "model")`` mesh run both engines, f32, and give the meshless
engines' tokens; an attached recorder inherits the mesh's degrees; the
parameters and caches are placed, each rank holding its shard only. The
ranks meet through a ``FileStore`` in pytest's ``tmp_path``; the one-rank
case runs in this process.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_mesh, process_group, spawn
from repro_torch.serve.engine import ContinuousBatchingEngine, Request, ServeEngine
from repro_torch.serve.trace import TraceRecorder


def _f32_smoke(name="qwen3-0.6b"):
    # float32 compute so sharded-vs-unsharded argmax comparisons are not
    # at the mercy of bf16 reaccumulation ties (the reference's choice)
    return dataclasses.replace(get_arch(name).smoke(), compute_dtype="float32")


def _serve(eng, prompts, rid0, max_new):
    for i, p in enumerate(prompts):
        eng.submit(Request(rid0 + i, p, max_new=max_new))
    done = eng.step_batch() if isinstance(eng, ServeEngine) else eng.run_to_completion()
    return {r.rid: r.tokens for r in done}


def _engines_rank(rank):
    """Both engines with and without the (2, 2) mesh, on the same weights."""
    from torch.distributed.tensor import DTensor

    from repro_torch.optim.adamw import tree_leaves

    cfg = _f32_smoke()
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    prompts = [np.arange(1, 9 + i) for i in range(4)]
    out = {}

    eng1 = ServeEngine(cfg, seed=0, max_batch=4, device="cpu")
    ref = _serve(eng1, prompts, 0, 6)
    rec = TraceRecorder()
    eng2 = ServeEngine(cfg, params=eng1.params, seed=0, max_batch=4, mesh=mesh, recorder=rec,
                       device="cpu")
    out["serve"] = (_serve(eng2, prompts, 0, 6), ref)
    out["serve_degrees"] = (eng2.tp, eng2.pp, [(m.tp, m.pp) for m in rec.meta])
    leaves = [p.data for p in eng2.params.parameters()]
    out["placed"] = (all(isinstance(p, DTensor) for p in leaves),
                     sorted({str(tuple(p.placements)) for p in leaves}))
    wq = eng2.params["segments"][0][0]["attn"]["wq"].data
    out["wq"] = (tuple(wq.shape), tuple(wq.to_local().shape))

    c1 = ContinuousBatchingEngine(cfg, slots=2, max_len=48, seed=0, device="cpu")
    ref2 = _serve(c1, prompts, 10, 4)
    rec2 = TraceRecorder()
    c2 = ContinuousBatchingEngine(cfg, slots=2, max_len=48, params=c1.params, seed=0, mesh=mesh,
                                  recorder=rec2, device="cpu")
    out["continuous"] = (_serve(c2, prompts, 10, 4), ref2)
    out["continuous_degrees"] = (c2.tp, [m.tp for m in rec2.meta])
    k = tree_leaves(c2.caches)[0]
    out["cache"] = (tuple(k.shape), tuple(k.to_local().shape), str(tuple(k.placements)))
    return out


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    return spawn(_engines_rank, 4, store_path=str(tmp_path_factory.mktemp("serve") / "store"),
                 timeout=600)


@pytest.mark.parametrize("engine", ["serve", "continuous"])
def test_sharded_engines_match_meshless(engines, engine):
    """``tests/test_serve_sharded.py:104``/``:112``: both engines on a (2, 2)
    mesh give the meshless engines' tokens on the same weights, on every
    rank."""
    for r in engines:
        got, ref = r[engine]
        assert got == ref and len(got) == 4


def test_sharded_engines_report_and_record_the_mesh_degrees(engines):
    """The engines report the mesh's degrees, ``tp == 2``, and an attached
    recorder inherits them without the caller declaring ``tp=``: every
    recorded ``StepMeta`` has ``tp == 2``."""
    for r in engines:
        tp, pp, meta = r["serve_degrees"]
        assert (tp, pp) == (2, 1) and meta and all(m == (2, 1) for m in meta)
        tp, meta = r["continuous_degrees"]
        assert tp == 2 and meta and all(t == 2 for t in meta)


def test_sharded_engines_hold_their_shards_only(engines):
    """Parameters and caches are DTensors, genuinely sharded: ``wq``
    ``(d, H*hd)`` keeps a quarter on each rank (fsdp on ``data``, tp on
    ``model``), and the continuous engine's KV cache ``(L, slots, S, Hkv,
    hd)`` holds one slot and half the kv heads."""
    for r in engines:
        placed, kinds = r["placed"]
        assert placed and any("Shard" in k for k in kinds)
        (d, h), local = r["wq"]
        assert local == (d // 2, h // 2)
        shape, local, _ = r["cache"]
        assert local == (shape[0], shape[1] // 2, shape[2], shape[3] // 2, shape[4])


def test_continuous_engine_mesh_inherited_degrees(tmp_path):
    """``tests/test_trace_residuals.py``'s mesh test: on a (1, 1) mesh of this
    process the engine binds the recorder to its degrees, and the recorded
    meta re-lowers to its recorded calls, predicted alike."""
    from repro_torch.core.hardware import get_hw
    from repro_torch.predict import get_predictor
    from repro_torch.serve.monitor import step_predicted_s

    cfg = get_arch("qwen3-0.6b").smoke()
    predictor = get_predictor("oracle", get_hw("tpu-v5e"))
    with process_group(str(tmp_path / "store")):
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        rec = TraceRecorder()
        eng = ContinuousBatchingEngine(cfg, slots=2, max_len=48, recorder=rec, mesh=mesh,
                                       device="cpu")
        eng.submit(Request(rid=0, prompt=np.arange(1, 9), max_new=2))
        eng.run_to_completion()
    assert rec.resolved_tp == eng.tp == 1  # inherited, not declared
    assert all(m.tp == eng.tp and m.pp == eng.pp for m in rec.meta)
    assert all(m.measured_s > 0 for m in rec.meta)
    for (_, _, calls), meta in zip(rec.steps, rec.meta):
        assert step_predicted_s(meta, cfg, predictor) == predictor.predict(calls).total_s
