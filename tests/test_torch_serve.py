"""The port's serving engines against the reference's, on the f32 qwen3-0.6b
smoke config with the reference's parameters converted in: the same
prompts give the same greedy tokens, and a recorder sees the same steps."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.models.transformer as RT
from repro.configs import get_arch as ref_get_arch
from repro.serve import engine as ref_engine
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.serve.engine import ContinuousBatchingEngine, Request, ServeEngine


@pytest.fixture(scope="module")
def setup():
    ref_cfg = dataclasses.replace(ref_get_arch("qwen3-0.6b").smoke(), compute_dtype="float32")
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke(), compute_dtype="float32")
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return ref_cfg, ref_params, cfg, params


def _prompts(n, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(rng.integers(8, 20))).astype(np.int32) for _ in range(n)]


def _requests(cls, prompts, max_new):
    return [cls(rid=i, prompt=p, max_new=max_new[i % len(max_new)]) for i, p in enumerate(prompts)]


class _Recorder:
    """Duck-typed trace recorder: logs what the engine reports."""

    def __init__(self):
        self.steps, self.measured = [], []

    def record_step(self, name, cfg, B, q, kv, phase, active=None):
        self.steps.append((name, B, q, kv, phase, active))

    def mark_measured(self, seconds):
        self.measured.append(seconds)


def test_serve_engine_matches_reference_greedy(setup):
    ref_cfg, ref_params, cfg, params = setup
    prompts = _prompts(5)
    ref_rec, rec = _Recorder(), _Recorder()
    ref = ref_engine.ServeEngine(ref_cfg, params=ref_params, max_batch=3, recorder=ref_rec)
    eng = ServeEngine(cfg, params=params, max_batch=3, recorder=rec, device="cpu")
    for r in _requests(ref_engine.Request, prompts, [4, 2]):
        ref.submit(r)
    for r in _requests(Request, prompts, [4, 2]):
        eng.submit(r)
    ref_out, out = [], []
    while ref.queue:
        ref_out += ref.step_batch()
    while eng.queue:
        out += eng.step_batch()
    assert [(r.rid, r.tokens, r.ticks) for r in out] == [
        (r.rid, r.tokens, r.ticks) for r in ref_out
    ]
    assert rec.steps == ref_rec.steps
    assert len(rec.measured) == len(rec.steps) and all(s > 0 for s in rec.measured)


def test_continuous_engine_matches_reference_greedy(setup):
    ref_cfg, ref_params, cfg, params = setup
    prompts = _prompts(5, seed=1)
    ref_rec, rec = _Recorder(), _Recorder()
    ref = ref_engine.ContinuousBatchingEngine(ref_cfg, slots=2, max_len=48, params=ref_params,
                                              recorder=ref_rec)
    eng = ContinuousBatchingEngine(cfg, slots=2, max_len=48, params=params, recorder=rec,
                                   device="cpu")
    for r in _requests(ref_engine.Request, prompts, [5, 3, 4]):
        ref.submit(r)
    for r in _requests(Request, prompts, [5, 3, 4]):
        eng.submit(r)
    ref_out = {r.rid: (r.tokens, r.ticks) for r in ref.run_to_completion()}
    out = {r.rid: (r.tokens, r.ticks) for r in eng.run_to_completion()}
    assert out == ref_out
    assert rec.steps == ref_rec.steps


def test_continuous_matches_isolated_serving(setup):
    _, _, cfg, params = setup
    prompt = _prompts(1, seed=3)[0]
    cont = ContinuousBatchingEngine(cfg, slots=2, max_len=48, params=params, device="cpu")
    cont.submit(Request(rid=0, prompt=prompt, max_new=5))
    iso = ServeEngine(cfg, params=cont.params, max_batch=1, device="cpu")
    iso.submit(Request(rid=0, prompt=prompt, max_new=5))
    assert cont.run_to_completion()[0].tokens == iso.step_batch()[0].tokens


def _sampled(cls, cfg, params, seed, **kw):
    eng = cls(cfg, params=params, seed=seed, device="cpu", **kw)
    for i, p in enumerate(_prompts(3, seed=5)):
        eng.submit(Request(rid=i, prompt=p, max_new=6, temperature=1.0))
    if cls is ServeEngine:
        out = []
        while eng.queue:
            out += eng.step_batch()
        return [r.tokens for r in out]
    return sorted((r.rid, r.tokens) for r in eng.run_to_completion())


@pytest.mark.parametrize("cls,kw", [(ServeEngine, {"max_batch": 2}),
                                    (ContinuousBatchingEngine, {"slots": 2, "max_len": 40})])
def test_temperature_sampling_is_reproducible_under_a_seed(setup, cls, kw):
    _, _, cfg, params = setup
    a = _sampled(cls, cfg, params, 0, **kw)
    assert a == _sampled(cls, cfg, params, 0, **kw)
    assert a != _sampled(cls, cfg, params, 1, **kw)
    flat = [t for toks in a for t in (toks[1] if isinstance(toks, tuple) else toks)]
    assert all(0 <= t < cfg.vocab_size for t in flat)


def test_sampling_follows_the_distribution(setup):
    """Gumbel-max draws follow softmax(logits / T)."""
    _, _, cfg, params = setup
    eng = ServeEngine(cfg, params=params, device="cpu")
    logits = torch.full((4000, cfg.padded_vocab), -1e4)
    logits[:, :3] = torch.tensor([0.0, 1.0, 2.0])
    draws = eng._runner.sample(logits, [2.0] * 4000, eng._runner.generator)
    freq = torch.bincount(draws, minlength=3)[:3].float() / 4000
    expect = torch.softmax(torch.tensor([0.0, 1.0, 2.0]) / 2.0, 0)
    assert torch.allclose(freq, expect, atol=0.03)


def test_engine_options_validate_and_mesh_runs_on_a_device_mesh(setup, tmp_path):
    """``mesh=`` takes a ``DeviceMesh``: on a (1, 1) mesh of one rank both
    engines give the meshless tokens at ``tp == pp == 1``, and anything that
    cannot place tensors is refused (tests/test_torch_dist_serve.py runs a
    (2, 2) mesh). What raises besides: predicted admission without its
    predictor or SLO, an unknown admission policy, and a family without a
    KV cache. ``audit=True`` without a predictor audits nothing, as the
    reference's."""
    from repro_torch.launch.mesh import make_mesh, process_group

    _, _, cfg, params = setup
    eng = ContinuousBatchingEngine(cfg, params=params, audit=True, device="cpu")
    assert eng.tp == eng.pp == 1 and eng.mesh is None
    prompts = _prompts(2, seed=7)
    with process_group(str(tmp_path / "store")):
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        for cls, kw in ((ServeEngine, {"max_batch": 2}),
                        (ContinuousBatchingEngine, {"slots": 2, "max_len": 40})):
            got = []
            for m in (None, mesh):
                e = cls(cfg, params=params, mesh=m, device="cpu", **kw)
                for i, p in enumerate(prompts):
                    e.submit(Request(rid=i, prompt=p, max_new=3))
                out = e.step_batch() if cls is ServeEngine else e.run_to_completion()
                got.append(sorted((r.rid, r.tokens) for r in out))
            assert got[0] == got[1] and e.mesh is mesh and (e.tp, e.pp) == (1, 1)
    for cls in (ServeEngine, ContinuousBatchingEngine):
        with pytest.raises(TypeError, match="DeviceMesh"):
            cls(cfg, params=params, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="admission="):
        ContinuousBatchingEngine(cfg, params=params, admission="predicted", device="cpu")
    with pytest.raises(ValueError, match="admission="):
        ContinuousBatchingEngine(cfg, params=params, admission="predicted",
                                 decode_slo_s=1.0, device="cpu")
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(cfg, params=params, admission="lottery", device="cpu")
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(get_arch("mamba2-370m").smoke(), device="cpu")


def test_launch_serve_runs_on_cpu(capsys):
    assert launch_serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "3"]) == 0
    assert "served 3 requests / 9 tokens" in capsys.readouterr().out
