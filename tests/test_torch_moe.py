"""The port's MoE model slice against the reference's, on the dbrx-132b
smoke config (and arctic-480b's, whose MoE layers add a dense residual FFN)
with the reference's weights converted in, f32 compute: the dispatch
geometry held equal, the layer's output and Switch aux loss within the
reference's f32 tolerance (2e-5) with the same dropped (token, slot) set,
prefill logits and decode chains within 2e-5 with equal greedy tokens in
both engines, and the dispatched bytes equal to
``decomposer.ep_alltoall_bytes``. On the CPU the expert FFN takes
``fused_moe``'s plain version (f32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as RM
import repro.models.transformer as RT
from repro.configs import get_arch as ref_get_arch
from repro.serve import engine as ref_engine
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.decomposer import COMPUTE_DTYPE_BYTES, ep_alltoall_bytes
from repro_torch.kernels.fused_moe import ops as moe_ops
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ContinuousBatchingEngine, Request, ServeEngine

TOL = 2e-5  # the reference's f32 tolerance (tests/test_kernels.py::_tol)


def _cfgs(arch="dbrx-132b", **kw):
    ref_cfg = dataclasses.replace(ref_get_arch(arch).smoke(), compute_dtype="float32", **kw)
    cfg = dataclasses.replace(get_arch(arch).smoke(), compute_dtype="float32", **kw)
    return ref_cfg, cfg


@pytest.fixture(scope="module", params=["dbrx-132b", "arctic-480b"])
def model(request):
    ref_cfg, cfg = _cfgs(request.param)
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return ref_cfg, ref_params, cfg, params


def _layer(ref_params, params, i=0):
    """Layer ``i``'s MoE parameters in both packages."""
    ref_p = jax.tree.map(lambda a: a[i], ref_params["segments"][0]["moe"])
    return ref_p, params["segments"][0][i]["moe"]


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


# ----------------------------------------------------------------------
# geometry and parameters
# ----------------------------------------------------------------------


def test_dispatch_geometry_and_capacity_equal_reference():
    for arch in ("dbrx-132b", "arctic-480b"):
        for cfg_of in (lambda a: a, lambda a: a.smoke()):
            ref_cfg, cfg = cfg_of(ref_get_arch(arch)), cfg_of(get_arch(arch))
            for T_ in (1, 2, 4, 7, 37, 64, 67, 512, 1000, 2003, 4096):
                for train in (False, True):
                    assert M.dispatch_geometry(cfg, T_, train=train) == \
                        RM.dispatch_geometry(ref_cfg, T_, train=train), (arch, T_, train)
            for group in (1, 3, 32, 512):
                for train in (False, True):
                    assert M._capacity(group, cfg, train) == RM._capacity(group, ref_cfg, train)


def test_params_from_numpy_carries_the_reference_moe_tree(model):
    ref_cfg, ref_params, cfg, params = model
    ref_tree = jax.tree.map(np.asarray, ref_params)
    for i in range(cfg.n_layers):
        layer = params["segments"][0][i]
        for path, leaf in jax.tree_util.tree_leaves_with_path(ref_tree["segments"][0]):
            keys = [k.key for k in path]
            node = layer
            for k in keys:
                node = node[k]
            assert np.array_equal(node.numpy(), leaf[i]), keys
    ref_shapes = jax.tree.map(lambda a: tuple(a.shape[1:]), ref_tree["segments"][0]["moe"])
    port = build_model(cfg, device="cpu").init(0)["segments"][0][0]["moe"]
    assert T.tree_map(lambda a: tuple(a.shape), port) == ref_shapes
    if cfg.dense_residual:
        assert "dense" in port


# ----------------------------------------------------------------------
# the layer: output, aux loss and the dropped (token, slot) set
# ----------------------------------------------------------------------


class _JnpProbe:
    """``jnp`` as the reference's MoE module sees it, keeping the operands
    of the combine einsum (the capacity one-hot holds who was kept)."""

    def __init__(self, seen):
        self.seen = seen

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        if spec == "gske,gskc->gsec":
            self.seen["pos_oh"] = np.asarray(ops[1])
        return jnp.einsum(spec, *ops, **kw)


class _TorchProbe:
    def __init__(self, seen):
        self.seen = seen

    def __getattr__(self, name):
        return getattr(torch, name)

    def einsum(self, spec, *ops):
        if spec == "gske,gskc->gsec":
            self.seen["pos_oh"] = ops[1].numpy()
        return torch.einsum(spec, *ops)


@pytest.mark.parametrize("capacity_factor", [8.0, None])
@pytest.mark.parametrize("train", [True, False])
def test_moe_layer_matches_reference(monkeypatch, capacity_factor, train):
    kw = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    ref_cfg, cfg = _cfgs(**kw)
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    ref_p, p = _layer(ref_params, params)
    x = np.random.default_rng(2).standard_normal((4, 96, cfg.d_model)).astype(np.float32)
    ref_seen, seen = {}, {}
    monkeypatch.setattr(RM, "jnp", _JnpProbe(ref_seen))
    monkeypatch.setattr(M, "torch", _TorchProbe(seen))
    ref_out, ref_aux = RM.moe_layer(ref_p, jnp.asarray(x), ref_cfg, train=train)
    with torch.no_grad():
        out, aux = M.moe_layer(p, torch.from_numpy(x), cfg, train=train)
    _close(out, ref_out)
    _close(aux, ref_aux)
    kept, ref_kept = seen["pos_oh"].sum(-1) > 0, ref_seen["pos_oh"].sum(-1) > 0
    assert np.array_equal(kept, ref_kept)
    # capacity_factor 8.0 never drops; the default (1.25 in training) does
    assert kept.all() == (capacity_factor == 8.0 or not train)


def test_moe_layer_pads_rows_for_the_kernel(monkeypatch):
    """A prime token count gives one-token groups and 2*67 = 134 rows a
    expert; they are padded to 256 for block_m = 128 and sliced off."""
    ref_cfg, cfg = _cfgs()
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(2))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    ref_p, p = _layer(ref_params, params)
    G, Sg, C = M.dispatch_geometry(cfg, 67, train=False)
    assert (G, Sg, G * C) == (67, 1, 134)
    launched = []
    inner = moe_ops.fused_moe

    def fused_moe(x, *w, block_m, **kw):
        launched.append((tuple(x.shape), block_m, x.is_contiguous()))
        return inner(x, *w, block_m=block_m, **kw)

    monkeypatch.setattr(moe_ops, "fused_moe", fused_moe)
    x = np.random.default_rng(1).standard_normal((1, 67, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        out, aux = M.moe_layer(p, torch.from_numpy(x), cfg, train=False)
    ref_out, ref_aux = RM.moe_layer(ref_p, jnp.asarray(x), ref_cfg, train=False)
    assert launched == [((cfg.n_experts, 256, cfg.d_model), 128, True)]
    _close(out, ref_out)
    _close(aux, ref_aux)
    # small row counts take block_m = rows, with no padding
    launched.clear()
    with torch.no_grad():
        M.moe_layer(p, torch.from_numpy(x[:, :4]), cfg, train=False)
    assert launched == [((cfg.n_experts, 4, cfg.d_model), 4, True)]


def test_dispatched_bytes_equal_ep_alltoall_bytes(monkeypatch):
    seen = []
    inner = M.expert_ffn
    monkeypatch.setattr(M, "expert_ffn", lambda xe, *w: seen.append(
        xe.numel() * xe.element_size()) or inner(xe, *w))
    for arch in ("dbrx-132b", "arctic-480b"):
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_arch(arch).smoke(), compute_dtype=dtype)
            p = build_model(cfg, device="cpu").init(0)["segments"][0][0]["moe"]
            p = T._cast(p, T.torch_dtype(dtype))
            for B, S in ((1, 1), (4, 1), (2, 37), (1, 96)):
                x = torch.randn(B, S, cfg.d_model).to(T.torch_dtype(dtype))
                with torch.no_grad():
                    M.moe_layer(p, x, cfg, train=False)
                assert seen.pop() == ep_alltoall_bytes({
                    "T": B * S, "d": cfg.d_model, "E": cfg.n_experts, "topk": cfg.top_k,
                    "capacity_factor": max(cfg.capacity_factor, 2.0),
                    "moe_group": cfg.moe_group, "dtype_bytes": COMPUTE_DTYPE_BYTES[dtype],
                }), (arch, dtype, B, S)


# ----------------------------------------------------------------------
# the model: prefill, decode chain, aux loss, and both engines
# ----------------------------------------------------------------------


def test_prefill_decode_chain_and_aux_match_reference(model):
    ref_cfg, ref_params, cfg, params = model
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 48))  # groups of 32
    for mode in ("prefill", "train"):
        h, aux, _ = RT.forward(ref_params, ref_cfg, {"tokens": jnp.asarray(toks)}, mode)
        with torch.no_grad():
            ph, paux, _ = T.forward(params, cfg, {"tokens": torch.from_numpy(toks)}, mode)
        _close(paux, aux)
        _close(T.full_logits(params, cfg, ph), RT.full_logits(ref_params, ref_cfg, h))
    api = build_model(cfg, device="cpu")
    h, _, ref_caches = RT.forward(ref_params, ref_cfg, {"tokens": jnp.asarray(toks)}, "prefill")
    ref_logits = RT.full_logits(ref_params, ref_cfg, h)[:, -1]
    with torch.no_grad():
        logits, caches = api.prefill(params, {"tokens": torch.from_numpy(toks)})
    ref_caches, caches = RT.pad_cache(ref_caches, ref_cfg, 56), T.pad_cache(caches, cfg, 56)
    _close(logits, ref_logits)
    for step in range(8):
        tok = np.asarray(jnp.argmax(ref_logits[:, : cfg.vocab_size], -1))
        assert np.array_equal(logits[:, : cfg.vocab_size].argmax(-1).numpy(), tok), step
        pos = np.full((2,), 48 + step)
        ref_logits, ref_caches = RT.decode_step(ref_params, ref_cfg, ref_caches,
                                                jnp.asarray(tok), jnp.asarray(pos))
        with torch.no_grad():
            logits, caches = api.decode(params, caches, torch.from_numpy(tok.copy()),
                                        torch.from_numpy(pos))
        _close(logits, ref_logits)


def test_init_cache_covers_the_moe_segment():
    ref_cfg, cfg = _cfgs()
    ref = jax.tree.map(lambda a: a.shape, RT.init_cache(ref_cfg, 3, 20))
    port = T.init_cache(cfg, 3, 20, "cpu")
    assert [{k: tuple(v.shape) for k, v in seg.items()} for seg in port] == \
        [{k: tuple(v) for k, v in seg.items()} for seg in ref]


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, int(rng.integers(5, 30))).astype(np.int32) for _ in range(n)]


def test_engines_serve_the_reference_greedy_tokens(model):
    ref_cfg, ref_params, cfg, params = model
    prompts = _prompts(5, seed=4)
    ref = ref_engine.ServeEngine(ref_cfg, params=ref_params, max_batch=3)
    eng = ServeEngine(cfg, params=params, max_batch=3, device="cpu")
    ref_c = ref_engine.ContinuousBatchingEngine(ref_cfg, slots=2, max_len=48, params=ref_params)
    eng_c = ContinuousBatchingEngine(cfg, slots=2, max_len=48, params=params, device="cpu")
    for i, p in enumerate(prompts):
        for e, req in ((ref, ref_engine.Request), (eng, Request), (ref_c, ref_engine.Request),
                       (eng_c, Request)):
            e.submit(req(rid=i, prompt=p, max_new=[5, 3][i % 2]))
    ref_out, out = [], []
    while ref.queue:
        ref_out += ref.step_batch()
    while eng.queue:
        out += eng.step_batch()
    assert [(r.rid, r.tokens) for r in out] == [(r.rid, r.tokens) for r in ref_out]
    assert {r.rid: r.tokens for r in eng_c.run_to_completion()} == \
        {r.rid: r.tokens for r in ref_c.run_to_completion()}
