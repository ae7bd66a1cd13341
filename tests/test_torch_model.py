"""The port's dense decoder against the reference on the qwen3-0.6b smoke
config: the reference's parameters, converted with ``params_from_numpy``,
run through both models on the same numpy tokens.

Tolerances: f32 compute 1e-4 (the reference's own model-vs-kernel bound,
``tests/test_kernels.py::test_flash_attention_matches_model_attention``);
bf16 compute 5e-2 of the largest reference value, since the two
frameworks round matmul outputs to bf16 at different places (the prefill
logits differ by about 1% of that scale on this config)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as RT
from repro.configs import get_arch as ref_get_arch
from repro.models.registry import build_model as ref_build_model
from repro_torch.configs import get_arch, list_archs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.silu_mul import ops as silu_ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.registry import build_model, materialize_batch

F32_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(compute_dtype):
    kw = dict(compute_dtype=compute_dtype, use_pallas=True)
    return (
        dataclasses.replace(ref_get_arch("qwen3-0.6b").smoke(), **kw),
        dataclasses.replace(get_arch("qwen3-0.6b").smoke(), **kw),
    )


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    ref_cfg, cfg = _cfgs(request.param)
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return request.param, ref_cfg, ref_params, cfg, params


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


def _close(ref, out, name, scale=None):
    if name == "float32":
        np.testing.assert_allclose(_np(out), _np(ref), **F32_TOL)
    else:
        scale = scale or float(np.abs(_np(ref)).max())
        assert float(np.abs(_np(out) - _np(ref)).max()) <= 5e-2 * scale


def params_dtype(name):
    return torch.float32 if name == "float32" else torch.bfloat16


@pytest.mark.parametrize("B,S", [(2, 32), (1, 19)])
def test_prefill_and_decode_match_reference(pair, B, S):
    name, ref_cfg, ref_params, cfg, params = pair
    tokens = np.random.default_rng(S).integers(0, cfg.vocab_size, (B, S))
    ref_api, api = ref_build_model(ref_cfg), build_model(cfg, device="cpu")
    ref_prefill, ref_decode = jax.jit(ref_api.prefill), jax.jit(ref_api.decode)

    ref_logits, ref_caches = ref_prefill(ref_params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    with torch.no_grad():
        logits, caches = api.prefill(params, {"tokens": torch.from_numpy(tokens)})
    _close(ref_logits, logits, name)
    for rc, c in zip(ref_caches, caches):
        for key in ("k", "v"):
            assert tuple(c[key].shape) == rc[key].shape and c[key].dtype == params_dtype(name)
            _close(rc[key], c[key], name)

    # 8 decode steps, both fed the reference's greedy tokens
    n_dec = 8
    ref_caches = RT.pad_cache(ref_caches, ref_cfg, S + n_dec)
    caches = T.pad_cache(caches, cfg, S + n_dec)
    tok = np.array(jnp.argmax(ref_logits, -1))  # a writable copy for torch
    for step in range(n_dec):
        pos = np.full((B,), S + step)
        ref_logits, ref_caches = ref_decode(
            ref_params, ref_caches, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32)
        )
        with torch.no_grad():
            logits, caches = api.decode(params, caches, torch.from_numpy(tok),
                                        torch.from_numpy(pos))
        _close(ref_logits, logits, name)
        tok = np.array(jnp.argmax(ref_logits, -1))  # a writable copy for torch
    for rc, c in zip(ref_caches, caches):
        _close(rc["k"], c["k"], name)


def test_full_logits_and_cast_for_compute(pair):
    name, ref_cfg, ref_params, cfg, params = pair
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    ref_hidden, _, _ = RT.forward(ref_params, ref_cfg, {"tokens": jnp.asarray(tokens)}, "prefill")
    ref_logits = RT.full_logits(ref_params, ref_cfg, ref_hidden)
    with torch.no_grad():
        # casting once ahead gives the same values as casting at every use
        cast = T.cast_for_compute(params, cfg)
        hidden, _, _ = T.forward(cast, cfg, {"tokens": torch.from_numpy(tokens)}, "prefill")
        logits = T.full_logits(cast, cfg, hidden)
        hidden2, _, _ = T.forward(params, cfg, {"tokens": torch.from_numpy(tokens)}, "prefill")
    assert torch.equal(hidden, hidden2)
    assert cast["final_norm"]["w"].dtype == torch.float32
    _close(ref_logits, logits, name)


def test_main_path_goes_through_the_kernel_entry_points(pair, monkeypatch):
    """Per forward: rmsnorm 4 * n_layers + 1 calls (ln1, q/k norms, ln2;
    final norm), act_mul n_layers, attention n_layers in prefill and 0 in
    decode, which stays on the plain chunked path."""
    name, _, _, cfg, params = pair
    calls = {"rmsnorm": 0, "act_mul": 0, "attention": 0}

    def counted(mod, fn_name):
        orig = getattr(mod, fn_name)

        def fn(*a, **kw):
            calls[fn_name] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(mod, fn_name, fn)

    counted(rms_ops, "rmsnorm")
    counted(silu_ops, "act_mul")
    counted(fa_ops, "attention")
    api = build_model(cfg, device="cpu")
    n = cfg.n_layers
    with torch.no_grad():
        logits, caches = api.prefill(params, materialize_batch(cfg, 2, 10, device="cpu"))
        assert calls == {"rmsnorm": 4 * n + 1, "act_mul": n, "attention": n}
        caches = T.pad_cache(caches, cfg, 12)
        api.decode(params, caches, logits.argmax(-1), torch.full((2,), 10))
    assert calls == {"rmsnorm": 2 * (4 * n + 1), "act_mul": 2 * n, "attention": n}


def test_init_params_has_the_reference_tree_and_laws():
    ref_cfg, cfg = _cfgs("float32")
    ref_tree = jax.tree.map(np.asarray, RT.init_params(ref_cfg, jax.random.PRNGKey(0)))
    params = build_model(cfg, device="cpu").init(0)
    shapes = lambda tree: {k: tuple(v.shape) for k, v in tree.state_dict().items()}
    assert shapes(params) == shapes(params_from_numpy(ref_tree, cfg, "cpu"))
    gen = torch.Generator().manual_seed(0)
    w = L.dense_init(gen, (512, 256), torch.float32, "cpu")
    std = 1.0 / np.sqrt(512)
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert abs(float(w.std()) / std - 0.8796) < 0.01  # std of N(0,1) cut at +-2
    e = L.embed_init(gen, (512, 256), torch.float32, "cpu")
    assert abs(float(e.std()) - 0.02) < 5e-4
    assert torch.equal(build_model(cfg, device="cpu").init(3)["embed"]["tok"],
                       build_model(cfg, device="cpu").init(3)["embed"]["tok"])


@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_inits_the_reference_tree(arch):
    """Every registered arch builds and inits in the port, with the tree
    and shapes of the reference's parameters carried across by
    ``params_from_numpy``; the SSM's f32 leaves follow the reference's laws."""
    ref_cfg, cfg = ref_get_arch(arch).smoke(), get_arch(arch).smoke()
    ref_tree = jax.tree.map(np.asarray, RT.init_params(ref_cfg, jax.random.PRNGKey(0)))
    params = build_model(cfg, device="cpu").init(0)
    state = lambda tree: {k: (tuple(v.shape), v.dtype) for k, v in tree.state_dict().items()}
    assert state(params) == state(params_from_numpy(ref_tree, cfg, "cpu"))
    for name, a in params.state_dict().items():
        if name.endswith(".A_log"):
            assert a.dtype == torch.float32 and bool(((a >= 0) & (a <= np.log(16.0))).all())
        if name.endswith(".dt_bias"):
            dt = torch.nn.functional.softplus(a)
            assert a.dtype == torch.float32 and bool(((dt > 9e-4) & (dt < 0.11)).all())
