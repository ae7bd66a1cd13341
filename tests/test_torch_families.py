"""The port's remaining model families against the reference, on the CPU.

For each of gemma2-2b (local/global pairs, softcaps, post-norms, geglu),
stablelm-3b (layernorm, partial rotary), mamba2-370m (SSD), hymba-1.5b
(attention and SSM heads, meta tokens), whisper-base (encoder-decoder,
layernorm, gelu) and llama-3.2-vision-11b (gated cross-attention groups),
the reference's smoke parameters go through ``params_from_numpy`` and both
models run on the same numpy tokens, frames and image embeds. llama-vision's
cross-attention gates are set away from their zero init (in the tree both
sides start from), so that its cross layers reach the logits.

Tolerances: the whole model in f32 within 1e-4 (``test_torch_model.py``'s),
in bf16 within 5e-2 of max|ref| (the two frameworks round to bf16 at other
places); the layer functions in f32 within 2e-5 (the reference's kernel
tolerance); greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as RL
import repro.models.ssm as RS
import repro.models.transformer as RT
from repro.configs import get_arch as ref_get_arch
from repro.models.registry import build_model as ref_build_model
from repro.serve import engine as ref_engine
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.silu_mul import ops as silu_ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.registry import build_model, materialize_batch
from repro_torch.serve.engine import ContinuousBatchingEngine, Request, ServeEngine

FAMILIES = ["gemma2-2b", "stablelm-3b", "mamba2-370m", "hymba-1.5b", "whisper-base",
            "llama-3.2-vision-11b"]
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
EXTRA = {"audio": "frames", "vlm": "image_embeds"}


def _cfgs(arch, compute_dtype="float32"):
    return (dataclasses.replace(ref_get_arch(arch).smoke(), compute_dtype=compute_dtype),
            dataclasses.replace(get_arch(arch).smoke(), compute_dtype=compute_dtype))


def _ref_params(ref_cfg, seed=0):
    params = RT.init_params(ref_cfg, jax.random.PRNGKey(seed))
    if ref_cfg.family == "vlm":  # open the zero-initialized gates
        cross = params["segments"][0]["cross"]
        cross["gate_attn"] = jnp.full_like(cross["gate_attn"], 0.7)
        cross["gate_ffn"] = jnp.full_like(cross["gate_ffn"], -0.4)
    return params


@pytest.fixture(scope="module")
def models():
    """(ref_cfg, ref_params, cfg, params) per (arch, compute dtype), built once."""
    cache = {}

    def get(arch, compute_dtype="float32"):
        if (arch, compute_dtype) not in cache:
            ref_cfg, cfg = _cfgs(arch, compute_dtype)
            ref_params = _ref_params(ref_cfg)
            params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
            cache[(arch, compute_dtype)] = (ref_cfg, ref_params, cfg, params)
        return cache[(arch, compute_dtype)]

    return get


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(ref, out, compute_dtype, scale=None):
    if compute_dtype == "float32":
        np.testing.assert_allclose(_np(out), _np(ref), **MODEL_TOL)
    else:
        scale = scale or float(np.abs(_np(ref)).max())
        assert float(np.abs(_np(out) - _np(ref)).max()) <= 5e-2 * scale


def _extra_arrays(cfg, B, seed):
    """The modality inputs of a batch of ``B``, as numpy f32 arrays."""
    if cfg.family not in EXTRA:
        return {}
    n = cfg.enc_frames if cfg.family == "audio" else cfg.n_img_tokens
    a = 0.1 * np.random.default_rng([seed, B]).standard_normal((B, n, cfg.d_model))
    return {EXTRA[cfg.family]: a.astype(np.float32)}


def _batches(cfg, tokens, compute_dtype):
    extra = _extra_arrays(cfg, tokens.shape[0], 7)
    ref = {"tokens": jnp.asarray(tokens, jnp.int32),
           **{k: jnp.asarray(v).astype(compute_dtype) for k, v in extra.items()}}
    port = {"tokens": torch.from_numpy(tokens),
            **{k: torch.from_numpy(v) for k, v in extra.items()}}
    return ref, port


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_chain_match_reference(models, arch, compute_dtype):
    """Prefill's last logits and every cache leaf, then 4 decode steps fed
    the reference's greedy tokens; a prompt long enough for gemma2's window
    (16) and hymba's local slice (meta 8 + window 16 + q_block 16) to cut
    keys, and not a whole number of SSD chunks or query blocks."""
    ref_cfg, ref_params, cfg, params = models(arch, compute_dtype)
    B, Sq, n_dec = 2, 45, 4
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, Sq))
    ref_batch, batch = _batches(cfg, tokens, compute_dtype)
    ref_api, api = ref_build_model(ref_cfg), build_model(cfg, device="cpu")
    ref_logits, ref_caches = jax.jit(ref_api.prefill)(ref_params, ref_batch)
    with torch.no_grad():
        logits, caches = api.prefill(params, batch)
    _close(ref_logits, logits, compute_dtype)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_caches)
    leaves = T.tree_map(lambda a: a, caches)
    for path, ref_leaf in ref_leaves:
        leaf = leaves
        for key in path:
            leaf = leaf[key.key if hasattr(key, "key") else key.idx]
        assert tuple(leaf.shape) == ref_leaf.shape, jax.tree_util.keystr(path)
        _close(ref_leaf, leaf, compute_dtype)

    ref_caches = RT.pad_cache(ref_caches, ref_cfg, Sq + n_dec)
    caches = T.pad_cache(caches, cfg, Sq + n_dec)
    ref_decode = jax.jit(ref_api.decode)
    tok = np.array(jnp.argmax(ref_logits, -1))
    for step in range(n_dec):
        pos = np.full((B,), Sq + step)
        ref_logits, ref_caches = ref_decode(ref_params, ref_caches, jnp.asarray(tok, jnp.int32),
                                            jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            logits, caches = api.decode(params, caches, torch.from_numpy(tok),
                                        torch.from_numpy(pos))
        _close(ref_logits, logits, compute_dtype)
        tok = np.array(jnp.argmax(ref_logits, -1))
    # the caches carried the state through the chain (SSM states written back)
    for (path, ref_leaf), leaf in zip(jax.tree_util.tree_leaves_with_path(ref_caches),
                                      jax.tree.leaves(T.tree_map(lambda a: a, caches))):
        _close(ref_leaf, leaf, compute_dtype)


def _serve(eng, request_cls, prompts, max_new):
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, prompt=p, max_new=max_new))
    if hasattr(eng, "step_batch"):
        out = []
        while eng.queue:
            out += eng.step_batch()
        return [(r.rid, r.tokens, r.ticks) for r in out]
    return sorted((r.rid, r.tokens, r.ticks) for r in eng.run_to_completion())


def _prompts(n, seed, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(rng.integers(20, 40))).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_engine_greedy_matches_reference(models, arch, monkeypatch):
    """Both ServeEngines on the same prompts give the same greedy tokens;
    the frames and image embeds each engine would draw are replaced by the
    same numpy arrays."""
    ref_cfg, ref_params, cfg, params = models(arch)
    ref = ref_engine.ServeEngine(ref_cfg, params=ref_params, max_batch=3)
    eng = ServeEngine(cfg, params=params, max_batch=3, device="cpu")
    monkeypatch.setattr(ref, "_extra_inputs", lambda B, key: {
        k: jnp.asarray(v) for k, v in _extra_arrays(cfg, B, 11).items()})
    monkeypatch.setattr(eng, "_extra_inputs", lambda B: {
        k: torch.from_numpy(v) for k, v in _extra_arrays(cfg, B, 11).items()})
    prompts = _prompts(5, seed=1)
    assert _serve(eng, Request, prompts, 4) == _serve(ref, ref_engine.Request, prompts, 4)


@pytest.mark.parametrize("arch", ["gemma2-2b", "stablelm-3b"])
def test_continuous_engine_greedy_matches_reference(models, arch):
    """The continuous engine's slot copy over gemma2's {local, global}
    cache tree and stablelm's flat one; prompts past gemma2's window."""
    ref_cfg, ref_params, cfg, params = models(arch)
    ref = ref_engine.ContinuousBatchingEngine(ref_cfg, slots=2, max_len=64, params=ref_params)
    eng = ContinuousBatchingEngine(cfg, slots=2, max_len=64, params=params, device="cpu")
    prompts = _prompts(4, seed=2)
    assert _serve(eng, Request, prompts, 5) == _serve(ref, ref_engine.Request, prompts, 5)


def test_continuous_engine_refuses_families_without_a_kv_cache():
    for arch in ("mamba2-370m", "hymba-1.5b", "whisper-base", "llama-3.2-vision-11b"):
        with pytest.raises(ValueError, match="KV-cache"):
            ContinuousBatchingEngine(get_arch(arch).smoke(), device="cpu")


def test_engine_extra_inputs_follow_the_seed():
    """Frames and image embeds: std 0.1, the compute type, reproducible
    under the engine's seed."""
    for arch, name in (("whisper-base", "frames"), ("llama-3.2-vision-11b", "image_embeds")):
        cfg = get_arch(arch).smoke()
        a = ServeEngine(cfg, seed=3, device="cpu")._extra_inputs(4)[name]
        b = ServeEngine(cfg, seed=3, device="cpu")._extra_inputs(4)[name]
        assert torch.equal(a, b) and a.dtype == torch.bfloat16
        assert a.shape == (4, cfg.enc_frames if name == "frames" else cfg.n_img_tokens, cfg.d_model)
        assert abs(float(a.float().std()) - 0.1) < 0.01
    assert ServeEngine(get_arch("gemma2-2b").smoke(), device="cpu")._extra_inputs(2) == {}


def test_materialize_batch_matches_the_specs():
    from repro.models.registry import batch_specs as ref_batch_specs
    from repro_torch.models.registry import batch_specs

    for arch in FAMILIES:
        ref_cfg, cfg = _cfgs(arch, "bfloat16")
        specs, ref_specs = batch_specs(cfg, 2, 9), ref_batch_specs(ref_cfg, 2, 9)
        assert {k: v.shape for k, v in specs.items()} == {k: v.shape for k, v in ref_specs.items()}
        batch = materialize_batch(cfg, 2, 9, seed=4, device="cpu")
        assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
            k: (s.shape, s.dtype) for k, s in specs.items()}
        again = materialize_batch(cfg, 2, 9, seed=4, device="cpu")
        assert all(torch.equal(batch[k], again[k]) for k in batch)


# ----------------------------------------------------------------------
# the layer functions, f32
# ----------------------------------------------------------------------


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def test_layernorm_matches_reference():
    rng = np.random.default_rng(0)
    x, w, b = _randn(rng, 3, 7, 40, scale=3.0), _randn(rng, 40), _randn(rng, 40)
    ref = RL.layernorm(*(jnp.asarray(a) for a in (x, w, b)))
    out = L.layernorm(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER_TOL)
    rx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    assert L.layernorm(tx, torch.from_numpy(w), torch.from_numpy(b)).dtype == torch.bfloat16
    np.testing.assert_allclose(
        _np(L.layernorm(tx, torch.from_numpy(w), torch.from_numpy(b))),
        _np(RL.layernorm(rx, jnp.asarray(w), jnp.asarray(b))), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("l,chunk,g", [(45, 16, 1), (64, 16, 2), (7, 16, 1)])
def test_ssd_chunked_matches_reference(l, chunk, g):
    """Including a tail that is not a whole chunk (dt = 0 padding)."""
    rng = np.random.default_rng(l)
    b, h, p, n = 2, 4, 8, 6
    x, B, C = _randn(rng, b, l, h, p), _randn(rng, b, l, g, n), _randn(rng, b, l, g, n)
    dt = np.exp(_randn(rng, b, l, h) - 3.0).astype(np.float32)
    A = -np.exp(_randn(rng, h)).astype(np.float32)
    ref_y, ref_s = RS.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk)
    y, s = S.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B, C)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **LAYER_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), **LAYER_TOL)


def test_ssm_layer_state_and_decode_match_reference(models):
    """The mixer's output, its conv window and SSM state, then three
    recurrent steps from that state."""
    ref_cfg, ref_params, cfg, params = models("mamba2-370m")
    ref_p = ref_params["segments"][0]["mix"]
    ref_p = jax.tree.map(lambda a: a[0], ref_p)
    p = params["segments"][0][0]["mix"]
    rng = np.random.default_rng(5)
    rx, tx = _pair(_randn(rng, 2, 23, cfg.d_model))
    ref_out, ref_st = RS.ssm_layer(ref_p, rx, ref_cfg)
    with torch.no_grad():
        out, st = S.ssm_layer(p, tx, cfg)
    for r, o in ((ref_out, out), (ref_st.conv, st.conv), (ref_st.ssm, st.ssm)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **LAYER_TOL)
    assert st.conv.shape == (2, S.conv_dim(cfg), cfg.conv_width - 1)
    for i in range(3):
        rx, tx = _pair(_randn(rng, 2, 1, cfg.d_model))
        ref_out, ref_st = RS.ssm_decode(ref_p, rx, ref_cfg, ref_st)
        with torch.no_grad():
            out, st = S.ssm_decode(p, tx, cfg, st)
        for r, o in ((ref_out, out), (ref_st.conv, st.conv), (ref_st.ssm, st.ssm)):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), **LAYER_TOL)


def _attn_inputs(rng, B, Sq, Skv, Hq, Hkv, D):
    return _randn(rng, B, Sq, Hq, D), _randn(rng, B, Skv, Hkv, D), _randn(rng, B, Skv, Hkv, D)


@pytest.mark.parametrize("kw", [
    dict(window=16, q_block=16, prefix=0),  # local slice
    dict(window=16, q_block=16, prefix=8),  # local slice with the meta prefix
    dict(window=8, q_block=16, prefix=4, Sq=40),  # ragged query blocks
    dict(window=None, q_block=16, prefix=8),  # global with a prefix
    dict(window=40, q_block=16, prefix=8),  # window too wide for a slice
], ids=["local", "local-prefix", "local-ragged", "global-prefix", "wide-window"])
def test_chunked_attention_paths_match_reference(kw):
    kw = dict(kw)
    Sq = kw.pop("Sq", 64)
    rng = np.random.default_rng(7)
    q, k, v = _attn_inputs(rng, 2, Sq, Sq, 4, 2, 16)
    pos = np.broadcast_to(np.arange(Sq)[None], (2, Sq)).copy()
    ref = RL.chunked_attention(*(jnp.asarray(a) for a in (q, k, v, pos, pos)), causal=True,
                               softcap=20.0, **kw)
    out = L.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v, pos, pos)), causal=True,
                              softcap=20.0, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER_TOL)


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("shape", [(2, 64, 4, 2, 16), (1, 96, 2, 1, 8)])
def test_triangular_attention_matches_reference(shape, softcap):
    """``tests/test_triangular.py``'s forward cases, through
    ``chunked_attention(causal_sparse=True)``."""
    B, Sq, Hkv, G, D = shape
    rng = np.random.default_rng(8)
    q, k, v = _attn_inputs(rng, B, Sq, Sq, Hkv * G, Hkv, D)
    pos = np.broadcast_to(np.arange(Sq)[None], (B, Sq)).copy()
    kw = dict(causal=True, softcap=softcap, q_block=16, causal_sparse=True)
    ref = RL.chunked_attention(*(jnp.asarray(a) for a in (q, k, v, pos, pos)), **kw)
    out = L.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v, pos, pos)), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER_TOL)
    dense = L.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v, pos, pos)),
                                **{**kw, "causal_sparse": False})
    np.testing.assert_allclose(out.numpy(), dense.numpy(), **LAYER_TOL)


def test_triangular_attention_visits_the_lower_triangle_only(monkeypatch):
    """nb(nb+1)/2 block pairs of q_block x q_block scores, not nb^2."""
    shapes = []
    orig = torch.einsum

    def einsum(eq, *ops):
        if eq == "bqhgd,bkhd->bhgqk":
            shapes.append(tuple(ops[1].shape))
        return orig(eq, *ops)

    monkeypatch.setattr(torch, "einsum", einsum)
    q = torch.randn(1, 64, 2, 8)
    pos = torch.arange(64)[None]
    L.chunked_attention(q, q, q, pos, pos, q_block=16, causal_sparse=True)
    assert len(shapes) == 4 * 5 // 2 and all(s[1] == 16 for s in shapes)


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-11b"])
def test_cross_attentions_match_reference(models, arch):
    """Prefill cross attention (the kernel's non-causal function) and the
    cached decode one, against a source longer than a query block."""
    ref_cfg, ref_params, cfg, params = models(arch)
    if cfg.family == "audio":
        ref_p = jax.tree.map(lambda a: a[0], ref_params["segments"][0]["xattn"])
        p = params["segments"][0][0]["xattn"]
    else:
        ref_p = jax.tree.map(lambda a: a[0], ref_params["segments"][0]["cross"]["attn"])
        p = params["segments"][0][0]["cross"]["attn"]
    rng = np.random.default_rng(9)
    rx, tx = _pair(_randn(rng, 2, 19, cfg.d_model))
    rsrc, tsrc = _pair(_randn(rng, 2, 37, cfg.d_model))
    ref_out, (rk, rv) = RL.cross_attention_layer(ref_p, rx, rsrc, ref_cfg)
    with torch.no_grad():
        out, (k, v) = L.cross_attention_layer(p, tx, tsrc, cfg)
    for r, o in ((ref_out, out), (rk, k), (rv, v)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **LAYER_TOL)
    rq, tq = _pair(_randn(rng, 2, 1, cfg.d_model))
    ref_dec = RL.cross_attention_cached(ref_p, rq, rk, rv, ref_cfg)
    with torch.no_grad():
        dec = L.cross_attention_cached(p, tq, k, v, cfg)
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref_dec), **LAYER_TOL)


def test_meta_token_positions_are_contiguous(models):
    """hymba's prefill positions (``[0..m) ++ base + m``) are ``0..m+S-1``,
    the flash-attention kernel's positions; equal to the reference's."""
    ref_cfg, ref_params, cfg, params = models("hymba-1.5b")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 13))
    base = np.broadcast_to(np.arange(13)[None], (2, 13))
    ref_x, ref_pos = RT._embed_input(ref_params, ref_cfg, jnp.asarray(tokens),
                                     jnp.asarray(base, jnp.int32))
    x, pos = T._embed_input(params, cfg, torch.from_numpy(tokens), torch.from_numpy(base.copy()))
    assert np.array_equal(pos.numpy(), np.asarray(ref_pos))
    assert torch.equal(pos, torch.arange(13 + cfg.meta_tokens).expand(2, -1))
    np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), **LAYER_TOL)
    # the global layers' kernel path checks that assumption where it is taken
    attn = params["segments"][0][0]["attn"]
    with torch.no_grad():
        L.attention_layer(attn, x, cfg, pos, window=None)
        with pytest.raises(RuntimeError, match="positions 0..S-1"):
            L.attention_layer(attn, x, cfg, pos + 1, window=None)


# ----------------------------------------------------------------------
# the kernel entry points on the families' paths
# ----------------------------------------------------------------------


def _expected_calls(cfg):
    """Entry-point calls of one prefill: (rmsnorm, act_mul, attention)."""
    n = cfg.n_layers
    norm = 0 if cfg.norm == "layernorm" else 1
    if cfg.family == "ssm":
        return 2 * n + 1, 0, 0
    if cfg.family == "hybrid":
        n_global = len({0, n // 2, n - 1})
        return 5 * n + 1, n, n_global
    if cfg.family == "audio":
        return 0, 0, cfg.n_enc_layers + 2 * n
    if cfg.family == "vlm":
        groups = n // cfg.cross_every
        return 2 * (n + groups) + 1, n + groups, n + groups
    per_layer = (4 if cfg.post_norms else 2) + (2 if cfg.qk_norm else 0)
    return norm * (per_layer * n + 1), n, n


@pytest.mark.parametrize("arch", FAMILIES)
def test_main_path_goes_through_the_kernel_entry_points(models, arch, monkeypatch):
    """Per prefill: rmsnorm, act_mul and attention calls as the family's
    blocks imply; gemma2's attention carries the window on its local
    layers and the softcap on all, and its FFN is geglu. Decode reaches
    rmsnorm and act_mul again and attention never."""
    _, _, cfg, params = models(arch)
    calls = {"rmsnorm": [], "act_mul": [], "attention": []}

    def counted(mod, name):
        orig = getattr(mod, name)

        def fn(*a, **kw):
            calls[name].append(kw)
            return orig(*a, **kw)

        monkeypatch.setattr(mod, name, fn)

    counted(rms_ops, "rmsnorm")
    counted(silu_ops, "act_mul")
    counted(fa_ops, "attention")
    api = build_model(cfg, device="cpu")
    with torch.no_grad():
        logits, caches = api.prefill(params, materialize_batch(cfg, 2, 40, device="cpu"))
    n_norm, n_act, n_attn = _expected_calls(cfg)
    assert [len(calls[k]) for k in ("rmsnorm", "act_mul", "attention")] == [n_norm, n_act, n_attn]
    if arch == "gemma2-2b":
        assert [c["window"] for c in calls["attention"]] == [cfg.window, None] * (cfg.n_layers // 2)
        assert all(c["softcap"] == 50.0 and c["causal"] for c in calls["attention"])
        assert all(c["act"] == "geglu" for c in calls["act_mul"])
    if arch == "whisper-base":  # encoder and cross attention are not causal
        assert sum(not c["causal"] for c in calls["attention"]) == cfg.n_enc_layers + cfg.n_layers
    if arch == "hymba-1.5b":
        assert all(c["window"] is None for c in calls["attention"])
    with torch.no_grad():
        api.decode(params, T.pad_cache(caches, cfg, 42), logits.argmax(-1), torch.full((2,), 40))
    assert [len(calls[k]) for k in ("rmsnorm", "act_mul", "attention")] == [
        2 * n_norm, 2 * n_act, n_attn]


# ----------------------------------------------------------------------
# trees, casting, the launcher
# ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_cache_and_pad_cache_trees_match_reference(arch):
    ref_cfg, cfg = _cfgs(arch, "bfloat16")
    ref_tree = jax.eval_shape(lambda: RT.init_cache(ref_cfg, 3, 20))
    tree = T.init_cache(cfg, 3, 20, "cpu")
    ref_shapes = [(jax.tree_util.keystr(p), a.shape, str(a.dtype))
                  for p, a in jax.tree_util.tree_leaves_with_path(ref_tree)]
    shapes = [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype).replace("torch.", ""))
              for p, a in jax.tree_util.tree_leaves_with_path(tree)]
    assert shapes == ref_shapes
    padded = T.pad_cache(tree, cfg, 31)
    ref_padded = jax.eval_shape(lambda t: RT.pad_cache(t, ref_cfg, 31), ref_tree)
    assert [tuple(a.shape) for a in jax.tree.leaves(padded)] == [
        a.shape for a in jax.tree.leaves(ref_padded)]


def test_cast_keeps_the_ssm_decay_in_f32(models):
    _, _, cfg, params = models("hymba-1.5b")
    cast = T.cast_for_compute(params, dataclasses.replace(cfg, compute_dtype="bfloat16"))
    mix = cast["segments"][0][0]["mix"]
    assert {k: mix[k].dtype for k in ("A_log", "dt_bias", "D")} == dict.fromkeys(
        ("A_log", "dt_bias", "D"), torch.float32)
    assert mix["in_proj"].dtype == cast["meta"].dtype == torch.bfloat16
    assert cast["final_norm"]["w"].dtype == torch.float32
    _, _, wcfg, wparams = models("whisper-base")
    wcast = T.cast_for_compute(wparams, dataclasses.replace(wcfg, compute_dtype="bfloat16"))
    assert wcast["enc"][0]["attn"]["wq"].dtype == wcast["dec_pos"].dtype == torch.bfloat16
    assert wcast["enc_pos"].dtype == torch.bfloat16
    assert wcast["enc_norm"]["w"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["whisper-base", "mamba2-370m"])
def test_launch_serve_runs_every_family_on_cpu(arch, capsys):
    assert launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "3"]) == 0
    assert "served 3 requests / 9 tokens" in capsys.readouterr().out
