"""The port's sharding rules (``repro_torch.dist.sharding``) held equal to
the reference's (``repro.dist.sharding``): ``resolve_pspec`` on the cases of
``tests/test_dist.py`` and over a sweep of shapes, roles and meshes, the
rule tables, and ``param_pspecs``, ``batch_pspecs``, ``cache_pspecs`` and
``train_state_pspecs`` over every registry arch on the production meshes,
leaf for leaf. Meshes are shapes only: ``repro.analysis.sharding.MeshShape``
on the reference's side, so no device is needed. Also: ``constrain`` and the
models' hooks, which the reference calls at the same 14 sites."""
import functools
import pickle

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as RP

import repro.models.transformer as RT
from repro.analysis.sharding import MeshShape as RefMeshShape
from repro.configs import get_arch as ref_get_arch
from repro.dist import sharding as ref
from repro.models.registry import batch_specs as ref_batch_specs
from repro.models.registry import build_model as ref_build_model
from repro.optim.adamw import AdamWState as RefAdamWState
from repro.train.step import train_state_pspecs as ref_train_state_pspecs
import repro_torch.analysis.sharding as port_sharding
from repro_torch.analysis.sharding import MeshShape
from repro_torch.configs import get_arch, list_archs
from repro_torch.dist import sharding as port
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.registry import batch_specs, build_model
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.train.step import train_state_pspecs

# the production geometries (the reference's launch.mesh): one pod, two
# pods, and the pipeline mesh (4 stages x 8 data x 8 model)
MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "4x8x8pp": {"pipe": 4, "data": 8, "model": 8},
}
META = torch.device("meta")


def _spec(s):
    """A reference or port PartitionSpec as a plain tuple of entries."""
    return tuple(s)


# ----------------------------------------------------------------------
# resolve_pspec and mesh_degrees
# ----------------------------------------------------------------------


@pytest.mark.parametrize("mesh,shape,roles,want", [
    # the cases of tests/test_dist.py::test_resolve_pspec_divisibility_fallback
    (MESHES["16x16"], (1, 128), ("batch", "tp"), (None, "model")),
    (MESHES["16x16"], (25, 64), ("tp", None), (None, None)),
    (MESHES["16x16"], (24, 48), ("fsdp", "tp"), (None, "model")),
    (MESHES["2x16x16"], (64, 10), ("batch", None), (("pod", "data"), None)),
    (MESHES["2x16x16"], (8, 10), ("batch", None), ("pod", None)),
    # an axis consumed once: experts take "model", the tp dim replicates
    (MESHES["16x16"], (16, 32, 64), ("experts", "fsdp", "tp"), ("model", "data", None)),
    (MESHES["4x8x8pp"], (6, 16, 16), ("pipe", "fsdp", "tp"), (None, "data", "model")),
    (MESHES["4x8x8pp"], (4, 16, 16), ("pipe", "fsdp", "tp"), ("pipe", "data", "model")),
])
def test_resolve_pspec_cases(mesh, shape, roles, want):
    got = port.resolve_pspec(shape, roles, mesh)
    exp = ref.resolve_pspec(shape, roles, RefMeshShape(mesh))
    assert _spec(got) == _spec(exp) == want
    assert repr(got) == repr(exp) and str(got) == str(exp)
    assert port.resolve_pspec(shape, roles, MeshShape(mesh)) == got


_ROLES = st.sampled_from([*ref._ROLE_AXES, None, "unknown"])


@st.composite
def _mesh(draw):
    names = draw(st.sampled_from([("data", "model"), ("pod", "data", "model"),
                                  ("data", "model", "pipe")]))
    return {n: draw(st.integers(1, 16)) for n in names}


@settings(max_examples=300, deadline=None)
@given(mesh=_mesh(), dims=st.lists(st.tuples(st.integers(1, 96), _ROLES), min_size=0,
                                   max_size=5))
def test_resolve_pspec_sweep(mesh, dims):
    shape, roles = tuple(d for d, _ in dims), tuple(r for _, r in dims)
    got = port.resolve_pspec(shape, roles, mesh)
    exp = ref.resolve_pspec(shape, roles, RefMeshShape(mesh))
    assert _spec(got) == _spec(exp)
    assert repr(got) == repr(exp)
    assert port.mesh_degrees(mesh) == ref.mesh_degrees(RefMeshShape(mesh))


def test_resolve_pspec_rejects_a_roles_length_mismatch():
    for fn, mesh in ((port.resolve_pspec, MESHES["16x16"]),
                     (ref.resolve_pspec, RefMeshShape(MESHES["16x16"]))):
        with pytest.raises(ValueError, match="vs roles"):
            fn((4, 4), ("batch",), mesh)


def test_mesh_degrees():
    assert port.mesh_degrees(None) == ref.mesh_degrees(None) == (1, 1)
    for sizes in MESHES.values():
        assert port.mesh_degrees(sizes) == ref.mesh_degrees(RefMeshShape(sizes))
        assert port.mesh_degrees(MeshShape(sizes)) == port.mesh_degrees(sizes)


def test_partition_spec_matches_jax():
    for entries in [(), ("data",), (None,), ("data", None), (("pod", "data"), "model", None),
                    (("pod",), None)]:
        got, exp = port.PartitionSpec(*entries), RP(*entries)
        assert repr(got) == repr(exp) and str(got) == str(exp)
        assert _spec(got) == _spec(exp)
        assert pickle.loads(pickle.dumps(got)) == got
        assert type(pickle.loads(pickle.dumps(got))) is port.PartitionSpec


def test_rule_tables_equal_the_references():
    assert port._ROLE_AXES == ref._ROLE_AXES
    assert port._PARAM_RULES == ref._PARAM_RULES
    assert port._MOE_PARAM_RULES == ref._MOE_PARAM_RULES
    assert port._CACHE_RULES == ref._CACHE_RULES
    assert port.AUDITED_PARAM_LEAVES == ref.AUDITED_PARAM_LEAVES


# ----------------------------------------------------------------------
# the tree mappers over every registry arch
# ----------------------------------------------------------------------


def _ref_flat(tree, is_leaf=None):
    """``{path: leaf}``, path the reference's keys and list indices."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): leaf
            for path, leaf in flat}


def _port_flat(tree, is_leaf):
    """``{path: leaf}``, path the port's keys and list indices."""
    return dict(port_sharding._flatten(tree, is_leaf))


def _is_rspec(x):
    return isinstance(x, RP)


def _is_pspec(x):
    return isinstance(x, port.PartitionSpec)


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    return jax.eval_shape(ref_build_model(ref_get_arch(arch)).init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _meta_params(arch):
    return T.init_params(get_arch(arch), torch.Generator().manual_seed(0), META)


def _stacked_path(path):
    """A per-layer leaf's path in the reference's stacked tree, and how many
    stack dims its reference leaf has in front: every list index but a
    segment's own is a layer of a stack."""
    out, dropped = [], 0
    for i, k in enumerate(path):
        if isinstance(k, int) and path[:i] != ("segments",):
            dropped += 1
        else:
            out.append(k)
    return tuple(out), dropped


@pytest.mark.parametrize("arch", list_archs())
def test_stacked_view_is_the_references_tree(arch):
    params = _meta_params(arch)
    assert all(p.is_meta for p in params.parameters())
    view = _port_flat(port.stacked_view(params), port._is_leaf)
    exp = _ref_flat(_ref_shapes(arch))
    assert view.keys() == exp.keys()
    for path, leaf in exp.items():
        assert view[path] == port.LeafShape(tuple(leaf.shape), str(leaf.dtype)), path
    assert port.stacked_view(port.stacked_view(params)) == port.stacked_view(params)


@pytest.mark.parametrize("arch", list_archs())
def test_param_pspecs_equal_the_references_on_every_arch(arch):
    """Leaf for leaf on the three production meshes: the stacked view's
    specs are the reference's; each per-layer spec is the reference's
    stacked spec with its stack entries (all None) dropped."""
    params, shapes = _meta_params(arch), _ref_shapes(arch)
    for sizes in MESHES.values():
        exp = {p: _spec(s) for p, s in
               _ref_flat(ref.param_pspecs(shapes, RefMeshShape(sizes)), _is_rspec).items()}
        stacked = _port_flat(port.param_pspecs(port.stacked_view(params), sizes), _is_pspec)
        assert {p: _spec(s) for p, s in stacked.items()} == exp
        per_layer = _port_flat(port.param_pspecs(params, MeshShape(sizes)), _is_pspec)
        assert len(per_layer) == sum(1 for _ in params.parameters())
        for path, spec in per_layer.items():
            ref_path, dropped = _stacked_path(path)
            assert exp[ref_path][:dropped] == (None,) * dropped, path
            assert _spec(spec) == exp[ref_path][dropped:], path


@pytest.mark.parametrize("arch", list_archs())
def test_cache_and_batch_pspecs_equal_the_references(arch):
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    caches = T.init_cache(cfg, 4, 128, META)
    ref_caches = jax.eval_shape(lambda: ref_build_model(rcfg).init_cache(4, 128))
    view = _port_flat(port.stacked_view(caches), port._is_leaf)
    for path, leaf in _ref_flat(ref_caches).items():
        assert view[path] == port.LeafShape(tuple(leaf.shape), str(leaf.dtype)), path
    for sizes in MESHES.values():
        exp = _ref_flat(ref.cache_pspecs(ref_caches, RefMeshShape(sizes)), _is_rspec)
        got = _port_flat(port.cache_pspecs(caches, sizes), _is_pspec)
        assert {p: _spec(s) for p, s in got.items()} == {p: _spec(s) for p, s in exp.items()}
        for B in (1, 2, 32, 64, 512):
            exp = ref.batch_pspecs(ref_batch_specs(rcfg, B, 96), RefMeshShape(sizes))
            got = port.batch_pspecs(batch_specs(cfg, B, 96), sizes)
            assert {k: _spec(v) for k, v in got.items()} == {k: _spec(v) for k, v in exp.items()}
    assert port.batch_pspecs({"x": torch.zeros(())}, MESHES["16x16"]) == {"x": ()}


@pytest.mark.parametrize("arch,err", [("qwen3-0.6b", False), ("dbrx-132b", True),
                                      ("llama-3.2-vision-11b", True)])
def test_train_state_pspecs_equal_the_references(arch, err):
    params = T.tree_map(lambda t: t.detach(), _meta_params(arch))
    state = {"params": params, "opt": AdamW(lr=lambda s: 1e-3).init(params), "step": 0,
             "err": T.tree_map(torch.empty_like, params) if err else None}
    shapes = _ref_shapes(arch)
    ref_state = {"params": shapes, "opt": RefAdamWState(step=None, mu=shapes, nu=shapes),
                 "step": None, "err": shapes if err else None}
    for sizes in MESHES.values():
        got = train_state_pspecs(state, sizes)
        exp = ref_train_state_pspecs(ref_state, RefMeshShape(sizes))
        assert isinstance(got["opt"], AdamWState)
        assert got["step"] == got["opt"].step == () and _spec(exp["step"]) == ()
        assert (got["err"] is None) == (exp["err"] is None)
        for key in ("params", "mu", "nu", "err"):
            mine = got["opt"]._asdict()[key] if key in ("mu", "nu") else got[key]
            theirs = exp["opt"]._asdict()[key] if key in ("mu", "nu") else exp[key]
            if theirs is None:
                continue
            theirs = {p: _spec(s) for p, s in _ref_flat(theirs, _is_rspec).items()}
            for path, spec in _port_flat(mine, _is_pspec).items():
                ref_path, dropped = _stacked_path(path)
                assert _spec(spec) == theirs[ref_path][dropped:], (key, path)


def test_a_rule_that_shards_a_stack_dim_is_refused():
    """An unaudited vector leaf rides the generic (fsdp, tp) fallback over its
    stacked ndim, which would split the layer-stack dim: refused."""
    tree = {"segments": [[{"mystery": torch.empty(32)} for _ in range(16)]]}
    with pytest.raises(ValueError, match="layer-stack dim"):
        port.param_pspecs(tree, MESHES["16x16"])
    with pytest.raises(ValueError, match="layers of a stack differ"):
        port.stacked_view({"segments": [[{"w": torch.empty(3)}, {"w": torch.empty(4)}]]})


# ----------------------------------------------------------------------
# constrain and the models' hooks
# ----------------------------------------------------------------------


def test_constrain_is_the_identity_without_a_mesh_and_places_under_one(tmp_path):
    """Without a mesh ``constrain`` returns its input; the spec is resolved
    first under any mesh; on a ``DeviceMesh`` (one rank here, a (1, 1)
    mesh) it returns a DTensor placed as ``to_named`` says, the same one
    again where it is already so placed; an axis-size mapping cannot place
    and raises."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_mesh, process_group

    x = torch.zeros(4, 8, 16)
    assert port.active_mesh() is None
    assert port.constrain(x, ("batch", None, None)) is x
    outer, inner = MeshShape(MESHES["16x16"]), {"data": 2, "model": 2}
    with port.use_mesh(outer):
        assert port.active_mesh() is outer
        with port.use_mesh(inner):
            assert port.active_mesh() is inner
            with pytest.raises(TypeError, match="DeviceMesh"):
                port.constrain(x, ("batch", None, None))
            with pytest.raises(ValueError, match="vs roles"):  # the spec is resolved first
                port.constrain(x, ("batch",))
        assert port.active_mesh() is outer
    assert port.active_mesh() is None
    with pytest.raises(TypeError, match="DeviceMesh"):
        port.to_named({"x": port.PartitionSpec()}, outer)
    with process_group(str(tmp_path / "store")):
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        with port.use_mesh(mesh):
            y = port.constrain(x, ("batch", None, "tp"))
            assert isinstance(y, DTensor) and torch.equal(y.full_tensor(), x)
            spec = port.resolve_pspec(x.shape, ("batch", None, "tp"), mesh)
            assert spec == port.PartitionSpec("data", None, "model")
            # a mesh dim of size 1 replicates: its one shard is the whole
            assert y.placements == port.to_named(spec, mesh) == (Replicate(), Replicate())
            assert port.constrain(y, ("batch", None, "tp")) is y
        assert port.to_named({"a": [spec], "n": None}, mesh) == {
            "a": [(Replicate(), Replicate())], "n": None}
    # placements on a (2, 2) mesh, read off its sizes alone
    fake = _FakeDeviceMesh((2, 2), ("data", "model"))
    assert port.placements(port.PartitionSpec("data", None, "model"), fake) == (Shard(0), Shard(2))
    assert port.placements(port.PartitionSpec(("data", "model")), fake) == (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="axis order"):
        port.placements(port.PartitionSpec(("model", "data")), fake)


class _FakeDeviceMesh(torch.distributed.device_mesh.DeviceMesh):
    """Sizes and dim names of a DeviceMesh, without a process group (what
    ``placements`` and ``_mesh_sizes`` read)."""

    def __init__(self, shape, names):
        self._shape, self._names = tuple(shape), tuple(names)

    @property
    def mesh_dim_names(self):
        return self._names

    @property
    def shape(self):
        return self._shape

    @property
    def ndim(self):
        return len(self._shape)

    def size(self, mesh_dim=None):
        return self._shape[mesh_dim]


def test_mesh_sizes_read_a_device_mesh_a_mapping_and_a_mesh_shape(tmp_path):
    """``_mesh_sizes`` (and so ``resolve_pspec`` and ``mesh_degrees``) reads a
    ``DeviceMesh`` by its dim names, a ``{axis: size}`` mapping, and
    anything whose ``.shape`` is such a mapping."""
    from repro_torch.launch.mesh import make_mesh, process_group

    fake = _FakeDeviceMesh((2, 4), ("data", "model"))
    assert port._mesh_sizes(fake) == {"data": 2, "model": 4}
    assert port.mesh_degrees(fake) == (4, 1)
    assert port._mesh_sizes({"data": 2, "model": 4}) == {"data": 2, "model": 4}
    assert port._mesh_sizes(MeshShape(MESHES["16x16"])) == {"data": 16, "model": 16}
    assert port.resolve_pspec((8, 12), ("batch", "tp"), fake) == port.PartitionSpec("data", "model")
    with process_group(str(tmp_path / "store")):
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        assert port._mesh_sizes(mesh) == {"data": 1, "model": 1}
        assert port.mesh_degrees(mesh) == (1, 1)


def _recorder(calls):
    def record(x, roles):
        calls.append((tuple(roles), tuple(x.shape)))
        return x

    return record


# one smoke model of each kind of block: dense (with gemma2's pairs and
# post-norms), MoE (arctic's with a dense residual), SSM, hybrid, whisper's
# encoder-decoder, llama-vision
HOOK_ARCHS = ["qwen3-0.6b", "gemma2-2b", "dbrx-132b", "mamba2-370m", "hymba-1.5b",
              "whisper-base", "llama-3.2-vision-11b", "arctic-480b"]


def _one_layer_a_stack(cfg):
    """The smoke config cut so that every layer stack holds one layer: the
    reference traces a stack's body once, the port runs each layer, so the
    two see the same calls. hymba at 4 layers has its global layers 0, 2, 3
    and one local layer, each a segment of its own."""
    import dataclasses

    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=4)
    if cfg.family == "vlm":
        return dataclasses.replace(cfg, n_layers=1, cross_every=1)
    if cfg.layer_pattern == "alt_local_global":
        return dataclasses.replace(cfg, n_layers=2)
    return dataclasses.replace(cfg, n_layers=1, n_enc_layers=min(cfg.n_enc_layers, 1))


@pytest.mark.parametrize("arch", HOOK_ARCHS)
def test_model_hooks_match_the_references_calls(arch, monkeypatch):
    """The port's models call ``constrain`` where the reference's do: the same
    roles on the same shapes, in the same order, through a prefill and a
    decode step (the reference traced with ``jax.eval_shape``). Without a
    mesh every hook returns its input."""
    import repro.dist.sharding as ref_sharding

    cfg = _one_layer_a_stack(get_arch(arch).smoke())
    rcfg = _one_layer_a_stack(ref_get_arch(arch).smoke())
    B, S = 2, 8
    ref_calls, port_calls = [], []
    monkeypatch.setattr(ref_sharding, "constrain", _recorder(ref_calls))
    monkeypatch.setattr(RT, "constrain", _recorder(ref_calls))
    for mod in (L, M, T):
        monkeypatch.setattr(mod, "constrain", _recorder(port_calls))

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    extra = {"audio": ("frames", cfg.enc_frames), "vlm": ("image_embeds", cfg.n_img_tokens)}
    batch = {"tokens": tokens}
    if cfg.family in extra:
        name, n = extra[cfg.family]
        batch[name] = 0.1 * rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)

    api = build_model(cfg, "cpu")
    params = api.init(0)
    with torch.no_grad():
        _, caches = api.prefill(params, {k: torch.from_numpy(v) for k, v in batch.items()})
        caches = T.pad_cache(caches, cfg, S + 1)
        api.decode(params, caches, torch.from_numpy(tokens[:, -1]), torch.full((B,), S))

    rapi = ref_build_model(rcfg)

    def prefill_then_decode(p, b):
        _, c = rapi.prefill(p, b)
        c = RT.pad_cache(c, rcfg, S + 1)
        return rapi.decode(p, c, b["tokens"][:, -1].astype(jax.numpy.int32),
                           jax.numpy.full((B,), S, jax.numpy.int32))

    rparams = jax.eval_shape(rapi.init, jax.random.PRNGKey(0))
    jax.eval_shape(prefill_then_decode, rparams, batch)
    assert port_calls == ref_calls
    assert port_calls  # every family reaches at least the embedding's hook
