"""The port's qwen3-0.6b and dbrx-132b smoke models on a (2, 2) ``("data",
"model")`` mesh of four gloo ranks (``tests/test_dist.py:100``/``:129``):
the sharded loss against the reference's single-device loss and the
port's meshless loss, and each placed leaf's local shape. Helpers and
tolerances: ``tests/test_torch_dist.py``.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.launch.mesh import spawn
from test_torch_dist import F32, LOSS_RTOL, MESH, _batch, _cfg, _local_shapes, _torch_batch

ARCHS = (("qwen3-0.6b", {}), ("dbrx-132b", {"capacity_factor": 8.0}))


def _ref_loss(arch, batch, **kw):
    """The reference's single-device loss (bf16 compute, as
    ``tests/test_dist.py`` runs it) on its own parameters, which it also
    returns as numpy for the port."""
    import jax
    import jax.numpy as jnp

    import repro.models.transformer as RT
    from repro.configs import get_arch as ref_get_arch

    cfg = dataclasses.replace(ref_get_arch(arch).smoke(), **kw)
    params = RT.init_params(cfg, jax.random.PRNGKey(0))
    loss, _ = jax.jit(lambda p, b: RT.train_loss(p, cfg, b))(
        params, {"tokens": jnp.asarray(batch["tokens"], jnp.int32)})
    return float(loss), jax.tree.map(np.asarray, params)


def _loss_on_mesh(api, params, batch, mesh):
    from repro_torch.dist.sharding import batch_pspecs, param_pspecs, place, use_mesh

    with use_mesh(mesh):
        placed = place(params, param_pspecs(params, mesh), mesh)
        loss, _ = api.loss(placed, place(batch, batch_pspecs(batch, mesh), mesh))
        return float(loss.full_tensor()), placed


def _losses_rank(rank, crossed):
    """Each arch's loss on the mesh (bf16, as the reference runs it, and
    f32) and without it (f32), and its placed leaves' local shapes."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.sharding import param_pspecs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model

    mesh = make_mesh(*MESH, device_type="cpu")
    sizes = dict(zip(*reversed(MESH)))
    out = {}
    for arch, kw in ARCHS:
        params_np, batch_np = crossed[arch]
        batch = _torch_batch(batch_np)
        res = {}
        for dtype in ("bfloat16", "float32"):
            cfg = _cfg(arch, dtype, **kw)
            api = build_model(cfg, "cpu")
            params = params_from_numpy(params_np, cfg, "cpu")
            res[f"mesh_{dtype}"], placed = _loss_on_mesh(api, params, batch, mesh)
        res["plain_float32"] = float(api.loss(params, batch)[0])
        res["model_leaves"], res["data_leaves"], res["bad_shapes"] = _local_shapes(
            placed, param_pspecs(params, mesh), sizes)
        local = placed["segments"][0][0]
        res["moe_local"] = (tuple(local["moe"]["w_gate"].to_local().shape)
                            if "moe" in local else None)
        out[arch] = res
    return out


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    crossed, ref = {}, {}
    for arch, kw in ARCHS:
        batch = _batch(_cfg(arch))
        ref[arch], params = _ref_loss(arch, batch, **kw)
        crossed[arch] = (params, batch)
    results = spawn(_losses_rank, 4, (crossed,),
                    store_path=str(tmp_path_factory.mktemp("models") / "store"), timeout=600)
    return results, ref


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b"])
def test_sharded_loss_matches_reference_and_meshless(models, arch):
    """``tests/test_dist.py:100``/``:129``: the loss on a (2, 2) fsdp + tp
    mesh (dbrx: expert parallel, capacity_factor 8) within rtol 2e-3 of the
    reference's single-device loss, and within f32 2e-5 of the port's
    meshless loss; every rank sees the same loss."""
    results, ref = models
    res = [r[arch] for r in results]
    for r in res:
        assert r["mesh_bfloat16"] == res[0]["mesh_bfloat16"]
        np.testing.assert_allclose(r["mesh_bfloat16"], ref[arch], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["mesh_float32"], r["plain_float32"], **F32)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b"])
def test_sharded_leaves_hold_their_shard_only(models, arch):
    """Really sharded, not replicated whole: each leaf whose spec names
    ``model`` or ``data`` holds its global shape divided by those axes on
    every rank; dbrx's experts split over ``model`` (8 / 2 a rank)."""
    results, _ = models
    for r in results:
        res = r[arch]
        assert res["bad_shapes"] == []
        assert res["model_leaves"] > 0 and res["data_leaves"] > 0
    if arch == "dbrx-132b":
        E = _cfg(arch).n_experts
        assert results[0][arch]["moe_local"][0] == E // 2
