"""mamba2-370m's SSD scan on head shards: four gloo ranks on a (1, 4)
``("data", "model")`` mesh, f32. The scan, the decode recurrence and the
decode conv split their heads (channels) over the model axis, which
replicates their inputs, as XLA splits the reference's
(``tests/test_torch_dryrun.py::test_repaired_cells_lower_on_a_fake_mesh``
counts the products). Held here: the sharded loss and every gradient leaf
equal the meshless ones with one and two B/C groups (replicated: each
rank expands the groups of its own two heads) and with eight (two a
rank, sharded with their heads), and
``ServeEngine`` on the mesh gives the meshless engine's tokens. Helpers:
``tests/test_torch_dist.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn
from test_torch_dist import _batch, _cfg, _torch_batch

MESH = ((1, 4), ("data", "model"))
#: of the loss, and of each gradient leaf's max|g|: f32 sums over the head
#: shards and their pending sums run in another order than without a mesh
TOL = 2e-5


def _ssm_rank(rank):
    """The loss and its gradients with and without the mesh for each group
    count, and both engines' tokens."""
    from repro_torch.dist.sharding import batch_pspecs, param_pspecs, place, use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import trainable
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serve.engine import Request, ServeEngine

    mesh = make_mesh(*MESH, device_type="cpu")
    out = {}
    for groups in (1, 2, 8):
        cfg = _cfg("mamba2-370m", ssm_groups=groups)
        api = build_model(cfg, "cpu")
        params = api.init(0)
        batch = _torch_batch(_batch(cfg, B=2, S=40))  # 40: two chunks and a padded tail
        tree = trainable(params)
        loss = api.loss(tree, batch)[0]
        grads = torch.autograd.grad(loss, tree_leaves(tree))
        with use_mesh(mesh):
            placed = trainable(place(params, param_pspecs(params, mesh), mesh))
            mloss = api.loss(placed, place(batch, batch_pspecs(batch, mesh), mesh))[0]
            mgrads = torch.autograd.grad(mloss, tree_leaves(placed))
        out[groups] = (float(loss), float(mloss.full_tensor()),
                       [float((m.full_tensor() - g).abs().max() / g.abs().max().clamp_min(1e-30))
                        for m, g in zip(mgrads, grads)])
    cfg = _cfg("mamba2-370m")
    prompts = [np.arange(1, 6 + 3 * i) for i in range(3)]
    tokens = []
    for m in (None, mesh):
        eng = ServeEngine(cfg, params=None if m is None else eng.params, seed=0, max_batch=4,
                          mesh=m, device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new=5))
        tokens.append({r.rid: list(r.tokens) for r in eng.step_batch()})
    out["tokens"] = tokens
    return out


@pytest.fixture(scope="module")
def ssm_runs(tmp_path_factory):
    return spawn(_ssm_rank, 4, store_path=str(tmp_path_factory.mktemp("ssm") / "store"),
                 timeout=600)


@pytest.mark.parametrize("groups", [1, 2, 8])
def test_ssd_scan_on_head_shards_keeps_loss_and_gradients(ssm_runs, groups):
    """On every rank, the loss on the mesh equals the meshless loss and
    each gradient leaf is within f32 tolerance of its max|g|: the scan's
    head shards, their pending sums for A and a replicated group, and the
    conv's channel shards give back the meshless gradients."""
    for res in ssm_runs:
        loss, mloss, errs = res[groups]
        assert abs(mloss - loss) <= TOL * abs(loss), (mloss, loss)
        assert max(errs) <= TOL, errs


def test_ssd_decode_on_head_shards_keeps_tokens(ssm_runs):
    """``ServeEngine`` on the mesh (prefill through the sharded scan, decode
    steps through the sharded recurrence and conv) gives the meshless
    engine's tokens on every rank."""
    for res in ssm_runs:
        meshless, sharded = res["tokens"]
        assert sharded == meshless and len(meshless) == 3
