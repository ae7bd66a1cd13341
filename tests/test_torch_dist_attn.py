"""gemma2-2b's attention on a mesh whose model axis divides neither head
count: eight gloo ranks on a (1, 8) ``("data", "model")`` mesh, f32, the
smoke config (4 query and 2 KV heads). ``flash_attention.ops.row_split``
splits the KV heads 2 ways and the query rows 4 ways, as XLA splits the
reference's (``tests/test_torch_dryrun.py`` counts the products), each rank
masking its rows at their offset. Held here: the loss and every gradient
leaf on the mesh equal the meshless ones, and ``ServeEngine`` on the mesh
gives the meshless engine's greedy tokens. Helpers:
``tests/test_torch_dist.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn
from test_torch_dist import _batch, _cfg, _torch_batch

MESH = ((1, 8), ("data", "model"))
#: of the loss, and of each gradient leaf's max|g|: f32 sums over the row
#: blocks' pending sums run in another order than without a mesh
TOL = 2e-5


def _attn_rank(rank):
    """The loss and its gradients with and without the mesh, the number of
    split attention calls on the mesh, and both engines' tokens."""
    from repro_torch.dist.sharding import batch_pspecs, param_pspecs, place, use_mesh
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import trainable
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serve.engine import Request, ServeEngine

    split, calls = fa_ops._attention_split, []

    def counted(*a, **kw):
        calls.append(a[4:7])  # (mesh dim, h, r)
        return split(*a, **kw)

    fa_ops._attention_split = counted
    o_input, o_placements = fa_ops.o_input, []

    def recorded(*a):
        flat = o_input(*a)
        if hasattr(flat, "placements"):  # on the mesh
            o_placements.append(tuple((type(p).__name__, getattr(p, "dim", None))
                                      for p in flat.placements))
        return flat

    fa_ops.o_input = recorded
    mesh = make_mesh(*MESH, device_type="cpu")
    cfg = _cfg("gemma2-2b")
    api = build_model(cfg, "cpu")
    params = api.init(0)
    batch = _torch_batch(_batch(cfg, B=2, S=32))
    tree = trainable(params)
    loss = api.loss(tree, batch)[0]
    grads = torch.autograd.grad(loss, tree_leaves(tree))
    with use_mesh(mesh):
        placed = trainable(place(params, param_pspecs(params, mesh), mesh))
        mloss = api.loss(placed, place(batch, batch_pspecs(batch, mesh), mesh))[0]
        mgrads = torch.autograd.grad(mloss, tree_leaves(placed))
    out = {"loss": (float(loss), float(mloss.full_tensor())),
           "errs": [float((m.full_tensor() - g).abs().max() / g.abs().max().clamp_min(1e-30))
                    for m, g in zip(mgrads, grads)],
           "splits": sorted(set(calls)), "o_input": sorted(set(o_placements))}
    prompts = [np.arange(1, 9 + 4 * i) for i in range(3)]
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
def attn_runs(tmp_path_factory):
    return spawn(_attn_rank, 8, store_path=str(tmp_path_factory.mktemp("attn") / "store"),
                 timeout=600)


def test_split_attention_keeps_loss_and_gradients(attn_runs):
    """On every rank the attention ran split (2 KV head groups x 4 row
    blocks of the model axis), the loss on the mesh equals the meshless
    loss and each gradient leaf is within f32 tolerance of its max|g|."""
    for res in attn_runs:
        assert res["splits"] == [(1, 2, 4)], res["splits"]
        loss, mloss = res["loss"]
        assert abs(mloss - loss) <= TOL * abs(loss), (mloss, loss)
        assert max(res["errs"]) <= TOL, res["errs"]


def test_o_projection_input_is_split_on_the_mesh(attn_runs):
    """The o-projection's input is no longer replicated on the mesh: its
    columns are split over the model axis as ``wo``'s rows are
    (``flash_attention.ops.o_input``), so each rank's ``wo`` gradient is its
    share."""
    for res in attn_runs:
        assert res["o_input"] == [(("Replicate", None), ("Shard", 2))], res["o_input"]


def test_split_attention_keeps_greedy_tokens(attn_runs):
    """``ServeEngine`` on the mesh (its prefill through the split attention)
    gives the meshless engine's greedy tokens on every rank."""
    for res in attn_runs:
        meshless, sharded = res["tokens"]
        assert sharded == meshless and len(meshless) == 3
