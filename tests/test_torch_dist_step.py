"""One f32 train step of qwen3-0.6b smoke on a (2, 2) ``("data", "model")``
mesh of four gloo ranks against the meshless step (with and without
bucketed int8 EF compression), a meshless checkpoint restored onto the
mesh (``tests/test_dist.py:316``), and ``Trainer(mesh=, async_save=True)``
saving on two ranks. Helpers and tolerances: ``tests/test_torch_dist.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn
from test_torch_dist import F32, MESH, _batch, _cfg, _restored_summary, _torch_batch


def _step_rank(rank, batch_np, ckpt_dir):
    """The train step on the mesh and without it, then the restore."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist.sharding import batch_pspecs, place, to_named, use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import (
        TrainConfig,
        init_train_state,
        make_optimizer,
        make_train_step,
        train_state_pspecs,
    )
    from repro_torch.train.trainer import Trainer, TrainerConfig

    mesh = make_mesh(*MESH, device_type="cpu")
    sizes = dict(zip(*reversed(MESH)))
    out = {}
    cfg = _cfg("qwen3-0.6b")
    api = build_model(cfg, "cpu")
    tc = TrainConfig(warmup=1, total_steps=4)  # the default lr, 3e-4
    opt = make_optimizer(tc)
    params = T.tree_map(lambda t: t.detach(), api.init(0))
    state = {"params": params, "opt": opt.init(params), "step": 0, "err": None}
    step = make_train_step(api, opt, tc)
    batch = _torch_batch(batch_np)
    plain, plain_m = step(state, batch)
    with use_mesh(mesh):
        sharded = place(state, to_named(train_state_pspecs(state, mesh), mesh), mesh)
        new, m = step(sharded, place(batch, batch_pspecs(batch, mesh), mesh))
        new_params = [p.full_tensor() for p in tree_leaves(new["params"])]
        norm = float(m["grad_norm"].full_tensor())
    out["step"] = {
        "params": [p.numpy() for p in new_params] if rank == 0 else None,
        "plain": [p.numpy() for p in tree_leaves(plain["params"])] if rank == 0 else None,
        "grad_norm": (norm, float(plain_m["grad_norm"])),
        "moments_placed": all(type(mu).__name__ == "DTensor"
                              for mu in tree_leaves(new["opt"].mu)),
    }
    # the same step with bucketed int8 error-feedback compression of the
    # DTensor gradients (its residual is placed as the parameters are)
    tc = dataclasses.replace(tc, compress_grads=True, overlap_grads=True, bucket_bytes=4096)
    step = make_train_step(api, opt, tc)
    state["err"] = T.tree_map(lambda t: torch.zeros_like(t), params)
    plain, _ = step(state, batch)
    with use_mesh(mesh):
        sharded = place(state, to_named(train_state_pspecs(state, mesh), mesh), mesh)
        new, _ = step(sharded, place(batch, batch_pspecs(batch, mesh), mesh))
        gaps = [float((a.full_tensor() - b).abs().max())
                for a, b in zip(tree_leaves(new["params"]), tree_leaves(plain["params"]))]
        out["step"]["compressed_gap"] = max(gaps)
        out["step"]["err_placed"] = all(type(e).__name__ == "DTensor"
                                        for e in tree_leaves(new["err"]))

    # a checkpoint written without a mesh, restored onto the (2, 2) mesh
    cfg = _cfg("qwen3-0.6b", "bfloat16")
    tr = Trainer(cfg, DataConfig(batch=4, seq_len=32), TrainConfig(total_steps=2, warmup=1),
                 TrainerConfig(total_steps=2, ckpt_every=2, ckpt_dir=ckpt_dir, log_every=100),
                 mesh=mesh, device="cpu")
    state = init_train_state(tr.api, tr.optimizer, 0)
    with use_mesh(mesh):
        step, restored, _ = tr.ckpt.restore_latest(
            state, to_named(train_state_pspecs(state, mesh), mesh))
    out["restore"] = _restored_summary(step, restored, mesh, sizes)
    return out


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("step")
    # a checkpoint of a meshless run, which the ranks restore onto the mesh
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.step import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    ckpt = str(tmp / "meshless")
    tr = Trainer(_cfg("qwen3-0.6b", "bfloat16"), DataConfig(batch=4, seq_len=32),
                 TrainConfig(total_steps=2, warmup=1),
                 TrainerConfig(total_steps=2, ckpt_every=2, ckpt_dir=ckpt, log_every=100),
                 device="cpu")
    _, state, _ = tr.run()
    results = spawn(_step_rank, 4, (_batch(_cfg("qwen3-0.6b")), ckpt),
                    store_path=str(tmp / "store"), timeout=600)
    return results, state


def test_sharded_train_step_matches_meshless(stepped):
    """One f32 train step on the mesh (loss, ``torch.autograd.grad`` and
    AdamW on DTensors) gives the meshless step's parameters within f32
    2e-5, and its gradient norm is the global one; so does a step with
    bucketed int8 error-feedback compression of the DTensor gradients."""
    results, _ = stepped
    step = results[0]["step"]
    assert len(step["params"]) == len(step["plain"])
    for a, b in zip(step["params"], step["plain"]):
        np.testing.assert_allclose(a, b, **F32)
    for r in results:
        norm, plain = r["step"]["grad_norm"]
        np.testing.assert_allclose(norm, plain, **F32)
        assert r["step"]["moments_placed"] and r["step"]["err_placed"]
        assert r["step"]["compressed_gap"] <= F32["atol"]


def test_meshless_checkpoint_restores_onto_the_mesh(stepped):
    """``tests/test_dist.py:316``, first half: a checkpoint written without a
    mesh restores onto (2, 2) at step 2, each leaf a DTensor placed by
    ``train_state_pspecs`` and holding its shard only, with the values
    saved."""
    results, state = stepped
    from repro_torch.optim.adamw import tree_leaves

    first = tree_leaves(state["params"])[0].float().numpy()
    for r in results:
        res = r["restore"]
        assert res["step"] == 2 and res["opt_step"] == 2
        assert res["placed"] and res["mu_dtensor"] and res["bad_shapes"] == []
        np.testing.assert_array_equal(res["first"], first)


def _async_rank(rank, ckpt_dir):
    """Three steps on a (1, 2) mesh, a checkpoint after each, saved on a
    thread and then synchronously: the losses and what was published."""
    import os

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.step import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    mesh = make_mesh((1, 2), ("data", "model"), device_type="cpu")
    out = {}
    for async_save in (True, False):
        d = os.path.join(ckpt_dir, f"async_{async_save}")
        tr = Trainer(_cfg("qwen3-0.6b"), DataConfig(batch=2, seq_len=16),
                     TrainConfig(total_steps=3, warmup=1),
                     TrainerConfig(total_steps=3, ckpt_every=1, ckpt_dir=d, log_every=100,
                                   async_save=async_save),
                     mesh=mesh, device="cpu")
        step, _, losses = tr.run()
        out[async_save] = (step, losses, tr.ckpt.steps())
    return out


def test_async_save_on_a_mesh_publishes_every_checkpoint(tmp_path):
    """``Trainer(mesh=, async_save=True)`` on two ranks: rank 0 writes each
    of three checkpoints on a thread while every rank makes the same
    barriers, so the run neither hangs nor pairs a barrier with a step's
    collectives: its losses equal the synchronous run's and all three
    checkpoints are published before ``run`` returns."""
    results = spawn(_async_rank, 2, (str(tmp_path),), store_path=str(tmp_path / "store"),
                    timeout=240)
    for r in results:
        (step, losses, steps), sync = r[True], r[False]
        assert step == 3 and steps == [1, 2, 3] and sync[2] == [1, 2, 3]
        assert losses == sync[1] and len(losses) == 3
