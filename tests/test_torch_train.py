"""The port's training stack against the reference, on the CPU.

The same numpy inputs (gradients, tokens, the reference's initial
parameters crossed with ``params_from_numpy``) go through both packages:
error-feedback compression and its bucket ledger are held equal; the
synthetic batches equal, value for value; the cross entropies, ``train_loss``
and its gradients (``jax.grad`` against ``torch.autograd``) within f32 2e-5
(the reference's kernel tolerance); the loss trajectory of ``launch.train``
within rtol 2e-3 a step (``tests/test_dist.py``'s model-loss tolerance: the
smoke model computes in bf16, which the two frameworks round at other
places). The checkpoint, preemption and watchdog tests mirror
``tests/test_substrate.py``'s; the plain backward formulas of the three
kernels that training runs through are held against ``torch.autograd`` of
their plain forwards (their kernels are held against them on the card,
``tests/test_torch_cuda.py``).
"""
import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dist.collectives as RC
import repro.models.layers as RL
import repro.models.transformer as RT
from repro.configs import get_arch as ref_get_arch
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.train.step import TrainConfig as RefTrainConfig
from repro.train.step import init_train_state as ref_init_train_state
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch, list_archs
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist import collectives as C
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
from repro_torch.kernels.fused_moe.ref import fused_moe_bwd_ref, fused_moe_ref
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
from repro_torch.kernels.silu_mul.ref import silu_mul_bwd_ref, silu_mul_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import tree_flatten, tree_leaves
from repro_torch.train.step import TrainConfig, init_train_state, make_optimizer, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

F32 = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL = 2e-3
PARITY_ARCHS = ["qwen3-0.6b", "dbrx-132b", "gemma2-2b", "mamba2-370m"]


@pytest.fixture(autouse=True)
def one_thread():
    """Several pytest workers with a thread per core each slow small CPU
    models down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _grad_tree(rng):
    """A gradient tree with keys out of sorted order, nested, and of sizes
    that split into several buckets."""
    return {
        "w_up": rng.standard_normal((64, 48)).astype(np.float32),
        "b": {"z": rng.standard_normal((300,)).astype(np.float32),
              "a": rng.standard_normal((7, 5)).astype(np.float32)},
        "emb": 1e-3 * rng.standard_normal((128, 32)).astype(np.float32),
        "zero": np.zeros((9,), np.float32),
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------


def test_ef_compress_grads_equal_to_reference():
    rng = np.random.default_rng(0)
    err_ref, err = None, None
    for step in range(3):
        g = _grad_tree(rng)
        prev = tree_flatten(err)[0] if err is not None else None
        deq_ref, err_ref = RC.ef_compress_grads(_to_jax(g), err_ref)
        deq, err = C.ef_compress_grads(_to_torch(g), err)
        for a, b in zip(jax.tree.leaves(deq_ref), tree_flatten(deq)[0]):
            np.testing.assert_array_equal(_np(b), np.asarray(a))
        for a, b in zip(jax.tree.leaves(err_ref), tree_flatten(err)[0]):
            np.testing.assert_array_equal(_np(b), np.asarray(a))
        # per-leaf conservation: deq + new_err == grads + err, exactly in f32
        for i, (gl, dl, el) in enumerate(zip(tree_flatten(_to_torch(g))[0],
                                             tree_flatten(deq)[0], tree_flatten(err)[0])):
            target = gl if prev is None else gl + prev[i]
            assert el.dtype == torch.float32 and torch.equal(dl + el, target)
    q, scale = C.int8_quantize(torch.tensor([-2.5, -0.5, 0.5, 1.5, 2.5]) * (2.5 / 127))
    rq, rscale = RC.int8_quantize(jnp.asarray([-2.5, -0.5, 0.5, 1.5, 2.5]) * (2.5 / 127))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))  # half to even
    assert q.dtype == torch.int8 and float(scale) == float(rscale)


@pytest.mark.parametrize("bucket_bytes", [1, 400, 2500, 4 << 20])
def test_bucket_ledger_and_bucketed_compression_equal_to_reference(bucket_bytes):
    rng = np.random.default_rng(1)
    g = _grad_tree(rng)
    ref_leaves = jax.tree.leaves(_to_jax(g))
    ledger = C.bucket_leaves(tree_flatten(_to_torch(g))[0], bucket_bytes)
    assert ledger == [C.GradBucket(b.leaf_indices, b.nbytes)
                      for b in RC.bucket_leaves(ref_leaves, bucket_bytes)]
    calls = []

    def all_reduce(leaves):
        calls.append(len(leaves))
        return [2.0 * x for x in leaves]

    deq_ref, err_ref, ledger_ref = RC.ef_compress_grads_bucketed(
        _to_jax(g), None, bucket_bytes=bucket_bytes, all_reduce=lambda ls: [2.0 * x for x in ls])
    deq, err, ledger = C.ef_compress_grads_bucketed(
        _to_torch(g), None, bucket_bytes=bucket_bytes, all_reduce=all_reduce)
    assert [(b.leaf_indices, b.nbytes) for b in ledger] == [
        (b.leaf_indices, b.nbytes) for b in ledger_ref]
    assert calls == [len(b.leaf_indices) for b in ledger]
    for a, b in zip(jax.tree.leaves(deq_ref) + jax.tree.leaves(err_ref),
                    tree_flatten(deq)[0] + tree_flatten(err)[0]):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    # bucketing changes no arithmetic: equal to the synchronous path
    sync, sync_err = C.ef_compress_grads(_to_torch(g), None)
    for a, b in zip(tree_flatten(sync)[0], tree_flatten(deq)[0]):
        assert torch.equal(2.0 * a, b)


def test_ef_compression_bias_vanishes():
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    err, acc = None, torch.zeros_like(g_true)
    for _ in range(50):
        deq, err = C.ef_compress_grads({"g": g_true}, err)
        acc += deq["g"]
    torch.testing.assert_close(acc / 50, g_true, atol=2e-2, rtol=0)


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-base", "llama-3.2-vision-11b"])
@pytest.mark.parametrize("process_index,process_count", [(0, 1), (1, 2), (3, 4)])
def test_synthetic_batches_equal_to_reference(arch, process_index, process_count):
    kw = dict(batch=8, seq_len=33, seed=5, process_index=process_index,
              process_count=process_count)
    ref = RefSyntheticLM(ref_get_arch(arch).smoke(), RefDataConfig(**kw))
    port = SyntheticLM(get_arch(arch).smoke(), DataConfig(**kw))
    for step in (0, 1, 17):
        a, b = ref.batch_at(step), port.batch_at(step)
        assert sorted(a) == sorted(b)
        assert b["tokens"].dtype == np.int64 and b["tokens"].shape == (8 // process_count, 33)
        for key in a:
            np.testing.assert_array_equal(b[key], a[key])
    with pytest.raises(ValueError):
        SyntheticLM(get_arch(arch).smoke(), DataConfig(batch=6, seq_len=8, process_count=4))


# ----------------------------------------------------------------------
# cross entropies, train_loss and its gradients
# ----------------------------------------------------------------------


@pytest.mark.parametrize("vocab_size,block", [(250, 16), (256, 7), (256, 64)])
def test_cross_entropies_match_reference(vocab_size, block):
    """The padded vocabulary (250 of 256 slots) is masked out; the chunked
    form pads a ragged length; a final softcap applies in its logits."""
    cfg = dataclasses.replace(get_arch("gemma2-2b").smoke(), vocab_size=vocab_size,
                              compute_dtype="float32")
    ref_cfg = dataclasses.replace(ref_get_arch("gemma2-2b").smoke(), vocab_size=vocab_size,
                                  compute_dtype="float32")
    assert cfg.padded_vocab == 256
    rng = np.random.default_rng(vocab_size + block)
    B, S, d = 2, 37, cfg.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    head = (rng.standard_normal((d, 256)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, vocab_size, (B, S))
    valid = (rng.random((B, S)) > 0.2).astype(np.float32)
    embed = {"head": head, "tok": np.zeros((256, d), np.float32)}
    logits = rng.standard_normal((B, S, 256)).astype(np.float32) * 3
    ref = RL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid), vocab_size)
    out = L.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          torch.from_numpy(valid), vocab_size)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **F32)
    ref = RL.chunked_cross_entropy(jnp.asarray(x), _to_jax(embed), jnp.asarray(labels),
                                   jnp.asarray(valid), ref_cfg, block=block)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = L.chunked_cross_entropy(xt, _to_torch(embed), torch.from_numpy(labels),
                                  torch.from_numpy(valid), cfg, block=block)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **F32)
    ref_dx = jax.grad(lambda a: RL.chunked_cross_entropy(
        a, _to_jax(embed), jnp.asarray(labels), jnp.asarray(valid), ref_cfg, block=block))(
        jnp.asarray(x))
    (dx,) = torch.autograd.grad(out, xt)
    np.testing.assert_allclose(_np(dx), np.asarray(ref_dx), **F32)


def _crossed(arch, seed=0):
    ref_cfg = dataclasses.replace(ref_get_arch(arch).smoke(), compute_dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).smoke(), compute_dtype="float32")
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(seed))
    if ref_cfg.family == "vlm":  # open the zero-initialized gates, so the cross layers count
        cross = ref_params["segments"][0]["cross"]
        cross["gate_attn"] = jnp.full_like(cross["gate_attn"], 0.7)
        cross["gate_ffn"] = jnp.full_like(cross["gate_ffn"], -0.4)
    return ref_cfg, cfg, ref_params


def _batch(cfg, B=2, S=40, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.family == "audio":
        batch["frames"] = 0.1 * rng.standard_normal((B, cfg.enc_frames, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = 0.1 * rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _port_loss_and_grads(cfg, params_tree, batch):
    params = T.trainable(params_tree)
    leaves = tree_leaves(params)
    loss, metrics = build_model(cfg, "cpu").loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, metrics, leaves, grads


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_train_loss_and_grads_match_reference(arch):
    """qwen3 (dense, qk-norm), dbrx (MoE: the aux loss), gemma2 (softcaps,
    a window, post-norms), mamba2 (the SSD scan), f32, remat on."""
    ref_cfg, cfg, ref_params = _crossed(arch)
    assert cfg.remat == "layer"
    batch = _batch(cfg)
    ref_batch = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
                 for k, v in batch.items()}
    (ref_loss, ref_m), ref_grads = jax.value_and_grad(
        lambda p: RT.train_loss(p, ref_cfg, ref_batch), has_aux=True)(ref_params)
    loss, metrics, leaves, grads = _port_loss_and_grads(
        cfg, params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, "cpu"), batch)
    np.testing.assert_allclose(_np(loss), np.asarray(ref_loss), **F32)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(_np(metrics[key]), np.asarray(ref_m[key]), **F32)
    if arch == "dbrx-132b":
        assert float(metrics["aux"].detach()) > 0
    expected = tree_leaves(T.tree_map(
        lambda t: t, params_from_numpy(jax.tree.map(np.asarray, ref_grads), cfg, "cpu")))
    assert len(grads) == len(expected)
    for g, r in zip(grads, expected):
        assert g is not None
        np.testing.assert_allclose(_np(g), _np(r), **F32)


@pytest.mark.parametrize("arch", [a for a in list_archs() if a not in PARITY_ARCHS])
def test_train_loss_grads_finite_for_every_other_family(arch):
    _, cfg, ref_params = _crossed(arch)
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    loss, _, leaves, grads = _port_loss_and_grads(
        cfg, params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, "cpu"), _batch(cfg))
    assert np.isfinite(float(loss))
    used = [g for g in grads if g is not None]
    assert len(used) >= len(leaves) - 1  # whisper's decoder positions are read in part only
    assert all(bool(torch.isfinite(g).all()) for g in used)
    assert sum(float(g.abs().sum()) > 0 for g in used) > len(used) // 2


def test_layer_remat_changes_no_gradient():
    """``remat="layer"`` (each layer under torch.utils.checkpoint) gives the
    gradients of ``remat="none"``, bit for bit on the CPU; and the Tree the
    trainable leaves came from stays frozen."""
    _, cfg, ref_params = _crossed("qwen3-0.6b")
    tree = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    batch = _batch(cfg)
    _, _, _, g_remat = _port_loss_and_grads(cfg, tree, batch)
    _, _, _, g_none = _port_loss_and_grads(dataclasses.replace(cfg, remat="none"), tree, batch)
    assert all(torch.equal(a, b) for a, b in zip(g_remat, g_none))
    assert not any(p.requires_grad for p in tree.parameters())


# ----------------------------------------------------------------------
# the launcher's loss trajectory, from the reference's initial state
# ----------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--compress-grads"], ["--microbatches", "2"]],
                         ids=["plain", "compress", "microbatches"])
def test_launch_train_trajectory_matches_reference(tmp_path, capsys, extra):
    """``launch.train --arch qwen3-0.6b --smoke --steps 6 --batch 4 --seq 32``
    on both packages. The port starts from the reference's initial state:
    it is written as the port's step-0 checkpoint, which the launcher
    resumes."""
    def argv(ckpt_dir):
        return ["--arch", "qwen3-0.6b", "--smoke", "--steps", "6", "--batch", "4", "--seq", "32",
                "--ckpt-dir", str(ckpt_dir), "--device", "cpu", *extra]

    args = launch_train.parse_args(argv(tmp_path / "port"))
    ref_cfg = ref_get_arch("qwen3-0.6b").smoke()
    ref = RefTrainer(
        ref_cfg, RefDataConfig(batch=4, seq_len=32),
        RefTrainConfig(lr=args.lr, total_steps=6, warmup=1, microbatches=args.microbatches,
                       compress_grads=args.compress_grads),
        RefTrainerConfig(total_steps=6, ckpt_every=20, ckpt_dir=str(tmp_path / "ref")))
    _, _, ref_losses = ref.run()
    ref_state = ref_init_train_state(ref.api, ref.optimizer, jax.random.PRNGKey(0),
                                     compress_grads=args.compress_grads)

    trainer = launch_train.build_trainer(args)
    state = init_train_state(trainer.api, trainer.optimizer, 0,
                             compress_grads=args.compress_grads)
    state["params"] = T.tree_map(lambda t: t.detach(), params_from_numpy(
        jax.tree.map(np.asarray, ref_state["params"]), trainer.cfg, "cpu"))
    state["opt"] = trainer.optimizer.init(state["params"])
    trainer.ckpt.save(0, state)
    step, _, losses = trainer.run()
    assert step == 6 and len(losses) == 6
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]

    # the CLI itself, from the same step-0 checkpoint in a fresh directory
    CheckpointManager(str(tmp_path / "cli")).save(0, state)
    assert launch_train.main(argv(tmp_path / "cli")) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == f"finished at step 6; loss {losses[0]:.4f} -> {losses[-1]:.4f}"


def test_launch_train_mesh_flags_check_their_rank_counts(tmp_path, monkeypatch):
    """``--mesh RxC`` spawns ``R*C`` ranks (``tests/test_torch_dist.py`` runs
    a 2x2 mesh); ``--devices`` must agree with it and means nothing without
    it; NCCL ranks need one GPU each, and more than the machine has are
    refused before any process starts, never moved to the CPU."""
    base = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)]
    args = launch_train.parse_args(base + ["--mesh", "2x2", "--device", "cpu"])
    assert launch_train.mesh_shape(args) == (2, 2)
    assert launch_train.mesh_shape(launch_train.parse_args(base)) == ()
    for flags, match in ((["--devices", "4"], "pass --mesh"),
                         (["--mesh", "2x2", "--devices", "3"], "--devices says 3")):
        with pytest.raises(ValueError, match=match):
            launch_train.main(base + ["--device", "cpu", *flags])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 NCCL ranks need 2 GPUs"):
        launch_train.main(base + ["--mesh", "1x2"])


def test_launch_train_layers_cuts_the_depth_at_full_width(tmp_path):
    """``--layers N`` trains the arch's own widths at N layers (the config's
    depth without it), so a model whose train state does not fit one card
    at full depth trains on it cut."""
    base = ["--arch", "gemma2-2b", "--steps", "1", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    full = get_arch("gemma2-2b")
    assert launch_train.arch_config(launch_train.parse_args(base)) == full
    cut = launch_train.arch_config(launch_train.parse_args(base + ["--layers", "2"]))
    assert cut == dataclasses.replace(full, n_layers=2)
    smoke = launch_train.parse_args(base + ["--smoke", "--layers", "4"])
    assert launch_train.arch_config(smoke) == dataclasses.replace(full.smoke(), n_layers=4)
    assert launch_train.build_trainer(smoke).cfg.n_layers == 4


# ----------------------------------------------------------------------
# checkpoints and fault tolerance (tests/test_substrate.py's, on the port)
# ----------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)},
             "h": torch.randn(5).to(torch.bfloat16), "n": 7, "none": None}
    mgr.save(3, state, extra={"loss": 1.5})
    mgr.save(6, state)
    mgr.save(9, state)
    assert mgr.steps() == [6, 9]  # keep=2 retention
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4)},
            "h": torch.zeros(5, dtype=torch.bfloat16), "n": 0, "none": None}
    step, new_state, extra = mgr.restore_latest(like)
    assert step == 9 and extra == {}
    assert torch.equal(new_state["a"], state["a"]) and torch.equal(new_state["h"], state["h"])
    assert new_state["n"] == 7 and new_state["none"] is None
    assert mgr.restore(6, like)[0]["b"]["c"].dtype == torch.float32
    # restore(shardings=) places each leaf on the active mesh (one rank here)
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.sharding import PartitionSpec, use_mesh
    from repro_torch.launch.mesh import make_mesh, process_group

    with pytest.raises(ValueError, match="use_mesh"):
        mgr.restore(9, like, shardings={"a": PartitionSpec("data", None)})
    with process_group(str(tmp_path / "store")):
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        with use_mesh(mesh):
            placed, _ = mgr.restore(9, like, shardings={
                "a": PartitionSpec("data", None), "b": {"c": (Replicate(), Replicate())},
                "h": None, "n": PartitionSpec(), "none": None})
        assert isinstance(placed["a"], DTensor) and isinstance(placed["b"]["c"], DTensor)
        assert placed["a"].placements == (Replicate(), Replicate())
        assert torch.equal(placed["a"].full_tensor(), state["a"])
        assert not isinstance(placed["h"], DTensor) and torch.equal(placed["h"], state["h"])
        assert placed["n"] == 7
        # a DTensor leaf of ``like`` comes back placed as it is
        again, _ = mgr.restore(9, placed)
        assert again["a"].placements == placed["a"].placements
        assert torch.equal(again["b"]["c"].full_tensor(), state["b"]["c"])


def test_checkpoint_layout_is_the_references(tmp_path):
    """``step_XXXXXXXXXX/{arrays.npz, manifest.json}``, leaves numbered in
    the reference's flatten order (dict keys sorted)."""
    import json

    state = {"z": torch.full((2,), 3.0), "a": {"y": torch.zeros(1), "b": torch.ones(3)}}
    CheckpointManager(str(tmp_path)).save(12, state, extra={"loss": 2.0})
    path = tmp_path / "step_0000000012"
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["step"] == 12 and manifest["n_leaves"] == 3
    assert manifest["paths"] == ["/a/b", "/a/y", "/z"] and manifest["extra"] == {"loss": 2.0}
    with np.load(path / "arrays.npz") as data:
        ref = jax.tree.leaves({"z": np.full((2,), 3.0), "a": {"y": np.zeros(1), "b": np.ones(3)}})
        for i, leaf in enumerate(ref):
            np.testing.assert_array_equal(data[f"leaf_{i:05d}"], leaf)


def test_restored_state_keeps_the_trees_key_order(tmp_path):
    """Leaves are numbered in sorted-key order, but a restored tree keeps
    the key order of the tree it restores into: ``tree_leaves`` (and so
    the order of ``global_norm``'s sum) is the same as before the save."""
    state = {"z": {"b": torch.ones(2), "a": torch.zeros(3)}, "m": [torch.full((1,), 2.0)]}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    _, restored, _ = mgr.restore_latest(state)
    assert list(restored) == ["z", "m"] and list(restored["z"]) == ["b", "a"]
    assert [t.tolist() for t in tree_leaves(restored)] == [t.tolist() for t in tree_leaves(state)]
    deq, _ = C.ef_compress_grads(state, None)
    assert list(deq["z"]) == ["b", "a"]


def test_checkpoint_atomicity_no_partial(tmp_path):
    """tmp dirs never count as checkpoints."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "tmp.5.123", exist_ok=True)
    os.makedirs(tmp_path / "step_0000000007", exist_ok=True)  # no manifest: incomplete
    assert mgr.latest_step() is None


def test_async_save_copies_to_the_host_first(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    t = torch.ones(1000)
    mgr.save(1, {"t": t})
    t.zero_()  # the caller goes on updating its tensors
    mgr.wait()
    _, restored, _ = mgr.restore_latest({"t": torch.zeros(1000)})
    assert bool((restored["t"] == 1).all())


def _mk_trainer(tmp_path, total_steps, **tc):
    cfg = get_arch("qwen3-0.6b").smoke()
    data = DataConfig(batch=4, seq_len=32, seed=0)
    tc = TrainConfig(lr=1e-3, warmup=2, total_steps=total_steps, **tc)
    tcfg = TrainerConfig(
        total_steps=total_steps, ckpt_every=4, ckpt_dir=str(tmp_path), keep=2, log_every=100
    )
    return Trainer(cfg, data, tc, tcfg, device="cpu")


@pytest.mark.parametrize("tc", [{}, {"compress_grads": True, "overlap_grads": True}],
                         ids=["plain", "compressed"])
def test_preempt_restart_bitwise_continuation(tmp_path, tc):
    _, state_full, losses_full = _mk_trainer(tmp_path / "full", 8, **tc).run(seed=0)
    step_a, _, losses_a = _mk_trainer(tmp_path / "pre", 8, **tc).run(seed=0, preempt_after=4)
    assert step_a == 4
    step_b, state_resumed, losses_b = _mk_trainer(tmp_path / "pre", 8, **tc).run(seed=0)
    assert step_b == 8
    assert losses_a + losses_b == losses_full
    leaves_full, _ = tree_flatten(state_full)
    leaves_resumed, _ = tree_flatten(state_resumed)
    for a, b in zip(leaves_full, leaves_resumed):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_training_reduces_loss(tmp_path):
    _, _, losses = _mk_trainer(tmp_path, 30).run(seed=1)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_straggler_watchdog_logs(tmp_path, caplog):
    t = _mk_trainer(tmp_path, 1)
    with caplog.at_level(logging.WARNING, logger="repro_torch.train"):
        for i in range(10):
            t._watchdog(i, 0.1)
        t._watchdog(10, 1.0)  # 10x the median -> straggler
    assert any("straggler" in r.message for r in caplog.records)


def test_train_step_microbatches_average_their_gradients():
    """Two microbatches of 2 rows: the loss is the mean of the two, the
    update that of the summed gradients over 2 (the reference's scan)."""
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke(), compute_dtype="float32")
    api = build_model(cfg, "cpu")
    tc = TrainConfig(lr=1e-3, warmup=1, total_steps=4)
    opt = make_optimizer(tc)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 24)))
    state = init_train_state(api, opt, 0)
    _, m2 = make_train_step(api, opt, dataclasses.replace(tc, microbatches=2))(
        state, {"tokens": tokens})
    halves = [api.loss(state["params"], {"tokens": tokens[i:i + 2]})[0] for i in (0, 2)]
    np.testing.assert_allclose(float(m2["loss"]), float(sum(halves)) / 2, rtol=1e-6)
    np.testing.assert_allclose(float(m2["ce"]), float(halves[1]), rtol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(api, opt, dataclasses.replace(tc, microbatches=3))(
            state, {"tokens": tokens})


# ----------------------------------------------------------------------
# the plain backward formulas of the kernels training runs through
# ----------------------------------------------------------------------


def _autograd(fwd, inputs, kw, seed):
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out = fwd(*leaves, **kw)
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(out.shape).astype(
        np.float32)).to(out.dtype)
    return g, torch.autograd.grad(out, leaves, g)


def _randn(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 7, 48), (33, 128), (4, 1024)])
def test_rmsnorm_plain_backward_is_autograd(shape):
    rng = np.random.default_rng(0)
    x, w = _randn(rng, shape), _randn(rng, shape[-1:], 0.1)
    g, (dx, dw) = _autograd(rmsnorm_ref, [x, w], {}, 1)
    rdx, rdw = rmsnorm_bwd_ref(g, x, w)
    torch.testing.assert_close(rdx, dx, **F32)
    torch.testing.assert_close(rdw, dw, **F32)


@pytest.mark.parametrize("act", ["silu", "geglu"])
def test_silu_mul_plain_backward_is_autograd(act):
    rng = np.random.default_rng(0)
    gate, up = _randn(rng, (4, 32, 64), 3.0), _randn(rng, (4, 32, 64))
    dh, (dg, du) = _autograd(lambda a, b: silu_mul_ref(a, b, act=act), [gate, up], {}, 1)
    rdg, rdu = silu_mul_bwd_ref(dh, gate, up, act=act)
    torch.testing.assert_close(rdg, dg, **F32)
    torch.testing.assert_close(rdu, du, **F32)


FA_BWD_CASES = [
    # (B, S, Skv, Hq, Hkv, D, causal, window, softcap): the reference's
    # kernel cases, GQA, and rows that see no key (S >= Skv + window)
    (1, 64, 64, 2, 2, 16, True, None, None),
    (2, 128, 128, 4, 2, 32, True, None, None),
    (1, 64, 64, 2, 1, 16, True, 32, None),
    (1, 64, 64, 2, 2, 16, True, None, 30.0),
    (2, 64, 64, 4, 4, 16, False, None, None),
    (1, 32, 128, 2, 2, 16, False, None, None),
    (1, 77, 90, 4, 1, 64, False, 50, 20.0),
    (1, 60, 20, 2, 1, 16, True, 10, None),
    (1, 60, 20, 2, 1, 16, False, 10, 5.0),
    # stablelm-3b's head dim 80: causal, and windowed and soft-capped with GQA
    (1, 48, 48, 2, 2, 80, True, None, None),
    (1, 40, 56, 4, 2, 80, True, 16, 30.0),
    # gemma2-2b's head dim 256 with its masks: causal, a window, softcap 50
    (1, 40, 40, 4, 2, 256, True, 16, 50.0),
]


@pytest.mark.parametrize("case", FA_BWD_CASES)
def test_attention_plain_backward_is_autograd(case):
    B, S, Skv, Hq, Hkv, D, causal, window, softcap = case
    rng = np.random.default_rng(0)
    q, k, v = _randn(rng, (B, S, Hq, D)), _randn(rng, (B, Skv, Hkv, D)), _randn(
        rng, (B, Skv, Hkv, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    dout, grads = _autograd(attention_ref, [q, k, v], kw, 1)
    for ref, got in zip(attention_bwd_ref(q, k, v, dout, **kw), grads):
        torch.testing.assert_close(ref, got, **F32)


MOE_BWD_CASES = [
    # (E, C, D, F): the reference's kernel cases, and ragged rows and widths
    (4, 32, 64, 128),
    (2, 64, 32, 64),
    (8, 16, 48, 96),
    (3, 20, 36, 44),
]


def _moe_operands(rng, E, C, D, F):
    """x, the three expert weights and the output gradient, as f32 numpy."""
    shapes = [(E, C, D), (E, D, F), (E, D, F), (E, F, D), (E, C, D)]
    scales = [0.5, 0.1, 0.1, 0.1, 1.0]
    return [(s * rng.standard_normal(shape)).astype(np.float32) for s, shape in zip(scales, shapes)]


@pytest.mark.parametrize("case", MOE_BWD_CASES)
def test_fused_moe_plain_backward_is_autograd(case):
    """``fused_moe_bwd_ref``'s formulas equal autograd of ``fused_moe_ref``."""
    *ins, dy = (torch.from_numpy(a) for a in _moe_operands(np.random.default_rng(0), *case))
    leaves = [t.clone().requires_grad_(True) for t in ins]
    grads = torch.autograd.grad(fused_moe_ref(*leaves), leaves, dy)
    for ref, got in zip(fused_moe_bwd_ref(*ins, dy), grads):
        torch.testing.assert_close(ref, got, **F32)


@pytest.mark.parametrize("case", MOE_BWD_CASES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_fused_moe_plain_backward_matches_jax_grad(case, name):
    """``fused_moe_bwd_ref`` against ``jax.vjp`` of the reference's
    ``repro.kernels.fused_moe.ref.fused_moe_ref`` on the same inputs, in
    both types: f32 2e-5, bf16 2e-2 (the reference's kernel tolerances)."""
    from repro.kernels.fused_moe.ref import fused_moe_ref as ref_fused_moe_ref

    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[name]
    arrays = _moe_operands(np.random.default_rng(1), *case)
    *jins, jdy = (jnp.asarray(a).astype(jdt) for a in arrays)
    _, vjp = jax.vjp(ref_fused_moe_ref, *jins)
    want = vjp(jdy)
    got = fused_moe_bwd_ref(*(torch.from_numpy(a).to(tdt) for a in arrays))
    tol = F32 if name == "float32" else dict(rtol=2e-2, atol=2e-2)
    for w, g in zip(want, got):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **tol)
