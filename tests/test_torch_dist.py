"""The port's executed sharding on the CPU: gloo process groups of 2, 4 and
8 ranks (``launch.mesh.spawn``, meeting through a ``FileStore`` in pytest's
``tmp_path``), held against the reference's single-device results and
against the port's own meshless runs (``tests/test_dist.py``'s cases; the
reference's sharded runs fail under this container's jax, so its
single-device results are the yardstick).

This file holds the pipeline schedules, the bucketed EF all-reduce and
the helpers that the other ``test_torch_dist_*.py`` files share (the
(2, 2) models' losses in ``_models``, the train step and checkpoints in
``_step``, the ``constrain`` sites in ``_sites``, the launcher on a mesh
and its elastic restore in ``_launch``, the engines in ``_serve``): a
spawned group or two a file, so that ``--dist loadfile`` spreads them over
workers.

Each spawned group runs several checks and returns numpy results; the
tests read them. Worker functions live at module level (a spawned rank
imports its module by name) and import neither jax nor ``repro``.
Tolerances: the reference's model-loss rtol 2e-3 (bf16 compute) against
JAX, f32 2e-5 against the port's meshless run, and bit-equality where the
reference asks for it (the bucketed EF transport).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn

F32 = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL = 2e-3
MESH = ((2, 2), ("data", "model"))


def _cfg(arch, dtype="float32", **kw):
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(arch).smoke(), compute_dtype=dtype)
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _batch(cfg, B=4, S=32, seed=0):
    return {"tokens": np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ----------------------------------------------------------------------
# what a placed tree holds on each rank
# ----------------------------------------------------------------------


def _spec_divisors(spec, sizes):
    """Per dim, the product of the mesh axes its spec entry names."""
    out = []
    for e in spec:
        axes = () if e is None else (e,) if isinstance(e, str) else e
        out.append(int(np.prod([sizes[a] for a in axes])) if axes else 1)
    return out


def _local_shapes(tree, specs, sizes):
    """``(leaves sharded on "model", on "data", mismatches)``: each placed
    leaf's local shape against its global shape divided by its spec's axes."""
    from repro_torch.optim.adamw import tree_leaves

    model = data = 0
    bad = []
    for leaf, spec in zip(tree_leaves(tree), tree_leaves_specs(specs)):
        div = _spec_divisors(spec, sizes)
        want = tuple(n // d for n, d in zip(leaf.shape, div))
        if tuple(leaf.to_local().shape) != want:
            bad.append((tuple(leaf.shape), tuple(spec), tuple(leaf.to_local().shape)))
        names = {a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)}
        model += "model" in names
        data += "data" in names
    return model, data, bad


def tree_leaves_specs(specs):
    from repro_torch.dist.sharding import PartitionSpec

    out = []

    def walk(node):
        if isinstance(node, PartitionSpec):
            out.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(specs)
    return out


def _restored_summary(step, state, mesh, sizes):
    """What a restore onto ``mesh`` gave: the step, whether every tensor leaf
    is a DTensor placed by ``train_state_pspecs``, the local-shape check,
    and the first parameter leaf's whole value."""
    from repro_torch.dist.sharding import param_pspecs, to_named
    from repro_torch.optim.adamw import tree_leaves

    specs = param_pspecs(state["params"], mesh)
    want = [tuple(p) for p in tree_leaves_placements(to_named(specs, mesh))]
    got = [tuple(p.placements) for p in tree_leaves(state["params"])]
    _, _, bad = _local_shapes(state["params"], specs, sizes)
    first = tree_leaves(state["params"])[0].full_tensor().float().numpy()
    return {"step": step, "placed": got == want and len(got) > 0, "bad_shapes": bad,
            "mu_dtensor": all(type(m).__name__ == "DTensor" for m in tree_leaves(state["opt"].mu)),
            "first": first, "opt_step": state["opt"].step}


def tree_leaves_placements(named):
    out = []

    def walk(node):
        if isinstance(node, tuple) and node and not isinstance(node[0], (tuple, list, dict)):
            out.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(named)
    return out


# ----------------------------------------------------------------------
# spawned ranks: pipeline schedules on a 4-rank "pipe" mesh
# ----------------------------------------------------------------------

# (schedule, n_layers, microbatches, interleave): tests/test_dist.py's cases
PIPE_CASES = [("gpipe", 8, 4, 1), ("gpipe", 8, 6, 1)] + [
    (s, L, M, V) for s in ("1f1b", "zb-h1") for L, M, V in ((16, 8, 2), (16, 6, 2), (8, 1, 2))
] + [("zb-h1", 8, 4, 1)]


def _pipe_inputs(L, M, seed=0):
    rng = np.random.default_rng([seed, L, M])
    return (0.3 * rng.standard_normal((L, 16, 16))).astype(np.float32), \
        rng.standard_normal((M, 2, 16)).astype(np.float32)


def _pipeline_rank(rank):
    from repro_torch.dist.pipeline import pipeline_forward, schedule_ticks
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((4,), ("pipe",), device_type="cpu")
    out = {}
    for sched, L, M, V in PIPE_CASES:
        w, x = (torch.from_numpy(a) for a in _pipe_inputs(L, M))
        kw = dict(schedule=sched, interleave=V)
        full = pipeline_forward(lambda lp, h: torch.tanh(h @ lp["w"]), {"w": w}, x, mesh, **kw)
        short = pipeline_forward(lambda lp, h: torch.tanh(h @ lp["w"]), {"w": w}, x, mesh,
                                 ticks=schedule_ticks(4, M, sched, V) - 1, **kw)
        out[(sched, L, M, V)] = (full.numpy(), short.numpy())
    return out


@pytest.fixture(scope="module")
def pipelined(tmp_path_factory):
    return spawn(_pipeline_rank, 4, store_path=str(tmp_path_factory.mktemp("pipe") / "store"),
                 timeout=300)


def _jax_sequential(w, x):
    import jax
    import jax.numpy as jnp
    from jax import lax

    def seq(xx):
        return lax.scan(lambda c, lw: (jnp.tanh(c @ lw), None), xx, jnp.asarray(w))[0]

    return np.asarray(jax.vmap(seq)(jnp.asarray(x)))


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "zb-h1"])
def test_pipeline_schedule_matches_sequential_at_exact_tick_count(pipelined, schedule):
    """``tests/test_dist.py:155``/``:182``/``:228``: each executed schedule
    on 4 ranks equals the layers scanned in JAX within 2e-5, on every rank;
    run one tick short of ``schedule_ticks`` it does not."""
    cases = [c for c in PIPE_CASES if c[0] == schedule]
    assert cases
    for case in cases:
        ref = _jax_sequential(*_pipe_inputs(*case[1:3]))
        for r in pipelined:
            full, short = r[case]
            np.testing.assert_allclose(full, ref, **F32)
            assert not np.allclose(short, ref, **F32), case


# ----------------------------------------------------------------------
# spawned ranks: the bucketed error-feedback all-reduce on 8 ranks
# ----------------------------------------------------------------------


def _ef_rank(rank):
    import torch.distributed as dist

    from repro_torch.dist.collectives import (
        ef_compress_grads,
        ef_compress_grads_bucketed,
        group_all_reduce,
    )

    rng = np.random.default_rng(0)
    full = {"w1": rng.standard_normal((8, 64, 16)), "w2": rng.standard_normal((8, 33)),
            "w3": rng.standard_normal((8, 5, 3))}
    grads = {k: torch.tensor(v[rank], dtype=torch.float32) for k, v in full.items()}
    db, eb, ledger = ef_compress_grads_bucketed(grads, None, bucket_bytes=600,
                                                all_reduce=group_all_reduce())
    ds, es = ef_compress_grads(grads, None)
    for v in ds.values():
        dist.all_reduce(v)
    as_np = lambda t: {k: v.numpy() for k, v in t.items()}  # noqa: E731
    return as_np(db), as_np(eb), as_np(ds), as_np(es), len(ledger)


def test_bucketed_ef_allreduce_over_a_process_group_matches_sync(tmp_path):
    """``tests/test_dist.py:265``: bucketed EF with one launch group a bucket
    over 8 gloo ranks equals compress-then-all-reduce bit for bit, and
    every rank's reduced gradient is the same."""
    results = spawn(_ef_rank, 8, store_path=str(tmp_path / "store"), timeout=300)
    for db, eb, ds, es, n_buckets in results:
        assert n_buckets > 1
        for k in ds:
            np.testing.assert_array_equal(db[k], ds[k])
            np.testing.assert_array_equal(eb[k], es[k])
            np.testing.assert_array_equal(db[k], results[0][0][k])
