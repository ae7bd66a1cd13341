"""Flash attention on a block of the query rows, on the CPU.

- ``q_offset`` on the port's plain forward and backward (``ref.py``, and
  ``ops.attention`` on CPU tensors): a block of rows at an offset gives the
  rows of the reference's full-length attention (``repro``'s JAX
  ``flash_attention_ref``), its output and, through ``jax.vjp`` with the
  output gradient zero outside the block, its dQ rows and its dK and dV;
  f32 2e-5 (the reference's kernel tolerance).
- ``ops.row_split``: where a mesh dim divides neither head count, its ranks
  split the KV heads and the query rows (on a fake process group).
- The wgmma backward engine's geometry (``kernel.bwd_wgmma_plan``) and the
  engine choice (``kernel.bwd_engine``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

F32 = dict(rtol=2e-5, atol=2e-5)

#: (B, rows, offset, Skv, Hq, Hkv, D, causal, window, softcap)
OFFSET_CASES = [
    (2, 16, 16, 48, 4, 2, 16, True, None, None),       # causal, GQA
    (1, 24, 8, 40, 2, 1, 32, True, 16, None),          # a window
    (1, 16, 32, 48, 4, 4, 16, True, 12, 30.0),         # a window and a softcap
    (2, 16, 8, 32, 4, 2, 16, False, 8, None),          # a window, not causal
    (1, 16, 24, 24, 2, 1, 16, True, 8, None),          # rows 31.. see no key
    (1, 16, 40, 24, 2, 1, 16, True, 8, 50.0),          # past Skv + window: none sees one
    (1, 20, 0, 20, 2, 2, 16, True, None, 50.0),        # no offset
]


def _jax_attention(q, k, v, causal, window, softcap):
    """The reference's kernel-layout oracle on the model layout, as the
    port's ``attention_ref`` transposes."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, S, Hkv, G, D).transpose(0, 2, 3, 1, 4).reshape(B * Hkv * G, S, D)
    kf, vf = (t.transpose(0, 2, 1, 3).reshape(B * Hkv, -1, D) for t in (k, v))
    of = jax_ref(qf, kf, vf, group=G, causal=causal, window=window, softcap=softcap)
    return of.reshape(B, Hkv, G, S, D).transpose(0, 3, 1, 2, 4).reshape(B, S, Hq, D)


def _inputs(case, seed=0):
    B, rows, off, Skv, Hq, Hkv, D, *_ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, off + rows, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32) for _ in range(2))
    g = np.zeros_like(q)  # the output gradient: zero outside the block
    g[:, off:] = rng.standard_normal((B, rows, Hq, D))
    return q, k, v, g


@pytest.mark.parametrize("case", OFFSET_CASES)
def test_offset_rows_are_the_full_attention_rows(case):
    """The block's output (``attention_ref``, ``ops.attention``) equals the
    reference's full-length output at those rows."""
    _, rows, off, *_, causal, window, softcap = case
    q, k, v, _ = _inputs(case)
    want = np.asarray(_jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                     window, softcap))[:, off:]
    qb, kt, vt = (torch.from_numpy(t) for t in (q[:, off:], k, v))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    np.testing.assert_allclose(attention_ref(qb, kt, vt, **kw).numpy(), want, **F32)
    np.testing.assert_allclose(fa_ops.attention(qb, kt, vt, **kw).numpy(), want, **F32)


@pytest.mark.parametrize("case", OFFSET_CASES)
def test_offset_gradients_are_the_full_attention_gradients(case):
    """The block's dQ is the reference's at those rows, and its dK and dV
    the reference's for an output gradient zero outside the block: through
    the explicit formula (``attention_bwd_ref``) and through autograd of
    the plain forward (what ``ops.attention`` trains on the CPU)."""
    _, rows, off, *_, causal, window, softcap = case
    q, k, v, g = _inputs(case)
    _, vjp = jax.vjp(lambda *a: _jax_attention(*a, causal, window, softcap),
                     *(jnp.asarray(t) for t in (q, k, v)))
    dq, dk, dv = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    want = (dq[:, off:], dk, dv)
    qb, kt, vt, gb = (torch.from_numpy(t) for t in (q[:, off:], k, v, g[:, off:]))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    explicit = attention_bwd_ref(qb, kt, vt, gb, **kw)
    leaves = [t.clone().requires_grad_() for t in (qb, kt, vt)]
    auto = torch.autograd.grad(fa_ops.attention(*leaves, **kw), leaves, gb)
    for got in (explicit, auto):
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.numpy(), w, **F32, err_msg=name)


def test_offset_zero_is_the_reference_function():
    """``q_offset=0`` is the function without the argument, bit for bit."""
    case = OFFSET_CASES[-1]
    q, k, v, g = (torch.from_numpy(t) for t in _inputs(case))
    kw = dict(causal=True, window=None, softcap=50.0)
    assert torch.equal(attention_ref(q, k, v, **kw), attention_ref(q, k, v, q_offset=0, **kw))
    for a, b in zip(attention_bwd_ref(q, k, v, g, **kw),
                    attention_bwd_ref(q, k, v, g, q_offset=0, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mesh_shape,heads,S,want", [
    ((1, 8), (4, 2), 64, (1, 2, 4)),    # gemma2-2b's smoke config: 2 KV heads x 4 row blocks
    ((16, 16), (8, 4), 4096, (1, 4, 4)),  # gemma2-2b on the production mesh
    ((2, 2), (4, 2), 64, None),         # the heads divide the model axis: they shard there
    ((1, 8), (2, 1), 12, None),         # 8 ranks: no KV head split, 12 rows do not divide
    ((1, 8), (3, 1), 64, (1, 1, 8)),    # one KV head: the rows alone
    ((1, 4), (6, 2), 64, (1, 2, 2)),    # 4 = 2 x 2
])
def test_row_split_factors_the_mesh_dim(mesh_shape, heads, S, want):
    """``row_split`` picks the innermost mesh dim that replicates attention
    and divides neither head count, with the most KV head groups whose
    rows still divide."""
    from repro_torch.launch.mesh import fake_process_group, make_mesh

    Hq, Hkv = heads
    with fake_process_group(math.prod(mesh_shape)):
        mesh = make_mesh(mesh_shape, ("data", "model"), device_type="cpu")
        rep = [Replicate()] * 2
        q = DTensor.from_local(torch.zeros(1, S, Hq, 8), mesh, rep, run_check=False)
        k = DTensor.from_local(torch.zeros(1, S, Hkv, 8), mesh, rep, run_check=False)
        pl = fa_ops.head_placements(q, k)
        assert fa_ops.row_split(q, k, pl) == want
        # a mesh dim that already shards the heads leaves the others alone
        if Hq % mesh_shape[1] == 0 and Hkv % mesh_shape[1] == 0:
            assert fa_ops.row_split(q, k, (Replicate(), Shard(2))) is None


WGMMA_SHAPES = [(1, 4096, 4096, 8, 4), (2, 130, 130, 4, 2), (1, 200, 50, 2, 1), (3, 64, 64, 2, 2),
                (1, 1, 300, 2, 1), (4, 2048, 2048, 16, 8), (1, 2048, 2048, 48, 8),
                (2, 1000, 1000, 12, 2)]


@pytest.mark.parametrize("D", fa_kernel.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("shape", WGMMA_SHAPES)
def test_wgmma_plan_covers_every_block_once(shape, D):
    """dQ (which writes Delta) launches first, then dK/dV; each grid takes
    every q block (128 rows) or key block (64 keys at D 256, 128 at D 64,
    80 and 128) of every head exactly once, dQ's heaviest causal block first, a ragged
    last block last. Shapes: gemma2-2b's, qwen3-0.6b's and dbrx-132b's
    training, ragged S, S != Skv, groups of 1 to 6."""
    B, S, Skv, Hq, Hkv = shape
    dq, dkdv = fa_kernel.bwd_wgmma_plan(B, S, Skv, Hq, Hkv, D)
    assert (dq.name, dkdv.name) == ("dq", "dkdv")
    assert (dq.rows, dkdv.rows) == (128, 64 if D == 256 else 128)
    for kern, heads, length in ((dq, Hq, S), (dkdv, Hkv, Skv)):
        n = kern.grid[1]
        assert kern.grid[0] == B * heads and sorted(kern.order) == list(range(n))
        assert (n - 1) * kern.rows < length <= n * kern.rows
    n = dq.grid[1]
    if S % dq.rows:
        assert dq.order[-1] == n - 1 and dq.order[:-1] == tuple(range(n - 2, -1, -1))
    else:
        assert dq.order == tuple(range(n - 1, -1, -1))
    assert dkdv.order == tuple(range(dkdv.grid[1]))


#: per head dim, at (B1 S4096 8/4) and (B4 S2048 16/8): the dQ and dK/dV
#: launches' (rows, step, ring slots), their grids, and their shared bytes
#: as the source lays them out
WGMMA_GEOMETRY = {
    256: dict(dq=(128, 64, (2, 1)), dkdv=(64, 64, (2,)), grids=((8, 32), (4, 64)),
              grids_qwen3=((64, 16), (32, 32)),
              # Q, dO of two consumers (32 KB a 64 x 256 tile), K 2 slots, V 1,
              # 1 + 2 x 2 + 2 x 1 barriers
              dq_smem=1024 + 4 * 32768 + 3 * 32768 + 8 * 7,
              # K, V, a 2-stage q/dO ring, P^T and dS^T twice (8 KB each), 5 barriers
              dkdv_smem=1024 + 2 * 32768 + 4 * 32768 + 4 * 8192 + 8 * 5),
    128: dict(dq=(128, 64, (3, 2)), dkdv=(128, 64, (3,)), grids=((8, 32), (4, 32)),
              grids_qwen3=((64, 16), (32, 16)),
              # Q, dO of two consumers (16 KB a 64 x 128 tile), K 3 slots, V 2,
              # 1 + 2 x 3 + 2 x 2 barriers
              dq_smem=1024 + 4 * 16384 + 5 * 16384 + 8 * 11,
              # K and V of two consumers, a 3-stage q/dO ring, each stage's lse
              # and Delta (64 f32 each), 7 barriers
              dkdv_smem=1024 + 4 * 16384 + 6 * 16384 + 3 * 2 * 64 * 4 + 8 * 7),
    # D 80: a row in two boxes of 64 columns (the second's last 48 TMA's
    # zeros), so a 64-row tile takes 16 KB and the bytes are D 128's
    80: dict(dq=(128, 64, (3, 2)), dkdv=(128, 64, (3,)), grids=((8, 32), (4, 32)),
             grids_qwen3=((64, 16), (32, 16)),
             dq_smem=1024 + 4 * 16384 + 5 * 16384 + 8 * 11,
             dkdv_smem=1024 + 4 * 16384 + 6 * 16384 + 3 * 2 * 64 * 4 + 8 * 7),
    # D 64: one box a row, 8 KB a 64-row tile
    64: dict(dq=(128, 64, (3, 2)), dkdv=(128, 64, (3,)), grids=((8, 32), (4, 32)),
             grids_qwen3=((64, 16), (32, 16)),
             dq_smem=1024 + 4 * 8192 + 5 * 8192 + 8 * 11,
             dkdv_smem=1024 + 4 * 8192 + 6 * 8192 + 3 * 2 * 64 * 4 + 8 * 7),
}


@pytest.mark.parametrize("D", fa_kernel.WGMMA_HEAD_DIMS)
def test_wgmma_plan_tiles_rings_and_shared_bytes(D):
    """Two consumer warpgroups a CTA, 64 rows each. dQ: 128 q rows, steps
    of 64 keys through K and V rings (D 256: 2 and 1 slots; D 64, 80 and
    128: 3 and 2). dK/dV: steps of 64 q rows through a ring (D 256: 64 keys
    a CTA, 2 stages, P^T and dS^T for even and odd steps; D 64, 80 and 128:
    128 keys a CTA, 3 stages, each with its lse and Delta). All within the
    232448 shared bytes a CTA may take: 1 KB alignment slack, a 64-row tile
    in boxes of 64 columns (8 KB a box), 8 bytes a barrier. Any other head
    dim, a group that does not divide or an empty batch raises."""
    want = WGMMA_GEOMETRY[D]
    dq, dkdv = fa_kernel.bwd_wgmma_plan(1, 4096, 4096, 8, 4, D)
    assert (dq.rows, dq.step, dq.stages, dq.warpgroups) == (*want["dq"], 2)
    assert (dkdv.rows, dkdv.step, dkdv.stages, dkdv.warpgroups) == (*want["dkdv"], 2)
    assert (dq.grid, dkdv.grid) == want["grids"]
    assert (dq.smem, dkdv.smem) == (want["dq_smem"], want["dkdv_smem"])
    qwen3 = fa_kernel.bwd_wgmma_plan(4, 2048, 2048, 16, 8, D)
    assert tuple(k.grid for k in qwen3) == want["grids_qwen3"]
    assert tuple(k.smem for k in qwen3) == (dq.smem, dkdv.smem)
    assert max(dq.smem, dkdv.smem) <= fa_kernel.SMEM_LIMIT == 232448
    for bad in ((1, 64, 64, 2, 2, 32), (1, 64, 64, 2, 2, 48), (1, 64, 64, 3, 2, D),
                (0, 64, 64, 2, 2, D)):
        with pytest.raises(ValueError):
            fa_kernel.bwd_wgmma_plan(*bad)


def test_bwd_engine_follows_type_head_dim_and_bases():
    """The wgmma engine takes bf16 at head dims 64, 80, 128 and 256 with
    16-byte bases (TMA's rule), the 3xTF32 engine f32 at 80 and 128; f32 at
    64 and 256, head dims 8-32 and an unaligned base stay on the mma.sync
    engine."""
    engine = fa_kernel.bwd_engine
    for D in (64, 80, 128, 256):
        assert engine(torch.bfloat16, D) == "wgmma"
        assert engine(torch.bfloat16, D, aligned=False) == "mma_sync"
        assert engine(torch.float32, D) == ("tf32" if D in (80, 128) else "mma_sync")
        assert engine(torch.float32, D, aligned=False) == "mma_sync"
    for D in set(fa_kernel.BWD_HEAD_DIMS) - {64, 80, 128, 256}:
        assert engine(torch.bfloat16, D) == "mma_sync"
        assert engine(torch.float32, D) == "mma_sync"
