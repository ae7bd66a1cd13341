"""The port's Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device each test skips with its reason. On a
machine with one (no JAX needed; where one is installed, ``JAX_PLATFORMS=cpu``
keeps ``tests/conftest.py``'s import-time probe off the card):

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are the reference's kernel tolerances: f32 2e-5, bf16 2e-2
(``tests/test_kernels.py::_tol``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fused_moe import kernel as moe_kernel
from repro_torch.kernels.fused_moe import ops as moe_ops
from repro_torch.kernels.scaled_mm import kernel as smm_kernel
from repro_torch.kernels.scaled_mm import ops as smm_ops
from repro_torch.kernels.scaled_mm.ref import scaled_mm_acc_ref
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.silu_mul import kernel as silu_kernel
from repro_torch.kernels.silu_mul import ops as silu_ops

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev, scale=1.0):
    return torch.from_numpy(scale * rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


def _close(out, ref, dtype):
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


FA_CASES = [
    # (B, S, Skv, Hq, Hkv, D, causal, window, softcap): the reference's cases
    (1, 64, 64, 2, 2, 16, True, None, None),
    (2, 128, 128, 4, 2, 32, True, None, None),
    (1, 64, 64, 2, 1, 16, True, 32, None),
    (1, 64, 64, 2, 2, 16, True, None, 30.0),
    (2, 64, 64, 4, 4, 16, False, None, None),
    (1, 32, 128, 2, 2, 16, False, None, None),
    # ragged lengths, head dims of the model zoo
    (2, 100, 100, 4, 2, 128, True, None, None),
    (1, 1000, 1000, 16, 8, 128, True, None, None),
    (1, 77, 200, 2, 1, 64, False, 50, 20.0),
    (1, 40, 40, 2, 2, 8, True, None, None),
    (1, 130, 130, 2, 1, 256, True, 64, 50.0),
    # rows q >= Skv + window - 1 see no key: they average v over every key
    (1, 200, 50, 2, 1, 64, False, 10, None),
    (1, 200, 50, 2, 1, 64, True, 10, None),
    # the remaining families' prefill shapes: gemma2-2b (a window of 4096
    # that cuts keys, softcap 50, head dim 256), whisper-base's encoder and
    # cross attention (ragged 1500-frame source, one query row at decode),
    # llama-3.2-vision's cross attention (1601 patches), stablelm-3b's head
    # dim 80 (causal, and windowed with a ragged length)
    (1, 4608, 4608, 8, 4, 256, True, 4096, 50.0),
    (1, 1500, 1500, 8, 8, 64, False, None, None),
    (1, 64, 1500, 8, 8, 64, False, None, None),
    (1, 1, 1500, 8, 8, 64, False, None, None),
    (1, 512, 1601, 32, 8, 128, False, None, None),
    (1, 2048, 2048, 32, 32, 80, True, None, None),
    (2, 300, 300, 4, 2, 80, True, 100, 30.0),
]


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, case, dtype):
    """The call runs on the engine ``fwd_engine`` picks (``FWD_COUNTS``),
    and only that engine's count moves. f32 is held to the kernels' function in float64
    (``_attention_f64``) at the reference's 2e-5: the plain version's own
    f32 products on the card host's CPU have landed 4.27e-5 from it on case
    0, so at f32's tolerance it is no yardstick (``test_torch_kernels.py::
    test_flash_attention_plain_version_stays_near_float64`` holds it near
    float64 on its own tolerance). bf16 is held to the plain version at
    2e-2."""
    B, S, Skv, Hq, Hkv, D, causal, window, softcap = case
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, S, Hq, D), dtype, dev)
    k = _randn(rng, (B, Skv, Hkv, D), dtype, dev)
    v = _randn(rng, (B, Skv, Hkv, D), dtype, dev)
    kw = dict(causal=causal, window=window, softcap=softcap)
    engine = fa_kernel.fwd_engine(dtype, D)
    n0 = _counts(FWD_COUNTS)
    out = fa_ops.attention(q, k, v, **kw)
    assert _counts(FWD_COUNTS) == {e: n + (e == engine) for e, n in n0.items()}
    torch.cuda.synchronize()
    if dtype == torch.float32:
        exact = _attention_f64(q, k, v, **kw)  # float64 on the card: no TF32 there
        assert out.shape == exact.shape and out.dtype == dtype
        err = float((out.double() - exact).abs().max())
        assert torch.allclose(out.double(), exact, rtol=TOL[dtype], atol=TOL[dtype]), (
            f"kernel {err:.3g} from the float64 function")
        return
    ref = fa_ops.attention(q.cpu(), k.cpu(), v.cpu(), **kw)
    out = out.cpu()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


#: each engine's count of calls: the forward's and the backward's
FWD_COUNTS = {"wgmma": "wgmma_launches", "tf32": "tf32_launches", "mma_sync": "launches"}
BWD_COUNTS = {"wgmma": "bwd_wgmma_launches", "tf32": "bwd_tf32_launches",
              "mma_sync": "bwd_launches"}


def _counts(names):
    """Each engine's count now, by engine."""
    return {e: getattr(fa_kernel, a) for e, a in names.items()}


def _attention_f64(q, k, v, *, causal, window, softcap):
    """The kernels' function in float64 on q's device (the model layout)."""
    q, k, v = (t.double() for t in (q, k, v))
    G = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    p = torch.softmax(s.masked_fill(~mask, -1.0e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


#: (B, S, Skv, Hq, Hkv, D, causal, window, softcap, q_offset) for the
#: forward's wgmma engine: FA_CASES at head dims 64, 128 and 256 (whisper-
#: base's encoder, cross attention and one-row decode among them), then GQA
#: with ragged lengths, a window whose last rows see no key (S != Skv), a
#: softcap with more keys than rows, query offsets (a rank's block of rows),
#: the serving path's main shape, the same at head dim 80 with stablelm-3b's
#: prefill, and at head dim 64 with hymba-1.5b's global layer (25/5 heads)
FWD_WGMMA_CASES = [(*c, 0) for c in FA_CASES if c[5] in (64, 128, 256)] + [
    (2, 300, 300, 8, 2, 128, True, None, None, 0),
    (2, 300, 300, 8, 2, 256, True, None, None, 0),
    (1, 200, 50, 2, 1, 128, False, 10, None, 0),
    (1, 200, 50, 2, 1, 256, True, 10, None, 0),
    (1, 77, 200, 4, 1, 128, False, 50, 20.0, 0),
    (1, 77, 200, 4, 1, 256, False, 50, 20.0, 0),
    (1, 64, 192, 4, 2, 128, True, None, None, 64),
    (1, 64, 96, 2, 1, 256, True, 32, 50.0, 100),
    (1, 130, 200, 2, 1, 256, False, 64, None, 40),
    (1, 1024, 4096, 8, 4, 256, True, 4096, 50.0, 3072),
    (4, 2048, 2048, 16, 8, 128, True, None, None, 0),
    (1, 64, 64, 2, 2, 80, True, None, None, 0),
    (2, 300, 300, 8, 2, 80, True, None, None, 0),
    (1, 200, 50, 2, 1, 80, True, 10, None, 0),
    (1, 77, 200, 4, 1, 80, False, 50, 20.0, 0),
    (1, 64, 192, 4, 2, 80, True, None, None, 64),
    (1, 130, 200, 2, 1, 80, False, 64, None, 40),
    (1, 2048, 2048, 32, 32, 80, True, None, None, 0),
    (2, 300, 300, 8, 2, 64, True, None, None, 0),
    (1, 130, 130, 2, 1, 64, True, 64, 50.0, 0),
    (1, 64, 192, 4, 2, 64, True, None, None, 64),
    (1, 130, 200, 2, 1, 64, False, 64, None, 40),
    (1, 1528, 1528, 25, 5, 64, True, None, None, 0),
]


def _lse_close(got, want):
    """Where the plain lse is finite, within bf16's 2e-2; -inf (rows that
    see no key) at the same rows."""
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got)) and not bool(torch.isnan(got).any())
    assert float((got[fin] - want[fin]).abs().max()) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("case", FWD_WGMMA_CASES)
def test_flash_attention_fwd_wgmma_matches_plain_and_mma_sync(dev, case):
    """The forward's wgmma engine (``csrc/flash_attention_wgmma.cu``): its
    output within bf16 2e-2 of the plain version's max|ref| and of the
    mma.sync engine's on the same inputs, its lse within 2e-2 of
    ``lse_ref``'s; bit-equal on a rerun; ``flash_attention_cuda`` picks it
    and only its count moves; the library's shared bytes are the plan's."""
    from repro_torch.kernels.flash_attention.ref import attention_ref, lse_ref

    B, S, Skv, Hq, Hkv, D, causal, window, softcap, off = case
    bf16 = torch.bfloat16
    rng = np.random.default_rng(6)
    q = _randn(rng, (B, S, Hq, D), bf16, dev)
    k, v = (_randn(rng, (B, Skv, Hkv, D), bf16, dev) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    assert fa_kernel.fwd_engine(bf16, D) == "wgmma"
    n0, w0 = fa_kernel.launches, fa_kernel.wgmma_launches
    out, lse = fa_kernel.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    again, lse2 = fa_kernel.flash_attention_wgmma_cuda(q, k, v, return_lse=True, **kw)
    assert (fa_kernel.launches, fa_kernel.wgmma_launches) == (n0, w0 + 2)
    assert fa_kernel.last_grid == fa_kernel.launch_plan(B, S, Skv, Hq, Hkv, D).grid
    old = fa_kernel.flash_attention_mma_sync_cuda(q, k, v, **kw)
    assert out.dtype == bf16 and bool(torch.isfinite(out).all())
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    _rel_close(out, attention_ref(q, k, v, **kw), bf16, "out")
    _rel_close(out, old, bf16, "out against the mma.sync engine")
    _lse_close(lse, lse_ref(q, k, v, **kw))
    plan = fa_kernel.fwd_wgmma_plan(B, S, Skv, Hq, Hkv, D)
    assert fa_kernel.fwd_wgmma_library().fa_fwd_wgmma_smem_bytes(D) == plan.smem


@pytest.mark.parametrize("blocks", [(64, 32, 512), (512, 512, 512), (256, 96, 768),
                                    (128, 64, 512)], ids=lambda b: f"q{b[0]}-k{b[1]}-S{b[2]}")
@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_flash_attention_fwd_wgmma_blocks_reach_the_launch(dev, blocks, D):
    """block_q and block_k reach the wgmma engine's launch (the grid the
    reference names, at lengths the blocks divide; steps cut into tiles, a
    tile cut at its step's end) and leave its function unchanged."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    bq, bk, S = blocks
    B, Hq, Hkv = 2, 4, 2
    rng = np.random.default_rng(7)
    q = _randn(rng, (B, S, Hq, D), torch.bfloat16, dev)
    k, v = (_randn(rng, (B, S, Hkv, D), torch.bfloat16, dev) for _ in range(2))
    for kw in (dict(causal=True), dict(causal=True, window=100, softcap=30.0),
               dict(causal=False)):
        out = fa_kernel.flash_attention_wgmma_cuda(q, k, v, block_q=bq, block_k=bk, **kw)
        assert fa_kernel.last_grid == fa_ops.grid_shape(B, S, S, Hq, Hkv, D, block_q=bq,
                                                         block_k=bk)
        _rel_close(out, attention_ref(q, k, v, **kw), torch.bfloat16, f"out {kw}")


def test_flash_attention_fwd_wgmma_refuses_what_it_does_not_take(dev):
    """f32, head dims other than 64, 80, 128 and 256, and a base that is not
    a 16-byte multiple are not the wgmma engine's: it raises, and
    ``flash_attention_cuda`` takes the mma.sync engine for them (f32 at 256,
    and f32 at 128 off a 16-byte base)."""
    rng = np.random.default_rng(8)
    for dtype, D, shift in ((torch.float32, 128, 1), (torch.float32, 256, 0),
                            (torch.bfloat16, 32, 0), (torch.bfloat16, 128, 1),
                            (torch.bfloat16, 256, 4)):
        q = _randn(rng, (1, 64 * 2 * D + shift), dtype, dev)[:, shift:].view(1, 64, 2, D)
        k, v = (_randn(rng, (1, 64, 1, D), dtype, dev) for _ in range(2))
        assert fa_kernel.fwd_engine(dtype, D, q.data_ptr() % 16 == 0) == "mma_sync"
        with pytest.raises(ValueError, match="16-byte"):
            fa_kernel.flash_attention_wgmma_cuda(q, k, v)
        n0, w0 = fa_kernel.launches, fa_kernel.wgmma_launches
        out = fa_kernel.flash_attention_cuda(q, k, v)
        assert (fa_kernel.launches, fa_kernel.wgmma_launches) == (n0 + 1, w0)
        _close(out.cpu(), fa_ops.attention(q.cpu(), k.cpu(), v.cpu()), dtype)


@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_flash_attention_trains_through_the_wgmma_forward(dev, D):
    """``ops.attention`` under grad in bf16 at head dims 64, 80, 128 and
    256: the forward on the wgmma engine feeds its output and lse to the
    backward engine ``bwd_engine`` picks (the wgmma engine at each of these
    head dims), whose gradients equal
    ``attention_bwd_ref``'s within bf16 2e-2 of each gradient's max|ref|,
    with gemma2's masks at 256 and GQA at each."""
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

    bf16 = torch.bfloat16
    rng = np.random.default_rng(9)
    shapes = [(2, 300, 8, D), (2, 300, 2, D), (2, 300, 2, D)]
    card = [_randn(rng, sh, bf16, dev).requires_grad_() for sh in shapes]
    g = _randn(rng, shapes[0], bf16, dev)
    kw = dict(causal=True, window=64, softcap=50.0) if D == 256 else dict(causal=True)
    count = "bwd_wgmma_launches" if fa_kernel.bwd_engine(bf16, D) == "wgmma" else "bwd_launches"
    w0, b0 = fa_kernel.wgmma_launches, getattr(fa_kernel, count)
    out = fa_ops.attention(*card, **kw)
    got = torch.autograd.grad(out, card, g)
    assert (fa_kernel.wgmma_launches, getattr(fa_kernel, count)) == (w0 + 1, b0 + 1)
    plain = [t.detach() for t in card]
    _rel_close(out, attention_ref(*plain, **kw), bf16, "out")
    for name, a, r in zip(("dq", "dk", "dv"), got, attention_bwd_ref(*plain, g, **kw)):
        assert a.dtype == bf16
        _rel_close(a, r, bf16, name)


FA_BF16_HEAD_DIMS = [64, 80, 128, 256]


@pytest.mark.parametrize("D", FA_BF16_HEAD_DIMS)
def test_flash_attention_bf16_tensor_core_head_dims(dev, D):
    """The tensor-core path at the head dims of the model zoo, with a
    ragged length and GQA."""
    B, S, Hq, Hkv = 2, 300, 8, 2
    rng = np.random.default_rng(1)
    q = _randn(rng, (B, S, Hq, D), torch.bfloat16, dev)
    k, v = (_randn(rng, (B, S, Hkv, D), torch.bfloat16, dev) for _ in range(2))
    out = fa_ops.attention(q, k, v)
    assert fa_kernel.last_grid == (B * Hq, 3, 3)
    _close(out.cpu(), fa_ops.attention(q.cpu(), k.cpu(), v.cpu()), torch.bfloat16)


FA_BLOCK_CORNERS = [(32, 32), (32, 512), (512, 32), (512, 512), (128, 256)]


@pytest.mark.parametrize("blocks", FA_BLOCK_CORNERS, ids=lambda b: f"q{b[0]}-k{b[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_block_corners(dev, blocks, dtype):
    """Each (block_q, block_k) corner of the tuner's lattice launches the
    grid it names on the engine ``fwd_engine`` picks (f32 at head dim 64:
    the 3xTF32 engine, the tuner's own) and computes the same function:
    f32 within 2e-5 of float64, bf16 of the plain version."""
    bq, bk = blocks
    B, S, Hq, Hkv, D = 2, 512, 4, 2, 64
    rng = np.random.default_rng(2)
    q = _randn(rng, (B, S, Hq, D), dtype, dev)
    k, v = (_randn(rng, (B, S, Hkv, D), dtype, dev) for _ in range(2))
    engine = fa_kernel.fwd_engine(dtype, D)
    assert engine == ("tf32" if dtype == torch.float32 else "wgmma")
    for kw in (dict(causal=True), dict(causal=True, window=100), dict(causal=False)):
        n0 = _counts(FWD_COUNTS)
        out = fa_ops.attention(q, k, v, block_q=bq, block_k=bk, **kw)
        assert _counts(FWD_COUNTS) == {e: n + (e == engine) for e, n in n0.items()}
        assert fa_kernel.last_grid == fa_ops.grid_shape(B, S, S, Hq, Hkv, D, block_q=bq, block_k=bk)
        if dtype == torch.float32:
            exact = _attention_f64(q, k, v, **{"window": None, "softcap": None, **kw})
            assert torch.allclose(out.double(), exact, rtol=TOL[dtype], atol=TOL[dtype]), kw
        else:
            _close(out.cpu(), fa_ops.attention(q.cpu(), k.cpu(), v.cpu(), **kw), dtype)


@pytest.mark.parametrize("shape", [(4, 32, 64), (2, 7, 48), (128, 16), (300, 1024), (33, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_dtype", ["same", torch.float32])
def test_rmsnorm_kernel_matches_plain(dev, shape, dtype, w_dtype):
    rng = np.random.default_rng(4)
    x = _randn(rng, shape, dtype, dev)
    w = _randn(rng, shape[-1:], dtype if w_dtype == "same" else w_dtype, dev, 0.1)
    n0 = rms_kernel.launches
    out = rms_ops.rmsnorm(x, w, block_rows=8)
    assert rms_kernel.launches == n0 + 1
    _close(out.cpu(), rms_ops.rmsnorm(x.cpu(), w.cpu()), dtype)


@pytest.mark.parametrize("act", ["silu", "geglu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 32, 64), (5, 3072), (3, 7, 33)])
def test_silu_mul_kernel_matches_plain(dev, act, dtype, shape):
    rng = np.random.default_rng(5)
    g = _randn(rng, shape, dtype, dev, 3.0)
    u = _randn(rng, shape, dtype, dev)
    n0 = silu_kernel.launches
    out = silu_ops.act_mul(g, u, act=act)
    assert silu_kernel.launches == n0 + 1
    _close(out.cpu(), silu_ops.act_mul(g.cpu(), u.cpu(), act=act), dtype)


@pytest.mark.parametrize("block_rows", [32, 128, 512, 7])
def test_silu_mul_block_rows_reach_the_launch(dev, block_rows):
    R, d = 1024, 3072
    rng = np.random.default_rng(6)
    g, u = _randn(rng, (R, d), torch.bfloat16, dev, 3.0), _randn(rng, (R, d), torch.bfloat16, dev)
    out = silu_ops.act_mul(g, u, block_rows=block_rows)
    assert silu_kernel.last_grid == silu_ops.grid_shape(R, d, block_rows=block_rows)
    _close(out.cpu(), silu_ops.act_mul(g.cpu(), u.cpu()), torch.bfloat16)


MOE_CASES = [
    # (E, C, D, F, block_m, block_f): the reference's cases, the tuner's
    # default workload at lattice corners, and ragged sub-tiles
    (4, 32, 64, 128, 16, 64),
    (2, 64, 32, 64, 32, 32),
    (8, 16, 48, 96, 16, 96),
    (8, 512, 256, 512, 128, 256),
    (8, 512, 256, 512, 512, 512),
    (8, 512, 256, 512, 32, 32),
    (3, 100, 200, 300, 50, 150),
    # several row sub-blocks and F steps a CTA, at the lattice's corners
    (2, 1024, 384, 1024, 32, 32),
    (2, 1024, 384, 1024, 128, 256),
    (2, 1024, 384, 1024, 512, 512),
    # a model's decode ticks: capacities of 4 and 8 rows, below the 32-row
    # sub-tile (block_m clamps to C)
    (16, 4, 640, 1024, 128, 256),
    (16, 8, 640, 1024, 128, 256),
    (4, 4, 48, 96, 128, 256),
    (4, 8, 64, 96, 8, 32),
]


@pytest.mark.parametrize("case", MOE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_moe_kernel_matches_plain(dev, case, dtype):
    E, C, D, F, bm, bf = case
    rng = np.random.default_rng(3)
    x = _randn(rng, (E, C, D), dtype, dev, 0.5)
    wg, wu = _randn(rng, (E, D, F), dtype, dev, 0.1), _randn(rng, (E, D, F), dtype, dev, 0.1)
    wd = _randn(rng, (E, F, D), dtype, dev, 0.1)
    engine = moe_kernel.fwd_engine(dtype, C, D, F, block_f=bf)
    before = _moe_fwd_counts()
    out = moe_ops.fused_moe(x, wg, wu, wd, block_m=bm, block_f=bf)
    assert _moe_fwd_counts() == {e: n + (e == engine) for e, n in before.items()}
    assert moe_kernel.last_grid == moe_ops.grid_shape(E, C, D, F, block_m=bm, block_f=bf)
    ref = moe_ops.fused_moe(*(t.cpu() for t in (x, wg, wu, wd)))
    _close(out.cpu(), ref, dtype)


def _moe_fwd_counts():
    """Each fused MoE forward engine's count, by ``fwd_engine``'s name."""
    return {"wgmma": moe_kernel.wgmma_launches, "wgmma_tf32": moe_kernel.tf32_launches,
            "mma_sync": moe_kernel.launches}


SMM_CASES = [
    # (M, K, N, block_m, block_n, block_k)
    (64, 128, 96, 32, 32, 64),
    (128, 64, 128, 64, 64, 32),
    (1024, 512, 512, 128, 128, 256),
    (1024, 512, 512, 512, 512, 512),
    (1024, 512, 512, 32, 32, 32),
    (7, 100, 13, 3, 5, 7),
    # a long K at the default blocks (|acc| stays below 2**24)
    (256, 6144, 512, 128, 128, 256),
    # an unaligned N: rows staged byte by byte
    (64, 96, 50, 32, 25, 32),
    # a block that walks 16 tensor-core sub-tiles
    (1024, 512, 512, 512, 512, 64),
]


@pytest.mark.parametrize("case", SMM_CASES)
def test_scaled_mm_kernel_matches_plain(dev, case):
    """The int32 sum is exact (read through unit scales and an f32 output,
    exact below 2**24), and the bf16 output equals the plain version's."""
    M, K, N, bm, bn, bk = case
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8)).to(dev)
    w = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8)).to(dev)
    sx = torch.from_numpy(rng.uniform(0.5, 2.0, M).astype(np.float32)).to(dev)
    sw = torch.from_numpy(rng.uniform(0.5, 2.0, N).astype(np.float32)).to(dev)
    blocks = dict(block_m=bm, block_n=bn, block_k=bk)
    n0 = smm_kernel.launches
    out = smm_ops.scaled_mm(x, w, sx, sw, **blocks)
    assert smm_kernel.launches == n0 + 1
    assert smm_kernel.last_grid == smm_ops.grid_shape(M, K, N, **blocks)
    unit = smm_ops.scaled_mm(x, w, torch.ones_like(sx), torch.ones_like(sw),
                             out_dtype=torch.float32, **blocks)
    torch.cuda.synchronize()
    acc = scaled_mm_acc_ref(x.cpu(), w.cpu())
    assert int(acc.abs().max()) < 2**24
    assert torch.equal(unit.cpu(), acc.float())
    ref = smm_ops.scaled_mm(x.cpu(), w.cpu(), sx.cpu(), sw.cpu())
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=1e-2, atol=1e-2)


def test_scaled_mm_kernel_float16_output(dev):
    """An f16 output, scales small enough to keep it finite: within 1e-2 of
    the plain version, through one launch of the reference's grid."""
    M, K, N = 256, 512, 384
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8)).to(dev)
    w = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8)).to(dev)
    sx = torch.from_numpy(rng.uniform(0.5e-3, 2e-3, M).astype(np.float32)).to(dev)
    sw = torch.from_numpy(rng.uniform(0.5e-3, 2e-3, N).astype(np.float32)).to(dev)
    n0 = smm_kernel.launches
    out = smm_ops.scaled_mm(x, w, sx, sw, out_dtype=torch.float16)
    assert smm_kernel.launches == n0 + 1
    assert smm_kernel.last_grid == smm_ops.grid_shape(M, K, N)
    ref = smm_ops.scaled_mm(x.cpu(), w.cpu(), sx.cpu(), sw.cpu(), out_dtype=torch.float16)
    torch.cuda.synchronize()
    assert out.dtype == torch.float16 and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=1e-2, atol=1e-2)


def test_tuner_times_the_kernels_on_the_card(dev):
    """One small tune() per tunable kernel with a launch grid on the card:
    every measured config launched (1 + repeats) times with the grid its
    blocks give."""
    from repro_torch.core.hardware import REGISTRY
    from repro_torch.predict.backends import get_predictor
    from repro_torch.tune import measure, tune

    hw = REGISTRY["tpu-v4"]
    # each kernel's count of the engine the tuner's f32 inputs take (fused
    # MoE's and flash attention's: their 3xTF32 engines)
    for kernel, mod, count, ops, kw in [
        ("fused_moe", moe_kernel, "tf32_launches", moe_ops, {"E": 2, "C": 64, "D": 64, "F": 128}),
        ("scaled_mm", smm_kernel, "launches", smm_ops, {"M": 128, "K": 256, "N": 128}),
        ("flash_attention", fa_kernel, "tf32_launches", fa_ops,
         {"B": 1, "S": 256, "Skv": 256, "Hq": 4, "Hkv": 2, "D": 64}),
        ("silu_mul", silu_kernel, "launches", silu_ops, {"R": 512, "d": 256}),
    ]:
        grids = []

        def timed(kernel, kw, blocks, **k):
            s = measure(kernel, kw, blocks, **k)
            grids.append((mod.last_grid, ops.grid_shape(**kw, **blocks)))
            return s

        n0 = getattr(mod, count)
        report = tune(kernel, hw, workload=kw, predictor=get_predictor("roofline", hw),
                      top_k=3, repeats=2, measure_fn=timed)
        distinct = {tuple(sorted(c.blocks.items())) for c in report.measured}
        distinct.add(tuple(sorted(report.default_blocks.items())))
        assert getattr(mod, count) - n0 == 3 * len(distinct) == 3 * len(grids)
        assert all(a == b for a, b in grids)
        assert not report.interpret and report.t_default > 0


def test_kernels_reject_bad_inputs(dev):
    x = torch.zeros(4, 8, device=dev)
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(x, torch.zeros(7, device=dev))
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(x.t(), torch.zeros(4, device=dev))
    with pytest.raises(TypeError):
        silu_ops.act_mul(x, x.to(torch.bfloat16))
    q = torch.zeros(1, 8, 2, 24, device=dev)
    with pytest.raises(ValueError):
        fa_ops.attention(q, q, q)
    x = torch.zeros(2, 32, 16, device=dev)
    wg, wd = torch.zeros(2, 16, 64, device=dev), torch.zeros(2, 64, 16, device=dev)
    with pytest.raises(ValueError):
        moe_ops.fused_moe(x, wg, wg, wd, block_m=24)  # 24 does not divide C=32
    with pytest.raises(TypeError):
        moe_ops.fused_moe(x, wg.bfloat16(), wg, wd)
    a = torch.zeros(8, 16, dtype=torch.int8, device=dev)
    with pytest.raises(TypeError):
        smm_ops.scaled_mm(a.float(), a.t().contiguous(), torch.ones(8, device=dev),
                          torch.ones(8, device=dev))


def _moe_layer_pair(dev, dtype, tokens, seed):
    """The dbrx-132b smoke MoE layer's parameters and an input, on the card
    and on the CPU (the same values), in ``dtype``."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_arch("dbrx-132b").smoke(),
                              compute_dtype={torch.float32: "float32",
                                             torch.bfloat16: "bfloat16"}[dtype])
    p = T._cast(build_model(cfg, device="cpu").init(seed)["segments"][0][0]["moe"], dtype)
    x = _randn(np.random.default_rng(seed), (1, tokens, cfg.d_model), dtype, "cpu")
    return cfg, p, x, T.tree_map(lambda a: a.to(dev), p), x.to(dev)


@pytest.mark.parametrize("tokens", [67, 4, 96])
def test_moe_layer_on_the_card_matches_the_cpu(dev, tokens):
    """f32: a prime prefill (one-token groups, 134 rows an expert, padded
    to 256 for block_m = 128), a decode tick of 4 tokens (4 rows, block_m
    4) and a 96-token prefill (groups of 32)."""
    from repro_torch.models import moe as M

    cfg, p, x, p_dev, x_dev = _moe_layer_pair(dev, torch.float32, tokens, seed=5)
    G, _, C = M.dispatch_geometry(cfg, tokens, train=False)
    rows = G * C
    before = _moe_fwd_counts()
    with torch.no_grad():
        out, aux = M.moe_layer(p_dev, x_dev, cfg, train=False)
        ref, ref_aux = M.moe_layer(p, x, cfg, train=False)
    engine = moe_kernel.fwd_engine(torch.float32, rows, cfg.d_model, cfg.moe_hidden)
    assert _moe_fwd_counts() == {e: n + (e == engine) for e, n in before.items()}
    bm = min(M.EXPERT_BLOCK_M, rows)
    padded = -(-rows // bm) * bm
    assert moe_kernel.last_grid == moe_ops.grid_shape(cfg.n_experts, padded, cfg.d_model,
                                                      cfg.moe_hidden, block_m=bm)
    _close(out.cpu(), ref, torch.float32)
    _close(aux.cpu(), ref_aux, torch.float32)


def test_dbrx_smoke_moe_layer_bf16_on_the_card_matches_the_cpu(dev):
    """bf16 compute: the card's kernel keeps gate and up in f32 and rounds
    h once; the CPU's plain version computes in f32 and rounds the output.
    Both route the same tokens to the same slots."""
    from repro_torch.models import moe as M

    cfg, p, x, p_dev, x_dev = _moe_layer_pair(dev, torch.bfloat16, 96, seed=6)
    with torch.no_grad():
        out, aux = M.moe_layer(p_dev, x_dev, cfg, train=False)
        ref, ref_aux = M.moe_layer(p, x, cfg, train=False)
        ids = torch.topk((x_dev.reshape(-1, cfg.d_model) @ p_dev["router"]).float(),
                         cfg.top_k).indices.cpu()
        ref_ids = torch.topk((x.reshape(-1, cfg.d_model) @ p["router"]).float(),
                             cfg.top_k).indices
    assert torch.equal(ids, ref_ids)
    assert out.dtype == torch.bfloat16
    _close(out.cpu(), ref, torch.bfloat16)
    _close(aux.cpu(), ref_aux, torch.bfloat16)


def test_mlp_forward_on_the_card_matches_the_cpu(dev):
    """The predictor's MLP (BatchNorm in train and eval mode, no dropout),
    same weights on the card and on the CPU, f32 without TF32."""
    from repro_torch.core import nn
    from repro_torch.optim.adamw import tree_map

    params, state = nn.init_mlp(torch.Generator().manual_seed(0), 44)
    x = _randn(np.random.default_rng(0), (512, 44), torch.float32, "cpu")
    to_dev = lambda tree: tree_map(lambda t: t.to(dev), tree)
    for train in (True, False):
        out, new_state = nn.mlp_forward(to_dev(params), to_dev(state), x.to(dev), train=train)
        ref, ref_state = nn.mlp_forward(params, state, x, train=train)
        _close(out.cpu(), ref, torch.float32)
        for a, b in zip(new_state["bn_var"], ref_state["bn_var"]):
            _close(a.cpu(), b, torch.float32)


def test_fit_mlp_on_the_card_learns_gemm(dev):
    """``tests/test_core.py``'s gemm criterion, trained on the card."""
    from repro_torch.core.dataset import SEEN, build_dataset, mape
    from repro_torch.core.estimator import train_pipeweave

    ds = build_dataset("gemm", n_workloads=110, seed=5)
    pw = train_pipeweave({"gemm": ds}, max_epochs=250, device="cuda")
    pred = pw.predict_dataset(ds)
    seen = np.array([h in SEEN for h in ds.hw_names])
    m = mape(pred[seen], ds.actual_s[seen])
    assert m < mape(ds.theoretical_s[seen], ds.actual_s[seen]) and m < 20.0, m


FAMILIES = ["gemma2-2b", "stablelm-3b", "mamba2-370m", "hymba-1.5b", "whisper-base",
            "llama-3.2-vision-11b"]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_smoke_model_on_the_card_matches_the_cpu(dev, arch, compute_dtype):
    """Each family's smoke model, the same weights and inputs on the card
    (kernels) and on the CPU (plain versions): prefill and 4 decode steps
    fed the CPU's greedy tokens, within 1e-4 of max|logit| in f32 and 5e-2
    in bf16 (the tolerances of ``tests/test_torch_families.py``)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model, materialize_batch

    cfg = dataclasses.replace(get_arch(arch).smoke(), compute_dtype=compute_dtype)
    cpu, gpu = build_model(cfg, "cpu"), build_model(cfg, "cuda")
    params = cpu.init(0)
    gparams = T.Tree(T.tree_map(lambda a: a.to(dev), params))
    batch = materialize_batch(cfg, 2, 45, device="cpu")
    tol = 1e-4 if compute_dtype == "float32" else 5e-2
    with torch.no_grad():
        ref, caches = cpu.prefill(params, batch)
        out, gcaches = gpu.prefill(gparams, {k: v.to(dev) for k, v in batch.items()})
        caches, gcaches = T.pad_cache(caches, cfg, 50), T.pad_cache(gcaches, cfg, 50)
        for step in range(5):
            scale = float(ref.float().abs().max())
            assert float((out.float().cpu() - ref.float()).abs().max()) <= tol * scale, step
            if step == 4:
                break
            tok, pos = ref.argmax(-1), torch.full((2,), 45 + step)
            ref, caches = cpu.decode(params, caches, tok, pos)
            out, gcaches = gpu.decode(gparams, gcaches, tok.to(dev), pos.to(dev))


# ----------------------------------------------------------------------
# backward kernels (training), against their plain backward formulas
# ----------------------------------------------------------------------


def _rel_close(got, ref, dtype, name):
    """Within TOL[dtype] of ``ref``'s largest magnitude (each gradient)."""
    torch.cuda.synchronize()
    scale = float(ref.float().abs().max())
    err = float((got.float() - ref.float()).abs().max())
    assert err <= TOL[dtype] * scale, f"{name}: {err:.3g} of max|ref| {scale:.3g}"


@pytest.mark.parametrize("shape,xd,wd", [
    ((8192, 1024), torch.bfloat16, torch.float32),  # the final norm: an f32 weight
    ((8192, 1024), torch.bfloat16, torch.bfloat16),
    ((4096, 128), torch.bfloat16, torch.bfloat16),  # q/k norms
    ((131072, 128), torch.bfloat16, torch.bfloat16),  # qwen3-0.6b's q norm at B4 S2048
    ((65536, 128), torch.bfloat16, torch.bfloat16),  # and its k norm
    ((2, 7, 48), torch.float32, torch.float32),
    ((777, 1024), torch.float32, torch.float32),
])
def test_rmsnorm_bwd_kernel_matches_plain(dev, shape, xd, wd):
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref

    rng = np.random.default_rng(0)
    x, w, g = _randn(rng, shape, xd, dev), _randn(rng, shape[-1:], wd, dev, 0.1), _randn(
        rng, shape, xd, dev)
    n0 = rms_kernel.bwd_launches
    dx, dw = rms_kernel.rmsnorm_bwd_cuda(g, x, w)
    assert rms_kernel.bwd_launches == n0 + 1 and dx.dtype == xd and dw.dtype == wd
    rdx, rdw = rmsnorm_bwd_ref(g, x, w)
    _rel_close(dx, rdx, xd, "dx")
    _rel_close(dw, rdw, wd, "dw")
    dx2, dw2 = rms_kernel.rmsnorm_bwd_cuda(g, x, w)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)  # no atomics: the same bits


@pytest.mark.parametrize("act", ["silu", "geglu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_silu_mul_bwd_kernel_matches_plain(dev, act, dtype):
    from repro_torch.kernels.silu_mul.ref import silu_mul_bwd_ref

    rng = np.random.default_rng(0)
    shape = (1000, 3072)
    g, u, dh = _randn(rng, shape, dtype, dev, 3.0), _randn(rng, shape, dtype, dev), _randn(
        rng, shape, dtype, dev)
    n0 = silu_kernel.bwd_launches
    dg, du = silu_kernel.silu_mul_bwd_cuda(dh, g, u, act=act)
    assert silu_kernel.bwd_launches == n0 + 1
    rdg, rdu = silu_mul_bwd_ref(dh, g, u, act=act)
    _rel_close(dg, rdg, dtype, "dg")
    _rel_close(du, rdu, dtype, "du")


FA_BWD_CASES = [
    # the reference's kernel cases, GQA, ragged lengths, qwen3-0.6b's heads,
    # and rows q >= Skv + window - 1 that see no key
    (1, 64, 64, 2, 2, 16, True, None, None),
    (2, 128, 128, 4, 2, 32, True, None, None),
    (1, 64, 64, 2, 1, 16, True, 32, None),
    (1, 64, 64, 2, 2, 16, True, None, 30.0),
    (2, 64, 64, 4, 4, 16, False, None, None),
    (1, 32, 128, 2, 2, 16, False, None, None),
    (2, 100, 100, 4, 2, 128, True, None, None),
    (1, 77, 200, 2, 1, 64, False, 50, 20.0),
    (1, 40, 40, 2, 2, 8, True, None, None),
    (1, 200, 50, 2, 1, 64, False, 10, None),
    (1, 200, 50, 2, 1, 64, True, 10, None),
    (1, 1000, 1000, 16, 8, 128, True, None, None),
    # stablelm-3b's head dim 80: its training shape, and a window, a softcap,
    # GQA and a ragged length
    (1, 2048, 2048, 32, 32, 80, True, None, None),
    (2, 300, 300, 4, 2, 80, True, 100, 30.0),
    (1, 781, 781, 16, 8, 128, True, None, None),
]


@pytest.mark.parametrize("case", FA_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_matches_plain(dev, case, dtype):
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    B, S, Skv, Hq, Hkv, D, causal, window, softcap = case
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, S, Hq, D), dtype, dev)
    k, v = (_randn(rng, (B, Skv, Hkv, D), dtype, dev) for _ in range(2))
    dout = _randn(rng, (B, S, Hq, D), dtype, dev)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = fa_kernel.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    # on the engine bwd_engine picks (bf16 at head dims 64-256: wgmma; f32 at
    # 80 and 128: 3xTF32); only its count moves. The 3xTF32 engine is held to
    # the plain backward run in float64
    engine = fa_kernel.bwd_engine(dtype, D)
    n0 = _counts(BWD_COUNTS)
    grads = fa_kernel.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    assert _counts(BWD_COUNTS) == {e: n + (e == engine) for e, n in n0.items()}
    wide = (lambda t: t.double()) if engine == "tf32" else (lambda t: t)
    want = attention_bwd_ref(*(wide(t) for t in (q, k, v, dout)), **kw)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        _rel_close(got, ref, dtype, name)
    again = fa_kernel.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # no atomics: the same bits


def test_kernel_ops_record_their_backward_kernels(dev):
    """On CUDA tensors that require grad, each op's output has a grad_fn
    whose backward launches the backward kernel, once."""
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    q = _randn(rng, (2, 64, 4, 32), bf16, dev).requires_grad_()
    k, v = (_randn(rng, (2, 64, 2, 32), bf16, dev).requires_grad_() for _ in range(2))
    x = _randn(rng, (64, 128), bf16, dev).requires_grad_()
    w = _randn(rng, (128,), torch.float32, dev, 0.1).requires_grad_()
    g, u = (_randn(rng, (64, 96), bf16, dev).requires_grad_() for _ in range(2))
    outs = [(fa_ops.attention(q, k, v), fa_kernel, (q, k, v)),
            (rms_ops.rmsnorm(x, w), rms_kernel, (x, w)),
            (silu_ops.act_mul(g, u), silu_kernel, (g, u))]
    for out, kmod, leaves in outs:
        assert out.grad_fn is not None
        n0 = kmod.bwd_launches
        out.float().square().sum().backward()
        assert kmod.bwd_launches == n0 + 1
        assert all(t.grad is not None and float(t.grad.abs().sum()) > 0 for t in leaves)
    assert w.grad.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_trains_at_head_dim_256(dev, dtype):
    """gemma2-2b's head dim 256 trains on the card: ``ops.attention`` under
    grad runs the backward engine ``bwd_engine`` picks (bf16: wgmma; f32:
    mma.sync), whose gradients equal ``attention_bwd_ref``'s with gemma2's
    masks (causal, a window, softcap 50), and a rerun gives the same bits."""
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    rng = np.random.default_rng(0)
    shapes = [(2, 200, 4, 256), (2, 200, 2, 256), (2, 200, 2, 256)]
    card = [_randn(rng, s, dtype, dev).requires_grad_() for s in shapes]
    g = _randn(rng, shapes[0], dtype, dev)
    kw = dict(causal=True, window=64, softcap=50.0)
    # bf16 runs on the wgmma engine, f32 on the mma.sync engine (bwd_engine)
    count = "bwd_wgmma_launches" if dtype == torch.bfloat16 else "bwd_launches"
    n0 = getattr(fa_kernel, count)
    got = torch.autograd.grad(fa_ops.attention(*card, **kw), card, g)
    again = torch.autograd.grad(fa_ops.attention(*card, **kw), card, g)
    assert getattr(fa_kernel, count) == n0 + 2
    want = attention_bwd_ref(*(t.detach() for t in card), g, **kw)
    for name, a, b, r in zip(("dq", "dk", "dv"), got, again, want):
        assert a.dtype == dtype and torch.equal(a, b)
        _rel_close(a, r, dtype, name)


#: (B, S, Skv, Hq, Hkv, causal, window, softcap, q_offset) at each head dim
#: of the wgmma engine: small, ragged (S 130) without and with each mask
#: alone and together, rows that see no key, S != Skv, a group of 6, query
#: offsets (a rank's block of rows), then each head dim's training shapes:
#: gemma2-2b's with and without its masks at 256; qwen3-0.6b's (16/8) and
#: dbrx-132b's (48/8) at 128; stablelm-3b's (32/32) at 80; hymba-1.5b's
#: global layer (25/5, causal) and whisper-base's encoder (8/8, no mask) at 64
_FA_WGMMA_SMALL = [
    (1, 64, 64, 2, 2, True, None, None, 0),
    (2, 130, 130, 4, 2, True, None, None, 0),
    (2, 130, 130, 4, 2, False, None, None, 0),
    (1, 130, 130, 2, 1, True, 64, None, 0),
    (1, 130, 130, 2, 1, False, None, 50.0, 0),
    (1, 130, 130, 2, 1, True, 64, 50.0, 0),
    (1, 200, 50, 2, 1, True, 10, None, 0),
    (1, 77, 200, 4, 1, False, 50, 20.0, 0),
    (2, 300, 300, 12, 2, True, None, None, 0),
    (1, 64, 192, 4, 2, True, None, None, 64),
    (1, 130, 200, 6, 1, False, 64, None, 40),
]
FA_WGMMA_CASES = [(*c, D) for D in (64, 80, 128, 256) for c in _FA_WGMMA_SMALL] + [
    (1, 4096, 4096, 8, 4, True, 4096, 50.0, 0, 256),
    (1, 4096, 4096, 8, 4, True, None, None, 0, 256),
    (1, 4096, 4096, 8, 4, False, None, None, 0, 256),
    (4, 2048, 2048, 16, 8, True, None, None, 0, 128),
    (1, 2048, 2048, 48, 8, True, None, None, 0, 128),
    (1, 2048, 2048, 32, 32, True, None, None, 0, 80),
    (1, 1528, 1528, 25, 5, True, None, None, 0, 64),
    (1, 1500, 1500, 8, 8, False, None, None, 0, 64),
]


@pytest.mark.parametrize("case", FA_WGMMA_CASES)
def test_flash_attention_bwd_wgmma_matches_plain_and_mma_sync(dev, case):
    """The wgmma engine (``csrc/flash_attention_bwd_wgmma.cu``) at head dims
    64, 80, 128 and 256: each gradient within bf16 2e-2 of ``attention_bwd_ref``'s
    max|ref| and of the mma.sync engine's on the same inputs, bit-equal on a
    rerun; its count moves by one a call and the mma.sync engine's not at
    all; each launch's shared bytes are the plan's."""
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    B, S, Skv, Hq, Hkv, causal, window, softcap, off, D = case
    bf16 = torch.bfloat16
    rng = np.random.default_rng(3)
    q, dout = (_randn(rng, (B, S, Hq, D), bf16, dev) for _ in range(2))
    k, v = (_randn(rng, (B, Skv, Hkv, D), bf16, dev) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    out, lse = fa_kernel.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert fa_kernel.bwd_engine(bf16, D) == "wgmma"
    b0, w0 = fa_kernel.bwd_launches, fa_kernel.bwd_wgmma_launches
    got = fa_kernel.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    again = fa_kernel.flash_attention_bwd_wgmma_cuda(q, k, v, out, lse, dout, **kw)
    assert (fa_kernel.bwd_launches, fa_kernel.bwd_wgmma_launches) == (b0, w0 + 2)
    old = fa_kernel.flash_attention_bwd_mma_sync_cuda(q, k, v, out, lse, dout, **kw)
    want = attention_bwd_ref(q, k, v, dout, **kw)
    for name, a, b, o, r in zip(("dq", "dk", "dv"), got, again, old, want):
        assert a.dtype == bf16 and bool(torch.isfinite(a).all()) and torch.equal(a, b), name
        _rel_close(a, r, bf16, name)
        _rel_close(a, o, bf16, name + " against the mma.sync engine")
    lib = fa_kernel.wgmma_library()
    for i, kern in enumerate(fa_kernel.bwd_wgmma_plan(B, S, Skv, Hq, Hkv, D)):
        assert lib.fa_bwd_wgmma_smem_bytes(D, i) == kern.smem <= fa_kernel.SMEM_LIMIT


@pytest.mark.parametrize("D", fa_kernel.WGMMA_HEAD_DIMS)
def test_flash_attention_bwd_wgmma_runs_first_on_a_fresh_thread(dev, D):
    """The wgmma engine as the first CUDA work of a new thread, as autograd's
    backward thread runs it: its tensor maps are encoded there (a driver
    call that needs the thread's context current), and its gradients equal
    those of a call on this thread."""
    import threading

    bf16 = torch.bfloat16
    rng = np.random.default_rng(6)
    q, dout = (_randn(rng, (1, 130, 4, D), bf16, dev) for _ in range(2))
    k, v = (_randn(rng, (1, 130, 2, D), bf16, dev) for _ in range(2))
    out, lse = fa_kernel.flash_attention_cuda(q, k, v, return_lse=True)
    here = fa_kernel.flash_attention_bwd_wgmma_cuda(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    there = {}

    def run():
        try:
            there["grads"] = fa_kernel.flash_attention_bwd_wgmma_cuda(q, k, v, out, lse, dout)
            torch.cuda.synchronize()
        except Exception as e:  # handed to the test's thread
            there["error"] = e

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    assert "error" not in there, there.get("error")
    for name, a, b in zip(("dq", "dk", "dv"), there["grads"], here):
        assert torch.equal(a, b), name


#: (B, S, Skv, Hq, Hkv, D, causal, window, softcap, q_offset) for the
#: forward's 3xTF32 engine: FWD_WGMMA_CASES at head dims 64, 80 and 128,
#: then the f32 paths' shapes: qwen3-0.6b's and stablelm-3b's gradient runs
#: (B2 S256), dbrx-132b's (B1 S128, 48/8 heads) and the tuner's workload
#: (B2 S512)
FWD_TF32_CASES = [c for c in FWD_WGMMA_CASES if c[5] in (64, 80, 128)] + [
    (2, 256, 256, 16, 8, 128, True, None, None, 0),
    (2, 256, 256, 32, 32, 80, True, None, None, 0),
    (1, 128, 128, 48, 8, 128, True, None, None, 0),
    (2, 512, 512, 16, 8, 128, True, None, None, 0),
]


@pytest.mark.parametrize("case", FWD_TF32_CASES)
def test_flash_attention_fwd_tf32_matches_float64_and_fma(dev, case):
    """The forward's 3xTF32 engine (``csrc/flash_attention_tf32.cu``): its
    output and lse within f32's 2e-5 (``allclose``) of the plain version run
    in float64, its output within 2e-5 of max|ref| of the FMA engine's on
    the same inputs; bit-equal on a rerun; ``flash_attention_cuda`` picks
    it and only its count moves; the library's shared bytes are the plan's."""
    from repro_torch.kernels.flash_attention.ref import attention_ref, lse_ref

    B, S, Skv, Hq, Hkv, D, causal, window, softcap, off = case
    f32 = torch.float32
    rng = np.random.default_rng(6)
    q = _randn(rng, (B, S, Hq, D), f32, dev)
    k, v = (_randn(rng, (B, Skv, Hkv, D), f32, dev) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    assert fa_kernel.fwd_engine(f32, D) == "tf32"
    n0 = _counts(FWD_COUNTS)
    out, lse = fa_kernel.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    again, lse2 = fa_kernel.flash_attention_tf32_cuda(q, k, v, return_lse=True, **kw)
    assert _counts(FWD_COUNTS) == {e: n + 2 * (e == "tf32") for e, n in n0.items()}
    assert fa_kernel.last_grid == fa_kernel.launch_plan(B, S, Skv, Hq, Hkv, D).grid
    old = fa_kernel.flash_attention_mma_sync_cuda(q, k, v, **kw)
    wide = [t.double() for t in (q, k, v)]
    exact, lexact = attention_ref(*wide, **kw), lse_ref(*wide, **kw)
    torch.cuda.synchronize()
    assert out.dtype == f32 and torch.equal(out, again) and torch.equal(lse, lse2)
    err = float((out.double() - exact).abs().max())
    assert torch.allclose(out.double(), exact, rtol=TOL[f32], atol=TOL[f32]), err
    fin = torch.isfinite(lexact)
    assert torch.equal(fin, torch.isfinite(lse)) and not bool(torch.isnan(lse).any())
    assert torch.allclose(lse.double()[fin], lexact[fin], rtol=TOL[f32], atol=TOL[f32])
    _rel_close(out, old, f32, "out against the FMA engine")
    plan = fa_kernel.fwd_tf32_plan(B, S, Skv, Hq, Hkv, D)
    assert fa_kernel.fwd_tf32_library().fa_fwd_tf32_smem_bytes(D) == plan.smem


@pytest.mark.parametrize("blocks", [(64, 32, 512), (512, 512, 512), (256, 96, 768),
                                    (128, 64, 512), (32, 16, 256)],
                         ids=lambda b: f"q{b[0]}-k{b[1]}-S{b[2]}")
@pytest.mark.parametrize("D", [64, 80, 128])
def test_flash_attention_fwd_tf32_blocks_reach_the_launch(dev, blocks, D):
    """block_q and block_k reach the 3xTF32 engine's launch (the grid the
    reference names; steps cut into tiles, a step shorter than a tile) and
    leave its function unchanged: within 2e-5 of float64."""
    bq, bk, S = blocks
    B, Hq, Hkv = 2, 4, 2
    rng = np.random.default_rng(7)
    q = _randn(rng, (B, S, Hq, D), torch.float32, dev)
    k, v = (_randn(rng, (B, S, Hkv, D), torch.float32, dev) for _ in range(2))
    for kw in (dict(causal=True, window=None, softcap=None),
               dict(causal=True, window=100, softcap=30.0),
               dict(causal=False, window=None, softcap=None)):
        out = fa_kernel.flash_attention_tf32_cuda(q, k, v, block_q=bq, block_k=bk, **kw)
        assert fa_kernel.last_grid == fa_ops.grid_shape(B, S, S, Hq, Hkv, D, block_q=bq,
                                                         block_k=bk)
        exact = _attention_f64(q, k, v, **kw)
        assert torch.allclose(out.double(), exact, rtol=TOL[torch.float32],
                              atol=TOL[torch.float32]), kw


def test_flash_attention_tf32_engines_refuse_what_they_do_not_take(dev):
    """bf16, head dims the 3xTF32 engines do not have (the forward 32 and
    256; the backward 64 and 256) and a base that is not a 16-byte multiple
    raise in their wrappers; ``flash_attention_cuda`` and
    ``flash_attention_bwd_cuda`` take the engine their ``*_engine`` picks,
    and only its count moves."""
    rng = np.random.default_rng(8)
    cases = ((torch.bfloat16, 128, 0), (torch.float32, 32, 0), (torch.float32, 256, 0),
             (torch.float32, 64, 0), (torch.float32, 128, 1), (torch.float32, 80, 2))
    for dtype, D, shift in cases:
        q, dout = (_randn(rng, (1, 64 * 2 * D + shift), dtype, dev)[:, shift:].view(1, 64, 2, D)
                   for _ in range(2))
        k, v = (_randn(rng, (1, 64, 1, D), dtype, dev) for _ in range(2))
        aligned = q.data_ptr() % 16 == 0
        fwd, bwd = fa_kernel.fwd_engine(dtype, D, aligned), fa_kernel.bwd_engine(dtype, D, aligned)
        if fwd != "tf32":
            with pytest.raises(ValueError, match="16-byte|head dim"):
                fa_kernel.flash_attention_tf32_cuda(q, k, v)
        n0 = _counts(FWD_COUNTS)
        out, lse = fa_kernel.flash_attention_cuda(q, k, v, return_lse=True)
        assert _counts(FWD_COUNTS) == {e: n + (e == fwd) for e, n in n0.items()}
        if bwd != "tf32":
            with pytest.raises(ValueError, match="16-byte|head dim"):
                fa_kernel.flash_attention_bwd_tf32_cuda(q, k, v, out, lse, dout)
        n0 = _counts(BWD_COUNTS)
        fa_kernel.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
        assert _counts(BWD_COUNTS) == {e: n + (e == bwd) for e, n in n0.items()}
    assert fa_kernel.fwd_engine(torch.float32, 64) == "tf32"
    assert fa_kernel.bwd_engine(torch.float32, 64) == "mma_sync"


#: (B, S, Skv, Hq, Hkv, causal, window, softcap, q_offset, D) for the
#: backward's 3xTF32 engine: the wgmma engine's small cases at head dims 80
#: and 128, then the f32 gradient runs' shapes (qwen3-0.6b's B2 S256 16/8,
#: dbrx-132b's B1 S128 48/8, stablelm-3b's B2 S256 32/32) and a ragged
#: 1000 rows
FA_TF32_BWD_CASES = [(*c, D) for D in (80, 128) for c in _FA_WGMMA_SMALL] + [
    (2, 256, 256, 16, 8, True, None, None, 0, 128),
    (1, 128, 128, 48, 8, True, None, None, 0, 128),
    (2, 256, 256, 32, 32, True, None, None, 0, 80),
    (1, 1000, 1000, 16, 8, True, None, None, 0, 128),
]


@pytest.mark.parametrize("case", FA_TF32_BWD_CASES)
def test_flash_attention_bwd_tf32_matches_float64_and_fma(dev, case):
    """The backward's 3xTF32 engine (``csrc/flash_attention_bwd_tf32.cu``) at
    head dims 80 and 128: each gradient within 2e-5 of the plain backward
    run in float64 (of each gradient's max|ref|) and of the FMA engine's on
    the same inputs, bit-equal on a rerun (its dK/dV split over CTAs where
    the plan splits it, summed in order); ``flash_attention_bwd_cuda`` picks
    it and only its count moves; each launch's shared bytes are the plan's."""
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    B, S, Skv, Hq, Hkv, causal, window, softcap, off, D = case
    f32 = torch.float32
    rng = np.random.default_rng(3)
    q, dout = (_randn(rng, (B, S, Hq, D), f32, dev) for _ in range(2))
    k, v = (_randn(rng, (B, Skv, Hkv, D), f32, dev) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    out, lse = fa_kernel.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert fa_kernel.bwd_engine(f32, D) == "tf32"
    n0 = _counts(BWD_COUNTS)
    got = fa_kernel.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    again = fa_kernel.flash_attention_bwd_tf32_cuda(q, k, v, out, lse, dout, **kw)
    assert _counts(BWD_COUNTS) == {e: n + 2 * (e == "tf32") for e, n in n0.items()}
    old = fa_kernel.flash_attention_bwd_mma_sync_cuda(q, k, v, out, lse, dout, **kw)
    want = attention_bwd_ref(*(t.double() for t in (q, k, v, dout)), **kw)
    for name, a, b, o, r in zip(("dq", "dk", "dv"), got, again, old, want):
        assert a.dtype == f32 and bool(torch.isfinite(a).all()) and torch.equal(a, b), name
        _rel_close(a, r, f32, name)
        _rel_close(a, o, f32, name + " against the FMA engine")
    lib = fa_kernel.bwd_tf32_library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, kern in enumerate(fa_kernel.bwd_tf32_plan(B, S, Skv, Hq, Hkv, D, sms)):
        assert lib.fa_bwd_tf32_smem_bytes(D, i) == kern.smem <= fa_kernel.SMEM_LIMIT


@pytest.mark.parametrize("D", fa_kernel.BWD_TF32_HEAD_DIMS)
def test_flash_attention_bwd_tf32_runs_first_on_a_fresh_thread(dev, D):
    """The 3xTF32 backward as the first CUDA work of a new thread, as
    autograd's backward thread runs it (its tensor maps encoded there): its
    gradients equal those of a call on this thread."""
    import threading

    rng = np.random.default_rng(6)
    q, dout = (_randn(rng, (1, 130, 4, D), torch.float32, dev) for _ in range(2))
    k, v = (_randn(rng, (1, 130, 2, D), torch.float32, dev) for _ in range(2))
    out, lse = fa_kernel.flash_attention_cuda(q, k, v, return_lse=True)
    here = fa_kernel.flash_attention_bwd_tf32_cuda(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    there = {}

    def run():
        try:
            there["grads"] = fa_kernel.flash_attention_bwd_tf32_cuda(q, k, v, out, lse, dout)
            torch.cuda.synchronize()
        except Exception as e:  # handed to the test's thread
            there["error"] = e

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    assert "error" not in there, there.get("error")
    for name, a, b in zip(("dq", "dk", "dv"), there["grads"], here):
        assert torch.equal(a, b), name


def _attention_bwd_f64(q, k, v, dout, **kw):
    """``(dq, dk, dv)`` of ``_attention_f64`` for ``dout``, by autograd in
    float64 on q's device."""
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(_attention_f64(*leaves, **kw), leaves, dout.double())


@pytest.mark.parametrize("D", fa_kernel.WGMMA_HEAD_DIMS)
def test_flash_attention_bwd_wgmma_refuses_what_it_does_not_take(dev, D):
    """f32, a base that is not a 16-byte multiple and (bf16) head dim 32
    are not the wgmma engine's: it raises, and ``flash_attention_bwd_cuda``
    takes the engine ``bwd_engine`` picks for them (f32 at 80 and 128: the
    3xTF32 engine; the rest: mma.sync), whose gradients are held to the
    function's float64 backward (f32, 2e-5 of each gradient's max|ref|) or to
    the plain backward (bf16, 2e-2)."""
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    rng = np.random.default_rng(4)
    for dtype, d, shift in ((torch.float32, D, 0), (torch.bfloat16, D, 1),
                            (torch.bfloat16, 32, 0)):
        q, dout = (_randn(rng, (1, 64 * 2 * d + shift), dtype, dev)[:, shift:].view(1, 64, 2, d)
                   for _ in range(2))
        k, v = (_randn(rng, (1, 64, 1, d), dtype, dev) for _ in range(2))
        out, lse = fa_kernel.flash_attention_cuda(q.contiguous(), k, v, return_lse=True)
        with pytest.raises(ValueError, match="16-byte|head dim"):
            fa_kernel.flash_attention_bwd_wgmma_cuda(q, k, v, out, lse, dout)
        engine = fa_kernel.bwd_engine(dtype, d, q.data_ptr() % 16 == 0)
        assert engine == ("tf32" if dtype == torch.float32 and d in (80, 128) else "mma_sync")
        n0 = _counts(BWD_COUNTS)
        got = fa_kernel.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
        assert _counts(BWD_COUNTS) == {e: n + (e == engine) for e, n in n0.items()}
        kw = dict(causal=True, window=None, softcap=None)
        if dtype == torch.float32:
            want = _attention_bwd_f64(q, k, v, dout, **kw)
        else:
            want = attention_bwd_ref(q, k, v, dout, causal=True)
        for name, a, r in zip(("dq", "dk", "dv"), got, want):
            _rel_close(a, r, dtype, f"{dtype} D{d} {name}")


#: (B, rows, offset, Skv, Hq, Hkv, D, causal, window, softcap): a block of q
#: rows at an offset (a rank's rows under ``ops.row_split``), rows past Skv +
#: window - 1 that see no key among them
FA_OFFSET_CASES = [
    (1, 64, 64, 192, 4, 2, 128, True, None, None),
    (2, 100, 60, 200, 4, 2, 80, True, 48, 30.0),
    (1, 130, 40, 200, 2, 1, 128, False, 64, None),
    (2, 100, 60, 200, 4, 2, 64, True, 48, 30.0),
    (1, 64, 100, 96, 2, 1, 256, True, 32, 50.0),
    (1, 1024, 3072, 4096, 8, 4, 256, True, 4096, 50.0),
    (1, 130, 40, 200, 2, 1, 256, False, 64, None),
]


@pytest.mark.parametrize("case", FA_OFFSET_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_q_offset_forward_and_backward(dev, case, dtype):
    """With ``q_offset`` the forward, and the backward on each engine that
    takes the type and head dim, equal the plain versions at that offset
    (f32 2e-5, bf16 2e-2 of each gradient's max|ref|)."""
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

    B, rows, off, Skv, Hq, Hkv, D, causal, window, softcap = case
    rng = np.random.default_rng(5)
    q, dout = (_randn(rng, (B, rows, Hq, D), dtype, dev) for _ in range(2))
    k, v = (_randn(rng, (B, Skv, Hkv, D), dtype, dev) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    out, lse = fa_kernel.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    _rel_close(out, attention_ref(q, k, v, **kw), dtype, "out")
    want = attention_bwd_ref(q, k, v, dout, **kw)
    engines = [fa_kernel.flash_attention_bwd_mma_sync_cuda]
    if fa_kernel.bwd_engine(dtype, D) != "mma_sync":
        engines.append(getattr(fa_kernel, f"flash_attention_bwd_{fa_kernel.bwd_engine(dtype, D)}"
                                          f"_cuda"))
    for engine in engines:
        got = engine(q, k, v, out, lse, dout, **kw)
        for name, a, r in zip(("dq", "dk", "dv"), got, want):
            _rel_close(a, r, dtype, f"{engine.__name__} {name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_trains_at_head_dim_80(dev, dtype):
    """stablelm-3b's head dim 80 trains on the card: ``ops.attention``'s
    gradients through the backward engine ``bwd_engine`` picks (bf16: wgmma;
    f32: 3xTF32), only its count moving, equal autograd's through the
    plain version on the CPU, on the same inputs."""
    rng = np.random.default_rng(0)
    shapes = [(2, 96, 4, 80), (2, 96, 2, 80), (2, 96, 2, 80)]
    host = [_randn(rng, s, dtype, "cpu").float().requires_grad_() for s in shapes]
    card = [t.detach().to(dev, dtype).requires_grad_() for t in host]
    g = _randn(rng, shapes[0], dtype, "cpu")
    engine = fa_kernel.bwd_engine(dtype, 80)
    assert engine == ("tf32" if dtype == torch.float32 else "wgmma")
    n0 = _counts(BWD_COUNTS)
    got = torch.autograd.grad(fa_ops.attention(*card, window=64), card, g.to(dev))
    assert _counts(BWD_COUNTS) == {e: n + (e == engine) for e, n in n0.items()}
    want = torch.autograd.grad(fa_ops.attention(*host, window=64), host, g.float())
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype
        _rel_close(a.cpu(), r, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_moe_trains_on_the_card(dev, dtype):
    """``fused_moe`` under grad runs the backward engine ``bwd_engine``
    picks (bf16 with 16-byte rows: the wgmma engine; f32 with 16-byte rows,
    36/44 wide too: the 3xTF32 wgmma engine; the 37/45-wide rows, and the
    36/44-wide bf16 ones: the mma.sync engine): the gradients of x and the
    three weights equal ``fused_moe_bwd_ref``'s, on ragged shapes too, and
    a rerun gives the same bits."""
    from repro_torch.kernels.fused_moe.ref import fused_moe_bwd_ref

    rng = np.random.default_rng(0)
    for E, C, D, F in ((2, 64, 48, 96), (3, 20, 36, 44), (3, 20, 37, 45)):
        x = _randn(rng, (E, C, D), dtype, dev).requires_grad_()
        ws = [_randn(rng, s, dtype, dev, 0.2).requires_grad_()
              for s in ((E, D, F), (E, D, F), (E, F, D))]
        dy = _randn(rng, (E, C, D), dtype, dev)
        engine = moe_kernel.bwd_engine(dtype, D, F)
        assert engine == ("mma_sync" if D % 4 or (dtype == torch.bfloat16 and D != 48)
                          else "wgmma" if dtype == torch.bfloat16 else "wgmma_tf32")
        # the forward runs on the engine fwd_engine picks: for these widths
        # the backward's counterpart (the 3xTF32 one for f32 with 16-byte rows)
        fwd = moe_kernel.fwd_engine(dtype, C, D, F)
        assert fwd == engine
        counts = lambda: (_moe_fwd_counts(), moe_kernel.bwd_launches,  # noqa: E731
                          moe_kernel.bwd_wgmma_launches, moe_kernel.bwd_tf32_launches)
        f0, b0, w0, t0 = counts()
        got = torch.autograd.grad(moe_ops.fused_moe(x, *ws, block_m=C), [x, *ws], dy)
        again = torch.autograd.grad(moe_ops.fused_moe(x, *ws, block_m=C), [x, *ws], dy)
        assert counts() == ({e: n + 2 * (e == fwd) for e, n in f0.items()},
                            b0 + 2 * (engine == "mma_sync"), w0 + 2 * (engine == "wgmma"),
                            t0 + 2 * (engine == "wgmma_tf32"))
        want = fused_moe_bwd_ref(x.detach(), *(w.detach() for w in ws), dy)
        for name, a, b, r in zip(("dx", "dw_gate", "dw_up", "dw_down"), got, again, want):
            assert a.dtype == dtype and torch.equal(a, b)
            _rel_close(a, r, dtype, name)


#: f32 shapes whose rows are 16-byte multiples: ragged M, N and K (none a
#: tile multiple), C 20 and 1 (rows padded to 4 values), one expert, and
#: arctic-480b's expert width (40 rows)
TF32_SHAPES = [(2, 64, 48, 96), (3, 20, 36, 44), (3, 200, 520, 776), (1, 1, 8, 8),
               (2, 40, 7168, 4864)]


@pytest.mark.parametrize("shape", TF32_SHAPES)
def test_fused_moe_bwd_tf32_matches_plain_and_mma_sync(dev, shape):
    """The 3xTF32 wgmma engine (``csrc/fused_moe_bwd_tf32.cu``): each
    gradient within f32 2e-5 of max|ref| of ``fused_moe_bwd_ref`` run in
    float64 (plain TF32 would be about 1e-3 off) and of the mma.sync
    engine's on the same inputs, bit-equal on a rerun; ``fused_moe_bwd_cuda``
    picks it, its count moves by one a call and the other engines' not at
    all; each launch's shared bytes are the library's."""
    from repro_torch.kernels.fused_moe.ref import fused_moe_bwd_ref

    E, C, D, F = shape
    f32 = torch.float32
    rng = np.random.default_rng(6)
    x, dy = _randn(rng, (E, C, D), f32, dev), _randn(rng, (E, C, D), f32, dev)
    ws = [_randn(rng, s, f32, dev, s[1] ** -0.5) for s in ((E, D, F), (E, D, F), (E, F, D))]
    assert moe_kernel.bwd_engine(f32, D, F) == "wgmma_tf32"
    counts = lambda: (moe_kernel.bwd_launches, moe_kernel.bwd_wgmma_launches,  # noqa: E731
                      moe_kernel.bwd_tf32_launches)
    b0, w0, t0 = counts()
    got = moe_kernel.fused_moe_bwd_cuda(x, *ws, dy)
    again = moe_kernel.fused_moe_bwd_tf32_cuda(x, *ws, dy)
    assert counts() == (b0, w0, t0 + 2)
    old = moe_kernel.fused_moe_bwd_mma_sync_cuda(x, *ws, dy)
    want = fused_moe_bwd_ref(*(t.double() for t in (x, *ws, dy)))
    for name, a, b, o, r in zip(("dx", "dw_gate", "dw_up", "dw_down"), got, again, old, want):
        assert a.dtype == f32 and torch.equal(a, b), name
        _rel_close(a, r, f32, name)
        _rel_close(a, o, f32, name + " against the mma.sync engine")
    lib = moe_kernel.tf32_library()
    for i, launch in enumerate(moe_kernel.tf32_plan(E, C, D, F)):
        assert lib.fused_moe_bwd_tf32_smem_bytes(i, C) == launch.smem <= moe_kernel.SMEM_LIMIT


def test_fused_moe_bwd_tf32_refuses_what_tma_cannot_address(dev):
    """f32 rows that are not 16-byte multiples (D 37, F 45) and a base off
    16 bytes are not the 3xTF32 engine's: it raises, and
    ``fused_moe_bwd_cuda`` takes the mma.sync engine for them."""
    rng = np.random.default_rng(7)
    f32 = torch.float32

    def offset(t):  # the same values at a base 4 bytes past a 16-byte boundary
        out = torch.empty(t.numel() + 1, dtype=f32, device=dev)[1:].view(t.shape)
        return out.copy_(t)

    for D, F, shift in ((37, 45, False), (48, 96, True)):
        x, dy = _randn(rng, (2, 8, D), f32, dev), _randn(rng, (2, 8, D), f32, dev)
        ws = [_randn(rng, s, f32, dev, 0.2) for s in ((2, D, F), (2, D, F), (2, F, D))]
        if shift:
            x = offset(x)
            assert x.is_contiguous() and x.data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte"):
            moe_kernel.fused_moe_bwd_tf32_cuda(x, *ws, dy)
        b0, t0 = moe_kernel.bwd_launches, moe_kernel.bwd_tf32_launches
        moe_kernel.fused_moe_bwd_cuda(x, *ws, dy)
        assert (moe_kernel.bwd_launches, moe_kernel.bwd_tf32_launches) == (b0 + 1, t0)


#: (E, C, D, F, block_m, block_f) for the 3xTF32 forward: ragged C, D and
#: F (C 1, 20 and 65: g^T's rows padded to 4 values), blocks of one tile,
#: several and under one, the tuner's default workload at two knob pairs,
#: and dbrx-132b's widths (two of its experts) at the tuner's 256 rows an
#: expert under three knob pairs and at training's 640
TF32_FWD_SHAPES = [(2, 64, 48, 96, 64, 96), (3, 20, 36, 44, 20, 44), (1, 1, 8, 8, 128, 256),
                   (3, 200, 520, 776, 100, 776), (2, 65, 40, 48, 65, 48),
                   (4, 256, 264, 512, 32, 64), (2, 384, 100, 96, 192, 32),
                   (8, 512, 256, 512, 128, 256), (8, 512, 256, 512, 512, 32),
                   (2, 256, 6144, 10752, 128, 256), (2, 256, 6144, 10752, 32, 512),
                   (2, 256, 6144, 10752, 256, 64), (2, 640, 6144, 10752, 128, 256)]


@pytest.mark.parametrize("shape", TF32_FWD_SHAPES)
def test_fused_moe_tf32_fwd_matches_float64_and_mma_sync(dev, shape):
    """The 3xTF32 forward (``csrc/fused_moe_tf32.cu``): within 1e-5 of
    max|ref| of ``fused_moe_ref`` run in float64 (plain TF32 would be about
    1e-3 off) and within f32 2e-5 of the mma.sync engine's output on the
    same inputs, bit-equal on a rerun; ``fused_moe_cuda`` picks it at every
    knob pair, its count moves by one a call and the other engines' not at
    all; the launched grid is the reference's; the library's shared bytes
    are the plan's."""
    from repro_torch.kernels.fused_moe.ref import fused_moe_ref

    E, C, D, F, bm, bf = shape
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(5)  # dbrx's weights drawn on the card

    def randn(shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev, dtype=f32)

    x = randn((E, C, D))
    ws = [randn(s, n ** -0.5) for s, n in (((E, D, F), D), ((E, D, F), D), ((E, F, D), F))]
    assert moe_kernel.fwd_engine(f32, C, D, F, block_f=bf) == "wgmma_tf32"
    before = _moe_fwd_counts()
    got = moe_kernel.fused_moe_cuda(x, *ws, block_m=bm, block_f=bf)
    again = moe_kernel.fused_moe_tf32_cuda(x, *ws, block_m=bm, block_f=bf)
    assert _moe_fwd_counts() == {e: n + 2 * (e == "wgmma_tf32") for e, n in before.items()}
    assert moe_kernel.last_grid == moe_ops.grid_shape(E, C, D, F, block_m=bm, block_f=bf)
    old = moe_kernel.fused_moe_mma_sync_cuda(x, *ws, block_m=bm, block_f=bf)
    exact = fused_moe_ref(*(t.double() for t in (x, *ws)))
    torch.cuda.synchronize()
    assert got.dtype == f32 and torch.equal(got, again)
    err = float((got.double() - exact).abs().max()) / float(exact.abs().max())
    assert err <= 1e-5, f"{err:.3g} of max|float64 ref|"
    _rel_close(got, old, f32, "y against the mma.sync engine")
    lib = moe_kernel.fwd_tf32_library()
    launch = moe_kernel.tf32_fwd_plan(E, C, D, F, bm, bf)[0]
    assert lib.fused_moe_tf32_smem_bytes(launch.tile[1]) == launch.smem <= moe_kernel.SMEM_LIMIT


def test_fused_moe_tf32_fwd_refuses_what_it_does_not_take(dev):
    """bf16, f32 rows that are not 16-byte multiples (D 37), a base off 16
    bytes and F blocks that are neither whole 32-deep stages nor all of F
    (48 of 96) are not the 3xTF32 forward's: it raises, and
    ``fused_moe_cuda`` takes another engine for them."""
    rng = np.random.default_rng(8)

    def offset(t):  # the same values at a base 4 bytes past a 16-byte boundary
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return out.copy_(t)

    for dtype, D, F, bf, shift in ((torch.bfloat16, 48, 96, 96, False),
                                   (torch.float32, 37, 96, 96, False),
                                   (torch.float32, 48, 96, 96, True),
                                   (torch.float32, 48, 96, 48, False)):
        x = _randn(rng, (2, 32, D), dtype, dev)
        ws = [_randn(rng, s, dtype, dev, 0.2) for s in ((2, D, F), (2, D, F), (2, F, D))]
        if shift:
            x = offset(x)
            assert x.is_contiguous() and x.data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte"):
            moe_kernel.fused_moe_tf32_cuda(x, *ws, block_f=bf)
        before = _moe_fwd_counts()
        out = moe_kernel.fused_moe_cuda(x, *ws, block_f=bf)
        engine = "wgmma" if dtype == torch.bfloat16 else "mma_sync"
        assert _moe_fwd_counts() == {e: n + (e == engine) for e, n in before.items()}
        _close(out.cpu(), moe_ops.fused_moe(*(t.cpu() for t in (x, *ws))), dtype)


#: bf16 shapes whose rows are 16-byte multiples: ragged M, N and K (none a
#: tile multiple), one expert, and arctic-480b's expert width (40 rows)
WGMMA_SHAPES = [(2, 64, 48, 96), (3, 200, 520, 776), (1, 1, 8, 8), (2, 40, 7168, 4864)]


@pytest.mark.parametrize("shape", WGMMA_SHAPES)
def test_fused_moe_bwd_wgmma_matches_plain_and_mma_sync(dev, shape):
    """The wgmma engine (``csrc/fused_moe_bwd_wgmma.cu``): each gradient
    within bf16 2e-2 of ``fused_moe_bwd_ref``'s max|ref| and of the mma.sync
    engine's on the same inputs, bit-equal on a rerun; its count moves by
    one a call and the mma.sync engine's not at all; each launch's shared
    bytes are the library's."""
    from repro_torch.kernels.fused_moe.ref import fused_moe_bwd_ref

    E, C, D, F = shape
    rng = np.random.default_rng(1)
    x, dy = _randn(rng, (E, C, D), torch.bfloat16, dev), _randn(rng, (E, C, D), torch.bfloat16, dev)
    ws = [_randn(rng, s, torch.bfloat16, dev, s[1] ** -0.5)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    assert moe_kernel.bwd_engine(torch.bfloat16, D, F) == "wgmma"
    b0, w0 = moe_kernel.bwd_launches, moe_kernel.bwd_wgmma_launches
    got = moe_kernel.fused_moe_bwd_cuda(x, *ws, dy)
    again = moe_kernel.fused_moe_bwd_wgmma_cuda(x, *ws, dy)
    assert (moe_kernel.bwd_launches, moe_kernel.bwd_wgmma_launches) == (b0, w0 + 2)
    old = moe_kernel.fused_moe_bwd_mma_sync_cuda(x, *ws, dy)
    want = fused_moe_bwd_ref(x, *ws, dy)
    for name, a, b, o, r in zip(("dx", "dw_gate", "dw_up", "dw_down"), got, again, old, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), name
        _rel_close(a, r, torch.bfloat16, name)
        _rel_close(a, o, torch.bfloat16, name + " against the mma.sync engine")
    lib = moe_kernel.wgmma_library()
    for i, launch in enumerate(moe_kernel.wgmma_plan(E, C, D, F)):
        assert lib.fused_moe_bwd_wgmma_smem_bytes(i) == launch.smem <= moe_kernel.SMEM_LIMIT


#: the forward wgmma engine's shapes and knobs (E, C, D, F, block_m,
#: block_f): ragged C, D and F, one and two consumer warpgroups, row blocks
#: walked in sub-tiles, F blocks cut inside a tile or spanning several, an
#: expert of 8 rows in one block, blocks of 32 and 8 rows of a larger expert
#: (a 64-row tile storing the block's rows), and dbrx-132b's width at its
#: decode tick (4 rows), 1024-token prefill (512) and training (640)
FWD_WGMMA_SHAPES = [(2, 64, 64, 128, 64, 256), (3, 200, 520, 776, 100, 776),
                    (3, 8, 264, 512, 128, 256), (16, 4, 6144, 10752, 128, 256),
                    (2, 192, 136, 264, 64, 88), (2, 384, 200, 328, 192, 8),
                    (1, 512, 256, 512, 512, 512), (4, 256, 256, 512, 128, 64),
                    (4, 256, 256, 512, 32, 64), (2, 200, 136, 264, 8, 88),
                    (16, 512, 6144, 10752, 128, 256), (16, 640, 6144, 10752, 128, 256)]


@pytest.mark.parametrize("shape", FWD_WGMMA_SHAPES)
def test_fused_moe_fwd_wgmma_matches_plain_and_mma_sync(dev, shape):
    """The forward wgmma engine (``csrc/fused_moe_wgmma.cu``): within bf16
    2e-2 of ``fused_moe_ref``'s max|ref| and of the mma.sync engine's output
    on the same inputs, bit-equal on a rerun; ``fused_moe_cuda`` picks it
    and its count moves, the mma.sync engine's does not; the library's
    shared bytes equal the plan's."""
    from repro_torch.kernels.fused_moe.ref import fused_moe_ref

    E, C, D, F, bm, bf = shape
    gen = torch.Generator(device=dev).manual_seed(4)  # dbrx's 3.2 G weights drawn on the card

    def randn(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)

    x = randn((E, C, D))
    ws = [randn(s, n ** -0.5) for s, n in (((E, D, F), D), ((E, D, F), D), ((E, F, D), F))]
    assert moe_kernel.fwd_engine(torch.bfloat16, C, D, F, block_f=bf) == "wgmma"
    n0, w0 = moe_kernel.launches, moe_kernel.wgmma_launches
    got = moe_kernel.fused_moe_cuda(x, *ws, block_m=bm, block_f=bf)
    again = moe_kernel.fused_moe_wgmma_cuda(x, *ws, block_m=bm, block_f=bf)
    assert (moe_kernel.launches, moe_kernel.wgmma_launches) == (n0, w0 + 2)
    assert moe_kernel.last_grid == moe_ops.grid_shape(E, C, D, F, block_m=bm, block_f=bf)
    old = moe_kernel.fused_moe_mma_sync_cuda(x, *ws, block_m=bm, block_f=bf)
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    _rel_close(got, fused_moe_ref(x, *ws), torch.bfloat16, "y")
    _rel_close(got, old, torch.bfloat16, "y against the mma.sync engine")
    lib = moe_kernel.fwd_wgmma_library()
    launch = moe_kernel.fwd_wgmma_plan(E, C, D, F, bm, bf)[0]
    assert lib.fused_moe_wgmma_smem_bytes(launch.consumers) == launch.smem <= moe_kernel.SMEM_LIMIT


def test_fused_moe_fwd_wgmma_trains_through_ops(dev):
    """``ops.fused_moe`` under grad on bf16 blocks of 128 rows: the forward
    on the wgmma engine, the backward on the backward's wgmma engine; the
    output and the gradients of x and the three weights equal the plain
    version's (``fused_moe_ref``, ``fused_moe_bwd_ref``)."""
    from repro_torch.kernels.fused_moe.ref import fused_moe_bwd_ref, fused_moe_ref

    E, C, D, F = 4, 256, 264, 512
    rng = np.random.default_rng(5)
    x = _randn(rng, (E, C, D), torch.bfloat16, dev).requires_grad_()
    ws = [_randn(rng, s, torch.bfloat16, dev, n ** -0.5).requires_grad_()
          for s, n in (((E, D, F), D), ((E, D, F), D), ((E, F, D), F))]
    dy = _randn(rng, (E, C, D), torch.bfloat16, dev)
    w0, b0 = moe_kernel.wgmma_launches, moe_kernel.bwd_wgmma_launches
    out = moe_ops.fused_moe(x, *ws, block_m=128, block_f=256)
    got = torch.autograd.grad(out, [x, *ws], dy)
    assert (moe_kernel.wgmma_launches, moe_kernel.bwd_wgmma_launches) == (w0 + 1, b0 + 1)
    plain = [t.detach() for t in (x, *ws)]
    _rel_close(out, fused_moe_ref(*plain), torch.bfloat16, "y")
    for name, a, r in zip(("dx", "dw_gate", "dw_up", "dw_down"), got,
                          fused_moe_bwd_ref(*plain, dy)):
        assert a.dtype == torch.bfloat16
        _rel_close(a, r, torch.bfloat16, name)


def test_fused_moe_fwd_wgmma_refuses_what_it_does_not_take(dev):
    """f32, bf16 F blocks that are not whole 16-byte chunks and bf16 rows
    that are not 16-byte multiples are not the forward wgmma engine's: it
    raises, and ``fused_moe_cuda`` takes the engine ``fwd_engine`` names
    for them (the 3xTF32 one for f32 with 16-byte rows, else mma.sync)."""
    rng = np.random.default_rng(3)
    for dtype, D, F, bf in ((torch.float32, 48, 96, 256), (torch.bfloat16, 48, 96, 12),
                            (torch.bfloat16, 36, 44, 256)):
        x = _randn(rng, (2, 64, D), dtype, dev)
        ws = [_randn(rng, s, dtype, dev, 0.2) for s in ((2, D, F), (2, D, F), (2, F, D))]
        with pytest.raises(ValueError, match="16-byte"):
            moe_kernel.fused_moe_wgmma_cuda(x, *ws, block_m=64, block_f=bf)
        engine = moe_kernel.fwd_engine(dtype, 64, D, F, block_f=bf)
        assert engine == ("wgmma_tf32" if dtype == torch.float32 else "mma_sync")
        before = _moe_fwd_counts()
        moe_kernel.fused_moe_cuda(x, *ws, block_m=64, block_f=bf)
        assert _moe_fwd_counts() == {e: n + (e == engine) for e, n in before.items()}


def test_fused_moe_bwd_wgmma_refuses_what_tma_cannot_address(dev):
    """f32, and bf16 rows that are not 16-byte multiples, are not the wgmma
    engine's: it raises, and ``fused_moe_bwd_cuda`` takes the engine
    ``bwd_engine`` picks for them (f32 with 16-byte rows: the 3xTF32 wgmma
    engine; the bf16 rows: the mma.sync engine)."""
    rng = np.random.default_rng(2)
    for dtype, D, F, count in ((torch.float32, 48, 96, "bwd_tf32_launches"),
                               (torch.bfloat16, 36, 44, "bwd_launches")):
        x, dy = _randn(rng, (2, 8, D), dtype, dev), _randn(rng, (2, 8, D), dtype, dev)
        ws = [_randn(rng, s, dtype, dev, 0.2) for s in ((2, D, F), (2, D, F), (2, F, D))]
        with pytest.raises(ValueError, match="16-byte"):
            moe_kernel.fused_moe_bwd_wgmma_cuda(x, *ws, dy)
        b0 = getattr(moe_kernel, count)
        moe_kernel.fused_moe_bwd_cuda(x, *ws, dy)
        assert getattr(moe_kernel, count) == b0 + 1


def test_scaled_mm_raises_under_grad(dev):
    xi = torch.randint(-127, 128, (64, 64), dtype=torch.int8, device=dev)
    wi = torch.randint(-127, 128, (64, 64), dtype=torch.int8, device=dev)
    sx = torch.ones(64, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="scaled_mm"):
        smm_ops.scaled_mm(xi, wi, sx, torch.ones(64, device=dev))


# ----------------------------------------------------------------------
# the predictor-coverage pre-flight on the card
# ----------------------------------------------------------------------


def test_continuous_engine_audit_on_the_card(dev):
    """``ContinuousBatchingEngine(device="cuda", audit=True)`` on the smoke
    config serves through predicted admission; a stale ``CommRegressor``
    raises ``AuditError`` before any CUDA allocation."""
    from repro_torch.analysis import AuditError
    from repro_torch.configs import get_arch
    from repro_torch.core.hardware import get_hw
    from repro_torch.predict import CommRegressor, get_predictor
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request

    cfg = get_arch("qwen3-0.6b").smoke()
    hw = get_hw("tpu-v5e")
    stale = CommRegressor().fit(hw)
    for k in [k for k in stale.theta if k[0] == "all_to_all"]:
        del stale.theta[k]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    with pytest.raises(AuditError, match="all_to_all"):
        ContinuousBatchingEngine(cfg, admission="predicted", decode_slo_s=0.5, audit=True,
                                 predictor=get_predictor("roofline", hw, comm=stale),
                                 device="cuda")
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == held
    eng = ContinuousBatchingEngine(cfg, admission="predicted", decode_slo_s=0.5, audit=True,
                                   predictor=get_predictor("roofline", hw), device="cuda")
    assert eng.admission == "predicted" and eng.tp == 1
    rng = np.random.default_rng(0)
    for rid in range(3):
        eng.submit(Request(rid, rng.integers(1, cfg.vocab_size, 9 + rid), max_new=4))
    results = eng.run_to_completion()
    assert sorted(r.rid for r in results) == [0, 1, 2]
    assert all(len(r.tokens) == 4 for r in results)
