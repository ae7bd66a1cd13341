"""The port's Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device each test skips with its reason. On a
machine with one (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

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
]


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, case, dtype):
    B, S, Skv, Hq, Hkv, D, causal, window, softcap = case
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, S, Hq, D), dtype, dev)
    k = _randn(rng, (B, Skv, Hkv, D), dtype, dev)
    v = _randn(rng, (B, Skv, Hkv, D), dtype, dev)
    kw = dict(causal=causal, window=window, softcap=softcap)
    n0 = fa_kernel.launches
    out = fa_ops.attention(q, k, v, **kw)
    assert fa_kernel.launches == n0 + 1
    ref = fa_ops.attention(q.cpu(), k.cpu(), v.cpu(), **kw)
    _close(out.cpu(), ref, dtype)


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
]


@pytest.mark.parametrize("case", MOE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_moe_kernel_matches_plain(dev, case, dtype):
    E, C, D, F, bm, bf = case
    rng = np.random.default_rng(3)
    x = _randn(rng, (E, C, D), dtype, dev, 0.5)
    wg, wu = _randn(rng, (E, D, F), dtype, dev, 0.1), _randn(rng, (E, D, F), dtype, dev, 0.1)
    wd = _randn(rng, (E, F, D), dtype, dev, 0.1)
    n0 = moe_kernel.launches
    out = moe_ops.fused_moe(x, wg, wu, wd, block_m=bm, block_f=bf)
    assert moe_kernel.launches == n0 + 1
    assert moe_kernel.last_grid == moe_ops.grid_shape(E, C, D, F, block_m=bm, block_f=bf)
    ref = moe_ops.fused_moe(*(t.cpu() for t in (x, wg, wu, wd)))
    _close(out.cpu(), ref, dtype)


SMM_CASES = [
    # (M, K, N, block_m, block_n, block_k)
    (64, 128, 96, 32, 32, 64),
    (128, 64, 128, 64, 64, 32),
    (1024, 512, 512, 128, 128, 256),
    (1024, 512, 512, 512, 512, 512),
    (1024, 512, 512, 32, 32, 32),
    (7, 100, 13, 3, 5, 7),
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


def test_tuner_times_the_kernels_on_the_card(dev):
    """One small tune() per new kernel on the card: every measured config
    launched (1 + repeats) times with the grid its blocks give."""
    from repro_torch.core.hardware import REGISTRY
    from repro_torch.predict.backends import get_predictor
    from repro_torch.tune import measure, tune

    hw = REGISTRY["tpu-v4"]
    for kernel, mod, ops, kw in [
        ("fused_moe", moe_kernel, moe_ops, {"E": 2, "C": 64, "D": 64, "F": 128}),
        ("scaled_mm", smm_kernel, smm_ops, {"M": 128, "K": 256, "N": 128}),
    ]:
        grids = []

        def timed(kernel, kw, blocks, **k):
            s = measure(kernel, kw, blocks, **k)
            grids.append((mod.last_grid, ops.grid_shape(**kw, **blocks)))
            return s

        n0 = mod.launches
        report = tune(kernel, hw, workload=kw, predictor=get_predictor("roofline", hw),
                      top_k=3, repeats=2, measure_fn=timed)
        distinct = {tuple(sorted(c.blocks.items())) for c in report.measured}
        distinct.add(tuple(sorted(report.default_blocks.items())))
        assert mod.launches - n0 == 3 * len(distinct) == 3 * len(grids)
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
