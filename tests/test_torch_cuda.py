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
