"""The port's kernel entry points on the CPU (their plain versions) against
the reference's Pallas kernels run in interpret mode, on the same numpy
inputs. Cases are the reference's (``tests/test_kernels.py``); tolerances
are its kernel tolerances: f32 2e-5, bf16 2e-2. The kernels themselves are
held against these plain versions on the card in ``test_torch_cuda.py``."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import largest_divisor_block as ref_largest_divisor_block
from repro.kernels.flash_attention import ops as ref_fa
from repro.kernels.fused_moe import ops as ref_moe
from repro.kernels.rmsnorm import ops as ref_rms
from repro.kernels.scaled_mm import ops as ref_smm
from repro.kernels.silu_mul import ops as ref_silu
from repro_torch.kernels import _build, largest_divisor_block
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fused_moe import kernel as moe_kernel
from repro_torch.kernels.fused_moe import ops as moe_ops
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.scaled_mm import kernel as smm_kernel
from repro_torch.kernels.scaled_mm import ops as smm_ops
from repro_torch.kernels.scaled_mm.ref import quantize_rowwise, scaled_mm_acc_ref
from repro_torch.kernels.silu_mul import kernel as silu_kernel
from repro_torch.kernels.silu_mul import ops as silu_ops

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _both(a: np.ndarray, name: str):
    """One numpy array as a jax array and a torch tensor of the same type
    (both round f32 to bf16 to nearest even, so the bits agree)."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _check(ref, out, name):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **_tol(name))


FA_CASES = [
    # (B, S, Skv, Hq, Hkv, D, causal, window, softcap), as tests/test_kernels.py
    (1, 64, 64, 2, 2, 16, True, None, None),
    (2, 128, 128, 4, 2, 32, True, None, None),
    (1, 64, 64, 2, 1, 16, True, 32, None),
    (1, 64, 64, 2, 2, 16, True, None, 30.0),
    (2, 64, 64, 4, 4, 16, False, None, None),
    (1, 32, 128, 2, 2, 16, False, None, None),
]


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_attention_matches_reference_kernel(case, name):
    B, S, Skv, Hq, Hkv, D, causal, window, softcap = case
    rng = np.random.default_rng(0)
    q, qt = _both(rng.standard_normal((B, S, Hq, D)).astype(np.float32), name)
    k, kt = _both(rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32), name)
    v, vt = _both(rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32), name)
    kw = dict(causal=causal, window=window, softcap=softcap)
    ref = ref_fa.attention(q, k, v, block_q=32, block_k=32, interpret=True, use_pallas=True, **kw)
    n0 = fa_kernel.launches
    out = fa_ops.attention(qt, kt, vt, block_q=32, block_k=32, **kw)
    assert fa_kernel.launches == n0  # a CPU tensor takes the plain version
    _check(ref, out, name)


@pytest.mark.parametrize("shape", [(4, 32, 64), (2, 7, 48), (128, 16)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_f32", [False, True])
def test_rmsnorm_matches_reference_kernel(shape, name, w_f32):
    rng = np.random.default_rng(4)
    x, xt = _both(rng.standard_normal(shape).astype(np.float32), name)
    w, wt = _both((0.1 * rng.standard_normal(shape[-1:])).astype(np.float32),
                  "float32" if w_f32 else name)
    ref = ref_rms.rmsnorm(x, w, block_rows=8, interpret=True, use_pallas=True)
    n0 = rms_kernel.launches
    out = rms_ops.rmsnorm(xt, wt, block_rows=8)
    assert rms_kernel.launches == n0 and out.dtype == xt.dtype
    _check(ref, out, name)


@pytest.mark.parametrize("act", ["silu", "geglu"])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_act_mul_matches_reference_kernel(act, name):
    rng = np.random.default_rng(5)
    g, gt = _both(rng.standard_normal((4, 32, 64)).astype(np.float32), name)
    u, ut = _both(rng.standard_normal((4, 32, 64)).astype(np.float32), name)
    ref = ref_silu.act_mul(g, u, act=act, block_rows=16, interpret=True, use_pallas=True)
    n0 = silu_kernel.launches
    out = silu_ops.act_mul(gt, ut, act=act, block_rows=16)
    assert silu_kernel.launches == n0 and out.dtype == gt.dtype
    _check(ref, out, name)


MOE_CASES = [
    # (E, C, D, F, block_m, block_f), as tests/test_kernels.py
    (4, 32, 64, 128, 16, 64),
    (2, 64, 32, 64, 32, 32),
    (8, 16, 48, 96, 16, 96),
]


@pytest.mark.parametrize("case", MOE_CASES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_fused_moe_matches_reference_kernel(case, name):
    E, C, D, F, bm, bf = case
    rng = np.random.default_rng(3)
    x, xt = _both((0.5 * rng.standard_normal((E, C, D))).astype(np.float32), name)
    wg, wgt = _both((0.1 * rng.standard_normal((E, D, F))).astype(np.float32), name)
    wu, wut = _both((0.1 * rng.standard_normal((E, D, F))).astype(np.float32), name)
    wd, wdt = _both((0.1 * rng.standard_normal((E, F, D))).astype(np.float32), name)
    ref = ref_moe.fused_moe(x, wg, wu, wd, block_m=bm, block_f=bf, interpret=True, use_pallas=True)
    n0 = moe_kernel.launches
    out = moe_ops.fused_moe(xt, wgt, wut, wdt, block_m=bm, block_f=bf)
    assert moe_kernel.launches == n0 and out.dtype == xt.dtype
    _check(ref, out, name)


SMM_SHAPES = [(64, 128, 96), (128, 64, 128)]  # (M, K, N), as tests/test_kernels.py
SMM_BLOCKS = [(32, 32, 64), (64, 64, 32)]


def _int8_operands(M, K, N, seed=7):
    """Row-quantized x (M, K) and w (K, N) with their scales, as numpy."""
    rng = np.random.default_rng(seed)
    x, sx = quantize_rowwise(torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)))
    wq, sw = quantize_rowwise(torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)))
    return x.numpy(), wq.t().contiguous().numpy(), sx.numpy(), sw.numpy()


@pytest.mark.parametrize("shape", SMM_SHAPES)
@pytest.mark.parametrize("blocks", SMM_BLOCKS)
def test_scaled_mm_matches_reference_kernel(shape, blocks):
    M, K, N = shape
    bm, bn, bk = blocks
    x, w, sx, sw = _int8_operands(M, K, N)
    acc = jnp.matmul(jnp.asarray(x, jnp.int32), jnp.asarray(w, jnp.int32),
                     preferred_element_type=jnp.int32)
    port_acc = scaled_mm_acc_ref(torch.from_numpy(x), torch.from_numpy(w))
    assert port_acc.dtype == torch.int32
    np.testing.assert_array_equal(port_acc.numpy(), np.asarray(acc))
    ref = ref_smm.scaled_mm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sx), jnp.asarray(sw),
                            block_m=bm, block_n=bn, block_k=bk, interpret=True, use_pallas=True)
    n0 = smm_kernel.launches
    out = smm_ops.scaled_mm(*(torch.from_numpy(a) for a in (x, w, sx, sw)),
                            block_m=bm, block_n=bn, block_k=bk)
    assert smm_kernel.launches == n0 and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=1e-2, atol=1e-2)


def test_quantize_rowwise_matches_reference():
    from repro.kernels.scaled_mm.ref import quantize_rowwise as ref_quantize

    a = np.random.default_rng(8).standard_normal((64, 128)).astype(np.float32)
    q, s = quantize_rowwise(torch.from_numpy(a))
    rq, rs = ref_quantize(jnp.asarray(a))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


HELPER_CASES = [
    ("flash_attention", dict(B=2, S=512, Skv=512, Hq=8, Hkv=4, D=64),
     [dict(), dict(block_q=64, block_k=256), dict(block_q=96)]),
    ("fused_moe", dict(E=16, C=256, D=6144, F=10752),
     [dict(), dict(block_m=32, block_f=512), dict(block_m=96)]),
    ("scaled_mm", dict(M=1000, K=6144, N=10752),
     [dict(), dict(block_m=512, block_n=32, block_k=96)]),
    ("rmsnorm", dict(R=4100, d=1024), [dict(), dict(block_rows=64)]),
    ("silu_mul", dict(R=4096, d=3072), [dict(), dict(block_rows=100)]),
]


@pytest.mark.parametrize("kernel, kw, block_sets", HELPER_CASES, ids=[c[0] for c in HELPER_CASES])
def test_static_helpers_equal_reference(kernel, kw, block_sets):
    """``grid_shape``/``vmem_footprint`` are the reference's, copied."""
    from repro_torch.analysis.kernels import KERNEL_HELPERS

    from repro.analysis.kernels import KERNEL_HELPERS as REF_HELPERS

    (grid, vmem), (ref_grid, ref_vmem) = KERNEL_HELPERS[kernel], REF_HELPERS[kernel]
    for blocks in block_sets:
        try:
            expect = ref_grid(**kw, **blocks)
        except ValueError:
            with pytest.raises(ValueError):
                grid(**kw, **blocks)
            continue
        assert grid(**kw, **blocks) == expect
        assert vmem(**kw, **blocks) == ref_vmem(**kw, **blocks)


def test_largest_divisor_block_matches_reference():
    for total in (1, 7, 12, 48, 96, 1000):
        for block in (1, 5, 8, 16, 256):
            assert largest_divisor_block(total, block) == ref_largest_divisor_block(total, block)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never computes the plain
    version itself, so only the ops entry points dispatch to it."""
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError):
        rms_kernel.rmsnorm_cuda(x, torch.zeros(16))
    with pytest.raises(ValueError):
        silu_kernel.silu_mul_cuda(x, x)
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_cuda(q, q, q)
    x = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):
        moe_kernel.fused_moe_cuda(x, torch.zeros(2, 16, 32), torch.zeros(2, 16, 32),
                                  torch.zeros(2, 32, 16))
    a = torch.zeros(8, 16, dtype=torch.int8)
    with pytest.raises(ValueError):
        smm_kernel.scaled_mm_cuda(a, a.t().contiguous(), torch.ones(8), torch.ones(8))


def test_silu_mul_wrapper_rejects_unknown_activation():
    """The wrapper names the activation it cannot compute instead of
    computing silu for it."""
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="unknown activation 'relu'"):
        silu_kernel.silu_mul_cuda(x, x, act="relu")


def test_cuda_library_path_follows_the_source(tmp_path: Path, monkeypatch):
    """The build cache is keyed by source content: an edit rebuilds."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("extern \"C\" int f() { return 0; }\n")
    first = _build.library_path("k", [src])
    assert first == _build.library_path("k", [src])
    src.write_text("extern \"C\" int f() { return 1; }\n")
    assert _build.library_path("k", [src]) != first
    assert first.parent == tmp_path / "build" and not first.exists()


def test_flash_attention_sources_are_in_the_package():
    assert all(p.is_file() and p.suffix == ".cu" for p in fa_kernel.SOURCES)
    assert _build.library_path("flash_attention", fa_kernel.SOURCES).suffix == ".so"


@pytest.mark.parametrize("name, mod", [("fused_moe", moe_kernel), ("scaled_mm", smm_kernel)])
def test_moe_and_scaled_mm_sources_are_in_the_package(name, mod):
    assert all(p.is_file() and p.suffix == ".cu" for p in mod.SOURCES)
    assert _build.library_path(name, mod.SOURCES).suffix == ".so"
