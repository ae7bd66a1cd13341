"""The port's kernel entry points on the CPU (their plain versions) against
the reference's Pallas kernels run in interpret mode, on the same numpy
inputs. Cases are the reference's (``tests/test_kernels.py``); tolerances
are its kernel tolerances: f32 2e-5, bf16 2e-2. The kernels themselves are
held against these plain versions on the card in ``test_torch_cuda.py``."""
import math
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
from test_torch_cuda import FA_CASES as CARD_FA_CASES
from test_torch_cuda import _attention_f64

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
    n0 = (fa_kernel.launches, fa_kernel.wgmma_launches)
    out = fa_ops.attention(qt, kt, vt, block_q=32, block_k=32, **kw)
    # a CPU tensor takes the plain version: neither engine launches
    assert (fa_kernel.launches, fa_kernel.wgmma_launches) == n0
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


def test_backward_sources_build_apart_from_their_forwards():
    """Each backward is its own library, so that phase 1 builds it beside
    its forward: a source of its own, another name, another library."""
    for name, mod in (("flash_attention", fa_kernel), ("fused_moe", moe_kernel)):
        assert all(p.is_file() and p.suffix == ".cu" for p in mod.BWD_SOURCES)
        assert not set(mod.BWD_SOURCES) & set(mod.SOURCES)
        assert (_build.library_path(name + "_bwd", mod.BWD_SOURCES)
                != _build.library_path(name, mod.SOURCES))


# ----------------------------------------------------------------------
# launch geometry: every knob reaches the launch
# ----------------------------------------------------------------------


def _lattice_workloads():
    from repro_torch.tune import DEFAULT_WORKLOADS, arch_workload

    cases = []
    for kernel in ("flash_attention", "fused_moe", "silu_mul", "scaled_mm"):
        cases.append((kernel, "default", DEFAULT_WORKLOADS[kernel]))
        for arch in ("qwen3-0.6b", "dbrx-132b"):
            if kernel == "fused_moe" and arch == "qwen3-0.6b":
                continue  # a dense arch launches no fused_moe
            cases.append((kernel, arch, arch_workload(kernel, arch)))
    return cases


LATTICE_CASES = _lattice_workloads()


def _plan_grid(kernel, kw, blocks):
    if kernel == "flash_attention":
        return fa_kernel.launch_plan(**kw, **blocks).grid
    if kernel == "fused_moe":
        return moe_kernel.launch_plan(**kw, **blocks).grid
    if kernel == "scaled_mm":
        return smm_kernel.launch_plan(**kw, **blocks).grid
    return silu_kernel.launch_plan(**kw, **blocks).grid


@pytest.mark.parametrize("kernel, name, kw", LATTICE_CASES,
                         ids=[f"{k}-{n}" for k, n, _ in LATTICE_CASES])
def test_launch_geometry_equals_reference_grid_over_the_lattice(kernel, name, kw):
    """For every config the tuner's SP2xx prefilter passes, the wrapper's
    launch geometry is the reference's ``grid_shape``: each knob changes
    the launch, none is clamped beyond ``min(block, dim)``."""
    from repro_torch.tune import enumerate_candidates, prefilter

    ref_helpers = {"flash_attention": ref_fa, "fused_moe": ref_moe, "silu_mul": ref_silu,
                   "scaled_mm": ref_smm}
    survivors, _ = prefilter(kernel, kw, enumerate_candidates(kernel))
    assert survivors
    for c in survivors:
        grid = _plan_grid(kernel, kw, c.blocks)
        assert grid == ref_helpers[kernel].grid_shape(**kw, **c.blocks), (kw, c.blocks)


@pytest.mark.parametrize("D", fa_kernel.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_plan_takes_every_lattice_pair(D, dtype):
    """Every (block_q, block_k) of the lattice that divides the shape has a
    plan the kernel takes: a register sub-tile it was built for (a step
    wider than it runs in two passes) and at most 8 warps."""
    from repro_torch.tune.space import BLOCK_VALUES

    B, S, Hq, Hkv = 2, 512, 4, 2
    for bq in BLOCK_VALUES:
        for bk in BLOCK_VALUES:
            plan = fa_kernel.launch_plan(B, S, S, Hq, Hkv, D, block_q=bq, block_k=bk, dtype=dtype)
            assert plan.grid == ref_fa.grid_shape(B, S, S, Hq, Hkv, D, block_q=bq, block_k=bk)
            assert (plan.block_q, plan.block_k) == (bq, bk)
            if dtype == torch.float32:
                assert (plan.kt, plan.warps) == (64, 8)
            else:
                assert plan.kt in ((32, 64, 128) if D <= 128 else (32, 64))
                assert plan.warps == min(8, bq // 16)


def test_flash_attention_plan_masks_ragged_lengths():
    """Serving lengths need not divide a block: the grid rounds up and the
    kernel masks the rest (prompts of 781-2004 tokens)."""
    plan = fa_kernel.launch_plan(1, 781, 781, 16, 8, 128)
    assert plan.grid == (16, 7, 7) and plan.block_q == plan.block_k == 128
    small = fa_kernel.launch_plan(1, 40, 40, 2, 2, 8)
    assert small.grid == (2, 1, 1) and (small.block_q, small.kt, small.warps) == (40, 64, 3)
    with pytest.raises(ValueError):
        fa_kernel.launch_plan(1, 64, 64, 2, 2, 24)


#: the card tests' f32 cases the CPU takes in well under a second (the
#: 4608- and 2048-token ones are left to the card)
PLAIN_F64_CASES = [c for c in CARD_FA_CASES if c[0] * c[3] * c[1] * c[2] <= 2e7]


@pytest.mark.parametrize("case", PLAIN_F64_CASES)
def test_flash_attention_plain_version_stays_near_float64(case):
    """The plain version in f32 on the CPU (the card tests' yardstick for
    bf16) against the same function in float64 (``_attention_f64``), within
    1e-5: f32 rounding over at most 1601 keys and 256 columns, which lands
    under 1.3e-6 here. On the card host's torch 2.11 it has landed 4.27e-5
    from float64 on case 0 (ROADMAP.md queue C)."""
    B, S, Skv, Hq, Hkv, D, causal, window, softcap = case
    rng = np.random.default_rng(0)  # the card test's draws
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((B, S, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    plain = fa_ops.attention(q, k, v, **kw)
    exact = _attention_f64(q, k, v, **kw)
    assert plain.dtype == torch.float32
    assert float((plain.double() - exact).abs().max()) <= 1e-5


def test_flash_attention_fwd_engine_follows_type_head_dim_and_alignment():
    """bf16 at head dims 64, 80, 128 and 256 whose bases are 16-byte
    multiples takes the wgmma engine, f32 at 64, 80 and 128 the 3xTF32
    engine; head dims 8-32, f32 at 256 and other bases take the mma.sync
    engine."""
    engine = fa_kernel.fwd_engine
    bf16 = torch.bfloat16
    assert engine(bf16, 64) == engine(bf16, 80) == engine(bf16, 128) == engine(bf16, 256)
    assert engine(bf16, 64) == "wgmma"
    for D in (8, 16, 32):
        assert engine(bf16, D) == "mma_sync"
    for D in fa_kernel.HEAD_DIMS:
        assert engine(torch.float32, D) == ("tf32" if D in (64, 80, 128) else "mma_sync")
        assert engine(torch.float32, D, False) == "mma_sync"
    assert engine(bf16, 64, False) == engine(bf16, 80, False) == "mma_sync"
    assert engine(bf16, 128, False) == "mma_sync"
    assert engine(bf16, 256, False) == "mma_sync"
    assert engine(torch.float16, 128) == "mma_sync"


#: the engine table: (dtype, D, aligned) -> (forward engine, backward engine)
ENGINE_TABLE = {
    (dt, D, aligned): (
        "mma_sync" if not aligned else
        ("wgmma" if D in (64, 80, 128, 256) else "mma_sync") if dt == torch.bfloat16 else
        ("tf32" if D in (64, 80, 128) else "mma_sync"),
        "mma_sync" if not aligned else
        ("wgmma" if D in (64, 80, 128, 256) else "mma_sync") if dt == torch.bfloat16 else
        ("tf32" if D in (80, 128) else "mma_sync"))
    for dt in (torch.float32, torch.bfloat16) for D in fa_kernel.HEAD_DIMS
    for aligned in (True, False)}


@pytest.mark.parametrize("key", list(ENGINE_TABLE), ids=lambda k: f"{k[0]}-D{k[1]}-{k[2]}")
def test_flash_attention_engines_follow_the_table(key):
    """Both directions' engines for every (type, head dim, alignment): bf16
    at 64, 80, 128 and 256 on wgmma; f32 forward at 64, 80 and 128 and f32
    backward at 80 and 128 on 3xTF32; the rest (head dims 8-32, f32 at 256,
    the f32 backward at 64, unaligned bases) on mma.sync."""
    dt, D, aligned = key
    assert (fa_kernel.fwd_engine(dt, D, aligned), fa_kernel.bwd_engine(dt, D, aligned)) == \
        ENGINE_TABLE[key]


@pytest.mark.parametrize("D", fa_kernel.FWD_TF32_HEAD_DIMS)
def test_flash_attention_fwd_tf32_plan_fits_and_launches_heaviest_first(D):
    """The forward 3xTF32 engine's shared bytes (alignment slack, Q and its
    lo of 64 rows, a two-stage ring of K, K lo, V^T and V^T lo tiles,
    fifteen barriers; a row of K in boxes of 32 f32 columns, so D 80 takes
    96, and V^T's D rows in boxes of 32 keys) fit a Hopper block; the last
    q block launches first, a ragged one last; the grid is the reference's
    first two grid dims; a step of block_k keys takes tiles of 64 keys at D
    64 and 32 at 80 and 128, one consumer warpgroup walking 64 q rows."""
    bn = {64: 64, 80: 32, 128: 32}[D]
    assert fa_kernel.FWD_TF32_TILE_KEYS[D] == bn
    padded = -(-D // 32) * 32
    plan = fa_kernel.fwd_tf32_plan(4, 2048, 2048, 16, 8, D)
    assert plan.smem == (1024 + 2 * 64 * padded * 4 + 2 * 2 * (bn * padded * 4 + bn * D * 4)
                         + 8 * 15)
    assert plan.smem <= fa_kernel.SMEM_LIMIT
    assert (plan.sub_rows, plan.tile_keys, plan.stages, plan.warpgroups) == (64, bn, 2, 1)
    assert plan.grid == (64, 16) and plan.order == tuple(range(15, -1, -1))
    assert plan.tiles_per_step == 128 // bn
    ragged = fa_kernel.fwd_tf32_plan(1, 4600, 4600, 8, 4, D)
    assert ragged.order == (*range(34, -1, -1), 35)
    other = fa_kernel.fwd_tf32_plan(1, 512, 512, 2, 1, D, block_q=64, block_k=96)
    assert other.grid == (2, 8) and other.tiles_per_step == -(-96 // bn)
    for bad in (32, 256):
        with pytest.raises(ValueError):
            fa_kernel.fwd_tf32_plan(1, 64, 64, 2, 1, bad)


@pytest.mark.parametrize("D", fa_kernel.FWD_WGMMA_HEAD_DIMS)
def test_flash_attention_fwd_wgmma_plan_fits_and_launches_heaviest_first(D):
    """The forward wgmma engine's shared bytes (alignment slack, two Q
    tiles of 64 rows, a two-stage ring of K and V tiles, ten barriers; a
    row in boxes of 64 columns, so D 80 takes 128) fit a Hopper block at
    each head dim; the last q block, whose rows see the most causal keys,
    launches first, a ragged one last; the grid is the reference's first
    two grid dims; a step of block_k keys takes whole tiles of 128 keys at
    D 64, 80 and 128 and 64 at D 256."""
    bn = {64: 128, 80: 128, 128: 128, 256: 64}[D]
    assert fa_kernel.FWD_WGMMA_TILE_KEYS[D] == bn
    padded = {64: 64, 80: 128, 128: 128, 256: 256}[D]
    plan = fa_kernel.fwd_wgmma_plan(4, 2048, 2048, 16, 8, D)
    assert plan.smem == 1024 + 2 * 64 * padded * 2 + 2 * 2 * bn * padded * 2 + 8 * 10
    assert plan.smem <= fa_kernel.SMEM_LIMIT
    assert (plan.sub_rows, plan.tile_keys, plan.stages, plan.warpgroups) == (128, bn, 2, 2)
    assert plan.grid == (64, 16) and plan.order == tuple(range(15, -1, -1))
    assert plan.tiles_per_step == 128 // bn
    ragged = fa_kernel.fwd_wgmma_plan(1, 4600, 4600, 8, 4, D)
    assert ragged.order == (*range(34, -1, -1), 35)
    other = fa_kernel.fwd_wgmma_plan(1, 512, 512, 2, 1, D, block_q=64, block_k=96)
    assert other.grid == (2, 8) and other.tiles_per_step == -(-96 // bn)
    with pytest.raises(ValueError):
        fa_kernel.fwd_wgmma_plan(1, 64, 64, 2, 1, 32)


FA_LATTICE_CASES = [c for c in LATTICE_CASES if c[0] == "flash_attention"]


@pytest.mark.parametrize("kernel, name, kw", FA_LATTICE_CASES, ids=[n for _, n, _ in FA_LATTICE_CASES])
@pytest.mark.parametrize("D", fa_kernel.FWD_WGMMA_HEAD_DIMS)
def test_flash_attention_fwd_wgmma_grid_is_the_reference_grid(kernel, name, kw, D):
    """Over every config the tuner's prefilter passes, at each of the
    wgmma engine's head dims, its CUDA grid is the reference's
    ``grid_shape`` less the KV axis (which its CTAs walk) and its blocks
    are the knobs after the ``min(block, dim)`` clamp."""
    from repro_torch.tune import enumerate_candidates, prefilter

    survivors, _ = prefilter(kernel, kw, enumerate_candidates(kernel))
    assert survivors
    shape = {**kw, "D": D}
    for c in survivors:
        plan = fa_kernel.fwd_wgmma_plan(**shape, **c.blocks)
        grid = ref_fa.grid_shape(**shape, **c.blocks)
        assert plan.grid == grid[:2], (shape, c.blocks)
        assert (plan.block_q, plan.block_k) == (min(c.blocks["block_q"], kw["S"]),
                                                min(c.blocks["block_k"], kw["Skv"]))


@pytest.mark.parametrize("kernel, name, kw", FA_LATTICE_CASES, ids=[n for _, n, _ in FA_LATTICE_CASES])
@pytest.mark.parametrize("D", fa_kernel.FWD_TF32_HEAD_DIMS)
def test_flash_attention_fwd_tf32_grid_is_the_reference_grid(kernel, name, kw, D):
    """Over every config the tuner's prefilter passes (the tuner, which
    times f32 inputs, is this engine's main user), at each of the 3xTF32
    engine's head dims, its CUDA grid is the reference's ``grid_shape``
    less the KV axis and ``launch_plan``'s, its blocks the knobs after the
    ``min(block, dim)`` clamp, and its shared bytes fit a block."""
    from repro_torch.tune import enumerate_candidates, prefilter

    survivors, _ = prefilter(kernel, kw, enumerate_candidates(kernel))
    assert survivors
    shape = {**kw, "D": D}
    for c in survivors:
        plan = fa_kernel.fwd_tf32_plan(**shape, **c.blocks)
        grid = ref_fa.grid_shape(**shape, **c.blocks)
        assert plan.grid == grid[:2] == fa_kernel.launch_plan(
            **shape, **c.blocks, dtype=torch.float32).grid[:2], (shape, c.blocks)
        assert (plan.block_q, plan.block_k) == (min(c.blocks["block_q"], kw["S"]),
                                                min(c.blocks["block_k"], kw["Skv"]))
        assert plan.smem <= fa_kernel.SMEM_LIMIT


#: (S, Skv, causal, window, q_offset, block_q, block_k): square and not,
#: each mask, rows that see no key, an offset, ragged lengths, knobs that
#: cut a step into several tiles or a tile at a step's end
FWD_WALKS = [(300, 300, True, None, 0, 128, 128), (300, 300, True, 64, 0, 128, 128),
             (200, 50, False, 10, 0, 128, 128), (200, 50, True, 10, 0, 64, 32),
             (77, 200, False, 50, 0, 256, 96), (64, 96, True, 32, 100, 128, 128),
             (130, 200, False, 64, 40, 512, 512), (4608, 4608, True, 4096, 0, 128, 128),
             (1, 300, True, None, 299, 128, 128)]


@pytest.mark.parametrize("case", FWD_WALKS)
@pytest.mark.parametrize("D", fa_kernel.FWD_WGMMA_HEAD_DIMS)
def test_flash_attention_fwd_wgmma_tiles_cover_every_visible_pair_once(case, D):
    """``fwd_wgmma_tiles`` (the source's ``Walk``): every row lies in one
    sub-block; a sub-block's tiles are disjoint, each inside one step and
    at most ``tile_keys`` wide; every key a row sees lies in one of them,
    and every key where a row sees none; every tile holds a key that a row
    of its sub-block sees (or the sub-block holds a row that sees none)."""
    from repro_torch.kernels.flash_attention.ref import visible_mask

    S, Skv, causal, window, off, bq, bk = case
    plan = fa_kernel.fwd_wgmma_plan(1, S, Skv, 2, 1, D, block_q=bq, block_k=bk)
    mask = visible_mask(S, Skv, causal, window, off, "cpu").numpy()
    rows = np.zeros(S, dtype=np.int64)
    for r0, n, tiles in fa_kernel.fwd_wgmma_tiles(plan, S, Skv, causal=causal, window=window,
                                                  q_offset=off):
        rows[r0:r0 + n] += 1
        sub = mask[r0:r0 + n]
        need = sub.any(axis=0) | (~sub.any(axis=1)).any()
        seen = np.zeros(Skv, dtype=np.int64)
        for k0, nk in tiles:
            assert 0 < nk <= plan.tile_keys
            assert k0 // plan.block_k == (k0 + nk - 1) // plan.block_k
            assert need[k0:k0 + nk].any()
            seen[k0:k0 + nk] += 1
        assert (seen <= 1).all() and (seen[need] == 1).all()
    assert (rows == 1).all()


@pytest.mark.parametrize("case", FWD_WALKS)
@pytest.mark.parametrize("D", fa_kernel.FWD_TF32_HEAD_DIMS)
def test_flash_attention_fwd_tf32_tiles_cover_every_visible_pair_once(case, D):
    """The 3xTF32 forward walks the source's ``Walk`` over its own plan (64
    rows a sub-block, tiles of 64 or 32 keys): every row lies in one
    sub-block; a sub-block's tiles are disjoint, each inside one step and
    at most ``tile_keys`` wide; every key a row sees lies in one of them, and
    every key where a row sees none; every tile holds a key that a row of its
    sub-block sees (or the sub-block holds a row that sees none)."""
    from repro_torch.kernels.flash_attention.ref import visible_mask

    S, Skv, causal, window, off, bq, bk = case
    plan = fa_kernel.fwd_tf32_plan(1, S, Skv, 2, 1, D, block_q=bq, block_k=bk)
    assert plan.sub_rows == 64 and plan.tile_keys == fa_kernel.FWD_TF32_TILE_KEYS[D]
    mask = visible_mask(S, Skv, causal, window, off, "cpu").numpy()
    rows = np.zeros(S, dtype=np.int64)
    for r0, n, tiles in fa_kernel.fwd_wgmma_tiles(plan, S, Skv, causal=causal, window=window,
                                                  q_offset=off):
        rows[r0:r0 + n] += 1
        sub = mask[r0:r0 + n]
        need = sub.any(axis=0) | (~sub.any(axis=1)).any()
        seen = np.zeros(Skv, dtype=np.int64)
        for k0, nk in tiles:
            assert 0 < nk <= plan.tile_keys
            assert k0 // plan.block_k == (k0 + nk - 1) // plan.block_k
            assert need[k0:k0 + nk].any()
            seen[k0:k0 + nk] += 1
        assert (seen <= 1).all() and (seen[need] == 1).all()
    assert (rows == 1).all()


#: (B, S, Skv, Hq, Hkv, q_offset, causal, window): the backward's walks
#: over ragged lengths, each mask, rows that see no key and offsets
BWD_TF32_WALKS = [(2, 256, 256, 16, 8, 0, True, None), (1, 300, 300, 4, 2, 0, True, 64),
                  (1, 200, 50, 2, 1, 0, False, 10), (1, 200, 50, 6, 1, 0, True, 10),
                  (1, 77, 200, 2, 1, 0, False, 50), (1, 64, 96, 2, 1, 100, True, 32),
                  (1, 130, 200, 2, 1, 40, False, 64), (1, 128, 128, 48, 8, 0, True, None)]


def _bwd_tf32_walks(plan, B, S, Skv, Hq, Hkv, causal, window, q_offset):
    """The pairs the 3xTF32 backward's two launches cover, as its source's
    ``KeyWalk`` (dQ) and ``QWalk`` (dK/dV, its grid's z splitting each
    group's q heads) walk them: two ``(B, Hq, S, Skv)`` counts."""
    dq, dkdv = plan[0], plan[1]
    step, rows, w = dq.step, dq.rows, window or 0

    def sees(p0, p1, k0, k1):
        return (not causal or k0 <= p1) and (w <= 0 or k1 > p0 - w)

    def no_key(p):
        return w > 0 and p >= Skv + w - 1

    cq = np.zeros((B, Hq, S, Skv), dtype=np.int64)
    ck = np.zeros_like(cq)
    for x in range(dq.grid[0]):
        b, h = divmod(x, Hq)
        for q0 in (blk * rows for blk in dq.order):
            q1 = min(q0 + rows, S) - 1
            for t in range(-(-Skv // step)):
                if sees(q0 + q_offset, q1 + q_offset, t * step, min(t * step + step, Skv) - 1):
                    cq[b, h, q0:q1 + 1, t * step:t * step + step] += 1
    group, splits = Hq // Hkv, dkdv.grid[2]
    for x in range(dkdv.grid[0]):
        b, hk = divmod(x, Hkv)
        for k0 in (blk * rows for blk in dkdv.order):
            k1 = min(k0 + rows, Skv) - 1
            for z in range(splits):
                for g in range(z * group // splits, (z + 1) * group // splits):
                    for i in range(-(-S // step)):
                        p0, p1 = i * step + q_offset, min(i * step + step, S) - 1 + q_offset
                        if sees(p0, p1, k0, k1) or no_key(p1):
                            ck[b, hk * group + g, i * step:i * step + step, k0:k1 + 1] += 1
    return cq, ck


@pytest.mark.parametrize("case", BWD_TF32_WALKS)
@pytest.mark.parametrize("D", fa_kernel.BWD_TF32_HEAD_DIMS)
def test_flash_attention_bwd_tf32_walks_cover_every_visible_pair_once(case, D):
    """The 3xTF32 backward's grids take every q block (dQ) and key block
    (dK/dV) once; dQ's walk covers every pair whose row sees its key once,
    and dK/dV's (with the q heads of each group split over its grid's z)
    every such pair once and every pair of a row that sees no key once."""
    from repro_torch.kernels.flash_attention.ref import visible_mask

    B, S, Skv, Hq, Hkv, off, causal, window = case
    plan = fa_kernel.bwd_tf32_plan(B, S, Skv, Hq, Hkv, D)
    dq, dkdv = plan[0], plan[1]
    assert sorted(dq.order) == list(range(dq.grid[1])) and dq.grid[0] == B * Hq
    assert sorted(dkdv.order) == list(range(dkdv.grid[1])) and dkdv.grid[0] == B * Hkv
    assert (Hq // Hkv) % dkdv.grid[2] == 0
    mask = visible_mask(S, Skv, causal, window, off, "cpu").numpy()
    blind = ~mask.any(axis=1)
    cq, ck = _bwd_tf32_walks(plan, B, S, Skv, Hq, Hkv, causal, window, off)
    assert (cq <= 1).all() and (ck <= 1).all()
    assert (cq[..., mask] == 1).all()
    assert (ck[..., mask] == 1).all() and (ck[:, :, blind, :] == 1).all()


def test_flash_attention_bwd_tf32_plan_rings_splits_and_shared_bytes():
    """dQ launches first (it writes Delta), then dK/dV, then (where dK/dV is
    split) the sum of its splits; one consumer warpgroup of 64 rows a CTA,
    steps of 32; the streamed tiles in a ring of two slots, their lo tiles
    in buffers that also hold the staged accumulators, two at D 80 and one
    at 128 (the resident tiles and their lo take 128 KB); every launch fits the 232448
    shared bytes a CTA may take; dK/dV's q heads split over CTAs only while
    the key blocks leave SMs idle, by a divisor of the group."""
    for D in fa_kernel.BWD_TF32_HEAD_DIMS:
        nb = -(-D // 32)
        st, los = 2, {80: 2, 128: 1}[D]
        plan = fa_kernel.bwd_tf32_plan(2, 256, 256, 16, 8, D)
        assert [k.name for k in plan] == ["dq", "dkdv", "sum"]
        dq, dkdv, total = plan
        assert dq.grid == (32, 4) and dq.order == (3, 2, 1, 0)
        assert dkdv.grid == (16, 4, 2) and dkdv.order == (0, 1, 2, 3)
        assert all((k.rows, k.step, k.stages, k.warpgroups) == (64, 32, (st, los), 1)
                   for k in (dq, dkdv))
        res, stp, staged = nb * 64 * 128, nb * 32 * 128, 64 * 128
        bars = 8 * (2 + 2 * st + 2 * los)
        assert dq.smem == 1024 + 4 * res + 2 * st * stp + los * max(2 * stp, 2 * staged) + bars
        assert dkdv.smem == (1024 + 4 * res + 2 * st * stp + los * (max(2 * stp, 4 * staged) + 256)
                             + bars)
        assert 0 < dq.smem <= fa_kernel.SMEM_LIMIT and 0 < dkdv.smem <= fa_kernel.SMEM_LIMIT
        assert total.smem == 0 and total.grid == (-(-2 * 256 * 8 * D // 4 // 256),)
        # dbrx-132b's f32 shape: 16 key-block CTAs, its group of 6 split 6 ways
        assert fa_kernel.bwd_tf32_plan(1, 128, 128, 48, 8, D)[1].grid == (8, 2, 6)
        # stablelm-3b's (no GQA) and a card-filling shape: no split, no sum
        assert [k.name for k in fa_kernel.bwd_tf32_plan(2, 256, 256, 32, 32, D)] == ["dq", "dkdv"]
        big = fa_kernel.bwd_tf32_plan(4, 2048, 2048, 16, 8, D)
        assert len(big) == 2 and big[1].grid == (32, 32, 1)
    assert fa_kernel.bwd_tf32_splits(1, 128, 48, 8, sms=16) == 1
    assert fa_kernel.bwd_tf32_splits(1, 128, 48, 8, sms=48) == 3
    for bad in ((1, 64, 64, 2, 2, 64), (1, 64, 64, 2, 2, 256), (1, 64, 64, 3, 2, 128),
                (0, 64, 64, 2, 2, 128)):
        with pytest.raises(ValueError):
            fa_kernel.bwd_tf32_plan(*bad)


def test_fused_moe_plan_fills_the_card_at_dbrx_width():
    """Both launches put at least one CTA on each of the H100's 132 SMs at
    the default blocks, and both knobs change both launches."""
    plan = moe_kernel.launch_plan(16, 256, 6144, 10752)
    assert plan.grid == (16, 2, 42) and plan.down_grid == (16, 2, 48)
    assert math.prod(plan.grid) >= 132 and math.prod(plan.down_grid) >= 132
    other = moe_kernel.launch_plan(16, 256, 6144, 10752, block_m=64, block_f=512)
    assert other.grid == (16, 4, 21) and other.down_grid == (16, 4, 48)
    assert (other.sub_rows, other.block_f) == (64, 512)
    with pytest.raises(ValueError):
        moe_kernel.launch_plan(2, 32, 16, 64, block_m=24)


SMM_PLAN_SHAPES = [(1024, 512, 512), (1024, 1024, 3072), (1024, 6144, 10752)]


@pytest.mark.parametrize("M, K, N", SMM_PLAN_SHAPES, ids=lambda v: str(v))
def test_scaled_mm_plan_fits_every_lattice_point(M, K, N):
    """At the default, qwen3-0.6b and dbrx-132b workloads, every point of
    the block lattice plans the reference's grid, fits the H100's 227 KB of
    shared memory a block, walks its block in a sub-tile no larger than it,
    and stages 64 bytes of k (32 where block_k is 32)."""
    from repro_torch.tune.space import BLOCK_VALUES

    for bm in BLOCK_VALUES:
        for bn in BLOCK_VALUES:
            for bk in BLOCK_VALUES:
                blocks = dict(block_m=bm, block_n=bn, block_k=bk)
                plan = smm_kernel.launch_plan(M, K, N, **blocks)
                assert plan.grid == ref_smm.grid_shape(M, K, N, **blocks)
                assert plan.smem_bytes <= smm_kernel.SMEM_LIMIT
                assert plan.sub_tile <= min(plan.block_m, plan.block_n)
                assert plan.stage_k == (32 if plan.block_k <= 32 else 64)
                assert plan.vectorized


def test_scaled_mm_plan_stages_unaligned_rows_byte_by_byte():
    """Rows or blocks that are not 16-byte multiples take the element-wise
    staging of the same kernel; the default dbrx plan is 128 x 128 on 8
    warps with a 4-stage ring of 64-byte steps."""
    assert not smm_kernel.launch_plan(7, 100, 13).vectorized
    assert not smm_kernel.launch_plan(64, 96, 50).vectorized
    assert not smm_kernel.launch_plan(64, 96, 50, block_m=32, block_n=25, block_k=32).vectorized
    small = smm_kernel.launch_plan(7, 100, 13, block_m=3, block_n=5, block_k=7)
    assert small.grid == (7, 13, 20) and (small.sub_tile, small.stage_k) == (32, 32)
    plan = smm_kernel.launch_plan(1024, 6144, 10752)
    assert plan.grid == (8, 84, 24) and plan.vectorized
    assert (plan.sub_tile, plan.warps, plan.stage_k, plan.stages) == (128, 8, 64, 4)
    assert plan.smem_bytes == 4 * (128 * 80 + 64 * 128)
    with pytest.raises(TypeError):
        smm_kernel.launch_plan(64, 64, 64, out_dtype=torch.int32)


@pytest.mark.parametrize("M, K, N", SMM_PLAN_SHAPES, ids=lambda v: str(v))
def test_scaled_mm_engine_takes_every_lattice_point_on_wgmma(M, K, N):
    """At the default, qwen3-0.6b and dbrx-132b workloads every point of
    the block lattice, so every survivor of the tuner's prefilter there,
    runs on the wgmma engine; its plan keeps the reference's grid, fits the
    H100's 227 KB of shared memory a block and stages a depth that divides
    block_k."""
    from repro_torch.tune import enumerate_candidates, prefilter
    from repro_torch.tune.space import BLOCK_VALUES

    survivors, _ = prefilter("scaled_mm", dict(M=M, K=K, N=N), enumerate_candidates("scaled_mm"))
    assert survivors
    assert all(smm_kernel.engine(M, K, N, **c.blocks) == "wgmma" for c in survivors)
    for bm in BLOCK_VALUES:
        for bn in BLOCK_VALUES:
            for bk in BLOCK_VALUES:
                blocks = dict(block_m=bm, block_n=bn, block_k=bk)
                assert smm_kernel.engine(M, K, N, **blocks) == "wgmma"
                plan = smm_kernel.wgmma_plan(M, K, N, **blocks)
                assert plan.grid == ref_smm.grid_shape(M, K, N, **blocks)
                assert plan.smem_bytes <= smm_kernel.SMEM_LIMIT
                assert plan.block_k % plan.stage_k == 0 and plan.stage_k in (32, 64, 128)
                assert plan.ctas == plan.grid[0] * plan.grid[1]


SMM_ENGINE_CASES = [
    # (M, K, N, blocks, aligned bases, engine)
    (7, 100, 13, dict(block_m=3, block_n=5, block_k=7), True, "mma_sync"),  # K and N off 16
    (64, 96, 50, dict(block_m=32, block_n=25, block_k=32), True, "mma_sync"),  # N off 16
    (64, 100, 48, dict(block_k=100), True, "mma_sync"),  # K off 16
    (64, 96, 48, dict(block_k=48), True, "mma_sync"),  # block_k not whole 32-deep steps
    (64, 96, 48, dict(block_k=32), False, "mma_sync"),  # a base off 16 bytes
    (64, 96, 48, dict(block_m=32, block_n=25, block_k=32), True, "wgmma"),
    (7, 96, 16, dict(block_m=3, block_n=5, block_k=32), True, "wgmma"),
    (1024, 6144, 10752, {}, True, "wgmma"),
]


@pytest.mark.parametrize("M, K, N, blocks, aligned, want", SMM_ENGINE_CASES)
def test_scaled_mm_engine_routes_what_tma_cannot_address_to_mma_sync(M, K, N, blocks, aligned,
                                                                      want):
    """``engine`` answers wgmma where K and N are multiples of 16, the bases
    16-byte multiples and block_k whole 32-deep steps, else mma_sync; the
    wgmma plan refuses what the engine does not take."""
    assert smm_kernel.engine(M, K, N, aligned=aligned, **blocks) == want
    if smm_kernel.engine(M, K, N, **blocks) == "mma_sync":
        with pytest.raises(ValueError):
            smm_kernel.wgmma_plan(M, K, N, **blocks)


SMM_WGMMA_COVER_CASES = [
    (1024, 512, 512, {}), (1024, 512, 512, dict(block_m=512, block_n=512, block_k=512)),
    (1024, 512, 512, dict(block_m=32, block_n=32, block_k=32)),
    (7, 96, 16, dict(block_m=3, block_n=5, block_k=32)),  # 1-row, 4-column blocks
    (100, 160, 496, dict(block_m=50, block_n=32, block_k=32)),  # bn 31: blocks off 16 columns
    (200, 288, 272, dict(block_m=100, block_n=136, block_k=96)),  # stages of 32, 2 column sub-tiles
    (300, 1024, 384, dict(block_m=300, block_n=384, block_k=128)),  # 3 x 3 sub-tiles, ragged
]


@pytest.mark.parametrize("M, K, N, blocks", SMM_WGMMA_COVER_CASES)
def test_scaled_mm_wgmma_plan_covers_every_output_once(M, K, N, blocks):
    """The wgmma engine's CTAs (one a block) and the sub-tiles each walks
    (``wgmma_walk``, the source's walk) store every output exactly once;
    the plan keeps the reference's grid, which the wrapper records as
    ``last_grid``, and fits 227 KB."""
    plan = smm_kernel.wgmma_plan(M, K, N, **blocks)
    assert plan.grid == ref_smm.grid_shape(M, K, N, **blocks)
    assert plan.smem_bytes <= smm_kernel.SMEM_LIMIT
    stored = np.zeros((M, N), np.int32)
    for cta in range(plan.ctas):
        for m0, rows, n0, cols in smm_kernel.wgmma_walk(plan, M, cta):
            assert 0 < rows <= plan.tile[0] and 0 < cols <= plan.tile[1]
            stored[m0:m0 + rows, n0:n0 + cols] += 1
    assert (stored == 1).all()


def test_scaled_mm_wgmma_plan_at_dbrx_width():
    """The default blocks at dbrx-132b width: 672 CTAs of a consumer and a
    producer warpgroup, one 128 x 128 sub-tile each, a ring of three
    128-deep stages in 99376 bytes (two CTAs an SM)."""
    plan = smm_kernel.wgmma_plan(1024, 6144, 10752)
    assert plan.grid == (8, 84, 24) and plan.ctas == 672
    assert (plan.tile, plan.sub_tiles, plan.threads) == ((128, 128), (1, 1), 256)
    assert (plan.stage_k, plan.stages) == (128, 3)
    assert plan.smem_bytes == 1024 + 3 * 2 * 128 * 128 + 2 * 3 * 8
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    deep = smm_kernel.wgmma_plan(1024, 6144, 10752, block_m=512, block_n=512, block_k=32)
    assert (deep.sub_tiles, deep.stage_k, deep.stages, deep.ctas) == ((4, 4), 32, 4, 42)


def test_scaled_mm_wgmma_source_is_a_library_of_its_own():
    """The wgmma engine is its own source and library, built beside the
    mma.sync engine's."""
    assert all(p.is_file() and p.suffix == ".cu" for p in smm_kernel.WGMMA_SOURCES)
    assert not set(smm_kernel.WGMMA_SOURCES) & set(smm_kernel.SOURCES)
    assert (_build.library_path("scaled_mm_wgmma", smm_kernel.WGMMA_SOURCES)
            != _build.library_path("scaled_mm", smm_kernel.SOURCES))


def test_silu_mul_plan_owns_whole_row_blocks():
    """A program owns whole rows; its chunk is the span rounded up to a
    power of two, within MIN_BLOCK and MAX_BLOCK, so one-row programs (a prime prompt
    length) launch few masked lanes."""
    plan = silu_kernel.launch_plan(8192, 3072)
    assert plan == silu_kernel.LaunchPlan((64,), 128, 16384, 32)
    assert silu_kernel.launch_plan(100, 48, block_rows=32).rows == largest_divisor_block(100, 32)
    assert silu_kernel.launch_plan(781, 3072, block_rows=8) == silu_kernel.LaunchPlan(
        (781,), 1, 4096, 8)
    for R, d, br in ((1024, 3072, 8), (7, 33, 128), (1, 1, 1), (2004, 3072, 16)):
        p = silu_kernel.launch_plan(R, d, block_rows=br)
        span = p.rows * d
        assert p.block & (p.block - 1) == 0 and 4 <= p.num_warps <= 32
        lo, hi = min(span, silu_kernel.MAX_BLOCK), max(silu_kernel.MIN_BLOCK, 2 * span - 1)
        assert lo <= p.block <= hi


def _causal_pairs(lo, hi, n_other, rows):
    """Causal (query, key) pairs of a block: ``rows=True`` counts the keys
    that q rows [lo, hi) see, else the q rows that see keys [lo, hi)."""
    idx = np.arange(lo, hi)
    return int((idx + 1).sum()) if rows else int((n_other - idx).clip(0).sum())


BWD_SHAPES = [(4, 2048, 2048, 16, 8), (1, 781, 781, 4, 2), (2, 64, 64, 2, 2), (1, 200, 50, 2, 1),
              (1, 2048, 2048, 32, 32)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_attention_bwd_plan_covers_every_block_once(shape, dtype):
    """Each kernel's grid takes every key block (dK/dV) or q block (dQ)
    exactly once, and the blocks cover every key and q row."""
    B, S, Skv, Hq, Hkv = shape
    for D in fa_kernel.BWD_HEAD_DIMS:
        plan = {k.name: k for k in fa_kernel.bwd_launch_plan(B, S, Skv, Hq, Hkv, D, dtype)}
        for name, heads, length in (("dkdv", Hkv, Skv), ("dq", Hq, S)):
            kern = plan[name]
            n = kern.grid[1]
            assert kern.grid[0] == B * heads and sorted(kern.order) == list(range(n))
            assert (n - 1) * kern.rows < length <= n * kern.rows
        if dtype == torch.float32:
            assert plan["delta"].grid[0] * plan["delta"].rows >= B * S * Hq


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_attention_bwd_plan_launches_the_heaviest_causal_block_first(shape, dtype):
    """Under a causal mask both grids launch their heaviest block first:
    dK/dV's first key block sees every q row, dQ's last q block every key,
    so the heaviest CTAs run in the first wave and not the last. Blocks
    follow in order of falling work, but for a ragged last q block, which
    launches last."""
    B, S, Skv, Hq, Hkv = shape
    for kern in fa_kernel.bwd_launch_plan(B, S, Skv, Hq, Hkv, 128, dtype):
        if kern.name == "delta":
            continue
        rows = kern.name == "dq"
        work = [_causal_pairs(i * kern.rows, min((i + 1) * kern.rows, S if rows else Skv),
                              S, rows) for i in kern.order]
        if rows and S % kern.rows and len(work) > 1:
            assert kern.order[-1] == len(kern.order) - 1
            work = work[:-1]
        assert work[0] == max(work) and work == sorted(work, reverse=True), (kern.name, work)


def test_flash_attention_bwd_plan_rings_and_shared_bytes():
    """bf16: dQ launches first (it writes Delta), then dK/dV, each streaming
    its tiles through a ring of at least two stages; every head dim's
    kernels fit the 232448 shared bytes a CTA may take. f32: the one-stage
    FMA kernels, Delta first."""
    for D in fa_kernel.BWD_HEAD_DIMS:
        bf = fa_kernel.bwd_launch_plan(4, 2048, 2048, 16, 8, D)
        assert [k.name for k in bf] == ["dq", "dkdv"]
        assert all(k.stages >= 2 and k.rows == 16 * k.warps for k in bf)
        assert all(k.step % 16 == 0 for k in bf)
        f32 = fa_kernel.bwd_launch_plan(4, 2048, 2048, 16, 8, D, torch.float32)
        assert [k.name for k in f32] == ["delta", "dkdv", "dq"]
        assert all(0 < k.smem <= 232448 for k in (*bf, *f32[1:]))
    ld = 128 + 8
    (tq, kst, kw), (tk, qst, qw) = fa_kernel.BWD_TILES
    dq, dkdv = fa_kernel.bwd_launch_plan(4, 2048, 2048, 16, 8, 128)
    assert (dq.step, dq.stages, dq.warps) == (tk, qst, qw)
    assert (dkdv.step, dkdv.stages, dkdv.warps) == (tq, kst, kw)
    assert dq.smem == 2 * ld * (2 * 16 * qw + 2 * qst * tk)
    assert dkdv.smem == 2 * ld * (2 * 16 * kw + 2 * kst * tq) + 8 * kst * tq
    assert dq.grid == (64, -(-2048 // (16 * qw))) and dkdv.grid == (32, -(-2048 // (16 * kw)))
    # head dim 256: two CTAs a block, each owning 128 columns of dQ (or dK and dV)
    ld = 256 + 8
    dq, dkdv = fa_kernel.bwd_launch_plan(1, 4096, 4096, 8, 4, 256)
    assert dq.grid == (8, -(-4096 // (16 * qw)), 2) and dkdv.grid == (4, -(-4096 // (16 * kw)), 2)
    assert dq.smem == 2 * ld * (2 * 16 * qw + 2 * qst * tk)
    assert dkdv.smem == 2 * ld * (2 * 16 * kw + 2 * kst * tq) + 8 * kst * tq
    f32 = fa_kernel.bwd_launch_plan(1, 4096, 4096, 8, 4, 256, torch.float32)
    assert f32[1].smem == 4 * (4 * 128 * 68 + 2 * 64 * 68 + 2 * 64)  # 128 columns at a time
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.bwd_launch_plan(1, 64, 64, 2, 2, 96)


MOE_BWD_SHAPES = [(16, 640, 6144, 10752), (16, 256, 6144, 10752), (2, 40, 7168, 4864),
                  (4, 32, 64, 128), (3, 20, 36, 44), (1, 1, 8, 8), (8, 129, 136, 264)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", MOE_BWD_SHAPES)
def test_fused_moe_bwd_plan_covers_every_output_once(shape, dtype):
    """Four launches in order; each product's (M, N, K) is the backward's
    maths (g, u; dh; dWd, dWg, dWu; dx over two K segments of F); the grid's
    128 x 128 tiles cover the largest product of a launch, its z axis every
    (expert, product); the products come to 16 E C D F operations (eight
    of 2 E C D F); each CTA's shared bytes fit, two to an SM in bf16."""
    E, C, D, F = shape
    plan = moe_kernel.bwd_launch_plan(E, C, D, F, dtype)
    assert [k.name for k in plan] == ["gate_up", "dh", "dw", "dx"]
    assert [k.layout for k in plan] == ["NN", "NT", "TN", "NT"]
    assert [k.products for k in plan] == [
        ((C, F, D, 1), (C, F, D, 1)), ((C, F, D, 1),),
        ((F, D, C, 1), (D, F, C, 1), (D, F, C, 1)), ((C, D, F, 2),)]
    mt, nt = moe_kernel.BWD_TILE
    ops = 0
    for k in plan:
        assert k.grid[2] == E * len(k.products) and k.stages >= 2
        for M, N, K, seg in k.products:
            assert (k.grid[0] - 1) * mt < max(m for m, *_ in k.products) <= k.grid[0] * mt
            assert M <= k.grid[0] * mt and N <= k.grid[1] * nt
            ops += 2 * E * M * N * K * seg
        per_sm = 2 if dtype == torch.bfloat16 else 1
        assert 0 < k.smem and per_sm * (k.smem + 1024) <= 233472
    assert ops == 16 * E * C * D * F
    with pytest.raises(TypeError, match="type"):
        moe_kernel.bwd_launch_plan(E, C, D, F, torch.float16)


#: dbrx-132b's and arctic-480b's training shapes (640 and 40 rows an
#: expert), and ragged ones whose rows are 16-byte multiples
WGMMA_PLAN_SHAPES = [(16, 640, 6144, 10752), (2, 40, 7168, 4864), (3, 200, 520, 776),
                     (1, 1, 8, 8), (8, 129, 136, 264)]


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("shape", WGMMA_PLAN_SHAPES)
def test_fused_moe_wgmma_walk_covers_every_tile_once(shape, sms):
    """The wgmma engine's four launches: the same products as the mma.sync
    engine's plan, each operand staged as it lies; across the persistent
    CTAs of a launch (as many as SMs, never more than live tiles) the walk
    visits every 128 x 256 output tile of every product of every expert
    exactly once, and the tiles cover each product's M x N output; each
    CTA's shared bytes fit an SM."""
    E, C, D, F = shape
    plan = moe_kernel.wgmma_plan(E, C, D, F, sms)
    assert [k.name for k in plan] == ["gate_up", "dh", "dw", "dx"]
    assert [k.products for k in plan] == [
        k.products for k in moe_kernel.bwd_launch_plan(E, C, D, F)]
    assert [k.layout for k in plan] == ["KM", "KK", "MM", "KK"]
    assert [k.staged for k in plan] == [False, False, True, False]
    bm, bn = moe_kernel.WGMMA_TILE
    for k in plan:
        tiles = {(e, p, mt, nt) for e in range(E) for p, (M, N, *_) in enumerate(k.products)
                 for mt in range(-(-M // bm)) for nt in range(-(-N // bn))}
        assert k.tiles_e * E == len(tiles) and k.ctas == min(sms, len(tiles))
        walked = [(e, p, m0 // bm, n0 // bn) for cta in range(k.ctas)
                  for e, p, m0, n0 in moe_kernel.wgmma_walk(k, E, cta)]
        assert len(walked) == len(tiles) and set(walked) == tiles
        for e, p, mt, nt in walked:
            M, N = k.products[p][:2]
            assert mt * bm < M and nt * bn < N
        assert k.stages == 4 and k.smem <= moe_kernel.SMEM_LIMIT
        stage = (bm + bn) * moe_kernel.WGMMA_K * 2
        assert k.scratch == (moe_kernel.WGMMA_ROW_SCRATCH if k.name in ("dh", "dx") else 0)
        assert k.smem == (1024 + k.stages * stage + k.staged * moe_kernel.WGMMA_STAGED
                          + k.scratch + 16 * k.stages)


def test_fused_moe_bwd_engine_follows_type_and_strides():
    """bf16 whose rows (D and F values) and bases are 16-byte multiples
    takes the wgmma engine; f32 whose rows and bases are takes the 3xTF32
    wgmma engine (D and F multiples of 4: 36 and 44 too); other rows and
    other bases take the mma.sync engine."""
    engine = moe_kernel.bwd_engine
    assert engine(torch.bfloat16, 6144, 10752) == "wgmma"
    assert engine(torch.bfloat16, 7168, 4864) == "wgmma"
    assert engine(torch.bfloat16, 8, 8) == "wgmma"
    assert engine(torch.float32, 6144, 10752) == "wgmma_tf32"
    assert engine(torch.float32, 7168, 4864) == "wgmma_tf32"
    assert engine(torch.float32, 36, 44) == "wgmma_tf32"
    assert engine(torch.float32, 8, 8) == "wgmma_tf32"
    assert engine(torch.float32, 37, 45) == "mma_sync"
    assert engine(torch.float32, 36, 45) == "mma_sync"
    assert engine(torch.float32, 6144, 10752, aligned=False) == "mma_sync"
    assert engine(torch.float32, 36, 44, aligned=False) == "mma_sync"
    assert engine(torch.bfloat16, 36, 44) == "mma_sync"
    assert engine(torch.bfloat16, 6144, 10756) == "mma_sync"
    assert engine(torch.bfloat16, 6144, 10752, aligned=False) == "mma_sync"
    assert engine(torch.float16, 6144, 10752) == "mma_sync"


#: the 3xTF32 engine's shapes: the backward cases' (ragged M, N and K, C 1
#: and 20), the tuner's f32 workload, dbrx-132b's and arctic-480b's widths
#: (640 and 40 rows an expert), and C on each side of the column steps
TF32_PLAN_SHAPES = [(16, 256, 6144, 10752), (16, 640, 6144, 10752), (2, 40, 7168, 4864),
                    (2, 64, 48, 96), (3, 20, 36, 44), (3, 200, 520, 776), (1, 1, 8, 8),
                    (8, 129, 136, 264), (2, 65, 40, 48), (2, 128, 40, 48)]


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("shape", TF32_PLAN_SHAPES)
def test_fused_moe_tf32_walk_covers_every_tile_once(shape, sms):
    """The 3xTF32 engine's four launches: the mma.sync engine's products,
    with gate_up's and dh's written transposed (F x C: each B then lies
    K-major), A MN-major but for Wd in dh; across the persistent CTAs of a
    launch (as many as SMs, never more than live tiles) the walk visits
    every 128-row output tile of every product of every expert exactly once,
    and the tiles cover each product's M x N output; the products come to
    16 E C D F operations."""
    E, C, D, F = shape
    plan = moe_kernel.tf32_plan(E, C, D, F, sms)
    assert [k.name for k in plan] == ["gate_up", "dh", "dw", "dx"]
    mma = moe_kernel.bwd_launch_plan(E, C, D, F, torch.float32)
    flip = {"gate_up", "dh"}
    assert [k.products for k in plan] == [
        tuple((n, m, kk, s) for m, n, kk, s in k.products) if k.name in flip else k.products
        for k in mma]
    assert [k.layout for k in plan] == ["M", "K", "M", "M"]
    ops = 0
    for k in plan:
        bm, bn = k.tile
        assert bm == moe_kernel.TF32_M and bn == (moe_kernel.tf32_cols(C) if k.name in flip
                                                  else moe_kernel.TF32_N)
        tiles = {(e, p, mt, nt) for e in range(E) for p, (M, N, *_) in enumerate(k.products)
                 for mt in range(-(-M // bm)) for nt in range(-(-N // bn))}
        assert k.tiles_e * E == len(tiles) and k.ctas == min(sms, len(tiles))
        walked = [(e, p, m0 // bm, n0 // bn) for cta in range(k.ctas)
                  for e, p, m0, n0 in moe_kernel.tf32_walk(k, E, cta)]
        assert len(walked) == len(tiles) and set(walked) == tiles
        for e, p, mt, nt in walked:
            M, N = k.products[p][:2]
            assert mt * bm < M and nt * bn < N
        ops += sum(2 * E * M * N * K * seg for M, N, K, seg in k.products)
    assert ops == 16 * E * C * D * F


@pytest.mark.parametrize("C", [1, 20, 40, 64, 65, 128, 129, 256, 640])
def test_fused_moe_tf32_shared_bytes_fit(C):
    """Each launch's shared bytes (the library's ``Cfg<BN>::BYTES``): 1 KB
    of alignment slack, a ring of four stages each holding A (128 rows x
    32 k), B and B's lo (columns x 32 k) in f32, and three barriers a
    stage; 64 columns for gate_up and dh at C <= 64, else 128; within
    ``SMEM_LIMIT``."""
    for k in moe_kernel.tf32_plan(2, C, 6144, 10752):
        bn = k.tile[1]
        assert bn == (64 if C <= 64 and k.name in ("gate_up", "dh") else 128)
        assert k.stages == 4
        assert k.smem == 1024 + k.stages * (128 + 2 * bn) * 32 * 4 + 24 * k.stages
        assert k.smem <= moe_kernel.SMEM_LIMIT


@pytest.mark.parametrize("C", [*range(1, 41), 64, 127, 256, 257, 640, 641])
def test_fused_moe_tf32_transposed_rows_are_16_byte_multiples(C):
    """The 3xTF32 engine's C-wide arrays (g^T, u^T, dg^T, du^T and the copy
    dy^T) keep rows of ``tf32_ld(C)`` f32 values: a 16-byte multiple, as TMA
    addresses it, for every C, padded by fewer than 4 values."""
    ld = moe_kernel.tf32_ld(C)
    assert ld * 4 % 16 == 0 and C <= ld < C + 4


#: the forward wgmma engine's shapes and knobs: dbrx-132b's decode tick,
#: 1024-token prefill and training (4, 512 and 640 rows an expert), the
#: tuner's bf16 workload, an expert of 8 rows in one block, and ragged C, D
#: and F with blocks of 64 rows (one consumer),
#: 128, sub-tiles of 128 (192, 512) and F blocks cut inside a tile (64, 88,
#: 8) or spanning several (512, 776)
FWD_WGMMA_CASES = [(16, 4, 6144, 10752, 128, 256), (3, 8, 264, 512, 128, 256),
                   (16, 512, 6144, 10752, 128, 256), (16, 640, 6144, 10752, 128, 256),
                   (16, 256, 6144, 10752, 128, 256), (3, 200, 520, 776, 200, 776),
                   (3, 200, 520, 776, 100, 776), (2, 192, 136, 264, 64, 88),
                   (1, 512, 256, 512, 512, 512), (2, 384, 200, 328, 192, 8),
                   (4, 256, 256, 512, 128, 64), (2, 128, 264, 520, 64, 520),
                   (4, 256, 256, 512, 32, 64), (2, 200, 136, 264, 8, 88)]


def _fwd_covered(plan, E, C, D, F, bm):
    """How many times each output element of each launch is stored: h (E,
    C, F) by gate_up, y (E, C, D) by down; and each tile's blocks."""
    counts = []
    for launch, n in zip(plan, (F, D)):
        seen = np.zeros((E, C, n), dtype=np.int64)
        tiles = 0
        for cta in range(launch.ctas):
            for e, m0, rows, n0, cols in moe_kernel.fwd_wgmma_walk(launch, E, C, n, bm, cta):
                tiles += 1
                assert 0 < rows <= launch.tile[0] and 0 < cols <= launch.tile[1]
                # a tile's rows lie in one block of block_m rows, its columns
                # in one column block
                assert m0 // min(bm, C) == (m0 + rows - 1) // min(bm, C)
                assert n0 // launch.col_block == (n0 + cols - 1) // launch.col_block
                seen[e, m0:m0 + rows, n0:n0 + cols] += 1
        assert tiles == E * launch.tiles_e
        counts.append(seen)
    return counts


@pytest.mark.parametrize("case, sms", [(c, n) for c in FWD_WGMMA_CASES for n in (132, 114, 1)
                                       if n == 132 or c[0] * c[1] * (c[2] + c[3]) < 4e6])
def test_fused_moe_fwd_wgmma_walk_covers_every_tile_once(case, sms):
    """The forward wgmma engine's two launches: across the persistent CTAs
    of a launch (as many as SMs, never more than live tiles) the walk
    stores every element of h (gate/up) and of y (down) exactly once; a
    tile is 64 rows (block_m 64: one consumer warpgroup) or 128 (two), by
    128 columns of F or 256 of D, and sums its whole K (D, then F); each
    CTA's shared bytes fit an SM. The full-width shapes are walked at 132
    SMs only."""
    E, C, D, F, bm, bf = case
    plan = moe_kernel.fwd_wgmma_plan(E, C, D, F, bm, bf, sms)
    assert [k.name for k in plan] == ["gate_up", "down"]
    kc = 1 if min(bm, C) <= 64 else 2
    for launch, cols, k in zip(plan, (128, 256), (D, F)):
        assert launch.tile == (64 * kc, cols) and launch.consumers == kc and launch.k == k
        assert launch.ctas == min(sms, E * launch.tiles_e)
        assert launch.stages == 4 and launch.smem <= moe_kernel.SMEM_LIMIT
        assert launch.smem == (1024 + 4 * (64 * kc + 256) * 64 * 2 + 4 * kc * 2048 + 64)
    for seen in _fwd_covered(plan, E, C, D, F, bm):
        assert (seen == 1).all()


def test_fused_moe_fwd_wgmma_knobs_reach_the_plan():
    """block_m sets a tile's rows (64: one consumer; more: sub-tiles of
    128) and block_f a gate/up tile's F columns (sub-tiles of 128 a block);
    two knob pairs give two plans, each covering the outputs once;
    ``launch_plan``'s clamp and divisibility hold (block_m clamps to C, a
    block that does not divide its dim raises); a block under 64 rows takes
    a 64-row tile of its own."""
    E, C, D, F = 2, 512, 256, 1024
    a = moe_kernel.fwd_wgmma_plan(E, C, D, F, 128, 256)
    b = moe_kernel.fwd_wgmma_plan(E, C, D, F, 64, 512)
    c = moe_kernel.fwd_wgmma_plan(E, C, D, F, 256, 64)
    assert a != b and b != c and a != c
    assert a[0].tile == (128, 128) and a[0].row_subs == 1 and a[0].col_subs == 2
    assert b[0].tile == (64, 128) and b[0].col_subs == 4 and b[0].row_tiles == 8
    assert c[0].row_subs == 2 and c[0].col_subs == 1 and c[0].tiles_e == 4 * 16
    for plan, bm in ((a, 128), (b, 64), (c, 256)):
        assert all((s == 1).all() for s in _fwd_covered(plan, E, C, D, F, bm))
    assert moe_kernel.fwd_wgmma_plan(E, 64, D, F, 128, 256)[0].tile == (64, 128)
    assert moe_kernel.fwd_wgmma_plan(E, C, D, F, 4096, 256) == moe_kernel.fwd_wgmma_plan(
        E, C, D, F, 512, 256)
    with pytest.raises(ValueError):
        moe_kernel.fwd_wgmma_plan(E, C, D, F, 96, 256)  # 96 does not divide 512
    d = moe_kernel.fwd_wgmma_plan(E, C, D, F, 32, 256)  # 16 blocks of 32 rows an expert
    assert d[0].tile == (64, 128) and d[0].row_subs == 1 and d[0].row_tiles == 16
    assert all((s == 1).all() for s in _fwd_covered(d, E, C, D, F, 32))
    tick = moe_kernel.fwd_wgmma_plan(16, 4, 6144, 10752)  # a block of an expert's 4 rows
    assert tick[0].tile == (64, 128) and tick[0].row_tiles == 1 and tick[1].tiles_e == 24


def test_fused_moe_fwd_engine_follows_type_widths_rows_and_alignment():
    """bf16 with rows to compute whose rows (D and F values) and bases are
    16-byte multiples, and whose F blocks are whole 16-byte chunks, takes
    the wgmma engine at every row count (a decode tick's 4 rows an expert
    too); f32 with such rows takes the 3xTF32 wgmma engine; no rows, other
    rows, other bases and other F blocks take the mma.sync engine."""
    engine = moe_kernel.fwd_engine
    bf16 = torch.bfloat16
    assert engine(bf16, 512, 6144, 10752) == "wgmma"  # dbrx's 1024-token prefill
    assert engine(bf16, 640, 6144, 10752) == "wgmma"  # its training layer
    assert engine(bf16, 64, 6144, 10752) == "wgmma"
    assert engine(bf16, 4, 6144, 10752) == "wgmma"  # its decode tick
    assert engine(bf16, 63, 6144, 10752) == "wgmma"
    assert engine(bf16, 0, 6144, 10752) == "mma_sync"
    assert engine(torch.float32, 512, 6144, 10752) == "wgmma_tf32"
    assert engine(torch.float16, 512, 6144, 10752) == "mma_sync"
    assert engine(bf16, 512, 6148, 10752) == "mma_sync"
    assert engine(bf16, 512, 6144, 10756) == "mma_sync"
    assert engine(bf16, 512, 6144, 10752, False) == "mma_sync"
    assert engine(bf16, 100, 200, 304, block_f=152) == "wgmma"
    assert engine(bf16, 100, 200, 300, block_f=150) == "mma_sync"
    assert engine(bf16, 512, 256, 520, block_f=260) == "mma_sync"
    assert engine(bf16, 512, 256, 520, block_f=520) == "wgmma"


def test_fused_moe_fwd_engine_gives_aligned_f32_to_the_tf32_engine():
    """f32 with rows to compute whose rows (D and F multiples of 4 values)
    and bases are 16-byte multiples takes the 3xTF32 wgmma engine, at every
    block_f of the tuner's lattice and wherever block_f is all of F (its
    sum over F walks block_f steps in 32-deep stages that never straddle
    one); other rows, other bases, no rows and other F blocks take the
    mma.sync engine."""
    from repro_torch.tune.space import BLOCK_VALUES

    engine = moe_kernel.fwd_engine
    f32 = torch.float32
    assert engine(f32, 256, 6144, 10752) == "wgmma_tf32"  # the tuner's f32 workload
    assert engine(f32, 640, 6144, 10752) == "wgmma_tf32"  # dbrx's training rows
    assert engine(f32, 40, 7168, 4864) == "wgmma_tf32"  # arctic-480b's widths
    assert engine(f32, 20, 36, 44) == engine(f32, 1, 8, 8) == "wgmma_tf32"
    for bf in BLOCK_VALUES:
        assert engine(f32, 512, 256, 512, block_f=bf) == "wgmma_tf32"
    assert engine(f32, 100, 200, 96, block_f=96) == "wgmma_tf32"  # one step of all of F
    assert engine(f32, 100, 200, 96, block_f=48) == "mma_sync"  # steps of 48: not whole stages
    assert engine(f32, 20, 37, 44) == engine(f32, 20, 36, 45) == "mma_sync"
    assert engine(f32, 256, 6144, 10752, False) == "mma_sync"
    assert engine(f32, 0, 6144, 10752) == "mma_sync"


#: the 3xTF32 forward's shapes and knobs: the tuner's f32 workload and
#: dbrx-132b's training rows (256 and 640 rows an expert), the tuner's
#: default workload, and ragged C, D and F with blocks of one tile, of
#: several, and under a tile (a tile's rows or columns past its block
#: computed and not stored)
TF32_FWD_CASES = [(16, 256, 6144, 10752, 128, 256), (16, 640, 6144, 10752, 128, 256),
                  (8, 512, 256, 512, 128, 256), (3, 20, 36, 44, 128, 256),
                  (3, 200, 520, 776, 100, 776), (3, 200, 520, 776, 200, 776),
                  (1, 1, 8, 8, 128, 256), (2, 130, 136, 264, 130, 264),
                  (2, 65, 40, 48, 65, 48), (4, 256, 264, 512, 32, 64),
                  (2, 512, 136, 1024, 256, 512), (2, 384, 100, 96, 192, 32)]


def _tf32_fwd_covered(plan, E):
    """Each launch's count of stores to each element of its output
    (out^T, M x N an expert), checking that a tile lies inside its blocks
    and that the walk visits ``E * tiles_e`` tiles."""
    counts = []
    for launch in plan:
        M, N, _ = launch.products
        seen = np.zeros((E, M, N), dtype=np.int8)
        tiles = 0
        for cta in range(launch.ctas):
            for e, m0, rows, n0, cols in moe_kernel.tf32_fwd_walk(launch, E, cta):
                tiles += 1
                assert 0 < rows <= launch.tile[0] and 0 < cols <= launch.tile[1]
                assert m0 // launch.row_block == (m0 + rows - 1) // launch.row_block
                assert n0 // launch.col_block == (n0 + cols - 1) // launch.col_block
                seen[e, m0:m0 + rows, n0:n0 + cols] += 1
        assert tiles == E * launch.tiles_e
        counts.append(seen)
    return counts


@pytest.mark.parametrize("case, sms", [(c, n) for c in TF32_FWD_CASES for n in (132, 114, 1)
                                       if n == 132 or c[0] * c[1] * (c[2] + c[3]) < 4e6])
def test_fused_moe_tf32_fwd_walk_covers_every_tile_once(case, sms):
    """The 3xTF32 forward's three launches: gate (g^T) and up (u^T, whose
    epilogue writes h) over F x C with K = D, down (y^T) over D x C with K =
    F; A is the weights, MN-major, B the tokens, K-major. Across the
    persistent CTAs of a launch (as many as SMs, never more than its tiles)
    the walk stores every element of each output exactly once; a tile is
    128 rows by 64 (block_m <= 64) or 128 columns; each CTA's shared bytes
    (alignment slack, four stages of A, B and B's lo, three barriers a
    stage) fit an SM; the products come to 6 E C D F operations. The
    full-width shapes are walked at 132 SMs only."""
    E, C, D, F, bm, bf = case
    plan = moe_kernel.tf32_fwd_plan(E, C, D, F, bm, bf, sms)
    assert [k.name for k in plan] == ["gate", "up", "down"]
    assert [k.products for k in plan] == [(F, C, D), (F, C, D), (D, C, F)]
    bn = 64 if min(bm, C) <= 64 else 128
    ops = 0
    for launch in plan:
        assert launch.tile == (128, bn) and launch.stages == 4
        assert launch.ctas == min(sms, E * launch.tiles_e)
        assert launch.smem == 1024 + 4 * (128 + 2 * bn) * 32 * 4 + 3 * 4 * 8
        assert launch.smem <= moe_kernel.SMEM_LIMIT
        M, N, K = launch.products
        ops += 2 * E * M * N * K
    assert ops == 6 * E * C * D * F
    assert all((seen == 1).all() for seen in _tf32_fwd_covered(plan, E))


@pytest.mark.parametrize("kw", [{"E": 8, "C": 512, "D": 256, "F": 512},
                                {"E": 2, "C": 256, "D": 6144, "F": 10752}],
                         ids=["default", "dbrx-132b"])
def test_fused_moe_tf32_fwd_runs_every_tuner_knob(kw):
    """Every (block_m, block_f) the tuner's prefilter passes on its default
    workload and at dbrx-132b's widths (two of its 16 experts) goes to the
    3xTF32 engine and shapes its launch: block_m the column blocks (tokens)
    of all three launches, block_f the row blocks (F) of gate and up; each
    knob pair's plan stores every output element once, and the launched
    grid stays the reference's ``grid_shape``; knob pairs that differ
    after the ``min(block, dim)`` clamp give different plans."""
    from repro_torch.tune import enumerate_candidates, prefilter

    survivors, _ = prefilter("fused_moe", kw, enumerate_candidates("fused_moe"))
    assert len(survivors) == 25
    E, C, D, F = kw["E"], kw["C"], kw["D"], kw["F"]
    plans, clamped = set(), set()
    for c in survivors:
        bm, bf = c.blocks["block_m"], c.blocks["block_f"]
        clamped.add((min(bm, C), min(bf, F)))
        assert moe_kernel.fwd_engine(torch.float32, C, D, F, block_f=bf) == "wgmma_tf32"
        plan = moe_kernel.tf32_fwd_plan(E, C, D, F, bm, bf)
        assert all(k.col_block == min(bm, C) for k in plan)
        assert plan[0].row_block == plan[1].row_block == min(bf, F) and plan[2].row_block == D
        assert moe_kernel.launch_plan(E, C, D, F, block_m=bm, block_f=bf).grid == \
            ref_moe.grid_shape(E, C, D, F, block_m=bm, block_f=bf)
        plans.add(plan)
        if D <= 256:
            assert all((seen == 1).all() for seen in _tf32_fwd_covered(plan, E))
    assert len(plans) == len(clamped)  # knobs the clamp makes equal give one plan


def test_fused_moe_tf32_fwd_plan_raises_where_the_engine_does_not_go():
    """The plan refuses what ``fwd_engine`` keeps from the engine (F blocks
    that are neither whole stages nor all of F, rows off 4 values) and what
    the reference refuses (a block that does not divide its dimension)."""
    with pytest.raises(ValueError):
        moe_kernel.tf32_fwd_plan(2, 100, 200, 96, 100, 48)
    with pytest.raises(ValueError):
        moe_kernel.tf32_fwd_plan(2, 100, 202, 96, 100, 96)
    with pytest.raises(ValueError):
        moe_kernel.tf32_fwd_plan(2, 100, 200, 96, 64, 96)


@pytest.mark.parametrize("R, d", [(8192, 1024), (131072, 128), (65536, 128), (8192, 3072),
                                  (777, 1024), (14, 48), (1, 1), (100003, 128)])
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_rmsnorm_bwd_plan_covers_each_row_once(R, d, sms):
    """The row pass's programs own disjoint, contiguous shares in whole
    steps; together they cover every row once, at most BWD_PROGRAMS_PER_SM
    programs an SM; a step holds at most BWD_TILE values; the ``dw`` pass
    covers every column and sums the partial rows in one order."""
    p = rms_kernel.bwd_plan(R, d, sms=sms)
    owner = np.zeros(R, dtype=np.int64)
    for prog in range(p.programs):
        lo = prog * p.rows_per_program
        assert lo < R
        owner[lo:lo + p.rows_per_program] += 1
    assert (owner == 1).all()
    assert p.rows_per_program % p.rows == 0
    assert p.programs <= max(1, rms_kernel.BWD_PROGRAMS_PER_SM * sms)
    assert p.rows * p.block_d <= max(rms_kernel.BWD_TILE, p.block_d)
    assert p.block_d >= d and p.block_d & (p.block_d - 1) == 0 and p.stages >= 1
    assert p.dw_programs * p.dw_block >= d and p.dw_rows >= 1
