// W8A8 scaled matrix product on Hopper's int8 wgmma fed by TMA: int8 x
// (M, K) times int8 w (K, N) with an exact int32 sum over K, then
//
//     out[r, c] = (float(acc[r, c]) * sx[r]) * sw[c]     -> out dtype
//
// Replaces _scaled_mm_kernel / scaled_mm_pallas of
// src/repro/kernels/scaled_mm/kernel.py for the shapes TMA can address (K
// and N multiples of 16, 16-byte bases, block_k a multiple of 32:
// kernel.engine): the tuner's workloads and every block it ranks.
// scaled_mm.cu (mma.sync) keeps the rest.
//
// What bounds it on an H100 SXM. At dbrx-132b width (M=1024, K=6144,
// N=10752) the product is 0.1353 Tops: 0.0684 ms at the 1979 TOPS int8
// tensor-core peak, against 94.4 MB moved (int8 in, bf16 out): 0.028 ms at
// 3.35 TB/s. So the tensor cores bound it. A 128 x 128 tile reads 256 bytes
// from L2 a k for 32768 operations, so at the peak the CTAs would pull some
// 15 TB/s out of L2. Sharing each w tile between the two CTAs of a cluster
// by TMA multicast (192 bytes a k) was measured slower, so the L2 reads are
// not what holds this tile at about half the peak.
//
// Design:
// - int8 wgmma reads both shared-memory operands K-major only; x is K-major
//   as it lies, w (K, N) is not. So the product is computed transposed,
//   out^T = w^T x^T: A = w^T from registers (register A takes any layout),
//   B = the x tile through its descriptor, K-major as it lies. No copy of w.
// - A fragment of w^T: four consecutive k of one column in a register. A
//   thread reads one 32-bit word (four columns) of each of four k rows of
//   the landed w tile and a 4 x 4 byte transpose (8 prmt) gives four
//   registers, one column each. A thread owns two rows of an m64 tile, so
//   each warpgroup computes two m64 tiles (128 columns of out), and every
//   transposed byte is used: thread group g = lane / 4 of warp v takes
//   columns 32 v + 4 g .. + 3; column 32 v + 4 g + 2 T + h is row g + 8 h of
//   the warp's 16 in tile T. Lanes t = lane % 4 read rows 4 t + (i ^ 2 (t /
//   2)) at load i, so the 32 lanes of each load hit 32 banks of the
//   128-byte-swizzled tile; lanes t >= 2 swap the halves in their last prmt.
// - The epilogue then holds, for each of its tokens, four neighbouring
//   columns: lanes g of a load write 64 contiguous bytes of a bf16 row (128
//   of f32), whole 32-byte sectors, straight from the accumulators. It
//   multiplies in the reference's order with round-to-nearest products and
//   cast, so the output can equal the plain version bit for bit.
// - The sum is exact: wgmma s32 without .satfinite wraps as the reference's
//   int32 does. Zero-filled operands add 0, so any tiling and any order of
//   k give the same bits.
// - Tiles: 128 tokens (the wgmma's N) x 128 columns, a consumer warpgroup
//   and a producer warpgroup a CTA, two CTAs an SM (a CTA builds its
//   fragments while the other's products run). Accumulators: 2 x 64 int32
//   a thread; the producer gives registers back (setmaxnreg) so that the
//   consumer has 216.
// - Knobs: a CTA owns one (bm, bn) block (a 1-D grid of M/bm x N/bn,
//   column block major as scaled_mm.cu's, so that the CTAs that run
//   together share w's columns) and walks it in 128 x 128 sub-tiles, rows
//   outer; rows and columns past its block are computed and not stored. A
//   TMA box starts on a 16-byte multiple of its rows, so a block whose
//   first column is not one walks sub-tiles from the 16-column multiple
//   below it. block_k is the step of the walk over K: a stage is SK = 128,
//   64 or 32 k, the largest that divides it, so no stage straddles a step.
//   x lands with SK bytes of swizzle (one swizzle row a token), w with 128
//   bytes (one row a k).
// - Loads: two TMA tensor maps (x in boxes of SK k x 128 tokens, w in boxes
//   of 128 columns x SK k); a ring of 3 (SK 128) or 4 stages with full and
//   empty mbarriers; TMA fills a box's out-of-bounds part with zeros, so
//   ragged M, N and K need no masks. Each stage's products are issued, then
//   waited for before the stage is released; the accumulators start from
//   scale_d 0.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <initializer_list>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TM = 128;        // tokens (rows of out) a tile: the wgmma's N
constexpr int TN = 128;        // columns of out a tile: two m64 tiles of w^T
constexpr int kThreads = 256;  // a consumer warpgroup, then the producer warpgroup

// SK: k bytes of a stage; a stage holds the x tile (TM rows of SK) and the
// w tile (SK rows of TN)
template <int SK> struct Cfg {
  static constexpr int STAGES = SK == 128 ? 3 : 4;
  static constexpr int X_BYTES = TM * SK, W_BYTES = SK * TN;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  // room to align the ring to 1024 bytes, the ring, its full and empty barriers
  static constexpr int BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
};

struct Params {
  CUtensorMap x, w;  // x (M, K): boxes of SK k x TM tokens; w (K, N): TN columns x SK k
  const float* sx;
  const float* sw;
  void* out;
  int N, K, bm, bn, m_blocks, m_subs;
};

template <typename O> __device__ __forceinline__ O from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint32_t bits16(__half v) { return __half_as_ushort(v); }

// four neighbouring outputs of a row (dst: the first, a 4-value multiple),
// those with lo <= e < hi: one store where that is all four, else one at a time
template <typename O>
__device__ __forceinline__ void store4(O* dst, const float (&v)[4], int lo, int hi) {
  if (lo <= 0 && hi >= 4) {
    if constexpr (sizeof(O) == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      const uint32_t lo = bits16(from_f32<O>(v[0])) | (bits16(from_f32<O>(v[1])) << 16);
      const uint32_t hi = bits16(from_f32<O>(v[2])) | (bits16(from_f32<O>(v[3])) << 16);
      *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e >= lo && e < hi) dst[e] = from_f32<O>(v[e]);
  }
}

template <int SK, typename O>
__global__ void __launch_bounds__(kThreads, 2) smm_wgmma(const __grid_constant__ Params P) {
  using G = Cfg<SK>;
  constexpr int S = SK / 32;  // k32 products a stage
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + G::STAGES * G::STAGE_BYTES, empty = full + G::STAGES * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrival, then the bytes
      mbar_init(empty + 8 * s, 1);  // the consumer warpgroup's release
    }
    mbar_fence_init();
  }
  __syncthreads();
  // column block major: the CTAs that run together read the same w columns
  const int m_blk = (blockIdx.x % P.m_blocks) * P.bm, n_blk = (blockIdx.x / P.m_blocks) * P.bn;
  // sub-tiles start on 16-column multiples, as a TMA box must
  const int n_first = n_blk & ~15, n_subs = (n_blk + P.bn - n_first + TN - 1) / TN;
  const int tiles = P.m_subs * n_subs, nk = P.K / SK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 4) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (warp == 4 && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
#pragma unroll 1
      for (int t = 0; t < tiles; ++t) {
        const int m0 = m_blk + (t / n_subs) * TM, n0 = n_first + (t % n_subs) * TN;
#pragma unroll 1
        for (int i = 0; i < nk; ++i) {
          const uint32_t fb = full + 8 * stage, sa = ring + stage * G::STAGE_BYTES;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_arrive_expect_tx(fb, G::STAGE_BYTES);
          tma_load_2d(sa, &P.x, fb, i * SK, m0);
          tma_load_2d(sa + G::X_BYTES, &P.w, fb, n0, i * SK);
          if (++stage == G::STAGES) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ consumer warpgroup
  setmaxnreg_inc<216>();
  const int g = lane / 4, t = lane % 4;
  // this lane's word of load i in a 16-deep half of the w tile: row 4 t +
  // (i ^ 2 (t / 2)), columns 32 warp + 4 g .. + 3, 128-byte swizzle
  uint32_t off[4];
  const int chunk = 2 * warp + g / 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * t + (i ^ (2 * (t / 2)));
    off[i] = r * TN + ((chunk ^ (r % 8)) << 4) + 4 * (g % 4);
  }
  // the last prmt's selectors: lanes t >= 2 loaded rows 2, 3 before 0, 1
  const uint32_t sel_lo = t >= 2 ? 0x1054u : 0x5410u, sel_hi = t >= 2 ? 0x3276u : 0x7632u;
  int acc[2][TM / 2];
#pragma unroll
  for (int T = 0; T < 2; ++T)
#pragma unroll
    for (int j = 0; j < TM / 2; ++j) acc[T][j] = 0;  // each tile's first products take scale_d 0
  int stage = 0;
  uint32_t phase = 0;
#pragma unroll 1
  for (int tt = 0; tt < tiles; ++tt) {
    const int m0 = m_blk + (tt / n_subs) * TM, n0 = n_first + (tt % n_subs) * TN;
#pragma unroll 1
    for (int i = 0; i < nk; ++i) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t sx_tile = ring + stage * G::STAGE_BYTES, sw_tile = sx_tile + G::X_BYTES;
      // a[kk][T]: tile T's A fragment of the stage's kk-th 32 k
      uint32_t a[S][2][4];
#pragma unroll
      for (int kk = 0; kk < S; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t base = sw_tile + (32 * kk + 16 * h) * TN;
          const uint32_t r0 = ld_shared_b32(base + off[0]), r1 = ld_shared_b32(base + off[1]);
          const uint32_t r2 = ld_shared_b32(base + off[2]), r3 = ld_shared_b32(base + off[3]);
          // 4 x 4 byte transpose: column j's word holds its four k in order
          const uint32_t lo01 = __byte_perm(r0, r1, 0x5140), hi01 = __byte_perm(r0, r1, 0x7362);
          const uint32_t lo23 = __byte_perm(r2, r3, 0x5140), hi23 = __byte_perm(r2, r3, 0x7362);
          a[kk][0][2 * h] = __byte_perm(lo01, lo23, sel_lo);
          a[kk][0][2 * h + 1] = __byte_perm(lo01, lo23, sel_hi);
          a[kk][1][2 * h] = __byte_perm(hi01, hi23, sel_lo);
          a[kk][1][2 * h + 1] = __byte_perm(hi01, hi23, sel_hi);
        }
#pragma unroll
      for (int kk = 0; kk < S; ++kk)
#pragma unroll
        for (int T = 0; T < 2; ++T)
#pragma unroll
          for (int e = 0; e < 4; ++e) fence_operand(a[kk][T][e]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < S; ++kk) {
        const uint64_t db = wgmma_desc_k<SK>(sx_tile + 32 * kk);
        const int sd = (i > 0 || kk > 0) ? 1 : 0;
        wgmma_m64n128k32_s8_rs(acc[0], a[kk][0], db, sd);
        wgmma_m64n128k32_s8_rs(acc[1], a[kk][1], db, sd);
      }
      wgmma_commit();
      wgmma_wait<0>();  // the stage's x tile and the A registers are free
      if (threadIdx.x == 0) mbar_arrive(empty + 8 * stage);
      if (++stage == G::STAGES) stage = 0, phase ^= 1;
    }
#pragma unroll
    for (int T = 0; T < 2; ++T)
#pragma unroll
      for (int j = 0; j < TM / 2; ++j) fence_operand(acc[T][j]);

    // epilogue: acc[T][4 j + 2 h + c] is column 32 warp + 4 g + 2 T + h,
    // token 8 j + 2 t + c of the tile; columns col + e with lo <= e < hi
    // lie in the block
    const int col = n0 + 32 * warp + 4 * g, m_end = m_blk + P.bm;
    const int lo = n_blk - col, hi = n_blk + P.bn - col;
    float s_col[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) s_col[e] = e >= lo && e < hi ? P.sw[col + e] : 0.f;
    O* out = static_cast<O*>(P.out) + col;
#pragma unroll
    for (int j = 0; j < TM / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int row = m0 + 8 * j + 2 * t + c;
        if (row >= m_end) continue;
        const float s_row = P.sx[row];
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[e / 2][4 * j + 2 * (e % 2) + c]), s_row),
                           s_col[e]);
        store4<O>(out + (size_t)row * P.N, v, lo, hi);
      }
  }
}

// ---------------------------------------------------------------- host side

template <int SK, typename O>
cudaError_t run(const Params& P, int ctas, cudaStream_t stream) {
  static int configured[kMaxDevices] = {};
  constexpr int smem = Cfg<SK>::BYTES;
  auto kernel = smm_wgmma<SK, O>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && configured[dev] < smem) {
    // two CTAs an SM: ask for the largest shared-memory carveout
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  err = opt_in(kernel, smem, configured);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kThreads, smem, stream>>>(P);
  return cudaGetLastError();
}

template <int SK>
cudaError_t run_out(const Params& P, int out_dtype, int ctas, cudaStream_t stream) {
  if (out_dtype == 0) return run<SK, float>(P, ctas, stream);
  if (out_dtype == 1) return run<SK, __nv_bfloat16>(P, ctas, stream);
  if (out_dtype == 2) return run<SK, __half>(P, ctas, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared bytes a CTA takes with stages of sk (128, 64 or 32) k
// (kernel.wgmma_plan computes the same); -1 for another sk.
long long scaled_mm_wgmma_smem_bytes(int sk) {
  return sk == 128 ? Cfg<128>::BYTES : sk == 64 ? Cfg<64>::BYTES : sk == 32 ? Cfg<32>::BYTES : -1;
}

// out_dtype: 0 float32, 1 bfloat16, 2 float16. x (M, K) and w (K, N) int8,
// sx (M,) and sw (N,) float32, out (M, N), all contiguous, every base a
// 16-byte multiple, K and N multiples of 16. bm, bn and bk divide M, N and
// K; sk (128, 64 or 32) divides bk. Returns a cudaError_t, or 100000 + a
// CUresult where a tensor map could not be encoded.
int scaled_mm_wgmma_forward(const void* x, const void* w, const void* sx, const void* sw,
                            void* out, int out_dtype, int M, int K, int N, int bm, int bn, int bk,
                            int sk, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || bm <= 0 || bn <= 0 || bk <= 0 || M % bm || N % bn ||
      K % bk || K % 16 || N % 16 || (sk != 128 && sk != 64 && sk != 32) || bk % sk)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, w, sx, sw, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const long long ctas = (long long)(M / bm) * (N / bn);
  if (ctas > INT_MAX) return (int)cudaErrorInvalidValue;
  Params P = {};
  int r = encode_s8_2d(&P.x, x, K, M, sk, TM, sk);
  if (r == CUDA_SUCCESS) r = encode_s8_2d(&P.w, w, N, K, TN, sk, 128);
  if (r != CUDA_SUCCESS) return kEncodeError + r;
  P.sx = static_cast<const float*>(sx);
  P.sw = static_cast<const float*>(sw);
  P.out = out;
  P.N = N, P.K = K, P.bm = bm, P.bn = bn, P.m_blocks = M / bm;
  P.m_subs = (bm + TM - 1) / TM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sk == 128) return (int)run_out<128>(P, out_dtype, (int)ctas, s);
  if (sk == 64) return (int)run_out<64>(P, out_dtype, (int)ctas, s);
  return (int)run_out<32>(P, out_dtype, (int)ctas, s);
}

}  // extern "C"
