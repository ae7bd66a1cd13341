// W8A8 scaled matrix product on Hopper's int8 tensor cores: int8 x (M, K)
// times int8 w (K, N) with an exact int32 sum over K, then the dequant
// epilogue
//
//     out[r, c] = (float(acc[r, c]) * sx[r]) * sw[c]     -> out dtype
//
// Replaces _scaled_mm_kernel / scaled_mm_pallas of
// src/repro/kernels/scaled_mm/kernel.py (grid (M/bm, N/bn, K/bk), the K
// axis sequential with an int32 VMEM accumulator).
//
// What bounds it on an H100 SXM. At dbrx-132b width (M=1024, K=6144,
// N=10752) the product is 0.1353 Tops: 0.0684 ms at the 1979 TOPS int8
// tensor-core peak. It moves 94.4 MB (int8 in, bf16 out): 0.028 ms at
// 3.35 TB/s. So the bound is the tensor cores' operations.
//
// Why mma.sync and not wgmma yet. int8 wgmma reads B from shared memory
// only K-major, and w arrives (K, N) with N contiguous: that needs a
// transpose stage of its own, and wgmma wants a TMA producer warp with
// mbarriers to be fed. Both are queued for a later PR; this kernel uses the
// warp-level mma.sync that the repo's other Hopper kernels already run.
//
// Design:
// - The sum is exact: mma.sync.m16n8k32.s32.s8.s8.s32 adds into int32
//   without .satfinite, so it wraps as the reference's int32 does (and does
//   not overflow for K <= 133k). Zero-filled operands add 0, so any tiling
//   and any order of k give the same bits.
// - One CTA owns each (bm, bn) block and walks the K axis in bk steps, in
//   order, as the TPU grid's sequential axis does: the launch grid is
//   (N/bn, M/bm) and the K/bk axis is the CTA's loop, so all three knobs
//   reach the launch. The CTA's linear index is read column block major,
//   so the CTAs that run together share w's column blocks and x stays in L2.
// - A CTA walks its block in square sub-tiles of 128, 64 or 32 (the largest
//   not above min(bm, bn), 32 for smaller blocks), with 8, 4 or 2 warps of
//   (16 * MI) rows x 32 columns. Rows and columns past the block load as
//   zero and are not stored.
// - Operands come by cp.async into a ring of 4 shared-memory stages that
//   hold KS = 64 bytes of k (32 where bk <= 32); a stage never straddles a
//   bk step and is zero-filled past the step's end. x rows are padded to
//   KS + 16 bytes and w rows (k) are 128 bytes with their 16-byte chunks
//   XOR-swizzled by (k / 4) % 4, so that neither operand's reads conflict.
//   Shapes whose rows or blocks are not 16-byte multiples stage byte by
//   byte into the same layout.
// - x is the A operand: ldmatrix.x4 on int8 rows gives the m16n8k32 A
//   fragment directly (an 8x8 b16 matrix is an 8x16 int8 one).
// - w is the B operand, which the s8 MMA wants as four consecutive k of one
//   column in a register. ldmatrix.trans moves 16-bit elements, so the
//   warp's 32 columns are permuted instead: thread group g (lane / 4) takes
//   physical columns 4g .. 4g+3 as its column of the four n8 tiles. It reads
//   one 32-bit word of each of rows k .. k+3 (k = 4 (lane % 4)) and a 4x4
//   byte transpose (8 prmt) gives its B register for all four tiles. Tile
//   j's accumulator column c is physical column 4c + j, so each thread
//   holds 8 neighbouring output columns of a row and stores them at once.
// - The epilogue multiplies in the reference's order with explicit
//   round-to-nearest products and cast, so the output can equal the plain
//   version bit for bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>

namespace {

constexpr int kStages = 4;
constexpr int kLdb = 128;  // bytes of a staged w row (one k), any sub-tile width
constexpr int kMaxDevices = 64;

// A sub-tile of TILE x TILE outputs: WM x WN warps of (16 * MI) x 32.
template <int TILE> struct Tile;
template <> struct Tile<128> { static constexpr int WM = 2, WN = 4, MI = 4, MIN_CTAS = 2; };
template <> struct Tile<64> { static constexpr int WM = 2, WN = 2, MI = 2, MIN_CTAS = 4; };
template <> struct Tile<32> { static constexpr int WM = 2, WN = 1, MI = 1, MIN_CTAS = 8; };

template <int TILE, int KS>
constexpr size_t smem_bytes_of() {
  return (size_t)kStages * ((size_t)TILE * (KS + 16) + (size_t)KS * kLdb);
}

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

// Eight neighbouring outputs of a row as one 16-byte store (two for f32).
template <typename O>
__device__ __forceinline__ void store8(O* dst, const float (&v)[8]) {
  if constexpr (sizeof(O) == 4) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint32_t p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = bits16(from_f32<O>(v[2 * e])) | (bits16(from_f32<O>(v[2 * e + 1])) << 16);
    *reinterpret_cast<uint4*>(dst) = make_uint4(p[0], p[1], p[2], p[3]);
  }
}

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of w's (k row r, column n) in a stage: 16-byte chunks XOR-swizzled.
__device__ __forceinline__ int b_offset(int r, int n) {
  return r * kLdb + ((((n >> 4) ^ (((r >> 2) & 3) << 1))) << 4) + (n & 15);
}

// ---------------------------------------------------------------- one sub-tile

// The operands of one sub-tile: x rows from `a` (row stride K), w columns
// from `b` (row stride N); `rows` and `cols` of it lie in the block.
struct SubTile {
  const int8_t* a;
  const int8_t* b;
  int K, N, bk, rows, cols, vec;
};

// Stage i of the sub-tile's walk: bk step i / tps, KS bytes of it at i % tps.
template <int TILE, int KS>
__device__ __forceinline__ void load_stage(const SubTile& op, int i, int8_t* sA, int8_t* sB) {
  constexpr int THREADS = 32 * Tile<TILE>::WM * Tile<TILE>::WN, LDA = KS + 16;
  const int tps = (op.bk + KS - 1) / KS;
  const int step = i / tps;
  const int k0 = step * op.bk + (i % tps) * KS;
  const int kmax = min((step + 1) * op.bk, op.K);
  if (op.vec) {
    constexpr int CPA = KS / 16, CPB = TILE / 16;
    for (int c = threadIdx.x; c < TILE * CPA; c += THREADS) {
      const int r = c / CPA, kc = (c % CPA) * 16;
      const bool ok = r < op.rows && k0 + kc < kmax;
      const int8_t* g = ok ? op.a + (size_t)r * op.K + k0 + kc : op.a;
      cp_async16(smem_u32(sA + r * LDA + kc), g, ok ? 16 : 0);
    }
    for (int c = threadIdx.x; c < KS * CPB; c += THREADS) {
      const int r = c / CPB, nc = (c % CPB) * 16;
      const bool ok = k0 + r < kmax && nc < op.cols;
      const int8_t* g = ok ? op.b + (size_t)(k0 + r) * op.N + nc : op.b;
      cp_async16(smem_u32(sB + b_offset(r, nc)), g, ok ? 16 : 0);
    }
  } else {
    for (int c = threadIdx.x; c < TILE * KS; c += THREADS) {
      const int r = c / KS, k = c % KS;
      const bool ok = r < op.rows && k0 + k < kmax;
      sA[r * LDA + k] = ok ? op.a[(size_t)r * op.K + k0 + k] : int8_t(0);
    }
    for (int c = threadIdx.x; c < KS * TILE; c += THREADS) {
      const int r = c / TILE, n = c % TILE;
      const bool ok = k0 + r < kmax && n < op.cols;
      sB[b_offset(r, n)] = ok ? op.b[(size_t)(k0 + r) * op.N + n] : int8_t(0);
    }
  }
}

// acc += the stage's KS-deep product for the warp's (16 MI) x 32 outputs.
// b_lane: the lane's byte offset of its first w word (see the head).
template <int MI, int KS>
__device__ __forceinline__ void mma_stage(int (&acc)[MI][4][4], const int8_t* sA,
                                          const int8_t* sB, int a_row0, int b_lane, int lane) {
  constexpr int LDA = KS + 16;
#pragma unroll
  for (int kk = 0; kk < KS / 32; ++kk) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ldsm_x4(a[mi], smem_u32(sA + (a_row0 + mi * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDA +
                                    kk * 32 + (lane / 16) * 16));
    uint32_t b[4][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // k 0..15 and 16..31 of the 32
      const int8_t* p = sB + (kk * 32 + h * 16) * kLdb + b_lane;
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(p + kLdb);
      const uint32_t r2 = *reinterpret_cast<const uint32_t*>(p + 2 * kLdb);
      const uint32_t r3 = *reinterpret_cast<const uint32_t*>(p + 3 * kLdb);
      // 4x4 byte transpose: word j holds byte j of r0, r1, r2, r3
      const uint32_t lo01 = __byte_perm(r0, r1, 0x5140), hi01 = __byte_perm(r0, r1, 0x7362);
      const uint32_t lo23 = __byte_perm(r2, r3, 0x5140), hi23 = __byte_perm(r2, r3, 0x7362);
      b[0][h] = __byte_perm(lo01, lo23, 0x5410);
      b[1][h] = __byte_perm(lo01, lo23, 0x7632);
      b[2][h] = __byte_perm(hi01, hi23, 0x5410);
      b[3][h] = __byte_perm(hi01, hi23, 0x7632);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[mi][j], a[mi], b[j][0], b[j][1]);
  }
}

template <int TILE, int KS>
__device__ void subtile_product(const SubTile& op, int (&acc)[Tile<TILE>::MI][4][4],
                                int8_t* smem) {
  using T = Tile<TILE>;
  constexpr int MI = T::MI;
  constexpr int A_B = TILE * (KS + 16), B_B = KS * kLdb;
  int8_t* sA = smem;
  int8_t* sB = smem + kStages * A_B;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int g = lane / 4, t = lane % 4;
  // rows 4t .. 4t+3 at column 32 wn + 4g; (k / 4) % 4 == t on every row read
  const int b_lane = b_offset(4 * t, 32 * wn + 4 * g);
  const int ntiles = (op.K / op.bk) * ((op.bk + KS - 1) / KS);

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0;

  __syncthreads();  // the last sub-tile's readers of the ring are done
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_stage<TILE, KS>(op, s, sA + s * A_B, sB + s * B_B);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i has landed for every thread; stage i-1's slot is free
    const int nx = i + kStages - 1;
    if (nx < ntiles) {
      const int sl = nx % kStages;
      load_stage<TILE, KS>(op, nx, sA + sl * A_B, sB + sl * B_B);
    }
    cp_async_commit();
    const int sl = i % kStages;
    mma_stage<MI, KS>(acc, sA + sl * A_B, sB + sl * B_B, wm * 16 * MI, b_lane, lane);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- the kernel

template <int TILE, int KS, typename O>
__global__ void __launch_bounds__(32 * Tile<TILE>::WM * Tile<TILE>::WN, Tile<TILE>::MIN_CTAS)
scaled_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ sx, const float* __restrict__ sw, O* __restrict__ out,
                 int K, int N, int bm, int bn, int bk, int vec) {
  using T = Tile<TILE>;
  constexpr int MI = T::MI;
  extern __shared__ __align__(128) int8_t smem[];
  // column block major: the CTAs that run together read the same w columns
  const int id = blockIdx.y * gridDim.x + blockIdx.x;
  const int m_blk = (id % gridDim.y) * bm;
  const int n_blk = (id / gridDim.y) * bn;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int g = lane / 4, t = lane % 4;

  for (int mt = 0; mt < bm; mt += TILE) {
    for (int nt = 0; nt < bn; nt += TILE) {
      SubTile op;
      op.a = x + (size_t)(m_blk + mt) * K;
      op.b = w + n_blk + nt;
      op.K = K;
      op.N = N;
      op.bk = bk;
      op.rows = min(TILE, bm - mt);
      op.cols = min(TILE, bn - nt);
      op.vec = vec;
      int acc[MI][4][4];
      subtile_product<TILE, KS>(op, acc, smem);

      // tile j's column c is the warp's column 4c + j: a thread holds the
      // 8 columns 32 wn + 8t .. +7 of rows g and g + 8 of each m16 tile
      const int c0 = 32 * wn + 8 * t;
      const int col = n_blk + nt + c0;
      float s_col[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) s_col[e] = c0 + e < op.cols ? sw[col + e] : 0.f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = wm * 16 * MI + mi * 16 + g + hr * 8;
          if (r >= op.rows) continue;
          const int row = m_blk + mt + r;
          const float s_row = sx[row];
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][e % 4][2 * hr + e / 4]), s_row),
                             s_col[e]);
          O* dst = out + (size_t)row * N + col;
          if (vec && c0 + 8 <= op.cols) {
            store8<O>(dst, v);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (c0 + e < op.cols) dst[e] = from_f32<O>(v[e]);
          }
        }
    }
  }
}

template <int TILE, int KS, typename O>
int launch(const void* x, const void* w, const void* sx, const void* sw, void* out, int M, int K,
           int N, int bm, int bn, int bk, int vec, long long smem_bytes, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_of<TILE, KS>();
  if ((size_t)smem_bytes != smem) return (int)cudaErrorInvalidValue;  // the plan disagrees
  auto kernel = scaled_mm_kernel<TILE, KS, O>;
  if (smem > 48 * 1024) {
    // raise the kernel's limit once per device, so that a launch being
    // captured into a CUDA graph makes no attribute call
    static bool configured[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!configured[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      configured[dev] = true;
    }
  }
  constexpr int threads = 32 * Tile<TILE>::WM * Tile<TILE>::WN;
  const dim3 grid(N / bn, M / bm);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<O*>(out), K, N, bm, bn, bk, vec);
  return (int)cudaGetLastError();
}

template <typename O>
int dispatch(int tile, int ks, const void* x, const void* w, const void* sx, const void* sw,
             void* out, int M, int K, int N, int bm, int bn, int bk, int vec, long long smem,
             cudaStream_t s) {
#define SMM_CASE(TL, KD)                                                                   \
  if (tile == TL && ks == KD)                                                              \
    return launch<TL, KD, O>(x, w, sx, sw, out, M, K, N, bm, bn, bk, vec, smem, s);
  SMM_CASE(128, 64)
  SMM_CASE(128, 32)
  SMM_CASE(64, 64)
  SMM_CASE(64, 32)
  SMM_CASE(32, 64)
  SMM_CASE(32, 32)
#undef SMM_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out_dtype: 0 float32, 1 bfloat16, 2 float16. x (M, K) and w (K, N) int8,
// sx (M,) and sw (N,) float32, out (M, N), all contiguous. bm, bn and bk
// divide M, N and K. tile (128, 64, 32), ks (64, 32) and smem_bytes come
// from the wrapper's launch plan; vec: every row, block and pointer is a
// 16-byte multiple. Returns a cudaError_t.
int scaled_mm_forward(const void* x, const void* w, const void* sx, const void* sw, void* out,
                      int out_dtype, int M, int K, int N, int bm, int bn, int bk, int tile, int ks,
                      int vec, long long smem_bytes, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || bm <= 0 || bn <= 0 || bk <= 0 || M % bm || N % bn || K % bk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return dispatch<float>(tile, ks, x, w, sx, sw, out, M, K, N, bm, bn, bk, vec, smem_bytes, s);
  if (out_dtype == 1)
    return dispatch<__nv_bfloat16>(tile, ks, x, w, sx, sw, out, M, K, N, bm, bn, bk, vec,
                                   smem_bytes, s);
  if (out_dtype == 2)
    return dispatch<__half>(tile, ks, x, w, sx, sw, out, M, K, N, bm, bn, bk, vec, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
