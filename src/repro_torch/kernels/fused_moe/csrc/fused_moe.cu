// Fused MoE expert FFN on Hopper: for every expert e over its gathered
// token block x_e (capacity C),
//
//     y_e = (silu(x_e @ w_gate[e]) * (x_e @ w_up[e])) @ w_down[e]
//
// Replaces _moe_kernel / fused_moe_pallas of
// src/repro/kernels/fused_moe/kernel.py (grid (E, C/block_m, F/block_f),
// the down-projection summed over the sequential F axis in a (block_m, D)
// f32 VMEM accumulator).
//
// What bounds it on an H100 SXM. At dbrx-132b width (E=16, C=256, D=6144,
// F=10752) the three products are 1.6235 TFLOP. With bf16 inputs they
// move 6.44 GB: 1.92 ms at 3.35 TB/s against 1.64 ms of bf16 tensor-core
// work, so bf16 at C=256 is bounded by reading the expert weights. With f32
// inputs (the tuner's) they move 12.88 GB; the reference's 2e-5 rules out
// plain TF32, and the 3xTF32 products used here do three TF32 products for
// each one: max(3 * 1.6235 TFLOP / 495 TFLOP/s, 12.88 GB / 3.35 TB/s) =
// 9.84 ms (the f32 FMA units' bound is 24.2 ms).
//
// Design: two launches behind one wrapper call, on the tensor cores.
// - The TPU's (block_m, D) f32 accumulator does not fit a CTA (786 KB at
//   D=6144 and block_m=32, against 227 KB of shared memory), and one CTA
//   per (expert, row block) left most of the 132 SMs idle. So the work is
//   split where the reference's F axis meets the down product:
//   (a) gate/up over the grid (E, C/block_m, F/block_f): each CTA computes
//       h = silu(x Wg) * (x Wu) for its (block_m, block_f) tile and writes
//       it to an (E, C, F) workspace the wrapper allocates (bf16 inputs
//       round h to bf16 there, as FA2 rounds P);
//   (b) the down product over output tiles (E, C/block_m, D/128): each CTA
//       walks F in block_f steps, in order, as the TPU kernel walks its F
//       blocks, and no pipeline stage straddles a step. The sum needs no
//       atomics and is the same on every run.
//   At dbrx width and the default blocks (128, 256) that is 1344 and 1536
//   CTAs. Both knobs change both launches: block_m the rows of every CTA,
//   block_f the F tiles of (a) and the F steps of (b).
// - CUDA's grid x axis (the fastest) is the row block, so the C/block_m
//   CTAs that read one expert's weight tile run together and the second
//   read hits L2.
// - A CTA walks its block_m rows in sub-blocks of 32, 64 or 128 rows and
//   its columns in tiles of 128 (for (a), 64 gate and the same 64 up
//   columns, so one thread holds both g and u of an element of h). 8 warps
//   as 2 (rows) x 4 (columns); each warp owns a (16 * mi) x 32 tile of the
//   accumulator.
// - K tiles (64 deep for bf16, 32 for f32) come into a ring of three
//   shared-memory stages by cp.async while the tensor cores work on the
//   oldest; rows are padded so that every fragment load is conflict-free.
//   Shapes whose rows are not 16-byte multiples load element by element.
// - bf16: mma.sync.m16n8k16 with f32 accumulation, operands by ldmatrix;
//   two CTAs share an SM (128 registers a thread) to keep loads in flight.
//   bf16 whose rows TMA can address runs on fused_moe_wgmma.cu instead
//   (kernel.fwd_engine), about 3x faster at dbrx width (PERF.md); this
//   engine keeps unaligned rows.
// - f32: 3xTF32 on mma.sync.m16n8k8: each operand is split into
//   hi = tf32(x) and lo = tf32(x - hi), and the sum takes lo*hi + hi*lo +
//   hi*hi (the lo*lo term is below f32's rounding). The tensor cores' own
//   f32 accumulation rounds less carefully than an IEEE add, which over
//   thousands of k steps costs digits; so each stage's 32-deep sum starts
//   from zero on the tensor cores and is added to the f32 total in
//   registers. mma.sync rather than wgmma: one tile engine takes both
//   types and every block shape the tuner asks for.
// Ragged edges (rows past block_m or C, columns past block_f or D, k past
// D or a step) load as zeros and are not stored, so any block that divides
// its dimension works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr int NTILE = 128;     // columns of a CTA tile
constexpr int kMaxDevices = 64;

template <typename T> struct Cfg;
// KS: k depth of a pipeline stage; CH: values in 16 bytes; rows padded so
// that fragment loads are conflict-free. f32 promotes the tensor cores'
// sum into an IEEE f32 total after every stage (see the head). bf16's
// kernels are held to 128 registers so that two CTAs share an SM and keep
// twice the loads in flight, which measured faster at dbrx width; f32's
// are not (its gate/up measured slower so).
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int KS = 64, STAGES = 3, LDA = KS + 8, LDB = NTILE + 8, CH = 8;
  static constexpr int GATE_UP_CTAS = 2;
  static constexpr int DOWN_CTAS = 2;
  static constexpr bool PROMOTE = false;
};
template <> struct Cfg<float> {
  static constexpr int KS = 32, STAGES = 3, LDA = KS + 4, LDB = NTILE + 8, CH = 4;
  static constexpr int GATE_UP_CTAS = 1;
  static constexpr int DOWN_CTAS = 1;
  static constexpr bool PROMOTE = true;
};

template <typename T>
constexpr size_t smem_bytes_of(int mi) {
  return sizeof(T) * Cfg<T>::STAGES *
         ((size_t)32 * mi * Cfg<T>::LDA + (size_t)Cfg<T>::KS * Cfg<T>::LDB);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

// Store two neighbouring values of row `row` at columns c, c + 1 (c even):
// as one 4- or 8-byte store where the layout is aligned (vec), else each
// value below `limit` on its own.
template <typename T>
__device__ __forceinline__ void store2(T* row, int c, int limit, float v0, float v1, int vec) {
  if (vec) {
    if (c < limit) {
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(v0, v1);
      } else {
        *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
      }
    }
  } else {
    if (c < limit) row[c] = from_f32<T>(v0);
    if (c + 1 < limit) row[c + 1] = from_f32<T>(v1);
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
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x = hi + lo with hi = tf32(x), lo = tf32(x - hi)
// (the conversion leaves the low 13 bits unspecified: they are cleared, or
// x - hi would lose what hi rounded away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  hi &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
  lo &= 0xffffe000u;
}

// ---------------------------------------------------------------- the tile engine

// One CTA tile's product: A (rows x K, row-major, lda) times B (K x 128,
// row-major, ldb), K walked in `nsteps` steps of `kstep` (the last clipped
// to `ktotal`). With `split`, B's columns 0..63 come from b0 and 64..127
// from b1 at the same offsets, and `n_valid` bounds each half; otherwise
// all 128 from b0. `vec`: every row and offset is a 16-byte multiple, so
// tiles come by cp.async; else element by element.
template <typename T>
struct Operands {
  const T* a;
  const T* b0;
  const T* b1;
  int lda, ldb, a_rows, n_valid, split, kstep, ktotal, nsteps, vec;
};

template <typename T, int MI>
__device__ __forceinline__ void load_tile(const Operands<T>& op, int i, T* sA, T* sB) {
  constexpr int MT = 32 * MI, LDA = Cfg<T>::LDA, LDB = Cfg<T>::LDB, CH = Cfg<T>::CH;
  constexpr int KS = Cfg<T>::KS;
  const int tps = (op.kstep + KS - 1) / KS;
  const int j = i / tps, t = i % tps;
  const int k0 = j * op.kstep + t * KS;
  const int kmax = min((j + 1) * op.kstep, op.ktotal);
  if (op.vec) {
    constexpr int CPA = KS / CH, CPB = NTILE / CH;
    for (int c = threadIdx.x; c < MT * CPA; c += kThreads) {
      const int r = c / CPA, kc = (c % CPA) * CH;
      const bool ok = r < op.a_rows && k0 + kc < kmax;
      const T* g = ok ? op.a + (size_t)r * op.lda + k0 + kc : op.a;
      cp_async16(smem_u32(sA + r * LDA + kc), g, ok ? 16 : 0);
    }
    for (int c = threadIdx.x; c < KS * CPB; c += kThreads) {
      const int r = c / CPB, nc = (c % CPB) * CH;
      const T* base = (op.split && nc >= 64) ? op.b1 : op.b0;
      const int col = op.split ? nc % 64 : nc;
      const bool ok = k0 + r < kmax && col < op.n_valid;
      const T* g = ok ? base + (size_t)(k0 + r) * op.ldb + col : op.b0;
      cp_async16(smem_u32(sB + r * LDB + nc), g, ok ? 16 : 0);
    }
  } else {
    for (int c = threadIdx.x; c < MT * KS; c += kThreads) {
      const int r = c / KS, k = c % KS;
      const bool ok = r < op.a_rows && k0 + k < kmax;
      sA[r * LDA + k] = ok ? op.a[(size_t)r * op.lda + k0 + k] : from_f32<T>(0.f);
    }
    for (int c = threadIdx.x; c < KS * NTILE; c += kThreads) {
      const int r = c / NTILE, n = c % NTILE;
      const T* base = (op.split && n >= 64) ? op.b1 : op.b0;
      const int col = op.split ? n % 64 : n;
      const bool ok = k0 + r < kmax && col < op.n_valid;
      sB[r * LDB + n] = ok ? base[(size_t)(k0 + r) * op.ldb + col] : from_f32<T>(0.f);
    }
  }
}

// The warp's first column in the CTA tile for its column pair n2 (16 wide).
__device__ __forceinline__ int warp_col(int split, int wn, int n2) {
  return split ? n2 * 64 + 16 * wn : 32 * wn + 16 * n2;
}

template <int MI>
__device__ __forceinline__ void mma_stage(float (&acc)[MI][4][4], const __nv_bfloat16* sA,
                                          const __nv_bfloat16* sB, int split, int wm, int wn,
                                          int lane) {
  constexpr int LDA = Cfg<__nv_bfloat16>::LDA, LDB = Cfg<__nv_bfloat16>::LDB;
  constexpr int KS = Cfg<__nv_bfloat16>::KS;
#pragma unroll
  for (int kk = 0; kk < KS / 16; ++kk) {
    uint32_t a[MI][4], b[2][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ldsm_x4(a[mi], smem_u32(sA + (wm * MI * 16 + mi * 16 + (lane % 8) + ((lane / 8) % 2) * 8) *
                                       LDA + kk * 16 + (lane / 16) * 8));
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2)
      ldsm_x4_t(b[n2], smem_u32(sB + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDB +
                                    warp_col(split, wn, n2) + (lane / 16) * 8));
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        mma_bf16(acc[mi][2 * n2], a[mi], b[n2][0], b[n2][1]);
        mma_bf16(acc[mi][2 * n2 + 1], a[mi], b[n2][2], b[n2][3]);
      }
  }
}

template <int MI>
__device__ __forceinline__ void mma_stage(float (&acc)[MI][4][4], const float* sA,
                                          const float* sB, int split, int wm, int wn, int lane) {
  constexpr int LDA = Cfg<float>::LDA, LDB = Cfg<float>::LDB, KS = Cfg<float>::KS;
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int kk = 0; kk < KS / 8; ++kk) {
    uint32_t ah[MI][4], al[MI][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const float* p = sA + (wm * MI * 16 + mi * 16 + g) * LDA + kk * 8 + c;
      split_tf32(p[0], ah[mi][0], al[mi][0]);
      split_tf32(p[8 * LDA], ah[mi][1], al[mi][1]);
      split_tf32(p[4], ah[mi][2], al[mi][2]);
      split_tf32(p[8 * LDA + 4], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float* p = sB + (kk * 8 + c) * LDB + warp_col(split, wn, ni / 2) + (ni % 2) * 8 + g;
      split_tf32(p[0], bh[ni][0], bl[ni][0]);
      split_tf32(p[4 * LDB], bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        mma_tf32(acc[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
        mma_tf32(acc[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
        mma_tf32(acc[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
      }
  }
}

// total = the product over K, walked in `nsteps` steps of `kstep` as
// pipeline stages of KS that never straddle a step. With PROMOTE each
// stage is summed on the tensor cores from zero in `part` and added to
// `total` with an IEEE f32 add.
template <typename T, int MI>
__device__ void tile_product(const Operands<T>& op, float (&total)[MI][4][4], T* smem) {
  constexpr int MT = 32 * MI, ST = Cfg<T>::STAGES, KS = Cfg<T>::KS;
  constexpr bool PROMOTE = Cfg<T>::PROMOTE;
  constexpr int A_EL = MT * Cfg<T>::LDA, B_EL = KS * Cfg<T>::LDB;
  T* sA = smem;
  T* sB = smem + ST * A_EL;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int tps = (op.kstep + KS - 1) / KS;
  const int ntiles = op.nsteps * tps;

  float part[PROMOTE ? MI : 1][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[mi][ni][e] = 0.f;

  __syncthreads();  // the last tile's readers of the ring are done
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < ntiles) load_tile<T, MI>(op, s, sA + s * A_EL, sB + s * B_EL);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // tile i has landed for every thread; tile i-1's stage is free
    const int nx = i + ST - 1;
    if (nx < ntiles) load_tile<T, MI>(op, nx, sA + (nx % ST) * A_EL, sB + (nx % ST) * B_EL);
    cp_async_commit();
    const int st = i % ST;
    if constexpr (PROMOTE) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
      mma_stage<MI>(part, sA + st * A_EL, sB + st * B_EL, op.split, wm, wn, lane);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) total[mi][ni][e] += part[mi][ni][e];
    } else {
      mma_stage<MI>(total, sA + st * A_EL, sB + st * B_EL, op.split, wm, wn, lane);
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- launch (a)

template <typename T, int MI>
__global__ void __launch_bounds__(kThreads, Cfg<T>::GATE_UP_CTAS)
moe_gate_up_kernel(const T* __restrict__ x, const T* __restrict__ wg, const T* __restrict__ wu,
                   T* __restrict__ h, int C, int D, int F, int bm, int bf, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int MT = 32 * MI;
  const int m0 = blockIdx.x * bm, f0 = blockIdx.y * bf, e = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const T* xe = x + (size_t)e * C * D;
  T* he = h + (size_t)e * C * F;

  for (int fc = 0; fc < bf; fc += 64) {  // 64 gate and 64 up columns at a time
    for (int r0 = 0; r0 < bm; r0 += MT) {
      Operands<T> op;
      op.a = xe + (size_t)(m0 + r0) * D;
      op.b0 = wg + (size_t)e * D * F + f0 + fc;
      op.b1 = wu + (size_t)e * D * F + f0 + fc;
      op.lda = D;
      op.ldb = F;
      op.a_rows = min(MT, bm - r0);
      op.n_valid = min(64, bf - fc);
      op.split = 1;
      op.kstep = D;
      op.ktotal = D;
      op.nsteps = 1;
      op.vec = vec;
      float acc[MI][4][4];
      tile_product<T, MI>(op, acc, smem);
      // n-tiles 0, 1 hold g and 2, 3 hold u of the same columns
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {  // rows lane/4 and lane/4 + 8
            const int r = wm * MI * 16 + mi * 16 + lane / 4 + hr * 8;
            const int col = fc + 16 * wn + ni * 8 + (lane % 4) * 2;
            if (r < op.a_rows)
              store2(he + (size_t)(m0 + r0 + r) * F + f0, col, bf,
                     silu(acc[mi][ni][2 * hr]) * acc[mi][ni + 2][2 * hr],
                     silu(acc[mi][ni][2 * hr + 1]) * acc[mi][ni + 2][2 * hr + 1], vec);
          }
    }
  }
}

// ---------------------------------------------------------------- launch (b)

template <typename T, int MI>
__global__ void __launch_bounds__(kThreads, Cfg<T>::DOWN_CTAS)
moe_down_kernel(const T* __restrict__ h, const T* __restrict__ wd, T* __restrict__ out, int C,
                int D, int F, int bm, int bf, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int MT = 32 * MI;
  const int m0 = blockIdx.x * bm, d0 = blockIdx.y * NTILE, e = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  T* oute = out + (size_t)e * C * D;

  for (int r0 = 0; r0 < bm; r0 += MT) {
    Operands<T> op;
    op.a = h + (size_t)e * C * F + (size_t)(m0 + r0) * F;
    op.b0 = wd + (size_t)e * F * D + d0;
    op.b1 = op.b0;
    op.lda = F;
    op.ldb = D;
    op.a_rows = min(MT, bm - r0);
    op.n_valid = min(NTILE, D - d0);
    op.split = 0;
    op.kstep = bf;  // the TPU kernel's sequential F blocks
    op.ktotal = F;
    op.nsteps = F / bf;
    op.vec = vec;
    float acc[MI][4][4];
    tile_product<T, MI>(op, acc, smem);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = wm * MI * 16 + mi * 16 + lane / 4 + hr * 8;
          const int col = 32 * wn + ni * 8 + (lane % 4) * 2;
          if (r < op.a_rows)
            store2(oute + (size_t)(m0 + r0 + r) * D + d0, col, op.n_valid, acc[mi][ni][2 * hr],
                   acc[mi][ni][2 * hr + 1], vec);
        }
  }
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem, size_t* configured) {
  // raise a kernel's shared-memory limit once per device and size, so a
  // launch being captured into a CUDA graph makes no attribute call
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured[dev] = smem;
  }
  return cudaSuccess;
}

template <typename T, int MI>
int launch(const void* x, const void* wg, const void* wu, const void* wd, void* h, void* out,
           int E, int C, int D, int F, int bm, int bf, int vec, cudaStream_t stream) {
  static size_t conf_a[kMaxDevices] = {}, conf_b[kMaxDevices] = {};
  const size_t smem = smem_bytes_of<T>(MI);
  cudaError_t err = opt_in(moe_gate_up_kernel<T, MI>, smem, conf_a);
  if (err != cudaSuccess) return (int)err;
  err = opt_in(moe_down_kernel<T, MI>, smem, conf_b);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_a(C / bm, F / bf, E);
  moe_gate_up_kernel<T, MI><<<grid_a, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<T*>(h), C, D, F, bm, bf, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b(C / bm, (D + NTILE - 1) / NTILE, E);
  moe_down_kernel<T, MI><<<grid_b, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(wd), static_cast<T*>(out), C, D, F, bm, bf,
      vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_mi(int mi, const void* x, const void* wg, const void* wu, const void* wd, void* h,
                void* out, int E, int C, int D, int F, int bm, int bf, int vec, cudaStream_t s) {
  switch (mi) {
    case 1: return launch<T, 1>(x, wg, wu, wd, h, out, E, C, D, F, bm, bf, vec, s);
    case 2: return launch<T, 2>(x, wg, wu, wd, h, out, E, C, D, F, bm, bf, vec, s);
    case 4: return launch<T, 4>(x, wg, wu, wd, h, out, E, C, D, F, bm, bf, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory one CTA of either launch takes for dtype (0 float32,
// 1 bfloat16) and row sub-blocks of 32 * mi rows (the wrapper checks it
// against the card's 227 KB before launching).
long long fused_moe_smem_bytes(int dtype, int mi) {
  return (long long)(dtype == 0 ? smem_bytes_of<float>(mi) : smem_bytes_of<__nv_bfloat16>(mi));
}

// dtype: 0 float32, 1 bfloat16. x (E, C, D), wg/wu (E, D, F), wd (E, F, D),
// out (E, C, D), all contiguous of that type; h an (E, C, F) workspace of
// the same type. bm divides C and bf divides F; mi in {1, 2, 4} sets the
// row sub-block (32 * mi); vec: all rows and offsets are 16-byte multiples.
// Launches (a) then (b) on `stream`. Returns a cudaError_t.
int fused_moe_forward(const void* x, const void* wg, const void* wu, const void* wd, void* h,
                      void* out, int dtype, int E, int C, int D, int F, int bm, int bf, int mi,
                      int vec, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || bm <= 0 || bf <= 0 || C % bm || F % bf)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_mi<float>(mi, x, wg, wu, wd, h, out, E, C, D, F, bm, bf, vec, s);
  if (dtype == 1)
    return dispatch_mi<__nv_bfloat16>(mi, x, wg, wu, wd, h, out, E, C, D, F, bm, bf, vec, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
