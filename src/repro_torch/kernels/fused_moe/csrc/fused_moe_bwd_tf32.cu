// Fused MoE expert FFN backward on Hopper, f32 as 3xTF32, on wgmma fed by
// TMA: for every expert e, with x (C, D), Wg and Wu (D, F), Wd (F, D) and
// the output gradient dy (C, D),
//
//     g = x Wg,  u = x Wu,  h = silu(g) u            (recomputed)
//     dh = dy Wd^T
//     dg = dh u silu'(g),  du = dh silu(g)
//     dWd = h^T dy,  dWg = x^T dg,  dWu = x^T du
//     dx = dg Wg^T + du Wu^T                          (one product, K = 2F)
//
// The backward of _moe_kernel / fused_moe_pallas of
// src/repro/kernels/fused_moe/kernel.py (which has none of its own: the
// reference differentiates its plain products). It computes what
// fused_moe_bwd.cu computes for f32, in the same four product launches with
// the same three epilogues; that file keeps the f32 calls whose rows or
// bases TMA cannot address (D or F not a multiple of 4 values, a base off
// 16 bytes), and fused_moe_bwd_wgmma.cu the bf16 ones.
//
// What bounds it on an H100 SXM. The eight products are 16 E C D F
// operations, and 3xTF32 runs each three times on the tensor cores: at the
// tuner's f32 workload (E=16, C=256, D=6144, F=10752) 3 x 4.33 TFLOP, 26.2
// ms at the 495 TFLOP/s TF32 peak, against 25.7 GB of inputs and gradients
// (7.7 ms at 3.35 TB/s): operations. f32 outside the tensor cores peaks at
// 67 TFLOP/s, which is where the library's f32 backward runs (65 ms there).
//
// Design, per launch:
//   - products: wgmma.mma_async m64nNk8 tf32 with A from registers and B
//     from shared memory. tf32 wgmma reads B only K-major (K contiguous),
//     so every product is written so that its B lies K-major in device
//     memory, and A, which registers take in any layout, lies as it lies:
//       (1) g^T = Wg^T x^T, u^T = Wu^T x^T (F x C, K = D): A = Wg, Wu
//           (MN-major), B = x as stored; g^T, u^T land in (E, F, Cp)
//           workspaces;
//       (2) dh^T = Wd dy^T (F x C, K = D): A = Wd (K-major), B = dy as
//           stored; the epilogue reads g^T, u^T and writes dg^T, du^T (E,
//           F, Cp) and h (E, C, F);
//       (3) dWd = h^T dy (F x D), dWg = x^T dg, dWu = x^T du (D x F), K = C:
//           A = h, x (MN-major), B = dy^T (a copy, below), dg^T, du^T;
//       (4) dx = dg Wg^T + du Wu^T (C x D, two K segments of F): A = dg^T,
//           du^T (MN-major), B = Wg, Wu as stored.
//     No weight is copied, and every output lands as it lies. The one copy
//     is dy^T (E, D, Cp), made by a transposing pass before (1). Cp is C
//     rounded up to 4 values, so that a row of a C-wide array is a 16-byte
//     multiple, as TMA addresses it for any C; the pads are written as
//     zeros and never read (the maps' bounds are C).
//   - 3xTF32: a b = a_hi b_hi + a_lo b_hi + a_hi b_lo, with hi the top 19
//     bits of the f32 word (its tf32 truncation) and lo = x - hi exactly,
//     as fused_moe_bwd.cu computes (the reference's f32 2e-5 rules out plain
//     TF32). A's hi and lo are made in registers where a consumer warpgroup
//     loads its fragment from the landed tile (ldmatrix for K-major A, one
//     32-bit load a value for MN-major A): once per value per warpgroup a
//     stage. B's lo is a tile of its own in the same stage, with the same
//     128-byte swizzle (the split is elementwise), made once per stage by
//     three splitter warps. B's hi is the landed tile itself: the tensor
//     cores read an f32 word given as tf32 as its top 19 bits, the
//     truncation that hi is, so lo completes it exactly. Were they to round,
//     a b_hi would be off by up to 2^-11 of b, some 5e-4 of a gradient; held
//     to the plain formula run in float64 on the card, the gradients land
//     within 6e-6 of max|ref|, as 3xTF32 does with an exact split.
//   - tiles: 128 x BN of one product's output, two consumer warpgroups of 64
//     rows each; BN = 128, and 64 for launches (1) and (2) when their N = C
//     is at most 64. A thread holds two BN / 2 f32 arrays: `part`, the
//     wgmma accumulator of one stage's products, and `acc`, the tile's sum,
//     into which each stage's `part` is added in IEEE f32. wgmma's own
//     accumulation loses precision over a long K: summing all of K in the
//     accumulator put the gradients 2.2e-4 of max|ref| from float64 at
//     dbrx-132b's widths (K = 6144 and 2F = 21504; fused_moe_bwd.cu, which
//     promotes too, 5e-6). The two arrays are what keeps BN at 128.
//   - loads: one TMA tensor map per operand over (expert, rows, cols), 128-
//     byte swizzle (a swizzle row is 32 f32 values), K steps of 32; a ring of
//     four stages (A, B and B's lo: 48 KB at BN 128) with full, split and
//     empty mbarriers; one producer thread starts the loads and three warps
//     split B (their warpgroup gives its registers to the consumers with
//     setmaxnreg). Ragged M, N and K need no masks: TMA fills a box's
//     out-of-bounds part with zeros, and the epilogues store only what lies
//     inside.
//   - scheduling: one persistent CTA an SM walks the launch's live tiles,
//     flat over (expert, product, n tile, m tile) with m fastest, so that
//     neighbouring CTAs share the B panel in L2; the producer loads the next
//     tile's stages while the consumers store the last one's output.
//   - determinism: a tile walks all of its K in one fixed order, with no
//     split-K and no atomics, so reruns are bit-equal.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128, BK = 32;                  // tile rows; k depth of a stage
constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);  // the last warpgroup loads and splits
constexpr int kSplitters = 96;                    // its warps 1-3 make B's lo
constexpr int A_BYTES = BM * BK * 4;              // 16 KB
constexpr int MN_BOX = kTf32BoxMN;                // an MN-major A box: 32 k-rows of 32 values
constexpr int STAGES = 4;

// BN: the tile's columns; a stage holds A, B and B's lo
template <int BN> struct Cfg {
  static constexpr int B_BYTES = BN * BK * 4;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  // room to align the ring to 1024 bytes, the ring, its full, split and empty barriers
  static constexpr int BYTES = 1024 + STAGES * STAGE_BYTES + 3 * STAGES * 8;
};

// the columns of launches (1) and (2), whose N is C (kernel.tf32_cols)
int cols_for(int C) { return C <= 64 ? 64 : 128; }

// The launches, each its own instance (so that a profile tells them
// apart), and their epilogues: the f32 sum (1, 3, 4); dh^T's silu-mul
// backward (2)
enum { GATE_UP = 1, DH = 2, DW = 3, DX = 4 };

// One product of each expert: out (M x N, row-major, ldo; expert e at e *
// o_e) = sum over the K segments s of A_s B_s, each operand read through its
// tensor map; mt x nt tiles of BM x BN; a row stores its first `cols`
// columns (N, or C's padded width: the pad gets the zeros of TMA's fill)
struct Gemm {
  CUtensorMap a[2];
  CUtensorMap b[2];
  float* out;
  long long o_e;
  int ldo, M, N, K, nseg, mt, nt, cols;
};

struct Launch {
  Gemm g[3];
  int nprod, E, tiles_e;  // products and tiles an expert
  // DH: g^T and u^T of launch (1) and dg^T, du^T, laid out as the
  // product's output (E, F, Cp); h (E, C, F)
  const float* gt;
  const float* ut;
  float* dgt;
  float* dut;
  float* h;
};

// tile t of the walk: expert, product, and the tile's first row and column
template <int BN>
__device__ __forceinline__ void tile_of(const Launch& L, int t, int& e, int& p, int& m0, int& n0) {
  e = t / L.tiles_e;
  int r = t - e * L.tiles_e;
  p = 0;
  while (p + 1 < L.nprod && r >= L.g[p].mt * L.g[p].nt) {
    r -= L.g[p].mt * L.g[p].nt;
    ++p;
  }
  n0 = (r / L.g[p].mt) * BN;
  m0 = (r % L.g[p].mt) * BM;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The epilogues. acc[4j + 2h + c] is row r0 + lane / 4 + 8 h, column 8 j +
// 2 (lane % 4) + c of the tile at (m0, n0) of expert e.

// GATE_UP, DW, DX: from registers, two columns a lane (a quad writes 32
// bytes a row)
template <int BN>
__device__ __forceinline__ void store_f32(const float (&acc)[BN / 2], const Gemm& g, int e, int m0,
                                          int n0, int r0, int lane) {
  const int rr = m0 + r0 + lane / 4, cc = n0 + 2 * (lane % 4);
  float* out = g.out + (size_t)e * g.o_e;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = rr + 8 * h2, c = cc + 8 * j;
      if (r < g.M && c < g.cols)  // cols is a multiple of 4, so c + 1 < cols
        *reinterpret_cast<float2*>(out + (size_t)r * g.ldo + c) =
            make_float2(acc[4 * j + 2 * h2], acc[4 * j + 2 * h2 + 1]);
    }
}

// DH: the sum is dh^T (rows f of F = g.M, columns c of C = g.N,
// rows padded to g.ldo); g^T and u^T of launch (1) lie as it does. Writes
// dg^T and du^T as it lies (the pads get zeros: g and u are 0 there) and h
// transposed, (C, F): a store instruction covers 8 f of 4 rows, whole
// sectors. Eight columns at a time: every g and u load before any use.
template <int BN>
__device__ __forceinline__ void store_swiglu(const float (&acc)[BN / 2], const Launch& L,
                                             const Gemm& g, int e, int m0, int n0, int r0,
                                             int lane) {
  const int rr = m0 + r0 + lane / 4, cc = n0 + 2 * (lane % 4);
  const size_t base = (size_t)e * g.o_e, hbase = (size_t)e * g.M * g.N;
#pragma unroll
  for (int q = 0; q < BN / 32; ++q) {
    float2 gv[4][2], uv[4][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int f = rr + 8 * h2, c = cc + 8 * (4 * q + jj);
        gv[jj][h2] = uv[jj][h2] = make_float2(0.f, 0.f);
        if (f < g.M && c < g.cols) {
          const size_t at = base + (size_t)f * g.ldo + c;
          gv[jj][h2] = __ldcs(reinterpret_cast<const float2*>(L.gt + at));
          uv[jj][h2] = __ldcs(reinterpret_cast<const float2*>(L.ut + at));
        }
      }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int f = rr + 8 * h2, c = cc + 8 * (4 * q + jj);
        if (f >= g.M || c >= g.cols) continue;
        const float2 gg = gv[jj][h2], uu = uv[jj][h2];
        const float s0 = sigmoid(gg.x), s1 = sigmoid(gg.y);
        const float d0 = acc[4 * (4 * q + jj) + 2 * h2], d1 = acc[4 * (4 * q + jj) + 2 * h2 + 1];
        const size_t at = base + (size_t)f * g.ldo + c;
        *reinterpret_cast<float2*>(L.dgt + at) =  // dg = dh u silu'(g)
            make_float2(d0 * uu.x * s0 * (1.f + gg.x * (1.f - s0)),
                        d1 * uu.y * s1 * (1.f + gg.y * (1.f - s1)));
        *reinterpret_cast<float2*>(L.dut + at) =  // du = dh silu(g)
            make_float2(d0 * gg.x * s0, d1 * gg.y * s1);
        if (c < g.N) L.h[hbase + (size_t)c * g.M + f] = gg.x * s0 * uu.x;  // h = silu(g) u
        if (c + 1 < g.N) L.h[hbase + (size_t)(c + 1) * g.M + f] = gg.y * s1 * uu.y;
      }
  }
}

// A_MN: A is MN-major (M contiguous in device memory); B is K-major.
// LAUNCH: which of the four launches, and so its epilogue.
template <bool A_MN, int LAUNCH, int BN>
__global__ void __launch_bounds__(kThreads, 1) moe_bwd_tf32(const __grid_constant__ Launch L) {
  using G = Cfg<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + STAGES * G::STAGE_BYTES, split = full + STAGES * 8,
                 empty = split + STAGES * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);             // the producer's arrival, then the bytes
      mbar_init(split + 8 * s, kSplitters);   // one arrival a splitter thread
      mbar_init(empty + 8 * s, kConsumers);   // one arrival a consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int total = L.E * L.tiles_e;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;

  if (wg == kConsumers) {
    // ------------------------------------------- producer and splitters
    setmaxnreg_dec<40>();
    int stage = 0;
    uint32_t phase = 0;
    if (warp == 0) {
      if (lane == 0) {
        for (int t = blockIdx.x; t < total; t += gridDim.x) {
          int e, p, m0, n0;
          tile_of<BN>(L, t, e, p, m0, n0);
          const Gemm& g = L.g[p];
          const int ks = (g.K + BK - 1) / BK;
          for (int i = 0; i < g.nseg * ks; ++i) {
            const int s = i / ks, k0 = (i - s * ks) * BK;
            const uint32_t fb = full + 8 * stage, sa = ring + stage * G::STAGE_BYTES,
                           sb = sa + A_BYTES;
            mbar_wait(empty + 8 * stage, phase ^ 1);
            mbar_arrive_expect_tx(fb, A_BYTES + G::B_BYTES);
            if (A_MN) {  // four boxes of 32 columns (rows of A) x 32 k
#pragma unroll
              for (int j = 0; j < BM / 32; ++j)
                tma_load_3d(sa + j * MN_BOX, &g.a[s], fb, m0 + 32 * j, k0, e);
            } else {  // one box of 32 k x 128 rows
              tma_load_3d(sa, &g.a[s], fb, k0, m0, e);
            }
            tma_load_3d(sb, &g.b[s], fb, k0, n0, e);  // 32 k x BN rows (B's columns)
            if (++stage == STAGES) stage = 0, phase ^= 1;
          }
        }
      }
    } else {
      // B's lo, chunk by chunk at the landed tile's own offsets
      const int tid = threadIdx.x % 128 - 32;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        int e, p, m0, n0;
        tile_of<BN>(L, t, e, p, m0, n0);
        const Gemm& g = L.g[p];
        const int nk = g.nseg * ((g.K + BK - 1) / BK);
        for (int i = 0; i < nk; ++i) {
          const uint32_t sb = ring + stage * G::STAGE_BYTES + A_BYTES, sl = sb + G::B_BYTES;
          mbar_wait(full + 8 * stage, phase);
          for (int c = tid; c < G::B_BYTES / 16; c += kSplitters) {
            st_shared_v4(sl + 16 * c, tf32_lo(ld_shared_v4(sb + 16 * c)));
          }
          fence_proxy_async();  // the lo tile, visible to the wgmmas that read it
          mbar_arrive(split + 8 * stage);
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    setmaxnreg_inc<232>();
    // a stage's products go into `part`, which is then added into `acc`
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) part[j] = 0.f;
    const int r0 = wg * 64 + warp * 16;  // this warp's first row of the tile
    const bool elected = threadIdx.x % 128 == 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      int e, p, m0, n0;
      tile_of<BN>(L, t, e, p, m0, n0);
      const Gemm& g = L.g[p];
      const int nk = g.nseg * ((g.K + BK - 1) / BK);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
      for (int i = 0; i < nk; ++i) {
        mbar_wait(full + 8 * stage, phase);
        mbar_wait(split + 8 * stage, phase);
        const uint32_t sa = ring + stage * G::STAGE_BYTES, sb = sa + A_BYTES,
                       sl = sb + G::B_BYTES;
        uint32_t hi[BK / 8][4], lo[BK / 8][4];
        load_a_tf32<A_MN>(sa, r0, lane, hi, lo);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          // the kk-th 8 of the step's k: 32 bytes into each 128-byte row of B
          const uint64_t bh = wgmma_desc(sb + kk * 32, 16, 1024),
                         bl = wgmma_desc(sl + kk * 32, 16, 1024);
          wgmma_tf32<BN>(part, lo[kk], bh, kk > 0 ? 1 : 0);  // a_lo b_hi
          wgmma_tf32<BN>(part, hi[kk], bl, 1);               // a_hi b_lo
          wgmma_tf32<BN>(part, hi[kk], bh, 1);               // a_hi b_hi
        }
        wgmma_commit();
        wgmma_wait<0>();  // the stage and the A registers are free
        if (elected) mbar_arrive(empty + 8 * stage);
        if (++stage == STAGES) stage = 0, phase ^= 1;
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          fence_operand(part[j]);
          acc[j] += part[j];  // the stage's sum into the f32 total, rounded to nearest
        }
      }
      if constexpr (LAUNCH == DH)
        store_swiglu<BN>(acc, L, g, e, m0, n0, r0, lane);
      else
        store_f32<BN>(acc, g, e, m0, n0, r0, lane);
    }
  }
}

// dy (E, C, D) into dyt (E, D, ld) with ld = C rounded up to 4, the pad
// columns zeroed: 32 x 32 tiles through shared memory
__global__ void __launch_bounds__(256) transpose_pad(const float* __restrict__ src,
                                                     float* __restrict__ dst, int C, int D,
                                                     int ld) {
  __shared__ float tile[32][33];
  const int e = blockIdx.z, c0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const float* s = src + (size_t)e * C * D;
  float* o = dst + (size_t)e * D * ld;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, d = d0 + threadIdx.x;
    tile[i][threadIdx.x] = (c < C && d < D) ? s[(size_t)c * D + d] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int d = d0 + i, c = c0 + threadIdx.x;
    if (d < D && c < ld) o[(size_t)d * ld + c] = tile[threadIdx.x][i];
  }
}

// ---------------------------------------------------------------- host side

template <bool A_MN, int LAUNCH, int BN>
cudaError_t run(Launch& L, int ctas, cudaStream_t stream) {
  static int configured[kMaxDevices] = {};
  constexpr int smem = Cfg<BN>::BYTES;
  const cudaError_t err = opt_in(moe_bwd_tf32<A_MN, LAUNCH, BN>, smem, configured);
  if (err != cudaSuccess) return err;
  L.tiles_e = 0;
  for (int i = 0; i < L.nprod; ++i) L.tiles_e += L.g[i].mt * L.g[i].nt;
  const int grid = std::min(ctas, L.E * L.tiles_e);
  moe_bwd_tf32<A_MN, LAUNCH, BN><<<grid, kThreads, smem, stream>>>(L);
  return cudaGetLastError();
}

template <bool A_MN, int LAUNCH>
cudaError_t run_cols(Launch& L, int bn, int ctas, cudaStream_t stream) {
  return bn == 64 ? run<A_MN, LAUNCH, 64>(L, ctas, stream)
                  : run<A_MN, LAUNCH, 128>(L, ctas, stream);
}

// An f32 operand of E arrays (rows, cols), rows `ld` values apart. A K-major
// operand (K along cols) is loaded in boxes of 32 k x `rows_box` rows; an
// MN-major A (its M along cols) in boxes of 32 columns x 32 k.
struct Operand {
  const void* base;
  int rows, cols, ld;
};

// product g: out (M x N, rows ldo apart, `cols` of them stored) = sum_s A_s
// B_s over K, with B_s K-major (N rows of K) and A_s MN-major (K rows of M)
// or K-major (M rows of K)
int product(Gemm& g, bool a_mn, const Operand* a, const Operand* b, int nseg, int E, int bn,
            float* out, int M, int N, int K, int ldo, int cols) {
  for (int s = 0; s < nseg; ++s) {
    int r = encode_f32_3d(&g.a[s], a[s].base, a[s].cols, a[s].rows, E, a[s].ld, 32,
                          a_mn ? BK : BM);
    if (r == CUDA_SUCCESS)
      r = encode_f32_3d(&g.b[s], b[s].base, b[s].cols, b[s].rows, E, b[s].ld, BK, bn);
    if (r != CUDA_SUCCESS) return r;
  }
  g.out = out, g.o_e = (long long)M * ldo, g.ldo = ldo, g.cols = cols;
  g.M = M, g.N = N, g.K = K, g.nseg = nseg;
  g.mt = (M + BM - 1) / BM, g.nt = (N + bn - 1) / bn;
  return CUDA_SUCCESS;
}

int backward(const float* x, const float* wg, const float* wu, const float* wd, const float* dy,
             float* gt, float* ut, float* h, float* dgt, float* dut, float* dyt, float* dx,
             float* dwg, float* dwu, float* dwd, int E, int C, int D, int F, int ctas,
             cudaStream_t s) {
  const int Cp = (C + 3) / 4 * 4, bn = cols_for(C);
  // (0) dy^T (E, D, Cp): launch (3)'s B for dWd
  transpose_pad<<<dim3((Cp + 31) / 32, (D + 31) / 32, E), dim3(32, 8), 0, s>>>(dy, dyt, C, D, Cp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Launch L = {};
  L.E = E;
  int r;
#define PRODUCT(P, AMN, A, B, NSEG, BN_, ...)                    \
  r = product(L.g[P], AMN, A, B, NSEG, E, BN_, __VA_ARGS__);     \
  if (r != CUDA_SUCCESS) return kEncodeError + r;
  // (1) g^T = Wg^T x^T, u^T = Wu^T x^T: (F x C) over K = D; Wg, Wu (D, F)
  // are A MN-major, x (C, D) is B K-major; rows of Cp values
  {
    const Operand ag[1] = {{wg, D, F, F}}, au[1] = {{wu, D, F, F}}, b[1] = {{x, C, D, D}};
    L.nprod = 2;
    PRODUCT(0, true, ag, b, 1, bn, gt, F, C, D, Cp, Cp)
    PRODUCT(1, true, au, b, 1, bn, ut, F, C, D, Cp, Cp)
    err = run_cols<true, GATE_UP>(L, bn, ctas, s);
    if (err != cudaSuccess) return (int)err;
  }
  // (2) dh^T = Wd dy^T: (F x C) over K = D; Wd (F, D) is A K-major, dy (C,
  // D) B K-major; the epilogue writes h, dg^T and du^T
  {
    const Operand a[1] = {{wd, F, D, D}}, b[1] = {{dy, C, D, D}};
    L.nprod = 1;
    PRODUCT(0, false, a, b, 1, bn, nullptr, F, C, D, Cp, Cp)
    L.gt = gt, L.ut = ut, L.dgt = dgt, L.dut = dut, L.h = h;
    err = run_cols<false, DH>(L, bn, ctas, s);
    if (err != cudaSuccess) return (int)err;
  }
  // (3) dWd = h^T dy (F x D), dWg = x^T dg, dWu = x^T du (D x F), over K =
  // C: h (C, F) and x (C, D) are A MN-major; dy^T (D, Cp), dg^T and du^T
  // (F, Cp) B K-major
  {
    const Operand ah[1] = {{h, C, F, F}}, ax[1] = {{x, C, D, D}};
    const Operand bdy[1] = {{dyt, D, C, Cp}}, bdg[1] = {{dgt, F, C, Cp}},
                  bdu[1] = {{dut, F, C, Cp}};
    L.nprod = 3;
    PRODUCT(0, true, ah, bdy, 1, 128, dwd, F, D, C, D, D)
    PRODUCT(1, true, ax, bdg, 1, 128, dwg, D, F, C, F, F)
    PRODUCT(2, true, ax, bdu, 1, 128, dwu, D, F, C, F, F)
    err = run<true, DW, 128>(L, ctas, s);
    if (err != cudaSuccess) return (int)err;
  }
  // (4) dx = dg Wg^T + du Wu^T: (C x D) over two K segments of F; dg^T and
  // du^T (F, Cp) are A MN-major, Wg and Wu (D, F) B K-major
  {
    const Operand a[2] = {{dgt, F, C, Cp}, {dut, F, C, Cp}};
    const Operand b[2] = {{wg, D, F, F}, {wu, D, F, F}};
    L.nprod = 1;
    PRODUCT(0, true, a, b, 2, 128, dx, C, D, F, D, D)
    err = run<true, DX, 128>(L, ctas, s);
    if (err != cudaSuccess) return (int)err;
  }
#undef PRODUCT
  return 0;
}

}  // namespace

extern "C" {

// Shared bytes a CTA of launch 0..3 takes for C rows an expert
// (kernel.tf32_plan computes the same).
long long fused_moe_bwd_tf32_smem_bytes(int launch, int C) {
  if (launch < 0 || launch > 3 || C <= 0) return -1;
  return launch < 2 && cols_for(C) == 64 ? Cfg<64>::BYTES : Cfg<128>::BYTES;
}

// x and dy (E, C, D), wg/wu (E, D, F), wd (E, F, D), f32; dx, dwg, dwu, dwd
// shaped as x, wg, wu, wd; workspaces gt, ut, dgt, dut (E, F, Cp), h (E, C,
// F) and dyt (E, D, Cp), f32, Cp = C rounded up to 4; all contiguous, every
// base a 16-byte multiple, D and F multiples of 4. ctas: the CTAs of a
// launch (the device's SMs). Five launches on `stream`, in order (dy^T, then
// the four products). Returns a cudaError_t, or 100000 + a CUresult where a
// tensor map could not be encoded.
int fused_moe_backward_tf32(const void* x, const void* wg, const void* wu, const void* wd,
                            const void* dy, void* gt, void* ut, void* h, void* dgt, void* dut,
                            void* dyt, void* dx, void* dwg, void* dwu, void* dwd, int E, int C,
                            int D, int F, int ctas, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || ctas <= 0 || D % 4 || F % 4)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  return backward(f(x), f(wg), f(wu), f(wd), f(dy), w(gt), w(ut), w(h), w(dgt), w(dut), w(dyt),
                  w(dx), w(dwg), w(dwu), w(dwd), E, C, D, F, ctas,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
