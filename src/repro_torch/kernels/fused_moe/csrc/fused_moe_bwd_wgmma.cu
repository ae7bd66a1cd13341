// Fused MoE expert FFN backward on Hopper, bf16, on wgmma fed by TMA: for
// every expert e, with x (C, D), Wg and Wu (D, F), Wd (F, D) and the output
// gradient dy (C, D),
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
// fused_moe_bwd.cu computes, in the same four launches with the same three
// epilogues; f32 runs on fused_moe_bwd_tf32.cu (3xTF32 on wgmma, every
// product written so that its B lies K-major, as tf32 wgmma reads it), and
// fused_moe_bwd.cu keeps the calls whose rows are not 16-byte multiples
// (TMA's stride rule).
//
// What bounds it on an H100 SXM. At dbrx-132b's training shape (E=16, 640
// rows an expert, D=6144, F=10752) the eight products are 10.8 TFLOP,
// 10.94 ms at the bf16 tensor-core peak, against 13.1 GB of inputs and
// gradients (3.9 ms at 3.35 TB/s): operations. The mma.sync engine reached
// 0.20 of that bound: warp-level products at about two thirds of the tensor
// cores' rate, operand loads that every thread addresses, and a grid sized
// for the largest product of a launch whose K = 640 is only ten steps deep.
//
// Design, per launch:
//   - products: wgmma.mma_async m64n256k16 (bf16 in, f32 accumulate), both
//     operands read from shared memory through descriptors. bf16 wgmma takes
//     either major-ness, so every operand is staged as it lies in device
//     memory: x, dy, dg, du K-major as A; Wd, Wg, Wu K-major as B in dh and
//     dx; Wg, Wu MN-major as B in gate_up; h, x MN-major as A and dy, dg, du
//     as B in dw. No pass transposes anything.
//   - tiles: 128 x 256 of one product's output, two consumer warpgroups of
//     64 rows each, 128 f32 accumulators a thread;
//   - loads: one TMA tensor map per operand over (expert, rows, cols), 128-
//     byte swizzle, K steps of 64; a ring of four 48 KB stages with full and
//     empty mbarriers; one producer thread starts the loads (its warpgroup
//     gives its registers to the consumers with setmaxnreg). Ragged M, N
//     and K need no masks: TMA fills a box's out-of-bounds part with zeros.
//   - scheduling: one persistent CTA an SM walks the launch's live tiles,
//     flat over (expert, product, n tile, m tile) with m fastest, so that
//     neighbouring CTAs share the B panel in L2; no CTA exists for a tile
//     that does not exist, and the producer loads the next tile's stages
//     while the consumers store the last one's output.
//   - epilogues, as fused_moe_bwd.cu's: the f32 g and u into workspaces (1);
//     dh's silu-mul backward, writing h, dg, du in bf16 (2); the sum in bf16
//     (3, 4). bf16 rows go out whole sectors at a time: (2) and (4) through
//     each consumer warp's 2 KB of shared memory (stmatrix in, 16 bytes a
//     lane out), (3) through a staged half tile a warpgroup and TMA stores,
//     since its K = C is only ten steps deep; g and u go out from registers.
//   - determinism: a tile walks all of its K in one fixed order, with no
//     split-K and no atomics, so reruns are bit-equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);  // the last warpgroup loads
constexpr int A_BYTES = BM * BK * 2;              // 16 KB
constexpr int B_BYTES = BN * BK * 2;              // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int BOX = 64 * BK * 2;                  // an MN-major box: 64 k-rows of 128 bytes
constexpr int OUT_BOX = 64 * 128;                 // a staged output box: 64 rows of 64 values
constexpr int STAGED_BYTES = BM * 128 * 2;        // EPI_TMA: each warpgroup's 64 x 128 half tile

constexpr int ROWS_SCRATCH = 2048;               // a consumer warp's: 16 rows of 128 bytes

// Epilogues: the f32 sum into a workspace (1); dh's silu-mul backward (2);
// the sum in bf16 (3); the sum in bf16 through a shared staging tile and TMA
// stores (4: the weight gradients, whose K = C is only a few steps deep, so
// that the stores do not hold up the next tile). (2) and (3) write bf16 rows
// through each warp's scratch (store_rows).
enum { EPI_F32 = 1, EPI_SWIGLU = 2, EPI_STORE = 3, EPI_TMA = 4 };

// A CTA's shared memory: the ring of stages, the staging half tiles
// (EPI_TMA) or the consumer warps' row scratch (EPI_SWIGLU, EPI_STORE),
// 2 x stages barriers, and room to align the ring to 1024 bytes
template <int EPI> struct Smem {
  static constexpr int STAGES = 4;
  static constexpr int STAGING = EPI == EPI_TMA                          ? STAGED_BYTES
                                 : EPI == EPI_SWIGLU || EPI == EPI_STORE ? 4 * kConsumers * ROWS_SCRATCH
                                                                         : 0;
  static constexpr int BYTES = 1024 + STAGES * STAGE_BYTES + STAGING + 2 * STAGES * 8;
};

// One product of each expert: out (M x N, row-major, ldo; expert e at e *
// o_e) = sum over the K segments s of A_s B_s, each operand read through its
// tensor map; mt x nt tiles of BM x BN.
struct Gemm {
  CUtensorMap a[2];
  CUtensorMap b[2];
  CUtensorMap o;  // EPI_TMA: the output, in boxes of 64 rows x 64 columns
  void* out;
  long long o_e;
  int ldo, M, N, K, nseg, mt, nt;
};

struct Launch {
  Gemm g[3];
  int nprod, E, tiles_e;  // products and tiles an expert
  // EPI_SWIGLU: the f32 g and u of launch (1), and h, dg, du (E, C, F)
  const float* gw;
  const float* uw;
  bf16* h;
  bf16* dg;
  bf16* du;
};

// tile t of the walk: expert, product, and the tile's first row and column
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

// The epilogues. acc[4j + 2h + c] is row 64 wg + 16 warp + lane / 4 + 8 h,
// column 8 j + 2 (lane % 4) + c of the tile at (m0, n0) of expert e.

// EPI_TMA: each warpgroup's 64 rows, 128 columns at a time, into its 16 KB
// of the staging tile as the output map's boxes lie (64 x 64, 128-byte
// swizzle: stmatrix without conflicts), then two TMA stores by one of its
// threads; the two warpgroups do not wait for each other
__device__ __forceinline__ void store_staged(const float (&acc)[BN / 2], const Gemm& g,
                                             uint32_t staging, int e, int m0, int n0, int wg,
                                             int warp, int lane) {
  const uint32_t mine = staging + wg * (STAGED_BYTES / kConsumers);
  const bool elected = threadIdx.x % 128 == 0;
  // lane l gives the address of row l % 8 of matrix l / 8: matrices (j,
  // rows 0-7), (j, rows 8-15), (j + 1, rows 0-7), (j + 1, rows 8-15)
  const int R = warp * 16 + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
  for (int half = 0; half < BN / 128; ++half) {
    if (elected) bulk_wait_read<0>();  // the last stores have read it
    named_barrier_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      const int jj = 16 * half + j, c = j + lane / 16;  // c: the n8 block in this half
      const uint32_t v[4] = {pack2(acc[4 * jj], acc[4 * jj + 1]),
                             pack2(acc[4 * jj + 2], acc[4 * jj + 3]),
                             pack2(acc[4 * jj + 4], acc[4 * jj + 5]),
                             pack2(acc[4 * jj + 6], acc[4 * jj + 7])};
      stmatrix_x4(mine + (c / 8) * OUT_BOX + R * 128 + (((c % 8) ^ (lane % 8)) * 16), v);
    }
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);
    if (elected) {
      for (int b = 0; b < 2; ++b) {
        const int col = n0 + 128 * half + 64 * b;
        if (col < g.N) tma_store_3d(&g.o, mine + b * OUT_BOX, col, m0 + 64 * wg, e);
      }
      bulk_commit();
    }
  }
}

// EPI_F32: from registers, two columns a lane (a quad writes 32 bytes a row)
__device__ __forceinline__ void store_f32(const float (&acc)[BN / 2], const Gemm& g, int e, int m0,
                                          int n0, int wg, int warp, int lane) {
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4, c0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int c = c0 + 8 * j, r = r0 + 8 * h2;
      if (c >= g.N || r >= g.M) continue;  // N is even, so c + 1 < N
      const size_t at = (size_t)e * g.o_e + (size_t)r * g.ldo + c;
      *reinterpret_cast<float2*>(static_cast<float*>(g.out) + at) =
          make_float2(acc[4 * j + 2 * h2], acc[4 * j + 2 * h2 + 1]);
    }
}

// EPI_SWIGLU, EPI_STORE: 32 columns at a time through store_rows; for
// EPI_SWIGLU the sum is dh, and the g and u of launch (1), laid out as dh,
// give h, dg and du
template <int EPI>
__device__ __forceinline__ void store_bf16(const float (&acc)[BN / 2], const Launch& L,
                                           const Gemm& g, uint32_t scratch, int e, int m0, int n0,
                                           int wg, int warp, int lane) {
  const int rw = m0 + wg * 64 + warp * 16, rows = g.M - rw;  // this warp's 16 rows
  const size_t base = (size_t)e * g.o_e + (size_t)rw * g.ldo;
#pragma unroll
  for (int q = 0; q < BN / 32; ++q) {
    const int c0 = n0 + 32 * q, cols = g.N - c0;
    if (cols <= 0) break;
    uint32_t w[4][2];
    if constexpr (EPI == EPI_STORE) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          w[jj][h2] = pack2(acc[4 * (4 * q + jj) + 2 * h2], acc[4 * (4 * q + jj) + 2 * h2 + 1]);
      store_rows(w, scratch, static_cast<bf16*>(g.out) + base + c0, g.ldo, rows, cols, lane);
    } else {
      // every g and u load of the 32 columns goes out before any use
      float2 gv[4][2], uv[4][2], sv[4][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = lane / 4 + 8 * h2, c = 8 * jj + 2 * (lane % 4);
          gv[jj][h2] = uv[jj][h2] = make_float2(0.f, 0.f);
          if (r < rows && c < cols) {
            const size_t at = base + (size_t)r * g.ldo + c0 + c;
            gv[jj][h2] = __ldcs(reinterpret_cast<const float2*>(L.gw + at));
            uv[jj][h2] = __ldcs(reinterpret_cast<const float2*>(L.uw + at));
          }
        }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          sv[jj][h2] = make_float2(sigmoid(gv[jj][h2].x), sigmoid(gv[jj][h2].y));
          w[jj][h2] = pack2(gv[jj][h2].x * sv[jj][h2].x * uv[jj][h2].x,
                            gv[jj][h2].y * sv[jj][h2].y * uv[jj][h2].y);  // h = silu(g) u
        }
      store_rows(w, scratch, L.h + base + c0, g.ldo, rows, cols, lane);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {  // dg = dh u silu'(g)
          const float2 gg = gv[jj][h2], uu = uv[jj][h2], ss = sv[jj][h2];
          const float v0 = acc[4 * (4 * q + jj) + 2 * h2], v1 = acc[4 * (4 * q + jj) + 2 * h2 + 1];
          w[jj][h2] = pack2(v0 * uu.x * ss.x * (1.f + gg.x * (1.f - ss.x)),
                            v1 * uu.y * ss.y * (1.f + gg.y * (1.f - ss.y)));
        }
      store_rows(w, scratch, L.dg + base + c0, g.ldo, rows, cols, lane);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {  // du = dh silu(g)
          const float2 gg = gv[jj][h2], ss = sv[jj][h2];
          const float v0 = acc[4 * (4 * q + jj) + 2 * h2], v1 = acc[4 * (4 * q + jj) + 2 * h2 + 1];
          w[jj][h2] = pack2(v0 * gg.x * ss.x, v1 * gg.y * ss.y);
        }
      store_rows(w, scratch, L.du + base + c0, g.ldo, rows, cols, lane);
    }
  }
}

// A_MN / B_MN: the operand is MN-major (M or N contiguous in device memory)
template <bool A_MN, bool B_MN, int EPI>
__global__ void __launch_bounds__(kThreads, 1) moe_bwd_wgmma(const __grid_constant__ Launch L) {
  constexpr int STAGES = Smem<EPI>::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u, staging = ring + STAGES * STAGE_BYTES;
  const uint32_t full = staging + Smem<EPI>::STAGING, empty = full + STAGES * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);            // the producer's arrival, then the bytes
      mbar_init(empty + 8 * s, kConsumers);  // one arrival a consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int total = L.E * L.tiles_e;
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // ------------------------------------------------ producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        int e, p, m0, n0;
        tile_of(L, t, e, p, m0, n0);
        const Gemm& g = L.g[p];
        const int ks = (g.K + BK - 1) / BK;
        for (int i = 0; i < g.nseg * ks; ++i) {
          const int s = i / ks, k0 = (i - s * ks) * BK;
          const uint32_t fb = full + 8 * stage, sa = ring + stage * STAGE_BYTES,
                         sb = sa + A_BYTES;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_arrive_expect_tx(fb, STAGE_BYTES);
          if (A_MN) {  // two boxes of 64 columns (rows of A) x 64 k
            tma_load_3d(sa, &g.a[s], fb, m0, k0, e);
            tma_load_3d(sa + BOX, &g.a[s], fb, m0 + 64, k0, e);
          } else {  // one box of 64 k x 128 rows
            tma_load_3d(sa, &g.a[s], fb, k0, m0, e);
          }
          if (B_MN) {  // four boxes of 64 columns x 64 k
#pragma unroll
            for (int j = 0; j < BN / 64; ++j) tma_load_3d(sb + j * BOX, &g.b[s], fb, n0 + 64 * j, k0, e);
          } else {  // one box of 64 k x 256 rows (B's columns)
            tma_load_3d(sb, &g.b[s], fb, k0, n0, e);
          }
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    setmaxnreg_inc<232>();
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const bool elected = threadIdx.x % 128 == 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      int e, p, m0, n0;
      tile_of(L, t, e, p, m0, n0);
      const Gemm& g = L.g[p];
      const int nk = g.nseg * ((g.K + BK - 1) / BK);
      int prev = 0;
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) fence_operand(acc[j]);
      for (int i = 0; i < nk; ++i) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t sa = ring + stage * STAGE_BYTES, sb = sa + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // this warpgroup's 64 rows of A, and the kk-th 16 of the step's k
          const uint64_t da = A_MN ? wgmma_desc(sa + wg * BOX + kk * 2048, BOX, 1024)
                                   : wgmma_desc(sa + wg * 8192 + kk * 32, 16, 1024);
          const uint64_t db = B_MN ? wgmma_desc(sb + kk * 2048, BOX, 1024)
                                   : wgmma_desc(sb + kk * 32, 16, 1024);
          wgmma_m64n256k16<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db, (i > 0 || kk > 0) ? 1 : 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // step i-1's products are done: its stage is free
        if (i > 0 && elected) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) fence_operand(acc[j]);
      if (elected) mbar_arrive(empty + 8 * prev);

      if constexpr (EPI == EPI_TMA)
        store_staged(acc, g, staging, e, m0, n0, wg, warp, lane);
      else if constexpr (EPI == EPI_F32)
        store_f32(acc, g, e, m0, n0, wg, warp, lane);
      else
        store_bf16<EPI>(acc, L, g, staging + (wg * 4 + warp) * ROWS_SCRATCH, e, m0, n0, wg, warp,
                        lane);
    }
    if constexpr (EPI == EPI_TMA) {
      if (threadIdx.x % 128 == 0) bulk_wait<0>();  // the last stores have landed
    }
  }
}

// ---------------------------------------------------------------- host side

template <bool A_MN, bool B_MN, int EPI>
cudaError_t run(Launch& L, int ctas, cudaStream_t stream) {
  static int configured[kMaxDevices] = {};
  constexpr int smem = Smem<EPI>::BYTES;
  const cudaError_t err = opt_in(moe_bwd_wgmma<A_MN, B_MN, EPI>, smem, configured);
  if (err != cudaSuccess) return err;
  L.tiles_e = 0;
  for (int i = 0; i < L.nprod; ++i) L.tiles_e += L.g[i].mt * L.g[i].nt;
  const int grid = std::min(ctas, L.E * L.tiles_e);
  moe_bwd_wgmma<A_MN, B_MN, EPI><<<grid, kThreads, smem, stream>>>(L);
  return cudaGetLastError();
}

// a tensor map over an (E, rows, cols) bf16 operand, staged K-major (a box
// of 64 k x `rows_box` rows) or MN-major (a box of 64 columns x 64 k)
int make_map(CUtensorMap* m, const void* base, int E, int rows, int cols, bool mn, int rows_box) {
  return encode_bf16_3d(m, base, cols, rows, E, 64, mn ? BK : rows_box);
}

// product p of L: out (M x N) = sum_s A_s B_s with the operands' arrays
// a_s (E, a_rows, a_cols) and b_s (E, b_rows, b_cols)
template <bool A_MN, bool B_MN, bool STAGED = false>
int product(Gemm& g, const void* const* a, const void* const* b, int nseg, int E, int a_rows,
            int a_cols, int b_rows, int b_cols, void* out, int M, int N, int K, int ldo) {
  for (int s = 0; s < nseg; ++s) {
    int r = make_map(&g.a[s], a[s], E, a_rows, a_cols, A_MN, BM);
    if (r == CUDA_SUCCESS) r = make_map(&g.b[s], b[s], E, b_rows, b_cols, B_MN, BN);
    if (r != CUDA_SUCCESS) return r;
  }
  if (STAGED) {  // the output in boxes of 64 columns x 64 rows (EPI_TMA)
    int r = make_map(&g.o, out, E, M, N, false, 64);
    if (r != CUDA_SUCCESS) return r;
  }
  g.out = out, g.o_e = (long long)M * N, g.ldo = ldo;
  g.M = M, g.N = N, g.K = K, g.nseg = nseg;
  g.mt = (M + BM - 1) / BM, g.nt = (N + BN - 1) / BN;
  return CUDA_SUCCESS;
}

int backward(const void* x, const void* wg, const void* wu, const void* wd, const void* dy,
             float* gw, float* uw, bf16* h, bf16* dg, bf16* du, void* dx, void* dwg, void* dwu,
             void* dwd, int E, int C, int D, int F, int ctas, cudaStream_t s) {
  Launch L = {};
  L.E = E;
  int r;
#define PRODUCT(P, AM, BM_, ...)                                   \
  r = product<AM, BM_, AM && BM_>(L.g[P], __VA_ARGS__);          \
  if (r != CUDA_SUCCESS) return kEncodeError + r;
  // (1) g = x Wg, u = x Wu: (C x F) over K = D; Wg, Wu (D, F) are B MN-major
  {
    const void* a[1] = {x};
    const void* bg[1] = {wg};
    const void* bu[1] = {wu};
    L.nprod = 2;
    PRODUCT(0, false, true, a, bg, 1, E, C, D, D, F, gw, C, F, D, F)
    PRODUCT(1, false, true, a, bu, 1, E, C, D, D, F, uw, C, F, D, F)
    cudaError_t err = run<false, true, EPI_F32>(L, ctas, s);
    if (err != cudaSuccess) return (int)err;
  }
  // (2) dh = dy Wd^T: (C x F) over K = D; Wd (F, D) is B K-major; the
  // epilogue writes h, dg and du
  {
    const void* a[1] = {dy};
    const void* b[1] = {wd};
    L.nprod = 1;
    PRODUCT(0, false, false, a, b, 1, E, C, D, F, D, nullptr, C, F, D, F)
    L.gw = gw, L.uw = uw, L.h = h, L.dg = dg, L.du = du;
    cudaError_t err = run<false, false, EPI_SWIGLU>(L, ctas, s);
    if (err != cudaSuccess) return (int)err;
  }
  // (3) dWd = h^T dy (F x D), dWg = x^T dg, dWu = x^T du (D x F), over
  // K = C: every operand MN-major
  {
    const void* ah[1] = {h};
    const void* ax[1] = {x};
    const void* bdy[1] = {dy};
    const void* bdg[1] = {dg};
    const void* bdu[1] = {du};
    L.nprod = 3;
    PRODUCT(0, true, true, ah, bdy, 1, E, C, F, C, D, dwd, F, D, C, D)
    PRODUCT(1, true, true, ax, bdg, 1, E, C, D, C, F, dwg, D, F, C, F)
    PRODUCT(2, true, true, ax, bdu, 1, E, C, D, C, F, dwu, D, F, C, F)
    cudaError_t err = run<true, true, EPI_TMA>(L, ctas, s);
    if (err != cudaSuccess) return (int)err;
  }
  // (4) dx = dg Wg^T + du Wu^T: (C x D) over two K segments of F; Wg, Wu
  // (D, F) are B K-major
  {
    const void* a[2] = {dg, du};
    const void* b[2] = {wg, wu};
    L.nprod = 1;
    PRODUCT(0, false, false, a, b, 2, E, C, F, D, F, dx, C, D, F, D)
    cudaError_t err = run<false, false, EPI_STORE>(L, ctas, s);
    if (err != cudaSuccess) return (int)err;
  }
#undef PRODUCT
  return 0;
}

}  // namespace

extern "C" {

// Shared bytes a CTA of launch 0..3 takes (kernel.wgmma_plan computes the same).
long long fused_moe_bwd_wgmma_smem_bytes(int launch) {
  static const int bytes[4] = {Smem<EPI_F32>::BYTES, Smem<EPI_SWIGLU>::BYTES,
                               Smem<EPI_TMA>::BYTES, Smem<EPI_STORE>::BYTES};
  return launch < 0 || launch > 3 ? -1 : bytes[launch];
}

// x and dy (E, C, D), wg/wu (E, D, F), wd (E, F, D), bf16; dx, dwg, dwu, dwd
// shaped as x, wg, wu, wd; workspaces gw, uw (E, C, F) f32 and h, dg, du (E,
// C, F) bf16; all contiguous, every base and row a 16-byte multiple. ctas:
// the CTAs of a launch (the device's SMs). Four launches on `stream`, in
// order. Returns a cudaError_t, or 100000 + a CUresult where a tensor map
// could not be encoded.
int fused_moe_backward_wgmma(const void* x, const void* wg, const void* wu, const void* wd,
                             const void* dy, void* gw, void* uw, void* h, void* dg, void* du,
                             void* dx, void* dwg, void* dwu, void* dwd, int E, int C, int D, int F,
                             int ctas, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || ctas <= 0 || D % 8 || F % 8)
    return (int)cudaErrorInvalidValue;
  return backward(x, wg, wu, wd, dy, static_cast<float*>(gw), static_cast<float*>(uw),
                  static_cast<bf16*>(h), static_cast<bf16*>(dg), static_cast<bf16*>(du), dx, dwg,
                  dwu, dwd, E, C, D, F, ctas, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
