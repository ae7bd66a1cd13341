// Fused MoE expert FFN forward on Hopper, f32 as 3xTF32, on wgmma fed by
// TMA: for every expert e over its gathered token block x_e (capacity C),
//
//     y_e = (silu(x_e Wg[e]) * (x_e Wu[e])) Wd[e]
//
// Replaces _moe_kernel / fused_moe_pallas of
// src/repro/kernels/fused_moe/kernel.py for f32 whose rows and bases TMA
// can address (D and F multiples of 4 values, 16-byte bases;
// kernel.fwd_engine): the tuner's f32 workloads and f32 training of an MoE
// model. fused_moe.cu (mma.sync) keeps the rows TMA cannot address, and
// fused_moe_wgmma.cu bf16.
//
// What bounds it on an H100 SXM. The three products are 6 E C D F
// operations, and 3xTF32 runs each three times on the tensor cores: at the
// tuner's f32 workload (E=16, C=256, D=6144, F=10752) 3 x 1.6235 TFLOP, 9.84
// ms at the 495 TFLOP/s TF32 peak, against 12.88 GB of weights and
// activations (3.84 ms at 3.35 TB/s): operations. The reference's f32 2e-5
// rules out plain TF32; f32 outside the tensor cores peaks at 67 TFLOP/s
// (24.2 ms).
//
// Design: the method of fused_moe_bwd_tf32.cu, in three launches.
//   - products: wgmma.mma_async m64nNk8 tf32 with A from registers and B
//     from shared memory. tf32 wgmma reads B only K-major (K contiguous),
//     and g = x Wg has B = Wg (D x F), which lies MN-major. So each product
//     is written with the tokens as B, as they lie, and the weights as A,
//     which registers take in any layout:
//       (a) g^T = Wg^T x^T (F x C, K = D): A = Wg (MN-major), B = x; g^T
//           lands in an (E, F, Cp) workspace;
//       (b) u^T = Wu^T x^T, the same product of Wu; the epilogue reads g^T
//           at the same places and writes h = silu(g) u as (E, C, F), so
//           that (c) reads it K-major;
//       (c) y^T = Wd^T h^T (D x C, K = F): A = Wd (MN-major), B = h; the
//           epilogue writes y (E, C, D) transposed: lanes on neighbouring
//           rows of the tile write neighbouring d, so each store covers
//           whole 32-byte sectors.
//     No weight is copied. Cp is C rounded up to 4 (g^T's rows are 16-byte
//     multiples); its pads are never read.
//   - 3xTF32: A's hi and lo are made in registers where a consumer
//     warpgroup loads its fragment from the landed tile; B's lo is a tile
//     of its own in the same stage, made by three splitter warps; B's hi is
//     the landed tile itself (hopper.cuh's load_a_tf32 and tf32_lo).
//   - tiles: 128 rows (weights' columns: F, or D for (c)) x BN columns
//     (tokens), two consumer warpgroups of 64 rows each; BN = 64 where the
//     block_m knob is at most 64, else 128. A thread holds `part`, the
//     wgmma accumulator of one stage's products, and `acc`, the tile's sum,
//     into which each stage's part is added in IEEE f32: wgmma's own
//     accumulation over K = 6144 drifts some 2e-4 of max|ref| from float64
//     (fused_moe_bwd_tf32.cu's finding).
//   - knobs: block_m cuts C into blocks, each walked in tiles of BN columns;
//     block_f cuts F into blocks for (a) and (b), each walked in tiles of
//     128 rows. Columns and rows of a tile past its block are computed and
//     not stored (the next block's tile computes them in the same order),
//     as fused_moe_wgmma.cu does. The sum of (c) over F walks block_f steps
//     in order, 32-deep stages that never straddle a step: the engine takes
//     block_f multiples of 32, or block_f = F (one step).
//   - loads: one TMA tensor map per operand over (expert, rows, cols),
//     128-byte swizzle, K steps of 32; a ring of four stages (A, B and B's
//     lo: 48 KB at BN 128) with full, split and empty mbarriers; one
//     producer thread starts the loads, three warps split B. Ragged M, N
//     and K need no masks: TMA fills a box's out-of-bounds part with zeros.
//   - scheduling: one persistent CTA an SM walks the launch's tiles flat
//     over (expert, row tile, column tile) with columns fastest, so that
//     the CTAs that read one weight panel run together and the second read
//     hits L2 (kernel.tf32_fwd_walk).
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
constexpr int A_BYTES = BM * BK * 4;              // 16 KB: four MN-major boxes
constexpr int STAGES = 4;

// BN: the tile's columns; a stage holds A, B and B's lo
template <int BN> struct Cfg {
  static constexpr int B_BYTES = BN * BK * 4;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  // room to align the ring to 1024 bytes, the ring, its full, split and empty barriers
  static constexpr int BYTES = 1024 + STAGES * STAGE_BYTES + 3 * STAGES * 8;
};

// The launches, each its own instance so that a profile tells them apart
enum { GATE = 0, UP = 1, DOWN = 2 };

// One launch: per expert, out^T (M x N) = A (K x M, MN-major) ^T B (N x K,
// K-major). Its tiles: row blocks of rb rows (block_f, or M) in row_subs
// tiles of BM; column blocks of cb columns (block_m) in col_subs tiles of
// BN. A tile stores the rows and columns inside its blocks; the last
// column block stores up to nlim (Cp for g^T, else N).
struct Launch {
  CUtensorMap a, b;
  float* out;       // GATE: g^T (E, M, ldo); UP: h (E, N, M); DOWN: y (E, N, M)
  const float* gt;  // UP: g^T, laid out as GATE's out
  int E, M, N, K, ldo, nlim;
  int rb, row_subs, row_tiles, cb, col_subs, col_tiles, tiles_e;
};

// tile t of the walk: expert, first row, rows stored, first column,
// columns stored
template <int BN>
__device__ __forceinline__ void tile_of(const Launch& L, int t, int& e, int& m0, int& rows, int& n0,
                                        int& cols) {
  e = t / L.tiles_e;
  const int r = t - e * L.tiles_e;
  const int ci = r % L.col_tiles, mi = r / L.col_tiles;
  const int mb = mi / L.row_subs, nb = ci / L.col_subs;
  m0 = mb * L.rb + (mi % L.row_subs) * BM;
  rows = min(BM, min((mb + 1) * L.rb, L.M) - m0);
  n0 = nb * L.cb + (ci % L.col_subs) * BN;
  const int n_end = min((nb + 1) * L.cb, L.N);
  cols = min(BN, (n_end == L.N ? L.nlim : n_end) - n0);
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// The epilogues. acc[4j + 2h + c] is row r0 + lane / 4 + 8 h, column 8 j +
// 2 (lane % 4) + c of the tile at (m0, n0) of expert e (r0: the warp's
// first row); rows and cols bound what is stored, and each is even where a
// pair is stored.
template <int LAUNCH, int BN>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2], const Launch& L, int e, int m0,
                                         int rows, int n0, int cols, int r0, int lane) {
  const int rr = r0 + lane / 4, cc = 2 * (lane % 4);
  if constexpr (LAUNCH == GATE) {  // g^T as it lies, two columns a lane
    float* out = L.out + ((size_t)e * L.M + m0) * L.ldo + n0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = rr + 8 * h2, c = cc + 8 * j;
        if (r < rows && c < cols)
          *reinterpret_cast<float2*>(out + (size_t)r * L.ldo + c) =
              make_float2(acc[4 * j + 2 * h2], acc[4 * j + 2 * h2 + 1]);
      }
  } else if constexpr (LAUNCH == UP) {  // h = silu(g) u, transposed: h[c][f]
    const float* gt = L.gt + ((size_t)e * L.M + m0) * L.ldo + n0;
    float* out = L.out + ((size_t)e * L.N + n0) * L.M + m0;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {  // eight columns at a time: every g load before any use
      float2 gv[4][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = rr + 8 * h2, c = cc + 8 * (4 * q + jj);
          gv[jj][h2] = make_float2(0.f, 0.f);
          if (r < rows && c < cols)
            gv[jj][h2] = __ldcs(reinterpret_cast<const float2*>(gt + (size_t)r * L.ldo + c));
        }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = rr + 8 * h2, c = cc + 8 * (4 * q + jj), i = 4 * (4 * q + jj) + 2 * h2;
          if (r >= rows) continue;
          if (c < cols) out[(size_t)c * L.M + r] = silu(gv[jj][h2].x) * acc[i];
          if (c + 1 < cols) out[(size_t)(c + 1) * L.M + r] = silu(gv[jj][h2].y) * acc[i + 1];
        }
    }
  } else {  // y, transposed: y[c][d]
    float* out = L.out + ((size_t)e * L.N + n0) * L.M + m0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = rr + 8 * h2, c = cc + 8 * j;
        if (r >= rows) continue;
        if (c < cols) out[(size_t)c * L.M + r] = acc[4 * j + 2 * h2];
        if (c + 1 < cols) out[(size_t)(c + 1) * L.M + r] = acc[4 * j + 2 * h2 + 1];
      }
  }
}

template <int LAUNCH, int BN>
__global__ void __launch_bounds__(kThreads, 1) moe_fwd_tf32(const __grid_constant__ Launch L) {
  using G = Cfg<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + STAGES * G::STAGE_BYTES, split = full + STAGES * 8,
                 empty = split + STAGES * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);            // the producer's arrival, then the bytes
      mbar_init(split + 8 * s, kSplitters);  // one arrival a splitter thread
      mbar_init(empty + 8 * s, kConsumers);  // one arrival a consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int total = L.E * L.tiles_e, nk = (L.K + BK - 1) / BK;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;

  if (wg == kConsumers) {
    // ------------------------------------------- producer and splitters
    setmaxnreg_dec<40>();
    int stage = 0;
    uint32_t phase = 0;
    if (warp == 0) {
      if (lane == 0) {
        for (int t = blockIdx.x; t < total; t += gridDim.x) {
          int e, m0, rows, n0, cols;
          tile_of<BN>(L, t, e, m0, rows, n0, cols);
          for (int i = 0; i < nk; ++i) {
            const uint32_t fb = full + 8 * stage, sa = ring + stage * G::STAGE_BYTES;
            mbar_wait(empty + 8 * stage, phase ^ 1);
            mbar_arrive_expect_tx(fb, A_BYTES + G::B_BYTES);
#pragma unroll
            for (int j = 0; j < BM / 32; ++j)  // four boxes of 32 columns (rows of A) x 32 k
              tma_load_3d(sa + j * kTf32BoxMN, &L.a, fb, m0 + 32 * j, i * BK, e);
            tma_load_3d(sa + A_BYTES, &L.b, fb, i * BK, n0, e);  // 32 k x BN rows of B
            if (++stage == STAGES) stage = 0, phase ^= 1;
          }
        }
      }
    } else {
      // B's lo, chunk by chunk at the landed tile's own offsets
      const int tid = threadIdx.x % 128 - 32;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        for (int i = 0; i < nk; ++i) {
          const uint32_t sb = ring + stage * G::STAGE_BYTES + A_BYTES, sl = sb + G::B_BYTES;
          mbar_wait(full + 8 * stage, phase);
          for (int c = tid; c < G::B_BYTES / 16; c += kSplitters)
            st_shared_v4(sl + 16 * c, tf32_lo(ld_shared_v4(sb + 16 * c)));
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
      int e, m0, rows, n0, cols;
      tile_of<BN>(L, t, e, m0, rows, n0, cols);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
      for (int i = 0; i < nk; ++i) {
        mbar_wait(full + 8 * stage, phase);
        mbar_wait(split + 8 * stage, phase);
        const uint32_t sa = ring + stage * G::STAGE_BYTES, sb = sa + A_BYTES, sl = sb + G::B_BYTES;
        uint32_t hi[BK / 8][4], lo[BK / 8][4];
        load_a_tf32<true>(sa, r0, lane, hi, lo);
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
      epilogue<LAUNCH, BN>(acc, L, e, m0, rows, n0, cols, r0, lane);
    }
  }
}

// ---------------------------------------------------------------- host side

template <int LAUNCH, int BN>
cudaError_t run(const Launch& L, int ctas, cudaStream_t stream) {
  static int configured[kMaxDevices] = {};
  constexpr int smem = Cfg<BN>::BYTES;
  const cudaError_t err = opt_in(moe_fwd_tf32<LAUNCH, BN>, smem, configured);
  if (err != cudaSuccess) return err;
  moe_fwd_tf32<LAUNCH, BN><<<std::min(ctas, L.E * L.tiles_e), kThreads, smem, stream>>>(L);
  return cudaGetLastError();
}

template <int LAUNCH>
cudaError_t run_cols(const Launch& L, int bn, int ctas, cudaStream_t stream) {
  return bn == 64 ? run<LAUNCH, 64>(L, ctas, stream) : run<LAUNCH, 128>(L, ctas, stream);
}

// The BN of a block of bm tokens (kernel.tf32_fwd_plan computes the same)
int cols_for(int bm) { return bm <= 64 ? 64 : 128; }

// A launch's maps and walk: out^T (M x N) over K, A (K rows of M values,
// rows `lda` apart) MN-major, B (N rows of K values) K-major; row blocks of
// rb and column blocks of cb, each dividing its dimension
int plan(Launch& L, const void* a, int lda, const void* b, int M, int N, int K, int rb, int cb,
         int bn) {
  int r = encode_f32_3d(&L.a, a, M, K, L.E, lda, 32, BK);
  if (r == CUDA_SUCCESS) r = encode_f32_3d(&L.b, b, K, N, L.E, K, BK, bn);
  if (r != CUDA_SUCCESS) return r;
  L.M = M, L.N = N, L.K = K;
  L.rb = rb, L.row_subs = (rb + BM - 1) / BM, L.row_tiles = (M / rb) * L.row_subs;
  L.cb = cb, L.col_subs = (cb + bn - 1) / bn, L.col_tiles = (N / cb) * L.col_subs;
  L.tiles_e = L.row_tiles * L.col_tiles;
  return CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Shared bytes a CTA takes with tiles of bn (64 or 128) columns
// (kernel.tf32_fwd_plan computes the same); -1 for another bn.
long long fused_moe_tf32_smem_bytes(int bn) {
  return bn == 64 ? Cfg<64>::BYTES : bn == 128 ? Cfg<128>::BYTES : -1;
}

// x (E, C, D), wg/wu (E, D, F), wd (E, F, D), f32, all contiguous, every
// base a 16-byte multiple, D and F multiples of 4; workspaces gt (E, F, Cp)
// with Cp = C rounded up to 4 and h (E, C, F), f32; out (E, C, D). bm
// divides C, bf divides F and is a multiple of 32 or F itself. ctas: the
// CTAs of a launch (the device's SMs). Launches (a), (b), (c) on `stream`.
// Returns a cudaError_t, or 100000 + a CUresult where a tensor map could
// not be encoded.
int fused_moe_forward_tf32(const void* x, const void* wg, const void* wu, const void* wd,
                           void* gt, void* h, void* out, int E, int C, int D, int F, int bm,
                           int bf, int ctas, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || ctas <= 0 || D % 4 || F % 4 || bm <= 0 ||
      bf <= 0 || C % bm || F % bf || (bf % 32 && bf != F))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Cp = (C + 3) / 4 * 4, bn = cols_for(bm);
  Launch L = {};
  L.E = E;
  // (a) g^T = Wg^T x^T: (F x C) over K = D; Wg (D, F) MN-major, x (C, D)
  int r = plan(L, wg, F, x, F, C, D, bf, bm, bn);
  if (r != CUDA_SUCCESS) return kEncodeError + r;
  L.out = static_cast<float*>(gt), L.ldo = Cp, L.nlim = Cp;
  cudaError_t err = run_cols<GATE>(L, bn, ctas, s);
  if (err != cudaSuccess) return (int)err;
  // (b) u^T = Wu^T x^T, and h = silu(g) u into (E, C, F)
  r = plan(L, wu, F, x, F, C, D, bf, bm, bn);
  if (r != CUDA_SUCCESS) return kEncodeError + r;
  L.gt = static_cast<const float*>(gt), L.out = static_cast<float*>(h), L.nlim = C;
  err = run_cols<UP>(L, bn, ctas, s);
  if (err != cudaSuccess) return (int)err;
  // (c) y^T = Wd^T h^T: (D x C) over K = F, walked in order; Wd (F, D)
  // MN-major, h (C, F); y (E, C, D) written transposed
  r = plan(L, wd, D, h, D, C, F, D, bm, bn);
  if (r != CUDA_SUCCESS) return kEncodeError + r;
  L.out = static_cast<float*>(out), L.gt = nullptr, L.nlim = C;
  return (int)run_cols<DOWN>(L, bn, ctas, s);
}

}  // extern "C"
