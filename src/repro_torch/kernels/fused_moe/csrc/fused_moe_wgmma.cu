// Fused MoE expert FFN forward on Hopper, bf16, on wgmma fed by TMA: for
// every expert e over its gathered token block x_e (capacity C),
//
//     y_e = (silu(x_e Wg[e]) * (x_e Wu[e])) Wd[e]
//
// Replaces _moe_kernel / fused_moe_pallas of
// src/repro/kernels/fused_moe/kernel.py for bf16 whose rows and bases are
// 16-byte multiples (kernel.fwd_engine), whatever the rows of a block: a
// decode tick's 4 rows an expert too, whose 64-row tile TMA fills with
// zeros past the expert's rows; fused_moe.cu (mma.sync) keeps f32 and rows
// TMA cannot address.
//
// What bounds it on an H100 SXM. At dbrx-132b's 1024-token prefill (E=16,
// 512 rows an expert, D=6144, F=10752) the three products are 3.25 TFLOP,
// 3.28 ms at the bf16 tensor-core peak, against 6.6 GB of weights and
// activations (2.0 ms at 3.35 TB/s): operations. The mma.sync engine
// reached 0.24 of that bound: warp-level products, operand loads that every
// thread addresses, and grids of short-lived CTAs.
//
// Design: two launches, as fused_moe.cu's (the TPU kernel's (block_m, D)
// f32 accumulator does not fit a CTA), each a persistent CTA an SM walking
// its launch's live tiles in the order kernel.fwd_wgmma_walk gives (m
// fastest, so that neighbouring CTAs share one weight panel in L2):
//   (a) gate/up: a tile is BMT (64 or 128) rows x 128 columns of F. Each K
//       step of 64 loads one B panel of 256 columns: the tile's 128 columns
//       of Wg, then the same 128 of Wu, four MN-major 64 x 64 TMA boxes, so
//       that one m64n256k16 yields g in accumulator columns 0-127 and u in
//       128-255. Column c and c + 128 sit in the same thread (indices i and
//       i + 64), so the epilogue forms h = silu(g) u in f32, rounds it to
//       bf16 once, and writes whole sectors of the (E, C, F) workspace
//       through each warp's row scratch; no f32 g or u goes to memory.
//   (b) down: y = h Wd, a tile BMT rows x 256 columns of D; h K-major, Wd
//       MN-major; K = F walked in order, 64 deep a stage; bf16 rows out
//       through the same row scratch.
//   - a warpgroup of 64 rows a consumer (BMT / 64 of them, 128 f32
//     accumulators a thread), one producer thread in a warpgroup that gives
//     its registers to two consumers (setmaxnreg); a ring of four 48 KB
//     stages (32 KB with one consumer) with full and empty mbarriers;
//   - the knobs: block_m rows a block, walked in sub-tiles of BMT; block_f
//     F columns a block of (a), walked in sub-tiles of 128 (columns of a
//     tile past its block are computed and not stored);
//   - ragged M, N and K need no masks on the loads: TMA fills a box's
//     out-of-bounds part with zeros; the stores are masked;
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

constexpr int BN = 256, BK = 64;       // a stage's B columns and k depth
constexpr int GATE_COLS = BN / 2;      // h columns of a gate/up tile
constexpr int B_BYTES = BN * BK * 2;   // 32 KB
constexpr int BOX = 64 * BK * 2;       // an MN-major box: 64 k-rows of 128 bytes
constexpr int STAGES = 4;
constexpr int ROWS_SCRATCH = 2048;     // a consumer warp's: 16 rows of 128 bytes

enum { EPI_SWIGLU = 1, EPI_STORE = 2 };  // (a): h = silu(g) u; (b): the sum

// A CTA's shared memory for KC consumer warpgroups (BMT = 64 KC rows): room
// to align the ring to 1024 bytes, the ring, each consumer warp's row
// scratch, 2 x STAGES barriers
template <int KC> struct Smem {
  static constexpr int A_BYTES = 64 * KC * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SCRATCH = 4 * KC * ROWS_SCRATCH;
  static constexpr int BYTES = 1024 + STAGES * STAGE_BYTES + SCRATCH + 2 * STAGES * 8;
};

// One launch: out (E, M, N) row-major = A (E, M, K) B (E, K, N), A read
// through map a (K-major boxes of 64 k x BMT rows), B through b0 and b1
// (MN-major boxes of 64 columns x 64 k: (a) Wg and Wu, (b) Wd twice).
struct Launch {
  CUtensorMap a, b0, b1;
  bf16* out;
  int E, M, N, K;
  // the walk (kernel.fwd_wgmma_walk): tiles an expert, row tiles of an
  // expert (row blocks x sub-tiles), sub-tiles a row block, rows a block;
  // column sub-tiles a column block, columns a block and a tile
  int tiles_e, row_tiles, row_subs, bm, col_subs, bc, tc;
};

// tile t of the walk: expert, first row, rows, first column, columns
template <int BMT>
__device__ __forceinline__ void tile_of(const Launch& L, int t, int& e, int& m0, int& rows,
                                        int& n0, int& cols) {
  e = t / L.tiles_e;
  const int r = t - e * L.tiles_e;
  const int mi = r % L.row_tiles, ci = r / L.row_tiles;
  const int ms = mi % L.row_subs, cs = ci % L.col_subs;
  m0 = (mi / L.row_subs) * L.bm + ms * BMT;
  rows = min(BMT, L.bm - ms * BMT);
  n0 = (ci / L.col_subs) * L.bc + cs * L.tc;
  cols = min(min(L.tc, L.bc - cs * L.tc), L.N - n0);
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// The epilogues. acc[4j + 2h + c] is row 64 wg + 16 warp + lane / 4 + 8 h,
// column 8 j + 2 (lane % 4) + c of the accumulator (256 columns).
template <int EPI>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2], const Launch& L,
                                         uint32_t scratch, int e, int m0, int rows, int n0,
                                         int cols, int wg, int warp, int lane) {
  const int rw = wg * 64 + warp * 16;  // this warp's first row in the tile
  if (rw >= rows) return;
  bf16* base = L.out + (size_t)e * L.M * L.N + (size_t)(m0 + rw) * L.N + n0;
  constexpr int QUADS = (EPI == EPI_SWIGLU ? GATE_COLS : BN) / 32;
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    if (32 * q >= cols) break;
    uint32_t w[4][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int i = 4 * (4 * q + jj) + 2 * h2;
        if constexpr (EPI == EPI_SWIGLU)  // g at i, u at i + 64 (column + 128)
          w[jj][h2] = pack2(silu(acc[i]) * acc[i + 64], silu(acc[i + 1]) * acc[i + 65]);
        else
          w[jj][h2] = pack2(acc[i], acc[i + 1]);
      }
    store_rows(w, scratch, base + 32 * q, L.N, rows - rw, cols - 32 * q, lane);
  }
}

template <int KC, int EPI>
__global__ void __launch_bounds__(128 * (KC + 1), 1) moe_fwd_wgmma(const __grid_constant__ Launch L) {
  constexpr int BMT = 64 * KC;
  using S = Smem<KC>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u, scratch = ring + STAGES * S::STAGE_BYTES;
  const uint32_t full = scratch + S::SCRATCH, empty = full + STAGES * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);     // the producer's arrival, then the bytes
      mbar_init(empty + 8 * s, KC);   // one arrival a consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int total = L.E * L.tiles_e;
  const int wg = threadIdx.x / 128;
  const int nk = (L.K + BK - 1) / BK;

  if (wg == KC) {
    // ------------------------------------------------ producer warpgroup
    if constexpr (KC == 2) setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        int e, m0, rows, n0, cols;
        tile_of<BMT>(L, t, e, m0, rows, n0, cols);
        for (int i = 0; i < nk; ++i) {
          const int k0 = i * BK;
          const uint32_t fb = full + 8 * stage, sa = ring + stage * S::STAGE_BYTES,
                         sb = sa + S::A_BYTES;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_arrive_expect_tx(fb, S::STAGE_BYTES);
          tma_load_3d(sa, &L.a, fb, k0, m0, e);  // 64 k x BMT rows
          if (EPI == EPI_SWIGLU) {  // Wg's columns n0, n0 + 64, then Wu's
            tma_load_3d(sb, &L.b0, fb, n0, k0, e);
            tma_load_3d(sb + BOX, &L.b0, fb, n0 + 64, k0, e);
            tma_load_3d(sb + 2 * BOX, &L.b1, fb, n0, k0, e);
            tma_load_3d(sb + 3 * BOX, &L.b1, fb, n0 + 64, k0, e);
          } else {  // Wd's 256 columns from n0
#pragma unroll
            for (int j = 0; j < BN / 64; ++j) tma_load_3d(sb + j * BOX, &L.b0, fb, n0 + 64 * j, k0, e);
          }
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    if constexpr (KC == 2) setmaxnreg_inc<232>();
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const bool elected = threadIdx.x % 128 == 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      int e, m0, rows, n0, cols;
      tile_of<BMT>(L, t, e, m0, rows, n0, cols);
      int prev = 0;
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) fence_operand(acc[j]);
      for (int i = 0; i < nk; ++i) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t sa = ring + stage * S::STAGE_BYTES, sb = sa + S::A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // this warpgroup's 64 rows of A, and the kk-th 16 of the step's k
          const uint64_t da = wgmma_desc(sa + wg * 8192 + kk * 32, 16, 1024);
          const uint64_t db = wgmma_desc(sb + kk * 2048, BOX, 1024);
          wgmma_m64n256k16<0, 1>(acc, da, db, (i > 0 || kk > 0) ? 1 : 0);
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
      epilogue<EPI>(acc, L, scratch + (wg * 4 + warp) * ROWS_SCRATCH, e, m0, rows, n0, cols, wg,
                    warp, lane);
    }
  }
}

// ---------------------------------------------------------------- host side

template <int KC, int EPI>
cudaError_t run(Launch& L, int ctas, cudaStream_t stream) {
  static int configured[kMaxDevices] = {};
  constexpr int smem = Smem<KC>::BYTES;
  const cudaError_t err = opt_in(moe_fwd_wgmma<KC, EPI>, smem, configured);
  if (err != cudaSuccess) return err;
  const int grid = std::min(ctas, L.E * L.tiles_e);
  moe_fwd_wgmma<KC, EPI><<<grid, 128 * (KC + 1), smem, stream>>>(L);
  return cudaGetLastError();
}

// the walk's numbers (kernel.fwd_wgmma_plan computes the same)
void walk(Launch& L, int C, int bm, int bmt, int ncols, int bc, int tc) {
  L.row_subs = (bm + bmt - 1) / bmt;
  L.row_tiles = (C / bm) * L.row_subs;
  L.bm = bm;
  L.col_subs = (bc + tc - 1) / tc;
  L.bc = bc;
  L.tc = tc;
  L.tiles_e = L.row_tiles * ((ncols + bc - 1) / bc) * L.col_subs;
}

template <int KC>
int forward(const void* x, const void* wg, const void* wu, const void* wd, bf16* h, bf16* out,
            int E, int C, int D, int F, int bm, int bf, int ctas, cudaStream_t s) {
  constexpr int BMT = 64 * KC;
  Launch L = {};
  L.E = E;
  // (a) h = silu(x Wg) (x Wu): (C x F) over K = D; x K-major, Wg and Wu MN-major
  int r = encode_bf16_3d(&L.a, x, D, C, E, 64, BMT);
  if (r == CUDA_SUCCESS) r = encode_bf16_3d(&L.b0, wg, F, D, E, 64, BK);
  if (r == CUDA_SUCCESS) r = encode_bf16_3d(&L.b1, wu, F, D, E, 64, BK);
  if (r != CUDA_SUCCESS) return kEncodeError + r;
  L.out = h, L.M = C, L.N = F, L.K = D;
  walk(L, C, bm, BMT, F, bf, GATE_COLS);
  cudaError_t err = run<KC, EPI_SWIGLU>(L, ctas, s);
  if (err != cudaSuccess) return (int)err;
  // (b) y = h Wd: (C x D) over K = F; h K-major, Wd MN-major
  r = encode_bf16_3d(&L.a, h, F, C, E, 64, BMT);
  if (r == CUDA_SUCCESS) r = encode_bf16_3d(&L.b0, wd, D, F, E, 64, BK);
  if (r != CUDA_SUCCESS) return kEncodeError + r;
  L.b1 = L.b0;
  L.out = out, L.M = C, L.N = D, L.K = F;
  walk(L, C, bm, BMT, D, BN, BN);
  return (int)run<KC, EPI_STORE>(L, ctas, s);
}

}  // namespace

extern "C" {

// Shared bytes a CTA of either launch takes with `consumers` (1 or 2)
// consumer warpgroups (kernel.fwd_wgmma_plan computes the same).
long long fused_moe_wgmma_smem_bytes(int consumers) {
  return consumers == 1 ? Smem<1>::BYTES : consumers == 2 ? Smem<2>::BYTES : -1;
}

// x (E, C, D), wg/wu (E, D, F), wd (E, F, D), bf16, all contiguous, every
// base and row a 16-byte multiple; h an (E, C, F) bf16 workspace, out (E, C,
// D). bm divides C (up to 64: one consumer warpgroup of 64-row tiles, the
// rows past a block computed and not stored; more: two, tiles of 128); bf
// divides F. ctas: the CTAs of a launch
// (the device's SMs). Launches (a) then (b) on `stream`. Returns a
// cudaError_t, or 100000 + a CUresult where a tensor map could not be
// encoded.
int fused_moe_forward_wgmma(const void* x, const void* wg, const void* wu, const void* wd, void* h,
                            void* out, int E, int C, int D, int F, int bm, int bf, int ctas,
                            void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || ctas <= 0 || D % 8 || F % 8 || bm <= 0 || bf <= 0 ||
      C % bm || F % bf)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm <= 64)
    return forward<1>(x, wg, wu, wd, static_cast<bf16*>(h), static_cast<bf16*>(out), E, C, D, F,
                      bm, bf, ctas, s);
  return forward<2>(x, wg, wu, wd, static_cast<bf16*>(h), static_cast<bf16*>(out), E, C, D, F, bm,
                    bf, ctas, s);
}

}  // extern "C"
