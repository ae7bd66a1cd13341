// Flash attention backward at head dims 80 and 128 on Hopper, f32 as
// 3xTF32, on wgmma fed by TMA. It computes what flash_attention_bwd.cu
// computes for f32 (the FA2 backward of flash_attention.cu: P = exp(S -
// lse) recomputed tile by tile, dV = P^T dO, dP = dO V^T, dS = P (dP -
// Delta) times 1 - tanh^2(s / c) under a softcap c, dK = dS^T Q scale, dQ =
// dS K scale), with every mask of that file: GQA, causal, a window, rows
// that see no key (P = 1 / Skv, dS = 0) and the query offset (row i sits at
// position q_offset + i). It reads the lse of either f32 forward engine.
// flash_attention_bwd.cu keeps f32 at the other head dims and bases TMA
// cannot address, flash_attention_bwd_wgmma.cu bf16; the reference has no
// backward kernel (XLA differentiates its plain attention), so this is the
// backward of the port's forward kernel, which replaces `_fa_kernel` of
// src/repro/kernels/flash_attention/kernel.py.
//
// What bounds it on an H100 SXM: operations. At qwen3-0.6b's f32 training
// shape (B2 S256, 16 q / 8 kv heads of 128, causal) the mask keeps 1.05 M
// pairs a head; the five products a backward needs are 2.7 GFLOP, and
// 3xTF32 runs each three times on the tensor cores: 0.0163 ms at the 495
// TFLOP/s TF32 peak (0.040 ms at f32's 67 TFLOP/s outside them), against 7
// MB moved. 3xTF32 holds the reference's f32 2e-5 where plain TF32 does
// not: a b = a_hi b_hi + a_lo b_hi + a_hi b_lo, hi the top 19 bits of the
// f32 word and lo = x - hi exactly.
//
// Design: two launches, dQ (whose prologue also writes Delta = rowsum(dO
// O), which dK/dV reads) then dK/dV, as flash_attention_bwd_wgmma.cu does.
// A CTA is one consumer warpgroup of 64 rows (q rows for dQ, keys for dK/dV)
// and one warpgroup that loads and splits: warp 4's first thread starts the
// TMA loads, warps 5-7 make the lo tiles (and, for dK/dV, bring each step's
// lse and Delta). Every tile is rows x D f32, loaded through a 4-D tensor
// map over (D, heads, rows, B) in boxes of 32 columns (128 bytes, 128-byte
// swizzle) of 64 resident rows or 32 streamed ones; D 80 takes three boxes
// a row, TMA filling columns 80-95 with zeros. Rows past S or Skv load as
// zeros.
//
// tf32 wgmma reads B only K-major, from shared memory A too. S = Q K^T and
// dP = dO V^T have both operands K-major as they lie (the head dim is K):
// both from shared memory, each with its lo tile, three products a k step
// (m64n32k8). The three products over the step's rows (dQ += dS K, dV +=
// P^T dO, dK += dS^T Q) have the rows as K and the head dim as N, which no
// tile lies K-major for. So each is computed transposed, with the head dim
// as M: dQ^T += K^T dS^T, dV^T += dO^T P, dK^T += Q^T dS. A (K^T, dO^T,
// Q^T) comes from registers, which take any layout: each thread loads its
// fragment from the landed row tile, one 32-bit load a value, and splits it
// there. B (dS^T, P, dS) is the step's accumulator, split and staged into
// shared memory row-major, which is K-major for it (m64n64k8: its 64 rows
// are N). No tile is copied and nothing is transposed in device memory; the
// head dim takes one M half of 64 at D 64 and two at 80 and 128 (at 80 the
// second half's rows past 80 are zeros and are not stored). Each half's
// products go into `part` (scale_d 0 first), added into the f32 total
// after the step: wgmma's own accumulation over a long K drifts from
// float64 (fused_moe_bwd_tf32.cu's finding).
//
//   dQ: a CTA owns 64 q rows of one head, Q and dO resident with their lo
//   tiles, K and V tiles of 32 keys streaming; the heaviest causal block
//   launches first.
//
//   dK/dV: a CTA owns 64 keys of one KV head, K and V resident with their lo
//   tiles, and walks some of its group's q heads and the tiles of 32 q rows
//   that see its keys (or hold rows that see no key), the q and dO tiles
//   streaming beside each step's lse (log2 units) and Delta. It computes S^T = K Q^T and dP^T = V dO^T, so P^T and
//   dS^T lie with the keys as rows, as they are staged. Where the key blocks
//   alone leave most of the card idle (qwen3-0.6b's f32 shape: 64 CTAs;
//   dbrx-132b's: 16), the group's q heads are split over `splits` CTAs a
//   key block (grid z), each writing its sums to a workspace, which a third
//   launch adds up in split order: still no atomics.
//
// Shared memory. The resident tiles and their lo take 128 KB at D 128, which
// leaves no room for a second stage of streamed tiles with their lo. So the
// streamed tiles land in a ring of two slots, the producer loading step j +
// 1's while step j computes, and their lo tiles in a ring of lo buffers,
// which the splitter warps fill for a step once the step before it that
// used the buffer is done with it: after a step's S and dP (S^T and dP^T)
// products its lo tiles are dead, and the buffer takes the step's staged
// accumulators. One lo buffer at D 128 (224 KB for either launch), so its
// split waits for the last step; two at D 80 (192 KB for dQ, 209 KB for
// dK/dV), where it runs under the last step. Every tile on a mask edge takes the masks by
// selects after all its pairs are computed as if visible; a warp tile
// wholly inside skips the position tests. Kernels are built with and
// without a softcap (CAP), so no pair pays for the test. Each wgmma group
// is waited for before the registers it writes are read, on every path.
//
// Determinism: no atomics; every CTA walks its steps in one fixed order, so
// reruns are bit-equal. tanh is 1 - 2 / (e^2y + 1) on the special-function
// unit, as the forward engines form it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;   // warpgroup 0 computes; warp 4 loads, warps 5-7 split
constexpr int kSplitters = 96;  // the threads of warps 5-7
constexpr int ROWS = 64;        // q rows of a dQ CTA, keys of a dK/dV CTA
constexpr int STEP = 32;        // keys (dQ) or q rows (dK/dV) of a step
constexpr int RBOX = ROWS * 128, SBOX = STEP * 128;  // a 32-column box of 64 / 32 rows
constexpr int STG = ROWS * 128;  // a staged 64 x 32 f32 tile
constexpr int TURN = 1;          // named barrier: the consumer warpgroup's staging
constexpr float LOG2E = 1.4426950408889634f;

constexpr int SLOTS = 2;  // the ring of a step's streamed tiles

// boxes of 32 columns a row, M halves of 64 of the head dim, the bytes of a
// 64-row and of a 32-row tile, the lo buffers, the barriers (resident full
// and split; full and empty a slot; split and lo free a lo buffer)
template <int D>
struct Tiles {
  static constexpr int NB = (D + 31) / 32, MH = (D + 63) / 64;
  static constexpr int RES = NB * RBOX, STP = NB * SBOX;
  static constexpr int LOS = D == 128 ? 1 : 2;
  static constexpr int BARS = 2 + 2 * SLOTS + 2 * LOS;
  static constexpr int max(int a, int b) { return a > b ? a : b; }
};

// dQ's shared memory from the 1024-aligned base: Q, its lo, dO, its lo; the
// ring (K and V a slot); the lo buffers (K's and V's lo, then dS and its lo
// staged); the barriers
template <int D>
struct DqSmem : Tiles<D> {
  using T = Tiles<D>;
  static constexpr int Q = 0, QL = T::RES, DO = 2 * T::RES, DOL = 3 * T::RES, RING = 4 * T::RES;
  static constexpr int SLOT = 2 * T::STP, LO = RING + SLOTS * SLOT;
  static constexpr int LOB = T::max(2 * T::STP, 2 * STG);  // a lo buffer
  static constexpr int BAR = LO + T::LOS * LOB;
  static constexpr int BYTES = 1024 + BAR + 8 * T::BARS;
};
// dK/dV's: K, its lo, V, its lo; the ring (q and dO a slot); the lo buffers
// (q's and dO's lo, then P^T, its lo, dS^T, its lo staged); each lo
// buffer's step's lse and Delta (32 f32 each); the barriers
template <int D>
struct DkdvSmem : Tiles<D> {
  using T = Tiles<D>;
  static constexpr int K = 0, KL = T::RES, V = 2 * T::RES, VL = 3 * T::RES, RING = 4 * T::RES;
  static constexpr int SLOT = 2 * T::STP, LO = RING + SLOTS * SLOT;
  static constexpr int LOB = T::max(2 * T::STP, 4 * STG);  // a lo buffer
  static constexpr int LD = LO + T::LOS * LOB;
  static constexpr int BAR = LD + T::LOS * 2 * STEP * 4;
  static constexpr int BYTES = 1024 + BAR + 8 * T::BARS;
};

struct Params {
  // loads, (D, heads, rows, B) in boxes of 32 columns: dQ's q and dout of 64
  // rows and k and v of 32; dK/dV's k and v of 64 and q and dout of 32
  CUtensorMap q, k, v, dout;
  const float* o;          // (B, S, Hq, D): Delta's rows
  const float* dout_rows;  // the same for dO
  const float* lse;        // (B, Hq, S)
  float* delta;            // (B, Hq, S), written by dQ
  float *dq, *dk, *dv;     // (B, S, Hq, D), (B, Skv, Hkv, D)
  float* ws;               // null, or dK/dV's sums of each split: (2, splits, B, Skv, Hkv, D)
  int S, Skv, Hq, Hkv, causal, window, qoff, splits;
  float softcap, scale;
};

// ------------------------------------------------------------ masks

__device__ __forceinline__ int heavy_first(int y, int n, int rows, int S) {
  // the last q block, whose rows see the most keys under a causal mask,
  // first; a ragged last block, lighter than the full one before it, last
  if (S % rows != 0) return y == n - 1 ? n - 1 : n - 2 - y;
  return n - 1 - y;
}
// a row at position p that sees no key (the plain version averages v over all)
__device__ __forceinline__ bool no_key(int p, int Skv, int window) {
  return window > 0 && p >= Skv + window - 1;
}
__device__ __forceinline__ bool visible(int p, int kj, int causal, int window) {
  return (!causal || kj <= p) && (window <= 0 || kj > p - window);
}
// false only if no pair of positions [p0, p1] x keys [k0, k1] is visible
__device__ __forceinline__ bool tile_sees(int p0, int p1, int k0, int k1, int causal, int window) {
  return (!causal || k0 <= p1) && (window <= 0 || k1 > p0 - window);
}
// every pair of positions [p0, p1] x keys [k0, k1] is visible
__device__ __forceinline__ bool tile_inside(int p0, int p1, int k0, int k1, int causal,
                                            int window) {
  return (!causal || k1 <= p0) && (window <= 0 || k0 > p1 - window);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x on the special-function unit
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared_f2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x), "f"(y) : "memory");
}
__device__ __forceinline__ void st_shared_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// The score's constants in log2 units: x = s scale, or c tanh(s scale / c)
// under a softcap c, and P = 2^(x log2 e - lse log2 e)
template <bool CAP>
struct Score {
  float mul;   // no softcap: scale log2 e; with one: 2 log2 e scale / c (tanh's e^2y)
  float cap2;  // c log2 e
  __device__ Score(float scale, float softcap)
      : mul(CAP ? 2.f * LOG2E * scale / softcap : scale * LOG2E), cap2(softcap * LOG2E) {}
};

// P and dS of a visible pair from the raw products s = q . k and dp = dO .
// v: dS = P (dP - Delta), times 1 - tanh^2 under a softcap
struct Pd {
  float p, ds;
};
template <bool CAP>
__device__ __forceinline__ Pd pair(float s, float dp, float lse2, float delta,
                                   const Score<CAP>& sc) {
  if constexpr (!CAP) {
    const float p = ex2(fmaf(s, sc.mul, -lse2));
    return {p, p * (dp - delta)};
  }
  const float t = fmaf(-2.f, __fdividef(1.f, ex2(s * sc.mul) + 1.f), 1.f);
  const float p = ex2(fmaf(t, sc.cap2, -lse2));
  return {p, p * (dp - delta) * fmaf(-t, t, 1.f)};
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}

// ------------------------------------------------------------ splits, staging

// This thread's A fragments of X^T, split, for rows 64 mh .. 64 mh + 63 of
// it (columns of X, the head dim) over the 32 rows of X (its k): X a landed
// 32-row tile of NB boxes of 32 columns (box c: 32 rows of 128 bytes, 16-byte
// chunk j of row r at (j ^ (r % 8)) * 16). hi[kk][i] and lo[kk][i] hold row
// 64 mh + 16 warp + lane / 4 + 8 (i % 2), k 8 kk + lane % 4 + 4 (i / 2);
// columns past the tile's boxes are zeros. Each is pinned where it is made.
template <int NB>
__device__ __forceinline__ void load_t(uint32_t x, int mh, int warp, int lane,
                                       uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 64 * mh + 16 * warp + lane / 4 + 8 * (i % 2);
      const int k = 8 * kk + lane % 4 + 4 * (i / 2);
      uint32_t w = 0u;
      if (m < 32 * NB)
        w = ld_shared_b32(x + (m / 32) * SBOX + k * 128 + ((((m % 32) / 4) ^ (k % 8)) * 16) +
                          (m % 4) * 4);
      hi[kk][i] = w & kTf32Hi;
      lo[kk][i] = __float_as_uint(__uint_as_float(w) - __uint_as_float(hi[kk][i]));
      fence_operand(hi[kk][i]);
      fence_operand(lo[kk][i]);
    }
}

// This warpgroup's 64 x 32 f32 accumulator fragment (acc[4j + 2i + c]: row
// 16 warp + lane / 4 + 8 i, column 8 j + 2 (lane % 4) + c), split into the
// K-major tiles hi and lo (row r: 128 bytes, 16-byte chunk j at (j ^ (r %
// 8)) * 16), two columns a store
__device__ __forceinline__ void stage_split(uint32_t hi, uint32_t lo, const float (&acc)[16],
                                            int warp, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + lane / 4 + 8 * i, col = 8 * j + 2 * (lane % 4);
      const uint32_t at = r * 128 + (((col / 4) ^ (r % 8)) * 16) + (col % 4) * 4;
      const float x0 = acc[4 * j + 2 * i], x1 = acc[4 * j + 2 * i + 1];
      const float h0 = __uint_as_float(__float_as_uint(x0) & kTf32Hi);
      const float h1 = __uint_as_float(__float_as_uint(x1) & kTf32Hi);
      st_shared_f2(hi + at, h0, h1);
      st_shared_f2(lo + at, x0 - h0, x1 - h1);
    }
}

// the K-major descriptor of 8 columns (k step kk) of a tile of 32-column
// boxes of `box` bytes at `tile`
__device__ __forceinline__ uint64_t kstep(uint32_t tile, int kk, int box) {
  return wgmma_desc(tile + (kk / 4) * box + (kk % 4) * 32, 16, 1024);
}

// acc (64 rows x 32) = A B^T over the head dim, 3xTF32: A a resident 64-row
// tile and its lo, B a streamed 32-row tile and its lo (S = Q K^T, dP = dO
// V^T; S^T = K Q^T, dP^T = V dO^T)
template <int D>
__device__ __forceinline__ void rows_product(float (&acc)[16], uint32_t a, uint32_t al, uint32_t b,
                                             uint32_t bl) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint64_t ah = kstep(a, kk, RBOX), alo = kstep(al, kk, RBOX);
    const uint64_t bh = kstep(b, kk, SBOX), blo = kstep(bl, kk, SBOX);
    wgmma_tf32_ss<32>(acc, alo, bh, kk > 0 ? 1 : 0);
    wgmma_tf32_ss<32>(acc, ah, blo, 1);
    wgmma_tf32_ss<32>(acc, ah, bh, 1);
  }
}

// total (the head dim's M half mh x 64) += X^T Y over the step's 32 rows,
// 3xTF32: X the landed 32-row tile at x (A from registers, load_t), Y the
// staged tiles hi and lo (64 rows of 32, K-major). The half's products go
// into `part` and are added into `total` once done.
template <int NB>
__device__ __forceinline__ void head_product(float (&total)[32], float (&part)[32], uint32_t x,
                                             int mh, uint32_t hi, uint32_t lo, int warp,
                                             int lane) {
  uint32_t ah[4][4], al[4][4];
  load_t<NB>(x, mh, warp, lane, ah, al);
  fence_all(part);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bh = wgmma_desc(hi + kk * 32, 16, 1024), bl = wgmma_desc(lo + kk * 32, 16, 1024);
    wgmma_tf32<64>(part, al[kk], bh, kk > 0 ? 1 : 0);
    wgmma_tf32<64>(part, ah[kk], bl, 1);
    wgmma_tf32<64>(part, ah[kk], bh, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(part);
#pragma unroll
  for (int x2 = 0; x2 < 32; ++x2) total[x2] += part[x2];
}

// the barriers from `at`: resident full (the TMA thread) and split (the
// splitters); full (the TMA thread) and empty (the consumer's four warps) a
// slot; split (the splitters) and lo free (the consumer's four warps) a lo
// buffer
template <int LOS>
__device__ __forceinline__ void init_barriers(uint32_t at) {
  mbar_init(at, 1), mbar_init(at + 8, kSplitters);
  for (int s = 0; s < SLOTS; ++s)
    mbar_init(at + 16 + 8 * s, 1), mbar_init(at + 16 + 8 * SLOTS + 8 * s, 4);
  for (int l = 0; l < LOS; ++l)
    mbar_init(at + 16 + 16 * SLOTS + 8 * l, kSplitters),
        mbar_init(at + 16 + 16 * SLOTS + 8 * LOS + 8 * l, 4);
}

// ---------------------------------------------------------------- dQ

// the key tiles a dQ block's rows (positions [p0, p1]) see, in order
struct KeyWalk {
  int t, p0, p1;
  __device__ void settle(const Params& P) {
    while (!done(P) &&
           !tile_sees(p0, p1, t * STEP, min(t * STEP + STEP, P.Skv) - 1, P.causal, P.window))
      ++t;
  }
  __device__ bool done(const Params& P) const { return t * STEP >= P.Skv; }
  __device__ void next(const Params& P) {
    ++t;
    settle(P);
  }
};

template <int D, bool CAP>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dq_tf32(const __grid_constant__ Params P) {
  using G = DqSmem<D>;
  constexpr int NB = G::NB, MH = G::MH;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + G::Q, sQL = base + G::QL, sO = base + G::DO, sOL = base + G::DOL;
  const uint32_t ring = base + G::RING;
  const uint32_t rfull = base + G::BAR, rsplit = rfull + 8, full = rsplit + 8;
  const uint32_t empty = full + 8 * SLOTS, split = empty + 8 * SLOTS, lofree = split + 8 * G::LOS;
  const int b = blockIdx.x / P.Hq, h = blockIdx.x % P.Hq, hk = h / (P.Hq / P.Hkv);
  const int q0 = heavy_first(blockIdx.y, gridDim.y, ROWS, P.S) * ROWS;
  const int q1 = min(q0 + ROWS, P.S) - 1;
  if (threadIdx.x == 0) {
    init_barriers<G::LOS>(rfull);
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 4) {
    // ------------------------------------------ producer and splitters
    const bool producer = warp == 4;
    if (producer && lane != 0) return;
    const int tid = threadIdx.x - 160;  // a splitter's index
    if (producer) {
      mbar_arrive_expect_tx(rfull, 2 * G::RES);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(sQ + c * RBOX, &P.q, rfull, 32 * c, h, q0, b);
        tma_load_4d(sO + c * RBOX, &P.dout, rfull, 32 * c, h, q0, b);
      }
    } else {
      mbar_wait(rfull, 0);
      split_lo(sQ, sQL, G::RES, tid, kSplitters);
      split_lo(sO, sOL, G::RES, tid, kSplitters);
      fence_proxy_async();  // the lo tiles, visible to the wgmmas that read them
      mbar_arrive(rsplit);
    }
    KeyWalk walk{0, q0 + P.qoff, q1 + P.qoff};
    walk.settle(P);
    int slot = 0, lb = 0;
    uint32_t ph = 0, lph = 0;
    for (; !walk.done(P); walk.next(P)) {
      const uint32_t sk = ring + slot * G::SLOT, sv = sk + G::STP;
      const uint32_t sKL = base + G::LO + lb * G::LOB, sVL = sKL + G::STP;
      if (producer) {
        mbar_wait(empty + 8 * slot, ph ^ 1);
        mbar_arrive_expect_tx(full + 8 * slot, G::SLOT);
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(sk + c * SBOX, &P.k, full + 8 * slot, 32 * c, hk, walk.t * STEP, b);
          tma_load_4d(sv + c * SBOX, &P.v, full + 8 * slot, 32 * c, hk, walk.t * STEP, b);
        }
      } else {
        mbar_wait(full + 8 * slot, ph);
        mbar_wait(lofree + 8 * lb, lph ^ 1);  // the lo buffer's last step is done with it
        split_lo(sk, sKL, G::STP, tid, kSplitters);
        split_lo(sv, sVL, G::STP, tid, kSplitters);
        fence_proxy_async();
        mbar_arrive(split + 8 * lb);
      }
      if (++slot == SLOTS) slot = 0, ph ^= 1;
      if (++lb == G::LOS) lb = 0, lph ^= 1;
    }
    return;
  }

  // -------------------------------------------------- the consumer
  const int w0 = q0 + 16 * warp;  // this warp's rows w0 .. w0 + 15 (of S and dP)
  const size_t hstride = (size_t)P.Hq * D;
  const size_t rbase = ((size_t)b * P.S * P.Hq + h) * D;

  // Delta = rowsum(dO O) of this warp's 16 rows, two lanes a row, 16 bytes a load
  const int dr = w0 + lane / 2;
  float dsum = 0.f;
  if (dr < P.S) {
    const float* orow = P.o + rbase + (size_t)dr * hstride;
    const float* grow = P.dout_rows + rbase + (size_t)dr * hstride;
#pragma unroll 4
    for (int c = (lane % 2) * 4; c < D; c += 8) {
      const float4 a = *reinterpret_cast<const float4*>(orow + c);
      const float4 g = *reinterpret_cast<const float4*>(grow + c);
      dsum = fmaf(a.x, g.x, dsum);
      dsum = fmaf(a.y, g.y, dsum);
      dsum = fmaf(a.z, g.z, dsum);
      dsum = fmaf(a.w, g.w, dsum);
    }
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  const size_t lbase = ((size_t)b * P.Hq + h) * P.S;
  if (lane % 2 == 0 && dr < P.S) P.delta[lbase + dr] = dsum;
  // this thread's rows w0 + lane / 4 + 8 i: Delta, and lse in log2 units
  float dl[2], ll2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + lane / 4 + 8 * i;
    dl[i] = __shfl_sync(0xffffffffu, dsum, 2 * (lane / 4) + 16 * i);
    ll2[i] = r < P.S ? P.lse[lbase + r] * LOG2E : 0.f;
  }
  const Score<CAP> sc(P.scale, P.softcap);
  const int wp0 = w0 + P.qoff;  // the position of row w0

  float dq[MH][32], part[32];  // dQ^T: the head dim's halves x 64 q rows
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    part[j] = 0.f;
#pragma unroll
    for (int mh = 0; mh < MH; ++mh) dq[mh][j] = 0.f;
  }
  mbar_wait(rfull, 0);
  mbar_wait(rsplit, 0);
  KeyWalk walk{0, q0 + P.qoff, q1 + P.qoff};
  walk.settle(P);
  int slot = 0, lb = 0;
  uint32_t ph = 0, lph = 0;
  for (; !walk.done(P); walk.next(P)) {
    const uint32_t sk = ring + slot * G::SLOT, sv = sk + G::STP;
    // the lo buffer's two uses: K's and V's lo; dS and its lo staged
    const uint32_t sKL = base + G::LO + lb * G::LOB, sVL = sKL + G::STP;
    const uint32_t sDS = sKL, sDSL = sKL + STG;
    const int kt0 = walk.t * STEP;
    float s[16], dp[16];  // S and dP: 64 rows x 32 keys
    mbar_wait(full + 8 * slot, ph);
    mbar_wait(split + 8 * lb, lph);
    wgmma_fence();
    rows_product<D>(s, sQ, sQL, sk, sKL);
    rows_product<D>(dp, sO, sOL, sv, sVL);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(s);
    fence_all(dp);

    // P, times 1 - tanh^2 under a softcap, then dS = P (dP - Delta) in s (0
    // where masked); a warp whose 16 rows see all 32 keys skips the position
    // tests. Its rows past S need none: their Q and dO rows load as zeros
    // and their lse and Delta are 0, so dS is 0, and their dQ is not stored
    const bool inside = kt0 + STEP <= P.Skv &&
                        tile_inside(wp0, wp0 + 15, kt0, kt0 + STEP - 1, P.causal, P.window);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int i = (e / 2) % 2;
      const Pd g = pair(s[e], dp[e], ll2[i], dl[i], sc);
      s[e] = g.ds;
      if (!inside) {
        const int r = w0 + lane / 4 + 8 * i, kj = kt0 + 8 * (e / 4) + 2 * (lane % 4) + e % 2;
        const int pos = r + P.qoff;
        const bool seen = r < P.S && kj < P.Skv && !no_key(pos, P.Skv, P.window) &&
                          visible(pos, kj, P.causal, P.window);
        s[e] = seen ? s[e] : 0.f;
      }
    }
    named_barrier_sync(TURN, 128);  // every warp is done with the lo tiles
    stage_split(sDS, sDSL, s, warp, lane);
    fence_proxy_async();  // the staged tiles, visible to the wgmmas that read them
    named_barrier_sync(TURN, 128);
    // dQ^T += K^T dS^T, a half of the head dim at a time
#pragma unroll
    for (int mh = 0; mh < MH; ++mh) head_product<NB>(dq[mh], part, sk, mh, sDS, sDSL, warp, lane);
    __syncwarp();
    if (lane == 0) {  // this warp's reads of the slot and of the lo buffer are done
      mbar_arrive(empty + 8 * slot);
      mbar_arrive(lofree + 8 * lb);
    }
    if (++slot == SLOTS) slot = 0, ph ^= 1;
    if (++lb == G::LOS) lb = 0, lph ^= 1;
  }

  // dQ = (dQ^T)^T scale: this thread's head-dim rows 64 mh + 16 warp +
  // lane / 4 + 8 i, q columns 8 j + 2 (lane % 4) + c
  float* out = P.dq + rbase + (size_t)q0 * hstride;
#pragma unroll
  for (int mh = 0; mh < MH; ++mh)
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int d = 64 * mh + 16 * warp + lane / 4 + 8 * ((x / 2) % 2);
      const int qc = 8 * (x / 4) + 2 * (lane % 4) + x % 2;
      if (d < D && q0 + qc < P.S) out[(size_t)qc * hstride + d] = dq[mh][x] * P.scale;
    }
}

// ---------------------------------------------------------------- dK, dV

// The q tiles a dK/dV block walks, in order: for each q head g of its
// share [g, g_end) of the group, the tiles of 32 rows that see one of keys
// [k0, k1] or hold rows that see no key (rows at positions qoff + index)
struct QWalk {
  int g, i;  // q head of the group and q tile; g == g_end once the walk is done
  int k0, k1, g_end;
  __device__ bool needed(const Params& P) const {
    const int p0 = i * STEP + P.qoff, p1 = min(i * STEP + STEP, P.S) - 1 + P.qoff;
    // a row that sees no key sits at position Skv + window - 1 or later
    return tile_sees(p0, p1, k0, k1, P.causal, P.window) || no_key(p1, P.Skv, P.window);
  }
  __device__ void settle(const Params& P) {
    while (!done(P)) {
      while (i * STEP < P.S && !needed(P)) ++i;
      if (i * STEP < P.S) return;
      ++g;
      i = 0;
    }
  }
  __device__ bool done(const Params&) const { return g >= g_end; }
  __device__ void next(const Params& P) {
    ++i;
    settle(P);
  }
};

template <int D, bool CAP>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dkdv_tf32(const __grid_constant__ Params P) {
  using G = DkdvSmem<D>;
  constexpr int NB = G::NB, MH = G::MH;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = base + G::K, sKL = base + G::KL, sV = base + G::V, sVL = base + G::VL;
  const uint32_t ring = base + G::RING;
  const uint32_t rfull = base + G::BAR, rsplit = rfull + 8, full = rsplit + 8;
  const uint32_t empty = full + 8 * SLOTS, split = empty + 8 * SLOTS, lofree = split + 8 * G::LOS;
  const int grp = P.Hq / P.Hkv;
  const int b = blockIdx.x / P.Hkv, hk = blockIdx.x % P.Hkv;
  // key block blockIdx.y: block 0, which every causal row sees, first
  const int k0 = blockIdx.y * ROWS, k1 = min(k0 + ROWS, P.Skv) - 1;
  if (threadIdx.x == 0) {
    init_barriers<G::LOS>(rfull);
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int share = grp / P.splits;  // q heads of the group this CTA walks
  QWalk walk{(int)blockIdx.z * share, 0, k0, k1, ((int)blockIdx.z + 1) * share};
  walk.settle(P);

  if (warp >= 4) {
    // ------------------------------------------ producer and splitters
    const bool producer = warp == 4;
    if (producer && lane != 0) return;
    const int tid = threadIdx.x - 160;  // a splitter's index
    if (producer) {
      mbar_arrive_expect_tx(rfull, 2 * G::RES);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(sK + c * RBOX, &P.k, rfull, 32 * c, hk, k0, b);
        tma_load_4d(sV + c * RBOX, &P.v, rfull, 32 * c, hk, k0, b);
      }
    } else {
      mbar_wait(rfull, 0);
      split_lo(sK, sKL, G::RES, tid, kSplitters);
      split_lo(sV, sVL, G::RES, tid, kSplitters);
      fence_proxy_async();
      mbar_arrive(rsplit);
    }
    int slot = 0, lb = 0;
    uint32_t ph = 0, lph = 0;
    for (; !walk.done(P); walk.next(P)) {
      const int h = hk * grp + walk.g;
      const uint32_t sq = ring + slot * G::SLOT, so = sq + G::STP;
      const uint32_t sQL = base + G::LO + lb * G::LOB, sOL = sQL + G::STP;
      const uint32_t sl = base + G::LD + lb * 2 * STEP * 4;
      if (producer) {
        mbar_wait(empty + 8 * slot, ph ^ 1);
        mbar_arrive_expect_tx(full + 8 * slot, G::SLOT);
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(sq + c * SBOX, &P.q, full + 8 * slot, 32 * c, h, walk.i * STEP, b);
          tma_load_4d(so + c * SBOX, &P.dout, full + 8 * slot, 32 * c, h, walk.i * STEP, b);
        }
      } else {
        // the step's lse (log2 units; 0 past S) and Delta, read while the
        // tiles land
        float val = 0.f;
        const int qi = walk.i * STEP + tid % STEP;
        if (tid < 2 * STEP && qi < P.S) {
          const size_t row = ((size_t)b * P.Hq + h) * P.S + qi;
          val = tid < STEP ? P.lse[row] * LOG2E : P.delta[row];
        }
        mbar_wait(full + 8 * slot, ph);
        mbar_wait(lofree + 8 * lb, lph ^ 1);  // the lo buffer's last step is done with it
        split_lo(sq, sQL, G::STP, tid, kSplitters);
        split_lo(so, sOL, G::STP, tid, kSplitters);
        if (tid < 2 * STEP) st_shared_f32(sl + 4 * tid, val);
        fence_proxy_async();
        mbar_arrive(split + 8 * lb);
      }
      if (++slot == SLOTS) slot = 0, ph ^= 1;
      if (++lb == G::LOS) lb = 0, lph ^= 1;
    }
    return;
  }

  // -------------------------------------------------- the consumer
  const Score<CAP> sc(P.scale, P.softcap);
  const int wk0 = k0 + 16 * warp;  // this warp's keys wk0 .. wk0 + 15 (rows of S^T)
  float dk[MH][32], dv[MH][32], part[32];  // dK^T, dV^T: the head dim's halves x 64 keys
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    part[j] = 0.f;
#pragma unroll
    for (int mh = 0; mh < MH; ++mh) dk[mh][j] = dv[mh][j] = 0.f;
  }
  mbar_wait(rfull, 0);
  mbar_wait(rsplit, 0);
  int slot = 0, lb = 0;
  uint32_t ph = 0, lph = 0;
  for (; !walk.done(P); walk.next(P)) {
    const int c0 = walk.i * STEP;  // the step's 32 q rows (columns of S^T)
    const uint32_t sq = ring + slot * G::SLOT, so = sq + G::STP;
    // the lo buffer's two uses: q's and dO's lo; P^T, dS^T and their lo
    // staged; and its step's lse and Delta
    const uint32_t lo = base + G::LO + lb * G::LOB, sQL = lo, sOL = lo + G::STP;
    const uint32_t sPT = lo, sPTL = lo + STG, sDST = lo + 2 * STG, sDSTL = lo + 3 * STG;
    const uint32_t sl = base + G::LD + lb * 2 * STEP * 4;
    float s[16], dp[16];  // S^T and dP^T: 64 keys x 32 q rows
    mbar_wait(full + 8 * slot, ph);
    mbar_wait(split + 8 * lb, lph);
    wgmma_fence();
    rows_product<D>(s, sK, sKL, sq, sQL);
    rows_product<D>(dp, sV, sVL, so, sOL);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(s);
    fence_all(dp);

    // P^T and dS^T of this warp's 16 keys x 32 q rows. Every pair is
    // computed as if visible; where the warp's tile meets a mask, selects
    // then set what the masks say (P 0, or 1 / Skv for a row that sees no
    // key; dS 0). A q row past S loads as zeros with lse and Delta 0, so
    // its P^T column is 1 and its dS^T column 0, and it adds P^T dO = 0 to
    // dV and dS^T Q = 0 to dK; a key past Skv lands only in its own row of
    // dK and dV, which is not stored: no edge past S or Skv is tested
    const int p0 = c0 + P.qoff;  // the position of q row c0
    const bool inside = tile_inside(p0, p0 + STEP - 1, wk0, wk0 + 15, P.causal, P.window);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + 2 * (lane % 4);  // this thread's q rows c0 + col + c
      const float2 l2 = ld_shared_f2(sl + 4 * col), dl = ld_shared_f2(sl + 4 * (STEP + col));
#pragma unroll
      for (int e = 4 * j; e < 4 * j + 4; ++e) {
        const Pd g = pair(s[e], dp[e], e % 2 ? l2.y : l2.x, e % 2 ? dl.y : dl.x, sc);
        s[e] = g.p;
        dp[e] = g.ds;
        if (!inside) {
          const int qi = c0 + col + e % 2, kj = wk0 + lane / 4 + 8 * ((e / 2) % 2);
          const int pos = qi + P.qoff;
          const bool real = qi < P.S && kj < P.Skv, blind = no_key(pos, P.Skv, P.window);
          const bool seen = real && !blind && visible(pos, kj, P.causal, P.window);
          s[e] = seen ? s[e] : real && blind ? 1.f / (float)P.Skv : 0.f;
          dp[e] = seen ? dp[e] : 0.f;
        }
      }
    }
    named_barrier_sync(TURN, 128);  // every warp is done with the lo tiles and lse
    stage_split(sPT, sPTL, s, warp, lane);
    stage_split(sDST, sDSTL, dp, warp, lane);
    fence_proxy_async();
    named_barrier_sync(TURN, 128);
    // dV^T += dO^T P, dK^T += Q^T dS, a half of the head dim at a time
#pragma unroll
    for (int mh = 0; mh < MH; ++mh) {
      head_product<NB>(dv[mh], part, so, mh, sPT, sPTL, warp, lane);
      head_product<NB>(dk[mh], part, sq, mh, sDST, sDSTL, warp, lane);
    }
    __syncwarp();
    if (lane == 0) {  // this warp's reads of the slot and of the lo buffer are done
      mbar_arrive(empty + 8 * slot);
      mbar_arrive(lofree + 8 * lb);
    }
    if (++slot == SLOTS) slot = 0, ph ^= 1;
    if (++lb == G::LOS) lb = 0, lph ^= 1;
  }

  // dK = (dK^T)^T scale and dV, or this split's sums of them into the
  // workspace: this thread's head-dim rows 64 mh + 16 warp + lane / 4 + 8 i,
  // key columns 8 j + 2 (lane % 4) + c
  const size_t kstride = (size_t)P.Hkv * D, n = (size_t)gridDim.x / P.Hkv * P.Skv * kstride;
  const size_t kbase = ((size_t)b * P.Skv * P.Hkv + hk) * D + (size_t)k0 * kstride;
  float* const dk_out = P.ws ? P.ws + blockIdx.z * n : P.dk;
  float* const dv_out = P.ws ? P.ws + (P.splits + blockIdx.z) * n : P.dv;
  const float kscale = P.ws ? 1.f : P.scale;
#pragma unroll
  for (int mh = 0; mh < MH; ++mh)
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int d = 64 * mh + 16 * warp + lane / 4 + 8 * ((x / 2) % 2);
      const int kc = 8 * (x / 4) + 2 * (lane % 4) + x % 2;
      if (d < D && k0 + kc < P.Skv) {
        dk_out[kbase + (size_t)kc * kstride + d] = dk[mh][x] * kscale;
        dv_out[kbase + (size_t)kc * kstride + d] = dv[mh][x];
      }
    }
}

// dK = scale times the sum of the splits' dK, dV the sum of theirs, in
// split order: 16 bytes a thread (n, the values of each, a multiple of 4)
__global__ void __launch_bounds__(256) sum_splits(const float* __restrict__ ws,
                                                  float* __restrict__ dk, float* __restrict__ dv,
                                                  size_t n, int splits, float scale) {
  const size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  const float* pk = ws + i;
  const float* pv = pk + splits * n;
  for (int z = 0; z < splits; ++z, pk += n, pv += n) {
    const float4 a = *reinterpret_cast<const float4*>(pk);
    const float4 c = *reinterpret_cast<const float4*>(pv);
    sk.x += a.x, sk.y += a.y, sk.z += a.z, sk.w += a.w;
    sv.x += c.x, sv.y += c.y, sv.z += c.z, sv.w += c.w;
  }
  *reinterpret_cast<float4*>(dk + i) = make_float4(sk.x * scale, sk.y * scale, sk.z * scale,
                                                   sk.w * scale);
  *reinterpret_cast<float4*>(dv + i) = sv;
}

// ---------------------------------------------------------------- host side

// the maps of one launch: q and dout with boxes of qrows rows, k and v of
// krows
int make_maps(Params& P, const void* q, const void* k, const void* v, const void* dout, int D,
              int B, int qrows, int krows) {
  int r = encode_f32_heads(&P.q, q, D, B, P.S, P.Hq, qrows);
  if (r == CUDA_SUCCESS) r = encode_f32_heads(&P.dout, dout, D, B, P.S, P.Hq, qrows);
  if (r == CUDA_SUCCESS) r = encode_f32_heads(&P.k, k, D, B, P.Skv, P.Hkv, krows);
  if (r == CUDA_SUCCESS) r = encode_f32_heads(&P.v, v, D, B, P.Skv, P.Hkv, krows);
  return r;
}

template <int D, bool CAP>
int launch(Params P, const void* q, const void* k, const void* v, const void* dout, int B,
           cudaStream_t st) {
  static int dq_configured[kMaxDevices] = {}, dkdv_configured[kMaxDevices] = {};
  int r = make_maps(P, q, k, v, dout, D, B, ROWS, STEP);
  if (r != CUDA_SUCCESS) return kEncodeError + r;
  cudaError_t err = opt_in(fa_bwd_dq_tf32<D, CAP>, DqSmem<D>::BYTES, dq_configured);
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dq_tf32<D, CAP>
      <<<dim3(B * P.Hq, (P.S + ROWS - 1) / ROWS), kThreads, DqSmem<D>::BYTES, st>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  r = make_maps(P, q, k, v, dout, D, B, STEP, ROWS);
  if (r != CUDA_SUCCESS) return kEncodeError + r;
  err = opt_in(fa_bwd_dkdv_tf32<D, CAP>, DkdvSmem<D>::BYTES, dkdv_configured);
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dkdv_tf32<D, CAP><<<dim3(B * P.Hkv, (P.Skv + ROWS - 1) / ROWS, P.splits), kThreads,
                             DkdvSmem<D>::BYTES, st>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess || P.ws == nullptr) return (int)err;
  const size_t n = (size_t)B * P.Skv * P.Hkv * D;
  sum_splits<<<(unsigned)((n / 4 + 255) / 256), 256, 0, st>>>(P.ws, P.dk, P.dv, n, P.splits,
                                                             P.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const Params& P, const void* q, const void* k, const void* v, const void* dout,
             int B, cudaStream_t st) {
  return P.softcap > 0.f ? launch<D, true>(P, q, k, v, dout, B, st)
                         : launch<D, false>(P, q, k, v, dout, B, st);
}

}  // namespace

extern "C" {

// Shared bytes a CTA of launch `which` (0: dQ, 1: dK/dV, 2: the splits'
// sum) takes at head dim D (kernel.bwd_tf32_plan computes the same); -1 for
// a head dim or launch the engine does not have.
long long fa_bwd_tf32_smem_bytes(int D, int which) {
  if (D != 80 && D != 128) return -1;
  if (which == 0) return D == 80 ? DqSmem<80>::BYTES : DqSmem<128>::BYTES;
  if (which == 1) return D == 80 ? DkdvSmem<80>::BYTES : DkdvSmem<128>::BYTES;
  return which == 2 ? 0 : -1;
}

// q, out, dout, dq (B, S, Hq, D) and k, v, dk, dv (B, Skv, Hkv, D) f32,
// contiguous, every base a 16-byte multiple, D 80 or 128; lse (B, Hq, S) f32
// from a forward; delta (B, Hq, S) f32, written; splits: CTAs a key block
// of dK/dV, dividing Hq / Hkv; ws: where splits > 1, a workspace of (2,
// splits, B, Skv, Hkv, D) f32, else null. window <= 0: none; softcap <= 0:
// none; q_offset >= 0: the position of q's first row. Two launches on
// `stream`, three where splits > 1. Returns a cudaError_t, or 100000 + a
// CUresult where a tensor map could not be encoded.
int fa_backward_tf32(const void* q, const void* k, const void* v, const void* out,
                     const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
                     void* ws, int B, int S, int Skv, int Hq, int Hkv, int D, int causal,
                     int window, float softcap, float scale, int qoff, int splits, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || qoff < 0 || splits <= 0 ||
      (Hq / Hkv) % splits != 0 || (splits > 1) != (ws != nullptr))
    return (int)cudaErrorInvalidValue;
  Params P = {};
  P.o = static_cast<const float*>(out);
  P.dout_rows = static_cast<const float*>(dout);
  P.lse = static_cast<const float*>(lse);
  P.delta = static_cast<float*>(delta);
  P.dq = static_cast<float*>(dq), P.dk = static_cast<float*>(dk), P.dv = static_cast<float*>(dv);
  P.ws = static_cast<float*>(ws), P.splits = splits;
  P.S = S, P.Skv = Skv, P.Hq = Hq, P.Hkv = Hkv;
  P.causal = causal, P.window = window, P.qoff = qoff, P.softcap = softcap, P.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 80) return launch_d<80>(P, q, k, v, dout, B, st);
  if (D == 128) return launch_d<128>(P, q, k, v, dout, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
