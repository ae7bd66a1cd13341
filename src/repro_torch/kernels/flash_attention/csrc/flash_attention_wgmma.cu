// Flash attention forward at head dims 64, 80, 128 and 256 on Hopper, bf16,
// on wgmma fed by TMA. It computes what flash_attention.cu computes (the reference's
// `_fa_kernel` of src/repro/kernels/flash_attention/kernel.py): FA2
// online-softmax attention with GQA (q head h reads kv head h / (Hq / Hkv)),
// the causal, sliding-window and tanh-softcap masks, f32 running max, sum and
// accumulator, output acc / max(l, 1e-30); masked keys score -1e30, keys past
// Skv (or past their step's end) weigh 0, and a row that sees no key (a
// window with position >= Skv + window - 1) averages v over all Skv keys, as
// the plain version does. Row i sits at position q_offset + i (a rank's block
// of rows under ops.row_split); the keys' positions start at 0. With `lse`,
// each row's natural-log log-sum-exp goes to lse[(b Hq + h) S + i] as f32
// (-inf for a row that sees no key), what both backward engines read.
// flash_attention.cu keeps f32, the other head dims and bases TMA cannot
// address (kernel.fwd_engine chooses).
//
// What bounds it on an H100 SXM: operations. At the serving path's main
// shape (B4 S2048, 16 q / 8 kv heads of 128, causal) the mask keeps 134.3 M
// pairs, 68.7 GFLOP of QK^T and PV: 0.0695 ms at the 989 TFLOP/s bf16 peak
// against 0.010 ms for its 33.6 MB. At stablelm-3b's prefill (B1 S2048, 32
// heads of 80, causal) the mask keeps 67.1 M pairs, 21.5 GFLOP: 0.0217 ms;
// there the exponent comes close to the products, one ex2 a pair at 16 a
// clock an SM, about 0.017 ms at 1.83 GHz. At head dim 64 the two are
// equal: a pair's 256 FLOP take 0.26 ps of the card at the bf16 peak, and
// its ex2 0.26 ps of 132 SMs' 16 a clock at 1.83 GHz; whisper-base's
// encoder (B1 S1500, 8 heads of 64, no mask) keeps 18.0 M pairs, 4.6 GFLOP,
// 0.0047 ms either way, and hymba-1.5b's global layer (B1 S1528, 25 / 5
// heads of 64, causal) 29.2 M pairs, 7.5 GFLOP, 0.0076 ms. So this
// instance reaches its bound only as far as the ping-pong below hides one
// consumer's exponents under the other's products. At gemma2-2b's prefill
// (B1 S4608, 8 / 4 heads of 256, causal, window 4096, softcap 50) 86 GFLOP:
// 0.087 ms; there the softcap's tanh adds two special-function results a
// pair to the exponent's one, about 0.065 ms of the SFU's 16 results a clock
// an SM, which the tensor cores' time hides only if the two overlap.
//
// Layout, loads, products. q, k, v and o are read and written in the model
// layout, (B, S, H, D) contiguous, through 4-D tensor maps over (D, heads,
// rows, B) whose boxes are 64 columns (128 bytes, 128-byte swizzle) by 64 q
// rows or BN keys of one head: no transposed copy. A CTA is one producer
// warpgroup (one thread issues the TMA loads; the warpgroup gives its
// registers away with setmaxnreg) and two consumer warpgroups of 64 q rows
// each. S = Q K^T takes both operands from shared memory, K-major; O += P V
// takes P from registers (the S accumulator's fragment is the A fragment,
// rounded to bf16 once) and V MN-major through the descriptor's transpose
// bit. D 128: tiles of BN = 128 keys, m64n128k16 for both products, O and S
// 64 f32 registers a thread each. D 256: tiles of BN = 64 keys (O is already
// 128 registers a thread), m64n64k16 for S and m64n256k16 for PV. D 80: a
// row of 160 bytes takes two boxes, the second's columns 80-127 filled with
// zeros by TMA (the map's bounds are 80 columns) and never read by a
// product: S walks 5 k steps of 16 (the fifth in the second box), PV is one
// m64n80k16 whose N crosses from the first box into the second's first 16
// columns. Tiles of BN = 128 keys as at D 128; O is 40 registers a thread.
// D 64: one box a row, tiles of BN = 128 keys, m64n128k16 for S and
// m64n64k16 for PV; O is 32 registers a thread.
// K and V tiles stream through a two-stage ring with their own full and
// empty mbarriers (81 KB of shared memory at D 64, 160 KB at D 80 and 128,
// 193 KB at D 256). A CTA keeps a whole SM all the same (its 384 threads
// take 168 registers each at launch): whisper-base's encoder grid of 96
// CTAs leaves 36 of the 132 SMs idle.
//
// Knobs and walk. The CUDA grid is (B Hq, ceil(S / bq)): a CTA owns bq =
// min(block_q, S) q rows and walks them in sub-blocks of 128 (rows of a
// sub-block past its block are computed and not stored), the q block whose
// rows see the most causal keys first. A sub-block walks its steps of bk =
// min(block_k, Skv) keys (the reference's sequential KV grid axis), each
// cut into tiles of BN keys from the step's first key; keys of a tile past
// its step's end weigh 0 there and are taken by the next step. Tiles that
// the causal or window mask removes for every row of the sub-block are
// never loaded; a sub-block holding a row that sees no key walks every
// tile. Only tiles on a mask edge do position tests. The running max and
// sum are rescaled once a tile.
//
// Keeping the tensor cores busy. Each consumer issues S_j = Q K_j^T and,
// behind it, O += P_{j-1} V_{j-1}, then does tile j's softmax while the PV
// product runs; O takes tile j's correction once that product is done. The
// two consumers take turns issuing (named barriers 1 and 2, ping-pong), so
// one warpgroup's softmax runs under the other's products. At D 80 the two
// are nearly equal: a tile's two products are 2.6 MFLOP a warpgroup, 0.35 us
// of an SM's share of the bf16 peak, and its 8192 exponents take 0.28 us of
// the SM's special-function unit, so while one consumer's products run the
// other's exponents do; neither waits long for the other's turn. At D 64 a
// tile's products (2.1 MFLOP a warpgroup, 0.28 us) and exponents (0.28 us)
// are equal, so the turns hide the exponent only where both consumers'
// work interleaves perfectly.
//
// ptxas injects a warpgroup.arrive (its C7519 note) where a product is
// issued on one path only, or where the compiler sinks the packing of a
// register-A fragment past the fence of the product that reads it: the
// first tile of a sub-block, which has no P V behind its S, takes an
// instance of its own, and P is pinned where it is packed (fence_all).
//
// Scores, in log2 units: x = s scale log2 e, or under a softcap c, c log2 e
// tanh(s scale / c) with tanh(y) = 1 - 2 / (e^2y + 1) on the special-function
// unit: the function flash_attention_bwd_wgmma.cu recomputes, so the lse it
// reads matches the P it forms.
//
// Determinism: no atomics, one fixed walk; reruns are bit-equal. The output
// goes out through each consumer's own Q tile (swizzled bf16), 16 bytes a
// store, rows past the block or S not stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kConsumers = 2;                     // consumer warpgroups of 64 q rows
constexpr int kThreads = 128 * (kConsumers + 1);  // the last warpgroup loads
constexpr int SUB = 64 * kConsumers;              // q rows of a sub-block
constexpr int STAGES = 2;                         // K/V ring (three at D 128 were no faster)
constexpr int TURN = 1;                           // named barriers TURN + consumer: its turn to issue
constexpr int EPI = TURN + kConsumers;            // named barriers EPI + consumer: its epilogue
constexpr float MASKED = -1.0e30f;                // the reference's value for a masked score
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Geometry at head dim D: keys of a tile, box and tile bytes, and the shared
// memory from the 1024-aligned base: each consumer's Q tile, the K and V
// slots, the barriers (Q full and empty; K full, K empty, V full, V empty a
// stage)
template <int D>
struct Geo {
  static constexpr int BN = D == 256 ? 64 : 128;
  static constexpr int NB = (D + 63) / 64;           // boxes of 64 columns a row
  static constexpr int QBOX = 64 * 128;              // 64 q rows x 64 columns
  static constexpr int KBOX = BN * 128;              // BN keys x 64 columns
  static constexpr int Q_BYTES = NB * QBOX;          // one consumer's 64 rows
  static constexpr int KV_BYTES = NB * KBOX;         // one K or V tile
  static constexpr int Q = 0, K = Q + kConsumers * Q_BYTES, V = K + STAGES * KV_BYTES;
  static constexpr int BAR = V + STAGES * KV_BYTES;
  static constexpr int BYTES = 1024 + BAR + 8 * (2 + 4 * STAGES);
};

struct Params {
  CUtensorMap q, k, v;  // (D, heads, rows, B): boxes of 64 columns x 64 q rows / BN keys
  bf16* o;              // (B, S, Hq, D)
  float* lse;           // null, or (B, Hq, S)
  int S, Skv, Hq, Hkv, bq, bk, causal, window, qoff;
  float softcap, scale;
};

// ------------------------------------------------------------ masks, walk

__device__ __forceinline__ int heavy_first(int y, int n, int rows, int S) {
  // the last q block, whose rows see the most keys under a causal mask,
  // first; a ragged last block, lighter than the full one before it, last
  if (S % rows != 0) return y == n - 1 ? n - 1 : n - 2 - y;
  return n - 1 - y;
}
__device__ __forceinline__ bool visible(int p, int kj, int causal, int window) {
  return (!causal || kj <= p) && (window <= 0 || kj > p - window);
}
// every pair of positions [p0, p1] x keys [k0, k1] is visible
__device__ __forceinline__ bool tile_inside(int p0, int p1, int k0, int k1, int causal,
                                            int window) {
  return (!causal || k1 <= p0) && (window <= 0 || k0 > p1 - window);
}

// The tiles a sub-block of positions [p0, p1] walks: steps j of bk keys,
// each cut into tiles t of BN keys, over the keys [k_lo, k_hi) that a row
// of it sees (all of them where a row sees none)
template <int BN>
struct Walk {
  int bk, Skv, k_lo, k_hi, j, t;
  __device__ Walk(int p0, int p1, int Skv_, int causal, int window, int bk_)
      : bk(bk_), Skv(Skv_), t(0) {
    k_hi = causal ? min(Skv, p1 + 1) : Skv;
    k_lo = window > 0 ? max(0, p0 - window + 1) : 0;
    if (window > 0 && p1 >= Skv + window - 1) k_lo = 0;
    j = k_lo < k_hi ? k_lo / bk : (k_hi + bk - 1) / bk + 1;
    settle();
  }
  __device__ int key0() const { return j * bk + t * BN; }
  __device__ int step_end() const { return min((j + 1) * bk, Skv); }
  __device__ bool done() const { return j * bk >= k_hi; }
  __device__ void settle() {
    while (!done()) {
      const int k0 = key0(), e = step_end();
      if (k0 >= e || k0 >= k_hi) {
        ++j;
        t = 0;
      } else if (min(k0 + BN, e) > k_lo) {
        return;
      } else {
        ++t;
      }
    }
  }
  __device__ void next() {
    ++t;
    settle();
  }
};

__device__ __forceinline__ float ex2(float x) {  // 2^x on the special-function unit
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ products

// the K-major descriptor of 16 columns (k step kk) of a tile of boxes of
// `box` bytes (64 columns each) at `tile`
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk, int box) {
  return wgmma_desc(tile + (kk / 4) * box + (kk % 4) * 32, 16, 1024);
}
// the MN-major descriptor of 16 rows (k step kk) of a tile of boxes of
// `box` bytes: N runs over the head dim, box to box
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk, int box) {
  return wgmma_desc(tile + kk * 2048, box, 1024);
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}
// pin P's A fragments where they are packed (the head says why)
template <int N>
__device__ __forceinline__ void fence_all(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < 4 * N; ++i) fence_operand(a[i / 4][i % 4]);
}

// s = Q K^T: this consumer's 64 rows x BN keys
template <int D>
__device__ __forceinline__ void qk(float (&s)[Geo<D>::BN / 2], uint32_t q, uint32_t k) {
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if constexpr (G::BN == 128)
      wgmma_m64n128k16<0, 0>(s, kmajor(q, kk, G::QBOX), kmajor(k, kk, G::KBOX), kk > 0);
    else
      wgmma_m64n64k16<0, 0>(s, kmajor(q, kk, G::QBOX), kmajor(k, kk, G::KBOX), kk > 0);
  }
}

// o += P V: P (64 rows x BN keys) from registers, V MN-major
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&p)[Geo<D>::BN / 16][4],
                                   uint32_t v) {
  using G = Geo<D>;
#pragma unroll
  for (int kq = 0; kq < G::BN / 16; ++kq) {
    if constexpr (D == 64)
      wgmma_m64n64k16_rs<1>(o, p[kq], mnmajor(v, kq, G::KBOX), 1);
    else if constexpr (D == 80)
      wgmma_m64n80k16_rs<1>(o, p[kq], mnmajor(v, kq, G::KBOX), 1);
    else if constexpr (D == 128)
      wgmma_m64n128k16_rs<1>(o, p[kq], mnmajor(v, kq, G::KBOX), 1);
    else
      wgmma_m64n256k16_rs<1>(o, p[kq], mnmajor(v, kq, G::KBOX), 1);
  }
}

// ------------------------------------------------------------ the kernel

template <int D>
__global__ void __launch_bounds__(kThreads, 1) fa_fwd_wgmma(const __grid_constant__ Params P) {
  using G = Geo<D>;
  constexpr int BN = G::BN, NS = BN / 2, NO = D / 2, KQ = BN / 16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + G::Q, sK = base + G::K, sV = base + G::V;
  const uint32_t qfull = base + G::BAR, qempty = qfull + 8, kfull = qempty + 8;
  const uint32_t kempty = kfull + 8 * STAGES, vfull = kempty + 8 * STAGES;
  const uint32_t vempty = vfull + 8 * STAGES;
  const int b = blockIdx.x / P.Hq, h = blockIdx.x % P.Hq, hk = h / (P.Hq / P.Hkv);
  const int r_begin = heavy_first(blockIdx.y, gridDim.y, P.bq, P.S) * P.bq;
  const int r_end = min(r_begin + P.bq, P.S);  // the rows this CTA owns
  if (threadIdx.x == 0) {
    // an empty barrier counts one arrival a consumer warp: each warp
    // releases a tile once its own wait for the products that read it is over
    mbar_init(qfull, 1);
    mbar_init(qempty, 4 * kConsumers);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kfull + 8 * s, 1), mbar_init(kempty + 8 * s, 4 * kConsumers);
      mbar_init(vfull + 8 * s, 1), mbar_init(vempty + 8 * s, 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // ------------------------------------------------ producer
    setmaxnreg_dec<24>();
    if (threadIdx.x % 128 == 0) {
      int stage = 0, sub = 0;
      uint32_t ph = 0;
      for (int r0 = r_begin; r0 < r_end; r0 += SUB, ++sub) {
        const int r1 = min(r0 + SUB, r_end) - 1;
        if (sub > 0) mbar_wait(qempty, (sub - 1) & 1);
        mbar_arrive_expect_tx(qfull, kConsumers * G::Q_BYTES);
        for (int w = 0; w < kConsumers; ++w)
          for (int c = 0; c < G::NB; ++c)
            tma_load_4d(sQ + w * G::Q_BYTES + c * G::QBOX, &P.q, qfull, 64 * c, h, r0 + 64 * w, b);
        for (Walk<BN> walk(r0 + P.qoff, r1 + P.qoff, P.Skv, P.causal, P.window, P.bk);
             !walk.done(); walk.next()) {
          const int k0 = walk.key0();
          mbar_wait(kempty + 8 * stage, ph ^ 1);
          mbar_arrive_expect_tx(kfull + 8 * stage, G::KV_BYTES);
          for (int c = 0; c < G::NB; ++c)
            tma_load_4d(sK + stage * G::KV_BYTES + c * G::KBOX, &P.k, kfull + 8 * stage, 64 * c,
                        hk, k0, b);
          mbar_wait(vempty + 8 * stage, ph ^ 1);
          mbar_arrive_expect_tx(vfull + 8 * stage, G::KV_BYTES);
          for (int c = 0; c < G::NB; ++c)
            tma_load_4d(sV + stage * G::KV_BYTES + c * G::KBOX, &P.v, vfull + 8 * stage, 64 * c,
                        hk, k0, b);
          if (++stage == STAGES) stage = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // -------------------------------------------------- consumers
  // 240 registers a consumer thread and 24 a producer one (the launch's 168
  // x 384, redistributed): with 232 and 40, D 128 spilled 84 bytes once the
  // first tile took its own instance of the step
  setmaxnreg_inc<240>();
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const bool leader = lane == 0;  // arrives at the empty barriers for its warp
  const uint32_t myQ = sQ + wg * G::Q_BYTES;
  // the score's constants: no softcap, x = s mul0; with one, the tanh's
  // e^2y = 2^(s mul0) and x = cap2 tanh
  const bool capped = P.softcap > 0.f;
  const float mul0 = capped ? 2.f * LOG2E * P.scale / P.softcap : P.scale * LOG2E;
  const float cap2 = P.softcap * LOG2E;
  const size_t rstride = (size_t)P.Hq * D;
  if (wg == 1) named_barrier_arrive(TURN, 256);  // consumer 0 issues first

  int stage = 0, sub = 0;
  uint32_t ph = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += SUB, ++sub) {
    const int r1 = min(r0 + SUB, r_end) - 1;
    const int w0 = r0 + 64 * wg + 16 * warp;  // this warp's rows w0 .. w0 + 15
    const int wp0 = w0 + P.qoff;              // the position of row w0
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    fence_all(o);  // pinned here: not sunk between two products' issues
    // this thread's rows w0 + lane / 4 + 8 i: running max (log2 units), its
    // part of the row sum, the last tile's correction
    float m[2] = {MASKED * LOG2E, MASKED * LOG2E}, l[2] = {0.f, 0.f}, corr[2];
    uint32_t p[KQ][4];  // the last tile's P, bf16 A fragments of 16 keys each
    int vstage = 0;     // the last tile's V slot
    uint32_t vph = 0;
    mbar_wait(qfull, sub & 1);
    Walk<BN> walk(r0 + P.qoff, r1 + P.qoff, P.Skv, P.causal, P.window, P.bk);
    // Tile j: S_j = Q K_j^T and, behind it where PV, O += P_{j-1} V_{j-1};
    // then tile j's softmax into p. A sub-block walks at least one tile: its
    // first takes the instance without P V, the rest the one with it, so
    // that each instance issues its products on every path (a product on
    // one path only makes ptxas inject warpgroup.arrives, its C7519 note)
    auto step = [&](auto pv_tag, const int k0, const int e) {
      constexpr bool PV = decltype(pv_tag)::value;
      float s[NS];
      mbar_wait(kfull + 8 * stage, ph);
      if constexpr (PV) mbar_wait(vfull + 8 * vstage, vph);
      named_barrier_sync(TURN + wg, 256);
      wgmma_fence();
      qk<D>(s, myQ, sK + stage * G::KV_BYTES);
      wgmma_commit();
      if constexpr (PV) {
        wgmma_fence();
        pv<D>(o, p, sV + vstage * G::KV_BYTES);
      }
      // an empty group where no P V is issued: the waits below stay the
      // same, which ptxas needs to see that no product is in flight where O
      // is touched (else it serializes every wgmma)
      wgmma_commit();
      named_barrier_arrive(TURN + (wg ^ 1), 256);
      wgmma_wait<1>();
      fence_all(s);
      if (leader) mbar_arrive(kempty + 8 * stage);

      // scores in log2 units; a warp whose 16 rows see all BN keys of the
      // tile skips the position tests (and, without a softcap, keeps the
      // raw products: mul folds the scale into the exponent's FFMA). The
      // softcap's test stays outside the loops: inside them, a softcap-free
      // tile on a mask edge also computed the tanh for the selects to throw
      // away. A tile whose only edge is its step's end tests that alone
      const bool seen = tile_inside(wp0, wp0 + 15, k0, k0 + BN - 1, P.causal, P.window);
      const bool inside = k0 + BN <= e && seen;
      // key kj of score x; x after the masks: -inf past its step's end, the
      // reference's masked value where they hide the pair, else y
      auto key = [&](int x) { return k0 + 8 * (x / 4) + 2 * (lane % 4) + x % 2; };
      auto masked = [&](int x, float y) {
        const int kj = key(x), pos = wp0 + lane / 4 + 8 * ((x / 2) % 2);
        return kj >= e ? -INFINITY : visible(pos, kj, P.causal, P.window) ? y : MASKED * LOG2E;
      };
      float mul = mul0;
      if (capped) {
        mul = 1.f;
#pragma unroll
        for (int x = 0; x < NS; ++x) {
          const float y = cap2 * fmaf(-2.f, __fdividef(1.f, ex2(s[x] * mul0) + 1.f), 1.f);
          s[x] = inside ? y : masked(x, y);
        }
      } else if (seen && !inside) {  // raw products kept, as inside
#pragma unroll
        for (int x = 0; x < NS; ++x) s[x] = key(x) >= e ? -INFINITY : s[x];
      } else if (!inside) {
        mul = 1.f;
#pragma unroll
        for (int x = 0; x < NS; ++x) s[x] = masked(x, s[x] * mul0);
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int x = 0; x < NS; ++x) mx[(x / 2) % 2] = fmaxf(mx[(x / 2) % 2], s[x]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i] * mul);  // mul > 0 keeps the order
        corr[i] = ex2(m[i] - m_new);
        l[i] *= corr[i];
        m[i] = m_new;
      }
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        s[x] = ex2(fmaf(s[x], mul, -m[(x / 2) % 2]));
        l[(x / 2) % 2] += s[x];
      }
      wgmma_wait<0>();  // the last tile's P V is done: its V slot and p are free
      if constexpr (PV) {
        fence_all(o);
        if (leader) mbar_arrive(vempty + 8 * vstage);
        // O to this tile's max, outside any open product, and pinned there
        // by the fence (before the first P V it is 0)
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] *= corr[(i / 2) % 2];
        fence_all(o);
      }
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        p[kq][0] = pack2(s[8 * kq + 0], s[8 * kq + 1]);
        p[kq][1] = pack2(s[8 * kq + 2], s[8 * kq + 3]);
        p[kq][2] = pack2(s[8 * kq + 4], s[8 * kq + 5]);
        p[kq][3] = pack2(s[8 * kq + 6], s[8 * kq + 7]);
      }
      fence_all(p);
      vstage = stage;
      vph = ph;
      if (++stage == STAGES) stage = 0, ph ^= 1;
    };
    step(std::false_type{}, walk.key0(), walk.step_end());
    for (walk.next(); !walk.done(); walk.next())
      step(std::true_type{}, walk.key0(), walk.step_end());
    // the last tile's P V
    mbar_wait(vfull + 8 * vstage, vph);
    named_barrier_sync(TURN + wg, 256);
    wgmma_fence();
    pv<D>(o, p, sV + vstage * G::KV_BYTES);
    wgmma_commit();
    named_barrier_arrive(TURN + (wg ^ 1), 256);
    wgmma_wait<0>();
    fence_all(o);
    if (leader) mbar_arrive(vempty + 8 * vstage);

    // out = acc / max(l, 1e-30) and the lse, this thread's two rows
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int r = w0 + lane / 4 + 8 * i;
      if (P.lse != nullptr && lane % 4 == 0 && r < r_end)
        P.lse[((size_t)b * P.Hq + h) * P.S + r] =
            (P.window > 0 && r + P.qoff >= P.Skv + P.window - 1)
                ? -INFINITY
                : (m[i] + log2f(fmaxf(l[i], 1e-30f))) * LN2;
      inv[i] = 1.f / fmaxf(l[i], 1e-30f);
    }
    // staged as bf16 into this consumer's own Q tile (its products are
    // done), in the swizzled layout: row r, 16-byte chunk c of box c / 8 at
    // r * 128 + ((c % 8) ^ (r % 8)) * 16
#pragma unroll
    for (int jn = 0; jn < NO / 4; ++jn)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 16 * warp + lane / 4 + 8 * i, c = jn;  // chunk of 8 columns
        const uint32_t at = myQ + (c / 8) * G::QBOX + r * 128 + (((c % 8) ^ (r % 8)) * 16) +
                            (lane % 4) * 4;
        const uint32_t val = pack2(o[4 * jn + 2 * i] * inv[i], o[4 * jn + 2 * i + 1] * inv[i]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(val) : "memory");
      }
    named_barrier_sync(EPI + wg, 128);
    const int row0 = r0 + 64 * wg;
    bf16* ob = P.o + ((size_t)b * P.S * P.Hq + h) * D;
#pragma unroll 4
    for (int idx = threadIdx.x % 128; idx < 64 * (D / 8); idx += 128) {
      const int r = idx / (D / 8), c = idx % (D / 8);
      const uint4 val =
          ld_shared_v4(myQ + (c / 8) * G::QBOX + r * 128 + (((c % 8) ^ (r % 8)) * 16));
      if (row0 + r < r_end)
        *reinterpret_cast<uint4*>(ob + (size_t)(row0 + r) * rstride + 8 * c) = val;
    }
    fence_proxy_async();  // these reads and writes before the next Q's TMA load
    named_barrier_sync(EPI + wg, 128);
    if (leader) mbar_arrive(qempty);
  }
  if (wg == 0) named_barrier_sync(TURN, 256);  // consumer 1's last turn handed over
}

// ---------------------------------------------------------------- host side

// a map over (B, rows, heads, D) bf16 in boxes of 64 columns x `box_rows`
// rows of one head
int make_map(CUtensorMap* m, const void* base, int D, int B, int rows, int heads, int box_rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)heads, (uint64_t)rows, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)heads * D * 2,
                               (uint64_t)rows * heads * D * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)box_rows, 1};
  return encode_bf16_4d(m, base, dims, strides, box);
}

template <int D>
int launch(Params& P, const void* q, const void* k, const void* v, int B, cudaStream_t st) {
  using G = Geo<D>;
  int r = make_map(&P.q, q, D, B, P.S, P.Hq, 64);
  if (r == CUDA_SUCCESS) r = make_map(&P.k, k, D, B, P.Skv, P.Hkv, G::BN);
  if (r == CUDA_SUCCESS) r = make_map(&P.v, v, D, B, P.Skv, P.Hkv, G::BN);
  if (r != CUDA_SUCCESS) return kEncodeError + r;
  static int configured[kMaxDevices] = {};
  cudaError_t err = opt_in(fa_fwd_wgmma<D>, G::BYTES, configured);
  if (err != cudaSuccess) return (int)err;
  fa_fwd_wgmma<D><<<dim3(B * P.Hq, (P.S + P.bq - 1) / P.bq), kThreads, G::BYTES, st>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared bytes a CTA takes at head dim D (kernel.fwd_wgmma_plan computes
// the same); -1 for a head dim the engine does not take.
long long fa_fwd_wgmma_smem_bytes(int D) {
  return D == 64    ? Geo<64>::BYTES
         : D == 80  ? Geo<80>::BYTES
         : D == 128 ? Geo<128>::BYTES
         : D == 256 ? Geo<256>::BYTES
                    : -1;
}

// q, o (B, S, Hq, D) and k, v (B, Skv, Hkv, D) bf16, contiguous, every base
// a 16-byte multiple, D 64, 80, 128 or 256; lse: null, or (B, Hq, S) f32. window <=
// 0: none; softcap <= 0: none; bq, bk: q rows a CTA owns and keys a step
// takes (already clamped to S and Skv); q_offset >= 0: the position of q's
// first row. One launch on `stream`. Returns a cudaError_t, or 100000 + a
// CUresult where a tensor map could not be encoded.
int fa_forward_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                     int S, int Skv, int Hq, int Hkv, int D, int causal, int window,
                     float softcap, float scale, int bq, int bk, int qoff, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || bq <= 0 || bk <= 0 ||
      bq > S || bk > Skv || qoff < 0)
    return (int)cudaErrorInvalidValue;
  Params P = {};
  P.o = static_cast<bf16*>(o);
  P.lse = static_cast<float*>(lse);
  P.S = S, P.Skv = Skv, P.Hq = Hq, P.Hkv = Hkv, P.bq = bq, P.bk = bk;
  P.causal = causal, P.window = window, P.qoff = qoff, P.softcap = softcap, P.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(P, q, k, v, B, st);
  if (D == 80) return launch<80>(P, q, k, v, B, st);
  if (D == 128) return launch<128>(P, q, k, v, B, st);
  if (D == 256) return launch<256>(P, q, k, v, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
