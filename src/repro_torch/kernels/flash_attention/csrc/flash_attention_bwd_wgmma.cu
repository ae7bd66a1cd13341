// Flash attention backward at head dim 256 on Hopper, bf16, on wgmma fed by
// TMA. It computes what flash_attention_bwd.cu computes (the FA2 backward of
// flash_attention.cu: P = exp(S - lse) recomputed tile by tile, dV = P^T dO,
// dP = dO V^T, dS = P (dP - Delta) times 1 - tanh^2(s / c) under a softcap
// c, dK = dS^T Q scale, dQ = dS K scale), with every mask of that file: GQA,
// causal, a window, rows that see no key (P = 1 / Skv, dS = 0) and the
// query offset (row i sits at position q_offset + i). That file keeps every
// other head dim, f32, and bf16 bases TMA cannot address; the reference has
// no backward kernel (XLA differentiates its plain attention).
//
// What bounds it on an H100 SXM. At gemma2-2b's training shape (B1 S4096,
// 8 q / 4 kv heads of 256, causal, window 4096, softcap 50) the mask keeps
// 67.1 M (query, key) pairs; the five products a backward needs are 172
// GFLOP, 0.174 ms at the bf16 tensor-core peak, against 92 MB moved:
// operations. The mma.sync engine of flash_attention_bwd.cu reaches 0.037
// of that bound there: warp-level products, S and dP computed twice (each
// of two CTAs a block owns 128 output columns and recomputes both over all
// 256), and a cp.async ring that every thread feeds.
//
// Design: two launches, each CTA one producer warpgroup (one thread
// starts the TMA loads; the warpgroup gives its registers away with
// setmaxnreg) and two consumer warpgroups on wgmma. Every tile is a
// 64-row x 256-column bf16 tile loaded as four TMA boxes of 64 rows x 64
// columns with 128-byte swizzle, through a 4-D tensor map over (D, heads,
// rows, B) whose box takes one head: the same boxes serve as K-major
// operands (q rows or keys as M or N, the head dim as K) and MN-major ones
// (the head dim as N) by the descriptor's transpose bit, so nothing is
// transposed. Rows past S or Skv load as zeros and are masked; the outputs
// go out by TMA stores that clip them.
//
//   dQ (first; its prologue also writes Delta = rowsum(dO O) for its rows,
//   which dK/dV reads): a CTA owns 128 q rows of one head, 64 a consumer
//   warpgroup, with Q and dO resident. Per visible 64-key step: S = Q K^T
//   and dP = dO V^T (m64n64k16, both operands from shared memory), dS in
//   registers, then dQ += dS K with dS as the A operand from registers
//   (m64n256k16, the accumulator's fragment is the A fragment) and K
//   MN-major. K streams through a ring of two slots and V through one (the
//   next V loads once this step's dP is done, while dS and dQ run): 224 KB.
//   The heaviest causal block launches first.
//
//   dK/dV: a CTA owns 64 keys of one KV head, K and V resident, and walks
//   its group's q heads and the q tiles that see its keys, the q and dO
//   tiles streaming through a two-stage ring. The 64 x 256 f32 dK and dV
//   of its keys are 256 registers a thread for one warpgroup, so each
//   consumer warpgroup owns 128 columns of both. S^T = K Q^T and dP^T =
//   V dO^T are computed once a step: each warpgroup takes 32 of the 64 q
//   columns (m64n32k16), forms its part of P^T and dS^T and writes it to
//   shared memory as bf16 in the swizzled layout wgmma reads (two buffers,
//   for even and odd steps, so one barrier a step suffices); then both
//   take all 64 as the A operand of dV += P^T dO and dK += dS^T Q
//   (m64n128k16, B MN-major). Four products a step where the mma.sync
//   engine's two CTAs do six.
//
// Determinism: no atomics; every CTA walks its steps in one fixed order, so
// reruns are bit-equal. Scores skip the position tests where a warp's tile
// is wholly visible; tanh is 1 - 2 / (e^2y + 1) on the special-function
// unit. Independent product chains are interleaved.
//
// What holds it back (PERF.md §6 has the times): 0.84-0.88 ms at gemma2's
// training shape, 0.20 of the bound and 5.5x faster than the mma.sync
// engine; each launch reaches 0.29 of the bound of its own products. A
// warpgroup waits for its products before the elementwise work (exp2,
// and under a softcap its tanh: three special-function results a pair, 0.17
// ms of the time), so the tensor cores idle unless the other warpgroup has
// products in flight; dK/dV's warpgroups meet at a barrier every step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int D = 256;
constexpr int TILE = 64;                          // rows (q rows or keys) of a tile and a step
constexpr int BOX = TILE * 128;                   // 8 KB: 64 rows of 64 columns (128 bytes)
constexpr int TILE_BYTES = (D / 64) * BOX;        // 32 KB: 64 rows of 256 columns
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // the last warpgroup loads
constexpr float LOG2E = 1.4426950408889634f;

// dQ: q rows a CTA, slots of the K and V rings; its shared memory from the
// 1024-aligned base: Q and dO of each consumer, the K and V slots, barriers
// (Q and dO; K full and empty; V full and empty)
constexpr int DQ_ROWS = TILE * kConsumers;
constexpr int K_SLOTS = 2, V_SLOTS = 1;
struct DqSmem {
  static constexpr int Q = 0, DO = Q + kConsumers * TILE_BYTES;
  static constexpr int K = DO + kConsumers * TILE_BYTES, V = K + K_SLOTS * TILE_BYTES;
  static constexpr int BAR = V + V_SLOTS * TILE_BYTES;
  static constexpr int BYTES = 1024 + BAR + 8 * (1 + 2 * K_SLOTS + 2 * V_SLOTS);
};

// dK/dV: stages of the q/dO ring; its shared memory: K, V, the ring (q
// tile then dO tile a stage), P^T and dS^T (64 keys x 64 q bf16, one box
// each) for even and for odd steps, barriers (K and V; full and empty a
// stage)
constexpr int ST = 2;
struct DkdvSmem {
  static constexpr int K = 0, V = TILE_BYTES, RING = 2 * TILE_BYTES;
  static constexpr int P = RING + ST * 2 * TILE_BYTES, DS = P + 2 * BOX;
  static constexpr int BAR = DS + 2 * BOX;
  static constexpr int BYTES = 1024 + BAR + 8 * (1 + 2 * ST);
};

struct Params {
  CUtensorMap q, k, v, dout;  // loads: (D, heads, rows, B), boxes of 64 columns x 64 rows
  CUtensorMap dq, dk, dv;     // stores, the same boxes
  const bf16* o;              // (B, S, Hq, D): Delta's rows
  const bf16* dout_rows;
  const float* lse;           // (B, Hq, S)
  float* delta;               // (B, Hq, S), written by dQ
  int S, Skv, Hq, Hkv, causal, window, qoff;
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

// The score's constants in log2 units: x = s scale, or c tanh(s scale / c)
// under a softcap c, and P = 2^(x log2 e - lse log2 e)
struct Score {
  float mul;   // no softcap: scale log2 e; with one: 2 log2 e scale / c (tanh's e^2y)
  float cap2;  // c log2 e
  bool capped;
  __device__ Score(float scale, float softcap)
      : mul(softcap > 0.f ? 2.f * LOG2E * scale / softcap : scale * LOG2E),
        cap2(softcap * LOG2E), capped(softcap > 0.f) {}
};

// P and dS of a visible pair from the raw products s = q . k and dp = dO .
// v: dS = P (dP - Delta), times 1 - tanh^2 under a softcap; tanh(y) is
// 1 - 2 / (e^2y + 1) on the special-function unit
struct Pd {
  float p, ds;
};
__device__ __forceinline__ Pd pair(float s, float dp, float lse2, float delta, const Score& sc) {
  if (!sc.capped) {
    const float p = ex2(fmaf(s, sc.mul, -lse2));
    return {p, p * (dp - delta)};
  }
  const float t = fmaf(-2.f, __fdividef(1.f, ex2(s * sc.mul) + 1.f), 1.f);
  const float p = ex2(fmaf(t, sc.cap2, -lse2));
  return {p, p * (dp - delta) * fmaf(-t, t, 1.f)};
}

// The K-major descriptor of 16 columns (k step kk of 16) of a 64-row tile
// of four boxes at `tile`, starting at row `row` (a multiple of 8)
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk, int row = 0) {
  return wgmma_desc(tile + (kk / 4) * BOX + (kk % 4) * 32 + row * 128, 16, 1024);
}
// The MN-major descriptor of 16 rows (k step kk) of a tile of boxes at
// `tile`, its N columns starting at box `box`
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk, int box = 0) {
  return wgmma_desc(tile + box * BOX + kk * 2048, BOX, 1024);
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}

// Write this warpgroup's fragment of a 64-row f32 accumulator (columns
// `col0` onwards of the tile, acc[4j + 2i + c]: row 16 warp + lane / 4 +
// 8 i, column 8 j + 2 (lane % 4) + c), scaled by `mul`, as bf16 into the
// swizzled boxes at `tile` (box = column / 64)
template <int N>
__device__ __forceinline__ void stage_rows(uint32_t tile, const float (&acc)[N], int col0,
                                           float mul) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + lane / 4 + 8 * i, c = col0 + 8 * j;
      const uint32_t at = tile + (c / 64) * BOX + r * 128 + ((((c % 64) / 8) ^ (r % 8)) * 16) +
                          (lane % 4) * 4;
      const uint32_t v = pack2(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(v) : "memory");
    }
}

// ---------------------------------------------------------------- dQ

// the key tiles a dQ block's rows (positions [p0, p1]) see, in order
struct KeyWalk {
  int t, n, p0, p1, Skv, causal, window;
  __device__ void settle() {
    while (t < n && !tile_sees(p0, p1, t * TILE, min(t * TILE + TILE, Skv) - 1, causal, window))
      ++t;
  }
  __device__ bool done() const { return t >= n; }
  __device__ void next() {
    ++t;
    settle();
  }
};

__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dq_wgmma(const __grid_constant__ Params P) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + DqSmem::Q, sO = base + DqSmem::DO;
  const uint32_t sK = base + DqSmem::K, sV = base + DqSmem::V;
  const uint32_t qfull = base + DqSmem::BAR, kfull = qfull + 8, kempty = kfull + 8 * K_SLOTS;
  const uint32_t vfull = kempty + 8 * K_SLOTS, vempty = vfull + 8 * V_SLOTS;
  const int b = blockIdx.x / P.Hq, h = blockIdx.x % P.Hq, hk = h / (P.Hq / P.Hkv);
  const int q0 = heavy_first(blockIdx.y, gridDim.y, DQ_ROWS, P.S) * DQ_ROWS;
  const int q1 = min(q0 + DQ_ROWS, P.S) - 1;
  const int nk = (P.Skv + TILE - 1) / TILE;
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < K_SLOTS; ++s) mbar_init(kfull + 8 * s, 1), mbar_init(kempty + 8 * s, kConsumers);
    for (int s = 0; s < V_SLOTS; ++s) mbar_init(vfull + 8 * s, 1), mbar_init(vempty + 8 * s, kConsumers);
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // ------------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      mbar_arrive_expect_tx(qfull, 2 * kConsumers * TILE_BYTES);
      for (int w = 0; w < kConsumers; ++w)
        for (int j = 0; j < D / 64; ++j) {
          tma_load_4d(sQ + w * TILE_BYTES + j * BOX, &P.q, qfull, 64 * j, h, q0 + TILE * w, b);
          tma_load_4d(sO + w * TILE_BYTES + j * BOX, &P.dout, qfull, 64 * j, h, q0 + TILE * w, b);
        }
      KeyWalk walk{0, nk, q0 + P.qoff, q1 + P.qoff, P.Skv, P.causal, P.window};
      walk.settle();
      int ks = 0;
      uint32_t kph = 0, vph = 0;
      for (; !walk.done(); walk.next()) {
        mbar_wait(kempty + 8 * ks, kph ^ 1);
        mbar_arrive_expect_tx(kfull + 8 * ks, TILE_BYTES);
        for (int j = 0; j < D / 64; ++j)
          tma_load_4d(sK + ks * TILE_BYTES + j * BOX, &P.k, kfull + 8 * ks, 64 * j, hk,
                      walk.t * TILE, b);
        if (++ks == K_SLOTS) ks = 0, kph ^= 1;
        mbar_wait(vempty, vph ^ 1);
        mbar_arrive_expect_tx(vfull, TILE_BYTES);
        for (int j = 0; j < D / 64; ++j)
          tma_load_4d(sV + j * BOX, &P.v, vfull, 64 * j, hk, walk.t * TILE, b);
        vph ^= 1;
      }
    }
    return;
  }

  // -------------------------------------------------- consumers
  setmaxnreg_inc<232>();
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const bool elected = threadIdx.x % 128 == 0;
  const int w0 = q0 + TILE * wg + 16 * warp;  // this warp's rows w0 .. w0 + 15
  const size_t hstride = (size_t)P.Hq * D;
  const size_t rbase = ((size_t)b * P.S * P.Hq + h) * D;

  // Delta = rowsum(dO O) of this warp's 16 rows, two lanes a row, 16 bytes a load
  const int dr = w0 + lane / 2;
  float dsum = 0.f;
  if (dr < P.S) {
    const bf16* orow = P.o + rbase + (size_t)dr * hstride;
    const bf16* grow = P.dout_rows + rbase + (size_t)dr * hstride;
#pragma unroll 4
    for (int c = (lane % 2) * 8; c < D; c += 16) {
      const uint4 a = *reinterpret_cast<const uint4*>(orow + c);
      const uint4 g = *reinterpret_cast<const uint4*>(grow + c);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fa = __bfloat1622float2(a2[j]), fg = __bfloat1622float2(g2[j]);
        dsum = fmaf(fa.x, fg.x, dsum);
        dsum = fmaf(fa.y, fg.y, dsum);
      }
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
  const Score sc(P.scale, P.softcap);
  const int wp0 = w0 + P.qoff;  // the position of row w0

  float dq[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) dq[j] = 0.f;
  const uint32_t myQ = sQ + wg * TILE_BYTES, myO = sO + wg * TILE_BYTES;
  mbar_wait(qfull, 0);
  KeyWalk walk{0, nk, q0 + P.qoff, q1 + P.qoff, P.Skv, P.causal, P.window};
  walk.settle();
  int ks = 0;
  uint32_t kph = 0, vph = 0;
  for (; !walk.done(); walk.next()) {
    const uint32_t kt = sK + ks * TILE_BYTES;
    const int kt0 = walk.t * TILE;
    float s[32], dp[32];  // S and dP: this warpgroup's 64 rows x 64 keys
    mbar_wait(kfull + 8 * ks, kph);
    mbar_wait(vfull, vph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // the two chains interleaved
      wgmma_m64n64k16<0, 0>(s, kmajor(myQ, kk), kmajor(kt, kk), kk > 0);
      wgmma_m64n64k16<0, 0>(dp, kmajor(myO, kk), kmajor(sV, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(s);
    fence_all(dp);
    if (elected) mbar_arrive(vempty);  // V is read: the next one may load
    vph ^= 1;

    // dS, in s; the scale goes to the sum. A warp whose 16 rows see all 64
    // keys skips the position tests
    const bool inside = w0 + 15 < P.S && kt0 + TILE <= P.Skv &&
                        tile_inside(wp0, wp0 + 15, kt0, kt0 + TILE - 1, P.causal, P.window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          if (inside) {
            s[e] = pair(s[e], dp[e], ll2[i], dl[i], sc).ds;
            continue;
          }
          const int r = w0 + lane / 4 + 8 * i, kj = kt0 + 8 * j + 2 * (lane % 4) + c;
          const int pos = r + P.qoff;
          float ds = 0.f;
          if (r < P.S && kj < P.Skv && !no_key(pos, P.Skv, P.window) &&
              visible(pos, kj, P.causal, P.window))
            ds = pair(s[e], dp[e], ll2[i], dl[i], sc).ds;
          s[e] = ds;
        }
    uint32_t a[4][4];  // dS as bf16 A fragments, 16 keys each
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      a[kq][0] = pack2(s[8 * kq + 0], s[8 * kq + 1]);
      a[kq][1] = pack2(s[8 * kq + 2], s[8 * kq + 3]);
      a[kq][2] = pack2(s[8 * kq + 4], s[8 * kq + 5]);
      a[kq][3] = pack2(s[8 * kq + 6], s[8 * kq + 7]);
    }
    // dQ += dS K: K MN-major (keys as k, the head dim as N)
    fence_all(dq);
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) wgmma_m64n256k16_rs<1>(dq, a[kq], mnmajor(kt, kq), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(dq);
    if (elected) mbar_arrive(kempty + 8 * ks);
    if (++ks == K_SLOTS) ks = 0, kph ^= 1;
  }

  // dQ * scale, through this warpgroup's own Q tile, out by TMA stores
  stage_rows(myQ, dq, 0, P.scale);
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (elected) {
    for (int j = 0; j < D / 64; ++j) tma_store_4d(&P.dq, myQ + j * BOX, 64 * j, h, q0 + TILE * wg, b);
    bulk_commit();
    bulk_wait<0>();
  }
}

// ---------------------------------------------------------------- dK, dV

// The q tiles a dK/dV block walks, in order: for each q head g of its
// group, the tiles of 64 rows that see one of keys [k0, k1] or hold rows
// that see no key (rows at positions qoff + index)
struct QWalk {
  int g, i;  // q head of the group and q tile; g == G once the walk is done
  int G, n, S, Skv, k0, k1, causal, window, qoff;
  bool any_no_key;
  __device__ bool needed() const {
    const int p0 = i * TILE + qoff, p1 = min(i * TILE + TILE, S) - 1 + qoff;
    return tile_sees(p0, p1, k0, k1, causal, window) || (any_no_key && no_key(p1, Skv, window));
  }
  __device__ void settle() {
    while (g < G) {
      while (i < n && !needed()) ++i;
      if (i < n) return;
      ++g;
      i = 0;
    }
  }
  __device__ bool done() const { return g >= G; }
  __device__ void next() {
    ++i;
    settle();
  }
};

__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dkdv_wgmma(const __grid_constant__ Params P) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = base + DkdvSmem::K, sV = base + DkdvSmem::V, ring = base + DkdvSmem::RING;
  const uint32_t sP = base + DkdvSmem::P, sDS = base + DkdvSmem::DS;
  const uint32_t kvfull = base + DkdvSmem::BAR, full = kvfull + 8, empty = full + 8 * ST;
  const int G = P.Hq / P.Hkv;
  const int b = blockIdx.x / P.Hkv, hk = blockIdx.x % P.Hkv;
  // key block blockIdx.y: block 0, which every causal row sees, first
  const int k0 = blockIdx.y * TILE, k1 = min(k0 + TILE, P.Skv) - 1;
  const bool any_no_key = P.window > 0 && P.S + P.qoff >= P.Skv + P.window;
  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < ST; ++s) mbar_init(full + 8 * s, 1), mbar_init(empty + 8 * s, kConsumers);
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  QWalk walk{0, 0, G, (P.S + TILE - 1) / TILE, P.S, P.Skv, k0, k1, P.causal, P.window, P.qoff,
             any_no_key};
  walk.settle();

  if (wg == kConsumers) {
    // ------------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      mbar_arrive_expect_tx(kvfull, 2 * TILE_BYTES);
      for (int j = 0; j < D / 64; ++j) {
        tma_load_4d(sK + j * BOX, &P.k, kvfull, 64 * j, hk, k0, b);
        tma_load_4d(sV + j * BOX, &P.v, kvfull, 64 * j, hk, k0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (; !walk.done(); walk.next()) {
        const int h = hk * G + walk.g;
        const uint32_t sq = ring + stage * 2 * TILE_BYTES;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_arrive_expect_tx(full + 8 * stage, 2 * TILE_BYTES);
        for (int j = 0; j < D / 64; ++j) {
          tma_load_4d(sq + j * BOX, &P.q, full + 8 * stage, 64 * j, h, walk.i * TILE, b);
          tma_load_4d(sq + TILE_BYTES + j * BOX, &P.dout, full + 8 * stage, 64 * j, h,
                      walk.i * TILE, b);
        }
        if (++stage == ST) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // -------------------------------------------------- consumers
  setmaxnreg_inc<232>();
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const bool elected = threadIdx.x % 128 == 0;
  const int wk0 = k0 + 16 * warp;  // this warp's keys: wk0 .. wk0 + 15
  const Score sc(P.scale, P.softcap);
  float dk[64], dv[64];  // this warpgroup's 128 columns of dK and dV
#pragma unroll
  for (int j = 0; j < 64; ++j) dk[j] = dv[j] = 0.f;
  mbar_wait(kvfull, 0);
  int stage = 0, odd = 0;
  uint32_t phase = 0;
  for (; !walk.done(); walk.next(), odd ^= 1) {
    const int h = hk * G + walk.g;
    const int c0 = walk.i * TILE + 32 * wg;  // this warpgroup's 32 q rows (columns of S^T)
    const size_t lbase = ((size_t)P.Hkv * G * b + h) * P.S;
    // lse (log2 units) and Delta of this thread's 8 q columns c0 + 8 j + 2 (lane % 4) + c
    float l2[8], dl[8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = c0 + 8 * j + 2 * (lane % 4) + c;
        l2[2 * j + c] = qi < P.S ? P.lse[lbase + qi] * LOG2E : 0.f;
        dl[2 * j + c] = qi < P.S ? P.delta[lbase + qi] : 0.f;
      }
    const uint32_t sq = ring + stage * 2 * TILE_BYTES, so = sq + TILE_BYTES;
    float s[16], dp[16];  // S^T and dP^T: 64 keys x this warpgroup's 32 q rows
    mbar_wait(full + 8 * stage, phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // the two chains interleaved
      wgmma_m64n32k16<0, 0>(s, kmajor(sK, kk), kmajor(sq, kk, 32 * wg), kk > 0);
      wgmma_m64n32k16<0, 0>(dp, kmajor(sV, kk), kmajor(so, kk, 32 * wg), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(s);
    fence_all(dp);

    // P^T and dS^T of this warp's 16 keys x 32 q rows, as bf16 pairs
    const int p0 = c0 + P.qoff;  // the position of q row c0
    const bool inside = c0 + 31 < P.S && wk0 + 15 < P.Skv &&
                        tile_inside(p0, p0 + 31, wk0, wk0 + 15, P.causal, P.window);
    uint32_t pw[8], dw[8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float pv[2], dv2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c, x = 2 * j + c;
          if (inside) {
            const Pd g = pair(s[e], dp[e], l2[x], dl[x], sc);
            pv[c] = g.p;
            dv2[c] = g.ds;
            continue;
          }
          const int qi = c0 + 8 * j + 2 * (lane % 4) + c, kj = wk0 + lane / 4 + 8 * i;
          const int pos = qi + P.qoff;
          pv[c] = dv2[c] = 0.f;
          if (qi < P.S && kj < P.Skv) {
            if (no_key(pos, P.Skv, P.window)) {
              pv[c] = 1.f / (float)P.Skv;
            } else if (visible(pos, kj, P.causal, P.window)) {
              const Pd g = pair(s[e], dp[e], l2[x], dl[x], sc);
              pv[c] = g.p;
              dv2[c] = g.ds;
            }
          }
        }
        pw[2 * j + i] = pack2(pv[0], pv[1]);
        dw[2 * j + i] = pack2(dv2[0], dv2[1]);
      }
    // this step's P^T and dS^T: the other pair is the last step's, which the
    // other warpgroup may still be reading; it read this pair before it
    // passed the last step's barrier
    const uint32_t bP = sP + odd * BOX, bDS = sDS + odd * BOX;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // row: key 16 warp + lane / 4 + 8 i; column: q row 32 wg + 8 j + 2 (lane % 4)
        const int r = 16 * warp + lane / 4 + 8 * i, chunk = 4 * wg + j;
        const uint32_t off = r * 128 + ((chunk ^ (r % 8)) * 16) + (lane % 4) * 4;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(bP + off), "r"(pw[2 * j + i]) : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(bDS + off), "r"(dw[2 * j + i]) : "memory");
      }
    fence_proxy_async();
    named_barrier_sync(1, 256);  // P^T and dS^T are whole

    // dV += P^T dO, dK += dS^T Q: this warpgroup's 128 columns (boxes 2 wg, 2 wg + 1)
    fence_all(dv);
    fence_all(dk);
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < TILE / 16; ++kq) {
      wgmma_m64n128k16<0, 1>(dv, kmajor(bP, kq), mnmajor(so, kq, 2 * wg), 1);
      wgmma_m64n128k16<0, 1>(dk, kmajor(bDS, kq), mnmajor(sq, kq, 2 * wg), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(dv);
    fence_all(dk);
    if (elected) mbar_arrive(empty + 8 * stage);
    if (++stage == ST) stage = 0, phase ^= 1;
  }

  // dK * scale and dV through the K and V tiles (both warpgroups are done
  // reading them), out by TMA stores
  named_barrier_sync(3, 256);
  stage_rows(sK, dk, 128 * wg, P.scale);
  stage_rows(sV, dv, 128 * wg, 1.f);
  fence_proxy_async();
  named_barrier_sync(4 + wg, 128);
  if (elected) {
    for (int j = 2 * wg; j < 2 * wg + 2; ++j) {
      tma_store_4d(&P.dk, sK + j * BOX, 64 * j, hk, k0, b);
      tma_store_4d(&P.dv, sV + j * BOX, 64 * j, hk, k0, b);
    }
    bulk_commit();
    bulk_wait<0>();
  }
}

// ---------------------------------------------------------------- host side

// a map over (B, rows, heads, D) bf16 in boxes of 64 columns x 64 rows of one head
int make_map(CUtensorMap* m, const void* base, int B, int rows, int heads) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)heads, (uint64_t)rows, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)heads * D * 2,
                               (uint64_t)rows * heads * D * 2};
  const uint32_t box[4] = {64, 1, TILE, 1};
  return encode_bf16_4d(m, base, dims, strides, box);
}

}  // namespace

extern "C" {

// Shared bytes a CTA of launch 0 (dQ) or 1 (dK/dV) takes
// (kernel.bwd_wgmma_plan computes the same).
long long fa_bwd_wgmma_smem_bytes(int launch) {
  return launch == 0 ? DqSmem::BYTES : launch == 1 ? DkdvSmem::BYTES : -1;
}

// q, o, dout, dq (B, S, Hq, 256) and k, v, dk, dv (B, Skv, Hkv, 256) bf16;
// lse (B, Hq, S) f32, the forward's; delta (B, Hq, S) f32 scratch; all
// contiguous, every base a 16-byte multiple. window <= 0: none; softcap
// <= 0: none; q_offset >= 0: the position of q's first row. Two launches on
// `stream`, dQ (which writes Delta) then dK/dV. Returns a cudaError_t, or
// 100000 + a CUresult where a tensor map could not be encoded.
int fa_backward_wgmma(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* delta, void* dq, void* dk,
                      void* dv, int B, int S, int Skv, int Hq, int Hkv, int causal, int window,
                      float softcap, float scale, int qoff, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || qoff < 0)
    return (int)cudaErrorInvalidValue;
  Params P = {};
  int r = make_map(&P.q, q, B, S, Hq);
  if (r == CUDA_SUCCESS) r = make_map(&P.dout, dout, B, S, Hq);
  if (r == CUDA_SUCCESS) r = make_map(&P.dq, dq, B, S, Hq);
  if (r == CUDA_SUCCESS) r = make_map(&P.k, k, B, Skv, Hkv);
  if (r == CUDA_SUCCESS) r = make_map(&P.v, v, B, Skv, Hkv);
  if (r == CUDA_SUCCESS) r = make_map(&P.dk, dk, B, Skv, Hkv);
  if (r == CUDA_SUCCESS) r = make_map(&P.dv, dv, B, Skv, Hkv);
  if (r != CUDA_SUCCESS) return kEncodeError + r;
  P.o = static_cast<const bf16*>(o);
  P.dout_rows = static_cast<const bf16*>(dout);
  P.lse = static_cast<const float*>(lse);
  P.delta = static_cast<float*>(delta);
  P.S = S, P.Skv = Skv, P.Hq = Hq, P.Hkv = Hkv, P.causal = causal, P.window = window;
  P.qoff = qoff, P.softcap = softcap, P.scale = scale;

  static int dq_in[kMaxDevices] = {}, dkdv_in[kMaxDevices] = {};
  cudaError_t err;
  if ((err = opt_in(fa_bwd_dq_wgmma, DqSmem::BYTES, dq_in)) != cudaSuccess) return (int)err;
  if ((err = opt_in(fa_bwd_dkdv_wgmma, DkdvSmem::BYTES, dkdv_in)) != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fa_bwd_dq_wgmma<<<dim3(B * Hq, (S + DQ_ROWS - 1) / DQ_ROWS), kThreads, DqSmem::BYTES, st>>>(P);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fa_bwd_dkdv_wgmma<<<dim3(B * Hkv, (Skv + TILE - 1) / TILE), kThreads, DkdvSmem::BYTES, st>>>(P);
  return (int)cudaGetLastError();
}

}  // extern "C"
