// Flash attention backward at head dims 64, 80, 128 and 256 on Hopper, bf16,
// on wgmma fed by TMA. It computes what flash_attention_bwd.cu computes (the
// FA2 backward of flash_attention.cu: P = exp(S - lse) recomputed tile by
// tile, dV = P^T dO, dP = dO V^T, dS = P (dP - Delta) times 1 - tanh^2(s /
// c) under a softcap c, dK = dS^T Q scale, dQ = dS K scale), with every
// mask of that file: GQA, causal, a window, rows that see no key (P = 1 /
// Skv, dS = 0) and the query offset (row i sits at position q_offset + i).
// That file keeps the other head dims, f32, and bf16 bases TMA cannot
// address; the reference has no backward kernel (XLA differentiates its
// plain attention), so this is the backward of the port's forward kernel,
// which replaces `_fa_kernel` of src/repro/kernels/flash_attention/kernel.py.
//
// What bounds it on an H100 SXM: operations. At qwen3-0.6b's training shape
// (B4 S2048, 16 q / 8 kv heads of 128, causal) the mask keeps 134.3 M
// (query, key) pairs; the five products a backward needs are 172 GFLOP,
// 0.174 ms at the bf16 tensor-core peak, against 202 MB moved. At gemma2-2b's
// (B1 S4096, 8 / 4 heads of 256, causal, window 4096, softcap 50) 67.1 M
// pairs, 172 GFLOP again, against 92 MB. At stablelm-3b's (B1 S2048, 32
// heads of 80, causal) 67.1 M pairs, 53.7 GFLOP, 0.0543 ms; at hymba-1.5b's
// global layer (B1 S1528, 25 / 5 heads of 64, causal) 29.2 M pairs, 18.7
// GFLOP, 0.0189 ms; there the exponents come close to the products (both
// launches recompute P: two ex2 a pair, 0.52 ps of the card's special-
// function units against 0.65 ps of its five products at the bf16 peak).
// The mma.sync engine of
// flash_attention_bwd.cu reaches 0.165 of the bound at D 128 (each warp holds
// 16 rows over the whole head dim: 255 registers and a spill) and 0.037 at
// D 256 (each of two CTAs a block recomputes S and dP over all 256 columns).
//
// Design: two launches, dQ (whose prologue also writes Delta = rowsum(dO
// O), which dK/dV reads) then dK/dV; each CTA one producer warpgroup (one
// thread starts the TMA loads; the warpgroup gives its registers away with
// setmaxnreg) and two consumer warpgroups on wgmma. Every tile is 64 rows x
// D bf16 columns, loaded as ceil(D / 64) TMA boxes of 64 rows x 64 columns
// with 128-byte swizzle through a 4-D tensor map over (D, heads, rows, B)
// whose box takes one head: the same boxes serve as K-major operands (q rows or
// keys as M or N, the head dim as K) and MN-major ones (the head dim as N)
// by the descriptor's transpose bit, so nothing is transposed. Rows past S
// or Skv load as zeros and are masked; the outputs go out by TMA stores
// that clip them. At D 80 a row takes two boxes, the tensor maps' bounds of
// 80 columns filling columns 80-127 of the second with zeros on a load and
// clipping them from a store: S and dP walk 5 k steps of 16 (the fifth in
// the second box), and each register-A product over the head dim (dQ += dS
// K, dV += P^T dO, dK += dS^T Q) is one m64n80k16 whose MN-major B crosses
// from the first box into the second's first 16 columns.
//
//   dQ: a CTA owns 128 q rows of one head, 64 a consumer warpgroup, with Q
//   and dO resident. Per visible 64-key step: S = Q K^T, then dP = dO V^T
//   (m64n64k16, both operands from shared memory, each its own commit
//   group, so P's exponent runs under dP's products), dS in registers, then
//   dQ += dS K with dS as the A operand from registers (m64nDk16; the
//   accumulator's fragment is the A fragment) and K MN-major. K and V
//   stream through rings (D 256: 2 and 1 slots, 224 KB; D 64, 80 and 128: 3
//   and 2, 73 KB at D 64 and 145 KB at 80 and 128); the next V loads once
//   this step's dP is done. Below D 256 a step's dS K product is issued
//   behind the next step's S and dP and runs under its elementwise work
//   (its K slot released then); the first step issues
//   it with zero fragments against the resident Q tile, so that every step
//   issues the same products on one path. The heaviest causal block
//   launches first.
//
//   dK/dV, D 64, 80 and 128: a CTA owns 128 keys of one KV head, 64 a
//   consumer warpgroup, K and V resident, and walks its group's q heads and
//   the q tiles that see its keys, the q and dO tiles streaming through a
//   three-stage ring. Each warpgroup keeps its 64 keys x D columns of dK
//   and dV in registers (D a thread: 128, 80 or 64; the consumers take 240
//   registers, the producer keeps 24): per step it computes S^T = K Q^T,
//   then dP^T = V dO^T (m64n64k16; without a softcap P^T's exponent runs
//   under dP^T),
//   forms P^T and dS^T in registers, packs them 16 q rows at a time and
//   takes them as the A operands of dV += P^T dO and dK += dS^T Q
//   (m64nDk16, B MN-major). No shared-memory round trip and no barrier
//   between the warpgroups. The lse (in log2 units) and Delta of a stage's
//   64 q rows ride in the ring beside its tiles, written by two more
//   producer warps and read from shared memory as each pair needs them.
//   Every pair is computed as if visible; a warp tile on a mask edge then
//   takes the masks by selects, which keep the registers the masked path
//   would spill.
//
//   dK/dV, D 256: a CTA owns 64 keys, K and V resident, the q and dO tiles
//   in a two-stage ring. The 64 x 256 f32 dK and dV of its keys are 256
//   registers a thread for one warpgroup, so each consumer warpgroup owns
//   128 columns of both. S^T and dP^T are computed once a step: each
//   warpgroup takes 32 of the 64 q columns (m64n32k16), forms its part of
//   P^T and dS^T and writes it to shared memory as bf16 in the swizzled
//   layout wgmma reads (two buffers, for even and odd steps, so one barrier
//   a step suffices); then both take all 64 as the A operand of dV += P^T
//   dO and dK += dS^T Q (m64n128k16, B MN-major).
//
// Every kernel is built with and without a softcap (CAP), so no pair pays
// for a test of it, and a warp tile wholly inside the masks skips the
// position tests. Descriptors step within a tile by adding to their
// address field.
//
// Determinism: no atomics; every CTA walks its steps in one fixed order, so
// reruns are bit-equal. tanh is 1 - 2 / (e^2y + 1) on the special-function
// unit. Every wgmma.wait_group is on every path, and every product is
// issued on every path, so ptxas never serializes the products.
//
// What holds it back (PERF.md §6 has the times): the elementwise work of a
// step (the exponent, the selects on mask edges, the bf16 packing) is issue
// time each warpgroup spends between its own products, hidden only while
// the other warpgroup has products in flight; a fully masked 64-key tile
// of a causal diagonal is still computed (the keys of the CTA's second
// warpgroup on its first q tile); at D 256 dK/dV's warpgroups meet at a
// barrier every step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int TILE = 64;                          // rows (q rows or keys) of a tile and a step
constexpr int BOX = TILE * 128;                   // 8 KB: 64 rows of 64 columns (128 bytes)
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // the last warpgroup loads
constexpr float LOG2E = 1.4426950408889634f;

// boxes of 64 columns a row of D columns (at D 80 the second's last 48
// columns are TMA's zeros), and the bytes of a tile of 64 rows
__host__ __device__ constexpr int boxes(int D) { return (D + 63) / 64; }
__host__ __device__ constexpr int tile_bytes(int D) { return boxes(D) * BOX; }

// dQ: q rows a CTA, slots of the K and V rings; its shared memory from the
// 1024-aligned base: Q and dO of each consumer, the K and V slots, barriers
// (Q and dO; K full and empty a slot; V full and empty a slot)
constexpr int DQ_ROWS = TILE * kConsumers;
template <int D>
struct DqSmem {
  static constexpr int T = tile_bytes(D);
  static constexpr int K_SLOTS = D == 256 ? 2 : 3, V_SLOTS = D == 256 ? 1 : 2;
  static constexpr int Q = 0, DO = Q + kConsumers * T;
  static constexpr int K = DO + kConsumers * T, V = K + K_SLOTS * T;
  static constexpr int BAR = V + V_SLOTS * T;
  static constexpr int BYTES = 1024 + BAR + 8 * (1 + 2 * K_SLOTS + 2 * V_SLOTS);
};

// dK/dV: keys a CTA, stages of the q/dO ring, shared memory: K, V, the ring
// (q tile then dO tile a stage), then barriers (K and V; full and empty a
// stage)
// D 64, 80 and 128: 128 keys, 64 a consumer warpgroup; a stage's lse (log2
// units) and Delta, 64 f32 each, before the barriers
template <int D>
struct DkdvSmem {
  static constexpr int ROWS = TILE * kConsumers, ST = 3, T = tile_bytes(D);
  static constexpr int K = 0, V = kConsumers * T, RING = 2 * kConsumers * T;
  static constexpr int LD = RING + ST * 2 * T;
  static constexpr int BAR = LD + ST * 2 * TILE * 4;
  static constexpr int FULL_ARRIVALS = 1 + 64;  // the TMA thread and the lse/Delta warps
  static constexpr int BYTES = 1024 + BAR + 8 * (1 + 2 * ST);
};
// D 256: 64 keys; P^T and dS^T (64 keys x 64 q bf16, one box each) for even
// and for odd steps before the barriers
template <>
struct DkdvSmem<256> {
  static constexpr int ROWS = TILE, ST = 2, T = tile_bytes(256);
  static constexpr int K = 0, V = T, RING = 2 * T;
  static constexpr int P = RING + ST * 2 * T, DS = P + 2 * BOX;
  static constexpr int BAR = DS + 2 * BOX;
  static constexpr int FULL_ARRIVALS = 1;  // the TMA thread
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

// `x` as a value the compiler cannot see through: descriptors computed from
// it inside a loop stay in the loop instead of holding two registers each
// across the whole walk
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %1;\n" : "=r"(x) : "r"(x));
  return x;
}

// two f32 out of shared memory, and one into it
__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// The score's constants in log2 units: x = s scale, or c tanh(s scale / c)
// under a softcap c (CAP: the kernels are built with and without one, so
// that no pair pays for the test), and P = 2^(x log2 e - lse log2 e)
template <bool CAP>
struct Score {
  float mul;   // no softcap: scale log2 e; with one: 2 log2 e scale / c (tanh's e^2y)
  float cap2;  // c log2 e
  __device__ Score(float scale, float softcap)
      : mul(CAP ? 2.f * LOG2E * scale / softcap : scale * LOG2E), cap2(softcap * LOG2E) {}
};

// P and dS of a visible pair from the raw products s = q . k and dp = dO .
// v: dS = P (dP - Delta), times 1 - tanh^2 under a softcap; tanh(y) is
// 1 - 2 / (e^2y + 1) on the special-function unit
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

// P times dS's softcap factor 1 - tanh^2 (P alone without a softcap) of a
// visible pair from the raw product s: dS is this times dP - Delta
template <bool CAP>
__device__ __forceinline__ float p_dcap(float s, float lse2, const Score<CAP>& sc) {
  if constexpr (!CAP) return ex2(fmaf(s, sc.mul, -lse2));
  const float t = fmaf(-2.f, __fdividef(1.f, ex2(s * sc.mul) + 1.f), 1.f);
  return ex2(fmaf(t, sc.cap2, -lse2)) * fmaf(-t, t, 1.f);
}

// The K-major descriptor of 16 columns (k step kk of 16) of a 64-row tile
// of boxes at `tile`, starting at row `row` (a multiple of 8). A step within
// a tile adds to the address field alone (shared addresses stay below 2^18),
// so an unrolled walk costs one add a descriptor
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk, int row = 0) {
  return wgmma_desc(tile + row * 128, 16, 1024) + (((kk / 4) * BOX + (kk % 4) * 32) >> 4);
}
// The MN-major descriptor of 16 rows (k step kk) of a tile of boxes at
// `tile`, its N columns starting at box `box`
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk, int box = 0) {
  return wgmma_desc(tile + box * BOX, BOX, 1024) + ((kk * 2048) >> 4);
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}
// pin A fragments where they are packed: the compiler may not sink the
// packing into the (conditional) block that issues their product, where
// ptxas would have to fence them on one path only and serialize every wgmma
__device__ __forceinline__ void fence_all(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

// The bf16 A fragment of columns 16 kq .. 16 kq + 15 of a 64 x 64 f32
// accumulator fragment (acc[4j + 2i + c]: row 16 warp + lane / 4 + 8 i,
// column 8 j + 2 (lane % 4) + c)
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], const float (&acc)[32], int kq) {
#pragma unroll
  for (int x = 0; x < 4; ++x) a[x] = pack2(acc[8 * kq + 2 * x], acc[8 * kq + 2 * x + 1]);
}

// acc (64 rows x D, f32) += A B over the whole head dim as N: A a bf16
// fragment from registers (a_fragment's layout), B MN-major through its
// descriptor (at D 80 N crosses from the first box into the second)
template <int D>
__device__ __forceinline__ void head_rs(float (&acc)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64)
    wgmma_m64n64k16_rs<1>(acc, a, db, 1);
  else if constexpr (D == 80)
    wgmma_m64n80k16_rs<1>(acc, a, db, 1);
  else if constexpr (D == 128)
    wgmma_m64n128k16_rs<1>(acc, a, db, 1);
  else
    wgmma_m64n256k16_rs<1>(acc, a, db, 1);
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
  int t, p0, p1;
  __device__ void settle(const Params& P) {
    while (!done(P) &&
           !tile_sees(p0, p1, t * TILE, min(t * TILE + TILE, P.Skv) - 1, P.causal, P.window))
      ++t;
  }
  __device__ bool done(const Params& P) const { return t * TILE >= P.Skv; }
  __device__ void next(const Params& P) {
    ++t;
    settle(P);
  }
};

template <int D, bool CAP>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dq_wgmma(const __grid_constant__ Params P) {
  using G = DqSmem<D>;
  constexpr int T = G::T, KS = G::K_SLOTS, VS = G::V_SLOTS;
  // D 64, 80, 128: a step's dS K product is issued behind the next step's S
  // and dP and runs under its elementwise work, its K slot released then; D
  // 256 has no K slot to spare
  constexpr bool kDefer = D != 256;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + G::Q, sO = base + G::DO;
  const uint32_t sK = base + G::K, sV = base + G::V;
  const uint32_t qfull = base + G::BAR, kfull = qfull + 8, kempty = kfull + 8 * KS;
  const uint32_t vfull = kempty + 8 * KS, vempty = vfull + 8 * VS;
  const int b = blockIdx.x / P.Hq, h = blockIdx.x % P.Hq, hk = h / (P.Hq / P.Hkv);
  const int q0 = heavy_first(blockIdx.y, gridDim.y, DQ_ROWS, P.S) * DQ_ROWS;
  const int q1 = min(q0 + DQ_ROWS, P.S) - 1;
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < KS; ++s) mbar_init(kfull + 8 * s, 1), mbar_init(kempty + 8 * s, kConsumers);
    for (int s = 0; s < VS; ++s) mbar_init(vfull + 8 * s, 1), mbar_init(vempty + 8 * s, kConsumers);
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // ------------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      mbar_arrive_expect_tx(qfull, 2 * kConsumers * T);
      for (int w = 0; w < kConsumers; ++w)
        for (int j = 0; j < boxes(D); ++j) {
          tma_load_4d(sQ + w * T + j * BOX, &P.q, qfull, 64 * j, h, q0 + TILE * w, b);
          tma_load_4d(sO + w * T + j * BOX, &P.dout, qfull, 64 * j, h, q0 + TILE * w, b);
        }
      KeyWalk walk{0, q0 + P.qoff, q1 + P.qoff};
      walk.settle(P);
      int ks = 0, vs = 0;
      uint32_t kph = 0, vph = 0;
      for (; !walk.done(P); walk.next(P)) {
        mbar_wait(kempty + 8 * ks, kph ^ 1);
        mbar_arrive_expect_tx(kfull + 8 * ks, T);
        for (int j = 0; j < boxes(D); ++j)
          tma_load_4d(sK + ks * T + j * BOX, &P.k, kfull + 8 * ks, 64 * j, hk, walk.t * TILE, b);
        if (++ks == KS) ks = 0, kph ^= 1;
        mbar_wait(vempty + 8 * vs, vph ^ 1);
        mbar_arrive_expect_tx(vfull + 8 * vs, T);
        for (int j = 0; j < boxes(D); ++j)
          tma_load_4d(sV + vs * T + j * BOX, &P.v, vfull + 8 * vs, 64 * j, hk, walk.t * TILE, b);
        if (++vs == VS) vs = 0, vph ^= 1;
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
  const Score<CAP> sc(P.scale, P.softcap);
  const int wp0 = w0 + P.qoff;  // the position of row w0

  float dq[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;
  const uint32_t myQ = sQ + wg * T, myO = sO + wg * T;
  mbar_wait(qfull, 0);
  KeyWalk walk{0, q0 + P.qoff, q1 + P.qoff};
  walk.settle(P);
  int ks = 0, vs = 0, kprev = 0;
  uint32_t kph = 0, vph = 0;
  bool owed = false;  // (D 128) the last step's dS K product is still to be issued
  uint32_t a[4][4];   // dS as bf16 A fragments, 16 keys each (zeros before the first step)
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i / 4][i % 4] = 0u;
  for (; !walk.done(P); walk.next(P)) {
    const uint32_t kt = sK + ks * T, vt = sV + vs * T;
    const uint32_t qt = opaque(myQ), ot = opaque(myO);
    const int kt0 = walk.t * TILE;
    float s[32], dp[32];  // S and dP: this warpgroup's 64 rows x 64 keys
    mbar_wait(kfull + 8 * ks, kph);
    mbar_wait(vfull + 8 * vs, vph);
    // S, then dP, each its own group: P's exponent runs under dP's products
    fence_all(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16<0, 0>(s, kmajor(qt, kk), kmajor(kt, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16<0, 0>(dp, kmajor(ot, kk), kmajor(vt, kk), kk > 0);
    wgmma_commit();
    if constexpr (kDefer) {
      // the last step's dQ += dS K behind them. The first step adds zero
      // fragments times the resident Q tile (exact zeros): every step issues
      // the same products on one path, since a product issued on one path
      // only makes ptxas fence it there and serialize every wgmma
      const uint32_t kb = owed ? sK + kprev * T : myQ;
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) head_rs<D>(dq, a[kq], mnmajor(kb, kq));
      wgmma_commit();
    }
    wgmma_wait<kDefer ? 2 : 1>();  // S
    fence_all(s);

    // P, times 1 - tanh^2 under a softcap, in s (0 where masked); a warp
    // whose 16 rows see all 64 keys skips the position tests. Its rows past
    // S need none: their Q and dO rows load as zeros and their lse and Delta
    // are 0, so P is 1 and dS 0, and the store clips their dQ (through the
    // position tests a ragged block's last warp took each step about twice
    // as long, and its CTA set the launch's time)
    const bool inside = kt0 + TILE <= P.Skv &&
                        tile_inside(wp0, wp0 + 15, kt0, kt0 + TILE - 1, P.causal, P.window);
    if (inside) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = p_dcap(s[e], ll2[(e / 2) % 2], sc);
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e / 2) % 2;
        const int r = w0 + lane / 4 + 8 * i, kj = kt0 + 8 * (e / 4) + 2 * (lane % 4) + e % 2;
        const int pos = r + P.qoff;
        s[e] = r < P.S && kj < P.Skv && !no_key(pos, P.Skv, P.window) &&
                       visible(pos, kj, P.causal, P.window)
                   ? p_dcap(s[e], ll2[i], sc)
                   : 0.f;
      }
    }
    wgmma_wait<kDefer ? 1 : 0>();  // dP
    fence_all(dp);
    if (elected) mbar_arrive(vempty + 8 * vs);  // V is read: the next one may load
    if (++vs == VS) vs = 0, vph ^= 1;
    // dS = P (dP - Delta) (1 - tanh^2), in s; the scale goes to the sum
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] *= dp[e] - dl[(e / 2) % 2];
    if constexpr (kDefer) {
      wgmma_wait<0>();  // the last step's dS K: its A fragments and K slot are free
      fence_all(dq);
      if (owed && elected) mbar_arrive(kempty + 8 * kprev);
    }
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) a_fragment(a[kq], s, kq);
    fence_all(a);
    if constexpr (kDefer) {
      owed = true;
      kprev = ks;
    } else {
      // dQ += dS K: K MN-major (keys as k, the head dim as N)
      fence_all(dq);
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) head_rs<D>(dq, a[kq], mnmajor(kt, kq));
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(dq);
      if (elected) mbar_arrive(kempty + 8 * ks);
    }
    if (++ks == KS) ks = 0, kph ^= 1;
  }
  if constexpr (kDefer) {  // the last step's dS K (zeros where the walk was empty)
    const uint32_t kb = owed ? sK + kprev * T : myQ;
    fence_all(dq);
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) head_rs<D>(dq, a[kq], mnmajor(kb, kq));
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(dq);
  }

  // dQ * scale, through this warpgroup's own Q tile, out by TMA stores
  stage_rows(myQ, dq, 0, P.scale);
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (elected) {
    for (int j = 0; j < boxes(D); ++j)
      tma_store_4d(&P.dq, myQ + j * BOX, 64 * j, h, q0 + TILE * wg, b);
    bulk_commit();
    bulk_wait<0>();
  }
}

// ---------------------------------------------------------------- dK, dV

// dkdv_edges: a dK/dV warp tile tests no edge past S or Skv. A q row past S
// loads as zeros with lse and Delta 0, so its P^T column is 1 and its dS^T
// column 0, and it adds P^T dO = 0 to dV and dS^T Q = 0 to dK. A key past
// Skv loads as zeros, and its P^T and dS^T row lands only in its own row of
// dK and dV, which the store clips. So only the masks over positions (and
// rows that see no key) take the selects: a ragged block's warps took every
// step of theirs twice as long through them.

// The q tiles a dK/dV block walks, in order: for each q head g of its
// group, the tiles of 64 rows that see one of keys [k0, k1] or hold rows
// that see no key (rows at positions qoff + index)
struct QWalk {
  int g, i;  // q head of the group and q tile; g == Hq / Hkv once the walk is done
  int k0, k1;
  __device__ bool needed(const Params& P) const {
    const int p0 = i * TILE + P.qoff, p1 = min(i * TILE + TILE, P.S) - 1 + P.qoff;
    // a row that sees no key sits at position Skv + window - 1 or later
    return tile_sees(p0, p1, k0, k1, P.causal, P.window) || no_key(p1, P.Skv, P.window);
  }
  __device__ void settle(const Params& P) {
    while (!done(P)) {
      while (i * TILE < P.S && !needed(P)) ++i;
      if (i * TILE < P.S) return;
      ++g;
      i = 0;
    }
  }
  __device__ bool done(const Params& P) const { return g >= P.Hq / P.Hkv; }
  __device__ void next(const Params& P) {
    ++i;
    settle(P);
  }
};

template <int D, bool CAP>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dkdv_wgmma(const __grid_constant__ Params P) {
  using G = DkdvSmem<D>;
  constexpr int T = G::T, ST = G::ST;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = base + G::K, sV = base + G::V, ring = base + G::RING;
  const uint32_t kvfull = base + G::BAR, full = kvfull + 8, empty = full + 8 * ST;
  const int grp = P.Hq / P.Hkv;
  const int b = blockIdx.x / P.Hkv, hk = blockIdx.x % P.Hkv;
  // key block blockIdx.y: block 0, which every causal row sees, first
  const int k0 = blockIdx.y * G::ROWS, k1 = min(k0 + G::ROWS, P.Skv) - 1;
  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < ST; ++s)
      mbar_init(full + 8 * s, G::FULL_ARRIVALS), mbar_init(empty + 8 * s, kConsumers);
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  QWalk walk{0, 0, k0, k1};
  walk.settle(P);

  // D 64, 80, 128: each consumer holds dK, dV, S^T and dP^T (192 registers
  // at 128), so the consumers take 240 and the producer keeps 24 (the 168 a
  // thread of the launch, redistributed)
  constexpr int kProducerRegs = D != 256 ? 24 : 40, kConsumerRegs = D != 256 ? 240 : 232;
  if (wg == kConsumers) {
    // ------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    const int t = threadIdx.x % 128;
    if (t == 0) {
      // K and V: one 64-key tile at D 256, one a consumer below
      mbar_arrive_expect_tx(kvfull, 2 * (G::ROWS / TILE) * T);
      for (int w = 0; w < G::ROWS / TILE; ++w)
        for (int j = 0; j < boxes(D); ++j) {
          tma_load_4d(sK + w * T + j * BOX, &P.k, kvfull, 64 * j, hk, k0 + TILE * w, b);
          tma_load_4d(sV + w * T + j * BOX, &P.v, kvfull, 64 * j, hk, k0 + TILE * w, b);
        }
      int stage = 0;
      uint32_t phase = 0;
      for (; !walk.done(P); walk.next(P)) {
        const int h = hk * grp + walk.g;
        const uint32_t sq = ring + stage * 2 * T;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_arrive_expect_tx(full + 8 * stage, 2 * T);
        for (int j = 0; j < boxes(D); ++j) {
          tma_load_4d(sq + j * BOX, &P.q, full + 8 * stage, 64 * j, h, walk.i * TILE, b);
          tma_load_4d(sq + T + j * BOX, &P.dout, full + 8 * stage, 64 * j, h, walk.i * TILE, b);
        }
        if (++stage == ST) stage = 0, phase ^= 1;
      }
    } else if constexpr (D != 256) {
      if (t / 32 == 1 || t / 32 == 2) {
        // lse (log2 units) and Delta of each stage's 64 q rows: warps 1 and
        // 2, 32 rows each, one a lane (the producer has 24 registers a thread)
        const int r = 32 * (t / 32 - 1) + t % 32;
        const uint32_t at0 = base + G::LD + 4 * r;
        int stage = 0;
        uint32_t phase = 0;
        for (; !walk.done(P); walk.next(P)) {
          const int qi = walk.i * TILE + r;
          const size_t row = ((size_t)b * P.Hq + hk * grp + walk.g) * P.S + qi;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t at = at0 + stage * 2 * TILE * 4;
          st_shared_f32(at, qi < P.S ? P.lse[row] * LOG2E : 0.f);
          st_shared_f32(at + 4 * TILE, qi < P.S ? P.delta[row] : 0.f);
          mbar_arrive(full + 8 * stage);
          if (++stage == ST) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // -------------------------------------------------- consumers
  setmaxnreg_inc<kConsumerRegs>();
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const bool elected = threadIdx.x % 128 == 0;
  const Score<CAP> sc(P.scale, P.softcap);
  // D 256: this warpgroup's 128 columns; below: its 64 keys, all D columns
  constexpr int NKV = D == 256 ? 64 : D / 2;
  float dk[NKV], dv[NKV];
#pragma unroll
  for (int j = 0; j < NKV; ++j) dk[j] = dv[j] = 0.f;
  mbar_wait(kvfull, 0);
  int stage = 0;
  uint32_t phase = 0;

  if constexpr (D != 256) {
    const int kw0 = k0 + TILE * wg;   // this warpgroup's 64 keys
    const int wk0 = kw0 + 16 * warp;  // this warp's keys: wk0 .. wk0 + 15
    const uint32_t myK = sK + wg * T, myV = sV + wg * T;
    for (; !walk.done(P); walk.next(P)) {
      const int c0 = walk.i * TILE;  // the step's 64 q rows (columns of S^T)
      const uint32_t sq = ring + stage * 2 * T, so = sq + T;
      const uint32_t sl = base + G::LD + stage * 2 * TILE * 4;
      const uint32_t kt = opaque(myK), vt = opaque(myV);
      float s[32], dp[32];  // S^T and dP^T: this warpgroup's 64 keys x 64 q rows
      mbar_wait(full + 8 * stage, phase);
      // S^T, then dP^T, each its own group: without a softcap P^T's exponent
      // runs under dP^T's products
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16<0, 0>(s, kmajor(kt, kk), kmajor(sq, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16<0, 0>(dp, kmajor(vt, kk), kmajor(so, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_all(s);
      if constexpr (!CAP) {  // P^T of every pair; the masks apply below
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = ld_shared_f2(sl + 4 * (8 * j + 2 * (lane % 4)));
#pragma unroll
          for (int e = 4 * j; e < 4 * j + 4; ++e)
            s[e] = ex2(fmaf(s[e], sc.mul, -(e % 2 ? l2.y : l2.x)));
        }
      }
      wgmma_wait<0>();
      fence_all(dp);

      // P^T and dS^T of this warp's 16 keys x 64 q rows, packed as bf16 A
      // fragments 16 q rows at a time (so the f32 values die as they go).
      // Every pair is computed as if visible; where the warp's tile meets a
      // mask or an edge, selects then set what the masks say (P 0, or 1 / Skv
      // for a row that sees no key; dS 0), so values of masked pairs (inf or
      // NaN among them) go no further. The edges past S and Skv need no test
      // (dkdv_edges)
      const int p0 = c0 + P.qoff;  // the position of q row c0
      const bool inside = tile_inside(p0, p0 + TILE - 1, wk0, wk0 + 15, P.causal, P.window);
      uint32_t pa[4][4], da[4][4];  // P^T and dS^T as bf16 A fragments, 16 q rows each
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
        for (int j = 2 * kq; j < 2 * kq + 2; ++j) {
          const int col = 8 * j + 2 * (lane % 4);  // this thread's q rows c0 + col + c
          const float2 dl = ld_shared_f2(sl + 4 * (TILE + col));
          float2 l2 = {0.f, 0.f};
          if constexpr (CAP) l2 = ld_shared_f2(sl + 4 * col);
#pragma unroll
          for (int e = 4 * j; e < 4 * j + 4; ++e) {
            const float delta = e % 2 ? dl.y : dl.x;
            if constexpr (CAP) {
              const Pd g = pair(s[e], dp[e], e % 2 ? l2.y : l2.x, delta, sc);
              s[e] = g.p;
              dp[e] = g.ds;
            } else {
              dp[e] = s[e] * (dp[e] - delta);
            }
          }
        }
        if (!inside) {
#pragma unroll
          for (int e = 8 * kq; e < 8 * kq + 8; ++e) {
            const int qi = c0 + 8 * (e / 4) + 2 * (lane % 4) + e % 2;
            const int kj = wk0 + lane / 4 + 8 * ((e / 2) % 2);
            const int pos = qi + P.qoff;
            const bool real = qi < P.S && kj < P.Skv, blind = no_key(pos, P.Skv, P.window);
            const bool seen = real && !blind && visible(pos, kj, P.causal, P.window);
            s[e] = seen ? s[e] : real && blind ? 1.f / (float)P.Skv : 0.f;
            dp[e] = seen ? dp[e] : 0.f;
          }
        }
        a_fragment(pa[kq], s, kq);
        a_fragment(da[kq], dp, kq);
      }
      // dV += P^T dO, dK += dS^T Q: all D columns, B MN-major
      fence_all(dv);
      fence_all(dk);
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < TILE / 16; ++kq) {
        head_rs<D>(dv, pa[kq], mnmajor(so, kq));
        head_rs<D>(dk, da[kq], mnmajor(sq, kq));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(dv);
      fence_all(dk);
      if (elected) mbar_arrive(empty + 8 * stage);
      if (++stage == ST) stage = 0, phase ^= 1;
    }

    // dK * scale and dV through this warpgroup's own K and V tiles (only its
    // own products read them), out by TMA stores
    stage_rows(myK, dk, 0, P.scale);
    stage_rows(myV, dv, 0, 1.f);
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);
    if (elected) {
      for (int j = 0; j < boxes(D); ++j) {
        tma_store_4d(&P.dk, myK + j * BOX, 64 * j, hk, kw0, b);
        tma_store_4d(&P.dv, myV + j * BOX, 64 * j, hk, kw0, b);
      }
      bulk_commit();
      bulk_wait<0>();
    }
  } else {
    const uint32_t sP = base + G::P, sDS = base + G::DS;
    const int wk0 = k0 + 16 * warp;  // this warp's keys: wk0 .. wk0 + 15
    int odd = 0;
    for (; !walk.done(P); walk.next(P), odd ^= 1) {
      const int h = hk * grp + walk.g;
      const int c0 = walk.i * TILE + 32 * wg;  // this warpgroup's 32 q rows (columns of S^T)
      const size_t lbase = ((size_t)P.Hkv * grp * b + h) * P.S;
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
      const uint32_t sq = ring + stage * 2 * T, so = sq + T;
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

      // P^T and dS^T of this warp's 16 keys x 32 q rows, as bf16 pairs; the
      // edges past S and Skv need no test (dkdv_edges)
      const int p0 = c0 + P.qoff;  // the position of q row c0
      const bool inside = tile_inside(p0, p0 + 31, wk0, wk0 + 15, P.causal, P.window);
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
}

// ---------------------------------------------------------------- host side

// a map over (B, rows, heads, D) bf16 in boxes of 64 columns x 64 rows of one head
int make_map(CUtensorMap* m, const void* base, int D, int B, int rows, int heads) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)heads, (uint64_t)rows, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)heads * D * 2,
                               (uint64_t)rows * heads * D * 2};
  const uint32_t box[4] = {64, 1, TILE, 1};
  return encode_bf16_4d(m, base, dims, strides, box);
}

template <int D, bool CAP>
int launch(Params& P, const void* q, const void* k, const void* v, const void* dout, void* dq,
           void* dk, void* dv, int B, cudaStream_t st) {
  int r = make_map(&P.q, q, D, B, P.S, P.Hq);
  if (r == CUDA_SUCCESS) r = make_map(&P.dout, dout, D, B, P.S, P.Hq);
  if (r == CUDA_SUCCESS) r = make_map(&P.dq, dq, D, B, P.S, P.Hq);
  if (r == CUDA_SUCCESS) r = make_map(&P.k, k, D, B, P.Skv, P.Hkv);
  if (r == CUDA_SUCCESS) r = make_map(&P.v, v, D, B, P.Skv, P.Hkv);
  if (r == CUDA_SUCCESS) r = make_map(&P.dk, dk, D, B, P.Skv, P.Hkv);
  if (r == CUDA_SUCCESS) r = make_map(&P.dv, dv, D, B, P.Skv, P.Hkv);
  if (r != CUDA_SUCCESS) return kEncodeError + r;
  static int dq_in[kMaxDevices] = {}, dkdv_in[kMaxDevices] = {};
  constexpr int DQ_BYTES = DqSmem<D>::BYTES, KV_BYTES = DkdvSmem<D>::BYTES;
  constexpr int KV_ROWS = DkdvSmem<D>::ROWS;
  cudaError_t err;
  if ((err = opt_in(fa_bwd_dq_wgmma<D, CAP>, DQ_BYTES, dq_in)) != cudaSuccess) return (int)err;
  if ((err = opt_in(fa_bwd_dkdv_wgmma<D, CAP>, KV_BYTES, dkdv_in)) != cudaSuccess) return (int)err;
  fa_bwd_dq_wgmma<D, CAP>
      <<<dim3(B * P.Hq, (P.S + DQ_ROWS - 1) / DQ_ROWS), kThreads, DQ_BYTES, st>>>(P);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fa_bwd_dkdv_wgmma<D, CAP>
      <<<dim3(B * P.Hkv, (P.Skv + KV_ROWS - 1) / KV_ROWS), kThreads, KV_BYTES, st>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared bytes a CTA of launch 0 (dQ) or 1 (dK/dV) takes at head dim D
// (kernel.bwd_wgmma_plan computes the same); -1 for what the engine does
// not take.
long long fa_bwd_wgmma_smem_bytes(int D, int launch) {
  if (D == 64) return launch == 0 ? DqSmem<64>::BYTES : launch == 1 ? DkdvSmem<64>::BYTES : -1;
  if (D == 80) return launch == 0 ? DqSmem<80>::BYTES : launch == 1 ? DkdvSmem<80>::BYTES : -1;
  if (D == 128) return launch == 0 ? DqSmem<128>::BYTES : launch == 1 ? DkdvSmem<128>::BYTES : -1;
  if (D == 256) return launch == 0 ? DqSmem<256>::BYTES : launch == 1 ? DkdvSmem<256>::BYTES : -1;
  return -1;
}

// q, o, dout, dq (B, S, Hq, D) and k, v, dk, dv (B, Skv, Hkv, D) bf16, D 64,
// 80, 128 or 256; lse (B, Hq, S) f32, the forward's; delta (B, Hq, S) f32 scratch;
// all contiguous, every base a 16-byte multiple. window <= 0: none; softcap
// <= 0: none; q_offset >= 0: the position of q's first row. Two launches on
// `stream`, dQ (which writes Delta) then dK/dV. Returns a cudaError_t, or
// 100000 + a CUresult where a tensor map could not be encoded.
int fa_backward_wgmma(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* delta, void* dq, void* dk,
                      void* dv, int B, int S, int Skv, int Hq, int Hkv, int D, int causal,
                      int window, float softcap, float scale, int qoff, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || qoff < 0)
    return (int)cudaErrorInvalidValue;
  Params P = {};
  P.o = static_cast<const bf16*>(o);
  P.dout_rows = static_cast<const bf16*>(dout);
  P.lse = static_cast<const float*>(lse);
  P.delta = static_cast<float*>(delta);
  P.S = S, P.Skv = Skv, P.Hq = Hq, P.Hkv = Hkv, P.causal = causal, P.window = window;
  P.qoff = qoff, P.softcap = softcap, P.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
  if (D == 64 && cap) return launch<64, true>(P, q, k, v, dout, dq, dk, dv, B, st);
  if (D == 64) return launch<64, false>(P, q, k, v, dout, dq, dk, dv, B, st);
  if (D == 80 && cap) return launch<80, true>(P, q, k, v, dout, dq, dk, dv, B, st);
  if (D == 80) return launch<80, false>(P, q, k, v, dout, dq, dk, dv, B, st);
  if (D == 128 && cap) return launch<128, true>(P, q, k, v, dout, dq, dk, dv, B, st);
  if (D == 128) return launch<128, false>(P, q, k, v, dout, dq, dk, dv, B, st);
  if (D == 256 && cap) return launch<256, true>(P, q, k, v, dout, dq, dk, dv, B, st);
  if (D == 256) return launch<256, false>(P, q, k, v, dout, dq, dk, dv, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
