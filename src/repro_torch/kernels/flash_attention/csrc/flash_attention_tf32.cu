// Flash attention forward at head dims 64, 80 and 128 on Hopper, f32 as
// 3xTF32, on wgmma fed by TMA. It computes what flash_attention.cu computes
// for f32 (the reference's `_fa_kernel` of
// src/repro/kernels/flash_attention/kernel.py): FA2 online-softmax
// attention with GQA (q head h reads kv head h / (Hq / Hkv)), the causal,
// sliding-window and tanh-softcap masks, f32 running max, sum and
// accumulator, output acc / max(l, 1e-30); masked keys score -1e30, keys
// past Skv (or past their step's end) weigh 0, and a row that sees no key
// (a window with position >= Skv + window - 1) averages v over all Skv
// keys. Row i sits at position q_offset + i; the keys' positions start at
// 0. With `lse`, each row's natural-log log-sum-exp goes to lse[(b Hq + h) S
// + i] (-inf for a row that sees no key), what both backward engines read.
// flash_attention.cu keeps f32 at the other head dims and bases TMA cannot
// address, flash_attention_wgmma.cu bf16 (kernel.fwd_engine chooses).
//
// What bounds it on an H100 SXM: operations. At qwen3-0.6b's f32 shape
// (B2 S256, 16 q / 8 kv heads of 128, causal) the mask keeps 1.05 M pairs
// a head, 1.08 GFLOP of QK^T and PV; 3xTF32 runs each product three times
// on the tensor cores, 0.0065 ms at the 495 TFLOP/s TF32 peak (0.016 ms at
// f32's 67 TFLOP/s outside them), against 3.1 MB moved. The reference's f32
// 2e-5 rules out plain TF32 (about 1e-3 off), not 3xTF32: a b = a_hi b_hi +
// a_lo b_hi + a_hi b_lo, hi the top 19 bits of the f32 word (how the tensor
// cores read an f32 word given as tf32) and lo = x - hi exactly.
//
// Layout and loads. q and k are read in the model layout, (B, S, H, D),
// through 4-D tensor maps over (D, heads, rows, B) whose boxes are 32
// columns (128 bytes of f32, 128-byte swizzle) by 64 q rows or BN keys of
// one head; D 80 takes three boxes a row, TMA filling columns 80-95 with
// zeros. tf32 wgmma reads B only K-major, and O = P V has V as B along its
// keys, so v is first copied transposed into (B Hkv, D, Skv rounded up to 4)
// by a small kernel (a pass over v, the one extra launch); its boxes are 32
// keys by D rows. A CTA is one consumer warpgroup (64 q rows) and one
// warpgroup that loads and splits: warp 4's first thread starts the TMA
// loads, warps 5-7 make the lo tiles.
//
// Products. S = Q K^T: both operands from shared memory, K-major as they
// lie (m64nBNk8), three products a k step: Q_lo K, Q K_lo, Q K. Q's lo and
// each K tile's lo are tiles of their own, made by the splitter warps from
// the landed tiles (the split is elementwise, so the swizzle carries over);
// a landed tile serves as its own hi. P V: P from registers, split there
// into hi and lo, and V^T's tile and its lo through descriptors (m64nDk8),
// three products a k step. The accumulator's fragment holds keys 2t and 2t
// + 1 of each group of 8 where tf32's A fragment holds k positions t and t +
// 4, so the splitter warps permute each landed V^T tile in place, 8 keys at
// a time, to the order the fragment reads (k position j holds key 2j, and
// j + 4 holds 2j + 1); no shuffle is spent on P. Each tile's P V goes into
// `part` (scale_d 0 first) and is added into O in IEEE f32 beside the
// rescale: wgmma's own accumulation over a long K drifts from float64
// (fused_moe_bwd_tf32.cu's finding).
//
// Shared memory: Q and its lo, a two-stage ring of K, K's lo, V^T and V^T's
// lo: 160 KB at D 64 (tiles of 64 keys), 136 KB at D 80 and 192 KB at D 128
// (tiles of 32 keys), each with full, split and empty mbarriers. f32 tiles
// are twice bf16's and every operand carries a lo tile, so one consumer
// warpgroup's 64 rows is what fits beside a ring at D 128.
//
// Knobs and walk: those of flash_attention_wgmma.cu. The CUDA grid is (B
// Hq, ceil(S / bq)), the q block whose rows see the most causal keys first;
// a CTA walks its bq rows 64 at a time (rows past its block are computed and
// not stored), and each sub-block its steps of bk keys, each cut into tiles
// of BN keys from the step's first key; tiles that the masks remove for
// every row are never loaded, and only tiles on a mask edge test positions.
// A step's products and its softmax run one after the other: each wgmma
// group is waited for before the registers it writes are read, on every
// path, so ptxas never serializes them.
//
// Determinism: no atomics, one fixed walk; reruns are bit-equal.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;   // warpgroup 0 computes; warp 4 loads, warps 5-7 split
constexpr int kSplitters = 96;  // the threads of warps 5-7
constexpr int ROWS = 64;        // q rows of a sub-block: the consumer warpgroup's
constexpr int STAGES = 2;       // the K/V^T ring
constexpr float MASKED = -1.0e30f;  // the reference's value for a masked score
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Geometry at head dim D: keys of a tile; boxes of 32 columns a row; box and
// tile bytes; the shared memory from the 1024-aligned base: Q, Q's lo, the
// K, K lo, V^T and V^T lo slots, the barriers (Q full, split, empty; K full,
// split, empty a stage; V the same)
template <int D>
struct Geo {
  static constexpr int BN = D == 64 ? 64 : 32;
  static constexpr int NB = (D + 31) / 32;
  static constexpr int QBOX = ROWS * 128, KBOX = BN * 128, VBOX = D * 128;
  static constexpr int Q_BYTES = NB * QBOX, K_BYTES = NB * KBOX, V_BYTES = (BN / 32) * VBOX;
  static constexpr int Q = 0, QL = Q + Q_BYTES, K = QL + Q_BYTES, KL = K + STAGES * K_BYTES;
  static constexpr int V = KL + STAGES * K_BYTES, VL = V + STAGES * V_BYTES;
  static constexpr int BAR = VL + STAGES * V_BYTES;
  static constexpr int BYTES = 1024 + BAR + 8 * (3 + 6 * STAGES);
};

struct Params {
  CUtensorMap q, k;  // (D, heads, rows, B): boxes of 32 columns x 64 q rows / BN keys
  CUtensorMap vt;    // (Skv, D, B Hkv), rows ld apart: boxes of 32 keys x D rows
  float* o;          // (B, S, Hq, D)
  float* lse;        // null, or (B, Hq, S)
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
// of it sees (all of them where a row sees none); flash_attention_wgmma.cu's
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

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}

// ------------------------------------------------------------ splits

// A landed V^T tile (boxes of 32 keys x D rows, 128-byte swizzled: 16-byte
// chunk c of row d at (c ^ (d % 8)) * 16), its keys permuted in place within
// each group of 8 to the order P's A fragment reads them (k position j holds
// key 2j, j + 4 holds key 2j + 1), and its lo into dst likewise
template <int D, int BN>
__device__ __forceinline__ void split_vt(uint32_t src, uint32_t dst, int tid) {
  for (int w = tid; w < (BN / 32) * D * 4; w += kSplitters) {
    const int g = w % 4, d = (w / 4) % D, box = w / (4 * D);
    const uint32_t row = box * D * 128 + d * 128;
    const uint32_t a0 = row + (((2 * g) ^ (d % 8)) * 16), a1 = row + (((2 * g + 1) ^ (d % 8)) * 16);
    const uint4 x = ld_shared_v4(src + a0), y = ld_shared_v4(src + a1);
    const uint4 even = make_uint4(x.x, x.z, y.x, y.z), odd = make_uint4(x.y, x.w, y.y, y.w);
    st_shared_v4(src + a0, even);
    st_shared_v4(src + a1, odd);
    st_shared_v4(dst + a0, tf32_lo(even));
    st_shared_v4(dst + a1, tf32_lo(odd));
  }
}

// ------------------------------------------------------------ products

// the K-major descriptor of 8 columns (k step kk) of a tile of 32-column
// boxes of `box` bytes at `tile`
__device__ __forceinline__ uint64_t kstep(uint32_t tile, int kk, int box) {
  return wgmma_desc(tile + (kk / 4) * box + (kk % 4) * 32, 16, 1024);
}

// s = Q K^T: 64 rows x BN keys, 3xTF32
template <int D>
__device__ __forceinline__ void qk(float (&s)[Geo<D>::BN / 2], uint32_t q, uint32_t ql,
                                   uint32_t k, uint32_t kl) {
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint64_t qh = kstep(q, kk, G::QBOX), qlo = kstep(ql, kk, G::QBOX);
    const uint64_t kh = kstep(k, kk, G::KBOX), klo = kstep(kl, kk, G::KBOX);
    wgmma_tf32_ss<G::BN>(s, qlo, kh, kk > 0 ? 1 : 0);
    wgmma_tf32_ss<G::BN>(s, qh, klo, 1);
    wgmma_tf32_ss<G::BN>(s, qh, kh, 1);
  }
}

// part = P V: P's hi and lo from registers (8 keys a k step, in split_vt's
// order), V^T and its lo through descriptors, 3xTF32
template <int D>
__device__ __forceinline__ void pv(float (&part)[D / 2], const uint32_t (&ph)[Geo<D>::BN / 8][4],
                                   const uint32_t (&pl)[Geo<D>::BN / 8][4], uint32_t v,
                                   uint32_t vl) {
  using G = Geo<D>;
#pragma unroll
  for (int j = 0; j < G::BN / 8; ++j) {
    const uint64_t vh = kstep(v, j, G::VBOX), vlo = kstep(vl, j, G::VBOX);
    wgmma_tf32<D>(part, pl[j], vh, j > 0 ? 1 : 0);
    wgmma_tf32<D>(part, ph[j], vlo, 1);
    wgmma_tf32<D>(part, ph[j], vh, 1);
  }
}

// ------------------------------------------------------------ the kernel

template <int D>
__global__ void __launch_bounds__(kThreads, 1) fa_fwd_tf32(const __grid_constant__ Params P) {
  using G = Geo<D>;
  constexpr int BN = G::BN, NS = BN / 2, NO = D / 2, KQ = BN / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + G::Q, sQL = base + G::QL, sK = base + G::K, sKL = base + G::KL;
  const uint32_t sV = base + G::V, sVL = base + G::VL;
  const uint32_t qfull = base + G::BAR, qsplit = qfull + 8, qempty = qsplit + 8;
  const uint32_t kfull = qempty + 8, ksplit = kfull + 8 * STAGES, kempty = ksplit + 8 * STAGES;
  const uint32_t vfull = kempty + 8 * STAGES, vsplit = vfull + 8 * STAGES;
  const uint32_t vempty = vsplit + 8 * STAGES;
  const int b = blockIdx.x / P.Hq, h = blockIdx.x % P.Hq, hk = h / (P.Hq / P.Hkv);
  const int r_begin = heavy_first(blockIdx.y, gridDim.y, P.bq, P.S) * P.bq;
  const int r_end = min(r_begin + P.bq, P.S);  // the rows this CTA owns
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1), mbar_init(qsplit, kSplitters), mbar_init(qempty, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kfull + 8 * s, 1), mbar_init(ksplit + 8 * s, kSplitters);
      mbar_init(kempty + 8 * s, 1);
      mbar_init(vfull + 8 * s, 1), mbar_init(vsplit + 8 * s, kSplitters);
      mbar_init(vempty + 8 * s, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 4) {
    // ------------------------------------------ producer and splitters
    const bool producer = warp == 4;
    if (producer && lane != 0) return;
    const int tid = threadIdx.x - 160;  // a splitter's index
    int stage = 0, sub = 0;
    uint32_t ph = 0;
    for (int r0 = r_begin; r0 < r_end; r0 += ROWS, ++sub) {
      const int r1 = min(r0 + ROWS, r_end) - 1;
      if (producer) {
        if (sub > 0) mbar_wait(qempty, (sub - 1) & 1);
        mbar_arrive_expect_tx(qfull, G::Q_BYTES);
        for (int c = 0; c < G::NB; ++c)
          tma_load_4d(sQ + c * G::QBOX, &P.q, qfull, 32 * c, h, r0, b);
      } else {
        mbar_wait(qfull, sub & 1);
        split_lo(sQ, sQL, G::Q_BYTES, tid, kSplitters);
        fence_proxy_async();  // the lo tile, visible to the wgmmas that read it
        mbar_arrive(qsplit);
      }
      for (Walk<BN> walk(r0 + P.qoff, r1 + P.qoff, P.Skv, P.causal, P.window, P.bk);
           !walk.done(); walk.next()) {
        const uint32_t k = sK + stage * G::K_BYTES, v = sV + stage * G::V_BYTES;
        if (producer) {
          const int k0 = walk.key0();
          mbar_wait(kempty + 8 * stage, ph ^ 1);
          mbar_arrive_expect_tx(kfull + 8 * stage, G::K_BYTES);
          for (int c = 0; c < G::NB; ++c)
            tma_load_4d(k + c * G::KBOX, &P.k, kfull + 8 * stage, 32 * c, hk, k0, b);
          mbar_wait(vempty + 8 * stage, ph ^ 1);
          mbar_arrive_expect_tx(vfull + 8 * stage, G::V_BYTES);
          for (int c = 0; c < BN / 32; ++c)
            tma_load_3d(v + c * G::VBOX, &P.vt, vfull + 8 * stage, k0 + 32 * c, 0,
                        b * P.Hkv + hk);
        } else {
          mbar_wait(kfull + 8 * stage, ph);
          split_lo(k, sKL + stage * G::K_BYTES, G::K_BYTES, tid, kSplitters);
          fence_proxy_async();
          mbar_arrive(ksplit + 8 * stage);
          mbar_wait(vfull + 8 * stage, ph);
          split_vt<D, BN>(v, sVL + stage * G::V_BYTES, tid);
          fence_proxy_async();
          mbar_arrive(vsplit + 8 * stage);
        }
        if (++stage == STAGES) stage = 0, ph ^= 1;
      }
    }
    return;
  }

  // -------------------------------------------------- the consumer
  const bool elected = threadIdx.x == 0;  // releases a slot once its products are done
  // the score's constants: no softcap, x = s mul0; with one, the tanh's
  // e^2y = 2^(s mul0) and x = cap2 tanh
  const bool capped = P.softcap > 0.f;
  const float mul0 = capped ? 2.f * LOG2E * P.scale / P.softcap : P.scale * LOG2E;
  const float cap2 = P.softcap * LOG2E;
  const size_t rstride = (size_t)P.Hq * D;
  float part[NO];  // one tile's P V
#pragma unroll
  for (int i = 0; i < NO; ++i) part[i] = 0.f;

  int stage = 0, sub = 0;
  uint32_t ph = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += ROWS, ++sub) {
    const int r1 = min(r0 + ROWS, r_end) - 1;
    const int w0 = r0 + 16 * warp;  // this warp's rows w0 .. w0 + 15
    const int wp0 = w0 + P.qoff;    // the position of row w0
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    // this thread's rows w0 + lane / 4 + 8 i: running max (log2 units) and
    // its part of the row sum
    float m[2] = {MASKED * LOG2E, MASKED * LOG2E}, l[2] = {0.f, 0.f};
    mbar_wait(qfull, sub & 1);
    mbar_wait(qsplit, sub & 1);
    for (Walk<BN> walk(r0 + P.qoff, r1 + P.qoff, P.Skv, P.causal, P.window, P.bk);
         !walk.done(); walk.next()) {
      const int k0 = walk.key0(), e = walk.step_end();
      float s[NS];
      mbar_wait(kfull + 8 * stage, ph);
      mbar_wait(ksplit + 8 * stage, ph);
      wgmma_fence();
      qk<D>(s, sQ, sQL, sK + stage * G::K_BYTES, sKL + stage * G::K_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(s);
      if (elected) mbar_arrive(kempty + 8 * stage);

      // scores in log2 units, as flash_attention_wgmma.cu forms them: a warp
      // whose 16 rows see all BN keys of the tile skips the position tests
      // (and, without a softcap, keeps the raw products: mul folds the scale
      // into the exponent's FFMA); a tile whose only edge is its step's end
      // tests that alone
      const bool seen = tile_inside(wp0, wp0 + 15, k0, k0 + BN - 1, P.causal, P.window);
      const bool inside = k0 + BN <= e && seen;
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
      float mx[2] = {-INFINITY, -INFINITY}, corr[2];
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
      // P's A fragments of 8 keys each, split: the accumulator's (row, key
      // 2t), (row + 8, 2t), (row, 2t + 1), (row + 8, 2t + 1) of each group of
      // 8 keys are k positions t, t, t + 4, t + 4 of the fragment's rows
      uint32_t phi[KQ][4], plo[KQ][4];
#pragma unroll
      for (int j = 0; j < KQ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = s[4 * j + (i % 2) * 2 + i / 2];
          phi[j][i] = __float_as_uint(x) & kTf32Hi;
          plo[j][i] = __float_as_uint(x - __uint_as_float(phi[j][i]));
          fence_operand(phi[j][i]);
          fence_operand(plo[j][i]);
        }
      mbar_wait(vfull + 8 * stage, ph);
      mbar_wait(vsplit + 8 * stage, ph);
      fence_all(part);
      wgmma_fence();
      pv<D>(part, phi, plo, sV + stage * G::V_BYTES, sVL + stage * G::V_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(part);
      if (elected) mbar_arrive(vempty + 8 * stage);
      // O to this tile's max, plus this tile's P V, in IEEE f32
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] = fmaf(o[i], corr[(i / 2) % 2], part[i]);
      if (++stage == STAGES) stage = 0, ph ^= 1;
    }
    if (elected) mbar_arrive(qempty);  // every product that reads Q is done

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
    // two columns a lane: four lanes of a row write 32 contiguous bytes
    float* ob = P.o + ((size_t)b * P.S * P.Hq + h) * D;
#pragma unroll
    for (int jn = 0; jn < NO / 4; ++jn)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = w0 + lane / 4 + 8 * i, c = 8 * jn + 2 * (lane % 4);
        if (r < r_end)
          *reinterpret_cast<float2*>(ob + (size_t)r * rstride + c) =
              make_float2(o[4 * jn + 2 * i] * inv[i], o[4 * jn + 2 * i + 1] * inv[i]);
      }
  }
}

// v (B, Skv, Hkv, D) into vt (B Hkv, D, ld), ld = Skv rounded up to 4, the
// pad keys zeroed: 32 x 32 tiles through shared memory
__global__ void __launch_bounds__(256) transpose_v(const float* __restrict__ v,
                                                   float* __restrict__ vt, int Skv, int Hkv, int D,
                                                   int ld) {
  __shared__ float tile[32][33];
  const int bh = blockIdx.z, b = bh / Hkv, hk = bh % Hkv;
  const int k0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int key = k0 + i, d = d0 + threadIdx.x;
    tile[i][threadIdx.x] =
        key < Skv && d < D ? v[(((size_t)b * Skv + key) * Hkv + hk) * D + d] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int d = d0 + i, key = k0 + threadIdx.x;
    if (d < D && key < ld) vt[((size_t)bh * D + d) * ld + key] = tile[threadIdx.x][i];
  }
}

// ---------------------------------------------------------------- host side

template <int D>
int launch(Params& P, const void* q, const void* k, const void* v, float* vt, int B,
           cudaStream_t st) {
  using G = Geo<D>;
  const int ld = (P.Skv + 3) / 4 * 4;
  int r = encode_f32_heads(&P.q, q, D, B, P.S, P.Hq, ROWS);
  if (r == CUDA_SUCCESS) r = encode_f32_heads(&P.k, k, D, B, P.Skv, P.Hkv, G::BN);
  if (r == CUDA_SUCCESS) r = encode_f32_3d(&P.vt, vt, P.Skv, D, (uint64_t)B * P.Hkv, ld, 32, D);
  if (r != CUDA_SUCCESS) return kEncodeError + r;
  static int configured[kMaxDevices] = {};
  cudaError_t err = opt_in(fa_fwd_tf32<D>, G::BYTES, configured);
  if (err != cudaSuccess) return (int)err;
  transpose_v<<<dim3((ld + 31) / 32, (D + 31) / 32, B * P.Hkv), dim3(32, 8), 0, st>>>(
      static_cast<const float*>(v), vt, P.Skv, P.Hkv, D, ld);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fa_fwd_tf32<D><<<dim3(B * P.Hq, (P.S + P.bq - 1) / P.bq), kThreads, G::BYTES, st>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared bytes a CTA takes at head dim D (kernel.fwd_tf32_plan computes the
// same); -1 for a head dim the engine does not take.
long long fa_fwd_tf32_smem_bytes(int D) {
  return D == 64 ? Geo<64>::BYTES : D == 80 ? Geo<80>::BYTES : D == 128 ? Geo<128>::BYTES : -1;
}

// q, o (B, S, Hq, D) and k, v (B, Skv, Hkv, D) f32, contiguous, every base a
// 16-byte multiple, D 64, 80 or 128; vt: a workspace of (B Hkv, D, ld) f32,
// ld = Skv rounded up to 4, 16-byte aligned; lse: null, or (B, Hq, S) f32.
// window <= 0: none; softcap <= 0: none; bq, bk: q rows a CTA owns and keys
// a step takes (already clamped to S and Skv); q_offset >= 0: the position
// of q's first row. Two launches on `stream` (v's transposed copy, the
// attention). Returns a cudaError_t, or 100000 + a CUresult where a tensor
// map could not be encoded.
int fa_forward_tf32(const void* q, const void* k, const void* v, void* vt, void* o, void* lse,
                    int B, int S, int Skv, int Hq, int Hkv, int D, int causal, int window,
                    float softcap, float scale, int bq, int bk, int qoff, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || bq <= 0 || bk <= 0 ||
      bq > S || bk > Skv || qoff < 0)
    return (int)cudaErrorInvalidValue;
  Params P = {};
  P.o = static_cast<float*>(o);
  P.lse = static_cast<float*>(lse);
  P.S = S, P.Skv = Skv, P.Hq = Hq, P.Hkv = Hkv, P.bq = bq, P.bk = bk;
  P.causal = causal, P.window = window, P.qoff = qoff, P.softcap = softcap, P.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* t = static_cast<float*>(vt);
  if (D == 64) return launch<64>(P, q, k, v, t, B, st);
  if (D == 80) return launch<80>(P, q, k, v, t, B, st);
  if (D == 128) return launch<128>(P, q, k, v, t, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
