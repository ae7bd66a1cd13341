// Flash attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// The reference has no backward kernel: it trains through the plain
// chunked attention, which XLA differentiates. The port sends training
// through its forward kernel (flash_attention.cu), so this is that
// kernel's backward, the FA2 recipe: with Delta = rowsum(dO * O) and the
// forward's per-row log-sum-exp, P = exp(S - lse) is recomputed tile by
// tile, never stored whole; dV = P^T dO, dP = dO V^T, dS = P * (dP - Delta),
// dK = dS^T Q * scale, dQ = dS K * scale. Under a softcap c the score is
// s' = c tanh(s / c), so dS also takes the factor 1 - tanh^2(s / c).
// Causal and window masks are the forward's: a masked pair has P = 0 and
// dS = 0. A row that sees no key (a window with S >= Skv + window) gets
// the plain version's output, the mean of v over every key, so there
// P = 1 / Skv, dS = 0, and its dQ is 0. As in the forward, row i sits at
// position q_offset + i (a rank's block of the query rows) for every mask,
// tile skip and walk; its index still addresses q, o, dO, lse and Delta.
//
// Layout as the forward: q, o, dO, dQ are (B, S, Hq, D), k, v, dK, dV
// (B, Skv, Hkv, D), contiguous; lse and Delta are (B, Hq, S) f32.
//
// Determinism: no float atomics. Two kernels own the two sums:
//   dK and dV: a CTA owns a block of keys of one kv head and walks the G q
//     heads of its group and their q tiles in order, so GQA's sum over the
//     group runs in registers in a fixed order;
//   dQ: a CTA owns a block of q rows of one head and walks the key tiles.
// Scores and dP are computed in both (seven tile products where an atomic
// design does five); that is the price of a fixed sum order.
//
// What bounds it on an H100 SXM. At qwen3-0.6b's training shape (B=4,
// S=2048, 16/8 heads of 128, causal) the causal mask keeps 134.3 M
// (query, key) pairs; the five products a backward needs are 172 GFLOP
// against 202 MB moved, so operations bound it, and only the tensor cores
// come near that bound.
//
// bf16 path (training's): mma.sync m16n8k16 with f32 accumulation, operands
// brought in by ldmatrix, two launches (dQ first):
//   dQ: a CTA of W warps owns 16 W q rows, 16 a warp, and keeps their dQ rows
//     in registers. Per step of TK keys: S = Q K^T and dP = dO V^T (the two
//     products interleaved), dS in registers, rounded to bf16 A fragments,
//     dQ += dS K. Its prologue also computes Delta = rowsum(dO O) for its
//     rows with 16-byte loads, while its first copies are in flight, and
//     stores it for the dK/dV kernel: no launch of its own.
//   dK/dV: a CTA of W warps owns 16 W keys, 16 a warp, and keeps their dK and
//     dV rows in registers; per step of TQ q rows, S^T = K Q^T and dP^T =
//     V dO^T (keys x queries) become P^T and dS^T in registers and, rounded
//     to bf16 A fragments (the C-to-A fragment identity the forward uses for
//     P), feed dV += P^T dO and dK += dS^T Q, whose B operands come by
//     transposing ldmatrix.
//   Both stream their tiles (q, dO, lse and Delta; k and v) through a ring
//   of ST shared-memory stages filled by cp.async, so step i + ST - 1 loads
//   while step i computes; one barrier a step. The softmax scale multiplies
//   the sums once, at the end, not every dS. A warp whose 16 rows or keys
//   the masks remove from a tile skips its products, and a tile whose pairs
//   are all visible skips the position tests (P = 2^(s scale log2 e - lse
//   log2 e), one FFMA and one ex2). Both grids launch their heaviest causal
//   blocks first: dK/dV's key block 0, which every row sees, and dQ's last
//   q block, which sees every key, so the causal tail is short.
//   Sizes (kernel.bwd_launch_plan; ptxas's counts are logged by
//   chip_smoke.py): TQ = TK = 64, ST = 2, W = 4. The accumulators take
//   most of the 255 registers a thread may hold (at head dim 128: dK and dV
//   128, S^T and dP^T 64), so an SM runs 8 warps whatever the split; two
//   CTAs of 4 warps an SM measured faster than one of 8 on the H100, since
//   one CTA's barriers and prologue overlap the other's products. At head
//   dim 128 the dK/dV instance spills a few bytes; the spill-free TQ = 32
//   measured slower. Rows are padded by 16 bytes in shared memory
//   (conflict-free ldmatrix); head dims below 16 are zero-padded to 16.
//
// f32 path (the f32 model): the reference's 2e-5 rules out bf16 and TF32
// products, so every product is an IEEE f32 FMA, the forward's f32 design:
// 256 threads, each a 4 x 4 patch of the 64 x 64 score tile, tiles
// transposed in shared memory as f32 and read as float4; a Delta kernel,
// then dK/dV, then dQ, one stage.
//
// Head dim 256 (gemma2-2b). Registers are the constraint: a warp's 16 rows
// of dK and dV over all 256 columns would take 256 registers a thread
// before S and dP. Of the two ways to split the head dim, the FA2 split
// across a CTA's warps (P and dS passed through shared memory) and two CTAs
// a block each owning one 128-wide half of the outputs, this takes the
// second, for both kernels: grid z picks the half, and each CTA computes S
// = Q K^T and dP = dO V^T over all 256 columns from shared memory (twice
// the score products of one CTA, against no new exchange through shared
// memory and the same per-warp code as head dim 128: dK/dV holds 128
// accumulator registers, as at 128, and dQ 64). The tiles are the other
// head dims' (64 q rows or keys a step, a two-stage ring, 4 warps), whose
// 204 KB of shared memory at 256 leave one CTA an SM. The f32 kernels keep
// their whole-head-dim accumulators (4 rows x 16 columns of each of dK and
// dV a thread: 128 registers) but hold 128 of the 256 columns of each
// shared tile at a time: S and dP sum over the two halves, and the sums
// into dK, dV and dQ take each half in turn.
//
// Head dims 8, 16, 32, 64, 80, 128 and 256; other head dims are refused by
// the wrapper.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BB = 64;      // q rows and keys of a tile
constexpr int BS = BB + 4;  // row stride of the transposed tiles, P and dS (float4-aligned)
constexpr int NTH = 256;    // threads: 16 (tx) x 16 (ty)
constexpr int kMaxDevices = 64;

// The q block a dQ CTA takes at launch position y of n blocks of `rows`:
// the last block, whose rows see the most keys under a causal mask, first;
// a ragged last block, lighter than the full one before it, last. A query
// offset moves every row alike, so the order stays.
__device__ __forceinline__ int heavy_first(int y, int n, int rows, int S) {
  if (S % rows != 0) return y == n - 1 ? n - 1 : n - 2 - y;
  return n - 1 - y;
}

// A row that sees no key at all; the plain version averages v over every key.
__device__ __forceinline__ bool no_key(int qi, int Skv, int window) {
  return window > 0 && qi >= Skv + window - 1;
}
__device__ __forceinline__ bool visible(int qi, int kj, int Skv, int causal, int window) {
  return kj < Skv && (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
}
// False only if no (query, key) pair of rows [q0, q1] x keys [k0, k1] is visible.
__device__ __forceinline__ bool tile_sees(int q0, int q1, int k0, int k1, int causal, int window) {
  return (!causal || k0 <= q1) && (window <= 0 || k1 > q0 - window);
}

// Rows [r0, r0 + BB) of a (rows, D) slice with row stride `stride`, as f32
// into dst[d * BS + r]; rows at or past `limit` are zero.
template <int D>
__device__ __forceinline__ void load_t(float* dst, const float* src, size_t stride, int r0,
                                       int limit) {
  for (int i = threadIdx.x; i < BB * D; i += NTH) {
    const int r = i / D, d = i % D;
    dst[d * BS + r] = (r0 + r < limit) ? src[(size_t)(r0 + r) * stride + d] : 0.f;
  }
}

// P and dS of one pair from its raw product s = q . k and dp = dO . v; dS
// carries the factor ds_scale (the scale, or 1 where the caller applies it
// to the sum)
struct Grad {
  float p, ds;
};
__device__ __forceinline__ Grad pair_grad(float s, float dp, int qi, int kj, int S, int Skv,
                                          int causal, int window, float softcap, float scale,
                                          float lse, float delta, float ds_scale, int qoff) {
  Grad g = {0.f, 0.f};
  if (qi >= S || kj >= Skv) return g;
  if (no_key(qi + qoff, Skv, window)) {
    g.p = 1.f / (float)Skv;
    return g;
  }
  if (!visible(qi + qoff, kj, Skv, causal, window)) return g;
  float x = s * scale, dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    x = softcap * t;
    dcap = 1.f - t * t;
  }
  g.p = expf(x - lse);
  g.ds = g.p * (dp - delta) * dcap * ds_scale;
  return g;
}

// ---------------------------------------------------------------- Delta

// Delta of the f32 path, one warp a row (the bf16 path computes it in dQ)
__global__ void __launch_bounds__(NTH) fa_bwd_delta_kernel(const float* __restrict__ o,
                                                           const float* __restrict__ dout,
                                                           float* __restrict__ delta, int rows,
                                                           int S, int Hq, int D) {
  const int row = blockIdx.x * (NTH / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;  // a row of (B, S, Hq)
  const float* op = o + (size_t)row * D;
  const float* dp = dout + (size_t)row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(op[d], dp[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % Hq, s = (row / Hq) % S, b = row / (Hq * S);
    delta[((size_t)b * Hq + h) * S + s] = acc;
  }
}

// ---------------------------------------------------------------- dK, dV

// The f32 kernels hold DC columns of each head-dim tile in shared memory at
// a time: the whole head dim up to 128; at 256, 128 (four 256-column tiles
// would take 279 KB). There S and dP are summed over the two halves, and
// the sums into dK, dV or dQ take each half in turn.
template <int D>
struct F32Chunks {
  static constexpr int DC = D > 128 ? 128 : D, N = D / DC;
  static constexpr size_t dkdv = sizeof(float) * (4 * DC * BS + 2 * BB * BS + 2 * BB);
  static constexpr size_t dq = sizeof(float) * (4 * DC * BS + BB * BS + 2 * BB);
};

// acc[r][c] += sum_d a[d][ty*4 + r] * b[d][tx*4 + c] over two transposed tiles
template <int D>
__device__ __forceinline__ void tile_dot_add(float (&acc)[4][4], const float* aT, const float* bT,
                                             int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(&aT[d * BS + ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&bT[d * BS + tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero44(float (&a)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[r][c] = 0.f;
}

template <int D>
__global__ void __launch_bounds__(NTH) fa_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int S,
    int Skv, int Hq, int Hkv, int causal, int window, float softcap, float scale, int qoff) {
  constexpr int DC = F32Chunks<D>::DC, NCH = F32Chunks<D>::N;
  extern __shared__ __align__(16) float smem[];
  float* kT = smem;             // [DC][BS]
  float* vT = kT + DC * BS;     // [DC][BS]
  float* qT = vT + DC * BS;     // [DC][BS]
  float* doT = qT + DC * BS;    // [DC][BS]
  float* pS = doT + DC * BS;    // [BB][BS]: P, a row per query
  float* dS = pS + BB * BS;     // [BB][BS]: dS, a row per query
  float* rowL = dS + BB * BS;   // [BB]: lse of the tile's rows
  float* rowD = rowL + BB;      // [BB]: Delta of the tile's rows

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, G = Hq / Hkv;
  const int k0 = blockIdx.y * BB, k1 = min(k0 + BB, Skv) - 1;
  const size_t q_step = (size_t)Hq * D, kv_step = (size_t)Hkv * D;
  constexpr int DPT = (D + 15) / 16;  // columns of a thread: tx + 16 c
  constexpr int CPC = DC / 16;        // of them in one chunk (D > 128 only)
  const bool any_no_key = window > 0 && S + qoff >= Skv + window;
  const float* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const float* vb = v + ((size_t)b * Skv * Hkv + hk) * D;

  if (NCH == 1) {
    load_t<DC>(kT, kb, kv_step, k0, Skv);
    load_t<DC>(vT, vb, kv_step, k0, Skv);
  }
  float adk[4][DPT], adv[4][DPT];  // keys ty*4 + r
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DPT; ++c) adk[r][c] = adv[r][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* qb = q + ((size_t)b * S * Hq + h) * D;
    const float* ob = dout + ((size_t)b * S * Hq + h) * D;
    const float* lb = lse + ((size_t)b * Hq + h) * S;
    const float* db = delta + ((size_t)b * Hq + h) * S;
    for (int q0 = 0; q0 < S; q0 += BB) {
      const int q1 = min(q0 + BB, S) - 1;
      if (!tile_sees(q0 + qoff, q1 + qoff, k0, k1, causal, window) &&
          !(any_no_key && no_key(q1 + qoff, Skv, window)))
        continue;
      float s[4][4], dp[4][4];
      zero44(s);
      zero44(dp);
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        __syncthreads();  // the last readers of qT, doT (kT, vT), pS, dS are done
        load_t<DC>(qT, qb + ch * DC, q_step, q0, S);
        load_t<DC>(doT, ob + ch * DC, q_step, q0, S);
        if (NCH > 1) {
          load_t<DC>(kT, kb + ch * DC, kv_step, k0, Skv);
          load_t<DC>(vT, vb + ch * DC, kv_step, k0, Skv);
        }
        if (ch == 0 && tid < BB) {
          rowL[tid] = (q0 + tid < S) ? lb[q0 + tid] : 0.f;
          rowD[tid] = (q0 + tid < S) ? db[q0 + tid] : 0.f;
        }
        __syncthreads();
        tile_dot_add<DC>(s, qT, kT, ty, tx);
        tile_dot_add<DC>(dp, doT, vT, ty, tx);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = ty * 4 + r;
        float pv[4], dsv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const Grad gr = pair_grad(s[r][c], dp[r][c], q0 + row, k0 + tx * 4 + c, S, Skv, causal,
                                    window, softcap, scale, rowL[row], rowD[row], scale, qoff);
          pv[c] = gr.p;
          dsv[c] = gr.ds;
        }
        *reinterpret_cast<float4*>(&pS[row * BS + tx * 4]) =
            make_float4(pv[0], pv[1], pv[2], pv[3]);
        *reinterpret_cast<float4*>(&dS[row * BS + tx * 4]) =
            make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
      }

      // dV[key][d] += sum_q P[q][key] dO[q][d];  dK[key][d] += sum_q dS[q][key] Q[q][d],
      // the last chunk's columns first (its q and dO tiles are in place)
#pragma unroll
      for (int ch = NCH - 1; ch >= 0; --ch) {
        if (ch != NCH - 1) {
          __syncthreads();
          load_t<DC>(qT, qb + ch * DC, q_step, q0, S);
          load_t<DC>(doT, ob + ch * DC, q_step, q0, S);
        }
        __syncthreads();
#pragma unroll 4
        for (int qq = 0; qq < BB; ++qq) {
          const float4 p4 = *reinterpret_cast<const float4*>(&pS[qq * BS + ty * 4]);
          const float4 d4 = *reinterpret_cast<const float4*>(&dS[qq * BS + ty * 4]);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
          const float dsv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int c = 0; c < DPT; ++c) {
            const int col = tx + 16 * c;
            if ((NCH > 1 && c / CPC != ch) || (D % 16 != 0 && col >= D)) continue;
            const float o = doT[(col - ch * DC) * BS + qq], x = qT[(col - ch * DC) * BS + qq];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              adv[r][c] = fmaf(pv[r], o, adv[r][c]);
              adk[r][c] = fmaf(dsv[r], x, adk[r][c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + ty * 4 + r;
    if (kj >= Skv) continue;
    const size_t base = (((size_t)b * Skv + kj) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = tx + 16 * c;
      if (D % 16 == 0 || col < D) {
        dk[base + col] = adk[r][c];
        dv[base + col] = adv[r][c];
      }
    }
  }
}

// ---------------------------------------------------------------- dQ

template <int D>
__global__ void __launch_bounds__(NTH) fa_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int S, int Skv, int Hq, int Hkv,
    int causal, int window, float softcap, float scale, int qoff) {
  constexpr int DC = F32Chunks<D>::DC, NCH = F32Chunks<D>::N;
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;             // [DC][BS]
  float* doT = qT + DC * BS;    // [DC][BS]
  float* kT = doT + DC * BS;    // [DC][BS]
  float* vT = kT + DC * BS;     // [DC][BS]
  float* dsT = vT + DC * BS;    // [BB][BS]: dS, a row per key
  float* rowL = dsT + BB * BS;  // [BB]
  float* rowD = rowL + BB;      // [BB]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / (Hq / Hkv);
  const int q0 = heavy_first(blockIdx.y, gridDim.y, BB, S) * BB, q1 = min(q0 + BB, S) - 1;
  const size_t q_step = (size_t)Hq * D, kv_step = (size_t)Hkv * D;
  constexpr int DPT = (D + 15) / 16;
  constexpr int CPC = DC / 16;
  const float* qb = q + ((size_t)b * S * Hq + h) * D;
  const float* ob = dout + ((size_t)b * S * Hq + h) * D;
  const float* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const float* vb = v + ((size_t)b * Skv * Hkv + hk) * D;

  if (NCH == 1) {
    load_t<DC>(qT, qb, q_step, q0, S);
    load_t<DC>(doT, ob, q_step, q0, S);
  }
  if (tid < BB) {
    const size_t at = ((size_t)b * Hq + h) * S + q0 + tid;
    rowL[tid] = (q0 + tid < S) ? lse[at] : 0.f;
    rowD[tid] = (q0 + tid < S) ? delta[at] : 0.f;
  }
  float adq[4][DPT];  // rows ty*4 + r
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DPT; ++c) adq[r][c] = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += BB) {
    if (!tile_sees(q0 + qoff, q1 + qoff, k0, min(k0 + BB, Skv) - 1, causal, window)) continue;
    float s[4][4], dp[4][4];
    zero44(s);
    zero44(dp);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      __syncthreads();  // q's loads have landed; the last tile's readers are done
      if (NCH > 1) {
        load_t<DC>(qT, qb + ch * DC, q_step, q0, S);
        load_t<DC>(doT, ob + ch * DC, q_step, q0, S);
      }
      load_t<DC>(kT, kb + ch * DC, kv_step, k0, Skv);
      load_t<DC>(vT, vb + ch * DC, kv_step, k0, Skv);
      __syncthreads();
      tile_dot_add<DC>(s, qT, kT, ty, tx);
      tile_dot_add<DC>(dp, doT, vT, ty, tx);
    }
    float dsv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dsv[r][c] = pair_grad(s[r][c], dp[r][c], q0 + row, k0 + tx * 4 + c, S, Skv, causal,
                              window, softcap, scale, rowL[row], rowD[row], scale, qoff).ds;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&dsT[(tx * 4 + c) * BS + ty * 4]) =
          make_float4(dsv[0][c], dsv[1][c], dsv[2][c], dsv[3][c]);

    // dQ[q][d] += sum_key dS[q][key] K[key][d], the last chunk's columns first
#pragma unroll
    for (int ch = NCH - 1; ch >= 0; --ch) {
      if (ch != NCH - 1) {
        __syncthreads();
        load_t<DC>(kT, kb + ch * DC, kv_step, k0, Skv);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BB; ++kk) {
        const float4 d4 = *reinterpret_cast<const float4*>(&dsT[kk * BS + ty * 4]);
        const float dv4[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          const int col = tx + 16 * c;
          if ((NCH > 1 && c / CPC != ch) || (D % 16 != 0 && col >= D)) continue;
          const float x = kT[(col - ch * DC) * BS + kk];
#pragma unroll
          for (int r = 0; r < 4; ++r) adq[r][c] = fmaf(dv4[r], x, adq[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi >= S) continue;
    const size_t base = (((size_t)b * S + qi) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = tx + 16 * c;
      if (D % 16 == 0 || col < D) dq[base + col] = adq[r][c];
    }
  }
}

// ---------------------------------------------------------------- bf16: tensor cores

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
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
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float ex2(float x) {  // 2^x on the special-function unit
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Row stride of a shared tile: 16 bytes of padding make every ldmatrix
// conflict-free (DP = 80: a 176-byte stride puts the 8 rows of an 8 x 8
// matrix on 8 distinct 16-byte bank groups).
__host__ __device__ constexpr int ld_of(int DP) { return DP + 8; }

// Copy `rows` rows of D values (row stride `stride`) into a tile of DP
// columns, zero-filling rows at or past `limit` and columns at or past D;
// NTHR threads share the copies.
template <int DP, int NTHR>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t stride, int row0,
                                          int rows, int limit, int D) {
  constexpr int LD = ld_of(DP), CH = DP / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * CH; i += NTHR) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = (row0 + r < limit) && (c < D);
    const bf16* g = ok ? src + (size_t)(row0 + r) * stride + c : src;
    cp_async16(smem_u32(dst + r * LD + c), g, ok ? 16 : 0);
  }
}

// Two 16 x (8 * NT) product tiles, interleaved: c += A . B^T and e += C .
// D^T, where A and C are 16 x DP rows at a_addr and c_addr and B and D are
// [n][k] in shared memory at b_addr and d_addr (ldmatrix base addresses)
template <int DP, int NT>
__device__ __forceinline__ void mma_rows2(float (&c)[NT][4], uint32_t a_addr, uint32_t b_addr,
                                          float (&e)[NT][4], uint32_t c_addr, uint32_t d_addr) {
  constexpr int LD = ld_of(DP);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4], cc[4];
    ldsm_x4(a, a_addr + kk * 32);
    ldsm_x4(cc, c_addr + kk * 32);
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t b[4], d[4];
      ldsm_x4(b, b_addr + (n2 * 16 * LD + kk * 16) * 2);
      ldsm_x4(d, d_addr + (n2 * 16 * LD + kk * 16) * 2);
      mma_bf16(c[2 * n2], a, b[0], b[1]);
      mma_bf16(e[2 * n2], cc, d[0], d[1]);
      mma_bf16(c[2 * n2 + 1], a, b[2], b[3]);
      mma_bf16(e[2 * n2 + 1], cc, d[2], d[3]);
    }
  }
}

// f32 C fragments of a 16 x 16 * KS tile, rounded to bf16 A fragments
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KS][4], const float (&x)[2 * KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// acc (16 x DO) += X (16 x 16 * KS, bf16 A fragments) . Y, where Y is [k][n]
// in shared memory (rows of DP columns) at yt_addr (a transposing ldmatrix
// base address, at the CTA's first output column)
template <int DP, int DO, int KS>
__device__ __forceinline__ void mma_acc(float (&acc)[DO / 8][4], const uint32_t (&x)[KS][4],
                                        uint32_t yt_addr) {
  constexpr int LD = ld_of(DP);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int d2 = 0; d2 < DO / 16; ++d2) {
      uint32_t b[4];
      ldsm_x4_t(b, yt_addr + (kk * 16 * LD + d2 * 16) * 2);
      mma_bf16(acc[2 * d2], x[kk], b[0], b[1]);
      mma_bf16(acc[2 * d2 + 1], x[kk], b[2], b[3]);
    }
  }
}

// Store a warp's 16 x DO f32 accumulator rows (row0 + lane/4, + 8) as bf16,
// columns below D.
template <int DO>
__device__ __forceinline__ void store_rows(bf16* base, size_t stride, const float (&acc)[DO / 8][4],
                                           int row0, int limit, int D) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int d = 0; d < DO / 8; ++d) {
    const int c = d * 8 + (lane % 4) * 2;
    if (c >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + lane / 4 + 8 * half;
      if (r < limit)
        *reinterpret_cast<uint32_t*>(base + (size_t)r * stride + c) =
            pack_bf16(acc[d][2 * half], acc[d][2 * half + 1]);
    }
  }
}

// The q tiles a dK/dV CTA walks, in order: for each q head g of its group,
// the tiles of t rows that see one of keys [k0, k1] or hold rows that see no
// key (rows at positions qoff + index). Every thread walks the same tiles.
struct QTiles {
  int g, i;  // q head of the group and q tile; g == G once the walk is done
  int G, n, t, S, Skv, k0, k1, causal, window, qoff;
  bool any_no_key;
  __device__ bool needed() const {
    const int q0 = i * t + qoff, q1 = min(i * t + t, S) - 1 + qoff;
    return tile_sees(q0, q1, k0, k1, causal, window) || (any_no_key && no_key(q1, Skv, window));
  }
  __device__ void settle() {  // forward to the first needed tile at or after (g, i)
    while (g < G) {
      while (i < n && !needed()) ++i;
      if (i < n) return;
      ++g;
      i = 0;
    }
  }
  __device__ bool done() const { return g >= G; }
  __device__ void next() {
    if (!done()) {
      ++i;
      settle();
    }
  }
};

// The key tiles of t keys a dQ CTA walks, in order: those one of its rows
// (at positions [q0, q1]) sees.
struct KTiles {
  int i, n, t, Skv, q0, q1, causal, window;
  __device__ bool needed() const {
    return tile_sees(q0, q1, i * t, min(i * t + t, Skv) - 1, causal, window);
  }
  __device__ void settle() {
    while (i < n && !needed()) ++i;
  }
  __device__ bool done() const { return i >= n; }
  __device__ void next() {
    if (!done()) {
      ++i;
      settle();
    }
  }
};

// Shared bytes of the two kernels, whose CTAs own `rows` keys or q rows
// (bwd_launch_plan in kernel.py computes the same).
__host__ __device__ constexpr size_t dkdv_smem(int DP, int rows, int TQ, int ST) {
  return sizeof(bf16) * ld_of(DP) * (2 * rows + 2 * ST * TQ) + sizeof(float) * 2 * ST * TQ;
}
__host__ __device__ constexpr size_t dq_smem(int DP, int rows, int TK, int ST) {
  return sizeof(bf16) * ld_of(DP) * (2 * rows + 2 * ST * TK);
}
// The output columns a CTA owns: the whole head dim up to 128; at 256, one
// 128-wide half (grid z picks it), since a warp's 16 rows of dK and dV over
// all 256 columns would take 256 registers a thread. Both halves' CTAs
// compute S and dP over all 256 columns.
__host__ __device__ constexpr int out_cols(int DP) { return DP > 128 ? 128 : DP; }

template <int DP, int TQ, int ST, int W, int DO>
__global__ void __launch_bounds__(32 * W, 8 / W) fa_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int Skv, int Hq, int Hkv, int D,
    int causal, int window, float softcap, float scale, int qoff) {
  constexpr int LD = ld_of(DP), NT = TQ / 8, DT = DO / 8, QT = TQ * LD;
  constexpr int BR = 16 * W, NTHR = 32 * W;  // keys of the CTA, 16 a warp; threads
  const int c0 = blockIdx.z * DO;            // the CTA's dK and dV columns: c0 .. c0 + DO - 1
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);        // [BR][LD]
  bf16* sV = sK + BR * LD;                              // [BR][LD]
  bf16* sQ = sV + BR * LD;                              // [ST][TQ][LD]: the ring of q tiles
  bf16* sO = sQ + ST * QT;                              // [ST][TQ][LD]: dO
  float* sL = reinterpret_cast<float*>(sO + ST * QT);  // [ST][TQ]: lse
  float* sD = sL + ST * TQ;                             // [ST][TQ]: Delta

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tid = threadIdx.x;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, G = Hq / Hkv;
  // key block blockIdx.y: block 0, which every causal row sees, launches first
  const int k0 = blockIdx.y * BR, k1 = min(k0 + BR, Skv) - 1;
  const int wk0 = k0 + warp * 16;  // this warp's keys: wk0 .. wk0 + 15
  const size_t q_step = (size_t)Hq * D, kv_step = (size_t)Hkv * D;
  const bool any_no_key = window > 0 && S + qoff >= Skv + window;
  const float scale_log2 = scale * LOG2E;

  QTiles walk{0, 0, G, (S + TQ - 1) / TQ, TQ, S, Skv, k0, k1, causal, window, qoff, any_no_key};
  walk.settle();
  QTiles ahead = walk;
  // the loads of tile `ahead` into ring slot `slot`, as one commit group
  // (an empty group past the walk's end keeps the groups counted)
  auto issue = [&](int slot) {
    if (!ahead.done()) {
      const int h = hk * G + ahead.g, q0 = ahead.i * TQ;
      load_rows<DP, NTHR>(sQ + slot * QT, q + ((size_t)b * S * Hq + h) * D, q_step, q0, TQ, S,
                          D);
      load_rows<DP, NTHR>(sO + slot * QT, dout + ((size_t)b * S * Hq + h) * D, q_step, q0, TQ,
                          S, D);
      for (int i = tid; i < 2 * TQ; i += NTHR) {
        const int r = i % TQ;
        const float* src = (i < TQ ? lse : delta) + ((size_t)b * Hq + h) * S;
        const bool ok = q0 + r < S;
        cp_async4(smem_u32((i < TQ ? sL : sD) + slot * TQ + r), ok ? src + q0 + r : src,
                  ok ? 4 : 0);
      }
      ahead.next();
    }
    cp_async_commit();
  };
  load_rows<DP, NTHR>(sK, k + ((size_t)b * Skv * Hkv + hk) * D, kv_step, k0, BR, Skv, D);
  load_rows<DP, NTHR>(sV, v + ((size_t)b * Skv * Hkv + hk) * D, kv_step, k0, BR, Skv, D);
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) issue(s);  // K and V ride in the first tile's group

  float adk[DT][4], adv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[d][e] = adv[d][e] = 0.f;
  const int kj_lo = wk0 + lane / 4;  // this thread's keys: kj_lo, kj_lo + 8
  const int a_row = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
  const uint32_t k_addr = smem_u32(sK + a_row * LD + a_col);
  const uint32_t v_addr = smem_u32(sV + a_row * LD + a_col);
  const int bn_row = (lane % 8) + (lane / 16) * 8, bn_col = ((lane / 8) % 2) * 8;
  const uint32_t qn_addr = smem_u32(sQ + bn_row * LD + bn_col);
  const uint32_t on_addr = smem_u32(sO + bn_row * LD + bn_col);
  const int bt_row = (lane % 8) + ((lane / 8) % 2) * 8, bt_col = (lane / 16) * 8;
  const uint32_t qt_addr = smem_u32(sQ + bt_row * LD + bt_col + c0);
  const uint32_t ot_addr = smem_u32(sO + bt_row * LD + bt_col + c0);

  for (int slot = 0; !walk.done(); slot = (slot + 1 == ST) ? 0 : slot + 1) {
    cp_async_wait<ST - 2>();  // this thread's copies of this tile have landed
    __syncthreads();          // everyone's have, and the last tile's slot is read
    issue(slot == 0 ? ST - 1 : slot - 1);  // the tile ST - 1 ahead, into that slot
    const int q0 = walk.i * TQ, q1 = min(q0 + TQ, S) - 1;
    const int p0 = q0 + qoff, p1 = q1 + qoff;  // their positions
    const bool sees = wk0 < Skv && (tile_sees(p0, p1, wk0, wk0 + 15, causal, window) ||
                                    (any_no_key && no_key(p1, Skv, window)));
    if (sees) {  // this warp's keys take part in this tile
      const uint32_t off = slot * QT * sizeof(bf16);
      float s[NT][4], dp[NT][4];  // S^T and dP^T: this warp's 16 keys x TQ queries
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      mma_rows2<DP, NT>(s, k_addr, qn_addr + off, dp, v_addr, on_addr + off);
      const float* L = sL + slot * TQ;
      const float* Dl = sD + slot * TQ;
      // a tile whose pairs are all visible skips the position tests
      const bool inside = softcap <= 0.f && q1 == q0 + TQ - 1 && wk0 + 15 < Skv &&
                          (!causal || wk0 + 15 <= p0) && (window <= 0 || wk0 > p1 - window);
      if (inside) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n * 8 + (lane % 4) * 2 + (e % 2);
            const float p = ex2(fmaf(s[n][e], scale_log2, -L[col] * LOG2E));
            dp[n][e] = p * (dp[n][e] - Dl[col]);  // the scale goes to the sum
            s[n][e] = p;
          }
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n * 8 + (lane % 4) * 2 + (e % 2);
            const Grad gr = pair_grad(s[n][e], dp[n][e], q0 + col, kj_lo + 8 * (e / 2), S, Skv,
                                      causal, window, softcap, scale, L[col], Dl[col], 1.f, qoff);
            s[n][e] = gr.p;
            dp[n][e] = gr.ds;
          }
      }
      uint32_t pa[TQ / 16][4], da[TQ / 16][4];  // P^T and dS^T as bf16 A fragments
      pack_a<TQ / 16>(pa, s);
      pack_a<TQ / 16>(da, dp);
      mma_acc<DP, DO, TQ / 16>(adv, pa, ot_addr + off);  // dV += P^T dO
      mma_acc<DP, DO, TQ / 16>(adk, da, qt_addr + off);  // dK += dS^T Q
    }
    walk.next();
  }
  cp_async_wait<0>();  // a CTA whose keys no query sees still waits for its loads
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[d][e] *= scale;
  const size_t kbase = ((size_t)b * Skv * Hkv + hk) * D + c0;
  store_rows<DO>(dk + kbase, kv_step, adk, wk0, Skv, D - c0);
  store_rows<DO>(dv + kbase, kv_step, adv, wk0, Skv, D - c0);
}

template <int DP, int TK, int ST, int W, int DO>
__global__ void __launch_bounds__(32 * W, 8 / W) fa_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, bf16* __restrict__ dq, int S, int Skv, int Hq, int Hkv, int D,
    int causal, int window, float softcap, float scale, int qoff) {
  constexpr int LD = ld_of(DP), NT = TK / 8, DT = DO / 8, KT = TK * LD;
  constexpr int BR = 16 * W, NTHR = 32 * W;  // q rows of the CTA, 16 a warp; threads
  const int c0 = blockIdx.z * DO;            // the CTA's dQ columns: c0 .. c0 + DO - 1
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BR][LD]
  bf16* sO = sQ + BR * LD;                        // [BR][LD]: dO
  bf16* sK = sO + BR * LD;                        // [ST][TK][LD]: the ring of key tiles
  bf16* sV = sK + ST * KT;                        // [ST][TK][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / (Hq / Hkv);
  const int q0 = heavy_first(blockIdx.y, gridDim.y, BR, S) * BR, q1 = min(q0 + BR, S) - 1;
  const int wq0 = q0 + warp * 16;  // this warp's rows: wq0 .. wq0 + 15
  const size_t q_step = (size_t)Hq * D, kv_step = (size_t)Hkv * D;
  const size_t qbase = ((size_t)b * S * Hq + h) * D;
  const bf16* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const bf16* vb = v + ((size_t)b * Skv * Hkv + hk) * D;
  const float scale_log2 = scale * LOG2E;

  KTiles walk{0, (Skv + TK - 1) / TK, TK, Skv, q0 + qoff, q1 + qoff, causal, window};
  walk.settle();
  KTiles ahead = walk;
  auto issue = [&](int slot) {  // as in the dK/dV kernel
    if (!ahead.done()) {
      load_rows<DP, NTHR>(sK + slot * KT, kb, kv_step, ahead.i * TK, TK, Skv, D);
      load_rows<DP, NTHR>(sV + slot * KT, vb, kv_step, ahead.i * TK, TK, Skv, D);
      ahead.next();
    }
    cp_async_commit();
  };
  load_rows<DP, NTHR>(sQ, q + qbase, q_step, q0, BR, S, D);
  load_rows<DP, NTHR>(sO, dout + qbase, q_step, q0, BR, S, D);
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) issue(s);  // Q and dO ride in the first tile's group

  // Delta = rowsum(dO * O) of this warp's 16 rows, two lanes a row, by
  // 16-byte loads while the copies above are in flight; the dK/dV kernel,
  // launched after this one, reads it
  const int dr = wq0 + lane / 2;
  float dsum = 0.f;
  if (dr < S) {
    const bf16* orow = o + qbase + (size_t)dr * q_step;
    const bf16* grow = dout + qbase + (size_t)dr * q_step;
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
  if (lane % 2 == 0 && dr < S && blockIdx.z == 0) delta[((size_t)b * Hq + h) * S + dr] = dsum;
  // this thread's rows wq0 + lane/4 and + 8: their Delta and lse (also in log2 units)
  const int r_lo = wq0 + lane / 4;
  float dl[2], ll[2], ll2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dl[r] = __shfl_sync(0xffffffffu, dsum, 2 * (lane / 4) + 16 * r);
    ll[r] = (r_lo + 8 * r < S) ? lse[((size_t)b * Hq + h) * S + r_lo + 8 * r] : 0.f;
    ll2[r] = ll[r] * LOG2E;
  }

  float adq[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[d][e] = 0.f;
  const int a_row = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
  const uint32_t q_addr = smem_u32(sQ + a_row * LD + a_col);
  const uint32_t o_addr = smem_u32(sO + a_row * LD + a_col);
  const int bn_row = (lane % 8) + (lane / 16) * 8, bn_col = ((lane / 8) % 2) * 8;
  const uint32_t kn_addr = smem_u32(sK + bn_row * LD + bn_col);
  const uint32_t vn_addr = smem_u32(sV + bn_row * LD + bn_col);
  const int bt_row = (lane % 8) + ((lane / 8) % 2) * 8, bt_col = (lane / 16) * 8;
  const uint32_t kt_addr = smem_u32(sK + bt_row * LD + bt_col + c0);

  for (int slot = 0; !walk.done(); slot = (slot + 1 == ST) ? 0 : slot + 1) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    issue(slot == 0 ? ST - 1 : slot - 1);
    const int kt0 = walk.i * TK;
    const int wp0 = wq0 + qoff;  // the position of row wq0
    if (wq0 < S && tile_sees(wp0, min(wq0 + 15, S - 1) + qoff, kt0, min(kt0 + TK, Skv) - 1,
                             causal, window)) {
      const uint32_t off = slot * KT * sizeof(bf16);
      float s[NT][4], dp[NT][4];  // S and dP: this warp's 16 rows x TK keys
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      mma_rows2<DP, NT>(s, q_addr, kn_addr + off, dp, o_addr, vn_addr + off);
      const bool inside = softcap <= 0.f && wq0 + 15 < S && kt0 + TK <= Skv &&
                          (!causal || kt0 + TK - 1 <= wp0) &&
                          (window <= 0 || kt0 > wp0 + 15 - window);
      if (inside) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[n][e], scale_log2, -ll2[e / 2]));
            s[n][e] = p * (dp[n][e] - dl[e / 2]);  // the scale goes to the sum
          }
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = pair_grad(s[n][e], dp[n][e], r_lo + 8 * (e / 2),
                                kt0 + n * 8 + (lane % 4) * 2 + (e % 2), S, Skv, causal, window,
                                softcap, scale, ll[e / 2], dl[e / 2], 1.f, qoff).ds;
      }
      uint32_t da[TK / 16][4];  // dS as bf16 A fragments
      pack_a<TK / 16>(da, s);
      mma_acc<DP, DO, TK / 16>(adq, da, kt_addr + off);  // dQ += dS K
    }
    walk.next();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[d][e] *= scale;
  store_rows<DO>(dq + qbase + c0, q_step, adq, wq0, S, D - c0);
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, S, Skv, Hq, Hkv, D, causal, window;
  float softcap, scale;
  int qoff;
};

// Raise a kernel's shared-memory limit once per device, so that a launch a
// CUDA graph captures makes no call besides the launch itself.
template <typename Kernel>
cudaError_t opt_in(bool (&done)[kMaxDevices], Kernel kernel, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int DP, int TK, int ST, int W>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t st) {
  static bool opted_in[kMaxDevices] = {};
  constexpr int rows = 16 * W, DO = out_cols(DP);
  constexpr size_t smem = dq_smem(DP, rows, TK, ST);
  cudaError_t err = opt_in(opted_in, fa_bwd_dq_mma_kernel<DP, TK, ST, W, DO>, smem);
  if (err != cudaSuccess) return err;
  fa_bwd_dq_mma_kernel<DP, TK, ST, W, DO>
      <<<dim3(a.B * a.Hq, (a.S + rows - 1) / rows, DP / DO), 32 * W, smem, st>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.o),
          static_cast<const bf16*>(a.dout), a.lse, a.delta, static_cast<bf16*>(a.dq), a.S,
          a.Skv, a.Hq, a.Hkv, a.D, a.causal, a.window, a.softcap, a.scale, a.qoff);
  return cudaGetLastError();
}

template <int DP, int TQ, int ST, int W>
cudaError_t launch_dkdv(const BwdArgs& a, cudaStream_t st) {
  static bool opted_in[kMaxDevices] = {};
  constexpr int rows = 16 * W, DO = out_cols(DP);
  constexpr size_t smem = dkdv_smem(DP, rows, TQ, ST);
  cudaError_t err = opt_in(opted_in, fa_bwd_dkdv_mma_kernel<DP, TQ, ST, W, DO>, smem);
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_mma_kernel<DP, TQ, ST, W, DO>
      <<<dim3(a.B * a.Hkv, (a.Skv + rows - 1) / rows, DP / DO), 32 * W, smem, st>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
          static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.S, a.Skv, a.Hq, a.Hkv, a.D,
          a.causal, a.window, a.softcap, a.scale, a.qoff);
  return cudaGetLastError();
}

// The tiles built (kernel.BWD_TILES names the same): both kernels step 64 q
// rows (dK/dV) or keys (dQ) through a two-stage ring, 4 warps a CTA, so two
// CTAs share an SM
constexpr int kTile = 64, kStages = 2, kWarps = 4;

// dQ launches first, since it writes the Delta that dK/dV reads.
template <int DP>
cudaError_t launch_bwd_mma(const BwdArgs& a, cudaStream_t st) {
  const cudaError_t err = launch_dq<DP, kTile, kStages, kWarps>(a, st);
  return err != cudaSuccess ? err : launch_dkdv<DP, kTile, kStages, kWarps>(a, st);
}

// ---------------------------------------------------------------- launch

template <int D>
cudaError_t launch_bwd_f32(const BwdArgs& a, cudaStream_t st) {
  static bool dkdv_in[kMaxDevices] = {}, dq_in[kMaxDevices] = {};
  cudaError_t err = opt_in(dkdv_in, fa_bwd_dkdv_kernel<D>, F32Chunks<D>::dkdv);
  if (err == cudaSuccess) err = opt_in(dq_in, fa_bwd_dq_kernel<D>, F32Chunks<D>::dq);
  if (err != cudaSuccess) return err;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const int rows = a.B * a.S * a.Hq;
  fa_bwd_delta_kernel<<<(rows + NTH / 32 - 1) / (NTH / 32), NTH, 0, st>>>(
      static_cast<const float*>(a.o), dout, a.delta, rows, a.S, a.Hq, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dkdv_kernel<D><<<dim3(a.B * a.Hkv, (a.Skv + BB - 1) / BB), NTH, F32Chunks<D>::dkdv, st>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.S,
      a.Skv, a.Hq, a.Hkv, a.causal, a.window, a.softcap, a.scale, a.qoff);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dq_kernel<D><<<dim3(a.B * a.Hq, (a.S + BB - 1) / BB), NTH, F32Chunks<D>::dq, st>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq), a.S, a.Skv, a.Hq, a.Hkv,
      a.causal, a.window, a.softcap, a.scale, a.qoff);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the FMA kernels), 1 = bfloat16 (the tensor-core
// kernels, rows 16-byte aligned); q, k, v, o, dout, dq, dk, dv all of it.
// lse: the forward's (B, Hq, S) f32 log-sum-exp; delta: (B, Hq, S) f32
// scratch. window <= 0: none; softcap <= 0: none. Head dims 8, 16, 32, 64,
// 80, 128, 256. tq, kv_stages, kv_warps, tk, q_stages, q_warps: the launch
// plan's tiles (kernel.bwd_launch_plan): the q rows of a dK/dV step, its
// ring's stages and its CTA's warps, and the same of dQ (keys a step); the
// f32 kernels take (64, 1, 8, 64, 1, 8). q_offset >= 0: the position of q's
// first row.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int fa_backward(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const void* lse, void* delta, void* dq, void* dk,
                           void* dv, int dtype, int B, int S, int Skv, int Hq, int Hkv, int D,
                           int causal, int window, float softcap, float scale, int tq,
                           int kv_stages, int kv_warps, int tk, int q_stages, int q_warps,
                           int qoff, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || qoff < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const BwdArgs a{q, k, v, o, dout, l, dl, dq, dk, dv, B, S, Skv, Hq, Hkv, D, causal, window,
                  softcap, scale, qoff};
  if (dtype == 0) {
    if (tq != BB || kv_stages != 1 || kv_warps != NTH / 32 || tk != BB || q_stages != 1 ||
        q_warps != NTH / 32)
      return cudaErrorInvalidValue;
    switch (D) {
      case 8: return launch_bwd_f32<8>(a, st);
      case 16: return launch_bwd_f32<16>(a, st);
      case 32: return launch_bwd_f32<32>(a, st);
      case 64: return launch_bwd_f32<64>(a, st);
      case 80: return launch_bwd_f32<80>(a, st);
      case 128: return launch_bwd_f32<128>(a, st);
      case 256: return launch_bwd_f32<256>(a, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype != 1 || tq != kTile || kv_stages != kStages || kv_warps != kWarps || tk != kTile ||
      q_stages != kStages || q_warps != kWarps)
    return cudaErrorInvalidValue;
  switch (D) {  // bf16 pads head dims 8 to 16
    case 8:
    case 16: return launch_bwd_mma<16>(a, st);
    case 32: return launch_bwd_mma<32>(a, st);
    case 64: return launch_bwd_mma<64>(a, st);
    case 80: return launch_bwd_mma<80>(a, st);
    case 128: return launch_bwd_mma<128>(a, st);
    case 256: return launch_bwd_mma<256>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
