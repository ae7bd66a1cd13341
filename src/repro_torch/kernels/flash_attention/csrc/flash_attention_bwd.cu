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
// P = 1 / Skv, dS = 0, and its dQ is 0.
//
// Layout as the forward: q, o, dO, dQ are (B, S, Hq, D), k, v, dK, dV
// (B, Skv, Hkv, D), contiguous; lse and Delta are (B, Hq, S) f32.
//
// Determinism: no float atomics. Three launches:
//   1. Delta, one warp a row;
//   2. dK and dV: a CTA owns 64 keys of one kv head and walks the G q heads
//      of its group and their q tiles in order, so GQA's sum over the group
//      runs in registers in a fixed order;
//   3. dQ: a CTA owns 64 q rows of one head and walks the 64-key tiles.
// Scores and dP are computed in both 2 and 3 (seven tile products where
// an atomic design does five); that is the price of a fixed sum order.
//
// What bounds it on an H100 SXM. At qwen3-0.6b's training shape (B=4,
// S=2048, 16/8 heads of 128, causal) the causal mask keeps 134.3 M
// (query, key) pairs; the five products a backward needs are 172 GFLOP
// against 202 MB moved, so operations bound it, and only the tensor cores
// come near that bound.
//
// bf16 path (training's): the forward's tensor-core design, mma.sync
// m16n8k16 with f32 accumulation and operands brought in by ldmatrix. A
// CTA is 4 warps. dK/dV: each warp owns 16 of the CTA's 64 keys and keeps
// their dK and dV rows in registers; per step of 32 q rows it computes
// S^T = K Q^T and dP^T = V dO^T (keys x q), turns them into P^T and dS^T
// in registers, and feeds both as A operands (rounded to bf16, the C-to-A
// fragment identity the forward uses for P) to dV += P^T dO and
// dK += dS^T Q, whose B operands come from the q tile by transposing
// ldmatrix. dQ: each warp owns 16 of the CTA's 64 q rows; per step of 64
// keys, S = Q K^T and dP = dO V^T, dS in registers, dQ += dS K. Tiles come
// in by cp.async into rows padded by 16 bytes (conflict-free ldmatrix),
// one stage: a step's loads are not yet overlapped with the last step's
// products. Head dims below 16 are zero-padded to 16.
//
// f32 path (the f32 model): the reference's 2e-5 rules out bf16 and TF32
// products, so every product is an IEEE f32 FMA, the forward's f32 design:
// 256 threads, each a 4 x 4 patch of the 64 x 64 score tile, tiles
// transposed in shared memory as f32 and read as float4.
//
// Head dims 8 to 128; other head dims are refused by the wrapper.
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

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

// acc[r][c] = sum_d a[d][ty*4 + r] * b[d][tx*4 + c] over two transposed tiles
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* aT, const float* bT,
                                         int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
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

// P and dS of one pair from its raw product s = q . k and dp = dO . v
struct Grad {
  float p, ds;
};
__device__ __forceinline__ Grad pair_grad(float s, float dp, int qi, int kj, int S, int Skv,
                                          int causal, int window, float softcap, float scale,
                                          float lse, float delta) {
  Grad g = {0.f, 0.f};
  if (qi >= S || kj >= Skv) return g;
  if (no_key(qi, Skv, window)) {
    g.p = 1.f / (float)Skv;
    return g;
  }
  if (!visible(qi, kj, Skv, causal, window)) return g;
  float x = s * scale, dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    x = softcap * t;
    dcap = 1.f - t * t;
  }
  g.p = expf(x - lse);
  g.ds = g.p * (dp - delta) * dcap * scale;
  return g;
}

// ---------------------------------------------------------------- Delta

template <typename T>
__global__ void __launch_bounds__(NTH) fa_bwd_delta_kernel(const T* __restrict__ o,
                                                           const T* __restrict__ dout,
                                                           float* __restrict__ delta, int rows,
                                                           int S, int Hq, int D) {
  const int row = blockIdx.x * (NTH / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;  // a row of (B, S, Hq)
  const T* op = o + (size_t)row * D;
  const T* dp = dout + (size_t)row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(op[d]), to_f(dp[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % Hq, s = (row / Hq) % S, b = row / (Hq * S);
    delta[((size_t)b * Hq + h) * S + s] = acc;
  }
}

// ---------------------------------------------------------------- dK, dV

template <int D>
struct BwdSmem {
  static constexpr size_t dkdv = sizeof(float) * (4 * D * BS + 2 * BB * BS + 2 * BB);
  static constexpr size_t dq = sizeof(float) * (4 * D * BS + BB * BS + 2 * BB);
};

template <int D>
__global__ void __launch_bounds__(NTH) fa_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int S,
    int Skv, int Hq, int Hkv, int causal, int window, float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* kT = smem;             // [D][BS]
  float* vT = kT + D * BS;      // [D][BS]
  float* qT = vT + D * BS;      // [D][BS]
  float* doT = qT + D * BS;     // [D][BS]
  float* pS = doT + D * BS;     // [BB][BS]: P, a row per query
  float* dS = pS + BB * BS;     // [BB][BS]: dS, a row per query
  float* rowL = dS + BB * BS;   // [BB]: lse of the tile's rows
  float* rowD = rowL + BB;      // [BB]: Delta of the tile's rows

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, G = Hq / Hkv;
  const int k0 = blockIdx.y * BB, k1 = min(k0 + BB, Skv) - 1;
  const size_t q_step = (size_t)Hq * D, kv_step = (size_t)Hkv * D;
  constexpr int DPT = (D + 15) / 16;  // columns of a thread: tx + 16 c
  const bool any_no_key = window > 0 && S >= Skv + window;

  load_t<D>(kT, k + ((size_t)b * Skv * Hkv + hk) * D, kv_step, k0, Skv);
  load_t<D>(vT, v + ((size_t)b * Skv * Hkv + hk) * D, kv_step, k0, Skv);
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
      if (!tile_sees(q0, q1, k0, k1, causal, window) && !(any_no_key && no_key(q1, Skv, window)))
        continue;
      __syncthreads();  // the last tile's readers of qT, doT, pS, dS are done
      load_t<D>(qT, qb, q_step, q0, S);
      load_t<D>(doT, ob, q_step, q0, S);
      if (tid < BB) {
        rowL[tid] = (q0 + tid < S) ? lb[q0 + tid] : 0.f;
        rowD[tid] = (q0 + tid < S) ? db[q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot<D>(s, qT, kT, ty, tx);
      tile_dot<D>(dp, doT, vT, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = ty * 4 + r;
        float pv[4], dsv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const Grad gr = pair_grad(s[r][c], dp[r][c], q0 + row, k0 + tx * 4 + c, S, Skv, causal,
                                    window, softcap, scale, rowL[row], rowD[row]);
          pv[c] = gr.p;
          dsv[c] = gr.ds;
        }
        *reinterpret_cast<float4*>(&pS[row * BS + tx * 4]) =
            make_float4(pv[0], pv[1], pv[2], pv[3]);
        *reinterpret_cast<float4*>(&dS[row * BS + tx * 4]) =
            make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
      }
      __syncthreads();

      // dV[key][d] += sum_q P[q][key] dO[q][d];  dK[key][d] += sum_q dS[q][key] Q[q][d]
#pragma unroll 4
      for (int qq = 0; qq < BB; ++qq) {
        const float4 p4 = *reinterpret_cast<const float4*>(&pS[qq * BS + ty * 4]);
        const float4 d4 = *reinterpret_cast<const float4*>(&dS[qq * BS + ty * 4]);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        const float dsv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          const int col = tx + 16 * c;
          if (D % 16 == 0 || col < D) {
            const float o = doT[col * BS + qq], x = qT[col * BS + qq];
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
    int causal, int window, float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;             // [D][BS]
  float* doT = qT + D * BS;     // [D][BS]
  float* kT = doT + D * BS;     // [D][BS]
  float* vT = kT + D * BS;      // [D][BS]
  float* dsT = vT + D * BS;     // [BB][BS]: dS, a row per key
  float* rowL = dsT + BB * BS;  // [BB]
  float* rowD = rowL + BB;      // [BB]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * BB, q1 = min(q0 + BB, S) - 1;
  const size_t q_step = (size_t)Hq * D, kv_step = (size_t)Hkv * D;
  constexpr int DPT = (D + 15) / 16;
  const float* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const float* vb = v + ((size_t)b * Skv * Hkv + hk) * D;

  load_t<D>(qT, q + ((size_t)b * S * Hq + h) * D, q_step, q0, S);
  load_t<D>(doT, dout + ((size_t)b * S * Hq + h) * D, q_step, q0, S);
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
    if (!tile_sees(q0, q1, k0, min(k0 + BB, Skv) - 1, causal, window)) continue;
    __syncthreads();  // q's loads have landed; the last tile's readers of kT, vT, dsT are done
    load_t<D>(kT, kb, kv_step, k0, Skv);
    load_t<D>(vT, vb, kv_step, k0, Skv);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(s, qT, kT, ty, tx);
    tile_dot<D>(dp, doT, vT, ty, tx);
    float dsv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dsv[r][c] = pair_grad(s[r][c], dp[r][c], q0 + row, k0 + tx * 4 + c, S, Skv, causal,
                              window, softcap, scale, rowL[row], rowD[row]).ds;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&dsT[(tx * 4 + c) * BS + ty * 4]) =
          make_float4(dsv[0][c], dsv[1][c], dsv[2][c], dsv[3][c]);
    __syncthreads();

    // dQ[q][d] += sum_key dS[q][key] K[key][d]
#pragma unroll 4
    for (int kk = 0; kk < BB; ++kk) {
      const float4 d4 = *reinterpret_cast<const float4*>(&dsT[kk * BS + ty * 4]);
      const float dv4[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 16 * c;
        if (D % 16 == 0 || col < D) {
          const float x = kT[col * BS + kk];
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

constexpr int TW = 4;           // warps a CTA
constexpr int TR = 16 * TW;     // keys (dK/dV) or q rows (dQ) a CTA owns
constexpr int TQ = 32;          // q rows of a dK/dV step
constexpr int TK = 64;          // keys of a dQ step

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }
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

__host__ __device__ constexpr int ld_of(int DP) { return DP + 8; }

// Copy `rows` rows of D values (row stride `stride`) into a tile of DP
// columns, zero-filling rows at or past `limit` and columns at or past D.
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t stride, int row0,
                                          int rows, int limit, int D) {
  constexpr int LD = ld_of(DP), CH = DP / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * CH; i += 32 * TW) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = (row0 + r < limit) && (c < D);
    const bf16* g = ok ? src + (size_t)(row0 + r) * stride + c : src;
    cp_async16(smem_u32(dst + r * LD + c), g, ok ? 16 : 0);
  }
}

// A 16 x (8 * NT) product tile += A (16 x DP rows at a_addr) . B^T, where B
// is [n][k] in shared memory at b_addr (both ldmatrix base addresses)
template <int DP, int NT>
__device__ __forceinline__ void mma_rows(float (&c)[NT][4], uint32_t a_addr, uint32_t b_addr) {
  constexpr int LD = ld_of(DP);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_addr + kk * 32);
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t b[4];
      ldsm_x4(b, b_addr + (n2 * 16 * LD + kk * 16) * 2);
      mma_bf16(c[2 * n2], a, b[0], b[1]);
      mma_bf16(c[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x DP) += X (16 x 16 * KS, f32 C fragments, rounded to bf16 as the
// A operand) . Y, where Y is [k][n] in shared memory at yt_addr (a
// transposing ldmatrix base address)
template <int DP, int KS>
__device__ __forceinline__ void mma_acc(float (&acc)[DP / 8][4], const float (&x)[2 * KS][4],
                                        uint32_t yt_addr) {
  constexpr int LD = ld_of(DP);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int d2 = 0; d2 < DP / 16; ++d2) {
      uint32_t b[4];
      ldsm_x4_t(b, yt_addr + (kk * 16 * LD + d2 * 16) * 2);
      mma_bf16(acc[2 * d2], a, b[0], b[1]);
      mma_bf16(acc[2 * d2 + 1], a, b[2], b[3]);
    }
  }
}

// Store a warp's 16 x DP f32 accumulator rows (row0 + lane/4, + 8) as bf16.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* base, size_t stride, const float (&acc)[DP / 8][4],
                                           int row0, int limit, int D) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int d = 0; d < DP / 8; ++d) {
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

template <int DP>
struct MmaSmem {
  static constexpr size_t dkdv =
      sizeof(bf16) * ld_of(DP) * (2 * TR + 2 * TQ) + sizeof(float) * 2 * TQ;
  static constexpr size_t dq =
      sizeof(bf16) * ld_of(DP) * (2 * TR + 2 * TK) + sizeof(float) * 2 * TR;
};

template <int DP>
__global__ void __launch_bounds__(32 * TW) fa_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int Skv, int Hq, int Hkv, int D,
    int causal, int window, float softcap, float scale) {
  constexpr int LD = ld_of(DP), NT = TQ / 8, DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [TR][LD]
  bf16* sV = sK + TR * LD;                        // [TR][LD]
  bf16* sQ = sV + TR * LD;                        // [TQ][LD]
  bf16* sO = sQ + TQ * LD;                        // [TQ][LD]: dO
  float* sL = reinterpret_cast<float*>(sO + TQ * LD);  // [TQ]: lse
  float* sD = sL + TQ;                                  // [TQ]: Delta

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tid = threadIdx.x;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, G = Hq / Hkv;
  const int k0 = blockIdx.y * TR, k1 = min(k0 + TR, Skv) - 1;
  const size_t q_step = (size_t)Hq * D, kv_step = (size_t)Hkv * D;
  const bool any_no_key = window > 0 && S >= Skv + window;
  load_rows<DP>(sK, k + ((size_t)b * Skv * Hkv + hk) * D, kv_step, k0, TR, Skv, D);
  load_rows<DP>(sV, v + ((size_t)b * Skv * Hkv + hk) * D, kv_step, k0, TR, Skv, D);
  cp_async_commit();

  float adk[DT][4], adv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[d][e] = adv[d][e] = 0.f;
  const int kj_lo = k0 + warp * 16 + lane / 4;  // this thread's keys: kj_lo, kj_lo + 8
  const int a_row = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
  const uint32_t k_addr = smem_u32(sK + a_row * LD + a_col);
  const uint32_t v_addr = smem_u32(sV + a_row * LD + a_col);
  const int bn_row = (lane % 8) + (lane / 16) * 8, bn_col = ((lane / 8) % 2) * 8;
  const uint32_t qn_addr = smem_u32(sQ + bn_row * LD + bn_col);
  const uint32_t on_addr = smem_u32(sO + bn_row * LD + bn_col);
  const int bt_row = (lane % 8) + ((lane / 8) % 2) * 8, bt_col = (lane / 16) * 8;
  const uint32_t qt_addr = smem_u32(sQ + bt_row * LD + bt_col);
  const uint32_t ot_addr = smem_u32(sO + bt_row * LD + bt_col);

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const bf16* qb = q + ((size_t)b * S * Hq + h) * D;
    const bf16* ob = dout + ((size_t)b * S * Hq + h) * D;
    const float* lb = lse + ((size_t)b * Hq + h) * S;
    const float* db = delta + ((size_t)b * Hq + h) * S;
    for (int q0 = 0; q0 < S; q0 += TQ) {
      const int q1 = min(q0 + TQ, S) - 1;
      if (!tile_sees(q0, q1, k0, k1, causal, window) && !(any_no_key && no_key(q1, Skv, window)))
        continue;
      __syncthreads();  // the last step's readers of sQ, sO, sL, sD are done
      load_rows<DP>(sQ, qb, q_step, q0, TQ, S, D);
      load_rows<DP>(sO, ob, q_step, q0, TQ, S, D);
      cp_async_commit();
      if (tid < TQ) {
        sL[tid] = (q0 + tid < S) ? lb[q0 + tid] : 0.f;
        sD[tid] = (q0 + tid < S) ? db[q0 + tid] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      float s[NT][4], dp[NT][4];  // S^T and dP^T: this warp's 16 keys x TQ queries
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      mma_rows<DP, NT>(s, k_addr, qn_addr);
      mma_rows<DP, NT>(dp, v_addr, on_addr);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + (lane % 4) * 2 + (e % 2);
          const Grad gr = pair_grad(s[n][e], dp[n][e], q0 + col, kj_lo + 8 * (e / 2), S, Skv,
                                    causal, window, softcap, scale, sL[col], sD[col]);
          s[n][e] = gr.p;
          dp[n][e] = gr.ds;
        }
      mma_acc<DP, TQ / 16>(adv, s, ot_addr);   // dV += P^T dO
      mma_acc<DP, TQ / 16>(adk, dp, qt_addr);  // dK += dS^T Q
    }
  }
  cp_async_wait_all();  // a CTA whose keys no query sees still waits for its loads
  const size_t kbase = ((size_t)b * Skv * Hkv + hk) * D;
  store_rows<DP>(dk + kbase, kv_step, adk, k0 + warp * 16, Skv, D);
  store_rows<DP>(dv + kbase, kv_step, adv, k0 + warp * 16, Skv, D);
}

template <int DP>
__global__ void __launch_bounds__(32 * TW) fa_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int S, int Skv, int Hq, int Hkv, int D, int causal, int window,
    float softcap, float scale) {
  constexpr int LD = ld_of(DP), NT = TK / 8, DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [TR][LD]
  bf16* sO = sQ + TR * LD;                        // [TR][LD]: dO
  bf16* sK = sO + TR * LD;                        // [TK][LD]
  bf16* sV = sK + TK * LD;                        // [TK][LD]
  float* sL = reinterpret_cast<float*>(sV + TK * LD);  // [TR]: lse
  float* sD = sL + TR;                                  // [TR]: Delta

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tid = threadIdx.x;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * TR, q1 = min(q0 + TR, S) - 1;
  const size_t q_step = (size_t)Hq * D, kv_step = (size_t)Hkv * D;
  const bf16* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const bf16* vb = v + ((size_t)b * Skv * Hkv + hk) * D;
  load_rows<DP>(sQ, q + ((size_t)b * S * Hq + h) * D, q_step, q0, TR, S, D);
  load_rows<DP>(sO, dout + ((size_t)b * S * Hq + h) * D, q_step, q0, TR, S, D);
  cp_async_commit();
  if (tid < TR) {
    const size_t at = ((size_t)b * Hq + h) * S + q0 + tid;
    sL[tid] = (q0 + tid < S) ? lse[at] : 0.f;
    sD[tid] = (q0 + tid < S) ? delta[at] : 0.f;
  }
  float adq[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[d][e] = 0.f;
  const int row_lo = warp * 16 + lane / 4;  // this thread's rows: q0 + row_lo, + 8
  const int a_row = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
  const uint32_t q_addr = smem_u32(sQ + a_row * LD + a_col);
  const uint32_t o_addr = smem_u32(sO + a_row * LD + a_col);
  const int bn_row = (lane % 8) + (lane / 16) * 8, bn_col = ((lane / 8) % 2) * 8;
  const uint32_t kn_addr = smem_u32(sK + bn_row * LD + bn_col);
  const uint32_t vn_addr = smem_u32(sV + bn_row * LD + bn_col);
  const int bt_row = (lane % 8) + ((lane / 8) % 2) * 8, bt_col = (lane / 16) * 8;
  const uint32_t kt_addr = smem_u32(sK + bt_row * LD + bt_col);

  for (int k0 = 0; k0 < Skv; k0 += TK) {
    if (!tile_sees(q0, q1, k0, min(k0 + TK, Skv) - 1, causal, window)) continue;
    __syncthreads();  // lse/Delta are stored; the last step's readers of sK, sV are done
    load_rows<DP>(sK, kb, kv_step, k0, TK, Skv, D);
    load_rows<DP>(sV, vb, kv_step, k0, TK, Skv, D);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float s[NT][4], dp[NT][4];  // S and dP: this warp's 16 rows x TK keys
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_rows<DP, NT>(s, q_addr, kn_addr);
    mma_rows<DP, NT>(dp, o_addr, vn_addr);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_lo + 8 * (e / 2);
        s[n][e] = pair_grad(s[n][e], dp[n][e], q0 + row, k0 + n * 8 + (lane % 4) * 2 + (e % 2),
                            S, Skv, causal, window, softcap, scale, sL[row], sD[row]).ds;
      }
    mma_acc<DP, TK / 16>(adq, s, kt_addr);  // dQ += dS K
  }
  cp_async_wait_all();
  store_rows<DP>(dq + ((size_t)b * S * Hq + h) * D, q_step, adq, q0 + warp * 16, S, D);
}

template <int DP>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, float* delta, void* dq, void* dk,
                           void* dv, int B, int S, int Skv, int Hq, int Hkv, int D, int causal,
                           int window, float softcap, float scale, cudaStream_t st) {
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(fa_bwd_dkdv_mma_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)MmaSmem<DP>::dkdv);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fa_bwd_dq_mma_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MmaSmem<DP>::dq);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const int rows = B * S * Hq;
  fa_bwd_delta_kernel<bf16><<<(rows + NTH / 32 - 1) / (NTH / 32), NTH, 0, st>>>(
      static_cast<const bf16*>(o), dop, delta, rows, S, Hq, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dkdv_mma_kernel<DP><<<dim3(B * Hkv, (Skv + TR - 1) / TR), 32 * TW, MmaSmem<DP>::dkdv,
                               st>>>(qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dk),
                                     static_cast<bf16*>(dv), S, Skv, Hq, Hkv, D, causal, window,
                                     softcap, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dq_mma_kernel<DP><<<dim3(B * Hq, (S + TR - 1) / TR), 32 * TW, MmaSmem<DP>::dq, st>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dq), S, Skv, Hq, Hkv, D, causal, window,
      softcap, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- launch

template <int D>
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int S, int Skv, int Hq, int Hkv, int causal, int window,
                       float softcap, float scale, cudaStream_t st) {
  // raise the shared-memory limits once per device, so that a launch a CUDA
  // graph captures makes no call besides the launch itself
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)BwdSmem<D>::dkdv);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fa_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)BwdSmem<D>::dq);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  const int rows = B * S * Hq;
  fa_bwd_delta_kernel<float><<<(rows + NTH / 32 - 1) / (NTH / 32), NTH, 0, st>>>(
      static_cast<const float*>(o), dop, delta, rows, S, Hq, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dkdv_kernel<D><<<dim3(B * Hkv, (Skv + BB - 1) / BB), NTH, BwdSmem<D>::dkdv, st>>>(
      qp, kp, vp, dop, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), S, Skv, Hq,
      Hkv, causal, window, softcap, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dq_kernel<D><<<dim3(B * Hq, (S + BB - 1) / BB), NTH, BwdSmem<D>::dq, st>>>(
      qp, kp, vp, dop, lse, delta, static_cast<float*>(dq), S, Skv, Hq, Hkv, causal, window,
      softcap, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(int D, const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int S, int Skv, int Hq, int Hkv, int causal, int window,
                       float softcap, float scale, cudaStream_t st) {
#define FA_BWD_CASE(DD)                                                                        \
  case DD:                                                                                     \
    return launch_bwd_f32<DD>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, Skv, Hq, Hkv, \
                              causal, window, softcap, scale, st);
  switch (D) {
    FA_BWD_CASE(8)
    FA_BWD_CASE(16)
    FA_BWD_CASE(32)
    FA_BWD_CASE(64)
    FA_BWD_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_BWD_CASE
}

}  // namespace

// dtype: 0 = float32 (the FMA kernels), 1 = bfloat16 (the tensor-core
// kernels, rows 16-byte aligned); q, k, v, o, dout, dq, dk, dv all of it.
// lse: the forward's (B, Hq, S) f32 log-sum-exp; delta: (B, Hq, S) f32
// scratch. window <= 0: none; softcap <= 0: none. Head dims 8, 16, 32, 64,
// 128. Returns the cudaError_t of the launches (0 on success).
extern "C" int fa_backward(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const void* lse, void* delta, void* dq, void* dk,
                           void* dv, int dtype, int B, int S, int Skv, int Hq, int Hkv, int D,
                           int causal, int window, float softcap, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return dispatch_f32(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, S, Skv, Hq, Hkv, causal,
                             window, softcap, scale, st);
  if (dtype != 1) return cudaErrorInvalidValue;
#define FA_BWD_MMA(DP)                                                                        \
  return launch_bwd_mma<DP>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S, Skv, Hq, Hkv, D, causal, \
                            window, softcap, scale, st);
  switch (D) {
    case 8:
    case 16: FA_BWD_MMA(16)
    case 32: FA_BWD_MMA(32)
    case 64: FA_BWD_MMA(64)
    case 128: FA_BWD_MMA(128)
    default: return cudaErrorInvalidValue;
  }
#undef FA_BWD_MMA
}
