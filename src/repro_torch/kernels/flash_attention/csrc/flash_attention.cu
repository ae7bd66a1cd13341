// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces `_fa_kernel` / `flash_attention_pallas` of
// src/repro/kernels/flash_attention/kernel.py: FA2 online-softmax attention
// with GQA, causal / sliding-window / tanh-softcap masks, f32 running max,
// sum and accumulator, output acc / max(l, 1e-30). The positions of k start
// at 0, those of q at q_offset (0 unless a rank holds a block of the query
// rows: ops.row_split), also when S != Skv; every mask and schedule below
// takes a row's position, q_offset + its index.
//
// Layout: q and o are (B, S, Hq, D), k and v (B, Skv, Hkv, D), contiguous;
// q head h reads kv head h / (Hq / Hkv). The kernel reads these strides
// directly, so no transposed copy is made.
//
// What bounds it on an H100 SXM. At the serving path's main shape (B=4,
// S=Skv=2048, 16 q / 8 kv heads of 128, causal, bf16) the causal mask keeps
// 134.3 M (query, key) pairs: 68.7 GFLOP of QK^T and PV against 33.6 MB of
// q, k, v and o. That is 0.0695 ms at the 989 TFLOP/s bf16 tensor-core
// peak and 0.010 ms at 3.35 TB/s, so operations bound it, and only the
// tensor cores can approach that bound.
//
// Knobs and launch (both paths). The launch grid is (B*Hq, ceil(S/bq)):
// one CTA owns bq = min(block_q, S) query rows and walks them in
// sub-blocks of at most what its registers hold (16 rows a warp, up to 8
// warps), in order. The TPU kernel's sequential KV grid axis becomes the
// CTA's loop over steps of bk = min(block_k, Skv) keys: the running max,
// sum and accumulator are rescaled once per step. A step wider than the
// register tile (kt keys) is staged as kt-key sub-tiles in two passes over
// them: the first finds the step's row maximum, the second computes
// exp(s - m) against it and accumulates P V, so the rescale still happens
// once per step (the price is QK^T twice for such steps). Steps that the
// causal or window mask removes entirely are never loaded. Keys past Skv
// or past their step's end score -inf (weight 0 whatever m is); keys the
// mask removes score -1e30, as in the reference. A row with no visible key
// (a window with S >= Skv + window) averages v over all Skv keys, as the
// plain version does: the sub-block holding it walks every step. Rows past
// S and keys past Skv are masked here, so no length has to divide a block.
//
// bf16 path (the serving path): mma.sync.m16n8k16 bf16 products with f32
// accumulation, operands brought to registers with ldmatrix, the FA2
// design. mma.sync was chosen over wgmma + TMA for this kernel: one code
// path takes every tile shape the knobs ask for (16-row warps, 32/64/128-
// key tiles, head dims 8..256). Each warp owns 16 q rows; S = Q K^T stays
// in registers (kt/2 floats a thread), P is rounded to bf16 in registers
// and fed to the PV product as its A operand without touching shared
// memory. K and V sub-tiles come into a ring of two shared-memory stages
// by cp.async, so the next sub-tile loads while this one computes; each
// fragment is loaded one product ahead of its use. Rows are padded by 16
// bytes in shared memory, which makes every ldmatrix conflict-free; head
// dims below 16 are zero-padded to 16 there, and head dim 80 to 96 (the
// zero columns add nothing to QK^T, and their outputs are not stored).
// Tiles inside the mask skip the position tests, and the scale folds into
// the exponent's FFMA. The
// output is staged through the warp's own q rows and written as 16-byte
// stores. What holds it at several times its bound (PERF.md) is the
// shared-memory reads: with 16 rows a warp, each K or V fragment feeds
// two products, so at 128 keys a step the fragment loads take about as
// long as the products (about 0.33 ms at the main shape on an H100 SXM).
// So bf16 at head dims 128 and 256 runs on flash_attention_wgmma.cu
// (wgmma fed by TMA, which reads B from shared memory itself); this file
// keeps f32, head dims 8-80 and bf16 bases that are not 16-byte multiples
// (kernel.fwd_engine chooses).
//
// Log-sum-exp for the backward (flash_attention_bwd.cu): where `lse` is not
// null, each row's natural-log log-sum-exp of its scores, lse = m + log l,
// is written as f32 at lse[(b * Hq + h) * S + q]; a row that sees no key
// gets -inf. The serving path passes null and writes nothing.
//
// f32 path (the tuner's inputs and the f32 model): the reference's 2e-5
// rules out TF32, so every product is an IEEE f32 FMA on the FMA units.
// 256 threads own 64 q rows; each thread holds a 4x4 patch of the 64x64
// score tile and a 4 x ceil(D/16) patch of the output rows; tiles sit in
// shared memory as f32 (q and k transposed, read as float4).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float MASKED = -1.0e30f;  // the reference's value for a masked score
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------- schedule

// The key schedule of one q sub-block: steps j of bk keys from j_lo to
// j_hi, each staged as sub-tiles t of kt keys; with two passes, phase 0
// (row max only) runs over a step's sub-tiles before phase 1 (accumulate).
struct Schedule {
  int bk, kt, nsub, two_pass, Skv;
  int j, ph, t, j_hi;
  __device__ int key0() const { return j * bk + t * kt; }
  __device__ int step_end() const { return min((j + 1) * bk, Skv); }
  __device__ bool valid() const { return j <= j_hi; }
  __device__ void next() {
    ++t;
    if (t >= nsub || key0() >= step_end()) {
      t = 0;
      if (two_pass && ph == 0) {
        ph = 1;
      } else {
        ph = two_pass ? 0 : 1;
        ++j;
      }
    }
  }
};

// First and last step a sub-block of rows [q0, q_last] can see. A row
// q >= Skv + window - 1 sees no key at all; the plain version averages v
// over every key for it, so a sub-block holding such a row walks them all
// (its other rows give the extra keys weight 0).
__device__ Schedule make_schedule(int q0, int q_last, int Skv, int causal, int window, int bk,
                                  int kt, int two_pass) {
  int k_hi = causal ? min(Skv, q_last + 1) : Skv;  // exclusive
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  if (window > 0 && q_last >= Skv + window - 1) k_lo = 0;
  Schedule s;
  s.bk = bk;
  s.kt = kt;
  s.nsub = (bk + kt - 1) / kt;
  s.two_pass = two_pass;
  s.Skv = Skv;
  s.t = 0;
  s.ph = two_pass ? 0 : 1;
  s.j = k_lo / bk;
  s.j_hi = (k_lo < k_hi) ? (k_hi - 1) / bk : s.j - 1;
  return s;
}

__device__ __forceinline__ float score(float acc, int qi, int kj, int step_end, int causal,
                                       int window, float softcap, float scale) {
  float x = acc * scale;
  if (softcap > 0.f) x = softcap * tanhf(x / softcap);
  bool keep = true;
  if (causal) keep = keep && kj <= qi;
  if (window > 0) keep = keep && kj > qi - window;
  // a key past Skv or past this step does not exist here: weight 0
  return (kj >= step_end) ? -INFINITY : (keep ? x : MASKED);
}

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }
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
__device__ __forceinline__ float ex2(float x) {  // 2^x on the special-function unit
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- bf16 path

__host__ __device__ constexpr int ld_of(int DP) { return DP + 8; }

// Shared-memory bytes of the bf16 kernel: q rows of the sub-block, then
// two stages of (k, v) sub-tiles, rows padded by 8 values (16 bytes).
size_t bf16_smem_bytes(int DP, int kt, int warps) {
  return sizeof(__nv_bfloat16) * (size_t)ld_of(DP) * (16 * warps + 4 * kt);
}

// Copy `rows` rows of D values (row stride `stride`) into a tile of DP
// columns, zero-filling rows at or past `limit` and columns at or past D.
template <int DP>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int row0, int rows, int limit, int D) {
  constexpr int LD = ld_of(DP), CH = DP / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = (row0 + r < limit) && (c < D);
    const __nv_bfloat16* g = ok ? src + (size_t)(row0 + r) * stride + c : src;
    cp_async16(smem_u32(dst + r * LD + c), g, ok ? 16 : 0);
  }
}

template <int DP, int KT>
__global__ void __launch_bounds__(256) fa_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    int S, int Skv, int Hq, int Hkv, int D, int bq, int bk, int causal, int window, float softcap,
    float scale, int qoff) {
  constexpr int LD = ld_of(DP);
  constexpr int NT = KT / 8;  // n-tiles of the score tile
  constexpr int DT = DP / 8;  // n-tiles of the output rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32;
  const int qsub = 16 * warps;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [qsub][LD]
  __nv_bfloat16* sK = sQ + qsub * LD;                               // [2][KT][LD]
  __nv_bfloat16* sV = sK + 2 * KT * LD;                             // [2][KT][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int iq = gridDim.y - 1 - blockIdx.y;  // the longest causal rows start first
  const int qb0 = iq * bq, qb_end = min(qb0 + bq, S);
  const int two_pass = bk > KT;
  const float scale_log2 = scale * LOG2E;

  const size_t q_step = (size_t)Hq * D, kv_step = (size_t)Hkv * D;
  const __nv_bfloat16* qb = q + ((size_t)b * S * Hq + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv * Hkv + hk) * D;
  __nv_bfloat16* ob = o + ((size_t)b * S * Hq + h) * D;

  for (int q0 = qb0; q0 < qb_end; q0 += qsub) {
    const int q_last = min(q0 + qsub, qb_end) - 1;
    Schedule sc = make_schedule(q0 + qoff, q_last + qoff, Skv, causal, window, bk, KT, two_pass);
    __syncthreads();  // the last sub-block's output staging in sQ is written out
    load_rows<DP>(sQ, qb, q_step, q0, qsub, S, D);
    cp_async_commit();
    int stage = 0;
    if (sc.valid()) {
      load_rows<DP>(sK, kb, kv_step, sc.key0(), KT, Skv, D);
      if (sc.ph == 1) load_rows<DP>(sV, vb, kv_step, sc.key0(), KT, Skv, D);
    }
    cp_async_commit();

    float acc[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    // running max (log2 units), this thread's part of the row sum, a wide step's max
    float m[2] = {MASKED * LOG2E, MASKED * LOG2E}, l[2] = {0.f, 0.f};
    float step_max[2] = {-INFINITY, -INFINITY};
    const int w0 = q0 + warp * 16;   // this warp's rows: w0 .. w0 + 15
    const int r_lo = w0 + lane / 4;  // this thread's rows: r_lo, r_lo + 8
    const int wp0 = w0 + qoff;       // the position of row w0

    while (sc.valid()) {
      Schedule nx = sc;
      nx.next();
      if (nx.valid()) {
        const int ns = stage ^ 1;
        load_rows<DP>(sK + ns * KT * LD, kb, kv_step, nx.key0(), KT, Skv, D);
        if (nx.ph == 1) load_rows<DP>(sV + ns * KT * LD, vb, kv_step, nx.key0(), KT, Skv, D);
      }
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();

      const __nv_bfloat16* tK = sK + stage * KT * LD;
      const __nv_bfloat16* tV = sV + stage * KT * LD;
      // S = Q K^T for this warp's 16 rows and KT keys; fragments are loaded
      // one product ahead of their use, so each ldmatrix has the previous
      // products' time to land
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const uint32_t q_addr =
          smem_u32(sQ + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8);
      const uint32_t k_addr =
          smem_u32(tK + ((lane % 8) + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4], bc[4], bn[4];
        ldsm_x4(a, q_addr + kk * 32);
        ldsm_x4(bc, k_addr + kk * 32);
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
          if (n2 + 1 < NT / 2) ldsm_x4(bn, k_addr + ((n2 + 1) * 16 * LD + kk * 16) * 2);
          mma_bf16(s[2 * n2], a, bc[0], bc[1]);
          mma_bf16(s[2 * n2 + 1], a, bc[2], bc[3]);
#pragma unroll
          for (int i = 0; i < 4; ++i) bc[i] = bn[i];
        }
      }
      // m is kept in log2 units (x * log2 e): exp(x - m) = 2^(s * mul - m),
      // one FFMA and one ex2. A tile inside the mask keeps the raw product
      // s and mul = scale * log2 e; other tiles are scored to log2 units.
      const int key0 = sc.key0(), kend = sc.step_end();
      const bool masked = key0 + KT > kend || (causal && key0 + KT - 1 > wp0) ||
                          (window > 0 && key0 <= wp0 + 15 - window);
      float mul = scale_log2;
      if (masked || softcap > 0.f) {
        mul = 1.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = r_lo + (e / 2) * 8 + qoff;
            const int kj = key0 + n * 8 + (lane % 4) * 2 + (e % 2);
            s[n][e] = score(s[n][e], qi, kj, kend, causal, window, softcap, scale) * LOG2E;
          }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] *= mul;  // mul > 0 keeps the order
      }
      if (sc.ph == 0) {  // first pass of a wide step: its row maximum only
#pragma unroll
        for (int r = 0; r < 2; ++r) step_max[r] = (sc.t == 0 ? mx[r] : fmaxf(step_max[r], mx[r]));
      } else {
        if (!two_pass || sc.t == 0) {  // once per step: the new max and the rescale
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m[r], two_pass ? step_max[r] : mx[r]);
            const float corr = ex2(m[r] - m_new);
            l[r] *= corr;
            m[r] = m_new;
#pragma unroll
            for (int d = 0; d < DT; ++d) {
              acc[d][2 * r] *= corr;
              acc[d][2 * r + 1] *= corr;
            }
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = ex2(fmaf(s[n][e], mul, -m[e / 2]));
            l[e / 2] += s[n][e];  // this thread's part of the row sum
          }
        }
        // O += P V, P rounded to bf16 in registers as the A operand
        const uint32_t v_addr =
            smem_u32(tV + ((lane % 8) + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8);
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                 pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                 pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                 pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          uint32_t bc[4], bn[4];
          ldsm_x4_t(bc, v_addr + kk * 16 * LD * 2);
#pragma unroll
          for (int d2 = 0; d2 < DT / 2; ++d2) {
            if (d2 + 1 < DT / 2) ldsm_x4_t(bn, v_addr + (kk * 16 * LD + (d2 + 1) * 16) * 2);
            mma_bf16(acc[2 * d2], a, bc[0], bc[1]);
            mma_bf16(acc[2 * d2 + 1], a, bc[2], bc[3]);
#pragma unroll
            for (int i = 0; i < 4; ++i) bc[i] = bn[i];
          }
        }
      }
      __syncthreads();  // this stage is read; the next iteration refills it
      stage ^= 1;
      sc = nx;
    }
    cp_async_wait_all();
    __syncthreads();  // every thread's copies into sQ have landed before it is reused

    // out = acc / max(l, 1e-30), staged through this warp's own q rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int qi = r_lo + 8 * r;
      if (lse != nullptr && lane % 4 == 0 && qi <= q_last)
        lse[((size_t)b * Hq + h) * S + qi] = (window > 0 && qi + qoff >= Skv + window - 1)
                                                 ? -INFINITY
                                                 : (m[r] + log2f(fmaxf(l[r], 1e-30f))) * LN2;
      l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* sO = sQ + warp * 16 * LD;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int c = d * 8 + (lane % 4) * 2;
      *reinterpret_cast<uint32_t*>(sO + (lane / 4) * LD + c) =
          pack_bf16(acc[d][0] * l[0], acc[d][1] * l[0]);
      *reinterpret_cast<uint32_t*>(sO + (lane / 4 + 8) * LD + c) =
          pack_bf16(acc[d][2] * l[1], acc[d][3] * l[1]);
    }
    __syncwarp();
    const int CH = D / 8;  // D >= 8: whole 16-byte chunks
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8;
      const int qi = w0 + r;
      if (qi <= q_last)
        *reinterpret_cast<uint4*>(ob + (size_t)qi * q_step + c) =
            *reinterpret_cast<const uint4*>(sO + r * LD + c);
    }
  }
}

template <int DP, int KT>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                        int Skv, int Hq, int Hkv, int D, int bq, int bk, int warps, int causal,
                        int window, float softcap, float scale, int qoff, cudaStream_t stream) {
  // raise the shared-memory limit once per device and size, so that a
  // launch a CUDA graph captures makes no call besides the launch itself
  static size_t configured[kMaxDevices] = {};
  const size_t smem = bf16_smem_bytes(DP, KT, warps);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > configured[dev]) {
    err = cudaFuncSetAttribute(fa_bf16_kernel<DP, KT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured[dev] = smem;
  }
  const dim3 grid(B * Hq, (S + bq - 1) / bq);
  fa_bf16_kernel<DP, KT><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, S, Skv, Hq, Hkv,
      D, bq, bk, causal, window, softcap, scale, qoff);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dispatch_kt(int kt, const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int S, int Skv, int Hq, int Hkv, int D, int bq, int bk, int warps,
                        int causal, int window, float softcap, float scale, int qoff,
                        cudaStream_t st) {
  switch (kt) {
    case 32:
      return launch_bf16<DP, 32>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, D, bq, bk, warps, causal, window,
                                 softcap, scale, qoff, st);
    case 64:
      return launch_bf16<DP, 64>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, D, bq, bk, warps, causal, window,
                                 softcap, scale, qoff, st);
    case 128:
      if constexpr (DP <= 128)
        return launch_bf16<DP, 128>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, D, bq, bk, warps, causal,
                                    window, softcap, scale, qoff, st);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- f32 path

constexpr int BQ = 64;      // q rows of a sub-block
constexpr int BK = 64;      // keys of a sub-tile
constexpr int NTH = 256;    // threads: 16 (tx) x 16 (ty)
constexpr int QS = BQ + 4;  // row stride of q^T and p^T (keeps float4 alignment)
constexpr int KS = BK + 4;  // row stride of k^T

template <int D> struct F32Smem {
  static constexpr int kv = (D * KS > BK * D) ? D * KS : BK * D;  // k^T, then v
  static constexpr size_t bytes = sizeof(float) * (D * QS + kv + BK * QS);
};

template <int D>
__global__ void __launch_bounds__(NTH) fa_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int S, int Skv, int Hq, int Hkv, int bq,
    int bk, int causal, int window, float softcap, float scale, int qoff) {
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;                  // [D][QS]
  float* kv = qT + D * QS;           // k^T [D][KS], later v [BK][D]
  float* pT = kv + F32Smem<D>::kv;   // [BK][QS]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int iq = gridDim.y - 1 - blockIdx.y;
  const int qb0 = iq * bq, qb_end = min(qb0 + bq, S);
  const int two_pass = bk > BK;

  const size_t q_step = (size_t)Hq * D, kv_step = (size_t)Hkv * D;
  const float* qb = q + ((size_t)b * S * Hq + h) * D;
  const float* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const float* vb = v + ((size_t)b * Skv * Hkv + hk) * D;
  float* ob = o + ((size_t)b * S * Hq + h) * D;
  constexpr int DPT = (D + 15) / 16;  // output columns of a thread: tx + 16 c

  for (int q0 = qb0; q0 < qb_end; q0 += BQ) {
    const int q_last = min(q0 + BQ, qb_end) - 1;
    __syncthreads();  // the last sub-block's readers of q^T are done
    for (int i = tid; i < BQ * D; i += NTH) {
      const int r = i / D, d = i % D;
      qT[d * QS + r] = (q0 + r < S) ? qb[(size_t)(q0 + r) * q_step + d] : 0.f;
    }
    float acc[4][DPT];
    float m[4], l[4], step_max[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      m[r] = MASKED;
      l[r] = 0.f;
      step_max[r] = -INFINITY;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[r][c] = 0.f;
    }

    for (Schedule sc = make_schedule(q0 + qoff, q_last + qoff, Skv, causal, window, bk, BK, two_pass);
         sc.valid(); sc.next()) {
      const int kt = sc.key0(), kend = sc.step_end();
      __syncthreads();  // q^T is stored; the last tile's readers of kv and p^T are done
      for (int i = tid; i < BK * D; i += NTH) {
        const int j = i / D, d = i % D;
        kv[d * KS + j] = (kt + j < Skv) ? kb[(size_t)(kt + j) * kv_step + d] : 0.f;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(&qT[d * QS + ty * 4]);
        const float4 bk4 = *reinterpret_cast<const float4*>(&kv[d * KS + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {bk4.x, bk4.y, bk4.z, bk4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
      }

      float rmax[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qi = q0 + ty * 4 + r;
        rmax[r] = -INFINITY;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = score(s[r][c], qi + qoff, kt + tx * 4 + c, kend, causal, window, softcap,
                          scale);
          rmax[r] = fmaxf(rmax[r], s[r][c]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], off));
      }
      if (sc.ph == 0) {  // first pass of a wide step: its row maximum only
#pragma unroll
        for (int r = 0; r < 4; ++r) step_max[r] = sc.t == 0 ? rmax[r] : fmaxf(step_max[r], rmax[r]);
        continue;
      }
      float corr[4] = {1.f, 1.f, 1.f, 1.f};
      const bool rescale = !two_pass || sc.t == 0;  // once per step
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (rescale) {
          const float m_new = fmaxf(m[r], two_pass ? step_max[r] : rmax[r]);
          corr[r] = expf(m[r] - m_new);
          m[r] = m_new;
        }
        float psum = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = expf(s[r][c] - m[r]);
          psum += s[r][c];
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l[r] = corr[r] * l[r] + psum;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(&pT[(tx * 4 + c) * QS + ty * 4]) =
            make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      __syncthreads();  // k^T is no longer read; p^T is complete

      for (int i = tid; i < BK * D; i += NTH) {
        const int j = i / D, d = i % D;
        kv[j * D + d] = (kt + j < Skv) ? vb[(size_t)(kt + j) * kv_step + d] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[r][c] *= corr[r];
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float4 p = *reinterpret_cast<const float4*>(&pT[j * QS + ty * 4]);
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          const int col = tx + 16 * c;
          if (D % 16 == 0 || col < D) {
            const float vv = kv[j * D + col];
            acc[0][c] = fmaf(p.x, vv, acc[0][c]);
            acc[1][c] = fmaf(p.y, vv, acc[1][c]);
            acc[2][c] = fmaf(p.z, vv, acc[2][c]);
            acc[3][c] = fmaf(p.w, vv, acc[3][c]);
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty * 4 + r;
      if (qi > q_last) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      if (lse != nullptr && tx == 0)
        lse[((size_t)b * Hq + h) * S + qi] =
            (window > 0 && qi + qoff >= Skv + window - 1) ? -INFINITY : m[r] + logf(denom);
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 16 * c;
        if (D % 16 == 0 || col < D) ob[(size_t)qi * q_step + col] = acc[r][c] / denom;
      }
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                       int Skv, int Hq, int Hkv, int bq, int bk, int causal, int window,
                       float softcap, float scale, int qoff, cudaStream_t stream) {
  const size_t smem = F32Smem<D>::bytes;
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(fa_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const dim3 grid(B * Hq, (S + bq - 1) / bq);
  fa_f32_kernel<D><<<grid, NTH, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, S, Skv, Hq, Hkv, bq, bk, causal, window, softcap, scale,
      qoff);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0: none. softcap <= 0: none.
// bq, bk: q rows a CTA owns and keys a softmax step takes (already clamped
// to S and Skv). kt, warps: the bf16 path's key sub-tile (32, 64, or 128
// for D <= 128) and warps a CTA; the f32 path takes kt = 64 and 8 warps.
// lse: null, or (B, Hq, S) f32 for each row's log-sum-exp (the backward's).
// q_offset >= 0: the position of q's first row.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o, void* lse_out,
                          int dtype, int B,
                          int S, int Skv, int Hq, int Hkv, int D, int causal, int window,
                          float softcap, float scale, int bq, int bk, int kt, int warps,
                          int qoff, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || bq <= 0 || bk <= 0 ||
      bq > S || bk > Skv || warps < 1 || warps > 8 || qoff < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (dtype == 0) {
    if (kt != BK || warps != NTH / 32) return cudaErrorInvalidValue;
    switch (D) {
      case 8: return launch_f32<8>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, bq, bk, causal, window, softcap, scale, qoff, st);
      case 16: return launch_f32<16>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, bq, bk, causal, window, softcap, scale, qoff, st);
      case 32: return launch_f32<32>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, bq, bk, causal, window, softcap, scale, qoff, st);
      case 64: return launch_f32<64>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, bq, bk, causal, window, softcap, scale, qoff, st);
      case 80: return launch_f32<80>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, bq, bk, causal, window, softcap, scale, qoff, st);
      case 128: return launch_f32<128>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, bq, bk, causal, window, softcap, scale, qoff, st);
      case 256: return launch_f32<256>(q, k, v, o, lse, B, S, Skv, Hq, Hkv, bq, bk, causal, window, softcap, scale, qoff, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (D) {
      case 8:
      case 16: return dispatch_kt<16>(kt, q, k, v, o, lse, B, S, Skv, Hq, Hkv, D, bq, bk, warps, causal, window, softcap, scale, qoff, st);
      case 32: return dispatch_kt<32>(kt, q, k, v, o, lse, B, S, Skv, Hq, Hkv, D, bq, bk, warps, causal, window, softcap, scale, qoff, st);
      case 64: return dispatch_kt<64>(kt, q, k, v, o, lse, B, S, Skv, Hq, Hkv, D, bq, bk, warps, causal, window, softcap, scale, qoff, st);
      // stablelm-3b's head dim: tiles of 96 columns, the last 16 zero-filled
      case 80: return dispatch_kt<96>(kt, q, k, v, o, lse, B, S, Skv, Hq, Hkv, D, bq, bk, warps, causal, window, softcap, scale, qoff, st);
      case 128: return dispatch_kt<128>(kt, q, k, v, o, lse, B, S, Skv, Hq, Hkv, D, bq, bk, warps, causal, window, softcap, scale, qoff, st);
      case 256: return dispatch_kt<256>(kt, q, k, v, o, lse, B, S, Skv, Hq, Hkv, D, bq, bk, warps, causal, window, softcap, scale, qoff, st);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
