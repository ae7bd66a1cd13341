// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces `_fa_kernel` / `flash_attention_pallas` of
// repro/kernels/flash_attention/kernel.py: FA2 online-softmax attention with
// GQA, causal / sliding-window / tanh-softcap masks, f32 running max, sum and
// accumulator, output acc / max(l, 1e-30). Positions of q and k both start
// at 0, also when S != Skv.
//
// Layout: q and o are (B, S, Hq, D), k and v (B, Skv, Hkv, D), contiguous;
// q head h reads kv head h / (Hq / Hkv). The kernel reads these strides
// directly, so no transposed copy is made.
//
// Design. One block of 256 threads owns one (batch, q head, 64-row q block)
// and loops over the 64-key tiles that block can see: the TPU kernel's
// sequential KV grid axis becomes this loop, and tiles that the causal or
// window mask removes entirely are never loaded. Each thread holds a 4x4
// patch of the score tile and a 4 x ceil(D/16) patch of the output rows
// (the same 4 rows), so the softmax statistics of a row live in the 16
// lanes that share it and are reduced with warp shuffles. Tiles sit in
// shared memory as f32 (q and k transposed, so a thread reads its 4 rows or
// 4 keys as one float4); every product is an IEEE f32 FMA, for f32 and bf16
// inputs alike, so f32 inputs meet a 2e-5 tolerance. Rows past S and keys
// past Skv are masked here, so no length has to divide the tile.
//
// What bounds it: at the main path's shapes, operations. This first version
// uses the f32 FMA units, not the tensor cores, so its time is several times
// the bf16 tensor-core bound; wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads: 16 (tx) x 16 (ty)
constexpr int QS = BQ + 4;    // row stride of q^T and p^T (keeps float4 alignment)
constexpr int KS = BK + 4;    // row stride of k^T
constexpr float MASKED = -1.0e30f;  // the reference's value for a masked score

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D> struct Smem {
  static constexpr int kv = (D * KS > BK * D) ? D * KS : BK * D;  // k^T, then v
  static constexpr size_t bytes = sizeof(float) * (D * QS + kv + BK * QS);
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) fa_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int S, int Skv, int Hq, int Hkv, int causal, int window,
    float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;                // [D][QS]
  float* kv = qT + D * QS;         // k^T [D][KS], later v [BK][D]
  float* pT = kv + Smem<D>::kv;    // [BK][QS]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * BQ;

  const size_t q_step = (size_t)Hq * D;   // elements between positions
  const size_t kv_step = (size_t)Hkv * D;
  const T* qb = q + ((size_t)b * S * Hq + h) * D;
  const T* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const T* vb = v + ((size_t)b * Skv * Hkv + hk) * D;
  T* ob = o + ((size_t)b * S * Hq + h) * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    qT[d * QS + r] = (q0 + r < S) ? to_f32(qb[(size_t)(q0 + r) * q_step + d]) : 0.f;
  }

  constexpr int DPT = (D + 15) / 16;  // output columns of a thread: tx + 16 c
  float acc[4][DPT];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = MASKED;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[r][c] = 0.f;
  }

  // the key range this q block can see; whole tiles outside it are skipped
  const int q_last = min(q0 + BQ, S) - 1;
  int k_begin = 0, k_end = Skv;
  if (causal) k_end = min(Skv, q_last + 1);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / BK) * BK;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // q^T is stored; the last tile's readers of kv and p^T are done
    for (int i = tid; i < BK * D; i += NT) {
      const int j = i / D, d = i % D;
      kv[d * KS + j] = (kt + j < Skv) ? to_f32(kb[(size_t)(kt + j) * kv_step + d]) : 0.f;
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
      const float4 bk = *reinterpret_cast<const float4*>(&kv[d * KS + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
    }

    float corr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty * 4 + r;
      float rmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = kt + tx * 4 + c;
        float x = s[r][c] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool keep = true;
        if (causal) keep = keep && kj <= qi;
        if (window > 0) keep = keep && kj > qi - window;
        // a key past Skv does not exist: -inf gives it weight 0 whatever m is
        x = (kj >= Skv) ? -INFINITY : (keep ? x : MASKED);
        s[r][c] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[r], rmax);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        psum += s[r][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      corr[r] = expf(m[r] - m_new);
      l[r] = corr[r] * l[r] + psum;
      m[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&pT[(tx * 4 + c) * QS + ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();  // k^T is no longer read; p^T is complete

    for (int i = tid; i < BK * D; i += NT) {
      const int j = i / D, d = i % D;
      kv[j * D + d] = (kt + j < Skv) ? to_f32(vb[(size_t)(kt + j) * kv_step + d]) : 0.f;
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
    if (qi >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = tx + 16 * c;
      if (D % 16 == 0 || col < D) ob[(size_t)qi * q_step + col] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                   int Skv, int Hq, int Hkv, int causal, int window, float softcap,
                   float scale, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  // the shared-memory opt-in is set once per device, so a launch that a
  // CUDA graph captures makes no call besides the launch itself
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const dim3 grid(B * Hq, (S + BQ - 1) / BQ);
  fa_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Skv, Hq, Hkv, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B,
                       int S, int Skv, int Hq, int Hkv, int causal, int window,
                       float softcap, float scale, cudaStream_t st) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, B, S, Skv, Hq, Hkv, causal, window, softcap, scale, st);
    case 16: return launch<T, 16>(q, k, v, o, B, S, Skv, Hq, Hkv, causal, window, softcap, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, B, S, Skv, Hq, Hkv, causal, window, softcap, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Skv, Hq, Hkv, causal, window, softcap, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Skv, Hq, Hkv, causal, window, softcap, scale, st);
    case 256: return launch<T, 256>(q, k, v, o, B, S, Skv, Hq, Hkv, causal, window, softcap, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0: none. softcap <= 0: none.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o, int dtype,
                          int B, int S, int Skv, int Hq, int Hkv, int D, int causal,
                          int window, float softcap, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, S, Skv, Hq, Hkv, causal, window, softcap, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, S, Skv, Hq, Hkv, causal, window, softcap,
                                     scale, st);
  return cudaErrorInvalidValue;
}
