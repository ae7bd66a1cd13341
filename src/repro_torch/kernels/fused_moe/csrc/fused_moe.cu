// Fused MoE expert FFN on Hopper: for every expert e over its gathered
// token block x_e (capacity C),
//
//     y_e = (silu(x_e @ w_gate[e]) * (x_e @ w_up[e])) @ w_down[e]
//
// Replaces _moe_kernel / fused_moe_pallas of
// src/repro/kernels/fused_moe/kernel.py (grid (E, C/block_m, F/block_f),
// the down-projection summed over the sequential F axis in a (block_m, D)
// f32 VMEM accumulator).
//
// What bounds it on an H100 SXM. At dbrx-132b width (E=16, C=256, D=6144,
// F=10752) the three products are 1.6235 TFLOP. With f32 inputs (the
// tuner's) they move 12.88 GB, and every product has to be an IEEE f32 FMA
// to meet the reference's 2e-5 (TF32 keeps ~3 digits), so the bound is
// 24.2 ms from operations at 67 TFLOP/s. With bf16 inputs the same work
// moves 6.44 GB: 1.92 ms at 3.35 TB/s against 1.64 ms of bf16 tensor-core
// work, so a bf16 kernel at C=256 is bounded by reading the expert weights.
//
// Design (a first kernel that is right, on the FMA units in f32):
// - The TPU's (block_m, D) f32 accumulator does not fit: at D=6144 even
//   block_m=32 needs 786 KB, against 227 KB of shared memory a block. So
//   the sum over F lives in an f32 workspace in device memory that the
//   wrapper allocates, and one CTA owns each (expert, block_m rows) block
//   and walks the F axis in order: no atomics, the same sum on every run.
// - The launch grid is (C/block_m, E); the F/block_f axis is the CTA's
//   sequential loop, as on the TPU, so both knobs reach the launch.
// - A CTA walks its block in 32-row sub-tiles. For each F block it computes
//   h = silu(x Wg) * (x Wu) for (32 rows, block_f) into shared memory
//   (kept transposed), then adds h @ Wd[F block] into the workspace in
//   128-column slices of D; the last F block writes the output in x's type.
// - Every tile is staged through shared memory as f32 and every product is
//   an fmaf; a thread owns a 4 x 4 patch of each output sub-tile. Ragged
//   edges (rows past block_m, columns past block_f or D, k past D) load as
//   zeros, so any block that divides its dimension works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;          // rows of a sub-tile
constexpr int kCols = 128;         // columns of a sub-tile (F in phase A, D in phase B)
constexpr int kChunk = 32;         // reduction depth staged at a time
constexpr int kXld = kRows + 4;    // row stride of the transposed x chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

size_t smem_bytes(int bf) {
  const size_t h_rows = (size_t)((bf + kCols - 1) / kCols) * kCols;
  return sizeof(float) * (kChunk * kXld + 2 * kChunk * kCols + h_rows * kRows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_moe_kernel(const T* __restrict__ x, const T* __restrict__ wg, const T* __restrict__ wu,
                 const T* __restrict__ wd, float* __restrict__ acc, T* __restrict__ out,
                 int C, int D, int F, int bm, int bf) {
  extern __shared__ float4 smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [kChunk][kXld]: x chunk, transposed
  float* w0 = xs + kChunk * kXld;                  // [kChunk][kCols]: Wg chunk, then Wd chunk
  float* w1 = w0 + kChunk * kCols;                 // [kChunk][kCols]: Wu chunk
  float* hs = w1 + kChunk * kCols;                 // [round_up(bf, kCols)][kRows]: h, transposed

  const int e = blockIdx.y;
  const int m0 = blockIdx.x * bm;
  const int n_f = F / bf;
  const int tid = threadIdx.x;
  const int tx = tid % 32;  // 4 columns each
  const int ty = tid / 32;  // 4 rows each

  const T* xe = x + (size_t)e * C * D;
  const T* wge = wg + (size_t)e * D * F;
  const T* wue = wu + (size_t)e * D * F;
  const T* wde = wd + (size_t)e * F * D;
  float* acce = acc + (size_t)e * C * D;
  T* oute = out + (size_t)e * C * D;

  for (int r0 = 0; r0 < bm; r0 += kRows) {
    const int rows = min(kRows, bm - r0);
    const size_t row0 = (size_t)(m0 + r0);
    for (int jf = 0; jf < n_f; ++jf) {  // the TPU kernel's sequential F axis
      const int f0 = jf * bf;

      // phase A: h = silu(x Wg) * (x Wu) for (rows, bf), into shared memory
      for (int c0 = 0; c0 < bf; c0 += kCols) {
        float g[4][4], u[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = u[i][j] = 0.0f;
        for (int k0 = 0; k0 < D; k0 += kChunk) {
          for (int i = tid; i < kRows * kChunk; i += kThreads) {
            const int r = i / kChunk, k = i % kChunk;
            float v = 0.0f;
            if (r < rows && k0 + k < D) v = to_f32(xe[(row0 + r) * D + k0 + k]);
            xs[k * kXld + r] = v;
          }
          for (int i = tid; i < kChunk * kCols; i += kThreads) {
            const int k = i / kCols, c = i % kCols;
            float a = 0.0f, b = 0.0f;
            if (k0 + k < D && c0 + c < bf) {
              const size_t off = (size_t)(k0 + k) * F + f0 + c0 + c;
              a = to_f32(wge[off]);
              b = to_f32(wue[off]);
            }
            w0[i] = a;
            w1[i] = b;
          }
          __syncthreads();
#pragma unroll 8
          for (int k = 0; k < kChunk; ++k) {
            const float4 xv = *reinterpret_cast<const float4*>(&xs[k * kXld + ty * 4]);
            const float4 gv = *reinterpret_cast<const float4*>(&w0[k * kCols + tx * 4]);
            const float4 uv = *reinterpret_cast<const float4*>(&w1[k * kCols + tx * 4]);
            const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
            const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
            const float ua[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                g[i][j] = fmaf(xa[i], ga[j], g[i][j]);
                u[i][j] = fmaf(xa[i], ua[j], u[i][j]);
              }
          }
          __syncthreads();
        }
        // columns past bf and rows past `rows` loaded zeros: their h is 0
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float4 hv;
          hv.x = silu(g[0][j]) * u[0][j];
          hv.y = silu(g[1][j]) * u[1][j];
          hv.z = silu(g[2][j]) * u[2][j];
          hv.w = silu(g[3][j]) * u[3][j];
          *reinterpret_cast<float4*>(&hs[(c0 + tx * 4 + j) * kRows + ty * 4]) = hv;
        }
      }
      __syncthreads();

      // phase B: acc[rows, :] += h (rows, bf) @ Wd[f0:f0+bf, :], by 128 columns
      for (int d0 = 0; d0 < D; d0 += kCols) {
        float o[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = 0.0f;
        for (int k0 = 0; k0 < bf; k0 += kChunk) {
          for (int i = tid; i < kChunk * kCols; i += kThreads) {
            const int k = i / kCols, c = i % kCols;
            float v = 0.0f;
            if (k0 + k < bf && d0 + c < D) v = to_f32(wde[(size_t)(f0 + k0 + k) * D + d0 + c]);
            w0[i] = v;
          }
          __syncthreads();
#pragma unroll 8
          for (int k = 0; k < kChunk; ++k) {
            const float4 hv = *reinterpret_cast<const float4*>(&hs[(k0 + k) * kRows + ty * 4]);
            const float4 wv = *reinterpret_cast<const float4*>(&w0[k * kCols + tx * 4]);
            const float ha[4] = {hv.x, hv.y, hv.z, hv.w};
            const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) o[i][j] = fmaf(ha[i], wa[j], o[i][j]);
          }
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
          if (r >= rows) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int d = d0 + tx * 4 + j;
            if (d >= D) continue;
            const size_t off = (row0 + r) * D + d;
            float v = o[i][j];
            if (jf > 0) v = acce[off] + v;  // the accumulator, in F order
            if (jf == n_f - 1) {
              oute[off] = from_f32<T>(v);
            } else {
              acce[off] = v;
            }
          }
        }
      }
      __syncthreads();  // hs is rewritten for the next F block
    }
  }
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd, void* acc, void* out,
           int E, int C, int D, int F, int bm, int bf, cudaStream_t stream) {
  // raise the kernel's shared-memory limit once per device and size, so a
  // launch being captured into a CUDA graph makes no attribute call
  constexpr int kMaxDevices = 64;
  static size_t configured[kMaxDevices] = {};
  const size_t smem = smem_bytes(bf);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > configured[dev]) {
    err = cudaFuncSetAttribute(fused_moe_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = smem;
  }
  const dim3 grid(C / bm, E);
  fused_moe_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<const T*>(wd), static_cast<float*>(acc), static_cast<T*>(out), C, D, F, bm, bf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA takes for block_f = bf (the wrapper checks it
// against the card's 227 KB before launching).
long long fused_moe_smem_bytes(int bf) { return (long long)smem_bytes(bf); }

// dtype: 0 float32, 1 bfloat16. x (E, C, D), wg/wu (E, D, F), wd (E, F, D),
// out (E, C, D), all contiguous of that type; acc an (E, C, D) f32
// workspace. bm divides C and bf divides F. Returns a cudaError_t.
int fused_moe_forward(const void* x, const void* wg, const void* wu, const void* wd, void* acc,
                      void* out, int dtype, int E, int C, int D, int F, int bm, int bf,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, wg, wu, wd, acc, out, E, C, D, F, bm, bf, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, wg, wu, wd, acc, out, E, C, D, F, bm, bf, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
