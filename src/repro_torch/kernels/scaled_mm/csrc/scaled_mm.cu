// W8A8 scaled matrix product on Hopper: int8 x (M, K) times int8 w (K, N)
// with an exact int32 sum over K, then the dequant epilogue
//
//     out[r, c] = (float(acc[r, c]) * sx[r]) * sw[c]     -> out dtype
//
// Replaces _scaled_mm_kernel / scaled_mm_pallas of
// src/repro/kernels/scaled_mm/kernel.py (grid (M/bm, N/bn, K/bk), the K
// axis sequential with an int32 VMEM accumulator).
//
// What bounds it on an H100 SXM. At dbrx-132b width (M=1024, K=6144,
// N=10752) the product is 0.1353 Tops on 94.4 MB (int8 in, bf16 out), so
// the bound is 0.068 ms from operations at the 1979 TOPS int8 tensor-core
// peak. This first kernel does not reach for it: it sums with __dp4a on
// the integer units, a small fraction of that peak.
//
// Design (a first kernel that is right):
// - The sum must be exact: __dp4a multiplies four packed int8 pairs and
//   adds them to an int32, so any order of k gives the same bits.
// - One CTA owns each (bm, bn) block and walks the K axis in bk steps, in
//   order, as the TPU grid's sequential axis does: the launch grid is
//   (N/bn, M/bm) and the K/bk axis is the CTA's loop, so all three knobs
//   reach the launch. A CTA walks its block in 64 x 64 output sub-tiles;
//   within a bk step, k is staged 64 bytes at a time and masked at the
//   step's end.
// - x is staged row-major and w transposed, both with k contiguous, so a
//   thread reads 16 k of a row as one int4 and feeds four __dp4a; rows are
//   padded to 80 bytes, which keeps those reads free of bank conflicts.
// - The epilogue multiplies in the reference's order with explicit
//   round-to-nearest products, so the output can equal the plain version
//   bit for bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // rows and columns of an output sub-tile
constexpr int kKBytes = 64;     // k staged at a time
constexpr int kLd = kKBytes + 16;  // row stride of the staged tiles, bytes

template <typename O> __device__ __forceinline__ O from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

template <typename O>
__global__ void __launch_bounds__(kThreads)
scaled_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ sx, const float* __restrict__ sw, O* __restrict__ out,
                 int K, int N, int bm, int bn, int bk) {
  __shared__ __align__(16) int8_t xs[kTile * kLd];  // x[rows, k]
  __shared__ __align__(16) int8_t ws[kTile * kLd];  // w[k, cols] stored as [cols][k]

  const int m_blk = blockIdx.y * bm;
  const int n_blk = blockIdx.x * bn;
  const int n_k = K / bk;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty + 16 i
  const int tx = tid % 16;  // columns tx + 16 j

  for (int mt = 0; mt < bm; mt += kTile) {
    const int rows = min(kTile, bm - mt);
    for (int nt = 0; nt < bn; nt += kTile) {
      const int cols = min(kTile, bn - nt);
      int acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;

      for (int kb = 0; kb < n_k; ++kb) {  // the TPU kernel's sequential K axis
        const int k_end = (kb + 1) * bk;
        for (int k0 = kb * bk; k0 < k_end; k0 += kKBytes) {
          for (int i = tid; i < kTile * kKBytes; i += kThreads) {
            const int r = i / kKBytes, k = i % kKBytes;
            int8_t v = 0;
            if (r < rows && k0 + k < k_end) v = x[(size_t)(m_blk + mt + r) * K + k0 + k];
            xs[r * kLd + k] = v;
          }
          for (int i = tid; i < kKBytes * kTile; i += kThreads) {
            const int k = i / kTile, c = i % kTile;
            int8_t v = 0;
            if (c < cols && k0 + k < k_end) v = w[(size_t)(k0 + k) * N + n_blk + nt + c];
            ws[c * kLd + k] = v;
          }
          __syncthreads();
#pragma unroll
          for (int k = 0; k < kKBytes; k += 16) {
            int4 a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              a[i] = *reinterpret_cast<const int4*>(&xs[(ty + 16 * i) * kLd + k]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              b[j] = *reinterpret_cast<const int4*>(&ws[(tx + 16 * j) * kLd + k]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                int s = acc[i][j];
                s = __dp4a(a[i].x, b[j].x, s);
                s = __dp4a(a[i].y, b[j].y, s);
                s = __dp4a(a[i].z, b[j].z, s);
                s = __dp4a(a[i].w, b[j].w, s);
                acc[i][j] = s;
              }
          }
          __syncthreads();
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= rows) continue;
        const int row = m_blk + mt + r;
        const float s_row = sx[row];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          if (c >= cols) continue;
          const int col = n_blk + nt + c;
          const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), s_row), sw[col]);
          out[(size_t)row * N + col] = from_f32<O>(v);
        }
      }
    }
  }
}

template <typename O>
int launch(const void* x, const void* w, const void* sx, const void* sw, void* out, int M, int K,
           int N, int bm, int bn, int bk, cudaStream_t stream) {
  const dim3 grid(N / bn, M / bm);
  scaled_mm_kernel<O><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<O*>(out), K, N, bm, bn, bk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out_dtype: 0 float32, 1 bfloat16, 2 float16. x (M, K) and w (K, N) int8,
// sx (M,) and sw (N,) float32, out (M, N), all contiguous. bm, bn and bk
// divide M, N and K. Returns a cudaError_t.
int scaled_mm_forward(const void* x, const void* w, const void* sx, const void* sw, void* out,
                      int out_dtype, int M, int K, int N, int bm, int bn, int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return launch<float>(x, w, sx, sw, out, M, K, N, bm, bn, bk, s);
  if (out_dtype == 1) return launch<__nv_bfloat16>(x, w, sx, sw, out, M, K, N, bm, bn, bk, s);
  if (out_dtype == 2) return launch<__half>(x, w, sx, sw, out, M, K, N, bm, bn, bk, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
