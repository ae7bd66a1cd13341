// Fused MoE expert FFN backward on Hopper: for every expert e, with x (C,
// D), Wg and Wu (D, F), Wd (F, D) and the output gradient dy (C, D),
//
//     g = x Wg,  u = x Wu,  h = silu(g) u            (recomputed)
//     dh = dy Wd^T
//     dg = dh u silu'(g),  du = dh silu(g)
//     dWd = h^T dy,  dWg = x^T dg,  dWu = x^T du
//     dx = dg Wg^T + du Wu^T                          (one product, K = 2F)
//
// The backward of _moe_kernel / fused_moe_pallas of
// src/repro/kernels/fused_moe/kernel.py, which has none of its own (the
// reference differentiates its plain products): the port trains through its
// forward kernel (fused_moe.cu), so this is that kernel's backward.
//
// This engine takes the calls whose rows or bases TMA cannot address (f32
// D or F not a multiple of 4 values, bf16 not of 8, a base off 16 bytes),
// which no model config's widths reach; bf16 and f32 with 16-byte rows run
// on fused_moe_bwd_wgmma.cu and fused_moe_bwd_tf32.cu, the same four
// launches on wgmma fed by TMA (kernel.bwd_engine chooses).
//
// What bounds it on an H100 SXM. At dbrx-132b's training shape (E=16, 640
// rows an expert from 2048 tokens, D=6144, F=10752) the products are eight
// of 2 x 640 x 6144 x 10752 operations an expert (g, u, dh, the three
// weight gradients, and dx over K = 2F): 10.8 TFLOP, 10.9 ms at the bf16
// tensor-core peak, against 13.1 GB of weights, their gradients and rows
// moved (3.9 ms at 3.35 TB/s); operations bound it. f32 inputs take 3xTF32
// products, as the forward does (the reference's 2e-5 rules out plain TF32).
//
// Design: one grouped-GEMM kernel, templated on the operands' layouts and
// on its epilogue, launched four times behind one wrapper call:
//   (1) [g | u] = x [Wg | Wu]        NN, f32 g and u into workspaces;
//   (2) dh = dy Wd^T                 NT; its epilogue reads g and u and
//       writes h, dg and du (the silu-mul backward, fused);
//   (3) dWd = h^T dy, dWg = x^T dg, dWu = x^T du   TN, one launch whose grid
//       z axis walks (expert, product);
//   (4) dx = [dg | du] [Wg | Wu]^T   NT over two K segments.
// A CTA owns a 128 x 128 output tile and walks the whole K dimension in
// order, so every sum runs in one fixed order: no atomics, and reruns are
// bit-equal. 8 warps as 2 (rows) x 4 (columns), each a 64 x 32 tile of the
// accumulator; K tiles (64 deep for bf16, 32 for f32) come into a ring of
// three shared-memory stages by cp.async while the tensor cores work on
// the oldest. A transposed operand is staged as it lies in device memory
// (16-byte copies along its contiguous dim) and read by the transposing
// ldmatrix (bf16) or by transposed indexing (f32), so no pass transposes.
// bf16: mma.sync.m16n8k16 with f32 accumulation; h, dg and du are rounded
// to bf16 between the launches, as the forward rounds h. f32: 3xTF32 on
// mma.sync.m16n8k8, each stage's sum promoted into an IEEE f32 total (the
// forward's scheme). Ragged edges load as zeros and are not stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr int MT = 128;        // rows of a CTA tile
constexpr int NT = 128;        // columns of a CTA tile
constexpr int kMaxDevices = 64;

template <typename T> struct Cfg;
// KS: k depth of a pipeline stage; CH: values in 16 bytes; a shared row of
// KS values is padded by PK values and one of 128 by PW, so that fragment
// loads are conflict-free. bf16's kernels are held to 128 registers, so that
// two CTAs share an SM (the forward's choice); f32's are not.
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int KS = 64, STAGES = 3, PK = 8, PW = 8, CH = 8, CTAS = 2;
  static constexpr bool PROMOTE = false;
};
template <> struct Cfg<float> {
  static constexpr int KS = 32, STAGES = 3, PK = 4, PW = 8, CH = 4, CTAS = 1;
  static constexpr bool PROMOTE = true;
};

// Shared tiles: A is (MT x KS) row-major, or (KS x MT) when transposed; B
// (KS x NT), or (NT x KS) when transposed.
template <typename T, bool AT> __host__ __device__ constexpr int a_ld() {
  return AT ? MT + Cfg<T>::PW : Cfg<T>::KS + Cfg<T>::PK;
}
template <typename T, bool BT> __host__ __device__ constexpr int b_ld() {
  return BT ? Cfg<T>::KS + Cfg<T>::PK : NT + Cfg<T>::PW;
}
template <typename T, bool AT> __host__ __device__ constexpr int a_elems() {
  return (AT ? Cfg<T>::KS : MT) * a_ld<T, AT>();
}
template <typename T, bool BT> __host__ __device__ constexpr int b_elems() {
  return (BT ? NT : Cfg<T>::KS) * b_ld<T, BT>();
}
template <typename T, bool AT, bool BT> __host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * Cfg<T>::STAGES * (size_t)(a_elems<T, AT>() + b_elems<T, BT>());
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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
template <int N> __device__ __forceinline__ void cp_async_wait() {
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
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x = hi + lo with hi = tf32(x), lo = tf32(x - hi), low 13 bits cleared
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  hi &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
  lo &= 0xffffe000u;
}

// ---------------------------------------------------------------- the problem

// One product of each expert: out (M x N, row-major, ldo) = sum over the K
// segments s of A_s (M x K) B_s (K x N). A_s[m][k] is a[s][m * lda + k], or
// a[s][k * lda + m] when transposed; B_s[k][n] is b[s][k * ldb + n], or
// b[s][n * ldb + k] when transposed. Expert e's operands start e * a_e,
// e * b_e and e * o_e values further on.
struct Gemm {
  const void* a[2];
  const void* b[2];
  void* out;
  long long a_e, b_e, o_e;
  int lda, ldb, ldo, M, N, K, nseg;
};

// Epilogues: store the f32 sum (1); the silu-mul backward of dh (2); store
// the sum in the inputs' type (3).
enum { EPI_F32 = 1, EPI_SWIGLU = 2, EPI_STORE = 3 };

struct Launch {
  Gemm g[3];
  int nprod;  // products an expert: blockIdx.z = e * nprod + product
  int vec;    // every row and base is a 16-byte multiple: tiles by cp.async
  // EPI_SWIGLU: the f32 g and u of launch (1), and h, dg, du (E, C, F)
  const float* gw;
  const float* uw;
  void* h;
  void* dg;
  void* du;
};

// Stage tile i of the walk (K segment i / tps, its (i % tps)-th KS step)
// into sA and sB.
template <typename T, bool AT, bool BT>
__device__ __forceinline__ void load_tile(const Gemm& p, int e, int m0, int n0, int i, int vec,
                                          T* sA, T* sB) {
  constexpr int KS = Cfg<T>::KS, CH = Cfg<T>::CH;
  const int tps = (p.K + KS - 1) / KS;
  const int s = i / tps, k0 = (i % tps) * KS;
  const T* a = static_cast<const T*>(p.a[s]) + (size_t)e * p.a_e;
  const T* b = static_cast<const T*>(p.b[s]) + (size_t)e * p.b_e;
  // a tile of R rows x L values: global row r0 + r, column c0 + c, valid
  // below (rlim, clim), into dst with row stride LD
  auto tile = [&](T* dst, int LD, const T* src, int ld, int R, int L, int r0, int c0, int rlim,
                  int clim) {
    if (vec) {
      const int cpr = L / CH;
      for (int c = threadIdx.x; c < R * cpr; c += kThreads) {
        const int r = c / cpr, cc = (c % cpr) * CH;
        const int n = (r0 + r < rlim) ? min(CH, clim - c0 - cc) : 0;
        const T* g = n > 0 ? src + (size_t)(r0 + r) * ld + c0 + cc : src;
        cp_async16(smem_u32(dst + r * LD + cc), g, n > 0 ? n * (int)sizeof(T) : 0);
      }
    } else {
      for (int c = threadIdx.x; c < R * L; c += kThreads) {
        const int r = c / L, cc = c % L;
        const bool ok = r0 + r < rlim && c0 + cc < clim;
        dst[r * LD + cc] = ok ? src[(size_t)(r0 + r) * ld + c0 + cc] : from_f32<T>(0.f);
      }
    }
  };
  constexpr int LA = a_ld<T, AT>(), LB = b_ld<T, BT>();
  if (AT) tile(sA, LA, a, p.lda, KS, MT, k0, m0, p.K, p.M);
  else tile(sA, LA, a, p.lda, MT, KS, m0, k0, p.M, p.K);
  if (BT) tile(sB, LB, b, p.ldb, NT, KS, n0, k0, p.N, p.K);
  else tile(sB, LB, b, p.ldb, KS, NT, k0, n0, p.K, p.N);
}

// acc += one stage's A (MT x KS) B (KS x NT) for this warp's 64 x 32 tile
template <bool AT, bool BT>
__device__ __forceinline__ void mma_stage(float (&acc)[4][4][4], const __nv_bfloat16* sA,
                                          const __nv_bfloat16* sB, int wm, int wn, int lane) {
  using T = __nv_bfloat16;
  constexpr int KS = Cfg<T>::KS, LA = a_ld<T, AT>(), LB = b_ld<T, BT>();
#pragma unroll
  for (int kk = 0; kk < KS / 16; ++kk) {
    uint32_t a[4][4], b[2][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int m = wm * 64 + mi * 16;
      if (AT)
        ldsm_x4_t(a[mi], smem_u32(sA + (kk * 16 + (lane % 8) + (lane / 16) * 8) * LA + m +
                                  ((lane / 8) % 2) * 8));
      else
        ldsm_x4(a[mi], smem_u32(sA + (m + (lane % 8) + ((lane / 8) % 2) * 8) * LA + kk * 16 +
                                (lane / 16) * 8));
    }
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
      const int n = wn * 32 + n2 * 16;
      if (BT)
        ldsm_x4(b[n2], smem_u32(sB + (n + (lane % 8) + (lane / 16) * 8) * LB + kk * 16 +
                                ((lane / 8) % 2) * 8));
      else
        ldsm_x4_t(b[n2], smem_u32(sB + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LB + n +
                                  (lane / 16) * 8));
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        mma_bf16(acc[mi][2 * n2], a[mi], b[n2][0], b[n2][1]);
        mma_bf16(acc[mi][2 * n2 + 1], a[mi], b[n2][2], b[n2][3]);
      }
  }
}

template <bool AT, bool BT>
__device__ __forceinline__ void mma_stage(float (&acc)[4][4][4], const float* sA, const float* sB,
                                          int wm, int wn, int lane) {
  constexpr int KS = Cfg<float>::KS, LA = a_ld<float, AT>(), LB = b_ld<float, BT>();
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int kk = 0; kk < KS / 8; ++kk) {
    uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int m = wm * 64 + mi * 16 + g, k = kk * 8 + c;
      float v[4];
      if (AT) {
        const float* p = sA + k * LA + m;
        v[0] = p[0], v[1] = p[8], v[2] = p[4 * LA], v[3] = p[4 * LA + 8];
      } else {
        const float* p = sA + m * LA + k;
        v[0] = p[0], v[1] = p[8 * LA], v[2] = p[4], v[3] = p[8 * LA + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(v[j], ah[mi][j], al[mi][j]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = wn * 32 + ni * 8 + g, k = kk * 8 + c;
      float v0, v1;
      if (BT) {
        v0 = sB[n * LB + k];
        v1 = sB[n * LB + k + 4];
      } else {
        v0 = sB[k * LB + n];
        v1 = sB[(k + 4) * LB + n];
      }
      split_tf32(v0, bh[ni][0], bl[ni][0]);
      split_tf32(v1, bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        mma_tf32(acc[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
        mma_tf32(acc[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
        mma_tf32(acc[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
      }
  }
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <typename T>
__device__ __forceinline__ void store_one(void* base, size_t at, float v) {
  static_cast<T*>(base)[at] = from_f32<T>(v);
}

template <typename T, bool AT, bool BT, int EPI>
__global__ void __launch_bounds__(kThreads, Cfg<T>::CTAS)
    moe_bwd_gemm(const __grid_constant__ Launch L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ST = Cfg<T>::STAGES, KS = Cfg<T>::KS, AE = a_elems<T, AT>(),
                BE = b_elems<T, BT>();
  constexpr bool PROMOTE = Cfg<T>::PROMOTE;
  T* sA = reinterpret_cast<T*>(smem_raw);
  T* sB = sA + ST * AE;
  const int prod = blockIdx.z % L.nprod, e = blockIdx.z / L.nprod;
  const Gemm& p = L.g[prod];
  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * NT;
  if (m0 >= p.M || n0 >= p.N) return;  // the grid covers the largest product
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int ntiles = p.nseg * ((p.K + KS - 1) / KS);

  float total[4][4][4], part[PROMOTE ? 4 : 1][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) total[mi][ni][j] = 0.f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < ntiles) load_tile<T, AT, BT>(p, e, m0, n0, s, L.vec, sA + s * AE, sB + s * BE);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // tile i has landed for every thread; tile i-1's stage is free
    const int nx = i + ST - 1;
    if (nx < ntiles)
      load_tile<T, AT, BT>(p, e, m0, n0, nx, L.vec, sA + (nx % ST) * AE, sB + (nx % ST) * BE);
    cp_async_commit();
    const int st = i % ST;
    if constexpr (PROMOTE) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[mi][ni][j] = 0.f;
      mma_stage<AT, BT>(part, sA + st * AE, sB + st * BE, wm, wn, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) total[mi][ni][j] += part[mi][ni][j];
    } else {
      mma_stage<AT, BT>(total, sA + st * AE, sB + st * BE, wm, wn, lane);
    }
  }
  cp_async_wait<0>();

  // element (r, c) of the tile: r = wm*64 + mi*16 + lane/4 + 8*(j/2),
  // c = wn*32 + ni*8 + 2*(lane%4) + j%2
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = m0 + wm * 64 + mi * 16 + lane / 4 + 8 * (j / 2);
        const int c = n0 + wn * 32 + ni * 8 + 2 * (lane % 4) + j % 2;
        if (r >= p.M || c >= p.N) continue;
        const size_t at = (size_t)e * p.o_e + (size_t)r * p.ldo + c;
        const float v = total[mi][ni][j];
        if constexpr (EPI == EPI_F32) {
          static_cast<float*>(p.out)[at] = v;
        } else if constexpr (EPI == EPI_STORE) {
          store_one<T>(p.out, at, v);
        } else {  // v is dh; g and u are launch (1)'s, laid out as dh
          const float g = L.gw[at], u = L.uw[at], s = sigmoid(g), act = g * s;
          store_one<T>(L.h, at, act * u);
          store_one<T>(L.dg, at, v * u * s * (1.f + g * (1.f - s)));
          store_one<T>(L.du, at, v * act);
        }
      }
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem, size_t* configured) {
  // raise a kernel's shared-memory limit once per device, so a launch being
  // captured into a CUDA graph makes no attribute call
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured[dev] = smem;
  }
  return cudaSuccess;
}

template <typename T, bool AT, bool BT, int EPI>
cudaError_t run(const Launch& L, int E, cudaStream_t stream) {
  static size_t configured[kMaxDevices] = {};
  constexpr size_t smem = smem_bytes<T, AT, BT>();
  cudaError_t err = opt_in(moe_bwd_gemm<T, AT, BT, EPI>, smem, configured);
  if (err != cudaSuccess) return err;
  int mt = 0, nt = 0;
  for (int i = 0; i < L.nprod; ++i) {
    mt = std::max(mt, (L.g[i].M + MT - 1) / MT);
    nt = std::max(nt, (L.g[i].N + NT - 1) / NT);
  }
  moe_bwd_gemm<T, AT, BT, EPI><<<dim3(mt, nt, E * L.nprod), kThreads, smem, stream>>>(L);
  return cudaGetLastError();
}

Gemm gemm(const void* a0, const void* a1, const void* b0, const void* b1, void* out,
          long long a_e, long long b_e, long long o_e, int lda, int ldb, int ldo, int M, int N,
          int K, int nseg) {
  Gemm g;
  g.a[0] = a0, g.a[1] = a1, g.b[0] = b0, g.b[1] = b1, g.out = out;
  g.a_e = a_e, g.b_e = b_e, g.o_e = o_e;
  g.lda = lda, g.ldb = ldb, g.ldo = ldo, g.M = M, g.N = N, g.K = K, g.nseg = nseg;
  return g;
}

template <typename T>
int backward(const void* x, const void* wg, const void* wu, const void* wd, const void* dy,
             float* gw, float* uw, void* h, void* dg, void* du, void* dx, void* dwg, void* dwu,
             void* dwd, int E, int C, int D, int F, int vec, cudaStream_t s) {
  const long long CD = (long long)C * D, DF = (long long)D * F, CF = (long long)C * F;
  Launch L = {};
  L.vec = vec;
  // (1) g = x Wg, u = x Wu: (C x F) over K = D
  L.nprod = 2;
  L.g[0] = gemm(x, x, wg, wg, gw, CD, DF, CF, D, F, F, C, F, D, 1);
  L.g[1] = gemm(x, x, wu, wu, uw, CD, DF, CF, D, F, F, C, F, D, 1);
  cudaError_t err = run<T, false, false, EPI_F32>(L, E, s);
  if (err != cudaSuccess) return (int)err;
  // (2) dh = dy Wd^T: (C x F) over K = D; Wd (F, D) is B transposed
  L.nprod = 1;
  L.g[0] = gemm(dy, dy, wd, wd, nullptr, CD, DF, CF, D, D, F, C, F, D, 1);
  L.gw = gw, L.uw = uw, L.h = h, L.dg = dg, L.du = du;
  err = run<T, false, true, EPI_SWIGLU>(L, E, s);
  if (err != cudaSuccess) return (int)err;
  // (3) dWd = h^T dy (F x D), dWg = x^T dg, dWu = x^T du (D x F), over K = C
  L.nprod = 3;
  L.g[0] = gemm(h, h, dy, dy, dwd, CF, CD, DF, F, D, D, F, D, C, 1);
  L.g[1] = gemm(x, x, dg, dg, dwg, CD, CF, DF, D, F, F, D, F, C, 1);
  L.g[2] = gemm(x, x, du, du, dwu, CD, CF, DF, D, F, F, D, F, C, 1);
  err = run<T, true, false, EPI_STORE>(L, E, s);
  if (err != cudaSuccess) return (int)err;
  // (4) dx = dg Wg^T + du Wu^T: (C x D) over two K segments of F
  L.nprod = 1;
  L.g[0] = gemm(dg, du, wg, wu, dx, CF, DF, CD, F, F, D, C, D, F, 2);
  return (int)run<T, false, true, EPI_STORE>(L, E, s);
}

}  // namespace

extern "C" {

// Shared bytes a CTA of each of the four launches takes, for dtype (0
// float32, 1 bfloat16) and launch 0..3 (kernel.bwd_launch_plan computes
// the same).
long long fused_moe_bwd_smem_bytes(int dtype, int launch) {
  static const size_t f32[4] = {smem_bytes<float, false, false>(), smem_bytes<float, false, true>(),
                                smem_bytes<float, true, false>(), smem_bytes<float, false, true>()};
  static const size_t b16[4] = {
      smem_bytes<__nv_bfloat16, false, false>(), smem_bytes<__nv_bfloat16, false, true>(),
      smem_bytes<__nv_bfloat16, true, false>(), smem_bytes<__nv_bfloat16, false, true>()};
  if (launch < 0 || launch > 3) return -1;
  return (long long)(dtype == 0 ? f32[launch] : b16[launch]);
}

// dtype: 0 float32, 1 bfloat16. x and dy (E, C, D), wg/wu (E, D, F), wd
// (E, F, D); dx, dwg, dwu, dwd shaped as x, wg, wu, wd; all contiguous of
// that type. Workspaces: gw, uw (E, C, F) f32; h, dg, du (E, C, F) of the
// type. vec: every row and base is a 16-byte multiple. Four launches on
// `stream`, in order. Returns a cudaError_t.
int fused_moe_backward(const void* x, const void* wg, const void* wu, const void* wd,
                       const void* dy, void* gw, void* uw, void* h, void* dg, void* du, void* dx,
                       void* dwg, void* dwu, void* dwd, int dtype, int E, int C, int D, int F,
                       int vec, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(gw);
  float* u = static_cast<float*>(uw);
  if (dtype == 0)
    return backward<float>(x, wg, wu, wd, dy, g, u, h, dg, du, dx, dwg, dwu, dwd, E, C, D, F, vec,
                           s);
  if (dtype == 1)
    return backward<__nv_bfloat16>(x, wg, wu, wd, dy, g, u, h, dg, du, dx, dwg, dwu, dwd, E, C,
                                   D, F, vec, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
