// Pieces shared by the any-shape kernels (any_shape.cu: rows 1, 2;
// any_shape_bwd.cu: row 3; the shared memory limit and alignment test of
// rows 4-8), for sm_90a: a one-warp-a-row LayerNorm and a tensor-core
// product that takes any M, N, K and any row pitch (rows 1-3). Every size
// is a launch argument. Each translation unit that includes this gets its
// own copy (an anonymous namespace).
//  - ln_rows_kernel: one warp a row, two-pass, C any.
//  - any_gemm_kernel: C[z] = A[z] @ B[z % b_mod], one 64 x 64 tile a block
//    of 128 threads, K in steps of 32, mma.sync m16n8k16 (bf16 operands,
//    f32 sums) from padded shared tiles. Operands are staged 16 bytes a
//    thread where rows are 16-byte aligned and whole, else one element a
//    thread with zeros past the edges. The epilogue stores bf16 or f32, or
//    bf16(res + A B).
#pragma once

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using vmt::bf2f;
using vmt::round_bf16;

constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block can ask

// ---- LayerNorm, one warp a row

constexpr int kLnWarps = 8;

__global__ void __launch_bounds__(kLnWarps * 32) ln_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    bf16* __restrict__ y, size_t rows, int C) {
  const size_t row = (size_t)blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += bf2f(xr[c]);
  const float mu = vmt::warp_sum(s) / C;
  float q = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dv = bf2f(xr[c]) - mu;
    q += dv * dv;
  }
  const float rstd = rsqrtf(vmt::warp_sum(q) / C + vmt::kLnEps);
  bf16* yr = y + row * C;
  for (int c = lane; c < C; c += 32)
    yr[c] = __float2bfloat16((bf2f(xr[c]) - mu) * rstd * gamma[c]);
}

cudaError_t launch_ln(const bf16* x, const float* gamma, bf16* y, size_t rows,
                      int C, cudaStream_t st) {
  const size_t blocks = (rows + kLnWarps - 1) / kLnWarps;
  ln_rows_kernel<<<(unsigned)blocks, kLnWarps * 32, 0, st>>>(x, gamma, y, rows,
                                                            C);
  return cudaGetLastError();
}

// ---- C[z] = A[z] @ B[z % b_mod] on the tensor cores, with an epilogue

constexpr int kGM = 64, kGN = 64, kGK = 32;   // block tile
constexpr int kGAP = kGK + 8, kGBP = kGN + 8;  // padded pitches (bf16)
constexpr int kGThreads = 128;

enum Epilogue { kStoreBf16 = 0, kStoreF32 = 1, kResidual = 2 };

struct Gemm {
  const bf16* a;                 // A[z][m][k] at a + z a_batch + m lda + k
  size_t lda, a_batch;
  const bf16* b;                 // B[z % b_mod][k][n] at b + (z % b_mod) b_batch + k ldb + n
  size_t ldb, b_batch;
  int b_mod;
  void* c;                       // C[z][m][n], bf16 or f32
  size_t ldc, c_batch;
  const bf16* res;               // kResidual: bf16(res + A B)
  size_t ldr;
  int M, N, K;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int kEpi>
__global__ void __launch_bounds__(kGThreads) any_gemm_kernel(const Gemm g) {
  __shared__ __align__(16) bf16 as[kGM * kGAP];
  __shared__ __align__(16) bf16 bs[kGK * kGBP];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int m0 = blockIdx.x * kGM, n0 = blockIdx.y * kGN;
  const size_t z = blockIdx.z;
  const bf16* A = g.a + z * g.a_batch;
  const bf16* B = g.b + (z % g.b_mod) * g.b_batch;
  const bool vec_a = aligned16(A) && g.lda % 8 == 0;
  const bool vec_b = aligned16(B) && g.ldb % 8 == 0;
  const bf16 zero = __float2bfloat16(0.f);
  // warps: 2 x 2 of 32 x 32
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  float acc[2][4][4] = {};
  for (int k0 = 0; k0 < g.K; k0 += kGK) {
    // A: 64 rows x 32 columns as 256 chunks of 8
    for (int i = t; i < kGM * kGK / 8; i += kGThreads) {
      const int r = i / (kGK / 8), o = (i % (kGK / 8)) * 8;
      const int m = m0 + r, k = k0 + o;
      bf16* dst = as + r * kGAP + o;
      const bf16* src = A + (size_t)m * g.lda + k;
      if (vec_a && m < g.M && k + 8 <= g.K) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (m < g.M && k + e < g.K) ? src[e] : zero;
      }
    }
    // B: 32 rows x 64 columns as 256 chunks of 8
    for (int i = t; i < kGK * kGN / 8; i += kGThreads) {
      const int r = i / (kGN / 8), o = (i % (kGN / 8)) * 8;
      const int k = k0 + r, n = n0 + o;
      bf16* dst = bs + r * kGBP + o;
      const bf16* src = B + (size_t)k * g.ldb + n;
      if (vec_b && k < g.K && n + 8 <= g.N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (k < g.K && n + e < g.N) ? src[e] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kGK; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        vmt::ldsm_x4(a[mt], as + (wm + mt * 16 + vmt::a_row_off(lane)) * kGAP +
                                ks + vmt::a_col_off(lane));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bb[4];
        vmt::ldsm_x4_t(bb, bs + (ks + vmt::bk_row_off(lane)) * kGBP + wn +
                               np * 16 + vmt::bk_col_off(lane));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          vmt::mma_bf16(acc[mt][2 * np], a[mt], bb[0], bb[1]);
          vmt::mma_bf16(acc[mt][2 * np + 1], a[mt], bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }
  // accumulator (mt, nt): rows g and g + 8, columns 2 tq and 2 tq + 1
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mt * 16 + gq + 8 * half;
      if (m >= g.M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + nt * 8 + 2 * tq + e;
          if (n >= g.N) continue;
          const float v = acc[mt][nt][2 * half + e];
          const size_t idx = z * g.c_batch + (size_t)m * g.ldc + n;
          if (kEpi == kStoreF32) {
            static_cast<float*>(g.c)[idx] = v;
          } else if (kEpi == kStoreBf16) {
            static_cast<bf16*>(g.c)[idx] = __float2bfloat16(v);
          } else {
            const float r = bf2f(g.res[(size_t)m * g.ldr + n]);
            static_cast<bf16*>(g.c)[idx] = __float2bfloat16(r + v);
          }
        }
    }
}

cudaError_t launch_gemm(const Gemm& g, int batches, int epi, cudaStream_t st) {
  const dim3 grid((g.M + kGM - 1) / kGM, (g.N + kGN - 1) / kGN, batches);
  if (epi == kStoreBf16)
    any_gemm_kernel<kStoreBf16><<<grid, kGThreads, 0, st>>>(g);
  else if (epi == kStoreF32)
    any_gemm_kernel<kStoreF32><<<grid, kGThreads, 0, st>>>(g);
  else
    any_gemm_kernel<kResidual><<<grid, kGThreads, 0, st>>>(g);
  return cudaGetLastError();
}

Gemm gemm(const bf16* a, size_t lda, size_t a_batch, const bf16* b, size_t ldb,
          size_t b_batch, int b_mod, void* c, size_t ldc, size_t c_batch,
          int M, int N, int K) {
  Gemm g;
  g.a = a; g.lda = lda; g.a_batch = a_batch;
  g.b = b; g.ldb = ldb; g.b_batch = b_batch; g.b_mod = b_mod;
  g.c = c; g.ldc = ldc; g.c_batch = c_batch;
  g.res = nullptr; g.ldr = 0;
  g.M = M; g.N = N; g.K = K;
  return g;
}

}  // namespace
