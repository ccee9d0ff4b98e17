// The weight gradients of the any-shape backward kernels (rows 3, 6, 7:
// any_shape_bwd.cu, any_linear_bwd.cu), for sm_90a: out[g] = sum_rows
// A[g]^T B[g] at any M and N, a 64 x 64 output tile and a chunk of rows a
// block on the tensor cores (zero-filled staging, masked stores), then
// reduce.cu's ordered column sum over the chunks: no atomics, two launches
// give the same bits. Each translation unit that includes this gets its
// own copy (an anonymous namespace).
#pragma once

#include "any_shape.cuh"
#include "reduce.cuh"

namespace {

// row r of group g at p + g group + (r / seg) seg_stride + (r % seg) ld
struct Rows {
  const bf16* p;
  size_t group, seg_stride, ld;
  int seg;
};

__device__ __forceinline__ const bf16* row_ptr(const Rows& a, int g, int r) {
  return a.p + (size_t)g * a.group + (size_t)(r / a.seg) * a.seg_stride +
         (size_t)(r % a.seg) * a.ld;
}

constexpr int kCT = 64, kCSlab = 32, kCP = kCT + 8;
constexpr int kMaxChunks = 128;

// eight columns c.. of one row into shared memory, zeros past the row's
// end or past r_end
__device__ __forceinline__ void stage8(bf16* dst, const Rows& a, int g,
                                       int row, int r_end, int c, int cols) {
  const bf16 zero = __float2bfloat16(0.f);
  if (row >= r_end) {
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = zero;
    return;
  }
  const bf16* src = row_ptr(a, g, row) + c;
  if (c + 8 <= cols && aligned16(src)) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = c + e < cols ? src[e] : zero;
}

__global__ void __launch_bounds__(128) any_contract_partial(
    const Rows A, const Rows B, float* __restrict__ part, int rows, int M,
    int N, int per, int chunks) {
  __shared__ __align__(16) bf16 as[kCSlab * kCP];
  __shared__ __align__(16) bf16 bs[kCSlab * kCP];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int n0 = blockIdx.x * kCT, m0 = blockIdx.y * kCT;
  const int g = blockIdx.z / chunks, chunk = blockIdx.z % chunks;
  const int r_begin = chunk * per, r_end = min(rows, r_begin + per);
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  float acc[2][4][4] = {};
  for (int r0 = r_begin; r0 < r_end; r0 += kCSlab) {
    for (int i = t; i < kCSlab * kCT / 8; i += 128) {
      const int r = i / (kCT / 8), o = (i % (kCT / 8)) * 8;
      stage8(as + r * kCP + o, A, g, r0 + r, r_end, m0 + o, M);
      stage8(bs + r * kCP + o, B, g, r0 + r, r_end, n0 + o, N);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kCSlab; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        vmt::ldsm_x4_t(af[mt], as + (ks + vmt::at_row_off(lane)) * kCP + wm +
                                   mt * 16 + vmt::at_col_off(lane));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bb[4];
        vmt::ldsm_x4_t(bb, bs + (ks + vmt::bk_row_off(lane)) * kCP + wn +
                               np * 16 + vmt::bk_col_off(lane));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          vmt::mma_bf16(acc[mt][2 * np], af[mt], bb[0], bb[1]);
          vmt::mma_bf16(acc[mt][2 * np + 1], af[mt], bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }
  float* out = part + ((size_t)g * chunks + chunk) * M * N;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mt * 16 + gq + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + nt * 8 + 2 * tq + e;
          if (n < N) out[(size_t)m * N + n] = acc[mt][nt][2 * half + e];
        }
    }
}

int contract_chunks(int groups, int rows, int M, int N) {
  const int tiles = groups * ((M + kCT - 1) / kCT) * ((N + kCT - 1) / kCT);
  int chunks = (4 * 132 + tiles - 1) / tiles;
  chunks = std::min(chunks, (rows + 255) / 256);
  chunks = std::min(chunks, kMaxChunks);
  return std::max(chunks, 1);
}

size_t contract_ws(int groups, int rows, int M, int N) {
  return (size_t)groups * contract_chunks(groups, rows, M, N) * M * N *
         sizeof(float);
}

// out (groups, M, N) f32; ws: contract_ws() bytes
cudaError_t launch_contract(const Rows& A, const Rows& B, float* out,
                            int groups, int rows, int M, int N, float* ws,
                            cudaStream_t st) {
  const int chunks = contract_chunks(groups, rows, M, N);
  int per = (rows + chunks - 1) / chunks;
  per = (per + kCSlab - 1) / kCSlab * kCSlab;
  const dim3 grid((N + kCT - 1) / kCT, (M + kCT - 1) / kCT, groups * chunks);
  any_contract_partial<<<grid, 128, 0, st>>>(A, B, ws, rows, M, N, per,
                                             chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // chunks <= 128 rows: one ordered pass, no workspace
  return vmt::launch_colsum(ws, out, groups, chunks, M * N, nullptr, st);
}

Rows rows_of(const void* p, size_t ld, size_t group = 0, int seg = 1 << 30,
             size_t seg_stride = 0) {
  Rows r;
  r.p = static_cast<const bf16*>(p);
  r.group = group;
  r.seg_stride = seg_stride;
  r.ld = ld;
  r.seg = seg;
  return r;
}

}  // namespace
