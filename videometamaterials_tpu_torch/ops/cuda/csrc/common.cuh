// Helpers shared by the port's kernels (no PyTorch headers: the library is
// built by one plain nvcc command and bound with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vmt {

// The blocks of this slice run with hidden = heads * dim_head = 8 * 32.
constexpr int kHeads = 8;
constexpr int kD = 32;               // head dim == warp size
constexpr int kH = kHeads * kD;      // one thread per hidden column
constexpr int kThreads = kH;
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round-to-nearest-even to bf16 and back: the places where the JAX kernels
// cast to bf16
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// eight bf16 values packed in a uint4 -> floats (bf16 is the top half of
// an fp32 word, so the conversion is a shift)
__device__ __forceinline__ void unpack8(const uint4 v, float (&f)[8]) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
  f[4] = __uint_as_float(v.z << 16);
  f[5] = __uint_as_float(v.z & 0xffff0000u);
  f[6] = __uint_as_float(v.w << 16);
  f[7] = __uint_as_float(v.w & 0xffff0000u);
}

// two floats -> packed bf16x2 (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two-pass scale-only LayerNorm of one channels-last row of kC values by
// one warp; writes bf16-rounded LN(x) * gamma into y (shared memory).
// valid == false writes zeros (ragged edge of a tile).
template <int kC>
__device__ __forceinline__ void layer_norm_row(
    const __nv_bfloat16* __restrict__ xrow, const float* __restrict__ gamma,
    float* y, bool valid, int lane) {
  static_assert(kC % 32 == 0, "channels must be a multiple of 32");
  if (!valid) {
#pragma unroll
    for (int u = 0; u < kC / 32; ++u) y[lane + 32 * u] = 0.f;
    return;
  }
  float v[kC / 32];
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < kC / 32; ++u) {
    v[u] = bf2f(xrow[lane + 32 * u]);
    sum += v[u];
  }
  const float mu = warp_sum(sum) / kC;
  float sq = 0.f;
#pragma unroll
  for (int u = 0; u < kC / 32; ++u) {
    const float dv = v[u] - mu;
    sq += dv * dv;
  }
  const float rstd = rsqrtf(warp_sum(sq) / kC + kLnEps);
#pragma unroll
  for (int u = 0; u < kC / 32; ++u) {
    const int c = lane + 32 * u;
    y[c] = round_bf16((v[u] - mu) * rstd * gamma[c]);
  }
}

// layer_norm_row for a tile of rows of kC bf16 values in shared memory
// (row pitch `pitch` elements), in place, eight consecutive threads a row
// (thread t: row t / 8), so the block's rows run side by side. The sums
// take layer_norm_row's order bit for bit: thread j of a row plays lanes
// j, j + 8, j + 16 and j + 24 of its warp (each summing elements lane +
// 32 u in order), adds them as the first two steps of warp_sum's xor
// butterfly (16, then 8) and shuffles the last three (4, 2, 1) with the
// row's other seven threads; so the tile's y equals the warp version's.
// Rows >= valid_rows become 0.
template <int kC>
__device__ __forceinline__ void layer_norm_tile8(__nv_bfloat16* tile, int pitch,
                                                 const float* __restrict__ gamma,
                                                 int valid_rows, int t) {
  static_assert(kC % 32 == 0, "channels must be a multiple of 32");
  constexpr int kU = kC / 32;
  const int r = t >> 3, j = t & 7;
  __nv_bfloat16* row = tile + r * pitch;
  const bool valid = r < valid_rows;  // no early exit: the shuffles take
                                      // the whole warp
  // butterfly of the four played lanes' partials, then across the row
  auto row_sum = [](const float (&ps)[4]) {
    float s = (ps[0] + ps[2]) + (ps[1] + ps[3]);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
  };
  float v[4][kU], ps[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    ps[a] = 0.f;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      v[a][u] = bf2f(row[j + 8 * a + 32 * u]);
      ps[a] += v[a][u];
    }
  }
  const float mu = row_sum(ps) / kC;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    ps[a] = 0.f;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const float dv = v[a][u] - mu;
      ps[a] += dv * dv;
    }
  }
  const float rstd = rsqrtf(row_sum(ps) / kC + kLnEps);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int c = j + 8 * a + 32 * u;
      row[c] = __float2bfloat16(valid ? (v[a][u] - mu) * rstd * gamma[c] : 0.f);
    }
}
}  // namespace vmt
