// The attention of one position and one head on the tensor cores, shared
// by the temporal forward and backward kernels.
//
// Per spatial position the temporal attention of a head is a set of
// products of at most 16 x 32 x 32: the F = 11 query frames (rows, padded
// to 16) against the F frames and T <= 11 conditioning tokens (keys,
// padded to 32) over the head's d = 32 features. One warp computes them
// with mma.sync m16n8k16: the operand rows are gathered by the per-lane
// row addresses of ldmatrix (a frame's q/k/v/g_acc row of the block's head
// tile, a token row, or a zero row for the padding), so no operand is
// copied. Score and weight fragments stay in registers; the softmax over
// the keys of a row reduces over the four lanes that hold the row (two
// shuffles a row, none a score).
#pragma once

#include "mma.cuh"

namespace vmt {

constexpr int kTokP = kD + 8;  // pitch (bf16) of the token rows and zero row

// Row addresses of one position's operands. The head tile holds, per frame
// and position, a row of kHP bf16: q (part 0), k (1), v (2) and, in the
// backward, g_acc (3), 32 each; the token rows of ek and ev (T x kTokP) and
// a zero row lie beside it.
template <int kF, int kT, int kP, int kHP>
struct PositionRows {
  const __nv_bfloat16* hs;
  const __nv_bfloat16* ekb;
  const __nv_bfloat16* evb;
  const __nv_bfloat16* zrow;
  int p;
  // query frame i's row of `part` (rows >= F: zeros)
  __device__ __forceinline__ const __nv_bfloat16* frame(int i, int part) const {
    return i < kF ? hs + (i * kP + p) * kHP + part * kD : zrow;
  }
  // key j's row: frames, then tokens (ek for part 1, ev for part 2), then
  // zeros
  __device__ __forceinline__ const __nv_bfloat16* key(int j, int part) const {
    if (j < kF) return hs + (j * kP + p) * kHP + part * kD;
    if (j < kF + kT) return (part == 1 ? ekb : evb) + (j - kF) * kTokP;
    return zrow;
  }
};

// acc (16 rows x 32 keys) += A B^T, A's rows arow(i) and B's rows brow(j),
// 32 features each (row-major, k contiguous)
template <class ARow, class BRow>
__device__ __forceinline__ void mma_rows_rows(float (&acc)[4][4], ARow arow,
                                              BRow brow, int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, arow(a_row_off(lane)) + ks * 16 + a_col_off(lane));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bb[4];
      ldsm_x4(bb, brow(np * 16 + bn_row_off(lane)) + ks * 16 + bn_col_off(lane));
      mma_bf16(acc[2 * np], a, bb[0], bb[1]);
      mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// The A fragments of a 16 x 32 (keys) fragment xf in registers (the
// layout mma_rows_rows leaves), k-step kk: bf16(X), or with kLo the
// rounding error X - bf16(X) in bf16. hi + lo keeps about 16 of X's 24
// significant bits, so a product of both with one B is an f32-exact X
// against bf16 B to that precision.
template <bool kLo>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const float (&xf)[4][4],
                                       int kk) {
  const float* x0 = xf[2 * kk];
  const float* x1 = xf[2 * kk + 1];
  auto part = [](float v) { return kLo ? v - round_bf16(v) : v; };
  a[0] = pack_bf16x2(part(x0[0]), part(x0[1]));
  a[1] = pack_bf16x2(part(x0[2]), part(x0[3]));
  a[2] = pack_bf16x2(part(x1[0]), part(x1[1]));
  a[3] = pack_bf16x2(part(x1[2]), part(x1[3]));
}

// acc (16 rows x 32 features) += X B, X a 16 x 32 (keys) fragment in
// registers taken as bf16(X), or with kSplit as bf16(X) + its rounding
// error (two products), B's rows brow(j) over the keys (n contiguous)
template <bool kSplit, class BRow>
__device__ __forceinline__ void mma_frag_rows(float (&acc)[4][4],
                                              const float (&xf)[4][4],
                                              BRow brow, int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t a[4], lo[4];
    frag_a<false>(a, xf, kk);
    if (kSplit) frag_a<true>(lo, xf, kk);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bb[4];
      ldsm_x4_t(bb, brow(kk * 16 + bk_row_off(lane)) + np * 16 + bk_col_off(lane));
      mma_bf16(acc[2 * np], a, bb[0], bb[1]);
      mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
      if (kSplit) {
        mma_bf16(acc[2 * np], lo, bb[0], bb[1]);
        mma_bf16(acc[2 * np + 1], lo, bb[2], bb[3]);
      }
    }
  }
}

// acc (32 keys x 32 features, two m-tiles) += X^T B, X a 16 x 32 fragment
// (rows: query frames, columns: keys) taken as bf16(X), or with kSplit as
// bf16(X) + its rounding error, transposed through the warp's scratch
// (16 x kTokP bf16, two of them with kSplit), B's rows brow(i) over the
// 16 query frames (n contiguous)
template <bool kSplit, class BRow>
__device__ __forceinline__ void mma_fragT_rows(float (&acc)[2][4][4],
                                               const float (&xf)[4][4],
                                               __nv_bfloat16* scratch,
                                               BRow brow, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int lo = 0; lo < (kSplit ? 2 : 1); ++lo) {
    __nv_bfloat16* sc = scratch + lo * 16 * kTokP;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = nt * 8 + 2 * tq;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = lo ? xf[nt][e] - round_bf16(xf[nt][e]) : xf[nt][e];
      *reinterpret_cast<uint32_t*>(sc + g * kTokP + col) = pack_bf16x2(v[0], v[1]);
      *reinterpret_cast<uint32_t*>(sc + (g + 8) * kTokP + col) =
          pack_bf16x2(v[2], v[3]);
    }
  }
  __syncwarp();
  uint32_t bq[2][4];
#pragma unroll
  for (int np = 0; np < 2; ++np)
    ldsm_x4_t(bq[np], brow(bk_row_off(lane)) + np * 16 + bk_col_off(lane));
#pragma unroll
  for (int lo = 0; lo < (kSplit ? 2 : 1); ++lo)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t a[4];
      ldsm_x4_t(a, scratch + lo * 16 * kTokP + at_row_off(lane) * kTokP + mt * 16 +
                       at_col_off(lane));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        mma_bf16(acc[mt][2 * np], a, bq[np][0], bq[np][1]);
        mma_bf16(acc[mt][2 * np + 1], a, bq[np][2], bq[np][3]);
      }
    }
  __syncwarp();  // the scratch is rewritten by the next call
}

// The softmax over the keys of the scores fragment, in place: bias_h
// (F x G, this head) added, keys >= G masked, f32 throughout; rows >= F
// (padding) come out as some finite distribution that no caller reads
template <int kF, int kG>
__device__ __forceinline__ void softmax_rows(float (&s)[4][4],
                                             const float* bias_h, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = g + 8 * half;
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * tq + e;
        float& v = s[nt][2 * half + e];
        v = col < kG ? v + (i < kF ? bias_h[i * kG + col] : 0.f) : -INFINITY;
        mx = fmaxf(mx, v);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float z = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[nt][2 * half + e];
        v = expf(v - mx);
        z += v;
      }
    z += __shfl_xor_sync(0xffffffffu, z, 1);
    z += __shfl_xor_sync(0xffffffffu, z, 2);
    const float inv_z = 1.f / z;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      s[nt][2 * half] *= inv_z;
      s[nt][2 * half + 1] *= inv_z;
    }
  }
}

// the rows < F of a 16 x 32 fragment, rounded to bf16, to dst(i) + column
template <int kF, class Dst>
__device__ __forceinline__ void store_frag_rows(const float (&acc)[4][4],
                                                Dst dst, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = g + 8 * half;
    if (i < kF) {
      __nv_bfloat16* row = dst(i);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<uint32_t*>(row + nt * 8 + 2 * tq) =
            pack_bf16x2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

}  // namespace vmt
