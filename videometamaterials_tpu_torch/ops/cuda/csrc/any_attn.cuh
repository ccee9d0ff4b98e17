// The temporal attention of one position and one head on the tensor cores
// at any shape, shared by the any-shape forward (any_shape.cu: rows 1 and
// 2) and backward (any_shape_bwd.cu: row 3). F query frames, F + T keys
// (the frames, then the conditioning tokens) and the head width d are
// launch arguments.
//
// A warp takes one position at a time. The query frames are the rows of
// m16 tiles (one up to F = 16, more above); the keys come in chunks of 32
// (four n8 tiles of the mma.sync m16n8k16 accumulators); d is covered in
// k-steps of 16, zero-padded to dp, a multiple of 16. Operand rows are
// gathered by the per-lane row addresses of ldmatrix from shared memory: a
// frame's q, k, v (and in the backward g_acc) row staged for the warp's
// position, a token row staged once for the block, or a zero row for the
// padding. Scores and softmax weights stay in registers as accumulator
// fragments (a row of a chunk lives in the four lanes of a quad); where a
// weight fragment is the A operand it is packed from the registers, and
// the transposed products (keys as rows) go through a 16 x 40 scratch.
// The accumulator layout is csrc/mma.cuh's: lane (g = lane / 4, tq = lane
// % 4) holds rows g and g + 8, columns 2 tq and 2 tq + 1 of each n8 tile.
#pragma once

#include <math_constants.h>

#include "any_shape.cuh"

namespace {

constexpr int kAttnKeys = 32;   // keys a chunk: four n8 tiles
constexpr int kAttnScrP = 40;   // pitch (bf16) of the transpose scratch

// d padded to the mma k-steps
__host__ __device__ inline int attn_dp(int d) { return (d + 15) / 16 * 16; }
// pitch (bf16) of a staged row: dp + 8, an odd number of 16-byte units, so
// the eight rows of an ldmatrix phase fall in eight bank groups
__host__ __device__ inline int attn_pitch(int d) { return attn_dp(d) + 8; }
// query rows: F padded to the m16 tiles
__host__ __device__ inline int attn_fq(int F) { return (F + 15) / 16 * 16; }
// pitch (f32) of a table the fragments add into: n rounded up to 8 mod 32,
// so a quad's two rows g and g + 4 fall in different banks
__host__ __device__ inline int attn_accp(int n) {
  return n + (40 - n % 32) % 32;
}
__host__ __device__ inline size_t attn_align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// shared memory of a block's own staging, bytes: the head's token rows (ek,
// then ev, T x pitch each) and a zero row, bf16, then its bias table
// F x (F + T) f32
__host__ __device__ inline size_t attn_block_bytes(int F, int T, int d) {
  return attn_align16((size_t)(2 * T + 1) * attn_pitch(d) * 2 +
                      (size_t)F * (F + T) * 4);
}

// Row addresses of one position's operands
struct AttnRows {
  const bf16* fr;    // the position's frame rows, [part][F][pitch]
  const bf16* tok;   // the block's token rows: ek [T][pitch], ev [T][pitch]
  const bf16* zrow;  // a row of zeros
  int F, T, pitch;
  // query frame i's row of `part` (i >= F: zeros)
  __device__ __forceinline__ const bf16* frame(int i, int part) const {
    return i < F ? fr + ((size_t)part * F + i) * pitch : zrow;
  }
  // key j's row of part 1 (k) or 2 (v): a frame's, a token's, or zeros
  __device__ __forceinline__ const bf16* key(int j, int part) const {
    if (j < F) return fr + ((size_t)part * F + j) * pitch;
    if (j < F + T) return tok + ((size_t)(part - 1) * T + j - F) * pitch;
    return zrow;
  }
};

// s (16 rows x 32 keys) = A B^T over `ksteps` k-steps of 16: A's rows
// arow(i), i < 16, and B's rows brow(j), j < 32, features contiguous
template <class ARow, class BRow>
__device__ __forceinline__ void attn_scores(float (&s)[4][4], ARow arow,
                                            BRow brow, int ksteps, int lane) {
  const bf16* ar = arow(vmt::a_row_off(lane)) + vmt::a_col_off(lane);
  const bf16* b0 = brow(vmt::bn_row_off(lane)) + vmt::bn_col_off(lane);
  const bf16* b1 = brow(16 + vmt::bn_row_off(lane)) + vmt::bn_col_off(lane);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[4], bb[4];
    vmt::ldsm_x4(a, ar + ks * 16);
    vmt::ldsm_x4(bb, b0 + ks * 16);
    vmt::mma_bf16(s[0], a, bb[0], bb[1]);
    vmt::mma_bf16(s[1], a, bb[2], bb[3]);
    vmt::ldsm_x4(bb, b1 + ks * 16);
    vmt::mma_bf16(s[2], a, bb[0], bb[1]);
    vmt::mma_bf16(s[3], a, bb[2], bb[3]);
  }
}

// the head's relative bias (bias_h: [F][G]) added to a chunk of scores of
// query rows i0.. and keys j0..; keys >= G masked to -inf; rows >= F (the
// padding of the last query tile) set to 0
__device__ __forceinline__ void attn_bias_mask(float (&s)[4][4],
                                               const float* bias_h, int i0,
                                               int j0, int F, int G,
                                               int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + g + 8 * half;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + nt * 8 + 2 * tq + e;
        float& v = s[nt][2 * half + e];
        v = j >= G ? -CUDART_INF_F : (i < F ? v + bias_h[i * G + j] : 0.f);
      }
  }
}

// the running max m and sum l of exp(s - m) of the lane's two rows, over
// one more chunk (every chunk holds a key < G, so the max is finite)
__device__ __forceinline__ void attn_online(const float (&s)[4][4],
                                            float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mx = fmaxf(mx, fmaxf(s[nt][2 * half], s[nt][2 * half + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[half], mx);
    float z = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      z += expf(s[nt][2 * half] - mn) + expf(s[nt][2 * half + 1] - mn);
    z += __shfl_xor_sync(0xffffffffu, z, 1);
    z += __shfl_xor_sync(0xffffffffu, z, 2);
    l[half] = l[half] * expf(m[half] - mn) + z;
    m[half] = mn;
  }
}

// the softmax weights of a chunk from the final max and sum, f32, in place
__device__ __forceinline__ void attn_probs(float (&s)[4][4],
                                           const float (&m)[2],
                                           const float (&l)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[nt][2 * half + e];
        v = expf(v - m[half]) / l[half];
      }
}

// the A fragment (k-step kk of 16 keys) of a 16 x 32 fragment in registers:
// bf16(X), or with kLo the rounding error X - bf16(X) in bf16
template <bool kLo>
__device__ __forceinline__ void attn_frag_a(uint32_t (&a)[4],
                                            const float (&xf)[4][4], int kk) {
  const float* x0 = xf[2 * kk];
  const float* x1 = xf[2 * kk + 1];
  auto part = [](float v) { return kLo ? v - round_bf16(v) : v; };
  a[0] = vmt::pack_bf16x2(part(x0[0]), part(x0[1]));
  a[1] = vmt::pack_bf16x2(part(x0[2]), part(x0[3]));
  a[2] = vmt::pack_bf16x2(part(x1[0]), part(x1[1]));
  a[3] = vmt::pack_bf16x2(part(x1[2]), part(x1[3]));
}

// acc (16 rows x kNT n8 tiles of the features f0..) += X B: X the 16 x 32
// (keys) fragment in registers, taken as bf16(X), or with kSplit as bf16(X)
// plus its rounding error (two products, about 16 significant bits); B's
// rows brow(j), j < 32, over the keys (features contiguous); npairs of the
// kNT / 2 pairs of n8 tiles lie inside dp
template <bool kSplit, int kNT, class BRow>
__device__ __forceinline__ void attn_mma_frag(float (&acc)[kNT][4],
                                              const float (&xf)[4][4],
                                              BRow brow, int f0, int npairs,
                                              int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t a[4], lo[4];
    attn_frag_a<false>(a, xf, kk);
    if (kSplit) attn_frag_a<true>(lo, xf, kk);
    const bf16* br =
        brow(kk * 16 + vmt::bk_row_off(lane)) + f0 + vmt::bk_col_off(lane);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      if (np >= npairs) break;
      uint32_t bb[4];
      vmt::ldsm_x4_t(bb, br + np * 16);
      vmt::mma_bf16(acc[2 * np], a, bb[0], bb[1]);
      vmt::mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
      if (kSplit) {
        vmt::mma_bf16(acc[2 * np], lo, bb[0], bb[1]);
        vmt::mma_bf16(acc[2 * np + 1], lo, bb[2], bb[3]);
      }
    }
  }
}

// X (16 rows x 32 keys, registers) into the warp's scratch as [row][key]
// bf16: bf16(X) at scratch, and with kSplit its rounding error at scratch +
// 16 kAttnScrP, for attn_mma_t
template <bool kSplit>
__device__ __forceinline__ void attn_stage_t(bf16* scratch,
                                             const float (&xf)[4][4],
                                             int lane) {
  const int g = lane >> 2, tq = lane & 3;
  __syncwarp();  // the previous chunk's reads of the scratch are done
#pragma unroll
  for (int lo = 0; lo < (kSplit ? 2 : 1); ++lo) {
    bf16* sc = scratch + lo * 16 * kAttnScrP;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = lo ? xf[nt][e] - round_bf16(xf[nt][e]) : xf[nt][e];
      const int col = nt * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(sc + g * kAttnScrP + col) =
          vmt::pack_bf16x2(v[0], v[1]);
      *reinterpret_cast<uint32_t*>(sc + (g + 8) * kAttnScrP + col) =
          vmt::pack_bf16x2(v[2], v[3]);
    }
  }
  __syncwarp();
}

// acc (32 keys as two m16 tiles x 16 features f0..) += X^T B from the
// staged scratch (attn_stage_t; kSplit: both parts), B's rows brow(i),
// i < 16, over the query rows (features contiguous)
template <bool kSplit, class BRow>
__device__ __forceinline__ void attn_mma_t(float (&acc)[2][2][4],
                                           const bf16* scratch, BRow brow,
                                           int f0, int lane) {
  uint32_t bq[4];
  vmt::ldsm_x4_t(bq, brow(vmt::bk_row_off(lane)) + f0 + vmt::bk_col_off(lane));
#pragma unroll
  for (int lo = 0; lo < (kSplit ? 2 : 1); ++lo)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t a[4];
      vmt::ldsm_x4_t(a, scratch + lo * 16 * kAttnScrP +
                            vmt::at_row_off(lane) * kAttnScrP + mt * 16 +
                            vmt::at_col_off(lane));
      vmt::mma_bf16(acc[mt][0], a, bq[0], bq[1]);
      vmt::mma_bf16(acc[mt][1], a, bq[2], bq[3]);
    }
}

// the frame rows of one position's head into `slots` slots of a staging
// buffer of the warp (slot p, frame f at fr + (p F + f) pitch): slot
// `gslot` from ga (g_acc, row pitch H), every other slot p from qkv's
// part p (q, k, v: row pitch 3H, column p H + h d); row (b, f, s) of each
// at ((b F + f) S + s). Where d is a multiple of 8, 16 bytes a copy by
// cp.async, committed as one group of each lane (the caller waits:
// attn_wait_rows), else one element a lane, synchronously; columns past d
// stay as they are (zeros)
__device__ __forceinline__ void attn_load_rows(
    bf16* fr, const bf16* __restrict__ qkv, const bf16* __restrict__ ga,
    int slots, int gslot, int b, int F, int S, int s, int H, int h, int d,
    int pitch, int lane) {
  auto src_row = [&](int p, int f) {
    const size_t row = ((size_t)b * F + f) * S + s;
    return p == gslot ? ga + row * H + h * d : qkv + row * 3 * H + p * H + h * d;
  };
  if (d % 8 == 0) {
    const int cpr = d / 8;
    for (int i = lane; i < slots * F * cpr; i += 32) {
      const int c = i % cpr, f = (i / cpr) % F, p = i / (cpr * F);
      vmt::cp_async16(fr + ((size_t)p * F + f) * pitch + c * 8,
                      src_row(p, f) + c * 8);
    }
    vmt::cp_async_commit();
  } else {
    for (int i = lane; i < slots * F * d; i += 32) {
      const int e = i % d, f = (i / d) % F, p = i / (d * F);
      fr[((size_t)p * F + f) * pitch + e] = src_row(p, f)[e];
    }
  }
}

// the rows of the current position visible to the warp: with a next
// position's copies in flight (`ahead`) all but the newest group, else all
__device__ __forceinline__ void attn_wait_rows(bool ahead) {
  if (ahead) vmt::cp_async_wait<1>();
  else vmt::cp_async_wait<0>();
  __syncwarp();
}

// the block's token rows of head h (ek then ev, (B, T, H) each), its
// zero row and its bias table bias_h[i * G + j] = bias[(i G + j) heads + h],
// after zeroing the whole dynamic shared memory of `bytes` (the padding
// columns of every staged row stay zero)
__device__ __forceinline__ void attn_stage_block(
    unsigned char* smem, size_t bytes, bf16* tok, float* bias_h,
    const bf16* __restrict__ ek, const bf16* __restrict__ ev,
    const float* __restrict__ bias, int b, int F, int T, int H, int h,
    int heads, int d, int pitch) {
  const int t = threadIdx.x, n = blockDim.x;
  for (size_t i = t; i < bytes / 16; i += n)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int i = t; i < 2 * T * d; i += n) {
    const int e = i % d, r = (i / d) % T, p = i / (d * T);
    tok[((size_t)p * T + r) * pitch + e] =
        (p ? ev : ek)[((size_t)b * T + r) * H + h * d + e];
  }
  const int G = F + T;
  for (int i = t; i < F * G; i += n) bias_h[i] = bias[(size_t)i * heads + h];
  __syncthreads();
}

}  // namespace
