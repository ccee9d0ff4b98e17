// Pieces of the any-shape linear kernels shared by rows 4-5
// (any_shape.cu), rows 6-7 (any_linear_bwd.cu) and row 8
// (any_linear_head*.cu), for sm_90a: K-chunks of x rows and weights staged
// by cp.async, LayerNorm statistics and a tile's LayerNorm bit-equal to
// ln_rows_kernel (eight threads a row playing its warp's lanes), the
// fragment normalisation of the streamed modes, ring-stage helpers, the
// weight-chunk loaders of the stats and apply kernels (heads padded to dp
// columns) and their projection on mma.sync. Each translation unit that
// includes this gets its own copy (an anonymous namespace).
#pragma once

#include "any_shape.cuh"

namespace {

constexpr int kLinThreads = 256;
constexpr int kLinKC = 32;            // K-chunk: x columns, weight rows
constexpr int kLinXP = kLinKC + 8;    // pitch of a chunk's x rows (bf16)
constexpr int kLinMinStages = 3, kLinMaxStages = 6;
constexpr int kLinMaxCols = 256;      // weight columns a stage holds at most
constexpr int kLinStatM = 64;         // tokens a stats sub-tile
constexpr int kMaxLinD = 64;
// dynamic shared memory of a block where two blocks share an SM
constexpr int kLinResSmem = 115712;

// the most ring stages (kLinMinStages at least) whose shared memory,
// smem(stages), stays within `limit`
template <class F>
int lin_stages(F smem, int limit) {
  int s = kLinMinStages;
  while (s < kLinMaxStages && smem(s + 1) <= limit) ++s;
  return s;
}

// warp_sum's butterfly over the 32 lanes of ln_rows_kernel's warp that
// eight threads of a row play (thread j: lanes j, j + 8, j + 16, j + 24 as
// layer_norm_tile8 in common.cuh; with `pairs`, lanes 2j, 2j + 1, 2j + 16,
// 2j + 17, whose step 1 then comes last, within the thread): ps holds the
// four played lanes' sums in that order; every thread returns lane 0's
// result
__device__ __forceinline__ float lin_row_sum(const float (&ps)[4],
                                             bool pairs) {
  float e = ps[0] + ps[2], o = ps[1] + ps[3];
  if (!pairs) {
    float s = e + o;
#pragma unroll
    for (int k = 4; k > 0; k >>= 1) s += __shfl_xor_sync(0xffffffffu, s, k);
    return s;
  }
#pragma unroll
  for (int k = 4; k > 0; k >>= 1) {
    e += __shfl_xor_sync(0xffffffffu, e, k);
    o += __shfl_xor_sync(0xffffffffu, o, k);
  }
  return e + o;
}

// mean and rstd of rows n0.. of a frame in device memory (at most 64 rows;
// 0 and 0 from `valid` on) into mu_s and rs_s, ln_rows_kernel's sums in
// its order (each played lane's elements lane + 32 u in turn, then
// lin_row_sum): its bits. Eight threads a row, both 32-row halves at once.
// Rows of an even C, 4-byte aligned, are read as bf16 pairs, 256 columns
// of both rows in flight; else one value at a time, 128 columns.
__device__ __forceinline__ void lin_row_stats(const bf16* xb, int n0,
                                              int valid, int rows, int C,
                                              float* mu_s, float* rs_s,
                                              int t) {
  constexpr int kRR = 2;           // rows a thread: r and r + 32
  const int j = t & 7;
  const bool pairs = C % 2 == 0 && (reinterpret_cast<uintptr_t>(xb) & 3) == 0;
  const bf16* xr[kRR];
  bool ok[kRR];
#pragma unroll
  for (int rr = 0; rr < kRR; ++rr) {
    const int r = (t >> 3) + 32 * rr;
    ok[rr] = r < valid && r < rows;
    xr[rr] = xb + (size_t)(n0 + (ok[rr] ? r : 0)) * C;
  }
  float ps[kRR][4] = {};
  // pass 0: the sums; pass 1: the squares about the mean
  float mu[kRR] = {0.f, 0.f};
  for (int pass = 0; pass < 2; ++pass) {
    if (pairs) {
      for (int u0 = 0; u0 < C; u0 += 256) {
        uint32_t v[kRR][8][2];   // [row][32-column group][pair]
#pragma unroll
        for (int rr = 0; rr < kRR; ++rr)
#pragma unroll
          for (int s = 0; s < 8; ++s)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = u0 + 32 * s + 16 * h + 2 * j;
              v[rr][s][h] = ok[rr] && c < C
                                ? *reinterpret_cast<const uint32_t*>(xr[rr] + c)
                                : 0u;
            }
#pragma unroll
        for (int rr = 0; rr < kRR; ++rr)
#pragma unroll
          for (int s = 0; s < 8; ++s)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (u0 + 32 * s + 16 * h + 2 * j >= C) continue;
              const float lo = __uint_as_float(v[rr][s][h] << 16);
              const float hi = __uint_as_float(v[rr][s][h] & 0xffff0000u);
              if (pass == 0) {
                ps[rr][2 * h] += lo;
                ps[rr][2 * h + 1] += hi;
              } else {
                const float dl = lo - mu[rr], dh = hi - mu[rr];
                ps[rr][2 * h] += dl * dl;
                ps[rr][2 * h + 1] += dh * dh;
              }
            }
      }
    } else {
      for (int u0 = 0; u0 < C; u0 += 128) {
        float v[kRR][4][4];   // [row][32-column group][played lane]
#pragma unroll
        for (int rr = 0; rr < kRR; ++rr)
#pragma unroll
          for (int b = 0; b < 4; ++b)
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const int c = u0 + 32 * b + 8 * a + j;
              v[rr][b][a] = ok[rr] && c < C ? bf2f(xr[rr][c]) : 0.f;
            }
#pragma unroll
        for (int rr = 0; rr < kRR; ++rr)
#pragma unroll
          for (int b = 0; b < 4; ++b)
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              if (u0 + 32 * b + 8 * a + j >= C) continue;
              if (pass == 0) {
                ps[rr][a] += v[rr][b][a];
              } else {
                const float dv = v[rr][b][a] - mu[rr];
                ps[rr][a] += dv * dv;
              }
            }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRR; ++rr) {
      const float s = lin_row_sum(ps[rr], pairs);
#pragma unroll
      for (int a = 0; a < 4; ++a) ps[rr][a] = 0.f;
      if (pass == 0) {
        mu[rr] = s / C;
      } else {
        const int r = (t >> 3) + 32 * rr;
        const float rs = rsqrtf(s / C + vmt::kLnEps);
        if (j == 0 && r < rows) {
          mu_s[r] = ok[rr] ? mu[rr] : 0.f;
          rs_s[r] = ok[rr] ? rs : 0.f;
        }
      }
    }
  }
}

// The resident modes' LN of a staged tile (C <= 128, at most four K-chunk
// slots of [rows][kLinXP], kXS elements apart): as lin_row_stats (eight
// threads a row, ln_rows_kernel's sums and bits), the row's values held in
// registers for all three passes; y = bf16((x - mu) rstd gamma) into ys
// (which may be xs), zeros past C and from `valid` on.
__device__ __forceinline__ void lin_ln_tile(const bf16* xs, bf16* ys,
                                            int kXS, const float* gs,
                                            int valid, int rows, int C,
                                            int t) {
  const int j = t & 7;
  auto row_sum = [](const float (&ps)[4]) {
    float s = (ps[0] + ps[2]) + (ps[1] + ps[3]);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
  };
  for (int r0 = 0; r0 < rows; r0 += kLinThreads / 8) {
    const int r = r0 + (t >> 3);
    const bool in = r < rows, ok = in && r < valid;
    const int off = (in ? r : 0) * kLinXP + j;
    float v[4][4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int a = 0; a < 4; ++a)
        v[b][a] = ok && 32 * b + 8 * a + j < C ? bf2f(xs[b * kXS + off + 8 * a])
                                               : 0.f;
    float ps[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (32 * b + 8 * a + j < C) ps[a] += v[b][a];
    const float mu = row_sum(ps) / C;
#pragma unroll
    for (int a = 0; a < 4; ++a) ps[a] = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (32 * b + 8 * a + j < C) {
          const float dv = v[b][a] - mu;
          ps[a] += dv * dv;
        }
    const float rs = rsqrtf(row_sum(ps) / C + vmt::kLnEps);
    if (in) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (32 * b >= C) break;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int c = 32 * b + 8 * a + j;
          ys[b * kXS + off + 8 * a] = __float2bfloat16(
              ok && c < C ? (v[b][a] - mu) * rs * gs[c] : 0.f);
        }
      }
    }
  }
}

// cp.async.wait_group with a count known at run time (0..kLinMaxStages - 2)
__device__ __forceinline__ void lin_wait(int n) {
  switch (n) {
    case 0: vmt::cp_async_wait<0>(); break;
    case 1: vmt::cp_async_wait<1>(); break;
    case 2: vmt::cp_async_wait<2>(); break;
    case 3: vmt::cp_async_wait<3>(); break;
    default: vmt::cp_async_wait<4>(); break;
  }
}
static_assert(kLinMaxStages - 2 <= 4, "lin_wait takes counts up to 4");

// x rows n0.. (zeros from `valid` on) of the frame, columns k0..k0+31
// (zeros from C on), into [rows][kLinXP]: 16 bytes a cp.async where rows
// are 16-byte aligned (vx: C % 8 == 0), else element by element. Each
// thread takes the same (row, 8 columns) pieces in every call.
__device__ __forceinline__ void lin_load_x(bf16* dst, const bf16* xb, int n0,
                                           int valid, int rows, int k0,
                                           int C, bool vx, int t) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = t; i < rows * (kLinKC / 8); i += kLinThreads) {
    const int r = i >> 2, o = (i & 3) * 8, k = k0 + o;
    bf16* d = dst + r * kLinXP + o;
    const bf16* s = xb + (size_t)(n0 + r) * C + k;
    if (vx) {
      const bool ok = r < valid && k < C;
      vmt::cp_async16(d, ok ? s : xb, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (r < valid && k + e < C) ? s[e] : zero;
    }
  }
}
static_assert(kLinKC / 8 == 4, "lin_load_x takes four 8-column pieces a row");

// gamma[k0..k0+31] (zeros from C on) into gs (vg: C % 4 == 0, aligned)
__device__ __forceinline__ void lin_load_gamma(float* gs, const float* gamma,
                                               int k0, int C, bool vg,
                                               int t) {
  if (t < kLinKC / 4) {
    const int k = k0 + 4 * t;
    if (vg) {
      vmt::cp_async16(gs + 4 * t, k < C ? gamma + k : gamma, k < C);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) gs[4 * t + e] = k + e < C ? gamma[k + e] : 0.f;
    }
  }
}

// a thread's share of a chunk of `units` 16-byte pieces a row (units <=
// kLinThreads): piece u (in elements) of rows r0, r0 + rstep, ...; the
// same in every chunk, so no chunk divides
struct LinUnit {
  int r0, rstep, u;
};
__device__ __forceinline__ LinUnit lin_unit(int units, int t) {
  const int rows = kLinThreads / units;
  return {t < rows * units ? t / units : kLinKC, rows, (t % units) * 8};
}

// two raw x values (a packed bf16 pair of one row) -> the packed pair of
// y = bf16((x - mu) rstd gamma), ln_rows_kernel's expression
__device__ __forceinline__ uint32_t lin_norm2(uint32_t v, float mu, float rs,
                                              float2 g) {
  const float lo = __uint_as_float(v << 16), hi = __uint_as_float(v & 0xffff0000u);
  return vmt::pack_bf16x2((lo - mu) * rs * g.x, (hi - mu) * rs * g.y);
}

// bytes of a ring stage: a K-chunk of `rows` x rows, gamma's chunk, the
// chunk's weight rows at pitch wp
__host__ __device__ inline int lin_stage_bytes(int rows, int wp) {
  return rows * kLinXP * 2 + kLinKC * 4 + kLinKC * wp * 2;
}

// the apply kernels (rows 5, 8): columns a warp takes in the
// out-projection (parts warps across a block of W_out columns): at most
// 64, and at most 256 a block
constexpr int kLinWC = 64;
__host__ __device__ inline int lin_apply_wc(int tile, int C) {
  const int parts = 8 / (tile / 16), per = (C + parts - 1) / parts;
  const int wc = (per + 15) / 16 * 16, cap = 256 / parts < kLinWC ? 256 / parts : kLinWC;
  return wc < cap ? wc : cap;
}

// apply, streamed: the pitch of a ring stage's weight rows
__host__ __device__ inline int lin_apply_wp(int tile, int group, int dp,
                                            int C) {
  const int cb = (8 / (tile / 16)) * lin_apply_wc(tile, C);
  return (group * dp > cb ? group * dp : cb) + 8;
}

// x[r][c] of a tile staged as K-chunk slots of [rows][kLinXP], slot_elems
// apart
__device__ __forceinline__ float lin_x_at(const bf16* xs, int slot_elems,
                                          int r, int c) {
  return bf2f(xs[(c / kLinKC) * slot_elems + r * kLinXP + c % kLinKC]);
}

// a chunk of weights: rows k0..k0+kLinKC-1 (zeros from C on) of w (row
// pitch ldw), column blocks of `group` heads of dp columns; head hl of
// block p is w's columns off[p] + (h0 + hl) d .. + d - 1 (zeros past d and
// past the last head). vw: every head's columns 16-byte aligned
template <int dp>
__device__ __forceinline__ void lin_load_w(bf16* dst, int wp, const bf16* w,
                                           int ldw, int k0, int C, int off0,
                                           int off1, int group, int h0,
                                           int heads, int d, bool vw,
                                           LinUnit un) {
  const bf16 zero = __float2bfloat16(0.f);
  const int width = group * dp, u = un.u;
  const int p = u / width, hl = (u % width) / dp, a = u % dp, h = h0 + hl;
  const bool col_ok = h < heads;
  const int col = (p ? off1 : off0) + h * d + a;
  for (int r = un.r0; r < kLinKC; r += un.rstep) {
    const int k = k0 + r;
    const bool row_ok = k < C && col_ok;
    bf16* dd = dst + r * wp + u;
    const bf16* s = w + (size_t)k * ldw + col;
    if (vw) {
      const bool ok = row_ok && a < d;
      vmt::cp_async16(dd, ok ? s : w, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dd[e] = (row_ok && a + e < d) ? s[e] : zero;
    }
  }
}

// the stats' layout of a group's columns: two parts, one a column half of
// the block (`half` columns each). A group of one head: part 0 its k, part
// 1 its v. An even group: part p the k and then the v of heads p G / 2 ..,
// so both halves' warps exponentiate. Of a part's column `col` (< half):
// whether it is a v column, its head within the group, its feature
struct KvCol {
  bool v;
  int hl, a;
};
template <int dp>
__device__ __forceinline__ KvCol stats_col(int part, int col, int G) {
  if (G == 1) return {part == 1, 0, col};
  const int kw = (G / 2) * dp;   // k columns of a part
  const bool v = col >= kw;
  const int c = v ? col - kw : col;
  return {v, part * (G / 2) + c / dp, c % dp};
}

// a chunk of W_k || W_v in the stats' layout (stats_col): rows
// k0..k0+kLinKC-1 (zeros from C on) of w_qkv (C, 3H); zeros past d and
// past the last head. vw: every head's columns 16-byte aligned
template <int dp>
__device__ __forceinline__ void lin_load_wkv(bf16* dst, int wp,
                                             const bf16* w_qkv, int k0, int C,
                                             int G, int h0, int heads, int d,
                                             bool vw, LinUnit un) {
  const bf16 zero = __float2bfloat16(0.f);
  const int H = heads * d, half = G * dp, u = un.u;
  const KvCol kc = stats_col<dp>(u / half, u % half, G);
  const int h = h0 + kc.hl;
  const bool col_ok = h < heads;
  const int col = (kc.v ? 2 * H : H) + h * d + kc.a;
  for (int r = un.r0; r < kLinKC; r += un.rstep) {
    const int k = k0 + r;
    const bool row_ok = k < C && col_ok;
    bf16* dd = dst + r * wp + u;
    const bf16* s = w_qkv + (size_t)k * 3 * H + col;
    if (vw) {
      const bool ok = row_ok && kc.a < d;
      vmt::cp_async16(dd, ok ? s : w_qkv, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dd[e] = (row_ok && kc.a + e < d) ? s[e] : zero;
    }
  }
}

// a chunk of W_out: rows kp0..kp0+kLinKC-1 of the head-padded hidden axis
// (row h dp + a is W_out's row h d + a, zeros for a >= d), columns c0..
// (zeros from C on). vw: C % 8 == 0 and W_out aligned
template <int dp>
__device__ __forceinline__ void lin_load_wout(bf16* dst, int wp,
                                              const bf16* w_out, int kp0,
                                              int c0, int C, int heads, int d,
                                              bool vw, LinUnit un) {
  const bf16 zero = __float2bfloat16(0.f);
  const int o = un.u, c = c0 + o;
  for (int r = un.r0; r < kLinKC; r += un.rstep) {
    const int kp = kp0 + r, h = kp / dp, a = kp % dp;
    const bool row_ok = h < heads && a < d;
    bf16* dd = dst + r * wp + o;
    const bf16* s = w_out + (size_t)(h * d + a) * C + c;
    if (vw) {
      const bool ok = row_ok && c < C;
      vmt::cp_async16(dd, ok ? s : w_out, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dd[e] = (row_ok && c + e < C) ? s[e] : zero;
    }
  }
}

// acc[0..nt) += y[m0..m0+15][chunk] @ W[chunk][col0 + 8 n ..]: with kNorm
// the chunk holds raw x, whose fragments are normalised to y as they are
// read; else it holds y
template <int kNT, bool kNorm = true>
__device__ __forceinline__ void lin_project(float (&acc)[kNT][4],
                                            const bf16* xs, const float* gs,
                                            const bf16* ws, int wp, int m0,
                                            int col0, int nt,
                                            const float (&mu)[2],
                                            const float (&rs)[2], int lane) {
  const int tq = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kLinKC / 16; ++ks) {
    uint32_t a[4];
    vmt::ldsm_x4(a, xs + (m0 + vmt::a_row_off(lane)) * kLinXP + ks * 16 +
                        vmt::a_col_off(lane));
    if (kNorm) {
      const float2 g0 = *reinterpret_cast<const float2*>(gs + ks * 16 + 2 * tq);
      const float2 g1 =
          *reinterpret_cast<const float2*>(gs + ks * 16 + 2 * tq + 8);
      a[0] = lin_norm2(a[0], mu[0], rs[0], g0);
      a[1] = lin_norm2(a[1], mu[1], rs[1], g0);
      a[2] = lin_norm2(a[2], mu[0], rs[0], g1);
      a[3] = lin_norm2(a[3], mu[1], rs[1], g1);
    }
    const bf16* wrow = ws + (ks * 16 + vmt::bk_row_off(lane)) * wp + col0 +
                       vmt::bk_col_off(lane);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      if (2 * np < nt) {
        uint32_t bb[4];
        vmt::ldsm_x4_t(bb, wrow + np * 16);
        vmt::mma_bf16(acc[2 * np], a, bb[0], bb[1]);
        vmt::mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
  }
}

// a kernel's dynamic shared memory, with the SM's split of L1 and shared
// memory set to the most shared memory (else two blocks of the plan may
// not fit on an SM)
template <class K>
cudaError_t lin_smem_attrs(K* kern, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace
