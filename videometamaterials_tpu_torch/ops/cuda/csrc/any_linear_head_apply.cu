// Row 8 at any shape, its apply (linear_head_any_apply_kernel), for
// sm_90a: the third of the three launches of vmt_linear_head_any, whose
// notes (any_linear_head.cu) give the arithmetic, the rounding model and
// the design. A source of its own so that nvcc builds it beside the rest.
#include <math_constants.h>

#include "any_linear_head.cuh"

namespace {

// exp(q - m) of a head's column; 0 in the padding past d
__device__ __forceinline__ float q_exp(float q, float m, bool pad) {
  return pad ? 0.f : expf(q - m);
}

// ctxn's hi and lo blocks of heads h0..h0+group-1 ([group][2][DP][DP + 8]
// from ctxp), zeros past the last head
template <int DP>
__device__ __forceinline__ void head_stage_ctx(const HeadAny& p, bf16* cs,
                                               int bf, int h0, int group,
                                               int t) {
  constexpr int kU = 2 * DP * (DP + 8) / 8;   // 16-byte units a head
  const uint4* src = reinterpret_cast<const uint4*>(
      p.ctxp + ((size_t)bf * p.heads + h0) * 2 * DP * (DP + 8));
  uint4* dst = reinterpret_cast<uint4*>(cs);
  const int live = min(group, p.heads - h0) * kU;
  for (int i = t; i < group * kU; i += kLinThreads)
    dst[i] = i < live ? src[i] : make_uint4(0u, 0u, 0u, 0u);
}

// the warp's heads hw0..hw0+nhw-1 of the group (q in acc, DP columns a
// head): the feature softmax on the fragments (a head's row lies in one
// quad: two shuffles for its max and its sum; the padding past d is -inf
// to the max, 0 to the sum and 0 in Q); oh_h = Q_h ctxn_h as Q_hi c_hi +
// Q_hi c_lo + Q_lo c_hi, Q's parts repacked from the accumulators as A
// fragments; oh's bf16 hi and lo into the oh tiles' rows m0.., columns
// col0 + hl DP..
template <int DP, int kNT>
__device__ __forceinline__ void head_apply(float (&acc)[kNT][4],
                                           const bf16* cs, bf16* oh_hi,
                                           bf16* oh_lo, int ohp, int col0,
                                           int hw0, int nhw, int d,
                                           float scale, int m0, int lane) {
  constexpr int kNTD = DP / 8, kCP = DP + 8;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < kNT / kNTD; ++i) {
    if (i >= nhw) continue;
    const int hl = hw0 + i;
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kNTD; ++j) {
      const float (&qv)[4] = acc[i * kNTD + j];
      const int c = j * 8 + 2 * tq;
      if (c < d) {
        mx0 = fmaxf(mx0, qv[0]);
        mx1 = fmaxf(mx1, qv[2]);
      }
      if (c + 1 < d) {
        mx0 = fmaxf(mx0, qv[1]);
        mx1 = fmaxf(mx1, qv[3]);
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < kNTD; ++j) {
      float (&ev)[4] = acc[i * kNTD + j];
      const int c = j * 8 + 2 * tq;
      ev[0] = q_exp(ev[0], mx0, c >= d);
      ev[1] = q_exp(ev[1], mx0, c + 1 >= d);
      ev[2] = q_exp(ev[2], mx1, c >= d);
      ev[3] = q_exp(ev[3], mx1, c + 1 >= d);
      s0 += ev[0] + ev[1];
      s1 += ev[2] + ev[3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    const float r0 = scale / s0, r1 = scale / s1;
    float o[kNTD][4];
#pragma unroll
    for (int n = 0; n < kNTD; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    const bf16* cb = cs + hl * 2 * DP * kCP;
#pragma unroll
    for (int kk = 0; kk < kNTD / 2; ++kk) {
      const float (&x0)[4] = acc[i * kNTD + 2 * kk];
      const float (&x1)[4] = acc[i * kNTD + 2 * kk + 1];
      const float q[8] = {x0[0] * r0, x0[1] * r0, x0[2] * r1, x0[3] * r1,
                          x1[0] * r0, x1[1] * r0, x1[2] * r1, x1[3] * r1};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ah[r] = vmt::pack_bf16x2(q[2 * r], q[2 * r + 1]);
        al[r] = lo_bf16x2(q[2 * r], q[2 * r + 1]);
      }
#pragma unroll
      for (int np = 0; np < kNTD / 2; ++np) {
        const int bo = (kk * 16 + vmt::bk_row_off(lane)) * kCP + np * 16 +
                       vmt::bk_col_off(lane);
        uint32_t bh[4], bl[4];
        vmt::ldsm_x4_t(bh, cb + bo);
        vmt::ldsm_x4_t(bl, cb + DP * kCP + bo);
        vmt::mma_bf16(o[2 * np], ah, bh[0], bh[1]);
        vmt::mma_bf16(o[2 * np + 1], ah, bh[2], bh[3]);
        vmt::mma_bf16(o[2 * np], ah, bl[0], bl[1]);
        vmt::mma_bf16(o[2 * np + 1], ah, bl[2], bl[3]);
        vmt::mma_bf16(o[2 * np], al, bh[0], bh[1]);
        vmt::mma_bf16(o[2 * np + 1], al, bh[2], bh[3]);
      }
    }
    const int off = (m0 + g) * ohp + col0 + hl * DP + 2 * tq;
    bf16* hrow = oh_hi + off;
    bf16* lrow = oh_lo + off;
#pragma unroll
    for (int n = 0; n < kNTD; ++n)
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const float a = o[n][2 * h8], b = o[n][2 * h8 + 1];
        *reinterpret_cast<uint32_t*>(hrow + 8 * h8 * ohp + n * 8) =
            vmt::pack_bf16x2(a, b);
        *reinterpret_cast<uint32_t*>(lrow + 8 * h8 * ohp + n * 8) = lo_bf16x2(a, b);
      }
  }
}

// dacc += (oh_hi + oh_lo)[m0..m0+15][kh chunk] @ W_out chunk [kLinKC][wc
// columns at wsq], two products
__device__ __forceinline__ void head_out_chunk(float (&dacc)[kLinWC / 8][4],
                                               const bf16* oh_hi,
                                               const bf16* oh_lo, int ohp,
                                               int kh, const bf16* wsq,
                                               int wp, int wc, int m0,
                                               int lane) {
#pragma unroll
  for (int ks = 0; ks < kLinKC / 16; ++ks) {
    const int ao = (m0 + vmt::a_row_off(lane)) * ohp + kh * kLinKC + ks * 16 +
                   vmt::a_col_off(lane);
    uint32_t ah[4], al[4];
    vmt::ldsm_x4(ah, oh_hi + ao);
    vmt::ldsm_x4(al, oh_lo + ao);
#pragma unroll
    for (int np = 0; np < kLinWC / 16; ++np) {
      if (np * 16 >= wc) continue;
      uint32_t bb[4];
      vmt::ldsm_x4_t(bb, wsq + (ks * 16 + vmt::bk_row_off(lane)) * wp +
                             np * 16 + vmt::bk_col_off(lane));
      vmt::mma_bf16(dacc[2 * np], ah, bb[0], bb[1]);
      vmt::mma_bf16(dacc[2 * np + 1], ah, bb[2], bb[3]);
      vmt::mma_bf16(dacc[2 * np], al, bb[0], bb[1]);
      vmt::mma_bf16(dacc[2 * np + 1], al, bb[2], bb[3]);
    }
  }
}

// out = bf16(x + out_bias + dacc) of rows m0.. (< valid) of the tile at
// row0 (frame rows), columns c0 + 8 n + 2 tq (+1) < C, in bf16 pairs where
// C is even; xr(r, c) reads x
template <class Xr>
__device__ __forceinline__ void head_store(const float (&dacc)[kLinWC / 8][4],
                                           const HeadAny& p, Xr xr,
                                           size_t row0, int valid, int c0,
                                           int wc, int m0, int lane) {
  const int g = lane >> 2, tq = lane & 3, C = p.C;
  const bool pairs = C % 2 == 0;
#pragma unroll
  for (int h8 = 0; h8 < 2; ++h8) {
    const int r = m0 + g + 8 * h8;
    if (r >= valid) continue;
    bf16* orow = p.out + (row0 + r) * C;
#pragma unroll
    for (int n = 0; n < kLinWC / 8; ++n) {
      if (n * 8 >= wc) continue;
      const int c = c0 + n * 8 + 2 * tq;
      if (pairs) {
        if (c < C)
          *reinterpret_cast<uint32_t*>(orow + c) = vmt::pack_bf16x2(
              xr(r, c) + p.out_bias[c] + dacc[n][2 * h8],
              xr(r, c + 1) + p.out_bias[c + 1] + dacc[n][2 * h8 + 1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c + e < C)
            orow[c + e] = __float2bfloat16(xr(r, c + e) + p.out_bias[c + e] +
                                           dacc[n][2 * h8 + e]);
      }
    }
  }
}

// One block a (frame, span tokens), walked `tile` tokens at a time
// (resident: 64-token tiles, up to four; streamed: one tile of 64, 32 or
// 16); warp (rg, ch), rg < tile / 16 over the token rows, ch over 8 /
// (tile / 16) column parts. A q pass takes a head group (the resident
// mode: every head): q = y W_q on mma.sync (a part: a run of the group's
// heads, DP columns each), then head_apply into the oh tiles. The
// out-projection: parts x wc columns a block of W_out (the resident mode:
// all C in one), oh_hi W_out + oh_lo W_out on mma.sync, with
// bf16(x + out_bias + .) in the epilogue. With apply_ohg the oh tiles hold
// one group: each block of W_out columns takes the q pass and the
// group's W_out rows group by group.
template <int DP, bool kRes>
__global__ void __launch_bounds__(kLinThreads, 2) linear_head_any_apply_kernel(
    const HeadAny p) {
  constexpr int kNTD = DP / 8;
  // n8 tiles a warp at most: 128 q columns, the resident mode 64 (its
  // registers also hold the tile loop's state)
  constexpr int kNT = ((kRes ? 64 : 128) / DP) * kNTD;
  constexpr int kCP = DP + 8;                  // pitch of the ctxn blocks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M = p.tile, RG = M / 16, parts = 8 / RG;
  const int GA = p.group, heads = p.heads, d = p.d, N = p.N, C = p.C;
  const int H = heads * d, hpk = round32(heads * DP);
  const int WC = lin_apply_wc(M, C), CB = parts * WC;
  const int nkc = (C + kLinKC - 1) / kLinKC;
  const int ncb = (C + CB - 1) / CB, groups = (heads + GA - 1) / GA;
  // the oh tiles' columns: every head's, or one group's
  const int ohw = p.ohg ? round32(GA * DP) : hpk, ohp = ohw + 8;
  const int nkh = ohw / kLinKC;
  const int pad0 = p.ohg ? GA * DP : heads * DP;   // zero columns from here
  // pitches of the W_q and W_out chunks
  const int wpq = kRes ? GA * DP + 8 : lin_apply_wp(M, GA, DP, C);
  const int wpo = kRes ? CB + 8 : wpq;
  const int kXS = M * kLinXP;                  // elements of an x chunk
  const int stage = lin_stage_bytes(M, wpq);
  // shared memory: resident: W_q's chunks, gamma, W_out's chunks, two
  // tiles of x chunks, a tile of y chunks (then oh's hi and lo tiles);
  // streamed: the ring; then cs, mu, rstd (streamed: then oh's tiles)
  bf16* wq_res = reinterpret_cast<bf16*>(smem_raw);
  float* g_res = reinterpret_cast<float*>(wq_res + nkc * kLinKC * wpq);
  bf16* wo_res = reinterpret_cast<bf16*>(g_res + nkc * kLinKC);
  bf16* x_res = wo_res + hpk * wpo;
  bf16* y_res = x_res + 2 * nkc * kXS;
  const int yo = max(nkc * kXS, 2 * M * ohp);
  unsigned char* tail =
      kRes ? reinterpret_cast<unsigned char*>(y_res + yo)
           : smem_raw + p.stages * stage;
  bf16* cs = reinterpret_cast<bf16*>(tail);                    // [GA][2][DP][kCP]
  float* mu_s = reinterpret_cast<float*>(cs + GA * 2 * DP * kCP);  // [M]
  float* rs_s = mu_s + M;                                      // [M]
  bf16* oh_hi = kRes ? y_res : reinterpret_cast<bf16*>(rs_s + M);  // [M][ohp]
  bf16* oh_lo = oh_hi + M * ohp;                               // [M][ohp]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2;
  const int bf = blockIdx.y, n_blk = blockIdx.x * p.span;
  const int ntiles = (min(p.span, N - n_blk) + M - 1) / M;
  const bf16* xb = p.x + (size_t)bf * N * C;
  const bool vx = aligned16(p.x) && C % 8 == 0;
  const bool vg = aligned16(p.gamma) && C % 4 == 0;
  const bool vw = aligned16(p.w_qkv) && d % 8 == 0;
  const bool vo = aligned16(p.w_out) && C % 8 == 0;
  const int rg = warp % RG, ch = warp / RG, m0 = rg * 16;
  const int hpw = (GA + parts - 1) / parts;    // heads a warp in a q pass
  // this thread's pieces of the W_q and W_out chunks
  const LinUnit qun = lin_unit(GA * DP / 8, t), oun = lin_unit(CB / 8, t);
  // the oh tiles' columns past the last head (or group): zeros into
  // W_out's rows of the next heads, or its zero rows
  auto zero_pad = [&]() {
    const int w = ohw - pad0;
    for (int i = t; i < 2 * M * w; i += kLinThreads) {
      const int r = (i / w) % M, c = pad0 + i % w;
      (i < M * w ? oh_hi : oh_lo)[r * ohp + c] = __float2bfloat16(0.f);
    }
  };

  if constexpr (kRes) {
    // one q group (GA >= heads), the out-projection's columns in one block
    // (CB >= C). Group 0: the weights, gamma and tile 0's x; group 1: tile
    // 1's x; then one a tile, the tile two ahead
    auto xt = [&](int it, int kc) { return x_res + ((it & 1) * nkc + kc) * kXS; };
    auto load_x = [&](int it) {
      const int n0 = n_blk + it * M;
      for (int kc = 0; kc < nkc; ++kc)
        lin_load_x(xt(it, kc), xb, n0, N - n0, M, kc * kLinKC, C, vx, t);
    };
    for (int kc = 0; kc < nkc; ++kc) {
      lin_load_gamma(g_res + kc * kLinKC, p.gamma, kc * kLinKC, C, vg, t);
      lin_load_w<DP>(wq_res + kc * kLinKC * wpq, wpq, p.w_qkv, 3 * H,
                     kc * kLinKC, C, 0, 0, GA, 0, heads, d, vw, qun);
    }
    for (int kh = 0; kh < nkh; ++kh)
      lin_load_wout<DP>(wo_res + kh * kLinKC * wpo, wpo, p.w_out, kh * kLinKC,
                        0, C, heads, d, vo, oun);
    load_x(0);
    vmt::cp_async_commit();
    if (ntiles > 1) load_x(1);
    vmt::cp_async_commit();
    head_stage_ctx<DP>(p, cs, bf, 0, GA, t);
    const int nhw = max(0, min(hpw, heads - ch * hpw));
    for (int it = 0; it < ntiles; ++it) {
      const int n0 = n_blk + it * M, valid = min(M, N - n0);
      vmt::cp_async_wait<1>();
      __syncthreads();  // tile it's x (it = 0: the weights, cs) visible;
                        // the last tile's readers of oh done
      // y of tile it into y_res (x stays for the residual)
      const bf16* xtile = xt(it, 0);
      lin_ln_tile(xtile, y_res, kXS, g_res, valid, M, C, t);
      __syncthreads();  // y visible
      const float mu[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
      float acc[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      for (int kc = 0; kc < nkc; ++kc)
        lin_project<kNT, false>(acc, y_res + kc * kXS, g_res + kc * kLinKC,
                                wq_res + kc * kLinKC * wpq, wpq, m0,
                                ch * hpw * DP, nhw * kNTD, mu, rs, lane);
      __syncthreads();  // every warp done with y: the oh tiles go over it
      zero_pad();
      head_apply<DP>(acc, cs, oh_hi, oh_lo, ohp, 0, ch * hpw, nhw, d,
                     p.scale, m0, lane);
      __syncthreads();  // the oh tiles visible
      float dacc[kLinWC / 8][4];
#pragma unroll
      for (int n = 0; n < kLinWC / 8; ++n) dacc[n][0] = dacc[n][1] = dacc[n][2] = dacc[n][3] = 0.f;
      for (int kh = 0; kh < nkh; ++kh)
        head_out_chunk(dacc, oh_hi, oh_lo, ohp, kh,
                       wo_res + kh * kLinKC * wpo + ch * WC, wpo, WC, m0,
                       lane);
      head_store(dacc, p,
                 [&](int r, int c) { return lin_x_at(xtile, kXS, r, c); },
                 (size_t)bf * N + n0, valid, ch * WC, WC, m0, lane);
      __syncthreads();  // every warp done with tile it's x and the oh tiles
      if (it + 2 < ntiles) load_x(it + 2);
      vmt::cp_async_commit();
    }
  } else {
    const int n0 = n_blk, valid = min(M, N - n0);
    // the chunks in order: every group's W_q chunks (with x), then each
    // column block's W_out chunks; with ohg, per column block and group
    // its W_q chunks, then its W_out chunks
    const int per = nkc + nkh;
    const int nq = p.ohg ? ncb * groups * per : groups * nkc + ncb * nkh;
    const int S = p.stages;
    auto ring = [&](int q) { return smem_raw + (q % S) * stage; };
    auto xs = [&](int q) { return reinterpret_cast<bf16*>(ring(q)); };
    auto gs = [&](int q) { return reinterpret_cast<float*>(xs(q) + kXS); };
    auto ws = [&](int q) { return reinterpret_cast<bf16*>(gs(q) + kLinKC); };
    auto load_chunk = [&](int q) {
      int gi = 0, kc = -1, kp0 = 0, c0 = 0;
      if (!p.ohg) {
        if (q < groups * nkc) {
          gi = q / nkc;
          kc = q % nkc;
        } else {
          const int r = q - groups * nkc;
          kp0 = (r % nkh) * kLinKC;
          c0 = (r / nkh) * CB;
        }
      } else {
        const int b = q / per, j = q % per;
        gi = b % groups;
        if (j < nkc) {
          kc = j;
        } else {
          kp0 = gi * GA * DP + (j - nkc) * kLinKC;
          c0 = (b / groups) * CB;
        }
      }
      if (kc >= 0) {
        const int k0 = kc * kLinKC;
        lin_load_x(xs(q), xb, n0, valid, M, k0, C, vx, t);
        lin_load_gamma(gs(q), p.gamma, k0, C, vg, t);
        lin_load_w<DP>(ws(q), wpq, p.w_qkv, 3 * H, k0, C, 0, 0, GA, gi * GA,
                       heads, d, vw, qun);
      } else {
        lin_load_wout<DP>(ws(q), wpq, p.w_out, kp0, c0, C, heads, d, vo,
                          oun);
      }
    };
    for (int q = 0; q < S - 1; ++q) {
      if (q < nq) load_chunk(q);
      vmt::cp_async_commit();
    }
    zero_pad();
    lin_row_stats(xb, n0, valid, M, C, mu_s, rs_s, t);

    int q = 0;
    float mu[2], rs[2];
    // group gi's q pass: its ctxn blocks, q over the K-chunks, head_apply
    auto q_pass = [&](int gi) {
      const int h0 = gi * GA;
      __syncthreads();  // the last pass's readers of cs (and oh) done
      head_stage_ctx<DP>(p, cs, bf, h0, GA, t);
      const int hw0 = ch * hpw;
      const int nhw = max(0, min(hpw, min(GA, heads - h0) - hw0));
      float acc[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      for (int kc = 0; kc < nkc; ++kc, ++q) {
        lin_wait(S - 2);
        __syncthreads();  // chunk q visible (q = 0: mu, rstd too; the first
                          // of a pass: cs)
        if (q == 0) {
          mu[0] = mu_s[m0 + g];
          rs[0] = rs_s[m0 + g];
          mu[1] = mu_s[m0 + g + 8];
          rs[1] = rs_s[m0 + g + 8];
        }
        if (q + S - 1 < nq) load_chunk(q + S - 1);
        vmt::cp_async_commit();
        lin_project<kNT>(acc, xs(q), gs(q), ws(q), wpq, m0, hw0 * DP,
                         nhw * kNTD, mu, rs, lane);
      }
      head_apply<DP>(acc, cs, oh_hi, oh_lo, ohp, p.ohg ? 0 : h0 * DP, hw0,
                     nhw, d, p.scale, m0, lane);
    };
    // nkh W_out chunks of the oh tiles' columns into dacc
    auto out_pass = [&](float (&dacc)[kLinWC / 8][4]) {
      for (int kh = 0; kh < nkh; ++kh, ++q) {
        lin_wait(S - 2);
        __syncthreads();  // chunk q visible (the first: the oh tiles too)
        if (q + S - 1 < nq) load_chunk(q + S - 1);
        vmt::cp_async_commit();
        head_out_chunk(dacc, oh_hi, oh_lo, ohp, kh, ws(q) + ch * WC, wpq, WC,
                       m0, lane);
      }
    };
    auto xr = [&](int r, int c) { return bf2f(xb[(size_t)(n0 + r) * C + c]); };
    if (!p.ohg)
      for (int gi = 0; gi < groups; ++gi) q_pass(gi);
    for (int cbi = 0; cbi < ncb; ++cbi) {
      float dacc[kLinWC / 8][4];
#pragma unroll
      for (int n = 0; n < kLinWC / 8; ++n) dacc[n][0] = dacc[n][1] = dacc[n][2] = dacc[n][3] = 0.f;
      if (p.ohg) {
        for (int gi = 0; gi < groups; ++gi) {
          q_pass(gi);
          out_pass(dacc);
        }
      } else {
        out_pass(dacc);
      }
      head_store(dacc, p, xr, (size_t)bf * N + n0, valid, cbi * CB + ch * WC,
                 WC, m0, lane);
    }
  }
}

template <int DP>
cudaError_t apply_launch(const HeadAny& p, bool res, int smem, int BF,
                         cudaStream_t st) {
  auto kern = res ? linear_head_any_apply_kernel<DP, true>
                  : linear_head_any_apply_kernel<DP, false>;
  cudaError_t err = lin_smem_attrs(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((p.N + p.span - 1) / p.span, BF), kLinThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

cudaError_t vmt_head::launch_apply(const HeadAny& p, int dp, bool res,
                                   int smem, int BF, cudaStream_t st) {
  switch (dp) {
    case 16: return apply_launch<16>(p, res, smem, BF, st);
    case 32: return apply_launch<32>(p, res, smem, BF, st);
    case 48: return apply_launch<48>(p, res, smem, BF, st);
    default: return apply_launch<64>(p, res, smem, BF, st);
  }
}
