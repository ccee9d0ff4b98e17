// The head-layout linear forward at any shape (row 8), for sm_90a.
//
// Replaces, at every shape outside the specialised instance's set (8 heads
// of 32, C in {64, 128, 256, 512}; fused_linear_block.cu's head mode):
//   videometamaterials_tpu/ops/pallas/fused_linear_block.py:_kernel, layout
//     "head" (pallas_call in _run_kernel)           -> vmt_linear_head_any
//
// Every size is a launch argument: frames BF, tokens N, channels C, heads
// and head width d <= 64 (hidden H = heads d), conditioning tokens Mc.
// The arithmetic is the JAX head kernel's (fused_linear_block.py:336-411;
// linear_block_head_plain):
//   y    = bf16(LN(x) gamma)                  two-pass
//   q, k, v = y W_qkv                         f32 sums of bf16 products
//   P    = softmax_tok([ek || k])             per feature, max-shifted,
//                                             unclamped
//   ctxn = P^T [ev || v] / HW                 f32
//   Q    = scale softmax_head(q)              f32
//   out  = bf16(x + out_bias + (Q ctxn) W_out)
// The float32 products run on the tensor cores through the bf16 hi + lo
// split (X = bf16(X) + bf16(X - bf16(X)), about 16 of f32's 24
// significant bits, f32 sums), the lo x lo term left out (below 2^-16 of
// the product), as the specialised head mode takes its apply:
//   ctx  = P_hi v_hi + P_hi v_lo + P_lo v_hi  (v: v / HW)
//   oh   = Q_hi c_hi + Q_hi c_lo + Q_lo c_hi  (c: ctxn)
//   out-projection oh_hi W_out + oh_lo W_out  (W_out holds bf16 values)
// P sums against the running max of a tile's 64-token sub-tiles; the merge
// adds the conditioning tokens (f32) first, then the tiles in order. The
// rounding model: tests/test_torch_port_linear_bwd_rounding.py's
// kernel_rounding_head_fwd with stats_parts=2, parts=2.
//
// What bounds it on an H100: chip_smoke.py's head_cost, x read and out
// written once; the QKV projection (2 C 3H a token), ctx and Q ctxn as
// three products each (2 x 3 x 2 H d) and the out-projection twice (2 x 2
// H C): operations at the bf16 tensor-core rate at the path shapes.
//
// Design: two fused kernels and a merge on the pieces of rows 4-5
// (any_linear.cuh: x and the weights in K-chunks of 32 by cp.async, LN
// bit-equal to ln_rows_kernel, heads padded to DP = 16 ceil(d / 16)
// columns, a template parameter; the padding masked: 0 to the running max,
// -inf to the softmax's max, 0 in its sum and in the products). No float32
// q, k, v, y or oh reaches device memory; no float atomics (two launches
// give the same bits).
//  1. linear_head_any_stats_kernel, one block a (token tile, head group,
//     frame), warps as row 4's: per 64-token sub-tile k || v on mma.sync;
//     the column max of k (a shared row a row group), the running max (the
//     ctx strips and z rescaled by exp(m_old - m)), P = exp(k - m) and z in
//     f32 registers; P and v / HW into shared memory as bf16 hi and lo
//     tiles; ctx += P^T v as the three split products on mma.sync (A read
//     transposed by ldmatrix), a warp a 16-row strip of a head. Only the
//     tile's partials (m, z, ctx) reach device memory.
//  2. linear_head_any_merge, a block a (256 outputs, head, frame): the
//     maximum M, 1 / z and ctxn from the conditioning tokens and then the
//     tiles in order; ctxn's bf16 hi and lo blocks (DP x DP + 8, zeros
//     past d) for the apply.
//  3. linear_head_any_apply_kernel (any_linear_head_apply.cu, a source of
//     its own so that nvcc builds it beside this one), one block a (frame,
//     token span), warps as row 5's: q = y W_q on mma.sync, the per-head
//     softmax on the accumulator fragments (a head's row lies in one
//     quad), Q split into hi and lo A fragments against ctxn's hi and lo
//     blocks, oh into shared hi and lo tiles, then the out-projection as
//     two accumulations into one f32 accumulator against W_out,
//     bf16(x + out_bias + .) in the epilogue.
// Two modes a kernel, picked by the plan (head_plan, exported as
// vmt_linear_head_any_plan; fused_linear_block.head_any_plan mirrors it):
// resident (C <= 128 where two blocks an SM fit: the weights stay in
// shared memory, the next x rows arriving during this tile's products; the
// apply's oh tiles over its spent y tile) or streamed (a ring of 3 to
// kLinMaxStages cp.async stages, LN statistics from device memory). The
// streamed apply keeps oh for every head, or, where those hi and lo tiles
// of heads x DP do not fit a block, for one head group at a time (apply_ohg:
// each column block of the out-projection then takes the groups in turn,
// q recomputed a column block). No shape with d <= 64 is refused.
#include <math_constants.h>

#include "any_linear_head.cuh"
#include "reduce.cuh"

namespace {

// blocks that keep the card's 132 SMs busy (rows 4-5's targets): one a SM
// for the stats' head groups, two for the resident apply's span; the
// streamed apply takes its largest token tile with three quarters of that
constexpr int kHeadGridBlocks = 132, kHeadSpanBlocks = 264;
constexpr int kHeadApplyBlocks = 3 * kHeadGridBlocks / 4;
constexpr int kHeadSpanTiles = 4;     // 64-token tiles a resident apply block

// The launch plan of row 8 at a shape (vmt_linear_head_any_plan;
// fused_linear_block.head_any_plan mirrors it).
struct HeadPlan {
  int dp;            // d padded to k-steps of 16
  int stats_tile;    // tokens a stats block (sub-tiles of kLinStatM)
  int stats_group;   // heads a stats block: its k || v columns
  int stats_res;     // 1: the resident mode
  int stats_stages;  // streamed: ring stages
  int stats_smem;    // bytes
  int apply_tile;    // tokens an apply block's pass: 64, 32 or 16
  int apply_span;    // tokens an apply block (resident: up to 4 passes)
  int apply_group;   // heads a q pass of an apply block
  int apply_res;     // 1: the resident mode
  int apply_stages;  // streamed: ring stages
  int apply_smem;    // bytes
  int apply_ohg;     // 1: the oh tiles hold one head group at a time
};

// the pitch of the stats' P || v tile, which holds one part at a time:
// an even group's part (the k and v of half its heads, `half` columns),
// or one head's k and v
__host__ __device__ inline int head_pk_pitch(int group, int dp) {
  return (group == 1 ? 2 : group) * dp + 8;
}

// stats: resident: the W chunks, gamma, two sub-tiles of x chunks;
// streamed: the ring; then the P || v hi and lo tiles [2][64][pitch] bf16,
// the column max and z parts [4][half] each, the running max [2][half]
// and z [half] f32, mu, rstd
__host__ __device__ inline int head_stats_smem(int group, int dp, int C,
                                               bool res, int stages) {
  const int half = group * dp, wp = 2 * half + 8;
  const int nkc = (C + kLinKC - 1) / kLinKC;
  const int tail = 2 * kLinStatM * head_pk_pitch(group, dp) * 2 +
                   11 * half * 4 + kLinStatM * 8;
  return (res ? nkc * kLinKC * (wp * 2 + 4) +
                    2 * nkc * kLinStatM * kLinXP * 2
              : stages * lin_stage_bytes(kLinStatM, wp)) +
         tail;
}

// apply: resident: W_q's chunks, gamma, W_out's chunks, two tiles of x
// chunks, then y's chunks, over which oh's hi and lo tiles [2][tile][hpk +
// 8] go; streamed: the ring, then oh's hi and lo tiles [2][tile][ohw + 8]
// (ohw: hpk, or the group's columns rounded to kLinKC); both: ctxn's hi
// and lo blocks [group][2][dp][dp + 8] bf16, mu and rstd
__host__ __device__ inline int head_apply_smem(int tile, int group, int heads,
                                               int dp, int C, bool res,
                                               int stages, int ohw) {
  const int hpk = round32(heads * dp);
  const int nkc = (C + kLinKC - 1) / kLinKC;
  const int cb = (8 / (tile / 16)) * lin_apply_wc(tile, C);
  const int xchunk = tile * kLinXP * 2;
  const int common = group * 2 * dp * (dp + 8) * 2 + tile * 8;
  if (res) {
    const int y = nkc * xchunk, oh = 2 * tile * (hpk + 8) * 2;
    return nkc * kLinKC * ((group * dp + 8) * 2 + 4) + hpk * (cb + 8) * 2 +
           2 * nkc * xchunk + (y > oh ? y : oh) + common;
  }
  return stages * lin_stage_bytes(tile, lin_apply_wp(tile, group, dp, C)) +
         2 * tile * (ohw + 8) * 2 + common;
}

// false: a shape no plan takes (d > kMaxLinD)
bool head_plan(int BF, int N, int C, int heads, int d, HeadPlan* p) {
  if (BF <= 0 || N <= 0 || C <= 0 || heads <= 0 || d <= 0 || d > kMaxLinD)
    return false;
  const int dp = (d + 15) / 16 * 16;
  p->dp = dp;
  // stats: one head or an even number (stats_col), at most 128 k and 128 v
  // columns; halved while the grid has fewer than kHeadGridBlocks blocks,
  // then while neither mode fits (resident: two blocks an SM; streamed: at
  // kLinMinStages, two blocks an SM where the grid has more blocks than
  // SMs)
  p->stats_tile = N >= 4096 ? 256 : 64;
  auto even = [](int g) { return g > 1 && g % 2 ? g - 1 : g; };
  const long tiles = (N + p->stats_tile - 1) / p->stats_tile;
  auto sblocks = [&](int g) { return tiles * ((heads + g - 1) / g) * BF; };
  auto slimit = [&](int g) {
    return sblocks(g) > kHeadGridBlocks ? kLinResSmem : (int)kMaxSmem;
  };
  auto res_fits = [&](int g) {
    return C <= 128 && head_stats_smem(g, dp, C, true, 0) <= kLinResSmem;
  };
  int group = even(heads < 128 / dp ? heads : 128 / dp);
  while (group > 1 && sblocks(group) < kHeadGridBlocks) group = even(group / 2);
  while (group > 1 && !res_fits(group) &&
         head_stats_smem(group, dp, C, false, kLinMinStages) > slimit(group))
    group = even(group / 2);
  p->stats_group = group;
  p->stats_res = res_fits(group);
  p->stats_stages = p->stats_res ? 0 : lin_stages([&](int s) {
    return head_stats_smem(group, dp, C, false, s);
  }, slimit(group));
  p->stats_smem =
      head_stats_smem(group, dp, C, p->stats_res, p->stats_stages);
  // apply, resident: one q pass over every head (at most 64 q columns a
  // warp), the out-projection's columns in one block, two blocks an SM
  const int hpk = round32(heads * dp);
  const int cap = 2 * (64 / dp);
  const int ga = heads < cap ? heads : cap;
  p->apply_ohg = 0;
  if (ga == heads && 2 * lin_apply_wc(64, C) >= C &&
      head_apply_smem(64, ga, heads, dp, C, true, 0, hpk) <= kLinResSmem) {
    int span = kHeadSpanTiles;
    while (span > 1 &&
           (long)((N + 64 * span - 1) / (64 * span)) * BF < kHeadSpanBlocks)
      span /= 2;
    p->apply_tile = 64;
    p->apply_span = 64 * span;
    p->apply_group = ga;
    p->apply_res = 1;
    p->apply_stages = 0;
    p->apply_smem = head_apply_smem(64, ga, heads, dp, C, true, 0, hpk);
    return true;
  }
  // apply, streamed: a warp's q columns (a group over 8 / (tile / 16)
  // column parts) stay within 128. Where the grid of 64-token tiles has
  // more blocks than SMs, the largest token tile, then head group
  // (halved), that fits two blocks an SM; else the largest tile whose
  // grid has kHeadApplyBlocks blocks, else the smallest that fits. The oh
  // tiles of every head first, else of one group at a time
  const bool many = (long)((N + 63) / 64) * BF > kHeadGridBlocks;
  for (int ohg = 0; ohg < 2; ++ohg) {
    for (int tile = 64; many && tile >= 16; tile /= 2) {
      const int parts = 8 / (tile / 16);
      int gmax = parts * (128 / dp);
      if (gmax > kLinMaxCols / dp) gmax = kLinMaxCols / dp;
      if (gmax > heads) gmax = heads;
      for (int g = gmax;; g = (g + 1) / 2) {
        const int ohw = ohg ? round32(g * dp) : hpk;
        auto smem = [&](int s) {
          return head_apply_smem(tile, g, heads, dp, C, false, s, ohw);
        };
        if (smem(kLinMinStages) <= kLinResSmem) {
          p->apply_tile = p->apply_span = tile;
          p->apply_group = g;
          p->apply_res = 0;
          p->apply_stages = lin_stages(smem, kLinResSmem);
          p->apply_smem = smem(p->apply_stages);
          p->apply_ohg = ohg;
          return true;
        }
        if (g == 1) break;
      }
    }
    bool found = false;
    for (int tile = 64; tile >= 16; tile /= 2) {
      const int parts = 8 / (tile / 16);
      int g = parts * (128 / dp);
      if (g > kLinMaxCols / dp) g = kLinMaxCols / dp;
      if (g > heads) g = heads;
      const int ohw = ohg ? round32(g * dp) : hpk;
      auto smem = [&](int s) {
        return head_apply_smem(tile, g, heads, dp, C, false, s, ohw);
      };
      if (smem(kLinMinStages) > (int)kMaxSmem) continue;
      const long blocks = (long)((N + tile - 1) / tile) * BF;
      p->apply_tile = p->apply_span = tile;
      p->apply_group = g;
      p->apply_res = 0;
      p->apply_stages = lin_stages(
          smem, blocks > kHeadGridBlocks ? kLinResSmem : (int)kMaxSmem);
      p->apply_smem = smem(p->apply_stages);
      p->apply_ohg = ohg;
      found = true;
      if (blocks >= kHeadApplyBlocks) break;
    }
    if (found) return true;
  }
  return false;
}

// ---- 1. the token sums

// One block a (token tile, head group, frame); warp (rg, ch): token rows
// 16 rg.. of each 64-token sub-tile, column half ch of the group's k and v
// columns (stats_col, dp columns a head). Per sub-tile: k || v on
// mma.sync; the column max of k over the valid rows (a shared row a row
// group; 0 in the padding, so that the running max stays finite there),
// the running max m; P = exp(k - m) and z from the k fragments; then per
// part of the group (stats_col: an even group's two column halves, each
// the k and v of half its heads; one head's k and v together) its P and
// v / HW as bf16 hi and lo into the pk tiles, and, the strips rescaled to
// the new max, ctx_h += P_h^T v_h as three products on mma.sync, one warp
// a 16-row strip (head, 16 context rows) of the group. A part at a time
// keeps the pk tiles half as wide, so that four heads of 32 fit two
// blocks an SM.
template <int DP, bool kRes>
__global__ void __launch_bounds__(kLinThreads, 2) linear_head_any_stats_kernel(
    const HeadAny p) {
  constexpr int kNTD = DP / 8;                 // n8 tiles a head
  constexpr int kNT = (128 / DP) * kNTD;       // n8 tiles a warp at most
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int tt = blockIdx.x, bf = blockIdx.z;
  const int G = p.group, h0 = blockIdx.y * G, half = G * DP, wp = 2 * half + 8;
  const int pw = head_pk_pitch(G, DP);        // pitch of the pk tiles
  const int N = p.N, C = p.C, heads = p.heads, d = p.d, H = heads * d;
  const int n_begin = tt * p.tile, n_end = min(N, n_begin + p.tile);
  const int n_sub = (n_end - n_begin + kLinStatM - 1) / kLinStatM;
  const int nkc = (C + kLinKC - 1) / kLinKC, nq = n_sub * nkc;
  const bf16* xb = p.x + (size_t)bf * N * C;
  const bool vx = aligned16(p.x) && C % 8 == 0;
  const bool vg = aligned16(p.gamma) && C % 4 == 0;
  const bool vw = aligned16(p.w_qkv) && d % 8 == 0;
  const int rg = warp & 3, ch = warp >> 2, m0 = rg * 16;
  // the ctx strip of this warp: head hh of the group, context rows am0..
  const int strips = half / 16;
  const int hh = warp / (DP / 16), am0 = (warp % (DP / 16)) * 16;

  // shared memory: the chunks (resident: W, gamma, two sub-tiles of x;
  // streamed: the ring), then the tail
  constexpr int kXS = kLinStatM * kLinXP;      // elements of an x chunk
  const int stage = lin_stage_bytes(kLinStatM, wp);
  unsigned char* tail = smem_raw + (kRes ? nkc * kLinKC * (wp * 2 + 4) +
                                               2 * nkc * kXS * 2
                                         : p.stages * stage);
  bf16* pk_hi = reinterpret_cast<bf16*>(tail);                  // [64][pw]
  bf16* pk_lo = pk_hi + kLinStatM * pw;                         // [64][pw]
  float* cmax = reinterpret_cast<float*>(pk_lo + kLinStatM * pw);  // [4][half]
  float* zpart = cmax + 4 * half;                               // [4][half]
  float* mrun = zpart + 4 * half;                               // [2][half]
  float* zrun = mrun + 2 * half;                                // [half]
  float* mu_s = zrun + half;                                    // [64]
  float* rs_s = mu_s + kLinStatM;                               // [64]
  bf16* wres = reinterpret_cast<bf16*>(smem_raw);
  float* gres = reinterpret_cast<float*>(wres + nkc * kLinKC * wp);
  bf16* xres = reinterpret_cast<bf16*>(gres + nkc * kLinKC);
  // the x, gamma and W of chunk kc of sub-tile s
  const int S = p.stages;
  auto ring = [&](int s, int kc) { return smem_raw + ((s * nkc + kc) % S) * stage; };
  auto xs = [&](int s, int kc) {
    return kRes ? xres + ((s & 1) * nkc + kc) * kXS
                : reinterpret_cast<bf16*>(ring(s, kc));
  };
  auto gs = [&](int s, int kc) {
    return kRes ? gres + kc * kLinKC
                : reinterpret_cast<float*>(reinterpret_cast<bf16*>(ring(s, kc)) + kXS);
  };
  auto ws = [&](int s, int kc) {
    return kRes ? wres + kc * kLinKC * wp
                : reinterpret_cast<bf16*>(gs(s, kc) + kLinKC);
  };
  const LinUnit wun = lin_unit(2 * half / 8, t);
  auto load_x = [&](int s, int kc) {
    const int ns = n_begin + s * kLinStatM;
    lin_load_x(xs(s, kc), xb, ns, n_end - ns, kLinStatM, kc * kLinKC, C, vx, t);
  };
  auto load_w = [&](int s, int kc) {
    lin_load_gamma(gs(s, kc), p.gamma, kc * kLinKC, C, vg, t);
    lin_load_wkv<DP>(ws(s, kc), wp, p.w_qkv, kc * kLinKC, C, G, h0, heads, d,
                     vw, wun);
  };

  if (kRes) {
    // group 0: the weights, gamma and sub-tile 0's x; group 1: sub-tile 1's
    for (int kc = 0; kc < nkc; ++kc) {
      load_w(0, kc);
      load_x(0, kc);
    }
    vmt::cp_async_commit();
    if (n_sub > 1)
      for (int kc = 0; kc < nkc; ++kc) load_x(1, kc);
    vmt::cp_async_commit();
  } else {
    for (int q = 0; q < S - 1; ++q) {
      if (q < nq) {
        load_x(q / nkc, q % nkc);
        load_w(q / nkc, q % nkc);
      }
      vmt::cp_async_commit();
    }
  }
  for (int i = t; i < half; i += kLinThreads) {
    mrun[i] = -CUDART_INF_F;
    zrun[i] = 0.f;
  }

  float cacc[kNTD][4];
#pragma unroll
  for (int n = 0; n < kNTD; ++n) cacc[n][0] = cacc[n][1] = cacc[n][2] = cacc[n][3] = 0.f;
  for (int s = 0; s < n_sub; ++s) {
    const int ns = n_begin + s * kLinStatM;
    const int valid = min(kLinStatM, n_end - ns);
    float acc[kNT][4];
    float mu[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if (kRes) {
      vmt::cp_async_wait<1>();
      __syncthreads();  // sub-tile s's x (s = 0: the weights) visible; the
                        // last sub-tile's readers of pk, cmax, zpart done
      // y over the sub-tile's x rows, in place
      bf16* xsub = xs(s, 0);
      lin_ln_tile(xsub, xsub, kXS, gres, valid, kLinStatM, C, t);
      __syncthreads();  // y visible
      for (int kc = 0; kc < nkc; ++kc)
        lin_project<kNT, false>(acc, xs(s, kc), gs(s, kc), ws(s, kc), wp, m0,
                                ch * half, half / 8, mu, rs, lane);
    } else {
      // the last sub-tile's readers of mu and rstd are past its barriers
      lin_row_stats(xb, ns, valid, kLinStatM, C, mu_s, rs_s, t);
      for (int kc = 0; kc < nkc; ++kc) {
        const int q = s * nkc + kc;
        lin_wait(S - 2);
        __syncthreads();  // chunk q (and mu, rstd) visible; slot q - 1 free
        if (kc == 0) {
          mu[0] = mu_s[m0 + g];
          rs[0] = rs_s[m0 + g];
          mu[1] = mu_s[m0 + g + 8];
          rs[1] = rs_s[m0 + g + 8];
        }
        const int qn = q + S - 1;
        if (qn < nq) {
          load_x(qn / nkc, qn % nkc);
          load_w(qn / nkc, qn % nkc);
        }
        vmt::cp_async_commit();
        lin_project<kNT>(acc, xs(s, kc), gs(s, kc), ws(s, kc), wp, m0,
                         ch * half, half / 8, mu, rs, lane);
      }
    }

    // the column max of the k columns over the valid rows (an n8 tile is
    // all k or all v: the parts' k and v blocks are dp wide)
    const bool v0 = m0 + g < valid, v1 = m0 + g + 8 < valid;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (n * 8 >= half) continue;
      const KvCol kc = stats_col<DP>(ch, n * 8 + 2 * tq, G);
      if (kc.v) continue;
      float c0 = fmaxf(v0 ? acc[n][0] : -CUDART_INF_F,
                       v1 ? acc[n][2] : -CUDART_INF_F);
      float c1 = fmaxf(v0 ? acc[n][1] : -CUDART_INF_F,
                       v1 ? acc[n][3] : -CUDART_INF_F);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        c0 = fmaxf(c0, __shfl_xor_sync(0xffffffffu, c0, o));
        c1 = fmaxf(c1, __shfl_xor_sync(0xffffffffu, c1, o));
      }
      const bool hv = h0 + kc.hl < heads;
      const int col = kc.hl * DP + kc.a;
      if (g == 0) {
        cmax[rg * half + col] = hv && kc.a < d ? c0 : 0.f;
        cmax[rg * half + col + 1] = hv && kc.a + 1 < d ? c1 : 0.f;
      }
    }
    __syncthreads();  // cmax visible

    // the new running max of a k column of the group, and the factor that
    // takes a sum at the old max to the new one
    const float* mold = mrun + (s & 1) * half;
    auto m_new = [&](int col) {
      float mn = mold[col];
#pragma unroll
      for (int r = 0; r < 4; ++r) mn = fmaxf(mn, cmax[r * half + col]);
      return mn;
    };
    auto rescale = [&](int col) { return expf(mold[col] - m_new(col)); };
    // P and z from the k fragments, v / HW from the v fragments, in place
    // of the accumulators; rows past the tile's end and columns past a
    // head's d count nothing
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (n * 8 >= half) continue;
      const KvCol kc = stats_col<DP>(ch, n * 8 + 2 * tq, G);
      const bool hv = h0 + kc.hl < heads;
      const bool c0 = kc.a < d && hv, c1 = kc.a + 1 < d && hv;
      const int col = kc.hl * DP + kc.a;
      float (&e)[4] = acc[n];
      if (!kc.v) {
        const float mn0 = m_new(col), mn1 = m_new(col + 1);
        e[0] = v0 && c0 ? expf(e[0] - mn0) : 0.f;
        e[1] = v0 && c1 ? expf(e[1] - mn1) : 0.f;
        e[2] = v1 && c0 ? expf(e[2] - mn0) : 0.f;
        e[3] = v1 && c1 ? expf(e[3] - mn1) : 0.f;
        float z0 = e[0] + e[2], z1 = e[1] + e[3];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          z0 += __shfl_xor_sync(0xffffffffu, z0, o);
          z1 += __shfl_xor_sync(0xffffffffu, z1, o);
        }
        if (g == 0) {
          zpart[rg * half + col] = z0;
          zpart[rg * half + col + 1] = z1;
        }
      } else {
        e[0] = v0 && c0 ? e[0] * p.inv_hw : 0.f;
        e[1] = v0 && c1 ? e[1] * p.inv_hw : 0.f;
        e[2] = v1 && c0 ? e[2] * p.inv_hw : 0.f;
        e[3] = v1 && c1 ? e[3] * p.inv_hw : 0.f;
      }
    }

    // a part at a time: its P and v as bf16 hi and lo into the pk tiles,
    // then ctx_h[a][e] at the new max: the strips of its heads rescaled,
    // then += sum_tok P[tok][a] v[tok][e] as P_hi v_hi + P_hi v_lo +
    // P_lo v_hi
    const int nph = G == 1 ? 1 : 2, gh = G == 1 ? 1 : G / 2;
    const int off0 = (m0 + g) * pw + (G == 1 ? ch * half : 0) + 2 * tq;
    const int off1 = off0 + 8 * pw;
    for (int ph = 0; ph < nph; ++ph) {
      if (G == 1 || ch == ph) {
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (n * 8 >= half) continue;
          const float (&e)[4] = acc[n];
          *reinterpret_cast<uint32_t*>(pk_hi + off0 + n * 8) = vmt::pack_bf16x2(e[0], e[1]);
          *reinterpret_cast<uint32_t*>(pk_hi + off1 + n * 8) = vmt::pack_bf16x2(e[2], e[3]);
          *reinterpret_cast<uint32_t*>(pk_lo + off0 + n * 8) = lo_bf16x2(e[0], e[1]);
          *reinterpret_cast<uint32_t*>(pk_lo + off1 + n * 8) = lo_bf16x2(e[2], e[3]);
        }
      }
      __syncthreads();  // part ph's pk (and, ph = 0, zpart) visible;
                        // resident: sub-tile s's x read by every warp
      if (kRes && ph == 0) {
        if (s + 2 < n_sub)
          for (int kc = 0; kc < nkc; ++kc) load_x(s + 2, kc);
        vmt::cp_async_commit();
      }
      if (warp < strips && hh / gh == ph) {
        const float s0 = rescale(hh * DP + am0 + g);
        const float s1 = rescale(hh * DP + am0 + g + 8);
#pragma unroll
        for (int n = 0; n < kNTD; ++n) {
          cacc[n][0] *= s0;
          cacc[n][1] *= s0;
          cacc[n][2] *= s1;
          cacc[n][3] *= s1;
        }
        // head hh's k and v columns in its part's tile
        const int k_off = (hh % gh) * DP, v_off = gh * DP + k_off;
#pragma unroll
        for (int ks = 0; ks < kLinStatM / 16; ++ks) {
          const int ao = (ks * 16 + vmt::at_row_off(lane)) * pw + k_off + am0 +
                         vmt::at_col_off(lane);
          uint32_t ah[4], al[4];
          vmt::ldsm_x4_t(ah, pk_hi + ao);
          vmt::ldsm_x4_t(al, pk_lo + ao);
#pragma unroll
          for (int np = 0; np < kNTD / 2; ++np) {
            const int bo = (ks * 16 + vmt::bk_row_off(lane)) * pw + v_off +
                           np * 16 + vmt::bk_col_off(lane);
            uint32_t bh[4], bl[4];
            vmt::ldsm_x4_t(bh, pk_hi + bo);
            vmt::ldsm_x4_t(bl, pk_lo + bo);
            vmt::mma_bf16(cacc[2 * np], ah, bh[0], bh[1]);
            vmt::mma_bf16(cacc[2 * np + 1], ah, bh[2], bh[3]);
            vmt::mma_bf16(cacc[2 * np], ah, bl[0], bl[1]);
            vmt::mma_bf16(cacc[2 * np + 1], ah, bl[2], bl[3]);
            vmt::mma_bf16(cacc[2 * np], al, bh[0], bh[1]);
            vmt::mma_bf16(cacc[2 * np + 1], al, bh[2], bh[3]);
          }
        }
      }
      if (ph + 1 < nph) __syncthreads();  // part ph's pk read
    }
    // z at the new max; the next sub-tile's max into the other buffer
    for (int i = t; i < half; i += kLinThreads) {
      const float zs = ((zpart[i] + zpart[half + i]) + zpart[2 * half + i]) +
                       zpart[3 * half + i];
      zrun[i] = zrun[i] * rescale(i) + zs;
      mrun[((s + 1) & 1) * half + i] = m_new(i);
    }
  }
  __syncthreads();  // the last zrun and mrun writes visible

  // the tile's partials
  const size_t pidx = (size_t)bf * gridDim.x + tt;
  if (warp < strips && h0 + hh < heads) {
    float* pc = p.part_ctx + (pidx * heads + h0 + hh) * d * d;
#pragma unroll
    for (int n = 0; n < kNTD; ++n)
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int a = am0 + g + 8 * h8;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * tq + e;
          if (a < d && col < d) pc[a * d + col] = cacc[n][2 * h8 + e];
        }
      }
  }
  for (int i = t; i < half; i += kLinThreads) {
    const int h = h0 + i / DP, a = i % DP;
    if (h < heads && a < d) {
      p.part_m[pidx * H + h * d + a] = mrun[(n_sub & 1) * half + i];
      p.part_z[pidx * H + h * d + a] = zrun[i];
    }
  }
}

// ---- 2. the merge: a block a (256 outputs, head, frame)

// M = the max over the conditioning tokens and the tiles, z, ctxn = (the
// conditioning tokens' exp(k - M) (v / HW), then the tiles' partials
// rescaled, in order) / z; ctxn's bf16 hi and lo into the head's padded
// [2][dp][dp + 8] blocks (zeros past d). Each block works out M and 1 / z
// of every feature (the same bits in each) and takes 256 of the d^2
// outputs, a thread one, so the tiles' partials are read by many blocks
// at once; block 0 writes the padding.
__global__ void __launch_bounds__(kLinThreads) linear_head_any_merge(
    const float* __restrict__ part_m, const float* __restrict__ part_z,
    const float* __restrict__ part_ctx, const bf16* __restrict__ ek,
    const bf16* __restrict__ ev, bf16* __restrict__ ctxp, int tiles, int Mc,
    int heads, int d, int dp, float inv_hw) {
  extern __shared__ float smem_f[];
  const int t = threadIdx.x, h = blockIdx.y, bf = blockIdx.z;
  const int H = heads * d, dd = d * d, cp = dp + 8;
  float* M = smem_f;         // [d]
  float* zi = M + d;         // [d]
  const bf16* ekb = ek + (size_t)bf * Mc * H + h * d;
  const bf16* evb = ev + (size_t)bf * Mc * H + h * d;
  const size_t pb = (size_t)bf * tiles;  // tile k's partials: pb + k
  bf16* cpad = ctxp + ((size_t)bf * heads + h) * 2 * dp * cp;
  if (blockIdx.x == 0)
    for (int i = t; i < 2 * dp * cp; i += kLinThreads) {
      const int a = (i / cp) % dp, e = i % cp;
      if (a >= d || e >= d) cpad[i] = __float2bfloat16(0.f);
    }
  if (t < d) {
    float m = -CUDART_INF_F;
    for (int mc = 0; mc < Mc; ++mc) m = fmaxf(m, bf2f(ekb[(size_t)mc * H + t]));
    for (int k = 0; k < tiles; ++k)
      m = fmaxf(m, part_m[(pb + k) * H + h * d + t]);
    float z = 0.f;
    for (int mc = 0; mc < Mc; ++mc) z += expf(bf2f(ekb[(size_t)mc * H + t]) - m);
    for (int k = 0; k < tiles; ++k) {
      const size_t pi = (pb + k) * H + h * d + t;
      z = fmaf(part_z[pi], expf(part_m[pi] - m), z);
    }
    M[t] = m;
    zi[t] = 1.f / z;
  }
  __syncthreads();
  const int o = blockIdx.x * kLinThreads + t;
  if (o >= dd) return;
  const int ai = o / d, e = o % d;
  float c = 0.f;
  for (int mc = 0; mc < Mc; ++mc)
    c = fmaf(expf(bf2f(ekb[(size_t)mc * H + ai]) - M[ai]),
             bf2f(evb[(size_t)mc * H + e]) * inv_hw, c);
  for (int k = 0; k < tiles; ++k) {
    const size_t pi = ((pb + k) * heads + h) * dd + o;
    c = fmaf(part_ctx[pi], expf(part_m[(pb + k) * H + h * d + ai] - M[ai]), c);
  }
  c *= zi[ai];
  const float hi = round_bf16(c);
  cpad[ai * cp + e] = __float2bfloat16(hi);
  cpad[(dp + ai) * cp + e] = __float2bfloat16(c - hi);
}

// the stats (sp: the plan's stats fields), the merge into ctxp, the apply
// (ap: the apply's; any_linear_head_apply.cu)
template <int DP>
cudaError_t head_launch(const HeadAny& sp, const HeadAny& ap,
                        const HeadPlan& pl, int BF, int Mc, const bf16* ek,
                        const bf16* ev, bf16* ctxp, cudaStream_t st) {
  const int heads = sp.heads;
  auto ks = pl.stats_res ? linear_head_any_stats_kernel<DP, true>
                         : linear_head_any_stats_kernel<DP, false>;
  cudaError_t err = lin_smem_attrs(ks, pl.stats_smem);
  if (err != cudaSuccess) return err;
  const int tiles = (sp.N + pl.stats_tile - 1) / pl.stats_tile;
  ks<<<dim3(tiles, (heads + pl.stats_group - 1) / pl.stats_group, BF),
       kLinThreads, pl.stats_smem, st>>>(sp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int mblocks = (sp.d * sp.d + kLinThreads - 1) / kLinThreads;
  linear_head_any_merge<<<dim3(mblocks, heads, BF), kLinThreads,
                          (size_t)2 * sp.d * sizeof(float), st>>>(
      sp.part_m, sp.part_z, sp.part_ctx, ek, ev, ctxp, tiles, Mc, heads,
      sp.d, DP, sp.inv_hw);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return vmt_head::launch_apply(ap, DP, pl.apply_res, pl.apply_smem, BF, st);
}

// the workspace, carved in 256-byte pieces (p null: the size only): the
// stats' partials m, z (BF, tiles, H) and ctx (BF, tiles, heads, d, d)
// f32, then ctxn's hi and lo blocks (BF, heads, 2, dp, dp + 8) bf16
struct HeadWs {
  float *part_m, *part_z, *part_ctx;
  bf16* ctxp;
  size_t bytes;
};

HeadWs head_ws(void* p, int BF, int N, int heads, int d, const HeadPlan& pl) {
  char* base = static_cast<char*>(p);
  size_t used = 0;
  auto take = [&](size_t bytes) {
    void* out = base == nullptr ? nullptr : base + used;
    used += vmt::align256(bytes);
    return out;
  };
  const size_t parts =
      (size_t)BF * ((N + pl.stats_tile - 1) / pl.stats_tile) * heads;
  HeadWs w;
  w.part_m = static_cast<float*>(take(parts * d * sizeof(float)));
  w.part_z = static_cast<float*>(take(parts * d * sizeof(float)));
  w.part_ctx = static_cast<float*>(take(parts * d * d * sizeof(float)));
  w.ctxp = static_cast<bf16*>(
      take((size_t)BF * heads * 2 * pl.dp * (pl.dp + 8) * sizeof(bf16)));
  w.bytes = used;
  return w;
}

}  // namespace

// The launch plan of row 8 at (BF, N, C, heads, d), as 13 ints into plan:
// dp; stats tile, head group, resident (0 or 1), ring stages (0 when
// resident), shared memory bytes; apply tile, span, head group, resident,
// ring stages, shared memory bytes, oh by head group (0 or 1).
// Returns 0, or cudaErrorInvalidValue for a shape no plan takes (d > 64).
// fused_linear_block.head_any_plan is its mirror.
extern "C" int vmt_linear_head_any_plan(int BF, int N, int C, int heads,
                                        int d, int* plan) {
  HeadPlan pl;
  if (!head_plan(BF, N, C, heads, d, &pl)) return (int)cudaErrorInvalidValue;
  const int v[13] = {pl.dp,          pl.stats_tile,  pl.stats_group,
                     pl.stats_res,   pl.stats_stages, pl.stats_smem,
                     pl.apply_tile,  pl.apply_span,  pl.apply_group,
                     pl.apply_res,   pl.apply_stages, pl.apply_smem,
                     pl.apply_ohg};
  for (int i = 0; i < 13; ++i) plan[i] = v[i];
  return 0;
}

// Bytes of vmt_linear_head_any's workspace at its plan (0: no plan).
extern "C" size_t vmt_linear_head_any_workspace(int BF, int N, int C,
                                                int heads, int d) {
  HeadPlan pl;
  if (!head_plan(BF, N, C, heads, d, &pl)) return 0;
  return head_ws(nullptr, BF, N, heads, d, pl).bytes;
}

// The head layout's forward at any shape (d <= 64), row 8's any-shape
// instance. x (BF, N, C) bf16; gamma (C) f32; w_qkv (C, 3H), w_out (H, C)
// bf16; out_bias (C) f32; ek/ev (BF, Mc, H) bf16 or null when Mc == 0.
// Out: out (BF, N, C) bf16. workspace: vmt_linear_head_any_workspace()
// bytes. Three launches (stats, merge, apply) as the plan says.
extern "C" int vmt_linear_head_any(
    const void* x, const void* gamma, const void* w_qkv, const void* w_out,
    const void* out_bias, const void* ek, const void* ev, void* out,
    void* workspace, int BF, int N, int C, int Mc, int heads, int d,
    float scale, float inv_hw, void* stream) {
  HeadPlan pl;
  if (Mc < 0 || (Mc > 0 && (ek == nullptr || ev == nullptr)) ||
      !head_plan(BF, N, C, heads, d, &pl))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const HeadWs w = head_ws(workspace, BF, N, heads, d, pl);
  HeadAny p{};
  p.x = static_cast<const bf16*>(x);
  p.gamma = static_cast<const float*>(gamma);
  p.w_qkv = static_cast<const bf16*>(w_qkv);
  p.w_out = static_cast<const bf16*>(w_out);
  p.out_bias = static_cast<const float*>(out_bias);
  p.ctxp = w.ctxp;
  p.out = static_cast<bf16*>(out);
  p.part_m = w.part_m;
  p.part_z = w.part_z;
  p.part_ctx = w.part_ctx;
  p.N = N; p.C = C; p.heads = heads; p.d = d;
  p.scale = scale;
  p.inv_hw = inv_hw;
  // the stats kernel reads the stats fields, the apply the apply's
  HeadAny sp = p, ap = p;
  sp.tile = pl.stats_tile;
  sp.group = pl.stats_group;
  sp.stages = pl.stats_stages;
  ap.tile = pl.apply_tile;
  ap.span = pl.apply_span;
  ap.group = pl.apply_group;
  ap.stages = pl.apply_stages;
  ap.ohg = pl.apply_ohg;
  const bf16* ekb = static_cast<const bf16*>(ek);
  const bf16* evb = static_cast<const bf16*>(ev);
  cudaError_t err;
  switch (pl.dp) {
    case 16: err = head_launch<16>(sp, ap, pl, BF, Mc, ekb, evb, w.ctxp, st); break;
    case 32: err = head_launch<32>(sp, ap, pl, BF, Mc, ekb, evb, w.ctxp, st); break;
    case 48: err = head_launch<48>(sp, ap, pl, BF, Mc, ekb, evb, w.ctxp, st); break;
    default: err = head_launch<64>(sp, ap, pl, BF, Mc, ekb, evb, w.ctxp, st); break;
  }
  return (int)err;
}
