// The linear-attention block's backward at any shape (rows 6 and 7), for
// sm_90a.
//
// Replaces, at every shape outside the specialised instance's set (8 heads
// of 32, C in {64, 128, 256, 512}; fused_linear_block_bwd.cu):
//   videometamaterials_tpu/ops/pallas/fused_linear_block.py:
//     _bwd_kernel        (per-head, pallas_call in _run_bwd_kernel)  clip = 0
//     _bwd_kernel_merged (pallas_call in _run_bwd_kernel_merged)     clip = 1
// -> vmt_linear_block_bwd_any. The two rows differ in one place: the
// merged row differentiates exp(clip(k, +-60)) and zeroes dk and dek where
// |k| >= 60; the per-head row differentiates the unclamped softmax.
//
// Every size is a launch argument: frames BF, tokens N, channels C, heads
// and head width d <= 64 (hidden H = heads d), conditioning tokens Mc.
// The cotangents and their layouts are the specialised kernel's: dx bf16;
// dgamma, dw_qkv (C, 3H), dw_out (H, C), dout_bias, dek, dev (BF, Mc, H),
// all f32. The arithmetic (fused_linear_block_bwd.cu's note): P = token
// softmax of kk (clip ? clip(k) : k), ctx = P^T v / HW, Q = scale
// softmax_head(q), g_oh = g W_out^T, dctx = Q^T g_oh, dQ = g_oh ctx^T, dq
// = Q dQ - (Q / scale) sum_head Q dQ, dP = dctx v^T / HW, dk = P (dP - S),
// S = sum_e dctx ctx, dv = P dctx / HW, dy = dqkv W_qkv^T, dx = g + the LN
// backward of dy.
//
// Rounding points: the specialised backward's, one rounding model for both
// instances (tests/test_torch_port_linear_bwd_rounding.py's
// kernel_rounding_bwd, its `chunk` the plan's token tile). Every product
// takes bf16 operands and sums in f32 on the tensor cores: y, P, v / HW,
// Q and g_oh go to bf16 before the sums ctx and dctx, whose merged ctx and
// dctx go to bf16 before the per-token products; dq, dk, dv and oh go to
// bf16 for the weight sums and dy. P sums against the running max of the
// tile's 64-token sub-tiles; S takes the bf16 dctx that dP takes (a dctx
// rounded in dP but not in S would leave dP's rounding error in dk =
// P (dP - S), which cancels where one token holds a feature's softmax);
// the conditioning tokens' dek and dev are f32 but for that bf16 dctx.
// Every quantity keeps within 5e-2 of the JAX kernels' cotangents at d =
// 32 and 64 without a hi + lo split (the rounding tests).
//
// What bounds it on an H100: the specialised instance's work for these
// heads (the QKV and g_oh projections twice, six per-head DP x DP
// products, dy and the weight sums, reading x and g twice and writing dx,
// y, dqkv and oh): operations at the bf16 tensor-core rate at the
// training shapes (chip_smoke.py prints each launch's bound).
//
// Design: the specialised instance's two token passes at any shape, on
// the pieces of rows 4-5 (any_linear.cuh): heads padded to DP = 16
// ceil(d / 16) columns (a template parameter; the padding masked: -inf or
// 0 in the softmaxes, zero rows and columns in the products), x and the
// weights in K-chunks of 32 by cp.async, LN bit-equal to ln_rows_kernel;
// two warps a head and 16-row group (half 0 its [k | v], half 1 its
// [q | g_oh], 2 DP columns a warp). No float32 q, k, v, g_oh or dy
// reaches device memory; no float atomics (two launches give the same
// bits).
//  1. linear_any_bwd_sums_kernel, one block a (token tile, head, frame):
//     per 64-token sub-tile the projection on mma.sync (A = y, or g for
//     g_oh); half 0 the column max of kk (a shared row a row group), the
//     running max, P and z; half 1 Q; P, v / HW, Q and g_oh to a bf16
//     tile; ctx = P^T v (rescaled to the running max) and dctx = Q^T g_oh
//     on mma.sync, a warp a 16-row strip; the tile's partials to device
//     memory.
//  2. linear_any_bwd_merge, a block a (head, frame): the conditioning tokens
//     first, then the tiles in order; bf16 ctx and dctx (padded to DP), M,
//     1 / z, S; the conditioning tokens' dek and dev.
//  3. linear_any_bwd_tok_kernel, a block a (token tile, frame), the heads in
//     groups: each warp recomputes its head's [k | v] or [q | g_oh] from x
//     and g, then dk and dv, or dq and oh, as 16 x DP x DP products with
//     ctx and dctx from shared memory; dq, dk, dv and oh in bf16 to shared
//     tiles and once to device memory. Resident (C <= 128): dy += dqkv
//     W_qkv^T into a shared f32 tile, then the LN backward (dx) and the
//     block's dgamma and dout_bias partials.
//  4. streamed plans: linear_any_bwd_dx_kernel, a block a (token tile,
//     frame), the tile's dqkv rows resident: dy = dqkv W_qkv^T in
//     256-channel tiles twice (the rows' LN sums and the columns' dgamma
//     and dout_bias partials, then dx), W_qkv streamed, dy never stored.
//  5. the weight sums dW_qkv = y^T dqkv and dW_out = oh^T g: reduce.cu's
//     pipelined contraction where M and N are multiples of 64, else
//     any_contract.cuh's; reduce.cu's ordered column sums for dgamma and
//     dout_bias.
// Two modes a pass, picked by the plan (bwd_plan, exported as
// vmt_linear_bwd_any_plan; fused_linear_block.bwd_any_plan mirrors it):
// resident (C <= 128 where it fits: the weights and the tile's x and g
// chunks stay in shared memory; pass 2 prefetches the next head group's
// weights and context blocks during this one's work) or streamed (x, g,
// gamma and the weights through a ring of cp.async stages, the blocks
// starting the K-chunks at different points, the LN statistics from
// device memory and the x fragments normalised as they are read). What
// held the first version back, measured (PERF.md): per-step latency with
// few warps an SM, the float32 staging of the context blocks, a dy tile
// that left the streamed pass 2 one block an SM and the weights streamed
// once every 16 to 32 tokens.
#include <math_constants.h>

#include <algorithm>

#include "any_contract.cuh"
#include "any_linear.cuh"

namespace {

constexpr float kClamp = 60.f;
constexpr int kBT = kLinThreads;        // threads a block: 8 warps
constexpr int kSumM = kLinStatM;        // tokens a pass-1 sub-tile
constexpr int kSMs = 132;
constexpr int kMaxGCols = 128;          // a group's G DP at most

__device__ __forceinline__ float clip_k(float k, int clip) {
  return clip ? fminf(fmaxf(k, -kClamp), kClamp) : k;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// ---- the launch plan

// Two warps a head and row group: half 0 projects [k | v], half 1 [q |
// g_oh] (2 DP columns a warp). Heads a pass-2 group at most, at M tokens
// a block: one for each two warps of a row group, at most kMaxGCols
// padded columns.
__host__ __device__ inline int tok_group_max(int dp, int M) {
  const int g = 64 / M;
  return g < kMaxGCols / dp ? g : kMaxGCols / dp;
}

struct BwdPlan {
  int dp;           // d padded to k-steps of 16
  int sums_tile;    // tokens a pass-1 block (64-token sub-tiles)
  int sums_res;     // 1: pass 1 resident
  int sums_stages;  // streamed: ring stages
  int sums_smem;    // bytes
  int tok_rows;     // tokens a pass-2 block: 64, 32 or 16
  int tok_group;    // heads a pass-2 group
  int tok_res;      // 1: pass 2 resident
  int tok_stages;   // streamed: ring stages
  int tok_smem;     // bytes
  int dx_rows;      // streamed pass 2: tokens a pass-3 block (else 0)
  int dx_stages;    // its ring stages
  int dx_smem;      // bytes
};

// a ring stage: rows of x and of g (one K-chunk each), gamma's chunk, the
// chunk's weight rows at pitch wp
__host__ __device__ inline int bwd_stage_bytes(int rows, int wp) {
  return 2 * rows * kLinXP * 2 + kLinKC * 4 + kLinKC * wp * 2;
}

// pass 1 (one head, [k v q g_oh] columns at pitch wp = 4 dp + 8):
// resident: the weights and gamma, two sub-tiles of x and g chunks;
// streamed: the ring; then the [P v Q g_oh] tile, cmax and zpart [4][dp],
// the running max [2][dp] and z [dp], mu and rstd
__host__ __device__ inline int sums_smem(int dp, int C, bool res,
                                         int stages) {
  const int wp = 4 * dp + 8, nkc = (C + kLinKC - 1) / kLinKC;
  const int tail = kSumM * wp * 2 + 11 * dp * 4 + 2 * kSumM * 4;
  return (res ? nkc * kLinKC * (wp * 2 + 4) + 4 * nkc * kSumM * kLinXP * 2
              : stages * bwd_stage_bytes(kSumM, wp)) +
         tail;
}

// pass 2 (M tokens, G heads of [k v q g_oh] at pitch wp = 4 G dp + 8):
// resident: two groups' weights (this one's and the next's), gamma, the
// tile's x and g chunks; streamed: the ring; then, resident, dy
// [M][nkc 32 + 4] f32 (streamed: pass 3's), the dqkv tile [M][3 G dp + 8]
// and the oh tile [M][G dp + 8] bf16, the bf16 ctx / dctx blocks
// [G][2][dp][dp + 8] and M / zinv / S [3][G dp] (resident: two groups'),
// mu and rstd
__host__ __device__ inline int tok_smem(int dp, int C, int M, int G, bool res,
                                        int stages) {
  const int wp = 4 * G * dp + 8, nkc = (C + kLinKC - 1) / kLinKC;
  const int nbuf = res ? 2 : 1;
  const int tail = (res ? M * (nkc * kLinKC + 4) * 4 : 0) +
                   M * (3 * G * dp + 8) * 2 +
                   M * (G * dp + 8) * 2 +
                   nbuf * (G * 2 * dp * (dp + 8) * 2 + 3 * G * dp * 4) +
                   2 * M * 4;
  return (res ? nbuf * nkc * kLinKC * wp * 2 + nkc * kLinKC * 4 +
                    2 * nkc * M * kLinXP * 2
              : stages * bwd_stage_bytes(M, wp)) +
         tail;
}

// pass 3 (after a streamed pass 2): dy = dqkv W_qkv^T and the LN backward
// in 256-channel tiles (linear_any_bwd_dx_kernel)
constexpr int kDxN = 256;             // channels a tile
constexpr int kDxK = 64;              // dqkv columns a ring stage
constexpr int kDxBP = kDxK + 8;       // pitch of a stage's W rows (bf16)

// dqkv columns padded to whole stages
__host__ __device__ inline int dx_k(int H) {
  return (3 * H + kDxK - 1) / kDxK * kDxK;
}

// the dqkv rows [M][K + 8] bf16, the ring [stages][kDxN][kDxBP] bf16, mu,
// rstd, mean(dy gamma), mean(dy gamma xhat) [4][M], the row sums of the
// column parts [8][M][2] and the column sums of the row groups
// [4][2][kDxN] f32
__host__ __device__ inline int dx_smem(int H, int M, int stages) {
  return M * (dx_k(H) + 8) * 2 + stages * kDxN * kDxBP * 2 +
         (4 * M + 8 * M * 2 + 4 * 2 * kDxN) * 4;
}

// false: a shape no plan takes (d > kMaxLinD; 3H beyond what pass 3's
// dqkv rows of 16 tokens leave room for). The rules follow measurements
// on an H100 (PERF.md): resident passes where C <= 128 lets them;
// streamed pass 1 in the smallest tile a frame takes in at most 9 tiles
// (its weights stream once a 64-token sub-tile whatever the tile);
// streamed passes 2 and 3 in the token tile that finishes its waves of
// blocks soonest.
bool bwd_plan(int BF, int N, int C, int heads, int d, BwdPlan* p) {
  if (BF <= 0 || N <= 0 || C <= 0 || heads <= 0 || d <= 0 || d > kMaxLinD)
    return false;
  const int dp = (d + 15) / 16 * 16;
  p->dp = dp;
  // pass 1: resident, a tile whose grid keeps two blocks an SM; streamed,
  // the smallest tile of at most 9 a frame
  auto sblocks = [&](int tile) {
    return (long)((N + tile - 1) / tile) * heads * BF;
  };
  p->sums_res = C <= 128 && sums_smem(dp, C, true, 0) <= kLinResSmem;
  p->sums_tile = kSumM;
  if (p->sums_res) {
    for (int tile : {1024, 256})
      if (sblocks(tile) >= 2 * kSMs) {
        p->sums_tile = tile;
        break;
      }
  } else {
    for (int tile : {64, 256, 1024}) {
      p->sums_tile = tile;
      if ((N + tile - 1) / tile <= 9) break;
    }
  }
  const int slimit =
      sblocks(p->sums_tile) > kSMs ? kLinResSmem : (int)kMaxSmem;
  p->sums_stages = p->sums_res ? 0 : lin_stages([&](int s) {
    return sums_smem(dp, C, false, s);
  }, slimit);
  p->sums_smem = sums_smem(dp, C, p->sums_res, p->sums_stages);
  if (p->sums_smem > (int)kMaxSmem) return false;
  // the least ceil(blocks / (SMs x blocks an SM)) x (rows + 8) over the
  // token tiles whose shared memory at kLinMinStages stages, smem(rows),
  // fits; ties: the first. Sets rows and the stages' limit
  auto pick = [&](auto smem, int* rows, int* limit) {
    long best = 0;
    *rows = 0;
    for (int m : {64, 32, 16}) {
      const int sm = smem(m);
      if (sm > (int)kMaxSmem) continue;
      const int bps = sm <= kLinResSmem ? 2 : 1;
      const long waves = ((long)((N + m - 1) / m) * BF + kSMs * bps - 1) /
                         (kSMs * bps);
      if (*rows == 0 || waves * (m + 8) < best) {
        best = waves * (m + 8);
        *rows = m;
        *limit = bps == 2 ? kLinResSmem : (int)kMaxSmem;
      }
    }
  };
  // pass 2: resident where it fits (dy there); else streamed with the
  // full head group, dy left to pass 3
  int res = 0, M = 0, limit = (int)kMaxSmem;
  if (C <= 128 && tok_smem(dp, C, 64, 1, true, 0) <= (int)kMaxSmem) {
    res = 1, M = 64;
  } else {
    pick([&](int m) {
      return tok_smem(dp, C, m, tok_group_max(dp, m), false, kLinMinStages);
    }, &M, &limit);
  }
  if (M == 0) return false;
  const int G = res ? 1 : tok_group_max(dp, M);
  p->tok_rows = M;
  p->tok_group = G;
  p->tok_res = res;
  p->tok_stages = res ? 0 : lin_stages([&](int s) {
    return tok_smem(dp, C, M, G, false, s);
  }, limit);
  p->tok_smem = tok_smem(dp, C, M, G, res, p->tok_stages);
  // pass 3 after a streamed pass 2
  p->dx_rows = p->dx_stages = p->dx_smem = 0;
  if (!res) {
    const int H = heads * d;
    int M3 = 0, limit3 = (int)kMaxSmem;
    pick([&](int m) { return dx_smem(H, m, kLinMinStages); }, &M3, &limit3);
    if (M3 == 0) return false;
    p->dx_rows = M3;
    p->dx_stages =
        lin_stages([&](int s) { return dx_smem(H, M3, s); }, limit3);
    p->dx_smem = dx_smem(H, M3, p->dx_stages);
  }
  return true;
}

// ---- the kernels' arguments

struct BwdAny {
  const bf16* x;          // (BF, N, C)
  const float* gamma;     // (C)
  const bf16* w_qkv;      // (C, 3H)
  const bf16* w_outT;     // (C, H): W_out^T
  const bf16* g;          // (BF, N, C): the cotangent
  const bf16* ek;         // (BF, Mc, H) or null
  const bf16* ev;
  float* part_m;          // (BF, tiles, H): a tile's column max
  float* part_z;          // (BF, tiles, H)
  float* part_ctx;        // (BF, tiles, heads, d, d)
  float* part_dctx;
  bf16* ctxp;             // (BF, heads, 2, DP, DP + 8): bf16 ctx (merged,
                          // normalised) and dctx, zeros past d
  float* mzs;             // (BF, 3, heads, DP): M, 1 / z, S, zeros past d
  bf16* dx;               // (BF, N, C)
  bf16* y;                // (BF, N, C): for dW_qkv
  bf16* dqkv;             // (BF, N, 3H): [dq | dk | dv]
  bf16* oh;               // (BF, N, H): for dW_out
  float* part_dgamma;     // (pass-2 blocks, C)
  float* part_dob;
  int N, C, heads, d, Mc, clip;
  int tile, stages, rows, group;   // the launched pass's plan
  float scale, inv_hw;
};

// ---- pieces of both passes

// A warp's share of a head group's [k v q g_oh] columns (DP each a head):
// rows 16 rg.. and head slot `slot`; half 0 the head's k and v at n8
// tiles [0, kT) and [kT, 2 kT), half 1 its q and g_oh at the same tiles
template <int DP>
struct Warp {
  static constexpr int kT = DP / 8;       // n8 tiles a part
  static constexpr int kNT = 2 * kT;      // n8 tiles a warp
  int rg, slot, m0;
  bool kv, q;            // the warp's parts: k and v, q and g_oh
  int col0, g_from;      // its first weight column; tiles from g_from take A = g
  __device__ Warp(int warp, int RG) {
    rg = warp % RG;
    const int cw = warp / RG, half = cw & 1;
    slot = cw >> 1;
    m0 = rg * 16;
    kv = half == 0;
    q = half == 1;
    col0 = slot * 4 * DP + half * 2 * DP;
    g_from = half ? kT : kNT;
  }
};

// rows k0..k0+31 (zeros from C on) of a head group's weights into
// [kLinKC][wp]: head slot s (head h0 + s), part p of (k, v, q, g_oh) at
// columns (4 s + p) DP: W_qkv's columns H + h d, 2 H + h d, h d, or
// W_out^T's h d (zeros past d and past the last head); parts >= nparts
// are not loaded. vw: every head's columns 16-byte aligned
template <int DP>
__device__ __forceinline__ void bwd_load_w(bf16* dst, int wp, const BwdAny& p,
                                           int k0, int h0, int nparts,
                                           bool vw, LinUnit un) {
  const bf16 zero = __float2bfloat16(0.f);
  const int u = un.u, s = u / (4 * DP), part = (u / DP) % 4, a = u % DP;
  const int h = h0 + s, d = p.d, H = p.heads * d;
  if (part >= nparts) return;
  const bool col_ok = h < p.heads;
  const bf16* base = part == 3 ? p.w_outT + h * d + a
                               : p.w_qkv + (part == 0 ? H : part == 1 ? 2 * H : 0) +
                                     h * d + a;
  const int ld = part == 3 ? H : 3 * H;
  for (int r = un.r0; r < kLinKC; r += un.rstep) {
    const int k = k0 + r;
    const bool row_ok = k < p.C && col_ok;
    bf16* dd = dst + r * wp + u;
    const bf16* src = base + (size_t)k * ld;
    if (vw) {
      const bool ok = row_ok && a < d;
      vmt::cp_async16(dd, ok ? src : p.w_qkv, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dd[e] = (row_ok && a + e < d) ? src[e] : zero;
    }
  }
}

// acc += rows m0..m0+15 of a K-chunk times the warp's weight columns
// (Warp): A = y, or g for the tiles from g_from. kNorm: xs holds raw x,
// normalised to y in the fragments (mu, rs of rows m0 + g and + 8, gam the
// chunk's gamma); else xs holds y
template <int DP, bool kNorm>
__device__ __forceinline__ void bwd_project(float (&acc)[Warp<DP>::kNT][4],
                                            const bf16* xs, const bf16* gs,
                                            const float* gam, const bf16* ws,
                                            int wp, const Warp<DP>& w,
                                            const float (&mu)[2],
                                            const float (&rs)[2], int lane) {
  constexpr int kNT = Warp<DP>::kNT;
  const int tq = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kLinKC / 16; ++ks) {
    const int aoff = (w.m0 + vmt::a_row_off(lane)) * kLinXP + ks * 16 +
                     vmt::a_col_off(lane);
    uint32_t ay[4], ag[4] = {0u, 0u, 0u, 0u};
    vmt::ldsm_x4(ay, xs + aoff);
    if (kNorm) {
      const float2 g0 = *reinterpret_cast<const float2*>(gam + ks * 16 + 2 * tq);
      const float2 g1 =
          *reinterpret_cast<const float2*>(gam + ks * 16 + 2 * tq + 8);
      ay[0] = lin_norm2(ay[0], mu[0], rs[0], g0);
      ay[1] = lin_norm2(ay[1], mu[1], rs[1], g0);
      ay[2] = lin_norm2(ay[2], mu[0], rs[0], g1);
      ay[3] = lin_norm2(ay[3], mu[1], rs[1], g1);
    }
    if (w.q) vmt::ldsm_x4(ag, gs + aoff);
    const bf16* wrow = ws + (ks * 16 + vmt::bk_row_off(lane)) * wp + w.col0 +
                       vmt::bk_col_off(lane);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t bb[4], a[4];
      vmt::ldsm_x4_t(bb, wrow + np * 16);
      const bool use_g = 2 * np >= w.g_from;
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = use_g ? ag[e] : ay[e];
      vmt::mma_bf16(acc[2 * np], a, bb[0], bb[1]);
      vmt::mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// exp(q - m) of a head's column; 0 in the padding past d
__device__ __forceinline__ float head_col_exp(float q, float m, bool in_head) {
  return in_head ? expf(q - m) : 0.f;
}

// q (acc n8 tiles kQB..: 0) -> Q = scale e / sum_head e, e = exp(q - max),
// the padding past d -inf to the max and 0 to the sum; rows not v0 / v1 0
template <int DP, int kNT, int kQB>
__device__ __forceinline__ void q_softmax(float (&acc)[kNT][4], int d,
                                          float scale, bool v0, bool v1,
                                          int tq) {
  constexpr int kT = DP / 8;
#pragma unroll
  for (int h8 = 0; h8 < 2; ++h8) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < kT; ++n) {
      const int c = n * 8 + 2 * tq;
      if (c < d) mx = fmaxf(mx, acc[kQB + n][2 * h8]);
      if (c + 1 < d) mx = fmaxf(mx, acc[kQB + n][2 * h8 + 1]);
    }
    mx = quad_max(mx);
    float s = 0.f;
#pragma unroll
    for (int n = 0; n < kT; ++n) {
      const int c = n * 8 + 2 * tq;
      float (&v)[4] = acc[kQB + n];
      v[2 * h8] = head_col_exp(v[2 * h8], mx, c < d);
      v[2 * h8 + 1] = head_col_exp(v[2 * h8 + 1], mx, c + 1 < d);
      s += v[2 * h8] + v[2 * h8 + 1];
    }
    s = quad_sum(s);  // every lane shuffles, valid row or not
    const float r = (h8 ? v1 : v0) ? scale / s : 0.f;
#pragma unroll
    for (int n = 0; n < kT; ++n) {
      acc[kQB + n][2 * h8] *= r;
      acc[kQB + n][2 * h8 + 1] *= r;
    }
  }
}

// ---- pass 1: the token sums

// One block a (token tile, head, frame), the warps as Warp lays them out
// over 4 row groups. Per 64-token
// sub-tile: kk, its column max over the valid rows, the running max m (the
// ctx strips and z rescaled by exp(m_old - m)), P = exp(kk - m); P,
// v / HW, Q and g_oh to the pv tile as bf16; ctx += P^T (v / HW) and dctx
// += Q^T g_oh on mma.sync, a warp a 16-row strip of either of a head. The
// tile's partials (m, z, ctx, dctx) to device memory.
template <int DP, bool kRes>
__global__ void __launch_bounds__(kBT, DP <= 32 ? 2 : 1)
    linear_any_bwd_sums_kernel(const BwdAny p) {
  using W = Warp<DP>;
  constexpr int kT = W::kT, kNT = W::kNT, kQB = 0, kM = kSumM;
  constexpr int kXS = kM * kLinXP;            // elements of a chunk of rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int tt = blockIdx.x, h = blockIdx.y, bf = blockIdx.z;
  const int N = p.N, C = p.C, heads = p.heads, d = p.d, H = heads * d;
  const int wp = 4 * DP + 8;
  const int n_begin = tt * p.tile, n_end = min(N, n_begin + p.tile);
  const int n_sub = (n_end - n_begin + kM - 1) / kM;
  const int nkc = (C + kLinKC - 1) / kLinKC, nq = n_sub * nkc;
  const bf16* xb = p.x + (size_t)bf * N * C;
  const bf16* gb = p.g + (size_t)bf * N * C;
  const bool vx = aligned16(p.x) && aligned16(p.g) && C % 8 == 0;
  const bool vg = aligned16(p.gamma) && C % 4 == 0;
  const bool vw = aligned16(p.w_qkv) && aligned16(p.w_outT) && d % 8 == 0;
  const W w(warp, 4);
  const int m0 = w.m0;
  // the contraction item of this warp: mat 0 ctx or 1 dctx, its rows
  // a0..a0+15
  const int mat = warp / (DP / 16), a0 = (warp % (DP / 16)) * 16;
  const bool contracts = warp < 2 * (DP / 16);

  // shared memory: resident: W [nkc][32][wp], gamma, then x and g chunks
  // of two sub-tiles [2][x | g][nkc][kXS]; streamed: the ring; then the
  // tail
  const int stage = bwd_stage_bytes(kM, wp);
  unsigned char* tail =
      smem_raw + (kRes ? nkc * kLinKC * (wp * 2 + 4) + 4 * nkc * kXS * 2
                       : p.stages * stage);
  bf16* pv = reinterpret_cast<bf16*>(tail);                  // [kM][wp]
  float* cmax = reinterpret_cast<float*>(pv + kM * wp);       // [4][DP]
  float* zpart = cmax + 4 * DP;                             // [4][DP]
  float* mrun = zpart + 4 * DP;                             // [2][DP]
  float* zrun = mrun + 2 * DP;                              // [DP]
  float* mu_s = zrun + DP;                                  // [kM]
  float* rs_s = mu_s + kM;                                   // [kM]
  bf16* wres = reinterpret_cast<bf16*>(smem_raw);
  float* gres = reinterpret_cast<float*>(wres + nkc * kLinKC * wp);
  bf16* xres = reinterpret_cast<bf16*>(gres + nkc * kLinKC);
  const int S = p.stages;
  auto ring = [&](int s, int kc) {
    return reinterpret_cast<bf16*>(smem_raw + ((s * nkc + kc) % S) * stage);
  };
  auto xs = [&](int s, int kc) {
    return kRes ? xres + ((s & 1) * 2 * nkc + kc) * kXS : ring(s, kc);
  };
  auto gsx = [&](int s, int kc) {
    return kRes ? xres + (((s & 1) * 2 + 1) * nkc + kc) * kXS
                : ring(s, kc) + kXS;
  };
  auto gam = [&](int s, int kc) {
    return kRes ? gres + kc * kLinKC
                : reinterpret_cast<float*>(ring(s, kc) + 2 * kXS);
  };
  auto ws = [&](int s, int kc) {
    return kRes ? wres + kc * kLinKC * wp
                : reinterpret_cast<bf16*>(gam(s, kc) + kLinKC);
  };
  const LinUnit wun = lin_unit(4 * DP / 8, t);
  auto load_x = [&](int s, int kc) {
    const int ns = n_begin + s * kM, k0 = kc * kLinKC;
    lin_load_x(xs(s, kc), xb, ns, n_end - ns, kM, k0, C, vx, t);
    lin_load_x(gsx(s, kc), gb, ns, n_end - ns, kM, k0, C, vx, t);
  };
  auto load_w = [&](int s, int kc) {
    const int k0 = kc * kLinKC;
    lin_load_gamma(gam(s, kc), p.gamma, k0, C, vg, t);
    bwd_load_w<DP>(ws(s, kc), wp, p, k0, h, 4, vw, wun);
  };

  if (kRes) {
    // group 0: the weights, gamma and sub-tile 0; group 1: sub-tile 1
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
  if (t < DP) {
    mrun[t] = -CUDART_INF_F;
    zrun[t] = 0.f;
  }
  float cacc[kT][4];
#pragma unroll
  for (int n = 0; n < kT; ++n) cacc[n][0] = cacc[n][1] = cacc[n][2] = cacc[n][3] = 0.f;

  for (int s = 0; s < n_sub; ++s) {
    const int ns = n_begin + s * kM, valid = min(kM, n_end - ns);
    float acc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float mu[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
    if (kRes) {
      vmt::cp_async_wait<1>();
      __syncthreads();  // sub-tile s (s = 0: the weights) visible; the last
                        // sub-tile's readers of pv, cmax, zpart done
      lin_ln_tile(xs(s, 0), xs(s, 0), kXS, gres, valid, kM, C, t);
      __syncthreads();  // y visible
      for (int kc = 0; kc < nkc; ++kc)
        bwd_project<DP, false>(acc, xs(s, kc), gsx(s, kc), gam(s, kc),
                               ws(s, kc), wp, w, mu, rs, lane);
    } else {
      // the last sub-tile's readers of mu and rstd are past its barriers
      lin_row_stats(xb, ns, valid, kM, C, mu_s, rs_s, t);
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
        bwd_project<DP, true>(acc, xs(s, kc), gsx(s, kc), gam(s, kc),
                              ws(s, kc), wp, w, mu, rs, lane);
      }
    }

    const bool v0 = m0 + g < valid, v1 = m0 + g + 8 < valid;
    bf16* pr0 = pv + (m0 + g) * wp + 2 * tq;
    bf16* pr1 = pr0 + 8 * wp;
    if (w.kv) {
      // kk in place of k; the warp's column max over its valid rows (0 in
      // the padding, so that the running max stays finite there)
#pragma unroll
      for (int n = 0; n < kT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = clip_k(acc[n][e], p.clip);
        float c0 = fmaxf(v0 ? acc[n][0] : -CUDART_INF_F,
                         v1 ? acc[n][2] : -CUDART_INF_F);
        float c1 = fmaxf(v0 ? acc[n][1] : -CUDART_INF_F,
                         v1 ? acc[n][3] : -CUDART_INF_F);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          c0 = fmaxf(c0, __shfl_xor_sync(0xffffffffu, c0, o));
          c1 = fmaxf(c1, __shfl_xor_sync(0xffffffffu, c1, o));
        }
        const int col = n * 8 + 2 * tq;
        if (g == 0) {
          cmax[w.rg * DP + col] = col < d ? c0 : 0.f;
          cmax[w.rg * DP + col + 1] = col + 1 < d ? c1 : 0.f;
        }
      }
    }
    if (w.q) {
      q_softmax<DP, kNT, kQB>(acc, d, p.scale, v0, v1, tq);
#pragma unroll
      for (int n = 0; n < kT; ++n) {
        const float (&qv)[4] = acc[kQB + n];
        const float (&go)[4] = acc[kQB + kT + n];
        *reinterpret_cast<uint32_t*>(pr0 + 2 * DP + n * 8) =
            vmt::pack_bf16x2(qv[0], qv[1]);
        *reinterpret_cast<uint32_t*>(pr1 + 2 * DP + n * 8) =
            vmt::pack_bf16x2(qv[2], qv[3]);
        *reinterpret_cast<uint32_t*>(pr0 + 3 * DP + n * 8) =
            vmt::pack_bf16x2(v0 ? go[0] : 0.f, v0 ? go[1] : 0.f);
        *reinterpret_cast<uint32_t*>(pr1 + 3 * DP + n * 8) =
            vmt::pack_bf16x2(v1 ? go[2] : 0.f, v1 ? go[3] : 0.f);
      }
    }
    __syncthreads();  // cmax visible

    // the new running max of a column of the group
    const float* mold = mrun + (s & 1) * DP;
    auto m_new = [&](int col) {
      float mn = mold[col];
#pragma unroll
      for (int r = 0; r < 4; ++r) mn = fmaxf(mn, cmax[r * DP + col]);
      return mn;
    };
    if (w.kv) {
      // P, its column sums (z), bf16 P and v / HW to the pv tile
#pragma unroll
      for (int n = 0; n < kT; ++n) {
        const int col = n * 8 + 2 * tq;
        const bool c0 = col < d, c1 = col + 1 < d;
        const float mn0 = m_new(col), mn1 = m_new(col + 1);
        const float p00 = v0 && c0 ? expf(acc[n][0] - mn0) : 0.f;
        const float p01 = v0 && c1 ? expf(acc[n][1] - mn1) : 0.f;
        const float p10 = v1 && c0 ? expf(acc[n][2] - mn0) : 0.f;
        const float p11 = v1 && c1 ? expf(acc[n][3] - mn1) : 0.f;
        float z0 = p00 + p10, z1 = p01 + p11;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          z0 += __shfl_xor_sync(0xffffffffu, z0, o);
          z1 += __shfl_xor_sync(0xffffffffu, z1, o);
        }
        if (g == 0) {
          zpart[w.rg * DP + col] = z0;
          zpart[w.rg * DP + col + 1] = z1;
        }
        const float (&v)[4] = acc[kT + n];
        *reinterpret_cast<uint32_t*>(pr0 + n * 8) = vmt::pack_bf16x2(p00, p01);
        *reinterpret_cast<uint32_t*>(pr1 + n * 8) = vmt::pack_bf16x2(p10, p11);
        *reinterpret_cast<uint32_t*>(pr0 + DP + n * 8) = vmt::pack_bf16x2(
            v0 ? v[0] * p.inv_hw : 0.f, v0 ? v[1] * p.inv_hw : 0.f);
        *reinterpret_cast<uint32_t*>(pr1 + DP + n * 8) = vmt::pack_bf16x2(
            v1 ? v[2] * p.inv_hw : 0.f, v1 ? v[3] * p.inv_hw : 0.f);
      }
    }
    __syncthreads();  // pv and zpart visible; resident: sub-tile s's x and
                      // g read by every warp
    if (kRes) {
      if (s + 2 < n_sub)
        for (int kc = 0; kc < nkc; ++kc) load_x(s + 2, kc);
      vmt::cp_async_commit();
    }

    // ctx[a][e] += sum_tok bf16(P)[tok][a] bf16(v / HW)[tok][e], rescaled
    // to the new max first; dctx[a][e] += sum_tok bf16(Q)[tok][a]
    // bf16(g_oh)[tok][e]
    if (contracts) {
      if (mat == 0) {
        const int ca = a0 + g;
        const float s0 = expf(mold[ca] - m_new(ca));
        const float s1 = expf(mold[ca + 8] - m_new(ca + 8));
#pragma unroll
        for (int n = 0; n < kT; ++n) {
          cacc[n][0] *= s0;
          cacc[n][1] *= s0;
          cacc[n][2] *= s1;
          cacc[n][3] *= s1;
        }
      }
      const bf16* pa = pv + (mat ? 2 * DP : 0) + a0;
      const bf16* pb = pv + (mat ? 3 * DP : DP);
#pragma unroll
      for (int ks = 0; ks < kM / 16; ++ks) {
        uint32_t a[4];
        vmt::ldsm_x4_t(a, pa + (ks * 16 + vmt::at_row_off(lane)) * wp +
                              vmt::at_col_off(lane));
#pragma unroll
        for (int np = 0; np < DP / 16; ++np) {
          uint32_t bb[4];
          vmt::ldsm_x4_t(bb, pb + (ks * 16 + vmt::bk_row_off(lane)) * wp +
                                 np * 16 + vmt::bk_col_off(lane));
          vmt::mma_bf16(cacc[2 * np], a, bb[0], bb[1]);
          vmt::mma_bf16(cacc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    if (t < DP) {
      const float mn = m_new(t);
      const float zs = ((zpart[t] + zpart[DP + t]) + zpart[2 * DP + t]) +
                       zpart[3 * DP + t];
      zrun[t] = zrun[t] * expf(mold[t] - mn) + zs;
      mrun[((s + 1) & 1) * DP + t] = mn;
    }
  }
  __syncthreads();  // the last zrun / mrun writes visible

  // the tile's partials
  const size_t pidx = (size_t)bf * gridDim.x + tt;
  if (contracts) {
    float* pc = (mat ? p.part_dctx : p.part_ctx) +
                (pidx * heads + h) * d * d;
#pragma unroll
    for (int n = 0; n < kT; ++n)
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int a = a0 + g + 8 * h8;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * tq + e;
          if (a < d && col < d) pc[a * d + col] = cacc[n][2 * h8 + e];
        }
      }
  }
  if (t < d) {
    p.part_z[pidx * H + h * d + t] = zrun[t];
    p.part_m[pidx * H + h * d + t] = mrun[(n_sub & 1) * DP + t];
  }
}

// ---- the merge: one block a (head, frame)

// M = the max over the conditioning tokens and the tiles, z, ctx = (the
// conditioning tokens' exp(kk - M) (v / HW), then the tiles' partials
// rescaled, in order) / z, dctx = the tiles' sum; bf16 ctx and dctx into
// the head's padded [2][DP][DP + 8] blocks; S = sum_e bf16(dctx) ctx; M,
// 1 / z, S into mzs (zeros past d); the conditioning tokens' dek = P (dP -
// S) (zero where |k| >= 60 under clip) and dev = P^T dctx / HW, f32 but for
// the bf16 dctx
template <int DP>
__global__ void __launch_bounds__(kBT) linear_any_bwd_merge(const BwdAny p,
                                                            int tiles,
                                                            float* dek,
                                                            float* dev) {
  constexpr int kCP = DP + 8;
  extern __shared__ float smem_f[];
  const int t = threadIdx.x, h = blockIdx.x, bf = blockIdx.y;
  const int d = p.d, heads = p.heads, H = heads * d, dd = d * d, Mc = p.Mc;
  const int clip = p.clip;
  const float inv_hw = p.inv_hw;
  float* cs = smem_f;         // [d][d] ctx (f32)
  float* ds = cs + dd;        // [d][d] bf16(dctx)
  float* Ms = ds + dd;        // [d]
  float* zi = Ms + d;         // [d]
  float* Ss = zi + d;         // [d]
  const bf16* ekb = p.ek + (size_t)bf * Mc * H + h * d;
  const bf16* evb = p.ev + (size_t)bf * Mc * H + h * d;
  const size_t pb = (size_t)bf * tiles;  // tile k's partials: pb + k
  bf16* cpad = p.ctxp + ((size_t)bf * heads + h) * 2 * DP * kCP;
  // the padding of the head's blocks
  for (int i = t; i < 2 * DP * kCP; i += kBT) {
    const int a = (i / kCP) % DP, e = i % kCP;
    if (a >= d || e >= d) cpad[i] = __float2bfloat16(0.f);
  }
  if (t < d) {
    float m = -CUDART_INF_F;
    for (int mc = 0; mc < Mc; ++mc)
      m = fmaxf(m, clip_k(bf2f(ekb[(size_t)mc * H + t]), clip));
    for (int k = 0; k < tiles; ++k)
      m = fmaxf(m, p.part_m[(pb + k) * H + h * d + t]);
    float z = 0.f;
    for (int mc = 0; mc < Mc; ++mc)
      z += expf(clip_k(bf2f(ekb[(size_t)mc * H + t]), clip) - m);
    for (int k = 0; k < tiles; ++k) {
      const size_t pi = (pb + k) * H + h * d + t;
      z = fmaf(p.part_z[pi], expf(p.part_m[pi] - m), z);
    }
    Ms[t] = m;
    zi[t] = 1.f / z;
  }
  __syncthreads();
  for (int o = t; o < dd; o += kBT) {
    const int ai = o / d, e = o % d;
    float c = 0.f, dc = 0.f;
    for (int mc = 0; mc < Mc; ++mc)
      c = fmaf(expf(clip_k(bf2f(ekb[(size_t)mc * H + ai]), clip) - Ms[ai]),
               bf2f(evb[(size_t)mc * H + e]) * inv_hw, c);
    for (int k = 0; k < tiles; ++k) {
      const size_t pi = ((pb + k) * heads + h) * dd + o;
      c = fmaf(p.part_ctx[pi],
               expf(p.part_m[(pb + k) * H + h * d + ai] - Ms[ai]), c);
      dc += p.part_dctx[pi];
    }
    c *= zi[ai];
    cpad[ai * kCP + e] = __float2bfloat16(c);
    cpad[(DP + ai) * kCP + e] = __float2bfloat16(dc);
    cs[o] = c;
    ds[o] = round_bf16(dc);
  }
  __syncthreads();
  if (t < DP) {
    float sv = 0.f;
    if (t < d)
      for (int e = 0; e < d; ++e) sv = fmaf(ds[t * d + e], cs[t * d + e], sv);
    if (t < d) Ss[t] = sv;
    float* mz = p.mzs + ((size_t)bf * 3 * heads + h) * DP + t;
    mz[0] = t < d ? Ms[t] : 0.f;
    mz[(size_t)heads * DP] = t < d ? zi[t] : 0.f;
    mz[(size_t)2 * heads * DP] = sv;
  }
  __syncthreads();
  for (int i = t; i < Mc * d; i += kBT) {
    const int mc = i / d, c = i % d;
    const bf16* ekr = ekb + (size_t)mc * H;
    const bf16* evr = evb + (size_t)mc * H;
    const float k = bf2f(ekr[c]);
    const float pc = expf(clip_k(k, clip) - Ms[c]) * zi[c];
    float dp = 0.f, dv = 0.f;
    for (int e = 0; e < d; ++e) {
      dp = fmaf(ds[c * d + e], bf2f(evr[e]) * inv_hw, dp);
      const float pe = expf(clip_k(bf2f(ekr[e]), clip) - Ms[e]) * zi[e];
      dv = fmaf(pe, ds[e * d + c], dv);
    }
    const bool dead = clip && fabsf(k) >= kClamp;
    const size_t o = ((size_t)bf * Mc + mc) * H + h * d + c;
    dek[o] = dead ? 0.f : pc * (dp - Ss[c]);
    dev[o] = dv * inv_hw;
  }
}

// ---- pass 2: the token cotangents and dx

// mu and rstd of a staged tile's rows (C <= 128: at most four K-chunk
// slots of [rows][kLinXP], kXS elements apart) into mu_s, rs_s:
// lin_ln_tile's sums, ln_rows_kernel's bits; rows from `valid` on 0, 0
__device__ __forceinline__ void ln_tile_stats(const bf16* xs, int kXS,
                                              int valid, int rows, int C,
                                              float* mu_s, float* rs_s,
                                              int t) {
  const int j = t & 7;
  auto row_sum = [](const float (&ps)[4]) {
    float s = (ps[0] + ps[2]) + (ps[1] + ps[3]);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
  };
  for (int r0 = 0; r0 < rows; r0 += kBT / 8) {
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
    if (in && j == 0) {
      mu_s[r] = ok ? mu : 0.f;
      rs_s[r] = ok ? rs : 0.f;
    }
  }
}

// A fragments (16 x DP, k-steps of 16) of the n8 tiles kB.. of acc as bf16
template <int DP, int kNT, int kB>
__device__ __forceinline__ void frag_pack(uint32_t (&a)[DP / 16][4],
                                          const float (&x)[kNT][4]) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const float* x0 = x[kB + 2 * kk];
    const float* x1 = x[kB + 2 * kk + 1];
    a[kk][0] = vmt::pack_bf16x2(x0[0], x0[1]);
    a[kk][1] = vmt::pack_bf16x2(x0[2], x0[3]);
    a[kk][2] = vmt::pack_bf16x2(x1[0], x1[1]);
    a[kk][3] = vmt::pack_bf16x2(x1[2], x1[3]);
  }
}

// o = A (16 x DP) B, B a DP x DP bf16 block (pitch DP + 8) stored [k][n]
// (kKN) or [n][k]
template <int DP, bool kKN>
__device__ __forceinline__ void mma_dd(float (&o)[DP / 8][4],
                                       const uint32_t (&a)[DP / 16][4],
                                       const bf16* b, int lane) {
  constexpr int kCP = DP + 8;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t bb[4];
      if (kKN)
        vmt::ldsm_x4_t(bb, b + (ks * 16 + vmt::bk_row_off(lane)) * kCP +
                               np * 16 + vmt::bk_col_off(lane));
      else
        vmt::ldsm_x4(bb, b + (np * 16 + vmt::bn_row_off(lane)) * kCP +
                             ks * 16 + vmt::bn_col_off(lane));
      vmt::mma_bf16(o[2 * np], a[ks], bb[0], bb[1]);
      vmt::mma_bf16(o[2 * np + 1], a[ks], bb[2], bb[3]);
    }
}

// the group's bf16 ctx / dctx blocks [G][2][DP][DP + 8] and M, 1 / z, S
// [3][G DP] of heads h0.. by cp.async from the merge's padded layouts
// (zeros past the last head); the caller commits
template <int DP>
__device__ __forceinline__ void stage_group(const BwdAny& p, bf16* cs,
                                            float* fs, int bf, int h0,
                                            int G, int t) {
  constexpr int kHB = 2 * DP * (DP + 8) / 8;   // 16-byte pieces a head's blocks
  constexpr int kHF = DP / 4;                  // 16-byte pieces a head's DP floats
  const int heads = p.heads;
  const bf16* src = p.ctxp + ((size_t)bf * heads + h0) * kHB * 8;
  for (int i = t; i < G * kHB; i += kBT) {
    const bool ok = h0 + i / kHB < heads;
    vmt::cp_async16(cs + (size_t)i * 8, ok ? src + (size_t)i * 8 : p.ctxp, ok);
  }
  for (int i = t; i < 3 * G * kHF; i += kBT) {
    const int which = i / (G * kHF), j = i % (G * kHF);
    const bool ok = h0 + j / kHF < heads;
    const float* fsrc =
        p.mzs + ((size_t)(bf * 3 + which) * heads + h0) * DP + (size_t)j * 4;
    vmt::cp_async16(fs + (size_t)i * 4, ok ? fsrc : p.mzs, ok);
  }
}

// The warp's k and v cotangents (k at tiles 0.., v at kT.. of acc; rows
// m0.., head slot hl of the group): P = exp(kk - M) / z, dP = bf16(v / HW)
// dctx^T, dk = P (dP - S) (zero where |k| >= 60 under clip), dv = bf16(P)
// dctx / HW; dk and dv (bf16) to the dqkv tile at columns 3 DP hl and
// 3 DP hl + DP.
template <int DP, int kNT>
__device__ __forceinline__ void head_kv(float (&acc)[kNT][4], const BwdAny& p,
                                        const bf16* cs, const float* fs,
                                        bf16* dqs, int dqp, int G, int hl,
                                        int m0, int valid, int lane) {
  constexpr int kT = DP / 8, kCP = DP + 8;
  const int g = lane >> 2, tq = lane & 3, d = p.d, clip = p.clip;
  const float inv_hw = p.inv_hw;
  const bool v0 = m0 + g < valid, v1 = m0 + g + 8 < valid;
  const bf16* dctxh = cs + (hl * 2 + 1) * DP * kCP;
  const float* mh = fs + hl * DP;
  const float* zh = fs + G * DP + hl * DP;
  const float* sh = fs + 2 * G * DP + hl * DP;
  bf16* row0 = dqs + (m0 + g) * dqp + hl * 3 * DP + 2 * tq;
  bf16* row1 = row0 + 8 * dqp;
  uint32_t af[DP / 16][4];
  float o[kT][4];
  // dP = bf16(v / HW) dctx^T (dctx [a][e] is B [n][k])
#pragma unroll
  for (int n = kT; n < 2 * kT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= inv_hw;
  frag_pack<DP, kNT, kT>(af, acc);
  mma_dd<DP, false>(o, af, dctxh, lane);
#pragma unroll
  for (int n = 0; n < kT; ++n) {
    float dk[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + 2 * tq + (e & 1);
      const bool ok = (e < 2 ? v0 : v1) && col < d;
      const float k = acc[n][e];
      const float pval = ok ? expf(clip_k(k, clip) - mh[col]) * zh[col] : 0.f;
      const bool pass = ok && (!clip || fabsf(k) < kClamp);
      dk[e] = pass ? pval * (o[n][e] - sh[col]) : 0.f;
      acc[n][e] = pval;
    }
    *reinterpret_cast<uint32_t*>(row0 + n * 8) = vmt::pack_bf16x2(dk[0], dk[1]);
    *reinterpret_cast<uint32_t*>(row1 + n * 8) = vmt::pack_bf16x2(dk[2], dk[3]);
  }
  // dv = bf16(P) dctx / HW (dctx is B [k][n])
  frag_pack<DP, kNT, 0>(af, acc);
  mma_dd<DP, true>(o, af, dctxh, lane);
#pragma unroll
  for (int n = 0; n < kT; ++n) {
    *reinterpret_cast<uint32_t*>(row0 + DP + n * 8) =
        vmt::pack_bf16x2(o[n][0] * inv_hw, o[n][1] * inv_hw);
    *reinterpret_cast<uint32_t*>(row1 + DP + n * 8) =
        vmt::pack_bf16x2(o[n][2] * inv_hw, o[n][3] * inv_hw);
  }
}

// The warp's q cotangent and oh (q at tiles kQB.., g_oh at kQB + kT..):
// Q, dQ = bf16(g_oh) ctx^T, dq = Q dQ - Q sum_head(Q dQ) / scale, oh =
// bf16(Q) ctx; dq (bf16) to the dqkv tile at column 3 DP hl + 2 DP, oh
// (bf16) to the oh tile at DP hl.
template <int DP, int kNT, int kQB>
__device__ __forceinline__ void head_q(float (&acc)[kNT][4], const BwdAny& p,
                                       const bf16* cs, bf16* dqs, int dqp,
                                       bf16* ohs, int ohp, int hl, int m0,
                                       int valid, int lane) {
  constexpr int kT = DP / 8, kCP = DP + 8;
  const int g = lane >> 2, tq = lane & 3;
  const bool v0 = m0 + g < valid, v1 = m0 + g + 8 < valid;
  const bf16* ctxh = cs + (hl * 2) * DP * kCP;
  bf16* row0 = dqs + (m0 + g) * dqp + hl * 3 * DP + 2 * DP + 2 * tq;
  bf16* row1 = row0 + 8 * dqp;
  uint32_t af[DP / 16][4];
  float o[kT][4];
  // dq from Q and dQ = bf16(g_oh) ctx^T (ctx [a][e] is B [n][k])
  q_softmax<DP, kNT, kQB>(acc, p.d, p.scale, v0, v1, tq);
  frag_pack<DP, kNT, kQB + kT>(af, acc);
  mma_dd<DP, false>(o, af, ctxh, lane);
  float t0 = 0.f, t1 = 0.f;
#pragma unroll
  for (int n = 0; n < kT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= acc[kQB + n][e];  // Q dQ
    t0 += o[n][0] + o[n][1];
    t1 += o[n][2] + o[n][3];
  }
  const float r0 = quad_sum(t0) / p.scale, r1 = quad_sum(t1) / p.scale;
#pragma unroll
  for (int n = 0; n < kT; ++n) {
    const float (&qv)[4] = acc[kQB + n];
    *reinterpret_cast<uint32_t*>(row0 + n * 8) =
        vmt::pack_bf16x2(o[n][0] - qv[0] * r0, o[n][1] - qv[1] * r0);
    *reinterpret_cast<uint32_t*>(row1 + n * 8) =
        vmt::pack_bf16x2(o[n][2] - qv[2] * r1, o[n][3] - qv[3] * r1);
  }
  // oh = bf16(Q) ctx (ctx is B [k][n])
  frag_pack<DP, kNT, kQB>(af, acc);
  mma_dd<DP, true>(o, af, ctxh, lane);
  bf16* oh0 = ohs + (m0 + g) * ohp + hl * DP + 2 * tq;
#pragma unroll
  for (int n = 0; n < kT; ++n) {
    *reinterpret_cast<uint32_t*>(oh0 + n * 8) = vmt::pack_bf16x2(o[n][0], o[n][1]);
    *reinterpret_cast<uint32_t*>(oh0 + 8 * ohp + n * 8) =
        vmt::pack_bf16x2(o[n][2], o[n][3]);
  }
}

// the resident pass 2 (64 rows, one head a group): dy[.][c0..c0+31] +=
// the dqkv tile ([dk dv dq]) W^T of a weight chunk's 32 channels (its
// rows, read as B [n][k]); n8 tile units (16 rows, 8 channels), two a warp
template <int DP>
__device__ __forceinline__ void dy_chunk(float* dys, int dyp, const bf16* dqs,
                                         int dqp, const bf16* wch, int wp,
                                         int c0, int warp, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  for (int u = warp; u < 16; u += kBT / 32) {
    const int rgd = u % 4, nt = u / 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4], b[2];
        vmt::ldsm_x4(a, dqs + (rgd * 16 + vmt::a_row_off(lane)) * dqp +
                            part * DP + kk * 16 + vmt::a_col_off(lane));
        vmt::ldsm_x2(b, wch + (nt * 8 + (lane & 7)) * wp + part * DP +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        vmt::mma_bf16(acc, a, b[0], b[1]);
      }
    float2* q0 = reinterpret_cast<float2*>(dys + (rgd * 16 + g) * dyp + c0 +
                                           nt * 8 + 2 * tq);
    float2* q1 = q0 + 4 * dyp;  // eight rows on (dyp floats a row)
    float2 u0 = *q0, u1 = *q1;
    u0.x += acc[0];
    u0.y += acc[1];
    u1.x += acc[2];
    u1.y += acc[3];
    *q0 = u0;
    *q1 = u1;
  }
}

// One block a (M-token tile, frame); the warps as Warp lays them out over
// M / 16 row groups. The LN statistics of the tile's rows first, then the
// heads in groups of G: the projection recomputed from x and g (the x
// fragments normalised as they are read), head_kv and head_q, the dqkv
// and oh tiles once to device memory. Resident (kRes: C <= 128): x and g
// stay in shared memory, the next group's weights, ctx / dctx and
// statistics arrive during this group's work, dy += dqkv W_qkv^T into a
// shared f32 tile a group at a time, and then the LN backward eight
// threads a row (dx; xhat dy into the dy tile) and the block's dgamma and
// dout_bias partials, each column's rows in order. Streamed: x, g and the
// weights through the ring; dy and the LN backward are pass 3's
// (linear_any_bwd_dx_kernel), from the dqkv rows written here.
template <int DP, bool kRes>
__global__ void __launch_bounds__(kBT, DP <= 32 ? 2 : 1)
    linear_any_bwd_tok_kernel(const BwdAny p) {
  using W = Warp<DP>;
  constexpr int kNT = W::kNT, kCP = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2;
  const int M = p.rows, RG = M / 16, G = p.group;
  const int N = p.N, C = p.C, heads = p.heads, d = p.d, H = heads * d;
  const int bf = blockIdx.y, n0 = blockIdx.x * M, valid = min(M, N - n0);
  const int nkc = (C + kLinKC - 1) / kLinKC, groups = (heads + G - 1) / G;
  const int wp = 4 * G * DP + 8, dqp = 3 * G * DP + 8, ohp = G * DP + 8;
  const int dyp = kRes ? nkc * kLinKC + 4 : 0;   // streamed: no dy tile
  const W w(warp, RG);
  const int m0 = w.m0;
  const bool active = w.slot < G;
  const bf16* xb = p.x + (size_t)bf * N * C;
  const bf16* gb = p.g + (size_t)bf * N * C;
  const size_t row0 = (size_t)bf * N + n0;  // the tile's first row of BF N
  const bool vx = aligned16(p.x) && aligned16(p.g) && C % 8 == 0;
  const bool vg = aligned16(p.gamma) && C % 4 == 0;
  const bool vw = aligned16(p.w_qkv) && aligned16(p.w_outT) && d % 8 == 0;
  const int kXS = M * kLinXP;
  const int stage = bwd_stage_bytes(M, wp);
  const int wsz = nkc * kLinKC * wp;           // a group's weights (bf16)
  const int csz = G * 2 * DP * kCP, fsz = 3 * G * DP;

  // shared memory: resident: two groups' W [nkc][32][wp], gamma, the
  // tile's x and g chunks [nkc][kXS] each; streamed: the ring; then dy
  // (resident), the dqkv and oh tiles, the context blocks and M / zinv / S
  // (resident: two groups'), mu and rstd
  unsigned char* tail =
      smem_raw + (kRes ? 2 * wsz * 2 + nkc * kLinKC * 4 + 2 * nkc * kXS * 2
                       : p.stages * stage);
  float* dys = reinterpret_cast<float*>(tail);               // [M][dyp]
  bf16* dqs = reinterpret_cast<bf16*>(dys + M * dyp);         // [M][dqp]
  bf16* ohs = dqs + M * dqp;                                  // [M][ohp]
  bf16* cs0 = ohs + M * ohp;                                  // [nbuf][csz]
  const int nbuf = kRes ? 2 : 1;
  float* fs0 = reinterpret_cast<float*>(cs0 + nbuf * csz);    // [nbuf][fsz]
  float* mu_s = fs0 + nbuf * fsz;                             // [M]
  float* rs_s = mu_s + M;                                     // [M]
  bf16* wres = reinterpret_cast<bf16*>(smem_raw);             // [2][wsz]
  float* gres = reinterpret_cast<float*>(wres + 2 * wsz);
  bf16* xres = reinterpret_cast<bf16*>(gres + nkc * kLinKC);
  bf16* gtile = xres + nkc * kXS;
  const int S = p.stages, nq = groups * nkc;
  auto ring = [&](int q) {
    return reinterpret_cast<bf16*>(smem_raw + (q % S) * stage);
  };
  auto rgam = [&](int q) { return reinterpret_cast<float*>(ring(q) + 2 * kXS); };
  auto rw = [&](int q) { return reinterpret_cast<bf16*>(rgam(q) + kLinKC); };
  const LinUnit wun = lin_unit(4 * G * DP / 8, t);
  // streamed: chunk q of group q / nkc: x, g, gamma and the weights of a
  // K-chunk
  auto load_chunk = [&](int q) {
    const int h0 = (q / nkc) * G, k0 = (q % nkc) * kLinKC;
    lin_load_x(ring(q), xb, n0, valid, M, k0, C, vx, t);
    lin_load_x(ring(q) + kXS, gb, n0, valid, M, k0, C, vx, t);
    lin_load_gamma(rgam(q), p.gamma, k0, C, vg, t);
    bwd_load_w<DP>(rw(q), wp, p, k0, h0, 4, vw, wun);
  };
  // resident: group gi's weights, context blocks and statistics into
  // buffer gi & 1
  auto load_group = [&](int gi) {
    const int b = gi & 1;
    for (int kc = 0; kc < nkc; ++kc)
      bwd_load_w<DP>(wres + b * wsz + kc * kLinKC * wp, wp, p, kc * kLinKC,
                     gi * G, 4, vw, wun);
    stage_group<DP>(p, cs0 + b * csz, fs0 + b * fsz, bf, gi * G, G, t);
  };
  // x[r][c] and g[r][c] of the tile
  auto x_at = [&](int r, int c) {
    return kRes ? bf2f(xres[(c / kLinKC) * kXS + r * kLinXP + c % kLinKC])
                : bf2f(xb[(size_t)(n0 + r) * C + c]);
  };
  auto g_at = [&](int r, int c) {
    return kRes ? bf2f(gtile[(c / kLinKC) * kXS + r * kLinXP + c % kLinKC])
                : bf2f(gb[(size_t)(n0 + r) * C + c]);
  };

  if (kRes) {
    for (int kc = 0; kc < nkc; ++kc) {
      lin_load_x(xres + kc * kXS, xb, n0, valid, M, kc * kLinKC, C, vx, t);
      lin_load_x(gtile + kc * kXS, gb, n0, valid, M, kc * kLinKC, C, vx, t);
      lin_load_gamma(gres + kc * kLinKC, p.gamma, kc * kLinKC, C, vg, t);
    }
    load_group(0);
    vmt::cp_async_commit();
  } else {
    for (int q = 0; q < S - 1; ++q) {
      if (q < nq) load_chunk(q);
      vmt::cp_async_commit();
    }
  }
  for (int i = t; i < M * dyp; i += kBT) dys[i] = 0.f;
  if (!kRes) lin_row_stats(xb, n0, valid, M, C, mu_s, rs_s, t);
  float mu[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  if (kRes) {
    vmt::cp_async_wait<0>();
    __syncthreads();  // x, g, gamma and group 0 visible
    ln_tile_stats(xres, kXS, valid, M, C, mu_s, rs_s, t);
    __syncthreads();  // mu and rstd visible
    mu[0] = mu_s[m0 + g];
    rs[0] = rs_s[m0 + g];
    mu[1] = mu_s[m0 + g + 8];
    rs[1] = rs_s[m0 + g + 8];
    // y for the weight sums, as the fragments normalise it: a warp a row
    for (int r = warp; r < valid; r += kBT / 32)
      for (int c = lane; c < C; c += 32)
        p.y[(row0 + r) * C + c] =
            __float2bfloat16((x_at(r, c) - mu_s[r]) * rs_s[r] * gres[c]);
  }

  int q = 0;  // streamed: the next chunk
  for (int gi = 0; gi < groups; ++gi) {
    const int h0 = gi * G;
    const bf16* cs = cs0 + (kRes ? (gi & 1) * csz : 0);
    const float* fs = fs0 + (kRes ? (gi & 1) * fsz : 0);
    float acc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if (kRes) {
      // the next group's loads overlap this one's work (their buffer's
      // last readers, group gi - 1, are past the barrier that ended it)
      if (gi + 1 < groups) load_group(gi + 1);
      vmt::cp_async_commit();
      const bf16* wg = wres + (gi & 1) * wsz;
      if (active)
        for (int kc = 0; kc < nkc; ++kc)
          bwd_project<DP, true>(acc, xres + kc * kXS, gtile + kc * kXS,
                                gres + kc * kLinKC, wg + kc * kLinKC * wp, wp,
                                w, mu, rs, lane);
    } else {
      stage_group<DP>(p, cs0, fs0, bf, h0, G, t);
      vmt::cp_async_commit();
      vmt::cp_async_wait<0>();
      for (int kc = 0; kc < nkc; ++kc, ++q) {
        lin_wait(S - 2);
        __syncthreads();  // chunk q visible (q = 0: mu, rstd too; the
                          // group's first: cs, fs)
        if (q == 0) {
          mu[0] = mu_s[m0 + g];
          rs[0] = rs_s[m0 + g];
          mu[1] = mu_s[m0 + g + 8];
          rs[1] = rs_s[m0 + g + 8];
        }
        if (q + S - 1 < nq) load_chunk(q + S - 1);
        vmt::cp_async_commit();
        if (gi == 0) {
          // y for the weight sums, as the fragments normalise it
          const bf16* xc = ring(q);
          const float* gc = rgam(q);
          for (int i = t; i < valid * kLinKC; i += kBT) {
            const int r = i / kLinKC, c = i % kLinKC, k = kc * kLinKC + c;
            if (k < C)
              p.y[(row0 + r) * C + k] = __float2bfloat16(
                  (bf2f(xc[r * kLinXP + c]) - mu_s[r]) * rs_s[r] * gc[c]);
          }
        }
        if (active)
          bwd_project<DP, true>(acc, ring(q), ring(q) + kXS, rgam(q), rw(q),
                                wp, w, mu, rs, lane);
      }
    }
    if (active && w.kv)
      head_kv<DP, kNT>(acc, p, cs, fs, dqs, dqp, G, w.slot, m0, valid, lane);
    if (active && w.q)
      head_q<DP, kNT, 0>(acc, p, cs, dqs, dqp, ohs, ohp, w.slot, m0, valid,
                         lane);
    __syncthreads();  // the dqkv and oh tiles visible

    // dqkv ([dq | dk | dv] x H) and oh of the group's heads, once: a
    // (row, part, head) segment of d values a few lanes, 16 bytes a lane
    // where d % 8 == 0
    const int gh = min(G, heads - h0), nseg = valid * 4 * gh;
    auto segment = [&](int sg, const bf16** src, bf16** dst) {
      const int r = sg / (4 * gh), part = (sg / gh) % 4, hl = sg % gh;
      // part 0-2: dq, dk, dv (the tile's dk 0, dv 1, dq 2); 3: oh
      *src = part < 3 ? dqs + r * dqp + (hl * 3 + (part + 2) % 3) * DP
                      : ohs + r * ohp + hl * DP;
      *dst = part < 3 ? p.dqkv + (row0 + r) * 3 * H + part * H + (h0 + hl) * d
                      : p.oh + (row0 + r) * H + (h0 + hl) * d;
    };
    if (d % 8 == 0) {
      const int pps = d / 8, spw = 32 / pps, sub = lane / pps, pc = lane % pps;
      if (sub < spw)
        for (int sg = warp * spw + sub; sg < nseg; sg += (kBT / 32) * spw) {
          const bf16* src;
          bf16* dst;
          segment(sg, &src, &dst);
          *reinterpret_cast<uint4*>(dst + pc * 8) =
              *reinterpret_cast<const uint4*>(src + pc * 8);
        }
    } else {
      for (int sg = warp; sg < nseg; sg += kBT / 32) {
        const bf16* src;
        bf16* dst;
        segment(sg, &src, &dst);
        for (int a = lane; a < d; a += 32) dst[a] = src[a];
      }
    }

    // resident: dy += dqkv W_qkv^T, the channels a chunk at a time
    if (kRes) {
      const bf16* wg = wres + (gi & 1) * wsz;
      for (int cc = 0; cc < nkc; ++cc)
        dy_chunk<DP>(dys, dyp, dqs, dqp, wg + cc * kLinKC * wp, wp,
                     cc * kLinKC, warp, lane);
      vmt::cp_async_wait<0>();
    }
    __syncthreads();  // resident: the next group's loads visible; this
                      // group's readers of its buffers, dqs and ohs done
  }
  if constexpr (!kRes) {
    vmt::cp_async_wait<0>();
    return;
  }

  // the LN backward with the rows' LN statistics (those of y), eight
  // threads a row, 32 rows at a time, from the staged x and g; dy's row
  // becomes xhat dy, dgamma's summand
  {
    for (int r0 = 0; r0 < valid; r0 += kBT / 8) {
      const int r = r0 + (t >> 3), j = t & 7;
      const bool ok = r < valid;   // the same for a row's eight threads
      const float mean = ok ? mu_s[r] : 0.f, rstd = ok ? rs_s[r] : 0.f;
      float* dyr = dys + (ok ? r : 0) * dyp;
      float xh[4][4], gd[4][4], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int c = 32 * b + 8 * a + j;
          const bool in = ok && c < C;
          xh[b][a] = in ? (x_at(r, c) - mean) * rstd : 0.f;
          gd[b][a] = in ? dyr[c] * gres[c] : 0.f;
          s1 += gd[b][a];
          s2 = fmaf(gd[b][a], xh[b][a], s2);
        }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      const float m1 = s1 / C, m2 = s2 / C;
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int c = 32 * b + 8 * a + j;
          if (!ok || c >= C) continue;
          p.dx[(row0 + r) * C + c] = __float2bfloat16(
              g_at(r, c) + rstd * (gd[b][a] - m1 - xh[b][a] * m2));
          dyr[c] *= xh[b][a];
        }
    }
  }
  __syncthreads();
  // the block's dgamma = sum_rows xhat dy and dout_bias = sum_rows g: a
  // thread a (column, run of rows), the runs (at most 8 a column, while
  // C < 256) then added in order through the space of the dqkv, oh and
  // context tiles
  const int runs = C >= kBT ? 1 : min(8, kBT / C);
  const int per = (valid + runs - 1) / runs;
  float* red = reinterpret_cast<float*>(dqs);     // [runs][2][C] when runs > 1
  const size_t blk = (size_t)bf * gridDim.x + blockIdx.x;
  for (int i = t; i < runs * C; i += kBT) {
    const int c = i % C, run = i / C;
    const int r1 = min(valid, (run + 1) * per);
    float dg = 0.f, db = 0.f;
    for (int r = run * per; r < r1; ++r) {
      dg += dys[r * dyp + c];
      db += g_at(r, c);
    }
    if (runs == 1) {
      p.part_dgamma[blk * C + c] = dg;
      p.part_dob[blk * C + c] = db;
    } else {
      red[(run * 2) * C + c] = dg;
      red[(run * 2 + 1) * C + c] = db;
    }
  }
  if (runs > 1) {
    __syncthreads();
    for (int c = t; c < C; c += kBT) {
      float dg = 0.f, db = 0.f;
      for (int run = 0; run < runs; ++run) {
        dg += red[(run * 2) * C + c];
        db += red[(run * 2 + 1) * C + c];
      }
      p.part_dgamma[blk * C + c] = dg;
      p.part_dob[blk * C + c] = db;
    }
  }
}

// ---- pass 3 (the streamed plans): dy = dqkv W_qkv^T and the LN backward

// One block a (M-token tile, frame), the tile's dqkv rows resident (their
// K = 3H columns zero-padded to whole chunks), W_qkv's rows streamed as
// 256-channel x kDxK tiles through a ring. dy is never stored: a first
// sweep over the channel tiles gives each row's sums of dy gamma and dy
// gamma xhat and each column's sums of xhat dy (dgamma) and g (dout_bias)
// over the block's rows; a second sweep recomputes dy and writes dx = g +
// rstd (dy gamma - mean(dy gamma) - xhat mean(dy gamma xhat)). Warps:
// M / 16 row groups x 8 / (M / 16) column parts of a tile.
__global__ void __launch_bounds__(kBT, 1) linear_any_bwd_dx_kernel(
    const BwdAny p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int M = p.rows, RG = M / 16, parts = 8 / RG, nw = kDxN / parts;
  const int N = p.N, C = p.C, H = p.heads * p.d, K = 3 * H, kp = dx_k(H);
  const int ap = kp + 8;
  const int bf = blockIdx.y, n0 = blockIdx.x * M, valid = min(M, N - n0);
  const size_t row0 = (size_t)bf * N + n0;
  const bf16* xb = p.x + row0 * C;
  const bf16* gb = p.g + row0 * C;
  const int rg = warp % RG, part = warp / RG, m0 = rg * 16;
  const int ntile = (C + kDxN - 1) / kDxN, nk = kp / kDxK;
  const int nq = 2 * ntile * nk, S = p.stages;
  bf16* as = reinterpret_cast<bf16*>(smem_raw);               // [M][ap]
  bf16* ring = as + M * ap;                                   // [S][kDxN][kDxBP]
  float* mu_s = reinterpret_cast<float*>(ring + S * kDxN * kDxBP);
  float* rs_s = mu_s + M;
  float* m1_s = rs_s + M;
  float* m2_s = m1_s + M;
  float* rowred = m2_s + M;                                   // [8][M][2]
  float* colred = rowred + 8 * M * 2;                         // [4][2][kDxN]
  const bool vk = aligned16(p.dqkv) && K % 8 == 0;
  const bool vw = aligned16(p.w_qkv) && K % 8 == 0;

  // the dqkv rows, zeros past K and from `valid` on
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = t; i < M * (kp / 8); i += kBT) {
    const int r = i / (kp / 8), o = (i % (kp / 8)) * 8;
    bf16* dst = as + r * ap + o;
    const bf16* src = p.dqkv + (row0 + r) * K + o;
    if (vk) {
      const bool ok = r < valid && o < K;
      vmt::cp_async16(dst, ok ? src : p.dqkv, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = r < valid && o + e < K ? src[e] : zero;
    }
  }
  vmt::cp_async_commit();
  // stage q: W_qkv rows (channels) c0.., columns (dqkv's) k0..
  auto load_w = [&](int q) {
    const int ct = (q / nk) % ntile, k0 = (q % nk) * kDxK, c0 = ct * kDxN;
    bf16* dst = ring + (q % S) * kDxN * kDxBP;
    for (int i = t; i < kDxN * (kDxK / 8); i += kBT) {
      const int r = i / (kDxK / 8), o = (i % (kDxK / 8)) * 8;
      const int c = c0 + r, k = k0 + o;
      bf16* d = dst + r * kDxBP + o;
      const bf16* src = p.w_qkv + (size_t)c * K + k;
      if (vw) {
        const bool ok = c < C && k < K;
        vmt::cp_async16(d, ok ? src : p.w_qkv, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = c < C && k + e < K ? src[e] : zero;
      }
    }
  };
  for (int q = 0; q < S - 1; ++q) {
    if (q < nq) load_w(q);
    vmt::cp_async_commit();
  }
  lin_row_stats(p.x + (size_t)bf * N * C, n0, valid, M, C, mu_s, rs_s, t);

  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};   // rows g, g + 8
  float acc[16][4];
  const int nt = nw / 8;                           // n8 tiles a warp
  for (int q = 0; q < nq; ++q) {
    const int sweep = q / (ntile * nk), ct = (q / nk) % ntile, kc = q % nk;
    lin_wait(S - 2);
    __syncthreads();  // stage q visible (q = 0: the dqkv rows, mu, rstd);
                      // slot q - 1 free
    if (q + S - 1 < nq) load_w(q + S - 1);
    vmt::cp_async_commit();
    if (kc == 0) {
#pragma unroll
      for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    }
    const bf16* wst = ring + (q % S) * kDxN * kDxBP + part * nw * kDxBP;
#pragma unroll
    for (int ks = 0; ks < kDxK / 16; ++ks) {
      uint32_t a[4];
      vmt::ldsm_x4(a, as + (m0 + vmt::a_row_off(lane)) * ap + kc * kDxK +
                          ks * 16 + vmt::a_col_off(lane));
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        if (2 * np >= nt) continue;
        uint32_t bb[4];
        vmt::ldsm_x4(bb, wst + (np * 16 + vmt::bn_row_off(lane)) * kDxBP +
                             ks * 16 + vmt::bn_col_off(lane));
        vmt::mma_bf16(acc[2 * np], a, bb[0], bb[1]);
        vmt::mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    if (kc + 1 < nk) continue;

    // the tile's epilogue: columns c0 + part nw + 8 n + 2 tq (+1), rows
    // m0 + g (+8)
    const int cw = ct * kDxN + part * nw;
    const int r0 = m0 + g, r1 = r0 + 8;
    const float mu0 = mu_s[r0], rs0 = rs_s[r0], mu1 = mu_s[r1], rs1 = rs_s[r1];
    if (sweep == 0) {
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        if (n >= nt) continue;
        float cg[2] = {0.f, 0.f}, cb[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? r0 : r1, c = cw + n * 8 + 2 * tq + (e & 1);
          if (r >= valid || c >= C) continue;
          const float xh = (bf2f(xb[(size_t)r * C + c]) - (e < 2 ? mu0 : mu1)) *
                           (e < 2 ? rs0 : rs1);
          const float gd = acc[n][e] * p.gamma[c];
          s1[e >> 1] += gd;
          s2[e >> 1] = fmaf(gd, xh, s2[e >> 1]);
          cg[e & 1] = fmaf(xh, acc[n][e], cg[e & 1]);
          cb[e & 1] += bf2f(gb[(size_t)r * C + c]);
        }
        // the column sums over the warp's 16 rows
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            cg[e] += __shfl_xor_sync(0xffffffffu, cg[e], o);
            cb[e] += __shfl_xor_sync(0xffffffffu, cb[e], o);
          }
        if (g == 0)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = part * nw + n * 8 + 2 * tq + e;
            colred[(rg * 2) * kDxN + j] = cg[e];
            colred[(rg * 2 + 1) * kDxN + j] = cb[e];
          }
      }
      __syncthreads();  // the row groups' column sums visible
      const size_t blk = (size_t)bf * gridDim.x + blockIdx.x;
      for (int j = t; j < kDxN; j += kBT) {
        const int c = ct * kDxN + j;
        if (c >= C) continue;
        float dg = 0.f, db = 0.f;
        for (int r = 0; r < RG; ++r) {
          dg += colred[(r * 2) * kDxN + j];
          db += colred[(r * 2 + 1) * kDxN + j];
        }
        p.part_dgamma[blk * C + c] = dg;
        p.part_dob[blk * C + c] = db;
      }
      if (ct + 1 == ntile) {
        // the rows' sums: the quad's lanes, then the column parts in order
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int o = 1; o < 4; o <<= 1) {
            s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], o);
            s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], o);
          }
        if (tq == 0)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            rowred[(part * M + m0 + g + 8 * h) * 2] = s1[h];
            rowred[(part * M + m0 + g + 8 * h) * 2 + 1] = s2[h];
          }
        __syncthreads();
        for (int r = t; r < M; r += kBT) {
          float a1 = 0.f, a2 = 0.f;
          for (int pp = 0; pp < parts; ++pp) {
            a1 += rowred[(pp * M + r) * 2];
            a2 += rowred[(pp * M + r) * 2 + 1];
          }
          m1_s[r] = a1 / C;
          m2_s[r] = a2 / C;
        }
        __syncthreads();  // the rows' means visible
      }
    } else {
      const float m10 = m1_s[r0], m20 = m2_s[r0], m11 = m1_s[r1], m21 = m2_s[r1];
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        if (n >= nt) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = h ? r1 : r0, c = cw + n * 8 + 2 * tq;
          if (r >= valid || c >= C) continue;
          const float mu = h ? mu1 : mu0, rs = h ? rs1 : rs0;
          const float m1 = h ? m11 : m10, m2 = h ? m21 : m20;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (c + e >= C) {
              v[e] = 0.f;
              continue;
            }
            const float xh = (bf2f(xb[(size_t)r * C + c + e]) - mu) * rs;
            const float gd = acc[n][2 * h + e] * p.gamma[c + e];
            v[e] = bf2f(gb[(size_t)r * C + c + e]) + rs * (gd - m1 - xh * m2);
          }
          bf16* dst = p.dx + (row0 + r) * C + c;
          if (C % 2 == 0) {
            *reinterpret_cast<uint32_t*>(dst) = vmt::pack_bf16x2(v[0], v[1]);
          } else {
            dst[0] = __float2bfloat16(v[0]);
            if (c + 1 < C) dst[1] = __float2bfloat16(v[1]);
          }
        }
      }
    }
  }
}

// ---- host

template <class K>
cudaError_t launch_k(K* kern, dim3 grid, int smem, const BwdAny& p,
                     cudaStream_t st) {
  cudaError_t err = lin_smem_attrs(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kBT, smem, st>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_passes(const BwdAny& p1, const BwdAny& p2,
                          const BwdPlan& pl, int BF, int tiles, float* dek,
                          float* dev, cudaStream_t st) {
  cudaError_t err = launch_k(
      pl.sums_res ? linear_any_bwd_sums_kernel<DP, true>
                  : linear_any_bwd_sums_kernel<DP, false>,
      dim3(tiles, p1.heads, BF), pl.sums_smem, p1, st);
  if (err != cudaSuccess) return err;
  const int d = p1.d;
  linear_any_bwd_merge<DP><<<dim3(p1.heads, BF), kBT,
                         ((size_t)2 * d * d + 3 * d) * sizeof(float), st>>>(
      p1, tiles, dek, dev);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_k(pl.tok_res ? linear_any_bwd_tok_kernel<DP, true>
                            : linear_any_bwd_tok_kernel<DP, false>,
                 dim3((p2.N + pl.tok_rows - 1) / pl.tok_rows, BF),
                 pl.tok_smem, p2, st);
  if (err != cudaSuccess || pl.tok_res) return err;
  BwdAny p3 = p2;
  p3.rows = pl.dx_rows;
  p3.stages = pl.dx_stages;
  return launch_k(linear_any_bwd_dx_kernel,
                  dim3((p2.N + pl.dx_rows - 1) / pl.dx_rows, BF), pl.dx_smem,
                  p3, st);
}

// dW = A^T B over the rows: reduce.cu's pipelined contraction where M and N
// are multiples of its 64 x 64 tile (and the rows 16-byte aligned), else
// any_contract_partial (both ordered: two launches give the same bits)
bool tiled(int M, int N) {
  return M % vmt::kContractTile == 0 && N % vmt::kContractTile == 0;
}

size_t contract_bytes(int rows, int M, int N) {
  return tiled(M, N) ? vmt::contract_workspace(1, rows, M, N)
                     : contract_ws(1, rows, M, N);
}

cudaError_t contract(const bf16* A, const bf16* B, float* out, int rows,
                     int M, int N, float* ws, cudaStream_t st) {
  if (tiled(M, N) && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(B) % 16 == 0)
    return vmt::launch_contract(A, B, out, 1, rows, M, N, 0, 0, ws, st);
  return launch_contract(rows_of(A, M), rows_of(B, N), out, 1, rows, M, N,
                         ws, st);
}

// the blocks that write dgamma and dout_bias partials: pass 2's
// (resident) or pass 3's
int partial_blocks(int BF, int N, const BwdPlan& pl) {
  const int rows = pl.tok_res ? pl.tok_rows : pl.dx_rows;
  return BF * ((N + rows - 1) / rows);
}

// the workspace, carved (p null: the size only)
struct BwdWs {
  bf16 *y, *dqkv, *oh, *ctxp;
  float *part_m, *part_z, *part_ctx, *part_dctx, *mzs, *pdg, *pdb, *colsum,
      *contract;
  size_t bytes;
};

BwdWs bwd_ws(void* base, int BF, int N, int C, int heads, int d,
             const BwdPlan& pl) {
  char* b = static_cast<char*>(base);
  size_t used = 0;
  auto take = [&](size_t bytes) {
    char* out = b == nullptr ? nullptr : b + used;
    used += vmt::align256(bytes);
    return out;
  };
  const size_t R = (size_t)BF * N, H = (size_t)heads * d;
  const size_t tiles = (N + pl.sums_tile - 1) / pl.sums_tile;
  const size_t parts = (size_t)BF * tiles;
  BwdWs w;
  w.y = reinterpret_cast<bf16*>(take(R * C * 2));
  w.dqkv = reinterpret_cast<bf16*>(take(R * 3 * H * 2));
  w.oh = reinterpret_cast<bf16*>(take(R * H * 2));
  w.part_m = reinterpret_cast<float*>(take(parts * H * 4));
  w.part_z = reinterpret_cast<float*>(take(parts * H * 4));
  w.part_ctx = reinterpret_cast<float*>(take(parts * heads * d * d * 4));
  w.part_dctx = reinterpret_cast<float*>(take(parts * heads * d * d * 4));
  w.ctxp = reinterpret_cast<bf16*>(
      take((size_t)BF * heads * 2 * pl.dp * (pl.dp + 8) * 2));
  w.mzs = reinterpret_cast<float*>(take((size_t)BF * 3 * heads * pl.dp * 4));
  const int blocks = partial_blocks(BF, N, pl);
  w.pdg = reinterpret_cast<float*>(take((size_t)blocks * C * 4));
  w.pdb = reinterpret_cast<float*>(take((size_t)blocks * C * 4));
  w.colsum = reinterpret_cast<float*>(take(vmt::colsum_workspace(1, blocks, C)));
  w.contract = reinterpret_cast<float*>(take(std::max(
      contract_bytes((int)R, C, 3 * (int)H), contract_bytes((int)R, (int)H, C))));
  w.bytes = used;
  return w;
}

// dW_qkv = y^T dqkv, dW_out = oh^T g
cudaError_t weight_sums(const BwdWs& w, const bf16* g, float* dw_qkv,
                        float* dw_out, int R, int C, int H, cudaStream_t st) {
  cudaError_t err = contract(w.y, w.dqkv, dw_qkv, R, C, 3 * H, w.contract, st);
  if (err != cudaSuccess) return err;
  return contract(w.oh, g, dw_out, R, H, C, w.contract, st);
}


}  // namespace

// The launch plan of rows 6 and 7 at (BF, N, C, heads, d), as 13 ints
// into plan: dp; pass 1's token tile, resident (0 or 1), ring stages (0
// when resident), shared memory bytes; pass 2's token tile, head group,
// resident, ring stages, shared memory bytes; pass 3's token tile, ring
// stages, shared memory bytes (0, 0, 0 after a resident pass 2). Returns
// 0, or cudaErrorInvalidValue for a shape no plan takes (d > 64, or 3H too
// wide for pass 3's dqkv rows). fused_linear_block.bwd_any_plan is its
// mirror.
extern "C" int vmt_linear_bwd_any_plan(int BF, int N, int C, int heads, int d,
                                       int* plan) {
  BwdPlan pl;
  if (!bwd_plan(BF, N, C, heads, d, &pl)) return (int)cudaErrorInvalidValue;
  const int v[13] = {pl.dp,         pl.sums_tile,  pl.sums_res,
                     pl.sums_stages, pl.sums_smem,  pl.tok_rows,
                     pl.tok_group,   pl.tok_res,    pl.tok_stages,
                     pl.tok_smem,    pl.dx_rows,    pl.dx_stages,
                     pl.dx_smem};
  for (int i = 0; i < 13; ++i) plan[i] = v[i];
  return 0;
}

// Workspace bytes of vmt_linear_block_bwd_any (0 for a shape no plan
// takes).
extern "C" size_t vmt_linear_block_bwd_any_workspace(int BF, int N, int C,
                                                     int heads, int d) {
  BwdPlan pl;
  if (!bwd_plan(BF, N, C, heads, d, &pl)) return 0;
  return bwd_ws(nullptr, BF, N, C, heads, d, pl).bytes;
}

// The linear block's backward at any shape (d <= 64). x, g (BF, N, C)
// bf16; gamma (C); w_qkv (C, 3H), w_outT (C, H) bf16; ek/ev (BF, Mc, H)
// bf16 or null when Mc == 0. Out: dx (BF, N, C) bf16; dgamma (C), dw_qkv
// (C, 3H), dw_out (H, C), dout_bias (C), dek/dev (BF, Mc, H), all f32.
// clip = 1: the merged row (clamped k; dk and dek zero where |k| >= 60);
// 0: the per-head row. workspace: vmt_linear_block_bwd_any_workspace()
// bytes.
extern "C" int vmt_linear_block_bwd_any(
    const void* x, const void* gamma, const void* w_qkv, const void* w_outT,
    const void* ek, const void* ev, const void* g, void* dx, void* dgamma,
    void* dw_qkv, void* dw_out, void* dout_bias, void* dek, void* dev,
    void* workspace, int BF, int N, int C, int Mc, int heads, int d,
    float scale, float inv_hw, int clip, void* stream) {
  BwdPlan pl;
  if (Mc < 0 || !bwd_plan(BF, N, C, heads, d, &pl) ||
      (Mc > 0 && (ek == nullptr || ev == nullptr || dek == nullptr ||
                  dev == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H = heads * d;
  const size_t R = (size_t)BF * N;
  const BwdWs w = bwd_ws(workspace, BF, N, C, heads, d, pl);
  BwdAny p{};
  p.x = static_cast<const bf16*>(x);
  p.gamma = static_cast<const float*>(gamma);
  p.w_qkv = static_cast<const bf16*>(w_qkv);
  p.w_outT = static_cast<const bf16*>(w_outT);
  p.g = static_cast<const bf16*>(g);
  p.ek = static_cast<const bf16*>(ek);
  p.ev = static_cast<const bf16*>(ev);
  p.part_m = w.part_m;
  p.part_z = w.part_z;
  p.part_ctx = w.part_ctx;
  p.part_dctx = w.part_dctx;
  p.ctxp = w.ctxp;
  p.mzs = w.mzs;
  p.dx = static_cast<bf16*>(dx);
  p.y = w.y;
  p.dqkv = w.dqkv;
  p.oh = w.oh;
  p.part_dgamma = w.pdg;
  p.part_dob = w.pdb;
  p.N = N; p.C = C; p.heads = heads; p.d = d; p.Mc = Mc; p.clip = clip;
  p.scale = scale;
  p.inv_hw = inv_hw;
  BwdAny p1 = p, p2 = p;
  p1.tile = pl.sums_tile;
  p1.stages = pl.sums_stages;
  p2.stages = pl.tok_stages;
  p2.rows = pl.tok_rows;
  p2.group = pl.tok_group;
  const int tiles = (N + pl.sums_tile - 1) / pl.sums_tile;
  float* dk = static_cast<float*>(dek);
  float* dv = static_cast<float*>(dev);
  cudaError_t err;
  switch (pl.dp) {
    case 16: err = launch_passes<16>(p1, p2, pl, BF, tiles, dk, dv, st); break;
    case 32: err = launch_passes<32>(p1, p2, pl, BF, tiles, dk, dv, st); break;
    case 48: err = launch_passes<48>(p1, p2, pl, BF, tiles, dk, dv, st); break;
    default: err = launch_passes<64>(p1, p2, pl, BF, tiles, dk, dv, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  const int blocks = partial_blocks(BF, N, pl);
  err = vmt::launch_colsum(w.pdg, static_cast<float*>(dgamma), 1, blocks, C,
                           w.colsum, st);
  if (err != cudaSuccess) return (int)err;
  err = vmt::launch_colsum(w.pdb, static_cast<float*>(dout_bias), 1, blocks,
                           C, w.colsum, st);
  if (err != cudaSuccess) return (int)err;
  return (int)weight_sums(w, static_cast<const bf16*>(g),
                          static_cast<float*>(dw_qkv),
                          static_cast<float*>(dw_out), (int)R, C, H, st);
}
