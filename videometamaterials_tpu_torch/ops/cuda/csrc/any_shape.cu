// Any-shape instances of the sampling path's three kernels, for sm_90a.
//
// Replaces, at every shape the TPU kernels take outside the specialised
// instances' set (F = 11 frames, 8 heads of 32, C in {64, 128, 256, 512},
// at most 69 conditioning tokens):
//   videometamaterials_tpu/ops/pallas/fused_temporal_block.py:_kernel
//     (split layout, pallas_call in _run_kernel)   -> vmt_temporal_block_any
//     (merged layout with emit_p, via _savedp_fwd) -> the same, p set
//   videometamaterials_tpu/ops/pallas/fused_linear_block.py:
//     _merged_stats_kernel (pallas_call in _run_kernel_merged) -> vmt_linear_stats_any
//     _merged_apply_kernel (pallas_call in _run_kernel_merged) -> vmt_linear_apply_any
// The specialised instances (fused_temporal_block.cu, fused_linear_block.cu)
// keep their shapes; the wrappers pick an instance from the shape alone.
//
// Every size is a launch argument: frames F, spatial positions S (tokens N),
// channels C, heads and head width d (hidden H = heads * d), conditioning
// tokens T (Mc). The roundings are the specialised kernels' and their plain
// twins':
//   temporal: y = bf16(LN(x) gamma) (two-pass), qkv = bf16(y @ w_all[f]),
//             p = bf16(softmax_j(q.k_j + bias)), acc = bf16(sum_j p_j v_j),
//             out = bf16(x + acc @ w_out)
//   stats:    k, v = y @ Wk, y @ Wv in f32; z = sum exp(clip(k, +-60)),
//             ctx[h, a, e] = sum bf16(exp(clip(k)))[a] bf16(v / HW)[e]
//             (the conditioning tokens first, then the token tiles in order)
//   apply:    q = y @ Wq in f32; qn = bf16(softmax_head(q) scale / z);
//             oh = bf16(qn_h @ bf16(ctx_h)); out = bf16(x + out_bias + oh @ Wout)
//
// What bounds them on an H100: the same work as the specialised instances
// (PERF.md's table; chip_smoke.py prints each launch's bound). At
// heads4x64's level 0 (22 frames of 9216 tokens, C = 64, 4 heads of 32)
// the stats are bounded by operations (8.3 GFLOP, 8.4 us at 989 TFLOP/s
// bf16), the apply by bytes (x read and out written, 51.9 MB, 15.6 us at
// 3.35 TB/s).
//
// Design. The temporal block (rows 1, 2) in launches of three kinds:
//  - ln_rows_kernel (any_shape.cuh): one warp a row, two-pass, C any.
//  - any_gemm_kernel (any_shape.cuh): its QKV projection and its
//    out-projection with the residual in the epilogue, on the tensor
//    cores, at any M, N, K and any row pitch.
//  - temporal_any_attn_kernel (on the tensor cores, any_attn.cuh): a
//    block a (32 positions, head, batch row) stages the head's token rows
//    and bias once; each warp takes a position at a time, its q, k, v
//    rows of the head arriving by cp.async, and runs mma.sync over key
//    chunks of 32 (the F frames, then the T tokens), the query frames as
//    m16 tiles and d in k-steps of 16. Two passes
//    keep the rounding points of the twin: the scores by mma give each
//    row's running max and sum; then the scores again (kept in registers
//    where one chunk holds every key), p = bf16(softmax) from the final
//    max and sum, and acc = bf16(sum_j p v) by mma with p as the A operand
//    (no rescaled accumulator), 32 features at a time; the next position's
//    rows arrive during this one's products. With a p pointer (row 2,
//    the saved plan's forward) the second pass also writes each bf16 p
//    into the (B, F, S, (F+T) heads) layout with key-group-major lanes;
//    nothing else changes, so out is bit-equal to the launch without p.
// The linear block (rows 4, 5), d up to 64 (the JAX model's linear blocks
// have d = 32): one fused kernel each, every product on mma.sync, k || v
// and q never in device memory (the notes above linear_any_stats_kernel).
//  - stats: one block a (token tile, head group, frame) reads x and writes
//    its tile's partial ctx and z; an ordered reduce adds the
//    conditioning tokens and the tiles in order (no atomics: two launches
//    give the same bits).
//  - apply: one block a (frame, 64 tokens) reads x and writes out.
// A plan (lin_plan, exported as vmt_linear_any_plan) sets each one's
// tiles, head groups and shared memory from the shape: C streams through
// the kernels in K-chunks, the heads in groups; a large heads x d shrinks
// the apply's token tile to 32 or 16.
// The temporal block's scratch (y, qkv, acc) and the stats' partials come
// from the wrapper.
#include <math_constants.h>

#include "any_attn.cuh"
#include "any_linear.cuh"

namespace {

constexpr float kClamp = 60.f;

// ---- temporal attention on the tensor cores (any_attn.cuh), one warp a
// position at a time, a block a (kFwdPos positions, head, batch row)

constexpr int kFwdPos = 32;     // positions a block
constexpr int kFwdWarps = 4;    // warps a block at most, as shared memory allows
// blocks an SM the registers leave room for: at most 170 registers a
// thread, which the stage fits without spilling
constexpr int kFwdBlocks = 3;

// shared memory, bytes: a warp's share (two buffers of a position's q, k,
// v rows of the head, 3 x F x pitch bf16 each: the next position's arrive
// during this one's products), then the block's (attn_block_bytes)
__host__ __device__ inline size_t fwd_rows_bytes(int F, int d) {
  return (size_t)3 * F * attn_pitch(d) * 2;
}
__host__ __device__ inline size_t fwd_warp_bytes(int F, int d) {
  return 2 * fwd_rows_bytes(F, d);
}

// warps a block (0: one warp's share does not fit)
int attn_warps(int F, int T, int d) {
  const size_t base = attn_block_bytes(F, T, d), per = fwd_warp_bytes(F, d);
  if (base + per > kMaxSmem) return 0;
  const size_t w = (kMaxSmem - base) / per;
  return w >= kFwdWarps ? kFwdWarps : (int)w;
}

struct TemporalAttn {
  const bf16* qkv;   // (B, F, S, 3H): q, k, v
  const bf16* ek;    // (B, T, H) or null
  const bf16* ev;
  const float* bias; // (F, F + T, heads)
  bf16* acc;         // (B, F, S, H)
  bf16* p;           // (B, F, S, (F + T) heads) or null
  int B, F, S, T, heads, d;
  int ppb;           // positions a block: kFwdPos, fewer on small grids
};

// features of an output chunk: a wider head takes its value sums 32
// features at a time (the scores again for each, but where one chunk of
// keys holds them all)
constexpr int kFwdFC = 32;

__global__ void __launch_bounds__(kFwdWarps * 32, kFwdBlocks)
    temporal_any_attn_kernel(
    const TemporalAttn a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kNT = kFwdFC / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z, s0 = blockIdx.x * a.ppb;
  const int F = a.F, T = a.T, G = F + T, d = a.d, H = a.heads * d;
  const int dp = attn_dp(d), pitch = dp + 8, ksteps = dp / 16;
  const int nqt = attn_fq(F) / 16;
  // one chunk of keys: the scores of pass 1 are kept for pass 2
  const bool one = G <= kAttnKeys;
  const size_t per = fwd_warp_bytes(F, d);
  // two buffers of [3][F][pitch]
  bf16* frs = reinterpret_cast<bf16*>(smem_raw + warp * per);
  const size_t rows_elems = fwd_rows_bytes(F, d) / sizeof(bf16);
  bf16* tok = reinterpret_cast<bf16*>(smem_raw + warps * per);
  bf16* zrow = tok + (size_t)2 * T * pitch;
  float* bias_h = reinterpret_cast<float*>(zrow + pitch);     // [F][G]
  attn_stage_block(smem_raw, warps * per + attn_block_bytes(F, T, d), tok,
                   bias_h, a.ek, a.ev, a.bias, b, F, T, H, h, a.heads, d,
                   pitch);
  const int gq = lane >> 2, tq = lane & 3;
  const int npos = min(a.ppb, a.S - s0);
  if (warp < npos)
    attn_load_rows(frs, a.qkv, nullptr, 3, -1, b, F, a.S, s0 + warp, H, h, d,
                    pitch, lane);
  for (int pos = warp, buf = 0; pos < npos; pos += warps, buf ^= 1) {
    const int s = s0 + pos;
    const bool ahead = pos + warps < npos;
    if (ahead)
      attn_load_rows(frs + (buf ^ 1) * rows_elems, a.qkv, nullptr, 3, -1, b, F,
                      a.S, s + warps, H, h, d, pitch, lane);
    attn_wait_rows(ahead);
    const AttnRows rows{frs + buf * rows_elems, tok, zrow, F, T, pitch};
    for (int qt = 0; qt < nqt; ++qt) {
      const int i0 = qt * 16;
      auto qrow = [&](int i) { return rows.frame(i0 + i, 0); };
      // bf16(p) of a chunk (keys j0..) into the (B, F, S, (F+T) heads)
      // layout
      auto store_p = [&](const float (&pr)[4][4], int j0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + gq + 8 * half;
          if (i >= F) continue;
          bf16* prow = a.p + (((size_t)b * F + i) * a.S + s) * G * a.heads;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = j0 + nt * 8 + 2 * tq + e;
              if (j < G)
                prow[(size_t)j * a.heads + h] =
                    __float2bfloat16(pr[nt][2 * half + e]);
            }
        }
      };
      // the weights of a chunk: softmax from the final max and sum, bf16
      auto weights = [&](float (&pr)[4][4], const float (&m)[2],
                         const float (&l)[2]) {
        attn_probs(pr, m, l);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) pr[nt][e] = round_bf16(pr[nt][e]);
      };
      // pass 1: the running max and sum of each query row
      float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
      float keep[4][4];
      for (int j0 = 0; j0 < G; j0 += kAttnKeys) {
        attn_scores(keep, qrow, [&](int j) { return rows.key(j0 + j, 1); },
                    ksteps, lane);
        attn_bias_mask(keep, bias_h, i0, j0, F, G, lane);
        attn_online(keep, m, l);
      }
      if (one) {
        weights(keep, m, l);
        if (a.p != nullptr) store_p(keep, 0);
      }
      // pass 2, a chunk of features at a time: p = bf16(softmax) from the
      // final max and sum (the scores again where there are several key
      // chunks; written once, with p set) and acc = bf16(sum_j p v)
      for (int f0 = 0; f0 < dp; f0 += kFwdFC) {
        const int npairs = min(kFwdFC, dp - f0) / 16;
        float acc[kNT][4] = {};
        if (one) {
          attn_mma_frag<false, kNT>(
              acc, keep, [&](int j) { return rows.key(j, 2); }, f0, npairs,
              lane);
        } else {
          for (int j0 = 0; j0 < G; j0 += kAttnKeys) {
            float pr[4][4];
            attn_scores(pr, qrow, [&](int j) { return rows.key(j0 + j, 1); },
                        ksteps, lane);
            attn_bias_mask(pr, bias_h, i0, j0, F, G, lane);
            weights(pr, m, l);
            if (a.p != nullptr && f0 == 0) store_p(pr, j0);
            attn_mma_frag<false, kNT>(
                acc, pr, [&](int j) { return rows.key(j0 + j, 2); }, f0,
                npairs, lane);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + gq + 8 * half;
          if (i >= F) continue;
          bf16* orow = a.acc + (((size_t)b * F + i) * a.S + s) * H + h * d;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int f = f0 + nt * 8 + 2 * tq + e;
              if (f < d) orow[f] = __float2bfloat16(acc[nt][2 * half + e]);
            }
        }
      }
    }
    __syncwarp();  // this buffer's reads are done before it is refilled
  }
}

// ---- linear stats and apply (rows 4, 5) on the tensor cores
//
// Both kernels: 256 threads a block, every product on mma.sync. The x
// rows are staged raw (bf16, by cp.async) in K-chunks of kLinKC columns.
// A head's weight columns are staged as a block of DP = 16 ceil(d / 16)
// columns, zeros past d, so a head starts on a fragment boundary; DP is a
// template parameter (16, 32, 48, 64), so the fragments' registers are
// indexed at compile time. y = bf16(LN(x) gamma) is ln_rows_kernel's, bit
// for bit: eight threads a row play its warp's lanes and sum in its order.
// Two modes, picked by the plan (lin_plan):
//  - resident (kRes; C <= 128, the weights and two or three tiles of x rows
//    beside two blocks an SM: heads4x64's full-resolution level): the
//    weights are loaded once a block and stay; the next tile's x rows
//    arrive during this one's products; LN runs on the staged rows, its
//    values in registers (lin_ln_tile), writing y to shared memory; an
//    apply block walks up to four 64-token tiles of its frame;
//  - streamed: every other shape; a ring of 3 to kLinMaxStages stages (as
//    many as the plan's shared memory takes), each one K-chunk of x rows,
//    their gamma and the matching weight rows, so C bounds no buffer; the
//    LN statistics come from device memory (lin_row_stats: bf16 pairs,
//    two rows' loads in flight) and the x fragments are normalised to y as
//    they are read (ldmatrix, then (x - mu) rstd gamma in registers).
// Measured (PERF.md): the LN, the stats' exp epilogue and the
// apply's softmax and stores take most of a resident block's time, the
// chunk loads and the device-memory LN most of a streamed one's.

// blocks that keep the card's 132 SMs busy: one a SM for the stats' head
// groups, two for the resident apply's span; the streamed apply takes its
// largest token tile with three quarters of that (each block reads all of
// W_q and W_out: a smaller tile reads them more often)
constexpr int kLinGridBlocks = 132, kLinSpanBlocks = 264;
constexpr int kLinApplyBlocks = 3 * kLinGridBlocks / 4;
constexpr int kLinSpanTiles = 4;      // 64-token tiles a resident apply block

// The launch plan of rows 4 and 5 at a shape (vmt_linear_any_plan;
// fused_linear_block.any_plan mirrors it).
struct LinPlan {
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
};

// stats: resident: the W chunks, gamma, two sub-tiles of x chunks;
// streamed: the ring; then pkv [64][wp] bf16, zs [4][half] f32, mu, rstd
__host__ __device__ inline int lin_stats_smem(int group, int dp, int C,
                                              bool res, int stages) {
  const int half = group * dp, wp = 2 * half + 8;
  const int nkc = (C + kLinKC - 1) / kLinKC;
  const int tail = kLinStatM * wp * 2 + 4 * half * 4 + kLinStatM * 8;
  return (res ? nkc * kLinKC * (wp * 2 + 4) +
                    2 * nkc * kLinStatM * kLinXP * 2
              : stages * lin_stage_bytes(kLinStatM, wp)) +
         tail;
}

// apply: resident: W_q's chunks, gamma, W_out's chunks, two tiles of x
// chunks and one of y chunks; streamed: the ring; then the group's bf16 context
// [group][dp][dp + 8] and 1/z, mu and rstd, the oh tile [tile][heads dp
// rounded to kLinKC, + 8] bf16
__host__ __device__ inline int lin_apply_smem(int tile, int group, int heads,
                                              int dp, int C, bool res,
                                              int stages) {
  const int hpk = (heads * dp + kLinKC - 1) / kLinKC * kLinKC;
  const int nkc = (C + kLinKC - 1) / kLinKC;
  const int cb = (8 / (tile / 16)) * lin_apply_wc(tile, C);
  const int tail = group * dp * (dp + 8) * 2 + group * dp * 4 + tile * 8 +
                   tile * (hpk + 8) * 2;
  return (res ? nkc * kLinKC * ((group * dp + 8) * 2 + 4) +
                    hpk * (cb + 8) * 2 + 3 * nkc * tile * kLinXP * 2
              : stages *
                    lin_stage_bytes(tile, lin_apply_wp(tile, group, dp, C))) +
         tail;
}

// false: a shape no plan takes (d > kMaxLinD, or an oh tile of 16 tokens
// that does not fit)
bool lin_plan(int BF, int N, int C, int heads, int d, LinPlan* p) {
  if (BF <= 0 || N <= 0 || C <= 0 || heads <= 0 || d <= 0 || d > kMaxLinD)
    return false;
  p->dp = (d + 15) / 16 * 16;
  // stats: each column half (k, v) of a block holds at most 128 columns;
  // smaller head groups where the grid would leave SMs idle (one head, or
  // an even number: stats_col)
  p->stats_tile = N >= 4096 ? 256 : 64;   // stats_tile (fused_linear_block.py)
  int group = heads < 128 / p->dp ? heads : 128 / p->dp;
  if (group > 1 && group % 2) --group;
  const long tiles = (N + p->stats_tile - 1) / p->stats_tile;
  while (group > 1 &&
         tiles * ((heads + group - 1) / group) * BF < kLinGridBlocks) {
    group /= 2;
    if (group > 1 && group % 2) --group;
  }
  p->stats_group = group;
  // resident: C <= 128 (lin_ln_tile) and two blocks an SM
  p->stats_res =
      C <= 128 && lin_stats_smem(group, p->dp, C, true, 0) <= kLinResSmem;
  // streamed: as many stages as fit two blocks an SM where the grid has
  // more blocks than SMs, else one
  const long sblocks = tiles * ((heads + group - 1) / group) * BF;
  const int slimit = sblocks > kLinGridBlocks ? kLinResSmem : (int)kMaxSmem;
  p->stats_stages = p->stats_res ? 0 : lin_stages([&](int s) {
    return lin_stats_smem(group, p->dp, C, false, s);
  }, slimit);
  p->stats_smem =
      lin_stats_smem(group, p->dp, C, p->stats_res, p->stats_stages);
  // apply, resident: one q pass over every head (at most 64 q columns a
  // warp), the out-projection's columns in one block, two blocks an SM
  const int cap = 2 * (64 / p->dp);
  const int ga = heads < cap ? heads : cap;
  if (ga == heads && 2 * lin_apply_wc(64, C) >= C &&
      lin_apply_smem(64, ga, heads, p->dp, C, true, 0) <= kLinResSmem) {
    int span = kLinSpanTiles;
    while (span > 1 &&
           (long)((N + 64 * span - 1) / (64 * span)) * BF < kLinSpanBlocks)
      span /= 2;
    p->apply_tile = 64;
    p->apply_span = 64 * span;
    p->apply_group = ga;
    p->apply_res = 1;
    p->apply_stages = 0;
    p->apply_smem = lin_apply_smem(64, ga, heads, p->dp, C, true, 0);
    return true;
  }
  // apply, streamed: the largest token tile whose oh tile fits and whose
  // grid has kLinApplyBlocks blocks, else the smallest that fits; a warp's
  // q columns (a group over 8 / (tile / 16) column parts) stay within 128
  bool found = false;
  for (int tile = 64; tile >= 16; tile /= 2) {
    const int parts = 8 / (tile / 16);
    int g = parts * (128 / p->dp);
    if (g > kLinMaxCols / p->dp) g = kLinMaxCols / p->dp;
    if (g > heads) g = heads;
    auto smem = [&](int s) {
      return lin_apply_smem(tile, g, heads, p->dp, C, false, s);
    };
    if (smem(kLinMinStages) > (int)kMaxSmem) continue;
    const long blocks = (long)((N + tile - 1) / tile) * BF;
    p->apply_tile = p->apply_span = tile;
    p->apply_group = g;
    p->apply_res = 0;
    p->apply_stages = lin_stages(
        smem, blocks > kLinGridBlocks ? kLinResSmem : (int)kMaxSmem);
    p->apply_smem = smem(p->apply_stages);
    found = true;
    if (blocks >= kLinApplyBlocks) break;
  }
  return found;
}

struct LinAny {
  const bf16* x;         // (BF, N, C)
  const float* gamma;    // (C)
  const bf16* w_qkv;     // (C, 3H)
  const bf16* w_out;     // (H, C)
  const float* out_bias; // (C)
  const float* ctx;      // (BF, heads, d, d)
  const float* z;        // (BF, H)
  bf16* out;             // (BF, N, C)
  float* part_ctx;       // (BF, tiles, heads, d, d)
  float* part_z;         // (BF, tiles, H)
  int N, C, heads, d, tile, span, group, stages;
  float inv_hw, scale;
};

__device__ __forceinline__ float clamp_k(float k) {
  return fminf(fmaxf(k, -kClamp), kClamp);
}

// Row 4. One block a (token tile, head group, frame); warp (rg, ch): token
// rows 16 rg.. of each 64-token sub-tile, column half ch of the group's k
// and v columns (stats_col: half the heads' k and v each, or for a group
// of one head its k, then its v; dp columns a head). From the k fragments
// pk = exp(clip(k)) and z (rows, then a shared row a row group); bf16(pk)
// and bf16(v / HW) into pkv [token][the same columns]; then ctx_h =
// bf16(pk_h)^T v_h over the sub-tile's tokens on mma.sync, A read
// transposed by ldmatrix, one warp a 16-row strip (head, 16 context rows)
// of the group. The tile's partials go to scratch; the ordered reduce
// adds the conditioning tokens and the tiles in order.
template <int DP, bool kRes>
__global__ void __launch_bounds__(kLinThreads, 2) linear_any_stats_kernel(
    const LinAny p) {
  constexpr int kNTD = DP / 8;                 // n8 tiles a head
  constexpr int kNT = (128 / DP) * kNTD;       // n8 tiles a warp at most
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int tt = blockIdx.x, bf = blockIdx.z;
  const int G = p.group, h0 = blockIdx.y * G, half = G * DP, wp = 2 * half + 8;
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
  // streamed: the ring), then pkv, zs, mu, rstd
  constexpr int kXS = kLinStatM * kLinXP;      // elements of an x chunk
  const int stage = lin_stage_bytes(kLinStatM, wp);
  unsigned char* tail = smem_raw + (kRes ? nkc * kLinKC * (wp * 2 + 4) +
                                               2 * nkc * kXS * 2
                                         : p.stages * stage);
  bf16* pkv = reinterpret_cast<bf16*>(tail);                    // [64][wp]
  float* zs = reinterpret_cast<float*>(pkv + kLinStatM * wp);   // [4][half]
  float* mu_s = zs + 4 * half;                                  // [64]
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
      if (n_sub > 0) load_x(0, kc);
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
  for (int i = t; i < 4 * half; i += kLinThreads) zs[i] = 0.f;

  float cacc[kNTD][4];
#pragma unroll
  for (int n = 0; n < kNTD; ++n) cacc[n][0] = cacc[n][1] = cacc[n][2] = cacc[n][3] = 0.f;
  for (int s = 0; s < n_sub; ++s) {
    const int ns = n_begin + s * kLinStatM;
    const int valid = min(kLinStatM, n_end - ns);
    float acc[kNT][4];
    float mu[2], rs[2];
    auto zero_acc = [&]() {
#pragma unroll
      for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    };
    if (kRes) {
      vmt::cp_async_wait<1>();
      __syncthreads();  // sub-tile s's x (s = 0: the weights) visible; the
                        // last sub-tile's readers of pkv, mu, rstd done
      // y over the sub-tile's x rows, in place
      bf16* xsub = xs(s, 0);
      lin_ln_tile(xsub, xsub, kXS, gres, valid, kLinStatM, C, t);
      __syncthreads();  // y visible
      zero_acc();
      for (int kc = 0; kc < nkc; ++kc)
        lin_project<kNT, false>(acc, xs(s, kc), gs(s, kc), ws(s, kc), wp, m0,
                                ch * half, half / 8, mu, rs, lane);
    } else {
      // the last sub-tile's readers of mu and rstd are past its pkv barrier
      lin_row_stats(xb, ns, valid, kLinStatM, C, mu_s, rs_s, t);
      zero_acc();
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

    // pk and z from the k fragments, v / HW from the v fragments; rows past
    // the tile's end and columns past a head's d count nothing
    const bool v0 = m0 + g < valid, v1 = m0 + g + 8 < valid;
    bf16* prow0 = pkv + (m0 + g) * wp + ch * half + 2 * tq;
    bf16* prow1 = prow0 + 8 * wp;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (n * 8 >= half) continue;
      const KvCol kc = stats_col<DP>(ch, n * 8 + 2 * tq, G);
      const bool hv = h0 + kc.hl < heads;
      const bool c0 = kc.a < d && hv, c1 = kc.a + 1 < d && hv;
      // z's column: the k column's index in the group
      const int col = kc.hl * DP + kc.a;
      float e[4];
      if (!kc.v) {
        e[0] = v0 && c0 ? expf(clamp_k(acc[n][0])) : 0.f;
        e[1] = v0 && c1 ? expf(clamp_k(acc[n][1])) : 0.f;
        e[2] = v1 && c0 ? expf(clamp_k(acc[n][2])) : 0.f;
        e[3] = v1 && c1 ? expf(clamp_k(acc[n][3])) : 0.f;
        float z0 = e[0] + e[2], z1 = e[1] + e[3];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          z0 += __shfl_xor_sync(0xffffffffu, z0, o);
          z1 += __shfl_xor_sync(0xffffffffu, z1, o);
        }
        if (g == 0) {
          zs[rg * half + col] += z0;
          zs[rg * half + col + 1] += z1;
        }
      } else {
        e[0] = v0 && c0 ? acc[n][0] * p.inv_hw : 0.f;
        e[1] = v0 && c1 ? acc[n][1] * p.inv_hw : 0.f;
        e[2] = v1 && c0 ? acc[n][2] * p.inv_hw : 0.f;
        e[3] = v1 && c1 ? acc[n][3] * p.inv_hw : 0.f;
      }
      *reinterpret_cast<uint32_t*>(prow0 + n * 8) = vmt::pack_bf16x2(e[0], e[1]);
      *reinterpret_cast<uint32_t*>(prow1 + n * 8) = vmt::pack_bf16x2(e[2], e[3]);
    }
    __syncthreads();  // pkv and this sub-tile's z rows visible; resident:
                      // sub-tile s's x read by every warp
    if (kRes) {
      if (s + 2 < n_sub)
        for (int kc = 0; kc < nkc; ++kc) load_x(s + 2, kc);
      vmt::cp_async_commit();
    }

    // ctx_h[a][e] += sum_tok bf16(pk)[tok][a] bf16(v / HW)[tok][e]
    if (warp < strips) {
      // head hh's k and v columns in the stats' layout
      const int gh = G == 1 ? 1 : G / 2, part = hh / gh;
      const int k_off = G == 1 ? 0 : part * half + (hh % gh) * DP;
      const int v_off = G == 1 ? half : k_off + gh * DP;
      const bf16* pkh = pkv + k_off + am0;
      const bf16* vh = pkv + v_off;
#pragma unroll
      for (int ks = 0; ks < kLinStatM / 16; ++ks) {
        uint32_t a[4];
        vmt::ldsm_x4_t(a, pkh + (ks * 16 + vmt::at_row_off(lane)) * wp +
                              vmt::at_col_off(lane));
#pragma unroll
        for (int np = 0; np < kNTD / 2; ++np) {
          uint32_t bb[4];
          vmt::ldsm_x4_t(bb, vh + (ks * 16 + vmt::bk_row_off(lane)) * wp +
                                 np * 16 + vmt::bk_col_off(lane));
          vmt::mma_bf16(cacc[2 * np], a, bb[0], bb[1]);
          vmt::mma_bf16(cacc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
  }

  // the tile's partials: ctx of the warp's strip; z of the group's columns,
  // the four row groups in order (zs is complete: its last writes precede
  // the last sub-tile's pkv barrier)
  const size_t pidx = (size_t)bf * gridDim.x + tt;
  if (warp < strips && h0 + hh < heads) {
    float* pc = p.part_ctx + (pidx * heads + h0 + hh) * d * d;
#pragma unroll
    for (int n = 0; n < kNTD; ++n)
#pragma unroll
      for (int half8 = 0; half8 < 2; ++half8) {
        const int a = am0 + g + 8 * half8;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * tq + e;
          if (a < d && col < d) pc[a * d + col] = cacc[n][2 * half8 + e];
        }
      }
  }
  for (int i = t; i < half; i += kLinThreads) {
    const int h = h0 + i / DP, a = i % DP;
    if (h < heads && a < d)
      p.part_z[pidx * H + h * d + a] =
          ((zs[i] + zs[half + i]) + zs[2 * half + i]) + zs[3 * half + i];
  }
}

// one block a (head, frame): the conditioning tokens first, once, then the
// tiles in order
__global__ void __launch_bounds__(kLinThreads) linear_any_stats_reduce(
    const float* __restrict__ part_ctx, const float* __restrict__ part_z,
    const bf16* __restrict__ ek, const bf16* __restrict__ ev,
    float* __restrict__ ctx, float* __restrict__ z, int tiles, int Mc,
    int heads, int d, float inv_hw) {
  const int t = threadIdx.x, h = blockIdx.x, bf = blockIdx.y;
  const int H = heads * d, dd = d * d;
  for (int o = t; o < dd; o += kLinThreads) {
    const int ai = o / d, e = o % d;
    float c = 0.f;
    for (int m = 0; m < Mc; ++m) {
      const size_t row = ((size_t)bf * Mc + m) * H + h * d;
      const float pkc = expf(clamp_k(bf2f(ek[row + ai])));
      c = fmaf(round_bf16(pkc), round_bf16(bf2f(ev[row + e]) * inv_hw), c);
    }
    const float* pc = part_ctx + (size_t)bf * tiles * heads * dd + h * dd + o;
    for (int tt = 0; tt < tiles; ++tt) c += pc[(size_t)tt * heads * dd];
    ctx[((size_t)bf * heads + h) * dd + o] = c;
  }
  if (t < d) {
    float zz = 0.f;
    for (int m = 0; m < Mc; ++m)
      zz += expf(clamp_k(bf2f(ek[((size_t)bf * Mc + m) * H + h * d + t])));
    const float* pz = part_z + (size_t)bf * tiles * H + h * d + t;
    for (int tt = 0; tt < tiles; ++tt) zz += pz[(size_t)tt * H];
    z[(size_t)bf * H + h * d + t] = zz;
  }
}

// exp(q - m) of a head's column; 0 in the padding past d
__device__ __forceinline__ float head_exp_col(float q, float m, bool in_head) {
  return in_head ? expf(q - m) : 0.f;
}

// the apply's bf16 context blocks [head][a][e] of heads h0..h0+group-1 and
// their 1/z, zeros past d and past the last head
template <int DP>
__device__ __forceinline__ void apply_stage_ctx(const LinAny& p, bf16* cs,
                                                float* iz, int bf, int h0,
                                                int group, int t) {
  const int heads = p.heads, d = p.d, H = heads * d;
  const int total = group * DP * DP;
  // eight loads of a thread in flight at a time
  for (int i0 = t; i0 < total; i0 += 8 * kLinThreads) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kLinThreads;
      const int hl = i / (DP * DP), a = (i / DP) % DP, e = i % DP;
      const int h = h0 + hl;
      v[u] = (i < total && h < heads && a < d && e < d)
                 ? p.ctx[(((size_t)bf * heads + h) * d + a) * d + e]
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kLinThreads;
      if (i < total)
        cs[((i / (DP * DP)) * DP + (i / DP) % DP) * (DP + 8) + i % DP] =
            __float2bfloat16(v[u]);
    }
  }
  for (int i = t; i < group * DP; i += kLinThreads) {
    const int h = h0 + i / DP, a = i % DP;
    iz[i] = (h < heads && a < d) ? 1.f / p.z[(size_t)bf * H + h * d + a] : 0.f;
  }
}

// the warp's heads hw0..hw0+nhw-1 of the group at h0 (q in acc, DP
// columns a head): the feature softmax on the fragments (a head's row lies
// in one quad: two shuffles for its max and its sum; the padding past d
// is -inf to the max, 0 to the sum and 0 in qn); oh_h = qn_h bf16(ctx_h)
// with qn = bf16(e (scale / s) (1 / z)) repacked from the accumulators as
// A fragments; bf16(oh) into the oh tile's rows m0.., columns h dp..
template <int DP, int kNT>
__device__ __forceinline__ void apply_heads(float (&acc)[kNT][4],
                                            const bf16* cs, const float* iz,
                                            bf16* oh, int ohp, int h0,
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
      ev[0] = head_exp_col(ev[0], mx0, c < d);
      ev[1] = head_exp_col(ev[1], mx0, c + 1 < d);
      ev[2] = head_exp_col(ev[2], mx1, c < d);
      ev[3] = head_exp_col(ev[3], mx1, c + 1 < d);
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
    const float* izh = iz + hl * DP + 2 * tq;
    const bf16* cb = cs + hl * DP * kCP;
#pragma unroll
    for (int kk = 0; kk < kNTD / 2; ++kk) {
      const float (&x0)[4] = acc[i * kNTD + 2 * kk];
      const float (&x1)[4] = acc[i * kNTD + 2 * kk + 1];
      const float* zc = izh + 16 * kk;
      uint32_t af[4];
      af[0] = vmt::pack_bf16x2(x0[0] * r0 * zc[0], x0[1] * r0 * zc[1]);
      af[1] = vmt::pack_bf16x2(x0[2] * r1 * zc[0], x0[3] * r1 * zc[1]);
      af[2] = vmt::pack_bf16x2(x1[0] * r0 * zc[8], x1[1] * r0 * zc[9]);
      af[3] = vmt::pack_bf16x2(x1[2] * r1 * zc[8], x1[3] * r1 * zc[9]);
#pragma unroll
      for (int np = 0; np < kNTD / 2; ++np) {
        uint32_t bb[4];
        vmt::ldsm_x4_t(bb, cb + (kk * 16 + vmt::bk_row_off(lane)) * kCP +
                               np * 16 + vmt::bk_col_off(lane));
        vmt::mma_bf16(o[2 * np], af, bb[0], bb[1]);
        vmt::mma_bf16(o[2 * np + 1], af, bb[2], bb[3]);
      }
    }
    bf16* orow = oh + (m0 + g) * ohp + (h0 + hl) * DP + 2 * tq;
#pragma unroll
    for (int n = 0; n < kNTD; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          vmt::pack_bf16x2(o[n][0], o[n][1]);
      *reinterpret_cast<uint32_t*>(orow + 8 * ohp + n * 8) =
          vmt::pack_bf16x2(o[n][2], o[n][3]);
    }
  }
}

// dacc += oh[m0..m0+15][kh chunk] @ W_out chunk [kLinKC][wc columns at wsq]
__device__ __forceinline__ void apply_out_chunk(float (&dacc)[kLinWC / 8][4],
                                                const bf16* oh, int ohp,
                                                int kh, const bf16* wsq,
                                                int wp, int wc, int m0,
                                                int lane) {
#pragma unroll
  for (int ks = 0; ks < kLinKC / 16; ++ks) {
    uint32_t a[4];
    vmt::ldsm_x4(a, oh + (m0 + vmt::a_row_off(lane)) * ohp + kh * kLinKC +
                        ks * 16 + vmt::a_col_off(lane));
#pragma unroll
    for (int np = 0; np < kLinWC / 16; ++np) {
      if (np * 16 >= wc) continue;
      uint32_t bb[4];
      vmt::ldsm_x4_t(bb, wsq + (ks * 16 + vmt::bk_row_off(lane)) * wp +
                             np * 16 + vmt::bk_col_off(lane));
      vmt::mma_bf16(dacc[2 * np], a, bb[0], bb[1]);
      vmt::mma_bf16(dacc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// out = bf16(x + out_bias + dacc) of rows m0.. (< valid) of the tile at
// row0 (frame rows), columns c0 + 8 n + 2 tq (+1) < C, in bf16 pairs where
// C is even; xr(r, c) reads x
template <class Xr>
__device__ __forceinline__ void apply_store(const float (&dacc)[kLinWC / 8][4],
                                            const LinAny& p, Xr xr,
                                            size_t row0, int valid, int c0,
                                            int wc, int m0, int lane) {
  const int g = lane >> 2, tq = lane & 3, C = p.C;
  const bool pairs = C % 2 == 0;
#pragma unroll
  for (int half8 = 0; half8 < 2; ++half8) {
    const int r = m0 + g + 8 * half8;
    if (r >= valid) continue;
    bf16* orow = p.out + (row0 + r) * C;
#pragma unroll
    for (int n = 0; n < kLinWC / 8; ++n) {
      if (n * 8 >= wc) continue;
      const int c = c0 + n * 8 + 2 * tq;
      if (pairs) {
        if (c < C)
          *reinterpret_cast<uint32_t*>(orow + c) = vmt::pack_bf16x2(
              xr(r, c) + p.out_bias[c] + dacc[n][2 * half8],
              xr(r, c + 1) + p.out_bias[c + 1] + dacc[n][2 * half8 + 1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c + e < C)
            orow[c + e] = __float2bfloat16(xr(r, c + e) + p.out_bias[c + e] +
                                           dacc[n][2 * half8 + e]);
      }
    }
  }
}

// Row 5. One block a (frame, span tokens), walked `tile` tokens at a time
// (resident: 64-token tiles, up to four; streamed: one tile of 64, 32 or
// 16); warp (rg, ch), rg < tile / 16 over the token rows, ch over 8 /
// (tile / 16) column parts. The q pass walks the heads in groups (the
// resident mode: one): q = y W_q on mma.sync (a part: a run of the group's
// heads, dp columns each), then `apply_heads`; bf16(oh) into the oh tile.
// Then oh W_out on mma.sync, parts x wc columns a block of W_out (the
// resident mode: all C in one), with bf16(x + out_bias + .) in the
// epilogue.
template <int DP, bool kRes>
__global__ void __launch_bounds__(kLinThreads, 2) linear_any_apply_kernel(
    const LinAny p) {
  constexpr int kNTD = DP / 8;
  // n8 tiles a warp at most: 128 q columns, the resident mode 64 (its
  // registers also hold the tile loop's state)
  constexpr int kNT = ((kRes ? 64 : 128) / DP) * kNTD;
  constexpr int kCP = DP + 8;                  // pitch of the context blocks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M = p.tile, RG = M / 16, parts = 8 / RG;
  const int GA = p.group, heads = p.heads, d = p.d, N = p.N, C = p.C;
  const int H = heads * d, hpk = (heads * DP + kLinKC - 1) / kLinKC * kLinKC;
  const int WC = lin_apply_wc(M, C), CB = parts * WC;
  const int nkc = (C + kLinKC - 1) / kLinKC, nkh = hpk / kLinKC;
  const int ncb = (C + CB - 1) / CB, groups = (heads + GA - 1) / GA;
  const int ohp = hpk + 8;
  // pitches of the W_q and W_out chunks
  const int wpq = kRes ? GA * DP + 8 : lin_apply_wp(M, GA, DP, C);
  const int wpo = kRes ? CB + 8 : wpq;
  const int kXS = M * kLinXP;                  // elements of an x chunk
  const int stage = lin_stage_bytes(M, wpq);
  // shared memory: resident: W_q's chunks, gamma, W_out's chunks, two
  // tiles of x chunks, a tile of y chunks; streamed: the ring; then cs, iz,
  // mu, rstd, oh
  bf16* wq_res = reinterpret_cast<bf16*>(smem_raw);
  float* g_res = reinterpret_cast<float*>(wq_res + nkc * kLinKC * wpq);
  bf16* wo_res = reinterpret_cast<bf16*>(g_res + nkc * kLinKC);
  bf16* x_res = wo_res + hpk * wpo;
  bf16* y_res = x_res + 2 * nkc * kXS;
  unsigned char* tail =
      kRes ? reinterpret_cast<unsigned char*>(y_res + nkc * kXS)
           : smem_raw + p.stages * stage;
  bf16* cs = reinterpret_cast<bf16*>(tail);                   // [GA][DP][kCP]
  float* iz = reinterpret_cast<float*>(cs + GA * DP * kCP);   // [GA DP]
  float* mu_s = iz + GA * DP;                                 // [M]
  float* rs_s = mu_s + M;                                     // [M]
  bf16* oh = reinterpret_cast<bf16*>(rs_s + M);               // [M][ohp]

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

  // the oh tile's columns past the last head (zeros into W_out's zero rows)
  for (int i = t; i < M * (hpk - heads * DP); i += kLinThreads) {
    const int r = i / (hpk - heads * DP), c = heads * DP + i % (hpk - heads * DP);
    oh[r * ohp + c] = __float2bfloat16(0.f);
  }

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
    apply_stage_ctx<DP>(p, cs, iz, bf, 0, GA, t);
    const int nhw = max(0, min(hpw, heads - ch * hpw));
    for (int it = 0; it < ntiles; ++it) {
      const int n0 = n_blk + it * M, valid = min(M, N - n0);
      vmt::cp_async_wait<1>();
      __syncthreads();  // tile it's x (it = 0: the weights, cs, iz) visible;
                        // the last tile's readers of mu, rstd, oh done
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
      apply_heads<DP>(acc, cs, iz, oh, ohp, 0, ch * hpw, nhw, d, p.scale, m0,
                      lane);
      __syncthreads();  // the oh tile visible
      float dacc[kLinWC / 8][4];
#pragma unroll
      for (int n = 0; n < kLinWC / 8; ++n) dacc[n][0] = dacc[n][1] = dacc[n][2] = dacc[n][3] = 0.f;
      for (int kh = 0; kh < nkh; ++kh)
        apply_out_chunk(dacc, oh, ohp, kh, wo_res + kh * kLinKC * wpo + ch * WC,
                        wpo, WC, m0, lane);
      apply_store(dacc, p,
                  [&](int r, int c) { return lin_x_at(xtile, kXS, r, c); },
                  (size_t)bf * N + n0, valid, ch * WC, WC, m0, lane);
      __syncthreads();  // every warp done with tile it's x
      if (it + 2 < ntiles) load_x(it + 2);
      vmt::cp_async_commit();
    }
  } else {
    const int n0 = n_blk, valid = min(M, N - n0);
    const int nq1 = groups * nkc, nq = nq1 + ncb * nkh;
    const int S = p.stages;
    auto ring = [&](int q) { return smem_raw + (q % S) * stage; };
    auto xs = [&](int q) { return reinterpret_cast<bf16*>(ring(q)); };
    auto gs = [&](int q) { return reinterpret_cast<float*>(xs(q) + kXS); };
    auto ws = [&](int q) { return reinterpret_cast<bf16*>(gs(q) + kLinKC); };
    auto load_chunk = [&](int q) {
      if (q < nq1) {
        const int k0 = (q % nkc) * kLinKC;
        lin_load_x(xs(q), xb, n0, valid, M, k0, C, vx, t);
        lin_load_gamma(gs(q), p.gamma, k0, C, vg, t);
        lin_load_w<DP>(ws(q), wpq, p.w_qkv, 3 * H, k0, C, 0, 0, GA,
                       (q / nkc) * GA, heads, d, vw, qun);
      } else {
        const int r = q - nq1;
        lin_load_wout<DP>(ws(q), wpq, p.w_out, (r % nkh) * kLinKC,
                          (r / nkh) * CB, C, heads, d, vo, oun);
      }
    };
    for (int q = 0; q < S - 1; ++q) {
      if (q < nq) load_chunk(q);
      vmt::cp_async_commit();
    }
    lin_row_stats(xb, n0, valid, M, C, mu_s, rs_s, t);

    int q = 0;
    float mu[2], rs[2];
    for (int gi = 0; gi < groups; ++gi) {
      const int h0 = gi * GA;
      if (gi > 0) __syncthreads();  // the last group's readers of cs, iz done
      apply_stage_ctx<DP>(p, cs, iz, bf, h0, GA, t);
      const int hw0 = ch * hpw;
      const int nhw = max(0, min(hpw, min(GA, heads - h0) - hw0));
      float acc[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      for (int kc = 0; kc < nkc; ++kc, ++q) {
        lin_wait(S - 2);
        __syncthreads();  // chunk q visible (q = 0: mu, rstd, cs, iz too)
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
      apply_heads<DP>(acc, cs, iz, oh, ohp, h0, hw0, nhw, d, p.scale, m0,
                      lane);
    }

    for (int cbi = 0; cbi < ncb; ++cbi) {
      float dacc[kLinWC / 8][4];
#pragma unroll
      for (int n = 0; n < kLinWC / 8; ++n) dacc[n][0] = dacc[n][1] = dacc[n][2] = dacc[n][3] = 0.f;
      for (int kh = 0; kh < nkh; ++kh, ++q) {
        lin_wait(S - 2);
        __syncthreads();  // chunk q visible (the first: the oh tile too)
        if (q + S - 1 < nq) load_chunk(q + S - 1);
        vmt::cp_async_commit();
        apply_out_chunk(dacc, oh, ohp, kh, ws(q) + ch * WC, wpq, WC, m0,
                        lane);
      }
      apply_store(dacc, p,
                  [&](int r, int c) {
                    return bf2f(xb[(size_t)(n0 + r) * C + c]);
                  },
                  (size_t)bf * N + n0, valid, cbi * CB + ch * WC, WC, m0,
                  lane);
    }
  }
}

// blocks an SM of the stats and the apply kernel of a plan
template <int DP>
cudaError_t lin_occupancy(const LinPlan& pl, int* out) {
  auto ks = pl.stats_res ? linear_any_stats_kernel<DP, true>
                         : linear_any_stats_kernel<DP, false>;
  auto ka = pl.apply_res ? linear_any_apply_kernel<DP, true>
                         : linear_any_apply_kernel<DP, false>;
  cudaError_t err = lin_smem_attrs(ks, pl.stats_smem);
  if (err == cudaSuccess) err = lin_smem_attrs(ka, pl.apply_smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, ks, kLinThreads, pl.stats_smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 1, ka, kLinThreads, pl.apply_smem);
  return err;
}

template <int DP>
cudaError_t lin_stats_launch(const LinAny& p, const LinPlan& pl, int BF,
                             int heads, cudaStream_t st) {
  auto kern = pl.stats_res ? linear_any_stats_kernel<DP, true>
                           : linear_any_stats_kernel<DP, false>;
  cudaError_t err = lin_smem_attrs(kern, pl.stats_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + pl.stats_tile - 1) / pl.stats_tile,
                  (heads + pl.stats_group - 1) / pl.stats_group, BF);
  kern<<<grid, kLinThreads, pl.stats_smem, st>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t lin_apply_launch(const LinAny& p, const LinPlan& pl, int BF,
                             cudaStream_t st) {
  auto kern = pl.apply_res ? linear_any_apply_kernel<DP, true>
                           : linear_any_apply_kernel<DP, false>;
  cudaError_t err = lin_smem_attrs(kern, pl.apply_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + pl.apply_span - 1) / pl.apply_span, BF);
  kern<<<grid, kLinThreads, pl.apply_smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the temporal attention stage at (F, T, d),
// bytes a block; 0 where one warp's share does not fit (the shape is
// refused).
extern "C" size_t vmt_temporal_block_any_smem(int F, int T, int d) {
  if (F <= 0 || T < 0 || d <= 0) return 0;
  const int w = attn_warps(F, T, d);
  return w ? w * fwd_warp_bytes(F, d) + attn_block_bytes(F, T, d) : 0;
}

// The temporal block at any shape. x (B, F, S, C); gamma (C); w_all
// (F, C, 3H); w_out (H, C); bias (F, F + T, heads) f32; ek/ev (B, T, H) or
// null when T == 0; scratch y (B, F, S, C), qkv (B, F, S, 3H), acc
// (B, F, S, H), all bf16; p (B, F, S, (F + T) heads) bf16, or null for no
// softmax weights out.
extern "C" int vmt_temporal_block_any(
    const void* x, const void* gamma, const void* w_all, const void* w_out,
    const void* bias, const void* ek, const void* ev, void* out, void* y,
    void* qkv, void* acc, void* p, int B, int F, int S, int C, int T,
    int heads, int d, void* stream) {
  if (B <= 0 || F <= 0 || S <= 0 || C <= 0 || T < 0 || heads <= 0 || d <= 0 ||
      (T > 0 && (ek == nullptr || ev == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int warps = attn_warps(F, T, d);
  if (warps == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H = heads * d;
  const size_t R = (size_t)B * F * S;
  cudaError_t err = launch_ln(static_cast<const bf16*>(x),
                              static_cast<const float*>(gamma),
                              static_cast<bf16*>(y), R, C, st);
  if (err != cudaSuccess) return (int)err;
  // qkv[b, f] = y[b, f] @ w_all[f]: batch z = b F + f, weights z % F
  err = launch_gemm(gemm(static_cast<const bf16*>(y), C, (size_t)S * C,
                         static_cast<const bf16*>(w_all), 3 * H,
                         (size_t)C * 3 * H, F, qkv, 3 * H, (size_t)S * 3 * H,
                         S, 3 * H, C),
                    B * F, kStoreBf16, st);
  if (err != cudaSuccess) return (int)err;
  TemporalAttn a;
  a.qkv = static_cast<const bf16*>(qkv);
  a.ek = static_cast<const bf16*>(ek);
  a.ev = static_cast<const bf16*>(ev);
  a.bias = static_cast<const float*>(bias);
  a.acc = static_cast<bf16*>(acc);
  a.p = static_cast<bf16*>(p);
  a.B = B; a.F = F; a.S = S; a.T = T; a.heads = heads; a.d = d;
  // positions a block: kFwdPos, or one a warp where that leaves fewer than
  // two blocks an SM (the deep levels' small S)
  a.ppb = (size_t)B * heads * ((S + kFwdPos - 1) / kFwdPos) >= 2 * 132
              ? kFwdPos
              : warps;
  const size_t smem = warps * fwd_warp_bytes(F, d) + attn_block_bytes(F, T, d);
  err = cudaFuncSetAttribute(temporal_any_attn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + a.ppb - 1) / a.ppb, heads, B);
  temporal_any_attn_kernel<<<grid, warps * 32, smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // out = bf16(x + acc @ w_out)
  Gemm g = gemm(static_cast<const bf16*>(acc), H, 0,
                static_cast<const bf16*>(w_out), C, 0, 1, out, C, 0, (int)R,
                C, H);
  g.res = static_cast<const bf16*>(x);
  g.ldr = C;
  return (int)launch_gemm(g, 1, kResidual, st);
}

// The launch plan of rows 4 and 5 at (BF, N, C, heads, d), as twelve ints
// into plan: dp; stats tile, head group, resident (0 or 1), ring stages (0
// when resident), shared memory bytes; apply tile, span, head group,
// resident, ring stages, shared memory bytes.
// Returns 0, or cudaErrorInvalidValue for a shape no plan takes (d > 64).
// fused_linear_block.any_plan is its mirror.
extern "C" int vmt_linear_any_plan(int BF, int N, int C, int heads, int d,
                                   int* plan) {
  LinPlan pl;
  if (BF <= 0 || C <= 0 || !lin_plan(BF, N, C, heads, d, &pl))
    return (int)cudaErrorInvalidValue;
  const int v[12] = {pl.dp,          pl.stats_tile,  pl.stats_group,
                     pl.stats_res,   pl.stats_stages, pl.stats_smem,
                     pl.apply_tile,  pl.apply_span,  pl.apply_group,
                     pl.apply_res,   pl.apply_stages, pl.apply_smem};
  for (int i = 0; i < 12; ++i) plan[i] = v[i];
  return 0;
}

// Blocks an SM of the stats and the apply kernel (out[0], out[1]) at the
// plan of (BF, N, C, heads, d): the occupancy the plan's shared memory and
// the kernels' registers allow.
extern "C" int vmt_linear_any_occupancy(int BF, int N, int C, int heads,
                                        int d, int* out) {
  LinPlan pl;
  if (!lin_plan(BF, N, C, heads, d, &pl)) return (int)cudaErrorInvalidValue;
  switch (pl.dp) {
    case 16: return (int)lin_occupancy<16>(pl, out);
    case 32: return (int)lin_occupancy<32>(pl, out);
    case 48: return (int)lin_occupancy<48>(pl, out);
    default: return (int)lin_occupancy<64>(pl, out);
  }
}

// The linear stats at any shape (d <= 64). x (BF, N, C); w_qkv (C, 3H);
// ek/ev (BF, Mc, H) or null when Mc == 0; scratch part_ctx (BF, tiles,
// heads, d, d) and part_z (BF, tiles, H) f32 with tiles = ceil(N / tile),
// tile the plan's stats tile; out ctx (BF, heads, d, d) and z (BF, H) f32.
extern "C" int vmt_linear_stats_any(
    const void* x, const void* gamma, const void* w_qkv, const void* ek,
    const void* ev, void* part_ctx, void* part_z, void* ctx, void* z, int BF,
    int N, int C, int Mc, int heads, int d, int tile, float inv_hw,
    void* stream) {
  LinPlan pl;
  if (BF <= 0 || C <= 0 || Mc < 0 || !lin_plan(BF, N, C, heads, d, &pl) ||
      tile != pl.stats_tile || (Mc > 0 && (ek == nullptr || ev == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LinAny p{};
  p.x = static_cast<const bf16*>(x);
  p.gamma = static_cast<const float*>(gamma);
  p.w_qkv = static_cast<const bf16*>(w_qkv);
  p.part_ctx = static_cast<float*>(part_ctx);
  p.part_z = static_cast<float*>(part_z);
  p.N = N; p.C = C; p.heads = heads; p.d = d;
  p.tile = pl.stats_tile; p.group = pl.stats_group;
  p.stages = pl.stats_stages;
  p.inv_hw = inv_hw;
  cudaError_t err;
  switch (pl.dp) {
    case 16: err = lin_stats_launch<16>(p, pl, BF, heads, st); break;
    case 32: err = lin_stats_launch<32>(p, pl, BF, heads, st); break;
    case 48: err = lin_stats_launch<48>(p, pl, BF, heads, st); break;
    default: err = lin_stats_launch<64>(p, pl, BF, heads, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + tile - 1) / tile;
  linear_any_stats_reduce<<<dim3(heads, BF), kLinThreads, 0, st>>>(
      static_cast<const float*>(part_ctx), static_cast<const float*>(part_z),
      static_cast<const bf16*>(ek), static_cast<const bf16*>(ev),
      static_cast<float*>(ctx), static_cast<float*>(z), tiles, Mc, heads, d,
      inv_hw);
  return (int)cudaGetLastError();
}

// The linear apply at any shape (d <= 64). x (BF, N, C); w_qkv (C, 3H);
// w_out (H, C); out_bias (C) f32; ctx (BF, heads, d, d), z (BF, H) f32;
// out (BF, N, C). No scratch: q and oh stay on the chip.
extern "C" int vmt_linear_apply_any(
    const void* x, const void* gamma, const void* w_qkv, const void* w_out,
    const void* out_bias, const void* ctx, const void* z, void* out, int BF,
    int N, int C, int heads, int d, float scale, void* stream) {
  LinPlan pl;
  if (BF <= 0 || C <= 0 || !lin_plan(BF, N, C, heads, d, &pl))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LinAny p{};
  p.x = static_cast<const bf16*>(x);
  p.gamma = static_cast<const float*>(gamma);
  p.w_qkv = static_cast<const bf16*>(w_qkv);
  p.w_out = static_cast<const bf16*>(w_out);
  p.out_bias = static_cast<const float*>(out_bias);
  p.ctx = static_cast<const float*>(ctx);
  p.z = static_cast<const float*>(z);
  p.out = static_cast<bf16*>(out);
  p.N = N; p.C = C; p.heads = heads; p.d = d;
  p.tile = pl.apply_tile; p.span = pl.apply_span; p.group = pl.apply_group;
  p.stages = pl.apply_stages;
  p.scale = scale;
  switch (pl.dp) {
    case 16: return (int)lin_apply_launch<16>(p, pl, BF, st);
    case 32: return (int)lin_apply_launch<32>(p, pl, BF, st);
    case 48: return (int)lin_apply_launch<48>(p, pl, BF, st);
    default: return (int)lin_apply_launch<64>(p, pl, BF, st);
  }
}
