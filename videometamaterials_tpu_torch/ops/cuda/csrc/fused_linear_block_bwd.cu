// Fused spatial linear-attention block, backward, for sm_90a.
//
// Replaces videometamaterials_tpu/ops/pallas/fused_linear_block.py:
//   _bwd_kernel         (per-head, pallas_call in _run_bwd_kernel)   clip = 0
//   _bwd_kernel_merged  (merged, pallas_call in _run_bwd_kernel_merged)
//                                                                    clip = 1
// The two rows differ in one place: the merged backward differentiates the
// forward's exp(clip(k, +-60)) and zeroes dk and dek where |k| >= 60
// (:311, :315); the per-head backward differentiates the unclamped token
// softmax. One source serves both through the runtime flag `clip`.
//
// Per folded frame (N tokens + Mc conditioning tokens), heads of d = 32,
// with y = bf16(LN(x) gamma), [q k v] = y W_qkv, kk = clip ? clip(k) : k:
//   P[n,a]  = exp(kk[n,a] - m[a]) zinv[a]              (token softmax)
//   ctx[a,e] = sum_n P[n,a] v[n,e] / HW                (a, e in one head)
//   Q[n,a]  = scale softmax_head(q[n])[a]
//   out     = x + out_bias + (Q ctx) W_out
// and the cotangents of g (all f32 but dx):
//   g_oh = g W_out^T,  dctx = Q^T g_oh,  dQ = g_oh ctx^T
//   dq   = Q dQ - (Q / scale) sum_head Q dQ
//   dP   = dctx v^T / HW,  dk = P (dP - S) with S[a] = sum_e dctx ctx
//   dv   = P dctx / HW     (the cond tokens: dek, dev the same way)
//   dW_out = oh^T g, dout_bias = sum g, dW_qkv = y^T dqkv,
//   dx = g + LN backward of dqkv W_qkv^T, dgamma = sum xhat dy.
//
// Rounding points. Every product takes bf16 operands and sums in f32 on
// the tensor cores. The merged route rounds where the JAX merged backward
// rounds (:256-296, :304-309): Q, ctx, g_oh, dctx, P, v / HW (and y,
// dq/dk/dv, oh for the weight sums and dy) go to bf16 before their
// products. Points that move: the stats sum bf16(exp(kk - m_t)) v with
// m_t the running max of the block's 64-token sub-tiles (the JAX kernel:
// bf16(exp(kk) / Z), normalised first); S = sum_e bf16(dctx) ctx (the JAX
// kernel sums P dP, whose dctx is bf16 too), and the conditioning tokens'
// terms are f32 but for that bf16 dctx. The per-head
// route rounds at the same points, where the JAX _bwd_kernel keeps g_oh,
// dq_t, dctx, dv and dpk in f32 (:482-491), and its oh for dW_out;
// tests/test_torch_port_linear_bwd_rounding.py holds a plain version
// rounding here against both JAX kernels.
//
// What bounds it on an H100, at the level-0 training shape (BF = 44,
// N = 9216, C = 64): it reads x and g and writes dx (156 MB, 47 us) and
// does about 186 GFLOP of the least work (the QKV projection, dy and
// dW_qkv: 3 x 2 C 3H a token; g_oh and dW_out: 2 x 2 H C; six per-head
// 32 x 32 products), 188 us at the bf16 tensor-core rate: the operations
// bound it.
//
// Design. ctx, its normaliser and dctx are sums over all N tokens, so the
// backward runs two passes over the tokens with ordered reduces between
// them and after them (no atomics; two launches give the same bits).
// Blocks of 8 warps (4 at C = 512) take 64-token tiles (32 at C = 512):
// warp (rg, cg) owns rows 16 rg.. and head 2 hp + cg of head pair hp, and
// projects its 16 rows onto the head's q, k, v (from y) and g_oh (from g,
// by W_out^T) columns, 16 x 128 mma.sync m16n8k16 fragments (csrc/mma.cuh)
// from a [C][256] staging of the pair's weights (resident at C <= 128,
// else a three-slot cp.async ring of 32-row chunks). The softmaxes and the
// per-head products run on those fragments in registers (quad shuffles, A
// fragments repacked from accumulators, 32 x 32 ctx/dctx blocks from
// shared memory). LN runs in place on the cp.async'd x rows
// (vmt::layer_norm_tile8, the warp LN's sums bit for bit).
//   1. stats (linear_bwd_stats_kernel, grid (1024-token chunk, head pair,
//      frame)): per 64-token sub-tile (the next one's x and g in flight)
//      the column max of kk, the running max rescaling the context
//      accumulators, P, v / HW, Q and g_oh staged in a [token][256] tile,
//      and ctx = P^T v and dctx = Q^T g_oh contracted over the tokens with
//      ldmatrix .trans; partial ctx, dctx, z, m. The head-layout forward
//      (vmt_linear_head, fused_linear_block.cu) runs it without g.
//      merge (linear_bwd_merge, a block per (context column, frame)): the
//      max-merged, normalised ctx with the cond tokens once, the chunks in
//      order; dctx; their bf16 copies. finish (linear_bwd_finish): S and
//      the cond tokens' dek, dev.
//   2. dx (linear_bwd_dx_kernel, a block per tile): the four head pairs in
//      turn, each: projection, dq/dk/dv and oh in bf16 to shared tiles and
//      from there once to HBM, dy += dqkv_pair W_pair^T (the staged weights
//      read as [c][j]) into a shared f32 tile; then the LN backward, dx,
//      and per-block dgamma and dout_bias partials (reduce.cu's ordered
//      column sums). y goes to HBM with the first pair.
//   3. weight gradients: reduce.cu's split-K contraction (tensor cores,
//      ordered) sums dW_qkv = y^T dqkv and dW_out = oh^T g. A third token
//      pass that recomputed dqkv and kept dW in registers took 0.97 ms at
//      level 0, against 0.22 ms the saves add to the dx pass and 0.39 ms
//      of contraction (scripts/torch_kernel_ab.py --profile, NVIDIA H100
//      80GB HBM3, 700 W; PERF.md).
// Bytes at level 0: x and g read twice and dx written (0.26 GB), y, dqkv
// and oh written once and read once (1.77 GB, against the parent's 1.97 GB
// of round trips, which wrote and read dq twice). Operations: about 590
// kFLOP a token (the projections recomputed in the dx pass), 239 GFLOP.
// What holds it back (NVIDIA H100 80GB HBM3, 700 W,
// scripts/torch_kernel_ab.py --profile): each pass waits per tile on
// barriers and loads, 5-8 us a 64-token tile and head pair with two blocks
// an SM at C = 64 (the dx pass at its 128-register cap spills 32 bytes),
// not on its operations.
#include <math_constants.h>

#include <algorithm>

#include "linear_stats.cuh"
#include "mma.cuh"
#include "reduce.cuh"

namespace {

using vmt::kD;
using vmt::kH;
using vmt::kHeads;
using vmt::bf2f;
using bf16 = __nv_bfloat16;

constexpr int kQKV = 3 * kH;
constexpr float kClamp = 60.f;
constexpr int kPairs = kHeads / 2;
constexpr int kKC = 32;             // weight rows a chunk
constexpr int kPairCols = 256;      // a pair's staged columns: [q k v W_out^T] x 2
constexpr int kWP = kPairCols + 8;  // padded pitch of the weight staging
constexpr int kPVP = kPairCols + 8; // stats' [token][P v Q g_oh] x 2 tile
constexpr int kCtxP = kD + 8;       // bf16 ctx / dctx blocks
constexpr int kDQ = 6 * kD;         // a pair's dq dk dv columns
constexpr int kDQP = kDQ + 8;
constexpr int kOHP = 2 * kD + 8;    // a pair's oh columns
constexpr int kChunkTokens = 1024;  // tokens a stats block

__device__ __forceinline__ float clip_k(float k, int clip) {
  return clip ? fminf(fmaxf(k, -kClamp), kClamp) : k;
}

// 16 rows a warp, row groups of a block: 4 (64 tokens, 8 warps), at
// C = 512 2 (32 tokens, 4 warps) so that its tiles fit shared memory
template <int kC>
__host__ __device__ constexpr int row_groups() { return kC == 512 ? 2 : 4; }
template <int kC>
__host__ __device__ constexpr int threads_of() { return 64 * row_groups<kC>(); }
template <int kC>
__host__ __device__ constexpr int tile_rows() { return 16 * row_groups<kC>(); }
// the pair's C x 256 weights stay in shared memory at C <= 128 (32 / 64
// KB); above, 32-row chunks stream through a ring of three slots
template <int kC>
__host__ __device__ constexpr bool resident() { return kC <= 128; }
template <int kC>
__host__ __device__ constexpr int w_rows() { return resident<kC>() ? kC : 3 * kKC; }

// stats: x and g tiles double-buffered (the next sub-tile's in flight)
template <int kC>
constexpr size_t stats_smem(bool grad) {
  constexpr int kM = tile_rows<kC>(), kYP = kC + 8;
  return ((size_t)2 * kM * kYP * (grad ? 2 : 1) + (size_t)w_rows<kC>() * kWP +
          (size_t)kM * kPVP) * 2 +
         (size_t)(2 * row_groups<kC>() + 3) * 64 * 4;
}

// dx: one tile, the pair's dqkv and oh tiles
template <int kC>
constexpr size_t dx_smem() {
  constexpr int kM = tile_rows<kC>(), kYP = kC + 8;
  return ((size_t)2 * kM * kYP + (size_t)w_rows<kC>() * kWP + (size_t)kM * kDQP +
          (size_t)kM * kOHP + (size_t)4 * kD * kCtxP) * 2 +
         ((size_t)kM * (kC + 4) + 3 * 64) * 4;
}

// ---- loads

// the rows n0.. of a frame into a [kM][kC + 8] tile; rows at or past n_end
// are zero-filled
template <int kC>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int n0,
                                          int n_end, int t) {
  constexpr int kM = tile_rows<kC>(), kYP = kC + 8, kThr = threads_of<kC>();
  for (int i = t; i < kM * kC / 8; i += kThr) {
    const int r = i / (kC / 8), o = (i % (kC / 8)) * 8;
    const bool valid = n0 + r < n_end;
    vmt::cp_async16(dst + r * kYP + o, src + (size_t)(valid ? n0 + r : 0) * kC + o,
                    valid);
  }
}

// weight rows c0..c0+nrows-1 of head pair hp into the staging [.][kWP]:
// 32 columns a segment, [q k v W_out^T] of head 2 hp, then of 2 hp + 1
// (w_outT null: the W_out^T segments are left alone)
__device__ __forceinline__ void load_pair_w(bf16* dst, const bf16* w_qkv,
                                            const bf16* w_outT, int hp, int c0,
                                            int nrows, int t, int nthr) {
  for (int i = t; i < nrows * 32; i += nthr) {
    const int r = i >> 5, piece = i & 31, seg = piece >> 2, off = (piece & 3) * 8;
    const int head = 2 * hp + (seg >> 2), part = seg & 3;
    if (part == 3 && w_outT == nullptr) continue;
    const bf16* src = part < 3
                          ? w_qkv + (size_t)(c0 + r) * kQKV + part * kH + head * kD + off
                          : w_outT + (size_t)(c0 + r) * kH + head * kD + off;
    vmt::cp_async16(dst + r * kWP + seg * kD + off, src);
  }
}

// a frame's bf16 ctx and dctx blocks of the pair ([head][mat][a][kCtxP])
// and its m, zinv, S columns ([3][64])
__device__ __forceinline__ void load_pair_frame(
    bf16* cs, float* fs, const bf16* ctx_b, const bf16* dctx_b,
    const float* m, const float* zinv, const float* S, int bf, int hp, int t,
    int nthr) {
  for (int i = t; i < 2 * 2 * kD * 4; i += nthr) {
    const int piece = i & 3, a = (i >> 2) & (kD - 1), mat = (i >> 7) & 1,
              hl = i >> 8;
    const bf16* src = (mat ? dctx_b : ctx_b) +
                      ((size_t)bf * kH + (2 * hp + hl) * kD + a) * kD + piece * 8;
    vmt::cp_async16(cs + ((hl * 2 + mat) * kD + a) * kCtxP + piece * 8, src);
  }
  for (int i = t; i < 48; i += nthr) {
    const int which = i >> 4, off = (i & 15) * 4;
    const float* src = (which == 0 ? m : which == 1 ? zinv : S) +
                       (size_t)bf * kH + hp * 64 + off;
    vmt::cp_async16(fs + which * 64 + off, src);
  }
}

// LN of the tile in place, (threads / 8) rows a pass; rows >= valid_rows -> 0
template <int kC>
__device__ __forceinline__ void ln_rows(bf16* ys, const float* __restrict__ gamma,
                                        int valid_rows, int t) {
  constexpr int kM = tile_rows<kC>(), kYP = kC + 8, kStep = threads_of<kC>() / 8;
#pragma unroll
  for (int r0 = 0; r0 < kM; r0 += kStep)
    vmt::layer_norm_tile8<kC>(ys + r0 * kYP, kYP, gamma, valid_rows - r0, t);
}

// ---- the projection: warp (rg, cg) rows m0.., head column block cg: n8
// tiles 0-3 q, 4-7 k, 8-11 v (A = y), 12-15 g_oh (A = g)

template <int kYP, int kN0, int kN1>
__device__ __forceinline__ void project_chunk(float (&acc)[16][4], const bf16* ys,
                                              const bf16* gs, const bf16* wch,
                                              int kc0, int m0, int cg, int lane) {
#pragma unroll
  for (int ks = 0; ks < kKC / 16; ++ks) {
    const int aoff = (m0 + vmt::a_row_off(lane)) * kYP + kc0 + ks * 16 +
                     vmt::a_col_off(lane);
    uint32_t ay[4], ag[4];
    vmt::ldsm_x4(ay, ys + aoff);
    if constexpr (kN1 > 12) vmt::ldsm_x4(ag, gs + aoff);
    const bf16* wrow = wch + (ks * 16 + vmt::bk_row_off(lane)) * kWP + cg * 128 +
                       vmt::bk_col_off(lane);
#pragma unroll
    for (int n = kN0; n < kN1; n += 2) {
      uint32_t bb[4];
      vmt::ldsm_x4_t(bb, wrow + n * 8);
      if (n < 12) {
        vmt::mma_bf16(acc[n], ay, bb[0], bb[1]);
        vmt::mma_bf16(acc[n + 1], ay, bb[2], bb[3]);
      } else {
        vmt::mma_bf16(acc[n], ag, bb[0], bb[1]);
        vmt::mma_bf16(acc[n + 1], ag, bb[2], bb[3]);
      }
    }
  }
}

// walk the pair's kC / 32 (>= 8) weight chunks through the three ring
// slots of ws, calling use(chunk, slot) with the chunk landed; the next two
// chunks' copies overlap it. Every thread must be past a barrier after the
// slots' last use; ends with one.
template <int kC, class Use>
__device__ __forceinline__ void ring_walk(bf16* ws, const bf16* w_qkv,
                                          const bf16* w_outT, int hp, int t,
                                          Use use) {
  constexpr int kNKC = kC / kKC, kThr = threads_of<kC>();
  static_assert(kNKC >= 2, "the ring primes two chunks");
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    load_pair_w(ws + q * kKC * kWP, w_qkv, w_outT, hp, q * kKC, kKC, t, kThr);
    vmt::cp_async_commit();
  }
  for (int kc = 0; kc < kNKC; ++kc) {
    vmt::cp_async_wait<1>();
    __syncthreads();  // chunk kc landed; slot (kc + 2) % 3's readers are done
    if (kc + 2 < kNKC)
      load_pair_w(ws + ((kc + 2) % 3) * kKC * kWP, w_qkv, w_outT, hp,
                  (kc + 2) * kKC, kKC, t, kThr);
    vmt::cp_async_commit();
    use(kc, ws + (kc % 3) * kKC * kWP);
  }
  __syncthreads();
}

// acc[kN0..kN1) = the warp's projection; resident: ws holds the pair's
// weights, landed and visible
template <int kC, int kN0, int kN1>
__device__ __forceinline__ void project(float (&acc)[16][4], const bf16* ys,
                                        const bf16* gs, bf16* ws,
                                        const bf16* w_qkv, const bf16* w_outT,
                                        int hp, int m0, int cg, int lane, int t) {
  constexpr int kYP = kC + 8;
#pragma unroll
  for (int n = kN0; n < kN1; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  if constexpr (resident<kC>()) {
#pragma unroll
    for (int kc = 0; kc < kC / kKC; ++kc)
      project_chunk<kYP, kN0, kN1>(acc, ys, gs, ws + kc * kKC * kWP, kc * kKC, m0,
                                   cg, lane);
  } else {
    ring_walk<kC>(ws, w_qkv, w_outT, hp, t, [&](int kc, const bf16* wch) {
      project_chunk<kYP, kN0, kN1>(acc, ys, gs, wch, kc * kKC, m0, cg, lane);
    });
  }
}

// ---- per-head products on the fragments (16 rows x 32 columns a warp)

// A fragments of the n8 tiles base..base+3 of acc as bf16
__device__ __forceinline__ void frag_pack(uint32_t (&a)[2][4], const float (&x)[16][4],
                                          int base) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const float* x0 = x[base + 2 * kk];
    const float* x1 = x[base + 2 * kk + 1];
    a[kk][0] = vmt::pack_bf16x2(x0[0], x0[1]);
    a[kk][1] = vmt::pack_bf16x2(x0[2], x0[3]);
    a[kk][2] = vmt::pack_bf16x2(x1[0], x1[1]);
    a[kk][3] = vmt::pack_bf16x2(x1[2], x1[3]);
  }
}

// o = A (16 x 32) B, B a 32 x 32 bf16 block (pitch kCtxP) stored [k][n]
// (kKN) or [n][k]
template <bool kKN>
__device__ __forceinline__ void mma_head(float (&o)[4][4], const uint32_t (&a)[2][4],
                                         const bf16* b, int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bb[4];
      if (kKN)
        vmt::ldsm_x4_t(bb, b + (ks * 16 + vmt::bk_row_off(lane)) * kCtxP + np * 16 +
                               vmt::bk_col_off(lane));
      else
        vmt::ldsm_x4(bb, b + (np * 16 + vmt::bn_row_off(lane)) * kCtxP + ks * 16 +
                             vmt::bn_col_off(lane));
      vmt::mma_bf16(o[2 * np], a[ks], bb[0], bb[1]);
      vmt::mma_bf16(o[2 * np + 1], a[ks], bb[2], bb[3]);
    }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// q (n8 tiles 0-3) -> Q = e scale / sum_head e, e = exp(q - max_head q);
// rows past the tile's end -> 0
__device__ __forceinline__ void q_softmax(float (&acc)[16][4], float scale, bool v0,
                                          bool v1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < 4; ++n)
      mx = fmaxf(mx, fmaxf(acc[n][2 * half], acc[n][2 * half + 1]));
    mx = quad_max(mx);
    float s = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      acc[n][2 * half] = expf(acc[n][2 * half] - mx);
      acc[n][2 * half + 1] = expf(acc[n][2 * half + 1] - mx);
      s += acc[n][2 * half] + acc[n][2 * half + 1];
    }
    s = quad_sum(s);  // every lane shuffles, valid row or not
    const float r = (half ? v1 : v0) ? scale / s : 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      acc[n][2 * half] *= r;
      acc[n][2 * half + 1] *= r;
    }
  }
}

// The per-head cotangents of the warp's 16 rows from its projection:
// dq, dk, dv (bf16) to the pair's [token][192] tile at column cg * 96,
// and oh = bf16(Q) ctx (bf16) to the [token][64] tile at cg * 32.
// cs: the pair's bf16 ctx/dctx blocks, fs: its m, zinv, S columns.
__device__ __forceinline__ void head_grads(float (&acc)[16][4], const bf16* cs,
                                           const float* fs, bf16* dqs, bf16* ohs,
                                           int cg, int m0, int valid_rows,
                                           int lane, float scale, float inv_hw,
                                           int clip) {
  const int gq = lane >> 2, tq = lane & 3;
  const bool v0 = m0 + gq < valid_rows, v1 = m0 + gq + 8 < valid_rows;
  const bf16* ctxh = cs + (cg * 2) * kD * kCtxP;
  const bf16* dctxh = cs + (cg * 2 + 1) * kD * kCtxP;
  const float* mh = fs + cg * kD;
  const float* zh = fs + 64 + cg * kD;
  const float* sh = fs + 128 + cg * kD;
  bf16* row0 = dqs + (m0 + gq) * kDQP + cg * 3 * kD + 2 * tq;
  bf16* row1 = row0 + 8 * kDQP;
  uint32_t af[2][4];
  float o[4][4];

  // dq from Q and dQ = g_oh ctx^T (ctx [a][e] is B [n][k])
  q_softmax(acc, scale, v0, v1);
  frag_pack(af, acc, 12);
  mma_head<false>(o, af, ctxh, lane);
  float t0 = 0.f, t1 = 0.f;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= acc[n][e];  // t = Q dQ
    t0 += o[n][0] + o[n][1];
    t1 += o[n][2] + o[n][3];
  }
  const float r0 = quad_sum(t0) / scale, r1 = quad_sum(t1) / scale;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    *reinterpret_cast<uint32_t*>(row0 + n * 8) = vmt::pack_bf16x2(
        o[n][0] - acc[n][0] * r0, o[n][1] - acc[n][1] * r0);
    *reinterpret_cast<uint32_t*>(row1 + n * 8) = vmt::pack_bf16x2(
        o[n][2] - acc[n][2] * r1, o[n][3] - acc[n][3] * r1);
  }
  // oh = bf16(Q) ctx (ctx is B [k][n])
  frag_pack(af, acc, 0);
  mma_head<true>(o, af, ctxh, lane);
  bf16* oh0 = ohs + (m0 + gq) * kOHP + cg * kD + 2 * tq;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    *reinterpret_cast<uint32_t*>(oh0 + n * 8) = vmt::pack_bf16x2(o[n][0], o[n][1]);
    *reinterpret_cast<uint32_t*>(oh0 + 8 * kOHP + n * 8) =
        vmt::pack_bf16x2(o[n][2], o[n][3]);
  }

  // dk from P and dP = bf16(v / HW) dctx^T (dctx [a][e] is B [n][k])
#pragma unroll
  for (int n = 8; n < 12; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= inv_hw;
  frag_pack(af, acc, 8);
  mma_head<false>(o, af, dctxh, lane);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float dk[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + 2 * tq + (e & 1);
      const bool valid = e < 2 ? v0 : v1;
      const float k = acc[4 + n][e];
      const float p = valid ? expf(clip_k(k, clip) - mh[col]) * zh[col] : 0.f;
      const bool pass = valid && (!clip || fabsf(k) < kClamp);
      dk[e] = pass ? p * (o[n][e] - sh[col]) : 0.f;
      acc[4 + n][e] = p;
    }
    *reinterpret_cast<uint32_t*>(row0 + kD + n * 8) = vmt::pack_bf16x2(dk[0], dk[1]);
    *reinterpret_cast<uint32_t*>(row1 + kD + n * 8) = vmt::pack_bf16x2(dk[2], dk[3]);
  }

  // dv = bf16(P) dctx / HW (dctx is B [k][n])
  frag_pack(af, acc, 4);
  mma_head<true>(o, af, dctxh, lane);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    *reinterpret_cast<uint32_t*>(row0 + 2 * kD + n * 8) =
        vmt::pack_bf16x2(o[n][0] * inv_hw, o[n][1] * inv_hw);
    *reinterpret_cast<uint32_t*>(row1 + 2 * kD + n * 8) =
        vmt::pack_bf16x2(o[n][2] * inv_hw, o[n][3] * inv_hw);
  }
}

// ---------------------------------------------------------------- stats

// grid (1024-token chunk, head pair, frame). Per 64-token sub-tile: kk, its
// column max over the valid rows, the running max m (the context
// accumulators and z rescaled by exp(m_old - m)), P = exp(kk - m); P,
// v / HW, Q, g_oh to the pv tile; ctx += bf16(P)^T bf16(v / HW), dctx +=
// bf16(Q)^T bf16(g_oh). kGrad false (the head-layout forward): ctx only,
// no g.
template <int kC, bool kGrad>
__global__ void __launch_bounds__(kC == 512 ? 128 : 256, kC == 64 ? 2 : 1)
    linear_bwd_stats_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const bf16* __restrict__ w_qkv, const bf16* __restrict__ w_outT,
    const bf16* __restrict__ g, float* __restrict__ part_ctx,
    float* __restrict__ part_dctx, float* __restrict__ part_z,
    float* __restrict__ part_m, int N, float inv_hw, float scale, int clip) {
  constexpr int kRG = row_groups<kC>(), kThr = threads_of<kC>(), kM = tile_rows<kC>();
  constexpr int kYP = kC + 8, kW = 2 * kRG;
  constexpr int kN0 = kGrad ? 0 : 4, kN1 = kGrad ? 16 : 12;
  constexpr int kItems = kGrad ? 8 : 4, kPW = (kItems + kW - 1) / kW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ys2 = reinterpret_cast<bf16*>(smem_raw);    // [2][kM][kYP]
  bf16* gs2 = ys2 + 2 * kM * kYP;                    // [2][kM][kYP] (kGrad)
  bf16* ws = gs2 + (kGrad ? 2 * kM * kYP : 0);       // [w_rows][kWP]
  bf16* pv = ws + w_rows<kC>() * kWP;                // [kM][kPVP]
  float* cmax = reinterpret_cast<float*>(pv + kM * kPVP);  // [kRG][64]
  float* zpart = cmax + kRG * 64;                    // [kRG][64]
  float* mrun = zpart + kRG * 64;                    // [2][64]
  float* zrun = mrun + 2 * 64;                       // [64]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int hp = blockIdx.y, bf = blockIdx.z;
  const int n_begin = blockIdx.x * kChunkTokens;
  const int n_end = min(N, n_begin + kChunkTokens);
  const int n_sub = (n_end - n_begin + kM - 1) / kM;
  const int rg = warp % kRG, cg = warp / kRG, m0 = rg * 16;
  const bf16* xb = x + (size_t)bf * N * kC;
  const bf16* gb = kGrad ? g + (size_t)bf * N * kC : nullptr;

  // the sub-tile's x (and g) rows into buffer b
  auto load_tiles = [&](int sub, int b) {
    const int ns = n_begin + sub * kM;
    load_rows<kC>(ys2 + b * kM * kYP, xb, ns, n_end, t);
    if constexpr (kGrad) load_rows<kC>(gs2 + b * kM * kYP, gb, ns, n_end, t);
  };
  if constexpr (resident<kC>())
    load_pair_w(ws, w_qkv, kGrad ? w_outT : nullptr, hp, 0, kC, t, kThr);
  load_tiles(0, 0);
  vmt::cp_async_commit();
  if (t < 64) {
    mrun[t] = -CUDART_INF_F;
    zrun[t] = 0.f;
  }
  // contraction items: item = mat * 4 + hl * 2 + half (mat 0: ctx, 1: dctx)
  float cacc[kPW][4][4];
#pragma unroll
  for (int j = 0; j < kPW; ++j)
#pragma unroll
    for (int n = 0; n < 4; ++n) cacc[j][n][0] = cacc[j][n][1] = cacc[j][n][2] = cacc[j][n][3] = 0.f;

  for (int s = 0; s < n_sub; ++s) {
    const int valid_rows = min(kM, n_end - (n_begin + s * kM));
    bf16* ys = ys2 + (s & 1) * kM * kYP;
    const bf16* gs = gs2 + (s & 1) * kM * kYP;
    vmt::cp_async_wait<0>();
    __syncthreads();  // sub-tile s (and the resident weights) visible; the
                      // last sub-tile is done with the other buffers
    if (s + 1 < n_sub) load_tiles(s + 1, (s + 1) & 1);
    vmt::cp_async_commit();
    ln_rows<kC>(ys, gamma, valid_rows, t);
    __syncthreads();
    float acc[16][4];
    project<kC, kN0, kN1>(acc, ys, gs, ws, w_qkv, kGrad ? w_outT : nullptr, hp,
                          m0, cg, lane, t);

    // kk in place of k; the warp's column max over its valid rows
    const bool v0 = m0 + gq < valid_rows, v1 = m0 + gq + 8 < valid_rows;
#pragma unroll
    for (int n = 4; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = clip_k(acc[n][e], clip);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float c0 = fmaxf(v0 ? acc[4 + n][0] : -CUDART_INF_F,
                       v1 ? acc[4 + n][2] : -CUDART_INF_F);
      float c1 = fmaxf(v0 ? acc[4 + n][1] : -CUDART_INF_F,
                       v1 ? acc[4 + n][3] : -CUDART_INF_F);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        c0 = fmaxf(c0, __shfl_xor_sync(0xffffffffu, c0, o));
        c1 = fmaxf(c1, __shfl_xor_sync(0xffffffffu, c1, o));
      }
      if (gq == 0) {
        cmax[rg * 64 + cg * kD + n * 8 + 2 * tq] = c0;
        cmax[rg * 64 + cg * kD + n * 8 + 2 * tq + 1] = c1;
      }
    }
    __syncthreads();  // cmax visible; y and g no longer read

    // the new running max of a column of the pair
    const float* mold = mrun + (s & 1) * 64;
    auto m_new = [&](int col) {
      float mn = mold[col];
#pragma unroll
      for (int r = 0; r < kRG; ++r) mn = fmaxf(mn, cmax[r * 64 + col]);
      return mn;
    };
    // P, z partial sums, and the pv tile: [P | v / HW | Q | g_oh] of the
    // warp's head at cg * 128
    bf16* pv0 = pv + (m0 + gq) * kPVP + cg * 128 + 2 * tq;
    bf16* pv1 = pv0 + 8 * kPVP;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = cg * kD + n * 8 + 2 * tq;
      const float mn0 = m_new(col), mn1 = m_new(col + 1);
      const float p00 = v0 ? expf(acc[4 + n][0] - mn0) : 0.f;
      const float p01 = v0 ? expf(acc[4 + n][1] - mn1) : 0.f;
      const float p10 = v1 ? expf(acc[4 + n][2] - mn0) : 0.f;
      const float p11 = v1 ? expf(acc[4 + n][3] - mn1) : 0.f;
      float z0 = p00 + p10, z1 = p01 + p11;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        z0 += __shfl_xor_sync(0xffffffffu, z0, o);
        z1 += __shfl_xor_sync(0xffffffffu, z1, o);
      }
      if (gq == 0) {
        zpart[rg * 64 + col] = z0;
        zpart[rg * 64 + col + 1] = z1;
      }
      *reinterpret_cast<uint32_t*>(pv0 + n * 8) = vmt::pack_bf16x2(p00, p01);
      *reinterpret_cast<uint32_t*>(pv1 + n * 8) = vmt::pack_bf16x2(p10, p11);
      const float (&v)[4] = acc[8 + n];
      *reinterpret_cast<uint32_t*>(pv0 + kD + n * 8) = vmt::pack_bf16x2(
          v0 ? v[0] * inv_hw : 0.f, v0 ? v[1] * inv_hw : 0.f);
      *reinterpret_cast<uint32_t*>(pv1 + kD + n * 8) = vmt::pack_bf16x2(
          v1 ? v[2] * inv_hw : 0.f, v1 ? v[3] * inv_hw : 0.f);
    }
    if constexpr (kGrad) {
      q_softmax(acc, scale, v0, v1);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        *reinterpret_cast<uint32_t*>(pv0 + 2 * kD + n * 8) =
            vmt::pack_bf16x2(acc[n][0], acc[n][1]);
        *reinterpret_cast<uint32_t*>(pv1 + 2 * kD + n * 8) =
            vmt::pack_bf16x2(acc[n][2], acc[n][3]);
        *reinterpret_cast<uint32_t*>(pv0 + 3 * kD + n * 8) =
            vmt::pack_bf16x2(acc[12 + n][0], acc[12 + n][1]);
        *reinterpret_cast<uint32_t*>(pv1 + 3 * kD + n * 8) =
            vmt::pack_bf16x2(acc[12 + n][2], acc[12 + n][3]);
      }
    }
    __syncthreads();  // pv and zpart visible

    // contractions over the sub-tile's tokens: A = P^T or Q^T read
    // transposed from the [token][a] columns, B = v or g_oh
#pragma unroll
    for (int j = 0; j < kPW; ++j) {
      const int item = warp + j * kW;
      if (item >= kItems) continue;
      const int mat = item >> 2, hl = (item >> 1) & 1, half = item & 1;
      float (&c)[4][4] = cacc[j];
      if (mat == 0) {
        // rows a = half * 16 + gq (+ 8) of head hl: rescale to the new max
        const int col = hl * kD + half * 16 + gq;
        const float s0 = expf(mold[col] - m_new(col));
        const float s1 = expf(mold[col + 8] - m_new(col + 8));
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          c[n][0] *= s0;
          c[n][1] *= s0;
          c[n][2] *= s1;
          c[n][3] *= s1;
        }
      }
      const bf16* pa = pv + hl * 128 + mat * 2 * kD + half * 16;
      const bf16* pb = pv + hl * 128 + mat * 2 * kD + kD;
#pragma unroll
      for (int ks = 0; ks < kM / 16; ++ks) {
        uint32_t a[4];
        vmt::ldsm_x4_t(a, pa + (ks * 16 + vmt::at_row_off(lane)) * kPVP +
                              vmt::at_col_off(lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bb[4];
          vmt::ldsm_x4_t(bb, pb + (ks * 16 + vmt::bk_row_off(lane)) * kPVP + np * 16 +
                                 vmt::bk_col_off(lane));
          vmt::mma_bf16(c[2 * np], a, bb[0], bb[1]);
          vmt::mma_bf16(c[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    if (t < 64) {
      const float mn = m_new(t);
      float zs = 0.f;
#pragma unroll
      for (int r = 0; r < kRG; ++r) zs += zpart[r * 64 + t];
      zrun[t] = zrun[t] * expf(mold[t] - mn) + zs;
      mrun[((s + 1) & 1) * 64 + t] = mn;
    }
  }
  __syncthreads();  // the last zrun / mrun writes visible

  // partials (BF, chunks, d, H): [e][h * 32 + a]
  const size_t pidx = (size_t)bf * gridDim.x + blockIdx.x;
#pragma unroll
  for (int j = 0; j < kPW; ++j) {
    const int item = warp + j * kW;
    if (item >= kItems) continue;
    const int mat = item >> 2, hl = (item >> 1) & 1, half = item & 1;
    float* pc = (mat ? part_dctx : part_ctx) + pidx * kD * kH +
                (2 * hp + hl) * kD + half * 16 + gq;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int e = n * 8 + 2 * tq;
      pc[e * kH] = cacc[j][n][0];
      pc[(e + 1) * kH] = cacc[j][n][1];
      pc[e * kH + 8] = cacc[j][n][2];
      pc[(e + 1) * kH + 8] = cacc[j][n][3];
    }
  }
  if (t < 64) {
    part_z[pidx * kH + hp * 64 + t] = zrun[t];
    part_m[pidx * kH + hp * 64 + t] = mrun[(n_sub & 1) * 64 + t];
  }
}

// The ordered merge of a frame's partials, one block per (context column
// e, frame): thread t takes context row t (head t / 32, feature t % 32);
// the max over the chunks and the cond tokens, then the cond tokens once
// and the chunks in order. ctxn = ctx / z and its bf16 copy, bf16(dctx)
// (part_dctx null: none); m and 1 / z from the column-0 blocks.
__global__ void __launch_bounds__(kH) linear_bwd_merge(
    const float* __restrict__ part_ctx, const float* __restrict__ part_dctx,
    const float* __restrict__ part_z, const float* __restrict__ part_m,
    const bf16* __restrict__ ek, const bf16* __restrict__ ev,
    float* __restrict__ ctxn, bf16* __restrict__ ctx_b,
    bf16* __restrict__ dctx_b, float* __restrict__ m_out,
    float* __restrict__ zinv_out, int n_chunks, int Mc, float inv_hw, int clip) {
  const int t = threadIdx.x, h = t >> 5;
  const int e = blockIdx.x, bf = blockIdx.y;
  const float* pm = part_m + (size_t)bf * n_chunks * kH + t;
  const float* pz = part_z + (size_t)bf * n_chunks * kH + t;
  float M = -CUDART_INF_F;
  for (int i = 0; i < n_chunks; ++i) M = fmaxf(M, pm[(size_t)i * kH]);
  for (int mc = 0; mc < Mc; ++mc)
    M = fmaxf(M, clip_k(bf2f(ek[((size_t)bf * Mc + mc) * kH + t]), clip));
  float c = 0.f, Z = 0.f, dc = 0.f;
  for (int mc = 0; mc < Mc; ++mc) {
    const size_t row = ((size_t)bf * Mc + mc) * kH;
    const float pk = expf(clip_k(bf2f(ek[row + t]), clip) - M);
    Z += pk;
    c = fmaf(pk, bf2f(ev[row + h * kD + e]) * inv_hw, c);
  }
  const float* pc = part_ctx + (size_t)bf * n_chunks * kD * kH + e * kH + t;
  const float* pd = part_dctx ? part_dctx + (size_t)bf * n_chunks * kD * kH + e * kH + t
                              : nullptr;
  for (int i = 0; i < n_chunks; ++i) {
    const float sc = expf(pm[(size_t)i * kH] - M);
    Z = fmaf(pz[(size_t)i * kH], sc, Z);
    c = fmaf(pc[(size_t)i * kD * kH], sc, c);
    if (pd) dc += pd[(size_t)i * kD * kH];
  }
  const float zi = 1.f / Z;
  const size_t o = ((size_t)bf * kH + t) * kD + e;
  ctxn[o] = c * zi;
  ctx_b[o] = __float2bfloat16(c * zi);
  if (pd) dctx_b[o] = __float2bfloat16(dc);
  if (e == 0) {
    m_out[(size_t)bf * kH + t] = M;
    zinv_out[(size_t)bf * kH + t] = zi;
  }
}

// per frame: S = sum_e bf16(dctx) ctx, and the cond tokens' dek, dev (f32
// but for dctx). S takes the bf16 dctx that the token passes' dP = v
// dctx^T takes: dk = P (dP - S) cancels where one token holds a feature's
// softmax, and a dctx rounded in dP but not in S would leave the rounding
// error of dP in the difference
__global__ void __launch_bounds__(kH) linear_bwd_finish(
    const float* __restrict__ ctxn, const bf16* __restrict__ dctx_b,
    const float* __restrict__ m_in, const float* __restrict__ zinv_in,
    const bf16* __restrict__ ek, const bf16* __restrict__ ev,
    float* __restrict__ S_out, float* __restrict__ dek, float* __restrict__ dev,
    int Mc, float inv_hw, int clip) {
  __shared__ float dctx_s[kH * (kD + 1)];
  __shared__ float p_s[kH];
  const int t = threadIdx.x, h = t >> 5, lane = t & 31;
  const int bf = blockIdx.x;
  float dc[kD];
  float S = 0.f;
#pragma unroll
  for (int e = 0; e < kD; ++e) {
    dc[e] = bf2f(dctx_b[((size_t)bf * kH + t) * kD + e]);
    S = fmaf(dc[e], ctxn[((size_t)bf * kH + t) * kD + e], S);
    dctx_s[t * (kD + 1) + e] = dc[e];
  }
  S_out[(size_t)bf * kH + t] = S;
  const float m = m_in[(size_t)bf * kH + t], zi = zinv_in[(size_t)bf * kH + t];
  for (int mc = 0; mc < Mc; ++mc) {
    const size_t row = ((size_t)bf * Mc + mc) * kH;
    const float kc = bf2f(ek[row + t]);
    const float P = expf(clip_k(kc, clip) - m) * zi;
    float dP = 0.f;
#pragma unroll
    for (int e = 0; e < kD; ++e)
      dP = fmaf(dc[e], bf2f(ev[row + h * kD + e]) * inv_hw, dP);
    const bool pass = !clip || fabsf(kc) < kClamp;
    dek[row + t] = pass ? P * (dP - S) : 0.f;
    __syncthreads();  // dctx_s written; p_s of the previous token read
    p_s[t] = P;
    __syncthreads();
    float dV = 0.f;
#pragma unroll
    for (int a = 0; a < kD; ++a)
      dV = fmaf(p_s[h * kD + a], dctx_s[(h * kD + a) * (kD + 1) + lane], dV);
    dev[row + t] = dV * inv_hw;
  }
}

// ---------------------------------------------------------------- dx

// dy += dqkv_pair W_pair^T for the 32 channels c0.. of a staged chunk
// (rows: channels, read as B [n][k]); warp: rows 16 (warp % kRG), 16 of
// the 32 channels
template <int kC>
__device__ __forceinline__ void dy_chunk(float* dys, const bf16* dqs,
                                         const bf16* wch, int c0, int warp,
                                         int lane) {
  constexpr int kRG = row_groups<kC>(), kDYP = kC + 4;
  const int dm0 = 16 * (warp % kRG), dn0 = 16 * (warp / kRG);
  const int gq = lane >> 2, tq = lane & 3;
  float d[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < kDQ / 16; ++ks) {
    uint32_t a[4], bb[4];
    vmt::ldsm_x4(a, dqs + (dm0 + vmt::a_row_off(lane)) * kDQP + ks * 16 +
                        vmt::a_col_off(lane));
    // dqkv columns 0-95: staged q, k, v of head 2 hp; 96-191: of 2 hp + 1
    const int kcol = ks < 6 ? ks * 16 : 128 + (ks - 6) * 16;
    vmt::ldsm_x4(bb, wch + (dn0 + vmt::bn_row_off(lane)) * kWP + kcol +
                         vmt::bn_col_off(lane));
    vmt::mma_bf16(d[0], a, bb[0], bb[1]);
    vmt::mma_bf16(d[1], a, bb[2], bb[3]);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int c = c0 + dn0 + nt * 8 + 2 * tq;
    float2* p0 = reinterpret_cast<float2*>(dys + (dm0 + gq) * kDYP + c);
    float2* p1 = reinterpret_cast<float2*>(dys + (dm0 + gq + 8) * kDYP + c);
    float2 u0 = *p0, u1 = *p1;
    u0.x += d[nt][0];
    u0.y += d[nt][1];
    u1.x += d[nt][2];
    u1.y += d[nt][3];
    *p0 = u0;
    *p1 = u1;
  }
}

// One 64-token tile (32 at C = 512) of a frame: the four head pairs in
// turn; y, dqkv and oh to HBM for the weight gradients' contraction.
template <int kC>
__global__ void __launch_bounds__(kC == 512 ? 128 : 256, kC == 64 ? 2 : 1)
    linear_bwd_dx_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const bf16* __restrict__ w_qkv, const bf16* __restrict__ w_outT,
    const bf16* __restrict__ g, const bf16* __restrict__ ctx_b,
    const bf16* __restrict__ dctx_b, const float* __restrict__ m,
    const float* __restrict__ zinv, const float* __restrict__ S,
    bf16* __restrict__ dx, float* __restrict__ part_dgamma,
    float* __restrict__ part_dob, bf16* __restrict__ y_out,
    bf16* __restrict__ dqkv_out, bf16* __restrict__ oh_out, int N,
    float inv_hw, float scale, int clip) {
  constexpr int kRG = row_groups<kC>(), kThr = threads_of<kC>(), kM = tile_rows<kC>();
  constexpr int kYP = kC + 8, kDYP = kC + 4, kW = 2 * kRG, kU = kC / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);  // [kM][kYP]
  bf16* gs = ys + kM * kYP;                       // [kM][kYP]
  bf16* ws = gs + kM * kYP;                       // [w_rows][kWP]
  bf16* dqs = ws + w_rows<kC>() * kWP;            // [kM][kDQP]
  bf16* ohs = dqs + kM * kDQP;                    // [kM][kOHP]
  bf16* cs = ohs + kM * kOHP;                     // [2][2][kD][kCtxP]
  float* dys = reinterpret_cast<float*>(cs + 4 * kD * kCtxP);  // [kM][kDYP]
  float* fs = dys + kM * kDYP;                    // [3][64]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int bf = blockIdx.y, n0 = blockIdx.x * kM;
  const int valid_rows = min(kM, N - n0);
  const int rg = warp % kRG, cg = warp / kRG, m0 = rg * 16;
  const bf16* xb = x + (size_t)bf * N * kC;
  const size_t row0 = (size_t)bf * N + n0;  // the tile's first row of BF x N

  load_rows<kC>(ys, xb, n0, N, t);
  load_rows<kC>(gs, g + (size_t)bf * N * kC, n0, N, t);
  for (int i = t; i < kM * kDYP; i += kThr) dys[i] = 0.f;
  for (int hp = 0; hp < kPairs; ++hp) {
    if (hp > 0) __syncthreads();  // the last pair's dy is done with ws, dqs, cs
    if constexpr (resident<kC>()) load_pair_w(ws, w_qkv, w_outT, hp, 0, kC, t, kThr);
    load_pair_frame(cs, fs, ctx_b, dctx_b, m, zinv, S, bf, hp, t, kThr);
    vmt::cp_async_commit();
    vmt::cp_async_wait<0>();
    __syncthreads();
    if (hp == 0) {
      ln_rows<kC>(ys, gamma, valid_rows, t);
      __syncthreads();
      for (int i = t; i < valid_rows * (kC / 8); i += kThr) {
        const int r = i / (kC / 8), o = (i % (kC / 8)) * 8;
        *reinterpret_cast<uint4*>(y_out + (row0 + r) * kC + o) =
            *reinterpret_cast<const uint4*>(ys + r * kYP + o);
      }
    }
    float acc[16][4];
    project<kC, 0, 16>(acc, ys, gs, ws, w_qkv, w_outT, hp, m0, cg, lane, t);
    head_grads(acc, cs, fs, dqs, ohs, cg, m0, valid_rows, lane, scale, inv_hw,
               clip);
    __syncthreads();  // the pair's dqkv and oh tiles visible
    // dqkv columns jl of the pair -> [q | k | v] x 256 of the row
    for (int i = t; i < valid_rows * (kDQ / 8); i += kThr) {
      const int r = i / (kDQ / 8), jl = (i % (kDQ / 8)) * 8;
      const int col = ((jl % 96) / kD) * kH + (2 * hp + jl / 96) * kD + jl % kD;
      *reinterpret_cast<uint4*>(dqkv_out + (row0 + r) * kQKV + col) =
          *reinterpret_cast<const uint4*>(dqs + r * kDQP + jl);
    }
    for (int i = t; i < valid_rows * 8; i += kThr) {
      const int r = i >> 3, o = (i & 7) * 8;
      *reinterpret_cast<uint4*>(oh_out + (row0 + r) * kH + hp * 64 + o) =
          *reinterpret_cast<const uint4*>(ohs + r * kOHP + o);
    }
    if constexpr (resident<kC>()) {
#pragma unroll
      for (int cc = 0; cc < kC / kKC; ++cc)
        dy_chunk<kC>(dys, dqs, ws + cc * kKC * kWP, cc * kKC, warp, lane);
    } else {
      ring_walk<kC>(ws, w_qkv, w_outT, hp, t, [&](int cc, const bf16* wch) {
        dy_chunk<kC>(dys, dqs, wch, cc * kKC, warp, lane);
      });
    }
  }
  __syncthreads();  // dy complete

  // LN backward, a warp a row (layer_norm_row's order for mu and rstd),
  // kRB rows of a warp at a time so that their x loads are in flight
  // together
  constexpr int kRB = kU <= 2 ? 4 : kU == 4 ? 2 : 1;
  float gam[kU], dgam[kU], dob[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    gam[u] = gamma[lane + 32 * u];
    dgam[u] = dob[u] = 0.f;
  }
  for (int rb = warp; rb < valid_rows; rb += kW * kRB) {
    float xv[kRB][kU];
#pragma unroll
    for (int b = 0; b < kRB; ++b) {
      const int r = rb + b * kW;
#pragma unroll
      for (int u = 0; u < kU; ++u)
        xv[b][u] = r < valid_rows ? bf2f(x[(row0 + r) * kC + lane + 32 * u]) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kRB; ++b) {
      const int r = rb + b * kW;  // the same for the whole warp
      if (r >= valid_rows) break;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) sum += xv[b][u];
      const float mu = vmt::warp_sum(sum) / kC;
      float sq = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float dv = xv[b][u] - mu;
        sq += dv * dv;
      }
      const float rstd = rsqrtf(vmt::warp_sum(sq) / kC + vmt::kLnEps);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = lane + 32 * u;
        const float xh = (xv[b][u] - mu) * rstd;
        const float dyv = dys[r * kDYP + c];
        dgam[u] = fmaf(xh, dyv, dgam[u]);
        dob[u] += bf2f(gs[r * kYP + c]);
        const float dxh = dyv * gam[u];
        xv[b][u] = xh;
        s1 += dxh;
        s2 = fmaf(dxh, xh, s2);
      }
      const float m1 = vmt::warp_sum(s1) / kC;
      const float m2 = vmt::warp_sum(s2) / kC;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = lane + 32 * u;
        const float dxh = dys[r * kDYP + c] * gam[u];
        dx[(row0 + r) * kC + c] = __float2bfloat16(
            bf2f(gs[r * kYP + c]) + rstd * (dxh - m1 - xv[b][u] * m2));
      }
    }
  }
  __syncthreads();  // dys free for the warps' partials
  float* red = dys;  // [kW][2][kC]
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    red[(warp * 2) * kC + lane + 32 * u] = dgam[u];
    red[(warp * 2 + 1) * kC + lane + 32 * u] = dob[u];
  }
  __syncthreads();
  const size_t blk = (size_t)bf * gridDim.x + blockIdx.x;
  for (int c = t; c < kC; c += kThr) {
    float sg = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      sg += red[(w * 2) * kC + c];
      sb += red[(w * 2 + 1) * kC + c];
    }
    part_dgamma[blk * kC + c] = sg;
    part_dob[blk * kC + c] = sb;
  }
}

// ---------------------------------------------------------------- host

int stats_chunks(int N) { return (N + kChunkTokens - 1) / kChunkTokens; }

int tile_count(int BF, int N, int C) {
  const int kM = C == 512 ? 32 : 64;
  return BF * ((N + kM - 1) / kM);
}

struct Work {
  vmt::OnlineStats st;
  float *S, *pdgam, *pdob, *ws_red;
  bf16 *y, *dqkv, *oh;  // the contraction's operands
  size_t bytes;
};

Work carve(void* base, int BF, int N, int C) {
  const size_t tiles = tile_count(BF, N, C), rows = (size_t)BF * N;
  size_t st[9];
  vmt::online_stats_sizes(BF, N, st);
  const size_t red = std::max({vmt::colsum_workspace(1, (int)tiles, C),
                               vmt::contract_workspace(1, (int)rows, C, kQKV),
                               vmt::contract_workspace(1, (int)rows, kH, C)});
  const size_t sz[7] = {(size_t)BF * kH * 4, tiles * C * 4, tiles * C * 4, red + 4,
                        rows * C * 2, rows * kQKV * 2, rows * kH * 2};
  char* p = static_cast<char*>(base);
  size_t off = 0;
  char* ptrs[16];
  for (int i = 0; i < 16; ++i) {
    ptrs[i] = p ? p + off : nullptr;
    off += vmt::align256(i < 9 ? st[i] : sz[i - 9]);
  }
  Work w{};
  float** fp[7] = {&w.st.pctx, &w.st.pdctx, &w.st.pz, &w.st.pm,
                   &w.st.ctxn, &w.st.m, &w.st.zinv};
  for (int i = 0; i < 7; ++i) *fp[i] = reinterpret_cast<float*>(ptrs[i]);
  w.st.ctx_b = reinterpret_cast<bf16*>(ptrs[7]);
  w.st.dctx_b = reinterpret_cast<bf16*>(ptrs[8]);
  float** rp[4] = {&w.S, &w.pdgam, &w.pdob, &w.ws_red};
  for (int i = 0; i < 4; ++i) *rp[i] = reinterpret_cast<float*>(ptrs[9 + i]);
  w.y = reinterpret_cast<bf16*>(ptrs[13]);
  w.dqkv = reinterpret_cast<bf16*>(ptrs[14]);
  w.oh = reinterpret_cast<bf16*>(ptrs[15]);
  w.bytes = off;
  return w;
}

template <int kC, bool kGrad>
cudaError_t stats_c(const bf16* x, const float* gamma, const bf16* w_qkv,
                    const bf16* w_outT, const bf16* g, const vmt::OnlineStats& s,
                    int BF, int N, float inv_hw, float scale, int clip,
                    cudaStream_t st) {
  constexpr size_t smem = stats_smem<kC>(kGrad);
  auto kern = linear_bwd_stats_kernel<kC, kGrad>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(stats_chunks(N), kPairs, BF), threads_of<kC>(), smem, st>>>(
      x, gamma, w_qkv, w_outT, g, s.pctx, kGrad ? s.pdctx : nullptr, s.pz, s.pm, N,
      inv_hw, scale, clip);
  return cudaGetLastError();
}

template <int kC>
cudaError_t launch(const void* x, const void* gamma, const void* w_qkv,
                   const void* w_outT, const void* ek, const void* ev,
                   const void* g, void* dx, void* dgamma, void* dw_qkv,
                   void* dw_out, void* dob, void* dek, void* dev,
                   void* workspace, int BF, int N, int Mc, float scale,
                   float inv_hw, int clip, cudaStream_t st) {
  const bf16* xb = static_cast<const bf16*>(x);
  const float* gm = static_cast<const float*>(gamma);
  const bf16* wq = static_cast<const bf16*>(w_qkv);
  const bf16* wo = static_cast<const bf16*>(w_outT);
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* ekb = static_cast<const bf16*>(ek);
  const bf16* evb = static_cast<const bf16*>(ev);
  const Work w = carve(workspace, BF, N, kC);
  constexpr int kM = tile_rows<kC>();
  const int n_tiles = (N + kM - 1) / kM;
  cudaError_t err;

  err = vmt::launch_online_stats(xb, gm, wq, wo, gb, ekb, evb, w.st, BF, N, kC,
                                 Mc, inv_hw, scale, clip, st);
  if (err != cudaSuccess) return err;
  linear_bwd_finish<<<BF, kH, 0, st>>>(w.st.ctxn, w.st.dctx_b, w.st.m, w.st.zinv,
                                       ekb, evb, w.S, static_cast<float*>(dek),
                                       static_cast<float*>(dev), Mc, inv_hw, clip);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  {
    constexpr size_t smem = dx_smem<kC>();
    auto kern = linear_bwd_dx_kernel<kC>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(n_tiles, BF), threads_of<kC>(), smem, st>>>(
        xb, gm, wq, wo, gb, w.st.ctx_b, w.st.dctx_b, w.st.m, w.st.zinv, w.S,
        static_cast<bf16*>(dx), w.pdgam, w.pdob, w.y, w.dqkv, w.oh, N, inv_hw,
        scale, clip);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int rows = BF * N;
  err = vmt::launch_contract(w.y, w.dqkv, static_cast<float*>(dw_qkv), 1, rows, kC,
                             kQKV, 0, 0, w.ws_red, st);
  if (err != cudaSuccess) return err;
  err = vmt::launch_contract(w.oh, gb, static_cast<float*>(dw_out), 1, rows, kH, kC,
                             0, 0, w.ws_red, st);
  if (err != cudaSuccess) return err;
  err = vmt::launch_colsum(w.pdgam, static_cast<float*>(dgamma), 1, BF * n_tiles,
                           kC, w.ws_red, st);
  if (err != cudaSuccess) return err;
  return vmt::launch_colsum(w.pdob, static_cast<float*>(dob), 1, BF * n_tiles, kC,
                            w.ws_red, st);
}

}  // namespace

namespace vmt {

void online_stats_sizes(int BF, int N, size_t (&bytes)[9]) {
  const size_t blks = (size_t)BF * stats_chunks(N);
  const size_t part = blks * kD * kH * 4, per = (size_t)BF * kH * kD;
  const size_t sz[9] = {part, part, blks * kH * 4, blks * kH * 4, per * 4,
                        (size_t)BF * kH * 4, (size_t)BF * kH * 4, per * 2,
                        per * 2};
  for (int i = 0; i < 9; ++i) bytes[i] = sz[i];
}

cudaError_t launch_online_stats(const __nv_bfloat16* x, const float* gamma,
                                const __nv_bfloat16* w_qkv,
                                const __nv_bfloat16* w_outT,
                                const __nv_bfloat16* g,
                                const __nv_bfloat16* ek,
                                const __nv_bfloat16* ev, const OnlineStats& s,
                                int BF, int N, int C, int Mc, float inv_hw,
                                float scale, int clip, cudaStream_t st) {
  const bool grad = g != nullptr;
  if (grad && w_outT == nullptr) return cudaErrorInvalidValue;
  cudaError_t err;
  switch (C) {
#define VMT_CASE(CC)                                                              \
  case CC:                                                                        \
    err = grad ? stats_c<CC, true>(x, gamma, w_qkv, w_outT, g, s, BF, N, inv_hw,  \
                                   scale, clip, st)                               \
               : stats_c<CC, false>(x, gamma, w_qkv, nullptr, nullptr, s, BF, N,  \
                                    inv_hw, scale, clip, st);                     \
    break;
    VMT_CASE(64)
    VMT_CASE(128)
    VMT_CASE(256)
    VMT_CASE(512)
#undef VMT_CASE
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  linear_bwd_merge<<<dim3(kD, BF), kH, 0, st>>>(
      s.pctx, grad ? s.pdctx : nullptr, s.pz, s.pm, ek, ev, s.ctxn, s.ctx_b,
      grad ? s.dctx_b : nullptr, s.m, s.zinv,
      stats_chunks(N), Mc, inv_hw, clip);
  return cudaGetLastError();
}

}  // namespace vmt

// Workspace bytes of vmt_linear_block_bwd for these sizes.
extern "C" size_t vmt_linear_block_bwd_workspace(int BF, int N, int C) {
  return carve(nullptr, BF, N, C).bytes;
}

// Dynamic shared memory of the backward's stages at C: 0 stats (with g),
// 1 dx, 2 stats without g (the head-layout forward's); 0 for a C the
// kernels do not take.
extern "C" size_t vmt_linear_block_bwd_smem(int C, int stage) {
#define VMT_CASE(CC)                                                           \
  case CC:                                                                     \
    return stage == 0 ? stats_smem<CC>(true) : stage == 1 ? dx_smem<CC>()      \
                      : stats_smem<CC>(false);
  switch (C) {
    VMT_CASE(64)
    VMT_CASE(128)
    VMT_CASE(256)
    VMT_CASE(512)
    default: return 0;
  }
#undef VMT_CASE
}

// w_outT: W_out^T (C, H) bf16. dek/dev: (BF, Mc, H) f32, or null when
// Mc == 0. clip = 1: the merged row (clamped k, dk and dek zero where
// |k| >= 60); clip = 0: per-head.
extern "C" int vmt_linear_block_bwd(
    const void* x, const void* gamma, const void* w_qkv, const void* w_outT,
    const void* ek, const void* ev, const void* g, void* dx, void* dgamma,
    void* dw_qkv, void* dw_out, void* dout_bias, void* dek, void* dev,
    void* workspace, int BF, int N, int C, int Mc, int heads, float scale,
    float inv_hw, int clip, void* stream) {
  if (heads != vmt::kHeads || BF <= 0 || N <= 0 || Mc < 0 ||
      (Mc > 0 && (ek == nullptr || ev == nullptr || dek == nullptr ||
                  dev == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VMT_CASE(CC)                                                         \
  case CC:                                                                   \
    return (int)launch<CC>(x, gamma, w_qkv, w_outT, ek, ev, g, dx, dgamma,   \
                           dw_qkv, dw_out, dout_bias, dek, dev, workspace,   \
                           BF, N, Mc, scale, inv_hw, clip, st);
  switch (C) {
    VMT_CASE(64)
    VMT_CASE(128)
    VMT_CASE(256)
    VMT_CASE(512)
    default: return (int)cudaErrorInvalidValue;
  }
#undef VMT_CASE
}
