// Fused spatial linear-attention block, forward, for sm_90a: a stats kernel
// and an apply kernel with two modes, merged and head layout.
//
// Replaces videometamaterials_tpu/ops/pallas/fused_linear_block.py:
//   _merged_stats_kernel (pallas_call in _run_kernel_merged) -> vmt_linear_stats
//   _merged_apply_kernel (pallas_call in _run_kernel_merged) -> vmt_linear_apply
//   _kernel, layout "head" (pallas_call in _run_kernel, which
//     VMT_LINEAR_LAYOUT=head selects) -> vmt_linear_head: the stats pass of
//     the linear backward (linear_stats.cuh, without g, unclamped) and the
//     apply kernel's head mode (below the merged notes)
//
// Per folded frame (b*f) over N tokens, heads = 8 of d = 32, hidden H = 256:
//   y    = bf16(LN(x) * gamma)                 two-pass, eps 1e-5
//   k    = y @ Wk,  v = bf16(y @ Wv / HW)      (v scaled BEFORE the cast)
//   pk   = exp(clip(k, -60, 60))               symmetric clamp: no max shift
//   z[a]       = sum_tok pk[a]                 (+ the cond tokens, once)
//   ctx[h,a,e] = sum_tok bf16(pk[h,a]) v[h,e]  (+ the cond tokens, once)
// and per token
//   q    = y @ Wq; e = exp(q - max_head(q)); s_h = sum_head(e)
//   qn   = bf16(e * (scale / s_h) * (1 / z))   per-head max shift (NaN guard)
//   oh   = bf16(qn_h @ bf16(ctx_h))            the eight per-head 32x32 blocks
//   out  = bf16(x + out_bias + oh @ Wout)
// Every product takes bf16 operands and sums in f32, as the JAX kernels'
// dot_generals do, so the tensor cores change only the order of the f32
// sums, never a rounding point.
//
// What bounds them on an H100, at the level-0 shape (2B*F = 22 frames,
// N = 9216, C = 64): stats reads x (26 MB) and does 2*22*9216*64*512 +
// 2*22*9216*8*32*32 = 16.6 GFLOP (17 us at 989 TFLOP/s bf16; the bytes
// take 7.8 us); apply reads x and writes out (52 MB, 15.5 us) and does
// 2*22*9216*(64*256 + 8*32*32 + 256*64) = 17.4 GFLOP (17.6 us). Both are
// bounded by operations at the tensor-core rate.
//
// Design: 256 threads a block, token tiles of kM = 64 rows, every product
// as mma.sync m16n8k16 (bf16 operands, fp32 sums; csrc/mma.cuh) from
// padded shared tiles.
//  - Both kernels: the x rows arrive by cp.async and LN runs in place,
//    eight threads a row (vmt::layer_norm_tile8, which sums in
//    layer_norm_row's order bit for bit); then one projection of 256
//    columns of w_qkv, y (64 x C) @ W (C x 256). Where they fit (apply at
//    C = 64, stats at C <= 128) all C x 256 weights are loaded once and
//    stay; above, 32-row chunks stream through a 3-stage cp.async ring.
//    Warp (rg, cg) owns rows 16 rg.. and columns 128 cg..: four n8 tiles
//    a head, so a row of a head lives in one quad of lanes.
//  - Stats, one block per (frame, token tile, head group of four): a warp's
//    128 columns are the k and the v of two heads, so every warp shares
//    the exp work, and each block streams half of W_k || W_v (the grid has
//    twice the blocks). pk and z come from the k fragments (z: the two
//    rows of a lane, xor shuffles over the quad's rows, then a per-warp
//    shared row; the four row groups in order at the end); bf16(pk) and v
//    go to a shared [token][256] tile, and ctx_h = bf16(pk_h)^T v_h
//    contracts over the 64 tokens as an mma whose A operand is read
//    transposed by ldmatrix .trans (warp w: head w / 2, context rows
//    16 (w % 2)..). A block walks its stats tile in sub-tiles of 64, the
//    next x rows arriving during this sub-tile's products, and keeps ctx
//    in its mma accumulators, then writes them to the partials scratch
//    (BF, tiles, d, H). The reduce runs a block per (context column,
//    frame), each thread summing the conditioning tokens once and then the
//    tiles in order, so two launches give the same bits (no atomics).
//  - Apply, one block per (frame, 64 tokens): q on the tensor cores; the
//    per-head softmax on the accumulator fragments (a quad shuffle for a
//    row's max and sum); qn repacked from accumulators straight into A
//    fragments and multiplied by the bf16 context block of its head
//    (16 x 32 x 32 a head); bf16(oh) goes to a shared tile over the spent
//    y rows, and oh @ Wout runs in blocks of 64 output columns (at C = 64
//    one block, loaded over the spent W_q during the softmax; above,
//    double buffered), with x, out_bias and the residual in the epilogue.
//  - C = 64, the full-resolution levels that take most of the time, fits
//    two blocks an SM in both kernels (88 and 92 KB of shared memory, at
//    most 128 registers a thread).
//
// The head layout (vmt_linear_head), per folded frame, unclamped and with
// the context normalised by the stats pass:
//   P      = softmax_tok([ek || k])            per feature, max-shifted
//   ctxn_h = P_h^T [ev || v]_h / HW            float32 (BF, heads, d, d)
//   Q      = scale softmax_head(q)             float32
//   out    = bf16(x + out_bias + sum_h (Q_h ctxn_h) W_out_h)
// The JAX head kernel keeps Q, ctxn and oh = Q ctxn in float32 and reads
// W_out (the bf16 weight) in float32. The head mode runs those two
// products on the tensor cores through the bf16 hi + lo split of
// temporal_tile.cuh (X = bf16(X) + bf16(X - bf16(X)), about 16 of f32's 24
// significant bits, f32 sums): oh = Q_hi c_hi + Q_hi c_lo + Q_lo c_hi
// (the lo x lo term is below 2^-16 of the product) and oh_hi W + oh_lo W
// (W holds bf16 values exactly). The stats pass rounds exp(k - m) and
// v / HW to bf16 before ctx (linear_stats.cuh); those and out are the
// head layout's only roundings besides the split's
// (tests/test_torch_port_linear_bwd_rounding.py models both against the
// JAX kernel). The apply's work at the level-0 shape (22, 9216, 64): reads
// x and writes out (52 MB, 15.5 us at 3.35 TB/s); the q projection 2 C H,
// Q ctxn 3 x 2 H d and the out-projection 2 x 2 H C a token (29.9
// GFLOP, 30 us at 989 TFLOP/s): bounded by operations. With the stats
// pass's QKV projection and ctx the whole forward is 46.5 GFLOP, 47 us.
//
// Head mode, the same tiles as the merged apply up to q; then per head the
// softmax on the fragments, Q split into hi and lo A fragments, against
// the context's hi and lo blocks (shared, bf16, [h][a][e]); oh stays in
// the warp's accumulators and is split into the out-projection's A
// fragments (hi and lo, 64 registers for the warp's four heads) without a
// shared tile. The out-projection is a split K over the hidden axis: warp
// (rg, cg) multiplies its heads' oh (hidden rows 128 cg..) by W_out for
// all 64 columns of a W_out block, writes the 32 columns its partner warp
// (rg, 1 - cg) stores into a shared f32 exchange tile (over the spent
// context blocks), and adds the partner's partial to its own 32 columns
// after one barrier (two terms: the same bits whichever warp adds them).
// Shared memory, bytes, at C = 64 / 128 / 256 / 512: 87,040 / 182,784 /
// 199,168 / 231,936 (the merged apply's 92,160 / ... / 212,480 less its
// oh tile and 1/z, plus the context's lo block); C = 64 fits two blocks an
// SM (<= 113 KB each).
#include <math_constants.h>

#include "linear_stats.cuh"
#include "temporal_tile.cuh"

namespace {

using vmt::kD;
using vmt::kH;
using vmt::kHeads;
using vmt::bf2f;
using vmt::round_bf16;

constexpr int kThreads = 256;
constexpr int kM = 64;            // tokens a tile: M of the projections
constexpr int kNP = 256;          // columns of one projection
constexpr int kBP = kNP + 8;      // padded pitch of the weight chunks, pkv, oh
constexpr int kKC = 32;           // weight rows per cp.async stage
constexpr int kStages = 3;
constexpr int kCtxP = kD + 8;     // padded pitch of apply's bf16 context
constexpr int kWN = 64;           // out-projection columns a W_out block
constexpr int kWP = kWN + 8;
constexpr int kGroupHeads = 4;    // heads a stats block
constexpr float kClamp = 60.f;
static_assert(kGroupHeads * kD * 2 == kNP, "a stats block projects k || v");

__device__ __forceinline__ float clamp_k(float k) {
  return fminf(fmaxf(k, -kClamp), kClamp);
}

// ---- weight staging and shared memory of the two kernels
//
// A kernel holds all of its C x 256 weight columns in shared memory at once
// ("resident": loaded once, no ring steps and no barrier between chunks)
// where they fit beside two blocks an SM or cost no occupancy: apply at
// C = 64, stats at C <= 128. Otherwise the chunks stream through a ring of
// kStages.

template <int kC>
__host__ __device__ constexpr bool apply_resident() {
  return kC / kKC <= 2;
}

template <int kC>
__host__ __device__ constexpr bool stats_resident() {
  return kC / kKC <= 4;
}

template <int kC>
__host__ __device__ constexpr int apply_w_chunks() {
  return apply_resident<kC>() ? kC / kKC : kStages;
}

template <int kC>
__host__ __device__ constexpr int stats_w_chunks() {
  return stats_resident<kC>() ? kC / kKC : kStages;
}

// apply's W_out blocks: one block (C = 64) lies over the spent W_q chunks,
// more are double-buffered beside them
template <int kC>
__host__ __device__ constexpr bool apply_wout_over_wq() {
  return kC / kWN == 1;
}

// apply's y tile; in the merged mode later its oh tile (the head mode keeps
// oh in registers)
template <int kC, bool kHead>
__host__ __device__ constexpr int apply_y_elems() {
  return kM * ((kC + 8) > kBP || kHead ? (kC + 8) : kBP);
}

// apply's W_q chunks (and, over them, W_out at C = 64)
template <int kC>
__host__ __device__ constexpr int apply_wq_elems() {
  const int wq = apply_w_chunks<kC>() * kKC * kBP;
  return apply_wout_over_wq<kC>() && kH * kWP > wq ? kH * kWP : wq;
}

template <int kC>
__host__ __device__ constexpr int apply_wout_elems() {
  return apply_wout_over_wq<kC>() ? 0 : 2 * kH * kWP;
}

// the bf16 context blocks [h][a][e]: bf16(ctx), or in the head mode the hi
// block and then the lo block
constexpr int kCtxElems = kHeads * kD * kCtxP;
// the head mode's exchange of out-projection partials, f32 [kM][kXP], over
// the spent context blocks
constexpr int kXP = kWN + 8;
static_assert(kM * kXP * 4 <= 2 * kCtxElems * 2, "exchange over the context");

template <int kC, bool kHead>
constexpr size_t apply_smem() {
  return ((size_t)apply_y_elems<kC, kHead>() + apply_wq_elems<kC>() +
          apply_wout_elems<kC>() + (size_t)(kHead ? 2 : 1) * kCtxElems) *
             2 +
         (kHead ? 0 : (size_t)kH * 4);
}

template <int kC>
constexpr size_t stats_smem() {
  return ((size_t)2 * kM * (kC + 8) + (size_t)stats_w_chunks<kC>() * kKC * kBP +
          (size_t)kM * kBP) *
             2 +
         (size_t)4 * (kNP / 2) * 4;
}

// ---- the shared building blocks

// rows k0..k0+31 of w_qkv (C, 3H) into a chunk [kKC][kBP]: chunk columns
// 64 s .. 64 s + 63 from w_qkv columns off_s ..; a thread copies the same
// 16 bytes of each row it takes (kThreads is a multiple of the 32 it
// takes a row)
__device__ __forceinline__ void load_w_chunk(__nv_bfloat16* dst,
                                             const __nv_bfloat16* w, int k0,
                                             int off0, int off1, int off2,
                                             int off3, int t) {
  const int j = (t & 31) * 8, s = j >> 6;
  const int col = (s == 0 ? off0 : s == 1 ? off1 : s == 2 ? off2 : off3) + (j & 63);
  for (int r = t >> 5; r < kKC; r += kThreads / 32)
    vmt::cp_async16(dst + r * kBP + j, w + (size_t)(k0 + r) * 3 * kH + col);
}

// the x rows n0..n0+63 of a frame into a [kM][kC + 8] tile; rows at or
// past n_end are zero-filled
template <int kC>
__device__ __forceinline__ void load_x_tile(__nv_bfloat16* dst,
                                            const __nv_bfloat16* xb, int n0,
                                            int n_end, int t) {
  constexpr int kYP = kC + 8;
  for (int i = t; i < kM * kC / 8; i += kThreads) {
    const int r = i / (kC / 8), o = (i % (kC / 8)) * 8;
    const bool valid = n0 + r < n_end;
    vmt::cp_async16(dst + r * kYP + o,
                    xb + (size_t)(valid ? n0 + r : 0) * kC + o, valid);
  }
}

// LN of the 64-row tile in place (32 rows a pass); rows >= valid_rows -> 0
template <int kC>
__device__ __forceinline__ void ln_tile(__nv_bfloat16* ys,
                                        const float* __restrict__ gamma,
                                        int valid_rows, int t) {
  constexpr int kYP = kC + 8;
  vmt::layer_norm_tile8<kC>(ys, kYP, gamma, valid_rows, t);
  vmt::layer_norm_tile8<kC>(ys + 32 * kYP, kYP, gamma, valid_rows - 32, t);
}

// acc += y[m0..m0+15][kc0..kc0+31] @ chunk[0..31][n0..n0+127]
template <int kYP>
__device__ __forceinline__ void project_chunk(float (&acc)[16][4],
                                              const __nv_bfloat16* ys,
                                              const __nv_bfloat16* wsl,
                                              int kc0, int m0, int n0,
                                              int lane) {
#pragma unroll
  for (int ks = 0; ks < kKC / 16; ++ks) {
    uint32_t a[4];
    vmt::ldsm_x4(a, ys + (m0 + vmt::a_row_off(lane)) * kYP + kc0 + ks * 16 +
                        vmt::a_col_off(lane));
    const __nv_bfloat16* wrow =
        wsl + (ks * 16 + vmt::bk_row_off(lane)) * kBP + n0 + vmt::bk_col_off(lane);
#pragma unroll
    for (int n = 0; n < 16; n += 2) {
      uint32_t bb[4];
      vmt::ldsm_x4_t(bb, wrow + n * 8);
      vmt::mma_bf16(acc[n], a, bb[0], bb[1]);
      vmt::mma_bf16(acc[n + 1], a, bb[2], bb[3]);
    }
  }
}

// ---- stats: per (token tile, head group, frame) partial ctx and z

template <int kC>
__global__ void __launch_bounds__(kThreads, kC == 64 ? 2 : 1) linear_stats_partial(
    const __nv_bfloat16* __restrict__ x,      // (BF, N, C)
    const float* __restrict__ gamma,          // (C)
    const __nv_bfloat16* __restrict__ w_qkv,  // (C, 3H)
    float* __restrict__ part_ctx,             // (BF, tiles, d, H)
    float* __restrict__ part_z,               // (BF, tiles, H)
    int N, int tile, float inv_hw) {
  constexpr int kYP = kC + 8;
  constexpr int kNKC = kC / kKC;
  constexpr bool kRes = stats_resident<kC>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kM][kYP]
  __nv_bfloat16* ws = ys + 2 * kM * kYP;            // [chunks][kKC][kBP]
  __nv_bfloat16* pkv = ws + stats_w_chunks<kC>() * kKC * kBP;  // [kM][kBP]
  float* zs = reinterpret_cast<float*>(pkv + kM * kBP);  // [4 row groups][128]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int hg = blockIdx.y, bf = blockIdx.z;
  const int n_begin = blockIdx.x * tile;
  const int n_end = min(N, n_begin + tile);
  const int n_sub = (n_end - n_begin + kM - 1) / kM;
  const int nq = n_sub * kNKC;
  const __nv_bfloat16* xb = x + (size_t)bf * N * kC;
  // chunk columns: k of the group's heads 0-1, their v, k of heads 2-3,
  // their v; warp (rg, cg) projects rows 16 rg.. onto columns 128 cg..:
  // n8 tiles 0-7 the k, 8-15 the v of heads 2 cg and 2 cg + 1
  const int koff = kH + hg * (kNP / 2), voff = 2 * kH + hg * (kNP / 2);
  const int rg = warp & 3, cg = warp >> 2, m0 = rg * 16;
  // context: head hh of the group, context rows am0..am0+15
  const int hh = warp >> 1, am0 = (warp & 1) * 16;
  // chunk q of the walk over sub-tiles: rows (q % kNKC) * 32 of the weights
  auto load_chunk = [&](int q) {
    load_w_chunk(ws + (kRes ? q : q % kStages) * kKC * kBP, w_qkv,
                 (q % kNKC) * kKC, koff, voff, koff + 64, voff + 64, t);
  };

  // cp.async groups. Resident: (x of sub-tile 0 + every chunk), then one a
  // sub-tile with the next sub-tile's x. Ring: (x of sub-tile 0 + chunk 0),
  // (chunk 1), ..., then one a ring step, holding the chunk kStages - 1
  // ahead and, on a sub-tile's first step, the x rows of the next sub-tile
  load_x_tile<kC>(ys, xb, n_begin, n_end, t);
  if (kRes) {
#pragma unroll
    for (int q = 0; q < kNKC; ++q) load_chunk(q);
    vmt::cp_async_commit();
  } else {
#pragma unroll
    for (int q = 0; q < kStages - 1; ++q) {
      if (q < nq) load_chunk(q);
      vmt::cp_async_commit();
    }
  }
  for (int i = t; i < 4 * (kNP / 2); i += kThreads) zs[i] = 0.f;

  float cacc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) cacc[n][0] = cacc[n][1] = cacc[n][2] = cacc[n][3] = 0.f;
  int q = 0;
  for (int s = 0; s < n_sub; ++s) {
    const int ns = n_begin + s * kM;
    const int valid_rows = n_end - ns;
    __nv_bfloat16* yt = ys + (s & 1) * kM * kYP;
    float acc[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if (kRes) {
      vmt::cp_async_wait<0>();
      __syncthreads();  // x of sub-tile s visible; the last sub-tile's
                        // readers of pkv and of the other y buffer done
      if (s + 1 < n_sub) {
        load_x_tile<kC>(ys + ((s + 1) & 1) * kM * kYP, xb, ns + kM, n_end, t);
        vmt::cp_async_commit();
      }
      ln_tile<kC>(yt, gamma, valid_rows, t);
      __syncthreads();  // the y tile visible
#pragma unroll
      for (int kc = 0; kc < kNKC; ++kc)
        project_chunk<kYP>(acc, yt, ws + kc * kKC * kBP, kc * kKC, m0,
                           cg * (kNP / 2), lane);
    } else {
      if (s == 0) vmt::cp_async_wait<kStages - 2>();
      else vmt::cp_async_wait<kNKC - 1>();
      __syncthreads();  // x of sub-tile s visible
      ln_tile<kC>(yt, gamma, valid_rows, t);
      for (int kc = 0; kc < kNKC; ++kc, ++q) {
        vmt::cp_async_wait<kStages - 2>();
        __syncthreads();  // chunk q and the y tile visible; slot q-1 free
        if (q + kStages - 1 < nq) load_chunk(q + kStages - 1);
        if (kc == 0 && s + 1 < n_sub)
          load_x_tile<kC>(ys + ((s + 1) & 1) * kM * kYP, xb, ns + kM, n_end, t);
        vmt::cp_async_commit();
        project_chunk<kYP>(acc, yt, ws + (q % kStages) * kKC * kBP, kc * kKC,
                           m0, cg * (kNP / 2), lane);
      }
    }

    // pk and z from the k fragments, v from the v fragments; rows past the
    // tile's end count nothing. pkv: [token][pk of heads 0-3 || v of 0-3]
    const bool v0 = m0 + g < valid_rows, v1 = m0 + g + 8 < valid_rows;
    __nv_bfloat16* prow0 = pkv + (m0 + g) * kBP + cg * 64 + 2 * tq;
    __nv_bfloat16* prow1 = prow0 + 8 * kBP;
    float* zrow = zs + rg * (kNP / 2) + cg * 64 + 2 * tq;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = v0 ? expf(clamp_k(acc[n][0])) : 0.f;
      const float p1 = v0 ? expf(clamp_k(acc[n][1])) : 0.f;
      const float p2 = v1 ? expf(clamp_k(acc[n][2])) : 0.f;
      const float p3 = v1 ? expf(clamp_k(acc[n][3])) : 0.f;
      float z0 = p0 + p2, z1 = p1 + p3;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        z0 += __shfl_xor_sync(0xffffffffu, z0, o);
        z1 += __shfl_xor_sync(0xffffffffu, z1, o);
      }
      if (g == 0) {
        zrow[n * 8] += z0;
        zrow[n * 8 + 1] += z1;
      }
      *reinterpret_cast<uint32_t*>(prow0 + n * 8) = vmt::pack_bf16x2(p0, p1);
      *reinterpret_cast<uint32_t*>(prow1 + n * 8) = vmt::pack_bf16x2(p2, p3);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float (&v)[4] = acc[8 + n];
      *reinterpret_cast<uint32_t*>(prow0 + kNP / 2 + n * 8) = vmt::pack_bf16x2(
          v0 ? v[0] * inv_hw : 0.f, v0 ? v[1] * inv_hw : 0.f);
      *reinterpret_cast<uint32_t*>(prow1 + kNP / 2 + n * 8) = vmt::pack_bf16x2(
          v1 ? v[2] * inv_hw : 0.f, v1 ? v[3] * inv_hw : 0.f);
    }
    __syncthreads();  // pkv and this sub-tile's z rows visible

    // ctx_h[a][e] += sum_tok bf16(pk)[tok][a] v[tok][e]: A = pk^T read
    // transposed from the [token][a] tile
    const __nv_bfloat16* pkh = pkv + hh * kD + am0;
    const __nv_bfloat16* vh = pkv + kNP / 2 + hh * kD;
#pragma unroll
    for (int ks = 0; ks < kM / 16; ++ks) {
      uint32_t a[4];
      vmt::ldsm_x4_t(a, pkh + (ks * 16 + vmt::at_row_off(lane)) * kBP +
                            vmt::at_col_off(lane));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bb[4];
        vmt::ldsm_x4_t(bb, vh + (ks * 16 + vmt::bk_row_off(lane)) * kBP +
                               np * 16 + vmt::bk_col_off(lane));
        vmt::mma_bf16(cacc[2 * np], a, bb[0], bb[1]);
        vmt::mma_bf16(cacc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
  }

  // partials: ctx[e][h * 32 + a] of this tile; z of the group's columns,
  // the four row groups in order (zs is complete: its last writes precede
  // the last sub-tile's barrier)
  const size_t pidx = (size_t)bf * gridDim.x + blockIdx.x;
  float* pc = part_ctx + pidx * kD * kH + (hg * kGroupHeads + hh) * kD + am0 + g;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int e = n * 8 + 2 * tq;
    pc[e * kH] = cacc[n][0];
    pc[(e + 1) * kH] = cacc[n][1];
    pc[e * kH + 8] = cacc[n][2];
    pc[(e + 1) * kH + 8] = cacc[n][3];
  }
  if (t < kNP / 2)
    part_z[pidx * kH + hg * (kNP / 2) + t] =
        ((zs[t] + zs[kNP / 2 + t]) + zs[kNP + t]) + zs[3 * (kNP / 2) + t];
}

// The ordered sum of a frame's partials, one block per (context column e,
// frame): thread t takes context row t (head t / 32, feature t % 32) and,
// in the blocks of column 0, z[t]; the conditioning tokens first, once
// (the TPU kernel's tile-0 init), then the tiles in order.
__global__ void __launch_bounds__(kThreads) linear_stats_reduce(
    const float* __restrict__ part_ctx, const float* __restrict__ part_z,
    const __nv_bfloat16* __restrict__ ek,     // (BF, Mc, H) or null
    const __nv_bfloat16* __restrict__ ev,     // (BF, Mc, H) or null
    float* __restrict__ ctx_out,              // (BF, heads, d, d)
    float* __restrict__ z_out,                // (BF, H)
    int n_tiles, int Mc, float inv_hw) {
  const int t = threadIdx.x;
  const int h = t >> 5;
  const int e = blockIdx.x, bf = blockIdx.y;
  float c = 0.f, z = 0.f;
  for (int m = 0; m < Mc; ++m) {
    const size_t row = ((size_t)bf * Mc + m) * kH;
    const float pkc = expf(clamp_k(bf2f(ek[row + t])));
    z += pkc;
    c = fmaf(round_bf16(pkc), round_bf16(bf2f(ev[row + h * kD + e]) * inv_hw), c);
  }
  const float* pc = part_ctx + (size_t)bf * n_tiles * kD * kH + e * kH + t;
  const float* pz = part_z + (size_t)bf * n_tiles * kH + t;
#pragma unroll 4
  for (int tile = 0; tile < n_tiles; ++tile) {
    c += pc[(size_t)tile * kD * kH];
    if (e == 0) z += pz[(size_t)tile * kH];
  }
  ctx_out[((size_t)bf * kH + t) * kD + e] = c;
  if (e == 0) z_out[(size_t)bf * kH + t] = z;
}

// ---- apply: per (64 tokens, frame)

// the per-head softmax's exp on the q fragments of head hh, in place (a
// row of the head is one quad, so its max and sum take two shuffles);
// r0, r1: scale / the sums of the lane's two rows
__device__ __forceinline__ void head_exp(float (&acc)[16][4], int hh,
                                         float scale, float& r0, float& r1) {
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float (&q)[4] = acc[hh * 4 + n];
    mx0 = fmaxf(mx0, fmaxf(q[0], q[1]));
    mx1 = fmaxf(mx1, fmaxf(q[2], q[3]));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float (&e)[4] = acc[hh * 4 + n];
    e[0] = expf(e[0] - mx0);
    e[1] = expf(e[1] - mx0);
    e[2] = expf(e[2] - mx1);
    e[3] = expf(e[3] - mx1);
    s0 += e[0] + e[1];
    s1 += e[2] + e[3];
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  r0 = scale / s0;
  r1 = scale / s1;
}

// The head mode's partial out-projection of a warp: d (16 rows x 32
// columns) = oh W over the warp's 128 hidden rows, oh as its hi and lo A
// fragments oa[head][k-step][hi, lo]; wb: the W_out block's row of the
// warp's first hidden row, col0 the first of the 32 columns
__device__ __forceinline__ void head_out_partial(
    float (&d)[4][4], const uint32_t (&oa)[4][2][2][4],
    const __nv_bfloat16* wb, int col0, int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
#pragma unroll
  for (int hh = 0; hh < 4; ++hh)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bb[4];
        vmt::ldsm_x4_t(bb, wb + (hh * kD + ks * 16 + vmt::bk_row_off(lane)) * kWP +
                               col0 + np * 16 + vmt::bk_col_off(lane));
#pragma unroll
        for (int lo = 0; lo < 2; ++lo) {
          vmt::mma_bf16(d[2 * np], oa[hh][ks][lo], bb[0], bb[1]);
          vmt::mma_bf16(d[2 * np + 1], oa[hh][ks][lo], bb[2], bb[3]);
        }
      }
}

// kHead false: the merged apply (ctx unnormalised, z its sums). kHead
// true: the head layout's apply (ctx the stats pass's normalised ctxn, z
// unused), every product past q f32-exact to the hi + lo split
template <int kC, bool kHead>
__global__ void __launch_bounds__(kThreads, kC == 64 ? 2 : 1) linear_apply_kernel(
    const __nv_bfloat16* __restrict__ x,      // (BF, N, C)
    const float* __restrict__ gamma,          // (C)
    const __nv_bfloat16* __restrict__ w_qkv,  // (C, 3H)
    const __nv_bfloat16* __restrict__ w_out,  // (H, C)
    const float* __restrict__ out_bias,       // (C)
    const float* __restrict__ ctx,            // (BF, heads, d, d)
    const float* __restrict__ z,              // (BF, H)
    __nv_bfloat16* __restrict__ out,          // (BF, N, C)
    int N, float scale) {
  constexpr int kYP = kC + 8;
  constexpr int kNKC = kC / kKC;
  constexpr int kS = apply_w_chunks<kC>();
  constexpr bool kRes = apply_resident<kC>();
  constexpr bool kOver = apply_wout_over_wq<kC>();
  constexpr int kNB = kC / kWN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kM][kYP]
  __nv_bfloat16* oh = ys;                            // [kM][kBP], over spent y
  __nv_bfloat16* ws = ys + apply_y_elems<kC, kHead>();  // [kS][kKC][kBP]
  __nv_bfloat16* wo = kOver ? ws : ws + apply_wq_elems<kC>();  // [bufs][kH][kWP]
  __nv_bfloat16* cs = ws + apply_wq_elems<kC>() + apply_wout_elems<kC>();
  float* inv_z = reinterpret_cast<float*>(cs + kCtxElems);  // [kH]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bf = blockIdx.y;
  const int n0 = blockIdx.x * kM;
  const int valid_rows = min(kM, N - n0);
  const __nv_bfloat16* xb = x + (size_t)bf * N * kC;
  // rows 16 rg.., heads 4 cg..4 cg + 3 (q columns 128 cg..)
  const int rg = warp & 3, cg = warp >> 2, m0 = rg * 16;

  // W_out[:, 64 nb .. 64 nb + 63] into buffer nb % 2
  auto load_wout = [&](int nb) {
    __nv_bfloat16* dst = wo + (nb & 1) * kH * kWP;
    for (int i = t; i < kH * kWN / 8; i += kThreads) {
      const int k = i >> 3, o = (i & 7) * 8;
      vmt::cp_async16(dst + k * kWP + o, w_out + (size_t)k * kC + nb * kWN + o);
    }
  };

  // cp.async groups. Resident: (x + every W_q chunk). Ring: (x + chunk 0),
  // (chunk 1), ..., one a ring step, the last one bringing W_out block 0
  load_x_tile<kC>(ys, xb, n0, N, t);
  if (kRes) {
#pragma unroll
    for (int q = 0; q < kNKC; ++q)
      load_w_chunk(ws + q * kKC * kBP, w_qkv, q * kKC, 0, 64, 128, 192, t);
    vmt::cp_async_commit();
  } else {
#pragma unroll
    for (int q = 0; q < kS - 1; ++q) {
      load_w_chunk(ws + q * kKC * kBP, w_qkv, q * kKC, 0, 64, 128, 192, t);
      vmt::cp_async_commit();
    }
  }
  // this frame's bf16 context blocks ([h][a][e], all loads in flight at
  // once) and 1/z; the head mode: the hi blocks, then the lo blocks
  {
    const float4* cf = reinterpret_cast<const float4*>(
        ctx + (size_t)bf * kHeads * kD * kD);
    constexpr int kU = kHeads * kD * kD / 4 / kThreads;
    float4 cv[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) cv[u] = cf[t + u * kThreads];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = (t + u * kThreads) * 4;
      *reinterpret_cast<uint2*>(cs + (i >> 5) * kCtxP + (i & 31)) =
          make_uint2(vmt::pack_bf16x2(cv[u].x, cv[u].y),
                     vmt::pack_bf16x2(cv[u].z, cv[u].w));
      if (kHead) {
        const float4 v = cv[u];
        *reinterpret_cast<uint2*>(cs + kCtxElems + (i >> 5) * kCtxP + (i & 31)) =
            make_uint2(vmt::pack_bf16x2(v.x - round_bf16(v.x), v.y - round_bf16(v.y)),
                       vmt::pack_bf16x2(v.z - round_bf16(v.z), v.w - round_bf16(v.w)));
      }
    }
  }
  if (!kHead) inv_z[t] = 1.f / z[(size_t)bf * kH + t];

  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  if (kRes) {
    vmt::cp_async_wait<0>();
    __syncthreads();  // x and W_q visible
    ln_tile<kC>(ys, gamma, valid_rows, t);
    __syncthreads();  // the y tile visible
#pragma unroll
    for (int kc = 0; kc < kNKC; ++kc)
      project_chunk<kYP>(acc, ys, ws + kc * kKC * kBP, kc * kKC, m0,
                         cg * (kNP / 2), lane);
  } else {
    vmt::cp_async_wait<kS - 2>();
    __syncthreads();  // x visible
    ln_tile<kC>(ys, gamma, valid_rows, t);
    for (int kc = 0; kc < kNKC; ++kc) {
      vmt::cp_async_wait<kS - 2>();
      __syncthreads();  // chunk kc and the y tile visible; slot kc-1 free
      const int qn = kc + kS - 1;
      if (qn < kNKC)
        load_w_chunk(ws + (qn % kS) * kKC * kBP, w_qkv, qn * kKC, 0, 64, 128, 192, t);
      if (!kOver && kc == kNKC - 1) load_wout(0);
      vmt::cp_async_commit();
      project_chunk<kYP>(acc, ys, ws + (kc % kS) * kKC * kBP, kc * kKC, m0,
                         cg * (kNP / 2), lane);
    }
  }
  __syncthreads();  // every warp is done with y and W_q (the merged mode's
                    // oh goes over y's rows)
  if (kOver) {
    load_wout(0);  // over the spent W_q chunks, during the softmax
    vmt::cp_async_commit();
  }

  if constexpr (kHead) {
    // per head: Q = scale softmax_head(q), oh = Q ctxn as Q_hi c_hi +
    // Q_hi c_lo + Q_lo c_hi, kept as the out-projection's A fragments
    uint32_t oa[kGroupHeads][2][2][4];  // [head][k-step][hi, lo]
#pragma unroll
    for (int hh = 0; hh < kGroupHeads; ++hh) {
      const int h = cg * kGroupHeads + hh;
      float r0, r1;
      head_exp(acc, hh, scale, r0, r1);
      float qf[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        qf[n][0] = acc[hh * 4 + n][0] * r0;
        qf[n][1] = acc[hh * 4 + n][1] * r0;
        qf[n][2] = acc[hh * 4 + n][2] * r1;
        qf[n][3] = acc[hh * 4 + n][3] * r1;
      }
      float o[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
      const __nv_bfloat16* cb = cs + h * kD * kCtxP;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t qh[4], ql[4];
        vmt::frag_a<false>(qh, qf, ks);
        vmt::frag_a<true>(ql, qf, ks);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int off = (ks * 16 + vmt::bk_row_off(lane)) * kCtxP + np * 16 +
                          vmt::bk_col_off(lane);
          uint32_t bh[4], bl[4];
          vmt::ldsm_x4_t(bh, cb + off);
          vmt::ldsm_x4_t(bl, cb + kCtxElems + off);
          vmt::mma_bf16(o[2 * np], qh, bh[0], bh[1]);
          vmt::mma_bf16(o[2 * np + 1], qh, bh[2], bh[3]);
          vmt::mma_bf16(o[2 * np], qh, bl[0], bl[1]);
          vmt::mma_bf16(o[2 * np + 1], qh, bl[2], bl[3]);
          vmt::mma_bf16(o[2 * np], ql, bh[0], bh[1]);
          vmt::mma_bf16(o[2 * np + 1], ql, bh[2], bh[3]);
        }
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        vmt::frag_a<false>(oa[hh][ks][0], o, ks);
        vmt::frag_a<true>(oa[hh][ks][1], o, ks);
      }
    }

    // out = bf16(x + out_bias + oh W_out), 64 columns a block: warp (rg,
    // cg) the split K over its hidden rows 128 cg.. for all 64 columns;
    // the partner's 32 columns (32 (1 - cg)..) through the exchange tile,
    // its own (32 cg..) kept and stored
    float* xch = reinterpret_cast<float*>(cs);  // [kM][kXP]
    const int own = cg * 32, other = 32 - own;
    for (int nb = 0; nb < kNB; ++nb) {
      vmt::cp_async_wait<0>();
      __syncthreads();  // W_out block nb visible; the other buffer, the
                        // context blocks (nb = 0) and the exchange free
      if (nb + 1 < kNB) load_wout(nb + 1);
      vmt::cp_async_commit();
      const __nv_bfloat16* wb = wo + (nb & 1) * kH * kWP + cg * 128 * kWP;
      float d[4][4];
      head_out_partial(d, oa, wb, other, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = other + n * 8 + 2 * tq;
        *reinterpret_cast<float2*>(xch + (m0 + g) * kXP + c) = make_float2(d[n][0], d[n][1]);
        *reinterpret_cast<float2*>(xch + (m0 + g + 8) * kXP + c) =
            make_float2(d[n][2], d[n][3]);
      }
      head_out_partial(d, oa, wb, own, lane);
      __syncthreads();  // the partners' partials visible
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half;
        if (r >= valid_rows) continue;
        const size_t row = ((size_t)bf * N + n0 + r) * kC;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int cl = own + n * 8 + 2 * tq, c = nb * kWN + cl;
          const float2 p = *reinterpret_cast<const float2*>(xch + r * kXP + cl);
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + row + c);
          const float2 bv = *reinterpret_cast<const float2*>(out_bias + c);
          *reinterpret_cast<uint32_t*>(out + row + c) = vmt::pack_bf16x2(
              __low2float(xv) + bv.x + (d[n][2 * half] + p.x),
              __high2float(xv) + bv.y + (d[n][2 * half + 1] + p.y));
        }
      }
    }
  } else {
    // per head: the feature softmax on the fragments (a row of the head is
    // one quad), qn straight into A fragments, oh = qn_h @ bf16(ctx_h)
#pragma unroll
    for (int hh = 0; hh < kGroupHeads; ++hh) {
      const int h = cg * kGroupHeads + hh;
      float r0, r1;
      head_exp(acc, hh, scale, r0, r1);
      // qn = bf16(e * (scale / s_h) * (1 / z)); the A fragment of k-step kk
      // is n8 tiles 2 kk (a0, a1) and 2 kk + 1 (a2, a3)
      uint32_t af[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float (&e)[4] = acc[hh * 4 + n];
        const int col = h * kD + n * 8 + 2 * tq;
        const float iz0 = inv_z[col], iz1 = inv_z[col + 1];
        af[n >> 1][(n & 1) * 2] = vmt::pack_bf16x2(e[0] * r0 * iz0, e[1] * r0 * iz1);
        af[n >> 1][(n & 1) * 2 + 1] = vmt::pack_bf16x2(e[2] * r1 * iz0, e[3] * r1 * iz1);
      }
      float o[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
      const __nv_bfloat16* cb = cs + h * kD * kCtxP;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bb[4];
          vmt::ldsm_x4_t(bb, cb + (ks * 16 + vmt::bk_row_off(lane)) * kCtxP +
                                 np * 16 + vmt::bk_col_off(lane));
          vmt::mma_bf16(o[2 * np], af[ks], bb[0], bb[1]);
          vmt::mma_bf16(o[2 * np + 1], af[ks], bb[2], bb[3]);
        }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = h * kD + n * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(oh + (m0 + g) * kBP + col) =
            vmt::pack_bf16x2(o[n][0], o[n][1]);
        *reinterpret_cast<uint32_t*>(oh + (m0 + g + 8) * kBP + col) =
            vmt::pack_bf16x2(o[n][2], o[n][3]);
      }
    }

    // out = bf16(x + out_bias + oh @ W_out), 64 columns a block: warp (rg,
    // cg) rows 16 rg.., columns 32 cg.. of the block
    const int wn0 = cg * 32;
    for (int nb = 0; nb < kNB; ++nb) {
      vmt::cp_async_wait<0>();
      __syncthreads();  // W_out block nb and oh visible; the other buffer free
      if (nb + 1 < kNB) load_wout(nb + 1);
      vmt::cp_async_commit();
      const __nv_bfloat16* wb = wo + (nb & 1) * kH * kWP;
      float d[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
#pragma unroll 4
      for (int ks = 0; ks < kH / 16; ++ks) {
        uint32_t a[4];
        vmt::ldsm_x4(a, oh + (m0 + vmt::a_row_off(lane)) * kBP + ks * 16 +
                            vmt::a_col_off(lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bb[4];
          vmt::ldsm_x4_t(bb, wb + (ks * 16 + vmt::bk_row_off(lane)) * kWP + wn0 +
                                 np * 16 + vmt::bk_col_off(lane));
          vmt::mma_bf16(d[2 * np], a, bb[0], bb[1]);
          vmt::mma_bf16(d[2 * np + 1], a, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half;
        if (r >= valid_rows) continue;
        const size_t row = ((size_t)bf * N + n0 + r) * kC;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = nb * kWN + wn0 + n * 8 + 2 * tq;
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + row + c);
          const float2 bv = *reinterpret_cast<const float2*>(out_bias + c);
          *reinterpret_cast<uint32_t*>(out + row + c) = vmt::pack_bf16x2(
              __low2float(xv) + bv.x + d[n][2 * half],
              __high2float(xv) + bv.y + d[n][2 * half + 1]);
        }
      }
    }
  }
}

template <int kC>
cudaError_t stats_c(const void* x, const void* gamma, const void* w_qkv,
                    const void* ek, const void* ev, void* part_ctx,
                    void* part_z, void* ctx, void* z, int BF, int N, int Mc,
                    int tile, float inv_hw, cudaStream_t stream) {
  const int n_tiles = (N + tile - 1) / tile;
  constexpr size_t smem = stats_smem<kC>();
  auto kern = linear_stats_partial<kC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_tiles, kHeads / kGroupHeads, BF), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const __nv_bfloat16*>(w_qkv), static_cast<float*>(part_ctx),
      static_cast<float*>(part_z), N, tile, inv_hw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  linear_stats_reduce<<<dim3(kD, BF), kThreads, 0, stream>>>(
      static_cast<const float*>(part_ctx), static_cast<const float*>(part_z),
      static_cast<const __nv_bfloat16*>(ek),
      static_cast<const __nv_bfloat16*>(ev), static_cast<float*>(ctx),
      static_cast<float*>(z), n_tiles, Mc, inv_hw);
  return cudaGetLastError();
}

template <int kC, bool kHead>
cudaError_t apply_c(const void* x, const void* gamma, const void* w_qkv,
                    const void* w_out, const void* out_bias, const void* ctx,
                    const void* z, void* out, int BF, int N, float scale,
                    cudaStream_t stream) {
  constexpr size_t smem = apply_smem<kC, kHead>();
  auto kern = linear_apply_kernel<kC, kHead>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((N + kM - 1) / kM, BF), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const __nv_bfloat16*>(w_qkv),
      static_cast<const __nv_bfloat16*>(w_out),
      static_cast<const float*>(out_bias), static_cast<const float*>(ctx),
      static_cast<const float*>(z), static_cast<__nv_bfloat16*>(out), N, scale);
  return cudaGetLastError();
}

template <bool kHead>
cudaError_t apply_any_c(const void* x, const void* gamma, const void* w_qkv,
                        const void* w_out, const void* out_bias,
                        const void* ctx, const void* z, void* out, int BF,
                        int N, int C, float scale, cudaStream_t stream) {
  switch (C) {
    case 64: return apply_c<64, kHead>(x, gamma, w_qkv, w_out, out_bias, ctx, z, out, BF, N, scale, stream);
    case 128: return apply_c<128, kHead>(x, gamma, w_qkv, w_out, out_bias, ctx, z, out, BF, N, scale, stream);
    case 256: return apply_c<256, kHead>(x, gamma, w_qkv, w_out, out_bias, ctx, z, out, BF, N, scale, stream);
    case 512: return apply_c<512, kHead>(x, gamma, w_qkv, w_out, out_bias, ctx, z, out, BF, N, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the head layout's stats buffers carved from one workspace
vmt::OnlineStats carve(void* base, int BF, int N, size_t* total) {
  size_t bytes[9];
  vmt::online_stats_sizes(BF, N, bytes);
  char* ptrs[9];
  size_t off = 0;
  for (int i = 0; i < 9; ++i) {
    ptrs[i] = base ? static_cast<char*>(base) + off : nullptr;
    off += (bytes[i] + 255) & ~(size_t)255;
  }
  if (total) *total = off;
  vmt::OnlineStats s;
  float** fp[7] = {&s.pctx, &s.pdctx, &s.pz, &s.pm, &s.ctxn, &s.m, &s.zinv};
  for (int i = 0; i < 7; ++i) *fp[i] = reinterpret_cast<float*>(ptrs[i]);
  s.ctx_b = reinterpret_cast<__nv_bfloat16*>(ptrs[7]);
  s.dctx_b = reinterpret_cast<__nv_bfloat16*>(ptrs[8]);
  return s;
}

}  // namespace

// tile: tokens a stats block, a multiple of 64 (walked in sub-tiles of 64)
extern "C" int vmt_linear_stats(const void* x, const void* gamma,
                                const void* w_qkv, const void* ek,
                                const void* ev, void* part_ctx, void* part_z,
                                void* ctx, void* z, int BF, int N, int C,
                                int Mc, int heads, int tile, float inv_hw,
                                void* stream) {
  if (heads != kHeads || N <= 0 || tile <= 0 || tile % kM || Mc < 0 ||
      (Mc > 0 && (ek == nullptr || ev == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: return (int)stats_c<64>(x, gamma, w_qkv, ek, ev, part_ctx, part_z, ctx, z, BF, N, Mc, tile, inv_hw, st);
    case 128: return (int)stats_c<128>(x, gamma, w_qkv, ek, ev, part_ctx, part_z, ctx, z, BF, N, Mc, tile, inv_hw, st);
    case 256: return (int)stats_c<256>(x, gamma, w_qkv, ek, ev, part_ctx, part_z, ctx, z, BF, N, Mc, tile, inv_hw, st);
    case 512: return (int)stats_c<512>(x, gamma, w_qkv, ek, ev, part_ctx, part_z, ctx, z, BF, N, Mc, tile, inv_hw, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// tile: tokens an apply block, 64
extern "C" int vmt_linear_apply(const void* x, const void* gamma,
                                const void* w_qkv, const void* w_out,
                                const void* out_bias, const void* ctx,
                                const void* z, void* out, int BF, int N, int C,
                                int heads, int tile, float scale,
                                void* stream) {
  if (heads != kHeads || N <= 0 || tile != kM) return (int)cudaErrorInvalidValue;
  return (int)apply_any_c<false>(x, gamma, w_qkv, w_out, out_bias, ctx, z, out,
                                 BF, N, C, scale,
                                 static_cast<cudaStream_t>(stream));
}

// Workspace bytes of vmt_linear_head for these sizes.
extern "C" size_t vmt_linear_head_workspace(int BF, int N) {
  size_t total = 0;
  carve(nullptr, BF, N, &total);
  return total;
}

// The head layout: the stats pass (unclamped, normalised ctx) and the
// apply's head mode. ek/ev: (BF, Mc, H) bf16, or null when Mc == 0.
// apply_tile: tokens an apply block, 64.
extern "C" int vmt_linear_head(const void* x, const void* gamma,
                               const void* w_qkv, const void* w_out,
                               const void* out_bias, const void* ek,
                               const void* ev, void* out, void* workspace,
                               int BF, int N, int C, int Mc, int heads,
                               int apply_tile, float scale, float inv_hw,
                               void* stream) {
  if (heads != kHeads || BF <= 0 || N <= 0 || apply_tile != kM || Mc < 0 ||
      (Mc > 0 && (ek == nullptr || ev == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (C != 64 && C != 128 && C != 256 && C != 512)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const vmt::OnlineStats s = carve(workspace, BF, N, nullptr);
  cudaError_t err = vmt::launch_online_stats(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const __nv_bfloat16*>(w_qkv), nullptr, nullptr,
      static_cast<const __nv_bfloat16*>(ek),
      static_cast<const __nv_bfloat16*>(ev), s, BF, N, C, Mc, inv_hw,
      /*scale=*/1.f, /*clip=*/0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)apply_any_c<true>(x, gamma, w_qkv, w_out, out_bias, s.ctxn,
                                nullptr, out, BF, N, C, scale, st);
}

// Dynamic shared memory of the stats (stage 0), apply (stage 1) and
// head-layout apply (stage 2) kernels at C; 0 for a C the kernels do not
// take.
extern "C" size_t vmt_linear_block_fwd_smem(int C, int stage) {
#define VMT_CASE(CC)                                     \
  case CC:                                               \
    return stage == 0   ? stats_smem<CC>()               \
           : stage == 1 ? apply_smem<CC, false>()        \
                        : apply_smem<CC, true>();
  switch (C) {
    VMT_CASE(64)
    VMT_CASE(128)
    VMT_CASE(256)
    VMT_CASE(512)
    default: return 0;
  }
#undef VMT_CASE
}
