// The any-shape instance of the temporal block's backward (row 3), for
// sm_90a.
//
// Replaces, at every shape the TPU kernels take outside the specialised
// instances' set (F = 11 frames, 8 heads of 32, C in {64, 128, 256, 512},
// at most 69 conditioning tokens):
//   videometamaterials_tpu/ops/pallas/fused_temporal_block.py:_bwd_kernel
//     (pallas_call in _run_bwd_kernel)                 -> vmt_temporal_block_bwd_any
// (row 2, the emit_p forward, is any_shape.cu's forward with p set; rows 6
// and 7, the linear backward, are any_linear_bwd.cu; row 8, the
// head-layout linear forward, is any_linear_head.cu). The specialised
// instance (fused_temporal_block_bwd.cu with reduce.cu's contraction)
// keeps its shapes; the wrapper picks an instance from the shape alone.
//
// Every size is a launch argument: frames F, positions S (tokens N),
// channels C, heads and head width d (hidden H = heads * d), conditioning
// tokens T. The cotangents and their layouts are the specialised kernel's
// (see its note): dx bf16, dgamma, dw_all (F, C, 3H), dw_out (H, C), dbias
// (F, F+T, heads), dek/dev (B, 2, T, H), all f32.
// Roundings, where fused_temporal_block_bwd.cu rounds: y, q, k, v and the
// value weights p in bf16 (as the forward), g_acc = g W_out^T in bf16,
// dqkv in bf16 for the weight sums and dy, the softmax and every sum in
// f32 (ds enters its tensor-core products as bf16 hi + lo, about 16
// significant bits, as in the specialised backward); dp = g_acc . v is
// rounded to bf16 as the plain twin's autograd rounds it.
//
// What bounds it on an H100: the same work as the specialised instance
// (chip_smoke.py prints each launch's bound): the projections, dy and the
// weight sums, operations at 989 TFLOP/s bf16 at the training shapes.
//
// Design: simple and right at any shape, no float atomics (two launches
// give the same bits), the partial sums added in a fixed order.
//  - ln_rows_kernel and any_gemm_kernel (any_shape.cuh): y, the QKV
//    projection, g W_out^T, dy = dqkv W^T (the wrapper hands the weights
//    transposed).
//  - temporal_any_bwd_attn_kernel (on the tensor cores, any_attn.cuh): a
//    block a (64 positions, head, batch row) stages the head's token rows
//    and bias once, its warps (up to four, as shared memory allows) taking
//    the positions in turn, their q, k, v and g_acc rows by cp.async; per
//    position three passes of mma.sync over the key chunks of 32 (F
//    frames, then T tokens), the query frames as m16 tiles: the softmax's
//    max and sum; p, bf16(p) for the value sum acc (kept for dw_out) and
//    D = sum_j p dp; then ds = p (dp - D), dq = ds k, dk = ds^T q (ds as
//    bf16 hi + lo, two products each, as the specialised backward) and dv
//    = bf16(p)^T g_acc; where one chunk holds every key and d <= 64 the
//    three passes share the scores of the first. A frame key's dk, dv go
//    to the bf16 dqkv scratch with dq; up to kTokInline tokens a token
//    key's are added to the warp's dek / dev rows, and ds to its dbias
//    table, over its positions; the block adds its warps in order and
//    writes one partial, and an ordered reduce sums the partials.
//  - temporal_any_bwd_tok_kernel, above kTokInline tokens (T-sized sums a
//    warp would hold the attention backward's occupancy down): a block a
//    (64 positions, head, chunk of 32 tokens) recomputes the chunk's p, dp
//    and ds from each query row's m, l, D (saved by the attention
//    backward) and sums dek = ds^T q, dev = bf16(p)^T g_acc over its
//    positions in registers on the tensor cores; the same partials.
//  - ln_bwd_kernel: dx = g + the LN backward of dy, and per-block partials
//    of dgamma, summed in order by reduce.cu's column sums.
//  - the weight gradients dW = A^T B over the rows (any_contract.cuh).
#include <math_constants.h>

#include <algorithm>

#include "any_attn.cuh"
#include "any_contract.cuh"

namespace {

// ---- LayerNorm backward: dx = g + LN'(dy), partials of dgamma

constexpr int kLnbWarps = 8;
constexpr int kLnbRows = 64;  // rows a block, 8 a warp

// x, g, dx (rows, C) bf16; dy (rows, C) f32; part_dgamma (blocks, C):
// each block's sums over its rows, its warps added in order
__global__ void __launch_bounds__(kLnbWarps * 32) ln_bwd_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ dy, const bf16* __restrict__ g,
    bf16* __restrict__ dx, float* __restrict__ part_dgamma, size_t rows,
    int C) {
  extern __shared__ float smem_f[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* dgw = smem_f + (size_t)warp * C;                  // [warp][C]
  for (int c = lane; c < C; c += 32) dgw[c] = 0.f;
  const size_t r0 = (size_t)blockIdx.x * kLnbRows;
  for (int k = warp; k < kLnbRows; k += kLnbWarps) {
    const size_t row = r0 + k;
    if (row >= rows) break;
    const bf16* xr = x + row * C;
    const float* dyr = dy + row * C;
    const bf16* gr = g + row * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += bf2f(xr[c]);
    const float mu = vmt::warp_sum(s) / C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dv = bf2f(xr[c]) - mu;
      q += dv * dv;
    }
    const float rstd = rsqrtf(vmt::warp_sum(q) / C + vmt::kLnEps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xh = (bf2f(xr[c]) - mu) * rstd;
      const float gd = dyr[c] * gamma[c];
      s1 += gd;
      s2 += gd * xh;
      dgw[c] += xh * dyr[c];
    }
    const float m1 = vmt::warp_sum(s1) / C, m2 = vmt::warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
      const float xh = (bf2f(xr[c]) - mu) * rstd;
      const float gd = dyr[c] * gamma[c];
      dx[row * C + c] =
          __float2bfloat16(bf2f(gr[c]) + rstd * (gd - m1 - xh * m2));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kLnbWarps * 32) {
    float a = 0.f;
    for (int w = 0; w < kLnbWarps; ++w) a += smem_f[(size_t)w * C + c];
    part_dgamma[(size_t)blockIdx.x * C + c] = a;
  }
}

size_t ln_bwd_blocks(size_t rows) { return (rows + kLnbRows - 1) / kLnbRows; }

size_t ln_bwd_smem(int C) { return (size_t)kLnbWarps * C * sizeof(float); }

cudaError_t launch_ln_bwd(const bf16* x, const float* gamma, const float* dy,
                          const bf16* g, bf16* dx, float* part_dgamma,
                          size_t rows, int C, cudaStream_t st) {
  const size_t smem = ln_bwd_smem(C);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ln_bwd_kernel<<<(unsigned)ln_bwd_blocks(rows), kLnbWarps * 32, smem, st>>>(
      x, gamma, dy, g, dx, part_dgamma, rows, C);
  return cudaGetLastError();
}

// ---- temporal attention backward on the tensor cores (any_attn.cuh)

constexpr int kTP = 64;          // positions a block
constexpr int kTWarps = 4;       // warps a block at most
// conditioning tokens up to which a warp of the attention backward sums
// the token keys' dk, dv itself (one key chunk of them); above, its shared
// memory would hold its occupancy down, and temporal_any_bwd_tok_kernel
// takes them
constexpr int kTokInline = 32;

// shared memory of a warp, bytes: two buffers of a position's q, k, v and
// g_acc rows of the head (4 x F x pitch bf16 each: the next position's
// arrive during this one's products), the transpose scratch (two 16 x
// kAttnScrP bf16 tiles), its dbias table (F x accp(F + T) f32, over its
// positions), with more than 16 frames (the query tiles add into them)
// the frame keys' dk, dv (2 x F x accp(d) f32) and, with T <=
// kTokInline, the token sums dek, dev (2 x T x accp(d) f32, over its
// positions). The block's own follow (attn_block_bytes).
__host__ __device__ inline size_t bwd_rows_bytes(int F, int d) {
  return (size_t)4 * F * attn_pitch(d) * 2;
}
__host__ __device__ inline size_t bwd_dbias_off(int F, int d) {
  return 2 * bwd_rows_bytes(F, d) + (size_t)2 * 16 * kAttnScrP * 2;
}
__host__ __device__ inline size_t bwd_fk_off(int F, int T, int d) {
  return bwd_dbias_off(F, d) + attn_align16((size_t)F * attn_accp(F + T) * 4);
}
__host__ __device__ inline size_t bwd_tok_off(int F, int T, int d) {
  return bwd_fk_off(F, T, d) +
         (F > 16 ? (size_t)2 * F * attn_accp(d) * 4 : 0);
}
__host__ __device__ inline size_t bwd_warp_bytes(int F, int T, int d) {
  return bwd_tok_off(F, T, d) +
         (T <= kTokInline ? (size_t)2 * T * attn_accp(d) * 4 : 0);
}

int bwd_warps(int F, int T, int d) {
  const size_t base = attn_block_bytes(F, T, d), per = bwd_warp_bytes(F, T, d);
  if (base + per > kMaxSmem) return 0;
  const size_t w = (kMaxSmem - base) / per;
  return w >= kTWarps ? kTWarps : (int)w;
}

struct TemporalBwd {
  const bf16* qkv;      // (B, F, S, 3H)
  const bf16* ga;       // (B, F, S, H): g @ w_out^T
  const bf16* ek;       // (B, T, H) or null
  const bf16* ev;
  const float* bias;    // (F, F + T, heads)
  bf16* acc;            // (B, F, S, H): the value sums, for dw_out
  bf16* dqkv;           // (B, F, S, 3H)
  float* part_bias;     // (B, heads, blocks, F, F + T)
  float* part_tok;      // (B, heads, blocks, 2, T, d)
  float* mld;           // (B, heads, S, F, 3): each query row's m, l, D,
                        // with T > kTokInline; else null
  int B, F, S, T, heads, d;
};

// A block a (kTP positions, head, batch row), its warps taking the
// positions in turn. Per position and query tile three passes of mma.sync
// over the key chunks: (1) the scores, each row's running max and sum;
// (2) the scores again, p from the final max and sum, acc = bf16(sum
// bf16(p) v) and, with the first feature chunk, D = sum_j p dp with dp =
// bf16(g_acc . v); (3) p and dp again, ds = p (dp - D), dq = ds k, dk =
// ds^T q (ds split into bf16(ds) + its rounding error, two products each)
// and dv = bf16(p)^T g_acc. A frame key's dk, dv go to the bf16 dqkv
// scratch with dq; up to kTokInline tokens a token key's are added to the
// warp's dek / dev rows, above them each query row's m, l and D go to mld
// for temporal_any_bwd_tok_kernel; ds is added to the warp's dbias table
// over its positions. The block adds its warps in order and writes one
// partial. kFC: features of an output chunk (32, or 64 with d > 32, the
// scores again for each chunk).
template <int kFC>
__global__ void __launch_bounds__(kTWarps * 32, 1) temporal_any_bwd_attn_kernel(
    const TemporalBwd a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kNT = kFC / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int blk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int F = a.F, T = a.T, G = F + T, d = a.d, H = a.heads * d;
  const int dp = attn_dp(d), pitch = dp + 8, ksteps = dp / 16;
  const int nqt = attn_fq(F) / 16, ap = attn_accp(d), gp = attn_accp(G);
  // one query tile: a frame key's dk, dv are whole after it and go
  // straight to dqkv; more: they add up in the warp's f32 rows first
  const bool direct = nqt == 1;
  const size_t per = bwd_warp_bytes(F, T, d);
  unsigned char* wbase = smem_raw + warp * per;
  bf16* frs = reinterpret_cast<bf16*>(wbase);         // two of [4][F][pitch]
  const size_t rows_elems = bwd_rows_bytes(F, d) / sizeof(bf16);
  bf16* scr = frs + 2 * rows_elems;                    // [2][16][kAttnScrP]
  float* dbw = reinterpret_cast<float*>(wbase + bwd_dbias_off(F, d));  // [F][gp]
  float* fkw = reinterpret_cast<float*>(wbase + bwd_fk_off(F, T, d));  // [2][F][ap]
  float* tokw = reinterpret_cast<float*>(wbase + bwd_tok_off(F, T, d));  // [2][T][ap]
  const bool tok_in = a.mld == nullptr;  // the token keys' dk, dv here
  bf16* tok = reinterpret_cast<bf16*>(smem_raw + warps * per);
  bf16* zrow = tok + (size_t)2 * T * pitch;
  float* bias_h = reinterpret_cast<float*>(zrow + pitch);      // [F][G]
  attn_stage_block(smem_raw, warps * per + attn_block_bytes(F, T, d), tok,
                   bias_h, a.ek, a.ev, a.bias, b, F, T, H, h, a.heads, d,
                   pitch);
  const int gq = lane >> 2, tq = lane & 3;
  const int s_begin = blk * kTP, s_end = min(a.S, s_begin + kTP);

  if (s_begin + warp < s_end)
    attn_load_rows(frs, a.qkv, a.ga, 4, 3, b, F, a.S, s_begin + warp, H, h,
                    d, pitch, lane);
  for (int s = s_begin + warp, buf = 0; s < s_end; s += warps, buf ^= 1) {
    const bool ahead = s + warps < s_end;
    if (ahead)
      attn_load_rows(frs + (buf ^ 1) * rows_elems, a.qkv, a.ga, 4, 3, b, F,
                      a.S, s + warps, H, h, d, pitch, lane);
    attn_wait_rows(ahead);
    const AttnRows rows{frs + buf * rows_elems, tok, zrow, F, T, pitch};
    if (!direct) {
      for (int i = lane; i < 2 * F * ap; i += 32) fkw[i] = 0.f;
      __syncwarp();
    }
    const size_t row0 = (size_t)b * F * a.S + s;  // row (b, f, s): row0 + f S
    // part 1 (dk) or 2 (dv) of a transposed chunk (keys j0.., features
    // c0..c0 + 15): a frame key's to dqkv or its f32 row, a token key's
    // added to the warp's token sums (with tok_in)
    auto put_keys = [&](const float (&t)[2][2][4], int part, int j0, int c0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = j0 + mt * 16 + gq + 8 * half;
          if (j >= (tok_in ? G : F)) continue;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int f = c0 + nt * 8 + 2 * tq + e;
              if (f >= d) continue;
              const float v = t[mt][nt][2 * half + e];
              if (j >= F)
                tokw[((size_t)(part - 1) * T + j - F) * ap + f] += v;
              else if (direct)
                a.dqkv[(row0 + (size_t)j * a.S) * 3 * H + part * H + h * d +
                       f] = __float2bfloat16(v);
              else
                fkw[((size_t)(part - 1) * F + j) * ap + f] += v;
            }
        }
    };
    for (int qt = 0; qt < nqt; ++qt) {
      const int i0 = qt * 16;
      auto qrow = [&](int i) { return rows.frame(i0 + i, 0); };
      auto grow = [&](int i) { return rows.frame(i0 + i, 3); };
      auto krow = [&](int j0) {
        return [&rows, j0](int j) { return rows.key(j0 + j, 1); };
      };
      auto vrow = [&](int j0) {
        return [&rows, j0](int j) { return rows.key(j0 + j, 2); };
      };
      // acc (the value sums, for dw_out) of a feature chunk to its scratch
      auto store_acc = [&](const float (&acc)[kNT][4], int f0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + gq + 8 * half;
          if (i >= F) continue;
          bf16* orow = a.acc + (row0 + (size_t)i * a.S) * H + h * d;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int f = f0 + nt * 8 + 2 * tq + e;
              if (f < d) orow[f] = __float2bfloat16(acc[nt][2 * half + e]);
            }
        }
      };
      // a chunk's (keys j0..) gradients from ds and bf16(p), features
      // f0..: dbias += ds (with the first feature chunk), dq += ds k, dk =
      // ds^T q and dv = bf16(p)^T g_acc (16 features at a time)
      auto grads = [&](const float (&pr)[4][4], const float (&ds)[4][4],
                       float (&dq)[kNT][4], int j0, int f0, int npairs) {
        if (f0 == 0) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = i0 + gq + 8 * half;
            if (i >= F) continue;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int j = j0 + nt * 8 + 2 * tq + e;
                if (j < G) dbw[i * gp + j] += ds[nt][2 * half + e];
              }
          }
        }
        attn_mma_frag<true, kNT>(dq, ds, krow(j0), f0, npairs, lane);
        if (j0 >= F && !tok_in) return;  // no key of this kernel's
        attn_stage_t<true>(scr, ds, lane);
        for (int c0 = f0; c0 < f0 + kFC && c0 < dp; c0 += 16) {
          float t[2][2][4] = {};
          attn_mma_t<true>(t, scr, qrow, c0, lane);
          put_keys(t, 1, j0, c0);
        }
        attn_stage_t<false>(scr, pr, lane);
        for (int c0 = f0; c0 < f0 + kFC && c0 < dp; c0 += 16) {
          float t[2][2][4] = {};
          attn_mma_t<false>(t, scr, grow, c0, lane);
          put_keys(t, 2, j0, c0);
        }
      };
      // each query row's m, l, D for the token keys' kernel
      auto store_mld = [&](const float (&m)[2], const float (&l)[2],
                           const float (&D)[2]) {
        if (a.mld == nullptr || tq != 0) return;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + gq + 8 * half;
          if (i >= F) continue;
          float* o = a.mld + ((((size_t)b * a.heads + h) * a.S + s) * F + i) * 3;
          o[0] = m[half];
          o[1] = l[half];
          o[2] = D[half];
        }
      };
      auto store_dq = [&](const float (&dq)[kNT][4], int f0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + gq + 8 * half;
          if (i >= F) continue;
          bf16* drow = a.dqkv + (row0 + (size_t)i * a.S) * 3 * H + h * d;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int f = f0 + nt * 8 + 2 * tq + e;
              if (f < d) drow[f] = __float2bfloat16(dq[nt][2 * half + e]);
            }
        }
      };
      // ds = p (dp - D) in place of dp, and p to bf16(p) in place
      auto dsoft = [&](float (&pr)[4][4], float (&ds)[4][4],
                       const float (&D)[2]) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& dv = ds[nt][2 * half + e];
              float& p = pr[nt][2 * half + e];
              dv = p * (round_bf16(dv) - D[half]);
              p = round_bf16(p);
            }
      };
      // D += sum_j p dp over a chunk, dp = bf16(g_acc . v)
      auto dsum = [&](const float (&pr)[4][4], const float (&dpv)[4][4],
                      float (&D)[2]) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              D[half] = fmaf(pr[nt][2 * half + e],
                             round_bf16(dpv[nt][2 * half + e]), D[half]);
      };
      auto quad_sum = [](float (&D)[2]) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          D[half] += __shfl_xor_sync(0xffffffffu, D[half], 1);
          D[half] += __shfl_xor_sync(0xffffffffu, D[half], 2);
        }
      };
      // pass 1: each query row's running max and sum
      float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
      float pr[4][4];
      for (int j0 = 0; j0 < G; j0 += kAttnKeys) {
        attn_scores(pr, qrow, krow(j0), ksteps, lane);
        attn_bias_mask(pr, bias_h, i0, j0, F, G, lane);
        attn_online(pr, m, l);
      }
      if (G <= kAttnKeys && dp <= kFC) {
        // one key chunk and one feature chunk: passes 2 and 3 on the
        // scores of pass 1
        float ds[4][4], D[2] = {0.f, 0.f};
        attn_probs(pr, m, l);
        attn_scores(ds, grow, vrow(0), ksteps, lane);
        dsum(pr, ds, D);
        quad_sum(D);
        store_mld(m, l, D);
        dsoft(pr, ds, D);
        {
          float acc[kNT][4] = {};
          attn_mma_frag<false, kNT>(acc, pr, vrow(0), 0, dp / 16, lane);
          store_acc(acc, 0);
        }
        float dq[kNT][4] = {};
        grads(pr, ds, dq, 0, 0, dp / 16);
        store_dq(dq, 0);
        continue;
      }
      // pass 2: the value sums acc a feature chunk at a time, and with the
      // first chunk D = sum_j p dp
      float D[2] = {0.f, 0.f};
      for (int f0 = 0; f0 < dp; f0 += kFC) {
        const int npairs = min(kFC, dp - f0) / 16;
        float acc[kNT][4] = {};
        for (int j0 = 0; j0 < G; j0 += kAttnKeys) {
          attn_scores(pr, qrow, krow(j0), ksteps, lane);
          attn_bias_mask(pr, bias_h, i0, j0, F, G, lane);
          attn_probs(pr, m, l);
          if (f0 == 0) {
            float dpv[4][4];
            attn_scores(dpv, grow, vrow(j0), ksteps, lane);
            dsum(pr, dpv, D);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) pr[nt][e] = round_bf16(pr[nt][e]);
          attn_mma_frag<false, kNT>(acc, pr, vrow(j0), f0, npairs, lane);
        }
        store_acc(acc, f0);
      }
      quad_sum(D);
      store_mld(m, l, D);
      // pass 3: ds = p (dp - D); dq = ds k; dk = ds^T q; dv = bf16(p)^T
      // g_acc; with the first feature chunk dbias += ds
      for (int f0 = 0; f0 < dp; f0 += kFC) {
        const int npairs = min(kFC, dp - f0) / 16;
        float dq[kNT][4] = {};
        for (int j0 = 0; j0 < G; j0 += kAttnKeys) {
          float ds[4][4];
          attn_scores(pr, qrow, krow(j0), ksteps, lane);
          attn_bias_mask(pr, bias_h, i0, j0, F, G, lane);
          attn_probs(pr, m, l);
          attn_scores(ds, grow, vrow(j0), ksteps, lane);
          dsoft(pr, ds, D);
          grads(pr, ds, dq, j0, f0, npairs);
        }
        store_dq(dq, f0);
      }
    }
    if (!direct) {
      __syncwarp();
      for (int i = lane; i < 2 * F * d; i += 32) {
        const int f = i % d, j = (i / d) % F, part = 1 + i / (d * F);
        a.dqkv[(row0 + (size_t)j * a.S) * 3 * H + part * H + h * d + f] =
            __float2bfloat16(fkw[((size_t)(part - 1) * F + j) * ap + f]);
      }
    }
    __syncwarp();  // this buffer's reads are done before it is refilled
  }
  __syncthreads();
  // the block's partials: its warps' sums, in order
  const size_t pidx = ((size_t)b * a.heads + h) * gridDim.x + blk;
  float* pbias = a.part_bias + pidx * F * G;
  const size_t dboff = bwd_dbias_off(F, d) / sizeof(float);
  const float* wf = reinterpret_cast<const float*>(smem_raw);
  const size_t wper = per / sizeof(float);
  for (int i = threadIdx.x; i < F * G; i += blockDim.x) {
    const size_t o = dboff + (size_t)(i / G) * gp + i % G;
    float v = 0.f;
    for (int w = 0; w < warps; ++w) v += wf[w * wper + o];
    pbias[i] = v;
  }
  if (tok_in && T > 0) {
    const size_t tkoff = bwd_tok_off(F, T, d) / sizeof(float);
    float* ptok = a.part_tok + pidx * 2 * T * d;
    for (int i = threadIdx.x; i < 2 * T * d; i += blockDim.x) {
      const int which = i / (T * d), tt = (i / d) % T, e = i % d;
      const size_t o = tkoff + ((size_t)which * T + tt) * ap + e;
      float v = 0.f;
      for (int w = 0; w < warps; ++w) v += wf[w * wper + o];
      ptok[i] = v;
    }
  }
}

// ---- the token keys' dk, dv (dek, dev): a kernel of their own, so the
// attention backward keeps no T-sized sums a warp and its occupancy does
// not fall with T

constexpr int kTokWarps = 4;

// shared memory, bytes: a warp's two buffers of a position's q and g_acc
// rows (2 x F x pitch bf16 each) and its transpose scratch; the block's 32
// token rows of ek and of ev and a zero row (bf16), the bias of its token
// columns (F x 32 f32), and the warps' sums for their ordered reduction
// (warps x 2 x 32 x (kFC + 8) f32)
__host__ __device__ inline size_t tok_warp_bytes(int F, int d) {
  return (size_t)2 * 2 * F * attn_pitch(d) * 2 + (size_t)2 * 16 * kAttnScrP * 2;
}
__host__ __device__ inline size_t tok_block_bytes(int F, int d, int warps,
                                                  int fc) {
  return (size_t)65 * attn_pitch(d) * 2 + (size_t)F * 32 * 4 +
         (size_t)warps * 2 * 32 * (fc + 8) * 4;
}
int tok_fc(int d) { return d <= 32 ? 32 : 64; }

int tok_warps(int F, int d) {
  for (int w = kTokWarps; w > 0; --w)
    if (w * tok_warp_bytes(F, d) + tok_block_bytes(F, d, w, tok_fc(d)) <=
        kMaxSmem)
      return w;
  return 0;
}

// A block a (kTP positions, head, chunk of 32 tokens, batch row), its
// warps taking the positions in turn, as the attention backward's blocks.
// Per position and query tile, from each query row's m, l and D (mld):
// the scores of the chunk's token keys, p = exp(s - m) / l, dp =
// bf16(g_acc . v), ds = p (dp - D); dek += ds^T q (ds as bf16 hi + lo) and
// dev += bf16(p)^T g_acc on the tensor cores, summed over the warp's
// positions in registers, 16 features a group, kFC features a pass over
// the positions. The block adds its warps in order and writes its rows of
// the partial part_tok (the attention backward's layout).
template <int kFC>
__global__ void __launch_bounds__(kTokWarps * 32, 1) temporal_any_bwd_tok_kernel(
    const TemporalBwd a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kGroups = kFC / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int tchunks = (a.T + kAttnKeys - 1) / kAttnKeys;
  const int blk = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / tchunks, t0 = (blockIdx.z % tchunks) * kAttnKeys;
  const int F = a.F, T = a.T, G = F + T, d = a.d, H = a.heads * d;
  const int dp = attn_dp(d), pitch = dp + 8, ksteps = dp / 16;
  const int nqt = attn_fq(F) / 16, nt_tok = min(kAttnKeys, T - t0);
  const size_t per = tok_warp_bytes(F, d);
  const size_t rows_elems = (size_t)2 * F * pitch;
  bf16* frs = reinterpret_cast<bf16*>(smem_raw + warp * per);  // two [2][F][pitch]
  bf16* scr = frs + 2 * rows_elems;
  bf16* tk = reinterpret_cast<bf16*>(smem_raw + warps * per);  // [32][pitch]
  bf16* tv = tk + kAttnKeys * pitch;
  bf16* zrow = tv + kAttnKeys * pitch;
  float* bias_t = reinterpret_cast<float*>(zrow + pitch);      // [F][32]
  float* red = bias_t + F * kAttnKeys;          // [warps][2][32][kFC + 8]
  const int t = threadIdx.x;
  const size_t bytes = warps * per + tok_block_bytes(F, d, warps, kFC);
  for (size_t i = t; i < bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int i = t; i < 2 * nt_tok * d; i += blockDim.x) {
    const int e = i % d, r = (i / d) % nt_tok, p = i / (d * nt_tok);
    const size_t src = ((size_t)b * T + t0 + r) * H + h * d + e;
    (p ? tv : tk)[r * pitch + e] = (p ? a.ev : a.ek)[src];
  }
  for (int i = t; i < F * kAttnKeys; i += blockDim.x) {
    const int r = i / kAttnKeys, j = i % kAttnKeys;
    if (j < nt_tok)
      bias_t[i] = a.bias[((size_t)r * G + F + t0 + j) * a.heads + h];
  }
  __syncthreads();
  const int gq = lane >> 2, tq = lane & 3;
  const int s_begin = blk * kTP, s_end = min(a.S, s_begin + kTP);
  auto krow = [&](int j) { return tk + j * pitch; };
  auto vrow = [&](int j) { return tv + j * pitch; };

  for (int f0 = 0; f0 < dp; f0 += kFC) {
    float sk[kGroups][2][2][4] = {}, sv[kGroups][2][2][4] = {};
    if (s_begin + warp < s_end)
      attn_load_rows(frs, a.qkv, a.ga, 2, 1, b, F, a.S, s_begin + warp, H,
                      h, d, pitch, lane);
    for (int s = s_begin + warp, buf = 0; s < s_end; s += warps, buf ^= 1) {
      const bool ahead = s + warps < s_end;
      if (ahead)
        attn_load_rows(frs + (buf ^ 1) * rows_elems, a.qkv, a.ga, 2, 1, b,
                        F, a.S, s + warps, H, h, d, pitch, lane);
      attn_wait_rows(ahead);
      const bf16* fr = frs + buf * rows_elems;  // [q, g_acc][F][pitch]
      const float* mld =
          a.mld + (((size_t)b * a.heads + h) * a.S + s) * F * 3;
      for (int qt = 0; qt < nqt; ++qt) {
        const int i0 = qt * 16;
        auto qrow = [&](int i) {
          return i0 + i < F ? fr + (size_t)(i0 + i) * pitch : zrow;
        };
        auto grow = [&](int i) {
          return i0 + i < F ? fr + (size_t)(F + i0 + i) * pitch : zrow;
        };
        float m[2], l[2], D[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + gq + 8 * half;
          m[half] = i < F ? mld[i * 3] : 0.f;
          l[half] = i < F ? mld[i * 3 + 1] : 1.f;
          D[half] = i < F ? mld[i * 3 + 2] : 0.f;
        }
        float pr[4][4], ds[4][4];
        attn_scores(pr, qrow, krow, ksteps, lane);
        attn_scores(ds, grow, vrow, ksteps, lane);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + gq + 8 * half;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = nt * 8 + 2 * tq + e;
              float& p = pr[nt][2 * half + e];
              float& dv = ds[nt][2 * half + e];
              p = i < F && j < nt_tok
                      ? expf(p + bias_t[i * kAttnKeys + j] - m[half]) / l[half]
                      : 0.f;
              dv = p * (round_bf16(dv) - D[half]);
              p = round_bf16(p);
            }
        }
        attn_stage_t<true>(scr, ds, lane);
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
          if (f0 + 16 * g < dp)
            attn_mma_t<true>(sk[g], scr, qrow, f0 + 16 * g, lane);
        attn_stage_t<false>(scr, pr, lane);
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
          if (f0 + 16 * g < dp)
            attn_mma_t<false>(sv[g], scr, grow, f0 + 16 * g, lane);
      }
      __syncwarp();  // this buffer's reads are done before it is refilled
    }
    // the warps' sums to `red`, then added in warp order
    float* rw = red + (size_t)warp * 2 * kAttnKeys * (kFC + 8);
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = mt * 16 + gq + 8 * half;
              const int f = 16 * g + nt * 8 + 2 * tq + e;
              rw[j * (kFC + 8) + f] = sk[g][mt][nt][2 * half + e];
              rw[(kAttnKeys + j) * (kFC + 8) + f] = sv[g][mt][nt][2 * half + e];
            }
    __syncthreads();
    const size_t pidx = ((size_t)b * a.heads + h) * gridDim.x + blk;
    float* ptok = a.part_tok + pidx * 2 * T * d;
    for (int i = t; i < 2 * kAttnKeys * kFC; i += blockDim.x) {
      const int which = i / (kAttnKeys * kFC), j = (i / kFC) % kAttnKeys;
      const int f = i % kFC;
      if (j >= nt_tok || f0 + f >= d) continue;
      float v = 0.f;
      for (int w = 0; w < warps; ++w)
        v += red[((size_t)(w * 2 + which) * kAttnKeys + j) * (kFC + 8) + f];
      ptok[((size_t)which * T + t0 + j) * d + f0 + f] = v;
    }
    __syncthreads();  // `red` is rewritten by the next pass
  }
}

// dbias[i][j][h] = sum over b, then the blocks, of part_bias
__global__ void temporal_any_bias_reduce(const float* __restrict__ part,
                                         float* __restrict__ dbias, int B,
                                         int heads, int blocks, int FG) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= FG * heads) return;
  const int h = o % heads, ij = o / heads;
  float v = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = part + (((size_t)b * heads + h) * blocks) * FG + ij;
    for (int k = 0; k < blocks; ++k) v += p[(size_t)k * FG];
  }
  dbias[o] = v;
}

// dekv[b][which][t][h d + e] = sum over the blocks of part_tok
__global__ void temporal_any_tok_reduce(const float* __restrict__ part,
                                        float* __restrict__ dekv, int B,
                                        int heads, int blocks, int T, int d) {
  const size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int H = heads * d;
  if (o >= (size_t)B * 2 * T * H) return;
  const int col = o % H, h = col / d, e = col % d;
  const int tt = (o / H) % T, which = (o / ((size_t)T * H)) % 2;
  const int b = o / ((size_t)2 * T * H);
  const float* p = part + (((size_t)b * heads + h) * blocks) * 2 * T * d +
                   ((size_t)which * T + tt) * d + e;
  float v = 0.f;
  for (int k = 0; k < blocks; ++k) v += p[(size_t)k * 2 * T * d];
  dekv[o] = v;
}

// ---- workspace carving

struct Carve {
  char* p;
  size_t used = 0;
  template <class T>
  T* take(size_t n) {
    T* out = reinterpret_cast<T*>(p == nullptr ? nullptr : p + used);
    used += vmt::align256(n * sizeof(T));
    return out;
  }
};

}  // namespace

// Dynamic shared memory a block of the temporal attention backward asks at
// (F, T, d), bytes; 0 where one warp's share does not fit (the shape is
// refused).
extern "C" size_t vmt_temporal_block_bwd_any_smem(int F, int T, int d) {
  if (F <= 0 || T < 0 || d <= 0) return 0;
  const int w = bwd_warps(F, T, d);
  if (w == 0 || (T > kTokInline && tok_warps(F, d) == 0)) return 0;
  return w * bwd_warp_bytes(F, T, d) + attn_block_bytes(F, T, d);
}

namespace {

// the temporal backward's scratch, carved from one workspace (p null: the
// size only)
struct TemporalWs {
  bf16 *y, *qkv, *ga, *acc, *dqkv;
  float *dy, *part_bias, *part_tok, *mld, *ln_part, *ln_ws, *contract;
  size_t bytes;
};

TemporalWs temporal_ws(void* p, int B, int F, int S, int C, int T, int heads,
                       int d) {
  Carve c{static_cast<char*>(p)};
  const size_t R = (size_t)B * F * S, H = (size_t)heads * d;
  const int blocks = (S + kTP - 1) / kTP;
  const size_t lnb = ln_bwd_blocks(R);
  TemporalWs w;
  w.y = c.take<bf16>(R * C);
  w.qkv = c.take<bf16>(R * 3 * H);
  w.ga = c.take<bf16>(R * H);
  w.acc = c.take<bf16>(R * H);
  w.dqkv = c.take<bf16>(R * 3 * H);
  w.dy = c.take<float>(R * C);
  w.part_bias = c.take<float>((size_t)B * heads * blocks * F * (F + T));
  w.part_tok = c.take<float>((size_t)B * heads * blocks * 2 * T * d);
  w.mld = c.take<float>(T > kTokInline ? (size_t)B * heads * S * F * 3 : 0);
  w.ln_part = c.take<float>(lnb * C);
  w.ln_ws = c.take<float>(vmt::colsum_workspace(1, (int)lnb, C) / sizeof(float));
  const size_t c1 = contract_ws(F, B * S, C, 3 * (int)H);
  const size_t c2 = contract_ws(1, (int)R, (int)H, C);
  w.contract = c.take<float>((c1 > c2 ? c1 : c2) / sizeof(float));
  w.bytes = c.used;
  return w;
}

}  // namespace

extern "C" size_t vmt_temporal_block_bwd_any_workspace(int B, int F, int S,
                                                       int C, int T,
                                                       int heads, int d) {
  return temporal_ws(nullptr, B, F, S, C, T, heads, d).bytes;
}

// The temporal block's backward at any shape. x, g (B, F, S, C) bf16;
// gamma (C); w_all (F, C, 3H) and w_allT (F, 3H, C) bf16; w_outT (C, H)
// bf16; bias (F, F + T, heads) f32; ek/ev (B, T, H) or null when T == 0.
// Out: dx (B, F, S, C) bf16; dgamma (C), dw_all (F, C, 3H), dw_out (H, C),
// dbias (F, F + T, heads), dekv (B, 2, T, H) (null when T == 0), all f32.
// workspace: vmt_temporal_block_bwd_any_workspace() bytes.
extern "C" int vmt_temporal_block_bwd_any(
    const void* x, const void* gamma, const void* w_all, const void* w_allT,
    const void* w_outT, const void* bias, const void* ek, const void* ev,
    const void* g, void* dx, void* dgamma, void* dw_all, void* dw_out,
    void* dbias, void* dekv, void* workspace, int B, int F, int S, int C,
    int T, int heads, int d, void* stream) {
  if (B <= 0 || F <= 0 || S <= 0 || C <= 0 || T < 0 || heads <= 0 || d <= 0 ||
      (T > 0 && (ek == nullptr || ev == nullptr || dekv == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int warps = bwd_warps(F, T, d);
  if (warps == 0 || (T > kTokInline && tok_warps(F, d) == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H = heads * d;
  const size_t R = (size_t)B * F * S;
  const TemporalWs w = temporal_ws(workspace, B, F, S, C, T, heads, d);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  cudaError_t err =
      launch_ln(xb, static_cast<const float*>(gamma), w.y, R, C, st);
  if (err != cudaSuccess) return (int)err;
  // qkv[b, f] = y[b, f] @ w_all[f]; g_acc = g @ w_out^T
  err = launch_gemm(gemm(w.y, C, (size_t)S * C, static_cast<const bf16*>(w_all),
                         3 * H, (size_t)C * 3 * H, F, w.qkv, 3 * H,
                         (size_t)S * 3 * H, S, 3 * H, C),
                    B * F, kStoreBf16, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm(gemm(gb, C, 0, static_cast<const bf16*>(w_outT), H, 0, 1,
                         w.ga, H, 0, (int)R, H, C),
                    1, kStoreBf16, st);
  if (err != cudaSuccess) return (int)err;
  TemporalBwd a;
  a.qkv = w.qkv;
  a.ga = w.ga;
  a.ek = static_cast<const bf16*>(ek);
  a.ev = static_cast<const bf16*>(ev);
  a.bias = static_cast<const float*>(bias);
  a.acc = w.acc;
  a.dqkv = w.dqkv;
  a.part_bias = w.part_bias;
  a.part_tok = w.part_tok;
  a.mld = T > kTokInline ? w.mld : nullptr;
  a.B = B; a.F = F; a.S = S; a.T = T; a.heads = heads; a.d = d;
  const size_t smem =
      warps * bwd_warp_bytes(F, T, d) + attn_block_bytes(F, T, d);
  auto kern = d <= 32 ? temporal_any_bwd_attn_kernel<32>
                      : temporal_any_bwd_attn_kernel<64>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (S + kTP - 1) / kTP;
  kern<<<dim3(blocks, heads, B), warps * 32, smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int FG = F * (F + T);
  temporal_any_bias_reduce<<<(FG * heads + 255) / 256, 256, 0, st>>>(
      w.part_bias, static_cast<float*>(dbias), B, heads, blocks, FG);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (T > kTokInline) {
    // the token keys' dk, dv from each query row's m, l, D
    const int tw = tok_warps(F, d), fc = tok_fc(d);
    const size_t tsmem = tw * tok_warp_bytes(F, d) + tok_block_bytes(F, d, tw, fc);
    auto tkern = fc == 32 ? temporal_any_bwd_tok_kernel<32>
                          : temporal_any_bwd_tok_kernel<64>;
    err = cudaFuncSetAttribute(tkern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)tsmem);
    if (err != cudaSuccess) return (int)err;
    const int tchunks = (T + kAttnKeys - 1) / kAttnKeys;
    tkern<<<dim3(blocks, heads, B * tchunks), tw * 32, tsmem, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (T > 0) {
    const size_t n = (size_t)B * 2 * T * H;
    temporal_any_tok_reduce<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        w.part_tok, static_cast<float*>(dekv), B, heads, blocks, T, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // dy[b, f] = dqkv[b, f] @ w_all[f]^T, then the LN backward
  err = launch_gemm(gemm(w.dqkv, 3 * H, (size_t)S * 3 * H,
                         static_cast<const bf16*>(w_allT), C,
                         (size_t)3 * H * C, F, w.dy, C, (size_t)S * C, S, C,
                         3 * H),
                    B * F, kStoreF32, st);
  if (err != cudaSuccess) return (int)err;
  const size_t lnb = ln_bwd_blocks(R);
  err = launch_ln_bwd(xb, static_cast<const float*>(gamma), w.dy, gb,
                      static_cast<bf16*>(dx), w.ln_part, R, C, st);
  if (err != cudaSuccess) return (int)err;
  err = vmt::launch_colsum(w.ln_part, static_cast<float*>(dgamma), 1,
                           (int)lnb, C, w.ln_ws, st);
  if (err != cudaSuccess) return (int)err;
  // dw_all[f] = sum_{b, s} y[b, f, s]^T dqkv[b, f, s]; dw_out = acc^T g
  err = launch_contract(
      rows_of(w.y, C, (size_t)S * C, S, (size_t)F * S * C),
      rows_of(w.dqkv, 3 * H, (size_t)S * 3 * H, S, (size_t)F * S * 3 * H),
      static_cast<float*>(dw_all), F, B * S, C, 3 * H, w.contract, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_contract(rows_of(w.acc, H), rows_of(g, C),
                              static_cast<float*>(dw_out), 1, (int)R, H, C,
                              w.contract, st);
}
