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
//   P[n,a]  = exp(kk[n,a]) / sum_n' exp(kk[n',a])     (token softmax)
//   ctx[a,e] = sum_n P[n,a] v[n,e] / HW               (a, e in one head)
//   Q[n,a]  = scale softmax_head(q[n])[a]
//   out     = x + out_bias + (Q ctx) W_out
// and the cotangents of g (all f32 but dx):
//   g_oh = g W_out^T,  dctx = Q^T g_oh,  dQ = g_oh ctx^T
//   dq   = Q (dQ - sum_head softmax(q) dQ)
//   dP   = dctx v^T / HW,  dk = P (dP - S) with S[a] = sum_e dctx ctx
//   dv   = P dctx / HW     (the cond tokens: dek, dev the same way)
//   dW_out = oh^T g, dout_bias = sum g, dW_qkv = y^T dqkv,
//   dx = g + LN backward of dqkv W_qkv^T, dgamma = sum xhat dy.
// Roundings: y bf16 (as the forward), dqkv and oh bf16 for the weight sums
// and dy (as the JAX backward's casts), the rest f32. LN is two-pass.
//
// What bounds it on an H100, at the level-0 training shape (BF = 44,
// N = 9216, C = 64): it reads x and g and writes dx (156 MB) and does
// about 100 GFLOP (the projections recomputed twice, g_oh, the per-head
// products, dy, dW_qkv and dW_out): the operations bound it at the
// tensor-core rate. This first kernel runs its products on the CUDA cores
// in fp32.
//
// Design. ctx and its normaliser are sums over all N tokens, and so are
// dctx and the weight gradients, so the backward has the forward's
// two-pass shape, with ordered reduces between the passes (no atomics):
//   1. stats: per (frame, token tile) partial ctx, z and running max of kk
//      (online rescaling, so the unclamped softmax needs no extra pass);
//      reduce: the max-merged, normalised ctx (+ the cond tokens once);
//   2. pass 1: per tile, recompute Q; g_oh, oh (bf16 to a scratch for
//      dW_out), dq (bf16 to the dqkv scratch) and partial dctx, dout_bias;
//      reduce: dctx, S, and the cond tokens' dek, dev;
//   3. pass 2: per tile, recompute P and v; dk, dv (to the dqkv scratch),
//      dy = dqkv W_qkv^T, the LN backward and dx, partial dgamma; y (bf16)
//      to a scratch;
//   4. dW_qkv = y^T dqkv and dW_out = oh^T g by the tiled contraction of
//      reduce.cu, dgamma and dout_bias by ordered column sums.
// Thread t owns hidden column t (head t / 32), so a per-head reduction is
// a warp reduction and each thread keeps its 32-wide rows and columns of
// ctx and dctx in registers. The TPU's full (hidden x hidden) masked
// context is not needed: only the eight diagonal 32 x 32 blocks exist.
#include <algorithm>

#include "common.cuh"
#include "linear_stats.cuh"
#include "reduce.cuh"

namespace {

using vmt::kD;
using vmt::kH;
using vmt::kThreads;
using vmt::bf2f;
using vmt::round_bf16;
using vmt::warp_max;
using vmt::warp_sum;

constexpr int kR = 8;  // tokens per chunk (one LN row per warp)
constexpr int kQKV = 3 * kH;
constexpr float kClamp = 60.f;

__device__ __forceinline__ float clip_k(float k, int clip) {
  return clip ? fminf(fmaxf(k, -kClamp), kClamp) : k;
}

// thread t: columns (col0 + t) of y @ w for the kR rows in ys
template <int kC>
__device__ __forceinline__ void project(const float* ys,
                                        const __nv_bfloat16* __restrict__ w,
                                        int col, float (&acc)[kR]) {
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = 0.f;
  const __nv_bfloat16* wc = w + col;
#pragma unroll 2
  for (int c = 0; c < kC; c += 4) {
    float wv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) wv[u] = bf2f(wc[(size_t)(c + u) * kQKV]);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float4 y4 = *reinterpret_cast<const float4*>(ys + r * kC + c);
      acc[r] = fmaf(y4.x, wv[0], acc[r]);
      acc[r] = fmaf(y4.y, wv[1], acc[r]);
      acc[r] = fmaf(y4.z, wv[2], acc[r]);
      acc[r] = fmaf(y4.w, wv[3], acc[r]);
    }
  }
}

// ---------------------------------------------------------------- stats

template <int kC>
__global__ void __launch_bounds__(kThreads) lin_bwd_stats(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
    const __nv_bfloat16* __restrict__ w_qkv, float* __restrict__ part_ctx,
    float* __restrict__ part_z, float* __restrict__ part_m, int N, int tile,
    float inv_hw, int clip) {
  __shared__ __align__(16) float ys[kR * kC];
  __shared__ __align__(16) float vs[kR * kH];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, h = warp;
  const int bf = blockIdx.y, n_tiles = gridDim.x;
  const int n_begin = blockIdx.x * tile, n_end = min(N, n_begin + tile);
  const __nv_bfloat16* xb = x + (size_t)bf * N * kC;
  float ctx[kD];
#pragma unroll
  for (int e = 0; e < kD; ++e) ctx[e] = 0.f;
  float z = 0.f, m = -INFINITY;
  for (int n0 = n_begin; n0 < n_end; n0 += kR) {
    {
      const int n = n0 + warp;
      const bool valid = n < n_end;
      vmt::layer_norm_row<kC>(xb + (size_t)(valid ? n : 0) * kC, gamma,
                              ys + warp * kC, valid, lane);
    }
    __syncthreads();
    float ka[kR], va[kR];
    project<kC>(ys, w_qkv, kH + t, ka);
    project<kC>(ys, w_qkv, 2 * kH + t, va);
    float mnew = m;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const bool valid = n0 + r < n_end;
      ka[r] = valid ? clip_k(ka[r], clip) : -INFINITY;
      mnew = fmaxf(mnew, ka[r]);
      vs[r * kH + t] = valid ? va[r] * inv_hw : 0.f;
    }
    const float sc = expf(m - mnew);  // m = -inf: nothing to rescale
    z *= sc;
#pragma unroll
    for (int e = 0; e < kD; ++e) ctx[e] *= sc;
    m = mnew;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float pk = expf(ka[r] - m);
      z += pk;
      const float* vrow = vs + r * kH + h * kD;
#pragma unroll
      for (int e = 0; e < kD; ++e) ctx[e] = fmaf(pk, vrow[e], ctx[e]);
    }
    __syncthreads();
  }
  const size_t blk = (size_t)bf * n_tiles + blockIdx.x;
#pragma unroll
  for (int e = 0; e < kD; ++e) part_ctx[(blk * kD + e) * kH + t] = ctx[e];
  part_z[blk * kH + t] = z;
  part_m[blk * kH + t] = m;
}

// per frame: the max-merged, normalised context (+ the cond tokens)
__global__ void __launch_bounds__(kThreads) lin_bwd_stats_reduce(
    const float* __restrict__ part_ctx, const float* __restrict__ part_z,
    const float* __restrict__ part_m, const __nv_bfloat16* __restrict__ ek,
    const __nv_bfloat16* __restrict__ ev, float* __restrict__ ctxn,
    float* __restrict__ m_out, float* __restrict__ zinv_out, int n_tiles,
    int Mc, float inv_hw, int clip) {
  const int t = threadIdx.x, h = t >> 5;
  const int bf = blockIdx.x;
  float M = -INFINITY;
  for (int i = 0; i < n_tiles; ++i)
    M = fmaxf(M, part_m[((size_t)bf * n_tiles + i) * kH + t]);
  for (int mc = 0; mc < Mc; ++mc)
    M = fmaxf(M, clip_k(bf2f(ek[((size_t)bf * Mc + mc) * kH + t]), clip));
  float ctx[kD];
#pragma unroll
  for (int e = 0; e < kD; ++e) ctx[e] = 0.f;
  float Z = 0.f;
  for (int mc = 0; mc < Mc; ++mc) {
    const size_t row = ((size_t)bf * Mc + mc) * kH;
    const float pk = expf(clip_k(bf2f(ek[row + t]), clip) - M);
    Z += pk;
#pragma unroll
    for (int e = 0; e < kD; ++e)
      ctx[e] = fmaf(pk, bf2f(ev[row + h * kD + e]) * inv_hw, ctx[e]);
  }
  for (int i = 0; i < n_tiles; ++i) {
    const size_t blk = (size_t)bf * n_tiles + i;
    const float mt = part_m[blk * kH + t];
    if (mt == -INFINITY) continue;  // a tile without tokens
    const float sc = expf(mt - M);
    Z = fmaf(part_z[blk * kH + t], sc, Z);
#pragma unroll
    for (int e = 0; e < kD; ++e)
      ctx[e] = fmaf(part_ctx[(blk * kD + e) * kH + t], sc, ctx[e]);
  }
  const float zi = 1.f / Z;
#pragma unroll
  for (int e = 0; e < kD; ++e) ctxn[((size_t)bf * kH + t) * kD + e] = ctx[e] * zi;
  m_out[(size_t)bf * kH + t] = M;
  zinv_out[(size_t)bf * kH + t] = zi;
}

// ---------------------------------------------------------------- pass 1

template <int kC>
__global__ void __launch_bounds__(kThreads) lin_bwd_pass1(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
    const __nv_bfloat16* __restrict__ w_qkv,
    const __nv_bfloat16* __restrict__ w_outT,   // (C, H)
    const __nv_bfloat16* __restrict__ g, const float* __restrict__ ctxn,
    __nv_bfloat16* __restrict__ oh_out,         // (BF, N, H) scratch
    __nv_bfloat16* __restrict__ dqkv_out,       // (BF, N, 3H) scratch
    float* __restrict__ part_dctx, float* __restrict__ part_dob, int N,
    int tile, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ys = reinterpret_cast<float*>(smem_raw);  // [R][C]
  float* gs = ys + kR * kC;                        // [R][C]
  float* qs = gs + kR * kC;                        // [R][H]  Q
  float* go = qs + kR * kH;                        // [R][H]  g_oh
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, h = warp;
  const int bf = blockIdx.y, n_tiles = gridDim.x;
  const int n_begin = blockIdx.x * tile, n_end = min(N, n_begin + tile);
  const __nv_bfloat16* xb = x + (size_t)bf * N * kC;
  const __nv_bfloat16* gb = g + (size_t)bf * N * kC;
  constexpr int kCT = (kC + kThreads - 1) / kThreads;

  float ccol[kD], crow[kD], dctx[kD];
#pragma unroll
  for (int a = 0; a < kD; ++a) {
    ccol[a] = ctxn[((size_t)bf * kH + h * kD + a) * kD + lane];  // ctx[a][e=lane]
    crow[a] = ctxn[((size_t)bf * kH + t) * kD + a];             // ctx[a=t][e]
    dctx[a] = 0.f;
  }
  float dob[kCT];
#pragma unroll
  for (int u = 0; u < kCT; ++u) dob[u] = 0.f;

  for (int n0 = n_begin; n0 < n_end; n0 += kR) {
    {
      const int n = n0 + warp;
      const bool valid = n < n_end;
      vmt::layer_norm_row<kC>(xb + (size_t)(valid ? n : 0) * kC, gamma,
                              ys + warp * kC, valid, lane);
      const __nv_bfloat16* gr = gb + (size_t)(valid ? n : 0) * kC;
#pragma unroll
      for (int u = 0; u < kC / 32; ++u)
        gs[warp * kC + lane + 32 * u] = valid ? bf2f(gr[lane + 32 * u]) : 0.f;
    }
    __syncthreads();
    float qa[kR], sm[kR];
    project<kC>(ys, w_qkv, t, qa);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float e = expf(qa[r] - warp_max(qa[r]));
      sm[r] = n0 + r < n_end ? e / warp_sum(e) : 0.f;
      qs[r * kH + t] = scale * sm[r];
    }
    float ga[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) ga[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kC; ++c) {
      const float w = bf2f(w_outT[(size_t)c * kH + t]);
#pragma unroll
      for (int r = 0; r < kR; ++r) ga[r] = fmaf(gs[r * kC + c], w, ga[r]);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) go[r * kH + t] = ga[r];
#pragma unroll
    for (int u = 0; u < kCT; ++u) {
      const int c = t + u * kThreads;
      if (c < kC)
#pragma unroll
        for (int r = 0; r < kR; ++r) dob[u] += gs[r * kC + c];
    }
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < kR && n0 + r < n_end; ++r) {
      const float* qrow = qs + r * kH + h * kD;
      const float* grow = go + r * kH + h * kD;
      float oh = 0.f, dQ = 0.f;
#pragma unroll
      for (int a = 0; a < kD; ++a) {
        oh = fmaf(qrow[a], ccol[a], oh);
        dQ = fmaf(grow[a], crow[a], dQ);
      }
      const size_t row = (size_t)bf * N + n0 + r;
      oh_out[row * kH + t] = __float2bfloat16(oh);
      const float Q = qs[r * kH + t];
      const float dq = Q * (dQ - warp_sum(sm[r] * dQ));
      dqkv_out[row * kQKV + t] = __float2bfloat16(dq);
#pragma unroll
      for (int e = 0; e < kD; ++e) dctx[e] = fmaf(Q, grow[e], dctx[e]);
    }
    __syncthreads();
  }
  const size_t blk = (size_t)bf * n_tiles + blockIdx.x;
#pragma unroll
  for (int e = 0; e < kD; ++e) part_dctx[(blk * kD + e) * kH + t] = dctx[e];
#pragma unroll
  for (int u = 0; u < kCT; ++u) {
    const int c = t + u * kThreads;
    if (c < kC) part_dob[blk * kC + c] = dob[u];
  }
}

// per frame: dctx (tiles in order), S = sum_e dctx ctx, and the cond
// tokens' dek, dev
__global__ void __launch_bounds__(kThreads) lin_bwd_reduce2(
    const float* __restrict__ part_dctx, const float* __restrict__ ctxn,
    const float* __restrict__ m_in, const float* __restrict__ zinv_in,
    const __nv_bfloat16* __restrict__ ek, const __nv_bfloat16* __restrict__ ev,
    float* __restrict__ dctx_out, float* __restrict__ S_out,
    float* __restrict__ dek, float* __restrict__ dev, int n_tiles, int Mc,
    float inv_hw, int clip) {
  __shared__ float dctx_s[kH * (kD + 1)];
  __shared__ float p_s[kH];
  const int t = threadIdx.x, h = t >> 5, lane = t & 31;
  const int bf = blockIdx.x;
  float dctx[kD];
#pragma unroll
  for (int e = 0; e < kD; ++e) dctx[e] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const float* pd = part_dctx + ((size_t)bf * n_tiles + i) * kD * kH;
#pragma unroll
    for (int e = 0; e < kD; ++e) dctx[e] += pd[e * kH + t];
  }
  float S = 0.f;
#pragma unroll
  for (int e = 0; e < kD; ++e) {
    S = fmaf(dctx[e], ctxn[((size_t)bf * kH + t) * kD + e], S);
    dctx_out[((size_t)bf * kH + t) * kD + e] = dctx[e];
    dctx_s[t * (kD + 1) + e] = dctx[e];
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
      dP = fmaf(dctx[e], bf2f(ev[row + h * kD + e]) * inv_hw, dP);
    const bool pass = !clip || fabsf(kc) < kClamp;
    dek[row + t] = pass ? P * (dP - S) : 0.f;
    __syncthreads();  // p_s of the previous token is read
    p_s[t] = P;
    __syncthreads();
    float dV = 0.f;
#pragma unroll
    for (int a = 0; a < kD; ++a)
      dV = fmaf(p_s[h * kD + a], dctx_s[(h * kD + a) * (kD + 1) + lane], dV);
    dev[row + t] = dV * inv_hw;
  }
}

// ---------------------------------------------------------------- pass 2

template <int kC>
__global__ void __launch_bounds__(kThreads) lin_bwd_pass2(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
    const __nv_bfloat16* __restrict__ w_qkv,
    const __nv_bfloat16* __restrict__ w_qkvT,   // (3H, C)
    const __nv_bfloat16* __restrict__ g, const float* __restrict__ dctx_in,
    const float* __restrict__ S_in, const float* __restrict__ m_in,
    const float* __restrict__ zinv_in, __nv_bfloat16* __restrict__ dx,
    __nv_bfloat16* __restrict__ y_out,          // (BF, N, C) scratch
    __nv_bfloat16* __restrict__ dqkv,           // (BF, N, 3H) scratch
    float* __restrict__ part_dgamma, int N, int tile, float inv_hw,
    int clip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ys = reinterpret_cast<float*>(smem_raw);  // [R][C]: y, then dy
  float* vs = ys + kR * kC;                        // [R][H]  v / HW
  float* ps = vs + kR * kH;                        // [R][H]  P
  __nv_bfloat16* ds =
      reinterpret_cast<__nv_bfloat16*>(ps + kR * kH);  // [R][3H] dqkv
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, h = warp;
  const int bf = blockIdx.y, n_tiles = gridDim.x;
  const int n_begin = blockIdx.x * tile, n_end = min(N, n_begin + tile);
  const __nv_bfloat16* xb = x + (size_t)bf * N * kC;

  float drow[kD], dcol[kD];
#pragma unroll
  for (int a = 0; a < kD; ++a) {
    drow[a] = dctx_in[((size_t)bf * kH + t) * kD + a];             // [a=t][e]
    dcol[a] = dctx_in[((size_t)bf * kH + h * kD + a) * kD + lane];  // [a][e=lane]
  }
  const float S = S_in[(size_t)bf * kH + t];
  const float m = m_in[(size_t)bf * kH + t];
  const float zi = zinv_in[(size_t)bf * kH + t];
  constexpr int kRR = kC >= 256 ? kR : kC / 32;
  constexpr int kGroups = kR / kRR;
  float dgam[kC / 32];
#pragma unroll
  for (int u = 0; u < kC / 32; ++u) dgam[u] = 0.f;

  for (int n0 = n_begin; n0 < n_end; n0 += kR) {
    {
      const int n = n0 + warp;
      const bool valid = n < n_end;
      vmt::layer_norm_row<kC>(xb + (size_t)(valid ? n : 0) * kC, gamma,
                              ys + warp * kC, valid, lane);
      if (valid) {
        __nv_bfloat16* yr = y_out + ((size_t)bf * N + n) * kC;
#pragma unroll
        for (int u = 0; u < kC / 32; ++u)
          yr[lane + 32 * u] = __float2bfloat16(ys[warp * kC + lane + 32 * u]);
      }
    }
    __syncthreads();
    float ka[kR], va[kR];
    project<kC>(ys, w_qkv, kH + t, ka);
    project<kC>(ys, w_qkv, 2 * kH + t, va);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const bool valid = n0 + r < n_end;
      ps[r * kH + t] = valid ? expf(clip_k(ka[r], clip) - m) * zi : 0.f;
      vs[r * kH + t] = valid ? va[r] * inv_hw : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const bool valid = n0 + r < n_end;
      const float* vrow = vs + r * kH + h * kD;
      const float* prow = ps + r * kH + h * kD;
      float dP = 0.f, dV = 0.f;
#pragma unroll
      for (int a = 0; a < kD; ++a) {
        dP = fmaf(drow[a], vrow[a], dP);
        dV = fmaf(prow[a], dcol[a], dV);
      }
      const bool pass = !clip || fabsf(ka[r]) < kClamp;
      const float dk = valid && pass ? ps[r * kH + t] * (dP - S) : 0.f;
      const float dv = valid ? dV * inv_hw : 0.f;
      const size_t row = (size_t)bf * N + n0 + r;
      const __nv_bfloat16 dkb = __float2bfloat16(dk), dvb = __float2bfloat16(dv);
      ds[r * kQKV + t] = valid ? dqkv[row * kQKV + t] : __float2bfloat16(0.f);
      ds[r * kQKV + kH + t] = dkb;
      ds[r * kQKV + 2 * kH + t] = dvb;
      if (valid) {
        dqkv[row * kQKV + kH + t] = dkb;
        dqkv[row * kQKV + 2 * kH + t] = dvb;
      }
    }
    __syncthreads();
    // dy = dqkv @ W_qkv^T into ys (y is no longer needed)
    for (int item = t; item < kC * kGroups; item += kThreads) {
      const int c = item % kC;
      const int r0 = (item / kC) * kRR;
      float o[kRR];
#pragma unroll
      for (int rr = 0; rr < kRR; ++rr) o[rr] = 0.f;
#pragma unroll 2
      for (int j = 0; j < kQKV; j += 8) {
        float w8[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) w8[u] = bf2f(w_qkvT[(size_t)(j + u) * kC + c]);
#pragma unroll
        for (int rr = 0; rr < kRR; ++rr) {
          float a[8];
          vmt::unpack8(*reinterpret_cast<const uint4*>(ds + (r0 + rr) * kQKV + j), a);
#pragma unroll
          for (int u = 0; u < 8; ++u) o[rr] = fmaf(a[u], w8[u], o[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRR; ++rr) ys[(r0 + rr) * kC + c] = o[rr];
    }
    __syncthreads();
    {
      const int n = n0 + warp;
      if (n < n_end) {
        const size_t row = ((size_t)bf * N + n) * kC;
        float xv[kC / 32];
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < kC / 32; ++u) {
          xv[u] = bf2f(x[row + lane + 32 * u]);
          sum += xv[u];
        }
        const float mu = warp_sum(sum) / kC;
        float sq = 0.f;
#pragma unroll
        for (int u = 0; u < kC / 32; ++u) {
          const float d = xv[u] - mu;
          sq += d * d;
        }
        const float rstd = rsqrtf(warp_sum(sq) / kC + vmt::kLnEps);
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int u = 0; u < kC / 32; ++u) {
          const int c = lane + 32 * u;
          const float xh = (xv[u] - mu) * rstd;
          const float dyv = ys[warp * kC + c];
          dgam[u] = fmaf(xh, dyv, dgam[u]);
          const float dxh = dyv * gamma[c];
          xv[u] = xh;
          s1 += dxh;
          s2 = fmaf(dxh, xh, s2);
        }
        const float m1 = warp_sum(s1) / kC;
        const float m2 = warp_sum(s2) / kC;
#pragma unroll
        for (int u = 0; u < kC / 32; ++u) {
          const int c = lane + 32 * u;
          const float dxh = ys[warp * kC + c] * gamma[c];
          dx[row + c] = __float2bfloat16(bf2f(g[row + c]) +
                                         rstd * (dxh - m1 - xv[u] * m2));
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < kC / 32; ++u) ys[warp * kC + lane + 32 * u] = dgam[u];
  __syncthreads();
  const size_t blk = (size_t)bf * n_tiles + blockIdx.x;
  for (int c = t; c < kC; c += kThreads) {
    float sg = 0.f;
#pragma unroll
    for (int w = 0; w < kR; ++w) sg += ys[w * kC + c];
    part_dgamma[blk * kC + c] = sg;
  }
}

// ---------------------------------------------------------------- host

struct Work {
  float *pctx, *pz, *pm, *ctxn, *m, *zinv, *pdctx, *pdob, *dctx, *S, *pdgam;
  __nv_bfloat16 *y, *dqkv, *oh;
  float *ws_contract, *ws_colsum;
  size_t bytes;
};

Work carve(void* base, int BF, int N, int C, int tile) {
  const int nT = (N + tile - 1) / tile;
  const size_t rows = (size_t)BF * N, blks = (size_t)BF * nT;
  const size_t sz[16] = {
      blks * kD * kH * 4, blks * kH * 4, blks * kH * 4,       // pctx pz pm
      (size_t)BF * kH * kD * 4, (size_t)BF * kH * 4, (size_t)BF * kH * 4,
      blks * kD * kH * 4, blks * C * 4,                       // pdctx pdob
      (size_t)BF * kH * kD * 4, (size_t)BF * kH * 4,          // dctx S
      blks * C * 4,                                           // pdgam
      rows * C * 2, rows * kQKV * 2, rows * kH * 2,           // y dqkv oh
      std::max(vmt::contract_workspace(1, (int)rows, C, kQKV),
               vmt::contract_workspace(1, (int)rows, kH, C)),
      vmt::colsum_workspace(1, (int)blks, C) + 4};
  void* ptrs[16];
  size_t off = 0;
  char* p = static_cast<char*>(base);
  for (int i = 0; i < 16; ++i) {
    ptrs[i] = p ? p + off : nullptr;
    off += vmt::align256(sz[i]);
  }
  Work w{};
  float** fp[11] = {&w.pctx, &w.pz, &w.pm, &w.ctxn, &w.m, &w.zinv,
                    &w.pdctx, &w.pdob, &w.dctx, &w.S, &w.pdgam};
  for (int i = 0; i < 11; ++i) *fp[i] = static_cast<float*>(ptrs[i]);
  w.y = static_cast<__nv_bfloat16*>(ptrs[11]);
  w.dqkv = static_cast<__nv_bfloat16*>(ptrs[12]);
  w.oh = static_cast<__nv_bfloat16*>(ptrs[13]);
  w.ws_contract = static_cast<float*>(ptrs[14]);
  w.ws_colsum = static_cast<float*>(ptrs[15]);
  w.bytes = off;
  return w;
}

template <int kC>
cudaError_t launch(const void* x, const void* gamma, const void* w_qkv,
                   const void* w_qkvT, const void* w_outT, const void* ek,
                   const void* ev, const void* g, void* dx, void* dgamma,
                   void* dw_qkv, void* dw_out, void* dob, void* dek,
                   void* dev, void* workspace, int BF, int N, int Mc,
                   int tile, float scale, float inv_hw, int clip,
                   cudaStream_t st) {
  using bf = __nv_bfloat16;
  const bf* xb = static_cast<const bf*>(x);
  const float* gm = static_cast<const float*>(gamma);
  const bf* wq = static_cast<const bf*>(w_qkv);
  const bf* gb = static_cast<const bf*>(g);
  const bf* ekb = static_cast<const bf*>(ek);
  const bf* evb = static_cast<const bf*>(ev);
  const Work w = carve(workspace, BF, N, kC, tile);
  const int nT = (N + tile - 1) / tile;
  const dim3 grid(nT, BF);
  cudaError_t err;

  err = vmt::launch_online_stats(
      xb, gm, wq, ekb, evb,
      vmt::OnlineStats{w.pctx, w.pz, w.pm, w.ctxn, w.m, w.zinv}, BF, N, kC,
      Mc, tile, inv_hw, clip, st);
  if (err != cudaSuccess) return err;

  const size_t smem1 = (2 * (size_t)kR * kC + 2 * (size_t)kR * kH) * 4;
  err = cudaFuncSetAttribute(lin_bwd_pass1<kC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem1);
  if (err != cudaSuccess) return err;
  lin_bwd_pass1<kC><<<grid, kThreads, smem1, st>>>(
      xb, gm, wq, static_cast<const bf*>(w_outT), gb, w.ctxn, w.oh, w.dqkv,
      w.pdctx, w.pdob, N, tile, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  lin_bwd_reduce2<<<BF, kThreads, 0, st>>>(
      w.pdctx, w.ctxn, w.m, w.zinv, ekb, evb, w.dctx, w.S,
      static_cast<float*>(dek), static_cast<float*>(dev), nT, Mc, inv_hw,
      clip);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem2 = ((size_t)kR * kC + 2 * (size_t)kR * kH) * 4 +
                       (size_t)kR * kQKV * 2;
  err = cudaFuncSetAttribute(lin_bwd_pass2<kC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  lin_bwd_pass2<kC><<<grid, kThreads, smem2, st>>>(
      xb, gm, wq, static_cast<const bf*>(w_qkvT), gb, w.dctx, w.S, w.m,
      w.zinv, static_cast<bf*>(dx), w.y, w.dqkv, w.pdgam, N, tile, inv_hw,
      clip);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int rows = BF * N;
  err = vmt::launch_contract(w.y, w.dqkv, static_cast<float*>(dw_qkv), 1,
                             rows, kC, kQKV, 0, 0, w.ws_contract, st);
  if (err != cudaSuccess) return err;
  err = vmt::launch_contract(w.oh, gb, static_cast<float*>(dw_out), 1, rows,
                             kH, kC, 0, 0, w.ws_contract, st);
  if (err != cudaSuccess) return err;
  err = vmt::launch_colsum(w.pdgam, static_cast<float*>(dgamma), 1, BF * nT,
                           kC, w.ws_colsum, st);
  if (err != cudaSuccess) return err;
  return vmt::launch_colsum(w.pdob, static_cast<float*>(dob), 1, BF * nT, kC,
                            w.ws_colsum, st);
}

}  // namespace

namespace vmt {

void online_stats_sizes(int BF, int N, int tile, size_t (&bytes)[6]) {
  const size_t blks = (size_t)BF * ((N + tile - 1) / tile);
  const size_t sz[6] = {blks * kD * kH * 4, blks * kH * 4, blks * kH * 4,
                        (size_t)BF * kH * kD * 4, (size_t)BF * kH * 4,
                        (size_t)BF * kH * 4};
  for (int i = 0; i < 6; ++i) bytes[i] = sz[i];
}

cudaError_t launch_online_stats(const __nv_bfloat16* x, const float* gamma,
                                const __nv_bfloat16* w_qkv,
                                const __nv_bfloat16* ek,
                                const __nv_bfloat16* ev, const OnlineStats& s,
                                int BF, int N, int C, int Mc, int tile,
                                float inv_hw, int clip, cudaStream_t st) {
  const int nT = (N + tile - 1) / tile;
  const dim3 grid(nT, BF);
  switch (C) {
#define VMT_CASE(CC)                                                         \
  case CC:                                                                   \
    lin_bwd_stats<CC><<<grid, kThreads, 0, st>>>(x, gamma, w_qkv, s.pctx,    \
                                                 s.pz, s.pm, N, tile, inv_hw, \
                                                 clip);                      \
    break;
    VMT_CASE(64)
    VMT_CASE(128)
    VMT_CASE(256)
    VMT_CASE(512)
#undef VMT_CASE
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lin_bwd_stats_reduce<<<BF, kThreads, 0, st>>>(s.pctx, s.pz, s.pm, ek, ev,
                                                s.ctxn, s.m, s.zinv, nT, Mc,
                                                inv_hw, clip);
  return cudaGetLastError();
}

}  // namespace vmt

// Workspace bytes of vmt_linear_block_bwd for these sizes.
extern "C" size_t vmt_linear_block_bwd_workspace(int BF, int N, int C,
                                                 int tile) {
  return carve(nullptr, BF, N, C, tile).bytes;
}

// dek/dev: (BF, Mc, H) f32, or null when Mc == 0. clip = 1: the merged
// row (clamped k, dk and dek zero where |k| >= 60); clip = 0: per-head.
extern "C" int vmt_linear_block_bwd(
    const void* x, const void* gamma, const void* w_qkv, const void* w_qkvT,
    const void* w_outT, const void* ek, const void* ev, const void* g,
    void* dx, void* dgamma, void* dw_qkv, void* dw_out, void* dout_bias,
    void* dek, void* dev, void* workspace, int BF, int N, int C, int Mc,
    int heads, int tile, float scale, float inv_hw, int clip, void* stream) {
  if (heads != vmt::kHeads || tile <= 0 || tile % kR || Mc < 0 ||
      (Mc > 0 && (ek == nullptr || ev == nullptr || dek == nullptr ||
                  dev == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VMT_CASE(CC)                                                        \
  case CC:                                                                  \
    return (int)launch<CC>(x, gamma, w_qkv, w_qkvT, w_outT, ek, ev, g, dx,  \
                           dgamma, dw_qkv, dw_out, dout_bias, dek, dev,     \
                           workspace, BF, N, Mc, tile, scale, inv_hw, clip, \
                           st);
  switch (C) {
    VMT_CASE(64)
    VMT_CASE(128)
    VMT_CASE(256)
    VMT_CASE(512)
    default: return (int)cudaErrorInvalidValue;
  }
#undef VMT_CASE
}
