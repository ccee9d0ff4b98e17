// Fused spatial linear-attention block, forward, for sm_90a: a stats kernel
// and an apply kernel.
//
// Replaces videometamaterials_tpu/ops/pallas/fused_linear_block.py:
//   _merged_stats_kernel (pallas_call in _run_kernel_merged) -> vmt_linear_stats
//   _merged_apply_kernel (pallas_call in _run_kernel_merged) -> vmt_linear_apply
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
//
// What bounds them on an H100, at the level-0 shape (2B*F = 22 frames,
// N = 9216, C = 64): stats reads x (26 MB) and does 2*22*9216*64*512 +
// 2*22*9216*8*32*32 = 16.6 GFLOP (17 us at 989 TFLOP/s bf16; the bytes
// take 7.8 us); apply reads x and writes out (52 MB, 15.5 us) and does
// 2*22*9216*(64*256 + 8*32*32 + 256*64) = 17.4 GFLOP (17.6 us). Both are
// bounded by operations at the tensor-core rate; these first kernels run
// their products on the CUDA cores in fp32 and sit above that bound.
//
// Design. Blocks run in no order, so the stats pass cannot accumulate
// across tiles in revisited output blocks as the TPU grid does: each block
// writes the partial ctx/z of its (frame, token tile) to scratch, and a
// second small pass adds the conditioning tokens once and then the tiles
// in order, so the result is deterministic (no atomics). Thread t owns
// hidden column t (head t/32, feature t%32): it computes k/v column t for 8
// tokens per weight load, keeps its own exp(k) column in registers, and
// accumulates ctx row (h, a=t%32) from v rows staged in shared memory. In
// apply, thread (h, e) keeps column e of head h's context in 32 registers;
// the q softmax is a warp reduction per head, and out-proj, bias and
// residual are fused. Only the 8 diagonal 32x32 context blocks are
// computed and stored: the TPU's masked 256x256 context is not needed.
#include "common.cuh"

namespace {

using vmt::kD;
using vmt::kH;
using vmt::kHeads;
using vmt::kThreads;
using vmt::bf2f;
using vmt::round_bf16;

constexpr int kR = 8;  // tokens per chunk (one LN row per warp)
static_assert(kR == kThreads / 32, "one warp per token in the LN phase");
constexpr float kClamp = 60.f;

__device__ __forceinline__ float clamp_k(float k) {
  return fminf(fmaxf(k, -kClamp), kClamp);
}

template <int kC>
__global__ void __launch_bounds__(kThreads) linear_stats_partial(
    const __nv_bfloat16* __restrict__ x,      // (BF, N, C)
    const float* __restrict__ gamma,          // (C)
    const __nv_bfloat16* __restrict__ w_qkv,  // (C, 3H)
    float* __restrict__ part_ctx,             // (BF, tiles, d, H)
    float* __restrict__ part_z,               // (BF, tiles, H)
    int N, int tile, float inv_hw) {
  __shared__ __align__(16) float ys[kR * kC];
  __shared__ __align__(16) float vs[kR * kH];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int h = warp;
  const int bf = blockIdx.y;
  const int n_tiles = gridDim.x;
  const int n_begin = blockIdx.x * tile;
  const int n_end = min(N, n_begin + tile);
  const __nv_bfloat16* xb = x + (size_t)bf * N * kC;
  const __nv_bfloat16* wk = w_qkv + kH + t;

  float ctx[kD];
#pragma unroll
  for (int e = 0; e < kD; ++e) ctx[e] = 0.f;
  float zacc = 0.f;

  for (int n0 = n_begin; n0 < n_end; n0 += kR) {
    {
      const int n = n0 + warp;
      const bool valid = n < n_end;
      vmt::layer_norm_row<kC>(xb + (size_t)(valid ? n : 0) * kC, gamma,
                              ys + warp * kC, valid, lane);
    }
    __syncthreads();
    float ka[kR], va[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) ka[r] = va[r] = 0.f;
#pragma unroll 2
    for (int c = 0; c < kC; c += 4) {
      float wkc[4], wvc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        wkc[u] = bf2f(wk[(size_t)(c + u) * 3 * kH]);
        wvc[u] = bf2f(wk[(size_t)(c + u) * 3 * kH + kH]);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4 y4 = *reinterpret_cast<const float4*>(ys + r * kC + c);
        const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          ka[r] = fmaf(yv[u], wkc[u], ka[r]);
          va[r] = fmaf(yv[u], wvc[u], va[r]);
        }
      }
    }
    float pkb[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const bool valid = n0 + r < n_end;
      const float pk = valid ? expf(clamp_k(ka[r])) : 0.f;
      zacc += pk;
      pkb[r] = round_bf16(pk);
      vs[r * kH + t] = valid ? round_bf16(va[r] * inv_hw) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float* vrow = vs + r * kH + h * kD;
#pragma unroll
      for (int e = 0; e < kD; e += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vrow + e);
        ctx[e] = fmaf(pkb[r], v4.x, ctx[e]);
        ctx[e + 1] = fmaf(pkb[r], v4.y, ctx[e + 1]);
        ctx[e + 2] = fmaf(pkb[r], v4.z, ctx[e + 2]);
        ctx[e + 3] = fmaf(pkb[r], v4.w, ctx[e + 3]);
      }
    }
  }
  float* pc = part_ctx + ((size_t)bf * n_tiles + blockIdx.x) * kD * kH;
#pragma unroll
  for (int e = 0; e < kD; ++e) pc[e * kH + t] = ctx[e];
  part_z[((size_t)bf * n_tiles + blockIdx.x) * kH + t] = zacc;
}

__global__ void __launch_bounds__(kThreads) linear_stats_reduce(
    const float* __restrict__ part_ctx, const float* __restrict__ part_z,
    const __nv_bfloat16* __restrict__ ek,     // (BF, Mc, H) or null
    const __nv_bfloat16* __restrict__ ev,     // (BF, Mc, H) or null
    float* __restrict__ ctx_out,              // (BF, heads, d, d)
    float* __restrict__ z_out,                // (BF, H)
    int n_tiles, int Mc, float inv_hw) {
  const int t = threadIdx.x;
  const int h = t >> 5;
  const int bf = blockIdx.x;
  float ctx[kD];
#pragma unroll
  for (int e = 0; e < kD; ++e) ctx[e] = 0.f;
  float z = 0.f;
  // conditioning tokens first, once (the TPU kernel's tile-0 init)
  for (int m = 0; m < Mc; ++m) {
    const size_t row = ((size_t)bf * Mc + m) * kH;
    const float pkc = expf(clamp_k(bf2f(ek[row + t])));
    z += pkc;
    const float pkcb = round_bf16(pkc);
#pragma unroll
    for (int e = 0; e < kD; ++e)
      ctx[e] = fmaf(pkcb, round_bf16(bf2f(ev[row + h * kD + e]) * inv_hw), ctx[e]);
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    const float* pc = part_ctx + ((size_t)bf * n_tiles + tile) * kD * kH;
#pragma unroll
    for (int e = 0; e < kD; ++e) ctx[e] += pc[e * kH + t];
    z += part_z[((size_t)bf * n_tiles + tile) * kH + t];
  }
#pragma unroll
  for (int e = 0; e < kD; ++e) ctx_out[((size_t)bf * kH + t) * kD + e] = ctx[e];
  z_out[(size_t)bf * kH + t] = z;
}

template <int kC>
__global__ void __launch_bounds__(kThreads) linear_apply_kernel(
    const __nv_bfloat16* __restrict__ x,      // (BF, N, C)
    const float* __restrict__ gamma,          // (C)
    const __nv_bfloat16* __restrict__ w_qkv,  // (C, 3H)
    const __nv_bfloat16* __restrict__ w_out,  // (H, C)
    const float* __restrict__ out_bias,       // (C)
    const float* __restrict__ ctx,            // (BF, heads, d, d)
    const float* __restrict__ z,              // (BF, H)
    __nv_bfloat16* __restrict__ out,          // (BF, N, C)
    int N, int tile, float scale) {
  // out-projection work split: rows per item so that kC * groups >= 256
  constexpr int kRR = kC >= 256 ? kR : kC / 32;
  constexpr int kGroups = kR / kRR;
  __shared__ __align__(16) float ys[kR * kC];
  __shared__ __align__(16) float qn_s[kR * kH];
  __shared__ __align__(16) float oh_s[kR * kH];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int h = warp;
  const int bf = blockIdx.y;
  const int n_begin = blockIdx.x * tile;
  const int n_end = min(N, n_begin + tile);
  const __nv_bfloat16* xb = x + (size_t)bf * N * kC;
  const __nv_bfloat16* wq = w_qkv + t;

  // column e = lane of head h's bf16-rounded context
  float cr[kD];
#pragma unroll
  for (int a = 0; a < kD; ++a)
    cr[a] = round_bf16(ctx[((size_t)bf * kH + h * kD + a) * kD + lane]);
  const float inv_z = 1.f / z[(size_t)bf * kH + t];

  for (int n0 = n_begin; n0 < n_end; n0 += kR) {
    {
      const int n = n0 + warp;
      const bool valid = n < n_end;
      vmt::layer_norm_row<kC>(xb + (size_t)(valid ? n : 0) * kC, gamma,
                              ys + warp * kC, valid, lane);
    }
    __syncthreads();
    float qa[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) qa[r] = 0.f;
#pragma unroll 2
    for (int c = 0; c < kC; c += 4) {
      float wqc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) wqc[u] = bf2f(wq[(size_t)(c + u) * 3 * kH]);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4 y4 = *reinterpret_cast<const float4*>(ys + r * kC + c);
        qa[r] = fmaf(y4.x, wqc[0], qa[r]);
        qa[r] = fmaf(y4.y, wqc[1], qa[r]);
        qa[r] = fmaf(y4.z, wqc[2], qa[r]);
        qa[r] = fmaf(y4.w, wqc[3], qa[r]);
      }
    }
    // per-head feature softmax of q with a PER-HEAD max shift
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float e = expf(qa[r] - vmt::warp_max(qa[r]));
      const float s = vmt::warp_sum(e);
      qn_s[r * kH + t] = round_bf16(e * (scale / s) * inv_z);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float* qrow = qn_s + r * kH + h * kD;
      float o = 0.f;
#pragma unroll
      for (int a = 0; a < kD; a += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qrow + a);
        o = fmaf(q4.x, cr[a], o);
        o = fmaf(q4.y, cr[a + 1], o);
        o = fmaf(q4.z, cr[a + 2], o);
        o = fmaf(q4.w, cr[a + 3], o);
      }
      oh_s[r * kH + t] = round_bf16(o);
    }
    __syncthreads();
    for (int item = t; item < kC * kGroups; item += kThreads) {
      const int c = item % kC;
      const int r0 = (item / kC) * kRR;
      float o[kRR];
#pragma unroll
      for (int rr = 0; rr < kRR; ++rr) o[rr] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kH; j += 4) {
        float w4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) w4[u] = bf2f(w_out[(size_t)(j + u) * kC + c]);
#pragma unroll
        for (int rr = 0; rr < kRR; ++rr) {
          const float4 a4 = *reinterpret_cast<const float4*>(oh_s + (r0 + rr) * kH + j);
          o[rr] = fmaf(a4.x, w4[0], o[rr]);
          o[rr] = fmaf(a4.y, w4[1], o[rr]);
          o[rr] = fmaf(a4.z, w4[2], o[rr]);
          o[rr] = fmaf(a4.w, w4[3], o[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRR; ++rr) {
        const int n = n0 + r0 + rr;
        if (n < n_end) {
          const size_t idx = ((size_t)bf * N + n) * kC + c;
          out[idx] = __float2bfloat16(bf2f(x[idx]) + out_bias[c] + o[rr]);
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
  linear_stats_partial<kC><<<dim3(n_tiles, BF), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const __nv_bfloat16*>(w_qkv), static_cast<float*>(part_ctx),
      static_cast<float*>(part_z), N, tile, inv_hw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  linear_stats_reduce<<<BF, kThreads, 0, stream>>>(
      static_cast<const float*>(part_ctx), static_cast<const float*>(part_z),
      static_cast<const __nv_bfloat16*>(ek),
      static_cast<const __nv_bfloat16*>(ev), static_cast<float*>(ctx),
      static_cast<float*>(z), n_tiles, Mc, inv_hw);
  return cudaGetLastError();
}

template <int kC>
cudaError_t apply_c(const void* x, const void* gamma, const void* w_qkv,
                    const void* w_out, const void* out_bias, const void* ctx,
                    const void* z, void* out, int BF, int N, int tile,
                    float scale, cudaStream_t stream) {
  const int n_tiles = (N + tile - 1) / tile;
  linear_apply_kernel<kC><<<dim3(n_tiles, BF), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const __nv_bfloat16*>(w_qkv),
      static_cast<const __nv_bfloat16*>(w_out),
      static_cast<const float*>(out_bias), static_cast<const float*>(ctx),
      static_cast<const float*>(z), static_cast<__nv_bfloat16*>(out), N, tile,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vmt_linear_stats(const void* x, const void* gamma,
                                const void* w_qkv, const void* ek,
                                const void* ev, void* part_ctx, void* part_z,
                                void* ctx, void* z, int BF, int N, int C,
                                int Mc, int heads, int tile, float inv_hw,
                                void* stream) {
  if (heads != kHeads || tile <= 0 || tile % kR || Mc < 0 ||
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

extern "C" int vmt_linear_apply(const void* x, const void* gamma,
                                const void* w_qkv, const void* w_out,
                                const void* out_bias, const void* ctx,
                                const void* z, void* out, int BF, int N, int C,
                                int heads, int tile, float scale,
                                void* stream) {
  if (heads != kHeads || tile <= 0 || tile % kR) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: return (int)apply_c<64>(x, gamma, w_qkv, w_out, out_bias, ctx, z, out, BF, N, tile, scale, st);
    case 128: return (int)apply_c<128>(x, gamma, w_qkv, w_out, out_bias, ctx, z, out, BF, N, tile, scale, st);
    case 256: return (int)apply_c<256>(x, gamma, w_qkv, w_out, out_bias, ctx, z, out, BF, N, tile, scale, st);
    case 512: return (int)apply_c<512>(x, gamma, w_qkv, w_out, out_bias, ctx, z, out, BF, N, tile, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
