// Fused spatial linear-attention block, "head" layout forward, for sm_90a.
//
// Replaces videometamaterials_tpu/ops/pallas/fused_linear_block.py:_kernel
// (pallas_call in _run_kernel, taken with layout="head", which
// VMT_LINEAR_LAYOUT=head selects) -> vmt_linear_head.
//
// Per folded frame (N tokens + Mc conditioning tokens stacked in front),
// heads = 8 of d = 32, hidden H = 256:
//   y    = bf16(LN(x) * gamma)                 two-pass, eps 1e-5
//   q, k, v = y @ W_qkv                        float32 from here on
//   Q    = softmax_head(q) * scale             per-head max shift
//   P    = softmax_tok([ek || k])              per feature, max-shifted,
//                                              UNCLAMPED (the merged stats
//                                              clamp k at +-60 instead)
//   ctx_h = P_h^T [ev || v]_h / HW             (d x d) per head
//   out  = bf16(x + out_bias + sum_h (Q_h ctx_h) W_out_h)
// Roundings: at out, and the stats pass's bf16 operands of ctx (1. below;
// tests/test_torch_port_linear_bwd_rounding.py holds them against the JAX
// kernel); W_out holds the bf16 weight the JAX model casts
// for the kernel, read in float32 as the TPU kernel reads it.
//
// What bounds it on an H100, at the sampling level-0 shape (BF = 22,
// N = 9216, C = 64): it reads x and writes out (52 MB, 15.5 us at
// 3.35 TB/s); its operations are, on bf16 operands, the QKV projection,
// 2 N C 3H a frame, and the stats pass's ctx, 2 N H d (23.3 GFLOP, 24 us
// at the 989 TFLOP/s bf16 tensor-core rate), and the products the apply
// keeps in float32: Q ctx, 2 N H d, and the out-projection, 2 N H C
// (10.0 GFLOP, 149 us at the 67 TFLOP/s fp32 rate). The operations bound
// it (172 us); the apply runs its products on the CUDA cores in fp32.
//
// Design. The TPU runs one grid cell per folded frame with all N tokens
// in VMEM: 22-44 blocks would leave most of the 132 SMs idle and hold far
// more than a block's shared memory. Here the token softmax is split:
//   1. stats (linear_stats.cuh, the backward kernel's first pass without
//      g, clip = 0): per (frame, 1024-token chunk, head pair) on the tensor
//      cores, each 64-token sub-tile exponentiating against the running
//      column max, the partial sums of exp(k - m) and bf16(exp(k - m))
//      bf16(v / HW) (two roundings the TPU kernel does not make), then an
//      ordered merge per frame with the cond tokens folded in once: the
//      normalised ctx, deterministic (no atomics);
//   2. apply (this file): per (frame, 64-token tile), thread t = hidden
//      column t (head t / 32) computes q column t for 8 tokens per weight
//      load, the feature softmax is a warp reduction, thread (h, e) keeps
//      column e of head h's ctx in registers for oh = Q ctx, and the
//      out-projection, bias and residual are fused.
#include "common.cuh"
#include "linear_stats.cuh"

namespace {

using vmt::kD;
using vmt::kH;
using vmt::kHeads;
using vmt::kThreads;
using vmt::bf2f;

constexpr int kR = 8;  // tokens per chunk (one LN row per warp)
static_assert(kR == kThreads / 32, "one warp per token in the LN phase");
constexpr int kQKV = 3 * kH;

template <int kC>
__global__ void __launch_bounds__(kThreads) linear_head_apply(
    const __nv_bfloat16* __restrict__ x,      // (BF, N, C)
    const float* __restrict__ gamma,          // (C)
    const __nv_bfloat16* __restrict__ w_qkv,  // (C, 3H)
    const __nv_bfloat16* __restrict__ w_out,  // (H, C)
    const float* __restrict__ out_bias,       // (C)
    const float* __restrict__ ctxn,           // (BF, H, d): [h*d + a][e]
    __nv_bfloat16* __restrict__ out,          // (BF, N, C)
    int N, int tile, float scale) {
  // out-projection work split: rows per item so that kC * groups >= 256
  constexpr int kRR = kC >= 256 ? kR : kC / 32;
  constexpr int kGroups = kR / kRR;
  __shared__ __align__(16) float ys[kR * kC];
  __shared__ __align__(16) float q_s[kR * kH];
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

  // column e = lane of head h's normalised context
  float cc[kD];
#pragma unroll
  for (int a = 0; a < kD; ++a)
    cc[a] = ctxn[((size_t)bf * kH + h * kD + a) * kD + lane];

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
      for (int u = 0; u < 4; ++u) wqc[u] = bf2f(wq[(size_t)(c + u) * kQKV]);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4 y4 = *reinterpret_cast<const float4*>(ys + r * kC + c);
        qa[r] = fmaf(y4.x, wqc[0], qa[r]);
        qa[r] = fmaf(y4.y, wqc[1], qa[r]);
        qa[r] = fmaf(y4.z, wqc[2], qa[r]);
        qa[r] = fmaf(y4.w, wqc[3], qa[r]);
      }
    }
    // q feature softmax with the per-head max shift, then the scale
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float e = expf(qa[r] - vmt::warp_max(qa[r]));
      q_s[r * kH + t] = e * (scale / vmt::warp_sum(e));
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float* qrow = q_s + r * kH + h * kD;
      float o = 0.f;
#pragma unroll
      for (int a = 0; a < kD; a += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qrow + a);
        o = fmaf(q4.x, cc[a], o);
        o = fmaf(q4.y, cc[a + 1], o);
        o = fmaf(q4.z, cc[a + 2], o);
        o = fmaf(q4.w, cc[a + 3], o);
      }
      oh_s[r * kH + t] = o;
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

// the stats buffers carved from one workspace
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

template <int kC>
cudaError_t apply_c(const void* x, const void* gamma, const void* w_qkv,
                    const void* w_out, const void* out_bias, const float* ctxn,
                    void* out, int BF, int N, int tile, float scale,
                    cudaStream_t stream) {
  const int n_tiles = (N + tile - 1) / tile;
  linear_head_apply<kC><<<dim3(n_tiles, BF), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const __nv_bfloat16*>(w_qkv),
      static_cast<const __nv_bfloat16*>(w_out),
      static_cast<const float*>(out_bias), ctxn,
      static_cast<__nv_bfloat16*>(out), N, tile, scale);
  return cudaGetLastError();
}

}  // namespace

// Workspace bytes of vmt_linear_head for these sizes.
extern "C" size_t vmt_linear_head_workspace(int BF, int N) {
  size_t total = 0;
  carve(nullptr, BF, N, &total);
  return total;
}

// ek/ev: (BF, Mc, H) bf16, or null when Mc == 0. apply_tile: tokens per
// block of the apply pass, a multiple of 8.
extern "C" int vmt_linear_head(const void* x, const void* gamma,
                               const void* w_qkv, const void* w_out,
                               const void* out_bias, const void* ek,
                               const void* ev, void* out, void* workspace,
                               int BF, int N, int C, int Mc, int heads,
                               int apply_tile, float scale, float inv_hw,
                               void* stream) {
  if (heads != kHeads || BF <= 0 || N <= 0 || apply_tile <= 0 ||
      apply_tile % kR || Mc < 0 || (Mc > 0 && (ek == nullptr || ev == nullptr)))
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
  switch (C) {
    case 64: return (int)apply_c<64>(x, gamma, w_qkv, w_out, out_bias, s.ctxn, out, BF, N, apply_tile, scale, st);
    case 128: return (int)apply_c<128>(x, gamma, w_qkv, w_out, out_bias, s.ctxn, out, BF, N, apply_tile, scale, st);
    case 256: return (int)apply_c<256>(x, gamma, w_qkv, w_out, out_bias, s.ctxn, out, BF, N, apply_tile, scale, st);
    default: return (int)apply_c<512>(x, gamma, w_qkv, w_out, out_bias, s.ctxn, out, BF, N, apply_tile, scale, st);
  }
}
