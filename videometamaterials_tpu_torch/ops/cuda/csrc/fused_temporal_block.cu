// Fused temporal-attention block, forward, for sm_90a.
//
// Replaces videometamaterials_tpu/ops/pallas/fused_temporal_block.py:_kernel
// (pallas_call in _run_kernel), has_cond both ways, in its two uses:
//   split softmax layout                  -> vmt_temporal_block_fwd, p null
//   merged layout with emit_p (the 'saved' backward plan's forward,
//   _savedp_fwd)                          -> vmt_temporal_block_fwd, p set
// The merged layout computes the split layout's out bit for bit (the JAX
// test pins it); emit_p adds one store: the bf16 softmax weights the value
// sum consumes, p[b, i, s, jg * 8 + h] (key group jg = frame j, then cond
// token t). The TPU's full-lane concatenation of the scores is a lane
// layout trick with no counterpart here: the weights are already in
// registers, one head per warp.
//
// Per batch row b and spatial position s, over F = 11 frames and T cond
// tokens (T = 11, or 0 for the init block), heads = 8 of d = 32:
//   y_f   = bf16(LN(x_f) * gamma)              two-pass, scale-only, eps 1e-5
//   qkv_f = bf16(y_f @ w_all[f])               rotary and 1/sqrt(d) are folded
//                                              into the per-frame w_all
//   p_ij  = bf16(softmax_j(q_i.k_j + bias_ij || q_i.ek_t + bias_it))
//   acc_i = bf16(sum_j p_ij v_j + sum_t p_it ev_t)
//   out_i = bf16(x_i + acc_i @ w_out)
// The three bf16 roundings are the JAX kernel's (:124, :226, :235).
//
// What bounds it on an H100, at the level-0 shape (B' = 2, S = 9216, C = 64,
// T = 11): it must read x and write out, 2 * 2*11*9216*64 * 2 B = 52 MB
// (15.5 us at 3.35 TB/s), and do 31.1 GFLOP (QKV 19.9, out-proj 6.6,
// scores + values 4.6), 31 us at the 989 TFLOP/s bf16 tensor-core rate: the
// operations bound it. This first kernel runs its products on the CUDA
// cores in fp32 (tensor cores, wgmma and TMA come later), so it sits well
// above that bound.
//
// Design: one block of 256 threads per (b, 8 positions). Positions are
// independent, so blocks need no communication and the qkv expansion (12x
// the input width), the scores and the softmax weights never leave the SM:
// device memory sees one read of x and one write of out, plus weights that
// stay in L2. Thread t owns hidden column t: in the projection it computes
// q/k/v column t for 8 positions (8 x 3 FMAs per weight load, w_all[f]
// streamed from L2 instead of staged: 768 KB at C = 512 is over the 227 KB a
// block can hold). In the attention phase warp h is head h and lane d is
// the head feature d, so a score is one warp reduction and the value sum
// needs no communication; the 22 scores and their softmax stay in fp32
// registers (frames and tokens are template constants). acc overwrites q
// in shared memory, and the out-projection runs once over all 88 rows.
// The TPU layout tricks (selector/expand matmuls, Ek_sel/Ev_exp fold) have
// no counterpart here: ek and ev are read directly. With p, lane j of warp
// h stores weight j of head h, the same rounded value the value sum uses,
// so out stays bit-equal to the launch without p. p adds
// B*F*S*(F+T)*8*2 bytes of writes (143 MB for each conditioned level-0
// block at batch 4; 43 us at 3.35 TB/s): the operations still bound it.
#include "common.cuh"

namespace {

using vmt::kH;
using vmt::kHeads;
using vmt::kThreads;
using vmt::bf2f;
using vmt::round_bf16;
using vmt::warp_sum;

constexpr int kP = 8;  // spatial positions per block (one LN row per warp)
static_assert(kP == kThreads / 32, "one warp per position in the LN phase");

template <int kF, int kT, int kC, bool kEmitP>
__global__ void __launch_bounds__(kThreads, 1) temporal_fwd_kernel(
    const __nv_bfloat16* __restrict__ x,      // (B, F, S, C)
    const float* __restrict__ gamma,          // (C)
    const __nv_bfloat16* __restrict__ w_all,  // (F, C, 3H)
    const __nv_bfloat16* __restrict__ w_out,  // (H, C)
    const float* __restrict__ bias,           // (F, F+T, heads)
    const __nv_bfloat16* __restrict__ ek,     // (B, T, H) or null
    const __nv_bfloat16* __restrict__ ev,     // (B, T, H) or null
    __nv_bfloat16* __restrict__ out,          // (B, F, S, C)
    __nv_bfloat16* __restrict__ p_out,        // (B, F, S, (F+T)*heads), kEmitP
    int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [F][P][H]
  __nv_bfloat16* ks = qs + kF * kP * kH;
  __nv_bfloat16* vs = ks + kF * kP * kH;
  float* ys = reinterpret_cast<float*>(vs + kF * kP * kH);         // [P][C]
  __shared__ float bias_s[kF * (kF + kT) * kHeads];

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kP;

  for (int i = t; i < kF * (kF + kT) * kHeads; i += kThreads) bias_s[i] = bias[i];

  // ---- phase A: per frame, LN of the block's positions, then the folded
  // QKV projection (thread t: columns t, H + t, 2H + t)
  for (int f = 0; f < kF; ++f) {
    {
      const int s = s0 + warp;
      const bool valid = s < S;
      const __nv_bfloat16* xrow =
          x + ((size_t)(b * kF + f) * S + (valid ? s : 0)) * kC;
      vmt::layer_norm_row<kC>(xrow, gamma, ys + warp * kC, valid, lane);
    }
    __syncthreads();
    float aq[kP], ak[kP], av[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) aq[p] = ak[p] = av[p] = 0.f;
    const __nv_bfloat16* wf = w_all + (size_t)f * kC * 3 * kH + t;
#pragma unroll 2
    for (int c = 0; c < kC; c += 4) {
      float wq[4], wk[4], wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const __nv_bfloat16* wr = wf + (size_t)(c + u) * 3 * kH;
        wq[u] = bf2f(wr[0]);
        wk[u] = bf2f(wr[kH]);
        wv[u] = bf2f(wr[2 * kH]);
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const float4 y4 = *reinterpret_cast<const float4*>(ys + p * kC + c);
        const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          aq[p] = fmaf(yv[u], wq[u], aq[p]);
          ak[p] = fmaf(yv[u], wk[u], ak[p]);
          av[p] = fmaf(yv[u], wv[u], av[p]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int o = (f * kP + p) * kH + t;
      qs[o] = __float2bfloat16(aq[p]);
      ks[o] = __float2bfloat16(ak[p]);
      vs[o] = __float2bfloat16(av[p]);
    }
    __syncthreads();
  }

  // ---- phase B: attention; warp = head, lane = feature within the head
  const int h = warp;
  float ekr[kT > 0 ? kT : 1], evr[kT > 0 ? kT : 1];
#pragma unroll
  for (int u = 0; u < kT; ++u) {
    ekr[u] = bf2f(ek[((size_t)b * kT + u) * kH + t]);
    evr[u] = bf2f(ev[((size_t)b * kT + u) * kH + t]);
  }
  for (int p = 0; p < kP && s0 + p < S; ++p) {
#pragma unroll 1
    for (int i = 0; i < kF; ++i) {
      const int oi = (i * kP + p) * kH + t;
      const float* brow = bias_s + i * (kF + kT) * kHeads + h;
      const float q = bf2f(qs[oi]);
      float sc[kF + kT];
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kF; ++j) {
        sc[j] = warp_sum(q * bf2f(ks[(j * kP + p) * kH + t])) + brow[j * kHeads];
        m = fmaxf(m, sc[j]);
      }
#pragma unroll
      for (int u = 0; u < kT; ++u) {
        sc[kF + u] = warp_sum(q * ekr[u]) + brow[(kF + u) * kHeads];
        m = fmaxf(m, sc[kF + u]);
      }
      float z = 0.f;
#pragma unroll
      for (int j = 0; j < kF + kT; ++j) {
        sc[j] = expf(sc[j] - m);
        z += sc[j];
      }
      const float inv_z = 1.f / z;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kF; ++j)
        acc = fmaf(round_bf16(sc[j] * inv_z), bf2f(vs[(j * kP + p) * kH + t]), acc);
#pragma unroll
      for (int u = 0; u < kT; ++u)
        acc = fmaf(round_bf16(sc[kF + u] * inv_z), evr[u], acc);
      qs[oi] = __float2bfloat16(acc);  // q_i at p is dead: reuse its slot
      if (kEmitP) {
        // lane jg writes key group jg's weight: the value sum's operand
        float pj = 0.f;
#pragma unroll
        for (int j = 0; j < kF + kT; ++j)
          if (lane == j) pj = sc[j] * inv_z;
        if (lane < kF + kT)
          p_out[(((size_t)(b * kF + i) * S + s0 + p) * (kF + kT) + lane) *
                    kHeads + h] = __float2bfloat16(pj);
      }
    }
  }
  __syncthreads();

  // ---- phase C: out = x + acc @ w_out over all rows; item = (column, frame)
  for (int item = t; item < kC * kF; item += kThreads) {
    const int c = item % kC;
    const int i = item / kC;
    const __nv_bfloat16* arow = qs + i * kP * kH;
    float o[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) o[p] = 0.f;
#pragma unroll 2
    for (int j = 0; j < kH; j += 8) {
      float w8[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) w8[u] = bf2f(w_out[(size_t)(j + u) * kC + c]);
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        float a[8];
        vmt::unpack8(*reinterpret_cast<const uint4*>(arow + p * kH + j), a);
#pragma unroll
        for (int u = 0; u < 8; ++u) o[p] = fmaf(a[u], w8[u], o[p]);
      }
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int s = s0 + p;
      if (s < S) {
        const size_t idx = ((size_t)(b * kF + i) * S + s) * kC + c;
        out[idx] = __float2bfloat16(bf2f(x[idx]) + o[p]);
      }
    }
  }
}

template <int kF, int kT, int kC, bool kEmitP>
cudaError_t launch(const void* x, const void* gamma, const void* w_all,
                   const void* w_out, const void* bias, const void* ek,
                   const void* ev, void* out, void* p_out, int B, int S,
                   cudaStream_t stream) {
  const size_t smem = 3 * (size_t)kF * kP * kH * sizeof(__nv_bfloat16) +
                      (size_t)kP * kC * sizeof(float);
  auto kernel = temporal_fwd_kernel<kF, kT, kC, kEmitP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kP - 1) / kP, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const __nv_bfloat16*>(w_all),
      static_cast<const __nv_bfloat16*>(w_out),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(ek),
      static_cast<const __nv_bfloat16*>(ev), static_cast<__nv_bfloat16*>(out),
      static_cast<__nv_bfloat16*>(p_out), S);
  return cudaGetLastError();
}

template <int kT, bool kEmitP>
cudaError_t launch_c(int C, const void* x, const void* gamma, const void* w_all,
                     const void* w_out, const void* bias, const void* ek,
                     const void* ev, void* out, void* p_out, int B, int S,
                     cudaStream_t stream) {
  switch (C) {
    case 64: return launch<11, kT, 64, kEmitP>(x, gamma, w_all, w_out, bias, ek, ev, out, p_out, B, S, stream);
    case 128: return launch<11, kT, 128, kEmitP>(x, gamma, w_all, w_out, bias, ek, ev, out, p_out, B, S, stream);
    case 256: return launch<11, kT, 256, kEmitP>(x, gamma, w_all, w_out, bias, ek, ev, out, p_out, B, S, stream);
    case 512: return launch<11, kT, 512, kEmitP>(x, gamma, w_all, w_out, bias, ek, ev, out, p_out, B, S, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kEmitP>
cudaError_t launch_t(int T, int C, const void* x, const void* gamma,
                     const void* w_all, const void* w_out, const void* bias,
                     const void* ek, const void* ev, void* out, void* p_out,
                     int B, int S, cudaStream_t stream) {
  if (T == 0)
    return launch_c<0, kEmitP>(C, x, gamma, w_all, w_out, bias, nullptr, nullptr, out, p_out, B, S, stream);
  if (T == 11)
    return launch_c<11, kEmitP>(C, x, gamma, w_all, w_out, bias, ek, ev, out, p_out, B, S, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// p: (B, F, S, (F+T)*heads) bf16 softmax weights out, or null for none.
extern "C" int vmt_temporal_block_fwd(const void* x, const void* gamma,
                                      const void* w_all, const void* w_out,
                                      const void* bias, const void* ek,
                                      const void* ev, void* out, void* p,
                                      int B, int F, int S, int C, int T,
                                      int heads, void* stream) {
  if (F != 11 || heads != kHeads) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p != nullptr)
    return (int)launch_t<true>(T, C, x, gamma, w_all, w_out, bias, ek, ev, out, p, B, S, st);
  return (int)launch_t<false>(T, C, x, gamma, w_all, w_out, bias, ek, ev, out, nullptr, B, S, st);
}

extern "C" const char* vmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
