// Fused temporal-attention block, backward, for sm_90a.
//
// Replaces videometamaterials_tpu/ops/pallas/fused_temporal_block.py:
// _bwd_kernel (pallas_call in _run_bwd_kernel): recompute the forward of
// the block (csrc/fused_temporal_block.cu) and emit every cotangent:
//   dx (B, F, S, C) bf16      = g + LN backward of dy
//   dgamma (C)                = sum_{b,f,s} xhat * dy
//   dw_all (F, C, 3H)         = sum_{b,s} y_f^T dqkv_f      (per frame)
//   dw_out (H, C)             = sum_{b,f,s} acc^T g
//   dbias (F, F+T, heads)     = sum_{b,s} ds
//   dek, dev (B, T, H)        = sum_{f,s} ds q, p g_acc    (per batch row)
// all f32 except dx. Per position and head, with g_acc = g @ w_out^T:
//   p    = softmax_j(q_i.k_j + bias_ij || q_i.ek_t + bias_it)
//   dp   = g_acc_i . [v_j || ev_t],  ds = p (dp - sum_j p dp)
//   dq_i = sum_j ds_ij k_j (+ ek),  dk_j = sum_i ds_ij q_i,
//   dv_j = sum_i bf16(p_ij) g_acc_i
// Roundings follow the JAX backward: q, k, v, y and the value weights p
// in bf16 (as the forward), dqkv in bf16 for the weight sums and dy, the
// softmax and every sum in f32; g_acc is kept in bf16. LN is two-pass.
//
// What bounds it on an H100, at the level-0 training shape (B = 4,
// S = 9216, C = 64, T = 11): it reads x and g and writes dx
// (3 * 4*11*9216*64 * 2 B = 156 MB) and does about 145 GFLOP (recomputed
// QKV 40, g_acc 13, attention backward ~10, dy 40, dw_all 40): the
// operations bound it (0.15 ms at the 989 TFLOP/s bf16 rate). This first
// kernel runs its products on the CUDA cores in fp32.
//
// Design. Attention is local to a spatial position, so dq, dk and dv are
// per-position work with the forward kernel's layout: one block of 256
// threads per (b, 8 positions); thread t owns hidden column t, warp h is
// head h. The block recomputes q, k, v (bf16, shared memory) and g_acc,
// then walks its positions: k, v and their gradients for all F frames sit
// in registers, a score or a dp is one warp reduction, and dq overwrites q
// (dk, dv overwrite k, v) in shared memory. dy = dqkv @ w_all[f]^T and the
// LN backward finish dx in the block. Everything else is a sum over all
// B*S positions. Per-block copies of dw_all do not fit (up to 17 MB at
// C = 512), so the block writes y and dqkv (bf16) to a scratch laid out
// frame-major, and a tiled contraction (reduce.cu) forms y_f^T dqkv_f per
// frame and acc^T g; dbias, dgamma and dek/dev leave each block as partial
// sums that an ordered column sum adds. No float atomics: two runs give
// the same bits. The TPU's selector/expand matmuls and colsum-via-MXU have
// no counterpart here.
#include <algorithm>

#include "common.cuh"
#include "reduce.cuh"

namespace {

using vmt::kH;
using vmt::kHeads;
using vmt::kThreads;
using vmt::bf2f;
using vmt::round_bf16;
using vmt::warp_sum;

constexpr int kP = 8;  // spatial positions per block (one LN row per warp)
constexpr int kQKV = 3 * kH;

template <int kF, int kT, int kC>
constexpr size_t smem_bytes() {
  return 4 * (size_t)kF * kP * kH * sizeof(__nv_bfloat16) +  // q k v g_acc
         (size_t)kP * kC * sizeof(float) +                    // row buffer
         2 * (size_t)kF * (kF + kT) * kHeads * sizeof(float); // bias, dbias
}

template <int kF, int kT, int kC>
__global__ void __launch_bounds__(kThreads, 1) temporal_bwd_kernel(
    const __nv_bfloat16* __restrict__ x,       // (B, F, S, C)
    const float* __restrict__ gamma,           // (C)
    const __nv_bfloat16* __restrict__ w_all,   // (F, C, 3H)
    const __nv_bfloat16* __restrict__ w_allT,  // (F, 3H, C)
    const __nv_bfloat16* __restrict__ w_outT,  // (C, H)
    const float* __restrict__ bias,            // (F, F+T, heads)
    const __nv_bfloat16* __restrict__ ek,      // (B, T, H) or null
    const __nv_bfloat16* __restrict__ ev,      // (B, T, H) or null
    const __nv_bfloat16* __restrict__ g,       // (B, F, S, C)
    __nv_bfloat16* __restrict__ dx,            // (B, F, S, C)
    __nv_bfloat16* __restrict__ y_out,         // (F, B, S, C) scratch
    __nv_bfloat16* __restrict__ dqkv_out,      // (F, B, S, 3H) scratch
    __nv_bfloat16* __restrict__ acc_out,       // (B, F, S, H) scratch
    float* __restrict__ part_dgamma,           // (B * nS, C)
    float* __restrict__ part_dbias,            // (B * nS, F (F+T) heads)
    float* __restrict__ part_dekv,             // (B, nS, 2, T, H)
    int B, int S) {
  constexpr int kNB = kF * (kF + kT) * kHeads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [F][P][H]
  __nv_bfloat16* ks = qs + kF * kP * kH;
  __nv_bfloat16* vs = ks + kF * kP * kH;
  __nv_bfloat16* gas = vs + kF * kP * kH;
  float* buf = reinterpret_cast<float*>(gas + kF * kP * kH);        // [P][C]
  float* bias_s = buf + kP * kC;
  float* dbias_s = bias_s + kNB;

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kP;
  const int nS = gridDim.x;

  for (int i = t; i < kNB; i += kThreads) {
    bias_s[i] = bias[i];
    dbias_s[i] = 0.f;
  }

  // ---- phase A: per frame, LN + folded QKV (as the forward), then
  // g_acc = g @ w_out^T for the block's positions
  for (int f = 0; f < kF; ++f) {
    {
      const int s = s0 + warp;
      const bool valid = s < S;
      const size_t row = (size_t)(b * kF + f) * S + (valid ? s : 0);
      vmt::layer_norm_row<kC>(x + row * kC, gamma, buf + warp * kC, valid,
                              lane);
      if (valid) {
        __nv_bfloat16* yr = y_out + ((size_t)(f * B + b) * S + s) * kC;
#pragma unroll
        for (int u = 0; u < kC / 32; ++u)
          yr[lane + 32 * u] = __float2bfloat16(buf[warp * kC + lane + 32 * u]);
      }
    }
    __syncthreads();
    float aq[kP], ak[kP], av[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) aq[p] = ak[p] = av[p] = 0.f;
    const __nv_bfloat16* wf = w_all + (size_t)f * kC * kQKV + t;
#pragma unroll 2
    for (int c = 0; c < kC; c += 4) {
      float wq[4], wk[4], wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const __nv_bfloat16* wr = wf + (size_t)(c + u) * kQKV;
        wq[u] = bf2f(wr[0]);
        wk[u] = bf2f(wr[kH]);
        wv[u] = bf2f(wr[2 * kH]);
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const float4 y4 = *reinterpret_cast<const float4*>(buf + p * kC + c);
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
    {
      const int s = s0 + warp;
      const bool valid = s < S;
      const __nv_bfloat16* gr = g + ((size_t)(b * kF + f) * S + (valid ? s : 0)) * kC;
#pragma unroll
      for (int u = 0; u < kC / 32; ++u)
        buf[warp * kC + lane + 32 * u] = valid ? bf2f(gr[lane + 32 * u]) : 0.f;
    }
    __syncthreads();
    float ga[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) ga[p] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kC; ++c) {
      const float w = bf2f(w_outT[(size_t)c * kH + t]);
#pragma unroll
      for (int p = 0; p < kP; ++p) ga[p] = fmaf(buf[p * kC + c], w, ga[p]);
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) gas[(f * kP + p) * kH + t] = __float2bfloat16(ga[p]);
    __syncthreads();
  }

  // ---- phase B: attention backward; warp = head, lane = feature
  const int h = warp;
  constexpr int kTT = kT > 0 ? kT : 1;
  float ekr[kTT], evr[kTT], dek[kTT], dev[kTT];
#pragma unroll
  for (int u = 0; u < kT; ++u) {
    ekr[u] = bf2f(ek[((size_t)b * kT + u) * kH + t]);
    evr[u] = bf2f(ev[((size_t)b * kT + u) * kH + t]);
    dek[u] = dev[u] = 0.f;
  }
  for (int p = 0; p < kP && s0 + p < S; ++p) {
    const int s = s0 + p;
    float kr[kF], vr[kF], dk[kF], dv[kF];
#pragma unroll
    for (int j = 0; j < kF; ++j) {
      kr[j] = bf2f(ks[(j * kP + p) * kH + t]);
      vr[j] = bf2f(vs[(j * kP + p) * kH + t]);
      dk[j] = dv[j] = 0.f;
    }
#pragma unroll 1
    for (int i = 0; i < kF; ++i) {
      const int oi = (i * kP + p) * kH + t;
      const float q = bf2f(qs[oi]);
      const float gi = bf2f(gas[oi]);
      const float* brow = bias_s + i * (kF + kT) * kHeads + h;
      float pr[kF + kT], dp[kF + kT];
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kF; ++j) {
        pr[j] = warp_sum(q * kr[j]) + brow[j * kHeads];
        m = fmaxf(m, pr[j]);
      }
#pragma unroll
      for (int u = 0; u < kT; ++u) {
        pr[kF + u] = warp_sum(q * ekr[u]) + brow[(kF + u) * kHeads];
        m = fmaxf(m, pr[kF + u]);
      }
      float z = 0.f;
#pragma unroll
      for (int j = 0; j < kF + kT; ++j) {
        pr[j] = expf(pr[j] - m);
        z += pr[j];
      }
      const float inv_z = 1.f / z;
      float acc = 0.f, tsum = 0.f;
#pragma unroll
      for (int j = 0; j < kF; ++j) {
        pr[j] *= inv_z;
        acc = fmaf(round_bf16(pr[j]), vr[j], acc);
        dp[j] = warp_sum(gi * vr[j]);
        tsum = fmaf(pr[j], dp[j], tsum);
      }
#pragma unroll
      for (int u = 0; u < kT; ++u) {
        pr[kF + u] *= inv_z;
        acc = fmaf(round_bf16(pr[kF + u]), evr[u], acc);
        dp[kF + u] = warp_sum(gi * evr[u]);
        tsum = fmaf(pr[kF + u], dp[kF + u], tsum);
      }
      acc_out[((size_t)(b * kF + i) * S + s) * kH + t] = __float2bfloat16(acc);
      float dq = 0.f;
      float* dbrow = dbias_s + i * (kF + kT) * kHeads + h;
#pragma unroll
      for (int j = 0; j < kF; ++j) {
        const float ds = pr[j] * (dp[j] - tsum);
        dq = fmaf(ds, kr[j], dq);
        dk[j] = fmaf(ds, q, dk[j]);
        dv[j] = fmaf(round_bf16(pr[j]), gi, dv[j]);
        if (lane == 0) dbrow[j * kHeads] += ds;
      }
#pragma unroll
      for (int u = 0; u < kT; ++u) {
        const float ds = pr[kF + u] * (dp[kF + u] - tsum);
        dq = fmaf(ds, ekr[u], dq);
        dek[u] = fmaf(ds, q, dek[u]);
        dev[u] = fmaf(round_bf16(pr[kF + u]), gi, dev[u]);
        if (lane == 0) dbrow[(kF + u) * kHeads] += ds;
      }
      qs[oi] = __float2bfloat16(dq);  // q_i at p is dead: reuse its slot
    }
#pragma unroll
    for (int j = 0; j < kF; ++j) {
      ks[(j * kP + p) * kH + t] = __float2bfloat16(dk[j]);
      vs[(j * kP + p) * kH + t] = __float2bfloat16(dv[j]);
    }
  }
  __syncthreads();

  // ---- phase C: per frame, dqkv to the scratch, dy = dqkv @ w_all[f]^T,
  // LN backward, dx = g + LN'(dy); dgamma accumulates per (warp, channel)
  constexpr int kRR = kC >= 256 ? kP : kC / 32;  // rows per dy item
  constexpr int kGroups = kP / kRR;
  float dgam[kC / 32];
#pragma unroll
  for (int u = 0; u < kC / 32; ++u) dgam[u] = 0.f;
  for (int f = 0; f < kF; ++f) {
    for (int item = t; item < kP * kQKV; item += kThreads) {
      const int p = item / kQKV, j = item % kQKV;
      if (s0 + p < S) {
        const __nv_bfloat16* src = j < kH ? qs : (j < 2 * kH ? ks : vs);
        dqkv_out[((size_t)(f * B + b) * S + s0 + p) * kQKV + j] =
            src[(f * kP + p) * kH + (j % kH)];
      }
    }
    for (int item = t; item < kC * kGroups; item += kThreads) {
      const int c = item % kC;
      const int r0 = (item / kC) * kRR;
      float o[kRR];
#pragma unroll
      for (int rr = 0; rr < kRR; ++rr) o[rr] = 0.f;
      const __nv_bfloat16* wt = w_allT + (size_t)f * kQKV * kC + c;
#pragma unroll 1
      for (int part = 0; part < 3; ++part) {
        const __nv_bfloat16* src = part == 0 ? qs : (part == 1 ? ks : vs);
        const __nv_bfloat16* wp = wt + (size_t)part * kH * kC;
#pragma unroll 2
        for (int j = 0; j < kH; j += 8) {
          float w8[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) w8[u] = bf2f(wp[(size_t)(j + u) * kC]);
#pragma unroll
          for (int rr = 0; rr < kRR; ++rr) {
            float a[8];
            vmt::unpack8(*reinterpret_cast<const uint4*>(
                             src + (f * kP + r0 + rr) * kH + j), a);
#pragma unroll
            for (int u = 0; u < 8; ++u) o[rr] = fmaf(a[u], w8[u], o[rr]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRR; ++rr) buf[(r0 + rr) * kC + c] = o[rr];
    }
    __syncthreads();
    {
      const int s = s0 + warp;
      if (s < S) {
        const size_t row = ((size_t)(b * kF + f) * S + s) * kC;
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
          const float dyv = buf[warp * kC + c];
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
          const float dxh = buf[warp * kC + c] * gamma[c];
          const float d = rstd * (dxh - m1 - xv[u] * m2);
          dx[row + c] = __float2bfloat16(bf2f(g[row + c]) + d);
        }
      }
    }
    __syncthreads();
  }

  // ---- per-block partial sums: dgamma (warps added in order), dbias,
  // dek/dev
  const size_t blk = (size_t)b * nS + blockIdx.x;
#pragma unroll
  for (int u = 0; u < kC / 32; ++u) buf[warp * kC + lane + 32 * u] = dgam[u];
  __syncthreads();
  for (int c = t; c < kC; c += kThreads) {
    float sgm = 0.f;
#pragma unroll
    for (int w = 0; w < kP; ++w) sgm += buf[w * kC + c];
    part_dgamma[blk * kC + c] = sgm;
  }
  for (int i = t; i < kNB; i += kThreads) part_dbias[blk * kNB + i] = dbias_s[i];
  if (kT > 0) {
    float* pd = part_dekv + blk * 2 * kT * kH;
#pragma unroll
    for (int u = 0; u < kT; ++u) {
      pd[u * kH + t] = dek[u];
      pd[(kT + u) * kH + t] = dev[u];
    }
  }
}

struct Work {
  __nv_bfloat16 *y, *dqkv, *acc;
  float *pdgamma, *pdbias, *pdekv, *ws_contract, *ws_colsum;
  size_t bytes;
};

Work carve(void* base, int B, int F, int S, int C, int T) {
  const int nS = (S + kP - 1) / kP;
  const size_t rows = (size_t)B * S;
  const int nb = F * (F + T) * kHeads;
  size_t sz[8] = {
      vmt::align256(F * rows * C * 2), vmt::align256(F * rows * kQKV * 2),
      vmt::align256(F * rows * kH * 2),
      vmt::align256((size_t)B * nS * C * 4),
      vmt::align256((size_t)B * nS * nb * 4),
      vmt::align256((size_t)B * nS * 2 * T * kH * 4 + 4),
      vmt::align256(std::max(vmt::contract_workspace(F, B * S, C, kQKV),
                             vmt::contract_workspace(1, B * F * S, kH, C))),
      vmt::align256(std::max(
          std::max(vmt::colsum_workspace(1, B * nS, C),
                   vmt::colsum_workspace(1, B * nS, nb)),
          vmt::colsum_workspace(B, nS, 2 * T * kH)) + 4)};
  Work w{};
  char* p = static_cast<char*>(base);
  size_t off = 0;
  void* ptrs[8];
  for (int i = 0; i < 8; ++i) {
    ptrs[i] = p ? p + off : nullptr;
    off += sz[i];
  }
  w.y = static_cast<__nv_bfloat16*>(ptrs[0]);
  w.dqkv = static_cast<__nv_bfloat16*>(ptrs[1]);
  w.acc = static_cast<__nv_bfloat16*>(ptrs[2]);
  w.pdgamma = static_cast<float*>(ptrs[3]);
  w.pdbias = static_cast<float*>(ptrs[4]);
  w.pdekv = static_cast<float*>(ptrs[5]);
  w.ws_contract = static_cast<float*>(ptrs[6]);
  w.ws_colsum = static_cast<float*>(ptrs[7]);
  w.bytes = off;
  return w;
}

template <int kF, int kT, int kC>
cudaError_t launch(const void* x, const void* gamma, const void* w_all,
                   const void* w_allT, const void* w_outT, const void* bias,
                   const void* ek, const void* ev, const void* g, void* dx,
                   void* dgamma, void* dw_all, void* dw_out, void* dbias,
                   void* dekv, void* workspace, int B, int S,
                   cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr size_t smem = smem_bytes<kF, kT, kC>();
  auto kernel = temporal_bwd_kernel<kF, kT, kC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const Work w = carve(workspace, B, kF, S, kC, kT);
  const int nS = (S + kP - 1) / kP;
  kernel<<<dim3(nS, B), kThreads, smem, stream>>>(
      static_cast<const bf*>(x), static_cast<const float*>(gamma),
      static_cast<const bf*>(w_all), static_cast<const bf*>(w_allT),
      static_cast<const bf*>(w_outT), static_cast<const float*>(bias),
      static_cast<const bf*>(ek), static_cast<const bf*>(ev),
      static_cast<const bf*>(g), static_cast<bf*>(dx), w.y, w.dqkv, w.acc,
      w.pdgamma, w.pdbias, w.pdekv, B, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // dw_all[f] = y_f^T dqkv_f over the B*S rows of frame f
  err = vmt::launch_contract(w.y, w.dqkv, static_cast<float*>(dw_all), kF,
                             B * S, kC, kQKV, (size_t)B * S * kC,
                             (size_t)B * S * kQKV, w.ws_contract, stream);
  if (err != cudaSuccess) return err;
  // dw_out = acc^T g over all B*F*S rows
  err = vmt::launch_contract(w.acc, static_cast<const bf*>(g),
                             static_cast<float*>(dw_out), 1, B * kF * S, kH,
                             kC, 0, 0, w.ws_contract, stream);
  if (err != cudaSuccess) return err;
  err = vmt::launch_colsum(w.pdgamma, static_cast<float*>(dgamma), 1, B * nS,
                           kC, w.ws_colsum, stream);
  if (err != cudaSuccess) return err;
  err = vmt::launch_colsum(w.pdbias, static_cast<float*>(dbias), 1, B * nS,
                           kF * (kF + kT) * kHeads, w.ws_colsum, stream);
  if (err != cudaSuccess || kT == 0) return err;
  return vmt::launch_colsum(w.pdekv, static_cast<float*>(dekv), B, nS,
                            2 * kT * kH, w.ws_colsum, stream);
}

template <int kT>
cudaError_t launch_c(int C, const void* x, const void* gamma,
                     const void* w_all, const void* w_allT,
                     const void* w_outT, const void* bias, const void* ek,
                     const void* ev, const void* g, void* dx, void* dgamma,
                     void* dw_all, void* dw_out, void* dbias, void* dekv,
                     void* ws, int B, int S, cudaStream_t st) {
#define VMT_CASE(CC)                                                        \
  case CC:                                                                  \
    return launch<11, kT, CC>(x, gamma, w_all, w_allT, w_outT, bias, ek,    \
                              ev, g, dx, dgamma, dw_all, dw_out, dbias,     \
                              dekv, ws, B, S, st);
  switch (C) {
    VMT_CASE(64)
    VMT_CASE(128)
    VMT_CASE(256)
    VMT_CASE(512)
    default: return cudaErrorInvalidValue;
  }
#undef VMT_CASE
}

}  // namespace

// Workspace bytes of vmt_temporal_block_bwd for these sizes.
extern "C" size_t vmt_temporal_block_bwd_workspace(int B, int F, int S, int C,
                                                   int T) {
  return carve(nullptr, B, F, S, C, T).bytes;
}

// dekv: (B, 2, T, H) f32 -- dek then dev -- or null when T == 0.
extern "C" int vmt_temporal_block_bwd(
    const void* x, const void* gamma, const void* w_all, const void* w_allT,
    const void* w_outT, const void* bias, const void* ek, const void* ev,
    const void* g, void* dx, void* dgamma, void* dw_all, void* dw_out,
    void* dbias, void* dekv, void* workspace, int B, int F, int S, int C,
    int T, int heads, void* stream) {
  if (F != 11 || heads != kHeads) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0)
    return (int)launch_c<0>(C, x, gamma, w_all, w_allT, w_outT, bias, nullptr,
                            nullptr, g, dx, dgamma, dw_all, dw_out, dbias,
                            nullptr, workspace, B, S, st);
  if (T == 11)
    return (int)launch_c<11>(C, x, gamma, w_all, w_allT, w_outT, bias, ek, ev,
                             g, dx, dgamma, dw_all, dw_out, dbias, dekv,
                             workspace, B, S, st);
  return (int)cudaErrorInvalidValue;
}
