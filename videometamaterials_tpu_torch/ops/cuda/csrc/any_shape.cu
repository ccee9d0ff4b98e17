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
// (PERF.md's table; chip_smoke.py prints each launch's bound), operations at
// 989 TFLOP/s bf16 for the projections at every path shape.
//
// Design: simple and right at any shape, in launches of four kinds.
//  - ln_rows_kernel (any_shape.cuh): one warp a row, two-pass, C any.
//  - any_gemm_kernel (any_shape.cuh): every projection (QKV, q, k || v,
//    the two out-projections with the residual in the epilogue) on the
//    tensor cores, at any M, N, K and any row pitch.
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
//  - linear stats as partial sums over 256-token tiles, one block a
//    (tile, head, frame), and an ordered reduce (no atomics: two launches
//    give the same bits); the apply's per-head softmax and q ctx one warp a
//    token. The stats take d up to 64 (the JAX model's linear blocks have
//    d = 32).
// The scratch between the launches (y, qkv or k || v in f32, acc or oh,
// the stats partials) comes from the wrapper.
#include <math_constants.h>

#include "any_attn.cuh"

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

// ---- linear stats: partials over token tiles, then an ordered reduce

constexpr int kStatThreads = 256;
constexpr int kSubT = 64;      // tokens staged at a time
constexpr int kMaxStatD = 64;  // d x d outputs, at most 16 a thread
constexpr int kOut = kMaxStatD * kMaxStatD / kStatThreads;

__device__ __forceinline__ float clamp_k(float k) {
  return fminf(fmaxf(k, -kClamp), kClamp);
}

// one block a (tile of `tile` tokens, head, frame); kv (BF, N, 2H) f32
__global__ void __launch_bounds__(kStatThreads) linear_any_stats_partial(
    const float* __restrict__ kv, float* __restrict__ part_ctx,
    float* __restrict__ part_z, int N, int tile, int heads, int d,
    float inv_hw) {
  extern __shared__ float smem_f[];
  const int t = threadIdx.x;
  const int tt = blockIdx.x, h = blockIdx.y, bf = blockIdx.z;
  const int tiles = gridDim.x, H = heads * d, dd = d * d;
  float* pkr = smem_f;             // [kSubT][d] bf16(exp(clip(k)))
  float* vr = pkr + kSubT * d;     // [kSubT][d] bf16(v / HW)
  float* pku = vr + kSubT * d;     // [kSubT][d] exp(clip(k))
  float acc[kOut];
#pragma unroll
  for (int u = 0; u < kOut; ++u) acc[u] = 0.f;
  float zacc = 0.f;
  const int n0 = tt * tile, n1 = min(N, n0 + tile);
  for (int sub = n0; sub < n1; sub += kSubT) {
    const int cnt = min(kSubT, n1 - sub);
    __syncthreads();
    for (int i = t; i < cnt * d; i += kStatThreads) {
      const int r = i / d, c = i % d;
      const float* row = kv + ((size_t)bf * N + sub + r) * 2 * H + h * d;
      const float pk = expf(clamp_k(row[c]));
      pku[i] = pk;
      pkr[i] = round_bf16(pk);
      vr[i] = round_bf16(row[H + c] * inv_hw);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      const int o = t + u * kStatThreads;
      if (o < dd) {
        const int ai = o / d, e = o % d;
        float c = acc[u];
        for (int r = 0; r < cnt; ++r) c = fmaf(pkr[r * d + ai], vr[r * d + e], c);
        acc[u] = c;
      }
    }
    if (t < d)
      for (int r = 0; r < cnt; ++r) zacc += pku[r * d + t];
  }
  float* pc = part_ctx + (((size_t)bf * tiles + tt) * heads + h) * dd;
#pragma unroll
  for (int u = 0; u < kOut; ++u) {
    const int o = t + u * kStatThreads;
    if (o < dd) pc[o] = acc[u];
  }
  if (t < d) part_z[((size_t)bf * tiles + tt) * H + h * d + t] = zacc;
}

// one block a (head, frame): the conditioning tokens first, once, then the
// tiles in order
__global__ void __launch_bounds__(kStatThreads) linear_any_stats_reduce(
    const float* __restrict__ part_ctx, const float* __restrict__ part_z,
    const bf16* __restrict__ ek, const bf16* __restrict__ ev,
    float* __restrict__ ctx, float* __restrict__ z, int tiles, int Mc,
    int heads, int d, float inv_hw) {
  const int t = threadIdx.x, h = blockIdx.x, bf = blockIdx.y;
  const int H = heads * d, dd = d * d;
  for (int o = t; o < dd; o += kStatThreads) {
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

// ---- linear apply: the per-head softmax of q and q ctx, one warp a token

constexpr int kApplyWarps = 8;

// q (BF, N, H) f32, ctx (BF, heads, d, d), z (BF, H) -> oh (BF, N, H) bf16
__global__ void __launch_bounds__(kApplyWarps * 32) linear_any_apply_heads(
    const float* __restrict__ q, const float* __restrict__ ctx,
    const float* __restrict__ z, bf16* __restrict__ oh, int BF, int N,
    int heads, int d, float scale) {
  extern __shared__ float smem_f[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * kApplyWarps + warp;
  if (row >= (size_t)BF * N) return;
  const int bf = row / N, H = heads * d;
  float* qn = smem_f + warp * d;
  const float* qr = q + row * H;
  for (int h = 0; h < heads; ++h) {
    const float* qh = qr + h * d;
    float m = -CUDART_INF_F;
    for (int ai = lane; ai < d; ai += 32) m = fmaxf(m, qh[ai]);
    m = vmt::warp_max(m);
    float s = 0.f;
    for (int ai = lane; ai < d; ai += 32) s += expf(qh[ai] - m);
    const float brd = scale / vmt::warp_sum(s);
    const float* zh = z + (size_t)bf * H + h * d;
    for (int ai = lane; ai < d; ai += 32)
      qn[ai] = round_bf16(expf(qh[ai] - m) * brd * (1.f / zh[ai]));
    __syncwarp();
    const float* ch = ctx + ((size_t)bf * heads + h) * d * d;
    for (int e = lane; e < d; e += 32) {
      float o = 0.f;
      for (int ai = 0; ai < d; ++ai) o = fmaf(qn[ai], round_bf16(ch[ai * d + e]), o);
      oh[row * H + h * d + e] = __float2bfloat16(o);
    }
    __syncwarp();
  }
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

// The linear stats at any shape (d <= 64). x (BF, N, C); w_qkv (C, 3H);
// ek/ev (BF, Mc, H) or null when Mc == 0; scratch y (BF, N, C) bf16, kv
// (BF, N, 2H) f32, part_ctx (BF, tiles, heads, d, d) and part_z
// (BF, tiles, H) f32 with tiles = ceil(N / tile); out ctx (BF, heads, d, d)
// and z (BF, H) f32.
extern "C" int vmt_linear_stats_any(
    const void* x, const void* gamma, const void* w_qkv, const void* ek,
    const void* ev, void* y, void* kv, void* part_ctx, void* part_z,
    void* ctx, void* z, int BF, int N, int C, int Mc, int heads, int d,
    int tile, float inv_hw, void* stream) {
  if (BF <= 0 || N <= 0 || C <= 0 || Mc < 0 || heads <= 0 || d <= 0 ||
      d > kMaxStatD || tile <= 0 || (Mc > 0 && (ek == nullptr || ev == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H = heads * d;
  const size_t R = (size_t)BF * N;
  cudaError_t err = launch_ln(static_cast<const bf16*>(x),
                              static_cast<const float*>(gamma),
                              static_cast<bf16*>(y), R, C, st);
  if (err != cudaSuccess) return (int)err;
  // k || v = y @ w_qkv[:, H:3H], float32
  err = launch_gemm(gemm(static_cast<const bf16*>(y), C, 0,
                         static_cast<const bf16*>(w_qkv) + H, 3 * H, 0, 1, kv,
                         2 * H, 0, (int)R, 2 * H, C),
                    1, kStoreF32, st);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + tile - 1) / tile;
  const size_t smem = (size_t)3 * kSubT * d * sizeof(float);
  linear_any_stats_partial<<<dim3(tiles, heads, BF), kStatThreads, smem, st>>>(
      static_cast<const float*>(kv), static_cast<float*>(part_ctx),
      static_cast<float*>(part_z), N, tile, heads, d, inv_hw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  linear_any_stats_reduce<<<dim3(heads, BF), kStatThreads, 0, st>>>(
      static_cast<const float*>(part_ctx), static_cast<const float*>(part_z),
      static_cast<const bf16*>(ek), static_cast<const bf16*>(ev),
      static_cast<float*>(ctx), static_cast<float*>(z), tiles, Mc, heads, d,
      inv_hw);
  return (int)cudaGetLastError();
}

// The linear apply at any shape. x (BF, N, C); w_qkv (C, 3H); w_out (H, C);
// out_bias (C) f32; ctx (BF, heads, d, d), z (BF, H) f32; scratch y
// (BF, N, C) bf16, q (BF, N, H) f32, oh (BF, N, H) bf16.
extern "C" int vmt_linear_apply_any(
    const void* x, const void* gamma, const void* w_qkv, const void* w_out,
    const void* out_bias, const void* ctx, const void* z, void* out, void* y,
    void* q, void* oh, int BF, int N, int C, int heads, int d, float scale,
    void* stream) {
  if (BF <= 0 || N <= 0 || C <= 0 || heads <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H = heads * d;
  const size_t R = (size_t)BF * N;
  cudaError_t err = launch_ln(static_cast<const bf16*>(x),
                              static_cast<const float*>(gamma),
                              static_cast<bf16*>(y), R, C, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm(gemm(static_cast<const bf16*>(y), C, 0,
                         static_cast<const bf16*>(w_qkv), 3 * H, 0, 1, q, H, 0,
                         (int)R, H, C),
                    1, kStoreF32, st);
  if (err != cudaSuccess) return (int)err;
  const size_t blocks = (R + kApplyWarps - 1) / kApplyWarps;
  linear_any_apply_heads<<<(unsigned)blocks, kApplyWarps * 32,
                           kApplyWarps * d * sizeof(float), st>>>(
      static_cast<const float*>(q), static_cast<const float*>(ctx),
      static_cast<const float*>(z), static_cast<bf16*>(oh), BF, N, heads, d,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  Gemm g = gemm(static_cast<const bf16*>(oh), H, 0,
                static_cast<const bf16*>(w_out), C, 0, 1, out, C, 0, (int)R, C,
                H);
  g.res = static_cast<const bf16*>(x);
  g.ldr = C;
  g.bias = static_cast<const float*>(out_bias);
  return (int)launch_gemm(g, 1, kResidual, st);
}
