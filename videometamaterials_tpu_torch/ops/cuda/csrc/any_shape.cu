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
//  - temporal_any_attn_kernel: one warp a (batch row, position, head),
//    four a block; the keys (F frames, then T tokens) in chunks of 32, one
//    a lane, staged in shared memory as bf16; two passes over the chunks,
//    so any F + T fits: the running max and sum of each query's scores,
//    then the scores again, bf16 p and the value sum (lanes over the
//    head's features). Where one chunk holds every key (F + T <= 32) it
//    is staged once and each lane keeps its score from the first pass.
//    With a p pointer (row 2, the saved plan's forward) the second pass
//    also writes each bf16 p into the (B, F, S, (F+T) heads) layout with
//    key-group-major lanes; nothing else changes, so out is bit-equal to
//    the launch without p.
//  - linear stats as partial sums over 256-token tiles, one block a
//    (tile, head, frame), and an ordered reduce (no atomics: two launches
//    give the same bits); the apply's per-head softmax and q ctx one warp a
//    token. The stats take d up to 64 (the JAX model's linear blocks have
//    d = 32).
// The scratch between the launches (y, qkv or k || v in f32, acc or oh,
// the stats partials) comes from the wrapper.
#include <math_constants.h>

#include "any_shape.cuh"

namespace {

constexpr float kClamp = 60.f;

// ---- temporal attention, one warp a (batch row, position, head)

constexpr int kKC = 32;        // keys a chunk, one a lane
constexpr int kAttnWarps = 4;  // a block at most, as shared memory allows

// 32-bit words a staged key row takes: odd, so the lanes' rows (one a
// lane) fall in 32 different banks
__host__ __device__ inline int key_words(int d) {
  const int w = (d + 1) / 2;
  return w % 2 ? w : w + 1;
}

// 32-bit words of shared memory a warp takes: q and acc (F x d floats
// each), the key chunk (32 rows of key_words(d), bf16) and the value chunk
// (32 x d bf16), each lane's running max and sum (F x 32 floats each),
// each query's max and sum (F each), bf16(p) of a chunk (32)
__host__ __device__ inline size_t attn_warp_floats(int F, int d) {
  return (size_t)2 * F * d + (size_t)kKC * key_words(d) +
         (size_t)kKC * ((d + 1) / 2) + (size_t)2 * F * kKC + 2 * F + kKC;
}

struct TemporalAttn {
  const bf16* qkv;   // (B, F, S, 3H): q, k, v
  const bf16* ek;    // (B, T, H) or null
  const bf16* ev;
  const float* bias; // (F, F + T, heads)
  bf16* acc;         // (B, F, S, H)
  bf16* p;           // (B, F, S, (F + T) heads) or null
  int B, F, S, T, heads, d;
};

__global__ void __launch_bounds__(kAttnWarps * 32) temporal_any_attn_kernel(
    const TemporalAttn a, int warps) {
  extern __shared__ float smem_f[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t item = (size_t)blockIdx.x * warps + warp;
  if (warp >= warps || item >= (size_t)a.B * a.S * a.heads) return;
  const int h = item % a.heads;
  const size_t bs = item / a.heads;
  const int s = bs % a.S, b = bs / a.S;
  const int F = a.F, T = a.T, G = F + T, d = a.d, H = a.heads * d;
  const int kp = 2 * key_words(d);  // pitch of a staged key row (bf16)
  float* q = smem_f + (size_t)warp * attn_warp_floats(F, d);  // [F][d]
  float* accs = q + F * d;                                   // [F][d]
  bf16* kc = reinterpret_cast<bf16*>(accs + F * d);          // [32][kp]
  bf16* vc = kc + kKC * kp;                                  // [32][d]
  float* pm = accs + F * d + kKC * key_words(d) + kKC * ((d + 1) / 2);
  float* pl = pm + F * kKC;                                  // [F][32]
  float* qm = pl + F * kKC;                                  // [F]
  float* ql = qm + F;                                        // [F]
  float* pb = ql + F;                                        // [32]
  // one chunk holds every key: staged once, and each lane's one score
  // kept from the first pass (its running max)
  const bool one_chunk = G <= kKC;

  // key j's row of part 1 (k) or 2 (v): a frame's, then a token's
  auto key_row = [&](int j, int part) -> const bf16* {
    if (j < F)
      return a.qkv + (((size_t)b * F + j) * a.S + s) * 3 * H + part * H + h * d;
    return (part == 1 ? a.ek : a.ev) + ((size_t)b * T + (j - F)) * H + h * d;
  };
  auto stage = [&](int j0, bool values) {
    __syncwarp();
    const int nk = min(kKC, G - j0);
    for (int r = 0; r < nk; ++r) {
      const bf16* kr = key_row(j0 + r, 1);
      for (int e = lane; e < d; e += 32) kc[r * kp + e] = kr[e];
      if (values) {
        const bf16* vr = key_row(j0 + r, 2);
        for (int e = lane; e < d; e += 32) vc[r * d + e] = vr[e];
      }
    }
    __syncwarp();
  };
  auto score = [&](int i, int j) {
    const float* qi = q + i * d;
    const bf16* kr = kc + lane * kp;
    float sc = 0.f;
    for (int e = 0; e < d; ++e) sc = fmaf(qi[e], bf2f(kr[e]), sc);
    return sc + a.bias[((size_t)i * G + j) * a.heads + h];
  };

  for (int f = 0; f < F; ++f) {
    const bf16* qr = a.qkv + (((size_t)b * F + f) * a.S + s) * 3 * H + h * d;
    for (int e = lane; e < d; e += 32) {
      q[f * d + e] = bf2f(qr[e]);
      accs[f * d + e] = 0.f;
    }
  }
  for (int i = 0; i < F; ++i) {
    pm[i * kKC + lane] = -CUDART_INF_F;
    pl[i * kKC + lane] = 0.f;
  }
  // pass 1: each lane's running max and sum of its keys' exp, per query
  for (int j0 = 0; j0 < G; j0 += kKC) {
    stage(j0, one_chunk);
    const int j = j0 + lane;
    if (j < G) {
      for (int i = 0; i < F; ++i) {
        const float sc = score(i, j);
        const float m = pm[i * kKC + lane], mn = fmaxf(m, sc);
        pl[i * kKC + lane] = pl[i * kKC + lane] * expf(m - mn) + expf(sc - mn);
        pm[i * kKC + lane] = mn;
      }
    }
  }
  __syncwarp();
  for (int i = 0; i < F; ++i) {
    const float m = pm[i * kKC + lane];
    const float mx = vmt::warp_max(m);
    const float l = vmt::warp_sum(pl[i * kKC + lane] * expf(m - mx));
    if (lane == 0) {
      qm[i] = mx;
      ql[i] = l;
    }
  }
  // pass 2: bf16(p) and the value sums, lanes over the head's features
  for (int j0 = 0; j0 < G; j0 += kKC) {
    if (one_chunk) __syncwarp();
    else stage(j0, true);
    const int j = j0 + lane, nk = min(kKC, G - j0);
    for (int i = 0; i < F; ++i) {
      float p = 0.f;
      if (j < G) {
        const float sc = one_chunk ? pm[i * kKC + lane] : score(i, j);
        p = round_bf16(expf(sc - qm[i]) / ql[i]);
        if (a.p != nullptr)
          a.p[(((size_t)b * F + i) * a.S + s) * G * a.heads + j * a.heads + h] =
              __float2bfloat16(p);
      }
      pb[lane] = p;
      __syncwarp();
      for (int e = lane; e < d; e += 32) {
        float o = accs[i * d + e];
        for (int r = 0; r < nk; ++r) o = fmaf(pb[r], bf2f(vc[r * d + e]), o);
        accs[i * d + e] = o;
      }
      __syncwarp();
    }
  }
  for (int f = 0; f < F; ++f) {
    bf16* orow = a.acc + (((size_t)b * F + f) * a.S + s) * H + h * d;
    for (int e = lane; e < d; e += 32) orow[e] = __float2bfloat16(accs[f * d + e]);
  }
}

// warps a block of the attention stage (0: one warp does not fit)
int attn_warps(int F, int d) {
  const size_t per = attn_warp_floats(F, d) * sizeof(float);
  const size_t w = kMaxSmem / per;
  return w >= kAttnWarps ? kAttnWarps : (int)w;
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

// Dynamic shared memory of the temporal attention stage at (F, d), bytes
// a block; 0 where one warp's share does not fit (the shape is refused).
extern "C" size_t vmt_temporal_block_any_smem(int F, int d) {
  if (F <= 0 || d <= 0) return 0;
  const int w = attn_warps(F, d);
  return w ? w * attn_warp_floats(F, d) * sizeof(float) : 0;
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
  const int warps = attn_warps(F, d);
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
  const size_t smem = (size_t)warps * attn_warp_floats(F, d) * sizeof(float);
  err = cudaFuncSetAttribute(temporal_any_attn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t items = (size_t)B * S * heads;
  temporal_any_attn_kernel<<<(unsigned)((items + warps - 1) / warps),
                             warps * 32, smem, st>>>(a, warps);
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
