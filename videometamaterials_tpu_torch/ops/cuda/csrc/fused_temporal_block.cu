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
// token t). With p set, only that store is added: every other instruction
// of both stages is the same, so out stays bit-equal.
//
// Per batch row b and spatial position s, over F = 11 frames and T cond
// tokens (0 <= T <= 69: the flagship's 11, or 0 for the init block; 6, 16
// or 50 on the conditioning ablations), heads = 8 of d = 32:
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
// operations bound it.
//
// Design: two stages, split where the JAX kernel rounds acc to bf16.
//  1. temporal_attn_kernel, one block of 256 threads per (32 positions,
//     head h, b), two blocks an SM at C <= 128: for each frame, the x rows
//     arrive by cp.async into a bf16 tile (the next frame's during this
//     frame's products) and LN runs in place, eight threads a row; then
//     the head's 96 q/k/v columns of y_f @ w_all[f] on the tensor cores
//     (mma.sync m16n8k16, bf16 operands, fp32 sums, ldmatrix from padded
//     shared tiles), the
//     weight rows streamed through a 3- or 4-stage cp.async ring of 32-row
//     chunks that runs across the frames. The head's q/k/v for all F
//     frames stay in shared memory. Then each warp takes its positions:
//     per position S = Q [K; EK]^T and acc = P [V; EV] are two products of
//     16 x 32 x 32 on the tensor cores (temporal_tile.cuh: query frames
//     padded to 16 rows, keys to 32, the operand rows gathered by
//     ldmatrix), the fp32 softmax between them in registers; acc goes out
//     in bf16 (B, F, S, H), and p, when asked, from the same rounded
//     fragment the value product consumed.
//  2. temporal_outproj_kernel: out = bf16(x + acc @ w_out), a 128 x 64
//     tensor-core tile over the B*F*S rows with the residual in its
//     epilogue; acc and the w_out tile arrive by cp.async in four
//     64-deep groups, the first product starting after the first group.
// What this does about the parent's bounds: (1) every product is on the
// tensor cores; (2) each QKV product has M = 32 rows, the out-projection
// 128, and the weights are staged once per block in shared memory, not
// re-read per thread from L2; (3) the grid splits over the 8 heads as
// well as over tiles of 32 positions: 80 blocks at (2, 144, 512), where
// the parent ran 36 on 132 SMs, 160 at batch 4 and 2304 at level 0
// (batch 2), where it ran 2304 of 8 positions; (4) no warp shuffle per
// score, two per row of the softmax. acc costs a write and a read of
// B*F*S*256*2 bytes (104 MB at the level-0 sampling shape, about 62 us at
// the HBM rate), and each of the 8 head blocks of a position re-reads its
// x rows (mostly from L2). p adds B*F*S*(F+T)*8*2
// bytes of 2-byte writes (143 MB at batch 4, level 0), strided by the 8
// heads. Kernel time depends only on the shape.
//
// Any T: the keys of a position (F frames, then T tokens) are padded to K,
// a multiple of 16 -- 32 while F + T <= 32, then 64 and 80 -- and the
// kernel instance is chosen by K (kNK = K / 16 key tiles), with T a launch
// argument: the token rows in shared memory, the bias columns and the key
// mask follow it, the fragment sizes and products follow K. A runtime T
// with padded key groups costs the padded keys' products (at most 15 keys
// of the next tile); template instances per T would cost one build of
// each kernel per count, for the 70 counts up to the maximum. The
// flagship's two counts, T = 11 and T = 0, keep instances of their own
// with T a compile-time constant, so their code is what it was before
// other counts were taken. At K >= 64 one block an SM runs (its
// shared memory allows no second).
#include "temporal_tile.cuh"

namespace {

using vmt::kH;
using vmt::kHeads;

constexpr int kThreads = 256;
constexpr int kHD = 3 * vmt::kD;  // q, k, v columns of one head
constexpr int kHP = kHD + 8;      // padded pitch of the head tile (bf16)
constexpr int kKC = 32;           // weight rows per cp.async stage
// stages of the weight ring: as deep as two blocks an SM allow
template <int kC>
__host__ __device__ constexpr int stages() { return kC <= 64 ? 4 : 3; }

constexpr int kP = 32;            // positions per block: M of the QKV product

constexpr int kMaxKeys = 80;      // F + T: five 16-key tiles
constexpr int kRuntimeT = -1;     // kT of the instances that take any T

template <int kF, int kC>
__host__ __device__ constexpr size_t attn_smem(int T) {
  return ((size_t)kF * kP * kHP + (size_t)2 * kP * (kC + 8) +
          (size_t)stages<kC>() * kKC * kHP + (size_t)(2 * T + 1) * vmt::kTokP) *
             2 +
         (size_t)kF * (kF + T) * 4;
}

// kT: the token count, fixed (>= 0) or kRuntimeT (t_rt is the count);
// kNK: 16-key tiles of a position's keys
template <int kF, int kT, int kNK, int kC, bool kEmitP>
__global__ void __launch_bounds__(kThreads, kNK > 2 ? 1 : 2) temporal_attn_kernel(
    const __nv_bfloat16* __restrict__ x,      // (B, F, S, C)
    const float* __restrict__ gamma,          // (C)
    const __nv_bfloat16* __restrict__ w_all,  // (F, C, 3H)
    const float* __restrict__ bias,           // (F, F+T, heads)
    const __nv_bfloat16* __restrict__ ek,     // (B, T, H) or null
    const __nv_bfloat16* __restrict__ ev,     // (B, T, H) or null
    __nv_bfloat16* __restrict__ acc_out,      // (B, F, S, H)
    __nv_bfloat16* __restrict__ p_out,        // (B, F, S, (F+T)*heads), kEmitP
    int S, int t_rt) {
  const int T = kT >= 0 ? kT : t_rt;          // conditioning tokens
  const int kG = kF + T;                      // key groups
  constexpr int kN = 2 * kNK;                 // 8-key tiles
  constexpr int kYP = kC + 8;                 // padded pitch of the y tiles
  constexpr int kNKC = kC / kKC;              // weight chunks per frame
  constexpr int kNQ = kF * kNKC;
  constexpr int kStages = stages<kC>();
  // warps: 2 row groups of 16 positions x 4 column groups of 24 (q, k, v
  // columns of the head: three n8 tiles)
  constexpr int kNT = kHD / 4 / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [F][P][kHP]
  __nv_bfloat16* ys = hs + kF * kP * kHP;                     // [2][P][kYP]
  __nv_bfloat16* ws = ys + 2 * kP * kYP;                   // [stage][kKC][kHP]
  __nv_bfloat16* ekb = ws + kStages * kKC * kHP;          // [T][kTokP]
  __nv_bfloat16* evb = ekb + T * vmt::kTokP;
  __nv_bfloat16* zrow = evb + T * vmt::kTokP;             // [kTokP] zeros
  float* bias_h = reinterpret_cast<float*>(zrow + vmt::kTokP);      // [F][G]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int s0 = blockIdx.x * kP;

  // weight chunk q: rows kc*32.. of w_all[f], the head's q, k and v columns
  auto load_chunk = [&](int q) {
    const int f = q / kNKC, kc = q % kNKC;
    __nv_bfloat16* dst = ws + (q % kStages) * kKC * kHP;
    for (int i = t; i < kKC * 12; i += kThreads) {
      const int r = i / 12, u = i % 12, seg = u >> 2, o = (u & 3) * 8;
      const __nv_bfloat16* src = w_all + ((size_t)f * kC + kc * kKC + r) * 3 * kH +
                                 seg * kH + h * vmt::kD + o;
      vmt::cp_async16(dst + r * kHP + seg * vmt::kD + o, src);
    }
  };
  // the x rows of frame f, raw, into y tile f % 2 (LN runs in place);
  // rows past S are zero-filled
  auto load_x = [&](int f) {
    __nv_bfloat16* dst = ys + (f & 1) * kP * kYP;
    for (int i = t; i < kP * kC / 8; i += kThreads) {
      const int r = i / (kC / 8), o = (i % (kC / 8)) * 8;
      const bool valid = s0 + r < S;
      vmt::cp_async16(dst + r * kYP + o,
                      x + ((size_t)(b * kF + f) * S + (valid ? s0 + r : 0)) * kC + o,
                      valid);
    }
  };
  load_x(0);
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    load_chunk(q);
    vmt::cp_async_commit();
  }
  for (int i = t; i < kF * kG; i += kThreads) bias_h[i] = bias[i * kHeads + h];
  for (int i = t; i < T * vmt::kD; i += kThreads) {
    const int u = i / vmt::kD, e = i % vmt::kD;
    const size_t o = ((size_t)b * T + u) * kH + h * vmt::kD + e;
    ekb[u * vmt::kTokP + e] = ek[o];
    evb[u * vmt::kTokP + e] = ev[o];
  }
  for (int i = t; i < vmt::kTokP; i += kThreads) zrow[i] = __float2bfloat16(0.f);

  // ---- QKV of head h for every frame, on the tensor cores. The cp.async
  // groups: the prologue's (x of frame 0 + chunk 0), (chunk 1), ..., then
  // one a ring step, holding the chunk kStages - 1 ahead and, on a frame's
  // first step, the x rows of the next frame. So x of frame f >= 1 sits
  // kNKC - 1 groups behind the newest when frame f starts.
  const int m0 = (warp & 1) * 16;
  const int n0 = (warp >> 1) * (kNT * 8);
  const int g = lane >> 2, tq = lane & 3;
  int q = 0;
  for (int f = 0; f < kF; ++f) {
    if (f == 0) vmt::cp_async_wait<kStages - 2>();
    else vmt::cp_async_wait<kNKC - 1>();
    __syncthreads();  // x of frame f visible; frame f-1's products done
    __nv_bfloat16* yf = ys + (f & 1) * kP * kYP;
    vmt::layer_norm_tile8<kC>(yf, kYP, gamma, S - s0, t);
    float acc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int kc = 0; kc < kNKC; ++kc, ++q) {
      vmt::cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk q and the y tile visible; slot q-1 free
      if (q + kStages - 1 < kNQ) load_chunk(q + kStages - 1);
      if (kc == 0 && f + 1 < kF) load_x(f + 1);
      vmt::cp_async_commit();
      const __nv_bfloat16* wsl = ws + (q % kStages) * kKC * kHP;
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        uint32_t a[4];
        vmt::ldsm_x4(a, yf + (m0 + vmt::a_row_off(lane)) * kYP + kc * kKC +
                            ks * 16 + vmt::a_col_off(lane));
        const __nv_bfloat16* wrow =
            wsl + (ks * 16 + vmt::bk_row_off(lane)) * kHP + n0;
#pragma unroll
        for (int n = 0; n + 1 < kNT; n += 2) {
          uint32_t bb[4];
          vmt::ldsm_x4_t(bb, wrow + n * 8 + vmt::bk_col_off(lane));
          vmt::mma_bf16(acc[n], a, bb[0], bb[1]);
          vmt::mma_bf16(acc[n + 1], a, bb[2], bb[3]);
        }
        if (kNT % 2) {
          uint32_t bb[2];
          vmt::ldsm_x2_t(bb, wrow + (kNT - 1) * 8);
          vmt::mma_bf16(acc[kNT - 1], a, bb[0], bb[1]);
        }
      }
    }
    __nv_bfloat16* hf = hs + f * kP * kHP;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = n0 + n * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(hf + (m0 + g) * kHP + col) =
          vmt::pack_bf16x2(acc[n][0], acc[n][1]);
      *reinterpret_cast<uint32_t*>(hf + (m0 + g + 8) * kHP + col) =
          vmt::pack_bf16x2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();

  // ---- attention on the tensor cores: warp w takes positions w, w + 8,
  // ...; per position S = Q [K; EK]^T, the softmax, acc = P [V; EV]
  vmt::PositionRows<kF, kP, kHP> rows{hs, ekb, evb, zrow, T, 0};
  for (int p = warp; p < kP && s0 + p < S; p += kThreads / 32) {
    rows.p = p;
    float sc[kN][4] = {};
    vmt::mma_rows_rows(sc, [&](int i) { return rows.frame(i, 0); },
                       [&](int j) { return rows.key(j, 1); }, lane);
    vmt::softmax_rows<kF>(sc, bias_h, kG, lane);
    float o[4][4] = {};
    vmt::mma_frag_rows<false>(o, sc, [&](int j) { return rows.key(j, 2); }, lane);
    const size_t row0 = (size_t)b * kF * S + s0 + p;  // (b, frame 0, s)
    vmt::store_frag_rows<kF>(o, [&](int i) {
      return acc_out + (row0 + (size_t)i * S) * kH + h * vmt::kD;
    }, lane);
    if (kEmitP) {
      // the weights the value sum consumed, bf16(p), to p[b, i, s, jg, h]
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = g + 8 * half;
        if (i >= kF) continue;
        __nv_bfloat16* prow = p_out + (row0 + (size_t)i * S) * kG * kHeads + h;
#pragma unroll
        for (int nt = 0; nt < kN; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = nt * 8 + 2 * tq + e;
            if (j < kG) prow[j * kHeads] = __float2bfloat16(sc[nt][2 * half + e]);
          }
      }
    }
  }
}

// ---- out = bf16(x + acc @ w_out): a 128 x 64 tile, K = H = 256
constexpr int kOM = 128, kON = 64, kOK = 64;  // tile rows, columns, K group
constexpr int kOAP = kH + 8, kOBP = kON + 8;  // padded pitches
constexpr size_t kOutSmem = ((size_t)kOM * kOAP + (size_t)kH * kOBP) * 2;

template <int kC>
__global__ void __launch_bounds__(kThreads) temporal_outproj_kernel(
    const __nv_bfloat16* __restrict__ x,      // (R, C)
    const __nv_bfloat16* __restrict__ acc,    // (R, H)
    const __nv_bfloat16* __restrict__ w_out,  // (H, C)
    __nv_bfloat16* __restrict__ out,          // (R, C)
    int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kOM][kOAP]
  __nv_bfloat16* bs = as + kOM * kOAP;                             // [H][kOBP]
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int r0 = blockIdx.x * kOM, c0 = blockIdx.y * kON;

  // four cp.async groups, one per 64-deep slice of K
#pragma unroll
  for (int kg = 0; kg < kH / kOK; ++kg) {
    for (int i = t; i < kOM * kOK / 8; i += kThreads) {
      const int r = i / (kOK / 8), o = kg * kOK + (i % (kOK / 8)) * 8;
      const bool valid = r0 + r < R;
      vmt::cp_async16(as + r * kOAP + o,
                      acc + (size_t)(valid ? r0 + r : 0) * kH + o, valid);
    }
    for (int i = t; i < kOK * kON / 8; i += kThreads) {
      const int k = kg * kOK + i / (kON / 8), o = (i % (kON / 8)) * 8;
      vmt::cp_async16(bs + k * kOBP + o, w_out + (size_t)k * kC + c0 + o);
    }
    vmt::cp_async_commit();
  }

  // warps: 4 row groups of 32 x 2 column groups of 32
  const int m0 = (warp & 3) * 32, n0 = (warp >> 2) * 32;
  float d[2][4][4] = {};
#pragma unroll
  for (int kg = 0; kg < kH / kOK; ++kg) {
    if (kg == 0) vmt::cp_async_wait<3>();
    if (kg == 1) vmt::cp_async_wait<2>();
    if (kg == 2) vmt::cp_async_wait<1>();
    if (kg == 3) vmt::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kOK / 16; ++ks) {
      const int k0 = kg * kOK + ks * 16;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        vmt::ldsm_x4(a[mt], as + (m0 + mt * 16 + vmt::a_row_off(lane)) * kOAP +
                                k0 + vmt::a_col_off(lane));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bb[4];
        vmt::ldsm_x4_t(bb, bs + (k0 + vmt::bk_row_off(lane)) * kOBP + n0 +
                               np * 16 + vmt::bk_col_off(lane));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          vmt::mma_bf16(d[mt][2 * np], a[mt], bb[0], bb[1]);
          vmt::mma_bf16(d[mt][2 * np + 1], a[mt], bb[2], bb[3]);
        }
      }
    }
  }

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + m0 + mt * 16 + g + 8 * half;
      if (r >= R) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const size_t idx = (size_t)r * kC + c0 + n0 + nt * 8 + 2 * tq;
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + idx);
        *reinterpret_cast<uint32_t*>(out + idx) = vmt::pack_bf16x2(
            __low2float(xv) + d[mt][nt][2 * half],
            __high2float(xv) + d[mt][nt][2 * half + 1]);
      }
    }
}

template <int kF, int kT, int kNK, int kC, bool kEmitP>
cudaError_t launch(const void* x, const void* gamma, const void* w_all,
                   const void* w_out, const void* bias, const void* ek,
                   const void* ev, void* out, void* acc, void* p_out, int B,
                   int S, int T, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const size_t smem = attn_smem<kF, kC>(T);
  auto attn = temporal_attn_kernel<kF, kT, kNK, kC, kEmitP>;
  cudaError_t err = cudaFuncSetAttribute(
      attn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn<<<dim3((S + kP - 1) / kP, kHeads, B), kThreads, smem, stream>>>(
      static_cast<const bf*>(x), static_cast<const float*>(gamma),
      static_cast<const bf*>(w_all), static_cast<const float*>(bias),
      static_cast<const bf*>(ek), static_cast<const bf*>(ev),
      static_cast<bf*>(acc), static_cast<bf*>(p_out), S, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto proj = temporal_outproj_kernel<kC>;
  err = cudaFuncSetAttribute(proj, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kOutSmem);
  if (err != cudaSuccess) return err;
  const int R = B * kF * S;
  proj<<<dim3((R + kOM - 1) / kOM, kC / kON), kThreads, kOutSmem, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(acc),
      static_cast<const bf*>(w_out), static_cast<bf*>(out), R);
  return cudaGetLastError();
}

template <int kT, int kNK, bool kEmitP>
cudaError_t launch_c(int C, const void* x, const void* gamma, const void* w_all,
                     const void* w_out, const void* bias, const void* ek,
                     const void* ev, void* out, void* acc, void* p_out, int B,
                     int S, int T, cudaStream_t stream) {
#define VMT_CASE(CC)                                                          \
  case CC:                                                                    \
    return launch<11, kT, kNK, CC, kEmitP>(x, gamma, w_all, w_out, bias, ek,  \
                                           ev, out, acc, p_out, B, S, T,      \
                                           stream);
  switch (C) {
    VMT_CASE(64)
    VMT_CASE(128)
    VMT_CASE(256)
    VMT_CASE(512)
    default: return cudaErrorInvalidValue;
  }
#undef VMT_CASE
}

// 16-key tiles of the instance that takes T tokens beside F frames (0 for
// a count outside [0, kMaxKeys - F])
int key_tiles(int F, int T) {
  const int G = F + T;
  if (T < 0 || G > kMaxKeys) return 0;
  return G <= 32 ? 2 : G <= 64 ? 4 : 5;
}

template <bool kEmitP>
cudaError_t launch_t(int T, int C, const void* x, const void* gamma,
                     const void* w_all, const void* w_out, const void* bias,
                     const void* ek, const void* ev, void* out, void* acc,
                     void* p_out, int B, int S, cudaStream_t stream) {
  if (T == 0)
    return launch_c<0, 2, kEmitP>(C, x, gamma, w_all, w_out, bias, nullptr,
                                  nullptr, out, acc, p_out, B, S, T, stream);
  if (T == 11)
    return launch_c<11, 2, kEmitP>(C, x, gamma, w_all, w_out, bias, ek, ev,
                                   out, acc, p_out, B, S, T, stream);
  switch (key_tiles(11, T)) {
    case 2:
      return launch_c<kRuntimeT, 2, kEmitP>(C, x, gamma, w_all, w_out, bias,
                                            ek, ev, out, acc, p_out, B, S, T,
                                            stream);
    case 4:
      return launch_c<kRuntimeT, 4, kEmitP>(C, x, gamma, w_all, w_out, bias,
                                            ek, ev, out, acc, p_out, B, S, T,
                                            stream);
    case 5:
      return launch_c<kRuntimeT, 5, kEmitP>(C, x, gamma, w_all, w_out, bias,
                                            ek, ev, out, acc, p_out, B, S, T,
                                            stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// acc: (B, F, S, H) bf16 scratch between the two stages.
// p: (B, F, S, (F+T)*heads) bf16 softmax weights out, or null for none.
extern "C" int vmt_temporal_block_fwd(const void* x, const void* gamma,
                                      const void* w_all, const void* w_out,
                                      const void* bias, const void* ek,
                                      const void* ev, void* out, void* acc,
                                      void* p, int B, int F, int S, int C,
                                      int T, int heads, void* stream) {
  if (F != 11 || heads != kHeads || (T > 0 && (ek == nullptr || ev == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p != nullptr)
    return (int)launch_t<true>(T, C, x, gamma, w_all, w_out, bias, ek, ev, out,
                               acc, p, B, S, st);
  return (int)launch_t<false>(T, C, x, gamma, w_all, w_out, bias, ek, ev, out,
                              acc, nullptr, B, S, st);
}

// Dynamic shared memory of the two stages at (C, T): stage 0 the
// attention stage, 1 the out-projection; 0 for a shape the kernel does not
// take.
extern "C" size_t vmt_temporal_block_fwd_smem(int C, int T, int stage) {
  if (key_tiles(11, T) == 0) return 0;
  if (stage == 1) return kOutSmem;
#define VMT_CASE(CC)  \
  case CC:            \
    return attn_smem<11, CC>(T);
  switch (C) {
    VMT_CASE(64)
    VMT_CASE(128)
    VMT_CASE(256)
    VMT_CASE(512)
    default: return 0;
  }
#undef VMT_CASE
}

extern "C" const char* vmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
