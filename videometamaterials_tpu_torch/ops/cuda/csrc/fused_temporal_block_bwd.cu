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
// operations bound it (0.15 ms at the 989 TFLOP/s bf16 rate).
//
// Design: three stages and the shared reductions, no float atomics.
//  1. temporal_bwd_attn_kernel, one block of 256 threads per (32
//     positions, head h, b): per frame, the x and g rows arrive by
//     cp.async into bf16 tiles (the next frame's during this frame's
//     products, where two tile sets fit) and LN runs in place, eight
//     threads a row; then the head's q, k, v (y @ w_all[f]) and g_acc
//     (g @ w_out^T) columns on the tensor cores (mma.sync m16n8k16 with
//     ldmatrix; the weight rows, w_all[f]'s 96 head columns beside
//     w_out^T's 32, streamed through a 3-stage cp.async ring across the
//     frames). q, k, v and g_acc of all frames stay in shared memory.
//     Then each warp takes its positions: per position the attention
//     backward is six products of at most 16 x 32 x 32 (temporal_tile.cuh):
//     S = Q [K; EK]^T, the f32 softmax, acc = P [V; EV] (bf16 to a
//     scratch for dw_out), dP = G_acc [V; EV]^T, dS = P (dP - rowsum P dP),
//     dQ = dS [K; EK], dK = dS^T Q, dV = bf16(P)^T G_acc: ds enters its
//     products as bf16(ds) plus its rounding error in bf16 (two products,
//     about 16 significant bits: the f32 ds of the roundings above), p as
//     bf16(p).
//     dq, dk and dv go to the bf16 dqkv scratch (F, B, S, 3H); dbias and
//     the token rows of dK, dV (dek, dev) sum over the warp's positions in
//     registers, then over the warps in order, and leave the block as
//     partials.
//  2. temporal_bwd_dx_kernel, per (frame f, 8192 / C rows of B*S): dy =
//     dqkv_f @ w_all[f]^T on the tensor cores (K = 768 through a cp.async
//     ring), then the LN backward in the block: dx, and a per-block
//     partial of dgamma.
//  3. dw_all[f] = y_f^T dqkv_f and dw_out = acc^T g by the split-K
//     contraction of reduce.cu (tensor cores), then ordered column sums.
// What this does about the parent's bounds: (1) every product (QKV,
// g_acc, the attention backward, dy, dw_all, dw_out) is on the tensor
// cores with M >= 16; (2) the weights are staged in shared memory once per
// block; (3) the grid is (positions / 32, 8 heads, B): 160 blocks at the
// deepest training level (4, 144), where the parent ran 72; (4) no warp
// shuffle per score or dp, two per row of the softmax and of its
// backward. The scratch (y, dqkv, acc) is 0.88 GB of bf16 at the level-0
// training shape, written once and read by the contraction and stage 2
// (dqkv twice): about 0.45 ms at the HBM rate. Kernel time depends only on
// the shape: the tiles are fixed by C.
#include <algorithm>

#include "reduce.cuh"
#include "temporal_tile.cuh"

namespace {

using vmt::kD;
using vmt::kH;
using vmt::kHeads;
using vmt::bf2f;
using vmt::warp_sum;

constexpr int kThreads = 256;
constexpr int kQKV = 3 * kH;
constexpr int kP = 32;            // positions per block of stage 1
constexpr int kHC = 4 * kD;       // q, k, v, g_acc columns of one head
constexpr int kHP = kHC + 8;      // padded pitch (bf16) of head tile and ring
constexpr int kKC = 32;           // weight rows per cp.async stage
constexpr int kStages = 3;

// y and g tiles per buffer set: two sets (the next frame's rows arrive
// while this frame's products run) where they fit beside the rest
template <int kC>
__host__ __device__ constexpr int tile_bufs() { return kC <= 256 ? 2 : 1; }

// phase B's shared memory: each warp's transpose scratch (two tiles), then
// each warp's
// partial dbias (16 x 32 f32) and dek/dev rows (T x 64 f32)
template <int kT>
__host__ __device__ constexpr size_t pass_smem() {
  return (size_t)8 * 2 * 16 * vmt::kTokP * 2 + (size_t)8 * 16 * 32 * 4 +
         (size_t)8 * kT * 2 * kD * 4;
}

template <int kF, int kT, int kC>
constexpr size_t attn_smem() {
  constexpr size_t tiles = (size_t)2 * tile_bufs<kC>() * kP * (kC + 8) * 2;
  constexpr size_t pass = pass_smem<kT>();
  return (size_t)kF * kP * kHP * 2 + (tiles > pass ? tiles : pass) +
         ((size_t)kStages * kKC * kHP + (size_t)(2 * kT + 1) * vmt::kTokP) * 2 +
         (size_t)kF * (kF + kT) * 4;
}

template <int kF, int kT, int kC>
__global__ void __launch_bounds__(kThreads, 1) temporal_bwd_attn_kernel(
    const __nv_bfloat16* __restrict__ x,       // (B, F, S, C)
    const float* __restrict__ gamma,           // (C)
    const __nv_bfloat16* __restrict__ w_all,   // (F, C, 3H)
    const __nv_bfloat16* __restrict__ w_outT,  // (C, H)
    const float* __restrict__ bias,            // (F, F+T, heads)
    const __nv_bfloat16* __restrict__ ek,      // (B, T, H) or null
    const __nv_bfloat16* __restrict__ ev,      // (B, T, H) or null
    const __nv_bfloat16* __restrict__ g,       // (B, F, S, C)
    __nv_bfloat16* __restrict__ y_out,         // (F, B, S, C) scratch
    __nv_bfloat16* __restrict__ dqkv_out,      // (F, B, S, 3H) scratch
    __nv_bfloat16* __restrict__ acc_out,       // (B, F, S, H) scratch
    float* __restrict__ part_dbias,            // (B * nS, F, F+T, heads)
    float* __restrict__ part_dekv,             // (B, nS, 2, T, H)
    int B, int S) {
  constexpr int kG = kF + kT;
  constexpr int kYP = kC + 8;
  constexpr int kNKC = kC / kKC;
  constexpr int kNQ = kF * kNKC;
  constexpr int kTB = tile_bufs<kC>();
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [F][P][kHP]
  unsigned char* uni = smem_raw + (size_t)kF * kP * kHP * 2;
  // phase A: the y tiles (x rows, LN in place) and the g tiles
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(uni);  // [kTB][P][kYP]
  __nv_bfloat16* gs = ys + kTB * kP * kYP;                    // [kTB][P][kYP]
  // phase B: per warp two 16 x kTokP transpose scratch tiles, then the
  // warps' partial dbias [16][32] and token rows [T][dek 32 | dev 32]
  __nv_bfloat16* scratch = reinterpret_cast<__nv_bfloat16*>(uni);
  float* red_b = reinterpret_cast<float*>(scratch + kWarps * 2 * 16 * vmt::kTokP);
  float* red_t = red_b + kWarps * 16 * 32;
  constexpr size_t kTiles = (size_t)2 * kTB * kP * kYP * 2;
  constexpr size_t kPass = pass_smem<kT>();
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(
      uni + (kTiles > kPass ? kTiles : kPass));                    // ring
  __nv_bfloat16* ekb = ws + kStages * kKC * kHP;                  // [T][kTokP]
  __nv_bfloat16* evb = ekb + kT * vmt::kTokP;
  __nv_bfloat16* zrow = evb + kT * vmt::kTokP;                    // zeros
  float* bias_h = reinterpret_cast<float*>(zrow + vmt::kTokP);    // [F][G]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int s0 = blockIdx.x * kP;
  const int nS = gridDim.x;

  // ring chunk q: rows kc*32.. of w_all[f] (the head's 96 q/k/v columns)
  // and of w_out^T (the head's 32 columns)
  auto load_chunk = [&](int q) {
    const int f = q / kNKC, c0 = (q % kNKC) * kKC;
    __nv_bfloat16* dst = ws + (q % kStages) * kKC * kHP;
    for (int i = t; i < kKC * 16; i += kThreads) {
      const int r = i / 16, u = i % 16, seg = u >> 2, o = (u & 3) * 8;
      const __nv_bfloat16* src =
          seg < 3 ? w_all + ((size_t)f * kC + c0 + r) * kQKV + seg * kH + h * kD + o
                  : w_outT + (size_t)(c0 + r) * kH + h * kD + o;
      vmt::cp_async16(dst + r * kHP + seg * kD + o, src);
    }
  };
  // the x and g rows of frame f into tile set f % kTB (rows past S: zeros)
  auto load_tiles = [&](int f) {
    __nv_bfloat16* yd = ys + (f % kTB) * kP * kYP;
    __nv_bfloat16* gd = gs + (f % kTB) * kP * kYP;
    for (int i = t; i < 2 * kP * kC / 8; i += kThreads) {
      const int which = i / (kP * kC / 8), j = i % (kP * kC / 8);
      const int r = j / (kC / 8), o = (j % (kC / 8)) * 8;
      const bool valid = s0 + r < S;
      const size_t src = ((size_t)(b * kF + f) * S + (valid ? s0 + r : 0)) * kC + o;
      vmt::cp_async16((which ? gd : yd) + r * kYP + o, (which ? g : x) + src,
                      valid);
    }
  };
  load_tiles(0);
  load_chunk(0);
  vmt::cp_async_commit();
  load_chunk(1);
  vmt::cp_async_commit();
  for (int i = t; i < kF * kG; i += kThreads) bias_h[i] = bias[i * kHeads + h];
  for (int i = t; i < kT * kD; i += kThreads) {
    const int u = i / kD, e = i % kD;
    const size_t o = ((size_t)b * kT + u) * kH + h * kD + e;
    ekb[u * vmt::kTokP + e] = ek[o];
    evb[u * vmt::kTokP + e] = ev[o];
  }
  for (int i = t; i < vmt::kTokP; i += kThreads) zrow[i] = __float2bfloat16(0.f);

  // ---- phase A: q, k, v, g_acc of head h for every frame
  // warps: 2 row groups of 16 positions x 4 column groups (q, k, v, g_acc).
  // cp.async groups: the prologue's (tiles of frame 0 + chunk 0), (chunk
  // 1), then one a ring step with the chunk two ahead; with two tile sets
  // a frame's first step also carries the next frame's tiles (kNKC - 1
  // groups behind the newest when that frame starts), with one set they
  // follow the frame's last product as a group of their own
  const int m0 = (warp & 1) * 16, cg = warp >> 1;
  const int gq = lane >> 2, tq = lane & 3;
  int q = 0;
  for (int f = 0; f < kF; ++f) {
    if (f == 0) vmt::cp_async_wait<1>();
    else if (kTB == 2) vmt::cp_async_wait<kNKC - 1>();
    else vmt::cp_async_wait<0>();
    __syncthreads();  // tiles of frame f visible; frame f-1's products done
    __nv_bfloat16* yf = ys + (f % kTB) * kP * kYP;
    const __nv_bfloat16* gf = gs + (f % kTB) * kP * kYP;
    vmt::layer_norm_tile8<kC>(yf, kYP, gamma, S - s0, t);
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const __nv_bfloat16* abase = cg == 3 ? gf : yf;
    for (int kc = 0; kc < kNKC; ++kc, ++q) {
      vmt::cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk q and the tiles visible; slot q-1 free
      if (q + kStages - 1 < kNQ) load_chunk(q + kStages - 1);
      if (kTB == 2 && kc == 0 && f + 1 < kF) load_tiles(f + 1);
      vmt::cp_async_commit();
      if (kc == 0 && h == 0) {
        // y (bf16) of the block's rows to the scratch of the dw_all sums
        for (int i = t; i < kP * kC / 8; i += kThreads) {
          const int r = i / (kC / 8), o = (i % (kC / 8)) * 8;
          if (s0 + r < S)
            *reinterpret_cast<uint4*>(y_out + ((size_t)(f * B + b) * S + s0 + r) * kC + o) =
                *reinterpret_cast<const uint4*>(yf + r * kYP + o);
        }
      }
      const __nv_bfloat16* wsl = ws + (q % kStages) * kKC * kHP;
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        uint32_t a[4];
        vmt::ldsm_x4(a, abase + (m0 + vmt::a_row_off(lane)) * kYP + kc * kKC +
                            ks * 16 + vmt::a_col_off(lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bb[4];
          vmt::ldsm_x4_t(bb, wsl + (ks * 16 + vmt::bk_row_off(lane)) * kHP +
                                 cg * kD + np * 16 + vmt::bk_col_off(lane));
          vmt::mma_bf16(acc[2 * np], a, bb[0], bb[1]);
          vmt::mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    __nv_bfloat16* hf = hs + f * kP * kHP;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = cg * kD + n * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(hf + (m0 + gq) * kHP + col) =
          vmt::pack_bf16x2(acc[n][0], acc[n][1]);
      *reinterpret_cast<uint32_t*>(hf + (m0 + gq + 8) * kHP + col) =
          vmt::pack_bf16x2(acc[n][2], acc[n][3]);
    }
    if (kTB == 1 && f + 1 < kF) {
      __syncthreads();  // the one tile set is free
      load_tiles(f + 1);
      vmt::cp_async_commit();
    }
  }
  vmt::cp_async_wait<0>();
  __syncthreads();

  // ---- phase B on the tensor cores: warp w takes positions w, w + 8, ...
  // Per position (rows: query frames, columns: keys): S = Q [K; EK]^T, the
  // softmax P, acc = P [V; EV], dP = G_acc [V; EV]^T, dS = P (dP - rowsum
  // P dP), dQ = dS [K; EK], dK = dS^T Q, dV = bf16(P)^T G_acc, ds split
  // into bf16(ds) + its rounding error for its two products.
  // dbias and the token rows of dK, dV sum over the warp's positions in
  // registers.
  vmt::PositionRows<kF, kT, kP, kHP> rows{hs, ekb, evb, zrow, 0};
  __nv_bfloat16* scr = scratch + warp * 2 * 16 * vmt::kTokP;
  float dbias_acc[4][4] = {}, tok_k[2][4][4] = {}, tok_v[2][4][4] = {};
  for (int p = warp; p < kP && s0 + p < S; p += kWarps) {
    rows.p = p;
    const size_t s = s0 + p;
    float pr[4][4] = {};
    vmt::mma_rows_rows(pr, [&](int i) { return rows.frame(i, 0); },
                       [&](int j) { return rows.key(j, 1); }, lane);
    vmt::softmax_rows<kF, kG>(pr, bias_h, lane);
    {
      float o[4][4] = {};
      vmt::mma_frag_rows<false>(o, pr, [&](int j) { return rows.key(j, 2); },
                                lane);
      vmt::store_frag_rows<kF>(o, [&](int i) {
        return acc_out + ((size_t)(b * kF + i) * S + s) * kH + h * kD;
      }, lane);
    }
    float ds[4][4] = {};
    vmt::mma_rows_rows(ds, [&](int i) { return rows.frame(i, 3); },
                       [&](int j) { return rows.key(j, 2); }, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tsum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          tsum = fmaf(pr[nt][2 * half + e], ds[nt][2 * half + e], tsum);
      tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
      tsum += __shfl_xor_sync(0xffffffffu, tsum, 2);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& d = ds[nt][2 * half + e];
          d = pr[nt][2 * half + e] * (d - tsum);
          dbias_acc[nt][2 * half + e] += d;
        }
    }
    {
      float dq[4][4] = {};
      vmt::mma_frag_rows<true>(dq, ds, [&](int j) { return rows.key(j, 1); },
                               lane);
      vmt::store_frag_rows<kF>(dq, [&](int i) {
        return dqkv_out + ((size_t)(i * B + b) * S + s) * kQKV + h * kD;
      }, lane);
    }
#pragma unroll
    for (int part = 1; part <= 2; ++part) {
      // part 1: dK = dS^T Q (ds split into bf16 + its rounding error, so
      // f32 to about 16 bits); part 2: dV = bf16(P)^T G_acc
      float d[2][4][4] = {};
      if (part == 1)
        vmt::mma_fragT_rows<true>(d, ds, scr, [&](int i) { return rows.frame(i, 0); },
                                  lane);
      else
        vmt::mma_fragT_rows<false>(d, pr, scr, [&](int i) { return rows.frame(i, 3); },
                                   lane);
      float (&tok)[2][4][4] = part == 1 ? tok_k : tok_v;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = mt * 16 + gq + 8 * half;  // key
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            tok[mt][nt][2 * half] += d[mt][nt][2 * half];
            tok[mt][nt][2 * half + 1] += d[mt][nt][2 * half + 1];
          }
          if (j < kF) {
            __nv_bfloat16* dst = dqkv_out + ((size_t)(j * B + b) * S + s) * kQKV +
                                 part * kH + h * kD;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              *reinterpret_cast<uint32_t*>(dst + nt * 8 + 2 * tq) =
                  vmt::pack_bf16x2(d[mt][nt][2 * half], d[mt][nt][2 * half + 1]);
          }
        }
    }
  }
  __syncthreads();  // every warp is past its scratch

  // ---- per-block partials, summed over the warps in order: dbias over the
  // positions, dek/dev (the token rows of dK, dV)
  {
    float* rb = red_b + warp * 16 * 32;
    float* rt = red_t + warp * kT * 2 * kD;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int i = gq + 8 * half, col = nt * 8 + 2 * tq;
        rb[i * 32 + col] = dbias_acc[nt][2 * half];
        rb[i * 32 + col + 1] = dbias_acc[nt][2 * half + 1];
      }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int u = mt * 16 + gq + 8 * half - kF;  // token
        if (u < 0 || u >= kT) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            rt[u * 2 * kD + nt * 8 + 2 * tq + e] = tok_k[mt][nt][2 * half + e];
            rt[u * 2 * kD + kD + nt * 8 + 2 * tq + e] = tok_v[mt][nt][2 * half + e];
          }
      }
  }
  __syncthreads();
  const size_t blk = (size_t)b * nS + blockIdx.x;
  for (int it = t; it < kF * kG; it += kThreads) {
    const int i = it / kG, j = it % kG;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red_b[(w * 16 + i) * 32 + j];
    part_dbias[(blk * kF * kG + it) * kHeads + h] = sum;
  }
  if (kT > 0) {
    float* pd = part_dekv + blk * 2 * kT * kH;
    for (int it = t; it < kT * 2 * kD; it += kThreads) {
      const int u = it / (2 * kD), e = it % (2 * kD);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red_t[(w * kT + u) * 2 * kD + e];
      pd[(e < kD ? u : kT + u) * kH + h * kD + e % kD] = sum;
    }
  }
}

// rows of stage 2 per block: dy tile of 8192 f32
template <int kC>
__host__ __device__ constexpr int dx_rows() { return 8192 / kC; }

template <int kC>
constexpr size_t dx_smem() {
  return (size_t)kStages * (dx_rows<kC>() + kC) * (kKC + 8) * 2;
}

template <int kF, int kC>
__global__ void __launch_bounds__(kThreads) temporal_bwd_dx_kernel(
    const __nv_bfloat16* __restrict__ x,      // (B, F, S, C)
    const float* __restrict__ gamma,          // (C)
    const __nv_bfloat16* __restrict__ w_all,  // (F, C, 3H)
    const __nv_bfloat16* __restrict__ dqkv,   // (F, B, S, 3H)
    const __nv_bfloat16* __restrict__ g,      // (B, F, S, C)
    __nv_bfloat16* __restrict__ dx,           // (B, F, S, C)
    float* __restrict__ part_dgamma,          // (F * nR, C)
    int B, int S) {
  constexpr int kR = dx_rows<kC>();
  constexpr int kAP = kKC + 8;
  constexpr int kNQ = kQKV / kKC;
  constexpr int kRG = kR / 16, kCG = 8 / kRG;
  static_assert(kC / kCG == 64, "each warp takes 16 rows x 64 columns");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* dys = reinterpret_cast<float*>(smem_raw);  // [kR][kC + 4], after the ring
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int f = blockIdx.y, r0 = blockIdx.x * kR;
  const int rows = B * S;
  const __nv_bfloat16* wf = w_all + (size_t)f * kC * kQKV;
  const __nv_bfloat16* af = dqkv + (size_t)f * rows * kQKV;

  // stage q: dqkv rows r0.. and w_all[f] rows (all C), columns q*32..
  auto load_chunk = [&](int q) {
    __nv_bfloat16* as = ring + (q % kStages) * (kR + kC) * kAP;
    __nv_bfloat16* bs = as + kR * kAP;
    for (int i = t; i < (kR + kC) * 4; i += kThreads) {
      const int r = i / 4, o = q * kKC + (i % 4) * 8;
      if (r < kR) {
        const bool valid = r0 + r < rows;
        vmt::cp_async16(as + r * kAP + o - q * kKC,
                        af + (size_t)(valid ? r0 + r : 0) * kQKV + o, valid);
      } else {
        vmt::cp_async16(bs + (r - kR) * kAP + o - q * kKC,
                        wf + (size_t)(r - kR) * kQKV + o);
      }
    }
  };
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    load_chunk(q);
    vmt::cp_async_commit();
  }
  const int m0 = (warp % kRG) * 16, n0 = (warp / kRG) * 64;
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int q = 0; q < kNQ; ++q) {
    vmt::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (q + kStages - 1 < kNQ) load_chunk(q + kStages - 1);
    vmt::cp_async_commit();
    const __nv_bfloat16* as = ring + (q % kStages) * (kR + kC) * kAP;
    const __nv_bfloat16* bs = as + kR * kAP;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      uint32_t a[4];
      vmt::ldsm_x4(a, as + (m0 + vmt::a_row_off(lane)) * kAP + ks * 16 +
                          vmt::a_col_off(lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        vmt::ldsm_x4(bb, bs + (n0 + np * 16 + vmt::bn_row_off(lane)) * kAP +
                             ks * 16 + vmt::bn_col_off(lane));
        vmt::mma_bf16(acc[2 * np], a, bb[0], bb[1]);
        vmt::mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
  }
  vmt::cp_async_wait<0>();
  __syncthreads();  // the ring is dead: dy takes its place
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n0 + n * 8 + 2 * tq;
    *reinterpret_cast<float2*>(dys + (m0 + gq) * (kC + 4) + col) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(dys + (m0 + gq + 8) * (kC + 4) + col) =
        make_float2(acc[n][2], acc[n][3]);
  }
  __syncthreads();

  // LN backward, one warp per row: dx = g + rstd (dxh - mean dxh - xh
  // mean(dxh xh)), dxh = dy gamma; dgamma per (warp, column)
  float dgam[kC / 32];
#pragma unroll
  for (int u = 0; u < kC / 32; ++u) dgam[u] = 0.f;
  for (int rl = warp; rl < kR; rl += kThreads / 32) {
    const int r = r0 + rl;
    if (r >= rows) break;
    const int bb = r / S, s = r % S;
    const size_t row = ((size_t)(bb * kF + f) * S + s) * kC;
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
    const float* dyr = dys + rl * (kC + 4);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int u = 0; u < kC / 32; ++u) {
      const int c = lane + 32 * u;
      const float xh = (xv[u] - mu) * rstd;
      dgam[u] = fmaf(xh, dyr[c], dgam[u]);
      const float dxh = dyr[c] * gamma[c];
      xv[u] = xh;
      s1 += dxh;
      s2 = fmaf(dxh, xh, s2);
    }
    const float m1 = warp_sum(s1) / kC;
    const float m2 = warp_sum(s2) / kC;
#pragma unroll
    for (int u = 0; u < kC / 32; ++u) {
      const int c = lane + 32 * u;
      const float d = rstd * (dyr[c] * gamma[c] - m1 - xv[u] * m2);
      dx[row + c] = __float2bfloat16(bf2f(g[row + c]) + d);
    }
  }
  __syncthreads();  // dy is dead: the warps' dgamma take its place
  float* red = dys;
#pragma unroll
  for (int u = 0; u < kC / 32; ++u) red[warp * kC + lane + 32 * u] = dgam[u];
  __syncthreads();
  for (int c = t; c < kC; c += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += red[w * kC + c];
    part_dgamma[((size_t)f * gridDim.x + blockIdx.x) * kC + c] = sum;
  }
}

template <int kC>
constexpr size_t dx_smem_all() {
  const size_t dy = (size_t)dx_rows<kC>() * (kC + 4) * 4;
  return dx_smem<kC>() > dy ? dx_smem<kC>() : dy;
}

struct Work {
  __nv_bfloat16 *y, *dqkv, *acc;
  float *pdgamma, *pdbias, *pdekv, *ws_contract, *ws_colsum;
  size_t bytes;
};

Work carve(void* base, int B, int F, int S, int C, int T) {
  const int nS = (S + kP - 1) / kP;
  const int nR = (B * S + 8192 / C - 1) / (8192 / C);
  const size_t rows = (size_t)B * S;
  const int nb = F * (F + T) * kHeads;
  size_t sz[8] = {
      vmt::align256(F * rows * C * 2), vmt::align256(F * rows * kQKV * 2),
      vmt::align256(F * rows * kH * 2),
      vmt::align256((size_t)F * nR * C * 4),
      vmt::align256((size_t)B * nS * nb * 4),
      vmt::align256((size_t)B * nS * 2 * T * kH * 4 + 4),
      vmt::align256(std::max(vmt::contract_workspace(F, B * S, C, kQKV),
                             vmt::contract_workspace(1, B * F * S, kH, C))),
      vmt::align256(std::max(
          std::max(vmt::colsum_workspace(1, F * nR, C),
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
                   const void* w_outT, const void* bias, const void* ek,
                   const void* ev, const void* g, void* dx, void* dgamma,
                   void* dw_all, void* dw_out, void* dbias, void* dekv,
                   void* workspace, int B, int S, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr size_t smem1 = attn_smem<kF, kT, kC>();
  auto attn = temporal_bwd_attn_kernel<kF, kT, kC>;
  cudaError_t err = cudaFuncSetAttribute(
      attn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  const Work w = carve(workspace, B, kF, S, kC, kT);
  const int nS = (S + kP - 1) / kP;
  attn<<<dim3(nS, kHeads, B), kThreads, smem1, stream>>>(
      static_cast<const bf*>(x), static_cast<const float*>(gamma),
      static_cast<const bf*>(w_all), static_cast<const bf*>(w_outT),
      static_cast<const float*>(bias), static_cast<const bf*>(ek),
      static_cast<const bf*>(ev), static_cast<const bf*>(g), w.y, w.dqkv,
      w.acc, w.pdbias, w.pdekv, B, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t smem2 = dx_smem_all<kC>();
  auto dxk = temporal_bwd_dx_kernel<kF, kC>;
  err = cudaFuncSetAttribute(dxk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  const int nR = (B * S + dx_rows<kC>() - 1) / dx_rows<kC>();
  dxk<<<dim3(nR, kF), kThreads, smem2, stream>>>(
      static_cast<const bf*>(x), static_cast<const float*>(gamma),
      static_cast<const bf*>(w_all), w.dqkv, static_cast<const bf*>(g),
      static_cast<bf*>(dx), w.pdgamma, B, S);
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
  err = vmt::launch_colsum(w.pdgamma, static_cast<float*>(dgamma), 1, kF * nR,
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
                     const void* w_all, const void* w_outT, const void* bias,
                     const void* ek, const void* ev, const void* g, void* dx,
                     void* dgamma, void* dw_all, void* dw_out, void* dbias,
                     void* dekv, void* ws, int B, int S, cudaStream_t st) {
#define VMT_CASE(CC)                                                        \
  case CC:                                                                  \
    return launch<11, kT, CC>(x, gamma, w_all, w_outT, bias, ek, ev, g, dx, \
                              dgamma, dw_all, dw_out, dbias, dekv, ws, B,   \
                              S, st);
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

// Dynamic shared memory of stage 0 (the attention stage) or 1 (dy and the
// LN backward) at (C, T); 0 for a shape the kernel does not take.
extern "C" size_t vmt_temporal_block_bwd_smem(int C, int T, int stage) {
#define VMT_CASE(CC)                                                      \
  case CC:                                                                \
    if (stage == 1) return dx_smem_all<CC>();                             \
    return T == 0 ? attn_smem<11, 0, CC>() : attn_smem<11, 11, CC>();
  if (T != 0 && T != 11) return 0;
  switch (C) {
    VMT_CASE(64)
    VMT_CASE(128)
    VMT_CASE(256)
    VMT_CASE(512)
    default: return 0;
  }
#undef VMT_CASE
}

// w_outT: w_out transposed, (C, H). dekv: (B, 2, T, H) f32 -- dek then
// dev -- or null when T == 0.
extern "C" int vmt_temporal_block_bwd(
    const void* x, const void* gamma, const void* w_all, const void* w_outT,
    const void* bias, const void* ek, const void* ev, const void* g, void* dx,
    void* dgamma, void* dw_all, void* dw_out, void* dbias, void* dekv,
    void* workspace, int B, int F, int S, int C, int T, int heads,
    void* stream) {
  if (F != 11 || heads != kHeads) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0)
    return (int)launch_c<0>(C, x, gamma, w_all, w_outT, bias, nullptr, nullptr,
                            g, dx, dgamma, dw_all, dw_out, dbias, nullptr,
                            workspace, B, S, st);
  if (T == 11)
    return (int)launch_c<11>(C, x, gamma, w_all, w_outT, bias, ek, ev, g, dx,
                             dgamma, dw_all, dw_out, dbias, dekv, workspace, B,
                             S, st);
  return (int)cudaErrorInvalidValue;
}
