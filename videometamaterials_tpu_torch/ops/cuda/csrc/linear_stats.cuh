// The linear block's unclamped-capable token-softmax statistics, shared by
// the backward kernel (fused_linear_block_bwd.cu, where they are defined)
// and the head-layout forward (fused_linear_block_head.cu).
//
// Per folded frame over its N tokens (+ Mc conditioning tokens), with
// y = bf16(LN(x) gamma), k = y Wk, v = y Wv, kk = clip ? clip(k, +-60) : k:
//   m[a]      = max_tok kk[., a]
//   zinv[a]   = 1 / sum_tok exp(kk[., a] - m[a])
//   ctxn[h, a, e] = zinv[a] sum_tok exp(kk[., a] - m[a]) v[., e] / HW
// all float32: a per (frame, token tile) pass keeps an online max and
// rescales its partial sums, then an ordered merge per frame folds in the
// conditioning tokens once and the tiles in order (no atomics).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace vmt {

// Float32 scratch of the per-tile partials and the merged results.
struct OnlineStats {
  float *pctx, *pz, *pm;       // (BF, tiles, d, H), (BF, tiles, H) x 2
  float *ctxn, *m, *zinv;      // (BF, H, d), (BF, H) x 2
};

// Bytes of each buffer of OnlineStats, in its field order.
void online_stats_sizes(int BF, int N, int tile, size_t (&bytes)[6]);

// x: (BF, N, C) bf16; w_qkv: (C, 3H) bf16; ek/ev: (BF, Mc, H) bf16 or null.
// C in {64, 128, 256, 512}; tile a multiple of 8.
cudaError_t launch_online_stats(const __nv_bfloat16* x, const float* gamma,
                                const __nv_bfloat16* w_qkv,
                                const __nv_bfloat16* ek,
                                const __nv_bfloat16* ev, const OnlineStats& s,
                                int BF, int N, int C, int Mc, int tile,
                                float inv_hw, int clip, cudaStream_t stream);

}  // namespace vmt
