// The linear block's unclamped-capable token-softmax statistics, shared by
// the backward kernel (fused_linear_block_bwd.cu, where they are defined)
// and the head-layout forward (vmt_linear_head, fused_linear_block.cu).
//
// Per folded frame over its N tokens (+ Mc conditioning tokens), with
// y = bf16(LN(x) gamma), k = y Wk, v = y Wv, kk = clip ? clip(k, +-60) : k:
//   m[a]      = max_tok kk[., a]
//   zinv[a]   = 1 / sum_tok exp(kk[., a] - m[a])
//   ctxn[h, a, e] = zinv[a] sum_tok exp(kk[., a] - m[a]) v[., e] / HW
// and, with the cotangent g (the backward), Q = scale softmax_head(q),
// g_oh = g W_out^T:
//   dctx[h, a, e] = sum_tok Q[., a] g_oh[., e]
// The sums run on the tensor cores (bf16 operands, f32 sums) per (frame,
// 1024-token chunk, head pair), each 64-token sub-tile exponentiating
// against the running column max; an ordered merge per frame folds in the
// conditioning tokens once and the chunks in order (no atomics).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace vmt {

// Scratch of the chunk partials and the merged results.
struct OnlineStats {
  float *pctx, *pdctx, *pz, *pm;  // (BF, chunks, d, H) x 2, (BF, chunks, H) x 2
  float *ctxn, *m, *zinv;         // (BF, H, d), (BF, H) x 2
  __nv_bfloat16 *ctx_b, *dctx_b;  // bf16(ctxn), bf16(dctx): (BF, H, d)
};

// Bytes of each buffer of OnlineStats, in its field order.
void online_stats_sizes(int BF, int N, size_t (&bytes)[9]);

// x, g: (BF, N, C) bf16; w_qkv: (C, 3H) bf16; w_outT: (C, H) bf16; ek/ev:
// (BF, Mc, H) bf16 or null. g null (with w_outT null): the statistics
// without dctx (pdctx, dctx_b unused). C in {64, 128, 256, 512}.
cudaError_t launch_online_stats(const __nv_bfloat16* x, const float* gamma,
                                const __nv_bfloat16* w_qkv,
                                const __nv_bfloat16* w_outT,
                                const __nv_bfloat16* g,
                                const __nv_bfloat16* ek,
                                const __nv_bfloat16* ev, const OnlineStats& s,
                                int BF, int N, int C, int Mc, float inv_hw,
                                float scale, int clip, cudaStream_t stream);

}  // namespace vmt
