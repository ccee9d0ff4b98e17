// Pieces shared by row 8's two any-shape sources (any_linear_head.cu: the
// plan, the token sums, the merge and the entry points;
// any_linear_head_apply.cu: the apply), for sm_90a. Two translation units
// so that nvcc builds them side by side; the apply's launch crosses from
// one to the other, so its argument block has a name outside the
// anonymous namespace.
#pragma once

#include "any_linear.cuh"

namespace vmt_head {

// a launch's arguments: the stats kernel reads the stats fields of the
// plan (tile, group, stages), the apply its own (tile, span, group,
// stages, ohg)
struct HeadAny {
  const bf16* x;          // (BF, N, C)
  const float* gamma;     // (C)
  const bf16* w_qkv;      // (C, 3H)
  const bf16* w_out;      // (H, C)
  const float* out_bias;  // (C)
  const bf16* ctxp;       // (BF, heads, 2, DP, DP + 8): ctxn hi, then lo
  bf16* out;              // (BF, N, C)
  float* part_m;          // (BF, tiles, H): a tile's running max
  float* part_z;          // (BF, tiles, H)
  float* part_ctx;        // (BF, tiles, heads, d, d)
  int N, C, heads, d, tile, span, group, stages, ohg;
  float scale, inv_hw;
};

// the apply kernel at (dp, resident), `smem` bytes a block, one block a
// (span tokens, frame) of BF frames (any_linear_head_apply.cu)
cudaError_t launch_apply(const HeadAny& p, int dp, bool res, int smem, int BF,
                         cudaStream_t st);

}  // namespace vmt_head

namespace {

using vmt_head::HeadAny;

__host__ __device__ inline int round32(int v) {
  return (v + kLinKC - 1) / kLinKC * kLinKC;
}

// the bf16 lo parts of two floats, packed: bf16(a - bf16(a)), ...
__device__ __forceinline__ uint32_t lo_bf16x2(float a, float b) {
  return vmt::pack_bf16x2(a - round_bf16(a), b - round_bf16(b));
}

}  // namespace
