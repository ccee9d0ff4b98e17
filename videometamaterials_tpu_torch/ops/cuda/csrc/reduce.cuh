// Deterministic reductions shared by the backward kernels (reduce.cu).
//
// The parameter gradients of the fused blocks are sums over every token
// and position of a launch: dW = sum_rows A^T B. Blocks run in no order,
// so each block writes a partial sum of its chunk of rows and a second
// pass adds the partials in a fixed order -- no float atomics, so two
// runs give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace vmt {

constexpr int kContractTile = 64;   // output tile of the contraction (M, N)

// Bytes of f32 workspace launch_contract needs.
size_t contract_workspace(int groups, int rows, int M, int N);

// out[g][m][n] = sum_r A[g][r][m] * B[g][r][n]  (f32 result)
// A: bf16, rows x M per group (row stride M, group stride a_group);
// B: bf16, rows x N per group (row stride N, group stride b_group).
// M and N must be multiples of 64. ws: contract_workspace() bytes.
cudaError_t launch_contract(const __nv_bfloat16* A, const __nv_bfloat16* B,
                            float* out, int groups, int rows, int M, int N,
                            size_t a_group, size_t b_group, float* ws,
                            cudaStream_t stream);

// Bytes of f32 workspace launch_colsum needs.
size_t colsum_workspace(int batch, int rows, int cols);

// out[b][c] = sum_r in[b][r][c], rows in order (in groups of 64 rows
// first when there are many). ws: colsum_workspace() bytes.
cudaError_t launch_colsum(const float* in, float* out, int batch, int rows,
                          int cols, float* ws, cudaStream_t stream);

// Round a byte count up to 256 (sub-buffers carved from one workspace).
inline size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

}  // namespace vmt
