// Deterministic reductions for the backward kernels, for sm_90a: a split-K
// contraction over rows (dW = A^T B) and ordered column sums.
//
// The Pallas backward kernels accumulate their weight gradients across
// the sequential TPU grid in revisited output blocks (dwall_ref[fi] +=
// ys^T dqkv, dwout_ref += acc^T g, ...). On the card the blocks run in no
// order: the row sums are split into chunks, each block writes the partial
// product of its chunk and one 64 x 64 output tile, and an ordered column
// sum adds the chunks. The same column sum adds the per-block partials of
// dgamma, dbias, dout_bias and dek/dev.
//
// Bound: a contraction of R rows into an M x N result reads R (M + N) bf16
// and does 2 R M N operations; at the flagship level-0 shapes (R = 36864
// per frame, M = 64, N = 768) the operations bound it at the tensor-core
// rate. This first version runs its products on the CUDA cores in fp32
// (a 4 x 4 register tile per thread over 16-row slabs staged in shared
// memory); wgmma is later work.
#include "reduce.cuh"

namespace vmt {
namespace {

constexpr int kSlab = 16;           // rows per shared-memory stage
constexpr int kMaxChunks = 128;     // partial products per output tile
constexpr int kColsumGroup = 64;    // rows per first-stage group

int contract_chunks(int groups, int rows, int M, int N) {
  const int tiles = groups * (M / kContractTile) * (N / kContractTile);
  int chunks = (4 * 132 + tiles - 1) / tiles;
  const int max_by_rows = (rows + 255) / 256;
  if (chunks > max_by_rows) chunks = max_by_rows;
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  return chunks < 1 ? 1 : chunks;
}

__global__ void __launch_bounds__(256) contract_partial(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
    float* __restrict__ part, int rows, int M, int N, size_t a_group,
    size_t b_group, int rows_per_chunk, int chunks) {
  __shared__ __align__(16) float As[kSlab][kContractTile];
  __shared__ __align__(16) float Bs[kSlab][kContractTile];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int n0 = blockIdx.x * kContractTile, m0 = blockIdx.y * kContractTile;
  const int g = blockIdx.z / chunks, chunk = blockIdx.z % chunks;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(rows, r_begin + rows_per_chunk);
  const __nv_bfloat16* a = A + g * a_group;
  const __nv_bfloat16* b = B + g * b_group;
  float acc[4][4] = {};
  // loader: thread t stages row t / 16, columns 4 (t % 16) .. + 3
  const int lr = t / 16, lc = (t % 16) * 4;
  for (int r0 = r_begin; r0 < r_end; r0 += kSlab) {
    const int r = r0 + lr;
    float av[4] = {0.f, 0.f, 0.f, 0.f}, bv[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < r_end) {
      const __nv_bfloat16* ar = a + (size_t)r * M + m0 + lc;
      const __nv_bfloat16* br = b + (size_t)r * N + n0 + lc;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        av[u] = __bfloat162float(ar[u]);
        bv[u] = __bfloat162float(br[u]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      As[lr][lc + u] = av[u];
      Bs[lr][lc + u] = bv[u];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSlab; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float ar[4] = {a4.x, a4.y, a4.z, a4.w};
      const float br[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
  float* out = part + ((size_t)g * chunks + chunk) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(out + (size_t)(m0 + ty * 4 + i) * N + n0 +
                               tx * 4) = v;
  }
}

// out[b][rc][c] = sum of rows [rc*group, min(rows, (rc+1)*group)) of
// in[b][.][c], in order
__global__ void __launch_bounds__(256) colsum_kernel(
    const float* __restrict__ in, float* __restrict__ out, int rows,
    int cols, int group, int out_rows) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  const int rc = blockIdx.y;
  const int b = blockIdx.z;
  if (c >= cols) return;
  const float* src = in + (size_t)b * rows * cols + c;
  const int r0 = rc * group, r1 = min(rows, r0 + group);
  float s = 0.f;
  int r = r0;
  for (; r + 4 <= r1; r += 4) {
    const float v0 = src[(size_t)r * cols];
    const float v1 = src[(size_t)(r + 1) * cols];
    const float v2 = src[(size_t)(r + 2) * cols];
    const float v3 = src[(size_t)(r + 3) * cols];
    s += v0;
    s += v1;
    s += v2;
    s += v3;
  }
  for (; r < r1; ++r) s += src[(size_t)r * cols];
  out[((size_t)b * out_rows + rc) * cols + c] = s;
}

}  // namespace

size_t contract_workspace(int groups, int rows, int M, int N) {
  return (size_t)groups * contract_chunks(groups, rows, M, N) * M * N *
         sizeof(float);
}

cudaError_t launch_contract(const __nv_bfloat16* A, const __nv_bfloat16* B,
                            float* out, int groups, int rows, int M, int N,
                            size_t a_group, size_t b_group, float* ws,
                            cudaStream_t stream) {
  if (M % kContractTile || N % kContractTile || rows <= 0)
    return cudaErrorInvalidValue;
  const int chunks = contract_chunks(groups, rows, M, N);
  int per = (rows + chunks - 1) / chunks;
  per = (per + kSlab - 1) / kSlab * kSlab;
  const dim3 grid(N / kContractTile, M / kContractTile, groups * chunks);
  contract_partial<<<grid, 256, 0, stream>>>(A, B, ws, rows, M, N, a_group,
                                             b_group, per, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // chunks <= kMaxChunks: one ordered pass adds them
  const dim3 grid2((M * N + 255) / 256, 1, groups);
  colsum_kernel<<<grid2, 256, 0, stream>>>(ws, out, chunks, M * N, chunks, 1);
  return cudaGetLastError();
}

size_t colsum_workspace(int batch, int rows, int cols) {
  if (rows <= 2 * kColsumGroup) return 0;
  const int groups = (rows + kColsumGroup - 1) / kColsumGroup;
  return (size_t)batch * groups * cols * sizeof(float);
}

cudaError_t launch_colsum(const float* in, float* out, int batch, int rows,
                          int cols, float* ws, cudaStream_t stream) {
  const int cb = (cols + 255) / 256;
  if (rows <= 2 * kColsumGroup) {
    colsum_kernel<<<dim3(cb, 1, batch), 256, 0, stream>>>(in, out, rows, cols,
                                                          rows, 1);
    return cudaGetLastError();
  }
  const int groups = (rows + kColsumGroup - 1) / kColsumGroup;
  colsum_kernel<<<dim3(cb, groups, batch), 256, 0, stream>>>(
      in, ws, rows, cols, kColsumGroup, groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_kernel<<<dim3(cb, 1, batch), 256, 0, stream>>>(ws, out, groups, cols,
                                                        groups, 1);
  return cudaGetLastError();
}

}  // namespace vmt
