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
// rate. Each block of 128 threads owns one 64 x 64 output tile of one
// chunk: 32-row slabs of A and B arrive through a 3-stage cp.async ring
// (zero-filled past the chunk's end) and the four warps, 32 x 32 each,
// multiply them on the tensor cores (mma.sync m16n8k16, A^T and B read
// with ldmatrix.trans from padded tiles, fp32 sums). A block's sum runs
// over its rows in a fixed order and the chunks are added in order, so two
// launches give the same bits.
#include "mma.cuh"
#include "reduce.cuh"

namespace vmt {
namespace {

constexpr int kSlab = 32;           // rows per cp.async stage
constexpr int kRing = 3;            // stages
constexpr int kTP = kContractTile + 8;  // padded pitch (bf16)
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

__global__ void __launch_bounds__(128) contract_partial(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
    float* __restrict__ part, int rows, int M, int N, size_t a_group,
    size_t b_group, int rows_per_chunk, int chunks) {
  __shared__ __align__(16) __nv_bfloat16 As[kRing][kSlab][kTP];
  __shared__ __align__(16) __nv_bfloat16 Bs[kRing][kSlab][kTP];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int n0 = blockIdx.x * kContractTile, m0 = blockIdx.y * kContractTile;
  const int g = blockIdx.z / chunks, chunk = blockIdx.z % chunks;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(rows, r_begin + rows_per_chunk);
  const int slabs = r_end > r_begin ? (r_end - r_begin + kSlab - 1) / kSlab : 0;
  const __nv_bfloat16* a = A + g * a_group;
  const __nv_bfloat16* b = B + g * b_group;

  // slab q: rows r_begin + 32 q .., 64 columns of A and of B (8 pieces of
  // 16 bytes a row)
  auto load_slab = [&](int q) {
#pragma unroll
    for (int i = t; i < 2 * kSlab * 8; i += 128) {
      const int which = i / (kSlab * 8), r = (i / 8) % kSlab, o = (i % 8) * 8;
      const int row = r_begin + q * kSlab + r;
      const bool valid = row < r_end;
      const size_t src_row = valid ? row : 0;
      if (which == 0)
        cp_async16(&As[q % kRing][r][o], a + src_row * M + m0 + o, valid);
      else
        cp_async16(&Bs[q % kRing][r][o], b + src_row * N + n0 + o, valid);
    }
  };
#pragma unroll
  for (int q = 0; q < kRing - 1; ++q) {
    if (q < slabs) load_slab(q);
    cp_async_commit();
  }
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  float acc[2][4][4] = {};
  for (int q = 0; q < slabs; ++q) {
    cp_async_wait<kRing - 2>();
    __syncthreads();
    if (q + kRing - 1 < slabs) load_slab(q + kRing - 1);
    cp_async_commit();
    const int st = q % kRing;
#pragma unroll
    for (int ks = 0; ks < kSlab / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4_t(af[mt], &As[st][ks * 16 + at_row_off(lane)]
                              [wm + mt * 16 + at_col_off(lane)]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bb[4];
        ldsm_x4_t(bb, &Bs[st][ks * 16 + bk_row_off(lane)]
                          [wn + np * 16 + bk_col_off(lane)]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bb[0], bb[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bb[2], bb[3]);
        }
      }
    }
  }
  float* out = part + ((size_t)g * chunks + chunk) * M * N;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int m = m0 + wm + mt * 16 + gq, n = n0 + wn + nt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(out + (size_t)(m + 8) * N + n) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
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
  contract_partial<<<grid, 128, 0, stream>>>(A, B, ws, rows, M, N, a_group,
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
