// Fused RBF Gram for Hopper (sm_90a):
//   out[i, j] = os * exp(-0.5 * sum_k ((x[i, k] - y[j, k]) / ls[k])^2)
//
// Replaces: sober_tpu/ops/pallas_kernels.py:rbf_gram_pallas (_rbf_kernel),
// the Pallas kernel that fuses the squared distance and the exp epilogue
// into one tile on the TPU.
//
// What bounds it on this card: on the main path d is 4 or 10, so each output
// costs ~3d flops and one 4-byte store. At 512 x 65,536 that is ~1 GFLOP
// against a 134 MB write: the kernel is bound by the output write to device
// memory, not by arithmetic, and a tensor-core product would buy nothing.
//
// What the design does about it: a plain 2-D tiled SIMT kernel. A block of
// 32 x 8 threads stages a tile of 64 scaled x rows and 128 scaled y rows in
// shared memory, transposed to [k][row] so a warp reads consecutive words.
// Each thread owns 8 x 4 outputs and accumulates the d-term sum of squared
// differences in registers (a direct difference, not the norm trick of
// ops/kernels.py: no cancellation and no clamp at 0 needed), then applies
// os * exp and stores. For a fixed output row the 32 lanes of a warp store
// 32 consecutive words, so every store is one coalesced 128-byte line.
// d may be anything up to MAX_D; the Matern epilogues can reuse the tile.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TX = 32;          // threads along y (output columns)
constexpr int TY = 8;           // threads along x (output rows)
constexpr int BM = 64;          // x rows per block
constexpr int BN = 128;         // y rows per block
constexpr int RM = BM / TY;     // output rows per thread
constexpr int RN = BN / TX;     // output columns per thread
constexpr int MAX_D = 64;       // (BM + BN) * MAX_D * 4 B = 48 KB of shared memory

__global__ void __launch_bounds__(TX * TY)
rbf_gram_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ ls, const float* __restrict__ os,
                float* __restrict__ out, int n, int m, int d) {
  extern __shared__ float smem[];
  float* xs = smem;             // [d][BM]
  float* ys = smem + d * BM;    // [d][BN]
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;

  // global reads are row-major and contiguous across the block; rows past
  // the edge are staged as zeros and never stored
  for (int e = tid; e < BM * d; e += TX * TY) {
    const int r = e / d, k = e - r * d, i = i0 + r;
    xs[k * BM + r] = i < n ? x[(size_t)i * d + k] / ls[k] : 0.f;
  }
  for (int e = tid; e < BN * d; e += TX * TY) {
    const int r = e / d, k = e - r * d, j = j0 + r;
    ys[k * BN + r] = j < m ? y[(size_t)j * d + k] / ls[k] : 0.f;
  }
  __syncthreads();

  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;

  for (int k = 0; k < d; ++k) {
    float xv[RM], yv[RN];
#pragma unroll
    for (int r = 0; r < RM; ++r) xv[r] = xs[k * BM + threadIdx.y + r * TY];
#pragma unroll
    for (int c = 0; c < RN; ++c) yv[c] = ys[k * BN + threadIdx.x + c * TX];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const float t = xv[r] - yv[c];
        acc[r][c] = fmaf(t, t, acc[r][c]);
      }
  }

  const float scale = *os;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = i0 + threadIdx.y + r * TY;
    if (i >= n) continue;
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int j = j0 + threadIdx.x + c * TX;
      if (j < m) out[(size_t)i * m + j] = scale * expf(-0.5f * acc[r][c]);
    }
  }
}

}  // namespace

// x (n, d), y (m, d), ls (d,), os (1,) and out (n, m): contiguous float32
// device buffers. Launches on `stream` and returns cudaGetLastError().
extern "C" int sober_rbf_gram(const float* x, const float* y, const float* ls,
                              const float* os, float* out, int n, int m, int d,
                              void* stream) {
  if (n <= 0 || m <= 0 || d < 1 || d > MAX_D || (n + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  const dim3 block(TX, TY);
  const size_t smem = (size_t)(BM + BN) * d * sizeof(float);
  rbf_gram_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      x, y, ls, os, out, n, m, d);
  return (int)cudaGetLastError();
}
