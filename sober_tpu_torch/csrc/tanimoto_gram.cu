// Tanimoto (Jaccard) similarity of 0/1 fingerprints for Hopper (sm_90a):
//   out[i, j] = |x_i & y_j| / max(|x_i| + |y_j| - |x_i & y_j|, 1e-20)
//
// Replaces: sober_tpu/ops/pallas_kernels.py:tanimoto_gram_pallas
// (_tanimoto_kernel), which runs the intersection counts as one fp32 MXU
// product per 256 x 256 tile with the denominator fused in.
//
// What bounds it on this card: the bits. Stored as fp32 0/1 values a
// 2048-bit fingerprint is 8 KB, and an fp32 product spends 2 flops on each
// bit pair; packed 32 to a word it is 256 B, and one AND plus one popcount
// covers 32 bit pairs. The dataset pi sweep (133,303 x 512 over 2048 bits)
// is ~280 GFLOP as an fp32 GEMM but ~4.4 G word pairs here, so the Gram is
// bound by the SM's popcount rate (16 a clock per SM), not by memory.
//
// What the design does about it, in two kernels:
//  * pack: one warp per row. Lane l reads element 32w + l of word w, so a
//    warp's read of 32 consecutive floats is one coalesced 128-byte load,
//    and __ballot_sync gives the word (bit l = element 32w + l; elements
//    past d are zero bits). Lane 0 writes the word and the row's popcount.
//    A value other than 0 or 1 (NaN included) sets a flag that the wrapper
//    reads and raises on, since popcounts are only right for 0/1 inputs.
//  * gram: a 2-D tiled SIMT kernel. A block of 16 x 16 threads owns a
//    64 x 64 output tile, 4 x 4 outputs a thread. The packed words of its
//    64 x rows and 64 y rows are staged in shared memory, CHUNK words at a
//    time (one chunk at d = 2048), transposed to [word][row] with one word
//    of padding so that both the staging stores and the inner-loop loads
//    are free of bank conflicts. The intersection is an exact int32 sum of
//    __popc(a & b); the epilogue divides in fp32, so an all-zero row pair
//    (the zero padding of pad_observations) gives 0 / 1e-20 = 0.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stddef.h>

namespace {

constexpr int PACK_WARPS = 8;   // rows per pack block
constexpr int TX = 16;          // threads along y (output columns)
constexpr int TY = 16;          // threads along x (output rows)
constexpr int BM = 64;          // x rows per block
constexpr int BN = 64;          // y rows per block
constexpr int RM = BM / TY;     // output rows per thread
constexpr int RN = BN / TX;     // output columns per thread
constexpr int CHUNK = 64;       // words staged per pass: 2 * 64 * 65 * 4 B = 33 KB

__global__ void __launch_bounds__(32 * PACK_WARPS)
pack_bits_kernel(const float* __restrict__ x, uint32_t* __restrict__ words,
                 int* __restrict__ counts, int* __restrict__ bad, int n, int d,
                 int n_words) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * PACK_WARPS + (threadIdx.x >> 5);
  if (row >= n) return;
  const float* xr = x + (size_t)row * d;
  uint32_t* wr = words + (size_t)row * n_words;
  int total = 0;
  bool flagged = false;
  for (int w = 0; w < n_words; ++w) {
    const int k = w * 32 + lane;
    const float v = k < d ? xr[k] : 0.f;
    const uint32_t word = __ballot_sync(0xffffffffu, v != 0.f);
    if (__any_sync(0xffffffffu, v != 0.f && v != 1.f)) flagged = true;
    if (lane == 0) wr[w] = word;
    total += __popc(word);
  }
  if (lane == 0) {
    counts[row] = total;
    if (flagged) atomicOr(bad, 1);
  }
}

__global__ void __launch_bounds__(TX * TY)
tanimoto_gram_kernel(const uint32_t* __restrict__ xw,
                     const uint32_t* __restrict__ yw,
                     const int* __restrict__ nx, const int* __restrict__ ny,
                     float* __restrict__ out, int n, int m, int n_words) {
  __shared__ uint32_t xs[CHUNK][BM + 1];
  __shared__ uint32_t ys[CHUNK][BN + 1];
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;

  int acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0;

  for (int k0 = 0; k0 < n_words; k0 += CHUNK) {
    const int kw = min(CHUNK, n_words - k0);
    // consecutive threads read consecutive words of a row; rows past the
    // edge are staged as zeros and never stored
    for (int e = tid; e < BM * kw; e += TX * TY) {
      const int r = e / kw, k = e - r * kw, i = i0 + r;
      xs[k][r] = i < n ? xw[(size_t)i * n_words + k0 + k] : 0u;
    }
    for (int e = tid; e < BN * kw; e += TX * TY) {
      const int r = e / kw, k = e - r * kw, j = j0 + r;
      ys[k][r] = j < m ? yw[(size_t)j * n_words + k0 + k] : 0u;
    }
    __syncthreads();
    for (int k = 0; k < kw; ++k) {
      uint32_t a[RM], b[RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = xs[k][threadIdx.y + r * TY];
#pragma unroll
      for (int c = 0; c < RN; ++c) b[c] = ys[k][threadIdx.x + c * TX];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[r][c] += __popc(a[r] & b[c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = i0 + threadIdx.y + r * TY;
    if (i >= n) continue;
    const float cx = (float)nx[i];
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int j = j0 + threadIdx.x + c * TX;
      if (j < m) {
        const float inter = (float)acc[r][c];
        out[(size_t)i * m + j] = inter / fmaxf(cx + (float)ny[j] - inter, 1e-20f);
      }
    }
  }
}

}  // namespace

// x (n, d) contiguous float32 holding 0/1; words (n, n_words) uint32 with
// n_words = ceil(d / 32); counts (n,) int32; bad (1,) int32, which must be 0
// on entry and is set to 1 if x holds a value other than 0 or 1. Launches
// on `stream` and returns cudaGetLastError().
extern "C" int sober_pack_bits(const float* x, uint32_t* words, int* counts,
                               int* bad, int n, int d, void* stream) {
  const int n_words = (d + 31) / 32;
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + PACK_WARPS - 1) / PACK_WARPS;
  pack_bits_kernel<<<blocks, 32 * PACK_WARPS, 0, (cudaStream_t)stream>>>(
      x, words, counts, bad, n, d, n_words);
  return (int)cudaGetLastError();
}

// xw (n, n_words) and yw (m, n_words) packed words, nx (n,) and ny (m,)
// their popcounts, out (n, m) float32: contiguous device buffers. Launches
// on `stream` and returns cudaGetLastError().
extern "C" int sober_tanimoto_gram(const uint32_t* xw, const uint32_t* yw,
                                   const int* nx, const int* ny, float* out,
                                   int n, int m, int n_words, void* stream) {
  if (n <= 0 || m <= 0 || n_words <= 0 || (n + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  const dim3 block(TX, TY);
  tanimoto_gram_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      xw, yw, nx, ny, out, n, m, n_words);
  return (int)cudaGetLastError();
}
