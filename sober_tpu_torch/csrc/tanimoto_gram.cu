// Tanimoto (Jaccard) similarity of 0/1 fingerprints for Hopper (sm_90a):
//   out[i, j] = |x_i & y_j| / max(|x_i| + |y_j| - |x_i & y_j|, 1e-20)
//
// Replaces: sober_tpu/ops/pallas_kernels.py:tanimoto_gram_pallas
// (_tanimoto_kernel), which runs the intersection counts as one fp32 MXU
// product per 256 x 256 tile with the denominator fused in.
//
// What bounds it on this card. At the dataset pi sweep (133,303 x 512 over
// 2048 bits, the pool packed beforehand) the intersections are
// 2 n m d = 2.8e11 operations of a 0/1 product: 0.141 ms at the 1,979
// TOP/s dense int8 tensor-core peak, against 0.09 ms to write the 273 MB
// fp32 Gram and 0.01 ms to read the 34 MB of packed words. So the
// operations bound it, and only the tensor cores come near that rate: the
// popcount units (16 a clock per SM) need ~1 ms for the same 4.4 G word
// pairs. At the recombination strips (500 x 2,000) a call is 64 tiles and
// launch latency bounds it.
//
// What the design does about it, in two kernels:
//  * pack: one warp per row. Lane l reads element 32w + l of word w, so a
//    warp's read of 32 consecutive floats is one coalesced 128-byte load,
//    and __ballot_sync gives the word (bit l = element 32w + l; elements
//    past d are zero bits). Lane 0 writes the word and the row's popcount.
//    A row holding a value other than 0 or 1 (NaN included) gets the count
//    -1 instead, and the device flag `bad` is raised; nothing waits on it.
//  * gram: the intersections as mma.sync m16n8k256 b1 with and.popc, which
//    takes the packed words as they are: an exact int32 count of the bit
//    pairs, 256 bits a step. (An s8 m16n8k32 product on bits unpacked to
//    bytes was 1.5x slower here; see PERF.md.) A persistent block of 8
//    warps walks 128 x 128 output tiles, 64 x 32 a warp, at most 2 blocks
//    an SM. The packed words of a tile's x and y rows stream through a
//    4-stage cp.async ring in shared memory, 16 words (512 bits) a row a
//    stage; the ring runs on across tiles, so the next tile's words load
//    while this one's products, division and stores run. Words are kept in
//    16-byte chunks whose order within a row is XOR-swizzled by the row, so
//    that a fragment load (8 rows x 4 words a warp) hits 32 distinct banks.
//    The epilogue divides in fp32 exactly as the reference does (an empty
//    intersection is +0 without a division: IEEE division takes its slow
//    path on a zero numerator, and most pairs share no bit), stages the
//    results through shared memory (padded rows, no bank conflicts) half a
//    tile at a time, and each warp writes whole 512-byte output rows with
//    16-byte streaming stores, which leave the packed words in L2. A row
//    or column of count -1 is NaN. Ragged edges: rows past n or m are
//    staged as zeros and never stored, words past ceil(d/32) are
//    zero-filled, and a word count that is not a multiple of 4 is copied
//    4 bytes at a time.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stddef.h>

namespace {

constexpr int PACK_WARPS = 8;           // rows per pack block
constexpr int BM = 128;                 // x rows a tile
constexpr int BN = 128;                 // y rows a tile
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;        // 64 output rows a warp
constexpr int WN = BN / WARPS_N;        // 32 output columns a warp
constexpr int MT = WM / 16;             // m16 tiles a warp
constexpr int NT = WN / 8;              // n8 tiles a warp
constexpr int KC = 16;                  // words a row a stage (4 chunks)
constexpr int STAGES = 4;
constexpr int STAGE_WORDS = (BM + BN) * KC;
constexpr int HALF_ROWS = BM / 2;       // output rows staged at a time
constexpr int OUT_LD = BN + 8;          // staging row stride (floats)
constexpr int RING_WORDS = STAGES * STAGE_WORDS;
constexpr int OUT_WORDS = HALF_ROWS * OUT_LD;
constexpr int COUNT_SLOTS = STAGES;     // the tile being finished and the up
                                        // to STAGES - 1 tiles loading ahead
constexpr int SMEM_BYTES = 4 * (RING_WORDS + OUT_WORDS + COUNT_SLOTS * (BM + BN));
constexpr int MAX_BLOCKS_PER_SM = 2;

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
    counts[row] = flagged ? -1 : total;
    if (flagged) atomicOr(bad, 1);
  }
}

// word w (0..3) of chunk c (0..3) of staged row r, within one stage
__device__ __forceinline__ int swz(int r, int c, int w) {
  return r * KC + ((c ^ ((r >> 1) & 3)) << 2) + w;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

struct Problem {
  const uint32_t* xw;
  const uint32_t* yw;
  const int* nx;
  const int* ny;
  float* out;
  int n, m, n_words, m_tiles, tiles, n_stages;
  bool vec;     // rows of 16-byte chunks: n_words % 4 == 0, aligned bases
};

// Load step `seq` of this block's walk (stage seq % n_stages of its tile
// number seq / n_stages) into ring slot seq % STAGES, and with a tile's
// first stage its counts into count slot (seq / n_stages) % COUNT_SLOTS.
// Rows past the edge and words past n_words are zero-filled. Commits one
// group, empty past the last tile.
__device__ __forceinline__ void load_step(const Problem& p, uint32_t* ring,
                                          int* counts, int seq) {
  const int q = seq / p.n_stages, st = seq - q * p.n_stages;
  const int tile = blockIdx.x + q * gridDim.x;
  if (tile < p.tiles) {
    const int i0 = (tile / p.m_tiles) * BM, j0 = (tile % p.m_tiles) * BN;
    const uint32_t base = static_cast<uint32_t>(
        __cvta_generic_to_shared(ring + (seq % STAGES) * STAGE_WORDS));
    const int k0 = st * KC;
    if (p.vec) {
      for (int e = threadIdx.x; e < (BM + BN) * 4; e += THREADS) {
        const int r = e >> 2, c = e & 3, k = k0 + 4 * c;
        const bool is_x = r < BM;
        const int row = is_x ? i0 + r : j0 + r - BM;
        const bool ok = row < (is_x ? p.n : p.m) && k < p.n_words;
        const uint32_t* src = ok ? (is_x ? p.xw : p.yw) + (size_t)row * p.n_words + k : p.xw;
        cp_async16(base + 4u * swz(r, c, 0), src, ok ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < (BM + BN) * KC; e += THREADS) {
        const int r = e / KC, kk = e % KC, k = k0 + kk;
        const bool is_x = r < BM;
        const int row = is_x ? i0 + r : j0 + r - BM;
        const bool ok = row < (is_x ? p.n : p.m) && k < p.n_words;
        const uint32_t* src = ok ? (is_x ? p.xw : p.yw) + (size_t)row * p.n_words + k : p.xw;
        cp_async4(base + 4u * swz(r, kk >> 2, kk & 3), src, ok ? 4 : 0);
      }
    }
    if (st == 0) {
      const uint32_t cbase = static_cast<uint32_t>(
          __cvta_generic_to_shared(counts + (q % COUNT_SLOTS) * (BM + BN)));
      for (int r = threadIdx.x; r < BM + BN; r += THREADS) {
        const bool is_x = r < BM;
        const int row = is_x ? i0 + r : j0 + r - BM;
        const bool ok = row < (is_x ? p.n : p.m);
        cp_async4(cbase + 4u * r, ok ? (is_x ? p.nx : p.ny) + row : p.nx, ok ? 4 : 0);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void mma_b1(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One stage's products into acc: chunks 2h and 2h + 1 (256 bits) are one
// k step. Lane (g, t) holds word t of each chunk: A rows g and g + 8 of an
// m16 tile, B row (output column) g of an n8 tile.
__device__ __forceinline__ void compute_stage(const uint32_t* sb,
                                              int (&acc)[MT][NT][4], int wm0,
                                              int wn0, int g, int t) {
#pragma unroll
  for (int h = 0; h < KC / 8; ++h) {
    uint32_t bw[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = BM + wn0 + nt * 8 + g;
      bw[nt][0] = sb[swz(r, 2 * h, t)];
      bw[nt][1] = sb[swz(r, 2 * h + 1, t)];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = wm0 + mt * 16 + g;
      const uint32_t a0 = sb[swz(r, 2 * h, t)], a1 = sb[swz(r + 8, 2 * h, t)];
      const uint32_t a2 = sb[swz(r, 2 * h + 1, t)];
      const uint32_t a3 = sb[swz(r + 8, 2 * h + 1, t)];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_b1(acc[mt][nt], a0, a1, a2, a3, bw[nt][0], bw[nt][1]);
    }
  }
}

// The reference's fp32 division, bit for bit. An empty intersection gives
// +0 (the denominator is at least 1e-20) without dividing.
__device__ __forceinline__ float tanimoto(int inter, int cx, int cy) {
  if (cx < 0 || cy < 0) return __int_as_float(0x7fffffff);   // NaN
  if (inter == 0) return 0.f;
  const float fi = (float)inter;
  return fi / fmaxf((float)cx + (float)cy - fi, 1e-20f);
}

__global__ void __launch_bounds__(THREADS, MAX_BLOCKS_PER_SM)
tanimoto_gram_kernel(const Problem p) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;
  float* so = reinterpret_cast<float*>(smem + RING_WORDS);
  int* counts = reinterpret_cast<int*>(smem + RING_WORDS + OUT_WORDS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const bool vec_out = (p.m & 3) == 0 && (reinterpret_cast<size_t>(p.out) & 15) == 0;

  // the ring runs STAGES - 1 steps ahead of the products, across tiles
  int seq = 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_step(p, ring, counts, s);

  for (int q = 0;; ++q) {
    const int tile = blockIdx.x + q * gridDim.x;
    if (tile >= p.tiles) break;
    const int i0 = (tile / p.m_tiles) * BM, j0 = (tile % p.m_tiles) * BN;
    int acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0;

    for (int st = 0; st < p.n_stages; ++st, ++seq) {
      asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2));
      __syncthreads();   // step seq landed for all; step seq - 1 is consumed
      load_step(p, ring, counts, seq + STAGES - 1);
      compute_stage(ring + (seq % STAGES) * STAGE_WORDS, acc, wm0, wn0, g, t);
    }

    // lane (g, t) holds rows g and g + 8, columns 2t and 2t + 1 of each
    // 16 x 8 tile; half h of the tile is the warps' m16 tiles 2h and 2h + 1
    const int* cx = counts + (q % COUNT_SLOTS) * (BM + BN);
    const int* cy = cx + BM;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h) __syncthreads();          // half 0 is stored
#pragma unroll
      for (int mt = 2 * h; mt < 2 * h + 2; ++mt) {
        const int r = wm0 + mt * 16 + g;                    // tile row
        const int sr = (wm0 / WM) * 32 + (mt - 2 * h) * 16 + g;   // staged row
        const int cx0 = cx[r], cx1 = cx[r + 8];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = wn0 + nt * 8 + 2 * t;
          const int cy0 = cy[c], cy1 = cy[c + 1];
          *reinterpret_cast<float2*>(so + sr * OUT_LD + c) = make_float2(
              tanimoto(acc[mt][nt][0], cx0, cy0), tanimoto(acc[mt][nt][1], cx0, cy1));
          *reinterpret_cast<float2*>(so + (sr + 8) * OUT_LD + c) = make_float2(
              tanimoto(acc[mt][nt][2], cx1, cy0), tanimoto(acc[mt][nt][3], cx1, cy1));
        }
      }
      __syncthreads();
      // a warp writes one 128-column row (512 B) a pass, 16 B a lane
#pragma unroll
      for (int e = threadIdx.x; e < HALF_ROWS * (BN / 4); e += THREADS) {
        const int sr = e / (BN / 4), c = 4 * (e % (BN / 4));
        const int i = i0 + (sr / 32) * WM + 32 * h + sr % 32, j = j0 + c;
        if (i >= p.n || j >= p.m) continue;
        const float4 v = *reinterpret_cast<const float4*>(so + sr * OUT_LD + c);
        float* o = p.out + (size_t)i * p.m + j;
        if (vec_out && j + 4 <= p.m) {
          __stcs(reinterpret_cast<float4*>(o), v);
        } else {
          const float vs[4] = {v.x, v.y, v.z, v.w};
          for (int k = 0; k < 4 && j + k < p.m; ++k) o[k] = vs[k];
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Blocks of the Gram kernel the device holds at once (SMs x blocks an SM),
// found at the first launch on each device, or 0 with *err set.
int resident_blocks(cudaError_t* err) {
  static int cache[64];
  int device = 0;
  *err = cudaGetDevice(&device);
  if (*err != cudaSuccess) return 0;
  if (device < 64 && cache[device] > 0) return cache[device];
  int sms = 0, per_sm = 0;
  *err = cudaFuncSetAttribute(tanimoto_gram_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tanimoto_gram_kernel, THREADS, SMEM_BYTES);
  if (*err == cudaSuccess && per_sm < 1) *err = cudaErrorInvalidConfiguration;
  if (*err != cudaSuccess) return 0;
  if (device < 64) cache[device] = sms * per_sm;
  return sms * per_sm;
}

}  // namespace

// x (n, d) contiguous float32 holding 0/1; words (n, n_words) uint32 with
// n_words = ceil(d / 32); counts (n,) int32, -1 for a row holding another
// value; bad (1,) int32, or'ed with 1 for such a row. Launches on `stream`
// and returns cudaGetLastError().
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
// their counts (-1: NaN in that row or column), out (n, m) float32:
// contiguous device buffers. Launches as many persistent blocks as the
// current device holds at once (at most one a tile) on `stream` and returns
// cudaGetLastError().
extern "C" int sober_tanimoto_gram(const uint32_t* xw, const uint32_t* yw,
                                   const int* nx, const int* ny, float* out,
                                   int n, int m, int n_words, void* stream) {
  if (n <= 0 || m <= 0 || n_words <= 0) return (int)cudaErrorInvalidValue;
  const long long m_tiles = (m + BN - 1) / BN;
  const long long tiles = ((n + BM - 1) / BM) * m_tiles;
  const long long steps = (tiles + 1) * ((n_words + KC - 1) / KC);
  if (steps > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const long long resident = resident_blocks(&err);
  if (err != cudaSuccess) return (int)err;
  const Problem p{xw, yw, nx, ny, out, n, m, n_words, (int)m_tiles, (int)tiles,
                  (n_words + KC - 1) / KC,
                  (n_words & 3) == 0 &&
                      ((reinterpret_cast<size_t>(xw) | reinterpret_cast<size_t>(yw)) & 15) == 0};
  const long long grid = tiles < resident ? tiles : resident;
  tanimoto_gram_kernel<<<(unsigned)grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
