// Fused RBF Gram for Hopper (sm_90a):
//   out[i, j] = os * exp(-0.5 * sum_k ((x[i, k] - y[j, k]) / ls[k])^2)
//
// Replaces: sober_tpu/ops/pallas_kernels.py:rbf_gram_pallas (_rbf_kernel),
// the Pallas kernel that fuses the squared distance and the exp epilogue
// into one tile on the TPU.
//
// What bounds it on this card: on the main path d is 4 or 10, so each output
// costs ~2d + 2 instructions and one 4-byte store. At 512 x 65,536 that is
// ~0.03 ms of fp32 instructions against 0.040 ms to write the 134 MB Gram: the
// output write to device memory bounds it, and the arithmetic comes close
// enough that the two must overlap. A tensor-core product would buy nothing.
//
// What the design does about it:
//  * Persistent blocks of 8 warps, as many as the card holds at once (3 an
//    SM) and never more than the tiles, take the output tiles strided by
//    the grid, so the small Grams (<= 512 x 512, 32 tiles) keep one tile a
//    block. A tile is 64 x 128 outputs; for rows of at most 512 floats whose
//    Gram outnumbers the blocks (the tall strips K(pool, X)), 16 x 512 (or
//    32 x 256 for m <= 256): whole rows, so the stores of a tile are one
//    contiguous run of lines rather than 64 runs that start and end inside
//    128-byte lines shared with other tiles (m = 500 rows are 2000 bytes).
//  * The operand rows of a tile are copied with cp.async in passes of up to
//    32 features; for d <= 32 the x rows and the y rows of a tile are each
//    one contiguous span, copied 16 bytes at a time. Each pass is then
//    transposed to [k][row] in shared memory and scaled by
//    sqrt(0.5 log2 e) / ls[k], and the next pass (of this tile or the next)
//    is copied while this one computes. Whole-row tiles all have the same
//    y rows, so with one pass a block stages those once, at its first tile.
//    Any d runs; d <= 32 is one pass. Rows past n or m are zero-filled and
//    never stored.
//  * With the scale folded in, the epilogue is one ex2.approx.ftz and one
//    multiply by os an output (2^-r equals exp(-0.5 r') for the unfolded
//    r'). Squared differences are summed directly (not by the norm trick of
//    ops/kernels.py, whose cancellation grows with d). ex2.approx.ftz writes
//    0 where the result is below 2^-126 and the reference keeps a denormal
//    (< 1.2e-38 apart).
//  * A warp owns 8 output rows and 128 columns of a tile, a lane 4
//    consecutive columns, so the lane's 8 x 4 sums read one float4 of y and
//    two broadcast float4s of x from shared memory a feature, and each
//    output row leaves as one 16-byte streaming store (st.global.cs.v4): a
//    warp writes 512 contiguous bytes at once, and the stores drain while
//    the warp goes on. (Staging the tile in shared memory for a bulk copy a
//    row or a TMA tensor store a warp, and write-back stores, were slower;
//    see PERF.md.) Where m is not a multiple of 4 the rows are not 16-byte
//    aligned, and the outputs are written 4 bytes at a time.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RM = 8;                   // output rows a warp (and a lane)
constexpr int RN = 4;                   // output columns a lane
constexpr int GN = 32 * RN;             // columns a warp: a column group
constexpr int DK = 32;                  // features staged a pass
constexpr int MAX_CG = 4;               // column groups a tile
constexpr int MAX_BLOCKS_PER_SM = 3;
// sqrt(0.5 * log2(e)): scaled by it over ls, 2^-|x - y|^2 is the RBF
constexpr float FOLD = 0.8493218002880191f;

// The Gram, and probes that only tools/rbf_gram_bench.py builds (with
// SOBER_RBF_GRAM_PROBES defined): kNoStore computes every output and writes
// none; kNoCompute stages the operands and writes os everywhere.
enum Probe { kFull = 0, kNoStore = 1, kNoCompute = 2 };

struct Problem {
  const float* x;
  const float* y;
  const float* ls;
  const float* os;
  float* out;
  int n, m, d, ls_stride, m_tiles, tiles, passes;
  int cg, tr, tc, br, ld;   // column groups, x rows, y rows, both, floats a
                            // feature of the transposed pass
  bool span;                // one pass and 16-byte aligned x and y: a
                            // tile's rows are copied 16 bytes at a time
  bool vec;                 // m % 4 == 0 and out 16-byte aligned
};

// Where a thread's elements of a [rows][w] array start and how they step:
// element e = tid + t * THREADS is row e / w, column e % w; rows and
// columns advance without a division.
struct Walk {
  int w, r0, c0, dr, dc;
};

__device__ __forceinline__ Walk make_walk(int w) {
  const int r0 = threadIdx.x / w, dr = THREADS / w;
  return {w, r0, (int)threadIdx.x - r0 * w, dr, THREADS - dr * w};
}

__device__ __forceinline__ void step(const Walk& w, int& r, int& c) {
  r += w.dr;
  c += w.dc;
  if (c >= w.w) {
    c -= w.w;
    ++r;
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// What step seq of a block stages: its tile (tiles blockIdx.x, + gridDim.x,
// ...; -1 past the last), the tile's first x and y rows, its pass, and
// whether its y rows must be staged (not when one pass of whole-row tiles
// staged them at the block's first tile: they are still in sb).
struct Stage {
  int tile, i0, j0, pass;
  bool y;
};

__device__ __forceinline__ Stage stage_of(const Problem& p, int seq) {
  const int q = p.passes == 1 ? seq : seq / p.passes;
  const int tile = blockIdx.x + q * gridDim.x, pass = seq - q * p.passes;
  if (tile >= p.tiles) return {-1, 0, 0, 0, false};
  const int ti = tile / p.m_tiles;
  return {tile, ti * p.tr, (tile - ti * p.m_tiles) * p.tc, pass,
          !(p.m_tiles == 1 && p.passes == 1 && q > 0)};
}

// Copy rows [r0, r0 + rows) of a (count, d) operand, features [k0, k0 +
// kw), into raw rows [at, at + rows) of [*][kw] (rows past count as zeros).
__device__ __forceinline__ void copy_rows(const Problem& p, uint32_t raw, const float* g,
                                          int count, int r0, int rows, int at, int k0,
                                          int kw) {
  if (p.span) {
    // the rows are one span of rows d floats
    const int valid = (count - r0 < rows ? count - r0 : rows) * p.d;
    const float* span = g + (size_t)r0 * p.d;
    for (int e = 4 * threadIdx.x; e < rows * p.d; e += 4 * THREADS) {
      const int left = valid - e;
      const int bytes = left >= 4 ? 16 : left > 0 ? 4 * left : 0;
      cp_async16(raw + 4u * (at * p.d + e), bytes ? span + e : p.x, bytes);
    }
  } else {
    const Walk cw = make_walk(kw);
    for (int r = cw.r0, c = cw.c0; r < rows; step(cw, r, c)) {
      const bool ok = r0 + r < count;
      cp_async4(raw + 4u * ((at + r) * kw + c),
                ok ? g + (size_t)(r0 + r) * p.d + k0 + c : p.x, ok ? 4 : 0);
    }
  }
}

// Copy what step seq stages into raw as [br][kw], unscaled, and the pass's
// scales into scale. Commits one group, empty past the block's last tile.
// Returns what it staged.
__device__ __forceinline__ Stage load_step(const Problem& p, float* raw, float* scale,
                                           int seq, const Walk& full, const Walk& last) {
  const Stage s = stage_of(p, seq);
  if (s.tile >= 0) {
    const int k0 = s.pass * DK;
    const int kw = s.pass == p.passes - 1 ? last.w : full.w;
    if (threadIdx.x < kw)
      scale[threadIdx.x] = FOLD / p.ls[(size_t)(k0 + threadIdx.x) * p.ls_stride];
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
    copy_rows(p, base, p.x, p.n, s.i0, p.tr, 0, k0, kw);
    if (s.y) copy_rows(p, base, p.y, p.m, s.j0, p.tc, p.tr, k0, kw);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return s;
}

// raw rows [0, rows) of [*][w.w] into sb as [k][row], scaled
__device__ __forceinline__ void transpose(const Walk& w, const float* raw, float* sb,
                                          int ld, const float* scale, int rows) {
  for (int r = w.r0, k = w.c0; r < rows; step(w, r, k))
    sb[k * ld + r] = raw[r * w.w + k] * scale[k];
}

__device__ __forceinline__ float ex2(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// 4 bytes at a time, for rows that are not 16-byte aligned and ragged ends
__device__ __forceinline__ void store_scalar(float* o, const float4& v, int left) {
  if (left > 0) __stcs(o, v.x);
  if (left > 1) __stcs(o + 1, v.y);
  if (left > 2) __stcs(o + 2, v.z);
  if (left > 3) __stcs(o + 3, v.w);
}

template <int PROBE>
__global__ void __launch_bounds__(THREADS, MAX_BLOCKS_PER_SM)
rbf_gram_kernel(const Problem p) {
  extern __shared__ __align__(16) float smem[];
  const int dk_max = p.d < DK ? p.d : DK;
  float* raw = smem;                          // [br][kw], as copied
  float* sb = raw + p.br * dk_max;            // [kw][ld], scaled
  float* scales = sb + dk_max * p.ld;         // [2][DK], by step parity
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // warp w owns rows RM (w / cg) .. of the tile and columns GN (w % cg) ..
  const int wr = RM * (warp / p.cg), wc = GN * (warp % p.cg) + RN * lane;
  const Walk full = make_walk(DK);
  const Walk last = make_walk(p.d - (p.passes - 1) * DK);
  const float os = *p.os;

  int seq = 0;
  Stage staged = load_step(p, raw, scales, 0, full, last);
  while (staged.tile >= 0) {
    const int i0 = staged.i0, j0 = staged.j0;
    float acc[RM][RN];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;

    for (int pass = 0; pass < p.passes; ++pass, ++seq) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();   // step seq landed for all; step seq - 1 is computed
      const Walk& w = pass == p.passes - 1 ? last : full;
      const float* scale = scales + (seq & 1) * DK;
      transpose(w, raw, sb, p.ld, scale, staged.y ? p.br : p.tr);
      __syncthreads();   // sb is ready and raw is free
      staged = load_step(p, raw, scales + ((seq + 1) & 1) * DK, seq + 1, full, last);
      if (PROBE == kNoCompute) continue;
      const int kw = w.w;
#pragma unroll 2
      for (int k = 0; k < kw; ++k) {
        const float* row = sb + k * p.ld;
        const float4 xa = *reinterpret_cast<const float4*>(row + wr);
        const float4 xb = *reinterpret_cast<const float4*>(row + wr + 4);
        const float4 yv = *reinterpret_cast<const float4*>(row + p.tr + wc);
        const float xs[RM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const float ys[RN] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int c = 0; c < RN; ++c) {
            const float t = xs[r] - ys[c];
            acc[r][c] = fmaf(-t, t, acc[r][c]);
          }
      }
    }

    float4 v[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r)
      v[r] = PROBE == kNoCompute
                 ? make_float4(os, os, os, os)
                 : make_float4(os * ex2(acc[r][0]), os * ex2(acc[r][1]),
                               os * ex2(acc[r][2]), os * ex2(acc[r][3]));
    if (PROBE == kNoStore) {
      // keep every output live without writing it
      float sink = 0.f;
#pragma unroll
      for (int r = 0; r < RM; ++r) sink += v[r].x + v[r].y + v[r].z + v[r].w;
      if (sink == -1.f) p.out[0] = sink;
      continue;
    }
    const int j = j0 + wc;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = i0 + wr + r;
      if (i >= p.n || j >= p.m) continue;
      float* o = p.out + (size_t)i * p.m + j;
      if (p.vec)
        __stcs(reinterpret_cast<float4*>(o), v[r]);
      else
        store_scalar(o, v[r], p.m - j);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows staged a tile and the floats of the transposed pass
constexpr int staged_rows(int cg) { return RM * WARPS / cg + GN * cg; }
constexpr int sb_stride(int cg) { return staged_rows(cg) + 4; }

size_t smem_bytes(int cg, int dk) {
  return sizeof(float) * ((size_t)dk * (staged_rows(cg) + sb_stride(cg)) + 2 * DK);
}

// Blocks with cg column groups at dk staged features that the device holds
// at once (SMs x blocks an SM), found at the first launch of each on each
// device, or 0 with *err set.
template <int PROBE>
int resident_blocks(int cg, int dk, cudaError_t* err) {
  static int cache[64][MAX_CG + 1][DK + 1];
  int device = 0;
  *err = cudaGetDevice(&device);
  if (*err != cudaSuccess) return 0;
  if (device < 64 && cache[device][cg][dk] > 0) return cache[device][cg][dk];
  int sms = 0, per_sm = 0;
  *err = cudaFuncSetAttribute(rbf_gram_kernel<PROBE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(MAX_CG, DK));
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rbf_gram_kernel<PROBE>,
                                                         THREADS, smem_bytes(cg, dk));
  if (*err == cudaSuccess && per_sm < 1) *err = cudaErrorInvalidConfiguration;
  if (*err != cudaSuccess) return 0;
  if (device < 64) cache[device][cg][dk] = sms * per_sm;
  return sms * per_sm;
}

template <int PROBE>
int launch(const float* x, const float* y, const float* ls, const float* os,
           float* out, int n, int m, int d, int ls_stride, void* stream) {
  if (n <= 0 || m <= 0 || d < 1 || ls_stride < 0) return (int)cudaErrorInvalidValue;
  const long long passes = (d + DK - 1) / DK;
  const int dk = d < DK ? d : DK;
  cudaError_t err;
  // Rows of at most 512 floats whose Gram outnumbers the blocks: tiles of
  // whole rows (one column tile), whose stores cover whole 128-byte lines
  // and whose y rows stay staged from tile to tile. Else 64 x 128.
  long long resident = resident_blocks<PROBE>(1, dk, &err);
  if (err != cudaSuccess) return (int)err;
  const long long tiles1 = ((n + RM * WARPS - 1LL) / (RM * WARPS)) * ((m + GN - 1) / GN);
  int cg = 1;
  if (passes == 1 && m <= MAX_CG * GN && tiles1 > resident)
    while (cg * GN < m) cg *= 2;
  const int tr = RM * WARPS / cg, tc = GN * cg;
  const long long m_tiles = (m + tc - 1) / tc;
  const long long tiles = ((n + tr - 1LL) / tr) * m_tiles;
  if (tiles * passes + 1 > 0x7fffffffLL || (long long)staged_rows(cg) * d > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  resident = resident_blocks<PROBE>(cg, dk, &err);
  if (err != cudaSuccess) return (int)err;
  const long long grid = tiles < resident ? tiles : resident;
  const Problem p{x, y, ls, os, out, n, m, d, ls_stride, (int)m_tiles, (int)tiles,
                  (int)passes, cg, tr, tc, staged_rows(cg), sb_stride(cg),
                  passes == 1 &&
                      ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(y)) & 15) == 0,
                  (m & 3) == 0 && (reinterpret_cast<size_t>(out) & 15) == 0};
  rbf_gram_kernel<PROBE>
      <<<(unsigned)grid, THREADS, smem_bytes(cg, dk), (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n, d), y (m, d), ls (d,) or one value read with ls_stride 0, os (1,)
// and out (n, m): contiguous float32 device buffers. Launches as many
// persistent blocks as the current device holds at once (at most one a
// tile) on `stream` and returns cudaGetLastError().
extern "C" int sober_rbf_gram(const float* x, const float* y, const float* ls,
                              const float* os, float* out, int n, int m, int d,
                              int ls_stride, void* stream) {
  return launch<kFull>(x, y, ls, os, out, n, m, d, ls_stride, stream);
}

#ifdef SOBER_RBF_GRAM_PROBES
// The same with a probe: 1 no global stores, 2 no distances and no exp.
extern "C" int sober_rbf_gram_probe(const float* x, const float* y, const float* ls,
                                    const float* os, float* out, int n, int m, int d,
                                    int ls_stride, int probe, void* stream) {
  return probe == kNoStore     ? launch<kNoStore>(x, y, ls, os, out, n, m, d, ls_stride, stream)
         : probe == kNoCompute ? launch<kNoCompute>(x, y, ls, os, out, n, m, d, ls_stride, stream)
                               : (int)cudaErrorInvalidValue;
}
#endif
