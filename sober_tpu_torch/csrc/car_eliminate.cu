// Caratheodory elimination loop for Hopper (sm_90a): n_take sequential
// eliminations of a weighted configuration along an orthonormal null basis,
// each followed by a Householder deflation of the basis.
//
// Replaces: sober_tpu/ops/pallas_car.py:car_eliminate_pallas (_car_kernel),
// whose semantics equal the XLA loop of sober_tpu/core/rchq.py:_caratheodory.
// Step t, on lanes i < m (one lane per point) and basis rows r >= t:
//   mu *= 1 - elim; active = mu > 0 && mask > 0 && !elim
//   phi = row t; flip its sign when no active lane is positive
//   alpha = mu / phi on positive active lanes; idx = FIRST lane at min alpha
//   valid = |phi|^2 > 1e-10 && any positive lane && alpha_min finite
//   mu = max(mu - alpha_min * phi, 0), mu[idx] = 0, elim[idx] = 1
//   u = column idx of rows >= t; v = u + sign(u_t) |u| e_t (u_t >= 0 -> +1)
//   rows >= t -= (2 / max(|v|^2, 1e-30)) v (v^T rows)   (skipped if !valid)
// Row t is then retired: rows are the transposed basis (q, m), so the
// drop-first-column step of the XLA loop is just moving on to row t + 1.
//
// What bounds it on this card: latency and synchronisation. A step is
// O(m q) flops (80k at m=400, q=200) spread over a few dependent phases: a
// lane reduction, the argmin, a gather of one column, a q-reduction and the
// rank-1 update. No step can start before the previous one ends.
//
// What the design does about it: one thread block runs the whole n_take loop
// for one CAR, with __syncthreads() between phases and no return to the host
// (the JAX loop paid a dispatch per step). Each thread owns up to LPT lanes
// and keeps their mu, elim and mask in registers. The lane reductions (|phi|^2,
// any positive, and the first-argmin of alpha for both signs of phi) are
// fused into one block reduction, so a step has two. Column i of the basis
// is read and rewritten only by the thread owning lane i, so the dot product
// and the rank-1 update need no sync between them, and a warp touches 32
// consecutive words of a row at a time. That dot product is accumulated in
// fp64 (see the loop): the elimination is chaotic in fp32, since rounding in
// mu grows from step to step, and past a few dozen steps two correct fp32
// implementations (or one fp32 and one fp64 run) pick different lanes, all
// valid and with the same moments. The transposed basis lives in a global
// scratch buffer: at m=400, q=200 it is 320 KB, more than the 227 KB of
// shared memory a block may have, and it stays resident in the 50 MB L2. At
// m=200, q=100 (80 KB) it would fit in shared memory; that, and a cluster
// that splits the 320 KB case over two blocks' shared memory, are left for
// later. Independent CARs run as a grid of blocks (batch = 1 on the main
// path).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int LPT = 4;             // lanes per thread: m <= LPT * 1024
constexpr int MAX_THREADS = 1024;
constexpr int NO_LANE = 0x7fffffff;

struct Cand {
  float phisq;   // sum of phi^2 over lanes
  float apos;    // min mu/phi over active lanes with phi > 0
  int ipos;      // first lane attaining apos
  float aneg;    // min mu/(-phi) over active lanes with phi < 0
  int ineg;
  int flags;     // bit 0: some active phi > 0; bit 1: some active phi < 0
};

__device__ __forceinline__ void take_min(float& a, int& i, float b, int j) {
  if (b < a || (b == a && j < i)) { a = b; i = j; }
}

__device__ __forceinline__ Cand merge(Cand a, const Cand& b) {
  a.phisq += b.phisq;
  take_min(a.apos, a.ipos, b.apos, b.ipos);
  take_min(a.aneg, a.ineg, b.aneg, b.ineg);
  a.flags |= b.flags;
  return a;
}

__device__ __forceinline__ Cand shfl_down(const Cand& c, int off) {
  Cand o;
  o.phisq = __shfl_down_sync(0xffffffffu, c.phisq, off);
  o.apos = __shfl_down_sync(0xffffffffu, c.apos, off);
  o.ipos = __shfl_down_sync(0xffffffffu, c.ipos, off);
  o.aneg = __shfl_down_sync(0xffffffffu, c.aneg, off);
  o.ineg = __shfl_down_sync(0xffffffffu, c.ineg, off);
  o.flags = __shfl_down_sync(0xffffffffu, c.flags, off);
  return o;
}

// Block-wide reduction; every thread returns the block's result. blockDim.x
// is a multiple of 32.
__device__ Cand block_reduce(Cand c, Cand* warp_part, Cand* result) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) c = merge(c, shfl_down(c, off));
  if (lane == 0) warp_part[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = lane < n_warps ? warp_part[lane]
                       : Cand{0.f, INFINITY, NO_LANE, INFINITY, NO_LANE, 0};
    for (int off = 16; off > 0; off >>= 1) c = merge(c, shfl_down(c, off));
    if (lane == 0) *result = c;
  }
  __syncthreads();
  return *result;
}

__device__ float block_sum(float s, float* warp_part, float* result) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) warp_part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < n_warps ? warp_part[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) *result = s;
  }
  __syncthreads();
  return *result;
}

__global__ void __launch_bounds__(MAX_THREADS)
car_eliminate_kernel(const float* __restrict__ mu_in,
                     const float* __restrict__ big_n,
                     const float* __restrict__ mask_in,
                     float* __restrict__ nt, float* __restrict__ mu_out,
                     float* __restrict__ elim_out, int m, int q, int n_take) {
  extern __shared__ float v[];      // (q,) Householder vector
  __shared__ Cand cand_part[32];
  __shared__ Cand cand_result;
  __shared__ float sum_part[32];
  __shared__ float sum_result;

  const size_t b = blockIdx.x;
  mu_in += b * m;
  mask_in += b * m;
  mu_out += b * m;
  elim_out += b * m;
  big_n += b * m * q;
  nt += b * q * m;
  const int tid = threadIdx.x, nthr = blockDim.x;

  // transposed copy of the (m, q) basis: direction r becomes row r
  for (int e = tid; e < m * q; e += nthr) {
    const int i = e / q, r = e - i * q;
    nt[(size_t)r * m + i] = big_n[e];
  }
  float mu[LPT], el[LPT], mk[LPT], ph[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const int i = tid + l * nthr;
    mu[l] = i < m ? mu_in[i] : 0.f;
    mk[l] = i < m ? mask_in[i] : 0.f;
    el[l] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < n_take; ++t) {
    const float* row = nt + (size_t)t * m;
    Cand c{0.f, INFINITY, NO_LANE, INFINITY, NO_LANE, 0};
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int i = tid + l * nthr;
      if (i >= m) continue;
      // strip fp32 deflation dust from eliminated lanes
      mu[l] = mu[l] * (1.f - el[l]);
      const float p = row[i];
      ph[l] = p;
      c.phisq = fmaf(p, p, c.phisq);
      const bool act = mu[l] > 0.f && mk[l] > 0.f && el[l] < 0.5f;
      if (act && p > 0.f) { c.flags |= 1; take_min(c.apos, c.ipos, __fdiv_rn(mu[l], p), i); }
      if (act && p < 0.f) { c.flags |= 2; take_min(c.aneg, c.ineg, __fdiv_rn(mu[l], -p), i); }
    }
    c = block_reduce(c, cand_part, &cand_result);

    // sign-flip recovery: with no positive active lane, use -phi
    const bool flip = !(c.flags & 1);
    const float a_min = flip ? c.aneg : c.apos;
    const int idx = flip ? c.ineg : c.ipos;
    const bool any_pos = flip ? (c.flags & 2) != 0 : true;
    const bool valid = c.phisq > 1e-10f && any_pos && isfinite(a_min);
    if (!valid) continue;           // uniform across the block

#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int i = tid + l * nthr;
      if (i >= m) continue;
      const float p = flip ? -ph[l] : ph[l];
      float nm = fmaxf(__fsub_rn(mu[l], __fmul_rn(a_min, p)), 0.f);
      if (i == idx) { nm = 0.f; el[l] = 1.f; }
      mu[l] = nm;
    }

    // Householder vector from column idx of rows >= t
    float ss = 0.f;
    for (int r = t + tid; r < q; r += nthr) {
      const float u = nt[(size_t)r * m + idx];
      v[r] = u;
      ss = fmaf(u, u, ss);
    }
    ss = block_sum(ss, sum_part, &sum_result);
    const float u_t = v[t];
    const float unorm = sqrtf(ss);
    const float v_t = u_t + (u_t >= 0.f ? unorm : -unorm);
    const float coef = 2.f / fmaxf(ss - u_t * u_t + v_t * v_t, 1e-30f);
    __syncthreads();                // every thread has read v[t]
    if (tid == 0) v[t] = v_t;
    __syncthreads();

    // reflect rows >= t; column i belongs to the thread owning lane i
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int i = tid + l * nthr;
      if (i >= m) continue;
      // w = v . column i, accumulated in fp64: the elimination recurrence
      // amplifies rounding in w (a sequential fp32 sum over q rows drifted
      // ~10x further from an fp64 run than the reference's matmul does);
      // four independent accumulators keep the loads in flight
      double w0 = 0.0, w1 = 0.0, w2 = 0.0, w3 = 0.0;
      int r = t;
      for (; r + 3 < q; r += 4) {
        w0 = fma((double)v[r], (double)nt[(size_t)r * m + i], w0);
        w1 = fma((double)v[r + 1], (double)nt[(size_t)(r + 1) * m + i], w1);
        w2 = fma((double)v[r + 2], (double)nt[(size_t)(r + 2) * m + i], w2);
        w3 = fma((double)v[r + 3], (double)nt[(size_t)(r + 3) * m + i], w3);
      }
      for (; r < q; ++r) w0 = fma((double)v[r], (double)nt[(size_t)r * m + i], w0);
      const float cw = (float)((double)coef * ((w0 + w1) + (w2 + w3)));
#pragma unroll 8
      for (int r = t; r < q; ++r) {
        float* p = nt + (size_t)r * m + i;
        *p = fmaf(-cw, v[r], *p);
      }
    }
    __syncthreads();                // next step reads row t+1 and a column
  }

#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const int i = tid + l * nthr;
    if (i < m) {
      mu_out[i] = mu[l];
      elim_out[i] = el[l];
    }
  }
}

}  // namespace

// mu, mask, mu_out, elim_out (batch, m); big_n (batch, m, q) row-major;
// scratch (batch, q, m): contiguous float32 device buffers. Launches one
// block per CAR on `stream` and returns cudaGetLastError().
extern "C" int sober_car_eliminate(const float* mu, const float* big_n,
                                   const float* mask, float* scratch,
                                   float* mu_out, float* elim_out, int batch,
                                   int m, int q, int n_take, void* stream) {
  if (batch <= 0 || m <= 0 || q < 0 || n_take < 0 || n_take > q ||
      m > LPT * MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  int threads = ((m + LPT - 1) / LPT + 31) / 32 * 32;
  if (threads < 32) threads = 32;
  // one lane per thread where the block can hold it
  const int one_per = (m + 31) / 32 * 32;
  if (one_per <= MAX_THREADS) threads = one_per;
  const size_t smem = (size_t)(q > 0 ? q : 1) * sizeof(float);
  car_eliminate_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      mu, big_n, mask, scratch, mu_out, elim_out, m, q, n_take);
  return (int)cudaGetLastError();
}
