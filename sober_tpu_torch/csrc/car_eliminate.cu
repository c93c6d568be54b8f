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
// |phi|^2 leaves out the eliminated lanes: in exact arithmetic the
// reflection maps column idx to a multiple of e_t, so below row t an
// eliminated column is zero (fp32 rounding in car_l2_kernel, its entries
// of step t in car_smem_kernel, which stops reflecting it), and it never
// feeds another column or lane again.
//
// What bounds it on this card: the chain of dependent steps. A step is
// O(m q) flops (80k at m=400, q=200: about a microsecond of one SM's fp64
// rate) and reads the live rows of the basis twice, but no step can start
// before the previous one has chosen its lane and reflected the basis. So
// the time is n_take times the latency of one step: its barriers, one
// reduction over the lanes, the gather of one column and the two passes
// over the live rows. Where those passes read from L2, with few loads in
// flight, they are the largest term (the first port's kernel: ~14 us a step
// at m=400).
//
// What the design does about it: one thread block, or a cluster of C blocks,
// runs the whole n_take loop for one CAR with no return to the host, and
// keeps the basis in shared memory (car_smem_kernel):
//   - block c of the cluster owns a contiguous slice of `width` lanes with
//     all q rows of their columns, column-major as big_n is: column j at
//     nt[j * stride], stride = q rounded up to 8, plus 4 (4 mod 8 words);
//   - 4 threads share a column: thread g takes rows r0 + 4 g + 16 k .. + 3,
//     r0 = t rounded down to 4, with one 16-byte load of the column, of v
//     and of vd (two) for four rows; its first NX loads of the column stay
//     in registers from the dot product to the update. A warp holds 8
//     columns; a quarter warp (8 columns, one g) then touches 8 different
//     16-byte bank groups. Rows below t in the first load take v = 0, an
//     exact no-op;
//   - w = v . column is accumulated in fp64 (the elimination is chaotic in
//     fp32: rounding in mu grows from step to step, and a sequential fp32
//     sum over q rows drifted ~10x further from an fp64 run than the
//     reference's matmul does). v is kept in fp32 for the update and in
//     fp64 for the product, so only the basis entries are converted. The 4
//     partial sums combine with two xor shuffles, which give all 4 threads
//     the same bits;
//   - an eliminated column is never reflected again (it is dead, see above).
//     So the owner never writes column idx after step t has chosen it, and
//     the other blocks may copy it while the owner reflects its other
//     columns: a step needs one cluster barrier and one block barrier;
//   - each warp merges its 8 lanes' candidates (phi^2 by a butterfly, the
//     least key by two redux steps) and stores them into its slot in the
//     shared memory of every block of the cluster (a buffer per step
//     parity). After the cluster barrier, warp 0 of every block merges the
//     slots in the same order, so every block reaches the same lane, alpha,
//     flip and validity, bit for bit. It then copies column idx, rows >= t,
//     from its owner into its own v and computes |u|^2 and the coefficient
//     itself; the block barrier hands v to the other warps;
//   - a column is read and written only by its own warp, so the update of
//     step t and the read of row t + 1 need only __syncwarp.
// A basis that no cluster of up to 8 blocks holds in shared memory (e.g.
// m=1000, q=500: 2 MB) takes car_l2_kernel, the first port's design: one
// block, the transposed basis in an L2-resident global scratch buffer, a
// thread per lane. ops/car.py:car_plan picks the variant and the cluster
// size by shape; sober_car_eliminate checks the same limits. Independent
// CARs run as a grid of blocks (clusters): batch = 1 on the main path.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int LPT = 4;             // L2 kernel: lanes per thread, m <= LPT * 1024
constexpr int MAX_THREADS = 1024;
// shared-memory kernel: lanes per block (8 columns per warp, <= 32 warps),
// the largest cluster, and the dynamic shared memory a block may have
// (227 KB less 1 KB kept for the static part); mirrored in ops/car.py
constexpr int MAX_WIDTH = 256;
constexpr int MAX_CLUSTER = 8;
constexpr int SMEM_LIMIT = 232448 - 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NO_KEY = ~0ull;
constexpr int NX = 4;              // 16-byte loads of a column kept in registers
constexpr unsigned NEG = 0x80000000u;

// A set of lanes' candidates. An active lane's key is
// ((phi < 0) << 63) | (alpha's bits << 32) | lane, with alpha = mu / |phi|
// >= 0: keys order as alpha does, ties going to the lower lane, and every
// positive lane's key is below every negative one's. So the least key is
// the step's choice with the sign-flip recovery built in.
struct Cand {
  float phisq;              // sum of phi^2 over lanes not eliminated
  unsigned long long key;   // the least key of the set
};

// the step's decision, as warp 0 of each block computed it
struct Decision {
  float a_min;
  int idx;
  int flip;
  int valid;
  float coef;    // 2 / |v|^2
};

__device__ __forceinline__ Cand no_cand() { return Cand{0.f, NO_KEY}; }

__device__ __forceinline__ Cand merge(Cand a, const Cand& b) {
  a.phisq += b.phisq;
  a.key = b.key < a.key ? b.key : a.key;
  return a;
}

// The merge of the candidates of lanes l, l ^ 1, .., l ^ (n - 1) (n a power
// of 2, at most 32), the same bits on each: phi^2 by a butterfly, the least
// key by two redux steps (its high word, then the low word among the lanes
// that hold it; lanes outside the group give no key).
__device__ __forceinline__ Cand warp_min(Cand c, int n) {
  for (int off = 1; off < n; off <<= 1) c.phisq += __shfl_xor_sync(FULL, c.phisq, off);
  const unsigned hi = __reduce_min_sync(FULL, (unsigned)(c.key >> 32));
  const unsigned lo = __reduce_min_sync(
      FULL, (unsigned)(c.key >> 32) == hi ? (unsigned)c.key : ~0u);
  c.key = ((unsigned long long)hi << 32) | lo;
  return c;
}

__device__ __forceinline__ Cand shfl_down(const Cand& c, int off) {
  return Cand{__shfl_down_sync(FULL, c.phisq, off),
              __shfl_down_sync(FULL, c.key, off)};
}

// The candidate of lane i with basis entry p.
__device__ __forceinline__ Cand lane_cand(float mu, float mk, float el, float p,
                                          int i) {
  Cand c = no_cand();
  if (el > 0.5f) return c;
  c.phisq = p * p;
  if (mu > 0.f && mk > 0.f && p != 0.f) {
    const bool neg = p < 0.f;
    const float alpha = __fdiv_rn(mu, neg ? -p : p);
    c.key = ((unsigned long long)(__float_as_uint(alpha) | (neg ? NEG : 0u)) << 32) |
            (unsigned)i;
  }
  return c;
}

// The step's choice: with no positive active lane (the least key is a
// negative lane's, or none), phi's sign flips. coef is left for the caller.
__device__ __forceinline__ Decision decide(const Cand& c) {
  const unsigned hi = (unsigned)(c.key >> 32);
  Decision d;
  d.a_min = c.key == NO_KEY ? INFINITY : __uint_as_float(hi & ~NEG);
  d.idx = (int)(unsigned)c.key;
  d.flip = (hi & NEG) != 0;
  d.valid = c.phisq > 1e-10f && c.key != NO_KEY && isfinite(d.a_min);
  d.coef = 0.f;
  return d;
}

// ---------------------------------------------------------------------------
// The basis in shared memory: one block (CLUSTER false) or a cluster
// ---------------------------------------------------------------------------

// A barrier of the whole cluster (every thread of every block; what a
// thread wrote to shared memory before it is seen after it), or of the block.
template <bool CLUSTER>
__device__ __forceinline__ void cluster_barrier() {
  if constexpr (CLUSTER)
    asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;"
                 ::: "memory");
  else __syncthreads();
}

// Dynamic shared memory: slots (2 x n_ranks * n_warps Cand), vd (qp doubles),
// v (qp floats), nt (width columns of qp + 4 floats). qp is q rounded up to
// 8; rows q.. of nt, v and vd are zero. blockDim.x = 32 * ceil(width / 8).
// n_ranks is the cluster size (1 without a cluster); the blocks
// blockIdx.x / n_ranks run CAR number blockIdx.x / n_ranks.
template <bool CLUSTER>
__global__ void __launch_bounds__(MAX_THREADS)
car_smem_kernel(const float* __restrict__ mu_in,
                const float* __restrict__ big_n,
                const float* __restrict__ mask_in,
                float* __restrict__ mu_out, float* __restrict__ elim_out,
                int m, int q, int n_take, int width, int qp, int n_ranks) {
  extern __shared__ __align__(16) unsigned char car_smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nthr >> 5;
  const int n_slot = n_ranks * n_warps;
  const int stride = qp + 4;                          // = 4 mod 8
  Cand* part = reinterpret_cast<Cand*>(car_smem);
  double* vd = reinterpret_cast<double*>(part + 2 * n_slot);
  float* v = reinterpret_cast<float*>(vd + qp);
  float* nt = v + qp;
  __shared__ Decision dec;

  int rank = 0;
  if constexpr (CLUSTER) rank = (int)cg::this_cluster().block_rank();
  const size_t b = blockIdx.x / n_ranks;
  const int c0 = rank * width;                        // first lane owned
  const int wc = max(0, min(width, m - c0));          // lanes owned
  const int col = warp * 8 + (lane & 7);              // local column
  const int g = lane >> 3;                            // rows 4 g + 16 j ..
  const bool own = col < wc;
  const int i = c0 + col;                             // global lane
  const float inv_width = 1.f / width;                // owner of a lane, exactly

  // the slice of big_n (rows c0.., contiguous) into nt, with eight loads in
  // flight per thread; then zeros in rows q.. and in v, vd
  {
    const float* src = big_n + b * (size_t)m * q + (size_t)c0 * q;
    const int n = wc * q;
    for (int e0 = tid; e0 < n; e0 += 8 * nthr) {
      float x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = e0 + k * nthr;
        x[k] = e < n ? src[e] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = e0 + k * nthr;
        if (e < n) {
          const int lc = e / q;
          nt[lc * stride + e - lc * q] = x[k];
        }
      }
    }
    const int pad = stride - q;
    for (int e = tid; e < width * pad; e += nthr) {
      const int lc = e / pad;
      nt[lc * stride + q + e - lc * pad] = 0.f;
    }
    for (int r = tid; r < qp; r += nthr) { v[r] = 0.f; vd[r] = 0.0; }
  }
  float mu = own ? mu_in[b * m + i] : 0.f;
  const float mk = own ? mask_in[b * m + i] : 0.f;
  float el = 0.f;
  float* mycol = nt + col * stride;
  // the slice is loaded, and (cluster) every block has started
  cluster_barrier<CLUSTER>();

  for (int t = 0; t < n_take; ++t) {
    // 1. this step's candidates, merged over the warp's 8 lanes and stored
    // into the warp's slot in every block
    float ph = 0.f;
    Cand c = no_cand();
    if (own) {
      mu = mu * (1.f - el);        // strip fp32 deflation dust
      ph = mycol[t];
      if (g == 0) c = lane_cand(mu, mk, el, ph, i);
    }
    c = warp_min(c, 8);
    Cand* slots = part + (t & 1) * n_slot;
    if (lane == 0) {
      if constexpr (CLUSTER) {
        for (int k = 0; k < n_ranks; ++k)
          cg::this_cluster().map_shared_rank(slots, k)[rank * n_warps + warp] = c;
      } else {
        slots[warp] = c;
      }
    }
    cluster_barrier<CLUSTER>();

    // the passes below run over rows r0.. in 16-byte loads, rows < t taking
    // v = 0 (an exact no-op)
    const int r0 = t & ~3;

    // 2. warp 0 merges the slots in the same order in every block,
    // decides, gathers the Householder column and writes both
    if (warp == 0) {
      c = no_cand();
      for (int k = lane; k < n_slot; k += 32) c = merge(c, slots[k]);
      Decision d = decide(warp_min(c, 32));
      if (d.valid) {
        const int owner = CLUSTER ? (int)((d.idx + 0.5f) * inv_width) : 0;
        const int lc = d.idx - owner * width;
        const float* src = nt + lc * stride;
        if constexpr (CLUSTER)
          src = cg::this_cluster().map_shared_rank(nt, owner) + lc * stride;
        // four rows a lane and load: v = u on rows >= t, 0 before
        const float u_t = src[t];
        float ss = 0.f;
        for (int r = r0 + 4 * lane; r < qp; r += 128) {
          float4 u = *reinterpret_cast<const float4*>(src + r);
          if (r < t) u.x = 0.f;
          if (r + 1 < t) u.y = 0.f;
          if (r + 2 < t) u.z = 0.f;
          if (r + 3 < t) u.w = 0.f;
          ss = fmaf(u.x, u.x, ss);
          ss = fmaf(u.y, u.y, ss);
          ss = fmaf(u.z, u.z, ss);
          ss = fmaf(u.w, u.w, ss);
          *reinterpret_cast<float4*>(v + r) = u;
          *reinterpret_cast<double2*>(vd + r) = make_double2(u.x, u.y);
          *reinterpret_cast<double2*>(vd + r + 2) = make_double2(u.z, u.w);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(FULL, ss, off);
        __syncwarp();              // v[t] below replaces u_t
        if (lane == 0) {
          const float unorm = sqrtf(ss);
          const float v_t = u_t + (u_t >= 0.f ? unorm : -unorm);
          d.coef = 2.f / fmaxf(ss - u_t * u_t + v_t * v_t, 1e-30f);
          v[t] = v_t;
          vd[t] = (double)v_t;
        }
      }
      if (lane == 0) dec = d;
    }
    __syncthreads();               // v and dec are written
    const Decision d = dec;
    if (!d.valid) continue;        // uniform across the cluster

    // 3. the weights, then the reflection of this warp's live columns. An
    // eliminated lane keeps mu = 0: its stale column must not feed it
    if (own && el < 0.5f) {
      const float p = d.flip ? -ph : ph;
      float nm = fmaxf(__fsub_rn(mu, __fmul_rn(d.a_min, p)), 0.f);
      if (i == d.idx) { nm = 0.f; el = 1.f; }
      mu = nm;
    }
    const bool live = own && el < 0.5f;
    // thread g takes rows r0 + 4 g + 16 j .. + 3 of its column: a 16-byte
    // load of the column, of v and of vd (two) for four rows. The first NX
    // loads of the column stay in registers for the update.
    float4 xs[NX];
    double w0 = 0.0, w1 = 0.0, w2 = 0.0, w3 = 0.0;
    const auto dot4 = [&](const float4& x, int r) {
      const double2 va = *reinterpret_cast<const double2*>(vd + r);
      const double2 vb = *reinterpret_cast<const double2*>(vd + r + 2);
      w0 = fma(va.x, (double)x.x, w0);
      w1 = fma(va.y, (double)x.y, w1);
      w2 = fma(vb.x, (double)x.z, w2);
      w3 = fma(vb.y, (double)x.w, w3);
    };
    if (live) {
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        const int r = r0 + 4 * g + 16 * k;
        if (r < qp) {
          xs[k] = *reinterpret_cast<const float4*>(mycol + r);
          dot4(xs[k], r);
        }
      }
#pragma unroll 2
      for (int r = r0 + 4 * g + 16 * NX; r < qp; r += 16)
        dot4(*reinterpret_cast<const float4*>(mycol + r), r);
    }
    double w = (w0 + w1) + (w2 + w3);
    w += __shfl_xor_sync(FULL, w, 8);
    w += __shfl_xor_sync(FULL, w, 16);
    if (live) {
      const float cw = (float)((double)d.coef * w);
      const auto update4 = [&](float4 x, int r) {
        const float4 vv = *reinterpret_cast<const float4*>(v + r);
        x.x = fmaf(-cw, vv.x, x.x);
        x.y = fmaf(-cw, vv.y, x.y);
        x.z = fmaf(-cw, vv.z, x.z);
        x.w = fmaf(-cw, vv.w, x.w);
        *reinterpret_cast<float4*>(mycol + r) = x;
      };
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        const int r = r0 + 4 * g + 16 * k;
        if (r < qp) update4(xs[k], r);
      }
#pragma unroll 2
      for (int r = r0 + 4 * g + 16 * NX; r < qp; r += 16)
        update4(*reinterpret_cast<const float4*>(mycol + r), r);
    }
    __syncwarp();                  // row t + 1 is read by the column's warp
  }

  // (cluster) no block leaves while another may still read its columns
  if constexpr (CLUSTER) cluster_barrier<true>();
  if (own && g == 0) {
    mu_out[b * m + i] = mu;
    elim_out[b * m + i] = el;
  }
}

// ---------------------------------------------------------------------------
// The basis in L2 (the first port's kernel), for shapes no cluster holds
// ---------------------------------------------------------------------------

// Block-wide reduction; every thread returns the block's result. blockDim.x
// is a multiple of 32.
__device__ Cand block_reduce(Cand c, Cand* warp_part, Cand* result) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) c = merge(c, shfl_down(c, off));
  if (lane == 0) warp_part[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = lane < n_warps ? warp_part[lane] : no_cand();
    for (int off = 16; off > 0; off >>= 1) c = merge(c, shfl_down(c, off));
    if (lane == 0) *result = c;
  }
  __syncthreads();
  return *result;
}

__device__ float block_sum(float s, float* warp_part, float* result) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(FULL, s, off);
  if (lane == 0) warp_part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < n_warps ? warp_part[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(FULL, s, off);
    if (lane == 0) *result = s;
  }
  __syncthreads();
  return *result;
}

__global__ void __launch_bounds__(MAX_THREADS)
car_l2_kernel(const float* __restrict__ mu_in,
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
    Cand c = no_cand();
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int i = tid + l * nthr;
      if (i >= m) continue;
      mu[l] = mu[l] * (1.f - el[l]);
      ph[l] = row[i];
      c = merge(c, lane_cand(mu[l], mk[l], el[l], ph[l], i));
    }
    const Decision d = decide(block_reduce(c, cand_part, &cand_result));
    if (!d.valid) continue;         // uniform across the block

#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int i = tid + l * nthr;
      if (i >= m) continue;
      const float p = d.flip ? -ph[l] : ph[l];
      float nm = fmaxf(__fsub_rn(mu[l], __fmul_rn(d.a_min, p)), 0.f);
      if (i == d.idx) { nm = 0.f; el[l] = 1.f; }
      mu[l] = nm;
    }

    // Householder vector from column idx of rows >= t
    float ss = 0.f;
    for (int r = t + tid; r < q; r += nthr) {
      const float u = nt[(size_t)r * m + d.idx];
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

    // reflect rows >= t; column i belongs to the thread owning lane i, and
    // w is accumulated in fp64 with four accumulators
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int i = tid + l * nthr;
      if (i >= m) continue;
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

// mu, mask, mu_out, elim_out (batch, m); big_n (batch, m, q) row-major:
// contiguous float32 device buffers. cluster 0 runs the L2 kernel, with
// scratch a (batch, q, m) buffer; cluster 1 the shared-memory kernel in one
// block per CAR, and cluster 2..8 in a cluster of that many blocks per CAR
// (scratch unused). Launches on `stream` and returns the launch's error, or
// cudaErrorInvalidValue for a shape the variant cannot hold.
extern "C" int sober_car_eliminate(const float* mu, const float* big_n,
                                   const float* mask, float* scratch,
                                   float* mu_out, float* elim_out, int batch,
                                   int m, int q, int n_take, int cluster,
                                   void* stream) {
  if (batch <= 0 || m <= 0 || q < 0 || n_take < 0 || n_take > q ||
      m > LPT * MAX_THREADS || cluster < 0 || cluster > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (cluster == 0) {
    int threads = ((m + LPT - 1) / LPT + 31) / 32 * 32;
    if (threads < 32) threads = 32;
    // one lane per thread where the block can hold it
    const int one_per = (m + 31) / 32 * 32;
    if (one_per <= MAX_THREADS) threads = one_per;
    const size_t smem = (size_t)(q > 0 ? q : 1) * sizeof(float);
    car_l2_kernel<<<batch, threads, smem, st>>>(mu, big_n, mask, scratch,
                                                mu_out, elim_out, m, q, n_take);
    return (int)cudaGetLastError();
  }
  const int width = (m + cluster - 1) / cluster;
  const int qp = (q + 7) / 8 * 8;
  const int threads = (width + 7) / 8 * 32;
  const size_t smem = (size_t)2 * cluster * (threads / 32) * sizeof(Cand) +
                      (size_t)qp * (sizeof(double) + sizeof(float)) +
                      (size_t)width * (qp + 4) * sizeof(float);
  if (width > MAX_WIDTH || smem > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (cluster == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        car_smem_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    car_smem_kernel<false><<<batch, threads, smem, st>>>(
        mu, big_n, mask, mu_out, elim_out, m, q, n_take, width, qp, 1);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      car_smem_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, car_smem_kernel<true>, mu, big_n, mask,
                           mu_out, elim_out, m, q, n_take, width, qp,
                           cluster);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
