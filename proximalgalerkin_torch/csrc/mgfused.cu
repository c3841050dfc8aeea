// Fused multigrid-preconditioned CG (MG-PCG) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ops/mgfused.py:237 FusedMgCg._kernel of the JAX
// reference package, together with its driver _solve_impl (:398). It
// solves the Jacobi-scaled Schur system of the mixed-precision P1 obstacle
// Newton step on an unpadded (m, m) f32 lattice with a zero Dirichlet
// exterior:
//
//   matvec   S p = alpha * B * K5(B * p) + C * p,   K5 = {4; -1 N/S/E/W}
//   precond  z   = sqf * V(sqf * r),                sqf = B * (4 alpha + w0)
//   V        one V(1,1) cycle: damped Jacobi (omega 0.8), 9-point full-
//            weighting restriction, bilinear prolongation (its transpose
//            times 4), 24 sweeps on the coarsest level.
//
// What bounds it on this card, and what the design does about it:
//
// * Launch and host overhead. A CG iteration is ten dependent kernels at
//   the bench size, most of them a few microseconds long. The host
//   enqueues a whole chunk of iterations once, on a private stream under
//   capture, and replays the instantiated CUDA graph on the caller's
//   stream: one host call per chunk. Every argument a captured kernel sees
//   is fixed for the life of a workspace (one per m): alpha, tol and
//   maxiter live in the device state vector `sc`, the grids in one
//   workspace buffer, and the two p and r buffers swap by the parity of
//   the device's iteration count, so one graph serves every chunk and
//   every solve.
// * Memory traffic on the fine grids. No pass writes what a later pass can
//   recompute from its neighbours:
//     - the pre-smooth from zero is pointwise (x = omega b / d), so the
//       down leg of a level is one kernel reading b_l and w_l (at level 0:
//       r, Ap, B and w0, plus x and p' at its own points, taking in
//       x += a p', r' = r - a Ap and b0 = sqf r') and writing b_{l+1}
//       (and x, r' at level 0);
//     - the up leg is one kernel: x_l + P e_{l+1} is recomputed on a tile
//       and its ring from b_l, w_l and e_{l+1}, then post-smoothed into
//       t_l; at level 0 it also makes the partials of r'.z and r'.r
//       (z = sqf t0 in registers);
//     - the matvec recomputes p' = z + beta p from t0 and the old p on its
//       points and their ring, writes p' into the other p buffer, and
//       makes the deferred best-iterate copy xb = x.
//   Each block stages its ring in shared memory and reads neighbours
//   there. Three fine-grid passes remain per iteration (matvec, level-0
//   down leg, level-0 up leg).
// * Latency of the small levels. The bottom of the cycle, from the first
//   level (at most 257) whose remaining levels fit the shared memory of
//   a cluster of 16 blocks (ops/mgfused.py level_plan; at the bench size
//   levels 257, 129, 65, 33, 17, 9, 5), is ONE launch of k_tail as a
//   thread-block cluster of 1024-thread blocks on neighbouring SMs (16,
//   the non-portable size, ran faster than 8 on an H100: PERF.md). The
//   levels above 33 lie across the cluster, a strip of rows in each
//   block's shared memory; a block reads the one or two rows past its
//   strip from its neighbours' shared memory (DSMEM), and the cluster
//   barrier separates the passes. The levels of at most 33 run in block
//   0 alone, as the one-block tail walks them, while the others wait at
//   the barrier. A cycle whose first level is at most 65 keeps the one-block
//   tail (a cluster of one block, 91 KB at m = 65). Each level is walked
//   without division; a coarsest level of at most 32 points is swept by
//   one warp in registers (shuffles, no barrier). Every pass is
//   pointwise, so where the levels are split changes no bit.
// * Scalar kernels. The reductions behind alpha and beta, and the loop
//   condition, run in the last block of the kernel that makes the
//   partials (a counter picks that block).
//
// Control flow. Every kernel of an iteration reads sc[LIVE] first and
// returns when the solve is finished, so an iteration queued after the
// end is the identity (the masked fori body of the TPU kernel). The host
// reads sc once per chunk.
//
// Determinism. Every dot product is two passes in a fixed order, with no
// float atomics: a shared-memory tree over each run of 256 points in
// index order, then the partials summed as 1024 strided lanes and a tree.
// That is the order of this port's first MG-PCG kernel, and every other
// operation is its arithmetic too, so the solve gives that kernel's bits
// (and the same CG counts), for any chunk size. Built with -fmad=false.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC -o libmgfused.so mgfused.cu
// Plain C interface, loaded with ctypes (proximalgalerkin_torch/ops/mgfused.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>

#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;              // threads of a grid kernel's block
constexpr unsigned FULL = 0xffffffffu;
// fine tiles (up leg above level 0, pointwise kernels): TX x TY points,
// 32 x 8 threads, each thread TY / 8 rows
constexpr int TX = 32, TY = 16, THY = 8;
constexpr int UX = TX + 2, UY = TY + 2;          // a fine tile and its ring
// coarse tiles of the down leg: CX x CY coarse points, one thread each
constexpr int CX = 32, CY = 8;
constexpr int RX = 2 * CX + 3, RY = 2 * CY + 3;  // fine region of x
constexpr int SX = RX - 2, SY = RY - 2;          // fine region of residuals
constexpr int TAIL_T = 32;                       // tail block: 32 x 32
constexpr int TAIL_ONE_MAX = 33;   // a cluster tail's levels in block 0
constexpr int MAX_CLUSTER = 16;    // the most blocks of a cluster
constexpr int COARSE_SWEEPS = 24;
static_assert(COARSE_SWEEPS % 2 == 0, "the coarsest sweeps end in t");
constexpr int MAX_LEVELS = 32;
// dynamic shared memory a block may ask for: the SM's 227 KB less room for
// the kernel's static shared memory
constexpr int MAX_SMEM = 232448 - 1024;
// mgf_ws_create's error when no cluster of the tail fits the card
constexpr int ERR_NO_CLUSTER = -2;
constexpr float OMEGA = 0.8f;

// slots of the device state vector (ops/mgfused.py _SC_*). Slots below
// SC_STATE are the solve's state, zeroed when it is primed; the others
// are its parameters, written by the host before the first chunk.
enum {
  SC_IT = 0, SC_RR, SC_RZ, SC_RRB, SC_IB, SC_OK, SC_STOP, SC_LIVE,
  SC_A, SC_GOOD, SC_BETA, SC_BETTER, SC_STATE,
  SC_ALPHA = 16, SC_TOL, SC_MAXIT, SC_WINDOW, SC_GUARD, SC_LEN = 32
};

__device__ __forceinline__ bool dead(const float* sc, int gated) {
  return gated && sc[SC_LIVE] < 0.5f;
}

__device__ __forceinline__ int odd_iteration(const float* sc) {
  return int(sc[SC_IT]) & 1;
}

__device__ __forceinline__ float sqf_of(float B, float w0, float alpha) {
  return B * (4.f * alpha + w0);
}

// a / d (d > 0), correctly rounded. The f32 division leaves its fast path
// for a much slower routine when the quotient may underflow, as it does
// wherever a tiny residual meets a pinned point's huge diagonal, so such
// quotients go through the f64 division instead:
// rounding the correctly rounded f64 quotient to f32 gives the correctly
// rounded f32 quotient (53 >= 2 * 24 + 2), the bits of a / d. (Written
// with intrinsics: the compiler folds float(double(a) / double(d)) back
// into the f32 division.)
__device__ __forceinline__ float div_pos(float a, float d) {
  const float aa = fabsf(a);
  if (aa > d * 1e-30f && aa < d * 1e30f) return __fdiv_rn(a, d);
  if (a == 0.f) return a;
  return __double2float_rn(__ddiv_rn(double(a), double(d)));
}

// the pre-smooth from zero: one damped-Jacobi update of x = 0
__device__ __forceinline__ float xpre(float b, float w, float alpha) {
  return div_pos(OMEGA * b, alpha * 4.f + w);
}

// b - (alpha K5 + w) x at a point, from x and its four neighbours
__device__ __forceinline__ float resid(float b, float w, float alpha,
                                       float xc, float n, float s, float we,
                                       float e) {
  const float k5 = 4.f * xc - n - s - we - e;
  return b - (alpha * k5 + w * xc);
}

// one damped-Jacobi update of x at a point
__device__ __forceinline__ float smooth(float b, float w, float alpha,
                                        float xc, float n, float s, float we,
                                        float e) {
  return xc + div_pos(OMEGA * resid(b, w, alpha, xc, n, s, we, e),
                     alpha * 4.f + w);
}

// full weighting R f R^T at coarse (I, J): rows first, then columns. f is
// read at f[r * ld + c] with (r, c) = (fine row - r0, fine col - c0).
__device__ __forceinline__ float restrict_at(const float* f, int ld, int r0,
                                             int c0, int I, int J, int m,
                                             int mc) {
  float u[3];
  for (int dj = -1; dj <= 1; ++dj) {
    const int j = 2 * J + dj;
    u[dj + 1] = 0.f;
    if (j < 0 || j >= m) continue;
    const float* col = f + (j - c0);
    float acc = 0.f;
    if (I > 0) acc = acc + 0.25f * col[(2 * I - 1 - r0) * ld];
    acc = acc + 0.5f * col[(2 * I - r0) * ld];
    if (I < mc - 1) acc = acc + 0.25f * col[(2 * I + 1 - r0) * ld];
    u[dj + 1] = acc;
  }
  float c = 0.f;
  if (J > 0) c = c + 0.25f * u[0];
  c = c + 0.5f * u[1];
  if (J < mc - 1) c = c + 0.25f * u[2];
  return c;
}

// (P e)(i, j) = 4 (R^T e R)(i, j): bilinear interpolation from the
// coarse rows e0 = row i / 2 and e1 = row (i + 1) / 2. All four
// candidates are loaded (clamped in range) and the arithmetic picked by
// selects, so that a warp of alternating parities does not diverge.
__device__ __forceinline__ float prolong_rows(const float* e0,
                                              const float* e1, int i,
                                              int j) {
  const int J0 = j >> 1;
  const bool oi = i & 1, oj = j & 1;
  const int J1 = oj ? J0 + 1 : J0;
  const float e00 = e0[J0], e10 = e1[J0];
  const float e01 = e0[J1], e11 = e1[J1];
  const float rc0 = oi ? 0.25f * e00 + 0.25f * e10 : 0.5f * e00;
  const float rc1 = oi ? 0.25f * e01 + 0.25f * e11 : 0.5f * e01;
  const float v = oj ? 0.25f * rc0 + 0.25f * rc1 : 0.5f * rc0;
  return 4.f * v;
}

__device__ __forceinline__ float prolong_at(const float* e, int i, int j,
                                            int mc) {
  const int I0 = i >> 1, I1 = (i & 1) ? I0 + 1 : I0;
  return prolong_rows(e + I0 * mc, e + I1 * mc, i, j);
}

// Fixed-order tree over a 1-D block of NT threads; every thread must
// call it. The same tree as the first kernel of this port had, so that
// the partial sums keep their bits.
__device__ float block_sum(float v, float* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] += sh[t + s];
    __syncthreads();
  }
  const float out = sh[0];
  __syncthreads();
  return out;
}

// After thread 0 stored the block's partials: returns, in every thread,
// whether this block arrived last of nblk. The last block then reads every
// partial, and resets the counter for the next launch.
__device__ bool arrive(unsigned* cnt, int nblk) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(cnt, 1u) == unsigned(nblk - 1);
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Bands: a block of the matvec and the level-0 up leg takes BK chunks of
// NT consecutive points (index order) and stages what the stencil reads
// over [start - m - 1, start + BAND + m + 1). A chunk's partial sum is the
// tree over its NT points, as if it were a block of its own.
constexpr int BK = 8, BAND = BK * NT;

__host__ __device__ inline int band_span(int m) { return BAND + 2 * m + 2; }

// row and column of point q >= -2m (q may lie before the grid)
__device__ __forceinline__ void row_col(int q, int m, int& i, int& j) {
  i = (q + 2 * m) / m - 2;
  j = q - i * m;
}

// the next point NT further on
__device__ __forceinline__ void step_nt(int m, int& i, int& j) {
  j += NT;
  while (j >= m) {
    j -= m;
    ++i;
  }
}

// the trees of BK chunks held in p (chunk c at p[c * NT]), each the tree
// of block_sum; the chunk sums end in p[c * NT]
__device__ void chunk_trees(float* p) {
  const int t = threadIdx.x;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (t < s)
      for (int c = 0; c < BK; ++c) p[c * NT + t] += p[c * NT + t + s];
    __syncthreads();
  }
}

// The last block's sum of nb partials, in the order of a 1024-thread
// block: RED lanes each sum a strided run, then a tree over the lanes.
// Each thread keeps RED / NT lanes and loads their partials a whole
// stride at a time, so that the loads are in flight together. sh holds
// RED floats.
constexpr int RED = 1024, LANES = RED / NT;
__device__ float sum_parts(const float* part, int nb, float* sh) {
  const int t = threadIdx.x;
  float acc[LANES];
#pragma unroll
  for (int l = 0; l < LANES; ++l) acc[l] = 0.f;
#pragma unroll 4
  for (int base = 0; base < nb; base += RED) {
    float v[LANES];
#pragma unroll
    for (int l = 0; l < LANES; ++l) {
      const int k = base + l * NT + t;
      v[l] = k < nb ? __ldcg(part + k) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < LANES; ++l)
      if (base + l * NT + t < nb) acc[l] += v[l];
  }
#pragma unroll
  for (int l = 0; l < LANES; ++l) sh[l * NT + t] = acc[l];
  __syncthreads();
  for (int s = RED / 2; s > 0; s >>= 1) {
    for (int v = t; v < s; v += NT) sh[v] += sh[v + s];
    __syncthreads();
  }
  const float out = sh[0];
  __syncthreads();
  return out;
}

// The scalar end of an iteration, by one thread: beta, the residual norm
// and the best-iterate bookkeeping (or, priming, the fresh state), then
// the loop condition of the next iteration.
__device__ void finish_iteration(float* sc, float rz_new, float rr_new,
                                 int prime) {
  if (prime) {
    for (int k = 0; k < SC_STATE; ++k) sc[k] = 0.f;
    sc[SC_RR] = rr_new;
    sc[SC_RZ] = rz_new;
    sc[SC_RRB] = rr_new;
    sc[SC_OK] = 1.f;
    const float tol = sc[SC_TOL];
    sc[SC_STOP] = tol * tol * rr_new;
  } else {
    const bool good = sc[SC_GOOD] > 0.5f;
    const float it = sc[SC_IT];
    sc[SC_BETA] = good ? rz_new / sc[SC_RZ] : 0.f;
    sc[SC_RZ] = rz_new;
    sc[SC_RR] = rr_new;
    const bool better = rr_new < sc[SC_RRB];
    sc[SC_BETTER] = better ? 1.f : 0.f;
    if (better) {
      sc[SC_RRB] = rr_new;
      sc[SC_IB] = it + 1.f;
    }
    sc[SC_OK] = good ? 1.f : 0.f;
    sc[SC_IT] = it + 1.f;
  }
  const float it = sc[SC_IT], stop = sc[SC_STOP];
  const bool stalled = (it - sc[SC_IB] > sc[SC_WINDOW]) &&
                       (sc[SC_RRB] < sc[SC_GUARD] * stop);
  const bool live = sc[SC_OK] > 0.5f && !stalled && it < sc[SC_MAXIT] &&
                    sc[SC_RR] > stop;
  sc[SC_LIVE] = live ? 1.f : 0.f;
}

// ------------------------------------------------------- grid kernels

// p' = sqf t0 + beta p (t0: the previous V-cycle's output, so sqf t0 = z),
// Ap = S p', partials of p'.Ap; the last block sets a = rz / p'.Ap. p' is
// read from and written to the two p buffers by the iteration's parity.
// B p' is staged over the band and its halo, so each is computed once.
// When the previous iteration improved, xb = x (the deferred copy).
// Dynamic shared memory: band_span(m) + BAND floats.
__global__ void __launch_bounds__(NT)
k_matvec(const float* __restrict__ B, const float* __restrict__ C,
         const float* __restrict__ w0, const float* __restrict__ t0,
         float* pa, float* pb, float* __restrict__ Ap,
         const float* __restrict__ x, float* __restrict__ xb, float* part,
         unsigned* cnt, float* sc, int m, int gated) {
  if (dead(sc, gated)) return;
  extern __shared__ float dyn[];
  const int span = band_span(m);
  float* sbp = dyn;
  float* prod = dyn + span;
  const float alpha = sc[SC_ALPHA], beta = sc[SC_BETA];
  const bool copy = gated && sc[SC_BETTER] > 0.5f;
  const int odd = odd_iteration(sc);
  const float* __restrict__ pold = odd ? pb : pa;
  float* __restrict__ pnew = odd ? pa : pb;
  const int n = m * m, t = threadIdx.x;
  const int s0 = blockIdx.x * BAND, lo = s0 - m - 1;
#pragma unroll 4
  for (int k = t, q = lo + t; k < span; k += NT, q += NT) {
    float v = 0.f;
    if (q >= 0 && q < n) {
      const float Bq = B[q];
      v = Bq * (sqf_of(Bq, w0[q], alpha) * t0[q] + beta * pold[q]);
    }
    sbp[k] = v;
  }
  __syncthreads();
  int i, j;
  row_col(s0 + t, m, i, j);
  for (int c = 0; c < BK; ++c, step_nt(m, i, j)) {
    const int idx = s0 + c * NT + t;
    float contrib = 0.f;
    if (idx < n) {
      const int k = idx - lo;
      const float Bv = B[idx];
      const float pn =
          sqf_of(Bv, w0[idx], alpha) * t0[idx] + beta * pold[idx];
      const float k5 = 4.f * sbp[k] - (i > 0 ? sbp[k - m] : 0.f) -
                       (i < m - 1 ? sbp[k + m] : 0.f) -
                       (j > 0 ? sbp[k - 1] : 0.f) -
                       (j < m - 1 ? sbp[k + 1] : 0.f);
      const float y = alpha * (Bv * k5) + C[idx] * pn;
      Ap[idx] = y;
      pnew[idx] = pn;
      contrib = pn * y;
      if (copy) xb[idx] = x[idx];
    }
    prod[c * NT + t] = contrib;
  }
  chunk_trees(prod);
  const int nb = (n + NT - 1) / NT;
  if (t == 0)
    for (int c = 0; c < BK && s0 + c * NT < n; ++c)
      part[blockIdx.x * BK + c] = prod[c * NT];
  if (arrive(cnt, gridDim.x)) {
    const float pAp = sum_parts(part, nb, dyn);
    if (t == 0) {
      const float rz = sc[SC_RZ];
      const bool good = pAp > FLT_MIN && rz > FLT_MIN;
      sc[SC_A] = good ? rz / pAp : 0.f;
      sc[SC_GOOD] = good ? 1.f : 0.f;
      *cnt = 0u;
    }
  }
}

// Residual of the pre-smoothed x on a down-leg region, then its full
// weighting at the block's coarse points. sb, sw, sx: b, w and x on the
// RY x RX fine region whose corner is fine (2 I0 - 2, 2 J0 - 2); sr:
// scratch for the SY x SX residuals.
__device__ void residual_restrict(const float* sb, const float* sw,
                                  const float* sx, float* sr, float* bc,
                                  float alpha, int I0, int J0, int m,
                                  int mc) {
  const int fr = 2 * I0 - 2, fc = 2 * J0 - 2;
  for (int kr = threadIdx.y * CX + threadIdx.x; kr < SY * SX; kr += NT) {
    const int li = kr / SX + 1, lj = kr - (li - 1) * SX + 1;
    const int i = fr + li, j = fc + lj;
    float v = 0.f;
    if (i >= 0 && i < m && j >= 0 && j < m) {
      const int k = li * RX + lj;
      v = resid(sb[k], sw[k], alpha, sx[k], sx[k - RX], sx[k + RX],
                sx[k - 1], sx[k + 1]);
    }
    sr[kr] = v;
  }
  __syncthreads();
  const int I = I0 + threadIdx.y, J = J0 + threadIdx.x;
  if (I < mc && J < mc)
    bc[I * mc + J] = restrict_at(sr, SX, fr + 1, fc + 1, I, J, m, mc);
}

// Down leg of level 0: r' = r - a Ap and b0 = sqf r' on the region
// (recomputed for the ring, written nowhere), the pre-smooth and residual
// of b0, restricted into b1; at the block's own fine points x += a p' and
// r' into the other r buffer. prime: the V-cycle of the priming, on
// b0 = sqf r with r in buffer 0, no updates.
__global__ void __launch_bounds__(NT)
k_down0(const float* __restrict__ B, const float* __restrict__ w0,
        float* __restrict__ x, float* ra, float* rb, const float* pa,
        const float* pb, const float* __restrict__ Ap,
        float* __restrict__ bc, const float* sc, int m, int prime) {
  if (dead(sc, !prime)) return;
  __shared__ float sb[RY * RX], sw[RY * RX], sx[RY * RX], sq[RY * RX];
  __shared__ float sr[SY * SX];
  const float alpha = sc[SC_ALPHA];
  const float a = prime ? 0.f : sc[SC_A];
  const int odd = prime ? 0 : odd_iteration(sc);
  const float* __restrict__ rold = odd ? rb : ra;
  float* __restrict__ rnew = odd ? ra : rb;
  const float* __restrict__ pn = odd ? pa : pb;   // the p' of k_matvec
  const int mc = (m - 1) / 2 + 1;
  const int I0 = blockIdx.y * CY, J0 = blockIdx.x * CX;
  const int fr = 2 * I0 - 2, fc = 2 * J0 - 2;
  for (int k = threadIdx.y * CX + threadIdx.x; k < RY * RX; k += NT) {
    const int li = k / RX, lj = k - li * RX;
    const int i = fr + li, j = fc + lj;
    float bv = 0.f, wv = 0.f, xv = 0.f, rv = 0.f;
    if (i >= 0 && i < m && j >= 0 && j < m) {
      const int idx = i * m + j;
      rv = rold[idx];
      if (!prime) rv = rv - a * Ap[idx];
      wv = w0[idx];
      bv = sqf_of(B[idx], wv, alpha) * rv;
      xv = xpre(bv, wv, alpha);
    }
    sb[k] = bv;
    sw[k] = wv;
    sx[k] = xv;
    sq[k] = rv;
  }
  __syncthreads();
  if (!prime) {
    for (int li = 2 + threadIdx.y; li < 2 + 2 * CY; li += CY) {
      for (int lj = 2 + threadIdx.x; lj < 2 + 2 * CX; lj += CX) {
        const int i = fr + li, j = fc + lj;
        if (i < m && j < m) {
          const int idx = i * m + j;
          x[idx] = x[idx] + a * pn[idx];
          rnew[idx] = sq[li * RX + lj];
        }
      }
    }
  }
  residual_restrict(sb, sw, sx, sr, bc, alpha, I0, J0, m, mc);
}

// Down leg of a level l > 0: pre-smooth of b_l from zero, residual,
// restriction into b_{l+1}.
__global__ void __launch_bounds__(NT)
k_down(const float* b, const float* w, float* bc, const float* sc, int m,
       int gated) {
  if (dead(sc, gated)) return;
  __shared__ float sb[RY * RX], sw[RY * RX], sx[RY * RX], sr[SY * SX];
  const float alpha = sc[SC_ALPHA];
  const int mc = (m - 1) / 2 + 1;
  const int I0 = blockIdx.y * CY, J0 = blockIdx.x * CX;
  const int fr = 2 * I0 - 2, fc = 2 * J0 - 2;
  for (int k = threadIdx.y * CX + threadIdx.x; k < RY * RX; k += NT) {
    const int li = k / RX, lj = k - li * RX;
    const int i = fr + li, j = fc + lj;
    float bv = 0.f, wv = 0.f, xv = 0.f;
    if (i >= 0 && i < m && j >= 0 && j < m) {
      const int idx = i * m + j;
      bv = b[idx];
      wv = w[idx];
      xv = xpre(bv, wv, alpha);
    }
    sb[k] = bv;
    sw[k] = wv;
    sx[k] = xv;
  }
  __syncthreads();
  residual_restrict(sb, sw, sx, sr, bc, alpha, I0, J0, m, mc);
}

// The post-smooth of u = x_pre + P e on the tile, from su (u on the tile
// and its ring), sb and sw (b and w there); returns t at local (li, tx).
__device__ __forceinline__ float post_smooth_tile(const float (*su)[UX],
                                                  const float (*sb)[UX],
                                                  const float (*sw)[UX],
                                                  float alpha, int li,
                                                  int tx) {
  const int a = li + 1, b = tx + 1;
  return smooth(sb[a][b], sw[a][b], alpha, su[a][b], su[a - 1][b],
                su[a + 1][b], su[a][b - 1], su[a][b + 1]);
}

// Up leg of a level l > 0: u = x_pre + P e (e = t_{l+1}) on the tile and
// its ring, then the post-smooth into t_l.
__global__ void __launch_bounds__(NT)
k_up(const float* b, const float* w, const float* e, float* t,
     const float* sc, int m, int gated) {
  if (dead(sc, gated)) return;
  __shared__ float su[UY][UX], sb[UY][UX], sw[UY][UX];
  const float alpha = sc[SC_ALPHA];
  const int mc = (m - 1) / 2 + 1;
  const int i0 = blockIdx.y * TY, j0 = blockIdx.x * TX;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int k = ty * TX + tx; k < UY * UX; k += NT) {
    const int li = k / UX, lj = k - li * UX;
    const int i = i0 + li - 1, j = j0 + lj - 1;
    float bv = 0.f, wv = 0.f, u = 0.f;
    if (i >= 0 && i < m && j >= 0 && j < m) {
      const int idx = i * m + j;
      bv = b[idx];
      wv = w[idx];
      u = xpre(bv, wv, alpha) + prolong_at(e, i, j, mc);
    }
    su[li][lj] = u;
    sb[li][lj] = bv;
    sw[li][lj] = wv;
  }
  __syncthreads();
  for (int li = ty; li < TY; li += THY) {
    const int i = i0 + li, j = j0 + tx;
    if (i < m && j < m)
      t[i * m + j] = post_smooth_tile(su, sb, sw, alpha, li, tx);
  }
}

// The scalar end of the iteration (or of the priming) in the last block,
// once every block stored its partials of r'.z (part[0, nb)) and r'.r
// (part[nb, 2 nb)). sh: RED floats.
__device__ void end_of_iteration(float* part, int nb, unsigned* cnt,
                                 float* sc, int prime, float* sh) {
  if (arrive(cnt, gridDim.x)) {
    const float rz_new = sum_parts(part, nb, sh);
    const float rr_new = sum_parts(part + nb, nb, sh);
    if (threadIdx.x == 0) {
      finish_iteration(sc, rz_new, rr_new, prime);
      *cnt = 0u;
    }
  }
}

// Up leg of level 0: t0 = the post-smooth of u = x_pre + P e, with
// b0 = sqf r'; u is staged over the band and its halo. Then the partials
// of r'.z and r'.r (z = sqf t0) and, in the last block, the scalar end of
// the iteration. Dynamic shared memory: band_span(m) + 2 BAND floats.
__global__ void __launch_bounds__(NT)
k_up0(const float* __restrict__ B, const float* __restrict__ w0,
      const float* ra, const float* rb, const float* __restrict__ e,
      float* __restrict__ t0, float* part, unsigned* cnt, float* sc, int m,
      int prime) {
  if (dead(sc, !prime)) return;
  extern __shared__ float dyn[];
  const int span = band_span(m);
  float* su = dyn;
  float* prz = dyn + span;
  float* prr = prz + BAND;
  const float alpha = sc[SC_ALPHA];
  const float* __restrict__ r =
      (prime || odd_iteration(sc)) ? ra : rb;   // r'
  const int mc = (m - 1) / 2 + 1;
  const int n = m * m, t = threadIdx.x;
  const int s0 = blockIdx.x * BAND, lo = s0 - m - 1;
  {
    int i, j;
    row_col(lo + t, m, i, j);
#pragma unroll 4
    for (int k = t, q = lo + t; k < span;
         k += NT, q += NT, step_nt(m, i, j)) {
      float u = 0.f;
      if (q >= 0 && q < n) {
        const float wq = w0[q];
        u = xpre(sqf_of(B[q], wq, alpha) * r[q], wq, alpha) +
            prolong_at(e, i, j, mc);
      }
      su[k] = u;
    }
  }
  __syncthreads();
  int i, j;
  row_col(s0 + t, m, i, j);
  for (int c = 0; c < BK; ++c, step_nt(m, i, j)) {
    const int idx = s0 + c * NT + t;
    float rz = 0.f, rr = 0.f;
    if (idx < n) {
      const int k = idx - lo;
      const float wv = w0[idx], sqf = sqf_of(B[idx], wv, alpha);
      const float rv = r[idx];
      const float tv = smooth(sqf * rv, wv, alpha, su[k],
                              i > 0 ? su[k - m] : 0.f,
                              i < m - 1 ? su[k + m] : 0.f,
                              j > 0 ? su[k - 1] : 0.f,
                              j < m - 1 ? su[k + 1] : 0.f);
      t0[idx] = tv;
      rz = rv * (sqf * tv);
      rr = rv * rv;
    }
    prz[c * NT + t] = rz;
    prr[c * NT + t] = rr;
  }
  chunk_trees(prz);
  chunk_trees(prr);
  const int nb = (n + NT - 1) / NT;
  if (t == 0) {
    for (int c = 0; c < BK && s0 + c * NT < n; ++c) {
      part[blockIdx.x * BK + c] = prz[c * NT];
      part[nb + blockIdx.x * BK + c] = prr[c * NT];
    }
  }
  end_of_iteration(part, nb, cnt, sc, prime, dyn);
}

// Level 0 when it is itself the bottom of the cycle (in the tail, or the
// only level): the pointwise x += a p', r' = r - a Ap and b0 = sqf r'.
__global__ void __launch_bounds__(NT)
k_axpy0(const float* B, const float* w0, float* x, float* ra, float* rb,
        const float* pa, const float* pb, const float* Ap, float* b0,
        const float* sc, int m, int prime) {
  if (dead(sc, !prime)) return;
  const float alpha = sc[SC_ALPHA];
  const float a = prime ? 0.f : sc[SC_A];
  const int odd = prime ? 0 : odd_iteration(sc);
  const float* rold = odd ? rb : ra;
  float* rnew = odd ? ra : rb;
  const float* pn = odd ? pa : pb;
  const int j = blockIdx.x * TX + threadIdx.x;
  for (int li = threadIdx.y; li < TY; li += THY) {
    const int i = blockIdx.y * TY + li;
    if (i < m && j < m) {
      const int idx = i * m + j;
      float rv = rold[idx];
      if (!prime) {
        rv = rv - a * Ap[idx];
        x[idx] = x[idx] + a * pn[idx];
        rnew[idx] = rv;
      }
      b0[idx] = sqf_of(B[idx], w0[idx], alpha) * rv;
    }
  }
}

// Level 0 as the bottom of the cycle: the partials of r'.z and r'.r with
// z = sqf t0, and the scalar end of the iteration in the last block.
__global__ void __launch_bounds__(NT)
k_rz0(const float* __restrict__ B, const float* __restrict__ w0,
      const float* ra, const float* rb, const float* __restrict__ t0,
      float* part, unsigned* cnt, float* sc, int m, int prime) {
  if (dead(sc, !prime)) return;
  __shared__ float sh[RED];
  const float alpha = sc[SC_ALPHA];
  const float* __restrict__ r = (prime || odd_iteration(sc)) ? ra : rb;
  const int idx = blockIdx.x * NT + threadIdx.x;
  float rz = 0.f, rr = 0.f;
  if (idx < m * m) {
    const float rv = r[idx];
    rz = rv * (sqf_of(B[idx], w0[idx], alpha) * t0[idx]);
    rr = rv * rv;
  }
  const float vz = block_sum(rz, sh), vr = block_sum(rr, sh);
  const int nb = gridDim.x;
  if (threadIdx.x == 0) {
    part[blockIdx.x] = vz;
    part[nb + blockIdx.x] = vr;
  }
  end_of_iteration(part, nb, cnt, sc, prime, sh);
}

// one damped-Jacobi sweep of a coarsest level too large for the tail;
// xin == nullptr means x = 0
__global__ void __launch_bounds__(NT)
k_sweep(const float* xin, const float* b, const float* w, float* out,
        const float* sc, int m, int gated) {
  if (dead(sc, gated)) return;
  const float alpha = sc[SC_ALPHA];
  const int j = blockIdx.x * TX + threadIdx.x;
  for (int li = threadIdx.y; li < TY; li += THY) {
    const int i = blockIdx.y * TY + li;
    if (i < m && j < m) {
      const int idx = i * m + j;
      float xc = 0.f, n = 0.f, s = 0.f, we = 0.f, e = 0.f;
      if (xin) {
        xc = xin[idx];
        if (i > 0) n = xin[idx - m];
        if (i < m - 1) s = xin[idx + m];
        if (j > 0) we = xin[idx - 1];
        if (j < m - 1) e = xin[idx + 1];
      }
      out[idx] = smooth(b[idx], w[idx], alpha, xc, n, s, we, e);
    }
  }
}

// at the end of a chunk whose solve has finished: the pending xb = x
__global__ void k_flush(const float* x, float* xb, long long n,
                        const float* sc) {
  if (sc[SC_LIVE] > 0.5f || sc[SC_BETTER] < 0.5f) return;
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  if (idx < n) xb[idx] = x[idx];
}

// z = sqf t0 (kernel_pc's output)
__global__ void k_zout(const float* B, const float* w0, const float* t0,
                       float* z, long long n, const float* sc) {
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  if (idx < n) z[idx] = sqf_of(B[idx], w0[idx], sc[SC_ALPHA]) * t0[idx];
}

// ------------------------------------------------------------ the tail

// Walks the points k = tid, tid + 1024, ... of an m x m level (or of some
// rows of it), keeping (i, j) of k without a division: mul = 2^20 / m
// rounded up (Tail::wmul) gives n / m exactly for n <= 1024, m < 600.
struct Walk {
  int k, i, j, di, dj, m;
  __device__ Walk(int tid, int m_, unsigned mul) : k(tid), m(m_) {
    i = int((unsigned(tid) * mul) >> 20);
    j = tid - i * m;
    di = int((unsigned(TAIL_T * TAIL_T) * mul) >> 20);
    dj = (TAIL_T * TAIL_T) - di * m;
  }
  __device__ void next() {
    k += TAIL_T * TAIL_T;
    i += di;
    j += dj;
    if (j >= m) {
      j -= m;
      ++i;
    }
  }
};

// The shape of a tail (tail_shape), fixed for a workspace and passed by
// value. The nc levels above TAIL_ONE_MAX (none on one block) lie across
// the cluster, block r holding rows [lo[l][r], lo[l][r + 1]) of level l;
// the others lie whole in block 0. The rows of level nc, the first of
// block 0's, are split evenly (lo[nc]) and each finer strip is twice its
// coarser one, so that a block restricts into and prolongs from its own
// strip but for a row at each edge. Shared memory, in floats: at soff[l]
// the block's strips of cluster level l, b, w and x, then t (but at the
// first level, whose t goes straight out), rows[l] rows each; at scr a
// scratch strip of rows[0] + 2 rows of ms[0]; at blk block 0's levels,
// b, w, x and t, each tot floats with its levels contiguous, and a
// second buffer for the coarsest.
constexpr int MAX_CL = 4;   // cluster levels (3 at most, from 257)
struct Tail {
  int nl, nc, scr, blk, tot;
  int ms[MAX_LEVELS];       // level sizes
  int woff[MAX_LEVELS];     // level offsets in w
  unsigned wmul[MAX_LEVELS];   // 2^20 / ms rounded up (Walk)
  int lo[MAX_CL + 1][MAX_CLUSTER + 1];
  int rows[MAX_CL], soff[MAX_CL];
};

// The cluster barrier in its two halves: a block arrives once its reads
// of the other blocks' shared memory and its writes there are done, and
// waits before it reads what the others wrote (or, at the end, before it
// leaves, so that its own memory outlives their reads).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// a 4-byte copy from global to shared memory, in flight until copy_wait
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// waits for this thread's copies
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The strips of an array of one cluster level, read by rows: rows of this
// block's strip in its shared memory, a row at most two before it or one
// after it in the neighbouring block's (DSMEM). The level's other arrays
// lie at the same distance from it in every block.
struct Strips {
  const float *mine, *prev, *next;
  int lo, hi, plo, m;
  __device__ const float* row(int i) const {
    return i < lo    ? prev + (i - plo) * m
           : i >= hi ? next + (i - hi) * m
                     : mine + (i - lo) * m;
  }
};

__device__ __forceinline__ Strips strips_of(const float* mine,
                                            const Tail& tl, int nb, int rk,
                                            int l) {
  cg::cluster_group cl = cg::this_cluster();
  Strips s;
  s.m = tl.ms[l];
  s.lo = tl.lo[l][rk];
  s.hi = tl.lo[l][rk + 1];
  s.plo = rk > 0 ? tl.lo[l][rk - 1] : 0;
  s.mine = mine;
  s.prev = rk > 0 ? cl.map_shared_rank(mine, rk - 1) : mine;
  s.next = rk < nb - 1 ? cl.map_shared_rank(mine, rk + 1) : mine;
  return s;
}

// an m x m level held whole in this block, read by rows
__device__ __forceinline__ Strips whole(const float* a, int m) {
  Strips s;
  s.mine = s.prev = s.next = a;
  s.lo = s.plo = 0;
  s.hi = s.m = m;
  return s;
}

// The V-cycle from level lt down (tl: its shape) in one launch: a cluster
// of nb blocks of 32 x 32 threads (nb = 1: one block), with every level
// in dynamic shared memory. bin: b of level lt; w: the diagonals, levels
// contiguous; tout: the cycle's output at level lt. On a cluster level
// each block works on its strip:
//   down: the residual of the pre-smoothed x (on the strip and the row
//     before it, into the scratch strip), then its restriction at the
//     block's rows of the next level and their pre-smooth;
//   up: x + P e (on the strip and a row each side, into the scratch
//     strip), then its post-smooth into t.
// Each pair of passes ends at the cluster barrier, as the next reads rows
// of the neighbouring blocks; block 0's levels are walked whole, with a
// block barrier a pass, while the others wait at the cluster barrier.
__global__ void __launch_bounds__(TAIL_T * TAIL_T)
k_tail(const float* __restrict__ bin, const float* __restrict__ w,
       float* __restrict__ tout, const float* sc, const Tail tl,
       int gated) {
  if (dead(sc, gated)) return;
  extern __shared__ float smem[];
  const float alpha = sc[SC_ALPHA];
  cg::cluster_group cl = cg::this_cluster();
  const int nb = int(cl.num_blocks()), rk = int(cl.block_rank());
  const int nl = tl.nl, nc = tl.nc, m0 = tl.ms[0];
  const int* const ms = tl.ms;
  const int* const off = tl.woff;
  float* const scr = smem + tl.scr;
  // block 0's levels: level l at off[l] - o0 of each array
  const int o0 = off[nc], tot = tl.tot;
  float* const sb = smem + tl.blk;
  float* const sw = sb + tot;
  float* const sx = sb + 2 * tot;
  float* const st = sb + 3 * tot;
  float* const sy = sb + 4 * tot;
  const int tid = threadIdx.y * TAIL_T + threadIdx.x;
  const int nt = TAIL_T * TAIL_T;

  if (nc == 0) {
#pragma unroll 8
    for (int k = tid; k < tot; k += nt) sw[k] = w[k];
#pragma unroll 8
    for (int k = tid; k < m0 * m0; k += nt) {   // the same k as above
      const float bv = bin[k];
      sb[k] = bv;
      sx[k] = xpre(bv, sw[k], alpha);
    }
    __syncthreads();
  } else {
    // every copy in flight at once: w of each strip (and of block 0's
    // levels), b of the first level's strip
    for (int l = 0; l < nc; ++l) {
      const int m = ms[l], dw = tl.rows[l] * m;
      const int lo = tl.lo[l][rk];
      const int n = (tl.lo[l][rk + 1] - lo) * m;
      float* const b = smem + tl.soff[l];
      const float* const wl = w + off[l] + lo * m;
      for (int k = tid; k < n; k += nt) copy_async(b + dw + k, wl + k);
      if (l == 0)
        for (int k = tid; k < n; k += nt) copy_async(b + k, bin + lo * m + k);
    }
    if (rk == 0)
      for (int k = tid; k < tot; k += nt) copy_async(sw + k, w + o0 + k);
    copy_wait();
    {
      const int m = m0, dw = tl.rows[0] * m;
      const int n = (tl.lo[0][rk + 1] - tl.lo[0][rk]) * m;
      float* const b = smem + tl.soff[0];
      for (int k = tid; k < n; k += nt)   // the k this thread copied
        b[2 * dw + k] = xpre(b[k], b[dw + k], alpha);
    }
    cluster_sync();

    // down across the cluster
    for (int l = 0; l < nc; ++l) {
      const int m = ms[l], mc = ms[l + 1];
      const int dw = tl.rows[l] * m, dx = 2 * dw;
      const float* const own = smem + tl.soff[l];
      const Strips L = strips_of(own, tl, nb, rk, l);
      const int lo = L.lo, hi = L.hi, a = lo > 0 ? lo - 1 : 0;
      // the residual into scratch row i - lo + 1
      for (Walk p(tid, m, tl.wmul[l]); p.k < (hi - a) * m; p.next()) {
        const int i = a + p.i, j = p.j;
        float v;
        if (i > lo && i < hi - 1) {   // rows of this block alone
          const int k = (i - lo) * m + j;
          const float* x = own + dx + k;
          v = resid(own[k], own[dw + k], alpha, x[0], x[-m], x[m],
                    j > 0 ? x[-1] : 0.f, j < m - 1 ? x[1] : 0.f);
        } else {
          const float* r = L.row(i);
          const float* rn = L.row(i > 0 ? i - 1 : i) + dx;
          const float* rs = L.row(i < m - 1 ? i + 1 : i) + dx;
          const float* x = r + dx;
          v = resid(r[j], r[dw + j], alpha, x[j], i > 0 ? rn[j] : 0.f,
                    i < m - 1 ? rs[j] : 0.f, j > 0 ? x[j - 1] : 0.f,
                    j < m - 1 ? x[j + 1] : 0.f);
        }
        scr[(i - lo + 1) * m + j] = v;
      }
      __syncthreads();
      const int clo = tl.lo[l + 1][rk];
      const int chi = tl.lo[l + 1][rk + 1];
      float *bc, *xc;
      const float* wc;
      if (l + 1 < nc) {
        const int dc = tl.rows[l + 1] * mc;
        bc = smem + tl.soff[l + 1];
        wc = bc + dc;
        xc = bc + 2 * dc;
      } else {   // into block 0, its rows clo .. chi - 1
        bc = cl.map_shared_rank(sb, 0) + clo * mc;
        wc = cl.map_shared_rank(sw, 0) + clo * mc;
        xc = cl.map_shared_rank(sx, 0) + clo * mc;
      }
      for (Walk p(tid, mc, tl.wmul[l + 1]); p.k < (chi - clo) * mc; p.next()) {
        const float bv =
            restrict_at(scr, m, lo - 1, 0, clo + p.i, p.j, m, mc);
        bc[p.k] = bv;
        xc[p.k] = xpre(bv, wc[p.k], alpha);
      }
      cluster_sync();
    }
  }

  if (rk == 0) {
    // down: the residual of the pre-smooth x into t, then its restriction
    // and the pre-smooth of the next level
    for (int l = nc; l < nl - 1; ++l) {
      const int m = ms[l], mc = ms[l + 1];
      const float *b = sb + off[l] - o0, *wl = sw + off[l] - o0;
      const float* x = sx + off[l] - o0;
      float* t = st + off[l] - o0;
      for (Walk p(tid, m, tl.wmul[l]); p.k < m * m; p.next()) {
        const int i = p.i, j = p.j, idx = p.k;
        t[idx] = resid(b[idx], wl[idx], alpha, x[idx],
                       i > 0 ? x[idx - m] : 0.f,
                       i < m - 1 ? x[idx + m] : 0.f,
                       j > 0 ? x[idx - 1] : 0.f,
                       j < m - 1 ? x[idx + 1] : 0.f);
      }
      __syncthreads();
      float *bc = sb + off[l + 1] - o0, *xc = sx + off[l + 1] - o0;
      const float* wc = sw + off[l + 1] - o0;
      for (Walk p(tid, mc, tl.wmul[l + 1]); p.k < mc * mc; p.next()) {
        const float bv = restrict_at(t, m, 0, 0, p.i, p.j, m, mc);
        bc[p.k] = bv;
        xc[p.k] = xpre(bv, wc[p.k], alpha);
      }
      __syncthreads();
    }

    // coarsest: COARSE_SWEEPS sweeps from zero, into t
    {
      const int l = nl - 1, m = ms[l], n = m * m;
      const float *b = sb + off[l] - o0, *wl = sw + off[l] - o0;
      float* const out = st + off[l] - o0;
      if (n <= 32) {
        // one warp, one point a lane, neighbours by shuffles
        if (tid < 32) {
          const bool in = tid < n;
          const int i = in ? tid / m : 0, j = in ? tid - i * m : 0;
          const float bv = in ? b[tid] : 0.f, wv = in ? wl[tid] : 0.f;
          float xv = 0.f;
          for (int s = 0; s < COARSE_SWEEPS; ++s) {
            const float xn = __shfl_sync(FULL, xv, (tid - m) & 31);
            const float xs = __shfl_sync(FULL, xv, (tid + m) & 31);
            const float xw = __shfl_sync(FULL, xv, (tid - 1) & 31);
            const float xe = __shfl_sync(FULL, xv, (tid + 1) & 31);
            const float nx = smooth(bv, wv, alpha, xv, i > 0 ? xn : 0.f,
                                    i < m - 1 ? xs : 0.f, j > 0 ? xw : 0.f,
                                    j < m - 1 ? xe : 0.f);
            xv = in ? nx : 0.f;
          }
          if (in) out[tid] = xv;
        }
        __syncthreads();
      } else {
        // ping-pong between sy and out, starting in sy: an even number of
        // sweeps ends in out
        const float* src = nullptr;
        float* dst = sy;
        float* other = out;
        for (int s = 0; s < COARSE_SWEEPS; ++s) {
          for (Walk p(tid, m, tl.wmul[l]); p.k < n; p.next()) {
            const int i = p.i, j = p.j, idx = p.k;
            float xc = 0.f, xn = 0.f, xs = 0.f, xw = 0.f, xe = 0.f;
            if (src) {
              xc = src[idx];
              if (i > 0) xn = src[idx - m];
              if (i < m - 1) xs = src[idx + m];
              if (j > 0) xw = src[idx - 1];
              if (j < m - 1) xe = src[idx + 1];
            }
            dst[idx] = smooth(b[idx], wl[idx], alpha, xc, xn, xs, xw, xe);
          }
          __syncthreads();
          float* nd = (s == 0) ? other : const_cast<float*>(src);
          src = dst;
          dst = nd;
        }
      }
    }

    // up: x += P e, then the post-smooth of x into t
    for (int l = nl - 2; l >= nc; --l) {
      const int m = ms[l], mc = ms[l + 1];
      const float *b = sb + off[l] - o0, *wl = sw + off[l] - o0;
      float *x = sx + off[l] - o0, *t = st + off[l] - o0;
      const float* e = st + off[l + 1] - o0;
      for (Walk p(tid, m, tl.wmul[l]); p.k < m * m; p.next())
        x[p.k] = x[p.k] + prolong_at(e, p.i, p.j, mc);
      __syncthreads();
      for (Walk p(tid, m, tl.wmul[l]); p.k < m * m; p.next()) {
        const int i = p.i, j = p.j, idx = p.k;
        t[idx] = smooth(b[idx], wl[idx], alpha, x[idx],
                        i > 0 ? x[idx - m] : 0.f,
                        i < m - 1 ? x[idx + m] : 0.f,
                        j > 0 ? x[idx - 1] : 0.f,
                        j < m - 1 ? x[idx + 1] : 0.f);
      }
      __syncthreads();
    }
  }
  if (nc == 0) {
    for (int k = tid; k < m0 * m0; k += nt) tout[k] = st[k];
    return;
  }

  // up across the cluster, from block 0's output at level nc
  cluster_sync();
  for (int l = nc - 1; l >= 0; --l) {
    const int m = ms[l], mc = ms[l + 1];
    const int dw = tl.rows[l] * m, dx = 2 * dw;
    float* const b = smem + tl.soff[l];
    const Strips L = strips_of(b, tl, nb, rk, l);
    const int lo = L.lo, hi = L.hi;
    const int a = lo > 0 ? lo - 1 : 0, z = hi < m ? hi + 1 : m;
    // e: t of level l + 1, in strips, or whole in block 0, whose rows
    // a / 2 .. z / 2 that this block reads it copies into its own st first
    const float* const e =
        l + 1 < nc ? smem + tl.soff[l + 1] + 3 * tl.rows[l + 1] * mc : st;
    if (l + 1 == nc && rk != 0) {
      const float* const e0 = cl.map_shared_rank(st, 0);
      const int end = ((z >> 1) < mc - 1 ? (z >> 1) + 1 : mc) * mc;
      for (int k = (a >> 1) * mc + tid; k < end; k += nt) st[k] = e0[k];
      __syncthreads();
    }
    const Strips E =
        l + 1 < nc ? strips_of(e, tl, nb, rk, l + 1) : whole(st, mc);
    // x + P e into scratch row i - lo + 1
    for (Walk p(tid, m, tl.wmul[l]); p.k < (z - a) * m; p.next()) {
      const int i = a + p.i, j = p.j, I0 = i >> 1;
      const int I1 = (i & 1) ? I0 + 1 : I0;
      float v;
      if (i >= lo && i < hi && I1 < E.hi) {   // rows of this block alone
        v = b[dx + (i - lo) * m + j] +
            prolong_rows(e + (I0 - E.lo) * mc, e + (I1 - E.lo) * mc, i, j);
      } else {
        v = L.row(i)[dx + j] + prolong_rows(E.row(I0), E.row(I1), i, j);
      }
      scr[(i - lo + 1) * m + j] = v;
    }
    if (l == 0) cluster_arrive();   // the last reads of other blocks
    __syncthreads();
    // the post-smooth into t (at level lt: into tout)
    float* const t = l > 0 ? b + 3 * dw : tout + lo * m;
    for (Walk p(tid, m, tl.wmul[l]); p.k < (hi - lo) * m; p.next()) {
      const int i = lo + p.i, j = p.j;
      const float* u = scr + (p.i + 1) * m + j;
      t[p.k] = smooth(b[p.k], b[dw + p.k], alpha, u[0],
                      i > 0 ? u[-m] : 0.f, i < m - 1 ? u[m] : 0.f,
                      j > 0 ? u[-1] : 0.f, j < m - 1 ? u[1] : 0.f);
    }
    if (l > 0) cluster_sync();
  }
  cluster_wait();
}

// ------------------------------------------------------------ host side

// the level sizes of ops/mg.py _levels_for
int levels_for(int m, int* ms) {
  int L = 0;
  ms[L++] = m;
  while (L < MAX_LEVELS && ms[L - 1] >= 9 && (ms[L - 1] - 1) % 2 == 0) {
    ms[L] = (ms[L - 1] - 1) / 2 + 1;
    ++L;
  }
  return L;
}

// The shape of the tail on the levels ms[0 .. nl) over nb blocks (see
// Tail); returns the floats of its shared memory, or -1 when the kernel
// cannot run it: a cluster tail has levels on both sides of TAIL_ONE_MAX,
// and the walks take levels below 600.
long long tail_shape(const int* ms, int nl, int nb, Tail* tl) {
  if (nl < 1 || nb < 1 || nb > MAX_CLUSTER || ms[0] >= 600) return -1;
  Tail t = {};
  t.nl = nl;
  int o = 0;
  for (int l = 0; l < nl; ++l) {
    t.ms[l] = ms[l];
    t.woff[l] = o;
    t.wmul[l] = ((1u << 20) + unsigned(ms[l]) - 1) / unsigned(ms[l]);
    o += ms[l] * ms[l];
  }
  while (nb > 1 && t.nc < nl && ms[t.nc] > TAIL_ONE_MAX) ++t.nc;
  const int nc = t.nc;
  if (nb > 1 && (nc == 0 || nc == nl || nc > MAX_CL)) return -1;
  long long f = 0;
  for (int l = nc; l >= 0 && nc > 0; --l) {
    for (int r = 0; r <= nb; ++r)
      t.lo[l][r] = r == nb ? ms[l] : (r * ms[nc] / nb) << (nc - l);
    if (l == nc) continue;
    for (int r = 0; r < nb; ++r) {
      const int k = t.lo[l][r + 1] - t.lo[l][r];
      t.rows[l] = k > t.rows[l] ? k : t.rows[l];
    }
  }
  for (int l = 0; l < nc; ++l) {
    t.soff[l] = int(f);
    f += (l == 0 ? 3 : 4) * (long long)t.rows[l] * ms[l];
  }
  t.scr = int(f);
  if (nc > 0) f += (long long)(t.rows[0] + 2) * ms[0];
  t.blk = int(f);
  t.tot = o - t.woff[nc];
  f += 4LL * t.tot + (long long)ms[nl - 1] * ms[nl - 1];
  if (tl) *tl = t;
  return f;
}

// dynamic shared memory of the tail from level lt on nb blocks, or -1
// when the kernel cannot run it (tail_shape) or it does not fit a block
long long tail_bytes(const int* ms, int L, int lt, int nb) {
  if (lt < 0 || lt >= L) return -1;
  const long long f = tail_shape(ms + lt, L - lt, nb, nullptr);
  return f < 0 || 4 * f > MAX_SMEM ? -1 : 4 * f;
}

inline int nblocks(long long n) { return int((n + NT - 1) / NT); }
inline int nbands(int m) { return int(((long long)m * m + BAND - 1) / BAND); }
inline size_t matvec_smem(int m) { return 4 * size_t(band_span(m) + BAND); }
inline size_t up0_smem(int m) { return 4 * size_t(band_span(m) + 2 * BAND); }

// lets the kernels with m-sized shared memory take up to MAX_SMEM
// (and k_tail a cluster of more than 8 blocks, where the card has them)
cudaError_t allow_smem() {
  cudaError_t e = cudaFuncSetAttribute(
      k_tail, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        k_tail, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        k_matvec, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        k_up0, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  return e;
}

// slots whose offsets the wrapper reads (ops/mgfused.py _OFF_*)
enum { OFF_B = 0, OFF_C, OFF_W, OFF_R0, OFF_XB, OFF_Z, OFF_SC, OFF_N };

struct Ws {
  int m = 0, L = 0, lt = 0;     // lt: first level of the tail (L: none)
  int nb = 1;                   // blocks of the tail's cluster
  Tail tail;
  int ms[MAX_LEVELS];
  long long woff[MAX_LEVELS];
  long long off[OFF_N];
  float *B, *C, *w, *x, *xb, *Ap, *z, *sc, *part, *spare, *t0;
  float *p[2], *r[2], *b[MAX_LEVELS], *t[MAX_LEVELS];
  unsigned* cnt;
  size_t tail_smem = 0;
  cudaStream_t cap = nullptr;   // private stream, used only for capture
};

// Lays the workspace out over base (only counts when base is null);
// returns the number of floats. Every array starts on 256 bytes.
long long layout(Ws& ws, float* base) {
  long long o = 0;
  auto take = [&](long long k) {
    float* p = base ? base + o : nullptr;
    o += (k + 63) / 64 * 64;
    return p;
  };
  const long long n = (long long)ws.m * ws.m;
  long long wtot = 0;
  for (int l = 0; l < ws.L; ++l) {
    ws.woff[l] = wtot;
    wtot += (long long)ws.ms[l] * ws.ms[l];
  }
  ws.off[OFF_B] = o; ws.B = take(n);
  ws.off[OFF_C] = o; ws.C = take(n);
  ws.off[OFF_W] = o; ws.w = take(wtot);
  ws.off[OFF_R0] = o; ws.r[0] = take(n);
  ws.r[1] = take(n);
  ws.off[OFF_XB] = o; ws.xb = take(n);
  ws.off[OFF_Z] = o; ws.z = take(n);
  ws.off[OFF_SC] = o; ws.sc = take(SC_LEN);
  ws.x = take(n);
  ws.Ap = take(n);
  ws.p[0] = take(n);
  ws.p[1] = take(n);
  for (int l = 0; l < ws.L; ++l) {
    const long long nl = (long long)ws.ms[l] * ws.ms[l];
    ws.b[l] = take(nl);
    ws.t[l] = take(nl);
  }
  const int c = ws.L - 1;
  ws.spare = take((long long)ws.ms[c] * ws.ms[c]);
  ws.part = take(3LL * nblocks(n));
  return o;
}

inline dim3 fine_grid(int m) {
  return dim3((m + TX - 1) / TX, (m + TY - 1) / TY);
}

inline dim3 coarse_grid(int m) {
  const int mc = (m - 1) / 2 + 1;
  return dim3((mc + CX - 1) / CX, (mc + CY - 1) / CY);
}

#define CHECK_LAUNCH()                              \
  do {                                              \
    cudaError_t e_ = cudaGetLastError();            \
    if (e_ != cudaSuccess) return int(e_);          \
  } while (0)

// 24 sweeps of level c by grid kernels; *out: the buffer holding the result
int sweeps(const Ws& ws, int c, int gated, cudaStream_t st, float** out) {
  const int m = ws.ms[c];
  const float* wl = ws.w + ws.woff[c];
  const float* src = nullptr;
  float* dst = ws.t[c];
  float* other = ws.spare;
  for (int s = 0; s < COARSE_SWEEPS; ++s) {
    k_sweep<<<fine_grid(m), dim3(TX, THY), 0, st>>>(src, ws.b[c], wl, dst,
                                                    ws.sc, m, gated);
    CHECK_LAUNCH();
    float* nd = (s == 0) ? other : const_cast<float*>(src);
    src = dst;
    dst = nd;
  }
  *out = const_cast<float*>(src);
  return 0;
}

// the launch of the tail: one cluster of ws.nb blocks (at holds its
// attribute)
cudaLaunchConfig_t tail_config(const Ws& ws, cudaStream_t st,
                               cudaLaunchAttribute* at) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ws.nb);
  cfg.blockDim = dim3(TAIL_T, TAIL_T);
  cfg.dynamicSmemBytes = ws.tail_smem;
  cfg.stream = st;
  at->id = cudaLaunchAttributeClusterDimension;
  at->val.clusterDim.x = ws.nb;
  at->val.clusterDim.y = 1;
  at->val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

// The bottom of the cycle at level l (the tail, or the sweeps of a
// coarsest level too large for it); *out: the buffer holding its output.
int bottom(const Ws& ws, int l, int gated, cudaStream_t st, float** out) {
  if (l == ws.lt) {
    cudaLaunchAttribute at;
    const cudaLaunchConfig_t cfg = tail_config(ws, st, &at);
    cudaError_t e = cudaLaunchKernelEx(
        &cfg, k_tail, (const float*)ws.b[l], (const float*)(ws.w + ws.woff[l]),
        ws.t[l], (const float*)ws.sc, ws.tail, gated);
    if (e != cudaSuccess) return int(e);
    CHECK_LAUNCH();
    *out = ws.t[l];
    return 0;
  }
  return sweeps(ws, l, gated, st, out);
}

// One V-cycle on b0 = sqf r' with the level-0 updates of the iteration
// (prime: the priming's cycle, on b0 = sqf r), ending with the scalars.
int vcycle(const Ws& ws, int prime, cudaStream_t st) {
  const int gated = !prime, m = ws.m;
  const dim3 fb(TX, THY), cb(CX, CY);
  float* out = nullptr;
  int err = 0;
  if (ws.L == 1 || ws.lt == 0) {   // level 0 is the bottom
    k_axpy0<<<fine_grid(m), fb, 0, st>>>(ws.B, ws.w, ws.x, ws.r[0], ws.r[1],
                                         ws.p[0], ws.p[1], ws.Ap, ws.b[0],
                                         ws.sc, m, prime);
    CHECK_LAUNCH();
    if ((err = bottom(ws, 0, gated, st, &out))) return err;
    k_rz0<<<nblocks((long long)m * m), NT, 0, st>>>(
        ws.B, ws.w, ws.r[0], ws.r[1], out, ws.part, ws.cnt + 1, ws.sc, m,
        prime);
    CHECK_LAUNCH();
    return 0;
  }
  const int c = ws.lt < ws.L ? ws.lt : ws.L - 1;   // the bottom level
  k_down0<<<coarse_grid(m), cb, 0, st>>>(ws.B, ws.w, ws.x, ws.r[0], ws.r[1],
                                         ws.p[0], ws.p[1], ws.Ap, ws.b[1],
                                         ws.sc, m, prime);
  CHECK_LAUNCH();
  for (int l = 1; l < c; ++l) {
    k_down<<<coarse_grid(ws.ms[l]), cb, 0, st>>>(ws.b[l], ws.w + ws.woff[l],
                                                  ws.b[l + 1], ws.sc,
                                                  ws.ms[l], gated);
    CHECK_LAUNCH();
  }
  if ((err = bottom(ws, c, gated, st, &out))) return err;
  for (int l = c - 1; l >= 1; --l) {
    k_up<<<fine_grid(ws.ms[l]), fb, 0, st>>>(ws.b[l], ws.w + ws.woff[l],
                                              out, ws.t[l], ws.sc, ws.ms[l],
                                              gated);
    CHECK_LAUNCH();
    out = ws.t[l];
  }
  k_up0<<<nbands(m), NT, up0_smem(m), st>>>(ws.B, ws.w, ws.r[0], ws.r[1],
                                             out, ws.t[0], ws.part,
                                             ws.cnt + 1, ws.sc, m, prime);
  CHECK_LAUNCH();
  return 0;
}

// the buffer holding the V-cycle's level-0 output (what k_matvec reads)
float* cycle_output(const Ws& ws) {
  if (ws.L == 1 && ws.lt != 0)   // sweeps: the result lands in spare
    return ws.spare;
  return ws.t[0];
}

// One chunk: with first, zero the iterate buffers and prime (p = z0 comes
// from the first matvec with beta = 0 and a zero old p), then `chunk`
// iterations, then the pending best-iterate copy if the solve is over.
int enqueue_chunk(const Ws& ws, int chunk, int first, cudaStream_t st) {
  const long long n = (long long)ws.m * ws.m;
  if (first) {
    for (float* v : {ws.x, ws.xb, ws.Ap, ws.p[0], ws.p[1]}) {
      cudaError_t e = cudaMemsetAsync(v, 0, n * sizeof(float), st);
      if (e != cudaSuccess) return int(e);
    }
    cudaError_t e = cudaMemsetAsync(ws.cnt, 0, 2 * sizeof(unsigned), st);
    if (e != cudaSuccess) return int(e);
    if (int err = vcycle(ws, 1, st)) return err;
  }
  const float* t0 = cycle_output(ws);
  for (int k = 0; k < chunk; ++k) {
    k_matvec<<<nbands(ws.m), NT, matvec_smem(ws.m), st>>>(
        ws.B, ws.C, ws.w, t0, ws.p[0], ws.p[1], ws.Ap, ws.x, ws.xb, ws.part,
        ws.cnt, ws.sc, ws.m, 1);
    CHECK_LAUNCH();
    if (int err = vcycle(ws, 0, st)) return err;
  }
  k_flush<<<int((n + NT - 1) / NT), NT, 0, st>>>(ws.x, ws.xb, n, ws.sc);
  CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" {

const char* mgf_error_string(int err) {
  if (err == ERR_NO_CLUSTER)
    return "the tail's cluster fits nowhere on this card "
           "(cudaOccupancyMaxActiveClusters is 0)";
  return cudaGetErrorString(cudaError_t(err));
}

// Floats of the workspace for m with the tail from level lt on a cluster
// of nb blocks (the wrapper's level_plan); -1 when the kernel cannot run
// that tail (tail_bytes).
long long mgf_ws_floats(int m, int lt, int nb) {
  Ws ws;
  ws.m = m;
  ws.L = levels_for(m, ws.ms);
  if (lt < 0 || lt > ws.L) return -1;
  if (lt == ws.L ? nb != 1 : tail_bytes(ws.ms, ws.L, lt, nb) < 0) return -1;
  if (up0_smem(m) > size_t(MAX_SMEM)) return -1;
  ws.lt = lt;
  ws.nb = nb;
  return layout(ws, nullptr);
}

// The workspace over fbase (mgf_ws_floats(m, lt, nb) floats) and cnt (two
// zeroed counters), once the card was found to hold the tail's cluster.
// Returns a handle, or null with *err set.
void* mgf_ws_create(int m, int lt, int nb, float* fbase, unsigned* cnt,
                    int* err) {
  *err = 0;
  if (mgf_ws_floats(m, lt, nb) < 0) {
    *err = int(cudaErrorInvalidValue);
    return nullptr;
  }
  Ws* ws = new Ws;
  ws->m = m;
  ws->L = levels_for(m, ws->ms);
  ws->lt = lt;
  ws->nb = nb;
  layout(*ws, fbase);
  ws->cnt = cnt;
  ws->t0 = cycle_output(*ws);
  if (lt < ws->L) {
    ws->tail_smem = size_t(tail_bytes(ws->ms, ws->L, lt, nb));
    tail_shape(ws->ms + lt, ws->L - lt, nb, &ws->tail);
  }
  cudaError_t e = allow_smem();
  if (e == cudaSuccess && lt < ws->L) {
    cudaLaunchAttribute at;
    const cudaLaunchConfig_t cfg = tail_config(*ws, nullptr, &at);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, k_tail, &cfg);
    if (e == cudaSuccess && clusters < 1) {
      delete ws;
      *err = ERR_NO_CLUSTER;
      return nullptr;
    }
  }
  if (e == cudaSuccess)
    e = cudaStreamCreateWithFlags(&ws->cap, cudaStreamNonBlocking);
  if (e != cudaSuccess) {
    delete ws;
    *err = int(e);
    return nullptr;
  }
  return ws;
}

long long mgf_ws_offset(void* h, int slot) {
  return static_cast<Ws*>(h)->off[slot];
}

void mgf_ws_destroy(void* h) {
  Ws* ws = static_cast<Ws*>(h);
  if (ws->cap) cudaStreamDestroy(ws->cap);
  delete ws;
}

// Captures one chunk (see enqueue_chunk) on the workspace's private
// stream and instantiates it. Returns the executable graph, or null with
// *err set.
void* mgf_capture(void* h, int chunk, int first, int* err) {
  Ws* ws = static_cast<Ws*>(h);
  *err = 0;
  cudaError_t e = cudaStreamBeginCapture(ws->cap,
                                         cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) {
    *err = int(e);
    return nullptr;
  }
  const int enq = enqueue_chunk(*ws, chunk, first, ws->cap);
  cudaGraph_t g = nullptr;
  e = cudaStreamEndCapture(ws->cap, &g);
  if (enq != 0 || e != cudaSuccess) {
    if (g) cudaGraphDestroy(g);
    cudaGetLastError();
    *err = enq != 0 ? enq : int(e);
    return nullptr;
  }
  cudaGraphExec_t ex = nullptr;
  e = cudaGraphInstantiate(&ex, g, 0ULL);
  cudaGraphDestroy(g);
  if (e != cudaSuccess) {
    *err = int(e);
    return nullptr;
  }
  return ex;
}

int mgf_launch(void* graph, void* stream) {
  return int(cudaGraphLaunch(static_cast<cudaGraphExec_t>(graph),
                             static_cast<cudaStream_t>(stream)));
}

void mgf_graph_destroy(void* graph) {
  cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(graph));
}

// z = sqf * V(sqf * r) for r in the workspace's r buffer 0, into its z
// buffer: the priming's cycle, launched directly on the stream.
int mgf_pc(void* h, void* stream) {
  const Ws& ws = *static_cast<Ws*>(h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int err = vcycle(ws, 1, st)) return err;
  const long long n = (long long)ws.m * ws.m;
  k_zout<<<int((n + NT - 1) / NT), NT, 0, st>>>(ws.B, ws.w, ws.t0, ws.z, n,
                                                ws.sc);
  CHECK_LAUNCH();
  return 0;
}

// The grid kernels launched alone, ungated, to hold each against its
// plain version. sc holds alpha (and beta for the matvec, whose parity
// slot must be 0: p is read from pa and p' written to pb).
long long mgf_fine_blocks(int m) { return nblocks((long long)m * m); }

int mgf_matvec(const float* B, const float* C, const float* w0,
               const float* t0, float* pa, float* pb, float* Ap, float* part,
               unsigned* cnt, float* sc, int m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cudaError_t e = allow_smem()) return int(e);
  k_matvec<<<nbands(m), NT, matvec_smem(m), st>>>(
      B, C, w0, t0, pa, pb, Ap, nullptr, nullptr, part, cnt, sc, m, 0);
  CHECK_LAUNCH();
  return 0;
}

int mgf_down(const float* b, const float* w, float* bc, const float* sc,
             int m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  k_down<<<coarse_grid(m), dim3(CX, CY), 0, st>>>(b, w, bc, sc, m, 0);
  CHECK_LAUNCH();
  return 0;
}

int mgf_up(const float* b, const float* w, const float* e, float* t,
           const float* sc, int m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  k_up<<<fine_grid(m), dim3(TX, THY), 0, st>>>(b, w, e, t, sc, m, 0);
  CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
