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
// * Memory bandwidth. A V-cycle is many stencil passes over f32 grids
//   (smooth, residual, restrict, prolong, smooth per level) and each does a
//   handful of flops per byte. The TPU kernel kept the whole ~60 MB working
//   set in VMEM; an SM has 227 KB of shared memory and the L2 is 50 MB, so
//   here every fine-level pass streams through device memory. Each kernel
//   reads its stencil neighbours through L1/L2 (neighbouring threads touch
//   neighbouring addresses), computes in registers and writes once. No
//   intermediate is written that a later pass could recompute cheaply: the
//   preconditioned vector z is never stored (sqf * x is recomputed where it
//   is used), and sqf itself is recomputed from B and w0.
// * Launch overhead at the coarse levels. Below m = 33 a level is a few
//   hundred points, far too little work for a grid launch. All levels with
//   m <= 33 (33, 17, 9, 5 at the bench size) run as ONE block that keeps
//   them in shared memory and runs all their smoothing sweeps, including
//   the 24 coarsest ones, between __syncthreads() barriers.
//
// Control flow. Scalars (a, beta, the best-iterate bookkeeping and the loop
// condition) never leave the device inside a chunk: single-block scalar
// kernels reduce the per-block partial sums and update a small state vector
// `sc`. Every vector kernel of an iteration first reads the device flag
// sc[LIVE] and returns at once when the solve is finished, so a chunk of
// `chunk` queued iterations after convergence is the identity -- the masked
// fori body of the TPU kernel. The host reads sc once per chunk.
//
// Determinism. Every dot product is two passes in a fixed order (a tree
// inside each block, then one block summing the block partials in a fixed
// strided order and a tree), with no float atomics, so the result is
// bitwise the same for any chunk size. Built with -fmad=false so that the
// same expression gives the same bits in every kernel that computes it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC -o libmgfused.so mgfused.cu
// Plain C interface, loaded with ctypes (proximalgalerkin_torch/ops/mgfused.py).

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int TPB = 256;          // threads per block of the grid kernels
constexpr int RED_TPB = 1024;     // threads of the single-block reductions
constexpr int COARSE_MAX = 33;    // levels with m <= this run in one block
constexpr int COARSE_TPB = 512;
constexpr int COARSE_SH = 1600;   // >= sum of m^2 over a tail from m <= 33
constexpr int COARSE_SWEEPS = 24;
constexpr int MAX_LEVELS = 32;
constexpr float OMEGA = 0.8f;

// slots of the device state vector (ops/mgfused.py _SC_*)
enum {
  SC_IT = 0, SC_RR, SC_RZ, SC_RRB, SC_IB, SC_OK, SC_STOP, SC_LIVE,
  SC_A, SC_GOOD, SC_BETA, SC_BETTER, SC_LEN = 16
};

__device__ __forceinline__ bool dead(const float* gate) {
  return gate != nullptr && *gate < 0.5f;
}

// 5-point stencil {4; -1 N/S/E/W} of v at (i, j), zero outside [0, m)^2,
// summed in the order of the plain version (ops/mg.py k5_apply).
__device__ __forceinline__ float k5_at(const float* v, int i, int j, int m) {
  const int idx = i * m + j;
  const float n = i > 0 ? v[idx - m] : 0.f;
  const float s = i < m - 1 ? v[idx + m] : 0.f;
  const float w = j > 0 ? v[idx - 1] : 0.f;
  const float e = j < m - 1 ? v[idx + 1] : 0.f;
  return 4.f * v[idx] - n - s - w - e;
}

// (B p) at (i, j), zero outside the grid
__device__ __forceinline__ float bp_at(const float* B, const float* p, int i,
                                       int j, int m) {
  if (i < 0 || i >= m || j < 0 || j >= m) return 0.f;
  const int idx = i * m + j;
  return B[idx] * p[idx];
}

__device__ __forceinline__ float sqf_at(const float* B, const float* w0,
                                        float alpha, int idx) {
  return B[idx] * (4.f * alpha + w0[idx]);
}

// one damped-Jacobi update at idx; x == nullptr means x = 0
__device__ __forceinline__ float smooth_at(const float* x, const float* b,
                                           const float* w, float alpha, int i,
                                           int j, int m) {
  const int idx = i * m + j;
  const float xv = x ? x[idx] : 0.f;
  const float k5 = x ? k5_at(x, i, j, m) : 0.f;
  const float res = b[idx] - (alpha * k5 + w[idx] * xv);
  const float d = alpha * 4.f + w[idx];
  return xv + OMEGA * res / d;
}

__device__ __forceinline__ float residual_at(const float* x, const float* b,
                                             const float* w, float alpha,
                                             int i, int j, int m) {
  const int idx = i * m + j;
  return b[idx] - (alpha * k5_at(x, i, j, m) + w[idx] * x[idx]);
}

// full weighting R f R^T at coarse (I, J): rows first, then columns
__device__ __forceinline__ float restrict_at(const float* f, int I, int J,
                                             int m, int mc) {
  float u[3];
  for (int dj = -1; dj <= 1; ++dj) {
    const int j = 2 * J + dj;
    u[dj + 1] = 0.f;
    if (j < 0 || j >= m) continue;
    float acc = 0.f;
    if (I > 0) acc = acc + 0.25f * f[(2 * I - 1) * m + j];
    acc = acc + 0.5f * f[(2 * I) * m + j];
    if (I < mc - 1) acc = acc + 0.25f * f[(2 * I + 1) * m + j];
    u[dj + 1] = acc;
  }
  float c = 0.f;
  if (J > 0) c = c + 0.25f * u[0];
  c = c + 0.5f * u[1];
  if (J < mc - 1) c = c + 0.25f * u[2];
  return c;
}

// (P e)(i, j) = 4 (R^T e R)(i, j): bilinear interpolation
__device__ __forceinline__ float prolong_at(const float* e, int i, int j,
                                            int mc) {
  const int I0 = i >> 1, J0 = j >> 1;
  const bool oi = i & 1, oj = j & 1;
  float rc[2];
  for (int k = 0; k < (oj ? 2 : 1); ++k) {
    const int J = J0 + k;
    rc[k] = oi ? 0.25f * e[I0 * mc + J] + 0.25f * e[(I0 + 1) * mc + J]
               : 0.5f * e[I0 * mc + J];
  }
  const float v = oj ? 0.25f * rc[0] + 0.25f * rc[1] : 0.5f * rc[0];
  return 4.f * v;
}

// fixed-order tree over the block; every thread of the block must call it
__device__ float block_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const float out = sh[0];
  __syncthreads();
  return out;
}

__device__ float sum_parts(const float* part, int nb, float* sh) {
  float acc = 0.f;
  for (int k = threadIdx.x; k < nb; k += blockDim.x) acc += part[k];
  return block_sum(acc, sh);
}

// ------------------------------------------------------- grid kernels

__global__ void k_matvec(const float* B, const float* C, const float* p,
                         float* Ap, float* part, float alpha, int m,
                         const float* gate) {
  if (dead(gate)) return;
  __shared__ float sh[TPB];
  const int idx = blockIdx.x * TPB + threadIdx.x;
  float contrib = 0.f;
  if (idx < m * m) {
    const int i = idx / m, j = idx - (idx / m) * m;
    const float c = B[idx] * p[idx];
    const float k5 = 4.f * c - bp_at(B, p, i - 1, j, m)
                     - bp_at(B, p, i + 1, j, m) - bp_at(B, p, i, j - 1, m)
                     - bp_at(B, p, i, j + 1, m);
    const float y = alpha * (B[idx] * k5) + C[idx] * p[idx];
    Ap[idx] = y;
    contrib = p[idx] * y;
  }
  const float s = block_sum(contrib, sh);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// b0 = sqf * r (the level-0 right-hand side of the V-cycle)
__global__ void k_scale(const float* r, const float* B, const float* w0,
                        float* b0, float alpha, int n, const float* gate) {
  if (dead(gate)) return;
  const int idx = blockIdx.x * TPB + threadIdx.x;
  if (idx < n) b0[idx] = sqf_at(B, w0, alpha, idx) * r[idx];
}

// x += a p, r -= a Ap, then b0 = sqf * r
__global__ void k_axpy(float* x, float* r, const float* p, const float* Ap,
                       const float* B, const float* w0, float* b0,
                       float alpha, int n, const float* sc) {
  if (dead(sc + SC_LIVE)) return;
  const int idx = blockIdx.x * TPB + threadIdx.x;
  if (idx >= n) return;
  const float a = sc[SC_A];
  x[idx] = x[idx] + a * p[idx];
  const float rn = r[idx] - a * Ap[idx];
  r[idx] = rn;
  b0[idx] = sqf_at(B, w0, alpha, idx) * rn;
}

// partials of r.z and r.r with z = sqf * xv (z is never stored)
__global__ void k_rz(const float* r, const float* B, const float* w0,
                     const float* xv, float* part_rz, float* part_rr,
                     float alpha, int n, const float* gate) {
  if (dead(gate)) return;
  __shared__ float sh[TPB];
  const int idx = blockIdx.x * TPB + threadIdx.x;
  float rz = 0.f, rr = 0.f;
  if (idx < n) {
    const float z = sqf_at(B, w0, alpha, idx) * xv[idx];
    rz = r[idx] * z;
    rr = r[idx] * r[idx];
  }
  const float s1 = block_sum(rz, sh);
  const float s2 = block_sum(rr, sh);
  if (threadIdx.x == 0) {
    part_rz[blockIdx.x] = s1;
    part_rr[blockIdx.x] = s2;
  }
}

// out = sqf * xv: the preconditioned vector z (first p, or mgf_pc's output)
__global__ void k_zout(const float* B, const float* w0, const float* xv,
                       float* out, float alpha, int n) {
  const int idx = blockIdx.x * TPB + threadIdx.x;
  if (idx < n) out[idx] = sqf_at(B, w0, alpha, idx) * xv[idx];
}

// p = z + beta p; xb = x where the residual improved
__global__ void k_pupdate(float* p, const float* B, const float* w0,
                          const float* xv, const float* x, float* xb,
                          float alpha, int n, const float* sc) {
  if (dead(sc + SC_LIVE)) return;
  const int idx = blockIdx.x * TPB + threadIdx.x;
  if (idx >= n) return;
  const float z = sqf_at(B, w0, alpha, idx) * xv[idx];
  p[idx] = z + sc[SC_BETA] * p[idx];
  if (sc[SC_BETTER] > 0.5f) xb[idx] = x[idx];
}

__global__ void k_smooth(const float* x, const float* b, const float* w,
                         float* out, float alpha, int m, const float* gate) {
  if (dead(gate)) return;
  const int idx = blockIdx.x * TPB + threadIdx.x;
  if (idx >= m * m) return;
  const int i = idx / m, j = idx - (idx / m) * m;
  out[idx] = smooth_at(x, b, w, alpha, i, j, m);
}

__global__ void k_residual(const float* x, const float* b, const float* w,
                           float* out, float alpha, int m,
                           const float* gate) {
  if (dead(gate)) return;
  const int idx = blockIdx.x * TPB + threadIdx.x;
  if (idx >= m * m) return;
  const int i = idx / m, j = idx - (idx / m) * m;
  out[idx] = residual_at(x, b, w, alpha, i, j, m);
}

__global__ void k_restrict(const float* f, float* c, int m,
                           const float* gate) {
  if (dead(gate)) return;
  const int mc = (m - 1) / 2 + 1;
  const int idx = blockIdx.x * TPB + threadIdx.x;
  if (idx >= mc * mc) return;
  const int I = idx / mc, J = idx - (idx / mc) * mc;
  c[idx] = restrict_at(f, I, J, m, mc);
}

__global__ void k_prolong_add(const float* e, float* x, int mc,
                              const float* gate) {
  if (dead(gate)) return;
  const int m = 2 * (mc - 1) + 1;
  const int idx = blockIdx.x * TPB + threadIdx.x;
  if (idx >= m * m) return;
  const int i = idx / m, j = idx - (idx / m) * m;
  x[idx] = x[idx] + prolong_at(e, i, j, mc);
}

// The V-cycle below (and including) a level with m <= COARSE_MAX, as one
// block with every level in shared memory. b_g: the tail's finest right-hand
// side; w_g: the tail's diagonals, levels contiguous; x_g: its solution.
__global__ void __launch_bounds__(COARSE_TPB)
k_coarse(const float* b_g, const float* w_g, float* x_g, int m0, int nl,
         float alpha, const float* gate) {
  if (dead(gate)) return;
  __shared__ float sb[COARSE_SH], sx[COARSE_SH], st[COARSE_SH],
      sw[COARSE_SH];
  int ms[8], off[8];
  ms[0] = m0;
  off[0] = 0;
  for (int l = 1; l < nl; ++l) {
    ms[l] = (ms[l - 1] - 1) / 2 + 1;
    off[l] = off[l - 1] + ms[l - 1] * ms[l - 1];
  }
  const int total = off[nl - 1] + ms[nl - 1] * ms[nl - 1];
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k = tid; k < total; k += nt) sw[k] = w_g[k];
  for (int k = tid; k < m0 * m0; k += nt) sb[k] = b_g[k];
  __syncthreads();

  // down: pre-smooth from zero, residual, restrict
  for (int l = 0; l < nl - 1; ++l) {
    const int m = ms[l], mc = ms[l + 1];
    float *b = sb + off[l], *x = sx + off[l], *t = st + off[l],
          *w = sw + off[l];
    for (int k = tid; k < m * m; k += nt)
      x[k] = smooth_at(nullptr, b, w, alpha, k / m, k % m, m);
    __syncthreads();
    for (int k = tid; k < m * m; k += nt)
      t[k] = residual_at(x, b, w, alpha, k / m, k % m, m);
    __syncthreads();
    for (int k = tid; k < mc * mc; k += nt)
      sb[off[l + 1] + k] = restrict_at(t, k / mc, k % mc, m, mc);
    __syncthreads();
  }
  // coarsest: COARSE_SWEEPS sweeps from zero, ping-pong sx <-> st
  const float* res[8];
  {
    const int l = nl - 1, m = ms[l];
    float *b = sb + off[l], *w = sw + off[l];
    float *src = nullptr, *dst = sx + off[l], *other = st + off[l];
    for (int s = 0; s < COARSE_SWEEPS; ++s) {
      for (int k = tid; k < m * m; k += nt)
        dst[k] = smooth_at(src, b, w, alpha, k / m, k % m, m);
      __syncthreads();
      float* nd = (s == 0) ? other : src;
      src = dst;
      dst = nd;
    }
    res[l] = src;
  }
  // up: prolong-add, post-smooth
  for (int l = nl - 2; l >= 0; --l) {
    const int m = ms[l], mc = ms[l + 1];
    float *b = sb + off[l], *x = sx + off[l], *t = st + off[l],
          *w = sw + off[l];
    const float* e = res[l + 1];
    for (int k = tid; k < m * m; k += nt)
      x[k] = x[k] + prolong_at(e, k / m, k % m, mc);
    __syncthreads();
    for (int k = tid; k < m * m; k += nt)
      t[k] = smooth_at(x, b, w, alpha, k / m, k % m, m);
    __syncthreads();
    res[l] = t;
  }
  for (int k = tid; k < m0 * m0; k += nt) x_g[k] = res[0][k];
}

// ----------------------------------------------------- scalar kernels

// sc[LIVE] = the loop condition (mgfused.py:288-296 live_of, :419-428 cond)
__global__ void k_begin(float* sc, float maxiter, float window,
                        float guard) {
  const float it = sc[SC_IT], stop = sc[SC_STOP];
  const bool stalled = (it - sc[SC_IB] > window) &&
                       (sc[SC_RRB] < guard * stop);
  const bool live = sc[SC_OK] > 0.5f && !stalled && it < maxiter &&
                    sc[SC_RR] > stop;
  sc[SC_LIVE] = live ? 1.f : 0.f;
}

// a = rz / p.Ap, with the breakdown guard
__global__ void k_alpha(const float* part, int nb, float* sc) {
  if (dead(sc + SC_LIVE)) return;
  __shared__ float sh[RED_TPB];
  const float pAp = sum_parts(part, nb, sh);
  if (threadIdx.x == 0) {
    const float rz = sc[SC_RZ];
    const bool good = pAp > FLT_MIN && rz > FLT_MIN;
    sc[SC_A] = good ? rz / pAp : 0.f;
    sc[SC_GOOD] = good ? 1.f : 0.f;
  }
}

// beta, the new residual norm and the best-iterate bookkeeping
__global__ void k_beta(const float* part_rz, const float* part_rr, int nb,
                       float* sc) {
  if (dead(sc + SC_LIVE)) return;
  __shared__ float sh[RED_TPB];
  const float rz_new = sum_parts(part_rz, nb, sh);
  const float rr_new = sum_parts(part_rr, nb, sh);
  if (threadIdx.x == 0) {
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
}

// first chunk: rr = r.r, rz = r.z0, stop = tol^2 rr, fresh bookkeeping
__global__ void k_prime(const float* part_rz, const float* part_rr, int nb,
                        float* sc, float tol) {
  __shared__ float sh[RED_TPB];
  const float rz = sum_parts(part_rz, nb, sh);
  const float rr = sum_parts(part_rr, nb, sh);
  if (threadIdx.x == 0) {
    for (int k = 0; k < SC_LEN; ++k) sc[k] = 0.f;
    sc[SC_RR] = rr;
    sc[SC_RZ] = rz;
    sc[SC_RRB] = rr;
    sc[SC_OK] = 1.f;
    sc[SC_STOP] = tol * tol * rr;
  }
}

// ------------------------------------------------------------ host side

struct Levels {
  int L = 0;          // number of levels
  int lc = 0;         // first level run by k_coarse (L if none)
  int ms[MAX_LEVELS];
  long long woff[MAX_LEVELS];   // offset of level l in the flat w array
  float* b[MAX_LEVELS];
  float* x[MAX_LEVELS];
  float* t[MAX_LEVELS];
  float* Ap = nullptr;
  float* part = nullptr;        // 2 * nb0 block partials
  int nb0 = 0;
};

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

inline int nblocks(long long n) { return int((n + TPB - 1) / TPB); }

long long scratch_floats(int m) {
  int ms[MAX_LEVELS];
  const int L = levels_for(m, ms);
  long long n0 = (long long)m * m, total = n0 + 2LL * nblocks(n0);
  for (int l = 0; l < L; ++l) total += 3LL * ms[l] * ms[l];
  return total;
}

Levels make_levels(int m, float* scratch) {
  Levels lv;
  lv.L = levels_for(m, lv.ms);
  const long long n0 = (long long)m * m;
  lv.nb0 = nblocks(n0);
  float* s = scratch;
  lv.Ap = s;
  s += n0;
  lv.part = s;
  s += 2LL * lv.nb0;
  long long wo = 0;
  lv.lc = lv.L;
  for (int l = 0; l < lv.L; ++l) {
    const long long nl = (long long)lv.ms[l] * lv.ms[l];
    lv.woff[l] = wo;
    wo += nl;
    lv.b[l] = s;
    lv.x[l] = s + nl;
    lv.t[l] = s + 2 * nl;
    s += 3 * nl;
    if (lv.lc == lv.L && lv.ms[l] <= COARSE_MAX) lv.lc = l;
  }
  return lv;
}

#define CHECK_LAUNCH()                              \
  do {                                              \
    cudaError_t e_ = cudaGetLastError();            \
    if (e_ != cudaSuccess) return int(e_);          \
  } while (0)

// V-cycle of level l on lv.b[l]; *out receives the buffer holding x_l
int vcycle(const Levels& lv, int l, const float* w, float alpha,
           const float* gate, cudaStream_t st, const float** out) {
  const int m = lv.ms[l];
  const int n = m * m;
  const float* wl = w + lv.woff[l];
  if (l == lv.lc) {
    k_coarse<<<1, COARSE_TPB, 0, st>>>(lv.b[l], wl, lv.x[l], m, lv.L - l,
                                       alpha, gate);
    CHECK_LAUNCH();
    *out = lv.x[l];
    return 0;
  }
  if (l == lv.L - 1) {   // coarsest level too large for one block
    float *src = nullptr, *dst = lv.x[l], *other = lv.t[l];
    for (int s = 0; s < COARSE_SWEEPS; ++s) {
      k_smooth<<<nblocks(n), TPB, 0, st>>>(src, lv.b[l], wl, dst, alpha, m,
                                           gate);
      CHECK_LAUNCH();
      float* nd = (s == 0) ? other : src;
      src = dst;
      dst = nd;
    }
    *out = src;
    return 0;
  }
  const int mc = lv.ms[l + 1];
  k_smooth<<<nblocks(n), TPB, 0, st>>>(nullptr, lv.b[l], wl, lv.x[l], alpha,
                                       m, gate);
  CHECK_LAUNCH();
  k_residual<<<nblocks(n), TPB, 0, st>>>(lv.x[l], lv.b[l], wl, lv.t[l],
                                         alpha, m, gate);
  CHECK_LAUNCH();
  k_restrict<<<nblocks((long long)mc * mc), TPB, 0, st>>>(lv.t[l],
                                                          lv.b[l + 1], m,
                                                          gate);
  CHECK_LAUNCH();
  const float* e = nullptr;
  const int err = vcycle(lv, l + 1, w, alpha, gate, st, &e);
  if (err) return err;
  k_prolong_add<<<nblocks(n), TPB, 0, st>>>(e, lv.x[l], mc, gate);
  CHECK_LAUNCH();
  k_smooth<<<nblocks(n), TPB, 0, st>>>(lv.x[l], lv.b[l], wl, lv.t[l], alpha,
                                       m, gate);
  CHECK_LAUNCH();
  *out = lv.t[l];
  return 0;
}

}  // namespace

extern "C" {

long long mgf_scratch_floats(int m) { return scratch_floats(m); }

const char* mgf_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

// One chunk of `chunk` PCG iterations on device-resident state. first != 0
// primes the solve (p = z0 = pc(b), rr, rz, stop) before the iterations.
// sc: the SC_LEN-float state vector; sc[SC_LIVE] holds the loop condition
// after the chunk. Returns a cudaError_t code (0 on success).
int mgf_chunk(const float* B, const float* C, const float* w, float* x,
              float* r, float* p, float* xb, float* scratch, float* sc,
              int m, int chunk, int first, float alpha, float tol,
              float maxiter, float window, float guard, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Levels lv = make_levels(m, scratch);
  const int n = m * m, nb = lv.nb0;
  float* part_rz = lv.part;
  float* part_rr = lv.part + nb;
  const float* live = sc + SC_LIVE;
  const float* xv = nullptr;
  int err = 0;
  if (first) {
    k_scale<<<nb, TPB, 0, st>>>(r, B, w, lv.b[0], alpha, n, nullptr);
    CHECK_LAUNCH();
    if ((err = vcycle(lv, 0, w, alpha, nullptr, st, &xv))) return err;
    k_rz<<<nb, TPB, 0, st>>>(r, B, w, xv, part_rz, part_rr, alpha, n,
                             nullptr);
    CHECK_LAUNCH();
    k_prime<<<1, RED_TPB, 0, st>>>(part_rz, part_rr, nb, sc, tol);
    CHECK_LAUNCH();
    k_zout<<<nb, TPB, 0, st>>>(B, w, xv, p, alpha, n);
    CHECK_LAUNCH();
  }
  for (int k = 0; k < chunk; ++k) {
    k_begin<<<1, 1, 0, st>>>(sc, maxiter, window, guard);
    CHECK_LAUNCH();
    k_matvec<<<nb, TPB, 0, st>>>(B, C, p, lv.Ap, lv.part, alpha, m, live);
    CHECK_LAUNCH();
    k_alpha<<<1, RED_TPB, 0, st>>>(lv.part, nb, sc);
    CHECK_LAUNCH();
    k_axpy<<<nb, TPB, 0, st>>>(x, r, p, lv.Ap, B, w, lv.b[0], alpha, n, sc);
    CHECK_LAUNCH();
    if ((err = vcycle(lv, 0, w, alpha, live, st, &xv))) return err;
    k_rz<<<nb, TPB, 0, st>>>(r, B, w, xv, part_rz, part_rr, alpha, n, live);
    CHECK_LAUNCH();
    k_beta<<<1, RED_TPB, 0, st>>>(part_rz, part_rr, nb, sc);
    CHECK_LAUNCH();
    k_pupdate<<<nb, TPB, 0, st>>>(p, B, w, xv, x, xb, alpha, n, sc);
    CHECK_LAUNCH();
  }
  k_begin<<<1, 1, 0, st>>>(sc, maxiter, window, guard);
  CHECK_LAUNCH();
  return 0;
}

// The kernel's pieces launched alone, to hold each against its plain
// version. None of them is gated.
int mgf_matvec(const float* B, const float* C, const float* p, float* Ap,
               float* part, float alpha, int m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  k_matvec<<<nblocks((long long)m * m), TPB, 0, st>>>(B, C, p, Ap, part,
                                                      alpha, m, nullptr);
  CHECK_LAUNCH();
  return 0;
}

int mgf_restrict(const float* f, float* c, int m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mc = (m - 1) / 2 + 1;
  k_restrict<<<nblocks((long long)mc * mc), TPB, 0, st>>>(f, c, m, nullptr);
  CHECK_LAUNCH();
  return 0;
}

int mgf_prolong_add(const float* e, float* x, int mc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = 2 * (mc - 1) + 1;
  k_prolong_add<<<nblocks((long long)m * m), TPB, 0, st>>>(e, x, mc,
                                                           nullptr);
  CHECK_LAUNCH();
  return 0;
}

// z = sqf * V(sqf * r): one preconditioner application
int mgf_pc(const float* B, const float* w, const float* r, float* z,
           float* scratch, float alpha, int m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Levels lv = make_levels(m, scratch);
  const int n = m * m;
  k_scale<<<lv.nb0, TPB, 0, st>>>(r, B, w, lv.b[0], alpha, n, nullptr);
  CHECK_LAUNCH();
  const float* xv = nullptr;
  const int err = vcycle(lv, 0, w, alpha, nullptr, st, &xv);
  if (err) return err;
  k_zout<<<lv.nb0, TPB, 0, st>>>(B, w, xv, z, alpha, n);
  CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
