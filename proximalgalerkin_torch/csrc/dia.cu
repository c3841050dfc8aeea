// DIA sparse matrix-vector product and the fused DIA-CG for NVIDIA Hopper
// (sm_90a), in f32 and f64.
//
// Replaces the TPU kernels of the JAX reference package:
//
//   ops/pallas_spmv.py:26  _dia_kernel  (dia_spmv_pallas)  -> k_spmv
//   ops/pallas_cg.py:118   k1_kernel    (make_fused_dia_cg) -> k_k1
//   ops/pallas_cg.py:151   k2_kernel    (same solve loop)   -> k_k2
//
// together with the solve loop fused_cg (ops/pallas_cg.py:241), which
// becomes the captured chunk below. The DIA operator is
//
//   y[i] = sum_d data[d, i] * x[i + off[d]],   zero outside [0, n),
//
// summed in offsets order, one rounding per product and per add: with
// -fmad=false this is bit for bit the plain version in ops/dia_spmv.py.
// The CG is the reference's identity-preconditioned CG on a pre-scaled
// operator (the caller folds the Jacobi scaling into data):
//
//   K1  p' = r + beta p;  Ap = DIA(p');  partials of p'.Ap;  a = rr / p'.Ap
//   K2  x += a p';  r -= a Ap;  partials of r.r;  beta, the bookkeeping
//       and the loop condition of the next iteration
//
// An iteration is these two launches. What bounds them on this card, and
// what the design does about it:
//
// * Memory bandwidth. A DIA row does 2 flops per diagonal against 4-8
//   bytes of data read, far below the H100's flop-per-byte balance, so the
//   least time is the bytes moved (K1: the diagonals, r and p read, p' and
//   Ap written; K2: x, p', r, Ap read, x and r written). To get near it a
//   kernel needs many independent 16-byte loads in flight and little else
//   to do:
//     - K1 keeps device memory busy while it computes. Its blocks are
//       as many as the card holds at once, and each works through bands
//       of four runs of 256 rows (bands blockIdx.x, + gridDim.x, ...),
//       thread t on row t of each run. What a band needs sits in a ring
//       of two shared-memory stages filled by asynchronous 16-byte
//       copies (cp.async: no registers, no thread waits for them): while
//       a block computes one band, the copies of its next are in flight.
//       A kernel whose blocks load, then compute, then reduce, leaves
//       the memory idle for the rest of a block's life, and the blocks
//       of a wave do so together.
//     - A stage holds the band's matrix rows and, for each cluster of
//       neighbouring offsets, r and p over the band shifted by the
//       cluster. The host finds the clusters (ops/dia_cg.py stage_plan:
//       the P1 stencil's (-m-1, -m), (-1, 0, 1), (m, m+1) give three).
//       p' = r + beta p is computed once over each segment, in place,
//       and a row's sum reads its neighbours there: one shared-memory
//       read per diagonal, stride one across the threads, instead of
//       two trips to the cache. Four rows a thread share the diagonal's
//       offset and address arithmetic: the kernel is bound by
//       instruction issue as much as by bytes. A diagonal outside every
//       cluster reads r and p through the cache, as every diagonal did
//       in this port's first DIA-CG; so any offsets work, and bounds
//       are explicit. The host also chooses the band and the ring's
//       depth (ops/dia_cg.py stage_plan): where the matrix rows of a
//       four-run band do not fit two stages (many diagonals), the band
//       is one run, in two stages or one.
//     - `data` lives in the solve's workspace with a row pitch that is a
//       multiple of 16 bytes: the matrix itself has n columns, n is odd
//       on the P1 meshes, and row d of a (ndiag, n) array starts at
//       d * n, which 16-byte copies cannot read.
//     - K2 is one pass of 16-byte loads and stores: blocks of 1,024
//       rows, four consecutive rows a thread.
//     - Nothing is copied that need not be. The best iterate is not
//       copied aside: x lives in three buffers, K2 writes x + a p' into
//       the one that holds neither the current nor the best iterate, and
//       the state vector says which is which.
// * Launch latency and host overhead. The dot products end in the kernel
//   that makes their partials: every block writes one partial per 256-row
//   run, and the block that arrives last at a device counter sums them
//   and does the scalar work (a, or beta, the best-iterate bookkeeping
//   and the loop condition), as in csrc/mgfused.cu. A block's tail is
//   short: one barrier and warp shuffles for the run sums, one barrier
//   and shuffles for the last block's sum. A whole chunk of iterations
//   is captured once as a CUDA graph on a private stream and replayed on
//   the caller's: one host call and one host read per chunk. Nothing a
//   captured kernel sees changes between chunks or solves: the matrix,
//   the vectors, the partials and the state vector `sc` (with tol,
//   maxiter, the stall window and guard) sit in a workspace, and the two
//   p buffers swap by the parity of the device's iteration count.
//
// Control flow. Every kernel of an iteration returns at once when
// sc[LIVE] is 0, so iterations queued after the end are the identity; the
// host reads sc once per chunk.
//
// Determinism. Every dot product is two passes in a fixed order, with no
// float atomics: the halving tree sh[t] + sh[t + s] over each run of 256
// rows in index order (its levels are an exchange between two warps,
// shuffles, and a thread's own four values, pairing the same entries),
// then the partials as 1,024 strided running sums in order and the same
// tree over those. The plain version sums in the same order
// (ops/dia_cg.py ordered_sum), so kernel and plain version agree bit for
// bit and the result does not depend on the chunk, the band or the
// workspace.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC -o libdia.so dia.cu
// Plain C interface, loaded with ctypes (proximalgalerkin_torch/ops/
// dia_spmv.py and dia_cg.py).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int TPB = 256;          // threads per block, every kernel
constexpr int RUN = 256;          // rows of one partial sum
constexpr int BK = 4;             // runs of a K2 or priming block
constexpr int BAND = BK * RUN;    // its rows
constexpr int RPT = BAND / TPB;   // consecutive rows of one of its threads,
                                  // and the values of a 16-byte f32 copy
constexpr int RED = 1024;         // strided lanes of the last block's sum
constexpr int LANES = RED / TPB;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DIAGS = 64;     // la/dia.py host_build's max_diags
constexpr int MAX_CLUSTERS = 8;   // staged segments (ops/dia_cg.py)

// a block's sum buffer: the contributions of the band's upper warps, then
// the last block's TPB lane sums
constexpr int PROD = BAND;

static_assert(RPT == 4, "16 bytes of f32: four consecutive rows");
static_assert(RUN == 64 * RPT, "two warps hold a run");
static_assert(LANES == 4 && TPB == 256, "sum_parts pairs four lanes a thread");

// slots of the device state vector (ops/dia_cg.py _SC_*). Slots below
// SC_STATE are the solve's state, zeroed when it is primed; the others
// are its parameters, written by the host before the first chunk.
enum {
  SC_IT = 0, SC_RR, SC_RRB, SC_IB, SC_OK, SC_STOP, SC_LIVE, SC_A, SC_GOOD,
  SC_BETA, SC_CUR, SC_BEST, SC_STATE,
  SC_TOL = 16, SC_MAXIT, SC_WINDOW, SC_GUARD, SC_LEN = 32
};

struct Offsets {
  int nd;
  int off[MAX_DIAGS];
};

// K1's staging plan (ops/dia_cg.py stage_plan). K1 works through bands of
// bk runs; a stage of its shared-memory ring holds, for one band, the nd
// matrix rows and r and p over each staged segment (p' over r once it is
// computed). Segment c holds rows [band start + start[c], + len[c]) from
// rawbase[c] on; start and len are multiples of RPT. Thread t finds p' at
// the neighbour on diagonal d of its row in run q at at[d] + t + q RUN,
// or reads r and p through the cache when at[d] < 0, and its rows' own p'
// at centre + t + q RUN when the main diagonal is staged (centre >= 0).
struct Plan {
  int nd, nc;
  int raw;      // staged rows of all segments
  int centre;
  int stages;   // stages of the ring
  int bk;       // runs of a band: 4 or 1
  int lo, hi;   // the least and the greatest offset
  int off[MAX_DIAGS];
  int at[MAX_DIAGS];
  int start[MAX_CLUSTERS];
  int len[MAX_CLUSTERS];
  int rawbase[MAX_CLUSTERS];
};

// values of one stage: the matrix rows, then r, then p
__host__ __device__ inline int stage_values(const Plan& pl) {
  return pl.nd * pl.bk * RUN + 2 * pl.raw;
}

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny<double>() {
  return DBL_MIN;
}

template <typename T>
__device__ __forceinline__ bool dead(const T* sc) {
  return sc[SC_LIVE] < T(0.5);
}

template <typename T>
__device__ __forceinline__ int odd_iteration(const T* sc) {
  return int(sc[SC_IT]) & 1;
}

// four consecutive values at a 16-byte aligned address
__device__ __forceinline__ void load4(const float* p, float (&v)[RPT]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[RPT]) {
  const double2* q = reinterpret_cast<const double2*>(p);
  const double2 a = q[0], b = q[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// four consecutive values from device to shared memory, asynchronously;
// both addresses 16-byte aligned
template <typename T>
__device__ __forceinline__ void async4(T* dst, const T* src) {
#pragma unroll
  for (int b = 0; b < int(RPT * sizeof(T)); b += 16)
    __pipeline_memcpy_async(reinterpret_cast<char*>(dst) + b,
                            reinterpret_cast<const char*>(src) + b, 16);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[RPT]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double (&v)[RPT]) {
  double2* q = reinterpret_cast<double2*>(p);
  q[0] = make_double2(v[0], v[1]);
  q[1] = make_double2(v[2], v[3]);
}

// one DIA row of the SpMV: sum_d data[d, i] * x[i + off[d]] in offsets
// order, terms outside [0, n) left out
template <typename T>
__device__ __forceinline__ T dia_row(const T* data, const Offsets& o,
                                     long long n, long long i, const T* x) {
  T acc = T(0);
  for (int d = 0; d < o.nd; ++d) {
    const long long j = i + o.off[d];
    if (j >= 0 && j < n) acc = acc + data[d * n + i] * x[j];
  }
  return acc;
}

// After the block's threads stored its partials: returns, in every
// thread, whether this block arrived last of nblk. The barrier orders the
// block's stores before thread 0's fence, and the fence before the
// counter. The last block then reads every partial, and resets the
// counter for the next launch.
__device__ bool arrive(unsigned* cnt, int nblk) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(cnt, 1u) == unsigned(nblk - 1);
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The halving tree sh[t] + sh[t + s], s = 128 ... 1, over 256 values, by
// the 32 lanes of one warp (every lane must call it): levels 128 to 32
// pair values 32 apart, which a lane reads back and sums itself; the last
// five are shuffles, which pair the same entries. The sum is valid in
// lane 0.
template <typename T>
__device__ __forceinline__ T tree_256(const T* sh, int lane) {
  T e[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) e[k] = sh[lane + 32 * k];
#pragma unroll
  for (int k = 0; k < 4; ++k) e[k] = e[k] + e[k + 4];
  T h = (e[0] + e[2]) + (e[1] + e[3]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) h = h + __shfl_down_sync(FULL, h, d);
  return h;
}

// The last block's sum of nb partials, in the order of a 1,024-thread
// block: RED lanes each sum a strided run in order, then the halving tree
// over the lanes. Thread t keeps lanes t, t + 256, t + 512, t + 768 and
// loads their partials a whole stride at a time, so that the loads are in
// flight together. The tree's levels 512 and 256 pair lanes of one
// thread; the rest is tree_256 by warp 0. sh holds TPB values. The sum is
// valid in thread 0 only.
template <typename T>
__device__ T sum_parts(const T* part, int nb, T* sh) {
  const int t = threadIdx.x;
  T acc[LANES];
#pragma unroll
  for (int l = 0; l < LANES; ++l) acc[l] = T(0);
#pragma unroll 4
  for (int base = 0; base < nb; base += RED) {
    T v[LANES];
#pragma unroll
    for (int l = 0; l < LANES; ++l) {
      const int k = base + l * TPB + t;
      v[l] = k < nb ? __ldcg(part + k) : T(0);
    }
#pragma unroll
    for (int l = 0; l < LANES; ++l)
      if (base + l * TPB + t < nb) acc[l] = acc[l] + v[l];
  }
  sh[t] = (acc[0] + acc[2]) + (acc[1] + acc[3]);
  __syncthreads();
  return t < 32 ? tree_256(sh, t) : T(0);
}

// The band's run sums from each thread's four contributions, one partial
// per run; true in the block that arrived last. The halving tree
// sh[t] + sh[t + s] over a run's 256 rows, held four a thread by two
// warps: level 128 pairs the warps (through prod), levels 64 to 4 pair
// lanes 16 to 1 apart, levels 2 and 1 a thread's own values. prod holds
// PROD values.
template <typename T>
__device__ bool band_partials(T (&v)[RPT], T* prod, T* part, long long n,
                              unsigned* cnt) {
  const int t = threadIdx.x, w = t >> 5;
  const long long s0 = (long long)blockIdx.x * BAND;
  if (w & 1) store4(prod + RPT * (t - 32), v);
  __syncthreads();
  if (!(w & 1)) {
    T o[RPT];
    load4(prod + RPT * t, o);
#pragma unroll
    for (int q = 0; q < RPT; ++q) v[q] = v[q] + o[q];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        v[q] = v[q] + __shfl_down_sync(FULL, v[q], d);
    }
    const T sum = (v[0] + v[2]) + (v[1] + v[3]);
    const int c = w >> 1;
    if ((t & 31) == 0 && s0 + c * RUN < n) part[blockIdx.x * BK + c] = sum;
  }
  return arrive(cnt, gridDim.x);
}

// the loop condition of the reference's fused_cg (ops/pallas_cg.py:253)
template <typename T>
__device__ T live_of(const T* sc) {
  const T it = sc[SC_IT], stop = sc[SC_STOP];
  const bool stalled = (it - sc[SC_IB] > sc[SC_WINDOW]) &&
                       (sc[SC_RRB] < sc[SC_GUARD] * stop);
  const bool live = sc[SC_OK] > T(0.5) && !stalled && it < sc[SC_MAXIT] &&
                    sc[SC_RR] > stop;
  return live ? T(1) : T(0);
}

inline int nblocks(long long n) { return int((n + TPB - 1) / TPB); }
inline int nbands(long long n) { return int((n + BAND - 1) / BAND); }
// partial sums of n rows: one per run
__device__ __forceinline__ int nruns(long long n) {
  return int((n + RUN - 1) / RUN);
}

// ------------------------------------------------------- grid kernels

template <typename T>
__global__ void k_spmv(const T* data, Offsets o, const T* x, T* y,
                       long long n) {
  const long long i = (long long)blockIdx.x * TPB + threadIdx.x;
  if (i < n) y[i] = dia_row(data, o, n, i, x);
}

// The segment that holds staged row k (counted through all segments).
__device__ __forceinline__ int segment_of(const Plan& pl, int k) {
  int c = 0;
  while (c + 1 < pl.nc && k >= pl.rawbase[c + 1]) ++c;
  return c;
}

// One stage of K1's ring for the band starting at row s0: 16-byte
// asynchronous copies of the band's matrix rows and of r and p over every
// segment, clipped to the matrix. Every thread commits one group of
// copies.
template <typename T, int NB>
__device__ __forceinline__ void issue_stage(T* st, const Plan& pl,
                                            const T* data, long long pitch,
                                            const T* r, const T* p,
                                            long long n, long long s0) {
  constexpr int BAND = NB * RUN;
  const int t = threadIdx.x;
  for (int k = RPT * t; k < BAND; k += RPT * TPB) {
    if (s0 + k >= n) break;
    const T* src = data + s0 + k;
    T* dst = st + k;
    for (int d = 0; d < pl.nd; ++d, src += pitch, dst += BAND)
      async4(dst, src);
  }
  T* sr = st + pl.nd * BAND;
  T* sp = sr + pl.raw;
  for (int g = RPT * t; g < pl.raw; g += RPT * TPB) {
    const int c = segment_of(pl, g);
    const long long j = s0 + pl.start[c] + (g - pl.rawbase[c]);
    if (j >= 0 && j < n) {
      async4(sr + g, r + j);
      async4(sp + g, p + j);
    }
  }
  __pipeline_commit();
}

// K1: p' = r + beta p into the other p buffer, Ap = DIA(p'), partials of
// p'.Ap. The last block sets a = rr / p'.Ap with the breakdown guard.
// A block takes bands of NB runs (blockIdx.x, + gridDim.x, ...), thread t
// row t of each run, and keeps the copies of the next pl.stages - 1
// bands in flight while it works on one. Dynamic shared memory:
// NB * TPB + pl.stages * stage_values.
template <typename T, int NB>
__global__ void __launch_bounds__(TPB)
k_k1(const T* __restrict__ data, long long pitch, Plan pl, const T* r,
     T* pa, T* pb, T* __restrict__ Ap, T* part, long long n, T* sc,
     unsigned* cnt) {
  if (dead(sc)) return;
  constexpr int BAND = NB * RUN;
  extern __shared__ __align__(16) unsigned char dyn[];
  T* red = reinterpret_cast<T*>(dyn);
  T* ring = red + NB * TPB;
  const int t = threadIdx.x, sv = stage_values(pl);
  const long long nbnd = (n + BAND - 1) / BAND;
  const T beta = sc[SC_BETA];
  const int odd = odd_iteration(sc);
  const T* p = odd ? pb : pa;
  T* pn = odd ? pa : pb;

  for (int k = 0; k < pl.stages - 1; ++k) {
    const long long band = blockIdx.x + (long long)k * gridDim.x;
    if (band < nbnd)
      issue_stage<T, NB>(ring + k * sv, pl, data, pitch, r, p, n,
                         band * BAND);
    else
      __pipeline_commit();
  }
  int k = 0;
  for (long long band = blockIdx.x; band < nbnd; band += gridDim.x, ++k) {
    // the ring slot freed by the band before takes the band stages - 1 on
    const long long ahead = band + (long long)(pl.stages - 1) * gridDim.x;
    if (ahead < nbnd)
      issue_stage<T, NB>(ring + (k + pl.stages - 1) % pl.stages * sv, pl,
                         data, pitch, r, p, n, ahead * BAND);
    else
      __pipeline_commit();
    if (pl.stages == 1) __pipeline_wait_prior(0);
    else __pipeline_wait_prior(1);
    __syncthreads();

    T* st = ring + k % pl.stages * sv;
    T* sr = st + pl.nd * BAND;    // r, then p' = r + beta p, in place
    const long long s0 = band * BAND, i0 = s0 + t;
    for (int g = RPT * t; g < pl.raw; g += RPT * TPB) {
      const int c = segment_of(pl, g);
      const long long j = s0 + pl.start[c] + (g - pl.rawbase[c]);
      if (j >= 0 && j < n) {
        T rv[RPT], pv[RPT];
        load4(sr + g, rv);
        load4(sr + pl.raw + g, pv);
#pragma unroll
        for (int q = 0; q < RPT; ++q) rv[q] = rv[q] + beta * pv[q];
        store4(sr + g, rv);
      }
    }
    __syncthreads();

    // row i0 + q RUN of the band, for each of its runs q
    T acc[NB];
#pragma unroll
    for (int q = 0; q < NB; ++q) acc[q] = T(0);
    if (s0 + pl.lo >= 0 && s0 + BAND + pl.hi <= n) {
      // every neighbour of every row of the band lies in the matrix
      for (int d = 0; d < pl.nd; ++d) {
        const T* dr = st + d * BAND + t;
        const int a = pl.at[d];
        if (a >= 0) {
          const T* pr = sr + a + t;
#pragma unroll
          for (int q = 0; q < NB; ++q)
            acc[q] = acc[q] + dr[q * RUN] * pr[q * RUN];
        } else {
          const long long j = i0 + pl.off[d];
#pragma unroll
          for (int q = 0; q < NB; ++q)
            acc[q] = acc[q] +
                     dr[q * RUN] * (r[j + q * RUN] + beta * p[j + q * RUN]);
        }
      }
    } else {
      for (int d = 0; d < pl.nd; ++d) {
        const T* dr = st + d * BAND + t;
        const int a = pl.at[d];
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          const long long j = i0 + q * RUN + pl.off[d];
          if (i0 + q * RUN < n && j >= 0 && j < n) {
            const T v = a >= 0 ? sr[a + t + q * RUN] : r[j] + beta * p[j];
            acc[q] = acc[q] + dr[q * RUN] * v;
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const long long i = i0 + q * RUN;
      T contrib = T(0);
      if (i < n) {
        // the row's own p': staged with the main diagonal, or recomputed
        const T pi = pl.centre >= 0 ? sr[pl.centre + t + q * RUN]
                                    : r[i] + beta * p[i];
        pn[i] = pi;
        Ap[i] = acc[q];
        contrib = pi * acc[q];
      }
      red[q * RUN + t] = contrib;
    }
    __syncthreads();
    // each run's halving tree by one warp
    if (t < 32 * NB) {
      const int w = t >> 5;
      const T sum = tree_256(red + w * RUN, t & 31);
      if ((t & 31) == 0 && s0 + w * RUN < n) part[band * NB + w] = sum;
    }
  }
  if (arrive(cnt, gridDim.x)) {
    const T pAp = sum_parts(part, nruns(n), red);
    if (t == 0) {
      const T rr = sc[SC_RR];
      const bool good = pAp > tiny<T>() && rr > tiny<T>();
      sc[SC_A] = good ? rr / pAp : T(0);
      sc[SC_GOOD] = good ? T(1) : T(0);
      *cnt = 0u;
    }
  }
}

// The x buffer K2 writes: the one of three that holds neither the
// current iterate nor the best one.
__device__ __forceinline__ int next_x(int cur, int best) {
  return cur == best ? (cur + 1) % 3 : 3 - cur - best;
}

// K2: x' = x + a p' into the free x buffer, r -= a Ap, partials of r.r.
// The last block: the new residual norm, beta of the next iteration, the
// best-iterate bookkeeping (x' becomes the current iterate and, when its
// residual is the smallest so far, the best one) and the next loop
// condition. xs: the three x buffers, npad values apart.
template <typename T>
__global__ void __launch_bounds__(TPB)
k_k2(T* xs, long long npad, T* __restrict__ r, const T* pa, const T* pb,
     const T* __restrict__ Ap, T* part, long long n, T* sc, unsigned* cnt) {
  if (dead(sc)) return;
  __shared__ __align__(16) T prod[PROD];
  const T a = sc[SC_A];
  const int cur = int(sc[SC_CUR]), nxt = next_x(cur, int(sc[SC_BEST]));
  const T* __restrict__ x = xs + cur * npad;
  T* __restrict__ xn = xs + nxt * npad;
  const T* __restrict__ pn = odd_iteration(sc) ? pa : pb;   // K1's p'
  const long long i0 = (long long)blockIdx.x * BAND + RPT * threadIdx.x;
  T contrib[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) contrib[q] = T(0);
  if (i0 < n) {
    T xv[RPT], pv[RPT], rv[RPT], av[RPT];
    load4(x + i0, xv);
    load4(pn + i0, pv);
    load4(r + i0, rv);
    load4(Ap + i0, av);
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      if (i0 + q < n) {
        xv[q] = xv[q] + a * pv[q];
        rv[q] = rv[q] - a * av[q];
        contrib[q] = rv[q] * rv[q];
      }
    }
    store4(xn + i0, xv);
    store4(r + i0, rv);
  }
  if (band_partials(contrib, prod, part, n, cnt)) {
    const T rr_new = sum_parts(part, nruns(n), prod);
    if (threadIdx.x == 0) {
      const T it = sc[SC_IT], rr = sc[SC_RR];
      if (rr_new < sc[SC_RRB]) {
        sc[SC_RRB] = rr_new;
        sc[SC_IB] = it + T(1);
        sc[SC_BEST] = T(nxt);
      }
      sc[SC_CUR] = T(nxt);
      sc[SC_BETA] = rr_new / rr;
      sc[SC_RR] = rr_new;
      sc[SC_OK] = sc[SC_GOOD];
      sc[SC_IT] = it + T(1);
      sc[SC_LIVE] = live_of(sc);
      *cnt = 0u;
    }
  }
}

// Priming: partials of b.b (b in r). The last block: rr = b.b,
// stop = tol^2 rr, fresh bookkeeping (x buffer 0, zeroed, is the current
// and the best iterate), the first loop condition.
template <typename T>
__global__ void __launch_bounds__(TPB)
k_prime(const T* __restrict__ r, T* part, long long n, T* sc,
        unsigned* cnt) {
  __shared__ __align__(16) T prod[PROD];
  const long long i0 = (long long)blockIdx.x * BAND + RPT * threadIdx.x;
  T contrib[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) contrib[q] = T(0);
  if (i0 < n) {
    T rv[RPT];
    load4(r + i0, rv);
#pragma unroll
    for (int q = 0; q < RPT; ++q)
      if (i0 + q < n) contrib[q] = rv[q] * rv[q];
  }
  if (band_partials(contrib, prod, part, n, cnt)) {
    const T rr = sum_parts(part, nruns(n), prod);
    if (threadIdx.x == 0) {
      for (int k = 0; k < SC_STATE; ++k) sc[k] = T(0);
      sc[SC_RR] = rr;
      sc[SC_RRB] = rr;
      sc[SC_OK] = T(1);
      const T tol = sc[SC_TOL];
      sc[SC_STOP] = tol * tol * rr;
      sc[SC_LIVE] = live_of(sc);
      *cnt = 0u;
    }
  }
}

// ------------------------------------------------------------ host side

#define CHECK_LAUNCH()                              \
  do {                                              \
    cudaError_t e_ = cudaGetLastError();            \
    if (e_ != cudaSuccess) return int(e_);          \
  } while (0)

#define CHECK_CUDA(call)                            \
  do {                                              \
    cudaError_t e_ = (call);                        \
    if (e_ != cudaSuccess) return int(e_);          \
  } while (0)

int make_offsets(const int* offs, int nd, Offsets* o) {
  if (nd < 1 || nd > MAX_DIAGS) return int(cudaErrorInvalidValue);
  o->nd = nd;
  for (int d = 0; d < nd; ++d) o->off[d] = offs[d];
  return 0;
}

template <typename T>
int spmv(const T* data, const int* offs, int nd, const T* x, T* y,
         long long n, void* stream) {
  Offsets o;
  int err = make_offsets(offs, nd, &o);
  if (err) return err;
  if (n == 0) return 0;
  k_spmv<T><<<nblocks(n), TPB, 0, static_cast<cudaStream_t>(stream)>>>(
      data, o, x, y, n);
  CHECK_LAUNCH();
  return 0;
}

// The DIA-CG workspace: the pointers every captured kernel sees. The
// seven vectors lie one after another from vec, npad values each (three x
// buffers, r, p0, p1, Ap); data has nd rows of `pitch` values.
constexpr int NVEC = 7;

struct Ws {
  int f64 = 0;
  long long n = 0, pitch = 0, npad = 0;
  int k1_grid = 0;   // K1's blocks: what the card holds at once
  Plan plan;
  void *data = nullptr, *vec = nullptr, *part = nullptr, *sc = nullptr;
  unsigned* cnt = nullptr;
  cudaStream_t cap = nullptr;   // private stream, used only for capture
};

template <typename T>
struct View {
  T *data, *xs, *r, *p0, *p1, *Ap, *part, *sc;
  explicit View(const Ws& ws)
      : data(static_cast<T*>(ws.data)), xs(static_cast<T*>(ws.vec)),
        r(xs + 3 * ws.npad), p0(xs + 4 * ws.npad), p1(xs + 5 * ws.npad),
        Ap(xs + 6 * ws.npad), part(static_cast<T*>(ws.part)),
        sc(static_cast<T*>(ws.sc)) {}
};

template <typename T>
size_t k1_smem(const Plan& pl) {
  return (size_t(pl.bk) * TPB + size_t(pl.stages) * stage_values(pl)) *
         sizeof(T);
}

// K1 for the workspace's band of four runs or one
template <typename T>
auto k1_kernel(const Plan& pl) {
  return pl.bk == 4 ? k_k1<T, 4> : k_k1<T, 1>;
}

template <typename T>
int launch_k1(const Ws& ws, cudaStream_t st) {
  const View<T> v(ws);
  k1_kernel<T>(ws.plan)<<<ws.k1_grid, TPB, k1_smem<T>(ws.plan), st>>>(
      v.data, ws.pitch, ws.plan, v.r, v.p0, v.p1, v.Ap, v.part, ws.n, v.sc,
      ws.cnt);
  CHECK_LAUNCH();
  return 0;
}

// K1's grid: as many blocks as the card holds at once with the plan's
// shared memory (the card refuses a plan that asks for more than a block
// may have), each taking every k1_grid-th band.
template <typename T>
cudaError_t plan_k1(Ws& ws) {
  const Plan& pl = ws.plan;
  const size_t smem = k1_smem<T>(pl);
  auto kernel = k1_kernel<T>(pl);
  // the attribute belongs to the kernel, which workspaces of other plans
  // share: it is set to the most the card allows a block beside the
  // kernel's static shared memory, not to this plan's size
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  const size_t most = size_t(optin) - attr.sharedSizeBytes;
  if (smem > most) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(most));
  // without this the card may keep a smaller carve-out and hold fewer
  // blocks an SM than the occupancy below says
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TPB,
                                                      smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const long long band = (long long)pl.bk * RUN;
  const long long bands = (ws.n + band - 1) / band;
  const long long grid = (long long)sms * per_sm;
  ws.k1_grid = int(grid < bands ? grid : bands);
  return cudaSuccess;
}

template <typename T>
int launch_k2(const Ws& ws, cudaStream_t st) {
  const View<T> v(ws);
  k_k2<T><<<nbands(ws.n), TPB, 0, st>>>(v.xs, ws.npad, v.r, v.p0, v.p1, v.Ap,
                                       v.part, ws.n, v.sc, ws.cnt);
  CHECK_LAUNCH();
  return 0;
}

// One chunk: with first, zero x buffer 0 and the p buffers and prime (r
// holds b), then `chunk` iterations.
template <typename T>
int enqueue_chunk(const Ws& ws, int chunk, int first, cudaStream_t st) {
  const View<T> v(ws);
  if (first) {
    T* const zeroed[] = {v.xs, v.p0, v.p1};
    for (T* z : zeroed)
      CHECK_CUDA(cudaMemsetAsync(z, 0, ws.npad * sizeof(T), st));
    CHECK_CUDA(cudaMemsetAsync(ws.cnt, 0, sizeof(unsigned), st));
    k_prime<T><<<nbands(ws.n), TPB, 0, st>>>(v.r, v.part, ws.n, v.sc,
                                             ws.cnt);
    CHECK_LAUNCH();
  }
  for (int k = 0; k < chunk; ++k) {
    if (int err = launch_k1<T>(ws, st)) return err;
    if (int err = launch_k2<T>(ws, st)) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

const char* dia_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

int dia_spmv_f32(const float* data, const int* offs, int nd, const float* x,
                 float* y, long long n, void* stream) {
  return spmv<float>(data, offs, nd, x, y, n, stream);
}

int dia_spmv_f64(const double* data, const int* offs, int nd,
                 const double* x, double* y, long long n, void* stream) {
  return spmv<double>(data, offs, nd, x, y, n, stream);
}

// The DIA-CG workspace over the caller's buffers (ops/dia_cg.py lays them
// out): data (nd rows of pitch values), vec (NVEC vectors of npad values),
// part (one value per 256-row run), sc (SC_LEN values), cnt (one zeroed
// counter). pitch and npad are multiples of 16 bytes and >= n rounded up
// to four rows; data and vec start on 16 bytes. The plan: cl[d] the
// staged segment of diagonal d or -1, and nc segments (start, len) of a
// band of bk runs (4 or 1), in a ring of `stages` stages (2 or 1).
// Returns a handle, or null with *err set.
void* dcg_ws_create(int f64, long long n, long long pitch, long long npad,
                    int nd, const int* offs, const int* cl, int nc,
                    const int* start, const int* len, int bk, int stages,
                    void* data, void* vec, void* part, void* sc,
                    unsigned* cnt, int* err) {
  *err = int(cudaErrorInvalidValue);
  const size_t item = f64 ? 8 : 4;
  const long long n4 = (n + RPT - 1) / RPT * RPT;
  if (n < 1 || nd < 1 || nd > MAX_DIAGS || nc < 0 || nc > MAX_CLUSTERS)
    return nullptr;
  if ((bk != 4 && bk != 1) || (stages != 2 && stages != 1)) return nullptr;
  if (pitch < n4 || npad < n4 || pitch * item % 16 || npad * item % 16)
    return nullptr;
  if (reinterpret_cast<size_t>(data) % 16 ||
      reinterpret_cast<size_t>(vec) % 16)
    return nullptr;
  Ws* ws = new Ws;
  ws->f64 = f64;
  ws->n = n;
  ws->pitch = pitch;
  ws->npad = npad;
  ws->data = data;
  ws->vec = vec;
  ws->part = part;
  ws->sc = sc;
  ws->cnt = cnt;
  Plan& pl = ws->plan;
  pl.nd = nd;
  pl.nc = nc;
  pl.bk = bk;
  pl.stages = stages;
  pl.raw = 0;
  pl.centre = -1;
  bool ok = true;
  for (int c = 0; c < nc; ++c) {
    pl.start[c] = start[c];
    pl.len[c] = len[c];
    pl.rawbase[c] = pl.raw;
    ok = ok && start[c] % RPT == 0 && len[c] > 0 && len[c] % RPT == 0;
    if (ok) pl.raw += len[c];
  }
  pl.lo = pl.hi = offs[0];
  for (int d = 0; d < nd; ++d) {
    const int c = cl[d];
    pl.off[d] = offs[d];
    pl.at[d] = -1;
    pl.lo = offs[d] < pl.lo ? offs[d] : pl.lo;
    pl.hi = offs[d] > pl.hi ? offs[d] : pl.hi;
    if (c >= nc) ok = false;
    if (!ok || c < 0) continue;
    // every row of the band finds its neighbour inside the segment
    ok = offs[d] >= start[c] && bk * RUN + offs[d] <= start[c] + len[c];
    pl.at[d] = pl.rawbase[c] + offs[d] - start[c];
    if (offs[d] == 0) pl.centre = pl.at[d];
  }
  cudaError_t e = cudaErrorInvalidValue;
  if (ok) e = f64 ? plan_k1<double>(*ws) : plan_k1<float>(*ws);
  if (e == cudaSuccess)
    e = cudaStreamCreateWithFlags(&ws->cap, cudaStreamNonBlocking);
  if (e != cudaSuccess) {
    delete ws;
    *err = int(e);
    return nullptr;
  }
  *err = 0;
  return ws;
}

// K1's launch shape on this card: blocks, and bytes of dynamic shared
// memory a block.
void dcg_ws_info(void* h, int* grid, int* smem) {
  const Ws& ws = *static_cast<Ws*>(h);
  *grid = ws.k1_grid;
  *smem = int(ws.f64 ? k1_smem<double>(ws.plan) : k1_smem<float>(ws.plan));
}

void dcg_ws_destroy(void* h) {
  Ws* ws = static_cast<Ws*>(h);
  if (ws->cap) cudaStreamDestroy(ws->cap);
  delete ws;
}

// Captures one chunk of `chunk` CG iterations (see enqueue_chunk) on the
// workspace's private stream and instantiates it. first != 0 primes the
// solve: r holds b, sc its parameters. After a replay sc[SC_LIVE] holds
// the loop condition. Returns the executable graph, or null with *err set.
void* dcg_capture(void* h, int chunk, int first, int* err) {
  Ws* ws = static_cast<Ws*>(h);
  *err = 0;
  cudaError_t e = cudaStreamBeginCapture(ws->cap,
                                         cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) {
    *err = int(e);
    return nullptr;
  }
  int enq = ws->f64 ? enqueue_chunk<double>(*ws, chunk, first, ws->cap)
                    : enqueue_chunk<float>(*ws, chunk, first, ws->cap);
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

int dcg_launch(void* graph, void* stream) {
  return int(cudaGraphLaunch(static_cast<cudaGraphExec_t>(graph),
                             static_cast<cudaStream_t>(stream)));
}

void dcg_graph_destroy(void* graph) {
  cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(graph));
}

// K1 and K2 launched alone on the workspace's buffers, on the stream (not
// captured), to hold each against its plain version: the state they read
// (sc, r, p, x, Ap) is whatever the caller put there.
int dcg_k1(void* h, void* stream) {
  const Ws& ws = *static_cast<Ws*>(h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ws.f64 ? launch_k1<double>(ws, st) : launch_k1<float>(ws, st);
}

int dcg_k2(void* h, void* stream) {
  const Ws& ws = *static_cast<Ws*>(h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ws.f64 ? launch_k2<double>(ws, st) : launch_k2<float>(ws, st);
}

}  // extern "C"
