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
// becomes dcg_chunk below. The DIA operator is
//
//   y[i] = sum_d data[d, i] * x[i + off[d]],   zero outside [0, n),
//
// summed in offsets order, one rounding per product and per add: with
// -fmad=false this is bit for bit the plain version in ops/dia_spmv.py.
// The CG is the reference's identity-preconditioned CG on a pre-scaled
// operator (the caller folds the Jacobi scaling into data):
//
//   K1  p' = r + beta p;  Ap = DIA(p');  per-block partials of p'.Ap
//   K2  x += a p';  r -= a Ap;           per-block partials of r.r
//
// What bounds these kernels on this card, and what the design does about
// it:
//
// * Memory bandwidth. A DIA row does 2 flops per diagonal against 4-8
//   bytes of data read, far below the H100's flop-per-byte balance, so the
//   time is the bytes moved. One thread per row: data[d, i] is read once,
//   coalesced (neighbouring threads on neighbouring i), and the x[i + off]
//   reads of a block's diagonals overlap, so all but the first come from
//   L1/L2. The SpMV is one pass over memory (the plain version makes one
//   read-modify-write pass per diagonal). K1 never stores p' before using
//   it: the p' values a row needs from its neighbours are recomputed from
//   r and p (the TPU kernel's halo recompute), so p' is written once and
//   read once, by K2. No tensor cores, no TMA: this is a 7-point stencil.
// * No halo limit. Bounds are explicit (no padding), and each block reads
//   whatever neighbours it needs through the cache, so any offset works.
//   The TPU kernel needs the halo inside one 512-row block and returns
//   None for wider offsets; this one has no such limit.
// * p' goes into the OTHER of two p buffers: neighbouring blocks still
//   read the old p. The host swaps the pair every iteration.
//
// Control flow, as in csrc/mgfused.cu. Scalars (a, beta, the best-iterate
// bookkeeping and the loop condition) stay on the device in a state vector
// `sc`, updated by single-block scalar kernels. Every kernel of an
// iteration returns at once when sc[LIVE] is 0, so a chunk of `chunk`
// queued iterations after the end is the identity; the host reads sc once
// per chunk. The best-iterate copy xb = x of an iteration that improved
// the residual is made by the next iteration's K1 (before its K2 moves x),
// or, when that iteration is dead, by k_flush at the end of the chunk.
//
// Determinism. Every dot product is two passes in a fixed order (a tree
// inside each block, then one block summing the block partials in a fixed
// strided order and a tree), with no float atomics; the plain version
// sums in the same order (ops/dia_cg.py ordered_sum), so kernel and plain
// version agree bit for bit and the result does not depend on the chunk.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC -o libdia.so dia.cu
// Plain C interface, loaded with ctypes (proximalgalerkin_torch/ops/
// dia_spmv.py and dia_cg.py).

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int TPB = 256;          // threads per block of the grid kernels
constexpr int RED_TPB = 1024;     // threads of the single-block reductions
constexpr int MAX_DIAGS = 64;     // la/dia.py host_build's max_diags

// slots of the device state vector (ops/dia_cg.py _SC_*)
enum {
  SC_IT = 0, SC_RR, SC_RRB, SC_IB, SC_OK, SC_STOP, SC_LIVE, SC_A, SC_GOOD,
  SC_BETA, SC_BETTER, SC_LEN = 16
};

struct Offsets {
  int nd;
  int off[MAX_DIAGS];
};

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny<double>() {
  return DBL_MIN;
}

template <typename T>
__device__ __forceinline__ bool dead(const T* sc) {
  return sc[SC_LIVE] < T(0.5);
}

// x[j]
template <typename T>
struct Plain {
  const T* x;
  __device__ __forceinline__ T operator()(long long j) const { return x[j]; }
};

// p'[j] = r[j] + beta p[j], recomputed wherever it is needed
template <typename T>
struct PUpdate {
  const T* r;
  const T* p;
  T beta;
  __device__ __forceinline__ T operator()(long long j) const {
    return r[j] + beta * p[j];
  }
};

// one DIA row: sum_d data[d, i] * v(i + off[d]) in offsets order, terms
// outside [0, n) left out
template <typename T, typename V>
__device__ __forceinline__ T dia_row(const T* data, const Offsets& o,
                                     long long n, long long i, const V& v) {
  T acc = T(0);
  for (int d = 0; d < o.nd; ++d) {
    const long long j = i + o.off[d];
    if (j >= 0 && j < n) acc = acc + data[d * n + i] * v(j);
  }
  return acc;
}

// fixed-order tree over the block; every thread of the block must call it
template <typename T>
__device__ T block_sum(T v, T* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      sh[threadIdx.x] = sh[threadIdx.x] + sh[threadIdx.x + s];
    __syncthreads();
  }
  const T out = sh[0];
  __syncthreads();
  return out;
}

template <typename T>
__device__ T sum_parts(const T* part, int nb, T* sh) {
  T acc = T(0);
  for (int k = threadIdx.x; k < nb; k += blockDim.x) acc = acc + part[k];
  return block_sum(acc, sh);
}

// the loop condition of the reference's fused_cg (ops/pallas_cg.py:253)
template <typename T>
__device__ T live_of(const T* sc, T maxiter, T window, T guard) {
  const T it = sc[SC_IT], stop = sc[SC_STOP];
  const bool stalled = (it - sc[SC_IB] > window) &&
                       (sc[SC_RRB] < guard * stop);
  const bool live = sc[SC_OK] > T(0.5) && !stalled && it < maxiter &&
                    sc[SC_RR] > stop;
  return live ? T(1) : T(0);
}

inline int nblocks(long long n) { return int((n + TPB - 1) / TPB); }

// ------------------------------------------------------- grid kernels

template <typename T>
__global__ void k_spmv(const T* data, Offsets o, const T* x, T* y,
                       long long n) {
  const long long i = (long long)blockIdx.x * TPB + threadIdx.x;
  if (i < n) y[i] = dia_row(data, o, n, i, Plain<T>{x});
}

// K1: p' = r + beta p into pn, Ap = DIA(p'), partials of p'.Ap; first the
// pending best-iterate copy of the previous iteration. beta comes from
// the state vector sc, or from beta_alone when sc is null (one launch
// outside a solve: no gate, no copy).
template <typename T>
__global__ void k_k1(const T* data, Offsets o, const T* r, const T* p,
                     T* pn, T* Ap, T* part, const T* x, T* xb, long long n,
                     const T* sc, T beta_alone) {
  if (sc != nullptr && dead(sc)) return;
  __shared__ T sh[TPB];
  const long long i = (long long)blockIdx.x * TPB + threadIdx.x;
  const PUpdate<T> pu{r, p, sc != nullptr ? sc[SC_BETA] : beta_alone};
  const bool copy = sc != nullptr && sc[SC_BETTER] > T(0.5);
  T contrib = T(0);
  if (i < n) {
    const T pi = pu(i);
    const T y = dia_row(data, o, n, i, pu);
    pn[i] = pi;
    Ap[i] = y;
    contrib = pi * y;
    if (copy) xb[i] = x[i];
  }
  const T s = block_sum(contrib, sh);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// K2: x += a p', r -= a Ap, partials of r.r; a from sc, or a_alone when
// sc is null
template <typename T>
__global__ void k_k2(T* x, T* r, const T* p, const T* Ap, T* part,
                     long long n, const T* sc, T a_alone) {
  if (sc != nullptr && dead(sc)) return;
  __shared__ T sh[TPB];
  const long long i = (long long)blockIdx.x * TPB + threadIdx.x;
  const T a = sc != nullptr ? sc[SC_A] : a_alone;
  T contrib = T(0);
  if (i < n) {
    x[i] = x[i] + a * p[i];
    const T rn = r[i] - a * Ap[i];
    r[i] = rn;
    contrib = rn * rn;
  }
  const T s = block_sum(contrib, sh);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// partials of r.r (priming)
template <typename T>
__global__ void k_sq(const T* r, T* part, long long n) {
  __shared__ T sh[TPB];
  const long long i = (long long)blockIdx.x * TPB + threadIdx.x;
  const T v = i < n ? r[i] * r[i] : T(0);
  const T s = block_sum(v, sh);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// the pending best-iterate copy, at the end of a chunk (not gated: it
// must land after the last live iteration)
template <typename T>
__global__ void k_flush(const T* x, T* xb, long long n, const T* sc) {
  if (sc[SC_BETTER] < T(0.5)) return;
  const long long i = (long long)blockIdx.x * TPB + threadIdx.x;
  if (i < n) xb[i] = x[i];
}

// ----------------------------------------------------- scalar kernels

// rr = b.b, stop = tol^2 rr, fresh bookkeeping, the first loop condition
template <typename T>
__global__ void k_prime(const T* part, int nb, T* sc, T tol, T maxiter,
                        T window, T guard) {
  __shared__ T sh[RED_TPB];
  const T rr = sum_parts(part, nb, sh);
  if (threadIdx.x == 0) {
    for (int k = 0; k < SC_LEN; ++k) sc[k] = T(0);
    sc[SC_RR] = rr;
    sc[SC_RRB] = rr;
    sc[SC_OK] = T(1);
    sc[SC_STOP] = tol * tol * rr;
    sc[SC_LIVE] = live_of(sc, maxiter, window, guard);
  }
}

// a = rr / p'.Ap, with the breakdown guard; the pending copy is done
template <typename T>
__global__ void k_alpha(const T* part, int nb, T* sc) {
  if (dead(sc)) return;
  __shared__ T sh[RED_TPB];
  const T pAp = sum_parts(part, nb, sh);
  if (threadIdx.x == 0) {
    const T rr = sc[SC_RR];
    const bool good = pAp > tiny<T>() && rr > tiny<T>();
    sc[SC_A] = good ? rr / pAp : T(0);
    sc[SC_GOOD] = good ? T(1) : T(0);
    sc[SC_BETTER] = T(0);
  }
}

// the new residual norm, beta of the next iteration, the best-iterate
// bookkeeping and the next loop condition
template <typename T>
__global__ void k_end(const T* part, int nb, T* sc, T maxiter, T window,
                      T guard) {
  if (dead(sc)) return;
  __shared__ T sh[RED_TPB];
  const T rr_new = sum_parts(part, nb, sh);
  if (threadIdx.x == 0) {
    const T it = sc[SC_IT], rr = sc[SC_RR];
    const bool better = rr_new < sc[SC_RRB];
    sc[SC_BETTER] = better ? T(1) : T(0);
    if (better) {
      sc[SC_RRB] = rr_new;
      sc[SC_IB] = it + T(1);
    }
    sc[SC_BETA] = rr_new / rr;
    sc[SC_RR] = rr_new;
    sc[SC_OK] = sc[SC_GOOD];
    sc[SC_IT] = it + T(1);
    sc[SC_LIVE] = live_of(sc, maxiter, window, guard);
  }
}

// ------------------------------------------------------------ host side

#define CHECK_LAUNCH()                              \
  do {                                              \
    cudaError_t e_ = cudaGetLastError();            \
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

template <typename T>
int chunk(const T* data, const int* offs, int nd, T* x, T* r, T* p0, T* p1,
          T* Ap, T* xb, T* part, T* sc, long long n, int nchunk, int first,
          int parity, T tol, T maxiter, T window, T guard, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Offsets o;
  int err = make_offsets(offs, nd, &o);
  if (err) return err;
  const int nb = nblocks(n);
  if (first) {
    k_sq<T><<<nb, TPB, 0, st>>>(r, part, n);
    CHECK_LAUNCH();
    k_prime<T><<<1, RED_TPB, 0, st>>>(part, nb, sc, tol, maxiter, window,
                                      guard);
    CHECK_LAUNCH();
  }
  for (int k = 0; k < nchunk; ++k) {
    const bool odd = ((parity + k) & 1) != 0;
    const T* p = odd ? p1 : p0;
    T* pn = odd ? p0 : p1;
    k_k1<T><<<nb, TPB, 0, st>>>(data, o, r, p, pn, Ap, part, x, xb, n, sc,
                                T(0));
    CHECK_LAUNCH();
    k_alpha<T><<<1, RED_TPB, 0, st>>>(part, nb, sc);
    CHECK_LAUNCH();
    k_k2<T><<<nb, TPB, 0, st>>>(x, r, pn, Ap, part, n, sc, T(0));
    CHECK_LAUNCH();
    k_end<T><<<1, RED_TPB, 0, st>>>(part, nb, sc, maxiter, window, guard);
    CHECK_LAUNCH();
  }
  k_flush<T><<<nb, TPB, 0, st>>>(x, xb, n, sc);
  CHECK_LAUNCH();
  return 0;
}

// K1 alone, with beta given
template <typename T>
int k1(const T* data, const int* offs, int nd, const T* r, const T* p,
       T* pn, T* Ap, T* part, T beta, long long n, void* stream) {
  Offsets o;
  int err = make_offsets(offs, nd, &o);
  if (err) return err;
  k_k1<T><<<nblocks(n), TPB, 0, static_cast<cudaStream_t>(stream)>>>(
      data, o, r, p, pn, Ap, part, nullptr, nullptr, n, nullptr, beta);
  CHECK_LAUNCH();
  return 0;
}

// K2 alone, with a given, in place on x and r
template <typename T>
int k2(T* x, T* r, const T* p, const T* Ap, T* part, T a, long long n,
       void* stream) {
  k_k2<T><<<nblocks(n), TPB, 0, static_cast<cudaStream_t>(stream)>>>(
      x, r, p, Ap, part, n, nullptr, a);
  CHECK_LAUNCH();
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

// One chunk of `nchunk` CG iterations on device-resident state. first != 0
// primes the solve (r holds b; x, xb, p0 and p1 hold zeros). parity: the
// number of iterations queued before this chunk, mod 2 (which p buffer is
// current). sc: the SC_LEN-value state vector; sc[SC_LIVE] holds the loop
// condition after the chunk. Returns a cudaError_t code (0 on success).
int dcg_chunk_f32(const float* data, const int* offs, int nd, float* x,
                  float* r, float* p0, float* p1, float* Ap, float* xb,
                  float* part, float* sc, long long n, int nchunk, int first,
                  int parity, float tol, float maxiter, float window,
                  float guard, void* stream) {
  return chunk<float>(data, offs, nd, x, r, p0, p1, Ap, xb, part, sc, n,
                      nchunk, first, parity, tol, maxiter, window, guard,
                      stream);
}

int dcg_chunk_f64(const double* data, const int* offs, int nd, double* x,
                  double* r, double* p0, double* p1, double* Ap, double* xb,
                  double* part, double* sc, long long n, int nchunk,
                  int first, int parity, double tol, double maxiter,
                  double window, double guard, void* stream) {
  return chunk<double>(data, offs, nd, x, r, p0, p1, Ap, xb, part, sc, n,
                       nchunk, first, parity, tol, maxiter, window, guard,
                       stream);
}

// K1 and K2 launched alone, to hold each against its plain version
int dcg_k1_f32(const float* data, const int* offs, int nd, const float* r,
               const float* p, float* pn, float* Ap, float* part,
               float beta, long long n, void* stream) {
  return k1<float>(data, offs, nd, r, p, pn, Ap, part, beta, n, stream);
}

int dcg_k1_f64(const double* data, const int* offs, int nd, const double* r,
               const double* p, double* pn, double* Ap, double* part,
               double beta, long long n, void* stream) {
  return k1<double>(data, offs, nd, r, p, pn, Ap, part, beta, n, stream);
}

int dcg_k2_f32(float* x, float* r, const float* p, const float* Ap,
               float* part, float a, long long n, void* stream) {
  return k2<float>(x, r, p, Ap, part, a, n, stream);
}

int dcg_k2_f64(double* x, double* r, const double* p, const double* Ap,
               double* part, double a, long long n, void* stream) {
  return k2<double>(x, r, p, Ap, part, a, n, stream);
}

}  // extern "C"
