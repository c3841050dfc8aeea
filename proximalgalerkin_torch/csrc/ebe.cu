// Element-by-element product with element matrices for NVIDIA Hopper
// (sm_90a), f64:
//
//   y[gidx[c, i]] += sum_j A[c, i, j] * x[gidx[c, j]],
//
// A (ne, L, L) the cells' (or facets') element matrices in their natural
// layout, gidx (ne, L) int32 the local slots' positions in x and y. It is
// the Jacobian action of the distributed Newton with a Schwarz
// preconditioner (parallel/dofpart.py): the factor has the element
// matrices at the step's point, and the action reuses them in place of a
// jvp through the pointwise residual.
//
// It replaces no TPU kernel: the JAX reference package's action is
// jax.jvp of the extended residual under jit (its parallel/dofpart.py),
// which XLA fuses on the TPU; the port's jvp through torch.func ran as
// 1,342 device operations, 14.4 of its 16.8 ms in two cuBLAS gemv calls
// of the residual's einsums, at the benchmark's 224^2, 8-subdomain cell.
//
// What bounds it on this card, and what the design does about it:
//
// * Memory bandwidth. A row does L multiply-adds against 8 L bytes of A,
//   so the bytes are the bound: A once (224^2 cell: 100,352 cells, L = 6,
//   28.9 MB), the int32 gathers once (2.4 MB), x read and y written once
//   (2.4 MB each), about 36 MB, 10.8 us at 3.35 TB/s. To come near it:
//     - One thread a (cell, row). A block of TPB threads takes TPB
//       consecutive rows, whose TPB * L values of A are one contiguous
//       span: the block copies it into shared memory with consecutive
//       threads on consecutive 8-byte words (every load coalesced), and
//       each thread then reads its own row there.
//     - The block's cells' indices and the values of x they gather are
//       staged once, one slot a thread, so each x value is read from
//       device memory once a (cell, slot), not once a row; the L threads
//       of a cell read the staged values as a shared-memory broadcast.
// * Scatter conflicts. Rows of neighbouring cells add into the same y
//   entries (a P1 vertex sits in six triangles). Each row's sum is added
//   with one f64 atomicAdd, native on sm_90; with few cells a vertex,
//   they rarely wait on each other. The order of the adds into one y
//   entry varies from launch to launch, so y is not reproducible bit for
//   bit: it differs from the plain version (ops/ebe.py) at rounding
//   level, within 1e-13 relative at the cell's shapes.
// * Sums. A row sums over j in order, a product and an add each (built
//   with -fmad=false, as every kernel of the port).
//
// The caller zeroes y (or holds the values to add to). L is a runtime
// value of 1 to MAX_L; the wrapper checks it, the shapes, and that
// ne * L fits an int.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC -o libebe.so ebe.cu
// Plain C interface, loaded with ctypes (proximalgalerkin_torch/ops/ebe.py).

#include <cuda_runtime.h>

namespace {

constexpr int TPB = 128;          // threads (rows) a block
constexpr int MAX_L = 32;         // ops/ebe.py MAX_L
// the cells a block's rows touch: at most TPB rows plus a partial cell at
// each end
constexpr int MAX_SLOTS = TPB + 2 * MAX_L;

__global__ void __launch_bounds__(TPB)
k_ebe_apply(const double* __restrict__ A, const int* __restrict__ gidx,
            const double* __restrict__ x, double* __restrict__ y, int ne,
            int L) {
  extern __shared__ double sa[];             // TPB * L values of A
  __shared__ double sx[MAX_SLOTS];
  __shared__ int sg[MAX_SLOTS];
  const int rows = ne * L;
  const int r0 = blockIdx.x * TPB;
  const int nr = min(TPB, rows - r0);
  const int t = threadIdx.x;

  const double* src = A + (long long)r0 * L;
  for (int k = t; k < nr * L; k += TPB) sa[k] = src[k];
  const int c0 = r0 / L;
  const int nslot = ((r0 + nr - 1) / L - c0 + 1) * L;
  const int* gsrc = gidx + (long long)c0 * L;
  for (int k = t; k < nslot; k += TPB) {
    const int g = gsrc[k];
    sg[k] = g;
    sx[k] = x[g];
  }
  __syncthreads();
  if (t >= nr) return;

  const int r = r0 + t;
  const int base = (r / L - c0) * L;
  const double* a = sa + t * L;
  const double* xs = sx + base;
  double s = 0.0;
  for (int j = 0; j < L; ++j) s += a[j] * xs[j];
  atomicAdd(y + sg[base + (r - (r / L) * L)], s);
}

}  // namespace

extern "C" {

const char* ebe_error_string(int err) {
  return cudaGetErrorString(cudaError_t(err));
}

// y += the element-by-element product of A (ne, L, L) with x gathered
// and scattered through gidx (ne, L), on the stream; 0 or a CUDA error.
int ebe_apply_f64(const double* A, const int* gidx, const double* x,
                  double* y, int ne, int L, void* stream) {
  if (L < 1 || L > MAX_L || ne < 0) return int(cudaErrorInvalidValue);
  if (ne == 0) return 0;
  const int rows = ne * L;
  const int blocks = (rows + TPB - 1) / TPB;
  k_ebe_apply<<<blocks, TPB, TPB * L * sizeof(double),
                static_cast<cudaStream_t>(stream)>>>(A, gidx, x, y, ne, L);
  return int(cudaGetLastError());
}

}  // extern "C"
