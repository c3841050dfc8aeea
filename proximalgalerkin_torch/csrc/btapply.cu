// Block-Thomas forward and back substitution for NVIDIA Hopper (sm_90a),
// f64 or f32, for a batch of S systems in one launch:
//
//   z_{k-1} = Minv_{k-1} y_{k-1},   y_k = b_k - L_{k-1} z_{k-1}   (y_0 = b_0)
//   x_{nb-1} = Minv_{nb-1} y_{nb-1},  x_k = z_k - T_k x_{k+1}
//
// Minv (S, nb, bs, bs), T and L (S, nb - 1, bs, bs) the factor of
// la/blocktri.py bt_factor, b and x (S, nb, bs), every array contiguous.
// It is the apply of the dense block-Thomas factor (la/blocktri.py
// bt_apply): the direction of the btlu Newton paths and the subdomain
// solve of the Schwarz preconditioner asm_btlu (parallel/dofpart.py).
//
// It replaces no TPU kernel: the JAX reference package's apply
// (proximalgalerkin_tpu/la/blocktri.py bt_apply) is two lax.scan loops of
// jnp products, which the port ran as about 4 nb matrix-vector products
// and 4 nb elementwise operations an apply, each a launch.
//
// What bounds it on this card, and what the design does about it:
//
// * Memory bandwidth. The factor is read once: (3 nb - 2) bs^2 values a
//   system (the distributed cell: 8 x 757 x 151^2 x 8 B = 1.105 GB, 0.330
//   ms at 3.35 TB/s). The back substitution takes z_k = Minv_k y_k from
//   the forward pass (kept in x, overwritten in place by x_k) instead of
//   reading Minv_k again.
// * The dependent chain. Each of the 3 nb - 2 products needs the whole
//   vector the one before it made. One thread-block cluster takes a
//   system; each block (CTA) of the cluster owns a slab of rows of every
//   block matrix and keeps the vectors in its shared memory, three
//   buffers in turn. After a product each block sends each of its rows to
//   every block of the cluster with st.async (distributed shared memory),
//   which completes its bytes on the receiver's mbarrier of that buffer;
//   a block starts the next product once its mbarrier has all bs values.
//   No cluster-wide barrier and no fence sits on the chain: a step is one
//   short product, a shuffle reduction and the remote stores' latency.
//   Three buffers make the reuse safe: a block that has the whole vector
//   p knows every block has finished reading vector p - 2. On the fast
//   path (one tile a product, at most two rows a warp, bs <= 32 JMAX) a
//   warp holds its rows of the next matrix in registers before the
//   vector arrives, so the chain waits only for the vector's loads. This
//   chain, not the bytes, bounds the kernel: about 1.05 us a step on an
//   H100, 0.80 ms an apply at the distributed cell (2.4 times its byte
//   bound), 0.28 ms at the disk cell's (1, 97, 200).
// * Latency of the matrices. The matrices do not depend on the vector, so
//   a producer warp streams the block's row slabs of the matrices, in the
//   order the products take them, into a ring of shared-memory slots with
//   bulk asynchronous copies (cp.async.bulk, completion on an mbarrier a
//   slot); the consumers release a slot on a second mbarrier. The ring
//   runs as many products ahead as it holds, so the reads overlap the
//   chain. A row slab is one contiguous range of device memory, copied
//   whole; when one row outgrows a slot the slab is cut into column tiles
//   (multiples of 32 columns), one copy a row piece. The copies are
//   widened to 16-byte boundaries (the factor's rows are not), never past
//   the 16-byte granule of the range's first or last value.
// * Sums. A consumer warp takes a row: lane l sums the columns j = l mod
//   32 in increasing j, a product and an add each (built with
//   -fmad=false), then the 32 partial sums meet in a butterfly of
//   shuffles. The order depends on nothing but bs, so two launches give
//   the same bits, in a CUDA graph or not, whatever the cluster size or
//   tiling; no atomics.
//
// Launch geometry (bt_apply_plan): the cluster size c (1 to 16 blocks,
// more than 8 non-portable) is the largest whose S clusters run in the
// fewest waves on the card (cudaOccupancyMaxActiveClusters); the rows of
// a block, the tiles and the ring's depth follow from bs, the dtype and
// c. The vector sits in shared memory while it takes at most
// VEC_SMEM_MAX bytes, else in the caller's (S, 2, bs) scratch in device
// memory (read and written past L1), two buffers in turn, each product
// then ending at the cluster barrier (split into arrive and wait), in
// which the producer warp takes part.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC -o libbtapply.so btapply.cu
// Plain C interface, loaded with ctypes (proximalgalerkin_torch/ops/
// btapply.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr int NWC = 15;                  // consumer warps a block
constexpr int NT = (NWC + 1) * 32;       // threads a block: + the producer
constexpr int MAXR = 4;                  // rows of a group a consumer holds
constexpr int GMAX = NWC * MAXR;         // rows of a group
constexpr int DMAX = 32;                 // ring slots at most
constexpr int JMAX = 8;                  // a lane's columns on the fast path
constexpr int SMEM_MAX = 232448;         // shared bytes a block can have
constexpr int VEC_SMEM_MAX = 32768;      // ops/btapply.py VEC_SMEM_MAX
constexpr int BAR_BYTES = 16 * DMAX + 32;   // full, empty, vector mbarriers
constexpr int ERR_NO_CLUSTER = 10001;    // no cluster size fits the card

struct Plan {
  int nb, bs, c;         // blocks, block size, blocks (CTAs) a cluster
  int G, ng, TC, nct;    // rows a group, groups, columns a tile, tiles
  int nt;                // tiles a product (ng * nct)
  int D, SB, PB;         // ring slots, bytes a slot, bytes a row piece
  int vec_bytes;         // shared bytes of the two vectors (0: global)
  int smem;              // dynamic shared bytes
  int waves;             // rounds of clusters the card runs
  int fast;              // one tile a product, at most 2 rows a warp and
                         // JMAX columns a lane, the vector in shared memory
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// whether the phase of parity `parity` of bar has completed (no wait)
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!ok);
}

// bytes (a multiple of 16) from src (16-byte aligned) to this block's
// shared dst (16-byte aligned), completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The cluster barrier in its two halves (as csrc/mgfused.cu): arrive once
// this thread's writes for the others are done, wait before reading
// theirs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// [a, b) widened to 16-byte boundaries: the start and the byte count
__device__ __forceinline__ uintptr_t floor16(const void* a) {
  return reinterpret_cast<uintptr_t>(a) & ~uintptr_t(15);
}

__device__ __forceinline__ uint32_t span16(const void* a, const void* b) {
  const uintptr_t e = (reinterpret_cast<uintptr_t>(b) + 15) & ~uintptr_t(15);
  return uint32_t(e - floor16(a));
}

__device__ __forceinline__ uint32_t shift16(const void* a) {
  return uint32_t(reinterpret_cast<uintptr_t>(a) & 15);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Product p of the chain: the matrix, its block index k and its kind
// (0: z_k = Minv_k y_k, 1: y_{k+1} = b_{k+1} - L_k z_k,
// 2: x_k = z_k - T_k x_{k+1})
template <typename T>
struct Chain {
  const T *M, *Tm, *L;
  int nb;
  long long bsq;
  __device__ __forceinline__ const T* at(int p, int* k, int* kind) const {
    if (p < 2 * (nb - 1)) {
      *k = p >> 1;
      *kind = p & 1;
      return (*kind ? L : M) + *k * bsq;
    }
    if (p == 2 * (nb - 1)) {
      *k = nb - 1;
      *kind = 0;
      return M + *k * bsq;
    }
    *k = 3 * nb - 3 - p;
    *kind = 2;
    return Tm + *k * bsq;
  }
};

// The vector of product p: buffer p % 3 of the three in shared memory
// (shared mode), whose mbarrier completes, for p >= 1, in its phase
// (p - 1) / 3 once every row has arrived
__device__ __forceinline__ uint32_t vec_parity(int p) {
  return uint32_t(((p - 1) / 3) & 1);
}

// the address in the cluster's shared window of block `rank`'s copy of
// this block's shared p
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t a = smem_u32(p);
  asm volatile("mapa.shared::cluster.u32 %0, %0, %1;\n" : "+r"(a) : "r"(rank));
  return a;
}

// val to the cluster address a, completing its bytes on the mbarrier at
// cluster address m (of the same block)
template <typename T>
__device__ __forceinline__ void push(T val, uint32_t a, uint32_t m) {
  if constexpr (sizeof(T) == 8) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
        "[%2];\n" ::"r"(a),
        "l"(__double_as_longlong(double(val))), "r"(m)
        : "memory");
  } else {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
        "[%2];\n" ::"r"(a),
        "r"(__float_as_uint(float(val))), "r"(m)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t ok;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!ok);
}

// A ring slot and the parity of its mbarriers' phase, a tile at a time
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int D) {
    if (++slot == D) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// a value for each of a consumer warp's rows of a group
template <typename T>
struct Rows {
  T v[MAXR];
};

// The kernel: one cluster of pl.c blocks a system, NWC consumer warps and
// one producer warp a block. VG: the vector in device memory, the
// products separated by cluster barriers (the producer takes part in
// them); else the vector in shared memory, three buffers, each row sent
// to every block by st.async, completing on that block's mbarrier of the
// buffer, and the producer runs free.
template <typename T, bool VG>
__global__ void __launch_bounds__(NT, 1)
    k_bt_apply(const T* __restrict__ Minv, const T* __restrict__ Tf,
               const T* __restrict__ Lf, const T* __restrict__ b,
               T* __restrict__ x, T* __restrict__ vg, Plan pl) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + DMAX;
  uint64_t* vbar = empty + DMAX;
  T* vs = reinterpret_cast<T*>(smem + BAR_BYTES);
  unsigned char* ring = smem + BAR_BYTES + pl.vec_bytes;

  cg::cluster_group cl = cg::this_cluster();
  const int c = pl.c, nb = pl.nb, bs = pl.bs;
  const int rk = int(cl.block_rank());
  const long long sys = blockIdx.x / c;
  const int lo = int((long long)rk * bs / c);
  const int hi = int((long long)(rk + 1) * bs / c);
  const long long bsq = (long long)bs * bs;
  const Chain<T> ch{Minv + sys * nb * bsq, Tf + sys * (nb - 1) * bsq,
                    Lf + sys * (nb - 1) * bsq, nb, bsq};
  const T* bsys = b + sys * nb * bs;
  T* xs = x + sys * nb * bs;
  T* vgs = VG ? vg + sys * 2 * bs : nullptr;
  const int P = 3 * nb - 2;
  const uint32_t vbytes = uint32_t(bs) * uint32_t(sizeof(T));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.D; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NWC);
    }
    if constexpr (!VG) {
      for (int s = 0; s < 3; ++s) mbar_init(vbar + s, 1);
      // vectors 1, 2 and 3 (buffers 1, 2, 0) in their phase 0
      for (int v = 1; v <= 3 && v <= P - 1; ++v)
        mbar_expect_tx(vbar + v % 3, vbytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the first vector: y_0 = b_0
  if constexpr (VG) {
    for (int i = lo + threadIdx.x; i < hi; i += NT) __stcg(vgs + i, bsys[i]);
  } else {
    for (int i = threadIdx.x; i < bs; i += NT) vs[i] = bsys[i];
  }
  cluster_arrive();
  cluster_wait();

  if (warp == NWC) {
    // ---- producer: the tiles in the order the consumers take them, tile
    // (group tg, column tile tct) of product tp into the ring's next slot
    const long long Q = (long long)P * pl.nt;
    long long q = 0;
    int tp = 0, tg = 0, tct = 0;
    Ring r;
    auto issue = [&]() {
      int k, kind;
      const T* A = ch.at(tp, &k, &kind);
      const int ra = lo + tg * pl.G, rb = min(ra + pl.G, hi);
      unsigned char* sb = ring + r.slot * pl.SB;
      uint64_t* bar = full + r.slot;
      if (pl.nct == 1) {
        if (lane == 0) {
          if (ra < rb) {
            const T* a0 = A + (long long)ra * bs;
            const T* a1 = A + (long long)rb * bs;
            const uint32_t n = span16(a0, a1);
            mbar_expect_tx(bar, n);
            bulk_copy(sb, reinterpret_cast<const void*>(floor16(a0)), n, bar);
          } else {
            mbar_expect_tx(bar, 0);
          }
        }
      } else {
        const int c0 = tct * pl.TC, c1 = min(bs, c0 + pl.TC);
        uint32_t mine = 0;
        for (int i = ra + lane; i < rb; i += 32) {
          const T* a0 = A + (long long)i * bs + c0;
          mine += span16(a0, a0 + (c1 - c0));
        }
        const uint32_t total = __reduce_add_sync(0xffffffffu, mine);
        if (lane == 0) mbar_expect_tx(bar, total);
        __syncwarp();
        for (int i = ra + lane; i < rb; i += 32) {
          const T* a0 = A + (long long)i * bs + c0;
          bulk_copy(sb + (i - ra) * pl.PB,
                    reinterpret_cast<const void*>(floor16(a0)),
                    span16(a0, a0 + (c1 - c0)), bar);
        }
      }
      __syncwarp();
      if (++tct == pl.nct) {
        tct = 0;
        if (++tg == pl.ng) {
          tg = 0;
          ++tp;
        }
      }
      r.next(pl.D);
      ++q;
    };
    if constexpr (VG) {
      for (int p = 0; p < P; ++p) {
        if (p > 0) cluster_wait();
        // every tile of product p, waiting for its slot; then the tiles
        // ahead whose slots are already free
        const long long qend = (long long)(p + 1) * pl.nt;
        while (q < Q) {
          if (q < qend) {
            mbar_wait(empty + r.slot, r.phase ^ 1u);
          } else {
            const bool freed = __shfl_sync(
                0xffffffffu,
                lane == 0 && mbar_test(empty + r.slot, r.phase ^ 1u), 0);
            if (!freed) break;
          }
          issue();
        }
        __syncwarp();
        if (p < P - 1) cluster_arrive();
      }
    } else {
      while (q < Q) {
        mbar_wait(empty + r.slot, r.phase ^ 1u);
        issue();
      }
    }
  } else {
    // ---- consumers: warp w holds rows ra + w + NWC m of each group
    Ring r;
    // lane l < c sends rows to block l: its vectors and their mbarriers
    const uint32_t peer_v = VG ? 0u : remote(vs, lane < c ? lane : rk);
    const uint32_t peer_b = VG ? 0u : remote(vbar, lane < c ? lane : rk);
    // the addends of group g of product p: b_{k+1} (kind 1) or z_k, kept
    // in x (kind 2)
    auto addends = [&](int p, int g) {
      Rows<T> out;
      int k = 0, kind = 0;
      if (p < P) ch.at(p, &k, &kind);
      const T* src = kind == 1 ? bsys + (long long)(k + 1) * bs
                               : xs + (long long)k * bs;
      const int ra = lo + g * pl.G, rb = min(ra + pl.G, hi);
#pragma unroll
      for (int m = 0; m < MAXR; ++m) {
        const int i = ra + warp + NWC * m;
        out.v[m] = kind != 0 && i < rb ? __ldcg(src + i) : T(0);
      }
      return out;
    };
    if (pl.fast) {
      // A product's rows are in registers before its vector is in: the
      // chain waits only for the vector's loads, the sums and the sends.
      // Each lane sums its columns in the same order as below.
      const int i0 = lo + warp, i1 = lo + warp + NWC;
      const bool has0 = i0 < hi, has1 = i1 < hi;
      const uint32_t pv0 = peer_v + uint32_t(i0 * sizeof(T));
      const uint32_t pv1 = peer_v + uint32_t(i1 * sizeof(T));
      T n0 = T(0), n1 = T(0);          // the next product's addends
      for (int p = 0; p < P; ++p) {
        int k, kind;
        const T* A = ch.at(p, &k, &kind);
        mbar_wait(full + r.slot, r.phase);
        const T* t0 = reinterpret_cast<const T*>(
                          ring + r.slot * pl.SB + shift16(A + (long long)lo * bs)) +
                      warp * bs;
        const T* t1 = t0 + NWC * bs;
        T a0[JMAX], a1[JMAX];
#pragma unroll
        for (int t = 0; t < JMAX; ++t) {
          const int j = lane + 32 * t;
          a0[t] = has0 && j < bs ? t0[j] : T(0);
          a1[t] = has1 && j < bs ? t1[j] : T(0);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + r.slot);
        r.next(pl.D);
        const T add0 = n0, add1 = n1;
        if (p + 1 < P) {
          int kn, kindn;
          ch.at(p + 1, &kn, &kindn);
          const T* src = kindn == 1 ? bsys + (long long)(kn + 1) * bs
                                    : xs + (long long)kn * bs;
          n0 = kindn != 0 && has0 ? __ldcg(src + i0) : T(0);
          n1 = kindn != 0 && has1 ? __ldcg(src + i1) : T(0);
        }
        // a warp without rows waits for no vector (warp 0 has a row and
        // arms each buffer's next phase)
        if (!has0) continue;
        const int cur = p % 3, nxt = (p + 1) % 3;
        if (p > 0) {
          mbar_wait_cluster(vbar + cur, vec_parity(p));
          if (threadIdx.x == 0 && p + 3 <= P - 1)
            mbar_expect_tx(vbar + cur, vbytes);
        }
        const T* vin = vs + cur * bs;
        T s0 = T(0), s1 = T(0);
#pragma unroll
        for (int t = 0; t < JMAX; ++t) {
          const int j = lane + 32 * t;
          if (j < bs) {
            const T v = vin[j];
            s0 += a0[t] * v;
            s1 += a1[t] * v;
          }
        }
        const uint32_t off = uint32_t(nxt * bs * sizeof(T));
        const uint32_t mb = peer_b + uint32_t(nxt * 8);
        const T r0 = warp_sum(s0);
        const T val0 = kind == 0 ? r0 : add0 - r0;
        if (p < P - 1 && lane < c) push(val0, pv0 + off, mb);
        if (has1) {
          const T r1 = warp_sum(s1);
          const T val1 = kind == 0 ? r1 : add1 - r1;
          if (p < P - 1 && lane < c) push(val1, pv1 + off, mb);
          if (kind != 1 && lane == 0) xs[(long long)k * bs + i1] = val1;
        }
        if (kind != 1 && lane == 0) xs[(long long)k * bs + i0] = val0;
        __syncwarp();
      }
    } else {
    Rows<T> nadd = addends(0, 0);
    for (int p = 0; p < P; ++p) {
      int k, kind;
      const T* A = ch.at(p, &k, &kind);
      const int cur = VG ? (p & 1) : p % 3;
      const int nxt = VG ? ((p + 1) & 1) : (p + 1) % 3;
      const T* vin = VG ? vgs + cur * bs : vs + cur * bs;
      Rows<T> add = nadd;
      nadd = addends(p + 1, 0);       // a product ahead, off the chain
      // the product's first tile does not depend on the vector
      mbar_wait(full + r.slot, r.phase);
      if constexpr (VG) {
        if (p > 0) cluster_wait();
      } else {
        if (p > 0) {
          mbar_wait_cluster(vbar + cur, vec_parity(p));
          // the buffer's next vector, p + 3, once this one is in
          if (threadIdx.x == 0 && p + 3 <= P - 1)
            mbar_expect_tx(vbar + cur, vbytes);
        }
      }
      for (int g = 0; g < pl.ng; ++g) {
        const int ra = lo + g * pl.G, rb = min(ra + pl.G, hi);
        if (g > 0) add = addends(p, g);
        T acc[MAXR];
#pragma unroll
        for (int m = 0; m < MAXR; ++m) acc[m] = T(0);
        for (int ct = 0; ct < pl.nct; ++ct) {
          if (g > 0 || ct > 0) mbar_wait(full + r.slot, r.phase);
          const unsigned char* sb = ring + r.slot * pl.SB;
          const int c0 = ct * pl.TC, c1 = min(bs, c0 + pl.TC);
          const T* rp[MAXR];
#pragma unroll
          for (int m = 0; m < MAXR; ++m) {
            const int i = ra + warp + NWC * m;
            if (pl.nct == 1) {
              const T* a0 = A + (long long)ra * bs;
              rp[m] = reinterpret_cast<const T*>(sb + shift16(a0)) +
                      (i - ra) * bs;
            } else {
              const T* a0 = A + (long long)i * bs + c0;
              rp[m] = reinterpret_cast<const T*>(sb + (i - ra) * pl.PB +
                                                 shift16(a0));
            }
          }
          for (int j = c0 + lane; j < c1; j += 32) {
            const T v = VG ? __ldcg(vin + j) : vin[j];
#pragma unroll
            for (int m = 0; m < MAXR; ++m)
              if (ra + warp + NWC * m < rb) acc[m] += rp[m][j - c0] * v;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + r.slot);
          r.next(pl.D);
        }
#pragma unroll
        for (int m = 0; m < MAXR; ++m) {
          const int i = ra + warp + NWC * m;
          if (i >= rb) continue;
          const T s = warp_sum(acc[m]);
          const T val = kind == 0 ? s : add.v[m] - s;
          if (p < P - 1) {
            if constexpr (VG) {
              if (lane == 0) __stcg(vgs + nxt * bs + i, val);
            } else {
              if (lane < c)
                push(val, peer_v + uint32_t((nxt * bs + i) * sizeof(T)),
                     peer_b + uint32_t(nxt * 8));
            }
          }
          if (kind != 1 && lane == 0) xs[(long long)k * bs + i] = val;
        }
      }
      __syncwarp();
      if constexpr (VG) {
        if (p < P - 1) cluster_arrive();
      }
    }
    }
  }
  // no block leaves while another may still write into its vectors
  __syncwarp();
  cluster_arrive();
  cluster_wait();
}

int round16(long long n) { return int((n + 15) / 16 * 16); }

// rows, tiles and ring of a cluster of c blocks (0, or -1 when nothing fits)
int tiling(int bs, int isz, int c, Plan* pl) {
  const int rmax = (bs + c - 1) / c;
  const long long rowb = (long long)bs * isz;
  pl->vec_bytes = rowb <= VEC_SMEM_MAX ? round16(3 * rowb) : 0;
  const int ring = (SMEM_MAX - BAR_BYTES - pl->vec_bytes) / 16 * 16;
  const int st = ring / 4 / 16 * 16;       // a slot: at least 4 in the ring
  // a copy widened to 16-byte boundaries takes at most 32 bytes more;
  // whole rows while a slot holds a row for each consumer warp
  const int gfit = int(std::min<long long>(GMAX, (st - 32) / rowb));
  if (gfit >= std::min(rmax, NWC)) {      // whole rows, one copy a tile
    const int ng = (rmax + gfit - 1) / gfit;
    pl->G = (rmax + ng - 1) / ng;
    pl->TC = bs;
    pl->PB = 0;
    pl->SB = round16(pl->G * rowb + 32);
  } else {                                // column tiles, a copy a row
    const int ng = (rmax + NWC - 1) / NWC;
    pl->G = (rmax + ng - 1) / ng;
    pl->TC = (st / pl->G - 48) / isz / 32 * 32;
    if (pl->TC < 32) return -1;
    pl->PB = round16((long long)pl->TC * isz) + 32;
    pl->SB = pl->G * pl->PB;
  }
  pl->ng = (rmax + pl->G - 1) / pl->G;
  pl->nct = (bs + pl->TC - 1) / pl->TC;
  pl->nt = pl->ng * pl->nct;
  pl->D = std::min(DMAX, ring / pl->SB);
  pl->fast = pl->vec_bytes > 0 && pl->nct == 1 && pl->ng == 1 &&
             pl->G <= 2 * NWC && bs <= 32 * JMAX;
  pl->smem = BAR_BYTES + pl->vec_bytes + pl->D * pl->SB;
  pl->c = c;
  pl->bs = bs;
  return 0;
}

std::mutex g_mu;
std::map<std::tuple<int, int, int>, bool> g_attr;        // dev, isz, vg
std::map<std::tuple<int, int, int, int, int>, int> g_active;
std::map<std::tuple<int, long long, int, int, int>, Plan> g_plans;

template <typename T, bool VG>
cudaLaunchConfig_t config(const Plan& pl, int S, cudaStream_t st,
                          cudaLaunchAttribute* at) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(S) * unsigned(pl.c));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = size_t(pl.smem);
  cfg.stream = st;
  at->id = cudaLaunchAttributeClusterDimension;
  at->val.clusterDim.x = unsigned(pl.c);
  at->val.clusterDim.y = 1;
  at->val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

// the kernel's attributes on device dev, once (g_mu held)
template <typename T, bool VG>
cudaError_t prepare(int dev) {
  const auto key = std::make_tuple(dev, int(sizeof(T)), int(VG));
  if (g_attr.count(key)) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      k_bt_apply<T, VG>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k_bt_apply<T, VG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  if (e == cudaSuccess) g_attr[key] = true;
  return e;
}

// clusters of pl that the card runs at once (g_mu held)
template <typename T, bool VG>
cudaError_t active(int dev, const Plan& pl, int* n) {
  const auto key = std::make_tuple(dev, int(sizeof(T)), int(VG), pl.c,
                                   pl.smem);
  auto it = g_active.find(key);
  if (it != g_active.end()) {
    *n = it->second;
    return cudaSuccess;
  }
  cudaLaunchAttribute at;
  const cudaLaunchConfig_t cfg = config<T, VG>(pl, 1, nullptr, &at);
  int m = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&m, k_bt_apply<T, VG>, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();   // an unsupported size is not a sticky error
    m = 0;
  }
  g_active[key] = m;
  *n = m;
  return cudaSuccess;
}

// the launch geometry of S systems (nb, bs) on device dev (g_mu held)
template <typename T, bool VG>
int plan(int dev, int S, int nb, int bs, Plan* out) {
  const auto key = std::make_tuple(dev, (long long)S * 8 + (long long)sizeof(T),
                                   nb, bs, int(VG));
  auto it = g_plans.find(key);
  if (it != g_plans.end()) {
    *out = it->second;
    return 0;
  }
  cudaError_t e = prepare<T, VG>(dev);
  if (e != cudaSuccess) return int(e);
  Plan best = {};
  bool found = false;
  for (int c = 16; c >= 1; c >>= 1) {
    if (c > bs) continue;
    Plan pl = {};
    if (tiling(bs, int(sizeof(T)), c, &pl) != 0) continue;
    int n = 0;
    active<T, VG>(dev, pl, &n);
    if (n < 1) continue;
    pl.waves = (S + n - 1) / n;
    if (!found || pl.waves < best.waves) {
      best = pl;
      found = true;
    }
  }
  if (!found) return ERR_NO_CLUSTER;
  best.nb = nb;
  g_plans[key] = best;
  *out = best;
  return 0;
}

template <typename T>
int launch(const T* Minv, const T* Tf, const T* Lf, const T* b, T* x, T* vg,
           int S, int nb, int bs, void* stream) {
  if (S < 0 || nb < 1 || bs < 1) return int(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const bool vglob = (long long)bs * sizeof(T) > VEC_SMEM_MAX;
  if (vglob && vg == nullptr) return int(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  Plan pl;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    const int err = vglob ? plan<T, true>(dev, S, nb, bs, &pl)
                          : plan<T, false>(dev, S, nb, bs, &pl);
    if (err != 0) return err;
  }
  cudaLaunchAttribute at;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vglob) {
    const cudaLaunchConfig_t cfg = config<T, true>(pl, S, st, &at);
    e = cudaLaunchKernelEx(&cfg, k_bt_apply<T, true>, Minv, Tf, Lf, b, x, vg,
                           pl);
  } else {
    const cudaLaunchConfig_t cfg = config<T, false>(pl, S, st, &at);
    e = cudaLaunchKernelEx(&cfg, k_bt_apply<T, false>, Minv, Tf, Lf, b, x,
                           vg, pl);
  }
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* bt_error_string(int err) {
  if (err == ERR_NO_CLUSTER)
    return "no thread-block cluster of the apply fits this card";
  return cudaGetErrorString(cudaError_t(err));
}

// x (S, nb, bs) = the block-Thomas apply of the factor (Minv, T, L) to b,
// on the stream; vg: (S, 2, bs) scratch where 2 bs values exceed
// VEC_SMEM_MAX bytes (else unused). 0 or an error (bt_error_string).
int bt_apply_f64(const double* Minv, const double* T, const double* L,
                 const double* b, double* x, double* vg, int S, int nb,
                 int bs, void* stream) {
  return launch<double>(Minv, T, L, b, x, vg, S, nb, bs, stream);
}

int bt_apply_f32(const float* Minv, const float* T, const float* L,
                 const float* b, float* x, float* vg, int S, int nb, int bs,
                 void* stream) {
  return launch<float>(Minv, T, L, b, x, vg, S, nb, bs, stream);
}

// The launch geometry of S systems (nb, bs) of itemsize isz (4 or 8) on
// the current device: out[0..10] = cluster blocks, rows a group, groups,
// columns a tile, column tiles, ring slots, bytes a slot, vector in
// device memory (0/1), dynamic shared bytes, waves, the fast path (0/1).
// 0 or an error.
int bt_apply_plan(int S, int nb, int bs, int isz, int* out) {
  if (S < 1 || nb < 1 || bs < 1 || (isz != 4 && isz != 8))
    return int(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  const bool vglob = (long long)bs * isz > VEC_SMEM_MAX;
  Plan pl;
  int err;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (isz == 8)
      err = vglob ? plan<double, true>(dev, S, nb, bs, &pl)
                  : plan<double, false>(dev, S, nb, bs, &pl);
    else
      err = vglob ? plan<float, true>(dev, S, nb, bs, &pl)
                  : plan<float, false>(dev, S, nb, bs, &pl);
  }
  if (err != 0) return err;
  const int v[11] = {pl.c, pl.G,  pl.ng,           pl.TC,   pl.nct,  pl.D,
                     pl.SB, pl.vec_bytes == 0, pl.smem, pl.waves, pl.fast};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
