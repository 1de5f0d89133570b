// The block-coordinate round's scalar chain (B3) and fused block (B4),
// for Hopper (sm_90a).
//
// Replaces the TPU kernels cocoa_tpu/ops/pallas_chain.py
// chain_block_batched (body _chain_kernel_batched) and fused_block (body
// _fused_kernel).  One block of B consecutive draws of shard k runs as a
// scalar recurrence over cached pairwise dots: for j = 0..B-1,
//   a      = a0_j + sum_{i<j, idx_i == idx_j} delta_i   (repeated draws)
//   margin = m0_j + sig_eff * (mb_j + sum_{i<j} coef_i * G[j, i])
//            (frozen mode: m0_j)
//   a'     = alpha_step(loss, a, y_j * margin, qii_j, lam*n)
//   delta_j = (a' - a) * live_j,   coef_j = y_j * delta_j / coef_div
// G[j, i] = x_i . x_j.  Only i < j is read, so a caller may pass the full
// symmetric Gram (the split branch) or its strict triangle (the sparse
// branch).  The fused kernel computes m0 = x_j . v (v = w + sig_eff * dw),
// G and the Delta-w increment dwu = sum_j coef_j x_j itself.
//
// What bounds it on this card:
// - the chain: B dependent steps per shard and only K shards, so latency
//   (each step's alpha_step and the hand-off of its coefficient to the
//   next step), not bytes or flops;
// - the fused block: the same chain, on one warp of each shard.  Its
//   Gram (K * B^2 * d / 2 multiply-adds), margins and apply are work over
//   d, spread over a cluster of blocks a shard.
//
// What the B3 design (chain_kernel) does about it:
// - the chain is right-looking: a step pushes its coefficient into the
//   margins of the rows still to come instead of pulling the past in with
//   a dot.  One block a shard; warp 0, the consumer, holds in lane l, for
//   its rows i = l + 32 r (r < R = ceil(B / 32)), acc_i = sum of
//   coef_t * G[i, t] over the steps t < i taken so far, a_i = a0_i plus
//   the deltas of earlier steps that drew the same index, and idx_i.  Step
//   j broadcasts acc_j, a_j and idx_j from lane j mod 32 (__shfl_sync);
//   every lane computes the margin, alpha_step, delta_j and coef_j with
//   the same bits in the same order of operations as chain_warp; then
//   each lane adds coef_j * G[i, j] to acc_i and delta_j to a_i (same
//   draw) for its rows i > j, without a branch: the rows i <= j and past
//   B take the terms too, and are never read again.  The step's G[i, j]
//   are loaded before its chain needs them.  The dependent path of a step
//   is one shuffle, alpha_step and one multiply-add: no butterfly and no
//   __syncwarp.  The panel index r_j = j / 32 is a compile-time index (an
//   unrolled loop over panels), so no register array is indexed at run
//   time.  acc_i sums in step order, so float32 results differ from the
//   left-looking kernel's butterfly order in the last bits.
// - the Gram is staged in shared memory by 256 producer threads, ahead of
//   the consumer: a unit is ``cols`` (32, 16 or 8) columns of the strict
//   lower triangle, columns [q cols, (q + 1) cols) of rows 32 floor(q cols
//   / 32) .. B-1, stored row-major with a row stride of cols + 1 words so
//   that lane l reading rows l + 32 r at one column hits 32 different
//   banks.  Units go round a ring of ``stages`` slots, slot s sized for
//   its largest unit, s; with stages = ceil(B / cols) every unit has its
//   own slot (the whole triangle, staged once: B=128 and 256 in float32).
//   Producers copy with element-sized cp.async and arrive on the slot's
//   "full" mbarrier through cp.async.mbarrier.arrive.noinc, so the
//   arrival lands when the copies have; the consumer's lanes wait on it
//   before the unit's first step and arrive on the slot's "empty" mbarrier
//   after its last.  The consumer's step reads only shared memory and
//   registers.  ops/block_chain.py chain_plan picks (stages, cols) against
//   the shared-memory opt-in; the kernel refuses a plan it cannot hold.
// - frozen mode reads no Gram and keeps no acc; the producers leave.
// - repeated draws compare int32 indices, so there is no (B, K, B)
//   equality tile and no 2^24 limit on the shard size.
//
// What the B4 design (fused_kernel) does about it:
// - one warp runs a shard's chain (chain_warp, left-looking: the
//   i-strided dots end in a shuffle butterfly, so every lane holds the
//   same bits and computes a' itself; Gram row j+1 is loaded into
//   registers while step j reduces).
// - the fused kernel runs shard k on a thread-block cluster of C blocks
//   (grid (C, K)).  Block r owns a contiguous slice of d, a multiple of 32
//   columns but for the last, and computes in its own shared memory the
//   partial margins x_j . v and the partial (B, B) Gram over its slice:
//   256 threads, 64 x 64 tiles of the lower triangle over 32-wide steps of
//   the slice, each thread a 4 x 4 register tile, the next step loaded
//   into registers while the current one is multiplied.  Plain FP32 fused
//   multiply-adds, no TF32: the gap certificate rests on
//   w = (1 / lam n) sum y alpha x, and tensor-core TF32 keeps three digits.
// - after a cluster barrier, block r sums a fixed 1/C of the Gram entries
//   i < j and of the margins, reading the C partials through distributed
//   shared memory in rank order 0..C-1, into the leader's (rank 0)
//   arrays.  The order is fixed, not first come first served, so two
//   launches give the same bits and the chain reads one value an entry.
// - after a second barrier warp 0 of the leader runs the chain over the
//   reduced Gram in its own shared memory, and the leader pushes the B
//   coefficients into every block's shared memory; after a third, each
//   block writes dwu = sum_j coef_j x_j over its own slice, each column
//   summed in j order by one thread, so dwu does not depend on C.
// - C comes from the caller (ops/block_chain.py fused_plan); C = 1 is one
//   block a shard.  A cluster above 8 blocks is non-portable and asked
//   for explicitly; a refused launch returns its error, nothing falls
//   back.
// - the TPU kernel's lane-blocked (6K, B) scalar tile, j-leading
//   (B, 2K, B) Gram layout, half-tile grid and f32-cast index compare are
//   TPU layout workarounds; here the Gram is (K, B, B) with row j of shard
//   k contiguous.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sdca_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // fused block
constexpr int kTile = 64;      // Gram output tile (rows and columns)
constexpr int kDk = 32;        // slice of d per tile step
constexpr int kLd = kDk + 1;   // padded shared row: no bank conflicts
constexpr int kMaxCluster = 16;  // the non-portable cluster limit
constexpr int kChainProducers = 256;  // B3: threads that stage the Gram
constexpr int kChainThreads = 32 + kChainProducers;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar)) : "memory");
}

// Wait until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One element from global to shared memory, asynchronously.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_u32(dst)), "l"(__cvta_generic_to_global(src)),
               "n"(sizeof(T)) : "memory");
}

// ``bar`` receives one arrival when every cp.async this thread issued so
// far has landed (the arrival is one of the count it was initialised
// with).
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// B3's ring: unit q holds columns [q * cols, (q + 1) * cols) of rows
// 32 * floor(q * cols / 32) .. b-1; slot s holds units s, s + S, ... and
// is sized for unit s.  The rows of slots 0..s-1, summed.
__host__ __device__ inline long long slot_rows_before(int b, int cols,
                                                      int s) {
  const int g = 32 / cols, m = s / g;
  return (long long)s * b -
         32LL * (g * (long long)m * (m - 1) / 2 + (long long)m * (s - m * g));
}

// One shard's chain on the calling warp.  R = ceil(B / 32) Gram entries
// per lane (B <= 32 R).  Every pointer but ``gram`` is shared memory;
// ``gram`` (row stride ``ld``) is shared or global memory, or null in
// frozen mode.  ``mb`` may be null (taken as 0).
template <typename T, int R>
__device__ void chain_warp(int b, const T* m0, const T* mb, const T* y,
                           const T* qii, const T* a0, const T* live,
                           const int* idx, const T* gram, int ld, T* coef,
                           T* delta, int loss, T lam_n, T coef_div,
                           T sig_eff, T smoothing) {
  const int lane = threadIdx.x & 31;
  T g[R];
#pragma unroll
  for (int r = 0; r < R; ++r) g[r] = T(0);  // row 0 reads nothing
  for (int j = 0; j < b; ++j) {
    const int jn = j + 1;
    T gn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      gn[r] = (gram != nullptr && jn < b && i < jn)
                  ? gram[(size_t)jn * ld + i] : T(0);
    }
    const int idx_j = idx[j];
    T dot = T(0), dsum = T(0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      if (i < j) {
        dot = dot + coef[i] * g[r];
        if (idx[i] == idx_j) dsum = dsum + delta[i];
      }
    }
    dot = sdca::warp_sum(dot);
    dsum = sdca::warp_sum(dsum);
    const T a = a0[j] + dsum;
    T margin = m0[j];
    if (gram != nullptr)
      margin = margin + sig_eff * ((mb != nullptr ? mb[j] : T(0)) + dot);
    const T yj = y[j];
    const T new_a = sdca::alpha_step<T>(loss, a, yj * margin, qii[j], lam_n,
                                        smoothing);
    const T dj = (new_a - a) * live[j];
    const T cj = yj * dj / coef_div;
    if (lane == 0) {
      coef[j] = cj;
      delta[j] = dj;
    }
    __syncwarp();  // step j's coef and delta precede step j+1's reads
#pragma unroll
    for (int r = 0; r < R; ++r) g[r] = gn[r];
  }
}

// B3: grid K, one block of kChainThreads per shard: warp 0 runs the chain
// (right-looking), the other threads stage the Gram's units in a ring of
// ``stages`` slots of ``cols`` columns.  scal (K, 6, B) = [m0 | y | qii |
// a0 | mb | live]; gram (K, B, B) or null (frozen); idx (K, B) int32.
template <typename T, int R>
__global__ void __launch_bounds__(kChainThreads) chain_kernel(
    const T* __restrict__ scal, const T* __restrict__ gram,
    const int* __restrict__ idx, T* __restrict__ delta_out,
    T* __restrict__ coef_out, int b, int stages, int cols, int loss,
    T lam_n, T coef_div, T sig_eff, T smoothing) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned long long* empty = full + stages;
  T* ring = reinterpret_cast<T*>(empty + stages);
  const int ld = cols + 1;
  T* s = ring + ld * slot_rows_before(b, cols, stages);
  T* coef = s + 6 * b;
  T* delta = coef + b;
  const int k = blockIdx.x, tid = threadIdx.x;
  const bool frozen = gram == nullptr;
  const int units = (b + cols - 1) / cols;
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + st, kChainProducers);
      mbar_init(empty + st, 32);
    }
  }
  __syncthreads();
  if (tid >= 32) {  // a producer: unit q into slot q mod S
    if (frozen) return;
    const int pt = tid - 32;
    const T* g = gram + (size_t)k * b * b;
    for (int q = 0; q < units; ++q) {
      const int slot = q % stages, round = q / stages;
      if (round > 0) mbar_wait(empty + slot, (round - 1) & 1);
      const int j0 = q * cols, base = j0 & ~31;
      T* dst = ring + ld * slot_rows_before(b, cols, slot);
      const int n = (b - base) * cols;
      for (int e = pt; e < n; e += kChainProducers) {
        const int ri = e / cols, cc = e - ri * cols;
        const int i = base + ri, j = j0 + cc;
        if (j < i) cp_async(dst + ri * ld + cc, g + (size_t)i * b + j);
      }
      cp_async_arrive(full + slot);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  const int lane = tid;
  const T* sc = scal + (size_t)k * 6 * b;
  for (int t = lane; t < 6 * b; t += 32) s[t] = sc[t];
  T acc[R], a[R];
  int ix[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    acc[r] = T(0);
    a[r] = i < b ? sc[3 * b + i] : T(0);
    ix[r] = i < b ? idx[(size_t)k * b + i] : -1;
  }
  __syncwarp();
  const T *m0 = s, *y = s + b, *qii = s + 2 * b, *mb = s + 4 * b,
          *live = s + 5 * b;
  const int per_panel = 32 / cols;
#pragma unroll
  for (int p = 0; p < R; ++p) {
    if (32 * p < b) {
      for (int h = 0; h < per_panel; ++h) {
        const int q = p * per_panel + h, j0 = 32 * p + h * cols;
        if (j0 >= b) break;
        const int slot = q % stages;
        const T* unit = ring + ld * slot_rows_before(b, cols, slot);
        if (!frozen) mbar_wait(full + slot, (q / stages) & 1);
        const int jn = min(b, j0 + cols);
        for (int j = j0; j < jn; ++j) {
          const int c = j - 32 * p;  // the lane that holds row j
          const T aj = __shfl_sync(0xffffffffu, a[p], c);
          const int idx_j = __shfl_sync(0xffffffffu, ix[p], c);
          const T accj = __shfl_sync(0xffffffffu, acc[p], c);
          // G[i, j] for this lane's rows, loaded before the chain needs
          // them; a row past B reads row B-1's slot, and rows i <= j read
          // entries no producer wrote: both are dead rows, never read
          const T* col = unit + (j - j0);
          T g[R];
          if (!frozen) {
#pragma unroll
            for (int r = p; r < R; ++r)
              g[r] = col[(min(lane + 32 * r, b - 1) - 32 * p) * ld];
          }
          T margin = m0[j];
          if (!frozen) margin = margin + sig_eff * (mb[j] + accj);
          const T yj = y[j];
          const T new_a = sdca::alpha_step<T>(loss, aj, yj * margin, qii[j],
                                              lam_n, smoothing);
          const T dj = (new_a - aj) * live[j];
          const T cj = yj * dj / coef_div;
          if (lane == 0) {  // read only after the chain
            coef[j] = cj;
            delta[j] = dj;
          }
          // the rows still to come take step j's terms; the rows i <= j
          // (and past B) are updated too, without a branch: they are not
          // read again
#pragma unroll
          for (int r = p; r < R; ++r) {
            if (!frozen) acc[r] = acc[r] + cj * g[r];
            a[r] = a[r] + (ix[r] == idx_j ? dj : T(0));
          }
        }
        if (!frozen) mbar_arrive(empty + slot);  // the unit is read
      }
    }
  }
  __syncwarp();
  for (int t = lane; t < b; t += 32) {
    delta_out[(size_t)k * b + t] = delta[t];
    coef_out[(size_t)k * b + t] = coef[t];
  }
}

// B4: grid (C, K), a cluster of C blocks of 256 threads per shard; block
// r owns columns [r * sw, min(d, (r + 1) * sw)).  xb (K, B, d) the
// block's rows; yb, qb, a0, live (K, B); idx (K, B) int32; v (K, d).
// Writes delta (K, B) and dwu (K, d).
template <typename T, int R>
__global__ void __launch_bounds__(kThreads) fused_kernel(
    const T* __restrict__ xb, const int* __restrict__ idx,
    const T* __restrict__ yb, const T* __restrict__ qb,
    const T* __restrict__ a0, const T* __restrict__ live,
    const T* __restrict__ v, T* __restrict__ delta_out,
    T* __restrict__ dwu_out, int b, int d, int sw, int loss, T lam_n,
    T coef_div, T sig_eff, T smoothing, int frozen) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* gram = reinterpret_cast<T*>(smem_raw);
  T* m0 = gram + (frozen ? 0 : (size_t)b * b);
  T* ys = m0 + b;
  T* qs = ys + b;
  T* as0 = qs + b;
  T* ls = as0 + b;
  T* coef = ls + b;
  T* delta = coef + b;
  T* ta = delta + b;          // kTile x kLd: rows of tile i
  T* tb = ta + kTile * kLd;   // kTile x kLd: rows of tile j
  int* ix = reinterpret_cast<int*>(tb + kTile * kLd);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nc = (int)cluster.num_blocks();
  const int k = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int f_lo = rank * sw, f_hi = min(d, f_lo + sw);
  const T* x = xb + (size_t)k * b * d;
  const T* vk = v + (size_t)k * d;
  if (rank == 0) {  // the chain's step scalars, on the leader only
    for (int t = tid; t < b; t += kThreads) {
      const size_t o = (size_t)k * b + t;
      ys[t] = yb[o];
      qs[t] = qb[o];
      as0[t] = a0[o];
      ls[t] = live[o];
      ix[t] = idx[o];
    }
  }
  // partial margins x_j . v over the slice, one warp per row
  for (int j = warp; j < b; j += kThreads / 32) {
    T acc = T(0);
    for (int f = f_lo + lane; f < f_hi; f += 32)
      acc = acc + x[(size_t)j * d + f] * vk[f];
    acc = sdca::warp_sum(acc);
    if (lane == 0) m0[j] = acc;
  }
  if (!frozen) {  // the partial Gram over the slice, lower-triangle tiles
    const int nt = (b + kTile - 1) / kTile;
    const int tx = tid & 15, ty = tid >> 4;  // 16 x 16 threads, 4 x 4 each
    constexpr int kPer = kTile * kDk / kThreads;  // slice loads per thread
    for (int tj = 0; tj < nt; ++tj) {
      for (int ti = 0; ti <= tj; ++ti) {
        T acc[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[u][w] = T(0);
        T pa[kPer], pb[kPer];
        auto fetch = [&](int f0) {
#pragma unroll
          for (int p = 0; p < kPer; ++p) {
            const int r = tid / kDk + p * (kThreads / kDk), c = tid % kDk;
            const int f = f0 + c, ri = ti * kTile + r, rj = tj * kTile + r;
            pa[p] = (ri < b && f < f_hi) ? x[(size_t)ri * d + f] : T(0);
            pb[p] = (rj < b && f < f_hi) ? x[(size_t)rj * d + f] : T(0);
          }
        };
        fetch(f_lo);
        for (int f0 = f_lo; f0 < f_hi; f0 += kDk) {
          __syncthreads();  // the previous step is no longer read
#pragma unroll
          for (int p = 0; p < kPer; ++p) {
            const int r = tid / kDk + p * (kThreads / kDk), c = tid % kDk;
            ta[r * kLd + c] = pa[p];
            tb[r * kLd + c] = pb[p];
          }
          __syncthreads();
          if (f0 + kDk < f_hi) fetch(f0 + kDk);  // overlaps the products
#pragma unroll 8
          for (int c = 0; c < kDk; ++c) {
            T ra[4], rb[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              ra[u] = ta[(ty + 16 * u) * kLd + c];
              rb[u] = tb[(tx + 16 * u) * kLd + c];
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int w = 0; w < 4; ++w) acc[u][w] = acc[u][w] + ra[u] * rb[w];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int i = ti * kTile + ty + 16 * u, j = tj * kTile + tx + 16 * w;
            if (i < b && j < b) gram[(size_t)j * b + i] = acc[u][w];
          }
      }
    }
  }
  cluster.sync();  // every partial is in its block's shared memory
  if (nc > 1) {
    // block r sums its fixed share of the entries over the C partials in
    // rank order, into the leader's arrays (partial 0 is the leader's own)
    if (!frozen) {
      for (int e = tid + kThreads * rank; e < b * b; e += kThreads * nc) {
        const int j = e / b;
        if (e - j * b >= j) continue;  // the chain reads i < j only
        T s = *cluster.map_shared_rank(gram + e, 0);
        for (int q = 1; q < nc; ++q) s = s + *cluster.map_shared_rank(gram + e, q);
        *cluster.map_shared_rank(gram + e, 0) = s;
      }
    }
    for (int j = rank + nc * tid; j < b; j += nc * kThreads) {
      T s = *cluster.map_shared_rank(m0 + j, 0);
      for (int q = 1; q < nc; ++q) s = s + *cluster.map_shared_rank(m0 + j, q);
      *cluster.map_shared_rank(m0 + j, 0) = s;
    }
    cluster.sync();  // the leader holds the sums
  }
  if (rank == 0) {
    if (warp == 0)
      chain_warp<T, R>(b, m0, nullptr, ys, qs, as0, ls, ix,
                       frozen ? nullptr : gram, b, coef, delta, loss, lam_n,
                       coef_div, sig_eff, smoothing);
    __syncthreads();
    for (int t = tid; t < b; t += kThreads)
      delta_out[(size_t)k * b + t] = delta[t];
    for (int t = tid; t < (nc - 1) * b; t += kThreads) {
      const int q = 1 + t / b, j = t - (q - 1) * b;
      *cluster.map_shared_rank(coef + j, q) = coef[j];
    }
  }
  cluster.sync();  // every block holds the coefficients
  for (int f = f_lo + tid; f < f_hi; f += kThreads) {
    T acc = T(0);
    for (int j = 0; j < b; ++j) acc = acc + coef[j] * x[(size_t)j * d + f];
    dwu_out[(size_t)k * d + f] = acc;
  }
}

// B3's shared memory: the 2 * stages mbarriers, the ring, the six step
// scalars and coef and delta.  ops/block_chain.py chain_smem_bytes is the
// same sum.
size_t chain_smem(int b, int stages, int cols, size_t itemsize) {
  return 16 * (size_t)stages +
         ((size_t)(cols + 1) * slot_rows_before(b, cols, stages) +
          8 * (size_t)b) * itemsize;
}

// A B3 plan: B in 1..1024, units of 32, 16 or 8 columns, 1..ceil(B / cols)
// slots.
inline bool chain_plan_ok(int b, int stages, int cols) {
  if (b < 1 || b > 1024) return false;
  if (cols != 32 && cols != 16 && cols != 8) return false;
  return stages >= 1 && stages <= (b + cols - 1) / cols;
}

size_t fused_smem(int b, size_t itemsize, int frozen) {
  return ((frozen ? 0 : (size_t)b * b) + 7 * (size_t)b + 2 * kTile * kLd) *
             itemsize + (size_t)b * sizeof(int);
}

template <typename T>
int launch_chain(const T* scal, const T* gram, const int* idx, T* delta,
                 T* coef, int k, int b, int stages, int cols, int loss,
                 double lam_n, double coef_div, double sig_eff,
                 double smoothing, void* stream) {
  if (k < 1 || !chain_plan_ok(b, stages, cols))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = chain_smem(b, stages, cols, sizeof(T));
  if (bytes > (size_t)sdca::smem_optin()) return (int)cudaErrorInvalidValue;
  auto kern = b <= 128 ? &chain_kernel<T, 4> : b <= 256 ? &chain_kernel<T, 8>
            : b <= 512 ? &chain_kernel<T, 16> : &chain_kernel<T, 32>;
  cudaError_t err = sdca::allow_smem(kern, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<k, kChainThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      scal, gram, idx, delta, coef, b, stages, cols, loss, T(lam_n),
      T(coef_div), T(sig_eff), T(smoothing));
  return (int)cudaGetLastError();
}

template <typename T>
using FusedFn = void (*)(const T*, const int*, const T*, const T*, const T*,
                         const T*, const T*, T*, T*, int, int, int, int, T,
                         T, T, T, int);

// The fused kernel for B, with its shared memory opted in and, above 8
// blocks a cluster, the non-portable cluster size allowed.
template <typename T>
cudaError_t fused_kernel_for(int b, int cluster, int frozen,
                             FusedFn<T>* out) {
  FusedFn<T> kern = b <= 128 ? &fused_kernel<T, 4>
                   : b <= 256 ? &fused_kernel<T, 8>
                   : b <= 512 ? &fused_kernel<T, 16> : &fused_kernel<T, 32>;
  cudaError_t err = sdca::allow_smem(kern, fused_smem(b, sizeof(T), frozen));
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  *out = kern;
  return err;
}

// A plan is C in 1..kMaxCluster blocks of sw columns covering d, every
// block's slice non-empty, sw a multiple of kDk when C > 1.
inline bool fused_plan_ok(int b, int d, int cluster, int sw) {
  if (b < 1 || b > 1024 || d < 1 || cluster < 1 || cluster > kMaxCluster ||
      sw < 1)
    return false;
  if (cluster > 1 && sw % kDk != 0) return false;
  return (long long)(cluster - 1) * sw < d && (long long)cluster * sw >= d;
}

inline cudaLaunchConfig_t fused_config(int k, int cluster, size_t bytes,
                                       void* stream,
                                       cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, k, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
int launch_fused(const T* xb, const int* idx, const T* yb, const T* qb,
                 const T* a0, const T* live, const T* v, T* delta, T* dwu,
                 int k, int b, int d, int cluster, int sw, int loss,
                 double lam_n, double coef_div, double sig_eff,
                 double smoothing, int frozen, void* stream) {
  if (k < 1 || !fused_plan_ok(b, d, cluster, sw))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = fused_smem(b, sizeof(T), frozen);
  if (bytes > (size_t)sdca::smem_optin()) return (int)cudaErrorInvalidValue;
  FusedFn<T> kern;
  cudaError_t err = fused_kernel_for<T>(b, cluster, frozen, &kern);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = fused_config(k, cluster, bytes, stream,
                                              &attr);
  err = cudaLaunchKernelEx(&cfg, kern, xb, idx, yb, qb, a0, live, v, delta,
                           dwu, b, d, sw, loss, T(lam_n), T(coef_div),
                           T(sig_eff), T(smoothing), frozen);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of ``cluster`` fused blocks the card can hold at once
// (cudaOccupancyMaxActiveClusters), written to *out.
template <typename T>
int fused_clusters(int b, int cluster, int frozen, int* out) {
  *out = 0;
  if (!fused_plan_ok(b, kDk * cluster, cluster, kDk))
    return (int)cudaErrorInvalidValue;
  FusedFn<T> kern;
  cudaError_t err = fused_kernel_for<T>(b, cluster, frozen, &kern);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = fused_config(
      1, cluster, fused_smem(b, sizeof(T), frozen), nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}

}  // namespace

// Plain C entry points for ctypes.  Every tensor is contiguous; indices
// are int32; ``gram`` is null in frozen mode.  Outputs are written whole.
// Returns the launch's error or cudaGetLastError() (cudaErrorInvalidValue
// for a chain plan that breaks chain_plan_ok's rules, a fused plan that
// breaks fused_plan_ok's, or a working set above the shared-memory
// opt-in).
#define CHAIN_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const T* scal, const T* gram, const int* idx,         \
                      T* delta, T* coef, int k, int b, int stages,          \
                      int cols, int loss, double lam_n, double coef_div,    \
                      double sig_eff, double smoothing, void* stream) {     \
    return launch_chain<T>(scal, gram, idx, delta, coef, k, b, stages,      \
                           cols, loss, lam_n, coef_div, sig_eff, smoothing, \
                           stream);                                         \
  }
CHAIN_ENTRY(chain_block_batched_f32, float)
CHAIN_ENTRY(chain_block_batched_f64, double)

#define FUSED_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const T* xb, const int* idx, const T* yb,             \
                      const T* qb, const T* a0, const T* live, const T* v,  \
                      T* delta, T* dwu, int k, int b, int d, int cluster,   \
                      int sw, int loss, double lam_n, double coef_div,      \
                      double sig_eff, double smoothing, int frozen,         \
                      void* stream) {                                       \
    return launch_fused<T>(xb, idx, yb, qb, a0, live, v, delta, dwu, k, b,  \
                           d, cluster, sw, loss, lam_n, coef_div, sig_eff,  \
                           smoothing, frozen, stream);                      \
  }
FUSED_ENTRY(fused_block_f32, float)
FUSED_ENTRY(fused_block_f64, double)

extern "C" int fused_block_clusters(int itemsize, int b, int cluster,
                                    int frozen, int* out) {
  return itemsize == 8 ? fused_clusters<double>(b, cluster, frozen, out)
                       : fused_clusters<float>(b, cluster, frozen, out);
}

// The kernels, for SDCA_KERNEL_INFO (analysis/kernel_budget.py looks them
// up by name).
namespace {
const sdca::KernelEntry kKernels[] = {
    {"chain_kernel<float,4>", (const void*)&chain_kernel<float, 4>},
    {"chain_kernel<float,8>", (const void*)&chain_kernel<float, 8>},
    {"chain_kernel<float,16>", (const void*)&chain_kernel<float, 16>},
    {"chain_kernel<float,32>", (const void*)&chain_kernel<float, 32>},
    {"chain_kernel<double,4>", (const void*)&chain_kernel<double, 4>},
    {"chain_kernel<double,8>", (const void*)&chain_kernel<double, 8>},
    {"chain_kernel<double,16>", (const void*)&chain_kernel<double, 16>},
    {"chain_kernel<double,32>", (const void*)&chain_kernel<double, 32>},
    {"fused_kernel<float,4>", (const void*)&fused_kernel<float, 4>},
    {"fused_kernel<float,8>", (const void*)&fused_kernel<float, 8>},
    {"fused_kernel<float,16>", (const void*)&fused_kernel<float, 16>},
    {"fused_kernel<float,32>", (const void*)&fused_kernel<float, 32>},
    {"fused_kernel<double,4>", (const void*)&fused_kernel<double, 4>},
    {"fused_kernel<double,8>", (const void*)&fused_kernel<double, 8>},
    {"fused_kernel<double,16>", (const void*)&fused_kernel<double, 16>},
    {"fused_kernel<double,32>", (const void*)&fused_kernel<double, 32>},
};
}  // namespace
SDCA_KERNEL_INFO(kKernels)

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
