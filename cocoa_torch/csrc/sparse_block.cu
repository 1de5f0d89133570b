// The sparse block round's Gram (B5) and Delta-w apply (B6), for Hopper
// (sm_90a), on the padded-CSR rows of one block: gidx / gval (K, B, W),
// cnts (K, B) the rows' lengths (-1 marks a masked step, which reads
// nothing and gives zeros).
//
// Replaces the TPU kernels cocoa_tpu/ops/pallas_sparse.py
// sparse_block_gram (body _gram_kernel) and sparse_block_apply (body
// _apply_kernel):
//   gram[k, j, i] = x_i . x_j for i < j, 0 elsewhere (row j of shard k is
//                   contiguous; the chain reads only i < j);
//   mb[k, j]      = x_j . (w + sig_eff * dw_k)   (frozen mode: x_j . w);
//   dw_k         += sum_j coef_kj * x_j           (the apply).
// A column repeated within a row sums, as the dense expansion of the
// plain version sums it, and padded slots past a row's length are never
// read; column 0 is a column like any other.
//
// What bounds it on this card: the Gram is K * B^2 / 2 sparse dot
// products of rows of ~nnz entries, against ~K * B * nnz distinct input
// slots (77 KB at rcv1-like float32); the apply is a scatter of K * B *
// nnz adds, and its rows must stay in order.  Both are latency-bound at
// these sizes: a lookup of one row's column in another row.
//
// What the Gram's design (gram_kernel) does about it:
// - grid (T, K): block (t, k) owns the rows i = t, t + T, ... of shard k
//   (``tables`` of them, a power of two, at most kMaxTables), round-robin,
//   so the triangle's work spreads evenly over the blocks.
// - one open-addressing hash table a row it owns, in shared memory:
//   ``slots`` (a power of two above W; the plan's default at least 2 W:
//   2048 at rcv1-like W = 548) slots of an int32 column key (-1 empty)
//   beside its value, read with one load, multiplicative hashing, linear
//   probing.  A warp builds one table, 32 entries at a time in slot
//   order: __match_any_sync groups a chunk's equal columns, the group's
//   lowest lane sums their values in lane order and claims the key with
//   atomicCAS, then adds the sum to the slot's value; chunks are ordered
//   by __syncwarp.  So a repeated column's value does not depend on
//   timing, and two launches agree bit for bit; only the slot a key lands
//   in may.  The same warp writes mb[k, i] (lane-strided products, a
//   shuffle butterfly).
// - each later row j (j > t) of the shard is read once by the block: its
//   8 warps take the rows j = t + 1 + w, t + 9 + w, ..., each staging its
//   next row in a second shared-memory buffer by cp.async while it probes
//   the current one (a lane reads back only the entries it copied, so
//   cp.async.wait_group alone orders them).  A lane looks each of its
//   entries up in the tables of the owned rows i < j, the first probes of
//   all tables issued together, the tables that collided walking on
//   together one slot a round, and one butterfly a table, the tables'
//   shuffles interleaved, gives gram[k, j, i].  The probe loop reads only
//   shared memory; the shard's row lengths are staged there first.
// - the entries j <= i of the owned columns are written as zeros, so the
//   (K, B, B) Gram is written whole; a masked row builds an empty table
//   and probes nothing.  Frozen mode builds no table.
// - ops/sparse_block.py gram_plan picks (T, slots) against the
//   shared-memory opt-in; the kernel refuses a plan it cannot hold.
//
// The apply's design (apply_kernel):
// - grid K; one block per shard walks rows j = 0..B-1 in order,
//   threads over the row's slots, a barrier between rows.  Every column
//   receives its adds in the row order of the TPU kernel (and of the
//   plain version on the CPU), so the result is the same from run to run;
//   atomics only resolve a column repeated within one row.  The product
//   coef * v is rounded before the add (__fmul_rn / __dmul_rn: no
//   contraction into an FMA), as the plain version rounds it.
// - the TPU kernels' SMEM row segmentation, GROUP-rounded trip counts and
//   lane-concatenated [w | dw] array are TPU addressing, not math; here w
//   is (d,) and dw is (K, d).

#include <cuda_runtime.h>

#include "sdca_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTables = 8;            // owned rows a Gram block, at most
constexpr unsigned kHashMul = 2654435769u;  // 2^32 / golden ratio

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

__device__ __forceinline__ int hash_slot(int col, int bits) {
  return bits == 0 ? 0 : (int)(((unsigned)col * kHashMul) >> (32 - bits));
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(__cvta_generic_to_global(src)), "n"(sizeof(T))
               : "memory");
}

// A table slot: an int32 column key (-1 empty) and its value, read with
// one shared-memory load.
template <typename T>
struct __align__(2 * sizeof(T)) Slot {
  int key;
  T val;
};

// Insert one 32-entry chunk of a row into its table (2^bits slots), on
// one warp: lane l holds entry base + l (``ok`` when it is inside the
// row).  Equal columns of the chunk are summed in lane order by the
// group's lowest lane, which claims the key and adds the sum.
template <typename T>
__device__ __forceinline__ void insert_chunk(Slot<T>* tab, int f, T v,
                                             bool ok, int lane, int bits) {
  const unsigned same =
      __match_any_sync(0xffffffffu, ok ? f : -1 - lane);
  T sum = v;
  if (__any_sync(0xffffffffu, same != (1u << lane))) {
    sum = T(0);
    for (int src = 0; src < 32; ++src) {
      const T vs = __shfl_sync(0xffffffffu, v, src);
      if ((same >> src) & 1u) sum = sum + vs;
    }
  }
  if (ok && __ffs(same) - 1 == lane) {
    const int mask = (1 << bits) - 1;
    int pos = hash_slot(f, bits);
    while (true) {
      const int old = atomicCAS(&tab[pos].key, -1, f);
      if (old == -1 || old == f) break;
      pos = (pos + 1) & mask;
    }
    tab[pos].val = tab[pos].val + sum;
  }
  __syncwarp();  // this chunk's adds precede the next chunk's
}

// B5: grid (T, K), kThreads threads; block (t, k) owns rows t + o * T of
// shard k, o < kTables.  Shared memory: the tables, each warp's two row
// buffers (values, then columns), the shard's row lengths.
template <typename T, int kTables>
__global__ void __launch_bounds__(kThreads) gram_kernel(
    const T* __restrict__ w, const T* __restrict__ dw,
    const int* __restrict__ gidx, const T* __restrict__ gval,
    const int* __restrict__ cnts, T* __restrict__ gram, T* __restrict__ mb,
    int b, int width, int d, int nt, int bits, T sig_eff, int frozen) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slots = 1 << bits, mask = slots - 1;
  Slot<T>* tab = reinterpret_cast<Slot<T>*>(smem_raw);
  T* bv = reinterpret_cast<T*>(tab + kTables * slots);
  int* bc = reinterpret_cast<int*>(bv + 2 * kWarps * width);
  int* kc = bc + 2 * kWarps * width;
  const int t = blockIdx.x, k = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int* rc = gidx + (size_t)k * b * width;
  const T* rv = gval + (size_t)k * b * width;
  for (int e = tid; e < b; e += kThreads) kc[e] = cnts[(size_t)k * b + e];
  if (!frozen) {
    for (int e = tid; e < kTables * slots; e += kThreads)
      tab[e] = Slot<T>{-1, T(0)};
    // the entries j <= i of the owned columns i
    for (int e = tid; e < kTables * b; e += kThreads) {
      const int o = e / b, j = e - o * b, i = t + o * nt;
      if (i < b && j <= i) gram[((size_t)k * b + j) * b + i] = T(0);
    }
  }
  __syncthreads();
  if (warp < kTables && t + warp * nt < b) {  // owned row i: table and mb
    const int i = t + warp * nt, cnt = kc[i];
    const int* ci = rc + (size_t)i * width;
    const T* vi = rv + (size_t)i * width;
    T acc = T(0);
    // the next chunk's entries are loaded while this one is inserted
    int f = lane < cnt ? ci[lane] : 0;
    T v = lane < cnt ? vi[lane] : T(0);
    for (int base = 0; base < cnt; base += 32) {
      const int e = base + lane, en = e + 32;
      const bool ok = e < cnt;
      const int fn = en < cnt ? ci[en] : 0;
      const T vn = en < cnt ? vi[en] : T(0);
      T coord = T(0);
      if (ok) {
        coord = w[f];
        if (!frozen) coord = coord + sig_eff * dw[(size_t)k * d + f];
      }
      if (!frozen) insert_chunk(tab + warp * slots, f, v, ok, lane, bits);
      if (ok) acc = acc + v * coord;
      f = fn;
      v = vn;
    }
    acc = sdca::warp_sum(acc);
    if (lane == 0) mb[(size_t)k * b + i] = acc;
  }
  if (frozen) return;
  __syncthreads();  // every table is built
  int* mc = bc + 2 * warp * width;
  T* mv = bv + 2 * warp * width;
  // stage row ``row`` (if any) into buffer ``buf``; returns its length
  auto stage = [&](int row, int buf) {
    const int cnt = row < b ? max(kc[row], 0) : 0;
    for (int e = lane; e < cnt; e += 32) {
      cp_async(mc + buf * width + e, rc + (size_t)row * width + e);
      cp_async(mv + buf * width + e, rv + (size_t)row * width + e);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    return cnt;
  };
  int j = t + 1 + warp;
  int cnt = stage(j, 0);
  for (int n = 0; j < b; ++n, j += kWarps) {
    const int cnt_next = stage(j + kWarps, (n + 1) & 1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    const int* cb = mc + (n & 1) * width;
    const T* vb = mv + (n & 1) * width;
    T acc[kTables];
#pragma unroll
    for (int o = 0; o < kTables; ++o) acc[o] = T(0);
    for (int e = lane; e < cnt; e += 32) {
      const int f = cb[e];
      const T v = vb[e];
      const int h = hash_slot(f, bits);
      Slot<T> hit[kTables];
      // every table's first probe, issued together (a table of a row i
      // >= j is read and not used: loading only the tables of rows i < j
      // measured slower)
#pragma unroll
      for (int o = 0; o < kTables; ++o) hit[o] = tab[o * slots + h];
      // a collision at the first probe: every such table walks on one
      // slot a round, the loads of a round issued together
      for (int step = 1;; ++step) {
        bool walk = false;
#pragma unroll
        for (int o = 0; o < kTables; ++o)
          walk |= t + o * nt < j && hit[o].key != f && hit[o].key != -1;
        if (!walk) break;
#pragma unroll
        for (int o = 0; o < kTables; ++o)
          if (t + o * nt < j && hit[o].key != f && hit[o].key != -1)
            hit[o] = tab[o * slots + ((h + step) & mask)];
      }
#pragma unroll
      for (int o = 0; o < kTables; ++o)
        if (t + o * nt < j && hit[o].key == f)
          acc[o] = acc[o] + v * hit[o].val;
    }
    // the tables' butterflies interleaved, each in sdca::warp_sum's order
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int o = 0; o < kTables; ++o)
        acc[o] = acc[o] + __shfl_xor_sync(0xffffffffu, acc[o], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int o = 0; o < kTables; ++o) {
        const int i = t + o * nt;
        if (i < j) gram[((size_t)k * b + j) * b + i] = acc[o];
      }
    }
    cnt = cnt_next;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads) apply_kernel(
    T* __restrict__ dw, const int* __restrict__ gidx,
    const T* __restrict__ gval, const int* __restrict__ cnts,
    const T* __restrict__ coefs, int b, int width, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);
  int* ns = reinterpret_cast<int*>(cs + b);
  const int k = blockIdx.x, tid = threadIdx.x;
  for (int t = tid; t < b; t += kThreads) {
    cs[t] = coefs[(size_t)k * b + t];
    ns[t] = cnts[(size_t)k * b + t];
  }
  __syncthreads();
  T* dwk = dw + (size_t)k * d;
  for (int j = 0; j < b; ++j) {
    const size_t row = ((size_t)k * b + j) * width;
    const T c = cs[j];
    for (int t = tid; t < ns[j]; t += kThreads)
      atomicAdd(dwk + gidx[row + t], mul_rn(c, gval[row + t]));
    __syncthreads();  // row j's adds precede row j+1's
  }
}

// The tables a Gram block needs for nt blocks a shard: ceil(b / nt)
// rounded up to a power of two.
inline int gram_tables(int b, int nt) {
  const int rows = (b + nt - 1) / nt;
  int tables = 1;
  while (tables < rows) tables *= 2;
  return tables;
}

// B5's shared memory: the tables (a slot holds the key beside its value,
// two values wide), each warp's two row buffers (a value and an int32
// column an entry) and the B row lengths.  ops/sparse_block.py
// gram_smem_bytes is the same sum.
size_t gram_smem(int tables, int slots, int width, int b, size_t itemsize) {
  return (size_t)tables * slots * 2 * itemsize +
         2 * (size_t)kWarps * width * (itemsize + sizeof(int)) +
         (size_t)b * sizeof(int);
}

// A Gram plan: nt in 1..b blocks a shard, at most kMaxTables rows each,
// a power-of-two table of more slots than a row has entries.
inline bool gram_plan_ok(int b, int width, int nt, int slots) {
  if (b < 1 || width < 0 || nt < 1 || nt > b) return false;
  if (gram_tables(b, nt) > kMaxTables) return false;
  return slots > width && slots <= (1 << 24) && (slots & (slots - 1)) == 0;
}

template <typename T>
using GramFn = void (*)(const T*, const T*, const int*, const T*, const int*,
                        T*, T*, int, int, int, int, int, T, int);

template <typename T>
int launch_gram(const T* w, const T* dw, const int* gidx, const T* gval,
                const int* cnts, T* gram, T* mb, int k, int b, int width,
                int d, int nt, int slots, double sig_eff, int frozen,
                void* stream) {
  if (k < 1 || !gram_plan_ok(b, width, nt, slots))
    return (int)cudaErrorInvalidValue;
  const int tables = gram_tables(b, nt);
  const size_t bytes = gram_smem(tables, slots, width, b, sizeof(T));
  if (bytes > (size_t)sdca::smem_optin()) return (int)cudaErrorInvalidValue;
  const GramFn<T> kern = tables == 1 ? &gram_kernel<T, 1>
                       : tables == 2 ? &gram_kernel<T, 2>
                       : tables == 4 ? &gram_kernel<T, 4>
                                     : &gram_kernel<T, 8>;
  cudaError_t err = sdca::allow_smem(kern, bytes);
  if (err != cudaSuccess) return (int)err;
  int bits = 0;
  while ((1 << bits) < slots) ++bits;
  kern<<<dim3(nt, k), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      w, dw, gidx, gval, cnts, gram, mb, b, width, d, nt, bits, T(sig_eff),
      frozen);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(T* dw, const int* gidx, const T* gval, const int* cnts,
                 const T* coefs, int k, int b, int width, int d,
                 void* stream) {
  const size_t bytes = (size_t)b * (sizeof(T) + sizeof(int));
  cudaError_t err = sdca::allow_smem(apply_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  apply_kernel<T><<<k, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      dw, gidx, gval, cnts, coefs, b, width, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  Every tensor is contiguous; indices
// are int32.  ``gram`` (K, B, B) and ``mb`` (K, B) are written whole
// (``gram`` is null in frozen mode); (nt, slots) is the Gram's plan.
// ``dw`` is advanced in place by the apply.  Returns the launch's error
// or cudaGetLastError() (cudaErrorInvalidValue for a Gram plan that
// breaks gram_plan_ok's rules or does not fit the shared-memory opt-in).
#define GRAM_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const T* w, const T* dw, const int* gidx,             \
                      const T* gval, const int* cnts, T* gram, T* mb,       \
                      int k, int b, int width, int d, int nt, int slots,    \
                      double sig_eff, int frozen, void* stream) {           \
    return launch_gram<T>(w, dw, gidx, gval, cnts, gram, mb, k, b, width,   \
                          d, nt, slots, sig_eff, frozen, stream);           \
  }
GRAM_ENTRY(sparse_block_gram_f32, float)
GRAM_ENTRY(sparse_block_gram_f64, double)

#define APPLY_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(T* dw, const int* gidx, const T* gval,                \
                      const int* cnts, const T* coefs, int k, int b,        \
                      int width, int d, void* stream) {                     \
    return launch_apply<T>(dw, gidx, gval, cnts, coefs, k, b, width, d,     \
                           stream);                                         \
  }
APPLY_ENTRY(sparse_block_apply_f32, float)
APPLY_ENTRY(sparse_block_apply_f64, double)

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
