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
// nnz adds, and each column's adds must stay in order.  Both are
// latency-bound at these sizes: a lookup of one row's column in another
// row, a chain of adds into one column.
//
// What the Gram's design (gram_kernel) does about it:
// - grid (T, K): block (t, k) owns the rows i = t, t + T, ... of shard k
//   (``tables`` of them, a power of two, at most kMaxTables), round-robin,
//   so the triangle's work spreads evenly over the blocks.
// - one open-addressing hash table a row it owns, in shared memory:
//   ``slots`` (a power of two above the entries a pass inserts; the
//   plan's default at least 2 W: 2048 at rcv1-like W = 548) slots of an
//   int32 column key (-1 empty)
//   beside its value, read with one load, multiplicative hashing, linear
//   probing.  A warp builds one table, 32 entries at a time in slot
//   order: __match_any_sync groups a chunk's equal columns, the group's
//   lowest lane sums their values in lane order and claims the key with
//   atomicCAS, then adds the sum to the slot's value; chunks are ordered
//   by __syncwarp.  So a repeated column's value does not depend on
//   timing, and two launches agree bit for bit; only the slot a key lands
//   in may.  The same warp writes mb[k, i] (lane-strided products, a
//   shuffle butterfly).
// - each later row j (j > t) of the shard is read once (once a pass) by
//   the block: its 8 warps take the rows j = t + 1 + w, t + 9 + w, ...,
//   each warp staging its next row (next chunk) in a second shared-memory
//   buffer by cp.async while it probes the current one (a lane reads back
//   only the entries it copied, so cp.async.wait_group alone orders
//   them).  gram_kernel stages whole rows, where two rows a warp fit
//   beside the tables; gram_pass_kernel stages chunks of ``chunk`` (256)
//   entries, a multiple of 32, so lane l holds entries l + 32 m of the
//   row in every chunk and its sums keep the row's order: the same bits
//   as whole rows.  A lane looks each of its entries up in the tables
//   of the owned rows i < j, the first probes of all tables issued
//   together, the tables that collided walking on together one slot a
//   round, and one butterfly a table at the row's end, the tables'
//   shuffles interleaved, gives gram[k, j, i].  The probe loop reads only
//   shared memory; the shard's row lengths are staged there first.
// - passes (gram_pass_kernel), for rows whose table does not fit: a
//   table takes at most ``cap`` entries of its row (a multiple of 32
//   below the slots), and pass p builds entries [p cap, (p + 1) cap) of
//   every owned row, then
//   streams the later rows against them; pass 0 writes each dot, a later
//   pass adds its part for the owned rows that still had entries, on the
//   same lane of the same warp, in pass order, so the sum does not depend
//   on timing.  A column repeated within a row sums in slot order inside
//   a pass; its entries in two passes reach the Gram as two partial dots.
//   The margin base is summed over the passes in the row's order.  cap >=
//   W (every plan whose tables of >= 2 W slots fit) is one pass.
// - the entries j <= i of the owned columns are written as zeros, so the
//   (K, B, B) Gram is written whole; a masked row builds an empty table
//   and probes nothing.  Frozen mode builds no table.
// - ops/sparse_block.py gram_plan picks (T, slots, chunk, cap) against
//   the shared-memory opt-in, for rows of any width; the kernel refuses a
//   plan it cannot hold.
//
// The apply's design (apply_kernel), for a scatter whose order must hold:
// - grid (S, K), S a power of two: block (t, k) owns the columns t + i S
//   of shard k's dw and keeps them in shared memory, read once, and
//   writes back once those an entry reached.  Interleaved, not
//   contiguous: LIBSVM data puts its frequent columns together (rcv1-like
//   data: 69 % of a block's entries fall in the first sixteenth of the
//   columns), and the slowest block is the kernel's time.  ops/sparse_block.py apply_plan picks S so that K S
//   blocks fill the card's SMs (16 slices of 2953 columns at the
//   rcv1-like block: 128 blocks), more where a slice would not fit.
// - every block reads the shard's live prefixes (the first cnts slots of
//   each row, never the padding) as one stream in (row, slot) order, in
//   chunks of ``chunk`` entries staged by cp.async into two shared-memory
//   buffers: the next chunk is in flight while this one is used, and no
//   global load waits behind an ordering point.
// - each chunk is compacted to the entries in the block's slice, in
//   (row, slot) order (a warp's ballots and the warps' counts give each
//   entry its place), with the product coef * v rounded before the add
//   (__fmul_rn / __dmul_rn: no contraction into an FMA), as the plain
//   version rounds it.
// - warp w owns the slice's columns f with f % 16 == w (16 warps: more
//   shared-memory chains in flight) and folds the list
//   32 entries at a time into the slice, starting from dw's value; a
//   column met more than once among 32 entries (a column repeated within
//   a row, or a hot column of many rows) is folded in lane order in its
//   lowest lane's register.  So each column's adds are a strict left fold
//   in (row, slot) order: the TPU kernel's order and that of the plain
//   version's scatter_add_ on the CPU, bit for bit, with no atomics and no
//   barrier a row (three a chunk).
// - the TPU kernels' SMEM row segmentation, GROUP-rounded trip counts and
//   lane-concatenated [w | dw] array are TPU addressing, not math; here w
//   is (d,) and dw is (K, d).

#include <cuda_runtime.h>

#include "sdca_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTables = 8;            // owned rows a Gram block, at most
constexpr int kApplyThreads = 512;       // the apply: more warps in flight
constexpr int kApplyWarps = kApplyThreads / 32;
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

// B5 on rows in chunks, in passes: gram_kernel's walk, with each warp's
// two buffers of ``chunk`` entries (values, then columns) in place of two
// whole rows, and an owned row's entries put in its table ``cap`` at a
// time: pass p builds entries [p cap, (p + 1) cap) and streams the later
// rows against them, adding its partial dots to the Gram.  A kernel of
// its own: folding the chunk and pass bookkeeping into gram_kernel made
// the whole-row plans 5-11 % slower on the card.
template <typename T, int kTables>
__global__ void __launch_bounds__(kThreads) gram_pass_kernel(
    const T* __restrict__ w, const T* __restrict__ dw,
    const int* __restrict__ gidx, const T* __restrict__ gval,
    const int* __restrict__ cnts, T* __restrict__ gram, T* __restrict__ mb,
    int b, int width, int d, int nt, int bits, int chunk, int cap,
    T sig_eff, int frozen) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slots = 1 << bits, mask = slots - 1;
  Slot<T>* tab = reinterpret_cast<Slot<T>*>(smem_raw);
  T* bv = reinterpret_cast<T*>(tab + kTables * slots);
  int* bc = reinterpret_cast<int*>(bv + 2 * kWarps * chunk);
  int* kc = bc + 2 * kWarps * chunk;
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
  // the passes: as many as the longest owned row needs (frozen mode
  // builds no table and reads each owned row whole, in one)
  int passes = 1;
  if (!frozen)
    for (int o = 0; o < kTables; ++o)
      if (t + o * nt < b)
        passes = max(passes, (max(kc[t + o * nt], 0) + cap - 1) / cap);
  const int own = t + warp * nt;
  const bool owner = warp < kTables && own < b;
  const int own_cnt = owner ? kc[own] : 0;
  // the pass that ends the owned row, where its margin base is written
  const int own_last = frozen || own_cnt <= 0 ? 0 : (own_cnt - 1) / cap;
  int* mc = bc + 2 * warp * chunk;
  T* mv = bv + 2 * warp * chunk;
  T macc = T(0);  // the owned row's margin base, summed over the passes
  for (int p = 0; p < passes; ++p) {
    if (p > 0) {
      __syncthreads();  // the last pass's probes are done
      for (int e = tid; e < kTables * slots; e += kThreads)
        tab[e] = Slot<T>{-1, T(0)};
      __syncthreads();
    }
    if (owner) {  // owned row i: this pass's entries into its table, mb
      const int lo = frozen ? 0 : p * cap;
      const int hi = frozen ? own_cnt : min(own_cnt, lo + cap);
      const int* ci = rc + (size_t)own * width;
      const T* vi = rv + (size_t)own * width;
      // the next chunk's entries are loaded while this one is inserted
      int f = lo + lane < hi ? ci[lo + lane] : 0;
      T v = lo + lane < hi ? vi[lo + lane] : T(0);
      for (int base = lo; base < hi; base += 32) {
        const int e = base + lane, en = e + 32;
        const bool ok = e < hi;
        const int fn = en < hi ? ci[en] : 0;
        const T vn = en < hi ? vi[en] : T(0);
        T coord = T(0);
        if (ok) {
          coord = w[f];
          if (!frozen) coord = coord + sig_eff * dw[(size_t)k * d + f];
        }
        if (!frozen) insert_chunk(tab + warp * slots, f, v, ok, lane, bits);
        if (ok) macc = macc + v * coord;
        f = fn;
        v = vn;
      }
      if (p == own_last) {
        const T sum = sdca::warp_sum(macc);
        if (lane == 0) mb[(size_t)k * b + own] = sum;
      }
    }
    if (frozen) return;
    __syncthreads();  // every table of this pass is built
    // stage entries [c chunk, c chunk + chunk) of row ``row`` (if any)
    // into buffer ``buf``; returns how many
    auto stage = [&](int row, int c, int buf) {
      const int left = row < b ? max(kc[row], 0) - c * chunk : 0;
      const int cnt = max(0, min(left, chunk));
      const size_t at = (size_t)row * width + (size_t)c * chunk;
      for (int e = lane; e < cnt; e += 32) {
        cp_async(mc + buf * chunk + e, rc + at + e);
        cp_async(mv + buf * chunk + e, rv + at + e);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      return cnt;
    };
    // the units (row j, chunk c) of this warp's rows j = t + 1 + warp,
    // t + 9 + warp, ..., in order; a row of no entries is one empty unit
    int j = t + 1 + warp, c = 0;
    int len = stage(j, 0, 0);
    T acc[kTables];
#pragma unroll
    for (int o = 0; o < kTables; ++o) acc[o] = T(0);
    for (int n = 0; j < b; ++n) {
      int jn = j, cn = c + 1;
      if (cn * chunk >= kc[j]) {  // row j's last chunk: next, row j + 8
        jn = j + kWarps;
        cn = 0;
      }
      const int len_next = stage(jn, cn, (n + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      const int* cb = mc + (n & 1) * chunk;
      const T* vb = mv + (n & 1) * chunk;
      // a lane's entries are c chunk + lane + 32 m: chunk is a multiple
      // of 32 (or the whole row), so each acc sums in the row's order
      for (int e = lane; e < len; e += 32) {
        const int f = cb[e];
        const T v = vb[e];
        const int h = hash_slot(f, bits);
        Slot<T> hit[kTables];
        // every table's first probe, issued together (a table of a row i
        // >= j is read and not used: loading only the tables of rows i <
        // j measured slower)
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
      if (jn != j) {  // row j is done: its dots with the owned rows
        // the tables' butterflies interleaved, each in sdca::warp_sum's
        // order
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int o = 0; o < kTables; ++o)
            acc[o] = acc[o] + __shfl_xor_sync(0xffffffffu, acc[o], off);
        }
        if (lane == 0) {
          // pass 0 writes the dot; a later pass adds its part for the
          // owned rows that still had entries, in pass order
#pragma unroll
          for (int o = 0; o < kTables; ++o) {
            const int i = t + o * nt;
            if (i < j && p == 0) gram[((size_t)k * b + j) * b + i] = acc[o];
            else if (i < j && p * cap < kc[i])
              gram[((size_t)k * b + j) * b + i] += acc[o];
          }
        }
#pragma unroll
        for (int o = 0; o < kTables; ++o) acc[o] = T(0);
      }
      j = jn;
      c = cn;
      len = len_next;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
}

// The slice that owns column f of d (-1 for a column outside 0..d-1).
__device__ __forceinline__ int slice_of(int f, int d, int smask) {
  return (unsigned)f < (unsigned)d ? f & smask : -1;
}

// The row of entry g of a shard's concatenated live prefixes: the last
// row j < b whose first entry off[j] is at or before g.
__device__ __forceinline__ int row_of(const int* off, int b, int g) {
  int lo = 0, hi = b - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= g) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// B6: grid (S, K), kApplyThreads threads, S = 2^sbits; block (t, k) owns
// the columns t + i S (i < cols) of shard k's Delta-w, at slice index i.
// Shared memory (apply_smem): the dw slice, the coefficients, two staging
// buffers of ``chunk`` values, the compacted list's values; the row
// offsets, two staging buffers of columns, the list's columns, the warps'
// counts; two buffers of row ids; a byte a slice column.
template <typename T>
__global__ void __launch_bounds__(kApplyThreads) apply_kernel(
    T* __restrict__ dw, const int* __restrict__ gidx,
    const T* __restrict__ gval, const int* __restrict__ cnts,
    const T* __restrict__ coefs, int b, int width, int d, int cols,
    int sbits, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dws = reinterpret_cast<T*>(smem_raw);
  T* cs = dws + cols;
  T* sv = cs + b;
  T* lv = sv + 2 * chunk;
  int* off = reinterpret_cast<int*>(lv + chunk);
  int* sc = off + b + 1;
  int* lc = sc + 2 * chunk;
  int* wt = lc + chunk;
  short* sr = reinterpret_cast<short*>(wt + kApplyWarps);
  unsigned char* hit = reinterpret_cast<unsigned char*>(sr + 2 * chunk);
  const int t = blockIdx.x, k = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int smask = (1 << sbits) - 1;
  const int n_cols = (d - t + smask) >> sbits;  // columns t + i S < d
  const int* rc = gidx + (size_t)k * b * width;
  const T* rv = gval + (size_t)k * b * width;
  T* dwk = dw + (size_t)k * d + t;
  // the dw slice and the coefficients by cp.async, in the first chunk's
  // group: their loads overlap the row offsets' round trip and scan
  for (int i = tid; i < n_cols; i += kApplyThreads) {
    cp_async(dws + i, dwk + ((size_t)i << sbits));
    hit[i] = 0;
  }
  for (int j = tid; j < b; j += kApplyThreads) {
    cp_async(cs + j, coefs + (size_t)k * b + j);
    off[j] = min(max(cnts[(size_t)k * b + j], 0), width);
  }
  __syncthreads();
  if (warp == 0) {  // off[j]: row j's first entry among the live prefixes
    int carry = 0;
    for (int base = 0; base < b; base += 32) {
      const int j = base + lane;
      const int len = j < b ? off[j] : 0;
      int incl = len;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (j < b) off[j] = carry + incl - len;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) off[b] = carry;
  }
  __syncthreads();
  const int total = off[b];
  const int chunks = (total + chunk - 1) / chunk;
  // stage entries [c chunk, c chunk + chunk) of the live prefixes into
  // buffer ``buf``: warp w copies the part of rows ja + w, ja + w + 8, ...
  // inside the chunk, and writes each entry's row beside it
  auto stage = [&](int c, int buf) {
    if (c < chunks) {
      const int g0 = c * chunk, g1 = min(total, g0 + chunk);
      for (int j = row_of(off, b, g0) + warp; j < b && off[j] < g1;
           j += kApplyWarps) {
        const int s0 = max(off[j], g0) - off[j];
        const int s1 = min(off[j + 1], g1) - off[j];
        const int at = buf * chunk + off[j] - g0;
        const size_t src = (size_t)j * width;
        for (int s = s0 + lane; s < s1; s += 32) {
          cp_async(sc + at + s, rc + src + s);
          cp_async(sv + at + s, rv + src + s);
          sr[at + s] = (short)j;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage(0, 0);
  for (int c = 0; c < chunks; ++c) {
    stage(c + 1, (c + 1) & 1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // chunk c is staged, every warp's copies
    const int n = min(total - c * chunk, chunk);
    const int* cb = sc + (c & 1) * chunk;
    const T* vb = sv + (c & 1) * chunk;
    const short* rb = sr + (c & 1) * chunk;
    // compaction: warp w takes entries [e0, e1) of the chunk, 32 at a
    // time; the entries in the slice keep their (row, slot) order
    const int seg = (n + kApplyThreads - 1) / kApplyThreads * 32;
    const int e0 = warp * seg, e1 = min(n, e0 + seg);
    int mine = 0;
    for (int base = e0; base < e1; base += 32) {
      const int e = base + lane;
      const bool in = e < e1 && slice_of(cb[e], d, smask) == t;
      mine += __popc(__ballot_sync(0xffffffffu, in));
    }
    if (lane == 0) wt[warp] = mine;
    __syncthreads();  // every warp's count
    int at = 0, m = 0;
#pragma unroll
    for (int w = 0; w < kApplyWarps; ++w) {
      at += w < warp ? wt[w] : 0;
      m += wt[w];
    }
    for (int base = e0; base < e1; base += 32) {
      const int e = base + lane;
      const int f = e < e1 ? cb[e] : -1;
      const bool in = e < e1 && slice_of(f, d, smask) == t;
      const unsigned bal = __ballot_sync(0xffffffffu, in);
      if (in) {
        const int to = at + __popc(bal & ((1u << lane) - 1u));
        lc[to] = f >> sbits;
        lv[to] = mul_rn(cs[rb[e]], vb[e]);
      }
      at += __popc(bal);
    }
    __syncthreads();  // the list is whole; staging buffer c & 1 is free
    // the fold: warp w owns the slice's columns f with f % kApplyWarps == w
    // and takes the list 32 entries at a time; a column met more than
    // once in 32 entries is folded in lane order in its lowest lane's
    // register, so every column's adds run in (row, slot) order
    for (int base = 0; base < m; base += 32) {
      const int e = base + lane;
      const int f = e < m ? lc[e] : -1;
      const bool own = f >= 0 && (f & (kApplyWarps - 1)) == warp;
      const T p = own ? lv[e] : T(0);
      // the lanes that own no entry share one key: match.any's cost grows
      // with the distinct keys of the warp
      const unsigned grp = __match_any_sync(0xffffffffu, own ? f : -1);
      const int size = own ? __popc(grp) : 0;
      const int rounds = __reduce_max_sync(0xffffffffu, (unsigned)size);
      if (own) hit[f] = 1;
      if (rounds <= 1) {
        if (own) dws[f] = dws[f] + p;
      } else {
        const bool lead = own && __ffs(grp) - 1 == lane;
        T acc = lead ? dws[f] : T(0);
        unsigned rest = grp;
        for (int r = 0; r < rounds; ++r) {
          const T x = __shfl_sync(0xffffffffu, p,
                                  rest ? __ffs(rest) - 1 : lane);
          if (lead && rest) acc = acc + x;
          rest &= rest - 1u;
        }
        if (lead) dws[f] = acc;
      }
      __syncwarp();  // this window's adds precede the next window's
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // only the columns an entry reached: the others hold dw's own bits, and
  // strided stores of the whole slice were a fifth of the kernel's time
  for (int i = tid; i < n_cols; i += kApplyThreads)
    if (hit[i]) dwk[(size_t)i << sbits] = dws[i];
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
// two values wide), each warp's two buffers of ``chunk`` entries (a value
// and an int32 column an entry) and the B row lengths.
// ops/sparse_block.py gram_smem_bytes is the same sum.
size_t gram_smem(int tables, int slots, int chunk, int b, size_t itemsize) {
  return (size_t)tables * slots * 2 * itemsize +
         2 * (size_t)kWarps * chunk * (itemsize + sizeof(int)) +
         (size_t)b * sizeof(int);
}

// A Gram plan: nt in 1..b blocks a shard, at most kMaxTables rows each,
// a power-of-two table of more slots than a pass inserts entries (cap),
// and chunks and passes that are the whole row or multiples of 32 entries
// (so a lane's entries keep the row's order).
inline bool gram_plan_ok(int b, int width, int nt, int slots, int chunk,
                         int cap) {
  if (b < 1 || width < 0 || nt < 1 || nt > b) return false;
  if (gram_tables(b, nt) > kMaxTables) return false;
  if (chunk < 1 || (chunk < width && chunk % 32 != 0)) return false;
  if (cap < 1 || (cap < width && cap % 32 != 0)) return false;
  return cap < slots && slots <= (1 << 24) && (slots & (slots - 1)) == 0;
}

template <typename T>
using GramFn = void (*)(const T*, const T*, const int*, const T*, const int*,
                        T*, T*, int, int, int, int, int, T, int);
template <typename T>
using PassFn = void (*)(const T*, const T*, const int*, const T*,
                        const int*, T*, T*, int, int, int, int, int, int,
                        int, T, int);

template <typename T>
int launch_gram(const T* w, const T* dw, const int* gidx, const T* gval,
                const int* cnts, T* gram, T* mb, int k, int b, int width,
                int d, int nt, int slots, int chunk, int cap, double sig_eff,
                int frozen, void* stream) {
  if (k < 1 || !gram_plan_ok(b, width, nt, slots, chunk, cap))
    return (int)cudaErrorInvalidValue;
  const int tables = gram_tables(b, nt);
  const size_t bytes = gram_smem(tables, slots, chunk, b, sizeof(T));
  if (bytes > (size_t)sdca::smem_optin()) return (int)cudaErrorInvalidValue;
  int bits = 0;
  while ((1 << bits) < slots) ++bits;
  const dim3 grid(nt, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (chunk >= width && cap >= width) {  // whole rows, one pass
    const GramFn<T> kern = tables == 1 ? &gram_kernel<T, 1>
                         : tables == 2 ? &gram_kernel<T, 2>
                         : tables == 4 ? &gram_kernel<T, 4>
                                       : &gram_kernel<T, 8>;
    err = sdca::allow_smem(kern, bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, bytes, s>>>(w, dw, gidx, gval, cnts, gram, mb, b,
                                       width, d, nt, bits, T(sig_eff),
                                       frozen);
  } else {
    const PassFn<T> kern = tables == 1 ? &gram_pass_kernel<T, 1>
                         : tables == 2 ? &gram_pass_kernel<T, 2>
                         : tables == 4 ? &gram_pass_kernel<T, 4>
                                       : &gram_pass_kernel<T, 8>;
    err = sdca::allow_smem(kern, bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, bytes, s>>>(w, dw, gidx, gval, cnts, gram, mb, b,
                                       width, d, nt, bits, chunk, cap,
                                       T(sig_eff), frozen);
  }
  return (int)cudaGetLastError();
}

// B6's shared memory: the dw slice, the B coefficients, two staging
// buffers and the compacted list of ``chunk`` values; the B + 1 row
// offsets, two staging buffers and the list of ``chunk`` int32 columns,
// the warps' counts; two staging buffers of ``chunk`` int16 row ids; a
// byte a slice column, set where an entry reached it.
// ops/sparse_block.py apply_smem_bytes is the same sum.
size_t apply_smem(int cols, int chunk, int b, size_t itemsize) {
  return ((size_t)cols + b + 3 * (size_t)chunk) * itemsize +
         ((size_t)b + 1 + 3 * (size_t)chunk + kApplyWarps) * sizeof(int) +
         2 * (size_t)chunk * sizeof(short) + (size_t)cols;
}

// An apply plan: a power-of-two count of slices, each of at most ``cols``
// columns, that covers d; chunks a multiple of 32 entries; row ids that
// fit an int16.
inline bool apply_plan_ok(int b, int d, int slices, int cols, int chunk) {
  if (b < 1 || b > 32767 || d < 1 || slices < 1 || cols < 1) return false;
  if ((slices & (slices - 1)) != 0 || slices > d) return false;
  if (chunk < 32 || chunk % 32 != 0) return false;
  return (long long)slices * cols >= d;
}

template <typename T>
int launch_apply(T* dw, const int* gidx, const T* gval, const int* cnts,
                 const T* coefs, int k, int b, int width, int d, int slices,
                 int cols, int chunk, void* stream) {
  if (k < 1 || width < 0 || !apply_plan_ok(b, d, slices, cols, chunk))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = apply_smem(cols, chunk, b, sizeof(T));
  if (bytes > (size_t)sdca::smem_optin()) return (int)cudaErrorInvalidValue;
  cudaError_t err = sdca::allow_smem(apply_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  int sbits = 0;
  while ((1 << sbits) < slices) ++sbits;
  apply_kernel<T><<<dim3(slices, k), kApplyThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      dw, gidx, gval, cnts, coefs, b, width, d, cols, sbits, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  Every tensor is contiguous; indices
// are int32.  ``gram`` (K, B, B) and ``mb`` (K, B) are written whole
// (``gram`` is null in frozen mode); (nt, slots, chunk, cap) is the
// Gram's plan.
// ``dw`` is advanced in place by the apply, whose plan is (slices, cols,
// chunk).  Returns the launch's error or cudaGetLastError()
// (cudaErrorInvalidValue for a plan that breaks gram_plan_ok's or
// apply_plan_ok's rules or does not fit the shared-memory opt-in).
#define GRAM_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const T* w, const T* dw, const int* gidx,             \
                      const T* gval, const int* cnts, T* gram, T* mb,       \
                      int k, int b, int width, int d, int nt, int slots,    \
                      int chunk, int cap, double sig_eff, int frozen,       \
                      void* stream) {                                       \
    return launch_gram<T>(w, dw, gidx, gval, cnts, gram, mb, k, b, width,   \
                          d, nt, slots, chunk, cap, sig_eff, frozen,        \
                          stream);                                          \
  }
GRAM_ENTRY(sparse_block_gram_f32, float)
GRAM_ENTRY(sparse_block_gram_f64, double)

#define APPLY_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(T* dw, const int* gidx, const T* gval,                \
                      const int* cnts, const T* coefs, int k, int b,        \
                      int width, int d, int slices, int cols, int chunk,    \
                      void* stream) {                                       \
    return launch_apply<T>(dw, gidx, gval, cnts, coefs, k, b, width, d,     \
                           slices, cols, chunk, stream);                    \
  }
APPLY_ENTRY(sparse_block_apply_f32, float)
APPLY_ENTRY(sparse_block_apply_f64, double)

// The kernels, for SDCA_KERNEL_INFO (analysis/kernel_budget.py looks them
// up by name).
namespace {
const sdca::KernelEntry kKernels[] = {
    {"gram_kernel<float,1>", (const void*)&gram_kernel<float, 1>},
    {"gram_kernel<float,2>", (const void*)&gram_kernel<float, 2>},
    {"gram_kernel<float,4>", (const void*)&gram_kernel<float, 4>},
    {"gram_kernel<float,8>", (const void*)&gram_kernel<float, 8>},
    {"gram_kernel<double,1>", (const void*)&gram_kernel<double, 1>},
    {"gram_kernel<double,2>", (const void*)&gram_kernel<double, 2>},
    {"gram_kernel<double,4>", (const void*)&gram_kernel<double, 4>},
    {"gram_kernel<double,8>", (const void*)&gram_kernel<double, 8>},
    {"gram_pass_kernel<float,1>", (const void*)&gram_pass_kernel<float, 1>},
    {"gram_pass_kernel<float,2>", (const void*)&gram_pass_kernel<float, 2>},
    {"gram_pass_kernel<float,4>", (const void*)&gram_pass_kernel<float, 4>},
    {"gram_pass_kernel<float,8>", (const void*)&gram_pass_kernel<float, 8>},
    {"gram_pass_kernel<double,1>", (const void*)&gram_pass_kernel<double, 1>},
    {"gram_pass_kernel<double,2>", (const void*)&gram_pass_kernel<double, 2>},
    {"gram_pass_kernel<double,4>", (const void*)&gram_pass_kernel<double, 4>},
    {"gram_pass_kernel<double,8>", (const void*)&gram_pass_kernel<double, 8>},
    {"apply_kernel<float>", (const void*)&apply_kernel<float>},
    {"apply_kernel<double>", (const void*)&apply_kernel<double>},
};
}  // namespace
SDCA_KERNEL_INFO(kKernels)

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
