// One sequential SDCA round over K padded-CSR shards, for Hopper (sm_90a).
//
// Replaces the TPU kernel cocoa_tpu/ops/pallas_sparse.py
// pallas_sparse_sdca_round (body _kernel).  For every shard k and every
// step h = 0..H-1, in order:
//   i      = idxs[k, h]
//   margin = sum_j v_j * (w[f_j] + sig_eff * dw_k[f_j])   over row i's
//            first row_len[k, i] slots (frozen mode: sum_j v_j * w[f_j])
//   a'     = alpha_step(loss, alpha[k, i], y * margin, |x|^2 * qii_factor, lam*n)
//   coef   = y * (a' - alpha[k, i]) / coef_div      (a division, as the
//            static JAX path writes it)
//   dw_k[f_j] += coef * v_j
//   alpha[k, i] = a'
//
// What bounds it on this card: each shard is a chain of H dependent steps
// (step h+1 reads the dw and alpha that step h wrote), and there are only
// K shards (4 to 8) for 132 SMs.  The bytes a round must move (about
// K*H*nnz*8 B of sampled rows plus K*d of dw) take microseconds at
// 3.35 TB/s; the round is latency-bound: H times one step's chain.  A
// step's own data is known before the round starts, except dw_k and the
// alpha of a row drawn again: the draw, the row's length, label and
// |x|^2, its columns and values, and w at those columns (w is read-only
// during the round).  Read in the step, they are four dependent global
// loads (draw -> row length -> columns -> w gather) on the chain.  The
// design takes all of them off it:
// - warp specialisation: one block per shard, warp 0 the *consumer* that
//   runs the chain, warps 1..S the *producers*.  Producer p fills slot p
//   of a ring of S slots in shared memory with steps p, p + S, p + 2S, ...:
//   the step's draw i, row length, y, |x|^2 and alpha[i], and for each of
//   the row's first ``slot`` entries its column f, value v and w[f].  A
//   producer walks its steps ahead of its slot: the scalars of the step
//   after next are loaded and its row asked into L2, the next step's first
//   entries and their w gathers are in registers, all before the slot is
//   free; only alpha[i] is read after.  The handshakes are named barriers
//   between the consumer and one producer, two a slot (full and empty;
//   bar.arrive on one side, bar.sync on the other), so S <= kMaxStages =
//   7 of the 15 ids beside __syncthreads' 0.  The consumer's step reads
//   only shared memory: dw_k gathers, the 32-lane butterfly, alpha_step,
//   the scatter, a __syncwarp a 32-entry chunk, and the slot's release.
//   Lanes stride the row (j = lane, lane + 32, ...) with the arithmetic of
//   the single-warp kernel this replaces, so its float32 bits are
//   unchanged wherever a row repeats no column.
// - the scatter: a float atomicAdd on shared memory is a compare-and-swap
//   loop on this card (ATOMS.CAST.SPIN), about 0.5 us of a step at
//   rcv1-like rows.
//   The producer marks a row in which a 32-entry chunk holds a column
//   twice (__match_any_sync over its lanes, off the chain); any other row
//   is scattered with a plain read-modify-write a chunk at a time, the
//   chunks ordered by __syncwarp, and its values are those the atomics
//   would give (the product is not fused into the add).  Marked rows,
//   dw_k in global memory and entries past the slot keep the atomics.
// - a row drawn again within S steps: alpha[i] is read by the producer
//   after the consumer has released the slot's previous step, h - S, whose
//   alpha write precedes the release; writes of steps h-S+1..h-1 may be
//   missed.  The consumer keeps its last steps' (i, a') in registers, step
//   s in lane s mod 32, and takes the newest of the last S - 1 whose row
//   matches over the staged value (a ballot-free min-reduction and one
//   shuffle, off the chain's data dependence through dw), so the value a
//   step uses is the one the sequential kernel reads, at any distance.
// - a row longer than a slot: its first ``slot`` entries come from the
//   ring, the rest are read by the consumer from the CSR arrays and w, as
//   the single-warp kernel read every entry (ops/sparse_sdca.py
//   sparse_plan says when slots are narrower than rows).  No width is
//   refused.
// - dw_k lives in shared memory when the caller's plan puts it there
//   (sparse_plan, against the 227 KB opt-in: d = 47 236 fits in float32,
//   189 KB, beside six 548-wide slots), else in global memory, read with
//   __ldcg past L1 because the scatter's atomics land in L2.  Every warp
//   zeroes it at the start and writes it out at the end.
// - the loops stop at row_len, so padded slots (index 0, value 0) are
//   never touched: in a parallel scatter a padded slot's dw[0] += 0 would
//   race with a real column 0 of the same row.  A column repeated within
//   a row adds both values.
// - the TPU kernel's SMEM segmentation, lane-blocked [w|dw] layout, GROUP
//   unroll and per-round (K, H, W) gather tables are TPU addressing
//   workarounds; what carries over is its idea of having each row's data
//   in fast memory before its step, here the producers' ring.
//
// The hybrid branch (the hot/cold column split, --hotCols; the TPU
// kernel's hot_panel/hot_cols operands) is a second kernel below,
// sparse_sdca_hybrid_kernel.  The CSR streams then hold only each row's
// cold residual, and a step also reads the row's dense hot-panel slice:
//   margin += sum_l hrow[l] * (w_hot[l] + sig_eff * dw_hot[l])
//   dw_hot += coef * hrow                          (after alpha_step)
// with w_hot = w[hot_cols]; on return dw_k has dw_hot added at hot_cols.
// At rcv1-like width a step reads a 5248-wide panel row (21 KB in
// float32) and about 18 residual nonzeros.  Its design, B2's shape
// (dense_sdca.cu) beside B1's ring:
// - kPanelThreads = 512 panel threads (16 warps), one residual consumer
//   warp and S producer warps per shard.  Panel thread t owns lanes t,
//   t + 512, ... for the round.  When ceil(n_hot / 512) <= kHotRegs (12
//   in float32, 6 in float64, so four such arrays stay in registers) its
//   w_hot and dw_hot lanes live in registers, and the next step's panel
//   slice is loaded into registers a step ahead, the one after asked into
//   L2.  A wider panel keeps w_hot in a global scratch row and dw_hot in
//   shared memory (or the scratch row), and reads each slice in the step.
// - the residual runs on its own warp, fed by the producers as in B1, in
//   parallel with the panel dots.
// - one barrier a step (a named barrier over the panel warps and the
//   residual warp; the producers are not in it).  Each warp's lane 0
//   writes its partial to red[step & 1], the residual warp also the
//   step's y, qii and alpha; after the barrier every warp sums the 17
//   partials in the same fixed tree and runs alpha_step itself, so no
//   second barrier hands coef out, and the bits agree in every warp.  red
//   is double-buffered by step parity: a warp cannot write step t+2's
//   partials before every warp has passed step t+1's barrier, that is,
//   has read step t's.  The residual warp's lane 0 alone writes alpha.
// - the fold of dw_hot into dw_k uses atomics after the last step: panel
//   padding lanes carry column 0 and value 0, so they add 0 at column 0,
//   where a real hot column 0 or a cold column 0 may be added in the same
//   pass.

#include <cuda_runtime.h>

#include "sdca_common.cuh"

namespace {

using sdca::alpha_step;
using sdca::warp_sum;

constexpr int kMaxStages = 7;   // two named barriers a slot, ids 1..14
constexpr int kMinSlot = 32;    // a narrower slot is the whole row
constexpr int kUnroll = 4;      // 32-entry chunks a lane holds at once
constexpr int kBlock = 32 * kUnroll;
constexpr int kPanelThreads = 512;
constexpr int kPanelWarps = kPanelThreads / 32;
// panel lanes a thread keeps in registers (w_hot, dw_hot and two slices)
template <typename T>
constexpr int kHotRegs = sizeof(T) == 4 ? 12 : 6;
constexpr int kHotUnroll = 16;  // panel lanes a thread loads at once
// red[parity]: the panel warps' partial dots, the residual warp's, then
// the step's y, qii and alpha
constexpr int kReduce = 2 * (kPanelWarps + 4);
constexpr int kStepBarrier = 15;
constexpr int kStepThreads = kPanelThreads + 32;
static_assert(2 * kMaxStages < kStepBarrier, "slot barriers below the step's");
static_assert(kPanelWarps + 1 <= 32, "the partials are summed by one warp");

__device__ __forceinline__ int full_barrier(int slot) { return 1 + 2 * slot; }
__device__ __forceinline__ int empty_barrier(int slot) { return 2 + 2 * slot; }

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A slot's bytes: ``slot`` entries of (T v, T w[f], int32 f) and the
// step's scalars (T y, |x|^2, alpha; int32 i, row length, and whether a
// 32-entry chunk of the row holds a column twice).
size_t slot_bytes(int slot, size_t itemsize) {
  return (size_t)slot * (2 * itemsize + 4) + 3 * itemsize + 12;
}

// Shared memory of one block: red (hybrid), then the state when it is
// there (dw_k, and dw_hot when the hot lanes are not in registers), then
// the ring.  ops/sparse_sdca.py plan_bytes is the same sum.
size_t smem_bytes(int d, int n_hot, size_t itemsize, bool state_in_smem,
                  bool hot_in_regs, int stages, int slot) {
  const size_t state =
      state_in_smem ? (size_t)d + (n_hot > 0 && !hot_in_regs ? n_hot : 0) : 0;
  return ((n_hot > 0 ? kReduce : 0) + state) * itemsize +
         (size_t)stages * slot_bytes(slot, itemsize);
}

template <typename T, bool kSmem>
__device__ __forceinline__ T load_dw(const T* dw, int f) {
  if (kSmem) return dw[f];
  return __ldcg(dw + f);
}

// a product that is never fused into a following add, as the atomic
// scatter's operand is not
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// The ring, structure of arrays over the S slots; T arrays first.
template <typename T>
struct Ring {
  T *v, *wf, *y, *sq, *a;
  int *f, *i, *len, *dup;
  int slot;
  __device__ Ring(unsigned char* base, int stages, int slot_) : slot(slot_) {
    const int n = stages * slot;
    v = reinterpret_cast<T*>(base);
    wf = v + n;
    y = wf + n;
    sq = y + stages;
    a = sq + stages;
    f = reinterpret_cast<int*>(a + stages);
    i = f + n;
    len = i + stages;
    dup = len + stages;
  }
};

// The shard's arrays, as each kernel's roles read them.
template <typename T>
struct Shard {
  const T* w;
  T* alpha;           // (n_shard,) of this shard
  const int* sp_idx;  // (n_shard, width) of this shard
  const T* sp_val;
  const T* labels;
  const T* sq;
  const int* idxs;  // (h,)
  const int* row_len;
  int width, h;
};

// Shard k's rows of the round's arrays.
template <typename T>
__device__ Shard<T> shard(const T* w, T* alpha, const int* sp_idx,
                          const T* sp_val, const T* labels, const T* sq,
                          const int* idxs, const int* row_len, int k,
                          int n_shard, int width, int h) {
  const size_t rows = (size_t)k * n_shard;
  return {w, alpha + rows, sp_idx + rows * width, sp_val + rows * width,
          labels + rows, sq + rows, idxs + (size_t)k * h, row_len + rows,
          width, h};
}

// Ask L2 for the 128-byte lines of a row's first n columns and values,
// over one warp.
template <typename T>
__device__ __forceinline__ void prefetch_row(const int* idx, const T* val,
                                             int n, int lane) {
  for (int j = lane * 32; j < n; j += 32 * 32)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(__cvta_generic_to_global(idx + j)));
  constexpr int kPerLine = 128 / sizeof(T);
  for (int j = lane * kPerLine; j < n; j += 32 * kPerLine)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(__cvta_generic_to_global(val + j)));
}

// Producer p: steps p, p + S, ... into slot p.  ``cur`` holds the step to
// fill, ``nxt`` the one S steps on (its row asked into L2), and the
// registers the first 32 * kUnroll entries of ``cur`` with their w.
template <typename T>
__device__ void produce(const Shard<T>& s, const Ring<T>& ring, int p,
                        int stages, int lane) {
  struct Step {
    int i, len;
    T y, sq;
  };
  auto scalars = [&](int step) {
    Step st;
    st.i = s.idxs[step];
    st.len = s.row_len[st.i];
    st.y = s.labels[st.i];
    st.sq = s.sq[st.i];
    prefetch_row(s.sp_idx + (size_t)st.i * s.width,
                 s.sp_val + (size_t)st.i * s.width, min(st.len, ring.slot),
                 lane);
    return st;
  };
  int f[kUnroll];
  T v[kUnroll], wf[kUnroll];
  auto load = [&](const Step& st, int base) {
    const int n = min(st.len, ring.slot);
    const size_t row = (size_t)st.i * s.width;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + lane + 32 * u;
      if (j < n) {
        f[u] = s.sp_idx[row + j];
        v[u] = s.sp_val[row + j];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (base + lane + 32 * u < n) wf[u] = s.w[f[u]];
  };
  // into the slot; true if a 32-entry chunk holds a column twice
  auto store = [&](const Step& st, int base) {
    const int n = min(st.len, ring.slot);
    const size_t at = (size_t)p * ring.slot;
    bool twice = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + lane + 32 * u;
      if (j < n) {
        ring.f[at + j] = f[u];
        ring.v[at + j] = v[u];
        ring.wf[at + j] = wf[u];
      }
      const unsigned same =
          __match_any_sync(0xffffffffu, j < n ? f[u] : -1 - lane);
      twice |= same != 1u << lane;
    }
    return twice;
  };

  if (p >= s.h) return;
  Step cur = scalars(p), nxt{};
  if (p + stages < s.h) nxt = scalars(p + stages);
  load(cur, 0);
  for (int step = p; step < s.h; step += stages) {
    if (step >= stages) bar_sync(empty_barrier(p), 64);
    const T a = __ldcg(s.alpha + cur.i);  // after the slot's last step
    bool twice = store(cur, 0);
    for (int base = kBlock; base < min(cur.len, ring.slot); base += kBlock) {
      load(cur, base);
      twice |= store(cur, base);
    }
    twice = __any_sync(0xffffffffu, twice);
    if (lane == 0) {
      ring.i[p] = cur.i;
      ring.len[p] = cur.len;
      ring.y[p] = cur.y;
      ring.sq[p] = cur.sq;
      ring.a[p] = a;
      ring.dup[p] = twice;
    }
    __syncwarp();
    bar_arrive(full_barrier(p), 64);
    cur = nxt;
    if (step + 2 * stages < s.h) nxt = scalars(step + 2 * stages);
    if (step + stages < s.h) load(cur, 0);
  }
}

// The consumer's chain.  kHybrid: the margin's residual part goes to red
// beside the panel warps' partials, and the step barrier joins them.
template <typename T, bool kSmem, bool kHybrid>
__device__ void consume(const Shard<T>& s, const Ring<T>& ring, T* dwk,
                        T* red, int stages, int loss, T lam_n, T coef_div,
                        T sig_eff, T qii_factor, T smoothing, int frozen,
                        int lane) {
  int hist_i = -1;  // step t's row and a' in lane t mod 32
  T hist_a = T(0);
  int p = 0;
  for (int step = 0; step < s.h; ++step) {
    bar_sync(full_barrier(p), 64);
    const int i = ring.i[p], len = ring.len[p];
    const T y = ring.y[p], qii = ring.sq[p] * qii_factor;
    // the newest of the last S - 1 steps that drew row i, if any
    const unsigned back = (unsigned)(step - 1 - lane) & 31u;
    const bool hit = hist_i == i && back < (unsigned)(stages - 1);
    const unsigned newest = __reduce_min_sync(0xffffffffu, hit ? back : 32u);
    const T fwd = __shfl_sync(0xffffffffu, hist_a,
                              (step - 1 - (int)newest) & 31);
    const T a = newest < 32u ? fwd : ring.a[p];

    const size_t at = (size_t)p * ring.slot;
    const size_t row = (size_t)i * s.width;
    // entry j: staged, or past the slot read from the CSR arrays
    auto entry = [&](int j, int& f, T& v) {
      f = j < ring.slot ? ring.f[at + j] : s.sp_idx[row + j];
      v = j < ring.slot ? ring.v[at + j] : s.sp_val[row + j];
    };
    // a lane's entries j = lane, lane + 32, ..., kUnroll at a time: the
    // loads first, the sum in j order
    int fr[kUnroll];
    T vr[kUnroll];
    T acc = T(0);
    for (int base = 0; base < len; base += kBlock) {
      T c[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + lane + 32 * u;
        if (j < len) {
          entry(j, fr[u], vr[u]);
          c[u] = j < ring.slot ? ring.wf[at + j] : s.w[fr[u]];
        }
      }
      if (!frozen) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (base + lane + 32 * u < len)
            c[u] = c[u] + sig_eff * load_dw<T, kSmem>(dwk, fr[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (base + lane + 32 * u < len) acc = acc + vr[u] * c[u];
    }
    acc = warp_sum(acc);

    T margin = acc;
    if constexpr (kHybrid) {
      T* rp = red + (step & 1) * (kPanelWarps + 4);
      if (lane == 0) {
        rp[kPanelWarps] = acc;
        rp[kPanelWarps + 1] = y;
        rp[kPanelWarps + 2] = qii;
        rp[kPanelWarps + 3] = a;
      }
      bar_sync(kStepBarrier, kStepThreads);
      margin = warp_sum(lane <= kPanelWarps ? rp[lane] : T(0));
    }
    const T new_a = alpha_step<T>(loss, a, y * margin, qii, lam_n, smoothing);
    const T coef = y * (new_a - a) / coef_div;
    // the scatter, a 32-entry chunk at a time: a plain read-modify-write
    // in shared memory where the producer found no column twice in a
    // staged chunk, else atomics (a column repeated within a row adds
    // both values); the chunks are ordered by __syncwarp
    const bool plain = kSmem && !ring.dup[p];
    for (int base = 0; base < len; base += kBlock) {
      if (len > kBlock) {  // the registers hold the last block's entries
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (base + lane + 32 * u < len)
            entry(base + lane + 32 * u, fr[u], vr[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + lane + 32 * u;
        if (j < len) {
          const T x = mul_rn(coef, vr[u]);
          if (plain && j < ring.slot)
            dwk[fr[u]] = dwk[fr[u]] + x;
          else
            atomicAdd(dwk + fr[u], x);
        }
        __syncwarp();
      }
    }
    if (lane == (step & 31)) {
      hist_i = i;
      hist_a = new_a;
    }
    if (lane == 0) s.alpha[i] = new_a;
    if (!kSmem) __threadfence_block();
    __syncwarp();  // the scatter precedes the next step's gathers
    if (step + stages < s.h) bar_arrive(empty_barrier(p), 64);
    if (++p == stages) p = 0;
  }
}

template <typename T, bool kSmem>
__global__ void __launch_bounds__(32 * (kMaxStages + 1))
    sparse_sdca_round_kernel(const T* __restrict__ w, T* __restrict__ alpha,
                             const int* __restrict__ sp_idx,
                             const T* __restrict__ sp_val,
                             const T* __restrict__ labels,
                             const T* __restrict__ sq,
                             const int* __restrict__ idxs,
                             const int* __restrict__ row_len,
                             T* __restrict__ dw_out, int n_shard, int width,
                             int d, int h, int stages, int slot, int loss,
                             T lam_n, T coef_div, T sig_eff, T qii_factor,
                             T smoothing, int frozen) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  T* dwk = kSmem ? reinterpret_cast<T*>(smem_raw) : dw_out + (size_t)k * d;
  const Ring<T> ring(smem_raw + (kSmem ? (size_t)d * sizeof(T) : 0), stages,
                     slot);
  const Shard<T> s = shard(w, alpha, sp_idx, sp_val, labels, sq, idxs,
                           row_len, k, n_shard, width, h);

  for (int c = t; c < d; c += blockDim.x) dwk[c] = T(0);
  if (!kSmem) __threadfence_block();
  __syncthreads();
  if (warp == 0)
    consume<T, kSmem, false>(s, ring, dwk, nullptr, stages, loss, lam_n,
                             coef_div, sig_eff, qii_factor, smoothing, frozen,
                             lane);
  else
    produce<T>(s, ring, warp - 1, stages, lane);
  __syncthreads();
  if (kSmem) {
    T* out = dw_out + (size_t)k * d;
    for (int c = t; c < d; c += blockDim.x) out[c] = dwk[c];
  }
}

// The panel threads of the hybrid kernel: their share of each step's dot,
// the step barrier, the same alpha_step as every warp, their dw_hot
// lanes; after the last step, the fold of dw_hot into dw_k.
template <typename T, bool kSmem, bool kRegs>
__device__ void panel(const Shard<T>& s, const T* panel_k, const int* hc_k,
                      T* w_hot, T* dwh, T* dwk, T* red, int n_hot, int loss,
                      T lam_n, T coef_div, T sig_eff, T smoothing, int frozen,
                      int t) {
  const int lane = t & 31, warp = t >> 5;
  // every warp's copy of the step's margin, alpha_step and coef
  auto step_coef = [&](int step, T acc) {
    T* rp = red + (step & 1) * (kPanelWarps + 4);
    acc = warp_sum(acc);
    if (lane == 0) rp[warp] = acc;
    bar_sync(kStepBarrier, kStepThreads);
    const T margin = warp_sum(lane <= kPanelWarps ? rp[lane] : T(0));
    const T y = rp[kPanelWarps + 1], qii = rp[kPanelWarps + 2],
            a = rp[kPanelWarps + 3];
    const T new_a = alpha_step<T>(loss, a, y * margin, qii, lam_n, smoothing);
    return y * (new_a - a) / coef_div;
  };
  const int h = s.h;
  // the draws of the next two steps, loaded a step before their use
  int i_cur = h > 0 ? s.idxs[0] : 0;
  int i_nxt = h > 1 ? s.idxs[1] : 0;
  int i_aft = h > 2 ? s.idxs[2] : 0;

  if constexpr (kRegs) {
    T wr[kHotRegs<T>], dr[kHotRegs<T>], xc[kHotRegs<T>], xn[kHotRegs<T>];
#pragma unroll
    for (int u = 0; u < kHotRegs<T>; ++u) {
      const int l = t + u * kPanelThreads;
      wr[u] = l < n_hot ? s.w[hc_k[l]] : T(0);
      dr[u] = T(0);
      xc[u] = l < n_hot && h > 0 ? panel_k[(size_t)i_cur * n_hot + l] : T(0);
      xn[u] = T(0);
    }
    if (h > 1)
      sdca::prefetch_l2<kPanelThreads>(panel_k + (size_t)i_nxt * n_hot,
                                       n_hot);
    for (int step = 0; step < h; ++step) {
      // the next step's slice into registers, the one after into L2
      if (step + 1 < h) {
        const T* hn = panel_k + (size_t)i_nxt * n_hot;
#pragma unroll
        for (int u = 0; u < kHotRegs<T>; ++u) {
          const int l = t + u * kPanelThreads;
          xn[u] = l < n_hot ? hn[l] : T(0);
        }
      }
      if (step + 2 < h)
        sdca::prefetch_l2<kPanelThreads>(panel_k + (size_t)i_aft * n_hot,
                                         n_hot);
      const int i_far = step + 3 < h ? s.idxs[step + 3] : 0;
      T acc = T(0);
#pragma unroll
      for (int u = 0; u < kHotRegs<T>; ++u)
        acc = acc + xc[u] * (frozen ? wr[u] : wr[u] + sig_eff * dr[u]);
      const T coef = step_coef(step, acc);
#pragma unroll
      for (int u = 0; u < kHotRegs<T>; ++u) {
        dr[u] = dr[u] + coef * xc[u];
        xc[u] = xn[u];
      }
      i_nxt = i_aft;
      i_aft = i_far;
    }
    bar_sync(kStepBarrier, kStepThreads);  // every residual scatter is in
#pragma unroll
    for (int u = 0; u < kHotRegs<T>; ++u) {
      const int l = t + u * kPanelThreads;
      if (l < n_hot) atomicAdd(dwk + hc_k[l], dr[u]);
    }
  } else {
    constexpr int kBatch = kPanelThreads * kHotUnroll;
    for (int l = t; l < n_hot; l += kPanelThreads) {  // lane l's owner
      w_hot[l] = s.w[hc_k[l]];
      dwh[l] = T(0);
    }
    if (h > 0)
      sdca::prefetch_l2<kPanelThreads>(panel_k + (size_t)i_cur * n_hot,
                                       n_hot);
    for (int step = 0; step < h; ++step) {
      const T* hrow = panel_k + (size_t)i_cur * n_hot;
      if (step + 1 < h)
        sdca::prefetch_l2<kPanelThreads>(panel_k + (size_t)i_nxt * n_hot,
                                         n_hot);
      const int i_far = step + 3 < h ? s.idxs[step + 3] : 0;
      T acc = T(0);
      T x0[kHotUnroll];  // the first batch of lanes, kept for the axpy
#pragma unroll
      for (int u = 0; u < kHotUnroll; ++u) {
        const int l = t + u * kPanelThreads;
        x0[u] = l < n_hot ? hrow[l] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kHotUnroll; ++u) {
        const int l = t + u * kPanelThreads;
        if (l < n_hot)
          acc = acc + x0[u] * (frozen ? w_hot[l] : w_hot[l] + sig_eff * dwh[l]);
      }
      for (int base = t + kBatch; base < n_hot; base += kBatch) {
        T x[kHotUnroll];
#pragma unroll
        for (int u = 0; u < kHotUnroll; ++u) {
          const int l = base + u * kPanelThreads;
          x[u] = l < n_hot ? hrow[l] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kHotUnroll; ++u) {
          const int l = base + u * kPanelThreads;
          if (l < n_hot)
            acc = acc + x[u] * (frozen ? w_hot[l] : w_hot[l] + sig_eff * dwh[l]);
        }
      }
      const T coef = step_coef(step, acc);
#pragma unroll
      for (int u = 0; u < kHotUnroll; ++u) {
        const int l = t + u * kPanelThreads;
        if (l < n_hot) dwh[l] = dwh[l] + coef * x0[u];
      }
      for (int l = t + kBatch; l < n_hot; l += kPanelThreads)
        dwh[l] = dwh[l] + coef * hrow[l];
      i_cur = i_nxt;
      i_nxt = i_aft;
      i_aft = i_far;
    }
    bar_sync(kStepBarrier, kStepThreads);  // every residual scatter is in
    for (int l = t; l < n_hot; l += kPanelThreads)
      atomicAdd(dwk + hc_k[l], dwh[l]);
  }
}

template <typename T, bool kSmem, bool kRegs>
__global__ void __launch_bounds__(kStepThreads + 32 * kMaxStages)
    sparse_sdca_hybrid_kernel(
        const T* __restrict__ w, T* __restrict__ alpha,
        const int* __restrict__ sp_idx, const T* __restrict__ sp_val,
        const T* __restrict__ labels, const T* __restrict__ sq,
        const int* __restrict__ idxs, const int* __restrict__ row_len,
        const T* __restrict__ hot_panel, const int* __restrict__ hot_cols,
        T* __restrict__ scratch, T* __restrict__ dw_out, int n_shard,
        int width, int d, int h, int n_hot, int stages, int slot, int loss,
        T lam_n, T coef_div, T sig_eff, T qii_factor, T smoothing,
        int frozen) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // layout: red, then [dw_k (d) | dw_hot (n_hot) unless in registers] when
  // kSmem, then the ring
  T* red = reinterpret_cast<T*>(smem_raw);
  T* state = red + kReduce;
  const int k = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  T* dwk = kSmem ? state : dw_out + (size_t)k * d;
  T* w_hot = scratch + (size_t)k * 2 * n_hot;
  T* dwh = kSmem ? state + d : w_hot + n_hot;
  const Ring<T> ring(reinterpret_cast<unsigned char*>(
                         state + (kSmem ? d + (kRegs ? 0 : n_hot) : 0)),
                     stages, slot);
  const Shard<T> s = shard(w, alpha, sp_idx, sp_val, labels, sq, idxs,
                           row_len, k, n_shard, width, h);

  for (int c = t; c < d; c += blockDim.x) dwk[c] = T(0);
  if (!kSmem) __threadfence_block();
  __syncthreads();  // the residual's scatter may reach any column of dw_k
  if (warp < kPanelWarps)
    panel<T, kSmem, kRegs>(s, hot_panel + (size_t)k * n_shard * n_hot,
                           hot_cols + (size_t)k * n_hot, w_hot, dwh, dwk, red,
                           n_hot, loss, lam_n, coef_div, sig_eff, smoothing,
                           frozen, t);
  else if (warp == kPanelWarps) {
    consume<T, kSmem, true>(s, ring, dwk, red, stages, loss, lam_n, coef_div,
                            sig_eff, qii_factor, smoothing, frozen, lane);
    bar_sync(kStepBarrier, kStepThreads);  // the panel's fold may start
  } else
    produce<T>(s, ring, warp - kPanelWarps - 1, stages, lane);
  __syncthreads();  // the fold is in dw_k
  if (kSmem) {
    T* out = dw_out + (size_t)k * d;
    for (int c = t; c < d; c += blockDim.x) out[c] = dwk[c];
  }
}

// The plan is the caller's (ops/sparse_sdca.py sparse_plan): one that
// breaks these rules or does not fit is refused, never replaced.
template <typename T>
bool plan_ok(int width, int n_hot, size_t bytes, int stages, int slot,
             bool hot_in_regs) {
  return stages >= 1 && stages <= kMaxStages && slot >= 1 && slot <= width &&
         (slot == width || slot % kMinSlot == 0) &&
         (!hot_in_regs ||
          (n_hot + kPanelThreads - 1) / kPanelThreads <= kHotRegs<T>) &&
         bytes <= (size_t)sdca::smem_optin();
}

template <typename T>
int launch(const T* w, T* alpha, const int* sp_idx, const T* sp_val,
           const T* labels, const T* sq, const int* idxs, const int* row_len,
           T* dw, int k, int n_shard, int width, int d, int h, int loss,
           double lam_n, double coef_div, double sig_eff, double qii_factor,
           double smoothing, int frozen, int state_in_smem, int stages,
           int slot, void* stream) {
  const size_t bytes =
      smem_bytes(d, 0, sizeof(T), state_in_smem, false, stages, slot);
  if (!plan_ok<T>(width, 0, bytes, stages, slot, false))
    return (int)cudaErrorInvalidValue;
  const auto kernel = state_in_smem ? sparse_sdca_round_kernel<T, true>
                                    : sparse_sdca_round_kernel<T, false>;
  const cudaError_t err = sdca::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<k, 32 * (stages + 1), bytes, static_cast<cudaStream_t>(stream)>>>(
      w, alpha, sp_idx, sp_val, labels, sq, idxs, row_len, dw, n_shard, width,
      d, h, stages, slot, loss, T(lam_n), T(coef_div), T(sig_eff),
      T(qii_factor), T(smoothing), frozen);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hybrid(const T* w, T* alpha, const int* sp_idx, const T* sp_val,
                  const T* labels, const T* sq, const int* idxs,
                  const int* row_len, const T* hot_panel,
                  const int* hot_cols, T* scratch, T* dw, int k, int n_shard,
                  int width, int d, int h, int n_hot, int loss, double lam_n,
                  double coef_div, double sig_eff, double qii_factor,
                  double smoothing, int frozen, int state_in_smem, int stages,
                  int slot, int hot_in_regs, void* stream) {
  const size_t bytes = smem_bytes(d, n_hot, sizeof(T), state_in_smem,
                                  hot_in_regs, stages, slot);
  if (n_hot < 1 ||
      !plan_ok<T>(width, n_hot, bytes, stages, slot, hot_in_regs))
    return (int)cudaErrorInvalidValue;
  const auto kernel =
      state_in_smem
          ? (hot_in_regs ? sparse_sdca_hybrid_kernel<T, true, true>
                         : sparse_sdca_hybrid_kernel<T, true, false>)
          : (hot_in_regs ? sparse_sdca_hybrid_kernel<T, false, true>
                         : sparse_sdca_hybrid_kernel<T, false, false>);
  const cudaError_t err = sdca::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<k, kStepThreads + 32 * stages, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      w, alpha, sp_idx, sp_val, labels, sq, idxs, row_len, hot_panel,
      hot_cols, scratch, dw, n_shard, width, d, h, n_hot, stages, slot, loss,
      T(lam_n), T(coef_div), T(sig_eff), T(qii_factor), T(smoothing), frozen);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  ``alpha`` holds the round's starting
// alpha and is advanced in place; ``dw`` (K, d) is written whole.  Every
// tensor is contiguous; indices are int32.  The plan: ``state_in_smem``
// places dw_k in shared memory (1) or global memory (0), ``stages`` is the
// ring's depth (1..7), ``slot`` a slot's entries (the row width, or a
// multiple of 32 below it; longer rows' tails are read from global
// memory); a plan that breaks these rules or whose bytes exceed the
// opt-in is refused with cudaErrorInvalidValue.  Returns
// cudaGetLastError().
extern "C" int sparse_sdca_round_f32(
    const float* w, float* alpha, const int* sp_idx, const float* sp_val,
    const float* labels, const float* sq, const int* idxs,
    const int* row_len, float* dw, int k, int n_shard, int width, int d,
    int h, int loss, double lam_n, double coef_div, double sig_eff,
    double qii_factor, double smoothing, int frozen, int state_in_smem,
    int stages, int slot, void* stream) {
  return launch<float>(w, alpha, sp_idx, sp_val, labels, sq, idxs, row_len,
                       dw, k, n_shard, width, d, h, loss, lam_n, coef_div,
                       sig_eff, qii_factor, smoothing, frozen, state_in_smem,
                       stages, slot, stream);
}

extern "C" int sparse_sdca_round_f64(
    const double* w, double* alpha, const int* sp_idx, const double* sp_val,
    const double* labels, const double* sq, const int* idxs,
    const int* row_len, double* dw, int k, int n_shard, int width, int d,
    int h, int loss, double lam_n, double coef_div, double sig_eff,
    double qii_factor, double smoothing, int frozen, int state_in_smem,
    int stages, int slot, void* stream) {
  return launch<double>(w, alpha, sp_idx, sp_val, labels, sq, idxs, row_len,
                        dw, k, n_shard, width, d, h, loss, lam_n, coef_div,
                        sig_eff, qii_factor, smoothing, frozen, state_in_smem,
                        stages, slot, stream);
}

// The hybrid branch: the CSR streams hold the cold residual, and
// ``hot_panel`` (K, n_shard, n_hot) / ``hot_cols`` int32 (K, n_hot) the hot
// panel; ``scratch`` (K, 2, n_hot) is the kernel's (w_hot, dw_hot) when
// the hot lanes are not in registers.  The plan as above, and
// ``hot_in_regs``: each panel thread's lanes in registers (ceil(n_hot /
// 512) <= 12), else in the scratch row and, with the state, shared memory.
extern "C" int sparse_sdca_hybrid_f32(
    const float* w, float* alpha, const int* sp_idx, const float* sp_val,
    const float* labels, const float* sq, const int* idxs,
    const int* row_len, const float* hot_panel, const int* hot_cols,
    float* scratch, float* dw, int k, int n_shard, int width, int d, int h,
    int n_hot, int loss, double lam_n, double coef_div, double sig_eff,
    double qii_factor, double smoothing, int frozen, int state_in_smem,
    int stages, int slot, int hot_in_regs, void* stream) {
  return launch_hybrid<float>(
      w, alpha, sp_idx, sp_val, labels, sq, idxs, row_len, hot_panel,
      hot_cols, scratch, dw, k, n_shard, width, d, h, n_hot, loss, lam_n,
      coef_div, sig_eff, qii_factor, smoothing, frozen, state_in_smem, stages,
      slot, hot_in_regs, stream);
}

extern "C" int sparse_sdca_hybrid_f64(
    const double* w, double* alpha, const int* sp_idx, const double* sp_val,
    const double* labels, const double* sq, const int* idxs,
    const int* row_len, const double* hot_panel, const int* hot_cols,
    double* scratch, double* dw, int k, int n_shard, int width, int d, int h,
    int n_hot, int loss, double lam_n, double coef_div, double sig_eff,
    double qii_factor, double smoothing, int frozen, int state_in_smem,
    int stages, int slot, int hot_in_regs, void* stream) {
  return launch_hybrid<double>(
      w, alpha, sp_idx, sp_val, labels, sq, idxs, row_len, hot_panel,
      hot_cols, scratch, dw, k, n_shard, width, d, h, n_hot, loss, lam_n,
      coef_div, sig_eff, qii_factor, smoothing, frozen, state_in_smem, stages,
      slot, hot_in_regs, stream);
}

// The kernels, for SDCA_KERNEL_INFO (analysis/kernel_budget.py looks them
// up by name).
namespace {
const sdca::KernelEntry kKernels[] = {
    {"sparse_sdca_round_kernel<float,smem>",
     (const void*)&sparse_sdca_round_kernel<float, true>},
    {"sparse_sdca_round_kernel<float,global>",
     (const void*)&sparse_sdca_round_kernel<float, false>},
    {"sparse_sdca_round_kernel<double,smem>",
     (const void*)&sparse_sdca_round_kernel<double, true>},
    {"sparse_sdca_round_kernel<double,global>",
     (const void*)&sparse_sdca_round_kernel<double, false>},
    {"sparse_sdca_hybrid_kernel<float,smem,regs>",
     (const void*)&sparse_sdca_hybrid_kernel<float, true, true>},
    {"sparse_sdca_hybrid_kernel<float,smem,memory>",
     (const void*)&sparse_sdca_hybrid_kernel<float, true, false>},
    {"sparse_sdca_hybrid_kernel<float,global,regs>",
     (const void*)&sparse_sdca_hybrid_kernel<float, false, true>},
    {"sparse_sdca_hybrid_kernel<float,global,memory>",
     (const void*)&sparse_sdca_hybrid_kernel<float, false, false>},
    {"sparse_sdca_hybrid_kernel<double,smem,regs>",
     (const void*)&sparse_sdca_hybrid_kernel<double, true, true>},
    {"sparse_sdca_hybrid_kernel<double,smem,memory>",
     (const void*)&sparse_sdca_hybrid_kernel<double, true, false>},
    {"sparse_sdca_hybrid_kernel<double,global,regs>",
     (const void*)&sparse_sdca_hybrid_kernel<double, false, true>},
    {"sparse_sdca_hybrid_kernel<double,global,memory>",
     (const void*)&sparse_sdca_hybrid_kernel<double, false, false>},
};
}  // namespace
SDCA_KERNEL_INFO(kKernels)

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
