// One sequential SDCA round over K dense shards, for Hopper (sm_90a).
//
// Replaces the TPU kernel cocoa_tpu/ops/pallas_sdca.py pallas_sdca_round
// (bodies _kernel and _kernel_interleaved).  For every shard k and every
// step h = 0..H-1, in order:
//   i      = idxs[k, h]
//   margin = x_i . w0 + sig_eff * (x_i . dw_k)      (frozen mode: x_i . w0)
//   a'     = alpha_step(loss, alpha[k, i], y * margin, |x_i|^2 * qii_factor,
//                       lam_n)
//   coef   = y * (a' - alpha[k, i]) / coef_div    (a division, as the
//            static JAX path writes it)
//   dw_k  += coef * x_i
//   alpha[k, i] = a'
// Every mode of ops/local_sdca.py runs through the same loop: the mode
// only sets sig_eff, qii_factor, coef_div and frozen; ``prox`` takes the
// lasso rule of sdca_common.cuh.
//
// What bounds it on this card: each shard is a chain of H dependent steps
// (step h+1 reads the dw and alpha that step h wrote), and there are only
// K shards (4 to 8) for 132 SMs.  The bytes a round must move (the K*H
// sampled rows, d values each, plus w and dw) take a tenth of a
// millisecond at 3.35 TB/s at epsilon-like size; the round is latency-
// bound: H times one step's dots -> reduce -> alpha_step -> axpy chain.
// The design takes the row load and one of the two barriers off that
// chain, as the TPU kernel's row BlockSpecs DMA each sampled row into VMEM
// ahead of its step:
// - one block of kThreads threads per shard.  Thread t owns columns
//   t, t + kThreads, ... of w0 and dw_k for the whole round, so the vector
//   state needs no barrier at all: only the two dot products cross
//   threads.
// - a ring of ``stages`` slots in shared memory (S <= kMaxStages), fed by
//   a stream of row chunks of ``chunk`` columns.  A row that fits a slot
//   is one chunk (chunk == d): its step reads it once, the dots and the
//   axpy from the same slot, which is refilled after the axpy.  A wider
//   row (a column of a tall lasso design is n values long) is ceil(d /
//   chunk) chunks, chunk a multiple of kThreads, streamed twice a step:
//   once for the dots and once for the axpy, each chunk refilled as soon
//   as it is read, so any width runs on the same loop.  Element e of the
//   stream goes into slot e mod S, S elements ahead of its use; the
//   copies are cp.async, one element each (rows are not 16-byte aligned
//   in general: the demo's 9947 float32 columns make a row 39 788 bytes),
//   one copy group per element, empty past the last, so
//   ``cp.async.wait_group S-1`` before each use always means "this
//   element has landed".  Each thread copies and reads only the columns it
//   owns, so its own wait makes a chunk visible to it without a barrier.
// - one __syncthreads per step.  Each warp's lane 0 writes its two partial
//   dots to red[step & 1]; after the barrier every warp reduces the 16
//   pairs in the same fixed tree, and every thread runs alpha_step and
//   computes coef itself, so no second barrier hands coef out.  red is
//   double-buffered by step parity: step t+1 writes the other half while
//   slow warps may still read step t's.  Every thread computes the same
//   values in the same order, so the sums, alpha and dw are bit-identical
//   from launch to launch and to the single-thread tail they replace.
//   Thread 0 alone stores alpha[k, i].
// - the scalars are loaded a step before their use, and first read after
//   the next barrier, so their latency hides behind a whole step: y and
//   |x|^2 of step t+1 (read-only) at the top of step t, alpha of step t+1
//   right after step t's barrier.  Every alpha write up to step t-1 was
//   made by thread 0 before that barrier and is visible; step t's own
//   write is not, so a draw i_{t+1} == i_t takes the a' every thread
//   holds.  A row drawn twice reads the alpha its last draw wrote, at any
//   distance.
// - w0 and dw_k live in shared memory when the caller's plan puts them
//   there (ops/dense_sdca.py stage_plan picks the placement, S and the
//   chunk against the 227 KB opt-in; this file only refuses a plan that
//   does not fit), else in global memory (w0 read through the read-only
//   path, dw_k in its output row), still owned column by column.  Every
//   plan has at least one slot of at least kThreads columns (or the whole
//   row), so there is one code path and no width is refused.
// - the TPU kernel's folded (8, d/8) rows, lane-blocked (n/128, 384)
//   stacked state, unrolled step groups, interleaved variant and VMEM fit
//   gates are TPU addressing workarounds and have no counterpart here.

#include <cuda_runtime.h>

#include "sdca_common.cuh"

namespace {

using sdca::alpha_step;
using sdca::warp_sum;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 3;
// red[parity][dot][warp]: each warp's two partial dots, by step parity
constexpr int kReduce = 2 * 2 * kWarps;
static_assert(kWarps == 16, "the cross-warp tree is two half-warps of 16");
// a chunked row streams 2 * ceil(d / chunk) >= 4 elements a step, so a
// refill S <= 3 elements ahead reaches at most the next step's row
static_assert(kMaxStages < 4, "a refill reaches at most one step ahead");

// Shared memory of one block: red, then [dw_k | w0] when the state is
// there, then the ring.  ops/dense_sdca.py plan_bytes is the same sum.
size_t smem_bytes(int d, size_t itemsize, bool state_in_smem, int stages,
                  int chunk) {
  return (kReduce + (state_in_smem ? 2 * (size_t)d : 0) +
          (size_t)stages * chunk) * itemsize;
}

// Copy this thread's columns of the n values at ``src`` into the shared
// slot ``dst``, one element per cp.async.  ``src`` starts at a multiple of
// kThreads columns, so the columns copied are the ones this thread owns.
template <typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* src, int n) {
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + c));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(__cvta_generic_to_global(src + c)), "n"(sizeof(T))
                 : "memory");
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's copy groups are in flight
// (n = stages - 1; wait_group takes an immediate).
__device__ __forceinline__ void wait_groups(int n) {
  static_assert(kMaxStages == 3, "one case per ring depth");
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
  }
}

// kChunked: the plan's slot is narrower than the row (chunk < d).  It
// only lets the compiler fold the chunk loops away for whole rows; both
// instantiations run the same loop.
template <typename T, bool kSmem, bool kChunked>
__global__ void __launch_bounds__(kThreads) dense_sdca_round_kernel(
    const T* __restrict__ w, T* __restrict__ alpha, const T* __restrict__ X,
    const T* __restrict__ labels, const T* __restrict__ sq,
    const int* __restrict__ idxs, T* __restrict__ dw_out, int n_shard, int d,
    int h, int stages, int chunk, int loss, T lam_n, T coef_div, T sig_eff,
    T qii_factor, T smoothing, int frozen) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);
  T* state = red + kReduce;
  T* ring = state + (kSmem ? 2 * d : 0);
  const int k = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  T* dwk = kSmem ? state : dw_out + (size_t)k * d;
  const T* w0s = state + d;
  T* alpha_k = alpha + (size_t)k * n_shard;
  const T* labels_k = labels + (size_t)k * n_shard;
  const T* sq_k = sq + (size_t)k * n_shard;
  const int* idxs_k = idxs + (size_t)k * h;
  const T* X_k = X + (size_t)k * n_shard * d;

  // the stream: a step's row once when it is one chunk, else its chunks
  // for the dots and then again for the axpy.  The next element to fill
  // is chunk f_j mod n_chunks of the row of step f_step.
  const int n_chunks = kChunked ? (d + chunk - 1) / chunk : 1;
  const int per_step = kChunked ? 2 * n_chunks : 1;
  int f_step = 0, f_j = 0;
  // that element (of row ``row``) into ``slot``, then its group, empty
  // past the last step
  auto fill = [&](int slot, int row) {
    if (f_step < h) {
      const int base =
          kChunked ? (f_j < n_chunks ? f_j : f_j - n_chunks) * chunk : 0;
      stage_chunk(ring + (size_t)slot * chunk, X_k + (size_t)row * d + base,
                  kChunked ? min(chunk, d - base) : d);
    }
    commit_group();
    if (++f_j == per_step) {
      f_j = 0;
      ++f_step;
    }
  };
  for (int s = 0; s < stages; ++s) fill(s, f_step < h ? idxs_k[f_step] : 0);
  for (int c = t; c < d; c += kThreads) {
    dwk[c] = T(0);
    if (kSmem) state[d + c] = w[c];
  }
  // no barrier: every later access to column c of the state or of a slot
  // is made by thread t

  // the scalars, a step ahead of their use: every thread holds y and qii
  // of the current step, a_ld (alpha of the current row as loaded after
  // the last barrier) and i_next; a_prev and rep stand in for a_ld when
  // the current row repeats the last step's
  int i = 0, i_next = 0;
  T y = T(0), qii = T(0), a_ld = T(0), a_prev = T(0);
  bool rep = false;
  if (h > 0) {
    i = idxs_k[0];
    y = labels_k[i];
    qii = sq_k[i] * qii_factor;
    a_ld = alpha_k[i];
    i_next = h > 1 ? idxs_k[1] : i;
  }
  // the refills of a step reach the row of step + ahead at most
  const int ahead = kChunked ? 1 : stages;

  int slot = 0;  // the slot of the element read next
  for (int step = 0; step < h; ++step) {
    const bool more = step + 1 < h;
    // read-only: y and |x|^2 of step + 1 now, the index of step + 2 for
    // the next step's loads, the row ``ahead`` steps on for the refills
    const T y_next = labels_k[i_next];
    const T sq_next = sq_k[i_next];
    const int i_after = step + 2 < h ? idxs_k[step + 2] : i_next;
    const int i_ahead = step + ahead < h ? idxs_k[step + ahead] : 0;
    // this thread is done with its columns of the element in ``slot``:
    // refill it with the element S on, and move to the next slot
    auto refill = [&]() {
      fill(slot, kChunked && f_step == step ? i : i_ahead);
      if (++slot == stages) slot = 0;
    };

    T m0 = T(0), m1 = T(0);
    for (int j = 0; j < n_chunks; ++j) {
      wait_groups(stages - 1);  // this thread's columns of the element
      const T* x = ring + (size_t)slot * chunk;
      const int base = j * chunk;
      const int end = kChunked ? min(d, base + chunk) : d;
#pragma unroll 4
      for (int c = base + t; c < end; c += kThreads) {
        const T xc = x[c - base];
        m0 = m0 + xc * (kSmem ? w0s[c] : __ldg(w + c));
        if (!frozen) m1 = m1 + xc * dwk[c];
      }
      if (kChunked) refill();
    }
    m0 = warp_sum(m0);
    if (!frozen) m1 = warp_sum(m1);
    T* rp = red + (step & 1) * 2 * kWarps;
    if (lane == 0) {
      rp[warp] = m0;
      rp[kWarps + warp] = m1;
    }
    __syncthreads();  // the step's one barrier: the partials, and every
                      // alpha write up to step - 1, are visible

    // every warp, the same tree: lanes 0-15 sum the x.w0 partials, lanes
    // 16-31 the x.dw partials, then the halves swap sums
    T v = rp[lane];
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1)
      v = v + __shfl_xor_sync(0xffffffffu, v, off);
    const T other = __shfl_xor_sync(0xffffffffu, v, 16);
    const T r0 = lane < 16 ? v : other;
    const T r1 = lane < 16 ? other : v;
    const T a = rep ? a_prev : a_ld;
    // step + 1's alpha, in flight until after the next barrier; a repeat
    // of this step's row takes this step's a' instead
    const bool rep_next = i_next == i;
    if (more && !rep_next) a_ld = alpha_k[i_next];
    const T margin = frozen ? r0 : r0 + sig_eff * r1;
    const T new_a = alpha_step<T>(loss, a, y * margin, qii, lam_n, smoothing);
    const T coef = y * (new_a - a) / coef_div;
    if (t == 0) alpha_k[i] = new_a;
    for (int j = 0; j < n_chunks; ++j) {
      if (kChunked) wait_groups(stages - 1);
      const T* x = ring + (size_t)slot * chunk;
      const int base = j * chunk;
      const int end = kChunked ? min(d, base + chunk) : d;
#pragma unroll 4
      for (int c = base + t; c < end; c += kThreads)
        dwk[c] = dwk[c] + coef * x[c - base];
      refill();
    }

    a_prev = new_a;
    rep = rep_next;
    y = y_next;
    qii = sq_next * qii_factor;
    i = i_next;
    i_next = i_after;
  }

  if (kSmem) {
    T* out = dw_out + (size_t)k * d;
    for (int c = t; c < d; c += kThreads) out[c] = dwk[c];
  }
}

template <typename T>
int launch(const T* w, T* alpha, const T* X, const T* labels, const T* sq,
           const int* idxs, T* dw, int k, int n_shard, int d, int h, int loss,
           double lam_n, double coef_div, double sig_eff, double qii_factor,
           double smoothing, int frozen, int state_in_smem, int stages,
           int chunk, void* stream) {
  const size_t bytes = smem_bytes(d, sizeof(T), state_in_smem, stages, chunk);
  // the plan is the caller's: one that does not fit is refused, never
  // replaced by another.  A chunk is the whole row or a multiple of
  // kThreads columns, so each thread's columns of a chunk are its own.
  if (stages < 1 || stages > kMaxStages || chunk < 1 ||
      (chunk != d && (chunk > d || chunk % kThreads != 0)) ||
      bytes > (size_t)sdca::smem_optin())
    return (int)cudaErrorInvalidValue;
  const bool chunked = chunk < d;
  const auto kernel =
      state_in_smem ? (chunked ? dense_sdca_round_kernel<T, true, true>
                               : dense_sdca_round_kernel<T, true, false>)
                    : (chunked ? dense_sdca_round_kernel<T, false, true>
                               : dense_sdca_round_kernel<T, false, false>);
  const cudaError_t err = sdca::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<k, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      w, alpha, X, labels, sq, idxs, dw, n_shard, d, h, stages, chunk, loss,
      T(lam_n), T(coef_div), T(sig_eff), T(qii_factor), T(smoothing), frozen);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  ``alpha`` holds the round's starting
// alpha and is advanced in place; ``dw`` (K, d) is written whole.  Every
// tensor is contiguous; ``idxs`` is int32.  ``state_in_smem`` places w0
// and dw_k in shared memory (1) or global memory (0), ``stages`` is the
// ring depth (1..3), ``chunk`` a slot's width in columns (d, or a multiple
// of 512 below d); a plan that breaks these rules or whose bytes exceed
// the opt-in is refused with cudaErrorInvalidValue.  Returns
// cudaGetLastError().
extern "C" int dense_sdca_round_f32(
    const float* w, float* alpha, const float* X, const float* labels,
    const float* sq, const int* idxs, float* dw, int k, int n_shard, int d,
    int h, int loss, double lam_n, double coef_div, double sig_eff,
    double qii_factor, double smoothing, int frozen, int state_in_smem,
    int stages, int chunk, void* stream) {
  return launch<float>(w, alpha, X, labels, sq, idxs, dw, k, n_shard, d, h,
                       loss, lam_n, coef_div, sig_eff, qii_factor, smoothing,
                       frozen, state_in_smem, stages, chunk, stream);
}

extern "C" int dense_sdca_round_f64(
    const double* w, double* alpha, const double* X, const double* labels,
    const double* sq, const int* idxs, double* dw, int k, int n_shard, int d,
    int h, int loss, double lam_n, double coef_div, double sig_eff,
    double qii_factor, double smoothing, int frozen, int state_in_smem,
    int stages, int chunk, void* stream) {
  return launch<double>(w, alpha, X, labels, sq, idxs, dw, k, n_shard, d, h,
                        loss, lam_n, coef_div, sig_eff, qii_factor, smoothing,
                        frozen, state_in_smem, stages, chunk, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
