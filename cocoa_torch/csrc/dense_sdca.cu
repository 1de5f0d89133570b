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
// bound: H times one step's load -> reduce -> alpha_step -> axpy chain.
//
// What the design does about it (simple first; speed is later work):
// - one block of kThreads threads per shard.  Thread t owns columns
//   t, t + kThreads, ... of w0 and dw_k for the whole round, so the vector
//   state needs no barrier at all: only the two dot products cross
//   threads.
// - w0 and dw_k live in shared memory when 2 * d * sizeof(T) fits the
//   opt-in (227 KB: d = 9947 fits in float32 and float64), else in global
//   memory (w0 read through the read-only path, dw_k in its output row),
//   still owned column by column.
// - both dots are reduced together in one fixed tree (a warp butterfly,
//   then warp 0 over the warp sums), so two launches agree bit for bit;
//   thread 0 runs alpha_step, writes alpha and hands coef to the block
//   through shared memory: two __syncthreads per step.
// - the next step's row is prefetched into L2 while this step runs
//   (idxs is known before the launch); each thread issues kUnroll of its
//   row loads before it uses any, and the axpy re-reads the current row,
//   which the dots have just brought on chip.
// - thread 0 reads alpha[k, i] after its own write of the step before, so
//   a row drawn twice reads the alpha its last draw wrote.  alpha stays in
//   global memory (float64 epsilon-like shards hold 400 KB of it).
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
constexpr int kUnroll = 8;  // row elements a thread loads at once

template <typename T, bool kSmem>
__global__ void __launch_bounds__(kThreads) dense_sdca_round_kernel(
    const T* __restrict__ w, T* __restrict__ alpha, const T* __restrict__ X,
    const T* __restrict__ labels, const T* __restrict__ sq,
    const int* __restrict__ idxs, T* __restrict__ dw_out, int n_shard, int d,
    int h, int loss, T lam_n, T coef_div, T sig_eff, T qii_factor,
    T smoothing, int frozen) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  // layout: [dw_k (d) | w0 (d)] when kSmem, then the warp sums and coef
  T* red = smem + (kSmem ? 2 * d : 0);  // (2, kWarps)
  T* coef_s = red + 2 * kWarps;
  const int k = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  T* dwk = kSmem ? smem : dw_out + (size_t)k * d;
  const T* w0s = smem + d;
  T* alpha_k = alpha + (size_t)k * n_shard;
  const T* labels_k = labels + (size_t)k * n_shard;
  const T* sq_k = sq + (size_t)k * n_shard;
  const int* idxs_k = idxs + (size_t)k * h;
  const T* X_k = X + (size_t)k * n_shard * d;

  for (int c = t; c < d; c += kThreads) {
    dwk[c] = T(0);
    if (kSmem) smem[d + c] = w[c];
  }
  // no barrier: every later access to column c is made by thread t
  if (h > 0) sdca::prefetch_l2<kThreads>(X_k + (size_t)idxs_k[0] * d, d);

  for (int step = 0; step < h; ++step) {
    const int i = idxs_k[step];
    const T* row = X_k + (size_t)i * d;
    if (step + 1 < h)
      sdca::prefetch_l2<kThreads>(X_k + (size_t)idxs_k[step + 1] * d, d);
    T y = T(0), a = T(0), qii = T(0);
    if (t == 0) {  // in flight while the dots run
      y = labels_k[i];
      a = alpha_k[i];
      qii = sq_k[i] * qii_factor;
    }
    T m0 = T(0), m1 = T(0);
    for (int base = t; base < d; base += kThreads * kUnroll) {
      T x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // kUnroll row loads in flight
        const int c = base + u * kThreads;
        x[u] = c < d ? row[c] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = base + u * kThreads;
        if (c < d) {
          m0 = m0 + x[u] * (kSmem ? w0s[c] : __ldg(w + c));
          if (!frozen) m1 = m1 + x[u] * dwk[c];
        }
      }
    }

    m0 = warp_sum(m0);
    m1 = warp_sum(m1);
    if (lane == 0) {
      red[warp] = m0;
      red[kWarps + warp] = m1;
    }
    __syncthreads();
    if (warp == 0) {
      T r0 = lane < kWarps ? red[lane] : T(0);
      T r1 = lane < kWarps ? red[kWarps + lane] : T(0);
      r0 = warp_sum(r0);
      r1 = warp_sum(r1);
      if (lane == 0) {
        const T margin = frozen ? r0 : r0 + sig_eff * r1;
        const T new_a =
            alpha_step<T>(loss, a, y * margin, qii, lam_n, smoothing);
        *coef_s = y * (new_a - a) / coef_div;
        alpha_k[i] = new_a;
      }
    }
    __syncthreads();  // coef is ready; the warp sums may be reused
    const T coef = *coef_s;
    for (int base = t; base < d; base += kThreads * kUnroll) {
      T x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = base + u * kThreads;
        x[u] = c < d ? row[c] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = base + u * kThreads;
        if (c < d) dwk[c] = dwk[c] + coef * x[u];
      }
    }
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
           double smoothing, int frozen, int allow_smem, void* stream) {
  const size_t scalars = (2 * kWarps + 1) * sizeof(T);
  const size_t state = 2 * (size_t)d * sizeof(T);
  const bool in_smem =
      allow_smem && state + scalars <= (size_t)sdca::smem_optin();
  const size_t bytes = scalars + (in_smem ? state : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_smem) {
    err = sdca::allow_smem(dense_sdca_round_kernel<T, true>, bytes);
    if (err != cudaSuccess) return (int)err;
    dense_sdca_round_kernel<T, true><<<k, kThreads, bytes, s>>>(
        w, alpha, X, labels, sq, idxs, dw, n_shard, d, h, loss, T(lam_n),
        T(coef_div), T(sig_eff), T(qii_factor), T(smoothing), frozen);
  } else {
    dense_sdca_round_kernel<T, false><<<k, kThreads, bytes, s>>>(
        w, alpha, X, labels, sq, idxs, dw, n_shard, d, h, loss, T(lam_n),
        T(coef_div), T(sig_eff), T(qii_factor), T(smoothing), frozen);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  ``alpha`` holds the round's starting
// alpha and is advanced in place; ``dw`` (K, d) is written whole.  Every
// tensor is contiguous; ``idxs`` is int32.  ``allow_smem`` = 0 keeps w0
// and dw_k in global memory even where they fit shared memory.  Returns
// cudaGetLastError().
extern "C" int dense_sdca_round_f32(
    const float* w, float* alpha, const float* X, const float* labels,
    const float* sq, const int* idxs, float* dw, int k, int n_shard, int d,
    int h, int loss, double lam_n, double coef_div, double sig_eff,
    double qii_factor, double smoothing, int frozen, int allow_smem,
    void* stream) {
  return launch<float>(w, alpha, X, labels, sq, idxs, dw, k, n_shard, d, h,
                       loss, lam_n, coef_div, sig_eff, qii_factor, smoothing,
                       frozen, allow_smem, stream);
}

extern "C" int dense_sdca_round_f64(
    const double* w, double* alpha, const double* X, const double* labels,
    const double* sq, const int* idxs, double* dw, int k, int n_shard, int d,
    int h, int loss, double lam_n, double coef_div, double sig_eff,
    double qii_factor, double smoothing, int frozen, int allow_smem,
    void* stream) {
  return launch<double>(w, alpha, X, labels, sq, idxs, dw, k, n_shard, d, h,
                        loss, lam_n, coef_div, sig_eff, qii_factor, smoothing,
                        frozen, allow_smem, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
