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
// 3.35 TB/s; the round is latency-bound: H times the latency of one step's
// load -> reduce -> update -> scatter chain.
//
// What the design does about it:
// - one block of ONE warp per shard.  The row's slots are strided over the
//   32 lanes, the margin is a shuffle butterfly (every lane ends with the
//   same bits, because IEEE addition is commutative), and every lane then
//   computes the same a' and coef itself.  No __syncthreads and no shared
//   broadcast sit on the chain; two __syncwarp per step order the alpha
//   write and the dw scatter against the next step's reads.
// - dw_k lives in shared memory when d * sizeof(T) fits the opt-in
//   dynamic shared memory (227 KB: d = 47 236 fits in float32, 189 KB),
//   so the margin's dw gathers and the scatter are shared-memory accesses.
//   Otherwise (float64 at rcv1 width), or when the caller passes
//   allow_smem = 0, dw_k lives in global memory and is read with __ldcg,
//   past L1, because the scatter's atomics land in L2.
// - the loops stop at row_len, so padded slots (index 0, value 0) are
//   never touched: in a parallel scatter a padded slot's dw[0] += 0 would
//   race with a real column 0 of the same row.  The scatter uses atomics
//   as well, so a column repeated within a row adds both values.
// - the TPU kernel's SMEM segmentation, lane-blocked [w|dw] layout, GROUP
//   unroll and per-round (K, H, W) gather tables are TPU addressing
//   workarounds and have no counterpart here: a lane reads its slot's
//   column and value straight from the CSR arrays.
//
// The hybrid branch (the hot/cold column split, --hotCols; the TPU
// kernel's hot_panel/hot_cols operands) is a second kernel below,
// sparse_sdca_hybrid_kernel.  The CSR streams then hold only each row's
// cold residual, and a step also reads the row's dense hot-panel slice:
//   margin += sum_l hrow[l] * (w_hot[l] + sig_eff * dw_hot[l])
//   dw_hot += coef * hrow                          (after alpha_step)
// with w_hot = w[hot_cols]; on return dw_k has dw_hot added at hot_cols.
// At rcv1-like width a step reads a 5248-wide panel row (21 KB in
// float32) and about 18 residual nonzeros, so a step is a dense step over
// the panel plus a sparse step over the residual, and one warp would give
// each lane 164 panel loads on the chain.  Its design:
// - one block of kHybridThreads threads per shard.  Thread t owns panel
//   lanes t, t + kHybridThreads, ... for the whole round (w_hot and dw_hot
//   need no barrier); warp 0 also walks the residual's slots, as the plain
//   kernel's warp does, and scatters them with atomics.  The hot dot and
//   the residual's sum go through one fixed reduction tree (a warp
//   butterfly, then warp 0 over the warp sums); thread 0 runs alpha_step
//   and hands coef to the block: two __syncthreads per step, as in
//   dense_sdca.cu.  The first kHotUnroll lanes of a thread stay in
//   registers between the dot and the axpy; the next step's panel row is
//   prefetched into L2.
// - dw_k and dw_hot live in shared memory when (d + n_hot) * sizeof(T)
//   fits the opt-in (float32 at rcv1-like width: 189 KB + 21 KB), else in
//   global memory (dw_k in its output row, dw_hot in a scratch row).
//   w_hot is gathered into a scratch row at the start, each lane by its
//   owner, and read from there.
// - the fold of dw_hot into dw_k uses atomics: panel padding lanes carry
//   column 0 and value 0, so they add 0 at column 0, where a real hot
//   column 0 or a cold column 0 may be added in the same pass.

#include <cuda_runtime.h>

#include "sdca_common.cuh"

namespace {

using sdca::alpha_step;

template <typename T, bool kSmem>
__device__ __forceinline__ T load_dw(const T* dw, int f) {
  if (kSmem) return dw[f];
  return __ldcg(dw + f);
}

template <typename T, bool kSmem>
__global__ void __launch_bounds__(32) sparse_sdca_round_kernel(
    const T* __restrict__ w, T* __restrict__ alpha,
    const int* __restrict__ sp_idx, const T* __restrict__ sp_val,
    const T* __restrict__ labels, const T* __restrict__ sq,
    const int* __restrict__ idxs, const int* __restrict__ row_len,
    T* __restrict__ dw_out, int n_shard, int width, int d, int h, int loss,
    T lam_n, T coef_div, T sig_eff, T qii_factor, T smoothing, int frozen) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = blockIdx.x;
  const int lane = threadIdx.x;
  T* dwk = kSmem ? reinterpret_cast<T*>(smem_raw) : dw_out + (size_t)k * d;
  T* alpha_k = alpha + (size_t)k * n_shard;
  const T* labels_k = labels + (size_t)k * n_shard;
  const T* sq_k = sq + (size_t)k * n_shard;
  const int* len_k = row_len + (size_t)k * n_shard;
  const int* idxs_k = idxs + (size_t)k * h;

  for (int j = lane; j < d; j += 32) dwk[j] = T(0);
  if (!kSmem) __threadfence_block();
  __syncwarp();

  for (int step = 0; step < h; ++step) {
    const int i = idxs_k[step];
    const size_t row = ((size_t)k * n_shard + i) * width;
    const int len = len_k[i];
    const T y = labels_k[i];
    const T a = alpha_k[i];
    const T qii = sq_k[i] * qii_factor;

    T acc = T(0);
    for (int j = lane; j < len; j += 32) {
      const int f = sp_idx[row + j];
      T coord = w[f];
      if (!frozen) coord = coord + sig_eff * load_dw<T, kSmem>(dwk, f);
      acc = acc + sp_val[row + j] * coord;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);

    const T new_a = alpha_step<T>(loss, a, y * acc, qii, lam_n, smoothing);
    const T coef = y * (new_a - a) / coef_div;
    for (int j = lane; j < len; j += 32)
      atomicAdd(dwk + sp_idx[row + j], coef * sp_val[row + j]);
    __syncwarp();  // every lane has read alpha[k, i] for this step
    if (lane == 0) alpha_k[i] = new_a;
    if (!kSmem) __threadfence_block();
    __syncwarp();  // the alpha write and the scatter precede the next step
  }

  if (kSmem) {
    T* out = dw_out + (size_t)k * d;
    for (int j = lane; j < d; j += 32) out[j] = dwk[j];
  }
}

template <typename T>
int launch(const T* w, T* alpha, const int* sp_idx, const T* sp_val,
           const T* labels, const T* sq, const int* idxs, const int* row_len,
           T* dw, int k, int n_shard, int width, int d, int h, int loss,
           double lam_n, double coef_div, double sig_eff, double qii_factor,
           double smoothing, int frozen, int allow_smem, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = (size_t)d * sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (allow_smem && bytes <= (size_t)smem_optin) {
    err = cudaFuncSetAttribute(sparse_sdca_round_kernel<T, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    sparse_sdca_round_kernel<T, true><<<k, 32, bytes, s>>>(
        w, alpha, sp_idx, sp_val, labels, sq, idxs, row_len, dw, n_shard,
        width, d, h, loss, T(lam_n), T(coef_div), T(sig_eff), T(qii_factor),
        T(smoothing), frozen);
  } else {
    sparse_sdca_round_kernel<T, false><<<k, 32, 0, s>>>(
        w, alpha, sp_idx, sp_val, labels, sq, idxs, row_len, dw, n_shard,
        width, d, h, loss, T(lam_n), T(coef_div), T(sig_eff), T(qii_factor),
        T(smoothing), frozen);
  }
  return (int)cudaGetLastError();
}

constexpr int kHybridThreads = 512;
constexpr int kHybridWarps = kHybridThreads / 32;
constexpr int kHotUnroll = 16;  // panel lanes a thread loads at once

template <typename T, bool kSmem>
__global__ void __launch_bounds__(kHybridThreads) sparse_sdca_hybrid_kernel(
    const T* __restrict__ w, T* __restrict__ alpha,
    const int* __restrict__ sp_idx, const T* __restrict__ sp_val,
    const T* __restrict__ labels, const T* __restrict__ sq,
    const int* __restrict__ idxs, const int* __restrict__ row_len,
    const T* __restrict__ hot_panel, const int* __restrict__ hot_cols,
    T* __restrict__ scratch, T* __restrict__ dw_out, int n_shard, int width,
    int d, int h, int n_hot, int loss, T lam_n, T coef_div, T sig_eff,
    T qii_factor, T smoothing, int frozen) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // layout: the warp sums and coef, then [dw_k (d) | dw_hot (n_hot)] when
  // kSmem
  T* red = reinterpret_cast<T*>(smem_raw);
  T* coef_s = red + kHybridWarps;
  const int k = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  T* dwk = kSmem ? coef_s + 1 : dw_out + (size_t)k * d;
  T* w_hot = scratch + (size_t)k * 2 * n_hot;
  T* dwh = kSmem ? dwk + d : w_hot + n_hot;
  T* alpha_k = alpha + (size_t)k * n_shard;
  const T* labels_k = labels + (size_t)k * n_shard;
  const T* sq_k = sq + (size_t)k * n_shard;
  const int* len_k = row_len + (size_t)k * n_shard;
  const int* idxs_k = idxs + (size_t)k * h;
  const int* hc_k = hot_cols + (size_t)k * n_hot;
  const T* panel_k = hot_panel + (size_t)k * n_shard * n_hot;
  constexpr int kBatch = kHybridThreads * kHotUnroll;

  for (int c = t; c < d; c += kHybridThreads) dwk[c] = T(0);
  for (int l = t; l < n_hot; l += kHybridThreads) {  // lane l's owner
    w_hot[l] = w[hc_k[l]];
    dwh[l] = T(0);
  }
  __syncthreads();  // warp 0's scatter may reach any column of dw_k
  if (h > 0)
    sdca::prefetch_l2<kHybridThreads>(panel_k + (size_t)idxs_k[0] * n_hot,
                                      n_hot);

  for (int step = 0; step < h; ++step) {
    const int i = idxs_k[step];
    const T* hrow = panel_k + (size_t)i * n_hot;
    if (step + 1 < h)
      sdca::prefetch_l2<kHybridThreads>(
          panel_k + (size_t)idxs_k[step + 1] * n_hot, n_hot);
    T y = T(0), a = T(0), qii = T(0);
    if (t == 0) {  // in flight while the dots run
      y = labels_k[i];
      a = alpha_k[i];
      qii = sq_k[i] * qii_factor;
    }
    T acc = T(0);
    T x0[kHotUnroll];  // the first batch of lanes, kept for the axpy
#pragma unroll
    for (int u = 0; u < kHotUnroll; ++u) {
      const int l = t + u * kHybridThreads;
      x0[u] = l < n_hot ? hrow[l] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kHotUnroll; ++u) {
      const int l = t + u * kHybridThreads;
      if (l < n_hot)
        acc = acc + x0[u] * (frozen ? w_hot[l] : w_hot[l] + sig_eff * dwh[l]);
    }
    for (int base = t + kBatch; base < n_hot; base += kBatch) {
      T x[kHotUnroll];
#pragma unroll
      for (int u = 0; u < kHotUnroll; ++u) {
        const int l = base + u * kHybridThreads;
        x[u] = l < n_hot ? hrow[l] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kHotUnroll; ++u) {
        const int l = base + u * kHybridThreads;
        if (l < n_hot)
          acc = acc + x[u] * (frozen ? w_hot[l] : w_hot[l] + sig_eff * dwh[l]);
      }
    }
    // the cold residual: warp 0 strides the row's slots over its lanes
    int len = 0;
    size_t row = 0;
    if (warp == 0) {
      len = len_k[i];
      row = ((size_t)k * n_shard + i) * width;
      for (int j = lane; j < len; j += 32) {
        const int f = sp_idx[row + j];
        T coord = w[f];
        if (!frozen) coord = coord + sig_eff * load_dw<T, kSmem>(dwk, f);
        acc = acc + sp_val[row + j] * coord;
      }
    }

    acc = sdca::warp_sum(acc);
    if (lane == 0) red[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      T r = lane < kHybridWarps ? red[lane] : T(0);
      r = sdca::warp_sum(r);
      if (lane == 0) {
        const T new_a = alpha_step<T>(loss, a, y * r, qii, lam_n, smoothing);
        *coef_s = y * (new_a - a) / coef_div;
        alpha_k[i] = new_a;
      }
    }
    __syncthreads();  // coef is ready; the warp sums may be reused
    const T coef = *coef_s;
#pragma unroll
    for (int u = 0; u < kHotUnroll; ++u) {
      const int l = t + u * kHybridThreads;
      if (l < n_hot) dwh[l] = dwh[l] + coef * x0[u];
    }
    for (int l = t + kBatch; l < n_hot; l += kHybridThreads)
      dwh[l] = dwh[l] + coef * hrow[l];
    if (warp == 0) {
      for (int j = lane; j < len; j += 32)
        atomicAdd(dwk + sp_idx[row + j], coef * sp_val[row + j]);
      if (!kSmem) __threadfence_block();
      __syncwarp();  // the scatter precedes warp 0's next reads of dw_k
    }
  }

  __syncthreads();  // every step's scatter is in dw_k
  for (int l = t; l < n_hot; l += kHybridThreads)
    atomicAdd(dwk + hc_k[l], dwh[l]);
  if (kSmem) {
    __syncthreads();
    T* out = dw_out + (size_t)k * d;
    for (int c = t; c < d; c += kHybridThreads) out[c] = dwk[c];
  }
}

template <typename T>
int launch_hybrid(const T* w, T* alpha, const int* sp_idx, const T* sp_val,
                  const T* labels, const T* sq, const int* idxs,
                  const int* row_len, const T* hot_panel,
                  const int* hot_cols, T* scratch, T* dw, int k, int n_shard,
                  int width, int d, int h, int n_hot, int loss, double lam_n,
                  double coef_div, double sig_eff, double qii_factor,
                  double smoothing, int frozen, int allow_smem,
                  void* stream) {
  const size_t scalars = (kHybridWarps + 1) * sizeof(T);
  const size_t state = ((size_t)d + n_hot) * sizeof(T);
  const bool in_smem =
      allow_smem && scalars + state <= (size_t)sdca::smem_optin();
  const size_t bytes = scalars + (in_smem ? state : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_smem) {
    err = sdca::allow_smem(sparse_sdca_hybrid_kernel<T, true>, bytes);
    if (err != cudaSuccess) return (int)err;
    sparse_sdca_hybrid_kernel<T, true><<<k, kHybridThreads, bytes, s>>>(
        w, alpha, sp_idx, sp_val, labels, sq, idxs, row_len, hot_panel,
        hot_cols, scratch, dw, n_shard, width, d, h, n_hot, loss, T(lam_n),
        T(coef_div), T(sig_eff), T(qii_factor), T(smoothing), frozen);
  } else {
    sparse_sdca_hybrid_kernel<T, false><<<k, kHybridThreads, bytes, s>>>(
        w, alpha, sp_idx, sp_val, labels, sq, idxs, row_len, hot_panel,
        hot_cols, scratch, dw, n_shard, width, d, h, n_hot, loss, T(lam_n),
        T(coef_div), T(sig_eff), T(qii_factor), T(smoothing), frozen);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  ``alpha`` holds the round's starting
// alpha and is advanced in place; ``dw`` (K, d) is written whole.  Every
// tensor is contiguous; indices are int32.  ``allow_smem`` = 0 keeps dw_k
// in global memory even where it fits shared memory.  Returns
// cudaGetLastError().
extern "C" int sparse_sdca_round_f32(
    const float* w, float* alpha, const int* sp_idx, const float* sp_val,
    const float* labels, const float* sq, const int* idxs,
    const int* row_len, float* dw, int k, int n_shard, int width, int d,
    int h, int loss, double lam_n, double coef_div, double sig_eff,
    double qii_factor, double smoothing, int frozen, int allow_smem,
    void* stream) {
  return launch<float>(w, alpha, sp_idx, sp_val, labels, sq, idxs, row_len,
                       dw, k, n_shard, width, d, h, loss, lam_n, coef_div,
                       sig_eff, qii_factor, smoothing, frozen, allow_smem,
                       stream);
}

extern "C" int sparse_sdca_round_f64(
    const double* w, double* alpha, const int* sp_idx, const double* sp_val,
    const double* labels, const double* sq, const int* idxs,
    const int* row_len, double* dw, int k, int n_shard, int width, int d,
    int h, int loss, double lam_n, double coef_div, double sig_eff,
    double qii_factor, double smoothing, int frozen, int allow_smem,
    void* stream) {
  return launch<double>(w, alpha, sp_idx, sp_val, labels, sq, idxs, row_len,
                        dw, k, n_shard, width, d, h, loss, lam_n, coef_div,
                        sig_eff, qii_factor, smoothing, frozen, allow_smem,
                        stream);
}

// The hybrid branch: the CSR streams hold the cold residual, and
// ``hot_panel`` (K, n_shard, n_hot) / ``hot_cols`` int32 (K, n_hot) the hot
// panel; ``scratch`` (K, 2, n_hot) is the kernel's (w_hot, dw_hot).
// ``allow_smem`` = 0 keeps dw_k and dw_hot in global memory.
extern "C" int sparse_sdca_hybrid_f32(
    const float* w, float* alpha, const int* sp_idx, const float* sp_val,
    const float* labels, const float* sq, const int* idxs,
    const int* row_len, const float* hot_panel, const int* hot_cols,
    float* scratch, float* dw, int k, int n_shard, int width, int d, int h,
    int n_hot, int loss, double lam_n, double coef_div, double sig_eff,
    double qii_factor, double smoothing, int frozen, int allow_smem,
    void* stream) {
  return launch_hybrid<float>(
      w, alpha, sp_idx, sp_val, labels, sq, idxs, row_len, hot_panel,
      hot_cols, scratch, dw, k, n_shard, width, d, h, n_hot, loss, lam_n,
      coef_div, sig_eff, qii_factor, smoothing, frozen, allow_smem, stream);
}

extern "C" int sparse_sdca_hybrid_f64(
    const double* w, double* alpha, const int* sp_idx, const double* sp_val,
    const double* labels, const double* sq, const int* idxs,
    const int* row_len, const double* hot_panel, const int* hot_cols,
    double* scratch, double* dw, int k, int n_shard, int width, int d, int h,
    int n_hot, int loss, double lam_n, double coef_div, double sig_eff,
    double qii_factor, double smoothing, int frozen, int allow_smem,
    void* stream) {
  return launch_hybrid<double>(
      w, alpha, sp_idx, sp_val, labels, sq, idxs, row_len, hot_panel,
      hot_cols, scratch, dw, k, n_shard, width, d, h, n_hot, loss, lam_n,
      coef_div, sig_eff, qii_factor, smoothing, frozen, allow_smem, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
