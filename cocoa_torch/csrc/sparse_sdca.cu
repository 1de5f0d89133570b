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

#include <cuda_runtime.h>

namespace {

enum { kHinge = 0, kSmoothHinge = 1, kLogistic = 2 };

template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// cocoa_tpu/ops/losses.py alpha_step, same constants (_EPS 1e-12,
// _U_MAX 35, 10 Newton iterations).
template <typename T>
__device__ T alpha_step(int loss, T a, T z, T qii, T lam_n, T s) {
  const T zero = T(0), one = T(1);
  if (loss == kHinge) {
    const T grad = (z - one) * lam_n;
    const T proj = a <= zero ? (grad < zero ? grad : zero)
                 : (a >= one ? (grad > zero ? grad : zero) : grad);
    const T new_a = qii != zero ? clip(a - grad / qii, zero, one) : one;
    return proj != zero ? new_a : a;
  }
  if (loss == kSmoothHinge) {
    const T grad = (z - one + s * a) * lam_n;
    return clip(a - grad / (qii + s * lam_n), zero, one);
  }
  const T ac = clip(a, T(1e-12), T(1.0 - 1e-12));
  const T q = qii / lam_n;
  T u = clip(log_t(ac / (one - ac)), T(-35), T(35));
  for (int it = 0; it < 10; ++it) {
    const T sig = one / (one + exp_t(-u));
    const T g = u + z + q * (sig - ac);
    const T gp = one + q * sig * (one - sig);
    u = clip(u - g / gp, T(-35), T(35));
  }
  return one / (one + exp_t(-u));
}

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

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
