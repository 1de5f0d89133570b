// Device code shared by every SDCA kernel of the port: the loss codes and
// the single-coordinate alpha step (cocoa_tpu/ops/losses.py alpha_step,
// same constants: _EPS 1e-12, _U_MAX 35, 10 Newton iterations), with the
// lasso prox rule of ProxCoCoA+.  One copy of the loss rules, included by
// sparse_sdca.cu, dense_sdca.cu, block_chain.cu and sparse_block.cu; the
// kernel table of SDCA_KERNEL_INFO by draw_tables.cu too.

#pragma once

#include <cuda_runtime.h>

namespace sdca {

enum { kHinge = 0, kSmoothHinge = 1, kLogistic = 2, kLasso = 3 };

template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// New alpha in [0, 1] for margin z = y * (x . w), qii already scaled by
// the caller.  hinge: projected gradient on the box, qii == 0 gives 1;
// smooth_hinge: clipped closed form; logistic: Newton in logit space.
// lasso (mode prox): the new, unbounded coordinate, the soft-threshold
// step t = S_{lam/(qii+s)}((qii*a - z)/(qii+s)) with lam_n the L1 weight
// and s the elastic-net l2 weight; qii + s == 0 (a zero column, s = 0)
// leaves the coordinate as it is.
template <typename T>
__device__ T alpha_step(int loss, T a, T z, T qii, T lam_n, T s) {
  const T zero = T(0), one = T(1);
  if (loss == kLasso) {
    const T denom = qii + s;
    if (!(denom > zero)) return a;
    const T u = (qii * a - z) / denom;
    const T thr = lam_n / denom;
    const T mag = (u < zero ? -u : u) - thr;
    const T sgn = u > zero ? one : (u < zero ? -one : zero);
    return sgn * (mag > zero ? mag : zero);
  }
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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Ask L2 for every 128-byte line of the n values at ``row``, spread over
// a block of kThreads threads (a row the next step will read).
template <int kThreads, typename T>
__device__ __forceinline__ void prefetch_l2(const T* row, int n) {
  constexpr int kPerLine = 128 / sizeof(T);
  for (int j = threadIdx.x * kPerLine; j < n; j += kThreads * kPerLine)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(
        __cvta_generic_to_global(row + j)));
}

// Opt in to ``bytes`` of dynamic shared memory for ``kernel`` when it is
// above the 48 KB default; returns the CUDA error code.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline int smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

// One kernel of a library's table: its name and its function.
struct KernelEntry {
  const char* name;
  const void* fn;
};

// out[0..5] = the kernel's registers a thread, static shared memory,
// local (spill) bytes a thread, most threads a block, blocks an SM can
// hold at ``threads`` threads and ``dyn`` bytes of dynamic shared memory
// (opted in first, as its launch does), and the dynamic shared memory it
// may then take.  Returns the CUDA error code.
inline int kernel_info(const KernelEntry* table, int n, int i, int threads,
                       long long dyn, long long* out) {
  if (i < 0 || i >= n || threads < 1 || dyn < 0)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, table[i].fn);
  if (err != cudaSuccess) return (int)err;
  if (dyn > 48 * 1024) {
    err = cudaFuncSetAttribute(table[i].fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dyn);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncGetAttributes(&a, table[i].fn);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, table[i].fn, threads, (size_t)dyn);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (long long)a.sharedSizeBytes;
  out[2] = (long long)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  out[4] = blocks;
  out[5] = a.maxDynamicSharedSizeBytes;
  return (int)cudaSuccess;
}

}  // namespace sdca

// The read-only entry points of a library's kernel table ``TABLE`` (an
// array of sdca::KernelEntry): their count, the name of kernel i, and
// sdca::kernel_info of kernel i (analysis/kernel_budget.py).
#define SDCA_KERNEL_INFO(TABLE)                                             \
  extern "C" int kernel_count() {                                           \
    return (int)(sizeof(TABLE) / sizeof(TABLE[0]));                         \
  }                                                                         \
  extern "C" const char* kernel_name(int i) {                               \
    return i >= 0 && i < kernel_count() ? TABLE[i].name : "";               \
  }                                                                         \
  extern "C" int kernel_info(int i, int threads, long long dyn,             \
                             long long* out) {                              \
    return sdca::kernel_info(TABLE, kernel_count(), i, threads, dyn, out);  \
  }
