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
// Row i is expanded densely and row j's columns are picked from it, as the
// TPU kernel does, so a column repeated within a row sums and padded slots
// past a row's length are never read.
//
// What bounds it on this card: the Gram reads, for every pair i < j, row
// j's slots and row i's dense expansion at those columns: about
// K * B^2 / 2 * nnz * 8 B of mostly cached traffic against ~K * B * nnz of
// distinct input slots; the apply is a scatter of K * B * nnz adds, and
// its rows must stay in order.  Both are latency-bound at these sizes.
//
// What the design does about it:
// - Gram: grid (B, K); the block (i, k) zeroes a d-vector in shared
//   memory (d * sizeof(T) up to the 227 KB opt-in: rcv1-like float32 is
//   189 KB) or, beyond it, uses a zeroed global scratch row read past L1
//   (__ldcg), scatters row i into it with atomics (repeated columns add),
//   then its 8 warps each take later rows j and reduce sum_t v_j[t] *
//   xrow[f_j[t]] with a shuffle butterfly.  Warp 0 also writes mb[k, i].
//   A global scratch row is zeroed again at row i's columns after use, so
//   the caller keeps one buffer and zeroes it once, not d per launch.
// - apply: grid K; one block per shard walks rows j = 0..B-1 in order,
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

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

template <typename T, bool kSmem>
__global__ void __launch_bounds__(kThreads) gram_kernel(
    const T* __restrict__ w, const T* __restrict__ dw,
    const int* __restrict__ gidx, const T* __restrict__ gval,
    const int* __restrict__ cnts, T* __restrict__ gram, T* __restrict__ mb,
    T* __restrict__ scratch, int b, int width, int d, T sig_eff,
    int frozen) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int i = blockIdx.x, k = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t row_i = ((size_t)k * b + i) * width;
  const int cnt_i = cnts[(size_t)k * b + i];
  if (warp == 0) {
    T acc = T(0);
    for (int t = lane; t < cnt_i; t += 32) {
      const int f = gidx[row_i + t];
      T coord = w[f];
      if (!frozen) coord = coord + sig_eff * dw[(size_t)k * d + f];
      acc = acc + gval[row_i + t] * coord;
    }
    acc = sdca::warp_sum(acc);
    if (lane == 0) mb[(size_t)k * b + i] = acc;
  }
  if (frozen) return;
  T* xrow = kSmem ? reinterpret_cast<T*>(smem_raw)
                  : scratch + ((size_t)k * b + i) * d;
  if (kSmem)
    for (int f = tid; f < d; f += kThreads) xrow[f] = T(0);
  __syncthreads();
  for (int t = tid; t < cnt_i; t += kThreads)
    atomicAdd(xrow + gidx[row_i + t], gval[row_i + t]);
  __syncthreads();
  for (int j = warp; j < b; j += kThreads / 32) {
    T acc = T(0);
    if (j > i) {
      const size_t row_j = ((size_t)k * b + j) * width;
      const int cnt_j = cnts[(size_t)k * b + j];
      for (int t = lane; t < cnt_j; t += 32) {
        const int f = gidx[row_j + t];
        const T xv = kSmem ? xrow[f] : __ldcg(xrow + f);
        acc = acc + gval[row_j + t] * xv;
      }
      acc = sdca::warp_sum(acc);
    }
    if (lane == 0) gram[((size_t)k * b + j) * b + i] = acc;
  }
  if (!kSmem) {
    __syncthreads();  // every warp has read the row
    for (int t = tid; t < cnt_i; t += kThreads) xrow[gidx[row_i + t]] = T(0);
  }
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

template <typename T>
int launch_gram(const T* w, const T* dw, const int* gidx, const T* gval,
                const int* cnts, T* gram, T* mb, T* scratch, int k, int b,
                int width, int d, double sig_eff, int frozen, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(b, k);
  if (scratch == nullptr) {
    const size_t bytes = frozen ? 0 : (size_t)d * sizeof(T);
    if (bytes > (size_t)sdca::smem_optin()) return (int)cudaErrorInvalidValue;
    cudaError_t err = sdca::allow_smem(gram_kernel<T, true>, bytes);
    if (err != cudaSuccess) return (int)err;
    gram_kernel<T, true><<<grid, kThreads, bytes, s>>>(
        w, dw, gidx, gval, cnts, gram, mb, scratch, b, width, d, T(sig_eff),
        frozen);
  } else {
    gram_kernel<T, false><<<grid, kThreads, 0, s>>>(
        w, dw, gidx, gval, cnts, gram, mb, scratch, b, width, d, T(sig_eff),
        frozen);
  }
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
// (``gram`` is null in frozen mode); ``scratch`` is null to expand rows in
// shared memory, or a zeroed (K, B, d) buffer, which is zeroed again on
// return.  ``dw`` is advanced in
// place by the apply.  Returns cudaGetLastError().
#define GRAM_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const T* w, const T* dw, const int* gidx,             \
                      const T* gval, const int* cnts, T* gram, T* mb,       \
                      T* scratch, int k, int b, int width, int d,           \
                      double sig_eff, int frozen, void* stream) {           \
    return launch_gram<T>(w, dw, gidx, gval, cnts, gram, mb, scratch, k, b, \
                          width, d, sig_eff, frozen, stream);               \
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
