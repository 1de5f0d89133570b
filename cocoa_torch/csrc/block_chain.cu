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
//   (each step: two B-wide dots, a shuffle reduction, alpha_step, one
//   shared-memory write), not bytes or flops;
// - the fused block: the Gram, K * B^2 * d / 2 multiply-adds on the CUDA
//   cores of K SMs (one block per shard), then the chain.
//
// What the design does about it:
// - one warp runs a shard's chain.  Coefficients, deltas, indices and the
//   step scalars live in shared memory; the i-strided dots end in a
//   shuffle butterfly, so every lane holds the same bits and computes a'
//   itself.  Gram row j+1 is loaded into registers while step j reduces
//   (the loads do not depend on the chain), hiding their latency.
// - repeated draws compare int32 indices, so there is no (B, K, B)
//   equality tile and no 2^24 limit on the shard size.
// - the fused kernel keeps the (B, B) Gram in shared memory (64 KB at
//   B = 128 in float32); 256 threads compute it in 64 x 64 tiles over
//   32-wide slices of d, each thread a 4 x 4 register tile, the next slice
//   loaded into registers while the current one is multiplied.  Plain FP32
//   fused multiply-adds, no TF32: the gap certificate rests on
//   w = (1 / lam n) sum y alpha x, and tensor-core TF32 keeps three digits.
// - the TPU kernel's lane-blocked (6K, B) scalar tile, j-leading
//   (B, 2K, B) Gram layout, half-tile grid and f32-cast index compare are
//   TPU layout workarounds; here the Gram is (K, B, B) with row j of shard
//   k contiguous.

#include <cuda_runtime.h>

#include "sdca_common.cuh"

namespace {

constexpr int kThreads = 256;  // fused block
constexpr int kTile = 64;      // Gram output tile (rows and columns)
constexpr int kDk = 32;        // slice of d per tile step
constexpr int kLd = kDk + 1;   // padded shared row: no bank conflicts

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

// B3: grid K, one warp per shard.  scal (K, 6, B) = [m0 | y | qii | a0 |
// mb | live]; gram (K, B, B) or null (frozen); idx (K, B) int32.
template <typename T, int R>
__global__ void __launch_bounds__(32) chain_kernel(
    const T* __restrict__ scal, const T* __restrict__ gram,
    const int* __restrict__ idx, T* __restrict__ delta_out,
    T* __restrict__ coef_out, int b, int loss, T lam_n, T coef_div,
    T sig_eff, T smoothing) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  T* coef = s + 6 * b;
  T* delta = coef + b;
  int* ix = reinterpret_cast<int*>(delta + b);
  const int k = blockIdx.x, lane = threadIdx.x;
  const T* sc = scal + (size_t)k * 6 * b;
  for (int t = lane; t < 6 * b; t += 32) s[t] = sc[t];
  for (int t = lane; t < b; t += 32) ix[t] = idx[(size_t)k * b + t];
  __syncwarp();
  chain_warp<T, R>(b, s, s + 4 * b, s + b, s + 2 * b, s + 3 * b, s + 5 * b,
                   ix, gram != nullptr ? gram + (size_t)k * b * b : nullptr,
                   b, coef, delta, loss, lam_n, coef_div, sig_eff, smoothing);
  for (int t = lane; t < b; t += 32) {
    delta_out[(size_t)k * b + t] = delta[t];
    coef_out[(size_t)k * b + t] = coef[t];
  }
}

// B4: grid K, 256 threads per shard.  xb (K, B, d) the block's rows;
// yb, qb, a0, live (K, B); idx (K, B) int32; v (K, d).  Writes delta
// (K, B) and dwu (K, d).
template <typename T, int R>
__global__ void __launch_bounds__(kThreads) fused_kernel(
    const T* __restrict__ xb, const int* __restrict__ idx,
    const T* __restrict__ yb, const T* __restrict__ qb,
    const T* __restrict__ a0, const T* __restrict__ live,
    const T* __restrict__ v, T* __restrict__ delta_out,
    T* __restrict__ dwu_out, int b, int d, int loss, T lam_n, T coef_div,
    T sig_eff, T smoothing, int frozen) {
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
  const int k = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const T* x = xb + (size_t)k * b * d;
  const T* vk = v + (size_t)k * d;
  for (int t = tid; t < b; t += kThreads) {
    const size_t o = (size_t)k * b + t;
    ys[t] = yb[o];
    qs[t] = qb[o];
    as0[t] = a0[o];
    ls[t] = live[o];
    ix[t] = idx[o];
  }
  // margins x_j . v, one warp per row
  for (int j = warp; j < b; j += kThreads / 32) {
    T acc = T(0);
    for (int f = lane; f < d; f += 32) acc = acc + x[(size_t)j * d + f] * vk[f];
    acc = sdca::warp_sum(acc);
    if (lane == 0) m0[j] = acc;
  }
  if (!frozen) {
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
            pa[p] = (ri < b && f < d) ? x[(size_t)ri * d + f] : T(0);
            pb[p] = (rj < b && f < d) ? x[(size_t)rj * d + f] : T(0);
          }
        };
        fetch(0);
        for (int f0 = 0; f0 < d; f0 += kDk) {
          __syncthreads();  // the previous slice is no longer read
#pragma unroll
          for (int p = 0; p < kPer; ++p) {
            const int r = tid / kDk + p * (kThreads / kDk), c = tid % kDk;
            ta[r * kLd + c] = pa[p];
            tb[r * kLd + c] = pb[p];
          }
          __syncthreads();
          if (f0 + kDk < d) fetch(f0 + kDk);  // overlaps the products
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
  __syncthreads();
  if (warp == 0)
    chain_warp<T, R>(b, m0, nullptr, ys, qs, as0, ls, ix,
                     frozen ? nullptr : gram, b, coef, delta, loss, lam_n,
                     coef_div, sig_eff, smoothing);
  __syncthreads();
  for (int t = tid; t < b; t += kThreads)
    delta_out[(size_t)k * b + t] = delta[t];
  for (int f = tid; f < d; f += kThreads) {
    T acc = T(0);
    for (int j = 0; j < b; ++j) acc = acc + coef[j] * x[(size_t)j * d + f];
    dwu_out[(size_t)k * d + f] = acc;
  }
}

size_t chain_smem(int b, size_t itemsize) {
  return 8 * (size_t)b * itemsize + (size_t)b * sizeof(int);
}

size_t fused_smem(int b, size_t itemsize, int frozen) {
  return ((frozen ? 0 : (size_t)b * b) + 7 * (size_t)b + 2 * kTile * kLd) *
             itemsize + (size_t)b * sizeof(int);
}

template <typename T>
int launch_chain(const T* scal, const T* gram, const int* idx, T* delta,
                 T* coef, int k, int b, int loss, double lam_n,
                 double coef_div, double sig_eff, double smoothing,
                 void* stream) {
  if (b < 1 || b > 1024) return (int)cudaErrorInvalidValue;
  auto kern = b <= 128 ? &chain_kernel<T, 4> : b <= 256 ? &chain_kernel<T, 8>
            : b <= 512 ? &chain_kernel<T, 16> : &chain_kernel<T, 32>;
  const size_t bytes = chain_smem(b, sizeof(T));
  cudaError_t err = sdca::allow_smem(kern, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<k, 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      scal, gram, idx, delta, coef, b, loss, T(lam_n), T(coef_div),
      T(sig_eff), T(smoothing));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused(const T* xb, const int* idx, const T* yb, const T* qb,
                 const T* a0, const T* live, const T* v, T* delta, T* dwu,
                 int k, int b, int d, int loss, double lam_n, double coef_div,
                 double sig_eff, double smoothing, int frozen, void* stream) {
  if (b < 1 || b > 1024) return (int)cudaErrorInvalidValue;
  auto kern = b <= 128 ? &fused_kernel<T, 4> : b <= 256 ? &fused_kernel<T, 8>
            : b <= 512 ? &fused_kernel<T, 16> : &fused_kernel<T, 32>;
  const size_t bytes = fused_smem(b, sizeof(T), frozen);
  if (bytes > (size_t)sdca::smem_optin()) return (int)cudaErrorInvalidValue;
  cudaError_t err = sdca::allow_smem(kern, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<k, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      xb, idx, yb, qb, a0, live, v, delta, dwu, b, d, loss, T(lam_n),
      T(coef_div), T(sig_eff), T(smoothing), frozen);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  Every tensor is contiguous; indices
// are int32; ``gram`` is null in frozen mode.  Outputs are written whole.
// Returns cudaGetLastError() (cudaErrorInvalidValue for a B outside
// 1..1024 or a fused working set above the shared-memory opt-in).
#define CHAIN_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const T* scal, const T* gram, const int* idx,         \
                      T* delta, T* coef, int k, int b, int loss,            \
                      double lam_n, double coef_div, double sig_eff,        \
                      double smoothing, void* stream) {                     \
    return launch_chain<T>(scal, gram, idx, delta, coef, k, b, loss, lam_n, \
                           coef_div, sig_eff, smoothing, stream);           \
  }
CHAIN_ENTRY(chain_block_batched_f32, float)
CHAIN_ENTRY(chain_block_batched_f64, double)

#define FUSED_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const T* xb, const int* idx, const T* yb,             \
                      const T* qb, const T* a0, const T* live, const T* v,  \
                      T* delta, T* dwu, int k, int b, int d, int loss,      \
                      double lam_n, double coef_div, double sig_eff,        \
                      double smoothing, int frozen, void* stream) {         \
    return launch_fused<T>(xb, idx, yb, qb, a0, live, v, delta, dwu, k, b,  \
                           d, loss, lam_n, coef_div, sig_eff, smoothing,    \
                           frozen, stream);                                 \
  }
FUSED_ENTRY(fused_block_f32, float)
FUSED_ENTRY(fused_block_f64, double)

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
