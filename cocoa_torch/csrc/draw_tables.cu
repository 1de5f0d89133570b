// The chunk's index tables made on the card: (C, K, H) int32 draws for
// rounds t0 .. t0 + C - 1 (1-based), with t0 read from device memory, so a
// captured chunk of rounds (solvers/base.py) draws its own tables and the
// host copies nothing per chunk.  Bit for bit with the host tables of
// utils/prng.py in every mode:
//
// - reference (mode 0): shard k of round t replays java.util.Random(seed +
//   t).nextInt(n_k) H times, rejection loop included
//   (prng.sample_indices_per_shard).  One warp per (round, shard) lane:
//   lane j of the warp holds the LCG state 32 draws apart from its
//   neighbours, so a warp takes 32 raw draws a step (one affine jump
//   advance^32 each), keeps the accepted ones in stream order with a
//   ballot and writes them out; the step count is H/32 plus the rejects'.
// - jax (mode 1): the counter hash of (seed, round, shard, position)
//   (prng.hash_tables), one thread per element.
// - permuted (mode 2): global step g = (t-1)*H + j of shard k reads the
//   keyed 4-round Feistel bijection of epoch g / n_k at g mod n_k, cycle
//   walked back into [0, n_k) (prng.permuted_tables), one thread per
//   element; the walk runs to its end on the card.
//
// Not a port of a TPU kernel: the JAX package makes these tables in XLA
// inside its compiled chunk (cocoa_tpu/solvers/base.py
// IndexSampler.tables_from_ts).  What bounds it: the table's bytes, C*K*H
// int32 written once, at 3.35 TB/s; in reference mode also each lane's
// chain of H dependent LCG steps, which the warp cuts to H/32 jumps.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint64_t kMult = 0x5DEECE66DULL;
constexpr uint64_t kAdd = 0xBULL;
constexpr uint64_t kMask48 = (1ULL << 48) - 1;
constexpr uint32_t kP1 = 0x9E3779B9u, kP2 = 0x85EBCA6Bu, kP3 = 0xC2B2AE35u;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ uint64_t lcg(uint64_t s, uint64_t a, uint64_t c) {
  // mod 2^64 keeps the low 48 bits exact
  return (s * a + c) & kMask48;
}

// Reference mode: one warp per (round, shard) lane of C*K.
__global__ void reference_kernel(const long long* __restrict__ counts,
                                 const long long* __restrict__ t0p,
                                 int* __restrict__ out, int c, int k, int h,
                                 long long seed) {
  const int lane = threadIdx.x & 31;
  const long long lane_id =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (lane_id >= (long long)c * k) return;
  const int ci = (int)(lane_id / k), ki = (int)(lane_id % k);
  const uint64_t bound = (uint64_t)counts[ki];
  const bool pow2 = (bound & (~bound + 1)) == bound;
  const uint64_t limit = ((1ULL << 31) / bound) * bound;
  // java.util.Random(seed + t): the scrambled seed, then lane + 1 steps
  uint64_t s = ((uint64_t)(seed + t0p[0] + ci) ^ kMult) & kMask48;
  for (int i = 0; i <= lane; ++i) s = lcg(s, kMult, kAdd);
  // advance^32 as one affine map: A_2L = A_L^2, C_2L = A_L C_L + C_L
  uint64_t a32 = kMult, c32 = kAdd;
  for (int i = 0; i < 5; ++i) {
    c32 = (a32 * c32 + c32) & kMask48;
    a32 = (a32 * a32) & kMask48;
  }
  int* row = out + lane_id * (long long)h;
  int written = 0;
  const unsigned below = (1u << lane) - 1u;
  while (written < h) {
    const uint32_t bits = (uint32_t)(s >> 17);
    const bool ok = pow2 || (uint64_t)bits < limit;
    const unsigned took = __ballot_sync(0xffffffffu, ok);
    const int pos = written + __popc(took & below);
    if (ok && pos < h)
      row[pos] = pow2 ? (int)((bound * (uint64_t)bits) >> 31)
                      : (int)(bits % (uint32_t)bound);
    written += __popc(took);
    s = lcg(s, a32, c32);
  }
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * kP2;
  x = (x ^ (x >> 13)) * kP3;
  return x ^ (x >> 16);
}

// jax mode: the counter hash, one thread per element of C*K*H.
__global__ void hash_kernel(const long long* __restrict__ counts,
                            const long long* __restrict__ t0p,
                            int* __restrict__ out, int c, int k, int h,
                            int k0, long long seed) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)c * k * h) return;
  const int j = (int)(idx % h);
  const long long lane_id = idx / h;
  const int ci = (int)(lane_id / k), ki = (int)(lane_id % k);
  const uint32_t t = (uint32_t)(t0p[0] + ci);
  const uint32_t base = mix32((t * kP1) ^ ((uint32_t)(k0 + ki) + 0x632BE5ABu) ^
                              (uint32_t)seed);
  const uint32_t v = mix32(base ^ ((uint32_t)j * kP3)) >> 1;
  out[idx] = (int)(v % (uint32_t)counts[ki]);
}

__device__ __forceinline__ uint32_t feistel(uint32_t x, int hb, uint32_t mask,
                                            uint32_t rk) {
  uint32_t left = x >> hb, right = x & mask;
#pragma unroll
  for (uint32_t r = 0; r < 4; ++r) {
    const uint32_t f = mix32((right * kP1) ^ rk ^ (r * kP2)) & mask;
    const uint32_t nl = right;
    right = left ^ f;
    left = nl;
  }
  return (left << hb) | right;
}

// permuted mode: one thread per element of C*K*H.
__global__ void permuted_kernel(const long long* __restrict__ counts,
                                const long long* __restrict__ t0p,
                                int* __restrict__ out, int c, int k, int h,
                                int k0, long long seed) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)c * k * h) return;
  const int j = (int)(idx % h);
  const long long lane_id = idx / h;
  const int ci = (int)(lane_id / k), ki = (int)(lane_id % k);
  const long long cnt = counts[ki];
  if (cnt <= 1) {
    out[idx] = 0;
    return;
  }
  const long long g = (t0p[0] - 1 + ci) * (long long)h + j;
  const uint32_t e = (uint32_t)(g / cnt);
  uint32_t y = (uint32_t)(g % cnt);
  const uint32_t rk =
      mix32((e * kP3) ^ ((uint32_t)(k0 + ki + 1) * kP1) ^ (uint32_t)seed);
  // the enclosing even-bit power-of-two domain: 2 * ceil(ceil(log2 n) / 2)
  const int bits = 64 - __clzll((unsigned long long)(cnt - 1));
  const int b = bits < 2 ? 2 : ((bits + 1) / 2) * 2;
  const int hb = b / 2;
  const uint32_t mask = (1u << hb) - 1u;
  y = feistel(y, hb, mask, rk);
  while ((long long)y >= cnt) y = feistel(y, hb, mask, rk);
  out[idx] = (int)y;
}

}  // namespace

// Plain C entry point for ctypes.  ``counts`` (K,) int64 shard sizes and
// ``t0`` (1,) int64 the chunk's first round, both in device memory;
// ``out`` (C, K, H) int32 is written whole; lane ki is the global shard
// ``k0 + ki`` (a gang's rank draws a run of the shards; the reference
// replay reads only the lane's size).  ``mode`` 0 reference, 1 jax,
// 2 permuted; anything else, or a non-positive extent, is refused with
// cudaErrorInvalidValue.  Returns cudaGetLastError().
extern "C" int draw_tables(int mode, const long long* counts,
                           const long long* t0, int* out, int c, int k, int h,
                           int k0, long long seed, void* stream) {
  if (c < 1 || k < 1 || h < 1 || k0 < 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    const long long lanes = (long long)c * k;
    const unsigned blocks =
        (unsigned)((lanes + kWarpsPerBlock - 1) / kWarpsPerBlock);
    reference_kernel<<<blocks, 32 * kWarpsPerBlock, 0, st>>>(counts, t0, out,
                                                             c, k, h, seed);
  } else {
    const long long n = (long long)c * k * h;
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    if (mode == 1)
      hash_kernel<<<blocks, kThreads, 0, st>>>(counts, t0, out, c, k, h,
                                               k0, seed);
    else
      permuted_kernel<<<blocks, kThreads, 0, st>>>(counts, t0, out, c, k, h,
                                                   k0, seed);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
