// Count-min-sketch kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// They replace the three Pallas TPU kernels of repro/kernels/cms/cms.py:
//
//   cms_update_kernel           <- cms.py:cms_update_pallas (_update_kernel)
//   cms_estimate_kernel         <- cms.py:cms_estimate_pallas (_estimate_kernel)
//   cms_update_estimate_kernel  <- cms.py:cms_update_estimate_pallas
//                                  (_update_estimate_kernel)
//
// Each computes what its Pallas kernel computes, not how. The TPU kernels
// compare every key against every lane of a width block (a one-hot over
// [4, N, BW], O(N*W) work), because a TPU has no scatter. Here a scatter
// and a gather are O(N): one thread per (row, key) or per key. The keys are
// hashed inside the kernel (murmur3 fmix32 and Kirsch-Mitzenmacher
// h1 + r*h2, as in repro/kernels/cms/ref.py), so no [4, N] index tensor is
// built or copied; a masked hash is always inside [0, W), so no out-of-range
// sentinel is needed.
//
// Bound on an H100: each call moves a few hundred bytes to a few KB (the
// keys, 4 cells per key, the estimates), a few ns at 3.35 TB/s, and does
// ~30 integer operations per key. At the main path's shapes (W = 1024, a
// handful of keys) every kernel is bound by launch latency, not by bytes or
// operations; the design keeps each call to one launch and no extra pass
// over the table.
//
// The table is updated IN PLACE, where the JAX reference returns a new
// array: copying the [4, W] table every admission decision would cost O(W).
//
// Saturating increments commute, so a CAS loop "add 1 unless >= cap" per
// (row, key) gives min(t + count, cap) for every touched cell in any order,
// duplicates included. Precondition, kept by the sketch: every cell <= cap
// on entry (the reference also clamps untouched cells above cap; no sketch
// ever holds one).
//
// Each C entry launches on the stream it is given, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;
constexpr int kThreads = 256;
// One CTA of the fused kernel; its loops stride over any M and N.
constexpr int kFusedThreads = 512;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Column of `key` in row `r` of a table of width mask + 1.
__device__ __forceinline__ uint32_t cell_index(int32_t key, uint32_t r, uint32_t mask) {
  const uint32_t u = static_cast<uint32_t>(key);
  const uint32_t h1 = mix32(u);
  const uint32_t h2 = mix32(u ^ 0x9E3779B9u) | 1u;
  return (h1 + r * h2) & mask;
}

// Saturating increment. Cells only grow inside a call, so a stale first
// read that is already >= cap is still >= cap; __ldcg reads past L1.
__device__ __forceinline__ void sat_inc(int32_t* cell, int32_t cap) {
  int32_t old = __ldcg(cell);
  while (old < cap) {
    const int32_t prev = atomicCAS(cell, old, old + 1);
    if (prev == old) return;
    old = prev;
  }
}

__device__ __forceinline__ void inc_lane(int32_t* table, int64_t width, const int32_t* keys,
                                         int64_t t, int32_t cap) {
  const int64_t k = t >> 2;
  const uint32_t r = static_cast<uint32_t>(t & 3);
  const uint32_t mask = static_cast<uint32_t>(width - 1);
  sat_inc(table + r * width + cell_index(keys[k], r, mask), cap);
}

__global__ void cms_update_kernel(int32_t* table, int64_t width, const int32_t* keys,
                                  int64_t n, int32_t cap) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < kRows * n) inc_lane(table, width, keys, t, cap);
}

__global__ void cms_estimate_kernel(const int32_t* __restrict__ table, int64_t width,
                                    const int32_t* __restrict__ keys, int64_t n,
                                    int32_t* __restrict__ out) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const uint32_t mask = static_cast<uint32_t>(width - 1);
  const int32_t key = keys[k];
  int32_t v = __ldg(table + cell_index(key, 0, mask));
  for (uint32_t r = 1; r < kRows; ++r) v = min(v, __ldg(table + r * width + cell_index(key, r, mask)));
  out[k] = v;
}

// One CTA: every gather must see every increment of the same call, and
// CTAs run in no order, so the increments and the gathers are separated by
// a block barrier (global writes before __syncthreads are visible to the
// block after it). The gathers read with __ldcg, past any L1 line an
// earlier read may hold.
__global__ void cms_update_estimate_kernel(int32_t* table, int64_t width,
                                           const int32_t* __restrict__ upd, int64_t m,
                                           const int32_t* __restrict__ est, int64_t n,
                                           int32_t cap, int32_t* __restrict__ out) {
  for (int64_t t = threadIdx.x; t < kRows * m; t += blockDim.x) inc_lane(table, width, upd, t, cap);
  __syncthreads();
  const uint32_t mask = static_cast<uint32_t>(width - 1);
  for (int64_t k = threadIdx.x; k < n; k += blockDim.x) {
    const int32_t key = est[k];
    int32_t v = __ldcg(table + cell_index(key, 0, mask));
    for (uint32_t r = 1; r < kRows; ++r) v = min(v, __ldcg(table + r * width + cell_index(key, r, mask)));
    out[k] = v;
  }
}

inline unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int cms_update_launch(void* table, int64_t width, const void* keys, int64_t n, int cap,
                      void* stream) {
  cms_update_kernel<<<blocks_for(kRows * n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(table), width, static_cast<const int32_t*>(keys), n, cap);
  return static_cast<int>(cudaGetLastError());
}

int cms_estimate_launch(const void* table, int64_t width, const void* keys, int64_t n, void* out,
                        void* stream) {
  cms_estimate_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), width, static_cast<const int32_t*>(keys), n,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int cms_update_estimate_launch(void* table, int64_t width, const void* upd, int64_t m,
                               const void* est, int64_t n, int cap, void* out, void* stream) {
  cms_update_estimate_kernel<<<1, kFusedThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(table), width, static_cast<const int32_t*>(upd), m,
      static_cast<const int32_t*>(est), n, cap, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* cms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
