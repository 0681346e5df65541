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
// keys, 4 cells per key, the estimates) and does ~30 integer operations per
// key. At the main path's shapes (W = 1024, about 10 keys a call) that is
// 264 B for an estimate of 11 keys, 7.9e-8 ms at 3.35 TB/s, against a
// device time of about 1.3 us (update 1.6 us, fused 2.3 us): every kernel
// sits on the launch floor, and no change to its body can move it there.
// So the bodies are unchanged since they were first written, and the
// redesign is of the call around them: the *_call entries below do a whole
// sketch call (keys in, estimates out) in one C call from Python, so the
// host pays one ctypes call, two small copies and one synchronisation per
// sketch call in place of tensor allocations and pageable copies.
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
// Two kinds of C entry:
//
// * *_launch: one kernel on the stream it is given, on device pointers the
//   caller owns (the tensor wrappers of kernels/cms/cms.py). They do not
//   synchronise, allocate nothing, and return cudaGetLastError().
// * *_call: a whole sketch call through the sketch's staging buffers
//   (kernels/cms/cms.py, Staging): pinned host keys copied by
//   cudaMemcpyAsync into a device key buffer, the kernels, and for the
//   estimating calls the estimates copied back into a pinned host buffer
//   and one cudaStreamSynchronize. A flush plan (pairs of int64: keys of
//   a cms_update_kernel launch, and whether the aging reset, a halving of
//   every counter, follows it) is read on the host. All of it runs in the
//   order of the one stream. They return the first failing call's code.
//   No mapped host memory, no host-side polling: CUDA's own copy and
//   synchronisation rules order everything.

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

// TinyLFU aging: halve every counter (paper section 3). The JAX package
// leaves this shift to XLA; here it is a kernel so that a flush with a
// reset inside it stays one C call, in stream order with the updates.
__global__ void cms_halve_kernel(int32_t* table, int64_t cells) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < cells) table[i] >>= 1;
}

inline unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

// Copies keys[0, count) from pinned host memory into the device key buffer.
cudaError_t copy_keys(int32_t* d_keys, const int32_t* h_keys, int64_t count, cudaStream_t s) {
  if (count == 0) return cudaSuccess;
  return cudaMemcpyAsync(d_keys, h_keys, count * sizeof(int32_t), cudaMemcpyHostToDevice, s);
}

// Keys a flush plan applies: the sum of its steps' counts.
int64_t plan_keys(const int64_t* plan, int64_t steps) {
  int64_t m = 0;
  for (int64_t i = 0; i < steps; ++i) m += plan[2 * i];
  return m;
}

// Runs a flush plan over the device keys d_keys[0, plan_keys): one update
// launch per step at its offset, the halving after a step that ends a
// sample. The split is the sketch's (core/cms_sketch.py, plan_flush).
cudaError_t run_plan(int32_t* table, int64_t width, const int32_t* d_keys, const int64_t* plan,
                     int64_t steps, int32_t cap, cudaStream_t s) {
  int64_t off = 0;
  for (int64_t i = 0; i < steps; ++i) {
    const int64_t take = plan[2 * i];
    cms_update_kernel<<<blocks_for(kRows * take), kThreads, 0, s>>>(table, width, d_keys + off,
                                                                    take, cap);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    off += take;
    if (plan[2 * i + 1]) {
      cms_halve_kernel<<<blocks_for(kRows * width), kThreads, 0, s>>>(table, kRows * width);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

// Copies n estimates back into pinned host memory and waits for the stream.
cudaError_t fetch_estimates(int32_t* h_out, const int32_t* d_out, int64_t n, cudaStream_t s) {
  if (n > 0) {
    const cudaError_t err =
        cudaMemcpyAsync(h_out, d_out, n * sizeof(int32_t), cudaMemcpyDeviceToHost, s);
    if (err != cudaSuccess) return err;
  }
  return cudaStreamSynchronize(s);
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

// A flush: the plan's keys copied once, then the plan. `event` is recorded
// right after the copy: the caller waits on it before it rewrites the
// pinned keys. Does not synchronise.
int cms_flush_call(void* table, int64_t width, const void* h_keys, void* d_keys,
                   const int64_t* plan, int64_t steps, int cap, void* event, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = copy_keys(static_cast<int32_t*>(d_keys), static_cast<const int32_t*>(h_keys),
                              plan_keys(plan, steps), s);
  if (err == cudaSuccess) err = cudaEventRecord(static_cast<cudaEvent_t>(event), s);
  if (err == cudaSuccess)
    err = run_plan(static_cast<int32_t*>(table), width, static_cast<const int32_t*>(d_keys), plan,
                   steps, cap, s);
  return static_cast<int>(err);
}

// An estimate, after the flush plan of the pending keys (steps may be 0):
// keys [pending | estimated] copied once, the plan, the estimate kernel
// over the last n keys, the estimates copied back, one synchronisation.
int cms_estimate_call(void* table, int64_t width, const void* h_keys, void* d_keys,
                      const int64_t* plan, int64_t steps, int64_t n, int cap, void* h_out,
                      void* d_out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* keys = static_cast<int32_t*>(d_keys);
  const int64_t m = plan_keys(plan, steps);
  cudaError_t err = copy_keys(keys, static_cast<const int32_t*>(h_keys), m + n, s);
  if (err == cudaSuccess)
    err = run_plan(static_cast<int32_t*>(table), width, keys, plan, steps, cap, s);
  if (err == cudaSuccess && n > 0) {
    cms_estimate_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const int32_t*>(table), width, keys + m, n, static_cast<int32_t*>(d_out));
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = fetch_estimates(static_cast<int32_t*>(h_out), static_cast<const int32_t*>(d_out), n, s);
  return static_cast<int>(err);
}

// The fused update + estimate: keys [m pending | n estimated] copied once,
// one launch, the estimates copied back, one synchronisation.
int cms_update_estimate_call(void* table, int64_t width, const void* h_keys, void* d_keys,
                             int64_t m, int64_t n, int cap, void* h_out, void* d_out,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* keys = static_cast<int32_t*>(d_keys);
  cudaError_t err = copy_keys(keys, static_cast<const int32_t*>(h_keys), m + n, s);
  if (err == cudaSuccess) {
    cms_update_estimate_kernel<<<1, kFusedThreads, 0, s>>>(
        static_cast<int32_t*>(table), width, keys, m, keys + m, n, cap,
        static_cast<int32_t*>(d_out));
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = fetch_estimates(static_cast<int32_t*>(h_out), static_cast<const int32_t*>(d_out), n, s);
  return static_cast<int>(err);
}

const char* cms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
