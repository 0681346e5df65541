// Flash-attention forward for Hopper (sm_90a), float32 arithmetic.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd_pallas` (`_flash_kernel`)
// of src/repro/kernels/attention/flash.py. It computes the same function:
//
//   o[b,s,h,:] = softmax_t( mask( cap( scale * q[b,s,h,:] . k[b,t,h/g,:] ) ) ) @ v[b,t,h/g,:]
//
// with the online softmax (running max m, running sum l, accumulator acc, all
// float32), GQA (query head h reads kv head h / g in place, g = Hq / Hkv, no
// replication in device memory), the masks `kpos < T`, causal `kpos <= qpos`
// and window `kpos > qpos - window`, all with the finite NEG_INF of the
// reference, and the optional gemma2 soft-cap `tanh(s / c) * c`.
//
// Layout: the model layout [B, S, H, D] is read in place through strides
// (element strides of batch, sequence and head; the last dim must be
// contiguous), so the wrapper transposes nothing. The output is written in
// the model layout [B, S, Hq, Dv], in the input's type (float32 or bfloat16).
//
// Design. One CTA of 256 threads per (q tile of BQ = 64 rows, head, batch).
// The TPU kernel carried m/l/acc across a sequential grid axis over kv tiles;
// CTAs run in no order here, so a loop inside the CTA walks the kv tiles
// (BK = 64 keys each) instead. Per kv tile: K and V are staged in shared
// memory (converted to float32), each thread computes a 4x4 block of the
// 64x64 score tile (rows ty + 16i, cols tx + 16j) by FMA over D, masks it and
// writes it to shared memory; four threads per row then update m and l and
// turn the scores into probabilities; finally each thread rescales and
// accumulates its 4 x (Dv/16) block of the output in registers. Q stays in
// shared memory for the whole CTA, so each K/V tile read from device memory
// serves 64 query rows. Tiles wholly above the causal diagonal or wholly
// before the window of every row of the q tile are skipped; that gives the
// same result, since their probabilities are exactly 0 once a live key has
// been seen. The ragged edges of S and T are masked here; nothing is padded
// in device memory. Causal q tiles are issued heaviest first.
//
// What bounds it. At the serving path's prefill shape (SmolLM-135M: 9 query
// heads over 3 kv heads, head dim 64, 3,584 tokens, causal) the work is
// 2 * 9 * 3584^2 * 128 / 2 = 14.8 GFLOP against 22 MB of q, k, v and o: the
// operations bound it (0.22 ms at the 67 TFLOP/s float32 rate against 7 us
// for the bytes). The reference's float32 tolerance (2e-5 + 2e-4 |x|) rules
// out TF32 tensor cores, so this kernel runs on the float32 FMA units; its
// inner loops issue one shared-memory load per two FMAs, so shared-memory
// bandwidth, not the FMA rate, is its limit. wgmma on bf16 inputs, TMA and
// warp specialisation are later work.
//
// The C entry point returns the CUDA error of the launch (0 on success); the
// Python wrapper raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.3819763e38f;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides (batch, sequence, head) of q, k, v, o
  int64_t sq[3], sk[3], sv[3], so[3];
  int Hq, Hkv, S, T;
  float scale, softcap;  // softcap <= 0: none
  int causal, window;    // window <= 0: none
};

template <int D, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * DV + BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
  static_assert(D % 16 == 0 && DV % 16 == 0, "head dims must be multiples of 16");
  extern __shared__ float smem[];
  float* Qs = smem;                // [BQ][D + 1]   (+1: no bank conflicts)
  float* Ks = Qs + BQ * (D + 1);   // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);   // [BK][DV]
  float* Ps = Vs + BK * DV;        // [BQ][BK + 1]  scores, then probabilities
  float* m_s = Ps + BQ * (BK + 1); // [BQ] running max
  float* l_s = m_s + BQ;           // [BQ] running sum
  float* c_s = l_s + BQ;           // [BQ] this tile's correction exp(m_prev - m_new)

  const int n_qt = (p.S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + hk * p.sk[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + hk * p.sv[2];
  T* og = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[2];

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, s = q0 + r;
    Qs[r * (D + 1) + d] = s < p.S ? to_f32(qg[(int64_t)s * p.sq[1] + d]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  float acc[4][DV / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DV / 16; ++j) acc[i][j] = 0.f;

  // kv tiles that hold a live key for some row of this q tile
  const int q_last = min(q0 + BQ, p.S) - 1;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.T, q_last + 1) : p.T;
  const int kt_lo = k_lo / BK;
  const int kt_hi = (k_hi + BK - 1) / BK;
  __syncthreads();

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D, t = k0 + r;
      Ks[r * (D + 1) + d] = t < p.T ? to_f32(kg[(int64_t)t * p.sk[1] + d]) : 0.f;
    }
    for (int i = tid; i < BK * DV; i += NT) {
      const int r = i / DV, d = i % DV, t = k0 + r;
      Vs[r * DV + d] = t < p.T ? to_f32(vg[(int64_t)t * p.sv[1] + d]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16i, cols tx + 16j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        float s = sc[i][j] * p.scale;
        if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
        bool live = kpos < p.T;
        if (p.causal) live = live && kpos <= qpos;
        if (p.window > 0) live = live && kpos > qpos - p.window;
        Ps[r * (BK + 1) + c] = live ? s : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes per row
    {
      const int r = tid / 4, sub = tid % 4;
      float* row = Ps + r * (BK + 1);
      const float m_prev = m_s[r];
      float mx = NEG_INF;
      for (int c = sub; c < BK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = sub; c < BK; c += 4) {
        const float e = expf(row[c] - m_new);
        row[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // every lane of the row has read m_s[r]
      if (sub == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P @ V: rows ty + 16i, cols tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DV / 16; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DV / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DV / 16; ++j) vv[j] = Vs[c * DV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DV / 16; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // Ks, Vs, Ps are overwritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    if (s >= p.S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = og + (int64_t)s * p.so[1];
#pragma unroll
    for (int j = 0; j < DV / 16; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int D, int DV>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, DV>();
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D, DV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid((p.S + BQ - 1) / BQ, p.Hq, B);
  flash_fwd_kernel<T, D, DV><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, int D, int DV, cudaStream_t stream) {
  if (D == 64 && DV == 64) return launch<T, 64, 64>(p, B, stream);
  if (D == 128 && DV == 128) return launch<T, 128, 128>(p, B, stream);
  if (D == 64 && DV == 128) return launch<T, 64, 128>(p, B, stream);
  if (D == 128 && DV == 64) return launch<T, 128, 64>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// strides: 12 int64 element strides, (batch, sequence, head) of q, k, v, o.
// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 and window <= 0 mean none.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                     const int64_t* strides, int B, int Hq, int Hkv, int S, int T, int D,
                     int DV, float scale, float softcap, int causal, int window, int dtype,
                     void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
  }
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.S = S;
  p.T = T;
  p.scale = scale;
  p.softcap = softcap;
  p.causal = causal;
  p.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? dispatch<float>(p, B, D, DV, st)
                    : dtype == 1 ? dispatch<__nv_bfloat16>(p, B, D, DV, st)
                                 : cudaErrorInvalidValue;
  return (int)err;
}

const char* flash_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
