// RWKV-6 wkv6 forward for Hopper (sm_90a), float32 arithmetic.
//
// Replaces the Pallas TPU kernel `wkv6_pallas` (`_wkv6_kernel`) of
// src/repro/kernels/wkv/wkv6.py. It computes the same function, per (b, h),
// with a float32 state S [K, V] that starts at zero:
//
//   o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t),   S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
//
// in the chunked form of the reference (chunks of C = 64 tokens; log decays
// summed within the chunk, cum inclusive and cprev = cum[t-1] exclusive):
//
//   o[t]  = (r[t] * exp(cprev[t])) @ S                      inter-chunk
//         + sum_{s<t} (sum_k r[t,k] k[s,k] exp(cprev[t,k] - cum[s,k])) v[s]
//         + (r[t] . (u * k[t])) v[t]                          the u bonus
//   S'    = exp(total) * S + sum_s (k[s] * exp(total - cum[s]))ᵀ v[s]
//
// The intra-chunk decay is taken pairwise per key channel, so every exponent
// is <= 0 for s < t (the two-factor form r·exp(cprev) x k·exp(-cum) overflows
// for strong decays); entries with s >= t are masked after the exponent is
// clamped to 0. Decays are kept in log2 units and raised with ex2. cprev is
// the exclusive scan itself (not cum - log w), so the exponent for s = t - 1
// is exactly 0. The final state is written in float32 when asked; the TPU
// kernel kept it in VMEM scratch and dropped it, the model's decode cache
// needs it.
//
// Layout: the model layout [B, T, H, K] (and [B, T, H, V] for v) is read in
// place through element strides of batch, time and head (the last dim must
// be contiguous); the wrapper copies nothing. The ragged end of T is masked
// here (r, k, v read as 0 and w as 1, so the padding neither decays nor
// feeds the state); o rows past T are not written. o is [B, T, H, V] in r's
// type (float32 or bfloat16); w may be float32 beside bfloat16 r, k, v, as
// the model computes it.
//
// Design. The TPU's grid was (B, H, T/C) with the chunk axis sequential and
// the state carried in scratch from one grid step to the next. CTAs run in no
// order here, so one CTA walks all chunks of its (b, h) in a loop and keeps S
// in shared memory (16 KB). B * H = 64 CTAs at rwkv6-7b's width would leave
// half of the 132 SMs idle, so each (b, h) gets NR = 2 CTAs that split the
// rows of the output: CTA j computes o for the rows t with t % 2 == j. The
// pairwise exponents, which dominate the work, are then split exactly in two
// (rows interleaved, so both halves hold the same number of pairs); each CTA
// still updates the whole state, a float32 FMA product that it repeats. A
// split of the V columns instead would repeat the exponents in every slice.
// Per chunk a CTA of 256 threads (i) stages k, v, log2 w and its own rows of
// r in shared memory as float32 from registers, and issues the loads of the
// next chunk into those registers, (ii) scans log2 w over the chunk (four
// threads per key channel), (iii) computes its 32 x 64 score tile, one 2 x 4
// block of (t, s) per thread over the 136 blocks that reach below the
// diagonal, while one warp computes the bonus, (iv) computes o for its rows,
// (v) updates S.
//
// What bounds it. At the prefill shape of rwkv6-7b (T = 3,584, H = 64,
// K = V = 64, float32) the function moves 294 MB (r, k, v, w read, o
// written), 0.088 ms at 3.35 TB/s; its least work, the step-by-step
// recurrence's 4 T H K V = 3.8 GFLOP, takes 0.056 ms at the 67 TFLOP/s
// float32 rate, so the bytes bound the function. The chunked form adds a
// cost of its own: 64 * 56 * 2,016 * 64 = 462 M pairwise exponents, 0.11 ms
// at 16 a clock on each SM (4.2e12 a second at the 1,980 MHz boost clock),
// above the function's bound. This kernel reaches neither: its score blocks
// keep only 4.25 of its 8 warps busy, and the state update is repeated in
// both CTAs of a head. The loads of a chunk are fetched into registers
// while the previous chunk is computed. An anchored sub-chunk form
// (exponents <= 0 against a per-sub-chunk anchor, products on the tensor
// cores) would cut the exponents about fourfold; it is later work.
//
// Rounding. o's inter-chunk, intra-chunk and bonus terms and the state's
// decayed part and chunk sum are each summed apart and added last, as the
// plain version does: one running sum would round each small term at the
// scale of the large one (a running state sum made the kernel's outputs
// 1.7 times farther from an exact float64 scan than the plain version's on
// rwkv6-7b's inputs; summed apart, 1.06 times).
//
// The C entry point returns the CUDA error of the launch (0 on success); the
// Python wrapper raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;        // tokens a chunk
constexpr int K = 64;        // key channels (head size)
constexpr int V = 64;        // value channels
constexpr int NR = 2;        // CTAs a (b, h); CTA j owns the rows t % NR == j
constexpr int R = C / NR;    // own rows a chunk
constexpr int NT = 256;      // threads a CTA
constexpr int CP = C + 4;    // padded row of the [K][C] tiles
constexpr int RP = R + 4;    // padded row of the [K][R] and [C][R] tiles
constexpr int TILES = 136;   // 2 x 4 score blocks that reach below the diagonal
constexpr int LROWS = C * K / NT;  // rows of a chunk that each thread stages
constexpr float LOG2_MIN_W = -39.863137f;  // log2(1e-12), the reference's clip of w

static_assert(K == V, "the staging loop reads k and v rows together");
static_assert(NT == 4 * K, "the scan gives four threads to each key channel");

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;  // [H, K] float32
  void* o;
  float* state;  // [B, H, K, V] float32, or null
  int64_t sr[3], sk[3], sv[3], sw[3], so[3];  // batch, time, head element strides
  int H;
  int T;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float comp(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// Loads this thread's LROWS rows (t = tid / K + 4n, channel tid % K) of chunk
// c into registers: r only where its rows are the CTA's own (their parity is
// the same for all n); rows past T as r = k = v = 0, w = 1.
template <typename T, typename TW>
__device__ __forceinline__ void fetch(const Params& p, const T* r, const T* k, const T* v,
                                      const TW* w, int c, int lt0, int lx, bool own_r,
                                      float (&pr)[LROWS], float (&pk)[LROWS],
                                      float (&pv)[LROWS], float (&pw)[LROWS]) {
#pragma unroll
  for (int n = 0; n < LROWS; ++n) {
    const int tg = c * C + lt0 + 4 * n;
    const bool in = tg < p.T;
    pk[n] = in ? to_f32(k[tg * p.sk[1] + lx]) : 0.f;
    pv[n] = in ? to_f32(v[tg * p.sv[1] + lx]) : 0.f;
    pw[n] = in ? to_f32(w[tg * p.sw[1] + lx]) : 1.f;
    pr[n] = in && own_r ? to_f32(r[tg * p.sr[1] + lx]) : 0.f;
  }
}

constexpr int smem_floats() {
  return 2 * K * CP        // kT, cumT
         + C * K + C * V   // lw, vS
         + 2 * K * RP      // rT, cpT
         + C * RP          // scT
         + K * V           // S
         + K + K + 4 * K + R;  // u, tot, part, bonus
}

template <typename T, typename TW>
__global__ void __launch_bounds__(NT, 1) wkv6_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);  // [K][CP] k, then k * exp(total - cum)
  float* cumT = kT + K * CP;                    // [K][CP] inclusive log2 decay
  float* lw = cumT + K * CP;                    // [C][K] log2 w
  float* vS = lw + C * K;                       // [C][V]
  float* rT = vS + C * V;                       // [K][RP] own rows of r, then r * exp(cprev)
  float* cpT = rT + K * RP;                     // [K][RP] own rows' exclusive log2 decay
  float* scT = cpT + K * RP;                    // [C][RP] scores, scT[s][i]
  float* S = scT + C * RP;                      // [K][V] state
  float* uS = S + K * V;
  float* tot = uS + K;
  float* part = tot + K;  // [4][K] quarter sums of the scan
  float* bonus = part + 4 * K;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int j = blockIdx.y;
  const T* r = static_cast<const T*>(p.r) + b * p.sr[0] + h * p.sr[2];
  const T* k = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const T* v = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const TW* w = static_cast<const TW*>(p.w) + b * p.sw[0] + h * p.sw[2];
  T* o = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[2];

  for (int e = tid; e < K * V; e += NT) S[e] = 0.f;
  if (tid < K) uS[tid] = p.u[h * K + tid];

  // this thread's 2 x 4 score block: own rows 2*srt + {0,1}, columns
  // 4*sct + {0..3}; the first TILES threads take the blocks with sct <= srt
  // (row-major over the lower triangle), the rest the blocks above it, which
  // hold no pair s < t and are written as zeros
  int srt = 0, sct;
  const bool live = tid < TILES;
  if (live) {
    while ((srt + 1) * (srt + 2) / 2 <= tid) ++srt;
    sct = tid - srt * (srt + 1) / 2;
  } else {
    int q = tid - TILES;
    while (q >= 15 - srt) q -= 15 - srt++;
    sct = srt + 1 + q;
  }
  const int ort = tid / 16, ovq = tid % 16;  // o block: own rows 2*ort + {0,1}, v 4*ovq..
  const int skq = tid / 16, svq = tid % 16;  // S block: k 4*skq.., v 4*svq..
  const int sx = tid % K, sq = tid / K;      // scan: key channel, quarter of the chunk
  const int lx = tid % K, lt0 = tid / K;      // staging: channel, first row
  const bool own_r = lt0 % NR == j;

  const int nchunks = (p.T + C - 1) / C;
  float pr[LROWS], pk[LROWS], pv[LROWS], pw[LROWS];
  fetch(p, r, k, v, w, 0, lt0, lx, own_r, pr, pk, pv, pw);
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * C;
    // (i) stage the chunk fetched into registers, then fetch the next one,
    // whose loads are in flight while this chunk is computed
#pragma unroll
    for (int n = 0; n < LROWS; ++n) {
      const int t = lt0 + 4 * n;
      kT[lx * CP + t] = pk[n];
      vS[t * V + lx] = pv[n];
      lw[t * K + lx] = fmaxf(log2f(pw[n]), LOG2_MIN_W);
      if (own_r) rT[lx * RP + t / NR] = pr[n];
    }
    __syncthreads();
    if (c + 1 < nchunks) fetch(p, r, k, v, w, c + 1, lt0, lx, own_r, pr, pk, pv, pw);

    // (ii) inclusive scan of log2 w over the chunk, per key channel
    float loc[C / 4];
    {
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < C / 4; ++i) {
        run += lw[(sq * (C / 4) + i) * K + sx];
        loc[i] = run;
      }
      part[sq * K + sx] = run;
    }
    __syncthreads();
    {
      float off = 0.f;
      for (int q = 0; q < sq; ++q) off += part[q * K + sx];
#pragma unroll
      for (int i = 0; i < C / 4; ++i) {
        const int t = sq * (C / 4) + i;
        cumT[sx * CP + t] = off + loc[i];
        if (t % NR == j) cpT[sx * RP + t / NR] = i == 0 ? off : off + loc[i - 1];
      }
      if (sq == 3) tot[sx] = off + loc[C / 4 - 1];
    }
    __syncthreads();

    // (iii) scores of the own rows, and (last warp) the bonus r . (u * k)
    {
      float acc[2][4] = {};
      if (live) {
#pragma unroll 4
        for (int x = 0; x < K; ++x) {
          const float2 rr = *reinterpret_cast<const float2*>(&rT[x * RP + 2 * srt]);
          const float2 cp = *reinterpret_cast<const float2*>(&cpT[x * RP + 2 * srt]);
          const float4 kk = *reinterpret_cast<const float4*>(&kT[x * CP + 4 * sct]);
          const float4 cm = *reinterpret_cast<const float4*>(&cumT[x * CP + 4 * sct]);
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const float kb = comp(kk, bb), mb = comp(cm, bb);
            acc[0][bb] += rr.x * kb * ex2(fminf(cp.x - mb, 0.f));
            acc[1][bb] += rr.y * kb * ex2(fminf(cp.y - mb, 0.f));
          }
        }
      }
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int s = 4 * sct + bb;
        float2 val;
        val.x = live && s < j + NR * (2 * srt) ? acc[0][bb] : 0.f;
        val.y = live && s < j + NR * (2 * srt + 1) ? acc[1][bb] : 0.f;
        *reinterpret_cast<float2*>(&scT[s * RP + 2 * srt]) = val;
      }
      if (tid >= NT - R) {
        const int i = tid - (NT - R), t = j + NR * i;
        float bo = 0.f;
        for (int x = 0; x < K; ++x) bo += rT[x * RP + i] * uS[x] * kT[x * CP + t];
        bonus[i] = bo;
      }
    }
    __syncthreads();

    // r * exp(cprev) for the inter-chunk term, k * exp(total - cum) for the
    // state update, both in place
    for (int e = tid; e < K * R; e += NT) {
      const int x = e / R, i = e % R;
      rT[x * RP + i] *= ex2(cpT[x * RP + i]);
    }
    for (int e = tid; e < K * C; e += NT) {
      const int x = e / C, s = e % C;
      kT[x * CP + s] *= ex2(tot[x] - cumT[x * CP + s]);
    }
    __syncthreads();

    // (iv) o for the own rows 2*ort + {0,1}, columns 4*ovq..: the
    // inter-chunk, intra-chunk and bonus terms summed apart and added last,
    // as the plain version does (one running sum would round each small term
    // at the scale of the large inter-chunk sum)
    {
      const int i0 = 2 * ort, v0 = 4 * ovq;
      float intra[2][4] = {}, inter[2][4] = {};
      const int s_end = j + NR * (i0 + 1);  // scores vanish for s >= t
      for (int s = 0; s < s_end; ++s) {
        const float2 sc = *reinterpret_cast<const float2*>(&scT[s * RP + i0]);
        const float4 vv = *reinterpret_cast<const float4*>(&vS[s * V + v0]);
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          intra[0][bb] += sc.x * comp(vv, bb);
          intra[1][bb] += sc.y * comp(vv, bb);
        }
      }
#pragma unroll 4
      for (int x = 0; x < K; ++x) {
        const float2 qq = *reinterpret_cast<const float2*>(&rT[x * RP + i0]);
        const float4 sv = *reinterpret_cast<const float4*>(&S[x * V + v0]);
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          inter[0][bb] += qq.x * comp(sv, bb);
          inter[1][bb] += qq.y * comp(sv, bb);
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int t = j + NR * (i0 + a), tg = t0 + t;
        if (tg < p.T) {
          const float4 vv = *reinterpret_cast<const float4*>(&vS[t * V + v0]);
          const float bo = bonus[i0 + a];
          T* dst = o + tg * p.so[1] + v0;
#pragma unroll
          for (int bb = 0; bb < 4; ++bb)
            store(dst + bb, inter[a][bb] + intra[a][bb] + bo * comp(vv, bb));
        }
      }
    }
    __syncthreads();

    // (v) S = exp(total) * S + (k * exp(total - cum))ᵀ v, block k 4*skq.., v 4*svq..;
    // the chunk's sum is taken apart and added to the decayed state once
    {
      const int x0 = 4 * skq, v0 = 4 * svq;
      float add[4][4] = {};
      for (int s = 0; s < C; s += 4) {
        float4 kk[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) kk[a] = *reinterpret_cast<const float4*>(&kT[(x0 + a) * CP + s]);
#pragma unroll
        for (int ss = 0; ss < 4; ++ss) {
          const float4 vv = *reinterpret_cast<const float4*>(&vS[(s + ss) * V + v0]);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float kv = comp(kk[a], ss);
            add[a][0] += kv * vv.x;
            add[a][1] += kv * vv.y;
            add[a][2] += kv * vv.z;
            add[a][3] += kv * vv.w;
          }
        }
      }
      float st[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float d = ex2(tot[x0 + a]);
        const float4 sv = *reinterpret_cast<const float4*>(&S[(x0 + a) * V + v0]);
        st[a][0] = d * sv.x + add[a][0];
        st[a][1] = d * sv.y + add[a][1];
        st[a][2] = d * sv.z + add[a][2];
        st[a][3] = d * sv.w + add[a][3];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(&S[(x0 + a) * V + v0]) =
            make_float4(st[a][0], st[a][1], st[a][2], st[a][3]);
      if (c == nchunks - 1 && p.state != nullptr && j == 0) {
        float* dst = p.state + ((int64_t)b * p.H + h) * K * V;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          *reinterpret_cast<float4*>(&dst[(x0 + a) * V + v0]) =
              make_float4(st[a][0], st[a][1], st[a][2], st[a][3]);
      }
    }
    __syncthreads();
  }
}

template <typename T, typename TW>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats();
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(wkv6_kernel<T, TW>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid(B * p.H, NR);
  wkv6_kernel<T, TW><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 15 int64 element strides, (batch, time, head) of r, k, v, w, o.
// dtype: 0 = float32 r/k/v/o, 1 = bfloat16; w_dtype: the same codes for w
// (float32 w with bfloat16 r/k/v is taken; bfloat16 w with float32 r is not).
// state: [B, H, K, V] float32 for the final state, or null.
int wkv6_launch(const void* r, const void* k, const void* v, const void* w, const float* u,
                void* o, float* state, const int64_t* strides, int B, int T, int H, int Kd,
                int Vd, int dtype, int w_dtype, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || Kd != K || Vd != V) return (int)cudaErrorInvalidValue;
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = w;
  p.u = u;
  p.o = o;
  p.state = state;
  for (int i = 0; i < 3; ++i) {
    p.sr[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.sw[i] = strides[9 + i];
    p.so[i] = strides[12 + i];
  }
  p.H = H;
  p.T = T;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && w_dtype == 0)
    err = launch<float, float>(p, B, st);
  else if (dtype == 1 && w_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(p, B, st);
  else if (dtype == 1 && w_dtype == 0)
    err = launch<__nv_bfloat16, float>(p, B, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* wkv6_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
