// Flash attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py:25. For every (batch, query head)
// and query row it computes online-softmax attention over the row's keys:
//
//     s = (q * 1/sqrt(D)) . k,   masked to -1e30 where the key is hidden,
//     out = sum_k softmax(s)_k v_k,
//
// with float32 scores, running max, running sum and accumulator, and the
// output `acc / max(l, 1e-20)` stored in the inputs' dtype. Key k is hidden
// from query q when `causal` and q - k < 0, or when a window is given and
// q - k >= window (positions counted from 0 for both, also when Sq != Sk).
// KV tiles that hide every key from every row of the query tile are not
// visited, as the TPU kernel skips them. A row that sees no key at all gets
// the mean of V over all Sk keys, which is what the oracle `attention_ref`
// (a softmax over Sk equal -1e30 scores) gives; the TPU kernel's value on
// such rows depends on its tile size.
//
// GQA: query head h reads KV head h / (Hq / Hkv); no KV head is copied.
//
// Operands (contiguous, on one device): q (B, Hq, Sq, D), k and v
// (B, Hkv, Sk, D), all float32 or all bfloat16; out (B, Hq, Sq, D) in the
// same dtype. Any Sq, Sk >= 1 (ragged tiles are masked) and D <= 256.
//
// Bound on the card. The work is 4 D operations per visible (q, k) pair
// (q.k and p.v) and the bytes are q, k, v read once and out written once:
// recurrentgemma-2b's sliding layer at B 8, S 2048 (10 query heads, 1 KV
// head of 256, causal) is 171.9 GFLOP and 185 MB, 0.17 ms at the tensor
// cores' 989 TFLOP/s (bf16) against 0.06 ms for the bytes: it is bound by
// operations. This kernel does them on the CUDA cores in float32 FMA
// (67 TFLOP/s, 2.6 ms at best), which keeps float32 inputs within 1e-5 of
// the oracle; wgmma, TMA and a pipelined producer warp are later work.
//
// Design. One block of 256 threads (16 x 16) per (b * Hq + h, 64-row query
// tile). The query tile, pre-scaled, stays in shared memory; K and then V
// tiles of kBK keys are staged into one shared buffer in float32. Each
// thread owns 4 query rows: for the scores it holds 4 x kBK/16 entries
// (key columns tx + 16 j), for the output 4 x D/16 accumulators (feature
// columns in vectors of kW interleaved across tx). The rows' max and sum
// are reduced over the 16 threads that share them with shuffles. Shared
// rows are padded by 4 floats so the 16-byte loads of neighbouring threads
// fall in distinct banks. The heaviest query tiles (last under causal) are
// launched first. Nothing is atomic, so runs repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;    // query rows per block
constexpr int kRows = 4;   // query rows per thread
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch casts
}

template <int W>
struct VecF;
template <>
struct VecF<4> {
  using type = float4;
};
template <>
struct VecF<2> {
  using type = float2;
};

// W consecutive floats from 16-byte (W = 4) or 8-byte (W = 2) aligned
// shared memory.
template <int W>
__device__ __forceinline__ void lds(float* dst, const float* src) {
  *reinterpret_cast<typename VecF<W>::type*>(dst) =
      *reinterpret_cast<const typename VecF<W>::type*>(src);
}

template <int kD>
struct Tile {
  static constexpr int kBK = kD >= 256 ? 32 : 64;  // keys per KV tile
  static constexpr int kLd = kD + 4;               // padded row of Q, K, V
  static constexpr int kPld = kBK + 4;             // padded row of P
  static constexpr int kCols = kBK / 16;           // score columns a thread
  static constexpr int kW = kD >= 64 ? 4 : 2;      // output vector width
  static constexpr int kG = kD / (16 * kW);        // output vectors a row
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)kBQ * kLd + (size_t)kBK * kLd + (size_t)kBQ * kPld);
};

// Stage rows [r0, r0 + nrows) of a (S, D) matrix into dst[nrows][kLd] as
// float32 times `scale`, zero beyond S and beyond D.
template <typename T, int kD>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int nrows, int S, int D, float scale) {
  constexpr int kLd = Tile<kD>::kLd;
  for (int i = threadIdx.x; i < nrows * kD; i += kThreads) {
    const int r = i / kD, d = i - r * kD;
    float x = 0.f;
    if (r0 + r < S && d < D) x = to_float(src[(size_t)(r0 + r) * D + d]) * scale;
    dst[r * kLd + d] = x;
  }
}

// grid = (B * Hq, ceil(Sq / kBQ)); block = kThreads; dynamic shared memory
// Tile<kD>::kSmem.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv,
             int Sq, int Sk, int D, int causal, int has_window, int window,
             float sm_scale) {
  using TL = Tile<kD>;
  constexpr int kBK = TL::kBK, kLd = TL::kLd, kPld = TL::kPld;
  constexpr int kCols = TL::kCols, kW = TL::kW, kG = TL::kG;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [kBQ][kLd]
  float* KVs = Qs + kBQ * kLd;  // [kBK][kLd]
  float* Ps = KVs + kBK * kLd;  // [kBQ][kPld]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const T* qp = q + (size_t)bh * Sq * D;
  const T* kp = k + (size_t)(b * Hkv + hk) * Sk * D;
  const T* vp = v + (size_t)(b * Hkv + hk) * Sk * D;
  T* op = out + (size_t)bh * Sq * D;

  // keys any row of this tile can see: [k_lo, k_hi)
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = has_window ? max(0, q0 - window + 1) : 0;

  stage<T, kD>(Qs, qp, q0, kBQ, Sq, D, sm_scale);

  float m[kRows], l[kRows], acc[kRows][kG][kW];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int w = 0; w < kW; ++w) acc[i][g][w] = 0.f;
  }

  for (int kt = (k_lo / kBK) * kBK; kt < k_hi; kt += kBK) {
    __syncthreads();  // Qs staged; the previous tile's V no longer read
    stage<T, kD>(KVs, kp, kt, kBK, Sk, D, 1.f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      float qv[kRows][4], kv[kCols][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) lds<4>(qv[i], Qs + (ty * kRows + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j) lds<4>(kv[j], KVs + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
#pragma unroll
          for (int w = 0; w < 4; ++w) s[i][j] = fmaf(qv[i][w], kv[j][w], s[i][j]);
    }
    __syncthreads();  // K no longer read
    stage<T, kD>(KVs, vp, kt, kBK, Sk, D, 1.f);

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = kt + tx + 16 * j;
        const int diff = qpos - kpos;
        const bool seen = (!causal || diff >= 0) && (!has_window || diff < window);
        // a key past Sk is no key at all: weight 0, never the max
        s[i][j] = kpos >= Sk ? -INFINITY : (seen ? s[i][j] : kNegInf);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - mn);
      l[i] = l[i] * corr + rs;
      m[i] = mn;
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int w = 0; w < kW; ++w) acc[i][g][w] *= corr;
#pragma unroll
      for (int j = 0; j < kCols; ++j) Ps[(ty * kRows + i) * kPld + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // V and P staged

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float pv[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) lds<4>(pv[i], Ps + (ty * kRows + i) * kPld + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[kG][kW];
#pragma unroll
        for (int g = 0; g < kG; ++g)
          lds<kW>(vv[g], KVs + (c + cc) * kLd + (g * 16 + tx) * kW);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int g = 0; g < kG; ++g)
#pragma unroll
            for (int w = 0; w < kW; ++w)
              acc[i][g][w] = fmaf(pv[i][cc], vv[g][w], acc[i][g][w]);
      }
    }
  }

  // rows that saw no key: the mean of V over all Sk keys (attention_ref)
  bool blind = false;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    blind |= m[i] == kNegInf && q0 + ty * kRows + i < Sq;
  if (__syncthreads_or(blind)) {
    float vs[kG][kW];
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int w = 0; w < kW; ++w) vs[g][w] = 0.f;
    for (int kt = 0; kt < Sk; kt += kBK) {
      __syncthreads();
      stage<T, kD>(KVs, vp, kt, kBK, Sk, D, 1.f);
      __syncthreads();
      for (int c = 0; c < kBK; ++c) {
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          float vv[kW];
          lds<kW>(vv, KVs + c * kLd + (g * 16 + tx) * kW);
#pragma unroll
          for (int w = 0; w < kW; ++w) vs[g][w] += vv[w];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (m[i] != kNegInf) continue;
      l[i] = (float)Sk;
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int w = 0; w < kW; ++w) acc[i][g][w] = vs[g][w];
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty * kRows + i;
    if (qpos >= Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const int d = (g * 16 + tx) * kW + w;
        if (d < D) op[(size_t)qpos * D + d] = from_float<T>(acc[i][g][w] / den);
      }
  }
}

template <typename T, int kD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Sk, int D, int causal, int has_window,
           int window, float sm_scale, cudaStream_t st) {
  // shared memory above 48 KB must be asked for, once per device
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute((const void*)flash_kernel<T, kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Tile<kD>::kSmem);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_kernel<T, kD><<<grid, kThreads, Tile<kD>::kSmem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, Sq, Sk, D,
      causal, has_window, window, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Hq, int Hkv, int Sq, int Sk, int D, int causal,
             int has_window, int window, float sm_scale, cudaStream_t st) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                         has_window, window, sm_scale, st);
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                         has_window, window, sm_scale, st);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                          has_window, window, sm_scale, st);
  return launch<T, 256>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                        has_window, window, sm_scale, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). `window` is read only
// when has_window is 1. Launches the kernel on `stream` and returns
// cudaGetLastError() as an int (0 = launched). Nothing is synchronised and
// nothing is allocated here.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                    int has_window, int window, float sm_scale, int dtype,
                    void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Sk < 1 || D < 1 ||
      D > 256 || (long long)B * Hq > 0x7fffffffLL ||
      ((long long)Sq + kBQ - 1) / kBQ > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                           has_window, window, sm_scale, st);
  return launch_d<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                          has_window, window, sm_scale, st);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
