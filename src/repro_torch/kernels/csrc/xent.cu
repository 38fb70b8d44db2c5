// Fused softmax cross-entropy, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_xent_kernel` / `softmax_xent` of
// src/repro/kernels/xent.py:28. For every token row n of (N, V) logits it
// computes, with float32 accumulation,
//
//     loss[n] = log(max(l, 1e-30)) + m - gold,
//     m = max_v x[n, v],  l = sum_v exp(x[n, v] - m),
//     gold = x[n, t[n]] if 0 <= t[n] < V, else 0,
//
// so a target outside [0, V) (-1, V, ...) gives the row's logsumexp, as the
// Pallas kernel does (its gold accumulator stays 0).
//
// Operands (contiguous, on one device): logits (N, V) float32 or bfloat16;
// targets (N,) int32 or int64; loss (N,) float32. Any N >= 1 and V >= 1.
//
// Bound on the card. Each logit is read once and each does a max, a
// subtract, an exp and an add: at (4096, 262144) bf16 that is 2.15 GB, 641
// us at 3.35 TB/s, against ~4.3 GFLOP (64 us at 67 TFLOP/s). It is bound by
// bytes.
//
// Design. One block of kThreads threads per row streams the row once with
// 16-byte loads (8 bf16 or 4 float32 a load, kUnroll loads in flight per
// thread), each thread folding its values into a running (max, sumexp) pair
// as the TPU kernel folds vocab tiles: one exp per value and one per
// 16-byte vector for the rescale. The TPU kernel's sequential grid over
// vocab tiles becomes this loop inside the block; the pairs are then merged
// across the block with warp shuffles and one shared-memory step, so no
// second pass over the row and no atomics are needed. The unaligned head of
// a row (V odd, say) and its ragged tail are read one value at a time.
// Thread 0 reads the gold logit itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The 16-byte vector's values, widened to float32 (exactly).
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Fold n values into the running (m, l) pair.
template <int n>
__device__ __forceinline__ void absorb(float& m, float& l, const float* x) {
  float mx = x[0];
#pragma unroll
  for (int i = 1; i < n; ++i) mx = fmaxf(mx, x[i]);
  const float mn = fmaxf(m, mx);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < n; ++i) s += expf(x[i] - mn);
  l = l * expf(m - mn) + s;
  m = mn;
}

// Merge another (m2, l2) pair into (m, l).
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void warp_merge(float& m, float& l) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, m2, l2);
  }
}

// grid = N; block = kThreads.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
xent_kernel(const T* __restrict__ logits, const I* __restrict__ targets,
            float* __restrict__ loss, long long V) {
  constexpr int kVec = 16 / sizeof(T);
  const size_t row = blockIdx.x;
  const T* x = logits + row * (size_t)V;
  long long head = (long long)(((16 - ((uintptr_t)x & 15)) & 15) / sizeof(T));
  if (head > V) head = V;
  const long long nvec = (V - head) / kVec;
  const long long tail = head + nvec * kVec;

  float m = kNegInf, l = 0.f;
  for (long long i = threadIdx.x; i < head; i += kThreads) {
    const float v = to_float(x[i]);
    absorb<1>(m, l, &v);
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
    uint4 u[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) u[j] = __ldcs(xv + i + j * kThreads);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      float f[kVec];
      unpack<T>(u[j], f);
      absorb<kVec>(m, l, f);
    }
  }
  for (; i < nvec; i += kThreads) {
    float f[kVec];
    unpack<T>(__ldcs(xv + i), f);
    absorb<kVec>(m, l, f);
  }
  for (long long j = tail + threadIdx.x; j < V; j += kThreads) {
    const float v = to_float(x[j]);
    absorb<1>(m, l, &v);
  }

  __shared__ float sm[kWarps], sl[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_merge(m, l);
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? sm[lane] : kNegInf;
    l = lane < kWarps ? sl[lane] : 0.f;
    warp_merge(m, l);
    if (lane == 0) {
      const long long t = (long long)targets[row];
      const float gold = (t >= 0 && t < V) ? to_float(x[t]) : 0.f;
      loss[row] = logf(fmaxf(l, 1e-30f)) + m - gold;
    }
  }
}

template <typename T>
void launch(const void* logits, const void* targets, float* loss, long long N,
            long long V, int target_dtype, cudaStream_t st) {
  const T* x = (const T*)logits;
  if (target_dtype == 0) {
    xent_kernel<T, int32_t><<<(unsigned)N, kThreads, 0, st>>>(
        x, (const int32_t*)targets, loss, V);
  } else {
    xent_kernel<T, int64_t><<<(unsigned)N, kThreads, 0, st>>>(
        x, (const int64_t*)targets, loss, V);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (logits); target_dtype: 0 = int32,
// 1 = int64. Launches the kernel on `stream` and returns cudaGetLastError()
// as an int (0 = launched). Nothing is synchronised and nothing is
// allocated here.
int softmax_xent(const void* logits, const void* targets, float* loss,
                 long long N, long long V, int dtype, int target_dtype,
                 void* stream) {
  if (N < 1 || V < 1 || N > 0x7fffffffLL || (dtype != 0 && dtype != 1) ||
      (target_dtype != 0 && target_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    launch<float>(logits, targets, loss, N, V, target_dtype, st);
  else
    launch<__nv_bfloat16>(logits, targets, loss, N, V, target_dtype, st);
  return (int)cudaGetLastError();
}

const char* xent_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
