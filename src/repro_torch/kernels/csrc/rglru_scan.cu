// RG-LRU linear-recurrence scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rglru_kernel` / `rglru_scan` of
// src/repro/kernels/rglru_scan.py:22. Every RG-LRU layer of the model's
// prefill (recurrentgemma-2b: 18 of its 26 layers) runs the recurrence
//
//     h_t = a_t * h_{t-1} + b_t,    t = 0..S-1, from h_{-1} = h0,
//
// independently for every (batch row b, feature d), with the state in
// float32 and each h_t stored in the output dtype (the inputs' dtype).
//
// Operands (contiguous, on one device): a and b (B, S, D), float32 or
// bfloat16 (both the same); h0 (B, D) float32; out (B, S, D) in a's dtype.
// Any B (<= 65535), S and D: the ragged feature edge is masked.
//
// Bound on the card. The recurrence does 2 operations per element and must
// read a and b once and write out once: at the model's prefill shape
// (8, 2048, 2560) in float32 that is 3 x 167.8 MB = 503 MB, 150 us at
// 3.35 TB/s, against 0.17 GFLOP (2.5 us at 67 TFLOP/s). It is bound by
// bytes, and the dependency chain runs along S, not D.
//
// Design. One thread per (b, d) feature walks time sequentially in
// registers; the threads of a warp hold neighbouring d, so every time step's
// loads and store are coalesced 128-byte (float32) or 64-byte (bfloat16)
// transactions. A block covers kBlock features of one batch row: grid =
// (ceil(D / kBlock), B). The card needs a few MB of loads in flight to reach
// its memory rate, and B * D threads are only ~20k at the model's shape, so
// each thread starts the loads of kUnroll time steps before it consumes
// them: 20,480 threads x 16 steps x 8 bytes = 2.6 MB in flight. The time
// loop's tail (S not a multiple of kUnroll) runs one step at a time.
//
// Arithmetic order. Each step is one multiply then one add, rounded on its
// own with __fmul_rn / __fadd_rn: nvcc would otherwise contract them into an
// FMA, which rounds once and differs from the plain PyTorch version (a
// separate multiply and add). Written this way the two agree to the last
// bit. There are no atomics, so runs repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // features (threads) per block
constexpr int kUnroll = 16;  // time steps whose loads are in flight together

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
  return __float2bfloat16_rn(x);
}

// grid = (ceil(D / kBlock), B); block = kBlock.
template <typename T>
__global__ void __launch_bounds__(kBlock)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, T* __restrict__ out, int S,
                  int D) {
  const int d = blockIdx.x * kBlock + threadIdx.x;
  if (d >= D) return;
  const size_t row = (size_t)blockIdx.y;
  const size_t stride = (size_t)D;
  size_t off = row * (size_t)S * stride + (size_t)d;
  float h = h0[row * stride + (size_t)d];

  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      av[i] = to_float(a[off + i * stride]);
      bv[i] = to_float(b[off + i * stride]);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      h = __fadd_rn(__fmul_rn(av[i], h), bv[i]);
      out[off + i * stride] = from_float<T>(h);
    }
    off += kUnroll * stride;
  }
  for (; t < S; ++t) {
    h = __fadd_rn(__fmul_rn(to_float(a[off]), h), to_float(b[off]));
    out[off] = from_float<T>(h);
    off += stride;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b and out). Launches the kernel on
// `stream` and returns cudaGetLastError() as an int (0 = launched). Nothing
// is synchronised and nothing is allocated here.
int rglru_scan(const void* a, const void* b, const float* h0, void* out, int B,
               int S, int D, int dtype, void* stream) {
  if (B < 1 || S < 1 || D < 1 || B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((D + kBlock - 1) / kBlock), (unsigned)B);
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    rglru_scan_kernel<float><<<grid, kBlock, 0, st>>>(
        (const float*)a, (const float*)b, h0, (float*)out, S, D);
  } else {
    rglru_scan_kernel<__nv_bfloat16><<<grid, kBlock, 0, st>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, h0,
        (__nv_bfloat16*)out, S, D);
  }
  return (int)cudaGetLastError();
}

const char* rglru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
