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
//
// The backward (training). The JAX package differentiates its associative
// scan; the Pallas kernel has no backward. For the loss L with incoming
// dh_t = dL/dh_t, the recurrence's adjoint runs time in reverse:
//
//     g_t  = dh_t + a_{t+1} * g_{t+1}    (g_S = 0)
//     da_t = g_t * h_{t-1}               (h_{-1} = h0)
//     db_t = g_t,    dh0 = a_0 * g_0,
//
// float32 only (the model's a and b are float32; the state is float32 and a
// stored bf16 h would not be it). rglru_scan_backward_kernel keeps the
// forward's layout, one thread per (b, d) walking t from S-1 down to 0,
// neighbouring d per warp, kUnroll steps of loads in flight, and rounds every
// multiply and add on its own as the plain version does. It reads a, h and
// dh once and writes da and db once: 5 x 41.9 MB at the training shape
// (2, 2048, 2560), 63 us at 3.35 TB/s, against 3 operations an element; it
// is bound by bytes, and the grid there is only 40 blocks on 132 SMs.

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

// grid = (ceil(D / kBlock), B); block = kBlock. float32 only.
__global__ void __launch_bounds__(kBlock)
rglru_scan_backward_kernel(const float* __restrict__ a,
                           const float* __restrict__ h,
                           const float* __restrict__ h0,
                           const float* __restrict__ dh,
                           float* __restrict__ da, float* __restrict__ db,
                           float* __restrict__ dh0, int S, int D) {
  const int d = blockIdx.x * kBlock + threadIdx.x;
  if (d >= D) return;
  const size_t row = (size_t)blockIdx.y;
  const size_t stride = (size_t)D;
  const size_t base = row * (size_t)S * stride + (size_t)d;
  float g = 0.f;       // g_{t+1}
  float a_next = 0.f;  // a_{t+1}
  int t = S - 1;
  // steps t, t-1, ..., t-kUnroll+1, all >= 1, so h_{t-1} lies in h
  for (; t - kUnroll + 1 >= 1; t -= kUnroll) {
    float av[kUnroll], hv[kUnroll], dv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const size_t off = base + (size_t)(t - i) * stride;
      av[i] = a[off];
      dv[i] = dh[off];
      hv[i] = h[off - stride];
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const size_t off = base + (size_t)(t - i) * stride;
      g = __fadd_rn(dv[i], __fmul_rn(a_next, g));
      da[off] = __fmul_rn(g, hv[i]);
      db[off] = g;
      a_next = av[i];
    }
  }
  for (; t >= 0; --t) {
    const size_t off = base + (size_t)t * stride;
    const float h_prev = t > 0 ? h[off - stride] : h0[row * stride + (size_t)d];
    g = __fadd_rn(dh[off], __fmul_rn(a_next, g));
    da[off] = __fmul_rn(g, h_prev);
    db[off] = g;
    a_next = a[off];
  }
  dh0[row * stride + (size_t)d] = __fmul_rn(a_next, g);
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

// The backward, float32 only: a, h, dh, da, db (B, S, D) and h0, dh0 (B, D),
// contiguous. Launches on `stream` and returns cudaGetLastError() as an int.
int rglru_scan_backward(const float* a, const float* h, const float* h0,
                        const float* dh, float* da, float* db, float* dh0,
                        int B, int S, int D, void* stream) {
  if (B < 1 || S < 1 || D < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((D + kBlock - 1) / kBlock), (unsigned)B);
  rglru_scan_backward_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      a, h, h0, dh, da, db, dh0, S, D);
  return (int)cudaGetLastError();
}

const char* rglru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
