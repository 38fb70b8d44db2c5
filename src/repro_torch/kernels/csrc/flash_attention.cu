// Flash attention forward, hand-written for Hopper (sm_90a): two kernels.
//
// Both replace the Pallas TPU kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py:25. For every (batch, query head)
// and query row they compute online-softmax attention over the row's keys:
//
//     s = (q . k) / sqrt(D),   masked to -1e30 where the key is hidden,
//     out = sum_k softmax(s)_k v_k,
//
// with float32 scores, running max, running sum and accumulator, and the
// output `acc / max(l, 1e-20)` stored in the inputs' dtype. Key k is hidden
// from query q when `causal` and q - k < 0, or when a window is given and
// q - k >= window. Key k sits at position k and query row i at position
// q_offset + i (0 for a whole sequence; a sequence block's start when the
// rows are one rank's block of a longer sequence and k, v the whole of it),
// also when Sq != Sk; the offset moves only the masks and the tile bounds,
// never an address.
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
// operations, and only the tensor cores come near it.
//
// The caller picks the kernel by dtype, D and alignment alone:
//
//   - `flash_attention_tc` (bf16, D % 8 == 0, 16-byte aligned operands):
//     the tensor-core kernel `flash_tc_kernel`, below. Both products run as
//     warpgroup wgmma with float32 accumulators, fed by TMA: the products
//     of bf16 inputs are exact in float32, so the scores differ from the
//     float32 oracle only in the order of summation; the probabilities are
//     rounded to bf16 for the P V product, as the JAX model does;
//   - `flash_attention` (float32, or bf16 that the first does not take):
//     the CUDA-core kernel `flash_kernel`, float32 FMA, no TF32, so float32
//     inputs stay within 1e-5 of the oracle.
//
// CUDA-core kernel. One block of 256 threads (16 x 16) per (b * Hq + h,
// 64-row query tile). The query tile, pre-scaled, stays in shared memory; K
// and then V tiles of kBK keys are staged into one shared buffer in float32.
// Each thread owns 4 query rows: for the scores it holds 4 x kBK/16 entries
// (key columns tx + 16 j), for the output 4 x D/16 accumulators (feature
// columns in vectors of kW interleaved across tx). The rows' max and sum
// are reduced over the 16 threads that share them with shuffles. Shared
// rows are padded by 4 floats so the 16-byte loads of neighbouring threads
// fall in distinct banks. The heaviest query tiles (last under causal) are
// launched first. Nothing is atomic, so runs repeat bit for bit.
//
// Tensor-core kernel. One block of two warpgroups per (b * Hq + h, 128-row
// query tile), heaviest tiles first; each warpgroup owns 64 query rows.
// Thread 0 loads the query tile once and the first K and V tiles of 64 keys
// by TMA into a ring of stages (2 at D = 256, 4 below), each with a `full`
// barrier per operand that counts the TMA bytes; the last of the 8 warps to
// finish with a stage loads the next tile into it (no producer warp: a
// ninth warp would cap every thread at 168 registers, and the consumers
// need ~200). Per key tile a warpgroup runs S = Q K^T as 16-deep wgmma
// steps with both operands in shared memory, the online softmax on the
// accumulator fragments (row max and sum over the 4 threads that share a
// row, exp2 with the scale and log2 e folded into the float32 scores, the
// mask applied only on tiles that cross the diagonal, the window edge or
// Sk), then O += P V with P converted to bf16 in registers as the A operand
// and V read MN-major from shared memory. The two products are pipelined:
// S of tile j + 1 is computed while P V of tile j runs, and its softmax
// overlaps that product. Tiles that none of a warpgroup's rows sees are
// skipped by it. TMA reads each head through a 3-D map over (D, S, B * H),
// so rows past Sq or Sk and columns past D arrive as zeros and a ragged
// tile never reads another head; D < 256 runs in 64- or 128-wide tiles.
// Output rows and columns are stored with bounds. Nothing is atomic but the
// stage release counts, which decide only who issues a load: runs repeat
// bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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
             int q_offset, float sm_scale) {
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

  // keys any row of this tile can see: [k_lo, k_hi), from the rows'
  // positions (q_offset on)
  const int q_last = q_offset + min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = has_window ? max(0, q_offset + q0 - window + 1) : 0;

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
      const int qpos = q_offset + q0 + ty * kRows + i;
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

// Shared memory above 48 KB must be asked for, once per device and kernel
// (`ready` is the kernel's own record).
cudaError_t allow_smem(const void* kernel, size_t bytes, bool (&ready)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

template <typename T, int kD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Sk, int D, int causal, int has_window,
           int window, int q_offset, float sm_scale, cudaStream_t st) {
  static bool ready[kMaxDevices] = {};
  const cudaError_t err =
      allow_smem((const void*)flash_kernel<T, kD>, Tile<kD>::kSmem, ready);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_kernel<T, kD><<<grid, kThreads, Tile<kD>::kSmem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, Sq, Sk, D,
      causal, has_window, window, q_offset, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Hq, int Hkv, int Sq, int Sk, int D, int causal,
             int has_window, int window, int q_offset, float sm_scale,
             cudaStream_t st) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                         has_window, window, q_offset, sm_scale, st);
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                         has_window, window, q_offset, sm_scale, st);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                          has_window, window, q_offset, sm_scale, st);
  return launch<T, 256>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                        has_window, window, q_offset, sm_scale, st);
}


// ---- the tensor-core kernel (bf16) -----------------------------------------------

// two warpgroups of 64 query rows each and no producer warp: with 8 warps a
// thread may keep 255 registers (16,384 per SM quarter, 2 warps each), and
// the output (128 float32 registers at D = 256), the scores and P take ~200;
// a ninth warp would cut that to 168
constexpr int kTcThreads = 256;
constexpr int kTcBQ = 128;       // query rows per block, 64 per warpgroup
constexpr int kTcBK = 64;        // keys per K / V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = kNegInf * kLog2e;  // -1e30 in the exp2 domain
// error codes of a failed cuTensorMapEncodeTiled: kTmapError + CUresult
constexpr int kTmapError = 100000;

template <int kD>
struct TcTile {
  static constexpr int kC = kD / 64;                  // 128-byte column chunks
  static constexpr int kStages = kD >= 256 ? 2 : 4;   // K / V tiles in flight
  static constexpr int kQChunk = kTcBQ * 128;         // bytes of a Q chunk
  static constexpr int kKVChunk = kTcBK * 128;        // bytes of a K or V chunk
  static constexpr int kQBytes = kC * kQChunk;
  static constexpr int kKVBytes = kC * kKVChunk;      // one K or V tile
  static constexpr int kBarOff = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kBars = 1 + 2 * kStages;       // full_q, full_k, full_v
  // then a release count per stage; 1024 bytes of slack to align the tiles
  // for the 128-byte swizzle
  static constexpr size_t kSmem = 1024 + kBarOff + 8 * kBars + 4 * kStages;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A consumer thread's two query rows and the masking rule.
struct Rows {
  int q;        // the first row's position (q_offset on); the second is q + 8
  int col0;     // the thread's first key column in a tile (then + 1, + 8 j)
  int Sk, causal, has_window, window;
  float scale_log2;  // 1/sqrt(D) * log2 e
};

// S = Q K^T for one key tile, issued and committed, not waited for: kD / 16
// steps of 16 columns; each 128-byte row of a chunk holds 4 steps.
template <int kD>
__device__ __forceinline__ void qk_issue(float (&s)[32], uint32_t q_addr,
                                         uint32_t k_addr) {
  // descriptors of the first step, pinned before the group opens; a step
  // only adds its byte offset / 16 (no carry: shared addresses < 2^18)
  uint64_t da = hopper::desc_sw128(q_addr, 16, 1024);
  uint64_t db = hopper::desc_sw128(k_addr, 16, 1024);
  hopper::fence_reg(da);
  hopper::fence_reg(db);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t step = (kk & 3) * 32;  // bytes into the 128-byte row
    const uint64_t a = da + (((kk >> 2) * TcTile<kD>::kQChunk + step) >> 4);
    const uint64_t b = db + (((kk >> 2) * TcTile<kD>::kKVChunk + step) >> 4);
    if (kk == 0)
      hopper::wgmma_m64n64k16_ss<0>(s, a, b);  // s = Q K^T: s's old values unread
    else
      hopper::wgmma_m64n64k16_ss<1>(s, a, b);
  }
  hopper::wgmma_commit();
}

// O += P V for one key tile, issued and committed: V (keys x D) is MN-major,
// and 16 keys are two 8-row atoms (2048 bytes) of each 64-column chunk. The
// caller pins O and P (fence_ops) before any wgmma group that is in flight
// with this one: an instruction that defines a wgmma's register while a
// group is in flight makes ptxas serialize every wgmma of the kernel.
template <int kD>
__device__ __forceinline__ void pv_issue(float (&o)[kD / 64][32], const uint32_t (&p)[16],
                                         uint32_t v_addr) {
  uint64_t dv = hopper::desc_sw128(v_addr, 1024, 1024);
  hopper::fence_reg(dv);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < kD / 64; ++c)
      hopper::wgmma_m64n64k16_rs_tn(
          o[c], p + 4 * kk, dv + ((c * TcTile<kD>::kKVChunk + kk * 2048) >> 4));
  hopper::wgmma_commit();
}

// Pins O and P: their rescaling and conversion happen here, not later.
template <int kC>
__device__ __forceinline__ void fence_ops(float (&o)[kC][32], uint32_t (&p)[16]) {
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) hopper::fence_reg(o[c][i]);
#pragma unroll
  for (int i = 0; i < 16; ++i) hopper::fence_reg(p[i]);
}

// One online-softmax step on the raw scores s of the key tile at kt: scale
// into the exp2 domain, mask (only when the tile crosses the diagonal, the
// window edge or Sk), update the rows' max m and per-thread sums l, leave
// the probabilities in s and return the factor corr that rescales the rows'
// earlier output.
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const Rows& r, int kt,
                                             int qb) {
  // the warpgroup's rows are at positions [qb - 63, qb]
  const bool edge = (r.causal && kt + kTcBK - 1 > qb - 63) ||
                    (r.has_window && kt <= qb - r.window) || kt + kTcBK > r.Sk;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = s[i] * r.scale_log2;
    if (edge) {
      const int kpos = kt + 8 * (i >> 2) + r.col0 + (i & 1);
      const int diff = r.q + 8 * ((i >> 1) & 1) - kpos;
      const bool seen =
          (!r.causal || diff >= 0) && (!r.has_window || diff < r.window);
      // a key past Sk is no key at all: weight 0, never the max
      x = kpos >= r.Sk ? -INFINITY : (seen ? x : kMasked);
    }
    s[i] = x;
  }
  float mx[2] = {kMasked, kMasked}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the 4 threads of a row are neighbours in the warp
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h]);
    corr[h] = exp2f(m[h] - mn);
    m[h] = mn;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
    rs[(i >> 1) & 1] += s[i];
  }
  // the sums stay per thread until the end: corr is the same for the row
  l[0] = l[0] * corr[0] + rs[0];
  l[1] = l[1] * corr[1] + rs[1];
}

// The probabilities as bf16 pairs, the A fragment of the P V product: the
// score fragment of keys 16 kk .. 16 kk + 15 is P's k-step kk.
__device__ __forceinline__ void pack_p(const float (&s)[32], uint32_t (&p)[16]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 4; ++h)
      p[4 * kk + h] = pack_bf16(s[8 * kk + 2 * h], s[8 * kk + 2 * h + 1]);
}

// grid = (B * Hq, ceil(Sq / kTcBQ)); block = kTcThreads; dynamic shared
// memory TcTile<kD>::kSmem. tm_q, tm_k, tm_v: maps over (D, S, B * H) with
// boxes of 64 x kTcBQ (q) and 64 x kTcBK (k, v).
template <int kD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                int Hq, int Hkv, int Sq, int Sk, int D, int causal, int has_window,
                int window, int q_offset, float scale_log2) {
  using TL = TcTile<kD>;
  constexpr int kC = TL::kC, kStages = TL::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;                               // [kC][kTcBQ][64]
  uint8_t* sK = sQ + TL::kQBytes;                   // [kStages][kC][kTcBK][64]
  uint8_t* sV = sK + kStages * TL::kKVBytes;        // [kStages][kC][kTcBK][64]
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + TL::kBarOff);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  int* released = reinterpret_cast<int*>(full_v + kStages);  // warps done, per stage

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh - b * Hq;
  const int bh_kv = b * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;  // heaviest tiles first
  // keys any row of this tile can see: [k_lo, k_hi), in key tiles from kt0,
  // from the rows' positions (q_offset on)
  const int q_last = q_offset + min(q0 + kTcBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = has_window ? max(0, q_offset + q0 - window + 1) : 0;
  const int kt0 = (k_lo / kTcBK) * kTcBK;
  const int n_tiles = k_hi > kt0 ? (k_hi - kt0 + kTcBK - 1) / kTcBK : 0;

  // TMA loads of key tile j (keys kt0 + 64 j) into stage j % kStages
  auto load_tile = [&](int j) {
    const int s = j % kStages, kt = kt0 + j * kTcBK;
    hopper::mbar_arrive_expect_tx(&full_k[s], TL::kKVBytes);
#pragma unroll
    for (int c = 0; c < kC; ++c)
      hopper::tma_load_3d(sK + s * TL::kKVBytes + c * TL::kKVChunk, &tm_k, &full_k[s],
                          64 * c, kt, bh_kv);
    hopper::mbar_arrive_expect_tx(&full_v[s], TL::kKVBytes);
#pragma unroll
    for (int c = 0; c < kC; ++c)
      hopper::tma_load_3d(sV + s * TL::kKVBytes + c * TL::kKVChunk, &tm_v, &full_v[s],
                          64 * c, kt, bh_kv);
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      released[s] = 0;
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  // the query tile once, and the first kStages key tiles
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(full_q, TL::kQBytes);
#pragma unroll
    for (int c = 0; c < kC; ++c)
      hopper::tma_load_3d(sQ + c * TL::kQChunk, &tm_q, full_q, 64 * c, q0, bh);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_tile(j);
  }

  {
    // ---- 64 query rows per warpgroup
    // provably the same across the warpgroup (a shuffle from lane 0), so that
    // ptxas keeps the wgmma under the branches below pipelined
    const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
    const int t = threadIdx.x & 127;
    const int row0 = 16 * (t >> 5) + ((t & 31) >> 2);  // and row0 + 8
    const int col0 = 2 * (t & 3);                       // + 8 j (+ 1)
    const int qa = q0 + 64 * wg;                        // this warpgroup's rows
    const int pa = q_offset + qa, pb = pa + 63;         // and their positions
    // keys these rows can see: [wk_lo, wk_hi); the key tiles [j_lo, j_hi)
    // that hold any of them (a run: the causal and window edges are lines)
    const int wk_hi = causal ? min(Sk, pb + 1) : Sk;
    const int wk_lo = has_window ? max(0, pa - window + 1) : 0;
    const int j_lo = (wk_lo - kt0) / kTcBK;
    const int j_hi = min(n_tiles, wk_hi > kt0 ? (wk_hi - kt0 + kTcBK - 1) / kTcBK : 0);
    const Rows rows{pa + row0, col0, Sk, causal, has_window, window, scale_log2};
    const uint32_t q_addr = hopper::smem_u32(sQ) + 64 * 128 * wg;
    const uint32_t k_addr = hopper::smem_u32(sK), v_addr = hopper::smem_u32(sV);

    // Key tile j sits in stage j % kStages, in that stage's (j / kStages)-th
    // fill. Once all 8 warps are done with it, the last one loads tile
    // j + kStages into the stage.
    auto k_tile = [&](int j) { return k_addr + (j % kStages) * TL::kKVBytes; };
    auto v_tile = [&](int j) { return v_addr + (j % kStages) * TL::kKVBytes; };
    auto parity = [&](int j) { return (uint32_t)((j / kStages) & 1); };
    auto release = [&](int j) {
      if ((t & 31) == 0) {
        const int done = atomicAdd(&released[j % kStages], 1);
        if (done % 8 == 7 && j + kStages < n_tiles) {
          hopper::fence_proxy_async();
          load_tile(j + kStages);
        }
      }
      __syncwarp();
    };
    // a tile none of these rows sees is waited for (its stage is refilled
    // only after it landed) and released unread
    auto pass = [&](int j) {
      hopper::mbar_wait(&full_k[j % kStages], parity(j));
      hopper::mbar_wait(&full_v[j % kStages], parity(j));
      release(j);
    };

    float o[kC][32];
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

    hopper::mbar_wait(full_q, 0);
    for (int j = 0; j < min(j_lo, n_tiles); ++j) pass(j);
    if (j_lo < j_hi) {
      // Software pipeline over the tiles these rows see: while O += P V runs
      // for tile j, S = Q K^T of tile j + 1 is done and its softmax runs on
      // the CUDA cores. Every wgmma below is issued and waited for
      // unconditionally, which keeps ptxas from serializing them.
      float corr[2];
      uint32_t p[16];
      {
        float s[32];
        hopper::mbar_wait(&full_k[j_lo % kStages], parity(j_lo));
        qk_issue<kD>(s, q_addr, k_tile(j_lo));
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) hopper::fence_reg(s[i]);
        softmax_step(s, m, l, corr, rows, kt0 + j_lo * kTcBK, pb);  // O is 0
        pack_p(s, p);
      }
      for (int j = j_lo; j < j_hi - 1; ++j) {
        // P and O only change while no wgmma is in flight: a register of a
        // wgmma written while another group runs makes ptxas serialize them
        float s[32];
        fence_ops(o, p);
        hopper::mbar_wait(&full_k[(j + 1) % kStages], parity(j + 1));
        qk_issue<kD>(s, q_addr, k_tile(j + 1));
        hopper::mbar_wait(&full_v[j % kStages], parity(j));
        pv_issue<kD>(o, p, v_tile(j));
        hopper::wgmma_wait<1>();  // S of tile j + 1; P V of tile j runs on
#pragma unroll
        for (int i = 0; i < 32; ++i) hopper::fence_reg(s[i]);
        softmax_step(s, m, l, corr, rows, kt0 + (j + 1) * kTcBK, pb);
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) hopper::fence_reg(o[c][i]);
#pragma unroll
        for (int i = 0; i < 16; ++i) hopper::fence_reg(p[i]);  // read until here
        release(j);
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];
        pack_p(s, p);
      }
      fence_ops(o, p);
      hopper::mbar_wait(&full_v[(j_hi - 1) % kStages], parity(j_hi - 1));
      pv_issue<kD>(o, p, v_tile(j_hi - 1));
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) hopper::fence_reg(o[c][i]);
      release(j_hi - 1);
    }
    for (int j = max(j_hi, j_lo); j < n_tiles; ++j) pass(j);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int r0 = qa + row0, r1 = r0 + 8;
    // rows that saw no key: the mean of V over all Sk keys (attention_ref)
    const bool blind0 = m[0] == kMasked && r0 < Sq;
    const bool blind1 = m[1] == kMasked && r1 < Sq;
    if (blind0 || blind1) {
      const __nv_bfloat16* vp = v + (size_t)bh_kv * Sk * D;
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i >> 1) & 1) ? blind1 : blind0) o[c][i] = 0.f;
      for (int key = 0; key < Sk; ++key) {
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int d = 64 * c + 8 * j + col0;
            if (d >= D) continue;
            const float2 x = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(vp + (size_t)key * D + d));
            if (blind0) {
              o[c][4 * j] += x.x;
              o[c][4 * j + 1] += x.y;
            }
            if (blind1) {
              o[c][4 * j + 2] += x.x;
              o[c][4 * j + 3] += x.y;
            }
          }
      }
      if (blind0) l[0] = (float)Sk;
      if (blind1) l[1] = (float)Sk;
    }

    const float inv0 = 1.f / fmaxf(l[0], 1e-20f), inv1 = 1.f / fmaxf(l[1], 1e-20f);
    __nv_bfloat16* op = out + (size_t)bh * Sq * D;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + col0;
        if (d >= D) continue;
        if (r0 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(op + (size_t)r0 * D + d) =
              __floats2bfloat162_rn(o[c][4 * j] * inv0, o[c][4 * j + 1] * inv0);
        if (r1 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(op + (size_t)r1 * D + d) =
              __floats2bfloat162_rn(o[c][4 * j + 2] * inv1, o[c][4 * j + 3] * inv1);
      }
  }
}

template <int kD>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B, int Hq,
              int Hkv, int Sq, int Sk, int D, int causal, int has_window, int window,
              int q_offset, float sm_scale, cudaStream_t st) {
  static bool ready[kMaxDevices] = {};
  const cudaError_t err =
      allow_smem((const void*)flash_tc_kernel<kD>, TcTile<kD>::kSmem, ready);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm_q, tm_k, tm_v;
  CUresult res = hopper::tensor_map_bf16_3d(&tm_q, q, D, Sq, (uint64_t)B * Hq, kTcBQ);
  if (res == CUDA_SUCCESS)
    res = hopper::tensor_map_bf16_3d(&tm_k, k, D, Sk, (uint64_t)B * Hkv, kTcBK);
  if (res == CUDA_SUCCESS)
    res = hopper::tensor_map_bf16_3d(&tm_v, v, D, Sk, (uint64_t)B * Hkv, kTcBK);
  if (res != CUDA_SUCCESS) return kTmapError + (int)res;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + kTcBQ - 1) / kTcBQ));
  flash_tc_kernel<kD><<<grid, kTcThreads, TcTile<kD>::kSmem, st>>>(
      tm_q, tm_k, tm_v, (const __nv_bfloat16*)v, (__nv_bfloat16*)out, Hq, Hkv, Sq, Sk,
      D, causal, has_window, window, q_offset, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). `window` is read only
// when has_window is 1; `q_offset` >= 0 is query row 0's position, with
// q_offset + Sq < 2^31. Launches the kernel on `stream` and returns
// cudaGetLastError() as an int (0 = launched). Nothing is synchronised and
// nothing is allocated here.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                    int has_window, int window, int q_offset, float sm_scale,
                    int dtype, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Sk < 1 || D < 1 ||
      D > 256 || (long long)B * Hq > 0x7fffffffLL ||
      ((long long)Sq + kBQ - 1) / kBQ > 65535 || (dtype != 0 && dtype != 1) ||
      q_offset < 0 || (long long)q_offset + Sq > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                           has_window, window, q_offset, sm_scale, st);
  return launch_d<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                          has_window, window, q_offset, sm_scale, st);
}

// The tensor-core kernel: q, k, v and out bfloat16, D % 8 == 0, every
// pointer 16-byte aligned (what TMA needs), `q_offset` as above; otherwise
// cudaErrorInvalidValue.
// Builds the three tensor maps on the host, launches on `stream` and returns
// cudaGetLastError() as an int, or kTmapError + the CUresult when a map
// cannot be encoded.
int flash_attention_tc(const void* q, const void* k, const void* v, void* out,
                       int B, int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                       int has_window, int window, int q_offset, float sm_scale,
                       void* stream) {
  const bool aligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 == 0;
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Sk < 1 || D < 8 ||
      D > 256 || D % 8 || !aligned || (long long)B * Hq > 0x7fffffffLL ||
      ((long long)Sq + kTcBQ - 1) / kTcBQ > 65535 || q_offset < 0 ||
      (long long)q_offset + Sq > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D <= 64)
    return launch_tc<64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal, has_window,
                         window, q_offset, sm_scale, st);
  if (D <= 128)
    return launch_tc<128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal, has_window,
                          window, q_offset, sm_scale, st);
  return launch_tc<256>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal, has_window,
                        window, q_offset, sm_scale, st);
}

const char* flash_error_string(int code) {
  if (code >= kTmapError) return "cuTensorMapEncodeTiled failed (CUresult = code - 100000)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
