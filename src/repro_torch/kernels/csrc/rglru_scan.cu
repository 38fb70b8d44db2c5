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
// Any B (<= 65535), S and D: the ragged edges are masked.
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
// stored bf16 h would not be it).
//
// Bound on the card. Each chain is a dependent multiply then add per step,
// so the work is sequential along S and parallel only over B * D chains.
// The forward reads a and b once and writes out once (3 x 4 bytes an element
// in float32), the backward reads a, h and dh and writes da and db (5 x 4):
// at the training shape (2, 2048, 2560) 126 MB and 210 MB, 37.6 us and
// 62.6 us at 3.35 TB/s; at the prefill shape (8, 2048, 2560) 503 MB, 150 us.
// The arithmetic (2 and 3 operations an element) is far below that, and one
// chain's walk of 2,048 steps at ~8 cycles a step takes ~9 us. Both kernels
// are bound by bytes, provided enough loads are in flight.
//
// Arithmetic order. Each step rounds its multiply and its add on its own
// (__fmul_rn / __fadd_rn): nvcc would otherwise contract them into an FMA,
// which rounds once and differs from the plain PyTorch version (a separate
// multiply and add). Every chain walks its steps in order, one step after the
// other, in both routes, so kernel and plain version agree to the last bit.
// There are no atomics, so runs repeat bit for bit.
//
// Two routes, chosen by the wrapper from the dtype, D and the operands'
// addresses alone (kernels/rglru_scan.py `_route`), never on failure:
//
// The TMA route (rglru_scan_tma_kernel, rglru_scan_backward_tma_kernel):
// float32 with D % 4 == 0 or bf16 with D % 8 == 0, every operand 16-byte
// aligned (TMA's row stride and base). A block is one warp, one lane a
// chain: the forward's block covers 32 neighbouring features of one batch
// row, the backward's 64 (two chains a lane, whose walks interleave). Each
// operand has a ring of kStages shared-memory tiles of kSteps time steps x
// the block's features, filled by cp.async.bulk.tensor.3d over the (D, S,
// B) tensor, each stage completing on its own mbarrier. Before the warp
// walks tile k, one lane issues tile k + kStages - 1 into the stage tile
// k - 1 left, so kStages - 1 tiles a block are always in flight while the
// lanes walk the one that has landed, each reading 32 consecutive values of
// one step (no bank conflict). The walk takes a tile's operands into
// registers 16 steps at a time, the next 16 loaded before this 16's
// results are stored, so no shared-memory load sits on the chain. The
// results go to a shared-memory output tile (two, used in turn) that one
// TMA store writes out; TMA skips what lies past D or S. The grid is
// persistent: min(work items, blocks resident on the card), each block
// walking its items (b, column of features) one after the other on one
// continuous ring, so the next item's tiles load while the current one's
// last steps are walked. TMA fills out-of-range coordinates with zeros:
// past the end a step sees a = b = 0 (forward) or a = dh = 0 (backward),
// which leaves the backward's carried a_{t+1} and g exactly +0, the state it
// starts from. The backward walks each item's tiles from the end and loads
// the h tile of steps [t0, t0 + kSteps) from coordinate t0 - 1, so each
// step's h_{t-1} sits beside its a and dh; coordinate -1 reads as zero and
// step 0 takes h0 instead. It carries a_{t+1} and g across tiles.
//
// Sizing, measured on the H100 against other tilings, stage counts, per-step
// global stores of the output and L2 promotions: the forward's tiles are 32
// steps, 8 stages (3 blocks an SM in float32); the backward's 32 steps of
// 64 features, 3 stages (2 blocks an SM). Both then reach 73-82% of their
// byte bounds (2.5-2.7 TB/s; chip_smoke.py phases 10 and 15).
//
// The direct route (rglru_scan_kernel, rglru_scan_backward_kernel): every
// other operand (another D, a misaligned view). One thread per (b, d) walks
// time in registers; the threads of a warp hold neighbouring d, so every
// time step's loads and store are coalesced. A block covers kBlock features
// of one batch row: grid = (ceil(D / kBlock), B). Each thread issues the
// loads of kUnroll steps, waits for them and walks them, so each 16 steps
// cost one full round trip to memory: ~230 us at the training shape whatever
// B, and only 40 blocks at B 2. That is what bound the first design, and
// what the TMA route's ring removes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ---- the TMA route ------------------------------------------------------------

constexpr int kLanes = 32;  // lanes per block: one warp
constexpr int kMaxDevices = 64;
// error codes of a failed cuTensorMapEncodeTiled: kTmapError + CUresult
constexpr int kTmapError = 100000;

// A block's tiling: each lane walks kChains chains (features lane,
// lane + 32, ...), so a block covers kWidth features; a tile holds kSteps
// steps of them; each operand ring has kStages tiles. The walk moves a
// tile's operands to registers kChunk steps at a time.
template <int kChains_, int kSteps_, int kStages_>
struct Tiling {
  static constexpr int kChains = kChains_;
  static constexpr int kWidth = kLanes * kChains_;
  static constexpr int kSteps = kSteps_;
  static constexpr int kStages = kStages_;
  static constexpr int kTile = kSteps_ * kWidth;  // elements
  static constexpr int kChunk = 16;
  static_assert(kSteps_ % kChunk == 0, "a tile is whole chunks");
};
// Sized on the H100: the forward keeps 7 tiles of 32 steps in flight a warp
// (3 blocks an SM in float32), the backward 2 tiles of 32 steps x 64
// features, two chains a lane (2 blocks an SM).
using FwdTiling = Tiling<1, 32, 8>;
using BwdTiling = Tiling<2, 32, 3>;

// Shared memory from `raw`, rounded up to 128 bytes (TMA's tile alignment).
__device__ __forceinline__ uint8_t* align128(uint8_t* raw) {
  return raw + ((128 - (hopper::smem_u32(raw) & 127)) & 127);
}

// The block's work items (b, kWidth-feature column) are blockIdx.x,
// blockIdx.x + gridDim.x, ...; each holds `tiles` tiles. The producer (lane
// 0) walks them in order, one tile at a time.
template <int kStages>
struct Cursor {
  int k = 0;      // the block's k-th item
  int tile = 0;   // tile within the item
  int stage = 0;  // ring stage of this tile
  __device__ void next(int tiles) {
    if (++tile == tiles) {
      tile = 0;
      ++k;
    }
    if (++stage == kStages) stage = 0;
  }
};

__device__ __forceinline__ int item_of(int k) { return blockIdx.x + k * gridDim.x; }

// grid = min(B * ceil(D / 32), resident blocks); block = 32; dynamic shared
// memory: 2 rings of kStages tiles, 2 output tiles, 128 bytes of alignment.
// tm_a, tm_b, tm_out: maps over (D, S, B), box {32, kSteps, 1}.
template <typename T>
__global__ void __launch_bounds__(kLanes)
rglru_scan_tma_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_b,
                      const __grid_constant__ CUtensorMap tm_out,
                      const float* __restrict__ h0, int B, int S, int D) {
  using L = FwdTiling;
  static_assert(L::kWidth == kLanes, "the forward walks one chain a lane");
  constexpr int kTile = L::kTile, kSteps = L::kSteps, kChunk = L::kChunk;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[L::kStages];
  T* sa = reinterpret_cast<T*>(align128(smem_raw));
  T* sb = sa + L::kStages * kTile;
  T* so = sb + L::kStages * kTile;  // [2][kTile]: the output, by tile parity
  const int lane = threadIdx.x;
  const int cols = (D + kLanes - 1) / kLanes;
  const int tiles = (S + kSteps - 1) / kSteps;
  const int items = (B * cols - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  Cursor<L::kStages> prod;
  auto issue = [&]() {
    const int item = item_of(prod.k), row = item / cols, col = item - row * cols;
    uint64_t* bar = &full[prod.stage];
    hopper::mbar_arrive_expect_tx(bar, 2 * kTile * (uint32_t)sizeof(T));
    hopper::tma_load_3d(sa + prod.stage * kTile, &tm_a, bar, col * kLanes,
                        prod.tile * kSteps, row);
    hopper::tma_load_3d(sb + prod.stage * kTile, &tm_b, bar, col * kLanes,
                        prod.tile * kSteps, row);
    prod.next(tiles);
  };
  if (lane == 0) {
    for (int s = 0; s < L::kStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (lane == 0)
    for (int i = 0; i < L::kStages - 1 && prod.k < items; ++i) issue();

  int stage = 0, n_tile = 0;
  uint32_t parity = 0;
  for (int k = 0; k < items; ++k) {
    const int item = item_of(k), row = item / cols, col = item - row * cols;
    const int d = col * kLanes + lane;
    float h = d < D ? h0[(size_t)row * D + d] : 0.f;
    for (int tile = 0; tile < tiles; ++tile, ++n_tile) {
      // the output tile of two tiles ago has been read out of shared memory
      if (lane == 0) hopper::bulk_wait_read<1>();
      // and every lane is done with the last tile's stage: refill that stage
      __syncwarp();
      if (lane == 0 && prod.k < items) {
        hopper::fence_proxy_async();
        issue();
      }
      hopper::mbar_wait(&full[stage], parity);
      const T* ta = sa + stage * kTile + lane;
      const T* tb = sb + stage * kTile + lane;
      T* to = so + (n_tile & 1) * kTile;
      // The tile's operands go to registers kChunk steps at a time, the next
      // chunk loaded before this chunk's stores: the compiler may not move a
      // load over a store that could alias it, and a shared-memory load on
      // the chain would cost its latency every step.
      float va[kChunk], vb[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        va[i] = to_float(ta[i * kLanes]);
        vb[i] = to_float(tb[i * kLanes]);
      }
#pragma unroll
      for (int i0 = 0; i0 < kSteps; i0 += kChunk) {
        float na[kChunk], nb[kChunk];
        if (i0 + kChunk < kSteps) {
#pragma unroll
          for (int i = 0; i < kChunk; ++i) {
            na[i] = to_float(ta[(i0 + kChunk + i) * kLanes]);
            nb[i] = to_float(tb[(i0 + kChunk + i) * kLanes]);
          }
        }
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          h = __fadd_rn(__fmul_rn(va[i], h), vb[i]);
          to[(i0 + i) * kLanes + lane] = from_float<T>(h);
        }
        if (i0 + kChunk < kSteps) {
#pragma unroll
          for (int i = 0; i < kChunk; ++i) {
            va[i] = na[i];
            vb[i] = nb[i];
          }
        }
      }
      // steps past S and features past D are not written
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        hopper::tma_store_3d(&tm_out, to, col * kLanes, tile * kSteps, row);
        hopper::bulk_commit();
      }
      if (++stage == L::kStages) {
        stage = 0;
        parity ^= 1;
      }
    }
  }
  if (lane == 0) hopper::bulk_wait<0>();
}

// grid = min(B * ceil(D / 64), resident blocks); block = 32; dynamic shared
// memory: 3 rings of kStages tiles, 2 x 2 output tiles, 128 bytes of
// alignment. Maps over (D, S, B), box {64, kSteps, 1}; float32.
__global__ void __launch_bounds__(kLanes)
rglru_scan_backward_tma_kernel(const __grid_constant__ CUtensorMap tm_a,
                               const __grid_constant__ CUtensorMap tm_h,
                               const __grid_constant__ CUtensorMap tm_dh,
                               const __grid_constant__ CUtensorMap tm_da,
                               const __grid_constant__ CUtensorMap tm_db,
                               const float* __restrict__ h0, float* __restrict__ dh0,
                               int B, int S, int D) {
  using L = BwdTiling;
  constexpr int kTile = L::kTile, kW = L::kWidth, kSteps = L::kSteps;
  constexpr int kChunk = L::kChunk, kChains = L::kChains;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[L::kStages];
  float* sa = reinterpret_cast<float*>(align128(smem_raw));
  float* sh = sa + L::kStages * kTile;
  float* sd = sh + L::kStages * kTile;
  float* so = sd + L::kStages * kTile;  // [2][2][kTile]: da, db, by tile parity
  const int lane = threadIdx.x;
  const int cols = (D + kW - 1) / kW;
  const int tiles = (S + kSteps - 1) / kSteps;
  const int items = (B * cols - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  // tiles run from the end: the cursor's tile r is tile tiles - 1 - r
  Cursor<L::kStages> prod;
  auto issue = [&]() {
    const int item = item_of(prod.k), row = item / cols, col = item - row * cols;
    const int t0 = (tiles - 1 - prod.tile) * kSteps;
    uint64_t* bar = &full[prod.stage];
    hopper::mbar_arrive_expect_tx(bar, 3 * kTile * (uint32_t)sizeof(float));
    hopper::tma_load_3d(sa + prod.stage * kTile, &tm_a, bar, col * kW, t0, row);
    hopper::tma_load_3d(sh + prod.stage * kTile, &tm_h, bar, col * kW, t0 - 1, row);
    hopper::tma_load_3d(sd + prod.stage * kTile, &tm_dh, bar, col * kW, t0, row);
    prod.next(tiles);
  };
  if (lane == 0) {
    for (int s = 0; s < L::kStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (lane == 0)
    for (int i = 0; i < L::kStages - 1 && prod.k < items; ++i) issue();

  int stage = 0, n_tile = 0;
  uint32_t parity = 0;
  for (int k = 0; k < items; ++k) {
    const int item = item_of(k), row = item / cols, col = item - row * cols;
    const int d0 = col * kW + lane;
    float h_init[kChains], g[kChains], a_next[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      h_init[c] = d0 + kLanes * c < D ? h0[(size_t)row * D + d0 + kLanes * c] : 0.f;
      g[c] = 0.f;       // g_{t+1}
      a_next[c] = 0.f;  // a_{t+1}
    }
    for (int r = 0; r < tiles; ++r, ++n_tile) {
      if (lane == 0) hopper::bulk_wait_read<1>();
      __syncwarp();
      if (lane == 0 && prod.k < items) {
        hopper::fence_proxy_async();
        issue();
      }
      hopper::mbar_wait(&full[stage], parity);
      const float* ta = sa + stage * kTile + lane;
      const float* th = sh + stage * kTile + lane;  // h_{t0 + i - 1} at step i
      const float* td = sd + stage * kTile + lane;
      float* tda = so + (n_tile & 1) * 2 * kTile;
      float* tdb = tda + kTile;
      const int t0 = (tiles - 1 - r) * kSteps;
      // registers kChunk steps at a time from the tile's end, the next chunk
      // loaded before this chunk's stores, as in the forward
      float va[kChunk][kChains], vh[kChunk][kChains], vd[kChunk][kChains];
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          const int e = (kSteps - kChunk + i) * kW + kLanes * c;
          va[i][c] = ta[e];
          vh[i][c] = th[e];
          vd[i][c] = td[e];
        }
#pragma unroll
      for (int i0 = kSteps - kChunk; i0 >= 0; i0 -= kChunk) {
        float na[kChunk][kChains], nh[kChunk][kChains], nd[kChunk][kChains];
        if (i0 > 0) {
#pragma unroll
          for (int i = 0; i < kChunk; ++i)
#pragma unroll
            for (int c = 0; c < kChains; ++c) {
              const int e = (i0 - kChunk + i) * kW + kLanes * c;
              na[i][c] = ta[e];
              nh[i][c] = th[e];
              nd[i][c] = td[e];
            }
        }
#pragma unroll
        for (int i = kChunk - 1; i >= 0; --i)
#pragma unroll
          for (int c = 0; c < kChains; ++c) {
            const int e = (i0 + i) * kW + kLanes * c + lane;
            g[c] = __fadd_rn(vd[i][c], __fmul_rn(a_next[c], g[c]));
            const float h_prev = (i0 + i == 0 && t0 == 0) ? h_init[c] : vh[i][c];
            tda[e] = __fmul_rn(g[c], h_prev);
            tdb[e] = g[c];
            a_next[c] = va[i][c];
          }
        if (i0 > 0) {
#pragma unroll
          for (int i = 0; i < kChunk; ++i)
#pragma unroll
            for (int c = 0; c < kChains; ++c) {
              va[i][c] = na[i][c];
              vh[i][c] = nh[i][c];
              vd[i][c] = nd[i][c];
            }
        }
      }
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        hopper::tma_store_3d(&tm_da, tda, col * kW, t0, row);
        hopper::tma_store_3d(&tm_db, tdb, col * kW, t0, row);
        hopper::bulk_commit();
      }
      if (++stage == L::kStages) {
        stage = 0;
        parity ^= 1;
      }
    }
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      if (d0 + kLanes * c < D)
        dh0[(size_t)row * D + d0 + kLanes * c] = __fmul_rn(a_next[c], g[c]);
  }
  if (lane == 0) hopper::bulk_wait<0>();
}

// Blocks of `kernel` (kLanes threads, `smem` bytes of dynamic shared memory)
// resident on the current device at once, into *blocks. The shared memory
// is asked for and the occupancy read once per device (`cache` is the
// kernel's own record). Makes the device's primary context current on this
// thread first: cuTensorMapEncodeTiled needs one, and autograd runs the
// backward (and a checkpoint's recomputed forward) on threads of its own.
template <typename K>
cudaError_t resident_blocks(K kernel, size_t smem, int (&cache)[kMaxDevices],
                            int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLanes, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[dev] = per_sm * sms;
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

// Encodes a map over each (B, S, D) array of `ptrs` with box
// {kWidth, kSteps, 1}; kTmapError + the CUresult of the first that fails.
template <typename L>
int encode_maps(CUtensorMap* maps, const void* const* ptrs, int n, CUtensorMapDataType type,
                int B, int S, int D) {
  for (int i = 0; i < n; ++i) {
    const CUresult res =
        hopper::tensor_map_3d(&maps[i], type, ptrs[i], D, S, B, L::kWidth, L::kSteps);
    if (res != CUDA_SUCCESS) return kTmapError + (int)res;
  }
  return 0;
}

template <typename T>
int launch_tma(const void* a, const void* b, const float* h0, void* out, int B, int S,
               int D, cudaStream_t st) {
  using L = FwdTiling;
  static int cache[kMaxDevices] = {};
  const size_t smem = (2 * L::kStages + 2) * L::kTile * sizeof(T) + 128;
  int resident = 0;
  const cudaError_t err = resident_blocks(rglru_scan_tma_kernel<T>, smem, cache, &resident);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm[3];
  const void* ptrs[3] = {a, b, out};
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int bad = encode_maps<L>(tm, ptrs, 3, type, B, S, D);
  if (bad) return bad;
  const long long items = (long long)B * ((D + L::kWidth - 1) / L::kWidth);
  const unsigned grid = (unsigned)(items < resident ? items : resident);
  rglru_scan_tma_kernel<T><<<grid, kLanes, smem, st>>>(tm[0], tm[1], tm[2], h0, B, S, D);
  return (int)cudaGetLastError();
}

int launch_backward_tma(const float* a, const float* h, const float* h0, const float* dh,
                        float* da, float* db, float* dh0, int B, int S, int D,
                        cudaStream_t st) {
  using L = BwdTiling;
  static int cache[kMaxDevices] = {};
  const size_t smem = (3 * L::kStages + 4) * L::kTile * sizeof(float) + 128;
  int resident = 0;
  const cudaError_t err =
      resident_blocks(rglru_scan_backward_tma_kernel, smem, cache, &resident);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm[5];
  const void* ptrs[5] = {a, h, dh, da, db};
  const int bad = encode_maps<L>(tm, ptrs, 5, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, B, S, D);
  if (bad) return bad;
  const long long items = (long long)B * ((D + L::kWidth - 1) / L::kWidth);
  const unsigned grid = (unsigned)(items < resident ? items : resident);
  rglru_scan_backward_tma_kernel<<<grid, kLanes, smem, st>>>(tm[0], tm[1], tm[2], tm[3],
                                                             tm[4], h0, dh0, B, S, D);
  return (int)cudaGetLastError();
}

// What the TMA route takes: every address 16-byte aligned, rows of D
// elements a multiple of 16 bytes, and B * ceil(D / 32) work items in an int.
bool tma_operands(const void* const* ptrs, int n, int B, int D, int elem_bytes) {
  uintptr_t any = 0;
  for (int i = 0; i < n; ++i) any |= (uintptr_t)ptrs[i];
  return any % 16 == 0 && ((long long)D * elem_bytes) % 16 == 0 &&
         (long long)B * ((D + kLanes - 1) / kLanes) <= 0x7fffffffLL;
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

// The TMA route of the forward: as rglru_scan, with a, b and out 16-byte
// aligned and D * (4 or 2 bytes) a multiple of 16 (what TMA needs);
// otherwise cudaErrorInvalidValue. Builds the tensor maps on the host,
// launches on `stream` and returns cudaGetLastError() as an int, or
// kTmapError + the CUresult when a map cannot be encoded.
int rglru_scan_tma(const void* a, const void* b, const float* h0, void* out, int B,
                   int S, int D, int dtype, void* stream) {
  const void* ptrs[3] = {a, b, out};
  if (B < 1 || S < 1 || D < 1 || B > 65535 || (dtype != 0 && dtype != 1) ||
      !tma_operands(ptrs, 3, B, D, dtype == 0 ? 4 : 2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_tma<float>(a, b, h0, out, B, S, D, st);
  return launch_tma<__nv_bfloat16>(a, b, h0, out, B, S, D, st);
}

// The TMA route of the backward: as rglru_scan_backward, with a, h, dh, da
// and db 16-byte aligned and D % 4 == 0; otherwise cudaErrorInvalidValue.
int rglru_scan_backward_tma(const float* a, const float* h, const float* h0,
                            const float* dh, float* da, float* db, float* dh0, int B,
                            int S, int D, void* stream) {
  const void* ptrs[5] = {a, h, dh, da, db};
  if (B < 1 || S < 1 || D < 1 || B > 65535 || !tma_operands(ptrs, 5, B, D, 4))
    return (int)cudaErrorInvalidValue;
  return launch_backward_tma(a, h, h0, dh, da, db, dh0, B, S, D, (cudaStream_t)stream);
}

const char* rglru_error_string(int code) {
  if (code >= kTmapError) return "cuTensorMapEncodeTiled failed (CUresult = code - 100000)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
