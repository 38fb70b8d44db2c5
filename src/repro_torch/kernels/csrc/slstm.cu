// sLSTM recurrence (the xLSTM scalar-memory mixer), hand-written for Hopper
// (sm_90a): the forward scan and its backward, each one cooperative launch.
//
// Replaces no Pallas kernel. The JAX model runs the recurrence as a
// jax.lax.scan over time (src/repro/models/layers.py:699 `slstm_apply`, :725
// `slstm_decode`, the cell `_slstm_cell` :666), which XLA compiles into one
// loop on the device. Here the whole scan is one launch, and so is its
// backward (the JAX model differentiates the scan).
//
// The function, in float32. xwb (B, S, 4d) is x @ w_x plus the bias; r (H,
// hd, 4 hd) the block-diagonal recurrence (d = H hd); the state h, c, n, m
// (B, d). A step:
//
//     rec[:, k*4hd:(k+1)*4hd] = h[:, k*hd:(k+1)*hd] @ r[k]       (per head k)
//     pre = xwb_t + rec,   [i | f | z | o] = pre split in four along 4d
//     lfm = log_sigmoid(f) + m,   m' = max(lfm, i)
//     c' = exp(lfm - m') c + exp(i - m') tanh(z),   n' = exp(lfm - m') n + exp(i - m')
//     h' = sigmoid(o) c' / max(n', 1)
//
// The gate layout is the trap: the per-head products are laid end to end and
// only then split into the four gates across the whole 4d row, so column
// col = gate * d + j reads head col / (4 hd). At xlstm-350m's width (d 1024, H
// 4) every feature's i gate reads head 0 and its o gate head 3, so every step
// needs the whole h_{t-1} of every head.
//
// Operands (contiguous, float32, one device). Forward: xwb, r, h0, c0, n0, m0
// in; hs (B, S, d) out, and with `save` the state after every step cs, ns, ms
// (B, S, d) and the pre-activations pre (B, S, 4d) (what the backward reads);
// without it cs, ns, ms (B, 1, d) hold the final state. Backward: r, pre, cs,
// ns, ms, c0, n0, m0, the incoming dhs (B, S, d) and the final state's dcT,
// dnT, dmT (B, d) in; dpre (B, S, 4d) (= dxwb) and the initial state's dh0,
// dc0, dn0, dm0 out. dr = sum over (b, t) of h_{t-1}^T dpre_t per head is one
// torch.bmm after the kernel (kernels/slstm.py).
//
// Design (the narrow route; the wide one below). One cooperative launch
// (co-residency guaranteed, else refused), one block of 256 threads for each
// 8 features (128 blocks, one an SM, at
// xlstm-350m's width), each owning the 32 gate columns j, d+j, 2d+j, 3d+j of
// the forward, the 8 rows of r[k] the backward needs for dh. Its share of r
// (32 KB at hd 256) stays in registers for the whole scan, 32 a thread. Rows
// go 8 at a time, each pass of 8 rows a scan of its own. A step is then one
// exchange between the SMs and little else on the chain:
//
//   - the exchange: the 64 gate threads store the block's piece of the step
//     (h_t forward; dpre_t backward, a piece a gate) into an exchange buffer
//     of three slots used in turn, meet at a named barrier, and one of them
//     raises the block's flag with st.release.gpu. Reader thread p polls
//     block p's flag (the flags a 128-byte line apart) with relaxed loads and
//     re-reads it once with an acquire load; the block then loads every
//     piece it needs into shared memory, all its 16-byte loads issued at
//     once. A flag holds the launch epoch plus the step, 64 bits that never
//     wrap: the epoch lives in the sync state (slstm_sync_words() words that
//     the wrapper zeroes once and keeps for the eager launches of a stream,
//     and zeroes in front of each launch captured into a CUDA graph), and
//     block 0 advances it at the end, so no flag of an earlier launch passes
//     for a current one. A wait is clock-bounded and traps instead of
//     hanging. The step's outputs are stored after the flag: nothing on the
//     chain waits for them;
//   - the products: warp w takes 4 columns of one gate (forward) or 4
//     features and a quarter of their head's 4 hd columns (backward); lane l
//     the k (or e) = l + 32 i. Each lane sums its part for 8 rows x 4
//     columns, with no branch, then a butterfly reduce-scatter over the
//     warp's shuffles leaves lane l the sum of (row l / 4, column l % 4). One
//     __syncthreads hands the sums to the 64 gate threads (a row and feature
//     each);
//   - off the chain: what a step reads that does not depend on the step
//     before (xwb_t forward; pre_t, the state at t-1 and dhs_t backward)
//     arrives by cp.async into a ring of 8 steps in shared memory, issued 6
//     steps ahead while the block waits at the exchange; the carried state
//     (c, n, m forward; dc, dn, dm and c_t, n_t backward) stays in the gate
//     thread's registers, read once and written where an output needs it.
//
// Arithmetic order. Every sum runs in a fixed order (no atomics), so a second
// run is identical bit for bit. The forward's state update rounds each
// multiply and add on its own (__fmul_rn / __fadd_rn), as the plain PyTorch
// version does; only the recurrent products' order (and the library's exp /
// tanh / log1p) differs from it, ~1e-7 relative a step.
//
// Bound on the card. At the prefill shape (8, 2048, d 1024, H 4) the products
// are 8 B S d hd = 34.4 GFLOP each way, 0.51 ms at the FP32 rate (67 TFLOP/s);
// the forward moves 340 MB (xwb in, hs out), 0.10 ms at 3.35 TB/s: bound by
// operations. The S steps are a chain of exchanges between the SMs, which
// that bound does not see. On an NVIDIA H100 80GB HBM3 at 700.00 W (a probe
// that timed variants of the kernels, PERF.md): the exchange alone, 32 KB a
// block at 128 blocks, takes 1.76 us a step, 3.61 ms over 2,048 steps, this
// design's floor (the first design's grid barrier alone: 1.41 us a step, 2.88 ms).
// A step takes ~3.0 us forward and ~3.4 us backward (6.2 and 6.9 ms, 12x
// and 13x the bound): the exchange ~1.9 us of it (the flag's release 0.46,
// the wait 0.52, the fetch 0.89), the products 0.71 us, the gate update
// 0.28-0.39 us. Timed beside it: flags packed together (2.41 us an
// exchange), relaxed polls and a fence (3.06), one counter (1.64),
// self-tagged 64-bit words and no flag (4.53: twice the bytes), a
// cluster's shared-memory broadcast (3.17-3.67); at 64 or 32 blocks the
// exchange alone takes 1.60 or 1.57 us, while each block's products would
// grow 2x or 4x (reasoned: the whole kernels were not timed at those grids).
//
// Routes. Every (d, H) with H dividing d runs, each way; which route and
// instance a shape takes, its grid and its shared memory, is plan_for's
// answer (slstm_plan asks it without launching):
//
//   - narrow, the design above: a head of at most 256 (r's share in
//     registers: instances for hd <= 32, 64, 128, 256), at most 256 groups of
//     8 features (one flag each), one block a group. Where the groups
//     outnumber the SMs (d > 1056 on a 132-SM H100, or xlstm-350m's 128 on a
//     card of fewer SMs) each kernel runs as a second instance compiled for
//     two blocks an SM (launch bounds: at most 128 registers a thread), the
//     same code, up to twice the SMs in groups;
//   - wide, every other shape: a head over 256 (the xLSTM paper's 760M, 1.3B
//     and 2.7B: hd 384, 512, 640), or more groups than two blocks an SM hold.
//     One block an SM, each owning gpb = ceil(groups / SMs) groups, so the
//     grid stays within the 256 flags and a step is still one flag a block.
//     r's share of a block no longer fits 32 registers a thread (1.3B: 128 KB
//     a block, 2.7B: 240 KB), so it lives in shared memory, as many of the
//     block's 4-column jobs as fit beside the staged tile, and the rest in
//     device memory (L2 up to ~50 MB): the backward reads r's rows where they
//     lie (e contiguous), the forward a copy of its columns transposed (k
//     contiguous), which each block writes for itself before the scan, after
//     the exchange buffer. The staged tile (h_{t-1} forward, the block's heads
//     of dpre_{t+1} backward) is staged whole where it fits and otherwise in
//     chunks, the sums of a chunk added to the last in order; a block's
//     features go in rounds of 32 (8 rows x 32 = one (row, feature) a
//     thread); and the carried state goes through device memory (the state
//     outputs, read back by the thread that wrote them), which bounds every
//     part of shared memory whatever d and hd are. It keeps the narrow
//     route's exchange, flags, epoch, clock-bounded wait and fixed-order sums
//     (bit-identical reruns) and keeps nothing in registers across steps:
//     simple first. At 1.3B's prefill shape (8, 2048, d 2048, H 4) the
//     products are 137.4 GFLOP each way, 2.05 ms at the FP32 rate; on an
//     NVIDIA H100 80GB HBM3 at 700.00 W the kernels take 16.75 ms forward
//     and 17.29 ms backward, 8.2 and 8.4 us a step, 12% of that bound
//     (PERF.md), not yet made fast.
//
// Nothing is refused for its width. The library refuses a malformed shape (d
// not a positive multiple of H: kMalformed; the wrapper refuses it first) and,
// as a guard no width reaches on an H100, a grid the card cannot hold at once
// (kNotResident), never run in part.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;   // batch rows a pass
constexpr int kFeat = 8;   // features a block: 4 gates x 8 = 32 columns
constexpr int kGate = kRows * kFeat;  // gate threads: one a (row, feature)
constexpr int kRing = 8;   // steps of step-independent operands in shared memory
constexpr int kLd = 8;     // 16-byte loads a thread issues at once
constexpr int kPad = 256;  // zeros after a staged tile: the products' reads past a head
constexpr int kSlots = 3;  // exchange slots, reused every third step
constexpr int kMaxBlocks = kThreads;  // flags in the sync state, one reader thread each
constexpr int kFlagStride = 16;  // 64-bit words from one flag to the next: a 128-byte line each

typedef unsigned long long u64;

// Error codes returned (beside CUDA's own): the card cannot hold every block
// of the launch at once; d is not a positive multiple of H.
constexpr int kNotResident = 10001;
constexpr int kMalformed = 10003;

// Clock cycles a block waits for a flag before it stops the kernel (~10 s at
// 1.7 GHz): a grid that is not all resident fails instead of hanging.
constexpr long long kBarrierPatience = 1LL << 34;

struct FwdArgs {
  const float* xwb;
  const float* r;
  const float* h0;
  const float* c0;
  const float* n0;
  const float* m0;
  float* hs;
  float* cs;
  float* ns;
  float* ms;
  float* pre;
  float* xbuf;     // [kSlots][blocks][kRows][kFeat]: h_t by block
  u64* sync;       // [0] the launch epoch, [kFlagStride (1 + p)] block p's flag
  int B, S, d, H, save;
};

struct BwdArgs {
  const float* r;
  const float* pre;
  const float* cs;
  const float* ns;
  const float* ms;
  const float* c0;
  const float* n0;
  const float* m0;
  const float* dhs;
  const float* dcT;
  const float* dnT;
  const float* dmT;
  float* dpre;
  float* dh0;
  float* dc0;
  float* dn0;
  float* dm0;
  float* xbuf;  // [kSlots][4 gates][blocks][kRows][kFeat]: dpre_t by gate and block
  u64* sync;
  int B, S, d, H, span;
};

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ void st_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
// The gate threads (warps 0 and 1) meet, without the other warps.
__device__ __forceinline__ void gate_threads_meet() {
  asm volatile("bar.sync 1, %0;" ::"n"(kGate) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Waits until at most kRing - 2 of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kRing - 2) : "memory");
}

// Copies `pieces` pieces of the exchange buffer (a piece: the 8 rows x 8
// columns one block wrote, 64 floats, row by row) from `src` into the staged
// tile `dst`: piece k's row b goes to dst[b * stride + 8 k ...]. Every load
// of a round is issued before the first store.
__device__ __forceinline__ void fetch_pieces(float* dst, int stride, const float* src,
                                             int pieces, int tid) {
  const int n4 = pieces * 16;  // float4 a piece: row (i / 2) % 8, half i % 2
  for (int r0 = 0; r0 < n4; r0 += kLd * kThreads) {
    float4 v[kLd];
#pragma unroll
    for (int k = 0; k < kLd; ++k) {
      const int i = r0 + k * kThreads + tid;
      if (i < n4) v[k] = __ldcg(reinterpret_cast<const float4*>(src) + i);
    }
#pragma unroll
    for (int k = 0; k < kLd; ++k) {
      const int i = r0 + k * kThreads + tid;
      float* row_part = dst + ((i >> 1) & 7) * stride + (i >> 4) * kFeat + (i & 1) * 4;
      if (i < n4) *reinterpret_cast<float4*>(row_part) = v[k];
    }
  }
}

// Publishes this block's slice: every gate thread has stored its part of
// the exchange buffer; one release store of the flag after they meet.
__device__ __forceinline__ void publish(u64* flag, u64 value, int tid) {
  gate_threads_meet();
  if (tid == 0) st_release(flag, value);
}

// Waits until every block's flag has reached `want`, then the block meets:
// thread p polls block p's flag with relaxed loads and reads it once more
// with an acquire load when it has (lighter than an acquire a poll).
__device__ __forceinline__ void wait_flags(const u64* flags, u64 want, int tid) {
  if (tid < (int)gridDim.x) {
    const u64* flag = flags + tid * kFlagStride;
    const long long start = clock64();
    while (ld_relaxed(flag) < want) {
      if (clock64() - start > kBarrierPatience) __trap();
    }
    (void)ld_acquire(flag);
  }
  __syncthreads();
}

// One level of reduce_scatter: lanes with bit W keep the upper W values,
// the others the lower, each adding its partner's copy of what it keeps.
template <int W>
__device__ __forceinline__ void butterfly(float (&v)[32], int lane) {
  const bool up = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float keep = up ? v[i + W] : v[i];
    const float send = up ? v[i] : v[i + W];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// Sums v over the warp's 32 lanes, a butterfly reduce-scatter in a fixed
// order: lane l returns the total of v[l].
__device__ __forceinline__ float reduce_scatter(float (&v)[32], int lane) {
  butterfly<16>(v, lane);
  butterfly<8>(v, lane);
  butterfly<4>(v, lane);
  butterfly<2>(v, lane);
  butterfly<1>(v, lane);
  return v[0];
}

// The warp's products for 8 rows x 4 columns: acc[row * 4 + c] = sum over i
// of x[row * stride + off[c] + 32 i] * rr[c][i] (x is the lane's first
// element). No branch: entries of r past the head are 0, and what they meet
// past the head is finite (the next head, or the zeroed pad). kSame: the four
// offsets are equal, so one load serves the four columns. Each sum adds its
// terms in the order of i; the loads of one i may not move above the i
// before (the empty asm), which keeps 8 rows' operands in registers at a
// time beside r's and the sums.
template <int kKs, bool kSame>
__device__ __forceinline__ void products(const float* x, int stride, const int (&off)[4],
                                         const float (&rr)[4][kKs], float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKs; ++i) {
#pragma unroll
    for (int row = 0; row < kRows; ++row) {
      const float* xr = x + row * stride + 32 * i;
      if (kSame) {
        const float xv = xr[off[0]];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[row * 4 + c] = fmaf(xv, rr[c][i], acc[row * 4 + c]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[row * 4 + c] = fmaf(xr[off[c]], rr[c][i], acc[row * 4 + c]);
      }
    }
    asm volatile("" ::: "memory");
  }
}

// The summed products of the warp's (row, column) for lane l = row * 4 +
// column.
template <int kKs>
__device__ __forceinline__ float warp_products(const float* x_s, int stride, const int (&off)[4],
                                               bool same, const float (&rr)[4][kKs], int lane) {
  float acc[32];
  if (same)
    products<kKs, true>(x_s + lane, stride, off, rr, acc);
  else
    products<kKs, false>(x_s + lane, stride, off, rr, acc);
  return reduce_scatter(acc, lane);
}

// The row stride of a staged tile of n columns: n rounded up to 8 more than
// a multiple of 32 floats, so that the 16-byte stores of 8 lanes to 4 rows x
// 2 halves of 8 columns fall on 8 different 16-byte bank groups (a stride of
// a multiple of 32 puts all 8 rows on the same banks).
__host__ __device__ __forceinline__ int tile_stride(int n) { return n + (40 - n % 32) % 32; }

// Zeroes n floats of shared memory (then the block meets).
__device__ __forceinline__ void zero_shared(float* p, int n, int tid) {
  for (int i = tid; i < n; i += kThreads) p[i] = 0.f;
  __syncthreads();
}

// As PyTorch's CUDA log_sigmoid and sigmoid.
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// kMin: the blocks an SM the instance is compiled for (launch bounds).
template <int kKs, int kMin>
__global__ void __launch_bounds__(kThreads, kMin) slstm_forward_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, S = a.S, d = a.d, hd = d / a.H, G = 4 * hd;
  const int P = gridDim.x, p = blockIdx.x, jlo = p * kFeat, dp = tile_stride(P * kFeat);
  float* h_s = smem;                          // [kRows][dp] + kPad: h_{t-1}
  float* pre_s = h_s + kRows * dp + kPad;     // [kRows][32]: the recurrent sums
  float* ring = pre_s + kRows * 32;           // [kRing][kRows][32]: xwb
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  zero_shared(h_s, kRows * dp + kPad, tid);

  // warp w: gate q = w / 2, features 4 (w % 2) + c; its columns of r
  const int q = warp >> 1, fq = warp & 1;
  float rr[4][kKs];
  int off[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = jlo + 4 * fq + c, col = q * d + j, head = col / G, e = col - head * G;
    off[c] = j < d ? head * hd : -1;
#pragma unroll
    for (int i = 0; i < kKs; ++i) {
      const int k = lane + 32 * i;
      rr[c][i] = (j < d && k < hd) ? a.r[((size_t)head * hd + k) * G + e] : 0.f;
    }
  }
#pragma unroll
  for (int c = 1; c < 4; ++c) off[c] = off[c] < 0 ? off[0] : off[c];  // r is 0 there
  if (off[0] < 0) off[0] = off[1] = off[2] = off[3] = 0;
  const bool same = off[1] == off[0] && off[2] == off[0] && off[3] == off[0];

  const u64 base = ld_relaxed(a.sync);
  u64* flags = a.sync + kFlagStride;
  const int npass = (B + kRows - 1) / kRows, nseq = npass * S;
  const size_t slot_floats = (size_t)P * kGate;

  // the ring: thread tid copies xwb of (row tid / 32, gate tid / 8 % 4,
  // feature tid % 8), step by step from the first
  const int f_row = tid >> 5, f_col = ((tid >> 3) & 3) * d + jlo + (tid & 7);
  const bool f_in = jlo + (tid & 7) < d;
  int f_pp = 0, f_t = 0, f_slot = 0;
  auto fill = [&]() {
    if (f_pp < npass) {
      const int b = f_pp * kRows + f_row;
      if (b < B && f_in)
        cp_async4(ring + f_slot * (kRows * 32) + tid,
                  a.xwb + ((size_t)b * S + f_t) * 4 * d + f_col);
      if (++f_t == S) f_t = 0, ++f_pp;
    }
    cp_async_commit();
    f_slot = f_slot + 1 == kRing ? 0 : f_slot + 1;
  };
  for (int i = 0; i < kRing - 2; ++i) fill();

  // the gate thread's (row, feature) and its state
  const int grow = tid >> 3, gf = tid & 7, gj = jlo + gf;
  float c = 0.f, n = 0.f, m = 0.f;

  int pp = 0, t = 0, slot = 0, xslot = 0;
  for (int it = 0; it < nseq; ++it) {
    const int b0 = pp * kRows, gb = b0 + grow;
    const bool gate = tid < kGate && gb < B && gj < d;
    // the operands of step it + kRing - 2 start on their way while the block
    // waits (its slot was read in step it - 2)
    fill();
    // h_{t-1} of the pass's rows into h_s
    if (t == 0) {
      for (int i = tid; i < kRows * d; i += kThreads) {
        const int row = i / d, x = i - row * d;
        if (b0 + row < B) h_s[row * dp + x] = a.h0[(size_t)(b0 + row) * d + x];
      }
      if (gate) {
        const size_t bj = (size_t)gb * d + gj;
        c = a.c0[bj];
        n = a.n0[bj];
        m = a.m0[bj];
      }
    } else {
      wait_flags(flags, base + it, tid);  // step it - 1 published
      // block p' wrote its 8 features' rows at piece p'
      fetch_pieces(h_s, dp, a.xbuf + (size_t)(xslot == 0 ? kSlots - 1 : xslot - 1) * slot_floats,
                   P, tid);
    }
    __syncthreads();
    pre_s[(lane >> 2) * 32 + q * kFeat + 4 * fq + (lane & 3)] =
        warp_products<kKs>(h_s, dp, off, same, rr, lane);
    cp_async_wait_ring();
    __syncthreads();
    if (tid < kGate) {
      float h = 0.f, pv[4];  // h_t and the step's pre-activations
      if (gate) {
        const float* x = ring + slot * (kRows * 32) + grow * 32 + gf;
        const float* pr = pre_s + grow * 32 + gf;
        const float ip = x[0] + pr[0], fp = x[kFeat] + pr[kFeat];
        const float zp = x[2 * kFeat] + pr[2 * kFeat], op = x[3 * kFeat] + pr[3 * kFeat];
        const float lfm = __fadd_rn(log_sigmoid(fp), m);
        const float mn = fmaxf(lfm, ip);
        const float ig = expf(__fsub_rn(ip, mn));
        const float fg = expf(__fsub_rn(lfm, mn));
        const float zg = tanhf(zp);
        const float og = sigmoid(op);
        c = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, zg));
        n = __fadd_rn(__fmul_rn(fg, n), ig);
        m = mn;
        h = __fdiv_rn(__fmul_rn(og, c), fmaxf(n, 1.f));
        pv[0] = ip;
        pv[1] = fp;
        pv[2] = zp;
        pv[3] = op;
      }
      // the next step reads h_t (0 where no row or feature is); the pass's
      // last is read by nobody
      if (t + 1 < S) {
        a.xbuf[(size_t)xslot * slot_floats + (size_t)p * kGate + tid] = h;
        publish(flags + p * kFlagStride, base + it + 1, tid);
      }
      // the outputs, which nobody on the chain waits for
      if (gate) {
        const size_t at = ((size_t)gb * S + t) * d + gj;
        a.hs[at] = h;
        if (a.save) {
          a.cs[at] = c;
          a.ns[at] = n;
          a.ms[at] = m;
          float* pa = a.pre + ((size_t)gb * S + t) * 4 * d + gj;
#pragma unroll
          for (int k = 0; k < 4; ++k) pa[k * d] = pv[k];
        } else if (t == S - 1) {
          const size_t bj = (size_t)gb * d + gj;
          a.cs[bj] = c;
          a.ns[bj] = n;
          a.ms[bj] = m;
        }
      }
    }
    if (++t == S) t = 0, ++pp;
    slot = slot + 1 == kRing ? 0 : slot + 1;
    xslot = xslot + 1 == kSlots ? 0 : xslot + 1;
  }
  if (p == 0 && tid == 0) st_relaxed(a.sync, base + nseq + 1);
}

template <int kKs, int kMin>
__global__ void __launch_bounds__(kThreads, kMin) slstm_backward_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, S = a.S, d = a.d, hd = d / a.H, G = 4 * hd;
  const int P = gridDim.x, p = blockIdx.x, jlo = p * kFeat, klo = jlo / hd;
  const int width = min(a.span * G, 4 * d - klo * G);  // the group's heads of dpre_{t+1}
  const int sw = tile_stride(a.span * G);
  float* dp_s = smem;                        // [kRows][sw] + kPad: the group's heads of dpre_{t+1}
  float* part_s = dp_s + kRows * sw + kPad;  // [4][kRows][kFeat]: the quarters' sums
  float* ring = part_s + 4 * kGate;          // [kRing][8][kRows][kFeat]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  zero_shared(dp_s, kRows * sw + kPad, tid);

  // warp w: features 4 (w / 4) + c, the quarter w % 4 of their head's 4 hd
  // columns; dh[:, j] = dpre_{t+1}[:, head k's columns] . r[k, j % hd, :]
  const int fq = warp >> 2, wq = warp & 3;
  float rr[4][kKs];
  int off[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = jlo + 4 * fq + c, kh = j / hd, kp = j - kh * hd;
    off[c] = j < d ? (kh - klo) * G + wq * hd : -1;
#pragma unroll
    for (int i = 0; i < kKs; ++i) {
      const int e = lane + 32 * i;
      rr[c][i] = (j < d && e < hd) ? a.r[((size_t)kh * hd + kp) * G + wq * hd + e] : 0.f;
    }
  }
#pragma unroll
  for (int c = 1; c < 4; ++c) off[c] = off[c] < 0 ? off[0] : off[c];
  if (off[0] < 0) off[0] = off[1] = off[2] = off[3] = 0;
  const bool same = off[1] == off[0] && off[2] == off[0] && off[3] == off[0];

  const u64 base = ld_relaxed(a.sync);
  u64* flags = a.sync + kFlagStride;
  const int npass = (B + kRows - 1) / kRows, nseq = npass * (S + 1);
  const size_t slot_floats = (size_t)4 * P * kGate;
  // whole pieces: column c of the 4d lies in piece c / 8 (gate q's pieces in
  // block order, one gate after the other), and the staged columns start on
  // a piece and fill whole ones
  const bool whole = d % kFeat == 0 && klo * G % kFeat == 0 && width % kFeat == 0;

  // the ring: 8 operands of (row, feature) a step: pre's four gates, c, n, m
  // at t - 1 and dhs_t; thread tid copies elements tid and tid + 256, step
  // by step from the last; the step -1 after each pass copies nothing
  int f_pp = 0, f_t = S - 1, f_slot = 0;
  auto fill = [&]() {
    if (f_pp < npass && f_t >= 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = tid + h * kThreads, op = e >> 6;
        const int b = f_pp * kRows + ((e >> 3) & 7), j = jlo + (e & 7);
        if (b < B && j < d) {
          const float* src;
          if (op < 4) {
            src = a.pre + ((size_t)b * S + f_t) * 4 * d + op * d + j;
          } else if (op < 7) {
            const float* prev = op == 4 ? a.cs : op == 5 ? a.ns : a.ms;
            const float* init = op == 4 ? a.c0 : op == 5 ? a.n0 : a.m0;
            src = f_t ? prev + ((size_t)b * S + f_t - 1) * d + j : init + (size_t)b * d + j;
          } else {
            src = a.dhs + ((size_t)b * S + f_t) * d + j;
          }
          cp_async4(ring + f_slot * (8 * kGate) + e, src);
        }
      }
    }
    if (f_pp < npass && --f_t < -1) f_t = S - 1, ++f_pp;
    cp_async_commit();
    f_slot = f_slot + 1 == kRing ? 0 : f_slot + 1;
  };
  for (int i = 0; i < kRing - 2; ++i) fill();

  const int grow = tid >> 3, gf = tid & 7, gj = jlo + gf;
  float dc = 0.f, dn = 0.f, dm = 0.f, ct = 0.f, nt = 0.f;

  int pp = 0, t = S - 1, slot = 0, xslot = 0;
  for (int it = 0; it < nseq; ++it) {
    const int b0 = pp * kRows, gb = b0 + grow;
    const bool gate = tid < kGate && gb < B && gj < d;
    const bool rec = t + 1 < S;  // h_t's gradient through dpre_{t+1}
    fill();  // as the forward's
    if (rec) {
      wait_flags(flags, base + it, tid);  // step it - 1 published
      // columns klo G + x of the 8 rows: column q d + j of row b lies in
      // the piece of gate q and block j / 8, at [b][j % 8]
      const float* src = a.xbuf + (size_t)(xslot == 0 ? kSlots - 1 : xslot - 1) * slot_floats;
      if (whole) {
        fetch_pieces(dp_s, sw, src + (size_t)(klo * G / kFeat) * kGate, width / kFeat, tid);
      } else {
        for (int i = tid; i < kRows * width; i += kThreads) {
          const int row = i / width, x = i - row * width;
          const int col = klo * G + x, gq = col / d, j = col - gq * d;
          dp_s[row * sw + x] = __ldcg(src + ((size_t)(gq * P + j / kFeat) * kRows + row) * kFeat +
                                      j % kFeat);
        }
      }
    } else if (gate) {
      const size_t bj = (size_t)gb * d + gj, at = ((size_t)gb * S + S - 1) * d + gj;
      dc = a.dcT[bj];
      dn = a.dnT[bj];
      dm = a.dmT[bj];
      ct = a.cs[at];
      nt = a.ns[at];
    }
    __syncthreads();
    if (rec)
      part_s[wq * kGate + (lane >> 2) * kFeat + 4 * fq + (lane & 3)] =
          warp_products<kKs>(dp_s, sw, off, same, rr, lane);
    cp_async_wait_ring();
    __syncthreads();
    if (tid < kGate) {
      float g[4] = {0.f, 0.f, 0.f, 0.f};  // dpre_t of (row, feature), gate by gate
      float ghr = 0.f;
      if (gate && rec) {
        ghr = part_s[tid];
#pragma unroll
        for (int w = 1; w < 4; ++w) ghr += part_s[w * kGate + tid];
      }
      if (gate && t >= 0) {
        const float* x = ring + slot * (8 * kGate) + tid;
        const float ip = x[0], fp = x[kGate], zp = x[2 * kGate], op = x[3 * kGate];
        const float cp = x[4 * kGate], np = x[5 * kGate], mp = x[6 * kGate];
        const float lfm = __fadd_rn(log_sigmoid(fp), mp);
        const float mt = fmaxf(lfm, ip);
        const float ig = expf(ip - mt), fg = expf(lfm - mt);
        const float zg = tanhf(zp), og = sigmoid(op);
        const float den = fmaxf(nt, 1.f);
        const float gh = x[7 * kGate] + ghr;
        const float dq = gh / den;
        // clamp_min(n, 1) passes the gradient at n == 1, as PyTorch's
        const float gc = dc + dq * og;
        const float gn = dn + (nt >= 1.f ? -gh * (og * ct) / (den * den) : 0.f);
        const float dfg = gc * cp + gn * np;
        const float dig = gc * zg + gn;
        const float ea = dig * ig, eb = dfg * fg;
        const float dmt = dm - ea - eb;
        // max(lfm, i) splits a tie half and half, as torch.maximum
        const float wl = lfm > ip ? 1.f : (lfm < ip ? 0.f : 0.5f);
        const float dlfm = eb + dmt * wl;
        const float z = expf(-fabsf(fp));  // sigmoid(-f), stably
        const float sneg = fp < 0.f ? 1.f / (1.f + z) : z / (1.f + z);
        g[0] = ea + dmt * (1.f - wl);
        g[1] = dlfm * sneg;
        g[2] = gc * ig * (1.f - zg * zg);
        g[3] = dq * ct * og * (1.f - og);
        dc = gc * fg;
        dn = gn * fg;
        dm = dlfm;
        ct = cp;
        nt = np;
      }
      // the next step (t - 1) reads dpre_t (0 where no row or feature is)
      if (t >= 0) {
        float* x = a.xbuf + (size_t)xslot * slot_floats + (size_t)p * kGate + tid;
#pragma unroll
        for (int k = 0; k < 4; ++k) x[(size_t)k * P * kGate] = g[k];
        publish(flags + p * kFlagStride, base + it + 1, tid);
      }
      // the outputs, which nobody on the chain waits for
      if (gate) {
        if (t >= 0) {
          float* dpa = a.dpre + ((size_t)gb * S + t) * 4 * d + gj;
#pragma unroll
          for (int k = 0; k < 4; ++k) dpa[k * d] = g[k];
        } else {
          const size_t bj = (size_t)gb * d + gj;
          a.dh0[bj] = ghr;
          a.dc0[bj] = dc;
          a.dn0[bj] = dn;
          a.dm0[bj] = dm;
        }
      }
    }
    if (--t < -1) t = S - 1, ++pp;
    slot = slot + 1 == kRing ? 0 : slot + 1;
    xslot = xslot + 1 == kSlots ? 0 : xslot + 1;
  }
  if (p == 0 && tid == 0) st_relaxed(a.sync, base + nseq + 1);
}

// ---------------------------------------------------------------------------
// The wide route (see the header): one block an SM, gpb groups of 8 features
// a block, r in shared memory and then device memory, the staged tile in
// chunks where it does not fit whole, the features in rounds of kRound.
// ---------------------------------------------------------------------------

constexpr int kRound = 32;  // features a round: 8 rows x 32 (row, feature) pairs, one a thread
constexpr int kWPad = 32;   // zeros after a staged chunk: the reads of lanes past its end

struct WideFwdArgs {
  FwdArgs a;
  float* rt;  // [blocks][gpb * 8 - rsm][4][hd]: the jobs' columns of r past rsm, transposed
  int gpb, chunk, rsm;  // groups a block, columns a staged chunk, jobs with r in shared memory
};

struct WideBwdArgs {
  BwdArgs a;
  int gpb, chunk, rsm;
};

// Adds to acc[row * 4 + c] the sum over k in [ka, kb) of x[row * stride + o
// + k] * rp[c][k] for the columns c in `sel` (a bit each): lane l takes k =
// ka + l + 32 i. A lane past kb, and a column not in sel, adds zeros: its r
// is not read, and the x it meets is finite (the chunk's zeroed pad, or the
// next row's). Each sum adds its terms in the order of i.
__device__ __forceinline__ void products_wide(const float* x, int stride, int o,
                                              const float* const (&rp)[4], int sel, int ka,
                                              int kb, float (&acc)[32], int lane) {
#pragma unroll 4
  for (int k0 = ka; k0 < kb; k0 += 32) {
    const int k = k0 + lane;
    const bool in = k < kb;
    float rv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) rv[c] = in && (sel >> c & 1) ? rp[c][k] : 0.f;
#pragma unroll
    for (int row = 0; row < kRows; ++row) {
      const float xv = x[row * stride + o + k];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[row * 4 + c] = fmaf(xv, rv[c], acc[row * 4 + c]);
    }
  }
}

// A job's sums over a staged chunk of `width` columns for the 8 rows x 4
// columns; lane l returns (row l / 4, column l % 4)'s. Column c exists where
// bit c of `valid` is set, its r is rp[c][0 .. hd) and the chunk holds its hd
// operands from offset off[c] (negative where they began in an earlier
// chunk); columns of one offset go in one pass, so a job whose 4 columns
// straddle two heads makes two.
__device__ __forceinline__ float job_products(const float* x_s, int stride, int width, int hd,
                                              const int (&off)[4], int valid,
                                              const float* const (&rp)[4], int lane) {
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  int done = 0;
#pragma unroll
  for (int c0 = 0; c0 < 4; ++c0) {
    if (!(valid >> c0 & 1) || (done >> c0 & 1)) continue;
    const int o = off[c0];
    int sel = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if ((valid >> c & 1) && off[c] == o) sel |= 1 << c;
    done |= sel;
    const int ka = max(0, -o), kb = min(hd, width - o);
    if (ka < kb) products_wide(x_s, stride, o, rp, sel, ka, kb, acc, lane);
  }
  return reduce_scatter(acc, lane);
}

// The forward on the wide route. Job jb of a block is gate jb % 4 of its
// features 4 (jb / 4) + c, c < 4; round rho its features [32 rho, 32 rho +
// 32), jobs of the same range.
__global__ void __launch_bounds__(kThreads, 1) slstm_forward_wide_kernel(WideFwdArgs w) {
  extern __shared__ __align__(16) float smem[];
  const FwdArgs& a = w.a;
  const int B = a.B, S = a.S, d = a.d, hd = d / a.H, G = 4 * hd;
  const int groups = (d + kFeat - 1) / kFeat, W = groups * kFeat;  // h in whole pieces
  const int F = w.gpb * kFeat, p = blockIdx.x, jlo = p * F, nglob = F - w.rsm;
  const int cs = tile_stride(w.chunk);
  float* x_s = smem;                        // [kRows][cs] + kWPad: a chunk of h_{t-1}
  float* pre_s = x_s + kRows * cs + kWPad;  // [kRows][4][kRound]: the round's recurrent sums
  float* r_s = pre_s + kRows * 4 * kRound;  // [rsm][4][hd]: the first jobs' columns of r
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  zero_shared(x_s, kRows * cs + kWPad, tid);

  // r's columns of the block's jobs, k contiguous: read along the columns
  // (gate-major, as they lie in r's rows), written into r_s or rt
  const long long ncol = 4LL * F;
  for (long long i = tid; i < ncol * hd; i += kThreads) {
    const int k = (int)(i / ncol), ci = (int)(i - k * ncol);
    const int q = ci / F, f = ci - q * F, j = jlo + f, jb = (f >> 2) * 4 + q, c = f & 3;
    float v = 0.f;
    if (j < d) {
      const int col = q * d + j, head = col / G;
      v = a.r[((size_t)head * hd + k) * G + col - head * G];
    }
    if (jb < w.rsm)
      r_s[((size_t)jb * 4 + c) * hd + k] = v;
    else
      w.rt[(((size_t)p * nglob + jb - w.rsm) * 4 + c) * hd + k] = v;
  }
  __syncthreads();

  const u64 base = ld_relaxed(a.sync);
  u64* flags = a.sync + kFlagStride;
  const int npass = (B + kRows - 1) / kRows, nseq = npass * S;
  const int nround = (F + kRound - 1) / kRound, nchunk = (W + w.chunk - 1) / w.chunk;
  const size_t slot_floats = (size_t)groups * kGate;

  int pp = 0, t = 0, xslot = 0;
  for (int it = 0; it < nseq; ++it) {
    const int b0 = pp * kRows;
    const float* prev = a.xbuf + (size_t)(xslot == 0 ? kSlots - 1 : xslot - 1) * slot_floats;
    for (int rho = 0; rho < nround; ++rho) {
      const int flo = rho * kRound, FR = min(kRound, F - flo);
      // the thread's (row, feature) of the round and what its step reads
      // that does not depend on the step before, on their way first
      const int grow = tid / FR, gf = tid - grow * FR, gb = b0 + grow, gj = jlo + flo + gf;
      const bool pair = tid < kRows * FR, gate = pair && gb < B && gj < d;
      float xv[4] = {0.f, 0.f, 0.f, 0.f}, c = 0.f, n = 0.f, m = 0.f;
      if (gate) {
        const float* xp = a.xwb + ((size_t)gb * S + t) * 4 * d + gj;
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = __ldg(xp + (size_t)q * d);
        // the state after step t - 1: this thread wrote it (c0.. at t == 0)
        const size_t at =
            t == 0 || !a.save ? (size_t)gb * d + gj : ((size_t)gb * S + t - 1) * d + gj;
        c = (t == 0 ? a.c0 : a.cs)[at];
        n = (t == 0 ? a.n0 : a.ns)[at];
        m = (t == 0 ? a.m0 : a.ms)[at];
      }
      if (rho == 0 && t > 0) wait_flags(flags, base + it, tid);  // step it - 1 published
      for (int ch = 0; ch < nchunk; ++ch) {
        const int x0 = ch * w.chunk, xw = min(w.chunk, W - x0);
        if (rho == 0 || nchunk > 1) {  // one chunk stays for the step's rounds
          __syncthreads();  // the last chunk's products are done
          if (t == 0) {
            for (int i = tid; i < kRows * xw; i += kThreads) {
              const int row = i / xw, x = i - row * xw;
              x_s[row * cs + x] = b0 + row < B && x0 + x < d
                                      ? a.h0[(size_t)(b0 + row) * d + x0 + x] : 0.f;
            }
          } else {
            // block p' wrote its groups' rows at their pieces
            fetch_pieces(x_s, cs, prev + (size_t)(x0 / kFeat) * kGate, xw / kFeat, tid);
          }
          __syncthreads();
        }
        for (int jb = flo + warp; jb < flo + FR; jb += kThreads / 32) {
          const int q = jb & 3, fq = jb >> 2;
          int off[4], valid = 0;
          const float* rp[4];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int j = jlo + 4 * fq + cc, head = (q * d + j) / G;
            off[cc] = head * hd - x0;
            if (j < d) valid |= 1 << cc;
            rp[cc] = jb < w.rsm ? r_s + ((size_t)jb * 4 + cc) * hd
                                : w.rt + (((size_t)p * nglob + jb - w.rsm) * 4 + cc) * hd;
          }
          const float v = job_products(x_s, cs, xw, hd, off, valid, rp, lane);
          float* dst = pre_s + ((lane >> 2) * 4 + q) * kRound + 4 * fq + (lane & 3) - flo;
          *dst = ch == 0 ? v : *dst + v;
        }
      }
      __syncthreads();
      if (pair) {
        float h = 0.f;
        if (gate) {
          const float* pr = pre_s + grow * 4 * kRound + gf;
          const float ip = xv[0] + pr[0], fp = xv[1] + pr[kRound];
          const float zp = xv[2] + pr[2 * kRound], op = xv[3] + pr[3 * kRound];
          const float lfm = __fadd_rn(log_sigmoid(fp), m);
          const float mn = fmaxf(lfm, ip);
          const float ig = expf(__fsub_rn(ip, mn));
          const float fg = expf(__fsub_rn(lfm, mn));
          const float zg = tanhf(zp);
          const float og = sigmoid(op);
          c = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, zg));
          n = __fadd_rn(__fmul_rn(fg, n), ig);
          m = mn;
          h = __fdiv_rn(__fmul_rn(og, c), fmaxf(n, 1.f));
          const size_t at = ((size_t)gb * S + t) * d + gj;
          a.hs[at] = h;
          if (a.save) {
            a.cs[at] = c;
            a.ns[at] = n;
            a.ms[at] = m;
            float* pa = a.pre + ((size_t)gb * S + t) * 4 * d + gj;
            pa[0] = ip;
            pa[d] = fp;
            pa[2 * d] = zp;
            pa[3 * d] = op;
          } else {  // the carried state, the final one after the last step
            const size_t bj = (size_t)gb * d + gj;
            a.cs[bj] = c;
            a.ns[bj] = n;
            a.ms[bj] = m;
          }
        }
        // the next step reads h_t (0 where no row or feature is)
        if (t + 1 < S && gj < W)
          a.xbuf[(size_t)xslot * slot_floats + (size_t)(gj / kFeat) * kGate + grow * kFeat +
                 (gj & 7)] = h;
      }
      if (rho + 1 < nround) __syncthreads();  // pre_s read before the next round writes it
    }
    if (t + 1 < S) {  // every thread's part stored: one release of the flag
      __syncthreads();
      if (tid == 0) st_release(flags + p * kFlagStride, base + it + 1);
    }
    if (++t == S) t = 0, ++pp;
    xslot = xslot + 1 == kSlots ? 0 : xslot + 1;
  }
  if (p == 0 && tid == 0) st_relaxed(a.sync, base + nseq + 1);
}

// The backward on the wide route. Job jb of a block is the quarter jb % 4 of
// the head columns of its features 4 (jb / 4) + c, c < 4; the staged tile
// holds the block's heads [klo, khi] of dpre_{t+1}, chunk by chunk.
__global__ void __launch_bounds__(kThreads, 1) slstm_backward_wide_kernel(WideBwdArgs w) {
  extern __shared__ __align__(16) float smem[];
  const BwdArgs& a = w.a;
  const int B = a.B, S = a.S, d = a.d, hd = d / a.H, G = 4 * hd;
  const int groups = (d + kFeat - 1) / kFeat, W = groups * kFeat;
  const int F = w.gpb * kFeat, p = blockIdx.x, jlo = p * F;
  const int klo = jlo / hd, width = ((min(jlo + F, d) - 1) / hd - klo + 1) * G;
  const int cs = tile_stride(w.chunk);
  float* x_s = smem;                         // [kRows][cs] + kWPad: a chunk of dpre_{t+1}'s heads
  float* part_s = x_s + kRows * cs + kWPad;  // [4][kRows][kRound]: the quarters' sums
  float* r_s = part_s + 4 * kRows * kRound;  // [rsm][4][hd]: the first jobs' rows of r
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  zero_shared(x_s, kRows * cs + kWPad, tid);

  // r's rows (feature j's row is r's (d, 4 hd) row j) of the first jobs
  for (long long i = tid; i < 4LL * w.rsm * hd; i += kThreads) {
    const int jc = (int)(i / hd), e = (int)(i - (long long)jc * hd), jb = jc >> 2;
    const int j = jlo + 4 * (jb >> 2) + (jc & 3);
    r_s[i] = j < d ? a.r[(size_t)j * G + (jb & 3) * hd + e] : 0.f;
  }
  __syncthreads();

  const u64 base = ld_relaxed(a.sync);
  u64* flags = a.sync + kFlagStride;
  const int npass = (B + kRows - 1) / kRows, nseq = npass * (S + 1);
  const int nround = (F + kRound - 1) / kRound, nchunk = (width + w.chunk - 1) / w.chunk;
  const size_t slot_floats = (size_t)4 * groups * kGate;
  // column c of the 4d lies in piece c / 8 where d fills whole pieces
  const bool aligned = d % kFeat == 0 && klo * G % kFeat == 0;

  int pp = 0, t = S - 1, xslot = 0;
  for (int it = 0; it < nseq; ++it) {
    const int b0 = pp * kRows;
    const bool rec = t + 1 < S;  // h_t's gradient through dpre_{t+1}
    const float* prev = a.xbuf + (size_t)(xslot == 0 ? kSlots - 1 : xslot - 1) * slot_floats;
    for (int rho = 0; rho < nround; ++rho) {
      const int flo = rho * kRound, FR = min(kRound, F - flo);
      const int grow = tid / FR, gf = tid - grow * FR, gb = b0 + grow, gj = jlo + flo + gf;
      const bool pair = tid < kRows * FR, gate = pair && gb < B && gj < d;
      // the pair's operands: pre's four gates, c, n, m at t - 1, dhs_t; c_t,
      // n_t; the carried dc, dn, dm (this thread wrote them, in dc0.. after
      // the first step)
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float ct = 0.f, nt = 0.f, dc = 0.f, dn = 0.f, dm = 0.f;
      if (gate && t >= 0) {
        const size_t bt = (size_t)gb * S + t, bj = (size_t)gb * d + gj;
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = __ldg(a.pre + bt * 4 * d + (size_t)q * d + gj);
        const size_t at = t ? (bt - 1) * d + gj : bj;
        x[4] = __ldg((t ? a.cs : a.c0) + at);
        x[5] = __ldg((t ? a.ns : a.n0) + at);
        x[6] = __ldg((t ? a.ms : a.m0) + at);
        x[7] = __ldg(a.dhs + bt * d + gj);
        ct = __ldg(a.cs + bt * d + gj);
        nt = __ldg(a.ns + bt * d + gj);
        const bool last = t == S - 1;
        dc = (last ? a.dcT : a.dc0)[bj];
        dn = (last ? a.dnT : a.dn0)[bj];
        dm = (last ? a.dmT : a.dm0)[bj];
      }
      if (rho == 0 && rec) wait_flags(flags, base + it, tid);  // step it - 1 published
      if (rec) {
        for (int ch = 0; ch < nchunk; ++ch) {
          const int x0 = ch * w.chunk, xw = min(w.chunk, width - x0);
          if (rho == 0 || nchunk > 1) {
            __syncthreads();
            // columns klo G + x0 + x of the 8 rows: column q d + j of row b
            // lies in the piece of gate q and group j / 8, at [b][j % 8]
            if (aligned && xw % kFeat == 0) {
              fetch_pieces(x_s, cs, prev + (size_t)((klo * G + x0) / kFeat) * kGate, xw / kFeat,
                           tid);
            } else {
              for (int i = tid; i < kRows * xw; i += kThreads) {
                const int row = i / xw, x = i - row * xw;
                const int col = klo * G + x0 + x, gq = col / d, j = col - gq * d;
                x_s[row * cs + x] = __ldcg(
                    prev + ((size_t)(gq * groups + j / kFeat) * kRows + row) * kFeat + j % kFeat);
              }
            }
            __syncthreads();
          }
          for (int jb = flo + warp; jb < flo + FR; jb += kThreads / 32) {
            const int wq = jb & 3, fq = jb >> 2;
            int off[4], valid = 0;
            const float* rp[4];
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int j = jlo + 4 * fq + cc;
              off[cc] = (j / hd - klo) * G + wq * hd - x0;
              if (j < d) valid |= 1 << cc;
              rp[cc] = jb < w.rsm ? r_s + ((size_t)jb * 4 + cc) * hd
                                  : a.r + (size_t)j * G + wq * hd;
            }
            const float v = job_products(x_s, cs, xw, hd, off, valid, rp, lane);
            float* dst = part_s + (wq * kRows + (lane >> 2)) * kRound + 4 * fq + (lane & 3) - flo;
            *dst = ch == 0 ? v : *dst + v;
          }
        }
      }
      __syncthreads();
      if (pair) {
        float g[4] = {0.f, 0.f, 0.f, 0.f};  // dpre_t of (row, feature), gate by gate
        float ghr = 0.f;
        if (gate && rec) {
          ghr = part_s[grow * kRound + gf];
#pragma unroll
          for (int q = 1; q < 4; ++q) ghr += part_s[(q * kRows + grow) * kRound + gf];
        }
        if (gate && t >= 0) {
          const float ip = x[0], fp = x[1], zp = x[2], op = x[3];
          const float cp = x[4], np = x[5], mp = x[6];
          const float lfm = __fadd_rn(log_sigmoid(fp), mp);
          const float mt = fmaxf(lfm, ip);
          const float ig = expf(ip - mt), fg = expf(lfm - mt);
          const float zg = tanhf(zp), og = sigmoid(op);
          const float den = fmaxf(nt, 1.f);
          const float gh = x[7] + ghr;
          const float dq = gh / den;
          // clamp_min(n, 1) passes the gradient at n == 1, as PyTorch's
          const float gc = dc + dq * og;
          const float gn = dn + (nt >= 1.f ? -gh * (og * ct) / (den * den) : 0.f);
          const float dfg = gc * cp + gn * np;
          const float dig = gc * zg + gn;
          const float ea = dig * ig, eb = dfg * fg;
          const float dmt = dm - ea - eb;
          // max(lfm, i) splits a tie half and half, as torch.maximum
          const float wl = lfm > ip ? 1.f : (lfm < ip ? 0.f : 0.5f);
          const float dlfm = eb + dmt * wl;
          const float z = expf(-fabsf(fp));  // sigmoid(-f), stably
          const float sneg = fp < 0.f ? 1.f / (1.f + z) : z / (1.f + z);
          g[0] = ea + dmt * (1.f - wl);
          g[1] = dlfm * sneg;
          g[2] = gc * ig * (1.f - zg * zg);
          g[3] = dq * ct * og * (1.f - og);
          dc = gc * fg;
          dn = gn * fg;
          dm = dlfm;
        }
        // the next step (t - 1) reads dpre_t (0 where no row or feature is)
        if (t >= 0 && gj < W) {
          float* xo = a.xbuf + (size_t)xslot * slot_floats + (size_t)(gj / kFeat) * kGate +
                      grow * kFeat + (gj & 7);
#pragma unroll
          for (int q = 0; q < 4; ++q) xo[(size_t)q * groups * kGate] = g[q];
        }
        if (gate) {
          const size_t bj = (size_t)gb * d + gj;
          if (t >= 0) {
            float* dpa = a.dpre + ((size_t)gb * S + t) * 4 * d + gj;
#pragma unroll
            for (int q = 0; q < 4; ++q) dpa[(size_t)q * d] = g[q];
            a.dc0[bj] = dc;  // carried; after step 0, the initial state's gradient
            a.dn0[bj] = dn;
            a.dm0[bj] = dm;
          } else {
            a.dh0[bj] = ghr;
          }
        }
      }
      if (rho + 1 < nround) __syncthreads();  // part_s read before the next round writes it
    }
    if (t >= 0) {
      __syncthreads();
      if (tid == 0) st_release(flags + p * kFlagStride, base + it + 1);
    }
    if (--t < -1) t = S - 1, ++pp;
    xslot = xslot + 1 == kSlots ? 0 : xslot + 1;
  }
  if (p == 0 && tid == 0) st_relaxed(a.sync, base + nseq + 1);
}

// The instance for a head of hd: registers for ceil(hd / 32) of r's entries a
// column and lane, rounded up to a power of two (hd <= 256; else none).
template <typename Args>
void (*kernel_for(int hd, void (*k1)(Args), void (*k2)(Args), void (*k4)(Args),
                  void (*k8)(Args)))(Args) {
  return hd <= 32 ? k1 : hd <= 64 ? k2 : hd <= 128 ? k4 : hd <= 256 ? k8 : nullptr;
}

template <int kMin>
void (*forward_for(int hd))(FwdArgs) {
  return kernel_for<FwdArgs>(hd, slstm_forward_kernel<1, kMin>, slstm_forward_kernel<2, kMin>,
                             slstm_forward_kernel<4, kMin>, slstm_forward_kernel<8, kMin>);
}

template <int kMin>
void (*backward_for(int hd))(BwdArgs) {
  return kernel_for<BwdArgs>(hd, slstm_backward_kernel<1, kMin>, slstm_backward_kernel<2, kMin>,
                             slstm_backward_kernel<4, kMin>, slstm_backward_kernel<8, kMin>);
}

// Shared memory on Hopper: what one block may have (227 KB), an SM's (228
// KB), and the share of it the system keeps for each resident block.
constexpr long long kSmemBlock = 232448;
constexpr long long kSmemSM = 233472;
constexpr long long kSmemReserved = 1024;

enum Route { kNarrow = 0, kWide = 1 };

// What a launch of (d, H) one way runs on a card of nsm SMs (slstm_plan gives
// it out in this order): the route; the narrow route's instance (kKs, the
// registers of r a column and lane; blocks an SM); the grid and the groups of
// 8 features a block; the most heads a block's features touch; the wide
// route's staged chunk (columns) and chunks a step, its jobs whose r lives in
// shared memory; the dynamic shared memory (bytes); the floats of device
// memory after the exchange buffer (the forward's transposed r past rsm).
struct Plan {
  long long code, route, kks, per_sm, grid, gpb, span, chunk, nchunk, rsm, smem, scratch;
};
constexpr int kPlanFields = 12;

// A staged tile of 8 rows of n columns and its pad, in bytes (the wide route).
long long tile_bytes(long long n) { return 4 * (kRows * (long long)tile_stride((int)n) + kWPad); }

// The narrow route where its instances take the head and the card holds one
// block a group (one an SM, else two an SM up to twice the SMs); else the
// wide route, which takes every shape.
Plan plan_for(int d, int H, int nsm, int backward) {
  Plan pl{};
  if (d < 1 || H < 1 || d % H || nsm < 1) {
    pl.code = kMalformed;
    return pl;
  }
  const int hd = d / H, G = 4 * hd, groups = (d + kFeat - 1) / kFeat;
  if (hd <= 256 && groups <= kMaxBlocks) {
    int span = 1;  // the most heads a group of 8 features touches
    for (int g = 0; g < groups; ++g) {
      const int lo = g * kFeat, hi = (lo + kFeat < d ? lo + kFeat : d) - 1;
      if (hi / hd - lo / hd + 1 > span) span = hi / hd - lo / hd + 1;
    }
    const long long smem =
        backward ? 4LL * (kRows * tile_stride(span * G) + kPad + 4 * kGate + kRing * 8 * kGate)
                 : 4LL * (kRows * tile_stride(groups * kFeat) + kPad + kRows * 32 +
                          kRing * kRows * 32);
    const int per_sm = groups <= nsm ? 1
                       : groups <= 2 * nsm && 2 * (smem + kSmemReserved) <= kSmemSM ? 2 : 0;
    if (per_sm) {
      const int kks = hd <= 32 ? 1 : hd <= 64 ? 2 : hd <= 128 ? 4 : 8;
      pl = {0, kNarrow, kks, per_sm, groups, 1, span, 0, 0, 0, smem, 0};
      return pl;
    }
  }
  const int cap = nsm < kMaxBlocks ? nsm : kMaxBlocks;
  const int gpb = (groups + cap - 1) / cap, F = gpb * kFeat, grid = (groups + gpb - 1) / gpb;
  int span = 1;  // the most heads a block's features touch
  for (int p = 0; p < grid; ++p) {
    const int lo = p * F, hi = (lo + F < d ? lo + F : d) - 1;
    if (hi / hd - lo / hd + 1 > span) span = hi / hd - lo / hd + 1;
  }
  // the staged tile: all of h forward, the block's heads of dpre backward;
  // whole where it fits beside the round's sums, else the widest chunk
  const long long width = backward ? (long long)span * G : (long long)groups * kFeat;
  const long long sums = 4LL * kRows * 4 * kRound;
  long long chunk = width;
  if (sums + tile_bytes(width) > kSmemBlock) {
    chunk = ((kSmemBlock - sums) / 4 - kWPad) / kRows - 40;
    chunk -= chunk % kFeat;
    while (sums + tile_bytes(chunk) > kSmemBlock) chunk -= kFeat;
  }
  // r's jobs (4 columns of hd each) in what is left
  const long long fit = (kSmemBlock - sums - tile_bytes(chunk)) / (16LL * hd);
  const long long rsm = fit < F ? fit : F;
  pl = {0, kWide, 0, 1, grid, gpb, span, chunk, (width + chunk - 1) / chunk, rsm,
        sums + tile_bytes(chunk) + rsm * 16 * hd,
        backward ? 0 : (long long)grid * (F - rsm) * 4 * hd};
  return pl;
}

// Floats of the exchange buffer proper: kSlots slots of every group's piece
// (the backward's, a piece a gate).
long long exchange_floats(int d, int backward) {
  const long long groups = (d + kFeat - 1) / kFeat;
  return (long long)kSlots * groups * kGate * (backward ? 4 : 1);
}

int sm_count(int* nsm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(nsm, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// Launches `kernel` cooperatively on the plan's grid and shared memory,
// after checking that the card holds every block at once (kNotResident
// otherwise, which no width reaches on an H100: a guard).
template <typename Args>
int start(void (*kernel)(Args), Args* args, const Plan& pl, int nsm, void* stream) {
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)kernel, kThreads,
                                                        (size_t)pl.smem);
  if (err != cudaSuccess) return (int)err;
  if (pl.grid > (long long)nsm * per_sm) return kNotResident;
  void* params[] = {args};
  cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)pl.grid), dim3(kThreads), params,
                              (size_t)pl.smem, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 64-bit words of the sync state: the launch epoch, then kMaxBlocks flags,
// each in a 128-byte line of its own.
long long slstm_sync_words() { return (long long)kFlagStride * (1 + kMaxBlocks); }

// Floats of the buffer a launch on the current device needs after its
// operands (the wrapper allocates it, uninitialised: the flags say what in
// it is current): the exchange buffer, then, for the forward on the wide
// route, the transposed columns of r that do not fit shared memory. -1 if
// the device cannot be asked.
long long slstm_exchange_floats(int d, int H, int backward) {
  int nsm = 0;
  if (sm_count(&nsm) != 0) return -1;
  return exchange_floats(d, backward) + plan_for(d, H, nsm, backward).scratch;
}

// The plan of a launch of (d, H) one way on a card of nsm SMs, without
// launching: writes kPlanFields numbers to `out` (Plan's fields, in order)
// and returns the refusal's code, 0 where the shape runs.
int slstm_plan(int d, int H, int nsm, int backward, long long* out) {
  const Plan pl = plan_for(d, H, nsm, backward);
  const long long v[kPlanFields] = {pl.code, pl.route, pl.kks, pl.per_sm, pl.grid, pl.gpb,
                                    pl.span, pl.chunk, pl.nchunk, pl.rsm, pl.smem, pl.scratch};
  for (int i = 0; i < kPlanFields; ++i) out[i] = v[i];
  return (int)pl.code;
}

// The forward scan: see the header. `xbuf` holds slstm_exchange_floats(d,
// H, 0) floats, `sync` the sync state (slstm_sync_words() 64-bit words on
// the card, zero before the first launch that uses it, then kept: each
// launch advances the epoch in it). Launches cooperatively on `stream` as
// plan_for says and returns the CUDA error as an int (0 = launched),
// kNotResident or kMalformed. Nothing is synchronised.
int slstm_forward(const float* xwb, const float* r, const float* h0, const float* c0,
                  const float* n0, const float* m0, float* hs, float* cs, float* ns,
                  float* ms, float* pre, float* xbuf, u64* sync, int B, int S, int d,
                  int H, int save, void* stream) {
  FwdArgs a{xwb, r, h0, c0, n0, m0, hs, cs, ns, ms, pre, xbuf, sync, B, S, d, H, save};
  int nsm = 0;
  const int err = sm_count(&nsm);
  if (err != 0) return err;
  const Plan pl = plan_for(d, H, nsm, 0);
  if (pl.code != 0) return (int)pl.code;
  if (pl.route == kNarrow)
    return start(pl.per_sm == 1 ? forward_for<1>(d / H) : forward_for<2>(d / H), &a, pl, nsm,
                 stream);
  WideFwdArgs w{a, xbuf + exchange_floats(d, 0), (int)pl.gpb, (int)pl.chunk, (int)pl.rsm};
  return start(slstm_forward_wide_kernel, &w, pl, nsm, stream);
}

// The backward scan: see the header. `xbuf` holds slstm_exchange_floats(d,
// H, 1) floats. Launches as slstm_forward, on the same sync state.
int slstm_backward(const float* r, const float* pre, const float* cs, const float* ns,
                   const float* ms, const float* c0, const float* n0, const float* m0,
                   const float* dhs, const float* dcT, const float* dnT, const float* dmT,
                   float* dpre, float* dh0, float* dc0, float* dn0, float* dm0, float* xbuf,
                   u64* sync, int B, int S, int d, int H, void* stream) {
  int nsm = 0;
  const int err = sm_count(&nsm);
  if (err != 0) return err;
  const Plan pl = plan_for(d, H, nsm, 1);
  if (pl.code != 0) return (int)pl.code;
  BwdArgs a{r, pre, cs, ns, ms, c0, n0, m0, dhs, dcT, dnT, dmT,
            dpre, dh0, dc0, dn0, dm0, xbuf, sync, B, S, d, H, (int)pl.span};
  if (pl.route == kNarrow)
    return start(pl.per_sm == 1 ? backward_for<1>(d / H) : backward_for<2>(d / H), &a, pl, nsm,
                 stream);
  WideBwdArgs w{a, (int)pl.gpb, (int)pl.chunk, (int)pl.rsm};
  return start(slstm_backward_wide_kernel, &w, pl, nsm, stream);
}

const char* slstm_error_string(int code) {
  if (code == kNotResident) return "the card cannot hold every block of this launch at once";
  if (code == kMalformed) return "the shape is malformed: d must be a positive multiple of H";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
