// sLSTM recurrence (the xLSTM scalar-memory mixer), hand-written for Hopper
// (sm_90a): the forward scan and its backward, each one cooperative launch.
//
// Replaces no Pallas kernel. The JAX model runs the recurrence as a
// jax.lax.scan over time (src/repro/models/layers.py:699 `slstm_apply`, :725
// `slstm_decode`, the cell `_slstm_cell` :666), which XLA compiles into one
// loop on the device; the port's eager loop over positions launched ~21 small
// ops a position a layer from the host instead. Here the whole scan is one
// launch, and so is its backward (the JAX model differentiates the scan).
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
// 4) every feature's i gate reads head 0 and its o gate head 3.
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
// Design. Every step needs the whole h_{t-1} (a feature's four gates read
// up to four heads), so the grid meets at a barrier after each step: one
// cooperative launch (co-residency guaranteed), at most one block an SM, each
// block owning groups of 8 features, i.e. the 32 gate columns j, d+j, 2d+j,
// 3d+j of its features, one a lane. It keeps those columns of r in shared
// memory for the whole scan (hd x 32 floats a group: 32 KB at hd 256; r is 4
// MB in all, more than a thread-block cluster's shared memory holds, hence
// the whole grid). A step, for 8 batch rows at a time: h_{t-1} of the rows
// into shared memory (read from hs through L2, __ldcg: another block wrote
// it), each warp a slice of the hd products of every column and row, the
// slices summed in warp order, the gates and the state update by one thread a
// (row, feature), the state kept in the output buffers that only its thread
// touches, h_t to hs; then the grid barrier. The backward walks t from S - 1
// to 0 the same way, carrying dc, dn, dm in dc0, dn0, dm0 (one thread each)
// and forming h_{t-1}'s recurrent gradient dh[:, k*hd + k'] = dpre_t[:, head
// k's 4hd columns] . r[k, k', :] from the dpre_t that every block wrote in the
// step before (a rows of r per feature in shared memory, dpre_t's head slice
// staged through shared memory), each a warp's strided sum then a butterfly.
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
// operations. The S steps are a chain: each adds a grid barrier (~1-2 us) and
// a round trip through L2, which this simple design does not hide.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // batch rows a pass
constexpr int kFeat = 8;  // features a group: 4 gates x 8 = 32 columns, one a lane
static_assert(kWarps == kFeat, "the backward's dot products are one warp a feature");

// Error code returned (beside CUDA's own) when the card cannot hold one block
// an SM of the launch, or the grid is not co-resident.
constexpr int kNotResident = 10001;

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
  unsigned* barrier;
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
  unsigned* barrier;
  int B, S, d, H, span;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Clock cycles a block waits at a barrier before it stops the kernel (~10 s
// at 1.7 GHz): a grid that is not all resident fails instead of hanging.
constexpr long long kBarrierPatience = 1LL << 34;

// Every block of the co-resident grid arrives, then waits for all: the
// counter (zeroed by the wrapper) grows by gridDim.x a barrier, and `target`
// is the count the current barrier waits for.
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    const long long start = clock64();
    while (ld_acquire(count) < target) {
      if (clock64() - start > kBarrierPatience) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// As PyTorch's CUDA log_sigmoid and sigmoid.
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(kThreads) slstm_forward_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  const int B = a.B, S = a.S, d = a.d, H = a.H, hd = d / H, G = 4 * hd;
  const int ngroups = (d + kFeat - 1) / kFeat;
  const int ng = (ngroups + gridDim.x - 1) / gridDim.x;  // groups a block holds
  const int hp = hd + 1;  // a head's row in h_s, padded off the banks of the next
  const int hrow = H * hp;
  float* r_s = smem;                          // [ng][hd][32]
  float* h_s = r_s + (size_t)ng * hd * 32;    // [kRows][H * hp]
  float* red_s = h_s + kRows * hrow;          // [kWarps][kRows][32]
  float* pre_s = red_s + kWarps * kRows * 32;  // [kRows][32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the group's 32 columns of r: lane l is gate l / 8 of feature l % 8
  for (int gi = 0; gi < ng; ++gi) {
    const int g = blockIdx.x + gi * gridDim.x;
    for (int idx = tid; idx < hd * 32; idx += kThreads) {
      const int kp = idx / 32, l = idx % 32, j = g * kFeat + l % kFeat;
      float v = 0.f;
      if (g < ngroups && j < d) {
        const int col = (l / kFeat) * d + j;
        v = a.r[((size_t)(col / G) * hd + kp) * G + col % G];
      }
      r_s[((size_t)gi * hd + kp) * 32 + l] = v;
    }
  }
  // this warp's slice of the hd products
  const int ks = (hd + kWarps - 1) / kWarps;
  const int kp0 = min(hd, warp * ks), kp1 = min(hd, kp0 + ks);
  unsigned target = 0;

  for (int t = 0; t < S; ++t) {
    for (int b0 = 0; b0 < B; b0 += kRows) {
      __syncthreads();  // h_s and pre_s free again
      for (int idx = tid; idx < kRows * d; idx += kThreads) {
        const int bb = idx / d, jj = idx - bb * d, b = b0 + bb;
        float v = 0.f;
        if (b < B)
          v = t == 0 ? a.h0[(size_t)b * d + jj]
                     : __ldcg(a.hs + ((size_t)b * S + t - 1) * d + jj);
        h_s[bb * hrow + (jj / hd) * hp + jj % hd] = v;
      }
      __syncthreads();
      for (int gi = 0; gi < ng; ++gi) {
        const int g = blockIdx.x + gi * gridDim.x;
        if (g >= ngroups) break;  // the same for every thread of the block
        {
          const int j = g * kFeat + lane % kFeat;
          const int hoff = j < d ? (((lane / kFeat) * d + j) / G) * hp : 0;
          float acc[kRows];
#pragma unroll
          for (int bb = 0; bb < kRows; ++bb) acc[bb] = 0.f;
          const float* rc = r_s + (size_t)gi * hd * 32 + lane;
          for (int kp = kp0; kp < kp1; ++kp) {
            const float rv = rc[kp * 32];
#pragma unroll
            for (int bb = 0; bb < kRows; ++bb)
              acc[bb] = fmaf(h_s[bb * hrow + hoff + kp], rv, acc[bb]);
          }
#pragma unroll
          for (int bb = 0; bb < kRows; ++bb) red_s[(warp * kRows + bb) * 32 + lane] = acc[bb];
        }
        __syncthreads();
        if (tid < kRows * 32) {  // the slices summed in warp order, plus xwb
          const int bb = tid / 32, l = tid % 32, b = b0 + bb, j = g * kFeat + l % kFeat;
          if (b < B && j < d) {
            float s = red_s[bb * 32 + l];
            for (int w = 1; w < kWarps; ++w) s += red_s[(w * kRows + bb) * 32 + l];
            const size_t at = ((size_t)b * S + t) * 4 * d + (l / kFeat) * d + j;
            const float p = a.xwb[at] + s;
            pre_s[bb * 32 + l] = p;
            if (a.save) a.pre[at] = p;
          }
        }
        __syncthreads();
        if (tid < kRows * kFeat) {  // the gates and the state of (row, feature)
          const int bb = tid / kFeat, f = tid % kFeat, b = b0 + bb, j = g * kFeat + f;
          if (b < B && j < d) {
            const float* p = pre_s + bb * 32 + f;
            const float ip = p[0], fp = p[kFeat], zp = p[2 * kFeat], op = p[3 * kFeat];
            const size_t at = a.save ? ((size_t)b * S + t) * d + j : (size_t)b * d + j;
            float c, n, m;
            if (t == 0) {
              c = a.c0[(size_t)b * d + j];
              n = a.n0[(size_t)b * d + j];
              m = a.m0[(size_t)b * d + j];
            } else {
              const size_t prev = a.save ? at - d : at;
              c = a.cs[prev];
              n = a.ns[prev];
              m = a.ms[prev];
            }
            const float lfm = __fadd_rn(log_sigmoid(fp), m);
            const float mn = fmaxf(lfm, ip);
            const float ig = expf(__fsub_rn(ip, mn));
            const float fg = expf(__fsub_rn(lfm, mn));
            const float zg = tanhf(zp);
            const float og = sigmoid(op);
            const float cn = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, zg));
            const float nn = __fadd_rn(__fmul_rn(fg, n), ig);
            a.cs[at] = cn;
            a.ns[at] = nn;
            a.ms[at] = mn;
            a.hs[((size_t)b * S + t) * d + j] = __fdiv_rn(__fmul_rn(og, cn), fmaxf(nn, 1.f));
          }
        }
      }
    }
    if (t + 1 < S) grid_barrier(a.barrier, target);
  }
}

__global__ void __launch_bounds__(kThreads) slstm_backward_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int B = a.B, S = a.S, d = a.d, H = a.H, hd = d / H, G = 4 * hd;
  const int ngroups = (d + kFeat - 1) / kFeat;
  const int ng = (ngroups + gridDim.x - 1) / gridDim.x;
  const int sw = a.span * G;                      // a staged row of dpre_{t+1}
  float* rr_s = smem;                             // [ng][kFeat][G]: r[k, k', :]
  float* dp_s = rr_s + (size_t)ng * kFeat * G;    // [kRows][sw]
  float* ghr_s = dp_s + (size_t)kRows * sw;       // [kRows][kFeat]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int gi = 0; gi < ng; ++gi) {
    const int g = blockIdx.x + gi * gridDim.x;
    for (int idx = tid; idx < kFeat * G; idx += kThreads) {
      const int f = idx / G, e = idx % G, j = g * kFeat + f;
      rr_s[(size_t)gi * kFeat * G + idx] =
          (g < ngroups && j < d) ? a.r[((size_t)(j / hd) * hd + j % hd) * G + e] : 0.f;
    }
    // the carried gradients start as the final state's
    if (g < ngroups && tid < kRows * kFeat) {
      for (int b0 = 0; b0 < B; b0 += kRows) {
        const int b = b0 + tid / kFeat, j = g * kFeat + tid % kFeat;
        if (b < B && j < d) {
          const size_t bj = (size_t)b * d + j;
          a.dc0[bj] = a.dcT[bj];
          a.dn0[bj] = a.dnT[bj];
          a.dm0[bj] = a.dmT[bj];
        }
      }
    }
  }
  unsigned target = 0;

  // t = -1 forms h0's gradient from dpre_0 alone
  for (int t = S - 1; t >= -1; --t) {
    for (int b0 = 0; b0 < B; b0 += kRows) {
      for (int gi = 0; gi < ng; ++gi) {
        const int g = blockIdx.x + gi * gridDim.x;
        if (g >= ngroups) break;
        const int jlo = g * kFeat, klo = jlo / hd;
        __syncthreads();  // dp_s and ghr_s free again
        if (t + 1 < S) {
          // h_t's recurrent gradient from dpre_{t+1} of the group's heads
          const int width = min(sw, 4 * d - klo * G);
          for (int idx = tid; idx < kRows * sw; idx += kThreads) {
            const int bb = idx / sw, x = idx - bb * sw, b = b0 + bb;
            dp_s[idx] = (b < B && x < width)
                            ? __ldcg(a.dpre + ((size_t)b * S + t + 1) * 4 * d + klo * G + x)
                            : 0.f;
          }
          __syncthreads();
          const int j = jlo + warp;
          float acc[kRows];
#pragma unroll
          for (int bb = 0; bb < kRows; ++bb) acc[bb] = 0.f;
          if (j < d) {  // the same for every lane of the warp
            const float* rr = rr_s + ((size_t)gi * kFeat + warp) * G;
            const float* dp = dp_s + (j / hd - klo) * G;
            for (int e = lane; e < G; e += 32) {
              const float rv = rr[e];
#pragma unroll
              for (int bb = 0; bb < kRows; ++bb) acc[bb] = fmaf(dp[bb * sw + e], rv, acc[bb]);
            }
          }
#pragma unroll
          for (int bb = 0; bb < kRows; ++bb)
            for (int o = 16; o > 0; o >>= 1) acc[bb] += __shfl_xor_sync(0xffffffffu, acc[bb], o);
          if (lane == 0) {
#pragma unroll
            for (int bb = 0; bb < kRows; ++bb) ghr_s[bb * kFeat + warp] = acc[bb];
          }
        } else if (tid < kRows * kFeat) {
          ghr_s[tid] = 0.f;
        }
        __syncthreads();
        if (tid < kRows * kFeat) {
          const int b = b0 + tid / kFeat, j = jlo + tid % kFeat;
          if (b < B && j < d) {
            const size_t bj = (size_t)b * d + j;
            if (t < 0) {
              a.dh0[bj] = ghr_s[tid];
            } else {
              const size_t at = ((size_t)b * S + t) * d + j;
              const size_t pa = ((size_t)b * S + t) * 4 * d + j;
              const float ip = a.pre[pa], fp = a.pre[pa + d];
              const float zp = a.pre[pa + 2 * d], op = a.pre[pa + 3 * d];
              const float cp = t ? a.cs[at - d] : a.c0[bj];
              const float np = t ? a.ns[at - d] : a.n0[bj];
              const float mp = t ? a.ms[at - d] : a.m0[bj];
              const float ct = a.cs[at], nt = a.ns[at];
              const float lfm = __fadd_rn(log_sigmoid(fp), mp);
              const float mt = fmaxf(lfm, ip);
              const float ig = expf(ip - mt), fg = expf(lfm - mt);
              const float zg = tanhf(zp), og = sigmoid(op);
              const float den = fmaxf(nt, 1.f);
              const float gh = a.dhs[at] + ghr_s[tid];
              const float dq = gh / den;
              // clamp_min(n, 1) passes the gradient at n == 1, as PyTorch's
              const float gc = a.dc0[bj] + dq * og;
              const float gn = a.dn0[bj] + (nt >= 1.f ? -gh * (og * ct) / (den * den) : 0.f);
              const float dfg = gc * cp + gn * np;
              const float dig = gc * zg + gn;
              const float ea = dig * ig, eb = dfg * fg;
              const float dmt = a.dm0[bj] - ea - eb;
              // max(lfm, i) splits a tie half and half, as torch.maximum
              const float wl = lfm > ip ? 1.f : (lfm < ip ? 0.f : 0.5f);
              const float dlfm = eb + dmt * wl;
              const float z = expf(-fabsf(fp));  // sigmoid(-f), stably
              const float sneg = fp < 0.f ? 1.f / (1.f + z) : z / (1.f + z);
              a.dpre[pa] = ea + dmt * (1.f - wl);
              a.dpre[pa + d] = dlfm * sneg;
              a.dpre[pa + 2 * d] = gc * ig * (1.f - zg * zg);
              a.dpre[pa + 3 * d] = dq * ct * og * (1.f - og);
              a.dc0[bj] = gc * fg;
              a.dn0[bj] = gn * fg;
              a.dm0[bj] = dlfm;
            }
          }
        }
      }
    }
    if (t >= 0) grid_barrier(a.barrier, target);
  }
}

// One block an SM at most, no more blocks than groups; the launch is refused
// (kNotResident) when the card cannot hold a block of `smem` bytes.
template <typename Kernel>
int grid_for(Kernel kernel, size_t smem, int ngroups, int* grid) {
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return kNotResident;
  *grid = ngroups < nsm ? ngroups : nsm;
  return 0;
}

}  // namespace

extern "C" {

// The forward scan: see the header. `barrier` is one zeroed unsigned int on
// the card. Launches cooperatively on `stream` and returns the CUDA error as
// an int (0 = launched), or kNotResident. Nothing is synchronised.
int slstm_forward(const float* xwb, const float* r, const float* h0, const float* c0,
                  const float* n0, const float* m0, float* hs, float* cs, float* ns,
                  float* ms, float* pre, unsigned* barrier, int B, int S, int d, int H,
                  int save, void* stream) {
  FwdArgs a{xwb, r, h0, c0, n0, m0, hs, cs, ns, ms, pre, barrier, B, S, d, H, save};
  const int hd = d / H, ngroups = (d + kFeat - 1) / kFeat;
  int grid = 0;
  // r_s for at most ceil(ngroups / grid) groups; sized below once grid is known
  size_t smem = sizeof(float) * ((size_t)hd * 32 + kRows * H * (hd + 1) + kWarps * kRows * 32 +
                                 kRows * 32);
  int err = grid_for(slstm_forward_kernel, smem, ngroups, &grid);
  if (err) return err;
  const int ng = (ngroups + grid - 1) / grid;
  if (ng > 1) {
    smem += sizeof(float) * (size_t)(ng - 1) * hd * 32;
    err = grid_for(slstm_forward_kernel, smem, ngroups, &grid);
    if (err) return err;
  }
  void* args[] = {&a};
  cudaLaunchCooperativeKernel((const void*)slstm_forward_kernel, dim3(grid), dim3(kThreads),
                              args, smem, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The backward scan: see the header. `span` is the most heads a group of 8
// features touches. Launches as slstm_forward.
int slstm_backward(const float* r, const float* pre, const float* cs, const float* ns,
                   const float* ms, const float* c0, const float* n0, const float* m0,
                   const float* dhs, const float* dcT, const float* dnT, const float* dmT,
                   float* dpre, float* dh0, float* dc0, float* dn0, float* dm0,
                   unsigned* barrier, int B, int S, int d, int H, void* stream) {
  const int hd = d / H, G = 4 * hd, ngroups = (d + kFeat - 1) / kFeat;
  int span = 1;
  for (int g = 0; g < ngroups; ++g) {
    const int lo = g * kFeat, hi = (lo + kFeat < d ? lo + kFeat : d) - 1;
    if (hi / hd - lo / hd + 1 > span) span = hi / hd - lo / hd + 1;
  }
  BwdArgs a{r, pre, cs, ns, ms, c0, n0, m0, dhs, dcT, dnT, dmT,
            dpre, dh0, dc0, dn0, dm0, barrier, B, S, d, H, span};
  int grid = 0;
  size_t smem = sizeof(float) * ((size_t)kFeat * G + (size_t)kRows * span * G + kRows * kFeat);
  int err = grid_for(slstm_backward_kernel, smem, ngroups, &grid);
  if (err) return err;
  const int ng = (ngroups + grid - 1) / grid;
  if (ng > 1) {
    smem += sizeof(float) * (size_t)(ng - 1) * kFeat * G;
    err = grid_for(slstm_backward_kernel, smem, ngroups, &grid);
    if (err) return err;
  }
  void* args[] = {&a};
  cudaLaunchCooperativeKernel((const void*)slstm_backward_kernel, dim3(grid), dim3(kThreads),
                              args, smem, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

const char* slstm_error_string(int code) {
  if (code == kNotResident) return "the card holds no block of this launch on an SM";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
