// Water-filling feasibility mass, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_waterfill_kernel` / `waterfill_masses` of
// src/repro/kernels/waterfill.py. For every candidate throughput level tau
// (a "lane") it runs the greedy k-pass water-filling of the non-cooperative
// OEF solver and returns the leftover need sum_u r_u, which is ~0 iff tau is
// feasible. Types go fastest first (column k-1 down to 0), users fastest
// first (row 0 first):
//
//     r_u   = tau * mask_u
//     for j = k-1 .. 0:
//         w_u      = max(Wf[u, j], 1e-300)
//         dev_u    = r_u / w_u
//         excl_u   = cumsum_u(dev) - dev_u
//         take_u   = clip(m_j - excl_u, 0, dev_u)
//         r_u     -= take_u * w_u
//     mass = sum_u r_u
//
// Operands (all float64, contiguous, on one device): taus (B, T),
// Wf (B, n_pad, k), m (B, k), mask (B, n_pad); output mass (B, T); scratch
// r (B, T, n_pad), written and read back only by the thread that owns each
// user, so no other thread ever depends on it. B is the batch of instances
// (1 on the service's path), T the lanes (1 for the warm-start probe, 8 per
// multisection step).
//
// Bound on the card. One call must read the inputs once and write the
// output once: about (n_pad*k + n_pad + k + 2T)*8 bytes per instance, 33 KB
// at n_pad = 1024, k = 3, T = 8, i.e. ~10 ns at 3.35 TB/s. It does about
// T*n_pad*k*8 FP64 operations, ~0.2 MFLOP, i.e. ~6 ns at 34 TFLOP/s. Both
// are three orders of magnitude below one launch's latency (a few us), so
// the kernel is bound by latency: by the k sequential type passes and the
// block-wide scan inside each. The design answers that by doing a whole
// multisection step in one launch (all T lanes at once, one block per lane
// and instance, no host sync), by sizing the block to n_pad (up to 1024
// threads) so that n_pad <= 1024 needs one scan chunk per type, and by
// launching nothing else: the multisection bookkeeping between steps is a
// few tiny torch ops on the same stream.
//
// Determinism. There are no atomics. Each block scans and reduces in a
// fixed tree order that depends only on n_pad, so a replay repeats bit for
// bit. The multiply-subtract is written with __dmul_rn / __dsub_rn so that
// nvcc cannot contract it into an FMA, which would round differently from
// the plain PyTorch version that the kernel is held against.
//
// Unlike the TPU kernel, whose sequential grid carried r and the running
// consumption in revisited output blocks, blocks here run in no order: the
// loops over types and user chunks live inside the block, and the running
// consumption of a type is a register carried across chunks.
//
// The fused solve (`waterfill_solve_kernel`, C entry `waterfill_solve`). Around
// the kernel above, the solver (`repro_torch.kernels.waterfill.
// waterfill_solve_plain`) brackets tau, probes an optional hint, runs ITERS
// multisection steps of LANES candidate taus each and recovers the
// allocation at the converged tau: ~140 launches a solve, each a few us of
// host work, for ~70 us of kernel. This kernel does all of it in one launch,
// one block per instance, the block sized as above (so the scans' tree order,
// and with it every lane's mass, is the one of `waterfill_masses_kernel`):
//
//     n_active = sum_u mask_u;   top_j = max_u Wf[u,j] mask_u
//     hi_cap   = (sum_j top_j m_j) / n_active + 1;   lo = 0, hi = hi_cap
//     hint:    h = min(max(hint, 0), hi_cap); ok(h) ? lo = h : hi = h
//     ITERS x: tau_t = lo + (hi - lo) (t + 1) / (LANES + 1), t < LANES
//              i = #{t : mass(tau_t) <= 1e-12 (1 + n_active tau_t)}
//              i > 0 ? lo = tau_{i-1};  i < LANES ? hi = tau_i
//     X = the greedy pass at lo, writing each type's take;  tau = lo
//
// Each thread carries all lanes of its users, so one block scan of a
// LANES-vector per type pass (two barriers; the per-warp totals alternate
// between two buffers) and one block sum per step serve all lanes: 2k + 3
// barriers a step, where the unfused path paid a launch per step. The
// second level of each lane's scan runs on warp (lane mod warps), in the
// same tree order. Thread 0 forms the taus and the bracket with every
// operation rounded on its own, in the plain version's order (hi_cap's sum
// over j in order), so the converged tau is the one the unfused path on the
// card finds, bit for bit. X differs from that path's by the order of
// torch's cumsum, ~1e-13 relative.
//
// Registers: at 1024 threads a thread has 64, and the 8 lanes' scan values
// and their shuffles take 32 across each scan's barriers. So everything else
// a thread carries across a scan lives in shared memory: its lanes' dev
// (8 x blockDim doubles) and the remaining needs r (8 x n_pad; 128 KB for
// both at n_pad = 1024, asked for once per device), or above n_pad = 1024 r
// in the global scratch as in the kernel above; and the running
// consumption, uniform over the block.
//
// Bound: one solve reads Wf, m, mask and the hint once and writes tau and X
// once, 8 (2 n_pad k + n_pad + k + 2) bytes per instance (74 KB at n_pad
// 1024, k 3: 22 ns), and does about 8 n_pad k (LANES ITERS + 1 + use_hint)
// FP64 operations (3.7 MFLOP: 0.11 us at 34 TFLOP/s). On one SM the FP64
// rate is 1/132 of that, and the division in each (lane, user, type) costs
// about ten operations; what bounds the launch is the one SM's FP64 rate
// and the barriers' latency, not device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarp = 32;
constexpr double kWFloor = 1e-300;  // same floor as the numpy greedy

// Inclusive scan of x over the block in a fixed order: warp shuffles, then
// one warp scans the per-warp totals kept in shared memory. Returns the
// inclusive prefix and stores the block total in *total. Every thread of
// the block must call it.
__device__ __forceinline__ double block_inclusive_scan(double x, double* warp_tot,
                                                       double* total) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int n_warps = (blockDim.x + kWarp - 1) / kWarp;
  double v = x;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  if (lane == kWarp - 1) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double s = lane < n_warps ? warp_tot[lane] : 0.0;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    if (lane < n_warps) warp_tot[lane] = s;
  }
  __syncthreads();
  const double prefix = warp > 0 ? warp_tot[warp - 1] : 0.0;
  *total = warp_tot[n_warps - 1];
  __syncthreads();  // warp_tot is rewritten by the next call
  return prefix + v;
}

// Sum of x over the block in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ double block_sum(double x, double* warp_tot) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int n_warps = (blockDim.x + kWarp - 1) / kWarp;
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  if (lane == 0) warp_tot[warp] = x;
  __syncthreads();
  double s = 0.0;
  if (warp == 0) {
    s = lane < n_warps ? warp_tot[lane] : 0.0;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
  }
  return s;
}

// grid = (T, B): one block per (lane, instance).
__global__ void waterfill_masses_kernel(const double* __restrict__ taus,
                                        const double* __restrict__ Wf,
                                        const double* __restrict__ m,
                                        const double* __restrict__ mask,
                                        double* __restrict__ r_buf,
                                        double* __restrict__ mass,
                                        int T, int n_pad, int k) {
  __shared__ double warp_tot[kMaxThreads / kWarp];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const double tau = taus[(size_t)b * T + t];
  const double* W = Wf + (size_t)b * n_pad * k;
  const double* mk = mask + (size_t)b * n_pad;
  const double* mb = m + (size_t)b * k;
  double* r = r_buf + ((size_t)b * T + t) * n_pad;

  double acc = 0.0;  // this thread's share of the final mass
  for (int j = k - 1; j >= 0; --j) {
    const double mj = mb[j];
    double carry = 0.0;  // consumption of type j by earlier chunks
    for (int c = 0; c < n_pad; c += blockDim.x) {
      const int u = c + threadIdx.x;
      const bool live = u < n_pad;
      double ru = 0.0;
      double w = 1.0;
      if (live) {
        ru = (j == k - 1) ? tau * mk[u] : r[u];
        w = fmax(W[(size_t)u * k + j], kWFloor);
      }
      const double dev = ru / w;
      double chunk_total;
      const double incl = block_inclusive_scan(dev, warp_tot, &chunk_total);
      if (live) {
        const double excl = (carry + incl) - dev;
        const double take = fmin(fmax(mj - excl, 0.0), dev);
        ru = __dsub_rn(ru, __dmul_rn(take, w));
        if (j == 0)
          acc += ru;
        else
          r[u] = ru;
      }
      carry += chunk_total;
    }
  }
  const double s = block_sum(acc, warp_tot);
  if (threadIdx.x == 0) mass[(size_t)b * T + t] = s;
}

constexpr int kLanes = 8;   // most candidate taus a step (MAX_LANES in waterfill.py)

__device__ __forceinline__ double neg_inf() {
  return __longlong_as_double((long long)0xfff0000000000000ULL);
}

// block_inclusive_scan for NL lanes at once: v becomes the inclusive prefix
// of each lane; lane t's block total is then buf[t * kWarp + n_warps - 1].
// Two barriers; the caller alternates `buf` between calls, so no third
// barrier guards it against the next call's writes.
template <int NL>
__device__ __forceinline__ void block_scan_lanes(double (&v)[NL], double* buf) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int n_warps = (blockDim.x + kWarp - 1) / kWarp;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
#pragma unroll
    for (int t = 0; t < NL; ++t) {
      const double y = __shfl_up_sync(0xffffffffu, v[t], off);
      if (lane >= off) v[t] += y;
    }
  }
  if (lane == kWarp - 1) {
#pragma unroll
    for (int t = 0; t < NL; ++t) buf[t * kWarp + warp] = v[t];
  }
  __syncthreads();
  for (int t = warp; t < NL; t += n_warps) {
    double s = lane < n_warps ? buf[t * kWarp + lane] : 0.0;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    if (lane < n_warps) buf[t * kWarp + lane] = s;
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < NL; ++t) v[t] = (warp > 0 ? buf[t * kWarp + warp - 1] : 0.0) + v[t];
}

// block_sum for NL lanes at once; lane t's sum lands in out[t] (shared),
// valid for every thread on return.
template <int NL>
__device__ __forceinline__ void block_sum_lanes(double (&x)[NL], double* buf, double* out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int n_warps = (blockDim.x + kWarp - 1) / kWarp;
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int t = 0; t < NL; ++t) x[t] += __shfl_down_sync(0xffffffffu, x[t], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < NL; ++t) buf[t * kWarp + warp] = x[t];
  }
  __syncthreads();
  for (int t = warp; t < NL; t += n_warps) {
    double s = lane < n_warps ? buf[t * kWarp + lane] : 0.0;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) out[t] = s;
  }
  __syncthreads();
}

// Largest x over the block, in out (shared), valid for every thread on return.
__device__ __forceinline__ void block_max(double x, double* buf, double* out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int n_warps = (blockDim.x + kWarp - 1) / kWarp;
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x = fmax(x, __shfl_down_sync(0xffffffffu, x, off));
  if (lane == 0) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    double s = lane < n_warps ? buf[lane] : neg_inf();
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      s = fmax(s, __shfl_down_sync(0xffffffffu, s, off));
    if (lane == 0) *out = s;
  }
  __syncthreads();
}

// One greedy k-pass of NL lanes at the taus tau[0..NL) (shared), the loop of
// waterfill_masses_kernel with the lanes carried together. r holds the
// remaining needs: with kShared in shared memory, lane-major (t * n_pad + u,
// so a warp's reads fall in distinct banks), else in the global scratch,
// user-major (u * kLanes + t, so a thread's lanes share one address). The running consumption of a type by earlier chunks
// is uniform over the block, so it lives in shared memory too, in two
// buffers that alternate by chunk (thread 0 writes the next while the block
// reads the current). Returns in acc this thread's share of each lane's
// mass; with kAlloc (NL = 1) it also writes each type's take into X. Each
// thread parks its lanes' dev in dv (shared, NL x blockDim) across the scan,
// so only the scan's values stay in registers there.
template <int NL, bool kAlloc, bool kShared>
__device__ __forceinline__ void greedy_pass(const double* tau, const double* __restrict__ W,
                                            const double* __restrict__ mk,
                                            const double* __restrict__ mb, int n_pad, int k,
                                            double* r, double* dv, double* __restrict__ X,
                                            double (*scan_buf)[kLanes * kWarp],
                                            double (*carry)[kLanes], int& parity,
                                            double (&acc)[NL]) {
  const int nt = blockDim.x;
  const int n_warps = (nt + kWarp - 1) / kWarp;
  const int chunks = (n_pad + nt - 1) / nt;
  const int t_stride = kShared ? n_pad : 1;
  const int u_stride = kShared ? 1 : kLanes;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < NL; ++t) carry[0][t] = 0.0;
  }
  int q = 0;  // chunks done in this pass; carry[q & 1] is the current chunk's
  for (int j = k - 1; j >= 0; --j) {
    const double mj = mb[j];
    for (int c = 0; c < chunks; ++c, ++q) {
      const int u = c * nt + threadIdx.x;
      const bool live = u < n_pad;
      double* ru_at = r + (size_t)u * u_stride;  // lane t at ru_at[t * t_stride]
      double w = 1.0;
      double v[NL];
#pragma unroll
      for (int t = 0; t < NL; ++t) v[t] = 0.0;
      if (live) {
        w = fmax(W[(size_t)u * k + j], kWFloor);
#pragma unroll
        for (int t = 0; t < NL; ++t) {
          const double ru = j == k - 1 ? __dmul_rn(tau[t], mk[u]) : ru_at[t * t_stride];
          v[t] = ru / w;
          dv[t * nt + threadIdx.x] = v[t];
        }
      }
      double* buf = scan_buf[parity];
      parity ^= 1;
      block_scan_lanes<NL>(v, buf);
      const double* cin = carry[q & 1];
      if (live) {
#pragma unroll
        for (int t = 0; t < NL; ++t) {
          const double dev = dv[t * nt + threadIdx.x];
          const double excl = (cin[t] + v[t]) - dev;
          const double take = fmin(fmax(mj - excl, 0.0), dev);
          const double ru = j == k - 1 ? __dmul_rn(tau[t], mk[u]) : ru_at[t * t_stride];
          if (kAlloc) X[(size_t)u * k + j] = take;
          ru_at[t * t_stride] = __dsub_rn(ru, __dmul_rn(take, w));
        }
      }
      if (threadIdx.x == 0) {
        const bool last = c == chunks - 1;  // the next type starts from nothing
#pragma unroll
        for (int t = 0; t < NL; ++t)
          carry[(q + 1) & 1][t] = last ? 0.0 : cin[t] + buf[t * kWarp + n_warps - 1];
      }
    }
  }
  // the final need, summed over this thread's chunks in order
#pragma unroll
  for (int t = 0; t < NL; ++t) {
    acc[t] = 0.0;
    for (int u = threadIdx.x; u < n_pad; u += nt)
      acc[t] += r[(size_t)u * u_stride + t * t_stride];
  }
}

// grid = (B,): one block per instance; see the header. Dynamic shared
// memory: dv (kLanes x blockDim doubles), then, with kSingle (n_pad <=
// blockDim), r (kLanes x n_pad).
template <bool kSingle>
__global__ void __launch_bounds__(kMaxThreads)
waterfill_solve_kernel(const double* __restrict__ Wf, const double* __restrict__ m,
                       const double* __restrict__ mask, const double* __restrict__ hint,
                       double* __restrict__ r_buf, double* __restrict__ tau_out,
                       double* __restrict__ X, int n_pad, int k, int lanes, int iters,
                       int use_hint) {
  extern __shared__ double dyn[];
  __shared__ double scan_buf[2][kLanes * kWarp];
  __shared__ double sum_buf[kLanes * kWarp];
  __shared__ double carry[2][kLanes];
  __shared__ double taus[kLanes];
  __shared__ double mass[kLanes];
  __shared__ double top;
  __shared__ double n_act;
  int parity = 0;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const double* W = Wf + (size_t)b * n_pad * k;
  const double* mk = mask + (size_t)b * n_pad;
  const double* mb = m + (size_t)b * k;
  double* dv = dyn;
  double* r = kSingle ? dyn + kLanes * nt : r_buf + (size_t)b * n_pad * kLanes;
  double* Xb = X + (size_t)b * n_pad * k;

  // the bracket: n_active and each type's fastest active user, whose
  // capacity thread 0 sums over j in order as each type's max lands (it
  // reads `top` before the next block_max's first barrier, so any k fits)
  double a[1] = {0.0};
  for (int u = tid; u < n_pad; u += nt) a[0] += mk[u];
  block_sum_lanes<1>(a, sum_buf, &n_act);
  double cap = 0.0;  // thread 0's
  for (int j = 0; j < k; ++j) {
    double t = neg_inf();
    for (int u = tid; u < n_pad; u += nt) t = fmax(t, __dmul_rn(W[(size_t)u * k + j], mk[u]));
    block_max(t, sum_buf, &top);
    if (tid == 0) cap = j == 0 ? __dmul_rn(top, mb[0]) : __dadd_rn(cap, __dmul_rn(top, mb[j]));
  }
  const double na = n_act;
  double lo = 0.0, hi = 0.0;  // thread 0's bracket
  if (tid == 0) {
    hi = __dadd_rn(cap / na, 1.0);
    taus[0] = fmin(fmax(hint[b], 0.0), hi);
  }
  __syncthreads();
  if (use_hint) {
    double acc[1];
    greedy_pass<1, false, kSingle>(taus, W, mk, mb, n_pad, k, r, dv, Xb, scan_buf, carry, parity,
                          acc);
    block_sum_lanes<1>(acc, sum_buf, mass);
    if (tid == 0) {
      const double h = taus[0];
      if (mass[0] <= __dmul_rn(1e-12, __dadd_rn(1.0, __dmul_rn(na, h)))) lo = h;
      else hi = h;
    }
  }
  const double step = 1.0 / (lanes + 1.0);  // frac_t = (t + 1) * step
  for (int it = 0; it < iters; ++it) {
    if (tid == 0) {
      const double d = __dsub_rn(hi, lo);
      for (int t = 0; t < kLanes; ++t)
        taus[t] = t < lanes ? __dadd_rn(lo, __dmul_rn(d, __dmul_rn((double)(t + 1), step)))
                            : 0.0;
    }
    __syncthreads();
    if constexpr (kSingle) {
      double acc[kLanes];
      greedy_pass<kLanes, false, true>(taus, W, mk, mb, n_pad, k, r, dv, Xb, scan_buf, carry,
                                       parity, acc);
      block_sum_lanes<kLanes>(acc, sum_buf, mass);
    } else {
      // the global scratch's addressing leaves no room for 8 lanes' scan in
      // 64 registers: two passes of 4 lanes (each lane's arithmetic as above)
      for (int h = 0; h < kLanes; h += kLanes / 2) {
        double acc[kLanes / 2];
        greedy_pass<kLanes / 2, false, false>(taus + h, W, mk, mb, n_pad, k, r + h, dv, Xb,
                                              scan_buf, carry, parity, acc);
        block_sum_lanes<kLanes / 2>(acc, sum_buf, mass + h);
      }
    }
    if (tid == 0) {
      int i = 0;  // feasibility is monotone: the feasible lanes form a prefix
      for (int t = 0; t < lanes; ++t)
        i += mass[t] <= __dmul_rn(1e-12, __dadd_rn(1.0, __dmul_rn(na, taus[t])));
      const double at_lo = taus[i > 0 ? i - 1 : 0];
      const double at_hi = taus[i < lanes ? i : lanes - 1];
      if (i > 0) lo = at_lo;
      if (i < lanes) hi = at_hi;
    }
  }
  // the allocation at the converged tau
  if (tid == 0) {
    taus[0] = lo;
    tau_out[b] = lo;
  }
  __syncthreads();
  double unused[1];
  greedy_pass<1, true, kSingle>(taus, W, mk, mb, n_pad, k, r, dv, Xb, scan_buf, carry, parity,
                       unused);
}

constexpr int kMaxDevices = 64;
// The most dynamic shared memory a solve takes, dv and r at n_pad = 1024
// (128 KB), above the 48 KB a launch gets unasked: asked for once per
// device and kernel, before the first launch (and so before any CUDA-graph
// capture).
constexpr size_t kSolveSmem = sizeof(double) * kLanes * 2 * kMaxThreads;

cudaError_t allow_solve_smem() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    const void* kernels[] = {(const void*)waterfill_solve_kernel<true>,
                             (const void*)waterfill_solve_kernel<false>};
    for (const void* kernel : kernels) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kSolveSmem);
      if (err != cudaSuccess) return err;
    }
    ready[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 = launched). Nothing is synchronised and nothing is allocated here.
int waterfill_masses(const double* taus, const double* Wf, const double* m,
                     const double* mask, double* r_buf, double* mass, int B,
                     int T, int n_pad, int k, void* stream) {
  if (B < 1 || T < 1 || n_pad < 1 || k < 1) return (int)cudaErrorInvalidValue;
  int threads = n_pad < kMaxThreads ? n_pad : kMaxThreads;
  threads = (threads + kWarp - 1) / kWarp * kWarp;
  const dim3 grid((unsigned)T, (unsigned)B);
  waterfill_masses_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      taus, Wf, m, mask, r_buf, mass, T, n_pad, k);
  return (int)cudaGetLastError();
}

// The fused solve over B instances (see the header); same contract. r_buf
// is (B, n_pad, kLanes) scratch when n_pad > 1024, else unused.
int waterfill_solve(const double* Wf, const double* m, const double* mask,
                    const double* hint, double* r_buf, double* tau, double* X, int B,
                    int n_pad, int k, int lanes, int iters, int use_hint, void* stream) {
  if (B < 1 || n_pad < 1 || k < 1 || lanes < 1 || lanes > kLanes || iters < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_solve_smem();
  if (err != cudaSuccess) return (int)err;
  int threads = n_pad < kMaxThreads ? n_pad : kMaxThreads;
  threads = (threads + kWarp - 1) / kWarp * kWarp;
  const size_t dv = sizeof(double) * kLanes * threads;
  if (n_pad <= kMaxThreads)
    waterfill_solve_kernel<true><<<(unsigned)B, threads, dv + sizeof(double) * kLanes * n_pad,
                                   (cudaStream_t)stream>>>(
        Wf, m, mask, hint, r_buf, tau, X, n_pad, k, lanes, iters, use_hint);
  else
    waterfill_solve_kernel<false><<<(unsigned)B, threads, dv, (cudaStream_t)stream>>>(
        Wf, m, mask, hint, r_buf, tau, X, n_pad, k, lanes, iters, use_hint);
  return (int)cudaGetLastError();
}

const char* waterfill_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
