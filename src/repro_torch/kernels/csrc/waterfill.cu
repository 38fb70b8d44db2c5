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

const char* waterfill_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
