// Pairwise envy-gap matrix, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_envy_kernel` / `envy_gaps` of
// src/repro/kernels/envy.py. For the primal-dual solver of cooperative OEF
// (Eq. 10) it forms, once per PDHG step, the gap of every envious row l
// against every envied row i:
//
//     own_l   = sum_{j=0..k-1} W[l, j] * X[l, j]
//     E[l, i] = (sum_{j=0..k-1} W[l, j] * X[i, j]) - own_l
//
// Operands (all float64, contiguous, on one device): W and X (B, G, k);
// output E (B, G, G). G is the padded group count (8 on the online
// service's path, any size in the batch API), k the device-type count
// (3-4 in the service clusters, at most kMaxK here), B the batch of
// instances on gridDim.z.
//
// Layout. One thread per output entry (l, i): a block covers a kTile x kTile
// tile (threadIdx.y -> l, threadIdx.x -> i, so neighbouring threads write
// neighbouring addresses of a row of E). The block stages the k-wide rows it
// needs in shared memory, stored type-major so that the threads of a warp
// read consecutive words: the W rows and X rows of its envious tile and the
// X rows of its envied tile. It forms own_l once per row of the tile, as the
// TPU kernel does with its `xl` operand, instead of once per output entry.
// Ragged edges (G not a multiple of kTile) are masked, so any G works.
//
// Bound on the card. One call must read W and X once and write E once,
// 8 * (2*G*k + G*G) * B bytes, and does 2*G*G*k FP64 operations per
// instance. At G = 4096, k = 3 that is 134 MB (40 us at 3.35 TB/s) against
// 0.1 GFLOP (3 us at 34 TFLOP/s): bound by bytes, by the output write. At
// the service's G = 8 both are a few ns, far below one launch's latency:
// there the cost is the launch, which a later speed PR removes by fusing
// the whole PDHG step (or segment) into one kernel.
//
// Arithmetic order. The sums run over j = 0..k-1 and the own term is
// subtracted last, each operation rounded on its own with __dmul_rn /
// __dadd_rn / __dsub_rn. nvcc would otherwise contract products into FMAs,
// which round differently from the plain PyTorch version that spells the
// same order as separate multiplies and adds; written this way the two agree
// to the last bit. There are no atomics, so replays repeat bit for bit.
//
// The fused PD segment (`pd_segment_kernel`, C entry `pd_segment`). The
// solver around the envy gaps, `repro_torch.kernels.envy.pd_segment_plain`,
// runs `seg` preconditioned PDHG steps of about 15 small torch ops each, so
// on the card a 250-step segment was ~3,750 launches of a few ns of work:
// bound by the host's launch work, not by the card. This kernel runs the
// whole segment, the running sums and the restart to their average in one
// launch, one block per instance. Per step, in the plain version's order:
//
//     AtY[l,j] = (cnt_l p_j + sum_i L[i,l] Wp[i,j]) - (sum_i L[l,i]) Wp[l,j]
//     xn       = max(x + tau (cnt_l Wp[l,j] - AtY), 0);   xb = 2 xn - x
//     E        = envy(Wp, xb) * pairm
//     p        = max(p + sig_cap (sum_l cnt_l xb[l,:] - m), 0)
//     L        = max(L + sig_env_l E, 0) * pairm
//     xs += xn;  ps += p;  Ls += L
//
// and at the end writes (xs, ps, Ls) / seg. The state x, xb, xs (G x k),
// p, ps (k) and L, Ls (G x G), with the operands Wp, tau (G x k), pairm
// (G x G), cnt and sig_env (G), lives in shared memory for the whole
// segment: the operands are read once and the averages written once. A step
// has two barriers: one after the (l, j) phase (AtY, xn, xb; each thread
// forms the two sums over i for its entry, so the row sums of L need no
// phase of their own), one after the (l, i) phase (E and L, with the own
// term formed per entry as the envy kernel forms it, and the column sums
// for p on the last warp). L's rows are padded to G + 1 doubles, so the
// row sums' reads fall in distinct banks. Sums run over i = 0..G-1 and
// j = 0..k-1 in order, every operation rounded on its own as above, with no
// atomics: a second launch repeats the first bit for bit. The sums over i
// start from 0.0, so their loops run G (a power of two) times and unroll by
// 8. Against the plain version (whose L^T Wp and row sums take the BLAS's
// and torch's order) it agrees to a few ulps per step.
//
// Bound: per instance the segment reads its operands and state once and
// writes the averages once, 8 (4 Gk + 3 G^2 + 2G + 3k + 1) bytes. A step
// needs 4 G^2 k FP64 operations in the products L^T Wp and Wp xb^T, which
// the tensor cores could run at 67 TFLOP/s, and 8 G^2 + 15 Gk + 5k more at
// 34 TFLOP/s (L's row sums and own terms once per l); at G = 8, k = 3 and
// 250 steps that is 2.5 KB and 0.41 MFLOP, ~9.4 ns. What bounds it
// is latency: 250 dependent steps of two barriers and a G-long chain of
// dependent adds each, on one SM. Shared memory caps G: 8 (3 G (G + 1) + 5 Gk + 2G + 3k)
// bytes is 184 KB at G = 64, k = 32. At G = 128, L alone takes 128 KB, and
// Ls and pairm would have to move to registers (16 of each per thread at
// 1024 threads, past the 64 registers a thread has there), so the limit is
// kPdMaxG = 64 (PD_FUSED_MAX_G in envy.py); larger G takes the stepwise loop.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;  // output tile edge: kTile * kTile threads a block
constexpr int kMaxK = 32;  // largest device-type count (MAX_K in envy.py)

// grid = (ceil(G / kTile) envied tiles, ceil(G / kTile) envious tiles, B).
__global__ void envy_gaps_kernel(const double* __restrict__ W,
                                 const double* __restrict__ X,
                                 double* __restrict__ E, int G, int k) {
  __shared__ double w_s[kMaxK][kTile];   // W rows of the envious tile
  __shared__ double xl_s[kMaxK][kTile];  // X rows of the envious tile
  __shared__ double xi_s[kMaxK][kTile];  // X rows of the envied tile
  __shared__ double own_s[kTile];

  const int b = blockIdx.z;
  const int l0 = blockIdx.y * kTile;
  const int i0 = blockIdx.x * kTile;
  const double* Wb = W + (size_t)b * G * k;
  const double* Xb = X + (size_t)b * G * k;
  const int tid = threadIdx.y * kTile + threadIdx.x;

  // Stage kTile rows of each operand tile; rows past G read as zero.
  for (int e = tid; e < kTile * k; e += kTile * kTile) {
    const int r = e / k;
    const int j = e - r * k;
    const int l = l0 + r;
    const int i = i0 + r;
    w_s[j][r] = l < G ? Wb[(size_t)l * k + j] : 0.0;
    xl_s[j][r] = l < G ? Xb[(size_t)l * k + j] : 0.0;
    xi_s[j][r] = i < G ? Xb[(size_t)i * k + j] : 0.0;
  }
  __syncthreads();

  if (threadIdx.y == 0) {
    const int r = threadIdx.x;
    double s = __dmul_rn(w_s[0][r], xl_s[0][r]);
    for (int j = 1; j < k; ++j) s = __dadd_rn(s, __dmul_rn(w_s[j][r], xl_s[j][r]));
    own_s[r] = s;
  }
  __syncthreads();

  const int ty = threadIdx.y;
  const int tx = threadIdx.x;
  const int l = l0 + ty;
  const int i = i0 + tx;
  if (l < G && i < G) {
    double s = __dmul_rn(w_s[0][ty], xi_s[0][tx]);
    for (int j = 1; j < k; ++j) s = __dadd_rn(s, __dmul_rn(w_s[j][ty], xi_s[j][tx]));
    E[((size_t)b * G + l) * G + i] = __dsub_rn(s, own_s[ty]);
  }
}

constexpr int kPdMaxG = 64;         // PD_FUSED_MAX_G in envy.py
constexpr int kPdMaxThreads = 1024;
constexpr int kMaxDevices = 64;

// Shared memory of the fused segment, in doubles: L, Ls, pairm (G rows of
// G + 1), Wp, tau, x, xb, xs (G x k), cnt, sig_env (G), p, ps, m (k).
__host__ __device__ constexpr size_t pd_smem_doubles(int G, int k) {
  return 3 * (size_t)G * (G + 1) + 5 * (size_t)G * k + 2 * (size_t)G + 3 * (size_t)k;
}

// torch.clamp_min(v, 0.0): NaN passes through.
__device__ __forceinline__ double clamp0(double v) { return v < 0.0 ? 0.0 : v; }

// grid = (B,): one block per instance; see the header for the step.
__global__ void __launch_bounds__(kPdMaxThreads)
pd_segment_kernel(const double* __restrict__ Wp, const double* __restrict__ cnt,
                  const double* __restrict__ m, const double* __restrict__ pairm,
                  const double* __restrict__ tau, const double* __restrict__ sig_env,
                  const double* __restrict__ sig_cap, const double* __restrict__ x0,
                  const double* __restrict__ p0, const double* __restrict__ L0,
                  double* __restrict__ x_out, double* __restrict__ p_out,
                  double* __restrict__ L_out, int G, int k, int seg) {
  extern __shared__ double sm[];
  const int ld = G + 1;  // padded row of L, Ls, pairm
  const int Gk = G * k;
  const int GG = G * G;
  double* L = sm;
  double* Ls = L + G * ld;
  double* pm = Ls + G * ld;
  double* W = pm + G * ld;
  double* T = W + Gk;
  double* x = T + Gk;
  double* xb = x + Gk;
  double* xs = xb + Gk;
  double* c = xs + Gk;
  double* se = c + G;
  double* p = se + G;
  double* ps = p + k;
  double* mm = ps + k;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int e = tid; e < Gk; e += nt) {
    W[e] = Wp[(size_t)b * Gk + e];
    T[e] = tau[(size_t)b * Gk + e];
    x[e] = x0[(size_t)b * Gk + e];
    xs[e] = 0.0;
  }
  for (int e = tid; e < GG; e += nt) {
    const int l = e / G;
    const int i = e - l * G;
    L[l * ld + i] = L0[(size_t)b * GG + e];
    pm[l * ld + i] = pairm[(size_t)b * GG + e];
    Ls[l * ld + i] = 0.0;
  }
  for (int e = tid; e < G; e += nt) {
    c[e] = cnt[(size_t)b * G + e];
    se[e] = sig_env[(size_t)b * G + e];
  }
  for (int e = tid; e < k; e += nt) {
    p[e] = p0[(size_t)b * k + e];
    ps[e] = 0.0;
    mm[e] = m[(size_t)b * k + e];
  }
  const double sc = sig_cap[b];
  __syncthreads();

  for (int s = 0; s < seg; ++s) {
    // (l, j): AtY, then the primal step and its extrapolation
    for (int e = tid; e < Gk; e += nt) {
      const int l = e / k;
      const int j = e - l * k;
      double lw = 0.0;  // sum_i L[i,l] Wp[i,j]
      double rs = 0.0;  // sum_i L[l,i]
#pragma unroll 8
      for (int i = 0; i < G; ++i) {
        lw = __dadd_rn(lw, __dmul_rn(L[i * ld + l], W[i * k + j]));
        rs = __dadd_rn(rs, L[l * ld + i]);
      }
      const double aty = __dsub_rn(__dadd_rn(__dmul_rn(c[l], p[j]), lw), __dmul_rn(rs, W[e]));
      const double xo = x[e];
      const double xn =
          clamp0(__dadd_rn(xo, __dmul_rn(T[e], __dsub_rn(__dmul_rn(c[l], W[e]), aty))));
      xb[e] = __dsub_rn(__dmul_rn(2.0, xn), xo);
      x[e] = xn;
      xs[e] = __dadd_rn(xs[e], xn);
    }
    __syncthreads();
    // (l, i): the envy gaps at xb and the envy duals
    for (int e = tid; e < GG; e += nt) {
      const int l = e / G;
      const int i = e - l * G;
      const double* wl = W + l * k;
      double own = __dmul_rn(wl[0], xb[l * k]);
      double cross = __dmul_rn(wl[0], xb[i * k]);
#pragma unroll 4
      for (int j = 1; j < k; ++j) {
        own = __dadd_rn(own, __dmul_rn(wl[j], xb[l * k + j]));
        cross = __dadd_rn(cross, __dmul_rn(wl[j], xb[i * k + j]));
      }
      const int at = l * ld + i;
      const double E = __dmul_rn(__dsub_rn(cross, own), pm[at]);
      const double Ln = __dmul_rn(clamp0(__dadd_rn(L[at], __dmul_rn(se[l], E))), pm[at]);
      L[at] = Ln;
      Ls[at] = __dadd_rn(Ls[at], Ln);
    }
    // the capacity duals, on the last warp (idle in the phase above when
    // the block has a warp to spare)
    for (int j = tid - (nt - 32); j >= 0 && j < k; j += 32) {
      double col = 0.0;
#pragma unroll 8
      for (int l = 0; l < G; ++l) col = __dadd_rn(col, __dmul_rn(c[l], xb[l * k + j]));
      const double pn = clamp0(__dadd_rn(p[j], __dmul_rn(sc, __dsub_rn(col, mm[j]))));
      p[j] = pn;
      ps[j] = __dadd_rn(ps[j], pn);
    }
    __syncthreads();
  }

  const double inv = 1.0 / (double)seg;
  for (int e = tid; e < Gk; e += nt) x_out[(size_t)b * Gk + e] = __dmul_rn(xs[e], inv);
  for (int e = tid; e < k; e += nt) p_out[(size_t)b * k + e] = __dmul_rn(ps[e], inv);
  for (int e = tid; e < GG; e += nt) {
    const int l = e / G;
    L_out[(size_t)b * GG + e] = __dmul_rn(Ls[l * ld + (e - l * G)], inv);
  }
}

// Shared memory above 48 KB must be asked for, once per device, before the
// first launch (and so before any CUDA-graph capture): here the most any
// (G, k) in range needs.
cudaError_t allow_pd_smem() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute((const void*)pd_segment_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(8 * pd_smem_doubles(kPdMaxG, kMaxK)));
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 = launched). Nothing is synchronised and nothing is allocated here.
int envy_gaps(const double* W, const double* X, double* E, int B, int G, int k,
              void* stream) {
  if (B < 1 || G < 1 || k < 1 || k > kMaxK || B > 65535)
    return (int)cudaErrorInvalidValue;
  const unsigned tiles = (unsigned)((G + kTile - 1) / kTile);
  if (tiles > 65535u) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles, tiles, (unsigned)B);
  const dim3 block(kTile, kTile);
  envy_gaps_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(W, X, E, G, k);
  return (int)cudaGetLastError();
}

// The fused PD segment over B instances (see the header); same contract.
int pd_segment(const double* Wp, const double* cnt, const double* m,
               const double* pairm, const double* tau, const double* sig_env,
               const double* sig_cap, const double* x, const double* p,
               const double* L, double* x_out, double* p_out, double* L_out, int B,
               int G, int k, int seg, void* stream) {
  if (B < 1 || G < 1 || G > kPdMaxG || k < 1 || k > kMaxK || seg < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_pd_smem();
  if (err != cudaSuccess) return (int)err;
  // a thread per (l, i) or (l, j) entry, and a warp for the capacity duals
  int threads = G * G > G * k ? G * G : G * k;
  threads = (threads + 31) / 32 * 32 + 32;
  threads = threads < kPdMaxThreads ? threads : kPdMaxThreads;
  pd_segment_kernel<<<(unsigned)B, threads, 8 * pd_smem_doubles(G, k),
                      (cudaStream_t)stream>>>(Wp, cnt, m, pairm, tau, sig_env, sig_cap,
                                              x, p, L, x_out, p_out, L_out, G, k, seg);
  return (int)cudaGetLastError();
}

const char* envy_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
