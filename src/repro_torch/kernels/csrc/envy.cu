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

const char* envy_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
