// Hopper (sm_90a) building blocks in inline PTX, for kernels that move tiles
// with the Tensor Memory Accelerator (TMA) and multiply them with warpgroup
// matrix multiplies (wgmma):
//
//   - mbarriers: init, an arrival with an expected transaction count,
//     and a parity wait;
//   - TMA: a 3-D tile load from global into shared memory that completes on
//     an mbarrier, a 3-D tile store back with its bulk-group commit and
//     wait, and the host-side tensor-map encoders (flash attention's
//     swizzled bf16 one and a general unswizzled one), reached through the
//     runtime's driver entry point so the library needs no -lcuda;
//   - wgmma: fence / commit / wait, the shared-memory matrix descriptor for
//     the 128-byte swizzle that TMA writes, and m64n64k16 bf16 products with
//     float32 accumulators, A from shared memory (SS) or from registers (RS);
//   - a register fence that keeps the compiler from moving accumulator
//     reads across an asynchronous wgmma.
//
// wgmma exists only for the sm_90a target.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and to the
// other threads once a __syncthreads follows.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` has completed. A fresh barrier is
// in phase 0, so a wait for parity 1 passes at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ---------------------------------------------------------------------

// Orders this thread's earlier shared-memory accesses (generic proxy) before
// its later TMA copies (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Copies the box at element coordinates (c0, c1, c2) of `map` into `dst`
// (shared memory, 1024-byte aligned for the 128-byte swizzle) and counts its
// bytes on `bar`. Coordinates past the tensor's edge read as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Copies the box at element coordinates (c0, c1, c2) of `map` from `src`
// (shared memory) to global memory; elements past the tensor's edge are not
// written. The copy joins this thread's open bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Closes this thread's open bulk group of TMA stores.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until at most kPending of this thread's bulk groups still read their
// shared memory (the source may then be overwritten).
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kPending) : "memory");
}

// Waits until at most kPending of this thread's bulk groups are incomplete.
template <int kPending>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(kPending) : "memory");
}

// ---- wgmma ---------------------------------------------------------------------

// Pins a register in place around asynchronous wgmma: the compiler may not
// move reads or writes of `r` across this point.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint64_t& r) {
  asm volatile("" : "+l"(r)::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// Shared-memory matrix descriptor for a tile that TMA wrote with the 128-byte
// swizzle: rows of 128 bytes, 8-row atoms of 1024 bytes. `addr` is the shared
// address of the operand's first element; the leading and stride byte
// offsets are in bytes (stored in 16-byte units). Layout type 1 = 128B swizzle.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

#define HOPPER_ACC32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),           \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),           \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),           \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define HOPPER_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31}"

// d (64 x 64, float32) = A B + (kAccumulate ? d : 0), A (64 x 16) and B
// (16 x 64) bf16 in shared memory, both K-major (the 16-wide reduction
// dimension contiguous). d's fragment: thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1).
template <int kAccumulate>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
               ", %32, %33, %34, 1, 1, 0, 0;\n"
               : HOPPER_ACC32(d)
               : "l"(desc_a), "l"(desc_b), "n"(kAccumulate));
}

// d (64 x 64, float32) += A B, A (64 x 16) bf16 in registers (a[0..3]: the
// same fragment as d's, two bf16 a register, low half the lower column) and
// B (16 x 64) bf16 in shared memory, MN-major (the 64-wide N dimension
// contiguous; the transpose bit is set).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tn(float (&d)[32],
                                                      const uint32_t* a,
                                                      uint64_t desc_b) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
               ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
               : HOPPER_ACC32(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

#undef HOPPER_ACC32
#undef HOPPER_D32

// ---- host: tensor maps -----------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a contiguous bf16 array of shape (n2, n1, n0), innermost
// n0 (n0 % 8 == 0, base 16-byte aligned), with boxes of 64 x rows x 1
// elements written to shared memory in the 128-byte swizzle. Out-of-range
// elements read as zeros.
inline CUresult tensor_map_bf16_3d(CUtensorMap* map, const void* base, uint64_t n0,
                                   uint64_t n1, uint64_t n2, uint32_t rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {n0 * 2, n1 * n0 * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {64, rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A tensor map over a contiguous float32 or bf16 array of shape (n2, n1, n0),
// innermost n0 (n0 x the element's bytes a multiple of 16, base 16-byte
// aligned), with boxes of box0 x box1 x 1 elements laid out in shared memory
// row after row, unswizzled (box0 x the element's bytes a multiple of 16).
// Out-of-range elements read as zeros and are skipped by a store.
inline CUresult tensor_map_3d(CUtensorMap* map, CUtensorMapDataType type,
                              const void* base, uint64_t n0, uint64_t n1, uint64_t n2,
                              uint32_t box0, uint32_t box1) {
  uint64_t elem = 0;
  if (type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32) elem = 4;
  if (type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) elem = 2;
  if (elem == 0) return CUDA_ERROR_INVALID_VALUE;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {n0 * elem, n1 * n0 * elem};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace hopper
