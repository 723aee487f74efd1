// Hopper (sm_90a) building blocks of the tensor-core flash kernels
// (flash_fwd_tc.cu, flash_bwd_dkdv_tc.cu, flash_bwd_dq_tc.cu): mbarriers,
// TMA loads, wgmma descriptors and the one wgmma shape the three kernels
// use, m64n64k16 bf16 with fp32 accumulators, in its SS form (A and B from
// shared memory) and its RS form (A from registers).
//
// Shared-memory tiles.  Every bf16 tile is [rows, 64] with 128-byte rows,
// written by TMA with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row
// r lands at chunk c ^ (r % 8), in 1024-byte atoms of 8 rows.  Tiles start
// on 1024-byte boundaries so the swizzle phase is the address's own.  One
// descriptor form reads such a tile either way:
//   * K-major (the 64 columns are the product's depth): rows are M or N,
//     8-row groups 1024 bytes apart (SBO); the k-th 16-column slice starts
//     32 * k bytes into the row (descriptor address + 2 * k).
//   * MN-major (the rows are the product's depth, transpose bit set): the 64
//     columns are N, one swizzle atom wide; the k-th 16-row slice starts
//     2048 * k bytes on (descriptor address + 128 * k), and 8-row groups are
//     1024 bytes apart (SBO).
//
// Accumulator fragment of m64nN (PTX "wgmma D fragment"): thread t of the
// warpgroup, warp w = t / 32, lane l: d[4c + e] is row 16w + l/4 + 8*(e/2),
// column 8c + 2*(l%4) + (e%2).  Rows r and r + 8 of a thread are "its two
// rows"; the four threads l/4 == const share a row.  The RS form's A
// fragment for k-slice kk is the same layout rounded to bf16 pairs:
// {d[8kk+0,1], d[8kk+2,3], d[8kk+4,5], d[8kk+6,7]} (pack_a).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hvd_tc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and announce `bytes` of TMA traffic for the current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// counts its (nonexistent) phase of parity 1 as complete, so a producer's
// first wait on an empty slot, with parity 1, passes at once.  A wait
// that lasts 10 s is a lost arrival: trap, so the launch fails with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(addr, parity)) {
    if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

// ---- TMA -------------------------------------------------------------------

// Box of a 3-D tensor map at coordinates (c0, c1, c2), innermost first, into
// shared memory; completes `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// Plain bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a 1024-byte-aligned SWIZZLE_128B bf16 tile (see the top).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4)          // start address, 16-byte units
         | (uint64_t(1) << 16)            // LBO: unused by these layouts
         | (uint64_t(1024 >> 4) << 32)    // SBO: 8-row groups 1024 B apart
         | (uint64_t(1) << 62);           // layout: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching accumulator registers across the
// asynchronous product (reads are ordered after the wait by this).
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HVD_WGMMA_D32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HVD_WGMMA_D32_OPS(d)                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (+)= A[64x16] * B[16x64]; A and B K-major in shared memory.
// accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HVD_WGMMA_D32_OPS(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A[64x16] * B[16x64]; A in registers (pack_a), B MN-major in shared
// memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HVD_WGMMA_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments (4 k-slices of 16) of a 64x64 accumulator, rounded to bf16.
__device__ __forceinline__ void pack_a(const float (&d)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Round a generic pointer into dynamic shared memory up to 1024 bytes.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

}  // namespace hvd_tc

// ---- host: tensor maps -----------------------------------------------------

typedef CUresult (*hvd_encode_tiled_fn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver PyTorch has already loaded (no
// link-time dependency on libcuda).
static hvd_encode_tiled_fn hvd_encode_tiled() {
  static hvd_encode_tiled_fn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    if (lib != nullptr)
      fn = reinterpret_cast<hvd_encode_tiled_fn>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// 3-D map over a contiguous bf16 [Z, S, 64] array, boxes of `rows` x 64,
// 128-byte swizzle.  Rows past S of a box are zero-filled: the map's second
// dimension ends at S, so a ragged tile never reads the next z's rows.
static bool hvd_map_rows(CUtensorMap* map, const void* base, int Z, int S,
                         int rows) {
  hvd_encode_tiled_fn encode = hvd_encode_tiled();
  if (encode == nullptr || (reinterpret_cast<uintptr_t>(base) & 15))
    return false;
  const cuuint64_t dims[3] = {64, (cuuint64_t)S, (cuuint64_t)Z};
  const cuuint64_t strides[2] = {64 * 2, (cuuint64_t)S * 64 * 2};  // bytes
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

// Allow `bytes` of dynamic shared memory for `kernel`, once per device (the
// attribute belongs to the device's context); `done` is the caller's flag
// array for this kernel.
template <typename Kernel>
static cudaError_t hvd_allow_smem(Kernel kernel, int bytes,
                                  bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}
