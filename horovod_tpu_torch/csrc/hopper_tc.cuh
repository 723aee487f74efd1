// Hopper (sm_90a) building blocks of the tensor-core flash kernels
// (flash_{fwd,bwd_dkdv,bwd_dq}_tc.cu and _f32tc.cu): mbarriers,
// TMA loads, wgmma descriptors and the bf16 wgmma forms those kernels use,
// fp32 accumulators throughout: m64n64k16 SS (A and B from shared memory;
// every score product, whose N is 64 keys or queries) and m64nNk16 RS (A
// from registers; the products whose N is the head_dim, N in {16, 32, 64}).
//
// Shared-memory tiles.  A bf16 tile is [rows, D], D in {16, 32, 64}
// (BfTile<D>), as TMA writes a box of D columns: rows of 2D bytes (128, 64
// or 32) with the swizzle of the same width, the 16-byte chunk c of row r
// at c ^ (r % 8), c ^ (r / 2 % 4) or c ^ (r / 4 % 2): address bits [4, 7),
// [4, 6) or [4, 5) XOR bits [7, ...).  Tiles start on 1024-byte boundaries
// so the swizzle phase is the address's own.  One descriptor form reads
// such a tile either way, its SBO the 8 rows of a swizzle atom (8 x 2D
// bytes):
//   * K-major (the D columns are the product's depth): rows are M or N; the
//     k-th 16-column slice starts 32 * k bytes into the row (descriptor
//     address + 2 * k), D / 16 slices.
//   * MN-major (the rows are the product's depth, transpose bit set): the D
//     columns are N, one swizzle atom wide; the k-th 16-row slice starts
//     16 * 2D * k bytes on (descriptor address + 2D * k).
// D 16 takes the 32-byte swizzle rather than a 32-column box over a
// 16-column tensor (TMA zero-filling columns 16-31): one layout rule for
// the three widths, and no bytes loaded or multiplied that are zeros.
//
// Accumulator fragment of m64nN (PTX "wgmma D fragment"): thread t of the
// warpgroup, warp w = t / 32, lane l: d[4c + e] is row 16w + l/4 + 8*(e/2),
// column 8c + 2*(l%4) + (e%2).  Rows r and r + 8 of a thread are "its two
// rows"; the four threads l/4 == const share a row.  The RS form's A
// fragment for k-slice kk is the same layout rounded to bf16 pairs:
// {d[8kk+0,1], d[8kk+2,3], d[8kk+4,5], d[8kk+6,7]} (pack_a).
//
// fp32 on the tensor cores (flash_fwd_f32tc.cu, flash_bwd_dkdv_f32tc.cu,
// flash_bwd_dq_f32tc.cu): the .tf32 wgmma shapes m64nNk8, N in {16, 32,
// 64}, three products a product (3xTF32), on F32Tile layouts; see
// "3xTF32" below.
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

// A bf16 tile [rows, D] (see the top): its descriptor and slice steps.
template <int D>
struct BfTile {
  static_assert(D == 16 || D == 32 || D == 64, "BfTile: D in {16, 32, 64}");
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kKSlices = D / 16;  // k16 slices of a K-major depth
  static constexpr uint64_t kDescBits =
      (uint64_t(1) << 16)                          // LBO: unused
      | (uint64_t((8 * kRowBytes) >> 4) << 32)     // SBO: 8-row groups
      | (uint64_t(D == 64 ? 1 : D == 32 ? 2 : 3) << 62);  // 128/64/32 B swizzle
  // what k-slice k adds to the descriptor, in 16-byte units
  static constexpr uint32_t kKStep = 2;           // K-major: 32 bytes on
  static constexpr uint32_t kMNStep = kRowBytes;  // MN-major: 16 rows on
  // descriptor of the 1024-byte-aligned tile at `tile` (its slice 0)
  __device__ static __forceinline__ uint64_t desc(const void* tile) {
    return ((smem_u32(tile) & 0x3FFFF) >> 4) | kDescBits;
  }
};

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
template <int K>
__device__ __forceinline__ void fence_acc(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HVD_WGMMA_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define HVD_WGMMA_D8_OPS(d)                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7])
#define HVD_WGMMA_D16                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HVD_WGMMA_D16_OPS(d)                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

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

// d += A[64x16] * B[16xN], N = 2K (the accumulator's K words a thread:
// N in {16, 32, 64}); A in registers (pack_a), B MN-major in shared memory
// (transpose bit set).
template <int K>
__device__ __forceinline__ void wgmma_rs(float (&d)[K], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (K == 32) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_WGMMA_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : HVD_WGMMA_D32_OPS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  } else if constexpr (K == 16) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HVD_WGMMA_D16
        ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : HVD_WGMMA_D16_OPS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  } else {
    static_assert(K == 8, "N in {16, 32, 64}");
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " HVD_WGMMA_D8
        ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : HVD_WGMMA_D8_OPS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
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

// ---- 3xTF32: fp32 products on the tensor cores ------------------------------
//
// wgmma has no fp32 form.  Its .tf32 form reads 32-bit words as tf32 (10
// mantissa bits), so one product is off by about 2^-11 relative.  An fp32
// operand is split as x = hi + lo: hi is x with its low 13 mantissa bits
// cleared (an exact tf32), x - hi is exact in fp32, and lo is it rounded to
// tf32 (cvt.rna).  a * b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b into
// one fp32 accumulator; the dropped lo_a lo_b is about 2^-22 of |a b|.
// The tensor core reads a .tf32 operand word by truncation: it ignores the
// low 13 bits (the premise of CUTLASS's round_half_ulp_truncate tf32
// conversion).  So the raw fp32 word IS its hi part, and only the lo parts
// are written out (split_lo, split_a).
//
// Registers.  ptxas serializes every wgmma of a kernel (each waits for the
// last) when the accumulators and A fragments of a pipeline stage do not
// fit beside the rest, when some path reads an accumulator while its
// products are in flight, or when an accumulator is left undefined on a
// path that skips its products; the kernels keep stages short and their
// waits unconditional, zero such accumulators first, and an accumulator is
// its own hi A fragment (a_hi).

// Layout.  The .tf32 (like every 32-bit) wgmma operand in shared memory is
// K-major only: there is no transpose bit for 32-bit types, so both
// operands must hold the product's depth contiguous.  F32Tile<ROWS, COLS>
// is a [ROWS, COLS] fp32 tile whose COLS are the depth, stored as COLS / CW
// chunks of [ROWS, CW], CW = min(COLS, 32): rows of 128 bytes with the
// 128-byte swizzle or, at COLS = 16, rows of 64 bytes with the 64-byte
// swizzle, exactly as TMA writes a box of CW columns with the matching
// CU_TENSOR_MAP_SWIZZLE (hvd_map_rows_f32).  The 16-byte chunk c of row r
// lands at c ^ (r % 8) (128-byte rows) or c ^ (r / 2 % 4) (64-byte rows):
// address bits [4, 7) or [4, 6) XOR bits [7, 10).  Chunks start on
// 1024-byte boundaries.  The k-th 8-column (32-byte) slice of the depth is
// chunk k / (CW / 8), 32 * (k % (CW / 8)) bytes into the row; its
// descriptor's SBO is 8 rows (1024 or 512 bytes).
//
// A from registers.  The .tf32 A fragment of k8 (per warp, as mma.m16n8k8
// .tf32's): a0 = (row g, depth t), a1 = (g + 8, t), a2 = (g, t + 4),
// a3 = (g + 8, t + 4), g = lane / 4, t = lane % 4.  An accumulator holds
// columns 8c + 2t and 8c + 2t + 1 of its two rows, not t and t + 4, so the
// columns do not line up.  a_hi / split_a hand depth t the accumulator
// column 8c + 2t and depth t + 4 the column 8c + 2t + 1, and the B tile that
// multiplies it holds key (or query) kappa of each 8-group at depth
// kpos8(kappa).  A sum over the depth does not depend on its order.

template <int ROWS, int COLS>
struct F32Tile {
  static_assert(ROWS % 8 == 0 && (COLS == 16 || COLS % 32 == 0),
                "F32Tile: ROWS a multiple of 8, COLS 16 or a multiple of 32");
  static constexpr int kRows = ROWS;
  static constexpr int kCols = COLS;
  static constexpr int kCW = COLS < 32 ? COLS : 32;  // columns per chunk
  static constexpr int kRowBytes = kCW * 4;           // 128 or 64
  static constexpr int kChunks = COLS / kCW;
  static constexpr int kChunkBytes = ROWS * kRowBytes;
  static constexpr int kBytes = kChunks * kChunkBytes;
  static constexpr int kSlicesPerChunk = kCW / 8;
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 0x70u : 0x30u;
  static constexpr uint64_t kDescBits =
      (uint64_t(1) << 16)                             // LBO: unused
      | (uint64_t((8 * kRowBytes) >> 4) << 32)        // SBO: 8-row groups
      | (uint64_t(kRowBytes == 128 ? 1 : 2) << 62);   // 128 / 64-byte swizzle
  static_assert(kChunkBytes % 1024 == 0, "chunks keep 1024-byte alignment");

  // byte offset of element (r, c) from the tile's start
  __device__ static __forceinline__ uint32_t offset(int r, int c) {
    const uint32_t off = r * kRowBytes + (c % kCW) * 4;
    return (c / kCW) * kChunkBytes + (off ^ ((off >> 3) & kSwizzle));
  }
  // wgmma descriptor of the tile at `tile` (its slice 0)
  __device__ static __forceinline__ uint64_t desc(const uint8_t* tile) {
    return ((smem_u32(tile) & 0x3FFFF) >> 4) | kDescBits;
  }
  // what slice k adds to it: the slice's byte offset in 16-byte units
  __host__ __device__ static constexpr uint32_t slice(int k) {
    return ((k / kSlicesPerChunk) * kChunkBytes +
            (k % kSlicesPerChunk) * 32) >> 4;
  }
};

// Calls f(Int<I>{}), ..., f(Int<N - 1>{}): a loop whose index is a
// constant expression (for the slice offsets below).
template <int K>
struct Int {
  static constexpr int value = K;
};
template <int I, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(Int<I>{});
    static_for<I + 1, N>(f);
  }
}

// lo part of x (its hi part is x itself, read by truncation)
__device__ __forceinline__ float tf32_lo(float x) {
  const float hi = __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x - hi));
  return __uint_as_float(y);
}
__device__ __forceinline__ float4 tf32_lo(float4 x) {
  return make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
}

// depth position, in its 8-group, of key (or query) kappa of a B tile that
// an A from split_a multiplies
__device__ __forceinline__ int kpos8(int kappa) {
  return (kappa >> 1) | ((kappa & 1) << 2);
}

// The k8 A fragments of a 64xN accumulator d (slice c = columns
// 8c..8c+7): hi of slice c is d's own words (a_hi), lo is split_a's.
template <int N>
__device__ __forceinline__ void a_hi(const float (&d)[N / 2], int c,
                                     uint32_t (&hi)[4]) {
  hi[0] = __float_as_uint(d[4 * c]);
  hi[1] = __float_as_uint(d[4 * c + 2]);
  hi[2] = __float_as_uint(d[4 * c + 1]);
  hi[3] = __float_as_uint(d[4 * c + 3]);
}
template <int N>
__device__ __forceinline__ void split_a(const float (&d)[N / 2],
                                        uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    uint32_t hi[4];
    a_hi<N>(d, c, hi);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      lo[c][r] = __float_as_uint(tf32_lo(__uint_as_float(hi[r])));
  }
}

// The k8 A fragments of rows [16w, 16w + 16) of a [64, COLS] F32Tile
// (warp w of the warpgroup), slice k, hi (the raw words) and lo: depth t
// is column 8k + t, the order of a B tile's own rows.
template <class Tile>
__device__ __forceinline__ void load_a(const uint8_t* tile, int warp,
                                       int lane, int k, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int r = 16 * warp + lane / 4, c = 8 * k + lane % 4;
  const int rr[4] = {r, r + 8, r, r + 8}, cc[4] = {c, c, c + 4, c + 4};
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float v =
        *reinterpret_cast<const float*>(tile + Tile::offset(rr[x], cc[x]));
    hi[x] = __float_as_uint(v);
    lo[x] = __float_as_uint(tf32_lo(v));
  }
}

// Write the lo part of a raw fp32 tile to `lo` (same layout, so any 16-byte
// chunk maps to itself); kN threads, thread `tid`.
template <class Tile, int kN>
__device__ __forceinline__ void split_lo(const uint8_t* raw, uint8_t* lo,
                                         int tid) {
#pragma unroll
  for (int it = 0; it < (Tile::kBytes + 16 * kN - 1) / (16 * kN); ++it) {
    const int x = (tid + it * kN) * 16;
    if (Tile::kBytes % (16 * kN) == 0 || x < Tile::kBytes)
      *reinterpret_cast<float4*>(lo + x) =
          tf32_lo(*reinterpret_cast<const float4*>(raw + x));
  }
}

// Write the transpose of a [R, C] tile `src` (Tile = F32Tile<R, C>), hi
// (the raw words) and lo, as F32Tile<C, R> tiles, row r of src going to
// column (r & ~7) | kpos8(r & 7).  A thread takes 4 x 4 blocks: the rows
// of one parity p in an 8-row group g (8g + p, + 2, + 4, + 6, which land
// on the 4 adjacent columns 8g + 4p ..) by 4 columns, read as 4 float4 and
// written as 4 float4 rows of the transpose.  Lanes 0-7 of a block of 8
// vary p and the 4 lowest column quads: 2-way bank conflicts on both the
// reads and the writes, for a quarter of the store instructions of a
// scalar transpose.
template <class Tile, int kN>
__device__ __forceinline__ void transpose_split(const uint8_t* src,
                                                uint8_t* thi, uint8_t* tlo,
                                                int tid) {
  using T = F32Tile<Tile::kCols, Tile::kRows>;
  constexpr int kG = Tile::kRows / 8;     // row groups
  constexpr int kQuads = Tile::kCols / 4;  // column quads
  constexpr int kLowQuads = kQuads < 4 ? kQuads : 4;
  constexpr int kUnits = 2 * kG * kQuads;
  static_assert((kG & (kG - 1)) == 0 && (kQuads & (kQuads - 1)) == 0,
                "powers of two");
#pragma unroll 2
  for (int x = tid; x < kUnits; x += kN) {
    const int p = x & 1;
    const int ql = (x >> 1) % kLowQuads;
    const int rest = (x >> 1) / kLowQuads;
    const int g = rest % kG;
    const int q4 = ql + kLowQuads * (rest / kG);
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = *reinterpret_cast<const float4*>(
          src + Tile::offset(8 * g + 2 * u + p, 4 * q4));
    const float4 rows[4] = {make_float4(v[0].x, v[1].x, v[2].x, v[3].x),
                            make_float4(v[0].y, v[1].y, v[2].y, v[3].y),
                            make_float4(v[0].z, v[1].z, v[2].z, v[3].z),
                            make_float4(v[0].w, v[1].w, v[2].w, v[3].w)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t off = T::offset(4 * q4 + e, 8 * g + 4 * p);
      *reinterpret_cast<float4*>(thi + off) = rows[e];
      *reinterpret_cast<float4*>(tlo + off) = tf32_lo(rows[e]);
    }
  }
}

// Order this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma operand reads, TMA writes) of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` over the first `threads` threads of the block.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// TMA load of an F32Tile from a hvd_map_rows_f32 map: one box per chunk,
// rows from `row` of slab `z`.
template <class Tile>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst,
                                              const CUtensorMap* map,
                                              int row, int z,
                                              uint64_t* bar) {
#pragma unroll
  for (int c = 0; c < Tile::kChunks; ++c)
    tma_load_3d(dst + c * Tile::kChunkBytes, map, c * Tile::kCW, row, z,
                bar);
}

// The .tf32 wgmma forms.  Descriptors come in as a tile's base descriptor
// and a slice offset, added inside the asm as an immediate: with one
// precomputed descriptor per slice, ptxas kept dozens of 64-bit values
// live across the loop and serialized every wgmma of the dK/dV kernel
// for want of registers.
//
// d (+)= A[64x8] * B[8xN], A and B K-major F32Tile slices in shared
// memory (descriptors a + OA, b + OB); accumulate == 0 overwrites d.
template <int N, uint32_t OA, uint32_t OB>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t a,
                                              uint64_t b, int accumulate) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n .reg .pred p;\n .reg .b64 da, db;\n add.s64 da, %32, %35;\n"
        " add.s64 db, %33, %36;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " HVD_WGMMA_D32
        ", da, db, p, 1, 1;\n}\n"
        : HVD_WGMMA_D32_OPS(d)
        : "l"(a), "l"(b), "r"(accumulate), "n"(OA), "n"(OB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n .reg .pred p;\n .reg .b64 da, db;\n add.s64 da, %16, %19;\n"
        " add.s64 db, %17, %20;\n setp.ne.b32 p, %18, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " HVD_WGMMA_D16
        ", da, db, p, 1, 1;\n}\n"
        : HVD_WGMMA_D16_OPS(d)
        : "l"(a), "l"(b), "r"(accumulate), "n"(OA), "n"(OB));
  } else {
    static_assert(N == 16, "N in {16, 32, 64}");
    asm volatile(
        "{\n .reg .pred p;\n .reg .b64 da, db;\n add.s64 da, %8, %11;\n"
        " add.s64 db, %9, %12;\n setp.ne.b32 p, %10, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 " HVD_WGMMA_D8
        ", da, db, p, 1, 1;\n}\n"
        : HVD_WGMMA_D8_OPS(d)
        : "l"(a), "l"(b), "r"(accumulate), "n"(OA), "n"(OB));
  }
}

// d += A[64x8] * B[8xN], A in registers (a_hi / split_a), B a K-major
// F32Tile slice in shared memory (descriptor b + OB).
template <int N, uint32_t OB>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n .reg .pred p;\n .reg .b64 db;\n add.s64 db, %36, %37;\n"
        " setp.ne.b32 p, %38, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " HVD_WGMMA_D32
        ", {%32, %33, %34, %35}, db, p, 1, 1;\n}\n"
        : HVD_WGMMA_D32_OPS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(OB),
          "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n .reg .pred p;\n .reg .b64 db;\n add.s64 db, %20, %21;\n"
        " setp.ne.b32 p, %22, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " HVD_WGMMA_D16
        ", {%16, %17, %18, %19}, db, p, 1, 1;\n}\n"
        : HVD_WGMMA_D16_OPS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(OB),
          "r"(1));
  } else {
    static_assert(N == 16, "N in {16, 32, 64}");
    asm volatile(
        "{\n .reg .pred p;\n .reg .b64 db;\n add.s64 db, %12, %13;\n"
        " setp.ne.b32 p, %14, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 " HVD_WGMMA_D8
        ", {%8, %9, %10, %11}, db, p, 1, 1;\n}\n"
        : HVD_WGMMA_D8_OPS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(OB),
          "r"(1));
  }
}

// The three products of slice K: d (+)= A * B with A = (hi tile a, lo
// tile al) and B = (b, bl), F32Tile base descriptors of tiles TA and TB.
template <int N, class TA, class TB, int K>
__device__ __forceinline__ void wgmma_3xtf32_ss(float (&d)[N / 2],
                                                uint64_t a, uint64_t al,
                                                uint64_t b, uint64_t bl) {
  constexpr uint32_t oa = TA::slice(K), ob = TB::slice(K);
  wgmma_tf32_ss<N, oa, ob>(d, al, b, K != 0);
  wgmma_tf32_ss<N, oa, ob>(d, a, bl, 1);
  wgmma_tf32_ss<N, oa, ob>(d, a, b, 1);
}
// ... with A = (a_hi, a_lo) in registers.
template <int N, class TB, int K>
__device__ __forceinline__ void wgmma_3xtf32_rs(float (&d)[N / 2],
                                                const uint32_t (&a_hi)[4],
                                                const uint32_t (&a_lo)[4],
                                                uint64_t b, uint64_t bl) {
  constexpr uint32_t ob = TB::slice(K);
  wgmma_tf32_rs<N, ob>(d, a_lo, b);
  wgmma_tf32_rs<N, ob>(d, a_hi, bl);
  wgmma_tf32_rs<N, ob>(d, a_hi, b);
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

// 3-D map over a contiguous bf16 [Z, S, D] array, D in {16, 32, 64}, whose
// boxes are BfTile<D> tiles: `rows` x D, the swizzle of a 2D-byte row
// (128, 64 or 32 bytes).  Rows past S of a box are zero-filled: the map's
// second dimension ends at S, so a ragged tile never reads the next z's
// rows.
static bool hvd_map_rows(CUtensorMap* map, const void* base, int Z, int S,
                         int D, int rows) {
  hvd_encode_tiled_fn encode = hvd_encode_tiled();
  if (encode == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) ||
      (D != 16 && D != 32 && D != 64))
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)Z};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)S * D * 2};  // bytes
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 3-D map over a contiguous fp32 [Z, S, D] array, D in {16, 32, 64}, whose
// boxes are the chunks of an F32Tile<rows, D>: `rows` x min(D, 32) columns,
// 128-byte swizzle (64-byte at D = 16).  Rows past S are zero-filled.
static bool hvd_map_rows_f32(CUtensorMap* map, const void* base, int Z,
                             int S, int D, int rows) {
  hvd_encode_tiled_fn encode = hvd_encode_tiled();
  if (encode == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) ||
      (D != 16 && D != 32 && D != 64))
    return false;
  const cuuint32_t cw = D < 32 ? D : 32;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)Z};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4,
                                 (cuuint64_t)S * D * 4};  // bytes
  const cuuint32_t box[3] = {cw, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                cw == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
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
