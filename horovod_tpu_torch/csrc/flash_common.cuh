// Shared pieces of the flash-attention kernels: the scalar ones
// (flash_fwd.cu, flash_bwd_dkdv.cu, flash_bwd_dq.cu) use all of it, the
// tensor-core ones (flash_{fwd,bwd_dkdv,bwd_dq}_tc.cu and _f32tc.cu)
// kNegInf, kv_row, tile_needed, masked and the dtype codes.
//
// Layout: folded [Z, S, D] row-major, contiguous.  Z = batch * heads for
// q/o/dq and batch * kv_heads for k/v/dk/dv; kv_row() routes a q row to
// its kv row (GQA/MQA) exactly like the reference's _kv_row.
//
// Arithmetic: scalar fp32 FMA on values widened from the input type
// (fp32 or bf16).  Each sequence row is owned by kSplit adjacent threads
// that hold kDH = min(D, 32) of its D values in registers; a dot product
// over D is kDH FMAs per thread plus one warp shuffle.  Tiles staged in
// shared memory are read by every thread of the block at the same row, so
// those reads are broadcasts; the kSplit parts of a row are kPad floats
// apart so the parts land in different banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvd_flash {

// The reference's NEG_INF (float32 min / 2): a finite "minus infinity".
// exp(NEG_INF - m) is 0 for a finite m and NEG_INF - NEG_INF is 0, so a
// row whose first visited tile is fully masked is repaired by the next
// rescale exactly as in the reference recurrence.
constexpr float kNegInf = -1.7014117331926443e38f;

// Rows of q (forward, dq) or of k/v (dk/dv) that one thread block owns.
constexpr int kBlockRows = 64;
// Rows of the streamed tile: keys in the forward and dq passes, queries in
// the dk/dv pass.
constexpr int kTileRows = 32;

template <int D>
struct RowSplit {
  static_assert(D == 16 || D == 32 || D == 64, "head_dim must be 16, 32 or 64");
  static constexpr int kDH = D < 32 ? D : 32;        // values per thread
  static constexpr int kSplit = D / kDH;             // threads per row
  static constexpr int kPad = kSplit > 1 ? 4 : 0;    // floats between parts
  static constexpr int kPartStride = kDH + kPad;     // floats
  static constexpr int kStride = kSplit * kPartStride;  // floats per smem row
  static constexpr int kThreads = kBlockRows * kSplit;
};

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
  return __float2bfloat16(x);
}

// q row (b*h + head) -> kv row (b*hkv + head / group); reference _kv_row.
__device__ __forceinline__ int kv_row(int z, int h, int hkv) {
  return (z / h) * hkv + (z % h) / (h / hkv);
}

// Whether the (q tile i of bq rows, k tile j of bk rows) pair holds any
// unmasked score.  The reference's predicates, flash_attention.py:171-175
// (forward), :304-308 (dk/dv) and :333-337 (dq), in one form.  window <= 0
// means no window.
__device__ __forceinline__ bool tile_needed(int i, int j, int bq, int bk,
                                            bool causal, int window) {
  bool need = !causal || (j * bk <= (i + 1) * bq - 1);
  if (window > 0) need = need && ((j + 1) * bk - 1 >= i * bq - (window - 1));
  return need;
}

// Element mask: keys past the ragged tail, above the diagonal, or outside
// the window band.
__device__ __forceinline__ bool masked(int qpos, int kpos, int S, bool causal,
                                       int window) {
  if (kpos >= S) return true;
  if (causal && kpos > qpos) return true;
  if (window > 0 && kpos < qpos - (window - 1)) return true;
  return false;
}

// This thread's part of row `pos` of a [S, D] slab, widened to fp32;
// zeros past the ragged tail.
template <typename T, int D>
__device__ __forceinline__ void load_part(const T* __restrict__ slab, int pos,
                                          int S, int part,
                                          float (&out)[RowSplit<D>::kDH]) {
  using L = RowSplit<D>;
  const T* src = slab + (size_t)pos * D + part * L::kDH;
#pragma unroll
  for (int d = 0; d < L::kDH; ++d) out[d] = pos < S ? to_float(src[d]) : 0.f;
}

template <typename T, int D>
__device__ __forceinline__ void store_part(T* __restrict__ slab, int pos,
                                           int part, const float* vals,
                                           float mul) {
  using L = RowSplit<D>;
  T* dst = slab + (size_t)pos * D + part * L::kDH;
#pragma unroll
  for (int d = 0; d < L::kDH; ++d) dst[d] = from_float<T>(vals[d] * mul);
}

// Copy rows [row0, row0 + rows) of a [S, D] slab into shared memory as
// fp32 in the split layout; rows past the ragged tail are zero.
template <typename T, int D, int kNumThreads>
__device__ __forceinline__ void stage_tile(const T* __restrict__ slab,
                                           int row0, int rows, int S,
                                           float* __restrict__ dst) {
  using L = RowSplit<D>;
  for (int idx = threadIdx.x; idx < rows * D; idx += kNumThreads) {
    const int r = idx / D, d = idx % D;
    const int g = row0 + r;
    const float x = g < S ? to_float(slab[(size_t)g * D + d]) : 0.f;
    dst[r * L::kStride + (d / L::kDH) * L::kPartStride + d % L::kDH] = x;
  }
}

// Partial dot product of this thread's registers with its part of a
// staged row (float4 broadcast reads).
template <int D>
__device__ __forceinline__ float part_dot(const float (&a)[RowSplit<D>::kDH],
                                          const float* __restrict__ row) {
  using L = RowSplit<D>;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < L::kDH; d += 4) {
    const float4 b = *reinterpret_cast<const float4*>(row + d);
    acc = fmaf(a[d], b.x, acc);
    acc = fmaf(a[d + 1], b.y, acc);
    acc = fmaf(a[d + 2], b.z, acc);
    acc = fmaf(a[d + 3], b.w, acc);
  }
  return acc;
}

// acc += w * (this thread's part of a staged row).
template <int D>
__device__ __forceinline__ void part_axpy(float (&acc)[RowSplit<D>::kDH],
                                          float w,
                                          const float* __restrict__ row) {
  using L = RowSplit<D>;
#pragma unroll
  for (int d = 0; d < L::kDH; d += 4) {
    const float4 b = *reinterpret_cast<const float4*>(row + d);
    acc[d] = fmaf(w, b.x, acc[d]);
    acc[d + 1] = fmaf(w, b.y, acc[d + 1]);
    acc[d + 2] = fmaf(w, b.z, acc[d + 2]);
    acc[d + 3] = fmaf(w, b.w, acc[d + 3]);
  }
}

// Sum a per-part value over the kSplit adjacent threads of one row.
template <int D>
__device__ __forceinline__ float sum_parts(float x) {
#pragma unroll
  for (int off = RowSplit<D>::kSplit / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace hvd_flash

// The C interface's dtype codes (flash_attention.py passes them).
#define HVD_FLASH_F32 0
#define HVD_FLASH_BF16 1

// Instantiate LAUNCH(T, D) for the dtype code and head_dim, or return
// cudaErrorInvalidValue for a combination the kernels do not take.
#define HVD_FLASH_DISPATCH(dtype, D, LAUNCH)                        \
  do {                                                              \
    if ((dtype) == HVD_FLASH_F32) {                                 \
      if ((D) == 16) { LAUNCH(float, 16); }                         \
      else if ((D) == 32) { LAUNCH(float, 32); }                    \
      else if ((D) == 64) { LAUNCH(float, 64); }                    \
      else return (int)cudaErrorInvalidValue;                       \
    } else if ((dtype) == HVD_FLASH_BF16) {                         \
      if ((D) == 16) { LAUNCH(__nv_bfloat16, 16); }                 \
      else if ((D) == 32) { LAUNCH(__nv_bfloat16, 32); }            \
      else if ((D) == 64) { LAUNCH(__nv_bfloat16, 64); }            \
      else return (int)cudaErrorInvalidValue;                       \
    } else {                                                        \
      return (int)cudaErrorInvalidValue;                            \
    }                                                               \
  } while (0)
