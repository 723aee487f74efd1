// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel horovod_tpu/ops/flash_attention.py:
// _flash_fwd_kernel (its inner `kernel`, :158-207).  Computes, per folded
// row z and query position, the online softmax of S = (Q * scale) K^T over
// the K tiles the causal/window masks leave alive, and writes
// O = acc / l in the input type and lse = m + log(l) in fp32.
//
// Design.  One thread block per (z, 64-row Q tile); a loop inside the
// block over 32-row K tiles replaces the TPU grid's sequential K axis.  Each
// K/V tile is staged in shared memory as fp32; m, l and the fp32
// accumulator stay in registers.  K tiles entirely above the diagonal or
// outside the window band are skipped, not just masked (tile_needed, the
// reference's predicate).  Ragged tails are masked in the kernel, so the
// tiles need not divide S.  Query tiles are issued last-first so the
// longest causal rows start first.
//
// What bounds it on the H100.  The work is two chained products
// (4 * D FLOPs per unmasked score) over q, k, v read once and o written
// once: at D = 64 that is about 128 FLOPs per byte moved, under the
// card's bf16 ridge of about 295, so the tensor-core version would be
// memory bound.  This version does its products as scalar fp32 FMAs
// (67 TFLOP/s peak, not 989), so it is bound by those operations.
//
// On no route: flash_fwd_tc.cu takes bf16 at every head_dim and
// flash_fwd_f32tc.cu fp32.  It stays built, held against the plain
// version, as the scalar yardstick the tensor-core forwards are timed
// against (chip_smoke.py, the speedup gate), launched only when named.
#include "flash_common.cuh"

using namespace hvd_flash;

template <typename T, int D>
__global__ void __launch_bounds__(RowSplit<D>::kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int h, int hkv,
                     int causal, int window, float scale) {
  using L = RowSplit<D>;
  constexpr int BQ = kBlockRows, BK = kTileRows;
  __shared__ __align__(16) float ks[BK * L::kStride];
  __shared__ __align__(16) float vs[BK * L::kStride];

  const int z = blockIdx.x;
  const int i = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int row = threadIdx.x / L::kSplit;
  const int part = threadIdx.x % L::kSplit;
  const int qpos = i * BQ + row;
  const T* qz = q + (size_t)z * S * D;
  const size_t kv_off = (size_t)kv_row(z, h, hkv) * S * D;

  float qr[L::kDH], acc[L::kDH];
  load_part<T, D>(qz, qpos, S, part, qr);
#pragma unroll
  for (int d = 0; d < L::kDH; ++d) {
    qr[d] *= scale;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const int nk = (S + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    if (!tile_needed(i, j, BQ, BK, causal, window)) continue;  // block-uniform
    __syncthreads();  // the previous tile is consumed
    stage_tile<T, D, L::kThreads>(k + kv_off, j * BK, BK, S, ks);
    stage_tile<T, D, L::kThreads>(v + kv_off, j * BK, BK, S, vs);
    __syncthreads();

    float s[BK];
    float m_tile = kNegInf;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      const float x = sum_parts<D>(
          part_dot<D>(qr, ks + jj * L::kStride + part * L::kPartStride));
      s[jj] = masked(qpos, j * BK + jj, S, causal, window) ? kNegInf : x;
      m_tile = fmaxf(m_tile, s[jj]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float corr = __expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < L::kDH; ++d) acc[d] *= corr;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      const float p = __expf(s[jj] - m_new);
      l += p;
      part_axpy<D>(acc, p, vs + jj * L::kStride + part * L::kPartStride);
    }
    m = m_new;
  }

  if (qpos < S) {
    T* oz = o + (size_t)z * S * D + (size_t)qpos * D + part * L::kDH;
#pragma unroll
    for (int d = 0; d < L::kDH; ++d) oz[d] = from_float<T>(acc[d] / l);
    if (part == 0) lse[(size_t)z * S + qpos] = m + logf(l);
  }
}

// q [Z, S, D]; k, v [Z / h * hkv, S, D]; o like q; lse [Z, S] fp32.
// window <= 0: no window.  Returns the launch's cudaGetLastError().
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int Z, int S, int D, int h,
                             int hkv, int causal, int window, float scale,
                             int dtype, void* stream) {
  const int tiles = (S + kBlockRows - 1) / kBlockRows;
  const dim3 grid(Z, tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HVD_LAUNCH(T, DD)                                                   \
  flash_fwd_kernel<T, DD><<<grid, RowSplit<DD>::kThreads, 0, st>>>(         \
      static_cast<const T*>(q), static_cast<const T*>(k),                   \
      static_cast<const T*>(v), static_cast<T*>(o),                         \
      static_cast<float*>(lse), S, h, hkv, causal, window, scale)
  HVD_FLASH_DISPATCH(dtype, D, HVD_LAUNCH);
#undef HVD_LAUNCH
  return (int)cudaGetLastError();
}
