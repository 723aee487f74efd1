// Flash-attention backward, dQ pass, for Hopper (sm_90a), on scalar fp32
// FMAs: on no route (ops/flash_attention.py, OFF_ROUTE).  The route takes
// flash_bwd_dq_tc.cu for bf16 and flash_bwd_dq_f32tc.cu for fp32; this
// kernel is built, held against its plain version and timed beside them as
// their yardstick (chip_smoke.py, SCALAR_TWIN), launched only when named
// through launch_dq's kernel=.
//
// Replaces the TPU kernel horovod_tpu/ops/flash_attention.py:
// _flash_bwd_pallas.kernel_dq (:324-349, with the shared recompute
// _recompute_p_ds, :270-289).  Per query row: rebuild P = exp(S*scale - lse)
// from the forward's logsumexp under the masks, dP = dO V^T,
// delta = rowsum(dO * O), dS = P * (dP - delta), and dQ = dS K * scale.
//
// Design.  One thread block per (z, 64-row Q tile), looping over the
// 32-row K tiles that the masks leave alive (the reference predicate);
// each K/V tile is staged in shared memory as fp32 and the dQ accumulator
// stays in fp32 registers.  delta is computed here from this row's dO and
// O, as the TPU kernel does per tile, not by a separate pass.  Each
// query row is written by its own block, so dQ needs no atomics and is
// the same from run to run.  Ragged tails are masked in the kernel.
//
// What bounds it on the H100.  3 products of 2 * D FLOPs per unmasked
// score against q, k, v, o, dO and lse read once and dQ written once:
// memory bound for tensor-core products, but this version's scalar fp32
// FMAs make it bound by operations (67 TFLOP/s fp32 peak).
#include "flash_common.cuh"

using namespace hvd_flash;

template <typename T, int D>
__global__ void __launch_bounds__(RowSplit<D>::kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const float* __restrict__ lse,
                        const T* __restrict__ dout, T* __restrict__ dq,
                        int S, int h, int hkv, int causal, int window,
                        float scale) {
  using L = RowSplit<D>;
  constexpr int BQ = kBlockRows, BK = kTileRows;
  __shared__ __align__(16) float ks[BK * L::kStride];
  __shared__ __align__(16) float vs[BK * L::kStride];

  const int z = blockIdx.x;
  const int i = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int row = threadIdx.x / L::kSplit;
  const int part = threadIdx.x % L::kSplit;
  const int qpos = i * BQ + row;
  const size_t q_off = (size_t)z * S * D;
  const size_t kv_off = (size_t)kv_row(z, h, hkv) * S * D;

  float qr[L::kDH], dor[L::kDH], acc[L::kDH];
  load_part<T, D>(q + q_off, qpos, S, part, qr);
  load_part<T, D>(dout + q_off, qpos, S, part, dor);
  {
    float orow[L::kDH];
    load_part<T, D>(o + q_off, qpos, S, part, orow);
#pragma unroll
    for (int d = 0; d < L::kDH; ++d) acc[d] = dor[d] * orow[d];
  }
  float delta = 0.f;
#pragma unroll
  for (int d = 0; d < L::kDH; ++d) delta += acc[d];
  delta = sum_parts<D>(delta);
#pragma unroll
  for (int d = 0; d < L::kDH; ++d) acc[d] = 0.f;
  const float lse_r = qpos < S ? lse[(size_t)z * S + qpos] : 0.f;

  const int nk = (S + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    if (!tile_needed(i, j, BQ, BK, causal, window)) continue;  // block-uniform
    __syncthreads();
    stage_tile<T, D, L::kThreads>(k + kv_off, j * BK, BK, S, ks);
    stage_tile<T, D, L::kThreads>(v + kv_off, j * BK, BK, S, vs);
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < BK; ++jj) {
      const float* krow = ks + jj * L::kStride + part * L::kPartStride;
      const float* vrow = vs + jj * L::kStride + part * L::kPartStride;
      const float s = sum_parts<D>(part_dot<D>(qr, krow)) * scale;
      const float dp = sum_parts<D>(part_dot<D>(dor, vrow));
      const bool off = qpos >= S || masked(qpos, j * BK + jj, S, causal, window);
      const float p = off ? 0.f : __expf(s - lse_r);
      part_axpy<D>(acc, p * (dp - delta), krow);
    }
  }
  if (qpos < S) store_part<T, D>(dq + q_off, qpos, part, acc, scale);
}

// Inputs as the forward's, plus o, lse and dout; dq like q.
extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* lse,
                                const void* dout, void* dq, int Z, int S,
                                int D, int h, int hkv, int causal, int window,
                                float scale, int dtype, void* stream) {
  const int tiles = (S + kBlockRows - 1) / kBlockRows;
  const dim3 grid(Z, tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HVD_LAUNCH(T, DD)                                                   \
  flash_bwd_dq_kernel<T, DD><<<grid, RowSplit<DD>::kThreads, 0, st>>>(      \
      static_cast<const T*>(q), static_cast<const T*>(k),                   \
      static_cast<const T*>(v), static_cast<const T*>(o),                   \
      static_cast<const float*>(lse), static_cast<const T*>(dout),          \
      static_cast<T*>(dq), S, h, hkv, causal, window, scale)
  HVD_FLASH_DISPATCH(dtype, D, HVD_LAUNCH);
#undef HVD_LAUNCH
  return (int)cudaGetLastError();
}
