// Flash-attention backward, dK/dV pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel horovod_tpu/ops/flash_attention.py:
// _flash_bwd_pallas.kernel_dkdv (:291-322, with the shared recompute
// _recompute_p_ds, :270-289).  Per key row: over every (q head of its GQA
// group, query row) the masks leave alive, rebuild P = exp(S*scale - lse),
// dP = dO V^T, delta = rowsum(dO * O), dS = P * (dP - delta), and
// accumulate dV += P^T dO and dK += dS^T Q * scale in fp32.
//
// Design.  One thread block per (kv row, 64-row K tile).  Its K and V rows
// and their dK/dV accumulators stay in registers; a loop inside the block
// over (q head in group, 32-row Q tile) stages Q and dO tiles in shared
// memory with their lse and delta = rowsum(dO * O) for the tile's rows
// (recomputed per tile, as the TPU kernel does).  The whole GQA group
// folds into one kv row inside one block, so dK/dV need no atomics and are
// the same from run to run.  Q tiles entirely past the diagonal or outside
// the window band are skipped (the reference predicate); ragged tails are
// masked in the kernel.  Key tiles are issued first-first: under a causal
// mask the first key tiles see the most query rows.
//
// What bounds it on the H100.  4 products of 2 * D FLOPs per unmasked
// score against q, k, v, o, dO and lse read once and dK, dV written once:
// memory bound for tensor-core products, but this version's scalar fp32
// FMAs make it bound by operations (67 TFLOP/s fp32 peak).
//
// On no route: flash_bwd_dkdv_tc.cu takes bf16 at every head_dim and
// flash_bwd_dkdv_f32tc.cu fp32.  It stays built, held against the plain
// version, as the scalar yardstick the tensor-core dK/dV kernels are timed
// against (chip_smoke.py, the speedup gate), launched only when named.
#include "flash_common.cuh"

using namespace hvd_flash;

template <typename T, int D>
__global__ void __launch_bounds__(RowSplit<D>::kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ o,
                          const float* __restrict__ lse,
                          const T* __restrict__ dout, T* __restrict__ dk,
                          T* __restrict__ dv, int S, int h, int hkv,
                          int causal, int window, float scale) {
  using L = RowSplit<D>;
  constexpr int BKV = kBlockRows, BQ = kTileRows;
  constexpr int kThreadsPerQRow = L::kThreads / BQ;  // for the delta sums
  __shared__ __align__(16) float qs[BQ * L::kStride];
  __shared__ __align__(16) float dos[BQ * L::kStride];
  __shared__ float lse_s[BQ];
  __shared__ float delta_s[BQ];

  const int zk = blockIdx.x;
  const int j = blockIdx.y;
  const int row = threadIdx.x / L::kSplit;
  const int part = threadIdx.x % L::kSplit;
  const int kpos = j * BKV + row;
  const size_t kv_off = (size_t)zk * S * D;
  const int group = h / hkv;

  float kr[L::kDH], vr[L::kDH], dka[L::kDH], dva[L::kDH];
  load_part<T, D>(k + kv_off, kpos, S, part, kr);
  load_part<T, D>(v + kv_off, kpos, S, part, vr);
#pragma unroll
  for (int d = 0; d < L::kDH; ++d) dka[d] = dva[d] = 0.f;

  const int nq = (S + BQ - 1) / BQ;
  for (int t = 0; t < group * nq; ++t) {
    const int i = t % nq;
    if (!tile_needed(i, j, BQ, BKV, causal, window)) continue;  // uniform
    // q row of this kv row's t / nq-th group member (reference _qrow)
    const int zq = (zk / hkv) * h + (zk % hkv) * group + t / nq;
    const size_t q_off = (size_t)zq * S * D;
    __syncthreads();  // the previous tile is consumed
    stage_tile<T, D, L::kThreads>(q + q_off, i * BQ, BQ, S, qs);
    stage_tile<T, D, L::kThreads>(dout + q_off, i * BQ, BQ, S, dos);
    {
      const int r = threadIdx.x / kThreadsPerQRow;
      const int c = threadIdx.x % kThreadsPerQRow;
      const int g = i * BQ + r;
      float acc = 0.f;
      if (g < S) {
        const T* dor = dout + q_off + (size_t)g * D;
        const T* orow = o + q_off + (size_t)g * D;
        for (int d = c; d < D; d += kThreadsPerQRow)
          acc = fmaf(to_float(dor[d]), to_float(orow[d]), acc);
      }
#pragma unroll
      for (int off = kThreadsPerQRow / 2; off > 0; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (c == 0) {
        delta_s[r] = acc;
        lse_s[r] = g < S ? lse[(size_t)zq * S + g] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      const int qpos = i * BQ + r;
      const float* qrow = qs + r * L::kStride + part * L::kPartStride;
      const float* dorow = dos + r * L::kStride + part * L::kPartStride;
      const float s = sum_parts<D>(part_dot<D>(kr, qrow)) * scale;
      const float dp = sum_parts<D>(part_dot<D>(vr, dorow));
      const bool off = qpos >= S || masked(qpos, kpos, S, causal, window);
      const float p = off ? 0.f : __expf(s - lse_s[r]);
      part_axpy<D>(dva, p, dorow);
      part_axpy<D>(dka, p * (dp - delta_s[r]), qrow);
    }
  }
  if (kpos < S) {
    store_part<T, D>(dk + kv_off, kpos, part, dka, scale);
    store_part<T, D>(dv + kv_off, kpos, part, dva, 1.f);
  }
}

// Inputs as the forward's, plus o, lse and dout; dk, dv like k.  Z counts
// q rows; the grid runs over the Z / h * hkv kv rows.
extern "C" int hvd_flash_bwd_dkdv(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* lse, const void* dout, void* dk,
                                  void* dv, int Z, int S, int D, int h,
                                  int hkv, int causal, int window, float scale,
                                  int dtype, void* stream) {
  const int tiles = (S + kBlockRows - 1) / kBlockRows;
  const dim3 grid(Z / h * hkv, tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HVD_LAUNCH(T, DD)                                                   \
  flash_bwd_dkdv_kernel<T, DD><<<grid, RowSplit<DD>::kThreads, 0, st>>>(    \
      static_cast<const T*>(q), static_cast<const T*>(k),                   \
      static_cast<const T*>(v), static_cast<const T*>(o),                   \
      static_cast<const float*>(lse), static_cast<const T*>(dout),          \
      static_cast<T*>(dk), static_cast<T*>(dv), S, h, hkv, causal, window,  \
      scale)
  HVD_FLASH_DISPATCH(dtype, D, HVD_LAUNCH);
#undef HVD_LAUNCH
  return (int)cudaGetLastError();
}
