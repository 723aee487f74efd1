// Flash-attention backward, dQ pass, in fp32 on Hopper's tensor cores
// (sm_90a): 3xTF32 wgmma fed by TMA, head_dim 16, 32 or 64.
//
// Replaces the TPU kernel horovod_tpu/ops/flash_attention.py:
// _flash_bwd_pallas.kernel_dq (:324-349, with the shared recompute
// _recompute_p_ds, :270-289; pallas_call :386-404), for fp32 inputs; bf16
// runs flash_bwd_dq_tc.cu at every head_dim.  Per query row: over the keys
// the masks leave alive, rebuild P = exp(S*scale - lse), dP = dO V^T and
// dS = P * (dP - delta) with delta = rowsum(dO * O), accumulate dQ += dS K
// in fp32, and write dQ * scale.  Every product is three tf32 products
// (hopper_tc.cuh, "3xTF32"), fp32-grade like the reference's
// preferred_element_type=float32 products.
//
// What bounds it on the H100.  3 products of 2 * D FLOPs per unmasked
// score at the fp32-accurate tensor-core rate of 165 TFLOP/s (495 TF32 /
// 3), against q, k, v, o, dO and lse read once and dQ written once in
// fp32: at D = 64 about 128 FLOPs per byte against a ridge of 49, so the
// bound is the operations (gpt-small's layer, Z=96, S=1024, causal: 19.34
// GFLOP, 0.117 ms).  In practice the split of every streamed K/V tile
// (lo parts and the K transpose, by the threads) and the latency of short
// product chains set the time, as in the fp32 forward and dK/dV.
//
// Design.
// * One CTA per (z, 128-row Q tile), Q tiles issued last-first (the
//   longest causal rows start first): two consumer warpgroups, each
//   owning 64 of the query rows, and one producer warp that issues every
//   TMA load.  A warpgroup's Q and dO tiles are loaded once and stay in
//   shared memory beside their lo parts (split_lo once); a raw fp32 tile
//   is its own hi part (the tensor core reads tf32 by truncation).  K/V
//   tiles of kBK = 32 keys of the kv row (GQA: kv_row) that tile_needed
//   leaves alive stream through a ring of kStages slots with full / empty
//   mbarriers; rows past S come back zero-filled.
// * delta = rowsum(dO * O) is computed here, once per query row (one CTA
//   owns each row): the four threads that share a row in the accumulator
//   layout each take a quarter of its columns, dO from the resident tile
//   and O from device memory, and two shuffles sum them.  O is read once
//   per backward; no pre-pass, no scratch, and the fp32 dK/dV is not
//   touched.
// * The split of a streamed tile is shared by the 128 query rows and done
//   by all 256 consumer threads: the lo parts of K and V, and K^T hi / lo
//   by transpose_split.  K plays the role V plays in the forward's
//   O += P V: the keys are the depth of dQ += dS K, and .tf32 operands are
//   K-major only (no transpose bit for 32-bit types, no TMA load of a
//   transpose), so the threads write K^T, each 8-key group in kpos8 order
//   to match the A fragments of dS (hopper_tc.cuh, "A from registers").
//   The writes reach the products through fence.proxy.async and a named
//   barrier of the consumers.  Sharing the split halves it per query row;
//   the fp32 dK/dV measured that sharing it between two warpgroups is
//   faster than splitting per warpgroup.
// * Products per tile and warpgroup: S = Q K^T and dP = dO V^T (3 x D / 8
//   wgmma m64n32k8 SS each, Q, dO, K and V K-major as they lie); the
//   K^T transpose runs on the threads meanwhile.  P = exp2(S * scale *
//   log2 e - lse * log2 e), masked only on tiles that cross the diagonal,
//   the window edge or S; dS = P (dP - delta); then dQ += dS K (3 x 4
//   wgmma m64nDk8 RS, dS its own hi A fragment, its lo part split in
//   registers).  A warpgroup whose 64 rows a tile leaves fully masked
//   (under the diagonal of its CTA's block, or past S) skips its
//   products but still shares the split.
// * ptxas and wgmma (hopper_tc.cuh, "Registers"): every wait is
//   unconditional, no accumulator is read with its products in flight,
//   and S and dP are zeroed before the products a warpgroup may skip: left
//   undefined on that path, they made ptxas serialize every wgmma of the
//   kernel (C7511), and it then ran far slower.  The build's -Xptxas -v
//   log shows that no instantiation is serialized (chip_smoke.py, phase
//   build).
// * Budget at D = 64: shared memory 208 KB (Q, dO and their lo parts for
//   128 rows 128 KB; 3 slots of K, V 48 KB; K lo, V lo, K^T hi, K^T lo
//   32 KB) + 1 KB of alignment, one CTA of 9 warps an SM, about 168
//   registers a thread.  At D 32 / 16 the tiles halve / quarter but the
//   registers barely shrink (S and dP stay 64 x 32): two CTAs an SM left
//   too few registers (ptxas spilled and serialized the wgmma), so one CTA
//   an SM at every D.
// * Each query row is written by its own CTA: no atomics, the same bits
//   from run to run.  Epilogue: dQ * scale, 8-byte stores from the
//   accumulator fragments, rows past S not written.
#include "flash_common.cuh"
#include "hopper_tc.cuh"

using namespace hvd_flash;
using namespace hvd_tc;

namespace {

constexpr int kWGRows = 64;              // query rows a warpgroup owns
constexpr int kWGs = 2;
constexpr int kBQ = kWGs * kWGRows;      // query rows per CTA
constexpr int kBK = 32;                  // keys per K/V tile
constexpr int kStages = 3;
constexpr int kWG = 128;
constexpr int kConsumers = kWGs * kWG;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp

template <int D>
struct Dq {
  using QT = F32Tile<kWGRows, D>;  // a warpgroup's Q or dO, or its lo part
  using KT = F32Tile<kBK, D>;      // a K or V slot, K lo, V lo
  using KtT = F32Tile<D, kBK>;     // K^T hi and lo: the keys are the depth
  // warpgroup w's Q, Q lo, dO, dO lo at (4w + 0, 1, 2, 3) QT::kBytes
  static constexpr int kSlots = 4 * kWGs * QT::kBytes;
  static constexpr int kSlotBytes = 2 * KT::kBytes;  // K at +0, V after
  static constexpr int kKlo = kSlots + kStages * kSlotBytes;
  static constexpr int kVlo = kKlo + KT::kBytes;
  static constexpr int kKth = kVlo + KT::kBytes;
  static constexpr int kKtl = kKth + KtT::kBytes;
  static constexpr int kSmem = kKtl + KtT::kBytes + 1024;  // + alignment
};

struct Barriers {
  uint64_t q;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_f32tc_kernel(__grid_constant__ const CUtensorMap map_q,
                              __grid_constant__ const CUtensorMap map_k,
                              __grid_constant__ const CUtensorMap map_v,
                              __grid_constant__ const CUtensorMap map_do,
                              const float* __restrict__ o,
                              const float* __restrict__ lse,
                              float* __restrict__ dq, int S, int h, int hkv,
                              int causal, int window, float scale,
                              float scale_log2) {
  using C = Dq<D>;
  using QT = typename C::QT;
  using KT = typename C::KT;
  using KtT = typename C::KtT;
  extern __shared__ uint8_t smem_raw[];
  __shared__ Barriers bars;
  uint8_t* smem = align_1024(smem_raw);
  // x: 0 Q, 1 Q lo, 2 dO, 3 dO lo of warpgroup w
  auto res = [&](int w, int x) { return smem + (4 * w + x) * QT::kBytes; };
  auto slot_k = [&](int st) { return smem + C::kSlots + st * C::kSlotBytes; };
  auto slot_v = [&](int st) { return slot_k(st) + KT::kBytes; };
  uint8_t* sklo = smem + C::kKlo;
  uint8_t* svlo = smem + C::kVlo;
  uint8_t* skth = smem + C::kKth;
  uint8_t* sktl = smem + C::kKtl;

  const int z = blockIdx.x;
  const int i = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int nk = (S + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&bars.q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars.full[s], 1);
      mbar_init(&bars.empty[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: one thread issues every load ----
    if (lane == 0) {
      const int zkv = kv_row(z, h, hkv);
      // a warpgroup whose rows all lie past S loads nothing
      const int live = min(kWGs, (S - i * kBQ + kWGRows - 1) / kWGRows);
      mbar_expect_tx(&bars.q, live * 2 * QT::kBytes);
      for (int w = 0; w < live; ++w) {
        const int row = i * kBQ + w * kWGRows;
        tma_load_tile<QT>(res(w, 0), &map_q, row, z, &bars.q);
        tma_load_tile<QT>(res(w, 2), &map_do, row, z, &bars.q);
      }
      int n = 0;
      for (int j = 0; j < nk; ++j) {
        if (!tile_needed(i, j, kBQ, kBK, causal, window)) continue;
        const int st = n % kStages;
        mbar_wait(&bars.empty[st], ((n / kStages) & 1) ^ 1);
        mbar_expect_tx(&bars.full[st], 2 * KT::kBytes);
        tma_load_tile<KT>(slot_k(st), &map_k, j * kBK, zkv, &bars.full[st]);
        tma_load_tile<KT>(slot_v(st), &map_v, j * kBK, zkv, &bars.full[st]);
        ++n;
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [row0, row0 + 64) ----
  const int tid = threadIdx.x;                 // of the 256 consumers
  const int wg = tid / kWG;
  const int wtid = tid % kWG;                  // in its warpgroup
  const int lr = (wtid / 32) * 16 + lane / 4;  // its rows lr, lr + 8
  const int row0 = i * kBQ + wg * kWGRows;
  const int r_lo = row0 + lr, r_hi = r_lo + 8;
  const int col = 2 * (lane % 4);              // + 8c + (e & 1)
  const bool rows_live = row0 < S;

  float acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;

  // lse (log2 domain) of this thread's two rows, and their O quarters,
  // read while Q and dO load; rows past S take 0 (their dS is 0)
  const size_t zrow = (size_t)z * S;
  const float l2_lo = r_lo < S ? lse[zrow + r_lo] * kLog2e : 0.f;
  const float l2_hi = r_hi < S ? lse[zrow + r_hi] * kLog2e : 0.f;
  const int c0 = 4 * (lane % 4);               // + 16x: this quarter
  float4 o_lo[D / 16], o_hi[D / 16];
#pragma unroll
  for (int x = 0; x < D / 16; ++x) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    o_lo[x] = r_lo < S ? *reinterpret_cast<const float4*>(
                             o + (zrow + r_lo) * D + c0 + 16 * x)
                       : zero;
    o_hi[x] = r_hi < S ? *reinterpret_cast<const float4*>(
                             o + (zrow + r_hi) * D + c0 + 16 * x)
                       : zero;
  }

  mbar_wait(&bars.q, 0);
  uint8_t* sq = res(wg, 0);
  uint8_t* sdo = res(wg, 2);
  if (rows_live) {
    split_lo<QT, kWG>(sq, res(wg, 1), wtid);
    split_lo<QT, kWG>(sdo, res(wg, 3), wtid);
  }
  // delta = rowsum(dO * O): this thread's quarter of its two rows, then
  // the four threads of each row (rows past S: dO and O are zero)
  float d_lo = 0.f, d_hi = 0.f;
  if (rows_live) {
#pragma unroll
    for (int x = 0; x < D / 16; ++x) {
      const float4 g = *reinterpret_cast<const float4*>(
          sdo + QT::offset(lr, c0 + 16 * x));
      const float4 g8 = *reinterpret_cast<const float4*>(
          sdo + QT::offset(lr + 8, c0 + 16 * x));
      d_lo = fmaf(g.x, o_lo[x].x, d_lo);
      d_lo = fmaf(g.y, o_lo[x].y, d_lo);
      d_lo = fmaf(g.z, o_lo[x].z, d_lo);
      d_lo = fmaf(g.w, o_lo[x].w, d_lo);
      d_hi = fmaf(g8.x, o_hi[x].x, d_hi);
      d_hi = fmaf(g8.y, o_hi[x].y, d_hi);
      d_hi = fmaf(g8.z, o_hi[x].z, d_hi);
      d_hi = fmaf(g8.w, o_hi[x].w, d_hi);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    d_lo += __shfl_xor_sync(0xffffffffu, d_lo, off);
    d_hi += __shfl_xor_sync(0xffffffffu, d_hi, off);
  }

  // base descriptors of the tiles the products read (a slot's per tile)
  const uint64_t dq_hi = QT::desc(sq), dq_lo = QT::desc(res(wg, 1));
  const uint64_t ddo_hi = QT::desc(sdo), ddo_lo = QT::desc(res(wg, 3));
  const uint64_t dk_lo = KT::desc(sklo), dv_lo = KT::desc(svlo);
  const uint64_t dkt_hi = KtT::desc(skth), dkt_lo = KtT::desc(sktl);
  int n = 0;
  for (int j = 0; j < nk; ++j) {
    if (!tile_needed(i, j, kBQ, kBK, causal, window)) continue;
    const int st = n % kStages;
    mbar_wait(&bars.full[st], (n / kStages) & 1);
    // the last tile's S and dP read K lo and V lo: every warp waited on
    // them before the last tile's second barrier
    split_lo<KT, kConsumers>(slot_k(st), sklo, tid);
    split_lo<KT, kConsumers>(slot_v(st), svlo, tid);
    fence_proxy_async();
    bar_sync(1, kConsumers);

    // does this tile leave any of this warpgroup's rows unmasked?
    const bool mine = rows_live && tile_needed(kWGs * i + wg, j, kWGRows,
                                               kBK, causal, window);
    // zeroed: with s and dp undefined on the path that skips the
    // products, ptxas serialized every wgmma of the kernel (C7511)
    float s[kBK / 2], dp[kBK / 2];
#pragma unroll
    for (int x = 0; x < kBK / 2; ++x) s[x] = dp[x] = 0.f;
    if (mine) {
      const uint64_t dk_hi = KT::desc(slot_k(st));
      const uint64_t dv_hi = KT::desc(slot_v(st));
      wgmma_fence();
      static_for<0, D / 8>([&](auto kk) {
        wgmma_3xtf32_ss<kBK, QT, KT, decltype(kk)::value>(s, dq_hi, dq_lo,
                                                           dk_hi, dk_lo);
      });
      static_for<0, D / 8>([&](auto kk) {
        wgmma_3xtf32_ss<kBK, QT, KT, decltype(kk)::value>(dp, ddo_hi, ddo_lo,
                                                           dv_hi, dv_lo);
      });
      wgmma_commit();
    }
    // K^T while the tensor cores take S and dP; the last tile's dQ read
    // K^T: every warp waited on it before the barrier above
    transpose_split<KT, kConsumers>(slot_k(st), skth, sktl, tid);
    fence_proxy_async();
    // unconditional: on no path may s or dp be read with products of
    // theirs in flight (ptxas serializes every wgmma if so)
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    bar_sync(1, kConsumers);  // K^T written, the slot read by every warp
    if (tid == 0) mbar_arrive(&bars.empty[st]);

    if (mine) {
      const int k0 = j * kBK;
      const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > row0) ||
                        (window > 0 && k0 < row0 + kWGRows - window);
#pragma unroll
      for (int c = 0; c < kBK / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >= 2;
          float p = ex2(fmaf(s[4 * c + e], scale_log2, hi ? -l2_hi : -l2_lo));
          if (edge && masked(hi ? r_hi : r_lo, k0 + 8 * c + col + (e & 1), S,
                             causal, window))
            p = 0.f;
          dp[4 * c + e] = p * (dp[4 * c + e] - (hi ? d_hi : d_lo));  // dS
        }
      }
      // dQ += dS K; dS is its own hi fragment
      uint32_t dl[kBK / 8][4];
      split_a<kBK>(dp, dl);
      wgmma_fence();
      static_for<0, kBK / 8>([&](auto c) {
        constexpr int kC = decltype(c)::value;
        uint32_t dh[4];
        a_hi<kBK>(dp, kC, dh);
        wgmma_3xtf32_rs<D, KtT, kC>(acc, dh, dl[kC], dkt_hi, dkt_lo);
      });
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(acc);
    ++n;
  }

  // ---- epilogue ----
  if (r_lo < S) {
    float* dst = dq + (zrow + r_lo) * D + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(dst + 8 * c) =
          make_float2(acc[4 * c] * scale, acc[4 * c + 1] * scale);
  }
  if (r_hi < S) {
    float* dst = dq + (zrow + r_hi) * D + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(dst + 8 * c) =
          make_float2(acc[4 * c + 2] * scale, acc[4 * c + 3] * scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, int Z, int S, int h,
           int hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  const int zkv = Z / h * hkv;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!hvd_map_rows_f32(&map_q, q, Z, S, D, kWGRows) ||
      !hvd_map_rows_f32(&map_k, k, zkv, S, D, kBK) ||
      !hvd_map_rows_f32(&map_v, v, zkv, S, D, kBK) ||
      !hvd_map_rows_f32(&map_do, dout, Z, S, D, kWGRows))
    return (int)cudaErrorInvalidValue;
  static bool smem_set[kMaxDevices];
  cudaError_t err =
      hvd_allow_smem(flash_bwd_dq_f32tc_kernel<D>, Dq<D>::kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Z, (S + kBQ - 1) / kBQ);
  flash_bwd_dq_f32tc_kernel<D><<<grid, kThreads, Dq<D>::kSmem, stream>>>(
      map_q, map_k, map_v, map_do, static_cast<const float*>(o),
      static_cast<const float*>(lse), static_cast<float*>(dq), S, h, hkv,
      causal, window, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// The same C interface as hvd_flash_bwd_dq (flash_bwd_dq.cu); takes fp32
// with head_dim 16, 32 or 64 (cudaErrorInvalidValue otherwise, or when a
// tensor map cannot be encoded).  Returns the launch's cudaGetLastError().
extern "C" int hvd_flash_bwd_dq_f32tc(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* lse, const void* dout,
                                      void* dq, int Z, int S, int D, int h,
                                      int hkv, int causal, int window,
                                      float scale, int dtype, void* stream) {
  if (dtype != HVD_FLASH_F32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HVD_LAUNCH(DD)                                                      \
  return launch<DD>(q, k, v, o, lse, dout, dq, Z, S, h, hkv, causal,        \
                    window, scale, st)
  if (D == 16) HVD_LAUNCH(16);
  if (D == 32) HVD_LAUNCH(32);
  if (D == 64) HVD_LAUNCH(64);
#undef HVD_LAUNCH
  return (int)cudaErrorInvalidValue;
}
