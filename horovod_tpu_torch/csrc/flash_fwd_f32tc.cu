// Flash-attention forward in fp32 on Hopper's tensor cores (sm_90a):
// 3xTF32 wgmma fed by TMA, head_dim 16, 32 or 64.
//
// Replaces the TPU kernel horovod_tpu/ops/flash_attention.py:
// _flash_fwd_kernel (its inner `kernel`, :158-207), for fp32 inputs; bf16
// runs flash_fwd_tc.cu at every head_dim.  Computes, per folded row z and
// query position, the online softmax of S = (Q * scale) K^T over the K
// tiles the causal/window masks leave alive, and writes O = acc / l and
// lse = m + log(l) in fp32, with the reference's finite NEG_INF
// recurrence.  The reference takes both products in fp32
// (flash_attention.py:179-185, :200-202), so this kernel must stay
// fp32-grade: each product is three tf32 products, hi*hi + hi*lo + lo*hi
// (hopper_tc.cuh, "3xTF32"), about 2^-22 relative from fp32.
//
// What bounds it on the H100.  4 * D FLOPs per unmasked score, taken three
// times on the tf32 tensor cores (495 TFLOP/s), so fp32-accurate work runs
// at 165 TFLOP/s; q, k, v read once and o, lse written once are 4-byte
// items.  At D = 64 that is about 128 FLOPs per byte, against a ridge of
// 165e12 / 3.35e12 = 49: the bound is the operations (gpt-small's layer,
// Z=96, S=1024, causal: 12.90 GFLOP, 0.078 ms).  In practice a warpgroup
// runs its split of each tile (the V transpose overlaps S), the softmax
// and the products one after another, and the other CTA on the SM
// overlaps them.
//
// Design.
// * One CTA per (z, 64-row Q tile), Q tiles issued last-first (the longest
//   causal rows start first): one consumer warpgroup owns the 64 query
//   rows, one producer warp issues every TMA load.  K/V tiles of kBK = 32
//   keys stream through a ring of kStages = 3 slots with full / empty
//   mbarriers; rows past S come back zero-filled.  32-key tiles, not 64,
//   keep the CTA at 104 KB of shared memory at D = 64 (Q and its lo 32 KB,
//   3 x 16 KB of K/V slots, 24 KB of K lo and V^T) so that two CTAs share
//   an SM and overlap one another's split, softmax and products; at 64
//   keys one CTA would fill the SM.  Registers: O (D / 2), S (16) and the
//   lo A fragments of P (16; P is its own hi), 137 a thread at D = 64
//   (the build's ptxas report), under the 204 that two CTAs of 160
//   threads allow.
// * The split.  A raw fp32 tile is its own hi part (the tensor core reads
//   tf32 by truncation), so Q (once) and each K tile only get a lo tile
//   beside them.  Each V tile is transposed by the threads into V^T hi /
//   lo work tiles (keys are the depth of O += P V, and .tf32 operands are
//   K-major only: there is no TMA load of a transpose), while the tensor
//   cores take S.  The writes go out through fence.proxy.async and a
//   named barrier of the warpgroup before the products read them; the
//   slot is released once S is computed and V transposed.
// * S = Q K^T: 3 x D / 8 wgmma m64n32k8 SS (Q and K K-major as they lie).
//   Scale and log2(e) fold into one multiply of S, so the softmax runs on
//   exp2; row max / sum across the 4 threads of a row by two shuffles; the
//   element mask only on tiles that cross the diagonal, the window edge
//   or S.
// * O += P V: 3 x 4 wgmma m64nDk8 RS, P's A fragments in registers (hi
//   the accumulator's own words, lo split).  The .tf32 A fragment does not line up with
//   the accumulator's columns (hopper_tc.cuh, "A from registers"), so the
//   transposed V^T tiles hold each 8-key group in kpos8 order.
// * Epilogue: O / l with 8-byte stores straight from the accumulator
//   fragments, lse = (m + log2 l) * ln 2.
#include "flash_common.cuh"
#include "hopper_tc.cuh"

using namespace hvd_flash;
using namespace hvd_tc;

namespace {

constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBK = 32;            // keys per K/V tile
constexpr int kStages = 3;
constexpr int kConsumers = 128;    // one warpgroup
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp

template <int D>
struct Fwd {
  using QT = F32Tile<kBQ, D>;   // Q (its own hi part) and its lo part
  using KT = F32Tile<kBK, D>;   // a K or V slot, K lo
  using VtT = F32Tile<D, kBK>;  // V^T hi and lo: the keys are the depth
  static constexpr int kQlo = QT::kBytes;
  static constexpr int kSlots = 2 * QT::kBytes;  // K at +0, V at +KT::kBytes
  static constexpr int kSlotBytes = 2 * KT::kBytes;
  static constexpr int kKlo = kSlots + kStages * kSlotBytes;
  static constexpr int kVth = kKlo + KT::kBytes;
  static constexpr int kVtl = kVth + VtT::kBytes;
  static constexpr int kSmem = kVtl + VtT::kBytes + 1024;  // + alignment
};

struct Barriers {
  uint64_t q;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_f32tc_kernel(__grid_constant__ const CUtensorMap map_q,
                           __grid_constant__ const CUtensorMap map_k,
                           __grid_constant__ const CUtensorMap map_v,
                           float* __restrict__ o, float* __restrict__ lse,
                           int S, int h, int hkv, int causal, int window,
                           float scale_log2) {
  using C = Fwd<D>;
  using QT = typename C::QT;
  using KT = typename C::KT;
  using VtT = typename C::VtT;
  extern __shared__ uint8_t smem_raw[];
  __shared__ Barriers bars;
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sq = smem;
  uint8_t* sqlo = smem + C::kQlo;
  uint8_t* sklo = smem + C::kKlo;
  uint8_t* svth = smem + C::kVth;
  uint8_t* svtl = smem + C::kVtl;
  auto slot_k = [&](int st) { return smem + C::kSlots + st * C::kSlotBytes; };
  auto slot_v = [&](int st) { return slot_k(st) + KT::kBytes; };

  const int z = blockIdx.x;
  const int i = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int nk = (S + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&bars.q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars.full[s], 1);
      mbar_init(&bars.empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: one thread issues every load ----
    if (lane == 0) {
      const int zkv = kv_row(z, h, hkv);
      mbar_expect_tx(&bars.q, QT::kBytes);
      tma_load_tile<QT>(sq, &map_q, i * kBQ, z, &bars.q);
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

  // ---- consumers: the warpgroup owns query rows [row0, row0 + 64) ----
  const int tid = threadIdx.x;
  const int row0 = i * kBQ;
  const int r_lo = row0 + warp * 16 + lane / 4;  // this thread's two rows
  const int r_hi = r_lo + 8;
  const int col = 2 * (lane % 4);                // + 8c + (e & 1)

  float acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf;  // running max, log2 domain
  float l_lo = 0.f, l_hi = 0.f;          // this thread's part of the sum

  // base descriptors of the tiles the products read (a slot's per tile)
  const uint64_t dq_hi = QT::desc(sq), dq_lo = QT::desc(sqlo);
  const uint64_t dk_lo = KT::desc(sklo);
  const uint64_t dvt_hi = VtT::desc(svth), dvt_lo = VtT::desc(svtl);
  mbar_wait(&bars.q, 0);
  split_lo<QT, kConsumers>(sq, sqlo, tid);
  int n = 0;
  for (int j = 0; j < nk; ++j) {
    if (!tile_needed(i, j, kBQ, kBK, causal, window)) continue;
    const int st = n % kStages;
    mbar_wait(&bars.full[st], (n / kStages) & 1);
    // the last tile's S read K lo and its P V read V^T: every warp has
    // waited on both before the barrier below
    split_lo<KT, kConsumers>(slot_k(st), sklo, tid);
    fence_proxy_async();
    bar_sync(1, kConsumers);

    float s[kBK / 2];
    const uint64_t dk_hi = KT::desc(slot_k(st));
    wgmma_fence();
    static_for<0, D / 8>([&](auto kk) {
      wgmma_3xtf32_ss<kBK, QT, KT, decltype(kk)::value>(s, dq_hi, dq_lo,
                                                         dk_hi, dk_lo);
    });
    wgmma_commit();
    // V^T while the tensor cores take S
    transpose_split<KT, kConsumers>(slot_v(st), svth, svtl, tid);
    fence_proxy_async();
    wgmma_wait<0>();
    fence_acc(s);
    bar_sync(1, kConsumers);  // V^T written, K and V read by every warp
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.empty[st]);

    const int k0 = j * kBK;
    const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > row0) ||
                      (window > 0 && k0 < row0 + kBQ - window);
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int c = 0; c < kBK / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * c + e] * scale_log2;
        if (edge && masked(e < 2 ? r_lo : r_hi, k0 + 8 * c + col + (e & 1),
                           S, causal, window))
          x = kNegInf;
        s[4 * c + e] = x;
        if (e < 2) mx_lo = fmaxf(mx_lo, x);
        else mx_hi = fmaxf(mx_hi, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = ex2(m_lo - mn_lo), corr_hi = ex2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= corr_lo;
    l_hi *= corr_hi;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      acc[4 * c] *= corr_lo;
      acc[4 * c + 1] *= corr_lo;
      acc[4 * c + 2] *= corr_hi;
      acc[4 * c + 3] *= corr_hi;
    }
#pragma unroll
    for (int c = 0; c < kBK / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[4 * c + e] - (e < 2 ? mn_lo : mn_hi));
        s[4 * c + e] = p;
        if (e < 2) l_lo += p;
        else l_hi += p;
      }
    }
    uint32_t pl[kBK / 8][4];
    split_a<kBK>(s, pl);
    wgmma_fence();
    static_for<0, kBK / 8>([&](auto c) {
      constexpr int kC = decltype(c)::value;
      uint32_t ph[4];
      a_hi<kBK>(s, kC, ph);
      wgmma_3xtf32_rs<D, VtT, kC>(acc, ph, pl[kC], dvt_hi, dvt_lo);
    });
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    ++n;
  }

  // ---- epilogue ----
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const size_t zrow = (size_t)z * S;
  if (r_lo < S) {
    float* dst = o + (zrow + r_lo) * D + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(dst + 8 * c) =
          make_float2(acc[4 * c] * inv_lo, acc[4 * c + 1] * inv_lo);
    if (lane % 4 == 0) lse[zrow + r_lo] = m_lo * kLn2 + logf(l_lo);
  }
  if (r_hi < S) {
    float* dst = o + (zrow + r_hi) * D + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(dst + 8 * c) =
          make_float2(acc[4 * c + 2] * inv_hi, acc[4 * c + 3] * inv_hi);
    if (lane % 4 == 0) lse[zrow + r_hi] = m_hi * kLn2 + logf(l_hi);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int Z, int S, int h, int hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  const int zkv = Z / h * hkv;
  CUtensorMap map_q, map_k, map_v;
  if (!hvd_map_rows_f32(&map_q, q, Z, S, D, kBQ) ||
      !hvd_map_rows_f32(&map_k, k, zkv, S, D, kBK) ||
      !hvd_map_rows_f32(&map_v, v, zkv, S, D, kBK))
    return (int)cudaErrorInvalidValue;
  static bool smem_set[kMaxDevices];
  cudaError_t err =
      hvd_allow_smem(flash_fwd_f32tc_kernel<D>, Fwd<D>::kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Z, (S + kBQ - 1) / kBQ);
  flash_fwd_f32tc_kernel<D><<<grid, kThreads, Fwd<D>::kSmem, stream>>>(
      map_q, map_k, map_v, static_cast<float*>(o), static_cast<float*>(lse),
      S, h, hkv, causal, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// The same C interface as hvd_flash_fwd (flash_fwd.cu); takes fp32 with
// head_dim 16, 32 or 64 (cudaErrorInvalidValue otherwise, or when a tensor
// map cannot be encoded).  Returns the launch's cudaGetLastError().
extern "C" int hvd_flash_fwd_f32tc(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int Z,
                                   int S, int D, int h, int hkv, int causal,
                                   int window, float scale, int dtype,
                                   void* stream) {
  if (dtype != HVD_FLASH_F32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 16)
    return launch<16>(q, k, v, o, lse, Z, S, h, hkv, causal, window, scale,
                      st);
  if (D == 32)
    return launch<32>(q, k, v, o, lse, Z, S, h, hkv, causal, window, scale,
                      st);
  if (D == 64)
    return launch<64>(q, k, v, o, lse, Z, S, h, hkv, causal, window, scale,
                      st);
  return (int)cudaErrorInvalidValue;
}
