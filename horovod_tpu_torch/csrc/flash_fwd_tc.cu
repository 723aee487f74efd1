// Flash-attention forward on Hopper's tensor cores (sm_90a): bf16,
// head_dim D in {16, 32, 64}, one template instantiated per D.
//
// Replaces the TPU kernel horovod_tpu/ops/flash_attention.py:
// _flash_fwd_kernel (its inner `kernel`, :158-207), for bf16 inputs (at D
// 64 every GPT size's attention but nano's, at D 32 gpt-nano's); fp32 goes
// to flash_fwd_f32tc.cu.  Computes, per folded row z and query position,
// the online softmax of S = (Q * scale) K^T over the K tiles the
// causal/window masks leave alive, and writes O = acc / l in bf16 and
// lse = m + log(l) in fp32, with the reference's finite NEG_INF recurrence.
//
// What bounds it on the H100.  4 * D FLOPs per unmasked score against
// q, k, v read once and o written once: about 2 * D FLOPs per byte, under
// the bf16 tensor-core ridge (~295), so the bound is the bytes.  In
// practice the limit is how well the two products (tensor cores), the
// softmax between them (FP32 pipes, one exp per score, the same at every
// D) and the loads overlap.
//
// Design.
// * One CTA per (z, 64-row Q tile): one consumer warpgroup that owns the 64
//   query rows and one producer warp that issues every load.  Q tiles are
//   issued last-first so the longest causal rows start first.  At D 64 a
//   CTA holds 108 registers a thread and 73 KB of shared memory, so three
//   run on an SM and overlap one another's loads, softmax and products
//   (this card has no other way to overlap them: each warpgroup waits on
//   its own products).  Two-warpgroup CTAs of 128 rows were slower.  At
//   D 32 / 16 the O accumulator and the tiles shrink (96 / 85 registers,
//   37 / 19 KB), and kMinBlocks asks for four CTAs an SM: three ran as
//   fast at D 32 on an H100, and five left too few registers (ptxas
//   serialized the wgmma and spilled), which was slower.
// * TMA.  3-D tensor maps [Z, S, D] (hvd_map_rows; BfTile<D>: 128-, 64- or
//   32-byte rows and swizzle): the Q tile is loaded once, K/V tiles of 64
//   keys stream through a ring of kStages slots, each with a full barrier
//   (expect_tx) and an empty barrier (one arrival per consumer warp).
//   Rows past S come back zero-filled.
// * S = Q K^T: wgmma m64n64k16 SS over D / 16 k-slices, Q and K K-major as
//   they lie in memory; scale and log2(e) are folded into one multiply of
//   S, so the softmax runs on exp2.  Row max / row sum across the 4
//   threads sharing a row with two shuffles; the element mask is applied
//   only on tiles that cross the diagonal, the window edge or S.
// * O += P V: wgmma m64nDk16 RS over the 64 keys, P rounded to bf16 in
//   registers (the accumulator layout is the A-operand layout), V MN-major
//   from shared memory.
// * Tiles of 64 x 64 (tile_needed at 64 x 64): a 64-key window visits 2 K
//   tiles per Q tile, where a 128-key tile grid would visit 2 tiles of
//   twice the width, all of them masked.
// * Epilogue: O / l to bf16 with 4-byte stores straight from the
//   accumulator fragments, lse = (m + log2 l) * ln 2.
#include "flash_common.cuh"
#include "hopper_tc.cuh"

using namespace hvd_flash;
using namespace hvd_tc;

namespace {

constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBK = 64;            // keys per K/V tile
constexpr int kStages = 4;
constexpr int kConsumerWarps = 4;  // one warpgroup
constexpr int kThreads = kConsumerWarps * 32 + 32;  // + the producer warp

template <int D>
struct Cfg {
  using Tile = BfTile<D>;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;
  static constexpr int kSmemBytes = kQBytes + kStages * 2 * kTileBytes + 1024;
  static constexpr int kMinBlocks = D == 64 ? 3 : 4;  // CTAs an SM
};

struct Barriers {
  uint64_t q;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
    flash_fwd_tc_kernel(__grid_constant__ const CUtensorMap map_q,
                        __grid_constant__ const CUtensorMap map_k,
                        __grid_constant__ const CUtensorMap map_v,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int S, int h, int hkv,
                        int causal, int window, float scale_log2) {
  using C = Cfg<D>;
  using Tile = typename C::Tile;
  constexpr int kTileBytes = C::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ Barriers bars;
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sq = smem;                       // [64, D]
  uint8_t* sk = smem + C::kQBytes;          // kStages x [64, D]
  uint8_t* sv = sk + kStages * kTileBytes;  // kStages x [64, D]

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
      mbar_expect_tx(&bars.q, C::kQBytes);
      tma_load_3d(sq, &map_q, 0, i * kBQ, z, &bars.q);
      int n = 0;
      for (int j = 0; j < nk; ++j) {
        if (!tile_needed(i, j, kBQ, kBK, causal, window)) continue;
        const int st = n % kStages;
        mbar_wait(&bars.empty[st], ((n / kStages) & 1) ^ 1);
        mbar_expect_tx(&bars.full[st], 2 * kTileBytes);
        tma_load_3d(sk + st * kTileBytes, &map_k, 0, j * kBK, zkv,
                    &bars.full[st]);
        tma_load_3d(sv + st * kTileBytes, &map_v, 0, j * kBK, zkv,
                    &bars.full[st]);
        ++n;
      }
    }
    return;
  }

  // ---- consumers: the warpgroup owns query rows [row0, row0 + 64) ----
  const int row0 = i * kBQ;
  const int r_lo = row0 + warp * 16 + lane / 4;  // this thread's two rows
  const int r_hi = r_lo + 8;
  const int col = 2 * (lane % 4);                // + 8c + (e & 1)
  const uint64_t desc_q = Tile::desc(sq);

  float acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf;  // running max, log2 domain
  float l_lo = 0.f, l_hi = 0.f;          // this thread's part of the sum

  mbar_wait(&bars.q, 0);
  int n = 0;
  for (int j = 0; j < nk; ++j) {
    if (!tile_needed(i, j, kBQ, kBK, causal, window)) continue;
    const int st = n % kStages;
    mbar_wait(&bars.full[st], (n / kStages) & 1);
    float s[32];
    const uint64_t desc_k = Tile::desc(sk + st * kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Tile::kKSlices; ++kk)
      wgmma_ss(s, desc_q + Tile::kKStep * kk, desc_k + Tile::kKStep * kk,
               kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);

    const int k0 = j * kBK;
    const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > row0) ||
                      (window > 0 && k0 < row0 + kBQ - window);
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
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
    for (int c = 0; c < 8; ++c) {
      if (c < D / 8) {  // the O accumulator's D / 8 column groups
        acc[4 * c] *= corr_lo;
        acc[4 * c + 1] *= corr_lo;
        acc[4 * c + 2] *= corr_hi;
        acc[4 * c + 3] *= corr_hi;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[4 * c + e] - (e < 2 ? mn_lo : mn_hi));
        s[4 * c + e] = p;
        if (e < 2) l_lo += p;
        else l_hi += p;
      }
    }
    uint32_t a[4][4];
    pack_a(s, a);
    const uint64_t desc_v = Tile::desc(sv + st * kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, a[kk], desc_v + Tile::kMNStep * kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.empty[st]);  // this warp is done with it
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
    __nv_bfloat16* dst = o + (zrow + r_lo) * D + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(dst + 8 * c) =
          pack_bf16(acc[4 * c] * inv_lo, acc[4 * c + 1] * inv_lo);
    if (lane % 4 == 0) lse[zrow + r_lo] = m_lo * kLn2 + logf(l_lo);
  }
  if (r_hi < S) {
    __nv_bfloat16* dst = o + (zrow + r_hi) * D + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(dst + 8 * c) =
          pack_bf16(acc[4 * c + 2] * inv_hi, acc[4 * c + 3] * inv_hi);
    if (lane % 4 == 0) lse[zrow + r_hi] = m_hi * kLn2 + logf(l_hi);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int Z, int S, int h, int hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  const int zkv = Z / h * hkv;
  CUtensorMap map_q, map_k, map_v;
  if (!hvd_map_rows(&map_q, q, Z, S, D, kBQ) ||
      !hvd_map_rows(&map_k, k, zkv, S, D, kBK) ||
      !hvd_map_rows(&map_v, v, zkv, S, D, kBK))
    return (int)cudaErrorInvalidValue;
  static bool smem_set[kMaxDevices];
  cudaError_t err =
      hvd_allow_smem(flash_fwd_tc_kernel<D>, C::kSmemBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Z, (S + kBQ - 1) / kBQ);
  flash_fwd_tc_kernel<D><<<grid, kThreads, C::kSmemBytes, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), S, h, hkv, causal, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// The same C interface as hvd_flash_fwd (flash_fwd.cu); takes bf16 with
// head_dim 16, 32 or 64 only (cudaErrorInvalidValue otherwise, or when a
// tensor map cannot be encoded).  Returns the launch's cudaGetLastError().
extern "C" int hvd_flash_fwd_tc(const void* q, const void* k, const void* v,
                                void* o, void* lse, int Z, int S, int D,
                                int h, int hkv, int causal, int window,
                                float scale, int dtype, void* stream) {
  if (dtype != HVD_FLASH_BF16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, lse, Z, S, h, hkv, causal, window, scale,
                        st);
    case 32:
      return launch<32>(q, k, v, o, lse, Z, S, h, hkv, causal, window, scale,
                        st);
    case 64:
      return launch<64>(q, k, v, o, lse, Z, S, h, hkv, causal, window, scale,
                        st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
