// Flash-attention backward, dQ pass, on Hopper's tensor cores (sm_90a):
// bf16, head_dim D in {16, 32, 64}, one template instantiated per D.
//
// Replaces the TPU kernel horovod_tpu/ops/flash_attention.py:
// _flash_bwd_pallas.kernel_dq (:324-349, with the shared recompute
// _recompute_p_ds, :270-289; pallas_call :386-404), for bf16 inputs (at D
// 64 every GPT size's attention but nano's, at D 32 gpt-nano's); fp32 goes
// to flash_bwd_dq_f32tc.cu.  Per query row: over the keys the masks leave
// alive, rebuild P = exp(S*scale - lse), dP = dO V^T and
// dS = P * (dP - delta), accumulate dQ += dS K in fp32, and write
// dQ * scale.
//
// What bounds it on the H100.  3 products of 2 * D FLOPs per unmasked
// score against q, k, v, dO and the (lse, delta) pairs read once and dQ
// written once: under the bf16 ridge, so the bound is the bytes; in
// practice the limit is how well the three products, the exp per score
// and the streamed K/V loads overlap.
//
// Design.
// * delta is not computed here.  flash_bwd_dkdv_tc's pre-pass has already
//   written (lse, delta) per query row into the [Z, S_pad] float2 scratch
//   (S_pad = S rounded up to 64, pad rows zero), and flash_bwd hands the
//   same buffer to this kernel after it: delta is computed once per row
//   per backward, and this kernel reads neither O nor lse.  The TPU kernel
//   recomputes delta from O for every (Q tile, K tile) pair; a pre-pass of
//   dQ's own would cost a launch and a pass over O per layer.
// * One CTA per (z, 64-row Q tile), Q tiles issued last-first so the
//   longest causal rows start first.  One consumer warpgroup owns the 64
//   query rows: their Q and dO tiles (TMA, 3-D maps, BfTile<D> rows and
//   swizzle: 128, 64 or 32 bytes; rows past S zero-filled) and their 64
//   pairs (one 512-byte bulk copy) are loaded once and stay in shared
//   memory; each thread reads its two rows' lse and delta into registers
//   once, before the loop.  A producer warp streams the K and V tiles of
//   the kv row (GQA: kv_row) that tile_needed leaves alive, through a ring
//   of kStages slots with full / empty mbarriers.
// * Products per K tile: S = Q K^T and dP = dO V^T (wgmma m64n64k16 SS
//   over D / 16 k-slices, all K-major), P = exp2(S * scale * log2 e -
//   lse * log2 e), dS = P (dP - delta), then dQ += dS K (m64nDk16 RS over
//   the 64 keys: dS rounded to bf16 in registers, the same K tile read
//   MN-major: one swizzled, 1024-byte-aligned tile serves both forms).
// * Rows are queries, so the element mask takes query = row, key = column
//   (the transpose of dK/dV's fragments), and runs only on tiles that
//   cross the diagonal, the window edge or S.  Query rows past S are not
//   masked: their Q and dO rows are zero-filled and their pairs are zero,
//   so their dS is 0, a dQ row depends on its own dS row only, and they
//   are not written.
// * Occupancy: one warpgroup waits on its own products, so overlap comes
//   from other CTAs.  At D 64 three accumulators (S, dP, dQ: 3 x 32 fp32)
//   and the packed dS fit under 136 registers and 66 KB of shared memory
//   at kStages = 3, so three CTAs share an SM.  At D 32 / 16 the dQ
//   accumulator shrinks to 16 / 8 words and the tiles to 34 / 18 KB, but
//   S and dP stay 64 x 64 (about 120 registers): three CTAs an SM at
//   every D.  Four left too few registers on an H100: ptxas serialized
//   the wgmma (C7512) and spilled, and it ran slower.
// * Each query row is written by its own CTA: no atomics, the same bits
//   from run to run (the reference's two-pass design).  Epilogue: dQ *
//   scale to bf16 with 4-byte stores from the accumulator fragments, rows
//   past S not written.
#include "flash_common.cuh"
#include "hopper_tc.cuh"

using namespace hvd_flash;
using namespace hvd_tc;

namespace {

constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBK = 64;            // keys per K/V tile
constexpr int kStages = 3;
constexpr int kConsumerWarps = 4;  // one warpgroup
constexpr int kThreads = kConsumerWarps * 32 + 32;  // + the producer warp
constexpr int kPairBytes = kBQ * 8;                 // (lse, delta) x 64 rows

template <int D>
struct Cfg {
  using Tile = BfTile<D>;
  static constexpr int kTileBytes = kBQ * D * 2;  // one of Q, dO, K, V
  // Q, dO, the pairs in a 1024-byte slot (keeps the ring aligned), the ring
  static constexpr int kSmemBytes =
      2 * kTileBytes + 1024 + kStages * 2 * kTileBytes + 1024;
};

struct Barriers {
  uint64_t q;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <int D>
__global__ void __launch_bounds__(kThreads, 3)
    flash_bwd_dq_tc_kernel(__grid_constant__ const CUtensorMap map_q,
                           __grid_constant__ const CUtensorMap map_k,
                           __grid_constant__ const CUtensorMap map_v,
                           __grid_constant__ const CUtensorMap map_do,
                           const float2* __restrict__ pairs,
                           __nv_bfloat16* __restrict__ dq, int S, int S_pad,
                           int h, int hkv, int causal, int window,
                           float scale, float scale_log2) {
  using C = Cfg<D>;
  using Tile = typename C::Tile;
  constexpr int kTileBytes = C::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ Barriers bars;
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sq = smem;                          // [64, D]
  uint8_t* sdo = smem + kTileBytes;            // [64, D]
  uint8_t* spairs = smem + 2 * kTileBytes;     // 64 float2
  uint8_t* sk = spairs + 1024;                 // kStages x [64, D]
  uint8_t* sv = sk + kStages * kTileBytes;     // kStages x [64, D]

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
      mbar_expect_tx(&bars.q, 2 * kTileBytes + kPairBytes);
      tma_load_3d(sq, &map_q, 0, i * kBQ, z, &bars.q);
      tma_load_3d(sdo, &map_do, 0, i * kBQ, z, &bars.q);
      bulk_load(spairs, pairs + (size_t)z * S_pad + i * kBQ, kPairBytes,
                &bars.q);
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
  const int lr = warp * 16 + lane / 4;  // this thread's rows lr, lr + 8
  const int r_lo = row0 + lr, r_hi = r_lo + 8;
  const int col = 2 * (lane % 4);       // + 8c + (e & 1)
  const uint64_t desc_q = Tile::desc(sq);
  const uint64_t desc_do = Tile::desc(sdo);

  float acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;

  mbar_wait(&bars.q, 0);
  const float2* pr = reinterpret_cast<const float2*>(spairs);
  const float2 pair_lo = pr[lr], pair_hi = pr[lr + 8];
  const float l2_lo = pair_lo.x * kLog2e, l2_hi = pair_hi.x * kLog2e;
  const float delta_lo = pair_lo.y, delta_hi = pair_hi.y;

  int n = 0;
  for (int j = 0; j < nk; ++j) {
    if (!tile_needed(i, j, kBQ, kBK, causal, window)) continue;
    const int st = n % kStages;
    mbar_wait(&bars.full[st], (n / kStages) & 1);
    float s[32], dp[32];
    const uint64_t desc_k = Tile::desc(sk + st * kTileBytes);
    const uint64_t desc_v = Tile::desc(sv + st * kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Tile::kKSlices; ++kk)
      wgmma_ss(s, desc_q + Tile::kKStep * kk, desc_k + Tile::kKStep * kk,
               kk);
#pragma unroll
    for (int kk = 0; kk < Tile::kKSlices; ++kk)
      wgmma_ss(dp, desc_do + Tile::kKStep * kk, desc_v + Tile::kKStep * kk,
               kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);

    const int k0 = j * kBK;
    const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > row0) ||
                      (window > 0 && k0 < row0 + kBQ - window);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        float p = ex2(fmaf(s[4 * c + e], scale_log2, hi ? -l2_hi : -l2_lo));
        if (edge && masked(hi ? r_hi : r_lo, k0 + 8 * c + col + (e & 1), S,
                           causal, window))
          p = 0.f;
        dp[4 * c + e] = p * (dp[4 * c + e] - (hi ? delta_hi : delta_lo));
      }
    }
    uint32_t da[4][4];
    pack_a(dp, da);  // dS, bf16
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D / 2>(acc, da[kk], desc_k + Tile::kMNStep * kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.empty[st]);  // this warp is done with it
    ++n;
  }

  // ---- epilogue ----
  const size_t zrow = (size_t)z * S;
  if (r_lo < S) {
    __nv_bfloat16* dst = dq + (zrow + r_lo) * D + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(dst + 8 * c) =
          pack_bf16(acc[4 * c] * scale, acc[4 * c + 1] * scale);
  }
  if (r_hi < S) {
    __nv_bfloat16* dst = dq + (zrow + r_hi) * D + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(dst + 8 * c) =
          pack_bf16(acc[4 * c + 2] * scale, acc[4 * c + 3] * scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* pairs,
           const void* dout, void* dq, int Z, int S, int h, int hkv,
           int causal, int window, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const int zkv = Z / h * hkv;
  const int S_pad = (S + kBQ - 1) / kBQ * kBQ;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!hvd_map_rows(&map_q, q, Z, S, D, kBQ) ||
      !hvd_map_rows(&map_k, k, zkv, S, D, kBK) ||
      !hvd_map_rows(&map_v, v, zkv, S, D, kBK) ||
      !hvd_map_rows(&map_do, dout, Z, S, D, kBQ))
    return (int)cudaErrorInvalidValue;
  static bool smem_set[kMaxDevices];
  cudaError_t err =
      hvd_allow_smem(flash_bwd_dq_tc_kernel<D>, C::kSmemBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Z, (S + kBQ - 1) / kBQ);
  flash_bwd_dq_tc_kernel<D><<<grid, kThreads, C::kSmemBytes, stream>>>(
      map_q, map_k, map_v, map_do, static_cast<const float2*>(pairs),
      static_cast<__nv_bfloat16*>(dq), S, S_pad, h, hkv, causal, window,
      scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// Inputs as hvd_flash_bwd_dq (flash_bwd_dq.cu), with `pairs` in place of o
// and lse: the [Z, S_pad] float2 (lse, delta) scratch that
// hvd_flash_bwd_dkdv_tc's pre-pass has filled on the same inputs (S_pad =
// S rounded up to 64).  bf16 with head_dim 16, 32 or 64 only
// (cudaErrorInvalidValue otherwise, or when a tensor map cannot be
// encoded).  Returns the launch's cudaGetLastError().
extern "C" int hvd_flash_bwd_dq_tc(const void* q, const void* k,
                                   const void* v, const void* pairs,
                                   const void* dout, void* dq, int Z, int S,
                                   int D, int h, int hkv, int causal,
                                   int window, float scale, int dtype,
                                   void* stream) {
  if (dtype != HVD_FLASH_BF16) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(pairs) & 15)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, pairs, dout, dq, Z, S, h, hkv, causal,
                        window, scale, st);
    case 32:
      return launch<32>(q, k, v, pairs, dout, dq, Z, S, h, hkv, causal,
                        window, scale, st);
    case 64:
      return launch<64>(q, k, v, pairs, dout, dq, Z, S, h, hkv, causal,
                        window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
