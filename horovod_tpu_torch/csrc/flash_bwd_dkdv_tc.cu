// Flash-attention backward, dK/dV pass, on Hopper's tensor cores
// (sm_90a): bf16, head_dim D in {16, 32, 64}, one template instantiated
// per D.
//
// Replaces the TPU kernel horovod_tpu/ops/flash_attention.py:
// _flash_bwd_pallas.kernel_dkdv (:291-322, with the shared recompute
// _recompute_p_ds, :270-289), for bf16 inputs; fp32 goes to
// flash_bwd_dkdv_f32tc.cu.  Per key row: over every (q head of its GQA
// group, query row) the masks leave alive, rebuild P = exp(S*scale - lse),
// dP = dO V^T, dS = P * (dP - delta) with delta = rowsum(dO * O), and
// accumulate dV += P^T dO and dK += dS^T Q * scale in fp32.
//
// What bounds it on the H100.  4 products of 2 * D FLOPs per unmasked
// score against q, k, v, o, dO and lse read once and dK, dV written once:
// under the bf16 ridge, so the bound is the bytes; in practice the limit
// is how well the four products, the exp per score and the streamed loads
// overlap.
//
// Design.
// * Pre-pass (flash_bwd_dkdv_tc_delta_kernel, launched first by the same
//   entry point): delta = rowsum(dO * O) in fp32, once per query row (D / 8
//   threads a row, 16 bytes of O and dO each), written beside the row's
//   lse as an (lse, delta) pair into a [Z, S_pad] float2 scratch buffer the
//   wrapper allocates (S_pad = S rounded up to 64, pad rows zero).  The TPU
//   kernel recomputes delta from O for every (K tile, Q tile) pair, a
//   Mosaic layout choice (flash_attention.py:261-267); here that would read
//   O about 8 times per row under a causal mask at S = 1024.  The padding
//   makes every 64-row slice of the pairs a 512-byte, 16-byte aligned
//   block, so one bulk copy brings it in beside the Q/dO tiles.
// * Main kernel: one CTA per (kv row, 64-key tile), key tiles first-first
//   (under a causal mask the first key tiles see the most queries).  One
//   consumer warpgroup owns the 64 keys: their K and V tiles are loaded
//   once by TMA and stay in shared memory, their dK and dV accumulators
//   (2 x m64nD fp32) stay in registers.  A producer warp streams the
//   (q head in group, 64-row Q tile) pairs tile_needed leaves alive: Q and
//   dO tiles by TMA (3-D maps, BfTile<D> rows and swizzle, rows past S
//   zero-filled) and the pair rows by a bulk copy, through a ring of
//   kStages slots with full / empty mbarriers.  At D 64, 168 registers a
//   thread: two CTAs share an SM, so one CTA's K/V load and dK/dV stores
//   overlap the other's products; two-warpgroup CTAs of 128 keys (one per
//   SM) were slower.  At D 32 / 16 the two accumulators halve / quarter
//   and kMinBlocks asks for three CTAs an SM (128 registers): two were
//   slower at D 32 on an H100, and four left too few registers (ptxas
//   serialized the wgmma and spilled), which was slower still.
// * Products per pair: S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16 SS
//   over D / 16 k-slices, all K-major), P^T = exp2(S^T * scale * log2 e -
//   lse * log2 e) masked, dS^T = P^T (dP^T - delta), then dV += P^T dO and
//   dK += dS^T Q (m64nDk16 RS over the 64 queries: P^T and dS^T rounded to
//   bf16 in registers, dO and Q MN-major).
// * The GQA group folds in the loop, so dK/dV need no atomics and are the
//   same bits from run to run.  Epilogue: dK * scale and dV to bf16, 4-byte
//   stores from the accumulator fragments, rows past S not written.
#include "flash_common.cuh"
#include "hopper_tc.cuh"

using namespace hvd_flash;
using namespace hvd_tc;

namespace {

constexpr int kBKV = 64;           // keys per CTA
constexpr int kBQ = 64;            // query rows per streamed tile
constexpr int kStages = 3;
constexpr int kConsumerWarps = 4;  // one warpgroup
constexpr int kThreads = kConsumerWarps * 32 + 32;
constexpr int kPairBytes = kBQ * 8;              // (lse, delta) x 64 rows

template <int D>
struct Cfg {
  using Tile = BfTile<D>;
  static constexpr int kKVBytes = kBKV * D * 2;       // one of K, V
  static constexpr int kTileBytes = kBQ * D * 2;      // one of Q, dO
  // Q, dO and the pairs, padded to keep the slots 1024-byte aligned
  static constexpr int kStageBytes = 2 * kTileBytes + 1024;
  static constexpr int kSmemBytes =
      2 * kKVBytes + kStages * kStageBytes + 1024;
  static constexpr int kMinBlocks = D == 64 ? 2 : 3;  // CTAs an SM
  // pre-pass: threads a row, each 16 bytes (8 values) of O and dO
  static constexpr int kParts = D / 8;
};
constexpr int kDeltaThreads = 256;

struct Barriers {
  uint64_t kv;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// (lse, delta) per query row of a [Z, S] problem into [Z, S_pad] pairs;
// D / 8 threads per row, each a 16-byte slice of O and dO.
template <int D>
__global__ void __launch_bounds__(kDeltaThreads)
    flash_bwd_dkdv_tc_delta_kernel(const __nv_bfloat16* __restrict__ o,
                                   const __nv_bfloat16* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   float2* __restrict__ out, int S,
                                   int S_pad, int rows) {
  constexpr int kParts = Cfg<D>::kParts;
  const int row = blockIdx.x * (kDeltaThreads / kParts) + threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
  const int z = row / S_pad, s = row % S_pad;
  const bool valid = row < rows && s < S;
  float acc = 0.f;
  if (valid) {
    const size_t off = ((size_t)z * S + s) * D + part * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + off);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float2 fa = __bfloat1622float2(a2[x]);
      const float2 fb = __bfloat1622float2(b2[x]);
      acc = fmaf(fa.x, fb.x, acc);
      acc = fmaf(fa.y, fb.y, acc);
    }
  }
#pragma unroll
  for (int off = kParts / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && row < rows)
    out[row] = valid ? make_float2(lse[(size_t)z * S + s], acc)
                     : make_float2(0.f, 0.f);
}

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
    flash_bwd_dkdv_tc_kernel(__grid_constant__ const CUtensorMap map_q,
                             __grid_constant__ const CUtensorMap map_k,
                             __grid_constant__ const CUtensorMap map_v,
                             __grid_constant__ const CUtensorMap map_do,
                             const float2* __restrict__ pairs,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int S, int S_pad,
                             int h, int hkv, int causal, int window,
                             float scale, float scale_log2) {
  using C = Cfg<D>;
  using Tile = typename C::Tile;
  constexpr int kKVBytes = C::kKVBytes, kTileBytes = C::kTileBytes;
  constexpr int kStageBytes = C::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ Barriers bars;
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sk = smem;                 // [64, D]
  uint8_t* sv = smem + kKVBytes;      // [64, D]
  uint8_t* stages = smem + 2 * kKVBytes;
  // slot st: Q [64, D] at +0, dO [64, D] at +kTileBytes, pairs after dO
  auto slot_q = [&](int st) { return stages + st * kStageBytes; };
  auto slot_do = [&](int st) { return slot_q(st) + kTileBytes; };
  auto slot_pairs = [&](int st) {
    return reinterpret_cast<float*>(slot_q(st) + 2 * kTileBytes);
  };

  const int zk = blockIdx.x;
  const int j = blockIdx.y;
  const int group = h / hkv;
  const int nq = (S + kBQ - 1) / kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&bars.kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars.full[s], 1);
      mbar_init(&bars.empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer ----
    if (lane == 0) {
      mbar_expect_tx(&bars.kv, 2 * kKVBytes);
      tma_load_3d(sk, &map_k, 0, j * kBKV, zk, &bars.kv);
      tma_load_3d(sv, &map_v, 0, j * kBKV, zk, &bars.kv);
      int n = 0;
      for (int t = 0; t < group * nq; ++t) {
        const int i = t % nq;
        if (!tile_needed(i, j, kBQ, kBKV, causal, window)) continue;
        // q row of this kv row's t / nq-th group member (reference _qrow)
        const int zq = (zk / hkv) * h + (zk % hkv) * group + t / nq;
        const int st = n % kStages;
        mbar_wait(&bars.empty[st], ((n / kStages) & 1) ^ 1);
        mbar_expect_tx(&bars.full[st], 2 * kTileBytes + kPairBytes);
        tma_load_3d(slot_q(st), &map_q, 0, i * kBQ, zq, &bars.full[st]);
        tma_load_3d(slot_do(st), &map_do, 0, i * kBQ, zq, &bars.full[st]);
        bulk_load(slot_pairs(st), pairs + (size_t)zq * S_pad + i * kBQ,
                  kPairBytes, &bars.full[st]);
        ++n;
      }
    }
    return;
  }

  // ---- consumers: the warpgroup owns keys [key0, key0 + 64) ----
  const int key0 = j * kBKV;
  const int k_lo = key0 + warp * 16 + lane / 4;  // this thread's two keys
  const int k_hi = k_lo + 8;
  const int col = 2 * (lane % 4);                // + 8c + (e & 1)
  const uint64_t desc_k = Tile::desc(sk);
  const uint64_t desc_v = Tile::desc(sv);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;

  mbar_wait(&bars.kv, 0);
  int n = 0;
  for (int t = 0; t < group * nq; ++t) {
    const int i = t % nq;
    if (!tile_needed(i, j, kBQ, kBKV, causal, window)) continue;
    const int st = n % kStages;
    mbar_wait(&bars.full[st], (n / kStages) & 1);
    float s[32], dp[32];
    const uint64_t desc_q = Tile::desc(slot_q(st));
    const uint64_t desc_do = Tile::desc(slot_do(st));
    constexpr uint32_t ks = Tile::kKStep;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Tile::kKSlices; ++kk)
      wgmma_ss(s, desc_k + ks * kk, desc_q + ks * kk, kk);
#pragma unroll
    for (int kk = 0; kk < Tile::kKSlices; ++kk)
      wgmma_ss(dp, desc_v + ks * kk, desc_do + ks * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);

    const int q0 = i * kBQ;
    const bool edge = q0 + kBQ > S || key0 + kBKV > S ||
                      (causal && key0 + kBKV - 1 > q0) ||
                      (window > 0 && key0 < q0 + kBQ - window);
    const float* pr = slot_pairs(st);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      // (lse, delta) of query columns 8c + col and 8c + col + 1
      const float4 ld =
          *reinterpret_cast<const float4*>(pr + 2 * (8 * c + col));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l2 = (e & 1) ? ld.z * kLog2e : ld.x * kLog2e;
        const float delta = (e & 1) ? ld.w : ld.y;
        float p = ex2(fmaf(s[4 * c + e], scale_log2, -l2));
        if (edge) {
          const int qpos = q0 + 8 * c + col + (e & 1);
          if (qpos >= S ||
              masked(qpos, e < 2 ? k_lo : k_hi, S, causal, window))
            p = 0.f;
        }
        s[4 * c + e] = p;                          // P^T
        dp[4 * c + e] = p * (dp[4 * c + e] - delta);  // dS^T
      }
    }
    uint32_t pa[4][4], da[4][4];
    pack_a(s, pa);
    pack_a(dp, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dv_acc, pa[kk], desc_do + Tile::kMNStep * kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dk_acc, da[kk], desc_q + Tile::kMNStep * kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.empty[st]);
    ++n;
  }

  // ---- epilogue ----
  const size_t base = (size_t)zk * S;
  if (k_lo < S) {
    __nv_bfloat16* dkr = dk + (base + k_lo) * D + col;
    __nv_bfloat16* dvr = dv + (base + k_lo) * D + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(dkr + 8 * c) =
          pack_bf16(dk_acc[4 * c] * scale, dk_acc[4 * c + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvr + 8 * c) =
          pack_bf16(dv_acc[4 * c], dv_acc[4 * c + 1]);
    }
  }
  if (k_hi < S) {
    __nv_bfloat16* dkr = dk + (base + k_hi) * D + col;
    __nv_bfloat16* dvr = dv + (base + k_hi) * D + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(dkr + 8 * c) =
          pack_bf16(dk_acc[4 * c + 2] * scale, dk_acc[4 * c + 3] * scale);
      *reinterpret_cast<uint32_t*>(dvr + 8 * c) =
          pack_bf16(dv_acc[4 * c + 2], dv_acc[4 * c + 3]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dk, void* dv, void* pairs,
           int Z, int S, int h, int hkv, int causal, int window, float scale,
           cudaStream_t st) {
  using C = Cfg<D>;
  const int zkv = Z / h * hkv;
  const int S_pad = (S + kBQ - 1) / kBQ * kBQ;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!hvd_map_rows(&map_q, q, Z, S, D, kBQ) ||
      !hvd_map_rows(&map_k, k, zkv, S, D, kBKV) ||
      !hvd_map_rows(&map_v, v, zkv, S, D, kBKV) ||
      !hvd_map_rows(&map_do, dout, Z, S, D, kBQ))
    return (int)cudaErrorInvalidValue;
  const int rows = Z * S_pad;
  constexpr int kRowsPerBlock = kDeltaThreads / C::kParts;
  flash_bwd_dkdv_tc_delta_kernel<D>
      <<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kDeltaThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(o),
          static_cast<const __nv_bfloat16*>(dout),
          static_cast<const float*>(lse), static_cast<float2*>(pairs), S,
          S_pad, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static bool smem_set[kMaxDevices];
  err = hvd_allow_smem(flash_bwd_dkdv_tc_kernel<D>, C::kSmemBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(zkv, (S + kBKV - 1) / kBKV);
  flash_bwd_dkdv_tc_kernel<D><<<grid, kThreads, C::kSmemBytes, st>>>(
      map_q, map_k, map_v, map_do, static_cast<const float2*>(pairs),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S,
      S_pad, h, hkv, causal, window, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// Inputs as hvd_flash_bwd_dkdv (flash_bwd_dkdv.cu), plus `pairs`: scratch
// of Z * S_pad float2 (S_pad = S rounded up to 64) for the pre-pass.  bf16
// with head_dim 16, 32 or 64 only (cudaErrorInvalidValue otherwise, or
// when a tensor map cannot be encoded).  Launches the pre-pass, then the
// main kernel, on `stream`; returns the launches' cudaGetLastError().
extern "C" int hvd_flash_bwd_dkdv_tc(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* lse, const void* dout,
                                     void* dk, void* dv, void* pairs, int Z,
                                     int S, int D, int h, int hkv, int causal,
                                     int window, float scale, int dtype,
                                     void* stream) {
  if (dtype != HVD_FLASH_BF16 || (reinterpret_cast<uintptr_t>(pairs) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, lse, dout, dk, dv, pairs, Z, S, h, hkv,
                        causal, window, scale, st);
    case 32:
      return launch<32>(q, k, v, o, lse, dout, dk, dv, pairs, Z, S, h, hkv,
                        causal, window, scale, st);
    case 64:
      return launch<64>(q, k, v, o, lse, dout, dk, dv, pairs, Z, S, h, hkv,
                        causal, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
