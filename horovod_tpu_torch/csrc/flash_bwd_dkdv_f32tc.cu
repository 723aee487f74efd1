// Flash-attention backward, dK/dV pass, in fp32 on Hopper's tensor cores
// (sm_90a): 3xTF32 wgmma fed by TMA, head_dim 16, 32 or 64.
//
// Replaces the TPU kernel horovod_tpu/ops/flash_attention.py:
// _flash_bwd_pallas.kernel_dkdv (:291-322, with the shared recompute
// _recompute_p_ds, :270-289), for fp32 inputs; bf16 runs
// flash_bwd_dkdv_tc.cu at every head_dim.  Per key row: over every (q
// head of its GQA group, query row) the masks leave alive, rebuild
// P = exp(S*scale - lse), dP = dO V^T, dS = P * (dP - delta) with
// delta = rowsum(dO * O), and accumulate dV += P^T dO and
// dK += dS^T Q * scale in fp32.  Every product is three tf32 products
// (hopper_tc.cuh, "3xTF32"), fp32-grade like the reference's
// preferred_element_type=float32 products.
//
// What bounds it on the H100.  4 products of 2 * D FLOPs per unmasked
// score at the fp32-accurate tensor-core rate of 165 TFLOP/s (495 TF32 /
// 3), against q, k, v, o, dO and lse read once and dK, dV written once in
// fp32: at D = 64 about 146 FLOPs per byte against a ridge of 49, so the
// bound is the operations (gpt-small's layer: 25.79 GFLOP, 0.156 ms).  In
// practice the split of every streamed tile (lo parts and transposes by
// the threads) and the latency of short product chains set the time.
//
// Design.
// * One CTA per (kv row, 128-key tile), key tiles first-first (under a
//   causal mask the first key tiles see the most queries); two
//   warpgroups, each owning 64 of the keys: their K and V tiles loaded
//   once by TMA, their fragments read from shared memory a k8 slice at a
//   time as the A operands of S^T and dP^T, their dK and dV accumulators
//   (2 x m64nD fp32) in registers.  The (q head in group, 32-row Q tile)
//   pairs tile_needed leaves alive stream through kStages = 2 slots of Q,
//   dO and O (TMA, full mbarriers; thread 0 refills a slot once both
//   warpgroups are done with it).  The GQA group folds in the loop: no
//   atomics, the same bits from run to run.
// * The split of a streamed tile, shared by the 128 keys and done by all
//   256 threads: delta = rowsum(dO * O) (in the kernel, as the scalar
//   kernel does: no pre-pass, no scratch), the lo parts of Q and dO, and
//   the transposes Q^T, dO^T (hi, lo; one a warpgroup, side by side), into
//   one of two work buffers.  Sharing it between two warpgroups' keys
//   halves it per key; two warpgroups that each split their own query
//   tiles for the same 64 keys ran slower.
//   The transposes are the B operands of dK += dS^T Q and dV += P^T dO,
//   whose depth is the queries: .tf32 operands are K-major only (no
//   transpose bit for 32-bit types, no TMA load of a transpose), so the
//   threads write them, each 8-query group in kpos8 order to match the A
//   fragments of P^T and dS^T (hopper_tc.cuh, "A from registers").  The
//   writes reach the products through fence.proxy.async and a barrier of
//   the CTA.
// * Products per tile and warpgroup: S^T = K Q^T and dP^T = V dO^T (3 x D
//   / 8 wgmma m64n32k8 RS each, two k8 slices a stage), P^T = exp2(S^T *
//   scale * log2 e - lse * log2 e) masked, dS^T = P^T (dP^T - delta),
//   then dV += P^T dO and dK += dS^T Q (3 x 4 wgmma m64nDk8 RS each, one
//   batch, P^T and dS^T their own hi A fragments, their lo parts split in
//   registers).  A warpgroup whose 64 keys a tile leaves fully masked
//   skips its products.
// * ptxas and wgmma.  ptxas serializes every wgmma of a kernel (a wait
//   after each, C7511 / C7514) when it finds a pipeline stage it cannot
//   keep in registers or a path that reads an accumulator with its
//   products in flight.  The dK/dV variants that kept K and V (and their
//   lo parts) in shared memory as SS operands were serialized on and off
//   as unrelated code changed, and then ran far slower; with K and V as
//   register A fragments a slice at a time, short stages and unconditional
//   waits, no instantiation is.  The build's -Xptxas -v log shows it
//   (chip_smoke.py, phase build).
// * Budget at D = 64: shared memory 208 KB (K, V of 128 keys 64 KB; 2
//   slots of Q, dO, O 48 KB; 2 work buffers of Q, dO lo and Q^T, dO^T hi +
//   lo 96 KB) + 1 KB of alignment, one CTA of 8 warps an SM; 212
//   registers a thread at D = 64 (the build's ptxas report), under the
//   255 that 8 warps allow.  Epilogue: dK * scale and dV, 8-byte stores
//   from the accumulator fragments, rows past S not written.
#include "flash_common.cuh"
#include "hopper_tc.cuh"

using namespace hvd_flash;
using namespace hvd_tc;

namespace {

constexpr int kWGKeys = 64;              // keys a warpgroup owns
constexpr int kWGs = 2;
constexpr int kBKV = kWGs * kWGKeys;     // keys per CTA
constexpr int kBQ = 32;                  // query rows per streamed tile
constexpr int kStages = 2;               // Q / dO / O slots
constexpr int kBufs = 2;                 // work buffers
constexpr int kWG = 128;
constexpr int kThreads = kWGs * kWG;
constexpr int kDeltaParts = kThreads / kBQ;  // threads a query row

template <int D>
struct DkDv {
  using KvT = F32Tile<kWGKeys, D>;  // a warpgroup's K or V
  using RowT = F32Tile<kBQ, D>;     // a Q, dO or O slot; Q, dO lo
  using ColT = F32Tile<D, kBQ>;     // Q^T, dO^T hi / lo: queries the depth
  static constexpr int kKv = KvT::kBytes, kR = RowT::kBytes;
  static constexpr int kC = ColT::kBytes;
  // warpgroup w's K at 2w kKv, its V at (2w + 1) kKv
  static constexpr int kSlots = kWGs * 2 * kKv;
  static constexpr int kSlotBytes = 3 * kR;  // Q, dO, O
  static constexpr int kBufs0 = kSlots + kStages * kSlotBytes;
  // a work buffer: Q lo, dO lo, Q^T hi, Q^T lo, dO^T hi, dO^T lo
  static constexpr int kQlo = 0, kDolo = kR, kQth = 2 * kR;
  static constexpr int kQtl = kQth + kC, kDoth = kQtl + kC;
  static constexpr int kDotl = kDoth + kC;
  static constexpr int kBufBytes = kDotl + kC;
  static constexpr int kSmem = kBufs0 + kBufs * kBufBytes + 1024;
};

struct Shared {
  uint64_t kv;
  uint64_t full[kStages];
  float lse[kBufs][kBQ];       // log2 domain
  float delta[kBufs][kBQ];
  float part[kDeltaParts][kBQ];
};

// The streamed tiles: (group member, query tile) pairs in order, the ones
// tile_needed leaves alive for the CTA's keys.
struct Tiles {
  int t;  // the next pair to look at
  __device__ __forceinline__ bool next(int j, int nq, int group,
                                       int causal, int window) {
    for (; t < group * nq; ++t)
      if (tile_needed(t % nq, j, kBQ, kBKV, causal, window)) {
        ++t;
        return true;
      }
    return false;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_f32tc_kernel(__grid_constant__ const CUtensorMap map_q,
                                __grid_constant__ const CUtensorMap map_k,
                                __grid_constant__ const CUtensorMap map_v,
                                __grid_constant__ const CUtensorMap map_do,
                                __grid_constant__ const CUtensorMap map_o,
                                const float* __restrict__ lse,
                                float* __restrict__ dk,
                                float* __restrict__ dv, int S, int h,
                                int hkv, int causal, int window, float scale,
                                float scale_log2) {
  using C = DkDv<D>;
  using KvT = typename C::KvT;
  using RowT = typename C::RowT;
  using ColT = typename C::ColT;
  extern __shared__ uint8_t smem_raw[];
  __shared__ Shared sh;
  uint8_t* smem = align_1024(smem_raw);
  auto slot_q = [&](int st) { return smem + C::kSlots + st * C::kSlotBytes; };
  auto slot_do = [&](int st) { return slot_q(st) + C::kR; };
  auto slot_o = [&](int st) { return slot_q(st) + 2 * C::kR; };
  auto buf = [&](int b) { return smem + C::kBufs0 + b * C::kBufBytes; };

  const int zk = blockIdx.x;
  const int j = blockIdx.y;
  const int group = h / hkv;
  const int nq = (S + kBQ - 1) / kBQ;
  const int wg = threadIdx.x / kWG;             // this warpgroup
  const int tid = threadIdx.x % kWG;            // its thread
  const int warp = tid / 32, lane = tid % 32;   // its warp
  const uint8_t* sk = smem + 2 * wg * C::kKv;   // its K and V
  const uint8_t* sv = sk + C::kKv;
  // q row of the t / nq-th group member of this kv row (reference _qrow)
  auto q_row = [&](int t) {
    return (zk / hkv) * h + (zk % hkv) * group + t / nq;
  };

  if (threadIdx.x == 0) {
    mbar_init(&sh.kv, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&sh.full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // thread 0 keeps kStages streamed tiles in flight
  Tiles loads{0};
  auto issue = [&](int st) {
    if (!loads.next(j, nq, group, causal, window)) return;
    const int t = loads.t - 1, row = (t % nq) * kBQ, zq = q_row(t);
    mbar_expect_tx(&sh.full[st], 3 * C::kR);
    tma_load_tile<RowT>(slot_q(st), &map_q, row, zq, &sh.full[st]);
    tma_load_tile<RowT>(slot_do(st), &map_do, row, zq, &sh.full[st]);
    tma_load_tile<RowT>(slot_o(st), &map_o, row, zq, &sh.full[st]);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sh.kv, 2 * kWGs * C::kKv);
    for (int w = 0; w < kWGs; ++w) {
      tma_load_tile<KvT>(smem + 2 * w * C::kKv, &map_k,
                         j * kBKV + w * kWGKeys, zk, &sh.kv);
      tma_load_tile<KvT>(smem + (2 * w + 1) * C::kKv, &map_v,
                         j * kBKV + w * kWGKeys, zk, &sh.kv);
    }
    for (int st = 0; st < kStages; ++st) issue(st);
  }

  // The split of streamed tile n (pair t) into buffer b, by all threads.
  // delta: kDeltaParts threads a query row, each a share of its columns.
  const int srow = threadIdx.x % kBQ;
  const int c0 = 4 * (threadIdx.x / kBQ);
  constexpr int kVec = D / (4 * kDeltaParts) > 0 ? D / (4 * kDeltaParts) : 1;
  auto split = [&](int n, int t, int b) {
    const int st = n % kStages;
    const int qrow = (t % nq) * kBQ + srow;
    const float lse_row = (qrow < S && threadIdx.x < kBQ)
                              ? lse[(size_t)q_row(t) * S + qrow] * kLog2e
                              : 0.f;
    mbar_wait(&sh.full[st], (n / kStages) & 1);
    const uint8_t* sq = slot_q(st);
    const uint8_t* sdo = slot_do(st);
    const uint8_t* so = slot_o(st);
    uint8_t* w = buf(b);
    float part = 0.f;  // rows past S are zero-filled in dO and O
#pragma unroll
    for (int x = 0; x < kVec; ++x) {
      const int c = c0 + 4 * kDeltaParts * x;
      if (c < D) {
        const uint32_t off = RowT::offset(srow, c);
        const float4 g = *reinterpret_cast<const float4*>(sdo + off);
        const float4 ov = *reinterpret_cast<const float4*>(so + off);
        part = fmaf(g.x, ov.x, part);
        part = fmaf(g.y, ov.y, part);
        part = fmaf(g.z, ov.z, part);
        part = fmaf(g.w, ov.w, part);
      }
    }
    sh.part[threadIdx.x / kBQ][srow] = part;
    split_lo<RowT, kThreads>(sdo, w + C::kDolo, threadIdx.x);
    split_lo<RowT, kThreads>(sq, w + C::kQlo, threadIdx.x);
    // one transpose a warpgroup, side by side
    if (wg == 0)
      transpose_split<RowT, kWG>(sdo, w + C::kDoth, w + C::kDotl, tid);
    else
      transpose_split<RowT, kWG>(sq, w + C::kQth, w + C::kQtl, tid);
    fence_proxy_async();
    bar_sync(1, kThreads);  // every share of delta is written
    if (threadIdx.x < kBQ) {
      float d = 0.f;
#pragma unroll
      for (int x = 0; x < kDeltaParts; ++x) d += sh.part[x][threadIdx.x];
      sh.delta[b][threadIdx.x] = d;
      sh.lse[b][threadIdx.x] = lse_row;
    }
  };

  // ---- this warpgroup's keys [key0, key0 + 64) ----
  const int key0 = j * kBKV + wg * kWGKeys;
  const int k_lo = key0 + warp * 16 + lane / 4;  // this thread's two keys
  const int k_hi = k_lo + 8;
  const int col = 2 * (lane % 4);                // + 8c + (e & 1)

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;

  Tiles seq{0};
  bool have = seq.next(j, nq, group, causal, window);
  int t_cur = seq.t - 1;
  if (have) split(0, t_cur, 0);
  mbar_wait(&sh.kv, 0);
  bar_sync(1, kThreads);  // buffer 0 (and its delta, lse) is complete
  for (int n = 0; have; ++n) {
    const int b = n % kBufs, st = n % kStages;
    const bool have_next = seq.next(j, nq, group, causal, window);
    const int t_next = seq.t - 1;
    const int i = t_cur % nq, q0 = i * kBQ;
    const uint8_t* w = buf(b);
    // does this tile leave any of this warpgroup's keys unmasked?
    const bool mine = key0 < S &&
                      tile_needed(i, j * kWGs + wg, kBQ, kWGKeys, causal,
                                  window);
    if (mine) {
      const uint64_t dq_hi = RowT::desc(slot_q(st));
      const uint64_t ddo_hi = RowT::desc(slot_do(st));
      const uint64_t dq_lo = RowT::desc(w + C::kQlo);
      const uint64_t ddo_lo = RowT::desc(w + C::kDolo);
      float s[kBQ / 2], dp[kBQ / 2];
#pragma unroll
      for (int x = 0; x < kBQ / 2; ++x) s[x] = dp[x] = 0.f;
      // K and V as A from registers, two k8 slices a stage, two stages in
      // flight
      static_for<0, D / 8>([&](auto kk) {
        constexpr int kK = decltype(kk)::value;
        constexpr uint32_t ob = RowT::slice(kK);
        uint32_t kh[4], kl[4], vh[4], vl[4];
        load_a<KvT>(sk, warp, lane, kK, kh, kl);
        load_a<KvT>(sv, warp, lane, kK, vh, vl);
        wgmma_fence();
        wgmma_tf32_rs<kBQ, ob>(s, kl, dq_hi);
        wgmma_tf32_rs<kBQ, ob>(s, kh, dq_lo);
        wgmma_tf32_rs<kBQ, ob>(s, kh, dq_hi);
        wgmma_tf32_rs<kBQ, ob>(dp, vl, ddo_hi);
        wgmma_tf32_rs<kBQ, ob>(dp, vh, ddo_lo);
        wgmma_tf32_rs<kBQ, ob>(dp, vh, ddo_hi);
        if constexpr (kK % 2 == 1) {
          wgmma_commit();
          if constexpr (kK + 1 < D / 8) wgmma_wait<1>();
        }
      });
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);

      const bool edge = q0 + kBQ > S || key0 + kWGKeys > S ||
                        (causal && key0 + kWGKeys - 1 > q0) ||
                        (window > 0 && key0 < q0 + kBQ - window);
#pragma unroll
      for (int c = 0; c < kBQ / 8; ++c) {
        // lse and delta of query columns 8c + col and 8c + col + 1
        const int qc = 8 * c + col;
        const float2 l2 = *reinterpret_cast<const float2*>(&sh.lse[b][qc]);
        const float2 d2 = *reinterpret_cast<const float2*>(&sh.delta[b][qc]);
        const float ll[2] = {l2.x, l2.y}, del[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[4 * c + e], scale_log2, -ll[e & 1]));
          if (edge) {
            const int qpos = q0 + qc + (e & 1);
            if (qpos >= S ||
                masked(qpos, e < 2 ? k_lo : k_hi, S, causal, window))
              p = 0.f;
          }
          s[4 * c + e] = p;                                 // P^T
          dp[4 * c + e] = p * (dp[4 * c + e] - del[e & 1]);  // dS^T
        }
      }
      // dV += P^T dO and dK += dS^T Q, one batch; P^T and dS^T are their
      // own hi fragments
      uint32_t pl[kBQ / 8][4], dl[kBQ / 8][4];
      split_a<kBQ>(s, pl);
      split_a<kBQ>(dp, dl);
      const uint64_t ddot_hi = ColT::desc(w + C::kDoth);
      const uint64_t ddot_lo = ColT::desc(w + C::kDotl);
      const uint64_t dqt_hi = ColT::desc(w + C::kQth);
      const uint64_t dqt_lo = ColT::desc(w + C::kQtl);
      wgmma_fence();
      static_for<0, kBQ / 8>([&](auto c) {
        constexpr int kC = decltype(c)::value;
        uint32_t hi[4];
        a_hi<kBQ>(s, kC, hi);
        wgmma_3xtf32_rs<D, ColT, kC>(dv_acc, hi, pl[kC], ddot_hi, ddot_lo);
      });
      static_for<0, kBQ / 8>([&](auto c) {
        constexpr int kC = decltype(c)::value;
        uint32_t hi[4];
        a_hi<kBQ>(dp, kC, hi);
        wgmma_3xtf32_rs<D, ColT, kC>(dk_acc, hi, dl[kC], dqt_hi, dqt_lo);
      });
      wgmma_commit();
    }
    // the next tile's split while the tensor cores take dV and dK
    if (have_next) split(n + 1, t_next, b ^ 1);
    // unconditional: on no path may the accumulators be read with
    // products of theirs in flight (ptxas serializes every wgmma if so)
    wgmma_wait<0>();
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    // the next buffer is complete; both warpgroups are done with this
    // tile's slot and buffer: refill the slot kStages tiles ahead
    bar_sync(1, kThreads);
    if (threadIdx.x == 0) issue(st);
    have = have_next;
    t_cur = t_next;
  }

  // ---- epilogue ----
  const size_t base = (size_t)zk * S;
  if (k_lo < S) {
    float* dkr = dk + (base + k_lo) * D + col;
    float* dvr = dv + (base + k_lo) * D + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<float2*>(dkr + 8 * c) =
          make_float2(dk_acc[4 * c] * scale, dk_acc[4 * c + 1] * scale);
      *reinterpret_cast<float2*>(dvr + 8 * c) =
          make_float2(dv_acc[4 * c], dv_acc[4 * c + 1]);
    }
  }
  if (k_hi < S) {
    float* dkr = dk + (base + k_hi) * D + col;
    float* dvr = dv + (base + k_hi) * D + col;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<float2*>(dkr + 8 * c) =
          make_float2(dk_acc[4 * c + 2] * scale, dk_acc[4 * c + 3] * scale);
      *reinterpret_cast<float2*>(dvr + 8 * c) =
          make_float2(dv_acc[4 * c + 2], dv_acc[4 * c + 3]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dk, void* dv, int Z,
           int S, int h, int hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  const int zkv = Z / h * hkv;
  CUtensorMap map_q, map_k, map_v, map_do, map_o;
  if (!hvd_map_rows_f32(&map_q, q, Z, S, D, kBQ) ||
      !hvd_map_rows_f32(&map_o, o, Z, S, D, kBQ) ||
      !hvd_map_rows_f32(&map_k, k, zkv, S, D, kWGKeys) ||
      !hvd_map_rows_f32(&map_v, v, zkv, S, D, kWGKeys) ||
      !hvd_map_rows_f32(&map_do, dout, Z, S, D, kBQ))
    return (int)cudaErrorInvalidValue;
  static bool smem_set[kMaxDevices];
  cudaError_t err = hvd_allow_smem(flash_bwd_dkdv_f32tc_kernel<D>,
                                   DkDv<D>::kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(zkv, (S + kBKV - 1) / kBKV);
  flash_bwd_dkdv_f32tc_kernel<D><<<grid, kThreads, DkDv<D>::kSmem, stream>>>(
      map_q, map_k, map_v, map_do, map_o, static_cast<const float*>(lse),
      static_cast<float*>(dk), static_cast<float*>(dv), S, h, hkv, causal,
      window, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// The same C interface as hvd_flash_bwd_dkdv (flash_bwd_dkdv.cu); takes
// fp32 with head_dim 16, 32 or 64 (cudaErrorInvalidValue otherwise, or
// when a tensor map cannot be encoded).  Returns the launch's
// cudaGetLastError().
extern "C" int hvd_flash_bwd_dkdv_f32tc(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* lse, const void* dout,
                                        void* dk, void* dv, int Z, int S,
                                        int D, int h, int hkv, int causal,
                                        int window, float scale, int dtype,
                                        void* stream) {
  if (dtype != HVD_FLASH_F32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HVD_LAUNCH(DD)                                                      \
  return launch<DD>(q, k, v, o, lse, dout, dk, dv, Z, S, h, hkv, causal,    \
                    window, scale, st)
  if (D == 16) HVD_LAUNCH(16);
  if (D == 32) HVD_LAUNCH(32);
  if (D == 64) HVD_LAUNCH(64);
#undef HVD_LAUNCH
  return (int)cudaErrorInvalidValue;
}
