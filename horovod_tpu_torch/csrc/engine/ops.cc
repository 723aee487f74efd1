#include "ops.h"

#include <algorithm>
#include <cmath>
#include <cstring>

#include "dtype_math.h"

namespace hvdtpu {

namespace {

// Balanced chunk boundary: chunk i of `count` elements across `n` chunks.
inline int64_t ChunkOff(int64_t count, int n, int i) {
  return count * i / n;
}

}  // namespace

Status RingAllreduce(TcpMesh* mesh, void* buf, int64_t count, DataType dtype,
                     ReduceOp op) {
  int n = mesh->size(), rank = mesh->rank();
  if (n == 1 || count == 0) return Status::OK();
  size_t elem = DataTypeSize(dtype);
  uint8_t* b = static_cast<uint8_t*>(buf);
  int next = (rank + 1) % n, prev = (rank - 1 + n) % n;

  int64_t max_chunk = 0;
  for (int i = 0; i < n; i++)
    max_chunk = std::max(max_chunk, ChunkOff(count, n, i + 1) - ChunkOff(count, n, i));
  std::vector<uint8_t> scratch(static_cast<size_t>(max_chunk) * elem);

  // Reduce-scatter: after n-1 steps, chunk (rank+1)%n holds the full sum.
  for (int step = 0; step < n - 1; step++) {
    int send_c = (rank - step + n) % n;
    int recv_c = (rank - step - 1 + n) % n;
    int64_t so = ChunkOff(count, n, send_c), sl = ChunkOff(count, n, send_c + 1) - so;
    int64_t ro = ChunkOff(count, n, recv_c), rl = ChunkOff(count, n, recv_c + 1) - ro;
    Status s = mesh->SendRecv(next, b + so * elem, static_cast<size_t>(sl) * elem,
                              prev, scratch.data(), static_cast<size_t>(rl) * elem);
    if (!s.ok()) return s;
    ReduceInto(dtype, op, b + ro * elem, scratch.data(), static_cast<size_t>(rl));
  }
  // Ring allgather of the reduced chunks.
  for (int step = 0; step < n - 1; step++) {
    int send_c = (rank + 1 - step + n) % n;
    int recv_c = (rank - step + n) % n;
    int64_t so = ChunkOff(count, n, send_c), sl = ChunkOff(count, n, send_c + 1) - so;
    int64_t ro = ChunkOff(count, n, recv_c), rl = ChunkOff(count, n, recv_c + 1) - ro;
    Status s = mesh->SendRecv(next, b + so * elem, static_cast<size_t>(sl) * elem,
                              prev, b + ro * elem, static_cast<size_t>(rl) * elem);
    if (!s.ok()) return s;
  }
  return Status::OK();
}

Status RingAllgatherv(TcpMesh* mesh, const void* send, void* recv,
                      const std::vector<int64_t>& counts, DataType dtype) {
  int n = mesh->size(), rank = mesh->rank();
  size_t elem = DataTypeSize(dtype);
  std::vector<int64_t> offs(n + 1, 0);
  for (int i = 0; i < n; i++) offs[i + 1] = offs[i] + counts[i];
  uint8_t* r = static_cast<uint8_t*>(recv);
  std::memcpy(r + offs[rank] * elem, send,
              static_cast<size_t>(counts[rank]) * elem);
  if (n == 1) return Status::OK();
  int next = (rank + 1) % n, prev = (rank - 1 + n) % n;
  for (int step = 0; step < n - 1; step++) {
    int send_b = (rank - step + n) % n;
    int recv_b = (rank - step - 1 + n) % n;
    Status s = mesh->SendRecv(
        next, r + offs[send_b] * elem, static_cast<size_t>(counts[send_b]) * elem,
        prev, r + offs[recv_b] * elem, static_cast<size_t>(counts[recv_b]) * elem);
    if (!s.ok()) return s;
  }
  return Status::OK();
}

Status TreeBroadcast(TcpMesh* mesh, void* buf, int64_t count, DataType dtype,
                     int root) {
  int n = mesh->size(), rank = mesh->rank();
  if (n == 1 || count == 0) return Status::OK();
  size_t len = static_cast<size_t>(count) * DataTypeSize(dtype);
  int vr = (rank - root + n) % n;
  for (int mask = 1; mask < n; mask <<= 1) {
    if (vr < mask) {
      int peer_vr = vr + mask;
      if (peer_vr < n) {
        Status s = mesh->SendBytes((peer_vr + root) % n, buf, len);
        if (!s.ok()) return s;
      }
    } else if (vr < 2 * mask) {
      Status s = mesh->RecvBytes((vr - mask + root) % n, buf, len);
      if (!s.ok()) return s;
    }
  }
  return Status::OK();
}

Status PairwiseAlltoall(TcpMesh* mesh, const void* send, void* recv,
                        int64_t chunk_elems, DataType dtype) {
  int n = mesh->size(), rank = mesh->rank();
  size_t chunk = static_cast<size_t>(chunk_elems) * DataTypeSize(dtype);
  const uint8_t* s = static_cast<const uint8_t*>(send);
  uint8_t* r = static_cast<uint8_t*>(recv);
  std::memcpy(r + rank * chunk, s + rank * chunk, chunk);
  for (int i = 1; i < n; i++) {
    int to = (rank + i) % n, from = (rank - i + n) % n;
    Status st = mesh->SendRecv(to, s + to * chunk, chunk, from,
                               r + from * chunk, chunk);
    if (!st.ok()) return st;
  }
  return Status::OK();
}

namespace {

// Wire codecs: the Adasum buffer travels point-to-point in its OWN dtype
// (bf16/f16 at 2 B/elt — half the f32 bytes, a quarter of the old f64
// wire), while dots/norms/coefficients accumulate in double, matching the
// reference's fp16 kernels that widen only in registers
// (adasum.h:101-120 DispatchComputeDotAndNormSqrds, ComputeDotAndNormSqrdsfp16).
struct F32Codec {
  using wire_t = float;
  static double Load(wire_t v) { return v; }
  static wire_t Store(double v) { return static_cast<float>(v); }
};
struct F64Codec {
  using wire_t = double;
  static double Load(wire_t v) { return v; }
  static wire_t Store(double v) { return v; }
};
struct Bf16Codec {
  using wire_t = uint16_t;
  static double Load(wire_t v) { return Bf16ToF32(v); }
  static wire_t Store(double v) { return F32ToBf16(static_cast<float>(v)); }
};
struct F16Codec {
  using wire_t = uint16_t;
  static double Load(wire_t v) { return F16ToF32(v); }
  static wire_t Store(double v) { return F32ToF16(static_cast<float>(v)); }
};

// Pairwise full-vector combine, w as "A" and other as "B":
// w = coefA * w + coefB * other, inner products in double (reference
// adasum.h:239-263).
template <typename C>
void PairCombine(typename C::wire_t* w, const typename C::wire_t* other,
                 int64_t count) {
  double dot = 0, na2 = 0, nb2 = 0;
  for (int64_t i = 0; i < count; i++) {
    double a = C::Load(w[i]);
    double b = C::Load(other[i]);
    dot += a * b;
    na2 += a * a;
    nb2 += b * b;
  }
  double ca = 1.0 - dot / (2.0 * std::max(na2, 1e-30));
  double cb = 1.0 - dot / (2.0 * std::max(nb2, 1e-30));
  for (int64_t i = 0; i < count; i++) {
    w[i] = C::Store(ca * C::Load(w[i]) + cb * C::Load(other[i]));
  }
}

// VHDD over the power-of-2 group {0..p-1} with a fold-in pre/post phase
// for the extra ranks {p..n-1} (the standard VHDD extension; replaces the
// old gather-to-rank-0 tree, which funneled all rows through one host).
//
// Grouping (mirrored by the Python engine's _numpy_adasum_rows so both
// engines agree on non-power-of-2 worlds):
//   pre:  extra rank p+j sends its vector to rank j, which pair-combines.
//   core: VHDD (reference adasum.h:167-299) over ranks 0..p-1.
//   post: rank j sends the finished vector back to extra p+j.
template <typename C>
Status AdasumImpl(TcpMesh* mesh, typename C::wire_t* w, int64_t count) {
  using W = typename C::wire_t;
  int n = mesh->size(), rank = mesh->rank();
  int p = 1;
  while (p * 2 <= n) p *= 2;
  int extras = n - p;
  size_t nbytes = static_cast<size_t>(count) * sizeof(W);

  if (rank >= p) {  // extra: fold in, then receive the final result
    int partner = rank - p;
    Status s = mesh->SendBytes(partner, w, nbytes);
    if (!s.ok()) return s;
    return mesh->RecvBytes(partner, w, nbytes);
  }
  std::vector<W> other;
  if (rank < extras) {  // fold-in target: absorb the extra's contribution
    other.resize(static_cast<size_t>(count));
    Status s = mesh->RecvBytes(p + rank, other.data(), nbytes);
    if (!s.ok()) return s;
    PairCombine<C>(w, other.data(), count);
  }

  // --- VHDD halving phase over the p-group ---
  int64_t start = 0, len = count;
  std::vector<std::pair<int64_t, int64_t>> seg_stack;
  for (int distance = 1; distance < p; distance <<= 1) {
    int partner = rank ^ distance;
    seg_stack.emplace_back(start, len);
    int64_t h = len / 2;
    int64_t my_start, my_len, send_off, send_len;
    if (rank < partner) {  // keep first half, hand off second
      my_start = start;
      my_len = h;
      send_off = start + h;
      send_len = len - h;
    } else {
      my_start = start + h;
      my_len = len - h;
      send_off = start;
      send_len = h;
    }
    other.resize(static_cast<size_t>(my_len));
    Status s = mesh->SendRecv(partner, w + send_off,
                              static_cast<size_t>(send_len) * sizeof(W),
                              partner, other.data(),
                              static_cast<size_t>(my_len) * sizeof(W));
    if (!s.ok()) return s;

    // Partial inner products on my piece, oriented so the lower block's
    // subtree vector is "A" group-wide (reference adasum.h reorients
    // before SumAllreduceWithComm).
    double dot = 0, mine2 = 0, theirs2 = 0;
    for (int64_t i = 0; i < my_len; i++) {
      double a = C::Load(w[my_start + i]);
      double b = C::Load(other[static_cast<size_t>(i)]);
      dot += a * b;
      mine2 += a * a;
      theirs2 += b * b;
    }
    bool lower = (rank & distance) == 0;
    double triple[3] = {lower ? mine2 : theirs2, lower ? theirs2 : mine2,
                        dot};
    // Recursive-doubling sum across the 2*distance block.
    for (int bit = 1; bit < 2 * distance; bit <<= 1) {
      int q = rank ^ bit;
      double in[3];
      Status st =
          mesh->SendRecv(q, triple, sizeof(triple), q, in, sizeof(in));
      if (!st.ok()) return st;
      triple[0] += in[0];
      triple[1] += in[1];
      triple[2] += in[2];
    }
    double normA = std::max(triple[0], 1e-30);
    double normB = std::max(triple[1], 1e-30);
    double full_dot = triple[2];
    double coefA = 1.0 - full_dot / (2.0 * normA);
    double coefB = 1.0 - full_dot / (2.0 * normB);
    double my_coef = lower ? coefA : coefB;
    double their_coef = lower ? coefB : coefA;
    for (int64_t i = 0; i < my_len; i++) {
      w[my_start + i] =
          C::Store(my_coef * C::Load(w[my_start + i]) +
                   their_coef * C::Load(other[static_cast<size_t>(i)]));
    }
    start = my_start;
    len = my_len;
  }

  // --- distance-doubling reassembly (mirror of the halving) ---
  for (int distance = p >> 1; distance >= 1; distance >>= 1) {
    int partner = rank ^ distance;
    auto [pstart, plen] = seg_stack.back();
    seg_stack.pop_back();
    int64_t h = plen / 2;
    int64_t their_off, their_len;
    if (rank < partner) {
      their_off = pstart + h;
      their_len = plen - h;
    } else {
      their_off = pstart;
      their_len = h;
    }
    Status s = mesh->SendRecv(partner, w + start,
                              static_cast<size_t>(len) * sizeof(W), partner,
                              w + their_off,
                              static_cast<size_t>(their_len) * sizeof(W));
    if (!s.ok()) return s;
    start = pstart;
    len = plen;
  }

  if (rank < extras) {  // hand the result back to the folded-in extra
    return mesh->SendBytes(p + rank, w, nbytes);
  }
  return Status::OK();
}

}  // namespace

Status AdasumAllreduce(TcpMesh* mesh, void* buf, int64_t count,
                       DataType dtype) {
  if (mesh->size() == 1 || count == 0) return Status::OK();
  switch (dtype) {
    case DataType::FLOAT32:
      return AdasumImpl<F32Codec>(mesh, static_cast<float*>(buf), count);
    case DataType::FLOAT64:
      return AdasumImpl<F64Codec>(mesh, static_cast<double*>(buf), count);
    case DataType::BFLOAT16:
      return AdasumImpl<Bf16Codec>(mesh, static_cast<uint16_t*>(buf), count);
    case DataType::FLOAT16:
      return AdasumImpl<F16Codec>(mesh, static_cast<uint16_t*>(buf), count);
    default: {
      // Exotic dtypes (ints): widen to a double scratch vector, run the
      // same distributed scheme, narrow back.  Correctness path only.
      std::vector<double> d(static_cast<size_t>(count));
      ToDouble(dtype, buf, d.data(), static_cast<size_t>(count));
      Status s = AdasumImpl<F64Codec>(mesh, d.data(), count);
      if (!s.ok()) return s;
      FromDouble(dtype, d.data(), buf, static_cast<size_t>(count));
      return s;
    }
  }
}

}  // namespace hvdtpu
