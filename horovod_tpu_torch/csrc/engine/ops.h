// Host-tensor collective algorithms over the TCP mesh.
//
// Reference: horovod/common/ops/{mpi,gloo,nccl}_operations.cc delegate to
// library collectives (MPI_Allreduce, gloo ring, ncclAllReduce); this
// build's CPU data plane implements the algorithms directly:
//   * allreduce  — ring reduce-scatter + ring allgather (bandwidth-optimal,
//                  the same schedule NCCL/gloo use)
//   * allgatherv — ragged ring (per-rank dim0 sizes from negotiation)
//   * broadcast  — binomial tree from the root
//   * alltoall   — pairwise shifted exchange
//   * adasum     — Vector-Halving Distance-Doubling with the projection
//                  rule (reference ops/adasum/adasum.h:167-299)
// The device data plane is XLA's (ops/collectives.py); these serve the
// eager host path.
#pragma once

#include <cstdint>
#include <vector>

#include "common.h"
#include "tcp.h"

namespace hvdtpu {

// In-place allreduce of `count` elements of `dtype` in buf, op in
// {SUM, MIN, MAX} (AVERAGE = SUM + caller-side scale).
Status RingAllreduce(TcpMesh* mesh, void* buf, int64_t count, DataType dtype,
                     ReduceOp op);

// Ragged allgather: local `send` holds counts[rank] elements; on return
// `recv` holds sum(counts) elements ordered by rank.  counts are element
// counts (dim0 * row_elems already folded in).
Status RingAllgatherv(TcpMesh* mesh, const void* send, void* recv,
                      const std::vector<int64_t>& counts, DataType dtype);

// In-place binomial-tree broadcast from root.
Status TreeBroadcast(TcpMesh* mesh, void* buf, int64_t count, DataType dtype,
                     int root);

// Alltoall: send[i*chunk .. (i+1)*chunk) goes to rank i; recv likewise.
Status PairwiseAlltoall(TcpMesh* mesh, const void* send, void* recv,
                        int64_t chunk_elems, DataType dtype);

// In-place Adasum allreduce (VHDD when size is a power of two; otherwise
// gather-to-root + sequential binary-tree combine + broadcast, matching the
// Python engine's _numpy_adasum_rows ordering).  Math in double.
Status AdasumAllreduce(TcpMesh* mesh, void* buf, int64_t count,
                       DataType dtype);

}  // namespace hvdtpu
