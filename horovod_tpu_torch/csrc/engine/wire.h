// Binary wire format for the native negotiation protocol.
//
// Reference: horovod/common/message.{h,cc} + wire/message.fbs (FlatBuffers).
// This build's control messages travel native→native only (workers ↔ the
// rank-0 coordinator over the TCP mesh), so the format is a hand-rolled
// little-endian encoding — one schema, defined here, no codegen.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "common.h"

namespace hvdtpu {

// Reference message.h:47-100.
struct Request {
  int32_t request_rank = 0;
  RequestType request_type = RequestType::ALLREDUCE;
  std::string tensor_name;
  DataType dtype = DataType::FLOAT32;
  std::vector<int64_t> shape;
  ReduceOp reduce_op = ReduceOp::SUM;
  int32_t root_rank = -1;
  double prescale = 1.0;
  double postscale = 1.0;

  int64_t NumElements() const {
    int64_t n = 1;
    for (auto d : shape) n *= d;
    return n;
  }
};

// Reference message.h:103-129 — plus the response-cache fast path: cache
// hits travel as slot positions, not re-serialized requests (reference
// response_cache.h CacheCoordinator bit vectors).
struct RequestList {
  std::vector<Request> requests;
  std::vector<uint32_t> cache_hits;  // ready cache slots on this rank
  bool shutdown = false;
  bool joined = false;
};

// Reference message.h:132-194.  Carries everything execution needs so a
// rank that never saw the tensor (joined) can participate with zeros.
struct Response {
  ResponseType response_type = ResponseType::ALLREDUCE;
  std::vector<std::string> tensor_names;
  std::string error_message;
  // Per-fused-entry geometry (negotiated): shapes[i] is entry i's shape.
  std::vector<std::vector<int64_t>> shapes;
  // Ragged allgather: per-rank dim0 sizes (reference Response::tensor_sizes,
  // controller.cc:453-518).
  std::vector<int64_t> tensor_sizes;
  DataType dtype = DataType::FLOAT32;
  ReduceOp reduce_op = ReduceOp::SUM;
  int32_t root_rank = -1;
  double prescale = 1.0;
  double postscale = 1.0;
};

struct ResponseList {
  std::vector<Response> responses;
  // Responses reconstructed from each rank's local cache, by slot.
  std::vector<uint32_t> cached_slots;
  bool shutdown = false;
  // True while any rank is joined: all ranks uniformly skip cache Puts so
  // the cache stays coherent for ranks that are absent from negotiation
  // (the joined rank can't observe new entries; freezing keeps every
  // rank's put/evict sequence identical — the invariant slot ids rest on).
  bool cache_frozen = false;
  // Autotuned parameter sync (reference SynchronizeParameters,
  // controller.cc:33-47): rank 0 attaches the tuner's latest move; every
  // rank applies it at the same cycle boundary, which keeps the fusion
  // threshold (and therefore fused-response layout) identical everywhere.
  bool has_params = false;
  int64_t tuned_fusion_bytes = 0;
  double tuned_cycle_ms = 0.0;
  bool tuned_cache_enabled = true;
};

// Serialization: append to / parse from a byte vector.
void SerializeRequestList(const RequestList& rl, std::vector<uint8_t>* out);
bool ParseRequestList(const uint8_t* data, size_t len, RequestList* out);
void SerializeResponseList(const ResponseList& rl, std::vector<uint8_t>* out);
bool ParseResponseList(const uint8_t* data, size_t len, ResponseList* out);

}  // namespace hvdtpu
