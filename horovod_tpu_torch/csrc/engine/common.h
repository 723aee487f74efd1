// horovod_tpu native core — shared types.
//
// Reference: horovod/common/common.h (Status, DataType, TensorTableEntry)
// and horovod/common/message.h (Request/Response types).  This library is
// the TPU build's native equivalent of the reference's L1-L3 (controller
// transport, negotiation, fusion, host-tensor collectives); the device
// data path stays in XLA (jit collectives), this engine serves the eager
// per-op API on host tensors.
#pragma once

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace hvdtpu {

// Mirrors horovod_tpu_torch/runtime/messages.py RequestType/ResponseType (which
// mirror reference message.h:52-58,137-144).  Values must stay in sync with
// the Python enums.
enum class RequestType : uint8_t {
  ALLREDUCE = 0,
  ALLGATHER = 1,
  BROADCAST = 2,
  JOIN = 3,
  ADASUM = 4,
  ALLTOALL = 5,
  BARRIER = 6,
  // 7 is reserved: ResponseType::ERROR holds it, and the controller maps
  // request -> response by numeric value (ConstructResponse).
  REDUCESCATTER = 8,
};

enum class ResponseType : uint8_t {
  ALLREDUCE = 0,
  ALLGATHER = 1,
  BROADCAST = 2,
  JOIN = 3,
  ADASUM = 4,
  ALLTOALL = 5,
  BARRIER = 6,
  ERROR = 7,
  REDUCESCATTER = 8,
};

// Mirrors horovod_tpu_torch/ops/collectives.py ReduceOp (which follows reference
// horovod_reduce_op_{average,sum,adasum}, operations.cc:726-799).
enum class ReduceOp : uint8_t {
  AVERAGE = 1,
  SUM = 2,
  ADASUM = 3,
  MIN = 4,
  MAX = 5,
};

// Host tensor dtypes (reference message.h:27-38 DataType).  Values are the
// wire/C-API contract with runtime/native.py.
enum class DataType : uint8_t {
  UINT8 = 0,
  INT8 = 1,
  INT32 = 2,
  INT64 = 3,
  FLOAT16 = 4,
  BFLOAT16 = 5,
  FLOAT32 = 6,
  FLOAT64 = 7,
  BOOL = 8,
};

inline size_t DataTypeSize(DataType t) {
  switch (t) {
    case DataType::UINT8:
    case DataType::INT8:
    case DataType::BOOL:
      return 1;
    case DataType::FLOAT16:
    case DataType::BFLOAT16:
      return 2;
    case DataType::INT32:
    case DataType::FLOAT32:
      return 4;
    case DataType::INT64:
    case DataType::FLOAT64:
      return 8;
  }
  return 1;
}

inline const char* DataTypeName(DataType t) {
  switch (t) {
    case DataType::UINT8: return "uint8";
    case DataType::INT8: return "int8";
    case DataType::INT32: return "int32";
    case DataType::INT64: return "int64";
    case DataType::FLOAT16: return "float16";
    case DataType::BFLOAT16: return "bfloat16";
    case DataType::FLOAT32: return "float32";
    case DataType::FLOAT64: return "float64";
    case DataType::BOOL: return "bool";
  }
  return "?";
}

// Reference common.h:107-148 Status — collapsed to what the C API needs.
enum class StatusCode : int32_t {
  OK = 0,
  IN_PROGRESS = 1,
  UNKNOWN_ERROR = 2,
  PRECONDITION_ERROR = 3,
  ABORTED = 4,
  INVALID_ARGUMENT = 5,
};

struct Status {
  StatusCode code = StatusCode::OK;
  std::string reason;
  static Status OK() { return Status{}; }
  static Status Error(StatusCode c, std::string r) { return Status{c, std::move(r)}; }
  bool ok() const { return code == StatusCode::OK; }
};

// Log levels follow reference logging.h; level from HVDTPU_LOG_LEVEL.
enum class LogLevel : int { TRACE = 0, DEBUG = 1, INFO = 2, WARNING = 3, ERROR = 4, FATAL = 5 };

LogLevel GlobalLogLevel();

#define HVD_LOG(level, rank, fmt, ...)                                        \
  do {                                                                        \
    if (static_cast<int>(level) >= static_cast<int>(::hvdtpu::GlobalLogLevel())) { \
      std::fprintf(stderr, "[hvdtpu %d] " fmt "\n", (rank), ##__VA_ARGS__);   \
    }                                                                         \
  } while (0)

}  // namespace hvdtpu
