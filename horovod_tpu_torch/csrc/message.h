// Coordination-plane message types + binary (de)serialization (native core).
//
// Reference equivalent: Request/RequestList and Response/ResponseList value
// classes (horovod/common/message.h:45-230) serialized through FlatBuffers
// (common/wire/message.fbs, message.cc ParseFromBytes/SerializeToString).
// FlatBuffers is not vendored here; the wire format is a simple
// length-prefixed little-endian layout (versioned magic header) — the
// multi-host eager control plane exchanges these blobs over the session's
// store, and schema evolution is handled by the version byte. The port's
// copy of the JAX package's csrc/message.h: the port's coordinator writes
// the blobs with wire.py, byte for byte this layout, and this parser reads
// them (tests/test_torch_native.py).
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace hvdtpu {

// DataType tags, value-compatible order with the reference enum
// (message.h:26-40).
enum class DataType : int32_t {
  HOROVOD_UINT8 = 0,
  HOROVOD_INT8 = 1,
  HOROVOD_UINT16 = 2,
  HOROVOD_INT16 = 3,
  HOROVOD_INT32 = 4,
  HOROVOD_INT64 = 5,
  HOROVOD_FLOAT16 = 6,
  HOROVOD_FLOAT32 = 7,
  HOROVOD_FLOAT64 = 8,
  HOROVOD_BOOL = 9,
  HOROVOD_BFLOAT16 = 10,  // TPU-native addition
};

// RequestType (message.h:47-49) + ALLTOALL (post-0.16 op, native here).
enum class RequestType : int32_t {
  ALLREDUCE = 0,
  ALLGATHER = 1,
  BROADCAST = 2,
  ALLTOALL = 3,
};

struct Request {
  int32_t request_rank = 0;
  RequestType request_type = RequestType::ALLREDUCE;
  DataType tensor_type = DataType::HOROVOD_FLOAT32;
  int32_t root_rank = -1;
  int32_t device = 0;
  std::string tensor_name;
  std::vector<int64_t> tensor_shape;
};

struct RequestList {
  std::vector<Request> requests;
  bool shutdown = false;
};

enum class ResponseType : int32_t {
  ALLREDUCE = 0,
  ALLGATHER = 1,
  BROADCAST = 2,
  ALLTOALL = 3,
  ERROR = 4,
};

struct Response {
  ResponseType response_type = ResponseType::ALLREDUCE;
  std::vector<std::string> tensor_names;
  std::string error_message;
  std::vector<int32_t> devices;
  std::vector<int64_t> tensor_sizes;  // allgather first-dim sizes by rank
};

struct ResponseList {
  std::vector<Response> responses;
  bool shutdown = false;
};

// Serialization. Blob layout: magic 'HVTP', u8 version, payload.
std::string SerializeRequestList(const RequestList& list);
bool ParseRequestList(const std::string& blob, RequestList* out);
std::string SerializeResponseList(const ResponseList& list);
bool ParseResponseList(const std::string& blob, ResponseList* out);

const char* DataTypeName(DataType t);
const char* RequestTypeName(RequestType t);

}  // namespace hvdtpu
