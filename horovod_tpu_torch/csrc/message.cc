#include "message.h"

#include <cstring>

namespace hvdtpu {

namespace {

constexpr char kMagic[4] = {'H', 'V', 'T', 'P'};
constexpr uint8_t kVersion = 1;

class Writer {
 public:
  std::string out;
  void U8(uint8_t v) { out.push_back(static_cast<char>(v)); }
  void I32(int32_t v) { Raw(&v, 4); }
  void I64(int64_t v) { Raw(&v, 8); }
  void Str(const std::string& s) {
    I32(static_cast<int32_t>(s.size()));
    out.append(s);
  }
  void Raw(const void* p, size_t n) {
    out.append(reinterpret_cast<const char*>(p), n);
  }
};

class Reader {
 public:
  Reader(const std::string& blob) : p_(blob.data()), end_(blob.data() + blob.size()) {}
  bool U8(uint8_t* v) { return Raw(v, 1); }
  bool I32(int32_t* v) { return Raw(v, 4); }
  bool I64(int64_t* v) { return Raw(v, 8); }
  bool Str(std::string* s) {
    int32_t n;
    if (!I32(&n) || n < 0 || p_ + n > end_) return false;
    s->assign(p_, n);
    p_ += n;
    return true;
  }
  bool Raw(void* v, size_t n) {
    if (p_ + n > end_) return false;
    std::memcpy(v, p_, n);
    p_ += n;
    return true;
  }

 private:
  const char* p_;
  const char* end_;
};

bool Header(Reader& r) {
  char magic[4];
  uint8_t ver;
  if (!r.Raw(magic, 4) || std::memcmp(magic, kMagic, 4) != 0) return false;
  if (!r.U8(&ver) || ver != kVersion) return false;
  return true;
}

}  // namespace

std::string SerializeRequestList(const RequestList& list) {
  Writer w;
  w.Raw(kMagic, 4);
  w.U8(kVersion);
  w.U8(list.shutdown ? 1 : 0);
  w.I32(static_cast<int32_t>(list.requests.size()));
  for (const Request& req : list.requests) {
    w.I32(req.request_rank);
    w.I32(static_cast<int32_t>(req.request_type));
    w.I32(static_cast<int32_t>(req.tensor_type));
    w.I32(req.root_rank);
    w.I32(req.device);
    w.Str(req.tensor_name);
    w.I32(static_cast<int32_t>(req.tensor_shape.size()));
    for (int64_t d : req.tensor_shape) w.I64(d);
  }
  return std::move(w.out);
}

bool ParseRequestList(const std::string& blob, RequestList* out) {
  Reader r(blob);
  if (!Header(r)) return false;
  uint8_t shutdown;
  int32_t n;
  if (!r.U8(&shutdown) || !r.I32(&n) || n < 0) return false;
  out->shutdown = shutdown != 0;
  out->requests.clear();
  out->requests.reserve(n);
  for (int32_t i = 0; i < n; ++i) {
    Request req;
    int32_t rt, dt, ndim;
    if (!r.I32(&req.request_rank) || !r.I32(&rt) || !r.I32(&dt) ||
        !r.I32(&req.root_rank) || !r.I32(&req.device) ||
        !r.Str(&req.tensor_name) || !r.I32(&ndim) || ndim < 0)
      return false;
    req.request_type = static_cast<RequestType>(rt);
    req.tensor_type = static_cast<DataType>(dt);
    req.tensor_shape.resize(ndim);
    for (int32_t d = 0; d < ndim; ++d)
      if (!r.I64(&req.tensor_shape[d])) return false;
    out->requests.push_back(std::move(req));
  }
  return true;
}

std::string SerializeResponseList(const ResponseList& list) {
  Writer w;
  w.Raw(kMagic, 4);
  w.U8(kVersion);
  w.U8(list.shutdown ? 1 : 0);
  w.I32(static_cast<int32_t>(list.responses.size()));
  for (const Response& res : list.responses) {
    w.I32(static_cast<int32_t>(res.response_type));
    w.Str(res.error_message);
    w.I32(static_cast<int32_t>(res.tensor_names.size()));
    for (const auto& name : res.tensor_names) w.Str(name);
    w.I32(static_cast<int32_t>(res.devices.size()));
    for (int32_t d : res.devices) w.I32(d);
    w.I32(static_cast<int32_t>(res.tensor_sizes.size()));
    for (int64_t s : res.tensor_sizes) w.I64(s);
  }
  return std::move(w.out);
}

bool ParseResponseList(const std::string& blob, ResponseList* out) {
  Reader r(blob);
  if (!Header(r)) return false;
  uint8_t shutdown;
  int32_t n;
  if (!r.U8(&shutdown) || !r.I32(&n) || n < 0) return false;
  out->shutdown = shutdown != 0;
  out->responses.clear();
  out->responses.reserve(n);
  for (int32_t i = 0; i < n; ++i) {
    Response res;
    int32_t rt, nn, nd, ns;
    if (!r.I32(&rt) || !r.Str(&res.error_message) || !r.I32(&nn) || nn < 0)
      return false;
    res.response_type = static_cast<ResponseType>(rt);
    res.tensor_names.resize(nn);
    for (int32_t k = 0; k < nn; ++k)
      if (!r.Str(&res.tensor_names[k])) return false;
    if (!r.I32(&nd) || nd < 0) return false;
    res.devices.resize(nd);
    for (int32_t k = 0; k < nd; ++k)
      if (!r.I32(&res.devices[k])) return false;
    if (!r.I32(&ns) || ns < 0) return false;
    res.tensor_sizes.resize(ns);
    for (int32_t k = 0; k < ns; ++k)
      if (!r.I64(&res.tensor_sizes[k])) return false;
    out->responses.push_back(std::move(res));
  }
  return true;
}

const char* DataTypeName(DataType t) {
  // Name strings parity with the reference's DataType_Name (message.cc).
  switch (t) {
    case DataType::HOROVOD_UINT8: return "uint8";
    case DataType::HOROVOD_INT8: return "int8";
    case DataType::HOROVOD_UINT16: return "uint16";
    case DataType::HOROVOD_INT16: return "int16";
    case DataType::HOROVOD_INT32: return "int32";
    case DataType::HOROVOD_INT64: return "int64";
    case DataType::HOROVOD_FLOAT16: return "float16";
    case DataType::HOROVOD_FLOAT32: return "float32";
    case DataType::HOROVOD_FLOAT64: return "float64";
    case DataType::HOROVOD_BOOL: return "bool";
    case DataType::HOROVOD_BFLOAT16: return "bfloat16";
  }
  return "unknown";
}

const char* RequestTypeName(RequestType t) {
  switch (t) {
    case RequestType::ALLREDUCE: return "allreduce";
    case RequestType::ALLGATHER: return "allgather";
    case RequestType::BROADCAST: return "broadcast";
    case RequestType::ALLTOALL: return "alltoall";
  }
  return "unknown";
}

}  // namespace hvdtpu
