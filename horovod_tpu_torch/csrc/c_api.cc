// C ABI for the native control-plane components, consumed from Python via
// ctypes (horovod_tpu_torch/native.py).
//
// Reference equivalent: the C API surface of horovod/common/operations.h:53-103
// (horovod_init/..., EnqueueTensor*) exposed through ctypes in
// common/basics.py. Here the collectives themselves are XLA programs driven
// from Python, so the native surface is the control plane: stats, response
// cache, fusion planning, timeline writing, message wire format, GP/EI
// autotuning, and bf16 conversion. The port's coordinator serializes with
// wire.py, whose bytes hvd_request_list_parse reads; torch casts its half
// types itself, and the converters are the reference's (the fp16 cast
// repaired: half.h), held to torch's casts by tests/test_torch_native.py.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "fusion.h"
#include "gaussian_process.h"
#include "half.h"
#include "message.h"
#include "response_cache.h"
#include "stats.h"
#include "timeline.h"

using namespace hvdtpu;

extern "C" {

// ------------------------------------------------------------------ stats
void* hvd_stats_new() { return new CollectiveStats(); }
void hvd_stats_free(void* s) { delete static_cast<CollectiveStats*>(s); }
void hvd_stats_record(void* s, const char* op, int64_t nbytes,
                      int64_t time_us) {
  static_cast<CollectiveStats*>(s)->Record(op, nbytes, time_us);
}
int64_t hvd_stats_counter(void* s, const char* op) {
  return static_cast<CollectiveStats*>(s)->Counter(op);
}
int64_t hvd_stats_total_time_us(void* s, const char* op) {
  return static_cast<CollectiveStats*>(s)->TotalTimeUs(op);
}
int hvd_stats_write_file(void* s, const char* path) {
  return static_cast<CollectiveStats*>(s)->WriteToFile(path);
}
int hvd_stats_histogram(void* s, const char* op, int64_t* sizes,
                        int64_t* counts, int64_t* times_us, int cap) {
  return static_cast<CollectiveStats*>(s)->Histogram(op, sizes, counts,
                                                     times_us, cap);
}

// ------------------------------------------------------------ response cache
void* hvd_cache_new(int capacity) { return new ResponseCache(capacity); }
void hvd_cache_free(void* c) { delete static_cast<ResponseCache*>(c); }
int hvd_cache_lookup(void* c, const char* key) {
  return static_cast<ResponseCache*>(c)->Lookup(key) ? 1 : 0;
}
void hvd_cache_put(void* c, const char* key) {
  static_cast<ResponseCache*>(c)->Put(key);
}
void hvd_cache_remove(void* c, const char* key) {
  static_cast<ResponseCache*>(c)->Remove(key);
}
int64_t hvd_cache_hits(void* c) {
  return static_cast<ResponseCache*>(c)->hits();
}
int64_t hvd_cache_misses(void* c) {
  return static_cast<ResponseCache*>(c)->misses();
}
int64_t hvd_cache_size(void* c) {
  return static_cast<ResponseCache*>(c)->size();
}

// ---------------------------------------------------------------- fusion
int hvd_fusion_plan(const int64_t* nbytes, const int32_t* dtype_id, int n,
                    int64_t threshold, int32_t* group_out) {
  std::vector<FusionEntry> entries(n);
  for (int i = 0; i < n; ++i) entries[i] = {nbytes[i], dtype_id[i]};
  std::vector<int32_t> groups;
  int ng = PlanFusion(entries, threshold, &groups);
  std::memcpy(group_out, groups.data(), n * sizeof(int32_t));
  return ng;
}
int64_t hvd_fusion_offsets(const int64_t* nbytes, int n, int64_t* offsets) {
  std::vector<int64_t> in(nbytes, nbytes + n), out;
  int64_t total;
  FusionOffsets(in, &out, &total);
  std::memcpy(offsets, out.data(), n * sizeof(int64_t));
  return total;
}

// --------------------------------------------------------------- timeline
void* hvd_timeline_new(const char* path, int mark_cycles) {
  auto* t = new TimelineWriter(path, mark_cycles != 0);
  if (!t->ok()) {
    delete t;
    return nullptr;
  }
  return t;
}
void hvd_timeline_event(void* t, const char* tensor, const char* name,
                        char phase, int64_t ts_us, int tid) {
  static_cast<TimelineWriter*>(t)->Event(tensor, name ? name : "", phase,
                                         ts_us, tid);
}
void hvd_timeline_cycle(void* t, int64_t ts_us) {
  static_cast<TimelineWriter*>(t)->MarkCycle(ts_us);
}
void hvd_timeline_counter(void* t, const char* name, int64_t ts_us,
                          double value) {
  static_cast<TimelineWriter*>(t)->Counter(name ? name : "", ts_us, value);
}
void hvd_timeline_close(void* t) {
  auto* tw = static_cast<TimelineWriter*>(t);
  tw->Close();
  delete tw;
}

// ---------------------------------------------------------------- messages
// Serializes a request list given parallel arrays. Returns the blob length;
// call with blob=nullptr to size, then again with a buffer.
int64_t hvd_request_list_serialize(
    int n, const int32_t* ranks, const int32_t* op_types,
    const int32_t* dtypes, const int32_t* root_ranks, const int32_t* devices,
    const char** names, const int32_t* ndims, const int64_t* dims_flat,
    int shutdown, char* blob, int64_t blob_cap) {
  RequestList list;
  list.shutdown = shutdown != 0;
  int64_t dpos = 0;
  for (int i = 0; i < n; ++i) {
    Request r;
    r.request_rank = ranks[i];
    r.request_type = static_cast<RequestType>(op_types[i]);
    r.tensor_type = static_cast<DataType>(dtypes[i]);
    r.root_rank = root_ranks[i];
    r.device = devices[i];
    r.tensor_name = names[i];
    r.tensor_shape.assign(dims_flat + dpos, dims_flat + dpos + ndims[i]);
    dpos += ndims[i];
    list.requests.push_back(std::move(r));
  }
  std::string out = SerializeRequestList(list);
  if (blob != nullptr && static_cast<int64_t>(out.size()) <= blob_cap)
    std::memcpy(blob, out.data(), out.size());
  return static_cast<int64_t>(out.size());
}

// Parses a blob; returns n requests (<0 on error). Caller passes arrays
// sized >= max_requests / max_total_dims; names_buf receives
// NUL-separated names.
int hvd_request_list_parse(const char* blob, int64_t blob_len,
                           int max_requests, int64_t max_total_dims,
                           int32_t* ranks, int32_t* op_types, int32_t* dtypes,
                           int32_t* root_ranks, int32_t* devices,
                           int32_t* ndims, int64_t* dims_flat,
                           char* names_buf, int64_t names_cap,
                           int* shutdown) {
  RequestList list;
  if (!ParseRequestList(std::string(blob, blob_len), &list)) return -1;
  if (static_cast<int>(list.requests.size()) > max_requests) return -2;
  int64_t dpos = 0, npos = 0;
  for (size_t i = 0; i < list.requests.size(); ++i) {
    const Request& r = list.requests[i];
    ranks[i] = r.request_rank;
    op_types[i] = static_cast<int32_t>(r.request_type);
    dtypes[i] = static_cast<int32_t>(r.tensor_type);
    root_ranks[i] = r.root_rank;
    devices[i] = r.device;
    ndims[i] = static_cast<int32_t>(r.tensor_shape.size());
    if (dpos + ndims[i] > max_total_dims) return -3;
    for (int64_t d : r.tensor_shape) dims_flat[dpos++] = d;
    int64_t len = static_cast<int64_t>(r.tensor_name.size()) + 1;
    if (npos + len > names_cap) return -4;
    std::memcpy(names_buf + npos, r.tensor_name.c_str(), len);
    npos += len;
  }
  *shutdown = list.shutdown ? 1 : 0;
  return static_cast<int>(list.requests.size());
}

// ------------------------------------------------------------ bayes opt
void* hvd_bo_new(int dim, const double* lo, const double* hi, double xi,
                 uint64_t seed) {
  return new BayesianOptimization(std::vector<double>(lo, lo + dim),
                                  std::vector<double>(hi, hi + dim), xi,
                                  seed);
}
void hvd_bo_free(void* b) { delete static_cast<BayesianOptimization*>(b); }
void hvd_bo_add_sample(void* b, const double* x, int dim, double y) {
  static_cast<BayesianOptimization*>(b)->AddSample(
      std::vector<double>(x, x + dim), y);
}
void hvd_bo_suggest(void* b, double* x_out, int dim) {
  std::vector<double> s = static_cast<BayesianOptimization*>(b)->Suggest();
  std::memcpy(x_out, s.data(), dim * sizeof(double));
}

// ------------------------------------------------------------------ half
void hvd_f32_to_bf16(const float* src, uint16_t* dst, int64_t n) {
  Float32ToBfloat16(src, dst, n);
}
void hvd_bf16_to_f32(const uint16_t* src, float* dst, int64_t n) {
  Bfloat16ToFloat32(src, dst, n);
}
void hvd_f32_to_f16(const float* src, uint16_t* dst, int64_t n) {
  Float32ToFloat16(src, dst, n);
}
void hvd_f16_to_f32(const uint16_t* src, float* dst, int64_t n) {
  Float16ToFloat32(src, dst, n);
}
void hvd_bf16_sum(const uint16_t* a, const uint16_t* b, uint16_t* out,
                  int64_t n) {
  Bfloat16Sum(a, b, out, n);
}

}  // extern "C"
