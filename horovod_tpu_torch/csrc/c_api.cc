// C ABI for the native control-plane components, consumed from Python via
// ctypes (horovod_tpu_torch/native.py).
//
// Reference equivalent: the C API surface of horovod/common/operations.h:53-103
// (horovod_init/..., EnqueueTensor*) exposed through ctypes in
// common/basics.py. Here the collectives themselves are XLA programs driven
// from Python, so the native surface is the control plane: stats, response
// cache, fusion planning and timeline writing. The request-list format is
// wire.py's (the coordinator's one serializer); the reference package's
// native message format and half converters have no caller in this
// runtime.

#include <cstdint>
#include <cstring>
#include <vector>

#include "fusion.h"
#include "gaussian_process.h"
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

}  // extern "C"
