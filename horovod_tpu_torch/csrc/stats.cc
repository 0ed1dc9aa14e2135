#include "stats.h"

#include <algorithm>
#include <fstream>
#include <vector>

namespace hvdtpu {

// Dump order parity with the Python mirror (horovod_tpu_torch/stats.py OPS) and
// the fork's fixed collective list (operations.cc:219-317).
static const char* kOps[] = {
    "allreduce", "allreduce_cached", "allreduce_jit", "allgather",
    "allgather_jit", "broadcast", "broadcast_jit", "alltoall",
    "alltoall_jit", "reducescatter", "reducescatter_jit", "gather",
    "gatherv"};

void CollectiveStats::Record(const std::string& op, int64_t nbytes,
                             int64_t time_us) {
  std::lock_guard<std::mutex> lock(mu_);
  OpStats& s = ops_[op];
  s.counter++;
  s.total_time_us += time_us;
  s.size_count[nbytes]++;
  s.size_time_us[nbytes] += time_us;
}

int64_t CollectiveStats::Counter(const std::string& op) const {
  std::lock_guard<std::mutex> lock(mu_);
  auto it = ops_.find(op);
  return it == ops_.end() ? 0 : it->second.counter;
}

int64_t CollectiveStats::TotalTimeUs(const std::string& op) const {
  std::lock_guard<std::mutex> lock(mu_);
  auto it = ops_.find(op);
  return it == ops_.end() ? 0 : it->second.total_time_us;
}

int CollectiveStats::Histogram(const std::string& op, int64_t* sizes,
                               int64_t* counts, int64_t* times_us,
                               int cap) const {
  std::lock_guard<std::mutex> lock(mu_);
  auto it = ops_.find(op);
  if (it == ops_.end()) return 0;
  const OpStats& s = it->second;
  int i = 0;
  for (const auto& kv : s.size_count) {  // std::map: ascending by size
    if (i < cap) {
      sizes[i] = kv.first;
      counts[i] = kv.second;
      times_us[i] = s.size_time_us.at(kv.first);
    }
    i++;
  }
  return static_cast<int>(s.size_count.size());
}

int CollectiveStats::WriteToFile(const std::string& path) const {
  std::lock_guard<std::mutex> lock(mu_);
  std::ofstream f(path);
  if (!f.is_open()) return 1;
  static const OpStats kEmpty;
  for (const char* op : kOps) {
    auto it = ops_.find(op);
    const OpStats& s = it == ops_.end() ? kEmpty : it->second;
    std::string pretty(op);
    std::replace(pretty.begin(), pretty.end(), '_', ' ');
    f << "Counter " << pretty << "," << s.counter << "\n";
    f << "Time " << pretty << "," << s.total_time_us << ",microseconds\n";
    f << "Message size,count,Time per call,Total time\n";
    for (const auto& kv : s.size_count) {
      int64_t cnt = kv.second;
      int64_t tot = s.size_time_us.at(kv.first);
      f << kv.first << "," << cnt << "," << tot / std::max<int64_t>(cnt, 1)
        << "," << tot << "\n";
    }
  }
  return f.good() ? 0 : 1;
}

}  // namespace hvdtpu
