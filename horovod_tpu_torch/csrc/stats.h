// Per-collective profiling statistics (native core).
//
// Reference equivalent: the fork's counters + per-message-size time
// histograms in HorovodGlobalState (horovod/common/global_state.h:113-141)
// and the shutdown dump write_to_file (horovod/common/operations.cc:219-317).
// Same dump layout as the Python mirror in horovod_tpu_torch/stats.py.
#pragma once

#include <cstdint>
#include <map>
#include <mutex>
#include <string>
#include <unordered_map>

namespace hvdtpu {

struct OpStats {
  int64_t counter = 0;
  int64_t total_time_us = 0;
  std::map<int64_t, int64_t> size_count;
  std::map<int64_t, int64_t> size_time_us;
};

class CollectiveStats {
 public:
  void Record(const std::string& op, int64_t nbytes, int64_t time_us);
  int64_t Counter(const std::string& op) const;
  int64_t TotalTimeUs(const std::string& op) const;
  // CSV-ish dump, fork layout (operations.cc:219-317). Returns 0 on success.
  int WriteToFile(const std::string& path) const;
  // Copies up to `cap` (size, count, total_us) histogram rows, ascending by
  // size; returns the number of rows the op actually has.
  int Histogram(const std::string& op, int64_t* sizes, int64_t* counts,
                int64_t* times_us, int cap) const;

 private:
  mutable std::mutex mu_;
  std::unordered_map<std::string, OpStats> ops_;
};

}  // namespace hvdtpu
