// Chrome-tracing timeline writer (native core).
//
// Reference equivalent: horovod/common/timeline.{h,cc} — an async writer
// thread fed through a lock-free SPSC queue (timeline.h:46-74), emitting
// Chrome about:tracing JSON with one "process" row per tensor name and the
// NEGOTIATE/TOP-LEVEL/ACTIVITY state machine. Here the queue is a mutex +
// condvar deque (the contention profile of a trace writer does not need
// lock-free), the event schema matches horovod_tpu_torch/timeline.py.
#pragma once

#include <condition_variable>
#include <cstdint>
#include <deque>
#include <fstream>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>

namespace hvdtpu {

class TimelineWriter {
 public:
  TimelineWriter(const std::string& path, bool mark_cycles);
  ~TimelineWriter();

  // phase: 'B' begin, 'E' end, 'i' instant, 'M' metadata.
  void Event(const std::string& tensor, const std::string& name, char phase,
             int64_t ts_us, int tid);
  void MarkCycle(int64_t ts_us);
  // Chrome "C" counter sample (metrics splice; horovod_tpu_torch/metrics.py).
  void Counter(const std::string& name, int64_t ts_us, double value);
  void Close();
  bool ok() const { return ok_; }

 private:
  struct Ev {
    int pid;
    int tid;
    char phase;
    int64_t ts_us;
    std::string name;   // empty for 'E'
    double value = 0.;  // 'C' counter samples only
  };
  int PidFor(const std::string& tensor);
  void WriterLoop();
  void Emit(const Ev& ev);

  std::ofstream file_;
  bool ok_ = false;
  bool mark_cycles_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Ev> queue_;
  bool closing_ = false;
  std::thread writer_;
  std::unordered_map<std::string, int> pids_;
};

}  // namespace hvdtpu
