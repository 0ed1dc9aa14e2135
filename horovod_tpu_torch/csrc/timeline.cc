#include "timeline.h"

namespace hvdtpu {

TimelineWriter::TimelineWriter(const std::string& path, bool mark_cycles)
    : mark_cycles_(mark_cycles) {
  file_.open(path);
  if (!file_.is_open()) return;
  file_ << "[\n";
  ok_ = true;
  writer_ = std::thread(&TimelineWriter::WriterLoop, this);
}

TimelineWriter::~TimelineWriter() { Close(); }

int TimelineWriter::PidFor(const std::string& tensor) {
  auto it = pids_.find(tensor);
  if (it != pids_.end()) return it->second;
  int pid = static_cast<int>(pids_.size()) + 1;
  pids_[tensor] = pid;
  // metadata row naming the tensor (same schema as the reference's
  // process_name metadata events)
  Ev meta{pid, 0, 'M', 0, tensor};
  {
    std::lock_guard<std::mutex> lock(mu_);
    queue_.push_back(meta);
  }
  cv_.notify_one();
  return pid;
}

void TimelineWriter::Event(const std::string& tensor, const std::string& name,
                           char phase, int64_t ts_us, int tid) {
  if (!ok_) return;
  int pid;
  {
    std::lock_guard<std::mutex> lock(mu_);
    auto it = pids_.find(tensor);
    pid = (it != pids_.end()) ? it->second : -1;
  }
  if (pid < 0) pid = PidFor(tensor);
  Ev ev{pid, tid, phase, ts_us, name};
  {
    std::lock_guard<std::mutex> lock(mu_);
    queue_.push_back(std::move(ev));
  }
  cv_.notify_one();
}

void TimelineWriter::MarkCycle(int64_t ts_us) {
  if (!ok_ || !mark_cycles_) return;
  Ev ev{0, 0, 'i', ts_us, "CYCLE_START"};
  {
    std::lock_guard<std::mutex> lock(mu_);
    queue_.push_back(std::move(ev));
  }
  cv_.notify_one();
}

void TimelineWriter::Counter(const std::string& name, int64_t ts_us,
                             double value) {
  if (!ok_) return;
  Ev ev{0, 0, 'C', ts_us, name, value};
  {
    std::lock_guard<std::mutex> lock(mu_);
    queue_.push_back(std::move(ev));
  }
  cv_.notify_one();
}

static std::string JsonEscape(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      default: out += c;
    }
  }
  return out;
}

void TimelineWriter::Emit(const Ev& ev) {
  if (ev.phase == 'M') {
    file_ << "{\"name\": \"process_name\", \"ph\": \"M\", \"pid\": " << ev.pid
          << ", \"args\": {\"name\": \"" << JsonEscape(ev.name) << "\"}},\n";
  } else if (ev.phase == 'E') {
    file_ << "{\"ph\": \"E\", \"pid\": " << ev.pid << ", \"tid\": " << ev.tid
          << ", \"ts\": " << ev.ts_us << "},\n";
  } else if (ev.phase == 'i') {
    file_ << "{\"name\": \"" << JsonEscape(ev.name)
          << "\", \"ph\": \"i\", \"pid\": " << ev.pid << ", \"tid\": "
          << ev.tid << ", \"ts\": " << ev.ts_us << ", \"s\": \"g\"},\n";
  } else if (ev.phase == 'C') {
    file_ << "{\"name\": \"" << JsonEscape(ev.name)
          << "\", \"ph\": \"C\", \"pid\": " << ev.pid << ", \"tid\": "
          << ev.tid << ", \"ts\": " << ev.ts_us << ", \"args\": {\"value\": "
          << ev.value << "}},\n";
  } else {
    file_ << "{\"name\": \"" << JsonEscape(ev.name) << "\", \"ph\": \""
          << ev.phase << "\", \"pid\": " << ev.pid << ", \"tid\": " << ev.tid
          << ", \"ts\": " << ev.ts_us << "},\n";
  }
}

void TimelineWriter::WriterLoop() {
  std::unique_lock<std::mutex> lock(mu_);
  while (true) {
    cv_.wait(lock, [&] { return !queue_.empty() || closing_; });
    while (!queue_.empty()) {
      Ev ev = std::move(queue_.front());
      queue_.pop_front();
      lock.unlock();
      Emit(ev);
      lock.lock();
    }
    if (closing_) break;
  }
  file_ << "{}]\n";
  file_.flush();
  file_.close();
}

void TimelineWriter::Close() {
  if (!ok_) return;
  {
    std::lock_guard<std::mutex> lock(mu_);
    closing_ = true;
  }
  cv_.notify_one();
  if (writer_.joinable()) writer_.join();
  ok_ = false;
}

}  // namespace hvdtpu
