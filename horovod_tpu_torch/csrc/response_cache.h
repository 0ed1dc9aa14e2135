// LRU response cache (native core).
//
// Reference equivalent: ResponseCache (horovod/common/response_cache.h:44,
// response_cache.cc) — steady-state training loops re-submit identical
// tensor metadata every step; a hit means negotiation/validation can be
// skipped. The reference synchronizes hit bits across ranks with a bit-vector
// MPI allreduce (response_cache.cc:304-390); in the single-controller engine
// all ranks share one cache, so the cross-rank agreement check lives with the
// caller (engine._run_cycle) instead.
#pragma once

#include <cstdint>
#include <list>
#include <mutex>
#include <string>
#include <unordered_map>

namespace hvdtpu {

class ResponseCache {
 public:
  explicit ResponseCache(int capacity) : capacity_(capacity) {}

  // Returns true on hit (and bumps LRU recency + hit counter).
  bool Lookup(const std::string& key);
  void Put(const std::string& key);
  // Drops one entry if present (stalled-tensor invalidation; reference:
  // InvalidateStalledCachedTensors, operations.cc:899-913).
  void Remove(const std::string& key);
  int64_t hits() const { return hits_; }
  int64_t misses() const { return misses_; }
  int64_t size() const;

 private:
  int capacity_;
  mutable std::mutex mu_;
  std::list<std::string> lru_;  // front = most recent
  std::unordered_map<std::string, std::list<std::string>::iterator> map_;
  int64_t hits_ = 0;
  int64_t misses_ = 0;
};

}  // namespace hvdtpu
