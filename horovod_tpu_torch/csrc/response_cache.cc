#include "response_cache.h"

namespace hvdtpu {

bool ResponseCache::Lookup(const std::string& key) {
  std::lock_guard<std::mutex> lock(mu_);
  if (capacity_ <= 0) return false;
  auto it = map_.find(key);
  if (it == map_.end()) {
    misses_++;
    return false;
  }
  lru_.splice(lru_.begin(), lru_, it->second);
  hits_++;
  return true;
}

void ResponseCache::Put(const std::string& key) {
  std::lock_guard<std::mutex> lock(mu_);
  if (capacity_ <= 0) return;
  auto it = map_.find(key);
  if (it != map_.end()) {
    lru_.splice(lru_.begin(), lru_, it->second);
    return;
  }
  lru_.push_front(key);
  map_[key] = lru_.begin();
  while (static_cast<int>(lru_.size()) > capacity_) {
    map_.erase(lru_.back());
    lru_.pop_back();
  }
}

void ResponseCache::Remove(const std::string& key) {
  std::lock_guard<std::mutex> lock(mu_);
  auto it = map_.find(key);
  if (it == map_.end()) return;
  lru_.erase(it->second);
  map_.erase(it);
}

int64_t ResponseCache::size() const {
  std::lock_guard<std::mutex> lock(mu_);
  return static_cast<int64_t>(lru_.size());
}

}  // namespace hvdtpu
