#include "response_cache.h"

namespace hvdtpu {

namespace {

bool SameParams(const Request& a, const Request& b) {
  return a.request_type == b.request_type && a.dtype == b.dtype &&
         a.shape == b.shape && a.reduce_op == b.reduce_op &&
         a.root_rank == b.root_rank && a.prescale == b.prescale &&
         a.postscale == b.postscale;
}

}  // namespace

int32_t ResponseCache::Lookup(const Request& req) const {
  auto it = by_name_.find(req.tensor_name);
  if (it == by_name_.end()) return -1;
  const Slot& s = slots_[it->second];
  if (!SameParams(s.request, req)) return -1;
  return static_cast<int32_t>(it->second);
}

void ResponseCache::Put(const Request& req, const Response& resp) {
  if (!enabled()) return;
  auto it = by_name_.find(req.tensor_name);
  if (it != by_name_.end()) {  // refresh in place (params may have changed)
    Slot& s = slots_[it->second];
    s.request = req;
    s.response = resp;
    Touch(it->second);
    return;
  }
  uint32_t slot;
  if (!free_slots_.empty()) {
    slot = free_slots_.back();
    free_slots_.pop_back();
  } else if (slots_.size() < capacity_) {
    slot = static_cast<uint32_t>(slots_.size());
    slots_.emplace_back();
  } else {  // evict LRU — deterministic across ranks (identical sequences)
    slot = lru_.back();
    lru_.pop_back();
    by_name_.erase(slots_[slot].request.tensor_name);
    slots_[slot].live = false;
  }
  Slot& s = slots_[slot];
  s.request = req;
  s.response = resp;
  s.live = true;
  lru_.push_front(slot);
  s.lru_it = lru_.begin();
  by_name_[req.tensor_name] = slot;
}

void ResponseCache::Touch(uint32_t slot) {
  Slot& s = slots_[slot];
  if (!s.live) return;
  lru_.erase(s.lru_it);
  lru_.push_front(slot);
  s.lru_it = lru_.begin();
}


}  // namespace hvdtpu
