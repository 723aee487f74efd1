// LRU cache of negotiated responses — the steady-state fast path.
//
// Reference: horovod/common/response_cache.{h,cc} — after a tensor has been
// negotiated once, later cycles communicate it as a cache *slot* instead of
// a re-serialized Request; when every queued tensor is a cache hit on every
// rank, the whole negotiation payload is a handful of slot ids (the
// reference packs them as bit vectors synced with MPI_Allreduce BAND,
// response_cache.h:107-167; here they ride the normal coordinator messages
// as position lists, which equally skips request serialization).
//
// Coherence invariant (same as the reference's): every rank performs
// identical put/evict sequences because puts happen in ResponseList order,
// which the coordinator broadcast makes identical everywhere — so slot ids
// agree across ranks without any extra synchronization.
#pragma once

#include <cstdint>
#include <list>
#include <string>
#include <unordered_map>
#include <vector>

#include "wire.h"

namespace hvdtpu {

class ResponseCache {
 public:
  explicit ResponseCache(size_t capacity) : capacity_(capacity) {}

  bool enabled() const { return capacity_ > 0; }

  // Slot of `req` if this rank's cached entry matches it exactly
  // (name + type + dtype + shape + op params); -1 on miss.
  int32_t Lookup(const Request& req) const;

  // Insert (or refresh) the response negotiated for `req`; evicts LRU when
  // full.  Must be called in ResponseList order on every rank.
  void Put(const Request& req, const Response& resp);

  // The cached response in `slot` (valid until the next Put).
  const Response& Get(uint32_t slot) const { return slots_[slot].response; }

  // The request stored in `slot`, or nullptr when the slot is not live.
  // Used by the coordinator's divergence repair (see Controller): rank 0's
  // copy of the (globally coherent) cache identifies which tensor a
  // worker's slot vote refers to.
  const Request* RequestFor(uint32_t slot) const {
    return (slot < slots_.size() && slots_[slot].live)
               ? &slots_[slot].request
               : nullptr;
  }

  // Mark slot most-recently-used (call when a cached response executes).
  void Touch(uint32_t slot);

  size_t size() const { return by_name_.size(); }

 private:
  struct Slot {
    Request request;   // this rank's request params at insertion
    Response response;
    bool live = false;
    std::list<uint32_t>::iterator lru_it;
  };

  size_t capacity_;
  std::vector<Slot> slots_;
  std::vector<uint32_t> free_slots_;
  std::list<uint32_t> lru_;  // front = most recent
  std::unordered_map<std::string, uint32_t> by_name_;
};

}  // namespace hvdtpu
