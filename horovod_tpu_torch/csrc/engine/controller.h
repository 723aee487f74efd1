// Rank-0 coordinator negotiation — the native controller.
//
// Reference: horovod/common/controller.cc.  Workers send their ready-tensor
// RequestLists to rank 0 each cycle; rank 0 counts per-name readiness
// (IncrementTensorCount, controller.cc:789-812), validates consistency and
// builds Responses (ConstructResponse, controller.cc:378-611), fuses
// adjacent allreduces under the fusion threshold (FuseResponses,
// controller.cc:640-761), and broadcasts the ResponseList.  Join and
// shutdown flags ride the same messages (controller.cc:219-221,256-259).
// The stall inspector (stall_inspector.cc) lives here too: rank 0 warns on
// tensors some ranks submitted and others haven't.
#pragma once

#include <chrono>
#include <cstdint>
#include <map>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

#include "response_cache.h"
#include "timeline.h"
#include "wire.h"

namespace hvdtpu {

// Fuse adjacent ALLREDUCE responses with identical dtype/op/scaling under
// the fusion threshold (reference FuseResponses, controller.cc:640-761,
// same-dtype look at :676-689).  Free function because EVERY rank fuses the
// [cached + new] response stream locally — inputs are identical everywhere
// (coordinator broadcast), so outputs are too.
void FuseResponseList(std::vector<Response>* responses,
                      int64_t fusion_threshold_bytes);

struct ControllerConfig {
  int world_size = 1;
  int64_t fusion_threshold_bytes = 64 * 1024 * 1024;
  double stall_warn_secs = 60.0;
  double stall_shutdown_secs = 0.0;  // 0 = never escalate
};

class Controller {
 public:
  explicit Controller(const ControllerConfig& cfg) : cfg_(cfg) {}

  // One coordinator cycle: merge all ranks' lists (index = rank), emit the
  // ResponseList every rank will execute.  `cache` is rank 0's copy of the
  // (globally coherent) response cache, used to count cache-slot readiness;
  // responses for ready slots come back as ResponseList::cached_slots.
  // Sets *should_shutdown when any rank raised the flag or a stall
  // escalated.
  ResponseList ComputeResponseList(const std::vector<RequestList>& lists,
                                   bool* should_shutdown);

  int joined_count() const { return static_cast<int>(joined_ranks_.size()); }

  // Rank 0's timeline receives the negotiation events (reference emits them
  // from IncrementTensorCount / response construction).
  void SetTimeline(Timeline* t) { timeline_ = t; }

  // Rank 0's replicated response cache, consulted to reconcile slot votes
  // against full requests for the same tensor (divergence repair).
  void SetCache(const ResponseCache* c) { cache_ = c; }

 private:
  struct TableEntry {
    std::map<int32_t, Request> requests;  // rank -> request
    std::chrono::steady_clock::time_point first_seen;
    uint64_t arrival_order = 0;
  };

  std::string Validate(const TableEntry& e) const;
  Response ConstructResponse(const TableEntry& e) const;
  void CheckStalls(bool* should_shutdown);

  Timeline* timeline_ = nullptr;
  const ResponseCache* cache_ = nullptr;
  ControllerConfig cfg_;
  std::unordered_map<std::string, TableEntry> table_;
  std::map<uint32_t, std::set<int32_t>> slot_ready_;  // cache slot -> ranks
  std::set<int32_t> joined_ranks_;
  bool shutdown_seen_ = false;
  uint64_t arrival_counter_ = 0;
  std::chrono::steady_clock::time_point last_stall_check_ =
      std::chrono::steady_clock::now();
};

}  // namespace hvdtpu
