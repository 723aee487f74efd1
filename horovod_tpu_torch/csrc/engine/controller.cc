#include "controller.h"

#include <algorithm>

#include "common.h"

namespace hvdtpu {

namespace {

const char* OpName(RequestType t) {
  switch (t) {
    case RequestType::ALLREDUCE: return "ALLREDUCE";
    case RequestType::ALLGATHER: return "ALLGATHER";
    case RequestType::BROADCAST: return "BROADCAST";
    case RequestType::JOIN: return "JOIN";
    case RequestType::ADASUM: return "ADASUM";
    case RequestType::ALLTOALL: return "ALLTOALL";
    case RequestType::BARRIER: return "BARRIER";
    case RequestType::REDUCESCATTER: return "REDUCESCATTER";
  }
  return "?";
}

std::string ShapeStr(const std::vector<int64_t>& s) {
  std::string out = "(";
  for (size_t i = 0; i < s.size(); i++) {
    if (i) out += ", ";
    out += std::to_string(s[i]);
  }
  out += ")";
  return out;
}

}  // namespace

// Consistency checks of ConstructResponse (reference controller.cc:378-611).
// Error strings match the Python controller (runtime/controller.py) so both
// engines surface identical messages to tests and users.
std::string Controller::Validate(const TableEntry& e) const {
  const Request& first = e.requests.begin()->second;
  if (first.request_type == RequestType::ALLGATHER && first.shape.empty()) {
    return "Allgather of " + first.tensor_name +
           " requires at least a 1-dimensional tensor (got a scalar).";
  }
  if (first.request_type == RequestType::REDUCESCATTER &&
      first.shape.empty()) {
    return "Reducescatter of " + first.tensor_name +
           " requires at least a 1-dimensional tensor (got a scalar).";
  }
  for (const auto& [rank, r] : e.requests) {
    if (r.dtype != first.dtype) {
      return "Mismatched data types for " + first.tensor_name + ": rank " +
             std::to_string(first.request_rank) + " sent " +
             DataTypeName(first.dtype) + ", rank " + std::to_string(rank) +
             " sent " + DataTypeName(r.dtype) + ".";
    }
    if (r.request_type != first.request_type) {
      return "Mismatched collective operations for " + first.tensor_name + ".";
    }
    if (r.reduce_op != first.reduce_op || r.prescale != first.prescale ||
        r.postscale != first.postscale) {
      return "Mismatched reduce options for " + first.tensor_name + ".";
    }
    switch (first.request_type) {
      case RequestType::ALLREDUCE:
      case RequestType::ADASUM:
      case RequestType::BROADCAST:
      case RequestType::ALLTOALL:
      case RequestType::REDUCESCATTER:
        if (r.shape != first.shape) {
          return "Mismatched shapes for " + first.tensor_name + ": " +
                 ShapeStr(first.shape) + " vs " + ShapeStr(r.shape) + ".";
        }
        break;
      case RequestType::ALLGATHER: {
        if (r.shape.empty()) {
          return "Allgather of " + first.tensor_name +
                 " requires at least a 1-dimensional tensor (got a scalar).";
        }
        if (!std::equal(r.shape.begin() + 1, r.shape.end(),
                        first.shape.begin() + 1, first.shape.end())) {
          return "Mismatched allgather shapes beyond dim 0 for " +
                 first.tensor_name + ".";
        }
        break;
      }
      default:
        break;
    }
    if (first.request_type == RequestType::BROADCAST &&
        r.root_rank != first.root_rank) {
      return "Mismatched root ranks for broadcast " + first.tensor_name +
             ": " + std::to_string(first.root_rank) + " vs " +
             std::to_string(r.root_rank) + ".";
    }
  }
  return "";
}

Response Controller::ConstructResponse(const TableEntry& e) const {
  const Request& first = e.requests.begin()->second;
  Response resp;
  resp.response_type = static_cast<ResponseType>(first.request_type);
  resp.tensor_names = {first.tensor_name};
  resp.dtype = first.dtype;
  resp.reduce_op = first.reduce_op;
  resp.root_rank = first.root_rank;
  resp.prescale = first.prescale;
  resp.postscale = first.postscale;
  resp.shapes = {first.shape};
  if (first.request_type == RequestType::ALLGATHER) {
    // Ragged per-rank dim0 sizes; joined/absent ranks contribute 0 rows
    // (reference controller.cc:453-518).
    resp.tensor_sizes.assign(cfg_.world_size, 0);
    for (const auto& [rank, r] : e.requests)
      resp.tensor_sizes[rank] = r.shape.empty() ? 0 : r.shape[0];
  }
  return resp;
}

void FuseResponseList(std::vector<Response>* responses,
                      int64_t fusion_threshold_bytes) {
  std::vector<Response> fused;
  for (auto& resp : *responses) {
    bool fusible =
        resp.response_type == ResponseType::ALLREDUCE && !fused.empty() &&
        fused.back().response_type == ResponseType::ALLREDUCE &&
        fused.back().dtype == resp.dtype &&
        fused.back().reduce_op == resp.reduce_op &&
        fused.back().prescale == resp.prescale &&
        fused.back().postscale == resp.postscale;
    if (fusible) {
      auto numel = [](const Response& r) {
        int64_t n = 0;
        for (const auto& s : r.shapes) {
          int64_t m = 1;
          for (auto d : s) m *= d;
          n += m;
        }
        return n;
      };
      int64_t bytes = (numel(fused.back()) + numel(resp)) *
                      static_cast<int64_t>(DataTypeSize(resp.dtype));
      if (bytes <= fusion_threshold_bytes) {
        fused.back().tensor_names.push_back(resp.tensor_names[0]);
        fused.back().shapes.push_back(resp.shapes[0]);
        continue;
      }
    }
    fused.push_back(std::move(resp));
  }
  *responses = std::move(fused);
}

ResponseList Controller::ComputeResponseList(
    const std::vector<RequestList>& lists, bool* should_shutdown) {
  ResponseList out;

  // Absorb join/shutdown flags (reference controller.cc:219-221,256-259).
  for (int r = 0; r < static_cast<int>(lists.size()); r++) {
    if (lists[r].shutdown) shutdown_seen_ = true;
    if (lists[r].joined) joined_ranks_.insert(r);
    for (uint32_t slot : lists[r].cache_hits) slot_ready_[slot].insert(r);
  }

  for (const auto& rl : lists) {
    for (const auto& req : rl.requests) {
      if (req.request_type == RequestType::JOIN) continue;
      auto [it, inserted] = table_.try_emplace(req.tensor_name);
      if (inserted) {
        it->second.first_seen = std::chrono::steady_clock::now();
        it->second.arrival_order = arrival_counter_++;
        if (timeline_)
          timeline_->NegotiateStart(req.tensor_name,
                                    OpName(req.request_type));
      }
      if (timeline_)
        timeline_->NegotiateRankReady(req.tensor_name, req.request_rank);
      it->second.requests[req.request_rank] = req;
    }
  }
  out.cache_frozen = !joined_ranks_.empty();

  // Divergence repair: a tuner cache toggle can land on opposite sides of
  // a straggler enqueue, so one rank classifies a tensor as a cache hit
  // (slot vote) while another negotiates it as a full request.  Neither
  // side completes alone — the slot waits on the requesting rank, the
  // request waits on the voting rank.  Rank 0's replicated cache knows the
  // slot's identity, so reconcile: fold each voting rank into the request
  // table using the cached request params, and drop the slot vote.
  if (cache_ != nullptr) {
    for (auto it = slot_ready_.begin(); it != slot_ready_.end();) {
      const Request* cached = cache_->RequestFor(it->first);
      auto tit = cached ? table_.find(cached->tensor_name) : table_.end();
      if (tit == table_.end()) {
        ++it;
        continue;
      }
      for (int32_t r : it->second) {
        Request req = *cached;
        req.request_rank = r;
        tit->second.requests.emplace(r, std::move(req));
        if (timeline_)
          timeline_->NegotiateRankReady(cached->tensor_name, r);
      }
      it = slot_ready_.erase(it);
    }
  }

  int needed = cfg_.world_size - static_cast<int>(joined_ranks_.size());

  // Cache fast path: slots every non-joined rank marked ready.
  for (auto it = slot_ready_.begin(); it != slot_ready_.end();) {
    int count = 0;
    for (int32_t r : it->second)
      if (!joined_ranks_.count(r)) count++;
    if (count >= needed) {
      out.cached_slots.push_back(it->first);
      it = slot_ready_.erase(it);
    } else {
      ++it;
    }
  }
  std::sort(out.cached_slots.begin(), out.cached_slots.end());

  // Ready uncached tensors, in first-arrival order (deterministic).
  std::vector<std::pair<uint64_t, std::string>> ready;
  for (const auto& [name, e] : table_) {
    if (static_cast<int>(e.requests.size()) >= needed)
      ready.emplace_back(e.arrival_order, name);
  }
  std::sort(ready.begin(), ready.end());

  for (const auto& [order, name] : ready) {
    auto it = table_.find(name);
    if (timeline_) {
      timeline_->NegotiateEnd(
          name, OpName(it->second.requests.begin()->second.request_type));
    }
    std::string err = Validate(it->second);
    if (!err.empty()) {
      Response resp;
      resp.response_type = ResponseType::ERROR;
      resp.tensor_names = {name};
      resp.error_message = err;
      out.responses.push_back(std::move(resp));
    } else {
      out.responses.push_back(ConstructResponse(it->second));
    }
    table_.erase(it);
  }

  // Join completion: everyone joined -> JOIN response resets state
  // (reference controller.cc:300-307).
  if (!joined_ranks_.empty() &&
      static_cast<int>(joined_ranks_.size()) == cfg_.world_size) {
    Response resp;
    resp.response_type = ResponseType::JOIN;
    resp.tensor_names = {"join"};
    out.responses.push_back(std::move(resp));
    joined_ranks_.clear();
  }

  CheckStalls(should_shutdown);

  if (shutdown_seen_) *should_shutdown = true;
  out.shutdown = *should_shutdown;
  return out;
}

void Controller::CheckStalls(bool* should_shutdown) {
  // Reference stall_inspector.cc: rank 0 warns when a tensor has been
  // waiting on some ranks past the threshold; optionally escalates to a
  // coordinated shutdown; stalled cached tensors are invalidated.
  auto now = std::chrono::steady_clock::now();
  double since_check =
      std::chrono::duration<double>(now - last_stall_check_).count();
  if (since_check < std::min(cfg_.stall_warn_secs, 10.0)) return;
  last_stall_check_ = now;
  for (const auto& [name, e] : table_) {
    double age = std::chrono::duration<double>(now - e.first_seen).count();
    if (age <= cfg_.stall_warn_secs) continue;
    std::string missing;
    for (int r = 0; r < cfg_.world_size; r++) {
      if (!e.requests.count(r) && !joined_ranks_.count(r)) {
        if (!missing.empty()) missing += ",";
        missing += std::to_string(r);
      }
    }
    HVD_LOG(LogLevel::WARNING, 0,
            "One or more tensors were submitted to be reduced/gathered but "
            "some ranks have not yet done so after %.0f s: tensor %s is "
            "waiting on ranks [%s]",
            age, name.c_str(), missing.c_str());
    // NOTE: the reference invalidates stalled *cached* tensors here
    // (stall_inspector InvalidateStalledCachedTensors), but it coordinates
    // the eviction across ranks through the cache-bit sync.  Our stall check
    // fires on rank-local wall clocks, so a local cache->Erase would free a
    // slot on this rank only and desynchronize slot numbering across the
    // job (slots are negotiated by id).  A stalled tensor is still pending
    // negotiation — it has no cache entry to evict — so we only warn.
    if (cfg_.stall_shutdown_secs > 0 && age > cfg_.stall_shutdown_secs) {
      HVD_LOG(LogLevel::ERROR, 0,
              "Stalled tensor %s exceeded shutdown threshold (%.0f s); "
              "aborting the job",
              name.c_str(), cfg_.stall_shutdown_secs);
      *should_shutdown = true;
    }
  }
}

}  // namespace hvdtpu
