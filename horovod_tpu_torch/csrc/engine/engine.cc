// The native eager engine: global state, background thread, C API.
//
// Reference: horovod/common/operations.cc — singleton HorovodGlobalState
// (operations.cc:114), one background thread owning all communication
// (InitializeHorovodOnce :604-650, BackgroundThreadLoop :333-600, rationale
// for single ownership :311-330), RunLoopOnce cycle (:550), PerformOperation
// executing fused responses (:232-309), Enqueue* APIs (:803-954) and the
// extern "C" surface (:661-799) loaded via ctypes (basics.py).
//
// The Python binding (horovod_tpu_torch/runtime/native.py) exchanges TCP
// addresses over the world's gloo group and then hands
// this engine full ownership of the eager data path: negotiation with the
// rank-0 coordinator, response-cache fast path, tensor fusion, ring
// collectives, Adasum VHDD, timeline, stall inspection.
#include <atomic>
#include <condition_variable>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "common.h"
#include "controller.h"
#include "dtype_math.h"
#include "ops.h"
#include "response_cache.h"
#include "tcp.h"
#include "timeline.h"
#include "wire.h"

namespace hvdtpu {

LogLevel GlobalLogLevel() {
  static LogLevel level = [] {
    const char* v = std::getenv("HVDTPU_LOG_LEVEL");
    if (!v) return LogLevel::WARNING;
    std::string s(v);
    if (s == "trace") return LogLevel::TRACE;
    if (s == "debug") return LogLevel::DEBUG;
    if (s == "info") return LogLevel::INFO;
    if (s == "warning") return LogLevel::WARNING;
    if (s == "error") return LogLevel::ERROR;
    if (s == "fatal") return LogLevel::FATAL;
    return LogLevel::WARNING;
  }();
  return level;
}

namespace {

constexpr const char* kShutdownError =
    "horovod_tpu has been shut down. This was caused by an exception on one "
    "of the ranks or an asymmetric shutdown; check the logs of other ranks."
    "  (reference: common.h:154-159)";

enum HandleStatus : int { kPending = 0, kOk = 1, kError = 2 };

// Completion record behind an integer handle (reference
// horovod/torch/handle_manager.cc).
struct HandleState {
  int status = kPending;
  std::string error;
  std::vector<uint8_t> output;      // result payload
  std::vector<int64_t> out_shape;   // result geometry
};

// One enqueued named tensor (reference TensorTableEntry, common.h:233-250).
struct Entry {
  int64_t handle = -1;
  Request req;
  std::vector<uint8_t> data;
};

class Engine {
 public:
  static Engine& Get() {
    static Engine* e = new Engine();  // leaked on purpose (atexit ordering)
    return *e;
  }

  int Listen() {
    {
      std::lock_guard<std::mutex> l(mu_);
      if (running_) {
        HVD_LOG(LogLevel::ERROR, rank_, "listen: an engine already runs");
        return -1;
      }
    }
    int port = -1;
    Status s = mesh_.Listen(&port);
    if (!s.ok()) {
      HVD_LOG(LogLevel::ERROR, rank_, "listen failed: %s", s.reason.c_str());
      return -1;
    }
    return port;
  }

  int Connect(int rank, int size, const std::vector<std::string>& addrs,
              int64_t fusion_bytes, double cycle_ms, int cache_capacity,
              double stall_warn, double stall_shutdown,
              const std::string& timeline_path, bool timeline_cycles) {
    {
      // A process may run one engine after another (shutdown, then a
      // fresh engine): start each from a clean table and counters.
      std::lock_guard<std::mutex> l(mu_);
      if (running_) return -3;
      table_.clear();
      pending_.clear();
      join_handles_.clear();
      joined_ = false;
      shutdown_requested_ = false;
      done_ = false;
    }
    perf_bytes_ = 0;
    cycles_ = 0;
    responses_ = 0;
    fused_responses_ = 0;
    largest_response_bytes_ = 0;
    rank_ = rank;
    size_ = size;
    fusion_bytes_ = fusion_bytes;
    cycle_ms_ = cycle_ms;
    cache_ = std::make_unique<ResponseCache>(
        static_cast<size_t>(cache_capacity));
    Status s = mesh_.Connect(rank, size, addrs);
    if (!s.ok()) {
      HVD_LOG(LogLevel::ERROR, rank_, "mesh connect failed: %s",
              s.reason.c_str());
      return -1;
    }
    // Every rank records its own timeline (the python side hands each
    // rank a distinct per-rank path; the launcher merges at job end).
    // Negotiation events stay rank-0-only — the controller lives there.
    timeline_.Initialize(timeline_path, rank_, timeline_cycles);
    if (rank_ == 0) {
      ControllerConfig cfg;
      cfg.world_size = size;
      cfg.fusion_threshold_bytes = fusion_bytes;
      cfg.stall_warn_secs = stall_warn;
      cfg.stall_shutdown_secs = stall_shutdown;
      controller_ = std::make_unique<Controller>(cfg);
      controller_->SetCache(cache_.get());
      controller_->SetTimeline(timeline_.enabled() ? &timeline_ : nullptr);
    }
    running_ = true;
    bg_ = std::thread(&Engine::BackgroundLoop, this);
    return 0;
  }

  int64_t Enqueue(RequestType op, const std::string& name, const void* data,
                  const std::vector<int64_t>& shape, DataType dtype,
                  ReduceOp reduce_op, int root_rank, double prescale,
                  double postscale) {
    auto e = std::make_shared<Entry>();
    e->req.request_rank = rank_;
    e->req.request_type = op;
    e->req.tensor_name = name;
    e->req.dtype = dtype;
    e->req.shape = shape;
    e->req.reduce_op = reduce_op;
    e->req.root_rank = root_rank;
    e->req.prescale = prescale;
    e->req.postscale = postscale;
    size_t nbytes =
        static_cast<size_t>(e->req.NumElements()) * DataTypeSize(dtype);
    e->data.resize(nbytes);
    if (data && nbytes) std::memcpy(e->data.data(), data, nbytes);

    std::lock_guard<std::mutex> l(mu_);
    int64_t h = next_handle_++;
    e->handle = h;
    auto hs = std::make_shared<HandleState>();
    handles_[h] = hs;
    if (done_) {
      hs->status = kError;
      hs->error = kShutdownError;
      return h;
    }
    if (table_.count(name)) {
      hs->status = kError;
      hs->error = "Requested to " + std::string(OpLower(op)) +
                  " a tensor with the same name as another tensor that is "
                  "currently being processed.  (reference: common.h:161-164)";
      return h;
    }
    table_[name] = e;
    pending_.push_back(e);
    return h;
  }

  int64_t Join() {
    std::lock_guard<std::mutex> l(mu_);
    int64_t h = next_handle_++;
    auto hs = std::make_shared<HandleState>();
    handles_[h] = hs;
    if (done_) {
      hs->status = kError;
      hs->error = kShutdownError;
      return h;
    }
    joined_ = true;
    join_handles_.push_back(h);
    return h;
  }

  int Poll(int64_t h) {
    std::lock_guard<std::mutex> l(mu_);
    auto it = handles_.find(h);
    return it == handles_.end() ? -1 : it->second->status;
  }

  int Wait(int64_t h) {
    std::unique_lock<std::mutex> l(mu_);
    auto it = handles_.find(h);
    if (it == handles_.end()) return -1;
    auto hs = it->second;
    cv_.wait(l, [&] { return hs->status != kPending; });
    return hs->status;
  }

  std::shared_ptr<HandleState> GetHandle(int64_t h) {
    std::lock_guard<std::mutex> l(mu_);
    auto it = handles_.find(h);
    return it == handles_.end() ? nullptr : it->second;
  }

  void Release(int64_t h) {
    std::lock_guard<std::mutex> l(mu_);
    handles_.erase(h);
  }

  void Shutdown() {
    {
      std::lock_guard<std::mutex> l(mu_);
      if (!running_) {
        done_ = true;
        return;
      }
      // a loop that already ended (a peer's shutdown) is joined all the same
      if (!done_) shutdown_requested_ = true;
    }
    if (bg_.get_id() == std::this_thread::get_id()) return;
    if (bg_.joinable()) bg_.join();
    timeline_.Shutdown();
    std::lock_guard<std::mutex> l(mu_);
    running_ = false;
  }

  bool IsDone() {
    std::lock_guard<std::mutex> l(mu_);
    return done_;
  }

 private:
  Engine() = default;

  static const char* OpLower(RequestType t) {
    switch (t) {
      case RequestType::ALLREDUCE: return "allreduce";
      case RequestType::ALLGATHER: return "allgather";
      case RequestType::BROADCAST: return "broadcast";
      case RequestType::JOIN: return "join";
      case RequestType::ADASUM: return "adasum";
      case RequestType::ALLTOALL: return "alltoall";
      case RequestType::BARRIER: return "barrier";
      case RequestType::REDUCESCATTER: return "reducescatter";
    }
    return "?";
  }

  // ------------------------------------------------------- background loop

  void BackgroundLoop() {
    while (true) {
      auto cycle_start = std::chrono::steady_clock::now();
      bool keep_going = RunLoopOnce();
      if (!keep_going) break;
      auto elapsed = std::chrono::duration<double, std::milli>(
                         std::chrono::steady_clock::now() - cycle_start)
                         .count();
      double cycle_ms = cycle_ms_.load();
      if (elapsed < cycle_ms) {
        std::this_thread::sleep_for(std::chrono::duration<double, std::milli>(
            cycle_ms - elapsed));
      }
    }
    FailAll(kShutdownError);
    mesh_.Close();
  }

  // One negotiation + execution cycle (reference RunLoopOnce,
  // operations.cc:550).
  bool RunLoopOnce() {
    cycles_++;
    timeline_.MarkCycle();
    RequestList my_list;
    std::vector<std::shared_ptr<Entry>> cached_entries;
    {
      std::lock_guard<std::mutex> l(mu_);
      my_list.shutdown = shutdown_requested_;
      my_list.joined = joined_;
      for (auto& e : pending_) {
        int32_t slot = cache_enabled_ ? cache_->Lookup(e->req) : -1;
        if (slot >= 0) {
          my_list.cache_hits.push_back(static_cast<uint32_t>(slot));
        } else {
          my_list.requests.push_back(e->req);
        }
      }
      pending_.clear();
    }

    // --- negotiation transport (reference mpi_controller.cc:107-199:
    // gather to rank 0, broadcast ResponseList back) ---
    ResponseList rlist;
    if (rank_ == 0) {
      std::vector<RequestList> lists(static_cast<size_t>(size_));
      lists[0] = std::move(my_list);
      // Poll-multiplexed gather: one framed RequestList from every worker,
      // consumed in arrival order — the coordinator's cycle cost does not
      // serialize behind a slow worker (reference gathers with a single
      // MPI_Gatherv, mpi_controller.cc:107-150).
      std::vector<std::vector<uint8_t>> bufs(static_cast<size_t>(size_));
      std::vector<int> workers;
      workers.reserve(static_cast<size_t>(size_) - 1);
      for (int r = 1; r < size_; r++) workers.push_back(r);
      if (!mesh_.RecvMsgMulti(workers, &bufs).ok()) {
        FailAll("negotiation transport failed (worker unreachable)");
        return false;
      }
      for (int r = 1; r < size_; r++) {
        if (!ParseRequestList(bufs[static_cast<size_t>(r)].data(),
                              bufs[static_cast<size_t>(r)].size(),
                              &lists[r])) {
          FailAll("negotiation transport failed (worker unreachable)");
          return false;
        }
      }
      bool should_shutdown = false;
      rlist = controller_->ComputeResponseList(lists, &should_shutdown);
      {
        // Attach the autotuner's latest move so every rank (this one
        // included) applies it at the same cycle boundary (reference
        // SynchronizeParameters, controller.cc:33-47).
        std::lock_guard<std::mutex> l(mu_);
        if (params_pending_) {
          rlist.has_params = true;
          rlist.tuned_fusion_bytes = params_fusion_bytes_;
          rlist.tuned_cycle_ms = params_cycle_ms_;
          rlist.tuned_cache_enabled = params_cache_enabled_;
          params_pending_ = false;
        }
      }
      std::vector<uint8_t> out;
      SerializeResponseList(rlist, &out);
      for (int r = 1; r < size_; r++) {
        if (!mesh_.SendMsg(r, out.data(), out.size()).ok()) {
          FailAll("negotiation transport failed (worker unreachable)");
          return false;
        }
      }
    } else {
      std::vector<uint8_t> out;
      SerializeRequestList(my_list, &out);
      if (!mesh_.SendMsg(0, out.data(), out.size()).ok()) {
        FailAll("negotiation transport failed (coordinator unreachable)");
        return false;
      }
      std::vector<uint8_t> buf;
      if (!mesh_.RecvMsg(0, &buf).ok() ||
          !ParseResponseList(buf.data(), buf.size(), &rlist)) {
        FailAll("negotiation transport failed (coordinator unreachable)");
        return false;
      }
    }

    // --- apply synced params BEFORE cache updates and fusion: all ranks
    // must fuse this cycle's responses with the same threshold ---
    if (rlist.has_params) {
      fusion_bytes_.store(rlist.tuned_fusion_bytes);
      cycle_ms_.store(rlist.tuned_cycle_ms);
      cache_enabled_.store(rlist.tuned_cache_enabled);
      HVD_LOG(LogLevel::DEBUG, rank_,
              "autotune applied: fusion=%lld cycle=%.2fms cache=%d",
              static_cast<long long>(rlist.tuned_fusion_bytes),
              rlist.tuned_cycle_ms, rlist.tuned_cache_enabled ? 1 : 0);
    }

    // --- reconstruct cached responses, update cache, fuse, execute ---
    std::vector<Response> exec;
    exec.reserve(rlist.cached_slots.size() + rlist.responses.size());
    for (uint32_t slot : rlist.cached_slots) {
      exec.push_back(cache_->Get(slot));
      cache_->Touch(slot);
    }
    for (auto& resp : rlist.responses) {
      if (cache_enabled_ && !rlist.cache_frozen &&
          resp.response_type != ResponseType::ERROR &&
          resp.response_type != ResponseType::JOIN &&
          resp.response_type != ResponseType::BARRIER) {
        std::lock_guard<std::mutex> l(mu_);
        auto it = table_.find(resp.tensor_names[0]);
        if (it != table_.end()) cache_->Put(it->second->req, resp);
      }
      exec.push_back(std::move(resp));
    }
    FuseResponseList(&exec, fusion_bytes_);

    for (const auto& resp : exec) PerformOperation(resp);

    return !rlist.shutdown;
  }

  // ------------------------------------------------------------- execution

  void PerformOperation(const Response& resp) {
    // reference PerformOperation (operations.cc:232-309).
    if (resp.response_type == ResponseType::JOIN) {
      std::vector<int64_t> hs;
      {
        std::lock_guard<std::mutex> l(mu_);
        hs.swap(join_handles_);
        joined_ = false;
      }
      for (int64_t h : hs) Complete(h, nullptr, 0, {});
      return;
    }

    std::vector<std::shared_ptr<Entry>> entries(resp.tensor_names.size());
    {
      std::lock_guard<std::mutex> l(mu_);
      for (size_t i = 0; i < resp.tensor_names.size(); i++) {
        auto it = table_.find(resp.tensor_names[i]);
        if (it != table_.end()) {
          entries[i] = it->second;
          table_.erase(it);
        }
      }
    }

    if (resp.response_type == ResponseType::ERROR) {
      for (auto& e : entries)
        if (e) Fail(e->handle, resp.error_message);
      return;
    }

    responses_++;
    if (resp.tensor_names.size() > 1) fused_responses_++;
    std::string names = resp.tensor_names[0];
    if (resp.tensor_names.size() > 1)
      names += "+" + std::to_string(resp.tensor_names.size() - 1);
    const char* opname =
        resp.response_type == ResponseType::ALLREDUCE       ? "ALLREDUCE"
        : resp.response_type == ResponseType::ALLGATHER     ? "ALLGATHER"
        : resp.response_type == ResponseType::BROADCAST     ? "BROADCAST"
        : resp.response_type == ResponseType::ADASUM        ? "ADASUM"
        : resp.response_type == ResponseType::ALLTOALL      ? "ALLTOALL"
        : resp.response_type == ResponseType::REDUCESCATTER ? "REDUCESCATTER"
                                                            : "BARRIER";
    timeline_.Start(names, opname);
    Status s;
    switch (resp.response_type) {
      case ResponseType::ALLREDUCE:
      case ResponseType::ADASUM:
        s = ExecAllreduce(resp, entries);
        break;
      case ResponseType::ALLGATHER:
        s = ExecAllgather(resp, entries);
        break;
      case ResponseType::BROADCAST:
        s = ExecBroadcast(resp, entries);
        break;
      case ResponseType::ALLTOALL:
        s = ExecAlltoall(resp, entries);
        break;
      case ResponseType::REDUCESCATTER:
        s = ExecReducescatter(resp, entries);
        break;
      case ResponseType::BARRIER:
        if (entries[0]) Complete(entries[0]->handle, nullptr, 0, {});
        break;
      default:
        break;
    }
    timeline_.End(names, opname);
    if (!s.ok()) {
      for (auto& e : entries)
        if (e) Fail(e->handle, s.reason);
    }
  }

  Status ExecAllreduce(const Response& resp,
                       const std::vector<std::shared_ptr<Entry>>& entries) {
    size_t elem = DataTypeSize(resp.dtype);
    // Fusion buffer assembly (reference MemcpyInFusionBuffer,
    // collective_operations.cc:159-210).  A joined/absent rank contributes
    // zeros of the negotiated shape (reference tensor_queue.h:39-41).
    int64_t total = 0;
    std::vector<int64_t> counts(entries.size());
    for (size_t i = 0; i < entries.size(); i++) {
      int64_t n = 1;
      for (auto d : resp.shapes[i]) n *= d;
      counts[i] = n;
      total += n;
    }
    std::string names = resp.tensor_names[0];
    timeline_.ActivityStart(names, "MEMCPY_IN_FUSION_BUFFER");
    std::vector<uint8_t> fused(static_cast<size_t>(total) * elem, 0);
    int64_t off = 0;
    for (size_t i = 0; i < entries.size(); i++) {
      if (entries[i])
        std::memcpy(fused.data() + off * elem, entries[i]->data.data(),
                    static_cast<size_t>(counts[i]) * elem);
      off += counts[i];
    }
    timeline_.ActivityEnd(names, "MEMCPY_IN_FUSION_BUFFER");

    if (resp.prescale != 1.0)
      ScaleInPlace(resp.dtype, fused.data(), static_cast<size_t>(total),
                   resp.prescale);

    Status s;
    if (resp.response_type == ResponseType::ADASUM ||
        resp.reduce_op == ReduceOp::ADASUM) {
      timeline_.ActivityStart(names, "ADASUM_VHDD");
      s = AdasumAllreduce(&mesh_, fused.data(), total, resp.dtype);
      timeline_.ActivityEnd(names, "ADASUM_VHDD");
    } else {
      ReduceOp ring_op = resp.reduce_op == ReduceOp::MIN   ? ReduceOp::MIN
                         : resp.reduce_op == ReduceOp::MAX ? ReduceOp::MAX
                                                           : ReduceOp::SUM;
      timeline_.ActivityStart(names, "RING_ALLREDUCE");
      s = RingAllreduce(&mesh_, fused.data(), total, resp.dtype, ring_op);
      timeline_.ActivityEnd(names, "RING_ALLREDUCE");
      if (s.ok() && resp.reduce_op == ReduceOp::AVERAGE)
        AverageInPlace(resp.dtype, fused.data(), static_cast<size_t>(total),
                       size_);
    }
    if (!s.ok()) return s;
    if (resp.postscale != 1.0)
      ScaleInPlace(resp.dtype, fused.data(), static_cast<size_t>(total),
                   resp.postscale);

    perf_bytes_ += static_cast<long long>(total) * elem;
    long long bytes = static_cast<long long>(total) * elem;
    if (bytes > largest_response_bytes_) largest_response_bytes_ = bytes;
    timeline_.ActivityStart(names, "MEMCPY_OUT_FUSION_BUFFER");
    off = 0;
    for (size_t i = 0; i < entries.size(); i++) {
      if (entries[i]) {
        Complete(entries[i]->handle, fused.data() + off * elem,
                 static_cast<size_t>(counts[i]) * elem, resp.shapes[i]);
      }
      off += counts[i];
    }
    timeline_.ActivityEnd(names, "MEMCPY_OUT_FUSION_BUFFER");
    return Status::OK();
  }

  Status ExecAllgather(const Response& resp,
                       const std::vector<std::shared_ptr<Entry>>& entries) {
    size_t elem = DataTypeSize(resp.dtype);
    const auto& shape = resp.shapes[0];
    int64_t row = 1;
    for (size_t i = 1; i < shape.size(); i++) row *= shape[i];
    std::vector<int64_t> counts(resp.tensor_sizes.size());
    int64_t total_rows = 0;
    for (size_t i = 0; i < counts.size(); i++) {
      counts[i] = resp.tensor_sizes[i] * row;
      total_rows += resp.tensor_sizes[i];
    }
    std::vector<uint8_t> out(static_cast<size_t>(total_rows * row) * elem);
    const void* send =
        entries[0] ? static_cast<const void*>(entries[0]->data.data())
                   : static_cast<const void*>(out.data());  // 0 elems
    Status s = RingAllgatherv(&mesh_, send, out.data(), counts, resp.dtype);
    if (!s.ok()) return s;
    perf_bytes_ += static_cast<long long>(out.size());
    if (entries[0]) {
      std::vector<int64_t> out_shape = shape;
      out_shape[0] = total_rows;
      Complete(entries[0]->handle, out.data(), out.size(), out_shape);
    }
    return Status::OK();
  }

  Status ExecBroadcast(const Response& resp,
                       const std::vector<std::shared_ptr<Entry>>& entries) {
    size_t elem = DataTypeSize(resp.dtype);
    int64_t n = 1;
    for (auto d : resp.shapes[0]) n *= d;
    std::vector<uint8_t> buf(static_cast<size_t>(n) * elem, 0);
    if (entries[0])
      std::memcpy(buf.data(), entries[0]->data.data(), buf.size());
    Status s = TreeBroadcast(&mesh_, buf.data(), n, resp.dtype,
                             resp.root_rank);
    if (!s.ok()) return s;
    perf_bytes_ += static_cast<long long>(buf.size());
    if (entries[0])
      Complete(entries[0]->handle, buf.data(), buf.size(), resp.shapes[0]);
    return Status::OK();
  }

  Status ExecAlltoall(const Response& resp,
                      const std::vector<std::shared_ptr<Entry>>& entries) {
    size_t elem = DataTypeSize(resp.dtype);
    const auto& shape = resp.shapes[0];
    int64_t n = 1;
    for (auto d : shape) n *= d;
    if (!shape.empty() && shape[0] % size_ != 0) {
      return Status::Error(
          StatusCode::INVALID_ARGUMENT,
          "alltoall dim0 (" + std::to_string(shape[0]) +
              ") must divide world size (" + std::to_string(size_) + ")");
    }
    std::vector<uint8_t> in(static_cast<size_t>(n) * elem, 0);
    std::vector<uint8_t> out(static_cast<size_t>(n) * elem, 0);
    if (entries[0]) std::memcpy(in.data(), entries[0]->data.data(), in.size());
    Status s = PairwiseAlltoall(&mesh_, in.data(), out.data(), n / size_,
                                resp.dtype);
    if (!s.ok()) return s;
    if (entries[0])
      Complete(entries[0]->handle, out.data(), out.size(), shape);
    return Status::OK();
  }

  Status ExecReducescatter(const Response& resp,
                           const std::vector<std::shared_ptr<Entry>>& entries) {
    // Sum across ranks, keep this rank's dim-0 rows; uneven splits give
    // the first (dim0 % size) ranks one extra row (the convention later
    // Horovod versions adopted for reducescatter).
    size_t elem = DataTypeSize(resp.dtype);
    const auto& shape = resp.shapes[0];
    int64_t n = 1;
    for (auto d : shape) n *= d;
    int64_t row = shape.empty() ? 1 : n / std::max<int64_t>(shape[0], 1);
    std::vector<uint8_t> buf(static_cast<size_t>(n) * elem, 0);
    if (entries[0])
      std::memcpy(buf.data(), entries[0]->data.data(), buf.size());
    if (resp.prescale != 1.0)
      ScaleInPlace(resp.dtype, buf.data(), static_cast<size_t>(n),
                   resp.prescale);
    Status s = RingAllreduce(&mesh_, buf.data(), n, resp.dtype, ReduceOp::SUM);
    if (!s.ok()) return s;
    if (resp.reduce_op == ReduceOp::AVERAGE)
      AverageInPlace(resp.dtype, buf.data(), static_cast<size_t>(n), size_);
    if (resp.postscale != 1.0)
      ScaleInPlace(resp.dtype, buf.data(), static_cast<size_t>(n),
                   resp.postscale);
    perf_bytes_ += static_cast<long long>(buf.size());
    if (entries[0]) {
      int64_t dim0 = shape.empty() ? 1 : shape[0];
      int64_t base = dim0 / size_, rem = dim0 % size_;
      int64_t start = rank_ * base + std::min<int64_t>(rank_, rem);
      int64_t rows = base + (rank_ < rem ? 1 : 0);
      std::vector<int64_t> out_shape = shape;
      out_shape[0] = rows;
      Complete(entries[0]->handle, buf.data() + start * row * elem,
               static_cast<size_t>(rows * row) * elem, out_shape);
    }
    return Status::OK();
  }

  // ------------------------------------------------------------ completion

  void Complete(int64_t h, const void* data, size_t nbytes,
                const std::vector<int64_t>& shape) {
    {
      std::lock_guard<std::mutex> l(mu_);
      auto it = handles_.find(h);
      if (it != handles_.end()) {
        auto& hs = *it->second;
        hs.output.assign(static_cast<const uint8_t*>(data),
                         static_cast<const uint8_t*>(data) + nbytes);
        hs.out_shape = shape;
        hs.status = kOk;
      }
    }
    cv_.notify_all();
  }

  void Fail(int64_t h, const std::string& err) {
    {
      std::lock_guard<std::mutex> l(mu_);
      auto it = handles_.find(h);
      if (it != handles_.end()) {
        it->second->error = err;
        it->second->status = kError;
      }
    }
    cv_.notify_all();
  }

  void FailAll(const std::string& err) {
    std::vector<int64_t> hs;
    {
      std::lock_guard<std::mutex> l(mu_);
      done_ = true;
      for (auto& [name, e] : table_) hs.push_back(e->handle);
      table_.clear();
      pending_.clear();
      for (int64_t h : join_handles_) hs.push_back(h);
      join_handles_.clear();
    }
    for (int64_t h : hs) Fail(h, err);
    cv_.notify_all();
  }

  int rank_ = 0;
  int size_ = 1;
  // Atomic: written by the RunLoop thread when synced params apply,
  // read lock-free by the Python autotune thread via hvdtpu_get_*.
  std::atomic<int64_t> fusion_bytes_{64 * 1024 * 1024};
  std::atomic<double> cycle_ms_{5.0};
  std::atomic<bool> cache_enabled_{true};

  // Autotune plumbing: the Python ParameterManager (rank 0) reads the
  // bytes counter to score bytes/sec and pushes proposals via
  // hvdtpu_set_params; they ride the next ResponseList to every rank
  // (reference parameter_manager.cc:528 + controller.cc:33-47).
  std::atomic<long long> perf_bytes_{0};
  // Engine counters the binding publishes (hvdtpu_stats): cycles run,
  // data responses executed, those of more than one tensor, and the
  // largest fused allreduce in bytes.
  std::atomic<long long> cycles_{0};
  std::atomic<long long> responses_{0};
  std::atomic<long long> fused_responses_{0};
  std::atomic<long long> largest_response_bytes_{0};
  bool params_pending_ = false;
  int64_t params_fusion_bytes_ = 0;
  double params_cycle_ms_ = 0.0;
  bool params_cache_enabled_ = true;

 public:
  void SetParams(int64_t fusion_bytes, double cycle_ms, bool cache_enabled) {
    std::lock_guard<std::mutex> l(mu_);
    params_pending_ = true;
    params_fusion_bytes_ = fusion_bytes;
    params_cycle_ms_ = cycle_ms;
    params_cache_enabled_ = cache_enabled;
  }
  long long PerfBytes() const { return perf_bytes_.load(); }
  void Stats(long long* out) const {
    out[0] = cycles_.load();
    out[1] = responses_.load();
    out[2] = fused_responses_.load();
    out[3] = largest_response_bytes_.load();
  }
  long long FusionBytes() const { return fusion_bytes_.load(); }
  double CycleMs() const { return cycle_ms_.load(); }

  // Fault injection (tests only): flip THIS rank's cache gate without the
  // params sync, recreating the transient divergence a tuner cache toggle
  // can cause when an enqueue straggles across the flip cycle.  Production
  // toggles must go through SetParams, which synchronizes all ranks.
  void InjectLocalCacheEnabled(bool on) { cache_enabled_.store(on); }

 private:

  TcpMesh mesh_;
  std::unique_ptr<Controller> controller_;
  std::unique_ptr<ResponseCache> cache_;
  Timeline timeline_;
  std::thread bg_;

  std::mutex mu_;
  std::condition_variable cv_;
  std::vector<std::shared_ptr<Entry>> pending_;
  std::unordered_map<std::string, std::shared_ptr<Entry>> table_;
  std::unordered_map<int64_t, std::shared_ptr<HandleState>> handles_;
  std::vector<int64_t> join_handles_;
  int64_t next_handle_ = 1;
  bool joined_ = false;
  bool shutdown_requested_ = false;
  bool done_ = false;
  bool running_ = false;
};

}  // namespace
}  // namespace hvdtpu

// ---------------------------------------------------------------- C API
// (reference operations.cc:661-799 — the surface HorovodBasics wraps with
// ctypes; handles follow torch/handle_manager.cc.)

extern "C" {

int hvdtpu_listen() { return hvdtpu::Engine::Get().Listen(); }

int hvdtpu_connect(int rank, int size, const char* addrs_csv,
                   long long fusion_bytes, double cycle_ms, int cache_capacity,
                   double stall_warn, double stall_shutdown,
                   const char* timeline_path, int timeline_mark_cycles) {
  std::vector<std::string> addrs;
  std::string cur;
  for (const char* p = addrs_csv; *p; p++) {
    if (*p == ',') {
      addrs.push_back(cur);
      cur.clear();
    } else {
      cur.push_back(*p);
    }
  }
  if (!cur.empty()) addrs.push_back(cur);
  if (static_cast<int>(addrs.size()) != size) return -2;
  return hvdtpu::Engine::Get().Connect(
      rank, size, addrs, fusion_bytes, cycle_ms, cache_capacity, stall_warn,
      stall_shutdown, timeline_path ? timeline_path : "",
      timeline_mark_cycles != 0);
}

long long hvdtpu_enqueue(int op, const char* name, const void* data,
                         const long long* shape, int ndim, int dtype,
                         int reduce_op, int root_rank, double prescale,
                         double postscale) {
  std::vector<int64_t> sh(shape, shape + ndim);
  return hvdtpu::Engine::Get().Enqueue(
      static_cast<hvdtpu::RequestType>(op), name, data, sh,
      static_cast<hvdtpu::DataType>(dtype),
      static_cast<hvdtpu::ReduceOp>(reduce_op), root_rank, prescale,
      postscale);
}

long long hvdtpu_join() { return hvdtpu::Engine::Get().Join(); }

int hvdtpu_poll(long long handle) {
  return hvdtpu::Engine::Get().Poll(handle);
}

int hvdtpu_wait(long long handle) {
  return hvdtpu::Engine::Get().Wait(handle);
}

const char* hvdtpu_error(long long handle) {
  auto hs = hvdtpu::Engine::Get().GetHandle(handle);
  // Pointer stays valid until hvdtpu_release (shared_ptr in handle table).
  return hs ? hs->error.c_str() : "unknown handle";
}

long long hvdtpu_result_nbytes(long long handle) {
  auto hs = hvdtpu::Engine::Get().GetHandle(handle);
  return hs ? static_cast<long long>(hs->output.size()) : -1;
}

int hvdtpu_result_ndim(long long handle) {
  auto hs = hvdtpu::Engine::Get().GetHandle(handle);
  return hs ? static_cast<int>(hs->out_shape.size()) : -1;
}

void hvdtpu_result_shape(long long handle, long long* out) {
  auto hs = hvdtpu::Engine::Get().GetHandle(handle);
  if (!hs) return;
  for (size_t i = 0; i < hs->out_shape.size(); i++) out[i] = hs->out_shape[i];
}

int hvdtpu_result_copy(long long handle, void* out) {
  auto hs = hvdtpu::Engine::Get().GetHandle(handle);
  if (!hs || hs->status != 1) return -1;
  std::memcpy(out, hs->output.data(), hs->output.size());
  return 0;
}

void hvdtpu_release(long long handle) {
  hvdtpu::Engine::Get().Release(handle);
}

void hvdtpu_shutdown() { hvdtpu::Engine::Get().Shutdown(); }

int hvdtpu_is_shutdown() {
  return hvdtpu::Engine::Get().IsDone() ? 1 : 0;
}

// Autotune surface (reference parameter_manager.cc scoring + param sync):
// rank 0's Python ParameterManager polls the bytes counter and pushes
// proposals; the engine ships them to all ranks on the next cycle.
void hvdtpu_set_params(long long fusion_bytes, double cycle_ms,
                       int cache_enabled) {
  hvdtpu::Engine::Get().SetParams(fusion_bytes, cycle_ms, cache_enabled != 0);
}

long long hvdtpu_perf_bytes() { return hvdtpu::Engine::Get().PerfBytes(); }

// out[4]: cycles, responses, fused responses, largest fused allreduce bytes.
void hvdtpu_stats(long long* out) { hvdtpu::Engine::Get().Stats(out); }

void hvdtpu_inject_local_cache_enabled(int on) {
  hvdtpu::Engine::Get().InjectLocalCacheEnabled(on != 0);
}

long long hvdtpu_get_fusion_bytes() {
  return hvdtpu::Engine::Get().FusionBytes();
}

double hvdtpu_get_cycle_ms() { return hvdtpu::Engine::Get().CycleMs(); }

}  // extern "C"
