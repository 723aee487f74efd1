// Chrome-tracing timeline with a dedicated writer thread.
//
// Reference: horovod/common/timeline.{h,cc} — rank 0 writes
// chrome://tracing JSON; events are produced on the background thread and
// drained by a writer thread through a queue (the reference uses a boost
// lockfree SPSC queue, timeline.h:68-70; a mutex+cv deque is equivalent
// here — the producer is a single thread either way).  Event vocabulary
// follows common.h:31-59: NEGOTIATE_<OP>, <OP>, CYCLE_START, and per-op
// activities.  Enabled via HVDTPU_TIMELINE=<path> on rank 0.
#pragma once

#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <string>
#include <thread>

namespace hvdtpu {

class Timeline {
 public:
  // path empty => disabled (all emit calls are no-ops).
  void Initialize(const std::string& path, int rank, bool mark_cycles);
  void Shutdown();
  ~Timeline() { Shutdown(); }

  bool enabled() const { return enabled_; }

  // Negotiation lifecycle (reference timeline.h:77 state machine).
  void NegotiateStart(const std::string& name, const std::string& op);
  void NegotiateRankReady(const std::string& name, int rank);
  void NegotiateEnd(const std::string& name, const std::string& op);
  // Top-level op execution span.
  void Start(const std::string& name, const std::string& op);
  void End(const std::string& name, const std::string& op);
  // Activity within an op (e.g. MEMCPY_IN_FUSION_BUFFER, RING_ALLREDUCE).
  void ActivityStart(const std::string& name, const std::string& activity);
  void ActivityEnd(const std::string& name, const std::string& activity);
  void MarkCycle();

 private:
  void Emit(char ph, const std::string& name, const std::string& cat,
            const std::string& args_json);
  void WriterLoop();

  bool enabled_ = false;
  bool mark_cycles_ = false;
  int rank_ = 0;
  int64_t start_us_ = 0;
  std::FILE* file_ = nullptr;
  bool first_event_ = true;

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::string> queue_;
  bool stop_ = false;
  std::thread writer_;
};

}  // namespace hvdtpu
