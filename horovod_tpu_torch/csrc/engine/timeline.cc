#include "timeline.h"

#include <chrono>
#include <cstdio>

namespace hvdtpu {

namespace {

int64_t NowUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Minimal JSON string escape (names come from user tensor names).
std::string Escape(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (char c : s) {
    if (c == '"' || c == '\\') {
      out.push_back('\\');
      out.push_back(c);
    } else if (static_cast<unsigned char>(c) < 0x20) {
      char buf[8];
      std::snprintf(buf, sizeof(buf), "\\u%04x", c);
      out += buf;
    } else {
      out.push_back(c);
    }
  }
  return out;
}

}  // namespace

void Timeline::Initialize(const std::string& path, int rank,
                          bool mark_cycles) {
  if (path.empty()) return;
  file_ = std::fopen(path.c_str(), "w");
  if (!file_) return;
  std::fputs("[\n", file_);
  stop_ = false;
  first_event_ = true;
  rank_ = rank;
  mark_cycles_ = mark_cycles;
  start_us_ = NowUs();
  enabled_ = true;
  writer_ = std::thread(&Timeline::WriterLoop, this);
}

void Timeline::Shutdown() {
  if (!enabled_) return;
  {
    std::lock_guard<std::mutex> l(mu_);
    stop_ = true;
  }
  cv_.notify_all();
  if (writer_.joinable()) writer_.join();
  std::fputs("\n]\n", file_);
  std::fclose(file_);
  file_ = nullptr;
  enabled_ = false;
}

void Timeline::Emit(char ph, const std::string& name, const std::string& cat,
                    const std::string& args_json) {
  if (!enabled_) return;
  char buf[512];
  int n = std::snprintf(
      buf, sizeof(buf),
      "{\"ph\":\"%c\",\"name\":\"%s\",\"cat\":\"%s\",\"ts\":%lld,"
      "\"pid\":%d,\"tid\":0%s%s}",
      ph, Escape(name).c_str(), Escape(cat).c_str(),
      static_cast<long long>(NowUs() - start_us_), rank_,
      args_json.empty() ? "" : ",", args_json.c_str());
  if (n <= 0) return;
  {
    std::lock_guard<std::mutex> l(mu_);
    queue_.emplace_back(buf, static_cast<size_t>(n));
  }
  cv_.notify_one();
}

void Timeline::WriterLoop() {
  std::unique_lock<std::mutex> l(mu_);
  while (!stop_ || !queue_.empty()) {
    cv_.wait(l, [&] { return stop_ || !queue_.empty(); });
    while (!queue_.empty()) {
      std::string ev = std::move(queue_.front());
      queue_.pop_front();
      l.unlock();
      if (!first_event_) std::fputs(",\n", file_);
      first_event_ = false;
      std::fputs(ev.c_str(), file_);
      l.lock();
    }
    std::fflush(file_);
  }
}

void Timeline::NegotiateStart(const std::string& name, const std::string& op) {
  Emit('B', name, "NEGOTIATE_" + op, "");
}

void Timeline::NegotiateRankReady(const std::string& name, int rank) {
  Emit('i', name, "RANK_READY",
       "\"args\":{\"rank\":" + std::to_string(rank) + "}");
}

void Timeline::NegotiateEnd(const std::string& name, const std::string& op) {
  Emit('E', name, "NEGOTIATE_" + op, "");
}

void Timeline::Start(const std::string& name, const std::string& op) {
  Emit('B', name, op, "");
}

void Timeline::End(const std::string& name, const std::string& op) {
  Emit('E', name, op, "");
}

void Timeline::ActivityStart(const std::string& name,
                             const std::string& activity) {
  Emit('B', name, activity, "");
}

void Timeline::ActivityEnd(const std::string& name,
                           const std::string& activity) {
  Emit('E', name, activity, "");
}

void Timeline::MarkCycle() {
  if (mark_cycles_) Emit('i', "CYCLE_START", "CYCLE", "");
}

}  // namespace hvdtpu
