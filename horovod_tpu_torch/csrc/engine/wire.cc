#include "wire.h"

#include <cstring>

namespace hvdtpu {
namespace {

// Little-endian primitive writers/readers.  x86-64 and every TPU host VM
// are little-endian; memcpy keeps it alignment-safe.
template <typename T>
void Put(std::vector<uint8_t>* out, T v) {
  size_t n = out->size();
  out->resize(n + sizeof(T));
  std::memcpy(out->data() + n, &v, sizeof(T));
}

void PutStr(std::vector<uint8_t>* out, const std::string& s) {
  Put<uint32_t>(out, static_cast<uint32_t>(s.size()));
  out->insert(out->end(), s.begin(), s.end());
}

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  template <typename T>
  T Get() {
    T v{};
    if (p + sizeof(T) > end) {
      ok = false;
      return v;
    }
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }

  std::string GetStr() {
    uint32_t n = Get<uint32_t>();
    if (!ok || p + n > end) {
      ok = false;
      return "";
    }
    std::string s(reinterpret_cast<const char*>(p), n);
    p += n;
    return s;
  }
};

void PutRequest(std::vector<uint8_t>* out, const Request& r) {
  Put<int32_t>(out, r.request_rank);
  Put<uint8_t>(out, static_cast<uint8_t>(r.request_type));
  Put<uint8_t>(out, static_cast<uint8_t>(r.dtype));
  Put<uint8_t>(out, static_cast<uint8_t>(r.reduce_op));
  Put<int32_t>(out, r.root_rank);
  Put<double>(out, r.prescale);
  Put<double>(out, r.postscale);
  PutStr(out, r.tensor_name);
  Put<uint32_t>(out, static_cast<uint32_t>(r.shape.size()));
  for (auto d : r.shape) Put<int64_t>(out, d);
}

bool GetRequest(Reader* rd, Request* r) {
  r->request_rank = rd->Get<int32_t>();
  r->request_type = static_cast<RequestType>(rd->Get<uint8_t>());
  r->dtype = static_cast<DataType>(rd->Get<uint8_t>());
  r->reduce_op = static_cast<ReduceOp>(rd->Get<uint8_t>());
  r->root_rank = rd->Get<int32_t>();
  r->prescale = rd->Get<double>();
  r->postscale = rd->Get<double>();
  r->tensor_name = rd->GetStr();
  uint32_t nd = rd->Get<uint32_t>();
  if (!rd->ok || nd > 64) return false;
  r->shape.resize(nd);
  for (uint32_t i = 0; i < nd; i++) r->shape[i] = rd->Get<int64_t>();
  return rd->ok;
}

void PutResponse(std::vector<uint8_t>* out, const Response& r) {
  Put<uint8_t>(out, static_cast<uint8_t>(r.response_type));
  Put<uint8_t>(out, static_cast<uint8_t>(r.dtype));
  Put<uint8_t>(out, static_cast<uint8_t>(r.reduce_op));
  Put<int32_t>(out, r.root_rank);
  Put<double>(out, r.prescale);
  Put<double>(out, r.postscale);
  PutStr(out, r.error_message);
  Put<uint32_t>(out, static_cast<uint32_t>(r.tensor_names.size()));
  for (const auto& n : r.tensor_names) PutStr(out, n);
  Put<uint32_t>(out, static_cast<uint32_t>(r.shapes.size()));
  for (const auto& s : r.shapes) {
    Put<uint32_t>(out, static_cast<uint32_t>(s.size()));
    for (auto d : s) Put<int64_t>(out, d);
  }
  Put<uint32_t>(out, static_cast<uint32_t>(r.tensor_sizes.size()));
  for (auto s : r.tensor_sizes) Put<int64_t>(out, s);
}

bool GetResponse(Reader* rd, Response* r) {
  r->response_type = static_cast<ResponseType>(rd->Get<uint8_t>());
  r->dtype = static_cast<DataType>(rd->Get<uint8_t>());
  r->reduce_op = static_cast<ReduceOp>(rd->Get<uint8_t>());
  r->root_rank = rd->Get<int32_t>();
  r->prescale = rd->Get<double>();
  r->postscale = rd->Get<double>();
  r->error_message = rd->GetStr();
  uint32_t nn = rd->Get<uint32_t>();
  if (!rd->ok || nn > (1u << 20)) return false;
  r->tensor_names.resize(nn);
  for (auto& n : r->tensor_names) n = rd->GetStr();
  uint32_t ns = rd->Get<uint32_t>();
  if (!rd->ok || ns > (1u << 20)) return false;
  r->shapes.resize(ns);
  for (auto& s : r->shapes) {
    uint32_t nd = rd->Get<uint32_t>();
    if (!rd->ok || nd > 64) return false;
    s.resize(nd);
    for (auto& d : s) d = rd->Get<int64_t>();
  }
  uint32_t nz = rd->Get<uint32_t>();
  if (!rd->ok || nz > (1u << 20)) return false;
  r->tensor_sizes.resize(nz);
  for (auto& z : r->tensor_sizes) z = rd->Get<int64_t>();
  return rd->ok;
}

}  // namespace

void SerializeRequestList(const RequestList& rl, std::vector<uint8_t>* out) {
  Put<uint8_t>(out, rl.shutdown ? 1 : 0);
  Put<uint8_t>(out, rl.joined ? 1 : 0);
  Put<uint32_t>(out, static_cast<uint32_t>(rl.cache_hits.size()));
  for (auto h : rl.cache_hits) Put<uint32_t>(out, h);
  Put<uint32_t>(out, static_cast<uint32_t>(rl.requests.size()));
  for (const auto& r : rl.requests) PutRequest(out, r);
}

bool ParseRequestList(const uint8_t* data, size_t len, RequestList* out) {
  Reader rd{data, data + len};
  out->shutdown = rd.Get<uint8_t>() != 0;
  out->joined = rd.Get<uint8_t>() != 0;
  uint32_t nh = rd.Get<uint32_t>();
  if (!rd.ok || nh > (1u << 20)) return false;
  out->cache_hits.resize(nh);
  for (auto& h : out->cache_hits) h = rd.Get<uint32_t>();
  uint32_t nr = rd.Get<uint32_t>();
  if (!rd.ok || nr > (1u << 20)) return false;
  out->requests.resize(nr);
  for (auto& r : out->requests)
    if (!GetRequest(&rd, &r)) return false;
  return rd.ok;
}

void SerializeResponseList(const ResponseList& rl, std::vector<uint8_t>* out) {
  Put<uint8_t>(out, rl.shutdown ? 1 : 0);
  Put<uint8_t>(out, rl.cache_frozen ? 1 : 0);
  Put<uint8_t>(out, rl.has_params ? 1 : 0);
  if (rl.has_params) {
    Put<int64_t>(out, rl.tuned_fusion_bytes);
    Put<double>(out, rl.tuned_cycle_ms);
    Put<uint8_t>(out, rl.tuned_cache_enabled ? 1 : 0);
  }
  Put<uint32_t>(out, static_cast<uint32_t>(rl.cached_slots.size()));
  for (auto s : rl.cached_slots) Put<uint32_t>(out, s);
  Put<uint32_t>(out, static_cast<uint32_t>(rl.responses.size()));
  for (const auto& r : rl.responses) PutResponse(out, r);
}

bool ParseResponseList(const uint8_t* data, size_t len, ResponseList* out) {
  Reader rd{data, data + len};
  out->shutdown = rd.Get<uint8_t>() != 0;
  out->cache_frozen = rd.Get<uint8_t>() != 0;
  out->has_params = rd.Get<uint8_t>() != 0;
  if (out->has_params) {
    out->tuned_fusion_bytes = rd.Get<int64_t>();
    out->tuned_cycle_ms = rd.Get<double>();
    out->tuned_cache_enabled = rd.Get<uint8_t>() != 0;
  }
  uint32_t ns = rd.Get<uint32_t>();
  if (!rd.ok || ns > (1u << 20)) return false;
  out->cached_slots.resize(ns);
  for (auto& s : out->cached_slots) s = rd.Get<uint32_t>();
  uint32_t nr = rd.Get<uint32_t>();
  if (!rd.ok || nr > (1u << 20)) return false;
  out->responses.resize(nr);
  for (auto& r : out->responses)
    if (!GetResponse(&rd, &r)) return false;
  return rd.ok;
}

}  // namespace hvdtpu
