// Full-mesh TCP transport for the native eager engine.
//
// Reference: horovod/common/gloo/gloo_context.cc builds a full TCP mesh via
// HTTP-KV rendezvous (gloo_context.cc:113-157).  Here the mesh is built the
// same way, but address exchange happens in Python (runtime/native.py uses
// the already-running coordination service), so this class only needs to
// listen, connect, and move framed byte messages.
//
// Concurrency model follows the reference's single-owner rule
// (operations.cc:311-330): after Connect(), every socket is owned by the
// background thread exclusively — no locking on the data path.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "common.h"

namespace hvdtpu {

class TcpMesh {
 public:
  TcpMesh() = default;
  ~TcpMesh();
  TcpMesh(const TcpMesh&) = delete;
  TcpMesh& operator=(const TcpMesh&) = delete;

  // Bind + listen on an ephemeral port; returns it.  Call before address
  // exchange so the advertised port is real.
  Status Listen(int* port_out);

  // Build the full mesh: rank i initiates connections to every j < i and
  // accepts from every j > i; each inbound connection self-identifies with
  // a 4-byte rank hello.  addrs[j] = "host:port".
  Status Connect(int rank, int size, const std::vector<std::string>& addrs);

  // Framed message passing: [u64 length][payload].
  Status SendMsg(int to, const uint8_t* data, size_t len);
  Status RecvMsg(int from, std::vector<uint8_t>* out);

  // Poll-multiplexed receive of ONE framed message from EACH listed peer,
  // consuming bytes from whichever socket is ready (reference contrast:
  // MPIController gathers all workers' requests in one MPI_Gatherv,
  // mpi_controller.cc:107-150 — a serial per-worker blocking recv loop
  // would make the coordinator's cycle time linear in world size when any
  // worker is slow).  out->at(peer) receives that peer's payload; entries
  // for ranks not in `peers` are left untouched.
  Status RecvMsgMulti(const std::vector<int>& peers,
                      std::vector<std::vector<uint8_t>>* out);

  // Raw byte transfer (data plane; no frame header).
  Status SendBytes(int to, const void* data, size_t len);
  Status RecvBytes(int from, void* data, size_t len);

  // Bidirectional exchange with (possibly distinct) peers, interleaved via
  // poll() so large transfers can't deadlock on full kernel buffers.
  Status SendRecv(int to, const void* sendbuf, size_t sendlen, int from,
                  void* recvbuf, size_t recvlen);

  void Close();

  int rank() const { return rank_; }
  int size() const { return size_; }

 private:
  Status SendAll(int fd, const void* data, size_t len);
  Status RecvAll(int fd, void* data, size_t len);

  int rank_ = 0;
  int size_ = 1;
  int listen_fd_ = -1;
  std::vector<int> fds_;  // fds_[peer] = connected socket, -1 for self
};

}  // namespace hvdtpu
