#include "tcp.h"

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstring>

namespace hvdtpu {

namespace {

constexpr int kConnectTimeoutSec = 120;

Status Errno(const char* what) {
  return Status::Error(StatusCode::UNKNOWN_ERROR,
                       std::string(what) + ": " + std::strerror(errno));
}

void SetSockOpts(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

bool SplitHostPort(const std::string& addr, std::string* host, int* port) {
  auto pos = addr.rfind(':');
  if (pos == std::string::npos) return false;
  *host = addr.substr(0, pos);
  *port = std::atoi(addr.c_str() + pos + 1);
  return *port > 0;
}

}  // namespace

TcpMesh::~TcpMesh() { Close(); }

Status TcpMesh::Listen(int* port_out) {
  listen_fd_ = socket(AF_INET, SOCK_STREAM, 0);
  if (listen_fd_ < 0) return Errno("socket");
  int one = 1;
  setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_addr.s_addr = htonl(INADDR_ANY);
  sa.sin_port = 0;
  if (bind(listen_fd_, reinterpret_cast<sockaddr*>(&sa), sizeof(sa)) < 0)
    return Errno("bind");
  if (listen(listen_fd_, 128) < 0) return Errno("listen");
  socklen_t slen = sizeof(sa);
  if (getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&sa), &slen) < 0)
    return Errno("getsockname");
  *port_out = ntohs(sa.sin_port);
  return Status::OK();
}

Status TcpMesh::Connect(int rank, int size,
                        const std::vector<std::string>& addrs) {
  rank_ = rank;
  size_ = size;
  fds_.assign(size, -1);
  if (size == 1) return Status::OK();

  // Outbound: connect to every lower rank (retry while the peer's accept
  // loop comes up — ranks start at slightly different times).
  for (int peer = 0; peer < rank; peer++) {
    std::string host;
    int port;
    if (!SplitHostPort(addrs[peer], &host, &port))
      return Status::Error(StatusCode::INVALID_ARGUMENT,
                           "bad address " + addrs[peer]);
    addrinfo hints{};
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    if (getaddrinfo(host.c_str(), nullptr, &hints, &res) != 0 || !res)
      return Status::Error(StatusCode::UNKNOWN_ERROR, "resolve " + host);
    sockaddr_in sa = *reinterpret_cast<sockaddr_in*>(res->ai_addr);
    sa.sin_port = htons(static_cast<uint16_t>(port));
    freeaddrinfo(res);

    int fd = -1;
    for (int attempt = 0; attempt < kConnectTimeoutSec * 10; attempt++) {
      fd = socket(AF_INET, SOCK_STREAM, 0);
      if (fd < 0) return Errno("socket");
      if (connect(fd, reinterpret_cast<sockaddr*>(&sa), sizeof(sa)) == 0)
        break;
      close(fd);
      fd = -1;
      usleep(100 * 1000);
    }
    if (fd < 0)
      return Status::Error(StatusCode::UNKNOWN_ERROR,
                           "connect to rank " + std::to_string(peer) + " at " +
                               addrs[peer] + " timed out");
    SetSockOpts(fd);
    int32_t hello = rank_;
    Status s = SendAll(fd, &hello, sizeof(hello));
    if (!s.ok()) return s;
    fds_[peer] = fd;
  }

  // Inbound: accept from every higher rank; hello identifies the peer.
  for (int n = rank + 1; n < size; n++) {
    pollfd p{listen_fd_, POLLIN, 0};
    int r = poll(&p, 1, kConnectTimeoutSec * 1000);
    if (r <= 0)
      return Status::Error(StatusCode::UNKNOWN_ERROR,
                           "timed out accepting mesh connections");
    int fd = accept(listen_fd_, nullptr, nullptr);
    if (fd < 0) return Errno("accept");
    SetSockOpts(fd);
    int32_t hello = -1;
    Status s = RecvAll(fd, &hello, sizeof(hello));
    if (!s.ok()) return s;
    if (hello <= rank_ || hello >= size_ || fds_[hello] != -1) {
      close(fd);
      return Status::Error(StatusCode::UNKNOWN_ERROR,
                           "unexpected mesh hello rank " + std::to_string(hello));
    }
    fds_[hello] = fd;
  }
  return Status::OK();
}

Status TcpMesh::SendAll(int fd, const void* data, size_t len) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  while (len > 0) {
    ssize_t n = send(fd, p, len, MSG_NOSIGNAL);
    if (n < 0) {
      if (errno == EINTR) continue;
      return Errno("send");
    }
    p += n;
    len -= static_cast<size_t>(n);
  }
  return Status::OK();
}

Status TcpMesh::RecvAll(int fd, void* data, size_t len) {
  uint8_t* p = static_cast<uint8_t*>(data);
  while (len > 0) {
    ssize_t n = recv(fd, p, len, 0);
    if (n == 0)
      return Status::Error(StatusCode::ABORTED, "peer closed connection");
    if (n < 0) {
      if (errno == EINTR) continue;
      return Errno("recv");
    }
    p += n;
    len -= static_cast<size_t>(n);
  }
  return Status::OK();
}

Status TcpMesh::SendMsg(int to, const uint8_t* data, size_t len) {
  uint64_t hdr = len;
  Status s = SendAll(fds_[to], &hdr, sizeof(hdr));
  if (!s.ok()) return s;
  return SendAll(fds_[to], data, len);
}

Status TcpMesh::RecvMsg(int from, std::vector<uint8_t>* out) {
  uint64_t hdr = 0;
  Status s = RecvAll(fds_[from], &hdr, sizeof(hdr));
  if (!s.ok()) return s;
  if (hdr > (1ull << 34))
    return Status::Error(StatusCode::UNKNOWN_ERROR, "oversized message");
  out->resize(hdr);
  return RecvAll(fds_[from], out->data(), hdr);
}

Status TcpMesh::RecvMsgMulti(const std::vector<int>& peers,
                             std::vector<std::vector<uint8_t>>* out) {
  // Per-peer incremental framing state; bytes are consumed from whichever
  // socket poll() reports readable, so one slow worker never serializes
  // the others behind it.
  struct PeerState {
    int peer = -1;
    uint64_t hdr = 0;
    size_t hdr_got = 0;   // bytes of the 8-byte length header received
    size_t body_got = 0;  // bytes of the payload received
    bool done = false;
  };
  std::vector<PeerState> states(peers.size());
  for (size_t i = 0; i < peers.size(); i++) states[i].peer = peers[i];
  size_t remaining = peers.size();

  std::vector<pollfd> pfds(peers.size());
  while (remaining > 0) {
    size_t n = 0;
    for (auto& st : states) {
      if (st.done) continue;
      pfds[n].fd = fds_[st.peer];
      pfds[n].events = POLLIN;
      pfds[n].revents = 0;
      n++;
    }
    int r = poll(pfds.data(), static_cast<nfds_t>(n),
                 kConnectTimeoutSec * 1000);
    if (r == 0)
      return Status::Error(StatusCode::UNKNOWN_ERROR,
                           "negotiation recv timed out");
    if (r < 0) {
      if (errno == EINTR) continue;
      return Errno("poll");
    }
    size_t pi = 0;
    for (auto& st : states) {
      if (st.done) continue;
      const pollfd& p = pfds[pi++];
      if (!(p.revents & (POLLIN | POLLERR | POLLHUP))) continue;
      // One read per readiness event; partial reads park the state until
      // the socket is ready again.
      if (st.hdr_got < sizeof(st.hdr)) {
        ssize_t k = read(p.fd,
                         reinterpret_cast<uint8_t*>(&st.hdr) + st.hdr_got,
                         sizeof(st.hdr) - st.hdr_got);
        if (k == 0)
          return Status::Error(StatusCode::ABORTED, "peer closed connection");
        if (k < 0) return Errno("read (negotiation header)");
        st.hdr_got += static_cast<size_t>(k);
        if (st.hdr_got == sizeof(st.hdr)) {
          if (st.hdr > (1ull << 34))
            return Status::Error(StatusCode::UNKNOWN_ERROR,
                                 "oversized message");
          (*out)[static_cast<size_t>(st.peer)].resize(st.hdr);
          if (st.hdr == 0) {
            st.done = true;
            remaining--;
          }
        }
        continue;
      }
      auto& buf = (*out)[static_cast<size_t>(st.peer)];
      ssize_t k = read(p.fd, buf.data() + st.body_got,
                       buf.size() - st.body_got);
      if (k == 0)
        return Status::Error(StatusCode::ABORTED, "peer closed connection");
      if (k < 0) return Errno("read (negotiation payload)");
      st.body_got += static_cast<size_t>(k);
      if (st.body_got == buf.size()) {
        st.done = true;
        remaining--;
      }
    }
  }
  return Status::OK();
}

Status TcpMesh::SendBytes(int to, const void* data, size_t len) {
  return SendAll(fds_[to], data, len);
}

Status TcpMesh::RecvBytes(int from, void* data, size_t len) {
  return RecvAll(fds_[from], data, len);
}

Status TcpMesh::SendRecv(int to, const void* sendbuf, size_t sendlen,
                         int from, void* recvbuf, size_t recvlen) {
  // Interleave so both directions drain regardless of kernel buffer size;
  // blocking send-then-recv on both sides of a pair can deadlock once
  // sendlen exceeds the socket buffer.  The send must not block either
  // (MSG_DONTWAIT): POLLOUT only says some room is free, and a blocking
  // send of the rest waits for the peer, which is blocked in its own send.
  const uint8_t* sp = static_cast<const uint8_t*>(sendbuf);
  uint8_t* rp = static_cast<uint8_t*>(recvbuf);
  size_t sleft = sendlen, rleft = recvlen;
  int sfd = fds_[to], rfd = fds_[from];
  while (sleft > 0 || rleft > 0) {
    pollfd p[2];
    int n = 0;
    int si = -1, ri = -1;
    if (sleft > 0) {
      si = n;
      p[n++] = {sfd, POLLOUT, 0};
    }
    if (rleft > 0) {
      ri = n;
      p[n++] = {rfd, POLLIN, 0};
    }
    int r = poll(p, static_cast<nfds_t>(n), 300 * 1000);
    if (r < 0) {
      if (errno == EINTR) continue;
      return Errno("poll");
    }
    if (r == 0)
      return Status::Error(StatusCode::UNKNOWN_ERROR, "sendrecv timed out");
    if (si >= 0 && (p[si].revents & (POLLOUT | POLLERR | POLLHUP))) {
      ssize_t k = send(sfd, sp, sleft, MSG_NOSIGNAL | MSG_DONTWAIT);
      if (k < 0 && errno != EINTR && errno != EAGAIN) return Errno("send");
      if (k > 0) {
        sp += k;
        sleft -= static_cast<size_t>(k);
      }
    }
    if (ri >= 0 && (p[ri].revents & (POLLIN | POLLERR | POLLHUP))) {
      ssize_t k = recv(rfd, rp, rleft, 0);
      if (k == 0)
        return Status::Error(StatusCode::ABORTED, "peer closed connection");
      if (k < 0 && errno != EINTR && errno != EAGAIN) return Errno("recv");
      if (k > 0) {
        rp += k;
        rleft -= static_cast<size_t>(k);
      }
    }
  }
  return Status::OK();
}

void TcpMesh::Close() {
  for (auto& fd : fds_) {
    if (fd >= 0) close(fd);
    fd = -1;
  }
  if (listen_fd_ >= 0) close(listen_fd_);
  listen_fd_ = -1;
}

}  // namespace hvdtpu
