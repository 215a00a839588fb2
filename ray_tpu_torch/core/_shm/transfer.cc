// Native object-transfer data plane over the shm store.
//
// Reference analogue: src/ray/object_manager/ — the C++ transfer plane
// (PullManager/PushManager + ObjectManagerService) that moves sealed
// plasma objects between nodes without the driver language in the loop.
// Same split here: Python owns the CONTROL path (who holds what, which
// address; see core/object_transfer.py), while this file is the DATA
// path — a serving thread streams a sealed object straight out of the
// mmap'd arena (shm_obj_get pins it; no intermediate buffer, no
// per-chunk RPC framing), and the pulling side receives into a single
// caller-provided buffer with the GIL released (ctypes).
//
// Protocol (one TCP connection, many sequential pulls):
//   request : [1B op=1][20B object id]
//   response: [1B status]                 status 1 = not found
//             [8B big-endian size][size bytes]   when status 0
//
// Compiled into libshm_store.so together with shm_store.cc (see
// Makefile); the store functions below resolve within the same .so.
// TSAN builds cover the serving threads via the in-process tests in
// tests/test_shm_store.py (fork-free, like the store's own TSAN tier).

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

extern "C" {
// from shm_store.cc (same shared object)
void* shm_obj_get(void* handle, const uint8_t* id, uint64_t* size_out);
int shm_obj_release(void* handle, const uint8_t* id);
void* shm_obj_create(void* handle, const uint8_t* id, uint64_t size);
int shm_obj_seal(void* handle, const uint8_t* id);
int shm_obj_delete(void* handle, const uint8_t* id);
}

namespace {

constexpr int kIdSize = 20;
constexpr uint8_t kOpPull = 1;
constexpr uint8_t kStatusOk = 0;
constexpr uint8_t kStatusMissing = 1;

// A stalled puller (zero TCP window) must not block a serving thread
// forever: the thread holds a pin on the blob it is streaming, and a
// pinned entry can never be evicted — an unbounded send would strand
// that arena region for the holder's lifetime. Receives stay unbounded
// on the server (idle pooled connections are normal).
constexpr int kServerSendTimeoutMs = 30000;

bool SendAll(int fd, const void* buf, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t w = send(fd, p, n, MSG_NOSIGNAL);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool RecvAll(int fd, void* buf, size_t n) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = recv(fd, p, n, 0);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    if (r == 0) return false;  // peer closed mid-message
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

void PackU64(uint8_t* out, uint64_t v) {
  for (int i = 7; i >= 0; i--) {
    out[i] = static_cast<uint8_t>(v & 0xff);
    v >>= 8;
  }
}

uint64_t UnpackU64(const uint8_t* in) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) v = (v << 8) | in[i];
  return v;
}

struct TransferServer {
  void* store = nullptr;
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> stopping{false};
  std::thread accept_thread;
  std::mutex mu;                    // guards conn_fds + active_conns
  std::condition_variable done_cv;  // stop() waits for active_conns == 0
  std::vector<int> conn_fds;        // slot table; -1 = free (slots reused,
                                    // so churn does not grow the vector)
  int active_conns = 0;
};

// Serve sequential pulls on one connection until EOF/error/stop. Runs
// detached; clears its slot under the lock BEFORE closing the fd, so
// stop() can never shutdown() an fd number the OS has reassigned.
void ServeConn(TransferServer* srv, int fd, size_t slot) {
  uint8_t req[1 + kIdSize];
  while (!srv->stopping.load(std::memory_order_relaxed)) {
    if (!RecvAll(fd, req, sizeof(req))) break;
    if (req[0] != kOpPull) break;  // unknown op: drop the connection
    uint64_t size = 0;
    void* ptr = shm_obj_get(srv->store, req + 1, &size);
    if (ptr == nullptr) {
      uint8_t status = kStatusMissing;
      if (!SendAll(fd, &status, 1)) break;
      continue;
    }
    uint8_t head[9];
    head[0] = kStatusOk;
    PackU64(head + 1, size);
    bool ok = SendAll(fd, head, sizeof(head)) && SendAll(fd, ptr, size);
    shm_obj_release(srv->store, req + 1);
    if (!ok) break;
  }
  {
    std::lock_guard<std::mutex> g(srv->mu);
    srv->conn_fds[slot] = -1;
    srv->active_conns--;
    srv->done_cv.notify_all();
  }
  close(fd);  // after the slot is cleared: stop() no longer sees this fd
}

void AcceptLoop(TransferServer* srv) {
  while (!srv->stopping.load(std::memory_order_relaxed)) {
    int fd = accept(srv->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (errno == EINTR) continue;
      break;  // listen fd shut down (stop) or fatal
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    timeval tv;
    tv.tv_sec = kServerSendTimeoutMs / 1000;
    tv.tv_usec = (kServerSendTimeoutMs % 1000) * 1000;
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    std::lock_guard<std::mutex> g(srv->mu);
    if (srv->stopping.load(std::memory_order_relaxed)) {
      close(fd);
      break;
    }
    size_t slot = 0;
    while (slot < srv->conn_fds.size() && srv->conn_fds[slot] != -1) slot++;
    if (slot == srv->conn_fds.size()) srv->conn_fds.push_back(fd);
    else srv->conn_fds[slot] = fd;
    srv->active_conns++;
    std::thread(ServeConn, srv, fd, slot).detach();
  }
}

}  // namespace

extern "C" {

// Start serving `store` on `host`:`port` (port 0 = ephemeral). Returns
// an opaque handle or null; *port_out receives the bound port.
void* shm_transfer_server_start(void* store, const char* host, int port,
                                int* port_out) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(fd);
    return nullptr;
  }
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 64) != 0) {
    close(fd);
    return nullptr;
  }
  socklen_t len = sizeof(addr);
  if (getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len) != 0) {
    close(fd);
    return nullptr;
  }
  TransferServer* srv = new TransferServer();
  srv->store = store;
  srv->listen_fd = fd;
  srv->port = ntohs(addr.sin_port);
  if (port_out != nullptr) *port_out = srv->port;
  srv->accept_thread = std::thread(AcceptLoop, srv);
  return srv;
}

int shm_transfer_server_port(void* handle) {
  return static_cast<TransferServer*>(handle)->port;
}

void shm_transfer_server_stop(void* handle) {
  TransferServer* srv = static_cast<TransferServer*>(handle);
  srv->stopping.store(true, std::memory_order_relaxed);
  shutdown(srv->listen_fd, SHUT_RDWR);
  srv->accept_thread.join();
  close(srv->listen_fd);
  {
    std::unique_lock<std::mutex> lk(srv->mu);
    for (int fd : srv->conn_fds)
      if (fd != -1) shutdown(fd, SHUT_RDWR);  // wakes blocked recv/send
    srv->done_cv.wait(lk, [srv] { return srv->active_conns == 0; });
  }
  delete srv;
}

// Client side. One fd per holder, reused across pulls (mirrors the
// pooled connections of the Python control path). `timeout_ms` bounds
// the connect AND every subsequent send/recv on the fd — a holder whose
// native port is blackholed must fail fast so the puller can fall back
// to the chunked control-path transfer (which carries its own timeout).
int shm_transfer_connect(const char* host, int port, int timeout_ms) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(fd);
    return -1;
  }
  int flags = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  int rc = connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
  if (rc != 0) {
    if (errno != EINPROGRESS) {
      close(fd);
      return -1;
    }
    pollfd pfd = {fd, POLLOUT, 0};
    if (poll(&pfd, 1, timeout_ms) != 1) {
      close(fd);
      return -1;  // timed out (or poll error)
    }
    int err = 0;
    socklen_t len = sizeof(err);
    if (getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len) != 0 || err != 0) {
      close(fd);
      return -1;
    }
  }
  fcntl(fd, F_SETFL, flags);  // back to blocking, bounded by SO_*TIMEO
  timeval tv;
  tv.tv_sec = timeout_ms / 1000;
  tv.tv_usec = (timeout_ms % 1000) * 1000;
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

// Pull object `id` into caller buffer `buf` (capacity `cap`). Returns the
// object size on success; -1 on connection error; -2 if the holder does
// not have the object; -3 if the object exceeds `cap` (the payload is
// drained so the connection stays usable).
int64_t shm_transfer_pull_buf(int fd, const uint8_t* id, void* buf,
                              uint64_t cap) {
  uint8_t req[1 + kIdSize];
  req[0] = kOpPull;
  memcpy(req + 1, id, kIdSize);
  if (!SendAll(fd, req, sizeof(req))) return -1;
  uint8_t status;
  if (!RecvAll(fd, &status, 1)) return -1;
  if (status == kStatusMissing) return -2;
  if (status != kStatusOk) return -1;
  uint8_t size_be[8];
  if (!RecvAll(fd, size_be, sizeof(size_be))) return -1;
  uint64_t size = UnpackU64(size_be);
  if (size > cap) {
    uint8_t scratch[1 << 16];
    uint64_t left = size;
    while (left > 0) {
      size_t n = left < sizeof(scratch) ? static_cast<size_t>(left)
                                        : sizeof(scratch);
      if (!RecvAll(fd, scratch, n)) return -1;
      left -= n;
    }
    return -3;
  }
  if (!RecvAll(fd, buf, size)) return -1;
  return static_cast<int64_t>(size);
}

// Pull object `id` straight into `dst_store` (create -> recv into the
// mapped arena -> seal): no caller-side allocation at all, which matters
// because the puller's buffer would otherwise be zero-filled by the
// allocator before the recv overwrites it. Returns the size on success;
// -1 on connection error; -2 if the holder does not have the object;
// -3 if the local create failed (duplicate / table full / exceeds
// arena — payload drained so the connection stays usable).
int64_t shm_transfer_pull_store(int fd, const uint8_t* id, void* dst_store) {
  uint8_t req[1 + kIdSize];
  req[0] = kOpPull;
  memcpy(req + 1, id, kIdSize);
  if (!SendAll(fd, req, sizeof(req))) return -1;
  uint8_t status;
  if (!RecvAll(fd, &status, 1)) return -1;
  if (status == kStatusMissing) return -2;
  if (status != kStatusOk) return -1;
  uint8_t size_be[8];
  if (!RecvAll(fd, size_be, sizeof(size_be))) return -1;
  uint64_t size = UnpackU64(size_be);
  void* ptr = shm_obj_create(dst_store, id, size);
  if (ptr == nullptr) {
    uint8_t scratch[1 << 16];
    uint64_t left = size;
    while (left > 0) {
      size_t n = left < sizeof(scratch) ? static_cast<size_t>(left)
                                        : sizeof(scratch);
      if (!RecvAll(fd, scratch, n)) return -1;
      left -= n;
    }
    return -3;
  }
  if (!RecvAll(fd, ptr, size)) {
    shm_obj_release(dst_store, id);  // drop the creator pin, then reclaim
    shm_obj_delete(dst_store, id);
    return -1;
  }
  shm_obj_seal(dst_store, id);
  return static_cast<int64_t>(size);
}

void shm_transfer_close_fd(int fd) { close(fd); }

}  // extern "C"
