// TCPStore: key-value rendezvous for multi-controller bootstrap.
//
// The port's copy of paddle_tpu/core/native/store.cc, unchanged in
// behaviour (Paddle's C++ TCPStore, paddle/phi/core/distributed/store/
// tcp_store.h:121, is the original). The store carries rendezvous,
// discovery and small control-plane values (the serving fleet's host
// directory); tensor traffic never touches it.
//
// Protocol (length-prefixed binary, little-endian):
//   request:  u8 cmd | u32 klen | key bytes | u64 vlen | value bytes
//   response: u64 vlen | value bytes            (GET/WAIT/ADD)
//             u64 0xFFFFFFFFFFFFFFFF            (GET miss)
// cmds: 0=SET 1=GET 2=ADD(value=i64 delta -> new value as i64) 3=WAIT
//       4=DELETE 5=COMPARE_SET(unused) 6=PING
//
// Single-threaded poll() loop; WAIT parks the connection until the key
// appears (the reference parks the socket the same way).

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <map>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Conn {
  int fd;
  std::string inbuf;
  bool waiting = false;
  std::string wait_key;
};

struct Server {
  int listen_fd = -1;
  int port = 0;
  std::thread thread;
  bool stop = false;
  std::map<std::string, std::string> kv;
  std::vector<Conn*> conns;
};

bool send_all(int fd, const char* p, size_t n) {
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

void reply_value(int fd, const std::string& v) {
  uint64_t vlen = v.size();
  std::string out(reinterpret_cast<char*>(&vlen), 8);
  out += v;
  send_all(fd, out.data(), out.size());
}

void reply_miss(int fd) {
  uint64_t vlen = ~0ULL;
  send_all(fd, reinterpret_cast<char*>(&vlen), 8);
}

// Returns bytes consumed (0 if incomplete).
size_t handle_one(Server* srv, Conn* c) {
  const std::string& b = c->inbuf;
  if (b.size() < 1 + 4) return 0;
  uint8_t cmd = static_cast<uint8_t>(b[0]);
  uint32_t klen;
  std::memcpy(&klen, b.data() + 1, 4);
  if (b.size() < 1 + 4 + klen + 8) return 0;
  std::string key = b.substr(5, klen);
  uint64_t vlen;
  std::memcpy(&vlen, b.data() + 5 + klen, 8);
  size_t total = 1 + 4 + klen + 8 + vlen;
  if (b.size() < total) return 0;
  std::string val = b.substr(5 + klen + 8, vlen);

  switch (cmd) {
    case 0:  // SET
      srv->kv[key] = val;
      reply_value(c->fd, "");
      break;
    case 1: {  // GET
      auto it = srv->kv.find(key);
      if (it == srv->kv.end()) reply_miss(c->fd);
      else reply_value(c->fd, it->second);
      break;
    }
    case 2: {  // ADD
      int64_t delta = 0;
      if (val.size() == 8) std::memcpy(&delta, val.data(), 8);
      int64_t cur = 0;
      auto it = srv->kv.find(key);
      if (it != srv->kv.end() && it->second.size() == 8)
        std::memcpy(&cur, it->second.data(), 8);
      cur += delta;
      std::string nv(reinterpret_cast<char*>(&cur), 8);
      srv->kv[key] = nv;
      reply_value(c->fd, nv);
      break;
    }
    case 3: {  // WAIT
      auto it = srv->kv.find(key);
      if (it != srv->kv.end()) {
        reply_value(c->fd, it->second);
      } else {
        c->waiting = true;
        c->wait_key = key;
      }
      break;
    }
    case 4:  // DELETE
      srv->kv.erase(key);
      reply_value(c->fd, "");
      break;
    case 6:  // PING
      reply_value(c->fd, "pong");
      break;
    default:
      reply_miss(c->fd);
  }
  return total;
}

void serve(Server* srv) {
  while (!srv->stop) {
    std::vector<pollfd> fds;
    fds.push_back({srv->listen_fd, POLLIN, 0});
    for (Conn* c : srv->conns) fds.push_back({c->fd, POLLIN, 0});
    int r = ::poll(fds.data(), fds.size(), 100 /*ms*/);
    if (r <= 0) continue;

    // conns polled THIS round: an accept below grows srv->conns past the
    // fds snapshot, and indexing fds[i+1] for the new conn would read out
    // of bounds — garbage revents can fake a POLLIN on the idle socket and
    // wedge the whole single-threaded loop in a blocking recv.
    const size_t n_polled = fds.size() - 1;
    if (fds[0].revents & POLLIN) {
      int fd = ::accept(srv->listen_fd, nullptr, nullptr);
      if (fd >= 0) {
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        srv->conns.push_back(new Conn{fd});
      }
    }
    std::vector<Conn*> alive;
    for (size_t i = 0; i < srv->conns.size(); ++i) {
      if (i >= n_polled) {  // accepted this round; poll it next iteration
        alive.push_back(srv->conns[i]);
        continue;
      }
      Conn* c = srv->conns[i];
      bool dead = false;
      if (fds[i + 1].revents & (POLLIN | POLLHUP | POLLERR)) {
        char buf[65536];
        ssize_t n = ::recv(c->fd, buf, sizeof(buf), 0);
        if (n <= 0) {
          dead = true;
        } else {
          c->inbuf.append(buf, static_cast<size_t>(n));
          size_t used;
          while ((used = handle_one(srv, c)) > 0) {
            c->inbuf.erase(0, used);
          }
          // a SET/ADD may satisfy parked WAITs
          for (Conn* w : srv->conns) {
            if (w->waiting && srv->kv.count(w->wait_key)) {
              w->waiting = false;
              reply_value(w->fd, srv->kv[w->wait_key]);
            }
          }
        }
      }
      if (dead) {
        ::close(c->fd);
        delete c;
      } else {
        alive.push_back(c);
      }
    }
    srv->conns.swap(alive);
  }
  for (Conn* c : srv->conns) {
    ::close(c->fd);
    delete c;
  }
  srv->conns.clear();
  ::close(srv->listen_fd);
}

}  // namespace

extern "C" {

// Returns an opaque handle (>0) or 0 on failure; *out_port gets the port.
void* pt_store_server_start(int port, int* out_port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return nullptr;
  }
  socklen_t len = sizeof(addr);
  getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len);
  if (::listen(fd, 128) != 0) {
    ::close(fd);
    return nullptr;
  }
  Server* srv = new Server();
  srv->listen_fd = fd;
  srv->port = ntohs(addr.sin_port);
  if (out_port) *out_port = srv->port;
  srv->thread = std::thread(serve, srv);
  return srv;
}

void pt_store_server_stop(void* handle) {
  Server* srv = static_cast<Server*>(handle);
  if (!srv) return;
  srv->stop = true;
  if (srv->thread.joinable()) srv->thread.join();
  delete srv;
}

}  // extern "C"
