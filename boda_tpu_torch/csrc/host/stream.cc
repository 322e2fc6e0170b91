// Framed byte-stream transport (reference capability: stream_util.cc —
// fd/fifo/TCP streams under the IPC remote-execution backend).
//
// Same address grammar and wire format as boda_tpu_torch/parallel/transport.py:
//   fds:R:W | fns:rfifo:wfifo | tcp:host:port | tcp-listen:port
// frames are u32-LE length + payload. TCP_NODELAY set on sockets
// (reference flush strategy, stream_util.cc:76-220).
#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/socket.h>
#include <unistd.h>
#include <vector>

namespace {

struct Stream {
  int rfd = -1, wfd = -1;
  bool is_sock = false;
  bool open = false;
};

std::vector<Stream> g_streams;

void set_err(char *err, int errlen, const std::string &msg) {
  if (err && errlen > 0) {
    strncpy(err, msg.c_str(), (size_t)errlen - 1);
    err[errlen - 1] = 0;
  }
}

int alloc_stream(int rfd, int wfd, bool is_sock) {
  for (size_t i = 0; i < g_streams.size(); i++)
    if (!g_streams[i].open) {
      g_streams[i] = Stream{rfd, wfd, is_sock, true};
      return (int)i;
    }
  g_streams.push_back(Stream{rfd, wfd, is_sock, true});
  return (int)g_streams.size() - 1;
}

bool write_all(int fd, const uint8_t *p, size_t n) {
  while (n) {
    ssize_t w = write(fd, p, n);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += w;
    n -= (size_t)w;
  }
  return true;
}

bool read_all(int fd, uint8_t *p, size_t n) {
  while (n) {
    ssize_t r = read(fd, p, n);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    if (r == 0) return false;  // EOF
    p += r;
    n -= (size_t)r;
  }
  return true;
}

}  // namespace

extern "C" {

// Open a stream by address string. Returns handle >= 0, or -1 (err filled).
int boda_stream_open(const char *addr_c, int is_server, char *err, int errlen) {
  std::string addr(addr_c);
  size_t colon = addr.find(':');
  std::string method = colon == std::string::npos ? addr : addr.substr(0, colon);
  std::string rest = colon == std::string::npos ? "" : addr.substr(colon + 1);
  if (method == "fds") {
    size_t c2 = rest.find(':');
    if (c2 == std::string::npos) { set_err(err, errlen, "fds: expected R:W"); return -1; }
    return alloc_stream(atoi(rest.substr(0, c2).c_str()),
                        atoi(rest.substr(c2 + 1).c_str()), false);
  }
  if (method == "fns") {
    size_t c2 = rest.find(':');
    if (c2 == std::string::npos) { set_err(err, errlen, "fns: expected rfifo:wfifo"); return -1; }
    std::string rfn = rest.substr(0, c2), wfn = rest.substr(c2 + 1);
    int rfd, wfd;
    // open order matters to avoid deadlock: server opens read first
    if (is_server) {
      rfd = open(rfn.c_str(), O_RDONLY);
      wfd = open(wfn.c_str(), O_WRONLY);
    } else {
      wfd = open(wfn.c_str(), O_WRONLY);
      rfd = open(rfn.c_str(), O_RDONLY);
    }
    if (rfd < 0 || wfd < 0) {
      set_err(err, errlen, std::string("fifo open failed: ") + strerror(errno));
      if (rfd >= 0) close(rfd);
      if (wfd >= 0) close(wfd);
      return -1;
    }
    return alloc_stream(rfd, wfd, false);
  }
  if (method == "tcp") {
    size_t c2 = rest.rfind(':');
    if (c2 == std::string::npos) { set_err(err, errlen, "tcp: expected host:port"); return -1; }
    std::string host = rest.substr(0, c2), port = rest.substr(c2 + 1);
    struct addrinfo hints = {}, *ai = nullptr;
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    int rc = getaddrinfo(host.c_str(), port.c_str(), &hints, &ai);
    if (rc != 0) { set_err(err, errlen, std::string("resolve failed: ") + gai_strerror(rc)); return -1; }
    int fd = -1;
    for (struct addrinfo *a = ai; a; a = a->ai_next) {
      fd = socket(a->ai_family, a->ai_socktype, a->ai_protocol);
      if (fd < 0) continue;
      if (connect(fd, a->ai_addr, a->ai_addrlen) == 0) break;
      close(fd);
      fd = -1;
    }
    freeaddrinfo(ai);
    if (fd < 0) { set_err(err, errlen, std::string("connect failed: ") + strerror(errno)); return -1; }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    return alloc_stream(fd, fd, true);
  }
  if (method == "tcp-listen") {
    int port = atoi(rest.c_str());
    int srv = socket(AF_INET, SOCK_STREAM, 0);
    if (srv < 0) { set_err(err, errlen, strerror(errno)); return -1; }
    int one = 1;
    setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    struct sockaddr_in sa = {};
    sa.sin_family = AF_INET;
    sa.sin_port = htons((uint16_t)port);
    sa.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    if (bind(srv, (struct sockaddr *)&sa, sizeof sa) != 0 || listen(srv, 1) != 0) {
      set_err(err, errlen, std::string("bind/listen failed: ") + strerror(errno));
      close(srv);
      return -1;
    }
    int conn = accept(srv, nullptr, nullptr);
    close(srv);
    if (conn < 0) { set_err(err, errlen, std::string("accept failed: ") + strerror(errno)); return -1; }
    setsockopt(conn, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    return alloc_stream(conn, conn, true);
  }
  set_err(err, errlen,
          "make_stream: unknown transport method '" + method + "' in '" + addr + "'");
  return -1;
}

int boda_stream_write_frame(int h, const void *p, int64_t n) {
  if (h < 0 || (size_t)h >= g_streams.size() || !g_streams[h].open) return 1;
  uint8_t hdr[4];
  uint32_t len = (uint32_t)n;
  memcpy(hdr, &len, 4);  // little-endian hosts only (x86/arm LE)
  if (!write_all(g_streams[h].wfd, hdr, 4)) return 1;
  if (n && !write_all(g_streams[h].wfd, (const uint8_t *)p, (size_t)n)) return 1;
  return 0;
}

// Returns frame length >= 0 and sets *out to a malloc'd buffer (caller
// frees via boda_stream_buf_free), or -1 on EOF/error.
int64_t boda_stream_read_frame(int h, void **out) {
  *out = nullptr;
  if (h < 0 || (size_t)h >= g_streams.size() || !g_streams[h].open) return -1;
  uint8_t hdr[4];
  if (!read_all(g_streams[h].rfd, hdr, 4)) return -1;
  uint32_t len;
  memcpy(&len, hdr, 4);
  uint8_t *buf = (uint8_t *)malloc(len ? len : 1);
  if (!buf) return -1;
  if (len && !read_all(g_streams[h].rfd, buf, len)) {
    free(buf);
    return -1;
  }
  *out = buf;
  return (int64_t)len;
}

void boda_stream_buf_free(void *p) { free(p); }

int boda_stream_close(int h) {
  if (h < 0 || (size_t)h >= g_streams.size() || !g_streams[h].open) return 1;
  Stream &s = g_streams[h];
  if (s.is_sock) close(s.rfd);
  else {
    if (s.rfd >= 0) close(s.rfd);
    if (s.wfd >= 0 && s.wfd != s.rfd) close(s.wfd);
  }
  s.open = false;
  return 0;
}

}  // extern "C"
