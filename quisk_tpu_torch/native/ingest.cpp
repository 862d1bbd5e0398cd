// quisk_tpu_torch native ingest library (host code, g++).
//
// Host-side, performance-critical sample ingest: packed-sample conversion,
// SDR packet framing/deframing with sequence tracking, and a lock-free
// SPSC ring buffer feeding the device pipeline.  These are the equivalents
// of the reference's C UDP readers (quisk.c:3284 quisk_read_rx_udp, 3519
// read_rx_udp10) and TX framers (microphone.c:721 quisk_hermes_tx_*),
// rebuilt as a reusable library with a C ABI consumed from Python via
// ctypes (no pybind11 dependency).
//
// Wire formats implemented (protocol shapes, written fresh from the
// protocol descriptions in SURVEY.md §2 / §5.8):
//  - iq24: packed little-endian signed 24-bit I/Q pairs -> float32 in [-1,1)
//  - hiqsdr: 1442-byte UDP payload = 1 seq byte + 1 status byte +
//            240 iq24 pairs (the N2ADR protocol family)
//  - metis:  1032-byte frame = 0xEF 0xFE 0x01 <ep> <seq:4 BE> + 2 x 512-byte
//            sub-frames, each: 0x7F 0x7F 0x7F c0..c4 then (n_rx * 6 + 2)-byte
//            sample groups: per-rx 24-bit I,Q then 16-bit mic
//  - wideband: [0xEF 0xFD][seq:4 BE][flags][0] + up to 8160 iq24 pairs
//
// Build: quisk_tpu_torch.io.native builds this file with g++ at first use
// into quisk_tpu_torch/_build/ (no -march=native: nothing in the library
// depends on the CPU it was built on).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <poll.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// 8160 pairs = 48,968-byte wideband datagrams (under the 64 KB limit)
constexpr int64_t QT_WB_PAIRS = 8160;

// ---------------------------------------------------------------- iq24
// Convert n packed 24-bit little-endian signed I/Q pairs to float32.
void qt_unpack_iq24(const uint8_t* in, int64_t n_pairs, float* out_i,
                    float* out_q) {
  const float scale = 1.0f / 8388608.0f;  // 2^23
  for (int64_t k = 0; k < n_pairs; ++k) {
    const uint8_t* p = in + k * 6;
    int32_t i = (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                          ((uint32_t)p[2] << 16));
    int32_t q = (int32_t)((uint32_t)p[3] | ((uint32_t)p[4] << 8) |
                          ((uint32_t)p[5] << 16));
    if (i & 0x800000) i -= 0x1000000;  // sign-extend 24 -> 32
    if (q & 0x800000) q -= 0x1000000;
    out_i[k] = (float)i * scale;
    out_q[k] = (float)q * scale;
  }
}

// Pack float32 I/Q into 24-bit little-endian pairs (TX direction).
void qt_pack_iq24(const float* in_i, const float* in_q, int64_t n_pairs,
                  uint8_t* out) {
  for (int64_t k = 0; k < n_pairs; ++k) {
    float fi = in_i[k], fq = in_q[k];
    if (fi > 0.9999999f) fi = 0.9999999f;
    if (fi < -1.0f) fi = -1.0f;
    if (fq > 0.9999999f) fq = 0.9999999f;
    if (fq < -1.0f) fq = -1.0f;
    int32_t i = (int32_t)(fi * 8388608.0f);
    int32_t q = (int32_t)(fq * 8388608.0f);
    uint8_t* p = out + k * 6;
    p[0] = (uint8_t)(i & 0xFF);
    p[1] = (uint8_t)((i >> 8) & 0xFF);
    p[2] = (uint8_t)((i >> 16) & 0xFF);
    p[3] = (uint8_t)(q & 0xFF);
    p[4] = (uint8_t)((q >> 8) & 0xFF);
    p[5] = (uint8_t)((q >> 16) & 0xFF);
  }
}

// ---------------------------------------------------------------- hiqsdr
// Payload: [seq:1][status:1][240 iq24 pairs] = 1442 bytes.
// Returns pairs written (240) or -1 on short packet.  seq_state tracks the
// expected next sequence number; *seq_errors increments on mismatch
// (the reference counts these the same way, quisk.c:3357-3363).
int64_t qt_hiqsdr_parse(const uint8_t* pkt, int64_t len, uint8_t* seq_state,
                        int64_t* seq_errors, float* out_i, float* out_q,
                        uint8_t* status_out) {
  if (len < 2 + 240 * 6) return -1;
  uint8_t seq = pkt[0];
  if (seq != *seq_state) ++*seq_errors;
  *seq_state = (uint8_t)(seq + 1);
  *status_out = pkt[1];
  qt_unpack_iq24(pkt + 2, 240, out_i, out_q);
  return 240;
}

int64_t qt_hiqsdr_build(const float* in_i, const float* in_q, uint8_t seq,
                        uint8_t status, uint8_t* out) {
  out[0] = seq;
  out[1] = status;
  qt_pack_iq24(in_i, in_q, 240, out + 2);
  return 2 + 240 * 6;
}

// -------------------------------------------------------------- wideband
// Jumbo-frame single-stream transport for wideband ingest (codec 2).
// The radio protocols above are packet-rate-bound at ~1-1.4 KB/frame —
// per-packet kernel cost caps the host path far below the >100x
// real-time contract.  This framing carries 8160 iq24 pairs per
// datagram (~48 KB: loopback MTU is 64 KB; on real fabrics it rides
// 9k-MTU jumbo frames via kernel UDP fragmentation or GSO), making the
// path byte-bound instead.  Layout:
//   [0xEF 0xFD][seq:u32 BE][flags:u8][0]  +  n iq24 pairs.
// seq_step > 1 supports STRIPED streams: one logical capture split
// round-robin over N sockets, socket i carrying seqs i, i+N, i+2N...
// *synced == 0 means no sequence is expected yet: the packet's own seq
// becomes the synchronisation point (joining a stream already in progress
// counts no error) and *synced is set.
int64_t qt_wideband_parse(const uint8_t* pkt, int64_t len,
                          uint32_t* seq_state, uint32_t seq_step,
                          uint8_t* synced, int64_t* seq_errors,
                          float* out_i, float* out_q) {
  if (len < 8 || pkt[0] != 0xEF || pkt[1] != 0xFD) return -1;
  int64_t np = (len - 8) / 6;
  if (np > QT_WB_PAIRS) return -1;
  uint32_t seq = ((uint32_t)pkt[2] << 24) | ((uint32_t)pkt[3] << 16) |
                 ((uint32_t)pkt[4] << 8) | (uint32_t)pkt[5];
  if (!*synced) {
    *seq_state = seq;
    *synced = 1;
  }
  if (seq != *seq_state) ++*seq_errors;
  *seq_state = seq + seq_step;
  qt_unpack_iq24(pkt + 8, np, out_i, out_q);
  return np;
}

int64_t qt_wideband_build(const float* in_i, const float* in_q,
                          int64_t n_pairs, uint32_t seq, uint8_t* out) {
  out[0] = 0xEF; out[1] = 0xFD;
  out[2] = (uint8_t)(seq >> 24); out[3] = (uint8_t)(seq >> 16);
  out[4] = (uint8_t)(seq >> 8);  out[5] = (uint8_t)seq;
  out[6] = 0; out[7] = 0;
  qt_pack_iq24(in_i, in_q, n_pairs, out + 8);
  return 8 + n_pairs * 6;
}

// ---------------------------------------------------------------- metis
// 1032-byte frame: EF FE 01 <ep> <seq32 BE> + 2 x 512-byte sub-frames.
// Sub-frame: 7F 7F 7F c0 c1 c2 c3 c4 then sample groups of
// (n_rx * 6 + 2) bytes: per-rx 24-bit BIG-endian I,Q then 16-bit BE mic.
// Returns total per-rx sample count appended to out arrays, or -1 on bad
// sync / header.  out_iq is an array of n_rx pointers to (i,q) interleaved
// float32 (len 2*max_samples); mic is int16 out.
static inline int32_t be24(const uint8_t* p) {
  int32_t v = ((int32_t)p[0] << 16) | ((int32_t)p[1] << 8) | (int32_t)p[2];
  if (v & 0x800000) v -= 0x1000000;
  return v;
}

int64_t qt_metis_parse(const uint8_t* pkt, int64_t len, int32_t n_rx,
                       uint32_t* seq_state, int64_t* seq_errors,
                       float* out_iq /* [n_rx][2*max] interleaved */,
                       int64_t out_stride /* floats per rx row */,
                       int16_t* out_mic, uint8_t* ctl_out /* [2*5] */) {
  if (len < 1032 || pkt[0] != 0xEF || pkt[1] != 0xFE || pkt[2] != 0x01)
    return -1;
  uint32_t seq = ((uint32_t)pkt[4] << 24) | ((uint32_t)pkt[5] << 16) |
                 ((uint32_t)pkt[6] << 8) | (uint32_t)pkt[7];
  if (seq != *seq_state) ++*seq_errors;
  *seq_state = seq + 1;
  const float scale = 1.0f / 8388608.0f;
  int64_t ns = 0;
  int group = n_rx * 6 + 2;
  for (int sub = 0; sub < 2; ++sub) {
    const uint8_t* f = pkt + 8 + sub * 512;
    if (f[0] != 0x7F || f[1] != 0x7F || f[2] != 0x7F) return -1;
    memcpy(ctl_out + sub * 5, f + 3, 5);
    const uint8_t* s = f + 8;
    int count = (512 - 8) / group;
    for (int k = 0; k < count; ++k, s += group) {
      for (int r = 0; r < n_rx; ++r) {
        float iv = (float)be24(s + r * 6) * scale;
        float qv = (float)be24(s + r * 6 + 3) * scale;
        out_iq[r * out_stride + 2 * ns] = iv;
        out_iq[r * out_stride + 2 * ns + 1] = qv;
      }
      out_mic[ns] = (int16_t)(((int16_t)s[n_rx * 6] << 8) |
                              (uint8_t)s[n_rx * 6 + 1]);
      ++ns;
    }
  }
  return ns;
}

// Build one Metis TX frame from float IQ (+mic ignored/zero): round-robin
// control registers supplied by the caller (c0..c4 per sub-frame).
int64_t qt_metis_build(const float* iq /* interleaved i,q */, int64_t n,
                       uint32_t seq, const uint8_t* ctl /* [2*5] */,
                       uint8_t* out /* 1032 */) {
  if (n < 126) return -1;  // need 63 samples per sub-frame (group = 8)
  memset(out, 0, 1032);
  out[0] = 0xEF; out[1] = 0xFE; out[2] = 0x01; out[3] = 0x02;
  out[4] = (uint8_t)(seq >> 24); out[5] = (uint8_t)(seq >> 16);
  out[6] = (uint8_t)(seq >> 8); out[7] = (uint8_t)seq;
  int64_t k = 0;
  for (int sub = 0; sub < 2; ++sub) {
    uint8_t* f = out + 8 + sub * 512;
    f[0] = 0x7F; f[1] = 0x7F; f[2] = 0x7F;
    memcpy(f + 3, ctl + sub * 5, 5);
    uint8_t* s = f + 8;
    int count = (512 - 8) / 8;  // 1 tx "rx" group: 6 bytes IQ + 2 mic
    for (int g = 0; g < count && k < n; ++g, s += 8, ++k) {
      float fi = iq[2 * k], fq = iq[2 * k + 1];
      if (fi > 0.9999999f) fi = 0.9999999f;
      if (fi < -1.0f) fi = -1.0f;
      if (fq > 0.9999999f) fq = 0.9999999f;
      if (fq < -1.0f) fq = -1.0f;
      int32_t i = (int32_t)(fi * 8388608.0f);
      int32_t q = (int32_t)(fq * 8388608.0f);
      s[0] = (uint8_t)(i >> 16); s[1] = (uint8_t)(i >> 8); s[2] = (uint8_t)i;
      s[3] = (uint8_t)(q >> 16); s[4] = (uint8_t)(q >> 8); s[5] = (uint8_t)q;
    }
  }
  return 1032;
}

// ---------------------------------------------------------------- ring
// Lock-free single-producer single-consumer ring of float32 (pairs welcome:
// push I/Q interleaved).  Capacity must be a power of two.
struct QtRing {
  float* buf;
  int64_t cap;           // in floats
  std::atomic<int64_t> head;  // write index (producer)
  std::atomic<int64_t> tail;  // read index (consumer)
  int64_t overruns;
};

void* qt_ring_create(int64_t capacity_floats) {
  int64_t cap = 1;
  while (cap < capacity_floats) cap <<= 1;
  QtRing* r = new QtRing();
  r->buf = new float[cap];
  r->cap = cap;
  r->head.store(0);
  r->tail.store(0);
  r->overruns = 0;
  return r;
}

void qt_ring_destroy(void* h) {
  QtRing* r = (QtRing*)h;
  delete[] r->buf;
  delete r;
}

int64_t qt_ring_size(void* h) {
  QtRing* r = (QtRing*)h;
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

int64_t qt_ring_overruns(void* h) { return ((QtRing*)h)->overruns; }

// Push n floats; drops (counts overrun) if not enough space.  Returns
// number actually written.
int64_t qt_ring_push(void* h, const float* data, int64_t n) {
  QtRing* r = (QtRing*)h;
  int64_t head = r->head.load(std::memory_order_relaxed);
  int64_t tail = r->tail.load(std::memory_order_acquire);
  int64_t space = r->cap - (head - tail);
  if (n > space) {
    ++r->overruns;
    n = space;
  }
  // at most two contiguous pieces: to the end of the buffer, then from 0
  int64_t at = head & (r->cap - 1);
  int64_t first = n < r->cap - at ? n : r->cap - at;
  memcpy(r->buf + at, data, (size_t)first * sizeof(float));
  memcpy(r->buf, data + first, (size_t)(n - first) * sizeof(float));
  r->head.store(head + n, std::memory_order_release);
  return n;
}

// Pop up to n floats; returns count popped.
int64_t qt_ring_pop(void* h, float* out, int64_t n) {
  QtRing* r = (QtRing*)h;
  int64_t head = r->head.load(std::memory_order_acquire);
  int64_t tail = r->tail.load(std::memory_order_relaxed);
  int64_t avail = head - tail;
  if (n > avail) n = avail;
  int64_t at = tail & (r->cap - 1);
  int64_t first = n < r->cap - at ? n : r->cap - at;
  memcpy(out, r->buf + at, (size_t)first * sizeof(float));
  memcpy(out + first, r->buf, (size_t)(n - first) * sizeof(float));
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

// ----------------------------------------------------------------- pump
// The whole ingest hot path in native code: a reader thread owns the
// socket, drains it with batched recvmmsg, parses (HiQSDR or Metis) and
// pushes interleaved I/Q float32 into per-receiver SPSC rings.  Python
// only supervises (start/stop/stats) and assembles blocks from the rings
// at block rate.  This is the analogue of the reference's C readers
// (quisk.c:3284 quisk_read_rx_udp / 3519 read_rx_udp10) — they ARE the
// reference's hot path; a per-packet Python loop caps out ~100x lower.

struct QtPump {
  int fd = -1;
  int codec = 0;  // 0 = hiqsdr, 1 = metis, 2 = wideband
  int n_rx = 1;
  std::vector<QtRing*> rings;
  QtRing* mic = nullptr;
  std::thread th;
  std::atomic<bool> running{false};
  std::atomic<int64_t> packets{0}, bad{0}, samples{0}, seq_errors{0};
  uint8_t hiq_seq = 0;
  uint32_t metis_seq = 0;
  uint32_t wb_seq = 0;
  uint32_t wb_step = 1;
  uint8_t wb_synced = 0;  // 0: the first wideband packet sets wb_seq
  // floats pushed to ring 0 before the first wideband packet that broke
  // the expected sequence or did not fit the ring whole, -1 while none
  // has; stored before that packet's push, so a reader that sees the
  // packet's samples sees it too
  std::atomic<int64_t> gap_at{-1};
  uint8_t ctl[10] = {0};
  uint8_t status = 0;
  // Hermes radio->PC status plane (quisk.c:3641-3718): C1..C4 for rows
  // 0..4 (quisk_hermes_to_pc), the latched HL2 ACK response, and the
  // key/overrange bits decoded from row 0.
  uint8_t h2pc[20] = {0};
  uint8_t ack[5] = {0};
  std::atomic<int32_t> ack_flag{0};
  std::atomic<int64_t> overrange{0};
  std::atomic<uint8_t> hw_ptt{0}, hw_cwkey{0}, tx_inhibit{0};
};

// Route one radio->PC C0..C4 group (quisk.c:3639-3676): ACK-bearing
// responses (C0 bit 7 of the >>1 view) latch for the host's write-queue
// state machine; rows 0..4 store C1..C4; row 0 carries PTT (C0 bit 0),
// CW key (C0 bit 2), overrange (C1 bit 0) and the TX-inhibit bit.
static void qt_hermes_route(QtPump* p, const uint8_t* g) {
  uint32_t d = (uint32_t)g[0] >> 1;
  if (d & 0x40) {  // HL2 ACK response: latch, do not store as row data
    memcpy(p->ack, g, 5);
    p->ack_flag.store(1, std::memory_order_release);
    return;
  }
  d >>= 2;
  if (d <= 4) memcpy(p->h2pc + d * 4, g + 1, 4);
  if (d == 0) {
    if (g[1] & 0x01) p->overrange.fetch_add(1, std::memory_order_relaxed);
    p->tx_inhibit.store((g[1] & 0x02) ? 0 : 1, std::memory_order_relaxed);
    p->hw_ptt.store(g[0] & 0x01, std::memory_order_relaxed);
    p->hw_cwkey.store((g[0] >> 2) & 0x01, std::memory_order_relaxed);
  }
}

void* qt_pump_create(int32_t codec, int32_t n_rx, const char* host,
                     int32_t port, int64_t ring_floats) {
  QtPump* p = new QtPump();
  p->codec = codec;
  p->n_rx = n_rx;
  p->fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (p->fd < 0) { delete p; return nullptr; }
  // deep kernel buffer: at 100+ MB/s a scheduling hiccup must not drop
  // (the reference leans on SO_RCVBUF the same way, quisk.c:4002).
  // SO_RCVBUF is capped at net.core.rmem_max, which on some hosts is 208
  // KB, a few wideband datagrams; a process allowed to (CAP_NET_ADMIN)
  // takes the whole buffer with SO_RCVBUFFORCE.
  int rcv = 1 << 24;
  if (setsockopt(p->fd, SOL_SOCKET, SO_RCVBUFFORCE, &rcv, sizeof rcv) != 0)
    setsockopt(p->fd, SOL_SOCKET, SO_RCVBUF, &rcv, sizeof rcv);
  sockaddr_in a;
  memset(&a, 0, sizeof a);
  a.sin_family = AF_INET;
  a.sin_port = htons((uint16_t)port);
  a.sin_addr.s_addr = host && host[0] ? inet_addr(host)
                                      : htonl(INADDR_LOOPBACK);
  if (bind(p->fd, (sockaddr*)&a, sizeof a) != 0) {
    close(p->fd);
    delete p;
    return nullptr;
  }
  for (int r = 0; r < n_rx; ++r)
    p->rings.push_back((QtRing*)qt_ring_create(ring_floats));
  p->mic = (QtRing*)qt_ring_create(ring_floats / 2);
  return p;
}

// The socket's receive buffer in bytes, as the kernel granted it.
int32_t qt_pump_rcvbuf(void* h) {
  int v = 0;
  socklen_t len = sizeof v;
  if (getsockopt(((QtPump*)h)->fd, SOL_SOCKET, SO_RCVBUF, &v, &len) != 0)
    return -1;
  return v;
}

int32_t qt_pump_port(void* h) {
  QtPump* p = (QtPump*)h;
  sockaddr_in a;
  socklen_t alen = sizeof a;
  if (getsockname(p->fd, (sockaddr*)&a, &alen) != 0) return -1;
  return (int32_t)ntohs(a.sin_port);
}

// Configure the wideband sequence expectation for STRIPED streams:
// this socket carries seqs seq0, seq0+step, seq0+2*step, ... from the
// first packet on (an explicit expectation: no first-packet sync).
void qt_pump_set_seq(void* h, uint32_t seq0, uint32_t step) {
  QtPump* p = (QtPump*)h;
  p->wb_seq = seq0;
  p->wb_step = step ? step : 1;
  p->wb_synced = 1;
}

// Ring-0 float position of the first wideband sequence break or partial
// push, -1 if none.
int64_t qt_pump_gap_at(void* h) {
  return ((QtPump*)h)->gap_at.load(std::memory_order_acquire);
}

static void qt_pump_loop(QtPump* p) {
  const int BATCH = p->codec == 2 ? 16 : 64;
  const int MTU = p->codec == 2 ? 49152 + 64 : 2048;
  std::vector<uint8_t> bufs((size_t)BATCH * MTU);
  mmsghdr msgs[64];
  iovec iov[64];
  for (int k = 0; k < BATCH; ++k) {
    iov[k].iov_base = bufs.data() + (size_t)k * MTU;
    iov[k].iov_len = (size_t)MTU;
    memset(&msgs[k], 0, sizeof msgs[k]);
    msgs[k].msg_hdr.msg_iov = &iov[k];
    msgs[k].msg_hdr.msg_iovlen = 1;
  }
  constexpr int MAXNS = 256;
  std::vector<float> iqbuf((size_t)p->n_rx * 2 * MAXNS);
  std::vector<float> wbi, wbq, wbin;
  if (p->codec == 2) {
    wbi.resize(QT_WB_PAIRS);
    wbq.resize(QT_WB_PAIRS);
    wbin.resize(2 * QT_WB_PAIRS);
  }
  int16_t micbuf[MAXNS];
  float micf[MAXNS];
  float outi[256], outq[256], inter[512];
  pollfd pf;
  pf.fd = p->fd;
  pf.events = POLLIN;
  while (p->running.load(std::memory_order_relaxed)) {
    if (poll(&pf, 1, 100) <= 0) continue;
    for (;;) {
      int n = recvmmsg(p->fd, msgs, BATCH, MSG_DONTWAIT, nullptr);
      if (n <= 0) break;
      for (int m = 0; m < n; ++m) {
        const uint8_t* pkt = bufs.data() + (size_t)m * MTU;
        int64_t len = msgs[m].msg_len;
        int64_t se = 0;
        if (p->codec == 2) {
          int64_t ns = qt_wideband_parse(pkt, len, &p->wb_seq,
                                         p->wb_step, &p->wb_synced, &se,
                                         wbi.data(), wbq.data());
          if (ns < 0) { ++p->bad; continue; }
          for (int64_t k = 0; k < ns; ++k) {
            wbin[2 * k] = wbi[k];
            wbin[2 * k + 1] = wbq[k];
          }
          QtRing* r0 = p->rings[0];
          int64_t head = r0->head.load(std::memory_order_relaxed);
          bool full = r0->cap - (head - r0->tail.load(
                                     std::memory_order_acquire)) < 2 * ns;
          // a sequence break, or a packet the ring cannot take whole
          if ((se || full) && p->gap_at.load(std::memory_order_relaxed) < 0)
            p->gap_at.store(head, std::memory_order_release);
          qt_ring_push(r0, wbin.data(), 2 * ns);
          p->seq_errors += se;
          ++p->packets;
          p->samples += ns;
        } else if (p->codec == 0) {
          uint8_t st = 0;
          int64_t ns = qt_hiqsdr_parse(pkt, len, &p->hiq_seq, &se, outi,
                                       outq, &st);
          if (ns < 0) { ++p->bad; continue; }
          p->status = st;
          for (int64_t k = 0; k < ns; ++k) {
            inter[2 * k] = outi[k];
            inter[2 * k + 1] = outq[k];
          }
          qt_ring_push(p->rings[0], inter, 2 * ns);
          p->seq_errors += se;
          ++p->packets;
          p->samples += ns;
        } else {
          int64_t ns = qt_metis_parse(pkt, len, p->n_rx, &p->metis_seq, &se,
                                      iqbuf.data(), 2 * MAXNS, micbuf,
                                      p->ctl);
          if (ns < 0) { ++p->bad; continue; }
          qt_hermes_route(p, p->ctl);
          qt_hermes_route(p, p->ctl + 5);
          for (int r = 0; r < p->n_rx; ++r)
            qt_ring_push(p->rings[r], iqbuf.data() + (size_t)r * 2 * MAXNS,
                         2 * ns);
          for (int64_t k = 0; k < ns; ++k)
            micf[k] = (float)micbuf[k] * (1.0f / 32768.0f);
          qt_ring_push(p->mic, micf, ns);
          p->seq_errors += se;
          ++p->packets;
          p->samples += ns;
        }
      }
      if (n < BATCH) break;
    }
  }
}

int32_t qt_pump_start(void* h) {
  QtPump* p = (QtPump*)h;
  if (p->running.load()) return 0;
  p->running.store(true);
  p->th = std::thread(qt_pump_loop, p);
  return 0;
}

void qt_pump_stop(void* h) {
  QtPump* p = (QtPump*)h;
  p->running.store(false);
  if (p->th.joinable()) p->th.join();
}

void qt_pump_destroy(void* h) {
  QtPump* p = (QtPump*)h;
  qt_pump_stop(h);
  if (p->fd >= 0) close(p->fd);
  for (QtRing* r : p->rings) qt_ring_destroy(r);
  qt_ring_destroy(p->mic);
  delete p;
}

// out[7]: packets, bad_packets, per-rx samples, seq_errors, ring_overruns,
// min ring fill (complex samples), mic fill
void qt_pump_stats(void* h, int64_t* out) {
  QtPump* p = (QtPump*)h;
  out[0] = p->packets.load();
  out[1] = p->bad.load();
  out[2] = p->samples.load();
  out[3] = p->seq_errors.load();
  int64_t ov = 0, fill = INT64_MAX;
  for (QtRing* r : p->rings) {
    ov += qt_ring_overruns(r);
    int64_t s = qt_ring_size(r) / 2;
    if (s < fill) fill = s;
  }
  out[4] = ov;
  out[5] = p->rings.empty() ? 0 : fill;
  out[6] = qt_ring_size(p->mic);
}

// Copy the Hermes status plane: out[0..19] = C1..C4 of rows 0..4,
// out[20] = hardware PTT, out[21] = hardware CW key, out[22] = TX inhibit.
void qt_pump_hermes_status(void* h, uint8_t* out23) {
  QtPump* p = (QtPump*)h;
  memcpy(out23, p->h2pc, 20);
  out23[20] = p->hw_ptt.load(std::memory_order_relaxed);
  out23[21] = p->hw_cwkey.load(std::memory_order_relaxed);
  out23[22] = p->tx_inhibit.load(std::memory_order_relaxed);
}

int64_t qt_pump_overrange(void* h) {
  return ((QtPump*)h)->overrange.load(std::memory_order_relaxed);
}

// 1 and the 5 ACK bytes if a fresh ACK arrived since the last take.
int32_t qt_pump_take_ack(void* h, uint8_t* out5) {
  QtPump* p = (QtPump*)h;
  if (!p->ack_flag.exchange(0, std::memory_order_acquire)) return 0;
  memcpy(out5, p->ack, 5);
  return 1;
}

int64_t qt_pump_available(void* h) {
  QtPump* p = (QtPump*)h;
  int64_t fill = INT64_MAX;
  for (QtRing* r : p->rings) {
    int64_t s = qt_ring_size(r) / 2;
    if (s < fill) fill = s;
  }
  return p->rings.empty() ? 0 : fill;
}

// Pop n_floats interleaved I/Q floats from receiver rx's ring.
int64_t qt_pump_read(void* h, int32_t rx, float* out, int64_t n_floats) {
  QtPump* p = (QtPump*)h;
  if (rx < 0 || rx >= (int32_t)p->rings.size()) return -1;
  return qt_ring_pop(p->rings[rx], out, n_floats);
}

int64_t qt_pump_read_mic(void* h, float* out, int64_t n) {
  QtPump* p = (QtPump*)h;
  return qt_ring_pop(p->mic, out, n);
}

// --------------------------------------------------------------- blaster
// Localhost packet blaster for ingest benchmarking: emits valid HiQSDR
// payloads or Metis RX frames (n_rx sample groups) with running sequence
// numbers via batched sendmmsg, optionally paced to pace_pps packets/s.
// Content is a small I ramp — throughput, not signal, is under test.
// Returns packets sent.  (The test-fixture role of the reference's WAV
// replay senders, quisk.c:292-577, at benchmark rates.)

int64_t qt_blast_seq(const char* host, int32_t port, int32_t codec,
                     int32_t n_rx, int64_t n_packets, double pace_pps,
                     uint32_t seq0, uint32_t seq_step);

int64_t qt_blast(const char* host, int32_t port, int32_t codec, int32_t n_rx,
                 int64_t n_packets, double pace_pps) {
  return qt_blast_seq(host, port, codec, n_rx, n_packets, pace_pps, 0, 1);
}

// Striped-capable blaster: sequence numbers start at seq0 and advance by
// seq_step per packet (a striped sender runs one of these per socket).
int64_t qt_blast_seq(const char* host, int32_t port, int32_t codec,
                     int32_t n_rx, int64_t n_packets, double pace_pps,
                     uint32_t seq0, uint32_t seq_step) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  int snd = 1 << 24;
  setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &snd, sizeof snd);
  sockaddr_in a;
  memset(&a, 0, sizeof a);
  a.sin_family = AF_INET;
  a.sin_port = htons((uint16_t)port);
  a.sin_addr.s_addr = host && host[0] ? inet_addr(host)
                                      : htonl(INADDR_LOOPBACK);
  if (connect(fd, (sockaddr*)&a, sizeof a) != 0) {
    close(fd);
    return -1;
  }
  int len = codec == 0 ? 2 + 240 * 6 : (codec == 2 ? 8 + 6 * (int)QT_WB_PAIRS : 1032);
  std::vector<uint8_t> basev((size_t)(len > 2048 ? len : 2048), 0);
  uint8_t* base = basev.data();
  if (codec == 2) {
    std::vector<float> ri(QT_WB_PAIRS), rq(QT_WB_PAIRS);
    for (int64_t k = 0; k < QT_WB_PAIRS; ++k) {
      ri[k] = (float)(k & 1023) / 2048.0f;
      rq[k] = -ri[k];
    }
    qt_wideband_build(ri.data(), rq.data(), QT_WB_PAIRS, 0, base);
  } else if (codec == 0) {
    float ri[240], rq[240];
    for (int k = 0; k < 240; ++k) {
      ri[k] = (float)k / 512.0f;
      rq[k] = -ri[k];
    }
    qt_hiqsdr_build(ri, rq, 0, 0, base);
  } else {
    base[0] = 0xEF; base[1] = 0xFE; base[2] = 0x01; base[3] = 0x06;
    for (int sub = 0; sub < 2; ++sub) {
      uint8_t* f = base + 8 + sub * 512;
      f[0] = 0x7F; f[1] = 0x7F; f[2] = 0x7F;
      int group = n_rx * 6 + 2;
      int count = (512 - 8) / group;
      uint8_t* s = f + 8;
      for (int g = 0; g < count; ++g, s += group)
        for (int r = 0; r < n_rx; ++r) s[r * 6 + 2] = (uint8_t)g;  // I ramp
    }
  }
  const int BATCH = codec == 2 ? 16 : 64;
  const size_t stride = (size_t)(len > 2048 ? len : 2048);
  std::vector<uint8_t> bufs((size_t)BATCH * stride);
  mmsghdr msgs[64];
  iovec iov[64];
  for (int k = 0; k < BATCH; ++k) {
    memcpy(bufs.data() + (size_t)k * stride, base, len);
    iov[k].iov_base = bufs.data() + (size_t)k * stride;
    iov[k].iov_len = (size_t)len;
    memset(&msgs[k], 0, sizeof msgs[k]);
    msgs[k].msg_hdr.msg_iov = &iov[k];
    msgs[k].msg_hdr.msg_iovlen = 1;
  }
  int64_t sent = 0;
  uint32_t seq = seq0;
  if (!seq_step) seq_step = 1;
  timespec t0;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  while (sent < n_packets) {
    int want = (int)(n_packets - sent < BATCH ? n_packets - sent : BATCH);
    for (int k = 0; k < want; ++k, seq += seq_step) {
      uint8_t* pkt = bufs.data() + (size_t)k * stride;
      if (codec == 0) {
        pkt[0] = (uint8_t)seq;
      } else if (codec == 2) {
        pkt[2] = (uint8_t)(seq >> 24); pkt[3] = (uint8_t)(seq >> 16);
        pkt[4] = (uint8_t)(seq >> 8);  pkt[5] = (uint8_t)seq;
      } else {
        pkt[4] = (uint8_t)(seq >> 24); pkt[5] = (uint8_t)(seq >> 16);
        pkt[6] = (uint8_t)(seq >> 8);  pkt[7] = (uint8_t)seq;
      }
    }
    int n = sendmmsg(fd, msgs, want, 0);
    if (n < 0) {
      timespec ts = {0, 200000};  // transient ENOBUFS: back off 0.2 ms
      nanosleep(&ts, nullptr);
      continue;
    }
    sent += n;
    if (pace_pps > 0.0) {
      timespec now;
      clock_gettime(CLOCK_MONOTONIC, &now);
      double elapsed = (now.tv_sec - t0.tv_sec) +
                       1e-9 * (now.tv_nsec - t0.tv_nsec);
      double target = (double)sent / pace_pps;
      if (target > elapsed) {
        double dt = target - elapsed;
        timespec ts;
        ts.tv_sec = (time_t)dt;
        ts.tv_nsec = (long)((dt - (double)ts.tv_sec) * 1e9);
        nanosleep(&ts, nullptr);
      }
    }
  }
  close(fd);
  return sent;
}

}  // extern "C"
