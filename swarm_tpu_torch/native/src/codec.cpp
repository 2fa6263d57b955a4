// Native batch codec for the Quasar-Lite wire protocol (server runtime
// hot path). The Python struct codec tops out around the reference's
// design envelope; serving a swarm needs the datagram->column conversion
// off the interpreter. One pass over a concatenated datagram buffer
// classifies each payload by (magic, length) and writes column arrays
// that feed the jitted batched ingest directly.
//
// Layouts (all little-endian, packed — proto/packets.py:36-78):
//   v2     42 B  <4sBfffiIffffB   QSRL agent x y yaw enc v2v f l b r lm
//   v1     41 B  <4sBfffiIffff    (no landmark byte)
//   scan  751 B  <4sBfffiIH181f   enc/v2v + n_rays + 181 ranges
//   bridge 743 B <4sBfffH181f     no enc/v2v (esp32 PlatformIO firmware)
//
// Kinds: 0 = unrecognised, 1 = v1, 2 = v2, 3 = scan, 4 = scan-bridge.

#include <cstdint>
#include <cstring>

namespace {

inline float rd_f32(const uint8_t* p) {
    float v;
    std::memcpy(&v, p, 4);
    return v;
}

inline int32_t rd_i32(const uint8_t* p) {
    int32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint32_t rd_u32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

constexpr int kV1 = 41, kV2 = 42, kScan = 751, kBridge = 743;
constexpr int kRays = 181;

}  // namespace

extern "C" {

// Returns 1 iff this build runs on a little-endian host (the wire
// format is LE; the Python wrapper refuses the fast path otherwise).
int codec_is_little_endian() {
    const uint16_t probe = 1;
    uint8_t b;
    std::memcpy(&b, &probe, 1);
    return b == 1;
}

// buf: concatenated datagrams; off/len: [n] byte offsets/lengths.
// Outputs are [n] (scans [n*181], dist4 [n*4]); rows for unrecognised
// payloads are zeroed with kind 0. Returns the number of recognised
// telemetry payloads.
int parse_telemetry_batch(const uint8_t* buf, const int32_t* off,
                          const int32_t* len, int n, int32_t* kind,
                          int32_t* agent, float* x, float* y, float* yaw,
                          int32_t* encoder, int32_t* v2v, float* dist4,
                          int32_t* landmark, float* scans) {
    int good = 0;
    for (int i = 0; i < n; ++i) {
        const uint8_t* p = buf + off[i];
        const int L = len[i];
        kind[i] = 0;
        agent[i] = 0;
        x[i] = y[i] = yaw[i] = 0.0f;
        encoder[i] = 0;
        v2v[i] = 0;
        landmark[i] = 0;
        std::memset(dist4 + 4 * i, 0, 4 * sizeof(float));
        std::memset(scans + kRays * i, 0, kRays * sizeof(float));
        if (L < 12 || std::memcmp(p, "QSRL", 4) != 0) continue;

        if (L == kV2 || L == kV1) {
            agent[i] = p[4];
            x[i] = rd_f32(p + 5);
            y[i] = rd_f32(p + 9);
            yaw[i] = rd_f32(p + 13);
            encoder[i] = rd_i32(p + 17);
            v2v[i] = static_cast<int32_t>(rd_u32(p + 21));
            for (int k = 0; k < 4; ++k)
                dist4[4 * i + k] = rd_f32(p + 25 + 4 * k);
            if (L == kV2) {
                landmark[i] = p[41];
                kind[i] = 2;
            } else {
                kind[i] = 1;
            }
            ++good;
        } else if (L == kScan) {
            agent[i] = p[4];
            x[i] = rd_f32(p + 5);
            y[i] = rd_f32(p + 9);
            yaw[i] = rd_f32(p + 13);
            encoder[i] = rd_i32(p + 17);
            v2v[i] = static_cast<int32_t>(rd_u32(p + 21));
            std::memcpy(scans + kRays * i, p + 27, kRays * sizeof(float));
            kind[i] = 3;
            ++good;
        } else if (L == kBridge) {
            agent[i] = p[4];
            x[i] = rd_f32(p + 5);
            y[i] = rd_f32(p + 9);
            yaw[i] = rd_f32(p + 13);
            std::memcpy(scans + kRays * i, p + 19, kRays * sizeof(float));
            kind[i] = 4;
            ++good;
        }
    }
    return good;
}

}  // extern "C"

#include <sys/socket.h>
#include <netinet/in.h>
#include <cerrno>
#include <unistd.h>

extern "C" {

// Drain a non-blocking UDP socket with recvmmsg(2): one syscall per
// <=256 datagrams instead of one recvfrom per datagram (the Python
// recv loop bounded the throughput serving mode at ~40k pkt/s).
// buf is [max_msgs, stride] row-major; lens/ip4/port are [max_msgs].
// Returns the number of datagrams read (0 on EAGAIN-empty).
int drain_udp(int fd, uint8_t* buf, int stride, int max_msgs,
              int32_t* lens, uint32_t* ip4, int32_t* port) {
    constexpr int kBatch = 256;
    mmsghdr hdrs[kBatch];
    iovec iovs[kBatch];
    sockaddr_in addrs[kBatch];
    int total = 0;
    while (total < max_msgs) {
        const int want = max_msgs - total < kBatch ? max_msgs - total
                                                   : kBatch;
        for (int i = 0; i < want; ++i) {
            iovs[i].iov_base = buf + (total + i) * stride;
            iovs[i].iov_len = stride;
            std::memset(&hdrs[i], 0, sizeof(mmsghdr));
            hdrs[i].msg_hdr.msg_iov = &iovs[i];
            hdrs[i].msg_hdr.msg_iovlen = 1;
            hdrs[i].msg_hdr.msg_name = &addrs[i];
            hdrs[i].msg_hdr.msg_namelen = sizeof(sockaddr_in);
        }
        const int got = recvmmsg(fd, hdrs, want, MSG_DONTWAIT, nullptr);
        if (got <= 0) break;
        for (int i = 0; i < got; ++i) {
            lens[total + i] = static_cast<int32_t>(hdrs[i].msg_len);
            ip4[total + i] = ntohl(addrs[i].sin_addr.s_addr);
            port[total + i] = ntohs(addrs[i].sin_port);
        }
        total += got;
        if (got < want) break;
    }
    return total;
}

// Paced sendmmsg blaster for the serving benchmark
// (swarm_tpu_torch/bench_serve.py): cycles a pre-packed packet ring
// ([n_ring, pkt_len] row-major) into 127.0.0.1:port in `burst`-packet
// batches, sleeping sleep_us between batches, until *stop != 0. Returns
// packets handed to the kernel (UDP may still drop at the receiver's
// rcvbuf — the benchmark reports applied vs sent separately).
// Rationale: the Python sendto loop costs ~5-10 us/packet of interpreter
// time; on a single-core benchmark host
// that halves the CPU left for the server under test, so the
// measurement reflected the harness, not the server. sendmmsg is
// ~1 us/packet and the sleep yields the core between bursts.
long long blast_udp(int port, const uint8_t* ring, int pkt_len,
                    int n_ring, const volatile int32_t* stop,
                    int burst, int sleep_us) {
    constexpr int kMax = 256;
    if (burst < 1) burst = 1;
    if (burst > kMax) burst = kMax;
    const int fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (fd < 0) return -1;
    sockaddr_in addr;
    std::memset(&addr, 0, sizeof(addr));
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    if (connect(fd, reinterpret_cast<const sockaddr*>(&addr),
                sizeof(addr)) != 0) {
        close(fd);
        return -1;
    }
    mmsghdr hdrs[kMax];
    iovec iovs[kMax];
    long long sent = 0;
    long long i = 0;
    while (!*stop) {
        for (int k = 0; k < burst; ++k) {
            iovs[k].iov_base = const_cast<uint8_t*>(
                ring + (i % n_ring) * pkt_len);
            iovs[k].iov_len = static_cast<size_t>(pkt_len);
            std::memset(&hdrs[k], 0, sizeof(mmsghdr));
            hdrs[k].msg_hdr.msg_iov = &iovs[k];
            hdrs[k].msg_hdr.msg_iovlen = 1;
            ++i;
        }
        const int got = sendmmsg(fd, hdrs, burst, 0);
        if (got < 0) {
            // ECONNREFUSED: ICMP from a not-yet/no-longer bound port;
            // ENOBUFS/EAGAIN: transient kernel queue pressure. Yield
            // and retry until the stop flag ends the run.
            if (errno == ECONNREFUSED || errno == ENOBUFS ||
                errno == EAGAIN || errno == EINTR) {
                usleep(1000);
                continue;
            }
            break;
        }
        sent += got;
        // partial send: rewind the ring index so the unsent tail goes
        // out first on the next burst (the function is documented as
        // cycling the ring; skipping would bias the agent mix)
        if (got < burst) i -= (burst - got);
        if (sleep_us > 0) usleep(static_cast<useconds_t>(sleep_us));
    }
    close(fd);
    return sent;
}

}  // extern "C"
