// Copy of qradiolink_tpu/native/qrl_native.cpp (the JAX package's host-IO
// engine), so that the port builds it from its own tree. Loaded by
// qradiolink_tpu_torch/io/native.py. Change it with its original: the
// port's IQ formats are held to the JAX package's byte for byte.
//
// Native host-IO engine for qradiolink_tpu.
//
// The reference's runtime around the DSP is C++ (GNU Radio's
// thread-per-block scheduler with ring buffers, custom sink/source
// blocks guarding std::vector queues with mutexes, and VOLK-vectorized
// sample format conversion). The TPU build replaces the *scheduler*
// with XLA whole-chain fusion, but the HOST boundary — sample-format
// conversion at the IQ ingest/egress and the producer/consumer ring
// between network threads and the compute loop — remains native here:
//
//   * cs16/cu8 <-> interleaved f32 conversions (auto-vectorized tight
//     loops, the VOLK role at the IQ boundary)
//   * a lock-free single-producer/single-consumer byte ring buffer
//     (acquire/release atomics, power-of-two capacity) — the
//     gr_buffer equivalent for the UDP-reader -> compute-loop handoff
//   * a background UDP receiver thread pumping datagrams into a ring
//     (the gr_audio_source/udp source thread role)
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (qradiolink_tpu_torch/io/native.py); built on demand with g++ -O3.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------- convert
void qrl_cs16_to_f32(const int16_t* in, float* out, int64_t n) {
    const float k = 1.0f / 32767.0f;
    for (int64_t i = 0; i < n; i++) out[i] = (float)in[i] * k;
}

void qrl_f32_to_cs16(const float* in, int16_t* out, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        float v = in[i] * 32767.0f;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32767.0f) v = -32767.0f;
        out[i] = (int16_t)(v >= 0.0f ? v + 0.5f : v - 0.5f);
    }
}

void qrl_cu8_to_f32(const uint8_t* in, float* out, int64_t n) {
    const float k = 1.0f / 127.5f;
    for (int64_t i = 0; i < n; i++) out[i] = ((float)in[i] - 127.5f) * k;
}

void qrl_f32_to_cu8(const float* in, uint8_t* out, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        float v = in[i] * 127.5f + 127.5f;
        if (v > 255.0f) v = 255.0f;
        if (v < 0.0f) v = 0.0f;
        out[i] = (uint8_t)(v + 0.5f);
    }
}

// ------------------------------------------------------------- ring buffer
struct QrlRing {
    uint8_t* data;
    uint64_t capacity;      // power of two
    uint64_t mask;
    std::atomic<uint64_t> head;  // write position (producer)
    std::atomic<uint64_t> tail;  // read position (consumer)
};

QrlRing* qrl_ring_create(uint64_t capacity_pow2) {
    uint64_t cap = 1;
    while (cap < capacity_pow2) cap <<= 1;
    QrlRing* r = new QrlRing();
    r->data = (uint8_t*)malloc(cap);
    r->capacity = cap;
    r->mask = cap - 1;
    r->head.store(0);
    r->tail.store(0);
    return r;
}

void qrl_ring_destroy(QrlRing* r) {
    if (!r) return;
    free(r->data);
    delete r;
}

uint64_t qrl_ring_readable(QrlRing* r) {
    return r->head.load(std::memory_order_acquire)
         - r->tail.load(std::memory_order_acquire);
}

uint64_t qrl_ring_writable(QrlRing* r) {
    return r->capacity - qrl_ring_readable(r);
}

// returns bytes written (0 when full)
uint64_t qrl_ring_write(QrlRing* r, const uint8_t* src, uint64_t n) {
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t free_b = r->capacity
        - (head - r->tail.load(std::memory_order_acquire));
    if (n > free_b) n = free_b;
    for (uint64_t i = 0; i < n; i++)
        r->data[(head + i) & r->mask] = src[i];
    r->head.store(head + n, std::memory_order_release);
    return n;
}

// returns bytes read
uint64_t qrl_ring_read(QrlRing* r, uint8_t* dst, uint64_t n) {
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    uint64_t avail = r->head.load(std::memory_order_acquire) - tail;
    if (n > avail) n = avail;
    for (uint64_t i = 0; i < n; i++)
        dst[i] = r->data[(tail + i) & r->mask];
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

// --------------------------------------------------------- UDP rx thread
struct QrlUdpRx {
    int fd;
    QrlRing* ring;
    std::thread* th;
    std::atomic<bool> stop;
    std::atomic<uint64_t> datagrams;
    std::atomic<uint64_t> dropped;
};

static void qrl_udp_loop(QrlUdpRx* u) {
    uint8_t buf[65536];
    while (!u->stop.load(std::memory_order_relaxed)) {
        ssize_t n = recv(u->fd, buf, sizeof(buf), 0);
        if (n <= 0) continue;   // timeout / transient
        uint64_t w = qrl_ring_write(u->ring, buf, (uint64_t)n);
        u->datagrams.fetch_add(1, std::memory_order_relaxed);
        if (w < (uint64_t)n)
            u->dropped.fetch_add(1, std::memory_order_relaxed);
    }
}

// binds host:port, pumps datagrams into ring; returns NULL on failure.
QrlUdpRx* qrl_udp_rx_start(const char* host, int port, QrlRing* ring,
                           int* bound_port) {
    int fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (fd < 0) return nullptr;
    struct timeval tv {0, 100000};  // 100 ms recv timeout for stop polls
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    sockaddr_in addr {};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    inet_pton(AF_INET, host, &addr.sin_addr);
    if (bind(fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
        close(fd);
        return nullptr;
    }
    if (bound_port) {
        sockaddr_in got {};
        socklen_t len = sizeof(got);
        getsockname(fd, (sockaddr*)&got, &len);
        *bound_port = ntohs(got.sin_port);
    }
    QrlUdpRx* u = new QrlUdpRx();
    u->fd = fd;
    u->ring = ring;
    u->stop.store(false);
    u->datagrams.store(0);
    u->dropped.store(0);
    u->th = new std::thread(qrl_udp_loop, u);
    return u;
}

uint64_t qrl_udp_rx_datagrams(QrlUdpRx* u) { return u->datagrams.load(); }
uint64_t qrl_udp_rx_dropped(QrlUdpRx* u) { return u->dropped.load(); }

void qrl_udp_rx_stop(QrlUdpRx* u) {
    if (!u) return;
    u->stop.store(true);
    u->th->join();
    delete u->th;
    close(u->fd);
    delete u;
}

// --------------------------------------------------------- UDP tx thread
// Paced egress: drains the ring in fixed-size datagrams at a fixed
// nanosecond cadence — the reference's timed sample sink / UDP audio
// out role (udpclient.cpp; limesdr sink burst pacing), GIL-free.
struct QrlUdpTx {
    int fd;
    QrlRing* ring;
    std::thread* th;
    std::atomic<bool> stop;
    std::atomic<uint64_t> datagrams;
    std::atomic<uint64_t> starved;   // pacing ticks with no full chunk
    uint64_t chunk;
    uint64_t ns_per_chunk;
};

static void qrl_udp_tx_loop(QrlUdpTx* u) {
    uint8_t buf[65536];
    struct timespec next;
    clock_gettime(CLOCK_MONOTONIC, &next);
    while (!u->stop.load(std::memory_order_relaxed)) {
        next.tv_nsec += (long)u->ns_per_chunk;
        while (next.tv_nsec >= 1000000000L) {
            next.tv_nsec -= 1000000000L;
            next.tv_sec += 1;
        }
        if (qrl_ring_readable(u->ring) >= u->chunk) {
            uint64_t n = qrl_ring_read(u->ring, buf, u->chunk);
            (void)send(u->fd, buf, n, 0);
            u->datagrams.fetch_add(1, std::memory_order_relaxed);
        } else {
            u->starved.fetch_add(1, std::memory_order_relaxed);
        }
        clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &next, nullptr);
    }
}

// connects to host:port and paces chunk-sized datagrams from the ring
// every ns_per_chunk nanoseconds; returns NULL on failure.
QrlUdpTx* qrl_udp_tx_start(const char* host, int port, QrlRing* ring,
                           uint64_t chunk_bytes, uint64_t ns_per_chunk) {
    if (chunk_bytes == 0 || chunk_bytes > 65536) return nullptr;
    int fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (fd < 0) return nullptr;
    sockaddr_in addr {};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    inet_pton(AF_INET, host, &addr.sin_addr);
    if (connect(fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
        close(fd);
        return nullptr;
    }
    QrlUdpTx* u = new QrlUdpTx();
    u->fd = fd;
    u->ring = ring;
    u->stop.store(false);
    u->datagrams.store(0);
    u->starved.store(0);
    u->chunk = chunk_bytes;
    u->ns_per_chunk = ns_per_chunk;
    u->th = new std::thread(qrl_udp_tx_loop, u);
    return u;
}

uint64_t qrl_udp_tx_datagrams(QrlUdpTx* u) { return u->datagrams.load(); }
uint64_t qrl_udp_tx_starved(QrlUdpTx* u) { return u->starved.load(); }

void qrl_udp_tx_stop(QrlUdpTx* u) {
    if (!u) return;
    u->stop.store(true);
    u->th->join();
    delete u->th;
    close(u->fd);
    delete u;
}

}  // extern "C"
