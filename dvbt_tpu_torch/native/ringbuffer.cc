// Native host runtime for the streaming path (SURVEY.md layer map: the
// reference delegates buffering and stream alignment to the GNU Radio C++
// runtime — lock-free single-writer circular buffers between blocks and the
// sync-byte search in convolutional_deinterleaver / energy_descramble
// [unverified — mount empty]).  This is the TPU framework's equivalent:
// a contiguous-read ring buffer feeding device-sized super-blocks, and an
// MPEG-TS framer that re-aligns 188-byte packets in arbitrary byte streams.
//
// Built with plain g++ (no pybind11 in the image); bound via ctypes.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC ring buffer with contiguous reads.
//
// Capacity is rounded to a power of two; a shadow region of `max_read`
// bytes is maintained past the end so a reader can always map `max_read`
// contiguous bytes (the classic "magic buffer" without mmap tricks: writes
// into the first `max_read` bytes are mirrored into the shadow).
// ---------------------------------------------------------------------------

struct Ring {
    uint8_t*  data;
    uint64_t  cap;        // power of two
    uint64_t  max_read;   // shadow size
    std::atomic<uint64_t> wpos;  // absolute write position (bytes)
    std::atomic<uint64_t> rpos;  // absolute read position (bytes)
};

Ring* ring_create(uint64_t capacity, uint64_t max_read) {
    uint64_t cap = 1;
    while (cap < capacity) cap <<= 1;
    if (max_read > cap) return nullptr;
    Ring* r = new (std::nothrow) Ring;
    if (!r) return nullptr;
    r->data = new (std::nothrow) uint8_t[cap + max_read];
    if (!r->data) { delete r; return nullptr; }
    r->cap = cap;
    r->max_read = max_read;
    r->wpos.store(0);
    r->rpos.store(0);
    return r;
}

void ring_destroy(Ring* r) {
    if (!r) return;
    delete[] r->data;
    delete r;
}

uint64_t ring_readable(const Ring* r) {
    return r->wpos.load(std::memory_order_acquire)
         - r->rpos.load(std::memory_order_acquire);
}

uint64_t ring_writable(const Ring* r) {
    return r->cap - ring_readable(r);
}

// Copy n bytes in; returns bytes accepted (may be < n when full).
uint64_t ring_write(Ring* r, const uint8_t* src, uint64_t n) {
    uint64_t w = r->wpos.load(std::memory_order_relaxed);
    uint64_t avail = r->cap - (w - r->rpos.load(std::memory_order_acquire));
    if (n > avail) n = avail;
    uint64_t off = w & (r->cap - 1);
    uint64_t first = n < (r->cap - off) ? n : (r->cap - off);
    std::memcpy(r->data + off, src, first);
    if (n > first) std::memcpy(r->data, src + first, n - first);
    // mirror the head into the shadow region for contiguous reads
    uint64_t mirror_from = off < r->max_read ? off : 0;
    if (off < r->max_read) {
        uint64_t m = first < (r->max_read - off) ? first : (r->max_read - off);
        std::memcpy(r->data + r->cap + off, r->data + off, m);
    }
    if (n > first && r->max_read > 0) {
        uint64_t m = (n - first) < r->max_read ? (n - first) : r->max_read;
        std::memcpy(r->data + r->cap, r->data, m);
    }
    (void)mirror_from;
    r->wpos.store(w + n, std::memory_order_release);
    return n;
}

// Pointer to n contiguous readable bytes (no copy), or null if unavailable.
const uint8_t* ring_peek(Ring* r, uint64_t n) {
    if (n > r->max_read || ring_readable(r) < n) return nullptr;
    return r->data + (r->rpos.load(std::memory_order_relaxed) & (r->cap - 1));
}

void ring_consume(Ring* r, uint64_t n) {
    r->rpos.fetch_add(n, std::memory_order_release);
}

// Copy-out read (for consumers that want their own buffer).
uint64_t ring_read(Ring* r, uint8_t* dst, uint64_t n) {
    uint64_t have = ring_readable(r);
    if (n > have) n = have;
    uint64_t rp = r->rpos.load(std::memory_order_relaxed);
    uint64_t off = rp & (r->cap - 1);
    uint64_t first = n < (r->cap - off) ? n : (r->cap - off);
    std::memcpy(dst, r->data + off, first);
    if (n > first) std::memcpy(dst + first, r->data, n - first);
    r->rpos.store(rp + n, std::memory_order_release);
    return n;
}

// ---------------------------------------------------------------------------
// MPEG-TS framer: find 188-byte packet alignment in a byte stream (sync
// 0x47, or 0xB8 for the dispersal-inverted packet) and emit whole packets.
// Mirrors the sync-search behavior of the reference's
// convolutional_deinterleaver / energy_descramble (SURVEY.md R8/R10).
// ---------------------------------------------------------------------------

// Scan `buf[0..n)` for the first offset where `confirm` consecutive packet
// slots all start with 0x47/0xB8.  Returns offset, or -1 if none.
int64_t ts_find_sync(const uint8_t* buf, uint64_t n, int confirm) {
    const uint64_t P = 188;
    if (n < P * (uint64_t)confirm) return -1;
    for (uint64_t off = 0; off + P * confirm <= n; ++off) {
        bool ok = true;
        for (int k = 0; k < confirm; ++k) {
            uint8_t b = buf[off + (uint64_t)k * P];
            if (b != 0x47 && b != 0xB8) { ok = false; break; }
        }
        if (ok) return (int64_t)off;
    }
    return -1;
}

// Validate packet grid: fraction (in 1/1000) of aligned sync bytes.
int32_t ts_sync_quality(const uint8_t* buf, uint64_t n) {
    const uint64_t P = 188;
    uint64_t total = n / P, good = 0;
    if (total == 0) return 0;
    for (uint64_t i = 0; i < total; ++i) {
        uint8_t b = buf[i * P];
        if (b == 0x47 || b == 0xB8) ++good;
    }
    return (int32_t)(good * 1000 / total);
}

}  // extern "C"
