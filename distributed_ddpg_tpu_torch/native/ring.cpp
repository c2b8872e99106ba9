// SPSC shared-memory transition ring of the port's actor -> learner
// transport (actors/pool.py, transport "shm").
//
// A copy of the ring_* functions of distributed_ddpg_tpu/native/
// replay_core.cpp (the sum tree is not used by the port yet). One ring per
// rollout worker: the worker process is the only producer, the learner
// process the only consumer, so monotonic head and tail counters with
// acquire/release ordering need no lock. Rows are fixed-width f32
// transitions copied in place, with no pickling.
//
// Python owns the shared block and passes its address; nothing here
// allocates or frees. Layout:
//   [0,   64): int64 head, rows ever pushed (written by the producer)
//   [64, 128): int64 tail, rows ever popped (written by the consumer)
//   [128, ..): f32 data[capacity][width], slot = counter % capacity

#include <atomic>
#include <cstdint>
#include <cstring>

namespace {

struct RingHeader {
    alignas(64) std::atomic<int64_t> head;
    alignas(64) std::atomic<int64_t> tail;
};
static_assert(sizeof(RingHeader) == 128, "header must match Python offset");

inline RingHeader* hdr(void* shm) { return static_cast<RingHeader*>(shm); }

inline float* data(void* shm) {
    return reinterpret_cast<float*>(static_cast<char*>(shm) + 128);
}

// Rows [counter, counter+n) occupy slots counter % capacity onward,
// split at the wrap.
inline void rows_in(float* ring, int64_t capacity, int64_t width,
                    int64_t counter, const float* src, int64_t n) {
    int64_t slot = counter % capacity;
    int64_t first = n < capacity - slot ? n : capacity - slot;
    std::memcpy(ring + slot * width, src, first * width * sizeof(float));
    if (n > first)
        std::memcpy(ring, src + first * width,
                    (n - first) * width * sizeof(float));
}

inline void rows_out(const float* ring, int64_t capacity, int64_t width,
                     int64_t counter, float* dst, int64_t n) {
    int64_t slot = counter % capacity;
    int64_t first = n < capacity - slot ? n : capacity - slot;
    std::memcpy(dst, ring + slot * width, first * width * sizeof(float));
    if (n > first)
        std::memcpy(dst + first * width, ring,
                    (n - first) * width * sizeof(float));
}

}  // namespace

extern "C" {

void ring_init(void* shm) {
    hdr(shm)->head.store(0, std::memory_order_relaxed);
    hdr(shm)->tail.store(0, std::memory_order_relaxed);
}

// Producer: append up to n rows; returns rows accepted (fewer than n when
// the ring is near full: the caller keeps the rest).
int64_t ring_push(void* shm, int64_t capacity, int64_t width,
                  const float* rows, int64_t n) {
    RingHeader* h = hdr(shm);
    int64_t head = h->head.load(std::memory_order_relaxed);
    int64_t tail = h->tail.load(std::memory_order_acquire);
    int64_t free_rows = capacity - (head - tail);
    int64_t take = n < free_rows ? n : free_rows;
    if (take <= 0) return 0;
    rows_in(data(shm), capacity, width, head, rows, take);
    h->head.store(head + take, std::memory_order_release);
    return take;
}

// Consumer: pop up to max_rows rows into out; returns rows popped.
int64_t ring_pop(void* shm, int64_t capacity, int64_t width, float* out,
                 int64_t max_rows) {
    RingHeader* h = hdr(shm);
    int64_t tail = h->tail.load(std::memory_order_relaxed);
    int64_t head = h->head.load(std::memory_order_acquire);
    int64_t avail = head - tail;
    int64_t take = avail < max_rows ? avail : max_rows;
    if (take <= 0) return 0;
    rows_out(data(shm), capacity, width, tail, out, take);
    h->tail.store(tail + take, std::memory_order_release);
    return take;
}

int64_t ring_size(void* shm) {
    RingHeader* h = hdr(shm);
    return h->head.load(std::memory_order_acquire) -
           h->tail.load(std::memory_order_acquire);
}

}  // extern "C"
