// Bounded MPMC byte-blob queue with condition-variable backpressure.
//
// TPU-native replacement for the C++ tf.FIFOQueue kernel the reference
// leans on (reference distributed_queue/buffer_queue.py:28-36,153-160,
// 368-378 places a shared_name FIFOQueue on the learner; its blocking
// enqueue is the actors' backpressure). Items are opaque byte blobs —
// the Python side owns serialization (data/codec.py) so one memcpy moves
// a whole trajectory. Blocking put when full, blocking get when empty,
// batch get into a caller-provided strided buffer so a 32-item batch is
// one FFI call instead of the reference's 32 sequential RPC round-trips
// (buffer_queue.py:416-435).
//
// Exposed as a C ABI for ctypes; no Python.h dependency. All calls
// release the GIL naturally (ctypes releases it around foreign calls),
// so producers and the learner thread overlap.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>

namespace {

struct RingQueue {
  explicit RingQueue(size_t cap) : capacity(cap), closed(false) {}
  size_t capacity;
  bool closed;
  std::deque<std::string> items;
  std::mutex mu;
  std::condition_variable not_full;
  std::condition_variable not_empty;
};

bool wait_until(std::condition_variable& cv, std::unique_lock<std::mutex>& lk,
                double timeout_s, bool (*pred)(RingQueue*), RingQueue* q) {
  if (timeout_s < 0) {
    cv.wait(lk, [&] { return pred(q); });
    return true;
  }
  return cv.wait_for(lk, std::chrono::duration<double>(timeout_s),
                     [&] { return pred(q); });
}

}  // namespace

extern "C" {

// Status codes shared with the Python wrapper (data/native.py).
enum { RQ_OK = 0, RQ_TIMEOUT = -1, RQ_CLOSED = -2, RQ_TOO_SMALL = -3 };

void* rq_create(int64_t capacity) {
  if (capacity <= 0) return nullptr;
  return new RingQueue(static_cast<size_t>(capacity));
}

void rq_destroy(void* h) { delete static_cast<RingQueue*>(h); }

int64_t rq_size(void* h) {
  auto* q = static_cast<RingQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  return static_cast<int64_t>(q->items.size());
}

void rq_close(void* h) {
  auto* q = static_cast<RingQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->not_full.notify_all();
  q->not_empty.notify_all();
}

// Blocks while full (backpressure). timeout_s < 0 means wait forever.
int64_t rq_put(void* h, const uint8_t* data, int64_t len, double timeout_s) {
  auto* q = static_cast<RingQueue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  bool ready = wait_until(
      q->not_full, lk, timeout_s,
      [](RingQueue* qq) { return qq->items.size() < qq->capacity || qq->closed; },
      q);
  if (!ready) return RQ_TIMEOUT;
  if (q->closed) return RQ_CLOSED;
  q->items.emplace_back(reinterpret_cast<const char*>(data),
                        static_cast<size_t>(len));
  q->not_empty.notify_one();
  return RQ_OK;
}

// Next item's size without consuming it; RQ_TIMEOUT / RQ_CLOSED on failure.
int64_t rq_peek_size(void* h, double timeout_s) {
  auto* q = static_cast<RingQueue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  bool ready = wait_until(
      q->not_empty, lk, timeout_s,
      [](RingQueue* qq) { return !qq->items.empty() || qq->closed; }, q);
  if (!ready) return RQ_TIMEOUT;
  if (q->items.empty()) return RQ_CLOSED;  // closed and drained
  return static_cast<int64_t>(q->items.front().size());
}

// Pop one item into `out` (capacity `out_cap`); returns bytes written.
int64_t rq_get(void* h, uint8_t* out, int64_t out_cap, double timeout_s) {
  auto* q = static_cast<RingQueue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  bool ready = wait_until(
      q->not_empty, lk, timeout_s,
      [](RingQueue* qq) { return !qq->items.empty() || qq->closed; }, q);
  if (!ready) return RQ_TIMEOUT;
  if (q->items.empty()) return RQ_CLOSED;
  std::string& item = q->items.front();
  if (static_cast<int64_t>(item.size()) > out_cap) return RQ_TOO_SMALL;
  std::memcpy(out, item.data(), item.size());
  int64_t n = static_cast<int64_t>(item.size());
  q->items.pop_front();
  q->not_full.notify_one();
  return n;
}

// Pop exactly `n` items, item i written at out + i*stride, its length in
// lens[i]. All-or-nothing: on timeout nothing is consumed (items already
// popped under the lock are pushed back in order). One FFI call per batch.
int64_t rq_get_batch(void* h, int64_t n, uint8_t* out, int64_t stride,
                     int64_t* lens, double timeout_s) {
  auto* q = static_cast<RingQueue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                      std::chrono::duration<double>(timeout_s < 0 ? 3e8 : timeout_s));
  for (int64_t i = 0; i < n; ++i) {
    bool ready = q->not_empty.wait_until(lk, deadline, [&] {
      return !q->items.empty() || q->closed;
    });
    if (!ready || q->items.empty()) {
      // Roll back: restore consumed items to the front, oldest first.
      for (int64_t j = i - 1; j >= 0; --j)
        q->items.emplace_front(reinterpret_cast<char*>(out + j * stride),
                               static_cast<size_t>(lens[j]));
      if (i > 0) q->not_empty.notify_all();
      return !ready ? RQ_TIMEOUT : RQ_CLOSED;
    }
    std::string& item = q->items.front();
    if (static_cast<int64_t>(item.size()) > stride) {
      for (int64_t j = i - 1; j >= 0; --j)
        q->items.emplace_front(reinterpret_cast<char*>(out + j * stride),
                               static_cast<size_t>(lens[j]));
      if (i > 0) q->not_empty.notify_all();
      return RQ_TOO_SMALL;
    }
    std::memcpy(out + i * stride, item.data(), item.size());
    lens[i] = static_cast<int64_t>(item.size());
    q->items.pop_front();
    q->not_full.notify_one();
  }
  return RQ_OK;
}

}  // extern "C"
