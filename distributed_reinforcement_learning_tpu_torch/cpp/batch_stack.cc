// Batched trajectory assembly for the learner's ingest hot path.
//
// The native queue's batch pop (`rq_get_batch`, ring_queue.cc) lands N
// codec blobs in ONE contiguous buffer at a fixed stride. All blobs in a
// queue share one schema (fixed unroll shapes — the same invariant the
// reference's fixed-shape queue placeholders encode at
// `distributed_queue/buffer_queue.py:40-50`), so batch assembly is a
// pure gather: for each field, copy its bytes out of every blob into a
// [N, ...] batch-major array. Doing the N*L copies here instead of
// Python (N frombuffer views + L np.stack calls per batch, plus N JSON
// header parses) keeps the single learner host core off the critical
// path — SURVEY §7 hard part (a).
//
// Plain C ABI for ctypes (pybind11 is not in the image).

#include <cstdint>
#include <cstring>

extern "C" {

// 1 iff every blob's first `prefix_len` bytes equal blob 0's. The codec
// header (magic + length + JSON) fully determines the layout, so equal
// prefixes mean the Python caller may parse ONE header for the batch.
int64_t bs_all_equal_prefix(const uint8_t* base, int64_t stride, int64_t n,
                            int64_t prefix_len) {
  for (int64_t i = 1; i < n; ++i) {
    if (std::memcmp(base, base + i * stride, prefix_len) != 0) return 0;
  }
  return 1;
}

// Gather one field: dst[i] = blob_i[src_offset : src_offset + nbytes].
void bs_gather(const uint8_t* base, int64_t stride, int64_t n,
               int64_t src_offset, int64_t nbytes, uint8_t* dst) {
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(dst + i * nbytes, base + i * stride + src_offset, nbytes);
  }
}

}  // extern "C"
