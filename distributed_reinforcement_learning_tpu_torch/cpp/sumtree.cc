// Array-backed binary sum tree with batch add / sample / update.
//
// Native replacement for the reference's pure-Python SumTree
// (distributed_queue/buffer_queue.py:256-301), the learner-host hotspot
// called per transition at train_apex.py:114-122 (SURVEY §2.2 E7). The
// priority math (propagate-to-root on set, subtractive descent on get)
// is identical; the wins are batch entry points (one FFI call per batch,
// O(n log C) in C++) and an internal mutex so the Ape-X learner's
// ingest and train phases can run from different threads.
//
// Payloads stay in Python — the tree stores only priorities; `add`
// returns the leaf slot (= write cursor) so the Python side keeps its
// data list aligned.
//
// The PyTorch port's copy adds `st_export` / `st_import`: the whole tree
// (inner sums included), the write cursor and the count, so that a
// checkpoint restores a tree that samples bit for bit as the saved one.

#include <cstdint>
#include <mutex>
#include <vector>

namespace {

struct SumTree {
  explicit SumTree(size_t cap)
      : capacity(cap), tree(2 * cap - 1, 0.0), write(0), count(0) {}
  size_t capacity;
  std::vector<double> tree;  // tree[0] = root total; leaves at [cap-1, 2cap-1)
  size_t write;
  size_t count;
  std::mutex mu;

  void set_priority(size_t idx, double priority) {
    double delta = priority - tree[idx];
    while (true) {
      tree[idx] += delta;
      if (idx == 0) break;
      idx = (idx - 1) / 2;
    }
  }

  // Leaf index whose cumulative-priority interval contains `value`.
  size_t retrieve(double value) const {
    size_t idx = 0;
    while (true) {
      size_t left = 2 * idx + 1;
      if (left >= tree.size()) break;
      if (value <= tree[left]) {
        idx = left;
      } else {
        value -= tree[left];
        idx = left + 1;
      }
    }
    return idx;
  }
};

}  // namespace

extern "C" {

void* st_create(int64_t capacity) {
  if (capacity <= 0) return nullptr;
  return new SumTree(static_cast<size_t>(capacity));
}

void st_destroy(void* h) { delete static_cast<SumTree*>(h); }

double st_total(void* h) {
  auto* t = static_cast<SumTree*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  return t->tree[0];
}

int64_t st_size(void* h) {
  auto* t = static_cast<SumTree*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  return static_cast<int64_t>(t->count);
}

double st_leaf_priority(void* h, int64_t tree_idx) {
  auto* t = static_cast<SumTree*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  return t->tree[static_cast<size_t>(tree_idx)];
}

// Copy the leaf priorities of slots [start, start+n) in one call — the
// checkpoint-snapshot read path (one FFI call for the whole ring instead
// of count individual st_leaf_priority calls under the Python lock).
void st_leaf_priorities(void* h, int64_t start, int64_t n, double* out) {
  auto* t = static_cast<SumTree*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  for (int64_t i = 0; i < n; ++i)
    out[i] = t->tree[static_cast<size_t>(start + i) + t->capacity - 1];
}

// Append n priorities at the ring-write cursor; out_data_idx[i] receives
// the leaf slot each landed in (tree idx = slot + capacity - 1).
void st_add_batch(void* h, const double* priorities, int64_t n,
                  int64_t* out_data_idx) {
  auto* t = static_cast<SumTree*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  for (int64_t i = 0; i < n; ++i) {
    size_t slot = t->write;
    t->set_priority(slot + t->capacity - 1, priorities[i]);
    out_data_idx[i] = static_cast<int64_t>(slot);
    t->write = (t->write + 1) % t->capacity;
    if (t->count < t->capacity) ++t->count;
  }
}

void st_update_batch(void* h, const int64_t* tree_idxs,
                     const double* priorities, int64_t n) {
  auto* t = static_cast<SumTree*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  for (int64_t i = 0; i < n; ++i)
    t->set_priority(static_cast<size_t>(tree_idxs[i]), priorities[i]);
}

// Subtractive descent for each query value (caller supplies the values so
// RNG stays in Python for reproducibility). Returns tree idx + priority.
void st_get_batch(void* h, const double* values, int64_t n,
                  int64_t* out_tree_idx, double* out_priority) {
  auto* t = static_cast<SumTree*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  for (int64_t i = 0; i < n; ++i) {
    size_t idx = t->retrieve(values[i]);
    out_tree_idx[i] = static_cast<int64_t>(idx);
    out_priority[i] = t->tree[idx];
  }
}

// Copy out the whole tree (2 * capacity - 1 doubles), the write cursor
// and the count.
void st_export(void* h, double* out_tree, int64_t* out_write, int64_t* out_count) {
  auto* t = static_cast<SumTree*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  for (size_t i = 0; i < t->tree.size(); ++i) out_tree[i] = t->tree[i];
  *out_write = static_cast<int64_t>(t->write);
  *out_count = static_cast<int64_t>(t->count);
}

// Overwrite the whole tree, write cursor and count with `st_export`'s
// output from a tree of the same capacity.
void st_import(void* h, const double* tree, int64_t write, int64_t count) {
  auto* t = static_cast<SumTree*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  for (size_t i = 0; i < t->tree.size(); ++i) t->tree[i] = tree[i];
  t->write = static_cast<size_t>(write);
  t->count = static_cast<size_t>(count);
}

}  // extern "C"
