// pbrt_tpu native host components.
//
// The device compute path is JAX/XLA/Pallas; these are the host-side native
// kernels where Python is the bottleneck at production scale:
//
//   * bvh_build  — binned-SAH BVH builder emitting the skip-link DFS
//                  layout consumed by the device traversers
//                  (pbrt_tpu/accel/bvh.py, ops/traverse.py).  Handles
//                  1M+ triangles in tens of milliseconds vs seconds for
//                  the Python median-split builder — and with SAH quality.
//   * tokenize   — byte-level pbrt scene tokenizer with the exact token
//                  rules of pbrt_tpu/core/parser.py (reference semantics
//                  parser.rs:66-148), emitting token spans for the Python
//                  parser to slice.  Python remains the semantic owner;
//                  this is the fast path for multi-megabyte scene files.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// Build: g++ -O3 -march=native -shared -fPIC -o libpbrt_native.so pbrt_native.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Box {
  float mn[3], mx[3];
  void reset() {
    for (int i = 0; i < 3; i++) {
      mn[i] = 3.4e38f;
      mx[i] = -3.4e38f;
    }
  }
  void grow(const float* p) {
    for (int i = 0; i < 3; i++) {
      mn[i] = std::min(mn[i], p[i]);
      mx[i] = std::max(mx[i], p[i]);
    }
  }
  void grow(const Box& b) {
    for (int i = 0; i < 3; i++) {
      mn[i] = std::min(mn[i], b.mn[i]);
      mx[i] = std::max(mx[i], b.mx[i]);
    }
  }
  float area() const {
    float d0 = std::max(mx[0] - mn[0], 0.f);
    float d1 = std::max(mx[1] - mn[1], 0.f);
    float d2 = std::max(mx[2] - mn[2], 0.f);
    return 2.f * (d0 * d1 + d1 * d2 + d2 * d0);
  }
};

struct Builder {
  const float *p0, *p1, *p2;
  int leaf_size;
  std::vector<Box> prim_box;
  std::vector<float> centroid;  // [n][3]
  std::vector<int64_t> perm;
  // outputs
  float* node_min;
  float* node_max;
  int32_t* skip;
  int32_t* first;
  int32_t* count;
  int n_nodes = 0;
  int max_nodes;

  static constexpr int kBins = 16;

  // Emits subtree for perm[lo, hi); returns subtree node count or -1 on
  // overflow.  DFS order; skip link = index just past the subtree.
  int build(int64_t lo, int64_t hi) {
    if (n_nodes >= max_nodes) return -1;
    int idx = n_nodes++;
    Box nb;
    nb.reset();
    for (int64_t i = lo; i < hi; i++) nb.grow(prim_box[perm[i]]);
    for (int c = 0; c < 3; c++) {
      node_min[idx * 3 + c] = nb.mn[c];
      node_max[idx * 3 + c] = nb.mx[c];
    }
    int64_t n = hi - lo;
    if (n <= leaf_size) {
      first[idx] = (int32_t)lo;
      count[idx] = (int32_t)n;
      skip[idx] = n_nodes;
      return 1;
    }
    first[idx] = 0;
    count[idx] = 0;

    // centroid bounds
    Box cb;
    cb.reset();
    for (int64_t i = lo; i < hi; i++) cb.grow(&centroid[perm[i] * 3]);

    // binned SAH over the widest centroid axis
    int axis = 0;
    float ext[3] = {cb.mx[0] - cb.mn[0], cb.mx[1] - cb.mn[1],
                    cb.mx[2] - cb.mn[2]};
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int64_t mid;
    if (ext[axis] < 1e-12f) {
      mid = lo + n / 2;  // degenerate: equal split
    } else {
      Box bin_box[kBins];
      int64_t bin_cnt[kBins];
      for (int b = 0; b < kBins; b++) {
        bin_box[b].reset();
        bin_cnt[b] = 0;
      }
      float k = kBins * (1.f - 1e-6f) / ext[axis];
      for (int64_t i = lo; i < hi; i++) {
        int b = (int)(k * (centroid[perm[i] * 3 + axis] - cb.mn[axis]));
        b = std::min(std::max(b, 0), kBins - 1);
        bin_box[b].grow(prim_box[perm[i]]);
        bin_cnt[b]++;
      }
      // sweep for best split
      Box right_acc[kBins];
      Box acc;
      acc.reset();
      for (int b = kBins - 1; b >= 1; b--) {
        acc.grow(bin_box[b]);
        right_acc[b] = acc;
      }
      float best_cost = 3.4e38f;
      int best_split = -1;
      acc.reset();
      int64_t left_n = 0;
      for (int b = 1; b < kBins; b++) {
        acc.grow(bin_box[b - 1]);
        left_n += bin_cnt[b - 1];
        int64_t right_n = n - left_n;
        if (left_n == 0 || right_n == 0) continue;
        float cost = acc.area() * left_n + right_acc[b].area() * right_n;
        if (cost < best_cost) {
          best_cost = cost;
          best_split = b;
        }
      }
      if (best_split < 0) {
        mid = lo + n / 2;
        std::nth_element(perm.begin() + lo, perm.begin() + mid,
                         perm.begin() + hi, [&](int64_t a, int64_t b) {
                           return centroid[a * 3 + axis] <
                                  centroid[b * 3 + axis];
                         });
      } else {
        float split_pos = cb.mn[axis] + best_split * ext[axis] / kBins;
        auto it = std::partition(perm.begin() + lo, perm.begin() + hi,
                                 [&](int64_t a) {
                                   return centroid[a * 3 + axis] < split_pos;
                                 });
        mid = it - perm.begin();
        if (mid == lo || mid == hi) mid = lo + n / 2;
      }
    }
    if (mid == lo || mid == hi) {
      // still degenerate: force median by index
      mid = lo + n / 2;
    }
    int l = build(lo, mid);
    if (l < 0) return -1;
    int r = build(mid, hi);
    if (r < 0) return -1;
    skip[idx] = n_nodes;
    return 1 + l + r;
  }
};

inline bool is_ws(uint8_t b) {
  return b == ' ' || b == '\n' || b == '\t' || b == '\r';
}

}  // namespace

extern "C" {

// Returns node count, or -1 on overflow / error.
// Output arrays must hold >= max_nodes entries (node_min/max: 3 floats each).
// perm must hold n_tris int64 entries and is filled with the new prim order.
int bvh_build(const float* p0, const float* p1, const float* p2,
              int64_t n_tris, int leaf_size, float* node_min, float* node_max,
              int32_t* skip, int32_t* first, int32_t* count, int64_t* perm,
              int max_nodes) {
  if (n_tris <= 0) return 0;
  Builder b;
  b.p0 = p0;
  b.p1 = p1;
  b.p2 = p2;
  b.leaf_size = leaf_size;
  b.node_min = node_min;
  b.node_max = node_max;
  b.skip = skip;
  b.first = first;
  b.count = count;
  b.max_nodes = max_nodes;
  b.prim_box.resize(n_tris);
  b.centroid.resize(n_tris * 3);
  b.perm.resize(n_tris);
  for (int64_t i = 0; i < n_tris; i++) {
    Box& box = b.prim_box[i];
    box.reset();
    box.grow(p0 + i * 3);
    box.grow(p1 + i * 3);
    box.grow(p2 + i * 3);
    for (int c = 0; c < 3; c++)
      b.centroid[i * 3 + c] = 0.5f * (box.mn[c] + box.mx[c]);
    b.perm[i] = i;
  }
  if (b.build(0, n_tris) < 0) return -1;
  std::memcpy(perm, b.perm.data(), n_tris * sizeof(int64_t));
  return b.n_nodes;
}

// Tokenize pbrt scene bytes.  Emits [start, end) byte spans per token,
// comment tokens included (start byte '#'), quoted strings kept quoted.
// Returns token count, -(pos+1) on tokenizer error (unterminated string),
// or -1 if max_toks exceeded.
int64_t tokenize(const uint8_t* data, int64_t len, int64_t* tok_start,
                 int64_t* tok_end, int64_t max_toks) {
  int64_t pos = 0;
  int64_t n = 0;
  while (pos < len) {
    uint8_t c = data[pos];
    if (is_ws(c)) {
      pos++;
      continue;
    }
    if (n >= max_toks) return -1;
    int64_t start = pos;
    if (c == '"') {
      pos++;
      bool closed = false;
      while (pos < len) {
        uint8_t q = data[pos];
        if (q == '"') {
          pos++;
          closed = true;
          break;
        }
        if (q == '\n') return -(start + 1);
        if (q == '\\') pos++;  // skip escaped char
        pos++;
      }
      if (!closed) return -(start + 1);
    } else if (c == '[' || c == ']') {
      pos++;
    } else if (c == '#') {
      while (pos < len && data[pos] != '\n' && data[pos] != '\r') pos++;
    } else {
      while (pos < len) {
        uint8_t q = data[pos];
        if (is_ws(q) || q == '"' || q == '[' || q == ']') break;
        pos++;
      }
    }
    tok_start[n] = start;
    tok_end[n] = pos;
    n++;
  }
  return n;
}

}  // extern "C"
