// Native BVH builder: binned-SAH over primitive AABBs -> flattened
// skip-link arrays (same layout as bvh/builder.py's BVHArrays).
//
// The reference has no native code at all (SURVEY.md §2: JS + WGSL
// only) and no acceleration structure; this is the host-side native
// component the ~1M-primitive config needs
// (BASELINE.md config 5), where the NumPy builder's per-node Python
// overhead dominates. Loaded via ctypes (native/__init__.py); the
// NumPy builder remains the fallback and the parity oracle.
//
// Layout contract (bvh/builder.py):
//   bbox_min/max: (N,3) f32 node bounds, DFS order
//   miss:         (N,)  i32 DFS escape link (N = terminate)
//   leaf_prims:   (N,K) i32 primitive ids, -1 padded; inner = all -1
//
// Build: g++ -O3 -march=native -shared -fPIC bvh_builder.cpp -o libcrtbvh.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int N_BINS = 16;

struct WorkItem {
  int32_t begin, end;    // range in the ids array
  int32_t escape_code;   // >=0 concrete; -1 root (=N); <=-2 pending slot
  int32_t resolve_slot;  // pending slot to set to this node's index, or -1
};

inline float bin_area(const float lo[3], const float hi[3]) {
  float dx = std::max(hi[0] - lo[0], 0.0f);
  float dy = std::max(hi[1] - lo[1], 0.0f);
  float dz = std::max(hi[2] - lo[2], 0.0f);
  return dx * dy + dy * dz + dz * dx;
}

}  // namespace

extern "C" int32_t crt_build_bvh(
    int32_t n_prims, const float* lo, const float* hi, int32_t max_leaf,
    float* out_bmin, float* out_bmax, int32_t* out_miss,
    int32_t* out_leaf) {
  if (n_prims <= 0 || max_leaf <= 0) return -1;

  std::vector<int32_t> ids(n_prims);
  for (int32_t i = 0; i < n_prims; ++i) ids[i] = i;
  std::vector<float> cent(3 * size_t(n_prims));
  for (int32_t i = 0; i < n_prims; ++i)
    for (int c = 0; c < 3; ++c)
      cent[3 * size_t(i) + c] = 0.5f * (lo[3 * size_t(i) + c] +
                                        hi[3 * size_t(i) + c]);

  std::vector<int32_t> pending;          // escape fixup slots
  std::vector<int32_t> miss_code;        // per emitted node
  std::vector<WorkItem> stack;
  stack.push_back({0, n_prims, -1, -1});
  int32_t n_nodes = 0;

  while (!stack.empty()) {
    WorkItem w = stack.back();
    stack.pop_back();
    const int32_t i = n_nodes++;
    const int32_t count = w.end - w.begin;
    if (w.resolve_slot >= 0) pending[w.resolve_slot] = i;

    // node bounds
    float nlo[3] = {INFINITY, INFINITY, INFINITY};
    float nhi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int32_t k = w.begin; k < w.end; ++k) {
      const size_t p = size_t(ids[k]);
      for (int c = 0; c < 3; ++c) {
        nlo[c] = std::min(nlo[c], lo[3 * p + c]);
        nhi[c] = std::max(nhi[c], hi[3 * p + c]);
      }
    }
    std::memcpy(out_bmin + 3 * size_t(i), nlo, sizeof nlo);
    std::memcpy(out_bmax + 3 * size_t(i), nhi, sizeof nhi);
    miss_code.push_back(w.escape_code);

    int32_t* leaf_row = out_leaf + size_t(i) * max_leaf;
    if (count <= max_leaf) {  // leaf
      for (int32_t k = 0; k < max_leaf; ++k)
        leaf_row[k] = k < count ? ids[w.begin + k] : -1;
      continue;
    }
    for (int32_t k = 0; k < max_leaf; ++k) leaf_row[k] = -1;

    // centroid extent -> split axis
    float clo[3] = {INFINITY, INFINITY, INFINITY};
    float chi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int32_t k = w.begin; k < w.end; ++k) {
      const float* c = &cent[3 * size_t(ids[k])];
      for (int a = 0; a < 3; ++a) {
        clo[a] = std::min(clo[a], c[a]);
        chi[a] = std::max(chi[a], c[a]);
      }
    }
    int axis = 0;
    float extent = chi[0] - clo[0];
    for (int a = 1; a < 3; ++a)
      if (chi[a] - clo[a] > extent) { extent = chi[a] - clo[a]; axis = a; }

    int32_t* mid = nullptr;
    if (extent > 1e-12f) {
      // binned SAH
      int32_t counts[N_BINS] = {0};
      float blo[N_BINS][3], bhi[N_BINS][3];
      for (int b = 0; b < N_BINS; ++b)
        for (int c = 0; c < 3; ++c) { blo[b][c] = INFINITY; bhi[b][c] = -INFINITY; }
      const float scale = N_BINS / extent;
      auto bin_of = [&](int32_t id) {
        int b = int((cent[3 * size_t(id) + axis] - clo[axis]) * scale);
        return std::min(std::max(b, 0), N_BINS - 1);
      };
      for (int32_t k = w.begin; k < w.end; ++k) {
        const int32_t id = ids[k];
        const int b = bin_of(id);
        ++counts[b];
        for (int c = 0; c < 3; ++c) {
          blo[b][c] = std::min(blo[b][c], lo[3 * size_t(id) + c]);
          bhi[b][c] = std::max(bhi[b][c], hi[3 * size_t(id) + c]);
        }
      }
      // prefix/suffix sweep
      float pre_area[N_BINS], suf_area[N_BINS];
      int32_t pre_cnt[N_BINS];
      {
        float alo[3] = {INFINITY, INFINITY, INFINITY};
        float ahi[3] = {-INFINITY, -INFINITY, -INFINITY};
        int32_t acc = 0;
        for (int b = 0; b < N_BINS; ++b) {
          for (int c = 0; c < 3; ++c) {
            alo[c] = std::min(alo[c], blo[b][c]);
            ahi[c] = std::max(ahi[c], bhi[b][c]);
          }
          acc += counts[b];
          pre_area[b] = bin_area(alo, ahi);
          pre_cnt[b] = acc;
        }
      }
      {
        float alo[3] = {INFINITY, INFINITY, INFINITY};
        float ahi[3] = {-INFINITY, -INFINITY, -INFINITY};
        for (int b = N_BINS - 1; b >= 0; --b) {
          for (int c = 0; c < 3; ++c) {
            alo[c] = std::min(alo[c], blo[b][c]);
            ahi[c] = std::max(ahi[c], bhi[b][c]);
          }
          suf_area[b] = bin_area(alo, ahi);
        }
      }
      int best = -1;
      float best_cost = INFINITY;
      for (int b = 0; b + 1 < N_BINS; ++b) {
        const int32_t nl = pre_cnt[b], nr = count - nl;
        if (nl == 0 || nr == 0) continue;
        const float cost = pre_area[b] * nl + suf_area[b + 1] * nr;
        if (cost < best_cost) { best_cost = cost; best = b; }
      }
      if (best >= 0) {
        mid = std::partition(
            ids.data() + w.begin, ids.data() + w.end,
            [&](int32_t id) { return bin_of(id) <= best; });
        if (mid == ids.data() + w.begin || mid == ids.data() + w.end)
          mid = nullptr;  // shouldn't happen, but stay safe
      }
    }
    if (mid == nullptr) {
      // median split on the centroid axis
      int32_t* b = ids.data() + w.begin;
      int32_t* e = ids.data() + w.end;
      mid = b + count / 2;
      std::nth_element(b, mid, e, [&](int32_t x, int32_t y) {
        return cent[3 * size_t(x) + axis] < cent[3 * size_t(y) + axis];
      });
    }

    const int32_t split = int32_t(mid - ids.data());
    const int32_t slot = int32_t(pending.size());
    pending.push_back(-1);
    // LIFO: right first so left is emitted at i+1 (DFS order)
    stack.push_back({split, w.end, w.escape_code, slot});
    stack.push_back({w.begin, split, int32_t(-2 - slot), -1});
  }

  // resolve escape codes
  for (int32_t i = 0; i < n_nodes; ++i) {
    const int32_t code = miss_code[i];
    out_miss[i] = code == -1 ? n_nodes
                : code >= 0  ? code
                             : pending[size_t(-2 - code)];
  }
  return n_nodes;
}
