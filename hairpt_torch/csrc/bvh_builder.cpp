// Native BVH builder: top-down binned SAH over primitive AABBs.
//
// The port's copy of csrc/bvh_builder.cpp (hairpt_torch builds and loads
// its own library; array contract in hairpt_torch/ops/bvh.py).
// Counterpart of the reference's GenericKDTree SAH builder with its
// parallel TreeBuilder threads (include/mitsuba/render/gkdtree.h:958,
// 1468): scene build runs on the host CPU, so the hot build path is C++
// (parallel subtree builds via std::thread below a spawn depth), and the
// result is emitted directly in the flattened preorder skip-pointer
// format.
//
// Exposed through a C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{3e38f, 3e38f, 3e38f};
  Vec3 hi{-3e38f, -3e38f, -3e38f};
  void extend(const AABB &o) { lo = vmin(lo, o.lo); hi = vmax(hi, o.hi); }
  void extend(const Vec3 &p) { lo = vmin(lo, p); hi = vmax(hi, p); }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f), dy = std::max(hi.y - lo.y, 0.f),
          dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Node {
  AABB box;
  int32_t left = 0;    // preorder child index (internal) or prim start (leaf)
  int32_t count = -1;  // -1 internal, >=0 leaf prim count
  int32_t skip = 0;    // preorder index just past this subtree
};

constexpr int kBins = 16;

struct Builder {
  std::vector<AABB> boxes;
  std::vector<Vec3> centroids;
  std::vector<int32_t> order;
  int leaf_size;

  AABB range_bounds(int lo, int hi) const {
    AABB b;
    for (int i = lo; i < hi; ++i) b.extend(boxes[order[i]]);
    return b;
  }

  // choose SAH split of order[lo:hi); returns partition point or -1 (leaf)
  int find_split(int lo, int hi, const AABB &bounds) {
    int n = hi - lo;
    if (n <= leaf_size) return -1;

    AABB cb;
    for (int i = lo; i < hi; ++i) cb.extend(centroids[order[i]]);
    float best_cost = 3.4e38f;
    int best_axis = -1, best_bin = -1;
    for (int axis = 0; axis < 3; ++axis) {
      float cmin = cb.lo[axis], cmax = cb.hi[axis];
      if (cmax - cmin < 1e-12f) continue;
      float inv = kBins / (cmax - cmin);
      AABB bin_box[kBins];
      int bin_cnt[kBins] = {0};
      for (int i = lo; i < hi; ++i) {
        int p = order[i];
        int bk = std::min(kBins - 1, std::max(0, (int)((centroids[p][axis]
                                                        - cmin) * inv)));
        bin_box[bk].extend(boxes[p]);
        bin_cnt[bk]++;
      }
      AABB right[kBins];
      AABB acc;
      for (int bk = kBins - 1; bk >= 0; --bk) {
        acc.extend(bin_box[bk]);
        right[bk] = acc;
      }
      AABB left;
      int nl = 0;
      for (int bk = 0; bk < kBins - 1; ++bk) {
        left.extend(bin_box[bk]);
        nl += bin_cnt[bk];
        int nr = n - nl;
        if (nl == 0 || nr == 0) continue;
        float cost = left.area() * nl + right[bk + 1].area() * nr;
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = bk;
        }
      }
    }
    if (best_axis < 0) {
      // all centroids coincide: median split unless tiny
      return (n > 4 * leaf_size) ? lo + n / 2 : -1;
    }
    if (best_cost >= bounds.area() * (n - 0.5f) && n <= 4 * leaf_size)
      return -1;

    AABB cb2;
    for (int i = lo; i < hi; ++i) cb2.extend(centroids[order[i]]);
    float cmin = cb2.lo[best_axis], cmax = cb2.hi[best_axis];
    float inv = kBins / (cmax - cmin);
    auto mid = std::partition(
        order.begin() + lo, order.begin() + hi, [&](int32_t p) {
          int bk = std::min(kBins - 1, std::max(0, (int)((centroids[p][best_axis]
                                                          - cmin) * inv)));
          return bk <= best_bin;
        });
    int m = (int)(mid - order.begin());
    if (m == lo || m == hi) m = lo + n / 2;
    return m;
  }

  // preorder build: parent at out.size()-1 position already pushed by caller
  void build_rec(int lo, int hi, int32_t node, std::vector<Node> &out,
                 int depth, int spawn_depth) {
    int split = find_split(lo, hi, out[node].box);
    if (split < 0) {
      out[node].left = lo;
      out[node].count = hi - lo;
      out[node].skip = node + 1;
      return;
    }
    if (depth < spawn_depth) {
      // build the two subtrees in parallel into separate vectors, then
      // splice (preorder indices shifted)
      std::vector<Node> lvec, rvec;
      lvec.push_back(Node{range_bounds(lo, split)});
      rvec.push_back(Node{range_bounds(split, hi)});
      std::thread tl([&] {
        build_rec(lo, split, 0, lvec, depth + 1, spawn_depth);
      });
      build_rec(split, hi, 0, rvec, depth + 1, spawn_depth);
      tl.join();
      int32_t li = (int32_t)out.size();
      for (auto nd : lvec) {
        if (nd.count < 0) nd.left += li;
        nd.skip += li;
        out.push_back(nd);
      }
      int32_t ri = (int32_t)out.size();
      for (auto nd : rvec) {
        if (nd.count < 0) nd.left += ri;
        nd.skip += ri;
        out.push_back(nd);
      }
      out[node].left = li;
      out[node].count = -1;
      out[node].skip = (int32_t)out.size();
      return;
    }
    int32_t li = (int32_t)out.size();
    out.push_back(Node{range_bounds(lo, split)});
    build_rec(lo, split, li, out, depth + 1, spawn_depth);
    int32_t ri = (int32_t)out.size();
    out.push_back(Node{range_bounds(split, hi)});
    build_rec(split, hi, ri, out, depth + 1, spawn_depth);
    out[node].left = li;
    out[node].count = -1;
    out[node].skip = (int32_t)out.size();
  }
};

}  // namespace

extern "C" {

// Returns the node count, or -1 on error. Output buffers must hold at least
// 2*n + 1 nodes (worst case: leaf_size == 1 chains).
int32_t hairpt_build_bvh(const float *prim_lo, const float *prim_hi,
                         int32_t n, int32_t leaf_size, int32_t n_threads,
                         float *node_lo, float *node_hi, int32_t *node_left,
                         int32_t *node_count, int32_t *node_skip,
                         int32_t *prim_order) {
  if (n <= 0 || leaf_size <= 0) return -1;
  Builder b;
  b.leaf_size = leaf_size;
  b.boxes.resize(n);
  b.centroids.resize(n);
  b.order.resize(n);
  for (int i = 0; i < n; ++i) {
    AABB bb;
    bb.lo = {prim_lo[3 * i], prim_lo[3 * i + 1], prim_lo[3 * i + 2]};
    bb.hi = {prim_hi[3 * i], prim_hi[3 * i + 1], prim_hi[3 * i + 2]};
    b.boxes[i] = bb;
    b.centroids[i] = {0.5f * (bb.lo.x + bb.hi.x), 0.5f * (bb.lo.y + bb.hi.y),
                      0.5f * (bb.lo.z + bb.hi.z)};
    b.order[i] = i;
  }
  int spawn_depth = 0;
  while ((1 << spawn_depth) < n_threads) spawn_depth++;

  std::vector<Node> nodes;
  nodes.reserve(2 * (size_t)n / leaf_size + 16);
  nodes.push_back(Node{b.range_bounds(0, n)});
  b.build_rec(0, n, 0, nodes, 0, spawn_depth);

  int32_t m = (int32_t)nodes.size();
  for (int32_t i = 0; i < m; ++i) {
    node_lo[3 * i] = nodes[i].box.lo.x;
    node_lo[3 * i + 1] = nodes[i].box.lo.y;
    node_lo[3 * i + 2] = nodes[i].box.lo.z;
    node_hi[3 * i] = nodes[i].box.hi.x;
    node_hi[3 * i + 1] = nodes[i].box.hi.y;
    node_hi[3 * i + 2] = nodes[i].box.hi.z;
    node_left[i] = nodes[i].left;
    node_count[i] = nodes[i].count;
    node_skip[i] = nodes[i].skip;
  }
  std::memcpy(prim_order, b.order.data(), sizeof(int32_t) * n);
  return m;
}
}
