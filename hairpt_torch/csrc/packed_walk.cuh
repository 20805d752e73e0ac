// The skip-pointer BVH walk of one ray, shared by kernel F (packed.cu:
// one walk per ray over the packed layout), kernel G (instanced.cu: one
// walk per ray and instance whose world box the ray enters) and kernel H
// (perray.cu: one walk per ray over the SoA BVHArrays), and the node
// decoding, slab test and leaf arithmetic that kernel I (blocked.cu)
// reuses. The walk is templated on a tree: PackedTree reads the packed
// layout (its contract and plain version in
// hairpt_torch/ops/intersect_packed.py), ArraysTree the BVHArrays and
// their sorted geometry (hairpt_torch/ops/intersect.py).
//
//   node row (32 B, two float4 loads): bbox min xyz, bbox max xyz,
//     meta = bitcast (child_or_leaf << 5 | count), skip = bitcast next
//     node in preorder past this subtree; the sentinel is M;
//   the slab test: inv_d = 1 / d with |d| < 1e-12 clamped to +-1e-12,
//     tf widened as tf * 1.00000024 + 1e-7, hit_box = tn <= tf &&
//     tf >= mint && tn <= maxt, min and max passing a NaN on as
//     torch.minimum / torch.maximum do (fminf / fmaxf would drop it);
//   a leaf the ray enters: its count primitives (64 B each) tested in
//     lane order; closest hit takes the first lane at the least t and
//     keeps it where t < maxt strictly, maxt shrinking to it; any hit
//     stops at the first lane that hits;
//   then node = (hit_box && inner) ? left child : skip.
// On the packed layout any hit starts occluded where maxt <= mint (no
// walk) and returns occ && !degenerate; on the BVHArrays (the JAX
// package's per-ray walk) it has no such rule. A walk is capped at 2 M
// steps.
//
// Every float operation is the plain version's, in its order, with no
// contraction (the libraries are built with --fmad=false), divisions and
// square roots IEEE-rounded (1.0f / sqrtf(x) for the hair's inverse
// length, never rsqrtf), so a walk equals _walk_plain bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace packed {

constexpr int PRIM_F = 16;
constexpr int INNER = 0x1F;

// walk results besides a hit: the step cap, an index out of range
constexpr int ERR_CAP = 1;
constexpr int ERR_RANGE = 2;

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float f_nan() { return __int_as_float(0x7fc00000); }

// torch.minimum / torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? f_nan() : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? f_nan() : fmaxf(a, b);
}

// 1 / x with |x| < 1e-12 set to +-1e-12 (tiled_kernels._inv_dir)
__device__ __forceinline__ float inv_dir(float x) {
  return 1.0f / (fabsf(x) < 1e-12f ? (x >= 0.0f ? 1e-12f : -1e-12f) : x);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, mint;
};

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// Moller-Trumbore on one triangle (p0, e1, e2): t and whether the ray hits
// it in [mint, maxt] (intersect_packed.tri_leaf_eval, without its id)
__device__ __forceinline__ bool tri_hit(float p0x, float p0y, float p0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        const Ray& r, float maxt, float& t) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = dot3(e1x, e1y, e1z, px, py, pz);
  const float inv_det = 1.0f / (fabsf(det) < 1e-12f ? 1.0f : det);
  const float tx = r.ox - p0x, ty = r.oy - p0y, tz = r.oz - p0z;
  const float u = dot3(tx, ty, tz, px, py, pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = dot3(r.dx, r.dy, r.dz, qx, qy, qz) * inv_det;
  t = dot3(e2x, e2y, e2z, qx, qy, qz) * inv_det;
  return fabsf(det) >= 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
         t >= r.mint && t <= maxt;
}

// the miter cylinder (p0, p1, miter normals n0, n1, radius) in the hair
// row order p0 p1 n0 n1 r: t and whether the ray hits it in [mint, maxt]
// (intersect_packed.hair_leaf_eval, without its id)
__device__ __forceinline__ bool hair_hit(const float* g, const Ray& r,
                                         float maxt, float& t) {
  const float p0x = g[0], p0y = g[1], p0z = g[2];
  const float p1x = g[3], p1y = g[4], p1z = g[5];
  const float n0x = g[6], n0y = g[7], n0z = g[8];
  const float n1x = g[9], n1y = g[10], n1z = g[11];
  const float rad = g[12];
  const float sx = p1x - p0x, sy = p1y - p0y, sz = p1z - p0z;
  const float l2 = nmax(dot3(sx, sy, sz, sx, sy, sz), 1e-30f);
  const float inv_len = 1.0f / sqrtf(l2);
  const float ax = sx * inv_len, ay = sy * inv_len, az = sz * inv_len;
  const float rx = r.ox - p0x, ry = r.oy - p0y, rz = r.oz - p0z;
  const float ar = dot3(ax, ay, az, rx, ry, rz);
  const float pox = rx - ar * ax, poy = ry - ar * ay, poz = rz - ar * az;
  const float ad = dot3(ax, ay, az, r.dx, r.dy, r.dz);
  const float pdx = r.dx - ad * ax, pdy = r.dy - ad * ay,
              pdz = r.dz - ad * az;
  const float qa = dot3(pdx, pdy, pdz, pdx, pdy, pdz);
  const float qb = dot3(pox, poy, poz, pdx, pdy, pdz);
  bool ok = qa > 1e-18f;
  const float a_safe = ok ? qa : 1.0f;
  const float t_mid = -qb / a_safe;
  const float qx = pox + pdx * t_mid, qy = poy + pdy * t_mid,
              qz = poz + pdz * t_mid;
  const float c_mid = dot3(qx, qy, qz, qx, qy, qz) - rad * rad;
  const float disc = -c_mid / a_safe;
  ok = ok && disc >= 0.0f;
  const float dt = sqrtf(nmax(disc, 0.0f));
  const float t_near = t_mid - dt;
  const float t_far = t_mid + dt;
  auto miter_ok = [&](float tt) {
    const float hx = r.ox + r.dx * tt, hy = r.oy + r.dy * tt,
                hz = r.oz + r.dz * tt;
    return dot3(hx - p0x, hy - p0y, hz - p0z, n0x, n0y, n0z) >= 0.0f &&
           dot3(hx - p1x, hy - p1y, hz - p1z, n1x, n1y, n1z) <= 0.0f;
  };
  const bool near_ok =
      ok && t_near >= r.mint && t_near <= maxt && miter_ok(t_near);
  const bool far_ok =
      ok && t_far >= r.mint && t_far <= maxt && miter_ok(t_far);
  t = near_ok ? t_near : t_far;
  return near_ok || far_ok;
}

// a packed triangle row (p0, e1, e2, pad, bitcast id)
struct TriLeaf {
  static __device__ __forceinline__ bool test(const float* __restrict__ p,
                                              const Ray& r, float maxt,
                                              float& t, int& pid) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    const float4 c = __ldg(reinterpret_cast<const float4*>(p) + 2);
    pid = __float_as_int(__ldg(p + PRIM_F - 1));
    const bool hit = tri_hit(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, r,
                             maxt, t);
    return pid >= 0 && hit;
  }
};

// a packed hair row (p0, p1, n0, n1, r, pad, pad, bitcast id)
struct HairLeaf {
  static __device__ __forceinline__ bool test(const float* __restrict__ p,
                                              const Ray& r, float maxt,
                                              float& t, int& pid) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    const float4 c = __ldg(reinterpret_cast<const float4*>(p) + 2);
    const float4 e = __ldg(reinterpret_cast<const float4*>(p) + 3);
    pid = __float_as_int(e.w);
    const float g[13] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z,
                         b.w, c.x, c.y, c.z, c.w, e.x};
    const bool hit = hair_hit(g, r, maxt, t);
    return pid >= 0 && hit;
  }
};

// one node of a tree: its box, its child (a leaf: its first primitive or
// leaf row), its primitive count, its skip pointer
struct Node {
  float lx, ly, lz, hx, hy, hz;
  int child, count, skip;
  bool leaf;
};

// The slab test, per axis in x, y, z order (tiled_kernels._slab), tf
// widened: does the ray enter the node's box in [mint, maxt]?
__device__ __forceinline__ bool box_hit(const Node& n, const Ray& r,
                                        float ix, float iy, float iz,
                                        float maxt) {
  float a0 = (n.lx - r.ox) * ix, a1 = (n.hx - r.ox) * ix;
  float tn = nmin(a0, a1), tf = nmax(a0, a1);
  a0 = (n.ly - r.oy) * iy;
  a1 = (n.hy - r.oy) * iy;
  tn = nmax(tn, nmin(a0, a1));
  tf = nmin(tf, nmax(a0, a1));
  a0 = (n.lz - r.oz) * iz;
  a1 = (n.hz - r.oz) * iz;
  tn = nmax(tn, nmin(a0, a1));
  tf = nmin(tf, nmax(a0, a1));
  tf = tf * 1.00000024f + 1e-7f;
  return tn <= tf && tf >= r.mint && tn <= maxt;
}

// The packed layout: nodes [M, 8] (32 B, two float4 loads per row), rows
// [L, K * 16]. A leaf's count is at most K and its row below L.
template <class Leaf>
struct PackedTree {
  const float* __restrict__ nodes;
  const float* __restrict__ rows;
  int M, L, K;
  static constexpr bool kDegenerate = true;

  __device__ __forceinline__ Node node(int k) const {
    const float4* nodes4 = reinterpret_cast<const float4*>(nodes);
    const float4 na = __ldg(nodes4 + 2 * k);
    const float4 nb = __ldg(nodes4 + 2 * k + 1);
    const int meta = __float_as_int(nb.z);
    Node n;
    n.lx = na.x;
    n.ly = na.y;
    n.lz = na.z;
    n.hx = na.w;
    n.hy = nb.x;
    n.hz = nb.y;
    n.count = meta & 0x1F;
    n.child = meta >> 5;
    n.skip = __float_as_int(nb.w);
    n.leaf = n.count != INNER;
    return n;
  }
  __device__ __forceinline__ bool leaf_ok(const Node& n) const {
    return (unsigned)n.child < (unsigned)L && n.count <= K;
  }
  __device__ __forceinline__ bool test(const Node& n, int j, const Ray& r,
                                       float maxt, float& t, int& pid) const {
    return Leaf::test(rows + ((size_t)n.child * K + j) * PRIM_F, r, maxt, t,
                      pid);
  }
};

constexpr int LEAF = 4;   // primitives tested per BVHArrays leaf

// the sorted geometry of the BVHArrays: triangles (p0, e1, e2) or hair
// (p0, p1, n0, n1, radius), [P, 3] arrays and a [P] radius; g[k] is the
// k-th field
struct TriGeom {
  static constexpr int NF = 9;   // floats per primitive
  // component c (0..8) of primitive i
  static __device__ __forceinline__ float get(const float* const* g, int i,
                                              int c) {
    return __ldg(g[c / 3] + 3 * (size_t)i + c % 3);
  }
  static __device__ __forceinline__ bool hit(const float* p, const Ray& r,
                                             float maxt, float& t) {
    return tri_hit(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], r,
                   maxt, t);
  }
};

struct HairGeom {
  static constexpr int NF = 13;
  static __device__ __forceinline__ float get(const float* const* g, int i,
                                              int c) {
    return c < 12 ? __ldg(g[c / 3] + 3 * (size_t)i + c % 3)
                  : __ldg(g[4] + i);
  }
  static __device__ __forceinline__ bool hit(const float* p, const Ray& r,
                                             float maxt, float& t) {
    return hair_hit(p, r, maxt, t);
  }
};

// the geometry's field pointers as a kernel argument (TriGeom uses the
// first three)
struct GeomPtrs {
  const float* f[5];
};

// The BVHArrays: node_min / node_max [M, 3], node_left, node_count (-1
// inner), node_skip [M]; a leaf tests min(count, LEAF) primitives from
// node_left on, and returns their sorted index. A leaf's run must lie in
// [0, P).
template <class Geom>
struct ArraysTree {
  const float* __restrict__ lo;
  const float* __restrict__ hi;
  const int* __restrict__ left;
  const int* __restrict__ count;
  const int* __restrict__ skip;
  GeomPtrs geom;   // Geom's fields
  int M, P;
  static constexpr bool kDegenerate = false;

  __device__ __forceinline__ Node node(int k) const {
    Node n;
    n.lx = __ldg(lo + 3 * k);
    n.ly = __ldg(lo + 3 * k + 1);
    n.lz = __ldg(lo + 3 * k + 2);
    n.hx = __ldg(hi + 3 * k);
    n.hy = __ldg(hi + 3 * k + 1);
    n.hz = __ldg(hi + 3 * k + 2);
    const int c = __ldg(count + k);
    n.leaf = c >= 0;
    n.count = c < LEAF ? c : LEAF;
    n.child = __ldg(left + k);
    n.skip = __ldg(skip + k);
    return n;
  }
  __device__ __forceinline__ bool leaf_ok(const Node& n) const {
    return n.count == 0 ||
           (n.child >= 0 && (long long)n.child + n.count <= (long long)P);
  }
  __device__ __forceinline__ bool test(const Node& n, int j, const Ray& r,
                                       float maxt, float& t, int& pid) const {
    pid = n.child + j;
    float p[Geom::NF];
#pragma unroll
    for (int c = 0; c < Geom::NF; ++c) p[c] = Geom::get(geom.f, pid, c);
    return Geom::hit(p, r, maxt, t);
  }
};

// The walk of ray r over one tree. Closest hit: best_t / best_p the
// nearest primitive in [mint, maxt] (inf / -1 = none); any hit: occ.
// Returns 0, ERR_CAP where the walk reached 2 M steps, or ERR_RANGE where
// a node or a leaf lies outside the tree (both stop the walk).
template <class Tree, bool ANY>
__device__ __forceinline__ int walk_tree(const Tree& tree, const Ray& r,
                                         float maxt, float& best_t,
                                         int& best_p, bool& occ) {
  const int M = tree.M;
  const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);
  const bool degenerate = Tree::kDegenerate && maxt <= r.mint;
  occ = degenerate;
  best_t = f_inf();
  best_p = -1;
  int rc = 0;
  const long long cap = 2LL * M;
  long long steps = 0;
  int node = 0;
  while (node != M && !(ANY && occ)) {
    if (steps == cap) {
      rc = ERR_CAP;
      break;
    }
    if ((unsigned)node >= (unsigned)M) {
      rc = ERR_RANGE;
      break;
    }
    ++steps;
    const Node nd = tree.node(node);
    const bool hit_box = box_hit(nd, r, ix, iy, iz, maxt);
    if (hit_box && nd.leaf) {
      if (!tree.leaf_ok(nd)) {
        rc = ERR_RANGE;
        break;
      }
      float tb = f_inf();
      int pb = -1;
      for (int j = 0; j < nd.count; ++j) {
        float t;
        int pid;
        if (tree.test(nd, j, r, maxt, t, pid)) {
          if (ANY) {
            occ = true;
            break;
          }
          if (t < tb) {
            tb = t;
            pb = pid;
          }
        }
      }
      if (!ANY && tb < maxt) {
        maxt = tb;
        best_t = tb;
        best_p = pb;
      }
    }
    node = (hit_box && !nd.leaf) ? nd.child : nd.skip;
  }
  occ = occ && !degenerate;
  return rc;
}

// The walk over one packed BVH: nodes [M, 8], rows [L, K * 16] (kernels
// F and G).
template <class Leaf, bool ANY>
__device__ __forceinline__ int walk(const float* __restrict__ nodes,
                                    const float* __restrict__ rows, int M,
                                    int L, int K, const Ray& r, float maxt,
                                    float& best_t, int& best_p, bool& occ) {
  const PackedTree<Leaf> tree{nodes, rows, M, L, K};
  return walk_tree<PackedTree<Leaf>, ANY>(tree, r, maxt, best_t, best_p,
                                          occ);
}

}  // namespace packed
