// The packed-layout BVH walk of one ray, shared by kernel F (packed.cu:
// one walk per ray) and kernel G (instanced.cu: one walk per ray and
// instance whose world box the ray enters). The layout contract and the
// plain version are in hairpt_torch/ops/intersect_packed.py.
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
// Any hit starts occluded where maxt <= mint (no walk) and returns
// occ && !degenerate. A walk is capped at 2 M steps.
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

// Moller-Trumbore (intersect_packed.tri_leaf_eval)
struct TriLeaf {
  static __device__ __forceinline__ bool test(const float* __restrict__ p,
                                              const Ray& r, float maxt,
                                              float& t, int& pid) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    const float4 c = __ldg(reinterpret_cast<const float4*>(p) + 2);
    pid = __float_as_int(__ldg(p + PRIM_F - 1));
    const float p0x = a.x, p0y = a.y, p0z = a.z;
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w, e2z = c.x;
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
    return pid >= 0 && fabsf(det) >= 1e-12f && u >= 0.0f && v >= 0.0f &&
           u + v <= 1.0f && t >= r.mint && t <= maxt;
  }
};

// the miter cylinder (intersect_packed.hair_leaf_eval)
struct HairLeaf {
  static __device__ __forceinline__ bool test(const float* __restrict__ p,
                                              const Ray& r, float maxt,
                                              float& t, int& pid) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    const float4 c = __ldg(reinterpret_cast<const float4*>(p) + 2);
    const float4 e = __ldg(reinterpret_cast<const float4*>(p) + 3);
    pid = __float_as_int(e.w);
    const float p0x = a.x, p0y = a.y, p0z = a.z;
    const float p1x = a.w, p1y = b.x, p1z = b.y;
    const float n0x = b.z, n0y = b.w, n0z = c.x;
    const float n1x = c.y, n1y = c.z, n1z = c.w;
    const float rad = e.x;
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
    return pid >= 0 && (near_ok || far_ok);
  }
};

// The walk of ray r over one packed BVH: nodes [M, 8], rows [L, K * 16].
// Closest hit: best_t / best_p the nearest primitive in [mint, maxt]
// (inf / -1 = none); any hit: occ. Returns 0, ERR_CAP where the walk
// reached 2 M steps, or ERR_RANGE where a node, a leaf row or a leaf's
// count lies outside the tree (both stop the walk).
template <class Leaf, bool ANY>
__device__ __forceinline__ int walk(const float* __restrict__ nodes,
                                    const float* __restrict__ rows, int M,
                                    int L, int K, const Ray& r, float maxt,
                                    float& best_t, int& best_p, bool& occ) {
  const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);
  const bool degenerate = maxt <= r.mint;
  occ = degenerate;
  best_t = f_inf();
  best_p = -1;
  int rc = 0;
  const long long cap = 2LL * M;
  long long steps = 0;
  int node = 0;
  const float4* nodes4 = reinterpret_cast<const float4*>(nodes);
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
    const float4 na = __ldg(nodes4 + 2 * node);
    const float4 nb = __ldg(nodes4 + 2 * node + 1);
    const int meta = __float_as_int(nb.z);
    const int skip = __float_as_int(nb.w);
    const int count = meta & 0x1F;
    const int child = meta >> 5;
    const bool is_leaf = count != INNER;
    // the slab test, per axis in x, y, z order (tiled_kernels._slab)
    float a0 = (na.x - r.ox) * ix, a1 = (na.w - r.ox) * ix;
    float tn = nmin(a0, a1), tf = nmax(a0, a1);
    a0 = (na.y - r.oy) * iy;
    a1 = (nb.x - r.oy) * iy;
    tn = nmax(tn, nmin(a0, a1));
    tf = nmin(tf, nmax(a0, a1));
    a0 = (na.z - r.oz) * iz;
    a1 = (nb.y - r.oz) * iz;
    tn = nmax(tn, nmin(a0, a1));
    tf = nmin(tf, nmax(a0, a1));
    tf = tf * 1.00000024f + 1e-7f;
    const bool hit_box = tn <= tf && tf >= r.mint && tn <= maxt;
    if (hit_box && is_leaf) {
      if ((unsigned)child >= (unsigned)L || count > K) {
        rc = ERR_RANGE;
        break;
      }
      const float* leaf = rows + (size_t)child * K * PRIM_F;
      float tb = f_inf();
      int pb = -1;
      for (int j = 0; j < count; ++j) {
        float t;
        int pid;
        if (Leaf::test(leaf + j * PRIM_F, r, maxt, t, pid)) {
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
    node = (hit_box && !is_leaf) ? child : skip;
  }
  occ = occ && !degenerate;
  return rc;
}

}  // namespace packed
