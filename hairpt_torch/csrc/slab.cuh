// The slab tests' tile test, shared by kernel A (tiled.cu) and the swept
// phase A (swept_cull.cu): a test of a box against the ranges of a group
// of rays that is false only if no ray of the group can pass the per-ray
// slab test against it. Plain version:
// hairpt_torch/ops/tiled_kernels.py::group_cull_plain.
#pragma once

#include <cuda_runtime.h>

namespace hairpt_dev {

// A group of rays as the tile test takes them: ranges of the origin and
// of 1/d per axis, the least mint and largest maxt; `finite` is false if
// a ray of the group has a non-finite component of o or 1/d (the group
// then passes every box). Kernel A builds the ranges over a tile's live
// rays, the swept phase A (swept_cull.cu) over all its rays.
struct RayRange {
  float omin[3], omax[3], imin[3], imax[3];
  float mint, maxt;
  bool finite;
};

// The range [lo, hi] of fl(fl(f - o) * inv) over o in [omin, omax] and
// inv in [imin, imax]: round-to-nearest is monotone and a product's
// extremes over a box lie at its corners.
__device__ __forceinline__ void face_range(float f, float omin, float omax,
                                           float imin, float imax,
                                           float& lo, float& hi) {
  const float xl = f - omax, xh = f - omin;
  const float p0 = xl * imin, p1 = xl * imax;
  const float p2 = xh * imin, p3 = xh * imax;
  lo = fminf(fminf(p0, p1), fminf(p2, p3));
  hi = fmaxf(fmaxf(p0, p1), fmaxf(p2, p3));
}

// false only if no ray of the range can pass the per-ray slab test
// against the box b (lo.xyz, hi.xyz)
__device__ __forceinline__ bool tile_pass(const RayRange& g,
                                          const float (&b)[6]) {
  if (!g.finite) return true;
  float tn = 0.0f, tf = 0.0f;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    float l0, h0, l1, h1;
    face_range(b[ax], g.omin[ax], g.omax[ax], g.imin[ax], g.imax[ax], l0,
               h0);
    face_range(b[3 + ax], g.omin[ax], g.omax[ax], g.imin[ax], g.imax[ax],
               l1, h1);
    const float lo_ax = fminf(l0, l1);
    const float hi_ax = fmaxf(h0, h1);
    tn = (ax == 0) ? lo_ax : fmaxf(tn, lo_ax);
    tf = (ax == 0) ? hi_ax : fminf(tf, hi_ax);
  }
  tf = tf * 1.00000024f + 1e-7f;
  return !(tn > tf || tf < g.mint || tn > g.maxt);
}

}  // namespace hairpt_dev
