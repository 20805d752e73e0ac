// The slab tests shared by the kernels:
//   * the tile test of kernel A (tiled.cu) and the swept phase A
//     (swept_cull.cu): a test of a box against the ranges of a group of
//     rays that is false only if no ray of the group can pass the per-ray
//     slab test against it. Plain version:
//     hairpt_torch/ops/tiled_kernels.py::group_cull_plain;
//   * the per-(ray, cluster) box cull of the phase-B kernels B (tiled.cu),
//     C and D (octets.cu), with its margin BOX_PAD. Plain version:
//     tiled_kernels.py::slot_cull_plain;
//   * the loads those kernels share: a cluster's box, and a cluster's
//     [16, K] segment block copied into shared memory by cp.async.
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

// The box cull's margin, relative to the coordinates' magnitude. The
// boxes are the exact cap-ellipse extents rounded to f32, and the lane
// test rounds its operands (a few ulp of |origin| and |p0|), so a
// grazing hit may lie on a face of its box or a few ulp outside it,
// where the slab test can reject it (a ray in the plane of a face gets a
// slab of zero width). 2^-16 is 256 ulp of that scale;
// tests/test_torch_tiled.py shows hits that the unwidened test loses and
// that no hit lies outside its box by a sixteenth of the margin.
// tiled_kernels.BOX_PAD is the same number.
constexpr float BOX_PAD = 1.0f / 65536.0f;

// A ray as the box cull takes it: its origin, 1/d with the components
// below 1e-12 in magnitude set to +-1e-12 (kernel A's), mint, maxt and the
// origin's largest |coordinate|.
struct CullRay {
  float o[3], inv[3], mint, maxt, mag;
};

__device__ __forceinline__ CullRay cull_ray(float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float mint, float maxt) {
  CullRay c;
  c.o[0] = ox;
  c.o[1] = oy;
  c.o[2] = oz;
  const float d[3] = {dx, dy, dz};
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    float dd = d[ax];
    if (fabsf(dd) < 1e-12f) dd = (dd >= 0.0f) ? 1e-12f : -1e-12f;
    c.inv[ax] = 1.0f / dd;
  }
  c.mint = mint;
  c.maxt = maxt;
  c.mag = fmaxf(fabsf(ox), fmaxf(fabsf(oy), fabsf(oz)));
  return c;
}

// Kernel A's slab test of the ray against the box b (lo.xyz, hi.xyz)
// widened by BOX_PAD times the larger of the origin's and the box's
// largest |coordinate|, up to maxt_eff (the ray's maxt, or less) with <=:
// false only if no lane test of the box's cluster can hit the ray in
// [mint, maxt_eff].
__device__ __forceinline__ bool box_cull(const CullRay& r,
                                         const float (&b)[6],
                                         float maxt_eff) {
  float bmag = fabsf(b[0]);
#pragma unroll
  for (int i = 1; i < 6; ++i) bmag = fmaxf(bmag, fabsf(b[i]));
  const float pad = BOX_PAD * (r.mag + bmag);
  float tn = 0.0f, tf = 0.0f;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float a0 = ((b[ax] - pad) - r.o[ax]) * r.inv[ax];
    const float a1 = ((b[3 + ax] + pad) - r.o[ax]) * r.inv[ax];
    const float lo_ax = fminf(a0, a1);
    const float hi_ax = fmaxf(a0, a1);
    tn = (ax == 0) ? lo_ax : fmaxf(tn, lo_ax);
    tf = (ax == 0) ? hi_ax : fminf(tf, hi_ax);
  }
  tf = tf * 1.00000024f + 1e-7f;
  return (tn <= tf) && (tf >= r.mint) && (tn <= maxt_eff);
}

// cluster cid's box from bounds [6, C] (lo.xyz, hi.xyz rows)
__device__ __forceinline__ void load_box(const float* __restrict__ bounds,
                                         int C, unsigned cid, float (&b)[6]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) b[i] = __ldg(bounds + (size_t)i * C + cid);
}

// copy one [16, K] segment block into shared memory with cp.async (16 B
// per copy, spread over the NT threads of the block); the caller commits
// the group
template <int K, int NT>
__device__ __forceinline__ void copy_block(float* dst, const float* src,
                                           int tid) {
  for (int i = tid; i < 4 * K; i += NT) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + 4 * i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + 4 * i));
  }
}

}  // namespace hairpt_dev
