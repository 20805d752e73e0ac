// Per-(ray, segment) miter-cylinder tests shared by the phase-B kernels
// (tiled.cu, octets.cu, phaseb.cu).
//
// A segment block is the [16, K] float layout of seg_rows_t (rows
// 0:3 p0 | 3:6 unit axis | 6:9 n0 | 9:12 n1 | 12 r | 13 sn1 = (p1-p0).n1 |
// 14 r^2 | 15 id as int32 bits, -1 for a padding segment); lane l of row j
// is rows[j * K + l]. Both tests return true on a hit of the segment in
// [mint, maxt] and then set t and pid. Every multiply and add is written
// out in the order of the plain PyTorch versions, and the kernels are
// compiled with --fmad=false, so kernel and plain version round alike.
#pragma once

#include <cuda_runtime.h>

namespace hairpt_dev {

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

struct RayRegs {
  float ox, oy, oz, dx, dy, dz, mint, maxt;
};

// rays8 [.., 8, n] row-major: component c of ray r at rays8[c * n + r]
__device__ __forceinline__ RayRegs load_ray(const float* r8, int n, int r) {
  RayRegs q;
  q.ox = r8[0 * n + r];
  q.oy = r8[1 * n + r];
  q.oz = r8[2 * n + r];
  q.dx = r8[3 * n + r];
  q.dy = r8[4 * n + r];
  q.dz = r8[5 * n + r];
  q.mint = r8[6 * n + r];
  q.maxt = r8[7 * n + r];
  return q;
}

// One segment lane of a block in registers: the 15 floats the tiled test
// reads and the id (-1 for a padding segment).
struct SegRegs {
  float p0x, p0y, p0z, ax, ay, az, n0x, n0y, n0z, n1x, n1y, n1z, sn1, rr2;
  int pid;
};

// lane l of a [16, K] block; row 12 (r) is not read by the tiled test
template <int K>
__device__ __forceinline__ SegRegs load_seg(const float* __restrict__ rows,
                                            int l) {
  SegRegs g;
  g.p0x = rows[0 * K + l];
  g.p0y = rows[1 * K + l];
  g.p0z = rows[2 * K + l];
  g.ax = rows[3 * K + l];
  g.ay = rows[4 * K + l];
  g.az = rows[5 * K + l];
  g.n0x = rows[6 * K + l];
  g.n0y = rows[7 * K + l];
  g.n0z = rows[8 * K + l];
  g.n1x = rows[9 * K + l];
  g.n1y = rows[10 * K + l];
  g.n1z = rows[11 * K + l];
  g.sn1 = rows[13 * K + l];
  g.rr2 = rows[14 * K + l];
  g.pid = __float_as_int(rows[15 * K + l]);
  return g;
}

// The tiled kernels' test: hairpt/ops/pallas_tiled.py::_cyl_test_tm and
// _cyl_test_oct (one reciprocal of a, miter planes in t-linear form);
// plain version hairpt_torch/ops/tiled_kernels.py::cyl_test.
__device__ __forceinline__ bool cyl_hit_seg(const SegRegs& g,
                                            const RayRegs& y, float& t) {
  const float rx = y.ox - g.p0x, ry = y.oy - g.p0y, rz = y.oz - g.p0z;
  const float ar = g.ax * rx + g.ay * ry + g.az * rz;
  const float pox = rx - ar * g.ax, poy = ry - ar * g.ay,
              poz = rz - ar * g.az;
  const float ad = g.ax * y.dx + g.ay * y.dy + g.az * y.dz;
  const float pdx = y.dx - ad * g.ax, pdy = y.dy - ad * g.ay,
              pdz = y.dz - ad * g.az;
  const float a = pdx * pdx + pdy * pdy + pdz * pdz;
  const float b = pox * pdx + poy * pdy + poz * pdz;
  bool ok = a > 1e-18f;
  const float inv_a = 1.0f / (ok ? a : 1.0f);
  const float t_mid = -b * inv_a;
  const float qx = pox + pdx * t_mid, qy = poy + pdy * t_mid,
              qz = poz + pdz * t_mid;
  const float c_mid = qx * qx + qy * qy + qz * qz - g.rr2;
  const float disc = -c_mid * inv_a;
  ok = ok && (disc >= 0.0f);
  const float dt = sqrtf(fmaxf(disc, 0.0f));
  const float t_near = t_mid - dt;
  const float t_far = t_mid + dt;
  const float on0 = rx * g.n0x + ry * g.n0y + rz * g.n0z;
  const float dn0 = y.dx * g.n0x + y.dy * g.n0y + y.dz * g.n0z;
  const float on1 = rx * g.n1x + ry * g.n1y + rz * g.n1z - g.sn1;
  const float dn1 = y.dx * g.n1x + y.dy * g.n1y + y.dz * g.n1z;
  const bool near_ok = ok && (t_near >= y.mint) && (t_near <= y.maxt) &&
                       (on0 + t_near * dn0 >= 0.0f) &&
                       (on1 + t_near * dn1 <= 0.0f);
  const bool far_ok = ok && (t_far >= y.mint) && (t_far <= y.maxt) &&
                      (on0 + t_far * dn0 >= 0.0f) &&
                      (on1 + t_far * dn1 <= 0.0f);
  t = near_ok ? t_near : t_far;
  return (g.pid >= 0) && (near_ok || far_ok);
}

// The swept kernel's test: hairpt/ops/pallas_phaseb.py::_phaseb_one (two
// divisions by a, miter planes through the hit point); plain version
// hairpt_torch/ops/phaseb_kernels.py::cyl_test_chunk.
__device__ __forceinline__ bool cyl_hit_chunk(const SegRegs& g,
                                              const RayRegs& y, float& t) {
  const float rx = y.ox - g.p0x, ry = y.oy - g.p0y, rz = y.oz - g.p0z;
  const float ar = g.ax * rx + g.ay * ry + g.az * rz;
  const float pox = rx - ar * g.ax, poy = ry - ar * g.ay,
              poz = rz - ar * g.az;
  const float ad = g.ax * y.dx + g.ay * y.dy + g.az * y.dz;
  const float pdx = y.dx - ad * g.ax, pdy = y.dy - ad * g.ay,
              pdz = y.dz - ad * g.az;
  const float a = pdx * pdx + pdy * pdy + pdz * pdz;
  const float b = pox * pdx + poy * pdy + poz * pdz;
  bool ok = a > 1e-18f;
  const float a_safe = ok ? a : 1.0f;
  const float t_mid = -b / a_safe;
  const float qx = pox + pdx * t_mid, qy = poy + pdy * t_mid,
              qz = poz + pdz * t_mid;
  const float c_mid = qx * qx + qy * qy + qz * qz - g.rr2;
  const float disc = -c_mid / a_safe;
  ok = ok && (disc >= 0.0f);
  const float dt = sqrtf(fmaxf(disc, 0.0f));
  const float t_near = t_mid - dt;
  const float t_far = t_mid + dt;
  bool m_ok[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float tt = s == 0 ? t_near : t_far;
    const float ex = y.ox + y.dx * tt - g.p0x, ey = y.oy + y.dy * tt - g.p0y,
                ez = y.oz + y.dz * tt - g.p0z;
    const float h0 = ex * g.n0x + ey * g.n0y + ez * g.n0z;
    const float h1 = ex * g.n1x + ey * g.n1y + ez * g.n1z - g.sn1;
    m_ok[s] = (h0 >= 0.0f) && (h1 <= 0.0f);
  }
  const bool near_ok =
      ok && (t_near >= y.mint) && (t_near <= y.maxt) && m_ok[0];
  const bool far_ok = ok && (t_far >= y.mint) && (t_far <= y.maxt) && m_ok[1];
  t = near_ok ? t_near : t_far;
  return (g.pid >= 0) && (near_ok || far_ok);
}

// A pretest of cyl_hit_chunk: false only where cyl_hit_chunk is false, so
// a warp whose lanes all fail it skips the divisions, the square root and
// the miter planes. cyl_hit_chunk misses unless c = |q|^2 - r^2 <= 0 at
// q = po + pd * t_mid (up to -c / a underflowing to -0). Here t_mid
// comes from __fdividef, within 2 ulp of -b / a, and every other
// operation is cyl_hit_chunk's; that moves each q_i by at most
// ~2^-20.9 (|po| + 2 |q|) in L1 norms (|pd t_mid| <= |po| + |q|), so c by
// at most 2^-19.9 Lq W + E^2 + 2^-20 (|q|^2 + r^2), W = Lp + 2 Lq. A c
// above 2^-17 Lq W + 2^-36 W^2 + 2^-19 (|q|^2 + r^2) + 1e-30 (the last
// term keeps -c / a from underflowing) is a miss; a non-finite c or
// bound passes. Plain version: phaseb_kernels.cyl_pretest_plain.
__device__ __forceinline__ bool cyl_may_hit_chunk(const SegRegs& g,
                                                  const RayRegs& y) {
  if (g.pid < 0) return false;
  const float rx = y.ox - g.p0x, ry = y.oy - g.p0y, rz = y.oz - g.p0z;
  const float ar = g.ax * rx + g.ay * ry + g.az * rz;
  const float pox = rx - ar * g.ax, poy = ry - ar * g.ay,
              poz = rz - ar * g.az;
  const float ad = g.ax * y.dx + g.ay * y.dy + g.az * y.dz;
  const float pdx = y.dx - ad * g.ax, pdy = y.dy - ad * g.ay,
              pdz = y.dz - ad * g.az;
  const float a = pdx * pdx + pdy * pdy + pdz * pdz;
  const float b = pox * pdx + poy * pdy + poz * pdz;
  if (!(a > 1e-18f)) return false;
  const float tm = __fdividef(-b, a);
  const float qx = pox + pdx * tm, qy = poy + pdy * tm, qz = poz + pdz * tm;
  const float sq = qx * qx + qy * qy + qz * qz;
  const float c = sq - g.rr2;
  const float lq = fabsf(qx) + fabsf(qy) + fabsf(qz);
  const float w = fabsf(pox) + fabsf(poy) + fabsf(poz) + 2.0f * lq;
  const float tol = 0x1p-17f * lq * w + 0x1p-36f * w * w +
                    0x1p-19f * (sq + g.rr2) + 1e-30f;
  return !(isfinite(c) && isfinite(tol) && c > tol);
}

}  // namespace hairpt_dev
