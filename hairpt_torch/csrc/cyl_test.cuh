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

// The tiled kernels' test: hairpt/ops/pallas_tiled.py::_cyl_test_tm and
// _cyl_test_oct (one reciprocal of a, miter planes in t-linear form);
// plain version hairpt_torch/ops/tiled_kernels.py::cyl_test.
template <int K>
__device__ __forceinline__ bool cyl_hit_tiled(const float* __restrict__ rows,
                                              int l, const RayRegs& y,
                                              float& t, int& pid) {
  const float p0x = rows[0 * K + l], p0y = rows[1 * K + l],
              p0z = rows[2 * K + l];
  const float ax_ = rows[3 * K + l], ay_ = rows[4 * K + l],
              az_ = rows[5 * K + l];
  const float n0x = rows[6 * K + l], n0y = rows[7 * K + l],
              n0z = rows[8 * K + l];
  const float n1x = rows[9 * K + l], n1y = rows[10 * K + l],
              n1z = rows[11 * K + l];
  const float sn1 = rows[13 * K + l], rr2 = rows[14 * K + l];
  pid = __float_as_int(rows[15 * K + l]);

  const float rx = y.ox - p0x, ry = y.oy - p0y, rz = y.oz - p0z;
  const float ar = ax_ * rx + ay_ * ry + az_ * rz;
  const float pox = rx - ar * ax_, poy = ry - ar * ay_, poz = rz - ar * az_;
  const float ad = ax_ * y.dx + ay_ * y.dy + az_ * y.dz;
  const float pdx = y.dx - ad * ax_, pdy = y.dy - ad * ay_,
              pdz = y.dz - ad * az_;
  const float a = pdx * pdx + pdy * pdy + pdz * pdz;
  const float b = pox * pdx + poy * pdy + poz * pdz;
  bool ok = a > 1e-18f;
  const float inv_a = 1.0f / (ok ? a : 1.0f);
  const float t_mid = -b * inv_a;
  const float qx = pox + pdx * t_mid, qy = poy + pdy * t_mid,
              qz = poz + pdz * t_mid;
  const float c_mid = qx * qx + qy * qy + qz * qz - rr2;
  const float disc = -c_mid * inv_a;
  ok = ok && (disc >= 0.0f);
  const float dt = sqrtf(fmaxf(disc, 0.0f));
  const float t_near = t_mid - dt;
  const float t_far = t_mid + dt;
  const float on0 = rx * n0x + ry * n0y + rz * n0z;
  const float dn0 = y.dx * n0x + y.dy * n0y + y.dz * n0z;
  const float on1 = rx * n1x + ry * n1y + rz * n1z - sn1;
  const float dn1 = y.dx * n1x + y.dy * n1y + y.dz * n1z;
  const bool near_ok = ok && (t_near >= y.mint) && (t_near <= y.maxt) &&
                       (on0 + t_near * dn0 >= 0.0f) &&
                       (on1 + t_near * dn1 <= 0.0f);
  const bool far_ok = ok && (t_far >= y.mint) && (t_far <= y.maxt) &&
                      (on0 + t_far * dn0 >= 0.0f) &&
                      (on1 + t_far * dn1 <= 0.0f);
  t = near_ok ? t_near : t_far;
  return (pid >= 0) && (near_ok || far_ok);
}

// The swept kernel's test: hairpt/ops/pallas_phaseb.py::_phaseb_one (two
// divisions by a, miter planes through the hit point); plain version
// hairpt_torch/ops/phaseb_kernels.py::cyl_test_chunk.
template <int K>
__device__ __forceinline__ bool cyl_hit_chunk(const float* __restrict__ rows,
                                              int l, const RayRegs& y,
                                              float& t, int& pid) {
  const float p0x = rows[0 * K + l], p0y = rows[1 * K + l],
              p0z = rows[2 * K + l];
  const float ax_ = rows[3 * K + l], ay_ = rows[4 * K + l],
              az_ = rows[5 * K + l];
  const float n0x = rows[6 * K + l], n0y = rows[7 * K + l],
              n0z = rows[8 * K + l];
  const float n1x = rows[9 * K + l], n1y = rows[10 * K + l],
              n1z = rows[11 * K + l];
  const float sn1 = rows[13 * K + l], rr2 = rows[14 * K + l];
  pid = __float_as_int(rows[15 * K + l]);

  const float rx = y.ox - p0x, ry = y.oy - p0y, rz = y.oz - p0z;
  const float ar = ax_ * rx + ay_ * ry + az_ * rz;
  const float pox = rx - ar * ax_, poy = ry - ar * ay_, poz = rz - ar * az_;
  const float ad = ax_ * y.dx + ay_ * y.dy + az_ * y.dz;
  const float pdx = y.dx - ad * ax_, pdy = y.dy - ad * ay_,
              pdz = y.dz - ad * az_;
  const float a = pdx * pdx + pdy * pdy + pdz * pdz;
  const float b = pox * pdx + poy * pdy + poz * pdz;
  bool ok = a > 1e-18f;
  const float a_safe = ok ? a : 1.0f;
  const float t_mid = -b / a_safe;
  const float qx = pox + pdx * t_mid, qy = poy + pdy * t_mid,
              qz = poz + pdz * t_mid;
  const float c_mid = qx * qx + qy * qy + qz * qz - rr2;
  const float disc = -c_mid / a_safe;
  ok = ok && (disc >= 0.0f);
  const float dt = sqrtf(fmaxf(disc, 0.0f));
  const float t_near = t_mid - dt;
  const float t_far = t_mid + dt;
  bool m_ok[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float tt = s == 0 ? t_near : t_far;
    const float ex = y.ox + y.dx * tt - p0x, ey = y.oy + y.dy * tt - p0y,
                ez = y.oz + y.dz * tt - p0z;
    const float h0 = ex * n0x + ey * n0y + ez * n0z;
    const float h1 = ex * n1x + ey * n1y + ez * n1z - sn1;
    m_ok[s] = (h0 >= 0.0f) && (h1 <= 0.0f);
  }
  const bool near_ok =
      ok && (t_near >= y.mint) && (t_near <= y.maxt) && m_ok[0];
  const bool far_ok = ok && (t_far >= y.mint) && (t_far <= y.maxt) && m_ok[1];
  t = near_ok ? t_near : t_far;
  return (pid >= 0) && (near_ok || far_ok);
}

}  // namespace hairpt_dev
