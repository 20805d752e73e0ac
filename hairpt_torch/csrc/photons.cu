// Kernel K: the hash-grid photon query for Hopper (sm_90a): the lanes'
// near photons as a list of (lane, photon) pairs, for the photon maps'
// surface gather and for the beam radiance estimate.
//
// Plain C interface for ctypes; the PyTorch wrappers (surface_pairs,
// beam_pairs and their chunked iterators), the layout contract and the
// plain versions (surface_pairs_plain, beam_pairs_plain) are in
// hairpt_torch/ops/photon_query.py. Built like the other kernels (nvcc
// -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared), as a
// library of its own. The entry point launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() right after the
// launch.
//
// Replaces no TPU kernel: the JAX package writes the neighbour search of
// its gather (hairpt/integrators/photonmap.py:214-233, gather_flux) and
// of its beam radiance estimate (:441-468, bre_query) as dense XLA array
// code that evaluates the BSDF or the phase function on every one of the
// 27 cells x max_per_cell slots of every lane (and every march step),
// mostly masked. Here one thread walks its lane's cells in the JAX
// loop order (dx, then dy, then dz, each -1, 0, 1; in beam mode the
// steps first) and emits only the slots that pass the JAX package's
// mask, so torch evaluates the BSDF or the phase function on those pairs
// alone. Two passes over the same loop: the first counts each lane's
// pairs, the wrapper takes the exclusive cumsum, the second writes each
// lane's pairs at its offset, lane by lane in the loop order.
//
// The rules, each exact against the dense loops:
//  - the query cell is ((p - grid_min) * inv_cell) truncated toward zero
//    (the float clamped to +-1e9 first: a cell that far out is outside
//    the grid in every version);
//  - a cell outside the grid (okc false) is skipped;
//  - start = lower_bound(cell, key); slot j reads min(start + j, M - 1);
//    the first slot whose key differs ends the cell (the keys are sorted,
//    so every later slot differs too); a clamped slot at M - 1 whose key
//    matches is emitted again for every such j, as the dense loop counts
//    it;
//  - surface: a lane whose point is not finite emits nothing (its d2 is
//    inf or NaN, so d2 < r2 never holds);
//  - beam: the march stops at the first step with lo_t >= t_end (no foot
//    can lie in [lo_t, hi_t) and below t_end).
// Every float operation is the plain version's, in its order, with no
// contraction, so the pairs equal the plain version's bit for bit.
//
// Bound: per lane, 27 binary searches (log2 M probes each) per cell
// visit and a few floats per slot; the sorted keys (a few MB) stay in
// L2. The surface query at the photon maps' sizes is bound by its
// operations, the beam query by its many steps' searches. The design is
// the simple one: one thread per lane, a binary search per cell.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

struct Grid {
  const float* pos;             // [M, 3] sorted by cell
  const int* cell;              // [M] sorted keys
  const unsigned char* valid;   // [M]
  const float* radius;          // [M] (beam mode)
  int M;
  int gr;
  float gx, gy, gz;             // grid_min
  float inv;                    // inv_cell
  float h;                      // 1 / inv_cell (beam mode)
  int mpc;                      // max_per_cell
  int n_steps;                  // beam mode
};

struct Lanes {
  const float* a;               // p (surface) or o (beam) [N, 3]
  const float* d;               // d [N, 3] (beam)
  const float* s;               // r2 (surface) or t_end (beam) [N]
  int N;
  int lane0;                    // the chunk's first lane (written ids)
  const long long* offs;        // [N] exclusive starts (write pass)
  long long base;               // offs of the chunk's first lane
  int* count;                   // [N] (count pass)
  int* lane_out;                // [P]
  int* idx_out;                 // [P]
  int* sc_out;                  // [P] step * 27 + cell (beam)
};

__device__ __forceinline__ int cell_of(float p, float g, float inv) {
  const float f = __fmul_rn(__fsub_rn(p, g), inv);
  return __float2int_rz(fminf(fmaxf(f, -1e9f), 1e9f));
}

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <bool WRITE>
__global__ void __launch_bounds__(THREADS)
surface_kernel(const Grid G, const Lanes L) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= L.N) return;
  const float px = L.a[3 * i], py = L.a[3 * i + 1], pz = L.a[3 * i + 2];
  const float r2 = L.s[i];
  long long w = WRITE ? L.offs[i] - L.base : 0;
  int n = 0;
  if (isfinite(px) && isfinite(py) && isfinite(pz)) {
    const int qx = cell_of(px, G.gx, G.inv);
    const int qy = cell_of(py, G.gy, G.inv);
    const int qz = cell_of(pz, G.gz, G.inv);
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          const int cx = qx + dx, cy = qy + dy, cz = qz + dz;
          if (cx < 0 || cx >= G.gr || cy < 0 || cy >= G.gr || cz < 0 ||
              cz >= G.gr)
            continue;
          const int key = (cx * G.gr + cy) * G.gr + cz;
          const int start = lower_bound(G.cell, G.M, key);
          for (int j = 0; j < G.mpc; ++j) {
            const int idx = min(start + j, G.M - 1);
            if (__ldg(G.cell + idx) != key) break;
            if (!__ldg(G.valid + idx)) continue;
            const float ex = __fsub_rn(__ldg(G.pos + 3 * idx), px);
            const float ey = __fsub_rn(__ldg(G.pos + 3 * idx + 1), py);
            const float ez = __fsub_rn(__ldg(G.pos + 3 * idx + 2), pz);
            const float d2 = __fadd_rn(
                __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                __fmul_rn(ez, ez));
            if (d2 < r2) {
              if (WRITE) {
                L.lane_out[w] = L.lane0 + i;
                L.idx_out[w] = idx;
                ++w;
              } else {
                ++n;
              }
            }
          }
        }
  }
  if (!WRITE) L.count[i] = n;
}

template <bool WRITE>
__global__ void __launch_bounds__(THREADS)
beam_kernel(const Grid G, const Lanes L) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= L.N) return;
  const float ox = L.a[3 * i], oy = L.a[3 * i + 1], oz = L.a[3 * i + 2];
  const float vx = L.d[3 * i], vy = L.d[3 * i + 1], vz = L.d[3 * i + 2];
  const float t_end = L.s[i];
  long long w = WRITE ? L.offs[i] - L.base : 0;
  int n = 0;
  for (int j = 0; j < G.n_steps; ++j) {
    const float jf = (float)j;
    const float lo_t = __fmul_rn(jf, G.h);
    if (lo_t >= t_end) break;
    const float hi_t = __fadd_rn(lo_t, G.h);
    const float t_mid = __fmul_rn(__fadd_rn(jf, 0.5f), G.h);
    const int qx = cell_of(__fadd_rn(ox, __fmul_rn(vx, t_mid)), G.gx, G.inv);
    const int qy = cell_of(__fadd_rn(oy, __fmul_rn(vy, t_mid)), G.gy, G.inv);
    const int qz = cell_of(__fadd_rn(oz, __fmul_rn(vz, t_mid)), G.gz, G.inv);
    int c = 0;
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz, ++c) {
          const int cx = qx + dx, cy = qy + dy, cz = qz + dz;
          if (cx < 0 || cx >= G.gr || cy < 0 || cy >= G.gr || cz < 0 ||
              cz >= G.gr)
            continue;
          const int key = (cx * G.gr + cy) * G.gr + cz;
          const int start = lower_bound(G.cell, G.M, key);
          for (int s = 0; s < G.mpc; ++s) {
            const int idx = min(start + s, G.M - 1);
            if (__ldg(G.cell + idx) != key) break;
            if (!__ldg(G.valid + idx)) continue;
            const float rx = __fsub_rn(__ldg(G.pos + 3 * idx), ox);
            const float ry = __fsub_rn(__ldg(G.pos + 3 * idx + 1), oy);
            const float rz = __fsub_rn(__ldg(G.pos + 3 * idx + 2), oz);
            const float foot = __fadd_rn(
                __fadd_rn(__fmul_rn(rx, vx), __fmul_rn(ry, vy)),
                __fmul_rn(rz, vz));
            const float rr = __fadd_rn(
                __fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)),
                __fmul_rn(rz, rz));
            const float b2 = __fsub_rn(rr, __fmul_rn(foot, foot));
            const float r = __ldg(G.radius + idx);
            const float r2 = __fmul_rn(r, r);
            if (foot >= lo_t && foot < hi_t && b2 < r2 && foot > 0.0f &&
                foot < t_end) {
              if (WRITE) {
                L.lane_out[w] = L.lane0 + i;
                L.idx_out[w] = idx;
                L.sc_out[w] = j * 27 + c;
                ++w;
              } else {
                ++n;
              }
            }
          }
        }
  }
  if (!WRITE) L.count[i] = n;
}

}  // namespace

extern "C" {

// beam: 0 surface (a = p, s = r2), 1 beam (a = o, d, s = t_end). write: 0
// the count pass (count [N] int32 written), 1 the write pass (offs [N]
// int64 exclusive starts, base subtracted; lane_out, idx_out and, in beam
// mode, sc_out [P] int32 written). The grid: pos [M, 3] f32, cell [M]
// int32 sorted, valid [M] u8, radius [M] f32 (beam), grid_min (gx, gy,
// gz), inv_cell, h = 1 / inv_cell in f32, gr cells per axis.
int hairpt_photons(int beam, int write, const void* pos, const void* cell,
                   const void* valid, const void* radius, int M, int gr,
                   float gx, float gy, float gz, float inv, float h,
                   int mpc, int n_steps, const void* a, const void* d,
                   const void* s, int N, int lane0, const void* offs,
                   long long base, void* count, void* lane_out,
                   void* idx_out, void* sc_out, void* stream) {
  if (N <= 0) return 0;
  if (pos == nullptr || cell == nullptr || valid == nullptr || a == nullptr ||
      s == nullptr || M < 1 || gr < 1 || mpc < 1 ||
      (beam && (radius == nullptr || d == nullptr || n_steps < 0)) ||
      (write ? (offs == nullptr || lane_out == nullptr ||
                idx_out == nullptr || (beam && sc_out == nullptr))
             : count == nullptr))
    return (int)cudaErrorInvalidValue;
  const Grid G{(const float*)pos, (const int*)cell,
               (const unsigned char*)valid, (const float*)radius, M, gr,
               gx, gy, gz, inv, h, mpc, n_steps};
  const Lanes L{(const float*)a, (const float*)d, (const float*)s, N, lane0,
                (const long long*)offs, base, (int*)count, (int*)lane_out,
                (int*)idx_out, (int*)sc_out};
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (N + THREADS - 1) / THREADS;
  if (beam) {
    if (write)
      beam_kernel<true><<<blocks, THREADS, 0, st>>>(G, L);
    else
      beam_kernel<false><<<blocks, THREADS, 0, st>>>(G, L);
  } else {
    if (write)
      surface_kernel<true><<<blocks, THREADS, 0, st>>>(G, L);
    else
      surface_kernel<false><<<blocks, THREADS, 0, st>>>(G, L);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
