// Cluster-chunk phase-B kernel of the swept traversal for Hopper (sm_90a).
//
// Plain C interface for ctypes; the PyTorch wrapper, its plain version and
// the layout contract are in hairpt_torch/ops/phaseb_kernels.py. Built
// like tiled.cu (nvcc -gencode arch=compute_90a,code=sm_90a -O3
// --fmad=false -shared), as a library of its own so the builds run in
// parallel. The entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cyl_test.cuh"

namespace {

using hairpt_dev::f_inf;
using hairpt_dev::RayRegs;
using hairpt_dev::SegRegs;

constexpr int MAX_CH = 256;   // rays per chunk the launch accepts
constexpr int SUBK = 32;      // segments per sub-cluster (one warp)
constexpr int CHUNKS_PER_BLOCK = 4;   // consecutive chunks one block walks
constexpr unsigned FULL = 0xffffffffu;
// The sub-box cull's margin, relative to the coordinates' magnitude:
// kernel B's BOX_PAD (tiled.cu), for the same reason (a grazing hit the
// lane test accepts may lie a few ulp outside its segment's exact box);
// phaseb_kernels.SUB_PAD is the same number, and
// tests/test_torch_swept_kernels.py shows hits the unwidened cull loses.
constexpr float SUB_PAD = 1.0f / 65536.0f;

// ---------------------------------------------------------------------------
// Kernel E: miter-cylinder tests of chunks of rays against one cluster.
//
// Replaces hairpt/ops/pallas_phaseb.py::_phaseb_kernel / _phaseb_one
// (called through phase_b_pallas, pallas_phaseb.py:186). The swept
// traversal sorts its (ray, cluster) pairs by cluster and pads each
// cluster's run to whole chunks of CH pairs, so chunk i holds CH rays
// (chunk_rays[i], padding lanes with maxt = -1) that all go to cluster
// chunk_cl[i]; the live chunks come first, one cluster's chunks next to
// each other. Each ray gets the closest hit over the cluster's K
// segments with the JAX kernel's tie rule: the minimum t and, among the
// lanes at that t, the largest pid (a lane whose t is not finite holds
// no pid). A dead chunk (cluster -1) writes misses and loads nothing. The
// arithmetic is _phaseb_one's (two divisions by a, miter planes through
// the hit point), not the tiled kernels'.
//
// What bounds it: operations. A chunk's CH rays all enter the cluster's
// box, but each enters only some of its K / 32 sub-clusters' boxes, and
// a lane with maxt < mint (padding) can hit nothing; testing every lane
// against all K segments (the first design: one block per chunk, one
// thread per ray) spent most of its ~105 f32 operations per test on
// pairs that cannot hit. Design:
//   * a block of K threads, thread l holding segment l in registers; it
//     walks CHUNKS_PER_BLOCK consecutive chunks and reloads its segment
//     only when the cluster changes (one cluster's chunks are adjacent;
//     1, 2, 8 and 16 chunks per block were slower on an H100, PERF.md);
//   * sub-box cull: each (ray, sub-cluster) pair of a chunk runs kernel
//     A's slab test against the sub-cluster's box (SweptHair.sub_lo /
//     sub_hi, the union of its segments' exact boxes) widened by SUB_PAD
//     times the larger of the ray origin's and the box's largest
//     |coordinate|; a lane with maxt < mint fails it, a ray with a
//     non-finite o, d or 1/d component passes it. __ballot_sync makes one
//     active-ray mask per sub-cluster;
//   * warp w is sub-cluster w: its 32 threads (one segment each) walk the
//     rays of its mask, reading each ray by broadcast from shared memory,
//     so every thread works on a (ray, segment) pair that can hit;
//   * pretest (cyl_may_hit_chunk): a ray whose distance to every lane's
//     axis provably exceeds r skips the divisions, the square root and
//     the miter planes (an H100's swept wave: 21.8 -> 17.6 ms of kernel
//     E, PERF.md). Hits
//     are rare: a warp reduces only when __ballot_sync(hit) != 0, to one
//     record per (ray, warp): its minimum t and the largest pid among its
//     lanes at that t with t finite. Each ray then merges its records
//     (the minimum, then the largest pid among the records at it), which
//     no order of lanes or warps changes.
// ---------------------------------------------------------------------------

// false only if the ray cannot hit a segment inside the box lo, hi
__device__ __forceinline__ bool sub_pass(const float* __restrict__ lo,
                                         const float* __restrict__ hi,
                                         const RayRegs& y) {
  if (!(y.maxt >= y.mint)) return false;   // padding: nothing can hit
  const float o[3] = {y.ox, y.oy, y.oz};
  const float d[3] = {y.dx, y.dy, y.dz};
  float inv[3];
  bool fin = true;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    float dd = d[ax];
    if (fabsf(dd) < 1e-12f) dd = (dd >= 0.0f) ? 1e-12f : -1e-12f;
    inv[ax] = 1.0f / dd;
    fin = fin && isfinite(o[ax]) && isfinite(d[ax]) && isfinite(inv[ax]);
  }
  if (!fin) return true;
  const float b[6] = {lo[0], lo[1], lo[2], hi[0], hi[1], hi[2]};
  float mag = fabsf(o[0]), bmag = fabsf(b[0]);
#pragma unroll
  for (int i = 1; i < 3; ++i) mag = fmaxf(mag, fabsf(o[i]));
#pragma unroll
  for (int i = 1; i < 6; ++i) bmag = fmaxf(bmag, fabsf(b[i]));
  const float pad = SUB_PAD * (mag + bmag);
  float tn = 0.0f, tf = 0.0f;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float a0 = ((b[ax] - pad) - o[ax]) * inv[ax];
    const float a1 = ((b[3 + ax] + pad) - o[ax]) * inv[ax];
    const float lo_ax = fminf(a0, a1);
    const float hi_ax = fmaxf(a0, a1);
    tn = (ax == 0) ? lo_ax : fmaxf(tn, lo_ax);
    tf = (ax == 0) ? hi_ax : fminf(tf, hi_ax);
  }
  tf = tf * 1.00000024f + 1e-7f;
  return (tn <= tf) && (tf >= y.mint) && (tn <= y.maxt);
}

template <int K>
__global__ void __launch_bounds__(K)
chunk_kernel(const int* __restrict__ chunk_cl,       // [n_chunks]
             const float* __restrict__ chunk_rays,   // [n_chunks, 8, CH]
             const float* __restrict__ seg_rows,     // [C, 16, K]
             const float* __restrict__ sub_lo,       // [C * K / 32, 3]
             const float* __restrict__ sub_hi,       // [C * K / 32, 3]
             int n_chunks, int ch,
             float* __restrict__ t_out,              // [n_chunks, CH]
             int* __restrict__ pid_out) {            // [n_chunks, CH]
  constexpr int NS = K / SUBK;        // sub-clusters = warps
  constexpr int AW = MAX_CH / 32;     // mask words per sub-cluster
  __shared__ float4 s_ray[MAX_CH][2];    // o.xyz mint | d.xyz maxt
  __shared__ unsigned s_act[NS][AW];     // rays passing each sub-box
  __shared__ float s_rt[MAX_CH][NS];     // per (ray, warp) records:
  __shared__ int s_rp[MAX_CH][NS];       //   min t, largest pid at it
  __shared__ unsigned s_hitm[MAX_CH];    // warps with a record

  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const int w = tid >> 5;
  const float inf = f_inf();
  const int chp = (ch + 31) & ~31;       // CH in whole warps
  const int c_begin = blockIdx.x * CHUNKS_PER_BLOCK;
  const int c_end = min(n_chunks, c_begin + CHUNKS_PER_BLOCK);
  for (int r = tid; r < MAX_CH; r += K) s_hitm[r] = 0u;
  __syncthreads();

  int cur = -1;
  SegRegs g = {};
  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    const int cl = chunk_cl[chunk];
    float* to = t_out + (size_t)chunk * ch;
    int* po = pid_out + (size_t)chunk * ch;
    if (cl < 0) {
      for (int r = tid; r < ch; r += K) {
        to[r] = inf;
        po[r] = -1;
      }
      continue;
    }
    if (cl != cur) {   // this thread's segment of the chunk's cluster
      cur = cl;
      g = hairpt_dev::load_seg<K>(seg_rows + (size_t)cl * 16 * K, tid);
    }
    // 1. stage the rays; the sub-box cull of every (ray, sub-cluster)
    const float* r8 = chunk_rays + (size_t)chunk * 8 * ch;
    for (int p = tid; p < NS * chp; p += K) {   // warp-uniform trip count
      const int s = p / chp;
      const int r = p - s * chp;
      bool pass = false;
      if (r < ch) {
        const RayRegs y = hairpt_dev::load_ray(r8, ch, r);
        if (s == 0) {
          s_ray[r][0] = make_float4(y.ox, y.oy, y.oz, y.mint);
          s_ray[r][1] = make_float4(y.dx, y.dy, y.dz, y.maxt);
        }
        const size_t sb = ((size_t)cl * NS + s) * 3;
        pass = sub_pass(sub_lo + sb, sub_hi + sb, y);
      }
      const unsigned b = __ballot_sync(FULL, pass);
      if (wl == 0) s_act[s][r >> 5] = b;
    }
    __syncthreads();
    // 2. warp w: its segments against the rays that enter its sub-box
    for (int aw = 0; aw < (chp >> 5); ++aw) {
      unsigned m = s_act[w][aw];
      while (m != 0u) {
        const int r = (aw << 5) + __ffs(m) - 1;
        m &= m - 1u;
        const float4 ra = s_ray[r][0], rb = s_ray[r][1];
        const RayRegs y = {ra.x, ra.y, ra.z, rb.x, rb.y, rb.z, ra.w, rb.w};
        const bool maybe = hairpt_dev::cyl_may_hit_chunk(g, y);
        if (__ballot_sync(FULL, maybe) == 0u) continue;
        float t = 0.0f;
        const bool hit = maybe && hairpt_dev::cyl_hit_chunk(g, y, t);
        if (__ballot_sync(FULL, hit) != 0u) {
          float wm = hit ? t : inf;
#pragma unroll
          for (int x = 16; x > 0; x >>= 1)
            wm = fminf(wm, __shfl_xor_sync(FULL, wm, x));
          const bool at = hit && t == wm && t < inf && t > -inf;
          const int pa = __reduce_max_sync(FULL, at ? g.pid : -1);
          if (wl == 0) {
            s_rt[r][w] = wm;
            s_rp[r][w] = pa;
            atomicOr(&s_hitm[r], 1u << w);
          }
        }
      }
    }
    __syncthreads();
    // 3. each ray merges its records
    for (int r = tid; r < ch; r += K) {
      const unsigned hm = s_hitm[r];
      float best = inf;
      int bp = -1;
      if (hm != 0u) {
        s_hitm[r] = 0u;
#pragma unroll
        for (int s = 0; s < NS; ++s)
          if ((hm >> s) & 1u) best = fminf(best, s_rt[r][s]);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          if (((hm >> s) & 1u) && s_rt[r][s] == best)
            bp = max(bp, s_rp[r][s]);
      }
      to[r] = best;
      po[r] = bp;
    }
  }
}

}  // namespace

extern "C" {

int hairpt_phase_b_chunks(const void* chunk_cl, const void* chunk_rays,
                          const void* seg_rows, const void* sub_lo,
                          const void* sub_hi, int n_chunks, int ch, int K,
                          void* t_out, void* pid_out, void* stream) {
  if (n_chunks <= 0) return 0;
  if (ch <= 0 || ch > MAX_CH) return (int)cudaErrorInvalidValue;
  const int blocks = (n_chunks + CHUNKS_PER_BLOCK - 1) / CHUNKS_PER_BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
#define HAIRPT_E(KK)                                                      \
  case KK:                                                                \
    chunk_kernel<KK><<<blocks, KK, 0, st>>>(                              \
        (const int*)chunk_cl, (const float*)chunk_rays,                   \
        (const float*)seg_rows, (const float*)sub_lo,                     \
        (const float*)sub_hi, n_chunks, ch, (float*)t_out,                \
        (int*)pid_out);                                                   \
    return (int)cudaGetLastError();
  switch (K) {
    HAIRPT_E(32)
    HAIRPT_E(64)
    HAIRPT_E(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HAIRPT_E
}

}  // extern "C"
