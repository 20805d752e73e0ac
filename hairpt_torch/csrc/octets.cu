// Octet-skipping and octet-stream phase-B kernels for Hopper (sm_90a).
//
// The two variants of the tiled phase B that work at the granularity of
// an octet: 8 consecutive rays of a 64-ray tile (rays 8o .. 8o+7). Plain
// C interface for ctypes; the PyTorch wrappers, their plain versions and
// the layout contract are in hairpt_torch/ops/tiled_kernels.py. Built
// like tiled.cu (nvcc -gencode arch=compute_90a,code=sm_90a -O3
// --fmad=false -shared), as a library of its own so the two build in
// parallel.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cyl_test.cuh"

namespace {

using hairpt_dev::f_inf;
using hairpt_dev::RayRegs;

constexpr int TILE = 64;          // rays per tile
constexpr int TE_INF = 4095;      // 12-bit "no further entry" sentinel
constexpr unsigned CID_MASK = (1u << 20) - 1;
constexpr int QBITS = 12;         // stream entry: slot q | bound << 12
constexpr unsigned QMASK = (1u << QBITS) - 1;

// One cluster's closest hit for one ray, with the octet kernels' per-slot
// reduction (_cyl_test_oct, pallas_tiled.py:213): the minimum t over the
// K lanes and, among the lanes at that t, the largest pid.
template <int K>
__device__ __forceinline__ void slot_best(const float* __restrict__ rows,
                                          const RayRegs& y, float& st,
                                          int& sp) {
  st = f_inf();
  sp = -1;
#pragma unroll 8
  for (int l = 0; l < K; ++l) {
    float t;
    int pid;
    if (hairpt_dev::cyl_hit_tiled<K>(rows, l, y, t, pid)) {
      if (t < st) {
        st = t;
        sp = pid;
      } else if (t == st) {
        sp = max(sp, pid);
      }
    }
  }
}

__device__ __forceinline__ float dequant(int bq, float tmin, float tscale) {
  return (bq == TE_INF) ? f_inf() : tmin + (float)bq * tscale;
}

// ---------------------------------------------------------------------------
// Kernel C: octet-skipping phase B.
//
// Replaces hairpt/ops/pallas_tiled.py::_tiled_kernel_oct (called through
// _tiled_phase_b_oct_impl, pallas_tiled.py:1116; math _cyl_test_oct,
// :213). Each tile walks its cnt[t] packed slots in entry-t order like
// kernel B, but a ray tests a slot only if its octet's bit is set in the
// slot's octet word oct[t, s]. Results equal the JAX kernel's, whose rules
// differ from kernel B's deferred form:
//   * the reduction is per slot (minimum t, then the largest pid among
//     the lanes at that t), and a slot replaces the ray's result only on
//     a strictly smaller t, so on equal t the earlier slot wins;
//   * the tile stops after every slot once each ray is resolved against
//     that slot's bound (best <= bound, or bound > t_pmax);
//   * any_hit changes only the stop rule (best finite, or bound > t_pmax):
//     the ray goes on testing, and pid is the hit's id, not 0/-1.
//
// What bounds it: operations, as kernel B (the same cylinder test, ~90
// f32 operations per ray and segment, on the slot-tests the octet bits
// leave). A warp holds four octets: a clear bit idles its 8 lanes, and
// only a slot whose four bits are all clear for a warp saves that warp's
// time. Design: kernel B's (one block per tile, one thread per ray, the
// slot's [16, K] block staged in shared memory); a slot no octet needs is
// not loaded.
// ---------------------------------------------------------------------------
template <int K>
__global__ void __launch_bounds__(TILE)
phase_b_oct_kernel(const int* __restrict__ slots,     // [T, q]
                   const int* __restrict__ cnt,       // [T]
                   const float* __restrict__ tmin,    // [T]
                   const float* __restrict__ tscale,  // [T]
                   const int* __restrict__ oct,       // [T, q]
                   const float* __restrict__ rays8,   // [T, 8, TILE]
                   const float* __restrict__ t_pmax,  // [T, TILE]
                   const float* __restrict__ seg_rows,  // [C, 16, K]
                   int q, int any_hit,
                   float* __restrict__ t_out,         // [T, TILE]
                   int* __restrict__ pid_out) {       // [T, TILE]
  __shared__ __align__(16) float s_rows[16 * K];

  const int tile = blockIdx.x;
  const int r = threadIdx.x;
  const int o = r >> 3;
  const RayRegs y = hairpt_dev::load_ray(rays8 + (size_t)tile * 8 * TILE,
                                         TILE, r);
  const float tpm = t_pmax[(size_t)tile * TILE + r];
  const int n_q = cnt[tile];
  const int* sl = slots + (size_t)tile * q;
  const int* oc = oct + (size_t)tile * q;
  const float tm = tmin[tile], ts = tscale[tile];
  const float inf = f_inf();

  float best = inf;
  int bpid = -1;
  for (int s = 0; s < n_q; ++s) {
    const unsigned packed = (unsigned)sl[s];
    const unsigned m8 = (unsigned)oc[s];
    if (m8 != 0u) {
      const float4* src = reinterpret_cast<const float4*>(
          seg_rows + (size_t)(packed & CID_MASK) * 16 * K);
      float4* dst = reinterpret_cast<float4*>(s_rows);
      __syncthreads();   // the previous slot's reads are done
      for (int i = r; i < 4 * K; i += TILE) dst[i] = src[i];
      __syncthreads();
      if ((m8 >> o) & 1u) {
        float st;
        int sp;
        slot_best<K>(s_rows, y, st, sp);
        if (st < best) {
          best = st;
          bpid = sp;
        }
      }
    }
    const float te_next = dequant((int)((packed >> 20) & TE_INF), tm, ts);
    const bool done = any_hit ? (best < inf || te_next > tpm)
                              : (best <= te_next || te_next > tpm);
    if (__syncthreads_and(done)) break;
  }
  t_out[(size_t)tile * TILE + r] = best;
  pid_out[(size_t)tile * TILE + r] = bpid;
}

// ---------------------------------------------------------------------------
// Kernel D: octet-stream phase B.
//
// Replaces hairpt/ops/pallas_tiled.py::_stream_kernel (called through
// stream_phase_b, pallas_tiled.py:854). Octet o of tile t walks its own
// compacted stream streams[t, o, 0:len), len = off[t, n_win, o]; entry j
// packs a slot index (low 12 bits, into cids[t]) with the 12-bit
// floor-quantized entry bound of the stream's NEXT entry (4095 = +inf on
// the last). Per entry the octet's rays take the per-slot reduction of
// kernel C and replace their result on a strictly smaller t; after each
// entry the octet stops once all 8 rays are resolved against that entry's
// bound (closest: best <= bound or bound > t_pmax; any hit: best finite
// or bound > t_pmax). The JAX kernel checks after groups of `unroll`
// entries; that cannot change a closest-hit result (a later entry of a
// resolved octet can only hit at t >= its bound >= best, and an equal t
// never replaces), so this kernel checks after every entry, and in any-hit
// mode only the hit flags are the same for every unroll.
//
// What bounds it: operations (the cylinder tests the octets run) and, on
// this design, the latency of global loads. The TPU kernel streamed
// windows of W slots through a two-window ring of 512 KB, which does not
// fit a block's 227 KB of shared memory, so nothing is staged: one block
// per tile, one thread per ray, each octet reading its entries' [16, K]
// blocks straight from global memory through the read-only path (the 8
// threads of an octet read the same address; a warp's four octets read
// up to four clusters). `off` is taken whole, as in the JAX call; only its
// last column (each stream's length) is read, and the port's query builds
// it with one window ([T, 2, 8]: 0 and the lengths).
// ---------------------------------------------------------------------------
template <int K>
__global__ void __launch_bounds__(TILE)
stream_kernel(const int* __restrict__ cids,      // [T, q]
              const int* __restrict__ streams,   // [T, 8, qo]
              const int* __restrict__ off,       // [T, n_win + 1, 8]
              const float* __restrict__ tmin,    // [T]
              const float* __restrict__ tscale,  // [T]
              const float* __restrict__ rays8,   // [T, 8, TILE]
              const float* __restrict__ t_pmax,  // [T, TILE]
              const float* __restrict__ seg_rows,  // [C, 16, K]
              int q, int qo, int n_win, int any_hit,
              float* __restrict__ t_out,         // [T, TILE]
              int* __restrict__ pid_out) {       // [T, TILE]
  const int tile = blockIdx.x;
  const int r = threadIdx.x;
  const int o = r >> 3;
  const unsigned omask = 0xFFu << ((r & 31) & ~7);   // the octet's lanes
  const RayRegs y = hairpt_dev::load_ray(rays8 + (size_t)tile * 8 * TILE,
                                         TILE, r);
  const float tpm = t_pmax[(size_t)tile * TILE + r];
  const int len = off[((size_t)tile * (n_win + 1) + n_win) * 8 + o];
  const int* st = streams + ((size_t)tile * 8 + o) * qo;
  const int* ci = cids + (size_t)tile * q;
  const float tm = tmin[tile], ts = tscale[tile];
  const float inf = f_inf();

  float best = inf;
  int bpid = -1;
  for (int j = 0; j < len; ++j) {
    const unsigned e = (unsigned)__ldg(st + j);
    const unsigned cid = (unsigned)__ldg(ci + (e & QMASK)) & CID_MASK;
    float et;
    int ep;
    slot_best<K>(seg_rows + (size_t)cid * 16 * K, y, et, ep);
    if (et < best) {
      best = et;
      bpid = ep;
    }
    const float te_next = dequant((int)((e >> QBITS) & TE_INF), tm, ts);
    const bool done = any_hit ? (best < inf || te_next > tpm)
                              : (best <= te_next || te_next > tpm);
    if (__all_sync(omask, done)) break;
  }
  t_out[(size_t)tile * TILE + r] = best;
  pid_out[(size_t)tile * TILE + r] = bpid;
}

#define HAIRPT_K_SWITCH(CALL)  \
  switch (K) {                 \
    case 32: CALL(32)          \
    case 64: CALL(64)          \
    case 128: CALL(128)        \
    default:                   \
      return (int)cudaErrorInvalidValue; \
  }

}  // namespace

extern "C" {

int hairpt_phase_b_oct(const void* slots, const void* cnt, const void* tmin,
                       const void* tscale, const void* oct,
                       const void* rays8, const void* t_pmax,
                       const void* seg_rows, int T, int q, int K,
                       int any_hit, void* t_out, void* pid_out,
                       void* stream) {
  if (T <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define HAIRPT_C(KK)                                                       \
  phase_b_oct_kernel<KK><<<T, TILE, 0, st>>>(                              \
      (const int*)slots, (const int*)cnt, (const float*)tmin,              \
      (const float*)tscale, (const int*)oct, (const float*)rays8,          \
      (const float*)t_pmax, (const float*)seg_rows, q, any_hit,            \
      (float*)t_out, (int*)pid_out);                                       \
  return (int)cudaGetLastError();
  HAIRPT_K_SWITCH(HAIRPT_C)
#undef HAIRPT_C
}

int hairpt_stream(const void* cids, const void* streams, const void* off,
                  const void* tmin, const void* tscale, const void* rays8,
                  const void* t_pmax, const void* seg_rows, int T, int q,
                  int qo, int n_win, int K, int any_hit, void* t_out,
                  void* pid_out, void* stream) {
  if (T <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define HAIRPT_D(KK)                                                       \
  stream_kernel<KK><<<T, TILE, 0, st>>>(                                   \
      (const int*)cids, (const int*)streams, (const int*)off,              \
      (const float*)tmin, (const float*)tscale, (const float*)rays8,       \
      (const float*)t_pmax, (const float*)seg_rows, q, qo, n_win, any_hit, \
      (float*)t_out, (int*)pid_out);                                       \
  return (int)cudaGetLastError();
  HAIRPT_K_SWITCH(HAIRPT_D)
#undef HAIRPT_D
}

}  // extern "C"
