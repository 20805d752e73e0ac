// Octet-skipping and octet-stream phase-B kernels for Hopper (sm_90a).
//
// The two variants of the tiled phase B that work at the granularity of
// an octet: 8 consecutive rays of a 64-ray tile (rays 8o .. 8o+7). Plain
// C interface for ctypes; the PyTorch wrappers, their plain versions and
// the layout contract are in hairpt_torch/ops/tiled_kernels.py. Built
// like tiled.cu (nvcc -gencode arch=compute_90a,code=sm_90a -O3
// --fmad=false -shared), as a library of its own so the two build in
// parallel. The box cull, the box load and the block copy are kernel B's
// (slab.cuh).
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cyl_test.cuh"
#include "slab.cuh"

namespace {

using hairpt_dev::box_cull;
using hairpt_dev::copy_block;
using hairpt_dev::CullRay;
using hairpt_dev::f_inf;
using hairpt_dev::load_box;
using hairpt_dev::RayRegs;
using hairpt_dev::SegRegs;

constexpr int TILE = 64;          // rays per tile
constexpr int TE_INF = 4095;      // 12-bit "no further entry" sentinel
constexpr unsigned CID_MASK = (1u << 20) - 1;
constexpr int QBITS = 12;         // stream entry: slot q | bound << 12
constexpr unsigned QMASK = (1u << QBITS) - 1;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float dequant(int bq, float tmin, float tscale) {
  return (bq == TE_INF) ? f_inf() : tmin + (float)bq * tscale;
}

// the stop rule of both kernels: the ray is resolved against the bound
// te_next of the slots or entries still to come
__device__ __forceinline__ bool resolved(float best, float te_next,
                                         float tpm, int any_hit) {
  return any_hit ? (best < f_inf() || te_next > tpm)
                 : (best <= te_next || te_next > tpm);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, x));
  return v;
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
//     the ray goes on testing, a smaller t replaces its hit, and pid is
//     the hit's id, not 0/-1.
//
// What bounds it: operations, as kernel B (the same cylinder test, ~90
// f32 operations per ray and segment). An octet's bit is set when ANY of
// its 8 rays enters the box, so most (ray, slot) tests the bits leave
// are misses. Design: kernel B's (tiled.cu), with these rules:
//   * slot cull: rays 0..63 run kernel B's box test (box_cull) against the
//     slot's cluster box up to min(maxt, best) in BOTH modes, ANDed with
//     the ray's octet bit; a __ballot_sync gives the 64-bit active mask.
//     Kernel B's any-hit rule (skip a ray that holds a hit) is wrong here:
//     a later slot's smaller t replaces the hit and its pid;
//   * 128 threads, one per segment lane, walk the active rays; a warp
//     with a hit writes one record per (ray, warp): its minimum t and the
//     largest pid at it. After the slot each ray takes the minimum over
//     its records and the largest pid among the records at it, and
//     replaces its result iff that t is smaller: the per-slot reduction,
//     in no order of lanes or warps;
//   * a two-stage cp.async ring of segment blocks; the slot words are
//     read two slots ahead, so the copy of a slot whose octet word is 0
//     (no ray of the tile tests it) is skipped;
//   * the stop check is a __syncthreads_and after every slot.
// ---------------------------------------------------------------------------
constexpr int C_THREADS = 128;    // K lanes x 128/K rays

template <int K>
__global__ void __launch_bounds__(C_THREADS)
phase_b_oct_kernel(const int* __restrict__ slots,     // [T, q]
                   const int* __restrict__ cnt,       // [T]
                   const float* __restrict__ tmin,    // [T]
                   const float* __restrict__ tscale,  // [T]
                   const int* __restrict__ oct,       // [T, q]
                   const float* __restrict__ rays8,   // [T, 8, TILE]
                   const float* __restrict__ t_pmax,  // [T, TILE]
                   const float* __restrict__ seg_rows,  // [C, 16, K]
                   const float* __restrict__ bounds,  // [6, C]
                   int C, int q, int any_hit,
                   float* __restrict__ t_out,         // [T, TILE]
                   int* __restrict__ pid_out,         // [T, TILE]
                   int* __restrict__ pairs_run) {     // [T] or null
  constexpr int NW = K / 32;           // records per ray
  constexpr int G = C_THREADS / K;     // rays tested side by side
  __shared__ __align__(16) float s_blk[2][16 * K];  // segment block ring
  __shared__ float4 s_ray[TILE][2];    // o.xyz mint | d.xyz maxt
  __shared__ float s_rt[TILE][NW];     // per-slot records of each warp:
  __shared__ int s_rp[TILE][NW];       //   min t, the largest pid at it
  __shared__ unsigned s_hitw[TILE];    // warps with a record this slot
  __shared__ unsigned s_act[2][2];     // [slot parity] active-ray mask

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % K;
  const int grp = tid / K;
  const int w = lane >> 5;
  const int wl = tid & 31;
  const bool ray_thr = tid < TILE;
  const float inf = f_inf();
  const int n_q = cnt[tile];
  const int* sl = slots + (size_t)tile * q;
  const int* oc = oct + (size_t)tile * q;

  // rays 0..63: one per thread of the first two warps
  CullRay cr = {};
  float tpm = 0.0f;
  float best = inf;
  int bpid = -1;
  if (ray_thr) {
    const RayRegs y = hairpt_dev::load_ray(rays8 + (size_t)tile * 8 * TILE,
                                           TILE, tid);
    s_ray[tid][0] = make_float4(y.ox, y.oy, y.oz, y.mint);
    s_ray[tid][1] = make_float4(y.dx, y.dy, y.dz, y.maxt);
    cr = hairpt_dev::cull_ray(y.ox, y.oy, y.oz, y.dx, y.dy, y.dz, y.mint,
                              y.maxt);
    tpm = t_pmax[(size_t)tile * TILE + tid];
    s_hitw[tid] = 0u;
  }
  const float tm = tmin[tile], ts = tscale[tile];

  // slot s's word and octet word, and slot s + 1's (read a slot ahead of
  // its copy)
  unsigned pk = 0u, m8 = 0u, pk1 = 0u, m81 = 0u;
  if (n_q > 0) {
    pk = (unsigned)sl[0];
    m8 = (unsigned)oc[0];
  }
  if (n_q > 1) {
    pk1 = (unsigned)sl[1];
    m81 = (unsigned)oc[1];
  }
  float bx[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (m8 != 0u) {
    if (ray_thr) load_box(bounds, C, pk & CID_MASK, bx);
    copy_block<K, C_THREADS>(s_blk[0],
                             seg_rows + (size_t)(pk & CID_MASK) * 16 * K,
                             tid);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  int n_pairs = 0;
  for (int s = 0; s < n_q; ++s) {
    // 1. slot cull: the ray's octet bit and the slot's widened box
    if (ray_thr) {
      const bool pass = ((m8 >> (tid >> 3)) & 1u) &&
                        box_cull(cr, bx, fminf(cr.maxt, best));
      const unsigned b = __ballot_sync(FULL, pass);
      if (wl == 0) s_act[s & 1][tid >> 5] = b;
    }
    // 2. prefetch slot s + 1 (its block into the other stage, read last
    //    by slot s - 1's tests, which ended before its stop check) unless
    //    its octet word is 0; read slot s + 2's words
    const unsigned pk_s = pk;
    pk = pk1;
    m8 = m81;
    if (s + 1 < n_q && m8 != 0u) {
      const unsigned cid = pk & CID_MASK;
      if (ray_thr) load_box(bounds, C, cid, bx);
      copy_block<K, C_THREADS>(s_blk[(s + 1) & 1],
                               seg_rows + (size_t)cid * 16 * K, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if (s + 2 < n_q) {
      pk1 = (unsigned)sl[s + 2];
      m81 = (unsigned)oc[s + 2];
    }
    asm volatile("cp.async.wait_group 1;\n" ::);   // this slot's block
    __syncthreads();   // the block and the active mask are complete
    const unsigned a0 = s_act[s & 1][0], a1 = s_act[s & 1][1];
    if ((a0 | a1) != 0u) {
      if (tid == 0) n_pairs += __popc(a0) + __popc(a1);
      // 3. this thread's lane against its share of the active rays
      const SegRegs g = hairpt_dev::load_seg<K>(s_blk[s & 1], lane);
      unsigned long long m = a0 | ((unsigned long long)a1 << 32);
      for (int i = 0; i < grp; ++i) m &= m - 1;
      while (m != 0ull) {
        const int r = __ffsll((long long)m) - 1;
        const float4 ra = s_ray[r][0], rb = s_ray[r][1];
        const RayRegs y = {ra.x, ra.y, ra.z, rb.x, rb.y, rb.z, ra.w, rb.w};
        float t;
        const bool hit = hairpt_dev::cyl_hit_seg(g, y, t);
        if (__ballot_sync(FULL, hit) != 0u) {
          const float wm = warp_min(hit ? t : inf);
          const int pa = __reduce_max_sync(FULL,
                                           (hit && t == wm) ? g.pid : -1);
          if (wl == 0) {
            s_rt[r][w] = wm;
            s_rp[r][w] = pa;
            atomicOr(&s_hitw[r], 1u << w);
          }
        }
#pragma unroll
        for (int i = 0; i < G; ++i) m &= m - 1;
      }
      __syncthreads();   // every record of the slot is written
      // 4. the slot's (minimum t, largest pid at it) replaces a larger t
      if (ray_thr && s_hitw[tid] != 0u) {
        const unsigned hw = s_hitw[tid];
        float st = inf;
#pragma unroll
        for (int v = 0; v < NW; ++v)
          if ((hw >> v) & 1u) st = fminf(st, s_rt[tid][v]);
        if (st < best) {
          int sp = -1;
#pragma unroll
          for (int v = 0; v < NW; ++v)
            if (((hw >> v) & 1u) && s_rt[tid][v] == st)
              sp = max(sp, s_rp[tid][v]);
          best = st;
          bpid = sp;
        }
        s_hitw[tid] = 0u;
      }
    }
    // 5. stop once every ray is resolved against this slot's bound
    bool done = true;
    if (ray_thr)
      done = resolved(best, dequant((int)((pk_s >> 20) & TE_INF), tm, ts),
                      tpm, any_hit);
    if (__syncthreads_and(done)) break;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);   // no copy outlives the block
  if (tid == 0 && pairs_run != nullptr) pairs_run[tile] = n_pairs;
  if (ray_thr) {
    t_out[(size_t)tile * TILE + tid] = best;
    pid_out[(size_t)tile * TILE + tid] = bpid;
  }
}

// ---------------------------------------------------------------------------
// Kernel D: octet-stream phase B.
//
// Replaces hairpt/ops/pallas_tiled.py::_stream_kernel (called through
// stream_phase_b, pallas_tiled.py:854). Octet o of tile t walks its own
// compacted stream streams[t, o, 0:len), len = off[t, n_win, o]; entry j
// packs a slot index (low 12 bits, into cids[t]) with the 12-bit
// floor-quantized entry bound of the stream's NEXT entry (4095 = +inf on
// the last). Per entry the octet's rays take kernel C's per-slot
// reduction and replace their result on a strictly smaller t; after each
// entry the octet stops once all 8 rays are resolved against that entry's
// bound (closest: best <= bound or bound > t_pmax; any hit: best finite
// or bound > t_pmax). The JAX kernel checks after groups of `unroll`
// entries; that cannot change a closest-hit result (a later entry of a
// resolved octet can only hit at t >= its bound >= best, and an equal t
// never replaces), so this kernel checks after every entry, and in any-hit
// mode only the hit flags are the same for every unroll.
//
// What bounds it: operations (the cylinder tests of the entries' rays)
// and the latency of each entry's loads: its word, its cluster id, its
// box and its [16, K] block, one after the other. Design:
//   * one warp per octet (8 warps per tile), so a warp's loop is its own
//     octet's stream and nothing else;
//   * the entries' words, cluster ids and boxes are loaded 32 at a time,
//     lane l holding entry j0 + l (one coalesced read of the stream, then
//     32 independent gathers), and handed to the warp by __shfl_sync;
//   * per entry, lanes 0..7 run kernel B's box test (box_cull) of their
//     ray up to min(maxt, best), in both modes (kernel C's any-hit rule);
//     a __ballot_sync gives the active rays. Lane l reads segment lanes
//     l, l + 32, .. of the entry's block from global memory (coalesced
//     per row, served by L2 and L1) into registers only when a ray is
//     active (an L1 prefetch of the next entry's block gained nothing:
//     PERF.md);
//   * each lane tests its K/32 segment lanes against each active ray (read
//     by broadcast from shared memory); when a lane hits, the warp reduces
//     to (minimum t, largest pid at it), and the ray's lane replaces its
//     result iff that t is smaller;
//   * the stop check is an __all_sync of the 8 ray lanes after every
//     entry.
// ---------------------------------------------------------------------------
constexpr int D_WARPS = 8;                   // one per octet
constexpr int D_THREADS = 32 * D_WARPS;
// three blocks per SM (at most 80 registers, a few bytes spilled at K =
// 128) ran 3-4% faster on both waves than two at 128 registers, and
// loading one segment lane at a time (fewer registers) 5-19% slower
// (PERF.md)
constexpr int D_MIN_BLOCKS = 3;

template <int K>
__global__ void __launch_bounds__(D_THREADS, D_MIN_BLOCKS)
stream_kernel(const int* __restrict__ cids,      // [T, q]
              const int* __restrict__ streams,   // [T, 8, qo]
              const int* __restrict__ off,       // [T, n_win + 1, 8]
              const float* __restrict__ tmin,    // [T]
              const float* __restrict__ tscale,  // [T]
              const float* __restrict__ rays8,   // [T, 8, TILE]
              const float* __restrict__ t_pmax,  // [T, TILE]
              const float* __restrict__ seg_rows,  // [C, 16, K]
              const float* __restrict__ bounds,  // [6, C]
              int C, int q, int qo, int n_win, int any_hit,
              float* __restrict__ t_out,         // [T, TILE]
              int* __restrict__ pid_out,         // [T, TILE]
              int* __restrict__ pairs_run) {     // [T] or null
  constexpr int NL = K / 32;                 // segment lanes per thread
  __shared__ float4 s_ray[TILE][2];          // o.xyz mint | d.xyz maxt
  __shared__ int s_pairs[D_WARPS];

  const int tile = blockIdx.x;
  const int o = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool ray_lane = lane < 8;
  const int r0 = 8 * o;                      // the octet's first ray
  const float inf = f_inf();

  CullRay cr = {};
  float tpm = 0.0f;
  float best = inf;
  int bpid = -1;
  if (ray_lane) {
    const RayRegs y = hairpt_dev::load_ray(rays8 + (size_t)tile * 8 * TILE,
                                           TILE, r0 + lane);
    s_ray[r0 + lane][0] = make_float4(y.ox, y.oy, y.oz, y.mint);
    s_ray[r0 + lane][1] = make_float4(y.dx, y.dy, y.dz, y.maxt);
    cr = hairpt_dev::cull_ray(y.ox, y.oy, y.oz, y.dx, y.dy, y.dz, y.mint,
                              y.maxt);
    tpm = t_pmax[(size_t)tile * TILE + r0 + lane];
  }
  __syncwarp();   // the octet's rays are staged (only its warp reads them)
  const int len = off[((size_t)tile * (n_win + 1) + n_win) * 8 + o];
  const int* st = streams + ((size_t)tile * 8 + o) * qo;
  const int* ci = cids + (size_t)tile * q;
  const float tm = tmin[tile], ts = tscale[tile];

  int n_pairs = 0;
  bool stop = false;
  for (int j0 = 0; j0 < len && !stop; j0 += 32) {
    // lane l holds entry j0 + l: its word, cluster id and box
    unsigned e_l = 0u, c_l = 0u;
    float b_l[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (j0 + lane < len) {
      e_l = (unsigned)__ldg(st + j0 + lane);
      c_l = (unsigned)__ldg(ci + (e_l & QMASK)) & CID_MASK;
      load_box(bounds, C, c_l, b_l);
    }
    const int n = min(32, len - j0);
    for (int i = 0; i < n; ++i) {
      const unsigned e = __shfl_sync(FULL, e_l, i);
      const unsigned cid = __shfl_sync(FULL, c_l, i);
      float bx[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) bx[k] = __shfl_sync(FULL, b_l[k], i);
      // 1. entry cull: each ray against the entry's widened box
      const bool pass = ray_lane && box_cull(cr, bx, fminf(cr.maxt, best));
      unsigned m = __ballot_sync(FULL, pass);
      if (m != 0u) {
        n_pairs += __popc(m);
        // 2. this lane's K/32 segment lanes of the block, in registers
        const float* blk = seg_rows + (size_t)cid * 16 * K;
        SegRegs g[NL];
#pragma unroll
        for (int u = 0; u < NL; ++u)
          g[u] = hairpt_dev::load_seg<K>(blk, lane + 32 * u);
        // 3. each active ray: the lane's minimum t and the largest pid at
        //    it, then the warp's
        while (m != 0u) {
          const int r = __ffs(m) - 1;
          m &= m - 1;
          const float4 ra = s_ray[r0 + r][0], rb = s_ray[r0 + r][1];
          const RayRegs y = {ra.x, ra.y, ra.z, rb.x, rb.y, rb.z, ra.w, rb.w};
          float lt = inf;
          int lp = -1;
#pragma unroll
          for (int u = 0; u < NL; ++u) {
            float t;
            if (hairpt_dev::cyl_hit_seg(g[u], y, t)) {
              if (t < lt) {
                lt = t;
                lp = g[u].pid;
              } else if (t == lt) {
                lp = max(lp, g[u].pid);
              }
            }
          }
          if (__ballot_sync(FULL, lt < inf) != 0u) {
            const float wm = warp_min(lt);
            const int pm = __reduce_max_sync(FULL, lt == wm ? lp : -1);
            if (lane == r && wm < best) {
              best = wm;
              bpid = pm;
            }
          }
        }
      }
      // 4. stop once the octet's rays are resolved against the bound
      const bool done =
          !ray_lane ||
          resolved(best, dequant((int)((e >> QBITS) & TE_INF), tm, ts), tpm,
                   any_hit);
      if (__all_sync(FULL, done)) {
        stop = true;
        break;
      }
    }
  }
  if (ray_lane) {
    t_out[(size_t)tile * TILE + r0 + lane] = best;
    pid_out[(size_t)tile * TILE + r0 + lane] = bpid;
  }
  if (pairs_run != nullptr) {
    if (lane == 0) s_pairs[o] = n_pairs;
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
#pragma unroll
      for (int v = 0; v < D_WARPS; ++v) sum += s_pairs[v];
      pairs_run[tile] = sum;
    }
  }
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

// pairs_run (optional) receives each tile's count of (ray, slot) pairs
// that passed the slot cull
int hairpt_phase_b_oct(const void* slots, const void* cnt, const void* tmin,
                       const void* tscale, const void* oct,
                       const void* rays8, const void* t_pmax,
                       const void* seg_rows, const void* bounds, int T,
                       int q, int K, int C, int any_hit, void* t_out,
                       void* pid_out, void* pairs_run, void* stream) {
  if (T <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define HAIRPT_C(KK)                                                       \
  phase_b_oct_kernel<KK><<<T, C_THREADS, 0, st>>>(                         \
      (const int*)slots, (const int*)cnt, (const float*)tmin,              \
      (const float*)tscale, (const int*)oct, (const float*)rays8,          \
      (const float*)t_pmax, (const float*)seg_rows, (const float*)bounds,  \
      C, q, any_hit, (float*)t_out, (int*)pid_out, (int*)pairs_run);       \
  return (int)cudaGetLastError();
  HAIRPT_K_SWITCH(HAIRPT_C)
#undef HAIRPT_C
}

// pairs_run (optional) receives each tile's count of (ray, entry) pairs
// that passed the entry cull
int hairpt_stream(const void* cids, const void* streams, const void* off,
                  const void* tmin, const void* tscale, const void* rays8,
                  const void* t_pmax, const void* seg_rows,
                  const void* bounds, int T, int q, int qo, int n_win, int K,
                  int C, int any_hit, void* t_out, void* pid_out,
                  void* pairs_run, void* stream) {
  if (T <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define HAIRPT_D(KK)                                                       \
  stream_kernel<KK><<<T, D_THREADS, 0, st>>>(                              \
      (const int*)cids, (const int*)streams, (const int*)off,              \
      (const float*)tmin, (const float*)tscale, (const float*)rays8,       \
      (const float*)t_pmax, (const float*)seg_rows, (const float*)bounds,  \
      C, q, qo, n_win, any_hit, (float*)t_out, (int*)pid_out,              \
      (int*)pairs_run);                                                    \
  return (int)cudaGetLastError();
  HAIRPT_K_SWITCH(HAIRPT_D)
#undef HAIRPT_D
}

}  // extern "C"
