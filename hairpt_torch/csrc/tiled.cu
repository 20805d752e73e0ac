// Tile-routed hair intersection kernels for Hopper (sm_90a).
//
// Two kernels, each the CUDA counterpart of one Pallas TPU kernel of the
// JAX package, with a plain C interface for ctypes (no PyTorch headers,
// so the build takes seconds). The PyTorch wrappers, their plain
// versions and the layout contract are in hairpt_torch/ops/tiled_kernels.py.
// The octet and stream variants of phase B are in octets.cu; the
// cylinder test is shared through cyl_test.cuh.
//
// Build (done at first use by hairpt_torch/ops/tiled_kernels.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC --fmad=false -o libhairpt_tiled.so tiled.cu
// --fmad=false keeps every multiply and add separately rounded, as the
// plain PyTorch versions (one elementwise operation per kernel) are, so
// kernel and plain version agree bit for bit.
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
constexpr int CULL_THREADS = 256; // clusters per phase-A block
constexpr int UNROLL = 8;         // phase-B slots between early-exit checks
constexpr int TE_INF = 4095;      // 12-bit "no further slot" sentinel
constexpr unsigned CID_MASK = (1u << 20) - 1;

// ---------------------------------------------------------------------------
// Kernel A: phase-A tile cull.
//
// Replaces hairpt/ops/pallas_tiled.py::_cull_kernel (called through
// cull_phase_a, pallas_tiled.py:1001). For each 64-ray tile and each
// cluster AABB it runs the slab test of every ray, and writes
//   te[t, c]     min over the tile's rays of max(entry t, 0), truncated
//                toward zero to bf16 (a lower bound); +inf for a miss,
//   t_pmax[t, r] each ray's largest entry t over its hit clusters
//                (-1 if none; the wrapper pre-fills -1).
// Fully dead tiles (no ray with maxt > mint) write inf and leave -1.
// The EMIT_OCT instance also writes
//   oct[t, c]    bit o set iff a ray of octet o (rays 8o..8o+7) enters
//                the box (pallas_tiled.py:940-948, the emit_oct output);
// the default instance has neither the register nor the store.
//
// What bounds it: operations. At the furball's main-path shapes (16,384
// tiles x 64 rays x ~7,875 clusters) the slab tests are ~0.2 TFLOP of
// f32 against a 258 MB bf16 te write, so the f32 rate and not memory is
// the limit. Design: one block per (tile, group of 256 clusters); the
// tile's 64 rays (origin, 1/d, mint, effective maxt) are staged once in
// shared memory and read by broadcast; each thread owns one cluster,
// keeps its six bounds in registers and loops over the 64 rays, so the
// inner loop is pure arithmetic. t_pmax is a per-ray maximum across
// clusters, i.e. across threads and blocks: a warp reduction
// (__reduce_max_sync on the float bits, valid because every value is -1
// or >= 0 and -0.0 is cleared to +0.0), a shared-memory atomicMax per
// warp and one global atomicMax per ray and block.
// ---------------------------------------------------------------------------
template <bool EMIT_OCT>
__global__ void __launch_bounds__(CULL_THREADS)
cull_kernel(const float* __restrict__ rays8,   // [T, 8, TILE]
            const float* __restrict__ bounds,  // [6, C] lo.xyz, hi.xyz
            int C, int n_cblk,
            uint16_t* __restrict__ te,         // [T, C] bf16 bits
            int* __restrict__ t_pmax,          // [T, TILE] float bits
            int* __restrict__ oct) {           // [T, C] (EMIT_OCT only)
  __shared__ float s_o[3][TILE];
  __shared__ float s_inv[3][TILE];
  __shared__ float s_mint[TILE];
  __shared__ float s_maxt[TILE];
  __shared__ int s_pmax[TILE];

  const int tile = blockIdx.x / n_cblk;
  const int c = (blockIdx.x % n_cblk) * CULL_THREADS + threadIdx.x;
  const float* r8 = rays8 + (size_t)tile * 8 * TILE;
  const int neg1 = __float_as_int(-1.0f);

  bool live_ray = false;
  if (threadIdx.x < TILE) {
    const int r = threadIdx.x;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      s_o[ax][r] = r8[ax * TILE + r];
      float d = r8[(3 + ax) * TILE + r];
      if (fabsf(d) < 1e-12f) d = (d >= 0.0f) ? 1e-12f : -1e-12f;
      s_inv[ax][r] = 1.0f / d;
    }
    const float mint = r8[6 * TILE + r];
    const float maxt = r8[7 * TILE + r];
    live_ray = maxt > mint;
    s_mint[r] = mint;
    s_maxt[r] = live_ray ? maxt : -f_inf();
    s_pmax[r] = neg1;
  }
  const int any_live = __syncthreads_or(live_ray);
  if (!any_live) {
    if (c < C) {
      te[(size_t)tile * C + c] = 0x7f80;   // bf16 +inf
      if (EMIT_OCT) oct[(size_t)tile * C + c] = 0;
    }
    return;
  }

  const bool valid = c < C;
  float lo[3], hi[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    lo[ax] = valid ? bounds[ax * C + c] : 3e37f;
    hi[ax] = valid ? bounds[(3 + ax) * C + c] : -3e37f;
  }
  const int lane = threadIdx.x & 31;
  float te_min = f_inf();
  unsigned oct_bits = 0u;
  for (int r = 0; r < TILE; ++r) {
    float tn = 0.0f, tf = 0.0f;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float a0 = (lo[ax] - s_o[ax][r]) * s_inv[ax][r];
      const float a1 = (hi[ax] - s_o[ax][r]) * s_inv[ax][r];
      const float lo_ax = fminf(a0, a1);
      const float hi_ax = fmaxf(a0, a1);
      tn = (ax == 0) ? lo_ax : fmaxf(tn, lo_ax);
      tf = (ax == 0) ? hi_ax : fminf(tf, hi_ax);
    }
    tf = tf * 1.00000024f + 1e-7f;
    const bool hit = valid && (tn <= tf) && (tf >= s_mint[r])
                     && (tn <= s_maxt[r]);
    const float tn0 = fmaxf(tn, 0.0f);
    if (hit) te_min = fminf(te_min, tn0);
    if (EMIT_OCT && hit) oct_bits |= 1u << (r >> 3);
    const int v = hit ? (__float_as_int(tn0) & 0x7fffffff) : neg1;
    const int m = __reduce_max_sync(0xffffffffu, v);
    if (lane == 0 && m != neg1) atomicMax(&s_pmax[r], m);
  }
  if (valid) {
    te[(size_t)tile * C + c] =
        (uint16_t)(__float_as_uint(te_min) >> 16);  // truncate toward 0
    if (EMIT_OCT) oct[(size_t)tile * C + c] = (int)oct_bits;
  }
  __syncthreads();
  if (threadIdx.x < TILE && s_pmax[threadIdx.x] != neg1)
    atomicMax(&t_pmax[(size_t)tile * TILE + threadIdx.x],
              s_pmax[threadIdx.x]);
}

// ---------------------------------------------------------------------------
// Kernel B: phase-B miter-cylinder test over each tile's slot list.
//
// Replaces hairpt/ops/pallas_tiled.py::_tiled_kernel (called through
// _tiled_phase_b_impl, pallas_tiled.py:1199; the math is _cyl_test_tm,
// pallas_tiled.py:37). Each tile walks its cnt[t] packed slots
// (cid | bq << 20, decoded as uint32) in entry-t order and tests all 64
// rays against the slot's K segments. Results match the deferred
// (HAIRPT_UNROLL=8) path of the JAX kernel exactly:
//   * per lane, the earliest slot wins on equal t (strict <); among the
//     lanes whose t equals the ray's best, the largest pid wins. A ray
//     keeps (best t, best pid, one bit per lane "this lane holds the
//     best t"), which is that rule without a [TILE, K] running matrix;
//   * the tile stops after a group of 8 slots once every ray is
//     resolved against the dequantized bound tmin + bq * tscale of the
//     group's last slot (bq == 4095 is +inf), or has no candidate left
//     (bound > its own t_pmax);
//   * any_hit: pid is 0/-1 and a ray skips the remaining slots once it
//     holds a finite hit.
//
// What bounds it: operations. Each (ray, segment) test is ~75 f32
// operations including a division and a square root; the bytes are one
// 8 KB segment block per slot, read by many tiles and served mostly by
// L2. Design: one block per tile, one thread per ray (64 threads); the
// slot's [16, K] block is staged in shared memory with float4 loads and
// read by broadcast, so the inner loop over K lanes is arithmetic on
// registers; K is a template parameter so the lane loop and the per-lane
// bit mask unroll into registers. The early exit is __syncthreads_and
// over the tile.
// ---------------------------------------------------------------------------
template <int K>
__global__ void __launch_bounds__(TILE)
phase_b_kernel(const int* __restrict__ slots,     // [T, q]
               const int* __restrict__ cnt,       // [T]
               const float* __restrict__ tmin,    // [T]
               const float* __restrict__ tscale,  // [T]
               const float* __restrict__ rays8,   // [T, 8, TILE]
               const float* __restrict__ t_pmax,  // [T, TILE]
               const float* __restrict__ seg_rows,  // [C, 16, K]
               int q, int any_hit,
               float* __restrict__ t_out,         // [T, TILE]
               int* __restrict__ pid_out,         // [T, TILE]
               int* __restrict__ slots_run) {     // [T] or null
  constexpr int NW = K / 32;
  __shared__ __align__(16) float s_rows[16 * K];

  const int tile = blockIdx.x;
  const int r = threadIdx.x;
  const RayRegs y = hairpt_dev::load_ray(rays8 + (size_t)tile * 8 * TILE,
                                         TILE, r);
  const float tpm = t_pmax[(size_t)tile * TILE + r];
  const int n_q = cnt[tile];
  const int* sl = slots + (size_t)tile * q;
  const float inf = f_inf();

  float best = inf;
  int bpid = -1;
  unsigned eq[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) eq[w] = 0u;

  int n_run = 0;
  for (int q0 = 0; q0 < n_q; q0 += UNROLL) {
    const int q_end = min(q0 + UNROLL, n_q);
    n_run = q_end;
    for (int s = q0; s < q_end; ++s) {
      const unsigned cid = (unsigned)sl[s] & CID_MASK;
      const float4* src =
          reinterpret_cast<const float4*>(seg_rows + (size_t)cid * 16 * K);
      float4* dst = reinterpret_cast<float4*>(s_rows);
      __syncthreads();   // the previous slot's reads are done
      for (int i = r; i < 4 * K; i += TILE) dst[i] = src[i];
      __syncthreads();
      if (any_hit && best < inf) continue;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int l = w * 32 + j;
          float t;
          int pid;
          if (hairpt_dev::cyl_hit_tiled<K>(s_rows, l, y, t, pid)) {
            const unsigned bit = 1u << j;
            if (t < best) {
              best = t;
              bpid = pid;
#pragma unroll
              for (int v = 0; v < NW; ++v) eq[v] = 0u;
              eq[w] = bit;
            } else if (t == best && !(eq[w] & bit)) {
              eq[w] |= bit;
              bpid = max(bpid, pid);
            }
          }
        }
      }
    }
    const unsigned packed = (unsigned)sl[q_end - 1];
    const int bq = (int)((packed >> 20) & TE_INF);
    const float te_next =
        (bq == TE_INF) ? inf : tmin[tile] + (float)bq * tscale[tile];
    const bool done = any_hit ? (best < inf || te_next > tpm)
                              : (best <= te_next || te_next > tpm);
    if (__syncthreads_and(done)) break;
  }
  if (slots_run != nullptr && r == 0) slots_run[tile] = n_run;
  t_out[(size_t)tile * TILE + r] = best;
  pid_out[(size_t)tile * TILE + r] =
      any_hit ? (best < inf ? 0 : -1) : bpid;
}

template <int K>
int launch_phase_b(const int* slots, const int* cnt, const float* tmin,
                   const float* tscale, const float* rays8,
                   const float* t_pmax, const float* seg_rows, int T, int q,
                   int any_hit, float* t_out, int* pid_out, int* slots_run,
                   cudaStream_t stream) {
  phase_b_kernel<K><<<T, TILE, 0, stream>>>(slots, cnt, tmin, tscale, rays8,
                                            t_pmax, seg_rows, q, any_hit,
                                            t_out, pid_out, slots_run);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// oct == nullptr launches the default instance (no octet output)
int hairpt_cull(const void* rays8, const void* bounds, int T, int C,
                void* te, void* t_pmax, void* oct, void* stream) {
  if (T <= 0) return 0;
  const int n_cblk = (C + CULL_THREADS - 1) / CULL_THREADS;
  const unsigned grid = (unsigned)T * n_cblk;
  cudaStream_t st = (cudaStream_t)stream;
  if (oct == nullptr)
    cull_kernel<false><<<grid, CULL_THREADS, 0, st>>>(
        (const float*)rays8, (const float*)bounds, C, n_cblk, (uint16_t*)te,
        (int*)t_pmax, nullptr);
  else
    cull_kernel<true><<<grid, CULL_THREADS, 0, st>>>(
        (const float*)rays8, (const float*)bounds, C, n_cblk, (uint16_t*)te,
        (int*)t_pmax, (int*)oct);
  return (int)cudaGetLastError();
}

int hairpt_phase_b(const void* slots, const void* cnt, const void* tmin,
                   const void* tscale, const void* rays8, const void* t_pmax,
                   const void* seg_rows, int T, int q, int K, int any_hit,
                   void* t_out, void* pid_out, void* slots_run,
                   void* stream) {
  if (T <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define HAIRPT_PB(KK)                                                      \
  case KK:                                                                 \
    return launch_phase_b<KK>((const int*)slots, (const int*)cnt,          \
                              (const float*)tmin, (const float*)tscale,    \
                              (const float*)rays8, (const float*)t_pmax,   \
                              (const float*)seg_rows, T, q, any_hit,       \
                              (float*)t_out, (int*)pid_out,                \
                              (int*)slots_run, st);
  switch (K) {
    HAIRPT_PB(32)
    HAIRPT_PB(64)
    HAIRPT_PB(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HAIRPT_PB
}

}  // extern "C"
