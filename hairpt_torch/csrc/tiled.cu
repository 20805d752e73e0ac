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
#include "slab.cuh"

namespace {

using hairpt_dev::box_cull;
using hairpt_dev::copy_block;
using hairpt_dev::CullRay;
using hairpt_dev::f_inf;
using hairpt_dev::load_box;
using hairpt_dev::RayRange;
using hairpt_dev::RayRegs;
using hairpt_dev::tile_pass;

constexpr int TILE = 64;          // rays per tile
constexpr int CULL_THREADS = 256; // clusters per phase-A chunk
constexpr int UNROLL = 8;         // phase-B slots between early-exit checks
constexpr int TE_INF = 4095;      // 12-bit "no further slot" sentinel
constexpr unsigned CID_MASK = (1u << 20) - 1;

// ---------------------------------------------------------------------------
// Kernel A: phase-A tile cull.
//
// Replaces hairpt/ops/pallas_tiled.py::_cull_kernel (called through
// cull_phase_a, pallas_tiled.py:1001). For each 64-ray tile and each
// cluster AABB it finds the rays whose slab test hits the box, and writes
//   te[t, c]     min over those rays of max(entry t, 0), truncated toward
//                zero to bf16 (a lower bound); +inf if there is none,
//   t_pmax[t, r] each ray's largest entry t over its hit clusters
//                (-1 if none; the wrapper pre-fills -1).
// A dead ray (maxt <= mint) never hits, as in the plain version; fully
// dead tiles write inf and leave -1. The EMIT_OCT instance also writes
//   oct[t, c]    bit o set iff a ray of octet o (rays 8o..8o+7) enters
//                the box (pallas_tiled.py:940-948, the emit_oct output);
// the default instance has neither the shared words nor the store.
//
// What bounds it: the number of tests. A camera tile's rays enter ~0.7%
// of the furball's 7,875 boxes and a bounce tile's ~6.6%, so slab-testing
// every (ray, cluster) pair (8.3e9 tests of ~38 instructions per camera
// wave) spends >90% of its instructions deciding "miss". Design: one block
// per tile, looping over the clusters in chunks of 256, with a two-level
// cull; what is left is bound by the tile tests' operations and the
// per-chunk latency (a box load, a barrier).
//   * tile test: the ranges of the tile's live rays' origins and inverse
//     directions per axis, their least mint and largest maxt. Against a
//     box, each of the slab test's round-to-nearest operations is applied
//     to the range ends (a product at the four corners of its range):
//     rounding is monotone, so the result brackets every ray's value and
//     a box the tile test rejects fails every ray's own test (no directed
//     rounding is needed; --fmad=false keeps each operation rounded on
//     its own). fminf/fmaxf drop a NaN operand, so a live ray with a
//     non-finite origin or 1/d component can hit a box through its other
//     axes: such a tile passes every box.
//   * level 1: one thread per cluster runs the tile test; the surviving
//     clusters and their boxes are compacted into shared memory with
//     __ballot_sync / __popc.
//   * level 2: the (survivor, ray) pairs are spread over all threads and
//     run the per-ray slab test unchanged. A hit does shared atomicMin
//     (te) and atomicMax (t_pmax) on the bits of max(entry t, 0) with its
//     sign cleared (so -0.0 orders as +0.0), and atomicOr of the octet
//     bit. Min, max and or do not depend on the order, so the outputs
//     equal the dense test's bit for bit whatever the mapping.
// Then the chunk's te (and oct) are stored coalesced, and after the last
// chunk one global atomicMax per ray merges t_pmax. Measured slower on
// the camera or the first bounce wave (PERF.md): an octet-level test
// between the two levels, blocks of 256 clusters per tile, a per-thread
// 64-ray loop behind the tile test, the next chunk's boxes prefetched
// into registers, blocks of 128 or 512 threads, and 2 or 4 tiles per
// block.
// ---------------------------------------------------------------------------

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int CULL_WARPS = CULL_THREADS / 32;
constexpr int TE_MISS = 0x7f800000;   // +inf: te bits of a missed box

template <bool EMIT_OCT>
__global__ void __launch_bounds__(CULL_THREADS)
cull_kernel(const float* __restrict__ rays8,   // [T, 8, TILE]
            const float* __restrict__ bounds,  // [6, C] lo.xyz, hi.xyz
            int C,
            uint16_t* __restrict__ te,         // [T, C] bf16 bits
            int* __restrict__ t_pmax,          // [T, TILE] float bits
            int* __restrict__ oct) {           // [T, C] (EMIT_OCT only)
  __shared__ float s_o[3][TILE];
  __shared__ float s_inv[3][TILE];
  __shared__ float s_mint[TILE];
  __shared__ float s_maxt[TILE];
  __shared__ int s_pmax[TILE];
  __shared__ float s_part[2][14];              // the two ray warps' ranges
  __shared__ unsigned s_live[2], s_bad[2];
  __shared__ float s_box[CULL_THREADS][6];     // level-1 survivors' boxes
  __shared__ int s_surv[CULL_THREADS];         //   ... their chunk index
  __shared__ int s_wcnt[2][CULL_WARPS];        // [chunk parity] survivors
  __shared__ int s_te[CULL_THREADS];           // te bits of the chunk
  __shared__ int s_oct[EMIT_OCT ? CULL_THREADS : 1];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float inf = f_inf();
  const float* r8 = rays8 + (size_t)tile * 8 * TILE;
  const int neg1 = __float_as_int(-1.0f);

  // 1. stage the rays; reduce each ray warp's ranges
  bool live_ray = false;
  if (tid < TILE) {
    const int r = tid;
    float o[3], inv[3];
    bool fin = true;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      o[ax] = r8[ax * TILE + r];
      float d = r8[(3 + ax) * TILE + r];
      if (fabsf(d) < 1e-12f) d = (d >= 0.0f) ? 1e-12f : -1e-12f;
      inv[ax] = 1.0f / d;
      s_o[ax][r] = o[ax];
      s_inv[ax][r] = inv[ax];
      fin = fin && isfinite(o[ax]) && isfinite(inv[ax]);
    }
    const float mint = r8[6 * TILE + r];
    const float maxt = r8[7 * TILE + r];
    live_ray = maxt > mint;
    s_mint[r] = mint;
    s_maxt[r] = live_ray ? maxt : -inf;
    s_pmax[r] = neg1;
    const bool use = live_ray && fin;
    // mn: omin.xyz, imin.xyz, mint; mx: omax.xyz, imax.xyz, maxt
    float mn[7], mx[7];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      mn[ax] = use ? o[ax] : inf;
      mx[ax] = use ? o[ax] : -inf;
      mn[3 + ax] = use ? inv[ax] : inf;
      mx[3 + ax] = use ? inv[ax] : -inf;
    }
    mn[6] = use ? mint : inf;
    mx[6] = use ? maxt : -inf;
    const unsigned lv = __ballot_sync(FULL_MASK, live_ray);
    const unsigned bd = __ballot_sync(FULL_MASK, live_ray && !fin);
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        mn[k] = fminf(mn[k], __shfl_xor_sync(FULL_MASK, mn[k], s));
        mx[k] = fmaxf(mx[k], __shfl_xor_sync(FULL_MASK, mx[k], s));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        s_part[warp][k] = mn[k];
        s_part[warp][7 + k] = mx[k];
      }
      s_live[warp] = lv;
      s_bad[warp] = bd;
    }
  }
  if (!__syncthreads_or(live_ray)) {
    for (int c = tid; c < C; c += CULL_THREADS) {
      te[(size_t)tile * C + c] = 0x7f80;   // bf16 +inf
      if (EMIT_OCT) oct[(size_t)tile * C + c] = 0;
    }
    return;
  }
  RayRange tg;   // the tile's ranges, in registers
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    tg.omin[ax] = fminf(s_part[0][ax], s_part[1][ax]);
    tg.imin[ax] = fminf(s_part[0][3 + ax], s_part[1][3 + ax]);
    tg.omax[ax] = fmaxf(s_part[0][7 + ax], s_part[1][7 + ax]);
    tg.imax[ax] = fmaxf(s_part[0][10 + ax], s_part[1][10 + ax]);
  }
  tg.mint = fminf(s_part[0][6], s_part[1][6]);
  tg.maxt = fmaxf(s_part[0][13], s_part[1][13]);
  tg.finite = (s_bad[0] | s_bad[1]) == 0u;
  const unsigned long long live_mask =
      s_live[0] | ((unsigned long long)s_live[1] << 32);

  for (int c0 = 0; c0 < C; c0 += CULL_THREADS) {
    const int c = c0 + tid;
    // 2. level 1: this thread's cluster against the tile
    float b[6];
    bool pass = false;
    if (c < C) {
#pragma unroll
      for (int i = 0; i < 6; ++i) b[i] = __ldg(bounds + (size_t)i * C + c);
      pass = tile_pass(tg, b);
    }
    s_te[tid] = TE_MISS;
    if (EMIT_OCT) s_oct[tid] = 0;
    // (double-buffered: with no survivor a chunk has one barrier, and a
    // thread may write the next chunk's counts while others still read)
    const int par = (c0 / CULL_THREADS) & 1;
    const unsigned bal = __ballot_sync(FULL_MASK, pass);
    if (lane == 0) s_wcnt[par][warp] = __popc(bal);
    __syncthreads();
    int base = 0, n_surv = 0;
#pragma unroll
    for (int w = 0; w < CULL_WARPS; ++w) {
      const int v = s_wcnt[par][w];
      base += (w < warp) ? v : 0;
      n_surv += v;
    }
    if (n_surv > 0) {
      if (pass) {
        const int pos = base + __popc(bal & ((1u << lane) - 1u));
        s_surv[pos] = tid;
#pragma unroll
        for (int i = 0; i < 6; ++i) s_box[pos][i] = b[i];
      }
      __syncthreads();
      // 3. level 2: (survivor, ray) pairs, the per-ray slab test
      for (int p = tid; p < TILE * n_surv; p += CULL_THREADS) {
        const int i = p >> 6;   // p / TILE
        const int r = p & 63;
        if (!((live_mask >> r) & 1ull)) continue;
        float tn = 0.0f, tf = 0.0f;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          const float a0 = (s_box[i][ax] - s_o[ax][r]) * s_inv[ax][r];
          const float a1 = (s_box[i][3 + ax] - s_o[ax][r]) * s_inv[ax][r];
          const float lo_ax = fminf(a0, a1);
          const float hi_ax = fmaxf(a0, a1);
          tn = (ax == 0) ? lo_ax : fmaxf(tn, lo_ax);
          tf = (ax == 0) ? hi_ax : fminf(tf, hi_ax);
        }
        tf = tf * 1.00000024f + 1e-7f;
        if ((tn <= tf) && (tf >= s_mint[r]) && (tn <= s_maxt[r])) {
          const int v = __float_as_int(fmaxf(tn, 0.0f)) & 0x7fffffff;
          atomicMin(&s_te[s_surv[i]], v);
          atomicMax(&s_pmax[r], v);
          if (EMIT_OCT) atomicOr(&s_oct[s_surv[i]], 1 << (r >> 3));
        }
      }
      __syncthreads();
    }
    // 4. the chunk's te (and oct), coalesced
    if (c < C) {
      te[(size_t)tile * C + c] = (uint16_t)((unsigned)s_te[tid] >> 16);
      if (EMIT_OCT) oct[(size_t)tile * C + c] = s_oct[tid];
    }
  }
  __syncthreads();
  if (tid < TILE && s_pmax[tid] != neg1)
    atomicMax(&t_pmax[(size_t)tile * TILE + tid], s_pmax[tid]);
}

// ---------------------------------------------------------------------------
// Kernel B: phase-B miter-cylinder test over each tile's slot list.
//
// Replaces hairpt/ops/pallas_tiled.py::_tiled_kernel (called through
// _tiled_phase_b_impl, pallas_tiled.py:1132/1199; the math is
// _cyl_test_tm, pallas_tiled.py:37). Each tile walks its cnt[t] packed
// slots (cid | bq << 20, decoded as uint32) in entry-t order and finds
// each of its 64 rays' closest hit among the slots' K segments. Results
// equal the deferred (HAIRPT_UNROLL=8) path of the JAX kernel:
//   * per lane, the earliest slot wins on equal t (strict <); among the
//     lanes whose t equals the ray's best, the largest pid wins. A ray
//     keeps (best t, best pid, one "holds the best t" bit per lane),
//     which is that rule without a [TILE, K] running matrix;
//   * the tile stops after a group of 8 slots once every ray is
//     resolved against the dequantized bound tmin + bq * tscale of the
//     group's last slot (bq == 4095 is +inf), or has no candidate left
//     (bound > its own t_pmax);
//   * any_hit: pid is 0/-1 and a ray skips the remaining slots once it
//     holds a finite hit.
//
// What bounds it: operations. Each (ray, segment) test is ~90 f32
// operations with a division and a square root, compiled without FMA
// (--fmad=false), so the card issues them at half its 67 TFLOP/s FMA
// rate. A slot's segment block (8 KB at K = 128) is read by many tiles
// and served mostly by L2. A slot is routed to a tile when ANY of its
// rays enters the cluster box, so most (ray, slot) pairs of an
// incoherent tile cannot hit; the design spends the arithmetic on the
// others:
//   * slot cull (box_cull, slab.cuh, shared with kernels C and D): rays
//     0..63 each run kernel A's slab test against the
//     slot's cluster box, widened by BOX_PAD times the larger of the
//     ray origin's and the box's largest |coordinate| (so that a
//     grazing hit the lane test accepts just outside the exact box is
//     kept; tiled_kernels.slot_cull_plain is its plain version), up to
//     min(maxt, best) with <= (closest hit; equal t still matters for
//     the tie rule), or not at all once the ray holds a hit (any hit).
//     A __ballot_sync turns the passes into a 64-bit active mask;
//   * mapping: 128 threads, one per segment lane (K = 128; 128/K rays
//     side by side for K < 128). A thread keeps its lane's 15 floats in
//     registers and walks the slot's active rays, reading each ray by
//     broadcast from shared memory, so every thread works on surviving
//     (ray, lane) pairs only. Hits are rare: a warp reduces only when
//     __ballot_sync(hit) is non-zero, and writes one record per (ray,
//     warp): its minimum t, the lanes at it, the largest pid among them
//     and the largest among those not already holding the ray's best.
//     After the slot each ray merges its records (reduce, then merge
//     against the holds-best bits), which no order of lanes or warps
//     changes;
//   * prefetch: a two-stage ring of segment blocks in shared memory. While
//     a slot's rays are tested, cp.async copies the next slot's block into
//     the other stage (and the rays' threads load its box into
//     registers); a thread reads its lane from the ring only when the
//     slot has an active ray. The ring costs no registers: prefetching
//     into registers instead took 108 and ran 10-20% slower (PERF.md);
//   * the early exit stays a __syncthreads_and after each group of 8.
// ---------------------------------------------------------------------------
constexpr int B_THREADS = 128;    // phase-B block: K lanes x 128/K rays
template <int K>
__global__ void __launch_bounds__(B_THREADS)
phase_b_kernel(const int* __restrict__ slots,     // [T, q]
               const int* __restrict__ cnt,       // [T]
               const float* __restrict__ tmin,    // [T]
               const float* __restrict__ tscale,  // [T]
               const float* __restrict__ rays8,   // [T, 8, TILE]
               const float* __restrict__ t_pmax,  // [T, TILE]
               const float* __restrict__ seg_rows,  // [C, 16, K]
               const float* __restrict__ bounds,  // [6, C]
               int C, int q, int any_hit,
               float* __restrict__ t_out,         // [T, TILE]
               int* __restrict__ pid_out,         // [T, TILE]
               int* __restrict__ slots_run,       // [T] or null
               int* __restrict__ pairs_run) {     // [T] or null
  constexpr int NW = K / 32;           // warps (holds-best words) per ray
  constexpr int G = B_THREADS / K;     // rays tested side by side
  constexpr unsigned FULL = 0xffffffffu;
  __shared__ __align__(16) float s_blk[2][16 * K];  // segment block ring
  __shared__ float4 s_ray[TILE][2];    // o.xyz mint | d.xyz maxt
  __shared__ unsigned s_eq[TILE][NW];  // lanes holding the ray's best t
  __shared__ float s_rt[TILE][NW];     // per-slot records of each warp:
  __shared__ unsigned s_rm[TILE][NW];  //   min t, the lanes at it,
  __shared__ int s_rpa[TILE][NW];      //   the largest pid among them,
  __shared__ int s_rpn[TILE][NW];      //   ... among those not holding
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
#pragma unroll
    for (int v = 0; v < NW; ++v) s_eq[tid][v] = 0u;
    s_hitw[tid] = 0u;
  }

  unsigned pk = 0u;
  float bx[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (n_q > 0) {
    pk = (unsigned)sl[0];
    if (ray_thr) load_box(bounds, C, pk & CID_MASK, bx);
    copy_block<K, B_THREADS>(s_blk[0],
                             seg_rows + (size_t)(pk & CID_MASK) * 16 * K,
                             tid);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  int n_run = 0, n_pairs = 0;
  for (int q0 = 0; q0 < n_q; q0 += UNROLL) {
    const int q_end = min(q0 + UNROLL, n_q);
    n_run = q_end;
    unsigned pk_last = pk;
    for (int s = q0; s < q_end; ++s) {
      // 1. slot cull: each ray against the slot's widened cluster box
      if (ray_thr) {
        const bool pass = !(any_hit && best < inf) &&
                          box_cull(cr, bx, fminf(cr.maxt, best));
        const unsigned b = __ballot_sync(FULL, pass);
        if (wl == 0) s_act[s & 1][tid >> 5] = b;
      }
      // 2. prefetch the next slot: its block into the other stage (read
      //    last by slot s - 1's tests, which ended before its barrier)
      pk_last = pk;
      if (s + 1 < n_q) {
        pk = (unsigned)sl[s + 1];
        const unsigned cid = pk & CID_MASK;
        if (ray_thr) load_box(bounds, C, cid, bx);
        copy_block<K, B_THREADS>(s_blk[(s + 1) & 1],
                                 seg_rows + (size_t)cid * 16 * K, tid);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);   // this slot's block
      __syncthreads();   // the block and the active mask are complete
      const unsigned a0 = s_act[s & 1][0], a1 = s_act[s & 1][1];
      if ((a0 | a1) != 0u) {
        if (tid == 0) n_pairs += __popc(a0) + __popc(a1);
        // 3. this thread's lane against its share of the active rays
        const hairpt_dev::SegRegs g =
            hairpt_dev::load_seg<K>(s_blk[s & 1], lane);
        unsigned long long m = a0 | ((unsigned long long)a1 << 32);
        for (int i = 0; i < grp; ++i) m &= m - 1;
        while (m != 0ull) {
          const int r = __ffsll((long long)m) - 1;
          const float4 ra = s_ray[r][0], rb = s_ray[r][1];
          const RayRegs y = {ra.x, ra.y, ra.z, rb.x, rb.y, rb.z, ra.w, rb.w};
          float t;
          const bool hit = hairpt_dev::cyl_hit_seg(g, y, t);
          if (__ballot_sync(FULL, hit) != 0u) {
            float wm = hit ? t : inf;
#pragma unroll
            for (int x = 16; x > 0; x >>= 1)
              wm = fminf(wm, __shfl_xor_sync(FULL, wm, x));
            const bool at = hit && t == wm;
            const unsigned am = __ballot_sync(FULL, at);
            const bool held = (s_eq[r][w] >> wl) & 1u;
            const int pa = __reduce_max_sync(FULL, at ? g.pid : -1);
            const int pn = __reduce_max_sync(FULL,
                                             (at && !held) ? g.pid : -1);
            if (wl == 0) {
              s_rt[r][w] = wm;
              s_rm[r][w] = am;
              s_rpa[r][w] = pa;
              s_rpn[r][w] = pn;
              atomicOr(&s_hitw[r], 1u << w);
            }
          }
#pragma unroll
          for (int i = 0; i < G; ++i) m &= m - 1;
        }
        __syncthreads();   // every record of the slot is written
        // 4. merge the slot into each ray's state
        if (ray_thr && s_hitw[tid] != 0u) {
          const unsigned hw = s_hitw[tid];
          float st = inf;
#pragma unroll
          for (int v = 0; v < NW; ++v)
            if ((hw >> v) & 1u) st = fminf(st, s_rt[tid][v]);
          if (st < best) {
            best = st;
            bpid = -1;
#pragma unroll
            for (int v = 0; v < NW; ++v) {
              const bool at = ((hw >> v) & 1u) && s_rt[tid][v] == st;
              s_eq[tid][v] = at ? s_rm[tid][v] : 0u;
              if (at) bpid = max(bpid, s_rpa[tid][v]);
            }
          } else if (st == best) {
#pragma unroll
            for (int v = 0; v < NW; ++v) {
              if (((hw >> v) & 1u) && s_rt[tid][v] == st) {
                s_eq[tid][v] |= s_rm[tid][v];
                bpid = max(bpid, s_rpn[tid][v]);
              }
            }
          }
          s_hitw[tid] = 0u;
        }
      }
    }
    bool done = true;
    if (ray_thr) {
      const int bq = (int)((pk_last >> 20) & TE_INF);
      const float te_next =
          (bq == TE_INF) ? inf : tmin[tile] + (float)bq * tscale[tile];
      done = any_hit ? (best < inf || te_next > tpm)
                     : (best <= te_next || te_next > tpm);
    }
    if (__syncthreads_and(done)) break;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);   // no copy outlives the block
  if (tid == 0) {
    if (slots_run != nullptr) slots_run[tile] = n_run;
    if (pairs_run != nullptr) pairs_run[tile] = n_pairs;
  }
  if (ray_thr) {
    t_out[(size_t)tile * TILE + tid] = best;
    pid_out[(size_t)tile * TILE + tid] =
        any_hit ? (best < inf ? 0 : -1) : bpid;
  }
}

template <int K>
int launch_phase_b(const int* slots, const int* cnt, const float* tmin,
                   const float* tscale, const float* rays8,
                   const float* t_pmax, const float* seg_rows,
                   const float* bounds, int T, int q, int C, int any_hit,
                   float* t_out, int* pid_out, int* slots_run,
                   int* pairs_run, cudaStream_t stream) {
  phase_b_kernel<K><<<T, B_THREADS, 0, stream>>>(
      slots, cnt, tmin, tscale, rays8, t_pmax, seg_rows, bounds, C, q,
      any_hit, t_out, pid_out, slots_run, pairs_run);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// oct == nullptr launches the default instance (no octet output)
int hairpt_cull(const void* rays8, const void* bounds, int T, int C,
                void* te, void* t_pmax, void* oct, void* stream) {
  if (T <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (oct == nullptr)
    cull_kernel<false><<<T, CULL_THREADS, 0, st>>>(
        (const float*)rays8, (const float*)bounds, C, (uint16_t*)te,
        (int*)t_pmax, nullptr);
  else
    cull_kernel<true><<<T, CULL_THREADS, 0, st>>>(
        (const float*)rays8, (const float*)bounds, C, (uint16_t*)te,
        (int*)t_pmax, (int*)oct);
  return (int)cudaGetLastError();
}

// pairs_run (optional) receives each tile's count of (ray, slot) pairs
// that passed the slot cull
int hairpt_phase_b(const void* slots, const void* cnt, const void* tmin,
                   const void* tscale, const void* rays8, const void* t_pmax,
                   const void* seg_rows, const void* bounds, int T, int q,
                   int K, int C, int any_hit, void* t_out, void* pid_out,
                   void* slots_run, void* pairs_run, void* stream) {
  if (T <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define HAIRPT_PB(KK)                                                      \
  case KK:                                                                 \
    return launch_phase_b<KK>(                                             \
        (const int*)slots, (const int*)cnt, (const float*)tmin,            \
        (const float*)tscale, (const float*)rays8, (const float*)t_pmax,   \
        (const float*)seg_rows, (const float*)bounds, T, q, C, any_hit,    \
        (float*)t_out, (int*)pid_out, (int*)slots_run, (int*)pairs_run,    \
        st);
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
