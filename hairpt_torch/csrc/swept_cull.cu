// Phase A of the swept traversal for Hopper (sm_90a): the candidate
// clusters of each ray.
//
// Plain C interface for ctypes; the PyTorch wrapper (swept_phase_a) and
// the layout contract are in hairpt_torch/ops/phaseb_kernels.py, the
// plain version is hairpt_torch/ops/intersect_swept.py::_phase_a_dense.
// Built like tiled.cu (nvcc -gencode arch=compute_90a,code=sm_90a -O3
// --fmad=false -shared), as a library of its own so the builds run in
// parallel. The entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cyl_test.cuh"
#include "slab.cuh"

namespace {

using hairpt_dev::f_inf;
using hairpt_dev::RayRange;
using hairpt_dev::tile_pass;

constexpr int TILE = 64;                  // rays per block
constexpr int THREADS = 256;              // clusters per chunk
constexpr int WARPS = THREADS / 32;
constexpr int HIT_WORDS = THREADS / 32;   // hit bits of a ray per chunk
// kept keys per ray that fit the shared-memory list (32 KB); a larger k
// keeps its lists in a global scratch buffer the caller allocates
constexpr int SMEM_K = 64;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// The swept phase A.
//
// Replaces, on the card, _phase_a_dense: the port of the JAX package's
// XLA array code hairpt/ops/intersect_swept.py:220 (no Pallas kernel). For
// each ray n it slab-tests the cluster boxes with _phase_a_dense's
// arithmetic (1/d with its 1e-12 clamp, the exit t widened by
// * 1.00000024 + 1e-7, hit = tn <= tf & tf >= mint & tn <= maxt) and
// writes
//   slots[n, :]  the k = min(p_max, C) kept cluster ids, -1 past cnt,
//   cnt[n]       how many are kept,
//   n_hit[n]     how many boxes the ray enters,
// bit for bit as the plain version does, in one of its two branches:
//   lowest  (C <= c_chunk): the k lowest ids, in id order;
//   nearest: the k smallest keys (bits(max(tn, 0)) & 0x7fffffff) << cbits
//            | id, in key order (ties at t = 0 go by id); an entry at
//            t = +inf counts in n_hit and is not kept.
// torch.minimum/maximum propagate a NaN, so a ray whose slab values hold
// one enters no box; fminf/fmaxf would drop it, so the test checks for
// it. Dead rays (maxt <= mint) are tested like the others, as the JAX
// package tests them: a dead lane at a hit point (mint = maxt = 0) enters
// the boxes around that point. A ray with a non-finite o or 1/d
// component on an axis has the same slab value v = (0 - o) * inv at
// both faces of every (finite) box there, so it enters no box if v is
// NaN, +inf with maxt < +inf, or -inf with mint > -inf: such a ray (an
// escaped lane, whose origin o + d * inf the integrator parks with
// mint = maxt = 0) is skipped.
//
// What bounds it: the number of tests, as in kernel A. A camera tile's
// rays enter ~0.7% of the furball's 7,875 boxes, a Morton-sorted bounce
// tile's ~6.6%. Design: kernel A's (tiled.cu). One block per tile of 64
// rays (the rays perm lists, in its order: the wrapper sorts them so that
// a tile's rays are coherent; the outputs go to each ray's own row) loops
// over the clusters in chunks of 256:
//   * tile test: kernel A's, on the ranges of ALL the tile's rays except
//     padding and skipped rays (kernel A takes only its live rays; here
//     a dead ray has candidates); any other ray with a non-finite o or
//     1/d component makes the tile pass every box; a tile with no ray
//     left writes empty lists;
//   * compaction of the passing clusters (__ballot_sync / __popc);
//   * the per-ray test over the (cluster, ray) pairs, spread over all
//     threads; a hit sets the pair's bit in shared memory;
//   * selection: each ray's thread walks its hit bits in id order, counts
//     them, recomputes each hit's entry t with the same code, and inserts
//     its key into the ray's sorted list of k keys (a key above the
//     list's last is dropped at once); the lists are in shared memory for
//     k <= SMEM_K, else in a global scratch buffer (SPILL).
// At the end the block writes its lists, coalesced.
// ---------------------------------------------------------------------------

// _phase_a_dense's test of one box: true on a hit, with the entry t in tn
__device__ __forceinline__ bool slab_hit(const float (&b)[6],
                                         const float (&o)[3],
                                         const float (&inv)[3], float mint,
                                         float maxt, float& tn_out) {
  float tn = 0.0f, tf = 0.0f;
  bool nan = false;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float a0 = (b[ax] - o[ax]) * inv[ax];
    const float a1 = (b[3 + ax] - o[ax]) * inv[ax];
    nan = nan || isnan(a0) || isnan(a1);
    const float lo_ax = fminf(a0, a1);
    const float hi_ax = fmaxf(a0, a1);
    tn = (ax == 0) ? lo_ax : fmaxf(tn, lo_ax);
    tf = (ax == 0) ? hi_ax : fminf(tf, hi_ax);
  }
  tf = tf * 1.00000024f + 1e-7f;
  tn_out = tn;
  return !nan && (tn <= tf) && (tf >= mint) && (tn <= maxt);
}

template <bool SPILL>
__global__ void __launch_bounds__(THREADS)
swept_cull_kernel(const float* __restrict__ o_g,     // [N, 3]
                  const float* __restrict__ d_g,     // [N, 3]
                  const float* __restrict__ mint_g,  // [N]
                  const float* __restrict__ maxt_g,  // [N]
                  const int* __restrict__ perm,      // [N] ray order
                  int N,
                  const float* __restrict__ lo_g,    // [C, 3]
                  const float* __restrict__ hi_g,    // [C, 3]
                  int C, int k, int p_max, int cbits, int lowest,
                  int* __restrict__ slots,           // [N, p_max]
                  int* __restrict__ cnt,             // [N]
                  long long* __restrict__ n_hit,     // [N]
                  unsigned long long* __restrict__ spill) {  // [T][k][TILE]
  extern __shared__ unsigned long long s_key[];      // [k][TILE]
  __shared__ float s_o[3][TILE];
  __shared__ float s_inv[3][TILE];
  __shared__ float s_mint[TILE];
  __shared__ float s_maxt[TILE];
  __shared__ int s_row[TILE];                        // output row, -1: pad
  __shared__ int s_len[TILE];
  __shared__ float s_part[2][14];                    // the two ray warps'
  __shared__ unsigned s_rng[2], s_bad[2];            //   ranges
  __shared__ float s_box[THREADS][6];                // passing clusters'
  __shared__ int s_cid[THREADS];                     //   boxes and ids
  __shared__ int s_wcnt[2][WARPS];                   // [chunk parity]
  __shared__ unsigned s_hit[HIT_WORDS][TILE];        // hit bits

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float inf = f_inf();
  const int i0 = blockIdx.x * TILE;
  unsigned long long* const keys =
      SPILL ? spill + (size_t)blockIdx.x * k * TILE : s_key;

  // 1. stage the rays; reduce each ray warp's ranges over its rays but
  //    padding and skipped rays (`ranged`)
  bool valid = false, ranged = false;
  float o[3] = {0.0f, 0.0f, 0.0f}, inv[3] = {0.0f, 0.0f, 0.0f};
  float mint = 0.0f, maxt = 0.0f;
  int len = 0, nh = 0;
  if (tid < TILE) {
    const int i = i0 + tid;
    valid = i < N;
    bool fin = true, never = false;
    int row = -1;
    if (valid) {
      row = perm[i];
      mint = mint_g[row];
      maxt = maxt_g[row];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        o[ax] = o_g[(size_t)row * 3 + ax];
        float d = d_g[(size_t)row * 3 + ax];
        if (fabsf(d) < 1e-12f) d = (d >= 0.0f) ? 1e-12f : -1e-12f;
        inv[ax] = 1.0f / d;
        if (!(isfinite(o[ax]) && isfinite(inv[ax]))) {
          fin = false;
          const float v = (0.0f - o[ax]) * inv[ax];
          never = never || isnan(v) || (v == inf && !(maxt == inf)) ||
                  (v == -inf && !(mint == -inf));
        }
      }
    }
    ranged = valid && !never;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      s_o[ax][tid] = o[ax];
      s_inv[ax][tid] = inv[ax];
    }
    s_mint[tid] = mint;
    s_maxt[tid] = maxt;
    s_row[tid] = row;
#pragma unroll
    for (int w = 0; w < HIT_WORDS; ++w) s_hit[w][tid] = 0u;
    const bool use = ranged && fin;
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
    const unsigned rm = __ballot_sync(FULL, ranged);
    const unsigned bd = __ballot_sync(FULL, ranged && !fin);
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
#pragma unroll
      for (int q = 0; q < 7; ++q) {
        mn[q] = fminf(mn[q], __shfl_xor_sync(FULL, mn[q], s));
        mx[q] = fmaxf(mx[q], __shfl_xor_sync(FULL, mx[q], s));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < 7; ++q) {
        s_part[warp][q] = mn[q];
        s_part[warp][7 + q] = mx[q];
      }
      s_rng[warp] = rm;
      s_bad[warp] = bd;
    }
  }
  __syncthreads();
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
  const unsigned long long rng_mask =
      s_rng[0] | ((unsigned long long)s_rng[1] << 32);

  for (int c0 = 0; c0 < (rng_mask ? C : 0); c0 += THREADS) {
    const int c = c0 + tid;
    // 2. this thread's cluster against the tile
    float b[6];
    bool pass = false;
    if (c < C) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        b[ax] = __ldg(lo_g + (size_t)c * 3 + ax);
        b[3 + ax] = __ldg(hi_g + (size_t)c * 3 + ax);
      }
      pass = tile_pass(tg, b);
    }
    // (double-buffered: with no survivor a chunk has one barrier)
    const int par = (c0 / THREADS) & 1;
    const unsigned bal = __ballot_sync(FULL, pass);
    if (lane == 0) s_wcnt[par][warp] = __popc(bal);
    __syncthreads();
    int base = 0, n_surv = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int v = s_wcnt[par][w];
      base += (w < warp) ? v : 0;
      n_surv += v;
    }
    if (n_surv == 0) continue;
    if (pass) {   // compaction keeps the clusters in id order
      const int pos = base + __popc(bal & ((1u << lane) - 1u));
      s_cid[pos] = c;
#pragma unroll
      for (int q = 0; q < 6; ++q) s_box[pos][q] = b[q];
    }
    __syncthreads();
    // 3. the per-ray test over the (cluster, ray) pairs
    for (int p = tid; p < TILE * n_surv; p += THREADS) {
      const int i = p >> 6;   // p / TILE
      const int r = p & 63;
      if (!((rng_mask >> r) & 1ull)) continue;
      float bx[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) bx[q] = s_box[i][q];
      const float ro[3] = {s_o[0][r], s_o[1][r], s_o[2][r]};
      const float ri[3] = {s_inv[0][r], s_inv[1][r], s_inv[2][r]};
      float tn;
      if (slab_hit(bx, ro, ri, s_mint[r], s_maxt[r], tn))
        atomicOr(&s_hit[i >> 5][r], 1u << (i & 31));
    }
    __syncthreads();
    // 4. each ray's hits, in id order, into its sorted list of keys (the
    //    other warps go on to the next chunk's tile test meanwhile)
    if (ranged) {
      const int nw = (n_surv + 31) >> 5;
      for (int w = 0; w < nw; ++w) {
        unsigned bits = s_hit[w][tid];
        if (bits == 0u) continue;
        s_hit[w][tid] = 0u;
        nh += __popc(bits);
        while (bits != 0u) {
          const int i = (w << 5) + __ffs(bits) - 1;
          bits &= bits - 1u;
          unsigned long long key;
          if (lowest) {
            if (len == k) break;
            key = (unsigned long long)s_cid[i];
          } else {
            float bx[6];
#pragma unroll
            for (int q = 0; q < 6; ++q) bx[q] = s_box[i][q];
            float tn;
            slab_hit(bx, o, inv, mint, maxt, tn);
            const unsigned tb = __float_as_uint(fmaxf(tn, 0.0f)) &
                                0x7fffffffu;
            if (tb >= 0x7f800000u) continue;   // t = +inf: not kept
            key = ((unsigned long long)tb << cbits) |
                  (unsigned long long)s_cid[i];
            if (len == k && key > keys[(k - 1) * TILE + tid]) continue;
          }
          int j = (len < k) ? len : k - 1;
          while (j > 0 && keys[(j - 1) * TILE + tid] > key) {
            keys[j * TILE + tid] = keys[(j - 1) * TILE + tid];
            --j;
          }
          keys[j * TILE + tid] = key;
          if (len < k) ++len;
        }
      }
    }
  }
  // 5. the outputs: counts per ray, the lists coalesced
  if (tid < TILE) s_len[tid] = len;
  __syncthreads();
  if (valid) {
    cnt[s_row[tid]] = len;
    n_hit[s_row[tid]] = nh;
  }
  const unsigned long long cmask = (1ull << cbits) - 1ull;
  for (int idx = tid; idx < TILE * p_max; idx += THREADS) {
    const int r = idx / p_max;
    const int j = idx - r * p_max;
    const int row = s_row[r];
    if (row < 0) continue;
    slots[(size_t)row * p_max + j] =
        (j < s_len[r]) ? (int)(keys[j * TILE + r] & cmask) : -1;
  }
}

}  // namespace

extern "C" {

int hairpt_swept_cull(const void* o, const void* d, const void* mint,
                      const void* maxt, const void* perm, int N,
                      const void* cl_lo, const void* cl_hi, int C, int k,
                      int p_max, int cbits, int lowest, void* slots,
                      void* cnt, void* n_hit, void* spill, void* stream) {
  if (N <= 0) return 0;
  const bool spilled = k > SMEM_K;
  if (perm == nullptr || C <= 0 || k < 1 || k > p_max || k > C ||
      cbits < 1 || cbits > 20 || spilled != (spill != nullptr))
    return (int)cudaErrorInvalidValue;
  const int T = (N + TILE - 1) / TILE;
  const size_t smem =
      spilled ? 0 : (size_t)k * TILE * sizeof(unsigned long long);
  auto kern = spilled ? swept_cull_kernel<true> : swept_cull_kernel<false>;
  kern<<<T, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const float*)mint,
      (const float*)maxt, (const int*)perm, N, (const float*)cl_lo,
      (const float*)cl_hi, C, k, p_max, cbits, lowest, (int*)slots,
      (int*)cnt, (long long*)n_hit, (unsigned long long*)spill);
  return (int)cudaGetLastError();
}

}  // extern "C"
