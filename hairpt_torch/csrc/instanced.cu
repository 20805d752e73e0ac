// Kernel G: the two-level walk of instanced triangle meshes for Hopper
// (sm_90a), closest and any hit.
//
// Plain C interface for ctypes; the PyTorch wrappers (inst_closest_hit,
// inst_any_hit), the layout and the plain versions (inst_closest_hit_plain,
// inst_any_hit_plain) are in hairpt_torch/ops/instancing.py. Built like
// packed.cu (nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared), as a library of its own so the builds run in parallel. The
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() right after the launch.
//
// Replaces, on the card, the JAX package's Python loop over the
// instances, unrolled under jit (hairpt/ops/instancing.py:173
// inst_closest_hit, :195 inst_any_hit; XLA array code, no Pallas kernel):
// there each instance costs a ray transform and one packed walk of the
// whole wave. Here one thread per ray loops over the instances in order:
//   the instance table (a row of INST_F floats per instance: world box,
//     world-to-object 3 x 4, the prototype's node base, node count, leaf
//     row base, leaf row count and prim count) is staged through shared
//     memory in chunks of CHUNK instances, so any count fits;
//   the world box test (_aabb_cull: 1 / d with |d| < 1e-12 clamped to
//     +-1e-12, tf * 1.00000024 + 1e-7, up to min(maxt, best t) for the
//     closest hit and maxt for the any hit);
//   the object ray: o' = ((m0 o.x + m1 o.y) + m2 o.z) + m3 per row and
//     d' = (m0 d.x + m1 d.y) + m2 d.z, d' not normalised, so t stays the
//     world t;
//   the prototype's packed walk (csrc/packed_walk.cuh, kernel F's loop
//     with its triangle leaf) up to that maxt;
//   closest hit: a hit replaces the best where t < best t strictly, so
//     the first instance in order wins a tie; any hit stops at the first
//     instance that occludes.
// The JAX package walks a culled instance with maxt = 0: that walk finds
// a hit only where mint < 0 (its hits lie in [mint, 0]), so the kernel
// walks a culled instance only then.
// The prim ids stay local to their prototype; *err is set where a walk
// reaches its step cap or leaves its tree, or a prim id lies outside its
// prototype.
//
// What bounds it: each ray tests every instance's box (30 f32 operations)
// and walks the instances it enters; the inputs (the instance table, the
// prototypes' node and leaf rows, 32 B per ray) are small beside the
// operations, and the walks' node and leaf rows come from L2. The design
// keeps the instance table in shared memory and each ray in registers
// across all its instances, so a wave costs one launch whatever the
// instance count; a tree over the instances, ray sorting or a wider tree
// are later work (ROADMAP Queue B).

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_walk.cuh"

namespace {

using packed::nmax;
using packed::nmin;
using packed::Ray;
using packed::TriLeaf;

constexpr int THREADS = 128;
constexpr int CHUNK = 256;   // instances staged in shared memory per pass
constexpr int INST_F = 24;   // floats per instance row
// the row's fields
constexpr int I_LO = 0, I_HI = 3, I_M = 6, I_NODE_BASE = 18, I_NODES = 19,
              I_LEAF_BASE = 20, I_LEAVES = 21, I_PRIMS = 22;

template <bool ANY>
__global__ void __launch_bounds__(THREADS)
    inst_kernel(const float* __restrict__ table, int I,
                const float* __restrict__ nodes,
                const float* __restrict__ rows, int K,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ mint_in,
                const float* __restrict__ maxt_in, int N,
                float* __restrict__ t_out, int* __restrict__ pid_out,
                int* __restrict__ which_out, int* __restrict__ occ_out,
                int* __restrict__ err) {
  __shared__ float s_tab[CHUNK * INST_F];
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const bool live = n < N;
  Ray r{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float maxt = 0.0f;
  if (live) {
    r.ox = o[3 * n];
    r.oy = o[3 * n + 1];
    r.oz = o[3 * n + 2];
    r.dx = d[3 * n];
    r.dy = d[3 * n + 1];
    r.dz = d[3 * n + 2];
    r.mint = mint_in[n];
    maxt = maxt_in[n];
  }
  const float ix = packed::inv_dir(r.dx), iy = packed::inv_dir(r.dy),
              iz = packed::inv_dir(r.dz);
  float best_t = packed::f_inf();
  int best_p = -1, best_i = -1;
  bool occ = false;
  bool done = !live;
  int rc = 0;
  for (int c0 = 0; c0 < I; c0 += CHUNK) {
    const int cn = min(CHUNK, I - c0);
    __syncthreads();
    for (int k = threadIdx.x; k < cn * INST_F; k += THREADS)
      s_tab[k] = __ldg(table + (size_t)c0 * INST_F + k);
    __syncthreads();
    for (int j = 0; j < cn && !done; ++j) {
      const float* row = s_tab + j * INST_F;
      // the world box (_aabb_cull), per axis in x, y, z order
      const float mt = ANY ? maxt : nmin(maxt, best_t);
      float a0 = (row[I_LO] - r.ox) * ix, a1 = (row[I_HI] - r.ox) * ix;
      float tn = nmin(a0, a1), tf = nmax(a0, a1);
      a0 = (row[I_LO + 1] - r.oy) * iy;
      a1 = (row[I_HI + 1] - r.oy) * iy;
      tn = nmax(tn, nmin(a0, a1));
      tf = nmin(tf, nmax(a0, a1));
      a0 = (row[I_LO + 2] - r.oz) * iz;
      a1 = (row[I_HI + 2] - r.oz) * iz;
      tn = nmax(tn, nmin(a0, a1));
      tf = nmin(tf, nmax(a0, a1));
      tf = tf * 1.00000024f + 1e-7f;
      const bool hit_box = tn <= tf && tf >= r.mint && tn <= mt;
      if (!hit_box && !(r.mint < 0.0f)) continue;
      // the object ray
      const float* m = row + I_M;
      Ray q;
      q.ox = ((m[0] * r.ox + m[1] * r.oy) + m[2] * r.oz) + m[3];
      q.oy = ((m[4] * r.ox + m[5] * r.oy) + m[6] * r.oz) + m[7];
      q.oz = ((m[8] * r.ox + m[9] * r.oy) + m[10] * r.oz) + m[11];
      q.dx = (m[0] * r.dx + m[1] * r.dy) + m[2] * r.dz;
      q.dy = (m[4] * r.dx + m[5] * r.dy) + m[6] * r.dz;
      q.dz = (m[8] * r.dx + m[9] * r.dy) + m[10] * r.dz;
      q.mint = r.mint;
      const int node_base = __float_as_int(row[I_NODE_BASE]);
      const int leaf_base = __float_as_int(row[I_LEAF_BASE]);
      float t;
      int p;
      bool hit;
      const int wrc = packed::walk<TriLeaf, ANY>(
          nodes + (size_t)node_base * 8,
          rows + (size_t)leaf_base * K * packed::PRIM_F,
          __float_as_int(row[I_NODES]), __float_as_int(row[I_LEAVES]), K, q,
          hit_box ? mt : 0.0f, t, p, hit);
      if (wrc != 0) {
        rc = wrc;
        done = true;
        break;
      }
      if (ANY) {
        if (hit) {
          occ = true;
          done = true;
        }
      } else if (t < best_t) {
        if (p < 0 || p >= __float_as_int(row[I_PRIMS])) {
          rc = packed::ERR_RANGE;
          done = true;
          break;
        }
        best_t = t;
        best_p = p;
        best_i = c0 + j;
      }
    }
    // the block leaves the loop once every ray is done (any hit)
    if (!__syncthreads_or(!done)) break;
  }
  if (rc != 0) atomicExch(err, rc);
  if (!live) return;
  if (ANY) {
    occ_out[n] = occ ? 1 : 0;
  } else {
    t_out[n] = best_t;
    pid_out[n] = best_p;
    which_out[n] = best_i;
  }
}

}  // namespace

extern "C" {

// table [I, 24] f32 (instancing.INST_F), nodes and rows every prototype's
// packed BVH rows concatenated, K the leaf size. any_hit: 0 closest (t,
// pid, which written), 1 any (occ written). *err: 1 a walk reached its
// step cap, 2 an index outside a tree or a prim id outside its prototype.
int hairpt_inst_walk(const void* table, int I, const void* nodes,
                     const void* rows, int K, int any_hit, const void* o,
                     const void* d, const void* mint, const void* maxt, int N,
                     void* t, void* pid, void* which, void* occ, void* err,
                     void* stream) {
  if (N <= 0) return 0;
  if (I <= 0 || K < 1 || K > 31 || err == nullptr ||
      (any_hit ? occ == nullptr
               : (t == nullptr || pid == nullptr || which == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (N + THREADS - 1) / THREADS;
  auto kern = any_hit ? inst_kernel<true> : inst_kernel<false>;
  kern<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)table, I, (const float*)nodes, (const float*)rows, K,
      (const float*)o, (const float*)d, (const float*)mint,
      (const float*)maxt, N, (float*)t, (int*)pid, (int*)which, (int*)occ,
      (int*)err);
  return (int)cudaGetLastError();
}

}  // extern "C"
