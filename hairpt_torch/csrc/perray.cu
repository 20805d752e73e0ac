// Kernel H: the per-ray BVH walk over the SoA BVHArrays for Hopper
// (sm_90a), traversal='perray', the triangles' and the hair's closest and
// any hit.
//
// Plain C interface for ctypes; the PyTorch wrappers (closest_hit,
// any_hit), the layout contract and the plain version (closest_hit_plain,
// any_hit_plain) are in hairpt_torch/ops/intersect.py. Built like
// packed.cu (nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared), as a library of its own so the builds run in parallel. The
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() right after the launch.
//
// Replaces, on the card, the JAX package's per-ray jax.lax.while_loop
// under vmap (hairpt/ops/intersect.py:143-224 make_traverse,
// make_traverse_any; XLA array code, no Pallas kernel). One thread per
// ray walks kernel F's loop (csrc/packed_walk.cuh walk_tree) over an
// ArraysTree: a node is read from node_min / node_max / node_left /
// node_count / node_skip, a leaf's primitives are gathered from the
// sorted geometry by their index, and the closest hit returns that sorted
// index. The slab test, the leaves' arithmetic and their tie rules are
// kernel F's; the any hit has no rule for maxt <= mint, as the JAX
// package's per-ray walk has none. A walk that reaches its cap of 2 M
// steps, or an index outside the tree, sets *err, which the wrapper
// raises on. Every float operation is the plain version's, in its order,
// with no contraction, so the kernel equals it bit for bit on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_walk.cuh"

namespace {

using packed::ArraysTree;
using packed::GeomPtrs;
using packed::HairGeom;
using packed::Ray;
using packed::TriGeom;

constexpr int THREADS = 128;

template <class Geom, bool ANY>
__global__ void __launch_bounds__(THREADS)
    perray_kernel(const float* __restrict__ lo, const float* __restrict__ hi,
                  const int* __restrict__ left, const int* __restrict__ count,
                  const int* __restrict__ skip, int M, GeomPtrs geom, int P,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ mint_in,
                  const float* __restrict__ maxt_in, int N,
                  float* __restrict__ t_out, int* __restrict__ pid_out,
                  int* __restrict__ occ_out, int* __restrict__ err) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const ArraysTree<Geom> tree{lo, hi, left, count, skip, geom, M, P};
  Ray r;
  r.ox = o[3 * n];
  r.oy = o[3 * n + 1];
  r.oz = o[3 * n + 2];
  r.dx = d[3 * n];
  r.dy = d[3 * n + 1];
  r.dz = d[3 * n + 2];
  r.mint = mint_in[n];
  float best_t;
  int best_p;
  bool occ;
  const int rc = packed::walk_tree<ArraysTree<Geom>, ANY>(
      tree, r, maxt_in[n], best_t, best_p, occ);
  if (rc != 0) atomicExch(err, rc);
  if (ANY) {
    occ_out[n] = occ ? 1 : 0;
  } else {
    t_out[n] = best_t;
    pid_out[n] = best_p;
  }
}

}  // namespace

extern "C" {

// geom: the sorted geometry's field pointers, triangles (leaf 0) p0, e1,
// e2 [P, 3]; hair (leaf 1) p0, p1, n0, n1 [P, 3] and radius [P]. any_hit:
// 0 closest (t, pid written), 1 any (occ written). *err: 1 where a walk
// reached 2 M steps, 2 where an index lay outside the tree.
int hairpt_perray_walk(const void* lo, const void* hi, const void* left,
                       const void* count, const void* skip, int M,
                       const void* const* geom, int P, int leaf,
                       int any_hit, const void* o, const void* d,
                       const void* mint, const void* maxt, int N, void* t,
                       void* pid, void* occ, void* err, void* stream) {
  if (N <= 0) return 0;
  const int nf = leaf == 0 ? 3 : 5;
  if (M <= 0 || P < 0 || (leaf != 0 && leaf != 1) || geom == nullptr ||
      err == nullptr ||
      (any_hit ? occ == nullptr : (t == nullptr || pid == nullptr)))
    return (int)cudaErrorInvalidValue;
  GeomPtrs g{};
  for (int i = 0; i < nf; ++i) {
    if (geom[i] == nullptr && P > 0) return (int)cudaErrorInvalidValue;
    g.f[i] = (const float*)geom[i];
  }
  const int blocks = (N + THREADS - 1) / THREADS;
  auto kern = leaf == 0 ? (any_hit ? perray_kernel<TriGeom, true>
                                   : perray_kernel<TriGeom, false>)
                        : (any_hit ? perray_kernel<HairGeom, true>
                                   : perray_kernel<HairGeom, false>);
  kern<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)lo, (const float*)hi, (const int*)left,
      (const int*)count, (const int*)skip, M, g, P, (const float*)o,
      (const float*)d, (const float*)mint, (const float*)maxt, N, (float*)t,
      (int*)pid, (int*)occ, (int*)err);
  return (int)cudaGetLastError();
}

}  // extern "C"
