// Kernel F: the packed-layout BVH walk for Hopper (sm_90a), the
// triangles' closest and any hit and the hair's under the 'packed'
// traversal.
//
// Plain C interface for ctypes; the PyTorch wrappers (closest_hit_packed,
// any_hit_packed), the layout contract and the plain version
// (_walk_plain) are in hairpt_torch/ops/intersect_packed.py. Built like
// tiled.cu (nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared), as a library of its own so the builds run in parallel. The
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() right after the launch.
//
// Replaces, on the card, the JAX package's per-ray jax.lax.while_loop
// under vmap (hairpt/ops/intersect_packed.py:173 closest_hit_packed,
// :228 any_hit_packed; XLA array code, no Pallas kernel). One thread per
// ray walks the stackless skip-pointer order of csrc/packed_walk.cuh
// (node rows, the slab test, the leaves' tests and their tie rules are
// described there). A walk that reaches
// its cap of 2 M steps, or an index outside the tree, sets *err, which
// the wrapper raises on.
//
// The walk itself (csrc/packed_walk.cuh, shared with kernel G) does every
// float operation of the plain version, in its order, with no contraction
// (--fmad=false), divisions and square roots IEEE-rounded, so the kernel
// equals _walk_plain bit for bit on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_walk.cuh"

namespace {

using packed::HairLeaf;
using packed::Ray;
using packed::TriLeaf;

constexpr int THREADS = 128;

template <class Leaf, bool ANY>
__global__ void __launch_bounds__(THREADS)
    walk_kernel(const float* __restrict__ nodes,
                const float* __restrict__ rows, int M, int L, int K,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ mint_in,
                const float* __restrict__ maxt_in, int N,
                float* __restrict__ t_out, int* __restrict__ pid_out,
                int* __restrict__ occ_out, int* __restrict__ err) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
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
  const int rc = packed::walk<Leaf, ANY>(nodes, rows, M, L, K, r, maxt_in[n],
                                         best_t, best_p, occ);
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

// leaf: 0 triangles, 1 hair; any_hit: 0 closest (t, pid written), 1 any
// (occ written). K is the leaf size (primitives per leaf row), L the
// number of leaf rows. *err: 1 where a walk reached 2 M steps, 2 where
// an index lay outside the tree.
int hairpt_packed_walk(const void* nodes, const void* rows, int M, int L,
                       int K, int leaf, int any_hit, const void* o,
                       const void* d, const void* mint, const void* maxt,
                       int N, void* t, void* pid, void* occ, void* err,
                       void* stream) {
  if (N <= 0) return 0;
  if (M <= 0 || L <= 0 || K < 1 || K > 31 || (leaf != 0 && leaf != 1) ||
      err == nullptr || (any_hit ? occ == nullptr
                                 : (t == nullptr || pid == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (N + THREADS - 1) / THREADS;
  auto kern = leaf == 0
                  ? (any_hit ? walk_kernel<TriLeaf, true>
                             : walk_kernel<TriLeaf, false>)
                  : (any_hit ? walk_kernel<HairLeaf, true>
                             : walk_kernel<HairLeaf, false>);
  kern<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)nodes, (const float*)rows, M, L, K, (const float*)o,
      (const float*)d, (const float*)mint, (const float*)maxt, N, (float*)t,
      (int*)pid, (int*)occ, (int*)err);
  return (int)cudaGetLastError();
}

}  // extern "C"
