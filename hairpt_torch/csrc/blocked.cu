// Kernel I: the block-shared BVH walk over the SoA BVHArrays for Hopper
// (sm_90a), traversal='blocked', the triangles' and the hair's closest
// and any hit.
//
// Plain C interface for ctypes; the PyTorch wrappers (closest_hit_blocked,
// any_hit_blocked) and the plain version are in
// hairpt_torch/ops/intersect_blocked.py. Built like perray.cu, as a
// library of its own. The entry point launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() right after the
// launch.
//
// Replaces, on the card, the JAX package's block walk
// (hairpt/ops/intersect_blocked.py:111-231 closest_hit_blocked,
// any_hit_blocked: one jax.lax.while_loop over all blocks, a jnp.any over
// each block per step; XLA array code, no Pallas kernel). One CTA per
// block of B rays (B a multiple of 32, at most 1024), one thread per
// lane; the block's node index is uniform:
//   - every thread reads the node (the same address: one broadcast load)
//     and slab-tests its own ray (csrc/packed_walk.cuh box_hit), an
//     any-hit lane only while it is not occluded;
//   - __syncthreads_or of the lanes' box hits is the JAX package's
//     jnp.any: the block descends on it at an inner node;
//   - at a leaf the block enters, the threads stage its min(count, 4)
//     primitives into shared memory, then each lane that entered the box
//     tests them in order with kernel F's arithmetic and tie rules
//     against its own shrinking maxt;
//   - the any hit ends the block once __syncthreads_and(occ || maxt <=
//     mint) holds; it starts with the lanes whose maxt <= mint counted
//     as occluded and returns occ && !(maxt <= mint).
// No thread leaves the loop early (padded lanes, maxt 0, walk with the
// rest), so every thread reaches each barrier. A block's walk is capped
// at 2 M steps; the cap or an index outside the tree sets *err, which
// the wrapper raises on. Every float operation is the plain version's,
// in its order, with no contraction (--fmad=false), so the kernel equals
// it bit for bit on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_walk.cuh"

namespace {

using packed::ArraysTree;
using packed::GeomPtrs;
using packed::HairGeom;
using packed::LEAF;
using packed::Node;
using packed::Ray;
using packed::TriGeom;

constexpr int MAX_BLOCK = 1024;

template <class Geom, bool ANY>
__global__ void __launch_bounds__(MAX_BLOCK)
    blocked_kernel(const float* __restrict__ lo, const float* __restrict__ hi,
                   const int* __restrict__ left, const int* __restrict__ count,
                   const int* __restrict__ skip, int M, GeomPtrs geom, int P,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ mint_in,
                   const float* __restrict__ maxt_in,
                   float* __restrict__ t_out, int* __restrict__ pid_out,
                   int* __restrict__ occ_out, int* __restrict__ err) {
  __shared__ float prims[LEAF * Geom::NF];
  const ArraysTree<Geom> tree{lo, hi, left, count, skip, geom, M, P};
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r;
  r.ox = o[3 * n];
  r.oy = o[3 * n + 1];
  r.oz = o[3 * n + 2];
  r.dx = d[3 * n];
  r.dy = d[3 * n + 1];
  r.dz = d[3 * n + 2];
  r.mint = mint_in[n];
  float maxt = maxt_in[n];
  const float ix = packed::inv_dir(r.dx), iy = packed::inv_dir(r.dy),
              iz = packed::inv_dir(r.dz);
  const bool degenerate = maxt <= r.mint;
  bool occ = ANY && degenerate;
  float best_t = packed::f_inf();
  int best_p = -1;
  const long long cap = 2LL * M;
  long long steps = 0;
  int rc = 0;
  int node = 0;
  // node, steps and rc are uniform over the block: every branch on them
  // is taken by all threads together
  while (node != M) {
    if (steps == cap) {
      rc = packed::ERR_CAP;
      break;
    }
    if ((unsigned)node >= (unsigned)M) {
      rc = packed::ERR_RANGE;
      break;
    }
    ++steps;
    const Node nd = tree.node(node);
    bool hit_box = packed::box_hit(nd, r, ix, iy, iz, maxt);
    if (ANY) hit_box = hit_box && !occ;
    const bool entered = __syncthreads_or(hit_box) != 0;
    if (entered && nd.leaf) {
      if (!tree.leaf_ok(nd)) {
        rc = packed::ERR_RANGE;
        break;
      }
      for (int i = threadIdx.x; i < nd.count * Geom::NF; i += blockDim.x)
        prims[i] = Geom::get(tree.geom.f, nd.child + i / Geom::NF,
                             i % Geom::NF);
      __syncthreads();
      if (hit_box) {
        float tb = packed::f_inf();
        int pb = -1;
        for (int j = 0; j < nd.count; ++j) {
          float t;
          if (Geom::hit(prims + j * Geom::NF, r, maxt, t)) {
            if (ANY) {
              occ = true;
              break;
            }
            if (t < tb) {
              tb = t;
              pb = nd.child + j;
            }
          }
        }
        if (!ANY && tb < maxt) {
          maxt = tb;
          best_t = tb;
          best_p = pb;
        }
      }
      // the next leaf's staging must wait for every lane's tests
      __syncthreads();
    }
    if (ANY) {
      const bool done = __syncthreads_and(occ || maxt <= r.mint) != 0;
      node = (entered && !nd.leaf && !done) ? nd.child
                                            : (done ? M : nd.skip);
    } else {
      node = (entered && !nd.leaf) ? nd.child : nd.skip;
    }
  }
  if (rc != 0 && threadIdx.x == 0) atomicExch(err, rc);
  if (ANY) {
    occ_out[n] = (occ && !degenerate) ? 1 : 0;
  } else {
    t_out[n] = best_t;
    pid_out[n] = best_p;
  }
}

}  // namespace

extern "C" {

// geom and any_hit as in hairpt_perray_walk (perray.cu); N a multiple of
// block, block a multiple of 32 in [32, 1024]. *err: 1 where a block's
// walk reached 2 M steps, 2 where an index lay outside the tree.
int hairpt_blocked_walk(const void* lo, const void* hi, const void* left,
                        const void* count, const void* skip, int M,
                        const void* const* geom, int P, int leaf,
                        int any_hit, const void* o, const void* d,
                        const void* mint, const void* maxt, int N, int block,
                        void* t, void* pid, void* occ, void* err,
                        void* stream) {
  if (N <= 0) return 0;
  const int nf = leaf == 0 ? 3 : 5;
  if (M <= 0 || P < 0 || (leaf != 0 && leaf != 1) || geom == nullptr ||
      err == nullptr || block <= 0 || block % 32 != 0 ||
      block > MAX_BLOCK || N % block != 0 ||
      (any_hit ? occ == nullptr : (t == nullptr || pid == nullptr)))
    return (int)cudaErrorInvalidValue;
  GeomPtrs g{};
  for (int i = 0; i < nf; ++i) {
    if (geom[i] == nullptr && P > 0) return (int)cudaErrorInvalidValue;
    g.f[i] = (const float*)geom[i];
  }
  auto kern = leaf == 0 ? (any_hit ? blocked_kernel<TriGeom, true>
                                   : blocked_kernel<TriGeom, false>)
                        : (any_hit ? blocked_kernel<HairGeom, true>
                                   : blocked_kernel<HairGeom, false>);
  kern<<<N / block, block, 0, (cudaStream_t)stream>>>(
      (const float*)lo, (const float*)hi, (const int*)left,
      (const int*)count, (const int*)skip, M, g, P, (const float*)o,
      (const float*)d, (const float*)mint, (const float*)maxt, (float*)t,
      (int*)pid, (int*)occ, (int*)err);
  return (int)cudaGetLastError();
}

}  // extern "C"
