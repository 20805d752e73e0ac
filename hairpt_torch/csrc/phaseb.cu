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

constexpr int MAX_CH = 256;   // rays per chunk the launch accepts

// ---------------------------------------------------------------------------
// Kernel E: miter-cylinder tests of one chunk of rays against one cluster.
//
// Replaces hairpt/ops/pallas_phaseb.py::_phaseb_kernel / _phaseb_one
// (called through phase_b_pallas, pallas_phaseb.py:186). The swept
// traversal sorts its (ray, cluster) pairs by cluster and pads each
// cluster's run to whole chunks of CH pairs, so chunk i holds CH rays
// (chunk_rays[i], dead lanes with maxt = -1) that all go to cluster
// chunk_cl[i]. Each ray gets the closest hit over the cluster's K
// segments with the JAX kernel's tie rule: the minimum t and, among the
// lanes at that t, the largest pid. A dead chunk (cluster -1) writes
// misses and loads nothing. The arithmetic is _phaseb_one's (two
// divisions by a, miter planes through the hit point), not the tiled
// kernels'.
//
// What bounds it: operations. Each live chunk does CH x K cylinder tests
// (~100 f32 operations each) on one 8 KB segment block (K = 128) and CH
// rays of 32 bytes. Design: one block per chunk, one thread per ray; the
// cluster's [16, K] block is staged in shared memory with float4 loads
// and read by broadcast. The JAX kernel's padding of the chunk count to
// groups of 8 is a TPU tiling rule and is not needed here.
// ---------------------------------------------------------------------------
template <int K>
__global__ void __launch_bounds__(MAX_CH)
chunk_kernel(const int* __restrict__ chunk_cl,       // [n_chunks]
             const float* __restrict__ chunk_rays,   // [n_chunks, 8, CH]
             const float* __restrict__ seg_rows,     // [C, 16, K]
             int ch,
             float* __restrict__ t_out,              // [n_chunks, CH]
             int* __restrict__ pid_out) {            // [n_chunks, CH]
  __shared__ __align__(16) float s_rows[16 * K];

  const size_t chunk = blockIdx.x;
  const int r = threadIdx.x;
  const int cl = chunk_cl[chunk];
  if (cl < 0) {
    if (r < ch) {
      t_out[chunk * ch + r] = f_inf();
      pid_out[chunk * ch + r] = -1;
    }
    return;
  }
  const float4* src =
      reinterpret_cast<const float4*>(seg_rows + (size_t)cl * 16 * K);
  float4* dst = reinterpret_cast<float4*>(s_rows);
  for (int i = r; i < 4 * K; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
  if (r >= ch) return;

  const RayRegs y =
      hairpt_dev::load_ray(chunk_rays + chunk * 8 * ch, ch, r);
  float best = f_inf();
  int bpid = -1;
#pragma unroll 8
  for (int l = 0; l < K; ++l) {
    float t;
    int pid;
    if (hairpt_dev::cyl_hit_chunk<K>(s_rows, l, y, t, pid)) {
      if (t < best) {
        best = t;
        bpid = pid;
      } else if (t == best) {
        bpid = max(bpid, pid);
      }
    }
  }
  t_out[chunk * ch + r] = best;
  pid_out[chunk * ch + r] = bpid;
}

}  // namespace

extern "C" {

int hairpt_phase_b_chunks(const void* chunk_cl, const void* chunk_rays,
                          const void* seg_rows, int n_chunks, int ch, int K,
                          void* t_out, void* pid_out, void* stream) {
  if (n_chunks <= 0) return 0;
  if (ch <= 0 || ch > MAX_CH) return (int)cudaErrorInvalidValue;
  const int threads = (ch + 31) / 32 * 32;
  cudaStream_t st = (cudaStream_t)stream;
#define HAIRPT_E(KK)                                                      \
  case KK:                                                                \
    chunk_kernel<KK><<<n_chunks, threads, 0, st>>>(                       \
        (const int*)chunk_cl, (const float*)chunk_rays,                   \
        (const float*)seg_rows, ch, (float*)t_out, (int*)pid_out);        \
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
