// Kernel L: the Ward-weighted irradiance-cache interpolation for Hopper
// (sm_90a): each lane's indirect irradiance interpolated from every cache
// record, in one pass over the records.
//
// Plain C interface for ctypes; the PyTorch wrapper (interp), the layout
// contract, the plain version (interp_plain) and the transcription of
// this per-thread loop (interp_thread) are in
// hairpt_torch/ops/irrcache_interp.py. Built like the other kernels (nvcc
// -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared), as a
// library of its own. The entry point launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() right after the
// launch.
//
// Replaces no TPU kernel: the JAX package's render pass writes the
// interpolation as dense XLA array code over [N lanes, M records]
// (hairpt/integrators/irrcache.py:273-308), with [N, M, 3] temporaries
// (51.5 GB each at 1024^2 lanes and 4,096 records). Here one thread
// takes one lane and walks every record; the records pass through shared
// memory in tiles of TILE, each thread of the block loading one.
//
// Per (lane, record), in the JAX package's formulas and order:
//   diff = p - cpos, d2 = |diff|^2, ndot = clip(n . cnrm, -1, 1),
//   arg = sqrt(d2) / k + sqrt(max(1 - ndot, 0)) + 1e-4,
//   w = ndot > 0.2 ? 1 / arg : 0,  w_cut = arg < kappa ? w : 0,
//   GRAD: e_rec = max(e_ind + cross(cnrm, n) . r_grad + diff . t_grad, 0)
//         (the gradients [world axis, colour], summed over the axis)
//   else: e_rec = e_ind.
// Per lane: the sums of w, w_cut, w e_rec and w_cut e_rec, each first
// over a tile of records, then over the tiles (the error of a float sum
// of 4,096 positive terms stays near that of 2 x 64); has_cut = sum of
// w_cut > 0 picks the cut sums, else the smooth ones; e = sum(w e_rec) /
// max(sum(w), 1e-9). A lane that is not valid writes e = 0, has_cut = 0.
// Every float operation is a round-to-nearest intrinsic with no
// contraction, so each pair's terms equal the plain version's bit for
// bit; the sums differ from the plain version's only in their order.
//
// Bound: GRAD 89 f32 operations per pair, 41 without (counted in
// chip_smoke.py's L_PAIR_FLOPS); at 1,048,576 lanes and 4,096 records
// about 380 GFLOP, ~5.7 ms at 67 TFLOP/s. The design is the simple one:
// one thread per lane, every record, no structure over the records.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = THREADS;   // records per shared-memory tile

// a record's floats: cpos 3, cnrm 3, e_ind 3, and with GRAD r_grad [3][3]
// and t_grad [3][3] (row = world axis, column = colour)
template <bool GRAD>
struct Rec {
  static constexpr int W = GRAD ? 27 : 9;
};

template <bool GRAD>
__global__ void __launch_bounds__(THREADS)
interp_kernel(const float* __restrict__ p, const float* __restrict__ nrm,
              const unsigned char* __restrict__ valid, int N,
              const float* __restrict__ rec, int M, float k, float kappa,
              float* __restrict__ e_out, unsigned char* __restrict__ cut_out) {
  constexpr int W = Rec<GRAD>::W;
  __shared__ float tile[TILE * W];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < N && valid[i];
  float px = 0.f, py = 0.f, pz = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  if (live) {
    px = p[3 * i]; py = p[3 * i + 1]; pz = p[3 * i + 2];
    nx = nrm[3 * i]; ny = nrm[3 * i + 1]; nz = nrm[3 * i + 2];
  }
  // a block with no live lane skips the records (every thread agrees)
  const bool any = __syncthreads_or(live);
  float sw = 0.f, swc = 0.f;
  float se[3] = {0.f, 0.f, 0.f}, sec[3] = {0.f, 0.f, 0.f};
  for (int t0 = 0; any && t0 < M; t0 += TILE) {
    const int nt = min(TILE, M - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < nt * W; j += THREADS)
      tile[j] = rec[(size_t)t0 * W + j];
    __syncthreads();
    if (!live) continue;
    float tw = 0.f, twc = 0.f;
    float te[3] = {0.f, 0.f, 0.f}, tec[3] = {0.f, 0.f, 0.f};
    for (int r = 0; r < nt; ++r) {
      const float* R = tile + r * W;
      const float dx = __fsub_rn(px, R[0]);
      const float dy = __fsub_rn(py, R[1]);
      const float dz = __fsub_rn(pz, R[2]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      float ndot = __fadd_rn(__fadd_rn(__fmul_rn(nx, R[3]),
                                       __fmul_rn(ny, R[4])),
                             __fmul_rn(nz, R[5]));
      ndot = fminf(fmaxf(ndot, -1.0f), 1.0f);
      const float arg = __fadd_rn(
          __fadd_rn(__fdiv_rn(__fsqrt_rn(d2), k),
                    __fsqrt_rn(fmaxf(__fsub_rn(1.0f, ndot), 0.0f))),
          1e-4f);
      const float w = ndot > 0.2f ? __fdiv_rn(1.0f, arg) : 0.0f;
      const float wc = arg < kappa ? w : 0.0f;
      float e[3];
      if (GRAD) {
        // cross(cnrm, n)
        const float c0 = __fsub_rn(__fmul_rn(R[4], nz), __fmul_rn(R[5], ny));
        const float c1 = __fsub_rn(__fmul_rn(R[5], nx), __fmul_rn(R[3], nz));
        const float c2 = __fsub_rn(__fmul_rn(R[3], ny), __fmul_rn(R[4], nx));
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float rg = __fadd_rn(
              __fadd_rn(__fmul_rn(c0, R[9 + c]), __fmul_rn(c1, R[12 + c])),
              __fmul_rn(c2, R[15 + c]));
          const float tg = __fadd_rn(
              __fadd_rn(__fmul_rn(dx, R[18 + c]), __fmul_rn(dy, R[21 + c])),
              __fmul_rn(dz, R[24 + c]));
          e[c] = fmaxf(__fadd_rn(__fadd_rn(R[6 + c], rg), tg), 0.0f);
        }
      } else {
        e[0] = R[6]; e[1] = R[7]; e[2] = R[8];
      }
      tw = __fadd_rn(tw, w);
      twc = __fadd_rn(twc, wc);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        te[c] = __fadd_rn(te[c], __fmul_rn(w, e[c]));
        tec[c] = __fadd_rn(tec[c], __fmul_rn(wc, e[c]));
      }
    }
    sw = __fadd_rn(sw, tw);
    swc = __fadd_rn(swc, twc);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      se[c] = __fadd_rn(se[c], te[c]);
      sec[c] = __fadd_rn(sec[c], tec[c]);
    }
  }
  if (i >= N) return;
  const bool cut = live && swc > 0.0f;
  const float den = fmaxf(cut ? swc : sw, 1e-9f);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    e_out[3 * i + c] = live ? __fdiv_rn(cut ? sec[c] : se[c], den) : 0.0f;
  cut_out[i] = cut ? 1 : 0;
}

}  // namespace

extern "C" {

// grad: 1 with the records' gradients (rec [M, 27]), 0 without (rec
// [M, 9]). p, nrm [N, 3] f32, valid [N] u8; e_out [N, 3] f32, cut_out [N]
// u8 written. k = k_norm_radius, kappa the weight cutoff.
int hairpt_irrcache(int grad, const void* p, const void* nrm,
                    const void* valid, int N, const void* rec, int M,
                    float k, float kappa, void* e_out, void* cut_out,
                    void* stream) {
  if (N <= 0) return 0;
  if (p == nullptr || nrm == nullptr || valid == nullptr ||
      e_out == nullptr || cut_out == nullptr || M < 0 ||
      (M > 0 && rec == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (N + THREADS - 1) / THREADS;
  if (grad)
    interp_kernel<true><<<blocks, THREADS, 0, st>>>(
        (const float*)p, (const float*)nrm, (const unsigned char*)valid, N,
        (const float*)rec, M, k, kappa, (float*)e_out,
        (unsigned char*)cut_out);
  else
    interp_kernel<false><<<blocks, THREADS, 0, st>>>(
        (const float*)p, (const float*)nrm, (const unsigned char*)valid, N,
        (const float*)rec, M, k, kappa, (float*)e_out,
        (unsigned char*)cut_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
