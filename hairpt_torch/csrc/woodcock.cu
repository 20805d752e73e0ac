// Kernel J: Woodcock tracking through a grid volume for Hopper (sm_90a):
// delta tracking (free-flight distance sampling) and ratio tracking
// (shadow-ray transmittance) of a heterogeneous medium.
//
// Plain C interface for ctypes; the PyTorch wrappers (woodcock_sample,
// woodcock_transmittance), the layout contract and the plain versions
// (woodcock_sample_plain, woodcock_transmittance_plain) are in
// hairpt_torch/models/media.py. Built like the other kernels (nvcc
// -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared), as a
// library of its own. The entry point launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() right after the
// launch.
//
// Replaces no TPU kernel: the JAX package writes both walks as a
// jax.lax.while_loop over the wave whose condition is "any lane not done"
// (hairpt/models/media.py:761-827 woodcock_sample, woodcock_transmittance;
// XLA array code). A torch loop of that shape would sync with the host on
// every step, so here one thread walks its lane's whole flight. A lane
// steps once per iteration of the JAX loop until it is done, so its k-th
// step is the loop's iteration k: the thread counts its own steps, draws
// rng.uniform_1d(pixel, sample, dim_base + 0x9E37 k + salt) (the PCG hash
// of hairpt_torch/core/rng.py, written below) and stops at the same cap.
// Vol is the dense trilinear lookup (grid_density) or the block-sparse
// one (hgrid_density). Every float operation is the plain version's, in
// its order, with no contraction, and max / min propagate NaN as torch's
// do, so the kernel equals the plain version bit for bit on the card
// where CUDA's logf and torch's log agree.
//
// Bound: each lane's steps are serial and data dependent; a step is a
// hash (integer work), a log, and eight gathered density reads. The
// function's least time is the rays and the grid read once against the
// counted float work of the steps taken; with few steps per lane (a
// mean free path of a few voxels' width in the cells of this repo) the
// rays' bytes bound it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float nmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp01(float x) {
  return nmin(nmax(x, 0.0f), 1.0f);
}

// hairpt_torch/core/rng.py hash_u32 / hash_combine / u32_to_unit_float
__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  const uint32_t state = x * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}
__device__ __forceinline__ uint32_t hash_combine(uint32_t a, uint32_t b) {
  return hash_u32(a ^ (hash_u32(b) + 0x9E3779B9u + (a << 6) + (a >> 2)));
}
__device__ __forceinline__ float unit_float(uint32_t h) {
  return __fmul_rn((float)(h >> 8), 1.0f / 16777216.0f);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// floor(f) to an int clamped to [0, n - 2], and the clamped weight
// f - i in [0, 1] (media._trilinear's lo)
__device__ __forceinline__ void cell(float f, int n, int& i, float& w) {
  i = clampi((int)floorf(f), 0, n - 2);
  w = clamp01(__fsub_rn(f, (float)i));
}

template <class At>
__device__ __forceinline__ float trilinear(const At& at, float fx, float fy,
                                           float fz, int nx, int ny, int nz) {
  int x0, y0, z0;
  float wx, wy, wz;
  cell(fx, nx, x0, wx);
  cell(fy, ny, y0, wy);
  cell(fz, nz, z0, wz);
  const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy),
              uz = __fsub_rn(1.0f, wz);
  auto lerp = [&](int z, int y) {
    return __fadd_rn(__fmul_rn(at(z, y, x0), ux),
                     __fmul_rn(at(z, y, x0 + 1), wx));
  };
  const float c00 = lerp(z0, y0), c01 = lerp(z0, y0 + 1);
  const float c10 = lerp(z0 + 1, y0), c11 = lerp(z0 + 1, y0 + 1);
  const float c0 = __fadd_rn(__fmul_rn(c00, uy), __fmul_rn(c01, wy));
  const float c1 = __fadd_rn(__fmul_rn(c10, uy), __fmul_rn(c11, wy));
  return __fadd_rn(__fmul_rn(c0, uz), __fmul_rn(c1, wz));
}

struct Box {
  float lo[3], inv[3], hi[3];  // world_min, inv_extent, world max
};

__device__ __forceinline__ bool grid_coords(const Box& b, const float p[3],
                                            float g[3]) {
  bool inside = true;
  for (int a = 0; a < 3; ++a) {
    g[a] = __fmul_rn(__fsub_rn(p[a], b.lo[a]), b.inv[a]);
    inside = inside && (g[a] >= 0.0f) && (g[a] <= 1.0f);
  }
  return inside;
}

// media.grid_density: data [nz, ny, nx], node-centred
struct DenseVol {
  const float* data;
  int nx, ny, nz;
  __device__ float operator()(const Box& box, const float p[3]) const {
    float g[3];
    if (!grid_coords(box, p, g)) return 0.0f;
    auto at = [&](int z, int y, int x) {
      return __ldg(data + ((size_t)z * ny + y) * nx + x);
    };
    return trilinear(at, __fmul_rn(g[0], (float)(nx - 1)),
                     __fmul_rn(g[1], (float)(ny - 1)),
                     __fmul_rn(g[2], (float)(nz - 1)), nx, ny, nz);
  }
};

// media.hgrid_density: block_idx [bz, by, bx] (-1 empty), blocks
// [NB, nb, nb, nb]
struct SparseVol {
  const float* blocks;
  const int* bidx;
  int bx, by, bz, nb;
  __device__ float operator()(const Box& box, const float p[3]) const {
    float g[3];
    if (!grid_coords(box, p, g)) return 0.0f;
    const int n[3] = {bx, by, bz};
    float f[3];
    int c[3];
    for (int a = 0; a < 3; ++a) {
      const float top = (float)(n[a] * nb - 1);
      f[a] = nmin(nmax(__fmul_rn(g[a], top), 0.0f), top);
      c[a] = clampi((int)__fdiv_rn(f[a], (float)nb), 0, n[a] - 1);
    }
    const int bi = __ldg(bidx + ((size_t)c[2] * by + c[1]) * bx + c[0]);
    if (bi < 0) return 0.0f;
    const float* blk = blocks + (size_t)bi * nb * nb * nb;
    auto at = [&](int z, int y, int x) {
      return __ldg(blk + ((size_t)z * nb + y) * nb + x);
    };
    return trilinear(at, __fsub_rn(f[0], (float)(c[0] * nb)),
                     __fsub_rn(f[1], (float)(c[1] * nb)),
                     __fsub_rn(f[2], (float)(c[2] * nb)), nb, nb, nb);
  }
};

struct Params {
  const float* box;  // world_min, inv_extent, world max
  const float* o;
  const float* d;
  const float* tmax;
  const long long* pixel;
  const long long* sample;
  int N, max_steps;
  uint32_t dim_base;
  float inv_mj, smax;
  float* t_out;
  unsigned char* is_med;
  float* tr_out;
};

template <class Vol, bool RATIO>
__global__ void __launch_bounds__(THREADS)
    woodcock_kernel(const Vol vol, const Params P) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= P.N) return;
  float o[3], d[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = P.o[3 * n + a];
    d[a] = P.d[3 * n + a];
  }
  const float t_max = P.tmax[n];
  Box box;
  for (int a = 0; a < 3; ++a) {
    box.lo[a] = __ldg(P.box + a);
    box.inv[a] = __ldg(P.box + 3 + a);
    box.hi[a] = __ldg(P.box + 6 + a);
  }
  // media._bbox_overlap
  float t0 = 0.0f, t1 = 0.0f;
  for (int a = 0; a < 3; ++a) {
    const float da = d[a];
    const float dd =
        fabsf(da) < 1e-12f ? (da >= 0.0f ? 1e-12f : -1e-12f) : da;
    const float inv_d = __fdiv_rn(1.0f, dd);
    const float a0 = __fmul_rn(__fsub_rn(box.lo[a], o[a]), inv_d);
    const float a1 = __fmul_rn(__fsub_rn(box.hi[a], o[a]), inv_d);
    const float mn = nmin(a0, a1), mx = nmax(a0, a1);
    t0 = a == 0 ? mn : nmax(t0, mn);
    t1 = a == 0 ? mx : nmin(t1, mx);
  }
  t0 = nmax(t0, 0.0f);
  t1 = nmin(t1, t_max);
  float t = nmax(t0, 0.0f);
  bool done = t0 >= t1;
  float tr = 1.0f;
  const uint32_t h0 = hash_combine((uint32_t)P.pixel[n],
                                   (uint32_t)P.sample[n]);
  for (int it = 0; it < P.max_steps && !done; ++it) {
    const uint32_t dim = P.dim_base + 0x9E37u * (uint32_t)it;
    const float u1 =
        unit_float(hash_combine(h0, dim + (RATIO ? 0x1234u : 0u)));
    const float step =
        __fmul_rn(logf(nmax(__fsub_rn(1.0f, u1), 1e-20f)), P.inv_mj);
    const float t_new = __fsub_rn(t, step);
    const bool escaped = t_new >= t1;
    float p[3];
    for (int a = 0; a < 3; ++a)
      p[a] = __fadd_rn(o[a], __fmul_rn(d[a], t_new));
    const float sig = __fmul_rn(vol(box, p), P.smax);
    if (RATIO) {
      const float ratio = __fsub_rn(1.0f, __fmul_rn(sig, P.inv_mj));
      if (!escaped) tr = __fmul_rn(tr, nmax(ratio, 0.0f));
      done = escaped || (tr <= 0.0f);
      if (!done) t = t_new;
    } else {
      const float u2 = unit_float(hash_combine(h0, dim + 0x5bd1u));
      const bool real = u2 < __fmul_rn(sig, P.inv_mj);
      t = t_new;
      done = escaped || real;
    }
  }
  if (RATIO) {
    for (int a = 0; a < 3; ++a) P.tr_out[3 * n + a] = tr;
  } else {
    const bool is_med = (t < t1) && (t0 < t1);
    P.t_out[n] = is_med ? t : t_max;
    P.is_med[n] = is_med ? 1 : 0;
  }
}

template <class Vol>
int launch(const Vol& vol, const Params& P, bool ratio, cudaStream_t s) {
  const int blocks = (P.N + THREADS - 1) / THREADS;
  if (ratio)
    woodcock_kernel<Vol, true><<<blocks, THREADS, 0, s>>>(vol, P);
  else
    woodcock_kernel<Vol, false><<<blocks, THREADS, 0, s>>>(vol, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ratio: 0 delta tracking (t_out [N] f32, is_med [N] u8 written), 1 ratio
// tracking (tr [N, 3] f32 written). sparse: 0 data [nz, ny, nx]; 1 data
// the blocks [NB, nb, nb, nb] and bidx [nz, ny, nx] int32 (nx, ny, nz the
// block counts). box [9]: world_min, inv_extent, world max; o, d [N, 3];
// tmax [N]; pixel, sample [N] int64 (the hash takes their low 32 bits).
int hairpt_woodcock(int ratio, int sparse, const void* data,
                    const void* bidx, int nx, int ny, int nz, int nb,
                    int max_steps, int dim_base, const void* box,
                    const void* o, const void* d, const void* tmax,
                    const void* pixel, const void* sample, int N,
                    float inv_mj, float smax, void* t_out, void* is_med,
                    void* tr, void* stream) {
  if (N <= 0) return 0;
  if (data == nullptr || box == nullptr || o == nullptr || d == nullptr ||
      tmax == nullptr || pixel == nullptr || sample == nullptr || nx < 1 ||
      ny < 1 || nz < 1 || max_steps < 0 ||
      (ratio ? tr == nullptr : (t_out == nullptr || is_med == nullptr)) ||
      (sparse ? (bidx == nullptr || nb < 2)
              : (nx < 2 || ny < 2 || nz < 2)))
    return (int)cudaErrorInvalidValue;
  const Params P{(const float*)box, (const float*)o, (const float*)d,
                 (const float*)tmax, (const long long*)pixel,
                 (const long long*)sample, N, max_steps, (uint32_t)dim_base,
                 inv_mj, smax, (float*)t_out, (unsigned char*)is_med,
                 (float*)tr};
  const cudaStream_t s = (cudaStream_t)stream;
  if (sparse)
    return launch(SparseVol{(const float*)data, (const int*)bidx, nx, ny, nz,
                            nb},
                  P, ratio != 0, s);
  return launch(DenseVol{(const float*)data, nx, ny, nz}, P, ratio != 0, s);
}

}  // extern "C"
