"""Procedural noise: improved Perlin noise and the TEA counter hash (port
of hairpt/core/noise.py).

Counterparts of the reference's src/librender/noise.cpp (Ken Perlin's
improved noise, the GRAD_PERLIN variant) and
include/mitsuba/core/qmc.h:146 sampleTEA / sampleTEAFloat, batched over
tensors; the irawan cloth BSDF draws its yarn-level variation from them.
TEA is u32 arithmetic: the values live in int64 lanes and every sum and
shift is masked back with `& 0xFFFFFFFF`, as core/rng.py does, so the
results are the JAX package's uint32 results bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF

# Ken Perlin's reference permutation (public domain), doubled for
# overflow-free nested lookups (noise.cpp NoisePerm)
_PERM = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68,
    175, 74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111,
    229, 122, 60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244,
    102, 143, 54, 65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208,
    89, 18, 169, 200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109,
    198, 173, 186, 3, 64, 52, 217, 226, 250, 124, 123, 5, 202, 38, 147,
    118, 126, 255, 82, 85, 212, 207, 206, 59, 227, 47, 16, 58, 17, 182,
    189, 28, 42, 223, 183, 170, 213, 119, 248, 152, 2, 44, 154, 163, 70,
    221, 153, 101, 155, 167, 43, 172, 9, 129, 22, 39, 253, 19, 98, 108,
    110, 79, 113, 224, 232, 178, 185, 112, 104, 218, 246, 97, 228, 251,
    34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241, 81, 51, 145,
    235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157, 184,
    84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156,
    180], np.int32)
_PERM2 = np.concatenate([_PERM, _PERM])


def _grad(perm, ix, iy, iz, dx, dy, dz):
    h = perm[perm[perm[ix] + iy] + iz] & 15
    u = torch.where(h < 8, dx, dy)
    v = torch.where(h < 4, dy, torch.where((h == 12) | (h == 14), dx, dz))
    return torch.where((h & 1) != 0, -u, u) + torch.where((h & 2) != 0, -v, v)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin(p):
    """Improved Perlin noise at points p [..., 3] (noise.cpp:64-111);
    output roughly in [-1, 1]."""
    perm = torch.as_tensor(_PERM2, dtype=torch.int64, device=p.device)
    pf = torch.floor(p)
    i = pf.to(torch.int32).to(torch.int64) & 255
    d = p - pf
    ix, iy, iz = i[..., 0], i[..., 1], i[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    w000 = _grad(perm, ix, iy, iz, dx, dy, dz)
    w100 = _grad(perm, ix + 1, iy, iz, dx - 1, dy, dz)
    w010 = _grad(perm, ix, iy + 1, iz, dx, dy - 1, dz)
    w110 = _grad(perm, ix + 1, iy + 1, iz, dx - 1, dy - 1, dz)
    w001 = _grad(perm, ix, iy, iz + 1, dx, dy, dz - 1)
    w101 = _grad(perm, ix + 1, iy, iz + 1, dx - 1, dy, dz - 1)
    w011 = _grad(perm, ix, iy + 1, iz + 1, dx, dy - 1, dz - 1)
    w111 = _grad(perm, ix + 1, iy + 1, iz + 1, dx - 1, dy - 1, dz - 1)
    wx, wy, wz = _fade(dx), _fade(dy), _fade(dz)
    x00 = w000 * (1 - wx) + w100 * wx
    x10 = w010 * (1 - wx) + w110 * wx
    x01 = w001 * (1 - wx) + w101 * wx
    x11 = w011 * (1 - wx) + w111 * wx
    y0 = x00 * (1 - wy) + x10 * wy
    y1 = x01 * (1 - wy) + x11 * wy
    return y0 * (1 - wz) + y1 * wz


def fbm(p, omega: float = 0.5, lam: float = 1.99, octaves: int = 6):
    """Fractional Brownian motion over perlin() (noise.cpp fbm)."""
    out = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    o = 1.0
    scale = 1.0
    for _ in range(octaves):
        out = out + o * perlin(p * scale)
        scale *= lam
        o *= omega
    return out


def _u32(x):
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x, np.int64))
    return x.to(torch.int64) & M32


def float_to_u32(x):
    """A float tensor cast to u32 (in int64 lanes) by XLA's rule, which
    the JAX package's `astype(uint32)` follows: truncation toward zero,
    saturating (negative values and NaN give 0, values past 2^32 - 1 give
    2^32 - 1)."""
    x = torch.clamp(torch.nan_to_num(x, nan=0.0), 0.0, 2.0 ** 33)
    return torch.clamp(x.to(torch.int64), max=M32)


def sample_tea(v0, v1, rounds: int = 4):
    """TEA block cipher as a counter hash (qmc.h:146 sampleTEA). v0, v1:
    u32 values (int64 lanes or anything torch.as_tensor takes); returns
    (v0', v1') as u32 in int64 lanes."""
    v0 = _u32(v0)
    v1 = _u32(v1)
    s = 0
    for _ in range(rounds):
        s = (s + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & M32) ^ ((v1 + s) & M32)
                    ^ (((v1 >> 5) + 0xC8013EA4) & M32))) & M32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & M32) ^ ((v0 + s) & M32)
                    ^ (((v0 >> 5) + 0x7E95761E) & M32))) & M32
    return v0, v1


def sample_tea_float(v0, v1, rounds: int = 4):
    """Uniform float32 in [0, 1) from the TEA hash (qmc.h sampleTEAFloat:
    the low word's top 23 bits as a [1, 2) mantissa, minus one)."""
    lo, _ = sample_tea(v0, v1, rounds)
    bits = (lo >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
