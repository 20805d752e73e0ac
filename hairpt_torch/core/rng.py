"""Stateless counter-based sampling (port of hairpt/core/rng.py).

Every sample dimension is a pure function of (pixel, sample, dim). torch
has no uint32 arithmetic on every operation, so u32 values live in int64
lanes and every product or sum is masked back with `& 0xFFFFFFFF`; the
results are bit-identical to the JAX package's uint32 arithmetic.

Three modes are ported:
- INDEPENDENT: the PCG hash (PCG-RXS-M-XS) mapped to floats;
- SOBOL: the padded Owen-scrambled (0,2)-sequence (the inverse-rendering
  example's sampler);
- SOBOL_QMC: the true high-dimensional Sobol' sequence with the per-pixel
  elementary-interval lookup, as `mode=(SOBOL_QMC, m, width)`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import sobolseq as sq

M32 = 0xFFFFFFFF

INDEPENDENT = 0
SOBOL = 1
SOBOL_QMC = 4


def _u32(x, device=None):
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x, np.int64), device=device)
    return x.to(torch.int64) & M32


def hash_u32(x):
    """PCG output mix (PCG-RXS-M-XS) of a uint32."""
    x = _u32(x)
    state = (x * 747796405 + 2891336453) & M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & M32
    return (word >> 22) ^ word


def hash_combine(a, b):
    """Mix two uint32 streams (order-sensitive)."""
    a = _u32(a)
    mix = (hash_u32(b) + 0x9E3779B9 + ((a << 6) & M32) + (a >> 2)) & M32
    return hash_u32(a ^ mix)


def u32_to_unit_float(x):
    """uint32 -> float32 in [0, 1) from the top 24 bits."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform_1d(pixel, sample, dim):
    h = hash_combine(hash_combine(pixel, sample), dim)
    return u32_to_unit_float(h)


def uniform_2d(pixel, sample, dim):
    h = hash_combine(hash_combine(pixel, sample), dim)
    h2 = hash_u32((h + 0x68bc21eb) & M32)
    return torch.stack([u32_to_unit_float(h), u32_to_unit_float(h2)], dim=-1)


def _mul32(x, c: int):
    """(x * c) mod 2^32 for u32 lanes x and a u32 constant c, in halves
    so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def reverse_bits_u32(x):
    x = _u32(x)
    x = ((x << 16) | (x >> 16)) & M32
    x = ((x & 0x00ff00ff) << 8) | ((x & 0xff00ff00) >> 8)
    x = ((x & 0x0f0f0f0f) << 4) | ((x & 0xf0f0f0f0) >> 4)
    x = ((x & 0x33333333) << 2) | ((x & 0xcccccccc) >> 2)
    x = ((x & 0x55555555) << 1) | ((x & 0xaaaaaaaa) >> 1)
    return x


def _laine_karras_permutation(x, seed):
    """Hash acting on reversed bits => per-digit Owen scramble (Burley
    2020)."""
    x = (_u32(x) + _u32(seed)) & M32
    for c in (0x6c50b47c, 0xb82f1e52, 0xc7afe638, 0x8d22f6e6):
        x = x ^ _mul32(x, c)
    return x


def owen_scramble_u32(x, seed):
    return reverse_bits_u32(_laine_karras_permutation(reverse_bits_u32(x),
                                                      seed))


def _sobol02_u32(index):
    """First two components of the Sobol (0,2)-sequence as uint32
    fractions."""
    index = _u32(index)
    x0 = reverse_bits_u32(index)  # van der Corput
    n = index
    v = torch.full_like(index, 1 << 31)
    x1 = torch.zeros_like(index)
    for _ in range(32):
        x1 = torch.where((n & 1) != 0, x1 ^ v, x1)
        n = n >> 1
        v = v ^ (v >> 1)
    return x0, x1


def sobol_2d(pixel, sample, dim):
    """Owen-scrambled (0,2)-point `sample` of the stream keyed by (pixel,
    dim); the sample index itself is Owen-shuffled per (pixel, dim), so
    the padded dimensions decorrelate (pbrt / Burley's padded Sobol')."""
    key = hash_combine(_u32(pixel), dim)
    shuffled = owen_scramble_u32(_u32(sample, key.device),
                                 hash_u32(key ^ 0xa511e9b3))
    x0, x1 = _sobol02_u32(shuffled)
    x0 = owen_scramble_u32(x0, hash_u32(key ^ 0x4117abf3))
    x1 = owen_scramble_u32(x1, hash_u32(key ^ 0x7f1d2ce7))
    return torch.stack([u32_to_unit_float(x0), u32_to_unit_float(x1)],
                       dim=-1)


_TABLES: dict = {}


def sobol_tables(m: int, device):
    """(byte tables [N_DIMS, 4, 256] int64, shift [N_DIMS] (numpy),
    pixel-lookup masks [m] (numpy)) for film resolution 2^m."""
    key = (m, str(device))
    if key not in _TABLES:
        dirs, shift = sq.make_np_tables()
        tables = torch.as_tensor(sq.byte_tables(dirs).astype(np.int64),
                                 device=device)
        _TABLES[key] = (tables, shift, sq.pixel_lookup_tables(m))
    return _TABLES[key]


def sobol_index(m: int, width: int, pixel, sample):
    """Global Sobol' index of (pixel, sample-in-pixel)."""
    tables, _, masks = sobol_tables(m, pixel.device)
    px = pixel % width
    py = pixel // width
    return sq.interval_to_index(m, masks, tables, sample, px, py)


def sobol_qmc_at(m: int, pixel, sample, index, dim: int, n_comp: int):
    """Components [dim, dim+n_comp) of the global point `index` (already
    looked up for (pixel, sample)). Dims 0/1 return the in-pixel
    fractional position; dims past the table fall back to the hash."""
    tables, shift, _ = sobol_tables(m, index.device)
    outs = []
    for c in range(n_comp):
        d = dim + c
        if d >= sq.N_DIMS:
            x = hash_combine(hash_combine(pixel, sample), d)
        else:
            x = sq.sobol_u32(tables, d, index) ^ int(shift[d])
            if d < 2:
                x = (x << m) & M32
        outs.append(u32_to_unit_float(x))
    return torch.stack(outs, dim=-1)


def sobol_qmc(m: int, width: int, pixel, sample, dim: int, n_comp: int):
    """Functional form of hairpt.core.rng.sobol_qmc for a static dim."""
    pixel = _u32(pixel)
    sample = _u32(sample, pixel.device)
    sample = torch.broadcast_to(sample, pixel.shape)
    i = sobol_index(m, width, pixel, sample)
    return sobol_qmc_at(m, pixel, sample, i, dim, n_comp)


class Sampler:
    """Per-wave sample source: holds the lanes' (pixel, sample) and, for
    SOBOL_QMC, their global Sobol' index, looked up once per wave (the
    JAX package recomputes it per request and relies on CSE)."""

    def __init__(self, mode, pixel, sample, index=None):
        self.mode = mode
        self.pixel = _u32(pixel)
        self.sample = torch.broadcast_to(_u32(sample, self.pixel.device),
                                         self.pixel.shape)
        self.index = index
        if index is None and self._qmc():
            self.index = sobol_index(mode[1], mode[2], self.pixel,
                                     self.sample)

    def _qmc(self):
        return isinstance(self.mode, tuple) and self.mode[0] == SOBOL_QMC

    def take(self, order) -> "Sampler":
        return Sampler(self.mode, self.pixel[order], self.sample[order],
                       None if self.index is None else self.index[order])

    def next_1d(self, dim: int):
        if self._qmc():
            return sobol_qmc_at(self.mode[1], self.pixel, self.sample,
                                self.index, dim, 1)[..., 0]
        if self.mode == INDEPENDENT:
            return uniform_1d(self.pixel, self.sample, dim)
        if self.mode == SOBOL:
            return sobol_2d(self.pixel, self.sample, dim)[..., 0]
        raise NotImplementedError(f"sampler mode {self.mode!r} is not "
                                  "ported")

    def next_2d(self, dim: int):
        if self._qmc():
            return sobol_qmc_at(self.mode[1], self.pixel, self.sample,
                                self.index, dim, 2)
        if self.mode == INDEPENDENT:
            return uniform_2d(self.pixel, self.sample, dim)
        if self.mode == SOBOL:
            return sobol_2d(self.pixel, self.sample, dim)
        raise NotImplementedError(f"sampler mode {self.mode!r} is not "
                                  "ported")
