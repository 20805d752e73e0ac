"""Stateless counter-based sampling (port of hairpt/core/rng.py).

Every sample dimension is a pure function of (pixel, sample, dim). torch
has no uint32 arithmetic on every operation, so u32 values live in int64
lanes and every product or sum is masked back with `& 0xFFFFFFFF`; the
results are bit-identical to the JAX package's uint32 arithmetic.

The JAX package's five modes:
- INDEPENDENT: the PCG hash (PCG-RXS-M-XS) mapped to floats;
- SOBOL: the padded Owen-scrambled (0,2)-sequence (the inverse-rendering
  example's sampler, and the scene XML's `ldsampler`);
- HALTON: the Faure-permuted Halton sequence, Cranley-Patterson rotated
  per pixel (the scene XML's `halton` and `hammersley`);
- STRATIFIED: jittered strata shuffled per (pixel, dim), as
  `mode=(STRATIFIED, spp)`, exact for power-of-two spp (independent
  samples otherwise);
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
HALTON = 2
STRATIFIED = 3
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


def _mul32(x, c):
    """(x * c) mod 2^32 for u32 lanes x and a u32 constant or u32 lanes c,
    in halves so no int64 product overflows."""
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


def _strat_perm(sample, spp_mask: int, pixel, dim: int):
    """Bijection of the sample index within [0, 2^k): XOR, then an odd
    multiply, keyed per (pixel, dim) (the reference stratified sampler's
    per-pixel stratum shuffle without permutation tables)."""
    key = hash_combine(_u32(pixel), dim)
    h1 = hash_u32(key ^ 0x9E3779B9)
    h2 = hash_u32(key ^ 0x85EBCA6B) | 1
    return _mul32(_u32(sample) ^ h1, h2) & spp_mask


def stratified_1d(pixel, sample, dim: int, spp: int):
    perm = _strat_perm(sample, spp - 1, pixel, dim)
    return (perm.to(torch.float32) + uniform_1d(pixel, sample, dim)) / spp


def stratified_2d(pixel, sample, dim: int, spp: int):
    k = int(np.log2(spp))
    a = 1 << (k // 2)
    b = spp // a
    perm = _strat_perm(sample, spp - 1, pixel, dim)
    sx = (perm % a).to(torch.float32)
    sy = (perm // a).to(torch.float32)
    j = uniform_2d(pixel, sample, dim)
    return torch.stack([(sx + j[..., 0]) / a, (sy + j[..., 1]) / b], dim=-1)


# Faure-permuted Halton (reference: src/samplers/halton.cpp + faure.cpp)
_FAURE_DIMS = 64
_FAURE_CACHE: list = []


def faure_permutation(b: int):
    """Faure's recursive digit permutation for base b: sigma_2c
    interleaves 2 sigma_c and 2 sigma_c + 1; sigma_2c+1 increments the
    elements >= c of sigma_2c and inserts c in the middle."""
    if b == 1:
        return [0]
    if b == 2:
        return [0, 1]
    if b % 2 == 0:
        prev = faure_permutation(b // 2)
        return [2 * v for v in prev] + [2 * v + 1 for v in prev]
    c = (b - 1) // 2
    prev = faure_permutation(b - 1)
    out = [v + 1 if v >= c else v for v in prev]
    out.insert(c, c)
    return out


def _first_primes(n: int):
    primes = []
    x = 2
    while len(primes) < n:
        if all(x % p for p in primes if p * p <= x):
            primes.append(x)
        x += 1
    return primes


def _faure_tables():
    """(primes [D], offsets [D], flat permutation table) as numpy."""
    if not _FAURE_CACHE:
        primes = _first_primes(_FAURE_DIMS)
        offs, flat = [], []
        for b in primes:
            offs.append(len(flat))
            flat.extend(faure_permutation(b))
        _FAURE_CACHE.append((np.asarray(primes, np.int64),
                             np.asarray(offs, np.int64),
                             np.asarray(flat, np.int64)))
    return _FAURE_CACHE[0]


def permuted_radical_inverse(dim: int, index, digits: int = 24):
    """Faure-permuted radical inverse of u32 lanes `index` in base
    prime(dim) (dim clipped to the table), float32 as the JAX package
    accumulates it."""
    primes, offs, flat = _faure_tables()
    d = min(max(int(dim), 0), _FAURE_DIMS - 1)
    b, off = int(primes[d]), int(offs[d])
    n = _u32(index)
    perm = torch.as_tensor(flat[off:off + b], device=n.device)
    bf = torch.tensor(b, dtype=torch.float32, device=n.device)
    factor = 1.0 / bf
    result = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    scale = torch.ones_like(result)
    for _ in range(digits):
        pd = perm[n % b].to(torch.float32)
        result = result + pd * factor * scale
        scale = scale / bf
        n = n // b
    return torch.clamp(result, max=1.0 - 1e-7)


def halton_2d(pixel, sample, dim: int):
    """The Faure-permuted Halton point of index `sample` in the bases
    (prime(dim), prime(dim + 1)), Cranley-Patterson rotated per
    (pixel, dim)."""
    key = hash_combine(_u32(pixel), dim)
    r1 = u32_to_unit_float(hash_u32(key ^ 0x11111111))
    r2 = u32_to_unit_float(hash_u32(key ^ 0x22222222))
    u1 = torch.remainder(permuted_radical_inverse(dim, sample) + r1, 1.0)
    u2 = torch.remainder(permuted_radical_inverse(dim + 1, sample) + r2,
                         1.0)
    return torch.stack(torch.broadcast_tensors(u1, u2), dim=-1)


def _stratified_spp(mode):
    """For a (STRATIFIED, spp) mode its spp if a power of two, else 0
    (independent samples then, as in the JAX package); None for the
    other modes."""
    if isinstance(mode, tuple) and mode[0] == STRATIFIED:
        spp = int(mode[1])
        return spp if spp > 0 and spp & (spp - 1) == 0 else 0
    return None


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
        spp = _stratified_spp(self.mode)
        if spp:
            return stratified_1d(self.pixel, self.sample, dim, spp)
        if self.mode == SOBOL:
            return sobol_2d(self.pixel, self.sample, dim)[..., 0]
        if self.mode == HALTON:
            return halton_2d(self.pixel, self.sample, dim)[..., 0]
        if self.mode == INDEPENDENT or spp == 0:
            return uniform_1d(self.pixel, self.sample, dim)
        raise NotImplementedError(f"sampler mode {self.mode!r} is "
                                  "unknown")

    def next_2d(self, dim: int):
        if self._qmc():
            return sobol_qmc_at(self.mode[1], self.pixel, self.sample,
                                self.index, dim, 2)
        spp = _stratified_spp(self.mode)
        if spp:
            return stratified_2d(self.pixel, self.sample, dim, spp)
        if self.mode == SOBOL:
            return sobol_2d(self.pixel, self.sample, dim)
        if self.mode == HALTON:
            return halton_2d(self.pixel, self.sample, dim)
        if self.mode == INDEPENDENT or spp == 0:
            return uniform_2d(self.pixel, self.sample, dim)
        raise NotImplementedError(f"sampler mode {self.mode!r} is "
                                  "unknown")
