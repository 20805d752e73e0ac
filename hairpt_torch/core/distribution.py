"""Discrete CDF sampling on tensors (port of hairpt/core/distribution.py).

The reference's DiscreteDistribution (include/mitsuba/core/pmf.h), the
2D envmap distribution (src/emitters/envmap.cpp) and the fork's
InterpolatedDistribution1D (src/bsdfs/InterpolatedDistribution1D.hpp):
CDFs are dense tensors over a trailing bin axis and inversion counts the
CDF entries below u, as the JAX package's does.
"""
from __future__ import annotations

import torch


def build_cdf(weights):
    """weights [..., N] -> (cdf [..., N], total [...]) with cdf[..., -1]
    == 1 (a uniform cdf where total == 0)."""
    c = torch.cumsum(weights, dim=-1)
    total = c[..., -1]
    n = weights.shape[-1]
    uniform = torch.arange(1, n + 1, dtype=weights.dtype,
                           device=weights.device) / n
    cdf = torch.where(total[..., None] > 0,
                      c / torch.clamp(total[..., None], min=1e-30), uniform)
    return cdf, total


def _at(cdf, idx):
    return torch.gather(cdf, -1, idx[..., None])[..., 0]


def sample_discrete(cdf, u):
    """Invert a normalized CDF [..., N] at u [...]: (index, prob,
    u_rescaled), the last the sample reused within the chosen bin
    (core/pmf.h:178 sampleReuse)."""
    n = cdf.shape[-1]
    idx = torch.clamp((cdf < u[..., None]).sum(-1), 0, n - 1)
    hi = _at(cdf, idx)
    lo = torch.where(idx > 0, _at(cdf, torch.clamp(idx - 1, min=0)), 0.0)
    prob = hi - lo
    u_rescaled = torch.clamp((u - lo) / torch.clamp(prob, min=1e-30), 0.0,
                             1.0 - 1e-7)
    return idx, prob, u_rescaled


def sample_continuous(cdf, u):
    """x in [0, 1) with density proportional to the piecewise-constant
    weights: (x, pdf with respect to x)."""
    n = cdf.shape[-1]
    idx, prob, ur = sample_discrete(cdf, u)
    return (idx.to(cdf.dtype) + ur) / n, prob * n


def pdf_continuous(cdf, x):
    """The density at x in [0, 1) of the piecewise-constant distribution."""
    n = cdf.shape[-1]
    idx = torch.clamp((x * n).to(torch.int64), 0, n - 1)
    hi = _at(cdf, idx)
    lo = torch.where(idx > 0, _at(cdf, torch.clamp(idx - 1, min=0)), 0.0)
    return (hi - lo) * n


class InterpolatedCdf1D:
    """R row distributions over N bins, indexed by a continuous row
    coordinate v in [0, R - 1]: the two neighbouring rows' weights are
    blended linearly before sampling (InterpolatedDistribution1D.hpp:69-
    112)."""

    def __init__(self, weights, device=None):
        from .. import resolve_device
        if torch.is_tensor(weights) and device is None:
            self.weights = weights.to(torch.float32)
        else:
            self.weights = torch.as_tensor(weights, dtype=torch.float32,
                                           device=resolve_device(device))
        self.rows, self.bins = self.weights.shape
        self.row_sums = self.weights.sum(-1)

    def _row(self, v):
        v = torch.clamp(v, 0.0, self.rows - 1 - 1e-6)
        r0 = torch.clamp(v.to(torch.int64), 0, self.rows - 2)
        return r0, v - r0.to(v.dtype)

    def _blend(self, v):
        r0, fv = self._row(v)
        return self.weights[r0] * (1.0 - fv[..., None]) \
            + self.weights[r0 + 1] * fv[..., None]

    def sum(self, v):
        r0, fv = self._row(v)
        return self.row_sums[r0] * (1.0 - fv) + self.row_sums[r0 + 1] * fv

    def sample(self, v, u):
        """(bin index, u_rescaled, probability of the bin)."""
        cdf, _ = build_cdf(self._blend(v))
        idx, prob, ur = sample_discrete(cdf, u)
        return idx, ur, prob

    def pdf_bin(self, v, idx):
        """The normalized probability of bin idx under row v."""
        w = self._blend(v)
        sel = _at(w, torch.clamp(idx, 0, self.bins - 1))
        return sel / torch.clamp(w.sum(-1), min=1e-30)
