"""Brent root finding, Catmull-Rom cubic splines and real spherical
harmonics on tensors (port of hairpt/core/numerics.py; the reference's
include/mitsuba/core/{brent.h, spline.h, shvector.h}).

As in the JAX package: a fixed number of Brent iterations instead of a
data-dependent loop, bisection on the spline's monotone CDF, and SH
projection by a Gauss-Legendre (theta) x trapezoid (phi) product rule.
"""
from __future__ import annotations

from math import factorial

import numpy as np
import torch

from .. import resolve_device


def _nz(x):
    """x with its zeros replaced by 1 (a safe denominator)."""
    return torch.where(x == 0, torch.ones_like(x), x)


def brent_solve(f, a, b, iters: int = 64, xtol: float = 1e-7):
    """Brent's method on every lane's bracket [a, b] (f(a) f(b) <= 0, as
    BrentSolver::solve needs), `iters` iterations: the root estimate.
    f maps tensors to tensors; a and b broadcast."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    a, b = torch.broadcast_tensors(a, b)
    fa, fb = f(a), f(b)
    swap = fa.abs() < fb.abs()
    a, b = torch.where(swap, b, a), torch.where(swap, a, b)
    fa, fb = torch.where(swap, fb, fa), torch.where(swap, fa, fb)
    c, fc = a, fa
    mflag = torch.ones_like(a, dtype=torch.bool)
    for _ in range(iters):
        use_iq = (fa != fc) & (fb != fc)
        s_iq = a * fb * fc / _nz((fa - fb) * (fa - fc)) \
            + b * fa * fc / _nz((fb - fa) * (fb - fc)) \
            + c * fa * fb / _nz((fc - fa) * (fc - fb))
        s_sec = b - fb * (b - a) / torch.where(fb == fa, torch.ones_like(fb),
                                               fb - fa)
        s = torch.where(use_iq, s_iq, s_sec)
        lo = (3 * a + b) / 4
        bisect = ((s < torch.minimum(lo, b)) | (s > torch.maximum(lo, b))
                  | (mflag & ((s - b).abs() >= (b - c).abs() / 2))
                  | (~mflag & ((s - b).abs() >= (c - b).abs() / 2)))
        s = torch.where(bisect, 0.5 * (a + b), s)
        mflag = bisect
        fs = f(s)
        c, fc = b, fb
        left = fa * fs < 0
        a2, fa2 = torch.where(left, a, s), torch.where(left, fa, fs)
        b2, fb2 = torch.where(left, s, b), torch.where(left, fs, fb)
        swap = fa2.abs() < fb2.abs()
        a, b = torch.where(swap, b2, a2), torch.where(swap, a2, b2)
        fa, fb = torch.where(swap, fb2, fa2), torch.where(swap, fa2, fb2)
    return b


# ---------------------------------------------------------------------------
# Catmull-Rom cubic splines on a uniform grid (spline.h)
# ---------------------------------------------------------------------------

def _tangents(vals, i, n):
    """f0, f1 and the one-sided-at-the-ends tangents d0, d1 of interval
    i (spline.cpp)."""
    f0, f1 = vals[i], vals[i + 1]
    d0 = torch.where(i > 0, 0.5 * (f1 - vals[torch.clamp(i - 1, min=0)]),
                     f1 - f0)
    d1 = torch.where(i + 2 < n, 0.5 * (vals[torch.clamp(i + 2, max=n - 1)]
                                       - f0), f1 - f0)
    return f0, f1, d0, d1


def eval_cubic_1d(x, values, xmin: float, xmax: float):
    """The Catmull-Rom interpolant of `values` (sampled uniformly on [xmin,
    xmax]) at x, 0 outside the domain (evalCubicInterp1D, extrapolate
    false)."""
    values = torch.as_tensor(values, dtype=torch.float32, device=x.device)
    n = values.shape[0]
    t = (x - xmin) / (xmax - xmin) * (n - 1)
    inside = (t >= 0) & (t <= n - 1)
    i = torch.clamp(torch.floor(t).to(torch.int64), 0, n - 2)
    u = t - i
    f0, f1, d0, d1 = _tangents(values, i, n)
    u2 = u * u
    u3 = u2 * u
    val = (2 * u3 - 3 * u2 + 1) * f0 + (-2 * u3 + 3 * u2) * f1 \
        + (u3 - 2 * u2 + u) * d0 + (u3 - u2) * d1
    return torch.where(inside, val, 0.0)


def integrate_cubic_1d(values, xmin: float, xmax: float):
    """The interpolant's integral over each of the n - 1 intervals
    (integrateCubicInterp1D), float64 on the host."""
    values = np.asarray(values, np.float64)
    n = len(values)
    w = (xmax - xmin) / (n - 1)
    f0, f1 = values[:-1], values[1:]
    d0 = np.empty(n - 1)
    d1 = np.empty(n - 1)
    d0[0] = f1[0] - f0[0]
    d0[1:] = 0.5 * (values[2:] - values[:-2])
    d1[:-1] = d0[1:]
    d1[-1] = f1[-1] - f0[-1]
    # the Hermite basis integrates to 1/2, 1/12, 1/2, -1/12
    return w * (0.5 * (f0 + f1) + (d0 - d1) / 12.0)


def sample_cubic_1d(u, values, xmin: float, xmax: float, iters: int = 40):
    """x distributed as the (non-negative) interpolant of `values`
    (sampleCubicInterp1D; bisection on the interval's CDF): (x, pdf)."""
    dev = u.device if torch.is_tensor(u) else resolve_device(None)
    areas = integrate_cubic_1d(values, xmin, xmax)
    cdf = np.concatenate([[0.0], np.cumsum(areas)])
    total = cdf[-1]
    cdf_n = torch.as_tensor(cdf / total, dtype=torch.float32, device=dev)
    vals = torch.as_tensor(np.asarray(values), dtype=torch.float32,
                           device=dev)
    n = len(values)
    u = torch.as_tensor(u, dtype=torch.float32, device=dev)
    idx = torch.clamp(torch.searchsorted(cdf_n, u, right=True) - 1, 0, n - 2)
    w = (xmax - xmin) / (n - 1)
    u_loc = (u - cdf_n[idx]) / torch.clamp(cdf_n[idx + 1] - cdf_n[idx],
                                           min=1e-12)
    x_lo = xmin + idx.to(torch.float32) * w
    f0, f1, d0, d1 = _tangents(vals, idx, n)
    den = torch.clamp(0.5 * (f0 + f1) + (d0 - d1) / 12.0, min=1e-12)

    def cdf_local(t):
        # the integral of the Hermite interpolant over [0, t] / over [0, 1]
        t2 = t * t
        t3 = t2 * t
        t4 = t3 * t
        num = (0.5 * t4 - t3 + t) * f0 \
            + (0.25 * t4 - (2.0 / 3.0) * t3 + 0.5 * t2) * d0 \
            + (-0.5 * t4 + t3) * f1 + (0.25 * t4 - t3 / 3.0) * d1
        return num / den

    lo, hi = torch.zeros_like(u), torch.ones_like(u)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = cdf_local(mid) < u_loc
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    x = x_lo + 0.5 * (lo + hi) * w
    return x, eval_cubic_1d(x, vals, xmin, xmax) / total


# ---------------------------------------------------------------------------
# real spherical harmonics (shvector.h SHVector)
# ---------------------------------------------------------------------------

def assoc_legendre(l_max: int, x):
    """Every P_l^m(x), 0 <= m <= l <= l_max, by the stable recurrences: a
    dict (l, m) -> tensor."""
    P = {(0, 0): torch.ones_like(x)}
    if l_max == 0:
        return P
    somx2 = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))
    for m in range(l_max + 1):
        if m > 0:
            P[(m, m)] = -(2 * m - 1) * somx2 * P[(m - 1, m - 1)]
        if m < l_max:
            P[(m + 1, m)] = x * (2 * m + 1) * P[(m, m)]
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * x * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)
    return P


def sh_eval_basis(l_max: int, theta, phi):
    """The real SH basis Y_l^m(theta, phi) for every l <= l_max, in the
    reference's order (l, then m from -l to l): [..., (l_max + 1)^2]."""
    P = assoc_legendre(l_max, torch.cos(theta))
    out = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = float(np.sqrt((2 * l + 1) / (4 * np.pi)
                                 * factorial(l - am) / factorial(l + am)))
            if m > 0:
                y = float(np.sqrt(2.0)) * norm * P[(l, am)] * torch.cos(
                    m * phi)
            elif m < 0:
                y = float(np.sqrt(2.0)) * norm * P[(l, am)] * torch.sin(
                    am * phi)
            else:
                y = norm * P[(l, 0)]
            out.append(y)
    return torch.stack(out, dim=-1)


def sh_project(f, l_max: int, res: int = 32, device=None):
    """f(theta, phi) projected onto the SH basis up to l_max by
    Gauss-Legendre (theta) x trapezoid (phi) quadrature (SHVector::project,
    res = 32): [(l_max + 1)^2] coefficients on `device` (the card unless
    "cpu")."""
    dev = resolve_device(device)
    xg, wg = np.polynomial.legendre.leggauss(res)
    theta = torch.as_tensor(np.arccos(xg), dtype=torch.float32, device=dev)
    phi = torch.as_tensor((np.arange(2 * res) + 0.5) / (2 * res) * 2 * np.pi,
                          dtype=torch.float32, device=dev)
    th, ph = torch.meshgrid(theta, phi, indexing="ij")
    vals = f(th, ph)
    basis = sh_eval_basis(l_max, th, ph)
    w = torch.as_tensor(wg, dtype=torch.float32, device=dev)[:, None] \
        * (2 * np.pi / (2 * res))
    return (vals[..., None] * basis * w[..., None]).sum(dim=(0, 1))


def sh_eval(coeffs, l_max: int, theta, phi):
    """The SH expansion `coeffs` at (theta, phi)."""
    basis = sh_eval_basis(l_max, theta, phi)
    return (torch.as_tensor(coeffs, dtype=torch.float32,
                            device=basis.device) * basis).sum(-1)
