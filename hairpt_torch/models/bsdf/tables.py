"""Host-side precomputed radiometric tables (numpy copy of
hairpt/models/bsdf/tables.py).

Replaces the reference's shipped rough-transmittance data files
(src/bsdfs/rtrans.h + data/microfacet/{beckmann,ggx}.dat, used by
plastic/roughplastic/marschner_diffuse): instead of loading binary blobs, the
directional albedo of the rough dielectric reflection lobe is integrated
numerically (float64 numpy) at scene-build time and cached per (kind, eta).
"""
from __future__ import annotations

import numpy as np

_CACHE: dict = {}

N_ALPHA = 32
N_COS = 64
ALPHA_MIN, ALPHA_MAX = 1e-3, 4.0


def _ggx_sample_albedo(eta: float, alpha: np.ndarray, cos_i: np.ndarray,
                       kind: int, n_samp: int = 64) -> np.ndarray:
    """Reflection albedo R(cosθi, alpha) of a rough dielectric interface via
    stratified importance sampling of D·cosθ (f64). alpha [A], cos_i [C] →
    [C, A]."""
    A, C = len(alpha), len(cos_i)
    u1 = (np.arange(n_samp) + 0.5) / n_samp
    u2 = (np.arange(n_samp) + 0.5) / n_samp
    U1, U2 = np.meshgrid(u1, u2, indexing="ij")
    U1 = U1.ravel()[None, None, :]  # [1, 1, S]
    U2 = U2.ravel()[None, None, :]
    a = alpha[None, :, None]
    ci = cos_i[:, None, None]
    si = np.sqrt(np.maximum(1 - ci ** 2, 0))

    if kind == 0:  # GGX
        a2 = a ** 2
        ct2 = (1.0 - U1) / (U1 * (a2 - 1.0) + 1.0)
    else:  # Beckmann
        a2 = a ** 2
        t2 = -a2 * np.log(np.maximum(1.0 - U1, 1e-20))
        ct2 = 1.0 / (1.0 + t2)
    ct = np.sqrt(np.maximum(ct2, 0))
    st = np.sqrt(np.maximum(1 - ct2, 0))
    phi = 2 * np.pi * U2
    mx, my, mz = st * np.cos(phi), st * np.sin(phi), ct

    # wi = (si, 0, ci)
    wi_dot_m = si * mx + ci * mz
    # wo = reflect(wi, m)
    wox = 2 * wi_dot_m * mx - si
    woz = 2 * wi_dot_m * mz - ci

    # Fresnel at the half vector
    cos_h = np.abs(wi_dot_m)
    sin2_t = np.maximum(1 - cos_h ** 2, 0) / eta ** 2
    tir = sin2_t >= 1.0
    cos_t = np.sqrt(np.maximum(1 - sin2_t, 0))
    rs = (cos_h - eta * cos_t) / np.maximum(cos_h + eta * cos_t, 1e-12)
    rp = (eta * cos_h - cos_t) / np.maximum(eta * cos_h + cos_t, 1e-12)
    F = np.where(tir, 1.0, 0.5 * (rs ** 2 + rp ** 2))

    def g1(cv, tanv2):
        if kind == 0:
            return 2.0 / (1.0 + np.sqrt(1.0 + a ** 2 * tanv2))
        b = 1.0 / np.maximum(a * np.sqrt(tanv2), 1e-12)
        return np.where(b < 1.6,
                        (3.535 * b + 2.181 * b ** 2)
                        / (1.0 + 2.276 * b + 2.577 * b ** 2), 1.0)

    tan_i2 = np.maximum(1 - ci ** 2, 0) / np.maximum(ci ** 2, 1e-12)
    tan_o2 = np.maximum(1 - woz ** 2, 0) / np.maximum(woz ** 2, 1e-12)
    G = g1(ci, tan_i2) * g1(woz, tan_o2)

    # weight for D·cosθ sampling of the reflection integrand:
    # F G |wi·m| / (cosθi cosθm)
    w = F * G * np.abs(wi_dot_m) / np.maximum(ci * np.maximum(mz, 1e-9), 1e-9)
    w = np.where((woz > 0) & (wi_dot_m > 0), w, 0.0)
    return np.clip(w.mean(axis=-1), 0.0, 1.0)  # [C, A]


class RoughTransmittance:
    """t(cosθ, alpha) = 1 − reflection albedo; bilinear-interpolated
    (reference: rtrans.h RoughTransmittance::eval / evalDiffuse)."""

    def __init__(self, kind: int, eta: float):
        self.cos_grid = (np.arange(N_COS) + 0.5) / N_COS
        self.alpha_grid = np.geomspace(ALPHA_MIN, ALPHA_MAX, N_ALPHA)
        R = _ggx_sample_albedo(eta, self.alpha_grid, self.cos_grid, kind)
        self.table = 1.0 - R                       # [C, A]
        # cosine-weighted average over the hemisphere per alpha
        mu = self.cos_grid
        self.diffuse = 2.0 * np.sum(self.table * mu[:, None], axis=0) / N_COS

    def eval_np(self, cos_theta, alpha):
        ci = np.clip(cos_theta, 0.0, 1.0)
        ai = np.clip(np.log(np.maximum(alpha, ALPHA_MIN)
                            / ALPHA_MIN) / np.log(ALPHA_MAX / ALPHA_MIN), 0, 1)
        x = ci * N_COS - 0.5
        y = ai * (N_ALPHA - 1)
        x0 = np.clip(np.floor(x).astype(int), 0, N_COS - 2)
        y0 = np.clip(np.floor(y).astype(int), 0, N_ALPHA - 2)
        fx = np.clip(x - x0, 0, 1)
        fy = np.clip(y - y0, 0, 1)
        t = self.table
        return ((t[x0, y0] * (1 - fx) + t[x0 + 1, y0] * fx) * (1 - fy)
                + (t[x0, y0 + 1] * (1 - fx) + t[x0 + 1, y0 + 1] * fx) * fy)

    def eval_diffuse_np(self, alpha):
        ai = np.clip(np.log(np.maximum(alpha, ALPHA_MIN)
                            / ALPHA_MIN) / np.log(ALPHA_MAX / ALPHA_MIN), 0, 1)
        y = ai * (N_ALPHA - 1)
        y0 = np.clip(np.floor(y).astype(int), 0, N_ALPHA - 2)
        fy = np.clip(y - y0, 0, 1)
        return self.diffuse[y0] * (1 - fy) + self.diffuse[y0 + 1] * fy


def get(kind: int, eta: float) -> RoughTransmittance:
    key = (kind, round(float(eta), 6))
    if key not in _CACHE:
        _CACHE[key] = RoughTransmittance(kind, float(eta))
    return _CACHE[key]
