"""Hosek-Wilkie analytic sky-dome radiance (RGB ground-truth variant).

Implements the model of Hosek & Wilkie, "An Analytic Model for Full
Spectral Sky-Dome Radiance" (SIGGRAPH 2012) — the sky model used by the
reference's `sky`/`sunsky` plugins (src/emitters/sky.cpp:246 via
src/emitters/sunsky/skymodel.cpp). Host-side numpy only: the baked
lat-long envmap is what ships to the device.

Coefficient data (hairpt/data/hosek_rgb.npz) is the authors' published
supplemental dataset (see tools/extract_hosek_data.py); the evaluation
code below is written from the paper's formulas:

  F(θ, γ) = (1 + A e^{B/(cosθ+0.01)}) ·
            (C + D e^{Eγ} + F cos²γ + G χ(H', γ) + I √max(cosθ,0))
  χ(h, γ) = (1 + cos²γ) / (1 + h² - 2 h cosγ)^{3/2}

with per-channel coefficient vectors (A..I = c[0..8], where the mie
anisotropy h is c[8] and the zenith coefficient is c[7]) interpolated
from the dataset: quintic Bernstein in stretched solar elevation
η = (elev / (π/2))^{1/3}, linear in turbidity ∈ [1, 10] and ground
albedo ∈ [0, 1]. Radiance = F · radConfig (same interpolation).
"""
from __future__ import annotations

import os

import numpy as np

_DATA = None


def _data():
    global _DATA
    if _DATA is None:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "data", "hosek_rgb.npz")
        _DATA = np.load(path)
    return _DATA


def _quintic_bernstein(ctrl, eta):
    """ctrl [..., 6, ...ax0]: Bernstein-5 combination along axis -2."""
    e = eta
    w = np.array([(1 - e) ** 5,
                  5 * (1 - e) ** 4 * e,
                  10 * (1 - e) ** 3 * e ** 2,
                  10 * (1 - e) ** 2 * e ** 3,
                  5 * (1 - e) * e ** 4,
                  e ** 5])
    return np.tensordot(w, ctrl, axes=([0], [0]))


def cook_configuration(turbidity: float, albedo, solar_elevation: float):
    """Returns (config [3, 9], rad_config [3]) for the RGB channels.

    turbidity ∈ [1, 10]; albedo scalar or [3]; solar_elevation in
    radians above the horizon (clamped ≥ 0)."""
    d = _data()
    turbidity = float(np.clip(turbidity, 1.0, 10.0))
    alb = np.broadcast_to(np.asarray(albedo, np.float64), (3,))
    alb = np.clip(alb, 0.0, 1.0)
    eta = (max(solar_elevation, 0.0) / (np.pi / 2.0)) ** (1.0 / 3.0)
    eta = min(eta, 1.0)

    it = int(np.clip(int(turbidity), 1, 9))
    ft = turbidity - it

    config = np.zeros((3, 9))
    rad = np.zeros((3,))
    for ch in range(3):
        coeff = d[f"coeff{ch}"].astype(np.float64)  # [2, 10, 6, 9]
        radd = d[f"rad{ch}"].astype(np.float64)     # [2, 10, 6]
        for (t_idx, t_w) in ((it - 1, 1.0 - ft), (min(it, 9), ft)):
            if t_w == 0.0:
                continue
            for (a_idx, a_w) in ((0, 1.0 - alb[ch]), (1, alb[ch])):
                if a_w == 0.0:
                    continue
                config[ch] += t_w * a_w * _quintic_bernstein(
                    coeff[a_idx, t_idx], eta)
                rad[ch] += t_w * a_w * _quintic_bernstein(
                    radd[a_idx, t_idx], eta)
    return config, rad


def sky_radiance(config, rad, cos_theta, cos_gamma):
    """Vectorized RGB radiance for view directions.

    cos_theta: cos of the view zenith angle (≥ 0 above horizon);
    cos_gamma: cos of the angle between view and sun directions.
    Returns [..., 3]."""
    cos_theta = np.maximum(np.asarray(cos_theta, np.float64), 0.0)
    cos_gamma = np.clip(np.asarray(cos_gamma, np.float64), -1.0, 1.0)
    gamma = np.arccos(cos_gamma)
    out = np.zeros(cos_theta.shape + (3,))
    for ch in range(3):
        A, B, C, D, E, F, G, I, H = (config[ch][i] for i in
                                     (0, 1, 2, 3, 4, 5, 6, 7, 8))
        chi = (1.0 + cos_gamma * cos_gamma) / np.power(
            1.0 + H * H - 2.0 * H * cos_gamma, 1.5)
        val = (1.0 + A * np.exp(B / (cos_theta + 0.01))) * (
            C + D * np.exp(E * gamma) + F * cos_gamma * cos_gamma
            + G * chi + I * np.sqrt(cos_theta))
        out[..., ch] = np.maximum(val * rad[ch], 0.0)
    return out.astype(np.float32)
