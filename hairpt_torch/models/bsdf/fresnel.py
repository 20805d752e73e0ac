"""Dielectric and conductor Fresnel terms (port of
hairpt/models/bsdf/fresnel.py; reference src/libcore/util.cpp
fresnelDielectricExt, fresnelConductorExact)."""
from __future__ import annotations

import numpy as np
import torch

from ...core.math import safe_sqrt


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized reflectance at a dielectric boundary (eta = n_t / n_i).
    Returns (R, cos_theta_t), cos_theta_t signed opposite to cos_theta_i."""
    outside = cos_theta_i >= 0.0
    eta_rel = torch.where(outside, eta, 1.0 / eta)
    cos_i = torch.abs(cos_theta_i)
    sin2_t = (1.0 - cos_i * cos_i) / torch.clamp(eta_rel * eta_rel,
                                                 min=1e-12)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    rs = (cos_i - eta_rel * cos_t) / torch.clamp(cos_i + eta_rel * cos_t,
                                                 min=1e-12)
    rp = (eta_rel * cos_i - cos_t) / torch.clamp(eta_rel * cos_i + cos_t,
                                                 min=1e-12)
    R = torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    cos_theta_t = torch.where(tir, 0.0, torch.where(outside, -cos_t, cos_t))
    return R, cos_theta_t


def fresnel_conductor(cos_theta_i, eta, k):
    """Exact unpolarized conductor reflectance; eta and k are [..., 3]
    rgb."""
    c2 = cos_theta_i * cos_theta_i
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2[..., None]
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + c2[..., None]
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * cos_theta_i[..., None]
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-12)
    t3 = c2[..., None] * a2b2 + s2[..., None] * s2[..., None]
    t4 = t2 * s2[..., None]
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-12)
    return 0.5 * (rp + rs)


def fresnel_diffuse_reflectance(eta: float, n: int = 4096) -> float:
    """Average Fresnel reflectance for cosine-distributed illumination
    (host-side numeric integral; reference: util.cpp
    fresnelDiffuseReflectance, exact branch)."""
    mu = (np.arange(n) + 0.5) / n
    eta_rel = eta
    cos_i = mu
    sin2_t = (1 - cos_i ** 2) / eta_rel ** 2
    tir = sin2_t >= 1.0
    cos_t = np.sqrt(np.maximum(1 - sin2_t, 0))
    rs = (cos_i - eta_rel * cos_t) / (cos_i + eta_rel * cos_t)
    rp = (eta_rel * cos_i - cos_t) / (eta_rel * cos_i + cos_t)
    R = np.where(tir, 1.0, 0.5 * (rs ** 2 + rp ** 2))
    return float(2.0 * np.sum(R * mu) / n)
