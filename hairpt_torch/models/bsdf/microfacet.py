"""GGX and Beckmann microfacet distributions with Smith shadowing and
visible-normal sampling (port of hairpt/models/bsdf/microfacet.py)."""
from __future__ import annotations

import math

import torch

from ...core.math import safe_sqrt, normalize

GGX = 0
BECKMANN = 1


def ndf(kind: int, alpha, m):
    """D(m) for m in the local frame (z up)."""
    ct = torch.clamp(m[..., 2], min=0.0)
    ct2 = ct * ct
    a2 = alpha * alpha
    if kind == GGX:
        denom = math.pi * (ct2 * (a2 - 1.0) + 1.0) ** 2
        d = a2 / torch.clamp(denom, min=1e-20)
    else:
        t2 = torch.where(ct2 > 0, (1.0 - ct2) / torch.clamp(ct2, min=1e-12),
                         0.0)
        d = torch.exp(-t2 / a2) / torch.clamp(math.pi * a2 * ct2 * ct2,
                                              min=1e-20)
    return torch.where(ct > 0, d, 0.0)


def smith_g1(kind: int, alpha, v, m):
    cos_v = v[..., 2]
    chi = (torch.sum(v * m, dim=-1) * cos_v) > 0
    ct2 = cos_v * cos_v
    tan2 = torch.where(ct2 > 0, (1.0 - ct2) / torch.clamp(ct2, min=1e-12),
                       float("inf"))
    a2 = alpha * alpha
    if kind == GGX:
        g = 2.0 / (1.0 + torch.sqrt(1.0 + a2 * tan2))
    else:
        a = 1.0 / torch.clamp(alpha * torch.sqrt(tan2), min=1e-12)
        g = torch.where(a < 1.6,
                        (3.535 * a + 2.181 * a * a)
                        / (1.0 + 2.276 * a + 2.577 * a * a), 1.0)
    return torch.where(chi, g, 0.0)


def g(kind: int, alpha, wi, wo, m):
    return smith_g1(kind, alpha, wi, m) * smith_g1(kind, alpha, wo, m)


def sample_all(kind: int, alpha, u):
    """Sample m proportional to D(m) cos(theta). Returns (m, pdf)."""
    a2 = alpha * alpha
    if kind == GGX:
        ct2 = (1.0 - u[..., 0]) / (u[..., 0] * (a2 - 1.0) + 1.0)
        ct = safe_sqrt(ct2)
    else:
        t2 = -a2 * torch.log(torch.clamp(1.0 - u[..., 0], min=1e-20))
        ct = 1.0 / torch.sqrt(1.0 + t2)
        ct2 = ct * ct
    st = safe_sqrt(1.0 - ct2)
    phi = 2.0 * math.pi * u[..., 1]
    m = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
    return m, ndf(kind, alpha, m) * ct


def sample_visible(kind: int, alpha, wi, u):
    """Visible-normal sampling (Heitz 2018) for GGX; Beckmann falls back to
    D cos(theta) sampling."""
    if kind != GGX:
        return sample_all(kind, alpha, u)
    vh = normalize(torch.stack([alpha * wi[..., 0], alpha * wi[..., 1],
                                torch.abs(wi[..., 2])], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    ex = torch.zeros_like(vh)
    ex[..., 0] = 1.0
    t1 = torch.where(lensq[..., None] > 1e-18,
                     torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                                  torch.zeros_like(inv)], dim=-1), ex)
    t2 = torch.linalg.cross(vh, t1)
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    m = normalize(torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                               torch.clamp(nh[..., 2], min=1e-6)], dim=-1))
    pdf = pdf_visible(kind, alpha, torch.stack(
        [wi[..., 0], wi[..., 1], torch.abs(wi[..., 2])], dim=-1), m)
    return m, pdf


def pdf_visible(kind: int, alpha, wi, m):
    """pdf of sample_visible in the half-vector measure."""
    if kind != GGX:
        return ndf(kind, alpha, m) * torch.clamp(m[..., 2], min=0.0)
    cos_i = torch.abs(wi[..., 2])
    return smith_g1(kind, alpha, wi, m) \
        * torch.abs(torch.sum(wi * m, dim=-1)) \
        * ndf(kind, alpha, m) / torch.clamp(cos_i, min=1e-8)


def half_vector_to_wo_pdf(pdf_m, wo, m):
    return pdf_m / torch.clamp(4.0 * torch.abs(torch.sum(wo * m, dim=-1)),
                               min=1e-8)
