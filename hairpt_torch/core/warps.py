"""Square -> sphere/hemisphere/disk warps and their densities (port of
hairpt/core/warps.py, the warps the ported BSDFs and emitters use)."""
from __future__ import annotations

import math

import torch

from .math import safe_sqrt

PI = math.pi
INV_PI = 1.0 / math.pi
INV_TWOPI = 1.0 / (2.0 * math.pi)


def square_to_uniform_sphere(s):
    z = 1.0 - 2.0 * s[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * PI * s[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_cone(s, cos_cutoff):
    cos_theta = (1.0 - s[..., 0]) + s[..., 0] * cos_cutoff
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * PI * s[..., 1]
    return torch.stack([torch.cos(phi) * sin_theta,
                        torch.sin(phi) * sin_theta, cos_theta], dim=-1)


def square_to_uniform_triangle(s):
    a = safe_sqrt(1.0 - s[..., 0])
    return torch.stack([1.0 - a, a * s[..., 1]], dim=-1)


def square_to_uniform_disk_concentric(s):
    ox = 2.0 * s[..., 0] - 1.0
    oy = 2.0 * s[..., 1] - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    cond = torch.abs(ox) > torch.abs(oy)
    r = torch.where(cond, ox, oy)
    safe_r = torch.where(r == 0.0, torch.ones_like(r), r)
    one = torch.ones_like(r)
    phi = torch.where(cond,
                      (PI / 4.0) * (oy / torch.where(cond, safe_r, one)),
                      (PI / 2.0) - (PI / 4.0)
                      * (ox / torch.where(cond, one, safe_r)))
    r = torch.where(zero, torch.zeros_like(r), r)
    phi = torch.where(zero, torch.zeros_like(phi), phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_cosine_hemisphere(s):
    p = square_to_uniform_disk_concentric(s)
    z = safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    return torch.stack([p[..., 0], p[..., 1], z], dim=-1)


def square_to_cosine_hemisphere_pdf(w):
    return torch.clamp(w[..., 2], min=0.0) * INV_PI


def square_to_phong_lobe(s, exponent):
    """Sample a Phong lobe around +z (reference: kajiyakay.cpp:244-249)."""
    cos_alpha = s[..., 1] ** (1.0 / (exponent + 1.0))
    sin_alpha = safe_sqrt(1.0 - s[..., 1] ** (2.0 / (exponent + 1.0)))
    phi = 2.0 * PI * s[..., 0]
    return torch.stack([sin_alpha * torch.cos(phi),
                        sin_alpha * torch.sin(phi), cos_alpha], dim=-1)


def phong_lobe_pdf(cos_alpha, exponent):
    return torch.where(cos_alpha > 0,
                       (cos_alpha ** exponent) * (exponent + 1.0) * INV_TWOPI,
                       0.0)
