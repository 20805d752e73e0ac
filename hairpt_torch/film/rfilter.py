"""Reconstruction filters (port of hairpt/film/rfilter.py): box, tent,
gaussian, mitchell, catmullrom and lanczos, evaluated analytically inside
the splat (reference: src/rfilters/*.cpp)."""
from __future__ import annotations

import math

import torch

BOX = 0
TENT = 1
GAUSSIAN = 2
MITCHELL = 3
CATMULLROM = 4
LANCZOS = 5

FILTERS = {
    "box": (BOX, 0.5),
    "tent": (TENT, 1.0),
    "gaussian": (GAUSSIAN, 2.0),
    "mitchell": (MITCHELL, 2.0),
    "catmullrom": (CATMULLROM, 2.0),
    "lanczos": (LANCZOS, 3.0),
}


def _mitchell_1d(x, B, C):
    x = torch.abs(x)
    x2, x3 = x * x, x * x * x
    return torch.where(
        x < 1,
        ((12 - 9 * B - 6 * C) * x3 + (-18 + 12 * B + 6 * C) * x2
         + (6 - 2 * B)) * (1.0 / 6.0),
        torch.where(
            x < 2,
            ((-B - 6 * C) * x3 + (6 * B + 30 * C) * x2
             + (-12 * B - 48 * C) * x + (8 * B + 24 * C)) * (1.0 / 6.0),
            0.0))


def _sinc(x):
    x = torch.abs(x) + 1e-8
    return torch.sin(math.pi * x) / (math.pi * x)


def filter_eval(kind: int, radius: float, dx, dy):
    """The separable 2D filter at offsets (dx, dy) from the sample."""
    if kind == BOX:
        return torch.where((torch.abs(dx) <= radius)
                           & (torch.abs(dy) <= radius), 1.0, 0.0)
    if kind == TENT:
        return torch.clamp(1.0 - torch.abs(dx) / radius, min=0.0) * \
            torch.clamp(1.0 - torch.abs(dy) / radius, min=0.0)
    if kind == GAUSSIAN:
        # stddev 0.5, truncated at the radius (reference gaussian.cpp)
        alpha = -1.0 / (2.0 * 0.5 ** 2)
        off = math.exp(alpha * radius * radius)
        gx = torch.clamp(torch.exp(alpha * dx * dx) - off, min=0.0)
        gy = torch.clamp(torch.exp(alpha * dy * dy) - off, min=0.0)
        return gx * gy
    if kind == MITCHELL:
        return _mitchell_1d(dx, 1 / 3, 1 / 3) * _mitchell_1d(dy, 1 / 3, 1 / 3)
    if kind == CATMULLROM:
        return _mitchell_1d(dx, 0.0, 0.5) * _mitchell_1d(dy, 0.0, 0.5)
    if kind == LANCZOS:
        tau = 3.0
        return torch.where(torch.abs(dx) < tau,
                           _sinc(dx) * _sinc(dx / tau), 0.0) * \
            torch.where(torch.abs(dy) < tau, _sinc(dy) * _sinc(dy / tau), 0.0)
    raise ValueError(f"unknown filter kind {kind}")
