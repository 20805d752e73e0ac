"""Vector/geometry math on batched torch tensors (port of hairpt/core/math.py).

Every function works on tensors with a trailing axis of size 3.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def normalize(a, eps: float = 1e-20):
    return a * torch.rsqrt(torch.clamp(torch.sum(a * a, dim=-1, keepdim=True),
                                       min=eps))


def safe_sqrt(x):
    """sqrt(max(x, 0)) that is exactly 0 for x <= 0."""
    return torch.where(x > 0.0, torch.sqrt(torch.clamp(x, min=1e-12)),
                       torch.zeros_like(x))


def reflect_z(w):
    """Mirror reflection about the local z axis: (-x, -y, z)."""
    return w * torch.tensor([-1.0, -1.0, 1.0], dtype=w.dtype,
                            device=w.device)


class Frame(NamedTuple):
    """Orthonormal shading frame; n is the local z axis."""
    s: torch.Tensor
    t: torch.Tensor
    n: torch.Tensor

    def to_local(self, v):
        return torch.stack([dot(self.s, v), dot(self.t, v), dot(self.n, v)],
                           dim=-1)

    def to_world(self, v):
        return (self.s * v[..., 0:1] + self.t * v[..., 1:2]
                + self.n * v[..., 2:3])


def coordinate_system(n):
    """Build (s, t) perpendicular to n (branchless Duff et al.)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    s = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a,
                     sign * b,
                     -sign * n[..., 0]], dim=-1)
    t = torch.stack([b,
                     sign + n[..., 1] * n[..., 1] * a,
                     -n[..., 1]], dim=-1)
    return s, t


def frame_from_normal(n) -> Frame:
    s, t = coordinate_system(n)
    return Frame(s=s, t=t, n=n)


class Ray(NamedTuple):
    o: torch.Tensor      # [N, 3]
    d: torch.Tensor      # [N, 3]
    mint: torch.Tensor   # [N]
    maxt: torch.Tensor   # [N]


def matrix_lookat(origin, target, up) -> np.ndarray:
    """Camera-to-world matrix, Mitsuba convention: camera looks down +z,
    x points left-to-right in image, y up (reference:
    core/transform.cpp lookAt)."""
    origin = np.asarray(origin, np.float64)
    d = np.asarray(target, np.float64) - origin
    d /= np.linalg.norm(d)
    left = np.cross(np.asarray(up, np.float64), d)
    left /= np.linalg.norm(left)
    new_up = np.cross(d, left)
    m = np.eye(4)
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = origin
    return m
