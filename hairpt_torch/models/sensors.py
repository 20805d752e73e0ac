"""Perspective camera (port of hairpt/models/sensors.py: Camera.perspective
and the pinhole branch of sample_ray)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.math import Ray, normalize

PERSPECTIVE = 0


class Camera(NamedTuple):
    kind: int
    to_world: np.ndarray       # [4, 4] camera -> world (rigid), host
    tan_half_fov: float        # tan(xfov / 2)
    aspect: float              # width / height
    width: int
    height: int
    near: float = 1e-2
    far: float = 1e4

    @staticmethod
    def perspective(to_world, fov_deg: float, width: int, height: int,
                    fov_axis: str = "x", near: float = 1e-2,
                    far: float = 1e4) -> "Camera":
        aspect = width / height
        fov = np.radians(fov_deg)
        if fov_axis == "y" or (fov_axis == "smaller" and aspect >= 1):
            fov = 2.0 * np.arctan(np.tan(fov / 2.0) * aspect)
        elif fov_axis == "diagonal":
            diag = np.hypot(aspect, 1.0)
            fov = 2.0 * np.arctan(np.tan(fov / 2.0) * aspect / diag)
        return Camera(kind=PERSPECTIVE,
                      to_world=np.asarray(to_world, np.float32),
                      tan_half_fov=float(np.float32(np.tan(fov / 2.0))),
                      aspect=aspect, width=width, height=height, near=near,
                      far=far)


def sample_ray(cam: Camera, pos, aperture_sample=None) -> Ray:
    """Pinhole camera rays for continuous film positions pos [N, 2]
    (pixel centres at i + 0.5). With u, v = pos / resolution the camera
    direction is ((1-2u) tan, (1-2v) tan / aspect, 1)."""
    if cam.kind != PERSPECTIVE:
        raise NotImplementedError("only the perspective camera is ported")
    dev = pos.device
    u = pos[..., 0] / cam.width
    v = pos[..., 1] / cam.height
    t = torch.tensor(cam.tan_half_fov, dtype=torch.float32, device=dev)
    near_p = torch.stack([(1.0 - 2.0 * u) * t,
                          (1.0 - 2.0 * v) * t / cam.aspect,
                          torch.ones_like(u)], dim=-1)
    m = torch.as_tensor(cam.to_world, device=dev)
    R = m[:3, :3]
    o_world = m[:3, 3]
    d_cam = normalize(near_p)
    o = torch.broadcast_to(o_world, d_cam.shape)
    d = d_cam @ R.T
    inv_z = 1.0 / d_cam[..., 2]
    return Ray(o=o.contiguous(), d=d, mint=cam.near * inv_z,
               maxt=cam.far * inv_z)
