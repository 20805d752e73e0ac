"""Sensors (port of hairpt/models/sensors.py: Camera and sample_ray):
perspective, thin lens, orthographic, spherical, telecentric, the
radiance, fluence and irradiance meters and the perspective camera with
radial distortion (reference src/sensors/). Ray generation is a batched
function of continuous film coordinates. camera_importance is the
pinhole importance the light tracers splat through, for every sensor
kind, as in the JAX package."""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import warps
from ..core.math import Ray, normalize

PERSPECTIVE = 0
THINLENS = 1
ORTHOGRAPHIC = 2
SPHERICAL = 3
TELECENTRIC = 4        # src/sensors/telecentric.cpp
RADIANCEMETER = 5      # src/sensors/radiancemeter.cpp
FLUENCEMETER = 6       # src/sensors/fluencemeter.cpp
IRRADIANCEMETER = 7    # src/sensors/irradiancemeter.cpp
PERSPECTIVE_RDIST = 8  # src/sensors/perspective_rdist.cpp


class Camera(NamedTuple):
    kind: int
    to_world: np.ndarray       # [4, 4] camera -> world (rigid), host
    tan_half_fov: float        # tan(xfov / 2)
    aspect: float              # width / height
    width: int
    height: int
    near: float = 1e-2
    far: float = 1e4
    aperture_radius: float = 0.0
    focus_distance: float = 1.0
    kc0: float = 0.0           # radial distortion r^2 coefficient
    kc1: float = 0.0           # radial distortion r^4 coefficient

    @staticmethod
    def perspective(to_world, fov_deg: float, width: int, height: int,
                    fov_axis: str = "x", near: float = 1e-2,
                    far: float = 1e4, aperture_radius: float = 0.0,
                    focus_distance: float = 1.0,
                    kind: int = PERSPECTIVE) -> "Camera":
        aspect = width / height
        fov = np.radians(fov_deg)
        if fov_axis == "y" or (fov_axis == "smaller" and aspect >= 1):
            fov = 2.0 * np.arctan(np.tan(fov / 2.0) * aspect)
        elif fov_axis == "diagonal":
            diag = np.hypot(aspect, 1.0)
            fov = 2.0 * np.arctan(np.tan(fov / 2.0) * aspect / diag)
        return Camera(kind=kind, to_world=np.asarray(to_world, np.float32),
                      tan_half_fov=float(np.float32(np.tan(fov / 2.0))),
                      aspect=aspect, width=width, height=height, near=near,
                      far=far, aperture_radius=aperture_radius,
                      focus_distance=focus_distance)


def _probe(cam: Camera, u, o, d):
    """A ray of constant clip distances (the kinds without a film
    plane)."""
    return Ray(o=o.contiguous(), d=d, mint=torch.full_like(u, cam.near),
               maxt=torch.full_like(u, cam.far))


def sample_ray(cam: Camera, pos, aperture_sample=None) -> Ray:
    """Camera rays for continuous film positions pos [N, 2] (pixel
    centres at i + 0.5); aperture_sample [N, 2] places the thin lens's and
    the telecentric lens's ray on the aperture. With u, v = pos /
    resolution the camera direction is ((1-2u) tan, (1-2v) tan / aspect,
    1): camera x points screen-left, y up, z forward
    (src/sensors/perspective.cpp:148-158)."""
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
    zero = torch.zeros_like(u)

    if cam.kind == ORTHOGRAPHIC:
        d_cam = torch.zeros_like(near_p)
        d_cam[..., 2] = 1.0
        o_cam = torch.stack([near_p[..., 0], near_p[..., 1], zero], dim=-1)
        return _probe(cam, u, o_cam @ R.T + o_world, d_cam @ R.T)
    if cam.kind == SPHERICAL:
        # the lat-long map of the whole sphere (src/sensors/spherical.cpp)
        phi = (1.0 - 2.0 * u) * math.pi
        theta = v * math.pi
        st, ct = torch.sin(theta), torch.cos(theta)
        d = torch.stack([st * torch.sin(phi), ct, -st * torch.cos(phi)],
                        dim=-1) @ R.T
        return _probe(cam, u, torch.broadcast_to(o_world, d.shape), d)
    if cam.kind == RADIANCEMETER:
        # every sample measures along +z (radiancemeter.cpp sampleRay)
        d_cam = torch.zeros_like(near_p)
        d_cam[..., 2] = 1.0
        return _probe(cam, u, torch.broadcast_to(o_world, d_cam.shape),
                      d_cam @ R.T)
    if cam.kind == FLUENCEMETER:
        # uniform-sphere directions from the film coordinates
        # (fluencemeter.cpp; develop averages over the sphere)
        z = 1.0 - 2.0 * v
        r_ = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2.0 * math.pi * u
        d_cam = torch.stack([r_ * torch.cos(phi), r_ * torch.sin(phi), z],
                            dim=-1)
        return _probe(cam, u, torch.broadcast_to(o_world, d_cam.shape),
                      d_cam @ R.T)
    if cam.kind == IRRADIANCEMETER:
        # the cosine-weighted hemisphere around +z, probed at the sensor's
        # origin (irradiancemeter.cpp attaches to a shape)
        r_ = torch.sqrt(torch.clamp(v, 0.0, 1.0))
        phi = 2.0 * math.pi * u
        z = torch.sqrt(torch.clamp(1.0 - r_ * r_, min=0.0))
        d_cam = torch.stack([r_ * torch.cos(phi), r_ * torch.sin(phi), z],
                            dim=-1)
        return _probe(cam, u, torch.broadcast_to(o_world, d_cam.shape),
                      d_cam @ R.T)
    if cam.kind == TELECENTRIC:
        # orthographic with a finite aperture focused at focus_distance
        # (telecentric.cpp)
        ap = warps.square_to_uniform_disk_concentric(
            aperture_sample if aperture_sample is not None
            else torch.zeros_like(pos)) * cam.aperture_radius
        p_focus = torch.stack([near_p[..., 0], near_p[..., 1],
                               torch.full_like(u, cam.focus_distance)], -1)
        o_cam = torch.stack([near_p[..., 0] + ap[..., 0],
                             near_p[..., 1] + ap[..., 1], zero], dim=-1)
        d_cam = normalize(p_focus - o_cam)
        return _probe(cam, u, o_cam @ R.T + o_world, d_cam @ R.T)
    if cam.kind == PERSPECTIVE_RDIST and (cam.kc0 != 0.0 or cam.kc1 != 0.0):
        # polynomial radial distortion on the image plane
        # (perspective_rdist.cpp, the kc coefficients)
        r2 = near_p[..., 0] ** 2 + near_p[..., 1] ** 2
        f = 1.0 + cam.kc0 * r2 + cam.kc1 * r2 * r2
        near_p = torch.stack([near_p[..., 0] * f, near_p[..., 1] * f,
                              near_p[..., 2]], dim=-1)

    d_cam = normalize(near_p)
    if cam.kind == THINLENS and cam.aperture_radius > 0.0:
        # the focus plane at focus_distance (thinlens.cpp)
        ap = warps.square_to_uniform_disk_concentric(aperture_sample) \
            * cam.aperture_radius
        focus_t = cam.focus_distance / d_cam[..., 2]
        p_focus = d_cam * focus_t[..., None]
        o_cam = torch.stack([ap[..., 0], ap[..., 1], zero], dim=-1)
        d_cam = normalize(p_focus - o_cam)
        o = o_cam @ R.T + o_world
    else:
        o = torch.broadcast_to(o_world, d_cam.shape)
    d = d_cam @ R.T
    inv_z = 1.0 / d_cam[..., 2]
    return Ray(o=o.contiguous(), d=d, mint=cam.near * inv_z,
               maxt=cam.far * inv_z)


def camera_importance(cam: Camera, p_world):
    """Pinhole-perspective importance for light-to-camera connections
    (bdpt's t = 1 strategies and particle tracing; reference:
    PerspectiveCamera::sampleDirect and importance,
    src/sensors/perspective.cpp:329-408). The JAX package uses it for
    every sensor kind, and so does the port.

    Returns (film_pos [N, 2], We [N], dist [N], dir_to_cam [N, 3],
    valid [N]); the splat estimator for a point x with scattered value
    f cos(theta_x) is f cos(theta_x) We / dist^2."""
    m = torch.as_tensor(cam.to_world, device=p_world.device)
    R = m[:3, :3]
    rel = p_world - m[:3, 3]
    pc = rel @ R                       # camera space (columns = axes)
    z = pc[..., 2]
    valid = z > cam.near
    zs = torch.where(valid, z, 1.0)
    xi = pc[..., 0] / zs
    yi = pc[..., 1] / zs
    t = cam.tan_half_fov
    u = (1.0 - xi / t) * 0.5
    v = (1.0 - yi * cam.aspect / t) * 0.5
    valid = valid & (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
    film_pos = torch.stack([u * cam.width, v * cam.height], dim=-1)
    dist = torch.sqrt(torch.clamp(torch.sum(rel * rel, dim=-1), min=1e-20))
    cos_theta = z / dist
    area = 4.0 * t * t / cam.aspect    # film area on the z = 1 plane
    we = 1.0 / torch.clamp(area * cos_theta ** 3, min=1e-9)
    d_to_cam = -rel / dist[..., None]
    return film_pos, torch.where(valid, we, 0.0), dist, d_to_cam, valid
