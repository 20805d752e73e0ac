"""Hair fiber geometry for the forward render (numpy copy of the parts of
hairpt/scene/hairgen.py the furball needs: FiberSet, segments and
gen_furball). Host-side, runs once per scene build."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FiberSet(NamedTuple):
    vertices: np.ndarray            # [V, 3] float
    vertex_starts_fiber: np.ndarray  # [V] bool
    radius: float


def segments(fs: FiberSet):
    """Flatten fibers into per-segment arrays with miter end planes
    (reference geometry model: hair.cpp:70-74, 570-596).
    Returns dict of float32 arrays p0,p1,n0,n1 and int fiber ids."""
    v = np.asarray(fs.vertices, np.float64)
    s = np.asarray(fs.vertex_starts_fiber, bool)
    n = len(v)
    iv = np.arange(n - 1)
    seg_mask = ~s[1:]                       # segment (i, i+1) exists
    iv = iv[seg_mask]
    d = v[1:] - v[:-1]
    dn = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-20)

    tang = dn[iv]
    has_prev = np.zeros(len(iv), bool)
    has_next = np.zeros(len(iv), bool)
    prev_t = np.zeros_like(tang)
    next_t = np.zeros_like(tang)
    has_prev = (iv - 1 >= 0) & ~s[iv]
    valid_prev = np.clip(iv - 1, 0, n - 2)
    prev_t = dn[valid_prev]
    has_next = (iv + 1 <= n - 2) & ~s[np.clip(iv + 2, 0, n - 1)]
    valid_next = np.clip(iv + 1, 0, n - 2)
    next_t = dn[valid_next]

    def miter(tt, other, has):
        m = tt + other
        ln = np.linalg.norm(m, axis=-1, keepdims=True)
        m = np.where(ln > 1e-12, m / np.maximum(ln, 1e-12), tt)
        return np.where(has[:, None], m, tt)

    n0 = miter(tang, prev_t, has_prev)
    n1 = miter(tang, next_t, has_next)
    return dict(p0=v[iv].astype(np.float32), p1=v[iv + 1].astype(np.float32),
                n0=n0.astype(np.float32), n1=n1.astype(np.float32),
                radius=np.full(len(iv), fs.radius, np.float32))


def gen_furball(n_fibers: int = 6000, n_segs: int = 12,
                radius: float = 0.00216667, seed: int = 3,
                center=(0.0, 11.0, 0.0), core_r: float = 1.6,
                fiber_len: float = 1.8) -> FiberSet:
    """Radial fur on a sphere with gravity droop, framed like
    models/furball/scene.xml (camera at (-10.7, 14.3, 10.3) aimed at
    roughly (0, 11, 0))."""
    rng = np.random.default_rng(seed)
    center = np.asarray(center)
    # even-ish directions over the sphere
    u = rng.random((n_fibers, 2))
    z = 1 - 2 * u[:, 0]
    r = np.sqrt(np.maximum(1 - z * z, 0))
    phi = 2 * np.pi * u[:, 1]
    dirs = np.stack([r * np.cos(phi), z, r * np.sin(phi)], -1)
    t = np.linspace(0, 1, n_segs + 1)
    lengths = fiber_len * rng.uniform(0.75, 1.25, n_fibers)
    # droop: blend direction toward -y along the fiber
    droop = 0.55 * t ** 2
    pts = center + dirs[:, None, :] * (core_r + lengths[:, None]
                                       * t[None, :])[:, :, None]
    pts[..., 1] -= droop[None, :] * lengths[:, None]
    # slight per-fiber waviness
    wob = rng.normal(0, 0.03, (n_fibers, 1, 3)) * np.sin(
        np.pi * 3 * t)[None, :, None]
    pts = pts + wob * lengths[:, None, None]
    verts = pts.reshape(-1, 3)
    starts = np.zeros(len(verts), bool)
    starts[::n_segs + 1] = True
    return FiberSet(verts, starts, radius)
