"""Specular manifold walk, batched (port of hairpt/integrators/manifold.py;
reference include/mitsuba/bidir/manifold.h, src/libbidir/manifold.cpp,
Jakob & Marschner 2012 "Manifold exploration").

Given a segment a -> x -> b whose middle vertex is specular (mirror
reflection or refraction), move x on the surface until the segment is a
valid specular chain. N chains walk in lockstep as a fixed-iteration
Newton loop over lanes:

  constraint  c(x) = the tangential components, in the frame (s, t) of
              n(x), of the difference between the direction to b and the
              mirror or Snell direction of the ray a -> x
  Jacobian    2 x 2 by symmetric finite differences along (s, t), each
              probe re-projected onto the geometry
  step        x <- project(x + du s + dv t), the displaced point put back
              on the surface by tracing a -> x' (manifold.cpp project()),
              which also refreshes n(x); a step longer than half the
              shorter chord is cut to it

Each iteration is five scene queries (four probes and the step's
reprojection), each through common.scene_intersect (the hair through
kernels A and B under 'tiled', the triangles through kernel F), with
mint = 1% of the chord. Dead lanes are traced all the same, with
maxt = 0, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..core.math import Ray, coordinate_system, dot, normalize
from .common import scene_intersect
from .path import _swept_params


def _norm(a):
    """|a| over the last axis as the JAX package computes it
    (sqrt of the sum of squares)."""
    return torch.sqrt(torch.sum(a * a, -1))


def _constraint(a, b, x, n, eta):
    """The specular constraint at x: the tangential components of the
    difference between the direction to b and the mirror / Snell
    direction predicted for the ray a -> x (the half-vector form's zero
    set, conditioned uniformly in eta). eta = n_dest / n_src seen from
    a's side; eta == 1 is a mirror. Total internal reflection leaves
    cost 0, so such a lane never passes a tolerance. Returns (c [N, 2],
    (s, t))."""
    wa = normalize(a - x)
    wb = normalize(b - x)
    cos_s = dot(wa, n)
    n_o = torch.where(cos_s[..., None] < 0, -n, n)   # toward a
    cosi = torch.abs(cos_s)
    refl = 2.0 * cosi[..., None] * n_o - wa
    inv_eta = 1.0 / torch.clamp(eta, min=1e-6)
    k = 1.0 - inv_eta ** 2 * (1.0 - cosi ** 2)
    cost = torch.sqrt(torch.clamp(k, min=0.0))
    refr = -inv_eta[..., None] * wa \
        + (inv_eta * cosi - cost)[..., None] * n_o
    d_pred = torch.where((eta == 1.0)[..., None], refl, refr)
    diff = wb - d_pred
    s, t = coordinate_system(n)
    return torch.stack([dot(s, diff), dot(t, diff)], -1), (s, t)


def walk(arr, cfg, a, b, hit0, eta=None, n_iters: int = 16,
         step_scale: float = 1.0, tol: float = 1e-4):
    """Move the specular vertex of hit0 (x = hit0.p, n = hit0.sh_n) so
    that a -> x -> b becomes a specular chain. a, b [N, 3] the fixed
    endpoints, eta [N] the relative IOR per lane (None: mirrors).
    Returns (x [N, 3], n [N, 3], ok [N]): ok where |c| < tol at the end
    and hit0 was valid. 5 n_iters scene queries."""
    n_l = a.shape[0]
    dev = a.device
    if eta is None:
        eta = torch.ones((n_l,), device=dev)
    params = _swept_params(cfg)
    x = hit0.p
    n = hit0.sh_n
    valid = hit0.valid
    # the finite-difference scale: a fraction of the shorter chord
    fd = 1e-3 * torch.minimum(_norm(a - x), _norm(b - x)) + 1e-7
    maxt = torch.where(valid, float("inf"), 0.0)

    def reproject(x_new):
        """Trace a -> x' back onto the geometry (manifold.cpp project());
        the ray skips the first 1% of the chord, so an endpoint lying on
        geometry itself does not hit itself."""
        d = x_new - a
        dist = _norm(d)
        d = d / torch.clamp(dist, min=1e-12)[..., None]
        h = scene_intersect(arr, Ray(o=a, d=d, mint=0.01 * dist,
                                     maxt=maxt), **params)
        return h.p, h.sh_n, h.valid

    def probe(x_disp):
        """The constraint at the re-projected displaced point, so the
        difference carries the surface's normal field (manifold.cpp's
        dndu / dndv terms)."""
        xp, np_, hp = reproject(x_disp)
        c, _ = _constraint(a, b, xp, np_, eta)
        return c, hp

    for _ in range(n_iters):
        c, (s, t) = _constraint(a, b, x, n, eta)
        cp_u, ok_u = probe(x + s * fd[..., None])
        cm_u, ok_u2 = probe(x - s * fd[..., None])
        cp_v, ok_v = probe(x + t * fd[..., None])
        cm_v, ok_v2 = probe(x - t * fd[..., None])
        fd_ok = ok_u & ok_u2 & ok_v & ok_v2
        j00 = (cp_u[..., 0] - cm_u[..., 0]) / (2 * fd)
        j10 = (cp_u[..., 1] - cm_u[..., 1]) / (2 * fd)
        j01 = (cp_v[..., 0] - cm_v[..., 0]) / (2 * fd)
        j11 = (cp_v[..., 1] - cm_v[..., 1]) / (2 * fd)
        det = j00 * j11 - j01 * j10
        inv = 1.0 / torch.where(torch.abs(det) < 1e-12, 1.0, det)
        du = -(j11 * c[..., 0] - j01 * c[..., 1]) * inv
        dv = -(-j10 * c[..., 0] + j00 * c[..., 1]) * inv
        # trust region: at most half the shorter chord
        max_step = step_scale * torch.minimum(_norm(a - x),
                                              _norm(b - x)) * 0.5
        mag = torch.sqrt(du * du + dv * dv)
        scale = torch.clamp(max_step / torch.clamp(mag, min=1e-12), max=1.0)
        du = du * scale
        dv = dv * scale
        xp, np_, hp = reproject(x + s * du[..., None] + t * dv[..., None])
        # a failed step (a miss, a singular Jacobian) leaves the lane
        # where it was
        good = hp & fd_ok & (torch.abs(det) > 1e-12)
        x = torch.where(good[..., None], xp, x)
        n = torch.where(good[..., None], np_, n)

    c_fin, _ = _constraint(a, b, x, n, eta)
    return x, n, valid & (_norm(c_fin) < tol)


def generalized_g(a, b, x, n, eta=None, fd: float = 1e-4):
    """The generalized geometric term of the chain a -> x -> b
    (manifold.h G()): G(a <-> x) times |det dc/db| / |det dc/dx|, both
    2 x 2 Jacobians by forward differences of the constraint. [N]."""
    n_l = a.shape[0]
    if eta is None:
        eta = torch.ones((n_l,), device=a.device)
    wa = normalize(x - a)
    d2 = torch.sum((x - a) ** 2, -1)
    g_ax = torch.abs(dot(wa, n)) / torch.clamp(d2, min=1e-12)
    c, (s, t) = _constraint(a, b, x, n, eta)
    fdv = fd * (torch.sqrt(d2) + 1e-6)
    sb, tb = coordinate_system(normalize(b - x))
    jb = torch.stack([(_constraint(a, b + db * fdv[..., None], x, n,
                                   eta)[0] - c) / fdv[..., None]
                      for db in (sb, tb)], -1)          # [N, 2, 2] dc/db
    jx = torch.stack([(_constraint(a, b, x + dx * fdv[..., None], n,
                                   eta)[0] - c) / fdv[..., None]
                      for dx in (s, t)], -1)            # [N, 2, 2] dc/dx
    det_b = jb[:, 0, 0] * jb[:, 1, 1] - jb[:, 0, 1] * jb[:, 1, 0]
    det_x = jx[:, 0, 0] * jx[:, 1, 1] - jx[:, 0, 1] * jx[:, 1, 0]
    return g_ax * (torch.abs(det_b) / torch.clamp(torch.abs(det_x),
                                                  min=1e-12))
