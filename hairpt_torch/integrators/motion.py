"""Motion-vector AOV integrator (port of hairpt/integrators/motion.py;
reference src/integrators/misc/motion.cpp).

For every pixel it finds the camera hit at the frame time, moves that
point to the target time by its object's rigid motion (Scene.motion:
MotionTables) and reprojects it through the camera at the target time.
The channels are the reference's: R, G the motion in pixels, B the change
of the point's distance to the camera; a pixel with nothing to track is
+inf.

Path configurations (motion.cpp's `config`): 'd' tracks the camera hit
(one scene query per wave); 'rd', 'ttd', 'trtd', ... track a diffuse point
seen through the chain of delta events the characters name (r a
reflection, t a transmission, followed from the camera): the chain is
traced, its end point moved, and the t1 image position that sees the
moved point through the same chain is found by 7 Newton iterations on the
image position, each retracing the chain three times (len(config) queries
a trace). Specular geometry and hair are taken as static.

Every query goes through common.scene_intersect (the hair through kernels
A and B under 'tiled', the triangles through kernel F).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rng
from ..core.math import Ray, coordinate_system, dot
from ..models import sensors
from ..models.bsdf import registry as mat
from .common import scene_intersect
from .mlt import _delta_bounce, _hit_to_vertex, _norm, camera_ray
from .path import _swept_params


def _advance(motion, hit):
    """p1 = M_obj p (the hit itself on hair or without tables). The
    object id is read at the hit's prim, clamped into the triangle table
    as the JAX package's gather clamps it, so an instance hit (whose
    prim is its prototype's triangle id) takes the motion of the
    top-level triangle of that index, as in the JAX package."""
    if motion is None or motion.tri_obj is None:
        return hit.p
    n_tri = motion.tri_obj.shape[0]
    obj = motion.tri_obj[torch.clamp(hit.prim, 0, n_tri - 1).long()]
    m = motion.obj_m[torch.where(hit.is_hair, 0, obj).long()]
    moved = torch.einsum("nij,nj->ni", m[:, :3, :3], hit.p) + m[:, :3, 3]
    return torch.where(hit.is_hair[..., None], hit.p, moved)


def _cam_pos(cam, dev):
    return torch.as_tensor(np.asarray(cam.to_world)[:3, 3],
                           dtype=torch.float32, device=dev)


def render_motion(scene, spp: int = 1, config: str | None = None):
    """The [H, W, 3] image of (dx_px, dy_px, d_dist), averaged over spp
    sample indices (pixel centres at spp 1); config defaults to the
    scene's RenderConfig.motion_config."""
    cfg = scene.config
    config = config or cfg.motion_config
    arr = scene.arrays
    dev = arr.device
    params = _swept_params(cfg)
    cam0 = scene.camera
    mt = scene.motion
    cam1 = mt.cam1 if mt is not None else cam0
    n_pix = cfg.width * cfg.height
    kind_tab = arr.materials.kind
    chars = config[:-1]

    def chain_trace(pos, cam):
        """The delta chain traced from image pos: (the ray leaving its
        last vertex, the end point's hit, ok)."""
        r = camera_ray(cam, pos)
        okc = torch.ones((n_pix,), dtype=torch.bool, device=dev)
        for c in chars:
            h = scene_intersect(arr, r, **params)
            kind = kind_tab[torch.clamp(h.mat_id, min=0).long()]
            is_delta = (kind == mat.CONDUCTOR) | (kind == mat.DIELECTRIC) \
                | (kind == mat.THINDIELECTRIC)
            if c == "t":
                is_delta = is_delta & (kind != mat.CONDUCTOR)
            okc = okc & h.valid & is_delta & ~h.is_hair
            choice = torch.full((n_pix,), 1 if c == "t" else 0,
                                dtype=torch.int32, device=dev)
            d_n, _, _ = _delta_bounce(arr, scene.active_kinds,
                                      _hit_to_vertex(h, okc), -r.d, choice)
            o_n = h.p + h.geo_n * torch.where(
                dot(d_n, h.geo_n) > 0, cfg.ray_eps, -cfg.ray_eps)[..., None]
            r = Ray(o=o_n, d=d_n, mint=torch.zeros(n_pix, device=dev),
                    maxt=torch.where(okc, float("inf"), 0.0))
        return r, scene_intersect(arr, r, **params), okc

    def wave(sample_id: int):
        pixel = torch.arange(n_pix, device=dev)
        px = (pixel % cfg.width).to(torch.float32)
        py = (pixel // cfg.width).to(torch.float32)
        if spp > 1:
            jit2 = rng.Sampler(cfg.sampler, pixel, sample_id).next_2d(0)
        else:
            jit2 = torch.full((n_pix, 2), 0.5, device=dev)
        pos0 = torch.stack([px + jit2[..., 0], py + jit2[..., 1]], -1)
        if config != "d":
            _, end_hit, ok = chain_trace(pos0, cam0)
            ok = ok & end_hit.valid & ~end_hit.is_hair
            xd_t1 = _advance(mt, end_hit)

            def miss(r_, sB, tB):
                """The perpendicular miss of the ray past xd_t1, in the
                ray's frame."""
                e = xd_t1 - r_.o
                ep = e - dot(e, r_.d)[..., None] * r_.d
                return torch.stack([dot(ep, sB), dot(ep, tB)], -1)

            # Newton on the t1 image position
            pos = pos0
            d_px = 0.25
            du_px = torch.tensor([d_px, 0.0], device=dev)
            dv_px = torch.tensor([0.0, d_px], device=dev)
            for _ in range(7):
                rC, _, okC = chain_trace(pos, cam1)
                sB, tB = coordinate_system(rC.d)
                f0 = miss(rC, sB, tB)
                rU, _, okU = chain_trace(pos + du_px, cam1)
                rV, _, okV = chain_trace(pos + dv_px, cam1)
                fU = (miss(rU, sB, tB) - f0) / d_px
                fV = (miss(rV, sB, tB) - f0) / d_px
                det = fU[..., 0] * fV[..., 1] - fV[..., 0] * fU[..., 1]
                good = okC & okU & okV & (torch.abs(det) > 1e-20)
                inv = 1.0 / torch.where(good, det, 1.0)
                du = (-fV[..., 1] * f0[..., 0] + fV[..., 0] * f0[..., 1]) \
                    * inv
                dv = (fU[..., 1] * f0[..., 0] - fU[..., 0] * f0[..., 1]) \
                    * inv
                # trust region: at most 4 px per iteration
                mag = torch.sqrt(du * du + dv * dv)
                sc = torch.clamp(4.0 / torch.clamp(mag, min=1e-12), max=1.0)
                pos = torch.where(good[..., None],
                                  pos + torch.stack([du * sc, dv * sc], -1),
                                  pos)

            rF, _, okF = chain_trace(pos, cam1)
            sB, tB = coordinate_system(rF.d)
            fF = miss(rF, sB, tB)
            dist1 = _norm(xd_t1 - _cam_pos(cam1, dev))
            dist0 = _norm(end_hit.p - _cam_pos(cam0, dev))
            chord = _norm(xd_t1 - rF.o)
            converged = _norm(fF) < 1e-3 * torch.clamp(chord, min=1e-3)
            in_img = (pos[..., 0] >= 0) & (pos[..., 0] <= cfg.width) \
                & (pos[..., 1] >= 0) & (pos[..., 1] <= cfg.height)
            ok = ok & okF & converged & in_img
            pos1 = pos
        else:
            hit = scene_intersect(arr, camera_ray(cam0, pos0),
                                  **params)
            pos1, _, dist1, _, vis1 = sensors.camera_importance(
                cam1, _advance(mt, hit))
            dist0 = torch.sqrt(torch.clamp(torch.sum(
                (hit.p - _cam_pos(cam0, dev)) ** 2, -1), min=1e-20))
            ok = hit.valid & vis1
        v = torch.stack([pos1[..., 0] - pos0[..., 0],
                         pos1[..., 1] - pos0[..., 1], dist1 - dist0], -1)
        return torch.where(ok[..., None], v, 0.0), ok.to(torch.float32)

    acc = torch.zeros((n_pix, 3), device=dev)
    cnt = torch.zeros((n_pix,), device=dev)
    for s in range(spp):
        v, c = wave(s)
        acc = acc + v
        cnt = cnt + c
    img = torch.where(cnt[..., None] > 0,
                      acc / torch.clamp(cnt, min=1.0)[..., None],
                      float("inf"))
    return img.reshape(cfg.height, cfg.width, 3)
