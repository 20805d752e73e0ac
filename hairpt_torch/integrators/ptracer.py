"""Adjoint particle tracer: light paths splatted through the camera (port
of hairpt/integrators/ptracer.py; reference src/integrators/ptracer/*,
CaptureParticleWorker).

Particles leave every emitter group (the environment from a tangent disk
of the scene's bounding sphere, the area lights, the delta lights; the
groups picked by the scene's NEE probabilities), bounce through the scene
by BSDF sampling with Russian roulette, and every vertex (the emitter
point itself where it has a finite position and no delta direction) is
connected to the camera with a shadow ray and splatted through
sensors.camera_importance (the pinhole importance, for every sensor kind,
as in the JAX package) with film.splat_add_only. Single strategy: no MIS.
The bounce and shadow queries are Morton-sorted (scene_occluded and
scene_intersect with sort_rays), as the JAX package's are. Seeds wrap to
32 bits as the JAX package's uint32 arithmetic does.
"""
from __future__ import annotations

import math
import time

import torch

from ..core import rng
from ..core.math import Ray, dot
from ..film import film as film_mod
from ..models import emitters as em
from ..models import sensors
from ..models.bsdf import registry as mat
from .common import scene_intersect, scene_occluded
from .path import _swept_params
from .photonmap import _emit_env, _flip_frame, _scene_bsphere, _u32
from .volpath import _offset


def render_ptracer(scene, n_paths: int = 1 << 15, spp_norm=None,
                   s_max: int = 5, seed: int = 0, progress=None):
    """Particle-traced render. n_paths light subpaths per wave; the
    number of waves makes the work about the film's spp budget:
    max(1, W H spp // (4 n_paths)). Returns the [H, W, 3] image.
    progress: callable(done_waves, waves, seconds, n_paths) per wave."""
    cfg = scene.config
    arr = scene.arrays
    cam = scene.camera
    fl = scene.film
    dev = arr.device
    active_kinds = scene.active_kinds
    params = _swept_params(cfg)
    if arr.area is None and arr.delta is None and arr.env is None:
        raise ValueError("ptracer needs an emitter")
    n_waves = max(1, (cfg.width * cfg.height * cfg.spp) // (4 * n_paths))
    n = n_paths
    p_env, p_area, p_delta = cfg.nee_probs
    center, radius = _scene_bsphere(arr)
    zero = torch.zeros((n,), device=dev)

    def camera_splat(splat_img, p, val, ok, geo_n=None):
        """Visibility-test p towards the camera and splat val We / d^2."""
        film_pos, we, dist, d_cam, vis = sensors.camera_importance(cam, p)
        ok = ok & vis
        c = val * (we / torch.clamp(dist * dist, min=1e-12))[..., None]
        ok = ok & (torch.amax(torch.abs(c), dim=-1) > 0)
        off = d_cam if geo_n is None else geo_n * torch.where(
            dot(d_cam, geo_n) > 0, 1.0, -1.0)[..., None]
        sh = Ray(o=p + off * cfg.ray_eps, d=d_cam, mint=zero,
                 maxt=torch.where(ok, dist - 2 * cfg.ray_eps, 0.0))
        occ = scene_occluded(arr, sh, sort_rays=True, **params)
        c = torch.where((ok & ~occ)[..., None], c, 0.0)
        return film_mod.splat_add_only(fl, film_pos, c, splat_img)

    def one_wave(wave_id: int, splat_img):
        idx = torch.arange(n, device=dev)
        sd = _u32(wave_id * 2654435761 + seed)
        u_dir = rng.uniform_2d(idx, sd, 0)
        u_disk = rng.uniform_2d(idx, sd, 2)
        u_grp = rng.uniform_1d(idx, sd, 4)
        u_sel = rng.uniform_1d(idx, sd, 5)
        u_tri = rng.uniform_2d(idx, sd, 6)
        grp = torch.where(u_grp < p_env, 0,
                          torch.where(u_grp < p_env + p_area, 1, 2))
        o = center.expand(n, 3)
        d = torch.zeros((n, 3), device=dev)
        d[:, 2] = 1.0
        pw = torch.zeros((n, 3), device=dev)
        if arr.env is not None and p_env > 0:
            o_e, d_e, pw_e = _emit_env(arr, center, radius, u_dir, u_disk)
            m = (grp == 0)[..., None]
            o = torch.where(m, o_e, o)
            d = torch.where(m, d_e, d)
            pw = torch.where(m, pw_e / p_env, pw)
        if arr.area is not None and p_area > 0:
            o_a, d_a, n_a, pw_a = em.area_emit(arr.area, u_sel, u_tri, u_dir)
            m = (grp == 1)[..., None]
            o = torch.where(m, o_a, o)
            d = torch.where(m, d_a, d)
            pw = torch.where(m, pw_a / p_area, pw)
            # s = 1: the emitter point itself, Le cos to the camera; the
            # position-only pdf gives (L A / p_sel) cos = (pw_a / pi) cos
            _, _, _, d_cam, _ = sensors.camera_importance(cam, o_a)
            cos_l = torch.clamp(dot(n_a, d_cam), min=0.0)
            splat_img = camera_splat(
                splat_img, o_a, pw_a / (math.pi * p_area) * cos_l[..., None],
                grp == 1, geo_n=n_a)
        if arr.delta is not None and p_delta > 0:
            dl = arr.delta
            o_d, d_d, pw_d, (l_i, prob) = em.delta_emit(dl, u_sel, u_dir,
                                                        center, radius)
            m = (grp == 2)[..., None]
            o = torch.where(m, o_d, o)
            d = torch.where(m, d_d, d)
            pw = torch.where(m, pw_d / p_delta, pw)
            # s = 1 for the finite-position, non-delta-direction emitters
            kind = dl.kind[l_i]
            inten = dl.intensity[l_i]
            _, _, _, d_cam, _ = sensors.camera_importance(cam, o_d)
            cos_sp = dot(dl.direction[l_i], d_cam)
            cc = dl.cos_cutoff[l_i]
            cb = dl.cos_beam[l_i]
            fall = torch.clamp((cos_sp - cc) / torch.clamp(cb - cc, min=1e-6),
                               0.0, 1.0)
            fall = torch.where(cos_sp >= cb, 1.0, fall)
            i_cam = torch.where((kind == em.SPOT)[..., None],
                                inten * fall[..., None], inten)
            finite = (kind == em.POINT) | (kind == em.SPOT)
            splat_img = camera_splat(
                splat_img, o_d,
                i_cam / (torch.clamp(prob, min=1e-12) * p_delta)[..., None],
                (grp == 2) & finite)

        alive = torch.amax(pw, dim=-1) > 0
        for b in range(s_max):
            r = Ray(o=o + d * cfg.ray_eps, d=d, mint=zero,
                    maxt=torch.where(alive, float("inf"), 0.0))
            hit = scene_intersect(arr, r, sort_rays=True, **params)
            landed = alive & hit.valid
            wi_world = -d
            fr, geo_n = _flip_frame(arr, hit, wi_world)
            wi = fr.to_local(wi_world)
            gm = mat.gather(arr.materials, arr.checkers, hit.mat_id, hit.uv)
            # connect this vertex to the camera
            _, _, _, d_cam, _ = sensors.camera_importance(cam, hit.p)
            f_cam, _ = mat.eval_pdf_mix(active_kinds, arr.materials,
                                        arr.checkers, hit.mat_id, hit.uv, gm,
                                        wi, fr.to_local(d_cam),
                                        arr.hair_tables)
            splat_img = camera_splat(splat_img, hit.p, pw * f_cam, landed,
                                     geo_n=geo_n)
            # continue the subpath
            dims = 8 + b * 8
            wo, w, _, _, _ = mat.sample_mix(
                active_kinds, arr.materials, arr.checkers, hit.mat_id, hit.uv,
                gm, wi, rng.uniform_1d(idx, sd, dims),
                rng.uniform_2d(idx, sd, dims + 1),
                rng.uniform_2d(idx, sd, dims + 3), arr.hair_tables)
            wo_world = fr.to_world(wo)
            pw2 = pw * w
            q = torch.clamp(torch.amax(w, dim=-1), 0.0, 0.95)
            keep = rng.uniform_1d(idx, sd, dims + 5) < q
            pw = pw2 / torch.clamp(q, min=1e-6)[..., None]
            alive = landed & keep & (torch.amax(pw, dim=-1) > 0)
            o = _offset(hit.p, geo_n, wo_world, cfg.ray_eps)
            d = wo_world
        return splat_img

    splat_img = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    for w in range(n_waves):
        t0 = time.time()
        splat_img = one_wave(w + 1, splat_img)
        if progress is not None:
            progress(w + 1, n_waves, time.time() - t0, float(n))
    # each particle carries flux / n_paths; the splats estimate the
    # measurement integral per pixel (bdpt's t = 1 splats: the W H
    # normalization)
    return splat_img * (cfg.width * cfg.height) / (n_paths * n_waves)
