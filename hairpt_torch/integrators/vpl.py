"""Instant radiosity with virtual point lights (port of
hairpt/integrators/vpl.py; reference src/integrators/vpl/vpl.cpp and the
VPL generation of src/librender/vpl.cpp).

trace_vpls emits light subpaths as the photon pass does
(photonmap._env_emit: every emitter group) and deposits a VPL at every
surface interaction, with its shading frame, material and incident flux.
The camera pass takes each pixel's first hit, adds direct lighting by the
path tracer's NEE (the reference's luminaire VPLs) and the environment
where the ray escapes, and sums every VPL's f_x f_y / max(r^2, clamp^2)
Phi with one shadow query per valid VPL per wave (n_paths x max_bounces
VPLs: 384 at the defaults; one that no subpath deposited adds nothing and
is skipped). Sample dimensions and seeds are the JAX package's.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..core import rng
from ..core.math import Frame, Ray
from ..film import film as film_mod
from ..models import sensors
from ..models.bsdf import registry as mat
from .common import scene_intersect, scene_occluded
from .path import (DIM_BASE, DIM_CAM_POS, DIM_STRIDE, _env_radiance,
                   _sample_emitter_direct, _swept_params)
from .photonmap import _env_emit, _flip_frame, _u32
from .volpath import _offset


class VPLSet(NamedTuple):
    pos: torch.Tensor     # [M, 3]
    power: torch.Tensor   # [M, 3] incident flux carried by the subpath
    wi: torch.Tensor      # [M, 3] world incident direction at the VPL
    sh_s: torch.Tensor    # [M, 3] shading frame
    sh_t: torch.Tensor
    sh_n: torch.Tensor
    geo_n: torch.Tensor   # [M, 3]
    mat_id: torch.Tensor  # [M]
    uv: torch.Tensor      # [M, 2]
    valid: torch.Tensor   # [M]


def trace_vpls(scene, n_paths: int, max_bounces: int = 3,
               seed: int = 0) -> VPLSet:
    """Light subpaths from every emitter group, a VPL at every surface
    interaction, bounce-major (reference: generateVPLs,
    src/librender/vpl.cpp:71-162)."""
    cfg = scene.config
    arr = scene.arrays
    params = _swept_params(cfg)
    dev = arr.device
    idx = torch.arange(n_paths, device=dev)
    smp = rng.Sampler(cfg.sampler, idx, _u32(seed * 811 + 7))
    ray, pw = _env_emit(scene, n_paths, seed)
    o, d = ray.o, ray.d
    alive = torch.ones((n_paths,), dtype=torch.bool, device=dev)
    z = torch.zeros((n_paths,), device=dev)
    deps = []
    for b in range(max_bounces):
        r = Ray(o=o, d=d, mint=z, maxt=torch.where(alive, float("inf"), 0.0))
        hit = scene_intersect(arr, r, sort_rays=True, **params)
        landed = alive & hit.valid
        wi_world = -d
        fr, geo_n = _flip_frame(arr, hit, wi_world)
        wi = fr.to_local(wi_world)
        deps.append((hit.p, torch.where(landed[..., None], pw, 0.0), wi_world,
                     fr.s, fr.t, fr.n, geo_n, hit.mat_id, hit.uv, landed))
        gm = mat.gather(arr.materials, arr.checkers, hit.mat_id, hit.uv)
        dims = DIM_BASE + b * DIM_STRIDE
        wo, w, _, _, _ = mat.sample(scene.active_kinds, gm, wi,
                                    smp.next_1d(dims + 3),
                                    smp.next_2d(dims + 4),
                                    smp.next_2d(dims + 6), arr.hair_tables)
        wo_world = fr.to_world(wo)
        pw2 = pw * w
        q = torch.clamp(torch.amax(w, dim=-1), 0.0, 0.95)
        keep = smp.next_1d(dims + 8) < q
        pw = pw2 / torch.clamp(q, min=1e-6)[..., None]
        alive = landed & keep & (torch.amax(pw, dim=-1) > 0)
        o = _offset(hit.p, geo_n, wo_world, cfg.ray_eps)
        d = wo_world
    return VPLSet(*[torch.stack([x[k] for x in deps]).reshape(
        (-1,) + deps[0][k].shape[1:]) for k in range(10)])


def render_vpl(scene, n_paths: int = 128, max_bounces: int = 3,
               clamp_dist: float = 0.05, spp: int | None = None,
               seed: int = 0, progress=None):
    """VPL render: the first camera hit gets direct NEE plus the summed
    VPL contributions f_x f_y G_clamped Phi_y (vpl.cpp evalContribution;
    G clamped at clamp_dist against the 1 / r^2 singularity). Lanes in
    pixel order, sample index s. progress: callable(done_spp, total_spp,
    seconds, n_shadow_queries) per wave."""
    cfg = scene.config
    arr = scene.arrays
    fl = scene.film
    cam = scene.camera
    dev = arr.device
    active_kinds = scene.active_kinds
    params = _swept_params(cfg)
    spp = spp if spp is not None else cfg.spp
    n = cfg.width * cfg.height
    vpls = trace_vpls(scene, n_paths, max_bounces, seed)
    ray_eps = cfg.ray_eps
    clamp2 = clamp_dist * clamp_dist
    zero = torch.zeros((n,), device=dev)
    pixel = torch.arange(n, device=dev)
    live_vpls = torch.nonzero(vpls.valid).flatten().tolist()

    def li(sample_id: int):
        smp = rng.Sampler(cfg.sampler, pixel, sample_id)
        px = (pixel % cfg.width).to(torch.float32)
        py = (pixel // cfg.width).to(torch.float32)
        jit2 = smp.next_2d(DIM_CAM_POS)
        pos = torch.stack([px + jit2[..., 0], py + jit2[..., 1]], -1)
        ray = sensors.sample_ray(cam, pos, None)
        hit = scene_intersect(arr, ray, **params)
        wi_world = -ray.d
        fr, geo_n = _flip_frame(arr, hit, wi_world)
        wi = fr.to_local(wi_world)
        gm = mat.gather(arr.materials, arr.checkers, hit.mat_id, hit.uv)
        li_acc = torch.where(hit.valid[..., None], 0.0,
                             _env_radiance(arr, ray.d))

        # direct NEE (the reference's luminaire VPLs)
        d_nee, dist_nee, le_nee, pdf_nee, _ = _sample_emitter_direct(
            arr, cfg, hit.p, smp.next_1d(DIM_BASE), smp.next_2d(DIM_BASE + 1))
        f_nee, _ = mat.eval_pdf(active_kinds, gm, wi, fr.to_local(d_nee),
                                arr.hair_tables)
        ok = hit.valid & (pdf_nee > 0)
        shadow = Ray(o=_offset(hit.p, geo_n, d_nee, ray_eps), d=d_nee,
                     mint=zero,
                     maxt=torch.where(ok, dist_nee - 2 * ray_eps, 0.0))
        occl = scene_occluded(arr, shadow, **params)
        li_acc = li_acc + torch.where(
            (ok & ~occl)[..., None],
            f_nee * le_nee / torch.clamp(pdf_nee, min=1e-20)[..., None], 0.0)

        # indirect: every VPL, one shadow query each (an invalid VPL adds
        # nothing in any lane and is skipped)
        li_vpl = torch.zeros((n, 3), device=dev)
        for j in live_vpls:
            delta = vpls.pos[j][None, :] - hit.p
            r2 = torch.sum(delta * delta, dim=-1)
            d_xy = delta * torch.rsqrt(torch.clamp(r2, min=1e-20))[..., None]
            f_x, _ = mat.eval_pdf(active_kinds, gm, wi, fr.to_local(d_xy),
                                  arr.hair_tables)
            # f at the VPL, in its stored frame and material
            fr_y = Frame(s=vpls.sh_s[j].expand(n, 3),
                         t=vpls.sh_t[j].expand(n, 3),
                         n=vpls.sh_n[j].expand(n, 3))
            gm_y = mat.gather(arr.materials, arr.checkers,
                              vpls.mat_id[j].expand(n),
                              vpls.uv[j].expand(n, 2))
            f_y, _ = mat.eval_pdf(active_kinds, gm_y,
                                  fr_y.to_local(vpls.wi[j].expand(n, 3)),
                                  fr_y.to_local(-d_xy), arr.hair_tables)
            # f_x and f_y hold the local cosines; what is left of the
            # geometry term is V / max(r^2, clamp^2)
            g = 1.0 / torch.clamp(r2, min=clamp2)
            okv = hit.valid & vpls.valid[j] & (r2 > 1e-12)
            dist = torch.sqrt(torch.clamp(r2, min=1e-20))
            sh = Ray(o=_offset(hit.p, geo_n, d_xy, ray_eps), d=d_xy,
                     mint=zero, maxt=torch.where(okv, dist - 2 * ray_eps,
                                                 0.0))
            occ = scene_occluded(arr, sh, **params)
            c = f_x * f_y * g[..., None] * vpls.power[j][None, :]
            li_vpl = li_vpl + torch.where((okv & ~occ)[..., None], c, 0.0)
        return li_acc + li_vpl, pos

    image, weight = film_mod.zeros(fl, dev)
    for s in range(spp):
        t0 = time.time()
        radiance, pos = li(s)
        radiance = torch.nan_to_num(radiance, nan=0.0, posinf=0.0,
                                    neginf=0.0)
        image, weight = film_mod.splat_samples(fl, pos, radiance, image,
                                               weight)
        if progress is not None:
            progress(s + 1, spp, time.time() - t0,
                     float(len(live_vpls) + 1))
    return film_mod.develop(image, weight)
