"""Irradiance caching in two passes (port of hairpt/integrators/
irrcache.py; reference src/integrators/misc/irrcache.cpp and libcore's
irrcache.cpp).

1. The cache pass: area-weighted points on the triangles (numpy's
   default_rng(seed), exactly the JAX package's points) get their
   indirect diffuse irradiance, with direct light evaluated at the
   secondary hits: either independent cosine rays, or a stratified
   (M_el, N_az) hemisphere grid with the Ward-Heckbert rotational and
   translational gradients. The grid's M_el N_az directions run as one
   query of M_el N_az M lanes (each lane keeps the salt of its cell).
2. The render pass: exact direct light (NEE), an area light's emission
   at a hit on it, the environment where the camera ray escapes, and
   albedo / pi times the indirect irradiance interpolated from every
   record with Ward weights by kernel L (ops/irrcache_interp.py).

Seeds and uint32 salts (seed * 7919 + cell, + 977, sample_id * 31 + 7,
s + seed * 65536) are the JAX package's, mod 2^32.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..core import rng, warps
from ..core.math import Ray, dot, frame_from_normal
from ..film import film as film_mod
from ..models import subsurface as sss_mod
from ..models.bsdf import registry as mat
from ..ops import irrcache_interp as L
from .aux_integrators import camera_wave
from .common import frame, scene_intersect, scene_occluded
from .path import (_emitter_radiance_at_hit, _env_radiance,
                   _sample_emitter_direct, _swept_params)


def _direct_light(scene, arr, p, sh_n, mat_id, uv, gm, fr, wi_l,
                  pixel_idx, salt):
    """One-sample NEE estimate of the direct reflected radiance (salt: an
    int or a u32 tensor per lane)."""
    cfg = scene.config
    n = p.shape[0]
    u_sel = rng.uniform_1d(pixel_idx, salt, 0)
    u2 = rng.uniform_2d(pixel_idx, salt, 1)
    d, dist, le, pdf, _ = _sample_emitter_direct(arr, cfg, p, u_sel, u2)
    f, _ = mat.eval_pdf_mix(scene.active_kinds, arr.materials, arr.checkers,
                            mat_id, uv, gm, wi_l, fr.to_local(d),
                            arr.hair_tables)
    ok = (pdf > 0) & (dot(sh_n, d) > 0)
    shadow = Ray(o=p + sh_n * cfg.ray_eps, d=d,
                 mint=torch.zeros((n,), device=p.device),
                 maxt=torch.where(ok, dist - 2 * cfg.ray_eps, 0.0))
    occ = scene_occluded(arr, shadow, **_swept_params(cfg))
    return torch.where((ok & ~occ)[..., None],
                       le * f / torch.clamp(pdf, min=1e-20)[..., None], 0.0)


def build_irradiance_cache(scene, n_points: int = 4096, m_rays: int = 16,
                           seed: int = 0, grid=None,
                           gradients: bool = False):
    """The cache pass: (pos [M, 3], nrm [M, 3], e_ind [M, 3]) and, with
    gradients, (r_grad, t_grad [M, 3, 3]) as well. A scene without
    triangles has no points and is refused."""
    arr = scene.arrays
    if arr.tri is None:
        raise ValueError("the irradiance cache places its points on the "
                         "scene's triangles, and this scene has none")
    tri = [x.cpu().numpy() for x in (arr.tri.p0, arr.tri.e1, arr.tri.e2)]
    pos, nrm, _ = sss_mod.sample_surface_points(tri, n_points, seed)
    pos = torch.as_tensor(pos, device=arr.device)
    nrm = torch.as_tensor(nrm, device=arr.device)
    return (pos, nrm) + estimate_irradiance(scene, pos, nrm, m_rays=m_rays,
                                            seed=seed, grid=grid,
                                            gradients=gradients)


def _secondary(scene, arr, o, d, idx, salt):
    """(radiance without emission, hit distance) of the rays o, d: direct
    light at their hits (the reference's ERadianceNoEmission), 0 and inf
    where they escape."""
    n = o.shape[0]
    r = Ray(o=o, d=d, mint=torch.zeros((n,), device=o.device),
            maxt=torch.full((n,), float("inf"), device=o.device))
    hit = scene_intersect(arr, r, **_swept_params(scene.config))
    fr2 = frame(hit)
    gm2 = mat.gather(arr.materials, arr.checkers, hit.mat_id, hit.uv)
    ld = _direct_light(scene, arr, hit.p, hit.sh_n, hit.mat_id, hit.uv, gm2,
                       fr2, fr2.to_local(-d), idx, salt)
    return torch.where(hit.valid[..., None], ld, 0.0), \
        torch.where(hit.valid, hit.t, float("inf"))


def estimate_irradiance(scene, pos, nrm, m_rays: int = 16, seed: int = 0,
                        grid=None, gradients: bool = False):
    """The indirect irradiance at the points: (e_ind,) from m_rays
    independent cosine rays each (grid None), or (e_ind, r_grad, t_grad)
    from the stratified (M_el, N_az) grid (cell centres cos theta_j =
    sqrt(1 - (j + 1/2) / M_el), phi_k = 2 pi (k + 1/2) / N_az) with the
    Ward-Heckbert gradients [world axis, colour] of
    HemisphereSampler::process (src/librender/irrcache.cpp:60-145);
    gradients without a grid take (8, 16)."""
    cfg = scene.config
    arr = scene.arrays
    dev = pos.device
    m = int(pos.shape[0])
    idx = torch.arange(m, device=dev)
    fr = frame_from_normal(nrm)
    o = pos + nrm * cfg.ray_eps
    if gradients and grid is None:
        grid = (8, 16)

    if grid is None:
        # independent cosine rays, all m_rays in one query; E = pi mean(L)
        salt = torch.arange(m_rays, device=dev) + seed * 7919
        salt = (salt & rng.M32)[:, None].expand(m_rays, m)
        u2 = rng.uniform_2d(idx[None].expand(m_rays, m), salt, 11)
        d = fr.to_world(warps.square_to_cosine_hemisphere(u2))
        lr, _ = _secondary(scene, arr, o.repeat(m_rays, 1),
                           d.reshape(-1, 3), idx.repeat(m_rays),
                           (salt.reshape(-1) + 977) & rng.M32)
        lr = lr.reshape(m_rays, m, 3)
        e = torch.zeros((m, 3), device=dev)
        for s in range(m_rays):
            e = e + lr[s]
        return (math.pi * e / m_rays,)

    M_el, N_az = grid
    d_l = []
    for j in range(M_el):
        cos_t = np.sqrt(1.0 - (j + 0.5) / M_el)
        sin_t = np.sqrt((j + 0.5) / M_el)
        for k in range(N_az):
            phi = 2.0 * np.pi * (k + 0.5) / N_az
            d_l.append([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t])
    d_l = torch.tensor(np.asarray(d_l, np.float32), device=dev)
    G = M_el * N_az
    d = fr.to_world(d_l[:, None, :].expand(G, m, 3))
    cell = torch.arange(G, device=dev)
    salt = ((cell + seed * 7919 + 977) & rng.M32)[:, None].expand(G, m)
    lr, dist = _secondary(scene, arr, o.repeat(G, 1), d.reshape(-1, 3),
                          idx.repeat(G), salt.reshape(-1))
    L_all = lr.reshape(M_el, N_az, m, 3)
    d_all = dist.reshape(M_el, N_az, m)

    # E = pi / (M N) sum L (cosine-weighted stratification)
    e_ind = math.pi * torch.mean(L_all, dim=(0, 1))

    ks = np.arange(N_az)
    phi_c = 2.0 * np.pi * (ks + 0.5) / N_az
    vk_ang = phi_c - np.pi / 2.0
    vkm_ang = (2.0 * np.pi * ks) / N_az + np.pi / 2.0
    js = np.arange(M_el)
    cos_tm = np.sqrt(1.0 - js / M_el)
    sin_tm = np.sqrt(js / M_el)
    cos_tc = np.sqrt(1.0 - (js + 0.5) / M_el)
    sin_tc = np.sqrt((js + 0.5) / M_el)
    cos_tp = np.sqrt(1.0 - (js + 1.0) / M_el)
    tan_tc = sin_tc / cos_tc

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)

    def to_world(ang):
        # local (cos a, sin a, 0) through each point's frame: [N_az, m, 3]
        lv = f32(np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)],
                          -1))
        return lv[:, None, 0, None] * fr.s[None] \
            + lv[:, None, 1, None] * fr.t[None]

    vk_w = to_world(vk_ang)
    vkm_w = to_world(vkm_ang)
    uk_w = to_world(phi_c)
    scale = math.pi / (M_el * N_az)
    # rotational: pi / (M N) sum_jk (-tan theta_j) v_k L_jk
    coef_r = -f32(tan_tc)[:, None, None, None] * vk_w[None]
    r_grad = scale * torch.einsum("jkma,jkmc->mac", coef_r, L_all)
    # translational, u_k: the walls j = 2 .. M_el - 1 only (the
    # reference's `if (j > 1)`, irrcache.cpp:104-115)
    dmin_u = torch.minimum(d_all[2:], d_all[1:-1])
    ok_u = torch.isfinite(dmin_u) & (dmin_u > 0)
    fac_u = (2.0 * np.pi / N_az) \
        * f32(cos_tm[2:] * cos_tm[2:] * sin_tm[2:])[:, None, None] \
        / torch.where(ok_u, dmin_u, 1.0)
    diff_u = L_all[2:] - L_all[1:-1]
    t_grad = torch.einsum("jkm,jkma,jkmc->mac",
                          torch.where(ok_u, fac_u, 0.0),
                          uk_w[None].expand((M_el - 2,) + uk_w.shape),
                          diff_u)
    # translational, v_k: the wall between (j, k - 1) and (j, k)
    d_prev = torch.roll(d_all, 1, dims=1)
    L_prev = torch.roll(L_all, 1, dims=1)
    dmin_v = torch.minimum(d_all, d_prev)
    ok_v = torch.isfinite(dmin_v) & (dmin_v > 0)
    fac_v = f32(cos_tc)[:, None, None] * f32(cos_tm - cos_tp)[:, None, None] \
        / (torch.where(ok_v, dmin_v, 1.0) * f32(sin_tc)[:, None, None])
    t_grad = t_grad + torch.einsum(
        "jkm,jkma,jkmc->mac", torch.where(ok_v, fac_v, 0.0),
        vkm_w[None].expand((M_el,) + vkm_w.shape), L_all - L_prev)
    return e_ind, r_grad, t_grad


def render_irrcache(scene, n_points: int = 4096, m_rays: int = 16,
                    spp: int = 4, k_norm_radius: float = 0.25,
                    seed: int = 0, gradients: bool = True, grid=None,
                    kappa: float = 2.0, cache=None, progress=None):
    """The render pass: direct NEE + emission + albedo / pi x kernel L's
    interpolated indirect irradiance; the environment where the camera
    ray escapes. gradients (the reference's useGradients default)
    extrapolates each record along its gradients, E' = E + (n_i x n) .
    rGrad + (x - x_i) . tGrad (irrcache.cpp:196-207). cache: a cache
    tuple to use instead of building one (its gradients decide).
    progress: callable(done, spp, seconds, lanes) per wave."""
    cfg = scene.config
    arr = scene.arrays
    fl = scene.film
    if cache is None:
        if gradients:
            cache = build_irradiance_cache(scene, n_points, m_rays, seed,
                                           grid=grid or (8, 16),
                                           gradients=True)
        else:
            cache = build_irradiance_cache(scene, n_points, m_rays, seed)
    rec = L.Records(*cache)
    image, weight = film_mod.zeros(fl, arr.device)
    for s in range(spp):
        t0 = time.time()
        sample_id = (s + seed * 65536) & rng.M32
        pixel, _, p2, ray, hit = camera_wave(scene, arr, sample_id)
        fr = frame(hit)
        gm = mat.gather(arr.materials, arr.checkers, hit.mat_id, hit.uv)
        ld = _direct_light(scene, arr, hit.p, hit.sh_n, hit.mat_id, hit.uv,
                           gm, fr, fr.to_local(-ray.d), pixel,
                           (sample_id * 31 + 7) & rng.M32)
        le = _emitter_radiance_at_hit(arr, hit, -ray.d)
        e_interp, _ = L.interp(hit.p, hit.sh_n, hit.valid, rec,
                               k_norm_radius, kappa)
        l_ind = gm.diffuse / math.pi * e_interp
        rad = torch.where(hit.valid[..., None], ld + le + l_ind,
                          _env_radiance(arr, ray.d))
        rad = torch.nan_to_num(rad, nan=0.0, posinf=0.0, neginf=0.0)
        image, weight = film_mod.splat_samples(fl, p2, rad, image, weight)
        if progress is not None:
            progress(s + 1, spp, time.time() - t0, float(pixel.shape[0]))
    return film_mod.develop(image, weight)
