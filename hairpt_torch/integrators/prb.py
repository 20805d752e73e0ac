"""Path-replay backpropagation (port of hairpt/integrators/prb.py):
the detached-sampling gradient of the differentiable mode of
path.make_li_fn with O(1) memory in depth (Vicini et al. 2021).

  1. primal pass: the forward estimator (Russian roulette, staged widths)
     gives each lane's radiance L and the loss adjoint delta = dloss/dL.
  2. replay at full width: the same paths again (the same sample
     dimensions, so the same sampling and RR decisions). At bounce k keep
       T_k  the throughput prefix,
       S_k  the suffix radiance in prefix-stripped units, S_1 = L, peeled
            by S_{k+1} = (S_k - e_k - c_k) / w_k,
     and add  vjp_theta[c_k](delta T_k) + vjp_theta[w_k](delta T_k S_{k+1})
     where c_k is the NEE contribution and w_k the bounce weight, the only
     theta-dependent terms of the estimator. Each bounce's autograd graph
     is built, differentiated and freed before the next bounce.

theta is the float fields of the material table and the Marschner
azimuthal tables (HairTables): sigma_a / beta_r gradients then flow
through precompute_azimuthal outside this loop (inverse.py). The replay
shades as the primal pass does: normal and bump maps, the bitmaps' level
of detail in every bounce and the camera hit's EWA. Lanes with
|w_k| < 1e-6 in a channel zero that channel's suffix. Shadow-ray RR is
not replayed: the scene must have nee_rr == 0.
"""
from __future__ import annotations

import torch

from ..core import rng
from ..core.math import Ray, dot
from ..models import emitters as em
from ..models import sensors
from ..models.bsdf import registry as mat
from . import path as path_int
from .common import frame, scene_intersect, scene_occluded
from .path import (DIM_BASE, DIM_CAM_POS, DIM_STRIDE, D_BSDF_LOBE,
                   D_BSDF_U2, D_BSDF_U2B, D_NEE_POS, D_NEE_SEL, D_RR,
                   _mi_weight, _pdf_emitter_hit, _sample_emitter_direct,
                   _swept_params, aperture_sample, camera_footprint,
                   has_bitmaps, texture_lod)


def _check_supported(scene):
    arr = scene.arrays
    if arr.sss is not None or mat.DIPOLE in scene.active_kinds:
        raise ValueError("PRB: dipole subsurface is not replayed (the "
                         "differentiable mode takes its branch)")
    if arr.media is not None:
        raise ValueError("PRB: media are not replayed")
    if scene.config.nee_rr != 0.0:
        raise ValueError("PRB: shadow-ray RR is not replayed (build the "
                         "scene with nee_rr=0 for gradients)")


def float_theta(arrays) -> dict:
    """The differentiable theta: the float fields of the material table,
    keyed ("materials", field), beside the hair tables' arrays, keyed
    ("hair_tables", field)."""
    theta = {}
    for group in ("materials", "hair_tables"):
        table = getattr(arrays, group)
        for f in (table._fields if table is not None else ()):
            v = getattr(table, f)
            if torch.is_tensor(v) and v.is_floating_point():
                theta[(group, f)] = v
    return theta


def with_theta(arrays, theta: dict):
    """The arrays with theta's tensors in place of their fields."""
    for group in ("materials", "hair_tables"):
        fields = {f: v for (g, f), v in theta.items() if g == group}
        if fields:
            arrays = arrays._replace(
                **{group: getattr(arrays, group)._replace(**fields)})
    return arrays


def _zero_nonfinite(x):
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def make_prb_grad_fn(scene, loss_fn=None):
    """Returns grad(arr, pixel_idx, sample_idx, *loss_args)
        -> ((loss, L [N, 3]), d_theta)

    loss_fn(L, pos, *loss_args) -> scalar defines the objective over the
    per-lane radiance (default: the mean). d_theta holds the gradient of
    the loss with respect to each tensor of float_theta(arr) that
    requires grad (all of them when none does), under its key. Only
    those are traced: a field left out costs nothing, where ext_trans,
    say, would add a [N, 64] gradient and its scatter to every
    evaluation."""
    _check_supported(scene)
    cfg = scene.config
    active_kinds = scene.active_kinds
    ray_eps = cfg.ray_eps
    params = _swept_params(cfg)
    li_fn = path_int.make_li_fn(scene)
    bitmaps = has_bitmaps(scene.arrays)

    def grad(arr, pixel_idx, sample_idx, *loss_args):
        theta = float_theta(arr)
        names = [k for k, v in theta.items() if v.requires_grad] \
            or list(theta)
        theta0 = {k: v.detach() for k, v in theta.items()}
        arr = with_theta(arr, theta0)
        n = pixel_idx.shape[0]
        dev = pixel_idx.device

        # ---- pass 1: primal (the forward estimator, full RR) ----
        with torch.no_grad():
            L, pos0, _ = li_fn(arr, pixel_idx, sample_idx)
        if loss_fn is None:
            loss_val = L.mean()
            adjoint = torch.full_like(L, 1.0 / L.numel())
        else:
            with torch.enable_grad():
                L_in = L.detach().requires_grad_()
                loss_val = loss_fn(L_in, pos0, *loss_args)
                (adjoint,) = torch.autograd.grad(loss_val, L_in)
            loss_val = loss_val.detach()

        # ---- pass 2: replay ----
        smp = rng.Sampler(cfg.sampler, pixel_idx, sample_idx)
        jitter = smp.next_2d(DIM_CAM_POS)
        px = (smp.pixel % cfg.width).to(torch.float32)
        py = (smp.pixel // cfg.width).to(torch.float32)
        pos = torch.stack([px + jitter[..., 0], py + jitter[..., 1]], -1)
        ap = aperture_sample(scene.camera, smp)
        ray = sensors.sample_ray(scene.camera, pos, ap)
        hit = scene_intersect(arr, ray, **params)
        duv_dx, duv_dy, ewa = camera_footprint(arr, scene.camera, pos, ray,
                                               hit, bitmaps, ap)

        leaves = [theta0[k].clone().requires_grad_() for k in names]
        arr_g = with_theta(arr, dict(zip(names, leaves)))
        mats_g, ht_g = arr_g.materials, arr_g.hair_tables
        grads = [torch.zeros_like(v) for v in leaves]

        active = torch.ones((n,), dtype=torch.bool, device=dev)
        ray_d = ray.d
        T = torch.ones((n, 3), device=dev)
        S = L
        eta = torch.ones((n,), device=dev)
        prev_bsdf_pdf = torch.zeros((n,), device=dev)
        prev_delta = torch.zeros((n,), dtype=torch.bool, device=dev)
        emission_allowed = torch.ones((n,), dtype=torch.bool, device=dev)
        depth = 1
        while depth < cfg.max_depth and bool(active.any()):
            dims = DIM_BASE + (depth - 1) * DIM_STRIDE
            d_in = ray_d

            # ---- loop-top emission e_k (theta-independent) ----
            e = torch.zeros((n, 3), device=dev)
            miss = active & ~hit.valid
            if arr.env is not None:
                le_env = em.env_eval(arr.env, d_in)
                lum_pdf = _pdf_emitter_hit(arr, cfg, hit, d_in)
                w = torch.where(prev_delta | emission_allowed, 1.0,
                                _mi_weight(prev_bsdf_pdf, lum_pdf))
                e = e + torch.where(miss[..., None], le_env * w[..., None],
                                    0.0)
            was_active = active
            active = active & hit.valid
            wi_world = -d_in
            if arr.area is not None:
                le = path_int._emitter_radiance_at_hit(arr, hit, wi_world)
                lum_pdf = _pdf_emitter_hit(arr, cfg, hit, d_in)
                w = torch.where(prev_delta | emission_allowed, 1.0,
                                _mi_weight(prev_bsdf_pdf, lum_pdf))
                e = e + torch.where(active[..., None], le * w[..., None],
                                    0.0)

            # ---- shading frame (normal / bump maps, twosided flip) ----
            if scene.has_normal_maps:
                p_n, p_s, p_t = mat.perturb_shading_frame(
                    arr.materials, arr.checkers, hit.mat_id, hit.uv,
                    hit.sh_n, hit.sh_s, hit.sh_t)
                hit = hit._replace(sh_n=p_n, sh_s=p_s, sh_t=p_t)
            two = arr.materials.twosided[torch.clamp(hit.mat_id,
                                                     min=0).long()]
            flip = (two & (dot(hit.sh_n, wi_world) < 0))[..., None]
            sh_n = torch.where(flip, -hit.sh_n, hit.sh_n)
            sh_t = torch.where(flip, -hit.sh_t, hit.sh_t)
            geo_n = torch.where(flip, -hit.geo_n, hit.geo_n)
            fr = frame(hit)._replace(n=sh_n, t=sh_t)
            wi = fr.to_local(wi_world)
            if cfg.strict_normals:
                active = active & ~(dot(d_in, geo_n) * wi[..., 2] >= 0)

            u_sel = smp.next_1d(dims + D_NEE_SEL)
            u_nee = smp.next_2d(dims + D_NEE_POS)
            # a stopped lane's point (at infinity on a miss) is parked at the
            # origin: its NEE direction stays finite, so the zero gradient its
            # masked contribution gets is not 0 * NaN
            p_nee = torch.where(active[..., None], hit.p, 0.0)
            d_nee, dist_nee, le_nee, pdf_nee, is_dl = \
                _sample_emitter_direct(arr, cfg, p_nee, u_sel, u_nee)
            wo_nee = fr.to_local(d_nee)
            u_lobe = smp.next_1d(dims + D_BSDF_LOBE)
            u2 = smp.next_2d(dims + D_BSDF_U2)
            u2b = smp.next_2d(dims + D_BSDF_U2B)

            # ---- theta-dependent locals: NEE contribution, bounce weight
            with torch.enable_grad():
                gm = mat.gather(
                    mats_g, arr.checkers, hit.mat_id, hit.uv,
                    texture_lod(arr, scene.camera, cfg.width, hit, bitmaps),
                    hit.bary, hit.vcolor,
                    (duv_dx, duv_dy) if depth == 1 and ewa else None)
                f_nee, bsdf_pdf_nee = mat.eval_pdf_mix(
                    active_kinds, mats_g, arr.checkers, hit.mat_id, hit.uv,
                    gm, wi, wo_nee, ht_g)
                w_nee = torch.where(is_dl, 1.0,
                                    _mi_weight(pdf_nee, bsdf_pdf_nee))
                c = le_nee * f_nee \
                    * (w_nee / torch.clamp(pdf_nee, min=1e-20))[..., None]
                wo, wt_s, bsdf_pdf, is_delta, eta_s = mat.sample_mix(
                    active_kinds, mats_g, arr.checkers, hit.mat_id, hit.uv,
                    gm, wi, u_lobe, u2, u2b, ht_g)
                wo = wo.detach()
                f2, p2 = mat.eval_pdf_mix(active_kinds, mats_g,
                                          arr.checkers, hit.mat_id, hit.uv,
                                          gm, wi, wo, ht_g)
                w_s = torch.where(is_delta[..., None], wt_s,
                                  f2 / torch.clamp(p2.detach(),
                                                   min=1e-9)[..., None])
            c_val, w_val = c.detach(), w_s.detach()
            bsdf_pdf, eta_s = bsdf_pdf.detach(), eta_s.detach()

            # ---- NEE visibility (geometry, detached) ----
            nee_ok = active & (pdf_nee > 0) \
                & (torch.amax(torch.abs(f_nee.detach()), dim=-1) > 0)
            if cfg.strict_normals:
                nee_ok = nee_ok & (dot(geo_n, d_nee) * wo_nee[..., 2] > 0)
            shadow_o = hit.p + geo_n * torch.where(
                dot(d_nee, geo_n) > 0, ray_eps, -ray_eps)[..., None]
            shadow = Ray(o=shadow_o, d=d_nee,
                         mint=torch.zeros((n,), device=dev),
                         maxt=torch.where(nee_ok, dist_nee - 2.0 * ray_eps,
                                          0.0))
            occluded = scene_occluded(arr, shadow, sort_rays=True,
                                      compact=False, **params)
            vis = (nee_ok & ~occluded)[..., None]
            c_vis = torch.where(vis, c_val, 0.0)

            # ---- masks mirroring the forward body ----
            wo_world = fr.to_world(wo)
            active_next = active \
                & ~(torch.amax(torch.abs(w_val), dim=-1) <= 0)
            if cfg.strict_normals:
                active_next = active_next \
                    & ~(dot(geo_n, wo_world) * wo[..., 2] <= 0)

            # ---- RR (the primal pass's decisions; factor detached) ----
            w_rr = torch.where(active[..., None], w_val, 0.0)
            T_bsdf = T * w_rr
            eta = eta * eta_s
            q = torch.clamp(torch.amax(T_bsdf, dim=-1) * eta * eta, max=0.95)
            do_rr = depth + 1 > cfg.rr_depth
            kill = do_rr & (smp.next_1d(dims + D_RR) >= q)
            rr_fac = torch.where(do_rr & ~kill,
                                 1.0 / torch.clamp(q, min=1e-6), 1.0)
            active_next = active_next & ~kill
            w_total = torch.where(active_next[..., None],
                                  w_rr * rr_fac[..., None], 0.0)

            # ---- suffix peel: S_{k+1} = (S - e - c) / w ----
            e_m = torch.where(was_active[..., None], e, 0.0)
            num = S - e_m - torch.where(active[..., None], c_vis, 0.0)
            big = torch.abs(w_total) > 1e-6
            S_next = torch.where(big, num / torch.where(big, w_total, 1.0),
                                 0.0)
            S_next = torch.where(active_next[..., None], S_next, 0.0)

            # ---- accumulate this bounce's gradient, free its graph ----
            cot_c = _zero_nonfinite(torch.where(vis & active[..., None],
                                                adjoint * T, 0.0))
            cot_w = _zero_nonfinite(torch.where(
                active_next[..., None], adjoint * T * S_next
                * rr_fac[..., None], 0.0))
            d_theta = torch.autograd.grad((c, w_s), leaves,
                                          grad_outputs=(cot_c, cot_w),
                                          allow_unused=True)
            for g, d in zip(grads, d_theta):
                if d is not None:
                    g += _zero_nonfinite(d)
            del c, w_s, gm, f_nee, f2, wt_s

            # ---- next ray ----
            next_o = hit.p + geo_n * torch.where(
                dot(wo_world, geo_n) > 0, ray_eps, -ray_eps)[..., None]
            next_ray = Ray(o=next_o, d=wo_world,
                           mint=torch.zeros((n,), device=dev),
                           maxt=torch.where(active_next, float("inf"), 0.0))
            hit = scene_intersect(arr, next_ray, sort_rays=True,
                                  compact=False, **params)
            active = active_next
            ray_d = wo_world
            T = T_bsdf * rr_fac[..., None]
            S = S_next
            prev_bsdf_pdf = bsdf_pdf
            prev_delta = is_delta
            emission_allowed = torch.zeros_like(active)
            depth += 1
        return (loss_val, L), dict(zip(names, grads))

    return grad
