"""Volumetric path tracing (port of hairpt/integrators/volpath.py;
reference src/integrators/path/volpath*.cpp).

make_volpath_li: a global homogeneous fog (media.Medium: spectral-MIS
free flights, the fog's depth along rays to the environment) or a grid
volume (media.HeteroMedium: delta tracking for the free flight and ratio
tracking on shadow rays, kernel J on the card); phase-function
scattering at medium events with every phase kind, NEE with the medium's
transmittance at medium and surface events, MIS against the environment
and the area lights. make_volpath_bounded_li: shape-bounded homogeneous
media (the scene's MediumTable, row 0 vacuum), each lane carrying its
medium id across refractive and null boundaries, shadow rays marched
through up to three null boundaries. The shading calls are the JAX
package's (gather with uv only, eval_pdf and sample).

The queries are the port's (integrators/common.py): kernels A and B on
the hair, F on the triangles. The bounce loop reads one count per
bounce (the live lanes: the loop's exit and the staged widths) and none
inside the Woodcock walks. Sample dimensions, constants and depth
semantics are the JAX package's. Two things differ in how the wave is
run, not in any live lane's numbers (each lane's random numbers are its
own, and the queries answer each ray on its own): lanes that are no
longer live enter the Woodcock walks parked (at the origin, along +z,
with no distance to cover), and the loop runs at path.render's staged
widths (path.stage_caps: n, n/4, n/16, the live lanes first).
"""
from __future__ import annotations

import time

import torch

from ..core import rng
from ..core.math import Ray, dot
from ..film import film as film_mod
from ..models import media as med
from ..models import sensors
from ..models.bsdf import registry as mat
from .common import frame, scene_intersect, scene_occluded
from .path import (DIM_BASE, DIM_CAM_POS, DIM_STRIDE, _env_radiance,
                   _mi_weight, _pdf_emitter_hit, _sample_emitter_direct,
                   _swept_params, stage_caps)

_SELF_INVERTING = (med.HG, med.ISOTROPIC, med.RAYLEIGH)


def _park(live, o, d, dist):
    """Woodcock inputs of lanes that are not live: at the origin, along
    +z, with no distance, so their walks end at once."""
    z = torch.zeros_like(o)
    zd = z.clone()
    zd[:, 2] = 1.0
    return (torch.where(live[..., None], o, z),
            torch.where(live[..., None], d, zd),
            torch.where(live, dist, 0.0))


def _camera(cfg, cam, smp, n):
    px = (smp.pixel % cfg.width).to(torch.float32)
    py = (smp.pixel // cfg.width).to(torch.float32)
    jit2 = smp.next_2d(DIM_CAM_POS)
    pos = torch.stack([px + jit2[..., 0], py + jit2[..., 1]], -1)
    return pos, sensors.sample_ray(cam, pos, None)


def _surface(arr, hit, d, d_nee):
    """The shading frame (twosided flip), wi, wo_nee, the flipped
    geometric normal and the gathered material of each hit."""
    wi_world = -d
    two = arr.materials.twosided[torch.clamp(hit.mat_id, min=0).long()]
    flip = (two & (dot(hit.sh_n, wi_world) < 0))[..., None]
    sh_n = torch.where(flip, -hit.sh_n, hit.sh_n)
    sh_t = torch.where(flip, -hit.sh_t, hit.sh_t)
    fr = frame(hit)._replace(n=sh_n, t=sh_t)
    geo_n = torch.where(flip, -hit.geo_n, hit.geo_n)
    gm = mat.gather(arr.materials, arr.checkers, hit.mat_id, hit.uv)
    return fr, fr.to_local(wi_world), fr.to_local(d_nee), geo_n, gm


def _offset(p, geo_n, w, eps):
    return p + geo_n * torch.where(dot(w, geo_n) > 0, eps, -eps)[..., None]


class _Wave:
    """The traced part of a wave: its state tensors (first axis the
    lanes), its sampler, and each lane's index in the full wave.
    narrow(width) keeps `width` lanes, the live ones first, writing the
    others' radiance out first."""

    def __init__(self, state: dict, smp, n: int):
        self.s = state
        self.smp = smp
        self.lane = torch.arange(n, device=smp.pixel.device)
        self.out = torch.zeros((n, 3), device=smp.pixel.device)

    def narrow(self, width: int):
        self.out[self.lane] = self.s["li"]
        keep = torch.argsort(torch.where(self.s["active"], 0, 1),
                             stable=True)[:width]
        self.s = {k: v[keep] for k, v in self.s.items()}
        self.smp = self.smp.take(keep)
        self.lane = self.lane[keep]

    def result(self):
        self.out[self.lane] = self.s["li"]
        return self.out


def make_volpath_li(scene, medium):
    """li(arr, pixel_idx, sample_idx) -> (radiance [N, 3], pos [N, 2],
    n_rays) in a global medium: a media.Medium (homogeneous fog) or a
    media.HeteroMedium (a grid volume, Woodcock tracking)."""
    cfg = scene.config
    cam = scene.camera
    active_kinds = scene.active_kinds
    ray_eps = cfg.ray_eps
    params = _swept_params(cfg)
    pk = medium.phase_kind
    hetero = isinstance(medium, med.HeteroMedium)
    ph_p = getattr(medium, "phase_p", None)
    ph_ori = getattr(medium, "orientation", None)
    ph_mix = getattr(medium, "mix", ())

    def bounce(arr, w: _Wave, depth: int):
        s, smp = w.s, w.smp
        active, o, d, throughput = s["active"], s["o"], s["d"], s["tp"]
        n = active.shape[0]
        dev = active.device
        dims = DIM_BASE + (depth - 1) * DIM_STRIDE
        zero_n = torch.zeros((n,), device=dev)
        r = Ray(o=o, d=d, mint=zero_n,
                maxt=torch.where(active, float("inf"), 0.0))
        hit = scene_intersect(arr, r, **params)
        if hetero:
            t_surf = torch.where(hit.valid, hit.t, 1e30)
            dist, is_med = med.woodcock_sample(
                medium, *_park(active, o, d, t_surf), smp.pixel, smp.sample,
                dims + 9)
            # delta tracking is analog: a medium event weighs the albedo
            w_flight = torch.where(is_med[..., None], medium.albedo[None, :],
                                   1.0)
        else:
            t_surf = torch.where(hit.valid, hit.t, medium.fog_depth)
            dist, is_med, w_flight = med.sample_distance(
                medium, smp.next_1d(dims + 9), smp.next_1d(dims + 10),
                t_surf)
        throughput = throughput * torch.where(active[..., None], w_flight,
                                              1.0)
        # the environment, reached past the medium; MIS against the
        # previous event's NEE
        miss = active & ~hit.valid & ~is_med
        lum_pdf = _pdf_emitter_hit(arr, cfg, hit, d)
        w_esc = torch.where(s["first"] | s["prev_delta"], 1.0,
                            _mi_weight(s["prev_pdf"], lum_pdf))
        li_acc = s["li"] + torch.where(
            miss[..., None],
            throughput * _env_radiance(arr, d) * w_esc[..., None], 0.0)
        active2 = active & (hit.valid | is_med)
        p_evt = o + d * dist[..., None]

        # ---- NEE from the event ----
        d_nee, dist_nee, le_nee, pdf_nee, is_dl = _sample_emitter_direct(
            arr, cfg, p_evt, smp.next_1d(dims + 0), smp.next_2d(dims + 1))
        ph = med.phase_eval(pk, medium.g, -d, d_nee, ph_p, ph_ori, ph_mix)
        fr, wi, wo_nee, geo_n, gm = _surface(arr, hit, d, d_nee)
        f_s, pdf_bs = mat.eval_pdf(active_kinds, gm, wi, wo_nee,
                                   arr.hair_tables)
        scat = torch.where(is_med[..., None], ph[..., None], f_s)
        off = torch.where(is_med[..., None], 0.0, geo_n * torch.where(
            dot(d_nee, geo_n) > 0, ray_eps, -ray_eps)[..., None])
        ok = active2 & (pdf_nee > 0)
        shadow = Ray(o=p_evt + off, d=d_nee, mint=zero_n,
                     maxt=torch.where(ok, dist_nee - 2 * ray_eps, 0.0))
        occl = scene_occluded(arr, shadow, **params)
        if hetero:
            tr_shadow = med.woodcock_transmittance(
                medium, *_park(ok, p_evt + off, d_nee,
                               torch.clamp(dist_nee, max=1e6)),
                smp.pixel, smp.sample, dims + 11)
        else:
            tr_shadow = med.transmittance(
                medium, torch.minimum(dist_nee, medium.fog_depth))
        ph_pdf_nee = med.phase_pdf(pk, medium.g, -d, d_nee, ph_p, ph_ori,
                                   ph_mix)
        w_mis = torch.where(is_dl, 1.0, _mi_weight(
            pdf_nee, torch.where(is_med, ph_pdf_nee, pdf_bs)))
        li_acc = li_acc + torch.where(
            (ok & ~occl)[..., None],
            throughput * le_nee * scat * tr_shadow
            * (w_mis / torch.clamp(pdf_nee, min=1e-20))[..., None], 0.0)

        # ---- continue the path ----
        u_ph = smp.next_2d(dims + 4)
        u_lobe = smp.next_1d(dims + 3)
        u2b = smp.next_2d(dims + 6)
        wo_med, pdf_ph = med.phase_sample(pk, medium.g, -d, u_ph, ph_p,
                                          ph_ori, ph_mix)
        wo_l, w_bsdf, pdf_b, is_delta, _ = mat.sample(
            active_kinds, gm, wi, u_lobe, u_ph, u2b, arr.hair_tables)
        wo_surf = fr.to_world(wo_l)
        d_next = torch.where(is_med[..., None], wo_med, wo_surf)
        if pk in _SELF_INVERTING:
            # eval / pdf is exactly 1 where the sampler inverts eval
            w_med3 = torch.ones((n, 3), device=dev)
        else:
            w_ph = torch.where(
                pdf_ph > 0,
                med.phase_eval(pk, medium.g, -d, wo_med, ph_p, ph_ori,
                               ph_mix) / torch.clamp(pdf_ph, min=1e-20),
                0.0)
            w_med3 = w_ph[..., None] * torch.ones((1, 3), device=dev)
        throughput = throughput * torch.where(is_med[..., None], w_med3,
                                              w_bsdf)
        active2 = active2 & ~(torch.amax(torch.abs(throughput), dim=-1) <= 0)
        o_next = torch.where(is_med[..., None], p_evt,
                             _offset(hit.p, geo_n, wo_surf, ray_eps))
        # Russian roulette
        if depth + 1 > cfg.rr_depth:
            q = torch.clamp(torch.amax(throughput, dim=-1), max=0.95)
            kill = smp.next_1d(dims + 8) >= q
            throughput = torch.where(
                (~kill)[..., None],
                throughput / torch.clamp(q, min=1e-6)[..., None], throughput)
            active2 = active2 & ~kill
        w.s = dict(active=active2, o=o_next, d=d_next, tp=throughput,
                   li=li_acc, first=torch.zeros_like(active2),
                   prev_pdf=torch.where(is_med, pdf_ph, pdf_b),
                   prev_delta=torch.where(is_med, False, is_delta))
        return ok.sum() + active2.sum()

    return _make_li(cfg, cam, bounce, {})


def _make_li(cfg, cam, bounce, extra):
    """The wave loop around a bounce function: the camera ray, then
    bounces while a lane is live and depth < max_depth, at path.render's
    staged widths (one count read per bounce)."""

    def li(arr, pixel_idx, sample_idx):
        smp = rng.Sampler(cfg.sampler, pixel_idx, sample_idx)
        n = pixel_idx.shape[0]
        dev = pixel_idx.device
        pos, ray = _camera(cfg, cam, smp, n)
        state = dict(active=torch.ones((n,), dtype=torch.bool, device=dev),
                     o=ray.o, d=ray.d, tp=torch.ones((n, 3), device=dev),
                     li=torch.zeros((n, 3), device=dev),
                     first=torch.ones((n,), dtype=torch.bool, device=dev),
                     prev_pdf=torch.zeros((n,), device=dev),
                     prev_delta=torch.zeros((n,), dtype=torch.bool,
                                            device=dev))
        state.update({k: f(n, dev) for k, f in extra.items()})
        w = _Wave(state, smp, n)
        caps = stage_caps(n)[1:]
        n_rays = torch.tensor(float(n), device=dev)
        depth = 1
        while depth < cfg.max_depth:
            n_live = int(w.s["active"].sum())
            if n_live == 0:
                break
            width = None
            while caps and n_live <= caps[0]:
                width = caps.pop(0)
            if width is not None:
                w.narrow(width)
            n_rays = n_rays + bounce(arr, w, depth)
            depth += 1
        return w.result(), pos, n_rays

    return li


def _march_transmittance(arr, cfg, p0, d_nee, max_dist, start_med, ok,
                         k_max: int = 3):
    """Shadow-ray transmittance through shape-bounded media: up to k_max
    boundary crossings, each segment attenuated by its medium's sigma_t,
    passing only through null-BSDF boundaries (any other surface
    occludes). Returns (tr [N, 3], occluded [N])."""
    n = p0.shape[0]
    dev = p0.device
    params = _swept_params(cfg)
    ntri = arr.tri_med.shape[0]
    tr = torch.ones((n, 3), device=dev)
    occluded = torch.zeros((n,), dtype=torch.bool, device=dev)
    done = ~ok
    cur = start_med
    p = p0
    remaining = max_dist
    for _ in range(k_max):
        live = ~done & ~occluded & (remaining > 0)
        r = Ray(o=p, d=d_nee, mint=torch.zeros((n,), device=dev),
                maxt=torch.where(live, remaining, 0.0))
        h = scene_intersect(arr, r, sort_rays=True, **params)
        seg = torch.where(h.valid, torch.minimum(h.t, remaining), remaining)
        sig = arr.media.sigma_t[cur.long()]
        tr = tr * torch.where(live[..., None], torch.exp(
            -sig * torch.clamp(seg, max=1e30)[..., None]), 1.0)
        boundary = live & h.valid & (h.t < remaining)
        kind = arr.materials.kind[torch.clamp(h.mat_id, min=0).long()]
        passable = boundary & (kind == mat.NULL) & ~h.is_hair
        occluded = occluded | (boundary & ~passable)
        done = done | (live & ~boundary)
        med_ids = arr.tri_med[torch.clamp(h.prim, 0, ntri - 1).long()]
        # parity-robust: leaving the medium we are in beats the normal
        by_norm = torch.where(dot(d_nee, h.geo_n) < 0, med_ids[:, 0],
                              med_ids[:, 1])
        nxt = torch.where(cur == med_ids[:, 0], med_ids[:, 1],
                          torch.where(cur == med_ids[:, 1], med_ids[:, 0],
                                      by_norm))
        cur = torch.where(passable, nxt, cur)
        p = torch.where(passable[..., None], h.p + d_nee * cfg.ray_eps, p)
        remaining = torch.where(passable, remaining - seg - cfg.ray_eps,
                                remaining)
    # still mid-march after k_max crossings: the rest is unverified
    return tr, occluded | ~done


def make_volpath_bounded_li(scene):
    """li(arr, pixel_idx, sample_idx) -> (radiance, pos, n_rays) with
    shape-bounded homogeneous media: each lane's medium id indexes
    arr.media (0 = vacuum); null-BSDF surfaces are pure medium
    boundaries, refractive and null crossings switch the id by the side
    of the geometric normal (outward-oriented closed meshes)."""
    cfg = scene.config
    cam = scene.camera
    active_kinds = scene.active_kinds
    ray_eps = cfg.ray_eps
    params = _swept_params(cfg)

    def bounce(arr, w: _Wave, depth: int):
        s, smp = w.s, w.smp
        active, o, d, throughput = s["active"], s["o"], s["d"], s["tp"]
        cur_med = s["med"]
        n = active.shape[0]
        dev = active.device
        ntri = arr.tri_med.shape[0]
        dims = DIM_BASE + (depth - 1) * DIM_STRIDE
        zero_n = torch.zeros((n,), device=dev)
        r = Ray(o=o, d=d, mint=zero_n,
                maxt=torch.where(active, float("inf"), 0.0))
        hit = scene_intersect(arr, r, sort_rays=True, **params)
        # vacuum lanes escape with weight 1; sigma > 0 lanes practically
        # never out-fly 1e7 mean free paths
        t_surf = torch.where(hit.valid, hit.t, 1e7)
        mi = cur_med.long()
        sig_t = arr.media.sigma_t[mi]
        g_lane = arr.media.g[mi]
        dist, is_med, w_flight = med.sample_distance_lane(
            sig_t, arr.media.albedo[mi], smp.next_1d(dims + 9),
            smp.next_1d(dims + 10), t_surf)
        throughput = throughput * torch.where(active[..., None], w_flight,
                                              1.0)
        miss = active & ~hit.valid & ~is_med
        lum_pdf = _pdf_emitter_hit(arr, cfg, hit, d)
        w_esc = torch.where(s["first"] | s["prev_delta"], 1.0,
                            _mi_weight(s["prev_pdf"], lum_pdf))
        li_acc = s["li"] + torch.where(
            miss[..., None],
            throughput * _env_radiance(arr, d) * w_esc[..., None], 0.0)
        active2 = active & (hit.valid | is_med)
        p_evt = o + d * dist[..., None]

        # ---- NEE, its transmittance marched through the boundaries ----
        d_nee, dist_nee, le_nee, pdf_nee, is_dl = _sample_emitter_direct(
            arr, cfg, p_evt, smp.next_1d(dims + 0), smp.next_2d(dims + 1))
        ph = med.phase_eval(med.HG, g_lane, -d, d_nee)
        fr, wi, wo_nee, geo_n, gm = _surface(arr, hit, d, d_nee)
        f_s, pdf_bs = mat.eval_pdf(active_kinds, gm, wi, wo_nee,
                                   arr.hair_tables)
        scat = torch.where(is_med[..., None], ph[..., None], f_s)
        off = torch.where(is_med[..., None], 0.0, geo_n * torch.where(
            dot(d_nee, geo_n) > 0, ray_eps, -ray_eps)[..., None])
        ok = active2 & (pdf_nee > 0) \
            & (torch.amax(torch.abs(scat), dim=-1) > 0)
        tr_shadow, occl = _march_transmittance(
            arr, cfg, p_evt + off, d_nee,
            torch.clamp(dist_nee, max=1e7) - 2 * ray_eps, cur_med, ok)
        w_mis = torch.where(is_dl, 1.0, _mi_weight(
            pdf_nee, torch.where(is_med, ph, pdf_bs)))
        li_acc = li_acc + torch.where(
            (ok & ~occl)[..., None],
            throughput * le_nee * scat * tr_shadow
            * (w_mis / torch.clamp(pdf_nee, min=1e-20))[..., None], 0.0)

        # ---- continue ----
        u_ph = smp.next_2d(dims + 4)
        u_lobe = smp.next_1d(dims + 3)
        u2b = smp.next_2d(dims + 6)
        wo_med, pdf_ph = med.phase_sample(med.HG, g_lane, -d, u_ph)
        wo_l, w_bsdf, pdf_b, is_delta, _ = mat.sample(
            active_kinds, gm, wi, u_lobe, u_ph, u2b, arr.hair_tables)
        wo_surf = fr.to_world(wo_l)
        d_next = torch.where(is_med[..., None], wo_med, wo_surf)
        throughput = throughput * torch.where(is_med[..., None], 1.0, w_bsdf)
        active2 = active2 & ~(torch.amax(torch.abs(throughput), dim=-1) <= 0)
        # a medium transition where a surface event crosses its boundary
        wi_world = -d
        surf_evt = active2 & ~is_med & hit.valid & ~hit.is_hair
        crossed = surf_evt & (dot(wo_surf, hit.geo_n)
                              * dot(wi_world, hit.geo_n) < 0)
        med_ids = arr.tri_med[torch.clamp(hit.prim, 0, ntri - 1).long()]
        by_norm = torch.where(dot(wo_surf, hit.geo_n) < 0, med_ids[:, 0],
                              med_ids[:, 1])
        nxt_med = torch.where(cur_med == med_ids[:, 0], med_ids[:, 1],
                              torch.where(cur_med == med_ids[:, 1],
                                          med_ids[:, 0], by_norm))
        cur_med2 = torch.where(crossed, nxt_med, cur_med)
        o_next = torch.where(is_med[..., None], p_evt,
                             _offset(hit.p, geo_n, wo_surf, ray_eps))
        if depth + 1 > cfg.rr_depth:
            q = torch.clamp(torch.amax(throughput, dim=-1), max=0.95)
            kill = smp.next_1d(dims + 8) >= q
            throughput = torch.where(
                (~kill)[..., None],
                throughput / torch.clamp(q, min=1e-6)[..., None], throughput)
            active2 = active2 & ~kill
        next_pdf = torch.where(is_med, pdf_ph, pdf_b)
        next_delta = torch.where(is_med, False, is_delta)
        # an index-matched (null) boundary is no scattering event: the MIS
        # state passes through it
        kind_hit = arr.materials.kind[torch.clamp(hit.mat_id, min=0).long()]
        is_null = active2 & ~is_med & (kind_hit == mat.NULL)
        w.s = dict(active=active2, o=o_next, d=d_next, tp=throughput,
                   li=li_acc, first=s["first"] & is_null,
                   prev_pdf=torch.where(is_null, s["prev_pdf"], next_pdf),
                   prev_delta=torch.where(is_null, s["prev_delta"],
                                          next_delta),
                   med=cur_med2)
        return ok.sum() + active2.sum()

    return _make_li(cfg, cam, bounce, {
        "med": lambda n, dev: torch.zeros((n,), dtype=torch.int32,
                                          device=dev)})


def render_volpath(scene, medium=None, spp: int = 8, seed: int = 0,
                   progress=None):
    """Full-frame volumetric render; returns the developed [H, W, 3]
    image. Without a medium argument: the bounded tracer where the scene
    has shape-bounded media and no scene medium, else the scene's medium,
    else the default fog make_medium((0.05,) * 3, (0.01,) * 3). Lanes in
    plain pixel order, sample index s + seed * 65536.
    progress: callable(done_spp, total_spp, seconds, n_rays) per wave."""
    cfg = scene.config
    fl = scene.film
    arr = scene.arrays
    dev = arr.device
    n_pix = cfg.width * cfg.height
    if medium is None and scene.medium is None and arr.media is not None:
        li = make_volpath_bounded_li(scene)
    else:
        if medium is None:
            medium = scene.medium if scene.medium is not None \
                else med.make_medium((0.05,) * 3, (0.01,) * 3, device=dev)
        li = make_volpath_li(scene, medium)
    pixel_idx = torch.arange(n_pix, device=dev)
    image, weight = film_mod.zeros(fl, dev)
    for s in range(spp):
        t0 = time.time()
        sample_idx = torch.full((n_pix,), s + seed * 65536,
                                dtype=torch.int64, device=dev)
        radiance, pos, n_rays = li(arr, pixel_idx, sample_idx)
        radiance = torch.nan_to_num(radiance, nan=0.0, posinf=0.0,
                                    neginf=0.0)
        image, weight = film_mod.splat_samples(fl, pos, radiance, image,
                                               weight)
        if progress is not None:
            progress(s + 1, spp, time.time() - t0, float(n_rays))
    return film_mod.develop(image, weight)
