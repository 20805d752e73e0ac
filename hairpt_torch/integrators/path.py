"""Wavefront MIS path tracer with next-event estimation and Russian
roulette (port of hairpt/integrators/path.py, forward and differentiable
modes).

The bounce loop runs over a whole wave of path states at once. Emitter
NEE samples the baked environment through its alias table; shadow rays
are thinned by shadow-ray RR (cfg.nee_rr). The forward mode runs the
loop at staged widths n -> n/4 -> n/16 (live lanes gathered first,
results scattered back) so deep RR tails do not pay full-width shading.
The differentiable mode runs max_depth - 1 bounces at full width with
no RR, each under torch.utils.checkpoint, and hands the recomputation
the bounce's query results instead of tracing again. Sample dimensions,
constants and depth semantics are the JAX package's.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core import rng
from ..core.math import Ray, dot
from ..film import film as film_mod
from ..models import emitters as em
from ..models import sensors
from ..models.bsdf import registry as mat
from .common import Hit, block_swizzle, frame, scene_intersect, \
    scene_occluded

# sample-dimension layout: camera uses [0,4) (dims 2-3 are the aperture's,
# unused by the pinhole); bounce b uses [4+16b, 4+16(b+1))
DIM_CAM_POS = 0
DIM_BASE = 4
DIM_STRIDE = 16
D_NEE_SEL = 0
D_NEE_POS = 1
D_BSDF_LOBE = 3
D_BSDF_U2 = 4
D_BSDF_U2B = 6
D_RR = 8
D_NEE_RR = 13

LUM = (0.212671, 0.715160, 0.072169)

# widths of the staged wavefront: n, n/4, n/16 (the JAX package's default
# HAIRPT_STAGES=3)
MAX_STAGES = 3


def _swept_params(cfg):
    """The traversal and its parameters, passed to every query (the JAX
    package's _swept_params; C and K come from the tables' shapes)."""
    return dict(traversal=cfg.traversal, q_max=cfg.tiled_q,
                p_max=cfg.swept_pmax, chunk=cfg.swept_chunk)


def _luminance(c):
    return c[..., 0] * LUM[0] + c[..., 1] * LUM[1] + c[..., 2] * LUM[2]


def _mi_weight(pdf_a, pdf_b):
    a2 = pdf_a * pdf_a
    return torch.where(pdf_a > 0, a2 / torch.clamp(a2 + pdf_b * pdf_b,
                                                   min=1e-30), 0.0)


class PathState(NamedTuple):
    active: torch.Tensor            # [N] bool
    ray_o: torch.Tensor             # [N, 3]
    ray_d: torch.Tensor             # [N, 3]
    throughput: torch.Tensor        # [N, 3]
    li: torch.Tensor                # [N, 3]
    eta: torch.Tensor               # [N]
    hit: Hit                        # hit of the current ray
    prev_bsdf_pdf: torch.Tensor     # [N]
    prev_delta: torch.Tensor        # [N] bool
    emission_allowed: torch.Tensor  # [N] bool


def _map_state(st: PathState, fn) -> PathState:
    return PathState(*[Hit(*[fn(x) for x in v]) if isinstance(v, Hit)
                       else fn(v) for v in st])


def _env_radiance(arr, d):
    if arr.env is None:
        return torch.zeros(d.shape[:-1] + (3,), device=d.device)
    return em.env_eval(arr.env, d)


def _sample_emitter_direct(arr, cfg, p, u_sel, u2):
    """Pick the environment (the only emitter type of this slice) with
    probability cfg.nee_probs[0] and sample a direction towards it.
    Returns (d, dist, le, pdf, is_delta_light)."""
    n = p.shape[0]
    dev = p.device
    d = torch.zeros((n, 3), device=dev)
    d[:, 2] = 1.0
    le = torch.zeros((n, 3), device=dev)
    pdf = torch.zeros((n,), device=dev)
    dist = torch.full((n,), float("inf"), device=dev)
    is_dl = torch.zeros((n,), dtype=torch.bool, device=dev)
    p_env = cfg.nee_probs[0]
    if arr.env is not None and p_env > 0:
        d_env, le_env, pdf_env = em.env_sample(arr.env, u2)
        sel = u_sel < p_env
        d = torch.where(sel[..., None], d_env, d)
        le = torch.where(sel[..., None], le_env, le)
        pdf = torch.where(sel, pdf_env * p_env, pdf)
    return d, dist, le, pdf, is_dl


def _pdf_emitter_hit(arr, cfg, hit: Hit, d):
    """pdf of NEE having produced the direction of a BSDF ray that
    escaped to the environment."""
    pdf = torch.zeros(d.shape[:1], device=d.device)
    p_env = cfg.nee_probs[0]
    if arr.env is not None and p_env > 0:
        pdf_env = em.env_pdf(arr.env, d) * p_env
        pdf = torch.where(hit.valid, pdf, pdf_env)
    return pdf


class _Mirrored:
    """A sampler whose per-bounce dimensions at the offsets `rels` are
    mirrored, u -> 1 - u: the second render of an antithetic pair. The
    camera's dimensions are never mirrored."""

    def __init__(self, smp, rels):
        self.smp = smp
        self.rels = rels

    def _flip(self, u, dim: int):
        if dim >= DIM_BASE and (dim - DIM_BASE) % DIM_STRIDE in self.rels:
            return 1.0 - u
        return u

    def take(self, order) -> "_Mirrored":
        return _Mirrored(self.smp.take(order), self.rels)

    def next_1d(self, dim: int):
        return self._flip(self.smp.next_1d(dim), dim)

    def next_2d(self, dim: int):
        u = self.smp.next_2d(dim)
        return torch.stack([self._flip(u[..., 0], dim),
                            self._flip(u[..., 1], dim + 1)], dim=-1)


def _run_query(fn, *args, **kwargs):
    return fn(*args, **kwargs)


class _QueryStash:
    """The query results of one bounce of the differentiable mode. The
    bounce's first run records them; when torch.utils.checkpoint runs the
    bounce again in the backward pass, it gets them back in the same
    order, so no closest-hit or any-hit query is traced twice. (The
    queries carry no gradient: their rays start at hit points and leave
    along detached directions.)"""

    def __init__(self):
        self.results = []

    def caller(self):
        """A query runner for one run of the bounce."""
        recorded = iter(list(self.results))

        def run(fn, *args, **kwargs):
            out = next(recorded, None)
            if out is None:
                out = fn(*args, **kwargs)
                self.results.append(out)
            return out
        return run


def make_li_fn(scene, differentiable: bool = False, antithetic=False):
    """The per-wave radiance estimator li(arr, pixel_idx, sample_idx) ->
    (radiance [N, 3], pos [N, 2], n_rays [] tensor).

    differentiable: max_depth - 1 bounces at full width, no Russian
    roulette, each bounce checkpointed (its shading is recomputed in the
    backward pass, its queries are not); sampling is detached, so
    gradients flow through the BSDF values only: the sampled direction
    and its pdf carry none, and a smooth lobe's weight is f(wo) /
    sg(pdf(wo)). The material table's float fields in `arr` may require
    grad.

    antithetic: False, True (mirror the BSDF sample's 2D dims, D_BSDF_U2
    and D_BSDF_U2 + 1) or a tuple of per-bounce dim offsets to mirror."""
    cfg = scene.config
    cam = scene.camera
    active_kinds = scene.active_kinds
    ray_eps = cfg.ray_eps
    params = _swept_params(cfg)
    anti_rels = (D_BSDF_U2, D_BSDF_U2 + 1) if antithetic is True \
        else tuple(antithetic or ())

    def body(arr, st: PathState, depth: int, smp, query=_run_query):
        n = st.active.shape[0]
        dev = st.active.device
        dims = DIM_BASE + (depth - 1) * DIM_STRIDE
        hit = st.hit
        active = st.active
        d_in = st.ray_d
        zero = torch.zeros((), device=dev)

        # ---- miss: environment ----
        miss = active & ~hit.valid
        env_rad = _env_radiance(arr, d_in)
        li_acc = st.li + torch.where((miss & st.emission_allowed)[..., None],
                                     st.throughput * env_rad, zero)
        if arr.env is not None:
            lum_pdf = _pdf_emitter_hit(arr, cfg, hit, d_in)
            w = torch.where(st.prev_delta, 1.0,
                            _mi_weight(st.prev_bsdf_pdf, lum_pdf))
            li_acc = li_acc + torch.where(
                (miss & ~st.emission_allowed)[..., None],
                st.throughput * env_rad * w[..., None], zero)
        active = active & hit.valid

        # ---- shading frame (twosided flip) ----
        wi_world = -d_in
        p_n, p_s, p_t = mat.perturb_shading_frame(
            arr.materials, hit.mat_id, hit.sh_n, hit.sh_s, hit.sh_t)
        hit = hit._replace(sh_n=p_n, sh_s=p_s, sh_t=p_t)
        two = arr.materials.twosided[torch.clamp(hit.mat_id, min=0).long()]
        flip = (two & (dot(hit.sh_n, wi_world) < 0))[..., None]
        sh_n = torch.where(flip, -hit.sh_n, hit.sh_n)
        sh_t = torch.where(flip, -hit.sh_t, hit.sh_t)
        geo_n = torch.where(flip, -hit.geo_n, hit.geo_n)
        fr = frame(hit)._replace(n=sh_n, t=sh_t)
        wi = fr.to_local(wi_world)
        if cfg.strict_normals:
            active = active & ~(dot(d_in, geo_n) * wi[..., 2] >= 0)
        gm = mat.gather(arr.materials, hit.mat_id)

        # ---- NEE ----
        u_sel = smp.next_1d(dims + D_NEE_SEL)
        u_nee = smp.next_2d(dims + D_NEE_POS)
        d_nee, dist_nee, le_nee, pdf_nee, is_dl = \
            _sample_emitter_direct(arr, cfg, hit.p, u_sel, u_nee)
        wo_nee = fr.to_local(d_nee)
        f_nee, bsdf_pdf_nee = mat.eval_pdf_mix(
            active_kinds, arr.materials, hit.mat_id, gm, wi, wo_nee)
        nee_ok = active & (pdf_nee > 0) \
            & (torch.amax(torch.abs(f_nee), dim=-1) > 0)
        if cfg.strict_normals:
            nee_ok = nee_ok & (dot(geo_n, d_nee) * wo_nee[..., 2] > 0)
        w_nee = torch.where(is_dl, 1.0, _mi_weight(pdf_nee, bsdf_pdf_nee))
        contrib = st.throughput * le_nee * f_nee \
            * (w_nee / torch.clamp(pdf_nee, min=1e-20))[..., None]
        if cfg.nee_rr > 0.0:
            p_tr = torch.clamp(_luminance(contrib.detach()) / cfg.nee_rr,
                               0.05, 1.0)
            u_srr = smp.next_1d(dims + D_NEE_RR)
            nee_ok = nee_ok & (u_srr < p_tr)
            contrib = contrib / p_tr[..., None]
        shadow_o = hit.p + geo_n * torch.where(
            dot(d_nee, geo_n) > 0, ray_eps, -ray_eps)[..., None]
        shadow = Ray(o=shadow_o, d=d_nee, mint=torch.zeros((n,), device=dev),
                     maxt=torch.where(nee_ok, dist_nee - 2.0 * ray_eps,
                                      0.0))
        occluded = query(scene_occluded, arr, shadow, sort_rays=True,
                         compact=False, **params)
        vis = nee_ok & ~occluded
        li_acc = li_acc + torch.where(vis[..., None], contrib, zero)

        # ---- BSDF sampling ----
        u_lobe = smp.next_1d(dims + D_BSDF_LOBE)
        u2 = smp.next_2d(dims + D_BSDF_U2)
        u2b = smp.next_2d(dims + D_BSDF_U2B)
        wo, bsdf_weight, bsdf_pdf, is_delta, eta_s = mat.sample_mix(
            active_kinds, arr.materials, hit.mat_id, gm, wi, u_lobe, u2, u2b)
        if differentiable:
            wo = wo.detach()
            bsdf_pdf = bsdf_pdf.detach()
            f2, p2 = mat.eval_pdf_mix(active_kinds, arr.materials,
                                      hit.mat_id, gm, wi, wo)
            w_smooth = f2 / torch.clamp(p2.detach(), min=1e-9)[..., None]
            bsdf_weight = torch.where(is_delta[..., None], bsdf_weight,
                                      w_smooth)
        wo_world = fr.to_world(wo)
        active = active & ~(torch.amax(torch.abs(bsdf_weight), dim=-1) <= 0)
        if cfg.strict_normals:
            active = active & ~(dot(geo_n, wo_world) * wo[..., 2] <= 0)
        throughput = st.throughput * bsdf_weight
        eta = st.eta * eta_s

        # ---- next ray ----
        next_o = hit.p + geo_n * torch.where(
            dot(wo_world, geo_n) > 0, ray_eps, -ray_eps)[..., None]
        next_ray = Ray(o=next_o, d=wo_world,
                       mint=torch.zeros((n,), device=dev),
                       maxt=torch.where(active, float("inf"), 0.0))
        hit2 = query(scene_intersect, arr, next_ray, sort_rays=True,
                     compact=False, **params)

        # ---- RR (none in the differentiable mode) ----
        if not differentiable and depth + 1 > cfg.rr_depth:
            q = torch.clamp(torch.amax(throughput, dim=-1) * eta * eta,
                            max=0.95)
            u_rr = smp.next_1d(dims + D_RR)
            kill = u_rr >= q
            throughput = torch.where(
                (~kill)[..., None],
                throughput / torch.clamp(q, min=1e-6)[..., None], throughput)
            active = active & ~kill

        n_new = nee_ok.sum() + active.sum()
        return PathState(active=active, ray_o=next_o, ray_d=wo_world,
                         throughput=throughput, li=li_acc, eta=eta, hit=hit2,
                         prev_bsdf_pdf=bsdf_pdf, prev_delta=is_delta,
                         emission_allowed=torch.zeros_like(active)), n_new

    def li(arr, pixel_idx, sample_idx):
        dev = pixel_idx.device
        smp = rng.Sampler(cfg.sampler, pixel_idx, sample_idx)
        n = pixel_idx.shape[0]
        px = (smp.pixel % cfg.width).to(torch.float32)
        py = (smp.pixel // cfg.width).to(torch.float32)
        if anti_rels:
            smp = _Mirrored(smp, anti_rels)
        jitter = smp.next_2d(DIM_CAM_POS)
        pos = torch.stack([px + jitter[..., 0], py + jitter[..., 1]], dim=-1)
        ray = sensors.sample_ray(cam, pos)
        hit0 = scene_intersect(arr, ray, **params)
        state = PathState(
            active=torch.ones((n,), dtype=torch.bool, device=dev),
            ray_o=ray.o, ray_d=ray.d,
            throughput=torch.ones((n, 3), device=dev),
            li=torch.zeros((n, 3), device=dev),
            eta=torch.ones((n,), device=dev), hit=hit0,
            prev_bsdf_pdf=torch.zeros((n,), device=dev),
            prev_delta=torch.zeros((n,), dtype=torch.bool, device=dev),
            emission_allowed=torch.ones((n,), dtype=torch.bool, device=dev))
        n_rays = torch.tensor(float(n), device=dev)
        if differentiable:
            for depth in range(1, cfg.max_depth):
                stash = _QueryStash()
                state, n_new = checkpoint(
                    lambda st, d=depth, q=stash: body(arr, st, d, smp,
                                                      q.caller()),
                    state, use_reentrant=False, preserve_rng_state=False)
                n_rays = n_rays + n_new
            return _flush_pending(arr, state), pos, n_rays

        stage_caps = [n]
        if n >= 4096:
            for f_ in (4, 16, 64, 256):
                m_ = max(256, (-(-n // f_) // 256) * 256)
                if m_ < stage_caps[-1] and len(stage_caps) < MAX_STAGES:
                    stage_caps.append(m_)

        depth = 1
        st_full = state
        for si, w_ in enumerate(stage_caps):
            next_cap = stage_caps[si + 1] if si + 1 < len(stage_caps) else 0
            if w_ == n:
                order, sub, ssmp = None, st_full, smp
            else:
                key = torch.where(st_full.active, 0, 1)
                order = torch.argsort(key, stable=True)[:w_]
                sub = _map_state(st_full, lambda a: a[order])
                ssmp = smp.take(order)
            while depth < cfg.max_depth:
                n_act = int(sub.active.sum())
                if n_act == 0 or (next_cap > 0 and n_act <= next_cap):
                    break
                sub, n_new = body(arr, sub, depth, ssmp)
                n_rays = n_rays + n_new
                depth += 1
            if order is None:
                st_full = sub
            else:
                def scatter(f, g):
                    out = f.clone()
                    out[order] = g
                    return out
                st_full = PathState(*[
                    Hit(*[scatter(a, b) for a, b in zip(fv, gv)])
                    if isinstance(fv, Hit) else scatter(fv, gv)
                    for fv, gv in zip(st_full, sub)])

        return _flush_pending(arr, st_full), pos, n_rays

    def _flush_pending(arr, st):
        """The emission pending on paths that stopped by depth while
        active."""
        li_acc = st.li
        if arr.env is not None:
            miss = st.active & ~st.hit.valid
            lum_pdf = _pdf_emitter_hit(arr, cfg, st.hit, st.ray_d)
            w = torch.where(st.prev_delta, 1.0,
                            _mi_weight(st.prev_bsdf_pdf, lum_pdf))
            w = torch.where(st.emission_allowed, 1.0, w)
            li_acc = li_acc + torch.where(
                miss[..., None],
                st.throughput * _env_radiance(arr, st.ray_d) * w[..., None],
                0.0)
        return li_acc

    return li


def render(scene, seed: int = 0, spp: int | None = None,
           return_stats: bool = False, progress=None):
    """Full-frame render: one wave per sample index, splatted on the film.
    Returns the developed [H, W, 3] image (linear radiance).

    progress: callable(done_spp, total_spp, seconds_of_this_wave, n_rays)
    after each wave (the wave is complete: its ray count is read back)."""
    cfg = scene.config
    spp = spp if spp is not None else cfg.spp
    fl = scene.film
    arr = scene.arrays
    dev = arr.hair.p0.device
    n_pix = cfg.width * cfg.height
    li_fn = make_li_fn(scene)
    swz = block_swizzle(cfg.width, cfg.height)
    pixel_idx = torch.as_tensor(swz, device=dev) if swz is not None \
        else torch.arange(n_pix, device=dev)
    image, weight = film_mod.zeros(fl, dev)
    total_rays = 0.0
    for s in range(spp):
        t0 = time.time()
        sample_idx = torch.full((n_pix,), s + seed * 65536,
                                dtype=torch.int64, device=dev)
        radiance, pos, n_rays = li_fn(arr, pixel_idx, sample_idx)
        radiance = torch.nan_to_num(radiance, nan=0.0, posinf=0.0,
                                    neginf=0.0)
        image, weight = film_mod.splat_samples(fl, pos, radiance, image,
                                               weight)
        wave_rays = float(n_rays)
        total_rays += wave_rays
        if progress is not None:
            progress(s + 1, spp, time.time() - t0, wave_rays)
    img = film_mod.develop(image, weight)
    if return_stats:
        return img, {"rays": total_rays}
    return img
