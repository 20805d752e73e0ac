"""Wavefront MIS path tracer with next-event estimation and Russian
roulette (port of hairpt/integrators/path.py, forward and differentiable
modes).

The bounce loop runs over a whole wave of path states at once. Emitter
NEE picks the baked environment (its alias table), an area light (a
triangle by power, a point on it uniformly) or a delta light (point,
spot, directional, collimated) with the probabilities cfg.nee_probs;
a BSDF ray that hits an area light or escapes to the environment adds
its emission under MIS, a delta light keeps an MIS weight of 1. Shadow
rays are thinned by shadow-ray RR (cfg.nee_rr). Bitmap textures are looked up
at the mip level of each hit's isotropic footprint; at the camera hit a
lane with a uv Jacobian (_camera_uv_partials) is EWA-filtered instead,
and whether a wave has such a lane is read once, after the camera query,
so the bounce loop adds no host sync for it. The forward mode runs the
loop at staged widths n -> n/4 -> n/16 (live lanes gathered first,
results scattered back) so deep RR tails do not pay full-width shading.
The differentiable mode runs max_depth - 1 bounces at full width with
no RR, each under torch.utils.checkpoint, and hands the recomputation
the bounce's query results instead of tracing again. A hit on a DIPOLE
row (subsurface scattering, the scene's arrays.sss attached by
integrators/sss.attach_dipole) adds the dipole's gathered radiance, or
with cfg.sss_single the single-scattering estimate (_single_scatter,
three queries of its own), and ends the lane, in both modes. Sample
dimensions, constants and depth semantics are the JAX package's.
"""
from __future__ import annotations

import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core import rng, warps
from ..core.math import Ray, dot
from ..film import film as film_mod
from ..models import emitters as em
from ..models import sensors
from ..models import subsurface as sss_mod
from ..models.bsdf import registry as mat
from ..ops.tiled_kernels import sqrt_rn
from ..utils import stats
from .common import Hit, block_swizzle, frame, scene_intersect, \
    scene_occluded

# sample-dimension layout: camera uses [0,4) (dims 2-3 are the aperture's:
# the thin lens and the telecentric lens); bounce b uses [4+16b, 4+16(b+1))
DIM_CAM_POS = 0
DIM_CAM_APERTURE = 2
DIM_BASE = 4
DIM_STRIDE = 16
D_NEE_SEL = 0
D_NEE_POS = 1
D_BSDF_LOBE = 3
D_BSDF_U2 = 4
D_BSDF_U2B = 6
D_RR = 8
D_SSS_DIST = 9              # single scatter: the interior distance
D_SSS_SEL = 10              # single scatter: the light selection
D_SSS_POS = 11              # (and 12) single scatter: the light position
D_NEE_RR = 13

LUM = (0.212671, 0.715160, 0.072169)

# widths of the staged wavefront: n, n/4, n/16 (the JAX package's default
# HAIRPT_STAGES=3), for waves of STAGE_MIN lanes or more
MAX_STAGES = 3
STAGE_MIN = 4096


def stage_caps(n: int):
    """The staged wavefront's widths for a wave of n lanes: n, then n/4
    and n/16 rounded up to 256 lanes (at most MAX_STAGES widths, each
    narrower than the last; n alone below STAGE_MIN lanes)."""
    caps = [n]
    if n >= STAGE_MIN:
        for f in (4, 16, 64, 256):
            m = max(256, (-(-n // f) // 256) * 256)
            if m < caps[-1] and len(caps) < MAX_STAGES:
                caps.append(m)
    return caps


def _swept_params(cfg):
    """The traversal and its parameters, passed to every query (the JAX
    package's _swept_params; C and K come from the tables' shapes)."""
    return dict(traversal=cfg.traversal, q_max=cfg.tiled_q,
                p_max=cfg.swept_pmax, chunk=cfg.swept_chunk,
                block=cfg.block, short_t=cfg.tiled_short)


def aperture_sample(cam, smp):
    """The camera's aperture sample (dims DIM_CAM_APERTURE), or None for a
    camera that has no aperture to sample (its rays do not read it)."""
    lens = (cam.kind == sensors.THINLENS and cam.aperture_radius > 0.0) \
        or cam.kind == sensors.TELECENTRIC
    return smp.next_2d(DIM_CAM_APERTURE) if lens else None


def _camera_uv_partials(arr, cam, pos, ray, hit, ap=None):
    """The uv footprint Jacobian at the camera hit (the JAX package's
    _camera_uv_partials; reference: Intersection::computePartials):
    offset rays through the next pixel centres transferred to the hit's
    tangent plane, projected on (dp/du, dp/dv) by least squares. Returns
    (duv_dx, duv_dy) [N, 2] in unscaled uv; zero on hair, instanced
    (uv_density 0), missed and degenerate lanes."""
    sh = arr.tri_shading
    i = torch.clamp(hit.prim, 0, sh.uv0.shape[0] - 1).long()
    duv1 = sh.uv1[i] - sh.uv0[i]
    duv2 = sh.uv2[i] - sh.uv0[i]
    e1 = arr.tri.e1[i]
    e2 = arr.tri.e2[i]
    det_uv = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
    inv_uv = 1.0 / torch.where(torch.abs(det_uv) < 1e-12, 1.0, det_uv)
    dpdu = (duv2[..., 1:2] * e1 - duv1[..., 1:2] * e2) * inv_uv[..., None]
    dpdv = (-duv2[..., 0:1] * e1 + duv1[..., 0:1] * e2) * inv_uv[..., None]
    one_x = torch.tensor([1.0, 0.0], device=pos.device)
    one_y = torch.tensor([0.0, 1.0], device=pos.device)
    n = hit.geo_n
    d_dot = dot(ray.d, n)

    def transfer(rd):
        dn = dot(rd.d, n)
        tq = dot(hit.p - rd.o, n) / torch.where(torch.abs(dn) < 1e-12, 1.0,
                                                dn)
        return rd.o + rd.d * tq[..., None] - hit.p

    dpdx = transfer(sensors.sample_ray(cam, pos + one_x, ap))
    dpdy = transfer(sensors.sample_ray(cam, pos + one_y, ap))
    g00 = dot(dpdu, dpdu)
    g01 = dot(dpdu, dpdv)
    g11 = dot(dpdv, dpdv)
    det_g = g00 * g11 - g01 * g01
    inv_g = 1.0 / torch.where(torch.abs(det_g) < 1e-20, 1.0, det_g)

    def solve(dp):
        bu = dot(dpdu, dp)
        bv = dot(dpdv, dp)
        return torch.stack([(g11 * bu - g01 * bv) * inv_g,
                            (g00 * bv - g01 * bu) * inv_g], -1)

    ok = (hit.valid & ~hit.is_hair & (hit.uv_density > 0)
          & (torch.abs(det_uv) > 1e-12) & (torch.abs(det_g) > 1e-20)
          & (torch.abs(d_dot) > 1e-6))[..., None]
    return (torch.where(ok, solve(dpdx), 0.0),
            torch.where(ok, solve(dpdy), 0.0))


def has_bitmaps(arr) -> bool:
    """Does the texture table hold a bitmap (one host sync; the callers
    ask once per render function)? Without one the footprint changes no
    texture value: only bitmap lanes read the mips."""
    return arr.checkers is not None \
        and bool((arr.checkers.kind == mat.TEX_BITMAP).any())


def camera_footprint(arr, cam, pos, ray, hit, bitmaps: bool, ap=None):
    """(duv_dx, duv_dy, ewa): the camera hit's uv Jacobian (the offset
    rays through the primary ray's aperture point ap), zero-width [N, 0]
    when the scene has no bitmap or no triangles, and whether any lane
    has a nonzero one (one host sync, once per wave)."""
    n = pos.shape[0]
    if not bitmaps or arr.checkers is None or arr.tri is None:
        z = torch.zeros((n, 0), device=pos.device)
        return z, z, False
    dx, dy = _camera_uv_partials(arr, cam, pos, ray, hit, ap)
    ewa = bool(((torch.abs(dx).sum(-1) + torch.abs(dy).sum(-1)) > 0).any())
    return dx, dy, ewa


def texture_lod(arr, cam, width: int, hit, bitmaps: bool):
    """The isotropic level of detail log2(max(t * pixel angle *
    uv_density * R, 1)) of each hit, or None without a bitmap."""
    if not bitmaps or arr.checkers is None:
        return None
    pix_ang = 2.0 * cam.tan_half_fov / width
    foot = hit.t * pix_ang * hit.uv_density * arr.checkers.bitmaps.shape[1]
    return torch.log2(torch.clamp(foot, min=1.0))


def kind_rows(materials):
    """Host copies of a material table's kind, mix_a and mix_b (the
    rows' families and the wrappers' nested rows), for live_kinds."""
    return (materials.kind.tolist(), materials.mix_a.tolist(),
            materials.mix_b.tolist())


def live_kinds(rows, mat_id, live):
    """The BSDF kinds the live lanes need: the kinds of the rows they hit
    and of those rows' nested rows (one host sync). Shading evaluates
    only these: every family's value is selected by the lane's own kind,
    so the live lanes' values are the same as over all the scene's
    kinds, and a bounce deep in a wave of glass and mirrors, where few
    kinds are left, does not pay the thousands of small launches of
    the rest (the wrappers evaluate their nested families again)."""
    kind, mix_a, mix_b = rows
    hit_rows = torch.bincount(torch.where(live, mat_id.long() + 1, 0),
                              minlength=len(kind) + 1)[1:]
    out = set()
    for r in torch.nonzero(hit_rows).flatten().tolist():
        out.add(kind[r])
        if kind[r] in mat.WRAPPER_KINDS:
            out.add(kind[mix_a[r]])
            if kind[r] == mat.MIXTURE:
                out.add(kind[mix_b[r]])
    return tuple(sorted(out))


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
    duv_dx: torch.Tensor            # [N, 2] the camera hit's uv Jacobian
    duv_dy: torch.Tensor            # ([N, 0] without textured triangles)


def _map_state(st: PathState, fn) -> PathState:
    return PathState(*[Hit(*[fn(x) for x in v]) if isinstance(v, Hit)
                       else fn(v) for v in st])


def _env_radiance(arr, d):
    if arr.env is None:
        return torch.zeros(d.shape[:-1] + (3,), device=d.device)
    return em.env_eval(arr.env, d)


def _emitter_radiance_at_hit(arr, hit: Hit, wi_world):
    """Le of an area light at the hit, seen from wi_world (0 where the hit
    is on no emitter or faces away: its geometric normal)."""
    if arr.area is None:
        return torch.zeros(hit.p.shape[:-1] + (3,), device=hit.p.device)
    le = arr.area.radiance[torch.clamp(hit.emitter_id, min=0).long()]
    on = (hit.emitter_id >= 0) & (dot(hit.geo_n, wi_world) > 0)
    return torch.where(on[..., None], le, 0.0)


def _sample_emitter_direct(arr, cfg, p, u_sel, u2):
    """Pick an emitter kind (environment, area, delta) by u_sel with the
    probabilities cfg.nee_probs and sample a direction towards it
    (reference: Scene::sampleEmitterDirect, scene.cpp:828). Returns (d,
    dist, le, pdf, is_delta_light); for a delta light le / pdf is its
    whole contribution (its MIS weight is 1). The shading points carry no
    gradient, so the square roots are tiled_kernels.sqrt_rn's."""
    n = p.shape[0]
    dev = p.device
    d = torch.zeros((n, 3), device=dev)
    d[:, 2] = 1.0
    le = torch.zeros((n, 3), device=dev)
    pdf = torch.zeros((n,), device=dev)
    dist = torch.full((n,), float("inf"), device=dev)
    is_dl = torch.zeros((n,), dtype=torch.bool, device=dev)
    p_env, p_area, p_delta = cfg.nee_probs
    if arr.env is not None and p_env > 0:
        d_env, le_env, pdf_env = em.env_sample(arr.env, u2)
        sel = u_sel < p_env
        d = torch.where(sel[..., None], d_env, d)
        le = torch.where(sel[..., None], le_env, le)
        pdf = torch.where(sel, pdf_env * p_env, pdf)
    if arr.area is not None and p_area > 0:
        area = arr.area
        u_resc = torch.clamp((u_sel - p_env) / p_area, 0.0, 1.0 - 1e-7)
        l, prob_l = em.sample_cdf(area.cdf, u_resc)
        su = sqrt_rn(torch.clamp(u2[..., 0], min=1e-12))
        b0 = 1.0 - su
        b1 = u2[..., 1] * su
        q = area.p0[l] + area.e1[l] * b0[..., None] \
            + area.e2[l] * b1[..., None]
        dq = q - p
        d2 = torch.sum(dq * dq, dim=-1)
        dl = sqrt_rn(torch.clamp(d2, min=1e-20))
        dd = dq / dl[..., None]
        cos_l = -torch.sum(area.n[l] * dd, dim=-1)
        pdf_sa = prob_l / torch.clamp(area.area[l], min=1e-12) * d2 \
            / torch.clamp(cos_l, min=1e-6)
        ok = cos_l > 1e-6
        sel = (u_sel >= p_env) & (u_sel < p_env + p_area)
        d = torch.where(sel[..., None], dd, d)
        le = torch.where((sel & ok)[..., None], area.radiance[l],
                         torch.where(sel[..., None], 0.0, le))
        pdf = torch.where(sel, torch.where(ok, pdf_sa * p_area, 0.0), pdf)
        dist = torch.where(sel, dl, dist)
    if arr.delta is not None and p_delta > 0:
        u_resc = torch.clamp((u_sel - p_env - p_area) / p_delta, 0.0,
                             1.0 - 1e-7)
        d_dl, dist_dl, contrib, prob_l = em.delta_light_sample(
            arr.delta, p, u_resc)
        sel = u_sel >= p_env + p_area
        d = torch.where(sel[..., None], d_dl, d)
        le = torch.where(sel[..., None], contrib, le)
        pdf = torch.where(sel, prob_l * p_delta, pdf)
        dist = torch.where(sel, dist_dl, dist)
        is_dl = is_dl | sel
    return d, dist, le, pdf, is_dl


def _pdf_emitter_hit(arr, cfg, hit: Hit, d):
    """pdf of NEE having produced the direction d of a BSDF ray: the
    environment's where it escaped, the area light's where it hit one
    (delta lights are not reachable by BSDF rays). prob_l is from the
    raw power, as in the JAX package (the CDF adds 1e-12 per entry)."""
    pdf = torch.zeros(d.shape[:1], device=d.device)
    p_env, p_area, _ = cfg.nee_probs
    if arr.env is not None and p_env > 0:
        pdf_env = em.env_pdf(arr.env, d) * p_env
        pdf = torch.where(hit.valid, pdf, pdf_env)
    if arr.area is not None and p_area > 0:
        area = arr.area
        l = torch.clamp(hit.emitter_id, min=0).long()
        power_lum = area.area * (area.radiance
                                 @ area.radiance.new_tensor(LUM))
        prob_l = power_lum / torch.clamp(power_lum.sum(), min=1e-12)
        cos_l = -torch.sum(area.n[l] * d, dim=-1)
        pdf_area = prob_l[l] / torch.clamp(area.area[l], min=1e-12) \
            * (hit.t * hit.t) / torch.clamp(cos_l, min=1e-6)
        on = hit.valid & (hit.emitter_id >= 0) & (cos_l > 1e-6)
        pdf = torch.where(on, pdf_area * p_area, pdf)
    return pdf


def _single_scatter(arr, cfg, p, n, wo_world, params, sel, u_dist, u_sel,
                    u_pos, query, qparams):
    """Single scattering through the refractive boundary (the JAX
    package's _single_scatter; reference src/subsurface/singlescatter.cpp
    LoSingle, with Jensen et al. 2001's estimator): the view ray refracted
    in, one scatter point sampled along its interior chord (truncated
    exponential), a light sampled from it, the exit point towards the
    light and the Snell-corrected inside distance (Jensen eq. 13), both
    interior lengths' attenuation and both Fresnel transmittances; a
    shadow ray from the exit point. [N, 3]; lanes with sel False trace
    degenerate rays and give 0. Its queries go through the bounce's
    query runner with the traversal's parameters qparams."""
    from ..models.bsdf.fresnel import fresnel_dielectric
    dev = p.device
    nray = p.shape[0]
    zero = torch.zeros((nray,), device=dev)
    eta = params.eta
    cos_o = torch.clamp(dot(wo_world, n), min=0.0)
    r_o, _ = fresnel_dielectric(cos_o, eta)
    sin2_t = (1.0 - cos_o * cos_o) / (eta * eta)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    w_in = -wo_world / eta + (cos_o / eta - cos_t)[..., None] * n
    o_in = p - n * cfg.ray_eps
    r0 = Ray(o=o_in, d=w_in, mint=zero,
             maxt=torch.where(sel, float("inf"), 0.0))
    hx0 = query(scene_intersect, arr, r0, sort_rays=True, **qparams)
    s_max = torch.where(hx0.valid, hx0.t, 0.0)
    sig_s = params.sigma_s * params.scale
    sig_t = sig_s + params.sigma_a * params.scale
    sig_bar = torch.mean(sig_t)
    cdf_max = 1.0 - torch.exp(-sig_bar * s_max)
    s = -torch.log1p(-u_dist * cdf_max) / sig_bar
    pdf_s = sig_bar * torch.exp(-sig_bar * s) / torch.clamp(cdf_max,
                                                            min=1e-12)
    x_s = o_in + w_in * s[..., None]
    ok = sel & hx0.valid & (cdf_max > 1e-6)
    d_nee, dist_nee, le, pdf_nee, _ = _sample_emitter_direct(
        arr, cfg, x_s, u_sel, u_pos)
    ok = ok & (pdf_nee > 0)
    r1 = Ray(o=x_s, d=d_nee, mint=zero,
             maxt=torch.where(ok, float("inf"), 0.0))
    hx1 = query(scene_intersect, arr, r1, sort_rays=True, **qparams)
    ok = ok & hx1.valid
    si = torch.where(hx1.valid, hx1.t, 0.0)
    cos_exit = torch.abs(dot(d_nee, hx1.geo_n))
    denom = torch.sqrt(torch.clamp(
        1.0 - (1.0 - cos_exit * cos_exit) / (eta * eta), min=1e-6))
    s_i = si * cos_exit / denom
    r_i, _ = fresnel_dielectric(cos_exit, eta)
    n_out = torch.where(dot(hx1.geo_n, d_nee)[..., None] > 0, hx1.geo_n,
                        -hx1.geo_n)
    sh = Ray(o=hx1.p + n_out * cfg.ray_eps, d=d_nee, mint=zero,
             maxt=torch.where(ok, dist_nee - si - 2 * cfg.ray_eps, 0.0))
    occ = query(scene_occluded, arr, sh, sort_rays=True, **qparams)
    ok = ok & ~occ
    g = torch.tensor(float(params.g), dtype=torch.float32, device=dev)
    cos_ph = dot(w_in, d_nee)
    ph = (1.0 - g * g) / (4.0 * math.pi * torch.clamp(
        1.0 + g * g - 2.0 * g * cos_ph, min=1e-6) ** 1.5)
    tr = torch.exp(-sig_t[None, :] * (s + s_i)[..., None])
    lo = sig_s[None, :] * tr * le * (
        ph * (1.0 - r_o) * (1.0 - r_i)
        / (torch.clamp(pdf_nee, min=1e-20)
           * torch.clamp(pdf_s, min=1e-20)))[..., None]
    return torch.where(ok[..., None], lo, 0.0)


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


class UniformSampler:
    """A sampler that reads its values from explicit primary samples: dim
    d of a lane is column d mod D of its row of uniforms [N, D] (the JAX
    package's n_uniform_dims hook, the primary-sample space of pssmlt and
    erpt; reference: ReplayableSampler, bidir/rsampler.h)."""

    def __init__(self, uniforms):
        self.u = uniforms

    def take(self, order) -> "UniformSampler":
        return UniformSampler(self.u[order])

    def next_1d(self, dim: int):
        return self.u[:, dim % self.u.shape[1]]

    def next_2d(self, dim: int):
        return torch.stack([self.next_1d(dim), self.next_1d(dim + 1)],
                           dim=-1)


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


ABLATE_KNOBS = ("nonee", "noshadow", "cheapshade", "nosort")


def make_li_fn(scene, differentiable: bool = False, antithetic=False,
               n_uniform_dims: int = 0, ablate: tuple = ()):
    """The per-wave radiance estimator li(arr, pixel_idx, sample_idx) ->
    (radiance [N, 3], pos [N, 2], n_rays [] tensor).

    differentiable: max_depth - 1 bounces at full width, no Russian
    roulette, each bounce checkpointed (its shading is recomputed in the
    backward pass, its queries are not); sampling is detached, so
    gradients flow through the BSDF values only: the sampled direction
    and its pdf carry none, and a smooth lobe's weight is f(wo) /
    sg(pdf(wo)); a delta lane keeps the sampled weight. The material
    table's float fields and the hair tables in `arr` may require grad.

    antithetic: False, True (mirror the BSDF sample's 2D dims, D_BSDF_U2
    and D_BSDF_U2 + 1) or a tuple of per-bounce dim offsets to mirror.

    n_uniform_dims > 0: li takes `uniforms` [N, n_uniform_dims] and every
    sample dimension d reads its column d mod n_uniform_dims
    (UniformSampler) instead of the procedural sampler; the wave then
    runs at full width, without the staged widths, as in the JAX
    package.

    ablate: the JAX package's diagnostic knobs, which split a wave's time
    into its parts (each takes a part away, so the image is wrong under
    any of them): 'nonee' skips emitter sampling and the shadow query,
    'noshadow' treats every shadow ray as unoccluded, 'cheapshade' puts
    closed-form Lambert in place of the BSDF's eval and sample, 'nosort'
    turns off the Morton / octant resort of the bounce and shadow waves.
    path.render and the CLI pass none."""
    bad = set(ablate) - set(ABLATE_KNOBS)
    if bad:
        raise ValueError(f"unknown ablate knobs {sorted(bad)}; the knobs "
                         f"are {ABLATE_KNOBS}")
    nonee, noshadow = "nonee" in ablate, "noshadow" in ablate
    cheapshade, sort_rays = "cheapshade" in ablate, "nosort" not in ablate
    cfg = scene.config
    cam = scene.camera
    active_kinds = scene.active_kinds
    rows = kind_rows(scene.arrays.materials) if len(active_kinds) > 1 \
        else None
    ray_eps = cfg.ray_eps
    params = _swept_params(cfg)
    anti_rels = (D_BSDF_U2, D_BSDF_U2 + 1) if antithetic is True \
        else tuple(antithetic or ())
    bitmaps = has_bitmaps(scene.arrays)
    dipole = mat.DIPOLE in active_kinds

    def body(arr, st: PathState, depth: int, smp, query=_run_query,
             ewa: bool = False, cam=cam):
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
        if arr.env is not None or arr.area is not None:
            lum_pdf = _pdf_emitter_hit(arr, cfg, hit, d_in)
            w = torch.where(st.prev_delta, 1.0,
                            _mi_weight(st.prev_bsdf_pdf, lum_pdf))
        if arr.env is not None:
            li_acc = li_acc + torch.where(
                (miss & ~st.emission_allowed)[..., None],
                st.throughput * env_rad * w[..., None], zero)
        active = active & hit.valid
        wi_world = -d_in

        # ---- emitter hit: an area light's emission ----
        if arr.area is not None:
            le = _emitter_radiance_at_hit(arr, hit, wi_world)
            w_sel = torch.where(st.emission_allowed, 1.0, w)
            li_acc = li_acc + torch.where(
                active[..., None], st.throughput * le * w_sel[..., None],
                zero)

        # ---- shading frame (twosided flip) ----
        if scene.has_normal_maps:
            p_n, p_s, p_t = mat.perturb_shading_frame(
                arr.materials, arr.checkers, hit.mat_id, hit.uv, hit.sh_n,
                hit.sh_s, hit.sh_t)
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
        # the camera hit's EWA where a lane has a Jacobian (ewa: read once
        # per wave), the footprint's trilinear level elsewhere
        duv = (st.duv_dx, st.duv_dy) if depth == 1 and ewa else None
        gm = mat.gather(arr.materials, arr.checkers, hit.mat_id, hit.uv,
                        texture_lod(arr, cam, cfg.width, hit, bitmaps),
                        hit.bary, hit.vcolor, duv)
        # ---- dipole subsurface lanes: gather Lo and end the lane ----
        if dipole and arr.sss is not None:
            is_sss = active & (gm.kind == mat.DIPOLE)
            if cfg.sss_single:
                lo_sss = _single_scatter(
                    arr, cfg, hit.p, sh_n, wi_world, arr.sss.params, is_sss,
                    smp.next_1d(dims + D_SSS_DIST),
                    smp.next_1d(dims + D_SSS_SEL),
                    smp.next_2d(dims + D_SSS_POS), query, params)
            else:
                lo_sss = sss_mod.sss_radiance(arr.sss, hit.p, wi[..., 2])
            li_acc = li_acc + torch.where(is_sss[..., None],
                                          st.throughput * lo_sss, zero)
            active = active & ~is_sss
        kinds = active_kinds if rows is None \
            else live_kinds(rows, hit.mat_id, active)

        def eval_pdf(wo_q):
            if cheapshade:
                cz = torch.clamp(wo_q[..., 2], min=0.0) / math.pi
                return gm.diffuse * cz[..., None], cz
            return mat.eval_pdf_mix(kinds, arr.materials, arr.checkers,
                                    hit.mat_id, hit.uv, gm, wi, wo_q,
                                    arr.hair_tables)

        # ---- NEE ----
        nee_ok = torch.zeros_like(active)
        if not nonee:
            u_sel = smp.next_1d(dims + D_NEE_SEL)
            u_nee = smp.next_2d(dims + D_NEE_POS)
            # a stopped lane's point (at infinity on a miss) is parked at
            # the origin: its NEE direction stays finite, so the zero
            # gradient its masked contribution gets is not 0 * NaN
            d_nee, dist_nee, le_nee, pdf_nee, is_dl = \
                _sample_emitter_direct(
                    arr, cfg, torch.where(active[..., None], hit.p, 0.0),
                    u_sel, u_nee)
            wo_nee = fr.to_local(d_nee)
            f_nee, bsdf_pdf_nee = eval_pdf(wo_nee)
            nee_ok = active & (pdf_nee > 0) \
                & (torch.amax(torch.abs(f_nee), dim=-1) > 0)
            if cfg.strict_normals:
                nee_ok = nee_ok & (dot(geo_n, d_nee) * wo_nee[..., 2] > 0)
            w_nee = torch.where(is_dl, 1.0,
                                _mi_weight(pdf_nee, bsdf_pdf_nee))
            contrib = st.throughput * le_nee * f_nee \
                * (w_nee / torch.clamp(pdf_nee, min=1e-20))[..., None]
            if cfg.nee_rr > 0.0:
                p_tr = torch.clamp(_luminance(contrib.detach())
                                   / cfg.nee_rr, 0.05, 1.0)
                u_srr = smp.next_1d(dims + D_NEE_RR)
                nee_ok = nee_ok & (u_srr < p_tr)
                contrib = contrib / p_tr[..., None]
            shadow_o = hit.p + geo_n * torch.where(
                dot(d_nee, geo_n) > 0, ray_eps, -ray_eps)[..., None]
            shadow = Ray(o=shadow_o, d=d_nee,
                         mint=torch.zeros((n,), device=dev),
                         maxt=torch.where(nee_ok, dist_nee - 2.0 * ray_eps,
                                          0.0))
            if noshadow:
                occluded = torch.zeros_like(nee_ok)
            else:
                occluded = query(scene_occluded, arr, shadow,
                                 sort_rays=sort_rays, compact=False,
                                 **params)
            vis = nee_ok & ~occluded
            li_acc = li_acc + torch.where(vis[..., None], contrib, zero)

        # ---- BSDF sampling ----
        u_lobe = smp.next_1d(dims + D_BSDF_LOBE)
        u2 = smp.next_2d(dims + D_BSDF_U2)
        u2b = smp.next_2d(dims + D_BSDF_U2B)
        if cheapshade:
            wo = warps.square_to_cosine_hemisphere(u2)
            bsdf_pdf = torch.clamp(wo[..., 2], min=0.0) / math.pi
            bsdf_weight = gm.diffuse
            is_delta = torch.zeros_like(active)
            eta_s = torch.ones((n,), device=dev)
        else:
            wo, bsdf_weight, bsdf_pdf, is_delta, eta_s = mat.sample_mix(
                kinds, arr.materials, arr.checkers, hit.mat_id, hit.uv,
                gm, wi, u_lobe, u2, u2b, arr.hair_tables)
        if differentiable:
            # a delta lane (the faithful Marschner's sampled hair lobe)
            # keeps the sampled weight, its gradient through the sampled
            # direction included; a smooth lane's is f(wo) / sg(pdf(wo))
            wo = wo.detach()
            bsdf_pdf = bsdf_pdf.detach()
            f2, p2 = eval_pdf(wo)
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
        hit2 = query(scene_intersect, arr, next_ray, sort_rays=sort_rays,
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
                         emission_allowed=torch.zeros_like(active),
                         duv_dx=st.duv_dx, duv_dy=st.duv_dy), n_new

    def li(arr, pixel_idx, sample_idx, cam_to_world=None, uniforms=None):
        """cam_to_world: the camera's [4, 4] pose for this wave (motion
        blur), else the scene camera's; it reaches every use of the
        camera in the wave. uniforms: [N, n_uniform_dims], the primary
        samples (required when n_uniform_dims > 0)."""
        cam_l = cam if cam_to_world is None \
            else cam._replace(to_world=np.asarray(cam_to_world, np.float32))
        dev = pixel_idx.device
        n = pixel_idx.shape[0]
        pix = rng._u32(pixel_idx)
        px = (pix % cfg.width).to(torch.float32)
        py = (pix // cfg.width).to(torch.float32)
        if n_uniform_dims > 0:
            if uniforms is None or tuple(uniforms.shape) != (
                    n, n_uniform_dims):
                raise ValueError(f"li needs uniforms [{n}, "
                                 f"{n_uniform_dims}]")
            smp = UniformSampler(uniforms)
        else:
            smp = rng.Sampler(cfg.sampler, pixel_idx, sample_idx)
            if anti_rels:
                smp = _Mirrored(smp, anti_rels)
        jitter = smp.next_2d(DIM_CAM_POS)
        pos = torch.stack([px + jitter[..., 0], py + jitter[..., 1]], dim=-1)
        ap = aperture_sample(cam_l, smp)
        ray = sensors.sample_ray(cam_l, pos, ap)
        hit0 = scene_intersect(arr, ray, **params)
        duv_dx, duv_dy, ewa = camera_footprint(arr, cam_l, pos, ray, hit0,
                                               bitmaps, ap)
        state = PathState(
            active=torch.ones((n,), dtype=torch.bool, device=dev),
            ray_o=ray.o, ray_d=ray.d,
            throughput=torch.ones((n, 3), device=dev),
            li=torch.zeros((n, 3), device=dev),
            eta=torch.ones((n,), device=dev), hit=hit0,
            prev_bsdf_pdf=torch.zeros((n,), device=dev),
            prev_delta=torch.zeros((n,), dtype=torch.bool, device=dev),
            emission_allowed=torch.ones((n,), dtype=torch.bool, device=dev),
            duv_dx=duv_dx, duv_dy=duv_dy)
        n_rays = torch.tensor(float(n), device=dev)
        if differentiable:
            for depth in range(1, cfg.max_depth):
                stash = _QueryStash()
                state, n_new = checkpoint(
                    lambda st, d=depth, q=stash: body(arr, st, d, smp,
                                                      q.caller(), ewa,
                                                      cam_l),
                    state, use_reentrant=False, preserve_rng_state=False)
                n_rays = n_rays + n_new
            return _flush_pending(arr, state), pos, n_rays

        caps = stage_caps(n) if n_uniform_dims == 0 else [n]
        depth = 1
        st_full = state
        for si, w_ in enumerate(caps):
            next_cap = caps[si + 1] if si + 1 < len(caps) else 0
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
                sub, n_new = body(arr, sub, depth, ssmp, ewa=ewa, cam=cam_l)
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
        active: the environment where they escaped, an area light where
        they hit one."""
        li_acc = st.li
        if arr.env is None and arr.area is None:
            return li_acc
        lum_pdf = _pdf_emitter_hit(arr, cfg, st.hit, st.ray_d)
        w = torch.where(st.prev_delta, 1.0,
                        _mi_weight(st.prev_bsdf_pdf, lum_pdf))
        w = torch.where(st.emission_allowed, 1.0, w)
        if arr.env is not None:
            miss = st.active & ~st.hit.valid
            li_acc = li_acc + torch.where(
                miss[..., None],
                st.throughput * _env_radiance(arr, st.ray_d) * w[..., None],
                0.0)
        if arr.area is not None:
            le = _emitter_radiance_at_hit(arr, st.hit, -st.ray_d)
            li_acc = li_acc + torch.where(
                (st.active & st.hit.valid)[..., None],
                st.throughput * le * w[..., None], 0.0)
        return li_acc

    return li


def render(scene, seed: int = 0, spp: int | None = None,
           return_stats: bool = False, progress=None,
           flush_every: float = 0.0, flush_cb=None,
           checkpoint: str | None = None):
    """Full-frame render: one wave per sample index, splatted on the film.
    Returns the developed [H, W, 3] image (linear radiance).

    Under an open shutter (close > open, and an animated camera, animated
    or deformable meshes or animated instances) sample index s, seed
    aside, renders at t_s = open + (s + 1/2) / spp * (close - open): the
    triangles rebuilt at t_s (scene.rebuild_geo), the instances re-posed
    (scene.repose_inst) and the camera posed (scene.camera_anim), as the
    JAX package's render does; a resumed sample keeps its t_s.

    progress:    callable(done_spp, total_spp, seconds_of_this_wave,
                 n_rays) after each wave (the wave is complete: its ray
                 count is read back)
    flush_every: seconds between flush_cb(partial image) calls (the
                 reference's `-r sec` partial-image flush)
    checkpoint:  path of an .npz of (image, weight, next_sample, spp), the
                 JAX package's keys: loaded if present and made for the
                 same spp and film, saved after every wave. The
                 accumulators are explicit values, so a resumed render
                 equals an uninterrupted one bit for bit.
    The render's rays, camera samples and waves, its time and its rate
    are recorded in utils/stats (the CLI's --stats prints them)."""
    cfg = scene.config
    spp = spp if spp is not None else cfg.spp
    fl = scene.film
    arr = scene.arrays
    dev = arr.device
    n_pix = cfg.width * cfg.height
    li_fn = make_li_fn(scene)
    swz = block_swizzle(cfg.width, cfg.height)
    pixel_idx = torch.as_tensor(swz, device=dev) if swz is not None \
        else torch.arange(n_pix, device=dev)
    image, weight = film_mod.zeros(fl, dev)
    s_start = 0
    if checkpoint and os.path.exists(checkpoint):
        ck = np.load(checkpoint)
        if int(ck["spp"]) == spp and ck["image"].shape == tuple(image.shape):
            image = torch.as_tensor(ck["image"], device=dev)
            weight = torch.as_tensor(ck["weight"], device=dev)
            s_start = int(ck["next_sample"])
    total_rays = 0.0
    t_flush = time.time()
    stats.start_timer("render")
    blur = scene.shutter[1] > scene.shutter[0] and (
        scene.rebuild_geo is not None or scene.camera_anim is not None
        or scene.repose_inst is not None)
    for s in range(s_start, spp):
        t0 = time.time()
        arrs, ctw = arr, None
        if blur:
            t_s = scene.shutter[0] + (s + 0.5) / spp \
                * (scene.shutter[1] - scene.shutter[0])
            if scene.rebuild_geo is not None:
                arrs = scene.rebuild_geo(t_s)
            if scene.repose_inst is not None:
                arrs = scene.repose_inst(arrs, t_s)
            if scene.camera_anim is not None:
                ctw = scene.camera_anim.eval(t_s)
        sample_idx = torch.full((n_pix,), s + seed * 65536,
                                dtype=torch.int64, device=dev)
        radiance, pos, n_rays = li_fn(arrs, pixel_idx, sample_idx,
                                      cam_to_world=ctw)
        radiance = torch.nan_to_num(radiance, nan=0.0, posinf=0.0,
                                    neginf=0.0)
        image, weight = film_mod.splat_samples(fl, pos, radiance, image,
                                               weight)
        wave_rays = float(n_rays)
        total_rays += wave_rays
        if checkpoint:
            np.savez(checkpoint, image=image.cpu().numpy(),
                     weight=weight.cpu().numpy(), next_sample=s + 1,
                     spp=spp)
        now = time.time()
        if progress is not None:
            progress(s + 1, spp, now - t0, wave_rays)
        if flush_every > 0 and flush_cb is not None \
                and now - t_flush >= flush_every:
            flush_cb(film_mod.develop(image, weight))
            t_flush = now
    img = film_mod.develop(image, weight)
    # the JAX package's counters (reference: statistics.h, path.cpp:24
    # avgPathLength), read back after each wave and recorded here
    stats.stop_timer("Path tracer", "render", total_rays, "rays")
    stats.record("Path tracer", "Rays traced", total_rays)
    stats.record("Path tracer", "Camera samples", float(n_pix) * spp)
    stats.record("Path tracer", "Rays per camera sample", total_rays,
                 float(n_pix) * spp, kind="average")
    stats.record("Path tracer", "Sample waves", spp)
    if return_stats:
        return img, {"rays": total_rays}
    return img
