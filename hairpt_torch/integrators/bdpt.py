"""Bidirectional path tracer with Veach's MIS (port of
hairpt/integrators/bdpt.py; reference src/integrators/bdpt/* and libbidir,
src/libbidir/path.h PathVertex / PathEdge).

Eye and light subpaths are stacked vertex arrays (VPath: leading axis the
vertex index, then the lanes); every (s, t) strategy is evaluated for the
whole wave with one shadow query per strategy, weighted by the balance
heuristic through the pdf-ratio walk over the combined path (Veach 10.2,
with the four scoped pdfRev overrides of the reference's Path::miWeight).

Emitters: the area lights and the environment (envmap, sky, sunsky); the
delta lights are not sampled by bdpt, in this package as in the JAX
package (_light_group_probs renormalizes over the two groups). An
environment light subpath starts on a tangent disk of the scene's
bounding sphere with a delta emission direction (no s = 1 connections);
its pdfs are in solid angle. An eye subpath that escapes materializes an
environment endpoint for the s = 0 strategy. The camera vertex has the
per-pixel direction pdf W H / (A cos^3), and the t = 1 strategies splat
through sensors.camera_importance (the pinhole importance, for every
sensor kind, as in the JAX package) with film.splat_add_only. Delta BSDF
vertices keep their discrete pdfs; connections through them are skipped.
The light subpaths' and the shadow queries are Morton-sorted, which
changes no ray's answer. Sample dimensions are the JAX package's.
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple

import torch

from ..core import rng
from ..core.math import Frame, Ray, coordinate_system, dot, \
    frame_from_normal
from ..film import film as film_mod
from ..models import emitters as em
from ..models import sensors
from ..models.bsdf import registry as mat
from .common import frame, scene_intersect, scene_occluded
from .path import _env_radiance, _swept_params
from .photonmap import _scene_bsphere, _u32

INV_PI = 1.0 / math.pi
LUM = (0.212671, 0.715160, 0.072169)


class VPath(NamedTuple):
    """A subpath's vertices, leading axis the vertex index (D)."""
    p: torch.Tensor        # [D, N, 3]
    ns: torch.Tensor       # [D, N, 3] shading normal (world)
    ng: torch.Tensor       # [D, N, 3] geometric normal
    sh_s: torch.Tensor     # [D, N, 3] shading tangent
    sh_t: torch.Tensor     # [D, N, 3]
    wi: torch.Tensor       # [D, N, 3] world direction from the previous
    #                        vertex to this one
    beta: torch.Tensor     # [D, N, 3] throughput up to this vertex
    pdf_fwd: torch.Tensor  # [D, N] area pdf of generating the vertex
    pdf_rev: torch.Tensor  # [D, N] area pdf from the opposite direction
    delta: torch.Tensor    # [D, N] bool: sampled through a delta lobe
    valid: torch.Tensor    # [D, N]
    mat_id: torch.Tensor   # [D, N]
    uv: torch.Tensor       # [D, N, 2]
    emitter_id: torch.Tensor  # [D, N] (eye path: the emissive hit)
    is_env: torch.Tensor   # [D, N] environment endpoint (an escaped eye
    #                        vertex, an environment light's origin);
    #                        pdf_fwd there is in solid angle


def _g_term(pa, pb, nb):
    d = pb - pa
    d2 = torch.clamp(torch.sum(d * d, -1), min=1e-12)
    dist = torch.sqrt(d2)
    return torch.abs(torch.sum(nb * (d / dist[..., None]), -1)) / d2, \
        d / dist[..., None], dist


def _to_area(pdf_w, p_from, p_to, n_to):
    """Solid angle -> area measure at the target vertex."""
    conv, _, _ = _g_term(p_from, p_to, n_to)
    return pdf_w * conv


def _vertex_frame(path: VPath, i: int) -> Frame:
    return Frame(s=path.sh_s[i], t=path.sh_t[i], n=path.ns[i])


def _bsdf_eval_pdf(scene, arr, path: VPath, i: int, wo_world):
    """(f cos, pdf_w, pdf_w of the reverse direction) at vertex i for the
    outgoing wo_world."""
    fr = _vertex_frame(path, i)
    wi_l = fr.to_local(-path.wi[i])
    wo_l = fr.to_local(wo_world)
    gm = mat.gather(arr.materials, arr.checkers, path.mat_id[i], path.uv[i])
    f, pdf = mat.eval_pdf_mix(scene.active_kinds, arr.materials,
                              arr.checkers, path.mat_id[i], path.uv[i], gm,
                              wi_l, wo_l, arr.hair_tables)
    _, pdf_rev = mat.eval_pdf_mix(scene.active_kinds, arr.materials,
                                  arr.checkers, path.mat_id[i], path.uv[i],
                                  gm, wo_l, wi_l, arr.hair_tables)
    return f, pdf, pdf_rev


def _trace_subpath(scene, arr, o0, d0, beta0, pdf_fwd1_w, n_steps: int, smp,
                   dim0: int, sort_rays: bool):
    """March a subpath from (o0, d0): stacked vertex fields of vertices 1
    .. n_steps (the caller owns vertex 0). pdf_fwd1_w: the solid-angle pdf
    of d0 (converted to area at vertex 1)."""
    cfg = scene.config
    n = o0.shape[0]
    dev = o0.device
    params = _swept_params(cfg)
    z = torch.zeros((n,), device=dev)
    o, d, beta, pdf_dir_w, prev_p = o0, d0, beta0, pdf_fwd1_w, o0
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    verts = []
    for step in range(n_steps):
        r = Ray(o=o, d=d, mint=z, maxt=torch.where(alive, float("inf"), 0.0))
        hit = scene_intersect(arr, r, sort_rays=sort_rays, **params)
        landed = alive & hit.valid
        escaped = alive & ~hit.valid   # the eye path's environment endpoint
        two = arr.materials.twosided[torch.clamp(hit.mat_id, min=0).long()]
        flip = (two & (dot(hit.sh_n, -d) < 0))[..., None]
        sh_n = torch.where(flip, -hit.sh_n, hit.sh_n)
        sh_t = torch.where(flip, -hit.sh_t, hit.sh_t)
        geo_n = torch.where(flip, -hit.geo_n, hit.geo_n)
        fr = frame(hit)._replace(n=sh_n, t=sh_t)
        pdf_fwd = _to_area(pdf_dir_w, prev_p, hit.p, sh_n)
        gm = mat.gather(arr.materials, arr.checkers, hit.mat_id, hit.uv)
        dims = dim0 + step * 16
        wi_l = fr.to_local(-d)
        wo_l, w_b, pdf_b, is_delta, _ = mat.sample_mix(
            scene.active_kinds, arr.materials, arr.checkers, hit.mat_id,
            hit.uv, gm, wi_l, smp.next_1d(dims), smp.next_2d(dims + 1),
            smp.next_2d(dims + 3), arr.hair_tables)
        wo_world = fr.to_world(wo_l)
        # the reverse pdf: sampling wi from wo at this vertex; a delta lobe
        # keeps its discrete pdf (solid angle here: the caller converts at
        # the previous vertex, whose normal it owns)
        _, pdf_rev_w = mat.eval_pdf_mix(
            scene.active_kinds, arr.materials, arr.checkers, hit.mat_id,
            hit.uv, gm, wo_l, wi_l, arr.hair_tables)
        pdf_rev_w = torch.where(is_delta, pdf_b, pdf_rev_w)
        verts.append(dict(
            p=hit.p, ns=sh_n, ng=geo_n, sh_s=fr.s, sh_t=fr.t, wi=d,
            beta=torch.where((landed | escaped)[..., None], beta, 0.0),
            # environment endpoints keep the solid-angle direction pdf
            pdf_fwd=torch.where(escaped, pdf_dir_w,
                                torch.where(landed, pdf_fwd, 0.0)),
            pdf_rev_w=torch.where(landed, pdf_rev_w, 0.0),
            # escaped endpoints are delta, so the unsamplable (1, t - 1)
            # NEE-to-environment hypothetical leaves the MIS sum
            delta=(is_delta & landed) | escaped, valid=landed,
            mat_id=hit.mat_id, uv=hit.uv,
            emitter_id=torch.where(landed, hit.emitter_id, -1),
            is_env=escaped))
        o = hit.p + geo_n * torch.where(dot(wo_world, geo_n) > 0,
                                        cfg.ray_eps, -cfg.ray_eps)[..., None]
        d = wo_world
        beta = beta * w_b
        pdf_dir_w = pdf_b
        alive = landed & (torch.amax(torch.abs(w_b), -1) > 0)
        prev_p = hit.p
    keys = ("p", "ns", "ng", "sh_s", "sh_t", "wi", "beta", "pdf_fwd",
            "pdf_rev_w", "delta", "valid", "mat_id", "uv", "emitter_id",
            "is_env")
    if not verts:
        return None
    return {k: torch.stack([v[k] for v in verts]) for k in keys}


def _light_group_probs(scene, arr):
    """(p_env, p_area): the light subpath's group probabilities,
    cfg.nee_probs renormalized over the groups bdpt samples (the delta
    lights are not among them)."""
    pe_c, pa_c, _ = scene.config.nee_probs
    has_env = arr.env is not None
    has_area = arr.area is not None
    if has_env and has_area:
        tot = max(pe_c + pa_c, 1e-9)
        return pe_c / tot, pa_c / tot
    if has_env:
        return 1.0, 0.0
    return 0.0, 1.0


def _cat(v0, rest):
    return v0[None] if rest is None else torch.cat([v0[None], rest], 0)


def _vpath(v0: dict, rest, d_max: int) -> VPath:
    """vertex 0 (v0) and the traced vertices as a VPath, its pdf_rev
    filled by _fill_pdf_rev."""
    f = {k: _cat(v0[k], None if rest is None else rest[k])
         for k in VPath._fields if k != "pdf_rev"}
    path = VPath(pdf_rev=torch.zeros_like(f["pdf_fwd"]), **f)
    if rest is None:
        return path
    return _fill_pdf_rev(path, rest["pdf_rev_w"], d_max)


def generate_paths(scene, arr, pixel_idx, sample_idx, t_max: int,
                   s_max: int):
    """The eye subpath (t_max vertices, the camera at index 0) and the
    light subpath (s_max vertices, the emitter point at index 0)."""
    cfg = scene.config
    cam = scene.camera
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    smp = rng.Sampler(cfg.sampler, pixel_idx, sample_idx)

    # ---- the eye subpath ----
    px = (pixel_idx % cfg.width).to(torch.float32)
    py = (pixel_idx // cfg.width).to(torch.float32)
    jit2 = smp.next_2d(0)
    pos = torch.stack([px + jit2[..., 0], py + jit2[..., 1]], -1)
    ray = sensors.sample_ray(cam, pos, None)
    # the pinhole direction pdf per pixel, W H / (A cos^3): one eye path is
    # traced per pixel (the per-film 1 / (A cos^3) under-counts by W H and
    # crushes every MIS weight against the t = 1 hypothetical)
    m4 = torch.as_tensor(cam.to_world, device=dev)
    fwd = m4[:3, 2]
    cos_cam = torch.sum(ray.d * fwd, -1)
    area = 4.0 * cam.tan_half_fov ** 2 / cam.aspect
    pdf_cam_w = (cfg.width * cfg.height) \
        / torch.clamp(area * cos_cam ** 3, min=1e-9)
    ev = _trace_subpath(scene, arr, ray.o, ray.d,
                        torch.ones((n, 3), device=dev), pdf_cam_w, t_max - 1,
                        smp, 100, sort_rays=False)
    z3 = torch.zeros((n, 3), device=dev)
    zb = torch.zeros((n,), dtype=torch.bool, device=dev)
    eye = _vpath(dict(
        p=m4[:3, 3].expand(n, 3), ns=fwd.expand(n, 3), ng=fwd.expand(n, 3),
        sh_s=z3, sh_t=z3, wi=z3, beta=torch.ones((n, 3), device=dev),
        pdf_fwd=torch.ones((n,), device=dev),
        # the pinhole camera vertex has pdfPos = 1 and is not delta
        # (PBRT's convention), so t = 1 splatting competes in MIS
        delta=zb, valid=~zb,
        mat_id=torch.zeros((n,), dtype=torch.int32, device=dev),
        uv=torch.zeros((n, 2), device=dev),
        emitter_id=torch.full((n,), -1, dtype=torch.int32, device=dev),
        is_env=zb), ev, t_max)

    # ---- the light subpath ----
    from ..core import warps
    pe, pa = _light_group_probs(scene, arr)
    u_sel = smp.next_1d(300)
    u_pos = smp.next_2d(301)
    u_dir = smp.next_2d(303)
    u_grp = smp.next_1d(305)
    grp_env = u_grp < pe

    q = torch.zeros((n, 3), device=dev)
    n_l = z3.clone()
    n_l[:, 2] = 1.0
    d_emit = n_l.clone()
    pdf_fwd0 = torch.ones((n,), device=dev)
    beta0_v = torch.zeros((n, 3), device=dev)
    beta1 = torch.zeros((n, 3), device=dev)
    pdf_dir_w = torch.ones((n,), device=dev)
    li = torch.full((n,), -1, dtype=torch.int64, device=dev)
    o_l = q
    delta0 = zb

    if arr.area is not None and pa > 0:
        al = arr.area
        li_a, p_sel = em.sample_cdf(al.cdf, u_sel)
        prob_l = p_sel * pa
        su = torch.sqrt(torch.clamp(u_pos[..., 0], min=1e-12))
        b0 = 1.0 - su
        b1 = u_pos[..., 1] * su
        q_a = al.p0[li_a] + al.e1[li_a] * b0[..., None] \
            + al.e2[li_a] * b1[..., None]
        n_a = al.n[li_a]
        pdf_pos = prob_l / torch.clamp(al.area[li_a], min=1e-12)
        le = al.radiance[li_a]
        # the cosine-weighted emission direction of a diffuse area light
        # (area.cpp sampleDirection)
        d_local = warps.square_to_cosine_hemisphere(u_dir)
        d_a = frame_from_normal(n_a).to_world(d_local)
        pdf_dir_a = torch.clamp(d_local[..., 2], min=1e-9) * INV_PI
        b1_a = le * (torch.abs(d_local[..., 2]) / torch.clamp(
            pdf_pos * pdf_dir_a, min=1e-20))[..., None]
        m = (~grp_env)[..., None]
        q = torch.where(m, q_a, q)
        n_l = torch.where(m, n_a, n_l)
        d_emit = torch.where(m, d_a, d_emit)
        pdf_fwd0 = torch.where(~grp_env, pdf_pos, pdf_fwd0)
        beta0_v = torch.where(m, le / torch.clamp(pdf_pos, min=1e-20)[..., None],
                              beta0_v)
        beta1 = torch.where(m, b1_a, beta1)
        pdf_dir_w = torch.where(~grp_env, pdf_dir_a, pdf_dir_w)
        li = torch.where(~grp_env, li_a, li)
        o_l = torch.where(m, q_a + n_a * cfg.ray_eps, o_l)

    env_origin = arr.env is not None and pe > 0
    if env_origin:
        # the environment's origin: an importance-sampled direction and a
        # tangent-disk point (PBRT's InfiniteAreaLight); pdf_fwd of vertex
        # 0 is the solid-angle direction density times the group
        # probability, and its emission direction is delta
        center, radius = _scene_bsphere(arr)
        d_env, le_env, pdf_env = em.env_sample(arr.env, u_pos)
        d_e = -d_env
        disk = warps.square_to_uniform_disk_concentric(u_dir) * radius
        s_a, t_a = coordinate_system(d_e)
        o_e = center - d_e * radius * 1.5 + s_a * disk[..., 0:1] \
            + t_a * disk[..., 1:2]
        b1_e = le_env * (math.pi * radius * radius / torch.clamp(
            pdf_env * pe, min=1e-20))[..., None]
        m = grp_env[..., None]
        q = torch.where(m, o_e, q)
        n_l = torch.where(m, d_e, n_l)
        d_emit = torch.where(m, d_e, d_emit)
        pdf_fwd0 = torch.where(grp_env, pdf_env * pe, pdf_fwd0)
        beta0_v = torch.where(m, 0.0, beta0_v)
        beta1 = torch.where(m, b1_e, beta1)
        li = torch.where(grp_env, -1, li)
        o_l = torch.where(m, o_e, o_l)
        delta0 = delta0 | grp_env
        inv_pi_r2 = 1.0 / (math.pi * radius * radius)
    else:
        grp_env = zb

    lv = _trace_subpath(scene, arr, o_l, d_emit, beta1, pdf_dir_w, s_max - 1,
                        smp, 400, sort_rays=True)
    light = _vpath(dict(
        p=q, ns=n_l, ng=n_l, sh_s=z3, sh_t=z3, wi=z3, beta=beta0_v,
        pdf_fwd=pdf_fwd0, delta=delta0, valid=~zb,
        mat_id=torch.zeros((n,), dtype=torch.int32, device=dev),
        uv=torch.zeros((n, 2), device=dev), emitter_id=li.to(torch.int32),
        is_env=grp_env), None if lv is None else dict(
            lv, is_env=torch.zeros_like(lv["valid"])), s_max)
    if env_origin and lv is not None:
        # the environment lanes' measures: vertex 1's area pdf is cos / (pi
        # R^2) (the disk's position density projected to the first hit,
        # PBRT's Vertex::PdfLight for infinite lights); vertex 0's reverse
        # pdf (the eye side escaping to the environment) stays solid angle
        cos1 = torch.abs(torch.sum(light.ns[1] * d_emit, -1))
        on = grp_env & light.valid[1]
        pdf_fwd = light.pdf_fwd.clone()
        pdf_fwd[1] = torch.where(on, cos1 * inv_pi_r2, light.pdf_fwd[1])
        pdf_rev = light.pdf_rev.clone()
        pdf_rev[0] = torch.where(on, lv["pdf_rev_w"][0], light.pdf_rev[0])
        light = light._replace(pdf_fwd=pdf_fwd, pdf_rev=pdf_rev)
    return eye, light


def _fill_pdf_rev(path: VPath, pdf_rev_w, d_max: int) -> VPath:
    """pdf_rev[i]: the reverse solid-angle pdf sampled at vertex i + 1,
    converted to area at vertex i."""
    pr = path.pdf_rev.clone()
    for i in range(d_max - 1):
        src = i + 1
        conv = _to_area(pdf_rev_w[i], path.p[src], path.p[i], path.ns[i])
        pr[i] = torch.where(path.valid[src], conv, 0.0)
    return path._replace(pdf_rev=pr)


def _light_origin_pdfs(scene, arr, p_from, light_p, light_n, emitter_id):
    """(the area pdf of the light point, with the area group's selection
    probability; the solid-angle pdf of its emission towards p_from; that
    direction; the squared distance)."""
    al = arr.area
    _, pa = _light_group_probs(scene, arr)
    power = al.area * (al.radiance @ al.radiance.new_tensor(LUM))
    prob = power * (pa / torch.clamp(torch.sum(power), min=1e-12))
    li = torch.clamp(emitter_id, min=0).long()
    pdf_pos = prob[li] / torch.clamp(al.area[li], min=1e-12)
    d = p_from - light_p
    d2 = torch.clamp(torch.sum(d * d, -1), min=1e-12)
    dirn = d / torch.sqrt(d2)[..., None]
    pdf_dir_w = torch.clamp(torch.sum(light_n * dirn, -1), min=0.0) * INV_PI
    return pdf_pos, pdf_dir_w, dirn, d2


def render_bdpt(scene, spp: int = 8, seed: int = 0, s_max: int = 4,
                t_max: int = 4, strategies=None, progress=None):
    """The BDPT render: the developed [H, W, 3] image plus the t = 1
    splats. strategies: an optional set of (s, t) pairs; only those
    contribute (the MIS weights are unchanged). Lanes in pixel order,
    sample index s + seed * 65536. progress: callable(done_spp, total_spp,
    seconds, 0) per wave."""
    cfg = scene.config
    arr = scene.arrays
    cam = scene.camera
    fl = scene.film
    dev = arr.device
    n = cfg.width * cfg.height
    params = _swept_params(cfg)
    if arr.area is None and arr.env is None:
        raise ValueError("bdpt needs an area or environment emitter")
    pixel_idx = torch.arange(n, device=dev)
    zero = torch.zeros((n,), device=dev)
    pix_pos = torch.stack([(pixel_idx % cfg.width).to(torch.float32) + 0.5,
                           (pixel_idx // cfg.width).to(torch.float32) + 0.5],
                          -1)

    def use(s, t):
        return strategies is None or (s, t) in strategies

    def shadow(p, ng, dirn, dist, ok):
        o = p + ng * torch.where(dot(dirn, ng) > 0, cfg.ray_eps,
                                 -cfg.ray_eps)[..., None]
        return scene_occluded(arr, Ray(o=o, d=dirn, mint=zero, maxt=torch.where(
            ok, dist - 2 * cfg.ray_eps, 0.0)), sort_rays=True, **params)

    def one_wave(sample_id, image, weight, splat_img):
        eye, light = generate_paths(scene, arr, pixel_idx,
                                    torch.full((n,), sample_id,
                                               dtype=torch.int64,
                                               device=dev), t_max, s_max)
        li_acc = torch.zeros((n, 3), device=dev)

        # ---- s = 0: the eye path hits an emitter or escapes ----
        for t in range(2, t_max + 1):
            if t - 1 > cfg.max_depth or not use(0, t):
                continue
            zi = t - 1
            w = _mis_weight(scene, arr, eye, light, 0, t, s_max=s_max,
                            t_max=t_max)
            if arr.area is not None:
                em_id = eye.emitter_id[zi]
                on = eye.valid[zi] & (em_id >= 0) \
                    & (dot(eye.ng[zi], -eye.wi[zi]) > 0)
                le = arr.area.radiance[torch.clamp(em_id, min=0).long()]
                li_acc = li_acc + torch.where(
                    on[..., None], eye.beta[zi] * le * w[..., None], 0.0)
            if arr.env is not None:
                # the escaped eye endpoint: the environment's radiance
                le_e = _env_radiance(arr, eye.wi[zi])
                li_acc = li_acc + torch.where(
                    eye.is_env[zi][..., None],
                    eye.beta[zi] * le_e * w[..., None], 0.0)

        # ---- s >= 1, t >= 2: connections ----
        for s in range(1, s_max + 1):
            for t in range(2, t_max + 1):
                if s + t - 1 > cfg.max_depth or not use(s, t):
                    continue
                ys, zi = s - 1, t - 1
                ok = eye.valid[zi] & light.valid[ys] & ~eye.delta[zi] \
                    & ~light.delta[ys]
                _, dirn, dist = _g_term(eye.p[zi], light.p[ys],
                                        light.ns[ys])
                f_e, _, _ = _bsdf_eval_pdf(scene, arr, eye, zi, dirn)
                if s == 1:
                    cos_l = torch.clamp(torch.sum(light.ns[ys] * (-dirn),
                                                  -1), min=0.0)
                    f_l = light.beta[ys] * cos_l[..., None]
                else:
                    f_l_b, _, _ = _bsdf_eval_pdf(scene, arr, light, ys,
                                                 -dirn)
                    f_l = light.beta[ys] * f_l_b
                d2 = torch.clamp(dist * dist, min=1e-12)
                c = eye.beta[zi] * f_e * f_l / d2[..., None]
                ok = ok & (torch.amax(torch.abs(c), -1) > 0)
                occ = shadow(eye.p[zi], eye.ng[zi], dirn, dist, ok)
                w = _mis_weight(scene, arr, eye, light, s, t, conn_dir=dirn,
                                conn_dist=dist, s_max=s_max, t_max=t_max)
                li_acc = li_acc + torch.where((ok & ~occ)[..., None],
                                              c * w[..., None], 0.0)

        # ---- t = 1: the light path splatted to the camera ----
        for s in range(2, s_max + 1):
            if s > cfg.max_depth or not use(s, 1):
                continue
            ys = s - 1
            film_pos, we, dist, d_cam, vis_ok = sensors.camera_importance(
                cam, light.p[ys])
            ok = light.valid[ys] & ~light.delta[ys] & vis_ok
            f_l, _, _ = _bsdf_eval_pdf(scene, arr, light, ys, d_cam)
            c = light.beta[ys] * f_l * (we / torch.clamp(
                dist * dist, min=1e-12))[..., None]
            ok = ok & (torch.amax(torch.abs(c), -1) > 0)
            occ = shadow(light.p[ys], light.ng[ys], d_cam, dist, ok)
            w = _mis_weight(scene, arr, eye, light, s, 1, conn_dir=-d_cam,
                            conn_dist=dist, s_max=s_max, t_max=t_max)
            val = torch.where((ok & ~occ)[..., None], c * w[..., None], 0.0)
            splat_img = film_mod.splat_add_only(fl, film_pos, val / spp,
                                                splat_img)
        image, weight = film_mod.splat_samples(fl, pix_pos, li_acc, image,
                                               weight)
        return image, weight, splat_img

    image, weight = film_mod.zeros(fl, dev)
    splat_img = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    for si in range(spp):
        t0 = time.time()
        image, weight, splat_img = one_wave(_u32(si + seed * 65536), image,
                                            weight, splat_img)
        if progress is not None:
            progress(si + 1, spp, time.time() - t0, 0.0)
    return film_mod.develop(image, weight) + splat_img


def _mis_weight(scene, arr, eye: VPath, light: VPath, s: int, t: int,
                conn_dir=None, conn_dist=None, s_max=None, t_max=None):
    """The balance-heuristic weight of strategy (s, t): the pdf-ratio walk
    of Veach 10.2 with the four scoped pdfRev overrides at the connection
    (the reference's Path::miWeight, PBRT's MISWeight). conn_dir points
    from the eye vertex to the light vertex. The denominator counts only
    the strategies the loops generate under (s_max, t_max): t' = 1 needs
    2 <= s' <= s_max, s' = 0 needs t' <= t_max, a connection s' <= s_max
    and t' <= t_max."""
    n = eye.p.shape[1]
    dev = eye.p.device
    zi = t - 1
    ys = s - 1
    zeros = torch.zeros((n,), device=dev)
    nob = torch.zeros((n,), dtype=torch.bool, device=dev)

    # ---- the reverse pdfs recomputed at the junction ----
    # pt.pdf_rev: generating the eye endpoint from the light side
    if s == 0:
        # from the light itself: the area light's position pdf, or the
        # environment's solid-angle direction density times the group
        # probability at an escaped endpoint
        if arr.area is not None:
            pdf_pos, _, _, _ = _light_origin_pdfs(
                scene, arr, eye.p[max(zi - 1, 0)], eye.p[zi], eye.ns[zi],
                eye.emitter_id[zi])
        else:
            pdf_pos = zeros
        if arr.env is not None:
            pe, _ = _light_group_probs(scene, arr)
            pdf_env = em.env_pdf(arr.env, eye.wi[zi]) * pe
            pt_rev = torch.where(eye.is_env[zi], pdf_env, pdf_pos)
        else:
            pt_rev = pdf_pos
    elif s == 1:
        # the light vertex emits towards the eye endpoint (area lights
        # only: environment origins are delta, never in s = 1)
        if arr.area is not None:
            _, pdf_dir_w, dirn, d2 = _light_origin_pdfs(
                scene, arr, eye.p[zi], light.p[ys], light.ns[ys],
                light.emitter_id[ys])
            pt_rev = pdf_dir_w * torch.abs(torch.sum(eye.ns[zi] * dirn,
                                                     -1)) / d2
        else:
            pt_rev = zeros
    else:
        # the light vertex scattering towards the eye endpoint
        _, pdf_w_fwd, _ = _bsdf_eval_pdf(scene, arr, light, ys, -conn_dir)
        pt_rev = _to_area(pdf_w_fwd, light.p[ys], eye.p[zi], eye.ns[zi])

    # pt_minus.pdf_rev: the eye endpoint scattering backwards
    if s == 0:
        # the emission pdf from the hit emitter towards z_{t-2}; an
        # environment endpoint's tangent-disk density projected to
        # z_{t-2}: cos / (pi R^2)
        if arr.area is not None:
            _, pdf_dir_w, dirn, d2 = _light_origin_pdfs(
                scene, arr, eye.p[zi - 1], eye.p[zi], eye.ns[zi],
                eye.emitter_id[zi])
            ptm_area = pdf_dir_w * torch.abs(torch.sum(eye.ns[zi - 1] * dirn,
                                                       -1)) / d2
        else:
            ptm_area = zeros
        if arr.env is not None:
            _, radius = _scene_bsphere(arr)
            cos_prev = torch.abs(torch.sum(eye.ns[zi - 1] * eye.wi[zi], -1))
            ptm_env = cos_prev / (math.pi * radius * radius)
            ptm_rev = torch.where(eye.is_env[zi], ptm_env, ptm_area)
        else:
            ptm_rev = ptm_area
    else:
        fr = _vertex_frame(eye, zi)
        gm = mat.gather(arr.materials, arr.checkers, eye.mat_id[zi],
                        eye.uv[zi])
        _, pdf_w = mat.eval_pdf_mix(scene.active_kinds, arr.materials,
                                    arr.checkers, eye.mat_id[zi], eye.uv[zi],
                                    gm, fr.to_local(conn_dir),
                                    fr.to_local(-eye.wi[zi]),
                                    arr.hair_tables)
        ptm_rev = _to_area(pdf_w, eye.p[zi], eye.p[zi - 1], eye.ns[zi - 1])

    # qs.pdf_rev and qs_minus.pdf_rev (s >= 1)
    if s >= 1:
        fr = _vertex_frame(eye, zi)
        gm = mat.gather(arr.materials, arr.checkers, eye.mat_id[zi],
                        eye.uv[zi])
        _, pdf_w = mat.eval_pdf_mix(scene.active_kinds, arr.materials,
                                    arr.checkers, eye.mat_id[zi], eye.uv[zi],
                                    gm, fr.to_local(-eye.wi[zi]),
                                    fr.to_local(conn_dir), arr.hair_tables)
        if t == 1:
            # the camera endpoint: the per-pixel directional importance
            # pdf, generate_paths' pdf_cam_w
            cam = scene.camera
            fwd = torch.as_tensor(cam.to_world, device=dev)[:3, 2]
            cosc = torch.abs(torch.sum(conn_dir * fwd, -1))
            area = 4.0 * cam.tan_half_fov ** 2 / cam.aspect
            pdf_w = (scene.config.width * scene.config.height) \
                / torch.clamp(area * cosc ** 3, min=1e-9)
        qs_rev = _to_area(pdf_w, eye.p[zi], light.p[ys], light.ns[ys])
        if s >= 2:
            fr_l = _vertex_frame(light, ys)
            gm_l = mat.gather(arr.materials, arr.checkers, light.mat_id[ys],
                              light.uv[ys])
            _, pdf_w2 = mat.eval_pdf_mix(
                scene.active_kinds, arr.materials, arr.checkers,
                light.mat_id[ys], light.uv[ys], gm_l,
                fr_l.to_local(-conn_dir), fr_l.to_local(-light.wi[ys]),
                arr.hair_tables)
            qsm_rev = _to_area(pdf_w2, light.p[ys], light.p[ys - 1],
                               light.ns[ys - 1])

    # ---- the pdf-ratio walks ----
    def remap(x):
        return torch.where(x > 0, x, 1.0)

    s_cap = s_max if s_max is not None else 10 ** 9
    t_cap = t_max if t_max is not None else 10 ** 9
    sum_ri = zeros
    # eye side, i = zi down to 1: the hypothetical strategy (s + t - i, i)
    ri = torch.ones((n,), device=dev)
    for i in range(zi, 0, -1):
        rev = pt_rev if i == zi else (ptm_rev if i == zi - 1
                                      else eye.pdf_rev[i])
        ri = ri * remap(rev) / remap(eye.pdf_fwd[i])
        sp = s + t - i
        if not (sp <= s_cap and (i >= 2 or sp >= 2)):
            continue
        nodelta = ~eye.delta[i] & ~(eye.delta[i - 1] if i - 1 > 0 else nob)
        sum_ri = sum_ri + torch.where(nodelta & eye.valid[i], ri, 0.0)
    # light side, i = ys down to 0: the hypothetical strategy (i, s + t - i)
    if s >= 1:
        ri = torch.ones((n,), device=dev)
        for i in range(ys, -1, -1):
            rev = qs_rev if i == ys else (qsm_rev if i == ys - 1
                                          else light.pdf_rev[i])
            ri = ri * remap(rev) / remap(light.pdf_fwd[i])
            if s + t - i > t_cap:
                continue
            nodelta = ~light.delta[i] & ~(light.delta[i - 1] if i >= 1
                                          else nob)
            if i == 0:
                # the i = 0 term is the s' = 0 hypothetical (the eye path
                # generates everything and escapes to the environment):
                # samplable for environment origins, though they are delta
                # for connections
                nodelta = nodelta | light.is_env[0]
            sum_ri = sum_ri + torch.where(nodelta & light.valid[i], ri, 0.0)
    return 1.0 / (1.0 + sum_ri)
