"""Path-space Metropolis light transport with the full mutation set (port
of hairpt/integrators/mlt.py; reference src/integrators/mlt/*, libbidir
mut_*.h).

Markov chains over light transport trajectories: the chain state is a
camera trajectory with its first K = 4 surface vertices stored (position,
frames, material, the bounce weights w_k = f cos / p and decision pdfs
p_k), the emission collected at each of them and at each escape, and a
w_rest bucket for everything deeper, which mutations scale by throughput
ratios. The chains target lum(W) q, the forward path tracer's value times
its density. Mutations:

  lens      a Kelemen large step (a fresh trajectory) or a Gaussian pixel
            move that re-traces x1 and reattaches at the kept x2
            (mut_lens.h);
  caustic   E-D-S-D: the light-side direction x3 -> x2 perturbed, the
            chain traced back toward the eye and y1 reprojected through
            the sensor; the Jacobian |d(A3, d) / d(pix, w0)| by finite
            differences of the chain map, a 4 x 4 determinant
            (mut_caustic.h);
  manifold  E-D-D-S-D: the direction at x1 perturbed, y2 landed, the
            specular x3 re-solved between y2 and the fixed x4 by
            manifold.walk, the generalized geometric term as Jacobian
            (mut_manifold.h);
  bidir     one interior vertex regrown (even rounds) or two (odd
            rounds), reconnected to the kept suffix (mut_bidir.h);
  mchain    E-S-D-S-D: the pixel moved and both specular chains re-traced
            with their kept branches (mut_mchain.h).

Every query goes through common.scene_intersect / scene_occluded (the
hair through kernels A and B under 'tiled', the triangles through kernel
F); the rest is per-lane algebra, each BSDF evaluation over only the
kinds its lanes' materials reach (path.live_kinds, one host sync). The JAX package's lax.scan over the
bounces and the rounds are Python loops here, its lax.cond on the round
parity a branch on r. Salts and seeds are the JAX package's uint32
values, mod 2^32.
"""
from __future__ import annotations

import math
import time
import weakref
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..core import rng
from ..core.math import Frame, Ray, coordinate_system, dot, normalize
from ..film import film as film_mod
from ..models import sensors
from ..models.bsdf import registry as mat
from . import manifold
from .manifold import _norm
from .common import frame, scene_intersect, scene_occluded
from .path import _env_radiance, _swept_params, kind_rows, live_kinds
from .pssmlt import pick_from_pool

LUM = np.array([0.212671, 0.715160, 0.072169], np.float32)
K = 4                       # stored vertices x1..x4
DELTA_CHAIN_KINDS = (mat.CONDUCTOR, mat.DIELECTRIC, mat.THINDIELECTRIC)
PHASES = ("lens", "caustic", "manifold", "bidir", "mchain")
M32 = rng.M32


def _lum(c):
    return c @ torch.as_tensor(LUM, device=c.device)


def _san(a):
    return torch.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)


class VertexRec(NamedTuple):
    """A stored surface vertex (enough to evaluate its BSDF again)."""
    p: torch.Tensor       # [N, 3]
    geo_n: torch.Tensor   # [N, 3]
    sh_n: torch.Tensor    # [N, 3] (unflipped; twosided applied at eval)
    sh_s: torch.Tensor
    sh_t: torch.Tensor
    mat_id: torch.Tensor  # [N] int32
    uv: torch.Tensor      # [N, 2]
    valid: torch.Tensor   # [N] bool
    em_id: torch.Tensor   # [N] area-light id at the vertex, -1 = none


class PathRec(NamedTuple):
    """The chain state. The vertex fields carry a leading K axis (v.p is
    [K, N, 3]); w[k] the bounce weight at vertex k, pdf[k] the density of
    its direction / lobe decision, w_em[k] the emission collected at
    vertex k, w_env[k] the environment when segment k escaped (segment 0
    the camera ray), w_rest everything from vertex K on."""
    pix: torch.Tensor       # [N, 2]
    v: VertexRec            # fields [K, N, ...]
    v_delta: torch.Tensor   # [K, N] the sampled lobe was delta
    v_choice: torch.Tensor  # [K, N] delta branch 0 reflect, 1 transmit
    wo: torch.Tensor        # [K, N, 3] sampled world direction
    w: torch.Tensor         # [K, N, 3]
    pdf: torch.Tensor       # [K, N]
    w_em: torch.Tensor      # [K, N, 3]
    w_env: torch.Tensor     # [K, N, 3]
    w_rest: torch.Tensor    # [N, 3]


def traj_w(t: PathRec):
    return torch.sum(t.w_em, 0) + torch.sum(t.w_env, 0) + t.w_rest


def _map_v(fn, *vs) -> VertexRec:
    return VertexRec(*[fn(*xs) for xs in zip(*vs)])


def _lane_gather(t: PathRec, pick) -> PathRec:
    """Index the lane axis: axis 0 of pix and w_rest, axis 1 of the
    K-leading fields."""
    pick = pick.long()

    def g1(a):
        return a[:, pick]
    return PathRec(pix=t.pix[pick], v=_map_v(g1, t.v),
                   v_delta=g1(t.v_delta), v_choice=g1(t.v_choice),
                   wo=g1(t.wo), w=g1(t.w), pdf=g1(t.pdf), w_em=g1(t.w_em),
                   w_env=g1(t.w_env), w_rest=t.w_rest[pick])


def _lane_select(mask, a_t: PathRec, b_t: PathRec) -> PathRec:
    """Per lane a where mask [N] else b."""
    n = mask.shape[0]

    def s0(a, b):
        return torch.where(mask.reshape((n,) + (1,) * (a.ndim - 1)), a, b)

    def s1(a, b):
        return torch.where(mask.reshape((1, n) + (1,) * (a.ndim - 2)), a, b)

    return PathRec(pix=s0(a_t.pix, b_t.pix), v=_map_v(s1, a_t.v, b_t.v),
                   v_delta=s1(a_t.v_delta, b_t.v_delta),
                   v_choice=s1(a_t.v_choice, b_t.v_choice),
                   wo=s1(a_t.wo, b_t.wo), w=s1(a_t.w, b_t.w),
                   pdf=s1(a_t.pdf, b_t.pdf), w_em=s1(a_t.w_em, b_t.w_em),
                   w_env=s1(a_t.w_env, b_t.w_env),
                   w_rest=s0(a_t.w_rest, b_t.w_rest))


def _vtx(t: PathRec, k: int) -> VertexRec:
    return _map_v(lambda a: a[k], t.v)


def _at(a, items: dict):
    """a with a[k] = value for each (k, value) of items (a copy)."""
    out = a.clone()
    for k, val in items.items():
        out[k] = val
    return out


def _set_vtx(v: VertexRec, items: dict) -> VertexRec:
    """v with vertex k replaced by the VertexRec items[k]."""
    return VertexRec(*[_at(a, {k: getattr(new, f) for k, new in
                               items.items()})
                       for f, a in zip(VertexRec._fields, v)])


def _hit_to_vertex(hit, ok) -> VertexRec:
    okn = ok[..., None]
    return VertexRec(p=torch.where(okn, hit.p, 0.0),
                     geo_n=torch.where(okn, hit.geo_n, 0.0),
                     sh_n=torch.where(okn, hit.sh_n, 0.0),
                     sh_s=torch.where(okn, hit.sh_s, 0.0),
                     sh_t=torch.where(okn, hit.sh_t, 0.0),
                     mat_id=hit.mat_id, uv=hit.uv, valid=ok,
                     em_id=torch.where(ok & (hit.emitter_id >= 0),
                                       hit.emitter_id, -1))


# id(material kind tensor) -> (a weak reference to it, its table's
# path.kind_rows), for _lane_kinds
_ROWS = {}


def _lane_kinds(arr, kinds, mat_id):
    """The BSDF kinds the lanes' materials need, of every lane, dead or
    alive (path.live_kinds; one host sync): each family's value is
    selected by the lane's own kind, so every lane's value is the one
    over all of `kinds`, and a batch that reaches a few of the scene's
    kinds does not evaluate the rest."""
    key = arr.materials.kind
    got = _ROWS.get(id(key))
    if got is None or got[0]() is not key:
        got = _ROWS[id(key)] = (weakref.ref(key), kind_rows(arr.materials))
    live = live_kinds(got[1], mat_id,
                      torch.ones(mat_id.shape, dtype=torch.bool,
                                 device=mat_id.device))
    return tuple(k for k in live if k in kinds) or kinds


def _oriented_frame(arr, v, wi_world) -> Frame:
    """The vertex's shading frame, turned toward wi_world on a twosided
    material."""
    two = arr.materials.twosided[torch.clamp(v.mat_id, min=0).long()]
    flip = (two & (dot(v.sh_n, wi_world) < 0))[..., None]
    return Frame(s=v.sh_s, t=torch.where(flip, -v.sh_t, v.sh_t),
                 n=torch.where(flip, -v.sh_n, v.sh_n))


def _eval_bsdf(arr, kinds, v: VertexRec, wi_world, wo_world):
    """(f cos [N, 3], pdf [N]) at a stored vertex, twosided-aware."""
    fr = _oriented_frame(arr, v, wi_world)
    gm = mat.gather(arr.materials, arr.checkers, v.mat_id, v.uv)
    return mat.eval_pdf_mix(_lane_kinds(arr, kinds, v.mat_id),
                            arr.materials, arr.checkers, v.mat_id, v.uv, gm,
                            fr.to_local(wi_world), fr.to_local(wo_world),
                            arr.hair_tables)


def _delta_bounce(arr, kinds, v: VertexRec, wi_world, choice):
    """The deterministic delta bounce at a vertex, replaying the branch
    `choice` (0 reflect, 1 transmit). Returns (wo_world, weight f cos / p
    [N, 3], discrete pdf [N])."""
    fr = _oriented_frame(arr, v, wi_world)
    gm = mat.gather(arr.materials, arr.checkers, v.mat_id, v.uv)
    nl = wi_world.shape[0]
    u_lobe = torch.where(choice == 1, 1.0, 0.0)
    u2 = torch.full((nl, 2), 0.5, device=wi_world.device)
    wo, w, pdf, _, _ = mat.sample_mix(
        _lane_kinds(arr, kinds, v.mat_id), arr.materials, arr.checkers,
        v.mat_id, v.uv, gm, fr.to_local(wi_world), u_lobe, u2, u2,
        arr.hair_tables)
    return fr.to_world(wo), _san(w), _san(pdf)


def _emitted(arr, v: VertexRec, towards):
    """One-sided Le of an area light at a vertex, toward `towards`."""
    if arr.area is None:
        return torch.zeros_like(v.p)
    le = arr.area.radiance[torch.clamp(v.em_id, min=0).long()]
    on = (v.em_id >= 0) & (dot(v.geo_n, towards) > 0) & v.valid
    return torch.where(on[..., None], le, 0.0)


def _offset_ray(p, geo_n, d, eps):
    return p + geo_n * torch.where(dot(d, geo_n) > 0, eps, -eps)[..., None]


def _safe_ratio(new, old):
    """new / old per element, 0 where |old| < 1e-24."""
    small = torch.abs(old) < 1e-24
    return _san(new / torch.where(small, 1.0, old)) * (~small)


def _perturb_dir(d, u2, theta1=1e-4, theta2=0.1):
    """d rotated by an exponentially distributed angle in [theta1,
    theta2] about a uniform azimuth (mut_caustic.h; symmetric)."""
    lr = torch.log(torch.tensor(theta2 / theta1, dtype=torch.float32,
                                device=d.device))
    theta = theta2 * torch.exp(-lr * u2[:, 0])
    phi = 2.0 * math.pi * u2[:, 1]
    s, t = coordinate_system(d)
    sin_t = torch.sin(theta)
    return normalize(d * torch.cos(theta)[..., None]
                     + s * (sin_t * torch.cos(phi))[..., None]
                     + t * (sin_t * torch.sin(phi))[..., None])


def _gauss2(idx, seed: int, k1: int, k2: int, it: int):
    """[N, 2] Box-Muller pair from uniform_2d at salts seed + k1 and
    seed + k2, dim 2 it (the lens and mchain pixel moves)."""
    g = rng.uniform_2d(idx, (seed + k1) & M32, (it * 2) & M32)
    g2 = rng.uniform_2d(idx, (seed + k2) & M32, (it * 2) & M32)
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(g[:, :1], min=1e-12)))
    return r * torch.cat([torch.cos(2 * math.pi * g2[:, :1]),
                          torch.sin(2 * math.pi * g2[:, :1])], 1)


def camera_ray(cam, pos):
    """The camera ray through film position pos with no aperture sample:
    a lens camera's through the lens centre, so the trajectory's first
    segment is the pinhole's that sensors.camera_importance reprojects
    through (the JAX package passes no aperture sample and fails on a
    thin lens)."""
    lens = cam.kind == sensors.THINLENS and cam.aperture_radius > 0.0
    return sensors.sample_ray(cam, pos, torch.full_like(pos, 0.5)
                              if lens else None)


def _record_path(scene, arr, pix_pos, salt: int) -> PathRec:
    """A unidirectional path trace (BSDF sampling only, no NEE; the
    emission collected at every hit as the forward path tracer does)
    keeping the first K vertices and the emission buckets:
    max(min(max_depth, 8), K) bounces."""
    cfg = scene.config
    kinds = scene.active_kinds
    n = pix_pos.shape[0]
    dev = pix_pos.device
    idx = torch.arange(n, device=dev)
    salt = salt & M32
    params = _swept_params(cfg)
    ray = camera_ray(scene.camera, pix_pos)
    d_max = max(min(cfg.max_depth, 8), K)
    o, d = ray.o, ray.d
    tp = torch.ones((n, 3), device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    recs, wos, ws, pdfs, deltas, choices, w_ems, w_envs = \
        [], [], [], [], [], [], [], []
    for b in range(d_max):
        hit = scene_intersect(arr, Ray(o=o, d=d, mint=torch.zeros(n,
                                                                device=dev),
                                       maxt=torch.where(alive,
                                                        float("inf"), 0.0)),
                              sort_rays=True, **params)
        esc = alive & ~hit.valid
        w_env_b = torch.where(esc[..., None], tp * _env_radiance(arr, d),
                              0.0)
        em_hit = alive & hit.valid & (hit.emitter_id >= 0)
        w_em_b = torch.zeros((n, 3), device=dev)
        if arr.area is not None:
            le = arr.area.radiance[torch.clamp(hit.emitter_id,
                                               min=0).long()]
            facing = dot(hit.geo_n, -d) > 0
            w_em_b = torch.where((em_hit & facing)[..., None], tp * le, 0.0)
        alive2 = alive & hit.valid

        wi_world = -d
        two = arr.materials.twosided[torch.clamp(hit.mat_id, min=0).long()]
        flip = (two & (dot(hit.sh_n, wi_world) < 0))[..., None]
        geo_n = torch.where(flip, -hit.geo_n, hit.geo_n)
        fr = frame(hit)._replace(n=torch.where(flip, -hit.sh_n, hit.sh_n),
                                 t=torch.where(flip, -hit.sh_t, hit.sh_t))
        wi = fr.to_local(wi_world)
        gm = mat.gather(arr.materials, arr.checkers, hit.mat_id, hit.uv)
        u_l = rng.uniform_1d(idx, salt, b * 8 + 0)
        u2 = rng.uniform_2d(idx, salt, b * 8 + 1)
        u2b = rng.uniform_2d(idx, salt, b * 8 + 3)
        wo, w, pdf, is_delta, _ = mat.sample_mix(
            _lane_kinds(arr, kinds, hit.mat_id), arr.materials,
            arr.checkers, hit.mat_id, hit.uv, gm, wi, u_l, u2, u2b,
            arr.hair_tables)
        wo_world = fr.to_world(wo)
        # transmit iff the local bounce crossed z = 0
        choice = ((wo[..., 2] * wi[..., 2]) < 0).to(torch.int32)
        w = torch.where(alive2[..., None], w, 0.0)
        tp = tp * torch.where(alive2[..., None], w, 1.0)
        alive3 = alive2 & (torch.amax(torch.abs(w), -1) > 0)
        o = _offset_ray(hit.p, geo_n, wo_world, cfg.ray_eps)
        d = wo_world
        rec = _hit_to_vertex(hit, alive & hit.valid)
        recs.append(rec._replace(em_id=torch.where(em_hit, hit.emitter_id,
                                                   -1)))
        wos.append(wo_world)
        ws.append(_san(w))
        pdfs.append(_san(pdf))
        deltas.append(is_delta & alive2)
        choices.append(choice)
        w_ems.append(_san(w_em_b))
        w_envs.append(_san(w_env_b))
        alive = alive3
    w_em_s = torch.stack(w_ems)
    w_env_s = torch.stack(w_envs)
    total = torch.sum(w_em_s, 0) + torch.sum(w_env_s, 0)
    head = torch.sum(w_em_s[:K], 0) + torch.sum(w_env_s[:K], 0)
    return PathRec(pix=pix_pos, v=_map_v(lambda *a: torch.stack(a),
                                         *recs[:K]),
                   v_delta=torch.stack(deltas[:K]),
                   v_choice=torch.stack(choices[:K]),
                   wo=torch.stack(wos[:K]), w=torch.stack(ws[:K]),
                   pdf=torch.stack(pdfs[:K]), w_em=_san(w_em_s[:K]),
                   w_env=_san(w_env_s[:K]), w_rest=_san(total - head))


# ---------------------------------------------------------------------------
# mutation steps
# ---------------------------------------------------------------------------

class Ctx(NamedTuple):
    """What every mutation step reads: the scene, its arrays and kinds,
    the lane count and index, the camera's position, the seed and the
    lens move's sigma (a fraction of the film width)."""
    scene: object
    arr: object
    kinds: tuple
    n: int
    idx: torch.Tensor
    cam_o: torch.Tensor
    seed: int
    lens_sigma: float


def make_ctx(scene, n: int, seed: int = 0, lens_sigma: float = 0.03) -> Ctx:
    arr = scene.arrays
    dev = arr.device
    return Ctx(scene=scene, arr=arr, kinds=scene.active_kinds, n=n,
               idx=torch.arange(n, device=dev),
               cam_o=torch.as_tensor(np.asarray(scene.camera.to_world)[:3, 3],
                                     dtype=torch.float32, device=dev),
               seed=seed, lens_sigma=lens_sigma)


def _intersect(ctx: Ctx, ray):
    return scene_intersect(ctx.arr, ray, sort_rays=True,
                           **_swept_params(ctx.scene.config))


def _occluded(ctx: Ctx, ray):
    return scene_occluded(ctx.arr, ray, sort_rays=True,
                          **_swept_params(ctx.scene.config))


def _ray(o, d, active):
    """A ray from o along d, [0, inf) on active lanes, empty elsewhere."""
    return Ray(o=o, d=d, mint=torch.zeros(o.shape[0], device=o.device),
               maxt=torch.where(active, float("inf"), 0.0))


def _shadow(ctx: Ctx, p, geo_n, q, active):
    """Occlusion of the open segment p -> q (origin offset at p)."""
    eps = ctx.scene.config.ray_eps
    seg = q - p
    dist = _norm(seg)
    d = seg / torch.clamp(dist, min=1e-12)[..., None]
    o = _offset_ray(p, geo_n, d, eps)
    return _occluded(ctx, Ray(o=o, d=d, mint=torch.zeros(ctx.n,
                                                         device=o.device),
                              maxt=torch.where(active, dist - 2 * eps,
                                               0.0)))


def _deep_scale(st: PathRec, k_from: int, ratio):
    """Every bucket of depth >= k_from scaled by the [N, 3] throughput
    ratio (w_em[k] and w_env[k] carry the product of w_0..w_{k-1})."""
    ks = range(k_from, K)
    return st._replace(w_em=_at(st.w_em, {k: st.w_em[k] * ratio
                                          for k in ks}),
                       w_env=_at(st.w_env, {k: st.w_env[k] * ratio
                                            for k in ks}),
                       w_rest=st.w_rest * ratio)


def _chain_delta_kind(arr, mat_id):
    """Is the material a pure delta kind a chain may pass through?"""
    kind = arr.materials.kind[torch.clamp(mat_id, min=0).long()]
    ok = torch.zeros(kind.shape, dtype=torch.bool, device=kind.device)
    for k in DELTA_CHAIN_KINDS:
        ok = ok | (kind == k)
    return ok


def _wbar(f, p):
    """f / p with p at least 1e-20, non-finite values 0."""
    return _san(f / torch.clamp(p, min=1e-20)[..., None])


def _accept(ok, num, den):
    return torch.where(ok, torch.clamp(_san(num / torch.clamp(den,
                                                              min=1e-24)),
                                       0.0, 1.0), 0.0)


def _in_film(pix, W, H):
    return (pix[:, 0] >= 0) & (pix[:, 0] < W) & (pix[:, 1] >= 0) \
        & (pix[:, 1] < H)


def _step_lens(ctx: Ctx, st: PathRec, it: int, p_large: float):
    """The large step / lens perturbation (mut_lens.h and Kelemen's large
    steps); a per-lane coin picks which."""
    scene, arr, kinds, n, idx = ctx.scene, ctx.arr, ctx.kinds, ctx.n, \
        ctx.idx
    cfg = scene.config
    W, H = cfg.width, cfg.height
    seed = ctx.seed
    dev = idx.device
    l = _lum(traj_w(st))
    is_large = rng.uniform_1d(idx, (seed + 3) & M32, it) < p_large

    # ---- large step ----
    u = rng.uniform_2d(idx, (it * 2654435761 + 17) & M32, 0)
    pix_l = torch.stack([u[:, 0] * W, u[:, 1] * H], -1)
    prop_l = _record_path(scene, arr, pix_l,
                          ((seed * 131) & M32) + it * 977 + 3)
    l_large = _lum(traj_w(prop_l))
    a_large = torch.clamp(l_large / torch.clamp(l, min=1e-12), 0.0, 1.0)
    a_large = torch.where(l <= 0, 1.0, a_large)

    # ---- lens perturbation ----
    pix_y = st.pix + _gauss2(idx, seed, 5, 6, it) * (ctx.lens_sigma * W)
    in_film = _in_film(pix_y, W, H)
    ray_y = camera_ray(scene.camera, pix_y)
    hit_y = _intersect(ctx, ray_y)
    y_ok = hit_y.valid & in_film
    y1 = _hit_to_vertex(hit_y, y_ok)
    x1 = _vtx(st, 0)
    x2 = _vtx(st, 1)
    has_x2 = x2.valid
    deep = torch.sum(st.w_em[1:], 0) + torch.sum(st.w_env[1:], 0) \
        + st.w_rest
    eligible = x1.valid & y_ok & (l > 0) \
        & (has_x2 | (_lum(st.w_env[1]) > 0))

    # the kept coordinate: x2 (a point) or w0 (a direction)
    h2 = has_x2[..., None]
    seg = x2.p - y1.p
    dist = _norm(seg)
    d_y = torch.where(h2, seg / torch.clamp(dist, min=1e-12)[..., None],
                      st.wo[0])
    seg_x = x2.p - x1.p
    dist_x = _norm(seg_x)
    d_x = torch.where(h2, seg_x / torch.clamp(dist_x, min=1e-12)[..., None],
                      st.wo[0])
    wi_cam_y = normalize(ctx.cam_o.expand_as(y1.p) - y1.p)
    wi_cam_x = normalize(ctx.cam_o.expand_as(x1.p) - x1.p)
    f1y, p1y = _eval_bsdf(arr, kinds, y1, wi_cam_y, d_y)
    f1x, p1x = _eval_bsdf(arr, kinds, x1, wi_cam_x, d_x)
    # the Jacobian solid angle -> the kept x2's area (1 for a direction)
    j_y = torch.where(has_x2, torch.abs(dot(d_y, x2.geo_n))
                      / torch.clamp(dist * dist, min=1e-12), 1.0)
    j_x = torch.where(has_x2, torch.abs(dot(d_x, x2.geo_n))
                      / torch.clamp(dist_x * dist_x, min=1e-12), 1.0)
    occ = _shadow(ctx, y1.p, y1.geo_n, x2.p, eligible & has_x2)
    ok = eligible & ~(has_x2 & occ) & (p1y > 0) & (p1x > 0) \
        & (_lum(f1x) > 1e-18) & (j_x > 1e-18)

    w0y = _wbar(f1y, p1y)
    rw1 = torch.where(ok[..., None], _safe_ratio(w0y, st.w[0]), 0.0)
    # x2's bounce weight under the changed incoming direction
    f2y, p2y = _eval_bsdf(arr, kinds, x2, -d_y, st.wo[1])
    w1y = _wbar(f2y, p2y)
    ok = ok & (~has_x2 | ((p2y > 1e-12) & (st.pdf[1] > 1e-12)))
    okx2 = ok & has_x2
    rw2 = torch.where(okx2[..., None], _safe_ratio(w1y, st.w[1]), 0.0)
    q2_ratio = torch.where(okx2, p2y / torch.clamp(st.pdf[1], min=1e-12),
                           1.0)

    em_y1 = _emitted(arr, y1, -ray_y.d)
    w_y = em_y1 + torch.where(h2, rw1 * (st.w_em[1] + rw2
                                         * (deep - st.w_em[1])),
                              rw1 * st.w_env[1])
    w_y = torch.where(ok[..., None], w_y, 0.0)
    l_y = _lum(w_y)
    a_lens = torch.clamp(l_y * p1y * j_y * q2_ratio
                         / torch.clamp(l * p1x * j_x, min=1e-20), 0.0, 1.0)
    a_lens = torch.where(ok, a_lens, 0.0)

    # the lens proposal
    zero3 = torch.zeros((n, 3), device=dev)
    r12 = rw1 * rw2
    w_em = {0: em_y1, 1: torch.where(h2, rw1 * st.w_em[1], 0.0)}
    w_env = {0: zero3, 1: torch.where(h2, 0.0, rw1 * st.w_env[1])}
    for k in range(2, K):
        w_em[k] = st.w_em[k] * r12
        w_env[k] = st.w_env[k] * r12
    lens_state = st._replace(
        pix=pix_y, v=_set_vtx(st.v, {0: y1}),
        v_delta=_at(st.v_delta, {0: False}), wo=_at(st.wo, {0: d_y}),
        w=_at(st.w, {0: torch.where(ok[..., None], w0y, st.w[0]),
                     1: torch.where(okx2[..., None], w1y, st.w[1])}),
        pdf=_at(st.pdf, {0: torch.where(ok, p1y, st.pdf[0]),
                         1: torch.where(okx2, p2y, st.pdf[1])}),
        w_em=_at(st.w_em, w_em), w_env=_at(st.w_env, w_env),
        w_rest=st.w_rest * r12)

    a = torch.where(is_large, a_large, a_lens)
    return _lane_select(is_large, prop_l, lens_state), a


def _caustic_probe(ctx: Ctx, pix, w0dir, choice1, x3p, e3s, e3t, d_base,
                   eb1, eb2, active):
    """(pix, w0) through one specular bounce: the landing point's tangent
    coordinates around x3 and the light-side direction's around d_base,
    the chain map whose Jacobian the caustic perturbation needs."""
    eps = ctx.scene.config.ray_eps
    ray = camera_ray(ctx.scene.camera, pix)
    h1 = _intersect(ctx, ray._replace(maxt=torch.where(active, ray.maxt,
                                                       0.0)))
    h2 = _intersect(ctx, _ray(_offset_ray(h1.p, h1.geo_n, w0dir, eps),
                              w0dir, active & h1.valid))
    v2 = _hit_to_vertex(h2, h2.valid)
    wo2, _, _ = _delta_bounce(ctx.arr, ctx.kinds, v2, -w0dir, choice1)
    h3 = _intersect(ctx, _ray(_offset_ray(h2.p, h2.geo_n, wo2, eps), wo2,
                              active & h1.valid & h2.valid))
    ok = active & h1.valid & h2.valid & h3.valid \
        & _chain_delta_kind(ctx.arr, h2.mat_id)
    rel = h3.p - x3p
    a3 = torch.stack([dot(rel, e3s), dot(rel, e3t)], -1)
    dv = normalize(h2.p - h3.p) - d_base
    return a3, torch.stack([dot(dv, eb1), dot(dv, eb2)], -1), ok


def _struct_caustic(st: PathRec, arr):
    """The E-D-S-D pattern (positive-luminance states only)."""
    x1, x2, x3 = _vtx(st, 0), _vtx(st, 1), _vtx(st, 2)
    return x1.valid & ~st.v_delta[0] & x2.valid & st.v_delta[1] \
        & _chain_delta_kind(arr, x2.mat_id) & x3.valid \
        & ~st.v_delta[2] & (_lum(traj_w(st)) > 0)


def _struct_manifold(st: PathRec, arr):
    """The E-D-D-S-D pattern (positive-luminance states only)."""
    x1, x2, x3, x4 = (_vtx(st, k) for k in range(K))
    return x1.valid & ~st.v_delta[0] & x2.valid & ~st.v_delta[1] \
        & x3.valid & st.v_delta[2] & _chain_delta_kind(arr, x3.mat_id) \
        & x4.valid & ~st.v_delta[3] & (_lum(traj_w(st)) > 0)


def _struct_mchain(st: PathRec, arr):
    """The E-S-D-S-D pattern (positive-luminance states only): two
    single-bounce specular chains apart."""
    x1, x2, x3, x4 = (_vtx(st, k) for k in range(K))
    return x1.valid & st.v_delta[0] & _chain_delta_kind(arr, x1.mat_id) \
        & x2.valid & ~st.v_delta[1] \
        & x3.valid & st.v_delta[2] & _chain_delta_kind(arr, x3.mat_id) \
        & x4.valid & ~st.v_delta[3] & (_lum(traj_w(st)) > 0)


def _struct_bidir(st: PathRec, two: bool):
    """The pattern the one- (two=False) or two-vertex regrow takes."""
    x = [_vtx(st, k) for k in range(K)]
    m = x[0].valid & ~st.v_delta[0] & x[1].valid & ~st.v_delta[1] \
        & x[2].valid & (_lum(traj_w(st)) > 0)
    return m & ~st.v_delta[2] & x[3].valid if two else m


def det4(m):
    """det of [N, 4, 4] matrices by the Laplace expansion over the 2 x 2
    minors of the first two rows: per-lane algebra, no batched LU (the
    JAX package's jnp.linalg.det is one; on the finite-difference
    Jacobians the two agree as closely as LU does with itself across
    the packages, the columns' own rounding dominating)."""
    a = [[m[:, i, j] for j in range(4)] for i in range(4)]
    s = [a[0][i] * a[1][j] - a[1][i] * a[0][j]
         for i, j in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))]
    c = [a[2][i] * a[3][j] - a[3][i] * a[2][j]
         for i, j in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))]
    return s[0] * c[5] - s[1] * c[4] + s[2] * c[3] + s[3] * c[2] \
        - s[4] * c[1] + s[5] * c[0]


def _step_caustic(ctx: Ctx, st: PathRec, it: int, sigma_scale: float = 1.0):
    """The caustic perturbation (mut_caustic.h), pattern E-D-S-D."""
    scene, arr, kinds, n, idx = ctx.scene, ctx.arr, ctx.kinds, ctx.n, \
        ctx.idx
    cfg = scene.config
    W, H = cfg.width, cfg.height
    eps = cfg.ray_eps
    dev = idx.device
    l = _lum(traj_w(st))
    x1, x2, x3 = _vtx(st, 0), _vtx(st, 1), _vtx(st, 2)
    struct = _struct_caustic(st, arr)

    # the light-side chain direction d = dir(x3 -> x2), perturbed
    d_x = normalize(x2.p - x3.p)
    u2 = rng.uniform_2d(idx, (ctx.seed + 21) & M32, it)
    d_y = _perturb_dir(d_x, u2, theta1=max(1e-4 * sigma_scale, 1e-7),
                       theta2=max(0.1 * sigma_scale, 2e-7))

    # the chain traced toward the eye: x3 -> y2 (specular) -> y1
    h2y = _intersect(ctx, _ray(_offset_ray(x3.p, x3.geo_n, d_y, eps), d_y,
                               struct))
    ok = struct & h2y.valid & _chain_delta_kind(arr, h2y.mat_id)
    y2 = _hit_to_vertex(h2y, ok)
    wo_rev, _, _ = _delta_bounce(arr, kinds, y2, -d_y, st.v_choice[1])
    h1y = _intersect(ctx, _ray(_offset_ray(y2.p, y2.geo_n, wo_rev, eps),
                               wo_rev, ok))
    ok = ok & h1y.valid & ~_chain_delta_kind(arr, h1y.mat_id)
    y1 = _hit_to_vertex(h1y, ok)
    # reprojected through the sensor, seen by the eye
    pix_y, _, _, d_to_cam, vis = sensors.camera_importance(scene.camera,
                                                           y1.p)
    in_film = vis & _in_film(pix_y, W, H)
    occ_eye = _shadow(ctx, y1.p, y1.geo_n, ctx.cam_o.expand_as(y1.p),
                      ok & in_film)
    ok = ok & in_film & ~occ_eye

    # the canonical (eye-side) factors at the new vertices
    d01_y = normalize(y2.p - y1.p)            # y1 -> y2
    f0y, p0y = _eval_bsdf(arr, kinds, y1, d_to_cam, d01_y)
    w0y = _wbar(f0y, p0y)
    wo1_y, w1y, pc1y = _delta_bounce(arr, kinds, y2, -d01_y,
                                     st.v_choice[1])
    # the canonical bounce must reproduce the segment y2 -> x3
    ok = ok & (dot(wo1_y, normalize(x3.p - y2.p)) > 0.999) & (p0y > 0) \
        & (pc1y > 0)
    # x3's decision under the changed incoming direction
    f2y, p2y = _eval_bsdf(arr, kinds, x3, d_y, st.wo[2])
    w2y = _wbar(f2y, p2y)
    ok = ok & (p2y > 1e-12) & (st.pdf[2] > 1e-12) & (st.pdf[0] > 1e-12) \
        & (st.pdf[1] > 1e-12)

    # the Jacobian |d(A3, d) / d(pix, w0)| of both states, by finite
    # differences
    e3s, e3t = x3.sh_s, x3.sh_t
    eb1, eb2 = coordinate_system(d_x)
    eps_p, eps_w = 0.35, 1.5e-3

    def jac(pix0, w0, choice, active):
        base_a3, base_dd, okj = _caustic_probe(
            ctx, pix0, w0, choice, x3.p, e3s, e3t, d_x, eb1, eb2, active)
        s_w, t_w = coordinate_system(w0)
        probes = [
            (pix0 + torch.tensor([eps_p, 0.0], device=dev), w0, eps_p),
            (pix0 + torch.tensor([0.0, eps_p], device=dev), w0, eps_p),
            (pix0, normalize(w0 + s_w * eps_w), eps_w),
            (pix0, normalize(w0 + t_w * eps_w), eps_w)]
        cols = []
        for pp, ww, e in probes:
            a3, dd, okp = _caustic_probe(ctx, pp, ww, choice, x3.p, e3s,
                                         e3t, d_x, eb1, eb2, active)
            cols.append(torch.cat([(a3 - base_a3) / e,
                                   (dd - base_dd) / e], -1))
            okj = okj & okp
        return _san(torch.abs(det4(torch.stack(cols, -1)))), okj

    j_y, ok_jy = jac(pix_y, d01_y, st.v_choice[1], ok)
    j_x, ok_jx = jac(st.pix, st.wo[0], st.v_choice[1], struct)
    ok = ok & ok_jy & ok_jx & (j_y > 1e-16) & (j_x > 1e-16)

    # the buckets: recomputed through x3, scaled beyond
    em_y1 = _emitted(arr, y1, d_to_cam)
    em_y2 = _emitted(arr, y2, -d01_y) * w0y
    em_x3 = _emitted(arr, x3, d_y) * w0y * w1y
    r3v = _safe_ratio(w0y * w1y * w2y, st.w[0] * st.w[1] * st.w[2])
    w_y = em_y1 + em_y2 + em_x3 + (st.w_em[3] + st.w_env[3]) * r3v \
        + st.w_rest * r3v
    w_y = torch.where(ok[..., None], w_y, 0.0)
    l_y = _lum(w_y)
    num = l_y * p0y * pc1y * p2y / torch.clamp(j_y, min=1e-20)
    den = l * st.pdf[0] * st.pdf[1] * st.pdf[2] / torch.clamp(j_x,
                                                              min=1e-20)
    a = _accept(ok, num, den)

    zero3 = torch.zeros((n, 3), device=dev)
    prop = st._replace(
        pix=pix_y, v=_set_vtx(st.v, {0: y1, 1: y2}),
        v_delta=_at(st.v_delta, {0: False, 1: True}),
        wo=_at(st.wo, {0: d01_y, 1: normalize(x3.p - y2.p)}),
        w=_at(st.w, {0: w0y, 1: w1y, 2: w2y}),
        pdf=_at(st.pdf, {0: p0y, 1: pc1y, 2: p2y}),
        w_em=_at(st.w_em, {0: em_y1, 1: em_y2, 2: em_x3,
                           3: st.w_em[3] * r3v}),
        w_env=_at(st.w_env, {0: zero3, 1: zero3, 2: zero3,
                             3: st.w_env[3] * r3v}),
        w_rest=st.w_rest * r3v)
    return prop, a


def _chain_eta(arr, v: VertexRec, choice, wi_world):
    """The walk's relative IOR at a stored specular vertex: 1 for a
    reflection, eta_b / eta_a for a transmission (a the side of
    wi_world)."""
    gm_eta = arr.materials.eta[torch.clamp(v.mat_id, min=0).long()]
    ext = dot(wi_world, v.sh_n) > 0
    eta_t = torch.where(ext, gm_eta, 1.0 / torch.clamp(gm_eta, min=1e-6))
    return torch.where(choice == 1, eta_t, 1.0)


def _step_manifold(ctx: Ctx, st: PathRec, it: int, sigma: float = 0.05):
    """The manifold perturbation (mut_manifold.h), pattern E-D-D-S-D:
    the direction at x1 perturbed, y2 landed, the specular x3 re-solved
    between y2 and the fixed x4 by the manifold walk (8 iterations)."""
    scene, arr, kinds, n, idx = ctx.scene, ctx.arr, ctx.kinds, ctx.n, \
        ctx.idx
    cfg = scene.config
    dev = idx.device
    l = _lum(traj_w(st))
    x1, x2, x3, x4 = (_vtx(st, k) for k in range(K))
    struct = _struct_manifold(st, arr)

    u2 = rng.uniform_2d(idx, (ctx.seed + 31) & M32, it)
    w0_y = _perturb_dir(st.wo[0], u2, theta1=1e-4 * sigma / 0.05,
                        theta2=sigma)
    h2y = _intersect(ctx, _ray(_offset_ray(x1.p, x1.geo_n, w0_y,
                                           cfg.ray_eps), w0_y, struct))
    ok = struct & h2y.valid & ~_chain_delta_kind(arr, h2y.mat_id)
    y2 = _hit_to_vertex(h2y, ok)

    # walk the specular vertex between y2 and the fixed x4
    eta = _chain_eta(arr, x3, st.v_choice[2], normalize(x2.p - x3.p))
    hit3_init = h2y._replace(p=x3.p, sh_n=x3.sh_n, valid=ok,
                             geo_n=x3.geo_n)
    y3p, y3n, walked = manifold.walk(arr, cfg, y2.p, x4.p, hit3_init,
                                     eta=eta, n_iters=8)
    ok = ok & walked
    sy, ty = coordinate_system(y3n)
    y3 = x3._replace(p=y3p, geo_n=y3n, sh_n=y3n, sh_s=sy, sh_t=ty, valid=ok)
    ok = ok & ~_shadow(ctx, y3.p, y3.geo_n, x4.p, ok)

    wi_cam = normalize(ctx.cam_o.expand_as(x1.p) - x1.p)
    f0y, p0y = _eval_bsdf(arr, kinds, x1, wi_cam, w0_y)
    w0y = _wbar(f0y, p0y)
    d12 = normalize(y3.p - y2.p)
    f1y, p1y = _eval_bsdf(arr, kinds, y2, -w0_y, d12)
    w1y = _wbar(f1y, p1y)
    wo2_y, w2y, pc2y = _delta_bounce(arr, kinds, y3, -d12, st.v_choice[2])
    d34 = normalize(x4.p - y3.p)
    ok = ok & (dot(wo2_y, d34) > 0.995) & (p0y > 0) & (p1y > 0) \
        & (pc2y > 0)
    f3y, p3y = _eval_bsdf(arr, kinds, x4, -d34, st.wo[3])
    w3y = _wbar(f3y, p3y)
    ok = ok & (p3y > 1e-12) & (st.pdf[0] > 1e-12) & (st.pdf[1] > 1e-12) \
        & (st.pdf[2] > 1e-12) & (st.pdf[3] > 1e-12)

    # the chain Jacobians |dA(x4) / dw| (generalized G)
    g_y = manifold.generalized_g(y2.p, x4.p, y3.p, y3n, eta)
    g_x = manifold.generalized_g(x2.p, x4.p, x3.p, x3.sh_n, eta)
    ok = ok & (g_y > 1e-16) & (g_x > 1e-16)

    em_y2 = _emitted(arr, y2, -w0_y) * w0y
    em_y3 = _emitted(arr, y3, -d12) * w0y * w1y
    em_x4 = _emitted(arr, x4, -d34) * w0y * w1y * w2y
    r4v = _safe_ratio(w0y * w1y * w2y * w3y,
                      st.w[0] * st.w[1] * st.w[2] * st.w[3])
    r3v = _safe_ratio(w0y * w1y * w2y, st.w[0] * st.w[1] * st.w[2])
    w_y = st.w_em[0] + em_y2 + em_y3 + em_x4 + st.w_env[3] * r3v \
        + st.w_rest * r4v
    w_y = torch.where(ok[..., None], w_y, 0.0)
    l_y = _lum(w_y)
    num = l_y * p0y * p1y * pc2y * p3y / torch.clamp(g_y, min=1e-20)
    den = l * st.pdf[0] * st.pdf[1] * st.pdf[2] * st.pdf[3] \
        / torch.clamp(g_x, min=1e-20)
    a = _accept(ok, num, den)

    zero3 = torch.zeros((n, 3), device=dev)
    prop = st._replace(
        v=_set_vtx(st.v, {1: y2, 2: y3}),
        wo=_at(st.wo, {0: w0_y, 1: d12, 2: d34}),
        w=_at(st.w, {0: w0y, 1: w1y, 2: w2y, 3: w3y}),
        pdf=_at(st.pdf, {0: p0y, 1: p1y, 2: pc2y, 3: p3y}),
        w_em=_at(st.w_em, {1: em_y2, 2: em_y3, 3: em_x4}),
        w_env=_at(st.w_env, {1: zero3, 2: zero3, 3: st.w_env[3] * r3v}),
        w_rest=st.w_rest * r4v)
    return prop, a


def _sample_at(ctx: Ctx, v: VertexRec, fr: Frame, wi_world, keys, dims):
    """A fresh BSDF sample at v in frame fr: (wo_world, weight, pdf,
    is_delta), the lobe, the direction and the second direction uniforms
    at salts seed + keys[i], dims dims[i]."""
    arr, idx, seed = ctx.arr, ctx.idx, ctx.seed
    gm = mat.gather(arr.materials, arr.checkers, v.mat_id, v.uv)
    u_l = rng.uniform_1d(idx, (seed + keys[0]) & M32, dims[0] & M32)
    u2 = rng.uniform_2d(idx, (seed + keys[1]) & M32, dims[1] & M32)
    u2b = rng.uniform_2d(idx, (seed + keys[2]) & M32, dims[2] & M32)
    wo_l, w, p, is_d, _ = mat.sample_mix(
        _lane_kinds(arr, ctx.kinds, v.mat_id), arr.materials, arr.checkers,
        v.mat_id, v.uv, gm,
        fr.to_local(wi_world), u_l, u2, u2b, arr.hair_tables)
    return fr.to_world(wo_l), _san(w), p, is_d


def _step_bidir(ctx: Ctx, st: PathRec, it: int):
    """The one-vertex bidirectional mutation (mut_bidir.h, scoped): a
    fresh BSDF direction at x1 lands y2, reconnected to the kept x3; the
    proposal's BSDF pdf cancels in the ratio."""
    scene, arr, kinds = ctx.scene, ctx.arr, ctx.kinds
    cfg = scene.config
    dev = ctx.idx.device
    l = _lum(traj_w(st))
    x1, x2, x3 = _vtx(st, 0), _vtx(st, 1), _vtx(st, 2)
    struct = _struct_bidir(st, two=False)

    wi_cam = normalize(ctx.cam_o.expand_as(x1.p) - x1.p)
    w0_y, w0y, p0y, is_d = _sample_at(
        ctx, x1, _oriented_frame(arr, x1, wi_cam), wi_cam, (41, 42, 43),
        (it * 4, it * 4 + 1, it * 4 + 2))
    ok = struct & ~is_d & (p0y > 0) & (torch.amax(torch.abs(w0y), -1) > 0)
    h2y = _intersect(ctx, _ray(_offset_ray(x1.p, x1.geo_n, w0_y,
                                           cfg.ray_eps), w0_y, ok))
    ok = ok & h2y.valid
    y2 = _hit_to_vertex(h2y, ok)

    # reconnect y2 -> x3
    seg = x3.p - y2.p
    dist = _norm(seg)
    d23_y = seg / torch.clamp(dist, min=1e-12)[..., None]
    ok = ok & ~_shadow(ctx, y2.p, y2.geo_n, x3.p, ok)
    f1y, p1y = _eval_bsdf(arr, kinds, y2, -w0_y, d23_y)
    w1y = _wbar(f1y, p1y)
    j_y = torch.abs(dot(d23_y, x3.geo_n)) / torch.clamp(dist * dist,
                                                        min=1e-12)
    d23_x = normalize(x3.p - x2.p)
    dist_x = _norm(x3.p - x2.p)
    j_x = torch.abs(dot(d23_x, x3.geo_n)) / torch.clamp(dist_x * dist_x,
                                                        min=1e-12)
    f2y, p2y = _eval_bsdf(arr, kinds, x3, -d23_y, st.wo[2])
    w2y = _wbar(f2y, p2y)
    ok = ok & (p1y > 0) & (p2y > 1e-12) & (st.pdf[1] > 1e-12) \
        & (st.pdf[2] > 1e-12) & (j_y > 1e-16) & (j_x > 1e-16)

    em_y2 = _emitted(arr, y2, -w0_y) * w0y
    em_x3 = _emitted(arr, x3, -d23_y) * w0y * w1y
    r3v = _safe_ratio(w0y * w1y * w2y, st.w[0] * st.w[1] * st.w[2])
    r2v = _safe_ratio(w0y * w1y, st.w[0] * st.w[1])
    w_y = st.w_em[0] + em_y2 + em_x3 + (st.w_em[3] + st.w_env[3]) * r3v \
        + st.w_env[2] * r2v + st.w_rest * r3v
    w_y = torch.where(ok[..., None], w_y, 0.0)
    l_y = _lum(w_y)
    a = _accept(ok, l_y * p1y * j_y * p2y, l * st.pdf[1] * j_x * st.pdf[2])

    zero3 = torch.zeros((ctx.n, 3), device=dev)
    prop = st._replace(
        v=_set_vtx(st.v, {1: y2}), v_delta=_at(st.v_delta, {1: False}),
        wo=_at(st.wo, {0: w0_y, 1: d23_y}),
        w=_at(st.w, {0: w0y, 1: w1y, 2: w2y}),
        pdf=_at(st.pdf, {0: p0y, 1: p1y, 2: p2y}),
        w_em=_at(st.w_em, {1: em_y2, 2: em_x3, 3: st.w_em[3] * r3v}),
        w_env=_at(st.w_env, {1: zero3, 2: st.w_env[2] * r2v,
                             3: st.w_env[3] * r3v}),
        w_rest=st.w_rest * r3v)
    return prop, a


def _step_bidir2(ctx: Ctx, st: PathRec, it: int):
    """The two-vertex class of the variable-length bidirectional mutation
    (mut_bidir.h): fresh BSDF directions at x1 and at the new y2 land y3,
    reconnected to the kept x4. mlt_chains alternates it with _step_bidir
    by round parity; each class is reversible within itself."""
    scene, arr, kinds = ctx.scene, ctx.arr, ctx.kinds
    cfg = scene.config
    dev = ctx.idx.device
    l = _lum(traj_w(st))
    x1, x2, x3, x4 = (_vtx(st, k) for k in range(K))
    struct = _struct_bidir(st, two=True)

    wi_cam = normalize(ctx.cam_o.expand_as(x1.p) - x1.p)
    w0_y, w0y, p0y, is_d0 = _sample_at(
        ctx, x1, _oriented_frame(arr, x1, wi_cam), wi_cam, (44, 45, 46),
        (it * 6, it * 6 + 1, it * 6 + 2))
    ok = struct & ~is_d0 & (p0y > 0) \
        & (torch.amax(torch.abs(w0y), -1) > 0)
    h2y = _intersect(ctx, _ray(_offset_ray(x1.p, x1.geo_n, w0_y,
                                           cfg.ray_eps), w0_y, ok))
    ok = ok & h2y.valid
    y2 = _hit_to_vertex(h2y, ok)

    # a fresh BSDF direction at y2 (its frame as hit, not oriented)
    w1_y, w1y, p1y_s, is_d1 = _sample_at(
        ctx, y2, Frame(s=y2.sh_s, t=y2.sh_t, n=y2.sh_n), -w0_y,
        (47, 48, 49), (it * 6 + 3, it * 6 + 4, it * 6 + 5))
    ok = ok & ~is_d1 & (p1y_s > 0) & (torch.amax(torch.abs(w1y), -1) > 0)
    h3y = _intersect(ctx, _ray(_offset_ray(y2.p, y2.geo_n, w1_y,
                                           cfg.ray_eps), w1_y, ok))
    ok = ok & h3y.valid
    y3 = _hit_to_vertex(h3y, ok)

    # reconnect y3 -> x4
    seg = x4.p - y3.p
    dist = _norm(seg)
    d34_y = seg / torch.clamp(dist, min=1e-12)[..., None]
    ok = ok & ~_shadow(ctx, y3.p, y3.geo_n, x4.p, ok)
    f2y, p2y = _eval_bsdf(arr, kinds, y3, -w1_y, d34_y)
    w2y = _wbar(f2y, p2y)
    j_y = torch.abs(dot(d34_y, x4.geo_n)) / torch.clamp(dist * dist,
                                                        min=1e-12)
    d34_x = normalize(x4.p - x3.p)
    dist_x = _norm(x4.p - x3.p)
    j_x = torch.abs(dot(d34_x, x4.geo_n)) / torch.clamp(dist_x * dist_x,
                                                        min=1e-12)
    f3y, p3y = _eval_bsdf(arr, kinds, x4, -d34_y, st.wo[3])
    w3y = _wbar(f3y, p3y)
    ok = ok & (p2y > 0) & (p3y > 1e-12) & (st.pdf[2] > 1e-12) \
        & (st.pdf[3] > 1e-12) & (j_y > 1e-16) & (j_x > 1e-16)

    em_y2 = _emitted(arr, y2, -w0_y) * w0y
    em_y3 = _emitted(arr, y3, -w1_y) * w0y * w1y
    em_x4 = _emitted(arr, x4, -d34_y) * w0y * w1y * w2y
    r4v = _safe_ratio(w0y * w1y * w2y * w3y,
                      st.w[0] * st.w[1] * st.w[2] * st.w[3])
    r3v = _safe_ratio(w0y * w1y * w2y, st.w[0] * st.w[1] * st.w[2])
    w_y = st.w_em[0] + em_y2 + em_y3 + em_x4 + st.w_env[3] * r3v \
        + st.w_rest * r4v
    w_y = torch.where(ok[..., None], w_y, 0.0)
    l_y = _lum(w_y)
    a = _accept(ok, l_y * p2y * j_y * p3y, l * st.pdf[2] * j_x * st.pdf[3])

    zero3 = torch.zeros((ctx.n, 3), device=dev)
    prop = st._replace(
        v=_set_vtx(st.v, {1: y2, 2: y3}),
        v_delta=_at(st.v_delta, {1: False, 2: False}),
        wo=_at(st.wo, {0: w0_y, 1: w1_y, 2: d34_y}),
        w=_at(st.w, {0: w0y, 1: w1y, 2: w2y, 3: w3y}),
        pdf=_at(st.pdf, {0: p0y, 1: p1y_s, 2: p2y, 3: p3y}),
        w_em=_at(st.w_em, {1: em_y2, 2: em_y3, 3: em_x4}),
        w_env=_at(st.w_env, {1: zero3, 2: zero3, 3: st.w_env[3] * r3v}),
        w_rest=st.w_rest * r4v)
    return prop, a


def _step_mchain(ctx: Ctx, st: PathRec, it: int):
    """Veach's multi-chain perturbation (mut_mchain.h) in the stored
    window, pattern E-S-D-S-D: the pixel moved, the first specular chain
    re-traced with its kept branch, the kept direction at the middle
    diffuse vertex carried across the second chain, and the last diffuse
    vertex reattached to the kept suffix. The kept coordinates are the
    forward tracer's, so no chain Jacobian enters."""
    scene, arr, kinds, n, idx = ctx.scene, ctx.arr, ctx.kinds, ctx.n, \
        ctx.idx
    cfg = scene.config
    W, H = cfg.width, cfg.height
    eps = cfg.ray_eps
    dev = idx.device
    l = _lum(traj_w(st))
    struct = _struct_mchain(st, arr)

    pix_y = st.pix + _gauss2(idx, ctx.seed, 61, 62, it) \
        * (ctx.lens_sigma * W)
    in_film = _in_film(pix_y, W, H)
    ray_y = camera_ray(scene.camera, pix_y)
    h1 = _intersect(ctx, ray_y._replace(maxt=torch.where(
        struct & in_film, ray_y.maxt, 0.0)))
    ok = struct & in_film & h1.valid & _chain_delta_kind(arr, h1.mat_id)
    y1 = _hit_to_vertex(h1, ok)

    # chain 1: the delta bounce with the kept branch
    wo0, w0y, pc0y = _delta_bounce(arr, kinds, y1, -ray_y.d,
                                   st.v_choice[0])
    h2 = _intersect(ctx, _ray(_offset_ray(y1.p, y1.geo_n, wo0, eps), wo0,
                              ok))
    ok = ok & h2.valid & ~_chain_delta_kind(arr, h2.mat_id)
    y2 = _hit_to_vertex(h2, ok)

    # the middle diffuse vertex: the kept outgoing direction
    d2 = st.wo[1]
    f2y, p2y = _eval_bsdf(arr, kinds, y2, -wo0, d2)
    w1y = _wbar(f2y, p2y)
    h3 = _intersect(ctx, _ray(_offset_ray(y2.p, y2.geo_n, d2, eps), d2, ok))
    ok = ok & h3.valid & _chain_delta_kind(arr, h3.mat_id)
    y3 = _hit_to_vertex(h3, ok)

    # chain 2: the delta bounce with the kept branch
    wo3, w2y, pc2y = _delta_bounce(arr, kinds, y3, -d2, st.v_choice[2])
    h4 = _intersect(ctx, _ray(_offset_ray(y3.p, y3.geo_n, wo3, eps), wo3,
                              ok))
    ok = ok & h4.valid & ~_chain_delta_kind(arr, h4.mat_id)
    y4 = _hit_to_vertex(h4, ok)

    # the last diffuse vertex reattaches to the kept suffix direction
    f4y, p4y = _eval_bsdf(arr, kinds, y4, -wo3, st.wo[3])
    w3y = _wbar(f4y, p4y)
    ok = ok & (pc0y > 0) & (p2y > 1e-12) & (pc2y > 0) & (p4y > 1e-12) \
        & (st.pdf[0] > 1e-12) & (st.pdf[1] > 1e-12) \
        & (st.pdf[2] > 1e-12) & (st.pdf[3] > 1e-12)

    em_y1 = _emitted(arr, y1, -ray_y.d)
    em_y2 = _emitted(arr, y2, -wo0) * w0y
    em_y3 = _emitted(arr, y3, -d2) * w0y * w1y
    em_y4 = _emitted(arr, y4, -wo3) * w0y * w1y * w2y
    r4 = _safe_ratio(w0y * w1y * w2y * w3y,
                     st.w[0] * st.w[1] * st.w[2] * st.w[3])
    w_y = em_y1 + em_y2 + em_y3 + em_y4 + st.w_rest * r4
    w_y = torch.where(ok[..., None], w_y, 0.0)
    l_y = _lum(w_y)
    a = _accept(ok, l_y * pc0y * p2y * pc2y * p4y,
                l * st.pdf[0] * st.pdf[1] * st.pdf[2] * st.pdf[3])

    zero3 = torch.zeros((n, 3), device=dev)
    prop = st._replace(
        pix=pix_y, v=_set_vtx(st.v, {0: y1, 1: y2, 2: y3, 3: y4}),
        v_delta=_at(st.v_delta, {0: True, 1: False, 2: True, 3: False}),
        wo=_at(st.wo, {0: wo0, 1: d2, 2: wo3}),
        w=_at(st.w, {0: w0y, 1: w1y, 2: w2y, 3: w3y}),
        pdf=_at(st.pdf, {0: pc0y, 1: p2y, 2: pc2y, 3: p4y}),
        w_em=_at(st.w_em, {0: em_y1, 1: em_y2, 2: em_y3, 3: em_y4}),
        w_env=_at(st.w_env, {k: zero3 for k in range(K)}),
        w_rest=st.w_rest * r4)
    return prop, a


# ---------------------------------------------------------------------------
# the chains and the render
# ---------------------------------------------------------------------------

def step(ctx: Ctx, phase: str, st: PathRec, it: int, r: int,
         p_large: float = 0.3):
    """(proposal, a) of one mutation phase at step it of round r; bidir
    takes the two-vertex class on odd rounds."""
    if phase == "lens":
        return _step_lens(ctx, st, it, p_large)
    if phase == "caustic":
        return _step_caustic(ctx, st, it)
    if phase == "manifold":
        return _step_manifold(ctx, st, it)
    if phase == "mchain":
        return _step_mchain(ctx, st, it)
    if r % 2 == 1:
        return _step_bidir2(ctx, st, it)
    return _step_bidir(ctx, st, it)


def match_share(phase: str, st: PathRec, arr):
    """The share of the chains whose state has the phase's pattern."""
    m = {"caustic": lambda: _struct_caustic(st, arr),
         "manifold": lambda: _struct_manifold(st, arr),
         "mchain": lambda: _struct_mchain(st, arr),
         "bidir": lambda: _struct_bidir(st, two=False),
         "lens": lambda: _lum(traj_w(st)) >= 0}[phase]()
    return float(m.float().mean())


class MltStep(NamedTuple):
    """One Metropolis step: the phase, its round, the state it started
    from, the proposal, its acceptance a, the accept flags and the two
    (pos [N, 2], rgb [N, 3]) deposits (current and proposed state, with
    the Kelemen weights before render_mlt's scale)."""
    phase: str
    r: int
    st: PathRec
    prop: PathRec
    a: torch.Tensor
    acc: torch.Tensor
    splats: tuple


class Chains(NamedTuple):
    """b the pool's mean luminance (0-d), pick [N] the pool lane each
    chain starts from, steps an iterator of MltStep, total_steps their
    count, pool_s the pool's seconds (the clock read after a sync),
    l_pool [n_boot N] the pool's luminances."""
    b: torch.Tensor
    pick: torch.Tensor
    steps: Iterator
    total_steps: int
    pool_s: float
    l_pool: torch.Tensor


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mlt_chains(scene, n_chains: int = 1 << 14, n_mutations: int = 64,
               p_large: float = 0.3, lens_sigma: float = 0.03,
               seed: int = 0, n_boot: int = 16, mutations=PHASES) -> Chains:
    """render_mlt's chains: the n_boot x n_chains pool is traced here and
    each step runs as the iterator reaches it."""
    cfg = scene.config
    arr = scene.arrays
    dev = arr.device
    n = n_chains
    W, H = cfg.width, cfg.height
    ctx = make_ctx(scene, n, seed, lens_sigma)
    # one step per enabled phase per round, lens always on
    phases = ["lens"] + [m for m in PHASES[1:] if m in mutations]
    n_rounds = max(n_mutations // len(phases), 1)

    t0 = time.time()
    idx_pool = torch.arange(n * n_boot, device=dev)
    u = rng.uniform_2d(idx_pool, (seed * 7919 + 5) & M32, 0)
    pool = _record_path(scene, arr, torch.stack([u[:, 0] * W, u[:, 1] * H],
                                                -1), seed * 131 + 1)
    l_pool = _lum(traj_w(pool))
    b = torch.mean(l_pool)
    pick = pick_from_pool(l_pool, rng.uniform_1d(ctx.idx, (seed + 9) & M32,
                                                 0))
    st0 = _lane_gather(pool, pick)
    del pool
    _sync(dev)
    pool_s = time.time() - t0

    def steps():
        st = st0
        for r in range(n_rounds):
            for ph_i, ph in enumerate(phases):
                it = r * len(phases) + ph_i
                prop, a = step(ctx, ph, st, it, r, p_large)
                w_x = traj_w(st)
                l = _lum(w_x)
                w_cur = torch.where(l > 1e-12, (1.0 - a)
                                    / torch.clamp(l, min=1e-12), 0.0)
                w_p = traj_w(prop)
                l_p = _lum(w_p)
                wp = torch.where(l_p > 1e-12,
                                 a / torch.clamp(l_p, min=1e-12), 0.0)
                acc = rng.uniform_1d(ctx.idx, (seed + 4 + 13 * ph_i) & M32,
                                     it) < a
                yield MltStep(ph, r, st, prop, a, acc,
                              ((st.pix, w_x * w_cur[:, None]),
                               (prop.pix, w_p * wp[:, None])))
                st = _lane_select(acc, prop, st)

    return Chains(b, pick, steps(), n_rounds * len(phases), pool_s, l_pool)


def render_mlt(scene, n_chains: int = 1 << 14, n_mutations: int = 64,
               p_large: float = 0.3, lens_sigma: float = 0.03,
               seed: int = 0, n_boot: int = 16, mutations=PHASES,
               progress=None):
    """Path-space MLT: n_chains chains started from a luminance-weighted
    pick of an n_boot x n_chains pool, n_mutations steps each over the
    phases of `mutations` (lens always on; a phase whose pattern never
    occurs rejects and splats the current state again). Returns the
    [H, W, 3] image, the splats scaled by b W H / (n_chains total_steps).
    progress: callable(step, total_steps, seconds, n_chains) per step."""
    cfg = scene.config
    chains = mlt_chains(scene, n_chains, n_mutations, p_large, lens_sigma,
                        seed, n_boot, mutations)
    splat = torch.zeros((cfg.height, cfg.width, 3),
                        device=scene.arrays.device)
    t0 = time.time()
    for i, s in enumerate(chains.steps):
        for pos, rgb in s.splats:
            splat = film_mod.splat_add_only(scene.film, pos, rgb, splat)
        if progress is not None:
            progress(i + 1, chains.total_steps, time.time() - t0,
                     float(n_chains))
        t0 = time.time()
    return splat * (chains.b * (cfg.width * cfg.height)
                    / (n_chains * chains.total_steps))
