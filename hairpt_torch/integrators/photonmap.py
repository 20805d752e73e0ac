"""Photon mapping (port of hairpt/integrators/photonmap.py; reference
src/integrators/photonmapper/*, src/librender/{photon,photonmap,
gatherproc}.cpp).

The light pass is the wavefront machinery run from the emitter side:
_env_emit picks an emitter group per photon with the scene's NEE
probabilities (the environment from a tangent disk of the scene's
bounding sphere, the area lights through emitters.area_emit, the delta
lights through emitters.delta_emit), and trace_photons deposits at every
surface hit and scatters by the BSDF with Russian roulette. The photon
map is a sorted uniform hash grid (build_photon_map: one stable sort by
cell key). The gather (gather_flux) asks kernel K (ops/photon_query.py)
for each lane's near (lane, photon) pairs and evaluates the BSDF on those
pairs only, in chunks of at most photon_query.PAIR_CAP pairs, summing f /
max(|cos|, 1e-4) Phi per lane (the JAX package evaluates every slot of
the 27 cells and masks). render_photonmap visualizes the global map at
the first camera hit, render_ppm averages passes of shrinking radius,
render_sppm keeps per-pixel radius, flux and count.

The volumetric branch (render_volumetric_photonmap, a global homogeneous
fog): trace_volume_photons deposits at medium events, build_volume_photon_map
shuffles, sorts and gives each photon a density-adapted disc radius, and
bre_query, the beam radiance estimate, asks kernel K's beam mode for the
pairs (each owned by the march step holding its perpendicular foot) and
evaluates the phase function, the Silverman kernel, the transmittance and
the cell's occupancy rescale on them. A grid medium is refused
(NotImplementedError): the JAX package's branch reads the homogeneous
fog's depth and fails on one.

Sample dimensions, seeds (wrapped to 32 bits as the JAX package's uint32
arithmetic wraps) and constants are the JAX package's; the queries are
the port's (integrators/common.py: kernels A and B on the hair, F on the
triangles), the photon and light rays Morton-sorted, which changes no
ray's answer.
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ..core import rng
from ..core.math import Ray, dot
from ..film import film as film_mod
from ..models import emitters as em
from ..models import media as med
from ..models import sensors
from ..models.bsdf import registry as mat
from ..ops import photon_query as pq
from .common import frame, scene_intersect
from .path import DIM_BASE, DIM_STRIDE, _env_radiance, _swept_params
from .volpath import _offset

M32 = 0xFFFFFFFF


class PhotonMap(NamedTuple):
    pos: torch.Tensor       # [M, 3] sorted by grid cell
    power: torch.Tensor     # [M, 3]
    wi: torch.Tensor        # [M, 3] incident direction (towards the surface)
    cell: torch.Tensor      # [M] int32 sorted cell keys
    valid: torch.Tensor     # [M] bool
    grid_min: torch.Tensor  # [3]
    inv_cell: float         # 1 / cell size (its float32 value)
    grid_res: int           # cells per axis

    def grid(self) -> pq.Grid:
        return pq.Grid(self.pos, self.cell, self.valid, self.grid_min,
                       self.inv_cell, self.grid_res)


class VolPhotonMap(NamedTuple):
    pos: torch.Tensor       # [M, 3] sorted by cell
    power: torch.Tensor     # [M, 3] flux (sigma_s / pdf weights included)
    wi: torch.Tensor        # [M, 3] propagation direction at the event
    cell: torch.Tensor      # [M] sorted cell keys
    valid: torch.Tensor     # [M]
    radius: torch.Tensor    # [M] per-photon disc radius (density-adapted)
    grid_min: torch.Tensor
    inv_cell: float
    grid_res: int

    def grid(self) -> pq.Grid:
        return pq.Grid(self.pos, self.cell, self.valid, self.grid_min,
                       self.inv_cell, self.grid_res, radius=self.radius)


def _scene_bsphere(arr):
    """(center [3], radius []) of the triangles' and hair's p0 bounds,
    the radius widened by 1.2 and 1e-3."""
    los, his = [], []
    for g in (arr.tri, arr.hair):
        if g is not None:
            los.append(torch.amin(g.p0, dim=0))
            his.append(torch.amax(g.p0, dim=0))
    lo = torch.amin(torch.stack(los), dim=0)
    hi = torch.amax(torch.stack(his), dim=0)
    center = 0.5 * (lo + hi)
    radius = 0.5 * torch.linalg.norm(hi - lo) * 1.2 + 1e-3
    return center, radius


def _u32(x: int) -> int:
    return int(x) & M32


def _emit_env(arr, center, radius, u_dir, u_disk):
    """Environment photons: an importance-sampled direction, the start on
    a tangent disk of radius R (envmap.cpp samplePosition /
    sampleDirection). Returns (o, d, L / pdf pi R^2)."""
    from ..core import warps
    from ..core.math import coordinate_system
    d_env, le, pdf_dir = em.env_sample(arr.env, u_dir)
    d_e = -d_env
    disk = warps.square_to_uniform_disk_concentric(u_disk) * radius
    s, t = coordinate_system(d_e)
    o_e = center - d_e * radius * 1.5 + s * disk[..., 0:1] \
        + t * disk[..., 1:2]
    pw_e = le / torch.clamp(pdf_dir, min=1e-12)[..., None] \
        * (math.pi * radius * radius)
    return o_e, d_e, pw_e


def _env_emit(scene, n: int, seed: int):
    """Emit photons from every emitter group present (environment, area
    lights, delta lights), a group per photon by the scene's NEE
    probabilities (reference: the per-plugin Emitter::sampleRay of
    ParticleProcess). Returns (ray, power / n)."""
    arr = scene.arrays
    dev = arr.device
    center, radius = _scene_bsphere(arr)
    idx = torch.arange(n, device=dev)
    seed = _u32(seed)
    u_dir = rng.uniform_2d(idx, seed, 0)
    u_disk = rng.uniform_2d(idx, seed, 2)
    u_grp = rng.uniform_1d(idx, seed, 4)
    u_sel = rng.uniform_1d(idx, seed, 5)
    u_tri = rng.uniform_2d(idx, seed, 6)

    p_env, p_area, p_delta = scene.config.nee_probs
    origin = center.expand(n, 3)
    d = torch.zeros((n, 3), device=dev)
    d[:, 2] = 1.0
    power = torch.zeros((n, 3), device=dev)
    grp = torch.where(u_grp < p_env, 0,
                      torch.where(u_grp < p_env + p_area, 1, 2))
    if arr.env is not None and p_env > 0:
        o_e, d_e, pw_e = _emit_env(arr, center, radius, u_dir, u_disk)
        m = (grp == 0)[..., None]
        origin = torch.where(m, o_e, origin)
        d = torch.where(m, d_e, d)
        power = torch.where(m, pw_e / p_env, power)
    if arr.area is not None and p_area > 0:
        o_a, d_a, _, pw_a = em.area_emit(arr.area, u_sel, u_tri, u_dir)
        m = (grp == 1)[..., None]
        origin = torch.where(m, o_a, origin)
        d = torch.where(m, d_a, d)
        power = torch.where(m, pw_a / p_area, power)
    if arr.delta is not None and p_delta > 0:
        o_d, d_d, pw_d, _ = em.delta_emit(arr.delta, u_sel, u_dir, center,
                                          radius)
        m = (grp == 2)[..., None]
        origin = torch.where(m, o_d, origin)
        d = torch.where(m, d_d, d)
        power = torch.where(m, pw_d / p_delta, power)
    eps = scene.config.ray_eps
    z = torch.zeros((n,), device=dev)
    return Ray(o=origin + d * eps, d=d, mint=z,
               maxt=torch.full((n,), float("inf"), device=dev)), power / n


def _flip_frame(arr, hit, wi_world):
    """(frame, flipped geometric normal) with the twosided flip."""
    two = arr.materials.twosided[torch.clamp(hit.mat_id, min=0).long()]
    flip = (two & (dot(hit.sh_n, wi_world) < 0))[..., None]
    fr = frame(hit)._replace(n=torch.where(flip, -hit.sh_n, hit.sh_n),
                             t=torch.where(flip, -hit.sh_t, hit.sh_t))
    return fr, torch.where(flip, -hit.geo_n, hit.geo_n)


def trace_photons(scene, n_photons: int, max_bounces: int = 4,
                  seed: int = 0):
    """Light-tracing pass: per-deposit (pos, power, wi, valid), n_photons
    x max_bounces slots, bounce-major (reference: GatherPhotonProcess,
    ParticleTracer::handleSurfaceInteraction)."""
    cfg = scene.config
    arr = scene.arrays
    params = _swept_params(cfg)
    dev = arr.device
    idx = torch.arange(n_photons, device=dev)
    smp = rng.Sampler(cfg.sampler, idx, _u32(seed * 977 + 13))
    ray, pw = _env_emit(scene, n_photons, seed)
    o, d = ray.o, ray.d
    alive = torch.ones((n_photons,), dtype=torch.bool, device=dev)
    z = torch.zeros((n_photons,), device=dev)
    deps = []
    for b in range(max_bounces):
        r = Ray(o=o, d=d, mint=z, maxt=torch.where(alive, float("inf"), 0.0))
        hit = scene_intersect(arr, r, sort_rays=True, **params)
        landed = alive & hit.valid
        wi_world = -d
        fr, geo_n = _flip_frame(arr, hit, wi_world)
        wi = fr.to_local(wi_world)
        deps.append((hit.p, torch.where(landed[..., None], pw, 0.0),
                     wi_world, landed))
        gm = mat.gather(arr.materials, arr.checkers, hit.mat_id, hit.uv)
        dims = DIM_BASE + b * DIM_STRIDE
        wo, w, _, _, _ = mat.sample(scene.active_kinds, gm, wi,
                                    smp.next_1d(dims + 3),
                                    smp.next_2d(dims + 4),
                                    smp.next_2d(dims + 6), arr.hair_tables)
        wo_world = fr.to_world(wo)
        pw2 = pw * w
        # Russian roulette on the photon's power
        q = torch.clamp(torch.amax(w, dim=-1), 0.0, 0.95)
        keep = smp.next_1d(dims + 8) < q
        pw = pw2 / torch.clamp(q, min=1e-6)[..., None]
        alive = landed & keep & (torch.amax(pw, dim=-1) > 0)
        o = _offset(hit.p, geo_n, wo_world, cfg.ray_eps)
        d = wo_world
    return tuple(torch.stack([x[k] for x in deps]).reshape(
        (-1,) + deps[0][k].shape[1:]) for k in range(4))


def _cell_keys(pos, valid, radius: float, grid_res: int):
    """(grid_min, inv_cell float, int32 keys) of the hash grid; invalid
    photons carry grid_res^3."""
    lo = torch.amin(torch.where(valid[:, None], pos, float("inf")),
                    dim=0) - radius
    inv = float(np.float32(1.0 / radius))
    f = (pos - lo) * torch.tensor(inv, dtype=torch.float32,
                                  device=pos.device)
    f = torch.where(torch.isnan(f), 0.0, torch.clamp(f, -1e9, 1e9))
    ijk = torch.clamp(f.to(torch.int32), 0, grid_res - 1)
    key = (ijk[:, 0] * grid_res + ijk[:, 1]) * grid_res + ijk[:, 2]
    key = torch.where(valid, key, torch.tensor(
        grid_res ** 3, dtype=torch.int32, device=pos.device))
    return lo, inv, key.to(torch.int32)


def build_photon_map(pos, power, wi, valid, radius: float,
                     grid_res: int = 256) -> PhotonMap:
    """Hash grid over the photons: one stable sort by cell key (replaces
    the reference's balanced kd-tree photon map, photonmap.cpp)."""
    lo, inv, key = _cell_keys(pos, valid, radius, grid_res)
    order = torch.argsort(key, stable=True)
    return PhotonMap(pos=pos[order].contiguous(), power=power[order],
                     wi=wi[order], cell=key[order].contiguous(),
                     valid=valid[order].contiguous(), grid_min=lo,
                     inv_cell=inv, grid_res=grid_res)


def gather_flux(pm: PhotonMap, scene, hit, wi_local, fr, r2,
                max_per_cell: int = 32):
    """(sum of f(wi -> wo) Phi, photon count) per lane over the photons
    within the per-lane squared radius r2 (a float or [N]) in the 27
    neighbour cells: kernel K's pairs, the BSDF evaluated on the pairs
    (chunks of at most photon_query.PAIR_CAP)."""
    arr = scene.arrays
    n = hit.p.shape[0]
    dev = hit.p.device
    acc = torch.zeros((n, 3), device=dev)
    count = torch.zeros((n,), device=dev)
    gm = mat.gather(arr.materials, arr.checkers, hit.mat_id, hit.uv)
    for lane, idx in pq.iter_surface_pairs(pm.grid(), hit.p, r2,
                                           max_per_cell):
        if lane.numel() == 0:
            continue
        w_ph = pm.wi[idx]
        wo_loc = torch.stack([dot(w_ph, fr.s[lane]), dot(w_ph, fr.t[lane]),
                              dot(w_ph, fr.n[lane])], dim=-1)
        gm_b = mat.GatheredMat(*[x[lane] for x in gm])
        f, _ = mat.eval_pdf(scene.active_kinds, gm_b, wi_local[lane], wo_loc,
                            arr.hair_tables)
        # photons carry flux; f holds |cos| through the local wo: divide
        # it back out (the flux estimate needs plain f)
        cosw = torch.clamp(torch.abs(wo_loc[..., 2]), min=1e-4)[..., None]
        acc.index_add_(0, lane, f / cosw * pm.power[idx])
        count.index_add_(0, lane, torch.ones_like(lane, dtype=torch.float32))
    return acc, count


def gather_radiance(pm: PhotonMap, scene, hit, wi_local, fr, radius: float,
                    max_per_cell: int = 32):
    """The density estimate: gather_flux / (pi r^2)."""
    flux, _ = gather_flux(pm, scene, hit, wi_local, fr, radius * radius,
                          max_per_cell)
    return flux / (math.pi * radius * radius)


def _camera_wave(scene, sample_id: int):
    """(film positions, camera ray, its hit, frame, wi local) of one
    camera wave, lanes in pixel order."""
    cfg = scene.config
    arr = scene.arrays
    dev = arr.device
    n_pix = cfg.width * cfg.height
    pixel = torch.arange(n_pix, device=dev)
    smp = rng.Sampler(cfg.sampler, pixel, _u32(sample_id))
    px = (pixel % cfg.width).to(torch.float32)
    py = (pixel // cfg.width).to(torch.float32)
    j2 = smp.next_2d(0)
    p2 = torch.stack([px + j2[..., 0], py + j2[..., 1]], -1)
    ray = sensors.sample_ray(scene.camera, p2, None)
    hit = scene_intersect(arr, ray, **_swept_params(cfg))
    fr, _ = _flip_frame(arr, hit, -ray.d)
    return p2, ray, hit, fr, fr.to_local(-ray.d)


def render_photonmap(scene, n_photons: int = 1 << 16, radius: float = 0.1,
                     max_bounces: int = 4, spp: int = 4, seed: int = 0,
                     progress=None):
    """Visualize the global photon map at the first camera intersection.
    progress: callable(done_spp, total_spp, seconds, n_pairs) per wave
    (the first wave's seconds include the photon pass)."""
    cfg = scene.config
    fl = scene.film
    dev = scene.arrays.device
    t0 = time.time()
    pm = build_photon_map(*trace_photons(scene, n_photons, max_bounces,
                                         seed), radius)
    image, weight = film_mod.zeros(fl, dev)
    for s in range(spp):
        p2, ray, hit, fr, wi_l = _camera_wave(scene, s + seed * 65536)
        rad = gather_radiance(pm, scene, hit, wi_l, fr, radius)
        rad = torch.where(hit.valid[..., None], rad,
                          _env_radiance(scene.arrays, ray.d))
        rad = torch.nan_to_num(rad, nan=0.0, posinf=0.0, neginf=0.0)
        image, weight = film_mod.splat_samples(fl, p2, rad, image, weight)
        if progress is not None:
            progress(s + 1, spp, time.time() - t0, 0.0)
            t0 = time.time()
    return film_mod.develop(image, weight)


def render_ppm(scene, n_photons: int = 1 << 14, passes: int = 4,
               radius0: float = 0.3, alpha: float = 0.7, spp: int = 2,
               seed: int = 0, progress=None):
    """Progressive photon mapping (reference: photonmapper/ppm.cpp):
    photon passes with the radius shrinking as r_{i+1}^2 = r_i^2 (i +
    alpha) / (i + 1), the passes' estimates averaged. progress:
    callable(done_passes, passes, seconds, 0) per pass."""
    acc = None
    r = radius0
    for i in range(passes):
        t0 = time.time()
        img = render_photonmap(scene, n_photons=n_photons, radius=r,
                               spp=spp, seed=seed * 131 + i)
        acc = img if acc is None else acc + img
        r = float(np.sqrt(r * r * (i + alpha) / (i + 1)))
        if progress is not None:
            progress(i + 1, passes, time.time() - t0, 0.0)
    return acc / passes


def render_sppm(scene, n_photons: int = 1 << 14, passes: int = 6,
                radius0: float = 0.3, alpha: float = 0.7, seed: int = 0,
                progress=None):
    """Stochastic progressive photon mapping (reference:
    photonmapper/sppm.cpp): per-pixel radius^2, accumulated flux tau and
    photon count N with the update N' = N + alpha M, r'^2 = r^2 N' / (N +
    M), tau' = (tau + Phi) r'^2 / r^2, a fresh jittered camera hit every
    pass. progress: callable(done_passes, passes, seconds, 0) per pass."""
    cfg = scene.config
    arr = scene.arrays
    dev = arr.device
    n_pix = cfg.width * cfg.height
    r2 = torch.full((n_pix,), radius0 * radius0, device=dev)
    tau = torch.zeros((n_pix, 3), device=dev)
    nacc = torch.zeros((n_pix,), device=dev)
    env_acc = torch.zeros((n_pix, 3), device=dev)
    for p in range(passes):
        t0 = time.time()
        pm = build_photon_map(*trace_photons(scene, n_photons, 4,
                                             seed * 131 + p), radius0)
        _, ray, hit, fr, wi_l = _camera_wave(scene, p)
        flux, m = gather_flux(pm, scene, hit, wi_l, fr, r2)
        flux = torch.where(hit.valid[..., None], flux, 0.0)
        m = torch.where(hit.valid, m, 0.0)
        n_new = nacc + alpha * m
        frac = torch.where(nacc + m > 0,
                           n_new / torch.clamp(nacc + m, min=1e-6), 1.0)
        r2 = r2 * frac
        tau = (tau + flux) * frac[..., None]
        nacc = n_new
        env_acc = env_acc + torch.where(hit.valid[..., None], 0.0,
                                        _env_radiance(arr, ray.d))
        if progress is not None:
            progress(p + 1, passes, time.time() - t0, 0.0)
    # tau holds the powers normalized by photons per pass (trace_photons
    # divides by n_photons): average over the passes
    l_ind = tau / (passes * math.pi * torch.clamp(r2, min=1e-12))[..., None]
    img = torch.nan_to_num(l_ind + env_acc / passes, nan=0.0, posinf=0.0,
                           neginf=0.0)
    return img.reshape(cfg.height, cfg.width, 3)


# ---------------------------------------------------------------------------
# Volumetric photon mapping with the beam radiance estimate (reference:
# photonmapper/bre.cpp: photon discs with per-photon radii, queried by
# camera beams). The photon kd-tree becomes the same sorted hash grid;
# the beam query is a fixed-step march where each step owns the photons
# whose perpendicular foot falls inside it.
# ---------------------------------------------------------------------------

def _homogeneous(medium):
    if not isinstance(medium, med.Medium):
        raise NotImplementedError(
            "volumetric photon mapping takes a homogeneous scene medium; "
            "the JAX package's branch reads the fog's depth and fails on "
            "a grid medium (render it with volpath)")


def trace_volume_photons(scene, medium, n_photons: int,
                         max_bounces: int = 8, seed: int = 0):
    """Photon pass through a homogeneous medium: spectral-MIS free flights
    (the volumetric path tracer's), a deposit at every medium event (its
    power carries sigma_s T / pdf), phase-function scattering and Russian
    roulette. A surface hit ends the volume path."""
    _homogeneous(medium)
    cfg = scene.config
    arr = scene.arrays
    params = _swept_params(cfg)
    dev = arr.device
    idx = torch.arange(n_photons, device=dev)
    sd = _u32(seed * 977 + 29)
    ray, pw = _env_emit(scene, n_photons, seed)
    pk = medium.phase_kind
    o, d = ray.o, ray.d
    alive = torch.ones((n_photons,), dtype=torch.bool, device=dev)
    z = torch.zeros((n_photons,), device=dev)
    deps = []
    for b in range(max_bounces):
        r = Ray(o=o, d=d, mint=z, maxt=torch.where(alive, float("inf"), 0.0))
        hit = scene_intersect(arr, r, sort_rays=True, **params)
        t_surf = torch.where(hit.valid, hit.t, medium.fog_depth)
        dims = DIM_BASE + b * DIM_STRIDE
        dist, is_med, w_d = med.sample_distance(
            medium, rng.uniform_1d(idx, sd, dims + 0),
            rng.uniform_1d(idx, sd, dims + 1), t_surf)
        landed = alive & is_med
        p_evt = o + d * dist[..., None]
        pw_evt = pw * w_d
        deps.append((p_evt, torch.where(landed[..., None], pw_evt, 0.0), d,
                     landed))
        wo, pdf_ph = med.phase_sample(pk, medium.g, -d,
                                      rng.uniform_2d(idx, sd, dims + 2),
                                      medium.phase_p, medium.orientation,
                                      medium.mix)
        if pk in (med.HG, med.ISOTROPIC, med.RAYLEIGH):
            w_ph = torch.ones((n_photons,), device=dev)
        else:
            w_ph = torch.where(pdf_ph > 0, med.phase_eval(
                pk, medium.g, -d, wo, medium.phase_p, medium.orientation,
                medium.mix) / torch.clamp(pdf_ph, min=1e-20), 0.0)
        pw2 = pw_evt * w_ph[..., None]
        q = torch.clamp(torch.amax(pw2, dim=-1)
                        / torch.clamp(torch.amax(pw, dim=-1), min=1e-9),
                        0.05, 0.95)
        keep = rng.uniform_1d(idx, sd, dims + 4) < q
        pw = pw2 / torch.clamp(q, min=1e-6)[..., None]
        alive = landed & keep & (torch.amax(pw, dim=-1) > 0)
        o, d = p_evt, wo
    return tuple(torch.stack([x[k] for x in deps]).reshape(
        (-1,) + deps[0][k].shape[1:]) for k in range(4))


def build_volume_photon_map(pos, power, wi, valid, radius: float,
                            grid_res: int = 128,
                            density_k: float = 8.0) -> VolPhotonMap:
    """Sorted hash grid of the volume photons with per-photon radii from
    the own-cell count under a locally uniform density: r_i = (3 k / (4
    pi rho_i))^(1/3), clamped to [cell / 4, cell] (reference: the reduced
    k-NN search of bre.cpp:84-118). The photons are shuffled by a hash
    first, so a dense cell's capped prefix in bre_query is an unbiased
    subsample."""
    M = pos.shape[0]
    dev = pos.device
    hkey = rng.hash_u32(torch.arange(M, device=dev) ^ 0xB5E)
    shuf = torch.argsort(hkey, stable=True)
    pos, power, wi, valid = pos[shuf], power[shuf], wi[shuf], valid[shuf]
    lo, inv, key = _cell_keys(pos, valid, radius, grid_res)
    order = torch.argsort(key, stable=True)
    key_s = key[order].contiguous()
    start = torch.searchsorted(key_s, key_s)
    end = torch.searchsorted(key_s, key_s, right=True)
    n_cell = torch.clamp((end - start).to(torch.float32), min=1.0)
    f32 = lambda x: torch.tensor(float(np.float32(x)), dtype=torch.float32,
                                 device=dev)
    rho = n_cell * f32((1.0 / radius) ** 3)
    r_i = (3.0 * density_k / (f32(4.0 * math.pi) * rho)) \
        ** f32(1.0 / 3.0)
    r_i = torch.clamp(r_i, 0.25 * radius, radius)
    return VolPhotonMap(pos=pos[order].contiguous(), power=power[order],
                        wi=wi[order], cell=key_s,
                        valid=valid[order].contiguous(), radius=r_i,
                        grid_min=lo, inv_cell=inv, grid_res=grid_res)


def bre_query(vpm: VolPhotonMap, medium, o, d, t_end, n_steps: int,
              max_per_cell: int = 16):
    """Beam radiance estimate along o + t d, t in (0, t_end) (bre.cpp
    query): the sum over the photon discs the beam crosses of T(sigma_t
    foot) Phi phase(w_j -> -d) K2(b^2 / r^2) / r^2, K2(x) = 3 / pi (1 -
    x)^2, each times its cell's occupancy rescale max(n_c, 1) /
    min(max(n_c, 1), max_per_cell). Kernel K's beam pairs, evaluated in
    chunks."""
    _homogeneous(medium)
    g = vpm.grid()
    n = o.shape[0]
    dev = o.device
    acc = torch.zeros((n, 3), device=dev)
    gr = vpm.grid_res
    h = torch.tensor(g.h, dtype=torch.float32, device=dev)
    offs = torch.tensor(pq.OFFSETS, dtype=torch.int64, device=dev)
    for lane, idx, sc in pq.iter_beam_pairs(g, o, d, t_end, n_steps,
                                            max_per_cell):
        if lane.numel() == 0:
            continue
        ol, dl = o[lane], d[lane]
        # the pair's cell: its step's query cell plus its offset
        t_mid = ((sc // 27).to(torch.float32) + 0.5) * h
        p_step = ol + dl * t_mid[..., None]
        q = torch.stack([pq._cell_of(p_step[:, k], g.gmin_host[k], g.inv)
                         for k in range(3)], -1) + offs[sc % 27]
        key = ((q[:, 0] * gr + q[:, 1]) * gr + q[:, 2]).to(torch.int32)
        n_c = (torch.searchsorted(vpm.cell, key, right=True)
               - torch.searchsorted(vpm.cell, key)).to(torch.float32)
        cell_scale = torch.clamp(n_c, min=1.0) / torch.clamp(
            torch.clamp(n_c, min=1.0), max=float(max_per_cell))
        rel = vpm.pos[idx] - ol
        foot = pq._dot3(rel, dl)
        b2 = pq._dot3(rel, rel) - foot * foot
        r2 = vpm.radius[idx] ** 2
        k2 = (3.0 / math.pi) * (1.0 - b2 / torch.clamp(r2, min=1e-12)) ** 2
        ph = med.phase_eval(medium.phase_kind, medium.g, -vpm.wi[idx], -dl,
                            medium.phase_p, medium.orientation, medium.mix)
        tr = torch.exp(-medium.sigma_t[None, :] * foot[..., None])
        c = tr * vpm.power[idx] * (ph * k2 / torch.clamp(r2, min=1e-12)
                                   )[..., None]
        acc.index_add_(0, lane, cell_scale[:, None] * c)
    return acc


def render_volumetric_photonmap(scene, n_photons: int = 1 << 15,
                                radius: float = 0.25, max_bounces: int = 8,
                                spp: int = 4, seed: int = 0,
                                n_steps: int | None = None, progress=None):
    """Photon-mapped render of a scene in a global homogeneous medium: the
    in-scattered radiance along each camera ray from the beam radiance
    estimate plus the surface (photon-map estimate) or environment
    radiance attenuated by the medium's transmittance. progress:
    callable(done_spp, total_spp, seconds, 0) per wave (the first wave's
    seconds include both photon passes)."""
    medium = scene.medium
    if medium is None:
        raise ValueError("the volumetric photon map needs a scene medium")
    _homogeneous(medium)
    cfg = scene.config
    fl = scene.film
    dev = scene.arrays.device
    t0 = time.time()
    vpm = build_volume_photon_map(*trace_volume_photons(
        scene, medium, n_photons, max_bounces, seed), radius)
    # the surface photon map for the attenuated surface component
    pm = build_photon_map(*trace_photons(scene, n_photons, max_bounces,
                                         seed + 7), radius)
    fog = float(medium.fog_depth)
    if n_steps is None:
        n_steps = int(min(256, np.ceil(float(min(fog, 60.0)) / radius)))
    image, weight = film_mod.zeros(fl, dev)
    for s in range(spp):
        p2, ray, hit, fr, wi_l = _camera_wave(scene, s + seed * 65536)
        t_end = torch.where(hit.valid, hit.t,
                            torch.clamp(medium.fog_depth, max=1e6))
        lv = bre_query(vpm, medium, ray.o, ray.d, t_end, n_steps)
        surf = gather_radiance(pm, scene, hit, wi_l, fr, radius)
        ls = torch.where(hit.valid[..., None], surf,
                         _env_radiance(scene.arrays, ray.d))
        tr_end = torch.exp(-medium.sigma_t[None, :] * t_end[..., None])
        rad = torch.nan_to_num(lv + tr_end * ls, nan=0.0, posinf=0.0,
                               neginf=0.0)
        image, weight = film_mod.splat_samples(fl, p2, rad, image, weight)
        if progress is not None:
            progress(s + 1, spp, time.time() - t0, 0.0)
            t0 = time.time()
    return film_mod.develop(image, weight)
