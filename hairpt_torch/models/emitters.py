"""Emitters (port of hairpt/models/emitters.py).

bake_sunsky rasterizes the Hosek-Wilkie sky and the sun disc into one
lat-long radiance table on the host (numpy, a copy of the JAX package's
bake), make_constant fills a uniform one, and make_envmap builds a
table's Vose alias table. The device queries
env_eval / env_sample / env_pdf are torch.

Area lights (emissive triangles, AreaLights, built by SceneBuilder) and
the point, spot, directional and collimated emitters (DeltaLights,
make_delta_lights) stay analytic, each with a discrete CDF for NEE's
selection (reference: Scene::sampleEmitterDirect,
src/librender/scene.cpp:828); delta_light_sample samples one delta light
for a shading point. delta_emit and area_emit sample emitted rays for
the light tracers (ptracer, vpl and the photon maps; bdpt samples its
light vertices itself).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.tiled_kernels import sqrt_rn

TWO_PI = 2.0 * np.pi

# sun angular radius (degrees) — physical value, as in src/emitters/sun.cpp
SUN_APP_RADIUS_DEG = 0.5358 / 2.0


class EnvMap(NamedTuple):
    """Baked lat-long environment with an O(1) alias sampling table."""
    image: torch.Tensor       # [H, W, 3] radiance
    to_world: torch.Tensor    # [3, 3] rotation (emitter-local -> world)
    to_local: torch.Tensor    # [3, 3]
    alias_idx: torch.Tensor   # [H*W] alias slot target
    alias_prob: torch.Tensor  # [H*W] P(keep slot)
    texel_pdf: torch.Tensor   # [H*W] discrete texel probability

    def to(self, device) -> "EnvMap":
        return EnvMap(*[t.to(device) for t in self])


# ---------------------------------------------------------------------------
# environment baking (host)
# ---------------------------------------------------------------------------

def _build_alias_table(weights: np.ndarray):
    """Vose alias method over the flat weight array (O(N) build).
    Returns (alias_idx [N] int32, alias_prob [N] float32, pdf [N] float64)."""
    w = np.asarray(weights, np.float64).reshape(-1)
    n = w.size
    pdf = w / w.sum()
    scaled = pdf * n
    alias = np.arange(n, dtype=np.int32)
    prob = np.ones(n, np.float64)
    small = list(np.nonzero(scaled < 1.0)[0][::-1])
    large = list(np.nonzero(scaled >= 1.0)[0][::-1])
    while small and large:
        s = small.pop()
        g = large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    # leftovers are ≈1 up to rounding
    for i in small + large:
        prob[i] = 1.0
    return alias, prob.astype(np.float32), pdf


def make_envmap(image: np.ndarray, to_world3=None,
                scale: float = 1.0, device=None) -> EnvMap:
    """The environment table and its alias table on `device` (the card
    unless "cpu")."""
    device = resolve_device(device)
    image = np.asarray(image, np.float32) * scale
    if to_world3 is None:
        to_world3 = np.eye(3)
    h = image.shape[0]
    lum = image @ np.array([0.212671, 0.715160, 0.072169])
    theta = (np.arange(h) + 0.5) / h * np.pi
    weights = lum * np.sin(theta)[:, None] + 1e-12
    alias_idx, alias_prob, pdf = _build_alias_table(weights)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return EnvMap(image=t(image),
                  to_world=t(np.asarray(to_world3, np.float32)),
                  to_local=t(np.linalg.inv(to_world3).astype(np.float32)),
                  alias_idx=t(alias_idx, torch.int64),
                  alias_prob=t(alias_prob),
                  texel_pdf=t(pdf.astype(np.float32)))


def make_constant(radiance, res: int = 8, device=None) -> EnvMap:
    """A constant environment (`<emitter type="constant">`): a uniform
    lat-long table."""
    img = np.broadcast_to(np.asarray(radiance, np.float32),
                          (res, 2 * res, 3)).copy()
    return make_envmap(img, device=device)


# --- Preetham sky ----------------------------------------------------------

def _perez(theta, gamma, A, B, C, D, E):
    cg = np.cos(gamma)
    return (1.0 + A * np.exp(B / np.maximum(np.cos(theta), 0.01))) \
        * (1.0 + C * np.exp(D * gamma) + E * cg * cg)


def _preetham_sky_xyY(theta, gamma, theta_s, T):
    """Preetham sky luminance/chromaticity (theta: view zenith angle,
    gamma: angle to sun, theta_s: sun zenith angle, T: turbidity)."""
    # Perez coefficients
    AY, BY, CY, DY, EY = (0.1787 * T - 1.4630, -0.3554 * T + 0.4275,
                          -0.0227 * T + 5.3251, 0.1206 * T - 2.5771,
                          -0.0670 * T + 0.3703)
    Ax, Bx, Cx, Dx, Ex = (-0.0193 * T - 0.2592, -0.0665 * T + 0.0008,
                          -0.0004 * T + 0.2125, -0.0641 * T - 0.8989,
                          -0.0033 * T + 0.0452)
    Ay, By, Cy, Dy, Ey = (-0.0167 * T - 0.2608, -0.0950 * T + 0.0092,
                          -0.0079 * T + 0.2102, -0.0441 * T - 1.6537,
                          -0.0109 * T + 0.0529)

    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2 * theta_s)
    Yz = (4.0453 * T - 4.9710) * np.tan(chi) - 0.2155 * T + 2.4192  # kcd/m2
    ts = theta_s
    tv = np.array([ts ** 3, ts ** 2, ts, 1.0])
    Tm = np.array([T * T, T, 1.0])
    xz = Tm @ np.array([[0.00166, -0.00375, 0.00209, 0.0],
                        [-0.02903, 0.06377, -0.03202, 0.00394],
                        [0.11693, -0.21196, 0.06052, 0.25886]]) @ tv
    yz = Tm @ np.array([[0.00275, -0.00610, 0.00317, 0.0],
                        [-0.04214, 0.08970, -0.04153, 0.00516],
                        [0.15346, -0.26756, 0.06670, 0.26688]]) @ tv

    Y = Yz * _perez(theta, gamma, AY, BY, CY, DY, EY) \
        / np.maximum(_perez(0.0, theta_s, AY, BY, CY, DY, EY), 1e-6)
    x = xz * _perez(theta, gamma, Ax, Bx, Cx, Dx, Ex) \
        / np.maximum(_perez(0.0, theta_s, Ax, Bx, Cx, Dx, Ex), 1e-6)
    y = yz * _perez(theta, gamma, Ay, By, Cy, Dy, Ey) \
        / np.maximum(_perez(0.0, theta_s, Ay, By, Cy, Dy, Ey), 1e-6)
    return Y, x, y


def _xyY_to_rgb(Y, x, y):
    y = np.maximum(y, 1e-6)
    X = x / y * Y
    Z = (1 - x - y) / y * Y
    M = np.array([[3.240479, -1.537150, -0.498535],
                  [-0.969256, 1.875991, 0.041556],
                  [0.055648, -0.204043, 1.057311]])
    xyz = np.stack([X, Y, Z], axis=-1)
    return np.maximum(xyz @ M.T, 0.0)


def _sun_radiance_rgb(theta_s, T):
    """Full Preetham solar radiance at the earth's surface in linear sRGB
    (reference: computeSunRadiance, src/emitters/sunsky/sunmodel.h:316-341
    — the paper's Rayleigh/aerosol/ozone/mixed-gas/water-vapor attenuation
    of the extraterrestrial solar spectrum, integrated against the CIE
    matching functions with mitsuba's ∫ȳ normalization)."""
    import os
    from ..core import spectral
    data = np.load(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "data",
        "sun_spectra.npz"))
    cos_t = max(np.cos(theta_s), 0.0)
    theta_deg = np.degrees(theta_s)
    m = 1.0 / (cos_t + 0.15 * (93.885 - theta_deg) ** -1.253)
    beta = 0.04608365822050 * T - 0.04586025928522
    lam = np.arange(350.0, 801.0, 5.0)            # nm (the reference grid)
    k_o = np.interp(lam, data["k_oWavelengths"], data["k_oAmplitudes"])
    k_g = np.interp(lam, data["k_gWavelengths"], data["k_gAmplitudes"])
    k_wa = np.interp(lam, data["k_waWavelengths"], data["k_waAmplitudes"])
    sol = np.interp(lam, data["solWavelengths"], data["solAmplitudes"])
    tau_r = np.exp(-m * 0.008735 * (lam / 1000.0) ** -4.08)
    tau_a = np.exp(-m * beta * (lam / 1000.0) ** -1.3)
    tau_o = np.exp(-m * k_o * 0.35)
    tau_g = np.exp(-1.41 * k_g * m / (1 + 118.93 * k_g * m) ** 0.45)
    w = 2.0
    tau_wa = np.exp(-0.2385 * k_wa * w * m
                    / (1 + 20.07 * k_wa * w * m) ** 0.45)
    spec = sol * tau_r * tau_a * tau_o * tau_g * tau_wa     # [L]
    cmf = np.asarray(spectral.cmf_xyz(lam))                 # [L, 3]
    xyz = (spec[:, None] * cmf).sum(0) * 5.0 / 106.856895   # ∫ȳ dλ norm
    rgb = spectral.XYZ_TO_RGB @ xyz
    return np.maximum(rgb, 0.0)


def bake_sunsky(sun_dir, turbidity: float = 3.0, sky_scale: float = 1.0,
                sun_scale: float = 1.0, sun_radius_scale: float = 1.0,
                res: int = 512, with_sun: bool = True,
                with_sky: bool = True, model: str = "hosek",
                albedo=0.15, device=None) -> EnvMap:
    """Rasterize the sun+sky model into a lat-long table.

    World convention matches the reference sky plugins: y is up.
    model: 'hosek' (Hosek-Wilkie 2012 — what the reference sky/sunsky
    plugins evaluate, src/emitters/sky.cpp:246) or 'preetham'
    (round-1 stand-in fit, kept for comparison); albedo = ground albedo
    (reference default 0.15). The table goes on `device` (the card unless
    "cpu")."""
    h, w = res, 2 * res
    sun_dir = np.asarray(sun_dir, np.float64)
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    theta_s = np.arccos(np.clip(sun_dir[1], -1, 1))

    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi
    phi = u * TWO_PI
    st = np.sin(theta)[:, None]
    d = np.stack([st * np.sin(phi)[None, :],
                  np.broadcast_to(np.cos(theta)[:, None], (h, w)),
                  st * (-np.cos(phi)[None, :])], axis=-1)  # mitsuba uv→dir

    img = np.zeros((h, w, 3), np.float32)
    cos_gamma = np.clip(d @ sun_dir, -1, 1)
    gamma = np.arccos(cos_gamma)

    if with_sky and theta_s < np.pi / 2:
        zen = np.broadcast_to(theta[:, None], (h, w))
        if model == "hosek":
            from . import hosek
            cfg, rad = hosek.cook_configuration(
                turbidity, albedo, np.pi / 2 - theta_s)
            rgb = hosek.sky_radiance(cfg, rad,
                                     np.cos(np.minimum(zen,
                                                       np.pi / 2 - 1e-3)),
                                     cos_gamma)
            # mitsuba's tristimulus normalization: the arhosek RGB
            # radiance divided by ∫ȳdλ (sky.cpp:434 "/ 106.856980")
            rgb = rgb / 106.856980
        else:
            Y, x, y = _preetham_sky_xyY(np.minimum(zen, np.pi / 2 - 0.001),
                                        gamma, theta_s, turbidity)
            rgb = _xyY_to_rgb(Y, x, y)
            # kcd/m^2-ish → roughly unit-luminance sky, then skyScale
            rgb = rgb * 0.02
        rgb[zen > np.pi / 2] = 0.0  # below horizon
        img += (sky_scale * rgb).astype(np.float32)

    if with_sun and theta_s < np.pi / 2:
        sun_r0 = np.radians(SUN_APP_RADIUS_DEG)
        sun_r = sun_r0 * sun_radius_scale
        # physical solar radiance, diluted so sunRadiusScale preserves the
        # total power (reference: sun.cpp:180-202 — the bake integrates
        # m_radiance over the UNSCALED solid angle and spreads it across
        # the scaled cone)
        rad0 = _sun_radiance_rgb(theta_s, turbidity)
        omega0 = TWO_PI * (1.0 - np.cos(sun_r0))
        omega = TWO_PI * (1.0 - np.cos(sun_r))
        disc = gamma <= sun_r
        L_sun = rad0 * (omega0 / omega)
        img[disc] += (sun_scale * L_sun).astype(np.float32)

    return make_envmap(img, device=device)


# ---------------------------------------------------------------------------
# environment queries (device)
# ---------------------------------------------------------------------------

def env_uv_from_dir(env: EnvMap, d_world):
    """Mitsuba envmap mapping: u from atan2(x, -z), v from acos(y)."""
    d = d_world @ env.to_local.T
    phi = torch.atan2(d[..., 0], -d[..., 2])
    phi = torch.where(phi < 0, phi + TWO_PI, phi)
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    return phi / TWO_PI, theta / math.pi


def env_eval(env: EnvMap, d_world):
    """Bilinear radiance lookup in direction d_world [..., 3]."""
    h, w = env.image.shape[:2]
    u, v = env_uv_from_dir(env, d_world)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0m = torch.remainder(x0, w)
    x1m = torch.remainder(x0 + 1, w)
    y0c = torch.clamp(y0, 0, h - 1)
    y1c = torch.clamp(y0 + 1, 0, h - 1)
    img = env.image
    return ((img[y0c, x0m] * (1 - fx) + img[y0c, x1m] * fx) * (1 - fy)
            + (img[y1c, x0m] * (1 - fx) + img[y1c, x1m] * fx) * fy)


def env_sample(env: EnvMap, u2):
    """Importance-sample a direction proportional to luminance * sin(theta)
    through the alias table. Returns (d_world [N, 3], radiance [N, 3],
    pdf_solid_angle [N])."""
    h, w = env.image.shape[:2]
    n = h * w
    slot = torch.clamp((u2[..., 0] * n).to(torch.int64), 0, n - 1)
    keep = u2[..., 1] < env.alias_prob[slot]
    idx = torch.where(keep, slot, env.alias_idx[slot])
    iy = idx // w
    ix = idx - iy * w
    v = (iy.to(torch.float32) + 0.5) / h
    u = (ix.to(torch.float32) + 0.5) / w
    theta = v * math.pi
    phi = u * TWO_PI
    st = torch.sin(theta)
    d_local = torch.stack([st * torch.sin(phi), torch.cos(theta),
                           -st * torch.cos(phi)], dim=-1)
    d_world = d_local @ env.to_world.T
    pdf = env.texel_pdf[idx] * (h * w) / (2.0 * math.pi * math.pi
                                          * torch.clamp(st, min=1e-5))
    radiance = env.image[iy, ix]
    return d_world, radiance, pdf


def env_pdf(env: EnvMap, d_world):
    h, w = env.image.shape[:2]
    u, v = env_uv_from_dir(env, d_world)
    ix = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    iy = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    st = torch.sin(torch.clamp(v, 1e-4, 1 - 1e-4) * math.pi)
    pdf_texel = env.texel_pdf[iy * w + ix]
    return pdf_texel * (h * w) / (2.0 * math.pi * math.pi
                                  * torch.clamp(st, min=1e-5))


# ---------------------------------------------------------------------------
# area and delta lights
# ---------------------------------------------------------------------------

class AreaLights(NamedTuple):
    """Emissive triangles for NEE (reference: src/emitters/area.cpp)."""
    p0: torch.Tensor         # [L, 3]
    e1: torch.Tensor         # [L, 3]
    e2: torch.Tensor         # [L, 3]
    n: torch.Tensor          # [L, 3] geometric normal
    radiance: torch.Tensor   # [L, 3]
    area: torch.Tensor       # [L]
    cdf: torch.Tensor        # [L] selection CDF (by power)
    tri_index: torch.Tensor  # [L] int32 index into the sorted triangles


POINT = 0
SPOT = 1
DIRECTIONAL = 2
COLLIMATED = 3


class DeltaLights(NamedTuple):
    """Point, spot, directional and collimated emitters (reference:
    src/emitters/{point,spot,directional,collimated}.cpp): delta
    distributions, reached only by NEE (MIS weight 1). A collimated beam
    is a delta in position and direction, so NEE to it always fails
    (collimated.cpp:126-134): it contributes nothing here."""
    kind: torch.Tensor        # [L] int32 POINT / SPOT / DIRECTIONAL / ...
    position: torch.Tensor    # [L, 3]
    direction: torch.Tensor   # [L, 3] spot axis / directional emission
    intensity: torch.Tensor   # [L, 3] point, spot: W/sr; directional: W/m^2
    cos_cutoff: torch.Tensor  # [L] spot outer angle
    cos_beam: torch.Tensor    # [L] spot inner (full-strength) angle
    cdf: torch.Tensor         # [L] selection CDF (by power luminance)


def make_delta_lights(entries, device=None) -> DeltaLights:
    """entries: dicts with keys kind, position, direction, intensity,
    cutoff_deg and beam_deg (the JAX package's, and its defaults); the
    table on `device` (the card unless "cpu")."""
    device = resolve_device(device)
    kind = np.array([e["kind"] for e in entries], np.int32)
    position = np.array([e.get("position", (0, 0, 0)) for e in entries],
                        np.float32)
    direction = np.array([e.get("direction", (0, 0, 1)) for e in entries],
                         np.float64)
    direction /= np.maximum(np.linalg.norm(direction, axis=-1,
                                           keepdims=True), 1e-12)
    intensity = np.array([e.get("intensity", (1, 1, 1)) for e in entries],
                         np.float32)
    cutoff = np.array([np.cos(np.radians(e.get("cutoff_deg", 20.0)))
                       for e in entries], np.float32)
    beam = np.array([np.cos(np.radians(e.get("beam_deg", 15.0)))
                     for e in entries], np.float32)
    lum = intensity @ np.array([0.212671, 0.715160, 0.072169], np.float32)
    cdf = np.cumsum(lum + 1e-9)
    cdf /= cdf[-1]

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    return DeltaLights(kind=t(kind, torch.int32), position=t(position),
                       direction=t(direction), intensity=t(intensity),
                       cos_cutoff=t(cutoff), cos_beam=t(beam), cdf=t(cdf))


def sample_cdf(cdf, u):
    """(index, its probability) of u in a discrete CDF (searchsorted to
    the left, clipped to the table): the JAX package's
    _sample_discrete_cdf, which NEE's area lights and delta_light_sample
    share."""
    idx = torch.clamp(torch.searchsorted(cdf, u.contiguous()), 0,
                      cdf.shape[0] - 1)
    lo = torch.where(idx > 0, cdf[torch.clamp(idx - 1, min=0)], 0.0)
    return idx, cdf[idx] - lo


def delta_light_sample(dl: DeltaLights, p, u):
    """Sample one delta light for shading points p [N, 3]. Returns (d [N,
    3], dist [N], contribution Le / pdf_positional [N, 3], selection
    probability [N]). The square root is rounded to nearest on every host
    (tiled_kernels.sqrt_rn; p carries no gradient)."""
    l, prob = sample_cdf(dl.cdf, u)
    kind = dl.kind[l]
    to_l = dl.position[l] - p
    d2 = torch.sum(to_l * to_l, dim=-1)
    dist_p = sqrt_rn(torch.clamp(d2, min=1e-20))
    d_point = to_l / dist_p[..., None]
    inten = dl.intensity[l]
    contrib_pt = inten / torch.clamp(d2, min=1e-12)[..., None]
    # spot falloff (reference: spot.cpp falloffCurve, a linear blend)
    cos_a = -torch.sum(dl.direction[l] * d_point, dim=-1)
    cc = dl.cos_cutoff[l]
    cb = dl.cos_beam[l]
    fall = torch.clamp((cos_a - cc) / torch.clamp(cb - cc, min=1e-6),
                       0.0, 1.0)
    fall = torch.where(cos_a >= cb, 1.0, fall)
    contrib_spot = contrib_pt * fall[..., None]
    is_dir = kind == DIRECTIONAL
    d = torch.where(is_dir[..., None], -dl.direction[l], d_point)
    dist = torch.where(is_dir, float("inf"), dist_p)
    contrib = torch.where(is_dir[..., None], inten,
                          torch.where((kind == SPOT)[..., None],
                                      contrib_spot, contrib_pt))
    # collimated: direct sampling of a 0D response always fails
    contrib = torch.where((kind == COLLIMATED)[..., None], 0.0, contrib)
    return d, dist, contrib, prob


def delta_emit(dl: DeltaLights, u_sel, u_dir, center, radius):
    """Sample an emitted ray from the delta-light set (light tracing and
    photon shooting; reference: {point,spot,directional,collimated}.cpp
    sampleRay). Returns (o [N, 3], d [N, 3], power [N, 3], (light index,
    selection probability)) where power is the per-ray flux estimate
    Phi / pdf already divided by the selection probability (the caller
    divides by the photon count). center / radius: the scene's bounding
    sphere (directional emitters start on a tangent disk)."""
    from ..core import warps
    from ..core.math import coordinate_system
    l, prob = sample_cdf(dl.cdf, u_sel)
    prob = torch.clamp(prob, min=1e-12)
    kind = dl.kind[l]
    pos = dl.position[l]
    axis = dl.direction[l]
    inten = dl.intensity[l]

    # point: uniform sphere, Phi = 4 pi I
    d_sph = warps.square_to_uniform_sphere(u_dir)
    pw_point = inten * (4.0 * math.pi)

    # spot: uniform cone inside the cutoff, weighted by the falloff curve;
    # Phi / pdf = I 2 pi (1 - cosCutoff) falloff (spot.cpp sampleRay)
    cc = dl.cos_cutoff[l]
    cb = dl.cos_beam[l]
    s_a, t_a = coordinate_system(axis)
    cone = warps.square_to_uniform_cone(u_dir, cc)
    d_cone = s_a * cone[..., 0:1] + t_a * cone[..., 1:2] \
        + axis * cone[..., 2:3]
    cos_a = cone[..., 2]
    fall = torch.clamp((cos_a - cc) / torch.clamp(cb - cc, min=1e-6),
                       0.0, 1.0)
    fall = torch.where(cos_a >= cb, 1.0, fall)
    pw_spot = inten * (TWO_PI * (1.0 - cc))[..., None] * fall[..., None]

    # directional: start on a tangent disk behind the scene; Phi = E pi R^2
    disk = warps.square_to_uniform_disk_concentric(u_dir) * radius
    o_dir = center - axis * radius * 1.5 \
        + s_a * disk[..., 0:1] + t_a * disk[..., 1:2]
    pw_dir = inten * (math.pi * radius * radius)

    # collimated: the exact beam; the intensity field stores the power Phi
    is_dir = (kind == DIRECTIONAL)[..., None]
    is_coll = (kind == COLLIMATED)[..., None]
    is_spot = (kind == SPOT)[..., None]
    o = torch.where(is_dir, o_dir, pos)
    d = torch.where(is_dir | is_coll, axis,
                    torch.where(is_spot, d_cone, d_sph))
    pw = torch.where(is_coll, inten,
                     torch.where(is_dir, pw_dir,
                                 torch.where(is_spot, pw_spot, pw_point)))
    return o, d, pw / prob[..., None], (l, prob)


def area_emit(al: AreaLights, u_sel, u_tri, u_dir):
    """Sample an emitted ray from the area-light set (area.cpp
    samplePosition and the cosine sampleDirection). Returns (o, d, n,
    power) with power = L pi A / p_sel (the flux estimate, divided by the
    selection probability)."""
    from ..core import warps
    from ..core.math import coordinate_system
    l, prob = sample_cdf(al.cdf, u_sel)
    prob = torch.clamp(prob, min=1e-12)
    b = warps.square_to_uniform_triangle(u_tri)
    o = al.p0[l] + al.e1[l] * b[..., 0:1] + al.e2[l] * b[..., 1:2]
    n = al.n[l]
    s_a, t_a = coordinate_system(n)
    loc = warps.square_to_cosine_hemisphere(u_dir)
    d = s_a * loc[..., 0:1] + t_a * loc[..., 1:2] + n * loc[..., 2:3]
    pw = al.radiance[l] * (math.pi * al.area[l] / prob)[..., None]
    return o, d, n, pw
