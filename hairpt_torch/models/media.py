"""Participating media: homogeneous media, the phase functions, grid
volumes and Woodcock tracking (port of hairpt/models/media.py; reference
src/medium/{homogeneous,heterogeneous}.cpp, src/phase/{isotropic,hg,
rayleigh,kkay,microflake,mixturephase}.cpp, src/volume/{gridvolume,
hgridvolume,volcache}.cpp).

The names, constants and arithmetic are the JAX package's. The tables are
built with numpy at build time, as there, and live on the device as
tensors (the JAX package keeps them on the host only for its compile
tunnel). A Medium's g, fog_depth, sigma_t and phase parameters are
float32 tensors, so every phase-function operation runs in float32 as
the JAX package's does; a mixture child's g stays a Python float, as in
the JAX package.

Heterogeneous media sample free-flight distances by delta tracking and
estimate shadow-ray transmittance by ratio tracking. The JAX package
writes both as a jax.lax.while_loop over the wave; here woodcock_sample
and woodcock_transmittance launch kernel J (csrc/woodcock.cu: one thread
per lane walks the lane's whole free flight) on CUDA tensors and run the
plain loops (woodcock_sample_plain, woodcock_transmittance_plain: the JAX
package's loop, one shared iteration counter) on CPU tensors; there is
no other branch. A lane's k-th step is the plain loop's iteration k, so
the kernel draws the same numbers as the loop and stops at the same cap.
LAUNCHES counts kernel J's launches per mode, PLAIN_ON_CUDA the plain
loops run on CUDA tensors (the main path runs none).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import rng
from ..core.math import frame_from_normal, normalize, safe_sqrt

ISOTROPIC = 0
HG = 1
RAYLEIGH = 2
KKAY = 3
MICROFLAKE = 4      # Gaussian-fiber micro-flake (src/phase/microflake.cpp)
MIXTURE_PHASE = 5   # weighted mixture (src/phase/mixturephase.cpp)
KKAY_IS = 6         # kkay with cone importance sampling

INV_FOURPI = 1.0 / (4.0 * math.pi)

_KKAY_LAT_BINS = 64  # latitude CDF resolution for KKAY_IS
_MF_TRIES = 64       # micro-flake rejection-sampling candidates per lane
_MF_SIGT_RES = 64    # sigma_t(cos theta) lookup resolution

LAUNCHES = {"woodcock_sample": 0, "woodcock_transmittance": 0}
PLAIN_ON_CUDA = dict.fromkeys(LAUNCHES, 0)


def reset_counts():
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


def _dev(device):
    from .. import resolve_device
    return resolve_device(device)


def _f32(a, dev):
    return torch.as_tensor(np.array(a, np.float32), device=dev)


class Medium(NamedTuple):
    sigma_t: torch.Tensor     # [3] extinction
    albedo: torch.Tensor      # [3] sigma_s / sigma_t
    g: torch.Tensor           # [] HG asymmetry
    fog_depth: torch.Tensor   # [] medium thickness along an escaping ray
    phase_kind: int
    phase_p: torch.Tensor = None      # kkay (ks, kd, exponent, norm) or
    #                                   microflake (stddev, norm, c1, 0,
    #                                   sigma_t table)
    orientation: torch.Tensor = None  # [3] fiber tangent (0: unoriented)
    mix: tuple = ()                   # (kind, weight, g) per child


def kkay_normalization(exponent: float) -> float:
    """Simpson quadrature of the specular lobe for perpendicular
    illumination (src/phase/kkay.cpp:58-76, n = 1000 panels)."""
    n_parts = 1000
    step = np.pi / n_parts
    theta = step * np.arange(1, n_parts)
    m = np.where(np.arange(1, n_parts) % 2 == 1, 4.0, 2.0)
    val = np.cos(theta - np.pi / 2) ** exponent * np.sin(theta)
    integral = float((val * m).sum() * step / 3.0)
    return 1.0 / (integral * 2.0 * np.pi)


def _fiber_sigma_t_table(stddev: float, res: int = _MF_SIGT_RES):
    """sigma_t(cos theta) of the Gaussian fiber distribution over |cos
    theta| in [0, 1], by quadrature at build time."""
    from math import erf
    norm = 1.0 / ((2.0 * np.pi) ** 1.5 * stddev
                  * erf(1.0 / (np.sqrt(2.0) * stddev)))
    zq, wq = np.polynomial.legendre.leggauss(128)
    phi = (np.arange(256) + 0.5) / 256 * 2.0 * np.pi
    ct = (np.arange(res) + 0.5) / res
    st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))
    sm = np.sqrt(np.maximum(1.0 - zq * zq, 0.0))
    dots = np.abs(st[:, None, None] * sm[None, :, None]
                  * np.cos(phi)[None, None, :]
                  + ct[:, None, None] * zq[None, :, None])
    d = norm * np.exp(-zq * zq / (2.0 * stddev * stddev))
    tab = (dots.mean(axis=-1) * d[None, :] * wq[None, :]).sum(-1) * 2 * np.pi
    return tab.astype(np.float32)


def make_medium(sigma_s, sigma_a, g=0.0, phase_kind=HG, fog_depth=1e4,
                ks=0.4, kd=0.2, exponent=4.0, orientation=(0.0, 0.0, 0.0),
                stddev=0.3, mix=(), device=None) -> Medium:
    """Global homogeneous fog of finite optical extent: any ray towards
    the environment traverses `fog_depth` of medium."""
    dev = _dev(device)
    sigma_s = np.asarray(sigma_s, np.float32)
    sigma_a = np.asarray(sigma_a, np.float32)
    sigma_t = sigma_s + sigma_a
    albedo = sigma_s / np.maximum(sigma_t, 1e-8)
    if phase_kind == MICROFLAKE:
        from math import erf
        c1 = 1.0 / erf(1.0 / (np.sqrt(2.0) * stddev))
        norm = 1.0 / ((2.0 * np.pi) ** 1.5 * stddev
                      * erf(1.0 / (np.sqrt(2.0) * stddev)))
        phase_p = np.asarray(np.concatenate(
            [[stddev, norm, c1, 0.0], _fiber_sigma_t_table(stddev)]),
            np.float32)
    else:
        phase_p = np.asarray([ks, kd, exponent,
                              kkay_normalization(exponent)], np.float32)
    return Medium(sigma_t=_f32(sigma_t, dev), albedo=_f32(albedo, dev),
                  g=_f32(g, dev), fog_depth=_f32(fog_depth, dev),
                  phase_kind=phase_kind, phase_p=_f32(phase_p, dev),
                  orientation=_f32(orientation, dev), mix=tuple(mix))


# ---------------------------------------------------------------------------
# phase functions (wi points towards the viewer, wo is the new direction)
# ---------------------------------------------------------------------------

def _fiber_frame(orientation, like):
    """(has_ori [...], the fiber frame) of an orientation broadcast to
    like's shape (unoriented lanes get +z)."""
    ori = torch.broadcast_to(torch.as_tensor(orientation, dtype=torch.float32,
                                             device=like.device), like.shape)
    has_ori = torch.sum(ori * ori, dim=-1) > 1e-12
    z = torch.tensor([0.0, 0.0, 1.0], device=like.device)
    n = normalize(torch.where(has_ori[..., None], ori, z))
    return has_ori, frame_from_normal(n)


def _kkay_eval(phase_p, orientation, wi, wo):
    """Kajiya-Kay fiber phase (src/phase/kkay.cpp:104-120)."""
    ks, kd, exponent, norm = phase_p[0], phase_p[1], phase_p[2], phase_p[3]
    has_ori, fr = _fiber_frame(orientation, wo)
    n = fr.n
    loc = fr.to_local(wo)
    z = -torch.sum(wi * n, dim=-1)
    xy2 = torch.clamp(loc[..., 0] ** 2 + loc[..., 1] ** 2, min=1e-20)
    a = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0) / xy2)
    r_loc = torch.stack([loc[..., 0] * a, loc[..., 1] * a, z], dim=-1)
    r_world = fr.to_world(r_loc)
    spec = torch.clamp(torch.sum(r_world * wo, dim=-1), min=0.0) ** exponent
    val = spec * norm * ks + kd * INV_FOURPI
    return torch.where(has_ori, val, kd * INV_FOURPI)


def _microflake_eval(phase_p, orientation, wi, wo):
    """Gaussian-fiber micro-flake phase (microflake.cpp:118-125); 0 on
    unoriented lanes."""
    stddev, norm = phase_p[0], phase_p[1]
    sig_tab = phase_p[4:4 + _MF_SIGT_RES]
    has_ori, fr = _fiber_frame(orientation, wo)
    wi_l = fr.to_local(wi)
    wo_l = fr.to_local(wo)
    h = wi_l + wo_l
    hh = torch.sum(h * h, dim=-1)
    hl = torch.sqrt(torch.clamp(hh, min=1e-20))
    hz = h[..., 2] / hl
    d = norm * torch.exp(-hz * hz / (2.0 * stddev * stddev))
    x = torch.abs(wi_l[..., 2]) * _MF_SIGT_RES - 0.5
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, _MF_SIGT_RES - 2)
    fx = torch.clamp(x - x0.to(x.dtype), 0.0, 1.0)
    sig = sig_tab[x0] * (1.0 - fx) + sig_tab[x0 + 1] * fx
    val = 0.5 * d / torch.clamp(sig, min=1e-8)
    return torch.where(has_ori & (hh > 1e-18), val, 0.0)


def _bits(x):
    return x.contiguous().view(torch.int32).to(torch.int64) & rng.M32


def _hash_u01(u2, salt: int):
    """Fresh uniforms from a 2D sample by integer hashing its bit patterns
    with a salt (the JAX package's _hash_u01)."""
    a = _bits(u2[..., 0])
    b = _bits(u2[..., 1])
    x = a ^ rng._mul32(b, 0x9E3779B9) ^ ((salt * 0x85EBCA6B) & rng.M32)
    x = rng._mul32(x ^ (x >> 16), 0x7FEB352D)
    x = rng._mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x.to(torch.float32) * (1.0 / 4294967296.0)


def _microflake_sample(phase_p, orientation, wi, u2):
    """Rejection sampling of flake normals over _MF_TRIES candidates
    (microflake.cpp:127-170); lanes with no acceptance get pdf 0."""
    stddev, c1 = phase_p[0], phase_p[2]
    has_ori, fr = _fiber_frame(orientation, wi)
    wi_l = fr.to_local(wi)
    accepted = torch.zeros(wi.shape[:-1], dtype=torch.bool, device=wi.device)
    h_sel = torch.zeros_like(wi_l)
    for t in range(_MF_TRIES):
        xi1 = _hash_u01(u2, 3 * t + 1)
        xi2 = _hash_u01(u2, 3 * t + 2)
        xia = _hash_u01(u2, 3 * t + 3)
        ct = torch.clamp(math.sqrt(2.0) * stddev * torch.special.erfinv(
            torch.clamp((1.0 - 2.0 * xi1) / c1, -0.999999, 0.999999)),
            -1.0, 1.0)
        st = safe_sqrt(1.0 - ct * ct)
        ph = 2.0 * math.pi * xi2
        h = torch.stack([st * torch.cos(ph), st * torch.sin(ph), ct], dim=-1)
        acc = (xia < torch.abs(torch.sum(wi_l * h, dim=-1))) & ~accepted
        h_sel = torch.where(acc[..., None], h, h_sel)
        accepted = accepted | acc
    wo_l = h_sel * (2.0 * torch.sum(wi_l * h_sel, -1, keepdim=True)) - wi_l
    wo = fr.to_world(wo_l)
    ok = accepted & has_ori
    wo = torch.where(ok[..., None], wo, -wi)
    pdf = torch.where(ok, _microflake_eval(phase_p, orientation, wi, wo), 0.0)
    return wo, pdf


def _kkay_lat_weights(phase_p, lat_m):
    exponent = phase_p[2]
    centers = (torch.arange(_KKAY_LAT_BINS, device=lat_m.device,
                            dtype=torch.float32) + 0.5) / _KKAY_LAT_BINS \
        * math.pi - math.pi / 2.0
    dlt = centers - lat_m[..., None]
    return torch.clamp(torch.cos(dlt), min=0.0) ** exponent \
        * torch.cos(centers)


def _kkay_is_pdf(phase_p, orientation, wi, wo):
    """pdf of the KKAY_IS sampler."""
    ks, kd = phase_p[0], phase_p[1]
    has_ori, fr = _fiber_frame(orientation, wo)
    z_m = -torch.sum(wi * fr.n, dim=-1)
    lat_m = torch.arcsin(torch.clamp(z_m, -1.0, 1.0))
    w = _kkay_lat_weights(phase_p, lat_m)
    total = torch.clamp(torch.sum(w, dim=-1), min=1e-20)
    z_o = torch.clamp(fr.to_local(wo)[..., 2], -1.0, 1.0)
    lat_o = torch.arcsin(z_o)
    j = torch.clamp(((lat_o / math.pi + 0.5) * _KKAY_LAT_BINS)
                    .to(torch.int64), 0, _KKAY_LAT_BINS - 1)
    wj = torch.gather(w, -1, j[..., None])[..., 0]
    dlat = math.pi / _KKAY_LAT_BINS
    cos_lat = torch.clamp(torch.cos(lat_o), min=1e-6)
    pdf_spec = wj / (total * dlat * 2.0 * math.pi * cos_lat)
    p_spec = torch.where(has_ori, ks / torch.clamp(ks + kd, min=1e-9), 0.0)
    return p_spec * pdf_spec + (1.0 - p_spec) * INV_FOURPI


def _kkay_is_sample(phase_p, orientation, wi, u2):
    ks, kd = phase_p[0], phase_p[1]
    has_ori, fr = _fiber_frame(orientation, wi)
    z_m = -torch.sum(wi * fr.n, dim=-1)
    lat_m = torch.arcsin(torch.clamp(z_m, -1.0, 1.0))
    p_spec = torch.where(has_ori, ks / torch.clamp(ks + kd, min=1e-9), 0.0)
    pick_spec = u2[..., 0] < p_spec
    u0 = torch.where(pick_spec,
                     u2[..., 0] / torch.clamp(p_spec, min=1e-9),
                     (u2[..., 0] - p_spec) / torch.clamp(1.0 - p_spec,
                                                         min=1e-9))
    u0 = torch.clamp(u0, 0.0, 1.0 - 1e-6)
    w = _kkay_lat_weights(phase_p, lat_m)
    cdf = torch.cumsum(w, dim=-1)
    total = torch.clamp(cdf[..., -1:], min=1e-20)
    cdf = cdf / total
    j = torch.clamp(torch.sum((cdf < u0[..., None]).to(torch.int64), -1),
                    0, _KKAY_LAT_BINS - 1)
    hi = torch.gather(cdf, -1, j[..., None])[..., 0]
    lo = torch.where(j > 0, torch.gather(
        cdf, -1, torch.clamp(j - 1, min=0)[..., None])[..., 0], 0.0)
    frac = torch.clamp((u0 - lo) / torch.clamp(hi - lo, min=1e-20), 0.0, 1.0)
    lat = (j.to(torch.float32) + frac) / _KKAY_LAT_BINS * math.pi \
        - math.pi / 2.0
    phi = 2.0 * math.pi * u2[..., 1]
    cl = torch.cos(lat)
    wo_spec = fr.to_world(torch.stack([cl * torch.cos(phi),
                                       cl * torch.sin(phi),
                                       torch.sin(lat)], dim=-1))
    z = 1.0 - 2.0 * u0
    r = safe_sqrt(1.0 - z * z)
    wo_diff = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z],
                          dim=-1)
    wo = torch.where(pick_spec[..., None], wo_spec, wo_diff)
    return wo, _kkay_is_pdf(phase_p, orientation, wi, wo)


def _mix_norm(mix):
    tot = sum(w for _, w, _ in mix)
    return [(k, w / max(tot, 1e-9), gc) for k, w, gc in mix], tot


def _default_kkay(phase_p, orientation, like):
    if phase_p is None:
        phase_p = torch.tensor([0.4, 0.2, 4.0, kkay_normalization(4.0)],
                               device=like.device)
    if orientation is None:
        orientation = torch.zeros(3, device=like.device)
    return phase_p, orientation


def _cbrt(x):
    """Real cube root (torch has no cbrt)."""
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def phase_eval(kind: int, g, wi, wo, phase_p=None, orientation=None,
               mix=()):
    ct = torch.sum(wi * (-wo), dim=-1)   # forward scattering: wo ~ -wi
    if kind == ISOTROPIC:
        return torch.full(ct.shape, INV_FOURPI, device=ct.device)
    if kind == HG:
        denom = 1.0 + g * g - 2.0 * g * ct
        return INV_FOURPI * (1.0 - g * g) / torch.clamp(
            denom * torch.sqrt(torch.clamp(denom, min=1e-8)), min=1e-8)
    if kind in (KKAY, KKAY_IS):
        phase_p, orientation = _default_kkay(phase_p, orientation, wi)
        return _kkay_eval(phase_p, orientation, wi, wo)
    if kind == MICROFLAKE:
        if orientation is None:
            orientation = torch.zeros(3, device=wi.device)
        return _microflake_eval(phase_p, orientation, wi, wo)
    if kind == MIXTURE_PHASE:
        out = 0.0
        for k, w, gc in mix:
            out = out + w * phase_eval(k, gc, wi, wo, phase_p, orientation)
        return out
    return (3.0 / (16.0 * math.pi)) * (1.0 + ct * ct)


def phase_pdf(kind: int, g, wi, wo, phase_p=None, orientation=None,
              mix=()):
    """pdf of phase_sample at wo (eval for the self-importance-sampled
    kinds; the uniform sphere's for kkay; its own for KKAY_IS and
    mixtures)."""
    if kind == KKAY:
        return torch.full(wi.shape[:-1], INV_FOURPI, device=wi.device)
    if kind == KKAY_IS:
        phase_p, orientation = _default_kkay(phase_p, orientation, wi)
        return _kkay_is_pdf(phase_p, orientation, wi, wo)
    if kind == MIXTURE_PHASE:
        nmix, _ = _mix_norm(mix)
        out = 0.0
        for k, w, gc in nmix:
            out = out + w * phase_pdf(k, gc, wi, wo, phase_p, orientation)
        return out
    return phase_eval(kind, g, wi, wo, phase_p, orientation)


def phase_sample(kind: int, g, wi, u2, phase_p=None, orientation=None,
                 mix=()):
    """Sample wo; returns (wo, pdf) (the JAX package's samplers: HG,
    isotropic and Rayleigh by inverse CDF, kkay on the uniform sphere,
    KKAY_IS by the cone's latitude CDF, micro-flakes by rejection,
    mixtures by a child picked by weight)."""
    dev = wi.device
    if kind == ISOTROPIC or kind == KKAY:
        z = 1.0 - 2.0 * u2[..., 0]
        r = safe_sqrt(1.0 - z * z)
        phi = 2.0 * math.pi * u2[..., 1]
        wo = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
        return wo, torch.full(u2.shape[:-1], INV_FOURPI, device=dev)
    if kind == RAYLEIGH:
        z = 2.0 * (2.0 * u2[..., 0] - 1.0)
        tmp = torch.sqrt(z * z + 1.0)
        cos_theta = torch.clamp(_cbrt(z + tmp) + _cbrt(z - tmp), -1.0, 1.0)
        sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
        phi = 2.0 * math.pi * u2[..., 1]
        fr = frame_from_normal(normalize(-wi))
        wo = fr.to_world(torch.stack([sin_theta * torch.cos(phi),
                                      sin_theta * torch.sin(phi),
                                      cos_theta], dim=-1))
        return wo, phase_eval(RAYLEIGH, g, wi, wo)
    if kind == KKAY_IS:
        phase_p, orientation = _default_kkay(phase_p, orientation, wi)
        return _kkay_is_sample(phase_p, orientation, wi, u2)
    if kind == MICROFLAKE:
        if orientation is None:
            orientation = torch.zeros(3, device=dev)
        return _microflake_sample(phase_p, orientation, wi, u2)
    if kind == MIXTURE_PHASE:
        nmix, _ = _mix_norm(mix)
        wo = torch.zeros(wi.shape[:-1] + (3,), device=dev)
        lo = 0.0
        u0 = u2[..., 0]
        for k, w, gc in nmix:
            hi = lo + w
            sel = (u0 >= lo) & (u0 < hi)
            u_r = torch.clamp((u0 - lo) / max(w, 1e-9), 0.0, 1.0 - 1e-7)
            wo_k, _ = phase_sample(k, gc, wi, torch.stack([u_r, u2[..., 1]],
                                                          dim=-1),
                                   phase_p, orientation)
            wo = torch.where(sel[..., None], wo_k, wo)
            lo = hi
        return wo, phase_pdf(MIXTURE_PHASE, g, wi, wo, phase_p, orientation,
                             mix)
    # HG inverse CDF (hg.cpp sample)
    g_t = torch.as_tensor(g, dtype=torch.float32, device=dev)
    small = torch.abs(g_t) < 1e-3
    g_safe = torch.where(small, 1e-3, g_t)
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u2[..., 0])
    cos_theta = torch.where(small, 1.0 - 2.0 * u2[..., 0],
                            (1.0 + g * g - sqr * sqr) / (2.0 * g_safe))
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * math.pi * u2[..., 1]
    fr = frame_from_normal(normalize(-wi))
    wo = fr.to_world(torch.stack([sin_theta * torch.cos(phi),
                                  sin_theta * torch.sin(phi),
                                  cos_theta], dim=-1))
    return wo, phase_eval(HG, g, wi, wo)


# ---------------------------------------------------------------------------
# homogeneous media
# ---------------------------------------------------------------------------

def transmittance(medium: Medium, dist):
    """exp(-sigma_t d) with an infinite distance giving 0."""
    d = torch.clamp(dist, max=1e30)[..., None]
    return torch.exp(-medium.sigma_t * d)


def sample_distance(medium: Medium, u_channel, u_dist, t_max):
    """Spectral-MIS free flight (a channel picked uniformly). Returns (d,
    is_medium_event, weight [N, 3]); the weight holds transmittance / pdf
    and sigma_s at medium events (homogeneous.cpp sampleDistance)."""
    c = torch.clamp((u_channel * 3).to(torch.int64), 0, 2)
    sig_c = medium.sigma_t[c]
    d = -torch.log(torch.clamp(1.0 - u_dist, min=1e-20)) \
        / torch.clamp(sig_c, min=1e-8)
    is_medium = d < t_max
    d = torch.minimum(d, t_max)
    tr = transmittance(medium, d)
    pdf_med = torch.mean(medium.sigma_t[None, :] * tr, dim=-1)
    pdf_surf = torch.mean(tr, dim=-1)
    sigma_s = medium.sigma_t * medium.albedo
    w_med = tr * sigma_s[None, :] / torch.clamp(pdf_med, min=1e-20)[..., None]
    w_surf = tr / torch.clamp(pdf_surf, min=1e-20)[..., None]
    return d, is_medium, torch.where(is_medium[..., None], w_med, w_surf)


class MediumTable(NamedTuple):
    """Shape-bounded homogeneous media, indexed per lane; row 0 is
    vacuum."""
    sigma_t: torch.Tensor   # [M, 3]
    albedo: torch.Tensor    # [M, 3]
    g: torch.Tensor         # [M]


def make_medium_table(entries, device=None) -> MediumTable:
    """entries: dicts of sigma_s, sigma_a and g; a vacuum row is
    prepended, so the scene's medium ids are 1-based."""
    dev = _dev(device)
    rows_t, rows_a, rows_g = [np.zeros(3, np.float32)], \
        [np.zeros(3, np.float32)], [0.0]
    for e in entries:
        ss = np.asarray(e.get("sigma_s", (0.5,) * 3), np.float32)
        sa = np.asarray(e.get("sigma_a", (0.1,) * 3), np.float32)
        st = ss + sa
        rows_t.append(st)
        rows_a.append(ss / np.maximum(st, 1e-8))
        rows_g.append(float(e.get("g", 0.0)))
    return MediumTable(sigma_t=_f32(np.stack(rows_t), dev),
                       albedo=_f32(np.stack(rows_a), dev),
                       g=_f32(rows_g, dev))


def sample_distance_lane(sig_t, albedo, u_channel, u_dist, t_max):
    """Per-lane spectral-MIS free flight over [N, 3] rows gathered from a
    MediumTable; vacuum lanes reach the surface with weight 1."""
    c = torch.clamp((u_channel * 3).to(torch.int64), 0, 2)
    sig_c = torch.gather(sig_t, 1, c[:, None])[:, 0]
    d = -torch.log(torch.clamp(1.0 - u_dist, min=1e-20)) \
        / torch.clamp(sig_c, min=1e-8)
    d = torch.where(sig_c > 0, d, float("inf"))
    is_medium = d < t_max
    d = torch.minimum(d, t_max)
    tr = torch.exp(-sig_t * torch.clamp(d, max=1e30)[..., None])
    pdf_med = torch.mean(sig_t * tr, dim=-1)
    pdf_surf = torch.mean(tr, dim=-1)
    sigma_s = sig_t * albedo
    w_med = tr * sigma_s / torch.clamp(pdf_med, min=1e-20)[..., None]
    w_surf = tr / torch.clamp(pdf_surf, min=1e-20)[..., None]
    return d, is_medium, torch.where(is_medium[..., None], w_med, w_surf)


# ---------------------------------------------------------------------------
# grid volumes
# ---------------------------------------------------------------------------

class GridVolume(NamedTuple):
    data: torch.Tensor        # [D, H, W] density (z, y, x)
    world_min: torch.Tensor   # [3]
    inv_extent: torch.Tensor  # [3] 1 / (world_max - world_min)


class HGridVolume(NamedTuple):
    block_idx: torch.Tensor   # [BZ, BY, BX] int32 block table (-1 empty)
    blocks: torch.Tensor      # [NB, b, b, b] per-block density
    world_min: torch.Tensor   # [3]
    inv_extent: torch.Tensor  # [3]


class HeteroMedium(NamedTuple):
    vol: object               # GridVolume or HGridVolume
    sigma_t: torch.Tensor     # [3] extinction at density 1
    albedo: torch.Tensor      # [3]
    g: torch.Tensor           # []
    majorant: torch.Tensor    # [] max density * max(sigma_t)
    phase_kind: int
    inv_majorant: float       # 1 / majorant (float32) on the host
    sigma_t_max: float        # max(sigma_t) (float32) on the host
    max_steps: int = 512      # Woodcock iteration cap


def host_scalars(majorant, sigma_t) -> dict:
    """HeteroMedium's inv_majorant and sigma_t_max from the majorant and
    sigma_t (array-likes on the host): the float32 values the plain loops
    compute on the device, so that kernel J reads nothing back."""
    mj = np.float32(np.asarray(majorant, np.float32))
    return dict(inv_majorant=float(np.float32(1.0) / mj),
                sigma_t_max=float(np.max(np.asarray(sigma_t, np.float32))))


def load_vol(path: str, device=None) -> GridVolume:
    """The grid of a .vol file: 'VOL', version 3, int32 encoding (1 =
    float32), xres, yres, zres, channels, the bbox, then x-fastest data
    (src/volume/gridvolume.cpp); the first channel is the density."""
    with open(path, "rb") as f:
        magic = f.read(3)
        if magic != b"VOL":
            raise ValueError("not a .vol file")
        version = f.read(1)[0]
        if version != 3:
            raise ValueError(f"unsupported .vol version {version}")
        enc, xres, yres, zres, channels = np.frombuffer(f.read(20),
                                                        np.int32)
        if enc != 1:
            raise ValueError(f"unsupported .vol encoding {enc}")
        bbox = np.frombuffer(f.read(24), np.float32)
        data = np.frombuffer(f.read(4 * xres * yres * zres * channels),
                             np.float32)
    data = data.reshape(zres, yres, xres, channels)[..., 0]
    dev = _dev(device)
    return GridVolume(data=_f32(data, dev), world_min=_f32(bbox[:3], dev),
                      inv_extent=_f32(1.0 / np.maximum(bbox[3:] - bbox[:3],
                                                       1e-12), dev))


def write_vol(path: str, data, world_min, world_max):
    """Write a single-channel float32 .vol (version 3) of data [D, H, W]."""
    d = np.ascontiguousarray(np.asarray(data, np.float32))
    zres, yres, xres = d.shape
    with open(path, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        f.write(np.asarray([1, xres, yres, zres, 1], np.int32).tobytes())
        f.write(np.asarray(list(world_min) + list(world_max),
                           np.float32).tobytes())
        f.write(d.tobytes())


def make_grid_volume(data, world_min, world_max, device=None) -> GridVolume:
    dev = _dev(device)
    wmin = np.asarray(world_min, np.float32)
    wmax = np.asarray(world_max, np.float32)
    return GridVolume(data=_f32(data, dev), world_min=_f32(wmin, dev),
                      inv_extent=_f32(1.0 / np.maximum(wmax - wmin, 1e-12),
                                      dev))


def _trilinear(at, fx, fy, fz, nx, ny, nz):
    """Trilinear blend of the corner lookups at(dz, dy, dx) of the cell at
    floor(f), clamped to the grid of nx x ny x nz nodes."""
    def lo(f, n):
        i = torch.clamp(torch.floor(f).to(torch.int64), 0, n - 2)
        return i, torch.clamp(f - i.to(f.dtype), 0.0, 1.0)
    x0, wx = lo(fx, nx)
    y0, wy = lo(fy, ny)
    z0, wz = lo(fz, nz)
    c00 = at(z0, y0, x0) * (1 - wx) + at(z0, y0, x0 + 1) * wx
    c01 = at(z0, y0 + 1, x0) * (1 - wx) + at(z0, y0 + 1, x0 + 1) * wx
    c10 = at(z0 + 1, y0, x0) * (1 - wx) + at(z0 + 1, y0, x0 + 1) * wx
    c11 = at(z0 + 1, y0 + 1, x0) * (1 - wx) \
        + at(z0 + 1, y0 + 1, x0 + 1) * wx
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz


def grid_density(vol: GridVolume, p):
    """Trilinear density lookup, zero outside the grid box
    (gridvolume.cpp lookupFloat)."""
    g = (p - vol.world_min) * vol.inv_extent
    inside = torch.all((g >= 0.0) & (g <= 1.0), dim=-1)
    D, H, W = vol.data.shape
    flat = vol.data.reshape(-1)

    def at(z, y, x):
        return flat[(z * H + y) * W + x]
    val = _trilinear(at, g[..., 0] * (W - 1), g[..., 1] * (H - 1),
                     g[..., 2] * (D - 1), W, H, D)
    return torch.where(inside, val, 0.0)


def make_hetero_medium(vol, sigma_s, sigma_a, g=0.0, phase_kind=HG,
                       density_scale=1.0) -> HeteroMedium:
    """The medium's tables on the volume's device."""
    dev = vol.world_min.device
    sigma_s = np.asarray(sigma_s, np.float32) * density_scale
    sigma_a = np.asarray(sigma_a, np.float32) * density_scale
    sigma_t = sigma_s + sigma_a
    albedo = sigma_s / np.maximum(sigma_t, 1e-8)
    dens_max = float((vol.blocks if isinstance(vol, HGridVolume)
                      else vol.data).max())
    majorant = max(dens_max * float(np.max(sigma_t)), 1e-8)
    return HeteroMedium(vol=vol, sigma_t=_f32(sigma_t, dev),
                        albedo=_f32(albedo, dev), g=_f32(g, dev),
                        majorant=_f32(majorant, dev), phase_kind=phase_kind,
                        **host_scalars(majorant, sigma_t))


def make_hgrid_from_dense(data, world_min, world_max, block: int = 8,
                          eps: float = 0.0, device=None) -> HGridVolume:
    """Split a dense [D, H, W] grid into block^3 tiles, dropping tiles
    whose max density <= eps."""
    dev = _dev(device)
    d = np.asarray(data, np.float32)
    D, H, W = d.shape
    pz, py, px = [(-s) % block for s in (D, H, W)]
    d = np.pad(d, ((0, pz), (0, py), (0, px)))
    BZ, BY, BX = d.shape[0] // block, d.shape[1] // block, d.shape[2] // block
    tiles = d.reshape(BZ, block, BY, block, BX, block) \
        .transpose(0, 2, 4, 1, 3, 5).reshape(-1, block, block, block)
    keep = tiles.max(axis=(1, 2, 3)) > eps
    idx = np.full(len(tiles), -1, np.int32)
    idx[keep] = np.arange(int(keep.sum()), dtype=np.int32)
    blocks = tiles[keep] if keep.any() else np.zeros(
        (1, block, block, block), np.float32)
    wmin = np.asarray(world_min, np.float32)
    wmax = np.asarray(world_max, np.float32)
    # node-centred: the extent grows with the padding
    scale = (np.asarray(d.shape[::-1], np.float32) - 1) \
        / np.maximum(np.asarray((W, H, D), np.float32) - 1, 1)
    ext = (wmax - wmin) * scale
    return HGridVolume(
        block_idx=torch.as_tensor(idx.reshape(BZ, BY, BX), device=dev),
        blocks=_f32(blocks, dev), world_min=_f32(wmin, dev),
        inv_extent=_f32(1.0 / np.maximum(ext, 1e-12), dev))


def hgrid_density(vol: HGridVolume, p):
    """Block-sparse trilinear lookup: the coarse cell, then trilinear
    inside its block (clamped at the block's border); empty cells give 0
    (hgridvolume.cpp:144-158)."""
    BZ, BY, BX = vol.block_idx.shape
    nb = vol.blocks.shape[1]
    g = (p - vol.world_min) * vol.inv_extent
    inside = torch.all((g >= 0.0) & (g <= 1.0), dim=-1)
    fx = torch.clamp(g[..., 0] * (BX * nb - 1), 0.0, BX * nb - 1.0)
    fy = torch.clamp(g[..., 1] * (BY * nb - 1), 0.0, BY * nb - 1.0)
    fz = torch.clamp(g[..., 2] * (BZ * nb - 1), 0.0, BZ * nb - 1.0)
    cz = torch.clamp((fz / nb).to(torch.int64), 0, BZ - 1)
    cy = torch.clamp((fy / nb).to(torch.int64), 0, BY - 1)
    cx = torch.clamp((fx / nb).to(torch.int64), 0, BX - 1)
    bi = vol.block_idx[cz, cy, cx].to(torch.int64)
    base = torch.clamp(bi, min=0) * (nb * nb * nb)
    flat = vol.blocks.reshape(-1)

    def at(z, y, x):
        return flat[base + (z * nb + y) * nb + x]
    val = _trilinear(at, fx - (cx * nb).to(fx.dtype),
                     fy - (cy * nb).to(fy.dtype),
                     fz - (cz * nb).to(fz.dtype), nb, nb, nb)
    return torch.where(inside & (bi >= 0), val, 0.0)


def bake_volume_cache(fn, world_min, world_max, res: int = 64,
                      block: int = 8, eps: float = 0.0,
                      device=None) -> HGridVolume:
    """volcache's counterpart: evaluate a density function on a dense
    grid once and serve lookups from the block-sparse result."""
    dev = _dev(device)
    wmin = np.asarray(world_min, np.float32)
    wmax = np.asarray(world_max, np.float32)
    zs = np.linspace(wmin[2], wmax[2], res)
    ys = np.linspace(wmin[1], wmax[1], res)
    xs = np.linspace(wmin[0], wmax[0], res)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    pts = torch.as_tensor(np.stack([X, Y, Z], -1).reshape(-1, 3),
                          dtype=torch.float32, device=dev)
    dens = torch.as_tensor(fn(pts)).detach().cpu().numpy() \
        .reshape(res, res, res)
    return make_hgrid_from_dense(dens, wmin, wmax, block=block, eps=eps,
                                 device=dev)


def volume_density(vol, p):
    """The density lookup of a dense or a block-sparse volume."""
    if isinstance(vol, HGridVolume):
        return hgrid_density(vol, p)
    return grid_density(vol, p)


# ---------------------------------------------------------------------------
# Woodcock tracking: the plain loops and kernel J
# ---------------------------------------------------------------------------

_SALT_SAMPLE = (0, 0x5bd1)
_SALT_TR = 0x1234


def _woodcock_uniform(pixel, sample, dim_base: int, it: int, salt: int):
    return rng.uniform_1d(pixel, sample, dim_base + 0x9E37 * it + salt)


def _world_max(vol):
    return vol.world_min + 1.0 / vol.inv_extent


def _bbox_overlap(vol, o, d, t_max):
    """[t0, t1] of the ray's overlap with the grid box (t1 < t0: none)."""
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-12,
                              torch.where(d >= 0, 1e-12, -1e-12), d)
    a0 = (vol.world_min - o) * inv_d
    a1 = (_world_max(vol) - o) * inv_d
    t0 = torch.amax(torch.minimum(a0, a1), dim=-1)
    t1 = torch.amin(torch.maximum(a0, a1), dim=-1)
    return torch.clamp(t0, min=0.0), torch.minimum(t1, t_max)


def _inv_majorant(med: HeteroMedium):
    return 1.0 / med.majorant


def _count_steps(counts, done, p):
    """Add the lanes stepping at this iteration to counts["steps"], and
    their lookup points to counts["points"] where that list is given."""
    if counts is not None:
        counts["steps"] = counts.get("steps", 0) + int((~done).sum())
        if "points" in counts:
            counts["points"].append(p[~done])


def woodcock_sample_plain(med: HeteroMedium, o, d, t_max, pixel, sample,
                          dim_base: int, counts=None):
    """Delta tracking clipped to the grid box (heterogeneous.cpp
    sampleDistance): (t [N], is_medium_event [N]); t_max where no medium
    event happened. The JAX package's loop: one iteration counter for the
    wave, a lane stepping once per iteration until it is done. counts (a
    dict) gets the steps taken, summed over the lanes, under "steps", and
    each step's lookup point in counts["points"] (a list) if it has
    one."""
    if o.is_cuda:
        PLAIN_ON_CUDA["woodcock_sample"] += 1
    inv_mj = _inv_majorant(med)
    smax = torch.amax(med.sigma_t)
    t0, t1 = _bbox_overlap(med.vol, o, d, t_max)
    t = torch.clamp(t0, min=0.0)
    done = t0 >= t1
    it = 0
    while it < med.max_steps and not bool(done.all()):
        u1 = _woodcock_uniform(pixel, sample, dim_base, it, _SALT_SAMPLE[0])
        u2 = _woodcock_uniform(pixel, sample, dim_base, it, _SALT_SAMPLE[1])
        t_new = t - torch.log(torch.clamp(1.0 - u1, min=1e-20)) * inv_mj
        escaped = t_new >= t1
        p = o + d * t_new[..., None]
        _count_steps(counts, done, p)
        dens = volume_density(med.vol, p)
        real = u2 < dens * smax * inv_mj
        t = torch.where(done, t, t_new)
        done = done | escaped | real
        it += 1
    is_med = (t < t1) & (t0 < t1)
    return torch.where(is_med, t, t_max), is_med


def woodcock_transmittance_plain(med: HeteroMedium, o, d, dist, pixel,
                                 sample, dim_base: int, counts=None):
    """Ratio-tracking transmittance [N, 3] along [0, dist], clipped to the
    grid box (heterogeneous.cpp evalTransmittance); the JAX package's
    loop. counts as in woodcock_sample_plain."""
    if o.is_cuda:
        PLAIN_ON_CUDA["woodcock_transmittance"] += 1
    inv_mj = _inv_majorant(med)
    smax = torch.amax(med.sigma_t)
    t0, t1 = _bbox_overlap(med.vol, o, d, dist)
    t = torch.clamp(t0, min=0.0)
    tr = torch.ones((o.shape[0], 3), device=o.device)
    done = t0 >= t1
    it = 0
    while it < med.max_steps and not bool(done.all()):
        u1 = _woodcock_uniform(pixel, sample, dim_base, it, _SALT_TR)
        t_new = t - torch.log(torch.clamp(1.0 - u1, min=1e-20)) * inv_mj
        escaped = t_new >= t1
        p = o + d * t_new[..., None]
        _count_steps(counts, done, p)
        dens = volume_density(med.vol, p)
        ratio = 1.0 - dens * smax * inv_mj
        tr = torch.where((done | escaped)[..., None], tr,
                         tr * torch.clamp(ratio, min=0.0)[..., None])
        done = done | escaped | (torch.amax(tr, dim=-1) <= 0.0)
        t = torch.where(done, t, t_new)
        it += 1
    return tr


_LIB = None


def lib():
    """Build (first use) and load libhairpt_woodcock.so (kernel J)."""
    global _LIB
    if _LIB is None:
        from ..ops._native import load_library
        from ..ops.tiled_kernels import nvcc_cmd
        L = load_library("hairpt_woodcock", ["woodcock.cu"], nvcc_cmd())
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        L.hairpt_woodcock.argtypes = [ci, ci, vp, vp, ci, ci, ci, ci, ci,
                                      ci, vp, vp, vp, vp, vp, vp, ci, cf,
                                      cf, vp, vp, vp, vp]
        L.hairpt_woodcock.restype = ci
        _LIB = L
    return _LIB


def _vol_args(vol, dev):
    """(sparse, data, block_idx or None, dims (x, y, z), nb, box [9]:
    world_min, inv_extent, world max) of a volume, checked for the
    kernel."""
    from ..ops.tiled_kernels import _check
    for f in ("world_min", "inv_extent"):
        _check(getattr(vol, f), f, torch.float32, (3,), dev)
    box = torch.cat([vol.world_min, vol.inv_extent, _world_max(vol)])
    if isinstance(vol, HGridVolume):
        BZ, BY, BX = vol.block_idx.shape
        nb = vol.blocks.shape[1]
        _check(vol.block_idx, "block_idx", torch.int32, (BZ, BY, BX), dev)
        _check(vol.blocks, "blocks", torch.float32,
               (vol.blocks.shape[0], nb, nb, nb), dev)
        return 1, vol.blocks, vol.block_idx, (BX, BY, BZ), nb, box
    D, H, W = vol.data.shape
    _check(vol.data, "data", torch.float32, (D, H, W), dev)
    return 0, vol.data, None, (W, H, D), 0, box


def _woodcock_kernel(med: HeteroMedium, o, d, t_max, pixel, sample,
                     dim_base: int, ratio: bool):
    from ..ops.tiled_kernels import _check, _raise_rc, _stream
    dev = o.device
    N = o.shape[0]
    o = o.float().contiguous()
    d = d.float().contiguous()
    t_max = t_max.float().contiguous()
    _check(o, "o", torch.float32, (N, 3), dev)
    _check(d, "d", torch.float32, (N, 3), dev)
    _check(t_max, "t_max", torch.float32, (N,), dev)
    pix = torch.broadcast_to(torch.as_tensor(pixel, device=dev),
                             (N,)).to(torch.int64).contiguous()
    smp = torch.broadcast_to(torch.as_tensor(sample, device=dev),
                             (N,)).to(torch.int64).contiguous()
    sparse, data, bidx, dims, nb, box = _vol_args(med.vol, dev)
    if ratio:
        out = torch.empty((N, 3), dtype=torch.float32, device=dev)
        t_out = is_med = None
    else:
        out = None
        t_out = torch.empty((N,), dtype=torch.float32, device=dev)
        is_med = torch.empty((N,), dtype=torch.uint8, device=dev)
    name = "woodcock_transmittance" if ratio else "woodcock_sample"
    if N > 0:
        rc = lib().hairpt_woodcock(
            int(ratio), sparse, data.data_ptr(),
            None if bidx is None else bidx.data_ptr(), dims[0], dims[1],
            dims[2], nb, med.max_steps, dim_base, box.data_ptr(),
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(),
            pix.data_ptr(), smp.data_ptr(), N, med.inv_majorant,
            med.sigma_t_max,
            None if t_out is None else t_out.data_ptr(),
            None if is_med is None else is_med.data_ptr(),
            None if out is None else out.data_ptr(), _stream(dev))
        _raise_rc(rc, name)
        LAUNCHES[name] += 1
    if ratio:
        return out
    return t_out, is_med.bool()


def woodcock_sample(med: HeteroMedium, o, d, t_max, pixel, sample,
                    dim_base: int):
    """(t [N], is_medium_event [N]) by delta tracking: kernel J on CUDA
    tensors, woodcock_sample_plain on CPU tensors."""
    if not o.is_cuda:
        return woodcock_sample_plain(med, o, d, t_max, pixel, sample,
                                     dim_base)
    return _woodcock_kernel(med, o, d, t_max, pixel, sample, dim_base, False)


def woodcock_transmittance(med: HeteroMedium, o, d, dist, pixel, sample,
                           dim_base: int):
    """[N, 3] ratio-tracking transmittance: kernel J on CUDA tensors,
    woodcock_transmittance_plain on CPU tensors."""
    if not o.is_cuda:
        return woodcock_transmittance_plain(med, o, d, dist, pixel, sample,
                                            dim_base)
    return _woodcock_kernel(med, o, d, dist, pixel, sample, dim_base, True)
