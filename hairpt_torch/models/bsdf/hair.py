"""Hair BSDFs (port of hairpt/models/bsdf/hair.py): Kajiya-Kay, Marschner
(R/TT/TRT + diffuse hybrid, faithful and corrected modes), and the
Kajiya-Kay x thin-dielectric hybrid.

These are the reference fork's own contributions:
- KajiyaKay       - src/bsdfs/kajiyakay.cpp:58-333
- Marschner       - src/bsdfs/marschner_diffuse.cpp (the plugin registered
                    under the name "marschner"), Tungsten-style
                    precomputed azimuthal tables
- MarschnerDielectric - src/bsdfs/marschnerdielectric.cpp:145-620

Local frame convention (HairShape::fillIntersectionRecord): local x =
fiber tangent, z = radial normal. Kajiya-Kay uses wi.x as the tangent
coordinate; the Marschner code treats wi.y as sin(theta) and
atan2(wo.x, wo.z) as the azimuth, a fork quirk kept as-is so renders
match.

The azimuthal precompute is a differentiable torch function of
(sigma_a, beta_r, eta), so inverse rendering optimizes absorption and
roughness through it.

Faithful-mode quirks kept (marschner_diffuse.cpp):
- eval scales the R lobe by 0.15                     (line 454)
- pdf() returns 1 when the diffuse component is on   (lines 517-520)
- sample() reuses one 2D sample for lobe selection, longitudinal and
  azimuthal sampling and the diffuse hemisphere       (line 648)
- the three Gaussian detector tables are all built with beta_R (precompute
  loop, line 774)
- the sampled specular lobe is flagged EDeltaReflection, so MIS treats
  BSDF-sampled emitter hits as delta (weight 1)

Per-lane lookups of the tables that carry a gradient (the value tables,
whose rows a million lanes share) go through `take_rows`, whose backward
is an index_add_ over the flattened row index rather than plain
indexing's sorted accumulate. The sampling tables (weights, lobe_weight)
carry no gradient.
"""
from __future__ import annotations

import math

import torch

from ...core import warps
from ...core.math import frame_from_normal, normalize, safe_sqrt
from ...core.quad import gauss_legendre
from . import registry as R
from .fresnel import fresnel_dielectric
# the Marschner kinds' diffuse term and spec-vs-diffuse probability are
# rough plastic's, at z-axis cosines (marschner_diffuse.cpp:467-479)
from .plastic import RoughPlastic

INV_PI = 1.0 / math.pi
INV_TWOPI = 1.0 / (2.0 * math.pi)
INV_FOURPI = 1.0 / (4.0 * math.pi)
TWO_PI = 2.0 * math.pi

AZ_RES = 64            # azimuthal table resolution (matches reference)
N_GAUSS = 140          # Gauss-Legendre points over fiber offset h
N_DETECTOR = 2048      # detector table samples

_GL_X, _GL_W = gauss_legendre(N_GAUSS)


def take_rows(table, idx):
    """table[idx] for a table of rows [R, F] and a row index idx [N]:
    one gather of each lane's row. Its backward is index_select's, an
    index_add_ of the lanes' gradients into the rows; plain indexing's
    backward sorts the lanes of a wave and sums each row's run on one
    thread, as the material gather's did (registry._Rows)."""
    return table.index_select(0, idx.reshape(-1)).view(
        idx.shape + table.shape[1:])


# ---------------------------------------------------------------------------
# longitudinal scattering M (von Mises-Fisher, stable small-v branch)
# (reference: marschner_diffuse.cpp:365-377 M, 289-299 logI0/I0)
# ---------------------------------------------------------------------------

def _log_i0(x):
    # series for small x, asymptotic for large (stable)
    x = torch.abs(x)
    small = torch.log(torch.special.i0(torch.clamp(x, max=12.0)))
    xm = torch.clamp(x, min=1e-6)
    large = x + 0.5 * (torch.log(1.0 / (TWO_PI * xm)) + 1.0 / (8.0 * xm))
    return torch.where(x > 12.0, large, small)


def longitudinal_m(v, sin_ti, sin_to, cos_ti, cos_to):
    # both branches are evaluated lane-wide under `where`, so each must stay
    # finite (value AND gradient) over the other's domain: computed in log
    # space with clamped exponents
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    log_stable = -b + _log_i0(a) - 1.0 / v + 0.6931 \
        + torch.log(1.0 / (2.0 * v))
    log_csch = -torch.log(torch.sinh(torch.clamp(1.0 / v, 1e-3, 40.0)))
    log_direct = -b + _log_i0(a) + log_csch - torch.log(2.0 * v)
    out = torch.where(v < 0.1, log_stable, log_direct)
    return torch.exp(torch.clamp(out, -80.0, 80.0))


def _sample_longitudinal(v, sin_ti, cos_ti, u1, u2):
    cos_t = 1.0 + v * torch.log(u1 + (1.0 - u1) * torch.exp(-2.0 / v))
    sin_t = torch.clamp(safe_sqrt(1.0 - cos_t * cos_t), max=1.0)
    cos_phi = torch.cos(TWO_PI * u2)
    return -cos_t * sin_ti + sin_t * cos_phi * cos_ti


def sample_longitudinal(v, sin_ti, cos_ti, u1, u2):
    """Numerically stable vMF inversion
    (reference: marschner_diffuse.cpp:581-591 sampleM).

    For the narrow lobes exp(-2 / v) underflows, so u1 = 0 (a Sobol'
    point at the origin) gives cos_t = -inf and sin(theta_o) = +-inf,
    which the callers clamp to +-1. The value is the JAX package's; its
    gradient there is 0 * inf (here and in the asin and atan2 of the pole
    direction downstream), NaN in the JAX package. Lanes whose result is
    not inside (-1, 1) keep the value without a gradient: the derivative
    runs through the same arithmetic at a finite u1."""
    out = _sample_longitudinal(v, sin_ti, cos_ti, u1, u2)
    ok = torch.abs(out) < 1.0
    return torch.where(ok, _sample_longitudinal(
        v, sin_ti, cos_ti, torch.where(ok, u1, 0.5), u2), out.detach())


# ---------------------------------------------------------------------------
# azimuthal precompute (differentiable)
# ---------------------------------------------------------------------------

def _gaussian_g(beta, theta):
    return torch.exp(-theta * theta / (2.0 * beta * beta)) \
        / (math.sqrt(TWO_PI) * beta)


def _detector_table(beta):
    """D(beta, phi) on a uniform [0, 2 pi] grid with wrap-around
    (reference D(): a sum of 2 pi-shifted Gaussians; a fixed +-3)."""
    phi = torch.arange(N_DETECTOR, device=beta.device) \
        / (N_DETECTOR - 1.0) * TWO_PI
    acc = torch.zeros_like(phi)
    for k in range(-3, 4):
        acc = acc + _gaussian_g(beta, phi + k * TWO_PI)
    return acc  # [N_DETECTOR]


def _approx_d(table, phi):
    """Wrapped linear interpolation of the detector table
    (reference approxD lambda)."""
    u = torch.abs(phi * (INV_TWOPI * (N_DETECTOR - 1)))
    x0 = u.to(torch.int32)
    frac = u - x0.to(u.dtype)
    x0 = torch.remainder(x0, N_DETECTOR).long()
    x1 = torch.remainder(x0 + 1, N_DETECTOR)
    t = table[:, None]
    return take_rows(t, x0)[..., 0] * (1.0 - frac) \
        + take_rows(t, x1)[..., 0] * frac


def _phi_exit(gamma_i, gamma_t, p):
    """Exit azimuth Phi(p, h) (reference Phi(), line 316)."""
    return 2.0 * p * gamma_t - 2.0 * gamma_i + p * math.pi


def precompute_azimuthal(sigma_a, beta_r, eta, device=None):
    """The three azimuthal scattering tables N_R / N_TT / N_TRT:
    values [3, AZ_RES (cos theta_d), AZ_RES (phi), 3 (rgb)] on the device
    of sigma_a (or `device` when the arguments are not tensors).
    Differentiable with respect to sigma_a, beta_r and eta
    (reference: precomputeAzimuthalDistributions,
    marschner_diffuse.cpp:752-846)."""
    if device is None and torch.is_tensor(sigma_a):
        device = sigma_a.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    sigma_a, beta_r, eta = f32(sigma_a), f32(beta_r), f32(eta)
    dev = sigma_a.device

    gl_x = torch.as_tensor(_GL_X, dtype=torch.float32, device=dev)
    gl_w = torch.as_tensor(_GL_W, dtype=torch.float32, device=dev)
    gamma_i = torch.asin(torch.clamp(gl_x, -1.0, 1.0))          # [G]

    det = _detector_table(beta_r)                  # all lobes use beta_R

    y = torch.arange(AZ_RES, dtype=torch.float32, device=dev) \
        / (AZ_RES - 1.0)                                          # cos rows
    cos_hd = torch.clamp(y, min=1e-4)[:, None]                    # [Y, 1]

    ior_prime = torch.sqrt(torch.clamp(
        eta * eta - (1.0 - cos_hd * cos_hd), min=0.0)) / cos_hd
    cos_tt = torch.sqrt(torch.clamp(
        1.0 - (1.0 - cos_hd * cos_hd) / (eta * eta), min=0.0))   # [Y, 1]
    sigma_prime = sigma_a[None, None, :] / cos_tt[..., None]     # [Y, 1, 3]

    gamma_t = torch.asin(torch.clamp(gl_x[None, :] / ior_prime, -1.0, 1.0))
    f, _ = fresnel_dielectric(cos_hd * torch.cos(gamma_i)[None, :], eta)
    absorption = torch.exp(-sigma_prime * 2.0
                           * torch.cos(gamma_t)[..., None])     # [Y, G, 3]

    a_r = f                                                      # [Y, G]
    a_tt = ((1.0 - f) ** 2)[..., None] * absorption
    a_trt = a_tt * f[..., None] * absorption

    phi = torch.arange(AZ_RES, dtype=torch.float32, device=dev) \
        / (AZ_RES - 1.0) * TWO_PI

    def row(p, amp):
        delta = phi[None, :, None] - _phi_exit(gamma_i, gamma_t[:, None, :],
                                               p)               # [Y, P, G]
        d = _approx_d(det, delta)
        if amp.dim() == 2:
            integ = torch.einsum("g,ypg,yg->yp", gl_w, d, amp)
            integ = integ[..., None].expand(-1, -1, 3)
        else:
            integ = torch.einsum("g,ypg,ygc->ypc", gl_w, d, amp)
        return 0.5 * integ                                      # [Y, P, 3]

    return torch.stack([row(0, a_r), row(1, a_tt), row(2, a_trt)], dim=0)


def azimuthal_sampling_tables(values):
    """Dilated max-weights and lobe-selection integrals from the value
    tables [3, Y, P, 3] (reference: Azimuthal ctor,
    marschner_diffuse.cpp:39-65, and weight())."""
    w = torch.amax(values, dim=-1)                 # [3, Y, P]
    # one-step dilation along both axes (a max-pool with both neighbours)
    w = torch.maximum(w, torch.maximum(torch.roll(w, 1, -1),
                                       torch.roll(w, -1, -1)))
    w = torch.maximum(w, torch.maximum(torch.roll(w, 1, -2),
                                       torch.roll(w, -1, -2)))
    lobe_weight = torch.sum(w, dim=-1) * (TWO_PI / AZ_RES)   # [3, Y]
    return w, lobe_weight


def quad_pack(values):
    """Repack stacked azimuthal tables [K, 3, Y, X, 3] into 2x2 bilinear
    quads [K, Y-1, X-1, 3, 4, 3], so the per-lane eval gathers one
    36-float block instead of 12 texels (all three lobes share the
    (y0, x0) footprint). Slicing and stacking only: gradients flow."""
    v00 = values[:, :, :-1, :-1, :]
    v01 = values[:, :, :-1, 1:, :]
    v10 = values[:, :, 1:, :-1, :]
    v11 = values[:, :, 1:, 1:, :]
    quad = torch.stack([v00, v01, v10, v11], dim=-2)  # [K,3,Y-1,X-1,4,3]
    return torch.movedim(quad, 1, 3).contiguous()     # [K,Y-1,X-1,3,4,3]


def hair_tables(values):
    """HairTables of stacked value tables [K, 3, Y, P, 3], the sampling
    tables built from their detached values."""
    ws, lws = zip(*[azimuthal_sampling_tables(v.detach()) for v in values])
    return R.HairTables(values=values, weights=torch.stack(ws),
                        lobe_weight=torch.stack(lws),
                        values_quad=quad_pack(values))


# ---------------------------------------------------------------------------
# per-lane table lookups
# ---------------------------------------------------------------------------

def _row_lerp(v_row):
    """(r0, fv) of a continuous row coordinate."""
    v = torch.clamp(v_row, 0.0, AZ_RES - 1 - 1e-4)
    r0 = torch.clamp(v.to(torch.int32), 0, AZ_RES - 2).long()
    return r0, (v - r0.to(v.dtype))[..., None]


def _azimuthal_eval_lanes(values, k, phi, cos_td, values_quad=None):
    """values: [K, 3, Y, P, 3] stacked tables; k: [N] per-lane material.
    With values_quad (quad_pack) one [3, 4, 3] block per lane replaces
    the 12 texel gathers."""
    u = (AZ_RES - 1) * phi * INV_TWOPI
    v = (AZ_RES - 1) * cos_td
    x0 = torch.clamp(u.to(torch.int32), 0, AZ_RES - 2).long()
    y0 = torch.clamp(v.to(torch.int32), 0, AZ_RES - 2).long()
    fu = torch.clamp(u - x0.to(u.dtype), 0.0, 1.0)[..., None]
    fv = torch.clamp(v - y0.to(v.dtype), 0.0, 1.0)[..., None]

    if values_quad is not None:
        q = AZ_RES - 1
        blk = (k * q + y0) * q + x0
        quad = take_rows(values_quad.reshape(-1, 3, 4, 3), blk)  # [N,3,4,3]
        wu = fu[..., None]                       # [N, 1, 1]
        wv = fv[..., None]
        blend = (quad[..., 0, :] * (1 - wu) + quad[..., 1, :] * wu) \
            * (1 - wv) \
            + (quad[..., 2, :] * (1 - wu) + quad[..., 3, :] * wu) * wv
        return blend[:, 0], blend[:, 1], blend[:, 2]

    texels = values.reshape(-1, 3)

    def g(lobe, yy, xx):
        return take_rows(texels, ((k * 3 + lobe) * AZ_RES + yy) * AZ_RES + xx)

    out = []
    for lobe in range(3):
        v00 = g(lobe, y0, x0)
        v01 = g(lobe, y0, x0 + 1)
        v10 = g(lobe, y0 + 1, x0)
        v11 = g(lobe, y0 + 1, x0 + 1)
        out.append((v00 * (1 - fu) + v01 * fu) * (1 - fv)
                   + (v10 * (1 - fu) + v11 * fu) * fv)
    return out


def _lobe_weight_lanes(lobe_weight, k, v_row):
    """lobe_weight: [K, 3, Y]; returns [N, 3] blended at a continuous
    row."""
    r0, fv = _row_lerp(v_row)
    lw = lobe_weight.transpose(1, 2)              # [K, Y, 3]
    return lw[k, r0] * (1.0 - fv) + lw[k, r0 + 1] * fv


def _lerped_row(weights, k, lobe, v_row):
    """The weight row [N, P] of each lane's lobe, lerped between rows."""
    r0, fv = _row_lerp(v_row)
    return weights[k, lobe, r0] * (1.0 - fv) + weights[k, lobe, r0 + 1] * fv


def _azimuthal_pdf_lanes(weights, k, phi, v_row):
    """Per-lobe piecewise-constant azimuthal pdf matching
    _azimuthal_sample_lanes exactly (same lerped weight row, same phi
    bins). weights: [K, 3, Y, P]; returns [..., 3] pdf over dphi."""
    x = torch.clamp((phi * (AZ_RES * INV_TWOPI)).to(torch.int32), 0,
                    AZ_RES - 1).long()
    out = []
    for lobe in range(3):
        w = _lerped_row(weights, k, lobe, v_row)
        total = torch.sum(w, dim=-1)
        wx = torch.gather(w, -1, x[..., None])[..., 0]
        out.append(wx / torch.clamp(total, min=1e-20) * (AZ_RES * INV_TWOPI))
    return torch.stack(out, dim=-1)


def _azimuthal_sample_lanes(weights, k, lobe, v_row, u):
    """Sample phi from the interpolated row CDF
    (reference: Azimuthal::sample + InterpolatedDistribution1D::warp)."""
    w = _lerped_row(weights, k, lobe, v_row)
    cdf = torch.cumsum(w, dim=-1)
    cdf = cdf / torch.clamp(cdf[..., -1:], min=1e-20)
    x = torch.sum((cdf < u[..., None]).to(torch.int32), dim=-1)
    x = torch.clamp(x, 0, AZ_RES - 1).long()
    hi = torch.gather(cdf, -1, x[..., None])[..., 0]
    lo = torch.where(x > 0, torch.gather(
        cdf, -1, torch.clamp(x - 1, min=0)[..., None])[..., 0], 0.0)
    ur = torch.clamp((u - lo) / torch.clamp(hi - lo, min=1e-20), 0.0,
                     1.0 - 1e-6)
    return TWO_PI * (x.to(u.dtype) + ur) / AZ_RES


def _pick(x3, lobe):
    """x3 [N, 3] at each lane's lobe."""
    return torch.gather(x3, -1, lobe[..., None])[..., 0]


def _select_lobe(target, lw):
    """0, 1 or 2 where target falls in the running sums of lw [N, 3]."""
    c0 = lw[..., 0]
    c01 = c0 + lw[..., 1]
    one = torch.ones_like(target, dtype=torch.long)
    return torch.where(target < c0, 0 * one,
                       torch.where(target < c01, one, 2 * one))


# ---------------------------------------------------------------------------
# Kajiya-Kay (reference: kajiyakay.cpp)
# ---------------------------------------------------------------------------

def _mirror_z(w):
    return torch.stack([-w[..., 0], -w[..., 1], w[..., 2]], dim=-1)


class KajiyaKay:
    @staticmethod
    def eval_pdf(gm, wi, wo, aux=None):
        valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
        tl = torch.abs(wi[..., 0])
        te = torch.abs(wo[..., 0])
        alpha = tl * te + safe_sqrt(1 - tl * tl) * safe_sqrt(1 - te * te)
        e = gm.exponent
        spec_on = (alpha > 0) & (wi[..., 0] * wo[..., 0] < 0)
        spec = torch.where(
            spec_on[..., None],
            0.15 * gm.specular
            * ((e + 2.0) * INV_FOURPI
               * torch.pow(torch.clamp(alpha, min=1e-12), e))[..., None],
            0.0)
        f = (spec + gm.diffuse * INV_PI) \
            * torch.clamp(wo[..., 2], min=0.0)[..., None]

        # pdf: a Phong lobe around the mirror (reflect about z) plus the
        # cosine mixture
        alpha_ph = torch.sum(wo * _mirror_z(wi), dim=-1)
        spec_pdf = warps.phong_lobe_pdf(torch.clamp(alpha_ph, min=0.0), e)
        diff_pdf = warps.square_to_cosine_hemisphere_pdf(wo)
        pdf = gm.spec_weight * spec_pdf + (1.0 - gm.spec_weight) * diff_pdf
        return (torch.where(valid[..., None], f, 0.0),
                torch.where(valid, pdf, 0.0))

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux=None):
        n = wi.shape[:-1]
        choose_spec = u_lobe <= gm.spec_weight
        local = warps.square_to_phong_lobe(u2, gm.exponent)
        wo_spec = frame_from_normal(normalize(_mirror_z(wi))).to_world(local)
        wo_diff = warps.square_to_cosine_hemisphere(u2)
        wo = torch.where(choose_spec[..., None], wo_spec, wo_diff)
        f, pdf = KajiyaKay.eval_pdf(gm, wi, wo, aux)
        ok = pdf > 1e-9
        weight = torch.where(ok[..., None],
                             f / torch.clamp(pdf, min=1e-9)[..., None], 0.0)
        return (wo, weight, torch.where(ok, pdf, 0.0),
                torch.zeros(n, dtype=torch.bool, device=wi.device),
                torch.ones(n, device=wi.device))


# ---------------------------------------------------------------------------
# Marschner (= the fork's MarschnerDiffuse)
# ---------------------------------------------------------------------------

def _marschner_angles(wi, wo):
    sin_ti = wi[..., 1]
    sin_to = wo[..., 1]
    cos_to = torch.clamp(safe_sqrt(1.0 - sin_to * sin_to), max=1.0)
    theta_i = torch.asin(torch.clamp(sin_ti, -1.0, 1.0))
    theta_o = torch.asin(torch.clamp(sin_to, -1.0, 1.0))
    cos_td = torch.cos((theta_o - theta_i) * 0.5)
    phi = torch.atan2(wo[..., 0], wo[..., 2])
    phi = torch.where(phi < 0, phi + TWO_PI, phi)
    return sin_ti, sin_to, cos_to, theta_i, cos_td, phi


def _lobe_thetas(gm, theta_i):
    """The three lobes' shifted incident angles and variances, [N, 3]."""
    tilt = gm.scale_tilt
    th = torch.stack([theta_i - 2 * tilt, theta_i + tilt,
                      theta_i + 4 * tilt], dim=-1)
    v3 = torch.stack([gm.beta_r ** 2, (gm.beta_r * 0.5) ** 2,
                      (gm.beta_r * 2.0) ** 2], dim=-1)
    return th, v3


def _marschner_m3(gm, theta_i, sin_to, cos_to):
    th, v3 = _lobe_thetas(gm, theta_i)
    return [longitudinal_m(v3[..., i], torch.sin(th[..., i]), sin_to,
                           torch.cos(th[..., i]), cos_to) for i in range(3)]


def _aux_row(gm):
    return torch.clamp(gm.aux_id, min=0).long()


def _sample_spec_dir(gm, aux, k, wi, lobe_u, u_long, u_phi):
    """The hair-lobe direction: a lobe chosen by lobe_u in proportion to
    the azimuthal weight at the cos(theta_i) row, a longitudinal angle
    from u_long [N, 2], an azimuth from u_phi."""
    sin_ti = wi[..., 1]
    cos_ti = torch.clamp(safe_sqrt(1.0 - sin_ti * sin_ti), max=1.0)
    theta_i = torch.asin(torch.clamp(sin_ti, -1.0, 1.0))
    th, v3 = _lobe_thetas(gm, theta_i)
    lw = _lobe_weight_lanes(aux.lobe_weight, k, (AZ_RES - 1) * cos_ti)
    lobe = _select_lobe(lobe_u * torch.sum(lw, dim=-1), lw)
    th_sel = _pick(th, lobe)
    sin_to = torch.clamp(sample_longitudinal(
        _pick(v3, lobe), torch.sin(th_sel), torch.cos(th_sel),
        u_long[..., 0], u_long[..., 1]), -1.0, 1.0)
    cos_to = torch.clamp(safe_sqrt(1.0 - sin_to * sin_to), max=1.0)
    cos_td = torch.cos((torch.asin(sin_to) - theta_i) * 0.5)
    phi = _azimuthal_sample_lanes(aux.weights, k, lobe,
                                  (AZ_RES - 1) * cos_td, u_phi)
    return torch.stack([torch.sin(phi) * cos_to, sin_to,
                        torch.cos(phi) * cos_to], dim=-1)


class Marschner:
    @staticmethod
    def eval_pdf(gm, wi, wo, aux):
        k = _aux_row(gm)
        _, sin_to, cos_to, theta_i, cos_td, phi = _marschner_angles(wi, wo)
        m_r, m_tt, m_trt = _marschner_m3(gm, theta_i, sin_to, cos_to)
        n_r, n_tt, n_trt = _azimuthal_eval_lanes(aux.values, k, phi, cos_td,
                                                 aux.values_quad)
        hair = 0.15 * m_r[..., None] * n_r + m_tt[..., None] * n_tt \
            + m_trt[..., None] * n_trt
        f = hair + RoughPlastic._diffuse_term(gm, wi, wo)
        # faithful-mode pdf quirk: pdf() = 1 with diffuse enabled
        return f, torch.ones(wi.shape[:-1], device=wi.device)

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux):
        n = wi.shape[:-1]
        # faithful quirk: one 2D sample u2 for the lobe choice (u2.x), the
        # longitudinal warp, the azimuth (u2.y) and the diffuse hemisphere
        wo_spec = _sample_spec_dir(gm, aux, _aux_row(gm), wi, u2[..., 0],
                                   u2, u2[..., 1])
        # spec-vs-diffuse choice from the rough transmittance, rough
        # plastic's (quirk: reuses u2.y)
        choose_spec = u2[..., 1] < RoughPlastic._prob_spec(gm, wi)
        wo_diff = warps.square_to_cosine_hemisphere(u2)
        wo = torch.where(choose_spec[..., None], wo_spec, wo_diff)

        # faithful pdf quirk: pdf = 1, weight = eval; the specular branch
        # is flagged delta (EDeltaReflection quirk)
        f, _ = Marschner.eval_pdf(gm, wi, wo, aux)
        return wo, f, torch.ones(n, device=wi.device), choose_spec, \
            torch.ones(n, device=wi.device)


# ---------------------------------------------------------------------------
# Corrected-mode Marschner (the default for the "marschner" plugin name):
# the fork's pure variant (src/bsdfs/marschner.cpp:409-535) with the
# quirks removed: all three lobes unscaled, the true 3-lobe mixture pdf,
# fresh 2D samples for the lobe, longitudinal and azimuthal choices, the
# sampled lobe smooth (NEE + MIS apply). The faithful behaviour stays at
# kind MARSCHNER.
# ---------------------------------------------------------------------------

def _marschner_p_spec(gm, wi):
    """Probability of the specular (hair-lobe) branch: the faithful
    spec-vs-diffuse mixture when a diffuse term is present; pure hair
    materials (diffuse == 0) always sample the hair lobes."""
    has_diffuse = torch.sum(gm.diffuse, dim=-1) > 0
    return torch.where(has_diffuse, RoughPlastic._prob_spec(gm, wi), 1.0)


class MarschnerPure:
    @staticmethod
    def eval_pdf(gm, wi, wo, aux):
        k = _aux_row(gm)
        sin_ti, sin_to, cos_to, theta_i, cos_td, phi = \
            _marschner_angles(wi, wo)
        cos_ti = torch.clamp(safe_sqrt(1.0 - sin_ti * sin_ti), max=1.0)
        m3 = _marschner_m3(gm, theta_i, sin_to, cos_to)
        n3 = _azimuthal_eval_lanes(aux.values, k, phi, cos_td,
                                   aux.values_quad)
        hair = sum(m[..., None] * nn for m, nn in zip(m3, n3))

        # the true mixture pdf over the 3 lobes (marschner.cpp pdf())
        lw = _lobe_weight_lanes(aux.lobe_weight, k, (AZ_RES - 1) * cos_ti)
        npdf = _azimuthal_pdf_lanes(aux.weights, k, phi,
                                    (AZ_RES - 1) * cos_td)
        pdf_hair = torch.sum(lw * torch.stack(m3, dim=-1) * npdf, dim=-1) \
            / torch.clamp(torch.sum(lw, dim=-1), min=1e-20)

        diffuse = RoughPlastic._diffuse_term(gm, wi, wo)
        p_spec = _marschner_p_spec(gm, wi)
        pdf = p_spec * pdf_hair + (1.0 - p_spec) \
            * warps.square_to_cosine_hemisphere_pdf(wo)
        return hair + diffuse, pdf

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux):
        n = wi.shape[:-1]
        # lobe choice from a fresh sample (u2b.x), the longitudinal warp
        # from its own 2D sample (u2), the azimuth from u2b.y
        wo_spec = _sample_spec_dir(gm, aux, _aux_row(gm), wi, u2b[..., 0],
                                   u2, u2b[..., 1])
        choose_spec = u_lobe < _marschner_p_spec(gm, wi)
        wo_diff = warps.square_to_cosine_hemisphere(u2)
        wo = torch.where(choose_spec[..., None], wo_spec, wo_diff)

        f, pdf = MarschnerPure.eval_pdf(gm, wi, wo, aux)
        ok = pdf > 1e-9
        weight = torch.where(ok[..., None],
                             f / torch.clamp(pdf, min=1e-9)[..., None], 0.0)
        return (wo, weight, torch.where(ok, pdf, 0.0),
                torch.zeros(n, dtype=torch.bool, device=wi.device),
                torch.ones(n, device=wi.device))


# ---------------------------------------------------------------------------
# MarschnerDielectric (reference: marschnerdielectric.cpp)
# ---------------------------------------------------------------------------

class MarschnerDielectric:
    """Thin-dielectric R/TT energy split where the reflection is a mirror
    delta and transmission is delta-forward; the solid-angle eval/pdf are
    0 (the reference's eval returns 0 in the solid-angle measure for every
    direction, so NEE never sees this material and the sampled diffuse
    branch carries zero weight, kept as in the reference)."""

    @staticmethod
    def eval_pdf(gm, wi, wo, aux=None):
        n = wi.shape[:-1]
        return (torch.zeros(n + (3,), device=wi.device),
                torch.zeros(n, device=wi.device))

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux=None):
        n = wi.shape[:-1]
        sw = gm.spec_weight
        choose_spec = u_lobe <= sw
        F, _ = fresnel_dielectric(wi[..., 2], gm.eta)
        T = 1.0 - F
        Rp = torch.where(F < 1.0, F + T * T * F / (1.0 - F * F + 1e-12), F)
        # rescaled lobe sample (reference: sample.x /= specSamplingWeight)
        x = torch.where(choose_spec, u_lobe / torch.clamp(sw, min=1e-7), 0.0)
        choose_r = x <= Rp
        wo_spec = torch.where(choose_r[..., None], _mirror_z(wi), -wi)
        w_spec = torch.where(choose_r[..., None], gm.specular, gm.transmit)
        wo_diff = warps.square_to_cosine_hemisphere(u2)
        wo = torch.where(choose_spec[..., None], wo_spec, wo_diff)
        # diffuse branch: weight = eval / pdf = 0 (as in the reference)
        weight = torch.where(choose_spec[..., None], w_spec, 0.0)
        pdf = torch.where(choose_spec,
                          torch.where(choose_r, Rp, 1.0 - Rp), 0.0)
        return wo, weight, pdf, choose_spec, torch.ones(n, device=wi.device)


R.register(R.KAJIYAKAY, KajiyaKay)
R.register(R.MARSCHNER, Marschner)
R.register(R.MARSCHNER_PURE, MarschnerPure)
R.register(R.MARSCHNERDIELECTRIC, MarschnerDielectric)
