"""Basic BSDF families (port of hairpt/models/bsdf/simple.py): diffuse,
rough (Oren-Nayar) diffuse, smooth conductor, dielectric and thin
dielectric, modified Phong, Ward and null (reference src/bsdfs/{diffuse,
roughdiffuse,conductor,dielectric,thindielectric,phong,ward,null}.cpp),
branchless over a wave of lanes."""
from __future__ import annotations

import math

import torch

from ...core import warps
from ...core.math import frame_from_normal, normalize, reflect_z, safe_sqrt
from . import registry as R
from .fresnel import fresnel_conductor, fresnel_dielectric

INV_PI = 1.0 / math.pi


def _cos(w):
    return w[..., 2]


def _flags(wi, delta: bool):
    """(is_delta, eta_scale = 1) of a family's samples."""
    n = wi.shape[:-1]
    return (torch.full(n, delta, dtype=torch.bool, device=wi.device),
            torch.ones(n, device=wi.device))


def _no_smooth(wi):
    """eval_pdf of a family with delta lobes only: zero."""
    n = wi.shape[:-1]
    return (torch.zeros(n + (3,), device=wi.device),
            torch.zeros(n, device=wi.device))


class Diffuse:
    @staticmethod
    def eval_pdf(gm, wi, wo, aux=None):
        valid = (_cos(wi) > 0) & (_cos(wo) > 0)
        f = gm.diffuse * (INV_PI * torch.clamp(_cos(wo), min=0.0))[..., None]
        pdf = warps.square_to_cosine_hemisphere_pdf(wo)
        return (torch.where(valid[..., None], f, 0.0),
                torch.where(valid, pdf, 0.0))

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux=None):
        wo = warps.square_to_cosine_hemisphere(u2)
        valid = _cos(wi) > 0
        weight = torch.where(valid[..., None], gm.diffuse, 0.0)
        pdf = torch.where(valid, warps.square_to_cosine_hemisphere_pdf(wo),
                          0.0)
        return (wo, weight, pdf) + _flags(wi, False)


class RoughDiffuse:
    """Oren-Nayar, the fast approximation of the reference's default."""

    @staticmethod
    def eval_pdf(gm, wi, wo, aux=None):
        valid = (_cos(wi) > 0) & (_cos(wo) > 0)
        # beckmann alpha -> Oren-Nayar sigma (roughdiffuse.cpp:151)
        sigma = gm.alpha / math.sqrt(2.0)
        sigma2 = sigma * sigma
        a = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
        b = 0.45 * sigma2 / (sigma2 + 0.09)
        ct_i, ct_o = _cos(wi), _cos(wo)
        st_i = safe_sqrt(1 - ct_i * ct_i)
        st_o = safe_sqrt(1 - ct_o * ct_o)
        denom = torch.clamp(st_i * st_o, min=1e-7)
        cos_dphi = torch.clamp((wi[..., 0] * wo[..., 0]
                                + wi[..., 1] * wo[..., 1]) / denom,
                               -1.0, 1.0)
        sin_alpha = torch.maximum(st_i, st_o)
        tan_beta = torch.minimum(st_i, st_o) / torch.clamp(
            torch.minimum(ct_i, ct_o), min=1e-4)
        f = gm.diffuse * (INV_PI * torch.clamp(ct_o, min=0.0)
                          * (a + b * torch.clamp(cos_dphi, min=0.0)
                             * sin_alpha * tan_beta))[..., None]
        pdf = warps.square_to_cosine_hemisphere_pdf(wo)
        return (torch.where(valid[..., None], f, 0.0),
                torch.where(valid, pdf, 0.0))

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux=None):
        wo = warps.square_to_cosine_hemisphere(u2)
        f, pdf = RoughDiffuse.eval_pdf(gm, wi, wo)
        weight = f / torch.clamp(pdf, min=1e-12)[..., None]
        return (wo, weight, pdf) + _flags(wi, False)


class Conductor:
    """A smooth conductor (also `mirror`: eta 1e4, k 0 gives F = 1)."""

    @staticmethod
    def eval_pdf(gm, wi, wo, aux=None):
        return _no_smooth(wi)

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux=None):
        wo = reflect_z(wi)
        valid = _cos(wi) > 0
        F = fresnel_conductor(torch.abs(_cos(wi)),
                              torch.broadcast_to(gm.eta[..., None],
                                                 gm.k.shape), gm.k)
        weight = torch.where(valid[..., None], gm.specular * F, 0.0)
        pdf = torch.where(valid, 1.0, 0.0)
        return (wo, weight, pdf) + _flags(wi, True)


def _refract_z(wi, cos_t, eta_rel):
    """Refract across z = 0 given the signed cos theta_t and the relative
    ior."""
    scale = torch.where(_cos(wi) >= 0, 1.0 / eta_rel, eta_rel)
    return torch.stack([-wi[..., 0] * scale, -wi[..., 1] * scale, cos_t],
                       dim=-1)


class Dielectric:
    @staticmethod
    def eval_pdf(gm, wi, wo, aux=None):
        return _no_smooth(wi)

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux=None):
        F, cos_t = fresnel_dielectric(_cos(wi), gm.eta)
        choose_r = u_lobe <= F
        eta_rel = torch.where(_cos(wi) >= 0, gm.eta, 1.0 / gm.eta)
        wo = torch.where(choose_r[..., None], reflect_z(wi),
                         _refract_z(wi, cos_t, gm.eta))
        # radiance transport: the solid-angle compression 1 / eta_rel^2
        factor = 1.0 / (eta_rel * eta_rel)
        weight = torch.where(choose_r[..., None], gm.specular,
                             gm.transmit * factor[..., None])
        pdf = torch.where(choose_r, F, 1.0 - F)
        eta_s = torch.where(choose_r, 1.0, eta_rel)
        return wo, weight, pdf, _flags(wi, True)[0], eta_s


class ThinDielectric:
    """R' = R + TRT + TR^3T + ... (thindielectric.cpp)."""

    @staticmethod
    def eval_pdf(gm, wi, wo, aux=None):
        return _no_smooth(wi)

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux=None):
        F, _ = fresnel_dielectric(torch.abs(_cos(wi)), gm.eta)
        T = 1.0 - F
        Rp = torch.where(F < 1.0, F + T * T * F / (1.0 - F * F + 1e-12), F)
        choose_r = u_lobe <= Rp
        wo = torch.where(choose_r[..., None], reflect_z(wi), -wi)
        weight = torch.where(choose_r[..., None], gm.specular, gm.transmit)
        pdf = torch.where(choose_r, Rp, 1.0 - Rp)
        return (wo, weight, pdf) + _flags(wi, True)


class Null:
    """Pass-through (null.cpp)."""

    @staticmethod
    def eval_pdf(gm, wi, wo, aux=None):
        return _no_smooth(wi)

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux=None):
        return (-wi, torch.broadcast_to(gm.transmit, wi.shape),
                torch.ones(wi.shape[:-1], device=wi.device)) \
            + _flags(wi, True)


class Phong:
    """The modified Phong model (phong.cpp)."""

    @staticmethod
    def eval_pdf(gm, wi, wo, aux=None):
        valid = (_cos(wi) > 0) & (_cos(wo) > 0)
        alpha = torch.sum(wo * reflect_z(wi), dim=-1)
        e = gm.exponent
        spec = torch.where((alpha > 0)[..., None], gm.specular * (
            (e + 2.0) * warps.INV_TWOPI
            * torch.pow(torch.clamp(alpha, min=1e-12), e))[..., None], 0.0)
        f = (spec + gm.diffuse * INV_PI) \
            * torch.clamp(_cos(wo), min=0.0)[..., None]
        spec_pdf = warps.phong_lobe_pdf(torch.clamp(alpha, min=0.0), e)
        diff_pdf = warps.square_to_cosine_hemisphere_pdf(wo)
        pdf = gm.spec_weight * spec_pdf + (1.0 - gm.spec_weight) * diff_pdf
        return (torch.where(valid[..., None], f, 0.0),
                torch.where(valid, pdf, 0.0))

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux=None):
        choose_spec = u_lobe <= gm.spec_weight
        local = warps.square_to_phong_lobe(u2, gm.exponent)
        wo_spec = frame_from_normal(normalize(reflect_z(wi))).to_world(local)
        wo_diff = warps.square_to_cosine_hemisphere(u2)
        wo = torch.where(choose_spec[..., None], wo_spec, wo_diff)
        f, pdf = Phong.eval_pdf(gm, wi, wo)
        weight = torch.where(pdf[..., None] > 0, f / torch.clamp(
            pdf, min=1e-12)[..., None], 0.0)
        return (wo, weight, pdf) + _flags(wi, False)


class Ward:
    """The balanced isotropic Ward model (ward.cpp)."""

    @staticmethod
    def eval_pdf(gm, wi, wo, aux=None):
        valid = (_cos(wi) > 0) & (_cos(wo) > 0)
        a = gm.alpha
        h = wi + wo
        h2 = torch.sum(h * h, dim=-1)
        h_len = torch.sqrt(torch.clamp(h2, min=1e-20))
        hz = h[..., 2] / h_len
        tan_h2 = torch.clamp(1 - hz * hz, min=0) \
            / torch.clamp(hz * hz, min=1e-12)
        exp_term = torch.exp(-tan_h2 / torch.clamp(a * a, min=1e-12))
        spec = exp_term / torch.clamp(
            4.0 * math.pi * a * a * torch.sqrt(torch.clamp(
                _cos(wi) * _cos(wo), min=1e-8)), min=1e-12)
        f = (gm.specular * spec[..., None] + gm.diffuse * INV_PI) \
            * torch.clamp(_cos(wo), min=0.0)[..., None]
        # the half-vector Gaussian with the d(omega_h) -> d(omega_o)
        # Jacobian, mixed with a cosine lobe
        spec_pdf = exp_term / torch.clamp(
            math.pi * a * a * hz ** 3 * 4.0
            * torch.abs(torch.sum(h / h_len[..., None] * wo, dim=-1)),
            min=1e-12)
        diff_pdf = warps.square_to_cosine_hemisphere_pdf(wo)
        pdf = gm.spec_weight * spec_pdf + (1 - gm.spec_weight) * diff_pdf
        return (torch.where(valid[..., None], f, 0.0),
                torch.where(valid, pdf, 0.0))

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux=None):
        a = gm.alpha
        choose_spec = u_lobe <= gm.spec_weight
        phi_h = 2 * math.pi * u2[..., 1]
        tan_h = a * torch.sqrt(-torch.log(torch.clamp(1 - u2[..., 0],
                                                      min=1e-12)))
        cos_h = 1.0 / torch.sqrt(1.0 + tan_h * tan_h)
        sin_h = safe_sqrt(1 - cos_h * cos_h)
        h = torch.stack([sin_h * torch.cos(phi_h), sin_h * torch.sin(phi_h),
                         cos_h], dim=-1)
        wo_spec = 2.0 * torch.sum(wi * h, dim=-1, keepdim=True) * h - wi
        wo_diff = warps.square_to_cosine_hemisphere(u2)
        wo = torch.where(choose_spec[..., None], wo_spec, wo_diff)
        f, pdf = Ward.eval_pdf(gm, wi, wo)
        weight = torch.where(pdf[..., None] > 0, f / torch.clamp(
            pdf, min=1e-12)[..., None], 0.0)
        return (wo, weight, pdf) + _flags(wi, False)


R.register(R.DIFFUSE, Diffuse)
R.register(R.ROUGHDIFFUSE, RoughDiffuse)
R.register(R.CONDUCTOR, Conductor)
R.register(R.DIELECTRIC, Dielectric)
R.register(R.THINDIELECTRIC, ThinDielectric)
R.register(R.NULL, Null)
R.register(R.PHONG, Phong)
R.register(R.WARD, Ward)
