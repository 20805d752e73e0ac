"""Smooth plastic, the teapot's material, rough plastic, the furball's,
and rough conductor (port of hairpt/models/bsdf/plastic.py; reference
plastic.cpp, roughplastic.cpp and roughconductor.cpp).

The microfacet distribution is a per-lane value: both closed forms are
evaluated and lane-selected."""
from __future__ import annotations

import math

import torch

from ...core import warps
from ...core.math import normalize, reflect_z
from . import microfacet as mf
from . import registry as R
from .fresnel import fresnel_conductor, fresnel_dielectric

INV_PI = 1.0 / math.pi


def _cos(w):
    return w[..., 2]


def _dyn_ndf(dist, alpha, m):
    return torch.where(dist == mf.GGX, mf.ndf(mf.GGX, alpha, m),
                       mf.ndf(mf.BECKMANN, alpha, m))


def _dyn_g(dist, alpha, wi, wo, m):
    return torch.where(dist == mf.GGX, mf.g(mf.GGX, alpha, wi, wo, m),
                       mf.g(mf.BECKMANN, alpha, wi, wo, m))


def _dyn_sample_m(dist, alpha, wi, u2):
    m_g, p_g = mf.sample_visible(mf.GGX, alpha, wi, u2)
    m_b, p_b = mf.sample_all(mf.BECKMANN, alpha, u2)
    sel = dist == mf.GGX
    return (torch.where(sel[..., None], m_g, m_b), torch.where(sel, p_g, p_b))


def _dyn_pdf_m(dist, alpha, wi, m):
    p_g = mf.pdf_visible(mf.GGX, alpha, wi, m)
    p_b = mf.ndf(mf.BECKMANN, alpha, m) * torch.clamp(m[..., 2], min=0.0)
    return torch.where(dist == mf.GGX, p_g, p_b)


def _half(wi, wo):
    return normalize(wi + wo)


class Plastic:
    """A delta specular lobe over a Fresnel-compensated diffuse base."""

    @staticmethod
    def _diffuse_term(gm, wi, wo):
        F_i, _ = fresnel_dielectric(_cos(wi), gm.eta)
        F_o, _ = fresnel_dielectric(_cos(wo), gm.eta)
        inv_eta2 = 1.0 / (gm.eta * gm.eta)
        diff = gm.diffuse
        comp = torch.where(gm.nonlinear[..., None],
                           1.0 - diff * gm.int_fdr[..., None],
                           (1.0 - gm.int_fdr)[..., None])
        diff = diff / torch.clamp(comp, min=1e-6)
        return diff * (INV_PI * torch.clamp(_cos(wo), min=0.0)
                       * (1.0 - F_i) * (1.0 - F_o) * inv_eta2)[..., None]

    @staticmethod
    def _prob_spec(gm, wi):
        F_i, _ = fresnel_dielectric(_cos(wi), gm.eta)
        sw = gm.spec_weight
        return (F_i * sw) / torch.clamp(F_i * sw + (1.0 - F_i) * (1.0 - sw),
                                        min=1e-7)

    @staticmethod
    def eval_pdf(gm, wi, wo, aux=None):
        valid = (_cos(wi) > 0) & (_cos(wo) > 0)
        f = Plastic._diffuse_term(gm, wi, wo)
        p_spec = Plastic._prob_spec(gm, wi)
        pdf = warps.square_to_cosine_hemisphere_pdf(wo) * (1.0 - p_spec)
        return (torch.where(valid[..., None], f, 0.0),
                torch.where(valid, pdf, 0.0))

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux=None):
        n = wi.shape[:-1]
        valid = _cos(wi) > 0
        F_i, _ = fresnel_dielectric(_cos(wi), gm.eta)
        p_spec = Plastic._prob_spec(gm, wi)
        choose_spec = u_lobe <= p_spec
        wo_spec = reflect_z(wi)
        wo_diff = warps.square_to_cosine_hemisphere(u2)
        wo = torch.where(choose_spec[..., None], wo_spec, wo_diff)
        w_spec = gm.specular \
            * (F_i / torch.clamp(p_spec, min=1e-7))[..., None]
        diff_pdf = warps.square_to_cosine_hemisphere_pdf(wo_diff) \
            * (1.0 - p_spec)
        w_diff = Plastic._diffuse_term(gm, wi, wo_diff) \
            / torch.clamp(diff_pdf, min=1e-9)[..., None]
        weight = torch.where(choose_spec[..., None], w_spec, w_diff)
        weight = torch.where(valid[..., None], weight, 0.0)
        pdf = torch.where(choose_spec, p_spec, diff_pdf)
        pdf = torch.where(valid, pdf, 0.0)
        return wo, weight, pdf, choose_spec, torch.ones(n, device=wi.device)


class RoughPlastic:
    @staticmethod
    def _diffuse_term(gm, wi, wo):
        T12 = R.ext_trans_lookup(gm, _cos(wi))
        T21 = R.ext_trans_lookup(gm, _cos(wo))
        inv_eta2 = 1.0 / (gm.eta * gm.eta)
        diff = gm.diffuse
        comp = torch.where(gm.nonlinear[..., None],
                           1.0 - diff * gm.int_fdr[..., None],
                           (1.0 - gm.int_fdr)[..., None])
        diff = diff / torch.clamp(comp, min=1e-6)
        return diff * (INV_PI * torch.clamp(_cos(wo), min=0.0)
                       * T12 * T21 * inv_eta2)[..., None]

    @staticmethod
    def _prob_spec(gm, wi):
        p = 1.0 - R.ext_trans_lookup(gm, _cos(wi))
        sw = gm.spec_weight
        return (p * sw) / torch.clamp(p * sw + (1.0 - p) * (1.0 - sw),
                                      min=1e-7)

    @staticmethod
    def eval_pdf(gm, wi, wo, aux=None):
        valid = (_cos(wi) > 0) & (_cos(wo) > 0)
        m = _half(wi, wo)
        D = _dyn_ndf(gm.dist, gm.alpha, m)
        G = _dyn_g(gm.dist, gm.alpha, wi, wo, m)
        F, _ = fresnel_dielectric(torch.sum(wi * m, dim=-1), gm.eta)
        spec = gm.specular * (F * D * G / torch.clamp(4.0 * _cos(wi),
                                                      min=1e-7))[..., None]
        f = spec + RoughPlastic._diffuse_term(gm, wi, wo)
        p_spec = RoughPlastic._prob_spec(gm, wi)
        pdf_m = _dyn_pdf_m(gm.dist, gm.alpha, wi, m)
        pdf_s = mf.half_vector_to_wo_pdf(pdf_m, wo, m)
        pdf = p_spec * pdf_s + (1.0 - p_spec) \
            * warps.square_to_cosine_hemisphere_pdf(wo)
        return (torch.where(valid[..., None], f, 0.0),
                torch.where(valid, pdf, 0.0))

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux=None):
        n = wi.shape[:-1]
        valid = _cos(wi) > 0
        p_spec = RoughPlastic._prob_spec(gm, wi)
        choose_spec = u_lobe <= p_spec
        m, _ = _dyn_sample_m(gm.dist, gm.alpha, wi, u2)
        wo_spec = 2.0 * torch.sum(wi * m, dim=-1, keepdim=True) * m - wi
        wo_diff = warps.square_to_cosine_hemisphere(u2b)
        wo = torch.where(choose_spec[..., None], wo_spec, wo_diff)
        f, pdf = RoughPlastic.eval_pdf(gm, wi, wo)
        ok = valid & (pdf > 1e-9) & (_cos(wo) > 0)
        weight = torch.where(ok[..., None],
                             f / torch.clamp(pdf, min=1e-9)[..., None], 0.0)
        pdf = torch.where(ok, pdf, 0.0)
        return (wo, weight, pdf, torch.zeros(n, dtype=torch.bool,
                                             device=wi.device),
                torch.ones(n, device=wi.device))


class RoughConductor:
    @staticmethod
    def eval_pdf(gm, wi, wo, aux=None):
        valid = (_cos(wi) > 0) & (_cos(wo) > 0)
        m = _half(wi, wo)
        D = _dyn_ndf(gm.dist, gm.alpha, m)
        G = _dyn_g(gm.dist, gm.alpha, wi, wo, m)
        F = fresnel_conductor(torch.abs(torch.sum(wi * m, dim=-1)),
                              torch.broadcast_to(gm.eta[..., None],
                                                 gm.k.shape), gm.k)
        f = gm.specular * F * (D * G / torch.clamp(4.0 * _cos(wi),
                                                   min=1e-7))[..., None]
        pdf_m = _dyn_pdf_m(gm.dist, gm.alpha, wi, m)
        pdf = mf.half_vector_to_wo_pdf(pdf_m, wo, m)
        return (torch.where(valid[..., None], f, 0.0),
                torch.where(valid, pdf, 0.0))

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux=None):
        n = wi.shape[:-1]
        m, _ = _dyn_sample_m(gm.dist, gm.alpha, wi, u2)
        wo = 2.0 * torch.sum(wi * m, dim=-1, keepdim=True) * m - wi
        f, pdf = RoughConductor.eval_pdf(gm, wi, wo)
        ok = (pdf > 1e-9) & (_cos(wo) > 0) & (_cos(wi) > 0)
        weight = torch.where(ok[..., None],
                             f / torch.clamp(pdf, min=1e-9)[..., None], 0.0)
        return (wo, weight, torch.where(ok, pdf, 0.0),
                torch.zeros(n, dtype=torch.bool, device=wi.device),
                torch.ones(n, device=wi.device))


R.register(R.PLASTIC, Plastic)
R.register(R.ROUGHPLASTIC, RoughPlastic)
R.register(R.ROUGHCONDUCTOR, RoughConductor)
