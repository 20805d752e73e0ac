"""Rough dielectric (GGX or Beckmann microfacet reflection and
refraction, Walter et al. 2007) and the diffuse transmitter (port of
hairpt/models/bsdf/dielectric_rough.py; reference
src/bsdfs/roughdielectric.cpp, src/bsdfs/difftrans.cpp)."""
from __future__ import annotations

import math

import torch

from ...core import warps
from ...core.math import normalize, safe_sqrt
from . import registry as R
from .fresnel import fresnel_dielectric
from .plastic import _dyn_g, _dyn_ndf, _dyn_pdf_m, _dyn_sample_m

INV_PI = 1.0 / math.pi


def _cos(w):
    return w[..., 2]


class RoughDielectric:
    """Microfacet reflection and refraction, eta = int / ext, both
    sides."""

    @staticmethod
    def _half_refl(wi, wo):
        # the reflection half-vector, oriented to +z
        return normalize((wi + wo) * torch.sign(_cos(wi))[..., None])

    @staticmethod
    def _half_trans(wi, wo, eta):
        # h_t = -(eta_i wi + eta_o wo), oriented to +z
        eta_i = torch.where(_cos(wi) > 0, 1.0, eta)
        eta_o = torch.where(_cos(wi) > 0, eta, 1.0)
        h = -(eta_i[..., None] * wi + eta_o[..., None] * wo)
        h = h * torch.sign(h[..., 2:3])
        return normalize(h), eta_i, eta_o

    @staticmethod
    def eval_pdf(gm, wi, wo, aux=None):
        ci = _cos(wi)
        co = _cos(wo)
        reflect = ci * co > 0
        eta = gm.eta
        sgn = torch.sign(ci)[..., None]

        # reflection
        m_r = RoughDielectric._half_refl(wi, wo)
        wi_u = wi * sgn
        wo_u = wo * sgn
        # both directions on the microfacet's front side
        side_r = (torch.sum(wi_u * m_r, dim=-1) > 0) \
            & (torch.sum(wo_u * m_r, dim=-1) > 0)
        F_r, _ = fresnel_dielectric(torch.sum(wi * m_r, dim=-1)
                                    * torch.sign(ci), eta)
        D_r = _dyn_ndf(gm.dist, gm.alpha, m_r)
        G_r = _dyn_g(gm.dist, gm.alpha, wi_u, wo_u, m_r)
        f_refl = gm.specular * (torch.where(side_r, F_r * D_r * G_r, 0.0)
                                / torch.clamp(4.0 * torch.abs(ci),
                                              min=1e-7))[..., None]

        # transmission
        m_t, eta_i, eta_o = RoughDielectric._half_trans(wi, wo, eta)
        idm = torch.sum(wi * m_t, dim=-1)
        odm = torch.sum(wo * m_t, dim=-1)
        # wi and wo on opposite sides of the microfacet, wi on its front
        side_t = (idm * odm < 0) & (idm * ci > 0)
        F_t, _ = fresnel_dielectric(idm * torch.sign(ci), eta)
        D_t = _dyn_ndf(gm.dist, gm.alpha, m_t)
        wo_t = wo * torch.sign(co)[..., None]
        G_t = _dyn_g(gm.dist, gm.alpha, wi_u, wo_t, m_t)
        denom = eta_i * idm + eta_o * odm
        jac = eta_o ** 2 * torch.abs(odm) / torch.clamp(denom * denom,
                                                        min=1e-12)
        f_tr = gm.transmit * torch.where(
            side_t, torch.abs(idm) * jac * (1.0 - F_t) * D_t * G_t
            / torch.clamp(torch.abs(ci), min=1e-7), 0.0)[..., None]
        # radiance transport compression
        eta_rel = torch.where(ci > 0, eta, 1.0 / eta)
        f_tr = f_tr / (eta_rel * eta_rel)[..., None]

        f = torch.where(reflect[..., None], f_refl, f_tr)
        valid = torch.abs(ci) > 1e-6
        f = torch.where(valid[..., None], f, 0.0)

        pdf_m_r = _dyn_pdf_m(gm.dist, gm.alpha, wi_u, m_r)
        pdf_refl = torch.where(side_r, pdf_m_r / torch.clamp(
            4.0 * torch.abs(torch.sum(wo * m_r, -1)), min=1e-7) * F_r, 0.0)
        pdf_m_t = _dyn_pdf_m(gm.dist, gm.alpha, wi_u, m_t)
        pdf_tr = torch.where(side_t, pdf_m_t * jac * (1.0 - F_t), 0.0)
        pdf = torch.where(reflect, pdf_refl, pdf_tr)
        return f, torch.where(valid, pdf, 0.0)

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux=None):
        n = wi.shape[:-1]
        ci = _cos(wi)
        sign_i = torch.sign(torch.where(ci == 0, 1.0, ci))
        wi_u = wi * sign_i[..., None]
        m_u, _ = _dyn_sample_m(gm.dist, gm.alpha, wi_u, u2)
        m = m_u * sign_i[..., None]

        idm = torch.sum(wi * m, dim=-1)
        F, _ = fresnel_dielectric(idm * sign_i, gm.eta)
        choose_r = u_lobe <= F

        wo_r = 2.0 * idm[..., None] * m - wi
        # refraction about m
        eta_rel = torch.where(ci > 0, gm.eta, 1.0 / gm.eta)
        inv_eta = 1.0 / eta_rel
        c = idm
        sign_c = torch.sign(torch.where(c == 0, 1.0, c))
        cos_t_m = safe_sqrt(1.0 - inv_eta ** 2 * (1.0 - c * c))
        wo_t = (inv_eta * c - sign_c * cos_t_m)[..., None] * m \
            - inv_eta[..., None] * wi
        wo = normalize(torch.where(choose_r[..., None], wo_r, wo_t))

        f, pdf = RoughDielectric.eval_pdf(gm, wi, wo)
        ok = pdf > 1e-9
        weight = torch.where(ok[..., None],
                             f / torch.clamp(pdf, min=1e-9)[..., None], 0.0)
        eta_s = torch.where(choose_r, 1.0, eta_rel)
        return (wo, weight, torch.where(ok, pdf, 0.0),
                torch.zeros(n, dtype=torch.bool, device=wi.device), eta_s)


class DiffTrans:
    """Purely diffuse transmission (difftrans.cpp)."""

    @staticmethod
    def eval_pdf(gm, wi, wo, aux=None):
        valid = _cos(wi) * _cos(wo) < 0
        f = gm.transmit * (INV_PI * torch.abs(_cos(wo)))[..., None]
        pdf = torch.abs(_cos(wo)) * INV_PI
        return (torch.where(valid[..., None], f, 0.0),
                torch.where(valid, pdf, 0.0))

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux=None):
        n = wi.shape[:-1]
        wo = warps.square_to_cosine_hemisphere(u2)
        wo = wo * torch.where(_cos(wi) > 0, -1.0, 1.0)[..., None]
        pdf = torch.abs(_cos(wo)) * INV_PI
        weight = torch.broadcast_to(gm.transmit, wi.shape)
        return (wo, weight, pdf,
                torch.zeros(n, dtype=torch.bool, device=wi.device),
                torch.ones(n, device=wi.device))


R.register(R.ROUGHDIELECTRIC, RoughDielectric)
R.register(R.DIFFTRANS, DiffTrans)
