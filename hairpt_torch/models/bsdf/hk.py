"""Hanrahan-Krueger single-scattering slab BSDF (port of
hairpt/models/bsdf/hk.py; reference src/bsdfs/hk.cpp): an index-matched
homogeneous layer of thickness d with sigma_s, sigma_a and an HG phase
function, its single-scattered glossy reflection and transmission plus
the attenuated delta transmission.

The material row holds transmit = sigma_s, sigma_a, alpha = thickness
and beta_r = the HG g.

  tau = (sigma_s + sigma_a) d,  albedo = sigma_s / sigma_t
  f_R = albedo p mu_i / (mu_i + mu_o) (1 - e^{-tau (1/mu_i + 1/mu_o)}) mu_o
  f_T = albedo p mu_i / (mu_i - mu_o) (e^{-tau/mu_i} - e^{-tau/mu_o}) mu_o
  (p the HG phase at the angle between wi and wo), and the delta
  transmission's weight e^{-tau/mu_i} (wo = -wi)
"""
from __future__ import annotations

import torch

from .. import media as med
from . import registry as R

LUM = (0.212671, 0.715160, 0.072169)


def _tau_albedo(gm):
    sig_s = gm.transmit
    sig_t = sig_s + gm.sigma_a
    tau = sig_t * gm.alpha[..., None]
    albedo = torch.where(sig_t > 0, sig_s / torch.clamp(sig_t, min=1e-12),
                         0.0)
    return tau, albedo


def _single_scatter(gm, wi, wo):
    """The glossy part of f |cos theta_o| (hk.cpp eval, ESolidAngle)."""
    tau, albedo = _tau_albedo(gm)
    mu_i = wi[..., 2]
    mu_o = wo[..., 2]
    ami = torch.clamp(torch.abs(mu_i), min=1e-6)
    amo = torch.clamp(torch.abs(mu_o), min=1e-6)
    phase = med.phase_eval(med.HG, gm.beta_r, wi, wo)
    refl = mu_i * mu_o > 0
    f_r = albedo * (phase * torch.abs(mu_i) / (ami + amo))[..., None] \
        * (1.0 - torch.exp(-tau * (1.0 / ami + 1.0 / amo)[..., None]))
    # transmission; at |mu_i| == |mu_o| the limit tau/mu_o e^{-tau/mu_o}
    diff = ami - amo
    safe = torch.abs(diff) > 1e-4
    f_t_reg = albedo \
        * (phase * ami / torch.where(safe, diff, 1.0))[..., None] \
        * (torch.exp(-tau / ami[..., None])
           - torch.exp(-tau / amo[..., None]))
    f_t_lim = albedo * phase[..., None] * (tau / amo[..., None]) \
        * torch.exp(-tau / amo[..., None])
    f_t = torch.where(safe[..., None], f_t_reg, f_t_lim)
    f = torch.where(refl[..., None], f_r,
                    torch.where((mu_i * mu_o < 0)[..., None], f_t, 0.0))
    return torch.clamp(f, min=0.0) * amo[..., None]


def _p_spec(gm, wi):
    tau, _ = _tau_albedo(gm)
    ami = torch.clamp(torch.abs(wi[..., 2]), min=1e-6)
    return torch.exp(-tau / ami[..., None]) @ tau.new_tensor(LUM)


class HK:
    @staticmethod
    def eval_pdf(gm, wi, wo, aux=None):
        f = _single_scatter(gm, wi, wo)
        p_s = _p_spec(gm, wi)
        pdf = med.phase_eval(med.HG, gm.beta_r, wi, wo) * (1.0 - p_s)
        return f, pdf

    @staticmethod
    def sample(gm, wi, u_lobe, u2, u2b, aux=None):
        n = wi.shape[:-1]
        tau, _ = _tau_albedo(gm)
        ami = torch.clamp(torch.abs(wi[..., 2]), min=1e-6)
        p_s = _p_spec(gm, wi)
        choose_delta = u_lobe < p_s
        wo_ph, pdf_ph = med.phase_sample(med.HG, gm.beta_r, wi, u2)
        wo = torch.where(choose_delta[..., None], -wi, wo_ph)
        w_delta = torch.exp(-tau / ami[..., None]) \
            / torch.clamp(p_s, min=1e-9)[..., None]
        f = _single_scatter(gm, wi, wo_ph)
        pdf_gl = pdf_ph * (1.0 - p_s)
        w_gloss = f / torch.clamp(pdf_gl, min=1e-9)[..., None]
        weight = torch.where(choose_delta[..., None], w_delta, w_gloss)
        pdf = torch.where(choose_delta, p_s, pdf_gl)
        return wo, weight, pdf, choose_delta, torch.ones(n, device=wi.device)


R.register(R.HK, HK)
