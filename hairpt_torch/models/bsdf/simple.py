"""The diffuse BSDF (port of the Diffuse family of
hairpt/models/bsdf/simple.py; reference src/bsdfs/diffuse.cpp): the
scene loader's default material of a shape without a BSDF."""
from __future__ import annotations

import math

import torch

from ...core import warps
from . import registry as R

INV_PI = 1.0 / math.pi


def _cos(w):
    return w[..., 2]


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
        n = wi.shape[:-1]
        return (wo, weight, pdf, torch.zeros(n, dtype=torch.bool,
                                             device=wi.device),
                torch.ones(n, device=wi.device))


R.register(R.DIFFUSE, Diffuse)
