"""Dipole BSSRDF subsurface scattering (port of
hairpt/models/subsurface.py; reference src/subsurface/dipole.cpp): the
dipole diffusion approximation of Jensen et al. 2001 over a fixed pool of
area-weighted surface samples whose irradiance one NEE pass estimates
(integrators/sss.py), gathered at shading time over a hash grid of the
samples.

  Fdr = -1.440/eta^2 + 0.710/eta + 0.668 + 0.0636 eta
  A = (1 + Fdr)/(1 - Fdr),  sigma_t' = sigma_s' + sigma_a,
  alpha' = sigma_s'/sigma_t',  sigma_tr = sqrt(3 sigma_a sigma_t'),
  zr = 1/sigma_t',  zv = zr (1 + 4A/3)
  Rd(r) = alpha'/4pi [zr (sigma_tr dr + 1) e^{-sigma_tr dr}/dr^3
                      + zv (sigma_tr dv + 1) e^{-sigma_tr dv}/dv^3]
  Lo(x, wo) = Ft(eta, wo)/pi sum_i Rd(|x - x_i|) E_i A_i
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class SSSParams(NamedTuple):
    sigma_s: torch.Tensor   # [3] reduced scattering sigma_s'
    sigma_a: torch.Tensor   # [3]
    eta: torch.Tensor       # []
    scale: torch.Tensor     # [] density scale
    g: float = 0.0          # HG anisotropy (single scattering only)


class SSSSamples(NamedTuple):
    pos: torch.Tensor       # [M, 3] sorted by grid cell
    irr: torch.Tensor       # [M, 3] irradiance
    area: torch.Tensor      # [M] area per sample
    cell: torch.Tensor      # [M] sorted cell keys
    grid_min: torch.Tensor  # [3]
    inv_cell: torch.Tensor  # []
    grid_res: int
    params: SSSParams


def dipole_coeffs(params: SSSParams):
    eta = params.eta
    fdr = -1.440 / (eta * eta) + 0.710 / eta + 0.668 + 0.0636 * eta
    a_ = (1.0 + fdr) / (1.0 - fdr)
    sig_s = params.sigma_s * params.scale
    sig_a = params.sigma_a * params.scale
    sig_tp = sig_s + sig_a
    alpha_p = sig_s / torch.clamp(sig_tp, min=1e-9)
    sig_tr = torch.sqrt(3.0 * sig_a * sig_tp)
    zr = 1.0 / torch.clamp(sig_tp, min=1e-9)
    zv = zr * (1.0 + 4.0 / 3.0 * a_)
    return alpha_p, sig_tr, zr, zv, fdr


def rd_kernel(params: SSSParams, r2):
    """Diffusion reflectance Rd(r) per channel: r2 [...] -> [..., 3]."""
    alpha_p, sig_tr, zr, zv, _ = dipole_coeffs(params)
    r2 = torch.clamp(r2, min=1e-12)[..., None]
    dr = torch.sqrt(r2 + zr * zr)
    dv = torch.sqrt(r2 + zv * zv)
    c1 = zr * (sig_tr * dr + 1.0) * torch.exp(-sig_tr * dr) / (dr ** 3)
    c2 = zv * (sig_tr * dv + 1.0) * torch.exp(-sig_tr * dv) / (dv ** 3)
    return alpha_p / (4.0 * math.pi) * (c1 + c2)


def sample_surface_points(meshes_tris, n_samples: int, seed: int = 0):
    """Area-weighted (pos, normal, area per sample) over the triangles
    (p0, e1, e2 numpy arrays), host side, numpy's default_rng(seed)."""
    p0, e1, e2 = meshes_tris
    cr = np.cross(e1, e2)
    tri_area = 0.5 * np.linalg.norm(cr, axis=1)
    total = tri_area.sum()
    rng_ = np.random.default_rng(seed)
    ti = rng_.choice(len(p0), size=n_samples, p=tri_area / total)
    u = rng_.random((n_samples, 2))
    su = np.sqrt(u[:, 0])
    b0 = 1 - su
    b1 = u[:, 1] * su
    pos = p0[ti] + e1[ti] * b0[:, None] + b1[:, None] * e2[ti]
    nrm = cr[ti] / np.maximum(np.linalg.norm(cr[ti], axis=1,
                                             keepdims=True), 1e-20)
    area = np.full(n_samples, total / n_samples, np.float32)
    return pos.astype(np.float32), nrm.astype(np.float32), area


def build_sss(pos, irr, area, params: SSSParams,
              grid_res: int = 128) -> SSSSamples:
    """Hash-grid the irradiance samples (cell size 2 / min sigma_tr, the
    most translucent channel's kernel radius)."""
    _, sig_tr, _, _, _ = dipole_coeffs(params)
    cell = float(2.0 / torch.min(sig_tr).cpu().numpy())
    lo = torch.amin(pos, dim=0) - cell
    inv = 1.0 / cell
    ijk = torch.clamp(((pos - lo) * inv).to(torch.int64), 0, grid_res - 1)
    key = (ijk[:, 0] * grid_res + ijk[:, 1]) * grid_res + ijk[:, 2]
    order = torch.argsort(key, stable=True)
    return SSSSamples(pos=pos[order], irr=irr[order], area=area[order],
                      cell=key[order], grid_min=lo,
                      inv_cell=torch.tensor(inv, dtype=torch.float32,
                                            device=pos.device),
                      grid_res=grid_res, params=params)


# lanes per chunk of sss_radiance's [N, 64, 3] temporaries on a wide wave
CHUNK = 1 << 16


def sss_radiance(sss: SSSSamples, p, wo_cos, max_per_cell: int = 64):
    """Outgoing subsurface radiance at points p [N, 3], with |cos| of the
    outgoing direction for the Fresnel transmittance (dipole.cpp Lo()).
    Wide waves go in chunks of CHUNK lanes; each lane's sum is taken in
    the same order."""
    if p.shape[0] > CHUNK:
        return torch.cat([sss_radiance(sss, p[i:i + CHUNK],
                                       wo_cos[i:i + CHUNK], max_per_cell)
                          for i in range(0, p.shape[0], CHUNK)])
    from .bsdf.fresnel import fresnel_dielectric
    gr = sss.grid_res
    dev = p.device
    q_ijk = ((p - sss.grid_min) * sss.inv_cell).to(torch.int64)
    acc = torch.zeros((p.shape[0], 3), device=dev)
    offs = torch.arange(max_per_cell, device=dev)
    last = sss.cell.shape[0] - 1
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                c = q_ijk + torch.tensor([dx, dy, dz], device=dev)
                okc = torch.all((c >= 0) & (c < gr), dim=-1)
                key = (c[:, 0] * gr + c[:, 1]) * gr + c[:, 2]
                start = torch.searchsorted(sss.cell, key)
                idxs = torch.clamp(start[:, None] + offs[None, :], max=last)
                in_cell = sss.cell[idxs] == key[:, None]
                d2 = torch.sum((sss.pos[idxs] - p[:, None]) ** 2, -1)
                rd = rd_kernel(sss.params, d2)
                w = (in_cell & okc[:, None]).to(torch.float32) \
                    * sss.area[idxs]
                acc = acc + torch.sum(rd * sss.irr[idxs] * w[..., None],
                                      dim=1)
    f_t, _ = fresnel_dielectric(torch.abs(wo_cos), sss.params.eta)
    return (1.0 - f_t)[..., None] / math.pi * acc
