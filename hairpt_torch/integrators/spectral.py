"""Spectral rendering: the N > 3-bin counterpart of the RGB path (port of
hairpt/integrators/spectral.py; reference: Mitsuba's SPECTRUM_SAMPLES
option, include/mitsuba/core/spectrum.h:25).

The same 3-channel path render runs once per band of 3 wavelength bins,
each channel carrying one wavelength, and the per-bin radiance is
integrated against the CIE matching functions into linear sRGB
(core/spectral.py). RGB inputs (the materials' diffuse, specular,
transmit and hair sigma_a, the area radiance, the delta intensity, the
environment's texels) are upsampled to the band's bins by the corrected
basis; under Cauchy dispersion every row's eta takes the band's centre
wavelength. The Marschner azimuthal tables are recomputed per band; the
environment's sampling tables stay the RGB ones, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import spectral as sp
from ..models.bsdf import hair as hair_bsdf
from ..models.bsdf import registry as mat
from . import path as path_int


def _up(A_band, rgb):
    """[..., 3] RGB at the band's 3 wavelengths: clip(rgb @ A_band.T, 0),
    A_band [3 (bins), 3 (rgb)]."""
    A = torch.as_tensor(np.asarray(A_band, np.float32), device=rgb.device)
    return torch.clamp(rgb @ A.T, min=0.0)


def respectralize_arrays(scene, A_band, lam_band, cauchy_b: float = 0.0):
    """The scene's arrays with every RGB quantity at the band's 3
    wavelengths (see the module docstring). The Marschner rows' tables
    are recomputed from the band's sigma_a upsampled once more and each
    row's eta before dispersion, as the JAX package recomputes them."""
    arr = scene.arrays
    mats0 = arr.materials
    eta = mats0.eta
    if cauchy_b > 0.0:
        # one eta per band, at its centre bin
        eta_c = sp.cauchy_eta(eta.cpu().numpy().astype(np.float64),
                              cauchy_b, float(lam_band[1]))
        eta = torch.as_tensor(eta_c.astype(np.float32), device=eta.device)
    mats = mats0._replace(
        diffuse=_up(A_band, mats0.diffuse),
        specular=_up(A_band, mats0.specular),
        transmit=_up(A_band, mats0.transmit),
        sigma_a=_up(A_band, mats0.sigma_a),
        eta=eta)
    arr2 = arr._replace(materials=mats)
    if arr.area is not None:
        arr2 = arr2._replace(area=arr.area._replace(
            radiance=_up(A_band, arr.area.radiance)))
    if arr.delta is not None:
        arr2 = arr2._replace(delta=arr.delta._replace(
            intensity=_up(A_band, arr.delta.intensity)))
    if arr.env is not None:
        arr2 = arr2._replace(env=arr.env._replace(
            image=_up(A_band, arr.env.image)))
    if arr.hair_tables is not None and scene.marschner_rows:
        vals, ws, lws = [], [], []
        for row in scene.marschner_rows:
            v = hair_bsdf.precompute_azimuthal(
                _up(A_band, mats.sigma_a[row]),
                float(mats0.beta_r[row]), float(mats0.eta[row]))
            w, lw = hair_bsdf.azimuthal_sampling_tables(v)
            vals.append(v)
            ws.append(w)
            lws.append(lw)
        stacked = torch.stack(vals)
        arr2 = arr2._replace(hair_tables=mat.HairTables(
            values=stacked, weights=torch.stack(ws),
            lobe_weight=torch.stack(lws),
            values_quad=hair_bsdf.quad_pack(stacked)))
    return arr2


def render_spectral(scene, n_bins: int = 12, spp: int = 16, seed: int = 0,
                    cauchy_b: float = 0.0, return_bins: bool = False,
                    progress=None):
    """n_bins wavelength bins (a multiple of 3) over [380, 720] nm ->
    linear sRGB [H, W, 3]. cauchy_b: the Cauchy B coefficient (um^2) of
    every row's eta (0: no dispersion; the result then matches the RGB
    render up to the upsampling's clamp). return_bins: also the per-bin
    radiance [H, W, n_bins]. progress goes to each band's path
    render."""
    if n_bins % 3 != 0 or n_bins < 3:
        raise ValueError(f"n_bins must be a positive multiple of 3, not "
                         f"{n_bins}")
    A, lam, _ = sp.upsample_basis(n_bins)
    Wrgb, _, _ = sp.rgb_weights(n_bins)
    cfg = scene.config
    dev = scene.arrays.device
    rgb = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    bins = []
    for g in range(n_bins // 3):
        sl = slice(3 * g, 3 * g + 3)
        arr_g = respectralize_arrays(scene, A[sl], lam[sl], cauchy_b)
        img_g = path_int.render(scene._replace(arrays=arr_g), spp=spp,
                                seed=seed, progress=progress)
        if return_bins:
            bins.append(img_g)
        rgb = rgb + img_g @ torch.as_tensor(Wrgb[sl].astype(np.float32),
                                            device=dev)
    if return_bins:
        return rgb, torch.cat(bins, dim=-1)
    return rgb
