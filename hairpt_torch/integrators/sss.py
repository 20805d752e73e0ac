"""The dipole subsurface prepass: irradiance at surface sample points
(port of hairpt/integrators/sss.py; reference dipole.cpp's
IrradianceSamplingProcess): a fixed pool of area-weighted points on the
dipole triangles gets E = integral L cos estimated with K light samples
each, one NEE wave per sample, its shadow rays through the port's any-hit
queries."""
from __future__ import annotations

import numpy as np
import torch

from ..core import rng
from ..core.math import Ray, dot
from ..models import subsurface as sss_mod
from ..models.bsdf import registry as mat
from .common import scene_occluded
from .path import _sample_emitter_direct, _swept_params


def compute_irradiance(scene, pos, nrm, k_samples: int = 16, seed: int = 0):
    """E [M, 3] at the points pos [M, 3] with normals nrm by NEE."""
    cfg = scene.config
    arr = scene.arrays
    dev = arr.device
    pos = torch.as_tensor(np.asarray(pos, np.float32), device=dev)
    nrm = torch.as_tensor(np.asarray(nrm, np.float32), device=dev)
    m = pos.shape[0]
    idx = torch.arange(m, device=dev)
    params = _swept_params(cfg)
    e = torch.zeros((m, 3), device=dev)
    for s in range(k_samples):
        smp = seed + s * 7919
        u_sel = rng.uniform_1d(idx, smp, 0)
        u2 = rng.uniform_2d(idx, smp, 1)
        d, dist, le, pdf, _ = _sample_emitter_direct(arr, cfg, pos, u_sel, u2)
        cos_i = torch.clamp(dot(nrm, d), min=0.0)
        ok = (pdf > 0) & (cos_i > 0)
        shadow = Ray(o=pos + nrm * cfg.ray_eps, d=d,
                     mint=torch.zeros((m,), device=dev),
                     maxt=torch.where(ok, dist - 2 * cfg.ray_eps, 0.0))
        occ = scene_occluded(arr, shadow, **params)
        e = e + torch.where(
            (ok & ~occ)[..., None],
            le * (cos_i / torch.clamp(pdf, min=1e-20))[..., None], 0.0)
    return e / k_samples


def attach_dipole(scene, n_samples: int = 4096, k_light_samples: int = 16,
                  seed: int = 0):
    """The scene with arrays.sss built over every triangle of a DIPOLE
    material (its parameters from the first DIPOLE row); unchanged
    without one. With cfg.sss_single there is no prepass: a one-sample
    pool carries the parameters."""
    arr = scene.arrays
    if mat.DIPOLE not in scene.active_kinds or arr.tri is None:
        return scene
    dev = arr.device
    kinds = arr.materials.kind.cpu().numpy()
    mids = arr.tri_shading.mat_id.cpu().numpy()
    sel = kinds[mids] == mat.DIPOLE
    if not sel.any():
        return scene
    row = int(np.nonzero(kinds == mat.DIPOLE)[0][0])
    tbl = arr.materials
    params = sss_mod.SSSParams(sigma_s=tbl.transmit[row],
                               sigma_a=tbl.sigma_a[row], eta=tbl.eta[row],
                               scale=tbl.mix_w[row], g=scene.config.sss_g)
    if scene.config.sss_single:
        z1 = torch.zeros((1, 3), device=dev)
        sss = sss_mod.build_sss(z1, z1, torch.zeros((1,), device=dev),
                                params)
        return scene._replace(arrays=arr._replace(sss=sss))
    p0 = arr.tri.p0.cpu().numpy()[sel]
    e1 = arr.tri.e1.cpu().numpy()[sel]
    e2 = arr.tri.e2.cpu().numpy()[sel]
    pos, nrm, area = sss_mod.sample_surface_points((p0, e1, e2), n_samples,
                                                   seed)
    irr = compute_irradiance(scene, pos, nrm, k_light_samples, seed)
    sss = sss_mod.build_sss(torch.as_tensor(pos, device=dev), irr,
                            torch.as_tensor(area, device=dev), params)
    return scene._replace(arrays=arr._replace(sss=sss))
