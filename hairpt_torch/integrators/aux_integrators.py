"""Auxiliary integrators: direct illumination, ambient occlusion, field
extraction, adaptive sampling and several channels at once (port of
hairpt/integrators/aux_integrators.py; reference src/integrators/direct/
{direct,ao}.cpp, src/integrators/misc/{field,adaptive,multichannel}.cpp).

Each wave is one sample index over every pixel in pixel order (the
adaptive refinement: over its hot pixels), as in the JAX package; sample
dimensions, seeds and the uint32 sample ids (s + seed * 65536, mod 2^32)
are the JAX package's.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..core import rng, warps
from ..core.math import Ray, dot
from ..film import film as film_mod
from ..models import sensors
from ..models.bsdf import registry as mat
from . import path as path_int
from .common import frame, scene_intersect, scene_occluded
from .path import _swept_params

FIELDS = ("distance", "position", "geoNormal", "shNormal", "uv", "albedo",
          "primIndex")


def _sample_id(s: int, seed: int) -> int:
    return (s + seed * 65536) & rng.M32


def render_direct(scene, seed: int = 0, spp=None, progress=None):
    """MIS direct illumination (emitter and BSDF sampling): the path
    render at max_depth 2."""
    scene = scene._replace(config=dataclasses.replace(scene.config,
                                                      max_depth=2))
    return path_int.render(scene, seed=seed, spp=spp, progress=progress)


def camera_wave(scene, arr, sample_id: int):
    """(pixel, sampler, film positions, camera ray, hit) of one wave in
    pixel order, the jitter at dims 0-1 and no aperture sample."""
    cfg = scene.config
    dev = arr.device
    pixel = torch.arange(cfg.width * cfg.height, device=dev)
    smp = rng.Sampler(cfg.sampler, pixel, sample_id)
    px = (pixel % cfg.width).to(torch.float32)
    py = (pixel // cfg.width).to(torch.float32)
    jit2 = smp.next_2d(0)
    pos = torch.stack([px + jit2[..., 0], py + jit2[..., 1]], -1)
    ray = sensors.sample_ray(scene.camera, pos, None)
    hit = scene_intersect(arr, ray, **_swept_params(cfg))
    return pixel, smp, pos, ray, hit


def _waves(scene, spp: int, seed, wave, progress):
    """Splat `wave(sample_id) -> (pos, value)` over spp sample indices
    (seed None: the index itself) and develop."""
    fl = scene.film
    image, weight = film_mod.zeros(fl, scene.arrays.device)
    for s in range(spp):
        t0 = time.time()
        pos, v = wave(s if seed is None else _sample_id(s, seed))
        image, weight = film_mod.splat_samples(fl, pos, v, image, weight)
        if progress is not None:
            progress(s + 1, spp, time.time() - t0, float(v.shape[0]))
    return film_mod.develop(image, weight)


def render_ao(scene, spp: int = 16, ray_length: float = -1.0,
              seed: int = 0, progress=None):
    """Ambient occlusion: the visibility of one cosine-hemisphere ray
    (dims 4-5) from each camera hit, averaged; ray_length <= 0 is
    unbounded; a pixel whose camera ray misses counts as visible."""
    cfg = scene.config
    arr = scene.arrays
    max_len = float("inf") if ray_length <= 0 else ray_length

    def wave(sample_id):
        _, smp, pos, ray, hit = camera_wave(scene, arr, sample_id)
        n = pos.shape[0]
        wo = frame(hit).to_world(warps.square_to_cosine_hemisphere(
            smp.next_2d(4)))
        n_or = torch.where(dot(hit.sh_n, -ray.d)[..., None] < 0,
                           -hit.geo_n, hit.geo_n)
        shadow = Ray(o=hit.p + n_or * cfg.ray_eps, d=wo,
                     mint=torch.zeros((n,), device=pos.device),
                     maxt=torch.where(hit.valid, max_len, 0.0))
        occ = scene_occluded(arr, shadow, **_swept_params(cfg))
        vis = torch.where(hit.valid, (~occ).to(torch.float32), 1.0)
        return pos, vis[..., None].expand(n, 3)

    return _waves(scene, spp, seed, wave, progress)


def render_field(scene, field: str = "shNormal", spp: int = 1,
                 progress=None):
    """A geometric field of the camera hits as an image (AOVs); 0 where
    the camera ray misses. primIndex is the hit's material id, as in the
    JAX package."""
    if field not in FIELDS:
        raise ValueError(f"field {field!r} is not one of {FIELDS}")
    arr = scene.arrays

    def wave(sample_id):
        _, _, pos, _, hit = camera_wave(scene, arr, sample_id)
        n = pos.shape[0]
        if field == "distance":
            v = torch.where(hit.valid, hit.t, 0.0)[..., None].expand(n, 3)
        elif field == "position":
            v = hit.p
        elif field == "geoNormal":
            v = hit.geo_n
        elif field == "shNormal":
            v = hit.sh_n
        elif field == "uv":
            v = torch.cat([hit.uv, torch.zeros_like(hit.uv[:, :1])], -1)
        elif field == "albedo":
            v = mat.gather(arr.materials, arr.checkers, hit.mat_id,
                           hit.uv).diffuse
        else:
            v = hit.mat_id.to(torch.float32)[..., None].expand(n, 3)
        return pos, torch.where(hit.valid[..., None], v, 0.0)

    return _waves(scene, spp, None, wave, progress)


def hot_pixels(err, k: int):
    """The k pixels of largest err, in descending order, the lower index
    first among equal values (jax.lax.top_k's order; a stable sort)."""
    return torch.sort(err.reshape(-1), descending=True,
                      stable=True).indices[:k]


def render_adaptive(scene, base_spp: int = 8, extra_spp: int = 24,
                    fraction: float = 0.25, seed: int = 0, progress=None):
    """Adaptive sampling: two half-buffers of base_spp // 2 (at least one)
    waves each, their relative difference |a - b| / max(a + b, 1e-3)
    summed over the colours, then extra_spp waves over the top `fraction`
    of pixels (at least one) by that error (hot_pixels)."""
    cfg = scene.config
    fl = scene.film
    arr = scene.arrays
    dev = arr.device
    n_pix = cfg.width * cfg.height
    li = path_int.make_li_fn(scene)
    done = [0]
    total = 2 * max(base_spp // 2, 1) + extra_spp

    def wave(pixel_idx, s, image, weight):
        t0 = time.time()
        sample_idx = torch.full(pixel_idx.shape, _sample_id(s, seed),
                                dtype=torch.int64, device=dev)
        radiance, pos, n_rays = li(arr, pixel_idx, sample_idx)
        radiance = torch.nan_to_num(radiance, nan=0.0, posinf=0.0,
                                    neginf=0.0)
        out = film_mod.splat_samples(fl, pos, radiance, image, weight)
        done[0] += 1
        if progress is not None:
            progress(done[0], total, time.time() - t0, float(n_rays))
        return out

    all_pix = torch.arange(n_pix, device=dev)
    img_a, wt_a = film_mod.zeros(fl, dev)
    img_b, wt_b = film_mod.zeros(fl, dev)
    half = max(base_spp // 2, 1)
    for s in range(half):
        img_a, wt_a = wave(all_pix, s, img_a, wt_a)
    for s in range(half, 2 * half):
        img_b, wt_b = wave(all_pix, s, img_b, wt_b)
    a = film_mod.develop(img_a, wt_a)
    b = film_mod.develop(img_b, wt_b)
    err = torch.sum(torch.abs(a - b), dim=-1) \
        / torch.clamp(torch.sum(a + b, dim=-1), min=1e-3)
    hot = hot_pixels(err, max(int(n_pix * fraction), 1))
    image = img_a + img_b
    weight = wt_a + wt_b
    for s in range(2 * half, 2 * half + extra_spp):
        image, weight = wave(hot, s, image, weight)
    return film_mod.develop(image, weight)


def render_multichannel(scene, channels=("radiance", "shNormal",
                                         "distance", "albedo"),
                        spp: int = 8, seed: int = 0):
    """Several channels of one scene: {name: image}. radiance is the path
    render at spp, ao render_ao at spp, any other name render_field's
    field at one sample."""
    out = {}
    for ch in channels:
        if ch == "radiance":
            out[ch] = path_int.render(scene, seed=seed, spp=spp)
        elif ch == "ao":
            out[ch] = render_ao(scene, spp=spp, seed=seed)
        else:
            out[ch] = render_field(scene, ch)
    return out
